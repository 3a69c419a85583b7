"""Host layer of the torch port against the JAX package: the planner, the
LUT factory and the configuration, plus the port's import isolation."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import vkfft_tpu
from vkfft_tpu import luts as ref_luts
from vkfft_tpu.planner import plan_axis as ref_plan_axis

import vkfft_tpu_torch
from vkfft_tpu_torch import luts
from vkfft_tpu_torch.config import (FFTConfig, Precision, TransformKind,
                                    config_from_reference)
from vkfft_tpu_torch.planner import plan_axis

REPO = pathlib.Path(__file__).resolve().parents[1]
# the primes of tests/test_factorize.py
PRIMES = (2, 3, 5, 7, 11, 13, 17, 97, 101, 10007)


def _plan_fields(p):
    d = p.decomp
    return (p.n, d.algorithm.value, d.radices, d.split, d.bluestein_size,
            d.rader_prime, tuple((s.r, s.L, s.M, s.Mp) for s in p.stages))


@pytest.mark.parametrize("lo", range(1, 4097, 512))
def test_plan_axis_matches_reference(lo):
    for n in range(lo, min(lo + 512, 4097)):
        assert _plan_fields(plan_axis(n)) == _plan_fields(ref_plan_axis(n)), n


@pytest.mark.parametrize("n", PRIMES + (131, 263, 393, 1009, 131 * 131,
                                        2 * 5003, 16384, 12289))
def test_plan_axis_matches_reference_primes(n):
    assert _plan_fields(plan_axis(n)) == _plan_fields(ref_plan_axis(n))


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("inverse", [False, True])
def test_luts_match_reference(inverse):
    for r in (2, 3, 5, 16, 61, 127):
        _same(luts.dft_matrix(r, inverse), ref_luts.dft_matrix(r, inverse))
    for r, mp in ((4, 16), (16, 1), (7, 9)):
        _same(luts.stage_twiddle(r, mp, inverse),
              ref_luts.stage_twiddle(r, mp, inverse))
    _same(luts.bluestein_chirp(263, 539, inverse),
          ref_luts.bluestein_chirp(263, 539, inverse))
    _same(luts.bluestein_chirp_factors(263, 16, 4, 8, 8, inverse),
          ref_luts.bluestein_chirp_factors(263, 16, 4, 8, 8, inverse))
    _same(luts.bluestein_chirp_rows(263, 8, 64, inverse, 0.5),
          ref_luts.bluestein_chirp_rows(263, 8, 64, inverse, 0.5))
    _same(luts.fourstep_twiddle_full(8, 16, inverse),
          ref_luts.fourstep_twiddle_full(8, 16, inverse))
    _same(luts.ct_twiddle(131, 3, inverse), ref_luts.ct_twiddle(131, 3, inverse))
    _same(luts.r2c_post_twiddle(64, inverse),
          ref_luts.r2c_post_twiddle(64, inverse))
    for n in (1, 8, 60, 97, 131, 263, 393):
        _same(luts.axis_tables(plan_axis(n), inverse),
              ref_luts.axis_tables(ref_plan_axis(n), inverse))


@pytest.mark.parametrize("p", [131, 1009])
def test_rader_tables_match_reference(p):
    _same(luts.rader_tables(p), ref_luts.rader_tables(p))


@pytest.mark.parametrize("kw", [
    {},
    {"fft_axes": (0, 2), "normalize": True, "batch": 3},
    {"kind": "R2C", "precision": "DOUBLE"},
    {"kind": "DCT", "rr_type": 4, "precision": "BFLOAT16"},
    {"zeropad_input": (None, (2, 8), None), "zeropad_output": ((0, 4), None, None),
     "keep_intermediate_order": True},
    {"convolution": True, "matrix_convolution": 2, "coordinate_features": 2,
     "conjugate_convolution": 1, "cross_power_spectrum_normalization": True},
])
def test_config_from_reference_round_trip(kw):
    kw = dict(kw)
    for key, enum in (("kind", vkfft_tpu.TransformKind),
                      ("precision", vkfft_tpu.Precision)):
        if key in kw:
            kw[key] = enum[kw[key]]
    ref = vkfft_tpu.FFTConfig(shape=(4, 8, 16), **kw)
    cfg = config_from_reference(dataclasses.asdict(ref))
    assert isinstance(cfg, FFTConfig)
    assert isinstance(cfg.kind, TransformKind)
    assert isinstance(cfg.precision, Precision)
    for f in dataclasses.fields(ref):
        a, b = getattr(cfg, f.name), getattr(ref, f.name)
        assert getattr(a, "value", a) == getattr(b, "value", b), f.name
    assert cfg.axes == ref.axes
    # and back: the port's fields build the reference's config
    again = vkfft_tpu.FFTConfig(**{
        k: (type(getattr(ref, k))(v.value) if hasattr(v, "value") else v)
        for k, v in dataclasses.asdict(cfg).items()})
    assert again == ref


def test_config_from_reference_rejects_unknown_field():
    with pytest.raises(ValueError):
        config_from_reference({"shape": (8,), "no_such_field": 1})


def test_version():
    assert vkfft_tpu_torch.get_version() == vkfft_tpu.get_version()


def test_import_isolation_subprocess():
    code = (
        "import sys\n"
        "import vkfft_tpu_torch\n"
        "import vkfft_tpu_torch.api, vkfft_tpu_torch.ops.torch_engine\n"
        "import vkfft_tpu_torch.ops.cuda_engine, vkfft_tpu_torch.ops.cuda_kernels\n"
        "import vkfft_tpu_torch.transforms.conv\n"
        "import vkfft_tpu_torch.precision.doubledouble\n"
        "import vkfft_tpu_torch.precision.dd_kernel\n"
        "import vkfft_tpu_torch.precision.dd_fft\n"
        "import vkfft_tpu_torch.cache, vkfft_tpu_torch.debug\n"
        "import vkfft_tpu_torch.planner.native\n"
        "import vkfft_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'vkfft_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|vkfft_tpu)(?:[\s.,]|$)", re.M)


def test_import_isolation_source_scan():
    files = sorted((REPO / "vkfft_tpu_torch").rglob("*.py"))
    assert {"doubledouble.py", "dd_kernel.py", "dd_fft.py"} <= {
        f.name for f in files if f.parent.name == "precision"}
    assert {"cache.py", "debug.py", "native.py", "cli.py"} <= {
        f.name for f in files}
    examples = sorted((REPO / "examples_torch").glob("*.py"))
    assert len(examples) == 11   # _common.py and the ten twins
    files += examples + [REPO / "chip_smoke.py", REPO / "bench_torch_long.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not _FORBIDDEN.search(text), f
        assert "import jax" not in text, f
