"""Plan blobs, the build cache and debug introspection of the torch port
(`vkfft_tpu_torch.cache`, `vkfft_tpu_torch.debug`) against the JAX package's
(``tests/test_cache_debug.py``; reference: binary save/load in sample 0,
``sample_0...cpp:169-199``; keepShaderCode/printMemoryLayout).

The twins of ``tests/test_cache_debug.py``'s cases (``test_dump_hlo`` as a
`dump_kernels` case held to `cuda_engine.route`, ``test_persistent_cache_toggle``
as a case on the build directory); then the blobs of both packages byte for
byte over a sweep of configs, loaded across the packages both ways; a
reloaded application's output against the original's, bit for bit, and the
JAX package's jnp engine within 1e-5; the twin of
``tests/test_planar.py::test_tl_spectrum_survives_plan_reload``; and the
texts of `describe` and `memory_layout`.  The same seeded numpy inputs go
through both packages.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu import cache as jcache
from vkfft_tpu import debug as jdebug

import vkfft_tpu_torch as vt
from vkfft_tpu_torch import cache, debug
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.planner import native, plan_axis

REF_TOL = 1e-5      # vs the JAX package's jnp engine, of max|ref|
NUMPY_TOL = 5e-6    # vs numpy fp64


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(p):
    return (np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64))


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# The twins of tests/test_cache_debug.py.
# ---------------------------------------------------------------------------

def test_plan_save_load_roundtrip():
    cfg = vt.FFTConfig(shape=(64, 32), normalize=True)
    app = vt.FFTApplication(cfg, engine="torch", device="cpu")
    blob = cache.save_application_to_string(app)
    assert blob.startswith(b"VKFFT-TPU-PLAN")
    app2 = cache.load_application_from_string(blob, engine="torch",
                                              device="cpu")
    assert app2.config == cfg
    assert app2.axis_plans.keys() == app.axis_plans.keys()
    for ax in app.axis_plans:
        assert app2.axis_plans[ax].cache_key() == app.axis_plans[ax].cache_key()
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 32))
         + 1j * rng.standard_normal((64, 32))).astype(np.complex64)
    np.testing.assert_array_equal(app2.forward(x), app.forward(x))


def test_load_rejects_garbage():
    with pytest.raises(ValueError):
        cache.load_plan(b"not a plan")


def test_load_rejects_another_algorithm():
    """A blob whose axis names another algorithm than this planner gives
    it is refused, as the JAX package refuses it."""
    blob = cache.save_plan(vt.FFTConfig(shape=(10007,)),
                           {0: plan_axis(10007)})
    bad = blob.replace(b'"bluestein"', b'"rader"')
    for load in (cache.load_plan, jcache.load_plan):
        with pytest.raises(ValueError, match="does not match"):
            load(bad)


@pytest.mark.parametrize("n", (1024, 10007))
def test_load_rejects_other_radices(n):
    """A blob whose axis names other radices than this planner's, as one
    from a planner with other radix limits would, is refused."""
    plan = plan_axis(n)
    blob = cache.save_plan(vt.FFTConfig(shape=(n,)), {0: plan})
    payload = json.loads(blob[len(cache._MAGIC):])
    radices = payload["plans"]["0"]["radices"]
    payload["plans"]["0"]["radices"] = radices[::-1]
    assert radices[::-1] != radices
    bad = cache._MAGIC + json.dumps(payload).encode()
    with pytest.raises(ValueError, match="radices"):
        cache.load_plan(bad)
    with pytest.raises(ValueError, match="radices"):
        cache.load_application_from_string(bad, engine="torch", device="cpu")


def test_describe_and_memory_layout():
    cfg = vt.FFTConfig(shape=(131, 1024))
    app = vt.FFTApplication(cfg, engine="torch", device="cpu")
    text = debug.describe(app)
    assert "rader" in text
    assert "1024" in text
    layout = debug.memory_layout(app)
    assert "pass axis0" in layout and "output" in layout
    # the same texts as the JAX package's, the port's route lines aside
    japp = vk.FFTApplication(vk.FFTConfig(shape=(131, 1024)), engine="jnp")
    assert layout == jdebug.memory_layout(japp)
    mine = [ln for ln in text.splitlines()[1:] if "route" not in ln
            and not ln.startswith("    fft_")]
    theirs = [ln for ln in jdebug.describe(japp).splitlines()[1:]
              if "pallas" not in ln]
    assert mine == theirs


def test_describe_bluestein():
    text = debug.describe_axis(plan_axis(10007))
    assert "bluestein" in text and "padded" in text
    split_text = debug.describe_axis(plan_axis(10006))
    assert "split" in split_text and "5003" in split_text


@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch goes through
    `cuda_kernels._launch` and its counter, to a library stub that does
    nothing (``tests/test_torch_any_length.py``)."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    calls = torch_engine.calls
    yield
    assert torch_engine.calls == calls


@pytest.mark.parametrize("n", [1024, 10007, 7919, 10006, 10240, 1 << 20])
def test_dump_kernels(monkeypatch, n):
    """`dump_kernels` lists the kernels one forward launches, as many times
    as `cuda_engine.route` names them, each with its sources and its nvcc
    command (the twin of ``test_dump_hlo``)."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,)), engine="cuda",
                            device="cpu")
    x = vt.Planar(torch.empty(2, n, device="meta"),
                  torch.empty(2, n, device="meta"))
    want = {}
    for kernel, _, _ in cuda_engine.route(plan_axis(n)):
        want[kernel] = want.get(kernel, 0) + 1
    with _stubbed_launches(monkeypatch):
        assert debug.launched(app.forward, x) == want
        text = debug.dump_kernels(app, x)
        inv = debug.dump_kernels(app, x, inverse=True)
    assert text.splitlines()[0] == f"forward: {sum(want.values())} kernel launches"
    assert inv.startswith(f"inverse: {sum(want.values())} kernel launches")
    for kernel, count in want.items():
        assert f"{kernel} x{count}: C entry vk_{kernel} of {kernel}" in text
        assert f"csrc/{kernel}.cu" in text and "csrc/inplace.cuh" in text
        assert " ".join(ck.NVCC_FLAGS) in text
        assert ck.library_path(kernel) in text
        assert "cuda route (c2c, one direction)" in debug.describe(app)
        assert f"{kernel}(" in debug.describe(app)


def test_dump_kernels_on_cpu_planes():
    """CPU planes run the kernels' plain versions: no launch to list."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,)), device="cpu")
    x = vt.from_numpy_planar(*_data((2, 16), 1))
    assert debug.dump_kernels(app, x) == (
        "forward: 0 kernel launches (planes on the CPU run the plain "
        "versions)")


def test_library_of_entries():
    """Every counted C entry names the library whose source holds it."""
    for entry in debug.launch_counts():
        lib = debug.library_of(entry)
        assert lib in ck.KERNEL_SOURCES, entry
        assert os.path.exists(os.path.join(ck.CSRC_DIR, lib + ".cu"))
    assert debug.library_of("fft_conv2d_zp_bf16") == "fft_conv_pair"
    assert debug.library_of("fft_lines_tl_f16") == "fft_lines"
    assert debug.library_of("fft_pair_f64") == "fft_pair"


def test_persistent_cache_toggle(tmp_path, monkeypatch):
    """`enable_persistent_cache` points the kernels' build directory and
    the native core's at one path; the core then builds there."""
    monkeypatch.setattr(ck, "BUILD_DIR", ck.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "error", None)
    path = str(tmp_path / "build_cache")
    cache.enable_persistent_cache(path)
    assert ck.BUILD_DIR == path and native.BUILD_DIR == path
    assert os.path.dirname(ck.library_path("fft_lines")) == path
    if native.get_lib() is not None:   # a C++ compiler exists
        assert [f for f in os.listdir(path) if f.endswith(".so")] == [
            os.path.basename(native.library_path(native._compiler()))]


def test_save_executable_declines():
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,)), device="cpu")
    assert cache.save_executable(app.forward, np.zeros(16, np.complex64)) is None


# ---------------------------------------------------------------------------
# Blobs across the packages.
# ---------------------------------------------------------------------------

BLOB_CONFIGS = {
    "1d": dict(shape=(1024,), normalize=True),
    "2d": dict(shape=(64, 32)),
    "3d": dict(shape=(8, 16, 32), normalize=True),
    "r2c": dict(shape=(4, 64), kind="R2C"),
    "dct3": dict(shape=(64,), kind="DCT", rr_type=3),
    "dst4": dict(shape=(32,), kind="DST", rr_type=4),
    "double": dict(shape=(256,), precision="DOUBLE", normalize=True),
    "bf16": dict(shape=(64, 64), precision="BFLOAT16"),
    "zeropad": dict(shape=(8, 128, 256), normalize=True,
                    zeropad_input=((4, 8), (64, 128), (128, 256))),
    "zeropad_out": dict(shape=(64, 64), zeropad_output=(None, (16, 48))),
    "keep_order": dict(shape=(4096,), normalize=True,
                       keep_intermediate_order=True),
    "axes_batch": dict(shape=(8, 32, 64), fft_axes=(0, 1), batch=16),
    "rader": dict(shape=(131,)),
    "bluestein": dict(shape=(10007,)),
    "split": dict(shape=(10006,)),
    "mixed": dict(shape=(7919, 6)),
    # small twins of the rows above for the reload cases
    "bluestein_263": dict(shape=(263,)),
    "mixed_131x6": dict(shape=(131, 6)),
    "zeropad_small": dict(shape=(8, 16, 32), normalize=True,
                          zeropad_input=((4, 8), (8, 16), (16, 32))),
}


def _configs(name):
    """The port's and the JAX package's FFTConfig of one entry."""
    kw = dict(BLOB_CONFIGS[name])
    tkw, jkw = dict(kw), dict(kw)
    if "kind" in kw:
        tkw["kind"] = vt.TransformKind[kw["kind"]]
        jkw["kind"] = vk.TransformKind[kw["kind"]]
    if "precision" in kw:
        tkw["precision"] = vt.Precision[kw["precision"]]
        jkw["precision"] = vk.Precision[kw["precision"]]
    return vt.FFTConfig(**tkw), vk.FFTConfig(**jkw)


def _fields(cfg) -> dict:
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("name", sorted(BLOB_CONFIGS))
def test_blob_bytes_match_reference(name):
    """The port's blob of a config is byte for byte the JAX package's."""
    tcfg, jcfg = _configs(name)
    mine = cache.save_application_to_string(
        vt.FFTApplication(tcfg, device="cpu"))
    theirs = jcache.save_application_to_string(
        vk.FFTApplication(jcfg, engine="jnp"))
    assert mine == theirs
    payload = json.loads(mine[len(cache._MAGIC):])
    assert payload["version"] == 2


@pytest.mark.parametrize("name", sorted(BLOB_CONFIGS))
def test_blobs_load_across_packages(name):
    """A blob of either package loads in the other, to the same config and
    the same axis plans."""
    tcfg, jcfg = _configs(name)
    tapp = vt.FFTApplication(tcfg, device="cpu")
    japp = vk.FFTApplication(jcfg, engine="jnp")
    back = jcache.load_application_from_string(
        cache.save_application_to_string(tapp), engine="jnp")
    assert back.config == jcfg
    mine = cache.load_application_from_string(
        jcache.save_application_to_string(japp), device="cpu")
    assert mine.config == tcfg and _fields(mine.config) == _fields(jcfg)
    assert {ax: p.cache_key() for ax, p in mine.axis_plans.items()} == {
        ax: p.cache_key() for ax, p in back.axis_plans.items()}
    # the routes the constructor sets up come with the reloaded app
    assert mine.double_route == tapp.double_route
    assert mine.zeropad_mode == tapp.zeropad_mode


def test_load_refuses_mismatched_plans():
    """An application whose plans differ from the blob's is refused rather
    than patched over."""
    blob = cache.save_application_to_string(
        vt.FFTApplication(vt.FFTConfig(shape=(64, 32)), device="cpu"))
    payload = json.loads(blob[len(cache._MAGIC):])
    payload["plans"]["1"]["n"] = 64
    bad = cache._MAGIC + json.dumps(payload).encode()
    with pytest.raises(ValueError, match="do not match"):
        cache.load_application_from_string(bad, device="cpu")


RELOAD_CASES = ("1d", "3d", "r2c", "double", "zeropad_small", "bluestein_263",
                "mixed_131x6", "split", "dct3")


@pytest.mark.parametrize("name", RELOAD_CASES)
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_reloaded_output_matches(name, engine):
    """A reloaded application's forward and inverse equal the original's
    bit for bit on the CPU (the torch engine, and the cuda engine's
    routing on CPU planes), and the JAX package's jnp engine within 1e-5;
    the forward within 5e-6 of numpy."""
    tcfg, jcfg = _configs(name)
    app = vt.FFTApplication(tcfg, engine=engine, device="cpu")
    app2 = cache.load_application_from_string(
        cache.save_application_to_string(app), engine=engine, device="cpu")
    japp = vk.FFTApplication(jcfg, engine="jnp")
    shape = (2,) + tcfg.shape if len(tcfg.shape) == 1 else tcfg.shape
    re, im = _data(shape, 7)
    if tcfg.kind is not vt.TransformKind.C2C:
        x = re
        want = (np.fft.rfftn(re.astype(np.float64), axes=tcfg.axes)
                if tcfg.kind is vt.TransformKind.R2C else None)
    elif tcfg.precision is vt.Precision.DOUBLE:
        x = re.astype(np.float64) + 1j * im.astype(np.float64)
        want = np.fft.fftn(x, axes=(-1,))
    else:
        x = (re + 1j * im).astype(np.complex64)
        want = np.fft.fftn(x.astype(np.complex128),
                           axes=tuple(a - len(tcfg.shape)
                                      for a in tcfg.axes))
        if tcfg.zeropad_input is not None:
            x = np.asarray(x)
            for ax, (lo, hi) in enumerate(tcfg.zeropad_input):
                idx = [slice(None)] * x.ndim
                idx[ax] = slice(lo, hi)
                x[tuple(idx)] = 0
            want = np.fft.fftn(x.astype(np.complex128))
    y, y2 = app.forward(x), app2.forward(x)
    np.testing.assert_array_equal(y2, y)
    z, z2 = app.inverse(y), app2.inverse(y2)
    np.testing.assert_array_equal(z2, z)
    ref = np.asarray(japp.forward(x))
    assert _rel(np.asarray(y2), ref) <= REF_TOL
    assert _rel(np.asarray(z2), np.asarray(japp.inverse(ref))) <= REF_TOL
    if want is not None:
        assert _rel(np.asarray(y2), want) <= NUMPY_TOL


def test_tl_spectrum_survives_plan_reload():
    """A reloaded application (plan blob round trip) inverts a kept-order
    forward of the original app (the twin of
    ``tests/test_planar.py:180-205``): the disableReorderFourStep contract
    rides the value; a mismatched config refuses rather than mis-slicing."""
    n = 256
    cfg = vt.FFTConfig(shape=(n,), normalize=True,
                       keep_intermediate_order=True)
    app = vt.FFTApplication(cfg, engine="cuda", device="cpu")
    re, im = _data((5, n), 11)
    x = re.astype(np.complex128) + 1j * im
    Y = app.forward(vt.from_numpy_planar(re, im))
    assert isinstance(Y, vt.TlSpectrum)
    app2 = cache.load_application_from_string(
        cache.save_application_to_string(app), engine="cuda", device="cpu")
    z = _c(app2.inverse(Y))
    assert _rel(z, x) < 5e-6
    np.testing.assert_array_equal(z, _c(app.inverse(Y)))
    other = vt.FFTApplication(vt.FFTConfig(shape=(512,), normalize=True),
                              engine="cuda", device="cpu")
    with pytest.raises(InvalidConfigError):
        other.inverse(Y)


# ---------------------------------------------------------------------------
# The texts.
# ---------------------------------------------------------------------------

def test_describe_texts():
    """`describe` names each route's kernels, the twofactor split of the v2
    lengths, DOUBLE's route, the zero-pad mode and a convolution's fused
    mode; `memory_layout` the Bluestein and Rader tables."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(7919, 10240)), device="cpu")
    text = debug.describe(app)
    assert "fft_twofactor(7918) -> fft_conv_inv(7918)" in text
    n1, n2 = ck.twofactor_split(10240)
    assert f"fft_twofactor(10240) split n1={n1} x n2={n2}" in text
    assert "rader" in text
    text = debug.describe(vt.FFTApplication(
        vt.FFTConfig(shape=(256,), precision=vt.Precision.DOUBLE),
        device="cpu"))
    assert "double_route=native" in text
    text = debug.describe(vt.FFTApplication(vt.FFTConfig(
        shape=(64, 64, 64), zeropad_input=((32, 64),) * 3), device="cpu"))
    assert "zeropad=elided-pair" in text
    assert "fft_strided_tw(512) -> fft_strided(2048)" in debug.describe_axis(
        plan_axis(1 << 20))
    layout = debug.memory_layout(vt.FFTApplication(
        vt.FFTConfig(shape=(10007, 131)), device="cpu"))
    assert "temp len 32768" in layout and "conv len 130" in layout
    cfg = vt.FFTConfig(shape=(4096,), convolution=True)
    conv = vt.ConvolutionApplication(cfg, np.ones(4096, np.complex64),
                                     device="cpu")
    assert debug.describe(conv).endswith("fusion=v3_1d")
    conv = vt.ConvolutionApplication(cfg, np.ones(4096, np.complex64),
                                     engine="torch", device="cpu")
    assert "fusion=none" in debug.describe(conv)


def test_profile_trace_on_cpu(tmp_path):
    """`profile_trace` warms up, records ``iters`` calls with their Python
    stacks into a Chrome trace and returns its directory; on the CPU the
    trace holds no device kernel."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(64,)), device="cpu")
    x = vt.from_numpy_planar(*_data((4, 64), 3))
    out = debug.profile_trace(app.forward, x, outdir=str(tmp_path / "t"),
                              iters=2)
    assert out == str(tmp_path / "t")
    events = debug.trace_events(out)
    frames = [e["name"] for e in events if e.get("cat") == "python_function"]
    assert sum("api.py" in f and "forward" in f for f in frames) == 2
    assert any("torch_engine.py" in f for f in frames)
    assert debug.device_ops(out) == []
