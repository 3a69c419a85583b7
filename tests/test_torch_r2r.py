"""The torch port's real-to-real transforms (DCT/DST types I-IV) against
the JAX package's (jnp engine, and the Pallas DCT kernels in interpret mode,
as tests/test_r2r.py runs them) and scipy.fft fp64: dct/idct/dst/idst,
dctn/dstn, FFTApplication(kind=DCT|DST), the plain versions of `fft_dct23`,
`fft_dct1` and `fft_dct4`, the CUDA engine's routing (the kernels' plain
versions and the compositions on CPU tensors), each route's exact launches
counted on meta tensors with the C library stubbed out, and refusals.  The
CUDA kernels themselves run only on the card (chip_smoke.py)."""
import contextlib
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine

NUMPY_TOL = 5e-6
REF_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sample 16/17's and sample 100's lengths, small and odd ones, and 4007, a
# prime past every kernel gate (4006 = 2 * 2003, 4008 = 8 * 3 * 167)
SIZES = [2, 3, 4, 5, 7, 16, 100, 255, 256, 1000, 1024, 4007]
FAMILIES = {"dct": (vt.dct, vt.idct, vk.dct, sfft.dct),
            "dst": (vt.dst, vt.idst, vk.dst, sfft.dst)}


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    try:
        yield
    finally:
        pallas_engine.set_interpret(False)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


# ---------------------------------------------------------------------------
# The slice as a whole, on both engines.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("type", [1, 2, 3, 4])
@pytest.mark.parametrize("family", ["dct", "dst"])
def test_types_match_reference_and_scipy(family, type, n):
    """Each type on the torch engine against the JAX package's jnp engine
    and scipy, and on the CUDA engine's routing (kernel plain versions or
    compositions, CPU tensors) against scipy; both round trips."""
    fwd, inv, ref_fn, sci = FAMILIES[family]
    x = _real((3, n), seed=n * 8 + type + (4 if family == "dst" else 0))
    want = sci(x.astype(np.float64), type=type)
    ref = np.asarray(jax.jit(lambda v: ref_fn(v, type=type, engine="jnp"))(x))
    y = fwd(torch.from_numpy(x), type=type)
    assert y.dtype == torch.float32 and y.shape == (3, n)
    assert _rel(y.numpy(), ref) <= REF_TOL
    assert _rel(y.numpy(), want) <= NUMPY_TOL
    assert _rel(inv(y, type=type).numpy(), x) <= REF_TOL
    calls = torch_engine.calls
    yc = fwd(torch.from_numpy(x), type=type, engine="cuda")
    assert _rel(yc.numpy(), want) <= NUMPY_TOL
    assert _rel(inv(yc, type=type, engine="cuda").numpy(), x) <= REF_TOL
    assert torch_engine.calls == calls


def test_kernel_gates_hold_the_reference_gates():
    """Each kernel's gate takes every n the JAX package's Pallas DCT gates
    take (2n, 2n-2 or 2n+2 with a v3 plan), and more: the stage length is
    the port's own (n, n -+ 1, n/2 or 2n)."""
    for n in range(1, 8200):
        if pallas_engine.use_dct_kernel(n):
            assert ck.dct23_supports(n) and ck.dct4_supports(n), n
        if pallas_engine.use_dct1_kernel(n):
            assert ck.dct1_supports(n, False), n
        if pallas_engine.use_dst1_kernel(n):
            assert ck.dct1_supports(n, True), n
    assert ck.dct23_supports(8192) and not pallas_engine.use_dct_kernel(8192)
    assert ck.dct4_supports(16384) and ck.dct4_supports(4095)
    for n in (2, 3, 4099, 4007, 8209):
        assert not ck.dct23_supports(n), n
    assert not ck.dct1_supports(2, False) and not ck.dct1_supports(8192, False)


# ---------------------------------------------------------------------------
# Each kernel's plain version against the Pallas kernel it replaces.
# ---------------------------------------------------------------------------

PLAIN_CASES = [
    # (kernel, Pallas function, dst, n)
    ("dct2", "dct2_lines", False, 64), ("dct2", "dst2_lines", True, 60),
    ("dct3", "dct3_lines", False, 64), ("dct3", "dst3_lines", True, 45),
    ("dct1", "dct1_lines", False, 65), ("dct1", "dst1_lines", True, 63),
    ("dct4", "dct4_lines", False, 64), ("dct4", "dst4_lines", True, 63),
]


@pytest.mark.parametrize("kernel,pallas_fn,dst,n", PLAIN_CASES)
def test_plain_versions_match_pallas_kernels(interpret, kernel, pallas_fn, dst,
                                             n):
    scale = 0.37
    x = _real((5, n), seed=n + dst)
    wrapper = getattr(ck, "fft_" + kernel)
    before = dict(ck.launches)
    got = wrapper(torch.from_numpy(x), dst, scale).numpy()
    assert ck.launches == before          # CPU tensors run the plain version
    ref = np.asarray(getattr(pallas_engine, pallas_fn)(jnp.asarray(x), scale))
    assert _rel(got, ref) <= REF_TOL
    t = int(kernel[-1])
    want = (sfft.dst if dst else sfft.dct)(x.astype(np.float64), type=t)
    assert _rel(got, want * scale) <= NUMPY_TOL


@pytest.mark.parametrize("dst", [False, True])
@pytest.mark.parametrize("n", [4, 5, 7, 64, 255, 256, 1000, 1023, 1025])
def test_plain_versions_match_scipy(dst, n):
    """Every plain version, at the gates' edges and odd lengths, against
    scipy: the contract each kernel is held to on the card."""
    x = torch.from_numpy(_real((3, n), seed=n))
    xd = x.double().numpy()
    sci = sfft.dst if dst else sfft.dct
    for t, fn in ((2, lambda: ck.fft_dct23_plain(x, False, dst, 1.5)),
                  (3, lambda: ck.fft_dct23_plain(x, True, dst, 1.5)),
                  (1, lambda: ck.fft_dct1_plain(x, dst, 1.5)),
                  (4, lambda: ck.fft_dct4_plain(x, dst, 1.5))):
        assert _rel(fn().numpy(), 1.5 * sci(xd, type=t)) <= NUMPY_TOL, t


# ---------------------------------------------------------------------------
# N-D, the application, and the host surface.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dct", "dst"])
@pytest.mark.parametrize("type", [1, 2, 3, 4])
def test_nd_and_axes_match_reference(family, type):
    fn = vt.dctn if family == "dct" else vt.dstn
    ref_fn = vk.dctn if family == "dct" else vk.dstn
    sci = sfft.dctn if family == "dct" else sfft.dstn
    x = _real((6, 9, 16), seed=type)
    for axes, engine in ((None, None), ((0, 2), "cuda"), ((1,), "cuda")):
        keep = torch.from_numpy(x.copy())
        xt = torch.from_numpy(x.copy())
        y = fn(xt, type=type, axes=axes, engine=engine)
        assert torch.equal(xt, keep)
        ax = (0, 1, 2) if axes is None else axes
        assert _rel(y.numpy(), sci(x.astype(np.float64), type=type, axes=ax)) \
            <= NUMPY_TOL
        ref = np.asarray(jax.jit(lambda v: ref_fn(v, type=type, axes=axes,
                                                  engine="jnp"))(x))
        assert _rel(y.numpy(), ref) <= REF_TOL
    one = vt.dct if family == "dct" else vt.dst
    y0 = one(torch.from_numpy(x), type=type, axis=0, engine="cuda")
    assert y0.is_contiguous()
    assert _rel(y0.numpy(), (sfft.dct if family == "dct" else sfft.dst)(
        x.astype(np.float64), type=type, axis=0)) <= NUMPY_TOL


@pytest.mark.parametrize("kind", ["dct", "dst"])
@pytest.mark.parametrize("rr_type", [1, 2, 3, 4])
def test_application_matches_reference(kind, rr_type):
    shape = (12, 9)
    x = _real((2,) + shape, seed=rr_type)
    jcfg = vk.FFTConfig(shape=shape, kind=vk.TransformKind(kind),
                        rr_type=rr_type)
    japp = vk.FFTApplication(jcfg, engine="jnp")
    jy = np.asarray(japp.forward(x))
    cfg = vt.config_from_reference(dataclasses.asdict(jcfg))
    for engine in ("torch", "cuda"):
        app = vt.FFTApplication(cfg, engine=engine, device="cpu")
        y = app.forward(x)
        assert isinstance(y, np.ndarray) and y.dtype == np.float32
        assert _rel(y, jy) <= REF_TOL
        z = app.inverse(torch.from_numpy(y))
        assert _rel(z.numpy(), np.asarray(japp.inverse(jy))) <= REF_TOL
        assert _rel(z.numpy(), x) <= REF_TOL


def test_config_from_reference_carries_r2r_kind():
    jcfg = vk.FFTConfig(shape=(96, 96), kind=vk.TransformKind.DCT, rr_type=3,
                        fft_axes=(1,))
    cfg = vt.config_from_reference(dataclasses.asdict(jcfg))
    assert cfg.kind is vt.TransformKind.DCT and cfg.rr_type == 3
    assert cfg.axes == (1,) and cfg.shape == (96, 96)


def test_host_input_and_dtypes():
    x = np.random.default_rng(3).standard_normal((2, 100))
    y = vt.dct(x, type=2, device="cpu")
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    assert _rel(y, sfft.dct(x, type=2)) <= NUMPY_TOL
    # a float64 tensor keeps its dtype on the CPU
    yd = vt.dst(torch.from_numpy(x), type=3)
    assert yd.dtype == torch.float64
    assert _rel(yd.numpy(), sfft.dst(x, type=3)) <= 1e-12
    # other real dtypes become float32
    yi = vt.dct(torch.arange(16), type=4)
    assert yi.dtype == torch.float32
    assert _rel(yi.numpy(), sfft.dct(np.arange(16.0), type=4)) <= NUMPY_TOL


# ---------------------------------------------------------------------------
# Routing: exact launches on meta tensors, and the refusals.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch goes through
    `cuda_kernels._launch` and its counter, to a library stub that does
    nothing."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launches()
    calls = torch_engine.calls
    yield ck.launches
    assert torch_engine.calls == calls


# (family, type, n, launches of a forward plus its inverse)
R2R_ROUTES = [
    ("dct", 2, 1024, {"fft_dct23": 2}),     # sample 100
    ("dct", 4, 1024, {"fft_dct4": 2}),
    ("dct", 4, 255, {"fft_dct4": 2}),       # odd n: the 2n form
    ("dct", 2, 255, {"fft_dct23": 2}),
    ("dst", 3, 100, {"fft_dct23": 2}),
    ("dct", 1, 1025, {"fft_dct1": 2}),
    ("dst", 1, 1023, {"fft_dct1": 2}),
    ("dst", 4, 8192, {"fft_dct4": 2}),
    # past the gates: the compositions on the card's FFT kernels
    ("dct", 2, 4099, {"fft_conv_pair": 2}),   # merged rfft, Bluestein 4099
    ("dst", 3, 4099, {"fft_conv_pair": 2}),   # inverse DFT of 4099
    ("dct", 1, 8192, {"fft_conv": 2}),        # extension 16382: Rader 8191
    ("dst", 1, 8190, {"fft_conv": 2}),        # extension 16382
    ("dct", 4, 4099, {"fft_conv_pair": 2}),   # odd: 8198, Bluestein 16640
    # odd: 16418 = SPLIT 8209 x 2, Rader 8209 on two factors
    ("dst", 4, 8209, {"fft_twofactor": 2, "fft_conv_inv": 2}),
    ("dst", 1, 2, {"fft_r2c": 2}),            # extension 6: rfft of 6
    ("dct", 2, 3, {}),                        # n <= 4: tensor butterflies
    ("dst", 4, 2, {}),
]


@pytest.mark.parametrize("family,type,n,want", R2R_ROUTES)
def test_r2r_route_launches(monkeypatch, family, type, n, want):
    fwd, inv = FAMILIES[family][:2]
    x = torch.empty(3, n, device="meta")
    with _stubbed_launches(monkeypatch) as launches:
        y = inv(fwd(x, type=type, engine="cuda"), type=type, engine="cuda")
        assert y.shape == (3, n)
        assert launches == {k: want.get(k, 0) for k in ck.KERNEL_SOURCES}
    kernel = cuda_engine.r2r_route(type, family == "dst", n)
    assert (kernel is not None) == (kernel in want), (kernel, want)


@pytest.mark.parametrize("shape,axes", [((4, 96, 96), (1, 2)),
                                        ((2, 32, 32, 32), (1, 2, 3))])
def test_application_launches(monkeypatch, shape, axes):
    """Sample 101's configurations: one kernel launch per axis a
    direction, the non-minor axes moved last and back."""
    cfg = vt.FFTConfig(shape=shape[1:], kind=vt.TransformKind.DCT, rr_type=2)
    app = vt.FFTApplication(cfg, engine="cuda")
    x = torch.empty(*shape, device="meta")
    with _stubbed_launches(monkeypatch) as launches:
        y = app.inverse(app.forward(x))
        assert y.shape == shape
        assert launches == {k: 2 * len(axes) if k == "fft_dct23" else 0
                            for k in ck.KERNEL_SOURCES}


def test_refusals():
    # zero-pad windows run since queue 1 item 8.1: the forward's input
    # masked, as the JAX package's DCT does
    app = vt.FFTApplication(vt.FFTConfig(shape=(64,), kind=vt.TransformKind.DCT,
                                         zeropad_input=((0, 32),)),
                            device="cpu")
    x = np.random.default_rng(64).standard_normal((2, 64)).astype(np.float32)
    masked = x.copy()
    masked[:, :32] = 0
    got = np.asarray(app.forward(torch.from_numpy(x)))
    want = np.asarray(vt.dct(torch.from_numpy(masked)))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(TypeError):
        vt.dct(torch.zeros(4, 8, dtype=torch.complex64))
    with pytest.raises(TypeError):
        vt.dst(np.zeros((4, 8), np.complex64), device="cpu")
    for fn in (vt.dct, vt.dst, vt.idct, vt.idst, vt.dctn, vt.dstn):
        with pytest.raises(InvalidConfigError, match="1..4"):
            fn(torch.zeros(4, 8), type=5)
    with pytest.raises(InvalidConfigError, match="n >= 2"):
        vt.dct(torch.zeros(4, 1), type=1)
    # float64 on the card is queue 1 item 10, on the kernels and the
    # compositions alike
    for n in (64, 4099):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            vt.dct(torch.empty(2, n, dtype=torch.float64, device="meta"),
                   engine="cuda")
    with pytest.raises(NotImplementedError, match="outside the kernel"):
        ck.fft_dct2(torch.zeros(2, 4099))
    with pytest.raises(ValueError):
        ck.fft_dct4(torch.zeros(2, 64).t())


@pytest.mark.parametrize("n", [64, 255, 4099])
def test_input_left_unchanged(n):
    x = torch.from_numpy(_real((3, n), seed=n))
    keep = x.clone()
    for family in ("dct", "dst"):
        fwd, inv = FAMILIES[family][:2]
        for t in (1, 2, 3, 4):
            y = fwd(x, type=t, engine="cuda")
            yk = y.clone()
            inv(y, type=t, engine="cuda")
            assert torch.equal(x, keep) and torch.equal(y, yk), (family, t)


@pytest.mark.parametrize("n", [96, 255, 256])
@pytest.mark.parametrize("type", [2, 3, 4])
def test_r2r_kernels_get_aligned_lines(monkeypatch, type, n):
    """A contiguous view that starts at an odd float reaches the R2R
    kernels as an 8-byte aligned copy (even-n `fft_dct4` reads float2
    pairs and refuses anything else on the card), with the view's
    values."""
    seen = []

    def recorder(kernel):
        def call(x, dst, scale):
            seen.append(x.data_ptr() % 8)
            return kernel(x, dst, scale)
        return call

    monkeypatch.setattr(cuda_engine, "_R2R_KERNELS",
                        {t: recorder(k)
                         for t, k in cuda_engine._R2R_KERNELS.items()})
    xh = _real((3, n), seed=n + type)
    x = torch.zeros(3 * n + 1)[1:].view(3, n)
    x.copy_(torch.from_numpy(xh))
    assert x.data_ptr() % 8
    for family in ("dct", "dst"):
        fwd, inv, sci_fwd, sci_inv = (
            (vt.dct, vt.idct, sfft.dct, sfft.idct) if family == "dct"
            else (vt.dst, vt.idst, sfft.dst, sfft.idst))
        for fn, sci in ((fwd, sci_fwd), (inv, sci_inv)):
            y = fn(x, type=type, engine="cuda")
            want = sci(xh.astype(np.float64), type=type)
            assert _rel(y.numpy(), want) <= NUMPY_TOL, (family, fn)
    assert seen and not any(seen), seen


def test_module_imports_no_jax():
    code = ("import sys; import vkfft_tpu_torch.transforms.r2r; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vkfft_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(os.path.join(REPO, "vkfft_tpu_torch", "transforms",
                           "r2r.py")) as f:
        text = f.read()
    assert "import jax" not in text and "vkfft_tpu." not in text


@pytest.mark.parametrize("family", ["dct", "dst"])
def test_length_one_matches_scipy(family):
    """n = 1: the port matches scipy for every type but DCT-I (undefined
    below n = 2, as in the JAX package).  The JAX package raises there for
    types III and every idct (recorded in ROADMAP queue 3)."""
    fwd, inv, ref_fn, sci = FAMILIES[family]
    isci = sfft.idct if family == "dct" else sfft.idst
    x = _real((3, 1), seed=1)
    xd = x.astype(np.float64)
    for t in (1, 2, 3, 4):
        if family == "dct" and t == 1:
            continue
        for engine in ("torch", "cuda"):
            y = fwd(torch.from_numpy(x), type=t, engine=engine)
            assert _rel(y.numpy(), sci(xd, type=t)) <= NUMPY_TOL
            z = inv(torch.from_numpy(x), type=t, engine=engine)
            assert _rel(z.numpy(), isci(xd, type=t)) <= NUMPY_TOL
    with pytest.raises(ValueError):
        ref_fn(x, type=3, engine="jnp")
    if family == "dct":
        with pytest.raises(ZeroDivisionError):
            vk.idct(x, type=2, engine="jnp")
