"""Bluestein's read window (the ``blu`` zero-pad route) in the port, on the
CPU: the route and `zeropad_mode` beside the JAX package's, the forward
of every Bluestein route of `cuda_engine.route` (fft_conv, fft_conv_pair,
fft_twofactor + fft_conv_inv, the fused long tier, the composed long
route) on the cuda engine's CPU routing against the JAX package (its jnp
engine; its pallas engine in interpret mode at sample 7's 10007) and
numpy fp64, with a NaN-poisoned declared-zero tail, the masked inverse,
the storage tiers, the windowed plain versions, the wrappers' checks, and
each route's exact launches on meta tensors with the C library stubbed
out (the windowed entries with their read window, no mask pass in the
forward).  The kernels themselves run only on the card (chip_smoke.py's
zeropad phases)."""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.pcomplex import widened
from vkfft_tpu_torch.planner.plan import plan_axis

NUMPY_TOL = 5e-6     # against numpy fp64 (PERF.md section 2's gate)
REF_TOL = 1e-5       # against the JAX package
TIERS = {"BFLOAT16": torch.bfloat16, "HALF": torch.float16}
# 4 storage ulps of max|ref| against the JAX package, the reference's own
# gates against fp64 (tests/test_torch_storage_routes.py)
HALF_REF_TOL = {"BFLOAT16": 1.6e-2, "HALF": 2e-3}
HALF_NUMPY_TOL = {"BFLOAT16": 5e-2, "HALF": 5e-3}
# the storage tiers' planes at 1/16: the JAX package's fp16 inverse puts
# the whole 1/N on the long tier's last upload (ROADMAP queue 3)
AMPLITUDE = 1.0 / 16
BLU = "elided-prefix (bluestein: forward reads; inverse masked)"

# (name, n, batch, the first kernel of the route cuda_engine.route gives
# the plan): one length of each Bluestein route
ROUTES = [("fft_conv", 383, 3, "fft_conv"),
          ("fft_conv_m8125", 4054, 2, "fft_conv"),
          ("fft_twofactor", 4213, 2, "fft_twofactor"),
          ("fft_conv_pair", 10007, 2, "fft_conv_pair"),
          ("long", 32771, 1, "fft_strided_tw")]
# where the JAX package's pallas engine masks (its gate _use_v3(m) or
# _long_conv_ok(m) does not hold) and the port elides
REF_MASKS = {"fft_twofactor": "the reference's blu gate (_use_v3(8470) or "
                              "_long_conv_ok(8470)) fails; the port's "
                              "fft_twofactor + fft_conv_inv route reads "
                              "the window"}


def _keeps(n):
    """Prefix windows at n / 3, n / 2 and n - 1."""
    return (n // 3, n // 2, n - 1)


def _c(p):
    """A port or JAX Planar as numpy complex128 (half planes widened)."""
    if isinstance(p, vt.Planar):
        p = widened(p)
        return p.re.double().numpy() + 1j * p.im.double().numpy()
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _data(B, n, keep, seed, amplitude=1.0):
    """Seeded float32 planes of (B, n) lines: (with NaN in the declared-
    zero tail [keep, n), with zeros there)."""
    rng = np.random.default_rng(seed)
    re, im = ((amplitude * rng.standard_normal((B, n))).astype(np.float32)
              for _ in range(2))
    nan = [t.copy() for t in (re, im)]
    zero = [t.copy() for t in (re, im)]
    for t in nan:
        t[:, keep:] = np.nan
    for t in zero:
        t[:, keep:] = 0
    return nan, zero


def _cfg(n, keep, **kw):
    return dict(shape=(n,), zeropad_input=((keep, n),), normalize=True, **kw)


def _jax(planes):
    return JPlanar(jnp.asarray(planes[0]), jnp.asarray(planes[1]))


def _port(planes):
    return vt.from_numpy_planar(*planes)


# ---------------------------------------------------------------------------
# The route.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n,B,first", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_and_mode(name, n, B, first):
    """Every Bluestein route takes the blu route on the cuda engine, at
    float32 and the half planes, with the reference's mode string; the JAX
    package's pallas engine gives the same string but where its gate masks
    (REF_MASKS); the torch engine and DOUBLE mask, as do an output window
    and a window off the prefix form."""
    assert cuda_engine.route(plan_axis(n))[0][0] == first
    app = vt.FFTApplication(vt.FFTConfig(**_cfg(n, n // 3)), engine="cuda")
    assert app.zeropad_mode == BLU
    for dt in (torch.float32,) + tuple(TIERS.values()):
        assert app.zeropad_route("cuda", dt) == {"kind": "blu",
                                                 "in_h": n // 3}
    ref = vk.FFTApplication(vk.FFTConfig(**_cfg(n, n // 3)), engine="pallas")
    assert (ref.zeropad_mode == BLU) == (name not in REF_MASKS)
    if name in REF_MASKS:
        assert ref.zeropad_mode == "masked"
    assert vt.FFTApplication(vt.FFTConfig(**_cfg(n, n // 3)),
                             engine="torch").zeropad_mode == "masked"
    for kw in (dict(precision=vt.Precision.DOUBLE),
               dict(zeropad_output=((n // 2, n),)),
               dict(zeropad_input=((n // 3, n - 1),))):
        cfg = dict(_cfg(n, n // 3), **kw)
        assert vt.FFTApplication(vt.FFTConfig(**cfg),
                                 engine="cuda").zeropad_mode == "masked"


# ---------------------------------------------------------------------------
# Values.
# ---------------------------------------------------------------------------

CASES = [(name, n, B, k) for name, n, B, _ in ROUTES for k in _keeps(n)]


@pytest.mark.parametrize("name,n,B,keep", CASES,
                         ids=[f"{c[0]}-keep{c[3]}" for c in CASES])
def test_fp32_matches_reference(name, n, B, keep):
    """The forward of NaN-tailed planes on the cuda engine's CPU routing:
    the same values as the zeroed planes' (nothing reads the tail), within
    REF_TOL of the JAX package's jnp engine and NUMPY_TOL of numpy fp64;
    the normalized inverse is the reference's masked inverse (zeros past
    the window, within REF_TOL)."""
    nan, zero = _data(B, n, keep, seed=n + keep)
    app = vt.FFTApplication(vt.FFTConfig(**_cfg(n, keep)), engine="cuda",
                            device="cpu")
    ref = vk.FFTApplication(vk.FFTConfig(**_cfg(n, keep)), engine="jnp")
    y = app.forward(_port(nan))
    y0 = app.forward(_port(zero))
    assert torch.equal(y.re, y0.re) and torch.equal(y.im, y0.im)
    jy = ref.forward(_jax(zero))
    x = zero[0].astype(np.float64) + 1j * zero[1]
    assert _rel(_c(y), _c(jy)) <= REF_TOL
    assert _rel(_c(y), np.fft.fft(x)) <= NUMPY_TOL
    z = app.inverse(y)
    jz = ref.inverse(jy)
    assert (_c(z)[:, keep:] == 0).all()
    assert _rel(_c(z), _c(jz)) <= REF_TOL
    assert _rel(_c(z), x) <= NUMPY_TOL


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name,n,B,first", ROUTES, ids=[r[0] for r in ROUTES])
def test_half_tiers_match_reference(tier, name, n, B, first):
    """HALF and BFLOAT16 on float32 Planar input (narrowed by the
    application): planes of the storage dtype, a NaN-poisoned tail changing
    nothing, within 4 storage ulps of the JAX package's jnp engine at the
    tier and within its gate of numpy fp64, both ways."""
    keep = n // 3
    nan, zero = _data(B, n, keep, seed=2 * n, amplitude=AMPLITUDE)
    app = vt.FFTApplication(vt.FFTConfig(**_cfg(
        n, keep, precision=vt.Precision[tier])), engine="cuda", device="cpu")
    ref = vk.FFTApplication(vk.FFTConfig(**_cfg(
        n, keep, precision=vk.Precision[tier])), engine="jnp")
    assert app.zeropad_route("cuda", TIERS[tier])["kind"] == "blu"
    y = app.forward(_port(nan))
    y0 = app.forward(_port(zero))
    assert y.dtype == TIERS[tier]
    assert torch.equal(y.re, y0.re) and torch.equal(y.im, y0.im)
    jy = ref.forward(_jax(zero))
    x = zero[0].astype(np.float64) + 1j * zero[1]
    assert _rel(_c(y), _c(jy)) <= HALF_REF_TOL[tier]
    assert _rel(_c(y), np.fft.fft(x)) <= HALF_NUMPY_TOL[tier]
    z = app.inverse(y)
    jz = ref.inverse(jy)
    assert z.dtype == TIERS[tier] and (_c(z)[:, keep:] == 0).all()
    assert _rel(_c(z), _c(jz)) <= HALF_REF_TOL[tier]
    assert _rel(_c(z), x) <= HALF_NUMPY_TOL[tier]


def test_matches_pallas_interpret_10007():
    """Sample 7's 10007 with the window (3000, 10007), batch 2 (the JAX
    package's own test_c2c.py case): the port's forward of NaN-tailed
    planes and its inverse within REF_TOL of the JAX package's pallas
    engine in interpret mode on the same route, which reads the window in
    its fused Bluestein kernel."""
    n, keep = 10007, 3000
    nan, zero = _data(2, n, keep, seed=17)
    cfg = _cfg(n, keep)
    app = vt.FFTApplication(vt.FFTConfig(**cfg), engine="cuda", device="cpu")
    ref = vk.FFTApplication(vk.FFTConfig(**cfg), engine="pallas")
    assert app.zeropad_mode == ref.zeropad_mode == BLU
    y = app.forward(_port(nan))
    pallas_engine.set_interpret(True)
    try:
        jy = ref.forward(_jax(zero))
        jz = ref.inverse(jy)
    finally:
        pallas_engine.set_interpret(False)
    assert _rel(_c(y), _c(jy)) <= REF_TOL
    assert _rel(_c(app.inverse(y)), _c(jz)) <= REF_TOL


def test_composed_route(monkeypatch):
    """The composition on the long DIRECT routes (where m's ns-point lines
    fit no fft_conv; forced here by refusing the fused split): the chirp
    taken over the window only, the same values as the zeroed planes',
    within NUMPY_TOL of numpy both ways."""
    monkeypatch.setattr(ck, "bluestein_long_split", lambda m: None)
    n, keep = 32771, 10000
    assert [k for k, _, _ in cuda_engine.route(plan_axis(n))][0] == \
        "fft_strided_tw"
    nan, zero = _data(1, n, keep, seed=3)
    app = vt.FFTApplication(vt.FFTConfig(**_cfg(n, keep)), engine="cuda",
                            device="cpu")
    assert app.zeropad_mode == BLU
    y = app.forward(_port(nan))
    y0 = app.forward(_port(zero))
    assert torch.equal(y.re, y0.re) and torch.equal(y.im, y0.im)
    x = zero[0].astype(np.float64) + 1j * zero[1]
    assert _rel(_c(y), np.fft.fft(x)) <= NUMPY_TOL
    assert _rel(_c(app.inverse(y)), x) <= NUMPY_TOL


def test_engine_window_on_any_direction():
    """`cuda_engine.fft_lines_p` takes the read window on a Bluestein plan
    in either direction (the API elides the forward only); an interior
    window or an output window stays a mask, and cropped lines too."""
    n, keep = 383, 100
    nan, zero = _data(2, n, keep, seed=5)
    x = zero[0].astype(np.float64) + 1j * zero[1]
    plan = plan_axis(n)
    for inverse in (False, True):
        y = cuda_engine.fft_lines_p(_port(nan), plan, inverse, in_keep=keep,
                                    scale=1.0 / n if inverse else 1.0)
        want = np.fft.ifft(x) if inverse else np.fft.fft(x)
        assert _rel(_c(y), want) <= NUMPY_TOL
    w = ck.line_window(n, in_keep=keep)
    assert cuda_engine.read_window(plan, w) == keep
    for kw in (dict(in_window=(5, 9)), dict(in_keep=keep, out_keep=9),
               dict(out_keep=9, out_fill=True)):
        assert cuda_engine.read_window(plan, ck.line_window(n, **kw)) == 0
    assert cuda_engine.read_window(plan_axis(384), ck.line_window(
        384, in_keep=keep)) == 0
    y = cuda_engine.fft_lines_p(vt.from_numpy_planar(
        *(t[:, :keep].copy() for t in zero)), plan, in_keep=keep)
    assert _rel(_c(y), np.fft.fft(x)) <= NUMPY_TOL


# ---------------------------------------------------------------------------
# The plain versions and the wrappers.
# ---------------------------------------------------------------------------

def _kernel_case(n, dtype=torch.float32):
    """(kernel, its windowed call, its plain call on given planes and
    in_keep) of the Bluestein kernel of n's route."""
    m = plan_axis(n).decomp.bluestein_size
    chirp = ck.bluestein_chirp(n, m, False, "cpu")
    if ck.kernel_supports(m):
        spec = ck.bluestein_spectrum(n, m, False, 1.0, "cpu")
        return ("fft_conv",
                lambda x, k: ck.fft_conv(*x, spec, chirp, in_keep=k),
                lambda x, k: ck.fft_conv_plain(*x, spec, chirp, in_keep=k))
    if ck.conv_pair_plan(m) is not None:
        spec = ck.bluestein_spectrum(n, m, False, 1.0, "cpu", "pair")
        return ("fft_conv_pair",
                lambda x, k: ck.fft_conv_pair(*x, spec, chirp, in_keep=k),
                lambda x, k: ck.fft_conv_pair_plain(*x, spec, chirp,
                                                    in_keep=k))
    kw = dict(pre=ck.chirp(n, False), post=ck.twiddle(m),
              plane=ck.bluestein_long_split(m))
    return ("fft_strided_tw",
            lambda x, k: ck.fft_strided(*x, False, 1.0, in_keep=k, **kw),
            lambda x, k: ck.fft_strided_plain(*x, False, 1.0, in_keep=k,
                                              **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [263, 10007, 32771])
def test_windowed_plain_versions(n, dtype):
    """Each windowed wrapper on CPU tensors (its plain version): NaN past
    the window changes nothing, the same planes as the unwindowed plain
    version of the zeroed lines, of the planes' dtype; in_keep = n is the
    whole line."""
    keep = n // 3 + 1
    nan, zero = _data(2, n, keep, seed=n)
    name, run, plain = _kernel_case(n, dtype)
    x = [torch.from_numpy(t).to(dtype) for t in nan]
    x0 = [torch.from_numpy(t).to(dtype) for t in zero]
    y = run(x, keep)
    assert y[0].dtype == dtype and y[0].shape[0] == 2
    for got, want in zip(y, plain(x0, 0)):
        assert torch.equal(got, want)
    for got, want in zip(run(x0, n), plain(x0, 0)):
        assert torch.equal(got, want)


def test_wrapper_window_checks():
    """A read window outside 0 <= in_keep <= n, on a mode without a chirp,
    on an inverse plane pass, or beside the plane mode's other options is
    refused."""
    n = 263
    m = plan_axis(n).decomp.bluestein_size
    x = [torch.zeros(2, n), torch.zeros(2, n)]
    chirp = ck.bluestein_chirp(n, m, False, "cpu")
    spec = ck.bluestein_spectrum(n, m, False, 1.0, "cpu")
    for k in (-1, n + 1):
        with pytest.raises(ValueError):
            ck.fft_conv(*x, spec, chirp, in_keep=k)
    with pytest.raises(ValueError):
        ck.fft_conv(torch.zeros(2, 256), torch.zeros(2, 256),
                    ck.rader_spectrum(257, 1.0, "cpu"), in_keep=5)
    n2 = 10007
    m2 = plan_axis(n2).decomp.bluestein_size
    y = [torch.zeros(2, n2), torch.zeros(2, n2)]
    with pytest.raises(ValueError):
        ck.fft_conv_pair(*y, ck.bluestein_spectrum(n2, m2, False, 1.0, "cpu",
                                                   "pair"),
                         ck.bluestein_chirp(n2, m2, False, "cpu"),
                         in_keep=n2 + 1)
    kw = dict(pre=ck.chirp(n, False), post=ck.twiddle(m), plane=(11, 49))
    with pytest.raises(ValueError):
        ck.fft_strided(*x, True, 1.0, in_keep=5, **kw)
    with pytest.raises(ValueError):
        ck.fft_strided(*x, False, 1.0, in_keep=n + 1, **kw)
    with pytest.raises(ValueError):
        ck.fft_strided(*x, False, 1.0, in_keep=5, out_keep=3, **kw)


# ---------------------------------------------------------------------------
# Launches on meta tensors.
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Records the name of each aten op."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.log.append(str(func))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _stubbed(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch recorded as
    (C entry, its arguments before the stream); no plain version and no
    plain-engine call may run."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name[3:], args[:-1])) or 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("fft_conv_plain", "fft_conv_pair_plain",
                 "fft_strided_plain", "fft_twofactor_plain",
                 "fft_conv_inv_plain"):
        monkeypatch.setattr(ck, name, _no_plain)
    ck.reset_launches()
    before = torch_engine.calls
    yield calls
    assert torch_engine.calls == before


def _no_plain(*args, **kw):
    raise AssertionError("a plain version ran on meta planes")


def _meta(shape, dtype=torch.float32):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


# the forward's launches of each route under the window: (C entry, whether
# its last argument before the stream is the read window)
WINDOWED = {"fft_conv": [("fft_conv_zp", True)],
            "fft_conv_m8125": [("fft_conv_zp", True)],
            "fft_conv_pair": [("fft_conv_pair_zp", True)],
            "fft_twofactor": [("fft_twofactor", False),
                              ("fft_conv_inv", False)],
            "long": [("fft_strided_tw_zp", True), ("fft_conv", False),
                     ("fft_strided_tw", False)]}


@pytest.mark.parametrize("tier", ["SINGLE"] + list(TIERS))
@pytest.mark.parametrize("name,n,B,first", ROUTES, ids=[r[0] for r in ROUTES])
def test_blu_launches(monkeypatch, tier, name, n, B, first):
    """A forward and a normalized inverse on the blu route: the forward
    launches the windowed entries of its route with the window as their
    read bound (the composed fft_twofactor route its kernels, the chirp
    over the window), as many launches as the unwindowed twin's, and no
    mask pass (no aten.where); the inverse the unwindowed kernels and the
    mask, as the reference's.  The half tiers launch the windowed entries'
    half twins."""
    prec = vt.Precision[tier]
    sfx = "" if tier == "SINGLE" else ck._SUFFIX[TIERS[tier]]
    dt = torch.float32 if tier == "SINGLE" else TIERS[tier]
    keep = n // 3
    app = vt.FFTApplication(vt.FFTConfig(**_cfg(n, keep, precision=prec)),
                            engine="cuda")
    dense = vt.FFTApplication(vt.FFTConfig(shape=(n,), precision=prec),
                              engine="cuda")
    with _stubbed(monkeypatch) as calls:
        dense.forward(_meta((B, n), dt))
        twin = list(calls)
        del calls[:]
        ops = []
        with _Ops(ops):
            y = app.forward(_meta((B, n), dt))
        fwd = list(calls)
        del calls[:]
        ops_inv = []
        with _Ops(ops_inv):
            z = app.inverse(y)
        inv = list(calls)
    assert z.shape == (B, n) and z.dtype == dt
    assert [(e, a[-1] == keep) for e, a in fwd] == [
        (e + sfx, w) for e, w in WINDOWED[name]]
    assert len(fwd) == len(twin)
    assert [e.replace("_zp", "") for e, _ in fwd] == [e for e, _ in twin]
    assert not any("where" in o for o in ops)
    assert [e for e, _ in inv] == [e for e, _ in twin]
    assert any("where" in o for o in ops_inv)
    windowed = {e + sfx for e, w in WINDOWED[name] if w}
    assert {k for k, v in ck.zp_launches.items() if v} == windowed
