"""Real and convolution data on float16 / bfloat16 planes, on the CPU.

Half real transforms keep the JAX package's dtypes: its untangle promotes
a half spectrum to float32 (``vkfft_tpu/transforms/r2c.py:173-182``,
``:236-246``), so `rfft`/`rfftn` of half data return float32 planes at
even n and on the merged-sequences route, and `irfft`/`irfftn` return
float32 at even n; the n < 4 / one-line route and the merged inverse stay
at the half dtype.  The port's torch engine and the cuda engine's routing
(the wrappers' plain versions on CPU tensors) against the JAX package's
jnp engine (x64 on, as tests/conftest.py sets it) and numpy fp64 of the
narrowed input; an fp16 `irfftn` whose whole 1/N on the last pass would
overflow.  Half convolution in every fused mode keeps the data's dtype,
against the JAX package's Pallas kernels in interpret mode where it fuses
the same mode and its jnp engine everywhere, the fp16 N-D modes stay
finite at the chip rows' sizes, and an fp16 cross-power composition at
2^20 keeps its range.  Each new route's exact launches, counted
on meta tensors with the library call stubbed out (as
tests/test_torch_storage.py counts them), and the half 2-D entry's fp32
layout and tables.  The kernels themselves run only on the card
(chip_smoke.py's storage phases).  Every test states its seed."""
import collections
import contextlib
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar
from vkfft_tpu.transforms import r2c as jr2c

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.pcomplex import widened
from vkfft_tpu_torch.planner.plan import plan_axis

TIERS = {"BFLOAT16": torch.bfloat16, "HALF": torch.float16}
JDT = {"BFLOAT16": jnp.bfloat16, "HALF": jnp.float16}
# 4 storage ulps of max|ref| against the JAX package, the reference's own
# gates against numpy fp64 (tests/test_torch_storage.py)
REF_TOL = {"BFLOAT16": 1.6e-2, "HALF": 2e-3}
NUMPY_TOL = {"BFLOAT16": 5e-2, "HALF": 5e-3}
ENGINES = ("torch", "cuda")
# (n, lines): a tiny length (the one-line route at every batch), an odd
# one on merged sequences, the real kernels' lengths, Rader's half-length
# (10006 = 2 x 5003) and the long tier's (2^17: 2^16 points a line)
REAL_LINES = ((2, 3), (63, 3), (64, 4), (1024, 4), (10006, 2), (1 << 17, 2))


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _j(p):
    """A JAX Planar as numpy complex128."""
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


def _t(p):
    """A port Planar as numpy complex128 (half planes widened exactly)."""
    p = widened(p)
    return p.re.double().numpy() + 1j * p.im.double().numpy()


def _planes_of(p):
    """A JAX Planar of a half dtype as float32 port planes (exactly)."""
    return vt.Planar(*(torch.from_numpy(np.array(t.astype(jnp.float32)))
                       for t in (p.re, p.im)))


def _jdt(a):
    return str(a.dtype)


def _tdt(t):
    return str(t.dtype)[6:]


@functools.lru_cache(maxsize=None)
def _reference(tier, n, lines):
    """The JAX package's jnp rfft of the narrowed seeded lines, and its
    irfft of that spectrum narrowed to the tier, as (input, spectrum,
    half spectrum, output) numpy arrays with the JAX dtypes."""
    jdt = JDT[tier]
    x = jnp.asarray(_real((lines, n), n)).astype(jdt)
    X = jr2c.rfft(JPlanar(x, jnp.zeros_like(x)), engine="jnp")
    Xh = JPlanar(X.re.astype(jdt), X.im.astype(jdt))
    y = jr2c.irfft(Xh, n=n, engine="jnp")
    return (np.asarray(x.astype(jnp.float32)), X, Xh, y)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n,lines", REAL_LINES,
                         ids=[f"{n}x{b}" for n, b in REAL_LINES])
def test_rfft_irfft_match_reference(tier, engine, n, lines):
    """rfft of half lines, as a Planar and as a tensor, and irfft of the
    half spectrum: each output dtype the JAX package's (float32 planes at
    even n >= 4 and on merged sequences, the half dtype on the one-line
    route; irfft float32 at even n >= 4), values within REF_TOL of its jnp
    engine and within its gate of numpy fp64 (seed n)."""
    dt = TIERS[tier]
    xw, X, Xh, y = _reference(tier, n, lines)
    x = torch.from_numpy(xw.copy()).to(dt)
    got = vt.rfft(vt.Planar(x, torch.zeros_like(x)), engine=engine)
    assert _tdt(got.re) == _jdt(X.re), (got.dtype, X.re.dtype)
    want = np.fft.rfft(xw.astype(np.float64))
    assert _rel(_t(got), _j(X)) <= REF_TOL[tier]
    assert _rel(_t(got), want) <= NUMPY_TOL[tier]
    # a tensor in gives a complex tensor out: complex64 on every route
    # (the JAX package's half one-line route cannot make its complex array)
    tens = vt.rfft(x, engine=engine)
    assert tens.dtype == torch.complex64
    assert _rel(tens.numpy(), _j(X)) <= REF_TOL[tier]
    spec = _planes_of(Xh)
    back = vt.irfft(spec.astype(dt), n=n, engine=engine)
    assert _tdt(back) == _jdt(y), (back.dtype, y.dtype)
    yw = np.asarray(y, np.float64)
    assert _rel(back.double().numpy(), yw) <= REF_TOL[tier]
    assert _rel(back.double().numpy(),
                np.fft.irfft(_t(spec), n=n)) <= NUMPY_TOL[tier]


# (shape of the real data, axes, s of the inverse): 2-D and 3-D, even and
# odd last axes (merged sequences); s the data's own lengths (the JAX
# package's odd routes neither crop nor pad the bins, and its even route
# folds a cropped spectrum's Im(Nyquist) in, where numpy drops it)
VOLUMES = (((2, 16, 64), (1, 2), (16, 64)), ((8, 16, 32), (0, 1, 2), None),
           ((4, 6, 7), (0, 1, 2), (4, 6, 7)))


@functools.lru_cache(maxsize=None)
def _reference_nd(tier, shape, axes, s):
    """The JAX package's jnp rfftn of the narrowed seeded data and its
    irfftn of that spectrum narrowed to the tier, as `_reference`."""
    jdt = JDT[tier]
    x = jnp.asarray(_real(shape, len(shape) + len(axes))).astype(jdt)
    X = jr2c.rfftn(JPlanar(x, jnp.zeros_like(x)), axes=axes, engine="jnp")
    Xh = JPlanar(X.re.astype(jdt), X.im.astype(jdt))
    y = jr2c.irfftn(Xh, s=s, axes=axes, engine="jnp")
    return (np.asarray(x.astype(jnp.float32)), X, Xh, y)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape,axes,s", VOLUMES,
                         ids=["x".join(map(str, v[0])) for v in VOLUMES])
def test_rfftn_irfftn_match_reference(tier, engine, shape, axes, s):
    """rfftn of half data runs the real axis and then the complex axes in
    fp32 (no half pair pass: `r2c_pair_supports` says no to half planes),
    irfftn of the half spectrum each complex axis at the half dtype scaled
    by its own 1/n, then the real axis; each output dtype the JAX
    package's, values within REF_TOL of its jnp engine and its gate of
    numpy fp64 (seed len(shape))."""
    dt = TIERS[tier]
    xw, X, Xh, y = _reference_nd(tier, shape, axes, s)
    xt = torch.from_numpy(xw.copy()).to(dt)
    got = vt.rfftn(vt.Planar(xt, torch.zeros_like(xt)), axes=axes,
                   engine=engine)
    assert _tdt(got.re) == _jdt(X.re)
    assert _rel(_t(got), _j(X)) <= REF_TOL[tier]
    assert _rel(_t(got), np.fft.rfftn(xw.astype(np.float64),
                                      axes=axes)) <= NUMPY_TOL[tier]
    spec = _planes_of(Xh)
    back = vt.irfftn(spec.astype(dt), s=s, axes=axes, engine=engine)
    assert _tdt(back) == _jdt(y)
    assert _rel(back.double().numpy(), np.asarray(y, np.float64)) <= \
        REF_TOL[tier]
    assert _rel(back.double().numpy(),
                np.fft.irfftn(_t(spec), s=s, axes=axes)) <= NUMPY_TOL[tier]


@pytest.mark.parametrize("engine", ENGINES)
def test_fp16_irfftn_keeps_its_range(engine):
    """A (64, 64, 64) fp16 real volume at amplitude 10: its spectrum
    narrowed to fp16 fits (float32 out of rfftn), but the unnormalized
    inverse of its first complex axis (64 times the 2-D spectra of the
    slices) does not; with each complex axis's 1/n on its own pass the
    fp16 irfftn is finite and within fp16's gate of the input, with the
    whole 1/N on the last pass the first pass is inf (seed 12)."""
    x = torch.from_numpy(10 * _real((64, 64, 64), 12)).half()
    X = vt.rfftn(vt.Planar(x, torch.zeros_like(x)), engine=engine)
    assert X.dtype == torch.float32
    Xh = X.astype(torch.float16)
    assert bool(torch.isfinite(Xh.re).all() and torch.isfinite(Xh.im).all())
    y = vt.irfftn(Xh, engine=engine)
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    assert _rel(y.double().numpy(), x.double().numpy()) <= NUMPY_TOL["HALF"]
    first = vt.api.get_engine(engine).fft_axis_p(Xh, 0, plan_axis(64), True)
    assert not bool(torch.isfinite(first.re).all())


# ---------------------------------------------------------------------------
# Convolution.
# ---------------------------------------------------------------------------

def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# (mode, config shape, config flags, batch): every fused mode, with its
# flags on some
CONV_MODES = (
    ("v3_1d", (64,), dict(conjugate_convolution=2), 3),
    ("v3_mat", (64,), dict(matrix_convolution=3, coordinate_features=3), 2),
    ("v3_rows", (67, 64), {}, 2),
    ("pair", (16, 64), dict(cross_power_spectrum_normalization=True), 2),
    ("v2_2k", (10240,), {}, 2))
# the modes the JAX package's Pallas engine fuses the same way
PALLAS_FUSES = ("v3_1d", "v3_mat")


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    yield
    pallas_engine.set_interpret(False)


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("mode,shape,flags,batch", CONV_MODES,
                         ids=[m[0] for m in CONV_MODES])
def test_half_convolution_keeps_its_dtype(interpret, tier, mode, shape,
                                          flags, batch):
    """ConvolutionApplication on half planes in each fused mode, the cuda
    engine's routing on CPU planes (the kernels' plain versions): the
    output of the data's dtype, within REF_TOL of the JAX package's jnp
    engine (whose composition returns float32) and of its Pallas engine in
    interpret mode where that fuses the same mode (whose kernels keep the
    data's dtype); the torch engine's composition keeps it too (seed
    len(shape) + batch)."""
    dt, jdt = TIERS[tier], JDT[tier]
    cfg = vk.FFTConfig(shape=shape, convolution=True, **flags)
    m = cfg.matrix_convolution
    feats = (m,) if m > 1 else ()
    kshape = ((m, m) if m > 1 else ()) + shape
    h = _complex(kshape, 20 + len(shape))
    x = _complex((batch,) + feats + shape, len(shape) + batch)
    jx = JPlanar(jnp.asarray(x.real).astype(jdt),
                 jnp.asarray(x.imag).astype(jdt))
    ref = vk.ConvolutionApplication(cfg, h, engine="jnp")
    want = ref(jx)
    fields = dataclasses.asdict(cfg)
    re, im = np.asarray(ref.kernel_f.re), np.asarray(ref.kernel_f.im)
    px = vt.Planar(torch.from_numpy(x.real.copy()).to(dt),
                   torch.from_numpy(x.imag.copy()).to(dt))
    for engine in ENGINES:
        app = vt.convolution_from_reference(fields, re, im, engine=engine,
                                            device="cpu")
        assert app.fusion_mode == (mode if engine == "cuda" else None)
        got = app(px)
        assert got.dtype == dt and got.shape == px.shape, engine
        assert _rel(_t(got), _j(want)) <= REF_TOL[tier], engine
    if mode in PALLAS_FUSES:
        fused = vk.ConvolutionApplication(cfg, h, engine="pallas")
        assert fused._fused is not None and fused._fused[0] == mode
        kept = fused(jx)
        assert _jdt(kept.re) == str(dt)[6:]
        got = vt.convolution_from_reference(fields, re, im, engine="cuda",
                                            device="cpu")(px)
        assert _rel(_t(got), _j(kept)) <= REF_TOL[tier]


# the N-D rows of chip_smoke.py's storage main path at one item each
FP16_ROWS = ((256, 256), (512, 512), (32, 256, 256))


@pytest.mark.parametrize("shape", FP16_ROWS,
                         ids=["x".join(map(str, s)) for s in FP16_ROWS])
def test_fp16_nd_convolution_stays_finite(shape):
    """The fp16 N-D fused modes (pair, v3_rows, pair after an outer axis)
    at the chip rows' sizes on unit-variance data and a unit-variance
    kernel: the outer axes' unnormalized passes and the fused pass's 1/N
    keep every intermediate within float16's range, and the result is
    finite and within fp16's gate of numpy fp64 on the narrowed planes
    (seed len(shape))."""
    cfg = vt.FFTConfig(shape=shape, convolution=True)
    h = _complex(shape, 30 + len(shape))
    x = _complex((1,) + shape, 40 + len(shape)).astype(np.complex64)
    app = vt.ConvolutionApplication(cfg, torch.from_numpy(h), engine="cuda",
                                    device="cpu")
    assert app.fusion_mode in ("pair", "v3_rows")
    px = vt.Planar(torch.from_numpy(x.real.copy()).half(),
                   torch.from_numpy(x.imag.copy()).half())
    got = app(px)
    assert got.dtype == torch.float16
    assert bool(torch.isfinite(got.re).all() and torch.isfinite(got.im).all())
    axes = tuple(range(1, len(shape) + 1))
    want = np.fft.ifftn(np.fft.fftn(_t(px), axes=axes)
                        * np.fft.fftn(h.astype(np.complex128)), axes=axes)
    assert _rel(_t(got), want) <= NUMPY_TOL["HALF"]


@pytest.mark.parametrize("engine", ENGINES)
def test_fp16_cross_power_composition_keeps_its_range(engine):
    """fp16 cross-power convolution at n = 2^20 (the long tier; no fused
    mode takes cross-power): the unit-magnitude product and its 1/N stay
    in fp32 through the inverse, as the JAX package computes them, and
    only the result is narrowed; a product narrowed at 2^-20 would keep
    about 4 bits.  Within fp16's gate of numpy fp64 on the narrowed input
    (seed 20)."""
    n = 1 << 20
    cfg = vt.FFTConfig(shape=(n,), convolution=True,
                       cross_power_spectrum_normalization=True)
    h = _complex((n,), 20)
    x = _complex((1, n), 21).astype(np.complex64)
    app = vt.ConvolutionApplication(cfg, torch.from_numpy(h), engine=engine,
                                    device="cpu")
    assert app.fusion_mode is None
    px = vt.Planar(torch.from_numpy(x.real.copy()).half(),
                   torch.from_numpy(x.imag.copy()).half())
    got = app(px)
    assert got.dtype == torch.float16
    Y = np.fft.fft(_t(px)) * np.fft.fft(h.astype(np.complex128))
    want = np.fft.ifft(Y / np.abs(Y))
    assert _rel(_t(got), want) <= NUMPY_TOL["HALF"]


# ---------------------------------------------------------------------------
# Launches on meta tensors.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch counted by
    `cuda_kernels._launch` and recorded as (C entry, arguments before the
    stream); no plain version and no plain-engine call may run."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args[:-1])) or 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launches()
    before = torch_engine.calls
    yield calls
    assert torch_engine.calls == before


def _meta(shape, dtype=torch.float32):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


def _counts(sfx):
    """(half launches of the ``sfx`` instantiations by kernel, fp32
    launches by library, fp64 launches, half launches of other
    suffixes)."""
    half = {k[:-len(sfx)]: v for k, v in ck.storage_launches.items()
            if k.endswith(sfx) and v}
    other = {k: v for k, v in ck.storage_launches.items()
             if not k.endswith(sfx) and v}
    fp32 = {k: v for k, v in ck.launches.items() if v}
    return half, fp32, sum(ck.f64_launches.values()), other


def _route(n):
    return dict(collections.Counter(k for k, _, _ in
                                    cuda_engine.route(plan_axis(n))))


# (what, call on meta tensors of dtype dt, output shape, output dtype,
# half launches, fp32 launches): rfft at 1024 (one half fft_lines of 512),
# at 10006 (Rader 5003's half route) and 2^18 (the long tier's 2^17), its
# irfft (one fp32 fft_c2r, or the fp32 half-length route), rfftn / irfftn
# of a (4, 8, 16, 32) volume (the real axis in half fft_lines and the
# complex axes in fp32 fft_strided; back the complex axes in half
# fft_strided and the real axis in fp32 fft_c2r)
REAL_ROUTES = (
    ("rfft 1024", lambda dt: vt.rfft(_meta((3, 1024), dt), engine="cuda"),
     (3, 513), torch.float32, {"fft_lines": 1}, {}),
    ("rfft 10006", lambda dt: vt.rfft(_meta((2, 10006), dt), engine="cuda"),
     (2, 5004), torch.float32, _route(5003), {}),
    ("rfft 2^18", lambda dt: vt.rfft(_meta((2, 1 << 18), dt),
                                     engine="cuda"),
     (2, (1 << 17) + 1), torch.float32, _route(1 << 17), {}),
    ("irfft 1024", lambda dt: vt.irfft(_meta((3, 513), dt), 1024,
                                       engine="cuda"),
     (3, 1024), torch.float32, {}, {"fft_r2c": 1}),
    ("irfft 10006", lambda dt: vt.irfft(_meta((2, 5004), dt), 10006,
                                        engine="cuda"),
     (2, 10006), torch.float32, {}, {"fft_conv": 1}),
    ("rfftn 3-D", lambda dt: vt.rfftn(_meta((4, 8, 16, 32), dt),
                                      axes=(1, 2, 3), engine="cuda"),
     (4, 8, 16, 17), torch.float32, {"fft_lines": 1}, {"fft_strided": 2}),
    ("irfftn 3-D", lambda dt: vt.irfftn(_meta((4, 8, 16, 17), dt),
                                        axes=(1, 2, 3), engine="cuda"),
     (4, 8, 16, 32), torch.float32, {"fft_strided": 2}, {"fft_r2c": 1}))


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("what,call,shape,out_dt,half,fp32", REAL_ROUTES,
                         ids=[r[0] for r in REAL_ROUTES])
def test_real_launches(monkeypatch, tier, what, call, shape, out_dt, half,
                       fp32):
    """Each half real route on meta tensors launches exactly its kernels:
    the C2C of the forward on the half instantiations, the widened
    inverse and the complex axes after a forward's untangle on the fp32
    ones; no fp64 launch, no plain version, no plain-engine call."""
    dt = TIERS[tier]
    sfx = ck._SUFFIX[dt]
    with _stubbed_launches(monkeypatch) as calls:
        y = call(dt)
        out = y.re if isinstance(y, vt.Planar) else y
        assert tuple(out.shape) == shape and out.dtype == out_dt
    assert _counts(sfx) == (half, fp32, 0, {})
    assert len(calls) == sum(half.values()) + sum(fp32.values())


def _conv_case(mode, dt):
    """A ConvolutionApplication of ``mode`` on meta tensors and its half
    data: the CONV_MODES config at batch 2 (a per-slice pair over a
    (4, 32, 32) volume for "pair")."""
    shape, flags = {
        "v3_1d": ((4096,), {}),
        "v3_mat": ((1024,), dict(matrix_convolution=3,
                                 coordinate_features=3)),
        "v3_rows": ((512, 512), {}),
        "pair": ((4, 32, 32), {}),
        "v2_2k": ((10240,), {})}[mode]
    cfg = vt.FFTConfig(shape=shape, convolution=True, **flags)
    m = cfg.matrix_convolution
    kshape = ((m, m) if m > 1 else ()) + shape
    kern = vt.Planar(torch.empty(kshape, device="meta"),
                     torch.empty(kshape, device="meta"))
    app = vt.ConvolutionApplication(cfg, kern, engine="cuda",
                                    kernel_in_freq_domain=True, device="meta")
    assert app.fusion_mode == mode
    return app, _meta((2,) + ((m,) if m > 1 else ()) + shape, dt)


# the half launches of one call of each mode
CONV_LAUNCHES = {"v3_1d": {"fft_conv": 1}, "v3_mat": {"fft_conv": 1},
                 "v3_rows": {"fft_strided": 2, "fft_conv": 1},
                 "pair": {"fft_strided": 2, "fft_conv2d": 1},
                 "v2_2k": {"fft_twofactor": 1, "fft_conv_inv": 1}}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("mode", list(CONV_LAUNCHES))
def test_conv_launches(monkeypatch, tier, mode):
    """Each fused mode on half planes launches exactly its kernels' half
    instantiations (the 2-D mode as ``vk_fft_conv2d_<dtype>``, counted
    apart from fft_conv_pair's Bluestein mode), and returns planes of the
    data's dtype; no fp32 or fp64 launch, no plain-engine call."""
    dt = TIERS[tier]
    sfx = ck._SUFFIX[dt]
    app, x = _conv_case(mode, dt)
    with _stubbed_launches(monkeypatch) as calls:
        y = app(x)
        assert y.dtype == dt and y.shape == x.shape
    want = CONV_LAUNCHES[mode]
    assert _counts(sfx) == (want, {}, 0, {})
    assert sorted(e for e, _ in calls) == sorted(
        f"vk_{k}{sfx}" for k, c in want.items() for _ in range(c))


@pytest.mark.parametrize("tier", list(TIERS))
def test_half_conv2d_takes_fp32_layout_and_tables(monkeypatch, tier):
    """The half 2-D entry of fft_conv_pair gets the fp32 layout
    (`conv2d_layout`: cluster, threads, shared bytes), fp32 plans, stage
    tables, twiddles and spectrum, and writes planes of the storage
    dtype; float64 planes are still refused (ROADMAP queue 1 item 10)."""
    dt = TIERS[tier]
    sfx = ck._SUFFIX[dt]
    dev = torch.device("meta")
    ck._DEVICE_TABLES.clear()
    with _stubbed_launches(monkeypatch) as calls:
        for ny, nz in ((256, 256), (16, 64)):
            q = _meta((3, ny, nz), dt)
            y = ck.fft_conv_pair(q.re, q.im,
                                 torch.empty(2 * ny * nz, 2, device=dev),
                                 conj_data=True, scale=0.5)
            assert y[0].dtype == dt and y[0].shape == (3, ny, nz)
        with pytest.raises(TypeError, match="item 10"):
            f = _meta((3, 16, 64), torch.float64)
            ck.fft_conv_pair(f.re, f.im, torch.empty(1024, 2, device=dev))
    assert [e for e, _ in calls] == [f"vk_fft_conv2d{sfx}"] * 2
    for (e, args), (ny, nz) in zip(calls, ((256, 256), (16, 64))):
        assert args[-3:] == ck.conv2d_layout(ny, nz)[:3]
        assert args[5:8] == (2, ck.CONV_CONJ_DATA, 0.5)
    assert ck._DEVICE_TABLES and all(
        v.dtype == torch.float32 and not any("torch." in str(k_) for k_ in k)
        for k, v in ck._DEVICE_TABLES.items())
    assert ck.storage_launches == {
        k: 2 * (k == f"fft_conv2d{sfx}") for k in ck.storage_launches}
    assert sum(ck.launches.values()) == sum(ck.f64_launches.values()) == 0


def test_refusals_that_stay():
    """float64 real data and convolution on the cuda engine, and half
    planes on the real kernels' own wrappers, stay refused (ROADMAP queue
    1 item 10); `r2c_pair_supports` says no to half planes."""
    f64 = torch.zeros(2, 64, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.rfft_lines_p(f64)
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.conv_fused_v3(vt.Planar(f64, f64), 64,
                                  torch.zeros(64, 2))
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.conv_fused_pair(vt.Planar(f64.reshape(2, 8, 8),
                                              f64.reshape(2, 8, 8)), 8, 8,
                                    torch.zeros(64, 2), 1 / 64)
    for dt in TIERS.values():
        with pytest.raises(TypeError, match="item 10"):
            ck.fft_r2c(torch.zeros(2, 64, dtype=dt))
        assert cuda_engine.r2c_pair_supports(256, 256)
        assert not cuda_engine.r2c_pair_supports(256, 256, dt)
