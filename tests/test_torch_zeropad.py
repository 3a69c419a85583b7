"""Zero-pad windows in the port's FFTApplication, on the CPU: the route
resolver (`zeropad_mode` beside the JAX package's pallas engine's), each
elided route's values on the cuda engine's routing (the windowed kernels'
plain versions on CPU tensors) and on the torch engine against numpy fp64
of the masked input and against the JAX package (its pallas engine in
interpret mode on the same route, its jnp engine where the route is
masked), the storage tiers and fp64 planes on the elided routes, the real
kinds and the dd tier's windows, the windowed plain versions against the
unwindowed ones on masked input, the wrappers' checks, and each route's
exact launches on meta tensors with the C library stubbed out (the windows
in their arguments, no copy between the launches of the corner routes).
The kernels themselves run only on the card (chip_smoke.py's zeropad
phases)."""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar
from vkfft_tpu.precision.doubledouble import ddc_from_complex128 as j_ddc
from vkfft_tpu.precision.doubledouble import ddc_to_complex128 as j_ddc_out

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.pcomplex import widened
from vkfft_tpu_torch.precision.doubledouble import (ddc_from_complex128,
                                                    ddc_to_complex128)

NUMPY_TOL = 5e-6     # against numpy fp64 (PERF.md section 2's gate)
REF_TOL = 1e-5       # against the JAX package
F64_TOL = 5e-14      # fp64 planes against numpy
# the storage tiers against the JAX package (tests/test_torch_storage.py)
HALF_REF_TOL = {"BFLOAT16": 1.6e-2, "HALF": 2e-3}


def _c(p):
    """A port or JAX Planar as numpy complex128 (half planes widened)."""
    if isinstance(p, vt.Planar):
        p = widened(p)
        return (p.re.double().numpy() + 1j * p.im.double().numpy())
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mask(a, spec, ndim):
    """numpy ``a`` with the [left, right) window of each trailing axis
    zeroed."""
    a = np.array(a)
    if spec is None:
        return a
    for ax, w in enumerate(spec):
        if w is not None:
            sl = [slice(None)] * a.ndim
            sl[a.ndim - ndim + ax] = slice(*w)
            a[tuple(sl)] = 0
    return a


def _np(y):
    """A result of either package as numpy."""
    if isinstance(y, (vt.Planar, JPlanar)):
        return _c(y)
    if isinstance(y, torch.Tensor):
        return y.numpy()
    return np.asarray(y)


def _zero_cells(shape, spec, ndim):
    return _mask(np.ones(shape), spec, ndim) == 0


def _data(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def _port(x):
    return vt.from_numpy_planar(np.real(x).astype(np.float32),
                                np.imag(x).astype(np.float32))


def _jax(x):
    return JPlanar(jnp.asarray(np.real(x).astype(np.float32)),
                   jnp.asarray(np.imag(x).astype(np.float32)))


# ---------------------------------------------------------------------------
# The resolver: zeropad_mode beside the JAX package's.
# ---------------------------------------------------------------------------

PREFIX = "elided-prefix"
INTERIOR = "elided-interior (forward reads; inverse in-kernel restore)"
BLU = "elided-prefix (bluestein: forward reads; inverse masked)"
# (name, shape, zeropad_input, zeropad_output, the port's cuda mode, the
# JAX package's pallas mode, the gate that decides where they differ)
MODES = [
    ("v3_32", (32,), ((8, 32),), None, PREFIX, PREFIX, None),
    ("interior_1024", (1024,), ((256, 768),), None, INTERIOR, INTERIOR,
     None),
    ("v2_10240", (10240,), ((5120, 10240),), None, PREFIX, PREFIX, None),
    ("v2_10240_output", (10240,), None, ((5120, 10240),), "elided-output",
     "masked", "the port's v2 (fft_twofactor) takes output keeps; the "
     "reference's v2 does not"),
    ("pair_16x32x32", (16, 32, 32), ((8, 16), (16, 32), (16, 32)), None,
     "elided-pair", "elided-axes", "cuda_engine.pair_supports(32, 32) holds; "
     "the reference's pair_available wants 128-multiples"),
    ("pair_out_16x32x32", (16, 32, 32), None, ((8, 16), (16, 32), (16, 32)),
     "elided-pair-output", "masked", "cuda_engine.pair_supports(32, 32) "
     "holds; the reference's pair_available wants 128-multiples"),
    ("axes_40x205", (40, 205), ((17, 40), (100, 205)), None, "elided-axes",
     "elided-axes", None),
    ("axes_2048x4096", (2048, 4096), ((1024, 2048), (2048, 4096)), None,
     "elided-axes", "elided-axes", None),
    ("ex05_8x128x256", (8, 128, 256), ((4, 8), (64, 128), (128, 256)), None,
     "elided-pair", "elided-pair", None),
    ("cube_512", (512, 512, 512), ((256, 512),) * 3, None, "elided-axes",
     "elided-axes", None),
    ("bluestein_10007", (10007,), ((3000, 10007),), None, BLU, BLU, None),
    # Bluestein's read window on each of the port's Bluestein routes:
    # fft_conv, fft_twofactor + fft_conv_inv, the fused long tier
    ("bluestein_383", (383,), ((127, 383),), None, BLU, BLU, None),
    ("bluestein_4054", (4054,), ((2027, 4054),), None, BLU, BLU, None),
    ("bluestein_4213", (4213,), ((1404, 4213),), None, BLU, "masked",
     "the port's fft_twofactor + fft_conv_inv route reads the window at m = "
     "8470; the reference's blu gate (_use_v3(m) or _long_conv_ok(m)) "
     "fails there"),
    ("bluestein_65537", (65537,), ((32768, 65537),), None, BLU, BLU, None),
    ("not_prefix_16", (16,), ((0, 8),), None, "masked", "masked", None),
    ("interior_60", (60,), ((7, 53),), None, INTERIOR, "masked",
     "any interior window of a DIRECT length elides in the port; the "
     "reference's v3_interior_window_ok wants 128-multiples"),
]


@pytest.mark.parametrize("name,shape,zin,zout,port,ref,gate", MODES,
                         ids=[m[0] for m in MODES])
def test_zeropad_mode_table(name, shape, zin, zout, port, ref, gate):
    """The port's cuda-engine mode beside the JAX package's pallas-engine
    mode, in the reference's words; where they differ, ``gate`` names the
    port's gate that decides (the port asks its own kernels' gates, not the
    TPU's)."""
    cfg = dict(shape=shape, zeropad_input=zin, zeropad_output=zout)
    got = vt.FFTApplication(vt.FFTConfig(**cfg), engine="cuda").zeropad_mode
    want = vk.FFTApplication(vk.FFTConfig(**cfg),
                             engine="pallas").zeropad_mode
    assert got == port
    assert want == ref
    assert (got == want) == (gate is None), gate
    # the torch engine masks, as the reference's jnp engine does
    assert vt.FFTApplication(vt.FFTConfig(**cfg),
                             engine="torch").zeropad_mode == "masked"
    assert vk.FFTApplication(vk.FFTConfig(**cfg),
                             engine="jnp").zeropad_mode == "masked"


def test_zeropad_mode_none_and_refusals():
    """No window: no mode.  keep_intermediate_order runs (queue 1 item
    8.2): without a window it has no zero-pad mode either; with one the
    flag is ignored, as the JAX package ignores it, and the elided route
    returns the reference's natural values."""
    assert vt.FFTApplication(vt.FFTConfig(shape=(16,))).zeropad_mode is None
    assert vt.FFTApplication(vt.FFTConfig(
        shape=(16,), keep_intermediate_order=True)).zeropad_mode is None
    cfg = dict(shape=(64,), zeropad_input=((20, 64),),
               keep_intermediate_order=True, normalize=True)
    app = vt.FFTApplication(vt.FFTConfig(**cfg), engine="cuda")
    assert app.zeropad_mode == "elided-prefix"
    re, im = _data((3, 64), 16)
    x = re + 1j * im
    y = app.forward(_port(x))
    assert type(y) is vt.Planar
    pallas_engine.set_interpret(True)
    try:
        ref = vk.FFTApplication(vk.FFTConfig(**cfg), engine="pallas")
        assert ref.zeropad_mode == "elided-prefix"
        want = _np(ref.forward(_jax(x)))
    finally:
        pallas_engine.set_interpret(False)
    assert _rel(_np(y), want) <= 1e-5


# ---------------------------------------------------------------------------
# Values of each route.
# ---------------------------------------------------------------------------

# (name, shape, zeropad_input, zeropad_output, batch, the port's route kind
# on the cuda engine, whether the JAX package's pallas engine runs the
# same kind)
ROUTES = [
    ("v3_in", (32,), ((8, 32),), None, 3, "v3", True),
    ("v3_in_out", (60,), ((7, 60),), ((31, 60),), 3, "v3", True),
    ("v3_out", (32,), None, ((9, 32),), 2, "v3", True),
    ("interior", (1024,), ((256, 768),), None, 2, "interior", True),
    ("v2", (10240,), ((5120, 10240),), None, 2, "v2", True),
    ("pair", (4, 128, 128), ((2, 4), (64, 128), (64, 128)), None, 1, "pair",
     True),
    ("pair_2d", (128, 256), ((64, 128), (128, 256)), None, 1, "pair", True),
    ("pair_out", (4, 128, 128), None, ((2, 4), (64, 128), (64, 128)), 1,
     "pair_out", True),
    ("axes", (40, 205), ((17, 40), (100, 205)), None, 2, "axes", True),
    ("axes_3d", (3, 40, 205), ((2, 3), (17, 40), (100, 205)), None, 1,
     "axes", True),
    ("pair_odd", (5, 12, 20), ((3, 5), (7, 12), (9, 20)), None, 2, "pair",
     False),
    # Bluestein's read window: the JAX package's pallas engine reads the
    # declared-zero tail at 10007 (its forward of a nonzero tail is the
    # whole line's DFT, ROADMAP queue 3's records of the reference), so the
    # port, which never reads it, is held to its jnp engine (the masked
    # route: the same function on inputs that respect the declaration)
    ("masked_bluestein", (10007,), ((3000, 10007),), None, 2, "blu",
     False),
    ("masked_not_prefix", (16,), ((0, 8),), None, 3, "masked", True),
]


def _reference(cfg_kw, x, inverse, same_kind):
    """The JAX package's result: its pallas engine in interpret mode where
    it runs the port's route kind, else its jnp engine."""
    engine = "pallas" if same_kind else "jnp"
    app = vk.FFTApplication(vk.FFTConfig(normalize=True, **cfg_kw),
                            engine=engine)
    pallas_engine.set_interpret(True)
    try:
        y = app.inverse(_jax(x)) if inverse else app.forward(_jax(x))
        return _c(y)
    finally:
        pallas_engine.set_interpret(False)


@pytest.mark.parametrize("name,shape,zin,zout,B,kind,same", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_values(name, shape, zin, zout, B, kind, same):
    """Each route on the cuda engine's routing and on the torch engine:
    the forward and the normalized inverse against numpy fp64 of the
    masked input (NUMPY_TOL) and against the JAX package on the same route
    kind (REF_TOL), the declared-zero outputs exactly 0.0.  On inputs that
    respect the declaration, and, for the kinds the two packages share, on
    inputs that do not (a spectrum with values in a declared-zero output
    region, data in a declared-zero input region): the contract, not just
    the happy path."""
    nd = len(shape)
    cfg_kw = dict(shape=shape, zeropad_input=zin, zeropad_output=zout)
    cfg = vt.FFTConfig(normalize=True, **cfg_kw)
    apps = {e: vt.FFTApplication(cfg, engine=e, device="cpu")
            for e in ("cuda", "torch")}
    assert apps["cuda"].zeropad_route()["kind"] == kind
    re, im = _data((B,) + shape, seed=len(name) + B)
    x = re.astype(np.float64) + 1j * im
    dims = tuple(range(1, nd + 1))
    respecting = _mask(x, zin, nd)
    spec = _mask(np.fft.fftn(respecting, axes=dims), zout, nd)
    back = _mask(np.fft.ifftn(spec, axes=dims), zin, nd)
    zeros_f = _zero_cells(x.shape, zout, nd)
    zeros_i = _zero_cells(x.shape, zin, nd)
    for engine, app in apps.items():
        y = _c(app.forward(_port(respecting)))
        z = _c(app.inverse(_port(spec)))
        assert _rel(y, spec) <= NUMPY_TOL, engine
        assert _rel(z, back) <= NUMPY_TOL, engine
        assert (y[zeros_f] == 0).all() and (z[zeros_i] == 0).all()
        assert _rel(y, _reference(cfg_kw, respecting, False, same)) <= REF_TOL
        assert _rel(z, _reference(cfg_kw, spec, True, same)) <= REF_TOL
    if not same:
        return
    # inputs that do not respect the declaration, on the shared kinds:
    # the forward of data in its zero windows, the inverse of a whole
    # spectrum
    X = np.fft.fftn(x, axes=dims)
    for engine, app in apps.items():
        if engine == "torch" and kind != "masked":
            continue   # the torch engine masks; its contract is masked's
        y = _c(app.forward(_port(x)))
        z = _c(app.inverse(_port(X)))
        assert _rel(y, _reference(cfg_kw, x, False, same)) <= REF_TOL
        assert _rel(z, _reference(cfg_kw, X, True, same)) <= REF_TOL
        assert (y[zeros_f] == 0).all() and (z[zeros_i] == 0).all()


@pytest.mark.parametrize("shape,zin,zout", [
    ((48,), ((13, 48),), ((30, 48),)),
    ((4, 16, 32), ((3, 4), (9, 16), (20, 32)), None)])
def test_tensor_and_host_input_take_the_route(shape, zin, zout):
    """Complex tensors and host arrays become planes before the walk, so
    they take the elided route of `Planar` input and give the JAX
    package's `Planar` results (its pallas engine in interpret mode)."""
    cfg_kw = dict(shape=shape, zeropad_input=zin, zeropad_output=zout)
    app = vt.FFTApplication(vt.FFTConfig(normalize=True, **cfg_kw),
                            engine="cuda", device="cpu")
    assert app.zeropad_route()["kind"] in ("v3", "pair")
    re, im = _data((2,) + shape, seed=11)
    x = re + 1j * im
    want = _reference(cfg_kw, x, False, same_kind=True)
    t = app.forward(torch.from_numpy(x.astype(np.complex64)))
    assert t.dtype == torch.complex64
    assert _rel(t.numpy(), want) <= REF_TOL
    h = app.forward(x.astype(np.complex64))
    assert isinstance(h, np.ndarray) and _rel(h, want) <= REF_TOL
    back = _reference(cfg_kw, want, True, same_kind=True)
    assert _rel(app.inverse(t).numpy(), back) <= REF_TOL


@pytest.mark.parametrize("tier", list(HALF_REF_TOL))
@pytest.mark.parametrize("name,shape,zin", [
    ("v3", (64,), ((17, 64),)),
    ("pair", (4, 32, 64), ((2, 4), (13, 32), (33, 64)))])
def test_half_planes(tier, name, shape, zin):
    """bf16 / fp16 Planar input on the v3 and pair routes: the result of
    the storage dtype, within the tier's REF_TOL of the JAX package's jnp
    engine at the same tier (its masked route: the same function)."""
    cfg_kw = dict(shape=shape, normalize=True, zeropad_input=zin,
                  precision=getattr(vt.Precision, tier))
    app = vt.FFTApplication(vt.FFTConfig(**cfg_kw), engine="cuda",
                            device="cpu")
    assert app.zeropad_route(
        "cuda", vt.api.STORAGE[app.config.precision])["kind"] == name
    ref = vk.FFTApplication(
        vk.FFTConfig(**dict(cfg_kw, precision=getattr(vk.Precision, tier))),
        engine="jnp")
    re, im = _data((2,) + shape, seed=5)
    x = re + 1j * im
    y = app.forward(_port(x))
    assert y.dtype == vt.api.STORAGE[app.config.precision]
    ry = ref.forward(_jax(x))
    assert _rel(_c(y), _c(ry)) <= HALF_REF_TOL[tier]
    z = app.inverse(y)
    rz = ref.inverse(ry)
    assert _rel(_c(z), _c(rz)) <= HALF_REF_TOL[tier]
    zero = _zero_cells(z.shape, zin, len(shape))
    assert (_c(z)[zero] == 0).all()


def test_native_fp64_v3():
    """float64 planes under SINGLE on the v3 route (the fp64 windowed
    fft_lines' plain version): within 5e-14 of numpy."""
    zin, zout = ((9, 40),), ((21, 40),)
    app = vt.FFTApplication(vt.FFTConfig(shape=(40,), normalize=True,
                                         zeropad_input=zin,
                                         zeropad_output=zout),
                            engine="cuda", device="cpu")
    assert app.zeropad_route("cuda", torch.float64)["kind"] == "v3"
    re, im = _data((3, 40), seed=40, dtype=np.float64)
    x = _mask(re + 1j * im, zin, 1)
    p = vt.from_numpy_planar(x.real, x.imag)
    y = app.forward(p)
    assert y.dtype == torch.float64
    want = _mask(np.fft.fft(x), zout, 1)
    assert _rel(_c(y), want) <= F64_TOL
    assert _rel(_c(app.inverse(y)), _mask(np.fft.ifft(want), zin, 1)) <= F64_TOL


def _layout(a, layout):
    """numpy complex ``a`` as port planes of ``layout``: ``transposed_im``
    (re contiguous, im a transposed view of the last two axes, which are
    square) or ``interleaved`` (``Planar(z.real, z.imag)`` of a complex
    tensor: both planes of last stride 2)."""
    if layout == "interleaved":
        z = torch.from_numpy(a.astype(np.complex64))
        return vt.Planar(z.real, z.imag)
    im = torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(a.imag, -1, -2)).astype(np.float32)).transpose(-1, -2)
    return vt.Planar(torch.from_numpy(a.real.astype(np.float32)), im)


@pytest.mark.parametrize("layout", ("transposed_im", "interleaved"))
@pytest.mark.parametrize("kind,shape,zin,zout,B", [
    ("v3", (32,), ((8, 32),), ((20, 32),), 32),
    ("pair", (4, 32, 32), ((2, 4), (16, 32), (16, 32)), None, 1),
    ("pair_out", (4, 32, 32), None, ((2, 4), (16, 32), (16, 32)), 1),
    ("axes", (205, 205), ((100, 205), (100, 205)), None, 1)])
def test_elided_routes_take_planes_of_any_layout(layout, kind, shape, zin,
                                                 zout, B):
    """`Planar` input whose planes do not share one layout (im a transposed
    view of a square plane) or whose last dim is not contiguous
    (`Planar(z.real, z.imag)`) gives the elided routes' values, forward and
    normalized inverse, against numpy fp64 of the masked input: the walks
    read corners through one set of strides, so such planes are copied
    once first."""
    nd = len(shape)
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True,
                                         zeropad_input=zin,
                                         zeropad_output=zout),
                            engine="cuda", device="cpu")
    assert app.zeropad_route()["kind"] == kind
    re, im = _data((B,) + shape, seed=B + nd)
    x = _mask(re.astype(np.float64) + 1j * im, zin, nd)
    dims = tuple(range(1, nd + 1))
    spec = _mask(np.fft.fftn(x, axes=dims), zout, nd)
    y = app.forward(_layout(x, layout))
    assert _rel(_c(y), spec) <= NUMPY_TOL
    z = app.inverse(_layout(spec, layout))
    assert _rel(_c(z), _mask(np.fft.ifftn(spec, axes=dims), zin, nd)) \
        <= NUMPY_TOL


@pytest.mark.parametrize("layout", ("transposed_im", "interleaved"))
def test_windowed_engine_calls_take_planes_of_any_layout(layout):
    """The cuda engine's windowed calls on such planes directly: fft_axis_p
    with keeps on a strided and on the minor axis, fft_pair_p with
    corners and fft_lines_p with a kept prefix, each against the same call
    on contiguous copies of the planes."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    re, im = _data((3, 16, 16), seed=3)
    a = re.astype(np.float64) + 1j * im
    x, c = _layout(a, layout), _port(a)
    for got, want in (
            (cuda_engine.fft_axis_p(x, 1, plan_axis(16), in_keep=5,
                                    out_keep=9),
             cuda_engine.fft_axis_p(c, 1, plan_axis(16), in_keep=5,
                                    out_keep=9)),
            (cuda_engine.fft_axis_p(x, 2, plan_axis(16), in_keep=5),
             cuda_engine.fft_axis_p(c, 2, plan_axis(16), in_keep=5)),
            (cuda_engine.axis_window(x, 1, plan_axis(16)),
             cuda_engine.fft_axis_p(c, 1, plan_axis(16))),
            (cuda_engine.fft_pair_p(x, 16, 16, in_keep=(5, 7),
                                    out_keep=(9, 0)),
             cuda_engine.fft_pair_p(c, 16, 16, in_keep=(5, 7),
                                    out_keep=(9, 0))),
            (cuda_engine.fft_lines_p(x, plan_axis(16), in_keep=5),
             cuda_engine.fft_lines_p(c, plan_axis(16), in_keep=5))):
        assert got.shape == want.shape
        assert _rel(_c(got), _c(want)) <= 1e-6


# ---------------------------------------------------------------------------
# The real kinds and the dd tier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,rr", [("R2C", 2), ("DCT", 2), ("DCT", 4),
                                     ("DST", 1), ("DST", 3)])
def test_real_kinds_mask_the_forward_input(kind, rr):
    """R2C, DCT and DST mask the forward's input with zeropad_input and
    ignore zeropad_output, as the JAX package's real kinds do
    (``vkfft_tpu/api.py:311-312``, ``:325-326``): equal to its jnp
    engine's both ways (ROADMAP queue 3 records the quirk)."""
    shape = (6, 32)
    cfg_kw = dict(shape=shape, kind=getattr(vt.TransformKind, kind),
                  rr_type=rr, zeropad_input=((3, 6), (20, 32)),
                  zeropad_output=((1, 3), (5, 9)))
    ref = vk.FFTApplication(vk.FFTConfig(**dict(
        cfg_kw, kind=getattr(vk.TransformKind, kind))), engine="jnp")
    x = _data((2,) + shape, seed=7)[0]
    want = ref.forward(jnp.asarray(x))
    wb = _np(ref.inverse(want))
    for engine in ("cuda", "torch"):
        app = vt.FFTApplication(vt.FFTConfig(**cfg_kw), engine=engine,
                                device="cpu")
        y = app.forward(torch.from_numpy(x))
        assert _rel(_np(y), _np(want)) <= REF_TOL, engine
        assert _rel(_np(app.inverse(y)), wb) <= REF_TOL, engine


def test_dd_tier_masks_unlike_the_reference():
    """DOUBLE on the dd tier (DDComplex input) masks the windows as the
    port's other tiers do: the masked transform, hi and lo planes alike.
    The JAX package's dd tier returns before its masks
    (``vkfft_tpu/api.py:391-416``) and gives the unmasked transform: the
    difference is pinned here (ROADMAP queue 3)."""
    shape, zin, zout = (24,), ((10, 24),), ((5, 9),)
    kw = dict(shape=shape, normalize=True, zeropad_input=zin,
              zeropad_output=zout)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 24)) + 1j * rng.standard_normal((2, 24))
    app = vt.FFTApplication(vt.FFTConfig(precision=vt.Precision.DOUBLE,
                                         **kw), device="cpu")
    y = ddc_to_complex128(app.forward(ddc_from_complex128(x))).numpy()
    masked = _mask(np.fft.fft(_mask(x, zin, 1)), zout, 1)
    assert _rel(y, masked) <= F64_TOL
    back = ddc_to_complex128(app.inverse(ddc_from_complex128(masked)))
    assert _rel(back.numpy(), _mask(np.fft.ifft(masked), zin, 1)) <= F64_TOL
    ref = vk.FFTApplication(vk.FFTConfig(precision=vk.Precision.DOUBLE, **kw),
                            engine="jnp")
    ry = np.asarray(j_ddc_out(ref.forward(j_ddc(x))))
    assert _rel(ry, np.fft.fft(x)) <= F64_TOL      # unmasked
    assert _rel(ry, masked) > 0.1
    # the native fp64 route (complex128) masks too
    y = app.forward(torch.from_numpy(x)).numpy()
    assert _rel(y, masked) <= F64_TOL


# ---------------------------------------------------------------------------
# The windowed plain versions against the unwindowed ones.
# ---------------------------------------------------------------------------

def _keeps(n):
    return sorted({1, 7, n - 1, n // 3 + 2} & set(range(1, n)))


LINE_FORMS = ("in_keep", "in_keep_cropped", "in_window", "out_keep",
              "out_fill", "out_zero_window")


@pytest.mark.parametrize("kernel,n", [("fft_lines", 60), ("fft_lines", 256),
                                      ("fft_twofactor", 10240)])
@pytest.mark.parametrize("form", LINE_FORMS)
def test_lines_windows_plain(kernel, n, form):
    """Each window form of fft_lines and fft_twofactor (CPU planes: their
    plain versions with the window) against the unwindowed plain version
    on masked input, then cropped or filled: keeps of 1, 7, n - 1 and
    values off the 4- and 16-point groups, interior windows at those
    edges."""
    run = getattr(ck, kernel)
    plain = ck.fft_lines_plain if kernel == "fft_lines" else \
        ck.fft_twofactor_plain
    re, im = (torch.from_numpy(t) for t in _data((3, n), seed=n))
    t = torch.arange(n)
    for i, k in enumerate(_keeps(n)):
        inv = i % 2 == 1
        win = (k, n - 1) if k < n - 1 else (1, k)
        if form in ("in_window", "out_zero_window") and win[0] >= win[1]:
            continue
        if form == "in_keep":
            y = run(re, im, inv, window=ck.line_window(n, in_keep=k))
            keep = t < k
            w = plain(torch.where(keep, re, 0.0), torch.where(keep, im, 0.0),
                      inv)
        elif form == "in_keep_cropped":
            y = run(re[:, :k].contiguous(), im[:, :k].contiguous(), inv,
                    window=ck.line_window(n, in_keep=k))
            keep = t < k
            w = plain(torch.where(keep, re, 0.0), torch.where(keep, im, 0.0),
                      inv)
        elif form == "in_window":
            y = run(re, im, inv, window=ck.line_window(n, in_window=win))
            keep = (t < win[0]) | (t >= win[1])
            w = plain(torch.where(keep, re, 0.0), torch.where(keep, im, 0.0),
                      inv)
        elif form == "out_keep":
            y = run(re, im, inv, window=ck.line_window(n, out_keep=k))
            w = tuple(v[:, :k] for v in plain(re, im, inv))
        elif form == "out_fill":
            y = run(re, im, inv,
                    window=ck.line_window(n, out_keep=k, out_fill=True))
            w = tuple(torch.where(t < k, v, 0.0) for v in plain(re, im, inv))
        else:
            y = run(re, im, inv,
                    window=ck.line_window(n, out_zero_window=win))
            keep = (t < win[0]) | (t >= win[1])
            w = tuple(torch.where(keep, v, 0.0) for v in plain(re, im, inv))
        assert y[0].shape == w[0].shape
        assert torch.equal(y[0], w[0]) and torch.equal(y[1], w[1]), (form, k)


@pytest.mark.parametrize("form", ("in_keep", "in_keep_cropped", "out_keep",
                                  "corner"))
def test_strided_windows_plain(form):
    """fft_strided's keeps (CPU planes) against the unwindowed plain
    version on masked rows, then cropped: whole and cropped rows, and a
    corner of wider planes read through its strides."""
    P, n, S = 2, 48, 10
    re, im = (torch.from_numpy(t) for t in _data((P, n, S + 3), seed=48))
    rows = torch.arange(n)[None, :, None]
    for k in _keeps(n):
        xr, xi = re[..., :S].contiguous(), im[..., :S].contiguous()
        masked = [torch.where(rows < k, v, 0.0) for v in (xr, xi)]
        if form == "in_keep":
            y = ck.fft_strided(xr, xi, in_keep=k)
            w = ck.fft_strided_plain(*masked, False)
        elif form == "in_keep_cropped":
            y = ck.fft_strided(xr[:, :k].contiguous(), xi[:, :k].contiguous(),
                               True, in_keep=k, n=n)
            w = ck.fft_strided_plain(*masked, True)
        elif form == "out_keep":
            y = ck.fft_strided(xr, xi, out_keep=k)
            w = tuple(v[:, :k] for v in ck.fft_strided_plain(xr, xi, False))
        else:
            view = [v.reshape(P, n, 1, S + 3)[..., :S] for v in (re, im)]
            y = ck.fft_strided(*view, in_keep=k, out_keep=k)
            w = tuple(v[:, :k].reshape(P, k, 1, S)
                      for v in ck.fft_strided_plain(*masked, False))
        assert y[0].shape == w[0].shape
        assert torch.equal(y[0], w[0]) and torch.equal(y[1], w[1]), (form, k)


@pytest.mark.parametrize("plane", [(16, 20), (12, 7)])
def test_pair_windows_plain(plane):
    """fft_pair's corners (CPU planes) against the unwindowed plain version
    on the masked plane, then cropped: read from whole planes and from the
    cropped corner, written cropped."""
    ny, nz = plane
    re, im = (torch.from_numpy(t) for t in _data((2, ny, nz), seed=ny))
    yy, zz = torch.arange(ny)[:, None], torch.arange(nz)[None, :]
    for ky, kz in [(1, min(7, nz - 1)), (min(7, ny - 1), nz - 1),
                   (ny - 1, 1), (ny // 3 + 2, 0), (0, nz // 3 + 2)]:
        cy, cz = ky or ny, kz or nz
        keep = (yy < cy) & (zz < cz)
        masked = [torch.where(keep, v, 0.0) for v in (re, im)]
        w = ck.fft_pair_plain(*masked, False)
        y = ck.fft_pair(re, im, in_keep=(ky, kz))
        assert torch.equal(y[0], w[0]) and torch.equal(y[1], w[1])
        y = ck.fft_pair(re[:, :cy, :cz].contiguous(),
                        im[:, :cy, :cz].contiguous(), in_keep=(ky, kz),
                        plane=(ny, nz))
        assert torch.equal(y[0], w[0]) and torch.equal(y[1], w[1])
        w = ck.fft_pair_plain(re, im, True)
        y = ck.fft_pair(re, im, True, out_keep=(ky, kz))
        assert torch.equal(y[0], w[0][:, :cy, :cz])
        assert torch.equal(y[1], w[1][:, :cy, :cz])


def test_wrapper_window_checks():
    """The windows refuse keeps outside 0 < keep < n, windows outside 0 <
    left < right < n, two options on one side, out_fill without out_keep
    (`line_window`, and a `LineWindow` built by hand), and the wrappers
    an out= that aliases the input on a cropped write."""
    re, im = (torch.from_numpy(t) for t in _data((2, 16), seed=16))
    for kw in (dict(in_keep=16), dict(in_keep=-1), dict(out_keep=17),
               dict(in_window=(0, 8)), dict(in_window=(4, 16)),
               dict(out_zero_window=(8, 8)),
               dict(in_keep=4, in_window=(5, 9)),
               dict(out_keep=4, out_zero_window=(5, 9)),
               dict(out_fill=True)):
        with pytest.raises(ValueError):
            ck.fft_lines(re, im, window=ck.line_window(16, **kw))
    for bad in ((16, 17, (0, 0), 16, (0, 0)), (16, 16, (0, 16), 16, (0, 0)),
                (16, 16, (0, 0), 0, (0, 0)), (16, 16, (0, 0), 16, (9, 8))):
        with pytest.raises(ValueError):
            ck.LineWindow(*bad)
    with pytest.raises(ValueError, match="aliases"):
        ck.fft_lines(re, im, window=ck.line_window(16, out_keep=8),
                     out=(re.view(-1)[:16].view(2, 8),
                          im.view(-1)[:16].view(2, 8)))
    y = ck.fft_lines(re, im, window=ck.line_window(16, in_keep=8),
                     out=(re, im))   # whole lines: ok
    assert y[0] is re
    p3 = [t.reshape(2, 4, 4) for t in (re, im)]
    with pytest.raises(ValueError):
        ck.fft_strided(*p3, in_keep=4)
    with pytest.raises(ValueError):
        ck.fft_pair(*p3, in_keep=(4, 0))
    with pytest.raises(ValueError, match="factor mode"):
        ck.fft_strided(*p3, in_keep=2, post=ck.twiddle(16))
    with pytest.raises(ValueError, match="natural order"):
        ck.fft_twofactor(re, im, window=ck.line_window(16, in_keep=4),
                         swapped=True)


def test_axis_keeps_on_the_cuda_engine():
    """cuda_engine.fft_axis_p honours in_keep / out_keep (the JAX package's
    fft_axis_p contract): only the kept rows read, only the kept rows
    written; on the minor axis, on a strided axis, and on axes off the
    windowed kernels (a mask and a slice: a non-minor axis of
    fft_twofactor's length 67, Rader's 131 on both axes)."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    for shape, axis in (((3, 16, 6), 1), ((3, 6, 16), 2), ((3, 17, 4), 1),
                        ((2, 67, 3), 1), ((2, 131, 3), 1), ((2, 3, 131), 2)):
        re, im = (torch.from_numpy(t) for t in _data(shape, seed=shape[axis]))
        x = vt.Planar(re, im)
        n = shape[axis]
        keep = (torch.arange(n) < 5).reshape([-1 if a == axis else 1
                                              for a in range(3)])
        masked = vt.Planar(torch.where(keep, re, 0.0),
                           torch.where(keep, im, 0.0))
        want = cuda_engine.fft_axis_p(masked, axis, plan_axis(n))
        got = cuda_engine.fft_axis_p(x, axis, plan_axis(n), in_keep=5)
        assert _rel(_c(got), _c(want)) <= 1e-6
        got = cuda_engine.fft_axis_p(x, axis, plan_axis(n), out_keep=5)
        whole = cuda_engine.fft_axis_p(x, axis, plan_axis(n))
        assert got.shape[axis] == 5
        assert _rel(_c(got), _c(whole[(slice(None),) * axis
                                      + (slice(0, 5),)])) <= 1e-6


# ---------------------------------------------------------------------------
# Launches on meta tensors.
# ---------------------------------------------------------------------------

class _Ops(TorchDispatchMode):
    """Records each aten op and each launch, in order."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.log.append(("op", func, args))
        return out


@contextlib.contextmanager
def _stubbed(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch recorded as
    (C entry, its window's ints); no plain version and no plain-engine call
    may run."""
    log = []
    real_launch = ck._launch

    def launch(name, entry, device, args, dtype=torch.float32):
        log.append(("launch", entry, [
            list(a) for a in args if isinstance(a, ctypes.Array)
            and a._type_ is ctypes.c_longlong]))
        return real_launch(name, entry, device, args, dtype)

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("fft_lines_plain", "fft_twofactor_plain",
                 "fft_strided_plain", "fft_pair_plain"):
        monkeypatch.setattr(ck, name, _no_plain)
    ck.reset_launches()
    before = torch_engine.calls
    yield log
    assert torch_engine.calls == before


def _no_plain(*args, **kw):
    raise AssertionError("a plain version ran on meta planes")


def _meta(shape, dtype=torch.float32):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


_COPIES = ("aten.clone", "aten.copy_", "aten.constant_pad_nd",
           "aten.contiguous", "aten.cat", "aten.stack")


def _copies_between_launches(log):
    """The data copies between the first and the last launch: every copy
    op but the host tables' uploads (a copy from the CPU)."""
    idx = [i for i, e in enumerate(log) if e[0] == "launch"]
    found = []
    for e in log[idx[0]:idx[-1]]:
        if e[0] != "op":
            continue
        name = str(e[1])
        if name.startswith("aten._to_copy"):
            if e[2] and getattr(e[2][0], "device", None) == torch.device(
                    "cpu"):
                continue
            found.append(name)
        elif name.startswith(_COPIES):
            found.append(name)
    return found


# (name, shape, zeropad_input, zeropad_output, batch, the launches of a
# forward and a normalized inverse in order, each (C entry, its window
# ints: fft_lines/fft_twofactor (s0, s1, d1, d2, s2, len, z0, z1, out, o0,
# o1), fft_strided (in_plane, in_row, cs, cw, in_keep, out_keep),
# fft_pair (in_plane, out_plane, in_row, out_row, ky, kz, oy, oz)))
LAUNCHES = [
    ("v3", (64,), ((20, 64),), ((33, 64),), 3, [
        ("fft_lines_zp", [0, 0, 1, 3, 64, 20, 0, 0, 64, 33, 64]),
        ("fft_lines_zp", [0, 0, 1, 3, 64, 33, 0, 0, 64, 20, 64])]),
    ("interior", (1024,), ((256, 768),), None, 2, [
        ("fft_lines_zp", [0, 0, 1, 2, 1024, 1024, 256, 768, 1024, 0, 0]),
        ("fft_lines_zp", [0, 0, 1, 2, 1024, 1024, 0, 0, 1024, 256, 768])]),
    ("v2", (10240,), ((5121, 10240),), None, 2, [
        ("fft_twofactor_zp",
         [0, 0, 1, 2, 10240, 5121, 0, 0, 10240, 0, 0]),
        ("fft_twofactor_zp",
         [0, 0, 1, 2, 10240, 10240, 0, 0, 10240, 5121, 10240])]),
    ("pair", (8, 32, 64), ((3, 8), (13, 32), (33, 64)), None, 2, [
        # the outer pass on the (13, 33) corner of the whole cube, read in
        # place; the pair kernel from the corner to whole planes
        ("fft_strided_zp", [8 * 32 * 64, 32 * 64, 64, 33, 3, 8]),
        ("fft_pair_zp", [13 * 33, 32 * 64, 33, 64, 13, 33, 32, 64]),
        # inverse: the pair kernel writes the corner, the outer pass its
        # kept rows of it, and the zeros are restored once
        ("fft_pair_zp", [32 * 64, 13 * 33, 64, 33, 32, 64, 13, 33]),
        ("fft_strided_zp", [8 * 13 * 33, 13 * 33, 0, 0, 8, 3])]),
    ("pair_out", (8, 32, 64), None, ((3, 8), (13, 32), (33, 64)), 1, [
        ("fft_pair_zp", [32 * 64, 13 * 33, 64, 33, 32, 64, 13, 33]),
        ("fft_strided_zp", [0, 13 * 33, 0, 0, 8, 3]),
        ("fft_strided_zp", [0, 32 * 64, 64, 33, 3, 8]),
        ("fft_pair_zp", [13 * 33, 32 * 64, 33, 64, 13, 33, 32, 64])]),
    ("axes", (4, 40, 205), ((2, 4), (17, 40), (100, 205)), None, 2, [
        # minor-first on the (2, 17) corner of the lines, read in place
        ("fft_lines_zp", [4 * 40 * 205, 40 * 205, 2, 17, 205, 100, 0, 0,
                          205, 0, 0]),
        ("fft_strided_zp", [17 * 205, 205, 0, 0, 17, 40]),
        ("fft_strided_zp", [2 * 40 * 205, 40 * 205, 0, 0, 2, 4]),
        # inverse: outer-first, each pass writing its kept rows
        ("fft_strided_zp", [4 * 40 * 205, 40 * 205, 0, 0, 4, 2]),
        ("fft_strided_zp", [40 * 205, 205, 0, 0, 40, 17]),
        ("fft_lines_zp", [0, 0, 1, 2 * 2 * 17, 205, 205, 0, 0, 100, 0, 0])]),
]


@pytest.mark.parametrize("name,shape,zin,zout,B,want", LAUNCHES,
                         ids=[c[0] for c in LAUNCHES])
def test_elided_launches(monkeypatch, name, shape, zin, zout, B, want):
    """Each elided route on CUDA planes launches exactly the windowed
    entries it names, in order, with the windows in their arguments; no
    unwindowed launch, no plain version, no plain-engine call; on the
    corner routes no copy of the data between the first launch and the
    last (the refill of a cropped result comes after it)."""
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True,
                                         zeropad_input=zin,
                                         zeropad_output=zout), engine="cuda")
    copies = []
    with _stubbed(monkeypatch) as log:
        x = _meta((B,) + shape)
        for inverse in (False, True):
            start = len(log)
            with _Ops(log):
                x = app.inverse(x) if inverse else app.forward(x)
            copies += _copies_between_launches(log[start:])
        assert x.shape == (B,) + shape
    launches = [e for e in log if e[0] == "launch"]
    got = [(entry, win[0]) for _, entry, win in launches]
    assert got == want
    assert sum(ck.launches.values()) == sum(ck.f64_launches.values()) == 0
    assert sum(ck.storage_launches.values()) == 0
    assert ck.zp_launches == {k: sum(1 for e, _ in want if e == k)
                              for k in ck.zp_launches}
    assert copies == []


@pytest.mark.parametrize("tier", ["bf16", "f16"])
def test_elided_launches_half(monkeypatch, tier):
    """The storage tiers' elided routes launch the half instantiations of
    the windowed entries."""
    prec = vt.Precision.BFLOAT16 if tier == "bf16" else vt.Precision.HALF
    app = vt.FFTApplication(vt.FFTConfig(
        shape=(8, 32, 64), normalize=True, precision=prec,
        zeropad_input=((3, 8), (13, 32), (33, 64))), engine="cuda")
    with _stubbed(monkeypatch) as log:
        app.inverse(app.forward(_meta((2, 8, 32, 64))))
    assert [e[1] for e in log if e[0] == "launch"] == [
        f"fft_strided_zp_{tier}", f"fft_pair_zp_{tier}",
        f"fft_pair_zp_{tier}", f"fft_strided_zp_{tier}"]


@pytest.mark.parametrize("shape,zin,want", [
    ((16,), ((0, 8),), {"fft_lines": 2}),
    ((10007,), ((3000, 5000),), {"fft_conv_pair": 2}),
    ((4, 16, 8), (None, (0, 4), None), {"fft_pair": 2, "fft_strided": 2})])
def test_masked_launches(monkeypatch, shape, zin, want):
    """A masked route runs its kernels unwindowed: no windowed launch."""
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True,
                                         zeropad_input=zin), engine="cuda")
    assert app.zeropad_mode == "masked"
    with _stubbed(monkeypatch):
        app.inverse(app.forward(_meta((2,) + shape)))
    assert sum(ck.zp_launches.values()) == 0
    assert {k: v for k, v in ck.launches.items() if v} == want
