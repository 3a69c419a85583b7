"""The double-double tier of the torch port on the CPU: the EFTs against
exact results; the plain versions of the `fft_dd` kernel (`dd_lines_plain`,
`dd_strided_plain`) against the JAX package's ``dd_fft_pallas`` and
``dd_fft_strided_pallas`` in interpret mode; `fft_dd` and
`FFTApplication(DOUBLE)` against the JAX package and numpy fp64 on every
route (kernel, four-step, Rader, Bluestein) and input form; each route's
exact launches, counted by the wrappers on meta tensors with the library
call stubbed out and held to `dd_route`; the refusals.  Inputs pass to both
packages through `ddc_from_reference`.  The CUDA kernel itself runs only on
the card (chip_smoke.py)."""
import contextlib
import fractions
import math
import types

import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.precision import dd_fft as jdd_fft
from vkfft_tpu.precision import doubledouble as jddm
from vkfft_tpu.precision.dd_kernel import (dd_fft_pallas,
                                           dd_fft_strided_pallas)

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.planner.factorize import is_prime, prime_factors
from vkfft_tpu_torch.precision import dd_fft, dd_kernel
from vkfft_tpu_torch.precision import doubledouble as ddm

REF_TOL = 1e-13      # the port against the JAX package, of max|ref|
NUMPY_TOL = 5e-14    # against numpy fp64 (sample 19's gate, cli.py:633)
FOUR_STEP_TOL = 2e-14  # test_doubledouble.py:129, to n = 6144
SAMPLE_19 = (8, 64, 100, 256, 101, 1024, 17, 97)


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _np(x: ddm.DDComplex) -> np.ndarray:
    return ddm.ddc_to_complex128(x).cpu().numpy()


def _planes_of(jx) -> list:
    return [np.asarray(p) for p in (jx.re.hi, jx.re.lo, jx.im.hi, jx.im.lo)]


def _port(jx) -> ddm.DDComplex:
    return ddm.ddc_from_reference(*_planes_of(jx), device="cpu")


def _jnp(jy) -> np.ndarray:
    p = [np.asarray(t, np.float64) for t in _planes_of(jy)]
    return (p[0] + p[1]) + 1j * (p[2] + p[3])


@pytest.fixture(scope="module")
def ref():
    """The JAX package's dd results on seeded inputs, computed once: the
    two Pallas kernels in interpret mode (both directions), `fft_dd` at n
    = 16 and `FFTApplication(DOUBLE, engine="jnp")` of (8, 16)."""
    out = {"lines_in": jddm.ddc_from_complex128(_cplx((3, 16), 16)),
           "strided_in": jddm.ddc_from_complex128(_cplx((2, 16, 8), 17)),
           "fft_dd_in": _cplx((2, 16), 18),
           "app_in": jddm.ddc_from_complex128(_cplx((8, 16), 19))}
    pallas_engine.set_interpret(True)
    try:
        for inv in (False, True):
            out["lines", inv] = dd_fft_pallas(out["lines_in"], 16, inv)
            out["strided", inv] = dd_fft_strided_pallas(out["strided_in"],
                                                        16, inv)
    finally:
        pallas_engine.set_interpret(False)
    out["fft_dd"] = jdd_fft.fft_dd(out["fft_dd_in"])
    app = vk.FFTApplication(vk.FFTConfig(shape=(8, 16),
                                         precision=vk.Precision.DOUBLE),
                            engine="jnp")
    out["app"] = app.forward(out["app_in"])
    return out


# ---------------------------------------------------------------------------
# The EFTs (test_doubledouble.py:11-34).
# ---------------------------------------------------------------------------

def _f32(seed, count, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(count) * scale).astype(np.float32)


def _exact(v) -> fractions.Fraction:
    return fractions.Fraction(float(v))


def test_two_sum_and_quick_two_sum_are_exact():
    a, b = _f32(1, 64), _f32(2, 64, 1e-5)
    s, e = ddm.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    qs, qe = ddm.quick_two_sum(torch.from_numpy(a), torch.from_numpy(b))
    for i in range(64):
        want = _exact(a[i]) + _exact(b[i])
        assert _exact(s[i]) + _exact(e[i]) == want
        assert _exact(qs[i]) + _exact(qe[i]) == want
        assert float(s[i]) == float(np.float32(a[i] + b[i]))


def test_two_prod_and_split_are_exact():
    a, b = _f32(3, 64), _f32(4, 64, 3.0)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    p, e = ddm.two_prod(ta, tb)
    hi, lo = ddm.split(ta)
    for i in range(64):
        assert _exact(p[i]) + _exact(e[i]) == _exact(a[i]) * _exact(b[i])
        assert _exact(hi[i]) + _exact(lo[i]) == _exact(a[i])
        # hi keeps at most 12 significant bits
        assert (math.frexp(float(hi[i]))[0] * 2 ** 12).is_integer()


def test_dd_split_roundtrip():
    a = np.random.default_rng(0).standard_normal(1000)
    err = np.abs(ddm.dd_to_f64(ddm.dd_from_f64(a)).numpy() - a)
    assert err.max() < 1e-13


def test_dd_mul_precision():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal(512), rng.standard_normal(512)
    got = ddm.dd_to_f64(ddm.dd_mul(ddm.dd_from_f64(a),
                                   ddm.dd_from_f64(b))).numpy()
    assert (np.abs(got - a * b) / np.abs(a * b)).max() < 1e-13


def test_dd_add_precision():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(512), rng.standard_normal(512) * 1e-8
    got = ddm.dd_to_f64(ddm.dd_add(ddm.dd_from_f64(a),
                                   ddm.dd_from_f64(b))).numpy()
    assert np.abs(got - (a + b)).max() < 1e-13
    got = ddm.dd_to_f64(ddm.dd_sub(ddm.dd_from_f64(a),
                                   ddm.dd_from_f64(b))).numpy()
    assert np.abs(got - (a - b)).max() < 1e-13


def test_ddcomplex_arithmetic_and_conversions():
    x, y = _cplx((3, 5), 5), _cplx((3, 5), 6)
    dx, dy = ddm.ddc_from_complex128(x), ddm.ddc_from_complex128(y)
    assert dx.shape == (3, 5) and dx.ndim == 2
    for got, want in ((dx + dy, x + y), (dx - dy, x - y), (dx * dy, x * y),
                      (dx.conj(), x.conj()), (dx[1:, 2], x[1:, 2]),
                      (dx.reshape(15), x.reshape(15))):
        assert _rel(_np(got), want) < 1e-14
    s = dx * ddm.dd_scalar(0.1)
    assert _rel(_np(s), x * 0.1) < 1e-14
    # a complex tensor splits on its device and comes back complex128
    t = ddm.ddc_from_complex128(torch.from_numpy(x))
    assert ddm.ddc_to_complex128(t).dtype == torch.complex128
    assert _rel(_np(t), x) < 1e-15
    jx = jddm.ddc_from_complex128(x)
    px = _port(jx)
    for a, b in zip(px.planes(), _planes_of(jx)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(TypeError):
        ddm.ddc_from_reference(*[p.astype(np.float64)
                                 for p in _planes_of(jx)], device="cpu")


# ---------------------------------------------------------------------------
# The kernel's plain versions against the JAX kernels (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_lines_plain_matches_dd_fft_pallas(ref, inverse):
    calls = dd_kernel.plain_calls
    got = dd_kernel.fft_dd_lines(_port(ref["lines_in"]), inverse)
    assert dd_kernel.plain_calls == calls + 1
    want = _jnp(ref["lines", inverse])
    assert _rel(_np(got), want) <= REF_TOL
    x = _jnp(ref["lines_in"])
    oracle = np.fft.ifft(x) * 16 if inverse else np.fft.fft(x)
    assert _rel(_np(got), oracle) <= NUMPY_TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_strided_plain_matches_dd_fft_strided_pallas(ref, inverse):
    got = dd_kernel.fft_dd_strided(_port(ref["strided_in"]), inverse)
    assert got.shape == (2, 16, 8)
    assert _rel(_np(got), _jnp(ref["strided", inverse])) <= REF_TOL
    x = _jnp(ref["strided_in"])
    oracle = (np.fft.ifft(x, axis=1) * 16 if inverse
              else np.fft.fft(x, axis=1))
    assert _rel(_np(got), oracle) <= NUMPY_TOL


@pytest.mark.parametrize("n", [8, 12, 60, 1000, 1144, 4095])
def test_plain_versions_every_radix(n):
    """The plain walk's radices (primes > 8 as their own stages, the rest
    grouped to 8) against numpy, both entries, the options too."""
    x = _cplx((2, n), n)
    dx = ddm.ddc_from_complex128(x)
    pre, post = _cplx(n, n + 1), _cplx(2 * n, n + 2)
    add = _cplx(2, n + 3)
    q = lambda v: torch.from_numpy(dd_kernel.quads(v))
    got = dd_kernel.fft_dd_lines(dx, True, pre=q(pre), post=q(post),
                                 add=q(add), scale=0.25)
    want = (np.fft.ifft(x * pre) * n * post.reshape(2, n)
            + add[:, None]) * 0.25
    assert _rel(_np(got), want) <= NUMPY_TOL
    if n <= 1000:
        xs = _cplx((2, n, 3), n + 4)
        tab = _cplx(n * 3, n + 5)
        got = dd_kernel.fft_dd_strided(ddm.ddc_from_complex128(xs), False,
                                       pre=q(tab), post=q(tab), scale=3.0)
        t = tab.reshape(n, 3)
        want = np.fft.fft(xs * t, axis=1) * t * 3.0
        assert _rel(_np(got), want) <= NUMPY_TOL


def test_pointwise_plain():
    x, t, c = _cplx((3, 5), 30), _cplx(5, 31), _cplx(3, 32)
    q = lambda v: torch.from_numpy(dd_kernel.quads(v))
    got = dd_kernel.dd_pointwise(ddm.ddc_from_complex128(x), q(t), q(c), 0.5)
    assert _rel(_np(got), (x * t + c[:, None]) * 0.5) < 1e-14
    got = dd_fft.dd_scale(ddm.ddc_from_complex128(x), 1.0 / 3.0)
    assert _rel(_np(got), x / 3.0) < 1e-14


def test_kernel_plan_and_gate():
    """The kernel takes every 13-smooth 2 <= n <= 4096 on the fp32
    kernels' plan (radices 2, 4, 8 and odd primes to 13, each odd stage
    with its roots), its values split exactly into quads."""
    for n in range(2, 4097):
        if not dd_kernel.use_dd_kernel(n):
            assert prime_factors(n)[-1] > 13
            continue
        ints, _ = ck.stage_tables(n, False)
        rad = ints[3:3 + ints[1]]
        assert int(np.prod(rad)) == n and all(
            r in (2, 3, 4, 5, 7, 8, 11, 13) for r in rad)
    assert not (dd_kernel.use_dd_kernel(4097) or dd_kernel.use_dd_kernel(17))
    plan, tab = dd_kernel._plan_args(1144, True, "cpu")
    assert tuple(plan) == ck.stage_tables(1144, True)[0]
    want = ck.stage_tables(1144, True)[1]
    q = tab.numpy().astype(np.float64)
    assert tab.dtype == torch.float32 and tab.shape == (len(want), 4)
    got = (q[:, 0] + q[:, 1]) + 1j * (q[:, 2] + q[:, 3])
    assert np.abs(got - want).max() <= 2.0 ** -48  # one split of fp64
    assert np.all(np.abs(q[:, 1]) <= np.abs(q[:, 0]) * 2.0 ** -24)
    with pytest.raises(NotImplementedError, match="dd_route"):
        dd_kernel.fft_dd_lines(ddm.ddc_from_complex128(_cplx((1, 17), 1)))


def test_wrapper_checks():
    x = ddm.ddc_from_complex128(_cplx((2, 8), 40))
    with pytest.raises(TypeError):
        dd_kernel.fft_dd_lines(x.map(lambda p: p.double()))
    with pytest.raises(ValueError):
        dd_kernel.fft_dd_lines(x.map(lambda p: p.t()))
    with pytest.raises(ValueError):
        dd_kernel.fft_dd_strided(x)
    with pytest.raises(ValueError):
        dd_kernel.fft_dd_lines(x, add=torch.zeros(3, 4))
    with pytest.raises(ValueError):
        dd_kernel.fft_dd_lines(x, post=torch.zeros(8, 2))
    with pytest.raises(TypeError):
        dd_kernel.fft_dd_lines(vt.Planar(x.re.hi, x.im.hi))


# ---------------------------------------------------------------------------
# fft_dd against the JAX package and numpy.
# ---------------------------------------------------------------------------

def test_fft_dd_matches_reference(ref):
    got = dd_fft.fft_dd(ref["fft_dd_in"], device="cpu")
    assert _rel(got, ref["fft_dd"]) <= REF_TOL
    assert _rel(got, np.fft.fft(ref["fft_dd_in"])) <= NUMPY_TOL


def _smallest_smooth_above(n):
    m = n + 1
    while prime_factors(m)[-1] > 13:
        m += 1
    return m


@pytest.mark.parametrize("n", SAMPLE_19 + (1144, 47, 34, 2053))
def test_fft_dd_sample_19_sizes(n):
    """Sample 19's sizes (cli.py:615-633), 11 * 13 * 8 (which the JAX
    kernel refuses) and Bluestein lengths, forward and normalized inverse,
    against numpy fp64."""
    x = _cplx((2, n), n)
    y = dd_fft.fft_dd(x, device="cpu")
    assert isinstance(y, np.ndarray) and y.dtype == np.complex128
    assert _rel(y, np.fft.fft(x)) <= NUMPY_TOL
    z = dd_fft.fft_dd(y, inverse=True, normalize=True, device="cpu")
    assert _rel(z, x) <= NUMPY_TOL


@pytest.mark.parametrize("n", [4096, 6144, "above_cap", 1 << 16])
def test_fft_dd_four_step_lengths(n):
    """test_doubledouble.py:112-131's lengths, the smallest 13-smooth
    length above the kernel's cap (a four-step here), and 2^16."""
    if n == "above_cap":
        n = _smallest_smooth_above(dd_kernel.DD_KERNEL_MAX_N)
        assert dd_fft.dd_route(n)[0] == "four_step"
    x = _cplx((1 if n > 8192 else 2, n), n % 1000)
    y = dd_fft.fft_dd(x, device="cpu")
    tol = FOUR_STEP_TOL if n <= 6144 else NUMPY_TOL
    assert _rel(y, np.fft.fft(x)) <= tol
    z = dd_fft.fft_dd(y, inverse=True, normalize=True, device="cpu")
    assert _rel(z, x) <= tol


# ---------------------------------------------------------------------------
# FFTApplication(DOUBLE).
# ---------------------------------------------------------------------------

def _double(shape, **kw):
    return vt.FFTApplication(vt.FFTConfig(shape=shape,
                                          precision=vt.Precision.DOUBLE, **kw),
                             device="cpu")


def test_application_matches_reference(ref):
    app = _double((8, 16))
    got = app.forward(_port(ref["app_in"]))
    assert isinstance(got, ddm.DDComplex) and got.shape == (8, 16)
    assert _rel(_np(got), _jnp(ref["app"])) <= REF_TOL
    assert _rel(_np(got), np.fft.fft2(_jnp(ref["app_in"]))) <= NUMPY_TOL


def test_application_1d_normalized_round_trip():
    x = _cplx((3, 64), 64)
    app = _double((64,), normalize=True)
    dx = ddm.ddc_from_complex128(x)
    y = app.forward(dx)
    assert _rel(_np(y), np.fft.fft(x)) <= NUMPY_TOL
    z = app.inverse(y)
    assert _rel(_np(z), x) <= NUMPY_TOL


def test_application_host_complex():
    """test_precision_tiers.py:41-63 on the port: host complex128 in and
    out, Planar fp32 widened (lo = 0), complex tensors give complex128
    tensors."""
    n = 64
    app = _double((n,), normalize=True)
    x = _cplx((3, n), 7)
    y = app.forward(x)
    assert isinstance(y, np.ndarray) and y.dtype == np.complex128
    assert _rel(y, np.fft.fft(x)) <= NUMPY_TOL
    z = app.inverse(y)
    assert _rel(z, x) <= NUMPY_TOL
    p = vt.from_complex(torch.from_numpy(x.astype(np.complex64)))
    yd = app.forward(p)
    assert isinstance(yd, ddm.DDComplex)
    assert _rel(_np(yd), np.fft.fft(x)) < 1e-5
    widened = x.astype(np.complex64).astype(np.complex128)
    assert _rel(_np(yd), np.fft.fft(widened)) <= NUMPY_TOL
    t = app.forward(torch.from_numpy(x))
    assert t.dtype == torch.complex128 and _rel(t.numpy(), y) == 0.0
    t = app.forward(torch.from_numpy(x.astype(np.complex64)))
    assert t.dtype == torch.complex128
    with pytest.raises(vt.errors.InvalidConfigError):
        app.forward(torch.ones(3, n))


@pytest.mark.parametrize("shape,axes", [((4, 8, 16), None),
                                        ((2, 17, 6), (1, 2)),
                                        ((3, 5, 1, 12), (0, 1, 3))])
def test_application_nd(shape, axes):
    """A 3-D (4, 8, 16) (strided passes on the non-minor axes), a
    non-minor Rader axis moved last and back, batch dims and a length-1
    axis, against numpy."""
    x = _cplx(shape, len(shape))
    app = _double(shape, fft_axes=axes, normalize=True)
    y = app.forward(ddm.ddc_from_complex128(x))
    assert _rel(_np(y), np.fft.fftn(x, axes=axes)) <= NUMPY_TOL
    z = app.inverse(y)
    assert _rel(_np(z), x) <= NUMPY_TOL


def test_fft_axis_dd_every_route():
    x = _cplx((2, 47, 3), 50)
    for axis, n in ((1, 47), (2, 3)):
        y = dd_fft.fft_axis_dd(ddm.ddc_from_complex128(x), axis, n)
        assert _rel(_np(y), np.fft.fft(x, axis=axis)) <= NUMPY_TOL
    with pytest.raises(ValueError):
        dd_fft.fft_axis_dd(ddm.ddc_from_complex128(x), 1, 46)


# ---------------------------------------------------------------------------
# Routes and launches.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors, every launch counted by
    `cuda_kernels._launch` and sent to a library stub; no plain version and
    no plain-engine call may run."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launches()
    calls, plain = torch_engine.calls, dd_kernel.plain_calls
    yield ck.launches
    assert torch_engine.calls == calls
    assert dd_kernel.plain_calls == plain


def _meta(shape):
    return ddm.DDComplex.of([torch.empty(shape, device="meta")
                             for _ in range(4)])


def _rader_prime_above(n):
    p = n + 1
    while not (is_prime(p) and prime_factors(p - 1)[-1] <= 13):
        p += 1
    return p


def _launches(n):
    """Launches of ``fft_dd`` one direction of length n makes, by its
    route: one pass, two for a four-step, Rader 2 L(p-1) + 1 (X0 on the
    pointwise entry), Bluestein 2 L(m)."""
    route = dd_fft.dd_route(n)
    if route[0] in ("kernel", "four_step"):
        return 1 if route[0] == "kernel" else 2
    core = _launches(route[1])
    return 2 * core + 1 if route[0] == "rader" else 2 * core


ROUTE_CASES = [(256, "kernel", 1), (1144, "kernel", 1),
               (6144, "four_step", 2), (1 << 16, "four_step", 2),
               (101, "rader", 3), (_rader_prime_above(4097), "rader", 5),
               (47, "bluestein", 2), (2053, "bluestein", 4)]


@pytest.mark.parametrize("n,route,per_dir", ROUTE_CASES)
def test_route_launches(monkeypatch, n, route, per_dir):
    """A forward and a normalized inverse through FFTApplication(DOUBLE)
    launch ``fft_dd`` exactly as `dd_route` names, on meta tensors."""
    assert dd_fft.dd_route(n)[0] == route
    assert _launches(n) == per_dir
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,),
                                         precision=vt.Precision.DOUBLE,
                                         normalize=True))
    with _stubbed_launches(monkeypatch) as launches:
        y = app.inverse(app.forward(_meta((2, n))))
        assert y.shape == (2, n)
        assert launches == {k: (2 * per_dir if k == "fft_dd" else 0)
                            for k in ck.KERNEL_SOURCES}


def test_nd_application_launches(monkeypatch):
    """A 3-D application: strided, strided, lines a direction (3), the
    1/N riding the inverse's last pass."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(64, 256, 256),
                                         precision=vt.Precision.DOUBLE,
                                         normalize=True))
    with _stubbed_launches(monkeypatch) as launches:
        y = app.inverse(app.forward(_meta((64, 256, 256))))
        assert y.shape == (64, 256, 256)
        assert launches["fft_dd"] == 6 and sum(launches.values()) == 6


# ---------------------------------------------------------------------------
# The kernel's instantiations: dd_variant and the argument each launch
# passes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_dd_variant_rule(inverse):
    """dd_variant(n) is the power-of-two instantiation exactly when every
    radix of the kernel's plan (`stage_tables`) is 2, 4 or 8, over every
    13-smooth n <= 4096; other lengths have no variant."""
    pow2 = dd_kernel.DD_VARIANT_RADICES[dd_kernel.DD_POW2]
    general = dd_kernel.DD_VARIANT_RADICES[dd_kernel.DD_GENERAL]
    assert pow2 < general
    seen = set()
    for n in range(2, dd_kernel.DD_KERNEL_MAX_N + 1):
        if not dd_kernel.use_dd_kernel(n):
            continue
        ints, _ = ck.stage_tables(n, inverse)
        radices = set(ints[3:3 + ints[1]])
        want = (dd_kernel.DD_POW2 if radices <= pow2
                else dd_kernel.DD_GENERAL)
        assert dd_kernel.dd_variant(n) == want, n
        assert radices <= dd_kernel.DD_VARIANT_RADICES[want], n
        seen.add(want)
        if want == dd_kernel.DD_POW2:
            assert n & (n - 1) == 0, n
    assert seen == {dd_kernel.DD_POW2, dd_kernel.DD_GENERAL}
    for n in (1, 17, 4097, 8192):
        with pytest.raises(NotImplementedError):
            dd_kernel.dd_variant(n)


@contextlib.contextmanager
def _recorded_launches(monkeypatch):
    """`_stubbed_launches` that also records each library call as (C
    entry, arguments before the stream)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args[:-1])) or 0

    with _stubbed_launches(monkeypatch) as launches:
        monkeypatch.setattr(ck, "_library", lambda name: Lib())
        yield launches, calls


POW2, GENERAL = dd_kernel.DD_POW2, dd_kernel.DD_GENERAL
VARIANT_CASES = [("sample9_n256", (16384, 256), 2, POW2),
                 ("sample9_n1024", (4096, 1024), 2, POW2),
                 ("3d_64x256x256", (64, 256, 256), 6, POW2),
                 ("four_step_n65536", (64, 1 << 16), 4, POW2),
                 ("n1144", (2, 1144), 2, GENERAL),
                 ("n4095", (2, 4095), 2, GENERAL),
                 ("n13", (2, 13), 2, GENERAL)]


@pytest.mark.parametrize("name,shape,count,variant", VARIANT_CASES,
                         ids=[c[0] for c in VARIANT_CASES])
def test_variant_launch_arguments(monkeypatch, name, shape, count, variant):
    """A forward and a normalized inverse through FFTApplication(DOUBLE)
    on meta planes: the main path's rows (sample 9, the 3-D row, the
    four-step) pass the power-of-two instantiation to every DFT launch,
    1144, 4095 and 13 the general one, as the last argument before the
    stream; the launch counts are the routes' own."""
    app = vt.FFTApplication(vt.FFTConfig(
        shape=shape[1:] if len(shape) == 2 else shape,
        precision=vt.Precision.DOUBLE, normalize=True))
    with _recorded_launches(monkeypatch) as (launches, calls):
        y = app.inverse(app.forward(_meta(shape)))
        assert y.shape == shape
        assert launches == {k: (count if k == "fft_dd" else 0)
                            for k in ck.KERNEL_SOURCES}
    entries = [e for e, _ in calls]
    assert len(calls) == count and set(entries) <= {"vk_fft_dd_lines",
                                                     "vk_fft_dd_strided"}
    assert [args[-1] for _, args in calls] == [variant] * count


def test_variant_of_each_entry(monkeypatch):
    """Each entry passes dd_variant of its own length: the lines and the
    strided entry at n = 256 and 1144 on meta planes."""
    with _recorded_launches(monkeypatch) as (_, calls):
        for n in (256, 1144):
            dd_kernel.fft_dd_lines(_meta((3, n)))
            dd_kernel.fft_dd_strided(_meta((2, n, 5)), inverse=True)
    assert [(e, a[-1]) for e, a in calls] == [
        ("vk_fft_dd_lines", POW2), ("vk_fft_dd_strided", POW2),
        ("vk_fft_dd_lines", GENERAL), ("vk_fft_dd_strided", GENERAL)]


def test_table_length_limit(monkeypatch):
    """The kernel walks a pre/post table with 32-bit positions: a table of
    2^31 quads or more is refused before any launch (meta tensors hold no
    memory)."""
    x = _meta((2, 64))
    big = torch.empty((1 << 31, 4), device="meta")
    with _recorded_launches(monkeypatch) as (_, calls):
        with pytest.raises(ValueError, match="2\\^31"):
            dd_kernel.fft_dd_lines(x, post=big)
        with pytest.raises(ValueError, match="2\\^31"):
            dd_kernel.fft_dd_strided(_meta((1, 64, 2)), pre=big)
        dd_kernel.fft_dd_lines(x, post=big[:(1 << 31) - 1])
    assert [e for e, _ in calls] == ["vk_fft_dd_lines"]


def test_ptxas_parser_names_each_instantiation():
    """chip_smoke's parser of a ``-Xptxas -v`` log, which reports the
    registers and spills of each fft_dd instantiation, names each kernel
    with its variant."""
    import chip_smoke
    log = ("ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__5150"
           "3a0b_9_fft_dd_cu_6c8e62f115dd_lines_kernelILi0EEEvNS_3In4ENS_4"
           "Out4ExiNS_4PlanEPK6float4NS_4OptsE' for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\nptxas info    : Used 80 registers, used 1 barriers\n")
    assert chip_smoke._ptxas_kernels(log) == [("dd_lines_kernel<0>", 80, 8,
                                               12)]


def test_every_length_has_one_route():
    """dd_route names one route for each n in 2..8192, the one its rules
    give, and its launches follow."""
    seen = set()
    for n in range(2, 8193):
        route = dd_fft.dd_route(n)
        seen.add(route[0])
        smooth = prime_factors(n)[-1] <= 13
        if smooth:
            assert route[0] == ("kernel" if n <= 4096 else "four_step"), n
        elif is_prime(n) and prime_factors(n - 1)[-1] <= 13:
            assert route == ("rader", n - 1), n
        else:
            assert route[0] == "bluestein" and route[1] >= 2 * n - 1, n
        assert _launches(n) >= 1
    assert seen == set(dd_fft.ROUTES)


def test_refusals():
    # the storage tiers run (tests/test_torch_storage.py holds them to the
    # JAX package): a CPU application of each narrows Planar input
    for prec in (vt.Precision.HALF, vt.Precision.BFLOAT16):
        app = vt.FFTApplication(vt.FFTConfig(shape=(16,), precision=prec),
                                device="cpu")
        y = app.forward(vt.Planar(torch.ones(2, 16), torch.zeros(2, 16)))
        assert y.dtype == vt.api.STORAGE[prec]
        assert torch.equal(y.re[:, 0].float(), torch.full((2,), 16.0))
    # the real kinds and convolution ignore the flag and run at the input's
    # dtype, as the JAX package's do (tests/test_torch_f64.py holds them to
    # it); the double-double tier is C2C's alone
    x = np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32)
    for kind in (vt.TransformKind.R2C, vt.TransformKind.DCT,
                 vt.TransformKind.DST):
        cfg = dict(shape=(16,), kind=kind)
        double = vt.FFTApplication(vt.FFTConfig(
            precision=vt.Precision.DOUBLE, **cfg), device="cpu")
        single = vt.FFTApplication(vt.FFTConfig(**cfg), device="cpu")
        np.testing.assert_array_equal(double.forward(x), single.forward(x))
    conv = vt.ConvolutionApplication(
        vt.FFTConfig(shape=(16,), convolution=True,
                     precision=vt.Precision.DOUBLE),
        np.ones(16), device="cpu")
    assert conv(x.astype(np.complex64)).dtype == np.complex64
    # 13-smooth lengths above 4096^2 split into no two kernel lengths
    for n in (1 << 25, 3 * (1 << 24)):
        with pytest.raises(NotImplementedError, match="queue 1 item 16"):
            dd_fft.dd_route(n)
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        _double((1 << 25,)).forward(_meta((1, 1 << 25)))
