"""Lengths of any size on the port's CUDA engine, on the CPU: the plain
versions of `fft_conv`, `fft_twofactor`, `fft_conv_inv` and
`fft_conv_pair` (through their wrappers, on CPU tensors) against the JAX
package's Pallas kernels in interpret mode (as tests/test_pallas.py runs
them) and numpy fp64; Rader, Bluestein, SPLIT and the two-factor DIRECT
lengths through `FFTApplication(engine="cuda")` and the functional API
against the JAX package's jnp engine and numpy; the exact kernel launches
of each route, counted by the wrappers on meta tensors with the library
call stubbed out; the half-length route of the real transforms; non-minor
axes; and the long-tier lengths the engine once refused, now run
(tests/test_torch_long.py holds the long tier itself).  The CUDA kernels
themselves run only on the card (chip_smoke.py)."""
import collections
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu import luts as jluts
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar
from vkfft_tpu.planner.plan import plan_axis as jplan_axis

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.ops.half_length import c2r_pack, r2c_untangle
from vkfft_tpu_torch.planner.plan import plan_axis

NUMPY_TOL = 5e-6
REF_TOL = 1e-5
CPU = torch.device("cpu")
# the reference's sample 7 (Bluestein m = 32768, Rader on two factors, a
# SPLIT around a Rader prime, DIRECT on two factors) and sample 14's
# lengths up to 16384, and two DIRECT lengths with no split into factors
# <= 128, on which the JAX package's Pallas route raises a TypeError
SAMPLE_7 = (10007, 7919, 10006, 10240)
LENGTHS = sorted(set(SAMPLE_7 + (17, 31, 61, 67, 97, 101, 257, 641, 1009,
                                 919, 8215, 8246)))


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    yield
    pallas_engine.set_interpret(False)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jp(re, im):
    return JPlanar(jnp.asarray(re), jnp.asarray(im))


def _dft(x, inverse, scale=1.0):
    n = x.shape[-1]
    return (np.fft.ifft(x, axis=-1) * n if inverse
            else np.fft.fft(x, axis=-1)) * scale


# ---------------------------------------------------------------------------
# Each kernel's plain version against the Pallas kernel it replaces.
# ---------------------------------------------------------------------------

def test_fft_conv_plain_matches_conv_fused_v3(interpret):
    """Scalar-table mode at Rader's p-1 = 130 (p = 131)."""
    p, m = 131, 130
    re, im = _planes((3, m), seed=m)
    got = _c(*ck.fft_conv(*_t(re, im), ck.rader_spectrum(p, 1.0, CPU)))
    b_t = jluts.rader_tables(p)[2]
    ref = pallas_engine.conv_fused_v3(_jp(re, im), m, b_t, scale=1.0 / m)
    assert _rel(got, _c(ref.re, ref.im)) <= REF_TOL
    want = np.fft.ifft(np.fft.fft(_c(re, im)) * b_t)
    assert _rel(got, want) <= NUMPY_TOL


@pytest.mark.parametrize("inverse,scale", [(False, 1.0), (True, 1.0 / 263)])
def test_fft_conv_plain_matches_bluestein_fused_v3(interpret, inverse, scale):
    n = 263
    m = plan_axis(n).decomp.bluestein_size
    assert ck.kernel_supports(m) and pallas_engine.use_conv_v3(m)
    re, im = _planes((3, n), seed=n + inverse)
    got = _c(*ck.fft_conv(*_t(re, im),
                          ck.bluestein_spectrum(n, m, inverse, scale, CPU),
                          ck.bluestein_chirp(n, m, inverse, CPU)))
    ref = pallas_engine.bluestein_fused_v3(_jp(re, im), n, m, inverse,
                                           scale=scale)
    assert _rel(got, _c(ref.re, ref.im)) <= REF_TOL
    assert _rel(got, _dft(_c(re, im), inverse, scale)) <= NUMPY_TOL


@pytest.mark.parametrize("n", [166, 10240])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("order", ["natural", "swapped"])
def test_fft_twofactor_plain_matches_v2_kernel(interpret, n, inverse, order):
    # the port's split is the JAX package's at these lengths, so the two
    # swapped orders are the same order
    assert ck.twofactor_split(n) == pallas_engine.split_lane_major(n)
    n1, n2 = ck.twofactor_split(n)
    scale = 1.0 / n if inverse else 0.5
    re, im = _planes((2, n), seed=n + 2 * inverse)
    got = _c(*ck.fft_twofactor(*_t(re, im), inverse, scale,
                               swapped=order == "swapped"))
    rr, ri = pallas_engine.core_fft_planar_v2(
        jnp.asarray(re), jnp.asarray(im), n, inverse, order=order,
        scale=scale)
    assert _rel(got, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    if order == "swapped" and inverse:
        x = x.reshape(2, n2, n1).transpose(0, 2, 1).reshape(2, n)
    want = _dft(x, inverse, scale)
    if order == "swapped" and not inverse:
        want = want.reshape(2, n1, n2).transpose(0, 2, 1).reshape(2, n)
    assert _rel(got, want) <= NUMPY_TOL


def test_fft_kernel_lengths_run_on_fft_twofactor():
    """``pallas_engine.py:152 _fft_kernel`` (the v1 four-step, n1 <= n2 <=
    128) goes into `fft_twofactor`: every length of its
    ``split_two_factors`` has a `twofactor_split`, and the JAX dispatch
    (``core_fft_planar``) reaches it for no n in 5..16384, each such n
    being a v3 or a v2 length first."""
    for n in range(2, 16385):
        if pallas_engine.split_two_factors(n) is not None:
            assert ck.twofactor_supports(n), n
    for n in range(5, 16385):
        if not (pallas_engine._use_v3(n) or pallas_engine._use_v2(n)):
            assert pallas_engine.split_two_factors(n) is None, n


@pytest.mark.parametrize("n", [1000, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_twofactor_plain_matches_fft_kernel(interpret, n, inverse):
    """`fft_twofactor`'s plain version against `_fft_kernel` itself
    (``_build_fft_call``, natural order, scale outside it)."""
    run = pallas_engine._build_fft_call(n, inverse, 2, True)
    re, im = _planes((2, n), seed=n + inverse)
    rr, ri = run(jnp.asarray(re), jnp.asarray(im))
    got = _c(*ck.fft_twofactor(*_t(re, im), inverse))
    assert _rel(got, _c(rr, ri)) <= REF_TOL
    assert _rel(got, _dft(_c(re, im), inverse)) <= NUMPY_TOL


def test_fft_conv_inv_plain_matches_conv_inv_kernel(interpret):
    """The two-kernel convolution of the JAX package (v2 forward in swapped
    order, then `_conv_inv_kernel`) at Rader's p-1 = 166 (p = 167)."""
    p, n = 167, 166
    re, im = _planes((3, n), seed=p)
    fr, fi = ck.fft_twofactor(*_t(re, im), swapped=True)
    got = _c(*ck.fft_conv_inv(fr, fi, ck.rader_spectrum(p, 1.0, CPU,
                                                        "swapped")))
    table = jluts.rader_tables(p)[2] / n
    ref = pallas_engine.conv_fused_planar(_jp(re, im), n, table,
                                          normalize=False)
    assert _rel(got, _c(ref.re, ref.im)) <= REF_TOL
    want = np.fft.ifft(np.fft.fft(_c(re, im)) * table) * n
    assert _rel(got, want) <= NUMPY_TOL
    dc = _t(*_planes((3,), seed=5))
    with_dc = _c(*ck.fft_conv_inv(fr, fi, ck.rader_spectrum(p, 1.0, CPU,
                                                            "swapped"), dc))
    assert _rel(with_dc, want + _c(*dc)[:, None]) <= NUMPY_TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_rader_dc_branch_matches_reference(interpret, inverse):
    """p = 167: p-1 = 2*83 is beyond `fft_conv` and the JAX package's v3,
    so both run the DC-fused two-factor branch."""
    p = 167
    assert not ck.kernel_supports(p - 1) and ck.twofactor_supports(p - 1)
    assert not pallas_engine._use_v3(p - 1) and pallas_engine._use_v2(p - 1)
    scale = 1.0 / p if inverse else 1.0
    re, im = _planes((3, p), seed=p + inverse)
    y = cuda_engine.fft_lines_p(vt.from_numpy_planar(re, im), plan_axis(p),
                                inverse, scale=scale)
    ref = pallas_engine.fft_lines_p(_jp(re, im), jplan_axis(p), inverse,
                                    scale=scale)
    got = _c(y.re, y.im)
    assert _rel(got, _c(ref.re, ref.im)) <= REF_TOL
    assert _rel(got, _dft(_c(re, im), inverse, scale)) <= NUMPY_TOL


def test_fft_conv_pair_plain_matches_bluestein_pair(interpret):
    n, B = 10007, 2
    m = plan_axis(n).decomp.bluestein_size
    assert m == 32768 and ck.conv_pair_plan(m) == (128, 256, 4)
    re, im = _planes((B, n), seed=n)
    got = _c(*ck.fft_conv_pair(*_t(re, im),
                               ck.bluestein_spectrum(n, m, False, 1.0, CPU,
                                                     "pair"),
                               ck.bluestein_chirp(n, m, False, CPU)))
    ref = pallas_engine._bluestein_pair_p(_jp(re, im), n, m, False)
    assert _rel(got, _c(ref.re, ref.im)) <= REF_TOL
    assert _rel(got, np.fft.fft(_c(re, im))) <= NUMPY_TOL


# ---------------------------------------------------------------------------
# The slice as a whole.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", LENGTHS)
def test_lengths_match_reference_and_numpy(n):
    re, im = _planes((2, n), seed=n)
    x = _c(re, im)
    want = np.fft.fft(x)
    ref = np.asarray(vk.fft(x.astype(np.complex64), engine="jnp"))
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=False),
                            engine="cuda")
    calls = torch_engine.calls
    y = app.forward(vt.from_numpy_planar(re, im))
    got = _c(y.re, y.im)
    assert _rel(got, ref) <= REF_TOL and _rel(got, want) <= NUMPY_TOL
    z = app.inverse(y)
    assert _rel(_c(z.re, z.im) / n, x) <= NUMPY_TOL
    f = vt.fft(x.astype(np.complex64), engine="cuda", device="cpu")
    assert isinstance(f, np.ndarray) and _rel(f, want) <= NUMPY_TOL
    back = vt.ifft(f, engine="cuda", device="cpu")
    assert _rel(back, x) <= NUMPY_TOL
    assert torch_engine.calls == calls


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


# (n, launches of a forward plus an inverse through FFTApplication)
ROUTES = [
    (10240, {"fft_twofactor": 2}),                    # DIRECT on two factors
    (7919, {"fft_twofactor": 2, "fft_conv_inv": 2}),  # Rader, DC-fused
    (10006, {"fft_conv": 2}),                         # SPLIT 5003 x 2
    (10007, {"fft_conv_pair": 2}),                    # Bluestein m = 32768
    (131, {"fft_conv": 2}),                           # Rader in one kernel
    (263, {"fft_conv": 2}),                           # Bluestein, m = 539
    (8133, {"fft_conv_pair": 2}),                     # m = 16464 = 84 * 196
    (5, {"fft_lines": 2}),                            # DIRECT on the stages
    (8215, {"fft_twofactor": 2}),                     # 5 * 31 * 53
    (4099, {"fft_conv_pair": 2}),                     # m = 8232 = 84 * 98
    (4213, {"fft_twofactor": 2, "fft_conv_inv": 2}),  # m = 8470, no plane
    (15838, {"fft_twofactor": 2, "fft_conv_inv": 2}),  # SPLIT 7919 x 2
]


@pytest.mark.parametrize("n,want", ROUTES)
def test_route_launches(monkeypatch, n, want):
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=False),
                            engine="cuda")
    x = vt.Planar(torch.empty(3, n, device="meta"),
                  torch.empty(3, n, device="meta"))
    with _stubbed_launches(monkeypatch) as launches:
        y = app.inverse(app.forward(x))
        assert y.shape == (3, n)
        assert launches == {k: want.get(k, 0) for k in ck.KERNEL_SOURCES}


@pytest.mark.parametrize("n", sorted({n for n, _ in ROUTES}
                                     | {6, 97, 641, 919, 1009, 8192, 12289,
                                        16382, 16384}))
def test_launches_follow_route(monkeypatch, n):
    """A forward and an inverse launch exactly the kernels `route` names for
    one direction, twice: the dispatch and the routing are one decision."""
    kernels = cuda_engine.route(plan_axis(n))
    want = collections.Counter(k for k, _, _ in kernels)
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=False),
                            engine="cuda")
    x = vt.Planar(torch.empty(2, n, device="meta"),
                  torch.empty(2, n, device="meta"))
    with _stubbed_launches(monkeypatch) as launches:
        app.inverse(app.forward(x))
        assert launches == {k: 2 * want[k] for k in ck.KERNEL_SOURCES}
    for kernel, plan, m in kernels:
        holds = {"fft_lines": ck.kernel_supports, "fft_conv": ck.kernel_supports,
                 "fft_twofactor": ck.twofactor_supports,
                 "fft_conv_inv": ck.twofactor_supports,
                 "fft_conv_pair": lambda m: ck.conv_pair_plan(m) is not None}
        assert holds[kernel](m), (kernel, plan.n, m)


@pytest.mark.parametrize("n,want", [(262, {"fft_conv": 2}),
                                    (15838, {"fft_twofactor": 2,
                                             "fft_conv_inv": 2}),
                                    (20014, {"fft_conv_pair": 2}),
                                    (1024, {"fft_r2c": 2})])
def test_real_route_launches(monkeypatch, n, want):
    x = torch.empty(3, n, device="meta")
    with _stubbed_launches(monkeypatch) as launches:
        z = vt.irfft(vt.rfft(x, engine="cuda"), n=n, engine="cuda")
        assert z.shape == (3, n)
        assert launches == {k: want.get(k, 0) for k in ck.KERNEL_SOURCES}


@pytest.mark.parametrize("n", [32771, 20480, 65537])
def test_long_tier_raises_naming_its_item(n):
    """DIRECT lengths above 16384 and Bluestein lengths padded beyond 2^16
    (32771 and 65537 are sample 14's), which waited for the long tier, run
    on it: `fft_lines_p` and `vt.fft` on CPU planes against the JAX
    package's jnp engine and numpy, with no call of the plain engine.
    8133 and the other lengths the JAX package sends there run on
    `fft_conv_pair` (`test_route_launches`)."""
    re, im = _planes((2, n), seed=3)
    x = _c(re, im)
    want = np.fft.fft(x)
    ref = np.asarray(vk.fft(x.astype(np.complex64), engine="jnp"))
    calls = torch_engine.calls
    y = cuda_engine.fft_lines_p(vt.from_numpy_planar(re, im), plan_axis(n))
    assert _rel(_c(y.re, y.im), ref) <= REF_TOL
    assert _rel(_c(y.re, y.im), want) <= NUMPY_TOL
    f = vt.fft(x.astype(np.complex64), engine="cuda", device="cpu")
    assert _rel(f, want) <= NUMPY_TOL
    assert torch_engine.calls == calls


def test_every_length_to_16384_has_a_route():
    """No 1-D plan of length 5..16384 raises on the CUDA engine, so none
    reaches the reference's TypeError (``pallas_engine.py:201``); the
    two-factor gate holds every length of the JAX package's v2."""
    for n in range(5, 16385):
        assert cuda_engine.supports(plan_axis(n)), n
        if pallas_engine._v2_supported(n):
            assert ck.twofactor_supports(n), n
    for n in (8215, 8246):
        assert pallas_engine.split_two_factors(n) is None
        assert ck.twofactor_split(n) is not None
    assert ck.twofactor_split(16384) == (128, 128)
    assert ck.twofactor_split(67) == (67, 1)
    assert ck.twofactor_split(16385) is None and ck.twofactor_split(134 * 131) \
        is None
    for m in (32768, 16464, 65536, 8232):
        nc, ns, c = ck.conv_pair_plan(m)
        assert nc * ns == m and nc <= ns and nc % c == 0 and ns % c == 0
        assert 16 * m // c <= ck.PAIR_MAX_BLOCK_BYTES
    assert ck.conv_pair_plan(66560) is None
    assert ck.conv_pair_plan(3 ** 10) is None     # fits no cluster


# ---------------------------------------------------------------------------
# Real transforms of every even n whose n/2 runs on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [262, 15838, 20014])
def test_real_half_length_route(n):
    """n/2 = 131 (Rader), 7919 (Rader on two factors), 10007 (Bluestein):
    `r2c_supports` fails, and the CUDA engine packs, runs the n/2-point
    C2C and untangles."""
    assert not ck.r2c_supports(n)
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    X = vt.rfft(torch.from_numpy(x), engine="cuda")
    want = np.fft.rfft(x.astype(np.float64))
    ref = np.asarray(vk.rfft(x, engine="jnp"))
    assert _rel(X.numpy(), want) <= NUMPY_TOL and _rel(X.numpy(), ref) <= REF_TOL
    z = vt.irfft(X, n=n, engine="cuda")
    assert _rel(z.numpy(), x) <= NUMPY_TOL
    # the jnp route folds Im(DC) in, so it gets a real signal's spectrum
    zr = np.asarray(vk.irfft(want.astype(np.complex64), n=n, engine="jnp"))
    zc = vt.irfft(torch.from_numpy(want.astype(np.complex64)), n=n,
                  engine="cuda")
    assert _rel(zc.numpy(), zr) <= REF_TOL
    # Im(DC) and Im(Nyquist) are ignored, as numpy ignores them
    bent = want.copy()
    bent[:, 0] += 3j
    bent[:, -1] -= 2j
    got = vt.irfft(torch.from_numpy(bent.astype(np.complex64)), n=n,
                   engine="cuda")
    assert _rel(got.numpy(), np.fft.irfft(bent, n=n)) <= NUMPY_TOL


@pytest.mark.parametrize("n", [6, 262, 1000])
@pytest.mark.parametrize("packed", [False, True])
def test_half_length_untangle_and_pack_match_numpy(n, packed):
    """The elementwise halves of the half-length route, around numpy's own
    n/2-point FFT, against numpy's rfft/irfft: no engine runs here."""
    x = np.random.default_rng(n).standard_normal((3, n))
    Z = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2])
    X = r2c_untangle(vt.from_numpy_planar(Z.real, Z.imag), n, packed)
    want = np.fft.rfft(x)
    if packed:
        want = np.concatenate([want[:, :n // 2].real
                               + 1j * np.concatenate(
                                   [want[:, n // 2:].real,
                                    want[:, 1:n // 2].imag], 1)], 1)
    assert _rel(_c(X.re, X.im), want) <= 1e-12
    F = c2r_pack(X, n, packed)
    z = np.fft.ifft(_c(F.re, F.im))
    got = np.stack([z.real, z.imag], -1).reshape(3, n)
    assert _rel(got, x) <= 1e-12


# ---------------------------------------------------------------------------
# Non-minor axes.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 131), (131, 8, 4)])
def test_non_minor_rader_axes(shape):
    re, im = _planes(shape, seed=sum(shape))
    x = vt.from_numpy_planar(re.copy(), im.copy())
    y = vt.fftn(x, engine="cuda")
    assert _rel(_c(y.re, y.im), np.fft.fftn(_c(re, im))) <= NUMPY_TOL
    z = vt.ifftn(y, engine="cuda")
    assert _rel(_c(z.re, z.im), _c(re, im)) <= NUMPY_TOL
    np.testing.assert_array_equal(x.re.numpy(), re)
    np.testing.assert_array_equal(x.im.numpy(), im)


def test_nd_application_with_a_bluestein_axis():
    shape = (2, 263, 12)          # axis 1 Bluestein (m = 539), not minor
    re, im = _planes(shape, seed=263)
    x = vt.from_numpy_planar(re.copy(), im.copy())
    app = vt.FFTApplication(vt.FFTConfig(shape=(263, 12), normalize=True),
                            engine="cuda")
    y = app.forward(x)
    assert _rel(_c(y.re, y.im), np.fft.fftn(_c(re, im), axes=(1, 2))) \
        <= NUMPY_TOL
    z = app.inverse(y)
    assert _rel(_c(z.re, z.im), _c(re, im)) <= NUMPY_TOL
    np.testing.assert_array_equal(x.re.numpy(), re)
    np.testing.assert_array_equal(x.im.numpy(), im)


def test_new_wrapper_checks():
    re, im = _t(*_planes((2, 130), seed=1))
    spec = ck.rader_spectrum(131, 1.0, CPU)
    with pytest.raises(ValueError):
        ck.fft_conv(re, im, spec[:64].contiguous())         # wrong length
    with pytest.raises(ValueError):
        ck.fft_conv(re, im, spec.double())
    with pytest.raises(ValueError):
        ck.fft_conv(re[:, :100].contiguous(), im[:, :100].contiguous(), spec)
    with pytest.raises(NotImplementedError, match="long tier"):
        ck.fft_twofactor(torch.zeros(1, 16400), torch.zeros(1, 16400))
    with pytest.raises(ValueError):
        ck.fft_conv_inv(re, im, spec, dc=(torch.zeros(3), torch.zeros(3)))
    with pytest.raises(NotImplementedError, match="long tier"):
        ck.fft_conv_pair(re, im, torch.zeros(66560, 2), torch.zeros(130, 2))
    with pytest.raises(TypeError):
        ck.fft_conv(re, im, spec.numpy())
    before = dict(ck.launches)
    ck.fft_conv(re, im, spec)
    ck.fft_twofactor(re, im, swapped=True)
    assert ck.launches == before
