"""The torch port's real transforms against the JAX package's (jnp engine,
and the Pallas R2C kernels in interpret mode, as tests/test_pallas.py and
tests/test_r2c.py run them) and numpy fp64: rfft/irfft, rfftn/irfftn,
rfft2/irfft2, FFTApplication(kind=R2C), the plain versions of the real
kernels, the numpy rule for Im(DC/Nyquist), the CUDA engine's routing onto
the real kernels (their plain versions on CPU planes), and refusals.  The
CUDA kernels themselves run only on the card (chip_smoke.py)."""
import contextlib
import ctypes
import dataclasses
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine

NUMPY_TOL = 5e-6
REF_TOL = 1e-5

# even, odd, prime and Bluestein-sized lengths of tests/test_r2c.py
SIZES = [2, 4, 8, 16, 64, 256, 1024, 6, 12, 60, 360, 1000,
         3, 5, 9, 15, 17, 97, 101, 254]


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    yield
    pallas_engine.set_interpret(False)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(p):
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


@pytest.mark.parametrize("n", SIZES)
def test_rfft_irfft_match_reference_jnp(n):
    x = _real((3, n), seed=n)
    X = vt.rfft(torch.from_numpy(x))
    assert X.is_complex() and X.shape == (3, n // 2 + 1)
    ref = np.asarray(vk.rfft(x, engine="jnp"))
    assert _rel(X.numpy(), ref) <= REF_TOL
    assert _rel(X.numpy(), np.fft.rfft(x.astype(np.float64))) <= NUMPY_TOL
    z = vt.irfft(X, n=n)
    assert z.dtype == torch.float32 and z.shape == (3, n)
    zr = np.asarray(vk.irfft(ref.astype(np.complex64), n=n, engine="jnp"))
    assert _rel(z.numpy(), zr) <= REF_TOL
    assert _rel(z.numpy(), x) <= NUMPY_TOL


@pytest.mark.parametrize("n", [3, 5, 101, 347, 1009])
@pytest.mark.parametrize("batch", [1, 2, 5])
def test_merged_sequences_match_reference(n, batch):
    """Odd n with two or more lines rides the merged-sequences route (one
    line with the complex route); both match the JAX package and numpy."""
    x = _real((batch, n), seed=n * 31 + batch)
    X = vt.rfft(x, device="cpu")
    assert isinstance(X, np.ndarray) and X.dtype == np.complex64
    assert _rel(X, np.asarray(vk.rfft(x, engine="jnp"))) <= REF_TOL
    assert _rel(X, np.fft.rfft(x.astype(np.float64))) <= NUMPY_TOL
    z = vt.irfft(X, n=n, device="cpu")
    assert _rel(z, np.asarray(vk.irfft(X, n=n, engine="jnp"))) <= REF_TOL
    assert _rel(z, x) <= NUMPY_TOL


@pytest.mark.parametrize("shape,axis", [((16, 5), 0), ((3, 7, 256), 1),
                                        ((6, 9, 4), 1), ((2, 3, 101), -1)])
def test_rfft_non_minor_axis(shape, axis):
    x = _real(shape, seed=sum(shape))
    X = vt.rfft(torch.from_numpy(x), axis=axis)
    assert _rel(X.numpy(), np.asarray(vk.rfft(x, axis=axis, engine="jnp"))) \
        <= REF_TOL
    assert _rel(X.numpy(), np.fft.rfft(x.astype(np.float64), axis=axis)) \
        <= NUMPY_TOL
    z = vt.irfft(X, n=shape[axis], axis=axis)
    assert _rel(z.numpy(), x) <= NUMPY_TOL


@pytest.mark.parametrize("n", [64, 60, 70, 63])
def test_irfft_explicit_n_crops_and_pads(n):
    X = np.fft.rfft(_real((4, 64), seed=3).astype(np.float64))
    got = vt.irfft(X.astype(np.complex64), n=n, device="cpu")
    assert got.shape == (4, n)
    assert _rel(got, np.fft.irfft(X, n=n)) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(8, 16), (4, 6, 8), (16, 17), (3, 128, 128)])
@pytest.mark.parametrize("fn", ["rfftn", "rfft2"])
def test_rfftn_irfftn_match_reference_jnp(shape, fn):
    x = _real(shape, seed=int(np.prod(shape)))
    inv = "i" + fn
    axes = None if fn == "rfftn" else (-2, -1)
    ax = tuple(range(len(shape))) if axes is None else (len(shape) - 2,
                                                         len(shape) - 1)
    X = getattr(vt, fn)(x, device="cpu")
    ref = np.asarray(getattr(vk, fn)(x, engine="jnp"))
    assert _rel(X, ref) <= REF_TOL
    assert _rel(X, np.fft.rfftn(x.astype(np.float64), axes=ax)) <= NUMPY_TOL
    s = tuple(shape[a] for a in ax)
    z = getattr(vt, inv)(X, s=s, device="cpu")
    zr = np.asarray(getattr(vk, inv)(ref.astype(np.complex64), s=s,
                                     engine="jnp"))
    assert _rel(z, zr) <= REF_TOL
    assert _rel(z, x) <= NUMPY_TOL


@pytest.mark.parametrize("shape,axes", [((4, 6, 8), (0, 2)),
                                        ((2, 3, 8, 12), (1, 3)),
                                        ((3, 8, 12), (0, 1))])
def test_rfftn_axis_subsets(shape, axes):
    x = _real(shape, seed=len(shape) + sum(axes))
    for engine in ("torch", "cuda"):
        X = vt.rfftn(torch.from_numpy(x), axes=axes, engine=engine)
        assert _rel(X.numpy(), np.fft.rfftn(x.astype(np.float64), axes=axes)) \
            <= NUMPY_TOL
        z = vt.irfftn(X, s=tuple(shape[a] for a in axes), axes=axes,
                      engine=engine)
        assert _rel(z.numpy(), x) <= NUMPY_TOL


def _ref_app(shape, axes, batch):
    return vk.FFTConfig(shape=shape, fft_axes=axes, kind=vk.TransformKind.R2C,
                        batch=batch)


@pytest.mark.parametrize("shape,axes,lead", [
    ((64,), None, (4,)), ((1000,), None, (3,)), ((47,), None, (2,)),
    ((16, 12), None, (2,)), ((8, 8, 6), None, (2,)), ((8, 10, 12), (0, 2), ()),
])
@pytest.mark.parametrize("engine", [None, "cuda"])
def test_application_r2c_matches_reference_jnp(shape, axes, lead, engine):
    ref_cfg = _ref_app(shape, axes, math.prod(lead))
    cfg = vt.config_from_reference(dataclasses.asdict(ref_cfg))
    ref_app = vk.FFTApplication(ref_cfg, engine="jnp")
    app = vt.FFTApplication(cfg, engine=engine, device="cpu")
    x = _real(lead + shape, seed=sum(shape))
    calls, launches = torch_engine.calls, dict(ck.launches)
    Y = app.forward(vt.from_numpy_planar(x, np.zeros_like(x)))
    Yr = np.asarray(ref_app.forward(x))
    assert isinstance(Y, vt.Planar) and Y.shape == Yr.shape
    assert _rel(_c(Y), Yr) <= REF_TOL
    ax = tuple(len(lead) + a for a in ref_cfg.axes)
    assert _rel(_c(Y), np.fft.rfftn(x.astype(np.float64), axes=ax)) <= NUMPY_TOL
    z = app.inverse(Y)
    assert isinstance(z, torch.Tensor) and z.shape == x.shape
    zr = np.asarray(ref_app.inverse(Yr.astype(np.complex64)))
    assert _rel(z.numpy(), zr) <= REF_TOL
    assert _rel(z.numpy(), x) <= NUMPY_TOL
    # host input in, host output out
    Yh = app.forward(x)
    assert isinstance(Yh, np.ndarray) and Yh.dtype == np.complex64
    zh = app.inverse(Yh)
    assert isinstance(zh, np.ndarray) and zh.dtype == np.float32
    assert _rel(zh, x) <= NUMPY_TOL
    assert ck.launches == launches
    assert (torch_engine.calls == calls) == (engine == "cuda")


def test_application_r2c_checks_shapes():
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,), kind=vt.TransformKind.R2C,
                                         batch=3), device="cpu")
    with pytest.raises(vt.errors.InvalidConfigError):
        app.forward(np.zeros((3, 8), np.float32))
    with pytest.raises(vt.errors.InvalidConfigError):
        app.forward(np.zeros((2, 16), np.float32))
    with pytest.raises(vt.errors.InvalidConfigError):
        app.inverse(np.zeros((3, 16), np.complex64))
    assert app.inverse(np.zeros((3, 9), np.complex64)).shape == (3, 16)


@pytest.mark.parametrize("n", [8, 64, 1000, 1024])
def test_fft_r2c_plain_matches_r2c_kernel(interpret, n):
    x = _real((5, n), seed=n)
    m = n // 2
    xt = torch.from_numpy(x)
    want = np.fft.rfft(x.astype(np.float64))
    for packed, fwd, inv in (
            (False, pallas_engine.rfft_lines_planar,
             pallas_engine.irfft_lines_planar),
            (True, pallas_engine.rfft_lines_packed,
             pallas_engine.irfft_lines_packed)):
        yr, yi = ck.fft_r2c(xt, packed)
        rr, ri = fwd(jnp.asarray(x))
        got = _c(vt.Planar(yr, yi))
        assert got.shape == (5, m if packed else m + 1)
        assert _rel(got, _c(vt.Planar(rr, ri))) <= REF_TOL
        nr, ni = ck.packed_to_numpy_layout(yr, yi) if packed else (yr, yi)
        assert _rel(_c(vt.Planar(nr, ni)), want) <= NUMPY_TOL
        if not packed:
            assert not yi[:, [0, m]].any()
        z = ck.fft_c2r(yr, yi, n, 2.0 / n, packed)
        zr = inv(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()), n,
                 scale=2.0 / n)
        assert _rel(z.numpy(), np.asarray(zr)) <= REF_TOL
        assert _rel(z.numpy(), x) <= NUMPY_TOL
        # the scale contract: output times (n/2)*scale
        z1 = ck.fft_c2r(yr, yi, n, 1.0, packed)
        assert _rel(z1.numpy(), x * m) <= NUMPY_TOL


def test_fft_r2c_pair_plain_matches_r2c_pair_kernel(interpret):
    x = _real((2, 128, 128), seed=128)
    yr, yi = ck.fft_r2c_pair(torch.from_numpy(x))
    ref = pallas_engine.rfft2_pair_planar(jnp.asarray(x))
    got = _c(vt.Planar(yr, yi))
    assert got.shape == (2, 128, 65)
    assert _rel(got, _c(ref)) <= REF_TOL
    assert _rel(got, np.fft.rfft2(x.astype(np.float64))) <= NUMPY_TOL
    z = ck.fft_c2r_pair(yr, yi, 128, 1.0 / 128, 2.0 / 128)
    zr = pallas_engine.irfft2_pair_planar(jnp.asarray(yr.numpy()),
                                          jnp.asarray(yi.numpy()), 128, 128)
    assert _rel(z.numpy(), np.asarray(zr)) <= REF_TOL
    assert _rel(z.numpy(), x) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(3, 2, 8), (2, 47, 60), (1, 8, 16384),
                                   (2, 9, 6)])
def test_fft_r2c_pair_plain_odd_shapes(shape):
    x = _real(shape, seed=sum(shape))
    ny, nz = shape[1:]
    yr, yi = ck.fft_r2c_pair(torch.from_numpy(x))
    assert _rel(_c(vt.Planar(yr, yi)), np.fft.rfft2(x.astype(np.float64))) \
        <= NUMPY_TOL
    z = ck.fft_c2r_pair(yr, yi, nz, 0.5 / ny, 1.0 / nz)
    assert _rel(z.numpy(), 0.25 * x) <= NUMPY_TOL


def _spectrum_with_imag_dc_nyquist(shape, seed):
    X = np.fft.rfft(np.random.default_rng(seed).standard_normal(shape))
    X[..., 0] += 3j
    X[..., -1] -= 2j
    return X


def test_c2r_ignores_imag_dc_and_nyquist_like_numpy(interpret):
    """The port's inverse drops Im(DC) and Im(Nyquist) at any batch, as
    numpy does and as the Pallas kernel does while its merged partner line
    is padding (5 lines); the jnp route of the JAX package folds them in."""
    n = 64
    X = _spectrum_with_imag_dc_nyquist((5, n), seed=1)
    want = np.fft.irfft(X, n=n)
    Xr, Xi = X.real.astype(np.float32), X.imag.astype(np.float32)
    pallas = np.asarray(pallas_engine.irfft_lines_planar(
        jnp.asarray(Xr), jnp.asarray(Xi), n, scale=2.0 / n))
    assert _rel(pallas, want) <= NUMPY_TOL
    z = ck.fft_c2r(torch.from_numpy(Xr), torch.from_numpy(Xi), n, 2.0 / n)
    assert _rel(z.numpy(), pallas) <= REF_TOL
    for engine in ("torch", "cuda"):
        for b in (5, 300):
            Xb = _spectrum_with_imag_dc_nyquist((b, n), seed=b)
            got = vt.irfft(Xb.astype(np.complex64), engine=engine, device="cpu")
            assert _rel(got, np.fft.irfft(Xb, n=n)) <= NUMPY_TOL
    jnp_route = np.asarray(vk.irfft(X.astype(np.complex64), n=n, engine="jnp"))
    assert _rel(jnp_route, want) > 1e-4
    # the Pallas pair merges two planes: the first plane's Im(DC/Nyquist)
    # columns leak into the second, where the port follows numpy
    P = np.fft.rfft2(np.random.default_rng(2).standard_normal((2, 128, 128)))
    P[:, :, 0] += 1j
    P[:, :, -1] -= 0.5j
    want2 = np.fft.irfft2(P)
    Pr, Pi = P.real.astype(np.float32), P.imag.astype(np.float32)
    pallas2 = np.asarray(pallas_engine.irfft2_pair_planar(
        jnp.asarray(Pr), jnp.asarray(Pi), 128, 128))
    assert _rel(pallas2, want2) > 1e-4
    z2 = ck.fft_c2r_pair(torch.from_numpy(Pr), torch.from_numpy(Pi), 128,
                         1.0 / 128, 2.0 / 128)
    assert _rel(z2.numpy(), want2) <= NUMPY_TOL


@pytest.mark.parametrize("shape,engine", [((6, 63), "torch"), ((6, 63), "cuda"),
                                          ((1, 63), "cuda"), ((3, 2), "cuda"),
                                          ((4, 16, 12), "cuda"),
                                          ((4, 16, 12), "torch")])
def test_inverse_numpy_rule_on_every_route(shape, engine):
    """Merged sequences, the complex route and the real pair also drop what
    numpy drops (the merged route would leak Im(DC) into its partner)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape)
    axes = (-2, -1) if len(shape) == 3 else (-1,)
    X = np.fft.rfftn(x, axes=axes)
    X[..., 0] += 1j
    X[..., -1] -= 0.5j
    got = vt.irfftn(X.astype(np.complex64), s=tuple(shape[a] for a in axes),
                    axes=axes, engine=engine, device="cpu")
    assert _rel(got, np.fft.irfftn(X, s=tuple(shape[a] for a in axes),
                                   axes=axes)) <= NUMPY_TOL


def _spies(monkeypatch, names):
    seen = {name: [] for name in names}
    for name in names:
        real = getattr(ck, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen[_name].append((tuple(args[0].shape),) + tuple(args[1:]))
            return _real(*args, **kw)

        monkeypatch.setattr(ck, name, spy)
    return seen


@pytest.mark.parametrize("shape,axes,pair", [
    ((4, 1024), (-1,), False), ((2, 16, 16), None, True),
    ((3, 16, 12), (1, 2), True), ((2, 47, 360), (1, 2), False),
    ((2, 8, 12), (0, 2), False),
])
def test_cuda_route_reaches_real_kernels(monkeypatch, shape, axes, pair):
    """engine='cuda' on CPU planes runs the real kernels' wrappers (their
    plain versions), the pair when both minor axes are transformed and the
    plane fits a cluster, and carries the whole 1/N in the last pass."""
    seen = _spies(monkeypatch, ["fft_r2c", "fft_c2r", "fft_r2c_pair",
                                "fft_c2r_pair", "fft_strided"])
    x = _real(shape, seed=sum(shape))
    calls = torch_engine.calls
    X = vt.rfftn(torch.from_numpy(x), axes=axes, engine="cuda")
    ax = tuple(range(len(shape))) if axes is None else tuple(
        a % len(shape) for a in axes)
    assert _rel(X.numpy(), np.fft.rfftn(x.astype(np.float64), axes=ax)) \
        <= NUMPY_TOL
    z = vt.irfftn(X, s=tuple(shape[a] for a in ax), axes=axes, engine="cuda")
    assert _rel(z.numpy(), x) <= NUMPY_TOL
    assert torch_engine.calls == calls
    if pair:
        assert len(seen["fft_r2c_pair"]) == 1 and len(seen["fft_c2r_pair"]) == 1
        assert not seen["fft_r2c"] and not seen["fft_c2r"]
        _, _, nz, sy, sz = seen["fft_c2r_pair"][0][:5]
        assert nz == shape[-1] and sz == pytest.approx(2.0 / nz)
        assert sy == pytest.approx(1.0 / math.prod(shape[a] for a in ax[:-1]))
    else:
        assert not seen["fft_r2c_pair"] and not seen["fft_c2r_pair"]
        assert len(seen["fft_r2c"]) == 1 and len(seen["fft_c2r"]) == 1
    if len(ax) > 1 and not (pair and len(ax) == 2):
        assert seen["fft_strided"]


def test_cuda_route_leaves_inputs_unchanged():
    # a length-1 axis hands its planes back untouched, so the passes after
    # it must not write over them: (8, 1) and (2, 3, 1) in the forward,
    # (1, 3, 4, 8) in the inverse's complex axes
    for shape in ((2, 8, 12), (8, 1), (2, 3, 1), (1, 3, 4, 8)):
        x = _real(shape, seed=5)
        xt = torch.from_numpy(x.copy())
        X = vt.rfftn(xt, engine="cuda")
        np.testing.assert_array_equal(xt.numpy(), x)
        assert _rel(X.numpy(), np.fft.rfftn(x.astype(np.float64))) <= NUMPY_TOL
        keep = X.clone()
        vt.irfftn(X, s=shape, engine="cuda")
        assert torch.equal(X, keep)
        p = vt.rfftn(vt.Planar(xt, xt), axes=tuple(range(len(shape))),
                     engine="cuda")
        np.testing.assert_array_equal(xt.numpy(), x)
        keep = vt.Planar(p.re.clone(), p.im.clone())
        z = vt.irfftn(p, s=shape, engine="cuda")
        assert torch.equal(p.re, keep.re) and torch.equal(p.im, keep.im)
        assert _rel(z.numpy(), x) <= NUMPY_TOL
        app = vt.FFTApplication(vt.FFTConfig(shape=shape,
                                             kind=vt.TransformKind.R2C),
                                engine="cuda")
        app.forward(vt.Planar(xt, torch.zeros_like(xt)))
        np.testing.assert_array_equal(xt.numpy(), x)
        app.inverse(p)
        assert torch.equal(p.re, keep.re) and torch.equal(p.im, keep.im)


# even n whose n/2 is a long-tier length (DIRECT above 16384, Bluestein
# padded beyond 2^16): the half-length route on the long tier, which the
# CUDA engine once refused and now runs
@pytest.mark.parametrize("n", [32800, 40960, 65542, 33000])
def test_cuda_route_refuses_real_lengths_outside_the_slice(n):
    """rfft/irfft of such n through the CUDA engine on CPU tensors (the
    wrappers' plain versions): within 1e-5 of the JAX package's jnp engine
    and 5e-6 of numpy, with no call of the plain engine."""
    x = torch.from_numpy(_real((2, n), seed=n))
    assert not cuda_engine.r2c_supports(n)
    calls = torch_engine.calls
    X = vt.rfft(x, engine="cuda")
    want = np.fft.rfft(x.numpy().astype(np.float64))
    ref = np.asarray(vk.rfft(x.numpy(), engine="jnp"))
    assert _rel(X.numpy(), want) <= NUMPY_TOL and _rel(X.numpy(), ref) <= REF_TOL
    z = vt.irfft(X, n=n, engine="cuda")
    assert _rel(z.numpy(), x.numpy()) <= NUMPY_TOL
    spec = want.astype(np.complex64)
    zr = np.asarray(vk.irfft(spec, n=n, engine="jnp"))
    zc = vt.irfft(torch.from_numpy(spec), n=n, engine="cuda")
    assert _rel(zc.numpy(), zr) <= REF_TOL
    assert torch_engine.calls == calls


@pytest.mark.parametrize("shape", [(3, 1), (1,)])
def test_irfftn_of_a_length_one_real_axis_raises_like_irfft(shape):
    """A spectrum whose real axis has one bin has the output length 0:
    irfftn raises the ValueError irfft raises (and numpy raises), before
    any scale is formed."""
    X = np.ones(shape, np.complex64)
    with pytest.raises(ValueError, match="invalid output length 0"):
        vt.irfft(X, device="cpu")
    with pytest.raises(ValueError, match="invalid output length 0"):
        vt.irfftn(X, device="cpu")
    with pytest.raises(ValueError):
        np.fft.irfftn(X)


def test_real_refusals_and_checks():
    x = torch.from_numpy(_real((2, 16), seed=2))
    with pytest.raises(NotImplementedError, match="item 10"):
        vt.rfft(x.double(), engine="cuda")
    with pytest.raises(TypeError):
        vt.rfft(torch.complex(x, x))
    with pytest.raises(TypeError):
        vt.rfft(np.ones((2, 8), np.complex64), device="cpu")
    # zero-pad windows run since queue 1 item 8.1: the real kinds mask the
    # forward's input, as the JAX package's do
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,), kind=vt.TransformKind.R2C,
                                         zeropad_input=((0, 8),)),
                            device="cpu")
    masked = x.numpy().copy()
    masked[:, :8] = 0
    assert _rel(app.forward(x).numpy(), np.fft.rfft(masked)) <= NUMPY_TOL
    # R2R kinds run since DCT/DST were ported (queue 1 item 9), and their
    # zero-pad windows since item 8.1
    vt.FFTApplication(vt.FFTConfig(shape=(16,), kind=vt.TransformKind.DST))
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,), kind=vt.TransformKind.DST,
                                         zeropad_input=((0, 8),)),
                            device="cpu")
    assert _rel(np.asarray(app.forward(x)),
                np.asarray(vt.dst(torch.from_numpy(masked)))) <= NUMPY_TOL
    # an s that crops a complex axis: numpy's answer, not a refusal
    X = np.fft.rfftn(_real((4, 16), seed=3)).astype(np.complex64)
    assert _rel(vt.irfftn(X, s=(3, 16), device="cpu"),
                np.fft.irfftn(X.astype(np.complex128), s=(3, 16),
                              axes=(0, 1))) <= NUMPY_TOL
    with pytest.raises(ValueError):
        ck.fft_c2r(x, x, 16)                   # 16 bins, not 9
    with pytest.raises(ValueError):
        ck.fft_r2c(x.t())                      # not contiguous
    with pytest.raises(TypeError):
        ck.fft_r2c(x.double())
    with pytest.raises(NotImplementedError, match="cuda_engine.route"):
        ck.fft_r2c_pair(torch.zeros(1, 67, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.fft_r2c_pair(torch.zeros(1, 1024, 1024))
    with pytest.raises(NotImplementedError, match="half-length route"):
        ck.fft_r2c(torch.zeros(2, 7))
    before = dict(ck.launches)
    ck.fft_r2c(x)
    ck.fft_r2c_pair(x.reshape(1, 2, 16))
    assert ck.launches == before


@pytest.mark.parametrize("shape,s,axes", [
    ((6, 9), (4, 16), None),                 # crop the complex axis
    ((6, 9), (9, 14), None),                 # pad it; crop the real bins
    ((5, 7, 9), (3, 10, 16), None),          # crop one, pad another
    ((5, 7, 9), (8, 4, 17), None),           # pad, crop, pad (odd n)
    ((7, 4, 6), (4, 9, 10), (1, 0, 2)),      # axes not in order
    ((6, 5, 3), (9, 4), (0, 1)),             # axes not the last ones
    ((2, 6, 8, 5), (3, 12), (1, 2)),         # a batch axis before
    ((4, 16, 9), (16, 16), (1, 2)),          # the pair route, unchanged
    ((4, 20, 9), (16, 16), (1, 2)),          # the pair route after a crop
    ((4, 12, 9), (16, 16), (1, 2)),          # ... after a pad
])
@pytest.mark.parametrize("engine", [None, "cuda"])
def test_irfftn_crops_and_pads_every_axis_like_numpy(shape, s, axes, engine):
    """irfftn/irfft2 crop or zero-pad each complex axis at its end to its
    entry of ``s`` before its inverse, as numpy does, with numpy's 1/N of
    the output shape, and leave the input unchanged."""
    rng = np.random.default_rng(sum(shape) + sum(s))
    X = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = np.fft.irfftn(X.astype(np.complex128), s=s,
                         axes=range(len(shape)) if axes is None else axes)
    Xt = torch.from_numpy(X)
    keep = Xt.clone()
    got = vt.irfftn(Xt, s=s, axes=axes, engine=engine)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= NUMPY_TOL
    assert torch.equal(Xt, keep)
    if axes is None and len(s) == 2:
        got2 = vt.irfft2(X, s=s, engine=engine, device="cpu")
        assert _rel(got2, want) <= NUMPY_TOL


def test_irfftn_refuses_an_empty_complex_axis():
    with pytest.raises(ValueError, match="invalid output lengths"):
        vt.irfftn(np.ones((4, 9), np.complex64), s=(0, 16), device="cpu")


def test_r2c_gates():
    for n in range(1, 16385 * 2):
        if n % 2 == 0 and ck.kernel_supports(n // 2):
            assert ck.r2c_supports(n), n
        else:
            assert not ck.r2c_supports(n), n
    assert ck.r2c_supports(16384) and ck.r2c_supports(4)
    assert not ck.r2c_supports(2) and not ck.r2c_supports(262)
    # a superset of the TPU kernel's gate
    for n in range(2, 8193):
        if pallas_engine.use_r2c_kernel(n):
            assert ck.r2c_supports(n), n
    for ny in (2, 8, 47, 64, 128, 256, 512, 1024):
        for nz in (4, 8, 12, 60, 128, 256, 360, 512, 1024, 16384):
            c = ck.r2c_pair_cluster(ny, nz)
            if c is None:
                continue
            m = nz // 2
            assert ny % c == 0 and m % c == 0
            assert 16 * ny * m // c <= ck.PAIR_MAX_BLOCK_BYTES
    assert ck.r2c_pair_cluster(256, 256) == 16
    assert ck.r2c_pair_cluster(8, 8) == 1
    for ny, nz in ((1024, 1024), (47, 360), (67, 64), (64, 67), (8, 2)):
        assert ck.r2c_pair_cluster(ny, nz) is None, (ny, nz)
        assert not cuda_engine.r2c_pair_supports(ny, nz)


def test_packed_layout_helpers_round_trip():
    x = torch.from_numpy(_real((3, 32), seed=9))
    nr, ni = ck.fft_r2c(x)
    pr, pi = ck.fft_r2c(x, packed=True)
    qr, qi = ck.numpy_to_packed_layout(nr, ni)
    assert torch.equal(qr, pr) and torch.equal(qi, pi)
    br, bi = ck.packed_to_numpy_layout(pr, pi)
    assert torch.equal(br, nr) and torch.equal(bi, ni)


def test_planar_numpy_style_indexing():
    t = torch.arange(24.0).reshape(2, 3, 4)
    p = vt.Planar(t, -t)
    a = t.numpy()
    np.testing.assert_array_equal(p[..., ::-1].re.numpy(), a[..., ::-1])
    np.testing.assert_array_equal(p[:, ::-2, 1].im.numpy(), -a[:, ::-2, 1])
    idx = np.array([3, 0, 0, 2])
    np.testing.assert_array_equal(p[..., idx].re.numpy(), a[..., idx])
    np.testing.assert_array_equal(p[1, [2, 0]].re.numpy(), a[1, [2, 0]])
    np.testing.assert_array_equal(p[:, None, 1:].re.numpy(), a[:, None, 1:])


def test_host_float64_narrows_under_single():
    """Host float64 and complex128 input becomes float32 planes under the
    SINGLE precision of every configuration (the JAX package narrows it at
    its boundary): complex64 out on the CPU route and on the cuda engine's
    route, which used to refuse float64 planes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64))
    xc = x + 1j * rng.standard_normal((4, 64))
    for engine in (None, "cuda"):
        for a in (x, xc):
            got = vt.fft(a, engine=engine, device="cpu")
            assert isinstance(got, np.ndarray) and got.dtype == np.complex64
            assert _rel(got, np.asarray(vk.fft(a))) <= REF_TOL
        got = vt.rfft(x, engine=engine, device="cpu")
        assert got.dtype == np.complex64
        assert _rel(got, np.asarray(vk.rfft(x))) <= REF_TOL
        back = vt.irfft(got.astype(np.complex128), n=64, engine=engine,
                        device="cpu")
        assert back.dtype == np.float32 and _rel(back, x) <= NUMPY_TOL
        app = vt.FFTApplication(vt.FFTConfig(shape=(64,)), engine=engine,
                                device="cpu")
        got = app.forward(xc)
        assert got.dtype == np.complex64
        assert _rel(got, np.asarray(vk.fft(xc))) <= REF_TOL
    # Planar and tensor input keep their dtype: on the cuda engine fp64
    # planes run the fp64 kernels where they take the length (here their
    # plain versions), and stay refused elsewhere (ROADMAP queue 1 item 10)
    t = torch.from_numpy(xc)
    assert vt.fft(t).dtype == torch.complex128
    got = vt.fft(t, engine="cuda")
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), np.fft.fft(xc)) <= 5e-14
    with pytest.raises(NotImplementedError, match="item 10"):
        vt.fft(torch.ones(2, 67, dtype=torch.complex128), engine="cuda")


# `fft_r2c` / `fft_c2r` on the in-place walk (csrc/fft_r2c.cu): the layout
# rule its C entry checks, the twiddles, and each launch's arguments.  The
# walk's constants: csrc/inplace.cuh's fixed radices, kPoints and
# kGenericPoints, csrc/stockham.cuh's kMaxStages
_FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
_MAX_STAGES = 16
R2C_LENGTHS = [n for n in range(2, 16385, 2) if ck.r2c_supports(n)]
R2C_ONE_PASS = 346   # lengths whose m-point DFT runs as one pass


def _walk_table_points(m):
    """What the C entry's table_len reads off a factor's plan ints."""
    if m == 1:
        return 0
    ints, _ = ck.stage_tables(m, False, 1.0, True)
    M, end = m, 0
    for s in range(ints[1]):
        r = ints[3 + s]
        tw_off = ints[3 + _MAX_STAGES + s]
        dft_off = ints[3 + 2 * _MAX_STAGES + s]
        M //= r
        end = max(end, dft_off + r if dft_off >= 0 else tw_off + r * M)
    return end


def _walk_rounds_fit(m, threads):
    if m == 1:
        return True
    return all((max(1, 12 // r) * threads >= m // r) if r in _FIXED_RADICES
               else 2 * threads >= m // r * -(-(r // 2 + 1) // 4)
               for r in ck.walk_radices(m))


def test_r2c_layout_rule_every_length():
    """Every even length the real kernels take gets a layout the C entry
    accepts: lines of m = n/2 points up to 2048 a block, a multiple of 32
    threads in 32..512 near one for 16 points, one pass where a block
    holds 4 lines or more and the stages fit, else `fft_lines`' two
    factors of m, every stage's sequence within a round, and exactly the
    shared bytes of the lines, the stage tables and the twiddles (64 +
    ceil(m/64) + 64 + m//128 + 1 points), at most 227 KB."""
    assert len(R2C_LENGTHS) == 2541
    one = 0
    for n in R2C_LENGTHS:
        m = n // 2
        n1, n2 = ck.r2c_split(n)
        threads, lines, smem = ck.r2c_layout(n)
        assert lines == max(1, 2048 // m) and n1 * n2 == m and n1 >= n2
        assert threads == min(512, max(32, -(-(-(-lines * m // 16)) // 32)
                                   * 32)), n
        fit = lines >= 4 and _walk_rounds_fit(m, threads)
        assert (n1, n2) == ((m, 1) if fit else ck._lines_factors(m)), n
        assert threads % 32 == 0 and 32 <= threads <= 512, n
        assert lines * m <= 16384, n
        one += n2 == 1
        assert _walk_rounds_fit(n1, threads) and _walk_rounds_fit(n2, threads)
        tw = 64 + -(-m // 64) + 64 + m // 128 + 1
        assert len(ck.r2c_twiddle(n, False)) == tw
        points = (lines * n2 * (n1 | 1) + _walk_table_points(n1)
                  + _walk_table_points(n2) + tw)
        assert smem == 8 * points <= ck.MAX_SMEM_BYTES, n
    assert one == R2C_ONE_PASS


@pytest.mark.parametrize("n,split,lines", [(1024, (512, 1), 4),
                                           (4, (2, 1), 1024),
                                           (2048, (64, 16), 2),
                                           (16384, (128, 64), 1),
                                           (7182, (63, 57), 1)])
def test_r2c_layout_of_named_lengths(n, split, lines):
    """bench.py's n = 1024 runs its 512-point DFT as one pass, 4 lines a
    block (128 threads, 16 points a thread); longer lines as two factors."""
    assert ck.r2c_split(n) == split
    assert ck.r2c_layout(n)[1] == lines


@pytest.mark.parametrize("n", [4, 1024, 7182, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_r2c_twiddle_tables(n, inverse):
    """The inter-factor twiddle's two tables are `fft_lines`' at m (no
    scale), and hi[k >> 6] * lo[k & 63] of the untangle's is e^{-2 pi i k /
    n} at every k <= m/2."""
    m = n // 2
    tw = ck.r2c_twiddle(n, inverse)
    pair = ck.twofactor_twiddle_pair(m, inverse)
    np.testing.assert_array_equal(tw[:len(pair)], pair)
    lo, hi = tw[len(pair):len(pair) + 64], tw[len(pair) + 64:]
    k = np.arange(m // 2 + 1)
    want = np.exp(-2j * np.pi * k / n)
    assert np.abs(hi[k >> 6] * lo[k & 63] - want).max() < 1e-14


class _R2CRecorder:
    """The C library stub: each real entry's arguments, the plans read back
    from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name in ("vk_fft_r2c", "vk_fft_c2r"):
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[5:7]]
                inverse = name == "vk_fft_c2r"
                self.calls.append({"entry": name, "batch": args[3],
                                   "packed": args[4], "plans": plans,
                                   "scale": args[10] if inverse else None,
                                   "layout": tuple(args[10 + inverse:
                                                        13 + inverse])})
            return 0
        return call


@pytest.mark.parametrize("n", [1024, 2048, 7182, 4])
def test_r2c_launch_arguments(monkeypatch, n):
    """Each direction and layout launches once with the batch, the layout
    flag, the unscaled plans of `r2c_split`'s factors (forward for r2c,
    inverse for c2r), the inverse's scale and the layout of
    `r2c_layout`."""
    lib = _R2CRecorder()
    monkeypatch.setattr(ck, "_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ck, "fft_r2c_plain", None)
    monkeypatch.setattr(ck, "fft_c2r_plain", None)
    ck.reset_launches()
    B, m = 3, n // 2
    x = torch.empty(B, n, device="meta")
    for packed in (False, True):
        yr, yi = ck.fft_r2c(x, packed)
        assert yr.shape == yi.shape == (B, m if packed else m + 1)
        z = ck.fft_c2r(yr, yi, n, 2.0 / n, packed)
        assert z.shape == (B, n)
    assert ck.launches == {k: 4 if k == "fft_r2c" else 0
                           for k in ck.KERNEL_SOURCES}
    n1, n2 = ck.r2c_split(n)
    for call, (entry, packed) in zip(
            lib.calls, [("vk_fft_r2c", 0), ("vk_fft_c2r", 0),
                        ("vk_fft_r2c", 1), ("vk_fft_c2r", 1)], strict=True):
        inverse = entry == "vk_fft_c2r"
        assert (call["entry"], call["batch"], call["packed"]) == (entry, B,
                                                                  packed)
        assert call["scale"] == (2.0 / n if inverse else None)
        assert call["layout"] == ck.r2c_layout(n)
        for ints, f in zip(call["plans"], (n1, n2)):
            assert ints == list(ck.stage_tables(f, inverse, 1.0, True)[0])
    tab = ck._DEVICE_TABLES[("r2c_twiddle", n, True, "meta")]
    assert tuple(tab.shape) == (len(ck.r2c_twiddle(n, True)), 2)


@pytest.mark.parametrize("n", [2048, 7182, 16384])
def test_fft_r2c_plain_matches_r2c_kernel_at_two_factor_lengths(interpret, n):
    """At lengths whose m = n/2 the kernel runs as two factors, the plain
    versions (through the wrappers on CPU tensors) agree with the JAX
    package's Pallas R2C kernels in interpret mode, or with its jnp engine
    where they do not take n, and with numpy, in both layouts."""
    x = _real((2, n), seed=n)
    xt = torch.from_numpy(x)
    want = np.fft.rfft(x.astype(np.float64))
    kernel = pallas_engine.use_r2c_kernel(n)
    for packed in (False, True):
        yr, yi = ck.fft_r2c(xt, packed)
        nr, ni = ck.packed_to_numpy_layout(yr, yi) if packed else (yr, yi)
        got = _c(vt.Planar(nr, ni))
        assert _rel(got, want) <= NUMPY_TOL
        if kernel:
            fwd = (pallas_engine.rfft_lines_packed if packed
                   else pallas_engine.rfft_lines_planar)
            ref = _c(vt.Planar(*fwd(jnp.asarray(x))))
            assert _rel(_c(vt.Planar(yr, yi)), ref) <= REF_TOL
        else:
            ref = np.asarray(vk.rfft(x, engine="jnp"))
            assert _rel(got, ref) <= REF_TOL
        z = ck.fft_c2r(yr, yi, n, 2.0 / n, packed)
        assert _rel(z.numpy(), x) <= NUMPY_TOL
