"""Convolution on the port, on the CPU: `vkfft_tpu_torch.ConvolutionApplication`
and `fftconvolve` held against the JAX package on the same numpy inputs
(its Pallas kernels in interpret mode for the fused modes, as
tests/test_conv.py runs them, and its jnp engine for the composition) and
against numpy fp64; the new modes' plain versions (rows, matrix, conjugated
data, cross-power in `fft_conv`; the 2-D mode of `fft_conv_pair`) against
the Pallas kernels directly; each mode's exact launches, counted by the
wrappers on meta tensors with the library call stubbed out; the port's
fusion rule; and inputs left unchanged.  The port runs its fused modes
through the plain versions here (engine "cuda" on CPU tensors) and the
composition on the torch engine; the CUDA kernels themselves run only on
the card (chip_smoke.py).  Every test states its seed."""
import contextlib
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine

NUMPY_TOL = 5e-6
REF_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    yield
    pallas_engine.set_interpret(False)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(p):
    return (np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64))


def _jp(x):
    return JPlanar(jnp.asarray(x.real.astype(np.float32)),
                   jnp.asarray(x.imag.astype(np.float32)))


def _tp(x):
    return vt.from_numpy_planar(x.real.astype(np.float32),
                                x.imag.astype(np.float32))


def _oracle(cfg, x, h):
    """numpy fp64 of the JAX package's convolution of x with the kernel h
    (``transforms/conv.py:309-339``)."""
    ndim = len(cfg.shape)
    axes = tuple(range(-ndim, 0))
    x = np.asarray(x, np.complex128)
    if cfg.zeropad_input is not None:
        for ax, w in enumerate(cfg.zeropad_input):
            if w is not None:
                idx = [slice(None)] * x.ndim
                idx[x.ndim - ndim + ax] = slice(w[0], w[1])
                x = x.copy()
                x[tuple(idx)] = 0
    X = np.fft.fftn(x, axes=axes)
    H = np.fft.fftn(np.asarray(h, np.complex128), axes=axes)
    if cfg.conjugate_convolution == 1:
        H = np.conj(H)
    elif cfg.conjugate_convolution == 2:
        X = np.conj(X)
    m = cfg.matrix_convolution
    if m > 1:
        lead = "k" if cfg.number_kernels > 1 else ""
        Y = np.einsum(f"{lead}oi...,bi...->{lead}bo...",
                      H, X.reshape((-1,) + X.shape[-ndim - 1:]))
        Y = Y.reshape(Y.shape[:len(lead)] + X.shape)
    elif cfg.number_kernels > 1:
        Y = H.reshape(H.shape[:1] + (1,) * (X.ndim - H.ndim + 1)
                      + H.shape[1:]) * X[None]
    else:
        Y = X * H
    if cfg.cross_power_spectrum_normalization:
        Y = Y / np.maximum(np.abs(Y), 1e-30)
    y = np.fft.ifftn(Y, axes=axes)
    if cfg.zeropad_output is not None:
        for ax, w in enumerate(cfg.zeropad_output):
            if w is not None:
                idx = [slice(None)] * y.ndim
                idx[y.ndim - ndim + ax] = slice(w[0], w[1])
                y[tuple(idx)] = 0
    return y


def _port_apps(ref_app, cfg):
    """The port's application on both engines, fed the JAX app's spectrum."""
    fields = dataclasses.asdict(cfg)
    re = np.asarray(ref_app.kernel_f.re)
    im = np.asarray(ref_app.kernel_f.im)
    return {eng: vt.convolution_from_reference(fields, re, im, engine=eng,
                                               device="cpu")
            for eng in ("cuda", "torch")}


def _hold(cfg, x, h, ref_engine, port_mode):
    """The JAX app on ``ref_engine`` and the port on both engines: each
    within REF_TOL of the JAX result and NUMPY_TOL of numpy fp64; the port's
    fusion mode is ``port_mode`` on the CUDA engine, which never reaches
    the plain engine (its kernels' plain versions are not counted), and
    None on the torch engine, which runs on it."""
    ref_app = vk.ConvolutionApplication(cfg, h, engine=ref_engine)
    ref = _c(ref_app(_jp(x)))
    want = _oracle(cfg, x, h)
    assert _rel(ref, want) <= NUMPY_TOL
    apps = _port_apps(ref_app, cfg)
    assert apps["cuda"].fusion_mode == port_mode
    assert apps["torch"].fusion_mode is None
    for eng, app in apps.items():
        calls = torch_engine.calls
        got = _c(app(_tp(x)))
        assert got.shape == want.shape, eng
        assert _rel(got, ref) <= REF_TOL, eng
        assert _rel(got, want) <= NUMPY_TOL, eng
        assert (torch_engine.calls == calls) == (eng == "cuda"), eng
    return ref_app


# ---------------------------------------------------------------------------
# The fused modes against the JAX package's Pallas kernels (interpret mode).
# ---------------------------------------------------------------------------

# (shape, matrix m, config flags, data batch, JAX mode, the port's mode)
FUSED = [
    ((256,), 1, {}, (4,), "v3_1d", "v3_1d"),
    ((256,), 1, {"conjugate_convolution": 2,
                 "cross_power_spectrum_normalization": True}, (4,),
     "v3_1d", "v3_1d"),
    ((256,), 3, {}, (2,), "v3_mat", "v3_mat"),
    ((128, 128), 1, {}, (2,), "pair", "pair"),
    ((128, 128), 1, {"conjugate_convolution": 1}, (2,), "pair", "pair"),
    ((128, 128), 1, {"conjugate_convolution": 2}, (2,), "pair", "pair"),
    ((4, 128, 128), 1, {}, (2,), "pair", "pair"),
    ((4, 128, 128), 1, {"conjugate_convolution": 1}, (2,), "pair", "pair"),
    ((4, 128, 128), 1, {"conjugate_convolution": 2}, (2,), "pair", "pair"),
    # the TPU's rows % 128 and 2^16-point caps send this plane to its
    # rows mode; it fits a cluster of fft_conv_pair here
    ((256, 512), 1, {}, (1,), "v3_rows", "pair"),
]


@pytest.mark.parametrize("shape,m,flags,batch,jax_mode,port_mode", FUSED)
def test_fused_modes_match_pallas(interpret, shape, m, flags, batch, jax_mode,
                                  port_mode):
    seed = sum(shape) + 7 * m + len(flags)
    cfg = vk.FFTConfig(shape=shape, convolution=True, matrix_convolution=m,
                       coordinate_features=m, **flags)
    ks = ((m, m) if m > 1 else ()) + shape
    h = _complex(ks, seed)
    x = _complex(batch + ((m,) if m > 1 else ()) + shape, seed + 1)
    ref_app = _hold(cfg, x, h, "pallas", port_mode)
    assert ref_app.fusion_mode == jax_mode


def test_rows_mode_matches_reference():
    """The port's rows mode: a plane that fits no cluster (256 x 1024) and
    one whose outer axis is no length of the stages (67, a DIRECT prime the
    TPU's pair kernel also declines); against the JAX package's jnp engine
    and numpy, seed 41."""
    for shape in ((256, 1024), (67, 64)):
        cfg = vk.FFTConfig(shape=shape, convolution=True)
        _hold(cfg, _complex((2,) + shape, 41), _complex(shape, 42), "jnp",
              "v3_rows")


def test_two_factor_mode_matches_reference():
    """`v2_2k`: n = 10240 is beyond `fft_conv`'s stages and held by
    `fft_twofactor` + `fft_conv_inv`; a conjugated kernel rides the table.
    Cross-power has no two-kernel form: the composition.  Seed 43."""
    n = 10240
    x, h = _complex((2, n), 43), _complex((n,), 44)
    _hold(vk.FFTConfig(shape=(n,), convolution=True, conjugate_convolution=1),
          x, h, "jnp", "v2_2k")
    _hold(vk.FFTConfig(shape=(n,), convolution=True,
                       cross_power_spectrum_normalization=True),
          x, h, "jnp", None)


# ---------------------------------------------------------------------------
# The composition against the JAX package's jnp engine.
# ---------------------------------------------------------------------------

COMPOSED = [
    # number_kernels > 1: a leading kernel dim on the output
    ("kernels", (64,), dict(number_kernels=2), (2, 64), (3, 64), None),
    ("kernels_2d", (8, 16), dict(number_kernels=3), (3, 8, 16), (2, 8, 16),
     None),
    # coordinate features not in (1, m): per-feature scalar kernels
    ("features", (32,), dict(coordinate_features=2), (2, 32), (3, 2, 32),
     None),
    # an N-D matrix kernel
    ("matrix_2d", (8, 16), dict(matrix_convolution=2, coordinate_features=2),
     (2, 2, 8, 16), (3, 2, 8, 16), None),
    ("matrix_kernels", (32,), dict(matrix_convolution=2, coordinate_features=2,
                                   number_kernels=2),
     (2, 2, 2, 32), (3, 2, 32), None),
    # cross-power with a conjugated kernel (phase correlation): fused v3_1d
    ("xpow", (64,), dict(conjugate_convolution=1,
                         cross_power_spectrum_normalization=True),
     (64,), (2, 64), "v3_1d"),
    ("xpow_2d", (8, 16), dict(cross_power_spectrum_normalization=True,
                              conjugate_convolution=2),
     (8, 16), (2, 8, 16), "pair"),
    # zero-padded linear convolution, masked in and out
    ("zeropad", (64,), dict(zeropad_input=((24, 64),),
                            zeropad_output=((39, 64),)),
     (64,), (2, 64), "v3_1d"),
    ("zeropad_2d", (16, 32), dict(zeropad_input=((8, 16), (16, 32)),
                                  zeropad_output=((12, 16), None)),
     (16, 32), (2, 16, 32), "pair"),
    # a Rader axis (131) is not DIRECT: the composition on the card's routes
    ("rader_axis", (131,), {}, (131,), (2, 131), None),
    # the reference's sample 51 (cli.py:885): 3-D 3 x 3 matrix kernel, the
    # last axis's upper half declared zero
    ("sample_51", (8, 8, 32), dict(matrix_convolution=3, coordinate_features=3,
                                   zeropad_input=(None, None, (16, 32))),
     (3, 3, 8, 8, 32), (3, 8, 8, 32), None),
]


@pytest.mark.parametrize("name,shape,flags,kshape,xshape,port_mode",
                         COMPOSED, ids=[c[0] for c in COMPOSED])
def test_composition_matches_jnp(name, shape, flags, kshape, xshape,
                                 port_mode):
    seed = 100 + len(name)
    cfg = vk.FFTConfig(shape=shape, convolution=True, **flags)
    _hold(cfg, _complex(xshape, seed), _complex(kshape, seed + 1), "jnp",
          port_mode)


def test_fftconvolve_matches_reference():
    """`fftconvolve` on both engines and every input kind, seed 5."""
    x, h = _complex((3, 16, 24), 5), _complex((16, 24), 6)
    ref = np.asarray(vk.fftconvolve(x, h, engine="jnp"))
    want = np.fft.ifft2(np.fft.fft2(x.astype(np.complex128))
                        * np.fft.fft2(h.astype(np.complex128)))
    assert _rel(ref, want) <= NUMPY_TOL
    for eng in ("cuda", "torch"):
        host = vt.fftconvolve(x, h, engine=eng, device="cpu")
        assert isinstance(host, np.ndarray)
        tens = vt.fftconvolve(torch.from_numpy(x), torch.from_numpy(h),
                              engine=eng)
        assert isinstance(tens, torch.Tensor) and tens.is_complex()
        plan = vt.fftconvolve(_tp(x), h, axes=(-2, -1), engine=eng)
        assert isinstance(plan, vt.Planar)
        for got in (host, tens.numpy(), _c(plan)):
            assert _rel(got, ref) <= REF_TOL and _rel(got, want) <= NUMPY_TOL
    one = vt.fftconvolve(x, h[0], axes=(-1,), device="cpu")
    assert _rel(one, np.fft.ifft(np.fft.fft(x) * np.fft.fft(h[0]))) \
        <= NUMPY_TOL


# ---------------------------------------------------------------------------
# The new modes' plain versions against the Pallas kernels directly.
# ---------------------------------------------------------------------------

XP = [(False, False), (True, False), (False, True), (True, True)]


def _table(tab, swapped=False):
    """The fused entries' device table of a host spectrum."""
    return cuda_engine.conv_spectrum(_tp(tab), swapped=swapped)


@pytest.mark.parametrize("conj,xpow", XP)
def test_rows_plain_matches_conv_fused_v3_rows(interpret, conj, xpow):
    """`fft_conv`'s rows mode: 256 lines of 64 points, 128 spectrum rows
    (the TPU takes rows in multiples of 128), seed 7."""
    n, rows, B = 64, 128, 256
    x, tab = _complex((B, n), 7), _complex((rows, n), 8)
    scale = 1.0 / (rows * n)
    ref = pallas_engine.conv_fused_v3_rows(_jp(x), n, rows, tab.T, scale,
                                           conj, xpow)
    got = cuda_engine.conv_fused_v3_rows(_tp(x), n, rows, _table(tab), scale,
                                         conj, xpow)
    assert _rel(_c(got), _c(ref)) <= REF_TOL
    X = np.fft.fft(x.astype(np.complex128))
    Y = (np.conj(X) if conj else X) * np.tile(tab, (B // rows, 1))
    if xpow:
        Y = Y / np.abs(Y)
    assert _rel(_c(got), np.fft.ifft(Y) * n * scale) <= NUMPY_TOL


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("conj,xpow", XP)
def test_matrix_plain_matches_conv_fused_v3_matrix(interpret, m, conj, xpow):
    """`fft_conv`'s matrix mode, (5, m, 128) planes, seed 9 + m."""
    n, B = 128, 5
    x, tab = _complex((B, m, n), 9 + m), _complex((m, m, n), 10 + m)
    ref = pallas_engine.conv_fused_v3_matrix(_jp(x), n, m, tab, 1.0 / n,
                                             conj, xpow)
    got = cuda_engine.conv_fused_v3_matrix(_tp(x), n, m, _table(tab), 1.0 / n,
                                           conj, xpow)
    assert _rel(_c(got), _c(ref)) <= REF_TOL
    X = np.fft.fft(x.astype(np.complex128))
    Y = np.einsum("oin,bin->bon", tab, np.conj(X) if conj else X)
    if xpow:
        Y = Y / np.abs(Y)
    assert _rel(_c(got), np.fft.ifft(Y)) <= NUMPY_TOL


@pytest.mark.parametrize("hp", [1, 2])
@pytest.mark.parametrize("conj,xpow", XP)
def test_pair_plain_matches_conv_fused_pair(interpret, hp, conj, xpow):
    """`fft_conv_pair`'s 2-D mode, four (128, 128) planes with a shared or
    per-slice spectrum, seed 11 + hp (the TPU's table is the transpose)."""
    ny = nz = 128
    x, tab = _complex((4, ny, nz), 11 + hp), _complex((hp, ny, nz), 12 + hp)
    scale = 1.0 / (ny * nz)
    ref = pallas_engine.conv_fused_pair(_jp(x), ny, nz,
                                        np.swapaxes(tab, 1, 2), scale, conj,
                                        xpow)
    got = cuda_engine.conv_fused_pair(_tp(x), ny, nz, _table(tab), scale,
                                      conj, xpow)
    assert _rel(_c(got), _c(ref)) <= REF_TOL
    X = np.fft.fft2(x.astype(np.complex128))
    Y = (np.conj(X) if conj else X) * np.tile(tab, (4 // hp, 1, 1))
    if xpow:
        Y = Y / np.abs(Y)
    assert _rel(_c(got), np.fft.ifft2(Y)) <= NUMPY_TOL


def test_scalar_plain_matches_conv_fused_v3(interpret):
    """`fft_conv`'s scalar mode with cross-power and conjugated data, 3
    lines of 240 points, seed 13."""
    n = 240
    x, tab = _complex((3, n), 13), _complex((n,), 14)
    ref = pallas_engine.conv_fused_v3(_jp(x), n, tab, 1.0 / n, True, True)
    got = cuda_engine.conv_fused_v3(_tp(x), n, _table(tab), 1.0 / n, True,
                                    True)
    assert _rel(_c(got), _c(ref)) <= REF_TOL


def test_planar_plain_matches_conv_fused_planar(interpret):
    """`conv_fused_planar` (v2_2k) at n = 4096, the JAX package's two
    kernels against `fft_twofactor` + `fft_conv_inv`, seed 15."""
    n = 4096
    x, tab = _complex((2, n), 15), _complex((n,), 16)
    ref = pallas_engine.conv_fused_planar(_jp(x), n, tab)
    got = cuda_engine.conv_fused_planar(_tp(x), n, _table(tab, swapped=True))
    assert _rel(_c(got), _c(ref)) <= REF_TOL
    want = np.fft.ifft(np.fft.fft(x.astype(np.complex128)) * tab)
    assert _rel(_c(got), want) <= NUMPY_TOL


# ---------------------------------------------------------------------------
# Launches on meta tensors, the fusion rule, inputs, refusals.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch goes through
    `cuda_kernels._launch` and its counter, to a library stub that does
    nothing; no plain-engine call."""
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


# (name, shape, flags, data batch, mode, launches of one call) — the rows
# chip_smoke.py drives, at their widths, with a short batch
LAUNCHES = [
    ("v3_1d", (4096,), {}, 2, "v3_1d", {"fft_conv": 1}),
    ("sample_50", (1024,), dict(matrix_convolution=3, coordinate_features=3),
     2, "v3_mat", {"fft_conv": 1}),
    ("sample_52", (256, 256), {}, 2, "pair", {"fft_conv_pair": 1}),
    ("rows", (512, 512), {}, 2, "v3_rows", {"fft_strided": 2, "fft_conv": 1}),
    ("per_slice", (32, 256, 256), {}, 2, "pair",
     {"fft_strided": 2, "fft_conv_pair": 1}),
    ("v2_2k", (10240,), {}, 2, "v2_2k",
     {"fft_twofactor": 1, "fft_conv_inv": 1}),
    # the composition: fftn as fft_pair on the minor pair and fft_strided
    # on the leading axis, ifftn the same back
    ("sample_51", (64, 64, 64), dict(matrix_convolution=3,
                                     coordinate_features=3,
                                     zeropad_input=(None, None, (32, 64))),
     2, None, {"fft_pair": 2, "fft_strided": 2}),
]


@pytest.mark.parametrize("name,shape,flags,batch,mode,want", LAUNCHES,
                         ids=[c[0] for c in LAUNCHES])
def test_mode_launches(monkeypatch, name, shape, flags, batch, mode, want):
    cfg = vt.FFTConfig(shape=shape, convolution=True, **flags)
    m = cfg.matrix_convolution
    ks = ((m, m) if m > 1 else ()) + shape
    spec = vt.Planar(torch.ones(ks), torch.zeros(ks))
    app = vt.ConvolutionApplication(cfg, spec, engine="cuda",
                                    kernel_in_freq_domain=True, device="cpu")
    assert app.fusion_mode == mode
    xs = (batch,) + ((m,) if m > 1 else ()) + shape
    x = vt.Planar(torch.empty(xs, device="meta"),
                  torch.empty(xs, device="meta"))
    with _stubbed_launches(monkeypatch) as launches:
        y = app(x)
        assert y.shape == xs
        assert launches == {k: want.get(k, 0) for k in ck.KERNEL_SOURCES}


RULE = [
    # (shape, config flags, the port's mode)
    ((4096,), {}, "v3_1d"),
    ((8192,), dict(cross_power_spectrum_normalization=True), "v3_1d"),
    ((10240,), {}, "v2_2k"),
    ((10240,), dict(conjugate_convolution=2), None),
    ((16384,), {}, "v2_2k"),
    ((131,), {}, None),                        # Rader: not DIRECT
    ((64,), dict(number_kernels=2), None),
    ((64,), dict(coordinate_features=2), None),
    ((256, 256), {}, "pair"),
    ((256, 512), {}, "pair"),                  # the TPU: v3_rows
    ((512, 512), {}, "v3_rows"),
    ((3, 5, 7), {}, "pair"),                   # the TPU: no 128-multiples
    ((67, 64), {}, "v3_rows"),
    ((8, 10240), {}, None),                    # no fused N-D last axis
    ((4096,), dict(matrix_convolution=3, coordinate_features=3), "v3_mat"),
    ((4096,), dict(matrix_convolution=3, coordinate_features=1), "v3_mat"),
    ((8192,), dict(matrix_convolution=2, coordinate_features=2), None),
    ((8, 16), dict(matrix_convolution=2, coordinate_features=2), None),
]


@pytest.mark.parametrize("shape,flags,mode", RULE)
def test_fusion_rule(shape, flags, mode):
    cfg = vt.FFTConfig(shape=shape, convolution=True, **flags)
    m, k = cfg.matrix_convolution, cfg.number_kernels
    ks = ((k,) if k > 1 else ()) + ((m, m) if m > 1 else ()) + shape
    spec = vt.Planar(torch.ones(ks), torch.zeros(ks))
    for engine, want in ((None, mode), ("cuda", mode), ("torch", None)):
        app = vt.ConvolutionApplication(cfg, spec, engine=engine,
                                        kernel_in_freq_domain=True,
                                        device="cpu")
        assert app.fusion_mode == want, engine


@pytest.mark.parametrize("shape,m,flags", [
    ((64,), 1, {}), ((64,), 2, {}), ((16, 32), 1, {}), ((4, 16, 32), 1, {}),
    ((32, 64), 1, dict(zeropad_input=((8, 32), None))),
    ((1, 64), 1, {}), ((4096,), 1, dict(conjugate_convolution=2)),
    ((10240,), 1, {}), ((8, 16), 2, {})])
def test_input_left_unchanged(shape, m, flags):
    """No mode writes over the caller's planes, a length-1 outer axis
    included; seed 21."""
    cfg = vt.FFTConfig(shape=shape, convolution=True, matrix_convolution=m,
                       coordinate_features=m if m > 1 else 1, **flags)
    ks = ((m, m) if m > 1 else ()) + shape
    xs = (2,) + ((m,) if m > 1 else ()) + shape
    h, x = _complex(ks, 21), _complex(xs, 22)
    want = _oracle(cfg, x, h)
    for engine in ("cuda", "torch"):
        app = vt.ConvolutionApplication(cfg, h, engine=engine, device="cpu")
        p = _tp(x)
        keep = (p.re.clone(), p.im.clone())
        got = app(p)
        assert torch.equal(p.re, keep[0]) and torch.equal(p.im, keep[1])
        assert _rel(_c(got), want) <= NUMPY_TOL
        host = app(x)
        assert isinstance(host, np.ndarray) and host.dtype == np.complex64
        assert _rel(host, want) <= NUMPY_TOL
        tens = app(torch.from_numpy(x))
        assert tens.is_complex() and _rel(tens.numpy(), want) <= NUMPY_TOL


def test_fft_application_still_refuses_convolution():
    with pytest.raises(InvalidConfigError, match="ConvolutionApplication"):
        vt.FFTApplication(vt.FFTConfig(shape=(16,), convolution=True))


def test_configuration_checks():
    cfg = vt.FFTConfig(shape=(16,), convolution=True)
    h = np.ones(16, np.complex64)
    with pytest.raises(InvalidConfigError):
        vt.ConvolutionApplication(vt.FFTConfig(shape=(16,)), h, device="cpu")
    with pytest.raises(InvalidConfigError):
        vt.ConvolutionApplication(cfg, np.ones(8), device="cpu")
    with pytest.raises(InvalidConfigError):
        vt.ConvolutionApplication(
            vt.FFTConfig(shape=(16,), convolution=True, matrix_convolution=2),
            np.ones((3, 3, 16)), device="cpu")
    with pytest.raises(InvalidConfigError):
        vt.ConvolutionApplication(
            vt.FFTConfig(shape=(16,), convolution=True, number_kernels=2),
            np.ones((3, 16)), device="cpu")
    with pytest.raises(InvalidConfigError):
        vt.ConvolutionApplication(cfg, h, engine="pallas", device="cpu")
    # the precision flag is ignored, as in the JAX package: the data's
    # dtype decides (tests/test_torch_f64.py)
    vt.ConvolutionApplication(
        vt.FFTConfig(shape=(16,), convolution=True,
                     precision=vt.Precision.DOUBLE), h, device="cpu")
    app = vt.ConvolutionApplication(cfg, h, device="cpu")
    with pytest.raises(InvalidConfigError):
        app(np.ones((2, 8), np.complex64))


def test_new_wrapper_checks():
    x = torch.zeros(2, 3, 8192)
    with pytest.raises(NotImplementedError, match="shared memory"):
        ck.fft_conv(x, x, torch.zeros(9 * 8192, 2))
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        ck.fft_conv(x, x, torch.zeros(100, 2))
    with pytest.raises(ValueError):
        ck.fft_conv(torch.zeros(2, 60), torch.zeros(2, 60),
                    torch.zeros(64, 2), torch.zeros(60, 2), conj_data=True)
    p = torch.zeros(1, 512, 512)
    with pytest.raises(NotImplementedError, match="cluster"):
        ck.fft_conv_pair(p, p, torch.zeros(512 * 512, 2))
    p = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError):
        ck.fft_conv_pair(p, p, torch.zeros(100, 2))
    assert ck.conv_matrix_supports(4096, 3) and not ck.conv_matrix_supports(
        8192, 3) and ck.conv_matrix_supports(7200, 2)
