"""Zero-pad windows of ConvolutionApplication's "pair" mode in the port.

The windowed 2-D mode of `fft_conv_pair` (its plain version on the CPU)
against the JAX package's ``conv_fused_pair`` with ``in_keep`` in
interpret mode (``tests/test_conv.py:326-352``) and against numpy; the
3-D all-axes windowed convolution of ``tests/test_conv.py:277-301``;
output windows; and on meta tensors each windowed call's exact launches,
with no masking pass on the elided route.
"""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar

import vkfft_tpu_torch as vt
from vkfft_tpu_torch import api
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine

REF_TOL = 1e-5
NUMPY_TOL = 5e-6


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    try:
        yield
    finally:
        pallas_engine.set_interpret(False)


def _c(p):
    return (p.re.double().numpy() if isinstance(p.re, torch.Tensor)
            else np.asarray(p.re, np.float64)) + 1j * (
        p.im.double().numpy() if isinstance(p.im, torch.Tensor)
        else np.asarray(p.im, np.float64))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _planar(x):
    return vt.from_numpy_planar(x.real.astype(np.float32).copy(),
                                x.imag.astype(np.float32).copy())


def _conv(x, h, axes):
    return np.fft.ifftn(np.fft.fftn(x, axes=axes) * np.fft.fftn(h, axes=axes),
                        axes=axes)


def test_conv_fused_pair_in_keep_matches_reference(interpret):
    """in_keep = (64, 64) at 128^2 (the reference's zero-padded conv bench
    geometry): the port's windowed 2-D mode reads the corner of the whole
    planes in place; the JAX package's kernel and numpy agree."""
    rng = np.random.default_rng(51)
    ny = nz = 128
    x = np.zeros((2, ny, nz), np.complex128)
    x[:, :64, :64] = (rng.standard_normal((2, 64, 64))
                      + 1j * rng.standard_normal((2, 64, 64)))
    # the declared-zero region holds garbage: it must never be read
    junk = x.copy()
    junk[:, 64:, :] = 1e6
    junk[:, :, 64:] = -1e6
    h = rng.standard_normal((ny, nz)) + 1j * rng.standard_normal((ny, nz))
    H = np.fft.fft2(h)
    ref_np = np.fft.ifft2(np.fft.fft2(x, axes=(1, 2)) * H[None], axes=(1, 2))
    p = JPlanar(jnp.asarray(x.real.astype(np.float32)),
                jnp.asarray(x.imag.astype(np.float32)))
    Ht = np.ascontiguousarray(np.swapaxes(H, 0, 1))
    ref = pallas_engine.conv_fused_pair(p, ny, nz, Ht, scale=1.0 / (ny * nz),
                                        in_keep=(64, 64))
    table = cuda_engine.conv_spectrum(_planar(H))
    got = cuda_engine.conv_fused_pair(_planar(junk), ny, nz, table,
                                      scale=1.0 / (ny * nz), in_keep=(64, 64))
    assert got.shape == (2, ny, nz)
    assert _rel(_c(got), _c(ref)) <= REF_TOL
    assert _rel(_c(got), ref_np) <= NUMPY_TOL
    # from the cropped corner, and writing an (oy, oz) corner only
    got = cuda_engine.conv_fused_pair(_planar(x[:, :64, :64]), ny, nz, table,
                                      scale=1.0 / (ny * nz), in_keep=(64, 64),
                                      out_keep=(7, 13))
    assert got.shape == (2, 7, 13)
    assert _rel(_c(got), ref_np[:, :7, :13]) <= NUMPY_TOL


@pytest.mark.parametrize("conj,xpow", [(False, False), (True, True)])
@pytest.mark.parametrize("keeps", [((1, 1), (0, 0)), ((7, 13), (5, 3)),
                                   ((16, 30), (31, 59)), ((0, 0), (1, 59))])
def test_windowed_plain_is_masked_conv(conj, xpow, keeps):
    """The windowed 2-D mode's plain version is the unwindowed one on the
    masked planes, cropped: every corner and flag, (ny - 1, nz - 1)
    included."""
    (ky, kz), (oy, oz) = keeps
    ny, nz = 32, 60
    rng = np.random.default_rng(ky + kz + oy)
    x = rng.standard_normal((3, ny, nz)) + 1j * rng.standard_normal((3, ny, nz))
    tab = torch.from_numpy(rng.standard_normal((2 * ny * nz, 2))
                           .astype(np.float32))
    xp = _planar(x)
    got = ck.fft_conv_pair(xp.re, xp.im, tab, conj_data=conj, xpow=xpow,
                           scale=0.5, in_keep=(ky, kz), out_keep=(oy, oz))
    xm = x.copy()
    xm[:, ky or ny:, :] = 0
    xm[:, :, kz or nz:] = 0
    mp = _planar(xm)
    want = ck.fft_conv_pair(mp.re, mp.im, tab, conj_data=conj, xpow=xpow,
                            scale=0.5)
    want = _c(vt.Planar(*want))[:, :oy or ny, :oz or nz]
    assert _rel(_c(vt.Planar(*got)), want) <= 1e-6


def test_conv_3d_all_axes_windows():
    """The sample-51 pattern (``tests/test_conv.py:277-301``): a 3-D
    convolution with declared-zero windows on every axis, at 2e-6 of
    numpy; the outer pass reads only its kept rows of the minor corner, the
    pair kernel only the corner."""
    rng = np.random.default_rng(63)
    n0, ny, nz = 8, 128, 128
    h0, hy, hz = 4, 64, 64
    shape = (n0, ny, nz)
    x = np.zeros(shape, np.complex64)
    x[:h0, :hy, :hz] = (rng.standard_normal((h0, hy, hz))
                        + 1j * rng.standard_normal((h0, hy, hz)))
    h = np.zeros(shape, np.complex64)
    h[:2, :8, :8] = rng.standard_normal((2, 8, 8)).astype(np.float32)
    cfg = vt.FFTConfig(shape=shape, convolution=True,
                       zeropad_input=((h0, n0), (hy, ny), (hz, nz)))
    app = vt.ConvolutionApplication(cfg, h, engine="cuda", device="cpu")
    assert app.fusion_mode == "pair"
    assert app._pair_windows() == (((hy, hz), {0: h0}), None)
    got = _c(app(_planar(x)))
    ref = _conv(x.astype(np.complex128), h.astype(np.complex128), (0, 1, 2))
    assert _rel(got, ref) < 2e-6


@pytest.mark.parametrize("shape,zin,zout", [
    ((64, 96), None, ((40, 64), (50, 96))),
    ((64, 96), ((32, 64), (48, 96)), ((40, 64), (50, 96))),
    ((4, 32, 64), ((2, 4), (16, 32), (32, 64)), (None, (20, 32), (40, 64))),
])
def test_output_windows(shape, zin, zout):
    """Output windows of the minor pair: the kernel writes the (oy, oz)
    corner, the zeros restored once at the end; the JAX package's pair mode
    takes the same windows (``_pair_prefix_keep``) and the values agree
    with numpy's, zeros outside the corner."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    h = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    cfg = vt.FFTConfig(shape=shape, convolution=True, zeropad_input=zin,
                       zeropad_output=zout)
    app = vt.ConvolutionApplication(cfg, _planar(h), engine="cuda",
                                    device="cpu")
    keeps, keep = app._pair_windows()
    assert keep == (zout[-2][0], zout[-1][0])
    assert vk.api._pair_prefix_keep(zout, shape) == keep
    xm = x.copy()
    for ax, w in enumerate(zin or ()):
        if w is not None:
            idx = [slice(None)] * len(shape)
            idx[ax] = slice(w[0], w[1])
            xm[tuple(idx)] = 0
    want = _conv(xm, h.astype(np.complex64).astype(np.complex128),
                 tuple(range(len(shape))))
    oy, oz = keep
    want[..., oy:, :] = 0
    want[..., :, oz:] = 0
    got = _c(app(_planar(x)))
    assert _rel(got, want) <= NUMPY_TOL
    assert np.abs(got[..., oy:, :]).max() == 0.0
    assert np.abs(got[..., :, oz:]).max() == 0.0


def test_windows_off_the_kernels_mask():
    """Windows the kernels do not elide mask as before: an interior input
    window; an output window on an outer axis; the other fused modes."""
    rng = np.random.default_rng(7)
    for shape, zin, zout, mode in (
            ((32, 48), ((5, 9), None), None, "pair"),
            ((4, 32, 48), None, ((2, 4), None, None), "pair"),
            ((256,), ((0, 100),), None, "v3_1d")):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        h = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        app = vt.ConvolutionApplication(
            vt.FFTConfig(shape=shape, convolution=True, zeropad_input=zin,
                         zeropad_output=zout), _planar(h), engine="cuda",
            device="cpu")
        assert app.fusion_mode == mode
        if mode == "pair":
            keeps, keep = app._pair_windows()
            assert keeps is None and keep is None
        xm = x.copy()
        for ax, w in enumerate(zin or ()):
            if w is not None:
                idx = [slice(None)] * len(shape)
                idx[ax] = slice(*w)
                xm[tuple(idx)] = 0
        want = _conv(xm, h.astype(np.complex64).astype(np.complex128),
                     tuple(range(len(shape))))
        for ax, w in enumerate(zout or ()):
            if w is not None:
                idx = [slice(None)] * len(shape)
                idx[ax] = slice(*w)
                want[tuple(idx)] = 0
        assert _rel(_c(app(_planar(x))), want) <= NUMPY_TOL


def test_elided_route_runs_no_mask(monkeypatch):
    """On the elided route no masking pass runs (api.apply_zeropad is never
    called with a window), the plain versions run their windowed forms;
    the masked route calls it."""
    calls = []
    real = api.apply_zeropad

    def counting(x, spec, ndim):
        if spec is not None:
            calls.append(spec)
        return real(x, spec, ndim)

    monkeypatch.setattr(api, "apply_zeropad", counting)
    rng = np.random.default_rng(3)
    shape = (8, 64, 64)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    cfg = vt.FFTConfig(shape=shape, convolution=True,
                       zeropad_input=((4, 8), (32, 64), (32, 64)),
                       zeropad_output=(None, (16, 64), (16, 64)))
    app = vt.ConvolutionApplication(cfg, _planar(x), engine="cuda",
                                    device="cpu")
    app(_planar(x))
    assert calls == []
    masked = vt.ConvolutionApplication(cfg, _planar(x), engine="torch")
    masked(_planar(x))
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# Launches on meta tensors (the C library stubbed out).
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed(monkeypatch):
    """Every launch recorded as (C entry, its window's ints); no plain
    version, no plain-engine call and no masking pass may run."""
    log = []
    real_launch = ck._launch

    def launch(name, entry, device, args, dtype=torch.float32):
        log.append((entry, [list(a) for a in args
                            if isinstance(a, ctypes.Array)
                            and a._type_ is ctypes.c_longlong]))
        return real_launch(name, entry, device, args, dtype)

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    def no_call(*args, **kw):
        raise AssertionError("a plain version or a mask ran")

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("fft_conv_pair_plain", "fft_strided_plain",
                 "fft_pair_plain"):
        monkeypatch.setattr(ck, name, no_call)
    monkeypatch.setattr(api, "apply_zeropad",
                        lambda x, spec, ndim: x if spec is None
                        else no_call())
    ck.reset_launches()
    before = torch_engine.calls
    yield log
    assert torch_engine.calls == before


def _meta(shape, dtype=torch.float32):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


# (name, shape, zeropad_input, zeropad_output, dtype, the launches in
# order: (C entry, its window ints: fft_strided (in_plane, in_row, cs, cw,
# in_keep, out_keep), fft_conv2d_zp (in_plane, out_plane, in_row,
# out_row, ky, kz, oy, oz)))
LAUNCHES = [
    ("sample51_2d", (256, 256), ((128, 256), (128, 256)), None,
     torch.float32,
     [("fft_conv2d_zp", [256 * 256, 256 * 256, 256, 256, 128, 128, 256,
                         256])]),
    ("2d_out", (64, 96), None, ((40, 64), (50, 96)), torch.float32,
     [("fft_conv2d_zp", [64 * 96, 40 * 50, 96, 50, 64, 96, 40, 50])]),
    ("2d_half", (256, 256), ((128, 256), (128, 256)), None, torch.bfloat16,
     [("fft_conv2d_zp_bf16", [256 * 256, 256 * 256, 256, 256, 128, 128,
                              256, 256])]),
    ("3d_all_axes", (8, 256, 256), ((4, 8), (128, 256), (128, 256)), None,
     torch.float32,
     # the outer pass on the (128, 128) corner of the volume read in place,
     # the pair kernel from the compact corner, the outer inverse
     [("fft_strided_zp", [8 * 256 * 256, 256 * 256, 256, 128, 4, 8]),
      ("fft_conv2d_zp", [128 * 128, 256 * 256, 128, 256, 128, 128, 256,
                         256]),
      ("fft_strided", [])]),
]


@pytest.mark.parametrize("name,shape,zin,zout,dtype,want", LAUNCHES,
                         ids=[c[0] for c in LAUNCHES])
def test_windowed_conv_launches(monkeypatch, name, shape, zin, zout, dtype,
                                want):
    """A windowed 2-D conv is one fft_conv2d_zp launch, no mask; the 3-D
    all-axes conv adds the outer axis's windowed forward and its inverse."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal(shape).astype(np.complex64)
    app = vt.ConvolutionApplication(
        vt.FFTConfig(shape=shape, convolution=True, zeropad_input=zin,
                     zeropad_output=zout), _planar(h), engine="cuda",
        device="cpu")
    assert app.fusion_mode == "pair"
    B = 2
    app._tables[("fused", "meta", torch.float32)] = torch.empty(
        (int(np.prod(shape[-2:])) * (shape[0] if len(shape) == 3 else 1), 2),
        device="meta")
    with _stubbed(monkeypatch) as log:
        y = app._convolve(_meta((B,) + shape, dtype))
    assert y.shape == (B,) + shape and y.dtype == dtype
    assert [(e, w[0] if w else []) for e, w in log] == want
    assert ck.zp_launches == {
        k: sum(1 for e, _ in want if e == k) for k in ck.zp_launches}
