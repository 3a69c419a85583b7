"""Real-to-real transforms: DCT and DST types I-IV.

Port of ``vkfft_tpu/transforms/r2r.py`` (the reference's
``PrePostProcessing/vkFFT_R2R.h``), scipy.fft's ``norm=None`` conventions.
Each type along the last axis goes one of two ways, as the JAX package's
``_kernel_ok``/``_dct_kernel_ok`` decide there:

* the engine's R2R line kernel, where the engine has one and its gate
  holds (`r2r_route`): on the card `fft_dct23` (types II and III),
  `fft_dct1` or `fft_dct4`, each DST the same kernel with a flag, and the
  inverse's 1/(2(n -+ 1)) or 1/(2n) folded into the kernel's scale;
* otherwise the JAX package's composition onto the engine's real and
  complex FFTs: the DCT-I/DST-I extensions, Makhoul's permutation for
  DCT-II/III, the n/2 and 2n forms of DCT-IV, the sign and reversal
  identities of DST-II/III/IV.  On the CPU (`ops/torch_engine.py`) every
  length goes this way; on the card the lengths outside the kernels' gates
  do, through the CUDA engine's own routes.

A non-minor axis is moved last and the result moved back, each a copy, as
the JAX package does.

Inputs: a torch tensor (it keeps its device and dtype; other than float32
and float64 it becomes float32), a ``Planar`` (its real plane), or a host
array (placed on ``device`` as float32, the SINGLE precision of the
functional API, and returned as a numpy array).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vkfft_tpu_torch import api
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.pcomplex import Planar
from vkfft_tpu_torch.planner.plan import plan_axis
from vkfft_tpu_torch.transforms import r2c


def real_input(x, device, what: str):
    """(real tensor, kind) of an R2R input, as `r2c._real_input` gives it,
    in float32 unless it is float64 (the JAX package's ``_rdt``)."""
    x, kind = r2c._real_input(x, device, what)
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    return x, kind


real_output = r2c._real_out


def _table(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _rfft_p(x: torch.Tensor, eng) -> Planar:
    """Half spectrum along the last axis (the port's rfft routes)."""
    return r2c._rfft_last(x, eng)


def _fft_p(p: Planar, eng, inverse: bool = False,
           scale: float = 1.0) -> Planar:
    """Unnormalized DFT along the last axis, times ``scale``."""
    *lead, n = p.shape
    y = eng.fft_lines_p(p.reshape(-1, n), plan_axis(n), inverse, scale=scale)
    return y.reshape(*lead, n)


def _kernel(eng, type: int, dst: bool, n: int) -> bool:
    route = getattr(eng, "r2r_route", None)
    return route is not None and route(type, dst, n) is not None


def _lines(x: torch.Tensor, eng, type: int, dst: bool,
           scale: float) -> torch.Tensor:
    *lead, n = x.shape
    return eng.r2r_lines_p(x.reshape(-1, n), type, dst, scale).reshape(
        *lead, n)


def _scaled(y: torch.Tensor, scale: float) -> torch.Tensor:
    return y * scale if scale != 1.0 else y


def _alt_sign(x: torch.Tensor) -> torch.Tensor:
    return x * _table(np.where(np.arange(x.shape[-1]) % 2, -1.0, 1.0), x)


# ---------------------------------------------------------------------------
# Each type along the last axis of real x, times ``scale``.
# ---------------------------------------------------------------------------

def _dct1(x, eng, scale):
    n = x.shape[-1]
    if n < 2:
        raise InvalidConfigError("DCT-I requires n >= 2")
    if _kernel(eng, 1, False, n):
        return _lines(x, eng, 1, False, scale)
    # even extension of length 2n-2; its rfft has exactly n bins
    ext = torch.cat([x, x[..., 1:-1].flip(-1)], -1)
    return _scaled(_rfft_p(ext, eng).re, scale)


def _dct2(x, eng, scale):
    n = x.shape[-1]
    if _kernel(eng, 2, False, n):
        return _lines(x, eng, 2, False, scale)
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], -1)
    # half-spectrum rfft + Hermitian unfold: V[k] = conj(V[n-k]) for k > n/2
    H = _rfft_p(v, eng)
    k = np.arange(n)
    idx = torch.as_tensor(np.where(k <= n // 2, k, n - k), device=x.device)
    Vr = H.re[..., idx]
    Vi = H.im[..., idx] * _table(np.where(k <= n // 2, 1.0, -1.0), x)
    # 2 scale Re(e^{-i pi k/2n} V[k])
    twr = _table(2.0 * scale * np.cos(0.5 * np.pi * k / n), x)
    twi = _table(-2.0 * scale * np.sin(0.5 * np.pi * k / n), x)
    return twr * Vr - twi * Vi


def _dct3(x, eng, scale):
    # V[k] = (c[k] - i c[n-k]) e^{i pi k/2n} (c[n] = 0), v the unnormalized
    # inverse DFT of V times scale, and Makhoul's order undone: y[2j] =
    # v[j], y[2j+1] = v[n-1-j] (the JAX package's u = V/2 and 2v, folded)
    n = x.shape[-1]
    if _kernel(eng, 3, False, n):
        return _lines(x, eng, 3, False, scale)
    k = np.arange(n)
    c_rev = torch.cat([torch.zeros_like(x[..., :1]), x[..., 1:].flip(-1)], -1)
    twr = _table(np.cos(0.5 * np.pi * k / n), x)
    twi = _table(np.sin(0.5 * np.pi * k / n), x)
    V = Planar(x * twr + c_rev * twi, x * twi - c_rev * twr)
    vr = _fft_p(V, eng, inverse=True, scale=scale).re
    half = (n + 1) // 2
    a = vr[..., :half]
    b = vr[..., half:].flip(-1)
    if n % 2:
        b = torch.cat([b, torch.zeros_like(a[..., :1])], -1)
    out = torch.stack([a, b], -1).reshape(*vr.shape[:-1], 2 * half)
    return out[..., :n]


def _dct4(x, eng, scale):
    n = x.shape[-1]
    if _kernel(eng, 4, False, n):
        return _lines(x, eng, 4, False, scale)
    if n % 2 == 0 and n >= 4:
        return _dct4_even(x, eng, scale)
    return _dct4_odd(x, eng, scale)


def _dct4_even(x, eng, scale):
    """Even-length DCT-IV via one n/2 complex FFT (the reference's N/2
    trick, ``vkfft_tpu/transforms/r2r.py:165-200`` has the derivation):
    with w[j] = (x[2j] + i x[n-1-2j]) e^{-i pi (4j+1)/4n} and W = FFT_m(w),
    m = n/2: y[2t] = 2 Re(e^{-i pi t/n} W[t]) and y[2t+1] = 2 Re(e^{i pi
    (t+1)/n} W[m-1-t])."""
    n = x.shape[-1]
    m = n // 2
    j = np.arange(m)
    pre_r = _table(np.cos(np.pi * (4 * j + 1) / (4 * n)), x)
    pre_i = _table(-np.sin(np.pi * (4 * j + 1) / (4 * n)), x)
    vr = x[..., 0::2]
    vi = x[..., 1::2].flip(-1)          # x[n-1-2j]
    W = _fft_p(Planar(vr * pre_r - vi * pre_i, vr * pre_i + vi * pre_r), eng)
    y_even = (_table(2.0 * scale * np.cos(np.pi * j / n), x) * W.re
              + _table(2.0 * scale * np.sin(np.pi * j / n), x) * W.im)
    Wr, Wi = W.re.flip(-1), W.im.flip(-1)
    y_odd = (_table(2.0 * scale * np.cos(np.pi * (j + 1) / n), x) * Wr
             - _table(2.0 * scale * np.sin(np.pi * (j + 1) / n), x) * Wi)
    return torch.stack([y_even, y_odd], -1).reshape(*x.shape[:-1], n)


def _dct4_odd(x, eng, scale):
    # half-sample shift via a 2n transform: w[j] = x[j] e^{-i pi j/2n}
    # zero-padded to 2n; DCT4[k] = 2 Re(e^{-i pi (2k+1)/4n} W[k])
    n = x.shape[-1]
    j = np.arange(n)
    pad = torch.nn.functional.pad
    w = Planar(pad(x * _table(np.cos(0.5 * np.pi * j / n), x), (0, n)),
               pad(x * _table(-np.sin(0.5 * np.pi * j / n), x), (0, n)))
    W = _fft_p(w, eng)[..., :n]
    post_r = _table(2.0 * scale * np.cos(0.25 * np.pi * (2 * j + 1) / n), x)
    post_i = _table(-2.0 * scale * np.sin(0.25 * np.pi * (2 * j + 1) / n), x)
    return post_r * W.re - post_i * W.im


def _dst1(x, eng, scale):
    n = x.shape[-1]
    if _kernel(eng, 1, True, n):
        return _lines(x, eng, 1, True, scale)
    zeros = torch.zeros_like(x[..., :1])
    # odd extension of length 2n+2; DST1[k] = -Im(E[k+1])
    ext = torch.cat([zeros, x, zeros, -x.flip(-1)], -1)
    return _scaled(-_rfft_p(ext, eng).im[..., 1:n + 1], scale)


def _dst2(x, eng, scale):
    if _kernel(eng, 2, True, x.shape[-1]):
        return _lines(x, eng, 2, True, scale)
    return _dct2(_alt_sign(x), eng, scale).flip(-1)


def _dst3(x, eng, scale):
    if _kernel(eng, 3, True, x.shape[-1]):
        return _lines(x, eng, 3, True, scale)
    return _alt_sign(_dct3(x.flip(-1), eng, scale))


def _dst4(x, eng, scale):
    if _kernel(eng, 4, True, x.shape[-1]):
        return _lines(x, eng, 4, True, scale)
    return _dct4(_alt_sign(x), eng, scale).flip(-1)


_DCT = {1: _dct1, 2: _dct2, 3: _dct3, 4: _dct4}
_DST = {1: _dst1, 2: _dst2, 3: _dst3, 4: _dst4}
_INVERSE_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _transform(family: dict, what: str, x, type: int, axis: int,
               engine: Optional[str], device, inverse: bool = False):
    if type not in family:
        raise InvalidConfigError(f"{what} type must be 1..4, got {type}")
    xt, kind = real_input(x, device, what)
    eng = api.get_engine(engine or api.engine_for(xt))
    axis %= xt.ndim
    n = xt.shape[axis]
    scale = 1.0
    if inverse:
        # idct(dct(x)) == x: DCT-I by 1/(2(n-1)), DST-I by 1/(2(n+1)),
        # the others by 1/(2n)
        if type == 1:
            if family is _DCT and n < 2:
                raise InvalidConfigError("DCT-I requires n >= 2")
            scale = 1.0 / (2 * (n - 1 if family is _DCT else n + 1))
        else:
            scale = 1.0 / (2 * n)
        type = _INVERSE_TYPE[type]
    y = family[type](r2c._move(xt, axis, -1), eng, scale)
    if axis != xt.ndim - 1:
        y = r2c._move(y, -1, axis).contiguous()
    return real_output(y, kind)


def dct(x, type: int = 2, axis: int = -1, engine: Optional[str] = None,
        device="cuda"):
    """DCT-I/II/III/IV along ``axis`` (scipy ``norm=None`` convention)."""
    return _transform(_DCT, "dct", x, type, axis, engine, device)


def dst(x, type: int = 2, axis: int = -1, engine: Optional[str] = None,
        device="cuda"):
    """DST-I/II/III/IV along ``axis`` (scipy ``norm=None`` convention)."""
    return _transform(_DST, "dst", x, type, axis, engine, device)


def idct(y, type: int = 2, axis: int = -1, engine: Optional[str] = None,
         device="cuda"):
    """Inverse DCT: idct(dct(x, type), type) == x."""
    return _transform(_DCT, "idct", y, type, axis, engine, device, True)


def idst(y, type: int = 2, axis: int = -1, engine: Optional[str] = None,
         device="cuda"):
    """Inverse DST: idst(dst(x, type), type) == x."""
    return _transform(_DST, "idst", y, type, axis, engine, device, True)


def _nd(fn, what: str, x, type: int, axes, engine, device):
    if type not in _DCT:
        raise InvalidConfigError(f"{what} type must be 1..4, got {type}")
    xt, kind = real_input(x, device, what)
    for a in r2c._axes(axes, xt.ndim):
        xt = fn(xt, type=type, axis=a, engine=engine)
    return real_output(xt, kind)


def dctn(x, type: int = 2, axes: Optional[Sequence[int]] = None,
         engine: Optional[str] = None, device="cuda"):
    """DCT of ``type`` along each of ``axes`` (default all), in order."""
    return _nd(dct, "dctn", x, type, axes, engine, device)


def dstn(x, type: int = 2, axes: Optional[Sequence[int]] = None,
         engine: Optional[str] = None, device="cuda"):
    """DST of ``type`` along each of ``axes`` (default all), in order."""
    return _nd(dst, "dstn", x, type, axes, engine, device)
