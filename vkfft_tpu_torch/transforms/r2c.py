"""Real-to-complex / complex-to-real transforms.

Port of ``vkfft_tpu/transforms/r2c.py`` (reference R2C machinery:
``appendR2C_write`` vkFFT_R2C.h:450, ``appendC2R_read`` :178, the even-n
half-size decomposition ``vkFFT_Plan_R2C.h:30``).  Each length goes one of
three ways, on either engine:

* even n >= 4: the engine's real lines (`rfft_lines_p`/`irfft_lines_p`):
  on the card the `fft_r2c`/`fft_c2r` kernel, which takes every even n
  whose n/2 the C2C kernels take and refuses the rest; on the CPU the
  plain even-n decomposition of `torch_engine`;
* odd n with at least two lines: merged sequences, two real lines riding
  one complex FFT (reference merged rows, ``vkFFT_R2C.h:27-177``);
* n < 4, or odd n with one line: the complex transform of the real input.

The N-D forms run the two minor axes as one real pair pass on an engine
that has one (`r2c_pair_supports`), else the real axis as lines, and then
the complex axes on the half spectrum; the inverse mirrors this and folds
the whole 1/N into its last pass.

float16 / bfloat16 data keeps the JAX package's dtypes, which its
untangle sets (``vkfft_tpu/transforms/r2c.py:173-182``, ``:236-246``):
the even-n and merged-sequences forwards run their C2C at the data's
dtype and untangle in fp32, returning float32 planes; the even-n inverse
widens the half spectrum and runs in fp32, to float32 data; the
merged-sequences inverse and the n < 4 / one-line route stay at the half
dtype.  `rfftn` then runs the complex axes on the float32 half spectrum;
`irfftn` of a half spectrum runs each complex axis's inverse at the half
dtype scaled by its own 1/n, as the JAX package normalizes each axis (a
whole 1/N on the last pass would let float16's intermediates overflow),
then the real axis with its 1/n.  An inverse ignores the imaginary parts
of the DC and Nyquist bins, as numpy does, on every route and at every
batch (the JAX package's jnp route folds them in, and its Pallas kernels
let them leak into the merged partner line or plane).

Inputs: a ``Planar`` (its real plane is the real data), a torch tensor, or
a host array (placed on ``device`` as float32, the SINGLE precision of the
functional API).  A forward returns a ``Planar`` for a ``Planar`` and a
complex tensor or numpy array otherwise; an inverse returns a real tensor,
or a numpy array for host input.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from vkfft_tpu_torch import api
from vkfft_tpu_torch.pcomplex import (STORAGE_DTYPES, Planar, from_complex,
                                      mul_neg_i, real_planar, to_complex,
                                      to_numpy, widened)
from vkfft_tpu_torch.planner.plan import plan_axis


def _real_input(x, device, what: str = "rfft"):
    """(real tensor, kind) of a forward's input; kind is 'planar',
    'tensor' or 'host'."""
    if isinstance(x, Planar):
        return x.re, "planar"
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            raise TypeError(f"{what} input must be real")
        return x, "tensor"
    a = np.asarray(x)
    if np.iscomplexobj(a):
        raise TypeError(f"{what} input must be real")
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(api.resolve_device(device)), "host"


def _spectrum_input(X, device):
    """(Planar, kind) of an inverse's input, as `_real_input`."""
    if isinstance(X, Planar):
        return X, "planar"
    if isinstance(X, torch.Tensor):
        return from_complex(X), "tensor"
    return from_complex(np.asarray(X), api.resolve_device(device)), "host"


def _complex_out(p: Planar, kind: str):
    return p if kind == "planar" else (to_numpy(p) if kind == "host"
                                       else to_complex(p))


def _real_out(y: torch.Tensor, kind: str):
    return y.detach().cpu().numpy() if kind == "host" else y


def _engine(engine: Optional[str], x):
    return api.get_engine(engine or api.engine_for(x))


def _axes(axes, ndim: int) -> tuple[int, ...]:
    if axes is None:
        return tuple(range(ndim))
    if not isinstance(axes, (tuple, list)):
        axes = (axes,)
    return tuple(a % ndim for a in axes)


def _move(x, src: int, dst: int):
    if src == dst:
        return x
    if isinstance(x, Planar):
        return Planar(x.re.movedim(src, dst), x.im.movedim(src, dst))
    return x.movedim(src, dst)


def _rfft_merged(flat: torch.Tensor, eng) -> Planar:
    """Merged-sequences R2C of (b, n) lines, n odd: z = x_a + i x_b, one
    C2C transform, and the Hermitian split recovers both half spectra (in
    fp32 for half lines, float32 planes out, as the JAX package's
    ``np.float32(0.5)`` promotes them)."""
    b, n = flat.shape
    if b % 2:
        flat = torch.cat([flat, flat.new_zeros(1, n)])
    Z = widened(eng.fft_lines_p(Planar(flat[0::2], flat[1::2]),
                                plan_axis(n)))
    h = n // 2 + 1
    Zk = Z[:, :h]
    Zr = Z[:, (-np.arange(h)) % n].conj()
    Xa = (Zk + Zr) * 0.5                   # spectrum of the even lines
    Xb = mul_neg_i((Zk - Zr) * 0.5)        # spectrum of the odd lines
    pairs = Xa.shape[0]
    return Planar(torch.stack([Xa.re, Xb.re], 1).reshape(2 * pairs, h)[:b],
                  torch.stack([Xa.im, Xb.im], 1).reshape(2 * pairs, h)[:b])


def _irfft_merged(p: Planar, n: int, eng, norm: float) -> torch.Tensor:
    """Inverse of the merged-sequences trick on (b, n//2+1) half spectra:
    Z = F_a + i F_b with Hermitian tails, one inverse C2C, and the two real
    lines come back as the re/im planes.  Im(DC) is dropped first, as numpy
    drops it (it would leak into the other line).  Half spectra stay at
    their dtype, as in the JAX package."""
    b, h = p.shape
    p = Planar(p.re, torch.cat([p.im[:, :1] * 0, p.im[:, 1:]], 1))
    if b % 2:
        zrow = p.re.new_zeros(1, h)
        p = Planar(torch.cat([p.re, zrow]), torch.cat([p.im, zrow]))
    Xa, Xb = p[0::2], p[1::2]
    j = np.arange(n - h, 0, -1)            # n - k for k in [h, n)
    ta, tb = Xa[:, j], Xb[:, j]
    Z = Planar(torch.cat([Xa.re - Xb.im, ta.re + tb.im], 1),
               torch.cat([Xa.im + Xb.re, tb.re - ta.im], 1))
    z = eng.fft_lines_p(Z, plan_axis(n), inverse=True, scale=norm)
    pairs = z.shape[0]
    return torch.stack([z.re, z.im], 1).reshape(2 * pairs, n)[:b]


def _rfft_last(x: torch.Tensor, eng) -> Planar:
    """Half spectrum along the last axis of real ``x``."""
    *lead, n = x.shape
    b = math.prod(lead)
    flat = x.reshape(b, n)
    if n % 2 == 0 and n >= 4:
        X = eng.rfft_lines_p(flat)
    elif n % 2 and n >= 3 and b >= 2:
        X = _rfft_merged(flat, eng)
    else:
        X = eng.fft_lines_p(real_planar(flat), plan_axis(n))[:, :n // 2 + 1]
    return X.reshape(*lead, n // 2 + 1)


def _fit_bins(p: Planar, h: int) -> Planar:
    """Crop or zero-pad the last axis to h bins, as numpy's irfft does."""
    m = p.shape[-1]
    if m == h:
        return p
    if m > h:
        return p[..., :h]
    pad = torch.nn.functional.pad
    return Planar(pad(p.re, (0, h - m)), pad(p.im, (0, h - m)))


def _fit_axis(p: Planar, axis: int, n: int) -> Planar:
    """Crop or zero-pad ``axis`` at its end to n points, as numpy's
    irfftn does to each complex axis before its inverse; into new planes,
    so the caller's stay unchanged and the walk owns the result."""
    m = p.shape[axis]
    if m == n:
        return p
    if m > n:
        return Planar(p.re.narrow(axis, 0, n).contiguous(),
                      p.im.narrow(axis, 0, n).contiguous())
    shape = list(p.shape)
    shape[axis] = n - m
    zeros = p.re.new_zeros(shape)
    return Planar(torch.cat([p.re, zeros], axis), torch.cat([p.im, zeros], axis))


def _irfft_last(p: Planar, n: int, eng, norm: float) -> torch.Tensor:
    """Real length-n data along the last axis of half spectrum ``p``: the
    unnormalized inverse times ``norm`` (1/n gives numpy's irfft).  Even n
    >= 4 returns float32 data for a half spectrum (the engines widen it);
    the other routes keep its dtype."""
    h = n // 2 + 1
    p = _fit_bins(p, h)
    *lead, _ = p.shape
    b = math.prod(lead)
    flat = p.reshape(b, h)
    if n % 2 == 0 and n >= 4:
        # the real kernels scale by (n/2)*scale
        y = eng.irfft_lines_p(flat, n, scale=2.0 * norm)
    elif n % 2 and n >= 3 and b >= 2:
        y = _irfft_merged(flat, n, eng, norm)
    else:
        # the full Hermitian spectrum through a complex inverse; its real
        # part ignores Im(DC) and Im(Nyquist)
        tail = flat[:, 1:n - h + 1][:, ::-1].conj()
        full = Planar(torch.cat([flat.re, tail.re], 1),
                      torch.cat([flat.im, tail.im], 1))
        y = eng.fft_lines_p(full, plan_axis(n), inverse=True, scale=norm).re
    return y.reshape(*lead, n)


def rfft(x, axis: int = -1, engine: Optional[str] = None, device="cuda"):
    """Forward real FFT along ``axis``: the n//2+1 half spectrum (numpy
    ``rfft`` convention, unnormalized)."""
    xr, kind = _real_input(x, device)
    eng = _engine(engine, xr)
    axis %= xr.ndim
    X = _rfft_last(_move(xr, axis, -1), eng)
    return _complex_out(_move(X, -1, axis), kind)


def irfft(X, n: Optional[int] = None, axis: int = -1,
          engine: Optional[str] = None, device="cuda"):
    """Inverse real FFT along ``axis`` (numpy ``irfft`` convention:
    normalized by 1/n, real output of length ``n``, default
    2*(bins-1))."""
    p, kind = _spectrum_input(X, device)
    eng = _engine(engine, p)
    axis %= p.ndim
    if n is None:
        n = 2 * (p.shape[axis] - 1)
    if n < 1:
        raise ValueError(f"invalid output length {n}")
    y = _irfft_last(_move(p, axis, -1), n, eng, 1.0 / n)
    return _real_out(_move(y, -1, axis), kind)


def _pair_ok(eng, shape, axes, nz: int, dtype) -> bool:
    """Whether the two minor axes of data of ``dtype`` run as one real pair
    pass."""
    ndim = len(shape)
    ok = getattr(eng, "r2c_pair_supports", None)
    return (ok is not None and len(axes) >= 2 and axes[-1] == ndim - 1
            and ndim - 2 in axes and ok(shape[-2], nz, dtype))


def rfftn(x, axes: Optional[Sequence[int]] = None,
          engine: Optional[str] = None, device="cuda"):
    """N-D real FFT: the real transform along the last of ``axes``, complex
    along the rest (numpy ``rfftn``).  When the two minor axes qualify they
    run as one real pair pass."""
    xr, kind = _real_input(x, device)
    eng = _engine(engine, xr)
    ndim = xr.ndim
    axes = _axes(axes, ndim)
    if _pair_ok(eng, xr.shape, axes, xr.shape[-1], xr.dtype):
        y = eng.rfft_pair_p(xr)
        rest = [a for a in axes if a < ndim - 2]
    else:
        y = _move(_rfft_last(_move(xr, axes[-1], -1), eng), -1, axes[-1])
        rest = axes[:-1]
    owned = api.owned_by_walk(xr)
    for a in rest:
        y = eng.fft_axis_p(y, a, plan_axis(y.shape[a]), donate=owned(y))
    return _complex_out(y, kind)


def irfftn(X, s: Optional[Sequence[int]] = None,
           axes: Optional[Sequence[int]] = None,
           engine: Optional[str] = None, device="cuda"):
    """N-D inverse real FFT (numpy ``irfftn``, normalized by 1/N).  ``s``
    gives the output length of each of ``axes``: each complex axis is
    cropped or zero-padded at its end to its entry before its inverse, the
    real axis's bins to s[-1] // 2 + 1, as numpy does.  The 1/N rides the
    last pass, or on a float16 / bfloat16 spectrum each complex axis's 1/n
    its own pass and the real axis's 1/n the last."""
    p, kind = _spectrum_input(X, device)
    eng = _engine(engine, p)
    ndim = p.ndim
    axes = _axes(axes, ndim)
    owned = api.owned_by_walk(p.re, p.im)
    if s is None:
        n = 2 * (p.shape[axes[-1]] - 1)
    else:
        if len(s) != len(axes):
            raise ValueError(f"s {tuple(s)} and axes {axes} differ in length")
        if any(k < 1 for k in s[:-1]):
            raise ValueError(f"invalid output lengths {tuple(s)}")
        for a, k in zip(axes[:-1], s[:-1]):
            p = _fit_axis(p, a, k)
        n = s[-1]
    if n < 1:
        raise ValueError(f"invalid output length {n}")
    # the 1/n of the complex axes: on the last pass, or on half planes
    # each on its own pass (outer 1 left for the last)
    per_axis = p.dtype in STORAGE_DTYPES
    outer = 1 if per_axis else math.prod(p.shape[a] for a in axes[:-1])
    pair = (_pair_ok(eng, p.shape[:-1] + (n,), axes, n, p.dtype)
            and p.shape[-1] == n // 2 + 1)
    rest = [a for a in axes if a < ndim - 2] if pair else axes[:-1]
    for a in rest:
        p = eng.fft_axis_p(p, a, plan_axis(p.shape[a]), inverse=True,
                           donate=owned(p),
                           scale=1.0 / p.shape[a] if per_axis else 1.0)
    if pair:
        # y carries the 1/N of every complex axis, z the real kernels' 2/n
        y = eng.irfft_pair_p(p, n, scale_y=1.0 / outer, scale_z=2.0 / n)
    else:
        last = axes[-1]
        y = _move(_irfft_last(_move(p, last, -1), n, eng, 1.0 / (outer * n)),
                  -1, last)
    return _real_out(y, kind)


def rfft2(x, axes=(-2, -1), engine: Optional[str] = None, device="cuda"):
    return rfftn(x, axes=axes, engine=engine, device=device)


def irfft2(X, s=None, axes=(-2, -1), engine: Optional[str] = None,
           device="cuda"):
    return irfftn(X, s=s, axes=axes, engine=engine, device=device)
