"""Double-double arithmetic on torch tensors: the port's "fp64" tier.

Port of ``vkfft_tpu/precision/doubledouble.py``.  A value is an unevaluated
sum hi + lo of two float32 numbers with |lo| <= ulp(hi)/2, kept exact by
error-free transformations (EFTs):

  two_sum  : Knuth's branch-free exact addition (6 flops)
  two_prod : Dekker's split-based exact product (split constant 2^12 + 1,
             fp32 has a 24-bit mantissa)

A complex array is four float32 planes, re.hi, re.lo, im.hi, im.lo
(`DDComplex`), about 2^-48 relative precision, as in the JAX package.

No ``optimization_barrier`` is needed here.  Eager torch runs each
operation as its own kernel and rounds its result to float32 in memory, so
nothing contracts a product into a later sum (FMA) or re-associates
``s - (s - a)`` across operations.  This module must therefore never go
through ``torch.compile`` and never use ``addcmul``/``addcdiv``, which
would fuse a product and a sum.  The CUDA kernel (``csrc/dd.cuh``) writes
the same EFTs with ``__fadd_rn``/``__fmul_rn``, which nvcc never contracts.

`ddc_from_reference` carries state across from the JAX package: the four
numpy planes of its ``DDComplex`` become the port's with the same bits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

_SPLITTER = 4097.0  # 2^12 + 1 for fp32 (24-bit mantissa)


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """two_sum for |a| >= |b| (3 flops)."""
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """a == hi + lo with hi, lo of 12 significant bits each."""
    t = _SPLITTER * a
    u = t - a
    hi = t - u
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


@dataclasses.dataclass
class DD:
    """Double-float real value: hi + lo with |lo| <= ulp(hi)/2."""

    hi: Any
    lo: Any

    @property
    def shape(self):
        return tuple(self.hi.shape)

    @property
    def ndim(self):
        return self.hi.ndim

    def reshape(self, *shape):
        return DD(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])

    def __add__(self, other):
        return dd_add(self, other)

    def __sub__(self, other):
        return dd_sub(self, other)

    def __mul__(self, other):
        return dd_mul(self, other)

    def __neg__(self):
        return dd_neg(self)


def dd_add(x: DD, y: DD) -> DD:
    """Double-double addition (the reference's ``PfQuadSum``)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + x.lo + y.lo
    hi, lo = quick_two_sum(s, e)
    return DD(hi, lo)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_sub(x: DD, y: DD) -> DD:
    return dd_add(x, dd_neg(y))


def dd_mul(x: DD, y: DD) -> DD:
    """Double-double product (the reference's ``PfQuadProd``)."""
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    hi, lo = quick_two_sum(p, e)
    return DD(hi, lo)


def split_scalar(v: float) -> tuple[float, float]:
    """A host fp64 scalar as the exact (hi, lo) float32 pair."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return float(hi), float(lo)


@functools.lru_cache(maxsize=1024)
def dd_scalar(v: float) -> DD:
    """A host fp64 scalar as a DD of 0-dim float32 CPU tensors, so that the
    EFTs on it round in fp32 (a Python float would compute in fp64)."""
    return DD(*(torch.tensor(p, dtype=torch.float32)
                for p in split_scalar(v)))


def _as_f64(a, device) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)))
    return t.to(t.device if device is None else device, torch.float64)


def dd_from_f64(a, device=None) -> DD:
    """Split fp64 data (a numpy array or a float64 tensor) into an exact
    hi + lo float32 pair, on ``device`` (default: the tensor's, or the
    CPU for numpy input), computed where the data lies."""
    t = _as_f64(a, device)
    hi = t.to(torch.float32)
    lo = (t - hi.to(torch.float64)).to(torch.float32)
    return DD(hi, lo)


def dd_to_f64(x: DD) -> torch.Tensor:
    """hi + lo as a float64 tensor on the planes' device."""
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


@dataclasses.dataclass
class DDComplex:
    """Planar complex with double-double planes: the quad-plane format of
    the "fp64" tier (four float32 planes per complex array)."""

    re: DD
    im: DD

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def device(self):
        return self.re.hi.device

    def planes(self) -> tuple:
        """(re.hi, re.lo, im.hi, im.lo)."""
        return (self.re.hi, self.re.lo, self.im.hi, self.im.lo)

    @staticmethod
    def of(planes) -> "DDComplex":
        """The inverse of `planes`."""
        rh, rl, ih, il = planes
        return DDComplex(DD(rh, rl), DD(ih, il))

    def map(self, f) -> "DDComplex":
        """``f`` applied to each of the four planes."""
        return DDComplex.of([f(p) for p in self.planes()])

    def reshape(self, *shape):
        return self.map(lambda p: p.reshape(*shape))

    def contiguous(self):
        return self.map(lambda p: p.contiguous())

    def __getitem__(self, idx):
        return self.map(lambda p: p[idx])

    def __add__(self, other):
        return DDComplex(self.re + other.re, self.im + other.im)

    def __sub__(self, other):
        return DDComplex(self.re - other.re, self.im - other.im)

    def __mul__(self, other):
        if isinstance(other, DDComplex):
            return DDComplex(self.re * other.re - self.im * other.im,
                             self.re * other.im + self.im * other.re)
        return DDComplex(self.re * other, self.im * other)

    def conj(self):
        return DDComplex(self.re, dd_neg(self.im))


def ddc_from_complex128(x, device=None) -> DDComplex:
    """Quad planes of complex data: a numpy array (split on the host, then
    moved to ``device``, default the CPU) or a complex tensor (split on its
    device, or on ``device`` when given)."""
    if isinstance(x, torch.Tensor):
        x = x.to(x.device if device is None else device, torch.complex128)
        return DDComplex(dd_from_f64(x.real.contiguous()),
                         dd_from_f64(x.imag.contiguous()))
    x = np.asarray(x, np.complex128)
    return DDComplex(dd_from_f64(x.real, device), dd_from_f64(x.imag, device))


def ddc_to_complex128(x: DDComplex) -> torch.Tensor:
    """A complex128 tensor on the planes' device."""
    return torch.complex(dd_to_f64(x.re), dd_to_f64(x.im))


def ddc_from_reference(re_hi, re_lo, im_hi, im_lo, device) -> DDComplex:
    """The port's `DDComplex` on ``device`` with the same bits as the JAX
    package's ``DDComplex`` whose four planes are given as numpy arrays
    (``np.asarray(x.re.hi)`` and so on)."""
    def plane(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise TypeError(f"dd planes are float32, got {a.dtype}")
        return torch.from_numpy(np.array(a)).to(device)
    return DDComplex.of([plane(p) for p in (re_hi, re_lo, im_hi, im_lo)])
