"""Planar complex representation on torch tensors.

Port of ``vkfft_tpu/pcomplex.py``.  A complex array is a pair of real planes
(``re``, ``im``) of one dtype on one device, the layout every kernel of the
port reads and writes (the reference's generated kernels likewise treat a
complex value as a 2-vector of scalars, ``vkFFT_Structs.h:73-91``).  Host
conversion to and from numpy complex happens only at the API boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class Planar:
    """A complex array stored as separate real/imag planes."""

    re: Any
    im: Any

    # -- shape/dtype/device passthroughs ---------------------------------
    @property
    def shape(self):
        return tuple(self.re.shape)

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def device(self):
        return self.re.device

    def astype(self, dtype):
        """The planes at ``dtype``; narrowing to float16 / bfloat16 rounds
        to nearest even (torch's ``.to``, as JAX's ``astype``)."""
        return Planar(self.re.to(dtype), self.im.to(dtype))

    def reshape(self, *shape):
        return Planar(self.re.reshape(*shape), self.im.reshape(*shape))

    def contiguous(self):
        return Planar(self.re.contiguous(), self.im.contiguous())

    def __getitem__(self, idx):
        idx = _torch_index(idx, self.shape, self.re.device)
        return Planar(self.re[idx], self.im[idx])

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, Planar):
            return Planar(self.re + other.re, self.im + other.im)
        return Planar(self.re + other, self.im)

    def __sub__(self, other):
        if isinstance(other, Planar):
            return Planar(self.re - other.re, self.im - other.im)
        return Planar(self.re - other, self.im)

    def __mul__(self, other):
        if isinstance(other, Planar):
            return Planar(self.re * other.re - self.im * other.im,
                          self.re * other.im + self.im * other.re)
        return Planar(self.re * other, self.im * other)

    def __rmul__(self, other):
        return self.__mul__(other)

    def conj(self):
        return Planar(self.re, -self.im)


@dataclasses.dataclass
class TlSpectrum(Planar):
    """The kept-intermediate-order spectrum: the ``keep_intermediate_order``
    forward result of ``FFTApplication`` on its kernels' lengths (the JAX
    package's ``TlSpectrum``, ``vkfft_tpu/pcomplex.py:84``; reference
    ``disableReorderFourStep``, ``vkFFT_Structs.h:221``).

    The planes hold the kernels' own layout.  1-D (``n2`` = 0): (*lead,
    n) lines in the swapped digit order of ``split`` = (n1, n2): bin k1 *
    n2 + k2 at k2 * n1 + k1 (natural where n2 = 1).  2-D pair (``n2`` > 0):
    (*lead, n2, n) transposed planes holding the natural 2-D spectrum of
    (n, n2) planes, as the JAX package's.  The round-trip contract rides
    the value: ``lead`` (the leading dims), ``batch`` (their product),
    ``n``/``n2`` (the transform lengths) and ``split``, so any application
    of the same configuration inverts it.  Elementwise arithmetic (a
    spectrum-domain table in the same layout, a scale) keeps the wrapper."""

    lead: tuple = ()
    batch: int = 0
    n: int = 0
    n2: int = 0
    split: tuple = ()

    def _like(self, p: Planar) -> "TlSpectrum":
        return TlSpectrum(p.re, p.im, self.lead, self.batch, self.n, self.n2,
                          self.split)

    def __add__(self, other):
        return self._like(Planar.__add__(self, other))

    def __sub__(self, other):
        return self._like(Planar.__sub__(self, other))

    def __mul__(self, other):
        return self._like(Planar.__mul__(self, other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def conj(self):
        return self._like(Planar.conj(self))

    def natural(self) -> Planar:
        """The spectrum in natural order: (*lead, n) lines, or (*lead, n,
        n2) planes of the 2-D pair."""
        if self.n2:
            return Planar(self.re.transpose(-1, -2).contiguous(),
                          self.im.transpose(-1, -2).contiguous())
        n1, n2 = self.split or (self.n, 1)
        return Planar(*(t.reshape(*self.lead, n2, n1).transpose(-1, -2)
                        .reshape(*self.lead, self.n)
                        for t in (self.re, self.im)))


def _torch_index(idx, shape, device):
    """A numpy-style index as torch takes it: integer arrays become index
    tensors on ``device``, and slices with a negative step (which torch
    refuses) become the index tensors of the positions they pick."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    named = sum(1 for e in idx if e is not None and e is not Ellipsis)
    out, d = [], 0
    for e in idx:
        if e is Ellipsis:
            d += len(shape) - named
        elif e is not None:
            if isinstance(e, slice) and e.step is not None and e.step < 0:
                e = np.arange(shape[d])[e]
            if isinstance(e, (np.ndarray, list)):
                e = torch.as_tensor(np.array(e), device=device)
            d += 1
        out.append(e)
    return tuple(out)


def from_complex(x, device=None) -> Planar:
    """Complex array -> planes.  A torch tensor keeps its own device and
    dtype; host input becomes float32 planes on ``device`` (CPU when None),
    the SINGLE precision of every configuration the port takes, as the JAX
    package narrows host input at its boundary (``vkfft_tpu/api.py:804-808``)."""
    if isinstance(x, Planar):
        return x
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return Planar(x.real.contiguous(), x.imag.contiguous())
        return Planar(x.contiguous(), torch.zeros_like(x))
    x = np.asarray(x)
    return from_numpy_planar(np.real(x).astype(np.float32),
                             np.imag(x).astype(np.float32), device)


def from_numpy_planar(re: np.ndarray, im: np.ndarray, device=None) -> Planar:
    """Host re/im planes -> a Planar on ``device`` (CPU when None): the form
    in which the tests hand the same seeded data to both packages."""
    if re.shape != im.shape or re.dtype != im.dtype:
        raise ValueError(f"planes differ: {re.shape}/{re.dtype} vs "
                         f"{im.shape}/{im.dtype}")
    return Planar(torch.from_numpy(np.ascontiguousarray(re)).to(device),
                  torch.from_numpy(np.ascontiguousarray(im)).to(device))


STORAGE_DTYPES = (torch.float16, torch.bfloat16)


def widened(p: Planar) -> Planar:
    """float16 / bfloat16 planes (the storage tiers) as float32 planes,
    exactly; other planes as they are."""
    return p.astype(torch.float32) if p.dtype in STORAGE_DTYPES else p


def to_complex(p: Planar) -> torch.Tensor:
    """Planes -> a complex torch tensor on the same device (complex64 for
    float16 / bfloat16 planes, which torch has no complex dtype of)."""
    p = widened(p)
    return torch.complex(p.re, p.im)


def to_numpy(p: Planar) -> np.ndarray:
    """Planes -> numpy complex on the host (complex64 for float16 /
    bfloat16 planes: numpy has no bfloat16)."""
    p = widened(p)
    r = p.re.detach().cpu().numpy()
    i = p.im.detach().cpu().numpy()
    dt = np.complex64 if r.dtype == np.float32 else np.complex128
    return (r + 1j * i).astype(dt)


def planar_table(tab: np.ndarray, dtype=torch.float32, device=None) -> Planar:
    """Host complex constant table -> planar tensors on ``device``."""
    return Planar(torch.as_tensor(np.real(tab), dtype=dtype, device=device),
                  torch.as_tensor(np.imag(tab), dtype=dtype, device=device))


def mul_i(p: Planar) -> Planar:
    """Multiply by +i: (a+bi)*i = -b + ai."""
    return Planar(-p.im, p.re)


def mul_neg_i(p: Planar) -> Planar:
    """Multiply by -i."""
    return Planar(p.im, -p.re)


def real_planar(x: torch.Tensor) -> Planar:
    """Wrap a real tensor as a planar complex with zero imaginary part."""
    return Planar(x, torch.zeros_like(x))
