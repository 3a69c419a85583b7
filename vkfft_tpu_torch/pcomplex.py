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
        return Planar(self.re.to(dtype), self.im.to(dtype))

    def reshape(self, *shape):
        return Planar(self.re.reshape(*shape), self.im.reshape(*shape))

    def contiguous(self):
        return Planar(self.re.contiguous(), self.im.contiguous())

    def __getitem__(self, idx):
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


def from_complex(x, device=None) -> Planar:
    """Complex array -> planes.  numpy input is placed on ``device`` (CPU
    when None); a torch tensor keeps its own device."""
    if isinstance(x, Planar):
        return x
    if isinstance(x, torch.Tensor):
        if x.is_complex():
            return Planar(x.real.contiguous(), x.imag.contiguous())
        return Planar(x.contiguous(), torch.zeros_like(x))
    x = np.asarray(x)
    if not np.iscomplexobj(x):
        x = x.astype(np.complex64 if x.dtype != np.float64 else np.complex128)
    dt = np.float32 if x.dtype == np.complex64 else np.float64
    return from_numpy_planar(x.real.astype(dt), x.imag.astype(dt), device)


def from_numpy_planar(re: np.ndarray, im: np.ndarray, device=None) -> Planar:
    """Host re/im planes -> a Planar on ``device`` (CPU when None): the form
    in which the tests hand the same seeded data to both packages."""
    if re.shape != im.shape or re.dtype != im.dtype:
        raise ValueError(f"planes differ: {re.shape}/{re.dtype} vs "
                         f"{im.shape}/{im.dtype}")
    return Planar(torch.from_numpy(np.ascontiguousarray(re)).to(device),
                  torch.from_numpy(np.ascontiguousarray(im)).to(device))


def to_complex(p: Planar) -> torch.Tensor:
    """Planes -> a complex torch tensor on the same device."""
    return torch.complex(p.re, p.im)


def to_numpy(p: Planar) -> np.ndarray:
    """Planes -> numpy complex on the host."""
    r = p.re.detach().cpu().numpy()
    i = p.im.detach().cpu().numpy()
    dt = np.complex64 if r.dtype == np.float32 else np.complex128
    return (r + 1j * i).astype(dt)


def planar_table(tab: np.ndarray, dtype=torch.float32, device=None) -> Planar:
    """Host complex constant table -> planar tensors on ``device``."""
    return Planar(torch.as_tensor(np.real(tab), dtype=dtype, device=device),
                  torch.as_tensor(np.imag(tab), dtype=dtype, device=device))
