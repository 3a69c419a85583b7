"""The elementwise halves of a real transform of even length n run as an
n/2-point complex one (``vkfft_tpu/transforms/r2c.py:167-182`` and
``:223-235``, reference ``vkFFT_Plan_R2C.h:30``): z[j] = x[2j] + i x[2j+1]
runs an m = n/2 point C2C, then the untangle E = (Z[k] + conj Z[m-k])/2,
O = -i (Z[k] - conj Z[m-k])/2, X[k] = E + w_n^k O; the inverse packs the
half spectrum back into the m-point spectrum of z.

Both engines import these: the CUDA engine around its n/2-point C2C on the
card (where `fft_r2c` does not take n), the plain engine around its own.
Tensor ops only, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.pcomplex import Planar, mul_i, mul_neg_i, planar_table


def r2c_untangle(Z: Planar, n: int, packed: bool = False) -> Planar:
    """The half spectrum of real lines of even length n from Z, the n/2-point
    DFT of z[j] = x[2j] + i x[2j+1]: numpy ``rfft`` values as (B, n/2+1)
    planes with Im(DC) = Im(Nyquist) = 0, or with ``packed`` (B, n/2) planes
    holding the real Nyquist bin in Im(bin 0).  Elementwise tensor ops, no
    FFT."""
    m = n // 2
    Zk = Z[:, np.arange(m + 1) % m]
    Zr = Z[:, (-np.arange(m + 1)) % m].conj()
    E = (Zk + Zr) * 0.5
    O = mul_neg_i((Zk - Zr) * 0.5)
    X = E + planar_table(luts.r2c_post_twiddle(n), Z.dtype, Z.device)[None] * O
    if packed:
        return Planar(X.re[:, :m].contiguous(),
                      torch.cat([X.re[:, m:], X.im[:, 1:m]], 1))
    zero = X.im[:, :1] * 0
    return Planar(X.re, torch.cat([zero, X.im[:, 1:m], zero], 1))


def c2r_pack(X: Planar, n: int, packed: bool = False) -> Planar:
    """The (B, n/2) spectrum whose n/2-point inverse DFT z gives real lines
    of even length n as x[2j] = Re z[j], x[2j+1] = Im z[j], from their
    (B, n/2+1) half spectrum (or the ``packed`` (B, n/2) form); Im(DC) and
    Im(Nyquist) are ignored, as numpy ignores them.  Elementwise tensor ops,
    no FFT."""
    m = n // 2
    dc = X.re[:, :1]
    nyq = X.im[:, :1] if packed else X.re[:, m:m + 1]
    zero = dc * 0
    F = Planar(torch.cat([dc, X.re[:, 1:m], nyq], 1),
               torch.cat([zero, X.im[:, 1:m], zero], 1))
    Xk = F[:, :m]
    Xr = F[:, m - np.arange(m)].conj()
    E = (Xk + Xr) * 0.5
    tw = planar_table(np.conj(luts.r2c_post_twiddle(n))[:m], X.dtype, X.device)
    O = tw[None] * ((Xk - Xr) * 0.5)
    return E + mul_i(O)
