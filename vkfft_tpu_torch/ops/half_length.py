"""The elementwise halves of a real transform of even length n run as an
n/2-point complex one (``vkfft_tpu/transforms/r2c.py:167-182`` and
``:223-235``, reference ``vkFFT_Plan_R2C.h:30``): z[j] = x[2j] + i x[2j+1]
runs an m = n/2 point C2C, then the untangle E = (Z[k] + conj Z[m-k])/2,
O = -i (Z[k] - conj Z[m-k])/2, X[k] = E + w_n^k O; the inverse packs the
half spectrum back into the m-point spectrum of z.

Both engines import these: the CUDA engine around its n/2-point C2C on the
card (where `fft_r2c` does not take n, and for every float16 / bfloat16
line), the plain engine around its own.  Tensor ops only, on any device.
Both compute in fp32 on half planes and return float32 planes: the JAX
package's untangle and packing promote a half spectrum to float32
(``np.float32(0.5)``, ``vkfft_tpu/transforms/r2c.py:173-182`` and
``:236-246``), so its half real transforms return float32.
"""
from __future__ import annotations

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.pcomplex import Planar

# Device copies of the mirror index and the combination tables, per
# (n, inverse, dtype, device): no call copies from the host.
_TABLES: dict = {}


def _tables(n: int, inverse: bool, dtype: torch.dtype, device):
    """(the index (m-k) mod m, A, B) for k < m = n/2, with the untangle
    X[k] = A[k] Z[k] + B[k] conj Z[m-k], A = (1 - i w)/2, B = (1 + i w)/2,
    w = w_n^k; the packing's F[k] = A X[k] + B conj X[m-k] takes conj w and
    the opposite signs.  A and B as the planes (Ar, Ai, -Ai, Br, Bi, -Br)."""
    key = (n, inverse, dtype, str(device))
    tab = _TABLES.get(key)
    if tab is None:
        m = n // 2
        w = luts.r2c_post_twiddle(n)[:m]
        if inverse:
            w = -np.conj(w)
        a, b = (1 - 1j * w) / 2, (1 + 1j * w) / 2
        planes = np.stack([a.real, a.imag, -a.imag, b.real, b.imag, -b.real])
        tab = (torch.as_tensor((-np.arange(m)) % m, device=device),
               torch.as_tensor(planes, dtype=dtype, device=device).unbind(0))
        _TABLES[key] = tab
    return tab


def _mirror_sum(P: Planar, n: int, inverse: bool, re: torch.Tensor,
                im: torch.Tensor) -> None:
    """re + i im = A P[k] + B conj P[(m-k) mod m] for k < m = n/2, in place
    in the (B, m) views ``re``/``im`` at their dtype (float16 / bfloat16
    P is read as it is and computed wider)."""
    idx, (ar, ai, nai, br, bi, nbr) = _tables(n, inverse, re.dtype,
                                              re.device)
    pr, pi = P.re[:, :n // 2], P.im[:, :n // 2]
    qr, qi = pr.index_select(1, idx), pi.index_select(1, idx)
    torch.mul(pr, ar, out=re)
    re.addcmul_(pi, nai).addcmul_(qr, br).addcmul_(qi, bi)
    torch.mul(pr, ai, out=im)
    im.addcmul_(pi, ar).addcmul_(qr, bi).addcmul_(qi, nbr)


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def r2c_untangle(Z: Planar, n: int, packed: bool = False) -> Planar:
    """The half spectrum of real lines of even length n from Z, the n/2-point
    DFT of z[j] = x[2j] + i x[2j+1]: numpy ``rfft`` values as (B, n/2+1)
    planes with Im(DC) = Im(Nyquist) = 0, or with ``packed`` (B, n/2) planes
    holding the real Nyquist bin in Im(bin 0).  Elementwise tensor ops, no
    FFT; a float16 / bfloat16 Z is computed in fp32 and the half spectrum
    comes back as float32 planes."""
    m = n // 2
    w = m if packed else m + 1
    re = torch.empty(Z.shape[0], w, dtype=_wide(Z.dtype), device=Z.device)
    im = torch.empty_like(re)
    _mirror_sum(Z, n, False, re[:, :m], im[:, :m])
    # bins 0 and m: Re Z[0] +- Im Z[0], real
    z0r, z0i = Z.re[:, 0].to(re.dtype), Z.im[:, 0].to(re.dtype)
    re[:, 0] = z0r + z0i
    if packed:
        im[:, 0] = z0r - z0i
    else:
        re[:, m] = z0r - z0i
        im[:, 0] = 0
        im[:, m] = 0
    return Planar(re, im)


def c2r_pack(X: Planar, n: int, packed: bool = False) -> Planar:
    """The (B, n/2) spectrum whose n/2-point inverse DFT z gives real lines
    of even length n as x[2j] = Re z[j], x[2j+1] = Im z[j], from their
    (B, n/2+1) half spectrum (or the ``packed`` (B, n/2) form); Im(DC) and
    Im(Nyquist) are ignored, as numpy ignores them.  Elementwise tensor ops,
    no FFT; a float16 / bfloat16 X is computed in fp32 and the spectrum
    comes back as float32 planes, for an inverse in fp32."""
    m = n // 2
    re = torch.empty(X.shape[0], m, dtype=_wide(X.dtype), device=X.device)
    im = torch.empty_like(re)
    _mirror_sum(X, n, True, re, im)
    # bin 0 from the real DC and Nyquist: F[0] = A[0] dc + B[0] nyq
    _, (ar, ai, _, br, bi, _) = _tables(n, True, re.dtype, re.device)
    dc = X.re[:, 0].to(re.dtype)
    nyq = (X.im[:, 0] if packed else X.re[:, m]).to(re.dtype)
    re[:, 0] = dc * ar[0] + nyq * br[0]
    im[:, 0] = dc * ai[0] + nyq * bi[0]
    return Planar(re, im)
