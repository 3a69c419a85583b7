"""Plain execution engine: plan-driven mixed-radix FFT in torch tensor ops.

Port of the planar half of ``vkfft_tpu/ops/jnp_engine.py``.  It runs any
plan the planner makes (DIRECT, SPLIT, RADER, BLUESTEIN) on planes of any
float dtype, and is the engine `api` uses for CPU tensors.  It launches no
kernel of the port: it is the CPU path and the oracle the kernels are held
against.

Stockham recurrence (self-sorting, natural order in and out): with ``L`` =
product of processed radices, ``M`` = remaining length, one radix-``r``
stage maps ``A[l, j*Mp + m'] -> A'[i*L + l, m']`` via

    A'[i*L + l, m'] = sum_j w_r^(i*j) * w_M^(i*m') * A[l, j*Mp + m'],

i.e. reshape ``(B, L, r, Mp)``, contract the DFT matrix over ``j``, multiply
the ``(r, Mp)`` twiddle, merge ``(i, l)`` with ``i`` major (reference
staged Stockham loop, ``vkFFT_FFT.h:156-239``).
"""
from __future__ import annotations

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.ops.half_length import c2r_pack, r2c_untangle
from vkfft_tpu_torch.pcomplex import STORAGE_DTYPES, Planar, planar_table
from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import AxisPlan, plan_axis

# Calls of `fft_lines_p`, `rfft_lines_p` and `irfft_lines_p`, the functions
# every transform of this engine runs through: a run that must stay on the
# kernels reads it to show that the plain engine was not reached.  The
# kernels' plain versions enter below them (`lines_plain`,
# `rfft_lines_plain`, ...) and are not counted.
calls = 0


def apply_stages_p(x: Planar, plan: AxisPlan, tables) -> Planar:
    """Planar Stockham core over (B, core_n) planes.  Each stage contracts
    every line on its own, a batch of B (r, r) @ (r, L*Mp) products whose
    shapes do not depend on B, so a line's result is the same bits in any
    batch (one (r, r) @ (r, B*L*Mp) product, as an einsum makes it, rounds
    differently below a few lines); the distributed layer's chunked
    exchanges rely on it."""
    B = x.shape[0]
    dt, dev = x.dtype, x.device
    xr, xi = x.re, x.im

    def lines(d, z):   # (r, r) x (B, L, r, Mp) -> (B, r, L, Mp)
        return torch.matmul(d, z.transpose(1, 2).reshape(B, r, L * Mp))

    for stage, (D, tw) in zip(plan.stages, tables):
        r, L, Mp = stage.r, stage.L, stage.Mp
        d = planar_table(D, dt, dev)
        t = planar_table(tw, dt, dev)
        zr = xr.reshape(B, L, r, Mp)
        zi = xi.reshape(B, L, r, Mp)
        yr = (lines(d.re, zr) - lines(d.im, zi)).reshape(B, r, L, Mp)
        yi = (lines(d.re, zi) + lines(d.im, zr)).reshape(B, r, L, Mp)
        twr = t.re[None, :, None, :]
        twi = t.im[None, :, None, :]
        xr = (yr * twr - yi * twi).reshape(B, L * r, Mp)
        xi = (yr * twi + yi * twr).reshape(B, L * r, Mp)
    return Planar(xr.reshape(B, -1), xi.reshape(B, -1))


def _pad_tail_p(x: Planar, pad: int) -> Planar:
    if pad == 0:
        return x
    return Planar(torch.nn.functional.pad(x.re, (0, pad)),
                  torch.nn.functional.pad(x.im, (0, pad)))


def _swap(p: Planar, B: int, d1: int, d2: int) -> Planar:
    return Planar(p.re.reshape(B, d1, d2).transpose(1, 2),
                  p.im.reshape(B, d1, d2).transpose(1, 2))


def _fft_split_p(x: Planar, plan: AxisPlan, tabs, inverse: bool) -> Planar:
    """Cooley-Tukey split n = a*b, each factor planned on its own (runs
    Rader primes inline as stage factors, ``vkFFT_Scheduler.h:2303-2404``)."""
    a, b = plan.decomp.split
    B = x.shape[0]
    tw = planar_table(tabs["split_tw"], x.dtype, x.device)
    y = _swap(x, B, a, b).reshape(B * b, a)
    y = lines_plain(y, plan_axis(a), inverse).reshape(B, b, a)
    y = y * Planar(tw.re[None], tw.im[None])
    y = _swap(y, B, b, a).reshape(B * a, b)
    y = lines_plain(y, plan_axis(b), inverse).reshape(B, a, b)
    return _swap(y, B, a, b).reshape(B, a * b)


def _fft_bluestein_p(x: Planar, plan: AxisPlan, tabs) -> Planar:
    """Chirp-z: pad to a smooth M and convolve with the chirp in the
    frequency domain (``PrePostProcessing/vkFFT_Bluestein.h``)."""
    n = plan.n
    m = plan.decomp.bluestein_size
    a_t, b_t = tabs["bluestein"]
    a = planar_table(a_t, x.dtype, x.device)
    b_fft = planar_table(b_t, x.dtype, x.device)
    y = _pad_tail_p(x * a[None, :], m - n)
    Y = apply_stages_p(y, plan, tabs["stages"])
    y = apply_stages_p(Y * b_fft[None, :], plan, tabs["inv_stages"])
    y = y * (1.0 / m)
    return y[:, :n] * a[None, :]


def _fft_rader_p(x: Planar, plan: AxisPlan, tabs) -> Planar:
    """Forward Rader prime FFT via the length-(p-1) cyclic convolution
    (``vkFFT_RaderKernels.h:30``)."""
    p = plan.n
    perm, inv_perm, b_t = tabs["rader"]
    b_fft = planar_table(b_t, x.dtype, x.device)
    x0 = x[:, :1]
    X0 = Planar(x.re.sum(dim=1, keepdim=True), x.im.sum(dim=1, keepdim=True))
    idx = torch.as_tensor(perm, device=x.device)
    A = apply_stages_p(x[:, idx], plan, tabs["stages"])
    c = apply_stages_p(A * b_fft[None, :], plan, tabs["inv_stages"])
    val = x0 + c * (1.0 / (p - 1))
    # out[:, inv_perm[k]] = val[:, k] as a gather: inv_perm hits every
    # position 1..p-1 once
    order = torch.as_tensor(np.argsort(inv_perm), device=x.device)
    return Planar(torch.cat([X0.re, val.re[:, order]], dim=1),
                  torch.cat([X0.im, val.im[:, order]], dim=1))


def fft_lines_p(x: Planar, plan: AxisPlan, inverse: bool = False,
                scale: float = 1.0) -> Planar:
    """Planar DFT over the last axis of (B, n) planes, scaled by ``scale``
    (unnormalized at the default).  bf16/f16 planes are storage-only tiers:
    every stage and the scale compute in fp32 and the result is cast back
    once a pass."""
    global calls
    calls += 1
    return lines_plain(x, plan, inverse, scale)


def lines_plain(x: Planar, plan: AxisPlan, inverse: bool = False,
                scale: float = 1.0) -> Planar:
    """`fft_lines_p` without the call count: the plain versions of the CUDA
    kernels (`cuda_kernels`) run through here.  bf16/f16 planes are
    widened to fp32 for the whole pass, the scale included, and narrowed
    once at its end, as the kernels' half-storage instantiations do."""
    if x.dtype in STORAGE_DTYPES:
        y = lines_plain(x.astype(torch.float32), plan, inverse, scale)
        return y.astype(x.dtype)
    if scale != 1.0:
        return lines_plain(x, plan, inverse) * scale
    if plan.n == 1:
        return x
    tabs = luts.axis_tables(plan, inverse)
    alg = plan.algorithm
    if alg is Algorithm.SPLIT:
        return _fft_split_p(x, plan, tabs, inverse)
    if alg is Algorithm.DIRECT:
        return apply_stages_p(x, plan, tabs["stages"])
    if alg is Algorithm.BLUESTEIN:
        return _fft_bluestein_p(x, plan, tabs)
    if inverse:  # RADER: the inverse by conjugation
        return lines_plain(x.conj(), plan, False).conj()
    return _fft_rader_p(x, plan, tabs)


# ---------------------------------------------------------------------------
# Real transforms of even n as a half-size complex FFT (``r2c.py:168-182``
# and ``:224-235`` of the JAX package, reference ``vkFFT_Plan_R2C.h:30``):
# z[j] = x[2j] + i x[2j+1] runs an m = n/2 point C2C, then the untangle
# E = (Z[k] + conj Z[m-k])/2, O = -i (Z[k] - conj Z[m-k])/2,
# X[k] = E + w_n^k O.  These are the plain versions of the CUDA kernels
# `fft_r2c`/`fft_c2r` and `fft_r2c_pair` and run under `lines_plain`, so they
# do not count in `calls`; `rfft_lines_p`/`irfft_lines_p` below are the
# engine's counted entry points.  The untangle and the packing are
# elementwise and live in `half_length`, which the CUDA engine's
# half-length route imports too.
# ---------------------------------------------------------------------------

def rfft_lines_plain(x: torch.Tensor, packed: bool = False) -> Planar:
    """Half spectrum of real (B, n) lines, n even and >= 4, as
    `r2c_untangle` gives it (float16 / bfloat16 lines: the C2C at their
    dtype, the untangle in fp32, float32 planes out)."""
    n = x.shape[1]
    Z = lines_plain(Planar(x[:, 0::2], x[:, 1::2]), plan_axis(n // 2))
    return r2c_untangle(Z, n, packed)


def irfft_lines_plain(X: Planar, n: int, scale: float = 1.0,
                      packed: bool = False) -> torch.Tensor:
    """Real (B, n) lines from their (B, n/2+1) half spectrum (or the
    ``packed`` (B, n/2) form), scaled by (n/2)*``scale``: ``scale=2/n``
    gives numpy ``irfft``.  Im(DC) and Im(Nyquist) are ignored, as numpy
    ignores them; a float16 / bfloat16 spectrum runs widened, to float32
    lines (`c2r_pack`)."""
    z = lines_plain(c2r_pack(X, n, packed), plan_axis(n // 2), True, scale)
    return torch.stack([z.re, z.im], -1).reshape(-1, n)


def _lines_along_y(x: Planar, inverse: bool, scale: float = 1.0) -> Planar:
    """`lines_plain` along the middle axis of (B, ny, nz) planes."""
    B, ny, nz = x.shape
    t = Planar(x.re.transpose(1, 2).reshape(B * nz, ny),
               x.im.transpose(1, 2).reshape(B * nz, ny))
    y = lines_plain(t, plan_axis(ny), inverse, scale)
    return Planar(y.re.reshape(B, nz, ny).transpose(1, 2).contiguous(),
                  y.im.reshape(B, nz, ny).transpose(1, 2).contiguous())


def rfft2_pair_plain(x: torch.Tensor) -> Planar:
    """numpy ``rfft2`` of real (B, ny, nz) planes, nz even and >= 4: the
    real transform along z, then the complex one along y."""
    B, ny, nz = x.shape
    X = rfft_lines_plain(x.reshape(B * ny, nz)).reshape(B, ny, nz // 2 + 1)
    return _lines_along_y(X, False)


def irfft2_pair_plain(X: Planar, nz: int, scale_y: float = 1.0,
                      scale_z: float = 1.0) -> torch.Tensor:
    """Real (B, ny, nz) planes from their (B, ny, nz/2+1) half spectrum,
    scaled by ny*``scale_y`` * (nz/2)*``scale_z``: the complex inverse
    along y, then the real one along z (``scale_y=1/ny``,
    ``scale_z=2/nz`` give numpy ``irfft2``)."""
    B, ny, h = X.shape
    Y = _lines_along_y(X, True, scale_y).reshape(B * ny, h)
    return irfft_lines_plain(Y, nz, scale_z).reshape(B, ny, nz)


def rfft_lines_p(x: torch.Tensor) -> Planar:
    """The engine's real transform of (B, n) lines, n even and >= 4, to
    the numpy (B, n/2+1) half spectrum."""
    global calls
    calls += 1
    return rfft_lines_plain(x)


def irfft_lines_p(X: Planar, n: int, scale: float = 1.0) -> torch.Tensor:
    """The engine's inverse real transform of (B, n/2+1) half spectra to
    (B, n) lines, n even and >= 4, scaled by (n/2)*``scale``."""
    global calls
    calls += 1
    return irfft_lines_plain(X, n, scale)


def fft_axis_p(x: Planar, axis: int, plan: AxisPlan, inverse: bool = False,
               scale: float = 1.0, donate: bool = False, in_keep: int = 0,
               out_keep: int = 0) -> Planar:
    """Planar DFT along ``axis`` of N-D planes, scaled by ``scale``.
    ``donate`` is accepted for engine-interface parity; this engine never
    writes in place.  ``in_keep``/``out_keep`` honour the declared-zero
    window contract as a mask / an output slice."""
    del donate
    axis = axis % x.ndim
    if x.shape[axis] != plan.n:
        raise ValueError(
            f"axis {axis} has length {x.shape[axis]}, plan is for {plan.n}")
    if in_keep:
        shp = [1] * x.ndim
        shp[axis] = plan.n
        m = (torch.arange(plan.n, device=x.device) < in_keep).reshape(shp)
        x = Planar(torch.where(m, x.re, 0.0), torch.where(m, x.im, 0.0))
    if out_keep:
        y = fft_axis_p(x, axis, plan, inverse, scale=scale)
        return Planar(y.re.narrow(axis, 0, out_keep),
                      y.im.narrow(axis, 0, out_keep))
    moved = axis != x.ndim - 1
    if moved:
        x = Planar(x.re.movedim(axis, -1), x.im.movedim(axis, -1))
    shape = x.shape
    y = fft_lines_p(x.reshape(-1, plan.n), plan, inverse,
                    scale=scale).reshape(*shape)
    if moved:
        y = Planar(y.re.movedim(-1, axis), y.im.movedim(-1, axis))
    return y
