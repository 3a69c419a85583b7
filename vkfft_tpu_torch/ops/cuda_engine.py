"""CUDA execution engine: the dispatch half of
``vkfft_tpu/ops/pallas_engine.py`` on the port's kernels.

Routing is the port's own (none of the TPU's lane-tile gates): a DIRECT
line length in the kernels' range runs `cuda_kernels.fft_lines` along the
minor axis and `cuda_kernels.fft_strided` along any other axis, in place on
the (P, n, S) view, with no transposes.  The two minor axes together run
`cuda_kernels.fft_pair` in one pass when `pair_supports` finds a cluster
for their plane.  Lengths n <= 4 on the minor axis run as plain tensor
butterflies, as ``pallas_engine._tiny_dft_p`` does.  Real lines of even
length run `cuda_kernels.fft_r2c`/`fft_c2r` where `r2c_supports` holds, and
the two minor axes of real data `cuda_kernels.fft_r2c_pair` where
`r2c_pair_supports` finds a cluster for their plane.

Everything else raises ``NotImplementedError`` naming its ROADMAP item:
Rader, Bluestein, SPLIT (the planner splits only around a Rader prime),
DIRECT lengths with a prime factor above 64 or above 8192, dtypes other
than float32 and zero-pad keeps.  Nothing here falls back to the plain
engine.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from vkfft_tpu_torch.ops import cuda_kernels as ck
from vkfft_tpu_torch.pcomplex import Planar
from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import AxisPlan, plan_axis


def supports(plan: AxisPlan) -> bool:
    """Whether this engine runs the plan (on the minor axis)."""
    if plan.n <= 4:
        return True
    return plan.algorithm is Algorithm.DIRECT and ck.kernel_supports(plan.n)


def pair_supports(ny: int, nz: int) -> bool:
    """Whether `fft_pair_p` runs a (ny, nz) plane in one kernel pass."""
    return (plan_axis(ny).algorithm is Algorithm.DIRECT
            and plan_axis(nz).algorithm is Algorithm.DIRECT
            and ck.pair_cluster(ny, nz) is not None)


r2c_supports = ck.r2c_supports


def r2c_pair_supports(ny: int, nz: int) -> bool:
    """Whether `rfft_pair_p`/`irfft_pair_p` run real (ny, nz) planes in one
    kernel pass."""
    return ck.r2c_pair_cluster(ny, nz) is not None


def _check_plan(plan: AxisPlan) -> None:
    if supports(plan):
        return
    alg = plan.algorithm
    what = {Algorithm.RADER: "Rader", Algorithm.BLUESTEIN: "Bluestein",
            Algorithm.DIRECT: "DIRECT", Algorithm.SPLIT: "SPLIT"}[alg]
    raise NotImplementedError(
        f"{what} plan for n={plan.n} is not on the CUDA engine yet: "
        "ROADMAP queue 1 item 6 (kernels: queue 2)")


def _check_dtype(x) -> None:
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"CUDA engine runs float32 planes; {x.dtype} is ROADMAP queue 1 "
            "item 10")


def core_fft_planar(xr: torch.Tensor, xi: torch.Tensor, n: int,
                    inverse: bool, donate: bool = False, scale: float = 1.0):
    """DFT of contiguous (B, n) planes through the lines kernel, scaled by
    ``scale`` in the kernel; ``donate`` writes over the input planes."""
    if xr.shape[-1] != n:
        raise ValueError(f"planes have length {xr.shape[-1]}, not {n}")
    return ck.fft_lines(xr, xi, inverse, scale,
                        out=(xr, xi) if donate else None)


def _tiny_dft_p(x: Planar, n: int, inverse: bool, scale: float) -> Planar:
    """n <= 4 DFT as plain elementwise tensor ops on (B, n) planes."""
    cols = [x[:, i:i + 1] for i in range(n)]
    if n == 2:
        a, b = cols
        out = [a + b, a - b]
    elif n == 3:
        a, b, c = cols
        w = np.exp((2j if inverse else -2j) * np.pi / 3)
        bc_s, bc_d = b + c, b - c
        t1 = a + bc_s * float(w.real)
        ti = float(w.imag)
        rot = Planar(-bc_d.im * ti, bc_d.re * ti)
        out = [a + bc_s, t1 + rot, t1 - rot]
    else:  # n == 4
        a, b, c, d = cols
        t0, t1 = a + c, a - c
        t2, t3 = b + d, b - d
        i3 = Planar(t3.im, -t3.re) if not inverse else Planar(-t3.im, t3.re)
        out = [t0 + t2, t1 + i3, t0 - t2, t1 - i3]
    y = Planar(torch.cat([o.re for o in out], dim=1),
               torch.cat([o.im for o in out], dim=1))
    return y * scale if scale != 1.0 else y


def fft_lines_p(x: Planar, plan: AxisPlan, inverse: bool = False,
                donate: bool = False, scale: float = 1.0) -> Planar:
    """Planar DFT over (B, n) planes, scaled by ``scale`` in the kernel.
    ``donate=True`` lets a DIRECT plan overwrite the caller's planes."""
    _check_dtype(x)
    n = plan.n
    if n == 1:
        return x * scale if scale != 1.0 else x
    if n <= 4:
        return _tiny_dft_p(x, n, inverse, scale)
    _check_plan(plan)
    x = x.contiguous()
    rr, ii = core_fft_planar(x.re, x.im, n, inverse, donate=donate,
                             scale=scale)
    return Planar(rr, ii)


def fft_axis_p(x: Planar, axis: int, plan: AxisPlan, inverse: bool = False,
               donate: bool = False, scale: float = 1.0, in_keep: int = 0,
               out_keep: int = 0) -> Planar:
    """Planar DFT along ``axis`` of N-D planes, scaled by ``scale``.  The
    minor axis runs the lines kernel on the (-1, n) view; any other axis
    runs the strided kernel on the (P, n, S) view.  ``donate=True`` lets
    the kernel write over the caller's planes (dead intermediates of an N-D
    walk)."""
    axis = axis % x.ndim
    if x.shape[axis] != plan.n:
        raise ValueError(
            f"axis {axis} has length {x.shape[axis]}, plan is for {plan.n}")
    _check_dtype(x)
    if in_keep or out_keep:
        raise NotImplementedError(
            "zero-pad keeps on the CUDA engine are ROADMAP queue 1 item 8")
    n = plan.n
    if n == 1:
        return x * scale if scale != 1.0 else x
    shape = x.shape
    if axis == x.ndim - 1:
        y = fft_lines_p(x.reshape(-1, n), plan, inverse, donate=donate,
                        scale=scale)
        return y.reshape(*shape)
    _check_plan(plan)
    x = x.contiguous()
    P = math.prod(shape[:axis])
    S = math.prod(shape[axis + 1:])
    xr = x.re.reshape(P, n, S)
    xi = x.im.reshape(P, n, S)
    rr, ii = ck.fft_strided(xr, xi, inverse, scale,
                            out=(xr, xi) if donate else None)
    return Planar(rr.reshape(shape), ii.reshape(shape))


def fft_pair_p(x: Planar, ny: int, nz: int, inverse: bool = False,
               donate: bool = False, scale: float = 1.0) -> Planar:
    """Planar 2-D DFT over the two minor axes (..., ny, nz) in one kernel
    pass, scaled by ``scale``; ``donate`` as for `fft_axis_p`."""
    _check_dtype(x)
    shape = x.shape
    if shape[-2:] != (ny, nz):
        raise ValueError(f"minor axes are {shape[-2:]}, not {(ny, nz)}")
    x = x.contiguous()
    xr = x.re.reshape(-1, ny, nz)
    xi = x.im.reshape(-1, ny, nz)
    rr, ii = ck.fft_pair(xr, xi, inverse, scale,
                         out=(xr, xi) if donate else None)
    return Planar(rr.reshape(shape), ii.reshape(shape))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous real tensor the real kernels can read as float2 pairs
    (a view may start at an odd float)."""
    x = x.contiguous()
    return x if x.data_ptr() % 8 == 0 else x.clone()


def rfft_lines_p(x: torch.Tensor) -> Planar:
    """numpy ``rfft`` (B, n/2+1) half spectrum of real (B, n) lines, n
    even, through `fft_r2c`."""
    _check_dtype(x)
    return Planar(*ck.fft_r2c(_aligned(x)))


def irfft_lines_p(X: Planar, n: int, scale: float = 1.0) -> torch.Tensor:
    """Real (B, n) lines from their (B, n/2+1) half spectrum through
    `fft_c2r`, scaled by (n/2)*``scale``."""
    _check_dtype(X)
    X = X.contiguous()
    return ck.fft_c2r(X.re, X.im, n, scale)


def rfft_pair_p(x: torch.Tensor) -> Planar:
    """numpy ``rfft2`` over the two minor axes of real (..., ny, nz) data
    in one `fft_r2c_pair` pass."""
    _check_dtype(x)
    *lead, ny, nz = x.shape
    yr, yi = ck.fft_r2c_pair(_aligned(x).reshape(-1, ny, nz))
    h = nz // 2 + 1
    return Planar(yr.reshape(*lead, ny, h), yi.reshape(*lead, ny, h))


def irfft_pair_p(X: Planar, nz: int, scale_y: float = 1.0,
                 scale_z: float = 1.0) -> torch.Tensor:
    """Real (..., ny, nz) data from the half spectrum of its two minor
    axes in one `fft_c2r_pair` pass, scaled by ny*``scale_y`` *
    (nz/2)*``scale_z``."""
    _check_dtype(X)
    *lead, ny, h = X.shape
    X = X.contiguous()
    y = ck.fft_c2r_pair(X.re.reshape(-1, ny, h), X.im.reshape(-1, ny, h),
                        nz, scale_y, scale_z)
    return y.reshape(*lead, ny, nz)
