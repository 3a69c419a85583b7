"""CUDA execution engine: the dispatch half of
``vkfft_tpu/ops/pallas_engine.py`` on the port's kernels.

Routing is the port's own (none of the TPU's lane-tile gates), in the JAX
package's order of tiers (``pallas_engine.fft_lines_p``, l.613-725):

* DIRECT: `cuda_kernels.fft_lines` where its stages take n (n <= 8192,
  primes <= 64), else `cuda_kernels.fft_twofactor` (n <= 16384, primes <=
  127), along the minor axis; along any other axis `fft_strided` in place
  on the (P, n, S) view where the stages take n, else the lines of the
  axis moved last.  The two minor axes together run `fft_pair` in one pass
  when `pair_supports` finds a cluster for their plane.  Lengths n <= 4 run
  as plain tensor butterflies, as ``pallas_engine._tiny_dft_p`` does.
* RADER (prime p): the gather x[:, perm], then `fft_conv` where its stages
  take p-1, else `fft_twofactor` (swapped order) and `fft_conv_inv` with
  the x0 term fused into its store; the DC sum and the output gather are
  tensor ops.  The inverse goes by conjugation, as in JAX.
* BLUESTEIN (padded length m): `fft_conv` in its Bluestein mode where its
  stages take m, else `fft_conv_pair` where `conv_pair_plan` finds a
  cluster plane for m, else chirp and pad as tensor ops, `fft_twofactor`
  (swapped) and `fft_conv_inv`, crop and chirp (m <= 16384); beyond, the
  fused long Bluestein where m = nc*ns has ns-point lines `fft_conv` takes
  (`bluestein_long_split`): `fft_strided_tw` reading the (B, n) line as
  the first n points of its (nc, ns) plane with the chirp on the read and
  the four-step twiddle on the write, `fft_conv`'s rows mode on the ns
  lines, and `fft_strided_tw` with the conjugate twiddle on the read and
  the chirp on the write of the first n points; else the chirp and the pad
  as tensor ops around the long DIRECT routes of m in the swapped order,
  with the spectrum multiply between them as a tensor op.
* SPLIT (n = a*b around a Rader prime): the two factors' lines with the
  swaps and the twiddle multiply as tensor ops, as in JAX.
* The long tier (DIRECT n > 16384; ``pallas_engine.py:4218-4418``): two
  uploads n = nc*ns (powers of two to 2^23), the strided nc pass in
  `fft_strided_tw` with w_n^(kc*js) on its write, which stores its tile
  transposed, (js, kc), then `fft_strided` over the ns rows of that
  layout, whose output is the natural order: the (kc, ks) -> (ks, kc)
  reorder rides the first pass's store, as the JAX package's ``tl``
  stage writes it (``pallas_engine.py:4242-4252``).  Or, where
  `long_split`'s cost model (fitted to an H100's pass times) prefers it,
  three uploads n = na*nb*ns, three `fft_strided_tw` passes: na with
  w_(na*nb)^(ka*jb) on its write, stored transposed as (jb, js, ka); nb
  over the (js, ka) columns with w_n^((kb*na + ka)*js) on its write; ns
  over the ka columns of the planes (b, kb), written interleaved as (ks,
  kb, ka), the natural order.  Where the last pass's tile holds fewer
  than 8 columns or no kernel of its kind takes ns (`ck.long_folds`: two
  uploads at ns = 4096 or 8192, 2^21 to 2^23, or ns outside `fft_strided`;
  three at na < 8, ns = 4096 (2^30) or ns outside `fft_strided_tw`), the
  ns pass runs on contiguous lines (`fft_lines` or
  `fft_twofactor`; three uploads' second pass then writes its planes
  interleaved so kc comes out in natural order) and the reorder is a
  tensor op, as in the JAX package where ``tl_ok`` fails; the swapped
  order of the composed Bluestein runs those passes too.  The inverse
  mirrors each with the conjugate twiddles on the strided reads.  The
  twiddles and chirps are computed in the kernel from their exact integer
  exponents: no O(n) table exists.  Rader's p - 1 never reaches it (p <=
  10007).

`route(plan)` makes that choice for the minor axis in one place, in the
forward's launch order: the dispatch below runs what it names, and the
smoke run's kernel sweeps and the launch tests enumerate from it.  Along a
non-minor axis a length outside `fft_strided`'s stages is moved last and
runs its `route` (``pallas_engine.py:817-827``).

Real lines of even length run `fft_r2c`/`fft_c2r` where `r2c_supports`
holds, and otherwise the half-length route of the JAX package's
``transforms/r2c.py:167-182`` and ``:223-235``: the n/2-point C2C on the
card between tensor-op packing and untangling; the two minor axes of real
data run `fft_r2c_pair` where `r2c_pair_supports` finds a cluster.  Real
float16 / bfloat16 lines take the half-length route at every even n: the
n/2-point C2C on the half instantiations, then the untangle in fp32, so
the half spectrum comes back as float32 planes, as the JAX package's
untangle promotes it; a half spectrum is widened and inverted in fp32
(`fft_c2r` where `r2c_supports` holds), as the JAX package packs it.

Real-to-real lines (DCT/DST types I-IV) run `fft_dct23`, `fft_dct1` or
`fft_dct4` where `r2r_route` names one; elsewhere `transforms/r2r.py` runs
the JAX package's composition (extensions, Makhoul's permutation, the
DCT-IV tricks) onto the real and complex routes above, on the card.

Convolution (`transforms/conv.py`): `conv_fused_v3`, `conv_fused_v3_rows`,
`conv_fused_v3_matrix`, `conv_fused_pair` and `conv_fused_planar`, the
counterparts of the JAX package's fused entry points, run a whole
circular convolution of the minor axis (or the minor pair) in one
`fft_conv` or `fft_conv_pair` launch, or in `fft_twofactor` +
`fft_conv_inv`; `conv_route(config, ...)` names the one a config runs.

float64 planes run the fp64 instantiations of `fft_lines`, `fft_strided`
and `fft_pair` wherever every axis of the call is one of theirs
(`f64_axis_supports`: n <= 4 as tensor ops, else DIRECT with the stages'
lengths; `f64_supports` for a whole configuration, the one rule the API's
DOUBLE route reads); no other route has fp64 kernels yet.

float16 and bfloat16 planes (the storage tiers: half the bytes, fp32
arithmetic) run every C2C route above, the real transforms' C2C and every
fused convolution mode on the half-storage instantiations of its kernels
(`ck.STORAGE_KERNELS`; `storage_axis_supports` holds wherever `supports`
does, n <= 4 as tensor ops widened to fp32).  The glue
between the kernels (Rader's DC sum and x0 terms, SPLIT's twiddle, the
Bluestein chirps and spectrum of the composed routes) computes in fp32
and narrows once to the planes' dtype, so every launch stays on the half
instantiations.  The inverse of the long tier on half planes scales each
upload by its own factor's 1/n_k (the rest of the caller's scale on the
last), as SPLIT's inverse does its first factor, so no unnormalized
intermediate leaves float16's range; fp32 keeps the whole scale on the
last pass.

Zero-pad windows (the API's elided routes): `fft_lines_p` takes the
reference's ``in_nonzero``/``in_window``/``out_keep``/``out_fill``/
``out_zero_window`` on DIRECT plans of `fft_lines` and `fft_twofactor`
(`window_kernel`), `fft_axis_p` prefix keeps (`axis_window`: the windowed
lines entry on the minor axis, the windowed `fft_strided` on any other
DIRECT axis of its lengths), `fft_pair_p` (ky, kz) corners; each reads a
corner of wider planes in place through its strides (planes of two
layouts, or whose last dim is not contiguous, are copied first:
`_one_layout`), and off those kernels honours the window with a mask and
a slice (``pallas_engine.fft_axis_p``'s contract).
`fft_conv_pair`'s 2-D mode takes the (ky, kz) / (oy, oz) corners of the
"pair" fusion mode (`conv_fused_pair`'s ``in_keep`` / ``out_keep``).
Bluestein's read window (`read_window`: a kept input prefix of a Bluestein
plan's lines) runs the windowed entries of `fft_conv`, `fft_conv_pair` and
the long tier's first `fft_strided_tw`, or the composed routes' chirp over
the kept points (`_bluestein_p`'s ``in_keep``).

The kept intermediate order (``keep_intermediate_order``):
`keep_order_kernel` names the form of a minor-axis DIRECT plan,
`keep_order_lines_p` runs it (`fft_lines`' tl entry, `fft_twofactor`
swapped at `ck.split_lane_major`), `keep_order_pair_p` the 2-D pair
(`fft_pair`'s tl entry, transposed planes).

What raises ``NotImplementedError`` naming its ROADMAP item: float64 on
every route but the fp64 kernels' DIRECT lengths, float64 real data and
convolution, R2R data on any dtype but float32 (the transforms widen half
R2R data first), and every other dtype (queue 1 item 10).  `check_walk`
refuses a C2C walk with such an axis before its first launch.  `route`
raises ValueError for a length no split of the long tier holds (beyond
2^40, or more primes above 64 than three uploads can place).  Nothing
here falls back to the plain engine or to a kernel's plain version.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.ops import cuda_kernels as ck
from vkfft_tpu_torch.ops.half_length import c2r_pack, r2c_untangle
from vkfft_tpu_torch.pcomplex import Planar, widened
from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import AxisPlan, plan_axis


def route(plan: AxisPlan) -> tuple[tuple[str, AxisPlan, int], ...]:
    """The kernels one direction of ``plan`` launches on (B, n) lines, in
    the forward's launch order, as (kernel, the plan it serves, the length
    it holds) triples; a SPLIT lists its factors' launches.  () for n <= 4,
    which runs as tensor ops.  This is the engine's one routing decision:
    `fft_lines_p` dispatches on it and `supports` reads it.  Raises
    ValueError for a length no split of the long tier holds (as the JAX
    package's ``_fft_long3_planar`` does)."""
    n, alg = plan.n, plan.algorithm
    if n <= 4:
        return ()
    if alg is Algorithm.SPLIT:
        return sum((route(plan_axis(f)) for f in plan.decomp.split), ())
    if alg is Algorithm.DIRECT:
        core = n
    elif alg is Algorithm.RADER:
        core = n - 1
    else:
        core = plan.decomp.bluestein_size
    if ck.kernel_supports(core):
        kernel = "fft_lines" if alg is Algorithm.DIRECT else "fft_conv"
        return ((kernel, plan, core),)
    if alg is Algorithm.BLUESTEIN and ck.conv_pair_plan(core) is not None:
        return (("fft_conv_pair", plan, core),)
    if ck.twofactor_supports(core):
        inv = () if alg is Algorithm.DIRECT else (("fft_conv_inv", plan, core),)
        return (("fft_twofactor", plan, core),) + inv
    if alg is Algorithm.BLUESTEIN:
        split = ck.bluestein_long_split(core)
        if split is not None:
            nc, ns = split
            return (("fft_strided_tw", plan, nc), ("fft_conv", plan, ns),
                    ("fft_strided_tw", plan, nc))
        fwd = _long_route(plan, core, natural=False)
        return fwd + fwd[::-1]
    # DIRECT beyond 16384 (Rader's p - 1 never is: RADER_MAX_PRIME)
    return _long_route(plan, core)


def _long_route(plan: AxisPlan, n: int, natural: bool = True) -> tuple:
    """The forward launches of the long tier at length n: a strided pass
    per strided factor of `long_split`, then the ns pass: in the natural
    order where the split folds the reorder (`ck.long_folds`), a strided
    pass (`fft_strided` after two uploads, `fft_strided_tw` after three),
    else the contiguous pass."""
    split = ck.long_split(n)
    if split is None:
        raise ValueError(f"no split of the long tier holds n={n}")
    *strided, ns = split
    if natural and ck.long_folds(split):
        last = "fft_strided" if len(split) == 2 else "fft_strided_tw"
        return tuple((k, plan, f) for k, f in
                     [("fft_strided_tw", f) for f in strided] + [(last, ns)])
    lines = "fft_lines" if ck.kernel_supports(ns) else "fft_twofactor"
    return (tuple(("fft_strided_tw", plan, f) for f in strided)
            + ((lines, plan, ns),))


def supports(plan: AxisPlan) -> bool:
    """Whether this engine runs the plan (on the minor axis): every 1-D
    plan the long tier's splits hold."""
    try:
        route(plan)
    except ValueError:
        return False
    return True


def pair_supports(ny: int, nz: int,
                  dtype: torch.dtype = torch.float32) -> bool:
    """Whether `fft_pair_p` runs a (ny, nz) plane of ``dtype`` in one
    kernel pass."""
    return (plan_axis(ny).algorithm is Algorithm.DIRECT
            and plan_axis(nz).algorithm is Algorithm.DIRECT
            and ck.pair_cluster(ny, nz, dtype) is not None)


def f64_axis_supports(plan: AxisPlan) -> bool:
    """Whether float64 planes run along an axis of ``plan`` on the fp64
    kernels, minor or not: n <= 4 (tensor ops on the minor axis) or a
    DIRECT plan of `fft_lines`' lengths (the minor axis in `fft_lines`,
    any other in `fft_strided`, two minor axes in `fft_pair` where
    `pair_supports` holds at float64)."""
    return plan.n <= 4 or (plan.algorithm is Algorithm.DIRECT
                           and ck.kernel_supports(plan.n, torch.float64))


def f64_supports(shape, axes) -> bool:
    """Whether a C2C transform of ``axes`` of ``shape`` runs on the fp64
    kernels: every transformed axis `f64_axis_supports`.  The DOUBLE
    precision's one routing decision (`api.double_route`), made from the
    plans before any launch, the same on the CPU and on the card."""
    return all(f64_axis_supports(plan_axis(shape[a])) for a in axes)


def storage_axis_supports(plan: AxisPlan) -> bool:
    """Whether float16 / bfloat16 planes run along an axis of ``plan`` on
    the half-storage kernels, minor or not: wherever `supports` holds
    (every route has its half instantiations: n <= 4 as tensor ops widened
    to fp32; a non-minor axis in `fft_strided` where `kernel_supports`
    holds, else on the contiguous route; two minor axes in `fft_pair`
    where `pair_supports` holds at the half dtype)."""
    return supports(plan)


def storage_supports(shape, axes) -> bool:
    """Whether a C2C transform of ``axes`` of ``shape`` runs on float16 /
    bfloat16 planes: every transformed axis `storage_axis_supports`."""
    return all(storage_axis_supports(plan_axis(shape[a])) for a in axes)


def axis_supports(plan: AxisPlan, dtype: torch.dtype) -> bool:
    """Whether planes of ``dtype`` run along an axis of ``plan``: float32
    on every route, float64 where `f64_axis_supports` holds, float16 /
    bfloat16 where `storage_axis_supports` does."""
    if dtype == torch.float64:
        return f64_axis_supports(plan)
    if dtype in ck.STORAGE_DTYPES:
        return storage_axis_supports(plan)
    return dtype == torch.float32


def check_walk(shape, axes, dtype: torch.dtype) -> None:
    """Refuse, before any launch, a C2C walk of ``axes`` of ``shape`` on
    planes of ``dtype`` that meets an axis no instantiation of that dtype
    runs (`axis_supports`)."""
    for a in axes:
        if not axis_supports(plan_axis(shape[a]), dtype):
            raise _dtype_error(dtype)


r2c_supports = ck.r2c_supports


def r2c_pair_supports(ny: int, nz: int,
                      dtype: torch.dtype = torch.float32) -> bool:
    """Whether `rfft_pair_p`/`irfft_pair_p` run real (ny, nz) planes of
    ``dtype`` in one kernel pass: float32 planes a cluster holds (the JAX
    package's ``_r2c_pair_ok``, ``transforms/r2c.py:245-250``, takes
    float32 only; half planes run the real axis and the complex axes
    apart)."""
    return (dtype == torch.float32
            and ck.r2c_pair_cluster(ny, nz) is not None)


def _dtype_error(dtype: torch.dtype) -> NotImplementedError:
    return NotImplementedError(
        f"CUDA engine runs float32 planes, float64 on the C2C routes of the "
        f"fp64 kernels (DIRECT lengths of fft_lines, n <= 4), and float16 / "
        f"bfloat16 on every C2C route, real transforms and convolution (not "
        f"on R2R data); {dtype} here is ROADMAP queue 1 item 10")


def _storage(dtype: torch.dtype) -> bool:
    """The dtype rule of the routes whose kernels have half-storage
    instantiations but no fp64 one (real lines, convolution)."""
    return dtype in ck.STORAGE_DTYPES


def _check_dtype(x, ok=None) -> None:
    """float32 planes, or float64 / float16 / bfloat16 where ``ok(dtype)``
    holds (a C2C route on that dtype's instantiations: `axis_supports`;
    asked only of those dtypes)."""
    if x.dtype == torch.float32 or (
            ok is not None and x.dtype in (torch.float64,) + ck.STORAGE_DTYPES
            and ok(x.dtype)):
        return
    raise _dtype_error(x.dtype)


def _tiny_dft_p(x: Planar, n: int, inverse: bool, scale: float) -> Planar:
    """n <= 4 DFT as plain elementwise tensor ops on (B, n) planes; half
    planes widened to fp32 around them, as the storage tiers compute."""
    if x.dtype in ck.STORAGE_DTYPES:
        return _tiny_dft_p(x.astype(torch.float32), n, inverse,
                           scale).astype(x.dtype)
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


def _pass_scales(dtype: torch.dtype, factors: tuple, inverse: bool,
                 scale: float) -> tuple:
    """The scale of each pass over ``factors`` (in launch order) of one
    axis: the caller's on the last; on the inverse of half planes each
    pass but the last its own factor's 1/n_k and the last the rest, so no
    unnormalized intermediate of the inverse leaves float16's range (an
    unnormalized first upload at 2^26 grows a unit-variance spectrum past
    65504)."""
    if not inverse or dtype not in ck.STORAGE_DTYPES:
        return (1.0,) * (len(factors) - 1) + (scale,)
    return (tuple(1.0 / f for f in factors[:-1])
            + (scale * math.prod(factors[:-1]),))


def _narrow(x: Planar, dtype: torch.dtype) -> Planar:
    """The glue's fp32 result at the planes' storage dtype, narrowed once
    (torch promotes a half plane times an fp32 table to fp32, which would
    launch the fp32 kernels next)."""
    return x if x.dtype == dtype else x.astype(dtype)


def _split_p(x: Planar, plan: AxisPlan, inverse: bool,
             scale: float) -> Planar:
    """SPLIT n = fa*fb (``pallas_engine.py:628-645``): the fa-point lines
    of the (fb, fa) transpose, the twiddle, the fb-point lines of the (fa,
    fb) transpose with the caller's scale, and the transpose back; the
    transposes and the multiply are tensor ops (on half planes the
    multiply in fp32, narrowed once; the inverse's scale `_pass_scales`)."""
    fa, fb = plan.decomp.split
    B = x.shape[0]
    sa, sb = _pass_scales(x.dtype, (fa, fb), inverse, scale)
    tw = ck.table_planar(ck.device_array(
        ("split", fa, fb, inverse), x.device,
        lambda: luts.ct_twiddle(fa, fb, inverse))).reshape(fb, fa)

    def swap(p, d1, d2):
        return Planar(*(t.reshape(B, d1, d2).transpose(1, 2)
                        for t in (p.re, p.im)))

    y = swap(x, fa, fb).reshape(B * fb, fa)
    y = fft_lines_p(y, plan_axis(fa), inverse, donate=True,
                    scale=sa).reshape(B, fb, fa)
    y = swap(_narrow(y * tw[None], x.dtype), fb, fa).reshape(B * fa, fb)
    y = fft_lines_p(y, plan_axis(fb), inverse, donate=True,
                    scale=sb).reshape(B, fa, fb)
    return swap(y, fa, fb).reshape(B, plan.n)


_RADER_INDEX: dict = {}


def _rader_index(p: int, device):
    """Rader's gather g^q mod p and output order argsort(g^-q mod p) for
    prime p, as index tensors on ``device``."""
    key = (p, str(device))
    if key not in _RADER_INDEX:
        perm, inv_perm, _ = luts.rader_tables(p)
        _RADER_INDEX[key] = (torch.as_tensor(perm, device=device),
                             torch.as_tensor(np.argsort(inv_perm),
                                             device=device))
    return _RADER_INDEX[key]


def _rader_p(x: Planar, p: int, scale: float, kernel: str) -> Planar:
    """Forward Rader DFT of prime length p (``pallas_engine.py:675-725``):
    the cyclic convolution of the p-1 gathered points in `fft_conv`, or in
    `fft_twofactor` (swapped) + `fft_conv_inv` with X0 = x0 + F[0] riding
    the forward's bin 0 and x0 the store (the DC-fused branch, l.686-716).
    ``kernel`` is the first of them on `route`.  The gathers, the DC sum
    and the concatenation are tensor ops (on half planes the DC sum, the
    x0 terms and X0 in fp32, each narrowed once).  `fft_conv`'s x0 term
    rides its input: the kernel b_k = w^(g^-k) sums to -1, so the
    convolution of x[perm] - x0 is the convolution of x[perm] plus x0
    (times the scale in the spectrum).  Added to the narrowed output of
    half planes, the common x0 rounded every output of a binade the same
    way, a coherent error (ten times the propagated error of one rounding
    in the round trip at 5003); on the input side its rounding is a few
    ulps of the input, under the output's."""
    dev, dt = x.device, x.dtype
    perm, order = _rader_index(p, dev)
    x0 = x[:, :1].astype(torch.float32)
    if kernel == "fft_conv":
        X0 = Planar(x.re.sum(1, keepdim=True, dtype=torch.float32),
                    x.im.sum(1, keepdim=True, dtype=torch.float32))
        xg = _narrow(Planar(x.re[:, perm], x.im[:, perm]) - x0, dt)
        val = Planar(*ck.fft_conv(xg.re, xg.im,
                                  ck.rader_spectrum(p, scale, dev),
                                  out=(xg.re, xg.im)))
    else:
        xg = Planar(x.re[:, perm], x.im[:, perm])
        fr, fi = ck.fft_twofactor(xg.re, xg.im, swapped=True,
                                  out=(xg.re, xg.im))
        # bin 0 sits at position 0 of the swapped order; X0 is taken
        # before fft_conv_inv writes over the spectrum
        X0 = Planar(x0.re + fr[:, :1], x0.im + fi[:, :1])
        dc = ((x0.re * scale).reshape(-1), (x0.im * scale).reshape(-1))
        val = Planar(*ck.fft_conv_inv(
            fr, fi, ck.rader_spectrum(p, scale, dev, "swapped"), dc=dc,
            out=(fr, fi)))
    X0 = _narrow(X0 * scale, dt)
    return Planar(torch.cat([X0.re, val.re[:, order]], 1),
                  torch.cat([X0.im, val.im[:, order]], 1))


def _chirp_pad(x: Planar, a: Planar, m: int, in_keep: int = 0) -> Planar:
    """The composed routes' read: the lines times the chirp ``a`` (fp32,
    narrowed once to the planes' dtype), zero-padded to m; with
    ``in_keep``, Bluestein's read window: only the first in_keep points
    taken, the declared-zero tail never read."""
    k = in_keep or x.shape[1]
    y = _narrow(x[:, :k] * a[:, :k], x.dtype)
    return Planar(*(torch.nn.functional.pad(t, (0, m - k))
                    for t in (y.re, y.im)))


def _bluestein_p(x: Planar, plan: AxisPlan, inverse: bool, scale: float,
                 kernels: tuple, in_keep: int = 0) -> Planar:
    """Bluestein DFT through the padded length m
    (``pallas_engine.py:648-672``), on the ``kernels`` `route` names, in
    its order: `fft_conv` (Bluestein mode); `fft_conv_pair`; the chirp and
    the pad as tensor ops around `fft_twofactor` (swapped) +
    `fft_conv_inv`; the fused long tier (`_bluestein_long_p`); the
    composition on the long DIRECT routes (`_bluestein_composed_p`).  1/m
    and the caller's scale ride the spectrum or the last kernel.  On half
    planes the tensor-op chirps compute in fp32 and narrow once.

    ``in_keep`` (0 < in_keep <= n; 0 for none): Bluestein's read window
    (the JAX package's ``blu`` route, ``vkfft_tpu/api.py:485-501``): the
    points past in_keep of each line are declared zero and never read,
    the windowed entries of `fft_conv`, `fft_conv_pair` and the long
    tier's first `fft_strided_tw`, or the composed routes' chirp taken
    over the first in_keep points only; every n points are written."""
    n, m = plan.n, plan.decomp.bluestein_size
    dev = x.device
    kernel = kernels[0][0]
    if kernel == "fft_strided_tw":
        if kernels[1][0] == "fft_conv":
            return _bluestein_long_p(x, n, m, inverse, scale, in_keep)
        return _bluestein_composed_p(x, n, m, inverse, scale, in_keep)
    chirp = ck.bluestein_chirp(n, m, inverse, dev)
    if kernel == "fft_conv":
        spec = ck.bluestein_spectrum(n, m, inverse, scale, dev)
        return Planar(*ck.fft_conv(x.re, x.im, spec, chirp, in_keep=in_keep))
    if kernel == "fft_conv_pair":
        spec = ck.bluestein_spectrum(n, m, inverse, scale, dev, "pair")
        return Planar(*ck.fft_conv_pair(x.re, x.im, spec, chirp,
                                        in_keep=in_keep))
    a = ck.table_planar(chirp)[None]
    y = _chirp_pad(x, a, m, in_keep)
    fr, fi = ck.fft_twofactor(y.re, y.im, swapped=True, out=(y.re, y.im))
    spec = ck.bluestein_spectrum(n, m, inverse, scale, dev, "swapped")
    vr, vi = ck.fft_conv_inv(fr, fi, spec, out=(fr, fi))
    return _narrow(Planar(vr[:, :n], vi[:, :n]) * a, x.dtype)


def _bluestein_long_p(x: Planar, n: int, m: int, inverse: bool,
                      scale: float, in_keep: int = 0) -> Planar:
    """The fused long Bluestein (``pallas_engine.py:452-519
    _bluestein_long_fused_p``) on m = nc*ns (`bluestein_long_split`), three
    kernels: the strided nc pass reading each (B, n) line as the first n
    points of its (nc, ns) plane, the chirp on the read and the four-step
    twiddle on the write; `fft_conv`'s rows mode on the ns-point lines of
    the swapped layout, line (b, kc) times row kc of the spectrum; the
    inverse strided pass, the conjugate twiddle on the read, the chirp on
    the write and the caller's scale in its stages, writing only the first
    n points.  ``in_keep``: the first pass's read window (its windowed
    entry)."""
    nc, ns = ck.bluestein_long_split(m)
    B = x.shape[0]
    t = ck.fft_strided(x.re, x.im, False, 1.0, pre=ck.chirp(n, inverse),
                       post=ck.twiddle(m), plane=(nc, ns), in_keep=in_keep)
    spec = ck.bluestein_spectrum(n, m, inverse, 1.0, x.device, "long")
    c = ck.fft_conv(t[0].reshape(B * nc, ns), t[1].reshape(B * nc, ns), spec,
                    out=tuple(u.reshape(B * nc, ns) for u in t))
    y = ck.fft_strided(c[0].reshape(B, m), c[1].reshape(B, m), True, scale,
                       pre=ck.twiddle(m, True), post=ck.chirp(n, inverse),
                       plane=(nc, ns), out_len=n)
    return Planar(*y)


def _bluestein_composed_p(x: Planar, n: int, m: int, inverse: bool,
                          scale: float, in_keep: int = 0) -> Planar:
    """Bluestein where m's ns-point lines fit no `fft_conv`
    (``pallas_engine.py:665-672`` with ``:400-402``): the chirp and the pad
    as tensor ops, the long forward in the swapped order, the spectrum (in
    that order) multiplied as a tensor op, the long inverse from the
    swapped order with the caller's scale, the crop and the chirp (on half
    planes the three multiplies in fp32, each narrowed once; the long
    inverse's per-upload scale, `_pass_scales`; ``in_keep``: the chirp over
    the read window only)."""
    dev, dt = x.device, x.dtype
    a = ck.table_planar(ck.bluestein_chirp(n, m, inverse, dev))[None]
    y = _chirp_pad(x, a, m, in_keep)
    Y = fft_long_p(y, m, False, order="swapped", donate=True)
    spec = ck.table_planar(ck.bluestein_spectrum(n, m, inverse, 1.0, dev,
                                                 "long_swapped"))
    Y = _narrow(Y * spec[None], dt)
    z = fft_long_p(Y, m, True, scale, order="swapped", donate=True)
    return _narrow(Planar(z.re[:, :n], z.im[:, :n]) * a, dt)


def _lines(x: Planar, n: int, inverse: bool, scale: float = 1.0) -> Planar:
    """The long tier's contiguous pass over (L, n) lines, in place:
    `fft_lines` where its stages take n, else `fft_twofactor`."""
    run = ck.fft_lines if ck.kernel_supports(n) else ck.fft_twofactor
    return Planar(*run(x.re, x.im, inverse, scale, out=(x.re, x.im)))


def fft_long_p(x: Planar, n: int, inverse: bool = False, scale: float = 1.0,
               order: str = "natural", split: Optional[tuple] = None,
               donate: bool = False) -> Planar:
    """DFT of (B, n) lines beyond one kernel (``pallas_engine.py:4218-4315
    fft_long_planar``): two uploads, n = nc*ns of ``split`` (default
    `long_split`; a three-factor split runs `fft_long3_p`).  Forward: the
    strided nc pass with the twiddle w_n^(kc*js) on its write, then the ns
    lines with the caller's scale, then the (kc, ks) -> (ks, kc) reorder as
    a tensor op; where the split folds (`ck.long_folds`) the natural order
    instead stores the first pass transposed, (js, kc), and runs the ns
    pass as `fft_strided` over its rows (the JAX package's free reorder,
    ``pallas_engine.py:4242-4252``).  The inverse mirrors it, the
    conjugate twiddle on the strided pass's read and the scale in its
    stages (on half planes each upload its own factor's 1/n_k and the
    rest of the scale on the last, `_pass_scales`).  ``order="swapped"``
    leaves (reads) the (kc, ks) order and skips the reorder; a forward and
    an inverse cancel it.  ``donate=True`` lets the first pass write over
    the caller's planes."""
    split = split or ck.long_split(n)
    if len(split) == 3:
        return fft_long3_p(x, n, inverse, scale, order, split, donate)
    nc, ns = split
    B = x.shape[0]
    x = x.contiguous()
    # the inverse's uploads in launch order: ns, then nc
    s_ns, s_nc = _pass_scales(x.dtype, (ns, nc), inverse, scale)
    if order == "natural" and ck.long_folds(split):
        if not inverse:
            t = ck.fft_strided(x.re.reshape(B, nc, ns),
                               x.im.reshape(B, nc, ns), False,
                               post=ck.twiddle(n), out_transposed=True)
            y = ck.fft_strided(*t, False, scale, out=t)
        else:
            xr, xi = x.re.reshape(B, ns, nc), x.im.reshape(B, ns, nc)
            t = ck.fft_strided(xr, xi, True, s_ns,
                               out=(xr, xi) if donate else None)
            y = ck.fft_strided(*t, True, s_nc, pre=ck.twiddle(n, True),
                               in_transposed=True)
        return Planar(*y).reshape(B, n)
    if not inverse:
        xr, xi = x.re.reshape(B, nc, ns), x.im.reshape(B, nc, ns)
        t = Planar(*ck.fft_strided(xr, xi, False, post=ck.twiddle(n),
                                   out=(xr, xi) if donate else None))
        y = _lines(t.reshape(B * nc, ns), ns, False, scale).reshape(B, n)
        return ck.swap_digits(y, nc, ns) if order == "natural" else y
    if order == "natural":
        x = ck.swap_digits(x, ns, nc)
    elif not donate:
        x = Planar(x.re.clone(), x.im.clone())
    y = _lines(x.reshape(B * nc, ns), ns, True, s_ns)
    yr, yi = y.re.reshape(B, nc, ns), y.im.reshape(B, nc, ns)
    z = ck.fft_strided(yr, yi, True, s_nc, pre=ck.twiddle(n, True),
                       out=(yr, yi))
    return Planar(*z).reshape(B, n)


def fft_long3_p(x: Planar, n: int, inverse: bool = False, scale: float = 1.0,
                order: str = "natural", split: Optional[tuple] = None,
                donate: bool = False) -> Planar:
    """Three uploads, n = na*nb*ns of ``split`` (default `long_split(n,
    3)`), as ``pallas_engine.py:4318-4418 _fft_long3_planar``.  Forward:
    the strided na pass over (B, na, nb*ns) with w_(na*nb)^(ka*jb), jb = s
    // ns, on its write; the strided nb pass over (B*na, nb, ns) with
    w_n^((kb*na + ka)*js), ka the digit carried in P, on its write, which
    it lays out interleaved as (B, nb, na, ns), kc = kb*na + ka in natural
    order; the ns lines with the scale; the (kc, ks) -> (ks, kc) reorder as
    a tensor op, as for two uploads.  Where the split folds
    (`ck.long_folds`) the natural order runs three strided passes
    instead: na stored transposed, (B, jb, js, ka); nb over its (js, ka)
    columns, w_n^((kb*na + ka)*js) on the write, giving (B, kb, js, ka);
    ns over the ka columns of the planes (b, kb), with the scale, written
    interleaved as (B, ks, kb, ka), the natural order.  The inverse
    mirrors it (on half planes each upload its own factor's 1/n_k,
    `_pass_scales`); ``order`` and ``donate`` as for `fft_long_p`."""
    na, nb, ns = split or ck.long_split(n, 3)
    B = x.shape[0]
    nc = na * nb
    x = x.contiguous()
    # the inverse's uploads in launch order: ns, nb, then na
    s_ns, s_nb, s_na = _pass_scales(x.dtype, (ns, nb, na), inverse, scale)
    if order == "natural" and ck.long_folds((na, nb, ns)):
        mid = ck.twiddle(n, inverse, a=na, sd=na, sm=na)
        if not inverse:
            t = ck.fft_strided(x.re.reshape(B, na, nb * ns),
                               x.im.reshape(B, na, nb * ns), False,
                               post=ck.twiddle(nc, sd=ns), out_transposed=True)
            t = tuple(u.reshape(B, nb, ns * na) for u in t)
            t = ck.fft_strided(*t, False, post=mid, out=t)
            y = ck.fft_strided(*(u.reshape(B * nb, ns, na) for u in t), False,
                               scale, out_interleave=nb)
        else:
            t = ck.fft_strided(x.re.reshape(B * nb, ns, na),
                               x.im.reshape(B * nb, ns, na), True, s_ns,
                               in_interleave=nb)
            t = tuple(u.reshape(B, nb, ns * na) for u in t)
            t = ck.fft_strided(*t, True, s_nb, pre=mid, out=t)
            y = ck.fft_strided(*(u.reshape(B, nb * ns, na) for u in t), True,
                               s_na, pre=ck.twiddle(nc, True, sd=ns),
                               in_transposed=True)
        return Planar(*y).reshape(B, n)
    if not inverse:
        xr, xi = x.re.reshape(B, na, nb * ns), x.im.reshape(B, na, nb * ns)
        tr, ti = ck.fft_strided(xr, xi, False,
                                post=ck.twiddle(nc, sd=ns),
                                out=(xr, xi) if donate else None)
        tr, ti = ck.fft_strided(tr.reshape(B * na, nb, ns),
                                ti.reshape(B * na, nb, ns), False,
                                post=ck.twiddle(n, a=na, pm=na, b=1),
                                out_interleave=na)
        y = _lines(Planar(tr, ti).reshape(B * nc, ns), ns, False,
                   scale).reshape(B, n)
        return ck.swap_digits(y, nc, ns) if order == "natural" else y
    if order == "natural":
        x = ck.swap_digits(x, ns, nc)
    elif not donate:
        x = Planar(x.re.clone(), x.im.clone())
    y = _lines(x.reshape(B * nc, ns), ns, True, s_ns)
    yr, yi = ck.fft_strided(y.re.reshape(B * na, nb, ns),
                            y.im.reshape(B * na, nb, ns), True, s_nb,
                            pre=ck.twiddle(n, True, a=na, pm=na, b=1),
                            in_interleave=na)
    yr, yi = yr.reshape(B, na, nb * ns), yi.reshape(B, na, nb * ns)
    ck.fft_strided(yr, yi, True, s_na, pre=ck.twiddle(nc, True, sd=ns),
                   out=(yr, yi))
    return Planar(yr, yi).reshape(B, n)


def window_kernel(plan: AxisPlan) -> Optional[str]:
    """The kernel whose windowed entry runs a zero-pad window on lines of
    ``plan``: `fft_lines` or `fft_twofactor` for a DIRECT plan that
    `route` runs in one of them, else None (the window is then a mask and
    a slice around the plan's route)."""
    if plan.algorithm is not Algorithm.DIRECT or plan.n <= 4:
        return None
    kernel = route(plan)[0][0]
    return kernel if kernel in ("fft_lines", "fft_twofactor") else None


def read_window(plan: AxisPlan, w: ck.LineWindow) -> int:
    """The read window (kept prefix) that a Bluestein plan's windowed
    entries run for the window ``w``: its kept input prefix where that is
    all of it (no interior window; the output whole, nothing written as
    zeros), else 0 (the window is then a mask and a slice)."""
    if (plan.algorithm is Algorithm.BLUESTEIN and w.length < w.n
            and w.zero == (0, 0) and w.out == w.n and w.fill == (0, 0)):
        return w.length
    return 0


def _masked_lines(x: Planar, plan: AxisPlan, inverse: bool, scale: float,
                  w: ck.LineWindow) -> Planar:
    """A window off the windowed kernels (``pallas_engine.fft_axis_p``'s
    contract, l.756-767): the read points of the (..., L) lines, zeros
    elsewhere, the plan's route, then the crop or the zeros written."""
    y = fft_lines_p(ck._window_lines_in(x.re, x.im, w), plan, inverse,
                    donate=True, scale=scale)
    return Planar(*ck._window_lines_out(y, w, x.shape[:-1]))


def fft_lines_p(x: Planar, plan: AxisPlan, inverse: bool = False,
                donate: bool = False, scale: float = 1.0, in_keep: int = 0,
                out_keep: int = 0, out_fill: bool = False, in_window=None,
                out_zero_window=None) -> Planar:
    """Planar DFT over (B, n) planes, scaled by ``scale`` in the kernels.
    ``donate=True`` lets a DIRECT plan overwrite the caller's planes.

    Zero-pad windows (``in_keep`` or ``in_window``; ``out_keep`` with or
    without ``out_fill``, or ``out_zero_window``; `ck.line_window`) run
    the windowed entry of `window_kernel`'s kernel; the planes may then be
    any view (..., L) of lines, L = n or the kept prefix, and the result
    is (..., n) or, cropped, (..., out_keep).  A kept input prefix alone on
    lines of n points of a Bluestein plan is its read window
    (`read_window`, `_bluestein_p`).  Off those kernels the window is a
    mask and a slice around the plan's route."""
    _check_dtype(x, lambda dt: axis_supports(plan, dt))
    w = ck.line_window(plan.n, in_keep, out_keep, out_fill, in_window,
                       out_zero_window, "fft_lines_p")
    if w is not None:
        return _windowed_lines(x, plan, inverse, scale, w, donate)
    n = plan.n
    if n == 1:
        return x * scale if scale != 1.0 else x
    if n <= 4:
        return _tiny_dft_p(x, n, inverse, scale)
    kernels = route(plan)
    kernel = kernels[0][0]
    alg = plan.algorithm
    if alg is Algorithm.SPLIT:
        return _split_p(x, plan, inverse, scale)
    x = x.contiguous()
    if alg is Algorithm.DIRECT:
        if kernel == "fft_strided_tw":
            return fft_long_p(x, n, inverse, scale, donate=donate)
        run = ck.fft_lines if kernel == "fft_lines" else ck.fft_twofactor
        return Planar(*run(x.re, x.im, inverse, scale,
                           out=(x.re, x.im) if donate else None))
    if alg is Algorithm.BLUESTEIN:
        return _bluestein_p(x, plan, inverse, scale, kernels)
    if inverse:   # Rader's inverse by conjugation (l.673-674)
        return fft_lines_p(x.conj(), plan, False, scale=scale).conj()
    return _rader_p(x, n, scale, kernel)


def keep_order_kernel(plan: AxisPlan) -> Optional[str]:
    """What runs lines of ``plan`` in the kept intermediate order (the
    JAX package's ``keep_intermediate_order`` branches on its ``pallas``
    engine, ``vkfft_tpu/api.py:449-477``): "tiny" for n = 2..4 (tensor
    butterflies, natural order), "fft_lines" for the DIRECT lengths `route`
    runs there (its tl entry: the swapped digit order of `ck.lines_split`),
    "fft_twofactor" for those it runs in `fft_twofactor` where the JAX
    package's v2 kernel takes them (`ck.split_lane_major` with n1 >= 8: its
    swapped order of that split); None elsewhere (natural order).  Kept
    per length (the plan is plan_axis(n)'s)."""
    return _keep_order_kernel(plan.n)


@functools.lru_cache(maxsize=4096)
def _keep_order_kernel(n: int) -> Optional[str]:
    plan = plan_axis(n)
    if plan.algorithm is not Algorithm.DIRECT or n < 2:
        return None
    if n <= 4:
        return "tiny"
    kernel = route(plan)[0][0]
    if kernel == "fft_lines":
        return kernel
    split = ck.split_lane_major(n)
    if kernel == "fft_twofactor" and split is not None and split[0] >= 8:
        return kernel
    return None


def keep_order_split(plan: AxisPlan, dtype: torch.dtype) -> tuple:
    """The (n1, n2) digit order of `keep_order_lines_p` on lines of
    ``plan`` and ``dtype``: bin k1 * n2 + k2 at k2 * n1 + k1, natural where
    n2 = 1."""
    kernel = keep_order_kernel(plan)
    if kernel == "fft_lines":
        return ck.lines_split(plan.n, dtype)
    if kernel == "fft_twofactor":
        return ck.split_lane_major(plan.n)
    return (plan.n, 1)


def keep_order_lines_p(x: Planar, plan: AxisPlan, inverse: bool = False,
                       scale: float = 1.0) -> Planar:
    """(B, n) lines in the kept intermediate order of `keep_order_kernel`:
    the forward from natural order to `keep_order_split`'s, the inverse
    back, in one launch (`fft_lines`' tl entry, or `fft_twofactor` swapped
    at `ck.split_lane_major`)."""
    _check_dtype(x, _storage)
    kernel = keep_order_kernel(plan)
    n = plan.n
    if kernel == "tiny":
        return _tiny_dft_p(x, n, inverse, scale)
    x = x.contiguous()
    if kernel == "fft_lines":
        return Planar(*ck.fft_lines(x.re, x.im, inverse, scale, tl=True))
    if kernel == "fft_twofactor":
        return Planar(*ck.fft_twofactor(x.re, x.im, inverse, scale,
                                        swapped=True,
                                        split=ck.split_lane_major(n)))
    raise ValueError(f"length {n} has no kept order (keep_order_kernel)")


def keep_order_pair_p(x: Planar, ny: int, nz: int, inverse: bool = False,
                      scale: float = 1.0) -> Planar:
    """The 2-D pair in the kept intermediate order, one `fft_pair` tl
    launch: the forward from (..., ny, nz) planes to the transposed (...,
    nz, ny) planes of their spectrum, the inverse back (the JAX package's
    ``fft_pair_tl_planar``)."""
    _check_dtype(x, lambda dt: _storage(dt) and pair_supports(ny, nz, dt))
    want = (nz, ny) if inverse else (ny, nz)
    if x.shape[-2:] != want:
        raise ValueError(f"minor axes are {x.shape[-2:]}, not {want}")
    lead = x.shape[:-2]
    x = x.contiguous()
    a, b = want
    rr, ii = ck.fft_pair(x.re.reshape(-1, a, b), x.im.reshape(-1, a, b),
                         inverse, scale, tl=True)
    return Planar(rr.reshape(*lead, b, a), ii.reshape(*lead, b, a))


def _one_layout(x: Planar) -> Planar:
    """``x`` where both planes share one layout with a contiguous last dim,
    as the windowed kernels read them in place through one set of strides;
    else a contiguous copy (planes of two layouts, such as a transposed
    ``im``, or interleaved ones, such as ``Planar(z.real, z.imag)``)."""
    re, im = x.re, x.im
    if re.stride() == im.stride() and (re.ndim == 0 or re.shape[-1] <= 1
                                       or re.stride(-1) == 1):
        return x
    return x.contiguous()


def _windowed_lines(x: Planar, plan: AxisPlan, inverse: bool, scale: float,
                    w: ck.LineWindow, donate: bool = False) -> Planar:
    """The window ``w`` on the (..., L) lines of ``x``: the windowed entry
    of `window_kernel`'s kernel, reading the planes in place; Bluestein's
    read window (`read_window`) on lines of n points through the windowed
    entries of its route (`_bluestein_p`); else `_masked_lines`."""
    kernel = window_kernel(plan)
    if kernel is None:
        keep = read_window(plan, w)
        if keep and x.shape[-1] == plan.n:
            y = _bluestein_p(x.reshape(-1, plan.n).contiguous(), plan,
                             inverse, scale, route(plan), keep)
            return y.reshape(*x.shape)
        return _masked_lines(x, plan, inverse, scale, w)
    x = _one_layout(x)
    run = ck.fft_lines if kernel == "fft_lines" else ck.fft_twofactor
    own = (donate and x.re.is_contiguous() and x.im.is_contiguous()
           and x.shape[-1] == w.n == w.out)
    return Planar(*run(x.re, x.im, inverse, scale,
                       out=(x.re, x.im) if own else None, window=w))


def _views(x: Planar, dims) -> tuple:
    """Both planes of ``x`` as the view of (size, stride) ``dims`` over
    their storage (no copy); the planes must share one layout
    (`_one_layout`), since ``dims`` come from one of them."""
    if x.re.stride() != x.im.stride():
        raise ValueError(f"planes of strides {x.re.stride()} and "
                         f"{x.im.stride()} (one layout: _one_layout)")
    return tuple(t.as_strided([d for d, _ in dims], [s for _, s in dims],
                              t.storage_offset()) for t in (x.re, x.im))


def axis_window(x: Planar, axis: int, plan: AxisPlan, inverse: bool = False,
                scale: float = 1.0, in_keep: int = 0,
                out_keep: int = 0) -> Planar:
    """`fft_axis_p` on a view with prefix keeps along ``axis`` (``pallas_
    engine.fft_axis_p``, l.744-790): the minor axis on the windowed lines
    entry of `window_kernel`, any other DIRECT axis of `fft_strided`'s
    lengths on its windowed entry, both reading the planes in place
    through their strides (a corner of wider planes; the identity window
    where the axis has no keep); elsewhere a mask and a slice.  The axis of
    ``x`` may hold n points or the kept ones; the result holds ``out_keep``
    (or n).  Contiguous planes without keeps take `fft_axis_p`'s route."""
    n, axis = plan.n, axis % x.ndim
    in_keep = ck._check_keep(in_keep, n, "axis_window")
    out_keep = ck._check_keep(out_keep, n, "axis_window")
    if not (in_keep or out_keep) and x.re.is_contiguous() \
            and x.im.is_contiguous():
        return fft_axis_p(x, axis, plan, inverse, scale=scale)
    if x.shape[axis] != n and not (in_keep and x.shape[axis] == in_keep):
        raise ValueError(
            f"axis {axis} has length {x.shape[axis]}, plan is for {n}")
    _check_dtype(x, lambda dt: axis_supports(plan, dt))
    x = _one_layout(x)
    shape = x.shape
    rows_in = in_keep or n
    rows_out = out_keep or n
    out_shape = shape[:axis] + (rows_out,) + shape[axis + 1:]
    if axis == x.ndim - 1:
        w = (ck.line_window(n, in_keep, out_keep, what="axis_window")
             or ck.LineWindow(n, n, (0, 0), n, (0, 0)))
        return _windowed_lines(x, plan, inverse, scale, w)
    lead = merged = None
    if plan.algorithm is Algorithm.DIRECT and ck.kernel_supports(n):
        lead = ck.merged_dims(shape[:axis], x.re.stride()[:axis])
        merged = ck.merged_dims(shape[axis + 1:], x.re.stride()[axis + 1:])
    if (lead is not None and len(lead) <= 1 and len(merged) <= 2
            and (not merged or merged[-1][1] == 1)):
        dims = ((lead or [(1, 0)]) + [(shape[axis], x.re.stride(axis))]
                + [(1, 1)] * (2 - len(merged)) + merged)
        y = ck.fft_strided(*_views(x, dims), inverse, scale, in_keep=in_keep,
                           out_keep=out_keep, n=n)
        return Planar(y[0].reshape(out_shape), y[1].reshape(out_shape))
    # the contract off the kernels: the kept rows, zeros to n, the axis
    # pass, the kept rows of the result
    pad = [0, 0] * (x.ndim - 1 - axis) + [0, n - rows_in]
    x = Planar(*(torch.nn.functional.pad(
        t.narrow(axis, 0, rows_in), pad).contiguous() for t in (x.re, x.im)))
    y = fft_axis_p(x, axis, plan, inverse, donate=True, scale=scale)
    return Planar(y.re.narrow(axis, 0, rows_out).contiguous(),
                  y.im.narrow(axis, 0, rows_out).contiguous())


def fft_axis_p(x: Planar, axis: int, plan: AxisPlan, inverse: bool = False,
               donate: bool = False, scale: float = 1.0, in_keep: int = 0,
               out_keep: int = 0) -> Planar:
    """Planar DFT along ``axis`` of N-D planes, scaled by ``scale``.  The
    minor axis runs the lines kernel on the (-1, n) view; any other axis
    runs the strided kernel on the (P, n, S) view.  ``donate=True`` lets
    the kernel write over the caller's planes (dead intermediates of an N-D
    walk).

    ``in_keep``/``out_keep``: prefix zero-pad keeps along the axis (the
    JAX package's ``fft_axis_p`` contract): only the first ``in_keep``
    points of the axis are read, the rest declared zero (the axis may
    hold n points or just those), and only the first ``out_keep`` are
    written (the result's axis has that length); on the windowed entries
    of the lines kernels and `fft_strided`, reading views in place
    (`axis_window`, which an elided walk also calls without keeps on a
    corner of wider planes)."""
    axis = axis % x.ndim
    n = plan.n
    if in_keep or out_keep:
        return axis_window(x, axis, plan, inverse, scale, in_keep, out_keep)
    if x.shape[axis] != n:
        raise ValueError(
            f"axis {axis} has length {x.shape[axis]}, plan is for {n}")
    _check_dtype(x, lambda dt: axis_supports(plan, dt))
    if n == 1:
        return x * scale if scale != 1.0 else x
    shape = x.shape
    if axis == x.ndim - 1:
        y = fft_lines_p(x.reshape(-1, n), plan, inverse, donate=donate,
                        scale=scale)
        return y.reshape(*shape)
    if plan.algorithm is not Algorithm.DIRECT or not ck.kernel_supports(n):
        # the contiguous route (``pallas_engine.py:817-827``): the axis
        # moved last, its lines, and moved back
        moved = Planar(x.re.movedim(axis, -1), x.im.movedim(axis, -1))
        y = fft_lines_p(moved.reshape(-1, n), plan, inverse, donate=donate,
                        scale=scale).reshape(*moved.shape)
        return Planar(y.re.movedim(-1, axis), y.im.movedim(-1, axis))
    x = x.contiguous()
    P = math.prod(shape[:axis])
    S = math.prod(shape[axis + 1:])
    xr = x.re.reshape(P, n, S)
    xi = x.im.reshape(P, n, S)
    rr, ii = ck.fft_strided(xr, xi, inverse, scale,
                            out=(xr, xi) if donate else None)
    return Planar(rr.reshape(shape), ii.reshape(shape))


def fft_pair_p(x: Planar, ny: int, nz: int, inverse: bool = False,
               donate: bool = False, scale: float = 1.0, in_keep=None,
               out_keep=None) -> Planar:
    """Planar 2-D DFT over the two minor axes (..., ny, nz) in one kernel
    pass, scaled by ``scale``; ``donate`` as for `fft_axis_p`.

    ``in_keep`` = (ky, kz): only that corner of each plane is read, the
    rest declared zero (the planes may be (..., ny, nz) or the corner
    itself, a view read in place); ``out_keep`` = (oy, oz): only that
    corner is written, (..., oy, oz) planes; 0 for an axis without a keep
    (the windowed entry of `fft_pair`)."""
    _check_dtype(x, lambda dt: pair_supports(ny, nz, dt))
    shape = x.shape
    if tuple(in_keep or (0, 0)) != (0, 0) or tuple(out_keep or (0, 0)) != (0, 0):
        ky, kz = in_keep or (0, 0)
        oy, oz = out_keep or (0, 0)
        if (shape[-2] not in (ny, ky) or shape[-1] not in (nz, kz)):
            raise ValueError(f"minor axes are {shape[-2:]}, not {(ny, nz)} "
                             f"or the ({ky}, {kz}) corner")
        x = _one_layout(x)
        lead = ck.merged_dims(shape[:-2], x.re.stride()[:-2])
        if len(lead) > 1:   # planes of more than one stride
            x = x.contiguous()
            lead = ck.merged_dims(shape[:-2], x.re.stride()[:-2])
        dims = (lead or [(1, 0)]) + [(shape[-2], x.re.stride(-2)),
                                     (shape[-1], x.re.stride(-1))]
        rr, ii = ck.fft_pair(*_views(x, dims), inverse, scale,
                             in_keep=(ky, kz), out_keep=(oy, oz),
                             plane=(ny, nz))
        out = shape[:-2] + (oy or ny, oz or nz)
        return Planar(rr.reshape(out), ii.reshape(out))
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
    even, as float32 planes: `fft_r2c` where `r2c_supports` holds for
    float32 lines, else the n/2-point C2C of z[j] = x[2j] + i x[2j+1] on
    the card at the lines' dtype (float16 / bfloat16 lines on the half
    instantiations) and the untangle as tensor ops in fp32
    (``vkfft_tpu/transforms/r2c.py:167-182``, whose untangle promotes half
    data to float32)."""
    _check_dtype(x, _storage)
    n = x.shape[1]
    if x.dtype == torch.float32 and ck.r2c_supports(n):
        return Planar(*ck.fft_r2c(_aligned(x)))
    z = Planar(x[:, 0::2].contiguous(), x[:, 1::2].contiguous())
    Z = fft_lines_p(z, plan_axis(n // 2), donate=True)
    return r2c_untangle(Z, n)


def irfft_lines_p(X: Planar, n: int, scale: float = 1.0) -> torch.Tensor:
    """Real (B, n) lines from their (B, n/2+1) half spectrum, scaled by
    (n/2)*``scale``: `fft_c2r` where `r2c_supports` holds, else the packing
    as tensor ops and the n/2-point inverse C2C on the card
    (``vkfft_tpu/transforms/r2c.py:223-235``); Im(DC) and Im(Nyquist) are
    ignored either way.  A float16 / bfloat16 spectrum is widened first and
    runs in fp32 to float32 lines, as the JAX package packs it
    (``:236-246``)."""
    X = widened(X)
    _check_dtype(X)
    X = X.contiguous()
    if ck.r2c_supports(n):
        return ck.fft_c2r(X.re, X.im, n, scale)
    z = fft_lines_p(c2r_pack(X, n), plan_axis(n // 2), True,
                    donate=True, scale=scale)
    return torch.stack([z.re, z.im], -1).reshape(-1, n)


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


def r2r_route(type: int, dst: bool, n: int) -> Optional[str]:
    """The kernel that runs a DCT (``dst``: DST) of ``type`` 1..4 on (B, n)
    lines, or None where its gate fails and `transforms/r2r.py` runs the
    transform as its composition on the card's FFT routes: the R2R
    counterpart of `route`."""
    if type in (2, 3):
        return "fft_dct23" if ck.dct23_supports(n) else None
    if type == 1:
        return "fft_dct1" if ck.dct1_supports(n, dst) else None
    return "fft_dct4" if ck.dct4_supports(n) else None


_R2R_KERNELS = {1: ck.fft_dct1, 2: ck.fft_dct2, 3: ck.fft_dct3,
                4: ck.fft_dct4}


def r2r_lines_p(x: torch.Tensor, type: int, dst: bool,
                scale: float = 1.0) -> torch.Tensor:
    """Unnormalized DCT (``dst``: DST) of ``type`` of real (B, n) lines,
    times ``scale``, in the kernel `r2r_route` names (the kernel's wrapper
    raises where it names none); a view at an odd float is copied, as the
    even-n `fft_dct4` reads float2 pairs."""
    _check_dtype(x)
    return _R2R_KERNELS[type](_aligned(x), dst, scale)


# ---------------------------------------------------------------------------
# Fused convolution: the counterparts of the JAX package's entry points
# (``pallas_engine.py:2392, 4532, 4874-4925``).  ``table`` is the kernel's
# spectrum as `conv_spectrum` makes it, an unscaled (L, 2) float32 tensor on
# the planes' device; ``scale`` rides the inverse stages (after the
# multiply, so after the cross-power normalization too).  ``donate=True``
# lets the kernel write over the caller's planes.  float16 / bfloat16 planes
# run every mode on the half instantiations of its kernels (the table, the
# stages and the multiply fp32) and come back at their dtype, as the JAX
# package's fused kernels keep theirs.
# ---------------------------------------------------------------------------

def conv_route(config, kernel_ndim: int) -> Optional[str]:
    """The fused mode that runs a convolution of ``config`` with a
    spectrum of ``kernel_ndim`` dims on this engine, or None where the
    composition runs: the convolution counterpart of `route`.  The JAX
    package's conditions on every fused form (every axis DIRECT, one
    kernel, coordinate_features 1 or m), then the port's own gates, in this
    order: "v3_1d" where `fft_conv`'s stages take n; "v2_2k" where they do
    not but `fft_twofactor` does, without conjugated data or cross-power;
    "pair" for N-D where the (ny, nz) plane fits a cluster of
    `fft_conv_pair`; "v3_rows" for N-D where it does not but `fft_conv`
    takes the last axis; "v3_mat" for 1-D m x m where
    `conv_matrix_supports` holds.

    Zero-pad windows do not change the mode.  The "pair" mode elides prefix
    windows in its kernels (`ConvolutionApplication._pair_windows`); every
    other window, and every window of the other modes, is a mask around
    the fused call.  Where the JAX package falls back to its composition
    under an output window (an output window off the minor pair's
    prefixes, or any output window off the pair mode,
    ``vkfft_tpu/transforms/conv.py:137-158, 189-190``), the port keeps its
    fused mode and masks: the values agree."""
    m, shape = config.matrix_convolution, config.shape
    ndim, n = len(shape), shape[-1]
    if (config.number_kernels != 1 or config.coordinate_features not in (1, m)
            or any(plan_axis(s).algorithm is not Algorithm.DIRECT
                   for s in shape)):
        return None
    if m > 1:
        return ("v3_mat" if ndim == 1 and kernel_ndim == 3
                and ck.conv_matrix_supports(n, m) else None)
    if kernel_ndim != ndim:
        return None
    if ndim == 1:
        if ck.kernel_supports(n):
            return "v3_1d"
        plain = not (config.conjugate_convolution == 2
                     or config.cross_power_spectrum_normalization)
        return "v2_2k" if ck.twofactor_supports(n) and plain else None
    if ck.pair_cluster(shape[-2], n) is not None:
        return "pair"
    return "v3_rows" if ck.kernel_supports(n) else None


def conv_spectrum(kernel_f: Planar, conj: bool = False,
                  swapped: bool = False) -> torch.Tensor:
    """The fused entries' table: the spectrum ``kernel_f`` raveled in its
    own order (with ``swapped``, one line in `fft_twofactor`'s swapped
    order, for `conv_fused_planar`), conjugated with ``conj``, as an
    unscaled (L, 2) float32 tensor on its device."""
    re = kernel_f.re.to(torch.float32)
    im = kernel_f.im.to(torch.float32)
    if swapped:
        re, im = ck.swapped_order(re.reshape(-1)), ck.swapped_order(
            im.reshape(-1))
    return torch.stack([re.reshape(-1), -im.reshape(-1) if conj
                        else im.reshape(-1)], -1).contiguous()


def _check_conv(x: Planar, lines: tuple, table: torch.Tensor,
                points: int, what: str) -> None:
    if x.shape[1:] != lines:
        raise ValueError(f"{what}: planes must be (B, *{lines}), got "
                         f"{x.shape}")
    if table.shape[0] != points:
        raise ValueError(f"{what}: a spectrum of {points} points, got "
                         f"{table.shape[0]}")


def _conv_lines(x: Planar, table: torch.Tensor, conj_data: bool, xpow: bool,
                scale: float, donate: bool) -> Planar:
    _check_dtype(x, _storage)
    x = x.contiguous()
    return Planar(*ck.fft_conv(x.re, x.im, table,
                               out=(x.re, x.im) if donate else None,
                               conj_data=conj_data, xpow=xpow, scale=scale))


def conv_fused_v3(x: Planar, n: int, table: torch.Tensor,
                  scale: float = 1.0, conj_data: bool = False,
                  xpow: bool = False, donate: bool = False) -> Planar:
    """Circular convolution of (B, n) lines with a kernel whose spectrum is
    the (n, 2) ``table``, times ``scale``, in one `fft_conv` launch
    (``pallas_engine.py:4874 conv_fused_v3``)."""
    _check_conv(x, (n,), table, n, "conv_fused_v3")
    return _conv_lines(x, table, conj_data, xpow, scale, donate)


def conv_fused_v3_rows(x: Planar, n: int, rows: int, table: torch.Tensor,
                       scale: float = 1.0, conj_data: bool = False,
                       xpow: bool = False, donate: bool = False) -> Planar:
    """The last-axis pass of an N-D convolution: (B, n) lines, line j times
    row j % rows of the (rows * n, 2) ``table``, in one `fft_conv` launch
    (``pallas_engine.py:4892 conv_fused_v3_rows``, whose table is the (n,
    rows) transpose)."""
    _check_conv(x, (n,), table, rows * n, "conv_fused_v3_rows")
    return _conv_lines(x, table, conj_data, xpow, scale, donate)


def conv_fused_v3_matrix(x: Planar, n: int, m: int, table: torch.Tensor,
                         scale: float = 1.0, conj_data: bool = False,
                         xpow: bool = False, donate: bool = False) -> Planar:
    """Matrix convolution of (B, m, n) planes with the (m, m, n) spectrum
    ``table``: out[:, o] = ifft(sum_i table[o, i] * fft(x[:, i])), in one
    `fft_conv` launch (``pallas_engine.py:4909 conv_fused_v3_matrix``)."""
    _check_conv(x, (m, n), table, m * m * n, "conv_fused_v3_matrix")
    return _conv_lines(x, table, conj_data, xpow, scale, donate)


def conv_fused_pair(x: Planar, ny: int, nz: int, table: torch.Tensor,
                    scale: float, conj_data: bool = False, xpow: bool = False,
                    donate: bool = False, in_keep=None,
                    out_keep=None) -> Planar:
    """Circular convolution over the two minor axes of (..., ny, nz) planes
    in one `fft_conv_pair` launch (``pallas_engine.py:2392
    conv_fused_pair``): ``table`` holds the (ny, nz) spectrum or (hp, ny,
    nz) per-slice spectra in natural order (the TPU's is the (nz, ny)
    transpose), plane b of the flattened batch multiplied by spectrum b %
    hp.

    Zero-pad corners (the reference's ``in_keep`` / ``out_keep``): with
    ``in_keep`` = (ky, kz) only that corner of each plane is read, the
    rest declared zero (the planes may be (..., ny, nz) or the corner
    itself, a view read in place); with ``out_keep`` = (oy, oz) only that
    corner is written, (..., oy, oz) planes; 0 for an axis without a keep
    (the 2-D mode's windowed entry)."""
    _check_dtype(x, _storage)
    shape = x.shape
    ky, kz = in_keep or (0, 0)
    oy, oz = out_keep or (0, 0)
    if (ky, kz, oy, oz) != (0, 0, 0, 0):
        if shape[-2] not in (ny, ky) or shape[-1] not in (nz, kz):
            raise ValueError(f"minor axes are {shape[-2:]}, not {(ny, nz)} "
                             f"or the ({ky}, {kz}) corner")
        x = _one_layout(x)
        lead = ck.merged_dims(shape[:-2], x.re.stride()[:-2])
        if len(lead) > 1:   # planes of more than one stride
            x = x.contiguous()
            lead = ck.merged_dims(shape[:-2], x.re.stride()[:-2])
        dims = (lead or [(1, 0)]) + [(shape[-2], x.re.stride(-2)),
                                     (shape[-1], x.re.stride(-1))]
        rr, ii = ck.fft_conv_pair(*_views(x, dims), table,
                                  conj_data=conj_data, xpow=xpow, scale=scale,
                                  in_keep=(ky, kz), out_keep=(oy, oz),
                                  plane=(ny, nz))
        out = shape[:-2] + (oy or ny, oz or nz)
        return Planar(rr.reshape(out), ii.reshape(out))
    if shape[-2:] != (ny, nz):
        raise ValueError(f"minor axes are {shape[-2:]}, not {(ny, nz)}")
    x = x.contiguous()
    xr = x.re.reshape(-1, ny, nz)
    xi = x.im.reshape(-1, ny, nz)
    rr, ii = ck.fft_conv_pair(xr, xi, table, out=(xr, xi) if donate else None,
                              conj_data=conj_data, xpow=xpow, scale=scale)
    return Planar(rr.reshape(shape), ii.reshape(shape))


def conv_fused_planar(x: Planar, n: int, table: torch.Tensor,
                      donate: bool = False) -> Planar:
    """Circular convolution of (B, n) lines with the kernel whose spectrum
    is ``table`` (`conv_spectrum` with ``swapped``), normalized by 1/n, for
    the lengths `fft_twofactor` holds: the forward in swapped order, then
    the multiply and the inverse in `fft_conv_inv` (``pallas_engine.py:4532
    conv_fused_planar``, as `_rader_p` runs its second branch)."""
    _check_conv(x, (n,), table, n, "conv_fused_planar")
    _check_dtype(x, _storage)
    x = x.contiguous()
    fr, fi = ck.fft_twofactor(x.re, x.im, swapped=True,
                              out=(x.re, x.im) if donate else None)
    return Planar(*ck.fft_conv_inv(fr, fi, table, out=(fr, fi),
                                   scale=1.0 / n))
