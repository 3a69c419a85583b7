"""Application layer — plan/execute lifecycle, C2C, R2C and R2R.

Port of the C2C, R2C and R2R core of ``vkfft_tpu/api.py``: ``FFTApplication``
plans every transformed axis at construction (``initializeVkFFT``,
``vkFFT_InitializeApp.h:1468``) and its ``forward``/``inverse`` walk the
axes (``VkFFTAppend``, ``vkFFT_RunApp.h:79``), folding the inverse's 1/N
into the last axis pass.  On an engine with a pair kernel
(``pair_supports``) the two minor axes run as one pass.  The R2C kind runs
`transforms.r2c.rfftn`/`irfftn`, the DCT and DST kinds
`transforms.r2r.dctn`/`dstn` forward and `idct`/`idst` axis by axis in
reverse order backward (``_real_transform``, ``api.py:293-330`` of the JAX
package).  The functional API (`fft`, `ifft`, ...) wraps a keyed
application cache.

Engines: ``torch`` (`ops.torch_engine`, plain tensor ops) runs CPU tensors;
``cuda`` (`ops.cuda_engine`, the port's kernels) runs CUDA tensors.  With no
engine named, each call picks by the device of its planes.  Host numpy
input goes to the application's ``device``, ``"cuda"`` unless the caller
asks for ``"cpu"``; without a CUDA device that raises rather than carry on
on the CPU.  Host input becomes float32 planes, the SINGLE precision of
every configuration the port takes (as the JAX package narrows it,
``vkfft_tpu/api.py:804-808``); ``Planar`` and tensor input keep their dtype.

Convolution configs run in `transforms.conv.ConvolutionApplication`, as in
the JAX package; `apply_zeropad` is the zero-pad mask it applies.

``Precision.DOUBLE`` on the C2C kind takes one of two routes, decided
once from the plan by `double_route` (the JAX package's rule, the card
having complex dtypes: native complex128 where the backend has them,
``vkfft_tpu/api.py:50-53``, ``:393``):

* ``"native"``: where every transformed axis runs on the fp64 kernels
  (`cuda_engine.f64_supports`: n <= 4, or DIRECT lengths of `fft_lines`),
  complex tensors (widened to complex128), float64 `Planar` planes and
  host data (as complex128 on ``device``) run the ordinary C2C walk at
  fp64: the fp64 instantiations of `fft_lines`, `fft_strided` and
  `fft_pair` on the card, the plain engine on the CPU.  They come back
  complex128, float64 planes and numpy complex128.
* ``"dd"``: every other length runs the double-double tier (`precision`,
  the JAX package's "fp64" path on its complex-free TPU,
  ``vkfft_tpu/api.py:393-416``), the same forms coming back the same
  way (``_coerce_double``, ``api.py:745-779``); the inverse's 1/N rides
  the last pass as an exactly split dd scale.

`DDComplex` quad planes always run the dd tier and give `DDComplex`;
float32 `Planar` planes under DOUBLE are widened with lo = 0 and run it
too.  Under SINGLE, float64 planes and complex128 tensors keep their
dtype: the fp64 kernels where `f64_supports` holds, the cuda engine's
refusal elsewhere.

``Precision.HALF`` and ``Precision.BFLOAT16`` on the C2C kind are the
storage tiers (the reference's ``halfPrecisionMemoryOnly``,
``vkfft_tpu/api.py:418-423``): a `Planar` input is narrowed to float16 /
bfloat16 planes (round to nearest even) before the walk, every kernel
reads and writes those planes (half the bytes of fp32) and computes in
fp32, each scale rides a pass in fp32, and the result is a `Planar` of
the storage dtype.  On the card the walk runs the half-storage
instantiations of the kernels of every C2C route, at every length the
fp32 tier runs (`cuda_engine.storage_supports`): DIRECT, Rader,
Bluestein, SPLIT and the long tier, the glue between their kernels in
fp32, narrowed once.  The CPU runs every length, widening each axis pass
to fp32.  Complex tensors and host arrays are not
`Planar`, so the flag leaves them as under SINGLE (complex64 in and
out), as the JAX package's non-`Planar` path does; float16 / bfloat16
`Planar` planes under SINGLE run at their storage dtype too.  float16
tops out at 65504: an unnormalized forward spectrum past it is inf, the
tier's own limit, as in the reference.  The normalized inverse of half
planes scales each pass by its own axes' 1/n (where fp32 folds the whole
1/N into the last pass), so its intermediates stay at the forward's
magnitude: with the whole 1/N last, the first pass of a 256^3 cube's
inverse reached 256 times the forward's bins, past float16's range.  The
same holds inside one axis: each upload of the long tier's inverse, and
the first factor's pass of SPLIT's, takes its own factor's 1/n_k
(`cuda_engine._pass_scales`); the unnormalized first upload of a 2^26
line's inverse would grow a unit-variance spectrum (~8192 sigma) past
65504.

The R2C, DCT/DST and convolution kinds ignore the precision flag and run
at the input's dtype, as the JAX package's do (``_real_transform``,
``api.py:293-330``; ``ConvolutionApplication``): float32 input on the
fp32 kernels, float64 on the CPU's plain engine (the cuda engine refuses
it, ROADMAP queue 1 item 10).

Zero-pad windows (``zeropad_input`` / ``zeropad_output``, the reference's
``vkFFT_Zeropad.h``) run on both engines, routed once per engine and
dtype by `FFTApplication._resolve_zeropad_route` (``zeropad_mode`` reports
it in the JAX package's words): on the cuda engine the C2C prefix and
interior windows its kernels elide run the windowed entries of
`fft_lines`, `fft_twofactor`, `fft_strided` and `fft_pair` (routes
``v3``, ``v2``, ``interior``, ``pair``, ``pair_out``, ``axes``: the
declared-zero input never read, the declared-zero output written as zeros
or restored once at the end); every other window, the torch engine, the
R2C/DCT/DST kinds (the forward's input window only, as in the JAX
package) and DOUBLE (both its routes, the dd tier's hi and lo planes
alike, where the JAX package's dd tier ignores the windows) mask.

``keep_intermediate_order`` (the reference's ``disableReorderFourStep``,
``vkFFT_Structs.h:221``) follows the JAX package's branches
(``vkfft_tpu/api.py:355-477``), decided by `FFTApplication._keep_order`:
on the cuda engine, for `Planar` input of a C2C config without zero-pad
windows, under SINGLE and the storage tiers (DOUBLE returns first, as the
reference's dd tier does), the forward of a 1-D transform of the minor
axis whose DIRECT length runs in `fft_lines` (or is 2..4) returns a
`TlSpectrum` of its lines in that kernel's swapped digit order (natural at
one pass and n <= 4); one of a length the JAX package's v2 kernel takes
(`fft_twofactor`'s) returns, both ways, a plain `Planar` in the swapped
order of ``split_lane_major`` (`cuda_kernels.split_lane_major`), the
inverse reading that order; the forward of a 2-D pair of DIRECT axes
(`cuda_engine.pair_supports`) returns a `TlSpectrum` of transposed (...,
nz, ny) planes.  The inverse of any application of the same config takes
a `TlSpectrum` back to natural order (a mismatched config raises
`InvalidConfigError`).  Every other case (the torch engine, complex
tensors and host arrays, the R2C/DCT/DST kinds, DOUBLE, windowed configs,
other lengths and axes) ignores the flag and returns the natural result,
as the JAX package does; `ConvolutionApplication` ignores it too.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from vkfft_tpu_torch.config import FFTConfig, Precision, TransformKind
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.pcomplex import (
    Planar,
    TlSpectrum,
    from_complex,
    from_numpy_planar,
    to_complex,
    to_numpy,
)
from vkfft_tpu_torch.planner.plan import AxisPlan, plan_axis
from vkfft_tpu_torch.precision import dd_fft
from vkfft_tpu_torch.precision.doubledouble import (
    DD,
    DDComplex,
    dd_to_f64,
    ddc_from_complex128,
    ddc_to_complex128,
)

ENGINES = ("torch", "cuda")


def get_engine(name: str):
    """Engine registry: 'torch' plain tensor ops, 'cuda' the kernels."""
    if name == "torch":
        from vkfft_tpu_torch.ops import torch_engine
        return torch_engine
    if name == "cuda":
        from vkfft_tpu_torch.ops import cuda_engine
        return cuda_engine
    raise InvalidConfigError(f"unknown engine {name!r}")


def engine_for(x: Planar) -> str:
    """The engine for planes on their device."""
    return "cuda" if x.device.type == "cuda" else "torch"


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: host input goes to device='cuda' by default; "
            "pass device='cpu' to run on the CPU")
    return dev


# The storage dtype of each storage tier (C2C `Planar` input).
STORAGE = {Precision.HALF: torch.float16, Precision.BFLOAT16: torch.bfloat16}


def double_route(config: FFTConfig) -> str:
    """The route of a C2C config under DOUBLE, from its plans before any
    launch and whatever device the data lies on: ``"native"`` where every
    transformed axis runs on the fp64 kernels
    (`cuda_engine.f64_supports`), else ``"dd"``, the double-double tier.
    `DDComplex` input runs the dd tier either way."""
    from vkfft_tpu_torch.ops import cuda_engine
    return ("native" if cuda_engine.f64_supports(config.shape, config.axes)
            else "dd")


def _check_slice(config: FFTConfig) -> None:
    if config.convolution:
        raise InvalidConfigError(
            "convolution configs are executed by ConvolutionApplication "
            "(vkfft_tpu_torch.ConvolutionApplication, the reference's "
            "performConvolution app pair)")


def _pad_planar_tail(x: Planar, keeps) -> Planar:
    """Zero-pad the trailing dims of a Planar from their kept extents back
    to full size, the declared-zero region restored as literal zeros
    (``vkfft_tpu/api.py:61 _pad_planar_tail``).  ``keeps``: one (kept,
    full) pair per trailing dim (kept 0 = already full)."""
    pad = []
    for kept, full in reversed(keeps):
        pad += [0, full - (kept or full)]
    return Planar(*(torch.nn.functional.pad(t, pad) for t in (x.re, x.im)))


def _prefix_keep_all(spec, shape):
    """(minor_keep, outer_keeps) when every declared-zero window in
    ``spec`` is a to-the-end prefix window (``vkfft_tpu/api.py:73``):
    minor_keep = (ky, kz) for the two minor axes (0 = unwindowed),
    outer_keeps maps outer axis -> kept prefix.  None when any window is
    not in that form."""
    ndim = len(shape)
    minor = [0, 0]
    outer = {}
    any_w = False
    for ax, w in enumerate(spec):
        if w is None:
            continue
        if w[1] != shape[ax] or not (0 < w[0] < shape[ax]):
            return None
        if ax >= ndim - 2:
            minor[ax - (ndim - 2)] = w[0]
        else:
            outer[ax] = w[0]
        any_w = True
    return (tuple(minor), outer) if any_w else None


def _pair_prefix_keep(spec, shape):
    """(keep_y, keep_z) when the windows of ``spec`` are prefix windows of
    the two minor axes only, which the pair kernels elide alone
    (``vkfft_tpu/api.py:95``); None otherwise."""
    keeps = _prefix_keep_all(spec, shape)
    if keeps is None or keeps[1]:
        return None
    return keeps[0]


def _mask_real(x, spec, ndim: int):
    """`apply_zeropad` on real data of every form the real kinds take (a
    tensor, host data, or a `Planar`'s planes)."""
    if spec is None:
        return x
    if isinstance(x, Planar):
        return apply_zeropad(x, spec, ndim)
    host = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.asarray(x)) if host else x
    t = apply_zeropad(Planar(t, t), spec, ndim).re
    return t.numpy() if host else t


def _mask_dd(x: DDComplex, spec, ndim: int) -> DDComplex:
    """`apply_zeropad` on double-double quad planes: hi and lo alike."""
    if spec is None:
        return x
    re = apply_zeropad(Planar(x.re.hi, x.re.lo), spec, ndim)
    im = apply_zeropad(Planar(x.im.hi, x.im.lo), spec, ndim)
    return DDComplex(DD(re.re, re.im), DD(im.re, im.im))


def apply_zeropad(x: Planar, spec, ndim: int) -> Planar:
    """Zero the configured [left, right) window of each axis of the
    trailing ``ndim`` axes (``vkfft_tpu/api.py:332 _apply_zeropad``; the
    reference elides those reads, ``vkFFT_Zeropad.h``).  Returns new
    planes; a spec of None returns ``x``."""
    if spec is None:
        return x
    offset = x.ndim - ndim
    for ax, window in enumerate(spec):
        if window is None:
            continue
        left, right = window
        size = x.shape[offset + ax]
        idx = torch.arange(size, device=x.device)
        shape = [1] * x.ndim
        shape[offset + ax] = size
        keep = ((idx < left) | (idx >= right)).reshape(shape)
        x = Planar(torch.where(keep, x.re, 0.0), torch.where(keep, x.im, 0.0))
    return x


def _storages(*ts: torch.Tensor) -> set:
    return {t.untyped_storage().data_ptr() for t in ts}


def owned_by_walk(*caller: torch.Tensor):
    """A test of whether planes are an axis walk's own, so a pass may write
    in place over them: a length-1 axis hands back the caller's planes."""
    theirs = _storages(*caller)
    return lambda y: _storages(y.re, y.im).isdisjoint(theirs)


class FFTApplication:
    """Planned, reusable C2C, R2C or DCT/DST executor for a fixed
    configuration.

    ``engine``: 'torch', 'cuda', or None to pick by the device of each
    call's planes.  ``device``: where host numpy input is placed."""

    def __init__(self, config: FFTConfig, engine: Optional[str] = None,
                 device="cuda"):
        _check_slice(config)
        if engine is not None and engine not in ENGINES:
            raise InvalidConfigError(f"unknown engine {engine!r}")
        self.config = config
        self.engine_name = engine
        self.device = torch.device(device)
        self.axis_plans: dict[int, AxisPlan] = {
            ax: plan_axis(config.shape[ax]) for ax in config.axes
        }
        # DOUBLE's route (`double_route`), decided once from the plans
        self.double_route = (
            double_route(config) if config.precision is Precision.DOUBLE
            and config.kind is TransformKind.C2C else None)
        # the zero-pad route and the kept-order form of each (engine,
        # dtype), resolved once
        self._zp_routes: dict = {}
        self._keep_routes: dict = {}

    def zeropad_route(self, engine: str = "cuda",
                      dtype: torch.dtype = torch.float32) -> dict:
        """The zero-pad route of planes of ``dtype`` on ``engine``
        (`_resolve_zeropad_route`), resolved once and kept."""
        key = (engine, dtype)
        if key not in self._zp_routes:
            self._zp_routes[key] = self._resolve_zeropad_route(engine, dtype)
        return self._zp_routes[key]

    def _resolve_zeropad_route(self, engine: str, dtype: torch.dtype) -> dict:
        """The one zero-pad routing decision (``vkfft_tpu/api.py:132-243``),
        shared by `_transform` and `zeropad_mode`, on the port's own gates:

        * ``none``: no window; ``masked``: an explicit zeroing pass (the
          torch engine, the R2C/DCT/DST kinds, DOUBLE, and every window
          the kernels below do not elide).
        * ``v3`` / ``v2``: 1-D prefix windows on the minor axis of a
          DIRECT plan that `cuda_engine.route` runs in `fft_lines` (v3) or
          `fft_twofactor` (v2), input (``in_h``) and output (``out_h``;
          the JAX package's v2 takes none) kept prefixes.
        * ``interior``: a 1-D interior input window 0 < left < right < n
          on those plans (``window``).
        * ``pair`` / ``pair_out``: N-D prefix windows of the input / the
          output, of at most three axes, every one transformed, the two
          minor axes where `cuda_engine.pair_supports` holds at ``dtype``
          and every other transformed axis DIRECT in `fft_strided`
          (``minor`` = (ky, kz), ``outer`` = {axis: kept}).
        * ``axes``: input prefix windows over every axis of at most three,
          all DIRECT, the minor axis in `fft_lines` or `fft_twofactor`,
          the others in `fft_strided` (``keeps`` = {axis: kept}).
        * ``blu``: Bluestein's read window (``vkfft_tpu/api.py:191-201``),
          an input prefix window alone on the minor axis of a BLUESTEIN
          plan, float32 or half planes: the forward reads the kept prefix
          ``in_h`` only, on every route `cuda_engine.route` gives the plan
          (the windowed entries of `fft_conv`, `fft_conv_pair` and the long
          tier's first `fft_strided_tw`, or the composed routes' chirp over
          the kept points); the inverse runs masked, as the reference's."""
        from vkfft_tpu_torch.ops import cuda_engine as ce
        from vkfft_tpu_torch.ops import cuda_kernels as ck
        from vkfft_tpu_torch.planner.factorize import Algorithm
        cfg = self.config
        zin, zout = cfg.zeropad_input, cfg.zeropad_output
        if zin is None and zout is None:
            return {"kind": "none"}
        if (engine != "cuda" or cfg.kind is not TransformKind.C2C
                or cfg.precision is Precision.DOUBLE):
            return {"kind": "masked"}
        ndim = len(cfg.shape)
        n = cfg.shape[-1]
        plans = self.axis_plans
        axes = set(cfg.axes)

        def windowed(spec):
            return {ax for ax, w in enumerate(spec or ()) if w is not None}

        def prefix(spec):
            """The kept prefix of the minor axis: 0 = unwindowed, -1 = a
            window that is not a to-the-end prefix, or on another axis."""
            if spec is None or not windowed(spec):
                return 0
            if windowed(spec) != {ndim - 1}:
                return -1
            w = spec[-1]
            return w[0] if w[1] == n and 0 < w[0] < n else -1

        def strided(ax):
            p = plans[ax]
            return (p.algorithm is Algorithm.DIRECT
                    and ck.kernel_supports(p.n, dtype))

        if cfg.axes == (ndim - 1,):
            plan = plans[ndim - 1]
            if plan.algorithm is Algorithm.BLUESTEIN:
                in_h, out_h = prefix(zin), prefix(zout)
                if (in_h > 0 and out_h == 0 and ce.supports(plan)
                        and dtype in (torch.float32,)
                        + tuple(STORAGE.values())):
                    return {"kind": "blu", "in_h": in_h}
                return {"kind": "masked"}
            kernel = ce.window_kernel(plan)
            if kernel is None:
                return {"kind": "masked"}
            in_h, out_h = prefix(zin), prefix(zout)
            w = zin[-1] if zin is not None else None
            if (in_h == -1 and out_h == 0 and windowed(zin) == {ndim - 1}
                    and 0 < w[0] < w[1] < n):
                return {"kind": "interior", "window": tuple(w)}
            if in_h >= 0 and out_h >= 0 and (in_h or out_h):
                return {"kind": "v3" if kernel == "fft_lines" else "v2",
                        "in_h": in_h, "out_h": out_h}
            return {"kind": "masked"}
        if len(axes) < 2 or ndim > 3:
            return {"kind": "masked"}
        ay, az = ndim - 2, ndim - 1
        spec = zin if zin is not None else zout
        if ((zin is None) != (zout is None) and {ay, az} <= axes
                and windowed(spec) <= axes
                and ce.pair_supports(cfg.shape[ay], cfg.shape[az], dtype)
                and all(strided(ax) for ax in axes if ax < ay)):
            keeps = _prefix_keep_all(spec, cfg.shape)
            if keeps is not None:
                return {"kind": "pair" if zin is not None else "pair_out",
                        "minor": keeps[0], "outer": keeps[1]}
        if (zout is None and axes == set(range(ndim))
                and ce.window_kernel(plans[az]) is not None
                and all(strided(ax) for ax in range(az))):
            keeps = _prefix_keep_all(zin, cfg.shape)
            if keeps is not None:
                minor, outer = keeps
                kd = dict(outer)
                if minor[0]:
                    kd[ay] = minor[0]
                if minor[1]:
                    kd[az] = minor[1]
                return {"kind": "axes", "keeps": kd}
        return {"kind": "masked"}

    @property
    def zeropad_mode(self) -> Optional[str]:
        """Which strategy the configured zero-pad windows get, in the JAX
        package's words (``vkfft_tpu/api.py:245-276``): 'elided-prefix'
        (the kernel never reads the zero input tail), 'elided-output' (the
        declared-zero spectrum region is never written / read), 'elided-
        prefix+output' (both), 'elided-interior (...)' (the zero middle is
        never read; forward reads, the inverse writing the zeros in its
        store), 'elided-pair' / 'elided-pair-output' (through the fused
        two-axis kernel and the outer axes' strided passes),
        'elided-axes' (each axis pass elides its own window), 'elided-
        prefix (bluestein: forward reads; inverse masked)' (Bluestein's
        read window), or 'masked' (an explicit zeroing pass).  None: no
        window configured.  The route of the application's ``engine``
        (``cuda`` when None) on float32 planes, from the resolver the
        execution path uses."""
        r = self.zeropad_route(self.engine_name or "cuda")
        kind = r["kind"]
        if kind == "none":
            return None
        if kind == "masked":
            return "masked"
        if kind == "interior":
            return "elided-interior (forward reads; inverse in-kernel restore)"
        if kind == "pair":
            return "elided-pair"
        if kind == "pair_out":
            return "elided-pair-output"
        if kind == "axes":
            return "elided-axes"
        if kind == "blu":
            return "elided-prefix (bluestein: forward reads; inverse masked)"
        if r["in_h"] and r["out_h"]:
            return "elided-prefix+output"
        return "elided-output" if r["out_h"] else "elided-prefix"

    def _check_batch(self, x, trailing_ndim: int):
        """Validate the declared batch count (reference ``numberBatches``,
        vkFFT_Structs.h:152): leading dims ahead of the transform block must
        multiply to ``config.batch`` when it is declared (> 1)."""
        if self.config.batch > 1:
            lead = x.shape[: x.ndim - trailing_ndim]
            total = math.prod(lead)
            if total != self.config.batch:
                raise InvalidConfigError(
                    f"configured batch={self.config.batch} but input leading "
                    f"dims {lead} give {total}")

    def keep_order_route(self, engine: str = "cuda",
                         dtype: torch.dtype = torch.float32) -> dict:
        """The form ``keep_intermediate_order`` takes on planes of
        ``dtype`` on ``engine``, resolved once and kept: ``kind`` "pair"
        (the 2-D forward to a `TlSpectrum` of transposed planes), "lines"
        (the 1-D forward to a `TlSpectrum` in the digit order ``split``),
        "v2" (a plain `Planar` in `cuda_kernels.split_lane_major`'s swapped
        order, both ways) or None (the flag is off or ignored: the
        natural walk)."""
        key = (engine, dtype)
        if key not in self._keep_routes:
            self._keep_routes[key] = self._resolve_keep_order(engine, dtype)
        return self._keep_routes[key]

    def _resolve_keep_order(self, engine: str, dtype: torch.dtype) -> dict:
        """The JAX package's branches (``vkfft_tpu/api.py:418-477``) on the
        port's gates: the cuda engine, a C2C config without windows,
        float32 or half planes; the 2-D pair of DIRECT axes where
        `cuda_engine.pair_supports` holds, else the minor axis of a 1-D
        walk by `cuda_engine.keep_order_kernel`."""
        from vkfft_tpu_torch.ops import cuda_engine as ce
        from vkfft_tpu_torch.planner.factorize import Algorithm
        cfg = self.config
        ndim = len(cfg.shape)
        if (not cfg.keep_intermediate_order or engine != "cuda"
                or cfg.kind is not TransformKind.C2C
                or cfg.zeropad_input is not None
                or cfg.zeropad_output is not None
                or dtype not in (torch.float32,) + tuple(STORAGE.values())):
            return {"kind": None}
        if ndim == 2 and len(cfg.axes) == 2:
            if (all(p.algorithm is Algorithm.DIRECT
                    for p in self.axis_plans.values())
                    and ce.pair_supports(*cfg.shape, dtype)):
                return {"kind": "pair"}
            return {"kind": None}
        if cfg.axes != (ndim - 1,):
            return {"kind": None}
        plan = self.axis_plans[ndim - 1]
        kernel = ce.keep_order_kernel(plan)
        if kernel in ("tiny", "fft_lines"):
            return {"kind": "lines", "split": ce.keep_order_split(plan, dtype)}
        return {"kind": "v2" if kernel == "fft_twofactor" else None}

    def _keep_order(self, x: Planar, inverse: bool) -> Optional[Planar]:
        """``keep_intermediate_order`` on `Planar` input (`keep_order_route`):
        the kept-order result where the flag takes effect, else None (the
        natural walk runs)."""
        from vkfft_tpu_torch.ops import cuda_engine as ce
        cfg = self.config
        if not cfg.keep_intermediate_order:
            return None
        ndim = len(cfg.shape)
        kind = self.keep_order_route(self.engine_name or engine_for(x),
                                     x.dtype)["kind"]
        if (kind is None or (inverse and kind != "v2")
                or x.shape[-ndim:] != cfg.shape):
            return None
        self._check_batch(x, ndim)
        if kind == "pair":
            lead = x.shape[:-2]
            y = ce.keep_order_pair_p(x, *cfg.shape, False)
            return TlSpectrum(y.re, y.im, lead, math.prod(lead), *cfg.shape)
        plan = self.axis_plans[ndim - 1]
        n = plan.n
        if kind == "v2":
            # a plain Planar in the swapped order both ways
            s = 1.0 / n if inverse and cfg.normalize else 1.0
            return ce.keep_order_lines_p(x.reshape(-1, n), plan, inverse,
                                         s).reshape(*x.shape)
        lead = x.shape[:-1]
        y = ce.keep_order_lines_p(x.reshape(-1, n), plan, False)
        return TlSpectrum(y.re.reshape(x.shape), y.im.reshape(x.shape), lead,
                          math.prod(lead), n, 0,
                          self.keep_order_route("cuda", x.dtype)["split"])

    def _tl_inverse(self, x: TlSpectrum) -> Planar:
        """The inverse of a `TlSpectrum` from any application of this
        config (``vkfft_tpu/api.py:365-386``), to natural order, normalized
        as ``normalize`` says."""
        from vkfft_tpu_torch.ops import cuda_engine as ce
        cfg = self.config
        ndim = len(cfg.shape)
        p = Planar(x.re, x.im)
        if x.n2:
            ny, nz = x.n, x.n2
            if ndim != 2 or cfg.shape != (ny, nz):
                raise InvalidConfigError(
                    f"TlSpectrum carries pair ({ny}, {nz}) but this "
                    f"application is configured for shape {cfg.shape}")
            s = 1.0 / (ny * nz) if cfg.normalize else 1.0
            return ce.keep_order_pair_p(p, ny, nz, True,
                                        s).reshape(*x.lead, ny, nz)
        n = x.n
        plan = self.axis_plans.get(ndim - 1)
        if (cfg.axes != (ndim - 1,) or cfg.shape[-1] != n
                or ce.keep_order_kernel(plan) not in ("tiny", "fft_lines")
                or tuple(x.split) != ce.keep_order_split(plan, x.dtype)):
            raise InvalidConfigError(
                f"TlSpectrum carries n={n} (digit order {x.split}) but this "
                f"application is configured for shape {cfg.shape}, axes "
                f"{cfg.axes}")
        s = 1.0 / n if cfg.normalize else 1.0
        return ce.keep_order_lines_p(p.reshape(-1, n), plan, True,
                                     s).reshape(*x.lead, n)

    def _transform(self, x: Planar, inverse: bool) -> Planar:
        cfg = self.config
        ndim = len(cfg.shape)
        if x.shape[-ndim:] != cfg.shape:
            raise InvalidConfigError(
                f"input trailing shape {x.shape[-ndim:]} != configured "
                f"{cfg.shape}")
        self._check_batch(x, ndim)
        name = self.engine_name or engine_for(x)
        eng = get_engine(name)
        check_walk = getattr(eng, "check_walk", None)
        if check_walk is not None:
            # refuse an axis the planes' dtype has no kernel for before the
            # first launch
            check_walk(cfg.shape, cfg.axes, x.dtype)
        axes = cfg.axes if not inverse else tuple(reversed(cfg.axes))
        # in-kernel normalization: fold 1/N into the LAST inverse axis pass
        # (reference stageNormalization, ``vkFFT_RadixShuffle.h:49-65``);
        # on half planes each inverse pass takes its own axes' 1/n instead,
        # so no unnormalized intermediate leaves fp16's range (a 256^3
        # cube's first inverse pass reached 256 times the forward's bins)
        norm_scale = 1.0
        if inverse and cfg.normalize:
            for ax in cfg.axes:
                norm_scale /= cfg.shape[ax]
        per_pass = norm_scale != 1.0 and x.dtype in STORAGE.values()

        def scale_of(pass_axes, last: bool) -> float:
            if per_pass:
                return 1.0 / math.prod(cfg.shape[a] for a in pass_axes)
            return norm_scale if last else 1.0

        # zero-pad work elision (reference ``vkFFT_Zeropad.h``; output
        # windows: frequencyZeroPadding, ``vkFFT_Structs.h:264``), routed
        # by the resolver `zeropad_mode` reports
        route = self.zeropad_route(name, x.dtype)
        kind = route["kind"]
        if kind != "masked":
            # the elided walks read corners of the planes in place through
            # one set of strides: planes of two layouts (a transposed im) or
            # interleaved ones (Planar(z.real, z.imag)) are copied once
            x = x.contiguous()
        if kind in ("v3", "v2", "interior"):
            return self._elided_lines(x, eng, route, inverse,
                                      scale_of((ndim - 1,), True))
        if kind == "blu" and not inverse:
            # Bluestein's read window (``vkfft_tpu/api.py:485-501``): the
            # forward reads the kept prefix; the inverse runs the masked
            # walk below, as the reference's does
            n = cfg.shape[-1]
            y = eng.fft_lines_p(x.reshape(-1, n), self.axis_plans[ndim - 1],
                                False, scale=scale_of((ndim - 1,), True),
                                in_keep=route["in_h"])
            return y.reshape(*x.shape)
        if kind in ("pair", "pair_out"):
            return self._elided_pair(x, eng, route, inverse, axes, scale_of)
        if kind == "axes":
            return self._elided_axes(x, eng, route, inverse, axes, scale_of)
        # masked (``vkfft_tpu/api.py:734-742``): the forward's input and
        # output windows, the inverse's result under the input's
        if not inverse:
            x = apply_zeropad(x, cfg.zeropad_input, ndim)
        y = self._walk(x, eng, inverse, axes, scale_of)
        return apply_zeropad(
            y, cfg.zeropad_input if inverse else cfg.zeropad_output, ndim)

    def _walk(self, x: Planar, eng, inverse: bool, axes, scale_of) -> Planar:
        """The axes' passes (``VkFFTAppend``): the two minor axes as one
        pass where the engine's pair kernel takes them, else one pass an
        axis."""
        cfg = self.config
        ndim = len(cfg.shape)
        lead = x.ndim - ndim
        owned = owned_by_walk(x.re, x.im)
        ay, az = ndim - 2, ndim - 1
        pair_ok = getattr(eng, "pair_supports", None)
        if (pair_ok is not None and ay in cfg.axes and az in cfg.axes
                and pair_ok(cfg.shape[ay], cfg.shape[az], x.dtype)):
            # the two minor axes as one pass (reference single-upload 2-D
            # regime, ``vkFFT_Scheduler.h`` numAxisUploads == 1): first in
            # the forward, last (with the 1/N) in the inverse
            ny, nz = cfg.shape[ay], cfg.shape[az]
            rest = [ax for ax in axes if ax < ay]
            if not inverse:
                x = eng.fft_pair_p(x, ny, nz, False)
            for ax in rest:
                x = eng.fft_axis_p(x, lead + ax, self.axis_plans[ax], inverse,
                                   scale=scale_of((ax,), False),
                                   donate=owned(x))
            if inverse:
                x = eng.fft_pair_p(x, ny, nz, True,
                                   scale=scale_of((ay, az), True),
                                   donate=owned(x))
            return x
        for i, ax in enumerate(axes):
            x = eng.fft_axis_p(x, lead + ax, self.axis_plans[ax], inverse,
                               scale=scale_of((ax,), i == len(axes) - 1),
                               donate=owned(x))
        return x

    def _elided_lines(self, x: Planar, eng, route: dict, inverse: bool,
                      scale: float) -> Planar:
        """Routes ``v3``, ``v2`` and ``interior`` (``vkfft_tpu/api.py:
        566-620``): one windowed pass over the minor axis's lines.  v3 /
        v2: the forward reads the input's kept prefix and writes the
        spectrum's, the inverse the mirror (the spectrum's declared-zero
        tail never read); the declared-zero output region is written as
        zeros by the kernel's store.  interior: the forward never reads
        the zero middle, the inverse writes it as zeros."""
        n = self.config.shape[-1]
        plan = self.axis_plans[len(self.config.shape) - 1]
        flat = x.reshape(-1, n)
        if route["kind"] == "interior":
            side = "out_zero_window" if inverse else "in_window"
            y = eng.fft_lines_p(flat, plan, inverse, scale=scale,
                                **{side: route["window"]})
        else:
            ik, ok = ((route["in_h"], route["out_h"]) if not inverse
                      else (route["out_h"], route["in_h"]))
            y = eng.fft_lines_p(flat, plan, inverse, scale=scale, in_keep=ik,
                                out_keep=ok, out_fill=bool(ok))
        return y.reshape(*x.shape)

    def _elided_pair(self, x: Planar, eng, route: dict, inverse: bool, axes,
                     scale_of) -> Planar:
        """Routes ``pair`` and ``pair_out`` (``vkfft_tpu/api.py:622-704``).
        Reads elided (the forward of input windows, the inverse of output
        windows): the outer axes' passes first, on the (ky, kz) corner of
        the planes read in place, then the pair kernel from the corner.
        Writes elided: the pair kernel first, cropping to the corner, the
        outer passes on the corner only, and the zeros restored once at
        the end (`_pad_planar_tail`)."""
        cfg = self.config
        ndim = len(cfg.shape)
        lead = x.ndim - ndim
        ay, az = ndim - 2, ndim - 1
        ny, nz = cfg.shape[ay], cfg.shape[az]
        minor, outer = route["minor"], route["outer"]
        reads = (route["kind"] == "pair") != inverse
        pair_in, outer_in = (minor, outer) if reads else ((0, 0), {})
        pair_out, outer_out = ((0, 0), {}) if reads else (minor, outer)
        rest = [ax for ax in axes if ax < ay]
        pscale = scale_of((ay, az), True)

        def outer_pass(x, ax, **keep):
            return eng.axis_window(x, lead + ax, self.axis_plans[ax], inverse,
                                   scale=scale_of((ax,), False), **keep)

        def refill(x):
            return _pad_planar_tail(
                x, [(outer_out.get(ax, 0), cfg.shape[ax]) for ax in range(ay)]
                + [(pair_out[0], ny), (pair_out[1], nz)])

        ky, kz = pair_in[0] or ny, pair_in[1] or nz
        if reads and rest and (ky < ny or kz < nz):
            x = x[..., :ky, :kz]
            for ax in rest:
                x = outer_pass(x, ax, in_keep=outer_in.get(ax, 0))
            return eng.fft_pair_p(x, ny, nz, inverse, scale=pscale,
                                  in_keep=pair_in)
        if not reads and rest:
            x = eng.fft_pair_p(x, ny, nz, inverse, scale=pscale,
                               out_keep=pair_out)
            for ax in rest:
                x = outer_pass(x, ax, out_keep=outer_out.get(ax, 0))
            return refill(x)
        if not inverse:
            x = eng.fft_pair_p(x, ny, nz, False, in_keep=pair_in,
                               out_keep=pair_out)
            for ax in rest:
                x = outer_pass(x, ax, in_keep=outer_in.get(ax, 0))
            return x if reads else refill(x)
        for ax in rest:
            x = outer_pass(x, ax, in_keep=outer_in.get(ax, 0),
                           out_keep=outer_out.get(ax, 0))
        x = eng.fft_pair_p(x, ny, nz, True, scale=pscale, in_keep=pair_in,
                           out_keep=pair_out)
        return x if reads else refill(x)

    def _elided_axes(self, x: Planar, eng, route: dict, inverse: bool, axes,
                     scale_of) -> Planar:
        """Route ``axes`` (``vkfft_tpu/api.py:690-733``): each axis pass
        elides its own window.  The forward runs minor-first on the corner
        of every windowed non-minor axis, read in place, so each pass
        transforms only the lines the later passes keep, and each pass
        re-expands its own axis; the inverse runs outer-first, each pass
        writing only its axis's kept prefix, and the zeros are restored
        once at the end."""
        cfg = self.config
        ndim = len(cfg.shape)
        lead = x.ndim - ndim
        keeps = route["keeps"]
        order = tuple(reversed(axes))
        if not inverse:
            sl = [slice(None)] * x.ndim
            for a, k in keeps.items():
                if a != ndim - 1:
                    sl[lead + a] = slice(0, k)
            x = x[tuple(sl)]
        for i, ax in enumerate(order):
            k = keeps.get(ax, 0)
            x = eng.axis_window(
                x, lead + ax, self.axis_plans[ax], inverse,
                scale=scale_of((ax,), i == len(order) - 1),
                in_keep=0 if inverse else k, out_keep=k if inverse else 0)
        if inverse:
            x = _pad_planar_tail(
                x, [(keeps.get(a, 0), cfg.shape[a]) for a in range(ndim)])
        return x

    def _real_transform(self, x, inverse: bool):
        """R2C, DCT and DST execution (``_real_transform``,
        ``vkfft_tpu/api.py:293-330``).  R2C: the forward takes real data of
        the configured shape and returns the half spectrum along the last
        configured axis; the inverse takes that spectrum and returns real
        data, normalized by 1/N whatever ``normalize`` says, as the JAX
        package's R2C inverse is.  DCT/DST of ``rr_type``: real data of the
        configured shape both ways, the forward unnormalized, the inverse
        the exact inverse (`r2r.idct`/`idst` per axis)."""
        from vkfft_tpu_torch.transforms import r2c, r2r
        cfg = self.config
        ndim = len(cfg.shape)
        if not isinstance(x, (Planar, torch.Tensor)):
            x = np.asarray(x)
        # negative axes relative to the trailing transform block, so leading
        # batch dims pass through
        axes = tuple(a - ndim for a in cfg.axes)
        last = cfg.axes[-1]
        want = list(cfg.shape)
        r2c_kind = cfg.kind is TransformKind.R2C
        if inverse and r2c_kind:
            want[last] = cfg.shape[last] // 2 + 1
        if tuple(x.shape[-ndim:]) != tuple(want):
            raise InvalidConfigError(
                f"{cfg.kind.value.upper()} "
                f"{'inverse' if inverse else 'forward'} input trailing "
                f"shape {tuple(x.shape[-ndim:])} != {tuple(want)}")
        self._check_batch(x, ndim)
        kw = dict(engine=self.engine_name, device=self.device)
        if not inverse:
            # the forward's input window only, as the JAX package's real
            # kinds mask (``vkfft_tpu/api.py:311-312``, ``:325-326``); the
            # output window is not applied there either
            x = _mask_real(x, cfg.zeropad_input, ndim)
        if r2c_kind:
            if not inverse:
                return r2c.rfftn(x, axes=axes, **kw)
            return r2c.irfftn(x, s=tuple(cfg.shape[a] for a in cfg.axes),
                              axes=axes, **kw)
        dct = cfg.kind is TransformKind.DCT
        if not inverse:
            return (r2r.dctn if dct else r2r.dstn)(x, type=cfg.rr_type,
                                                   axes=axes, **kw)
        inv = r2r.idct if dct else r2r.idst
        y, kind = r2r.real_input(x, self.device, cfg.kind.value)
        for a in reversed(axes):
            y = inv(y, type=cfg.rr_type, axis=a, engine=self.engine_name)
        return r2r.real_output(y, kind)

    def _transform_dd(self, x, inverse: bool):
        """The DOUBLE walk on `DDComplex` planes: the axes in ``cfg.axes``
        order, reversed for the inverse, the 1/N on the last pass longer
        than 1 (``vkfft_tpu/api.py:393-416``)."""
        cfg = self.config
        ndim = len(cfg.shape)
        if tuple(x.shape[-ndim:]) != cfg.shape:
            raise InvalidConfigError(
                f"input trailing shape {tuple(x.shape[-ndim:])} != "
                f"configured {cfg.shape}")
        self._check_batch(x, ndim)
        axes = [ax for ax in (reversed(cfg.axes) if inverse else cfg.axes)
                if cfg.shape[ax] > 1]
        scale = 1.0
        if inverse and cfg.normalize:
            scale = 1.0 / math.prod(cfg.shape[ax] for ax in cfg.axes)
        x = x.contiguous()
        if not inverse:
            x = _mask_dd(x, cfg.zeropad_input, ndim)
        lead = x.ndim - ndim
        for i, ax in enumerate(axes):
            x = dd_fft.fft_axis_dd(x, lead + ax, cfg.shape[ax], inverse,
                                   scale if i == len(axes) - 1 else 1.0)
        # the windows masked as on the other tiers (the JAX package's dd
        # tier returns before its masks, ``vkfft_tpu/api.py:391-416``)
        return _mask_dd(
            x, cfg.zeropad_input if inverse else cfg.zeropad_output, ndim)

    def _run_double(self, x, inverse: bool):
        """DOUBLE on every input form (see the module docstring): the
        route of `double_route`, `DDComplex` and float32 `Planar` on the
        dd tier.  On the dd tier the planes' device picks kernel or plain
        versions, whatever ``engine`` says."""
        if isinstance(x, DDComplex):
            return self._transform_dd(x, inverse)
        native = self.double_route == "native"
        if isinstance(x, Planar):
            if x.dtype == torch.float32:
                lo = torch.zeros_like(x.re)
                return self._transform_dd(
                    DDComplex(DD(x.re, lo), DD(x.im, lo)), inverse)
            if x.dtype != torch.float64:
                raise InvalidConfigError(
                    f"DOUBLE takes float32 or float64 Planar planes, got "
                    f"{x.dtype}")
            if native:
                return self._transform(x, inverse)
            y = self._transform_dd(
                ddc_from_complex128(torch.complex(x.re, x.im)), inverse)
            return Planar(dd_to_f64(y.re), dd_to_f64(y.im))
        if isinstance(x, torch.Tensor):
            if not x.is_complex():
                raise InvalidConfigError(
                    "DOUBLE takes complex tensors, Planar or DDComplex planes")
            x = x.to(torch.complex128)
            if native:
                return to_complex(self._transform(from_complex(x), inverse))
            return ddc_to_complex128(
                self._transform_dd(ddc_from_complex128(x), inverse))
        xh = np.asarray(x, np.complex128)
        dev = resolve_device(self.device)
        if native:
            p = from_numpy_planar(xh.real, xh.imag, dev)
            return to_numpy(self._transform(p, inverse))
        xd = ddc_from_complex128(xh, dev)
        return ddc_to_complex128(self._transform_dd(xd, inverse)).cpu().numpy()

    def _run(self, x, inverse: bool):
        if self.config.kind is not TransformKind.C2C:
            return self._real_transform(x, inverse)
        if inverse and isinstance(x, TlSpectrum):
            # the kept-order form goes back whatever the precision says,
            # its contract riding the value (``vkfft_tpu/api.py:365-386``)
            return self._tl_inverse(x)
        if (self.config.precision is Precision.DOUBLE
                or isinstance(x, DDComplex)):
            return self._run_double(x, inverse)
        if isinstance(x, Planar):
            storage = STORAGE.get(self.config.precision)
            if storage is not None:
                # the storage tiers narrow the planes (``vkfft_tpu/api.py:
                # 418-423``, reference halfPrecisionMemoryOnly)
                x = x.astype(storage)
            y = self._keep_order(x, inverse)
            if y is not None:
                return y
            return self._transform(x, inverse)
        if isinstance(x, torch.Tensor):
            return to_complex(self._transform(from_complex(x), inverse))
        p = from_complex(np.asarray(x), resolve_device(self.device))
        return to_numpy(self._transform(p, inverse))

    def forward(self, x):
        """``VkFFTAppend(app, -1, ...)`` analog.  Takes a ``Planar`` (result
        a ``Planar`` on the same device), a torch tensor (result a complex
        tensor on its device) or a host array (placed on ``device``, result
        a numpy complex array); under DOUBLE, or for `DDComplex` input, the
        double-double tier's forms (module docstring).  R2C: real data in
        (a ``Planar``'s real plane), the half spectrum out.  DCT/DST: real
        data in and out (a tensor, or a numpy array for host input)."""
        return self._run(x, False)

    def inverse(self, x):
        """``VkFFTAppend(app, 1, ...)`` analog (inverse transform).  R2C:
        the half spectrum in, real data out (a tensor, or a numpy array
        for host input)."""
        return self._run(x, True)


# ---------------------------------------------------------------------------
# Functional numpy-style façade with an application cache.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def _cached_app(config: FFTConfig, engine: Optional[str],
                device: str) -> FFTApplication:
    return FFTApplication(config, engine=engine, device=device)


def get_application(config: FFTConfig, engine: Optional[str] = None,
                    device="cuda") -> FFTApplication:
    return _cached_app(config, engine, str(torch.device(device)))


def fftn(x, axes=None, engine: Optional[str] = None, inverse: bool = False,
         normalize: Optional[bool] = None, device="cuda"):
    """N-D complex-to-complex DFT over ``axes`` (default all).  Accepts a
    ``Planar``, a torch tensor, or a host array (placed on ``device``);
    returns the same kind.  The inverse is normalized by default."""
    if not isinstance(x, (Planar, torch.Tensor)):
        x = np.asarray(x)
    ndim = len(x.shape)
    if axes is None:
        axes = tuple(range(ndim))
    else:
        axes = tuple(a % ndim for a in (axes if isinstance(axes, (tuple, list))
                                        else (axes,)))
    if not axes:
        # numpy's fftn over no axes: the input, in the form a transform
        # returns it
        if isinstance(x, Planar):
            return x
        if isinstance(x, torch.Tensor):
            return to_complex(from_complex(x))
        return to_numpy(from_complex(x, resolve_device(device)))
    # the configuration covers the trailing block of dims holding every
    # transformed axis; leading dims are batch
    lead = min(axes)
    cfg = FFTConfig(shape=tuple(x.shape[lead:]),
                    fft_axes=tuple(a - lead for a in axes),
                    normalize=True if normalize is None else normalize)
    app = get_application(cfg, engine, device)
    return app.inverse(x) if inverse else app.forward(x)


def fft(x, axis: int = -1, engine: Optional[str] = None, device="cuda"):
    """1-D forward DFT along ``axis`` (unnormalized, numpy convention)."""
    return fftn(x, axes=(axis,), engine=engine, device=device)


def ifft(x, axis: int = -1, engine: Optional[str] = None, device="cuda"):
    """1-D inverse DFT along ``axis`` (normalized by 1/n)."""
    return fftn(x, axes=(axis,), engine=engine, inverse=True, device=device)


def fft2(x, axes=(-2, -1), engine: Optional[str] = None, device="cuda"):
    return fftn(x, axes=axes, engine=engine, device=device)


def ifft2(x, axes=(-2, -1), engine: Optional[str] = None, device="cuda"):
    return fftn(x, axes=axes, engine=engine, inverse=True, device=device)


def ifftn(x, axes=None, engine: Optional[str] = None, device="cuda"):
    return fftn(x, axes=axes, engine=engine, inverse=True, device=device)
