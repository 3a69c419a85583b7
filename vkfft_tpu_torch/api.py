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

Not ported yet, and refused with ``NotImplementedError`` naming the ROADMAP
item: zero-pad windows in `FFTApplication` (of every kind, R2R included)
and keep_intermediate_order.
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


def check_precision_and_order(config: FFTConfig) -> None:
    """The refusals every application of the port shares (the precision
    flags all run: the storage tiers on C2C, the other kinds and
    convolution at the input's dtype, as in the JAX package)."""
    if config.keep_intermediate_order:
        raise NotImplementedError(
            "keep_intermediate_order is ROADMAP queue 1 item 8")


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
    check_precision_and_order(config)
    if config.zeropad_input is not None or config.zeropad_output is not None:
        raise NotImplementedError("zero-pad windows are ROADMAP queue 1 item 8")


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

    def _transform(self, x: Planar, inverse: bool) -> Planar:
        cfg = self.config
        ndim = len(cfg.shape)
        if x.shape[-ndim:] != cfg.shape:
            raise InvalidConfigError(
                f"input trailing shape {x.shape[-ndim:]} != configured "
                f"{cfg.shape}")
        self._check_batch(x, ndim)
        eng = get_engine(self.engine_name or engine_for(x))
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
        lead = x.ndim - ndim
        for i, ax in enumerate(axes):
            x = dd_fft.fft_axis_dd(x, lead + ax, cfg.shape[ax], inverse,
                                   scale if i == len(axes) - 1 else 1.0)
        return x

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
        if (self.config.precision is Precision.DOUBLE
                or isinstance(x, DDComplex)):
            return self._run_double(x, inverse)
        if isinstance(x, Planar):
            storage = STORAGE.get(self.config.precision)
            if storage is not None:
                # the storage tiers narrow the planes (``vkfft_tpu/api.py:
                # 418-423``, reference halfPrecisionMemoryOnly)
                x = x.astype(storage)
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
