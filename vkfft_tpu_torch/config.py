"""User-facing configuration — the analog of ``VkFFTConfiguration``, copied
from ``vkfft_tpu/config.py`` so that the port imports nothing of the JAX
package, plus `config_from_reference`.

The reference exposes one ~100-field plain-C struct with
"only nonzero fields override defaults" semantics
(``vkFFT_Structs/vkFFT_Structs.h:93-324``, defaulting in
``setConfigurationVkFFT``, ``vkFFT_InitializeApp.h:428+``).  Here the same
surface is a frozen dataclass with explicit Optional fields; anything left at
its default is defaulted by the planner.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence


class Precision(enum.Enum):
    """Compute/storage precision tiers (reference flags ``halfPrecision``,
    ``doublePrecision``, ``quadDoubleDoublePrecision`` etc.,
    ``vkFFT_Structs.h:187-199``).

    On TPU: SINGLE is fp32 (MXU 6-pass), DOUBLE is double-double of fp32
    pairs in-kernel with fp64 host LUTs (there is no fp64 unit), HALF/BF16
    are storage-only modes computing in fp32 (mirrors
    ``halfPrecisionMemoryOnly``)."""

    SINGLE = "single"
    DOUBLE = "double"
    HALF = "half"            # fp16 storage, fp32 compute
    BFLOAT16 = "bfloat16"    # bf16 storage, fp32 compute


class TransformKind(enum.Enum):
    C2C = "c2c"
    R2C = "r2c"    # reference flag performR2C (vkFFT_Structs.h:201)
    DCT = "dct"    # performDCT 1..4 (vkFFT_Structs.h:202)
    DST = "dst"    # performDST 1..4 (vkFFT_Structs.h:203)


@dataclasses.dataclass(frozen=True)
class FFTConfig:
    """Plan-time configuration for one FFT application.

    Field-to-reference mapping (all into ``vkFFT_Structs.h``):
      shape            <- size[VKFFT_MAX_FFT_DIMENSIONS] + FFTdim (:147-150)
      fft_axes         <- omitDimension inverted (:230)
      kind/rr_type     <- performR2C/performDCT/performDST (:201-203)
      precision        <- halfPrecision/doublePrecision/... (:187-199)
      normalize        <- normalize (:219)
      zeropad_input    <- performZeropadding + fft_zeropad_left/right (:204-206)
      zeropad_output   <- frequencyZeroPadding (:207)
      convolution_*    <- performConvolution & friends (:209-218, :252-260)
      batch            <- numberBatches (:152)
      keep_intermediate_order <- disableReorderFourStep (:221)
    """

    shape: tuple[int, ...]
    kind: TransformKind = TransformKind.C2C
    rr_type: int = 2                      # DCT/DST type 1..4 when kind is DCT/DST
    precision: Precision = Precision.SINGLE
    fft_axes: Optional[tuple[int, ...]] = None   # None -> all axes
    normalize: bool = False               # True: inverse scales by 1/N (numpy-style)
    # Zero padding, VkFFT convention (fft_zeropad_left/right,
    # vkFFT_Structs.h:204-206): the per-axis (left, right) window declares
    # the index range [left, right) as ZERO — those reads are elided in the
    # input and/or those writes elided in the output.
    zeropad_input: Optional[tuple[Optional[tuple[int, int]], ...]] = None
    zeropad_output: Optional[tuple[Optional[tuple[int, int]], ...]] = None
    # Fused frequency-domain convolution.
    convolution: bool = False
    coordinate_features: int = 1          # matrix-conv vector length (1..3)
    matrix_convolution: int = 1           # 1 scalar, 2/3 matrix kernel
    symmetric_kernel: bool = False
    number_kernels: int = 1
    conjugate_convolution: int = 0        # 0 none, 1 conj(kernel), 2 conj(data)
    cross_power_spectrum_normalization: bool = False
    batch: int = 1
    keep_intermediate_order: bool = False

    def __post_init__(self):
        if not self.shape:
            raise ValueError("shape must be non-empty")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"invalid shape {self.shape}")
        if self.kind in (TransformKind.DCT, TransformKind.DST) and not 1 <= self.rr_type <= 4:
            raise ValueError(f"DCT/DST type must be 1..4, got {self.rr_type}")

    @property
    def axes(self) -> tuple[int, ...]:
        if self.fft_axes is not None:
            return self.fft_axes
        return tuple(range(len(self.shape)))


# The compute modes of `set_compute_mode` (the JAX package's names,
# ``vkfft_tpu/__init__.py:51-75``), and the one recorded for the process.
COMPUTE_MODES = ("fp32", "fp32_int8", "bf16")
_compute_mode = "fp32"


def set_compute_mode(mode: str) -> None:
    """Select the fp32 tier's compute mode, process-wide, like the
    reference's compile-time precision switches (``vkFFT/vkFFT.h:70-102``):
    ``"fp32"`` (the default), ``"fp32_int8"`` or ``"bf16"``; anything else
    raises ValueError.  The JAX package emulates fp32 products on the
    TPU's matrix unit in several passes (bf16 or int8 digits), or in one
    bf16 pass for ``"bf16"`` (~3e-3); the port's kernels compute in fp32
    on the GPU's vector units whatever the mode, so each mode runs the
    same kernels and meets fp32's ~3e-7, within every mode's contract.
    The mode is recorded and read back by `get_compute_mode`."""
    global _compute_mode
    if mode not in COMPUTE_MODES:
        raise ValueError(f"unknown compute mode: {mode!r} "
                         "(expected fp32 | fp32_int8 | bf16)")
    _compute_mode = mode


def get_compute_mode() -> str:
    """The compute mode `set_compute_mode` recorded ("fp32" by default)."""
    return _compute_mode


def _tuple_tree(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuple_tree(e) for e in v)
    return v


def config_from_reference(fields: dict) -> FFTConfig:
    """Build an ``FFTConfig`` from ``dataclasses.asdict`` of the JAX
    package's ``FFTConfig`` (the state that crosses between the two
    packages: an FFT has no weights).  Enum members of the other package are
    matched by value, so the port never imports it."""
    kw = dict(fields)
    unknown = set(kw) - {f.name for f in dataclasses.fields(FFTConfig)}
    if unknown:
        raise ValueError(f"unknown FFTConfig fields {sorted(unknown)}")
    for key, enum_cls in (("kind", TransformKind), ("precision", Precision)):
        if key in kw:
            kw[key] = enum_cls(getattr(kw[key], "value", kw[key]))
    for key in ("shape", "fft_axes", "zeropad_input", "zeropad_output"):
        if kw.get(key) is not None:
            kw[key] = _tuple_tree(kw[key])
    return FFTConfig(**kw)
