"""vkfft_tpu_torch — the port of ``vkfft_tpu`` to PyTorch and CUDA.

The JAX package ``vkfft_tpu`` stays in the repository as the reference; this
package imports nothing of it (nor JAX) and keeps its own copies of the host
modules.  Layer map:
  planner/   — size factorization, algorithm selection, axis plans (copy)
  luts       — host fp64 twiddle/chirp/Rader tables (copy)
  pcomplex   — planar (re, im) torch tensors
  ops/       — torch_engine (plain tensor ops, the CPU path and oracle),
               cuda_kernels (hand-written CUDA kernels for sm_90a, built
               with nvcc at first use) and cuda_engine (dispatch onto them)
  api        — FFTApplication and the functional C2C API
  transforms/ — r2c: rfft/irfft, rfft2/irfft2, rfftn/irfftn;
               r2r: dct/idct/dst/idst/dctn/dstn, types I-IV;
               conv: ConvolutionApplication, fftconvolve
  precision/ — the double-double ("fp64") tier: doubledouble (DD,
               DDComplex, the EFTs), dd_kernel (the fft_dd kernel's host
               side and plain versions), dd_fft (routes, the axis walk,
               fft_dd); FFTApplication runs it under Precision.DOUBLE
               where the fp64 kernels do not take a config
               (api.double_route), and for DDComplex input
Precision.HALF / BFLOAT16 — the storage tiers of C2C: Planar input
narrowed to float16 / bfloat16 planes, every kernel reading and writing
half the bytes and computing in fp32, a Planar of the storage dtype out
(complex tensors and host arrays as under SINGLE); on the card every C2C
length; half real data and half convolution run on the card too (a half
rfft returns the reference's float32 planes, a convolution the data's
dtype); float16's range ends at 65504
keep_intermediate_order — the forward on the kernels' DIRECT lengths
returns a TlSpectrum (1-D, the 2-D pair) or the swapped digit order,
which any application of the config inverts (api module docstring)
set_compute_mode / get_compute_mode — the JAX package's process-wide
compute mode ("fp32", "fp32_int8", "bf16"), recorded; every mode runs
the fp32 kernels
"""
from vkfft_tpu_torch.config import (
    FFTConfig,
    Precision,
    TransformKind,
    config_from_reference,
    get_compute_mode,
    set_compute_mode,
)
from vkfft_tpu_torch.errors import FFTError, FFTResult, error_string
from vkfft_tpu_torch.pcomplex import (
    Planar,
    TlSpectrum,
    from_complex,
    from_numpy_planar,
    planar_table,
    to_complex,
    to_numpy,
)
from vkfft_tpu_torch.api import (
    FFTApplication,
    get_application,
    fft,
    ifft,
    fft2,
    ifft2,
    fftn,
    ifftn,
)
from vkfft_tpu_torch.transforms.r2c import (
    rfft,
    irfft,
    rfft2,
    irfft2,
    rfftn,
    irfftn,
)
from vkfft_tpu_torch.transforms.r2r import (
    dct,
    idct,
    dst,
    idst,
    dctn,
    dstn,
)
from vkfft_tpu_torch import precision
from vkfft_tpu_torch.transforms.conv import (
    ConvolutionApplication,
    convolution_from_reference,
    fftconvolve,
)

__version__ = "0.1.0"


def get_version() -> tuple[int, int, int]:
    """``VkFFTGetVersion`` analog (reference: ``vkFFT/vkFFT.h:109``)."""
    major, minor, patch = (int(v) for v in __version__.split("."))
    return major, minor, patch
