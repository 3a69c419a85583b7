"""The double-double ("fp64") tier: `DDComplex` quad planes, the EFTs,
and `fft_dd` (port of ``vkfft_tpu/precision``).  `FFTApplication` runs
it under ``Precision.DOUBLE``."""
from vkfft_tpu_torch.precision.doubledouble import (
    DD,
    DDComplex,
    dd_add,
    dd_from_f64,
    dd_mul,
    dd_neg,
    dd_sub,
    dd_to_f64,
    ddc_from_complex128,
    ddc_from_reference,
    ddc_to_complex128,
)
from vkfft_tpu_torch.precision.dd_fft import dd_route, fft_dd
