"""Advanced N-D application: transform kinds and precision tiers from one
configuration struct.

Reference analog: API guide "Advanced FFT application example: ND, C2C/R2C/
R2R, different precisions" (``VkFFT_API_guide.tex:2337``) — the same
VkFFTConfiguration drives C2C, R2C (performR2C) and DCT (performDCT) at
half/single/double precision.  Here ``FFTConfig.kind``/``rr_type``/
``precision`` play those roles and the application dispatches on them
(reference dispatch: ``vkFFT_Plan_FFT.h:682-696``).  The twin of
``examples/ex02_nd_kinds_precisions.py`` on the PyTorch port."""
import numpy as np
import scipy.fft

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch.config import Precision, TransformKind
    from vkfft_tpu_torch.pcomplex import from_complex, to_numpy

    shape = (16, 64)
    rng = np.random.default_rng(1)
    xr = rng.standard_normal(shape).astype(np.float32)
    xc = (xr + 1j * rng.standard_normal(shape)).astype(np.complex64)

    # C2C, fp32 tier
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, kind=TransformKind.C2C),
                            device=dev)
    err = rel_err(to_numpy(app.forward(from_complex(xc, dev))), np.fft.fftn(xc))
    print(f"C2C single: {err:.2e}")
    assert err < 2e-6

    # R2C from the same config surface: forward returns the packed half
    # spectrum over the last axis (numpy rfftn layout)
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, kind=TransformKind.R2C),
                            device=dev)
    err = rel_err(app.forward(xr), np.fft.rfftn(xr))
    print(f"R2C single: {err:.2e}")
    assert err < 2e-6

    # R2R: DCT-II (performDCT = 2 analog); scipy is the oracle
    app = vt.FFTApplication(
        vt.FFTConfig(shape=(64,), kind=TransformKind.DCT, rr_type=2),
        device=dev)
    err = rel_err(app.forward(xr[0]),
                  scipy.fft.dct(xr[0].astype(np.float64), type=2))
    print(f"DCT-II single: {err:.2e}")
    assert err < 2e-6

    # bf16 storage tier (halfPrecisionMemoryOnly analog: narrow storage,
    # fp32 compute) — looser tolerance from the narrow I/O
    app = vt.FFTApplication(
        vt.FFTConfig(shape=shape, precision=Precision.BFLOAT16), device=dev)
    err = rel_err(to_numpy(app.forward(from_complex(xc, dev))), np.fft.fftn(xc))
    print(f"C2C bf16 storage: {err:.2e}")
    assert err < 5e-2

    # double-double tier ("fp64" from fp32 pairs)
    from vkfft_tpu_torch.precision.doubledouble import (
        ddc_from_complex128,
        ddc_to_complex128,
    )

    app = vt.FFTApplication(
        vt.FFTConfig(shape=(64,), precision=Precision.DOUBLE, normalize=True),
        device=dev)
    x64 = xc[0].astype(np.complex128)
    err = rel_err(ddc_to_complex128(app.forward(ddc_from_complex128(x64, dev))),
                  np.fft.fft(x64))
    print(f"C2C double-double: {err:.2e}")
    assert err < 1e-12
    print("ok")


if __name__ == "__main__":
    main()
