"""Simple 1-D C2C FFT — the plan / execute / teardown lifecycle.

Reference analog: API guide "Simple FFT application example: 1D C2C"
(``VkFFT_API_guide.tex:2262``): fill VkFFTConfiguration, initializeVkFFT,
VkFFTAppend(-1/+1), deleteVkFFT.  Here the configuration is a frozen
dataclass, planning happens in the application constructor, execution is a
method call, and teardown is garbage collection.  The twin of
``examples/ex01_simple_1d_c2c.py`` on the PyTorch port."""
import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch.pcomplex import from_complex, to_numpy

    n = 1024
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)

    # configuration (VkFFTConfiguration analog) + planning (initializeVkFFT)
    cfg = vt.FFTConfig(shape=(n,), normalize=True)
    app = vt.FFTApplication(cfg, device=dev)

    # execution (VkFFTAppend, inverse = -1 / forward = +1 direction flags)
    X = app.forward(from_complex(x, dev))  # planar in, planar out, on dev
    x_back = to_numpy(app.inverse(X))

    fwd_err = rel_err(to_numpy(X), np.fft.fft(x))
    inv_err = rel_err(x_back, x)
    print(f"forward rel err {fwd_err:.2e}, roundtrip rel err {inv_err:.2e}")
    assert fwd_err < 2e-6 and inv_err < 2e-6

    # one-shot functional form (no explicit application; plans are cached)
    assert rel_err(vt.ifft(vt.fft(x, device=dev), device=dev), x) < 2e-6
    print("ok")


if __name__ == "__main__":
    main()
