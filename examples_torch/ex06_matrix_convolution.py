"""3x3 matrix-vector convolution in the frequency domain.

Reference analog: API guide "Convolution application example: 3x3
matrix-vector convolution" (``VkFFT_API_guide.tex:2487``) and the
convolution parameters (``coordinateFeatures``, ``matrixConvolution``,
``symmetricKern``, ``vkFFT_Structs.h:209-218``).  The data is a field of
3-vectors; the kernel a field of 3x3 matrices; in frequency space each mode
gets a matrix-vector product.  The reference requires a separate
``kernelConvolution=1`` application to pre-transform the kernel; here the
constructor does it (pass ``kernel_in_freq_domain=True`` to skip).  The
twin of ``examples/ex06_matrix_convolution.py`` on the PyTorch port."""
import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt

    n = 256
    m = 3                      # vector length / matrix size
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((m, n))
         + 1j * rng.standard_normal((m, n))).astype(np.complex64)
    kern = rng.standard_normal((m, m, n)).astype(np.float32) + 0j

    cfg = vt.FFTConfig(shape=(n,), convolution=True,
                       matrix_convolution=m, coordinate_features=m)
    app = vt.ConvolutionApplication(cfg, kern, device=dev)
    y = app(x)

    # oracle: per-mode matrix-vector product in frequency space
    Kf = np.fft.fft(kern.astype(np.complex128), axis=-1)
    Xf = np.fft.fft(x.astype(np.complex128), axis=-1)
    ref = np.fft.ifft(np.einsum("oiu,iu->ou", Kf, Xf), axis=-1)
    err = rel_err(y, ref)
    print(f"3x3 matrix conv rel err {err:.2e} (fused mode: {app.fusion_mode})")
    assert err < 2e-6

    # the same app reruns on new data without replanning
    x2 = (rng.standard_normal((m, n))
          + 1j * rng.standard_normal((m, n))).astype(np.complex64)
    y2 = app(x2)
    ref2 = np.fft.ifft(
        np.einsum("oiu,iu->ou", Kf, np.fft.fft(x2.astype(np.complex128), axis=-1)),
        axis=-1)
    assert rel_err(y2, ref2) < 2e-6
    print("ok")


if __name__ == "__main__":
    main()
