"""Out-of-place R2C / C2R and the packed half-spectrum layout.

Reference analog: API guide "Advanced FFT application example: out-of-place
R2C FFT with custom strides" (``VkFFT_API_guide.tex:2386``) and the R2C
buffer-layout discussion (:396).  The reference makes the user compute
(x/2+1)-strided buffer sizes by hand; here the half spectrum is simply the
returned array's shape (numpy ``rfft`` convention).

The even-length fast path transforms a packed complex sequence of length
n/2, so R2C moves half the bytes and half the work of the C2C of the same
length (``vkFFT_R2C.h`` even decomposition; in-kernel pack/untangle).  The
twin of ``examples/ex03_r2c_half_spectrum.py`` on the PyTorch port."""
import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt

    rng = np.random.default_rng(2)

    # 1-D: n real -> n//2+1 complex
    n = 4096
    x = rng.standard_normal(n).astype(np.float32)
    X = vt.rfft(x, device=dev)
    assert X.shape == (n // 2 + 1,)
    err = rel_err(X, np.fft.rfft(x))
    x_back = vt.irfft(X, n=n, device=dev)
    print(f"rfft rel err {err:.2e}, roundtrip {rel_err(x_back, x):.2e}")
    assert err < 2e-6 and rel_err(x_back, x) < 2e-6

    # 3-D: only the LAST axis is halved; batch dims lead
    shape = (4, 32, 128)
    v = rng.standard_normal(shape).astype(np.float32)
    V = vt.rfftn(v, device=dev)
    assert V.shape == (4, 32, 65)
    err = rel_err(V, np.fft.rfftn(v))
    print(f"rfftn rel err {err:.2e}")
    assert err < 2e-6

    # odd lengths fall back to the full-size path transparently
    xo = rng.standard_normal(243).astype(np.float32)
    assert rel_err(vt.rfft(xo, device=dev), np.fft.rfft(xo)) < 2e-6
    print("ok")


if __name__ == "__main__":
    main()
