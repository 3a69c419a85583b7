"""3-D zero-padded FFT with work elision.

Reference analog: API guide "Advanced FFT application example: 3D
zero-padded FFT" (``VkFFT_API_guide.tex:2451``) and the zero-padding
parameters (``performZeropadding``, ``fft_zeropad_left/right``,
``vkFFT_Structs.h:204-206``).  Declaring a region of the input as zero lets
the engine SKIP the reads of that region (and symmetric output writes in the
inverse) — up to 2x faster for half-padded volumes (reference README.md:14).

The canonical use is linear (non-circular) convolution: pad each axis to
double length, declare the upper half zero.  The twin of
``examples/ex05_zeropadded_3d.py`` on the PyTorch port."""
import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch.pcomplex import from_complex, to_numpy

    n0, ny, nz = 8, 128, 256
    h0, hy, hz = 4, 64, 128          # nonzero window = lower half of each axis
    rng = np.random.default_rng(4)
    x = np.zeros((n0, ny, nz), np.complex64)
    x[:h0, :hy, :hz] = (rng.standard_normal((h0, hy, hz))
                        + 1j * rng.standard_normal((h0, hy, hz))
                        ).astype(np.complex64)

    # (left, right) declares [left, right) as zero on each axis
    cfg = vt.FFTConfig(shape=(n0, ny, nz), normalize=True,
                       zeropad_input=((h0, n0), (hy, ny), (hz, nz)))
    app = vt.FFTApplication(cfg, device=dev)
    print(f"zero-pad route: {app.zeropad_mode}")

    X = to_numpy(app.forward(from_complex(x, dev)))
    err = rel_err(X, np.fft.fftn(x))
    print(f"zero-padded forward rel err {err:.2e}")
    assert err < 2e-6

    # the same windows apply to the inverse's output: the declared-zero
    # tail comes back exactly zero
    z = to_numpy(app.inverse(app.forward(from_complex(x, dev))))
    assert rel_err(z[:h0, :hy, :hz], x[:h0, :hy, :hz]) < 2e-6
    assert np.abs(z[h0:]).max() == 0.0
    print("roundtrip ok; tail exactly zero")
    print("ok")


if __name__ == "__main__":
    main()
