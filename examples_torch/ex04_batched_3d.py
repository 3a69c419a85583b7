"""3-D FFT with batching and omitted axes.

Reference analog: API guide "Advanced FFT application example: 3D FFT with
innermost batching" (``VkFFT_API_guide.tex:2425``) plus the
``numberBatches`` / ``omitDimension`` configuration fields
(``vkFFT_Structs.h:152,230``).  Here batch dims are simply leading tensor
dimensions, ``FFTConfig.batch`` is an optional declared count that is
validated at call time, and ``fft_axes`` selects which dims transform
(omitDimension inverted).  The twin of ``examples/ex04_batched_3d.py`` on
the PyTorch port."""
import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch.pcomplex import from_complex, to_numpy

    shape = (8, 32, 64)
    batch = 16
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((batch, *shape))
         + 1j * rng.standard_normal((batch, *shape))).astype(np.complex64)

    # declared batch count (numberBatches): validated against the leading dims
    cfg = vt.FFTConfig(shape=shape, batch=batch, normalize=True)
    app = vt.FFTApplication(cfg, device=dev)
    X = to_numpy(app.forward(from_complex(x, dev)))
    err = rel_err(X, np.fft.fftn(x, axes=(1, 2, 3)))
    print(f"batched 3-D rel err {err:.2e}")
    assert err < 2e-6

    # omitDimension analog: transform only the outer two of the three dims
    cfg = vt.FFTConfig(shape=shape, fft_axes=(0, 1))
    app = vt.FFTApplication(cfg, device=dev)
    X = to_numpy(app.forward(from_complex(x, dev)))
    err = rel_err(X, np.fft.fftn(x, axes=(1, 2)))
    print(f"omitted-axis rel err {err:.2e}")
    assert err < 2e-6

    # wrong declared batch raises, like the reference's config validation
    try:
        app_bad = vt.FFTApplication(vt.FFTConfig(shape=shape, batch=4),
                                    device=dev)
        app_bad.forward(from_complex(x, dev))
    except vt.FFTError as e:
        print(f"batch mismatch correctly rejected: {e}")
    else:
        raise AssertionError("batch mismatch not detected")
    print("ok")


if __name__ == "__main__":
    main()
