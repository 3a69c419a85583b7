"""R2C cross-correlation (phase correlation) between two datasets.

Reference analog: API guide "Convolution application example: R2C
cross-correlation between two datasets" (``VkFFT_API_guide.tex:2528``) with
``conjugateConvolution`` and ``crossPowerSpectrumNormalization``
(``vkFFT_Structs.h:252-260``).  Phase correlation of an image with a shifted
copy produces a delta at the shift — the standard registration primitive.
The twin of ``examples/ex07_cross_correlation.py`` on the PyTorch port."""
import numpy as np

from _common import host, setup


def main():
    dev = setup()
    import vkfft_tpu_torch as vt

    shape = (64, 128)
    rng = np.random.default_rng(6)
    ref_img = rng.standard_normal(shape).astype(np.float32)
    dy, dx = 9, 23
    moved = np.roll(ref_img, (dy, dx), axis=(0, 1))

    # conjugate_convolution=1: multiply by conj(kernel spectrum);
    # cross-power normalization: divide by the magnitude -> pure phase
    cfg = vt.FFTConfig(shape=shape, convolution=True,
                       conjugate_convolution=1,
                       cross_power_spectrum_normalization=True)
    app = vt.ConvolutionApplication(cfg, ref_img + 0j, device=dev)
    corr = np.abs(host(app(moved + 0j)))

    peak = np.unravel_index(np.argmax(corr), shape)
    print(f"phase-correlation peak at {peak}, expected ({dy}, {dx})")
    assert peak == (dy, dx)
    print("ok")


if __name__ == "__main__":
    main()
