"""Quad-class precision via double-double emulation.

Reference analog: API guide "VkFFT support for double-double emulation of
quad precision" (``VkFFT_API_guide.tex:735``; benchmark
``sample_9_benchmark_VkFFT_quadDoubleDouble.cpp``).  The reference builds
fp128-class values from two fp64s; here, as in the JAX package, a "double"
value is two fp32 planes (hi + lo, error-free transformations) giving
~1e-14 relative error: the ``fft_dd`` kernel's tier, which
``FFTApplication`` runs under ``Precision.DOUBLE`` for ``DDComplex`` input.
Twiddle tables are computed host-side in fp64 and split exactly.  The twin
of ``examples/ex10_quad_double_double.py`` on the PyTorch port."""
import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch.config import Precision
    from vkfft_tpu_torch.precision.doubledouble import (
        ddc_from_complex128,
        ddc_to_complex128,
    )

    n = 1024
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)   # complex128

    cfg = vt.FFTConfig(shape=(n,), precision=Precision.DOUBLE, normalize=True)
    app = vt.FFTApplication(cfg, device=dev)

    X = app.forward(ddc_from_complex128(x, dev))      # DDComplex planes
    err = rel_err(ddc_to_complex128(X), np.fft.fft(x))
    print(f"dd forward rel err {err:.2e} (fp32 alone would be ~1e-7)")
    assert err < 1e-12

    z = ddc_to_complex128(app.inverse(X))
    print(f"dd roundtrip rel err {rel_err(z, x):.2e}")
    assert rel_err(z, x) < 1e-12

    # non-power-of-two and prime sizes work through the same cascade
    for m in (243, 131):
        cfg = vt.FFTConfig(shape=(m,), precision=Precision.DOUBLE,
                           normalize=True)
        app = vt.FFTApplication(cfg, device=dev)
        xm = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        err = rel_err(ddc_to_complex128(app.forward(ddc_from_complex128(xm, dev))),
                      np.fft.fft(xm))
        print(f"dd n={m} rel err {err:.2e}")
        assert err < 1e-11
    print("ok")


if __name__ == "__main__":
    main()
