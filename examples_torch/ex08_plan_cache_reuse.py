"""Application binary reuse: plan blobs + the kernel build cache.

Reference analog: API guide "Simple FFT application binary reuse application"
(``VkFFT_API_guide.tex:2580``; ``saveApplicationToString`` /
``loadApplicationFromString``).  Two layers here:

1. plan blobs — a declarative JSON description of the planning state
   (config + per-axis algorithm), byte for byte the JAX package's blob of
   the same config, shippable to machines without a planner;
2. the build cache — the kernels' libraries (compiled by nvcc at first use)
   and the native planner core, keyed by their sources' hash, in the
   directory ``enable_persistent_cache`` names; a warm process loads them
   and compiles nothing.

The cache directory is ``$VKFFT_TPU_TORCH_CACHE`` when set, else ``_cache``
beside this file.  The twin of ``examples/ex08_plan_cache_reuse.py`` on the
PyTorch port."""
import os

import numpy as np

from _common import setup, rel_err


def main():
    dev = setup()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch import cache
    from vkfft_tpu_torch.pcomplex import from_complex, to_numpy

    # compiled-binary layer: point the build cache at a directory once per
    # process
    cache_dir = os.environ.get("VKFFT_TPU_TORCH_CACHE") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_cache")
    cache.enable_persistent_cache(cache_dir)

    n = 2048
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)

    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True), device=dev)
    blob = cache.save_application_to_string(app)      # bytes, JSON inside
    print(f"plan blob: {len(blob)} bytes")

    # ...ship blob elsewhere; rebuild without replanning decisions...
    app2 = cache.load_application_from_string(blob, device=dev)
    y = to_numpy(app2.forward(from_complex(x, dev)))
    err = rel_err(y, np.fft.fft(x))
    print(f"restored app rel err {err:.2e}")
    assert err < 2e-6
    assert rel_err(to_numpy(app2.inverse(app2.forward(from_complex(x, dev)))),
                   x) < 2e-6
    print(f"build cache {cache_dir}: "
          f"{sorted(f for f in os.listdir(cache_dir) if f.endswith('.so'))}")
    print("ok")


if __name__ == "__main__":
    main()
