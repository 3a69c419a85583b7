"""Mode times of `fft_strided_tw` against `fft_strided` on one NVIDIA GPU.

    python3 bench_torch_strided_tw.py [PACKAGE_DIR]

Imports `vkfft_tpu_torch` from PACKAGE_DIR (default: this file's
directory), so one call can time the same modes on copies of the package
whose kernel differs (built in each copy's own `_build/`).  At the long
tier's 2^20 x 16 pass (16 x 512 x 2048) and at 1 x 256 x 65536 it times
`fft_strided` (the plain mode) and `fft_strided_tw` in each mode with and
without its factor: natural rows, the output stored transposed, the input
read transposed, the twiddle on the write (post) or on the read (pre).
CUDA events, three warm-up calls, then the median of 20 runs of 10
back-to-back calls; prints one line a mode, then the card's name and
power limit.  It checks nothing: `chip_smoke.py`'s long_kernels phase
holds every mode against its plain version.
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

SHAPES = ((16, 512, 2048), (1, 256, 65536))


def _time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_strided_tw: no CUDA device", file=sys.stderr)
        return 2
    where = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
        os.path.abspath(__file__))
    sys.path.insert(0, where)
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    tw = ck._fft_strided_tw
    for P, n, S in SHAPES:
        x = torch.randn((P, n, S), generator=gen, device=dev)
        y = torch.randn((P, n, S), generator=gen, device=dev)
        xt, yt = (t.transpose(1, 2).contiguous() for t in (x, y))
        fwd, inv = ck.twiddle(n * S), ck.twiddle(n * S, True)
        modes = {
            "fft_strided": lambda: ck.fft_strided(x, y),
            "natural": lambda: tw(x, y, False, 1.0, None, None, None, None,
                                  None, 1, 1),
            "natural post": lambda: tw(x, y, False, 1.0, None, None, fwd,
                                       None, None, 1, 1),
            "natural pre": lambda: tw(x, y, True, 1.0, None, inv, None, None,
                                      None, 1, 1),
            "store transposed": lambda: tw(x, y, False, 1.0, None, None,
                                           None, None, None, 1, 1, False,
                                           True),
            "store transposed post": lambda: tw(x, y, False, 1.0, None, None,
                                                fwd, None, None, 1, 1, False,
                                                True),
            "read transposed": lambda: tw(xt, yt, True, 1.0, None, None,
                                          None, None, None, 1, 1, True),
            "read transposed pre": lambda: tw(xt, yt, True, 1.0, None, inv,
                                              None, None, None, 1, 1, True),
        }
        for name, fn in modes.items():
            print(f"{where} {P}x{n}x{S} {name}: {_time_ms(fn):.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
