"""Pass times of the torch port's long tier on one NVIDIA GPU.

    python3 bench_torch_long.py

The measurements `cuda_kernels.long_split`'s cost model rests on, over
2^24 points a pass (128 MiB of planes): the factor mode of the strided
pass (`fft_strided_tw`, with the two-upload twiddle on its write) at
each strided length nc = 64 .. 8192 beside the plain mode (`fft_strided`)
where its stages take nc; the contiguous pass (`fft_lines`, or
`fft_twofactor` at 16384) at ns = 256 .. 16384; the four-step reorder as
the tensor-op transpose; and forward-plus-inverse round trips of 2^20 x
16, 2^24 and 2^26 points through `cuda_engine.fft_long_p` on several two-
and three-upload splits, natural and swapped order, each checked against
its input, beside `torch.fft`.  CUDA events, two warm-up calls, then the
median of 10 runs of 5 back-to-back calls.  Prints one JSON object per
measurement and the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

POINTS = 1 << 24
STRIDED = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
LINES = (256, 1024, 2048, 4096, 8192, 16384)
ROUND_TRIPS = (
    (1 << 20, 16, ((128, 8192), (256, 4096), (512, 2048), (1024, 1024),
                   (64, 16384), (64, 128, 128), (16, 128, 512))),
    (1 << 24, 1, ((2048, 8192), (4096, 4096), (1024, 16384),
                  (16, 128, 8192), (64, 512, 512), (256, 256, 256))),
    (1 << 26, 1, ((8192, 8192), (4096, 16384), (64, 128, 8192),
                  (256, 256, 1024), (128, 512, 1024), (256, 512, 512))),
)
ROUND_TRIP_TOL = 1e-5


def _time_ms(fn, reps: int = 10, inner: int = 5) -> float:
    for _ in range(2):
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


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_long: no CUDA device", file=sys.stderr)
        return 2
    from vkfft_tpu_torch.ops import cuda_engine as ce
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    from vkfft_tpu_torch.pcomplex import Planar
    ck.build_kernels()
    dev = torch.device("cuda", 0)

    def emit(row):
        print(json.dumps(row), flush=True)

    for nc in STRIDED:
        S = POINTS // (16 * nc)
        xr = torch.randn((16, nc, S), device=dev)
        xi = torch.randn((16, nc, S), device=dev)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        tw = ck.twiddle(nc * S)
        row = {"pass": "fft_strided_tw", "nc": nc, "shape": [16, nc, S],
               "ms": _time_ms(lambda: ck.fft_strided(
                   xr, xi, False, post=tw, out=(yr, yi)))}
        if ck.kernel_supports(nc):
            row["plain_mode_ms"] = _time_ms(
                lambda: ck.fft_strided(xr, xi, False, out=(yr, yi)))
        emit(row)
        del xr, xi, yr, yi
    for ns in LINES:
        xr = torch.randn((POINTS // ns, ns), device=dev)
        xi = torch.randn((POINTS // ns, ns), device=dev)
        run = ck.fft_lines if ck.kernel_supports(ns) else ck.fft_twofactor
        emit({"pass": run.__name__, "ns": ns, "shape": list(xr.shape),
              "ms": _time_ms(lambda: run(xr, xi, False, 1.0, out=(xr, xi)))})
        del xr, xi
    x = Planar(torch.randn((16, 512 * 2048), device=dev),
               torch.randn((16, 512 * 2048), device=dev))
    emit({"pass": "reorder", "shape": [16, 512, 2048],
          "ms": _time_ms(lambda: ck.swap_digits(x, 512, 2048))})
    del x
    for n, B, splits in ROUND_TRIPS:
        x = Planar(torch.randn((B, n), device=dev),
                   torch.randn((B, n), device=dev))
        xc = torch.complex(x.re, x.im)
        emit({"round_trip": "torch.fft", "n": n, "lines": B,
              "ms": _time_ms(lambda: torch.fft.ifft(torch.fft.fft(xc)))})
        del xc
        for split in splits:
            row = {"round_trip": "fft_long_p", "n": n, "lines": B,
                   "split": list(split)}
            for order in ("natural", "swapped"):
                def trip(order=order):
                    y = ce.fft_long_p(x, n, False, order=order, split=split)
                    return ce.fft_long_p(y, n, True, 1.0 / n, order=order,
                                         split=split)
                z = trip()
                err = _rel(torch.complex(z.re, z.im),
                           torch.complex(x.re, x.im))
                assert err <= ROUND_TRIP_TOL, (n, split, order, err)
                row[f"{order}_ms"] = _time_ms(trip)
                row[f"{order}_rel_err"] = err
            emit(row)
        del x
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
