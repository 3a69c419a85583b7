"""Block budget of the torch port's pair kernel on one NVIDIA GPU.

    python3 bench_torch_pair.py

Times `fft_pair` (vkfft_tpu_torch/csrc/fft_pair.cu) on a few batches of
planes under several per-block shared-memory budgets, that is several
cluster sizes (`cuda_kernels.pair_cluster`), each checked against its
plain version, and beside it the two axis passes it replaces
(`fft_lines` + `fft_strided`) on the 256^3 cube.  CUDA events, three
warm-up calls, then the mean of 20 back-to-back calls.  Prints one JSON
object per measurement and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

KERNEL_TOL = 1e-5
BUDGETS = (128 * 1024, 64 * 1024, 32 * 1024, 16 * 1024)
SHAPES = ((256, 256, 256), (512, 128, 128), (4096, 64, 64), (1024, 64, 256))


def _time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_torch_pair: no CUDA device", file=sys.stderr)
        return 2
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    ck.build_kernels()
    dev = torch.device("cuda", 0)
    default = ck.PAIR_BLOCK_BYTES
    try:
        for budget in BUDGETS:
            ck.PAIR_BLOCK_BYTES = budget
            ck.pair_cluster.cache_clear()
            for shape in SHAPES:
                cluster = ck.pair_cluster(*shape[1:])
                row = {"kernel": "fft_pair", "block_budget": budget,
                       "shape": list(shape), "cluster": cluster}
                if cluster is not None:
                    xr = torch.randn(shape, device=dev)
                    xi = torch.randn(shape, device=dev)
                    y = ck.fft_pair(xr, xi)
                    p = ck.fft_pair_plain(xr, xi, False)
                    row["rel_err_plain"] = _rel(torch.complex(*y),
                                                torch.complex(*p))
                    assert row["rel_err_plain"] <= KERNEL_TOL, row
                    row["ms"] = _time_ms(lambda: ck.fft_pair(xr, xi))
                print(json.dumps(row), flush=True)
    finally:
        ck.PAIR_BLOCK_BYTES = default
        ck.pair_cluster.cache_clear()
    xr = torch.randn(256, 256, 256, device=dev)
    xi = torch.randn(256, 256, 256, device=dev)
    lr, li = xr.view(-1, 256), xi.view(-1, 256)
    print(json.dumps({"kernel": "fft_lines+fft_strided", "shape": [256] * 3,
                      "lines_ms": _time_ms(lambda: ck.fft_lines(lr, li)),
                      "strided_ms": _time_ms(lambda: ck.fft_strided(xr, xi))}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
