"""Smoke run of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero before the result line):
  1. device and toolchain: the card's name and power limit, torch, CUDA and
     nvcc versions; builds the CUDA kernels from vkfft_tpu_torch/csrc;
  2. each kernel against its plain torch version on the card (<= 1e-5 of
     max|ref|), at every length the kernels take, and on a subset against
     numpy fp64 (<= 5e-6); then the API's other routes (axis subsets, odd,
     tiny and length-1 axes, complex tensors, inputs left unchanged,
     refusals outside the slice);
  3. the main path at full width through FFTApplication: batched 1-D C2C
     at n = 256, 1024, 4096 with 128 MB of planar data each (forward plus
     normalized inverse), and fftn/ifftn of a 256^3 cube (the pair kernel
     on the two minor axes, the strided kernel on the leading one); every
     kernel's launch counter must rise and the plain engine's must not;
  4. times with CUDA events (warm-up, then the median of 20 runs of 10
     back-to-back calls): each kernel at the main path's shapes, held
     against its plain version there (<= 1e-5 of max|ref|), and each
     end-to-end round trip, beside the HBM-bandwidth bound and the
     torch.fft time of the same function.

Every number is printed as it is measured.  The last lines are a JSON
object describing each kernel, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-5             # kernel vs its plain version, of max|ref|
NUMPY_TOL = 5e-6              # vs numpy fp64, the gate of tests/test_pallas.py
TARGET_BYTES = 128 * 1024 * 1024
ROWS_1D = (256, 1024, 4096)
CUBE = (256, 256, 256)
REPS = 20
INNER = 10


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _finite(*planars) -> bool:
    return all(bool(torch.isfinite(t).all()) for p in planars
               for t in (p.re, p.im))


def _time_ms(fn, reps: int = REPS, inner: int = INNER,
             warmup: int = 3) -> float:
    """Median over ``reps`` runs of ``inner`` back-to-back calls, each run
    timed by CUDA events and divided by ``inner``.  The host enqueues
    ahead of the card, so the host's launch gap of a lone call (tens of
    microseconds) stays out of the time."""
    for _ in range(warmup):
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


def _planes(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


def phase_toolchain(ck) -> dict:
    import platform
    nvcc = ck._nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[-1]
    info = {"card": _smi(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "nvcc": ver,
            "python": platform.python_version()}
    t0 = time.perf_counter()
    paths = ck.build_kernels()
    info["build_s"] = time.perf_counter() - t0
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            regs = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        info[f"ptxas_{name}"] = regs
    for k, v in info.items():
        _log(f"[toolchain] {k}: {v}")
    return info


def phase_kernels_vs_plain(ck, dev) -> dict:
    """Each kernel against its plain version (and numpy on a subset)."""
    out = {"fft_lines": [], "fft_strided": [], "fft_pair": []}
    numpy_n = {47, 60, 256, 1000, 4096, 8192}
    for n in (8, 47, 60, 64, 100, 256, 360, 1000, 1024, 2048, 4096, 8192):
        B = 33
        xr, xi = _planes((B, n), n, dev)
        for inverse in (False, True):
            scale = 1.0 / n if inverse else 0.5
            yr, yi = ck.fft_lines(xr, xi, inverse, scale)
            torch.cuda.synchronize()
            pr, pi = ck.fft_lines_plain(xr, xi, inverse, scale)
            ref = torch.complex(pr, pi)
            err = _rel(torch.complex(yr, yi), ref)
            row = {"n": n, "B": B, "inverse": inverse, "rel_err_plain": err}
            assert err <= KERNEL_TOL, row
            if n in numpy_n:
                x = xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy()
                want = (np.fft.ifft(x, axis=1) * n if inverse
                        else np.fft.fft(x, axis=1)) * scale
                got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
                row["rel_err_numpy"] = float(np.abs(got - want).max()
                                             / np.abs(want).max())
                assert row["rel_err_numpy"] <= NUMPY_TOL, row
            out["fft_lines"].append(row)
    strided_shapes = [(1, 256, 65536), (3, 64, 1), (2, 256, 37),
                      (4, 60, 129), (2, 8192, 5), (1, 1000, 33), (5, 47, 2)]
    for (P, n, S) in strided_shapes:
        xr, xi = _planes((P, n, S), P * n + S, dev)
        for inverse in (False, True):
            scale = 1.0 / n if inverse else 1.0
            yr, yi = ck.fft_strided(xr, xi, inverse, scale)
            torch.cuda.synchronize()
            pr, pi = ck.fft_strided_plain(xr, xi, inverse, scale)
            err = _rel(torch.complex(yr, yi), torch.complex(pr, pi))
            row = {"shape": [P, n, S], "inverse": inverse, "rel_err_plain": err}
            assert err <= KERNEL_TOL, row
            if P * n * S <= 1 << 20:
                x = xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy()
                want = (np.fft.ifft(x, axis=1) * n if inverse
                        else np.fft.fft(x, axis=1)) * scale
                got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
                row["rel_err_numpy"] = float(np.abs(got - want).max()
                                             / np.abs(want).max())
                assert row["rel_err_numpy"] <= NUMPY_TOL, row
            out["fft_strided"].append(row)
    pair_shapes = [(3, 16, 16), (2, 8, 12), (7, 2, 4), (2, 47, 60),
                   (5, 128, 128), (2, 64, 256), (3, 256, 256), (2, 8, 8192),
                   (256, 256, 256)]
    for (B, ny, nz) in pair_shapes:
        xr, xi = _planes((B, ny, nz), B + ny * nz, dev)
        for inverse in (False, True):
            scale = 1.0 / (ny * nz) if inverse else 1.0
            yr, yi = ck.fft_pair(xr, xi, inverse, scale)
            torch.cuda.synchronize()
            pr, pi = ck.fft_pair_plain(xr, xi, inverse, scale)
            err = _rel(torch.complex(yr, yi), torch.complex(pr, pi))
            row = {"shape": [B, ny, nz], "cluster": ck.pair_cluster(ny, nz),
                   "inverse": inverse, "rel_err_plain": err}
            assert err <= KERNEL_TOL, row
            if B * ny * nz <= 1 << 20:
                x = xr.double().cpu().numpy() + 1j * xi.double().cpu().numpy()
                want = (np.fft.ifft2(x) * (ny * nz) if inverse
                        else np.fft.fft2(x)) * scale
                got = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
                row["rel_err_numpy"] = float(np.abs(got - want).max()
                                             / np.abs(want).max())
                assert row["rel_err_numpy"] <= NUMPY_TOL, row
            out["fft_pair"].append(row)
    # every length the kernels take: lines at all of them, strided at every
    # fifth, alternating directions
    covered = [n for n in range(2, ck.KERNEL_MAX_N + 1) if ck.kernel_supports(n)]
    sweep = {"lengths": len(covered), "lines_worst": 0.0, "strided_worst": 0.0}
    for i, n in enumerate(covered):
        inverse = bool(i % 2)
        xr, xi = _planes((3, n), n, dev)
        yr, yi = ck.fft_lines(xr, xi, inverse, 0.5)
        pr, pi = ck.fft_lines_plain(xr, xi, inverse, 0.5)
        err = _rel(torch.complex(yr, yi), torch.complex(pr, pi))
        assert err <= KERNEL_TOL, ("fft_lines", n, inverse, err)
        sweep["lines_worst"] = max(sweep["lines_worst"], err)
        if i % 5 == 0:
            xr, xi = xr.reshape(3, n, 1).expand(3, n, 2).contiguous(), \
                xi.reshape(3, n, 1).expand(3, n, 2).contiguous()
            yr, yi = ck.fft_strided(xr, xi, inverse, 0.5)
            pr, pi = ck.fft_strided_plain(xr, xi, inverse, 0.5)
            err = _rel(torch.complex(yr, yi), torch.complex(pr, pi))
            assert err <= KERNEL_TOL, ("fft_strided", n, inverse, err)
            sweep["strided_worst"] = max(sweep["strided_worst"], err)
    out["sweep"] = sweep
    _log(f"[kernels] sweep over every covered length: {sweep}")
    worst = {k: max(r["rel_err_plain"] for r in out[k])
             for k in ck.KERNEL_SOURCES}
    _log(f"[kernels] worst rel err vs plain: {worst}")
    worst_np = {k: max(r.get("rel_err_numpy", 0.0) for r in out[k])
                for k in ck.KERNEL_SOURCES}
    _log(f"[kernels] worst rel err vs numpy fp64: {worst_np}")
    return out


def phase_routes(vt, dev) -> dict:
    """The API's other routes on the card: axis subsets, tiny and odd
    lengths, batch dims, complex tensors, and refusals outside the slice."""
    rows = []
    cases = [((2, 3, 4, 60), None), ((2, 3, 4, 60), (1, 3)), ((64, 47), None),
             ((7, 2, 1000), (0, 2)), ((5, 16, 9), (1,)), ((3, 8192), None),
             ((2, 1, 64), (1, 2)), ((3, 5, 1, 16), None), ((4, 512, 512), None),
             ((6, 64, 64), (1, 2))]
    for shape, axes in cases:
        xr, xi = _planes(shape, sum(shape), dev)
        xc = torch.complex(xr, xi)
        y = vt.fftn(vt.Planar(xr, xi), axes=axes)
        z = vt.ifftn(y, axes=axes)
        e_fwd = _rel(torch.complex(y.re, y.im), torch.fft.fftn(xc, dim=axes))
        e_rt = _rel(torch.complex(z.re, z.im), xc)
        kept = torch.equal(torch.complex(xr, xi), xc)
        row = {"shape": list(shape), "axes": axes, "rel_err_fwd": e_fwd,
               "rel_err_round_trip": e_rt, "input_kept": kept}
        assert e_fwd <= NUMPY_TOL and e_rt <= NUMPY_TOL and kept, row
        rows.append(row)
    xr, xi = _planes((4, 256), 1, dev)
    xc = torch.complex(xr, xi)
    yc = vt.fft(xc)
    assert yc.is_complex() and yc.device == xc.device
    assert _rel(yc, torch.fft.fft(xc)) <= NUMPY_TOL
    for n in (131, 263, 67):
        p = vt.Planar(*_planes((2, n), n, dev))
        try:
            vt.fft(p)
        except NotImplementedError:
            continue
        raise AssertionError(f"n={n} is outside the slice but did not raise")
    _log(f"[routes] {len(rows)} fftn/ifftn cases, worst "
         f"{max(max(r['rel_err_fwd'], r['rel_err_round_trip']) for r in rows)}")
    return {"cases": rows}


def phase_main_path(vt, ck, torch_engine, dev) -> dict:
    """The port's main path, through the entry points a user calls."""
    apps, inputs = {}, {}
    for n in ROWS_1D:
        batch = TARGET_BYTES // (8 * n)
        apps[n] = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True))
        inputs[n] = vt.Planar(*_planes((batch, n), n, dev))
    cube = vt.Planar(*_planes(CUBE, 3, dev))
    torch.cuda.synchronize()

    ck.reset_launches()
    torch_engine.calls = 0
    results = {}
    for n in ROWS_1D:
        y = apps[n].forward(inputs[n])
        z = apps[n].inverse(y)
        results[n] = (y, z)
    Y3 = vt.fftn(cube)
    Z3 = vt.ifftn(Y3)
    torch.cuda.synchronize()
    launches = dict(ck.launches)
    plain_calls = torch_engine.calls

    _log(f"[main] launches {launches}, plain engine calls {plain_calls}")
    assert all(v > 0 for v in launches.values()), launches
    assert plain_calls == 0, plain_calls
    rows = []
    for n in ROWS_1D:
        x = inputs[n]
        y, z = results[n]
        ref = torch.fft.fft(torch.complex(x.re, x.im), dim=-1)
        e_fwd = _rel(torch.complex(y.re, y.im), ref)
        e_rt = _rel(torch.complex(z.re, z.im), torch.complex(x.re, x.im))
        finite = _finite(y, z)
        row = {"row": f"1d_n{n}", "shape": list(x.shape),
               "rel_err_fwd_vs_torch_fft": e_fwd, "rel_err_round_trip": e_rt,
               "finite": finite}
        _log(f"[main] {row}")
        assert finite and y.shape == x.shape and z.shape == x.shape, row
        assert e_fwd <= NUMPY_TOL and e_rt <= NUMPY_TOL, row
        rows.append(row)
    ref3 = torch.fft.fftn(torch.complex(cube.re, cube.im))
    e_fwd = _rel(torch.complex(Y3.re, Y3.im), ref3)
    e_rt = _rel(torch.complex(Z3.re, Z3.im), torch.complex(cube.re, cube.im))
    finite = _finite(Y3, Z3)
    row = {"row": "3d_256^3", "shape": list(CUBE),
           "rel_err_fwd_vs_torch_fft": e_fwd, "rel_err_round_trip": e_rt,
           "finite": finite}
    _log(f"[main] {row}")
    assert finite and Y3.shape == CUBE and e_fwd <= NUMPY_TOL \
        and e_rt <= NUMPY_TOL, row
    rows.append(row)
    del ref3, results
    return {"launches": launches, "plain_engine_calls": plain_calls,
            "rows": rows}


def _fft_ops(points: int, n: int) -> float:
    return 5.0 * points * math.log2(n)


def _bound(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _errors(y, p, what) -> float:
    """Max abs error of kernel planes ``y`` against plain planes ``p``,
    after asserting the relative error is within KERNEL_TOL."""
    rel = _rel(torch.complex(*y), torch.complex(*p))
    assert rel <= KERNEL_TOL, (what, rel)
    return max((y[0] - p[0]).abs().max().item(),
               (y[1] - p[1]).abs().max().item())


def phase_times(vt, ck, dev) -> dict:
    """Kernels at the main path's shapes (each held against its plain
    version there), and the end-to-end round trips."""
    _log(f"[time] card: {_smi()}")
    kernels = {name: [] for name in ck.KERNEL_SOURCES}
    lines_shapes = [(TARGET_BYTES // (8 * n), n) for n in ROWS_1D]
    for B, n in lines_shapes:
        xr, xi = _planes((B, n), n, dev)
        err = _errors(ck.fft_lines(xr, xi, False),
                      ck.fft_lines_plain(xr, xi, False), ("fft_lines", B, n))
        xc = torch.complex(xr, xi)
        nbytes = 16.0 * B * n
        bound, by = _bound(nbytes, _fft_ops(B * n, n))
        ms = _time_ms(lambda: ck.fft_lines(xr, xi, False))
        row = {"shape": [B, n], "ms": ms, "GBs": nbytes / ms / 1e6,
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(lambda: ck.fft_lines_plain(xr, xi, False),
                                    reps=5, inner=1, warmup=1),
               "library_ms": _time_ms(lambda: torch.fft.fft(xc, dim=-1))}
        _log(f"[time] fft_lines {row}")
        kernels["fft_lines"].append(row)
        del xr, xi, xc
    for shape in [(1, 256, 65536), (256, 256, 256)]:
        P, n, S = shape
        xr, xi = _planes(shape, n + P, dev)
        err = _errors(ck.fft_strided(xr, xi, False),
                      ck.fft_strided_plain(xr, xi, False),
                      ("fft_strided", shape))
        xc = torch.complex(xr, xi)
        nbytes = 16.0 * P * n * S
        bound, by = _bound(nbytes, _fft_ops(P * n * S, n))
        ms = _time_ms(lambda: ck.fft_strided(xr, xi, False))
        row = {"shape": list(shape), "ms": ms, "GBs": nbytes / ms / 1e6,
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(
                   lambda: ck.fft_strided_plain(xr, xi, False), reps=5,
                   inner=1, warmup=1),
               "library_ms": _time_ms(lambda: torch.fft.fft(xc, dim=1))}
        _log(f"[time] fft_strided {row}")
        kernels["fft_strided"].append(row)
        del xr, xi, xc
    B, ny, nz = CUBE
    xr, xi = _planes(CUBE, 5, dev)
    err = _errors(ck.fft_pair(xr, xi, False), ck.fft_pair_plain(xr, xi, False),
                  ("fft_pair", CUBE))
    xc = torch.complex(xr, xi)
    nbytes = 16.0 * B * ny * nz
    bound, by = _bound(nbytes, _fft_ops(B * ny * nz, ny * nz))
    ms = _time_ms(lambda: ck.fft_pair(xr, xi, False))
    row = {"shape": list(CUBE), "cluster": ck.pair_cluster(ny, nz), "ms": ms,
           "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
           "max_abs_err": err,
           "plain_ms": _time_ms(lambda: ck.fft_pair_plain(xr, xi, False),
                                reps=5, inner=1, warmup=1),
           "library_ms": _time_ms(lambda: torch.fft.fft2(xc))}
    _log(f"[time] fft_pair {row}")
    kernels["fft_pair"].append(row)
    del xr, xi, xc

    e2e = []
    for n in ROWS_1D:
        B = TARGET_BYTES // (8 * n)
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True))
        x = vt.Planar(*_planes((B, n), n, dev))
        xc = torch.complex(x.re, x.im)
        nbytes = 4.0 * 8 * B * n     # bench.py: fwd + inv, read + write
        ms = _time_ms(lambda: app.inverse(app.forward(x)))
        bound, by = _bound(nbytes, 2 * _fft_ops(B * n, n))
        row = {"row": f"1d_n{n}", "shape": [B, n], "ms": ms,
               "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
               "torch_fft_ms": _time_ms(
                   lambda: torch.fft.ifft(torch.fft.fft(xc, dim=-1), dim=-1))}
        row["vs_torch_fft"] = row["torch_fft_ms"] / ms
        _log(f"[time] e2e {row}")
        e2e.append(row)
        del x, xc
    cube = vt.Planar(*_planes(CUBE, 3, dev))
    cc = torch.complex(cube.re, cube.im)
    points = math.prod(CUBE)
    # bench.py: fwd + inv, read + write, per axis pass (pair + strided)
    nbytes = 2 * 2 * 2 * 8.0 * points
    ms = _time_ms(lambda: vt.ifftn(vt.fftn(cube)))
    bound, by = _bound(nbytes, 2 * _fft_ops(points, points))
    row = {"row": "3d_256^3", "shape": list(CUBE), "ms": ms,
           "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
           "axis_passes_per_dir": 2,
           "torch_fft_ms": _time_ms(lambda: torch.fft.ifftn(torch.fft.fftn(cc)))}
    row["vs_torch_fft"] = row["torch_fft_ms"] / ms
    _log(f"[time] e2e {row}")
    e2e.append(row)
    return {"kernels": kernels, "e2e": e2e}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import vkfft_tpu_torch as vt
        from vkfft_tpu_torch.ops import cuda_kernels as ck
        from vkfft_tpu_torch.ops import torch_engine
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    record = {}
    phases = [("toolchain", lambda: phase_toolchain(ck)),
              ("kernels", lambda: phase_kernels_vs_plain(ck, dev)),
              ("routes", lambda: phase_routes(vt, dev)),
              ("main_path", lambda: phase_main_path(vt, ck, torch_engine, dev)),
              ("times", lambda: phase_times(vt, ck, dev))]
    for name, fn in phases:
        t = time.perf_counter()
        try:
            record[name] = fn()
        except Exception as e:   # report the phase, then fail the run
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed: {e!r}", file=sys.stderr)
            return 1
        _log(f"[phase] {name} done in {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
    record["total_s"] = time.perf_counter() - t0

    launches = record["main_path"]["launches"]
    sources = {"fft_lines": ("vkfft_tpu_torch/csrc/fft_lines.cu",
                             "vkfft_tpu/ops/pallas_engine.py:1563"),
               "fft_strided": ("vkfft_tpu_torch/csrc/fft_strided.cu",
                               "vkfft_tpu/ops/pallas_engine.py:3489"),
               "fft_pair": ("vkfft_tpu_torch/csrc/fft_pair.cu",
                            "vkfft_tpu/ops/pallas_engine.py:1982")}
    # the leading axis of the cube, which the JAX package runs in
    # _outer_kernel, runs in fft_strided on the (P, n, R*nz) view
    also = {"fft_strided": ["vkfft_tpu/ops/pallas_engine.py:4001"]}
    entries = []
    for name, rows in record["times"]["kernels"].items():
        head = rows[0]
        entries.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "also_replaces": also.get(name, []),
            "per_shape": rows})
    _log(f"[phase] all done in {record['total_s']:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
