"""CLI benchmark / precision / functional suite of the PyTorch port.

Twin of ``vkfft_tpu/cli.py``, the analog of the reference's test-suite
driver (``VkFFT_TestSuite.cpp:548`` flag dispatch, ``:124`` launchVkFFT),
with the same sample taxonomy, flags, printed rows and PASS/FAIL gates:

  0-10    benchmarks          (``sample_0..10_benchmark_*.cpp``)
  11-19   precision vs oracle (``sample_11..19_precision_*.cpp``)
  50-52   convolution checks  (``sample_50..52_convolution_*.cpp``)
  100-101 DCT benchmarks      (``sample_100/101_benchmark_*_dct.cpp``)
  1000+   size sweeps         (``sample_1000..1004_*_2_4096.cpp``)
  200     user benchmark      (``user_benchmark_VkFFT.cpp``, flags
                               -X/-Y/-Z/-P/-B/-N/-R2C/-DCT)

Metrics match the reference: per-system avg ms, "benchmark score" =
sum(bufferSize_KB / avg_ms) / num_systems (``sample_0...cpp:242,268``),
estimated bandwidth from bytes moved (``:234-241``), and avg/max absolute
difference and relative eps against the fp64 numpy oracle
(``sample_11...cpp:289-323``).

Devices: the data goes to the first CUDA device unless ``--cpu`` is given;
without ``--cpu`` and without a CUDA device the CLI exits non-zero.
Engines: ``--engine cuda`` (the port's kernels; on CPU tensors their plain
versions), ``--engine torch`` (plain tensor ops), or, by default, each
call's planes pick by their device (`api.engine_for`).  ``-compare`` runs
the sample on each engine in turn, cuda then torch, and the timed C2C rows
(samples 0, 3, 7 and 200) print ``torch.fft``'s round trip of the same
data beside them.

Where the JAX package branches on its backend having complex dtypes (its
TPU has none), the port has them on both devices and takes the complex
branch everywhere; its fp64 samples (1, 8, 12, 18, 200 with -P 1, 1001)
build ``Precision.DOUBLE`` applications, which run native fp64 or the
double-double tier as `api.double_route` decides from the plan (host
complex128 given to a SINGLE transform is narrowed to complex64).  The
real fp64 data of sample 101 runs where the plain engine does (the CPU);
the card's real kernels take float32.  The multidim DCT rows (sample 101,
sample 200 with -DCT) transform the system's axes; the JAX CLI's `dctn`
call also transforms its batch axis.

Timing (`_time_fwd_inv`, `_time_chain_fn`): repeated calls on the same
input, the median over runs of back-to-back calls, each run timed with
CUDA events on the card and `time.perf_counter` on the CPU; the last
output must be finite.  Module-level byte targets (`TARGET_BYTES`, ...)
size the benchmarks.

Usage:  python -m vkfft_tpu_torch.cli -vkfft 0 [-o results.txt]
            [--engine cuda|torch] [--cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import platform
import statistics
import sys
import time

import numpy as np
import torch

import vkfft_tpu_torch as vt
from vkfft_tpu_torch import cache
from vkfft_tpu_torch.api import resolve_device
from vkfft_tpu_torch.config import FFTConfig, Precision
from vkfft_tpu_torch.ops import cuda_kernels as ck
from vkfft_tpu_torch.pcomplex import (Planar, from_complex,
                                      from_numpy_planar, to_numpy)
from vkfft_tpu_torch.precision.dd_fft import fft_dd, fft_lines_dd
from vkfft_tpu_torch.precision.doubledouble import DD, DDComplex

# Byte targets of the benchmarks (the JAX package's sizes)
TARGET_BYTES = 128 << 20          # samples 0, 2, 3, 4, 6, 100, 51's bench
SMALL_TARGET_BYTES = 64 << 20     # samples 4 (--full), 5, 7, 9
DCT_ND_BYTES = 8 << 20            # sample 101; sample 4 on the torch engine
FP64_BLUESTEIN_BYTES = 4 << 20    # sample 8
# sample 3's cubes (and the reference's 3-D sweep's non-pow-2 row 96^3)
SAMPLE_3_SYSTEMS = [(32, 32, 32), (64, 64, 64), (96, 96, 96),
                    (128, 128, 128), (256, 256, 256), (512, 512, 512)]
# sample 4's default systems (the reference's table runs with --full)
SAMPLE_4_SYSTEMS = [(1024, 2048), (2048, 4096), (128, 128, 128),
                    (256, 256, 256), (512, 512, 512)]
ITERS = 80                        # timed calls of a benchmark row
INNER = 10                        # back-to-back calls of a timed run at most


_SAMPLES = {}


def sample(num, desc):
    def deco(fn):
        _SAMPLES[num] = (fn, desc)
        return fn
    return deco


class Ctx:
    """A sample's run: its arguments, engine (None: by the planes' device),
    device and the ``-o`` file it appends to."""
    def __init__(self, args, device: torch.device):
        self.args = args
        self.engine = args.engine
        self.device = device
        self.out = open(args.output, "a") if args.output else None

    def log(self, msg=""):
        print(msg, flush=True)
        if self.out:
            self.out.write(msg + "\n")
            self.out.flush()

    def close(self):
        if self.out:
            self.out.close()
            self.out = None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rand_complex(shape, seed=0, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _device_planes(shape, seed, device, dtype=torch.float32) -> Planar:
    """Seeded normal planes made on ``device`` (the benchmarks' data: no
    host array of their size)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return Planar(torch.randn(shape, generator=g, device=device, dtype=dtype),
                  torch.randn(shape, generator=g, device=device, dtype=dtype))


def _device_real(shape, seed, device, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def _leaves(y) -> list:
    """The tensors of a result: planes (`Planar`, `TlSpectrum`), the four
    planes of a `DDComplex`, or a tensor."""
    if hasattr(y, "planes"):
        return list(y.planes())
    if hasattr(y, "re"):
        return [y.re, y.im]
    return [y]


def _time_calls(call, iters: int, warmup: int) -> float:
    """Seconds a call of ``call()`` takes: ``warmup`` calls, then about
    ``iters`` calls in runs of up to `INNER` back-to-back ones, the median
    over the runs.  On the card each run is timed by CUDA events (the host
    enqueues ahead of the card, so a lone call's launch gap stays out), on
    the CPU by `time.perf_counter`.  Raises FloatingPointError where the
    last output is not finite."""
    y = call()
    for _ in range(warmup - 1):
        y = call()
    cuda = _leaves(y)[0].device.type == "cuda"
    inner = max(1, min(INNER, iters // 4))
    times = []
    for _ in range(max(1, iters // inner)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                y = call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                y = call()
            times.append((time.perf_counter() - t0) / inner)
    if not all(bool(torch.isfinite(t).all()) for t in _leaves(y)):
        raise FloatingPointError("timed call returned non-finite values")
    return statistics.median(times)


def _time_fwd_inv(app, x, iters=None, warmup=2):
    """Reference ``performVulkanFFTiFFT`` analog (utils_VkFFT.cpp:868):
    seconds a forward + inverse of ``app`` on ``x``, each call on the same
    input (a chain of unnormalized round trips grows by n a call); about
    `ITERS` calls where ``iters`` is None."""
    return _time_calls(lambda: app.inverse(app.forward(x)),
                       ITERS if iters is None else iters, warmup)


def _time_chain_fn(fn, x0, iters=None, warmup=2):
    """Seconds a call ``fn(x0)`` takes (see `_time_calls`; about `ITERS`
    calls where ``iters`` is None)."""
    return _time_calls(lambda: fn(x0), ITERS if iters is None else iters,
                       warmup)


def _name(shape) -> str:
    return "x".join(map(str, shape))


def _torch_fft_row(ctx, x: Planar, shape, dt: float, label: str, prefix: str,
                   iters: int):
    """Under -compare: ``torch.fft``'s ifftn(fftn(.)) of the same planes
    (cuFFT on the card) and the ratio (> 1: the port is faster)."""
    xc = torch.complex(x.re, x.im)
    dims = tuple(range(xc.ndim - len(shape), xc.ndim))
    dt_lib = _time_chain_fn(
        lambda v: torch.fft.ifftn(torch.fft.fftn(v, dim=dims), dim=dims), xc,
        iters=iters)
    ctx.log(f"  {label}{prefix}: torch.fft {dt_lib * 1e3:8.3f} ms  "
            f"vs torch.fft {dt_lib / dt:.3f}")


def _bench_systems(ctx, systems, dtype=np.complex64, target_bytes=None,
                   label="", iters=None):
    """Reference sample-0 pattern: sweep systems, batch each to the target
    size, print ms + bandwidth + aggregate score.  complex128 runs
    ``Precision.DOUBLE`` on float64 planes."""
    target = TARGET_BYTES if target_bytes is None else target_bytes
    double = np.dtype(dtype) == np.complex128
    itemsize = np.dtype(dtype).itemsize
    score = 0.0
    for shape in systems:
        n_elems = math.prod(shape)
        batch = max(1, target // (itemsize * n_elems))
        x = _device_planes((batch,) + shape, n_elems, ctx.device,
                           torch.float64 if double else torch.float32)
        cfg = FFTConfig(shape=shape, normalize=False,
                        precision=Precision.DOUBLE if double
                        else Precision.SINGLE)
        app = vt.get_application(cfg, ctx.engine, ctx.device)
        dt = _time_fwd_inv(app, x, iters=iters)
        nbytes = batch * n_elems * itemsize
        uploads = 2 * len(shape)  # fwd+inv, one read+write per axis pass
        gbs = nbytes * 2 * uploads / dt / 1e9
        score += nbytes / 1024 / (dt * 1e3)
        prefix = f"{_name(shape):>16} batch {batch:6d}"
        ctx.log(f"  {label}{prefix}: {dt * 1e3:8.3f} ms  est {gbs:7.1f} GB/s")
        if ctx.args.compare and not double:
            _torch_fft_row(ctx, x, shape, dt, label, prefix, iters)
        del x
    ctx.log(f"  benchmark score: {score / len(systems):.1f}")


def _precision_report(ctx, name, got, ref):
    diff = np.abs(got - ref)
    data_norm = np.abs(ref)
    eps = diff / np.maximum(data_norm.max(), 1e-300)
    ctx.log(f"  {name}: avg_diff {diff.mean():.3e}  max_diff {diff.max():.3e}  "
            f"avg_eps {eps.mean():.3e}  max_eps {eps.max():.3e}")
    return eps.max()


def _to_host(y) -> np.ndarray:
    """Planes, a tensor or host data -> numpy (planes as complex)."""
    if isinstance(y, Planar):
        return to_numpy(y)
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def _run_fft_host(x, engine, axes=None, inverse=False, device="cuda"):
    """Host data through `fftn` on ``device`` and back to numpy."""
    return _to_host(vt.fftn(x, axes=axes, engine=engine, inverse=inverse,
                            device=device))


def _double_app(ctx, shape):
    """A ``Precision.DOUBLE`` C2C application (unnormalized)."""
    cfg = FFTConfig(shape=shape, normalize=False, precision=Precision.DOUBLE)
    return vt.get_application(cfg, ctx.engine, ctx.device)


def _routes_line(ctx, routes: list):
    """The DOUBLE routes a sample's systems took (`api.double_route`)."""
    ctx.log(f"  DOUBLE routes: native {routes.count('native')}, "
            f"double-double {routes.count('dd')}")


# ---------------------------------------------------------------------------
# benchmark samples
# ---------------------------------------------------------------------------

@sample(0, "benchmark 1D batched C2C FP32 (pow-2)")
def sample_0(ctx):
    _bench_systems(ctx, [(1 << k,) for k in range(6, 13)])


@sample(1, "benchmark 1D batched C2C FP64 (DOUBLE: native fp64, CPU and GPU)")
def sample_1(ctx):
    _bench_systems(ctx, [(1 << k,) for k in range(6, 12)], dtype=np.complex128)


@sample(3, "benchmark 3D C2C FP32 (cube sweep, sample_3/1003 analog)")
def sample_3(ctx):
    """Reference sample_3 + the 3-D benchmark sweep of
    ``sample_1003_benchmark_VkFFT_single_3d_2_512.cpp``: pow-2 cubes to
    512^3 plus a non-pow-2 row (96 = 2^5*3, per-axis route)."""
    _bench_systems(ctx, SAMPLE_3_SYSTEMS)


@sample(6, "benchmark R2C/C2R FP32")
def sample_6(ctx):
    for n in (256, 1024, 4096):
        batch = max(1, TARGET_BYTES // (4 * n))
        x = _device_real((batch, n), n, ctx.device)
        dt = _time_chain_fn(
            lambda v, n=n: vt.irfft(vt.rfft(v, engine=ctx.engine), n=n,
                                    engine=ctx.engine), x)
        moved = 2 * 2 * batch * n * 4   # real r+w per direction class
        ctx.log(f"  R2C+C2R n={n:6d} batch {batch:6d}: {dt * 1e3:8.3f} ms  "
                f"est {moved / dt / 1e9:7.1f} GB/s")
        del x


@sample(7, "benchmark Bluestein (primes) FP32")
def sample_7(ctx):
    """Primes vs the smooth neighbor: 10007 (Bluestein), 7919 (Rader, p-1 =
    2*37*107), 10006 (SPLIT with a 5003 factor), and 10240 = 2^11*5 (the
    smooth neighbor the prime rows are judged against — same nominal-bytes
    formula, so the GB/s ratio IS the time-per-point ratio)."""
    _bench_systems(ctx, [(10007,), (7919,), (2 * 5003,), (10240,)],
                   target_bytes=SMALL_TARGET_BYTES)


# ---------------------------------------------------------------------------
# precision samples
# ---------------------------------------------------------------------------

_PRECISION_SYSTEMS_1D = [(1 << k,) for k in range(3, 15)] + [
    (6,), (12,), (60,), (120,), (360,), (1000,), (2310,),
]
# long-path (multi-upload four-step) systems to the reference's full 2^26
# envelope (sample_11_precision_VkFFT_single.cpp:78-90)
_PRECISION_SYSTEMS_LONG = [(1 << 17,), (1 << 20,), (1 << 22,), (1 << 24,),
                           (1 << 26,)]
# 4-D transforms (reference default VKFFT_MAX_FFT_DIMENSIONS=4,
# vkFFT/vkFFT.h:70-102)
_PRECISION_SYSTEMS_ND = [(8, 16), (32, 32), (16, 17, 4), (8, 8, 8),
                         (8, 8, 8, 8), (4, 8, 16, 8)]


@sample(11, "precision C2C FP32 vs fp64 oracle")
def sample_11(ctx):
    worst = 0.0
    for shape in (_PRECISION_SYSTEMS_1D + _PRECISION_SYSTEMS_LONG
                  + _PRECISION_SYSTEMS_ND):
        x = _rand_complex(shape, seed=1, dtype=np.complex64)
        got = _run_fft_host(x, ctx.engine, device=ctx.device)
        ref = np.fft.fftn(x.astype(np.complex128))
        worst = max(worst, _precision_report(ctx, _name(shape), got, ref))
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 1e-4 else 'FAIL'})")


@sample(12, "precision C2C FP64 vs fp64 oracle")
def sample_12(ctx):
    """The DOUBLE precision's one-flag ergonomics (reference
    ``doublePrecision``, ``vkFFT_Structs.h:187``): host complex128 through
    a DOUBLE application, native fp64 or double-double by its plan."""
    worst = 0.0
    routes = []
    for shape in _PRECISION_SYSTEMS_1D:
        x = _rand_complex(shape, seed=2, dtype=np.complex128)
        app = _double_app(ctx, shape)
        routes.append(app.double_route)
        got = app.forward(x.reshape(1, *shape))[0]
        ref = np.fft.fftn(x)
        worst = max(worst, _precision_report(ctx, f"{shape[0]}", got, ref))
    _routes_line(ctx, routes)
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 1e-12 else 'FAIL'})")


@sample(14, "precision non-pow2 + primes (Rader/Bluestein paths)")
def sample_14(ctx):
    worst = 0.0
    # primes toward the reference's ~1e5 envelope (Rader ceiling README.md:10,
    # Bluestein beyond): 32771/65537/99991 exercise the large-prime paths
    for n in [17, 31, 61, 67, 97, 101, 257, 641, 1009, 10007, 10006, 919,
              32771, 65537, 99991]:
        x = _rand_complex((3, n), seed=n, dtype=np.complex64)
        got = _run_fft_host(x, ctx.engine, axes=(-1,), device=ctx.device)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        worst = max(worst, _precision_report(ctx, f"n={n}", got, ref))
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 1e-3 else 'FAIL'})")


@sample(15, "precision R2C/C2R")
def sample_15(ctx):
    worst = 0.0
    kw = dict(engine=ctx.engine, device=ctx.device)
    for n in [8, 64, 256, 1024, 60, 1000, 17, 101]:
        rng = np.random.default_rng(n)
        x = rng.standard_normal((3, n)).astype(np.float32)
        got = _to_host(vt.rfft(x, **kw))
        ref = np.fft.rfft(x.astype(np.float64))
        worst = max(worst, _precision_report(ctx, f"n={n}", got, ref))
        back = _to_host(vt.irfft(got, n=n, **kw))
        worst = max(worst, _precision_report(ctx, f"n={n} inv", back,
                                             x.astype(np.float64)))
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 1e-4 else 'FAIL'})")


@sample(16, "precision DCT I-IV FP32")
def sample_16(ctx):
    worst = 0.0
    for t in (1, 2, 3, 4):
        # 1024/1000/255 exercise the in-kernel forms (incl. odd lengths)
        for n in (16, 64, 100, 256, 255, 1000, 1024):
            rng = np.random.default_rng(n * t)
            x = rng.standard_normal((3, n)).astype(np.float32)
            got = _to_host(vt.dct(x, type=t, engine=ctx.engine,
                                  device=ctx.device))
            j = np.arange(n)
            k = np.arange(n)[:, None]
            if t == 1:
                jj = np.arange(1, n - 1)
                M = 2 * np.cos(np.pi * jj * k / (n - 1))
                ref = x[..., :1] + ((-1.0) ** k[:, 0]) * x[..., -1:] + x[..., 1:-1] @ M.T
            elif t == 2:
                ref = x @ (2 * np.cos(np.pi * (2 * j + 1) * k / (2 * n))).T
            elif t == 3:
                jj = np.arange(1, n)
                ref = x[..., :1] + x[..., 1:] @ (2 * np.cos(np.pi * jj * (2 * k + 1) / (2 * n))).T
            else:
                ref = x @ (2 * np.cos(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * n))).T
            worst = max(worst, _precision_report(ctx, f"DCT-{t} n={n}", got, ref))
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 1e-3 else 'FAIL'})")


@sample(17, "precision DST I-IV FP32")
def sample_17(ctx):
    worst = 0.0
    kw = dict(engine=ctx.engine, device=ctx.device)
    for t in (1, 2, 3, 4):
        for n in (16, 64, 100, 255, 1024):
            rng = np.random.default_rng(n * t + 7)
            x = rng.standard_normal((2, n)).astype(np.float32)
            got = vt.dst(x, type=t, **kw)
            back = _to_host(vt.idst(got, type=t, **kw))
            worst = max(worst, _precision_report(ctx, f"DST-{t} n={n} roundtrip",
                                                 back, x.astype(np.float64)))
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 1e-3 else 'FAIL'})")


# ---------------------------------------------------------------------------
# convolution samples
# ---------------------------------------------------------------------------

@sample(50, "convolution: 1D 3x3 identity matrix kernel")
def sample_50(ctx):
    n = 32
    x = _rand_complex((3, n), seed=5)
    kern = np.zeros((3, 3, n))
    for c in range(3):
        kern[c, c, 0] = 1.0
    cfg = FFTConfig(shape=(n,), convolution=True, matrix_convolution=3,
                    coordinate_features=3)
    app = vt.ConvolutionApplication(cfg, kern, engine=ctx.engine,
                                    device=ctx.device)
    y = _to_host(app(x))
    err = np.abs(y - x).max()
    ctx.log(f"  identity 3x3 matrix conv max err: {err:.3e} "
            f"({'PASS' if err < 1e-4 else 'FAIL'})")


@sample(52, "convolution: 2D batched scalar kernel vs oracle")
def sample_52(ctx):
    shape = (16, 32)
    x = _rand_complex((4,) + shape, seed=6)
    h = _rand_complex(shape, seed=7)
    cfg = FFTConfig(shape=shape, convolution=True)
    app = vt.ConvolutionApplication(cfg, h, engine=ctx.engine,
                                    device=ctx.device)
    y = _to_host(app(x))
    ref = np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(h))
    err = np.abs(y - ref).max() / np.abs(ref).max()
    ctx.log(f"  2D conv rel err: {err:.3e} ({'PASS' if err < 1e-4 else 'FAIL'})")


@sample(100, "benchmark multidim DCT FP32 (types 2 and 4, odd sizes incl.)")
def sample_100(ctx):
    # n=255 exercises the odd-length in-kernel forms; type 4 the per-line
    # DCT-IV kernel
    for t in (2, 4):
        for n in (256, 1024, 255):
            batch = max(1, TARGET_BYTES // (4 * n))
            x = _device_real((batch, n), n, ctx.device)
            # idct inverts dct exactly: the same input each call
            dt = _time_chain_fn(
                lambda v, t=t: vt.idct(vt.dct(v, type=t, engine=ctx.engine),
                                       type=t, engine=ctx.engine), x)
            moved = 2 * 2 * batch * n * 4
            ctx.log(f"  DCT-{t}+inv n={n} batch {batch}: {dt * 1e3:8.3f} ms  "
                    f"est {moved / dt / 1e9:7.1f} GB/s")
            del x


@sample(1000, "sweep: EVERY system 2..4096 FP32 precision")
def sample_1000(ctx):
    """Reference sample_1000 runs *every* n in 2..4096
    (``sample_1000_benchmark_VkFFT_single_2_4096.cpp:77``), here on either
    device (the JAX package ran a subset on its TPU)."""
    worst = 0.0
    worst_n = 0
    count = 0
    for n in range(2, 4097):
        x = _rand_complex((2, n), seed=n, dtype=np.complex64)
        got = _run_fft_host(x, ctx.engine, axes=(-1,), device=ctx.device)
        ref = np.fft.fft(x.astype(np.complex128), axis=-1)
        eps = np.abs(got - ref).max() / np.abs(ref).max()
        if eps > worst:
            worst, worst_n = eps, n
        count += 1
    ctx.log(f"  {count} systems, worst rel err {worst:.3e} at n={worst_n} "
            f"({'PASS' if worst < 1e-4 else 'FAIL'})")


@sample(200, "user benchmark (-X/-Y/-Z/-P/-B/-N/-R2C/-DCT)")
def sample_200(ctx):
    a = ctx.args
    shape = tuple(s for s in (a.Z, a.Y, a.X) if s > 1) or (a.X,)
    batch = a.B
    if a.DCT:
        axes = tuple(range(-len(shape), 0))   # the system's, not the batch
        x = _device_real((batch,) + shape, 0, ctx.device)
        dt = _time_chain_fn(
            lambda v: vt.dctn(v, type=a.DCT, axes=axes, engine=ctx.engine),
            x, iters=a.N)
        ctx.log(f"  DCT-{a.DCT} {shape} batch {batch}: {dt * 1e3:.3f} ms")
        return
    if a.R2C:
        n = shape[-1]
        x = _device_real((batch,) + shape, 0, ctx.device)
        dt = _time_chain_fn(
            lambda v: vt.irfft(vt.rfft(v, engine=ctx.engine), n=n,
                               engine=ctx.engine), x, iters=a.N)
        ctx.log(f"  R2C+C2R {shape} batch {batch}: {dt * 1e3:.3f} ms")
        return
    if a.load:
        # reference -load FILE: loadApplicationFromString from a user file
        with open(a.load, "rb") as f:
            app = cache.load_application_from_string(
                f.read(), engine=ctx.engine, device=ctx.device)
        shape = app.config.shape
        ctx.log(f"  loaded plan blob from {a.load}")
    else:
        cfg = FFTConfig(shape=shape, normalize=False,
                        precision=Precision.DOUBLE if a.P else Precision.SINGLE)
        app = vt.get_application(cfg, ctx.engine, ctx.device)
    if a.save:
        # reference -save FILE: saveApplicationToString to a user file
        with open(a.save, "wb") as f:
            f.write(cache.save_application_to_string(app))
        ctx.log(f"  saved plan blob to {a.save}")
    double = app.config.precision is Precision.DOUBLE
    x = _device_planes((batch,) + shape, 0, ctx.device,
                       torch.float64 if double else torch.float32)
    dt = _time_fwd_inv(app, x, iters=a.N)
    nbytes = batch * math.prod(shape) * (16 if double else 8)
    gbs = nbytes * 2 * 2 * len(shape) / dt / 1e9
    ctx.log(f"  {shape} batch {batch}: {dt * 1e3:.3f} ms  est {gbs:.1f} GB/s")
    if a.compare and not double:
        _torch_fft_row(ctx, x, shape, dt, "", f"{shape} batch {batch}", a.N)


@sample(2, "benchmark bf16/fp16 storage C2C (halfPrecisionMemoryOnly analog)")
def sample_2(ctx):
    for n in (256, 1024, 4096):
        batch = max(1, TARGET_BYTES // (4 * n))
        cfg = FFTConfig(shape=(n,), precision=Precision.BFLOAT16,
                        normalize=True)
        app = vt.get_application(cfg, ctx.engine, ctx.device)
        # bf16 planes in, so every call reads the storage dtype
        p = _device_planes((batch, n), n, ctx.device).astype(torch.bfloat16)
        dt = _time_fwd_inv(app, p)
        moved = 2 * 2 * 2 * batch * n * 2   # bf16 planes, r+w, fwd+inv
        ctx.log(f"  bf16 storage n={n} batch {batch}: {dt*1e3:8.3f} ms  "
                f"est {moved/dt/1e9:7.1f} GB/s of bf16 bytes")
        del p


@sample(9, "benchmark double-double (quad-class) C2C")
def sample_9(ctx):
    """Reference ``sample_9_benchmark_VkFFT_quadDoubleDouble.cpp`` analog:
    fwd+inv at a real batch, effective GB/s over the quad planes (4 fp32
    planes per complex value = the dd storage footprint); the inverse's
    1/n rides its pass."""
    for n in (256, 1024):
        batch = max(128, SMALL_TARGET_BYTES // (16 * n))
        p = _device_planes((batch, n), n, ctx.device)
        z = torch.zeros_like(p.re)
        x = DDComplex(DD(p.re, z), DD(p.im, z))

        def fwd_inv(v, n=n):
            return fft_lines_dd(fft_lines_dd(v, n, False), n, True, 1.0 / n)

        dt = _time_chain_fn(fwd_inv, x, iters=min(ITERS, 20))
        moved = 4 * 4 * batch * n * 4  # quad planes, r+w, fwd+inv
        ctx.log(f"  dd n={n} batch {batch}: {dt*1e3:8.3f} ms/iter  "
                f"est {moved/dt/1e9:7.1f} GB/s")
        del p, z, x


@sample(19, "precision double-double vs fp64 oracle (quad-tier check)")
def sample_19(ctx):
    worst = 0.0
    # Rader covers primes > 13
    for n in (8, 64, 100, 256, 101, 1024, 17, 97):
        rng = np.random.default_rng(n)
        x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
        got = fft_dd(x, device=ctx.device)
        ref = np.fft.fft(x)
        worst = max(worst, _precision_report(ctx, f"n={n}", got, ref))
    ctx.log(f"  WORST max_eps: {worst:.3e} ({'PASS' if worst < 5e-14 else 'FAIL'})")


@sample(10, "plan save/load (binary cache analog, sample-0 pattern)")
def sample_10(ctx):
    cfg = FFTConfig(shape=(1024,), normalize=True)
    app = vt.get_application(cfg, ctx.engine, ctx.device)
    blob = cache.save_application_to_string(app)
    app2 = cache.load_application_from_string(blob, engine=ctx.engine,
                                              device=ctx.device)
    xd = from_complex(_rand_complex((8, 1024), seed=3), ctx.device)
    y1 = app.forward(xd)
    y2 = app2.forward(xd)
    ok = all(torch.equal(a, b) for a, b in zip(_leaves(y1), _leaves(y2)))
    ctx.log(f"  plan blob {len(blob)} bytes, reloaded app bitwise-equal: {ok} "
            f"({'PASS' if ok else 'FAIL'})")


@sample(4, "benchmark zero-padded C2C FP32 (3-D work elision; sample_4 analog)")
def sample_4(ctx):
    """Reference sample_4
    (``sample_4_benchmark_VkFFT_single_3d_zeropadding.cpp``) benchmarks
    three-dimensional transforms with half-size declared-zero windows on
    every axis, where zero-pad elision compounds.  The 1-D rows time full
    round trips, and ``fft_lines`` with and without its read window for
    the kernel-level ratio."""

    # The reference's full 39-system table (2-D rows + 3-D cubes,
    # ``sample_4...zeropadding.cpp:69-78``; its size[0] is the contiguous
    # dim -> reversed into our row-major shape).  It runs on the torch
    # engine or with --full; else a representative subset.
    ref_2d = [(1024, 1024), (720, 480), (1280, 720), (1920, 1080),
              (2560, 1440), (3840, 2160), (7680, 4320)]
    ref_2d += [(1 << a, 1 << b) for a, b in
               ((6, 6), (7, 6), (7, 7), (8, 7), (8, 8), (9, 8), (9, 9),
                (10, 9), (10, 10), (11, 10), (11, 11), (12, 11), (12, 12),
                (13, 12), (13, 13), (14, 13))]
    ref_3d = [(1 << a, 1 << b, 1 << c) for a, b, c in
              ((4, 4, 4), (5, 4, 4), (5, 5, 4), (5, 5, 5), (6, 5, 5),
               (6, 6, 5), (6, 6, 6), (7, 6, 6), (7, 7, 6), (7, 7, 7),
               (8, 7, 7), (8, 8, 7), (8, 8, 8), (9, 8, 8), (9, 9, 8),
               (9, 9, 9))]
    full_sweep = ctx.engine == "torch" or ctx.args.full
    if full_sweep:
        systems = ([tuple(reversed(d)) for d in ref_2d]
                   + [tuple(reversed(d)) for d in ref_3d])
        target = DCT_ND_BYTES if ctx.engine == "torch" else SMALL_TARGET_BYTES
    else:
        systems = SAMPLE_4_SYSTEMS
        target = TARGET_BYTES
    score_f = score_p = 0.0
    rated = 0
    for shape in systems:
        n_el = math.prod(shape)
        batch = max(1, target // (8 * n_el))
        x = _device_planes((batch,) + shape, n_el, ctx.device)
        # reference pad window: [ceil(size/2), size) per axis
        zp = tuple((-(-d // 2), d) for d in shape)
        full = vt.get_application(FFTConfig(shape=shape), ctx.engine,
                                  ctx.device)
        pad = vt.get_application(FFTConfig(shape=shape, zeropad_input=zp),
                                 ctx.engine, ctx.device)
        dt_f = _time_chain_fn(full.forward, x)
        dt_p = _time_chain_fn(pad.forward, x)
        del x
        kb = batch * n_el * 8 / 1024.0
        score_f += kb / (dt_f * 1e3)
        score_p += kb / (dt_p * 1e3)
        rated += 1
        ctx.log(f"  {_name(shape):>14s} batch {batch:4d} fwd: "
                f"full {dt_f*1e3:8.3f} ms  half-pad {dt_p*1e3:8.3f} ms "
                f"({dt_f/dt_p:.2f}x, mode: {pad.zeropad_mode})")
    if rated:
        ctx.log(f"  benchmark score (sum KB/ms / {rated}): "
                f"full {score_f/rated:.0f}  half-pad {score_p/rated:.0f}")

    # -- 1-D: round trips + fft_lines with and without its read window --
    for n in (1024, 4096):
        batch = max(1, TARGET_BYTES // (8 * n))
        x = _device_planes((batch, n), n, ctx.device)
        full = vt.get_application(FFTConfig(shape=(n,), normalize=True),
                                  ctx.engine, ctx.device)
        pad = vt.get_application(
            FFTConfig(shape=(n,), normalize=True,
                      zeropad_input=((n // 2, n),)), ctx.engine, ctx.device)
        mid = vt.get_application(
            FFTConfig(shape=(n,), zeropad_input=((n // 4, 3 * n // 4),)),
            ctx.engine, ctx.device)
        rt_full = _time_fwd_inv(full, x)
        rt_pad = _time_fwd_inv(pad, x)
        dt_mid = _time_chain_fn(mid.forward, x)
        # the kernel-level forward ratio: fft_lines on the whole lines
        # against its windowed entry reading the first n/2 points
        s = float(1.0 / np.sqrt(n))
        window = ck.line_window(n, in_keep=n // 2)
        kf = _time_chain_fn(lambda p: Planar(*ck.fft_lines(p.re, p.im, False,
                                                           s)), x)
        kp = _time_chain_fn(lambda p: Planar(*ck.fft_lines(
            p.re, p.im, False, s, window=window)), x)
        ctx.log(f"  n={n} batch {batch}: rt full {rt_full*1e3:8.3f} ms  "
                f"rt half-pad {rt_pad*1e3:8.3f} ms ({rt_full/rt_pad:.2f}x)  "
                f"fwd-kernel {kf/kp:.2f}x  "
                f"interior fwd {dt_mid*1e3:8.3f} ms "
                f"(mode: {mid.zeropad_mode})")
        del x


@sample(5, "benchmark no-reorder 4-step (disableReorderFourStep analog)")
def sample_5(ctx):
    """Reference sample_5: skipping the 4-step reorder pass keeps output in
    swapped digit order for extra bandwidth (``disableReorderFourStep``).
    Here: keep_intermediate_order=True vs natural order."""
    for n in (4096, 65536):
        batch = max(1, SMALL_TARGET_BYTES // (8 * n))
        x = _device_planes((batch, n), n, ctx.device)
        nat = vt.get_application(FFTConfig(shape=(n,)), ctx.engine, ctx.device)
        swp = vt.get_application(
            FFTConfig(shape=(n,), keep_intermediate_order=True), ctx.engine,
            ctx.device)
        dt_nat = _time_fwd_inv(nat, x)
        dt_swp = _time_fwd_inv(swp, x)
        ctx.log(f"  n={n} batch {batch}: natural {dt_nat*1e3:8.3f} ms  "
                f"swapped {dt_swp*1e3:8.3f} ms  speedup {dt_nat/dt_swp:.2f}x")
        del x
    # 2-D pair tl form: the opaque (nz, ny) intermediate skips one in-tile
    # transpose per direction
    ny = nz = 256
    batch = max(1, SMALL_TARGET_BYTES // (8 * ny * nz))
    x2 = _device_planes((batch, ny, nz), ny, ctx.device)
    nat2 = vt.get_application(FFTConfig(shape=(ny, nz)), ctx.engine, ctx.device)
    tl2 = vt.get_application(
        FFTConfig(shape=(ny, nz), keep_intermediate_order=True), ctx.engine,
        ctx.device)
    dt_nat2 = _time_fwd_inv(nat2, x2)
    dt_tl2 = _time_fwd_inv(tl2, x2)
    ctx.log(f"  2-D {ny}x{nz} batch {batch}: natural {dt_nat2*1e3:8.3f} "
            f"ms  pair-tl {dt_tl2*1e3:8.3f} ms  "
            f"speedup {dt_nat2/dt_tl2:.2f}x")


@sample(8, "benchmark Bluestein/Rader FP64 (DOUBLE: double-double at these "
           "lengths, CPU and GPU)")
def sample_8(ctx):
    _bench_systems(ctx, [(10007,), (7919,)], dtype=np.complex128,
                   target_bytes=FP64_BLUESTEIN_BYTES, iters=min(ITERS, 10))


@sample(13, "precision bf16/fp16 storage C2C vs fp64 oracle (sample_13 analog)")
def sample_13(ctx):
    """Reference sample_13 tests true fp16 compute; the port's half tiers
    are storage-only with fp32 compute (config.Precision) — the bound
    tested here is the bf16/fp16 quantization floor, not fp32 accuracy."""
    worst = 0.0
    for prec, tol in ((Precision.BFLOAT16, 8e-2), (Precision.HALF, 1e-2)):
        for n in (64, 256, 1024):
            rng = np.random.default_rng(n)
            xr = rng.standard_normal((4, n)).astype(np.float32)
            xi = rng.standard_normal((4, n)).astype(np.float32)
            cfg = FFTConfig(shape=(n,), precision=prec)
            app = vt.get_application(cfg, ctx.engine, ctx.device)
            got = _to_host(app.forward(from_numpy_planar(xr, xi, ctx.device)))
            ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
            eps = _precision_report(ctx, f"{prec.value} n={n}", got, ref)
            worst = max(worst, 0.0 if eps < tol else eps)
    ctx.log(f"  {'PASS' if worst == 0.0 else f'FAIL worst {worst:.3e}'}")


@sample(18, "precision non-pow2 FP64 (DOUBLE: native fp64 or double-double)")
def sample_18(ctx):
    worst = 0.0
    routes = []
    for n in [6, 12, 60, 120, 360, 1000, 2310, 17, 101, 919, 1009]:
        x = _rand_complex((3, n), seed=n, dtype=np.complex128)
        app = _double_app(ctx, (n,))
        routes.append(app.double_route)
        got = app.forward(x)
        ref = np.fft.fft(x, axis=-1)
        worst = max(worst, _precision_report(ctx, f"n={n}", got, ref))
    _routes_line(ctx, routes)
    ctx.log(f"  WORST max_eps: {worst:.3e} "
            f"({'PASS' if worst < 1e-12 else 'FAIL'})")


@sample(51, "convolution: 3D zero-padded real-input 3x3 matrix kernel")
def sample_51(ctx):
    """Reference sample_51 (3-D zero-padded R2C matrix convolution): real
    input, 3x3 matrix kernel, zero-padding declared on the last axis; then
    the zero-pad elision factor of the fused 2-D conv route."""
    shape = (8, 8, 32)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3,) + shape)
    x[..., shape[-1] // 2:] = 0
    kern = rng.standard_normal((3, 3) + shape) + 1j * rng.standard_normal((3, 3) + shape)
    cfg = FFTConfig(shape=shape, convolution=True, matrix_convolution=3,
                    coordinate_features=3,
                    zeropad_input=(None, None, (shape[-1] // 2, shape[-1])))
    app = vt.ConvolutionApplication(cfg, kern, engine=ctx.engine,
                                    device=ctx.device)
    y = _to_host(app(x))
    X = np.fft.fftn(x, axes=(-3, -2, -1))
    K = np.fft.fftn(kern, axes=(-3, -2, -1))
    ref = np.fft.ifftn(np.einsum("ij...,j...->i...", K, X), axes=(-3, -2, -1))
    err = np.abs(y - ref).max() / np.abs(ref).max()
    ctx.log(f"  3D zero-padded matrix conv rel err: {err:.3e} "
            f"({'PASS' if err < 1e-4 else 'FAIL'})")

    # -- benchmark: the zero-pad elision factor on the fused conv route:
    # 2-D scalar kernels with the data in a declared corner
    shape2 = (256, 256)
    batch = max(1, TARGET_BYTES // (8 * math.prod(shape2)))
    kern2 = rng.standard_normal(shape2) + 1j * rng.standard_normal(shape2)
    xfull = (rng.standard_normal((batch,) + shape2)
             + 1j * rng.standard_normal((batch,) + shape2)).astype(np.complex64)
    xpad = np.array(xfull)
    xpad[:, shape2[0] // 2:, :] = 0
    xpad[:, :, shape2[1] // 2:] = 0
    dense = vt.ConvolutionApplication(
        FFTConfig(shape=shape2, convolution=True), kern2,
        engine=ctx.engine, device=ctx.device)
    padded = vt.ConvolutionApplication(
        FFTConfig(shape=shape2, convolution=True,
                  zeropad_input=tuple((d // 2, d) for d in shape2)),
        kern2, engine=ctx.engine, device=ctx.device)
    xd = from_complex(xfull, ctx.device)
    xp = from_complex(xpad, ctx.device)
    dt_d = _time_chain_fn(dense, xd)
    dt_p = _time_chain_fn(padded, xp)
    ctx.log(f"  2D {shape2} scalar conv batch {batch}: dense "
            f"{dt_d*1e3:8.3f} ms  half-pad^2 {dt_p*1e3:8.3f} ms "
            f"({dt_d/dt_p:.2f}x; modes {dense.fusion_mode} / "
            f"{padded.fusion_mode})")


@sample(101, "benchmark multidim DCT FP64 (CPU) / FP32 (GPU)")
def sample_101(ctx):
    # float64 where the plain engine runs the data (the CPU); the card's
    # and the cuda engine's real kernels take float32 (queue 1 item 10)
    plain = ctx.device.type == "cpu" and ctx.engine != "cuda"
    dt_np = torch.float64 if plain else torch.float32
    # 96x96 exercises non-pow2; the cubes cover the strided R2R passes
    for shape in ((64, 64), (96, 96), (32, 32, 32)):
        batch = max(1, DCT_ND_BYTES // (8 * math.prod(shape)))
        x = _device_real((batch,) + shape, 0, ctx.device, dt_np)
        axes = tuple(range(-len(shape), 0))   # the system's, not the batch
        for t in (2, 3):
            dt = _time_chain_fn(
                lambda v, t=t: vt.dctn(v, type=t, axes=axes,
                                       engine=ctx.engine), x,
                iters=min(ITERS, 5))
            ctx.log(f"  DCT-{t} {_name(shape)} batch {batch} "
                    f"[{str(dt_np).replace('torch.', '')}]: "
                    f"{dt * 1e3:.3f} ms")
        del x


@sample(1001, "sweep: 1D FP64 2..4096 (DOUBLE: native fp64 or double-double)")
def sample_1001(ctx):
    """Every n in 2..4096 like the reference's sample_1001, each through a
    DOUBLE application (the JAX package ran a double-double subset on its
    TPU)."""
    worst = 0.0
    count = 0
    routes = []
    for n in range(2, 4097):
        x = _rand_complex((2, n), seed=n, dtype=np.complex128)
        app = _double_app(ctx, (n,))
        routes.append(app.double_route)
        got = app.forward(x)
        ref = np.fft.fft(x, axis=-1)
        worst = max(worst, np.abs(got - ref).max() / np.abs(ref).max())
        count += 1
    _routes_line(ctx, routes)
    ctx.log(f"  {count} systems, worst rel err {worst:.3e} "
            f"({'PASS' if worst < 1e-12 else 'FAIL'})")


@sample(1002, "sweep: 1D bf16-storage subset (fp16-sweep analog)")
def sample_1002(ctx):
    worst = 0.0
    count = 0
    for n in (8, 16, 32, 64, 128, 256, 512, 1024, 60, 100, 360):
        rng = np.random.default_rng(n)
        xr = rng.standard_normal((2, n)).astype(np.float32)
        xi = rng.standard_normal((2, n)).astype(np.float32)
        app = vt.get_application(
            FFTConfig(shape=(n,), precision=Precision.BFLOAT16), ctx.engine,
            ctx.device)
        got = _to_host(app.forward(from_numpy_planar(xr, xi, ctx.device)))
        ref = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
        worst = max(worst, np.abs(got - ref).max() / np.abs(ref).max())
        count += 1
    ctx.log(f"  {count} systems, worst rel err {worst:.3e} "
            f"({'PASS' if worst < 8e-2 else 'FAIL'})")


@sample(1003, "sweep: double-double (quad-class) subset")
def sample_1003(ctx):
    worst = 0.0
    sizes = (8, 16, 32, 64, 100, 128, 256, 360)
    for n in sizes:
        rng = np.random.default_rng(n)
        x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
        got = fft_dd(x, device=ctx.device)
        ref = np.fft.fft(x)
        worst = max(worst, np.abs(got - ref).max() / np.abs(ref).max())
    ctx.log(f"  {len(sizes)} systems, worst rel err {worst:.3e} "
            f"({'PASS' if worst < 1e-10 else 'FAIL'})")


@sample(1004, "sweep: 3D cubes FP32 precision")
def sample_1004(ctx):
    worst = 0.0
    sizes = (4, 8, 12, 16, 24, 32, 48, 64)
    for n in sizes:
        x = _rand_complex((n, n, n), seed=n, dtype=np.complex64)
        got = _run_fft_host(x, ctx.engine, device=ctx.device)
        ref = np.fft.fftn(x.astype(np.complex128))
        worst = max(worst, np.abs(got - ref).max() / np.abs(ref).max())
    ctx.log(f"  cubes {sizes}, worst rel err {worst:.3e} "
            f"({'PASS' if worst < 1e-4 else 'FAIL'})")


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _list_devices(device: torch.device) -> None:
    if device.type == "cpu":
        print(f"  device 0: cpu ({platform.machine()}, {os.cpu_count()} "
              f"threads, torch {torch.__version__})")
        return
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"  device {i}: {p.name} (cuda, compute capability "
              f"{p.major}.{p.minor}, {p.total_memory / 2**30:.1f} GiB)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="vkfft_tpu_torch test/benchmark suite "
                    "(VkFFT_TestSuite analog)")
    ap.add_argument("-vkfft", "-sample", dest="sample", type=int, default=None,
                    help="sample number to run (see -list)")
    ap.add_argument("-list", action="store_true", help="list samples")
    ap.add_argument("-devices", action="store_true", help="list devices")
    ap.add_argument("-o", dest="output", default=None, help="append results to file")
    ap.add_argument("--engine", default=None, choices=["cuda", "torch"],
                    help="execution engine (default: by the data's device)")
    ap.add_argument("--cpu", action="store_true",
                    help="put the data on the CPU (default: the first CUDA "
                         "device)")
    ap.add_argument("--full", action="store_true",
                    help="sample 4: run the reference's full 39-system "
                         "table (default on the torch engine)")
    ap.add_argument("-X", type=int, default=1024)
    ap.add_argument("-Y", type=int, default=1)
    ap.add_argument("-Z", type=int, default=1)
    ap.add_argument("-P", type=int, default=0, help="0 fp32, 1 fp64")
    ap.add_argument("-B", type=int, default=1, help="batch")
    ap.add_argument("-N", type=int, default=10, help="iterations")
    ap.add_argument("-R2C", type=int, default=0)
    ap.add_argument("-DCT", type=int, default=0)
    ap.add_argument("-save", default=None, metavar="FILE",
                    help="sample 200: write the plan blob to FILE "
                         "(saveApplicationToString analog)")
    ap.add_argument("-load", default=None, metavar="FILE",
                    help="sample 200: build the application from a plan "
                         "blob file (loadApplicationFromString analog)")
    ap.add_argument("-compare", action="store_true",
                    help="second-implementation race: run the sample on "
                         "both engines (cuda kernels vs torch tensor ops), "
                         "the timed C2C rows beside torch.fft — the "
                         "cuFFT/rocFFT comparison-suite analog")
    args = ap.parse_args(argv)

    if args.list or args.sample is None and not args.devices:
        print("available samples:")
        for num in sorted(_SAMPLES):
            print(f"  {num:5d}  {_SAMPLES[num][1]}")
        return 0
    try:
        device = torch.device("cpu") if args.cpu else resolve_device("cuda")
    except RuntimeError as e:
        print(f"vkfft_tpu_torch.cli: {e}; the CLI takes --cpu for that",
              file=sys.stderr)
        return 2
    if args.devices:
        _list_devices(device)
        return 0
    if args.sample not in _SAMPLES:
        ap.error(f"no sample {args.sample} (see -list)")

    fn, desc = _SAMPLES[args.sample]
    engines = ["cuda", "torch"] if args.compare else [args.engine]
    for eng in engines:
        ctx = Ctx(argparse.Namespace(**dict(vars(args), engine=eng)), device)
        try:
            label = f" [engine={eng}]" if args.compare else ""
            ctx.log(f"sample {args.sample}: {desc}{label}")
            t0 = time.perf_counter()
            fn(ctx)
            ctx.log(f"  done in {time.perf_counter() - t0:.1f} s")
        finally:
            ctx.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
