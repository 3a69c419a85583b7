"""Smoke run of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases NAME,...]

Phases (each asserts; any failure exits non-zero before the result line):
  1. device and toolchain: the card's name and power limit, torch, CUDA and
     nvcc versions; builds the CUDA kernels from vkfft_tpu_torch/csrc;
  2. each kernel against its plain torch version on the card (<= 1e-5 of
     max|ref|), at every length the kernels take (the real kernels at
     every even n whose n/2 they take, up to 16384, alternating direction
     and layout), and on a subset against numpy fp64 (<= 5e-6); fft_lines
     also at named lengths in both directions, in place and with its
     output inside sentinel guards; fft_pair also on planes whose long
     axis runs as two factors, on every PAIR_SWEEP_STRIDE-th plane it
     serves and the first of each layout class, both directions, and on
     planes of several clusters in place and inside sentinel guards;
     fft_r2c/fft_c2r at named lengths in both layouts and directions with
     their outputs inside sentinel guards, aligned and not; fft_r2c_pair
     on every R2C_PAIR_SWEEP_STRIDE-th real plane it serves and the first
     of each layout class, both directions, and on planes of several
     clusters inside sentinel guards; fft_strided at every length it
     serves at S = 1 and 37, both directions, inside sentinel guards and
     in place, and on the first length of each layout class at S = 4096
     and 65536; then the
     API's other routes (axis subsets, odd, tiny and length-1 axes, complex
     tensors, the real transforms' merged, tiny and explicit-n routes, the
     numpy rule for Im(DC/Nyquist), irfftn with an s that crops or pads
     the complex axes, inputs left unchanged, long-tier lengths that once
     were refused);
  3. the main path at full width, each part with the launch counters set
     to 0 just before it and read just after: C2C through FFTApplication,
     batched 1-D at n = 256, 1024, 4096 with 128 MB of planar data each
     (forward plus normalized inverse) and fftn/ifftn of a 256^3 cube (the
     pair kernel on the two minor axes, the strided kernel on the leading
     one), where every C2C kernel's counter must rise; then three R2C
     paths, each counted apart and held to the exact launches it must
     make: bench.py's r2c row (1-D n = 1024, 32768 lines, 128 MB of real
     data) through FFTApplication (2 of fft_r2c), the same through
     rfft/irfft on a real tensor (2 of fft_r2c), and rfftn/irfftn of a
     real 256^3 cube (2 of the real pair kernel on axes 1-2, 2 of the
     strided kernel on axis 0 of the half spectrum); the plain engine's
     counter must stay 0 throughout;
  4. times with CUDA events (warm-up, then the median of 20 runs of 10
     back-to-back calls): each kernel at the main path's shapes (the
     strided kernel also on the real cube's (1, 256, 33024) half spectrum,
     both directions), held against its plain version there (<= 1e-5 of
     max|ref|; fft_lines, fft_r2c/fft_c2r, fft_pair, fft_r2c_pair and
     fft_strided with their registers, spills, layouts and blocks an SM,
     and a sweep of their layouts: fft_lines' and fft_r2c's splits, lines
     a block and points a thread, fft_pair's and fft_r2c_pair's cluster
     and points a thread, fft_strided's columns a block; fft_pair also
     beside the two axis passes it replaces; fft_strided also at the long
     axes n = 64, 1024, 4096, 8192 over 2^24 points, and on the half
     spectrum in place and on more allocations; fft_r2c_pair also on a
     208^3 cube, its instantiation with the generic stage), and each
     end-to-end round trip,
     beside the HBM-bandwidth bound and the torch.fft time of the same
     function;
  5. lengths of any size: fft_conv, fft_twofactor, fft_conv_inv and
     fft_conv_pair against their plain versions at every third length
     they serve on the routes of the 1-D plans of 5..16384 (and numpy on
     a subset); fft_twofactor also at 113, 134, 7918, 10240, 12288 and
     16384 in all four forms (both directions, both digit orders), in
     place, and with its output inside sentinel guards, aligned and not
     (no write outside the output), fft_conv_pair likewise at
     CONV_PAIR_NAMED in both directions; every third n in 5..16384, and named ones, through
     vt.fft/vt.ifft against numpy, where none may raise (SWEEP_STRIDE = 1
     takes every length); Rader and Bluestein non-minor axes; rfft/irfft
     of the half-length route;
  6. the reference's sample 7 (n = 10007 Bluestein, 7919 Rader, 10006
     SPLIT, 10240 DIRECT; 64 MiB each) through FFTApplication, each row
     counted from 0 and held to its exact launches, then the four new
     kernels at those shapes (fft_twofactor also at 512 x 16384 and
     125203 x 67, each row with its registers, spills, layout and
     resident blocks an SM; fft_conv_pair with its registers, spills,
     layout, resident clusters and blocks an SM, and the sweep of its
     plane and cluster at m = 32768) and the rows' round trips timed as
     in 4;
  7. DCT/DST types I-IV: fft_dct23, fft_dct1 and fft_dct4 against their
     plain versions and scipy fp64 at every third length their gates take
     (both flags, non-unit scales); every type of dct/dst/idct/idst at
     every third n in 2..4096 and named ones (none may raise), dctn/dstn;
     the reference's sample 100 (idct(dct(x, t), t), t = 2, 4, n = 256,
     1024, 255 at 128 MiB), DCT-I/DST-I round trips at n = 1025/1023 and
     sample 101 (FFTApplication(kind=DCT) of (96, 96) and (32, 32, 32),
     t = 2, 3, batched to 128 MiB), each row counted from 0 and held to
     its exact launches; then the three kernels and the rows timed as in
     4 (with their layouts, registers, spills and blocks an SM, and the
     layout sweep of fft_dct23, fft_dct4 and fft_dct1), beside
     torch.fft.rfft + irfft of the same data (not the same
     function: no PyTorch call computes a DCT) and, for the N-D rows, the
     share of the round trip outside the kernels.
  8. convolution (ConvolutionApplication): conv_kernels, the new modes of
     fft_conv (rows, matrix mm = 2 and 3) and the 2-D mode of
     fft_conv_pair against their plain versions, each with and without
     conjugated data and cross-power, at the main path's shapes and a
     spread of lengths (and numpy on the small cases), fft_conv at one
     shape of every layout class of conv_layout in each mode and flag
     (and its Bluestein mode), fft_conv_inv at one length of every
     twofactor_layout class with and without the x0 term, both against
     numpy fp64 too and launched inside sentinel guards at float offsets
     0..3, and every prime 11..127 through each walk kernel that runs it
     as a generic stage (fft_twofactor, fft_lines, fft_conv, fft_dct23,
     fft_dct4, fft_r2c_pair); conv_routes, every
     fusion mode, flag and composition case at small shapes against numpy,
     and fftconvolve; conv_main_path, the reference's samples 50-52 and
     the other modes' rows at 128 MiB of complex64 data (v3_1d at 4096 x
     4096, sample 50's 3 x 3 matrix at 5461 x 3 x 1024, sample 52 / 51's
     dense bench at 256 x 256 x 256 as pair, 64 x 512 x 512 as v3_rows, 8
     x 32 x 256 x 256 as pair with per-slice spectra, 1638 x 10240 as
     v2_2k, sample 51's zero-padded 3 x 3 matrix at 21 x 3 x 64^3 as the
     composition), each counted from 0 and held to its exact launches, two
     seeded items of each against numpy fp64; conv_times, the kernels at
     those shapes (held against their plain versions) and each row's call
     timed as in 4, beside the bound and the torch.fft composition of the
     same function (fftn, the multiply or einsum, ifftn), fft_conv's rows
     with its registers, spills, split, layout and blocks an SM, and the
     sweep of its layout constants (CONV_SWEEP) at each row's shape.
  9. the long tier: long_kernels, fft_strided_tw (the factor mode of
     fft_strided) against its plain version on every factor form of the
     long tier (two uploads, three uploads' two passes, the Bluestein
     chirp with live lengths that are not multiples of S, the folded
     order's transposed store and read, its second pass over (js, ka)
     columns and its interleaved third), both directions, and numpy fp64
     on the smaller cases; long_routes, DIRECT
     lengths 16385..2^20 (sampled, with 16400 and 20480), Bluestein
     32771 / 65537 / 99991, SPLIT 131 * 32768, rfft/irfft at 40960 and
     65542, a long non-minor axis and three uploads forced at 2^20 and
     2^22 against numpy, none of which may raise; long_main_path, the
     reference's sample 11 long systems (2^17 .. 2^26, one line each,
     vkfft_tpu/cli.py:272) against numpy fp64 at 5e-6, a 2^20 row at 128
     MiB of planes (16 lines) and one 2^28 line (its oracle torch.fft in
     complex128 on the card; the smallest power of two the port's split
     sends to three uploads is sample 11's 2^24), each counted from 0 and
     held to its exact launches (the reorder folded into a pass where
     cuda_kernels.long_folds holds); long_times, fft_strided_tw at the
     2^20 row's shapes (the folded and the natural passes, with layout,
     registers, spills at most 64 and none, blocks an SM), the two
     placements of the folded reorder beside the unfolded route, and the
     2^20, 2^22, Bluestein 65537, 2^24 and 2^26 round trips, beside the
     bound, the reorder's share (0 where folded) and torch.fft.
 10. the double-double tier (Precision.DOUBLE, DDComplex, fft_dd) on
     fft_dd: dd_kernels, its lines and strided entries against their
     plain versions at every 8th 13-smooth length to 4096 and named ones
     (64, 256, 1024, 4096 on the power-of-two instantiation, 13, 1144,
     4095 on the general one; direction alternating, odd S, P > 1, the
     pre/post tables and scale), the general instantiation forced on the
     powers of two, and Rader's pointwise entry, <= 1e-13 of max|ref|
     (not KERNEL_TOL: broken EFTs pass at 1e-5), each entry's refusal of
     a plan its instantiation lacks, a subset against torch.fft in
     complex128 on the card (<= 5e-14), and both instantiations launched
     on tiles of several per plane and on lines with their outputs inside
     sentinel guards (no write outside the output); dd_routes, fft_dd at sample 19's
     sizes and four-step, Rader and Bluestein lengths (<= 5e-14 of
     numpy), sample 12's complex-free systems 8..4096 through host
     complex128 (<= 1e-12), a 3-D shape as a complex tensor, DDComplex
     and widened Planar; dd_main_path, the reference's sample 9 (n = 256
     and 1024, 64 MiB of quad planes, vkfft_tpu/cli.py:567-612), a 3-D
     (64, 256, 256) row and a four-step 2^16 x 64 row through
     FFTApplication(DOUBLE), forward and normalized inverse, each counted
     from 0 and held to its exact launches with no plain dd call;
     dd_times, the entries at those shapes beside the bound, the
     computed fp32 issue floor, the plain time and torch.fft in
     complex128, with each row's instantiation, registers, spills and
     resident blocks an SM, and each row's round trip with the host's
     enqueue time of one.
 11. walk_times: the kernels the walk's generic stage and the conv
     redesign changed, at the rows PERF.md compares (fft_conv's Rader 5003
     and conv rows, fft_conv_inv and fft_twofactor at 1059 x 7918,
     fft_dct23 / fft_dct4 at 255, fft_lines at 1001 beside 1024,
     fft_r2c_pair on the 208^3 cube), fft_strided_tw at 16 x 512 x 2048,
     fft_dct1 at DCT-I 1025 / DST-I 1023 and the long round trips, with
     registers and spills; it runs
     unchanged on an older package, so the parent's kernels are timed by
     this script in the same call.

 12. native fp64 (Precision.DOUBLE's native route, api.double_route):
     f64_kernels, the fp64 instantiations of fft_lines, fft_strided and
     fft_pair against their plain fp64 versions (<= 1e-13 of max|ref|) on
     a sample of every layout class, in place and against torch.fft
     complex128 (<= 5e-14) on the first of each class; f64_routes, DOUBLE
     at F64_ROUTE_LENGTHS and N-D shapes, each native (fp64 launches only)
     or on the dd tier (fft_dd only) as double_route names, every input
     form, SINGLE on complex128; f64_main_path, FFTApplication(DOUBLE) on
     complex128 tensors at n = 256 / 1024 / 4096 on 128 MiB and fftn /
     ifftn of a complex128 256^3 cube, each counted from 0 and held to its
     exact fp64 launches with no fft_dd launch and no plain call, against
     torch.fft complex128 and the input (<= 5e-14); f64_times, the fp64
     kernels at those shapes (32 B a point a pass; registers, spills,
     layout, blocks an SM) beside their plain versions and torch.fft
     complex128, and each row's round trip on complex128 tensors and on
     float64 planes beside torch.fft complex128 and the dd tier on the
     same data (DDComplex planes, and the dd route on the tensor).  The toolchain phase holds every fp32
     kernel's ptxas line to FP32_PTXAS and every fp64 kernel to no spill.
 13. the storage tiers (Precision.HALF / BFLOAT16) and half real and
     convolution data: storage_kernels, the half-storage instantiations of
     fft_lines, fft_twofactor, fft_strided, fft_pair, fft_strided_tw,
     fft_conv (its scalar, rows, matrix and Bluestein modes with their
     flags), fft_conv_inv and fft_conv_pair (the Bluestein mode, and the
     2-D mode's fft_conv2d_<dtype> entries on every layout class) against
     their plain versions (<= 2 storage ulps of max|plain|, no inf or nan)
     at both dtypes, each case three times inside sentinel guards, at half
     offsets off the planes' 8-byte groups, and in place (the factor
     mode's transposed, interleaved and cropped layouts on inputs at those
     offsets); storage_routes, Rader 7919 and 5003, Bluestein 10007, SPLIT
     10006 and the long tier's 2^17 at both tiers with exactly the half
     launches their routes name, half rfft / irfft at 1024, 10006 and
     2^18 and rfftn / irfftn of a 3-D volume (the forward's C2C on the
     half kernels, the widened inverse and the complex axes after the
     untangle on the fp32 ones, each direction's launches exact), every
     fused convolution mode on half planes with its exact half launches,
     and every DIRECT length of samples 2, 13 and 1002 on the half
     fft_lines; storage_main_path, sample 2's rows at 128 MiB / (4 n)
     lines, sample 7's rows, the 256^3 cube, ex02's (16, 64) plane,
     samples 13 and 1002, and the long rows (2^20 x 16, 2^22 x 4, 2^24,
     2^26, Bluestein 65537 x 127) through FFTApplication at both tiers;
     the half real rows (rfft / irfft of 65536 lines of 1024, rfftn /
     irfftn of the 256^3 cube) and conv rows (sample 52's 256 planes of
     256^2, v3_1d 4096, sample 50's 3 x 3 matrix at 1024, v2_2k 10240) at
     both dtypes; each counted from 0 and held to its exact launches,
     finite, against fp64 at the reference's gates and against the CPU's
     torch engine; storage_times, the kernels beside the bound at 2 B a
     real, the fp32 kernel on the same points and torch.fft complex32 (the
     half 2-D conv beside its composition ifft2(fft2(x) * H)), and the
     rows' round trips and calls beside the fp32 ones.  The toolchain
     phase holds each half kernel's ptxas line to its fp32 twin's.
 14. zero-pad windows (FFTApplication's zeropad_input / zeropad_output):
     zeropad_kernels, the windowed entries of fft_lines, fft_twofactor,
     fft_strided and fft_pair (vk_<name>_zp and their fp64 and half
     instantiations) against their plain versions in every window form
     (kept prefixes of 1, 7, n - 1 and n / 3 + 1 read from whole and from
     cropped planes, interior windows, cropped, filled and zero-windowed
     outputs, corners of wider planes read in place), fp32 <= 1e-5, half
     <= 2 storage ulps, fp64 <= 1e-13, the declared-zero input cells NaN
     (a read of one would show), every output inside sentinel guards,
     written zeros exact, and the windowed kernels' ptxas lines printed;
     zeropad_routes, every zeropad_mode kind through FFTApplication in
     fp32 and bf16 with its exact windowed launches (a masked route its
     unwindowed kernels), no plain-engine call, against fp64 at the gates
     and against the CPU's torch engine; zeropad_main_path, the
     reference's sample 4 rows (vkfft_tpu/cli.py:658-700: 256^3 on the
     pair corner route, 512^3 and 2048 x 4096 on the axes route) and the
     v3 / interior / v2 / pair_out / ex05 rows at full size, each held to
     its exact launches and zeropad_mode; zeropad_times, each row's round
     trip beside the unwindowed transform and torch.fft, with the host's
     enqueue time, the device time replayed from a CUDA graph and the
     points moved (the byte ratio), and each windowed fp32 kernel beside
     its unwindowed launch on the same planes, its plain version,
     torch.fft and its bound at the kept bytes.  The convolution's "pair"
     mode with windows rides the same phases: fft_conv_pair's windowed
     2-D entry (vk_fft_conv2d_zp, _bf16, _f16) in zeropad_kernels at input
     corners (1, 1), (7, 13), (ny / 2, nz / 2), (ny - 1, nz - 1) read from
     whole and cropped planes and the same output corners; windowed
     ConvolutionApplication calls in zeropad_routes; sample 51's benchmark
     (256 planes of 256^2, half-pad^2 input windows: one fft_conv2d_zp
     launch, no mask) and a 3-D (8, 256, 256) convolution windowed on
     every axis in zeropad_main_path; both beside their dense twins, the
     masked route and the torch.fft composition in zeropad_times.
 15. keep_intermediate_order: keep_order_kernels, fft_lines' and
     fft_pair's tl entries (vk_<name>_tl, _bf16, _f16) and fft_twofactor
     swapped at split_lane_major (every length where that is not its
     own split, 8208 on) against their plain versions, both directions,
     inside sentinel guards, with their ptxas lines; keep_order_routes,
     FFTApplication with the flag on each form (n <= 4, fft_lines'
     lengths, the v2 lengths, pairs) in fp32 and bf16, each round trip's
     exact launches, the forward decoded against fp64; keep_order_main_
     path, sample 5's rows (vkfft_tpu/cli.py:770-805: n = 4096 and 65536
     at 64 MiB, the 256^2 pair) held to their exact launches (2 tl
     launches a round trip, 65536 its natural long route);
     keep_order_times, each round trip beside its natural twin and
     torch.fft with the host's enqueue time, and each tl kernel beside its
     natural launch, plain version, torch.fft and bound.  The toolchain
     phase holds the new kernels' ptxas lines to NEW_PTXAS.
 16. the distributed layer (vkfft_tpu_torch.parallel):
     parallel_routes, on a world of one rank on NCCL in this process,
     transpose_back (slab and pencil), the real pencil, complex64 and
     complex128 tensors against the single-device transforms, then a gloo
     world of PAR_WORLD ranks spawned on the one card (NCCL refuses two
     ranks on one GPU; gloo stages the exchanges through the host):
     __graft_entry__.dryrun_multichip's checks at 256^3 (slab, pencil (2,
     2), the real slab, pfft, a hybrid mesh with overlap_chunks=2), each
     rank's shard against its block of the single-device result, and its
     slab round trip timed by the host clock (host-staged, not a
     yardstick); parallel_main_path, the world of one: slab (chunk 1 and
     2) and pencil (1, 1) round trips of the 256^3 cube, prfftn / pirfftn
     of the real cube, DistributedConvolution at 256^3 and pfft of 65536
     lines of 256, each counted from 0 and held to its exact launches and
     exchanges with no plain-engine call, against the port's single-device
     transform (<= KERNEL_TOL) and fp64 (<= NUMPY_TOL), chunk 2 bit for bit
     chunk 1; parallel_times, the world of one's slab and pencil round
     trips at 256^3 and 512^3 beside FFTApplication on the same cube, with
     each exchange's time, its pack's, their share, the host's enqueue
     time, and at 256^3 where the host's and the card's time go.
     parallel_multi_gpu, run only when named and on a machine with
     PAR_WORLD cards (a machine of four): a NCCL world of a rank a card,
     the same checks, the launches of each rank's slab round trip, and
     the slab and pencil round trips at 256^3 and 512^3 beside
     FFTApplication on one card.
 17. plan blobs, the build cache, debug introspection and the examples
     (vkfft_tpu_torch.cache, .debug, .planner.native, examples_torch/):
     cache_main_path, six applications at full width (CACHE_ROWS: 1-D
     C2C 1024 at 128 MB, the 256^3 cube, R2C 1024, DOUBLE 256, kept order
     4096, sample 4's windowed 256^3) built, their plan blobs saved and
     run, then reloaded from the blob files in a second Python process
     that points the build cache at this run's build directory and reruns
     the same inputs (and inverts this process's TlSpectrum): every output
     torch.equal, the same launches, the native core loaded there, the
     build directory's listing unchanged (no compiler ran); the cold
     build's seconds against the warm process's time to its first result,
     and the planning of n = 1 .. 2^16 on the native core against the
     Python body; debug_main_path, describe / memory_layout / dump_kernels
     of those applications and sample 7's lengths against the launch
     counters and cuda_engine.route, and a profile_trace of the 256^3
     round trip read back (the route's device kernels in it, no
     torch_engine frame, its five longest device operations); examples,
     every examples_torch/ex*.py on the card (ex09 a NCCL world of a rank
     a visible card), each printing "ok", nothing compiled.

Every number is printed as it is measured; the whole record also goes to
chiprun_out/chip_smoke.json.  The last lines are a JSON object describing
each kernel, the card's name and power limit, and
{"ok": true, "device": {...}}.

--phases runs only the named phases, in their order (say
toolchain,dd_kernels,dd_times to iterate on fft_dd,
toolchain,f64_kernels,f64_routes,f64_main_path,f64_times on the fp64
kernels and DOUBLE's native route,
toolchain,storage_kernels,storage_routes,storage_main_path,storage_times
on the half-storage kernels and the HALF / BFLOAT16 tiers,
toolchain,zeropad_kernels,zeropad_routes,zeropad_main_path,zeropad_times
on the windowed entries and the zero-pad routes (with the convolution's),
toolchain,keep_order_kernels,keep_order_routes,keep_order_main_path,
keep_order_times on the tl entries and keep_intermediate_order,
toolchain,parallel_routes,parallel_main_path,parallel_times on the
distributed layer, toolchain,parallel_multi_gpu on four cards,
toolchain,cache_main_path,debug_main_path,examples on the plan blobs, the
build cache, debug introspection and the example twins,
toolchain,any_kernels,any_times on fft_twofactor and fft_conv_pair,
toolchain,conv_kernels,conv_times on fft_conv and fft_conv_inv (with the
layout sweep), toolchain,walk_times beside an older tree,
toolchain,kernels,times on fft_lines, fft_pair and fft_strided,
toolchain,long_kernels,long_times on fft_strided_tw and the long tier's
fold, toolchain,r2r_kernels,r2r_times on fft_dct23, fft_dct1 and
fft_dct4, or toolchain,real_kernels,real_times on fft_r2c and
fft_r2c_pair), writes their record
to chiprun_out/chip_smoke_phases.json and prints no result line.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-5             # kernel vs its plain version, of max|ref|
NUMPY_TOL = 5e-6              # vs numpy fp64, the gate of tests/test_pallas.py
TARGET_BYTES = 128 * 1024 * 1024
ROWS_1D = (256, 1024, 4096)
CUBE = (256, 256, 256)
# a real cube whose planes need fft_r2c_pair's generic stage (208 = 16 * 13)
GENERIC_CUBE = (208, 208, 208)
R2C_N = 1024                  # bench.py's r2c row: 128 MB of real data
R2C_LINES = TARGET_BYTES // (4 * R2C_N)
C2C_KERNELS = ("fft_lines", "fft_strided", "fft_pair")
R2C_KERNELS = ("fft_r2c", "fft_r2c_pair")
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


def _host_ms(fn, calls: int = 20) -> float:
    """Host time a call takes to enqueue ``fn``'s work, the card synchronized
    before and after: where it reaches the call's device time, the host
    bounds the call and the card idles between its kernels."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def _planes(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev))


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled kernel, with its first template
    argument when it has one: dd_lines_kernel<0>."""
    import re
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name, i = mangled, 0
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        name, i = s[j:j + int(s[i:j])], j + int(s[i:j])
    arg = re.match(r"ILi(\d+)E", s[i:])
    return name + (f"<{arg.group(1)}>" if arg else "")


def _ptxas_kernels(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of each
    entry function in a ``-Xptxas -v`` log (fft_dd's <0> and <1>: the
    power-of-two and the general instantiation)."""
    import re
    rows, name, spills = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spills = _kernel_name(m.group(1)), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append((name, int(m.group(1))) + spills)
            name = None
    return rows


def _ptxas_lines(log: str) -> dict:
    """{kernel: "<stack frame and spills> | <registers, barriers, ...>"}
    of each entry function in a ``-Xptxas -v`` log."""
    import re
    out, name, frame = {}, None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, frame = _kernel_name(m.group(1)), ""
        if "bytes stack frame" in ln and name:
            frame = ln.strip()
        m = re.search(r"ptxas info\s*: (Used \d+ registers.*)", ln)
        if m and name:
            out[name] = f"{frame} | {m.group(1).strip()}"
            name = None
    return out


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
    lines, f64 = {}, {}
    for name, path in paths.items():
        with open(path[:-3] + ".log") as f:
            log = f.read()
        info[f"ptxas_{name}"] = [ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln]
        # every kernel: (kernel, registers, spill stores, loads)
        info[f"ptxas_{name}_kernels"] = _ptxas_kernels(log)
        lines.update(_ptxas_lines(log))
        f64.update({k: (r, st, ld) for k, r, st, ld in _ptxas_kernels(log)
                    if k.endswith("_f64_kernel")})
    for k, v in info.items():
        _log(f"[toolchain] {k}: {v}")
    # every fp32 kernel compiles as before the walk took its complex type
    # as a template argument; every fp64 instantiation without a spill;
    # every half-storage one as its fp32 twin
    changed = {k: (lines.get(k), v) for k, v in FP32_PTXAS.items()
               if lines.get(k) != v}
    storage = {k: lines.get(k) for k in STORAGE_TWINS}
    off_twin = _storage_ptxas_ok(lines)
    info["fp32_ptxas_as_pinned"] = not changed
    info["f64_ptxas"] = f64
    info["storage_ptxas"] = storage
    _log(f"[toolchain] fp32 ptxas lines as pinned: {not changed} "
         f"{changed or ''}; fp64 kernels {f64}; half-storage kernels as "
         f"their fp32 twins: {not off_twin} {off_twin or ''}")
    assert not changed, changed
    # the kept-order entries and the windowed ones as pinned
    fresh = {k: v for k, v in lines.items() if "_tl_" in k or "_zp" in k}
    for k, v in sorted(fresh.items()):
        _log(f"[toolchain] {k}: {v}")
    moved = {k: (lines.get(k), v) for k, v in NEW_PTXAS.items()
             if lines.get(k) != v}
    info["new_ptxas"] = fresh
    assert not moved, moved
    assert all(st == ld == 0 for _, st, ld in f64.values()), f64
    assert all(v is not None for v in storage.values()), storage
    assert not off_twin, off_twin
    return info


# fft_lines' named lengths: the shortest, odd and prime lines several to a
# block (one pass), the main path's 256 (one pass), 1024 and 4096 (two
# factors), and lines of two factors alone in a block (2048, 3591 = 63 *
# 57, 7175 = 175 * 41, 8192)
LINES_NAMED = (2, 3, 47, 256, 1024, 2048, 3591, 4096, 7175, 8192)


# fft_pair: planes whose long axis runs as two factors (z: 8064 = 112 x
# 72, 7182 = 114 x 63; y: 8064, and 4096 one pass over 2 blocks), the
# stride of the sweep over the served planes, and the planes launched
# inside sentinel guards, several clusters each (256 x 256 over 8 blocks,
# an odd plane over 1, columns of 3 over 4 blocks, two factors over 2)
PAIR_TWO_FACTOR = ((2, 2, 8064), (2, 8064, 2), (3, 2, 7182), (3, 4096, 4))
PAIR_SWEEP_STRIDE = 97
PAIR_GUARDED = ((3, 256, 256), (5, 47, 60), (3, 64, 12), (3, 2, 8064))
# fft_strided's checks at large S: at most this many points a case
STRIDED_POINTS = 1 << 19
# fft_strided's long axes, each over 2^24 points (P = 1), and the columns
# a block of its layout sweep at n = 256
STRIDED_LONG = (64, 1024, 4096, 8192)
STRIDED_SWEEP_COLUMNS = (8, 16, 32, 64)
# fft_strided on the real cube's half spectrum, timed again on this many
# more pairs of planes
STRIDED_ALLOCATIONS = 3


def _pair_served(ck) -> list:
    """Every (ny, nz) plane fft_pair serves (`pair_cluster`)."""
    lengths = [n for n in range(2, ck.KERNEL_MAX_N + 1)
               if ck.kernel_supports(n)]
    return [(ny, nz) for ny in lengths for nz in lengths
            if ny * nz <= 131072 and ck.pair_cluster(ny, nz) is not None]


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
                   (256, 256, 256)] + list(PAIR_TWO_FACTOR)
    for (B, ny, nz) in pair_shapes:
        xr, xi = _planes((B, ny, nz), B + ny * nz, dev)
        for inverse in (False, True):
            scale = 1.0 / (ny * nz) if inverse else 1.0
            yr, yi = ck.fft_pair(xr, xi, inverse, scale)
            torch.cuda.synchronize()
            pr, pi = ck.fft_pair_plain(xr, xi, inverse, scale)
            err = _rel(torch.complex(yr, yi), torch.complex(pr, pi))
            row = {"shape": [B, ny, nz], "layout": ck.pair_layout(ny, nz),
                   "splits": ck.pair_splits(ny, nz),
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
    # fft_pair over the planes it serves: every PAIR_SWEEP_STRIDE-th and
    # the first of each layout class (cluster, threads, which axes run as
    # two factors, the column tile's width mod 4), both directions
    served = _pair_served(ck)
    classes, picked = {}, []
    for i, (ny, nz) in enumerate(served):
        c, threads, _ = ck.pair_layout(ny, nz)
        (_, n2z), (_, n2y) = ck.pair_splits(ny, nz)
        key = (c, threads, n2z > 1, n2y > 1, (nz // c) % 4)
        if key not in classes or i % PAIR_SWEEP_STRIDE == 0:
            classes.setdefault(key, (ny, nz))
            picked.append((ny, nz))
    worst = 0.0
    for i, (ny, nz) in enumerate(picked):
        xr, xi = _planes((2, ny, nz), i, dev)
        for inverse in (False, True):
            scale = 1.0 / (ny * nz) if inverse else 0.5
            err = _rel(torch.complex(*ck.fft_pair(xr, xi, inverse, scale)),
                       torch.complex(*ck.fft_pair_plain(xr, xi, inverse,
                                                        scale)))
            assert err <= KERNEL_TOL, ("fft_pair", ny, nz, inverse, err)
            worst = max(worst, err)
    out["pair_sweep"] = {"served": len(served), "checked": len(picked),
                         "classes": len(classes), "worst": worst}
    _log(f"[kernels] fft_pair over the served planes: {out['pair_sweep']}")
    # fft_pair on planes of several clusters, both directions, in place and
    # with its output inside sentinel guards, aligned and not
    out["fft_pair_guarded"] = {"launches": 0, "occupancy": {}}
    for (B, ny, nz) in PAIR_GUARDED:
        out["fft_pair_guarded"]["occupancy"][f"{ny}x{nz}"] = \
            ck.pair_occupancy(ny, nz)
        xr, xi = _planes((B, ny, nz), ny + nz, dev)
        for inverse in (False, True):
            scale = 1.0 / (ny * nz) if inverse else 0.5
            plain = ck.fft_pair_plain(xr, xi, inverse, scale)
            inplace = (xr.clone(), xi.clone())
            got = ck.fft_pair(*inplace, inverse, scale, out=inplace)
            err = _rel(torch.complex(*got), torch.complex(*plain))
            assert err <= KERNEL_TOL, ("fft_pair in place", ny, nz, err)
            for offset in (0, 1):
                got, changed = _guarded(
                    lambda *p, out: ck.fft_pair(*p, inverse, scale, out=out),
                    (xr, xi), offset)
                err = _rel(torch.complex(*got), torch.complex(*plain))
                row = {"shape": [B, ny, nz], "inverse": inverse,
                       "offset": offset, "rel_err_plain": err,
                       "guard_cells_changed": changed}
                assert changed == 0 and err <= KERNEL_TOL, row
                out["fft_pair_guarded"]["launches"] += 1
    _log(f"[kernels] fft_pair guarded: {out['fft_pair_guarded']}")
    # fft_lines at named lengths (one pass, or two factors where a stage's
    # sequences do not fit a round), both directions, in place and with its
    # output inside sentinel guards, aligned and not
    out["fft_lines_guarded"] = {"launches": 0, "blocks_per_sm": {}}
    for n in LINES_NAMED:
        out["fft_lines_guarded"]["blocks_per_sm"][n] = ck.lines_occupancy(n)
        xr, xi = _planes((37 if n < 2048 else 5, n), n + 11, dev)
        for inverse in (False, True):
            scale = 1.0 / n if inverse else 0.5
            plain = ck.fft_lines_plain(xr, xi, inverse, scale)
            inplace = (xr.clone(), xi.clone())
            got = ck.fft_lines(*inplace, inverse, scale, out=inplace)
            assert got[0] is inplace[0] and got[1] is inplace[1]
            err = _rel(torch.complex(*got), torch.complex(*plain))
            assert err <= KERNEL_TOL, ("fft_lines in place", n, inverse, err)
            for offset in (0, 1):
                got, changed = _guarded(
                    lambda *p, out: ck.fft_lines(*p, inverse, scale, out=out),
                    (xr, xi), offset)
                err = _rel(torch.complex(*got), torch.complex(*plain))
                row = {"n": n, "inverse": inverse, "offset": offset,
                       "split": list(ck.lines_split(n)),
                       "rel_err_plain": err, "guard_cells_changed": changed}
                assert changed == 0 and err <= KERNEL_TOL, row
                out["fft_lines_guarded"]["launches"] += 1
    _log(f"[kernels] fft_lines guarded: {out['fft_lines_guarded']}")
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
    # fft_strided at every length it serves: S = 1 and 37 (a ragged tile)
    # in turn, both directions in turn, with its output inside sentinel
    # guards (aligned and not) and in place; then, on the first length of
    # each layout class at S = 4096 and 65536 (at most STRIDED_POINTS
    # points), the same
    out["fft_strided_guarded"] = {"launches": 0, "worst": 0.0,
                                  "classes": 0}

    def strided_case(P, n, S, inverse, offset):
        xr, xi = _planes((P, n, S), n + S, dev)
        scale = 1.0 / n if inverse else 0.5
        plain = ck.fft_strided_plain(xr, xi, inverse, scale)
        got, changed = _guarded(
            lambda *p, out: ck.fft_strided(*p, inverse, scale, out=out),
            (xr, xi), offset)
        err = _rel(torch.complex(*got), torch.complex(*plain))
        inplace = (xr.clone(), xi.clone())
        got = ck.fft_strided(*inplace, inverse, scale, out=inplace)
        assert got[0] is inplace[0] and got[1] is inplace[1]
        err = max(err, _rel(torch.complex(*got), torch.complex(*plain)))
        row = {"shape": [P, n, S], "inverse": inverse, "offset": offset,
               "layout": ck.strided_layout(n, S), "rel_err_plain": err,
               "guard_cells_changed": changed}
        assert changed == 0 and err <= KERNEL_TOL, row
        g = out["fft_strided_guarded"]
        g["launches"] += 2
        g["worst"] = max(g["worst"], err)

    for i, n in enumerate(covered):
        strided_case(3, n, (1, 37)[i % 2], bool((i // 2) % 2), (i // 4) % 2)
    for S in (4096, 65536):
        classes = {}
        for n in covered:
            ts, threads, _ = ck.strided_layout(n, S)
            key = (ck.strided_split(n, S)[1] > 1, ts, threads)
            classes.setdefault(key, n)
        for i, n in enumerate(classes.values()):
            ts = ck.strided_layout(n, S)[0]
            Sn = S if n * S <= STRIDED_POINTS else max(
                ts, STRIDED_POINTS // n // ts * ts + S % ts)
            strided_case(1, n, Sn, bool(i % 2), (i // 2) % 2)
        out["fft_strided_guarded"]["classes"] += len(classes)
    _log(f"[kernels] fft_strided guarded and in place: "
         f"{out['fft_strided_guarded']}")
    worst = {k: max(r["rel_err_plain"] for r in out[k])
             for k in C2C_KERNELS}
    _log(f"[kernels] worst rel err vs plain: {worst}")
    worst_np = {k: max(r.get("rel_err_numpy", 0.0) for r in out[k])
                for k in C2C_KERNELS}
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
    for n in (20480, 65537):   # the long tier
        xr, xi = _planes((2, n), n, dev)
        xc = torch.complex(xr, xi)
        y = vt.fft(vt.Planar(xr, xi))
        row = {"shape": [2, n], "axes": None, "rel_err_fwd": _rel(
            torch.complex(y.re, y.im), torch.fft.fft(xc))}
        assert row["rel_err_fwd"] <= NUMPY_TOL, row
        rows.append(row)
    _log(f"[routes] {len(rows)} fftn/ifftn cases, worst "
         f"{max(max(r['rel_err_fwd'], r.get('rel_err_round_trip', 0.0)) for r in rows)}")
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
    assert all(launches[k] > 0 for k in C2C_KERNELS), launches
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
    kernels = {name: [] for name in C2C_KERNELS}
    lines_shapes = [(TARGET_BYTES // (8 * n), n) for n in ROWS_1D]
    regs, spill_st, spill_ld = _ptxas_of(ck, "fft_lines")["fft_lines_kernel"]
    split_sweep = []
    for B, n in lines_shapes:
        xr, xi = _planes((B, n), n, dev)
        plain = ck.fft_lines_plain(xr, xi, False)
        err = _errors(ck.fft_lines(xr, xi, False), plain, ("fft_lines", B, n))
        xc = torch.complex(xr, xi)
        nbytes = 16.0 * B * n
        bound, by = _bound(nbytes, _fft_ops(B * n, n))
        ms = _time_ms(lambda: ck.fft_lines(xr, xi, False))
        threads, lines, smem = ck.lines_layout(n)
        row = {"shape": [B, n], "ms": ms, "GBs": nbytes / ms / 1e6,
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(lambda: ck.fft_lines_plain(xr, xi, False),
                                    reps=5, inner=1, warmup=1),
               "library_ms": _time_ms(lambda: torch.fft.fft(xc, dim=-1)),
               "split": list(ck.lines_split(n)), "threads": threads,
               "lines_per_block": lines, "smem_bytes": smem,
               "registers": regs, "spill_bytes": [spill_st, spill_ld],
               "blocks_per_sm": ck.lines_occupancy(n)}
        _log(f"[time] fft_lines {row}")
        kernels["fft_lines"].append(row)
        # the layout sweep: one pass and two factors (`_lines_splits`) at
        # other lines a block, points a thread and radices, timed in turns
        # (down the list, then up), each against the plain version first
        rows = []
        for split, (bp, aim) in ((p, v) for p in _lines_splits(ck, n)
                                 for v in LINES_SWEEP):
            v = {"split": list(split), "block_points": bp, "aim": aim}
            with _lines_layout_forced(ck, v):
                threads = ck.lines_layout(n)[0]
                seen = [(r["split"], r["layout"]) for r in rows]
                if (all(ck.walk_rounds_fit(m, threads, True)
                        for m in v["split"])
                        and (v["split"], list(ck.lines_layout(n))) not in seen):
                    v.update(shape=[B, n], layout=list(ck.lines_layout(n)),
                             blocks_per_sm=ck.lines_occupancy(n), ms=[])
                    rows.append(v)
        for v in rows + rows[::-1]:
            with _lines_layout_forced(ck, v):
                fn = lambda: ck.fft_lines(xr, xi, False)
                v["max_abs_err"] = _errors(fn(), plain, ("fft_lines", n, v))
                v["ms"].append(_time_ms(fn))
        split_sweep += rows
        _log(f"[time] fft_lines layout sweep n={n}: {rows}")
        del xr, xi, xc, plain
    # fft_strided at the main path's shapes, then the long axes over 2^24
    # points
    shapes = [(1, 256, 65536), (256, 256, 256)] + [
        (1, n, (1 << 24) // n) for n in STRIDED_LONG]
    for shape in shapes:
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
               "library_ms": _time_ms(lambda: torch.fft.fft(xc, dim=1)),
               **_strided_extra(ck, n, S)}
        _log(f"[time] fft_strided {row}")
        kernels["fft_strided"].append(row)
        del xr, xi, xc
    # the layout sweep at n = 256 over S = 65536 and 33024 (the real cube's
    # half spectrum): STRIDED_SWEEP_COLUMNS columns a block, timed in turns
    # (down the list, then up), each against the plain version first
    strided_sweep = []
    for S in (65536, 33024):
        xr, xi = _planes((1, 256, S), S, dev)
        plain = ck.fft_strided_plain(xr, xi, False)
        rows = []
        for ts in STRIDED_SWEEP_COLUMNS:
            v = {"tile_points": 256 * ts}
            with _strided_layout_forced(ck, v):
                v.update(shape=[1, 256, S], **_strided_extra(ck, 256, S),
                         ms=[])
            rows.append(v)
        for v in rows + rows[::-1]:
            with _strided_layout_forced(ck, v):
                fn = lambda: ck.fft_strided(xr, xi, False)
                v["max_abs_err"] = _errors(fn(), plain, ("fft_strided", v))
                v["ms"].append(_time_ms(fn))
        strided_sweep += rows
        del xr, xi, plain
    _log(f"[time] fft_strided layout sweep: {strided_sweep}")
    B, ny, nz = CUBE
    xr, xi = _planes(CUBE, 5, dev)
    plain = ck.fft_pair_plain(xr, xi, False)
    err = _errors(ck.fft_pair(xr, xi, False), plain, ("fft_pair", CUBE))
    xc = torch.complex(xr, xi)
    nbytes = 16.0 * B * ny * nz
    bound, by = _bound(nbytes, _fft_ops(B * ny * nz, ny * nz))
    regs, spill_st, spill_ld = _ptxas_of(ck, "fft_pair")["fft_pair_kernel"]

    def pair_extra():
        c, threads, smem = ck.pair_layout(ny, nz)
        clusters, blocks = ck.pair_occupancy(ny, nz)
        return {"cluster": c, "threads": threads,
                "smem_bytes": smem, "splits": ck.pair_splits(ny, nz),
                "registers": regs, "spill_bytes": [spill_st, spill_ld],
                "resident_clusters": clusters, "blocks_per_sm": blocks}

    # the two axis passes it replaces: fft_lines on the rows, fft_strided
    # down the columns
    lr, li = xr.view(B * ny, nz), xi.view(B * ny, nz)

    def axis_passes():
        zr, zi = ck.fft_lines(lr, li, False)
        return ck.fft_strided(zr.view(B, ny, nz), zi.view(B, ny, nz), False)

    ms = _time_ms(lambda: ck.fft_pair(xr, xi, False))
    row = {"shape": list(CUBE), "ms": ms,
           "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
           "max_abs_err": err,
           "plain_ms": _time_ms(lambda: ck.fft_pair_plain(xr, xi, False),
                                reps=5, inner=1, warmup=1),
           "library_ms": _time_ms(lambda: torch.fft.fft2(xc)),
           "axis_passes_ms": _time_ms(axis_passes), **pair_extra()}
    _log(f"[time] fft_pair {row}")
    kernels["fft_pair"].append(row)
    # the cluster sweep at 256 x 256: clusters of 4, 8 and 16 blocks
    # (PAIR_TILE_POINTS) at 8 or 16 points a thread, timed in turns (down
    # the list, then up), each against the plain version first
    pair_sweep = []
    for tile in (16384, 8192, 4096):
        for aim in (8, 16):
            v = {"tile_points": tile, "aim": aim}
            with _pair_layout_forced(ck, v):
                v.update(pair_extra(), ms=[])
            if all((p["cluster"], p["threads"]) != (v["cluster"], v["threads"])
                   for p in pair_sweep):
                pair_sweep.append(v)
    for v in pair_sweep + pair_sweep[::-1]:
        with _pair_layout_forced(ck, v):
            fn = lambda: ck.fft_pair(xr, xi, False)
            v["max_abs_err"] = _errors(fn(), plain, ("fft_pair", v))
            v["ms"].append(_time_ms(fn))
    _log(f"[time] fft_pair layout sweep: {pair_sweep}")
    del xr, xi, xc, plain

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
           # the host's enqueue time of one round trip: near "ms", the
           # host bounds the row
           "host_ms": _host_ms(lambda: vt.ifftn(vt.fftn(cube))),
           "torch_fft_ms": _time_ms(lambda: torch.fft.ifftn(torch.fft.fftn(cc)))}
    row["vs_torch_fft"] = row["torch_fft_ms"] / ms
    _log(f"[time] e2e {row}")
    e2e.append(row)
    return {"kernels": kernels, "e2e": e2e, "fft_lines_layout_sweep": split_sweep,
            "fft_pair_layout_sweep": pair_sweep,
            "fft_strided_layout_sweep": strided_sweep}


# fft_lines' layout sweep: (LINES_BLOCK_POINTS, points a thread) at each
# split of `_lines_splits`; the layouts a length does not fit are left out
LINES_SWEEP = tuple((bp, aim) for bp in (2048, 4096) for aim in (16, 32))
# fft_r2c's: (points a block, points a thread) of its m-point DFT
R2C_SWEEP = tuple((bp, aim) for bp in (1024, 2048, 4096) for aim in (8, 16, 32))


def _lines_splits(ck, n):
    """The splits the layout sweep times at length n: one pass, the rule's,
    twofactor_split's and the two factors of fewest stages after them."""
    two = sorted(((n // d, d) for d in range(2, n) if n % d == 0
                  and n // d >= d and ck.stage_radices(n // d)
                  and ck.stage_radices(d)),
                 key=lambda p: (len(ck.walk_radices(p[0]))
                                + len(ck.walk_radices(p[1])), -p[1]))
    out = [(n, 1), ck.lines_split(n), ck.twofactor_split(n)] + two[:3]
    return list(dict.fromkeys(out))


class _conv_pair_plan_forced:
    """fft_conv_pair's Bluestein mode with the plane and cluster ``plan``
    (nc, ns, cluster) at padded length m for the time of the block (its
    layout rule and the spectrum's plane order read
    `cuda_kernels.conv_pair_plan`; the cached device tables are dropped on
    the way in and out)."""

    def __init__(self, ck, m, plan):
        self.ck, self.m, self.plan = ck, m, plan

    def __enter__(self):
        ck, rule = self.ck, self.ck.conv_pair_plan
        self.rule = rule
        ck.conv_pair_plan = lambda m: self.plan if m == self.m else rule(m)
        ck._DEVICE_TABLES.clear()

    def __exit__(self, *exc):
        self.ck.conv_pair_plan = self.rule
        self.ck._DEVICE_TABLES.clear()


class _pair_layout_forced:
    """fft_pair and fft_r2c_pair with the tile points and points a thread
    of layout ``v`` for the time of the block (`cuda_kernels.pair_layout`
    and `r2c_pair_layout` read PAIR_TILE_POINTS and PAIR_AIM_POINTS)."""

    def __init__(self, ck, v):
        self.ck, self.v = ck, v

    def __enter__(self):
        ck, v = self.ck, self.v
        self.saved = (ck.PAIR_TILE_POINTS, ck.PAIR_AIM_POINTS)
        ck.PAIR_TILE_POINTS = v["tile_points"]
        ck.PAIR_AIM_POINTS = v["aim"]

    def __exit__(self, *exc):
        self.ck.PAIR_TILE_POINTS, self.ck.PAIR_AIM_POINTS = self.saved


def _strided_extra(ck, n, S) -> dict:
    """fft_strided's layout, registers, spills and blocks an SM at (n, S)."""
    regs, spill_st, spill_ld = _ptxas_of(ck, "fft_strided")[
        "fft_strided_kernel"]
    ts, threads, smem = ck.strided_layout(n, S)
    return {"columns": ts, "split": list(ck.strided_split(n, S)),
            "threads": threads, "smem_bytes": smem, "registers": regs,
            "spill_bytes": [spill_st, spill_ld],
            "blocks_per_sm": ck.strided_occupancy(n, S)}


class _strided_layout_forced:
    """fft_strided with the tile points of layout ``v`` for the time of
    the block (`cuda_kernels.strided_layout` reads STRIDED_TILE_POINTS)."""

    def __init__(self, ck, v):
        self.ck, self.v = ck, v

    def __enter__(self):
        self.saved = self.ck.STRIDED_TILE_POINTS
        self.ck.STRIDED_TILE_POINTS = self.v["tile_points"]

    def __exit__(self, *exc):
        self.ck.STRIDED_TILE_POINTS = self.saved


class _lines_layout_forced:
    """fft_lines with the split, lines a block and points a thread of
    layout ``v`` for the time of the block (its layout rule reads
    `cuda_kernels.lines_split`, LINES_BLOCK_POINTS, LINES_ONE_PASS_AIM and
    LINES_AIM_POINTS)."""

    def __init__(self, ck, v):
        self.ck, self.v = ck, v

    def __enter__(self):
        ck, v = self.ck, self.v
        self.saved = (ck.lines_split, ck.LINES_BLOCK_POINTS,
                      ck.LINES_ONE_PASS_AIM, ck.LINES_AIM_POINTS)
        ck.lines_split = lambda n, dtype=None: tuple(v["split"])
        ck.LINES_BLOCK_POINTS = v["block_points"]
        ck.LINES_ONE_PASS_AIM = ck.LINES_AIM_POINTS = v["aim"]

    def __exit__(self, *exc):
        (self.ck.lines_split, self.ck.LINES_BLOCK_POINTS,
         self.ck.LINES_ONE_PASS_AIM, self.ck.LINES_AIM_POINTS) = self.saved


class _r2c_layout_forced:
    """fft_r2c with the split, points a block and points a thread of
    layout ``v`` for the time of the block (its layout rule reads
    `cuda_kernels.r2c_split`, R2C_BLOCK_POINTS and R2C_AIM_POINTS)."""

    def __init__(self, ck, v):
        self.ck, self.v = ck, v

    def __enter__(self):
        ck, v = self.ck, self.v
        self.saved = (ck.r2c_split, ck.R2C_BLOCK_POINTS, ck.R2C_AIM_POINTS)
        ck.r2c_split = lambda n: tuple(v["split"])
        ck.R2C_BLOCK_POINTS = v["block_points"]
        ck.R2C_AIM_POINTS = v["aim"]

    def __exit__(self, *exc):
        (self.ck.r2c_split, self.ck.R2C_BLOCK_POINTS,
         self.ck.R2C_AIM_POINTS) = self.saved


def _numpy_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.double().cpu().numpy()


# fft_r2c's named lengths (real n): m = 2, odd m = 3 and 47, the main
# path's 1024 (one pass, 8 lines a block), m = 1000 and 1024 (two
# factors, 4 lines a block), 7182 (m = 63 * 57) and the longest, 16384
R2C_NAMED = (4, 6, 94, 1024, 2000, 2048, 7182, 16384)
R2C_GUARD = 1 << 14           # sentinel floats each side of an output


def _r2c_guarded(ck, x, packed, inverse, offset, dev):
    """One launch of fft_r2c (fft_c2r with ``inverse``, of x's plain
    spectrum) with its output planes inside a buffer of sentinel values
    (R2C_GUARD floats each side and ``offset`` more before): (the output,
    the plain version's, the guard cells the launch changed)."""
    B, n = x.shape
    m = n // 2
    spec = ck.fft_r2c_plain(x, packed)
    if inverse:
        shapes, want = [(B, n)], (ck.fft_c2r_plain(*spec, n, 2.0 / n, packed),)
    else:
        shapes, want = [(B, m if packed else m + 1)] * 2, spec
    numel, sentinel = B * shapes[0][1], 12345.0
    lead = R2C_GUARD + offset
    buf = torch.full((len(shapes), lead + numel + R2C_GUARD), sentinel,
                     device=dev)
    y = [buf[i, lead:lead + numel].view(shapes[i]) for i in range(len(shapes))]
    args = (list(spec) + y if inverse else [x] + y) + [
        B, int(packed), *ck._r2c_walk_args(n, inverse, 2.0 / n if inverse
                                           else 1.0, dev)]
    ck._launch("fft_r2c", "fft_c2r" if inverse else "fft_r2c", dev, args)
    changed = (int((buf[:, :lead] != sentinel).sum())
               + int((buf[:, lead + numel:] != sentinel).sum()))
    return (y[0] if inverse else tuple(y)), (want[0] if inverse else want), \
        changed


# fft_r2c_pair: the stride of the sweep over the real planes it serves,
# and the planes launched inside sentinel guards (the main path's 256 x
# 256, an odd column tile over 1 block, m = 8064's two factors over 2, odd
# m = 3 and 47)
R2C_PAIR_SWEEP_STRIDE = 97
R2C_PAIR_GUARDED = ((3, 256, 256), (2, 48, 6), (2, 2, 16128), (3, 16, 94))


def _r2c_pair_served(ck) -> list:
    """Every real (ny, nz) plane fft_r2c_pair serves (`r2c_pair_cluster`)."""
    lengths = [n for n in range(2, ck.KERNEL_MAX_N + 1)
               if ck.kernel_supports(n)]
    return [(ny, 2 * m) for ny in lengths for m in lengths
            if ny * m <= 131072 and ck.r2c_pair_cluster(ny, 2 * m) is not None]


def _r2c_pair_class(ck, ny, nz):
    """The layout class of a real plane: cluster, threads, which axes run
    as two factors, whether the column tile's width is odd, the forward's
    instantiation."""
    c, threads, _ = ck.r2c_pair_layout(ny, nz)
    (_, n2z), (_, n2y) = ck.r2c_pair_splits(ny, nz)
    return (c, threads, n2z > 1, n2y > 1, (nz // 2 // c) % 2,
            ck.r2c_pair_generic(ny, nz))


def _r2c_pair_guarded(ck, x, inverse, offset, dev):
    """One launch of fft_r2c_pair (fft_c2r_pair with ``inverse``, of x's
    plain spectrum, scaled to numpy's irfft2) with its output planes inside
    a buffer of sentinel values (R2C_GUARD floats each side and ``offset``
    more before): (the output, the plain version's, the guard cells the
    launch changed)."""
    B, ny, nz = x.shape
    h = nz // 2 + 1
    spec = ck.fft_r2c_pair_plain(x)
    if inverse:
        shapes = [(B, ny, nz)]
        want = (ck.fft_c2r_pair_plain(*spec, nz, 1.0 / ny, 2.0 / nz),)
    else:
        shapes, want = [(B, ny, h)] * 2, spec
    numel, sentinel = math.prod(shapes[0]), 12345.0
    lead = R2C_GUARD + offset
    buf = torch.full((len(shapes), lead + numel + R2C_GUARD), sentinel,
                     device=dev)
    y = [buf[i, lead:lead + numel].view(shapes[i]) for i in range(len(shapes))]
    args = (list(spec) + y if inverse else [x] + y) + [
        B, *ck._r2c_pair_args(ny, nz, inverse, 1.0 / ny if inverse else 1.0,
                              dev),
        *((2.0 / nz,) if inverse else ()), *ck.r2c_pair_layout(ny, nz)]
    ck._launch("fft_r2c_pair", "fft_c2r_pair" if inverse else "fft_r2c_pair",
               dev, args)
    changed = (int((buf[:, :lead] != sentinel).sum())
               + int((buf[:, lead + numel:] != sentinel).sum()))
    return (y[0] if inverse else tuple(y)), (want[0] if inverse else want), \
        changed


def phase_real_kernels_vs_plain(ck, dev) -> dict:
    """fft_r2c/fft_c2r and fft_r2c_pair against their plain versions (and
    numpy fp64 on a subset), in both directions and both layouts."""
    out = {"fft_r2c": [], "fft_r2c_pair": []}
    for n in (4, 6, 94, 120, 1000, 1024, 2048, 4096, 16384):
        B = 33
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((B, n), generator=g, device=dev)
        want = np.fft.rfft(_host(x), axis=1)
        m = n // 2
        for packed in (False, True):
            yr, yi = ck.fft_r2c(x, packed)
            torch.cuda.synchronize()
            pr, pi = ck.fft_r2c_plain(x, packed)
            row = {"n": n, "B": B, "packed": packed,
                   "rel_err_plain": _rel(torch.complex(yr, yi),
                                         torch.complex(pr, pi))}
            if packed:
                yr, yi = ck.packed_to_numpy_layout(yr, yi)
            else:
                # stored, not rounded: Im(DC) and Im(Nyquist) are 0
                row["im_dc_nyquist"] = float(
                    yi[:, [0, m]].abs().max().item())
                assert row["im_dc_nyquist"] == 0.0, row
            row["rel_err_numpy"] = _numpy_rel(
                _host(yr) + 1j * _host(yi), want)
            # the inverse of numpy's spectrum, scaled 2/n to numpy irfft
            sr = torch.tensor(want.real, dtype=torch.float32, device=dev)
            si = torch.tensor(want.imag, dtype=torch.float32, device=dev)
            if packed:
                sr, si = ck.numpy_to_packed_layout(sr, si)
                sr, si = sr.contiguous(), si.contiguous()
            z = ck.fft_c2r(sr, si, n, 2.0 / n, packed)
            torch.cuda.synchronize()
            row["rel_err_plain_inverse"] = _rel(
                z, ck.fft_c2r_plain(sr, si, n, 2.0 / n, packed))
            row["rel_err_numpy_inverse"] = _numpy_rel(_host(z), _host(x))
            assert max(row["rel_err_plain"],
                       row["rel_err_plain_inverse"]) <= KERNEL_TOL, row
            assert max(row["rel_err_numpy"],
                       row["rel_err_numpy_inverse"]) <= NUMPY_TOL, row
            out["fft_r2c"].append(row)
    # guarded launches at named lengths: one pass several lines a block,
    # two factors, odd m; both layouts (numpy rows of n/2+1 bins, unaligned
    # in most rows), both directions, the planes aligned and not
    out["fft_r2c_guarded"] = {"launches": 0, "blocks_per_sm": {}}
    for n in R2C_NAMED:
        out["fft_r2c_guarded"]["blocks_per_sm"][n] = [
            ck.r2c_occupancy(n, False), ck.r2c_occupancy(n, True)]
        g = torch.Generator(device=dev).manual_seed(n + 5)
        x = torch.randn((37 if n < 4096 else 5, n), generator=g, device=dev)
        for packed in (False, True):
            for offset in (0, 1, 2):
                got, want, changed = _r2c_guarded(ck, x, packed, False,
                                                  offset, dev)
                err = _rel(torch.complex(*got), torch.complex(*want))
                row = {"n": n, "packed": packed, "direction": "r2c",
                       "offset": offset, "rel_err_plain": err,
                       "guard_cells_changed": changed}
                assert changed == 0 and err <= KERNEL_TOL, row
                # the inverse's real output stays 8-byte aligned
                got, want, changed = _r2c_guarded(ck, x, packed, True,
                                                  2 * offset, dev)
                err = _rel(got, want)
                row.update(direction="c2r", offset=2 * offset,
                           rel_err_plain=err, guard_cells_changed=changed)
                assert changed == 0 and err <= KERNEL_TOL, row
                out["fft_r2c_guarded"]["launches"] += 2
    _log(f"[real kernels] fft_r2c guarded: {out['fft_r2c_guarded']}")
    pair_shapes = [(2, 8, 8), (3, 16, 16), (2, 47, 60), (2, 64, 64),
                   (2, 64, 128), (3, 128, 128), (2, 128, 256), (4, 256, 256),
                   (2, 8, 16384), (256, 256, 256)]
    for (B, ny, nz) in pair_shapes:
        g = torch.Generator(device=dev).manual_seed(B + ny * nz)
        x = torch.randn((B, ny, nz), generator=g, device=dev)
        yr, yi = ck.fft_r2c_pair(x)
        torch.cuda.synchronize()
        pr, pi = ck.fft_r2c_pair_plain(x)
        z = ck.fft_c2r_pair(pr, pi, nz, 1.0 / ny, 2.0 / nz)
        torch.cuda.synchronize()
        row = {"shape": [B, ny, nz], "layout": ck.r2c_pair_layout(ny, nz),
               "splits": ck.r2c_pair_splits(ny, nz),
               "rel_err_plain": _rel(torch.complex(yr, yi),
                                     torch.complex(pr, pi)),
               "rel_err_plain_inverse": _rel(z, ck.fft_c2r_pair_plain(
                   pr, pi, nz, 1.0 / ny, 2.0 / nz))}
        assert max(row["rel_err_plain"],
                   row["rel_err_plain_inverse"]) <= KERNEL_TOL, row
        if B * ny * nz <= 1 << 20:
            xh = _host(x)
            want = np.fft.rfft2(xh)
            row["rel_err_numpy"] = _numpy_rel(_host(yr) + 1j * _host(yi), want)
            sr = torch.tensor(want.real, dtype=torch.float32, device=dev)
            si = torch.tensor(want.imag, dtype=torch.float32, device=dev)
            zn = ck.fft_c2r_pair(sr, si, nz, 1.0 / ny, 2.0 / nz)
            row["rel_err_numpy_inverse"] = _numpy_rel(_host(zn), xh)
            assert max(row["rel_err_numpy"],
                       row["rel_err_numpy_inverse"]) <= NUMPY_TOL, row
        out["fft_r2c_pair"].append(row)
    # fft_r2c_pair over the real planes it serves: every
    # R2C_PAIR_SWEEP_STRIDE-th and the first of each layout class, both
    # directions
    served = _r2c_pair_served(ck)
    classes, picked = {}, []
    for i, (ny, nz) in enumerate(served):
        key = _r2c_pair_class(ck, ny, nz)
        if key not in classes or i % R2C_PAIR_SWEEP_STRIDE == 0:
            classes.setdefault(key, (ny, nz))
            picked.append((ny, nz))
    worst = 0.0
    for i, (ny, nz) in enumerate(picked):
        g = torch.Generator(device=dev).manual_seed(i)
        x = torch.randn((2, ny, nz), generator=g, device=dev)
        spec = ck.fft_r2c_pair_plain(x)
        err = max(_rel(torch.complex(*ck.fft_r2c_pair(x)),
                       torch.complex(*spec)),
                  _rel(ck.fft_c2r_pair(*spec, nz, 1.0 / ny, 2.0 / nz),
                       ck.fft_c2r_pair_plain(*spec, nz, 1.0 / ny, 2.0 / nz)))
        assert err <= KERNEL_TOL, ("fft_r2c_pair", ny, nz, err)
        worst = max(worst, err)
    out["r2c_pair_sweep"] = {"served": len(served), "checked": len(picked),
                             "classes": len(classes), "worst": worst}
    _log(f"[real kernels] fft_r2c_pair over the served planes: "
         f"{out['r2c_pair_sweep']}")
    # fft_r2c_pair on planes of several clusters, both directions, with
    # its outputs inside sentinel guards, aligned and not (the real side
    # stays 8-byte aligned)
    out["fft_r2c_pair_guarded"] = {"launches": 0, "occupancy": {}}
    for (B, ny, nz) in R2C_PAIR_GUARDED:
        out["fft_r2c_pair_guarded"]["occupancy"][f"{ny}x{nz}"] = [
            ck.r2c_pair_occupancy(ny, nz, False),
            ck.r2c_pair_occupancy(ny, nz, True)]
        g = torch.Generator(device=dev).manual_seed(ny + nz)
        x = torch.randn((B, ny, nz), generator=g, device=dev)
        for inverse in (False, True):
            for offset in (0, 1, 2):
                if inverse and offset % 2:
                    continue
                got, want, changed = _r2c_pair_guarded(ck, x, inverse,
                                                       offset, dev)
                err = (_rel(got, want) if inverse else
                       _rel(torch.complex(*got), torch.complex(*want)))
                row = {"shape": [B, ny, nz], "inverse": inverse,
                       "offset": offset, "layout": ck.r2c_pair_layout(ny, nz),
                       "rel_err_plain": err, "guard_cells_changed": changed}
                assert changed == 0 and err <= KERNEL_TOL, row
                out["fft_r2c_pair_guarded"]["launches"] += 1
    _log(f"[real kernels] fft_r2c_pair guarded: "
         f"{out['fft_r2c_pair_guarded']}")
    # every even n whose n/2 the kernels take, up to 16384: directions
    # alternate, and layouts every second length
    covered = [2 * m for m in range(2, ck.KERNEL_MAX_N + 1)
               if ck.kernel_supports(m)]
    sweep = {"lengths": len(covered), "worst": 0.0}
    for i, n in enumerate(covered):
        inverse, packed = bool(i % 2), bool((i // 2) % 2)
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((3, n), generator=g, device=dev)
        if inverse:
            sr, si = ck.fft_r2c_plain(x, packed)
            err = _rel(ck.fft_c2r(sr, si, n, 0.5, packed),
                       ck.fft_c2r_plain(sr, si, n, 0.5, packed))
        else:
            err = _rel(torch.complex(*ck.fft_r2c(x, packed)),
                       torch.complex(*ck.fft_r2c_plain(x, packed)))
        assert err <= KERNEL_TOL, ("fft_r2c sweep", n, inverse, packed, err)
        sweep["worst"] = max(sweep["worst"], err)
    out["sweep"] = sweep
    _log(f"[real kernels] sweep over every covered even length: {sweep}")
    for k in R2C_KERNELS:
        worst = max(max(r["rel_err_plain"], r["rel_err_plain_inverse"])
                    for r in out[k])
        worst_np = max(max(r.get("rel_err_numpy", 0.0),
                           r.get("rel_err_numpy_inverse", 0.0))
                       for r in out[k])
        _log(f"[real kernels] {k}: worst rel err vs plain {worst}, "
             f"vs numpy fp64 {worst_np}")
    return out


def phase_real_routes(vt, dev) -> dict:
    """The real transforms' other routes on the card, against numpy fp64
    (or torch.fft on shapes too large for the host): a non-minor axis, odd
    n (merged sequences on fft_lines), n = 2 and 3, an explicit n, rfftn
    axis subsets, the numpy rule for Im(DC/Nyquist), inputs left unchanged,
    and a refusal outside the kernels."""
    rows = []
    g = torch.Generator(device=dev).manual_seed(7)

    def real(shape):
        return torch.randn(shape, generator=g, device=dev)

    def check(what, got, want, tol=NUMPY_TOL):
        err = _numpy_rel(got, want)
        rows.append({"case": what, "rel_err": err})
        assert err <= tol, (what, err)

    for shape, axis in (((64, 5, 3), 0), ((3, 1000, 4), 1), ((5, 47), -1),
                        ((1, 47), -1), ((4, 2), -1), ((4, 3), -1),
                        ((2, 3), -1), ((3, 60), -1)):
        x = real(shape)
        keep = x.clone()
        X = vt.rfft(x, axis=axis)
        want = np.fft.rfft(_host(x), axis=axis)
        check(f"rfft {shape} axis {axis}", X.cpu().numpy(), want)
        n = shape[axis]
        z = vt.irfft(X, n=n, axis=axis)
        check(f"irfft {shape} axis {axis}", _host(z), _host(x))
        assert torch.equal(x, keep), ("rfft changed its input", shape)
    # an explicit n: crop and zero-pad the spectrum as numpy does
    x = real((4, 64))
    X = vt.rfft(x)
    Xh = X.cpu().numpy().astype(np.complex128)
    for n in (64, 60, 70, 63):
        check(f"irfft n={n}", _host(vt.irfft(X, n=n)),
              np.fft.irfft(Xh, n=n))
    # a spectrum with nonzero Im(DC) and Im(Nyquist): numpy ignores them
    for n in (64, 63, 1024):
        Xh = np.fft.rfft(np.random.default_rng(n).standard_normal((6, n)))
        Xh[:, 0] += 3j
        Xh[:, -1] -= 2j
        Xd = torch.tensor(Xh.astype(np.complex64), device=dev)
        keep = Xd.clone()
        check(f"irfft Im(DC/Nyquist) n={n}", _host(vt.irfft(Xd, n=n)),
              np.fft.irfft(Xh, n=n))
        assert torch.equal(Xd, keep), "irfft changed its input"
    Xh = np.fft.rfftn(np.random.default_rng(1).standard_normal((3, 16, 12)),
                      axes=(1, 2))
    Xh[:, :, 0] += 1j
    Xh[:, :, -1] -= 0.5j
    check("irfftn Im(DC/Nyquist) pair",
          _host(vt.irfftn(torch.tensor(Xh.astype(np.complex64), device=dev),
                          axes=(1, 2))),
          np.fft.irfftn(Xh, axes=(1, 2)))
    for shape, axes in (((4, 6, 8), None), ((4, 6, 8), (0, 2)),
                        ((2, 3, 8, 12), (1, 3)), ((3, 8, 12), (0, 1)),
                        ((16, 17), None), ((5, 64, 60), (1, 2)),
                        ((2, 47, 60), None), ((2, 512, 512), (1, 2)),
                        ((1, 1024, 1024), (1, 2))):
        x = real(shape)
        keep = x.clone()
        X = vt.rfftn(x, axes=axes)
        ax = tuple(range(len(shape))) if axes is None else axes
        want = np.fft.rfftn(_host(x), axes=ax)
        check(f"rfftn {shape} axes {axes}", X.cpu().numpy(), want)
        z = vt.irfftn(X, s=tuple(shape[a] for a in ax), axes=axes)
        check(f"irfftn {shape} axes {axes}", _host(z), _host(x))
        assert torch.equal(x, keep), ("rfftn changed its input", shape)
    # an s that crops or zero-pads the complex axes, as numpy's irfftn
    # does: a crop and a pad on the pair route, both at once in 3-D
    Xh = np.fft.rfftn(np.random.default_rng(2).standard_normal((5, 24, 40)))
    for s, axes in (((16, 40), (1, 2)), ((32, 40), (1, 2)),
                    ((3, 32, 40), (0, 1, 2))):
        want = np.fft.irfftn(Xh, s=s, axes=axes)
        Xd = torch.tensor(Xh.astype(np.complex64), device=dev)
        keep = Xd.clone()
        got = vt.irfftn(Xd, s=s, axes=axes)
        assert tuple(got.shape) == want.shape, (s, axes, got.shape)
        check(f"irfftn s={s} axes {axes}", _host(got), want)
        assert torch.equal(Xd, keep), "irfftn changed its input"
    for n in (40960, 65542):   # n/2 = 20480, 32771: the long tier
        x = real((2, n))
        X = vt.rfft(x)
        check(f"rfft n={n} (long tier)", X.cpu().numpy(), np.fft.rfft(_host(x)))
    _log(f"[real routes] {len(rows)} cases, worst "
         f"{max(r.get('rel_err', 0.0) for r in rows)}")
    return {"cases": rows}


def phase_real_main_path(vt, ck, torch_engine, dev) -> dict:
    """The real part of the main path, through the entry points a user
    calls: bench.py's r2c row through FFTApplication (Planar in, real
    planes out) and through rfft/irfft on a real tensor, and the real
    256^3 cube through rfftn/irfftn."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(R2C_N,),
                                         kind=vt.TransformKind.R2C))
    x = _planes((R2C_LINES, R2C_N), 11, dev)[0]
    xp = vt.Planar(x, torch.zeros_like(x))
    cube = _planes(CUBE, 13, dev)[0]
    cube_p = vt.Planar(cube, torch.zeros_like(cube))
    keep = (x.clone(), cube.clone())
    torch.cuda.synchronize()

    def forward_inverse(fwd, inv, data):
        spec = fwd(data)
        return spec, inv(spec)

    # each path with the counts from 0, held to the launches it must make:
    # one real-lines launch per direction in 1-D, and for the cube one
    # real-pair and one strided launch per direction
    paths = (("1d_r2c_n1024", lambda: forward_inverse(app.forward,
                                                      app.inverse, xp),
              {"fft_r2c": 2}),
             ("1d_r2c_n1024_public", lambda: forward_inverse(vt.rfft,
                                                             vt.irfft, x),
              {"fft_r2c": 2}),
             ("3d_r2c_256^3", lambda: forward_inverse(vt.rfftn, vt.irfftn,
                                                      cube_p),
              {"fft_r2c_pair": 2, "fft_strided": 2}))
    results, by_path, plain_calls = {}, {}, 0
    for name, drive, want in paths:
        ck.reset_launches()
        torch_engine.calls = 0
        results[name] = drive()
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_path[name] = got
        plain_calls += torch_engine.calls
        _log(f"[main r2c] {name}: launches {got}, plain engine calls "
             f"{torch_engine.calls}")
        assert got == {k: want.get(k, 0) for k in got}, (name, got, want)
        assert torch_engine.calls == 0, (name, torch_engine.calls)
    launches = {k: sum(c[k] for c in by_path.values()) for k in ck.launches}
    assert torch.equal(x, keep[0]) and torch.equal(cube, keep[1])
    Y, z = results["1d_r2c_n1024"]
    Yt, zt = results["1d_r2c_n1024_public"]
    Y3, Z3 = results["3d_r2c_256^3"]

    rows = []
    ref = torch.fft.rfft(x)
    h = R2C_N // 2 + 1
    for name, spec, back in (("1d_r2c_n1024", torch.complex(Y.re, Y.im), z),
                             ("1d_r2c_n1024_public", Yt, zt)):
        row = {"row": name, "shape": [R2C_LINES, R2C_N],
               "rel_err_fwd_vs_torch_fft": _rel(spec, ref),
               "rel_err_round_trip": _rel(back, x),
               "finite": bool(torch.isfinite(spec).all()
                              and torch.isfinite(back).all())}
        _log(f"[main r2c] {row}")
        assert row["finite"] and spec.shape == (R2C_LINES, h) \
            and back.shape == x.shape, row
        assert row["rel_err_fwd_vs_torch_fft"] <= NUMPY_TOL \
            and row["rel_err_round_trip"] <= NUMPY_TOL, row
        rows.append(row)
    # the cube: torch.fft as the reference on the card, numpy on one plane
    ref3 = torch.fft.rfftn(cube)
    spec3 = torch.complex(Y3.re, Y3.im)
    row = {"row": "3d_r2c_256^3", "shape": list(CUBE),
           "rel_err_fwd_vs_torch_fft": _rel(spec3, ref3),
           "rel_err_round_trip": _rel(Z3, cube),
           "finite": bool(torch.isfinite(spec3).all()
                          and torch.isfinite(Z3).all())}
    del ref3
    _log(f"[main r2c] {row}")
    assert row["finite"] and Y3.shape == CUBE[:-1] + (CUBE[-1] // 2 + 1,) \
        and Z3.shape == CUBE, row
    assert row["rel_err_fwd_vs_torch_fft"] <= NUMPY_TOL \
        and row["rel_err_round_trip"] <= NUMPY_TOL, row
    rows.append(row)
    return {"launches": launches, "launches_by_path": by_path,
            "plain_engine_calls": plain_calls, "rows": rows}


def phase_real_times(vt, ck, dev) -> dict:
    """The real kernels at the main path's shapes (each held against its
    plain version there), both layouts of fft_r2c, and the real round
    trips, beside the HBM bound and torch.fft."""
    _log(f"[time] card: {_smi()}")
    kernels = {name: [] for name in R2C_KERNELS}
    B, n = R2C_LINES, R2C_N
    m = n // 2
    x = _planes((B, n), 21, dev)[0]
    with open(ck.library_path("fft_r2c")[:-3] + ".log") as f:
        regs = {k: (r, st, ld) for k, r, st, ld in _ptxas_kernels(f.read())}

    def layout(inverse):
        r, st, ld = regs["c2r_kernel" if inverse else "r2c_kernel"]
        threads, lines, smem = ck.r2c_layout(n)
        return {"split": list(ck.r2c_split(n)), "threads": threads,
                "lines_per_block": lines, "smem_bytes": smem,
                "registers": r, "spill_bytes": [st, ld],
                "blocks_per_sm": ck.r2c_occupancy(n, inverse),
                "fft_lines_same_points_ms": lines_ms}

    # the walk alone on the same points and bytes: fft_lines over (B, m)
    # complex planes
    zr, zi = _planes((B, m), 22, dev)
    lines_ms = _time_ms(lambda: ck.fft_lines(zr, zi, False))
    del zr, zi
    for packed in (False, True):
        w = m if packed else m + 1
        nbytes = 4.0 * B * n + 8.0 * B * w
        bound, by = _bound(nbytes, _fft_ops(B * m, m) + 10.0 * B * m)
        yr, yi = ck.fft_r2c(x, packed)
        err = _errors((yr, yi), ck.fft_r2c_plain(x, packed),
                      ("fft_r2c", B, n, packed))
        row = {"shape": [B, n], "direction": "r2c", "packed": packed,
               "ms": _time_ms(lambda: ck.fft_r2c(x, packed)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(lambda: ck.fft_r2c_plain(x, packed),
                                    reps=5, inner=1, warmup=1),
               "library_ms": _time_ms(lambda: torch.fft.rfft(x)),
               **layout(False)}
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] fft_r2c {row}")
        kernels["fft_r2c"].append(row)
        sr, si = yr, yi
        z = ck.fft_c2r(sr, si, n, 2.0 / n, packed)
        pz = ck.fft_c2r_plain(sr, si, n, 2.0 / n, packed)
        rel = _rel(z, pz)
        assert rel <= KERNEL_TOL, ("fft_c2r", packed, rel)
        Xc = torch.complex(*(ck.packed_to_numpy_layout(sr, si) if packed
                             else (sr, si)))
        row = {"shape": [B, n], "direction": "c2r", "packed": packed,
               "ms": _time_ms(lambda: ck.fft_c2r(sr, si, n, 2.0 / n, packed)),
               "bound_ms": bound, "bound_by": by,
               "max_abs_err": (z - pz).abs().max().item(),
               "plain_ms": _time_ms(
                   lambda: ck.fft_c2r_plain(sr, si, n, 2.0 / n, packed),
                   reps=5, inner=1, warmup=1),
               "library_ms": _time_ms(lambda: torch.fft.irfft(Xc, n=n)),
               **layout(True)}
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] fft_c2r {row}")
        kernels["fft_r2c"].append(row)
        del z, pz, Xc
    # the layout sweep, numpy layout both ways: fft_lines' splits of m and
    # blocks (LINES_SWEEP), timed in turns (down the list, then up), each
    # against the plain version first
    spec = ck.fft_r2c_plain(x)
    plain = {False: spec, True: ck.fft_c2r_plain(*spec, n, 2.0 / n)}
    calls = {False: lambda: ck.fft_r2c(x),
             True: lambda: ck.fft_c2r(*spec, n, 2.0 / n)}
    sweep = []
    for split, (bp, aim) in ((p, v) for p in _lines_splits(ck, m)
                             for v in R2C_SWEEP):
        v = {"split": list(split), "block_points": bp, "aim": aim}
        with _r2c_layout_forced(ck, v):
            threads = ck.r2c_layout(n)[0]
            seen = [(r["split"], r["layout"]) for r in sweep]
            if (all(ck.walk_rounds_fit(k, threads, True) for k in split)
                    and (v["split"], list(ck.r2c_layout(n))) not in seen):
                v.update(shape=[B, n], layout=list(ck.r2c_layout(n)),
                         blocks_per_sm=[ck.r2c_occupancy(n, False),
                                        ck.r2c_occupancy(n, True)],
                         ms_r2c=[], ms_c2r=[])
                sweep.append(v)
    for v in sweep + sweep[::-1]:
        with _r2c_layout_forced(ck, v):
            for inverse in (False, True):
                got = calls[inverse]()
                if inverse:
                    rel = _rel(got, plain[True])
                    assert rel <= KERNEL_TOL, ("fft_c2r", v, rel)
                else:
                    _errors(got, plain[False], ("fft_r2c", v))
                v["ms_c2r" if inverse else "ms_r2c"].append(
                    _time_ms(calls[inverse]))
    _log(f"[time] fft_r2c layout sweep n={n}: {sweep}")
    del x, spec, plain
    with open(ck.library_path("fft_r2c_pair")[:-3] + ".log") as f:
        pregs = {k: (r, st, ld) for k, r, st, ld in _ptxas_kernels(f.read())}

    def pair_rows(shape, seed):
        """fft_r2c_pair and fft_c2r_pair on real (P, ny, nz) planes, with
        their layout, instantiation, registers and spills."""
        P, ny, nz = shape
        h = nz // 2 + 1
        cube = _planes(shape, seed, dev)[0]
        nbytes = 4.0 * P * ny * nz + 8.0 * P * ny * h
        ops = (_fft_ops(P * ny * (nz // 2), ny * (nz // 2))
               + 10.0 * P * ny * nz)
        bound, by = _bound(nbytes, ops)
        generic = int(ck.r2c_pair_generic(ny, nz))

        def extra(inverse):
            r, st, ld = pregs["c2r_pair_kernel" if inverse
                              else f"r2c_pair_kernel<{generic}>"]
            c, threads, smem = ck.r2c_pair_layout(ny, nz)
            clusters, blocks = ck.r2c_pair_occupancy(ny, nz, inverse)
            return {"cluster": c, "threads": threads, "smem_bytes": smem,
                    "splits": ck.r2c_pair_splits(ny, nz),
                    "generic_stage": generic, "registers": r,
                    "spill_bytes": [st, ld], "resident_clusters": clusters,
                    "blocks_per_sm": blocks}

        spec = ck.fft_r2c_pair_plain(cube)
        yr, yi = ck.fft_r2c_pair(cube)
        err = _errors((yr, yi), spec, ("fft_r2c_pair", shape))
        row = {"shape": list(shape), "direction": "r2c",
               "ms": _time_ms(lambda: ck.fft_r2c_pair(cube)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(lambda: ck.fft_r2c_pair_plain(cube),
                                    reps=5, inner=1, warmup=1),
               "library_ms": _time_ms(lambda: torch.fft.rfft2(cube)),
               **extra(False)}
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] fft_r2c_pair {row}")
        kernels["fft_r2c_pair"].append(row)
        z = ck.fft_c2r_pair(yr, yi, nz, 1.0 / ny, 2.0 / nz)
        pz = ck.fft_c2r_pair_plain(yr, yi, nz, 1.0 / ny, 2.0 / nz)
        rel = _rel(z, pz)
        assert rel <= KERNEL_TOL, ("fft_c2r_pair", shape, rel)
        Xc = torch.complex(yr, yi)
        row = {"shape": list(shape), "direction": "c2r",
               "ms": _time_ms(lambda: ck.fft_c2r_pair(yr, yi, nz, 1.0 / ny,
                                                      2.0 / nz)),
               "bound_ms": bound, "bound_by": by,
               "max_abs_err": (z - pz).abs().max().item(),
               "plain_ms": _time_ms(lambda: ck.fft_c2r_pair_plain(
                   yr, yi, nz, 1.0 / ny, 2.0 / nz), reps=5, inner=1,
                   warmup=1),
               "library_ms": _time_ms(
                   lambda: torch.fft.irfft2(Xc, s=(ny, nz))),
               **extra(True)}
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] fft_c2r_pair {row}")
        kernels["fft_r2c_pair"].append(row)
        return cube, spec, (yr, yi), pz

    # the main path's cube (the kernels line's row), then one whose stages
    # need the generic one (the forward's instantiation <1>)
    P, ny, nz = CUBE
    h = nz // 2 + 1
    cube, spec, (yr, yi), pz = pair_rows(CUBE, 23)
    pair_rows(GENERIC_CUBE, 24)
    # the cluster sweep at 256 x 256: clusters of 4, 8 and 16 blocks
    # (PAIR_TILE_POINTS, which fft_r2c_pair shares with fft_pair) at 8 or
    # 16 points a thread, both directions, timed in turns (down the list,
    # then up), each against the plain version first
    calls = {False: lambda: ck.fft_r2c_pair(cube),
             True: lambda: ck.fft_c2r_pair(yr, yi, nz, 1.0 / ny, 2.0 / nz)}
    pair_sweep = []
    for tile in (8192, 4096, 2048):
        for aim in (8, 16):
            v = {"tile_points": tile, "aim": aim}
            with _pair_layout_forced(ck, v):
                v.update(layout=list(ck.r2c_pair_layout(ny, nz)),
                         blocks_per_sm=[ck.r2c_pair_occupancy(ny, nz, False)[1],
                                        ck.r2c_pair_occupancy(ny, nz, True)[1]],
                         ms_r2c=[], ms_c2r=[])
            if all(p["layout"] != v["layout"] for p in pair_sweep):
                pair_sweep.append(v)
    for v in pair_sweep + pair_sweep[::-1]:
        with _pair_layout_forced(ck, v):
            _errors(calls[False](), spec, ("fft_r2c_pair", v))
            rel = _rel(calls[True](), pz)
            assert rel <= KERNEL_TOL, ("fft_c2r_pair", v, rel)
            for inverse in (False, True):
                v["ms_c2r" if inverse else "ms_r2c"].append(
                    _time_ms(calls[inverse]))
    _log(f"[time] fft_r2c_pair layout sweep: {pair_sweep}")
    del pz, yr, yi, spec
    # fft_strided on the main path's real cube: axis 0 of the (1, 256,
    # 256*129) half spectrum, forward and unscaled inverse
    shape = (1, P, ny * h)
    sr, si = _planes(shape, 27, dev)
    sc = torch.complex(sr, si)
    nbytes = 16.0 * math.prod(shape)
    bound, by = _bound(nbytes, _fft_ops(math.prod(shape), P))
    kernels["fft_strided"] = []
    for inverse in (False, True):
        lib = torch.fft.ifft if inverse else torch.fft.fft
        err = _errors(ck.fft_strided(sr, si, inverse),
                      ck.fft_strided_plain(sr, si, inverse),
                      ("fft_strided", shape, inverse))
        # in place (as the round trip runs it: cuda_engine donates) on a
        # copy, and out of place on STRIDED_ALLOCATIONS more pairs of
        # planes, all alive at once: the time follows where the planes lie
        ip = (sr.clone(), si.clone())
        more = [_planes(shape, 28 + a, dev)
                for a in range(STRIDED_ALLOCATIONS)]
        row = {"shape": list(shape), "inverse": inverse,
               "ms": _time_ms(lambda: ck.fft_strided(sr, si, inverse)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(
                   lambda: ck.fft_strided_plain(sr, si, inverse), reps=5,
                   inner=1, warmup=1),
               "library_ms": _time_ms(
                   lambda: lib(sc, dim=1, norm="forward" if inverse
                               else "backward")),
               "inplace_ms": _time_ms(
                   lambda: ck.fft_strided(*ip, inverse, out=ip)),
               "allocations_ms": [
                   _time_ms(lambda: ck.fft_strided(*x, inverse))
                   for x in more],
               **_strided_extra(ck, P, shape[2])}
        del ip, more
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] fft_strided {row}")
        kernels["fft_strided"].append(row)
    del sr, si, sc

    e2e = []
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), kind=vt.TransformKind.R2C))
    x = _planes((B, n), 25, dev)[0]
    xp = vt.Planar(x, torch.zeros_like(x))
    nbytes = 2 * (4.0 * B * n + 8.0 * B * (m + 1))
    bound, by = _bound(nbytes, 2 * _fft_ops(B * m, m))
    tf = _time_ms(lambda: torch.fft.irfft(torch.fft.rfft(x), n=n))
    for name, fn in (("1d_r2c_n1024", lambda: app.inverse(app.forward(xp))),
                     ("1d_r2c_n1024_public", lambda: vt.irfft(vt.rfft(x)))):
        row = {"row": name, "shape": [B, n], "ms": _time_ms(fn),
               "bound_ms": bound, "bound_by": by, "torch_fft_ms": tf}
        row["GBs"] = nbytes / row["ms"] / 1e6
        row["vs_torch_fft"] = tf / row["ms"]
        _log(f"[time] e2e {row}")
        e2e.append(row)
    del x, xp
    cube_p = vt.Planar(cube, torch.zeros_like(cube))
    points = math.prod(CUBE)
    half = P * ny * h
    # per direction: the pair pass (real plane + half spectrum) and the
    # strided pass over the half spectrum (read + write of both planes)
    nbytes = 2 * ((4.0 * points + 8.0 * half) + 16.0 * half)
    bound, by = _bound(nbytes, 2 * _fft_ops(points // 2, points // 2))
    row = {"row": "3d_r2c_256^3", "shape": list(CUBE),
           "ms": _time_ms(lambda: vt.irfftn(vt.rfftn(cube_p))),
           "host_ms": _host_ms(lambda: vt.irfftn(vt.rfftn(cube_p))),
           "bound_ms": bound, "bound_by": by, "axis_passes_per_dir": 2,
           "torch_fft_ms": _time_ms(
               lambda: torch.fft.irfftn(torch.fft.rfftn(cube), s=CUBE))}
    row["GBs"] = nbytes / row["ms"] / 1e6
    row["vs_torch_fft"] = row["torch_fft_ms"] / row["ms"]
    _log(f"[time] e2e {row}")
    e2e.append(row)
    return {"kernels": kernels, "e2e": e2e, "fft_r2c_layout_sweep": sweep,
            "fft_r2c_pair_layout_sweep": pair_sweep}


# ---------------------------------------------------------------------------
# Lengths of any size: Rader, Bluestein, SPLIT and the two-factor tier.
# ---------------------------------------------------------------------------

def _served(ce) -> dict:
    """The lengths each new kernel serves on the routes of every 1-D plan
    of length 5..16384 (SPLIT factors included), as the engine's `route`
    names them: fft_conv's Rader primes and Bluestein (n, m),
    fft_twofactor's lengths, fft_conv_inv's Rader primes and Bluestein
    (n, m), fft_conv_pair's Bluestein (n, m)."""
    from vkfft_tpu_torch.planner.factorize import Algorithm
    from vkfft_tpu_torch.planner.plan import plan_axis
    out = {"conv_rader": set(), "conv_blu": set(), "twofactor": set(),
           "conv_inv_rader": set(), "conv_inv_blu": set(), "conv_pair": set()}
    for n in range(5, 16385):
        for kernel, plan, m in ce.route(plan_axis(n)) or ():
            rader = plan.algorithm is Algorithm.RADER
            case = plan.n if rader else (plan.n, m)
            if kernel == "fft_twofactor":
                out["twofactor"].add(m)
            elif kernel == "fft_conv":
                out["conv_rader" if rader else "conv_blu"].add(case)
            elif kernel == "fft_conv_inv":
                out["conv_inv_rader" if rader else "conv_inv_blu"].add(case)
            elif kernel == "fft_conv_pair":
                out["conv_pair"].add(case)
    return {k: sorted(v) for k, v in out.items()}


def _host_planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


# The sweeps below take every SWEEP_STRIDE-th length (and the last), so the
# whole run stays near three minutes of command time on the H100; with a
# stride of 1 they take every length (16380 route lengths and 7122 kernel
# cases, 227-269 s on their own on an H100 80GB HBM3 at 700 W; PERF.md).
SWEEP_STRIDE = 3


def _every_stride(items: list) -> list:
    picked = items[::SWEEP_STRIDE]
    if items and (len(items) - 1) % SWEEP_STRIDE:
        picked.append(items[-1])
    return picked


# fft_twofactor's named lengths: a prime (n2 = 1), a short line several
# to a block, the Rader 7918 of sample 7's 7919, its DIRECT 10240, 12288
# and the longest line
TWOFACTOR_NAMED = (113, 134, 7918, 10240, 12288, 16384)
TWOFACTOR_GUARD = 1 << 14     # sentinel floats each side of an output


def _guarded(call, x, offset):
    """One launch ``call(*planes, out=...)`` on planes x, its output planes
    inside a buffer of sentinel values (TWOFACTOR_GUARD floats on each
    side, and ``offset`` more floats before: 1 makes them unaligned): (the
    output, the guard cells the launch changed)."""
    sentinel, numel = 12345.0, x[0].numel()
    lead = TWOFACTOR_GUARD + offset
    buf = torch.full((2, lead + numel + TWOFACTOR_GUARD), sentinel,
                     device=x[0].device)
    y = tuple(buf[i, lead:lead + numel].view(x[0].shape) for i in range(2))
    src = x
    if offset:
        # the input unaligned too: a copy at the same offset
        pad = torch.zeros((2, offset + numel), device=x[0].device)
        src = tuple(pad[i, offset:].view(x[0].shape) for i in range(2))
        src[0].copy_(x[0])
        src[1].copy_(x[1])
    got = call(*src, out=y)
    changed = (int((buf[:, :lead] != sentinel).sum())
               + int((buf[:, lead + numel:] != sentinel).sum()))
    return got, changed


# fft_conv_pair's named Bluestein lengths (n, in both directions): sample
# 7's 10007 (m = 32768 = 128 x 256), odd column tiles (m = 8316 = 66 x 126
# and 10648 = 44 x 242 over 2 blocks), even ones of planes that are not
# powers of two (16640 = 104 x 160, 19200 = 120 x 160)
CONV_PAIR_NAMED = (10007, 4127, 5297, 8198, 9413)


def phase_any_kernels_vs_plain(ck, ce, dev) -> dict:
    """fft_conv, fft_twofactor, fft_conv_inv and fft_conv_pair against
    their plain versions at every SWEEP_STRIDE-th length they serve (batch
    2; fft_twofactor cycles through both orders and both directions from
    one length to the next), one odd batch each, and numpy fp64 on a
    subset; fft_twofactor at TWOFACTOR_NAMED in every form, in place and
    guarded."""
    from vkfft_tpu_torch import luts
    served = _served(ce)
    count = {"fft_conv": len(served["conv_rader"]) + len(served["conv_blu"]),
             "fft_twofactor": len(served["twofactor"]),
             "fft_conv_inv": len(served["conv_inv_rader"])
             + len(served["conv_inv_blu"]),
             "fft_conv_pair": len(served["conv_pair"])}
    served = {k: _every_stride(v) for k, v in served.items()}
    out = {k: {"lengths": c, "checked": 0, "worst": 0.0, "worst_numpy": 0.0}
           for k, c in count.items()}
    t0 = time.perf_counter()

    def check(kernel, what, got, plain, want=None):
        err = _rel(torch.complex(*got), torch.complex(*plain))
        assert err <= KERNEL_TOL, (kernel, what, err)
        out[kernel]["checked"] += 1
        out[kernel]["worst"] = max(out[kernel]["worst"], err)
        if want is not None:
            e = _numpy_rel(_host(got[0]) + 1j * _host(got[1]), want)
            assert e <= NUMPY_TOL, (kernel, what, "numpy", e)
            out[kernel]["worst_numpy"] = max(out[kernel]["worst_numpy"], e)

    def planes(shape, seed):
        return tuple(torch.from_numpy(a).to(dev)
                     for a in _host_planes(shape, seed))

    def numpy_of(x):
        return _host(x[0]) + 1j * _host(x[1])

    # fft_conv: Rader's p-1 (scalar table) and Bluestein's m it holds
    for i, p in enumerate(served["conv_rader"]):
        B = 33 if i == 0 else 2
        x = planes((B, p - 1), p)
        spec = ck.rader_spectrum(p, 1.0, dev)
        want = None
        if i % 50 == 0:
            # the unnormalized inverse of the spectrum times b / (p - 1)
            want = np.fft.ifft(np.fft.fft(numpy_of(x))
                               * luts.rader_tables(p)[2])
        check("fft_conv", ("rader", p), ck.fft_conv(*x, spec),
              ck.fft_conv_plain(*x, spec), want)
    for i, (n, m) in enumerate(served["conv_blu"]):
        inverse = bool(i % 2)
        x = planes((33 if i == 0 else 2, n), n)
        spec = ck.bluestein_spectrum(n, m, inverse, 1.0, dev)
        chirp = ck.bluestein_chirp(n, m, inverse, dev)
        want = None
        if i % 25 == 0:
            want = (np.fft.ifft(numpy_of(x)) * n if inverse
                    else np.fft.fft(numpy_of(x)))
        check("fft_conv", ("bluestein", n, m), ck.fft_conv(*x, spec, chirp),
              ck.fft_conv_plain(*x, spec, chirp), want)
    # fft_twofactor: every length it serves, orders and directions in turn
    for i, n in enumerate(served["twofactor"]):
        inverse, swapped = bool(i % 2), bool((i // 2) % 2)
        scale = 1.0 / n if inverse else 1.0
        x = planes((33 if i == 0 else 2, n), n)
        want = None
        if i % 100 == 0 and not swapped:
            want = (np.fft.ifft(numpy_of(x)) if inverse
                    else np.fft.fft(numpy_of(x)))
        check("fft_twofactor", (n, inverse, swapped),
              ck.fft_twofactor(*x, inverse, scale, swapped),
              ck.fft_twofactor_plain(*x, inverse, scale, swapped), want)
    # fft_twofactor at the named lengths in all four forms, in place, and
    # with its output inside sentinel guards (planes 16-byte aligned or not)
    out["fft_twofactor"]["guarded"] = 0
    out["fft_twofactor"]["blocks_per_sm"] = {}
    for n in TWOFACTOR_NAMED:
        out["fft_twofactor"]["blocks_per_sm"][n] = ck.twofactor_occupancy(n)
        B = 37 if n < 2048 else 5
        x = planes((B, n), n + 7)
        spec = np.fft.fft(numpy_of(x))
        for inverse in (False, True):
            for swapped in (False, True):
                scale = 1.0 / n if inverse else 1.0
                feed = x
                want = (np.fft.ifft(numpy_of(x)) if inverse else spec)
                if swapped and inverse:
                    # a spectrum in swapped order in, x out
                    n1, n2 = ck.twofactor_split(n)
                    feed = tuple(t.reshape(B, n1, n2).transpose(1, 2)
                                 .reshape(B, n).contiguous() for t in x)
                elif swapped:
                    want = np.stack([ck.swapped_order(v).ravel()
                                     for v in spec])
                what = (n, inverse, swapped)
                plain = ck.fft_twofactor_plain(*feed, inverse, scale, swapped)
                check("fft_twofactor", what,
                      ck.fft_twofactor(*feed, inverse, scale, swapped),
                      plain, want)
                inplace = tuple(t.clone() for t in feed)
                got = ck.fft_twofactor(*inplace, inverse, scale, swapped,
                                       out=inplace)
                assert got[0] is inplace[0] and got[1] is inplace[1]
                check("fft_twofactor", what + ("in place",), got, plain)
                for offset in (0, 1):
                    got, changed = _guarded(
                        lambda *p, out: ck.fft_twofactor(
                            *p, inverse, scale, swapped, out=out),
                        feed, offset)
                    assert changed == 0, (what, offset, changed)
                    check("fft_twofactor", what + ("guarded", offset), got,
                          plain)
                    out["fft_twofactor"]["guarded"] += 1
    # fft_conv_inv: Rader's p-1 with the x0 term, Bluestein's m without
    for i, p in enumerate(served["conv_inv_rader"]):
        B = 33 if i == 0 else 2
        x = planes((B, p - 1), p)
        dc = tuple(t.contiguous() for t in planes((B,), p + 1))
        spec = ck.rader_spectrum(p, 1.0, dev, "swapped")
        want = None
        if i % 25 == 0:
            # x is a spectrum in the swapped order: back to natural order,
            # times b, the unnormalized inverse over p - 1 points, plus dc
            n1, n2 = ck.twofactor_split(p - 1)
            natural = numpy_of(x).reshape(B, n2, n1).transpose(0, 2, 1)
            want = (np.fft.ifft(natural.reshape(B, p - 1)
                                * luts.rader_tables(p)[2])
                    + numpy_of(dc)[:, None])
        check("fft_conv_inv", ("rader", p), ck.fft_conv_inv(*x, spec, dc),
              ck.fft_conv_inv_plain(*x, spec, dc), want)
    for n, m in served["conv_inv_blu"]:
        x = planes((2, m), m)
        spec = ck.bluestein_spectrum(n, m, False, 1.0, dev, "swapped")
        check("fft_conv_inv", ("bluestein", n, m), ck.fft_conv_inv(*x, spec),
              ck.fft_conv_inv_plain(*x, spec))
    # fft_conv_pair at its named lengths in both directions, in place, and
    # with its output inside sentinel guards (planes 16-byte aligned or not)
    from vkfft_tpu_torch.planner.plan import plan_axis
    out["fft_conv_pair"]["guarded"] = 0
    out["fft_conv_pair"]["layouts"] = {}
    for n in CONV_PAIR_NAMED:
        m = plan_axis(n).decomp.bluestein_size
        out["fft_conv_pair"]["layouts"][n] = {
            "m": m, "layout": list(ck.conv_pair_layout(m)),
            "clusters_blocks": list(ck.conv_pair_occupancy(m))}
        x = planes((5, n), n + 3)
        for inverse in (False, True):
            spec = ck.bluestein_spectrum(n, m, inverse, 1.0, dev, "pair")
            chirp = ck.bluestein_chirp(n, m, inverse, dev)
            want = (np.fft.ifft(numpy_of(x)) * n if inverse
                    else np.fft.fft(numpy_of(x)))
            what = (n, m, inverse)
            plain = ck.fft_conv_pair_plain(*x, spec, chirp)
            check("fft_conv_pair", what, ck.fft_conv_pair(*x, spec, chirp),
                  plain, want)
            inplace = tuple(t.clone() for t in x)
            got = ck.fft_conv_pair(*inplace, spec, chirp, out=inplace)
            assert got[0] is inplace[0] and got[1] is inplace[1]
            check("fft_conv_pair", what + ("in place",), got, plain)
            for offset in (0, 1):
                got, changed = _guarded(
                    lambda *p, out: ck.fft_conv_pair(*p, spec, chirp,
                                                     out=out), x, offset)
                assert changed == 0, (what, offset, changed)
                check("fft_conv_pair", what + ("guarded", offset), got, plain)
                out["fft_conv_pair"]["guarded"] += 1
    # fft_conv_pair: every Bluestein n it serves
    for i, (n, m) in enumerate(served["conv_pair"]):
        inverse = bool(i % 2)
        x = planes((33 if i == 0 else 2, n), n)
        spec = ck.bluestein_spectrum(n, m, inverse, 1.0, dev, "pair")
        chirp = ck.bluestein_chirp(n, m, inverse, dev)
        want = None
        if i % 100 == 0:
            want = (np.fft.ifft(numpy_of(x)) * n if inverse
                    else np.fft.fft(numpy_of(x)))
        check("fft_conv_pair", (n, m), ck.fft_conv_pair(*x, spec, chirp),
              ck.fft_conv_pair_plain(*x, spec, chirp), want)
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    _log(f"[any kernels] {out}")
    return out


# the lengths in 5..16384 that raise on the card: none; the long tier
# (DIRECT n > 16384, Bluestein padded beyond 2^16) starts above 16384
LONG_TIER_TO_16384 = ()
# every SWEEP_STRIDE-th length, and always sample 7's, sample 14's up to
# 16384 (vkfft_tpu/cli.py:323), the lengths the JAX package sends to its
# long tier (8133) or to its TypeError (8215, 8246), and the last one
ROUTE_LENGTHS = sorted(set(range(5, 16385, SWEEP_STRIDE))
                       | {10007, 7919, 10006, 10240, 17, 31, 61, 67, 97, 101,
                          257, 641, 1009, 919, 8133, 8215, 8246, 16384})


def phase_any_routes(vt, ce, dev) -> dict:
    """The lengths of ROUTE_LENGTHS in 5..16384 through vt.fft/vt.ifft on
    the card (batch 2) against numpy fp64, with the round trip; the lengths
    that raise must be exactly the long tier's.  Then Rader and Bluestein
    axes as non-minor
    axes of fftn/FFTApplication, and rfft/irfft of n = 262, 15838, 20014
    (the half-length route), against numpy."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    t0 = time.perf_counter()
    raised, worst = [], {"fwd": 0.0, "round_trip": 0.0}
    for n in ROUTE_LENGTHS:
        xr, xi = _host_planes((2, n), n)
        x = vt.Planar(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
        if not ce.supports(plan_axis(n)):
            raised.append(n)
            continue
        y = vt.fft(x)
        z = vt.ifft(y)
        h = torch.stack([y.re, y.im, z.re, z.im]).double().cpu().numpy()
        xc = xr.astype(np.float64) + 1j * xi
        e_f = _numpy_rel(h[0] + 1j * h[1], np.fft.fft(xc))
        e_r = _numpy_rel(h[2] + 1j * h[3], xc)
        assert e_f <= NUMPY_TOL and e_r <= NUMPY_TOL, (n, e_f, e_r)
        worst["fwd"] = max(worst["fwd"], e_f)
        worst["round_trip"] = max(worst["round_trip"], e_r)
    _log(f"[any routes] {len(ROUTE_LENGTHS)} lengths in 5..16384 (every "
         f"{SWEEP_STRIDE}th and named ones): "
         f"{len(ROUTE_LENGTHS) - len(raised)} lengths run, "
         f"{len(raised)} raise {raised}, worst {worst}, "
         f"{time.perf_counter() - t0:.1f} s")
    assert tuple(raised) == LONG_TIER_TO_16384, raised
    cases = []

    def check(what, got, want):
        err = _numpy_rel(got, want)
        cases.append({"case": what, "rel_err": err})
        assert err <= NUMPY_TOL, (what, err)

    for n in (16400, 20480, 32771):   # the long tier (phase long_routes)
        xr, xi = _host_planes((2, n), n)
        y = vt.fft(vt.Planar(torch.from_numpy(xr).to(dev),
                             torch.from_numpy(xi).to(dev)))
        check(f"fft n={n} (long tier)", _host(y.re) + 1j * _host(y.im),
              np.fft.fft(xr.astype(np.float64) + 1j * xi))

    for shape, axes in (((6, 131), None), ((131, 8, 4), None),
                        ((3, 263, 12), (1, 2)), ((10007, 2), (0,))):
        xr, xi = _host_planes(shape, sum(shape))
        x = vt.Planar(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
        keep = (x.re.clone(), x.im.clone())
        ax = tuple(range(len(shape))) if axes is None else axes
        xc = xr.astype(np.float64) + 1j * xi
        y = vt.fftn(x, axes=axes)
        check(f"fftn {shape} axes {axes}", _host(y.re) + 1j * _host(y.im),
              np.fft.fftn(xc, axes=ax))
        z = vt.ifftn(y, axes=axes)
        check(f"ifftn {shape} axes {axes}", _host(z.re) + 1j * _host(z.im), xc)
        assert torch.equal(x.re, keep[0]) and torch.equal(x.im, keep[1]), shape
    app = vt.FFTApplication(vt.FFTConfig(shape=(263, 12), normalize=True))
    xr, xi = _host_planes((2, 263, 12), 5)
    x = vt.Planar(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
    xc = xr.astype(np.float64) + 1j * xi
    y = app.forward(x)
    check("FFTApplication (263, 12)", _host(y.re) + 1j * _host(y.im),
          np.fft.fftn(xc, axes=(1, 2)))
    z = app.inverse(y)
    check("FFTApplication (263, 12) inverse", _host(z.re) + 1j * _host(z.im),
          xc)
    for n in (262, 15838, 20014):
        xh = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
        X = vt.rfft(torch.from_numpy(xh).to(dev))
        want = np.fft.rfft(xh.astype(np.float64))
        check(f"rfft n={n}", X.cpu().numpy(), want)
        check(f"irfft n={n}", _host(vt.irfft(X, n=n)), xh.astype(np.float64))
        bent = want.copy()
        bent[:, 0] += 3j
        bent[:, -1] -= 2j
        got = vt.irfft(torch.from_numpy(bent.astype(np.complex64)).to(dev), n=n)
        check(f"irfft n={n} Im(DC/Nyquist)", _host(got),
              np.fft.irfft(bent, n=n))
    _log(f"[any routes] {len(cases)} axis and real cases, worst "
         f"{max(c['rel_err'] for c in cases)}")
    return {"lengths_run": len(ROUTE_LENGTHS) - len(raised), "raised": raised,
            "worst": worst, "cases": cases,
            "seconds": time.perf_counter() - t0}


SAMPLE_7 = (10007, 7919, 10006, 10240)    # vkfft_tpu/cli.py:251-260
SAMPLE_7_BYTES = 64 * 1024 * 1024         # cli.py:139-171 batches to 64 MiB
SAMPLE_7_LAUNCHES = {10007: {"fft_conv_pair": 2},
                     7919: {"fft_twofactor": 2, "fft_conv_inv": 2},
                     10006: {"fft_conv": 2},
                     10240: {"fft_twofactor": 2}}


def _sample_7_batch(n: int) -> int:
    return SAMPLE_7_BYTES // (8 * n)


def phase_any_main_path(vt, ck, torch_engine, dev) -> dict:
    """The reference's sample 7 on the card: each row at 64 MiB of planar
    fp32 data, forward then inverse through FFTApplication(normalize=False),
    the counts set to 0 just before each row and read just after; each row
    must make exactly its launches and no plain-engine call."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    rows, by_row = [], {}
    for n in SAMPLE_7:
        B = _sample_7_batch(n)
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=False))
        x = vt.Planar(*_planes((B, n), n, dev))
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        y = app.forward(x)
        z = app.inverse(y)
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_row[f"sample7_n{n}"] = got
        want = SAMPLE_7_LAUNCHES[n]
        _log(f"[main any] n={n}: launches {got}, plain engine calls "
             f"{torch_engine.calls}")
        assert got == {k: want.get(k, 0) for k in got}, (n, got, want)
        assert torch_engine.calls == 0, (n, torch_engine.calls)
        xc = torch.complex(x.re, x.im)
        row = {"row": f"sample7_n{n}", "shape": [B, n],
               "plan": plan_axis(n).algorithm.value,
               "rel_err_fwd_vs_torch_fft": _rel(torch.complex(y.re, y.im),
                                                torch.fft.fft(xc)),
               "rel_err_round_trip": _rel(torch.complex(z.re, z.im) / n, xc),
               "finite": _finite(y, z)}
        _log(f"[main any] {row}")
        assert row["finite"] and y.shape == x.shape and z.shape == x.shape, row
        assert row["rel_err_fwd_vs_torch_fft"] <= NUMPY_TOL \
            and row["rel_err_round_trip"] <= NUMPY_TOL, row
        rows.append(row)
        del x, y, z, xc
    launches = {k: sum(c[k] for c in by_row.values()) for k in ck.launches}
    return {"launches": launches, "launches_by_path": by_row,
            "plain_engine_calls": 0, "rows": rows}


def _cmul_ops(count: float) -> float:
    return 6.0 * count


def phase_any_times(vt, ck, dev) -> dict:
    """The four new kernels at the main path's shapes (each held against
    its plain version there) and sample 7's round trips, beside the bound
    and torch.fft on the same data."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    _log(f"[time] card: {_smi()}")
    kernels = {k: [] for k in ("fft_conv", "fft_twofactor", "fft_conv_inv",
                               "fft_conv_pair")}

    def row_of(name, shape, fn, plain, nbytes, ops, library, extra=None):
        got = fn()
        err = _errors(got, plain(), (name, shape))
        bound, by = _bound(nbytes, ops)
        row = dict(extra or {})
        row.update({"shape": list(shape), "ms": _time_ms(fn),
                    "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                    "plain_ms": _time_ms(plain, reps=5, inner=1, warmup=1),
                    "library_ms": library and _time_ms(library)})
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] {name} {row}")
        kernels[name].append(row)

    # fft_conv: the 10006 row's Rader 5003 on (2 * 838, 5002), scalar
    # table; the library call is the same cyclic convolution composed in
    # torch.fft on complex64 (the unnormalized inverse of the spectrum's
    # product, as the kernel's table carries the 1/(p-1)), held to the
    # kernel's output; the lone forward fft stays as torch_fft_ms
    B, p = 2 * _sample_7_batch(10006), 5003
    m = p - 1
    xr, xi = _planes((B, m), 31, dev)
    spec = ck.rader_spectrum(p, 1.0, dev)
    xc = torch.complex(xr, xi)
    sc = torch.complex(spec[:, 0].contiguous(), spec[:, 1].contiguous())
    conv = lambda: torch.fft.ifft(torch.fft.fft(xc) * sc, norm="forward")
    got = ck.fft_conv(xr, xi, spec)
    row_of("fft_conv", (B, m), lambda: ck.fft_conv(xr, xi, spec),
           lambda: ck.fft_conv_plain(xr, xi, spec),
           16.0 * B * m + 8.0 * m,
           B * (2 * _fft_ops(m, m) + _cmul_ops(m)), conv,
           {"mode": "rader p=5003",
            "library": "torch.fft ifft(fft(x) * spectrum), complex64",
            "library_rel_err": _rel(torch.complex(*got), conv()),
            "torch_fft_ms": _time_ms(lambda: torch.fft.fft(xc))})
    assert kernels["fft_conv"][-1]["library_rel_err"] <= KERNEL_TOL
    del xr, xi, xc, got
    # fft_twofactor: the 10240 row (natural both ways), the 7919 row's
    # forward in swapped order on (1059, 7918), whose library call is the
    # same DFT in natural order, the longest line, 16384, and the shortest
    # it serves, 67 (30 lines a block), at 64 MiB; each with its registers
    # and spills (ptxas), its layout and its resident blocks an SM
    regs, spill_st, spill_ld = _ptxas_of(ck, "fft_twofactor")[
        "fft_twofactor_kernel"]
    for n, B, inverse, swapped in ((10240, _sample_7_batch(10240), False, False),
                                   (10240, _sample_7_batch(10240), True, False),
                                   (7918, _sample_7_batch(7919), False, True),
                                   (16384, _sample_7_batch(16384), False, False),
                                   (16384, _sample_7_batch(16384), True, False),
                                   (67, _sample_7_batch(67), False, False)):
        xr, xi = _planes((B, n), n + inverse, dev)
        xc = torch.complex(xr, xi)
        lib = torch.fft.ifft if inverse else torch.fft.fft
        row_of("fft_twofactor", (B, n),
               lambda: ck.fft_twofactor(xr, xi, inverse, 1.0, swapped),
               lambda: ck.fft_twofactor_plain(xr, xi, inverse, 1.0, swapped),
               16.0 * B * n + 8.0 * n, B * (_fft_ops(n, n) + _cmul_ops(n)),
               (lambda: lib(xc, norm="forward")) if inverse
               else (lambda: lib(xc)),
               {"inverse": inverse, "swapped": swapped,
                "split": list(ck.twofactor_split(n)),
                "registers": regs, "spill_bytes": [spill_st, spill_ld],
                "threads": ck.twofactor_layout(n)[0],
                "lines_per_block": ck.twofactor_layout(n)[1],
                "smem_bytes": ck.twofactor_layout(n)[2],
                "blocks_per_sm": ck.twofactor_occupancy(n),
                "library": ("torch.fft.fft, natural order (the kernel's "
                            "output is in swapped order)") if swapped
                else "torch.fft"})
        del xr, xi, xc
    # fft_conv_inv: the 7919 row's multiply and inverse with the x0 term
    B, p = _sample_7_batch(7919), 7919
    m = p - 1
    xr, xi = _planes((B, m), 37, dev)
    dc = tuple(t.contiguous() for t in _planes((B,), 38, dev))
    spec = ck.rader_spectrum(p, 1.0, dev, "swapped")
    xc = torch.complex(xr, xi)
    row_of("fft_conv_inv", (B, m), lambda: ck.fft_conv_inv(xr, xi, spec, dc),
           lambda: ck.fft_conv_inv_plain(xr, xi, spec, dc),
           16.0 * B * m + 8.0 * m + 8.0 * B,
           B * (_fft_ops(m, m) + _cmul_ops(2 * m) + 2 * m), None,
           {"mode": "rader p=7919, dc",
            "torch_fft_ms": _time_ms(lambda: torch.fft.ifft(xc))})
    del xr, xi, xc
    # fft_conv_pair: the 10007 row's forward, m = 32768.  The function is
    # an n-point DFT of each line: its bound counts 5 n log2 n operations
    # a line, not the two m-point FFTs of the padded length the planner
    # chose; those stand apart as algorithm_ops_ms
    n = 10007
    B, m = _sample_7_batch(n), plan_axis(n).decomp.bluestein_size
    blu_ops = B * (2 * _fft_ops(m, m) + _cmul_ops(2 * n + 3 * m))
    xr, xi = _planes((B, n), 41, dev)
    spec = ck.bluestein_spectrum(n, m, False, 1.0, dev, "pair")
    chirp = ck.bluestein_chirp(n, m, False, dev)
    xc = torch.complex(xr, xi)
    with open(ck.library_path("fft_conv_pair")[:-3] + ".log") as f:
        regs = {k: (r, st, ld) for k, r, st, ld in _ptxas_kernels(f.read())}
    r, st, ld = regs["fft_conv_pair_kernel"]

    def pair_extra():
        nc, ns, c, threads, smem = ck.conv_pair_layout(m)
        clusters, blocks = ck.conv_pair_occupancy(m)
        return {"m": m, "plane": [nc, ns], "cluster": c, "threads": threads,
                "smem_bytes": smem, "registers": r, "spill_bytes": [st, ld],
                "resident_clusters": clusters, "blocks_per_sm": blocks,
                "algorithm_ops_ms": blu_ops / FP32_FLOP_PER_S * 1e3}

    row_of("fft_conv_pair", (B, n),
           lambda: ck.fft_conv_pair(xr, xi, spec, chirp),
           lambda: ck.fft_conv_pair_plain(xr, xi, spec, chirp),
           16.0 * B * n + 8.0 * (2 * m + n), _fft_ops(B * n, n),
           lambda: torch.fft.fft(xc), pair_extra())
    # the layout sweep at m = 32768: every plane (nc, ns) of the stages'
    # lengths and every cluster the layout rule allows on it (2 blocks
    # would hold 16384 points, above CONV_PAIR_TILE_MAX), timed in turns
    # (down the list, then up), each against the plain version first
    variants = []
    for nc in (d for d in range(1, m + 1) if m % d == 0):
        ns = m // nc
        if nc <= ns and ck.kernel_supports(nc) and ck.kernel_supports(ns):
            for c in ck.PAIR_CLUSTERS:
                if nc % c or ns % c or m // c > ck.CONV_PAIR_TILE_MAX:
                    continue
                with _conv_pair_plan_forced(ck, m, (nc, ns, c)):
                    threads = ck.conv_pair_layout(m)[3]
                if all(ck.walk_rounds_fit(k, threads, True) for k in (nc, ns)):
                    variants.append((nc, ns, c))
    rows, tables = {}, {}
    for plan in variants + variants[::-1]:
        with _conv_pair_plan_forced(ck, m, plan):
            sp = ck.bluestein_spectrum(n, m, False, 1.0, dev, "pair")
            if plan[:2] not in tables:
                tables[plan[:2]] = ck.fft_conv_pair_plain(xr, xi, sp, chirp)
            fn = lambda: ck.fft_conv_pair(xr, xi, sp, chirp)
            row = rows.setdefault(plan, dict(pair_extra(), stages=sum(
                len(ck.walk_radices(k)) for k in plan[:2]), ms=[]))
            row["max_abs_err"] = _errors(fn(), tables[plan[:2]],
                                         ("fft_conv_pair", plan))
            row["ms"].append(_time_ms(fn))
    sweep_rows = list(rows.values())
    for row in sweep_rows:
        _log(f"[time] fft_conv_pair layout sweep {row}")
    del xr, xi, xc, tables

    e2e = []
    for n in SAMPLE_7:
        B = _sample_7_batch(n)
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=False))
        x = vt.Planar(*_planes((B, n), n + 1, dev))
        xc = torch.complex(x.re, x.im)
        plan = plan_axis(n)
        # cli.py's nominal bytes (fwd + inv, one read and one write) and
        # the nominal 5 n log2 n operations of an n-point DFT a line and
        # direction; the two FFTs of the convolution length that Rader
        # (n - 1) or Bluestein (the padded m) run stand apart
        nbytes = 4 * 8.0 * B * n
        bound, by = _bound(nbytes, 2 * _fft_ops(B * n, n))
        core = {"bluestein": plan.decomp.bluestein_size, "rader": n - 1}.get(
            plan.algorithm.value)
        ms = _time_ms(lambda: app.inverse(app.forward(x)))
        row = {"row": f"sample7_n{n}", "shape": [B, n],
               "plan": plan.algorithm.value, "ms": ms,
               "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
               "algorithm_ops_ms": core and 2 * B * 2 * _fft_ops(core, core)
               / FP32_FLOP_PER_S * 1e3,
               "torch_fft_ms": _time_ms(
                   lambda: torch.fft.ifft(torch.fft.fft(xc), norm="forward"))}
        row["vs_torch_fft"] = row["torch_fft_ms"] / ms
        _log(f"[time] e2e {row}")
        e2e.append(row)
        del x, xc
    return {"kernels": kernels, "e2e": e2e,
            "conv_pair_layout_sweep": sweep_rows}


# ---------------------------------------------------------------------------
# Real-to-real transforms: DCT/DST types I-IV.
# ---------------------------------------------------------------------------

R2R_KERNELS = ("fft_dct23", "fft_dct1", "fft_dct4")
R2R_TOL = 1e-5                # round trips, of max|x|


def _r2r_cases(ck) -> dict:
    """(kernel, call, plain, scipy type) per gate: the lengths each R2R
    kernel takes (`dct23_supports`, `dct1_supports`, `dct4_supports`)."""
    def dct23(type3):
        return (lambda x, dst, s: (ck.fft_dct3 if type3 else ck.fft_dct2)(
                    x, dst, s),
                lambda x, dst, s: ck.fft_dct23_plain(x, type3, dst, s),
                3 if type3 else 2)
    return {"fft_dct23": ([n for n in range(2, ck.KERNEL_MAX_N + 1)
                           if ck.dct23_supports(n)],
                          (dct23(False), dct23(True))),
            "fft_dct1": ([(n, dst) for dst in (False, True)
                          for n in range(2, ck.KERNEL_MAX_N + 2)
                          if ck.dct1_supports(n, dst)],
                         ((ck.fft_dct1, ck.fft_dct1_plain, 1),)),
            "fft_dct4": ([n for n in range(2, 2 * ck.KERNEL_MAX_N + 1)
                          if ck.dct4_supports(n)],
                         ((ck.fft_dct4, ck.fft_dct4_plain, 4),))}


def phase_r2r_kernels_vs_plain(ck, dev) -> dict:
    """fft_dct23, fft_dct1 and fft_dct4 against their plain versions on the
    card and against scipy.fft fp64, at every SWEEP_STRIDE-th length each
    gate takes (batch 2; fft_dct23 cycles through types II and III, every
    kernel through both flags, the scale 0.5 or 1/(2n)), and at one odd
    batch of 33 lines a kernel."""
    import scipy.fft as sfft
    t0 = time.perf_counter()
    out = {}
    for name, (lengths, calls) in _r2r_cases(ck).items():
        picked = _every_stride(lengths)
        row = {"lengths": len(lengths), "checked": 0, "worst": 0.0,
               "worst_scipy": 0.0}
        for i, case in enumerate(picked):
            n, dst = case if isinstance(case, tuple) else (case, bool(i % 2))
            call, plain, t = calls[(i // 2) % len(calls)]
            scale = 0.5 if i % 3 else 1.0 / (2 * n)
            B = 33 if i == 0 else 2
            x = torch.from_numpy(_host_planes((B, n), n + i)[0]).to(dev)
            y = call(x, dst, scale)
            p = plain(x, dst, scale)
            err = _rel(y, p)
            want = (sfft.dst if dst else sfft.dct)(_host(x), type=t) * scale
            e_s = _numpy_rel(_host(y), want)
            assert err <= KERNEL_TOL and e_s <= NUMPY_TOL, \
                (name, n, t, dst, err, e_s)
            row["checked"] += 1
            row["worst"] = max(row["worst"], err)
            row["worst_scipy"] = max(row["worst_scipy"], e_s)
        out[name] = row
    out.update(_dct_walk_checks(ck, dev))
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    _log(f"[r2r kernels] {out}")
    return out


def _dct_class(ck, n, type4):
    """The layout class of fft_dct23 (fft_dct4 with ``type4``) at length n:
    the kernel (odd n: the 2n form), whether it runs two factors, threads,
    pipelines a block, whether a stage is the generic prime one."""
    points = ck.dct4_points(n) if type4 else n
    n1, n2 = ck.dct_split(points, type4)
    threads, lines, _ = (ck.dct4_layout if type4 else ck.dct23_layout)(n)
    return (bool(type4 and n % 2), n2 > 1, threads, lines,
            ck.walk_generic((n1, n2)))


def _dct1_classes(ck) -> dict:
    """One (n, dst) of each layout class fft_dct1 serves: whether it runs
    two factors, threads, lines a block, whether a stage is the generic
    prime one, the parity of its M points."""
    out = {}
    for dst in (False, True):
        for n in range(3, ck.KERNEL_MAX_N + 2):
            if ck.dct1_supports(n, dst):
                M = ck.dct1_length(n, dst)
                split = ck.dct_split(M, True)
                threads, lines, _ = ck.dct1_layout(n, dst)
                out.setdefault((split[1] > 1, threads, lines,
                                ck.walk_generic(split), M % 2), (n, dst))
    return out


def _dct_classes(ck, type4) -> dict:
    """One length of each layout class the kernel serves: {class: n}."""
    supports = ck.dct4_supports if type4 else ck.dct23_supports
    top = 2 * ck.KERNEL_MAX_N if type4 else ck.KERNEL_MAX_N
    out = {}
    for n in range(4, top + 1):
        if supports(n):
            out.setdefault(_dct_class(ck, n, type4), n)
    return out


# fft_dct23 / fft_dct1 / fft_dct4 launched inside sentinel guards: sample
# 101's n = 32 and 96, sample 100's 255, 256, 1024, DCT-I's 1025 and DST-I's
# 1023 rows, the longest lines
DCT_GUARDED = (32, 96, 255, 256, 1023, 1024, 1025, 4095, 8192, 16384)
DCT_GUARD = 1 << 12           # sentinel floats each side of an output


def _dct_guarded(ck, x, type, dst, offset, dev):
    """One launch of fft_dct1/2/3/4 with its output inside a buffer of
    sentinel values (DCT_GUARD floats each side and ``offset`` more before):
    (the output, the guard cells the launch changed)."""
    B, n = x.shape
    numel, sentinel = B * n, 12345.0
    lead = DCT_GUARD + offset
    buf = torch.full((lead + numel + DCT_GUARD,), sentinel, device=dev)
    y = buf[lead:lead + numel].view(B, n)
    lead_args = (n, int(dst)) if type == 4 else (int(dst),)
    ck._launch(ck.DCT_LIBRARIES[type], f"fft_dct{type}", dev,
               [x, y, B, *lead_args,
                *ck._dct_walk_args(n, type, 0.5, dev, dst)])
    changed = (int((buf[:lead] != sentinel).sum())
               + int((buf[lead + numel:] != sentinel).sum()))
    return y, changed


def _dct_walk_checks(ck, dev) -> dict:
    """fft_dct23 (types II and III) and fft_dct4 at one length of every
    layout class, at a batch of three blocks and one line more (an odd
    count of lines: the last pipeline of fft_dct23 and of odd-n fft_dct4,
    two lines each, carries one), both flags, against their plain
    versions, and fft_dct1 at one (n, flag) of each of its layout classes;
    then guarded launches at DCT_GUARDED with the output at float offsets
    0..3, where even-n fft_dct4, which stores float2 pairs, must refuse
    the odd offsets and write nothing."""
    out = {}
    for name, type4 in (("fft_dct23", False), ("fft_dct4", True)):
        classes = _dct_classes(ck, type4)
        row = {"classes": len(classes), "checked": 0, "worst": 0.0}
        for cls, n in classes.items():
            lines = (ck.dct4_layout if type4 else ck.dct23_layout)(n)[1]
            per = lines if type4 and n % 2 == 0 else 2 * lines
            B = 3 * per + 1
            x = torch.from_numpy(_host_planes((B, n), n)[0]).to(dev)
            for type in ((4,) if type4 else (2, 3)):
                for dst in (False, True):
                    call = {2: ck.fft_dct2, 3: ck.fft_dct3,
                            4: ck.fft_dct4}[type]
                    got = call(x, dst, 0.5)
                    want = (ck.fft_dct4_plain(x, dst, 0.5) if type4 else
                            ck.fft_dct23_plain(x, type == 3, dst, 0.5))
                    err = _rel(got, want)
                    assert err <= KERNEL_TOL, (name, cls, n, type, dst, err)
                    row["checked"] += 1
                    row["worst"] = max(row["worst"], err)
        out[f"{name}_classes"] = row
        _log(f"[r2r kernels] {name} layout classes: {row}")
    # fft_dct1 at one (n, flag) of every layout class, three blocks and a
    # line
    classes = _dct1_classes(ck)
    row = {"classes": len(classes), "checked": 0, "worst": 0.0}
    for cls, (n, dst) in classes.items():
        B = 3 * ck.dct1_layout(n, dst)[1] + 1
        x = torch.from_numpy(_host_planes((B, n), n)[0]).to(dev)
        err = _rel(ck.fft_dct1(x, dst, 0.5), ck.fft_dct1_plain(x, dst, 0.5))
        assert err <= KERNEL_TOL, ("fft_dct1", cls, n, dst, err)
        row["checked"] += 1
        row["worst"] = max(row["worst"], err)
    out["fft_dct1_classes"] = row
    _log(f"[r2r kernels] fft_dct1 layout classes: {row}")
    guarded = {"launches": 0, "refused": 0, "worst": 0.0}
    for n in DCT_GUARDED:
        x = torch.from_numpy(_host_planes((5, n), n + 1)[0]).to(dev)
        for type in (1, 2, 3, 4):
            for dst in (False, True):
                if not (ck.dct1_supports(n, dst) if type == 1
                        else ck.dct4_supports(n) if type == 4
                        else ck.dct23_supports(n)):
                    continue
                want = (ck.fft_dct1_plain(x, dst, 0.5) if type == 1 else
                        ck.fft_dct4_plain(x, dst, 0.5) if type == 4 else
                        ck.fft_dct23_plain(x, type == 3, dst, 0.5))
                for offset in range(4):
                    if type == 4 and n % 2 == 0 and offset % 2:
                        try:
                            _dct_guarded(ck, x, type, dst, offset, dev)
                        except RuntimeError:
                            guarded["refused"] += 1
                            continue
                        raise AssertionError(("not refused", n, offset))
                    got, changed = _dct_guarded(ck, x, type, dst, offset, dev)
                    err = _rel(got, want)
                    assert changed == 0 and err <= KERNEL_TOL, \
                        (n, type, dst, offset, changed, err)
                    guarded["launches"] += 1
                    guarded["worst"] = max(guarded["worst"], err)
    out["dct_guarded"] = guarded
    return out


# every SWEEP_STRIDE-th n in 2..4096, sample 16/17's and sample 100's
# lengths, and two past the JAX package's gates (4099 prime; 8192, whose
# 2n is beyond its kernels: here fft_dct23 and fft_dct4 take it)
R2R_ROUTE_LENGTHS = sorted(set(range(2, 4097, SWEEP_STRIDE))
                           | {16, 64, 100, 255, 256, 1000, 1024, 4096, 4099,
                              8192})
# lengths of the odd-offset views: even and odd n, one pass and two factors
R2R_ODD_VIEW_LENGTHS = (96, 255, 256, 1024, 8192)


def phase_r2r_routes(vt, dev) -> dict:
    """Every type of vt.dct/vt.dst and its inverse at R2R_ROUTE_LENGTHS
    (batch 2) on the card: forward against scipy fp64, the round trip
    against the input; none may raise.  Then dctn/dstn over axis subsets
    and the input left unchanged."""
    import scipy.fft as sfft
    t0 = time.perf_counter()
    worst = {"fwd": 0.0, "round_trip": 0.0}
    cases = 0
    fams = (("dct", vt.dct, vt.idct, sfft.dct), ("dst", vt.dst, vt.idst,
                                                 sfft.dst))
    for n in R2R_ROUTE_LENGTHS:
        xh = _host_planes((2, n), n)[0]
        x = torch.from_numpy(xh).to(dev)
        xd = xh.astype(np.float64)
        for fam, fwd, inv, sci in fams:
            for t in (1, 2, 3, 4):
                if fam == "dct" and t == 1 and n < 2:
                    continue
                y = fwd(x, type=t)
                z = inv(y, type=t)
                h = torch.stack([y, z]).double().cpu().numpy()
                e_f = _numpy_rel(h[0], sci(xd, type=t))
                e_r = _numpy_rel(h[1], xd)
                assert e_f <= NUMPY_TOL and e_r <= R2R_TOL, (fam, t, n, e_f,
                                                             e_r)
                worst["fwd"] = max(worst["fwd"], e_f)
                worst["round_trip"] = max(worst["round_trip"], e_r)
                cases += 1
    nd = []
    for shape, axes in (((6, 96, 96), (1, 2)), ((3, 32, 32, 32), None),
                        ((40, 7, 64), (0,)), ((5, 255, 12), (1,))):
        xh = _host_planes(shape, sum(shape))[0]
        x = torch.from_numpy(xh).to(dev)
        keep = x.clone()
        ax = tuple(range(len(shape))) if axes is None else axes
        for t in (1, 2, 3, 4):
            for fn, sci in ((vt.dctn, sfft.dctn), (vt.dstn, sfft.dstn)):
                e = _numpy_rel(_host(fn(x, type=t, axes=axes)),
                               sci(xh.astype(np.float64), type=t, axes=ax))
                assert e <= NUMPY_TOL, (shape, axes, t, e)
                nd.append(e)
        assert torch.equal(x, keep), shape
    # contiguous views that start at an odd float: the kernels that read
    # float2 pairs (even-n fft_dct4) must get an aligned copy
    odd_view = []
    for n in R2R_ODD_VIEW_LENGTHS:
        xh = _host_planes((3, n), n + 2)[0]
        xd = xh.astype(np.float64)
        x = torch.zeros(3 * n + 1, device=dev)[1:].view(3, n)
        assert x.data_ptr() % 8, n
        x.copy_(torch.from_numpy(xh).to(dev))
        keep = x.clone()
        for t in (2, 3, 4):
            for fn, sci in ((vt.dct, sfft.dct), (vt.dst, sfft.dst),
                            (vt.idct, sfft.idct), (vt.idst, sfft.idst)):
                e = _numpy_rel(_host(fn(x, type=t)), sci(xd, type=t))
                assert e <= NUMPY_TOL, (n, fn.__name__, t, e)
                odd_view.append(e)
            for fn, sci in ((vt.dctn, sfft.dctn), (vt.dstn, sfft.dstn)):
                e = _numpy_rel(_host(fn(x, type=t, axes=(1,))),
                               sci(xd, type=t, axes=(1,)))
                assert e <= NUMPY_TOL, (n, fn.__name__, t, e)
                odd_view.append(e)
        assert torch.equal(x, keep), n
    out = {"lengths": len(R2R_ROUTE_LENGTHS), "cases": cases, "worst": worst,
           "nd_cases": len(nd), "nd_worst": max(nd),
           "odd_view_cases": len(odd_view), "odd_view_worst": max(odd_view),
           "seconds": time.perf_counter() - t0}
    _log(f"[r2r routes] {out}")
    return out


R2R_BYTES = 128 * 1024 * 1024
SAMPLE_100 = ((2, 256), (2, 1024), (2, 255), (4, 256), (4, 1024), (4, 255))
SAMPLE_101 = ((96, 96), (32, 32, 32))      # vkfft_tpu/cli.py:952-973


def _r2r_paths(vt, dev) -> list:
    """(name, inputs, drive, launches it must make, check) of each main-path
    R2R row: sample 100 (cli.py:424-446; idct(dct(x, t), t) at 128 MiB of
    fp32 lines), the DCT-I and DST-I round trips at n = 1025 and 1023, and
    sample 101 (FFTApplication(kind=DCT), forward then inverse, batched to
    128 MiB)."""
    paths = []
    for t, n in SAMPLE_100:
        B = R2R_BYTES // (4 * n)
        x = _planes((B, n), t * n, dev)[0]
        paths.append((f"sample100_dct{t}_n{n}", x,
                      lambda x, t=t: _fwd_inv(lambda v: vt.dct(v, type=t),
                                              lambda v: vt.idct(v, type=t), x),
                      {"fft_dct4" if t == 4 else "fft_dct23": 2}, ("dct", t)))
    for fam, n in (("dct", 1025), ("dst", 1023)):
        fwd, inv = (vt.dct, vt.idct) if fam == "dct" else (vt.dst, vt.idst)
        x = _planes((R2R_BYTES // (4 * n), n), n, dev)[0]
        paths.append((f"{fam}1_n{n}", x,
                      lambda x, fwd=fwd, inv=inv: _fwd_inv(
                          lambda v: fwd(v, type=1), lambda v: inv(v, type=1),
                          x),
                      {"fft_dct1": 2}, (fam, 1)))
    for shape in SAMPLE_101:
        B = R2R_BYTES // (4 * math.prod(shape))
        for t in (2, 3):
            app = vt.FFTApplication(vt.FFTConfig(
                shape=shape, kind=vt.TransformKind.DCT, rr_type=t))
            x = _planes((B,) + shape, t + len(shape), dev)[0]
            paths.append((f"sample101_dct{t}_{'x'.join(map(str, shape))}", x,
                          lambda x, app=app: _fwd_inv(app.forward, app.inverse,
                                                      x),
                          {"fft_dct23": 2 * len(shape)}, ("dctn", t)))
    return paths


def _fwd_inv(fwd, inv, x):
    y = fwd(x)
    return y, inv(y)


def phase_r2r_main_path(vt, ck, torch_engine, dev) -> dict:
    """The R2R rows through the entry points a user calls, each with the
    counts set to 0 just before it and read just after, held to its exact
    launches and no plain-engine call; the forward of the first 16 lines (or
    volumes) against scipy fp64 and the whole round trip against the
    input."""
    import scipy.fft as sfft
    rows, by_path = [], {}
    for name, x, drive, want, (fam, t) in _r2r_paths(vt, dev):
        keep = x[:16].clone()
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        y, z = drive(x)
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_path[name] = got
        _log(f"[main r2r] {name}: launches {got}, plain engine calls "
             f"{torch_engine.calls}")
        assert got == {k: want.get(k, 0) for k in got}, (name, got, want)
        assert torch_engine.calls == 0, (name, torch_engine.calls)
        head = _host(x[:16])
        sci = {"dct": sfft.dct, "dst": sfft.dst}.get(fam)
        ref = (sci(head, type=t) if sci else
               sfft.dctn(head, type=t, axes=tuple(range(1, x.ndim))))
        row = {"row": name, "shape": list(x.shape),
               "rel_err_fwd_vs_scipy": _numpy_rel(_host(y[:16]), ref),
               "rel_err_round_trip": _rel(z, x),
               "finite": bool(torch.isfinite(y).all()
                              and torch.isfinite(z).all())}
        _log(f"[main r2r] {row}")
        assert row["finite"] and y.shape == x.shape and z.shape == x.shape, row
        assert row["rel_err_fwd_vs_scipy"] <= NUMPY_TOL \
            and row["rel_err_round_trip"] <= R2R_TOL, row
        assert torch.equal(x[:16], keep), name
        rows.append(row)
        del x, y, z
    launches = {k: sum(c[k] for c in by_path.values()) for k in ck.launches}
    return {"launches": launches, "launches_by_path": by_path,
            "plain_engine_calls": 0, "rows": rows}


class _dct_layout_forced:
    """fft_dct23 and fft_dct4 with the split, points a block and points a
    thread of layout ``v`` for the time of the block (their layout rules
    read `cuda_kernels.dct_split` and DCT23_BLOCK_POINTS / DCT23_AIM_POINTS,
    R2C_BLOCK_POINTS / R2C_AIM_POINTS)."""

    NAMES = ("DCT23_BLOCK_POINTS", "DCT23_AIM_POINTS", "R2C_BLOCK_POINTS",
             "R2C_AIM_POINTS")

    def __init__(self, ck, v):
        self.ck, self.v = ck, v

    def __enter__(self):
        ck, v = self.ck, self.v
        self.saved = (ck.dct_split,) + tuple(getattr(ck, k)
                                             for k in self.NAMES)
        ck.dct_split = lambda points, type4=False: tuple(v["split"])
        for k in self.NAMES:
            setattr(ck, k, v["aim"] if k.endswith("AIM_POINTS")
                    else v["block_points"])

    def __exit__(self, *exc):
        self.ck.dct_split = self.saved[0]
        for k, val in zip(self.NAMES, self.saved[1:]):
            setattr(self.ck, k, val)


# the R2R kernels' timed rows: fft_dct23 (types II and III) at sample 100's
# n = 256 / 1024 / 255 and sample 101's axes n = 96 / 32; fft_dct4 at
# sample 100's n = 256 / 1024 / 255 (odd: the 2n form); each over R2R_BYTES
DCT23_ROWS = (256, 1024, 255, 96, 32)
DCT4_ROWS = (256, 1024, 255)
# the layout sweep's rows: (type, n)
DCT_SWEEP_ROWS = ((2, 256), (2, 1024), (2, 255), (2, 96), (4, 256),
                  (4, 1024), (4, 255), (1, 1025))


def _dct_layout(ck, regs, type, n, dst=False) -> dict:
    """fft_dct23's, fft_dct1's or fft_dct4's layout at length n, with its
    kernel's registers and spills (ptxas) and its resident blocks an
    SM."""
    if type == 1:
        M = ck.dct1_length(n, dst)
        threads, lines, smem = ck.dct1_layout(n, dst)
        r, st, ld = regs["dct1_kernel"]
        return {"kernel": "dct1_kernel", "pipeline_points": M,
                "split": list(ck.dct_split(M, True)), "threads": threads,
                "lines_per_block": lines, "smem_bytes": smem,
                "registers": r, "spill_bytes": [st, ld],
                "blocks_per_sm": ck.dct1_occupancy(n, dst)}
    type4 = type == 4
    points = ck.dct4_points(n) if type4 else n
    threads, lines, smem = (ck.dct4_layout if type4 else ck.dct23_layout)(n)
    kernel = ({2: "dct2_kernel", 3: "dct3_kernel"}.get(type)
              or ("dct4_odd_kernel" if n % 2 else "dct4_even_kernel"))
    r, st, ld = regs[kernel]
    return {"kernel": kernel, "pipeline_points": points,
            "split": list(ck.dct_split(points, type4)), "threads": threads,
            "lines_per_block": lines, "smem_bytes": smem, "registers": r,
            "spill_bytes": [st, ld],
            "blocks_per_sm": (ck.dct4_occupancy(n) if type4
                              else ck.dct23_occupancy(n, type == 3))}


def _dct_sweep(ck, regs, dev) -> list:
    """The layout sweep of fft_dct23 (type II), fft_dct4 and fft_dct1
    (DCT-I) at DCT_SWEEP_ROWS over R2R_BYTES: the splits of
    `_lines_splits` on the
    pipeline's points and the blocks of R2C_SWEEP, each held against the
    plain version, timed in turns (down the list, then up)."""
    rows = []
    for type, n in DCT_SWEEP_ROWS:
        B = R2R_BYTES // (4 * n)
        x = _planes((B, n), n + 11, dev)[0]
        call = {1: lambda: ck.fft_dct1(x, False, 1.0),
                2: lambda: ck.fft_dct2(x, False, 1.0),
                4: lambda: ck.fft_dct4(x, False, 1.0)}[type]
        plain = {1: lambda: ck.fft_dct1_plain(x, False, 1.0),
                 2: lambda: ck.fft_dct23_plain(x, False, False, 1.0),
                 4: lambda: ck.fft_dct4_plain(x, False, 1.0)}[type]()
        points = {1: ck.dct1_length(n, False), 2: n,
                  4: ck.dct4_points(n)}[type]
        layout = {1: lambda n: ck.dct1_layout(n, False), 2: ck.dct23_layout,
                  4: ck.dct4_layout}[type]
        sweep, seen = [], []
        for split, (bp, aim) in ((p, v) for p in _lines_splits(ck, points)
                                 for v in R2C_SWEEP):
            v = {"split": list(split), "block_points": bp, "aim": aim}
            with _dct_layout_forced(ck, v):
                threads = layout(n)[0]
                key = (v["split"], list(layout(n)))
                if (all(ck.walk_rounds_fit(k, threads, True) for k in split)
                        and key not in seen):
                    seen.append(key)
                    v.update(type=type, shape=[B, n], layout=list(layout(n)),
                             blocks_per_sm=_dct_layout(ck, regs, type, n)[
                                 "blocks_per_sm"], ms=[])
                    sweep.append(v)
        for v in sweep + sweep[::-1]:
            with _dct_layout_forced(ck, v):
                rel = _rel(call(), plain)
                assert rel <= KERNEL_TOL, (type, n, v, rel)
                v["ms"].append(_time_ms(call, reps=7))
        best = min(sweep, key=lambda v: min(v["ms"]))
        _log(f"[time] dct layout sweep type {type} n={n}: {len(sweep)} "
             f"layouts, rule {list(layout(n))} split "
             f"{list(ck.dct_split(points, type != 2))}; best {best}")
        rows += sweep
        del x, plain
    return rows


def phase_r2r_times(vt, ck, dev) -> dict:
    """The R2R kernels at the main path's shapes (each held against its
    plain version there, with its layout, registers, spills, blocks an SM
    and launches a call), fft_dct23's and fft_dct4's layout sweep, and the
    main-path rows' round trips: ms, GB/s by the convention of one 4 B read
    and one 4 B write a point per kernel pass and direction, the bound, and
    torch.fft.rfft + irfft of the same lines as a yardstick that is not the
    same function (no PyTorch call computes a DCT).  The N-D rows also
    print the share of the round trip outside the kernels: the copies that
    move each non-minor axis last and back."""
    _log(f"[time] card: {_smi()}")
    kernels = {k: [] for k in R2R_KERNELS}
    regs = {}
    for lib in ("fft_dct23", "fft_dct4", "fft_dct1"):
        with open(ck.library_path(lib)[:-3] + ".log") as f:
            regs.update({k: (r, st, ld)
                         for k, r, st, ld in _ptxas_kernels(f.read())})

    def r2r_ops(B, n, points):
        # a real FFT of n points (2.5 n log2 n) and O(n) rotations a line,
        # on the points of the kernel's complex pipeline
        return B * (2.5 * points * math.log2(max(points, 2)) + 6.0 * n)

    def kernel_row(name, B, n, points, fn, plain, extra):
        x = _planes((B, n), n + 7, dev)[0]
        before = dict(ck.launches)
        y = fn(x)
        calls = {k: c - before[k] for k, c in ck.launches.items()
                 if c != before[k]}
        p = plain(x)
        rel = _rel(y, p)
        assert rel <= KERNEL_TOL, (name, B, n, rel)
        err = (y - p).abs().max().item()
        del y, p
        nbytes = 8.0 * B * n
        bound, by = _bound(nbytes, r2r_ops(B, n, points))
        row = dict(extra)
        row.update({"shape": [B, n], "ms": _time_ms(lambda: fn(x)),
                    "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                    "launches_per_call": calls,
                    "plain_ms": _time_ms(lambda: plain(x), reps=5, inner=1,
                                         warmup=1),
                    "library_ms": None,
                    "rfft_irfft_ms_not_same_function": _time_ms(
                        lambda: torch.fft.irfft(torch.fft.rfft(x), n=n))})
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] {name} {row}")
        kernels[name].append(row)
        return row["ms"]

    dct23_ms = {}
    for n in DCT23_ROWS:
        B = R2R_BYTES // (4 * n)
        for type3 in (False, True):
            f = ck.fft_dct3 if type3 else ck.fft_dct2
            s = 1.0 / (2 * n) if type3 else 1.0
            dct23_ms[n, type3] = kernel_row(
                "fft_dct23", B, n, n, lambda x, f=f, s=s: f(x, False, s),
                lambda x, ty=type3, s=s: ck.fft_dct23_plain(x, ty, False, s),
                {"type": 3 if type3 else 2,
                 **_dct_layout(ck, regs, 3 if type3 else 2, n)})
    for n in DCT4_ROWS:
        kernel_row("fft_dct4", R2R_BYTES // (4 * n), n, ck.dct4_points(n),
                   lambda x: ck.fft_dct4(x, False, 1.0),
                   lambda x: ck.fft_dct4_plain(x, False, 1.0),
                   {"type": 4, **_dct_layout(ck, regs, 4, n)})
    for dst, n in ((False, 1025), (True, 1023)):
        kernel_row("fft_dct1", R2R_BYTES // (4 * n), n,
                   ck.dct1_length(n, dst),
                   lambda x, d=dst: ck.fft_dct1(x, d, 1.0),
                   lambda x, d=dst: ck.fft_dct1_plain(x, d, 1.0),
                   {"dst": dst, **_dct_layout(ck, regs, 1, n, dst)})
    # the redesigned kernel: at most 64 registers, no spill
    r, st, ld = regs["dct1_kernel"]
    assert r <= 64 and st == ld == 0, regs["dct1_kernel"]
    sweep = _dct_sweep(ck, regs, dev)
    # fft_dct23 on the lines of sample 101's axes (n = 96, 32), the rows
    # above at R2R_BYTES, as sample 101's rows batch them
    axis_ms = {shape: dct23_ms[shape[-1], False] + dct23_ms[shape[-1], True]
               for shape in SAMPLE_101}

    e2e = []
    for name, x, drive, want, (fam, t) in _r2r_paths(vt, dev):
        passes = sum(want.values()) // 2
        n = x.shape[-1]
        lines = x.numel() // n
        nbytes = 2 * passes * 8.0 * x.numel()
        bound, by = _bound(nbytes, 2 * passes * r2r_ops(lines, n, n))
        ms = _time_ms(lambda: drive(x))
        row = {"row": name, "shape": list(x.shape), "ms": ms,
               "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
               "kernel_passes_per_dir": passes,
               "rfft_irfft_ms_not_same_function": _time_ms(
                   lambda: torch.fft.irfftn(torch.fft.rfftn(
                       x, dim=tuple(range(x.ndim - passes, x.ndim))),
                       s=x.shape[x.ndim - passes:],
                       dim=tuple(range(x.ndim - passes, x.ndim))))}
        if passes > 1:
            shape = tuple(x.shape[1:])
            kms = passes * axis_ms[shape]
            row["kernels_ms"] = kms
            row["glue_share"] = 1.0 - kms / ms
        _log(f"[time] e2e {row}")
        e2e.append(row)
        del x
    return {"kernels": kernels, "layout_sweep": sweep, "e2e": e2e}


# ---------------------------------------------------------------------------
# Convolution: ConvolutionApplication, its fused modes and the composition.
# ---------------------------------------------------------------------------

CONV_KERNELS = ("fft_conv", "fft_conv_pair")
CONV_BYTES = 128 * 1024 * 1024   # of complex64 data a row
# (row, shape, config flags, fusion mode, launches of one call): the
# reference's samples 50-52 at full width (vkfft_tpu/cli.py:393, :411,
# :885) and the modes' other rows, each batched to CONV_BYTES (4096, 5461,
# 256, 64, 8, 1638 and 21 items; sample 51, the composition, at (64, 64,
# 64) with 3 coordinates, 126 MiB)
CONV_ROWS = (
    ("v3_1d_n4096", (4096,), {}, "v3_1d", {"fft_conv": 1}),
    ("sample50_mat3_n1024", (1024,),
     dict(matrix_convolution=3, coordinate_features=3), "v3_mat",
     {"fft_conv": 1}),
    ("sample52_256x256", (256, 256), {}, "pair", {"fft_conv_pair": 1}),
    ("rows_512x512", (512, 512), {}, "v3_rows",
     {"fft_strided": 2, "fft_conv": 1}),
    ("per_slice_32x256x256", (32, 256, 256), {}, "pair",
     {"fft_strided": 2, "fft_conv_pair": 1}),
    ("v2_2k_n10240", (10240,), {}, "v2_2k",
     {"fft_twofactor": 1, "fft_conv_inv": 1}),
    ("sample51_mat3_64cube", (64, 64, 64),
     dict(matrix_convolution=3, coordinate_features=3,
          zeropad_input=(None, None, (32, 64))), None,
     {"fft_pair": 2, "fft_strided": 2}),
)
# small shapes of every mode, each flag and the composition's cases
CONV_ROUTES = (
    ((64,), {}), ((4096,), dict(conjugate_convolution=1)),
    ((1000,), dict(conjugate_convolution=2)),
    ((243,), dict(cross_power_spectrum_normalization=True)),
    ((8192,), dict(conjugate_convolution=2,
                   cross_power_spectrum_normalization=True)),
    ((10240,), {}), ((12288,), dict(conjugate_convolution=1)),
    ((10240,), dict(cross_power_spectrum_normalization=True)),
    ((131,), {}), ((64,), dict(number_kernels=2)),
    ((32,), dict(coordinate_features=2)),
    ((256,), dict(matrix_convolution=2, coordinate_features=2)),
    ((4096,), dict(matrix_convolution=3, coordinate_features=3,
                   conjugate_convolution=2,
                   cross_power_spectrum_normalization=True)),
    ((8192,), dict(matrix_convolution=3, coordinate_features=3)),
    ((64, 64), {}), ((96, 60), dict(conjugate_convolution=1)),
    ((256, 512), dict(conjugate_convolution=2)),
    ((128, 128), dict(cross_power_spectrum_normalization=True)),
    ((512, 512), dict(conjugate_convolution=1)), ((67, 64), {}),
    ((1024, 256), dict(cross_power_spectrum_normalization=True)),
    ((4, 64, 128), {}), ((3, 5, 7), dict(conjugate_convolution=2)),
    ((2, 3, 64, 64), {}), ((8, 10240), {}),
    ((8, 16), dict(matrix_convolution=2, coordinate_features=2)),
    ((64,), dict(zeropad_input=((24, 64),), zeropad_output=((39, 64),))),
    ((64, 64), dict(zeropad_input=((32, 64), (32, 64)),
                    zeropad_output=((48, 64), (48, 64)))),
    ((8, 8, 32), dict(matrix_convolution=3, coordinate_features=3,
                      zeropad_input=(None, None, (16, 32)))),
)


def _conv_shapes(cfg, batch: int):
    """(kernel shape, data shape) of a convolution config."""
    m, k = cfg.matrix_convolution, cfg.number_kernels
    feats = () if m == 1 and cfg.coordinate_features == 1 else (
        m if m > 1 else cfg.coordinate_features,)
    kshape = (((k,) if k > 1 else ()) + ((m, m) if m > 1 else feats)
              + cfg.shape)
    return kshape, (batch,) + feats + cfg.shape


def _conv_oracle(cfg, x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """numpy fp64 of the convolution of data x with the kernel h: the zero
    pad masks, fftn, the conjugations, the multiply (the matrix einsum, the
    kernel batch), the cross-power normalization and ifftn."""
    ndim = len(cfg.shape)
    axes = tuple(range(-ndim, 0))

    def mask(a, spec):
        for ax, w in enumerate(spec or ()):
            if w is not None:
                idx = [slice(None)] * a.ndim
                idx[a.ndim - ndim + ax] = slice(w[0], w[1])
                a[tuple(idx)] = 0
        return a

    X = np.fft.fftn(mask(x.astype(np.complex128), cfg.zeropad_input),
                    axes=axes)
    H = np.fft.fftn(h.astype(np.complex128), axes=axes)
    if cfg.conjugate_convolution == 1:
        H = np.conj(H)
    elif cfg.conjugate_convolution == 2:
        X = np.conj(X)
    if cfg.matrix_convolution > 1:
        k = "k" if cfg.number_kernels > 1 else ""
        Y = np.einsum(f"{k}oi...,bi...->{k}bo...", H, X)
    elif cfg.number_kernels > 1:
        Y = H.reshape(H.shape[:1] + (1,) * (X.ndim - H.ndim + 1)
                      + H.shape[1:]) * X[None]
    else:
        Y = X * H
    if cfg.cross_power_spectrum_normalization:
        Y = Y / np.maximum(np.abs(Y), 1e-30)
    return mask(np.fft.ifftn(Y, axes=axes), cfg.zeropad_output)


def _cplx2(re: torch.Tensor, im: torch.Tensor) -> np.ndarray:
    return _host(re) + 1j * _host(im)


def _cplx(p) -> np.ndarray:
    return _cplx2(p.re, p.im)


def _conv_mode_numpy(x, t, pair: bool, scale: float, conj_data: bool,
                     xpow: bool) -> np.ndarray:
    """numpy fp64 of a kernel mode: data x ((B, n), (B, mm, n) or (B, ny,
    nz)), the table t raveled; item b takes row (or plane) b % rows."""
    axes = (-2, -1) if pair else (-1,)
    X = np.fft.fftn(x, axes=axes)
    if conj_data:
        X = np.conj(X)
    if x.ndim == 3 and not pair:
        mm, n = x.shape[1:]
        Y = np.einsum("oin,bin->bon", t.reshape(mm, mm, n), X)
    else:
        K = t.reshape((-1,) + x.shape[1:])
        Y = X * K[np.arange(x.shape[0]) % K.shape[0]]
    if xpow:
        Y = Y / np.maximum(np.abs(Y), 1e-30)
    return np.fft.ifftn(Y, axes=axes) * (
        math.prod(x.shape[len(x.shape) - len(axes):]) * scale)


def _conv_mode_cases(ck):
    """(what, planes shape, spectrum length, call kw) of each new mode of
    the two kernels at the main path's shapes and a spread of lengths
    their gates take, each flag combination on each."""
    flags = [dict(conj_data=c, xpow=x) for c in (False, True)
             for x in (False, True)]
    cases = []
    spread = [n for n in (2, 3, 5, 8, 13, 17, 31, 49, 61, 64, 96, 100, 243,
                          256, 343, 512, 625, 1000, 1024, 2048, 2187, 3125,
                          4096, 6561, 8192) if ck.kernel_supports(n)]
    for i, n in enumerate(spread):
        rows = (2, 3, 7)[i % 3]
        for f in flags:
            cases.append(("fft_conv", f"rows {rows} n={n}", (2 * rows, n),
                          rows * n, f))
        for mm in (2, 3):
            if ck.conv_matrix_supports(n, mm):
                for f in flags:
                    cases.append(("fft_conv", f"matrix {mm} n={n}",
                                  (2, mm, n), mm * mm * n, f))
    for f in flags:   # the main path's shapes
        cases += [("fft_conv", "scalar 4096x4096", (4096, 4096), 4096, f),
                  ("fft_conv", "matrix 3 5461x1024", (5461, 3, 1024),
                   9 * 1024, f),
                  ("fft_conv", "rows 512 32768x512", (32768, 512), 512 * 512,
                   f),
                  ("fft_conv_pair", "2-D 256x256x256", (256, 256, 256),
                   256 * 256, f),
                  ("fft_conv_pair", "2-D hp=32 256x256x256", (256, 256, 256),
                   32 * 256 * 256, f)]
    # the 2-D mode's layout classes: clusters of 1 to 16, odd and even
    # column tiles, an axis of two factors (8064 = 112 x 72) either way
    for i, (ny, nz) in enumerate(((2, 2), (3, 5), (8, 8), (16, 60), (64, 64),
                                  (100, 128), (128, 128), (81, 81), (47, 60),
                                  (256, 512), (512, 256), (4096, 2),
                                  (2, 8064), (8064, 2))):
        if ck.pair_cluster(ny, nz) is None:
            continue
        hp = (1, 3)[i % 2]
        for f in flags:
            cases.append(("fft_conv_pair", f"2-D hp={hp} {ny}x{nz}",
                          (3 * hp, ny, nz), hp * ny * nz, f))
    return cases


def phase_conv_kernels_vs_plain(ck, dev) -> dict:
    """The new modes of fft_conv (rows, matrix mm = 2 and 3) and the 2-D
    mode of fft_conv_pair against their plain versions (<= 1e-5 of
    max|ref|), with and without conjugated data and cross-power, at the
    main path's shapes and a spread of lengths, and on the small cases
    against numpy fp64 (<= 5e-6); the 2-D mode also in place and with its
    output inside sentinel guards at float offsets 0 and 1, and its layout
    and resident clusters and blocks an SM at each plane."""
    worst, worst_np, count, vs_numpy = {}, 0.0, 0, 0
    guarded, layouts = 0, {}
    for i, (kernel, what, shape, L, kw) in enumerate(_conv_mode_cases(ck)):
        xr, xi = _planes(shape, 500 + i, dev)
        spec = torch.randn((L, 2), generator=torch.Generator(
            device=dev).manual_seed(900 + i), device=dev)
        ndim2 = kernel == "fft_conv_pair"
        scale = 1.0 / (shape[-1] * (shape[-2] if ndim2 else 1))
        run = ck.fft_conv_pair if ndim2 else ck.fft_conv
        plain = ck.fft_conv_pair_plain if ndim2 else ck.fft_conv_plain
        y = run(xr, xi, spec, None, conj_data=kw["conj_data"],
                xpow=kw["xpow"], scale=scale)
        p = plain(xr, xi, spec, None, kw["conj_data"], kw["xpow"], scale)
        rel = _rel(torch.complex(*y), torch.complex(*p))
        key = f"{kernel} {what.split(' ')[0]}"
        worst[key] = max(worst.get(key, 0.0), rel)
        assert rel <= KERNEL_TOL, (kernel, what, kw, rel)
        count += 1
        if ndim2:
            # the 2-D mode in place, and with its output inside sentinel
            # guards (planes 16-byte aligned or not)
            def call(*q, out):
                return run(*q, spec, None, out=out,
                           conj_data=kw["conj_data"], xpow=kw["xpow"],
                           scale=scale)
            inplace = (xr.clone(), xi.clone())
            got = call(*inplace, out=inplace)
            assert got[0] is inplace[0] and got[1] is inplace[1]
            checks = [("in place", got)]
            for offset in (0, 1):
                got, changed = _guarded(call, (xr, xi), offset)
                assert changed == 0, (what, kw, offset, changed)
                checks.append((("guarded", offset), got))
                guarded += 1
            for how, got in checks:
                rel = _rel(torch.complex(*got), torch.complex(*p))
                worst[key] = max(worst[key], rel)
                assert rel <= KERNEL_TOL, (kernel, what, kw, how, rel)
            del inplace, got, checks
            ny, nz = shape[1:]
            layouts.setdefault(f"{ny}x{nz}", {
                "layout": list(ck.conv2d_layout(ny, nz)),
                "clusters_blocks": list(ck.conv2d_occupancy(ny, nz))})
        if math.prod(shape) <= 1 << 16:
            rel_np = _numpy_rel(_cplx2(*y), _conv_mode_numpy(
                _cplx2(xr, xi), _cplx2(spec[:, 0], spec[:, 1]), ndim2,
                scale, **kw))
            assert rel_np <= NUMPY_TOL, (kernel, what, kw, rel_np)
            worst_np = max(worst_np, rel_np)
            vs_numpy += 1
        del xr, xi, y, p
    _log(f"[conv kernels] {count} cases ({guarded} 2-D guarded), worst vs "
         f"plain {worst}, {vs_numpy} vs numpy, worst {worst_np:.3e}, 2-D "
         f"layouts {layouts}")
    out = {"cases": count, "worst_rel_vs_plain": worst,
           "vs_numpy": vs_numpy, "worst_rel_vs_numpy": worst_np,
           "conv2d_guarded": guarded, "conv2d_layouts": layouts}
    out.update(_conv_walk_checks(ck, dev))
    out.update(_generic_prime_checks(ck, dev))
    return out


def _conv_class(ck, m, mm):
    """The layout class of fft_conv on m-point lines, mm lines an item:
    mm, whether it runs two factors, threads, lines a block, whether a
    stage is the generic prime one."""
    n1, n2 = ck.conv_split(m, mm)
    threads, lines, _ = ck.conv_layout(m, mm)
    return (mm, n2 > 1, threads, lines, ck.walk_generic((n1, n2)))


def _conv_classes(ck) -> dict:
    """One (m, mm) of each layout class fft_conv serves: {class: (m,
    mm)}."""
    out = {}
    for m in range(2, ck.KERNEL_MAX_N + 1):
        if ck.kernel_supports(m):
            for mm in (1, 2, 3):
                if mm == 1 or ck.conv_matrix_supports(m, mm):
                    out.setdefault(_conv_class(ck, m, mm), (m, mm))
    return out


def _twofactor_classes(ck) -> dict:
    """One length of each `twofactor_layout` class (fft_twofactor's and
    fft_conv_inv's): {class: n}."""
    out = {}
    for n in range(2, ck.TWOFACTOR_MAX_N + 1):
        if ck.twofactor_supports(n):
            n1, n2 = ck.twofactor_split(n)
            threads, lines, _ = ck.twofactor_layout(n)
            out.setdefault((n2 > 1, threads, lines,
                            ck.walk_generic((n1, n2))), n)
    return out


# fft_conv and fft_conv_inv launched inside sentinel guards (the output at
# float offsets 0..3 of its buffer, the input copied to the same offset):
# (what, planes shape, table length, chirp length or None, kw)
CONV_GUARDED = (("rader 5003", (5, 5002), 5002, None, {}),
                ("scalar 4096", (3, 4096), 4096, None, dict(xpow=True)),
                ("rows 3", (7, 512), 3 * 512, None, dict(conj_data=True)),
                ("matrix 3", (2, 3, 1024), 9 * 1024, None, {}),
                ("matrix 2", (5, 2, 96), 4 * 96, None,
                 dict(conj_data=True, xpow=True)),
                ("bluestein 263", (4, 263), 539, 263, {}))
CONV_INV_GUARDED = (2, 134, 1000, 7918, 10240, 16384)


def _conv_walk_checks(ck, dev) -> dict:
    """fft_conv (csrc/fft_conv.cu on the walk) at one (m, mm) of every
    layout class of `conv_layout`, three blocks and one item more: mm = 1
    in the rows mode (3 rows) and the scalar mode by turns, mm = 2 and 3 in
    the matrix mode, with and without conjugated data by turns, and the
    Bluestein mode of n = (m + 1) // 2 on every mm = 1 class; fft_conv_inv
    at one length of every `twofactor_layout` class with and without the
    per-line constant; each against its plain version (<= 1e-5) and numpy
    fp64 (<= 5e-6); then both inside sentinel guards at CONV_GUARDED /
    CONV_INV_GUARDED, aligned and not (no write outside the output).  The
    cross-power flag is held by the mode cases above (every flag at a
    spread of lengths and the main path's shapes): Y / |Y| of fp32 spectra
    turns the rounding at a bin of small |Y| into an error of order 1e-5
    of the output in any fp32 implementation (at 76 points, 322 lines:
    the plain version 1.42e-5 from numpy fp64, the kernel 1.15e-5 from
    the plain version)."""
    from vkfft_tpu_torch import luts
    flags = (dict(conj_data=False, xpow=False),
             dict(conj_data=True, xpow=False))
    out = {}
    row = {"classes": 0, "checked": 0, "worst": 0.0, "worst_numpy": 0.0}
    blu = {"checked": 0, "worst": 0.0, "worst_numpy": 0.0}

    def record(r, err, e_np, what):
        assert err <= KERNEL_TOL, (what, err)
        r["checked"] += 1
        r["worst"] = max(r["worst"], err)
        if e_np is not None:
            assert e_np <= NUMPY_TOL, (what, e_np)
            r["worst_numpy"] = max(r["worst_numpy"], e_np)

    for i, (cls, (m, mm)) in enumerate(_conv_classes(ck).items()):
        row["classes"] += 1
        lines = ck.conv_layout(m, mm)[1]
        kw = flags[i % 2]
        rows = 1 if mm > 1 or i % 2 else 3
        B = 3 * lines // mm + 1
        shape = (B, mm, m) if mm > 1 else (B, m)
        x = tuple(torch.from_numpy(a).to(dev)
                  for a in _host_planes(shape, m + mm))
        L = mm * mm * m if mm > 1 else rows * m
        spec = torch.from_numpy(np.stack(_host_planes((L,), m + 7), -1)).to(
            dev)
        got = ck.fft_conv(*x, spec, scale=1.0 / m, **kw)
        want = ck.fft_conv_plain(*x, spec, None, kw["conj_data"],
                                 kw["xpow"], 1.0 / m)
        e_np = _numpy_rel(_cplx2(*got), _conv_mode_numpy(
            _cplx2(*x), _cplx2(spec[:, 0], spec[:, 1]), False, 1.0 / m, **kw))
        record(row, _rel(torch.complex(*got), torch.complex(*want)), e_np,
               (cls, m, mm, kw))
        if mm == 1 and m > 2:
            n = (m + 1) // 2
            inverse = bool(i % 2)
            chirp, b = luts.bluestein_chirp(n, m, inverse)
            tab = lambda t: torch.from_numpy(np.stack(
                [t.real, t.imag], -1).astype(np.float32)).to(dev)
            xb = tuple(t[:, :n].contiguous() for t in x)
            got = ck.fft_conv(*xb, tab(b / m), tab(chirp))
            want = ck.fft_conv_plain(*xb, tab(b / m), tab(chirp))
            ref = (np.fft.ifft(_cplx2(*xb)) * n if inverse
                   else np.fft.fft(_cplx2(*xb)))
            record(blu, _rel(torch.complex(*got), torch.complex(*want)),
                   _numpy_rel(_cplx2(*got), ref), ("bluestein", n, m))
    out["fft_conv_classes"] = row
    out["fft_conv_bluestein_classes"] = blu
    _log(f"[conv kernels] fft_conv layout classes: {row}, Bluestein {blu}")
    inv = {"classes": 0, "checked": 0, "worst": 0.0, "worst_numpy": 0.0}
    for i, (cls, n) in enumerate(_twofactor_classes(ck).items()):
        inv["classes"] += 1
        lines = ck.twofactor_layout(n)[1]
        B = 3 * lines + 1
        x = tuple(torch.from_numpy(a).to(dev)
                  for a in _host_planes((B, n), n + 3))
        spec = torch.from_numpy(np.stack(_host_planes((n,), n + 5), -1)).to(
            dev)
        n1, n2 = ck.twofactor_split(n)
        natural = (_cplx2(*x) * _cplx2(spec[:, 0], spec[:, 1])).reshape(
            B, n2, n1).transpose(0, 2, 1).reshape(B, n)
        for dc in (None, tuple(t.contiguous() for t in x[0][:, :2].T)):
            got = ck.fft_conv_inv(*x, spec, dc, scale=0.5)
            want = ck.fft_conv_inv_plain(*x, spec, dc, 0.5)
            ref = np.fft.ifft(natural) * n * 0.5
            if dc is not None:
                ref = ref + _cplx2(*dc)[:, None]
            record(inv, _rel(torch.complex(*got), torch.complex(*want)),
                   _numpy_rel(_cplx2(*got), ref), ("conv_inv", cls, n))
    out["fft_conv_inv_classes"] = inv
    _log(f"[conv kernels] fft_conv_inv layout classes: {inv}")
    guarded = {"launches": 0, "worst": 0.0}
    for what, shape, L, nc, kw in CONV_GUARDED:
        x = tuple(torch.from_numpy(a).to(dev)
                  for a in _host_planes(shape, L + 11))
        spec = torch.from_numpy(np.stack(_host_planes((L,), L), -1)).to(dev)
        chirp = (torch.from_numpy(np.stack(_host_planes((nc,), nc), -1)).to(
            dev) if nc else None)
        want = ck.fft_conv_plain(*x, spec, chirp, kw.get("conj_data", False),
                                 kw.get("xpow", False), 0.25)
        for offset in range(4):
            got, changed = _guarded(
                lambda *p, out: ck.fft_conv(*p, spec, chirp, out=out,
                                            scale=0.25, **kw), x, offset)
            err = _rel(torch.complex(*got), torch.complex(*want))
            assert changed == 0 and err <= KERNEL_TOL, (what, offset,
                                                         changed, err)
            guarded["launches"] += 1
            guarded["worst"] = max(guarded["worst"], err)
    for n in CONV_INV_GUARDED:
        x = tuple(torch.from_numpy(a).to(dev)
                  for a in _host_planes((5, n), n + 13))
        spec = torch.from_numpy(np.stack(_host_planes((n,), n), -1)).to(dev)
        dc = tuple(t.contiguous() for t in x[1][:, :2].T)
        want = ck.fft_conv_inv_plain(*x, spec, dc, 0.5)
        for offset in range(4):
            got, changed = _guarded(
                lambda *p, out: ck.fft_conv_inv(*p, spec, dc, out=out,
                                                scale=0.5), x, offset)
            err = _rel(torch.complex(*got), torch.complex(*want))
            assert changed == 0 and err <= KERNEL_TOL, (n, offset, changed,
                                                         err)
            guarded["launches"] += 1
            guarded["worst"] = max(guarded["worst"], err)
    out["conv_guarded"] = guarded
    _log(f"[conv kernels] guarded launches: {guarded}")
    return out


PRIMES = tuple(p for p in range(11, 128) if all(p % d for d in range(2, p)))


def _generic_prime_checks(ck, dev) -> dict:
    """Every prime p in 11..127 through each walk kernel that runs it as a
    generic stage: fft_twofactor at p, 2p and 16p (both directions),
    fft_lines, fft_conv (scalar mode), fft_dct23 (types II and III) and
    fft_dct4 at p and 2p, and fft_r2c_pair (its instantiation with the
    generic stage) on a (p, 2p) real plane, where their gates take them
    (primes up to 64 but fft_twofactor's); each against its plain version
    (<= 1e-5) and numpy / scipy fp64 (<= 5e-6)."""
    import scipy.fft as sfft
    rows = {k: {"checked": 0, "worst": 0.0, "worst_numpy": 0.0}
            for k in ("fft_twofactor", "fft_lines", "fft_conv", "fft_dct23",
                      "fft_dct4", "fft_r2c_pair")}

    def record(name, err, e_np, what):
        assert err <= KERNEL_TOL and e_np <= NUMPY_TOL, (name, what, err,
                                                         e_np)
        r = rows[name]
        r["checked"] += 1
        r["worst"] = max(r["worst"], err)
        r["worst_numpy"] = max(r["worst_numpy"], e_np)

    for p in PRIMES:
        for n in (p, 2 * p, 16 * p):
            planes = tuple(torch.from_numpy(a).to(dev)
                           for a in _host_planes((5, n), n))
            xc = _cplx2(*planes)
            if ck.twofactor_supports(n):
                for inverse in (False, True):
                    got = ck.fft_twofactor(*planes, inverse, 1.0)
                    ref = np.fft.ifft(xc) * n if inverse else np.fft.fft(xc)
                    record("fft_twofactor", _rel(torch.complex(*got),
                           torch.complex(*ck.fft_twofactor_plain(
                               *planes, inverse, 1.0))),
                           _numpy_rel(_cplx2(*got), ref), (n, inverse))
            if n == 16 * p or not ck.kernel_supports(n):
                continue
            got = ck.fft_lines(*planes, True, 1.0 / n)
            record("fft_lines", _rel(torch.complex(*got), torch.complex(
                *ck.fft_lines_plain(*planes, True, 1.0 / n))),
                _numpy_rel(_cplx2(*got), np.fft.ifft(xc)), n)
            spec = torch.from_numpy(np.stack(_host_planes((n,), p), -1)).to(
                dev)
            got = ck.fft_conv(*planes, spec, scale=1.0 / n)
            record("fft_conv", _rel(torch.complex(*got), torch.complex(
                *ck.fft_conv_plain(*planes, spec, None, scale=1.0 / n))),
                _numpy_rel(_cplx2(*got), _conv_mode_numpy(
                    xc, _cplx2(spec[:, 0], spec[:, 1]), False, 1.0 / n,
                    False, False)), n)
            x = planes[0]
            for name, supports, types in (("fft_dct23", ck.dct23_supports,
                                           (2, 3)),
                                          ("fft_dct4", ck.dct4_supports,
                                           (4,))):
                if not supports(n):
                    continue
                for t in types:
                    call = {2: ck.fft_dct2, 3: ck.fft_dct3, 4: ck.fft_dct4}[t]
                    got = call(x, False, 0.5)
                    want = (ck.fft_dct4_plain(x, False, 0.5) if t == 4 else
                            ck.fft_dct23_plain(x, t == 3, False, 0.5))
                    record(name, _rel(got, want), _numpy_rel(
                        _host(got), sfft.dct(_host(x), type=t) * 0.5), (n, t))
        if ck.r2c_pair_cluster(p, 2 * p):
            x = torch.from_numpy(_host_planes((3, p, 2 * p), p)[0]).to(dev)
            got = ck.fft_r2c_pair(x)
            record("fft_r2c_pair", _rel(torch.complex(*got), torch.complex(
                *ck.fft_r2c_pair_plain(x))), _numpy_rel(
                _cplx2(*got), np.fft.rfft2(_host(x))), (p, 2 * p))
    _log(f"[conv kernels] primes 11..127 on the walk: {rows}")
    return {"generic_primes": rows}


def phase_conv_routes(vt, dev) -> dict:
    """ConvolutionApplication over small shapes of every fusion mode, each
    flag and the composition (kernel batches, coordinate features, N-D
    matrix kernels, a Rader axis, zero-padded linear convolution) on the
    card, against numpy fp64 (<= 5e-6 of max|ref|); the input left
    unchanged; fftconvolve."""
    rows, worst = [], 0.0
    for i, (shape, flags) in enumerate(CONV_ROUTES):
        cfg = vt.FFTConfig(shape=shape, convolution=True, **flags)
        kshape, xshape = _conv_shapes(cfg, 2)
        rng = np.random.default_rng(700 + i)
        h = (rng.standard_normal(kshape)
             + 1j * rng.standard_normal(kshape)).astype(np.complex64)
        x = (rng.standard_normal(xshape)
             + 1j * rng.standard_normal(xshape)).astype(np.complex64)
        app = vt.ConvolutionApplication(cfg, h, device=dev)
        p = vt.from_complex(torch.from_numpy(x).to(dev))
        keep = p.re.clone()
        got = _cplx(app(p))
        assert torch.equal(p.re, keep), (shape, flags)
        rel = _numpy_rel(got, _conv_oracle(cfg, x, h))
        assert rel <= NUMPY_TOL, (shape, flags, app.fusion_mode, rel)
        worst = max(worst, rel)
        rows.append({"shape": list(shape), "flags": str(flags),
                     "mode": app.fusion_mode, "rel_err_vs_numpy": rel})
    x = np.random.default_rng(799).standard_normal((3, 48, 64)) + 0j
    h = np.random.default_rng(798).standard_normal((48, 64)) + 0j
    got = vt.fftconvolve(x, h, device=dev)
    rel = _numpy_rel(got, np.fft.ifft2(np.fft.fft2(x) * np.fft.fft2(h)))
    assert isinstance(got, np.ndarray) and rel <= NUMPY_TOL, rel
    modes = sorted({str(r["mode"]) for r in rows})
    _log(f"[conv routes] {len(rows)} configs, modes {modes}, worst vs numpy "
         f"{worst:.3e}; fftconvolve {rel:.3e}")
    return {"rows": rows, "worst_rel_vs_numpy": worst,
            "fftconvolve_rel": rel}


def _conv_paths(vt, dev, names=None):
    """(row, app, data, launches it must make, kernel host array) of each
    main-path convolution row (of those ``names`` only, where given);
    kernels and data made on the card from their seeds, each kernel
    transformed by the app at construction."""
    for i, (name, shape, flags, mode, want) in enumerate(CONV_ROWS):
        if names is not None and name not in names:
            continue
        cfg = vt.FFTConfig(shape=shape, convolution=True, **flags)
        batch = CONV_BYTES // (8 * cfg.matrix_convolution * math.prod(shape))
        kshape, xshape = _conv_shapes(cfg, batch)
        h = vt.Planar(*_planes(kshape, 600 + i, dev))
        app = vt.ConvolutionApplication(cfg, h, device=dev)
        assert app.fusion_mode == mode, (name, app.fusion_mode, mode)
        x = vt.Planar(*_planes(xshape, 650 + i, dev))
        yield name, cfg, app, x, want, h


def phase_conv_main_path(vt, ck, torch_engine, dev) -> dict:
    """The convolution rows through ConvolutionApplication, each with the
    counts set to 0 just before it and read just after, held to its exact
    launches and no plain-engine call; two items at seeded positions of the
    batch against numpy fp64, the input left unchanged."""
    rows, by_path = [], {}
    for name, cfg, app, x, want, h in _conv_paths(vt, dev):
        pick = sorted(np.random.default_rng(len(name)).choice(
            x.shape[0], 2, replace=False).tolist())
        keep = x.re[pick].clone()
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        y = app(x)
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_path[f"conv_{name}"] = got
        _log(f"[main conv] {name}: mode {app.fusion_mode}, launches {got}, "
             f"plain engine calls {torch_engine.calls}")
        assert got == {k: want.get(k, 0) for k in got}, (name, got, want)
        assert torch_engine.calls == 0, (name, torch_engine.calls)
        ref = _conv_oracle(cfg, _cplx2(x.re[pick], x.im[pick]), _cplx(h))
        row = {"row": name, "shape": list(x.shape), "mode": app.fusion_mode,
               "items_checked": pick,
               "rel_err_vs_numpy": _numpy_rel(
                   _cplx2(y.re[pick], y.im[pick]), ref),
               "finite": _finite(y)}
        _log(f"[main conv] {row}")
        assert row["finite"] and y.shape == x.shape, row
        assert row["rel_err_vs_numpy"] <= NUMPY_TOL, row
        assert torch.equal(x.re[pick], keep), name
        rows.append(row)
        del x, y, h, app
    launches = {k: sum(c[k] for c in by_path.values()) for k in ck.launches}
    return {"launches": launches, "launches_by_path": by_path,
            "plain_engine_calls": 0, "rows": rows}


def _conv_ops(cfg, items: int) -> float:
    """Nominal operations of a convolution: per item and coordinate a
    forward and an inverse DFT of the transform (5 N log2 N), and per
    frequency the m x m complex multiply-add (8 m^2 flops, 6 for m = 1)."""
    N = math.prod(cfg.shape)
    m = cfg.matrix_convolution
    mult = 6.0 if m == 1 else 8.0 * m * m
    return items * (2 * m * 5.0 * N * math.log2(N) + mult * N)


def phase_conv_times(vt, ck, dev) -> dict:
    """The new modes of fft_conv and fft_conv_pair at the main path's
    shapes (each held against its plain version there) and the rows'
    calls: ms, GB/s of the function's bytes (the data read once and
    written once, 16 B a point, and the spectrum once), the bound, and the
    torch.fft composition of the same function as a yardstick (fftn, the
    multiply or einsum, ifftn: three library calls and more, not one)."""
    _log(f"[time] card: {_smi()}")
    kernels = {k: [] for k in CONV_KERNELS}

    def kernel_row(name, what, shape, L, run, plain, cfg, items):
        xr, xi = _planes(shape, 800 + len(kernels[name]), dev)
        spec = torch.randn((L, 2), generator=torch.Generator(
            device=dev).manual_seed(850 + len(kernels[name])), device=dev)
        err = _errors(run(xr, xi, spec), plain(xr, xi, spec), (name, what))
        nbytes = 16.0 * xr.numel() + 8.0 * L
        bound, by = _bound(nbytes, _conv_ops(cfg, items))
        row = {"mode": what, "shape": list(shape), "spectrum_points": L,
               "ms": _time_ms(lambda: run(xr, xi, spec)), "bound_ms": bound,
               "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(lambda: plain(xr, xi, spec), reps=5,
                                    inner=1, warmup=1),
               "library_ms": None}
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] {name} {row}")
        kernels[name].append(row)
        del xr, xi, spec

    cfg = vt.FFTConfig
    kernel_row("fft_conv", "scalar", (4096, 4096), 4096,
               lambda r, i, s: ck.fft_conv(r, i, s, scale=1 / 4096),
               lambda r, i, s: ck.fft_conv_plain(r, i, s, scale=1 / 4096),
               cfg(shape=(4096,), convolution=True), 4096)
    kernel_row("fft_conv", "matrix 3", (5461, 3, 1024), 9 * 1024,
               lambda r, i, s: ck.fft_conv(r, i, s),
               lambda r, i, s: ck.fft_conv_plain(r, i, s),
               cfg(shape=(1024,), convolution=True, matrix_convolution=3,
                   coordinate_features=3), 5461)
    kernel_row("fft_conv", "rows 512", (32768, 512), 512 * 512,
               lambda r, i, s: ck.fft_conv(r, i, s),
               lambda r, i, s: ck.fft_conv_plain(r, i, s),
               cfg(shape=(512,), convolution=True), 32768)
    for hp in (1, 32):
        kernel_row("fft_conv_pair", f"2-D hp={hp}", (256, 256, 256),
                   hp * 256 * 256,
                   lambda r, i, s: ck.fft_conv_pair(r, i, s, scale=2 ** -16),
                   lambda r, i, s: ck.fft_conv_pair_plain(r, i, s,
                                                          scale=2 ** -16),
                   cfg(shape=(256, 256), convolution=True), 256)

    # the walk kernels' own numbers on their rows: registers, spills,
    # split, layout and resident blocks an SM (the 2-D mode: clusters too)
    regs, st, ld = _ptxas_of(ck, "fft_conv")["fft_conv_kernel"]
    for row, (m, mm) in zip(kernels["fft_conv"], ((4096, 1), (1024, 3),
                                                  (512, 1))):
        row.update({"registers": regs, "spill_bytes": [st, ld],
                    "split": list(ck.conv_split(m, mm)),
                    "layout": list(ck.conv_layout(m, mm)),
                    "blocks_per_sm": ck.conv_occupancy(m, mm)})
    regs, st, ld = _ptxas_of(ck, "fft_conv_pair")["fft_conv2d_kernel"]
    for row in kernels["fft_conv_pair"]:
        row.update({"registers": regs, "spill_bytes": [st, ld],
                    "layout": list(ck.conv2d_layout(256, 256)),
                    "clusters_blocks": list(ck.conv2d_occupancy(256, 256))})
    sweep = _conv_sweep(ck, dev)
    sweep2d = _conv2d_sweep(ck, dev)

    e2e = []
    for name, cfg_, app, x, want, h in _conv_paths(vt, dev):
        ndim = len(cfg_.shape)
        dims = tuple(range(-ndim, 0))
        m = cfg_.matrix_convolution
        items = x.re.numel() // math.prod(cfg_.shape) // m
        H = torch.fft.fftn(torch.complex(h.re, h.im), dim=dims)
        xc = torch.complex(x.re, x.im)
        mask = None
        if cfg_.zeropad_input is not None:
            mask = vt.api.apply_zeropad(
                vt.Planar(torch.ones(cfg_.shape, device=dev),
                          torch.zeros(cfg_.shape, device=dev)),
                cfg_.zeropad_input, ndim).re

        def library(xc=xc, H=H, mask=mask, m=m, dims=dims):
            X = torch.fft.fftn(xc if mask is None else xc * mask, dim=dims)
            Y = (torch.einsum("oi...,bi...->bo...", H, X) if m > 1
                 else X * H)
            return torch.fft.ifftn(Y, dim=dims)

        spec_points = h.re.numel()
        nbytes = 16.0 * x.re.numel() + 8.0 * spec_points
        bound, by = _bound(nbytes, _conv_ops(cfg_, items))
        ms = _time_ms(lambda: app(x))
        row = {"row": name, "shape": list(x.shape), "mode": app.fusion_mode,
               "launches": sum(want.values()), "ms": ms,
               "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
               "torch_fft_composition_ms": _time_ms(library)}
        row["vs_torch_fft"] = row["torch_fft_composition_ms"] / ms
        _log(f"[time] e2e {row}")
        e2e.append(row)
        del x, h, app, H, xc
    return {"kernels": kernels, "e2e": e2e, "conv_layout_sweep": sweep,
            "conv2d_layout_sweep": sweep2d}


def _ptxas_of(ck, name: str) -> dict:
    """{kernel: (registers, spill stores, spill loads)} of a built
    library's ptxas log."""
    with open(ck.library_path(name)[:-3] + ".log") as f:
        return {k: (r, st, ld) for k, r, st, ld in _ptxas_kernels(f.read())}


def phase_walk_times(ck, dev) -> dict:
    """The kernels whose stages the walk's generic stage and the conv
    redesign changed, at the rows PERF.md compares (each against its plain
    version there): fft_conv's Rader 5003 (1676 x 5002), scalar 4096 x
    4096, matrix 3 5461 x 3 x 1024 and rows 512 32768 x 512;
    fft_conv_inv 1059 x 7918 with the x0 term; fft_twofactor's swapped
    forward at 1059 x 7918; fft_dct23 II / III and odd fft_dct4 at 131586
    x 255; fft_lines at 1001 (7 * 11 * 13) beside 1024, 128 MB each; the
    real 208^3 cube through fft_r2c_pair (its instantiation with the
    generic stage); fft_strided_tw's twiddled passes at 16 x 512 x 2048,
    fft_dct1 at 32736 x 1025 (DCT-I) and 32800 x 1023 (DST-I),
    fft_conv_pair's 2-D mode at 256 x 256^2 (hp = 1 and 32) and sample
    52's and the per-slice 32 x 256^2 calls, and the long round trips of
    LONG_E2E.  Each row with the kernel's registers
    and spills, its layout and resident blocks an SM where the package
    names them, so the same phase times an older package's kernels too."""
    _log(f"[time] card: {_smi()}")
    rows = []

    def row_of(name, kernel, what, shape, fn, plain, nbytes, ops, library,
               layout=None):
        got, want = fn(), plain()
        if isinstance(got, torch.Tensor):   # a real transform's output
            got, want = ((t, torch.zeros_like(t)) for t in (got, want))
        err = _errors(got, want, (name, what))
        bound, by = _bound(nbytes, ops)
        regs = _ptxas_of(ck, name).get(kernel)
        row = {"kernel": name, "what": what, "shape": list(shape),
               "ms": _time_ms(fn), "bound_ms": bound, "bound_by": by,
               "max_abs_err": err,
               "plain_ms": _time_ms(plain, reps=5, inner=1, warmup=1),
               "library_ms": library and _time_ms(library),
               "registers": regs and regs[0],
               "spill_bytes": regs and list(regs[1:])}
        if layout is not None:
            try:
                row["layout"] = layout()
            except AttributeError:   # a package without that rule
                pass
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] walk {row}")
        rows.append(row)

    def conv_layout(m, mm):
        return lambda: {"split": list(ck.conv_split(m, mm)),
                        "layout": list(ck.conv_layout(m, mm)),
                        "blocks_per_sm": ck.conv_occupancy(m, mm)}

    # fft_conv: sample 7's Rader 5003, then the conv rows
    B = 2 * _sample_7_batch(10006)
    xr, xi = _planes((B, 5002), 31, dev)
    spec = ck.rader_spectrum(5003, 1.0, dev)
    xc = torch.complex(xr, xi)
    sc = torch.complex(spec[:, 0].contiguous(), spec[:, 1].contiguous())
    row_of("fft_conv", "fft_conv_kernel", "rader 5003", (B, 5002),
           lambda: ck.fft_conv(xr, xi, spec),
           lambda: ck.fft_conv_plain(xr, xi, spec),
           16.0 * B * 5002 + 8.0 * 5002,
           B * (2 * _fft_ops(5002, 5002) + _cmul_ops(5002)),
           lambda: torch.fft.ifft(torch.fft.fft(xc) * sc, norm="forward"),
           conv_layout(5002, 1))
    del xr, xi, xc
    for what, shape, L, mm, scale in (
            ("scalar 4096", (4096, 4096), 4096, 1, 1 / 4096),
            ("matrix 3", (5461, 3, 1024), 9 * 1024, 3, 1.0),
            ("rows 512", (32768, 512), 512 * 512, 1, 1.0)):
        m = shape[-1]
        xr, xi = _planes(shape, 800 + m, dev)
        spec = torch.randn((L, 2), generator=torch.Generator(
            device=dev).manual_seed(850 + m), device=dev)
        items = xr.numel() // (mm * m)
        row_of("fft_conv", "fft_conv_kernel", what, shape,
               lambda: ck.fft_conv(xr, xi, spec, scale=scale),
               lambda: ck.fft_conv_plain(xr, xi, spec, scale=scale),
               16.0 * xr.numel() + 8.0 * L,
               items * (2 * mm * _fft_ops(m, m) + (6.0 if mm == 1 else
                                                   8.0 * mm * mm) * m),
               None, conv_layout(m, mm))
        del xr, xi, spec
    # fft_conv_inv and fft_twofactor at sample 7's 7919 (1059 x 7918)
    B, m = _sample_7_batch(7919), 7918
    xr, xi = _planes((B, m), 37, dev)
    dc = tuple(t.contiguous() for t in _planes((B,), 38, dev))
    spec = ck.rader_spectrum(7919, 1.0, dev, "swapped")
    tf_layout = lambda: {"split": list(ck.twofactor_split(m)),
                         "layout": list(ck.twofactor_layout(m))}
    row_of("fft_conv_inv", "fft_conv_inv_kernel", "rader 7919, dc", (B, m),
           lambda: ck.fft_conv_inv(xr, xi, spec, dc),
           lambda: ck.fft_conv_inv_plain(xr, xi, spec, dc),
           16.0 * B * m + 8.0 * m + 8.0 * B,
           B * (_fft_ops(m, m) + _cmul_ops(2 * m) + 2 * m), None, tf_layout)
    xc = torch.complex(xr, xi)
    row_of("fft_twofactor", "fft_twofactor_kernel", "7918 swapped forward",
           (B, m), lambda: ck.fft_twofactor(xr, xi, False, 1.0, True),
           lambda: ck.fft_twofactor_plain(xr, xi, False, 1.0, True),
           16.0 * B * m + 8.0 * m, B * (_fft_ops(m, m) + _cmul_ops(m)),
           lambda: torch.fft.fft(xc), tf_layout)
    del xr, xi, xc, dc
    # the DCT kernels at sample 100's 255 = 3 * 5 * 17
    n = 255
    B = TARGET_BYTES // (4 * n)
    x = torch.from_numpy(_host_planes((B, n), n)[0]).to(dev)
    for name, kernel, what, fn, plain in (
            ("fft_dct23", "dct2_kernel", "DCT-II 255",
             lambda: ck.fft_dct2(x), lambda: ck.fft_dct23_plain(x, False)),
            ("fft_dct23", "dct3_kernel", "DCT-III 255",
             lambda: ck.fft_dct3(x), lambda: ck.fft_dct23_plain(x, True)),
            ("fft_dct4", "dct4_odd_kernel", "DCT-IV 255 (odd)",
             lambda: ck.fft_dct4(x), lambda: ck.fft_dct4_plain(x))):
        row_of(name, kernel, what, (B, n), fn, plain, 8.0 * B * n,
               _fft_ops(B * n, n), None)
    del x
    # fft_lines: 1001 = 7 * 11 * 13 (two generic stages) beside 1024
    for n in (1001, 1024):
        B = TARGET_BYTES // (8 * n)
        xr, xi = _planes((B, n), n, dev)
        xc = torch.complex(xr, xi)
        row_of("fft_lines", "fft_lines_kernel", f"n = {n}", (B, n),
               lambda: ck.fft_lines(xr, xi), lambda: ck.fft_lines_plain(
                   xr, xi, False), 16.0 * B * n, _fft_ops(B * n, n),
               lambda: torch.fft.fft(xc),
               lambda: {"split": list(ck.lines_split(n)),
                        "layout": list(ck.lines_layout(n))})
        del xr, xi, xc
    # fft_r2c_pair on the real 208^3 cube (208 = 16 * 13)
    ny = nz = GENERIC_CUBE[-1]
    cube = torch.from_numpy(_host_planes(GENERIC_CUBE, 208)[0]).to(dev)
    nb = GENERIC_CUBE[0] * ny * (nz // 2 + 1)
    row_of("fft_r2c_pair", "r2c_pair_kernel<1>", "208^3 forward",
           GENERIC_CUBE, lambda: ck.fft_r2c_pair(cube),
           lambda: ck.fft_r2c_pair_plain(cube),
           4.0 * cube.numel() + 8.0 * nb,
           _fft_ops(cube.numel(), ny * nz) / 2,
           lambda: torch.fft.rfft2(cube),
           lambda: {"layout": list(ck.r2c_pair_layout(ny, nz))})
    del cube
    # fft_strided_tw at the 2^20 row's pass (16 x 512 x 2048), the twiddle
    # on the write and after the read, and fft_dct1 at the DCT-I 1025 /
    # DST-I 1023 rows (PERF.md rows 3 and 14)
    B, nc, ns = LONG_ROW_LINES, 512, 2048
    xr, xi = _planes((B, nc, ns), 901, dev)
    for inverse in (False, True):
        kw = (dict(pre=ck.twiddle(LONG_ROW_N, True)) if inverse
              else dict(post=ck.twiddle(LONG_ROW_N)))
        scale = 1.0 / LONG_ROW_N if inverse else 1.0
        row_of("fft_strided_tw", "fft_strided_tw_kernel",
               "inverse, twiddle after the read" if inverse
               else "forward, twiddle on the write", (B, nc, ns),
               lambda: ck.fft_strided(xr, xi, inverse, scale, **kw),
               lambda: ck.fft_strided_plain(xr, xi, inverse, scale, **kw),
               16.0 * B * nc * ns,
               _fft_ops(B * nc * ns, nc) + _cmul_ops(B * nc * ns), None,
               lambda: {"layout": list(ck.strided_tw_layout(nc, ns)),
                        "blocks_per_sm": ck.strided_tw_occupancy(nc, ns)})
    del xr, xi
    for dst, n in ((False, 1025), (True, 1023)):
        B = TARGET_BYTES // (4 * n)
        x = _planes((B, n), n + 7, dev)[0]
        row_of("fft_dct1", "dct1_kernel", f"{'DST' if dst else 'DCT'}-I {n}",
               (B, n), lambda: ck.fft_dct1(x, dst, 1.0),
               lambda: ck.fft_dct1_plain(x, dst, 1.0), 8.0 * B * n,
               _fft_ops(B * n, n), None,
               lambda: {"layout": list(ck.dct1_layout(n, dst)),
                        "blocks_per_sm": ck.dct1_occupancy(n, dst)})
        del x
    # fft_conv_pair's 2-D mode at 256 planes of 256 x 256 (PERF.md row
    # 10), a shared spectrum and hp = 32, the torch.fft composition beside
    # it; the layout and resident clusters and blocks an SM where the
    # package names them
    xr, xi = _planes((256, 256, 256), 880, dev)
    xc = torch.complex(xr, xi)
    for hp in (1, 32):
        spec = torch.randn((hp * 65536, 2), generator=torch.Generator(
            device=dev).manual_seed(882 + hp), device=dev)
        # plane b times spectrum b % hp, broadcast over the groups of hp
        H = torch.complex(spec[:, 0], spec[:, 1]).reshape(hp, 256, 256)
        row_of("fft_conv_pair", "fft_conv2d_kernel", f"2-D hp={hp}",
               (256, 256, 256),
               lambda: ck.fft_conv_pair(xr, xi, spec, scale=2 ** -16),
               lambda: ck.fft_conv_pair_plain(xr, xi, spec, scale=2 ** -16),
               16.0 * xr.numel() + 8.0 * hp * 65536,
               256 * (2 * _fft_ops(65536, 65536) + _cmul_ops(65536)),
               lambda: torch.fft.ifft2(torch.fft.fft2(xc).view(
                   256 // hp, hp, 256, 256) * H),
               lambda: {"layout": list(ck.conv2d_layout(256, 256)),
                        "clusters_blocks": list(
                            ck.conv2d_occupancy(256, 256))})
        del spec, H
    del xr, xi, xc
    # sample 52's and the per-slice 3-D row's calls through
    # ConvolutionApplication (PERF.md section 5), the composition beside
    import vkfft_tpu_torch as vt
    conv_calls = []
    for name, cfg, app, x, want, h in _conv_paths(
            vt, dev, ("sample52_256x256", "per_slice_32x256x256")):
        dims = tuple(range(-len(cfg.shape), 0))
        H = torch.fft.fftn(torch.complex(h.re, h.im), dim=dims)
        xc = torch.complex(x.re, x.im)
        row = {"row": name, "shape": list(x.shape), "mode": app.fusion_mode,
               "ms": _time_ms(lambda: app(x)),
               "torch_fft_composition_ms": _time_ms(
                   lambda: torch.fft.ifftn(torch.fft.fftn(xc, dim=dims) * H,
                                           dim=dims))}
        row["vs_torch_fft"] = row["torch_fft_composition_ms"] / row["ms"]
        _log(f"[time] walk {row}")
        conv_calls.append(row)
        del x, h, app, H, xc
    # the long tier's round trips through FFTApplication
    rounds = []
    for n, B in LONG_E2E:
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True))
        x = vt.Planar(*_planes((B, n), n + 5, dev))
        row = {"row": f"long_n{n}", "shape": [B, n],
               "ms": _time_ms(lambda: app.inverse(app.forward(x)))}
        _log(f"[time] walk {row}")
        rounds.append(row)
        del x
    return {"rows": rows, "conv_calls": conv_calls, "long_round_trips": rounds}


# fft_conv's layout sweep (conv_times): (block points, points a thread in
# one pass, in two factors) in turn at each main-path shape, the rule's
# own (8192, 16, 32) among them
CONV_SWEEP = ((2048, 16, 32), (4096, 16, 32), (8192, 16, 32),
              (4096, 8, 16), (4096, 32, 32), (8192, 32, 32))


class _conv_layout_forced:
    """fft_conv's layout rule with other block constants (CONV_SWEEP)."""

    def __init__(self, ck, consts):
        self.ck, self.consts = ck, consts

    def __enter__(self):
        ck = self.ck
        self.saved = (ck.CONV_BLOCK_POINTS, ck.CONV_ONE_PASS_AIM,
                      ck.CONV_AIM_POINTS)
        (ck.CONV_BLOCK_POINTS, ck.CONV_ONE_PASS_AIM,
         ck.CONV_AIM_POINTS) = self.consts

    def __exit__(self, *exc):
        (self.ck.CONV_BLOCK_POINTS, self.ck.CONV_ONE_PASS_AIM,
         self.ck.CONV_AIM_POINTS) = self.saved


def _conv_sweep(ck, dev) -> list:
    """fft_conv at its main-path shapes under each CONV_SWEEP layout, timed
    in turns (down the list, then up), each against the plain version
    first: the Rader 5003 row, v3_1d's 4096 x 4096, sample 50's 5461 x 3 x
    1024 and v3_rows' 32768 x 512."""
    rows = []
    shapes = (("rader 5003", (2 * _sample_7_batch(10006), 5002), 5002, 1),
              ("scalar 4096", (4096, 4096), 4096, 1),
              ("matrix 3", (5461, 3, 1024), 9 * 1024, 3),
              ("rows 512", (32768, 512), 512 * 512, 1))
    for what, shape, L, mm in shapes:
        m = shape[-1]
        xr, xi = _planes(shape, 870 + m, dev)
        spec = (ck.rader_spectrum(5003, 1.0, dev) if m == 5002 else
                torch.randn((L, 2), generator=torch.Generator(
                    device=dev).manual_seed(871), device=dev))
        plain = ck.fft_conv_plain(xr, xi, spec)
        by = {}
        for consts in CONV_SWEEP + CONV_SWEEP[::-1]:
            with _conv_layout_forced(ck, consts):
                fn = lambda: ck.fft_conv(xr, xi, spec)
                row = by.setdefault(consts, {
                    "shape": list(shape), "mode": what,
                    "block_points": consts[0], "aims": list(consts[1:]),
                    "split": list(ck.conv_split(m, mm)),
                    "layout": list(ck.conv_layout(m, mm)),
                    "blocks_per_sm": ck.conv_occupancy(m, mm),
                    "max_abs_err": _errors(fn(), plain, (what, consts)),
                    "ms": []})
                row["ms"].append(_time_ms(fn))
        for row in by.values():
            _log(f"[time] fft_conv layout sweep {row}")
        rows += list(by.values())
        del xr, xi, plain
    return rows


# fft_conv_pair's 2-D layout sweep (conv_times): (tile points, points a
# thread) of `_plane_layout` at 256 x 256, clusters of 16, 8 and 4 blocks
# at 256 to 1024 threads, the rule's own (4096, 16) among them
CONV2D_SWEEP = ((4096, 16), (8192, 16), (16384, 16), (4096, 8), (8192, 8))


def _conv2d_sweep(ck, dev) -> list:
    """fft_conv_pair's 2-D mode at 256 planes of 256 x 256 under each
    CONV2D_SWEEP layout, timed in turns (down the list, then up), each
    against the plain version first."""
    xr, xi = _planes((256, 256, 256), 880, dev)
    spec = torch.randn((256 * 256, 2), generator=torch.Generator(
        device=dev).manual_seed(881), device=dev)
    plain = ck.fft_conv_pair_plain(xr, xi, spec, scale=2 ** -16)
    by = {}
    for tile, aim in CONV2D_SWEEP + CONV2D_SWEEP[::-1]:
        with _pair_layout_forced(ck, {"tile_points": tile, "aim": aim}):
            fn = lambda: ck.fft_conv_pair(xr, xi, spec, scale=2 ** -16)
            row = by.setdefault((tile, aim), {
                "shape": [256, 256, 256], "tile_points": tile, "aim": aim,
                "layout": list(ck.conv2d_layout(256, 256)[:3]),
                "clusters_blocks": list(ck.conv2d_occupancy(256, 256)),
                "max_abs_err": _errors(fn(), plain, ("2-D", tile, aim)),
                "ms": []})
            row["ms"].append(_time_ms(fn))
    for row in by.values():
        _log(f"[time] fft_conv_pair 2-D layout sweep {row}")
    return list(by.values())


# ---------------------------------------------------------------------------
# The long tier: DIRECT beyond 16384 in two and three uploads, the long
# Bluestein, on the factor mode of fft_strided (fft_strided_tw).
# ---------------------------------------------------------------------------

LONG_KERNELS = ("fft_strided_tw",)
SAMPLE_11_LONG = (1 << 17, 1 << 20, 1 << 22, 1 << 24, 1 << 26)  # cli.py:272
LONG_ROW_N = 1 << 20             # the 2^20 row: 16 lines, 128 MiB of planes
LONG_ROW_LINES = TARGET_BYTES // (8 * LONG_ROW_N)
LONG_BLUESTEIN_N = 65537         # m = 131712, the fused long Bluestein


def _long_factor_cases(ck):
    """(what, plane shape (P, n, S) or (P, L, (n, S)), inverse, scale,
    options) of the factor mode: every factor form of the long tier, both
    directions, live lengths that are not multiples of S, primes above 64,
    the largest n and odd S."""
    twid = ck.twiddle
    na, nb, ns = 64, 128, 128
    out = [
        ("two-upload fwd", (16, 512, 2048), False, 1.0,
         dict(post=twid(1 << 20))),
        ("two-upload inv", (16, 512, 2048), True, 2.0 ** -20,
         dict(pre=twid(1 << 20, True))),
        ("three pass 1 fwd", (2, na, nb * ns), False, 1.0,
         dict(post=twid(na * nb, sd=ns))),
        ("three pass 1 inv", (2, na, nb * ns), True, 0.5,
         dict(pre=twid(na * nb, True, sd=ns))),
        ("three pass 2 fwd", (2 * na, nb, ns), False, 1.0,
         dict(post=twid(na * nb * ns, a=na, pm=na, b=1),
              out_interleave=na)),
        ("three pass 2 inv", (2 * na, nb, ns), True, 1.0,
         dict(pre=twid(na * nb * ns, True, a=na, pm=na, b=1),
              in_interleave=na)),
        ("n=8192", (1, 8192, 96), False, 1.0, dict(post=twid(8192 * 96))),
        ("primes 127, 101", (3, 127 * 2, 101), True, 1.0,
         dict(pre=twid(254 * 101, True))),
        ("odd S", (5, 96, 77), False, 1.0, dict(post=twid(96 * 77))),
        # the folded natural order: two uploads' first pass stored
        # transposed and its inverse read so; three uploads' first pass
        # likewise, its second over the (js, ka) columns, its third
        # interleaved
        ("fold two-upload fwd", (16, 512, 2048), False, 1.0,
         dict(post=twid(1 << 20), out_transposed=True)),
        ("fold two-upload inv", (16, 2048, 512), True, 2.0 ** -20,
         dict(pre=twid(1 << 20, True), in_transposed=True)),
        ("fold three pass 1 fwd", (2, na, nb * ns), False, 1.0,
         dict(post=twid(na * nb, sd=ns), out_transposed=True)),
        ("fold three pass 1 inv", (2, nb * ns, na), True, 0.5,
         dict(pre=twid(na * nb, True, sd=ns), in_transposed=True)),
        ("fold three pass 2 fwd", (2, nb, ns * na), False, 1.0,
         dict(post=twid(na * nb * ns, a=na, sd=na, sm=na))),
        ("fold three pass 2 inv", (2, nb, ns * na), True, 1.0,
         dict(pre=twid(na * nb * ns, True, a=na, sd=na, sm=na))),
        ("fold three pass 3 fwd", (2 * nb, ns, na), False, 0.25,
         dict(out_interleave=nb)),
        ("fold three pass 3 inv", (2 * nb, ns, na), True, 1.0,
         dict(in_interleave=nb)),
        ("transposed, primes 127, 101, odd S", (3, 77, 254), True, 1.0,
         dict(pre=twid(254 * 77, True), in_transposed=True)),
        ("transposed n=8192", (1, 8192, 40), False, 1.0,
         dict(post=twid(8192 * 40), out_transposed=True)),
    ]
    # the long Bluestein's two passes at sample 14's 32771 and 65537, at
    # 99991 and at a small plane whose live rows end mid-row
    for n, inverse, m in ((32771, False, 66560), (65537, True, 131712),
                          (99991, False, 1 << 18), (3001, True, 64 * 128)):
        plane = ck.bluestein_long_split(m) if n > 16384 else (64, 128)
        out.append((f"bluestein n={n} read", (3, n, plane), False, 1.0,
                    dict(pre=ck.chirp(n, inverse), post=twid(m))))
        out.append((f"bluestein n={n} write", (3, m, plane), True, 1.0 / 3,
                    dict(pre=twid(m, True), post=ck.chirp(n, inverse),
                         out_len=n)))
    return out


def _factor_numpy(ck, f, P, n, S):
    """The factor's definition in numpy fp64 on (P, n, S)."""
    p = np.arange(P)[:, None, None]
    row = np.arange(n)[None, :, None]
    s = np.arange(S)[None, None, :]
    if f.kind == "chirp":
        e = (row * S + s) ** 2 % f.N
    else:
        e = (row * f.a + p % f.pm * f.b + s % f.sm) * (s // f.sd) % f.N
    return np.exp((2j if f.inverse else -2j) * np.pi * e / f.N)


def phase_long_kernels_vs_plain(ck, dev) -> dict:
    """fft_strided_tw, the factor mode of fft_strided, against its plain
    version (<= 1e-5 of max|ref|) on every case of `_long_factor_cases`,
    and against its definition in numpy fp64 (<= 5e-6) on the smaller."""
    t0 = time.perf_counter()
    cases = []
    for what, shape, inverse, scale, kw in _long_factor_cases(ck):
        if len(shape) == 3 and isinstance(shape[2], tuple):
            P, L, plane = shape
            xr, xi = _planes((P, L), L, dev)
            kw = dict(kw, plane=plane)
            n, S = plane
        else:
            xr, xi = _planes(shape, sum(shape), dev)
            P, n, S = shape
            if kw.get("in_transposed"):
                n, S = S, n
        got = ck.fft_strided(xr, xi, inverse, scale, **kw)
        plain = ck.fft_strided_plain(xr, xi, inverse, scale, **kw)
        err = _rel(torch.complex(*got), torch.complex(*plain))
        row = {"case": what, "shape": list(xr.shape),
               "out_shape": list(got[0].shape), "rel_err_vs_plain": err}
        assert err <= KERNEL_TOL, row
        if P * n * S <= 1 << 22:
            x = np.zeros((P, n * S), np.complex128)
            x[:, :xr.shape[1] if "plane" in kw else n * S] = _cplx2(
                xr.reshape(P, -1), xi.reshape(P, -1))
            x = (x.reshape(P, S, n).transpose(0, 2, 1)
                 if kw.get("in_transposed") else x.reshape(P, n, S))
            d = kw.get("in_interleave", 1)
            x = x.reshape(P // d, n, d, S).transpose(0, 2, 1, 3).reshape(
                P, n, S)
            if kw.get("pre") is not None:
                x = x * _factor_numpy(ck, kw["pre"], P, n, S)
            y = np.fft.ifft(x, axis=1) * n if inverse else np.fft.fft(x, axis=1)
            y = y * scale
            if kw.get("post") is not None:
                y = y * _factor_numpy(ck, kw["post"], P, n, S)
            d = kw.get("out_interleave", 1)
            y = y.reshape(P // d, d, n, S).transpose(0, 2, 1, 3)
            if kw.get("out_transposed"):
                y = y.reshape(P, n, S).transpose(0, 2, 1)
            y = y.reshape(P, -1)[:, :got[0].reshape(P, -1).shape[1]]
            row["rel_err_vs_numpy"] = _numpy_rel(
                _cplx2(got[0].reshape(P, -1), got[1].reshape(P, -1)), y)
            assert row["rel_err_vs_numpy"] <= NUMPY_TOL, row
        _log(f"[long kernels] {row}")
        cases.append(row)
        del xr, xi, got, plain
    return {"cases": cases, "seconds": time.perf_counter() - t0}


# every 97th DIRECT length of 16385..2^20 and named ones (16400, 20480),
# Bluestein 32771 (m = 66560), 65537 (m = 131712), 99991 (m = 2^18), the
# SPLIT 131 * 32768
LONG_ROUTE_LENGTHS = sorted(set(range(16385, (1 << 20) + 1, 16384 * 3 + 97))
                            | {16400, 20480, 32768, 1 << 20, 32771, 65537,
                               99991, 131 * 32768})


def phase_long_routes(vt, ce, dev) -> dict:
    """LONG_ROUTE_LENGTHS through vt.fft/vt.ifft on the card (batch 2)
    against numpy fp64, none of which may raise; rfft/irfft at 40960 and
    65542 (n/2 = 20480, 32771); a long non-minor axis; the three-upload
    route forced at 2^20 and 2^22 (cuda_engine.fft_long3_p)."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    t0 = time.perf_counter()
    cases = []

    def check(what, got, want):
        err = _numpy_rel(got, want)
        cases.append({"case": what, "rel_err": err})
        assert err <= NUMPY_TOL, (what, err)

    for n in LONG_ROUTE_LENGTHS:
        xr, xi = _host_planes((2, n), n)
        x = vt.Planar(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
        y = vt.fft(x)
        z = vt.ifft(y)
        xc = xr.astype(np.float64) + 1j * xi
        route = [(k, m) for k, _, m in ce.route(plan_axis(n))]
        check(f"fft n={n} {route}", _cplx2(y.re, y.im), np.fft.fft(xc))
        check(f"ifft(fft) n={n}", _cplx2(z.re, z.im), xc)
    for n in (40960, 65542):
        xh = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
        X = vt.rfft(torch.from_numpy(xh).to(dev))
        want = np.fft.rfft(xh.astype(np.float64))
        check(f"rfft n={n}", X.cpu().numpy(), want)
        check(f"irfft n={n}", _host(vt.irfft(X, n=n)), xh.astype(np.float64))
    shape = (20480, 3, 4)
    xr, xi = _host_planes(shape, 7)
    x = vt.Planar(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
    xc = xr.astype(np.float64) + 1j * xi
    y = vt.fftn(x, axes=(0,))
    check(f"fftn {shape} axes (0,)", _cplx2(y.re, y.im),
          np.fft.fft(xc, axis=0))
    z = vt.ifftn(y, axes=(0,))
    check(f"ifftn {shape} axes (0,)", _cplx2(z.re, z.im), xc)
    for n in (1 << 20, 1 << 22):
        xr, xi = _host_planes((1, n), n + 3)
        x = vt.Planar(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
        split = ce.ck.long_split(n, 3)
        y = ce.fft_long3_p(x, n, split=split)
        z = ce.fft_long3_p(y, n, True, 1.0 / n, split=split)
        xc = xr.astype(np.float64) + 1j * xi
        check(f"three uploads n={n} {split}", _cplx2(y.re, y.im),
              np.fft.fft(xc))
        check(f"three uploads n={n} inverse", _cplx2(z.re, z.im), xc)
    worst = max(c["rel_err"] for c in cases)
    _log(f"[long routes] {len(cases)} cases ({len(LONG_ROUTE_LENGTHS)} "
         f"lengths), worst {worst}, {time.perf_counter() - t0:.1f} s")
    return {"cases": cases, "worst": worst,
            "seconds": time.perf_counter() - t0}


LONG_LINE_MAX = 1 << 28          # one line of 2 GiB of planes


def _long_rows(ck):
    """(row, lines, n, launches of a forward and an inverse) of the long
    main path: sample 11's long systems (one line each; its 2^24 is the
    smallest power of two the port's split sends to three uploads), the
    2^20 row at 128 MiB, and one 2^28 line."""
    smallest3 = next(1 << k for k in range(15, 41)
                     if len(ck.long_split(1 << k)) == 3)
    assert smallest3 in SAMPLE_11_LONG, smallest3
    rows = [(f"sample11_n{n}", 1, n) for n in SAMPLE_11_LONG]
    rows += [(f"1d_n{LONG_ROW_N}_x{LONG_ROW_LINES}", LONG_ROW_LINES,
              LONG_ROW_N), (f"three_uploads_n{LONG_LINE_MAX}", 1,
                            LONG_LINE_MAX)]
    return [(name, B, n, LONG_LAUNCHES[n]) for name, B, n in rows]


# launches of one forward and one inverse, by length (the splits of
# cuda_kernels.long_split: to 2^23 two uploads, from 2^24 three; the
# reorder folded into a pass where cuda_kernels.long_folds holds: 2^17,
# 2^20 and every three-upload row here; 2^22's ns = 8192 keeps the
# transpose)
LONG_LAUNCHES = {
    1 << 17: {"fft_strided_tw": 2, "fft_strided": 2},
    1 << 20: {"fft_strided_tw": 2, "fft_strided": 2},
    1 << 22: {"fft_strided_tw": 2, "fft_lines": 2},
    1 << 24: {"fft_strided_tw": 6},
    1 << 26: {"fft_strided_tw": 6},
    1 << 28: {"fft_strided_tw": 6},
}


def phase_long_main_path(vt, ck, torch_engine, dev) -> dict:
    """Each long row through FFTApplication (forward, normalized inverse),
    the counts set to 0 just before it and read just after, held to its
    exact launches and no plain-engine call; the forward against numpy
    fp64 (the three-upload line against torch.fft in complex128 on the
    card, an oracle only), the round trip against the input."""
    rows, by_row = [], {}
    for name, B, n, want in _long_rows(ck):
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True))
        xr, xi = _planes((B, n), n % 997, dev)
        x = vt.Planar(xr, xi)
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        y = app.forward(x)
        z = app.inverse(y)
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_row[f"long_{name}"] = got
        _log(f"[main long] {name}: split {ck.long_split(n)}, launches {got}, "
             f"plain engine calls {torch_engine.calls}")
        assert got == {k: want.get(k, 0) for k in got}, (name, got, want)
        assert torch_engine.calls == 0, (name, torch_engine.calls)
        row = {"row": name, "shape": [B, n], "split": ck.long_split(n),
               "finite": _finite(y, z)}
        if n <= 1 << 26:
            pick = min(B, 2)
            want_f = np.fft.fft(_cplx2(xr[:pick], xi[:pick]))
            row["oracle"] = "numpy fp64"
            row["rel_err_fwd"] = _numpy_rel(_cplx2(y.re[:pick], y.im[:pick]),
                                            want_f)
            del want_f
        else:
            xc = torch.complex(xr.double(), xi.double())
            ref = torch.fft.fft(xc)
            row["oracle"] = "torch.fft complex128 on the card"
            row["rel_err_fwd"] = _rel(torch.complex(y.re.double(),
                                                    y.im.double()), ref)
            del xc, ref
        row["rel_err_round_trip"] = _rel(torch.complex(z.re, z.im),
                                         torch.complex(xr, xi))
        _log(f"[main long] {row}")
        assert row["finite"] and y.shape == x.shape and z.shape == x.shape, row
        assert row["rel_err_fwd"] <= NUMPY_TOL, row
        assert row["rel_err_round_trip"] <= NUMPY_TOL, row
        rows.append(row)
        del x, y, z, xr, xi
        torch.cuda.empty_cache()
    launches = {k: sum(c[k] for c in by_row.values()) for k in ck.launches}
    return {"launches": launches, "launches_by_path": by_row,
            "plain_engine_calls": 0, "rows": rows}


# the long round trips timed (n, lines): the 2^20 row at 128 MiB, the 2^22
# row (ns = 8192: the transpose stays), Bluestein 65537 at 64 MiB, sample
# 11's 2^24 and 2^26 lines (three uploads)
LONG_E2E = ((LONG_ROW_N, LONG_ROW_LINES), (1 << 22, TARGET_BYTES >> 25),
            (LONG_BLUESTEIN_N, SAMPLE_7_BYTES // (8 * LONG_BLUESTEIN_N)),
            (1 << 24, 1), (1 << 26, 1))


def _long_placements(ck, dev) -> dict:
    """The two placements of the folded reorder at the 2^20 row, timed in
    turns (down the list, then up; the round trips down once more) beside
    the route without the fold, forward (against torch.fft of the same
    lines, an oracle only) and forward plus inverse (against the input):
    (a) the strided pass stores its tile transposed and fft_strided runs
    the ns rows (the inverse: fft_strided, then the strided pass reading
    transposed); (b) the strided pass stores rows and the ns pass reads
    each line as a column of fft_strided_tw's transposed read, storing 8
    lines a block transposed, as the JAX package's tl stage (its memory
    pattern; the port has no such mode of fft_lines; the inverse: the ns
    pass stored transposed, then the strided pass on rows); the route
    before the fold: fft_lines on the ns lines and the transpose as a
    tensor op."""
    from vkfft_tpu_torch.pcomplex import Planar
    B, n = LONG_ROW_LINES, LONG_ROW_N
    nc, ns = ck.long_split(n)
    xr, xi = _planes((B, nc, ns), 777, dev)
    post, pre = ck.twiddle(n), ck.twiddle(n, True)

    def fold_a():
        t = ck.fft_strided(xr, xi, post=post, out_transposed=True)
        return ck.fft_strided(*t, out=t)

    def inv_a(y):
        t = ck.fft_strided(*y, True)
        return ck.fft_strided(*t, True, 1.0 / n, pre=pre, in_transposed=True)

    def fold_b():
        t = ck.fft_strided(xr, xi, post=post)
        return ck.fft_strided(*t, in_transposed=True)

    def inv_b(y):
        t = ck.fft_strided(*y, True, out_transposed=True)
        return ck.fft_strided(*t, True, 1.0 / n, pre=pre, out=t)

    def unfolded():
        t = ck.fft_strided(xr, xi, post=post)
        lines = tuple(u.reshape(-1, ns) for u in t)
        ck.fft_lines(*lines, out=lines)
        y = ck.swap_digits(Planar(t[0].reshape(B, n), t[1].reshape(B, n)),
                           nc, ns)
        return y.re.reshape(B, ns, nc), y.im.reshape(B, ns, nc)

    def inv_unfolded(y):
        x = ck.swap_digits(Planar(y[0].reshape(B, n), y[1].reshape(B, n)),
                           ns, nc)
        lines = (x.re.reshape(-1, ns), x.im.reshape(-1, ns))
        ck.fft_lines(*lines, True, out=lines)
        t = (x.re.reshape(B, nc, ns), x.im.reshape(B, nc, ns))
        return ck.fft_strided(*t, True, 1.0 / n, pre=pre, out=t)

    want = torch.fft.fft(torch.complex(xr, xi).reshape(B, n))
    x = torch.complex(xr, xi)
    out = {"shape": [B, nc, ns], "ms": {}, "round_trip_ms": {}}
    variants = (("a_strided_store_transposed", fold_a, inv_a),
                ("b_lines_store_transposed", fold_b, inv_b),
                ("unfolded_lines_and_transpose", unfolded, inv_unfolded))
    for name, fwd, inv in variants:
        y = fwd()
        rel = _rel(torch.complex(*y).reshape(B, n), want)
        assert rel <= KERNEL_TOL, (name, rel)
        rel = _rel(torch.complex(*inv(y)).reshape(x.shape), x)
        assert rel <= KERNEL_TOL, (name, "round trip", rel)
        out["ms"][name], out["round_trip_ms"][name] = [], []
    for name, fwd, _ in variants + variants[::-1]:
        out["ms"][name].append(_time_ms(fwd))
    for name, fwd, inv in variants + variants[::-1] + variants:
        out["round_trip_ms"][name].append(
            _time_ms(lambda: inv(fwd())))
    _log(f"[time] long placements {out}")
    return out


def phase_long_times(vt, ce, ck, dev) -> dict:
    """fft_strided_tw at the 2^20 row's shapes: the main path's folded
    passes (the forward stored transposed, the inverse read transposed)
    and the natural mode's twiddled passes, each held against its plain
    version there (no one PyTorch call computes a twiddled strided pass,
    so library_ms is null), with its layout, registers and spills (at most
    64, none) and blocks an SM; the two placements of the folded reorder
    (`_long_placements`); and the round trips of LONG_E2E beside the bound
    (one read and one write of the planes a direction), the kernels a
    direction launches, the reorder's share (the tensor-op transposes the
    route still runs, timed alone at the row's shapes; 0 where the split
    folds them, `long_folds`) and torch.fft of the same data."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    _log(f"[time] card: {_smi()}")
    r, st, ld = _ptxas_of(ck, "fft_strided_tw")["fft_strided_tw_kernel"]
    assert r <= 64 and st == ld == 0, (r, st, ld)
    kernels = {"fft_strided_tw": []}
    B, n = LONG_ROW_LINES, LONG_ROW_N
    nc, ns = ck.long_split(n)
    for what, shape, inverse, kw in (
            ("folded forward: twiddle on the write, stored transposed",
             (B, nc, ns), False,
             dict(post=ck.twiddle(n), out_transposed=True)),
            ("folded inverse: read transposed, twiddle after the read",
             (B, ns, nc), True,
             dict(pre=ck.twiddle(n, True), in_transposed=True)),
            ("natural forward: twiddle on the write", (B, nc, ns), False,
             dict(post=ck.twiddle(n))),
            ("natural inverse: twiddle after the read", (B, nc, ns), True,
             dict(pre=ck.twiddle(n, True)))):
        xr, xi = _planes(shape, 900 + inverse, dev)
        scale = 1.0 / n if inverse else 1.0
        err = _errors(ck.fft_strided(xr, xi, inverse, scale, **kw),
                      ck.fft_strided_plain(xr, xi, inverse, scale, **kw),
                      ("fft_strided_tw", what))
        nbytes = 16.0 * B * n
        bound, by = _bound(nbytes, _fft_ops(B * n, nc) + _cmul_ops(B * n))
        rows, cols = (shape[2], shape[1]) if kw.get("in_transposed") \
            else shape[1:]
        row = {"what": what, "shape": list(shape), "inverse": inverse,
               "ms": _time_ms(lambda: ck.fft_strided(xr, xi, inverse, scale,
                                                     **kw)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "plain_ms": _time_ms(lambda: ck.fft_strided_plain(
                   xr, xi, inverse, scale, **kw), reps=5, inner=1, warmup=1),
               "library_ms": None,
               "layout": list(ck.strided_tw_layout(rows, cols)),
               "split": list(ck.strided_tw_split(rows, cols)),
               "registers": r, "spill_bytes": [st, ld],
               "blocks_per_sm": ck.strided_tw_occupancy(rows, cols)}
        row["GBs"] = nbytes / row["ms"] / 1e6
        _log(f"[time] fft_strided_tw {row}")
        kernels["fft_strided_tw"].append(row)
        del xr, xi
    placements = _long_placements(ck, dev)

    e2e = []
    for n, B in LONG_E2E:
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True))
        x = vt.Planar(*_planes((B, n), n + 5, dev))
        xc = torch.complex(x.re, x.im)
        kernels_ = ce.route(plan_axis(n))
        nbytes = 4 * 8.0 * B * n
        bound, by = _bound(nbytes, 2 * _fft_ops(B * n, n))
        ms = _time_ms(lambda: app.inverse(app.forward(x)))
        row = {"row": f"long_n{n}", "shape": [B, n],
               "plan": plan_axis(n).algorithm.value,
               "route": [(k, m) for k, _, m in kernels_],
               "uploads_per_dir": len(kernels_), "ms": ms,
               "GBs": nbytes / ms / 1e6, "bound_ms": bound, "bound_by": by,
               "torch_fft_ms": _time_ms(
                   lambda: torch.fft.ifft(torch.fft.fft(xc)))}
        if row["plan"] == "direct":
            split = ck.long_split(n)
            row["folded"] = ck.long_folds(split)
            reorder = 0.0
            if not row["folded"]:
                t = x.re.reshape(B, n // split[-1], split[-1])
                reorder = _time_ms(lambda: (t.transpose(1, 2).contiguous(),
                                            t.transpose(1, 2).contiguous()))
            row["reorder_ms_per_dir"] = reorder
            row["reorder_share"] = 2 * reorder / ms
        row["vs_torch_fft"] = row["torch_fft_ms"] / ms
        _log(f"[time] e2e {row}")
        e2e.append(row)
        del x, xc
    return {"kernels": kernels, "placements": placements, "e2e": e2e}


# ---------------------------------------------------------------------------
# The double-double tier (Precision.DOUBLE, DDComplex, fft_dd) on fft_dd.
# ---------------------------------------------------------------------------

DD_KERNEL_TOL = 1e-13        # fft_dd vs its plain version, of max|ref|
DD_NUMPY_TOL = 5e-14         # vs fp64 (sample 19's gate, cli.py:633)
DD_SAMPLE_12_TOL = 1e-12     # sample 12's gate (cli.py:315)
DD_OP_FLOPS = 11             # fp32 operations a dd operation (csrc/dd.cuh)
DD_ADD_INSTR = 11            # fp32 instructions a dd add (csrc/dd.cuh)
DD_MUL_INSTR = 7             # fp32 instructions a dd product (csrc/dd.cuh)
DD_STRIDE = 8                # every 8th kernel length in dd_kernels
DD_BYTES = 64 * 1024 * 1024  # sample 9: 64 MiB of quad planes a row
DD_GUARD_REPEATS = 3         # launches of each guarded case in dd_kernels
DD_GUARD = 1 << 16           # sentinel floats each side of an output
SAMPLE_19 = (8, 64, 100, 256, 101, 1024, 17, 97)    # cli.py:615
# sample 12's complex-free systems, cli.py:267 and :303 (the first 10)
SAMPLE_12 = tuple(1 << k for k in range(3, 13))
# (row, shape, launches a forward plus an inverse): sample 9's rows
# (cli.py:567-612, 64 MiB / (16 n) lines), a 3-D row, a four-step row
DD_ROWS = (("sample9_n256", (DD_BYTES // (16 * 256), 256), 2),
           ("sample9_n1024", (DD_BYTES // (16 * 1024), 1024), 2),
           ("3d_64x256x256", (64, 256, 256), 6),
           ("four_step_n65536", (DD_BYTES // (16 * 65536), 65536), 4))


def _ddc(shape, seed, dev):
    """Random dd planes on the card, split from complex128 there, and the
    complex128 tensor they hold."""
    from vkfft_tpu_torch.precision import doubledouble as ddm
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.complex(torch.randn(shape, generator=g, device=dev,
                                  dtype=torch.float64),
                      torch.randn(shape, generator=g, device=dev,
                                  dtype=torch.float64))
    return ddm.ddc_from_complex128(x), x


def _dd_rel(a, b) -> float:
    from vkfft_tpu_torch.precision import doubledouble as ddm
    a = ddm.ddc_to_complex128(a) if not isinstance(a, torch.Tensor) else a
    b = ddm.ddc_to_complex128(b) if not isinstance(b, torch.Tensor) else b
    return _rel(a, b)


def _dd_err(y, p, what) -> tuple:
    """(max abs error, relative error) of kernel quad planes against plain
    ones, after asserting the relative error is within DD_KERNEL_TOL."""
    rel = _dd_rel(y, p)
    assert rel <= DD_KERNEL_TOL, (what, rel)
    err = max(((a.double() - c.double()) + (b.double() - d.double())).abs()
              .max().item() for a, b, c, d in
              ((y.re.hi, y.re.lo, p.re.hi, p.re.lo),
               (y.im.hi, y.im.lo, p.im.hi, p.im.lo)))
    return err, rel


def _dd_kernel_lengths(dk) -> list:
    lengths = [n for n in range(2, dk.DD_KERNEL_MAX_N + 1)
               if dk.use_dd_kernel(n)]
    # the main path's powers of two and general lengths of each radix
    named = {2, 3, 5, 7, 11, 13, 16, 64, 256, 1024, 1144, 4095, 4096}
    return sorted(set(lengths[::DD_STRIDE]) | named)


def _dd_variant_name(dk, variant: int) -> str:
    return "pow2" if variant == dk.DD_POW2 else "general"


def _with_variant(dk, variant: int, fn):
    """fn() with every fft_dd launch passing ``variant`` in place of
    dd_variant's choice."""
    real = dk.dd_variant
    dk.dd_variant = lambda n: variant
    try:
        return fn()
    finally:
        dk.dd_variant = real


def _dd_guarded(dk, entry: str, x, inverse: bool, variant: int, dev):
    """One launch of fft_dd's ``entry`` ("lines", "strided") on x, its
    output planes inside a buffer of sentinel values (DD_GUARD floats on
    each side): (the output, the guard cells the launch changed)."""
    sentinel, n = 12345.0, x.shape[-1] if entry == "lines" else x.shape[1]
    numel = x.re.hi.numel()
    buf = torch.full((4, numel + 2 * DD_GUARD), sentinel, device=dev)
    y = [buf[i, DD_GUARD:DD_GUARD + numel].view(x.shape) for i in range(4)]
    plan, table = dk._plan_args(n, inverse, dev)
    extents = ([x.shape[0]] if entry == "lines"
               else [x.shape[0], x.shape[2]])
    options = [None, 0, None, 0] + ([None] if entry == "lines" else [])
    dk.ck._launch("fft_dd", "fft_dd_" + entry, dev,
                  [*x.planes(), *y, *extents, plan, table, *options, 1.0,
                   0.0, variant])
    changed = (int((buf[:, :DD_GUARD] != sentinel).sum())
               + int((buf[:, DD_GUARD + numel:] != sentinel).sum()))
    return dk.DDComplex.of(y), changed


def phase_dd_kernels_vs_plain(dk, dev) -> dict:
    """fft_dd's entries against their plain versions on the card (<= 1e-13
    of max|ref|, not KERNEL_TOL: broken EFTs pass at 1e-5), at every 8th
    13-smooth kernel length and named ones (64, 256, 1024, 4096 on the
    power-of-two instantiation, 13, 1144, 4095 on the general one), the
    direction alternating: lines (B = 3), the strided entry with odd S and
    P > 1 (its pre/post tables and scale on every other length), Rader's
    pointwise entry; on a subset against torch.fft in complex128 on the
    card (<= 5e-14).  Then the general instantiation at the powers of two
    (it holds every radix) against plain, each entry's refusal of a plan
    whose radices its instantiation lacks (1144 on the power-of-two one),
    and the guarded launches (`_dd_guarded`).  The worst error is kept for
    each instantiation and entry."""
    from vkfft_tpu_torch.precision import doubledouble as ddm
    out = {"lines": [], "strided": [], "pointwise": [],
           "general_at_pow2": []}
    for i, n in enumerate(_dd_kernel_lengths(dk)):
        inverse = bool(i % 2)
        variant = _dd_variant_name(dk, dk.dd_variant(n))
        x, xc = _ddc((3, n), n, dev)
        y = dk.fft_dd_lines(x, inverse)
        err, rel = _dd_err(y, dk.dd_lines_plain(x, inverse), ("lines", n))
        row = {"n": n, "variant": variant, "inverse": inverse,
               "max_abs_err": err, "rel_err": rel}
        if i % 4 == 0 or n in (4096, 4095, 1144, 13):
            ref = torch.fft.ifft(xc) * n if inverse else torch.fft.fft(xc)
            row["rel_err_torch_fft_c128"] = _dd_rel(y, ref)
            assert row["rel_err_torch_fft_c128"] <= DD_NUMPY_TOL, row
        out["lines"].append(row)
        S = 1 + 2 * (n % 5) if n > 512 else 33
        xs, xsc = _ddc((2, n, S), n + 1, dev)
        kw = {}
        if i % 2:
            tab = torch.from_numpy(dk.quads(np.exp(
                0.37j * np.arange(n * S)))).to(dev)
            kw = dict(pre=tab, post=tab, scale=0.5)
        y = dk.fft_dd_strided(xs, inverse, **kw)
        err, rel = _dd_err(y, dk.dd_strided_plain(xs, inverse, **kw),
                           ("strided", n, S))
        row = {"n": n, "variant": variant, "P": 2, "S": S,
               "inverse": inverse, "options": bool(kw), "max_abs_err": err,
               "rel_err": rel}
        if not kw and (i % 4 == 1 or n == 4096):
            ref = (torch.fft.ifft(xsc, dim=1) * n if inverse
                   else torch.fft.fft(xsc, dim=1))
            row["rel_err_torch_fft_c128"] = _dd_rel(y, ref)
            assert row["rel_err_torch_fft_c128"] <= DD_NUMPY_TOL, row
        out["strided"].append(row)
    for R, C in ((5, 1), (3, 100)):
        x, _ = _ddc((R, C), R, dev)
        add = dk.quads_of(_ddc((R,), R + 1, dev)[0])
        tab = torch.from_numpy(dk.quads(np.exp(0.1j * np.arange(C)))).to(dev)
        y = dk.dd_pointwise(x, tab, add, 0.25)
        err, rel = _dd_err(y, dk.dd_pointwise_plain(x, tab, add, 0.25),
                           ("pointwise", R))
        out["pointwise"].append({"shape": [R, C], "max_abs_err": err,
                                 "rel_err": rel})
    for n in (64, 256, 1024, 4096):
        x, _ = _ddc((3, n), n + 7, dev)
        xs, _ = _ddc((2, n, 9), n + 8, dev)
        y = _with_variant(dk, dk.DD_GENERAL, lambda: dk.fft_dd_lines(x))
        ys = _with_variant(dk, dk.DD_GENERAL,
                           lambda: dk.fft_dd_strided(xs, True))
        for entry, got, want in (("lines", y, dk.dd_lines_plain(x, False)),
                                 ("strided", ys,
                                  dk.dd_strided_plain(xs, True))):
            err, rel = _dd_err(got, want, ("general", entry, n))
            out["general_at_pow2"].append(
                {"n": n, "entry": entry, "variant": "general",
                 "max_abs_err": err, "rel_err": rel})
    x, _ = _ddc((3, 1144), 5, dev)
    xs, _ = _ddc((1, 1144, 3), 6, dev)
    refusals = {}
    for entry, fn in (("lines", lambda: dk.fft_dd_lines(x)),
                      ("strided", lambda: dk.fft_dd_strided(xs))):
        try:
            _with_variant(dk, dk.DD_POW2, fn)
            refusals[entry] = "launched"
        except RuntimeError as e:
            refusals[entry] = str(e)
        assert "invalid argument" in refusals[entry], (entry, refusals)
    out["refusals"] = refusals
    # both instantiations on the strided entry's tiles of several per
    # plane (where a build at another register cap once faulted) and on
    # lines, each launched DD_GUARD_REPEATS times with its output inside
    # sentinel guards: no write outside the output, each within 1e-13
    guarded = {"launches": 0, "guard_cells_changed": 0, "worst_rel": 0.0}
    cases = ([("strided", (P, n, S)) for n in (32, 64, 256, 1024)
              for S in (33, 64, 97) for P in (1, 2)]
             + [("lines", (5, n)) for n in (64, 256, 1024, 4096)])
    for i, (entry, shape) in enumerate(cases):
        x, _ = _ddc(shape, i + 11, dev)
        inverse = bool(i % 2)
        want = (dk.dd_lines_plain(x, inverse) if entry == "lines"
                else dk.dd_strided_plain(x, inverse))
        for variant in (dk.DD_POW2, dk.DD_GENERAL):
            for _ in range(DD_GUARD_REPEATS):
                y, changed = _dd_guarded(dk, entry, x, inverse, variant, dev)
                rel = _dd_err(y, want, ("guarded", entry, shape, variant))[1]
                assert changed == 0, (entry, shape, variant, changed)
                guarded["launches"] += 1
                guarded["worst_rel"] = max(guarded["worst_rel"], rel)
    out["guarded"] = guarded
    torch.cuda.synchronize()
    worst = {}
    for entry in ("lines", "strided"):
        for r in out[entry] + [r for r in out["general_at_pow2"]
                               if r["entry"] == entry]:
            key = f"{r['variant']}/{entry}"
            worst[key] = max(worst.get(key, 0.0), r["rel_err"])
    worst["pointwise"] = max(r["rel_err"] for r in out["pointwise"])
    _log(f"[dd kernels] {len(out['lines'])} lengths, worst rel_err vs plain "
         f"by instantiation/entry {worst}; a pow2 launch of n = 1144 "
         f"refused: {refusals}; guarded launches {guarded}")
    out["worst"] = worst
    return out


def phase_dd_routes(vt, dd_fft, dev) -> dict:
    """fft_dd and FFTApplication(DOUBLE) on the card: sample 19's sizes
    (<= 5e-14 of numpy), sample 12's complex-free systems through host
    complex128 (<= 1e-12), four-step, Rader and Bluestein lengths, a 3-D
    shape, the other input forms; none may raise."""
    from vkfft_tpu_torch.precision import doubledouble as ddm
    rows = []

    def check(name, got, want, tol):
        err = _numpy_rel(got, want)
        rows.append({"case": name, "rel_err": err})
        assert err <= tol, (name, err)

    for n in SAMPLE_19 + (1144, 47, 2053, 4116, 6144, 4801, 1 << 16):
        rng = np.random.default_rng(n)
        x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
        y = dd_fft.fft_dd(x)
        check(f"fft_dd_{n}_{dd_fft.dd_route(n)[0]}", y, np.fft.fft(x),
              DD_NUMPY_TOL)
        z = dd_fft.fft_dd(y, inverse=True, normalize=True)
        check(f"fft_dd_{n}_round_trip", z, x, DD_NUMPY_TOL)
    for n in SAMPLE_12:
        rng = np.random.default_rng(2)
        x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,),
                                             precision=vt.Precision.DOUBLE))
        check(f"sample12_{n}", app.forward(x.reshape(1, n))[0],
              np.fft.fft(x), DD_SAMPLE_12_TOL)
    shape = (4, 24, 17)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True,
                                         precision=vt.Precision.DOUBLE))
    y = app.forward(torch.from_numpy(x).to(dev))
    assert y.dtype == torch.complex128 and y.device == dev
    check("3d_tensor_4x24x17", y.cpu().numpy(), np.fft.fftn(x), DD_NUMPY_TOL)
    z = app.inverse(ddm.ddc_from_complex128(y))
    assert isinstance(z, ddm.DDComplex)
    check("3d_round_trip", _host_c128(z), x, DD_NUMPY_TOL)
    p = vt.Planar(torch.from_numpy(x.real.astype(np.float32)).to(dev),
                  torch.from_numpy(x.imag.astype(np.float32)).to(dev))
    check("3d_planar_widened", _host_c128(app.forward(p)),
          np.fft.fftn(x.astype(np.complex64).astype(np.complex128)),
          DD_NUMPY_TOL)
    worst = max(r["rel_err"] for r in rows)
    _log(f"[dd routes] {len(rows)} cases, worst rel_err {worst:.3e}")
    return {"rows": rows, "worst": worst}


def _host_c128(x) -> np.ndarray:
    from vkfft_tpu_torch.precision import doubledouble as ddm
    return ddm.ddc_to_complex128(x).cpu().numpy()


def phase_dd_main_path(vt, ck, dk, torch_engine, dev) -> dict:
    """Sample 9 at full width, a 3-D row and a four-step row through
    FFTApplication(DOUBLE) on DDComplex planes on the card (forward, then
    normalized inverse), each counted from 0 and held to its exact
    launches, no plain dd call and no plain-engine call; the forward
    against torch.fft in complex128 on the card and the round trip
    against the input (<= 5e-14)."""
    rows, by_row = [], {}
    for name, shape, want in DD_ROWS:
        x, xc = _ddc(shape, len(name), dev)
        app = vt.FFTApplication(vt.FFTConfig(
            shape=shape[1:] if len(shape) == 2 else shape, normalize=True,
            precision=vt.Precision.DOUBLE))
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        dk.plain_calls = 0
        y = app.forward(x)
        z = app.inverse(y)
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_row[f"dd_{name}"] = got
        _log(f"[main dd] {name}: launches {got}, plain dd calls "
             f"{dk.plain_calls}, plain engine calls {torch_engine.calls}")
        assert got == {k: (want if k == "fft_dd" else 0) for k in got}, (
            name, got)
        assert dk.plain_calls == 0 and torch_engine.calls == 0, name
        ref = (torch.fft.fftn(xc) if len(shape) == 3
               else torch.fft.fft(xc))
        row = {"row": name, "shape": list(shape), "launches": want,
               "oracle": "torch.fft complex128 on the card",
               "rel_err_fwd": _dd_rel(y, ref),
               "rel_err_round_trip": _dd_rel(z, xc),
               "finite": all(bool(torch.isfinite(p).all())
                             for p in y.planes() + z.planes())}
        _log(f"[main dd] {row}")
        assert row["finite"] and y.shape == x.shape == z.shape, row
        assert row["rel_err_fwd"] <= DD_NUMPY_TOL, row
        assert row["rel_err_round_trip"] <= DD_NUMPY_TOL, row
        rows.append(row)
        del x, xc, y, z, ref
        torch.cuda.empty_cache()
    launches = {k: sum(c[k] for c in by_row.values()) for k in ck.launches}
    return {"launches": launches, "launches_by_path": by_row,
            "plain_dd_calls": 0, "plain_engine_calls": 0, "rows": rows}


def _dd_ops(points: int, n: int) -> float:
    """5 n log2 n dd operations a DFT of n, DD_OP_FLOPS fp32 operations
    each."""
    return _fft_ops(points, n) * DD_OP_FLOPS


def _dd_instructions(points: int, n: int, table: bool = False) -> float:
    """fp32 instructions of the nominal dd work: a DFT of n's 5 n log2 n
    operations are 3 n log2 n adds and 2 n log2 n products (n/2 log2 n
    radix-2 butterflies of one complex product and two complex adds), at
    DD_ADD_INSTR and DD_MUL_INSTR instructions; a table's complex product
    a point is 4 products and 2 adds.  A computed count, not a measured
    one: the kernel's radix-8 and radix-4 stages do fewer operations."""
    per_point = math.log2(n) * (3 * DD_ADD_INSTR + 2 * DD_MUL_INSTR)
    if table:
        per_point += 4 * DD_MUL_INSTR + 2 * DD_ADD_INSTR
    return per_point * points


def _fp32_issue_per_s() -> float:
    """fp32 instructions the card issues a second: one a lane a clock on
    the 128 fp32 lanes of each SM at the SM clock's maximum
    (``nvidia-smi --query-gpu=clocks.max.sm``).  A dd add is 11
    single-flop instructions, so this, not FP32_FLOP_PER_S (which counts
    an fma as 2), is the arithmetic floor of dd code."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(res.stdout.strip().splitlines()[0].split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6


def phase_dd_times(vt, dd_fft, dk, ck, dev) -> dict:
    """fft_dd's entries at the main path's shapes (held against their
    plain versions there), beside the bound (32 B a point a pass, each
    table read once; 5 n log2 n dd operations of DD_OP_FLOPS), the
    computed issue floor (`_dd_instructions` over `_fp32_issue_per_s`;
    not a measurement), the plain time
    and torch.fft on complex128 of the same points (cuFFT Z2Z, the same
    function at no less precision, 16 B a point), with the instantiation
    each row runs, its registers and spills (ptxas) and its resident
    blocks an SM (``vk_fft_dd_occupancy``); then each main-path row's
    round trip beside torch.fft + ifft on complex128."""
    _log(f"[time] card: {_smi()}")
    issue = _fp32_issue_per_s()
    with open(ck.library_path("fft_dd")[:-3] + ".log") as f:
        ptxas = {k: (r, st, ld) for k, r, st, ld in _ptxas_kernels(f.read())}
    # the passes of the main path: sample 9's lines, the 3-D row's axis 1
    # and axis 0 (the (1, n0, n1*n2) view), the four-step's strided pass
    # with its twiddle on the write
    cases = []
    for name, shape, _ in DD_ROWS:
        if name.startswith("sample9"):
            cases.append(("lines", shape, None))
        elif len(shape) == 3:
            cases += [("strided", shape, None),
                      ("strided", (1, shape[0], shape[1] * shape[2]), None)]
        else:
            cases.append(("strided", (shape[0],) + dd_fft.dd_split(shape[1]),
                          "twiddle"))
    rows = []
    for entry, shape, opt in cases:
        for inverse in (False, True):
            x, xc = _ddc(shape, sum(shape) + inverse, dev)
            n = shape[-1] if entry == "lines" else shape[1]
            kw, table_bytes = {}, 0
            if opt == "twiddle":
                n1, n2 = shape[1:]
                kw = dict(post=dk.device_quads(
                    ("twiddle", n1, n2, inverse), dev,
                    lambda: dd_fft._four_step_twiddle(n1, n2, inverse)))
                table_bytes = 16 * n1 * n2
            if entry == "lines":
                fn = lambda: dk.fft_dd_lines(x, inverse, **kw)
                plain = lambda: dk.dd_lines_plain(x, inverse, **kw)
                lib = lambda: torch.fft.fft(xc)
            else:
                fn = lambda: dk.fft_dd_strided(x, inverse, **kw)
                plain = lambda: dk.dd_strided_plain(x, inverse, **kw)
                lib = lambda: torch.fft.fft(xc, dim=1)
            err, rel = _dd_err(fn(), plain(), (entry, shape, inverse))
            points = math.prod(shape)
            nbytes = 32.0 * points + table_bytes
            ops = _dd_ops(points, n) + (DD_OP_FLOPS * 6 * points if kw else 0)
            bound, by = _bound(nbytes, ops)
            variant = dk.dd_variant(n)
            regs, spill_st, spill_ld = ptxas[f"dd_{entry}_kernel<{variant}>"]
            row = {"entry": f"fft_dd_{entry}", "shape": list(shape),
                   "inverse": inverse, "factor": opt or None,
                   "variant": _dd_variant_name(dk, variant),
                   "registers": regs, "spill_bytes": [spill_st, spill_ld],
                   "blocks_per_sm": dk.dd_occupancy(
                       variant, dk.DD_LINES if entry == "lines"
                       else dk.DD_STRIDED, n),
                   # the first timing of a shape ran up to 60 % slow:
                   # a whole pass is discarded, and kept beside the time
                   "ms_discarded_pass": _time_ms(fn),
                   "ms": _time_ms(fn), "bound_ms": bound, "bound_by": by,
                   "issue_floor_ms": _dd_instructions(
                       points, n, bool(kw)) / issue * 1e3,
                   "max_abs_err": err, "rel_err_vs_plain": rel,
                   "plain_ms": _time_ms(plain, reps=3, inner=1, warmup=1),
                   "library_ms": _time_ms(lib),
                   "library": "torch.fft.fft complex128 (cuFFT Z2Z)"}
            row["GBs"] = nbytes / row["ms"] / 1e6
            row["roofline_share"] = bound / row["ms"]
            _log(f"[time] fft_dd {row}")
            rows.append(row)
            del x, xc
    e2e = []
    for name, shape, want in DD_ROWS:
        x, xc = _ddc(shape, 7, dev)
        app = vt.FFTApplication(vt.FFTConfig(
            shape=shape[1:] if len(shape) == 2 else shape, normalize=True,
            precision=vt.Precision.DOUBLE))
        nd = len(shape) == 3
        points = math.prod(shape)
        # one read and one write of the quad planes an axis a direction
        # (PERF.md section 2), whatever a 1-D length's uploads
        nbytes = 2 * (3 if nd else 1) * 32.0 * points
        ops = sum(_dd_ops(points, m) for m in (shape if nd else shape[1:]))
        bound, by = _bound(nbytes, 2 * ops)
        ms = _time_ms(lambda: app.inverse(app.forward(x)))
        host = _host_ms(lambda: app.inverse(app.forward(x)))
        issue_floor = 2 * sum(_dd_instructions(points, m) for m in (
            shape if nd else shape[1:])) / issue * 1e3
        lib = ((lambda: torch.fft.ifftn(torch.fft.fftn(xc))) if nd else
               (lambda: torch.fft.ifft(torch.fft.fft(xc))))
        row = {"row": name, "shape": list(shape), "launches": want,
               "ms": ms, "GBs": nbytes / ms / 1e6,
               "bound_ms": bound, "bound_by": by,
               "issue_floor_ms": issue_floor, "host_enqueue_ms": host,
               "torch_fft_c128_ms": _time_ms(lib)}
        row["vs_torch_fft"] = row["torch_fft_c128_ms"] / ms
        if name.startswith("four_step"):
            t = x.re.hi.reshape(shape[0], *dd_fft.dd_split(shape[1]))
            reorder = _time_ms(lambda: [t.transpose(1, 2).contiguous()
                                        for _ in range(4)])
            row["reorder_ms_per_dir"] = reorder
            row["reorder_share"] = 2 * reorder / ms
        _log(f"[time] e2e dd {row}")
        e2e.append(row)
        del x, xc
    return {"kernels": {"fft_dd": rows}, "e2e": e2e}


# ---------------------------------------------------------------------------
# Native fp64: the fp64 instantiations of fft_lines, fft_strided and
# fft_pair, DOUBLE's route (api.double_route), its main path and times.
# ---------------------------------------------------------------------------

F64_KERNEL_TOL = 1e-13       # fp64 kernel vs its plain fp64 version
F64_NUMPY_TOL = 5e-14        # vs torch.fft complex128 (PERF.md section 2)
# NVIDIA's data sheet, H100 SXM: fp64 outside the tensor cores
FP64_FLOP_PER_S = 34e12
F64_BYTES = 128 * 1024 * 1024   # of complex128 a 1-D row
F64_CUBE = (256, 256, 256)      # complex128, 256 MiB
F64_LINES_STRIDE = 11        # every 11th fft_lines length in f64_kernels
F64_STRIDED_STRIDE = 23      # every 23rd fft_strided length
F64_PAIR_STRIDE = 211        # every 211th plane fp64 fft_pair serves
# the fp32 kernels' ptxas lines as the tree before the fp64 instantiations
# built them (an H100 build of d903725): the walk's template must leave
# them as they were
FP32_PTXAS = {
    "fft_lines_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_strided_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_pair_kernel": "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads | Used 64 registers, used 1 barriers, 8 bytes cumulative stack size",
    "c2r_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "r2c_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "r2c_pair_kernel<0>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "r2c_pair_kernel<1>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "c2r_pair_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_conv_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_twofactor_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_conv_inv_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_conv2d_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_conv_pair_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "dct3_kernel": "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads | Used 64 registers, used 1 barriers, 8 bytes cumulative stack size",
    "dct2_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "dct1_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "dct4_odd_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "dct4_even_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "fft_strided_tw_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 64 registers, used 1 barriers",
    "dd_strided_kernel<1>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 128 registers, used 1 barriers",
    "dd_strided_kernel<0>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 80 registers, used 1 barriers",
    "dd_lines_kernel<1>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 128 registers, used 1 barriers",
    "dd_lines_kernel<0>": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 80 registers, used 1 barriers",
    "dd_pointwise_kernel": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads | Used 29 registers, used 0 barriers",
}


# the ptxas lines of the kept-order entries (fft_lines_tl_kernel,
# fft_pair_tl_kernel and their half twins) and of fft_conv_pair's windowed
# 2-D entry (fft_conv2d_zp_kernel and its twins), pinned from an H100
# build of this tree
ZERO_SPILL_64 = ("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                 "loads | Used 64 registers, used 1 barriers")
# the tl inverse spills 8 B / 4 B (ROADMAP queue 3)
PAIR_TL_INVERSE_LINE = ("8 bytes stack frame, 8 bytes spill stores, 4 bytes "
                        "spill loads | Used 64 registers, used 1 barriers, 8 "
                        "bytes cumulative stack size")
ZP_LINES_SPILL = ("8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
                  "loads | Used 64 registers, used 1 barriers, 8 bytes "
                  "cumulative stack size")
NEW_PTXAS = {
    "fft_lines_tl_kernel": ZERO_SPILL_64,
    "fft_lines_tl_f16_kernel": ZERO_SPILL_64,
    "fft_lines_tl_bf16_kernel": ZERO_SPILL_64,
    "fft_pair_tl_kernel<0>": ZERO_SPILL_64,
    "fft_pair_tl_f16_kernel<0>": ZERO_SPILL_64,
    "fft_pair_tl_bf16_kernel<0>": ZERO_SPILL_64,
    "fft_pair_tl_kernel<1>": PAIR_TL_INVERSE_LINE,
    "fft_pair_tl_f16_kernel<1>": PAIR_TL_INVERSE_LINE,
    "fft_pair_tl_bf16_kernel<1>": PAIR_TL_INVERSE_LINE,
    "fft_conv2d_zp_kernel": ZERO_SPILL_64,
    "fft_conv2d_zp_f16_kernel": ZERO_SPILL_64,
    "fft_conv2d_zp_bf16_kernel": ZERO_SPILL_64,
    # Bluestein's read window: the windowed entries of fft_conv,
    # fft_conv_pair and fft_strided_tw
    **{f"{k}_zp{t}_kernel": ZERO_SPILL_64
       for k in ("fft_conv", "fft_conv_pair", "fft_strided_tw")
       for t in ("", "_f16", "_bf16")},
    # the windowed lines entries, their 4 B spill (ROADMAP queue 3:
    # the block's count of lines, stored after the read and loaded in the
    # passes' stage loop)
    **{f"{k}_zp{t}_kernel": ZP_LINES_SPILL
       for k in ("fft_lines", "fft_twofactor") for t in ("", "_f16", "_bf16")},
}


# the half-storage instantiations (C entries vk_<name>_f16 / _bf16) and
# their fp32 twins: the same body at the same bounds, the conversions at
# the edge of device memory, so the same registers and no spill beyond the
# twin's (fft_pair_kernel's 4 B, ROADMAP queue 3); fft_conv_pair's are its
# Bluestein kernel and its 2-D mode's fft_conv2d_kernel
STORAGE_TWINS = {f"{k}_{t}_kernel": f"{k}_kernel"
                 for k in ("fft_lines", "fft_twofactor", "fft_strided",
                           "fft_pair", "fft_strided_tw", "fft_conv",
                           "fft_conv_inv", "fft_conv_pair", "fft_conv2d")
                 for t in ("f16", "bf16")}


def _storage_ptxas_ok(lines: dict) -> dict:
    """{half kernel: (its ptxas line, its twin's pinned line)} for every
    half-storage kernel in ``lines`` whose line is not its fp32 twin's
    FP32_PTXAS line (registers, stack frame and spills): empty when all
    are."""
    return {k: (lines[k], FP32_PTXAS[t]) for k, t in STORAGE_TWINS.items()
            if k in lines and lines[k] != FP32_PTXAS[t]}


def _f64_bound(points: float, n: int, passes: int = 1):
    """The least time of ``passes`` passes over ``points`` complex128
    points of DFTs of n: 32 B a point a pass (16 read, 16 written) over
    the HBM rate, or 5 n log2 n a DFT over the fp64 rate if larger."""
    tb = passes * 32.0 * points / HBM_BYTES_PER_S * 1e3
    to = passes * _fft_ops(points, n) / FP64_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _planes64(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev, dtype=torch.float64),
            torch.randn(shape, generator=g, device=dev, dtype=torch.float64))


def _f64_err(y, p, what) -> float:
    """Max abs error of fp64 kernel planes ``y`` against plain planes ``p``,
    after asserting the relative error is within F64_KERNEL_TOL."""
    rel = _rel(torch.complex(*y), torch.complex(*p))
    assert rel <= F64_KERNEL_TOL, (what, rel)
    return max((y[0] - p[0]).abs().max().item(),
               (y[1] - p[1]).abs().max().item())


def _f64_generic(ck, split) -> bool:
    """Whether a factor of the split has a generic (prime) stage in the
    fp64 walk (`stage_radices`)."""
    return any(r not in ck._WALK_FIXED_RADICES
               for k in split if k > 1 for r in ck.stage_radices(k))


def phase_f64_kernels(ck, dev) -> dict:
    """fp64 fft_lines, fft_strided and fft_pair against their plain fp64
    versions (<= F64_KERNEL_TOL of max|ref|) on a sample of every layout
    class (every F64_*_STRIDE-th length or plane and the first of each
    class: one pass or two factors, lines a block, columns a tile,
    cluster and threads, a generic stage or none), direction alternating,
    with a ragged last block; the first of each class also in place and
    against torch.fft complex128 (<= F64_NUMPY_TOL)."""
    F = torch.float64
    out = {"fft_lines": [], "fft_strided": [], "fft_pair": []}
    worst = {k: 0.0 for k in out}
    lib_worst = 0.0

    def check(name, call, plain, lib, x, key, first):
        nonlocal lib_worst
        y = call(*x)
        rel = _rel(torch.complex(*y), torch.complex(*plain(*x)))
        assert rel <= F64_KERNEL_TOL, (name, key, rel)
        worst[name] = max(worst[name], rel)
        row = {"case": key, "rel_err_vs_plain": rel}
        if first:
            e = _rel(torch.complex(*y), lib(torch.complex(*x)))
            assert e <= F64_NUMPY_TOL, (name, key, e)
            lib_worst = max(lib_worst, e)
            c = tuple(t.clone() for t in x)
            call(*c, out=c)
            assert all(torch.equal(a, b) for a, b in zip(c, y)), (name, key)
            row.update(rel_err_vs_torch_fft=e, in_place=True)
        out[name].append(row)

    lengths = [n for n in range(2, ck.KERNEL_MAX_N + 1)
               if ck.kernel_supports(n, F)]
    firsts = {}
    for n in lengths:
        t, lines, _ = ck.lines_layout(n, F)
        split = ck.lines_split(n, F)
        firsts.setdefault((split[1] == 1, lines > 1, t,
                           _f64_generic(ck, split)), n)
    named = set(firsts.values()) | set(LINES_NAMED)
    for i, n in enumerate(sorted(set(lengths[::F64_LINES_STRIDE]) | named)):
        inv = bool(i & 1)
        sc = 1.0 / n if inv else 1.0
        lines = ck.lines_layout(n, F)[1]
        x = _planes64((2 * lines + 1, n), n, dev)
        check("fft_lines",
              lambda r, m, out=None: ck.fft_lines(r, m, inv, sc, out=out),
              lambda r, m: ck.fft_lines_plain(r, m, inv, sc),
              lambda c: (torch.fft.ifft(c, dim=-1) * (n * sc) if inv
                         else torch.fft.fft(c, dim=-1)),
              x, (n, inv), n in named)
    firsts = {}
    for S in (1, 37, 200):
        for n in lengths:
            ts = ck.strided_layout(n, S, F)[0]
            split = ck.strided_split(n, S, F)
            key = (S, split[1] == 1, ts == S, ts == 1,
                   _f64_generic(ck, split))
            firsts.setdefault(key, (n, S))
    cases = sorted(set(firsts.values())
                   | {(n, S) for S in (1, 37)
                      for n in lengths[::F64_STRIDED_STRIDE]})
    named = set(firsts.values())
    for i, (n, S) in enumerate(cases):
        inv = bool(i & 1)
        P = 1 if S == 200 else 2
        x = _planes64((P, n, S), n + S, dev)
        check("fft_strided",
              lambda r, m, out=None: ck.fft_strided(r, m, inv, 0.5, out=out),
              lambda r, m: ck.fft_strided_plain(r, m, inv, 0.5),
              lambda c: (torch.fft.ifft(c, dim=1) * (0.5 * n) if inv
                         else torch.fft.fft(c, dim=1) * 0.5),
              x, (P, n, S, inv), (n, S) in named)
    served = [(ny, nz) for ny, nz in _pair_served(ck)
              if ck.pair_cluster(ny, nz, F) is not None]
    firsts = {}
    for ny, nz in served:
        c, t, _ = ck.pair_layout(ny, nz, F)
        splits = ck.pair_splits(ny, nz, F)
        key = (c, t, splits[0][1] == 1, splits[1][1] == 1,
               _f64_generic(ck, splits[0] + splits[1]))
        firsts.setdefault(key, (ny, nz))
    named = set(firsts.values()) | {(256, 256)}
    for i, (ny, nz) in enumerate(sorted(set(served[::F64_PAIR_STRIDE])
                                        | named)):
        inv = bool(i & 1)
        sc = 1.0 / (ny * nz) if inv else 1.0
        x = _planes64((2, ny, nz), ny + nz, dev)
        check("fft_pair",
              lambda r, m, out=None: ck.fft_pair(r, m, inv, sc, out=out),
              lambda r, m: ck.fft_pair_plain(r, m, inv, sc),
              lambda c: (torch.fft.ifft2(c) if inv else torch.fft.fft2(c)),
              x, (ny, nz, inv), (ny, nz) in named)
    torch.cuda.synchronize()
    counts = {k: len(v) for k, v in out.items()}
    _log(f"[f64] cases {counts}, worst vs plain {worst}, worst vs torch.fft "
         f"complex128 {lib_worst}; pair planes served at fp64: {len(served)}")
    return {"cases": out, "counts": counts, "worst_vs_plain": worst,
            "worst_vs_torch_fft": lib_worst, "pair_served": len(served)}


F64_ROUTE_LENGTHS = sorted(set(range(2, 4097, 37))
                           | {3, 4, 47, 61, 64, 67, 97, 127, 1001, 4096,
                              8192, 8209, 10007, 10240})


def phase_f64_routes(vt, ck, ce, dev) -> dict:
    """DOUBLE's route on the card: every F64_ROUTE_LENGTHS length through
    FFTApplication(DOUBLE) on complex128 tensors (forward, normalized
    inverse), native (fp64 launches only, `ce.f64_supports`) or the dd
    tier (fft_dd only) as `api.double_route` names, against torch.fft
    complex128 and the input (<= F64_NUMPY_TOL); N-D shapes (the pair
    where fp64 serves the plane, two axis passes where only fp32 does, a
    Rader axis on the dd tier); each input form (float64 Planar, host
    complex128, complex64 tensors, DDComplex on a covered length); SINGLE
    on complex128 (fp64 where covered, item 10 elsewhere)."""
    F = torch.float64
    rows = []

    def run(shape, axes=None, form="tensor"):
        nd = len(shape) - 1
        axes = tuple(range(nd)) if axes is None else axes
        app = vt.FFTApplication(vt.FFTConfig(
            shape=shape[1:], fft_axes=axes, normalize=True,
            precision=vt.Precision.DOUBLE))
        xr, xi = _planes64(shape, sum(shape), dev)
        xc = torch.complex(xr, xi)
        x = {"tensor": xc, "planar": vt.Planar(xr, xi),
             "host": xc.cpu().numpy()}[form]
        torch.cuda.synchronize()
        ck.reset_launches()
        y = app.forward(x)
        z = app.inverse(y)
        torch.cuda.synchronize()
        f64, fp32 = dict(ck.f64_launches), dict(ck.launches)

        def c(t):
            if isinstance(t, vt.Planar):
                return torch.complex(t.re, t.im)
            return torch.as_tensor(t, device=dev)
        dims = tuple(a + 1 for a in axes)
        e_f = _rel(c(y), torch.fft.fftn(xc, dim=dims))
        e_rt = _rel(c(z), xc)
        native = app.double_route == "native"
        assert native == ce.f64_supports(shape[1:], axes), shape
        if native:
            assert fp32["fft_dd"] == 0 and sum(fp32.values()) == 0, (shape,
                                                                     fp32)
            assert sum(f64.values()) > 0 or max(shape[1:]) <= 4, (shape, f64)
        else:
            assert sum(f64.values()) == 0 and fp32["fft_dd"] > 0, (shape, f64)
        assert e_f <= F64_NUMPY_TOL and e_rt <= F64_NUMPY_TOL, (shape, e_f,
                                                                  e_rt)
        rows.append({"shape": list(shape), "axes": list(axes), "form": form,
                     "route": app.double_route, "f64_launches": f64,
                     "fft_dd_launches": fp32["fft_dd"],
                     "rel_err_fwd": e_f, "rel_err_round_trip": e_rt})

    for n in F64_ROUTE_LENGTHS:
        run((3, n))
    for shape, axes in (((4, 32, 48), None), ((2, 16, 256, 256), None),
                        ((2, 256, 512), None), ((3, 97, 64), None),
                        ((3, 97, 64), (1,)), ((2, 64, 97), None)):
        run(shape, axes)
    for form in ("planar", "host"):
        run((3, 1024), form=form)
        run((3, 97), form=form)
    # complex64 tensors widen to complex128 on the native route
    app = vt.FFTApplication(vt.FFTConfig(shape=(256,),
                                         precision=vt.Precision.DOUBLE))
    assert app.forward(torch.ones(2, 256, dtype=torch.complex64,
                                  device=dev)).dtype == torch.complex128
    # DDComplex keeps the dd tier on a covered length
    from vkfft_tpu_torch.precision import doubledouble as ddm
    ck.reset_launches()
    q = app.forward(ddm.ddc_from_complex128(torch.ones(2, 256,
                                                       dtype=torch.complex128,
                                                       device=dev)))
    torch.cuda.synchronize()
    assert isinstance(q, ddm.DDComplex) and ck.launches["fft_dd"] == 1
    assert sum(ck.f64_launches.values()) == 0
    # SINGLE on complex128 tensors: fp64 where covered, item 10 elsewhere
    ck.reset_launches()
    t = vt.fft(torch.ones(2, 1000, dtype=torch.complex128, device=dev))
    assert t.dtype == torch.complex128 and ck.f64_launches["fft_lines"] == 1
    try:
        vt.fft(torch.ones(2, 97, dtype=torch.complex128, device=dev))
        raise AssertionError("SINGLE complex128 at 97 ran")
    except NotImplementedError as e:
        assert "item 10" in str(e), e
    routes = {}
    for r in rows:
        routes[r["route"]] = routes.get(r["route"], 0) + 1
    worst = max(max(r["rel_err_fwd"], r["rel_err_round_trip"]) for r in rows)
    _log(f"[f64 routes] {len(rows)} cases, {routes}, worst {worst}")
    return {"rows": rows, "routes": routes, "worst": worst}


def _f64_rows():
    """(row, shape) of the fp64 main path: 1-D n = 256 / 1024 / 4096 on
    F64_BYTES of complex128, and the 256^3 cube."""
    return ([(f"f64_1d_n{n}", (F64_BYTES // (16 * n), n)) for n in ROWS_1D]
            + [("f64_3d_256^3", F64_CUBE)])


# the fp64 launches of a forward and a normalized inverse of each row
F64_LAUNCHES = {"f64_1d_n256": {"fft_lines": 2},
                "f64_1d_n1024": {"fft_lines": 2},
                "f64_1d_n4096": {"fft_lines": 2},
                "f64_3d_256^3": {"fft_pair": 2, "fft_strided": 2}}


def phase_f64_main_path(vt, ck, dk, torch_engine, dev) -> dict:
    """DOUBLE's main path: FFTApplication(DOUBLE) on complex128 tensors, 1-D
    n = 256 / 1024 / 4096 at 128 MiB (forward, normalized inverse), and
    fftn/ifftn of a complex128 256^3 cube (the pair on axes 1-2,
    fft_strided on axis 0), each counted from 0 and held to its exact fp64
    launches, no fft_dd launch, no plain-engine or plain dd call; the
    forward against torch.fft complex128 and the round trip against the
    input (<= F64_NUMPY_TOL)."""
    F = torch.float64
    rows, by_row, f64_by_row = [], {}, {}
    for name, shape in _f64_rows():
        xc = torch.complex(*_planes64(shape, len(name), dev))
        cube = len(shape) == 3
        app = None if cube else vt.FFTApplication(vt.FFTConfig(
            shape=shape[1:], normalize=True, precision=vt.Precision.DOUBLE))
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        dk.plain_calls = 0
        if cube:
            y = vt.fftn(xc)
            z = vt.ifftn(y)
        else:
            y = app.forward(xc)
            z = app.inverse(y)
        torch.cuda.synchronize()
        fp32, f64 = dict(ck.launches), dict(ck.f64_launches)
        by_row[name], f64_by_row[name] = fp32, f64
        _log(f"[main f64] {name}: fp64 launches {f64}, fp32 {fp32}, plain "
             f"engine calls {torch_engine.calls}, plain dd {dk.plain_calls}")
        want = F64_LAUNCHES[name]
        assert f64 == {k: want.get(k, 0) for k in f64}, (name, f64)
        assert sum(fp32.values()) == 0, (name, fp32)
        assert torch_engine.calls == 0 and dk.plain_calls == 0, name
        ref = torch.fft.fftn(xc) if cube else torch.fft.fft(xc)
        row = {"row": name, "shape": list(shape), "dtype": str(y.dtype),
               "f64_launches": f64, "fft_dd_launches": fp32["fft_dd"],
               "oracle": "torch.fft complex128 on the card",
               "rel_err_fwd": _rel(y, ref), "rel_err_round_trip": _rel(z, xc),
               "finite": bool(torch.isfinite(torch.view_as_real(y)).all()
                              and torch.isfinite(torch.view_as_real(z)).all())}
        _log(f"[main f64] {row}")
        assert row["finite"] and y.shape == z.shape == xc.shape, row
        assert y.dtype == z.dtype == torch.complex128, row
        assert row["rel_err_fwd"] <= F64_NUMPY_TOL, row
        assert row["rel_err_round_trip"] <= F64_NUMPY_TOL, row
        rows.append(row)
        del xc, y, z, ref
        torch.cuda.empty_cache()
    return {"launches": {k: sum(c[k] for c in by_row.values())
                         for k in ck.launches},
            "f64_launches": {k: sum(c[k] for c in f64_by_row.values())
                             for k in ck.f64_launches},
            "launches_by_path": by_row, "f64_launches_by_path": f64_by_row,
            "plain_engine_calls": 0, "plain_dd_calls": 0, "rows": rows}


def phase_f64_times(vt, ck, dev) -> dict:
    """The fp64 kernels at the main path's shapes (each held against its
    plain fp64 version there, <= F64_KERNEL_TOL), beside the bound (32 B a
    point a pass over HBM, or 5 n log2 n over FP64_FLOP_PER_S), the plain
    time and torch.fft on complex128 of the same planes (cuFFT Z2Z), with
    each kernel's registers and spills (ptxas), layout and resident blocks
    an SM; then each main-path row's round trip on complex128 tensors
    (and on float64 Planar planes, no split and join around the kernels)
    beside torch.fft complex128 and beside the dd tier on the same data
    (on DDComplex planes, and on the tensor as DOUBLE ran it before the
    fp64 kernels), with the host's enqueue time of one round trip."""
    F = torch.float64
    _log(f"[time] card: {_smi()}")
    kernels = {k: [] for k in ck.F64_KERNELS}

    def ptx(name):
        return _ptxas_of(ck, name)[f"{name}_f64_kernel"]

    def timed(name, shape, call, plain, lib, n, extra):
        xr, xi = _planes64(shape, sum(shape), dev)
        xc = torch.complex(xr, xi)
        err = _f64_err(call(xr, xi), plain(xr, xi), (name, shape))
        points = math.prod(shape)
        bound, by = _f64_bound(points, n)
        regs, st, ld = ptx(name)
        ms = _time_ms(lambda: call(xr, xi))
        row = {"shape": list(shape), "dtype": "float64 planes", "ms": ms,
               "GBs": 32.0 * points / ms / 1e6, "bound_ms": bound,
               "bound_by": by, "roofline_share": bound / ms,
               "max_abs_err": err,
               "plain_ms": _time_ms(lambda: plain(xr, xi), reps=3, inner=1,
                                    warmup=1),
               "library_ms": _time_ms(lambda: lib(xc)),
               "library": "torch.fft complex128 (cuFFT Z2Z)",
               "registers": regs, "spill_bytes": [st, ld], **extra}
        row["vs_library"] = row["library_ms"] / ms
        _log(f"[time] {name} f64 {row}")
        kernels[name].append(row)
        del xr, xi, xc

    for n in ROWS_1D:
        t, lines, smem = ck.lines_layout(n, F)
        timed("fft_lines", (F64_BYTES // (16 * n), n),
              lambda r, m: ck.fft_lines(r, m),
              lambda r, m: ck.fft_lines_plain(r, m, False),
              lambda c: torch.fft.fft(c, dim=-1), n,
              {"split": list(ck.lines_split(n, F)), "threads": t,
               "lines_per_block": lines, "smem_bytes": smem,
               "blocks_per_sm": ck.lines_occupancy(n, F)})
    for shape in ((1, 256, 65536), (256, 256, 256)):
        P, n, S = shape
        ts, t, smem = ck.strided_layout(n, S, F)
        timed("fft_strided", shape, lambda r, m: ck.fft_strided(r, m),
              lambda r, m: ck.fft_strided_plain(r, m, False),
              lambda c: torch.fft.fft(c, dim=1), n,
              {"columns": ts, "split": list(ck.strided_split(n, S, F)),
               "threads": t, "smem_bytes": smem,
               "blocks_per_sm": ck.strided_occupancy(n, S, F)})
    B, ny, nz = F64_CUBE
    c, t, smem = ck.pair_layout(ny, nz, F)
    clusters, blocks = ck.pair_occupancy(ny, nz, F)
    timed("fft_pair", F64_CUBE, lambda r, m: ck.fft_pair(r, m),
          lambda r, m: ck.fft_pair_plain(r, m, False),
          lambda c: torch.fft.fft2(c), ny * nz,
          {"cluster": c, "threads": t, "smem_bytes": smem,
           "splits": ck.pair_splits(ny, nz, F),
           "resident_clusters": clusters, "blocks_per_sm": blocks})

    from vkfft_tpu_torch.precision import doubledouble as ddm
    e2e = []
    for name, shape in _f64_rows():
        cube = len(shape) == 3
        xr, xi = _planes64(shape, 11, dev)
        xc = torch.complex(xr, xi)
        xp = vt.Planar(xr, xi)
        app = vt.FFTApplication(vt.FFTConfig(
            shape=shape if cube else shape[1:], normalize=True,
            precision=vt.Precision.DOUBLE))
        xd = ddm.ddc_from_complex128(xc)
        points = math.prod(shape)
        passes = 4 if cube else 2
        bound, by = _f64_bound(points, shape[-1], passes)
        # the main path's form: complex128 tensors, split into float64
        # planes and joined again around the kernels (the cube through
        # fftn / ifftn, as the main path runs it)
        native = ((lambda: vt.ifftn(vt.fftn(xc))) if cube else
                  (lambda: app.inverse(app.forward(xc))))
        lib = ((lambda: torch.fft.ifftn(torch.fft.fftn(xc))) if cube else
               (lambda: torch.fft.ifft(torch.fft.fft(xc))))

        def dd_tensor():   # the dd route on the same tensor: DOUBLE's
            # route for complex128 tensors before the fp64 kernels
            return ddm.ddc_to_complex128(app.inverse(app.forward(
                ddm.ddc_from_complex128(xc))))
        row = {"row": name, "shape": list(shape), "route": app.double_route,
               "ms": _time_ms(native),
               "planar_ms": _time_ms(lambda: app.inverse(app.forward(xp))),
               "bound_ms": bound, "bound_by": by,
               "host_enqueue_ms": _host_ms(native),
               "torch_fft_c128_ms": _time_ms(lib),
               "dd_ms": _time_ms(lambda: app.inverse(app.forward(xd))),
               "dd_tensor_ms": _time_ms(dd_tensor),
               "passes_per_dir": passes // 2}
        row["GBs"] = passes * 32.0 * points / row["ms"] / 1e6
        row["roofline_share"] = bound / row["ms"]
        row["planar_roofline_share"] = bound / row["planar_ms"]
        row["vs_torch_fft"] = row["torch_fft_c128_ms"] / row["ms"]
        row["vs_dd_tensor"] = row["dd_tensor_ms"] / row["ms"]
        row["planar_vs_dd"] = row["dd_ms"] / row["planar_ms"]
        _log(f"[time] e2e f64 {row}")
        e2e.append(row)
        del xr, xi, xc, xp, xd
        torch.cuda.empty_cache()
    return {"kernels": kernels, "e2e": e2e}


# ---------------------------------------------------------------------------
# The storage tiers (Precision.HALF / BFLOAT16): the half-storage
# instantiations of every C2C kernel, the tiers' routes, main path and
# times.
# ---------------------------------------------------------------------------

STORAGE = {"bf16": torch.bfloat16, "f16": torch.float16}
STORAGE_TIER = {"bf16": "BFLOAT16", "f16": "HALF"}
# a kernel against its plain version: 2 storage ulps of max|plain| (unit
# roundoff 2^-8 of bf16, 2^-11 of fp16; both round once from fp32 values
# whose sums ran in other orders)
STORAGE_KERNEL_TOL = {"bf16": 8e-3, "f16": 1e-3}
# against fp64: the reference's gates (vkfft_tpu/cli.py:845, :1023)
STORAGE_NUMPY_TOL = {"bf16": 8e-2, "f16": 1e-2}
# a route that narrows several times a direction (Rader, Bluestein, SPLIT,
# the long tier: after each kernel and each glue step) against the CPU's
# torch engine, which narrows once an axis pass: 4 storage ulps of
# max|ref|, as the CPU tests hold the port to the JAX package
STORAGE_ROUTE_TOL = {"bf16": 1.6e-2, "f16": 2e-3}
STORAGE_BYTES = 128 * 1024 * 1024   # sample 2: batch 128 MiB / (4 n)
STORAGE_GUARD = 1 << 12             # sentinel halves each side of an output
STORAGE_REPEATS = 3                 # guarded launches of each case
STORAGE_REF_LINES = 512             # lines of a 1-D row held to the CPU
SAMPLE_13 = (64, 256, 1024)
SAMPLE_1002 = (8, 16, 32, 64, 128, 256, 512, 1024, 60, 100, 360)


def _storage_planes(shape, seed, dev, dt):
    return tuple(t.to(dt) for t in _planes(shape, seed, dev))


def _storage_rel(y, p) -> tuple:
    """(max|y - p| / max|p| over both planes, max|y - p|), in fp32, after
    asserting every value of y is finite (an inf or nan is a failure,
    never a tolerance miss)."""
    y = [t.float() for t in y]
    p = [t.float() for t in p]
    assert all(bool(torch.isfinite(t).all()) for t in y), "inf or nan"
    err = max((a - b).abs().max().item() for a, b in zip(y, p))
    return err / max(b.abs().max().item() for b in p), err


def _at_offset(x, offset):
    """Half planes x copied to views ``offset`` halves into buffers of
    their own (1..3: off the planes' 8-byte groups)."""
    if not offset:
        return x
    dt, numel, shape = x[0].dtype, x[0].numel(), x[0].shape
    pad = torch.zeros((2, offset + numel), dtype=dt, device=x[0].device)
    src = tuple(pad[i, offset:].view(shape) for i in range(2))
    src[0].copy_(x[0])
    src[1].copy_(x[1])
    return src


def _storage_guarded(call, x, offset):
    """One launch ``call(*planes, out=...)`` on half planes x, its output
    inside a buffer of sentinels (STORAGE_GUARD halves on each side, and
    ``offset`` more before: 1..3 leave a plane off its 8-byte groups, the
    input copied at the same offset): (the output, the guard cells the
    launch changed)."""
    dt, numel, shape = x[0].dtype, x[0].numel(), x[0].shape
    lead = STORAGE_GUARD + offset
    buf = torch.full((2, lead + numel + STORAGE_GUARD), 12345.0, dtype=dt,
                     device=x[0].device)
    sentinel = buf[0, 0].clone()
    y = tuple(buf[i, lead:lead + numel].view(shape) for i in range(2))
    got = call(*_at_offset(x, offset), out=y)
    changed = (int((buf[:, :lead] != sentinel).sum())
               + int((buf[:, lead + numel:] != sentinel).sum()))
    return got, changed


def _storage_cases(ck):
    """(kernel, shape, inverse, extra keywords, in place) of storage_kernels:
    every layout class of the four kernels at the main path's widths."""
    cases = [("fft_lines", (65536, 256), False, {}, False),     # one pass
             ("fft_lines", (16384, 1024), True, {}, False),     # two factors
             ("fft_lines", (4096, 4096), False, {}, True),
             ("fft_lines", (8193, 8192), True, {}, False),      # one a block
             ("fft_lines", (1001, 60), False, {}, False),       # a block shared
             ("fft_lines", (1001, 100), True, {}, False),
             ("fft_lines", (1001, 360), False, {}, True),
             ("fft_lines", (333, 47), True, {}, False),         # odd: heads
             ("fft_lines", (77, 1001), False, {}, False),       # generic stages
             ("fft_twofactor", (1638, 10240), False, {}, False),
             ("fft_twofactor", (1638, 10240), True, {}, True),
             ("fft_twofactor", (1638, 10240), False, {"swapped": True},
              False),
             ("fft_twofactor", (1638, 10240), True, {"swapped": True}, False),
             ("fft_twofactor", (333, 113), False, {}, False),   # a prime
             ("fft_strided", (1, 256, 65536), False, {}, False),
             ("fft_strided", (3, 64, 33), True, {}, False),     # S odd
             ("fft_strided", (2, 4096, 40), False, {}, False),
             ("fft_strided", (1, 8192, 24), True, {}, False),
             ("fft_strided", (4, 256, 256), False, {}, True),
             ("fft_pair", (256, 256, 256), False, {}, False),   # cluster 16
             ("fft_pair", (256, 256, 256), True, {}, True),
             ("fft_pair", (37, 16, 64), True, {}, False)]       # one block
    assert ck.pair_layout(256, 256)[0] == 16 and ck.pair_layout(16, 64)[0] == 1
    return cases


def _storage_route_cases(ck, dev):
    """(kernel, what, input shape, call(re, im, out=None), plain(re, im),
    guarded, in place) of storage_kernels for the kernels of the tiers'
    Rader, Bluestein, SPLIT and long routes, every layout class at the main
    path's shapes: fft_strided_tw natural with pre and post factors (S odd
    too: single halves), stored and read transposed, written and read
    interleaved, a Bluestein plane read from its line's n points and
    written back to n (out_len < n S); fft_conv's scalar (Rader 5003, and
    131 for lines sharing a block), Bluestein and rows (the long
    Bluestein's 384) modes; fft_conv_inv at 7918 with and without the x0
    term, and at 134 (lines sharing a block); fft_conv_pair's Bluestein
    mode at 10007.  A case is guarded where the wrapper takes an ``out`` of
    the input's shape; the others run on inputs at the same offsets and
    write fresh planes."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    N, nb = LONG_ROW_N, LONG_BLUESTEIN_N
    nc, ns = ck.long_split(N)
    na3, nb3, ns3 = ck.long_split(1 << 24)
    mb = plan_axis(nb).decomp.bluestein_size
    bc, bs = ck.bluestein_long_split(mb)
    cases = []

    def strided(what, shape, inverse, scale, guarded, in_place, **kw):
        cases.append(("fft_strided_tw", what, shape,
                      lambda r, i, out=None: ck.fft_strided(
                          r, i, inverse, scale, out=out, **kw),
                      lambda r, i: ck.fft_strided_plain(r, i, inverse, scale,
                                                        **kw),
                      guarded, in_place))

    strided("natural, pre and post", (8, nc, ns), False, 1.0, True, True,
            pre=ck.twiddle(N, True), post=ck.twiddle(N))
    strided("natural, post, S odd", (3, 64, 33), True, 1 / 64, True, False,
            post=ck.twiddle(64 * 33))
    strided("stored transposed, post", (8, nc, ns), False, 1.0, False, False,
            post=ck.twiddle(N), out_transposed=True)
    strided("read transposed, pre", (8, ns, nc), True, 1 / N, False, False,
            pre=ck.twiddle(N, True), in_transposed=True)
    strided("written interleaved", (nb3, ns3, na3), False, 1.0, False, False,
            out_interleave=nb3)
    strided("read interleaved", (nb3, ns3, na3), True, 1 / ns3, False, False,
            in_interleave=nb3)
    strided("Bluestein plane from n points", (8, nb), False, 1.0, False,
            False, pre=ck.chirp(nb), post=ck.twiddle(mb), plane=(bc, bs))
    strided("Bluestein plane to n points", (8, mb), True, 1 / nb, False,
            False, pre=ck.twiddle(mb, True), post=ck.chirp(nb),
            plane=(bc, bs), out_len=nb)

    def conv(name, what, shape, *tables, dc=None, in_place=True):
        call = getattr(ck, name)
        plain = getattr(ck, name + "_plain")
        kw = {} if dc is None else {"dc": dc}
        cases.append((name, what, shape,
                      lambda r, i, out=None: call(r, i, *tables, out=out,
                                                  **kw),
                      lambda r, i: plain(r, i, *tables, **kw), True,
                      in_place))

    conv("fft_conv", "scalar, Rader 5003", (2 * _sample_7_batch(10006), 5002),
         ck.rader_spectrum(5003, 1.0, dev))
    conv("fft_conv", "scalar, Rader 131 (lines share a block)", (333, 130),
         ck.rader_spectrum(131, 1.0, dev), in_place=False)
    conv("fft_conv", "Bluestein 1006 in 2016", (2000, 1006),
         ck.bluestein_spectrum(1006, 2016, False, 1.0, dev),
         ck.bluestein_chirp(1006, 2016, False, dev))
    conv("fft_conv", "rows, the long Bluestein's", (8 * bc, bs),
         ck.bluestein_spectrum(nb, mb, False, 1.0, dev, "long"))
    B = _sample_7_batch(7919)
    g = torch.Generator(device=dev).manual_seed(7)
    dc = tuple(torch.randn(B, generator=g, device=dev) for _ in range(2))
    sw = ck.rader_spectrum(7919, 1.0 / 7919, dev, "swapped")
    conv("fft_conv_inv", "7918 with x0", (B, 7918), sw, dc=dc)
    conv("fft_conv_inv", "7918 without x0", (B, 7918), sw, in_place=False)
    conv("fft_conv_inv", "134 with x0 (lines share a block)", (333, 134),
         torch.randn(134, 2, generator=g, device=dev),
         dc=tuple(torch.randn(333, generator=g, device=dev)
                  for _ in range(2)))
    m = plan_axis(10007).decomp.bluestein_size
    conv("fft_conv_pair", "Bluestein 10007", (_sample_7_batch(10007), 10007),
         ck.bluestein_spectrum(10007, m, False, 1.0, dev, "pair"),
         ck.bluestein_chirp(10007, m, False, dev))
    assert ck.conv_pair_layout(m)[2] > 1    # a cluster of blocks
    return cases


# the layout classes of fft_conv_pair's 2-D mode (phase_conv_kernels_vs_
# plain's planes: clusters of 1 to 16, odd and even column tiles, an axis
# of two factors either way) and the main path's 256 x 256 planes with one
# shared spectrum and 32 per-slice ones
CONV2D_STORAGE_PLANES = ((2, 2), (3, 5), (8, 8), (16, 60), (64, 64),
                         (100, 128), (128, 128), (81, 81), (47, 60),
                         (256, 512), (512, 256), (4096, 2), (2, 8064),
                         (8064, 2))


def _storage_conv_cases(ck, dev):
    """(kernel, what, input shape, call(re, im, out=None), plain(re, im),
    guarded, in place) of storage_kernels for the fused convolutions' half
    entries: fft_conv_pair's 2-D mode (``vk_fft_conv2d_<dtype>``) on every
    layout class of CONV2D_STORAGE_PLANES and the main path's 256 x 256
    planes (hp = 1 and 32), the flag combinations in turn; fft_conv's
    scalar, matrix (mm = 2 and 3) and rows modes at the main path's shapes
    with their flags (the v3_1d, v3_mat and v3_rows modes on half
    planes)."""
    flags = [dict(conj_data=c, xpow=x) for c in (False, True)
             for x in (False, True)]
    g = torch.Generator(device=dev).manual_seed(17)
    cases = []

    def add(name, what, shape, L, kw, scale, in_place):
        spec = torch.randn((L, 2), generator=g, device=dev)
        call = ck.fft_conv_pair if name == "fft_conv2d" else ck.fft_conv
        plain = (ck.fft_conv_pair_plain if name == "fft_conv2d"
                 else ck.fft_conv_plain)
        cases.append((name, f"{what} {kw}", shape,
                      lambda r, i, out=None: call(r, i, spec, None, out=out,
                                                  scale=scale, **kw),
                      lambda r, i: plain(r, i, spec, None, scale=scale,
                                         **kw), True, in_place))

    for i, (ny, nz) in enumerate(CONV2D_STORAGE_PLANES):
        assert ck.pair_cluster(ny, nz) is not None, (ny, nz)
        hp = (1, 3)[i % 2]
        add("fft_conv2d", f"2-D hp={hp} {ny}x{nz}", (3 * hp, ny, nz),
            hp * ny * nz, flags[i % 4], 1.0 / (ny * nz), i % 3 == 0)
    for hp, kw in ((1, flags[0]), (32, flags[3])):
        add("fft_conv2d", f"2-D hp={hp} 256x256x256", CUBE, hp * 256 * 256,
            kw, 2.0 ** -16, hp == 1)
    add("fft_conv", "scalar 4096x4096", (4096, 4096), 4096, flags[3],
        1.0 / 4096, True)
    add("fft_conv", "matrix 3 5461x1024", (5461, 3, 1024), 9 * 1024,
        flags[0], 1.0 / 1024, True)
    add("fft_conv", "matrix 2 n=256", (5, 2, 256), 4 * 256, flags[1],
        1.0 / 256, False)
    add("fft_conv", "rows 512 32768x512", (32768, 512), 512 * 512, flags[2],
        2.0 ** -18, False)
    return cases


def phase_storage_kernels(ck, dev) -> dict:
    """The half-storage instantiations of every C2C kernel and of the fused
    convolutions against their plain versions (the same half planes
    widened to fp32, computed, narrowed once) at both dtypes, on every
    layout class (`_storage_cases`, `_storage_route_cases`,
    `_storage_conv_cases`): each case STORAGE_REPEATS times at half
    offsets 0, 1 and 3 (the later two off the planes' 8-byte groups: the
    single-half spans), its output inside sentinel guards where the wrapper
    takes one, <= STORAGE_KERNEL_TOL of max|plain| with no inf or nan and
    no write outside the output; the in-place cases also written over their
    input, equal to the out-of-place result bit for bit."""
    out = {k: [] for k in ck.STORAGE_ENTRIES}
    worst = {}
    for tag, dt in STORAGE.items():
        tol = STORAGE_KERNEL_TOL[tag]
        for i, (name, shape, inv, kw, in_place) in enumerate(
                _storage_cases(ck)):
            n = shape[-1] if name in ("fft_lines", "fft_twofactor") else (
                shape[1] if name == "fft_strided" else shape[1] * shape[2])
            sc = 1.0 / n if inv else 1.0
            call = getattr(ck, name)
            plain = getattr(ck, name + "_plain")
            x = _storage_planes(shape, i + 7, dev, dt)
            ref = plain(*x, inv, sc, **kw)
            row = {"dtype": tag, "case": [list(shape), inv, kw],
                   "rel_err": [], "guard_cells_changed": []}
            for r, offset in zip(range(STORAGE_REPEATS), (0, 1, 3)):
                y, changed = _storage_guarded(
                    lambda a, b, out: call(a, b, inv, sc, out=out, **kw),
                    x, offset)
                rel, err = _storage_rel(y, ref)
                assert y[0].dtype == dt, (name, shape)
                assert rel <= tol and changed == 0, (name, tag, shape, inv,
                                                     kw, offset, rel, changed)
                row["rel_err"].append(rel)
                row["guard_cells_changed"].append(changed)
                row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
            if in_place:
                y = call(*x, inv, sc, **kw)
                c = tuple(t.clone() for t in x)
                call(*c, inv, sc, out=c, **kw)
                assert all(torch.equal(a, b) for a, b in zip(c, y)), (
                    name, tag, shape)
                row["in_place_equal"] = True
            torch.cuda.synchronize()
            key = f"{name}_{tag}"
            worst[key] = max(worst.get(key, 0.0), max(row["rel_err"]))
            out[name].append(row)
            del x, ref
        for i, (name, what, shape, call, plain, guarded, in_place) in \
                enumerate(_storage_route_cases(ck, dev)
                          + _storage_conv_cases(ck, dev)):
            x = _storage_planes(shape, i + 101, dev, dt)
            ref = plain(*x)
            row = {"dtype": tag, "case": what, "shape": list(shape),
                   "guarded": guarded, "rel_err": [],
                   "guard_cells_changed": []}
            for r, offset in zip(range(STORAGE_REPEATS), (0, 1, 3)):
                if guarded:
                    y, changed = _storage_guarded(call, x, offset)
                else:
                    y, changed = call(*_at_offset(x, offset)), 0
                rel, err = _storage_rel(y, ref)
                assert y[0].dtype == dt, (name, what)
                assert rel <= tol and changed == 0, (name, what, tag,
                                                     offset, rel, changed)
                row["rel_err"].append(rel)
                row["guard_cells_changed"].append(changed)
                row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
            if in_place:
                y = call(*x)
                c = tuple(t.clone() for t in x)
                call(*c, out=c)
                assert all(torch.equal(a, b) for a, b in zip(c, y)), (
                    name, what, tag)
                row["in_place_equal"] = True
            torch.cuda.synchronize()
            key = f"{name}_{tag}"
            worst[key] = max(worst.get(key, 0.0), max(row["rel_err"]))
            out[name].append(row)
            del x, ref
    counts = {k: len(v) for k, v in out.items()}
    _log(f"[storage] cases {counts}, worst vs plain {worst} (tolerances "
         f"{STORAGE_KERNEL_TOL})")
    return {"cases": out, "counts": counts, "worst_vs_plain": worst}


def _storage_launch_check(ck, torch_engine, tag, want, what, fp32=None):
    """The launches since the last reset: exactly ``want`` ({kernel:
    count}) of the ``tag`` instantiations and ``fp32`` of the fp32 kernels
    (none by default; a half real transform runs both: its C2C at the half
    dtype, the widened inverse or the complex axes after the untangle in
    fp32), no other launch, no call of the plain engine.  Returns the
    half launches by kernel."""
    fp32 = fp32 or {}
    sfx = "_" + tag
    got = {k[:-len(sfx)]: v for k, v in ck.storage_launches.items()
           if k.endswith(sfx)}
    others = {k: v for k, v in ck.storage_launches.items()
              if not k.endswith(sfx) and v}
    assert got == {k: want.get(k, 0) for k in got}, (what, got)
    assert dict(ck.launches) == {k: fp32.get(k, 0) for k in ck.launches}, (
        what, ck.launches)
    assert not others and sum(ck.f64_launches.values()) == 0, (
        what, others, ck.f64_launches)
    assert torch_engine.calls == 0, (what, torch_engine.calls)
    return got


# the tiers' Rader (on fft_twofactor + fft_conv_inv; on fft_conv),
# Bluestein (on fft_conv_pair), SPLIT and two-upload long routes
STORAGE_ROUTE_LENGTHS = (7919, 10007, 10006, 5003, 1 << 17)


def _route_launches(ce, n) -> dict:
    """{kernel: launches} of a forward and an inverse of length n: each
    direction the kernels `cuda_engine.route` names."""
    import collections
    from vkfft_tpu_torch.planner.plan import plan_axis
    return dict(collections.Counter(
        2 * [k for k, _, _ in ce.route(plan_axis(n))]))


# real lengths of the half real routes: fft_r2c's 1024 (one half fft_lines
# of 512 forward, one fp32 fft_c2r back), Rader's half length 10006 (5003)
# and the long tier's 2^18 (2^17), forward and inverse each on the route of
# n/2; and a (4, 64, 128, 96) volume through rfftn / irfftn
STORAGE_REAL_LENGTHS = (1024, 10006, 1 << 18)
STORAGE_REAL_VOLUME = (4, 64, 128, 96)


def _half_real_launches(ce, ck, shape):
    """The launches of a half real round trip over every axis but the
    first of ``shape`` (the others' lengths DIRECT ones `fft_strided`
    takes): ((half, fp32) of the forward, (half, fp32) of the inverse of
    its spectrum narrowed to the tier), each {kernel: launches}.  The
    forward runs the n/2-point C2C's route at the half dtype and the
    complex axes in fp32 `fft_strided`; the inverse the complex axes in
    half `fft_strided` and the real axis widened: fp32 `fft_c2r` where
    `r2c_supports` holds, else the fp32 route of n/2."""
    import collections
    from vkfft_tpu_torch.planner.plan import plan_axis
    n = shape[-1]
    c2c = dict(collections.Counter(
        k for k, _, _ in ce.route(plan_axis(n // 2))))
    outer = {"fft_strided": len(shape) - 2} if len(shape) > 2 else {}
    real = {"fft_r2c": 1} if ck.r2c_supports(n) else c2c
    return (c2c, outer), (outer, real)


def _half_real_round_trip(vt, ck, ce, torch_engine, tag, x):
    """rfft (rfftn over every axis but the first, for more than one) of
    half real data ``x`` as a Planar, then irfft (irfftn) of its spectrum
    narrowed to the tier, each counted from 0 and held to its exact
    launches (`_half_real_launches`) with no plain-engine call: (spectrum,
    narrowed spectrum, output, launches)."""
    dt = STORAGE[tag]
    axes = tuple(range(1, x.ndim))
    fwd, inv = _half_real_launches(ce, ck, x.shape)

    def held(want, what):
        """The (half, fp32) launches of one direction, held to ``want``."""
        half = _storage_launch_check(ck, torch_engine, tag, want[0],
                                     (tuple(x.shape), what), want[1])
        return ({k: v for k, v in half.items() if v},
                {k: v for k, v in ck.launches.items() if v})

    if x.ndim == 2:
        forward = lambda: vt.rfft(vt.Planar(x, x))
        inverse = lambda X: vt.irfft(X, n=x.shape[1])
    else:
        forward = lambda: vt.rfftn(vt.Planar(x, x), axes=axes)
        inverse = lambda X: vt.irfftn(X, s=x.shape[1:], axes=axes)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch_engine.calls = 0
    X = forward()
    torch.cuda.synchronize()
    got_f = held(fwd, "forward")
    Xh = X.astype(dt)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch_engine.calls = 0
    y = inverse(Xh)
    torch.cuda.synchronize()
    got_i = held(inv, "inverse")
    assert X.dtype == torch.float32 and y.dtype == torch.float32, x.shape
    assert _finite(X) and bool(torch.isfinite(y).all()), x.shape
    return X, Xh, y, {"forward": got_f, "inverse": got_i}


def _storage_real_routes(vt, ck, ce, torch_engine, dev) -> list:
    """Half real transforms at both tiers on the card: rfft of half lines
    at STORAGE_REAL_LENGTHS (float32 planes out, the C2C on the half
    instantiations) and irfft of the spectrum narrowed to the tier
    (widened, in fp32, float32 out), and rfftn / irfftn of
    STORAGE_REAL_VOLUME (the real axis on half fft_lines, the complex axes
    in fp32 after the untangle; back the complex axes in half fft_strided,
    each with its own 1/n, and the real axis in fp32 fft_c2r); each call
    held to its exact launches (`_half_real_round_trip`), within the
    reference's gates of torch.fft on the narrowed input (the inverse: of
    the narrowed spectrum)."""
    rows = []
    cases = [(f"1d_n{n}", (4, n)) for n in STORAGE_REAL_LENGTHS]
    cases.append(("3d_" + "x".join(map(str, STORAGE_REAL_VOLUME[1:])),
                  STORAGE_REAL_VOLUME))
    for tag, dt in STORAGE.items():
        for name, shape in cases:
            x = _storage_planes(shape, shape[-1], dev, dt)[0]
            X, Xh, y, got = _half_real_round_trip(vt, ck, ce, torch_engine,
                                                  tag, x)
            dims = tuple(range(1, len(shape)))
            xw = x.double()
            e_f = _rel(vt.to_complex(X).cdouble(),
                       torch.fft.rfftn(xw, dim=dims))
            Xw = torch.complex(Xh.re.double(), Xh.im.double())
            e_i = _rel(y.double(), torch.fft.irfftn(Xw, s=shape[1:],
                                                    dim=dims))
            e_rt = _rel(y.double(), xw)
            row = {"row": name, "dtype": tag, "shape": list(shape),
                   "launches": got, "rel_err_fwd_vs_fp64": e_f,
                   "rel_err_inv_vs_fp64": e_i, "rel_err_round_trip": e_rt}
            _log(f"[storage routes] real {row}")
            assert max(e_f, e_i, e_rt) <= STORAGE_NUMPY_TOL[tag], row
            rows.append(row)
            del x, xw, X, Xh, Xw, y
    return rows


# (config shape, flags, fusion mode, half launches of one call) of the
# fused modes on half planes: each mode and flag at small shapes
STORAGE_CONV_ROUTES = (
    ((4096,), dict(conjugate_convolution=1), "v3_1d", {"fft_conv": 1}),
    ((1000,), dict(conjugate_convolution=2,
                   cross_power_spectrum_normalization=True), "v3_1d",
     {"fft_conv": 1}),
    ((256,), dict(matrix_convolution=2, coordinate_features=2), "v3_mat",
     {"fft_conv": 1}),
    ((1024,), dict(matrix_convolution=3, coordinate_features=3), "v3_mat",
     {"fft_conv": 1}),
    ((512, 512), {}, "v3_rows", {"fft_strided": 2, "fft_conv": 1}),
    ((256, 256), {}, "pair", {"fft_conv2d": 1}),
    ((96, 60), dict(conjugate_convolution=1), "pair", {"fft_conv2d": 1}),
    ((128, 128), dict(cross_power_spectrum_normalization=True), "pair",
     {"fft_conv2d": 1}),
    ((4, 64, 128), {}, "pair", {"fft_strided": 2, "fft_conv2d": 1}),
    ((10240,), {}, "v2_2k", {"fft_twofactor": 1, "fft_conv_inv": 1}),
    ((12288,), dict(conjugate_convolution=1), "v2_2k",
     {"fft_twofactor": 1, "fft_conv_inv": 1}))


def _storage_conv_routes(vt, ck, torch_engine, dev) -> list:
    """Every fused convolution mode on half planes at both tiers
    (STORAGE_CONV_ROUTES), batch 2, a unit-variance kernel: exactly the
    half launches of its mode, no other, no plain-engine call; the output
    of the data's dtype, finite, within the reference's gates of numpy
    fp64 of the narrowed planes; the input left unchanged."""
    rows = []
    for i, (shape, flags, mode, want) in enumerate(STORAGE_CONV_ROUTES):
        cfg = vt.FFTConfig(shape=shape, convolution=True, **flags)
        kshape, xshape = _conv_shapes(cfg, 2)
        rng = np.random.default_rng(720 + i)
        h = (rng.standard_normal(kshape)
             + 1j * rng.standard_normal(kshape)).astype(np.complex64)
        app = vt.ConvolutionApplication(cfg, h, device=dev)
        assert app.fusion_mode == mode, (shape, flags, app.fusion_mode)
        for tag, dt in STORAGE.items():
            x = vt.Planar(*_storage_planes(xshape, 740 + i, dev, dt))
            keep = x.re.clone()
            torch.cuda.synchronize()
            ck.reset_launches()
            torch_engine.calls = 0
            y = app(x)
            torch.cuda.synchronize()
            got = _storage_launch_check(ck, torch_engine, tag, want,
                                        (shape, flags))
            assert y.dtype == dt and y.shape == x.shape and _finite(y)
            assert torch.equal(x.re, keep), (shape, flags)
            rel = _numpy_rel(_cplx(y), _conv_oracle(cfg, _cplx(x), h))
            row = {"shape": list(shape), "flags": str(flags), "mode": mode,
                   "dtype": tag, "launches": {k: v for k, v in got.items()
                                              if v},
                   "rel_err_vs_numpy": rel}
            _log(f"[storage routes] conv {row}")
            assert rel <= STORAGE_NUMPY_TOL[tag], row
            rows.append(row)
            del x, y, keep
    return rows


def phase_storage_routes(vt, ck, ce, torch_engine, dev) -> dict:
    """The tiers' routes: Rader 7919 and 5003, Bluestein 10007, SPLIT
    10006 and the long tier's 2^17 under HALF and BFLOAT16, forward and
    normalized inverse, each with exactly the half launches its route
    names (no fp32 or fp64 launch, no plain-engine call), finite, within
    the reference's gates of torch.fft on the narrowed input; half real
    transforms and every fused convolution mode on half planes
    (`_storage_real_routes`, `_storage_conv_routes`); every DIRECT length
    of samples 2, 13 and 1002 runs its forward and normalized inverse on
    the half-storage fft_lines (two launches, no other, no plain-engine
    call), within the reference's gates of torch.fft on the narrowed
    input."""
    rows = []
    for n in STORAGE_ROUTE_LENGTHS:
        want = _route_launches(ce, n)
        for tag, dt in STORAGE.items():
            app = vt.FFTApplication(vt.FFTConfig(
                shape=(n,), normalize=True,
                precision=vt.Precision[STORAGE_TIER[tag]]))
            x = vt.Planar(*_planes((4, n), n, dev))
            torch.cuda.synchronize()
            ck.reset_launches()
            torch_engine.calls = 0
            y = app.forward(x)
            z = app.inverse(y)
            torch.cuda.synchronize()
            _storage_launch_check(ck, torch_engine, tag, want, n)
            xn = torch.complex(x.re.to(dt).float(), x.im.to(dt).float())
            assert y.dtype == z.dtype == dt and _finite(y, z), (n, tag)
            e_f = _rel(vt.to_complex(y), torch.fft.fft(xn.cdouble()).cfloat())
            e_rt = _rel(vt.to_complex(z), xn)
            assert max(e_f, e_rt) <= STORAGE_NUMPY_TOL[tag], (n, tag, e_f,
                                                              e_rt)
            rows.append({"n": n, "dtype": tag, "launches": want,
                         "rel_err_fwd": e_f, "rel_err_round_trip": e_rt})
    real = _storage_real_routes(vt, ck, ce, torch_engine, dev)
    conv = _storage_conv_routes(vt, ck, torch_engine, dev)
    lengths = sorted(set(ROWS_1D) | set(SAMPLE_13) | set(SAMPLE_1002))
    for n in lengths:
        for tag, dt in STORAGE.items():
            app = vt.FFTApplication(vt.FFTConfig(
                shape=(n,), normalize=True,
                precision=vt.Precision[STORAGE_TIER[tag]]))
            x = vt.Planar(*_planes((4, n), n, dev))
            torch.cuda.synchronize()
            ck.reset_launches()
            torch_engine.calls = 0
            y = app.forward(x)
            z = app.inverse(y)
            torch.cuda.synchronize()
            _storage_launch_check(ck, torch_engine, tag, {"fft_lines": 2}, n)
            xn = torch.complex(x.re.to(dt).float(), x.im.to(dt).float())
            e_f = _rel(vt.to_complex(y), torch.fft.fft(xn.cdouble()).cfloat())
            e_rt = _rel(vt.to_complex(z), xn)
            assert y.dtype == z.dtype == dt, (n, tag)
            assert max(e_f, e_rt) <= STORAGE_NUMPY_TOL[tag], (n, tag, e_f,
                                                              e_rt)
            rows.append({"n": n, "dtype": tag, "rel_err_fwd": e_f,
                         "rel_err_round_trip": e_rt})
    worst = {tag: max(max(r["rel_err_fwd"], r["rel_err_round_trip"])
                      for r in rows if r["dtype"] == tag) for tag in STORAGE}
    _log(f"[storage routes] {len(rows)} rows on the storage kernels, worst "
         f"{worst}")
    return {"rows": rows, "worst": worst, "real": real, "conv": conv}


# the long rows of the tiers' main path (row, lines, n): the 2^20 row at
# 128 MiB of complex64, 2^22 (not folded: ns = 8192), sample 11's 2^24 and
# 2^26 (three uploads) and the fused long Bluestein at 65537
STORAGE_LONG_ROWS = (
    (f"1d_n{LONG_ROW_N}_x{LONG_ROW_LINES}", LONG_ROW_LINES, LONG_ROW_N),
    ("1d_n4194304_x4", TARGET_BYTES >> 25, 1 << 22),
    ("sample11_n16777216", 1, 1 << 24), ("sample11_n67108864", 1, 1 << 26),
    ("bluestein_n65537_x127", SAMPLE_7_BYTES // (8 * LONG_BLUESTEIN_N),
     LONG_BLUESTEIN_N))
# lines of a long or sample 7 row held to the CPU's torch engine: at most
# 2^22 points a line (a 2^24 or 2^26 line on the CPU takes minutes)
STORAGE_CPU_POINTS = 1 << 22


def _storage_rows(ce):
    """(row, tier, shape, config shape, launches of a forward and a
    normalized inverse) of the tiers' main path: sample 2's rows at 128
    MiB / (4 n) lines, sample 7's rows at its 64 MiB of complex64 (DIRECT
    10240, Bluestein 10007, Rader 7919, SPLIT 10006), the 256^3 cube (pair
    + strided), ex02's (16, 64) plane, sample 13's and sample 1002's
    systems, and the long rows (STORAGE_LONG_ROWS); the launches of the
    other routes those `cuda_engine.route` names."""
    rows = []
    for tag in STORAGE:
        for n in ROWS_1D:
            rows.append((f"sample2_n{n}", tag, (STORAGE_BYTES // (4 * n), n),
                         (n,), {"fft_lines": 2}))
        rows.append(("sample7_n10240", tag, (_sample_7_batch(10240), 10240),
                     (10240,), {"fft_twofactor": 2}))
        for n in (10007, 7919, 10006):
            rows.append((f"sample7_n{n}", tag, (_sample_7_batch(n), n), (n,),
                         _route_launches(ce, n)))
        rows.append(("3d_256^3", tag, CUBE, CUBE,
                     {"fft_pair": 2, "fft_strided": 2}))
        rows.append(("ex02_16x64", tag, (16, 64), (16, 64), {"fft_pair": 2}))
        for n in SAMPLE_13:
            rows.append((f"sample13_n{n}", tag, (4, n), (n,),
                         {"fft_lines": 2}))
        for n in SAMPLE_1002:
            rows.append((f"sample1002_n{n}", tag, (2, n), (n,),
                         {"fft_lines": 2}))
        for name, B, n in STORAGE_LONG_ROWS:
            rows.append((name, tag, (B, n), (n,), _route_launches(ce, n)))
    return rows


def phase_storage_main_path(vt, ck, ce, torch_engine, dev) -> dict:
    """The tiers' main path through FFTApplication(precision=BFLOAT16 /
    HALF, normalize=True) on float32 Planar input, which the application
    narrows (`_storage_rows`), then the half real rows through vt.rfft /
    vt.irfft and vt.rfftn / vt.irfftn (`_storage_real_row`) and the half
    convolution rows through ConvolutionApplication (`_storage_conv_row`):
    each row's forward and inverse counted from
    0 and held to its exact launches of the half-storage instantiations,
    no other launch and no plain-engine call; the results of the storage
    dtype, finite, the forward against fp64 (numpy for the small systems,
    torch.fft complex128 on the card for the rest) and the round trip
    against the narrowed input within the reference's gates, and both
    against the same call on the CPU's torch engine (the first
    STORAGE_REF_LINES lines of the 1-D rows, at most STORAGE_CPU_POINTS
    points of them; none of the 2^24 and 2^26 lines) within
    STORAGE_KERNEL_TOL, or STORAGE_ROUTE_TOL on a route of several
    roundings a direction."""
    from vkfft_tpu_torch.planner.factorize import Algorithm
    from vkfft_tpu_torch.planner.plan import plan_axis
    rows, by_row = [], {}
    for name, tag, shape, cfg_shape, want in _storage_rows(ce):
        dt = STORAGE[tag]
        prec = vt.Precision[STORAGE_TIER[tag]]
        app = vt.FFTApplication(vt.FFTConfig(shape=cfg_shape, normalize=True,
                                             precision=prec))
        x = vt.Planar(*_planes(shape, len(name), dev))
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        y = app.forward(x)
        z = app.inverse(y)
        torch.cuda.synchronize()
        got = _storage_launch_check(ck, torch_engine, tag, want, name)
        by_row[f"{name}_{tag}"] = dict(ck.storage_launches)
        assert y.dtype == z.dtype == dt and y.shape == z.shape == shape, name
        assert _finite(y, z), name
        xn = torch.complex(x.re.to(dt).float(), x.im.to(dt).float())
        dims = tuple(range(len(shape) - len(cfg_shape), len(shape)))
        small = math.prod(shape) <= 1 << 16
        if small:
            ref = np.fft.fftn(xn.cpu().numpy().astype(np.complex128),
                              axes=dims)
            e_f = float(np.abs(vt.to_numpy(y) - ref).max() / np.abs(ref).max())
        else:
            ref = torch.fft.fftn(xn.cdouble(), dim=dims)
            e_f = _rel(vt.to_complex(y).cdouble(), ref)
        e_rt = _rel(vt.to_complex(z), xn)
        del ref
        # the same call on the CPU's torch engine
        lines = shape[0]
        if len(cfg_shape) == 1:
            lines = min(STORAGE_REF_LINES, shape[0],
                        STORAGE_CPU_POINTS // shape[1])
        e_cf = e_cr = None
        if lines:
            cpu = vt.FFTApplication(vt.FFTConfig(
                shape=cfg_shape, normalize=True, precision=prec),
                engine="torch", device="cpu")
            xc = vt.Planar(x.re[:lines].cpu(), x.im[:lines].cpu())
            yc = cpu.forward(xc)
            zc = cpu.inverse(yc)
            e_cf = _storage_rel((y.re[:lines].cpu(), y.im[:lines].cpu()),
                                (yc.re, yc.im))[0]
            e_cr = _storage_rel((z.re[:lines].cpu(), z.im[:lines].cpu()),
                                (zc.re, zc.im))[0]
            del xc, yc, zc
        row = {"row": name, "dtype": tag, "shape": list(shape),
               "launches": got, "rel_err_fwd_vs_fp64": e_f,
               "rel_err_round_trip": e_rt, "rel_err_fwd_vs_cpu_engine": e_cf,
               "rel_err_inv_vs_cpu_engine": e_cr,
               "cpu_engine_lines": lines if len(cfg_shape) == 1 else "all"}
        _log(f"[main storage] {row}")
        assert e_f <= STORAGE_NUMPY_TOL[tag], row
        assert e_rt <= STORAGE_NUMPY_TOL[tag], row
        single = all(plan_axis(k).algorithm is Algorithm.DIRECT
                     and k <= ck.TWOFACTOR_MAX_N for k in cfg_shape)
        cpu_tol = (STORAGE_KERNEL_TOL if single else STORAGE_ROUTE_TOL)[tag]
        row["cpu_engine_tol"] = cpu_tol
        assert not lines or max(e_cf, e_cr) <= cpu_tol, row
        rows.append(row)
        del x, y, z, xn
        torch.cuda.empty_cache()
    fp32_by_row = {}
    for tag in STORAGE:
        for name, shape in STORAGE_REAL_ROWS:
            t0 = time.perf_counter()
            row, half, fp32 = _storage_real_row(vt, ck, ce, torch_engine,
                                                dev, tag, name, shape)
            row["seconds"] = time.perf_counter() - t0
            by_row[f"{name}_{tag}"] = half
            fp32_by_row[f"{name}_{tag}"] = fp32
            rows.append(row)
        t0 = time.perf_counter()
        for name, cfg, app, x, want, h in _conv_paths(vt, dev,
                                                      STORAGE_CONV_ROWS):
            row, half = _storage_conv_row(vt, ck, torch_engine, tag, name,
                                          cfg, app, x, want, h)
            row["seconds"] = time.perf_counter() - t0
            by_row[f"conv_{name}_{tag}"] = half
            rows.append(row)
            del x, h, app
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
    totals = {k: sum(c[k] for c in by_row.values())
              for k in ck.storage_launches}
    _log(f"[main storage] launches over the path {totals}")
    assert all(v > 0 for v in totals.values()), totals
    return {"storage_launches": totals, "storage_launches_by_path": by_row,
            "fp32_launches_by_path": fp32_by_row,
            "plain_engine_calls": 0, "rows": rows}


# the half real rows of the tiers' main path: 128 MiB of half real lines
# of 1024 (65536 lines), and the real 256^3 cube
STORAGE_REAL_ROWS = (("r2c_1d_n1024_x65536", (65536, 1024)),
                     ("r2c_3d_256^3", (1,) + CUBE))
# the convolution rows of the tiers' main path (CONV_ROWS at half planes):
# sample 52's 256 planes of 256^2, v3_1d at 4096, sample 50's 3 x 3 matrix
# at 1024, v2_2k at 10240
STORAGE_CONV_ROWS = ("sample52_256x256", "v3_1d_n4096", "sample50_mat3_n1024",
                     "v2_2k_n10240")


def _storage_real_row(vt, ck, ce, torch_engine, dev, tag, name, shape):
    """One half real row of the main path through vt.rfft / vt.irfft (the
    cube: vt.rfftn / vt.irfftn), each direction counted from 0 and held to
    its exact launches with no plain-engine call (`_half_real_round_trip`):
    the forward against torch.fft fp64 of the narrowed input, the inverse
    against fp64 of the narrowed spectrum, the round trip against the
    input, all at the reference's gates, and both directions against the
    CPU's torch engine on the same half planes (the first
    STORAGE_REF_LINES lines of the 1-D row, the whole cube) within
    STORAGE_KERNEL_TOL: one rounding of the C2C's output a forward, fp32
    after it.  Returns (row, half launches by instantiation, fp32
    launches)."""
    dt = STORAGE[tag]
    x = _storage_planes(shape, len(name), dev, dt)[0]
    X, Xh, y, got = _half_real_round_trip(vt, ck, ce, torch_engine, tag, x)
    half = {k: 0 for k in ck.storage_launches}
    fp32 = {}
    for part in got.values():
        for k, v in part[0].items():
            half[f"{k}_{tag}"] += v
        for k, v in part[1].items():
            fp32[k] = fp32.get(k, 0) + v
    dims = tuple(range(1, len(shape)))
    xw = x.double()
    e_f = _rel(vt.to_complex(X).cdouble(), torch.fft.rfftn(xw, dim=dims))
    Xw = torch.complex(Xh.re.double(), Xh.im.double())
    e_i = _rel(y.double(), torch.fft.irfftn(Xw, s=shape[1:], dim=dims))
    e_rt = _rel(y.double(), xw)
    del xw, Xw
    lines = min(STORAGE_REF_LINES, shape[0])
    xc = x[:lines].cpu()
    Xhc = vt.Planar(Xh.re[:lines].cpu(), Xh.im[:lines].cpu())
    if len(shape) == 2:
        Xc = vt.rfft(vt.Planar(xc, xc), engine="torch")
        yc = vt.irfft(Xhc, n=shape[1], engine="torch")
    else:
        Xc = vt.rfftn(vt.Planar(xc, xc), axes=dims, engine="torch")
        yc = vt.irfftn(Xhc, s=shape[1:], axes=dims, engine="torch")
    e_cf = _storage_rel((X.re[:lines].cpu(), X.im[:lines].cpu()),
                        (Xc.re, Xc.im))[0]
    e_ci = _storage_rel((y[:lines].cpu(),), (yc,))[0]
    row = {"row": name, "dtype": tag, "shape": list(shape),
           "launches": got, "rel_err_fwd_vs_fp64": e_f,
           "rel_err_inv_vs_fp64": e_i, "rel_err_round_trip": e_rt,
           "rel_err_fwd_vs_cpu_engine": e_cf,
           "rel_err_inv_vs_cpu_engine": e_ci, "cpu_engine_lines": lines,
           "cpu_engine_tol": STORAGE_KERNEL_TOL[tag]}
    _log(f"[main storage] {row}")
    assert max(e_f, e_i, e_rt) <= STORAGE_NUMPY_TOL[tag], row
    assert max(e_cf, e_ci) <= STORAGE_KERNEL_TOL[tag], row
    del x, X, Xh, y, xc, Xhc, Xc, yc
    torch.cuda.empty_cache()
    return row, half, fp32


def _storage_conv_row(vt, ck, torch_engine, tag, name, cfg, app, x, want,
                      h):
    """One convolution row of the main path on half planes (the row's
    float32 data narrowed to the tier): counted from 0 and held to its
    exact half launches (the fp32 row's kernels, the 2-D mode as
    fft_conv2d) with no plain-engine call; the output of the data's dtype
    and finite; two items at seeded positions against numpy fp64 of the
    narrowed items at the reference's gates and against the CPU's torch
    engine (the composition on the same half items: the forward at the
    half dtype, the product and the inverse in fp32, narrowed once)
    within STORAGE_ROUTE_TOL.  Returns (row, half launches by
    instantiation)."""
    dt = STORAGE[tag]
    want = {("fft_conv2d" if k == "fft_conv_pair" else k): v
            for k, v in want.items()}
    x = x.astype(dt)
    pick = sorted(np.random.default_rng(len(name)).choice(
        x.shape[0], 2, replace=False).tolist())
    torch.cuda.synchronize()
    ck.reset_launches()
    torch_engine.calls = 0
    y = app(x)
    torch.cuda.synchronize()
    got = _storage_launch_check(ck, torch_engine, tag, want, name)
    half = dict(ck.storage_launches)
    assert y.dtype == dt and y.shape == x.shape and _finite(y), name
    xs = vt.Planar(x.re[pick], x.im[pick])
    ref = _conv_oracle(cfg, _cplx(xs), _cplx(h))
    e_np = _numpy_rel(_cplx2(y.re[pick], y.im[pick]), ref)
    cpu = vt.ConvolutionApplication(
        cfg, vt.Planar(h.re.cpu(), h.im.cpu()), engine="torch", device="cpu")
    yc = cpu(vt.Planar(xs.re.cpu(), xs.im.cpu()))
    assert yc.dtype == dt, name
    e_cpu = _storage_rel((y.re[pick].cpu(), y.im[pick].cpu()),
                         (yc.re, yc.im))[0]
    row = {"row": f"conv_{name}", "dtype": tag, "shape": list(x.shape),
           "mode": app.fusion_mode, "launches": {k: v for k, v in
                                                 got.items() if v},
           "items_checked": pick, "rel_err_vs_fp64": e_np,
           "rel_err_vs_cpu_engine": e_cpu,
           "cpu_engine_tol": STORAGE_ROUTE_TOL[tag]}
    _log(f"[main storage] {row}")
    assert e_np <= STORAGE_NUMPY_TOL[tag], row
    assert e_cpu <= STORAGE_ROUTE_TOL[tag], row
    del x, y, xs, yc
    return row, half


def _c32(x):
    """Half planes as one complex32 tensor (torch.fft's half C2C)."""
    return torch.view_as_complex(torch.stack([x[0].half(), x[1].half()],
                                             -1))


def phase_storage_times(vt, ck, dev) -> dict:
    """The half-storage kernels at the main path's shapes (held against
    their plain versions there, <= STORAGE_KERNEL_TOL) beside the bound (8
    B a point a pass, 2 B a real, over HBM; or 5 n log2 n over the fp32
    rate), the fp32 kernel on the same points, the plain time and
    torch.fft on complex32 (cuFFT's half C2C, computing in fp16: not the
    same function) where n is a power of two, each with registers and
    spills (ptxas), layout and blocks an SM; then the rows of PERF.md
    section 5, 1-D n = 256 / 1024 / 4096 at sample 2's batch and the 256^3
    cube, forward plus normalized inverse through FFTApplication at both
    tiers, beside the fp32 round trip on the same points, the bound, the
    host's enqueue time and torch.fft complex32; and fft_lines' point rate
    at n = 256 from 2^20 points (in L2) to 2^25, fp32 beside both half
    dtypes.  The half 2-D convolution (fft_conv_pair's 2-D mode, entries
    fft_conv2d_<dtype>) at sample 52's 256 planes of 256^2 beside its fp32
    twin, its bound at 2 B a real and the spectrum's fp32 once, and
    torch.fft's complex32 composition ifft2(fft2(x) * H); the half real and
    convolution rows' round trips and calls beside their fp32 ones."""
    _log(f"[time] card: {_smi()}")
    kernels = {f"{k}_{t}": [] for k in ck.STORAGE_ENTRIES for t in STORAGE}

    def timed(name, tag, shape, call, plain, lib, n, extra, ops=None,
              table_bytes=0.0):
        dt = STORAGE[tag]
        lib_name = extra.pop("library", "torch.fft complex32 (cuFFT half "
                             "C2C)*")
        x = _storage_planes(shape, sum(shape), dev, dt)
        x32 = tuple(t.float() for t in x)
        rel, err = _storage_rel(call(*x), plain(*x))
        assert rel <= STORAGE_KERNEL_TOL[tag], (name, tag, shape, rel)
        points = math.prod(shape)
        bound, by = _bound(8.0 * points + table_bytes,
                           _fft_ops(points, n) if ops is None else ops)
        regs, st, ld = _ptxas_of(ck, ck.STORAGE_LIBRARY[name])[
            f"{name}_{tag}_kernel"]
        ms = _time_ms(lambda: call(*x))
        row = {"shape": list(shape), "dtype": tag, "ms": ms,
               "GBs": 8.0 * points / ms / 1e6, "bound_ms": bound,
               "bound_by": by, "roofline_share": bound / ms,
               "max_abs_err": err, "rel_err_vs_plain": rel,
               "fp32_ms": _time_ms(lambda: call(*x32)),
               "plain_ms": _time_ms(lambda: plain(*x), reps=3, inner=1,
                                    warmup=1),
               "library_ms": None, "library": "— (none)",
               "registers": regs, "spill_bytes": [st, ld], **extra}
        row["vs_fp32"] = ms / row["fp32_ms"]
        if lib is not None and tag == "f16":
            xc = _c32(x)
            try:
                lib(xc)
            except RuntimeError as e:   # an op complex32 lacks
                row["library"] = f"— ({lib_name}: {e})"
            else:
                row["library_ms"] = _time_ms(lambda: lib(xc))
                row["library"] = lib_name
        _log(f"[time] {name} {tag} {row}")
        kernels[f"{name}_{tag}"].append(row)
        del x, x32

    for tag, dt in STORAGE.items():
        for n in ROWS_1D:
            t, lines, smem = ck.lines_layout(n, dt)
            timed("fft_lines", tag, (STORAGE_BYTES // (4 * n), n),
                  lambda r, m: ck.fft_lines(r, m),
                  lambda r, m: ck.fft_lines_plain(r, m, False),
                  lambda c: torch.fft.fft(c, dim=-1), n,
                  {"split": list(ck.lines_split(n, dt)), "threads": t,
                   "lines_per_block": lines, "smem_bytes": smem,
                   "blocks_per_sm": ck.lines_occupancy(n, dt)})
        n = 10240
        t, lines, smem = ck.twofactor_layout(n)
        timed("fft_twofactor", tag, (_sample_7_batch(n), n),
              lambda r, m: ck.fft_twofactor(r, m),
              lambda r, m: ck.fft_twofactor_plain(r, m, False), None, n,
              {"split": list(ck.twofactor_split(n)), "threads": t,
               "lines_per_block": lines, "smem_bytes": smem,
               "blocks_per_sm": ck.twofactor_occupancy(n, dt)})
        P, n, S = shape = (1, 256, 65536)
        ts, t, smem = ck.strided_layout(n, S, dt)
        timed("fft_strided", tag, shape, lambda r, m: ck.fft_strided(r, m),
              lambda r, m: ck.fft_strided_plain(r, m, False),
              lambda c: torch.fft.fft(c, dim=1), n,
              {"columns": ts, "split": list(ck.strided_split(n, S, dt)),
               "threads": t, "smem_bytes": smem,
               "blocks_per_sm": ck.strided_occupancy(n, S, dt)})
        B, ny, nz = CUBE
        c, t, smem = ck.pair_layout(ny, nz, dt)
        clusters, blocks = ck.pair_occupancy(ny, nz, dt)
        timed("fft_pair", tag, CUBE, lambda r, m: ck.fft_pair(r, m),
              lambda r, m: ck.fft_pair_plain(r, m, False),
              lambda c: torch.fft.fft2(c), ny * nz,
              {"cluster": c, "threads": t, "smem_bytes": smem,
               "splits": ck.pair_splits(ny, nz, dt),
               "resident_clusters": clusters, "blocks_per_sm": blocks})
        # the kernels of the other routes at their main path's shapes: the
        # 2^20 row's folded passes, sample 7's Rader 5003 (10006's
        # factor), Rader 7919's inverse with x0, Bluestein 10007 on its
        # plane, the long Bluestein's rows; no one PyTorch call computes
        # any of them (cuFFT's half C2C takes powers of two only)
        B, N = LONG_ROW_LINES, LONG_ROW_N
        nc, ns = ck.long_split(N)
        for what, shape, inv, kw in (
                ("folded forward: twiddle on the write, stored transposed",
                 (B, nc, ns), False,
                 dict(post=ck.twiddle(N), out_transposed=True)),
                ("folded inverse: read transposed, twiddle after the read",
                 (B, ns, nc), True,
                 dict(pre=ck.twiddle(N, True), in_transposed=True))):
            rows_, cols = (shape[2], shape[1]) if inv else shape[1:]
            ts, t, smem = ck.strided_tw_layout(rows_, cols)
            sc = 1.0 / N if inv else 1.0
            timed("fft_strided_tw", tag, shape,
                  lambda r, m, inv=inv, sc=sc, kw=kw: ck.fft_strided(
                      r, m, inv, sc, **kw),
                  lambda r, m, inv=inv, sc=sc, kw=kw: ck.fft_strided_plain(
                      r, m, inv, sc, **kw), None, nc,
                  {"what": what, "columns": ts, "threads": t,
                   "smem_bytes": smem,
                   "split": list(ck.strided_tw_split(rows_, cols)),
                   "blocks_per_sm": ck.strided_tw_occupancy(rows_, cols,
                                                            dt)},
                  _fft_ops(B * N, nc) + _cmul_ops(B * N))
        spec = ck.rader_spectrum(5003, 1.0, dev)
        shape = (2 * _sample_7_batch(10006), 5002)
        timed("fft_conv", tag, shape, lambda r, m: ck.fft_conv(r, m, spec),
              lambda r, m: ck.fft_conv_plain(r, m, spec), None, 5002,
              {"mode": "rader p=5003", "layout": list(ck.conv_layout(5002)),
               "blocks_per_sm": ck.conv_occupancy(5002, 1, dt)},
              shape[0] * (2 * _fft_ops(5002, 5002) + _cmul_ops(5002)))
        from vkfft_tpu_torch.planner.plan import plan_axis
        mb = plan_axis(LONG_BLUESTEIN_N).decomp.bluestein_size
        bc, bs = ck.bluestein_long_split(mb)
        lspec = ck.bluestein_spectrum(LONG_BLUESTEIN_N, mb, False, 1.0, dev,
                                      "long")
        shape = (bc * (SAMPLE_7_BYTES // (8 * LONG_BLUESTEIN_N)), bs)
        timed("fft_conv", tag, shape, lambda r, m: ck.fft_conv(r, m, lspec),
              lambda r, m: ck.fft_conv_plain(r, m, lspec), None, bs,
              {"mode": f"rows {bc} x {bs} (the long Bluestein's)",
               "layout": list(ck.conv_layout(bs)),
               "blocks_per_sm": ck.conv_occupancy(bs, 1, dt)},
              shape[0] * (2 * _fft_ops(bs, bs) + _cmul_ops(bs)))
        B = _sample_7_batch(7919)
        sw = ck.rader_spectrum(7919, 1.0 / 7919, dev, "swapped")
        g = torch.Generator(device=dev).manual_seed(11)
        dc = tuple(torch.randn(B, generator=g, device=dev) for _ in range(2))
        t, lines, smem = ck.twofactor_layout(7918)
        timed("fft_conv_inv", tag, (B, 7918),
              lambda r, m: ck.fft_conv_inv(r, m, sw, dc),
              lambda r, m: ck.fft_conv_inv_plain(r, m, sw, dc), None, 7918,
              {"with_x0": True, "threads": t, "lines_per_block": lines,
               "smem_bytes": smem,
               "blocks_per_sm": ck.conv_inv_occupancy(7918, dt)},
              B * (_fft_ops(7918, 7918) + 2 * _cmul_ops(7918)))
        m = plan_axis(10007).decomp.bluestein_size
        pspec = ck.bluestein_spectrum(10007, m, False, 1.0, dev, "pair")
        chirp = ck.bluestein_chirp(10007, m, False, dev)
        B = _sample_7_batch(10007)
        nc_, ns_, c, t, smem = ck.conv_pair_layout(m)
        clusters, blocks = ck.conv_pair_occupancy(m, dt)
        timed("fft_conv_pair", tag, (B, 10007),
              lambda r, m_: ck.fft_conv_pair(r, m_, pspec, chirp),
              lambda r, m_: ck.fft_conv_pair_plain(r, m_, pspec, chirp),
              None, m,
              {"plane": [nc_, ns_], "cluster": c, "threads": t,
               "smem_bytes": smem, "resident_clusters": clusters,
               "blocks_per_sm": blocks},
              B * (2 * _fft_ops(m, m) + 3 * _cmul_ops(m)))
        # the half 2-D convolution at sample 52's shape: one shared 256^2
        # spectrum (fp32, read once a launch), the 1/N in the kernel
        B, ny, nz = CUBE
        spec = torch.randn((ny * nz, 2), generator=torch.Generator(
            device=dev).manual_seed(19), device=dev)
        hc = torch.complex(spec[:, 0], spec[:, 1]).reshape(ny, nz).to(
            torch.complex32)
        c, t, smem = ck.conv2d_layout(ny, nz)[:3]
        clusters, blocks = ck.conv2d_occupancy(ny, nz, dt)
        timed("fft_conv2d", tag, CUBE,
              lambda r, m: ck.fft_conv_pair(r, m, spec, scale=1 / (ny * nz)),
              lambda r, m: ck.fft_conv_pair_plain(r, m, spec,
                                                  scale=1 / (ny * nz)),
              lambda c_: torch.fft.ifft2(torch.fft.fft2(c_) * hc), ny * nz,
              {"mode": "2-D hp=1 (sample 52)", "cluster": c, "threads": t,
               "smem_bytes": smem, "resident_clusters": clusters,
               "blocks_per_sm": blocks,
               "library": "torch.fft complex32 composition ifft2(fft2(x) * "
                          "H) (cuFFT half C2C, computing in fp16)*"},
              _conv_ops(vt.FFTConfig(shape=(ny, nz), convolution=True), B),
              table_bytes=8.0 * ny * nz)

    # the point rate of fft_lines at n = 256 from planes the 50 MB L2
    # holds (2^20 points: 16 MB of fp32 in and out) to sample 2's 2^25: a
    # kernel bound by device memory runs faster per point where the planes
    # sit in L2, and its half planes faster than its fp32 ones
    rate = []
    for points in (1 << 20, 1 << 22, 1 << 25):
        shape = (points // 256, 256)
        row = {"points": points}
        for tag, dt in [("fp32", torch.float32)] + list(STORAGE.items()):
            x = _storage_planes(shape, 5, dev, dt)
            y = tuple(torch.empty_like(t) for t in x)
            row[f"{tag}_ms"] = _time_ms(lambda: ck.fft_lines(*x, out=y))
            row[f"{tag}_Gpoints_s"] = points / row[f"{tag}_ms"] / 1e6
            del x, y
        _log(f"[time] fft_lines point rate {row}")
        rate.append(row)

    e2e = []
    for tag, dt in STORAGE.items():
        prec = vt.Precision[STORAGE_TIER[tag]]
        for name, shape, cfg_shape in (
                [(f"1d_n{n}", (STORAGE_BYTES // (4 * n), n), (n,))
                 for n in ROWS_1D] + [("3d_256^3", CUBE, CUBE)]
                + [(f"sample7_n{n}", (_sample_7_batch(n), n), (n,))
                   for n in (10007, 7919, 10006)]
                + [(row, (B, n), (n,)) for row, B, n in STORAGE_LONG_ROWS]):
            cube = len(cfg_shape) == 3
            app = vt.FFTApplication(vt.FFTConfig(shape=cfg_shape,
                                                 normalize=True,
                                                 precision=prec))
            app32 = vt.FFTApplication(vt.FFTConfig(shape=cfg_shape,
                                                   normalize=True))
            x = vt.Planar(*_storage_planes(shape, 13, dev, dt))
            x32 = x.astype(torch.float32)
            points = math.prod(shape)
            passes = 4 if cube else 2
            bound, by = _bound(passes * 8.0 * points,
                               2 * _fft_ops(points, points if cube
                                            else shape[-1]))
            fn = lambda: app.inverse(app.forward(x))
            row = {"row": name, "dtype": tag, "shape": list(shape),
                   "ms": _time_ms(fn), "bound_ms": bound, "bound_by": by,
                   "passes_per_dir": passes // 2,
                   "host_enqueue_ms": _host_ms(fn),
                   "fp32_ms": _time_ms(lambda: app32.inverse(
                       app32.forward(x32))),
                   "torch_fft_c32_ms": None}
            pow2 = all(k & (k - 1) == 0 for k in cfg_shape)
            if tag == "f16" and pow2:
                xc = _c32((x.re, x.im))
                row["torch_fft_c32_ms"] = _time_ms(
                    (lambda: torch.fft.ifftn(torch.fft.fftn(xc))) if cube
                    else (lambda: torch.fft.ifft(torch.fft.fft(xc, dim=-1),
                                                 dim=-1)))
                del xc
            row["GBs"] = passes * 8.0 * points / row["ms"] / 1e6
            row["roofline_share"] = bound / row["ms"]
            row["vs_fp32"] = row["ms"] / row["fp32_ms"]
            if not pow2:
                row["torch_fft_c32"] = "— (none: cuFFT's half C2C takes " \
                    "powers of two only)"
            _log(f"[time] e2e storage {row}")
            e2e.append(row)
            del x, x32
            torch.cuda.empty_cache()
    e2e += _storage_real_times(vt, dev) + _storage_conv_times(vt, dev)
    return {"kernels": kernels, "e2e": e2e, "fft_lines_point_rate": rate}


def _storage_real_times(vt, dev) -> list:
    """The half real rows (STORAGE_REAL_ROWS) at both tiers: rfft (rfftn)
    of the half data and irfft (irfftn) of its spectrum narrowed to the
    tier, each timed beside the same call on the float32 data and
    spectrum, with the bound of each call's bytes (its input read once,
    its output written once: 2 B a half real, 4 B a float32 one) and the
    host's enqueue time."""
    rows = []
    for tag, dt in STORAGE.items():
        for name, shape in STORAGE_REAL_ROWS:
            x = _storage_planes(shape, 13, dev, dt)[0]
            x32 = x.float()
            dims = tuple(range(1, len(shape)))
            if len(shape) == 2:
                fwd = lambda t: vt.rfft(vt.Planar(t, t))
                inv = lambda X: vt.irfft(X, n=shape[1])
            else:
                fwd = lambda t: vt.rfftn(vt.Planar(t, t), axes=dims)
                inv = lambda X: vt.irfftn(X, s=shape[1:], axes=dims)
            X32 = fwd(x32)
            Xh = X32.astype(dt)
            points = math.prod(shape)
            bins = X32.re.numel()
            n = shape[-1] if len(shape) == 2 else points
            ops = _fft_ops(points // 2, n // 2)
            row = {"row": name, "dtype": tag, "shape": list(shape)}
            for what, fn, fn32, nbytes in (
                    ("rfft", lambda: fwd(x), lambda: fwd(x32),
                     2.0 * points + 8.0 * bins),
                    ("irfft", lambda: inv(Xh), lambda: inv(X32),
                     4.0 * bins + 4.0 * points)):
                bound, by = _bound(nbytes, ops)
                ms = _time_ms(fn)
                row[what] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                             "roofline_share": bound / ms,
                             "host_enqueue_ms": _host_ms(fn),
                             "fp32_ms": _time_ms(fn32)}
                row[what]["vs_fp32"] = ms / row[what]["fp32_ms"]
            row["round_trip_ms"] = row["rfft"]["ms"] + row["irfft"]["ms"]
            row["fp32_round_trip_ms"] = (row["rfft"]["fp32_ms"]
                                         + row["irfft"]["fp32_ms"])
            _log(f"[time] e2e storage {row}")
            rows.append(row)
            del x, x32, X32, Xh
            torch.cuda.empty_cache()
    return rows


def _storage_conv_times(vt, dev) -> list:
    """The convolution rows of the tiers' main path (STORAGE_CONV_ROWS) at
    both tiers: the call on half planes beside the same call on the float32
    planes, with the bound (8 B a half point read and written once, the
    spectrum's fp32 once) and, at float16 for the scalar power-of-two rows,
    torch.fft's complex32 composition ifftn(fftn(x) * H) (cuFFT's half
    C2C, computing in fp16)."""
    rows = []
    for tag, dt in STORAGE.items():
        for name, cfg, app, x, want, h in _conv_paths(vt, dev,
                                                      STORAGE_CONV_ROWS):
            xh = x.astype(dt)
            ndim = len(cfg.shape)
            m = cfg.matrix_convolution
            items = x.re.numel() // math.prod(cfg.shape) // m
            nbytes = 8.0 * x.re.numel() + 8.0 * h.re.numel()
            bound, by = _bound(nbytes, _conv_ops(cfg, items))
            ms = _time_ms(lambda: app(xh))
            row = {"row": f"conv_{name}", "dtype": tag,
                   "shape": list(x.shape), "mode": app.fusion_mode,
                   "ms": ms, "bound_ms": bound, "bound_by": by,
                   "roofline_share": bound / ms,
                   "host_enqueue_ms": _host_ms(lambda: app(xh)),
                   "fp32_ms": _time_ms(lambda: app(x)),
                   "torch_fft_c32_ms": None}
            row["vs_fp32"] = ms / row["fp32_ms"]
            pow2 = all(k & (k - 1) == 0 for k in cfg.shape)
            if tag == "f16" and pow2 and m == 1:
                dims = tuple(range(-ndim, 0))
                H = torch.fft.fftn(torch.complex(h.re, h.im),
                                   dim=dims).to(torch.complex32)
                xc = _c32((xh.re, xh.im))
                lib = lambda: torch.fft.ifftn(torch.fft.fftn(xc, dim=dims)
                                              * H, dim=dims)
                try:
                    lib()
                    row["torch_fft_c32_ms"] = _time_ms(lib)
                except RuntimeError as e:   # an op complex32 lacks
                    row["torch_fft_c32"] = f"— ({e})"
                del H, xc
            _log(f"[time] e2e storage {row}")
            rows.append(row)
            del x, xh, h, app
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# 14. Zero-pad windows: the windowed entries of fft_lines, fft_twofactor,
# fft_strided and fft_pair, and FFTApplication's elided routes.
# ---------------------------------------------------------------------------

ZP_SENTINEL = 768.0     # exact at every dtype: guard cells must keep it
ZP_GUARD = 1 << 12      # sentinel reals each side of an output
ZP_TOL = {torch.float32: KERNEL_TOL, torch.float64: F64_KERNEL_TOL,
          torch.bfloat16: STORAGE_KERNEL_TOL["bf16"],
          torch.float16: STORAGE_KERNEL_TOL["f16"]}
# (kernel, lines, n) of the windowed lines entries: one pass of several
# lines a block (60, 256), two factors (1024, 4096, 8192), fft_twofactor's
# layouts (7918 = 2 * 37 * 107, 10240)
ZP_LINES = (("fft_lines", 257, 60), ("fft_lines", 64, 256),
            ("fft_lines", 17, 1024), ("fft_lines", 5, 4096),
            ("fft_lines", 3, 8192), ("fft_twofactor", 3, 7918),
            ("fft_twofactor", 3, 10240))
# (P, n, S) of the windowed fft_strided: one pass and two factors, a
# ragged last tile, a column run of one
ZP_STRIDED = ((2, 64, 96), (1, 256, 300), (3, 1024, 16), (1, 4096, 8))
# (B, ny, nz) of the windowed fft_pair: several clusters, an odd plane
ZP_PAIR = ((3, 16, 64), (2, 256, 256), (3, 47, 60), (2, 64, 12))


def _zp_keeps(n: int) -> tuple:
    """Kept prefixes of n points: 1, 7, n - 1 and one off every group of
    4 or 16 points."""
    return tuple(sorted({1, min(7, n - 1), n - 1, n // 3 + 1}))


def _zp_windows(n: int) -> tuple:
    """Interior windows 0 < left < right < n at edges off the groups."""
    return ((1, n - 1), (min(7, n - 2), max(min(7, n - 2) + 1, n - 5)),
            (n // 3 + 1, max(n // 3 + 2, 2 * n // 3 - 1)))


def _zp_input(shape, seed, dev, dt, zero):
    """Seeded planes of ``shape`` at ``dt``: (with NaN in the declared-zero
    cells ``zero`` (a boolean mask, or None), the same with zeros there)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = [torch.randn(shape, generator=g, device=dev,
                     dtype=torch.float64 if dt == torch.float64
                     else torch.float32).to(dt) for _ in range(2)]
    if zero is None:
        return x, x
    return ([t.masked_fill(zero, float("nan")) for t in x],
            [t.masked_fill(zero, 0.0) for t in x])


def _zp_guarded(call, shape, dt, dev):
    """``call(out=...)`` with its output planes of ``shape`` inside a
    buffer of ZP_SENTINEL reals (ZP_GUARD each side): (the output, the
    guard cells the launch changed)."""
    numel = math.prod(shape)
    buf = torch.full((2, ZP_GUARD + numel + ZP_GUARD), ZP_SENTINEL, dtype=dt,
                     device=dev)
    y = tuple(buf[i, ZP_GUARD:ZP_GUARD + numel].view(shape) for i in range(2))
    got = call(out=y)
    changed = (int((buf[:, :ZP_GUARD] != ZP_SENTINEL).sum())
               + int((buf[:, ZP_GUARD + numel:] != ZP_SENTINEL).sum()))
    return got, changed


def _zp_check(y, p, dt, what, zeros=None) -> float:
    """Relative error of the kernel's planes ``y`` against the plain ones
    ``p`` (every value finite, within ZP_TOL of max|plain|); the cells of
    ``zeros`` exactly 0."""
    yf = [t.double() for t in y]
    pf = [t.double() for t in p]
    assert all(bool(torch.isfinite(t).all()) for t in yf), (what, "inf/nan")
    ref = max(t.abs().max().item() for t in pf) or 1.0
    err = max((a - b).abs().max().item() for a, b in zip(yf, pf)) / ref
    assert err <= ZP_TOL[dt], (what, err)
    if zeros is not None:
        assert all(bool((t[zeros] == 0).all()) for t in y), (what, "zeros")
    return err


def _zp_case(ck, out, key, call, plain, shape, dt, dev, zeros=None):
    """One guarded windowed launch against its plain version."""
    y, changed = _zp_guarded(call, shape, dt, dev)
    err = _zp_check(y, plain, dt, key, zeros)
    assert changed == 0, (key, changed)
    rec = out.setdefault(key, {"cases": 0, "worst_rel_err": 0.0})
    rec["cases"] += 1
    rec["worst_rel_err"] = max(rec["worst_rel_err"], err)


def phase_zeropad_kernels(ck, dev) -> dict:
    """The windowed entries (``vk_<kernel>_zp`` and its fp64 and half
    instantiations) against their plain versions on the same inputs: each
    window form of each kernel (kept prefixes 1, 7, n - 1 and n / 3 + 1,
    read from whole planes and from cropped ones; interior windows; outputs
    cropped, filled and with a zero window; corners of wider planes read
    in place through their strides), fp32 within KERNEL_TOL, the half
    dtypes within 2 storage ulps, fp64 within F64_KERNEL_TOL.  The
    declared-zero input cells hold NaN (a read of one would show in the
    output, which must be finite and equal the plain version on the zeroed
    input), every output lies inside sentinel guards that must stay
    unwritten, and written zeros must be exact.  Prints the windowed
    kernels' ptxas lines."""
    out = {}
    lines_log = {}
    for name in ck.ZP_KERNELS + ck.ZP_BLUESTEIN_KERNELS:
        with open(ck.library_path(name)[:-3] + ".log") as f:
            lines_log.update({k: v for k, v in _ptxas_lines(f.read()).items()
                              if "_zp" in k})
    for k, v in sorted(lines_log.items()):
        _log(f"[zeropad ptxas] {k}: {v}")
    out["ptxas"] = lines_log
    for kernel, B, n in ZP_LINES:
        run = getattr(ck, kernel)
        plain = (ck.fft_lines_plain if kernel == "fft_lines"
                 else ck.fft_twofactor_plain)
        for dt in ck.ZP_DTYPES[kernel]:
            key = f"{ck.zp_entry(kernel, dt)}_n{n}"
            t = torch.arange(n, device=dev)
            for i, k in enumerate(_zp_keeps(n)):
                inv = i % 2 == 1
                s = 1.0 / n if inv else 1.0
                # a kept prefix read from whole lines and from cropped ones
                x, x0 = _zp_input((B, n), n + k, dev, dt, (t >= k)[None, :])
                w = ck.line_window(n, in_keep=k)
                p = plain(*x0, inv, s, window=w)
                _zp_case(ck, out, key, lambda out: run(
                    *x, inv, s, window=w, out=out), p, (B, n), dt, dev)
                xc = [v[:, :k].contiguous() for v in x]
                _zp_case(ck, out, key, lambda out: run(
                    *xc, inv, s, window=w, out=out), p, (B, n), dt, dev)
                # the output cropped, and filled
                x, _ = _zp_input((B, n), 2 * n + k, dev, dt, None)
                for fill in (False, True):
                    w = ck.line_window(n, out_keep=k, out_fill=fill)
                    p = plain(*x, not inv, 1.0, window=w)
                    shape = (B, n if fill else k)
                    _zp_case(ck, out, key, lambda out: run(
                        *x, not inv, window=w, out=out),
                        p, shape, dt, dev,
                        (t >= k)[None, :].expand(B, n) if fill else None)
            for j, win in enumerate(_zp_windows(n)):
                inv = j % 2 == 0
                zero = (t >= win[0]) & (t < win[1])
                x, x0 = _zp_input((B, n), 3 * n + j, dev, dt, zero[None, :])
                w = ck.line_window(n, in_window=win)
                p = plain(*x0, inv, 1.0, window=w)
                _zp_case(ck, out, key, lambda out: run(
                    *x, inv, window=w, out=out), p, (B, n), dt, dev)
                w = ck.line_window(n, out_zero_window=win)
                p = plain(*x0, not inv, 1.0, window=w)
                _zp_case(ck, out, key, lambda out: run(
                    *x0, not inv, window=w, out=out), p, (B, n),
                    dt, dev, zero[None, :].expand(B, n))
            # lines of a corner of wider planes (three strides), read in
            # place: the planes (3, 4, 5, n), the corner [:, :2, :3], a
            # kept prefix n / 3 + 1
            k = n // 3 + 1
            full = torch.ones((3, 4, 5, n), dtype=torch.bool, device=dev)
            full[:, :2, :3, :k] = False
            x, x0 = _zp_input((3, 4, 5, n), 4 * n, dev, dt, full)
            xv = [v[:, :2, :3] for v in x]
            w = ck.line_window(n, in_keep=k)
            p = plain(*[v[:, :2, :3] for v in x0], False, 1.0, window=w)
            _zp_case(ck, out, key, lambda out: run(
                *xv, False, window=w, out=out), p, (3, 2, 3, n), dt, dev)
    for P, n, S in ZP_STRIDED:
        for dt in ck.ZP_DTYPES["fft_strided"]:
            key = f"{ck.zp_entry('fft_strided', dt)}_n{n}"
            rows = torch.arange(n, device=dev)[None, :, None]
            for i, k in enumerate(_zp_keeps(n)):
                inv = i % 2 == 1
                x, x0 = _zp_input((P, n, S), n + k, dev, dt,
                                  (rows >= k).expand(P, n, S))
                p = ck.fft_strided_plain(*x0, inv, 1.0, window=(n, k, n))
                _zp_case(ck, out, key, lambda out: ck.fft_strided(
                    *x, inv, in_keep=k, out=out), p, (P, n, S), dt, dev)
                xc = [v[:, :k].contiguous() for v in x]
                _zp_case(ck, out, key, lambda out: ck.fft_strided(
                    *xc, inv, in_keep=k, n=n, out=out), p, (P, n, S), dt, dev)
                p = ck.fft_strided_plain(*x0, not inv, 1.0, window=(n, n, k))
                _zp_case(ck, out, key, lambda out: ck.fft_strided(
                    *x0, not inv, out_keep=k, out=out), p, (P, k, S), dt, dev)
                # a corner of wider planes: (P, n, 3, S + 5) planes, the
                # columns [:2, :S] of each row, rows below k read
                big, big0 = _zp_input(
                    (P, n, 3, S + 5), 2 * n + k, dev, dt,
                    (torch.arange(n, device=dev)[None, :, None, None] >= k)
                    .expand(P, n, 3, S + 5))
                xv = [v[:, :, :2, :S] for v in big]
                p = ck.fft_strided_plain(*[v[:, :, :2, :S] for v in big0],
                                         inv, 1.0, window=(n, k, k))
                _zp_case(ck, out, key, lambda out: ck.fft_strided(
                    *xv, inv, in_keep=k, out_keep=k, out=out), p,
                    (P, k, 2, S), dt, dev)
    for B, ny, nz in ZP_PAIR:
        for dt in ck.ZP_DTYPES["fft_pair"]:
            if ck.pair_cluster(ny, nz, dt) is None:
                continue
            key = f"{ck.zp_entry('fft_pair', dt)}_{ny}x{nz}"
            yy = torch.arange(ny, device=dev)[:, None]
            zz = torch.arange(nz, device=dev)[None, :]
            ks = [(k, kz) for k, kz in zip(_zp_keeps(ny), _zp_keeps(nz)[::-1])]
            ks += [(0, nz // 3 + 1), (ny // 3 + 1, 0)]
            for i, (ky, kz) in enumerate(ks):
                inv = i % 2 == 1
                cy, cz = ky or ny, kz or nz
                zero = ((yy >= cy) | (zz >= cz))[None].expand(B, ny, nz)
                x, x0 = _zp_input((B, ny, nz), ny + nz + i, dev, dt, zero)
                win = (ny, nz, cy, cz, ny, nz)
                p = ck.fft_pair_plain(*x0, inv, 1.0, window=win)
                _zp_case(ck, out, key, lambda out: ck.fft_pair(
                    *x, inv, in_keep=(ky, kz), out=out), p, (B, ny, nz),
                    dt, dev)
                xc = [v[:, :cy, :cz].contiguous() for v in x]
                _zp_case(ck, out, key, lambda out: ck.fft_pair(
                    *xc, inv, in_keep=(ky, kz), plane=(ny, nz), out=out), p,
                    (B, ny, nz), dt, dev)
                win = (ny, nz, ny, nz, cy, cz)
                p = ck.fft_pair_plain(*x0, not inv, 1.0, window=win)
                _zp_case(ck, out, key, lambda out: ck.fft_pair(
                    *x0, not inv, out_keep=(ky, kz), out=out), p,
                    (B, cy, cz), dt, dev)
                win = (ny, nz, cy, cz, cy, cz)
                p = ck.fft_pair_plain(*x0, inv, 1.0, window=win)
                _zp_case(ck, out, key, lambda out: ck.fft_pair(
                    *x, inv, in_keep=(ky, kz), out_keep=(ky, kz), out=out),
                    p, (B, cy, cz), dt, dev)
    _conv2d_zp_cases(ck, out, dev)
    _blu_zp_cases(ck, out, dev)
    torch.cuda.synchronize()
    for key, rec in out.items():
        if key != "ptxas":
            _log(f"[zeropad kernels] {key}: {rec}")
    return out


# Bluestein's read window: the lengths of each windowed entry's kernel
# mode (fft_conv: m = 539, 770, 8125 in one pass and two factors;
# fft_conv_pair: m = 8192 and sample 7's 32768; fft_strided_tw's plane
# mode: the long tier's 32771 and 65537)
ZP_BLU_LENGTHS = (263, 383, 4054, 4073, 10007, 32771, 65537)


def _blu_kernel(ck, n, dev):
    """(windowed entry, its call on planes with a read window, its plain
    version, whether the call takes ``out``) of the kernel of n's
    Bluestein route."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    m = plan_axis(n).decomp.bluestein_size
    chirp = ck.bluestein_chirp(n, m, False, dev)
    if ck.kernel_supports(m):
        spec = ck.bluestein_spectrum(n, m, False, 1.0, dev)
        return ("fft_conv",
                lambda x, k, out=None: ck.fft_conv(*x, spec, chirp, out=out,
                                                   in_keep=k),
                lambda x: ck.fft_conv_plain(*x, spec, chirp), True)
    if ck.conv_pair_plan(m) is not None:
        spec = ck.bluestein_spectrum(n, m, False, 1.0, dev, "pair")
        return ("fft_conv_pair",
                lambda x, k, out=None: ck.fft_conv_pair(
                    *x, spec, chirp, out=out, in_keep=k),
                lambda x: ck.fft_conv_pair_plain(*x, spec, chirp), True)
    kw = dict(pre=ck.chirp(n, False), post=ck.twiddle(m),
              plane=ck.bluestein_long_split(m))
    return ("fft_strided_tw",
            lambda x, k, out=None: ck.fft_strided(*x, False, 1.0, in_keep=k,
                                                  **kw),
            lambda x: ck.fft_strided_plain(*x, False, 1.0, **kw), False)


def _blu_zp_cases(ck, out, dev) -> None:
    """The windowed entries of Bluestein's read window (vk_fft_conv_zp,
    vk_fft_conv_pair_zp, vk_fft_strided_tw_zp and their _bf16, _f16 twins)
    against the unwindowed plain versions on the zeroed lines: windows 1,
    7, n / 3 + 1 and n - 1 of each length of ZP_BLU_LENGTHS, the
    declared-zero tail NaN, fp32 within KERNEL_TOL and the half tiers
    within 2 storage ulps; the two conv entries' outputs inside sentinel
    guards, and in place over their input."""
    for n in ZP_BLU_LENGTHS:
        name, run, plain, guarded = _blu_kernel(ck, n, dev)
        B = 3 if n < 20000 else 2
        t = torch.arange(n, device=dev)
        for dt in (torch.float32,) + ck.STORAGE_DTYPES:
            key = f"{ck.zp_entry(name, dt)}_n{n}"
            for i, k in enumerate(_zp_keeps(n)):
                x, x0 = _zp_input((B, n), n + k, dev, dt, (t >= k)[None, :])
                p = plain(x0)
                shape = tuple(p[0].shape)
                if guarded:
                    _zp_case(ck, out, key, lambda out: run(x, k, out),
                             p, shape, dt, dev)
                    if i == 0:
                        # in place over the input's planes
                        xi = [v.clone() for v in x]
                        got = run(xi, k, tuple(xi))
                        _zp_check(got, p, dt, key)
                else:
                    got = run(x, k)
                    rec = out.setdefault(key, {"cases": 0,
                                               "worst_rel_err": 0.0})
                    rec["cases"] += 1
                    rec["worst_rel_err"] = max(rec["worst_rel_err"],
                                               _zp_check(got, p, dt, key))


# (B, ny, nz, hp) of fft_conv_pair's windowed 2-D entry: sample 51's
# 256^2, the tests' 128 x 256 with per-slice spectra, an odd plane
# (cluster 1), several clusters
ZP_CONV2D = ((2, 256, 256, 1), (4, 128, 256, 2), (3, 47, 60, 1),
             (3, 16, 64, 3))


def _conv2d_zp_cases(ck, out, dev) -> None:
    """fft_conv_pair's windowed 2-D entry (vk_fft_conv2d_zp, _bf16, _f16)
    against its plain version: input corners (1, 1), (7, 13), (ny / 2, nz /
    2) and (ny - 1, nz - 1) read from whole planes (NaN outside the corner)
    and from cropped ones, the same corners as output windows, the flags
    in turn; guarded as the other windowed entries."""
    for B, ny, nz, hp in ZP_CONV2D:
        g = torch.Generator(device=dev).manual_seed(ny * nz + hp)
        tab = torch.randn((hp * ny * nz, 2), generator=g, device=dev)
        corners = ((1, 1), (7, 13), (ny // 2, nz // 2), (ny - 1, nz - 1))
        for dt in (torch.float32,) + ck.STORAGE_DTYPES:
            key = f"fft_conv2d_zp{ck._SUFFIX[dt]}_{ny}x{nz}"
            yy = torch.arange(ny, device=dev)[:, None]
            zz = torch.arange(nz, device=dev)[None, :]
            for i, (ky, kz) in enumerate(corners):
                ky, kz = min(ky, ny - 1), min(kz, nz - 1)
                flags = dict(conj_data=i % 2 == 1, xpow=i == 3)
                s = 1.0 / (ny * nz)
                zero = ((yy >= ky) | (zz >= kz))[None].expand(B, ny, nz)
                x, x0 = _zp_input((B, ny, nz), ny + nz + i, dev, dt, zero)
                win = (ny, nz, ky, kz, ny, nz)
                p = ck.fft_conv_pair_plain(*x0, tab, None, scale=s,
                                           window=win, **flags)
                _zp_case(ck, out, key, lambda out: ck.fft_conv_pair(
                    *x, tab, out=out, scale=s, in_keep=(ky, kz), **flags),
                    p, (B, ny, nz), dt, dev)
                xc = [v[:, :ky, :kz].contiguous() for v in x]
                _zp_case(ck, out, key, lambda out: ck.fft_conv_pair(
                    *xc, tab, out=out, scale=s, in_keep=(ky, kz),
                    plane=(ny, nz), **flags), p, (B, ny, nz), dt, dev)
                win = (ny, nz, ny, nz, ky, kz)
                p = ck.fft_conv_pair_plain(*x0, tab, None, scale=s,
                                           window=win, **flags)
                _zp_case(ck, out, key, lambda out: ck.fft_conv_pair(
                    *x0, tab, out=out, scale=s, out_keep=(ky, kz), **flags),
                    p, (B, ky, kz), dt, dev)
                win = (ny, nz, ky, kz, ky, kz)
                p = ck.fft_conv_pair_plain(*x0, tab, None, scale=s,
                                           window=win, **flags)
                _zp_case(ck, out, key, lambda out: ck.fft_conv_pair(
                    *x, tab, out=out, scale=s, in_keep=(ky, kz),
                    out_keep=(ky, kz), **flags), p, (B, ky, kz), dt, dev)


def _zp_mask(t: torch.Tensor, spec, ndim: int) -> torch.Tensor:
    """``t`` with the configured [left, right) window of each of its
    trailing ``ndim`` axes zeroed."""
    if spec is None:
        return t
    t = t.clone()
    off = t.ndim - ndim
    for ax, w in enumerate(spec):
        if w is not None:
            t.narrow(off + ax, w[0], w[1] - w[0]).zero_()
    return t


def _zp_zero(shape, spec, ndim, dev):
    """The boolean mask of the declared-zero cells of ``spec``."""
    z = torch.zeros(shape, dtype=torch.bool, device=dev)
    if spec is None:
        return z
    off = len(shape) - ndim
    for ax, w in enumerate(spec):
        if w is not None:
            z.narrow(off + ax, w[0], w[1] - w[0]).fill_(True)
    return z


def _zp_launches(ck, torch_engine, want, what):
    """Exactly ``want`` ({entry: count}) launches since the last reset,
    windowed and unwindowed (a masked route: no windowed one), no other
    launch of kind or dtype, no plain-engine call."""
    got = {k: v for k, v in ck.zp_launches.items() if v}
    others = {k: v for d in (ck.launches, ck.f64_launches,
                             ck.storage_launches) for k, v in d.items() if v}
    if want.get("masked"):
        want = dict(want)
        del want["masked"]
        assert not got and others == want, (what, got, others)
    else:
        assert {**got, **others} == want, (what, got, others)
    assert torch_engine.calls == 0, (what, torch_engine.calls)
    return {**got, **others}


class _AtenOps(TorchDispatchMode):
    """The names of the aten ops run inside the block."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _blu_forward_unmasked(app, x, what) -> None:
    """The forward of the blu route runs no mask pass (no aten.where): the
    declared-zero tail is left unread by the kernels, not zeroed first."""
    ops = _AtenOps()
    with ops:
        app.forward(x)
    assert not any("where" in o for o in ops.names), (what, ops.names)


def _blu_twin(ce, n: int, suffix: str = "") -> dict:
    """{kernel: launches} of the dense twin's round trip on n (each kernel
    of the route, both ways), the entries of the planes' dtype."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    out = {}
    for k, _, _ in ce.route(plan_axis(n)):
        out[k + suffix] = out.get(k + suffix, 0) + 2
    return out


def _zp_round_trip(vt, ck, torch_engine, cfg, x, want, what):
    """Forward and normalized inverse of Planar ``x`` through
    FFTApplication(``cfg``), counted from 0 and held to ``want``: (the
    application, the forward, the inverse, the launches)."""
    app = vt.FFTApplication(cfg)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch_engine.calls = 0
    y = app.forward(x)
    z = app.inverse(y)
    torch.cuda.synchronize()
    got = _zp_launches(ck, torch_engine, want, what)
    assert _finite(y, z), what
    return app, y, z, got


def _zp_check_values(vt, cfg, x, y, z, dt, what, cpu_lines=None):
    """The forward of ``x`` against fp64 (torch.fft complex128) of its
    masked input, masked by the output windows, the declared-zero output
    exactly 0; the inverse of the forward against the fp64 inverse of that
    reference under the input windows; both at the gates (NUMPY_TOL, the
    half tiers' STORAGE_NUMPY_TOL)."""
    nd = len(cfg.shape)
    dims = tuple(range(x.ndim - nd, x.ndim))
    xw = torch.complex(x.re.double(), x.im.double())
    if dt != torch.float32:
        xw = torch.complex(x.re.to(dt).double(), x.im.to(dt).double())
    xm = _zp_mask(xw, cfg.zeropad_input, nd)
    del xw
    ref = _zp_mask(torch.fft.fftn(xm, dim=dims), cfg.zeropad_output, nd)
    del xm
    e_f = _rel(torch.complex(y.re.double(), y.im.double()), ref)
    iref = _zp_mask(torch.fft.ifftn(ref, dim=dims), cfg.zeropad_input, nd)
    del ref
    e_i = _rel(torch.complex(z.re.double(), z.im.double()), iref)
    del iref
    zo = _zp_zero(y.shape, cfg.zeropad_output, nd, y.re.device)
    zi = _zp_zero(z.shape, cfg.zeropad_input, nd, z.re.device)
    exact = (bool((y.re[zo] == 0).all() and (y.im[zo] == 0).all())
             and bool((z.re[zi] == 0).all() and (z.im[zi] == 0).all()))
    tol = (NUMPY_TOL if dt == torch.float32
           else STORAGE_NUMPY_TOL["bf16" if dt == torch.bfloat16 else "f16"])
    assert e_f <= tol and e_i <= tol and exact, (what, e_f, e_i, exact)
    return e_f, e_i


# (name, config keywords, batch, {windowed entry: launches} of a forward
# and an inverse, or {"masked": True, kernel: launches}) of zeropad_routes
ZP_ROUTES = (
    ("v3_in", dict(shape=(4096,), zeropad_input=((1000, 4096),)), 9,
     {"fft_lines_zp": 2}),
    ("v3_out", dict(shape=(4096,), zeropad_output=((2049, 4096),)), 9,
     {"fft_lines_zp": 2}),
    ("v3_both", dict(shape=(60,), zeropad_input=((7, 60),),
                     zeropad_output=((31, 60),)), 33, {"fft_lines_zp": 2}),
    ("interior", dict(shape=(1024,), zeropad_input=((256, 768),)), 17,
     {"fft_lines_zp": 2}),
    ("v2", dict(shape=(10240,), zeropad_input=((5121, 10240),)), 3,
     {"fft_twofactor_zp": 2}),
    ("pair_3d", dict(shape=(8, 64, 128),
                     zeropad_input=((3, 8), (33, 64), (61, 128))), 2,
     {"fft_pair_zp": 2, "fft_strided_zp": 2}),
    ("pair_2d", dict(shape=(64, 128), zeropad_input=((33, 64), (64, 128))),
     5, {"fft_pair_zp": 2}),
    ("pair_out_3d", dict(shape=(8, 64, 128),
                         zeropad_output=((4, 8), (32, 64), (63, 128))), 2,
     {"fft_pair_zp": 2, "fft_strided_zp": 2}),
    ("axes_2d", dict(shape=(40, 205), zeropad_input=((17, 40), (100, 205))),
     7, {"fft_lines_zp": 2, "fft_strided_zp": 2}),
    ("axes_3d", dict(shape=(6, 40, 205),
                     zeropad_input=((2, 6), (17, 40), (100, 205))), 2,
     {"fft_lines_zp": 2, "fft_strided_zp": 4}),
    # Bluestein's read window on each route: the forward's first kernel
    # its windowed entry (fft_twofactor + fft_conv_inv: the chirp over the
    # window), the masked inverse the unwindowed kernels
    ("blu_fft_conv", dict(shape=(383,), zeropad_input=((127, 383),)), 33,
     {"fft_conv_zp": 1, "fft_conv": 1}),
    ("blu_fft_conv_m8125", dict(shape=(4054,),
                                zeropad_input=((1351, 4054),)), 5,
     {"fft_conv_zp": 1, "fft_conv": 1}),
    ("blu_twofactor", dict(shape=(4213,), zeropad_input=((1404, 4213),)), 5,
     {"fft_twofactor": 2, "fft_conv_inv": 2}),
    ("blu_fft_conv_pair", dict(shape=(10007,),
                               zeropad_input=((3000, 10007),)), 2,
     {"fft_conv_pair_zp": 1, "fft_conv_pair": 1}),
    ("blu_long", dict(shape=(65537,), zeropad_input=((32768, 65537),)), 2,
     {"fft_strided_tw_zp": 1, "fft_conv": 2, "fft_strided_tw": 3}),
    ("masked_bluestein", dict(shape=(10007,),
                              zeropad_input=((3000, 5000),)), 2,
     {"masked": True, "fft_conv_pair": 2}),
    ("masked_not_prefix", dict(shape=(16,), zeropad_input=((0, 8),)), 5,
     {"masked": True, "fft_lines": 2}),
)


# ConvolutionApplication's "pair" mode with windows (the 2-D mode's
# windowed entry): (name, config keywords, batch, {launch key: count} of a
# call: windowed entries and the unwindowed launches beside them)
ZP_CONV_ROUTES = (
    ("conv2d_in", dict(shape=(64, 128), zeropad_input=((33, 64), (64, 128))),
     3, {"fft_conv2d_zp": 1}),
    ("conv2d_out", dict(shape=(64, 128), zeropad_output=((40, 64),
                                                         (50, 128))),
     3, {"fft_conv2d_zp": 1}),
    ("conv2d_both", dict(shape=(47, 60), zeropad_input=((20, 47), (31, 60)),
                         zeropad_output=((11, 47), (59, 60))),
     2, {"fft_conv2d_zp": 1}),
    ("conv3d_all_axes", dict(shape=(8, 64, 128), zeropad_input=(
        (3, 8), (33, 64), (61, 128))), 2,
     {"fft_strided_zp": 1, "fft_conv2d_zp": 1, "fft_strided": 1}),
    ("conv2d_masked_interior", dict(shape=(64, 128),
                                    zeropad_input=((5, 9), None)), 3,
     {"fft_conv_pair": 1}),
)


def _zp_conv_call(vt, ck, torch_engine, cfg, x, h, want, what):
    """A ConvolutionApplication(``cfg``) call on Planar ``x`` with kernel
    planes ``h`` (its spectrum made before the count), counted from 0 and
    held to ``want`` ({launch key: count} over every counter), no
    plain-engine call: (the application, the result, the launches)."""
    app = vt.ConvolutionApplication(cfg, h)
    assert app.fusion_mode == "pair", (what, app.fusion_mode)
    app(x)   # the spectrum's table made once, outside the count
    torch.cuda.synchronize()
    ck.reset_launches()
    torch_engine.calls = 0
    y = app(x)
    torch.cuda.synchronize()
    got = {k: v for d in (ck.launches, ck.storage_launches, ck.zp_launches,
                          ck.tl_launches, ck.f64_launches)
           for k, v in d.items() if v}
    assert got == want and torch_engine.calls == 0, (what, got, want)
    assert _finite(y), what
    return app, y, got


def _zp_conv_check(cfg, x, h, y, dt, what) -> float:
    """The call's result against fp64 (torch.fft complex128) of the masked
    input convolved with the kernel, masked by the output windows; the
    declared-zero output exactly 0; at the gates."""
    nd = len(cfg.shape)
    dims = tuple(range(x.ndim - nd, x.ndim))
    xm = _zp_mask(torch.complex(x.re.to(dt).double(), x.im.to(dt).double()),
                  cfg.zeropad_input, nd)
    H = torch.fft.fftn(torch.complex(h.re.double(), h.im.double()),
                       dim=tuple(range(-nd, 0)))
    ref = _zp_mask(torch.fft.ifftn(torch.fft.fftn(xm, dim=dims) * H,
                                   dim=dims), cfg.zeropad_output, nd)
    del xm, H
    e = _rel(torch.complex(y.re.double(), y.im.double()), ref)
    zo = _zp_zero(y.shape, cfg.zeropad_output, nd, y.re.device)
    exact = bool((y.re[zo] == 0).all() and (y.im[zo] == 0).all())
    tol = (NUMPY_TOL if dt == torch.float32
           else STORAGE_NUMPY_TOL["bf16" if dt == torch.bfloat16 else "f16"])
    assert e <= tol and exact, (what, e, exact)
    return e


def phase_zeropad_routes(vt, ck, torch_engine, dev) -> dict:
    """Each zeropad_mode kind through FFTApplication on the card (ZP_ROUTES)
    in fp32 and at bfloat16: its exact windowed launches (a masked route:
    its unwindowed kernels and no windowed one), no plain-engine call;
    the forward and the round trip against fp64 of the masked input at the
    gates, declared-zero outputs exactly 0; and both against the same
    call on the CPU's torch engine (KERNEL_TOL in fp32, the half tier's
    STORAGE_ROUTE_TOL).  The blu rows (Bluestein's read window on each
    Bluestein route) launch as many kernels as their dense twin and run no
    mask pass in the forward."""
    from vkfft_tpu_torch.ops import cuda_engine as ce
    rows = []
    for name, kw, B, want in ZP_ROUTES:
        for prec, dt in ((vt.Precision.SINGLE, torch.float32),
                         (vt.Precision.BFLOAT16, torch.bfloat16)):
            cfg = vt.FFTConfig(normalize=True, precision=prec, **kw)
            shape = (B,) + cfg.shape
            x = vt.Planar(*_planes(shape, len(name), dev))
            # the tier's instantiations of the same kernels
            w = {k if k == "masked" or dt == torch.float32 else k + "_bf16": v
                 for k, v in want.items()}
            app, y, z, got = _zp_round_trip(vt, ck, torch_engine, cfg, x,
                                            w, f"{name}_{dt}")
            if name.startswith("blu_"):
                # as many launches as the dense twin, no mask pass forward
                twin = _blu_twin(ce, cfg.shape[-1],
                                 "" if dt == torch.float32 else "_bf16")
                assert sum(got.values()) == sum(twin.values()), (got, twin)
                assert {k.replace("_zp", ""): 0 for k in got} == {
                    k: 0 for k in twin}, (got, twin)
                _blu_forward_unmasked(app, x, name)
            e_f, e_i = _zp_check_values(vt, cfg, x, y, z, dt, name)
            cpu = vt.FFTApplication(cfg, engine="torch", device="cpu")
            xc = vt.Planar(x.re.cpu(), x.im.cpu())
            yc = cpu.forward(xc)
            zc = cpu.inverse(yc)
            tol = (KERNEL_TOL if dt == torch.float32
                   else STORAGE_ROUTE_TOL["bf16"])
            e_cf = _storage_rel((y.re.cpu(), y.im.cpu()), (yc.re, yc.im))[0]
            e_ci = _storage_rel((z.re.cpu(), z.im.cpu()), (zc.re, zc.im))[0]
            row = {"route": name, "mode": app.zeropad_mode,
                   "dtype": str(dt), "shape": list(shape), "launches": got,
                   "rel_err_fwd_vs_fp64": e_f, "rel_err_inv_vs_fp64": e_i,
                   "rel_err_fwd_vs_cpu_engine": e_cf,
                   "rel_err_inv_vs_cpu_engine": e_ci}
            _log(f"[zeropad routes] {row}")
            assert max(e_cf, e_ci) <= tol, row
            rows.append(row)
    # the convolution's "pair" mode with windows (ZP_CONV_ROUTES), fp32 and
    # bf16 data, each call held to its exact launches and fp64
    for name, kw, B, want in ZP_CONV_ROUTES:
        for dt in (torch.float32, torch.bfloat16):
            cfg = vt.FFTConfig(convolution=True, **kw)
            shape = (B,) + cfg.shape
            x = vt.Planar(*_planes(shape, len(name), dev)).astype(dt)
            h = vt.Planar(*_planes(cfg.shape, len(name) + 1, dev))
            # the half tier's entries (the 2-D mode's: fft_conv2d_<dtype>)
            w = {({"fft_conv_pair": "fft_conv2d"}.get(k, k) + "_bf16"
                  if dt == torch.bfloat16 else k): v
                 for k, v in want.items()}
            app, y, got = _zp_conv_call(vt, ck, torch_engine, cfg, x, h, w,
                                        f"{name}_{dt}")
            e = _zp_conv_check(cfg, x, h, y, dt, name)
            row = {"route": name, "dtype": str(dt), "shape": list(shape),
                   "launches": got, "rel_err_vs_fp64": e}
            _log(f"[zeropad routes] {row}")
            rows.append(row)
    return {"rows": rows}


def _zp_half(n: int) -> tuple:
    return (n // 2, n)


# sample 4's rows (vkfft_tpu/cli.py:658-700: half windows on every axis,
# 128 MiB a system) and the other elided routes at full size: (name,
# config keywords, batch, {windowed entry: launches} of a round trip)
ZP_MAIN_ROWS = (
    ("sample4_256^3", dict(shape=CUBE, zeropad_input=tuple(
        _zp_half(n) for n in CUBE)), 1,
     {"fft_pair_zp": 2, "fft_strided_zp": 2}),
    ("sample4_512^3", dict(shape=(512, 512, 512), zeropad_input=tuple(
        _zp_half(512) for _ in range(3))), 1,
     {"fft_lines_zp": 2, "fft_strided_zp": 4}),
    ("sample4_2048x4096", dict(shape=(2048, 4096), zeropad_input=(
        _zp_half(2048), _zp_half(4096))), 2,
     {"fft_lines_zp": 2, "fft_strided_zp": 2}),
    ("v3_n4096", dict(shape=(4096,), zeropad_input=(_zp_half(4096),)),
     TARGET_BYTES // (8 * 4096), {"fft_lines_zp": 2}),
    ("interior_n1024", dict(shape=(1024,), zeropad_input=((256, 768),)),
     TARGET_BYTES // (8 * 1024), {"fft_lines_zp": 2}),
    ("v2_n10240", dict(shape=(10240,), zeropad_input=(_zp_half(10240),)),
     TARGET_BYTES // (8 * 10240), {"fft_twofactor_zp": 2}),
    ("pair_out_256^3", dict(shape=CUBE, zeropad_output=tuple(
        _zp_half(n) for n in CUBE)), 1,
     {"fft_pair_zp": 2, "fft_strided_zp": 2}),
    ("ex05_8x128x256", dict(shape=(8, 128, 256), zeropad_input=(
        (4, 8), (64, 128), (128, 256))), TARGET_BYTES // (8 * 8 * 128 * 256),
     {"fft_pair_zp": 2, "fft_strided_zp": 2}),
    # Bluestein's read window on one length of each Bluestein route, 64
    # MiB of fp32 planes (sample 7's batching): fft_conv at 4054 (m =
    # 8125), fft_twofactor + fft_conv_inv at 4213, sample 7's 10007 in
    # fft_conv_pair with the window of the JAX package's test (3000), the
    # fused long tier at 65537; half prefixes elsewhere
    ("blu_n4054", dict(shape=(4054,), zeropad_input=(_zp_half(4054),)),
     SAMPLE_7_BYTES // (8 * 4054), {"fft_conv_zp": 1, "fft_conv": 1}),
    ("blu_n4213", dict(shape=(4213,), zeropad_input=(_zp_half(4213),)),
     SAMPLE_7_BYTES // (8 * 4213), {"fft_twofactor": 2, "fft_conv_inv": 2}),
    ("blu_sample7_n10007", dict(shape=(10007,),
                                zeropad_input=((3000, 10007),)),
     SAMPLE_7_BYTES // (8 * 10007),
     {"fft_conv_pair_zp": 1, "fft_conv_pair": 1}),
    ("blu_n65537", dict(shape=(65537,), zeropad_input=(_zp_half(65537),)),
     SAMPLE_7_BYTES // (8 * 65537),
     {"fft_strided_tw_zp": 1, "fft_conv": 2, "fft_strided_tw": 3}),
)
# the convolution rows: sample 51's benchmark (vkfft_tpu/cli.py:907-950:
# 256 planes of 256^2, half-pad^2 input windows, 128 MiB) and a 3-D (8,
# 256, 256) convolution windowed on every axis (tests/test_conv.py:277's
# pattern at full plane width, 32 volumes, 128 MiB): (name, config
# keywords, batch, {launch key: count} of a call)
ZP_CONV_MAIN_ROWS = (
    ("sample51_bench_256x256^2", dict(shape=(256, 256), zeropad_input=(
        _zp_half(256), _zp_half(256))), TARGET_BYTES // (8 * 65536),
     {"fft_conv2d_zp": 1}),
    ("conv3d_8x256x256", dict(shape=(8, 256, 256), zeropad_input=(
        _zp_half(8), _zp_half(256), _zp_half(256))),
     TARGET_BYTES // (8 * 8 * 65536),
     {"fft_strided_zp": 1, "fft_conv2d_zp": 1, "fft_strided": 1}),
)
ZP_MODES = {"sample4_256^3": "elided-pair", "sample4_512^3": "elided-axes",
            "sample4_2048x4096": "elided-axes", "v3_n4096": "elided-prefix",
            "interior_n1024":
                "elided-interior (forward reads; inverse in-kernel restore)",
            "v2_n10240": "elided-prefix",
            "pair_out_256^3": "elided-pair-output",
            "ex05_8x128x256": "elided-pair",
            **{name: "elided-prefix (bluestein: forward reads; inverse "
                     "masked)" for name in ("blu_n4054", "blu_n4213",
                                             "blu_sample7_n10007",
                                             "blu_n65537")}}


def phase_zeropad_main_path(vt, ck, torch_engine, dev) -> dict:
    """The reference's sample 4 rows (256^3 on the pair corner route, 512^3
    and 2048 x 4096 on the axes route: the port's 512^2 and 2048 x 4096
    planes are past pair_cluster) and the other elided routes at full size
    (ZP_MAIN_ROWS, Bluestein's read window among them) through
    FFTApplication(normalize=True) on fp32 Planar
    input: each round trip counted from 0 and held to its exact windowed
    (and, on the blu route's masked inverse, unwindowed) launches with no
    plain-engine call, its zeropad_mode, finite, the
    forward and the round trip against fp64 of the masked input at the
    gates, the declared-zero outputs exactly 0."""
    rows, by_row = [], {}
    for name, kw, B, want in ZP_MAIN_ROWS:
        cfg = vt.FFTConfig(normalize=True, **kw)
        shape = (B,) + cfg.shape
        x = vt.Planar(*_planes(shape, len(name), dev))
        app, y, z, got = _zp_round_trip(vt, ck, torch_engine, cfg, x, want,
                                        name)
        assert app.zeropad_mode == ZP_MODES[name], (name, app.zeropad_mode)
        by_row[name] = {k: got.get(k, 0) for k in ck.zp_launches}
        e_f, e_i = _zp_check_values(vt, cfg, x, y, z, torch.float32, name)
        row = {"row": name, "mode": app.zeropad_mode, "shape": list(shape),
               "launches": got, "rel_err_fwd_vs_fp64": e_f,
               "rel_err_inv_vs_fp64": e_i}
        _log(f"[zeropad main] {row}")
        rows.append(row)
        del x, y, z
        torch.cuda.empty_cache()
    for name, kw, B, want in ZP_CONV_MAIN_ROWS:
        cfg = vt.FFTConfig(convolution=True, **kw)
        shape = (B,) + cfg.shape
        x = vt.Planar(*_planes(shape, len(name), dev))
        h = vt.Planar(*_planes(cfg.shape, len(name) + 1, dev))
        app, y, got = _zp_conv_call(vt, ck, torch_engine, cfg, x, h, want,
                                    name)
        by_row[name] = {k: got.get(k, 0) for k in ck.zp_launches}
        # 4 items against fp64
        e = _zp_conv_check(cfg, x[:4], h, y[:4], torch.float32, name)
        row = {"row": name, "mode": app.fusion_mode, "shape": list(shape),
               "launches": got, "rel_err_vs_fp64": e}
        _log(f"[zeropad main] {row}")
        rows.append(row)
        del x, y, app
        torch.cuda.empty_cache()
    totals = {k: sum(c[k] for c in by_row.values()) for k in ck.zp_launches}
    _log(f"[zeropad main] launches over the path {totals}")
    assert all(totals[ck.zp_entry(k, torch.float32)] > 0
               for k in ck.ZP_KERNELS + ck.ZP_BLUESTEIN_KERNELS), totals
    return {"zp_launches": totals, "zp_launches_by_path": by_row,
            "plain_engine_calls": 0, "rows": rows}


def _zp_points(cfg, route: dict, B: int) -> tuple:
    """(windowed, unwindowed) points a round trip of ``cfg`` on ``B``
    systems reads and writes, each read once and each write once, from the
    walk of its route (api.FFTApplication's _elided_lines, _elided_pair,
    _elided_axes; the refill of a cropped result, read and written, with
    them).  Unwindowed: one read and one write of every point a pass, the
    pair kernel holding the two minor axes where pair_supports does."""
    from vkfft_tpu_torch.ops import cuda_engine as ce
    shape, nd = cfg.shape, len(cfg.shape)
    N = math.prod(shape) * B
    passes = (1 if nd == 1 else nd - 1
              if ce.pair_supports(shape[-2], shape[-1]) else nd)
    whole = 2 * passes * 2 * N
    kind = route["kind"]
    if kind in ("v3", "v2"):
        n = shape[-1]
        h, o = route["in_h"] or n, route["out_h"] or n
        return B * h + N + B * o + N, whole
    if kind == "blu":
        # the lines' own points (each route's m-point intermediates, the
        # same with and without the window, left out): the forward's kept
        # read and its write, the inverse's read and write and its mask
        return B * route["in_h"] + N + 2 * N + 2 * N, whole
    if kind == "interior":
        left, right = route["window"]
        return N - B * (right - left) + N + 2 * N, whole
    if kind == "axes":
        keep = route["keeps"]
    else:
        keep = dict(route["outer"])
        keep.update({nd - 2 + i: k for i, k in enumerate(route["minor"])
                     if k})
    def prod(e):
        return math.prod(e) * B
    def reads_elided():
        ext = [keep.get(a) or n for a, n in enumerate(shape)]
        pts = 0
        order = (range(nd - 1, -1, -1) if kind == "axes"
                 else list(range(nd - 2)) + [None])
        for ax in order:
            pts += prod(ext)
            if ax is None:
                ext = list(shape)
            else:
                ext[ax] = shape[ax]
            pts += prod(ext)
        return pts
    def writes_elided():
        ext = list(shape)
        pts = 0
        order = (range(nd) if kind == "axes" else [None] + list(range(nd - 2)))
        for ax in order:
            pts += prod(ext)
            if ax is None:
                ext[-2:] = [keep.get(nd - 2) or shape[-2],
                            keep.get(nd - 1) or shape[-1]]
            else:
                ext[ax] = keep.get(ax) or shape[ax]
            pts += prod(ext)
        return pts + prod(ext) + N
    return reads_elided() + writes_elided(), whole


def _graph_ms(fn, reps: int = REPS, inner: int = INNER):
    """The device time of ``fn``'s work replayed from a CUDA graph (its
    kernels back to back, no host enqueue between them), timed as
    `_time_ms` times a call; a string saying why where the capture
    fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return _time_ms(graph.replay, reps, inner)
    except Exception as e:   # a measurement, not a check: say why
        torch.cuda.synchronize()
        return f"not measured: {e!r}"[:200]


def phase_zeropad_times(vt, ck, dev) -> dict:
    """Each main-path row's round trip (forward + normalized inverse) with
    its windows beside the same transform without windows, beside the
    masked route the resolver chooses against (the window applied as a
    mask around the unwindowed walk, api.FFTApplication._transform's
    masked branch) and beside torch.fft's fftn + ifftn of the full array
    (complex64), in turns on
    the same planes, with the host's enqueue time of each and each one's
    device time replayed from a CUDA graph (`_graph_ms`: where the graph
    is faster than the call, the host held the card back), and the points
    each moves (`_zp_points`); and each windowed fp32 kernel at a main-path shape
    beside its unwindowed launch on the same planes, its plain version,
    torch.fft of the full planes, and its bound at the bytes it moves (the
    kept reads and writes, 8 B a point, over HBM_BYTES_PER_S)."""
    from vkfft_tpu_torch.api import apply_zeropad as mask
    rows = []
    for name, kw, B, _ in ZP_MAIN_ROWS:
        cfg = vt.FFTConfig(normalize=True, **kw)
        plain_cfg = vt.FFTConfig(normalize=True, shape=cfg.shape)
        shape = (B,) + cfg.shape
        x = vt.Planar(*_planes(shape, len(name), dev))
        app, full = vt.FFTApplication(cfg), vt.FFTApplication(plain_cfg)
        xc = torch.complex(x.re, x.im)
        dims = tuple(range(1, len(shape)))
        big = math.prod(shape) >= 1 << 26
        reps, inner = (5, 2) if big else (REPS, INNER)

        def windowed():
            app.inverse(app.forward(x))

        def unwindowed():
            full.inverse(full.forward(x))

        def masked():
            nd = len(cfg.shape)
            y = mask(full.forward(mask(x, cfg.zeropad_input, nd)),
                     cfg.zeropad_output, nd)
            mask(full.inverse(y), cfg.zeropad_input, nd)

        def torch_fft():
            torch.fft.ifftn(torch.fft.fftn(xc, dim=dims), dim=dims)

        t = {k: [] for k in ("windowed", "unwindowed", "masked", "torch")}
        for fn, k in ((unwindowed, "unwindowed"), (windowed, "windowed"),
                      (masked, "masked"), (masked, "masked"),
                      (windowed, "windowed"), (unwindowed, "unwindowed"),
                      (torch_fft, "torch")):
            t[k].append(_time_ms(fn, reps, inner))
        row = {"row": name, "mode": app.zeropad_mode, "shape": list(shape),
               "ms": min(t["windowed"]), "unwindowed_ms": min(t["unwindowed"]),
               "masked_ms": min(t["masked"]), "torch_fft_ms": t["torch"][0],
               "host_ms": _host_ms(windowed, 5 if big else 20),
               "unwindowed_host_ms": _host_ms(unwindowed, 5 if big else 20),
               "graph_ms": _graph_ms(windowed, reps, inner),
               "unwindowed_graph_ms": _graph_ms(unwindowed, reps, inner),
               "masked_graph_ms": _graph_ms(masked, reps, inner)}
        row["speedup_vs_unwindowed"] = row["unwindowed_ms"] / row["ms"]
        row["speedup_vs_masked"] = row["masked_ms"] / row["ms"]
        pts, whole = _zp_points(cfg, app.zeropad_route(), B)
        row.update(points_moved=pts, unwindowed_points_moved=whole,
                   byte_ratio=whole / pts)
        _log(f"[zeropad times] {row}")
        rows.append(row)
        del x, xc, app, full
        torch.cuda.empty_cache()
    rows += _zp_conv_times(vt, dev)
    kernels = _zp_kernel_times(ck, dev)
    kernels.update(_zp_blu_kernel_times(ck, dev))
    return {"rows": rows, "kernels": kernels}


def _zp_conv_times(vt, dev) -> list:
    """The convolution rows (ZP_CONV_MAIN_ROWS): the windowed call beside
    its dense twin (the same config without windows, on the same planes),
    the masked route (the input masked, the dense call) and the torch.fft
    composition of the windowed function (the input masked, fftn, the
    multiply, ifftn), in turns, with the host's enqueue time."""
    from vkfft_tpu_torch.api import apply_zeropad as mask
    rows = []
    for name, kw, B, _ in ZP_CONV_MAIN_ROWS:
        cfg = vt.FFTConfig(convolution=True, **kw)
        nd = len(cfg.shape)
        shape = (B,) + cfg.shape
        x = vt.Planar(*_planes(shape, len(name), dev))
        h = vt.Planar(*_planes(cfg.shape, len(name) + 1, dev))
        app = vt.ConvolutionApplication(cfg, h)
        dense = vt.ConvolutionApplication(
            vt.FFTConfig(convolution=True, shape=cfg.shape), h)
        dims = tuple(range(1, nd + 1))
        H = torch.fft.fftn(torch.complex(h.re, h.im),
                           dim=tuple(range(-nd, 0)))

        def windowed():
            app(x)

        def twin():
            dense(x)

        def masked():
            dense(mask(x, cfg.zeropad_input, nd))

        def torch_fft():
            xm = mask(x, cfg.zeropad_input, nd)
            torch.fft.ifftn(torch.fft.fftn(torch.complex(xm.re, xm.im),
                                           dim=dims) * H, dim=dims)

        t = {k: [] for k in ("windowed", "dense", "masked", "torch")}
        for fn, k in ((twin, "dense"), (windowed, "windowed"),
                      (masked, "masked"), (masked, "masked"),
                      (windowed, "windowed"), (twin, "dense"),
                      (torch_fft, "torch")):
            t[k].append(_time_ms(fn))
        row = {"row": name, "mode": app.fusion_mode, "shape": list(shape),
               "ms": min(t["windowed"]), "dense_ms": min(t["dense"]),
               "masked_ms": min(t["masked"]), "torch_fft_ms": t["torch"][0],
               "host_ms": _host_ms(windowed), "dense_host_ms": _host_ms(twin)}
        row["speedup_vs_dense"] = row["dense_ms"] / row["ms"]
        row["speedup_vs_masked"] = row["masked_ms"] / row["ms"]
        _log(f"[zeropad times] {row}")
        rows.append(row)
        del x, app, dense, H
        torch.cuda.empty_cache()
    return rows


def _zp_kernel_times(ck, dev) -> dict:
    """The four windowed fp32 kernels at main-path shapes: fft_lines_zp on
    4096 x 4096 lines reading half of each, fft_twofactor_zp on 1638 x
    10240 the same, fft_strided_zp on the 256^3 cube's x pass reading the
    (128, 128, 128) corner of the full cube in place (the outer axis) and
    on 512^3's middle axis from 256 kept rows, fft_pair_zp on 256 planes
    of 256^2 from their (128, 128) corners; each beside the unwindowed
    launch on the whole planes, the plain version and torch.fft of the
    whole planes."""
    out = {}
    cases = []
    x = _planes((4096, 4096), 1, dev)
    wx = ck.line_window(4096, in_keep=2048)
    cases.append(("fft_lines", "fft_lines_zp", x,
                  lambda: ck.fft_lines(*x, window=wx),
                  lambda: ck.fft_lines(*x),
                  lambda: ck.fft_lines_plain(*x, False, window=wx),
                  lambda: torch.fft.fft(torch.complex(*x), dim=-1),
                  4096 * 2048 + 4096 * 4096, 4096 * 4096, 4096))
    y = _planes((1638, 10240), 2, dev)
    wy = ck.line_window(10240, in_keep=5120)
    cases.append(("fft_twofactor", "fft_twofactor_zp", y,
                  lambda: ck.fft_twofactor(*y, window=wy),
                  lambda: ck.fft_twofactor(*y),
                  lambda: ck.fft_twofactor_plain(*y, False, window=wy),
                  lambda: torch.fft.fft(torch.complex(*y), dim=-1),
                  1638 * (5120 + 10240), 1638 * 10240, 10240))
    c = _planes((1, 256, 256, 256), 3, dev)
    cv = [t[:, :, :128, :128] for t in c]
    cf = [t.reshape(1, 256, 65536) for t in c]
    cases.append(("fft_strided", "fft_strided_zp", c,
                  lambda: ck.fft_strided(*cv, in_keep=128),
                  lambda: ck.fft_strided(*cf),
                  lambda: ck.fft_strided_plain(*cv, False,
                                               window=(256, 128, 256)),
                  lambda: torch.fft.fft(torch.complex(*cf), dim=1),
                  128 ** 3 + 256 * 128 * 128, 256 ** 3, 256))
    # the middle axis of the 512^3 axes route: 256 planes of (512, 512)
    # from their first 256 rows (the forward's y pass)
    m = _planes((256, 256, 512), 4, dev)
    mf = _planes((256, 512, 512), 5, dev)
    cases.append(("fft_strided", "fft_strided_zp", m,
                  lambda: ck.fft_strided(*m, in_keep=256, n=512),
                  lambda: ck.fft_strided(*mf),
                  lambda: ck.fft_strided_plain(*m, False,
                                               window=(512, 256, 512)),
                  lambda: torch.fft.fft(torch.complex(*mf), dim=1),
                  256 * 256 * 512 + 256 * 512 * 512, 256 * 512 * 512, 512))
    pc = [t[0, :, :128, :128].contiguous() for t in c]
    pf = [t[0] for t in c]
    cases.append(("fft_pair", "fft_pair_zp", pc,
                  lambda: ck.fft_pair(*pc, in_keep=(128, 128),
                                      plane=(256, 256)),
                  lambda: ck.fft_pair(*pf),
                  lambda: ck.fft_pair_plain(*pc, False, window=(
                      256, 256, 128, 128, 256, 256)),
                  lambda: torch.fft.fft2(torch.complex(*pf)),
                  256 * 128 * 128 + 256 ** 3, 256 ** 3, 256 * 256))
    tab = torch.stack(_planes((256 * 256,), 6, dev), -1).contiguous()
    cases.append(("fft_conv_pair", "fft_conv2d_zp", pf,
                  lambda: ck.fft_conv_pair(*pf, tab, scale=1 / 65536,
                                           in_keep=(128, 128)),
                  lambda: ck.fft_conv_pair(*pf, tab, scale=1 / 65536),
                  lambda: ck.fft_conv_pair_plain(
                      *pf, tab, None, scale=1 / 65536,
                      window=(256, 256, 128, 128, 256, 256)),
                  lambda: torch.fft.ifft2(torch.fft.fft2(
                      torch.complex(*pf)) * torch.complex(
                          tab[:, 0], tab[:, 1]).view(256, 256)),
                  256 * 128 * 128 + 256 ** 3 + 65536, 2 * 256 ** 3,
                  256 * 256))
    shapes = ["4096 x 4096, in_keep 2048", "1638 x 10240, in_keep 5120",
              "256^3 x pass from the (128, 128, 128) corner",
              "256 x 512 x 512 from 256 rows",
              "256 x 256^2 from (128, 128) corners",
              "sample 51: 256 x 256^2 convolved from (128, 128) corners of "
              "the whole planes, read in place"]
    for shape, (name, entry, _, win, whole, plain, lib, pts, full_pts,
                n) in zip(shapes, cases):
        got, ref = win(), plain()
        err = _zp_check(got, ref, torch.float32, entry)
        tw = [_time_ms(f) for f in (whole, win, win, whole)]
        plain_ms = _time_ms(plain, 5, 2)
        lib_ms = _time_ms(lib)
        bound, by = _bound(8.0 * pts, _fft_ops(full_pts, n))
        # a convolution's full_pts counts its two 2-D FFTs' points; its
        # unwindowed launch moves each point once each way
        moved = full_pts // 2 if name == "fft_conv_pair" else full_pts
        full_bound = _bound(16.0 * moved, _fft_ops(full_pts, n))[0]
        row = {"kernel": entry, "ms": min(tw[1], tw[2]),
               "unwindowed_ms": min(tw[0], tw[3]), "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
               "unwindowed_bound_ms": full_bound, "max_abs_err": max(
                   (a - b).abs().max().item() for a, b in zip(got, ref)),
               "rel_err": err, "shape": shape,
               "kept_points_moved": pts,
               "whole_points_moved": 2 * full_pts}
        _log(f"[zeropad times] {row}")
        out.setdefault(entry, []).append(row)
        del got, ref
    del x, y, c, cv, cf, m, mf, pc, pf
    torch.cuda.empty_cache()
    return out


# the windowed kernels of Bluestein's read window at the main path's rows:
# (route, n, the read window)
ZP_BLU_TIMES = (("fft_conv", 4054, 2027), ("fft_conv_pair", 10007, 3000),
                ("fft_strided_tw", 65537, 32768))


def _zp_blu_kernel_times(ck, dev) -> dict:
    """The three windowed entries of Bluestein's read window at the blu
    main-path rows' shapes (ZP_BLU_TIMES, 64 MiB of fp32 planes): the
    windowed launch, the unwindowed launch on the same planes, the plain
    version, torch.fft of the same lines (the same
    function for the two conv kernels, their library_ms; the long tier's
    first pass has none), each timed in turns, and the bound at the kept
    bytes (the window's reads, every write, the tables once) and the
    operations of the kernel's m-point work."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    out = {}
    for route, n, keep in ZP_BLU_TIMES:
        B = SAMPLE_7_BYTES // (8 * n)
        m = plan_axis(n).decomp.bluestein_size
        name, run, plain, _ = _blu_kernel(ck, n, dev)
        assert name == route, (name, route)
        t = torch.arange(n, device=dev)
        x, x0 = _zp_input((B, n), n, dev, torch.float32, (t >= keep)[None, :])
        got, ref = run(x, keep), plain(x0)
        err = _zp_check(got, ref, torch.float32, name)
        xc = torch.complex(*x0)
        if name == "fft_strided_tw":
            nc, ns = ck.bluestein_long_split(m)
            kept = 8.0 * (B * keep + B * m)
            ops = _fft_ops(B * m, nc) + 2 * _cmul_ops(B * m)
            whole = 8.0 * (B * n + B * m)
        else:
            kept = 8.0 * (B * keep + B * n + m + n)
            ops = B * (2 * _fft_ops(m, m) + _cmul_ops(m))
            whole = 8.0 * (2 * B * n + m + n)
        bound, by = _bound(kept, ops)

        def windowed():
            run(x, keep)

        def unwindowed():
            run(x0, 0)

        seq = (("unwindowed", unwindowed), ("windowed", windowed),
               ("windowed", windowed), ("unwindowed", unwindowed))
        t_ms = {}
        for k, fn in seq:
            t_ms.setdefault(k, []).append(_time_ms(fn))
        fft_ms = _time_ms(lambda: torch.fft.fft(xc))
        row = {"kernel": ck.zp_entry(name, torch.float32),
               "ms": min(t_ms["windowed"]),
               "unwindowed_ms": min(t_ms["unwindowed"]),
               "plain_ms": _time_ms(lambda: plain(x0), 5, 2),
               "library_ms": None if name == "fft_strided_tw" else fft_ms,
               "torch_fft_n_ms": fft_ms, "bound_ms": bound, "bound_by": by,
               "unwindowed_bound_ms": _bound(whole, ops)[0],
               "max_abs_err": max((a - b).abs().max().item()
                                  for a, b in zip(got, ref)),
               "rel_err": err, "shape": f"{B} x {n}, in_keep {keep} (m = "
                                        f"{m})",
               "kept_bytes": kept}
        _log(f"[zeropad times] {row}")
        out.setdefault(row["kernel"], []).append(row)
        del x, x0, xc, got, ref
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# keep_intermediate_order: fft_lines' and fft_pair's tl entries and
# fft_twofactor at split_lane_major (the kept-order phases)
# ---------------------------------------------------------------------------

TL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# (lines, n) of fft_lines' tl entry: one pass (256), two factors (1024 as
# 64 x 16, 4096 as 256 x 16, 8192 as 128 x 64)
TL_LINES = ((64, 256), (17, 1024), (5, 4096), (3, 8192))
# fft_twofactor at split_lane_major: the lengths where it is twofactor_split
# too (134) or not (10240's (128, 80); and every length of _tl_differ)
TL_TWOFACTOR_NAMED = (134, 10240)
TL_TWOFACTOR_HALF_STRIDE = 10   # every 10th differing length at bf16/f16
# (B, ny, nz) of fft_pair's tl entry: sample 5's 256^2, the tests' 128 x
# 256, two-factor axes on either side, an odd plane (cluster 1), a column
# tile of odd width, several clusters
TL_PAIR = ((3, 256, 256), (2, 128, 256), (2, 2, 8064), (2, 8064, 2),
           (3, 47, 60), (2, 64, 12), (3, 16, 64))


def _tl_differ(ck, ce) -> list:
    """The lengths where the kept-order route runs fft_twofactor at a split
    other than its own twofactor_split (121 of them, 8208 on)."""
    from vkfft_tpu_torch.planner.plan import plan_axis
    return [n for n in range(8193, ck.TWOFACTOR_MAX_N + 1)
            if ce.keep_order_kernel(plan_axis(n)) == "fft_twofactor"
            and ck.split_lane_major(n) != ck.twofactor_split(n)]


def phase_keep_order_kernels(ck, ce, dev) -> dict:
    """The kept-order entries against their plain versions on the same
    inputs, both directions, fp32 within KERNEL_TOL and the half dtypes
    within 2 storage ulps, every output inside sentinel guards that must
    stay unwritten: fft_lines' tl entry (TL_LINES; and in place),
    fft_twofactor swapped at split_lane_major (every length where that is
    not its own twofactor_split, at bf16 / f16 every TL_TWOFACTOR_HALF_
    STRIDE-th, and TL_TWOFACTOR_NAMED), fft_pair's tl entry (TL_PAIR: the
    forward to the transposed planes, the inverse from them).  Prints the
    tl kernels' ptxas lines."""
    out = {}
    lines_log = {}
    for name in ck.TL_KERNELS:
        with open(ck.library_path(name)[:-3] + ".log") as f:
            lines_log.update({k: v for k, v in _ptxas_lines(f.read()).items()
                              if "_tl" in k})
    for k, v in sorted(lines_log.items()):
        _log(f"[keep_order ptxas] {k}: {v}")
    out["ptxas"] = lines_log
    for B, n in TL_LINES:
        for dt in TL_DTYPES:
            key = f"fft_lines_tl{ck._SUFFIX[dt]}_n{n}"
            for inv in (False, True):
                s = 1.0 / n if inv else 1.0
                x, _ = _zp_input((B, n), n + inv, dev, dt, None)
                p = ck.fft_lines_plain(*x, inv, s, tl=True)
                _zp_case(ck, out, key, lambda out: ck.fft_lines(
                    *x, inv, s, out=out, tl=True), p, (B, n), dt, dev)
                y = [t.clone() for t in x]
                ck.fft_lines(*y, inv, s, out=y, tl=True)
                _zp_case(ck, out, key, lambda out: [
                    o.copy_(t) for o, t in zip(out, y)], p, (B, n), dt, dev)
    differ = _tl_differ(ck, ce)
    assert len(differ) == 121 and differ[0] == 8208, differ[:3]
    for dt in TL_DTYPES:
        ns = (differ if dt == torch.float32
              else differ[::TL_TWOFACTOR_HALF_STRIDE]) + list(
                  TL_TWOFACTOR_NAMED)
        for n in ns:
            split = ck.split_lane_major(n)
            key = f"fft_twofactor{ck._SUFFIX[dt]}_split_lane_major"
            for inv in (False, True):
                s = 1.0 / n if inv else 1.0
                x, _ = _zp_input((3, n), n + inv, dev, dt, None)
                p = ck.fft_twofactor_plain(*x, inv, s, True, split=split)
                _zp_case(ck, out, key, lambda out: ck.fft_twofactor(
                    *x, inv, s, swapped=True, split=split, out=out),
                    p, (3, n), dt, dev)
    for B, ny, nz in TL_PAIR:
        for dt in TL_DTYPES:
            if ck.pair_cluster(ny, nz, dt) is None:
                continue
            key = f"fft_pair_tl{ck._SUFFIX[dt]}_{ny}x{nz}"
            x, _ = _zp_input((B, ny, nz), ny + nz, dev, dt, None)
            p = ck.fft_pair_plain(*x, False, 1.0, tl=True)
            _zp_case(ck, out, key, lambda out: ck.fft_pair(
                *x, out=out, tl=True), p, (B, nz, ny), dt, dev)
            s = 1.0 / (ny * nz)
            x, _ = _zp_input((B, nz, ny), ny + nz + 1, dev, dt, None)
            p = ck.fft_pair_plain(*x, True, s, tl=True)
            _zp_case(ck, out, key, lambda out: ck.fft_pair(
                *x, True, s, out=out, tl=True), p, (B, ny, nz), dt, dev)
    torch.cuda.synchronize()
    for key, rec in out.items():
        if key != "ptxas":
            _log(f"[keep_order kernels] {key}: {rec}")
    return out


# (name, shape, batch, the kept-order launches of a round trip by entry
# stem: the tl entries' or fft_twofactor's; {} for n <= 4) of keep_order
# routes; the kinds of the forward's result
TL_ROUTES = (
    ("tiny_n4", (4,), 5, {}, "tl"),
    ("lines_n256", (256,), 9, {"fft_lines_tl": 2}, "tl"),
    ("lines_n1024", (1024,), 3, {"fft_lines_tl": 2}, "tl"),
    ("lines_n4096", (4096,), 3, {"fft_lines_tl": 2}, "tl"),
    ("lines_n8192", (8192,), 2, {"fft_lines_tl": 2}, "tl"),
    ("v2_n134", (134,), 5, {"fft_twofactor": 2}, "v2"),
    ("v2_n8208", (8208,), 2, {"fft_twofactor": 2}, "v2"),
    ("v2_n8320", (8320,), 2, {"fft_twofactor": 2}, "v2"),
    ("v2_n10240", (10240,), 2, {"fft_twofactor": 2}, "v2"),
    ("pair_128x256", (128, 256), 2, {"fft_pair_tl": 2}, "tl"),
    ("pair_2x8064", (2, 8064), 2, {"fft_pair_tl": 2}, "tl"),
    ("pair_47x60", (47, 60), 3, {"fft_pair_tl": 2}, "tl"),
)


def _tl_launches(ck, torch_engine, want, dt, what) -> dict:
    """Exactly ``want`` ({entry stem: count}, at ``dt``'s instantiations)
    kept-order launches since the last reset and no other launch, no
    plain-engine call."""
    sfx = ck._SUFFIX[dt]
    want = {k + sfx: v for k, v in want.items()}
    got = {k: v for d in (ck.launches, ck.storage_launches, ck.tl_launches,
                          ck.zp_launches, ck.f64_launches)
           for k, v in d.items() if v}
    assert got == want, (what, got, want)
    assert torch_engine.calls == 0, (what, torch_engine.calls)
    return got


def _tl_natural(ck, y, shape, kind) -> torch.Tensor:
    """The forward's kept-order result as a complex128 natural spectrum:
    a TlSpectrum decoded by itself, the v2 swapped order of
    split_lane_major by its digits."""
    if kind == "tl":
        y = y.natural()
        return torch.complex(y.re.double(), y.im.double())
    n1, n2 = ck.split_lane_major(shape[-1])
    lead = y.shape[:-1]
    return torch.complex(*(t.double().reshape(*lead, n2, n1).transpose(-1, -2)
                           .reshape(*lead, n1 * n2) for t in (y.re, y.im)))


def phase_keep_order_routes(vt, ck, torch_engine, dev) -> dict:
    """FFTApplication(keep_intermediate_order=True) on the card (TL_ROUTES)
    in fp32 and at bfloat16: each round trip counted from 0 and held to
    its exact launches (a fresh application of the config runs the
    inverse), the forward's form (a TlSpectrum or the v2 swapped Planar)
    decoded to natural order against torch.fft complex128 of the input,
    the round trip against the input, at the gates (NUMPY_TOL; the half
    tier's STORAGE_NUMPY_TOL); a complex tensor with the flag runs the
    natural route."""
    rows = []
    for name, shape, B, want, kind in TL_ROUTES:
        for prec, dt in ((vt.Precision.SINGLE, torch.float32),
                         (vt.Precision.BFLOAT16, torch.bfloat16)):
            cfg = vt.FFTConfig(shape=shape, normalize=True, precision=prec,
                               keep_intermediate_order=True)
            x = vt.Planar(*_planes((B,) + shape, len(name), dev))
            torch.cuda.synchronize()
            ck.reset_launches()
            torch_engine.calls = 0
            y = vt.FFTApplication(cfg).forward(x)
            z = vt.FFTApplication(cfg).inverse(y)
            torch.cuda.synchronize()
            got = _tl_launches(ck, torch_engine, want, dt, name)
            assert isinstance(y, vt.TlSpectrum) == (kind == "tl"), name
            assert y.dtype == dt and z.dtype == dt and z.shape == x.shape
            dims = tuple(range(1, len(shape) + 1))
            xw = torch.complex(x.re.to(dt).double(), x.im.to(dt).double())
            e_f = _rel(_tl_natural(ck, y, shape, kind),
                       torch.fft.fftn(xw, dim=dims))
            e_i = _rel(torch.complex(z.re.double(), z.im.double()), xw)
            tol = NUMPY_TOL if dt == torch.float32 else STORAGE_NUMPY_TOL[
                "bf16"]
            row = {"route": name, "dtype": str(dt), "shape": [B, *shape],
                   "launches": got, "rel_err_fwd_vs_fp64": e_f,
                   "rel_err_inv_vs_input": e_i}
            _log(f"[keep_order routes] {row}")
            assert e_f <= tol and e_i <= tol, row
            rows.append(row)
    # a complex tensor ignores the flag: natural, the unflagged launches
    x = torch.complex(*_planes((3, 4096), 5, dev))
    y = vt.FFTApplication(vt.FFTConfig(shape=(4096,),
                                       keep_intermediate_order=True)).forward(x)
    assert torch.is_tensor(y) and _rel(
        y.to(torch.complex128), torch.fft.fft(x.to(torch.complex128))) \
        <= NUMPY_TOL
    return {"rows": rows}


# sample 5 (vkfft_tpu/cli.py:770-805: keep_intermediate_order round trips
# at 64 MiB of complex64): (name, shape, batch, {launch key: count} of a
# round trip)
SAMPLE_5_BYTES = 64 * 1024 * 1024
TL_MAIN_ROWS = (
    ("sample5_n4096", (4096,), SAMPLE_5_BYTES // (8 * 4096),
     {"fft_lines_tl": 2}),
    ("sample5_n65536", (65536,), SAMPLE_5_BYTES // (8 * 65536), None),
    ("sample5_pair_256^2", (256, 256), SAMPLE_5_BYTES // (8 * 65536),
     {"fft_pair_tl": 2}),
)


def phase_keep_order_main_path(vt, ck, ce, torch_engine, dev) -> dict:
    """Sample 5's rows at full width through FFTApplication(normalize=True,
    keep_intermediate_order=True) on fp32 Planar input (TL_MAIN_ROWS): the
    4096-point lines and the 256^2 pair as kept-order round trips (2
    launches of the tl entry each, nothing else: no reorder op), 65536 on
    its natural long route (the reference takes no other length,
    vkfft_tpu/api.py:449-477) with that route's launches; each counted
    from 0, no plain-engine call, finite, 16 lines or planes of the
    forward against torch.fft complex128 and the round trip against the
    input."""
    rows, by_row = [], {}
    for name, shape, B, want in TL_MAIN_ROWS:
        if want is None:
            want = _route_launches(ce, shape[-1])
        cfg = vt.FFTConfig(shape=shape, normalize=True,
                           keep_intermediate_order=True)
        x = vt.Planar(*_planes((B,) + shape, len(name), dev))
        app = vt.FFTApplication(cfg)
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        y = app.forward(x)
        z = app.inverse(y)
        torch.cuda.synchronize()
        got = _tl_launches(ck, torch_engine, want, torch.float32, name)
        by_row[name] = {k: got.get(k, 0) for k in ck.tl_launches}
        kind = "tl" if isinstance(y, vt.TlSpectrum) else "natural"
        assert (kind == "tl") == (name != "sample5_n65536"), name
        assert _finite(y, z), name
        dims = tuple(range(1, len(shape) + 1))
        nat = y.natural() if kind == "tl" else y
        xs = torch.complex(x.re[:16].double(), x.im[:16].double())
        e_f = _rel(torch.complex(nat.re[:16].double(), nat.im[:16].double()),
                   torch.fft.fftn(xs, dim=dims))
        e_i = _rel(torch.complex(z.re.double(), z.im.double()),
                   torch.complex(x.re.double(), x.im.double()))
        row = {"row": name, "form": kind, "shape": [B, *shape],
               "launches": got, "rel_err_fwd_vs_fp64": e_f,
               "rel_err_inv_vs_input": e_i}
        _log(f"[keep_order main] {row}")
        assert e_f <= NUMPY_TOL and e_i <= NUMPY_TOL, row
        rows.append(row)
        del x, y, z, nat
        torch.cuda.empty_cache()
    totals = {k: sum(c[k] for c in by_row.values()) for k in ck.tl_launches}
    _log(f"[keep_order main] launches over the path {totals}")
    assert totals["fft_lines_tl"] > 0 and totals["fft_pair_tl"] > 0, totals
    return {"tl_launches": totals, "tl_launches_by_path": by_row,
            "plain_engine_calls": 0, "rows": rows}


def phase_keep_order_times(vt, ck, dev) -> dict:
    """Sample 5's round trips (TL_MAIN_ROWS) kept-order beside the same
    config without the flag (the natural twin) and torch.fft's fft + ifft
    of the complex64 data, in turns on the same planes, each with the
    host's enqueue time; and the kept-order kernels at the rows' shapes
    (fft_lines' tl entry on 2048 x 4096, fft_pair's on 128 x 256^2, both
    directions; fft_twofactor swapped at split_lane_major on 1022 x 8208)
    beside the natural launch on the same planes (fft_twofactor: swapped
    at its own twofactor_split), the plain version, torch.fft of the same
    function, and the bound of their bytes (16 B a point, read and
    written once) and operations."""
    rows = []
    for name, shape, B, _ in TL_MAIN_ROWS:
        x = vt.Planar(*_planes((B,) + shape, len(name), dev))
        tl = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True,
                                            keep_intermediate_order=True))
        nat = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True))
        xc = torch.complex(x.re, x.im)
        dims = tuple(range(1, len(shape) + 1))

        def kept():
            tl.inverse(tl.forward(x))

        def natural():
            nat.inverse(nat.forward(x))

        def torch_fft():
            torch.fft.ifftn(torch.fft.fftn(xc, dim=dims), dim=dims)

        t = {k: [] for k in ("kept", "natural", "torch")}
        for fn, k in ((natural, "natural"), (kept, "kept"), (kept, "kept"),
                      (natural, "natural"), (torch_fft, "torch")):
            t[k].append(_time_ms(fn))
        pts = B * math.prod(shape)
        # the function's bound: each point read and written once a
        # direction, whatever the route's passes
        bound, by = _bound(2 * 16.0 * pts, 2 * _fft_ops(pts, pts // B))
        row = {"row": name, "shape": [B, *shape], "ms": min(t["kept"]),
               "natural_ms": min(t["natural"]), "torch_fft_ms": t["torch"][0],
               "host_ms": _host_ms(kept), "natural_host_ms": _host_ms(natural),
               "bound_ms": bound, "bound_by": by,
               "kept_vs_natural": min(t["natural"]) / min(t["kept"])}
        _log(f"[keep_order times] {row}")
        rows.append(row)
        del x, xc, tl, nat
        torch.cuda.empty_cache()
    return {"rows": rows, "kernels": _tl_kernel_times(ck, dev)}


def _tl_kernel_times(ck, dev) -> dict:
    out = {}
    lx = _planes((2048, 4096), 11, dev)
    ltl = [t.clone() for t in lx]
    px = _planes((128, 256, 256), 12, dev)
    ptl = _planes((128, 256, 256), 13, dev)
    n2 = 8208
    tx = _planes((SAMPLE_5_BYTES // (8 * n2), n2), 14, dev)
    sl = ck.split_lane_major(n2)
    cases = [
        ("fft_lines_tl", "2048 x 4096 forward",
         lambda: ck.fft_lines(*lx, tl=True), lambda: ck.fft_lines(*lx),
         lambda: ck.fft_lines_plain(*lx, False, tl=True),
         lambda: torch.fft.fft(torch.complex(*lx)), 2048 * 4096, 4096),
        ("fft_lines_tl", "2048 x 4096 inverse",
         lambda: ck.fft_lines(*ltl, True, 1 / 4096, tl=True),
         lambda: ck.fft_lines(*ltl, True, 1 / 4096),
         lambda: ck.fft_lines_plain(*ltl, True, 1 / 4096, tl=True),
         lambda: torch.fft.ifft(torch.complex(*ltl)), 2048 * 4096, 4096),
        ("fft_pair_tl", "128 x 256^2 forward",
         lambda: ck.fft_pair(*px, tl=True), lambda: ck.fft_pair(*px),
         lambda: ck.fft_pair_plain(*px, False, tl=True),
         lambda: torch.fft.fft2(torch.complex(*px)), 128 * 65536, 65536),
        ("fft_pair_tl", "128 x 256^2 inverse",
         lambda: ck.fft_pair(*ptl, True, 1 / 65536, tl=True),
         lambda: ck.fft_pair(*ptl, True, 1 / 65536),
         lambda: ck.fft_pair_plain(*ptl, True, 1 / 65536, tl=True),
         lambda: torch.fft.ifft2(torch.complex(*ptl)), 128 * 65536, 65536),
        ("fft_twofactor_split", f"{tx[0].shape[0]} x {n2} swapped at "
         f"split_lane_major {sl} (its own {ck.twofactor_split(n2)})",
         lambda: ck.fft_twofactor(*tx, swapped=True, split=sl),
         lambda: ck.fft_twofactor(*tx, swapped=True),
         lambda: ck.fft_twofactor_plain(*tx, False, swapped=True, split=sl),
         lambda: torch.fft.fft(torch.complex(*tx)), tx[0].numel(), n2),
    ]
    for key, shape, run, twin, plain, lib, pts, n in cases:
        got, ref = run(), plain()
        err = _zp_check(got, ref, torch.float32, key)
        tt = [_time_ms(f) for f in (twin, run, run, twin)]
        row = {"kernel": key, "shape": shape, "ms": min(tt[1], tt[2]),
               "natural_ms": min(tt[0], tt[3]),
               "plain_ms": _time_ms(plain, 5, 2), "library_ms": _time_ms(lib),
               "max_abs_err": max((a - b).abs().max().item()
                                  for a, b in zip(got, ref)),
               "rel_err": err}
        row["bound_ms"], row["bound_by"] = _bound(16.0 * pts,
                                                  _fft_ops(pts, n))
        _log(f"[keep_order times] {row}")
        out.setdefault(key, []).append(row)
        del got, ref
    del lx, ltl, px, ptl, tx
    torch.cuda.empty_cache()
    return out


# --- the distributed layer (vkfft_tpu_torch.parallel) ------------------------

PAR_PFFT = (65536, 256)          # pfft: 65536 lines of 256, 128 MiB of planes
PAR_CUBES = ((256, 256, 256), (512, 512, 512))
PAR_WORLD = 4                    # the gloo world on the one card
PAR_JOIN_S = 300                 # its deadline: a hung collective fails
# each world-of-1 part's launches, forward and inverse (the convolution:
# its call; pfft: its forward), and its exchanges
PAR_LAUNCHES = {
    "slab_256^3": {"fft_pair": 2, "fft_strided": 2},
    "slab_chunks2_256^3": {"fft_pair": 2, "fft_strided": 4},
    "pencil_256^3": {"fft_lines": 2, "fft_strided": 4},
    "prfftn_256^3": {"fft_r2c": 2, "fft_strided": 4},
    "conv_256^3": {"fft_pair": 2, "fft_strided": 2},
    "pfft_65536x256": {"fft_lines": 1},
}
PAR_EXCHANGES = {"slab_256^3": 2, "slab_chunks2_256^3": 4,
                 "pencil_256^3": 4, "prfftn_256^3": 2, "conv_256^3": 2,
                 "pfft_65536x256": 0}


def _nccl_world() -> None:
    """A world of one rank on NCCL in this process, on its own store."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1


def _local(y):
    """The local planes or tensor of a facade's DTensor result."""
    if isinstance(y, tuple):
        return tuple(_local(t) for t in y)
    if hasattr(y, "re"):
        return type(y)(_local(y.re), _local(y.im))
    return y.to_local() if hasattr(y, "to_local") else y


def _c(p) -> torch.Tensor:
    return torch.complex(p.re, p.im) if hasattr(p, "re") else p


def phase_parallel_main_path(vt, ck, torch_engine, dev) -> dict:
    """The distributed layer on a world of one rank on NCCL, through the
    entry points a user calls: slab (chunk 1 and 2) and pencil (1, 1)
    forward and inverse of the 256^3 cube, prfftn / pirfftn of the real
    cube, DistributedConvolution at 256^3 and pfft of 65536 lines of 256,
    each counted from 0 and held to its exact launches and exchanges, no
    plain-engine call; each result against the port's single-device
    transform on the card (<= KERNEL_TOL) and the forward against
    torch.fft complex128 or numpy (<= NUMPY_TOL)."""
    from vkfft_tpu_torch import parallel as par
    from vkfft_tpu_torch.parallel import pencil
    _nccl_world()
    slab = par.fft_mesh()
    pen = par.fft_mesh((1, 1), ("px", "py"))
    x = vt.Planar(*_planes(CUBE, 51, dev))
    xr = _planes(CUBE, 52, dev)[0]
    k = vt.Planar(*_planes(CUBE, 53, dev))
    lines = vt.Planar(*_planes(PAR_PFFT, 54, dev))
    keep = [t.clone() for t in (x.re, x.im, xr, lines.re)]
    conv = par.DistributedConvolution(CUBE, slab, k)
    apps = {"slab_256^3": par.DistributedFFT(CUBE, slab),
            "slab_chunks2_256^3": par.DistributedFFT(CUBE, slab,
                                                     overlap_chunks=2),
            "pencil_256^3": par.DistributedFFT(CUBE, pen)}
    assert apps["slab_256^3"]._tail_pair

    def round_trip(app):
        y = app.forward(app.shard_input(x))
        return y, app.inverse(y)

    def real_round_trip():
        Y = par.prfftn(xr, slab)
        return Y, par.pirfftn(Y, CUBE, slab)

    paths = [(name, (lambda a=a: round_trip(a))) for name, a in apps.items()]
    paths += [("prfftn_256^3", real_round_trip),
              ("conv_256^3", lambda: (conv(x),)),
              ("pfft_65536x256", lambda: (par.pfft(lines, slab),))]
    torch.cuda.synchronize()
    results, by_path, xchg_by_path = {}, {}, {}
    for name, drive in paths:
        ck.reset_launches()
        torch_engine.calls = 0
        before = pencil.exchanges
        results[name] = _local(drive())
        torch.cuda.synchronize()
        got = dict(ck.launches)
        by_path[name] = got
        xchg_by_path[name] = pencil.exchanges - before
        _log(f"[main par] {name}: launches {got}, exchanges "
             f"{xchg_by_path[name]}, plain engine calls {torch_engine.calls}")
        want = PAR_LAUNCHES[name]
        assert got == {k: want.get(k, 0) for k in got}, (name, got, want)
        assert xchg_by_path[name] == PAR_EXCHANGES[name], name
        assert torch_engine.calls == 0, (name, torch_engine.calls)

    assert all(torch.equal(a, b) for a, b in
               zip(keep, (x.re, x.im, xr, lines.re))), "inputs changed"
    del keep
    rows = []

    def row(name, **errs):
        r = {"row": name, **errs}
        _log(f"[main par] {r}")
        for key, err in errs.items():
            assert err <= (NUMPY_TOL if key.endswith("fp64")
                           or key.endswith("round_trip") else KERNEL_TOL), r
        rows.append(r)

    xc = _c(x)
    ref = vt.fftn(x)
    ref64 = torch.fft.fftn(xc.to(torch.complex128))
    y, z = results["slab_256^3"]
    row("slab_256^3", vs_single_device=_rel(_c(y), _c(ref)),
        vs_fp64=_rel(_c(y).to(torch.complex128), ref64),
        round_trip=_rel(_c(z), xc))
    y2, z2 = results["slab_chunks2_256^3"]
    bitwise = bool(torch.equal(y2.re, y.re) and torch.equal(y2.im, y.im)
                   and torch.equal(z2.re, z.re) and torch.equal(z2.im, z.im))
    row("slab_chunks2_256^3", vs_single_device=_rel(_c(y2), _c(ref)),
        round_trip=_rel(_c(z2), xc))
    # chunking changes the schedule, not one bit of the result
    assert bitwise, "overlap_chunks=2 differs from the monolithic slab"
    rows[-1]["bitwise_equal_to_chunk_1"] = bitwise
    y3, z3 = results["pencil_256^3"]
    row("pencil_256^3", vs_single_device=_rel(_c(y3), _c(ref)),
        vs_fp64=_rel(_c(y3).to(torch.complex128), ref64),
        round_trip=_rel(_c(z3), xc))
    del ref64
    Y, back = results["prfftn_256^3"]
    rref = vt.rfftn(xr)
    row("prfftn_256^3", vs_single_device=_rel(_c(Y), rref),
        vs_fp64=_rel(_c(Y).to(torch.complex128),
                     torch.fft.rfftn(xr.to(torch.float64))),
        round_trip=_rel(back, xr))
    (cy,) = results["conv_256^3"]
    want = vt.ifftn(vt.fftn(x) * vt.fftn(k))
    row("conv_256^3", vs_single_device=_rel(_c(cy), _c(want)))
    (ly,) = results["pfft_65536x256"]
    head = _c(lines)[:1024].cpu().numpy().astype(np.complex128)
    row("pfft_65536x256", vs_single_device=_rel(_c(ly), _c(vt.fft(lines))),
        vs_numpy_fp64=float(np.abs(_c(ly)[:1024].cpu().numpy()
                                   - np.fft.fft(head)).max()
                            / np.abs(np.fft.fft(head)).max()))
    assert all(_finite(p) for p in (y, z, y2, z2, y3, z3, cy, ly))
    return {"launches": {k: sum(c[k] for c in by_path.values())
                         for k in ck.launches},
            "launches_by_path": {f"parallel_{k}": v
                                 for k, v in by_path.items()},
            "exchanges_by_path": xchg_by_path, "plain_engine_calls": 0,
            "nccl": str(torch.cuda.nccl.version()),
            "rows": rows}


def _world_rank(rank: int, path: str, backend: str, world: int) -> None:
    """One rank of a spawned world (`_world`): gloo with every rank on the
    one card, or NCCL with rank r on card r; its checks and times
    (`_world_checks`) written for the parent."""
    import datetime
    import traceback
    import torch.distributed as dist
    dev = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{path}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PAR_JOIN_S))
    try:
        out = _world_checks(rank, world, dev, backend == "nccl")
    except Exception:   # the parent reports it and fails the phase
        out = {"failed": traceback.format_exc()}
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    if "failed" not in out:
        dist.destroy_process_group()


def _world_checks(rank: int, world: int, dev, timed: bool) -> dict:
    """`__graft_entry__.dryrun_multichip`'s checks at 256^3 on a world of
    ``world`` ranks: slab, pencil (2, world / 2), the real slab, pfft and a
    hybrid mesh with overlap_chunks=2; each rank's shard held against its
    block of the port's single-device result on its card, the slab's
    launches and exchanges counted on every rank, the errors gathered to
    rank 0.  The slab and pencil round trips timed: by CUDA events where
    ``timed`` (NCCL), else by the host clock over a few runs (gloo, whose
    exchanges go through the host)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch import parallel as par
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    from vkfft_tpu_torch.ops import torch_engine
    from vkfft_tpu_torch.parallel import pencil
    from vkfft_tpu_torch.parallel.pencil import _slices
    x = vt.Planar(*_planes(CUBE, 61, dev))     # the same on every rank
    xr = _planes(CUBE, 62, dev)[0]
    lines = vt.Planar(*_planes(PAR_PFFT, 63, dev))
    slab = par.fft_mesh((world,), ("fft",))
    pen = par.fft_mesh((2, world // 2), ("px", "py"))
    hyb = par.hybrid_fft_mesh((1, world // 2), (2, 1), ("px", "py"))
    ref = _c(vt.fftn(x))
    xc = _c(x)

    def block(t, mesh, placements):
        return t[_slices(mesh, t.shape, placements)]

    errs = {}

    def hold(name, got, want, mesh, placements):
        errs[name] = _rel(_c(_local(got)), block(want, mesh, placements))

    app = par.DistributedFFT(CUBE, slab)
    xl = app.shard_input(x)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch_engine.calls = 0
    before = pencil.exchanges
    y = app.forward(xl)
    app.inverse(y)
    torch.cuda.synchronize()
    counts = {"launches": {k: v for k, v in ck.launches.items() if v},
              "exchanges": pencil.exchanges - before,
              "plain_engine_calls": torch_engine.calls}
    assert counts["launches"] == {"fft_pair": 2, "fft_strided": 2}, counts
    assert counts["exchanges"] == 2 and torch_engine.calls == 0, counts
    for name, mesh, oc in (("slab", slab, 1), ("pencil", pen, 1),
                           ("hybrid_chunks2", hyb, 2)):
        app = par.DistributedFFT(CUBE, mesh, overlap_chunks=oc)
        y = par.pfftn(x, mesh, overlap_chunks=oc)
        hold(f"{name}_fwd", y, ref, mesh, app.output_spec())
        hold(f"{name}_round_trip", par.pifftn(y, mesh, overlap_chunks=oc),
             xc, mesh, app.input_spec())
    app = par.DistributedFFT(CUBE, slab, real=True)
    Y = par.prfftn(xr, slab)
    hold("real_fwd", Y, vt.rfftn(xr), slab, app.output_spec())
    hold("real_round_trip", par.pirfftn(Y, CUBE, slab), xr, slab,
         app.input_spec())
    hold("pfft", par.pfft(lines, slab), _c(vt.fft(lines)), slab,
         (Shard(0),))
    del x, xr, lines, ref, xc, y, Y
    torch.cuda.empty_cache()
    times = {}
    for cube in (PAR_CUBES if timed else PAR_CUBES[:1]):
        name = "x".join(map(str, cube))
        for kind, mesh in (("slab", slab), ("pencil", pen)):
            app = par.DistributedFFT(cube, mesh)
            xl = app.shard_input(vt.Planar(*_planes(cube, 64, dev)))
            fn = lambda: app.inverse(app.forward(xl))
            if timed:
                ms = _time_ms(fn, reps=10, inner=5)
            else:
                runs = []
                for _ in range(4):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t0) * 1e3)
                ms = statistics.median(runs[1:])
            times[f"{kind}_{name}"] = ms
            if timed and kind == "slab":
                X = app._xchg[0]
                times[f"exchange_{name}"] = _time_ms(
                    lambda: X.run(xl, 1, 0), reps=10, inner=5)
            del xl
            torch.cuda.empty_cache()
    gathered = [None] * world
    dist.all_gather_object(gathered, {"errs": errs, "counts": counts,
                                      "times_ms": times})
    return {"ranks": gathered} if rank == 0 else {}


def _world(ck, backend: str, world: int) -> dict:
    """A world of ``world`` ranks spawned from this process: gloo with
    every rank on the one card (NCCL refuses two ranks on one GPU), or
    NCCL with a card a rank; joined within PAR_JOIN_S, stopped if not."""
    import tempfile
    import torch.multiprocessing as mp
    ck.build_kernels()   # the ranks load the libraries, not build them
    with tempfile.TemporaryDirectory() as path:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_world_rank,
                             args=(r, path, backend, world))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, PAR_JOIN_S - (time.perf_counter() - t0)))
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        outs = []
        for r in range(world):
            f = os.path.join(path, f"rank{r}.json")
            outs.append(json.load(open(f)) if os.path.exists(f) else None)
    failed = [o["failed"] for o in outs if o and "failed" in o]
    assert not failed, failed[0]
    assert not hung, f"ranks still running after {PAR_JOIN_S} s: {hung}"
    assert [p.exitcode for p in procs] == [0] * world, \
        [p.exitcode for p in procs]
    out = outs[0]
    for rk in out["ranks"]:
        for key, err in rk["errs"].items():
            assert err <= (NUMPY_TOL if key.endswith("round_trip")
                           else KERNEL_TOL), (key, err, rk)
    out["seconds"] = time.perf_counter() - t0
    out["times_ms"] = {k: statistics.median(rk["times_ms"][k]
                                            for rk in out["ranks"])
                       for k in out["ranks"][0]["times_ms"]}
    return out


def phase_parallel_routes(vt, ck, dev) -> dict:
    """The distributed layer's other forms on the world of one rank:
    transpose_back (slab and pencil), the real pencil, complex64 and
    complex128 tensors (the fp64 kernels), every result against the port's
    single-device transform; then the gloo world of PAR_WORLD ranks on the
    one card at 256^3 (`_world`)."""
    from vkfft_tpu_torch import parallel as par
    _nccl_world()
    slab = par.fft_mesh()
    pen = par.fft_mesh((1, 1), ("px", "py"))
    x = vt.Planar(*_planes(CUBE, 71, dev))
    xc = _c(x)
    ref = _c(vt.fftn(x))
    rows = []
    for name, mesh in (("slab", slab), ("pencil", pen)):
        app = par.DistributedFFT(CUBE, mesh, transpose_back=True)
        assert app.output_spec() == app.input_spec()
        y = app.forward(x)
        rows.append({"row": f"{name}_transpose_back",
                     "vs_single_device": _rel(_c(y), ref),
                     "round_trip": _rel(_c(app.inverse(y)), xc)})
    xr = _planes(CUBE, 72, dev)[0]
    app = par.DistributedFFT(CUBE, pen, real=True)
    Y = app.forward(xr)
    rows.append({"row": "real_pencil", "vs_single_device": _rel(
        Y, vt.rfftn(xr)), "round_trip": _rel(app.inverse(Y), xr)})
    app = par.DistributedFFT(CUBE, slab)
    y = app.forward(xc)
    assert y.is_complex() and y.dtype == torch.complex64
    rows.append({"row": "slab_complex64_tensor", "vs_single_device": _rel(
        y, ref), "round_trip": _rel(app.inverse(y), xc)})
    del y, Y
    x64 = xc.to(torch.complex128)
    y = app.forward(x64)
    rows.append({"row": "slab_complex128_tensor", "vs_fp64": _rel(
        y, torch.fft.fftn(x64)), "round_trip_fp64": _rel(app.inverse(y), x64)})
    assert y.dtype == torch.complex128
    for r in rows:
        _log(f"[routes par] {r}")
        for key, err in r.items():
            if key != "row":
                tol = (F64_NUMPY_TOL if key.endswith("fp64") else NUMPY_TOL
                       if key == "round_trip" else KERNEL_TOL)
                assert err <= tol, r
    del x64, y
    torch.cuda.empty_cache()
    gloo = _world(ck, "gloo", PAR_WORLD)
    _log(f"[routes par] gloo world of {PAR_WORLD} on one card, host-staged: "
         f"{gloo}")
    return {"rows": rows, "gloo_world": gloo}


def phase_parallel_multi_gpu(vt, ck, dev) -> dict:
    """The distributed layer across PAR_WORLD cards of one host, one rank
    a card on NCCL (over NVLink): `_world_checks` and the slab and pencil
    round trips at 256^3 and 512^3, beside FFTApplication on one card in
    this process.  Run only when named (--phases), on a machine with
    PAR_WORLD cards."""
    count = torch.cuda.device_count()
    assert count >= PAR_WORLD, f"{count} cards, the phase needs {PAR_WORLD}"
    single = {}
    for cube in PAR_CUBES:
        x = vt.Planar(*_planes(cube, 64, dev))
        single["x".join(map(str, cube))] = _time_ms(
            lambda: vt.ifftn(vt.fftn(x)), reps=10, inner=5)
        del x
    torch.cuda.empty_cache()
    out = _world(ck, "nccl", PAR_WORLD)
    out["single_device_ms"] = single
    out["cards"] = [torch.cuda.get_device_name(i) for i in range(count)]
    _log(f"[multi par] NCCL world of {PAR_WORLD} cards: {out}")
    return out


def phase_parallel_times(vt, dev) -> dict:
    """World-of-1 round trips (NCCL) of the slab and the pencil (1, 1) at
    256^3 and 512^3 beside FFTApplication (fftn / ifftn) on the same cube,
    with the exchanges' share (each exchange timed alone: its pack, and
    pack + all_to_all_single + unpack), the host's enqueue time and the
    HBM bound of the transform's own passes."""
    from vkfft_tpu_torch import parallel as par
    _nccl_world()
    _log(f"[time par] card: {_smi()}")
    slab = par.fft_mesh()
    pen = par.fft_mesh((1, 1), ("px", "py"))
    rows = []
    for cube in PAR_CUBES:
        x = vt.Planar(*_planes(cube, 81, dev))
        points = math.prod(cube)
        name = "x".join(map(str, cube))
        single = _time_ms(lambda: vt.ifftn(vt.fftn(x)))
        # bench.py: fwd + inv, read + write, per axis pass (pair + strided)
        bound, by = _bound(2 * 2 * 2 * 8.0 * points,
                           2 * _fft_ops(points, points))
        kinds = [("slab", slab, 1), ("pencil", pen, 1)]
        if cube == CUBE:
            kinds.append(("slab_chunks2", slab, 2))
        for kind, mesh, oc in kinds:
            app = par.DistributedFFT(cube, mesh, overlap_chunks=oc)
            fn = lambda: app.inverse(app.forward(x))
            ms = _time_ms(fn)
            X = app._xchg[-1]
            # each exchange of the round trip moves the whole cube
            n_xchg = (2 if kind.startswith("slab") else 4)
            xchg_ms = _time_ms(lambda: X.run(x, 1, 0))
            pack_ms = _time_ms(lambda: X.pack(x, 1))
            r = {"row": f"{kind}_{name}", "shape": list(cube), "ms": ms,
                 "single_device_ms": single, "vs_single_device": single / ms,
                 "exchange_ms": xchg_ms, "pack_ms": pack_ms,
                 "exchanges": n_xchg,
                 "exchange_share": n_xchg * xchg_ms / ms,
                 "host_ms": _host_ms(fn), "bound_ms": bound, "bound_by": by,
                 "GBs": 2 * 2 * 2 * 8.0 * points / ms / 1e6}
            _log(f"[time par] {r}")
            rows.append(r)
        del x
        torch.cuda.empty_cache()
    return {"rows": rows, "breakdown_256^3": _par_breakdown(vt, slab, dev)}


def _par_breakdown(vt, slab, dev) -> dict:
    """Where the slab's 256^3 round trip spends host and device time: the
    host's enqueue time (`_host_ms`) of each piece, and the device time of
    the bare collective beside a copy of the same bytes."""
    import torch.distributed as dist
    from vkfft_tpu_torch import parallel as par
    x = vt.Planar(*_planes(CUBE, 82, dev))
    app = par.DistributedFFT(CUBE, slab)
    X = app._xchg[0]
    send = X.pack(x, 1)
    recv = torch.empty_like(send)
    a2a = lambda: dist.all_to_all_single(recv, send, group=X.group)
    host = {"pack": _host_ms(lambda: X.pack(x, 1)),
            "all_to_all_single": _host_ms(a2a),
            "all_to_all_single_async_wait": _host_ms(
                lambda: dist.all_to_all_single(recv, send, group=X.group,
                                               async_op=True).wait()),
            "exchange": _host_ms(lambda: X.run(x, 1, 0)),
            "tail_pair": _host_ms(lambda: app._tail(x, False, False)),
            "axis0_strided": _host_ms(lambda: app._fft(x, 0, False, False)),
            "slab_forward": _host_ms(lambda: app.forward(x)),
            "slab_round_trip": _host_ms(lambda: app.inverse(app.forward(x))),
            "single_device_round_trip": _host_ms(
                lambda: vt.ifftn(vt.fftn(x)))}
    device = {"all_to_all_single": _time_ms(a2a),
              "copy_same_bytes": _time_ms(lambda: recv.copy_(send)),
              "pack": _time_ms(lambda: X.pack(x, 1))}
    out = {"host_ms": host, "device_ms": device}
    _log(f"[time par] breakdown 256^3: {out}")
    return out


# --- plan blobs and the build cache, debug introspection, the examples ------

# The applications of cache_main_path, saved as plan blobs and reloaded in
# a second process: (name, FFTConfig fields as config_from_reference takes
# them (enums by value: they go to the second process as JSON), input
# shape, input form, the launches a forward plus an inverse makes, by
# counter entry: fp32 kernels by name, the fp64 instantiations as
# <kernel>_f64, the windowed and tl entries by C entry).
CACHE_ROWS = (
    ("c2c_n1024", dict(shape=(1024,), normalize=True),
     (TARGET_BYTES // (8 * 1024), 1024), "planar", {"fft_lines": 2}),
    ("c2c_256^3", dict(shape=CUBE, normalize=True), CUBE, "planar",
     {"fft_pair": 2, "fft_strided": 2}),
    ("r2c_n1024", dict(shape=(R2C_N,), kind="r2c"), (R2C_LINES, R2C_N),
     "real", {"fft_r2c": 2}),
    ("double_n256", dict(shape=(256,), precision="double", normalize=True),
     (TARGET_BYTES // (16 * 256), 256), "complex128", {"fft_lines_f64": 2}),
    ("keep_order_n4096", dict(shape=(4096,), normalize=True,
                              keep_intermediate_order=True),
     (TARGET_BYTES // (8 * 4096), 4096), "planar", {"fft_lines_tl": 2}),
    ("sample4_256^3", dict(shape=CUBE, normalize=True,
                           zeropad_input=tuple((n // 2, n) for n in CUBE)),
     CUBE, "planar", {"fft_pair_zp": 2, "fft_strided_zp": 2}),
)
CACHE_CHILD_S = 600      # the second process's deadline
PLAN_SWEEP_N = 1 << 16   # the planning comparison: n = 1 .. 2^16


def _cache_input(vt, shape, form: str, seed: int, dev):
    """A row's input, made alike in both processes from its seed."""
    re, im = _planes(shape, seed, dev)
    if form == "real":
        return vt.Planar(re, torch.zeros_like(re))
    if form == "complex128":
        return torch.complex(re.double(), im.double())
    return vt.Planar(re, im)


def _tensors(y) -> list:
    """The tensors of a result (planes or a tensor), in order."""
    return [y.re, y.im] if hasattr(y, "re") else [y]


def _same(a, b) -> bool:
    """Bit for bit the same result: each tensor torch.equal, and a
    TlSpectrum's layout fields equal."""
    if type(a) is not type(b):
        return False
    if hasattr(a, "lead") and (a.lead, a.batch, a.n, a.n2, a.split) != (
            b.lead, b.batch, b.n, b.n2, b.split):
        return False
    ta, tb = _tensors(a), _tensors(b)
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(ta, tb))


def _listing(path: str) -> dict:
    """{file: (size, mtime_ns)} of a build directory."""
    return {f: (os.stat(os.path.join(path, f)).st_size,
                os.stat(os.path.join(path, f)).st_mtime_ns)
            for f in sorted(os.listdir(path))}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_rows(vt, cache, dev, workdir: str, rows, reload: bool) -> tuple:
    """Each application of ``rows`` ((name, FFTConfig fields, input shape,
    input form)) forward and inverse on its input: built and its blob
    written (the first process, which also saves its kept-order forward),
    or reloaded from that blob (the second).  Returns ({name: (y, z)},
    {name: app})."""
    out, apps = {}, {}
    for i, (name, kw, shape, form) in enumerate(rows):
        blob_path = os.path.join(workdir, f"{name}.blob")
        if reload:
            with open(blob_path, "rb") as f:
                app = cache.load_application_from_string(f.read())
        else:
            app = vt.FFTApplication(vt.config_from_reference(kw))
            with open(blob_path, "wb") as f:
                f.write(cache.save_application_to_string(app))
        x = _cache_input(vt, tuple(shape), form, 301 + i, dev)
        y = app.forward(x)
        out[name], apps[name] = (y, app.inverse(y)), app
        if name.startswith("keep_order") and not reload:
            torch.save(y, os.path.join(workdir, f"{name}.tl.pt"))
    _sync(dev)
    return out, apps


def cache_child(workdir: str, t_start: float) -> int:
    """The second process of cache_main_path: reads each row's plan blob
    from ``workdir``, points the build cache at the first process's build
    directory, reruns the same inputs on the same device and writes its
    outputs, its launches and its times back to ``workdir``."""
    t_import = time.perf_counter()
    import vkfft_tpu_torch as vt
    from vkfft_tpu_torch import cache, debug
    from vkfft_tpu_torch.ops import cuda_kernels as ck
    from vkfft_tpu_torch.planner import native
    with open(os.path.join(workdir, "request.json")) as f:
        req = json.load(f)
    cache.enable_persistent_cache(req["build_dir"])
    dev = torch.device(req["device"])
    name, kw, shape, form = req["rows"][0]
    with open(os.path.join(workdir, f"{name}.blob"), "rb") as f:
        app = cache.load_application_from_string(f.read(), device=dev)
    first = app.forward(_cache_input(vt, tuple(shape), form, 301, dev))
    _sync(dev)
    t_first = time.perf_counter()
    del app, first
    ck.reset_launches()
    outs, apps = _run_rows(vt, cache, dev, workdir, req["rows"], reload=True)
    counts = {k: v for k, v in debug.launch_counts().items() if v}
    for name in outs:
        if name.startswith("keep_order"):   # the first process's TlSpectrum
            theirs = torch.load(os.path.join(workdir, f"{name}.tl.pt"),
                                map_location=dev, weights_only=False)
            outs[name] += (apps[name].inverse(theirs),)
    for name, res in outs.items():
        torch.save(res, os.path.join(workdir, f"{name}.child.pt"))
    with open(os.path.join(workdir, "child.json"), "w") as f:
        json.dump({"start_to_first_result_s": t_first - t_start,
                   "import_to_first_result_s": t_first - t_import,
                   "launches": counts, "native_loaded":
                   native.get_lib() is not None, "native_error": native.error,
                   "build_dir": ck.BUILD_DIR}, f)
    return 0


def _planning_ms(factorize, native_on: bool) -> float:
    """Host ms to plan every n = 1 .. PLAN_SWEEP_N with the planner's caches
    emptied first: on the native core, or on the Python body (the core
    switched off)."""
    key = "VKFFT_TPU_TORCH_NATIVE"
    old = os.environ.get(key)
    if not native_on:
        os.environ[key] = "0"
    try:
        factorize.decompose.cache_clear()
        factorize.next_smooth.cache_clear()
        t0 = time.perf_counter()
        for n in range(1, PLAN_SWEEP_N + 1):
            factorize.decompose(n)
        return (time.perf_counter() - t0) * 1e3
    finally:
        if old is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = old
        factorize.decompose.cache_clear()
        factorize.next_smooth.cache_clear()


def phase_cache_main_path(vt, ck, torch_engine, dev, cold_build_s) -> dict:
    """Plan blobs and the build cache at full width (CACHE_ROWS): each
    application built here, its blob saved, forward and inverse run on its
    input (the launches counted from 0, no plain-engine call); then a
    second Python process reads each blob from its file, points the build
    cache at this process's build directory, reruns the same inputs (and
    inverts this process's TlSpectrum) and writes its outputs: each
    torch.equal to this process's, the same launches, the native core
    loaded there, and the build directory's listing unchanged (no nvcc, no
    c++).  Prints the cold build's seconds (the toolchain phase's build,
    and the native core's own into an empty directory) against the warm
    process's time to its first result, and the planning of n = 1 .. 2^16
    on the native core against the Python body."""
    import shutil
    import tempfile
    from vkfft_tpu_torch import cache, debug
    from vkfft_tpu_torch.planner import factorize, native
    assert native.get_lib() is not None, f"native core: {native.error}"
    card = _smi()
    plan_native = _planning_ms(factorize, True)
    plan_python = _planning_ms(factorize, False)
    _log(f"[cache] planning n = 1..{PLAN_SWEEP_N}: native core "
         f"{plan_native:.1f} ms, Python body {plan_python:.1f} ms "
         f"({plan_python / plan_native:.2f}x), host, {card}")
    build_dir = ck.BUILD_DIR
    workdir = tempfile.mkdtemp(prefix="vkfft_cache_phase")
    try:
        native_dir = os.path.join(workdir, "native_cold")
        old = native.BUILD_DIR
        native.set_build_dir(native_dir)
        t0 = time.perf_counter()
        native.build()
        native_cold_s = time.perf_counter() - t0
        native.set_build_dir(old)
        assert native.get_lib() is not None, native.error
        cache.enable_persistent_cache(build_dir)
        apps = [row[:4] for row in CACHE_ROWS]
        with open(os.path.join(workdir, "request.json"), "w") as f:
            json.dump({"build_dir": build_dir, "device": str(dev),
                       "rows": apps}, f)
        torch.cuda.synchronize()
        ck.reset_launches()
        torch_engine.calls = 0
        mine, _ = _run_rows(vt, cache, dev, workdir, apps, reload=False)
        counts = {k: v for k, v in debug.launch_counts().items() if v}
        plain_calls = torch_engine.calls
        want = {}
        for *_, launches in CACHE_ROWS:
            for k, v in launches.items():
                want[k] = want.get(k, 0) + v
        _log(f"[cache] launches of the path {counts}, plain engine calls "
             f"{plain_calls}")
        assert counts == want, (counts, want)
        assert plain_calls == 0
        before = _listing(build_dir)
        code = ("import time; t0 = time.perf_counter(); import sys; "
                f"sys.path.insert(0, {os.getcwd()!r}); import chip_smoke; "
                "sys.exit(chip_smoke.cache_child(sys.argv[1], t0))")
        t_spawn = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code, workdir],
                             capture_output=True, text=True,
                             timeout=CACHE_CHILD_S)
        child_wall_s = time.perf_counter() - t_spawn
        assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
        after = _listing(build_dir)
        assert after == before, (before, after)
        with open(os.path.join(workdir, "child.json")) as f:
            child = json.load(f)
        assert child["native_loaded"], child["native_error"]
        assert child["build_dir"] == build_dir
        assert child["launches"] == counts, (child["launches"], counts)
        rows = []
        for name, _, shape, form, _ in CACHE_ROWS:
            theirs = torch.load(os.path.join(workdir, f"{name}.child.pt"),
                                map_location=dev, weights_only=False)
            y, z = mine[name]
            same = [_same(theirs[0], y), _same(theirs[1], z)]
            if name.startswith("keep_order"):
                assert isinstance(y, vt.TlSpectrum)
                same.append(_same(theirs[2], z))
            row = {"row": name, "shape": list(shape), "form": form,
                   "output": type(y).__name__, "equal": same,
                   "finite": all(bool(torch.isfinite(t).all())
                                 for t in _tensors(y) + _tensors(z))}
            _log(f"[cache] {row}")
            assert all(same) and row["finite"], row
            rows.append(row)
            del theirs
        info = {"card": card, "cold_build_s": cold_build_s,
                "native_cold_build_s": native_cold_s,
                "warm_start_to_first_result_s":
                    child["start_to_first_result_s"],
                "warm_import_to_first_result_s":
                    child["import_to_first_result_s"],
                "warm_process_wall_s": child_wall_s,
                "planning_native_ms": plan_native,
                "planning_python_ms": plan_python,
                "build_dir_files": len(after)}
        _log(f"[cache] {info}")
        return {**info, "launches": counts, "plain_engine_calls": plain_calls,
                "rows": rows}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _debug_rows(vt, ce, dev) -> list:
    """The applications debug_main_path reads: (name, app, input, the
    launches of one forward, by counter entry)."""
    from vkfft_tpu_torch.planner import plan_axis

    def route(n):
        want = {}
        for k, _, _ in ce.route(plan_axis(n)):
            want[k] = want.get(k, 0) + 1
        return want

    rows = []
    for i, (name, kw, shape, form, _) in enumerate(CACHE_ROWS):
        if name.startswith("r2c"):
            continue   # the real kinds' kernels are not the C2C route
        want = {"c2c_n1024": route(1024),
                "c2c_256^3": {"fft_pair": 1, "fft_strided": 1},
                "double_n256": {"fft_lines_f64": 1},
                "keep_order_n4096": {"fft_lines_tl": 1},
                "sample4_256^3": {"fft_pair_zp": 1, "fft_strided_zp": 1}}[name]
        rows.append((name, vt.FFTApplication(vt.config_from_reference(kw)),
                     _cache_input(vt, shape, form, 401 + i, dev), want))
    for n in (10007, 7919, 10006):   # sample 7's Bluestein, Rader, SPLIT
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,)))
        x = vt.Planar(*_planes((SAMPLE_7_BYTES // (8 * n), n), n, dev))
        rows.append((f"sample7_n{n}", app, x, route(n)))
    return rows


def phase_debug_main_path(vt, ck, ce, torch_engine, dev) -> dict:
    """describe, memory_layout and dump_kernels of the cache path's C2C
    applications and sample 7's 10007 / 7919 / 10006 at full width, held
    to the launches the counters record for one forward (and to
    cuda_engine.route's kernels), no plain-engine call; then profile_trace
    of the 256^3 round trip, its Chrome trace read back: the route's
    device kernels (fft_pair, fft_strided) in it, no torch_engine frame,
    and its five longest device operations printed with their ms."""
    import shutil
    import tempfile
    from vkfft_tpu_torch import debug
    out = {"rows": []}
    for name, app, x, want in _debug_rows(vt, ce, dev):
        torch.cuda.synchronize()
        torch_engine.calls = 0
        got = debug.launched(app.forward, x)
        text = debug.dump_kernels(app, x)
        desc = debug.describe(app)
        layout = debug.memory_layout(app)
        torch.cuda.synchronize()
        assert got == want, (name, got, want)
        assert torch_engine.calls == 0, name
        assert text.splitlines()[0] == (
            f"forward: {sum(got.values())} kernel launches"), text
        for entry, count in got.items():
            lib = debug.library_of(entry)
            assert f"{entry} x{count}: C entry vk_{entry} of {lib}" in text
            assert ck.library_path(lib) in text and os.path.exists(
                ck.library_path(lib))
            if entry == lib and app.config.axes == (0,):
                assert f"{lib}(" in desc, (name, desc)
        assert layout.count("pass axis") == len(app.config.axes)
        assert layout.endswith("-> output")
        _log(f"[debug] {name}: launches {got}\n{desc}\n{layout}\n{text}")
        out["rows"].append({"row": name, "launches": got, "describe": desc,
                            "memory_layout": layout, "dump_kernels": text})
    app = vt.FFTApplication(vt.FFTConfig(shape=CUBE, normalize=True))
    x = vt.Planar(*_planes(CUBE, 451, dev))
    outdir = tempfile.mkdtemp(prefix="vkfft_trace")
    try:
        iters = 5
        calls = torch_engine.calls
        debug.profile_trace(lambda: app.inverse(app.forward(x)),
                            outdir=outdir, iters=iters)
        assert torch_engine.calls == calls
        ops = debug.device_ops(outdir)
        frames = [e["name"] for e in debug.trace_events(outdir)
                  if e.get("cat") == "python_function"]
        trace_mb = os.path.getsize(os.path.join(outdir, "trace.json")) / 2**20
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    names = [name for name, _, _ in ops]
    top = [{"op": name[:120], "ms_per_round_trip": ms / iters,
            "count": count} for name, ms, count in ops[:5]]
    _log(f"[debug] profile_trace of the 256^3 round trip x{iters} "
         f"({trace_mb:.1f} MiB of trace), {_smi()}: the five longest device "
         f"operations {top}")
    for kernel in ("fft_pair", "fft_strided"):
        assert any(kernel in n for n in names), (kernel, names)
    assert not any("torch_engine.py" in f for f in frames)
    assert any("cuda_kernels.py" in f and "_launch" in f for f in frames)
    out["profile_top5"] = top
    out["device_op_names"] = [n[:200] for n in names]
    return out


EXAMPLES_S = 600         # each example's deadline


def phase_examples(ck, dev) -> dict:
    """Every examples_torch/ex*.py twin as a subprocess on the card (ex09 a
    NCCL world of one rank a visible card), all started together, ex08's
    build cache at this run's build directory: each exits 0 and prints
    "ok" last, and no example compiles anything (the build directory's
    listing unchanged)."""
    root = os.path.dirname(os.path.abspath(__file__))
    scripts = sorted(f for f in os.listdir(os.path.join(root, "examples_torch"))
                     if f.startswith("ex") and f.endswith(".py"))
    assert len(scripts) == 10, scripts
    env = dict(os.environ, PYTHONPATH=root,
               VKFFT_TPU_TORCH_CACHE=ck.BUILD_DIR)
    env.pop("VKFFT_TPU_TORCH_EXAMPLES_CPU", None)
    before = _listing(ck.BUILD_DIR)
    t0 = time.perf_counter()
    procs = {s: subprocess.Popen(
        [sys.executable, s], cwd=os.path.join(root, "examples_torch"),
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for s in scripts}
    rows, failed = [], []
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=EXAMPLES_S)
            lines = stdout.strip().splitlines()
            ok = p.returncode == 0 and lines and lines[-1] == "ok"
            rows.append({"example": s, "rc": p.returncode,
                         "done_by_s": time.perf_counter() - t0,
                         "stdout": lines[-8:]})
            _log(f"[examples] {s}: rc {p.returncode}, last lines "
                 f"{lines[-4:]}")
            if not ok:
                failed.append((s, stdout[-2000:], stderr[-4000:]))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not failed, failed
    assert _listing(ck.BUILD_DIR) == before
    return {"rows": rows, "wall_s": time.perf_counter() - t0,
            "devices": torch.cuda.device_count()}


def _run_phases(phases, record: dict) -> bool:
    """Run each (name, fn) into ``record``; True as soon as one fails
    (its traceback printed)."""
    for name, fn in phases:
        t = time.perf_counter()
        try:
            record[name] = fn()
        except Exception as e:   # report the phase, then fail the run
            import traceback
            traceback.print_exc()
            print(f"chip_smoke: phase {name} failed: {e!r}", file=sys.stderr)
            return True
        record.setdefault("phase_s", {})[name] = time.perf_counter() - t
        _log(f"[phase] {name} done in {record['phase_s'][name]:.1f} s")
        torch.cuda.empty_cache()
    return False


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", help="comma-separated phase names: run "
                    "only these and print no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import vkfft_tpu_torch as vt
        from vkfft_tpu_torch.ops import cuda_engine as ce
        from vkfft_tpu_torch.ops import cuda_kernels as ck
        from vkfft_tpu_torch.ops import torch_engine
        from vkfft_tpu_torch.precision import dd_fft, dd_kernel as dk
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
              ("real_kernels", lambda: phase_real_kernels_vs_plain(ck, dev)),
              ("routes", lambda: phase_routes(vt, dev)),
              ("real_routes", lambda: phase_real_routes(vt, dev)),
              ("main_path", lambda: phase_main_path(vt, ck, torch_engine, dev)),
              ("real_main_path",
               lambda: phase_real_main_path(vt, ck, torch_engine, dev)),
              ("times", lambda: phase_times(vt, ck, dev)),
              ("real_times", lambda: phase_real_times(vt, ck, dev)),
              ("any_kernels", lambda: phase_any_kernels_vs_plain(ck, ce, dev)),
              ("any_routes", lambda: phase_any_routes(vt, ce, dev)),
              ("any_main_path",
               lambda: phase_any_main_path(vt, ck, torch_engine, dev)),
              ("any_times", lambda: phase_any_times(vt, ck, dev)),
              ("r2r_kernels", lambda: phase_r2r_kernels_vs_plain(ck, dev)),
              ("r2r_routes", lambda: phase_r2r_routes(vt, dev)),
              ("r2r_main_path",
               lambda: phase_r2r_main_path(vt, ck, torch_engine, dev)),
              ("r2r_times", lambda: phase_r2r_times(vt, ck, dev)),
              ("conv_kernels", lambda: phase_conv_kernels_vs_plain(ck, dev)),
              ("conv_routes", lambda: phase_conv_routes(vt, dev)),
              ("conv_main_path",
               lambda: phase_conv_main_path(vt, ck, torch_engine, dev)),
              ("conv_times", lambda: phase_conv_times(vt, ck, dev)),
              ("walk_times", lambda: phase_walk_times(ck, dev)),
              ("long_kernels", lambda: phase_long_kernels_vs_plain(ck, dev)),
              ("long_routes", lambda: phase_long_routes(vt, ce, dev)),
              ("long_main_path",
               lambda: phase_long_main_path(vt, ck, torch_engine, dev)),
              ("long_times", lambda: phase_long_times(vt, ce, ck, dev)),
              ("dd_kernels", lambda: phase_dd_kernels_vs_plain(dk, dev)),
              ("dd_routes", lambda: phase_dd_routes(vt, dd_fft, dev)),
              ("dd_main_path",
               lambda: phase_dd_main_path(vt, ck, dk, torch_engine, dev)),
              ("dd_times", lambda: phase_dd_times(vt, dd_fft, dk, ck, dev)),
              ("f64_kernels", lambda: phase_f64_kernels(ck, dev)),
              ("f64_routes", lambda: phase_f64_routes(vt, ck, ce, dev)),
              ("f64_main_path",
               lambda: phase_f64_main_path(vt, ck, dk, torch_engine, dev)),
              ("f64_times", lambda: phase_f64_times(vt, ck, dev)),
              ("storage_kernels", lambda: phase_storage_kernels(ck, dev)),
              ("storage_routes",
               lambda: phase_storage_routes(vt, ck, ce, torch_engine, dev)),
              ("storage_main_path",
               lambda: phase_storage_main_path(vt, ck, ce, torch_engine,
                                               dev)),
              ("storage_times", lambda: phase_storage_times(vt, ck, dev)),
              ("zeropad_kernels", lambda: phase_zeropad_kernels(ck, dev)),
              ("zeropad_routes",
               lambda: phase_zeropad_routes(vt, ck, torch_engine, dev)),
              ("zeropad_main_path",
               lambda: phase_zeropad_main_path(vt, ck, torch_engine, dev)),
              ("zeropad_times", lambda: phase_zeropad_times(vt, ck, dev)),
              ("keep_order_kernels",
               lambda: phase_keep_order_kernels(ck, ce, dev)),
              ("keep_order_routes",
               lambda: phase_keep_order_routes(vt, ck, torch_engine, dev)),
              ("keep_order_main_path",
               lambda: phase_keep_order_main_path(vt, ck, ce, torch_engine,
                                                  dev)),
              ("keep_order_times",
               lambda: phase_keep_order_times(vt, ck, dev)),
              ("parallel_routes", lambda: phase_parallel_routes(vt, ck, dev)),
              ("parallel_main_path",
               lambda: phase_parallel_main_path(vt, ck, torch_engine, dev)),
              ("parallel_times", lambda: phase_parallel_times(vt, dev)),
              ("cache_main_path",
               lambda: phase_cache_main_path(
                   vt, ck, torch_engine, dev,
                   record["toolchain"]["build_s"])),
              ("debug_main_path",
               lambda: phase_debug_main_path(vt, ck, ce, torch_engine, dev)),
              ("examples", lambda: phase_examples(ck, dev)),
              ("parallel_multi_gpu",
               lambda: phase_parallel_multi_gpu(vt, ck, dev))]
    only = args.phases.split(",") if args.phases else None
    if only:
        unknown = set(only) - {name for name, _ in phases}
        if unknown:
            print(f"chip_smoke: no phase {sorted(unknown)}", file=sys.stderr)
            return 2
        phases = [(name, fn) for name, fn in phases if name in only]
    else:   # a run with no arguments needs one card
        phases = [(name, fn) for name, fn in phases
                  if name != "parallel_multi_gpu"]
    try:
        failed = _run_phases(phases, record)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():   # the parallel phases' world of one
            dist.destroy_process_group()
    if failed:
        return 1
    record["total_s"] = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    if only:
        with open(os.path.join("chiprun_out", "chip_smoke_phases.json"),
                  "w") as f:
            json.dump(record, f, indent=1, default=str)
        _log(f"[phase] {only} done in {record['total_s']:.1f} s")
        return 0

    # launches over the whole main path: the C2C part and each R2C path,
    # each counted from 0
    by_path = dict({"c2c": record["main_path"]["launches"]},
                   **record["real_main_path"]["launches_by_path"],
                   **record["any_main_path"]["launches_by_path"],
                   **record["r2r_main_path"]["launches_by_path"],
                   **record["conv_main_path"]["launches_by_path"],
                   **record["long_main_path"]["launches_by_path"],
                   **record["dd_main_path"]["launches_by_path"],
                   **record["f64_main_path"]["launches_by_path"],
                   **record["parallel_main_path"]["launches_by_path"])
    # the cache path's launches (plan blobs built and run here), by counter
    cache_counts = record["cache_main_path"]["launches"]
    by_path["cache"] = {k: cache_counts.get(k, 0) for k in ck.KERNEL_SOURCES}
    launches = {k: sum(c[k] for c in by_path.values())
                for k in ck.KERNEL_SOURCES}
    pe = "vkfft_tpu/ops/pallas_engine.py"
    sources = {"fft_lines": ("vkfft_tpu_torch/csrc/fft_lines.cu", f"{pe}:1563"),
               "fft_strided": ("vkfft_tpu_torch/csrc/fft_strided.cu",
                               f"{pe}:3489"),
               "fft_pair": ("vkfft_tpu_torch/csrc/fft_pair.cu", f"{pe}:1982"),
               "fft_r2c": ("vkfft_tpu_torch/csrc/fft_r2c.cu", f"{pe}:2461"),
               "fft_r2c_pair": ("vkfft_tpu_torch/csrc/fft_r2c_pair.cu",
                                f"{pe}:3204"),
               "fft_conv": ("vkfft_tpu_torch/csrc/fft_conv.cu", f"{pe}:4579"),
               "fft_twofactor": ("vkfft_tpu_torch/csrc/fft_twofactor.cu",
                                 f"{pe}:897"),
               "fft_conv_inv": ("vkfft_tpu_torch/csrc/fft_conv_inv.cu",
                                f"{pe}:4421"),
               "fft_conv_pair": ("vkfft_tpu_torch/csrc/fft_conv_pair.cu",
                                 f"{pe}:2205"),
               "fft_dct23": ("vkfft_tpu_torch/csrc/fft_dct23.cu", f"{pe}:2745"),
               "fft_dct1": ("vkfft_tpu_torch/csrc/fft_dct1.cu", f"{pe}:2958"),
               "fft_dct4": ("vkfft_tpu_torch/csrc/fft_dct4.cu", f"{pe}:3080"),
               "fft_strided_tw": ("vkfft_tpu_torch/csrc/fft_strided_tw.cu",
                                  f"{pe}:3439"),
               "fft_dd": ("vkfft_tpu_torch/csrc/fft_dd.cu",
                          "vkfft_tpu/precision/dd_kernel.py:166")}
    # the half entries counted apart by C entry (fft_conv_pair's 2-D mode,
    # vk_fft_conv2d_<dtype>, apart from its Bluestein mode's) at their
    # library's source
    for entry, lib in ck.STORAGE_LIBRARY.items():
        sources.setdefault(entry, sources[lib])
    # the leading axis of the cube, which the JAX package runs in
    # _outer_kernel, runs in fft_strided on the (P, n, R*nz) view; each real
    # source holds both directions; the factor mode (fft_strided_tw) is the
    # whole of _strided_kernel and the factor option of _strided_kernel_v3;
    # fft_twofactor holds every length of the v1 _fft_kernel
    also = {"fft_strided": [f"{pe}:4001"], "fft_r2c": [f"{pe}:2507"],
            "fft_r2c_pair": [f"{pe}:3229"], "fft_dct23": [f"{pe}:2789"],
            "fft_strided_tw": [f"{pe}:3489"], "fft_twofactor": [f"{pe}:152"],
            "fft_dd": ["vkfft_tpu/precision/dd_kernel.py:259"]}
    timed = {k: record["times"]["kernels"].get(k, [])
             + record["real_times"]["kernels"].get(k, [])
             + record["any_times"]["kernels"].get(k, [])
             + record["r2r_times"]["kernels"].get(k, [])
             + record["conv_times"]["kernels"].get(k, [])
             + record["long_times"]["kernels"].get(k, [])
             + record["dd_times"]["kernels"].get(k, [])
             for k in ck.KERNEL_SOURCES}
    entries = []
    for name, rows in timed.items():
        head = rows[0]
        entries.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "also_replaces": also.get(name, []),
            "per_shape": rows})
    # the fp64 instantiations of fft_lines, fft_strided and fft_pair (the
    # same sources), launched on DOUBLE's main path
    f64_by_path = dict(record["f64_main_path"]["f64_launches_by_path"],
                       cache={k: cache_counts.get(k + "_f64", 0)
                              for k in ck.F64_KERNELS})
    for name in ck.F64_KERNELS:
        rows = record["f64_times"]["kernels"][name]
        head = rows[0]
        entries.append({
            "name": f"{name}_f64", "route": "cuda",
            "source": sources[name][0], "replaces": sources[name][1],
            "launches": sum(c[name] for c in f64_by_path.values()),
            "launches_by_path": {p: c[name] for p, c in f64_by_path.items()},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": "float64",
            "also_replaces": also.get(name, []), "per_shape": rows})
    # the half-storage instantiations of every C2C kernel and of the fused
    # convolutions (the same sources), launched on the storage tiers' main
    # path
    st_by_path = record["storage_main_path"]["storage_launches_by_path"]
    for key, rows in record["storage_times"]["kernels"].items():
        name, tag = key.rsplit("_", 1)
        head = rows[0]
        entries.append({
            "name": key, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(c[key] for c in st_by_path.values()),
            "launches_by_path": {p: c[key] for p, c in st_by_path.items()
                                 if c[key]},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": STORAGE_TIER[tag].lower(),
            "also_replaces": also.get(name, []), "per_shape": rows})
    # the windowed entries of fft_lines, fft_twofactor, fft_strided and
    # fft_pair (the same sources), launched on the zero-pad main path
    zp_by_path = dict(record["zeropad_main_path"]["zp_launches_by_path"],
                      cache={k: cache_counts.get(k, 0)
                             for k in ck.zp_launches})
    for key, rows in record["zeropad_times"]["kernels"].items():
        name = key.rsplit("_", 1)[0]
        head = rows[0]
        entries.append({
            "name": key, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(c[key] for c in zp_by_path.values()),
            "launches_by_path": {p: c[key] for p, c in zp_by_path.items()
                                 if c[key]},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "unwindowed_ms": head["unwindowed_ms"], "shape": head["shape"],
            "also_replaces": also.get(name, []), "per_shape": rows})
    # the tl entries of fft_lines and fft_pair (the same sources), launched
    # on the kept-order main path (fft_twofactor at split_lane_major is
    # fft_twofactor's own entry: its row stays in the record)
    tl_by_path = dict(record["keep_order_main_path"]["tl_launches_by_path"],
                      cache={k: cache_counts.get(k, 0)
                             for k in ck.tl_launches})
    for key, rows in record["keep_order_times"]["kernels"].items():
        if key not in ck.tl_launches:
            continue
        name = key[:-len("_tl")]
        head = rows[0]
        entries.append({
            "name": key, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": sum(c[key] for c in tl_by_path.values()),
            "launches_by_path": {p: c[key] for p, c in tl_by_path.items()
                                 if c[key]},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "natural_ms": head["natural_ms"], "shape": head["shape"],
            "also_replaces": also.get(name, []), "per_shape": rows})
    _log(f"[phase] all done in {record['total_s']:.1f} s")
    record["kernels_line"] = entries
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps({"kernels": entries}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
