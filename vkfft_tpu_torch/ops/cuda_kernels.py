"""The port's hand-written CUDA kernels, their plain versions, and the build.

Fourteen kernels, CUDA C++ for ``sm_90a`` in ``vkfft_tpu_torch/csrc``;
the thirteen fp32 ones here, and `fft_dd` (``csrc/fft_dd.cu``), the
double-double tier's kernel, whose tables, plain versions and wrappers
are in ``precision/dd_kernel.py`` (it replaces
``vkfft_tpu/precision/dd_kernel.py:166 _dd_fft_kernel`` and ``:259
_dd_strided_kernel``):

* `fft_lines` (``csrc/fft_lines.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:1563 _fft_kernel_v3``: batched C2C of
  contiguous (B, n) fp32 planes, natural order, scale in the kernel.
* `fft_strided` (``csrc/fft_strided.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:3489 _strided_kernel_v3``: C2C along the
  middle dim of (P, n, S) fp32 planes, S contiguous, scale in the kernel,
  a tile of columns held once in shared memory on the in-place walk
  (`strided_layout`).
  It also computes what ``pallas_engine.py:4001 _outer_kernel`` does (dim 1
  of (P, n, R, nz) planes): on the card that layout is the (P, n, R*nz)
  view of the same memory, so one kernel serves both.
* `fft_strided_tw` (``csrc/fft_strided_tw.cu``), the factor mode of
  `fft_strided` (its ``pre``/``post``/``plane``, interleave and
  transposed options), replaces
  ``vkfft_tpu/ops/pallas_engine.py:3439 _strided_kernel`` and the factor
  option of ``:3489 _strided_kernel_v3``: the strided DFT with a four-step
  twiddle or a Bluestein chirp (`Factor`) computed in the kernel and
  multiplied after the read and on the write, over live lengths of the
  planes, its tile on the in-place walk (`strided_tw_layout`); the passes
  of the long tier (`long_split`, `bluestein_long_split`), whose first
  pass stores the four-step reorder transposed where the split folds it
  (`long_folds`).
* `fft_pair` (``csrc/fft_pair.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:1982 _pair_kernel``: 2-D C2C of the two
  minor axes of (B, ny, nz) fp32 planes in one pass, a plane held once in
  the shared memory of a thread-block cluster on the in-place walk
  (`pair_layout`).
* `fft_r2c` / `fft_c2r` (``csrc/fft_r2c.cu``) replace
  ``vkfft_tpu/ops/pallas_engine.py:2461 _r2c_kernel`` and ``:2507
  _c2r_kernel``: real (B, n) lines, n even, to their half spectrum in the
  numpy or the packed layout, and back, as an n/2-point complex FFT on the
  in-place walk (`fft_lines`' block, `r2c_layout`) and an in-place
  untangle.
* `fft_r2c_pair` / `fft_c2r_pair` (``csrc/fft_r2c_pair.cu``) replace
  ``vkfft_tpu/ops/pallas_engine.py:3204 _r2c_pair_kernel`` and ``:3229
  _c2r_pair_kernel``: numpy ``rfft2``/``irfft2`` of the two minor axes of
  real (B, ny, nz) planes in one pass, a plane held once in the shared
  memory of a cluster on the in-place walk (`r2c_pair_layout`).
* `fft_conv` (``csrc/fft_conv.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:4579 _conv_v3_kernel`` in all its modes
  (scalar table, rows, m x m matrix, conjugated data, cross-power,
  Bluestein): forward stages, a per-frequency multiply and inverse stages
  of each line in one launch.
* `fft_twofactor` (``csrc/fft_twofactor.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:897 _fft_kernel_v2``: the two-factor
  DFT n = n1*n2 <= 16384, natural or swapped digit order.  It also
  computes what ``:152 _fft_kernel`` (the v1 four-step, n1 <= n2 <= 128)
  does: `twofactor_split` holds every length of ``split_two_factors``.
* `fft_conv_inv` (``csrc/fft_conv_inv.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:4421 _conv_inv_kernel``: a spectrum in
  `fft_twofactor`'s swapped order times a table, the two-factor inverse to
  natural order, and a per-line constant added in the store.
* `fft_conv_pair` (``csrc/fft_conv_pair.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:2205 _conv_pair_kernel`` in both its
  modes: one padded Bluestein line of m = nc*ns <= 2^16 points as a
  four-step plane held in a cluster, and the 2-D circular convolution of
  each (ny, nz) plane with a shared or per-slice spectrum.
* `fft_dct23` (``csrc/fft_dct23.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:2745 _dct2_kernel`` and ``:2789
  _dct3_kernel``: DCT-II/DST-II and DCT-III/DST-III of real (B, n) lines,
  two lines riding one n-point complex pipeline.
* `fft_dct1` (``csrc/fft_dct1.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:2958 _dct1_kernel``: DCT-I/DST-I as the
  real FFT of the extension, read by cp.async straight into it, on the
  in-place walk (`dct1_layout`).
* `fft_dct4` (``csrc/fft_dct4.cu``) replaces
  ``vkfft_tpu/ops/pallas_engine.py:3080 _dct4_kernel``: DCT-IV/DST-IV, the
  n/2 complex trick for even n and the 2n-point form for odd n.

`fft_lines`, `fft_strided` and `fft_pair` have fp64 instantiations
(the same source, the walk of ``csrc/inplace.cuh`` templated over its
complex type): the wrappers launch them (C entries ``vk_<name>_f64``,
counted in `f64_launches`) on float64 planes, with the stage and twiddle
tables in fp64, at the same layout rules in points, a point 16 B of
shared memory (`lines_layout`, `strided_layout`, `pair_layout` and
`pair_cluster` take the dtype).  `fft_lines`, `fft_twofactor`,
`fft_strided`, `fft_pair`, `fft_strided_tw`, `fft_conv`, `fft_conv_inv`
and `fft_conv_pair` (`STORAGE_KERNELS`: every kernel of the C2C routes and
of the fused convolutions) have half-storage instantiations (C entries
``vk_<name>_f16`` and ``vk_<name>_bf16``, and ``vk_fft_conv2d_f16`` /
``_bf16`` for `fft_conv_pair`'s 2-D mode, counted in `storage_launches`
by entry, `STORAGE_ENTRIES`): float16 or bfloat16 planes, read widened to
fp32 and written narrowed, the tables, factors, spectra, chirps, shared
memory (8 B a point, so every fp32 layout rule holds as it is) and every
stage fp32.  Every other kernel (the real and R2R kernels) takes float32
planes only (other precisions are ROADMAP queue 1 item 10).

`fft_lines`, `fft_twofactor`, `fft_strided` and `fft_pair` have windowed
entries (`ZP_KERNELS`; C entries ``vk_<name>_zp`` and their ``_f64``,
``_f16``, ``_bf16`` twins where the kernel has that instantiation, counted
in `zp_launches`): the zero-pad options of the TPU kernels they replace
(`line_window`: kept prefixes, interior windows, cropped, filled and
zero-windowed outputs; `fft_strided`'s row keeps; `fft_pair`'s corners),
the declared-zero input never read and held as zeros in shared memory,
the output cropped or written with exact zeros, the planes read in place
through their strides (a corner of wider planes).  Their kernels are
instantiations of their own, so the unwindowed kernels compile as before.
`fft_conv_pair`'s 2-D mode has windowed entries too (``vk_fft_conv2d_zp``,
``_f16``, ``_bf16``, `ZP_CONV2D_ENTRIES`: `_conv_pair_kernel`'s in_keep /
out_keep corners).

`fft_lines` and `fft_pair` have tl entries (`TL_KERNELS`; C entries
``vk_<name>_tl``, ``_f16``, ``_bf16``, counted in `tl_launches`): the
keep_intermediate_order forms of the TPU kernels they replace, `fft_lines`
leaving a two-factor line in its factors' swapped digit order (`tl_order`)
and `fft_pair` the transposed (nz, ny) planes of the spectrum, and reading
them back.  `fft_twofactor` takes its factors from its caller (``split``),
so the kept order of the JAX package's v2 lengths, `split_lane_major`'s,
runs on it.

The FFT kernels are bound by bytes (one read and one write of each point)
and keep every stage of a line or column tile in shared memory; the source
notes in the ``.cu`` files say how.  `fft_lines`, `fft_strided` and
`fft_pair` take any 2 <= n <= 8192 whose prime factors are all <= 64
(`kernel_radices`), a superset-equal of the JAX package's ``_v3_plan``
coverage, and the real kernels every even n whose n/2 that is
(`r2c_supports`); `fft_pair` and `fft_r2c_pair` take the planes
`pair_cluster` and `r2c_pair_cluster` find a cluster for.  `fft_conv`
holds the lengths of `fft_lines` (its matrix mode those whose mm
coordinate lines fit a block, `conv_matrix_supports`);
`fft_twofactor` and `fft_conv_inv` every n <= 16384 whose primes are <=
127 (`twofactor_split`); `fft_conv_pair` the padded lengths
`conv_pair_plan` finds a cluster plane for, and in its 2-D mode the
planes of `pair_cluster`;
`fft_strided_tw` every n <= 8192 whose primes are <= 127
(`strided_tw_supports`), which with `fft_lines` and `fft_twofactor`
splits every DIRECT length the long tier meets; the R2R
kernels the n >= 4 (DCT-I/DST-I: n >= 3) whose stage length the stages
take (`dct23_supports`, `dct1_supports`, `dct4_supports`), a superset of
the JAX package's ``use_dct_kernel``, ``use_dct1_kernel``,
``use_dst1_kernel`` and ``use_dct4_kernel``.

Each wrapper checks its tensors, then runs the plain version when they lie
on the CPU and launches the kernel when they lie on a CUDA device; there is
no other fallback.  `launches` counts kernel launches per source, where
the wrappers launch.

Build: at first use, ``nvcc`` compiles each ``.cu`` into its own shared
library with a C interface (all sources at once, in parallel) under
``vkfft_tpu_torch/_build``, keyed by a hash of the sources and flags, and
``ctypes`` loads them.  Nothing is built or imported from CUDA while this
module is imported.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.ops import torch_engine
from vkfft_tpu_torch.pcomplex import STORAGE_DTYPES, Planar, planar_table
from vkfft_tpu_torch.planner.factorize import MAX_DIRECT_PRIME, prime_factors
from vkfft_tpu_torch.planner.plan import plan_axis

KERNEL_MAX_N = 8192
KERNEL_MAX_PRIME = 64
# `fft_twofactor`/`fft_conv_inv`: a line of up to 16384 points (128 KB)
# in one block, each factor a Stockham run of primes up to the planner's
# largest DIRECT prime.
TWOFACTOR_MAX_N = 16384
# The largest first factor `twofactor_split` takes: the rule that picks
# every split of the two-factor kernels (a longer n1 would move them).
TWOFACTOR_TILE = 4096
# `fft_twofactor`'s block (csrc/fft_twofactor.cu): at most 512 threads
# (kThreads), each holding at most 12 points through a stage round, 16
# outputs of a generic prime stage; the layout aims at 8 points a thread.
# A line shorter than 2048 points shares its block with others up to 2048
# points, so no thread idles at short n.  The inter-factor twiddle is two
# tables, w_n^b for b < 64 (kTwLo) and scale * w_n^(64 a).
TWOFACTOR_THREADS = 512
TWOFACTOR_AIM_POINTS = 8
TWOFACTOR_BLOCK_POINTS = 2048
TWOFACTOR_TW_LO = 64
# The in-place walk's rounds (csrc/inplace.cuh): a thread holds at most
# WALK_POINTS points of a fixed-radix stage (kPoints), or WALK_GENERIC_ITEMS
# items of a generic (prime) stage r (kGenericItems), each WALK_GENERIC_PAIRS
# of a butterfly's (r + 1) / 2 output pairs (kGenericPairs), and a round
# holds whole sequences.
WALK_POINTS = 12
WALK_GENERIC_PAIRS = 4
WALK_GENERIC_ITEMS = 2
# The fp64 walk (kItems, kRadix16 in csrc/inplace.cuh): one generic item a
# round and no radix-16 stage, its plans `stage_radices`' (with either, the
# fp64 kernels spilled at 128 registers a thread).
WALK_GENERIC_ITEMS_F64 = 1
_WALK_FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
# `fft_conv_pair`'s Bluestein mode (csrc/fft_conv_pair.cu): padded lengths
# up to 2^16, the plane held once over a cluster of up to 16 blocks, a
# block at most CONV_PAIR_TILE_MAX points (its exchange moves at most
# CONV_PAIR_XCHG points a thread, kXchg, at up to 512 threads,
# kPairThreads); the smallest such cluster, which a sweep of planes and
# clusters on the card found the fastest (PERF.md); the layout aims at 8
# points a thread.
CONV_PAIR_MAX_M = 1 << 16
CONV_PAIR_THREADS = 512
CONV_PAIR_XCHG = 16
CONV_PAIR_TILE_MAX = CONV_PAIR_XCHG * CONV_PAIR_THREADS
CONV_PAIR_AIM_POINTS = 8
_MAX_STAGES = 16  # vkfft::kMaxStages in csrc/stockham.cuh
# Radices with a butterfly of their own in csrc/stockham.cuh; every other
# radix reads its roots w_r^k from the table.
_BUTTERFLY_RADICES = (2, 4, 8)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNEL_SOURCES = ("fft_lines", "fft_strided", "fft_pair", "fft_r2c",
                  "fft_r2c_pair", "fft_conv", "fft_twofactor", "fft_conv_inv",
                  "fft_conv_pair", "fft_dct23", "fft_dct1", "fft_dct4",
                  "fft_strided_tw", "fft_dd")
# The planes `fft_pair` and `fft_conv_pair`'s 2-D mode serve
# (`pair_cluster`; `fft_r2c_pair` its real planes, `r2c_pair_cluster`):
# the set the kernels served when a block held two buffers of its share of
# a plane, the cluster growing until a block needed PAIR_BLOCK_BYTES, or
# else to its largest size, as long as a block needed at most
# PAIR_MAX_BLOCK_BYTES; kept as the gate, the kernels now hold one copy
# (`pair_layout`, `conv2d_layout`).  A larger plane runs as two axis
# passes.
PAIR_BLOCK_BYTES = 32 * 1024
PAIR_MAX_BLOCK_BYTES = 128 * 1024
PAIR_CLUSTERS = (1, 2, 4, 8, 16)
# `fft_pair`'s layout (csrc/fft_pair.cu, `pair_layout`): the plane held
# once over the smallest cluster whose blocks hold at most
# PAIR_TILE_POINTS points, else over the largest (every plane
# `pair_cluster` serves fits 8192 points a block), a thread for about
# PAIR_AIM_POINTS of them and at most PAIR_XCHG of an exchange (kXchg) at
# up to PAIR_THREADS threads (kThreads).  Small blocks, many to an SM: at
# 256 x 256, 16 blocks of 4096 points beat 8 of 8192 and 4 of 16384
# (chip_smoke.py's sweep, PERF.md).  `fft_r2c_pair` takes the same rule
# on a real plane's (ny, nz/2) complex points (`r2c_pair_layout`), where
# its own sweep found the same constants best.
PAIR_TILE_POINTS = 4096
PAIR_AIM_POINTS = 16
PAIR_XCHG = 16
PAIR_THREADS = 1024
# `fft_conv_pair`'s 2-D mode on `fft_pair`'s plane (`conv2d_layout`): a
# thread moves at most CONV2D_ODD_XCHG points of an exchange where a
# column tile's width is odd (kOddXchg; single points, 16 of them and
# their indices spilled).
CONV2D_ODD_XCHG = 8
# Shared memory a block may opt into on sm_90 (vkfft::kMaxSmemBytes in
# csrc/stockham.cuh).
MAX_SMEM_BYTES = 232448
# Flags of `fft_conv` and `fft_conv_pair`'s 2-D mode (kConjData, kXpow in
# their sources).
CONV_CONJ_DATA = 1
CONV_XPOW = 2
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The kernels with an fp64 instantiation (C entries vk_<name>_f64), and the
# most threads a block of each (kThreads64 in their sources: a double2
# takes four registers, so the bounds leave each thread 128).  The layout
# rules give at most these at 16 B a point.
F64_KERNELS = ("fft_lines", "fft_strided", "fft_pair")
F64_THREADS = {"fft_lines": 256, "fft_strided": 512, "fft_pair": 256}

# The kernels with half-storage instantiations (C entries vk_<name>_f16 and
# vk_<name>_bf16): float16 / bfloat16 planes on the fp32 walk, at the fp32
# kernel's bounds and layout (a shared point stays a float2); every kernel
# a C2C route or a fused convolution launches (fft_conv_pair in both its
# modes; the 2-D mode's entries are vk_fft_conv2d_f16 / _bf16).
STORAGE_KERNELS = ("fft_lines", "fft_twofactor", "fft_strided", "fft_pair",
                   "fft_strided_tw", "fft_conv", "fft_conv_inv",
                   "fft_conv_pair")
# The half-storage instantiations counted apart in `storage_launches`, by
# the name of their C entry, each with the library that holds it: each
# kernel of STORAGE_KERNELS (fft_conv_pair: its Bluestein mode) and
# fft_conv_pair's 2-D mode.
STORAGE_LIBRARY = {**{name: name for name in STORAGE_KERNELS},
                   "fft_conv2d": "fft_conv_pair"}
STORAGE_ENTRIES = tuple(STORAGE_LIBRARY)
# The suffix of the C entries of each dtype's instantiation.
_SUFFIX = {torch.float32: "", torch.float64: "_f64", torch.float16: "_f16",
           torch.bfloat16: "_bf16"}

# Kernel launches per wrapper, counted where the wrapper launches; the fp64
# instantiations' apart, and the half-storage ones apart by instantiation
# (``fft_lines_f16``, ``fft_lines_bf16``, ..., ``fft_conv2d_bf16``: the
# name of the C entry).
launches = {name: 0 for name in KERNEL_SOURCES}
f64_launches = {name: 0 for name in F64_KERNELS}
storage_launches = {name + _SUFFIX[dt]: 0 for name in STORAGE_ENTRIES
                    for dt in STORAGE_DTYPES}

# The kernels with zero-pad windows (the reference's in_nonzero, in_window,
# out_keep, out_fill, out_zero_window and corner keeps): C entries
# ``vk_<name>_zp`` and their instantiations ``_zp_f64``, ``_zp_f16``,
# ``_zp_bf16`` in the kernel's own source, counted apart in `zp_launches`
# by entry (``fft_lines_zp``, ``fft_pair_zp_bf16``, ...).
ZP_KERNELS = ("fft_lines", "fft_twofactor", "fft_strided", "fft_pair")
ZP_DTYPES = {name: ((torch.float32,) + STORAGE_DTYPES
                    + ((torch.float64,) if name in F64_KERNELS else ()))
             for name in ZP_KERNELS}
ZP_ENTRIES = tuple(name + "_zp" + _SUFFIX[dt] for name in ZP_KERNELS
                   for dt in ZP_DTYPES[name])
# fft_conv_pair's 2-D mode has windowed entries too (``vk_fft_conv2d_zp``,
# ``_f16``, ``_bf16``: _conv_pair_kernel's in_keep / out_keep), counted in
# `zp_launches` beside the four kernels'.
ZP_CONV2D_ENTRIES = tuple("fft_conv2d_zp" + _SUFFIX[dt]
                          for dt in (torch.float32,) + STORAGE_DTYPES)
# The kernels of the Bluestein routes have windowed entries of Bluestein's
# read window (``vk_fft_conv_zp``, ``vk_fft_conv_pair_zp`` in its
# Bluestein mode, ``vk_fft_strided_tw_zp`` in its plane mode, each with
# ``_f16`` and ``_bf16`` twins: _conv_v3_kernel's blu_in, _conv_pair_kernel's
# and _strided_kernel's in_keep), the read bound ``in_keep`` an argument of
# its own beside the line's pitch, counted in `zp_launches`.
ZP_BLUESTEIN_KERNELS = ("fft_conv", "fft_conv_pair", "fft_strided_tw")
ZP_BLUESTEIN_ENTRIES = tuple(name + "_zp" + _SUFFIX[dt]
                             for name in ZP_BLUESTEIN_KERNELS
                             for dt in (torch.float32,) + STORAGE_DTYPES)
zp_launches = {entry: 0 for entry in ZP_ENTRIES + ZP_CONV2D_ENTRIES
               + ZP_BLUESTEIN_ENTRIES}

# The kernels with entries in the kept intermediate order (the reference's
# keep_intermediate_order, its tl layouts): C entries ``vk_<name>_tl`` and
# their ``_f16``, ``_bf16`` twins in the kernel's own source, counted apart
# in `tl_launches` by entry (``fft_lines_tl``, ``fft_pair_tl_bf16``, ...).
TL_KERNELS = ("fft_lines", "fft_pair")
TL_ENTRIES = tuple(name + "_tl" + _SUFFIX[dt] for name in TL_KERNELS
                   for dt in (torch.float32,) + STORAGE_DTYPES)
tl_launches = {entry: 0 for entry in TL_ENTRIES}


def zp_entry(name: str, dtype: torch.dtype) -> str:
    """The windowed C entry of kernel ``name`` on planes of ``dtype``."""
    return name + "_zp" + _SUFFIX[dtype]


def reset_launches() -> None:
    for counts in (launches, f64_launches, storage_launches, zp_launches,
                   tl_launches):
        for name in counts:
            counts[name] = 0


def point_bytes(dtype: torch.dtype = torch.float32) -> int:
    """Shared bytes of one complex point of planes of ``dtype`` (a float2,
    a double2; a float2 for the half-storage planes, which the fp32 walk
    holds widened)."""
    if dtype == torch.float64:
        return 16
    if dtype == torch.float32 or dtype in STORAGE_DTYPES:
        return 8
    raise TypeError(f"no kernel takes {dtype} planes")


def table_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the stage and twiddle tables of planes of ``dtype``:
    float64 for the fp64 kernels, float32 for the rest (the half-storage
    instantiations compute in fp32)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _walk_of(pbytes: int) -> tuple[bool, int]:
    """(radix-16 stages: `walk_radices`, else `stage_radices`; generic
    items a round) of the walk's instantiation at ``pbytes`` shared bytes a
    point: fp32's (8) or fp64's (16)."""
    return ((True, WALK_GENERIC_ITEMS) if pbytes == 8
            else (False, WALK_GENERIC_ITEMS_F64))


# ---------------------------------------------------------------------------
# Plan and tables shared by the kernels and their plain versions.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def stage_radices(n: int) -> Optional[tuple[int, ...]]:
    """Stage radices of one shared-memory Stockham run of length n
    (``csrc/stockham.cuh``), or None unless 2 <= n <= 8192 with every prime
    factor <= 127.  Powers of two go as radix 8 (one 8*2 becomes 4*4, so
    no radix-2 stage when a radix-8 one exists), then every odd prime as a
    stage of its own, largest first."""
    if n < 2 or n > KERNEL_MAX_N:
        return None
    primes = prime_factors(n)
    if primes[-1] > MAX_DIRECT_PRIME:
        return None
    twos = primes.count(2)
    rad = [8] * (twos // 3)
    if twos % 3 == 2:
        rad.append(4)
    elif twos % 3 == 1:
        if rad:
            rad[-1] = 4
            rad.append(4)
        else:
            rad.append(2)
    rad += sorted((p for p in primes if p != 2), reverse=True)
    assert len(rad) <= _MAX_STAGES, (n, rad)
    return tuple(rad)


@functools.lru_cache(maxsize=4096)
def kernel_radices(n: int) -> Optional[tuple[int, ...]]:
    """Stage radices of `fft_lines`, `fft_strided`, `fft_pair` and
    `fft_conv` for length n, or None when n is out of their range (a prime
    factor above 64)."""
    rad = stage_radices(n)
    if rad is None or prime_factors(n)[-1] > KERNEL_MAX_PRIME:
        return None
    return rad


def kernel_supports(n: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether `fft_lines` (and so `fft_strided`, and at float32
    `fft_conv`) takes lines of length n of ``dtype``: n of
    `kernel_radices`, and at float64 a block of `lines_layout` within
    shared memory (every such n; the half-storage planes take fp32's
    layouts)."""
    if kernel_radices(n) is None:
        return False
    return (point_bytes(dtype) == 8
            or lines_layout(n, dtype)[2] <= MAX_SMEM_BYTES)


def _divisors(n: int) -> list[int]:
    divs = [1]
    for p, e in collections.Counter(prime_factors(n)).items():
        divs = [d * p ** k for d in divs for k in range(e + 1)]
    return sorted(divs)


@functools.lru_cache(maxsize=4096)
def twofactor_split(n: int) -> Optional[tuple[int, int]]:
    """(n1, n2) of `fft_twofactor` for length n: n = n1*n2 viewed as an
    (n2, n1) row-major matrix, each factor a Stockham run (`stage_radices`;
    n2 may be 1 for a prime n), the larger factor as small as it can be and
    n1 >= n2.  None unless 2 <= n <= 16384 with every prime factor <= 127.
    The JAX package's v2 needs both factors <= 128 (``split_lane_major``);
    here a factor is any Stockham run, so every such n has a split."""
    if n < 2 or n > TWOFACTOR_MAX_N or prime_factors(n)[-1] > MAX_DIRECT_PRIME:
        return None
    best = None
    for n1 in reversed(_divisors(n)):
        n2 = n // n1
        if n1 < n2:
            break
        if (stage_radices(n1) is not None
                and (n2 == 1 or stage_radices(n2) is not None)
                and n1 <= TWOFACTOR_TILE):
            best = (n1, n2)
    return best


@functools.lru_cache(maxsize=4096)
def split_lane_major(n: int) -> Optional[tuple[int, int]]:
    """(n1, n2) of the JAX package's v2 kernel, its ``split_lane_major``
    (``pallas_engine.py:857``): n1 the largest divisor of n up to 128, n2 =
    n // n1, None where n2 > 128.  The port's own copy: the digit order of
    the keep_intermediate_order route on `fft_twofactor`'s lengths, which
    `fft_twofactor` takes as its ``split`` (its own rule, `twofactor_split`,
    picks other factors at 121 lengths from 8208 on, 8208 as (108, 76)
    where this gives (114, 72)).  n1 >= n2 always: a larger n2 would be a
    divisor up to 128 above n1."""
    best = next(((n1, n // n1) for n1 in range(min(n, 128), 0, -1)
                 if n % n1 == 0), None)
    return best if best is not None and best[1] <= 128 else None


def _check_split(n: int, split, what: str) -> tuple[int, int]:
    """``split`` (n1, n2) of `fft_twofactor` at length n, or its own
    `twofactor_split` for None: n = n1 * n2, n1 >= n2, each factor a
    Stockham run (n2 may be 1), n1 <= TWOFACTOR_TILE."""
    if split is None:
        return twofactor_split(n)
    n1, n2 = (int(f) for f in split)
    if not (n1 * n2 == n and n1 >= n2 >= 1 and n1 <= TWOFACTOR_TILE
            and stage_radices(n1) is not None
            and (n2 == 1 or stage_radices(n2) is not None)):
        raise ValueError(f"{what}: ({n1}, {n2}) is no split of {n} "
                         "(n1 * n2 = n, n1 >= n2, each a Stockham run, n1 <= "
                         f"{TWOFACTOR_TILE})")
    return n1, n2


def twofactor_supports(n: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether `fft_twofactor` takes lines of length n of ``dtype``:
    `twofactor_split` holds n, on float32 or half-storage planes."""
    return (twofactor_split(n) is not None
            and (dtype == torch.float32 or dtype in STORAGE_DTYPES))


def strided_tw_supports(n: int) -> bool:
    """Whether `fft_strided_tw` (the factor mode of `fft_strided`) takes a
    transform length n: a Stockham run (`stage_radices`: n <= 8192, primes
    <= 127)."""
    return stage_radices(n) is not None


# ---------------------------------------------------------------------------
# The long tier: lengths beyond one kernel as two or three uploads, each a
# pass over the whole line.  The splits are this card's own, by a cost
# model fitted to an H100's times of each pass over 2^24 points
# (`bench_torch_long.py`; PERF.md), in units of a pass that reads whole
# sectors (0.19 ms): a strided pass of length n reads each row of its tile
# as a run of ts floats (`strided_tw_layout`: 4096/n, at least 8 where
# they fit beside the tables, 6 at 4096 and 3 at 8192), and a tile of
# more than STRIDED_TILE_POINTS points holds fewer blocks an SM (the walk's
# `fft_strided` over 2^24 points: 0.19 ms at n = 1024, 0.53 at 4096,
# 0.78 at 8192 against 0.11 at n = 64; PERF.md §6 row 2);
# `fft_lines` runs 0.14-0.19 ms to n = 4096 and 0.27 at 8192,
# `fft_twofactor` 0.49 at 16384 (one block per SM).  The kernel redesigned
# since runs a 16384-point pass over 2^23 points (512 lines) in 0.148 ms
# (chip_smoke.py any_times on an H100; PERF.md), about 0.30 over 2^24:
# its weight below (3.0) is not re-fitted yet (ROADMAP).
# ---------------------------------------------------------------------------

LONG_LINES_MIN = 8     # the contiguous factor: no tensor-op tiny DFT
# A third upload's fixed costs (one more launch, a fresh buffer for the
# interleaved pass), in passes: two uploads win a near-tie.
THREE_UPLOAD_COST = 0.5


def _strided_cost(n: int) -> float:
    """Relative cost of a strided pass of length n at the columns ts of
    `strided_tw_layout`: (8/ts)^0.75 for tiles of ts < 8 columns (runs
    shorter than a sector) times (ts * n / STRIDED_TILE_POINTS)^0.75 for
    tiles of more points (fewer blocks an SM), and one more where a prime
    above 64 takes an O(r^2) stage.  At n = 1024, 2048 and 4096 the same
    values as the rule before the walk (ts = min(32, 4096/n)) gave."""
    ts = strided_tw_layout(n, 1 << 30)[0]
    return (max(1.0, (8.0 / ts) ** 0.75)
            * max(1.0, ts * n / STRIDED_TILE_POINTS) ** 0.75
            + (prime_factors(n)[-1] > KERNEL_MAX_PRIME))


def _lines_cost(n: int) -> Optional[float]:
    """Relative cost of the contiguous pass of length n, or None where no
    kernel of one pass takes it."""
    if n < LONG_LINES_MIN:
        return None
    if kernel_supports(n):
        return 1.0 if n <= 4096 else 1.4
    return 3.0 if twofactor_supports(n) else None


def _best_split(cands):
    """The cheapest split, then the one of fewer uploads, then the most
    even; None if there is none."""
    return min(cands, key=lambda c: (c[0], len(c[1]), max(c[1]), c[1]))[1] \
        if cands else None


@functools.lru_cache(maxsize=1024)
def long_split(n: int, uploads: int = 0) -> Optional[tuple[int, ...]]:
    """The long tier's split of a DIRECT length n: (nc, ns) for two uploads
    or (na, nb, ns) for three, the strided factors lengths of
    `strided_tw_supports` and ns one of `fft_lines` or `fft_twofactor`
    (8 <= ns <= 16384).  The cheapest by `_strided_cost`, `_lines_cost`
    and THREE_UPLOAD_COST, then the one of fewer uploads, then the most
    even: powers of two to 2^23 in two uploads, from 2^24 in three (two
    reach 2^27).  ``uploads`` 2 or 3 asks for that many.  None when no
    split exists (beyond 2^40, or too many primes above 64)."""
    divs = _divisors(n)
    cands = []
    if uploads in (0, 2):
        cands = [(_strided_cost(n // ns) + cost, (n // ns, ns)) for ns in divs
                 if (cost := _lines_cost(ns)) is not None and ns < n
                 and strided_tw_supports(n // ns)]
    if uploads in (0, 3):
        for ns in divs:
            cost = _lines_cost(ns)
            if cost is None or ns >= n:
                continue
            rest = n // ns
            for na in _divisors(rest):
                nb = rest // na
                if (na > 1 and nb > 1 and strided_tw_supports(na)
                        and strided_tw_supports(nb)):
                    cands.append((_strided_cost(na) + _strided_cost(nb) + cost
                                  + THREE_UPLOAD_COST, (na, nb, ns)))
    return _best_split(cands)


@functools.lru_cache(maxsize=1024)
def bluestein_long_split(m: int) -> Optional[tuple[int, int]]:
    """(nc, ns) of the fused long Bluestein of padded length m: the strided
    passes of length nc (`strided_tw_supports`) around `fft_conv`'s rows
    mode on the ns-point lines (`kernel_supports`), the cheapest and most
    even such split; None where ns fits no `fft_conv` (the composition on
    the long DIRECT routes runs)."""
    cands = [(2 * _strided_cost(m // ns) + _lines_cost(ns), (m // ns, ns))
             for ns in _divisors(m)
             if LONG_LINES_MIN <= ns < m and kernel_supports(ns)
             and strided_tw_supports(m // ns)]
    return _best_split(cands)


def long_folds(split: tuple[int, ...]) -> bool:
    """Whether the natural order of the long tier at ``split`` needs no
    transpose: the last pass (two uploads: `fft_strided` over ns rows and
    nc columns after a first pass that stores its tile transposed; three:
    `fft_strided_tw` over ns rows and na columns, its planes interleaved)
    takes ns and holds a tile of STRIDED_MIN_COLUMNS columns or more, runs
    of whole sectors.  Elsewhere the (kc, ks) -> (ks, kc) reorder stays a
    tensor op, as in the JAX package where ``tl_ok`` fails."""
    *strided, ns = split
    if len(split) == 2:
        return (kernel_supports(ns)
                and strided_layout(ns, strided[0])[0] >= STRIDED_MIN_COLUMNS)
    return (strided_tw_supports(ns)
            and strided_tw_layout(ns, strided[0])[0] >= STRIDED_MIN_COLUMNS)


def long_order(spec, split: tuple[int, ...]):
    """A natural-order spectrum of length n (numpy array or tensor) in the
    long tier's swapped order of ``split``: position (kc, ks) holds bin kc
    + nc*ks, nc the product of the strided factors, as the forward passes
    leave it without the reorder (three uploads too: their second pass
    writes the middle digits in natural order)."""
    ns = split[-1]
    return spec.reshape(ns, len(spec) // ns).T


@dataclasses.dataclass(frozen=True)
class Factor:
    """A factor exp(-+2 pi i e / N) (+ with ``inverse``) on each point of a
    (P, n, S) plane of `fft_strided`'s factor mode, its exponent e an
    integer of the point's (p, row, s):

    * "twiddle", the four-step twiddle: e = (row * a + (p % pm) * b + s %
      sm) * (s // sd);
    * "chirp", the Bluestein chirp exp(-+i pi j^2 / n) at N = 2n: e = j^2
      mod N, j = row * S + s the point's index in its line.
    """
    kind: str
    N: int
    inverse: bool = False
    a: int = 1
    pm: int = 1
    b: int = 0
    sd: int = 1
    sm: int = 1

    def ints(self) -> list[int]:
        """The kernel's form: kind, sign, N, a, pm, b, sd, sm."""
        return [{"twiddle": 1, "chirp": 2}[self.kind],
                1 if self.inverse else -1, self.N, self.a, self.pm, self.b,
                self.sd, self.sm]


def twiddle(N: int, inverse: bool = False, a: int = 1, pm: int = 1,
            b: int = 0, sd: int = 1, sm: int = 1) -> Factor:
    """w_N^(-+(row*a + (p % pm)*b + s % sm) * (s // sd)): the two-upload
    twiddle w_N^(kc*js) at the defaults, three uploads' w_(NaNb)^(ka*jb)
    with sd = Ns and w_N^((kb*Na + ka)*js) with a = pm = Na, b = 1 (on
    the folded order's columns s = js*Na + ka: a = sm = sd = Na)."""
    return Factor("twiddle", N, inverse, a, pm, b, sd, sm)


def chirp(n: int, inverse: bool = False) -> Factor:
    """Bluestein's chirp exp(-+i pi j^2 / n) of point j of a line of n
    (`luts.bluestein_chirp`)."""
    return Factor("chirp", 2 * n, inverse)


def conv_pair_plan(m: int) -> Optional[tuple[int, int, int]]:
    """(nc, ns, cluster) of `fft_conv_pair`'s Bluestein mode for a padded
    length m: the line as an (nc, ns) row-major plane, both factors lengths
    of the stages (`kernel_supports`), ns >= nc, with a cluster of 1, 2, 4,
    8 or 16 blocks dividing nc and ns whose blocks hold at most
    CONV_PAIR_TILE_MAX points, and of those the plane of the fewest stages
    (`walk_radices`; a generic radix r counts r / 8), then the most square;
    the cluster the smallest that fits.  None when m > 2^16 or no split
    fits a cluster.  The walk's time follows its stages (PERF.md)."""
    return _conv_pair_plan(m)


def _stage_cost(n: int) -> float:
    """The in-place walk's stages of an n-point run, a generic radix r
    counted r / 8 (its O(r^2) sums)."""
    return sum(1.0 if r in _WALK_FIXED_RADICES else r / 8.0
               for r in walk_radices(n))


@functools.lru_cache(maxsize=1024)
def _conv_pair_plan(m: int) -> Optional[tuple[int, int, int]]:
    if m > CONV_PAIR_MAX_M:
        return None
    best, best_key = None, None
    for nc in _divisors(m):
        ns = m // nc
        if nc > ns:
            break
        if not (kernel_supports(nc) and kernel_supports(ns)):
            continue
        fits = [c for c in PAIR_CLUSTERS if nc % c == 0 and ns % c == 0
                and m // c <= CONV_PAIR_TILE_MAX]
        if not fits:
            continue
        key = (_stage_cost(nc) + _stage_cost(ns), -nc)
        if best_key is None or key < best_key:
            best_key, best = key, (nc, ns, fits[0])
    return best


def conv_pair_layout(m: int) -> tuple[int, int, int, int, int]:
    """(nc, ns, cluster, threads, shared bytes) of an `fft_conv_pair`
    Bluestein block for padded length m, the one layout rule (the C entry
    refuses any other): `conv_pair_plan`'s plane and cluster; ``threads`` a
    multiple of 32 near one thread for 8 points of the block's m /
    cluster, at most 512; the block's tile at the row pitch ns | 1, the
    four stage tables (`walk_radices`) and the four-step twiddle's two
    root tables."""
    nc, ns, c = conv_pair_plan(m)
    tile = m // c
    want = -(-tile // CONV_PAIR_AIM_POINTS)
    threads = min(CONV_PAIR_THREADS, max(32, -(-want // 32) * 32))
    points = ((nc // c) * (ns | 1) + 2 * _table_points(nc, True)
              + 2 * _table_points(ns, True) + TWOFACTOR_TW_LO
              + -(-m // TWOFACTOR_TW_LO))
    return nc, ns, c, threads, 8 * points


def conv_pair_occupancy(m: int,
                        dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(resident clusters on the card, resident blocks an SM) of
    `fft_conv_pair`'s Bluestein mode at the layout of padded length m on
    lines of ``dtype``, from ``cudaOccupancyMaxActiveClusters`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (C entry
    ``vk_fft_conv_pair_occupancy``, ``vk_fft_conv_pair_f16_occupancy``,
    ...)."""
    return _cluster_occupancy("fft_conv_pair",
                              f"fft_conv_pair{_SUFFIX[dtype]}_occupancy",
                              *conv_pair_layout(m)[2:])


def conv_matrix_supports(n: int, mm: int) -> bool:
    """Whether `fft_conv`'s matrix mode takes lines of length n with mm = 2
    or 3 coordinates: n a length of the stages with 16 mm n bytes within
    a block's shared memory (at mm = 3 up to n = 4096 of the powers of
    two; the JAX package's VMEM holds 8192).  The set the kernel served
    when it held two buffers of an item's lines, kept as the fusion rule's
    gate; a block now holds the item's lines once (`conv_layout`)."""
    return (mm in (2, 3) and kernel_supports(n)
            and 2 * 8 * mm * n <= MAX_SMEM_BYTES)


def r2c_supports(n: int) -> bool:
    """Whether `fft_r2c`/`fft_c2r` take real lines of length n: n even and
    n/2 a length the stages take (n up to 16384)."""
    return n % 2 == 0 and kernel_supports(n // 2)


def dct1_length(n: int, dst: bool) -> int:
    """Complex points of `fft_dct1`'s pipeline: the real FFT of the 2(n-1)
    (DCT-I) or 2(n+1) (DST-I) point extension runs as half as many."""
    return n + 1 if dst else n - 1


def dct4_length(n: int) -> int:
    """The stage length of `fft_dct4`'s gate: n/2 for even n, 2n for odd n
    (the JAX package's 2n form, whose length its kernels gate on)."""
    return n // 2 if n % 2 == 0 else 2 * n


def dct4_points(n: int) -> int:
    """Complex points of `fft_dct4`'s pipeline: n/2 for even n (a line
    each), n for odd n (two lines each, a real DFT of the same size)."""
    return n // 2 if n % 2 == 0 else n


def dct23_supports(n: int) -> bool:
    """Whether `fft_dct23` takes lines of length n: n >= 4 and n a length
    of the stages (every n the JAX package's ``use_dct_kernel`` takes,
    whose 2n is one)."""
    return n >= 4 and kernel_supports(n)


def dct1_supports(n: int, dst: bool) -> bool:
    """Whether `fft_dct1` takes lines of length n: n >= 3 and n -+ 1 a
    length of the stages (``use_dct1_kernel``/``use_dst1_kernel`` want
    2(n -+ 1) to be one)."""
    return n >= 3 and kernel_supports(dct1_length(n, dst))


def dct4_supports(n: int) -> bool:
    """Whether `fft_dct4` takes lines of length n: n >= 4 and
    `dct4_length` a length of the stages (``use_dct4_kernel`` wants 2n)."""
    return n >= 4 and kernel_supports(dct4_length(n))


def _cluster(ny: int, cols: int, pbytes: int = 8) -> Optional[int]:
    """Blocks of a cluster that holds ny x cols complex points of
    ``pbytes`` bytes (see PAIR_BLOCK_BYTES: two buffers of them), each
    block ny/C rows or cols/C columns, or None."""
    fits = [c for c in PAIR_CLUSTERS if ny % c == 0 and cols % c == 0
            and 2 * pbytes * ny * cols // c <= PAIR_MAX_BLOCK_BYTES]
    for c in fits:
        if 2 * pbytes * ny * cols // c <= PAIR_BLOCK_BYTES:
            return c
    return fits[-1] if fits else None


@functools.lru_cache(maxsize=1024)
def pair_cluster(ny: int, nz: int,
                 dtype: torch.dtype = torch.float32) -> Optional[int]:
    """Blocks of the cluster that holds one (ny, nz) plane of ``dtype`` in
    `fft_pair` (see PAIR_BLOCK_BYTES, at `point_bytes` a point: float64
    serves the planes of at most 4096 points a block, 256 x 256 among
    them), or None when the plane does not fit or an axis is outside the
    kernels' range."""
    if not (kernel_supports(ny) and kernel_supports(nz)):
        return None
    return _cluster(ny, nz, point_bytes(dtype))


def _two_factors(n: int, threads: int,
                 pbytes: int = 8) -> Optional[tuple[int, int]]:
    """The two factors n1 >= n2 > 1 of n of fewest stages (`walk_radices`,
    a generic radix r as r / 8), then the most square, among those whose
    stages fit a round of ``threads`` threads (`walk_rounds_fit` of the
    walk at ``pbytes`` a point); None where none does (a prime n)."""
    walk, items = _walk_of(pbytes)
    best, best_key = None, None
    for n2 in _divisors(n)[1:]:
        n1 = n // n2
        if n1 < n2:
            break
        if not (stage_radices(n1) and stage_radices(n2)
                and walk_rounds_fit(n1, threads, walk, items)
                and walk_rounds_fit(n2, threads, walk, items)):
            continue
        key = (_stage_cost(n1) + _stage_cost(n2), -n2)
        if best_key is None or key < best_key:
            best, best_key = (n1, n2), key
    return best


def _pair_factors(n: int, threads: int, pbytes: int = 8) -> tuple[int, int]:
    """(n1, n2) of one axis of `fft_pair` at ``threads`` a block: (n, 1),
    one pass, where every stage's sequences fit a round of the threads
    (`walk_rounds_fit` of the walk at ``pbytes`` a point), else
    `_two_factors`."""
    if walk_rounds_fit(n, threads, *_walk_of(pbytes)):
        return n, 1
    best = _two_factors(n, threads, pbytes)
    assert best is not None, (n, threads)
    return best


def pair_splits(ny: int, nz: int, dtype: torch.dtype = torch.float32):
    """((n1z, n2z), (n1y, n2y)): the factors of each axis of `fft_pair` at
    the threads of `pair_layout` (`_pair_factors`)."""
    return _plane_layout(ny, nz, False, PAIR_TILE_POINTS, PAIR_AIM_POINTS,
                         pbytes=point_bytes(dtype))[3]


def pair_layout(ny: int, nz: int,
                dtype: torch.dtype = torch.float32) -> tuple[int, int, int]:
    """(cluster, threads, shared bytes) of an `fft_pair` block for a plane
    `pair_cluster` serves, the one layout rule (the C entry refuses any
    other): the smallest cluster (1, 2, 4, 8, 16) dividing ny and nz whose
    blocks hold at most PAIR_TILE_POINTS points, else the largest;
    ``threads`` a multiple of 32 near one for PAIR_AIM_POINTS points and at
    least one for PAIR_XCHG, in 32..PAIR_THREADS; the block's tile (the z
    factors' rows at the odd pitch n1z | 1) beside the four stage tables
    (`walk_radices`) and both axes' twiddle root tables.  At float64 the
    same rule in points at 16 B a point (at most F64_THREADS threads on
    the planes `pair_cluster` serves at float64)."""
    return _plane_layout(ny, nz, False, PAIR_TILE_POINTS, PAIR_AIM_POINTS,
                         pbytes=point_bytes(dtype))[:3]


@functools.lru_cache(maxsize=4096)
def _plane_layout(ny: int, nz: int, real: bool, tile_points: int, aim: int,
                  odd_xchg: int = PAIR_XCHG, pbytes: int = 8):
    """(cluster, threads, shared bytes, splits) of `fft_pair` on a complex
    (ny, nz) plane, or of `fft_r2c_pair` on a ``real`` one, whose rows are
    m = nz/2 complex points and whose z twiddles are `r2c_twiddle`'s, a
    thread moving at most ``odd_xchg`` points of an exchange where a
    column tile's width is odd, ``pbytes`` shared bytes a point (16: the
    fp64 `fft_pair`, its threads at most F64_THREADS); computed once a
    plane at the given constants (a launch reads them; the sweeps change
    the constants)."""
    m = nz // 2 if real else nz
    fits = [k for k in PAIR_CLUSTERS if ny % k == 0 and m % k == 0]
    c = next((k for k in fits if ny * m // k <= tile_points), fits[-1])
    tile, rows = ny * m // c, ny // c
    xchg = odd_xchg if (m // c) % 2 else PAIR_XCHG
    want = max(-(-tile // aim), -(-tile // xchg))
    cap = PAIR_THREADS if pbytes == 8 else F64_THREADS["fft_pair"]
    threads = min(cap, max(32, -(-want // 32) * 32))
    (n1z, n2z), (n1y, n2y) = splits = (_pair_factors(m, threads, pbytes),
                                       _pair_factors(ny, threads, pbytes))
    walk = _walk_of(pbytes)[0]
    twz = (len(r2c_twiddle(nz, False)) if real
           else TWOFACTOR_TW_LO + -(-nz // TWOFACTOR_TW_LO))
    points = (rows * n2z * (n1z | 1)
              + sum(_table_points(k, walk) for k in (n1z, n2z, n1y, n2y))
              + twz + TWOFACTOR_TW_LO + -(-ny // TWOFACTOR_TW_LO))
    return c, threads, pbytes * points, splits


def conv2d_layout(ny: int, nz: int):
    """(cluster, threads, shared bytes, ((n1z, n2z), (n1y, n2y))) of a
    block of `fft_conv_pair`'s 2-D mode for a plane `pair_cluster` serves,
    the one layout rule (the C entry refuses any other): `fft_pair`'s plane
    (`_plane_layout` at PAIR_TILE_POINTS and PAIR_AIM_POINTS), with at most
    CONV2D_ODD_XCHG points a thread of an exchange where the column tile's
    width is odd (there the threads, and so the axes' factors, may differ
    from `pair_layout`'s).  The kernel runs the inverse as the forward DFT
    of the conjugated data, so it holds `fft_pair`'s tables (one stage
    table a factor, one twiddle an axis) and its shared bytes at the same
    factors."""
    return _plane_layout(ny, nz, False, PAIR_TILE_POINTS, PAIR_AIM_POINTS,
                         CONV2D_ODD_XCHG)


def conv2d_occupancy(ny: int, nz: int,
                     dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(resident clusters on the card, resident blocks an SM) of
    `fft_conv_pair`'s 2-D mode at the layout of an (ny, nz) plane of
    ``dtype`` (C entry ``vk_fft_conv2d_occupancy``,
    ``vk_fft_conv2d_f16_occupancy``, ...)."""
    return _cluster_occupancy("fft_conv_pair",
                              f"fft_conv2d{_SUFFIX[dtype]}_occupancy",
                              *conv2d_layout(ny, nz)[:3])


def _cluster_occupancy(name: str, entry: str, c: int, threads: int,
                       smem: int) -> tuple[int, int]:
    """(resident clusters, resident blocks an SM) from C entry
    ``vk_<entry>`` of library ``name`` at `c` blocks a cluster."""
    fn = getattr(_library(name), "vk_" + entry)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    clusters, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(c, threads, smem, ctypes.byref(clusters), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"vk_{entry}({c}, {threads}, {smem}) failed: "
                           f"CUDA error {err}")
    return clusters.value, blocks.value


def pair_occupancy(ny: int, nz: int,
                   dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(resident clusters on the card, resident blocks an SM) of `fft_pair`
    at the layout of an (ny, nz) plane of ``dtype``, from
    ``cudaOccupancyMaxActiveClusters`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (C entry
    ``vk_fft_pair_occupancy``, ``vk_fft_pair_f64_occupancy``)."""
    return _cluster_occupancy("fft_pair",
                              f"fft_pair{_SUFFIX[dtype]}_occupancy",
                              *pair_layout(ny, nz, dtype))


@functools.lru_cache(maxsize=1024)
def r2c_pair_cluster(ny: int, nz: int) -> Optional[int]:
    """Blocks of the cluster that holds one real (ny, nz) plane in
    `fft_r2c_pair`: the rule of `pair_cluster` on its (ny, nz/2) complex
    points, or None when nz is odd, an axis is outside the kernels' range
    or the plane does not fit."""
    if not (nz % 2 == 0 and kernel_supports(ny) and kernel_supports(nz // 2)):
        return None
    return _cluster(ny, nz // 2)


def r2c_pair_splits(ny: int, nz: int):
    """((n1z, n2z), (n1y, n2y)): the factors of m = nz/2 and of ny in
    `fft_r2c_pair` at the threads of `r2c_pair_layout` (`_pair_factors`)."""
    return _plane_layout(ny, nz, True, PAIR_TILE_POINTS, PAIR_AIM_POINTS)[3]


def walk_generic(factors) -> bool:
    """Whether a stage of the walk over lengths ``factors`` has a radix
    without a butterfly of its own (the generic stage, ``stage_generic``
    in csrc/inplace.cuh)."""
    return any(r not in _WALK_FIXED_RADICES
               for k in factors for r in walk_radices(k) or ())


def r2c_pair_generic(ny: int, nz: int) -> bool:
    """Whether a stage of `fft_r2c_pair` on a real (ny, nz) plane has a
    radix without a butterfly of its own: the forward kernel's
    instantiation with the generic stage (``has_generic`` in
    csrc/inplace.cuh)."""
    return walk_generic(k for split in r2c_pair_splits(ny, nz) for k in split)


def r2c_pair_layout(ny: int, nz: int) -> tuple[int, int, int]:
    """(cluster, threads, shared bytes) of an `fft_r2c_pair` /
    `fft_c2r_pair` block for a real plane `r2c_pair_cluster` serves, the
    one layout rule (the C entry refuses any other): `pair_layout`'s on the
    (ny, m = nz/2) complex points, the smallest cluster (1, 2, 4, 8, 16)
    dividing ny and m whose blocks hold at most PAIR_TILE_POINTS points,
    else the largest; ``threads`` a multiple of 32 near one for
    PAIR_AIM_POINTS points and at least one for PAIR_XCHG, in
    32..PAIR_THREADS; the
    block's row tile (the z factors' rows at the odd pitch n1z | 1)
    beside the four stage tables (`walk_radices`), the z twiddles of
    `r2c_twiddle` and the y axis's inter-factor twiddle."""
    return _plane_layout(ny, nz, True, PAIR_TILE_POINTS, PAIR_AIM_POINTS)[:3]


def r2c_pair_occupancy(ny: int, nz: int,
                       inverse: bool = False) -> tuple[int, int]:
    """(resident clusters on the card, resident blocks an SM) of
    `fft_r2c_pair` (`fft_c2r_pair` with ``inverse``) at the layout of a
    real (ny, nz) plane (C entry ``vk_fft_r2c_pair_occupancy``; the
    forward's instantiation of `r2c_pair_generic`)."""
    c, threads, smem = r2c_pair_layout(ny, nz)
    generic = int(r2c_pair_generic(ny, nz))
    fn = _library("fft_r2c_pair").vk_fft_r2c_pair_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    clusters, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(int(inverse), generic, c, threads, smem,
             ctypes.byref(clusters), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"vk_fft_r2c_pair_occupancy({int(inverse)}, "
                           f"{generic}, {c}, {threads}, {smem}) failed: "
                           f"CUDA error {err}")
    return clusters.value, blocks.value


# `fft_strided`'s block (csrc/fft_strided.cu, `strided_layout`): a tile of
# ts neighbouring columns across all n rows, held once in shared memory:
# STRIDED_TILE_POINTS // n columns, but at least STRIDED_MIN_COLUMNS (a
# 32-byte sector of each plane-row) where shared memory holds them beside
# the tables, else the most it holds, and at most S; a thread for about
# STRIDED_AIM_POINTS points, up to STRIDED_THREADS; one pass where the
# one-pass tile holds STRIDED_MIN_COLUMNS columns and its stages fit a
# round of the threads, else two factors (the late stages of a lone long
# column in one pass read at a stride of r points, PERF.md).
STRIDED_TILE_POINTS = 4096
STRIDED_MIN_COLUMNS = 8
STRIDED_AIM_POINTS = 16
STRIDED_THREADS = 1024


def _column_points(split, padded: bool, ts: Optional[int] = None) -> int:
    """Points a column of a strided tile takes in shared memory: n1 * n2,
    or with ``padded`` (`fft_strided_tw`'s lines, ``tile_stride``) for one
    pass of ts < 16 columns a power of two n1 rounded up to 16 / ts mod 16
    where the tile still fits beside its tables, else (and with ts None)
    the odd stride (n2 * (n1 | 1)) | 1 of its (n2, n1) matrix at the pitch
    n1 | 1."""
    n1, n2 = split
    if not padded:
        return n1 * n2
    if ts is not None and n2 == 1 and ts < 16 and 16 % ts == 0:
        even = n1 + (16 // ts - n1) % 16
        if ts * even + _strided_table_points(*split) <= MAX_SMEM_BYTES // 8:
            return even
    return (n2 * (n1 | 1)) | 1


def _strided_table_points(n1: int, n2: int, walk: bool = True) -> int:
    """Points of `fft_strided`'s stage tables (`walk_radices`; with
    ``walk`` False the fp64 walk's `stage_radices`) and the twiddle's two
    tables beside the tile."""
    return (_table_points(n1, walk) + _table_points(n2, walk)
            + TWOFACTOR_TW_LO + -(-(n1 * n2) // TWOFACTOR_TW_LO))


def _strided_columns(n: int, S: int, split, tile_points: int,
                     min_columns: int, padded: bool = False,
                     pbytes: int = 8) -> int:
    """Columns of an `fft_strided` tile of length n at ``split``
    (`fft_strided_tw`'s with ``padded``), ``pbytes`` shared bytes a
    point."""
    fit = ((MAX_SMEM_BYTES // pbytes
            - _strided_table_points(*split, _walk_of(pbytes)[0]))
           // _column_points(split, padded))
    want = max(tile_points // n, min_columns)
    return max(1, min(S, want, fit))


def _strided_threads(points: int, pbytes: int = 8) -> int:
    want = -(-points // STRIDED_AIM_POINTS)
    cap = STRIDED_THREADS if pbytes == 8 else F64_THREADS["fft_strided"]
    return min(cap, max(32, -(-want // 32) * 32))


@functools.lru_cache(maxsize=4096)
def _strided_factors(n: int, pbytes: int = 8) -> tuple[int, int]:
    """The two factors of a two-factor `fft_strided` axis: `_two_factors`
    at 32 threads, so they fit a round of any block's (the fp64 walk, one
    generic item a round, at 64: a block of two factors has more)."""
    walk, items = _walk_of(pbytes)
    best = _two_factors(n, 32 * WALK_GENERIC_ITEMS // items, pbytes)
    assert best is not None, n
    return best


def strided_split(n: int, S: int,
                  dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(n1, n2) of `fft_strided` for length n over S columns: (n, 1), one
    pass, where shared memory holds STRIDED_MIN_COLUMNS columns of n points
    beside the one-pass tables (at float32 to n = 3456 or so, at float64
    about half that) and every stage's sequences fit a round of the tile's
    threads, else `_strided_factors`."""
    return _strided_layout(n, S, STRIDED_TILE_POINTS, STRIDED_MIN_COLUMNS,
                           pbytes=point_bytes(dtype))[3]


def strided_layout(n: int, S: int,
                   dtype: torch.dtype = torch.float32) -> tuple[int, int, int]:
    """(ts, threads, shared bytes) of an `fft_strided` block for length n
    over S columns of ``dtype``, the one layout rule (the C entry refuses
    any other): STRIDED_TILE_POINTS // n columns, at least
    STRIDED_MIN_COLUMNS where shared memory holds them beside the tables,
    at most S, at the split of `strided_split`; a multiple of 32 threads
    near one for STRIDED_AIM_POINTS points, at most STRIDED_THREADS (at
    float64 F64_THREADS); the tile of ts * n points beside both factors'
    stage tables and the twiddle's two tables, `point_bytes` a point (at
    float64 a tile holds half the columns: 1 at n = 8192)."""
    return _strided_layout(n, S, STRIDED_TILE_POINTS, STRIDED_MIN_COLUMNS,
                           pbytes=point_bytes(dtype))[:3]


@functools.lru_cache(maxsize=4096)
def _strided_layout(n: int, S: int, tile_points: int, min_columns: int,
                    padded: bool = False, pbytes: int = 8):
    """`strided_layout` and `strided_split` at the given constants
    (`strided_tw_layout` and `strided_tw_split` with ``padded``; the fp64
    kernel's at ``pbytes`` 16), computed once an (n, S)."""
    one = (n, 1)
    walk, items = _walk_of(pbytes)
    fit = ((MAX_SMEM_BYTES // pbytes - _strided_table_points(*one, walk))
           // _column_points(one, padded))
    ts = _strided_columns(n, S, one, tile_points, min_columns, padded, pbytes)
    split = (one if fit >= min_columns
             and walk_rounds_fit(n, _strided_threads(ts * n, pbytes), walk,
                                 items)
             else _strided_factors(n, pbytes))
    ts = _strided_columns(n, S, split, tile_points, min_columns, padded,
                          pbytes)
    threads = _strided_threads(ts * n, pbytes)
    assert all(walk_rounds_fit(k, threads, walk, items) for k in split), \
        (n, S)
    return (ts, threads,
            pbytes * (ts * _column_points(split, padded, ts)
                      + _strided_table_points(*split, walk)), split)


def strided_occupancy(n: int, S: int,
                      dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks an SM of `fft_strided` at the layout of length n
    over S columns of ``dtype``, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current card
    (C entry ``vk_fft_strided_occupancy``, ``vk_fft_strided_f64_...``)."""
    return _occupancy("fft_strided", *strided_layout(n, S, dtype)[1:],
                      entry=f"fft_strided{_SUFFIX[dtype]}_occupancy")


def strided_tw_split(n: int, S: int) -> tuple[int, int]:
    """(n1, n2) of `fft_strided_tw` for length n over S columns:
    `strided_split`'s rule on its padded lines (n up to 8192 with primes up
    to 127, `strided_tw_supports`)."""
    return _strided_layout(n, S, STRIDED_TILE_POINTS, STRIDED_MIN_COLUMNS,
                           True)[3]


def strided_tw_layout(n: int, S: int) -> tuple[int, int, int]:
    """(ts, threads, shared bytes) of an `fft_strided_tw` block for length
    n over S columns, the one layout rule (the C entry refuses any other):
    `strided_layout`'s columns and threads, each column held as a line of
    the walk's two-factor passes (the (n2, n1) matrix at the pitch n1 | 1)
    and the lines an odd stride apart (`_column_points`), beside both
    factors' stage tables and the twiddle's two tables."""
    return _strided_layout(n, S, STRIDED_TILE_POINTS, STRIDED_MIN_COLUMNS,
                           True)[:3]


def strided_tw_occupancy(n: int, S: int,
                         dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks an SM of `fft_strided_tw` at the layout of length n
    over S columns on planes of ``dtype`` (C entry
    ``vk_fft_strided_tw_occupancy``, ``vk_fft_strided_tw_f16_occupancy``,
    ...)."""
    return _occupancy("fft_strided_tw", *strided_tw_layout(n, S)[1:],
                      entry=f"fft_strided_tw{_SUFFIX[dtype]}_occupancy")


def _unsupported(n: int) -> NotImplementedError:
    return NotImplementedError(
        f"length {n} is outside the range of the CUDA kernel (2 <= n <= "
        f"{KERNEL_MAX_N}, prime factors <= {KERNEL_MAX_PRIME}); the engine "
        "runs other lengths on the kernels of their route "
        "(cuda_engine.route), lengths beyond 16384 on the long tier")


@functools.lru_cache(maxsize=4096)
def walk_radices(n: int) -> Optional[tuple[int, ...]]:
    """Stage radices of the in-place walk's `fft_lines` and
    `fft_conv_pair` (``csrc/inplace.cuh``, which has a radix-16 butterfly):
    `stage_radices` with the power of two 2^t as radix-16 stages where that
    makes fewer stages (t = 4, 7, 8 and from 10 up: 16 * 16 for 256, 16 *
    8 for 128), else as there; None where `stage_radices` is."""
    rad = stage_radices(n)
    if rad is None:
        return None
    t = prime_factors(n).count(2)
    k, rem = divmod(t, 4)
    if rem == 1:
        if k == 0:
            return rad
        k, tail = k - 1, [8, 4]
    else:
        tail = {0: [], 2: [4], 3: [8]}[rem]
    p2 = [16] * k + tail
    old = [r for r in rad if r in (2, 4, 8)]
    if len(p2) >= len(old):
        return rad
    return tuple(p2) + tuple(r for r in rad if r not in (2, 4, 8))


@functools.lru_cache(maxsize=1024)
def stage_tables(n: int, inverse: bool, scale: float = 1.0,
                 walk: bool = False):
    """(plan ints, complex128 table) for length n.  Per stage the (r, Mp)
    twiddle block w_M^(i*m), with ``scale`` folded into stage 0 (the
    reference's stageNormalization, ``vkFFT_RadixShuffle.h:49-65``), and for
    radices without a butterfly of their own the roots w_r^k.  Computed in
    fp64 like ``_v3_tables_impl``; the kernels read it cast to fp32.
    ``walk``: the stages of `walk_radices` (radix 16, which carries its
    roots too).  n = 1 is the empty plan of a trivial factor of
    `fft_twofactor`."""
    if n == 1:
        return tuple([1, 0, int(inverse)] + [0] * _MAX_STAGES
                     + [0] * _MAX_STAGES + [-1] * _MAX_STAGES), \
            np.full(1, scale, np.complex128)
    radices = (walk_radices if walk else stage_radices)(n)
    if radices is None:
        raise _unsupported(n)
    sign = 2.0j if inverse else -2.0j
    parts, tw_off, dft_off = [], [], []
    off, M = 0, n
    for s, r in enumerate(radices):
        Mp = M // r
        tw = np.exp(sign * np.pi / M
                    * (np.outer(np.arange(r), np.arange(Mp)) % M))
        if s == 0:
            tw = tw * scale
        tw_off.append(off)
        parts.append(tw.ravel())
        off += r * Mp
        if r in _BUTTERFLY_RADICES:
            dft_off.append(-1)
        else:
            dft_off.append(off)
            parts.append(np.exp(sign * np.pi / r * np.arange(r)))
            off += r
        M = Mp
    pad = [0] * (_MAX_STAGES - len(radices))
    ints = ([n, len(radices), int(inverse)] + list(radices) + pad
            + tw_off + pad + dft_off + [-1] * len(pad))
    return tuple(ints), np.concatenate(parts)


@functools.lru_cache(maxsize=256)
def twofactor_twiddle(n: int, inverse: bool, scale: float = 1.0):
    """`fft_twofactor`'s inter-factor twiddle w_n^(k2*j1) (w_n^(-k2*j1) for
    the inverse) at [k2*n1 + j1], times ``scale`` (the JAX package folds
    the scale into the same twiddle, ``_v2_tables``), complex128: the
    whole table that the kernels' two tables (`twofactor_twiddle_pair`)
    stand for."""
    n1, n2 = twofactor_split(n)
    k2 = np.arange(n2, dtype=np.int64)[:, None]
    j1 = np.arange(n1, dtype=np.int64)[None, :]
    sign = 2.0j if inverse else -2.0j
    return (np.exp(sign * np.pi / n * ((k2 * j1) % n)) * scale).ravel()


@functools.lru_cache(maxsize=256)
def twofactor_twiddle_pair(n: int, inverse: bool, scale: float = 1.0):
    """`fft_twofactor`'s inter-factor twiddle (and, at n = m and no scale,
    `fft_conv_pair`'s four-step twiddle w_m^(kc*js)) as two tables, complex128:
    w_n^b for b < 64, then scale * w_n^(64 a) for a < ceil(n / 64) (w_n^(-e)
    for the inverse); the kernel takes w_n^e * scale = hi[e >> 6] *
    lo[e & 63] for the exponent e = k2 * j1 < n."""
    sign = 2.0j if inverse else -2.0j
    lo = np.exp(sign * np.pi / n * np.arange(TWOFACTOR_TW_LO))
    a = np.arange(-(-n // TWOFACTOR_TW_LO), dtype=np.int64)
    hi = np.exp(sign * np.pi / n * ((TWOFACTOR_TW_LO * a) % n)) * scale
    return np.concatenate([lo, hi])


def _table_points(n: int, walk: bool = False) -> int:
    """Points of a factor's stage table that a walk kernel copies into
    shared memory (none for the empty plan of a length-1 factor)."""
    return 0 if n == 1 else len(stage_tables(n, False, 1.0, walk)[1])


def generic_groups(r: int) -> int:
    """Items of a generic radix-r stage a butterfly (``generic_groups`` in
    ``csrc/inplace.cuh``): its (r + 1) / 2 output pairs, WALK_GENERIC_PAIRS
    an item."""
    return -(-(r // 2 + 1) // WALK_GENERIC_PAIRS)


def walk_rounds_fit(n: int, threads: int, walk: bool = False,
                    items: int = WALK_GENERIC_ITEMS) -> bool:
    """Whether ``threads`` hold a whole sequence of every stage of an
    n-point Stockham run (of `walk_radices` with ``walk``) in one round of
    the in-place walk (``rounds_fit`` in ``csrc/inplace.cuh``: a thread
    holds max(1, 12 // r) butterflies of a fixed radix r, ``items`` items
    of a generic one (WALK_GENERIC_ITEMS; the fp64 walk's
    WALK_GENERIC_ITEMS_F64), `generic_groups` a butterfly); the empty run
    of n = 1 always fits."""
    if n == 1:
        return True
    for r in (walk_radices if walk else stage_radices)(n):
        if r in _WALK_FIXED_RADICES:
            if max(1, WALK_POINTS // r) * threads < n // r:
                return False
        elif items * threads < n // r * generic_groups(r):
            return False
    return True


def _block_threads(points: int, aim: int = TWOFACTOR_AIM_POINTS) -> int:
    """Threads of a walk block of ``points`` points: a multiple of 32 near
    one thread for ``aim`` of them, at most 512."""
    want = -(-points // aim)
    return min(TWOFACTOR_THREADS, max(32, -(-want // 32) * 32))


# `fft_lines`' block (csrc/fft_lines.cu): lines shorter than
# LINES_BLOCK_POINTS share a block up to that many points, a thread for
# about LINES_ONE_PASS_AIM of them in one pass (where a block holds
# LINES_ONE_PASS_LINES lines or more) or LINES_AIM_POINTS in two factors:
# small blocks, many to an SM, so more of each SM's data is in flight
# (chip_smoke.py's layout sweep, PERF.md).
LINES_BLOCK_POINTS = 4096
LINES_ONE_PASS_LINES = 8
LINES_ONE_PASS_AIM = 16
LINES_AIM_POINTS = 32


def _lines_block(n: int, one_pass: bool) -> tuple[int, int]:
    """(threads, lines) of an `fft_lines` block for length n."""
    lines = max(1, LINES_BLOCK_POINTS // n)
    aim = LINES_ONE_PASS_AIM if one_pass else LINES_AIM_POINTS
    return _block_threads(lines * n, aim), lines


def lines_split(n: int,
                dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(n1, n2) of `fft_lines` for length n: (n, 1), one pass of n-point
    stages, where a block holds LINES_ONE_PASS_LINES lines or more (n <=
    512) and every stage's sequences fit one round of its threads
    (`walk_rounds_fit`), else two factors (`_lines_factors`).  A round
    holds whole sequences, and a line's last stage is one sequence of n /
    r butterflies; in one pass, a block of few lines reads its late stages
    at a stride of r points (bank conflicts: 4096 took 0.219 ms so, 0.141
    as 256 x 16; 1024 0.149 and 0.133 as 64 x 16).  At float64 the fp64
    walk's rounds (`_walk_of`)."""
    pbytes = point_bytes(dtype)
    threads, lines = _lines_block(n, True)
    if lines >= LINES_ONE_PASS_LINES and walk_rounds_fit(
            n, threads, *_walk_of(pbytes)):
        return n, 1
    return _lines_factors(n, pbytes)


@functools.lru_cache(maxsize=4096)
def _lines_factors(n: int, pbytes: int = 8) -> tuple[int, int]:
    """The two factors n1 >= n2 > 1 of a lone `fft_lines` line
    (`_two_factors` at its threads); else `twofactor_split` (a prime n:
    (n, 1))."""
    return (_two_factors(n, _block_threads(n, LINES_AIM_POINTS), pbytes)
            or twofactor_split(n))


def lines_layout(n: int,
                 dtype: torch.dtype = torch.float32) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_lines` block for length
    n, the one layout rule (the C entry refuses any other): ``lines`` =
    max(1, LINES_BLOCK_POINTS // n) lines a block, a multiple of 32
    threads near one for LINES_ONE_PASS_AIM points (one pass) or
    LINES_AIM_POINTS (two factors), at most 512 (at most 256 come of it,
    the fp64 kernel's cap), and the split of `lines_split`, each line once
    as the (n2, n1) matrix at the odd pitch n1 | 1, beside both factors'
    stage tables (`walk_radices`; the fp64 walk's `stage_radices`) and the
    twiddle's two tables, `point_bytes` of ``dtype`` a point."""
    pbytes = point_bytes(dtype)
    walk = _walk_of(pbytes)[0]
    n1, n2 = lines_split(n, dtype)
    threads, lines = _lines_block(n, n2 == 1)
    points = (lines * n2 * (n1 | 1) + _table_points(n1, walk)
              + _table_points(n2, walk)
              + TWOFACTOR_TW_LO + -(-n // TWOFACTOR_TW_LO))
    return threads, lines, pbytes * points


# `fft_conv`'s block (csrc/fft_conv.cu, `conv_layout`): `fft_lines`' rule
# on the m-point lines a convolution runs (Bluestein: the padded length),
# with constants of its own: lines share a block up to CONV_BLOCK_POINTS
# points, in the matrix mode whole items of mm lines; a thread for about
# CONV_ONE_PASS_AIM of them in one pass (where a block holds
# CONV_ONE_PASS_LINES lines or more and every stage's sequences fit a
# round), else CONV_AIM_POINTS in `fft_lines`' two factors of a lone
# line.  8192 points a block beat 2048 and 4096 at 4096 x 4096, 5461 x 3
# x 1024 and 32768 x 512 and tied at Rader's 1676 x 5002 (chip_smoke.py's
# layout sweep, PERF.md).
CONV_BLOCK_POINTS = 8192
CONV_ONE_PASS_LINES = 8
CONV_ONE_PASS_AIM = 16
CONV_AIM_POINTS = 32


def _conv_block(m: int, mm: int, one_pass: bool) -> tuple[int, int]:
    """(threads, lines) of an `fft_conv` block of m-point lines, mm lines
    an item."""
    lines = mm * max(1, CONV_BLOCK_POINTS // (mm * m))
    aim = CONV_ONE_PASS_AIM if one_pass else CONV_AIM_POINTS
    return _block_threads(lines * m, aim), lines


def conv_split(m: int, mm: int = 1) -> tuple[int, int]:
    """(n1, n2) of `fft_conv`'s m-point lines, mm lines an item: (m, 1),
    one pass, where a block holds CONV_ONE_PASS_LINES lines or more and
    every stage's sequences fit a round of its threads, else `fft_lines`'
    two factors of a lone line (which fit the block's threads, as many or
    more)."""
    threads, lines = _conv_block(m, mm, True)
    if lines >= CONV_ONE_PASS_LINES and walk_rounds_fit(m, threads, True):
        return m, 1
    return _lines_factors(m)


def conv_layout(m: int, mm: int = 1) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_conv` block for m-point
    lines, mm lines an item (the matrix mode's coordinates; 1 in the
    scalar, rows and Bluestein modes), the one layout rule (the C entry
    refuses any other): ``lines`` = mm * max(1, CONV_BLOCK_POINTS // (mm *
    m)), a multiple of 32 threads near one for CONV_ONE_PASS_AIM points
    (one pass) or CONV_AIM_POINTS (two factors), at most 512, the split of
    `conv_split`, each line once as the (n2, n1) matrix at the odd pitch
    n1 | 1, beside the forward and the inverse stage tables of both factors
    (`walk_radices`) and the forward and the inverse twiddle's two
    tables."""
    n1, n2 = conv_split(m, mm)
    threads, lines = _conv_block(m, mm, n2 == 1)
    points = (lines * n2 * (n1 | 1)
              + 2 * (_table_points(n1, True) + _table_points(n2, True)
                     + TWOFACTOR_TW_LO + -(-m // TWOFACTOR_TW_LO)))
    return threads, lines, 8 * points


def conv_occupancy(m: int, mm: int = 1,
                   dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks an SM of `fft_conv` at the layout of m-point lines,
    mm lines an item, on planes of ``dtype``, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current card
    (C entry ``vk_fft_conv_occupancy``, ``vk_fft_conv_f16_occupancy``,
    ...)."""
    return _occupancy("fft_conv", *conv_layout(m, mm)[::2],
                      entry=f"fft_conv{_SUFFIX[dtype]}_occupancy")


# `fft_r2c`'s block (csrc/fft_r2c.cu): its m = n/2-point lines share a
# block up to R2C_BLOCK_POINTS points, a thread for about R2C_AIM_POINTS of
# them; one pass where a block holds R2C_ONE_PASS_LINES lines or more,
# else `fft_lines`' two factors of m.  Its own constants, not `fft_lines`':
# at n = 1024 four 512-point lines a block in one pass beat eight, and
# two factors (chip_smoke.py's layout sweep, PERF.md).
R2C_BLOCK_POINTS = 2048
R2C_ONE_PASS_LINES = 4
R2C_AIM_POINTS = 16


@functools.lru_cache(maxsize=4096)
def _walk_split(points: int, block_points: int, one_pass_lines: int,
                aim: int) -> tuple[int, int]:
    """(n1, n2) of a walk block of ``points``-point lines (`fft_r2c`'s,
    `fft_dct23`'s and `fft_dct4`'s): (points, 1), one pass, where a block
    of max(1, block_points // points) lines holds ``one_pass_lines`` or
    more and every stage's sequences fit a round of its threads (one for
    ``aim`` points), else `fft_lines`' two factors of a lone line (which
    fit the block's threads, as many or more)."""
    lines = max(1, block_points // points)
    threads = _block_threads(lines * points, aim)
    if lines >= one_pass_lines and walk_rounds_fit(points, threads, True):
        return points, 1
    return _lines_factors(points)


@functools.lru_cache(maxsize=4096)
def _walk_layout(points: int, split: tuple, block_points: int, aim: int,
                 twiddle_points: int) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of that block: max(1, block_points
    // points) lines, a multiple of 32 threads near one for ``aim`` points,
    at most 512, each line once as the (n2, n1) matrix at the odd pitch n1
    | 1, beside both factors' stage tables (`walk_radices`) and
    ``twiddle_points`` more."""
    n1, n2 = split
    lines = max(1, block_points // points)
    smem = 8 * (lines * n2 * (n1 | 1) + _table_points(n1, True)
                + _table_points(n2, True) + twiddle_points)
    return _block_threads(lines * points, aim), lines, smem


def r2c_split(n: int) -> tuple[int, int]:
    """(n1, n2) of the m = n/2-point complex DFT inside `fft_r2c` /
    `fft_c2r` for even length n: `_walk_split` with R2C_BLOCK_POINTS,
    R2C_ONE_PASS_LINES and R2C_AIM_POINTS."""
    return _walk_split(n // 2, R2C_BLOCK_POINTS, R2C_ONE_PASS_LINES,
                       R2C_AIM_POINTS)


@functools.lru_cache(maxsize=1024)
def r2c_twiddle(n: int, inverse: bool) -> np.ndarray:
    """The twiddles of `fft_r2c` (`fft_c2r` with ``inverse``) for even
    length n, complex128: the m = n/2-point inter-factor twiddle's two
    tables (`twofactor_twiddle_pair`, no scale: the inverse's rides its
    untangle), then the untangle's w_n^k = e^{-2 pi i k / n}, k <= m/2, as
    two tables: w_n^b for b < 64, then w_n^(64 a) for a <= m // 128 (the
    inverse conjugates them in the kernel)."""
    m = n // 2
    lo = np.exp(-2j * np.pi / n * np.arange(TWOFACTOR_TW_LO))
    hi = np.exp(-2j * np.pi / n * TWOFACTOR_TW_LO
                * np.arange((m // 2) // TWOFACTOR_TW_LO + 1))
    return np.concatenate([twofactor_twiddle_pair(m, inverse), lo, hi])


def r2c_layout(n: int) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_r2c` / `fft_c2r` block for
    even length n, the one layout rule (the C entry refuses any other):
    `_walk_layout` of m = n/2-point lines, up to R2C_BLOCK_POINTS points a
    block, a thread for about R2C_AIM_POINTS, the split of `r2c_split`
    and the twiddles of `r2c_twiddle`."""
    return _walk_layout(n // 2, r2c_split(n), R2C_BLOCK_POINTS,
                        R2C_AIM_POINTS, len(r2c_twiddle(n, False)))


def r2c_occupancy(n: int, inverse: bool = False) -> int:
    """Resident blocks an SM of `fft_r2c` (`fft_c2r` with ``inverse``) at
    the layout of length n, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current card
    (C entry ``vk_fft_r2c_occupancy``)."""
    threads, _, smem = r2c_layout(n)
    return _flag_occupancy("fft_r2c", "fft_r2c", int(inverse), threads, smem)


# `fft_dct23` and `fft_dct4` (csrc/fft_dct23.cu, csrc/fft_dct4.cu) on the
# points of their complex pipelines (n points carrying two real lines for
# DCT-II/III and odd DCT-IV, n/2 for even DCT-IV): pipelines share a block
# up to a block's points, a thread for about its aim of them, one pass
# where a block holds enough pipelines, else `fft_lines`' two factors.
# `fft_dct4` takes `fft_r2c`'s block (R2C_*); `fft_dct23` its own, the
# best of chip_smoke.py's layout sweep at n = 96 / 1024 / 255 and within
# 1.4 % of it at 256 (PERF.md, PR 14 run 7): 4096 points a block, 32 a
# thread, one pass from 8 pipelines a block.
DCT23_BLOCK_POINTS = 4096
DCT23_ONE_PASS_LINES = 8
DCT23_AIM_POINTS = 32


def dct_split(points: int, type4: bool = False) -> tuple[int, int]:
    """(n1, n2) of the complex pipeline of ``points`` points inside
    `fft_dct23` (`fft_dct4` with ``type4``): (points, 1), one pass, where a
    block holds DCT23_ONE_PASS_LINES (R2C_ONE_PASS_LINES) pipelines or
    more and every stage's sequences fit a round of its threads, else
    `fft_lines`' two factors of a lone pipeline (which fit the block's
    threads, as many or more)."""
    if type4:
        return _walk_split(points, R2C_BLOCK_POINTS, R2C_ONE_PASS_LINES,
                           R2C_AIM_POINTS)
    return _walk_split(points, DCT23_BLOCK_POINTS, DCT23_ONE_PASS_LINES,
                       DCT23_AIM_POINTS)


def _rotation_table(N: int, count: int, sign: int = -1, shift: float = 0.0,
                    scale: float = 1.0) -> np.ndarray:
    """value(e) = scale * w^(e + shift), w = e^(sign 2 pi i / N), for e <
    count as the walk's two tables, complex128: w^b for b < 64, then scale
    * w^(64 a + shift) for a < ceil(count / 64) (``root`` in
    ``csrc/real_walk.cuh``)."""
    w = sign * 2j * np.pi / N
    lo = np.exp(w * np.arange(TWOFACTOR_TW_LO))
    a = np.arange(-(-count // TWOFACTOR_TW_LO), dtype=np.float64)
    return np.concatenate([lo, scale * np.exp(w * (TWOFACTOR_TW_LO * a
                                                   + shift))])


def _rotation_points(count: int) -> int:
    return TWOFACTOR_TW_LO + -(-count // TWOFACTOR_TW_LO)


@functools.lru_cache(maxsize=256)
def dct23_twiddle(n: int, type3: bool, scale: float = 1.0) -> np.ndarray:
    """The twiddles of `fft_dct2` (`fft_dct3` with ``type3``) at length n,
    complex128: the n-point inter-factor twiddle's two tables
    (`twofactor_twiddle_pair`, inverse for type III, no scale), then the
    rotation table of rot[k] = scale e^{-i pi k/2n} (type III: e^{+i pi
    k/2n}), k < n (`_rotation_table`)."""
    return np.concatenate([twofactor_twiddle_pair(n, type3),
                           _rotation_table(4 * n, n, 1 if type3 else -1,
                                           scale=scale)])


@functools.lru_cache(maxsize=256)
def dct4_twiddle(n: int, scale: float = 1.0) -> np.ndarray:
    """The twiddles of `fft_dct4` at length n, complex128: the pipeline's
    inter-factor twiddle's two tables (`twofactor_twiddle_pair` of
    `dct4_points`, no scale), then for even n two rotation tables
    (`_rotation_table`), pre[j] = e^{-i pi (4j+1)/4n}, j < n/2, and post[k]
    = 2 scale e^{-i pi k/n}, k <= n/2; for odd n the one point sqrt(2)
    scale / 2, the factor of every output of its real DFT's
    post-processing (``csrc/fft_dct4.cu``)."""
    pair = twofactor_twiddle_pair(dct4_points(n), False)
    if n % 2:
        return np.concatenate([pair, [np.sqrt(2.0) * scale / 2]])
    m = n // 2
    return np.concatenate([pair, _rotation_table(2 * n, m, shift=0.25),
                           _rotation_table(2 * n, m + 1, scale=2.0 * scale)])


def dct_twiddle_points(n: int, type4: bool) -> int:
    """Points of `dct23_twiddle` (`dct4_twiddle` with ``type4``) at length
    n, as the C entries count them."""
    if not type4:
        return 2 * _rotation_points(n)
    if n % 2:
        return _rotation_points(n) + 1
    m = n // 2
    return (_rotation_points(m) + _rotation_points(m)
            + _rotation_points(m + 1))


def dct23_layout(n: int) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_dct23` block for length
    n, the one layout rule (the C entry refuses any other): ``lines`` =
    max(1, DCT23_BLOCK_POINTS // n) pipelines of n points a block, each two
    real lines, a multiple of 32 threads near one for DCT23_AIM_POINTS
    points, at most 512, the split of `dct_split`, each pipeline once as
    the (n2, n1) matrix at the odd pitch n1 | 1, beside both factors'
    stage tables (`walk_radices`) and the twiddles of `dct23_twiddle`."""
    return _walk_layout(n, dct_split(n), DCT23_BLOCK_POINTS,
                        DCT23_AIM_POINTS, dct_twiddle_points(n, False))


@functools.lru_cache(maxsize=256)
def dct1_twiddle(n: int, dst: bool, scale: float = 1.0) -> np.ndarray:
    """The twiddles of `fft_dct1` at length n, complex128: the M-point
    inter-factor twiddle's two tables (`twofactor_twiddle_pair`, M =
    `dct1_length`, the scale in them), then the untangle's w_2M^k, k <=
    M/2, as `r2c_twiddle`'s two tables."""
    M = dct1_length(n, dst)
    return np.concatenate([twofactor_twiddle_pair(M, False, scale),
                           r2c_twiddle(2 * M, False)[_rotation_points(M):]])


def dct1_layout(n: int, dst: bool) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_dct1` block for length n,
    the one layout rule (the C entry refuses any other): `fft_r2c`'s
    block (R2C_BLOCK_POINTS, R2C_AIM_POINTS, `dct_split`'s rule with
    R2C_ONE_PASS_LINES) on the M = `dct1_length` complex points of a
    line's extension, beside the twiddles of `dct1_twiddle` (`fft_dct23`'s
    block, the best of chip_smoke.py's sweep at DCT-I 1025, ran DST-I 1023
    slower: PERF.md §6)."""
    M = dct1_length(n, dst)
    return _walk_layout(M, dct_split(M, True), R2C_BLOCK_POINTS,
                        R2C_AIM_POINTS, len(dct1_twiddle(n, dst)))


def dct1_occupancy(n: int, dst: bool) -> int:
    """Resident blocks an SM of `fft_dct1` at the layout of length n (C
    entry ``vk_fft_dct1_occupancy``)."""
    threads, _, smem = dct1_layout(n, dst)
    return _occupancy("fft_dct1", threads, smem)


def dct4_layout(n: int) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_dct4` block for length n:
    `dct23_layout`'s rule with R2C_BLOCK_POINTS and R2C_AIM_POINTS on the
    `dct4_points` of its pipeline (``lines`` pipelines of a line each, or
    of two for odd n) and the twiddles of `dct4_twiddle`."""
    points = dct4_points(n)
    return _walk_layout(points, dct_split(points, True), R2C_BLOCK_POINTS,
                        R2C_AIM_POINTS, dct_twiddle_points(n, True))


def _flag_occupancy(name: str, entry: str, flag: int, threads: int,
                    smem: int) -> int:
    fn = getattr(_library(name), f"vk_{entry}_occupancy")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(flag, threads, smem, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"vk_{entry}_occupancy({flag}, {threads}, "
                           f"{smem}) failed: CUDA error {err}")
    return blocks.value


def dct23_occupancy(n: int, type3: bool = False) -> int:
    """Resident blocks an SM of `fft_dct2` (`fft_dct3` with ``type3``) at
    the layout of length n, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current card
    (C entry ``vk_fft_dct23_occupancy``)."""
    threads, _, smem = dct23_layout(n)
    return _flag_occupancy("fft_dct23", "fft_dct23", int(type3), threads,
                           smem)


def dct4_occupancy(n: int) -> int:
    """Resident blocks an SM of `fft_dct4` at the layout of length n (the
    odd kernel for odd n; C entry ``vk_fft_dct4_occupancy``)."""
    threads, _, smem = dct4_layout(n)
    return _flag_occupancy("fft_dct4", "fft_dct4", n % 2, threads, smem)


def lines_occupancy(n: int, dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks an SM of `fft_lines` at the layout of length n of
    ``dtype``, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on
    the current card (C entry ``vk_fft_lines_occupancy``,
    ``vk_fft_lines_f64_occupancy``)."""
    return _occupancy("fft_lines", *lines_layout(n, dtype)[::2],
                      entry=f"fft_lines{_SUFFIX[dtype]}_occupancy")


def _occupancy(name: str, threads: int, smem: int,
               entry: Optional[str] = None) -> int:
    entry = entry or f"{name}_occupancy"
    fn = getattr(_library(name), f"vk_{entry}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(threads, smem, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"vk_{entry}({threads}, {smem}) "
                           f"failed: CUDA error {err}")
    return blocks.value


@functools.lru_cache(maxsize=4096)
def twofactor_layout(n: int, split: Optional[tuple] = None
                     ) -> tuple[int, int, int]:
    """(threads, lines, shared bytes) of an `fft_twofactor` block for
    length n at ``split`` (default `twofactor_split`), the one layout rule
    (the C entry refuses any other).  A block holds ``lines`` = max(1,
    2048 // n) lines, each once as the (n2, n1) matrix with an odd row
    pitch n1 | 1 in float2, beside both factors' stage tables and the
    twiddle's two tables; ``threads`` is a multiple of 32 near one thread
    for 8 points, at most 512."""
    n1, n2 = split or twofactor_split(n)
    lines = max(1, TWOFACTOR_BLOCK_POINTS // n)
    points = (lines * n2 * (n1 | 1) + _table_points(n1) + _table_points(n2)
              + TWOFACTOR_TW_LO + -(-n // TWOFACTOR_TW_LO))
    return _block_threads(lines * n), lines, 8 * points


def conv_inv_occupancy(n: int, dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks an SM of `fft_conv_inv` at `twofactor_layout`'s
    layout of length n on planes of ``dtype`` (C entry
    ``vk_fft_conv_inv_occupancy``, ``vk_fft_conv_inv_f16_occupancy``,
    ...)."""
    return _occupancy("fft_conv_inv", *twofactor_layout(n)[::2],
                      entry=f"fft_conv_inv{_SUFFIX[dtype]}_occupancy")


def twofactor_occupancy(n: int, dtype: torch.dtype = torch.float32) -> int:
    """Resident blocks an SM of `fft_twofactor` at the layout of length n
    of ``dtype``, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on
    the current card (C entry ``vk_fft_twofactor_occupancy``,
    ``vk_fft_twofactor_f16_occupancy``, ...)."""
    return _occupancy("fft_twofactor", *twofactor_layout(n)[::2],
                      entry=f"fft_twofactor{_SUFFIX[dtype]}_occupancy")


# Device copies of the tables, per (what, parameters..., device).
_DEVICE_TABLES: dict = {}


def device_array(key: tuple, device: torch.device, build,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Cached (L, 2) device copy of the complex128 table ``build()`` in
    ``dtype``: interleaved (re, im) pairs, read by the kernels as float2
    (as double2 at float64)."""
    if dtype != torch.float32:
        key = key + (str(dtype),)
    key = key + (str(device),)
    tab = _DEVICE_TABLES.get(key)
    if tab is None:
        t = np.asarray(build(), np.complex128).ravel()
        host = np.stack([t.real, t.imag], axis=-1)
        tab = torch.from_numpy(host).to(device, dtype)
        _DEVICE_TABLES[key] = tab
    return tab


def _device_table(n: int, inverse: bool, scale: float,
                  device: torch.device, walk: bool = False,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return device_array(("stages", n, inverse, scale, walk), device,
                        lambda: stage_tables(n, inverse, scale, walk)[1],
                        dtype)


def swapped_order(spec):
    """A natural-order spectrum of length n (a numpy array or a tensor) in
    `fft_twofactor`'s swapped order, as an (n2, n1) view: position k2*n1 +
    k1 holds bin k1*n2 + k2 (the JAX package's ``tab_sw = table.reshape(n1,
    n2).T``, ``pallas_engine.py:4548``)."""
    n1, n2 = twofactor_split(len(spec))
    return spec.reshape(n1, n2).T


def _pair_order(spec: np.ndarray) -> np.ndarray:
    """A natural-order spectrum of length m in `fft_conv_pair`'s plane
    order: position kc*ns + ks holds bin ks*nc + kc."""
    nc, ns, _ = conv_pair_plan(len(spec))
    return spec.reshape(ns, nc).T


_LAYOUTS = {"natural": lambda s: s, "swapped": swapped_order,
            "pair": _pair_order,
            "long": lambda s: long_order(s, bluestein_long_split(len(s))),
            "long_swapped": lambda s: long_order(s, long_split(len(s)))}


def rader_spectrum(p: int, scale: float, device,
                   layout: str = "natural") -> torch.Tensor:
    """Device table of Rader's convolution spectrum for prime p:
    FFT_{p-1}(w_p^(g^-q)) * scale / (p-1) (``luts.rader_tables``; the JAX
    package's table, ``pallas_engine.py:700,721``), in ``layout``:
    "natural" for `fft_conv`, "swapped" for `fft_conv_inv`."""
    return device_array(
        ("rader", p, scale, layout), torch.device(device),
        lambda: _LAYOUTS[layout](luts.rader_tables(p)[2] * (scale / (p - 1))))


def bluestein_spectrum(n: int, m: int, inverse: bool, scale: float, device,
                       layout: str = "natural") -> torch.Tensor:
    """Device table of Bluestein's convolution spectrum FFT_m(b) * scale/m
    (``luts.bluestein_chirp``; ``pallas_engine.py:4865``) in ``layout``:
    "natural" for `fft_conv`, "swapped" for `fft_conv_inv`, "pair" for
    `fft_conv_pair`, "long" for `fft_conv`'s rows mode in the fused long
    Bluestein (row kc of `bluestein_long_split`'s (nc, ns)), "long_swapped"
    for the long tier's swapped order of `long_split`."""
    return device_array(
        ("bluestein", n, m, inverse, scale, layout), torch.device(device),
        lambda: _LAYOUTS[layout](luts.bluestein_chirp(n, m, inverse)[1]
                                 * (scale / m)))


def bluestein_chirp(n: int, m: int, inverse: bool, device) -> torch.Tensor:
    """Device table of the chirp a[k] = exp(-+i pi k^2 / n), k < n, that
    `fft_conv` and `fft_conv_pair` multiply on the read and the write."""
    return device_array(("chirp", n, m, inverse), torch.device(device),
                         lambda: luts.bluestein_chirp(n, m, inverse)[0])


# ---------------------------------------------------------------------------
# Plain versions: the same functions through the plain engine, which plans
# and tables its own stages (`torch_engine`), so they share nothing with
# the kernels but the definition of the DFT.
# ---------------------------------------------------------------------------

def _storage_plain(plain):
    """A plain version that takes float16 / bfloat16 planes as its kernel's
    half-storage instantiation does: widened to fp32, computed, narrowed
    once (round to nearest even)."""
    @functools.wraps(plain)
    def run(re, im, *args, **kw):
        if re.dtype not in STORAGE_DTYPES:
            return plain(re, im, *args, **kw)
        yr, yi = plain(re.float(), im.float(), *args, **kw)
        return yr.to(re.dtype), yi.to(re.dtype)
    return run


# ---------------------------------------------------------------------------
# Zero-pad windows (the reference's vkFFT_Zeropad.h; ``pallas_engine.py``'s
# in_nonzero / in_window / out_keep / out_fill / out_zero_window of
# _fft_kernel_v3, in_nonzero / out_keep of _fft_kernel_v2, the corner
# keeps of _pair_kernel and the row keeps of _strided_kernel_v3 and
# _outer_kernel).  A window's function is its plain version's: the
# declared-zero input is never read and counts as zero, a cropped output
# has the kept length, a filled output holds exact zeros.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LineWindow:
    """The windows of a lines pass of n points: the input's points t <
    ``length`` outside ``zero`` = [z0, z1) are read (the rest declared zero);
    the output is ``out`` points a line, with zeros written over ``fill`` =
    [o0, o1)."""
    n: int
    length: int
    zero: tuple
    out: int
    fill: tuple

    def __post_init__(self):
        n, (z0, z1), (f0, f1) = self.n, self.zero, self.fill
        if not (0 < self.length <= n and 0 < self.out <= n
                and ((z0, z1) == (0, 0) or 0 < z0 < z1 < n)
                and ((f0, f1) == (0, 0) or 0 < f0 < f1 <= n)):
            raise ValueError(f"{self}: reads 0 < length <= n, writes 0 < out "
                             "<= n, zero 0 < z0 < z1 < n, fill 0 < f0 < f1 "
                             "<= n, (0, 0) for none (line_window)")


def _check_keep(keep: int, n: int, what: str) -> int:
    keep = int(keep or 0)
    if keep and not 0 < keep < n:
        raise ValueError(f"{what}: a kept prefix of {keep} points of {n} "
                         f"(0 < keep < {n}; 0 for none)")
    return keep


def _check_window(win, n: int, what: str) -> tuple:
    if win is None:
        return (0, 0)
    left, right = (int(v) for v in win)
    if not 0 < left < right < n:
        raise ValueError(f"{what}: an interior window ({left}, {right}) of "
                         f"{n} points (0 < left < right < {n})")
    return (left, right)


def line_window(n: int, in_keep: int = 0, out_keep: int = 0,
                out_fill: bool = False, in_window=None,
                out_zero_window=None,
                what: str = "fft_lines") -> Optional[LineWindow]:
    """The `LineWindow` of these options on lines of n points, None where
    there is none: ``in_keep`` (a kept prefix of the input; 0 none) or
    ``in_window`` (an interior declared-zero window of the input);
    ``out_keep`` (the output cropped to a kept prefix, or with
    ``out_fill`` written whole with zeros past it) or ``out_zero_window``
    (zeros written over an interior window).  Raises ValueError for a
    keep outside 0 < keep < n, a window outside 0 < left < right < n, or
    two options on one side."""
    ik = _check_keep(in_keep, n, what)
    ok = _check_keep(out_keep, n, what)
    iw = _check_window(in_window, n, what)
    ow = _check_window(out_zero_window, n, what)
    if ik and iw != (0, 0) or ok and ow != (0, 0):
        raise ValueError(f"{what}: a kept prefix and a window on one side")
    if out_fill and not ok:
        raise ValueError(f"{what}: out_fill needs out_keep")
    if not (ik or ok or iw != (0, 0) or ow != (0, 0)):
        return None
    fill = (ok, n) if out_fill else ow
    return LineWindow(n, ik or n, iw, ok if ok and not out_fill else n, fill)


def _window_lines_in(re, im, w: LineWindow) -> Planar:
    """The (B, n) lines a windowed kernel sees: the read points of the
    input's lines (..., L), zeros elsewhere (new planes)."""
    L = re.shape[-1]
    x = Planar(re.reshape(-1, L)[:, :w.length], im.reshape(-1, L)[:, :w.length])
    x = Planar(*(torch.nn.functional.pad(t, (0, w.n - w.length))
                 for t in (x.re, x.im)))
    if w.zero != (0, 0):
        t = torch.arange(w.n, device=re.device)
        keep = (t < w.zero[0]) | (t >= w.zero[1])
        x = Planar(torch.where(keep, x.re, 0.0), torch.where(keep, x.im, 0.0))
    return x


def _window_lines_out(y: Planar, w: LineWindow, lead: tuple):
    """The output of the windowed kernel from the whole lines' DFT: the
    kept prefix, zeros written over the fill range."""
    yr, yi = y.re[:, :w.out], y.im[:, :w.out]
    if w.fill != (0, 0):
        t = torch.arange(w.out, device=yr.device)
        keep = (t < w.fill[0]) | (t >= w.fill[1])
        yr, yi = torch.where(keep, yr, 0.0), torch.where(keep, yi, 0.0)
    return (yr.reshape(*lead, w.out).contiguous(),
            yi.reshape(*lead, w.out).contiguous())


@_storage_plain
def fft_lines_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                    scale: float = 1.0, window: Optional[LineWindow] = None,
                    tl: bool = False):
    """Plain torch version of `fft_lines`; with ``window``, of its
    windowed entry: the read points of the lines (..., L), zeros elsewhere,
    transformed, then cropped or filled (`LineWindow`); with ``tl``, of its
    tl entry: the forward's output and the inverse's input in the swapped
    digit order of `lines_split` (`tl_order`)."""
    if window is not None:
        y = torch_engine.lines_plain(_window_lines_in(re, im, window),
                                     plan_axis(window.n), inverse, scale)
        return _window_lines_out(y, window, re.shape[:-1])
    n = re.shape[1]
    x = Planar(re, im)
    if tl and inverse:
        x = tl_order(x, lines_split(n, re.dtype), natural=True)
    y = torch_engine.lines_plain(x, plan_axis(n), inverse, scale)
    if tl and not inverse:
        y = tl_order(y, lines_split(n, re.dtype))
    return y.re.contiguous(), y.im.contiguous()


def tl_order(x: Planar, split, natural: bool = False) -> Planar:
    """(B, n) lines of natural order in the swapped digit order of
    ``split`` = (n1, n2), bin k1 * n2 + k2 at k2 * n1 + k1 (`fft_lines`'
    and `fft_twofactor`'s forward with the order kept); with ``natural``
    the other way.  A split of one factor (n2 = 1) is the natural order."""
    n1, n2 = split
    if n2 == 1:
        return x
    return swap_digits(x, n2, n1) if natural else swap_digits(x, n1, n2)


def _factor_planes(f: Factor, P: int, n: int, S: int, device) -> Planar:
    """The values of factor ``f`` on (P, n, S) planes (broadcastable: P or
    1 leading), from its exponents in int64 and the angle in float64 torch
    ops, independently of the kernel's arithmetic."""
    row = torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    s = torch.arange(S, dtype=torch.int64, device=device)[None, None, :]
    if f.kind == "chirp":
        j = row * S + s
        e = (j * j) % f.N
    else:
        p = torch.arange(P if f.pm > 1 else 1, dtype=torch.int64,
                         device=device)[:, None, None]
        e = ((row * f.a + (p % f.pm) * f.b + s % f.sm) * (s // f.sd)) % f.N
    theta = e.to(torch.float64) * ((2.0 if f.inverse else -2.0) * np.pi / f.N)
    return Planar(torch.cos(theta).to(torch.float32),
                  torch.sin(theta).to(torch.float32))


def _interleave(t: torch.Tensor, d: int, undo: bool = False) -> torch.Tensor:
    """(P, n, S) planes p = b*d + q laid out row by row interleaved,
    (P/d, n, d, S) in memory (``csrc/fft_strided_tw.cu``); ``undo`` reads
    that layout back into (P, n, S) planes."""
    P, n, S = t.shape
    if d == 1:
        return t
    if undo:
        return t.reshape(P // d, n, d, S).transpose(1, 2).reshape(P, n, S)
    return t.reshape(P // d, d, n, S).transpose(1, 2).reshape(P, n, S)


@_storage_plain
def fft_strided_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                      scale: float = 1.0, pre: Optional[Factor] = None,
                      post: Optional[Factor] = None, plane=None,
                      out_len: Optional[int] = None, in_interleave: int = 1,
                      out_interleave: int = 1, in_transposed: bool = False,
                      out_transposed: bool = False,
                      window: Optional[tuple] = None, in_keep: int = 0):
    """Plain torch version of `fft_strided`; with ``window`` = (n, rows
    read, rows written), of its windowed entry: the first rows of the
    (P, R, ...) planes, zero rows to n, transformed, the first rows kept,
    (P, rows written, ...).  Else: the planes (with ``plane``,
    (P, L) lines zero-padded to the (n, S) plane, and with ``in_keep``
    their points past in_keep zero first, Bluestein's read window of
    `fft_strided_tw`'s windowed entry; with ``in_interleave``,
    read from the interleaved layout; with ``in_transposed``, (P, S, n)
    planes transposed) times the ``pre`` factor, the transform dim moved
    last, `fft_lines_plain`, moved back, times the ``post`` factor (with
    ``plane``, the first ``out_len`` points of each plane; with
    ``out_interleave``, laid out interleaved; with ``out_transposed``, as
    (P, S, n) planes)."""
    if window is not None:
        n, rows_in, rows_out = window
        P, tail = re.shape[0], re.shape[2:]
        x = [torch.nn.functional.pad(
            t.reshape(P, t.shape[1], -1)[:, :rows_in],
            (0, 0, 0, n - rows_in)) for t in (re, im)]
        yr, yi = fft_strided_plain(*x, inverse, scale)
        return (yr[:, :rows_out].reshape(P, rows_out, *tail).contiguous(),
                yi[:, :rows_out].reshape(P, rows_out, *tail).contiguous())
    if in_transposed:
        re, im = (t.transpose(1, 2) for t in (re, im))
    if plane is None:
        P, n, S = re.shape
        x = Planar(_interleave(re, in_interleave, True),
                   _interleave(im, in_interleave, True))
    else:
        n, S = plane
        P = re.shape[0]
        re, im = _keep_prefix(re, im, in_keep)
        x = Planar(*(torch.nn.functional.pad(t, (0, n * S - t.shape[1]))
                     .reshape(P, n, S) for t in (re, im)))
    if pre is not None:
        x = x * _factor_planes(pre, P, n, S, re.device)

    def lines(t):
        return t.permute(0, 2, 1).reshape(P * S, n)

    yr, yi = fft_lines_plain(lines(x.re), lines(x.im), inverse, scale)
    y = Planar(yr.reshape(P, S, n).permute(0, 2, 1),
               yi.reshape(P, S, n).permute(0, 2, 1))
    if post is not None:
        y = y * _factor_planes(post, P, n, S, re.device)
    if plane is not None:
        keep = n * S if out_len is None else out_len
        y = Planar(y.re.reshape(P, n * S)[:, :keep],
                   y.im.reshape(P, n * S)[:, :keep])
    else:
        y = Planar(_interleave(y.re, out_interleave),
                   _interleave(y.im, out_interleave))
    if out_transposed:
        y = Planar(y.re.transpose(1, 2), y.im.transpose(1, 2))
    return y.re.contiguous(), y.im.contiguous()


@_storage_plain
def fft_pair_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                   scale: float = 1.0, window: Optional[tuple] = None,
                   tl: bool = False):
    """Plain torch version of `fft_pair`: the z axis as lines, then the y
    axis as a strided pass with the scale.  With ``window`` = (ny, nz, ky,
    kz, oy, oz), of its windowed entry: the (ky, kz) corner of each plane
    (B, Ry, Rz), zeros to (ny, nz), transformed, the (oy, oz) corner kept.
    With ``tl``, of its tl entry: the forward writes, and the inverse
    reads, the transposed (B, nz, ny) planes of the spectrum."""
    if window is not None:
        ny, nz, ky, kz, oy, oz = window
        x = [torch.nn.functional.pad(t[:, :ky, :kz], (0, nz - kz, 0, ny - ky))
             for t in (re, im)]
        yr, yi = fft_pair_plain(*x, inverse, scale)
        return (yr[:, :oy, :oz].contiguous(), yi[:, :oy, :oz].contiguous())
    if tl:
        # the transposed (B, nz, ny) planes of the spectrum: the forward's
        # output, the inverse's input
        if inverse:
            re, im = (t.transpose(1, 2).contiguous() for t in (re, im))
        yr, yi = fft_pair_plain(re, im, inverse, scale)
        if inverse:
            return yr, yi
        return yr.transpose(1, 2).contiguous(), yi.transpose(1, 2).contiguous()
    B, ny, nz = re.shape
    zr, zi = fft_lines_plain(re.reshape(B * ny, nz), im.reshape(B * ny, nz),
                             inverse)
    return fft_strided_plain(zr.reshape(B, ny, nz), zi.reshape(B, ny, nz),
                             inverse, scale)


def fft_r2c_plain(x: torch.Tensor, packed: bool = False):
    """Plain torch version of `fft_r2c` (`torch_engine.rfft_lines_plain`)."""
    y = torch_engine.rfft_lines_plain(x, packed)
    return y.re, y.im


def fft_c2r_plain(re: torch.Tensor, im: torch.Tensor, n: int,
                  scale: float = 1.0, packed: bool = False) -> torch.Tensor:
    """Plain torch version of `fft_c2r`."""
    return torch_engine.irfft_lines_plain(Planar(re, im), n, scale, packed)


def fft_r2c_pair_plain(x: torch.Tensor):
    """Plain torch version of `fft_r2c_pair`."""
    y = torch_engine.rfft2_pair_plain(x)
    return y.re, y.im


def fft_c2r_pair_plain(re: torch.Tensor, im: torch.Tensor, nz: int,
                       scale_y: float = 1.0,
                       scale_z: float = 1.0) -> torch.Tensor:
    """Plain torch version of `fft_c2r_pair`."""
    return torch_engine.irfft2_pair_plain(Planar(re, im), nz, scale_y,
                                          scale_z)


def table_planar(tab: torch.Tensor) -> Planar:
    """An (L, 2) device table as a length-L Planar."""
    return Planar(tab[:, 0], tab[:, 1])


def swap_digits(x: Planar, rows: int, cols: int) -> Planar:
    """(B, rows*cols) viewed as [row][col] -> [col][row], contiguous."""
    B = x.shape[0]
    return Planar(*(t.reshape(B, rows, cols).transpose(1, 2).reshape(B, -1)
                    for t in (x.re, x.im)))


def _xpow_v3(y: Planar) -> Planar:
    """Y / |Y| in `fft_conv`'s form, Y * rsqrt(|Y|^2 + 1e-30)
    (``pallas_engine.py:4665``)."""
    return y * torch.rsqrt(y.re * y.re + y.im * y.im + 1e-30)


def _xpow_pair(y: Planar) -> Planar:
    """Y / |Y| in the 2-D mode's form, Y / max(|Y|, 1e-30)
    (``pallas_engine.py:2288``, as the JAX package's composition)."""
    return y * (1.0 / torch.clamp_min(torch.sqrt(y.re * y.re + y.im * y.im),
                                      1e-30))


def _by_line(tab: Planar, count: int, period: int) -> Planar:
    """Rows ``j % period`` of a (period, ...) table for j < count."""
    idx = torch.arange(count, device=tab.re.device) % period
    return Planar(tab.re[idx], tab.im[idx])


def _keep_prefix(re, im, in_keep: int):
    """(B, n) lines with the points past ``in_keep`` zero (new planes; 0
    keeps all): Bluestein's read window as a plain version sees it, the
    declared-zero tail never taking part, whatever it holds."""
    n = re.shape[-1]
    if not in_keep or in_keep >= n:
        return re, im
    return tuple(torch.nn.functional.pad(t[..., :in_keep], (0, n - in_keep))
                 for t in (re, im))


@_storage_plain
def fft_conv_plain(re: torch.Tensor, im: torch.Tensor,
                   spectrum: torch.Tensor, chirp: Optional[torch.Tensor] = None,
                   conj_data: bool = False, xpow: bool = False,
                   scale: float = 1.0, in_keep: int = 0):
    """Plain torch version of `fft_conv`: the inverse DFT, times ``scale``,
    of DFT(x) (conjugated with ``conj_data``) times the spectrum (over its
    rows, line j row j % rows; for (B, mm, n) planes mixed by the (mm, mm,
    n) matrix), divided by its modulus with ``xpow``; with ``chirp``, x * a
    zero-padded to m = len(spectrum) on the way in and the first n points
    times a on the way out (with ``in_keep``, of the windowed entry: the
    points past in_keep zero first)."""
    tab = table_planar(spectrum)
    if chirp is not None:
        m, n = spectrum.shape[0], re.shape[1]
        re, im = _keep_prefix(re, im, in_keep)
        a = table_planar(chirp)[None]
        x = Planar(re, im) * a
        x = Planar(*(torch.nn.functional.pad(t, (0, m - n))
                     for t in (x.re, x.im)))
        plan = plan_axis(m)
        X = torch_engine.lines_plain(x, plan) * tab[None]
        y = torch_engine.lines_plain(X, plan, True, scale)[:, :n] * a
        return y.re.contiguous(), y.im.contiguous()
    shape, n = re.shape, re.shape[-1]
    plan = plan_axis(n)
    X = torch_engine.lines_plain(Planar(re, im).reshape(-1, n), plan)
    X = X.reshape(*shape)
    if conj_data:
        X = X.conj()
    if re.ndim == 3:
        mm = shape[1]
        K = tab.reshape(mm, mm, n)

        def mix(k, x):
            return torch.einsum("oin,bin->bon", k, x)

        Y = Planar(mix(K.re, X.re) - mix(K.im, X.im),
                   mix(K.re, X.im) + mix(K.im, X.re))
    else:
        Y = X * _by_line(tab.reshape(-1, n), shape[0], tab.shape[0] // n)
    if xpow:
        Y = _xpow_v3(Y)
    y = torch_engine.lines_plain(Y.reshape(-1, n), plan, True, scale)
    return y.re.reshape(shape).contiguous(), y.im.reshape(shape).contiguous()


@_storage_plain
def fft_twofactor_plain(re: torch.Tensor, im: torch.Tensor, inverse: bool,
                        scale: float = 1.0, swapped: bool = False,
                        window: Optional[LineWindow] = None,
                        split: Optional[tuple] = None):
    """Plain torch version of `fft_twofactor`: the DFT of each line times
    ``scale``; with ``swapped`` the forward's output and the inverse's input
    are in the swapped digit order of ``split`` (default
    `twofactor_split`).  With ``window``, of its windowed entry (natural
    order), as `fft_lines_plain`'s."""
    if window is not None:
        y = torch_engine.lines_plain(_window_lines_in(re, im, window),
                                     plan_axis(window.n), inverse, scale)
        return _window_lines_out(y, window, re.shape[:-1])
    n = re.shape[1]
    n1, n2 = _check_split(n, split, "fft_twofactor")
    x = Planar(re, im)
    if inverse and swapped:
        x = swap_digits(x, n2, n1)
    y = torch_engine.lines_plain(x, plan_axis(n), inverse, scale)
    if swapped and not inverse:
        y = swap_digits(y, n1, n2)
    return y.re.contiguous(), y.im.contiguous()


@_storage_plain
def fft_conv_inv_plain(re: torch.Tensor, im: torch.Tensor,
                       spectrum: torch.Tensor, dc=None, scale: float = 1.0):
    """Plain torch version of `fft_conv_inv`: the spectrum (swapped order)
    times the table (swapped order), the inverse DFT to natural order times
    ``scale``, plus the per-line constant ``dc`` = (re, im) of shape
    (B,)."""
    n = re.shape[1]
    n1, n2 = twofactor_split(n)
    y = swap_digits(Planar(re, im) * table_planar(spectrum)[None], n2, n1)
    z = torch_engine.lines_plain(y, plan_axis(n), True, scale)
    if dc is not None:
        z = z + Planar(dc[0][:, None], dc[1][:, None])
    return z.re.contiguous(), z.im.contiguous()


@_storage_plain
def fft_conv_pair_plain(re: torch.Tensor, im: torch.Tensor,
                        spectrum: torch.Tensor,
                        chirp: Optional[torch.Tensor] = None,
                        conj_data: bool = False, xpow: bool = False,
                        scale: float = 1.0, window: Optional[tuple] = None,
                        in_keep: int = 0):
    """Plain torch version of `fft_conv_pair`.  With ``chirp`` (Bluestein
    mode): `fft_conv_plain` with the spectrum back in natural order (with
    ``in_keep``, of the windowed entry: the points past in_keep zero
    first).
    Without (2-D mode, (B, ny, nz) planes): the 2-D DFT of each plane
    (conjugated with ``conj_data``) times spectrum b % hp of the (hp, ny,
    nz) table, divided by its modulus with ``xpow``, and the inverse 2-D
    DFT times ``scale``.  With ``window`` = (ny, nz, ky, kz, oy, oz), of the
    2-D mode's windowed entry: the (ky, kz) corner of each plane (B, Ry,
    Rz), zeros to (ny, nz), convolved, the (oy, oz) corner kept."""
    if window is not None:
        ny, nz, ky, kz, oy, oz = window
        x = [torch.nn.functional.pad(t[:, :ky, :kz], (0, nz - kz, 0, ny - ky))
             for t in (re, im)]
        yr, yi = fft_conv_pair_plain(*x, spectrum, None, conj_data, xpow,
                                     scale)
        return (yr[:, :oy, :oz].contiguous(), yi[:, :oy, :oz].contiguous())
    if chirp is not None:
        m = spectrum.shape[0]
        nc, ns, _ = conv_pair_plan(m)
        natural = spectrum.reshape(nc, ns, 2).transpose(0, 1).reshape(m, 2)
        return fft_conv_plain(re, im, natural, chirp, in_keep=in_keep)
    B, ny, nz = re.shape
    X = Planar(*fft_pair_plain(re, im, False))
    if conj_data:
        X = X.conj()
    tab = table_planar(spectrum).reshape(-1, ny, nz)
    Y = X * _by_line(tab, B, tab.shape[0])
    if xpow:
        Y = _xpow_pair(Y)
    return fft_pair_plain(Y.re.contiguous(), Y.im.contiguous(), True, scale)


# The R2R kernels' plain versions compute the TPU kernels' own forms
# (``pallas_engine.py:2745-2880``, ``:2958-3050``, ``:3080-3150``): 2n-point
# zero-padded pipelines with rotations and correction terms, so they share
# no algorithm with the CUDA kernels, which permute and extend in shared
# memory.


def fft_dct23_plain(x: torch.Tensor, type3: bool, dst: bool = False,
                    scale: float = 1.0) -> torch.Tensor:
    """Plain torch version of `fft_dct23`.  Type II: H = rfft of x
    zero-padded to 2n, DCT2[k] = Re(2 e^{-i pi k/2n} H[k]) and DST2[k] =
    -Im(2 e^{-i pi (k+1)/2n} H[k+1]).  Type III: c = x times the
    pre-rotation (DCT: 2 e^{-i pi j/2n}, c[0] = x[0]; DST: shifted one bin,
    the end term halved) zero-extended to 2n, Z = DFT_2n(c), DCT3 = Re Z,
    DST3 = -Im Z, on the first n bins.  All times ``scale``."""
    pad = torch.nn.functional.pad
    n = x.shape[1]
    k = np.arange(n)
    if not type3:
        shift = 1 if dst else 0
        rot = planar_table(2.0 * scale * np.exp(-0.5j * np.pi * (k + shift)
                                                / n), x.dtype, x.device)
        H = torch_engine.rfft_lines_plain(pad(x, (0, n)))
        V = H[:, shift:shift + n] * rot[None]
        return -V.im if dst else V.re
    rot = 2.0 * np.exp(-0.5j * np.pi * (k + (1 if dst else 0)) / n)
    if dst:
        rot[-1] *= 0.5
    else:
        rot[0] = 1.0
    rot = planar_table(rot, x.dtype, x.device)
    c = Planar(*(pad(t, (1, n - 1) if dst else (0, n))
                 for t in (x * rot.re, x * rot.im)))
    Z = torch_engine.lines_plain(c, plan_axis(2 * n), False, scale)[:, :n]
    return (-Z.im if dst else Z.re).contiguous()


def fft_dct1_plain(x: torch.Tensor, dst: bool = False,
                   scale: float = 1.0) -> torch.Tensor:
    """Plain torch version of `fft_dct1` (the TPU kernel's form, not the
    CUDA kernel's extension): H = rfft of x zero-padded to 2M
    (DST-I: shifted one place), M = `dct1_length`; DCT1[k] = 2 Re H[k] -
    x[0] - (-1)^k x[n-1], DST1[k] = -2 Im H[k+1]; times ``scale``."""
    n = x.shape[1]
    M = dct1_length(n, dst)
    pad = (1, 2 * M - n - 1) if dst else (0, 2 * M - n)
    H = torch_engine.rfft_lines_plain(torch.nn.functional.pad(x, pad))
    if dst:
        y = -2.0 * H.im[:, 1:n + 1]
    else:
        alt = torch.as_tensor(np.where(np.arange(n) % 2, -1.0, 1.0),
                              dtype=x.dtype, device=x.device)
        y = 2.0 * H.re[:, :n] - x[:, :1] - alt * x[:, n - 1:]
    return (y * scale).contiguous()


def fft_dct4_plain(x: torch.Tensor, dst: bool = False,
                   scale: float = 1.0) -> torch.Tensor:
    """Plain torch version of `fft_dct4`: c = x e^{-i pi j/2n}
    zero-extended to 2n, Z = DFT_2n(c), DCT4[k] = 2 Re(t_k Z[k]), DST4[k] =
    -2 Im(t_k Z[k]), t_k = e^{-i pi (2k+1)/4n}; times ``scale``."""
    n = x.shape[1]
    j = np.arange(n)
    pre = planar_table(np.exp(-0.5j * np.pi * j / n), x.dtype, x.device)
    post = planar_table(2.0 * scale * np.exp(-0.25j * np.pi * (2 * j + 1) / n),
                        x.dtype, x.device)
    c = Planar(*(torch.nn.functional.pad(t, (0, n))
                 for t in (x * pre.re, x * pre.im)))
    Z = torch_engine.lines_plain(c, plan_axis(2 * n))[:, :n] * post[None]
    return (-Z.im if dst else Z.re).contiguous()


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "nvcc on the machine that has the card")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_key()}.so")


def build_kernels() -> dict:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: path}; the compiler's
    messages (with ``-Xptxas -v``: registers, shared memory, spills) go to
    a ``.log`` beside each library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in KERNEL_SOURCES}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    try:
        for name, path in todo.items():
            tmp = f"{path}.tmp{os.getpid()}"
            log = open(path[:-3] + ".log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, name + ".cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           log, tmp)
        failed = []
        for name, (proc, log, tmp) in procs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, todo[name])
            else:
                failed.append(name)
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        msgs = []
        for name in failed:
            with open(todo[name][:-3] + ".log") as f:
                msgs.append(f"--- {name} ---\n{f.read()[-4000:]}")
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return paths


_LIBS: dict = {}

# C entry points of each library and their arguments before the stream
# (p: pointer, q: 64-bit int, i: int, f: float).
_ENTRIES = {
    # planes, batch, plans, tables, the twiddle's two tables, then the
    # layout (lines_layout): threads, lines, shared bytes
    # (the fp64 entries _f64 take the same arguments on fp64 planes and
    # tables, the half-storage ones _f16 and _bf16 on half planes and fp32
    # tables: `_with_instantiations`)
    "fft_lines": {"fft_lines": "ppppqpppppiii"},
    # planes, P, S, the plans of the two factors, their tables, the
    # twiddle's two tables, then the layout (strided_layout): columns a
    # block, threads, shared bytes
    "fft_strided": {"fft_strided": "ppppqq" + "p" * 5 + "iii"},
    # planes, batch, the plans of each axis's two factors (z1, z2, y1,
    # y2), their tables, the twiddles of z and y, then the layout
    # (pair_layout): cluster, threads, shared bytes
    "fft_pair": {"fft_pair": "ppppq" + "p" * 10 + "iii"},
    # real side, spectrum planes, batch, packed, plans, tables, the
    # twiddles (r2c_twiddle), the inverse's scale, then the layout
    # (r2c_layout): threads, lines, shared bytes
    "fft_r2c": {"fft_r2c": "pppqipppppiii", "fft_c2r": "pppqipppppfiii"},
    # real side or spectrum planes, batch, the plans of each axis's two
    # factors (z1, z2 of nz/2; y1, y2), their tables, the twiddles of z
    # (r2c_twiddle) and y, the inverse's scale_z, then the layout
    # (r2c_pair_layout): cluster, threads, shared bytes
    "fft_r2c_pair": {"fft_r2c_pair": "pppq" + "p" * 10 + "iii",
                     "fft_c2r_pair": "pppq" + "p" * 10 + "fiii"},
    # planes, lines, n, mm, rows, flags, the plans of the forward and the
    # inverse factors (f1, f2, i1, i2), their tables, the forward and the
    # inverse twiddle's two tables, spectrum, chirp, then the layout
    # (conv_layout): threads, lines, shared bytes
    "fft_conv": {"fft_conv": "ppppqiiii" + "p" * 12 + "iii"},
    # planes, batch, plans, tables, the twiddle's two tables, swapped,
    # then the layout (twofactor_layout): threads, lines, shared bytes
    "fft_twofactor": {"fft_twofactor": "ppppqpppppiiii"},
    # planes, batch, plans, tables, the twiddle's two tables, spectrum, the
    # per-line constant's planes, then the layout (twofactor_layout):
    # threads, lines, shared bytes
    "fft_conv_inv": {"fft_conv_inv": "ppppq" + "p" * 8 + "iii"},
    # Bluestein: planes, batch, n, plans, tables, the twiddle's two
    # tables, spectrum, chirp, then the layout (conv_pair_layout): cluster,
    # threads, shared bytes
    # 2-D: planes, batch, hp, flags, scale, the plans of each axis's two
    # factors (z1, z2, y1, y2), their tables, the twiddles of z and y,
    # spectrum, then the layout (conv2d_layout): cluster, threads, shared
    # bytes
    "fft_conv_pair": {"fft_conv_pair": "ppppqi" + "p" * 11 + "iii",
                      "fft_conv2d": "ppppqiif" + "p" * 11 + "iii"},
    # real lines in and out, batch, (fft_dct4: n,) dst, plans, tables,
    # the twiddles (dct23_twiddle / dct1_twiddle / dct4_twiddle), then the
    # layout (dct23_layout / dct1_layout / dct4_layout): threads, lines,
    # shared bytes
    "fft_dct23": {"fft_dct2": "ppqi" + "p" * 5 + "iii",
                  "fft_dct3": "ppqi" + "p" * 5 + "iii"},
    "fft_dct1": {"fft_dct1": "ppqi" + "p" * 5 + "iii"},
    "fft_dct4": {"fft_dct4": "ppqii" + "p" * 5 + "iii"},
    # planes, P, S, the live lengths, the plans of the two factors, their
    # tables, the twiddle's two tables, the factors, the interleaves, the
    # mode, then the layout (strided_tw_layout): columns a block, threads,
    # shared bytes
    "fft_strided_tw": {"fft_strided_tw": "ppppqqqq" + "p" * 6 + "iii"
                       + "iii"},
    # the double-double tier (precision/dd_kernel.py): eight quad planes,
    # extents, plan, table, the pre/post tables and their lengths, the
    # per-line add, the dd scale, the instantiation (dd_kernel.dd_variant)
    "fft_dd": {"fft_dd_lines": "p" * 8 + "qpppqpqpffi",
               "fft_dd_strided": "p" * 8 + "qqpppqpqffi",
               "dd_pointwise": "p" * 8 + "qqpqpff"},
}


def _with_instantiations(entries: dict) -> dict:
    """`_ENTRIES` with the fp64 and half-storage C entries of the kernels
    that have them, each with its fp32 entry's arguments."""
    out = {name: dict(sigs) for name, sigs in entries.items()}
    for name in F64_KERNELS:
        out[name][name + _SUFFIX[torch.float64]] = entries[name][name]
    for entry, lib in STORAGE_LIBRARY.items():
        for dt in STORAGE_DTYPES:
            out[lib][entry + _SUFFIX[dt]] = entries[lib][entry]
    return out


def _with_windows(entries: dict) -> dict:
    """`_ENTRIES` with the windowed C entries (`ZP_ENTRIES`): each its
    kernel's arguments (`fft_twofactor`'s without ``swapped``: the windows
    run natural order) and the window's ints by pointer."""
    out = {name: dict(sigs) for name, sigs in entries.items()}
    for name in ZP_KERNELS:
        sig = entries[name][name]
        if name == "fft_twofactor":
            sig = "ppppqpppppiii"
        for dt in ZP_DTYPES[name]:
            out[name][zp_entry(name, dt)] = sig + "p"
    for entry in ZP_CONV2D_ENTRIES:
        out["fft_conv_pair"][entry] = entries["fft_conv_pair"]["fft_conv2d"] + "p"
    # Bluestein's read window: the kernel's arguments and in_keep (an int;
    # a 64-bit one for the plane mode's live lengths)
    for entry in ZP_BLUESTEIN_ENTRIES:
        name = entry[:entry.index("_zp")]
        out[name][entry] = entries[name][name] + (
            "q" if name == "fft_strided_tw" else "i")
    return out


def _with_tl(entries: dict) -> dict:
    """`_ENTRIES` with the tl C entries (`TL_ENTRIES`), each with its
    kernel's arguments."""
    out = {name: dict(sigs) for name, sigs in entries.items()}
    for entry in TL_ENTRIES:
        name = entry[:entry.index("_tl")]
        out[name][entry] = entries[name][name]
    return out


_ENTRIES = _with_tl(_with_windows(_with_instantiations(_ENTRIES)))
_CTYPES = {"p": ctypes.c_void_p, "q": ctypes.c_longlong, "i": ctypes.c_int,
           "f": ctypes.c_float}


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build_kernels()[name]
    lib = ctypes.CDLL(path)
    for entry, sig in _ENTRIES[name].items():
        fn = getattr(lib, "vk_" + entry)
        fn.argtypes = [_CTYPES[c] for c in sig] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.vk_error_string.argtypes = [ctypes.c_int]
    lib.vk_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def _launch(name: str, entry: str, device: torch.device, args,
            dtype: torch.dtype = torch.float32) -> None:
    """One launch of C entry ``vk_<entry>`` of library ``name`` on the
    current stream of ``device``; tensors pass as their data pointers and
    ctypes arrays by address.  Raises on a refused launch and counts it
    in `launches` otherwise (a tl or windowed entry in `tl_launches` or
    `zp_launches` under its entry, a float64 instantiation in
    `f64_launches`, a half-storage one in `storage_launches` under its
    entry)."""
    lib = _library(name)
    c_args = [ctypes.addressof(a) if isinstance(a, ctypes.Array)
              else a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "vk_" + entry)(*c_args, stream)
    if err:
        msg = lib.vk_error_string(err).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
    if entry in tl_launches:
        tl_launches[entry] += 1
    elif entry in zp_launches:
        zp_launches[entry] += 1
    elif dtype == torch.float64:
        f64_launches[name] += 1
    elif dtype in STORAGE_DTYPES:
        storage_launches[entry] += 1
    else:
        launches[name] += 1


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check_planes(re, im, ndim: int, what: str,
                  dtypes: tuple = (torch.float32,)) -> None:
    """Planes for ``what``: of one of ``dtypes`` (float32, and the dtypes of
    the kernel's other instantiations), both of one dtype."""
    if not (isinstance(re, torch.Tensor) and isinstance(im, torch.Tensor)):
        raise TypeError(f"{what}: re and im must be torch tensors")
    if re.shape != im.shape or re.ndim != ndim:
        raise ValueError(f"{what}: planes must both be {ndim}-D of one shape, "
                         f"got {tuple(re.shape)} and {tuple(im.shape)}")
    for t in (re, im):
        _check_real(t, ndim, what, dtypes)
    if re.dtype != im.dtype:
        raise TypeError(f"{what}: planes of {re.dtype} and {im.dtype}")
    if re.device != im.device:
        raise ValueError(f"{what}: planes on {re.device} and {im.device}")


# The plane dtypes of the kernels with other instantiations than fp32:
# `fft_lines`, `fft_strided` and `fft_pair` (fp64 and half storage), the
# other C2C kernels (half storage).
_C2C_DTYPES = (torch.float32, torch.float64) + STORAGE_DTYPES
_HALF_DTYPES = (torch.float32,) + STORAGE_DTYPES


def _check_real(x, ndim: int, what: str,
                dtypes: tuple = (torch.float32,)) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: input must be a torch tensor")
    if x.ndim != ndim:
        raise ValueError(f"{what}: input must be {ndim}-D, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{what}: planes must be {kinds}, got {x.dtype} "
                        "(other precisions are ROADMAP queue 1 item 10)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: planes must be contiguous")


def _check_length(n: int) -> None:
    if not kernel_supports(n):
        raise _unsupported(n)


def _check_r2c_length(n: int) -> None:
    if not r2c_supports(n):
        raise NotImplementedError(
            f"real length {n} is outside the real kernels' range (n even, "
            f"n/2 a length of the CUDA kernels: 2 <= n/2 <= {KERNEL_MAX_N}, "
            f"prime factors <= {KERNEL_MAX_PRIME}); the CUDA engine runs "
            "other lengths on the C2C routes (the half-length route of "
            "cuda_engine.rfft_lines_p)")


def _check_out(re, out) -> None:
    for y in out:
        if (y.shape != re.shape or y.dtype != re.dtype
                or y.device != re.device or not y.is_contiguous()):
            raise ValueError("out planes must match the input planes")


def _plan(n: int, inverse: bool, scale: float, device: torch.device,
          walk: bool = False, dtype: torch.dtype = torch.float32):
    """(plan ints as a C array, device table in ``dtype``) of one axis for
    a launch (``walk``: the radices of `walk_radices`)."""
    return (_plan_array(n, inverse, scale, walk),
            _device_table(n, inverse, scale, device, walk=walk, dtype=dtype))


def _walk_plans(ns, inverse: bool, device: torch.device,
                dtype: torch.dtype):
    """`_plan` of each length of ``ns`` for the walk kernels' instantiation
    of planes of ``dtype``: `walk_radices` and fp32 tables, or at float64
    `stage_radices` and fp64 tables."""
    tab = table_dtype(dtype)
    return [_plan(k, inverse, 1.0, device, tab == torch.float32, tab)
            for k in ns]


def _twiddle_pair(n: int, inverse: bool, scale: float, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The device copy of `twofactor_twiddle_pair` for planes of
    ``dtype`` (its `table_dtype`)."""
    return device_array(("twofactor_pair", n, inverse, scale), device,
                        lambda: twofactor_twiddle_pair(n, inverse, scale),
                        table_dtype(dtype))


@functools.lru_cache(maxsize=4096)
def _plan_array(n: int, inverse: bool, scale: float, walk: bool):
    """The plan ints of `stage_tables` as a C array, built once a plan (the
    C entries only read it): about 10 µs of Python a launch otherwise."""
    ints, _ = stage_tables(n, inverse, scale, walk)
    return (ctypes.c_int * len(ints))(*ints)


def _apply(name: str, re, im, out, plain, kernel_args, entry=None):
    """Shared body of the wrappers of complex planes: ``plain()`` for CPU
    planes (copied into ``out`` when given), one launch of C entry
    ``vk_<entry>`` (default ``name``; its fp64 instantiation ``_f64`` on
    float64 planes, counted in `f64_launches`, its half-storage ones
    ``_f16``/``_bf16``, counted in `storage_launches`) of library ``name``
    for CUDA planes with ``kernel_args()`` between the four plane pointers
    and the stream.  The output planes have the input's shape; ``out`` may
    be the input."""
    if out is not None:
        _check_out(re, out)
    if re.device.type == "cpu":
        yr, yi = plain()
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    yr, yi = out if out is not None else (torch.empty_like(re),
                                          torch.empty_like(im))
    if re.numel():
        _launch(name, (entry or name) + _SUFFIX[re.dtype], re.device,
                [re, im, yr, yi, *kernel_args()], re.dtype)
    return yr, yi


def merged_dims(shape, strides) -> list:
    """(size, stride) of the dims of a view, length-1 dims dropped and
    neighbours merged where the outer one's stride spans the inner one:
    the fewest strides that address it."""
    out = []
    for size, stride in zip(shape, strides):
        if size == 1:
            continue
        if out and out[-1][1] == size * stride:
            out[-1] = (out[-1][0] * size, stride)
        else:
            out.append((size, stride))
    return out


def _check_view(re, im, what: str, dtypes: tuple, ndims=None) -> None:
    """Planes of a windowed launch: views of one dtype, device, shape and
    strides, their last dim contiguous (a corner of wider planes, read
    through its strides in place)."""
    if not (isinstance(re, torch.Tensor) and isinstance(im, torch.Tensor)):
        raise TypeError(f"{what}: re and im must be torch tensors")
    if re.shape != im.shape or re.stride() != im.stride():
        raise ValueError(f"{what}: planes of shapes {tuple(re.shape)} and "
                         f"{tuple(im.shape)}, strides {re.stride()} and "
                         f"{im.stride()}")
    if ndims is not None and re.ndim not in ndims:
        raise ValueError(f"{what}: planes must be {ndims}-D, got "
                         f"{tuple(re.shape)}")
    if re.dtype not in dtypes or im.dtype != re.dtype:
        kinds = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{what}: planes must be {kinds}, got {re.dtype} "
                        "(other precisions are ROADMAP queue 1 item 10)")
    if re.device != im.device:
        raise ValueError(f"{what}: planes on {re.device} and {im.device}")
    if re.ndim and re.shape[-1] > 1 and re.stride(-1) != 1:
        raise ValueError(f"{what}: the planes' last dim must be contiguous")


def _window_out(re, im, out, shape) -> None:
    """``out`` of a windowed launch: planes of the output's shape, the
    input's dtype and device, contiguous; they may be the input planes
    only where the output has the input's shape and layout (whole
    contiguous lines or planes), never on a cropped write or a corner
    read."""
    if out is None:
        return
    for y in out:
        if (tuple(y.shape) != tuple(shape) or y.dtype != re.dtype
                or y.device != re.device or not y.is_contiguous()):
            raise ValueError(f"out planes must be contiguous {tuple(shape)} "
                             f"planes of {re.dtype}")
    theirs = {t.untyped_storage().data_ptr() for t in (re, im)}
    if ({y.untyped_storage().data_ptr() for y in out} & theirs
            and (tuple(shape) != tuple(re.shape)
                 or not (re.is_contiguous() and im.is_contiguous()))):
        raise ValueError("out= aliases the input on a cropped write or a "
                         "corner read")


def _windowed_lines(name: str, re, im, inverse: bool, scale: float, out,
                    w: LineWindow, dtypes: tuple, layout, plain):
    """A windowed launch of `fft_lines` or `fft_twofactor` (C entry
    ``vk_<name>_zp``): the lines are the leading dims of the (..., L)
    view, L = n or the kept prefix, addressed through at most three
    strides (inplace.cuh's LineWindow); the output is (..., w.out)."""
    _check_view(re, im, name, dtypes)
    if re.ndim < 2:
        raise ValueError(f"{name}: planes must be at least 2-D")
    L = re.shape[-1]
    if L not in (w.n, w.length) or L < w.length:
        raise ValueError(f"{name}: lines of {L} points for a window of "
                         f"{w.length} read of {w.n}")
    lead = tuple(re.shape[:-1])
    shape = lead + (w.out,)
    _window_out(re, im, out, shape)
    if re.device.type == "cpu":
        yr, yi = plain()
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    groups = merged_dims(lead, re.stride()[:-1])
    if len(groups) > 3:
        raise ValueError(f"{name}: lines of {len(groups)} strides (at most 3; "
                         "copy the planes)")
    (d0, s0), (d1, s1), (d2, s2) = [(1, 0)] * (3 - len(groups)) + groups
    if len(groups) == 0:
        s2 = L
    B = d0 * d1 * d2
    yr, yi = out if out is not None else (re.new_empty(shape),
                                          im.new_empty(shape))
    if B:
        win = (ctypes.c_longlong * 11)(s0, s1, d1, d2, s2, w.length,
                                       *w.zero, w.out, *w.fill)
        _launch(name, zp_entry(name, re.dtype), re.device,
                [re, im, yr, yi, B, *layout(), win], re.dtype)
    return yr, yi


def fft_lines(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
              scale: float = 1.0, out=None,
              window: Optional[LineWindow] = None, tl: bool = False):
    """DFT of each line of (B, n) float32, float64, float16 or bfloat16
    planes, times ``scale``.  ``out`` may name the output planes, which may
    be the input planes themselves (in place).  CPU tensors run
    `fft_lines_plain`; CUDA tensors launch the kernel (float64: its fp64
    instantiation; float16 / bfloat16: its half-storage one, computing in
    fp32) on the current stream.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:1563 _fft_kernel_v3``.  Bound
    by bytes (16 B a point read once and written once; 32 B at float64, 8
    B on half planes); a
    block holds its lines once each in shared memory (`lines_layout`) and
    runs their stages in place on the walk of ``csrc/inplace.cuh``, as one
    pass or, where a stage's sequences do not fit a round, two factors
    (`lines_split`), so device memory sees only that traffic
    (``csrc/fft_lines.cu``).

    A zero-pad ``window`` (a `LineWindow` of n points, `line_window`:
    ``in_keep`` or ``in_window``, ``out_keep`` with or without
    ``out_fill``, or ``out_zero_window``) launches the windowed entry
    (``vk_fft_lines_zp`` and its instantiations, counted in
    `zp_launches`), which replaces the options of the same names of
    ``_fft_kernel_v3``: the planes may then be any view (..., L) whose
    lines three strides address (a corner of wider planes, read in
    place; the identity window reads such a view whole), L = n or the
    kept prefix, and the output is (..., window.out).  Bound by the bytes of
    the kept reads and writes.

    ``tl`` (float32, float16 or bfloat16 planes): the kept intermediate
    order, the tl entry (``vk_fft_lines_tl`` and its half twins, counted in
    `tl_launches`), which replaces ``_fft_kernel_v3``'s tl layout: the
    forward writes each line in the swapped digit order of `lines_split`'s
    (n1, n2), bin k1 * n2 + k2 at k2 * n1 + k1 (natural for a length of one
    pass), and the inverse reads that order (`tl_order`).  The same
    passes; the two-factor store and read skip the walk's transposed
    shared-memory access."""
    if tl:
        if window is not None:
            raise ValueError("fft_lines: a window runs natural order")
        _check_planes(re, im, 2, "fft_lines", _HALF_DTYPES)
    if window is not None:
        n = window.n
        _check_length(n)
        dt = re.dtype

        def layout():
            (p1, t1), (p2, t2) = _walk_plans(lines_split(n, dt), inverse,
                                             re.device, dt)
            tw = _twiddle_pair(n, inverse, scale, re.device, dt)
            return (p1, p2, t1, t2, tw, *lines_layout(n, dt))

        return _windowed_lines("fft_lines", re, im, inverse, scale, out, window,
                               _C2C_DTYPES, layout,
                               lambda: fft_lines_plain(re, im, inverse, scale,
                                                       window=window))
    _check_planes(re, im, 2, "fft_lines", _C2C_DTYPES)
    B, n = re.shape
    _check_length(n)
    dt = re.dtype

    def args():
        (p1, t1), (p2, t2) = _walk_plans(lines_split(n, dt), inverse,
                                         re.device, dt)
        tw = _twiddle_pair(n, inverse, scale, re.device, dt)
        return (B, p1, p2, t1, t2, tw, *lines_layout(n, dt))

    return _apply("fft_lines", re, im, out,
                  lambda: fft_lines_plain(re, im, inverse, scale, tl=tl), args,
                  entry="fft_lines_tl" if tl else None)


def fft_strided(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                scale: float = 1.0, out=None, pre: Optional[Factor] = None,
                post: Optional[Factor] = None, plane=None,
                out_len: Optional[int] = None, in_interleave: int = 1,
                out_interleave: int = 1, in_transposed: bool = False,
                out_transposed: bool = False, in_keep: int = 0,
                out_keep: int = 0, n: Optional[int] = None):
    """DFT along the middle dim of (P, n, S) float32, float64, float16 or
    bfloat16 planes, times ``scale``.  ``out`` as for `fft_lines`.  CPU
    tensors run `fft_strided_plain`; CUDA tensors launch the kernel
    (float64: its fp64 instantiation; float16 / bfloat16: its half-storage
    one; the factor mode below takes float32 and the half dtypes).

    Replaces ``vkfft_tpu/ops/pallas_engine.py:3489 _strided_kernel_v3``,
    and ``:4001 _outer_kernel`` through the (P, n, R*nz) view.  Bound by
    bytes (16 B a point, 32 at float64, 8 on half planes); a block holds a
    tile of neighbouring columns
    across all n rows once in shared memory (`strided_layout`), reading
    each row of the tile as one contiguous run, and runs the stages down
    the columns on the walk of ``csrc/inplace.cuh``, in one pass or two
    factors (`strided_split`) (``csrc/fft_strided.cu``).

    The factor mode (any of ``pre``, ``post``, ``plane``, an interleave
    or a transposed side) launches `fft_strided_tw`
    (``csrc/fft_strided_tw.cu``, counted apart, the same tile on the walk,
    `strided_tw_layout`), which replaces ``:3439 _strided_kernel`` and the
    factor option of ``:3489``: the input times the ``pre`` `Factor` and
    the output times the ``post`` one, each computed in the kernel; n up
    to 8192 with primes up to 127 (`strided_tw_supports`).  With
    ``plane=(n, S)`` the planes are (P, L) lines, the first L <= n*S
    points of each (n, S) plane (the rest read
    as zero), and the output is the first ``out_len`` (default n*S) points
    of each transformed plane, (P, out_len): the long Bluestein's live
    rows, with no pad or crop in device memory; ``in_keep`` (1 <= in_keep
    <= L, 0 for none) with ``plane`` is Bluestein's read window of a
    forward pass (the windowed entry ``vk_fft_strided_tw_zp`` and its half
    twins, counted in `zp_launches`, which replaces the in_keep of
    ``_strided_kernel``'s Bluestein pass): only the first in_keep points of
    each line are read, the rest declared zero.  ``in_interleave`` /
    ``out_interleave`` d > 1 (whole planes only) read / write the planes p
    = b*d + q interleaved row by row, (P/d, n, d, S) in memory: three
    uploads' last pass writes the long tier's natural order so.
    ``out_transposed`` writes the output as (P, S, n) planes, each column
    one run of n points, and ``in_transposed`` reads the input as (P, S,
    n) planes (whole planes, no interleave, not in place): the long
    tier's first pass stores the four-step reorder, and its inverse reads
    it.

    Zero-pad keeps (``in_keep``: only the first rows are read, the rest
    declared zero; ``out_keep``: only the first rows are written, (P,
    out_keep, ...) planes; 0 < keep < n) launch the windowed entry
    (``vk_fft_strided_zp`` and its instantiations, counted in
    `zp_launches`), which replaces the in_keep / out_keep of
    ``_strided_kernel_v3`` and ``_outer_kernel``.  The planes may then be
    a view (P, R, S) or (P, R, G, W) with its last dim contiguous (a
    corner of wider planes, read in place through its strides), R = ``n``
    (default R) or the kept rows; the output is contiguous (P, out_keep or
    n, ...) of the input's trailing shape.  Bound by the bytes of the kept
    rows read and written."""
    if plane is not None and (out_keep or n is not None):
        raise ValueError("fft_strided: the plane mode's window is in_keep")
    if (in_keep or out_keep or n is not None) and plane is None:
        if (pre is not None or post is not None or in_interleave != 1
                or out_interleave != 1 or in_transposed or out_transposed):
            raise ValueError("fft_strided: keeps do not take the factor mode")
        return _fft_strided_window(re, im, inverse, scale, out, in_keep,
                                   out_keep, n)
    if (pre is not None or post is not None or plane is not None
            or in_interleave != 1 or out_interleave != 1 or in_transposed
            or out_transposed):
        return _fft_strided_tw(re, im, inverse, scale, out, pre, post, plane,
                               out_len, in_interleave, out_interleave,
                               in_transposed, out_transposed, in_keep)
    _check_planes(re, im, 3, "fft_strided", _C2C_DTYPES)
    P, n, S = re.shape
    _check_length(n)
    dt = re.dtype

    def args():
        (p1, t1), (p2, t2) = _walk_plans(strided_split(n, S, dt), inverse,
                                         re.device, dt)
        tw = _twiddle_pair(n, inverse, scale, re.device, dt)
        return (P, S, p1, p2, t1, t2, tw, *strided_layout(n, S, dt))

    return _apply("fft_strided", re, im, out,
                  lambda: fft_strided_plain(re, im, inverse, scale), args)


def _fft_strided_window(re, im, inverse: bool, scale: float, out,
                        in_keep: int, out_keep: int, n: Optional[int]):
    """The windowed mode of `fft_strided` (C entry ``vk_fft_strided_zp``
    of ``csrc/fft_strided.cu``, its ColWindow)."""
    what = "fft_strided"
    _check_view(re, im, what, _C2C_DTYPES, (3, 4))
    P, R = re.shape[:2]
    n = R if n is None else n
    _check_length(n)
    rows_in = _check_keep(in_keep, n, what) or n
    rows_out = _check_keep(out_keep, n, what) or n
    if R not in (n, rows_in):
        raise ValueError(f"{what}: {R} rows for {rows_in} read of {n}")
    tail = tuple(re.shape[2:])
    S = math.prod(tail)
    shape = (P, rows_out) + tail
    _window_out(re, im, out, shape)
    if re.device.type == "cpu":
        yr, yi = fft_strided_plain(re, im, inverse, scale,
                                   window=(n, rows_in, rows_out))
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    cols = merged_dims(tail, re.stride()[2:])
    if len(cols) > 2 or cols and cols[-1][1] != 1:
        raise ValueError(f"{what}: columns of {len(cols)} strides (at most "
                         "2, the last contiguous; copy the planes)")
    cw, cs = (cols[1][0], cols[0][1]) if len(cols) == 2 else (0, 0)
    dt = re.dtype
    yr, yi = out if out is not None else (re.new_empty(shape),
                                          im.new_empty(shape))
    if P and S:
        (p1, t1), (p2, t2) = _walk_plans(strided_split(n, S, dt), inverse,
                                         re.device, dt)
        tw = _twiddle_pair(n, inverse, scale, re.device, dt)
        win = (ctypes.c_longlong * 6)(re.stride(0) if P > 1 else 0,
                                      re.stride(1), cs, cw, rows_in, rows_out)
        _launch(what, zp_entry(what, dt), re.device,
                [re, im, yr, yi, P, S, p1, p2, t1, t2, tw,
                 *strided_layout(n, S, dt), win], dt)
    return yr, yi


def _fft_strided_tw(re, im, inverse: bool, scale: float, out,
                    pre: Optional[Factor], post: Optional[Factor], plane,
                    out_len: Optional[int], in_pd: int, out_pd: int,
                    in_transposed: bool = False,
                    out_transposed: bool = False, in_keep: int = 0):
    """The factor mode of `fft_strided` (C entry ``vk_fft_strided_tw`` of
    ``csrc/fft_strided_tw.cu``, counted as ``fft_strided_tw``; on float16 /
    bfloat16 planes its half-storage instantiation, the factors and tables
    fp32); with ``in_keep`` (plane mode), its windowed entry
    ``vk_fft_strided_tw_zp``."""
    what = "fft_strided_tw"
    mode = 1 if in_transposed else 2 if out_transposed else 0
    if mode and (in_transposed and out_transposed or plane is not None
                 or in_pd != 1 or out_pd != 1 or out is not None):
        raise ValueError(f"{what}: a transposed side takes whole planes, "
                         "one side, no interleave and a fresh output")
    if plane is None:
        _check_planes(re, im, 3, what, _HALF_DTYPES)
        P, n, S = re.shape
        if in_transposed:
            S, n = n, S
        in_len = keep = n * S
        if out_len is not None:
            raise ValueError(f"{what}: out_len needs plane")
        if in_pd < 1 or out_pd < 1 or P % in_pd or P % out_pd:
            raise ValueError(f"{what}: {P} planes do not interleave by "
                             f"{in_pd} and {out_pd}")
        if out is not None and in_pd != out_pd:
            raise ValueError(f"{what}: a changed interleave cannot write "
                             "in place")
        shape = (P, S, n) if out_transposed else (P, n, S)
    else:
        if in_pd != 1 or out_pd != 1:
            raise ValueError(f"{what}: interleave needs whole planes")
        _check_planes(re, im, 2, what, _HALF_DTYPES)
        n, S = plane
        P, in_len = re.shape
        keep = n * S if out_len is None else out_len
        if not (1 <= in_len <= n * S and 1 <= keep <= n * S):
            raise ValueError(f"{what}: live lengths {in_len} in and {keep} "
                             f"out of an ({n}, {S}) plane")
        in_keep = _check_read_window(in_keep, in_len, what)
        if in_keep and inverse:
            raise ValueError(f"{what}: a read window on a forward pass")
        shape = (P, keep)
    if not strided_tw_supports(n):
        raise NotImplementedError(
            f"{what}: length {n} is outside the factor mode's range (2 <= n "
            f"<= {KERNEL_MAX_N}, prime factors <= {MAX_DIRECT_PRIME}); the "
            "long tier splits longer lines (long_split)")
    for f in (pre, post):
        if f is not None and f.kind == "chirp" and n * S >= 1 << 32:
            raise ValueError(f"{what}: a chirp over lines of 2^32 points or "
                             "more (j^2 must fit 64 bits)")
    if out is not None:
        if plane is not None and in_len != keep:
            raise ValueError(f"{what}: out planes need equal live lengths")
        _check_out(re, out)
    if re.device.type == "cpu":
        yr, yi = fft_strided_plain(re, im, inverse, scale, pre, post, plane,
                                   out_len, in_pd, out_pd, in_transposed,
                                   out_transposed, in_keep=in_keep)
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    yr, yi = out if out is not None else (re.new_empty(shape),
                                          im.new_empty(shape))
    if P:
        n1, n2 = strided_tw_split(n, S)
        p1, t1 = _plan(n1, inverse, 1.0, re.device, True)
        p2, t2 = _plan(n2, inverse, 1.0, re.device, True)
        tw = device_array(("twofactor_pair", n, inverse, scale), re.device,
                          lambda: twofactor_twiddle_pair(n, inverse, scale))
        factors = (ctypes.c_longlong * 16)(
            *(pre.ints() if pre else [0] * 8),
            *(post.ints() if post else [0] * 8))
        _launch(what, what + ("_zp" if in_keep else "") + _SUFFIX[re.dtype],
                re.device,
                [re, im, yr, yi, P, S, in_len, keep, p1, p2, t1, t2, tw,
                 factors, in_pd, out_pd, mode, *strided_tw_layout(n, S)]
                + ([in_keep] if in_keep else []), re.dtype)
    return yr, yi


def fft_pair(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
             scale: float = 1.0, out=None, in_keep=None, out_keep=None,
             plane: Optional[tuple] = None, tl: bool = False):
    """2-D DFT over the two minor axes of (B, ny, nz) float32, float64,
    float16 or bfloat16 planes, times ``scale``, in one pass.  ``out`` as
    for `fft_lines`.  CPU tensors run `fft_pair_plain`; CUDA tensors launch
    the kernel (float64: its fp64 instantiation; float16 / bfloat16: its
    half-storage one).

    Replaces ``vkfft_tpu/ops/pallas_engine.py:1982 _pair_kernel``.  Bound by
    bytes (16 B a point for both axes, 32 at float64, 8 on half planes); a
    cluster
    (`pair_layout`) holds each plane once in its shared memory on the walk
    of ``csrc/inplace.cuh``, runs the z stages on rows, exchanges the tiles
    between its blocks over distributed shared memory and runs the y
    stages down the columns (``csrc/fft_pair.cu``); the planes are those
    `pair_cluster` serves at the planes' dtype.

    Zero-pad corners (``in_keep`` = (ky, kz): only that corner of each
    plane is read, the rest declared zero; ``out_keep`` = (oy, oz): only
    that corner is written, (B, oy, oz) planes; 0 for an axis without a
    keep, else 0 < keep < its length) launch the windowed entry
    (``vk_fft_pair_zp`` and its instantiations, counted in `zp_launches`),
    which replaces ``_pair_kernel``'s in_keep / out_keep.  The planes may
    then be a view (B, Ry, Rz) with its last dim contiguous: a corner of
    wider planes read in place, or the cropped corner itself, of the
    (ny, nz) ``plane`` (default (Ry, Rz)).  Bound by the bytes of the kept
    corners read and written.

    ``tl`` (float32, float16 or bfloat16 planes): the kept intermediate
    order, the tl entry (``vk_fft_pair_tl`` and its half twins, counted in
    `tl_launches`), which replaces ``_pair_kernel``'s tl layout
    (``fft_pair_tl_planar``): the forward takes (B, ny, nz) planes and
    returns the transposed (B, nz, ny) planes of their spectrum, each axis
    in natural order; the inverse takes those and returns (B, ny, nz)
    planes.  The forward writes each column tile as rows of the transposed
    plane, the inverse reads it so and runs the y axis first, so neither
    moves the plane back between the cluster's blocks."""
    if tl:
        if in_keep is not None or out_keep is not None or plane is not None:
            raise ValueError("fft_pair: corners run natural order")
        return _fft_pair_tl(re, im, inverse, scale, out)
    if in_keep is not None or out_keep is not None or plane is not None:
        return _fft_pair_window(re, im, inverse, scale, out,
                                in_keep or (0, 0), out_keep or (0, 0), plane)
    _check_planes(re, im, 3, "fft_pair", _C2C_DTYPES)
    B, ny, nz = re.shape
    _check_length(ny)
    _check_length(nz)
    dt = re.dtype
    if pair_cluster(ny, nz, dt) is None:
        raise _no_cluster("fft_pair", ny, nz)

    return _apply("fft_pair", re, im, out,
                  lambda: fft_pair_plain(re, im, inverse, scale),
                  lambda: (B, *_pair_args(ny, nz, inverse, scale, re.device,
                                          dt)))


def _pair_args(ny: int, nz: int, inverse: bool, scale: float, device,
               dt: torch.dtype) -> tuple:
    """`fft_pair`'s launch arguments after the batch: the plans, tables and
    twiddles of its axes' factors, then its layout (`pair_layout`)."""
    layout = pair_layout(ny, nz, dt)
    (n1z, n2z), (n1y, n2y) = pair_splits(ny, nz, dt)
    plans = _walk_plans((n1z, n2z, n1y, n2y), inverse, device, dt)
    tw = [_twiddle_pair(k, inverse, s, device, dt)
          for k, s in ((nz, 1.0), (ny, scale))]
    return (*(p for p, _ in plans), *(t for _, t in plans), *tw, *layout)


def _fft_pair_tl(re, im, inverse: bool, scale: float, out):
    """The tl mode of `fft_pair` (C entry ``vk_fft_pair_tl``): (B, ny, nz)
    planes to the transposed (B, nz, ny) ones of the spectrum, or back."""
    what = "fft_pair"
    _check_planes(re, im, 3, what, _HALF_DTYPES)
    B, a, b = re.shape
    ny, nz = (b, a) if inverse else (a, b)
    _check_length(ny)
    _check_length(nz)
    dt = re.dtype
    if pair_cluster(ny, nz, dt) is None:
        raise _no_cluster(what, ny, nz)
    shape = (B, b, a)
    _window_out(re, im, out, shape)
    if re.device.type == "cpu":
        yr, yi = fft_pair_plain(re, im, inverse, scale, tl=True)
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    yr, yi = out if out is not None else (re.new_empty(shape),
                                          im.new_empty(shape))
    if B:
        _launch(what, "fft_pair_tl" + _SUFFIX[dt], re.device,
                [re, im, yr, yi, B,
                 *_pair_args(ny, nz, inverse, scale, re.device, dt)], dt)
    return yr, yi


def _fft_pair_window(re, im, inverse: bool, scale: float, out, in_keep,
                     out_keep, plane):
    """The windowed mode of `fft_pair` (C entry ``vk_fft_pair_zp`` of
    ``csrc/fft_pair.cu``, its PairWindow)."""
    what = "fft_pair"
    _check_view(re, im, what, _C2C_DTYPES, (3,))
    B, Ry, Rz = re.shape
    ny, nz = plane or (Ry, Rz)
    _check_length(ny)
    _check_length(nz)
    dt = re.dtype
    if pair_cluster(ny, nz, dt) is None:
        raise _no_cluster(what, ny, nz)
    ky = _check_keep(in_keep[0], ny, what) or ny
    kz = _check_keep(in_keep[1], nz, what) or nz
    oy = _check_keep(out_keep[0], ny, what) or ny
    oz = _check_keep(out_keep[1], nz, what) or nz
    if Ry not in (ny, ky) or Rz not in (nz, kz):
        raise ValueError(f"{what}: ({Ry}, {Rz}) planes for a ({ky}, {kz}) "
                         f"corner of ({ny}, {nz})")
    shape = (B, oy, oz)
    _window_out(re, im, out, shape)
    window = (ny, nz, ky, kz, oy, oz)
    if re.device.type == "cpu":
        yr, yi = fft_pair_plain(re, im, inverse, scale, window=window)
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    yr, yi = out if out is not None else (re.new_empty(shape),
                                          im.new_empty(shape))
    if B:
        win = (ctypes.c_longlong * 8)(re.stride(0) if B > 1 else 0, oy * oz,
                                      re.stride(1) if Ry > 1 else Rz, oz,
                                      ky, kz, oy, oz)
        _launch(what, zp_entry(what, dt), re.device,
                [re, im, yr, yi, B,
                 *_pair_args(ny, nz, inverse, scale, re.device, dt), win], dt)
    return yr, yi


def _no_cluster(what: str, ny: int, nz: int) -> NotImplementedError:
    return NotImplementedError(
        f"a ({ny}, {nz}) plane does not fit a cluster of {what} (at most 16 "
        "blocks of 128 KB); larger planes are ROADMAP queue 2 item 3")


def _check_aligned(x: torch.Tensor, what: str) -> None:
    """The real kernels read a line as float2 pairs: 8-byte alignment."""
    if x.device.type != "cpu" and x.data_ptr() % 8:
        raise ValueError(f"{what}: the real input must be 8-byte aligned "
                         "(pass a fresh contiguous tensor)")


def _check_spectrum(re, im, n: int, packed: bool, what: str) -> None:
    want = n // 2 if packed else n // 2 + 1
    if re.shape[-1] != want:
        raise ValueError(f"{what}: a{' packed' if packed else ''} half "
                         f"spectrum of length {n} has {want} bins, got "
                         f"{re.shape[-1]}")


def fft_r2c(x: torch.Tensor, packed: bool = False):
    """Half spectrum (re, im) of each real line of (B, n) float32 ``x``, n
    even: numpy ``rfft`` values as (B, n/2+1) planes with Im(DC) and
    Im(Nyquist) exactly 0, or with ``packed`` (B, n/2) planes holding the
    real Nyquist bin in Im(bin 0).  CPU tensors run `fft_r2c_plain`; CUDA
    tensors launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:2461 _r2c_kernel``.  Bound by
    bytes (4 B a real point read, 8 B a bin written); a block reads its
    lines as float2 pairs straight to their places, runs the n/2-point
    stages in place on the walk of ``csrc/inplace.cuh`` (`r2c_layout`) and
    untangles there (``csrc/fft_r2c.cu``)."""
    _check_real(x, 2, "fft_r2c")
    B, n = x.shape
    _check_r2c_length(n)
    _check_aligned(x, "fft_r2c")
    if x.device.type == "cpu":
        return fft_r2c_plain(x, packed)
    w = n // 2 if packed else n // 2 + 1
    yr, yi = x.new_empty((B, w)), x.new_empty((B, w))
    if B:
        _launch("fft_r2c", "fft_r2c", x.device,
                [x, yr, yi, B, int(packed),
                 *_r2c_walk_args(n, False, 1.0, x.device)])
    return yr, yi


def _r2c_walk_args(n: int, inverse: bool, scale: float, device):
    """The plans, tables, twiddles (the inverse's scale after them) and
    layout of an `fft_r2c` / `fft_c2r` launch at even length n."""
    n1, n2 = r2c_split(n)
    p1, t1 = _plan(n1, inverse, 1.0, device, True)
    p2, t2 = _plan(n2, inverse, 1.0, device, True)
    tw = device_array(("r2c_twiddle", n, inverse), device,
                      lambda: r2c_twiddle(n, inverse))
    return (p1, p2, t1, t2, tw, *((scale,) if inverse else ()),
            *r2c_layout(n))


def fft_c2r(re: torch.Tensor, im: torch.Tensor, n: int, scale: float = 1.0,
            packed: bool = False) -> torch.Tensor:
    """Real (B, n) float32 lines from their half spectrum planes, (B,
    n/2+1) or ``packed`` (B, n/2), scaled by (n/2)*``scale`` (``scale=2/n``
    gives numpy ``irfft``).  Im(DC) and Im(Nyquist) are not read, as numpy
    ignores them.  CPU tensors run `fft_c2r_plain`; CUDA tensors launch the
    kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:2507 _c2r_kernel``; bound and
    design as `fft_r2c`, backwards: the untangle before the first stage
    (``csrc/fft_r2c.cu``)."""
    _check_planes(re, im, 2, "fft_c2r")
    _check_r2c_length(n)
    _check_spectrum(re, im, n, packed, "fft_c2r")
    if re.device.type == "cpu":
        return fft_c2r_plain(re, im, n, scale, packed)
    B = re.shape[0]
    y = re.new_empty((B, n))
    if B:
        _launch("fft_r2c", "fft_c2r", re.device,
                [re, im, y, B, int(packed),
                 *_r2c_walk_args(n, True, scale, re.device)])
    return y


def packed_to_numpy_layout(re: torch.Tensor, im: torch.Tensor):
    """(B, m) packed half spectrum -> (B, m+1) numpy ``rfft`` layout
    (``pallas_engine.py:2712``)."""
    nyq = im[:, :1]
    zero = torch.zeros_like(nyq)
    return (torch.cat([re, nyq], -1), torch.cat([zero, im[:, 1:], zero], -1))


def numpy_to_packed_layout(re: torch.Tensor, im: torch.Tensor):
    """(B, m+1) numpy ``rfft`` layout -> (B, m) packed half spectrum, the
    imaginary parts of DC and Nyquist dropped (``pallas_engine.py:2721``)."""
    return re[:, :-1], torch.cat([re[:, -1:], im[:, 1:-1]], -1)


def fft_r2c_pair(x: torch.Tensor):
    """numpy ``rfft2`` (re, im) of the two minor axes of real (B, ny, nz)
    float32 ``x``, nz even, as (B, ny, nz/2+1) planes, in one pass.  CPU
    tensors run `fft_r2c_pair_plain`; CUDA tensors launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:3204 _r2c_pair_kernel``.
    Bound by bytes (4 B a real point, 8 B a bin, for both axes); a cluster
    (`r2c_pair_layout`) holds each plane once on the walk of
    ``csrc/inplace.cuh``: the rows as nz/2 complex pairs, untangled in the
    exchange of the tiles between its blocks over distributed shared
    memory, the y stages down the columns, the DC and Nyquist columns
    riding one complex column (``csrc/fft_r2c_pair.cu``); the planes are
    those `r2c_pair_cluster` serves."""
    _check_real(x, 3, "fft_r2c_pair")
    B, ny, nz = x.shape
    _pair_gate(ny, nz)
    _check_aligned(x, "fft_r2c_pair")
    if x.device.type == "cpu":
        return fft_r2c_pair_plain(x)
    yr = x.new_empty((B, ny, nz // 2 + 1))
    yi = torch.empty_like(yr)
    if B:
        _launch("fft_r2c_pair", "fft_r2c_pair", x.device,
                [x, yr, yi, B, *_r2c_pair_args(ny, nz, False, 1.0, x.device),
                 *r2c_pair_layout(ny, nz)])
    return yr, yi


def _r2c_pair_args(ny: int, nz: int, inverse: bool, scale_y: float,
                   device):
    """The plans, tables and twiddles of an `fft_r2c_pair` /
    `fft_c2r_pair` launch (scale_y in the y twiddle), before the
    inverse's scale_z and the layout."""
    (n1z, n2z), (n1y, n2y) = r2c_pair_splits(ny, nz)
    plans = [_plan(k, inverse, 1.0, device, True)
             for k in (n1z, n2z, n1y, n2y)]
    twz = device_array(("r2c_twiddle", nz, inverse), device,
                       lambda: r2c_twiddle(nz, inverse))
    twy = device_array(("twofactor_pair", ny, inverse, scale_y), device,
                       lambda: twofactor_twiddle_pair(ny, inverse, scale_y))
    return (*(p for p, _ in plans), *(t for _, t in plans), twz, twy)


def fft_c2r_pair(re: torch.Tensor, im: torch.Tensor, nz: int,
                 scale_y: float = 1.0, scale_z: float = 1.0) -> torch.Tensor:
    """Real (B, ny, nz) float32 planes from their (B, ny, nz/2+1) half
    spectrum, in one pass, scaled by ny*``scale_y`` * (nz/2)*``scale_z``
    (``scale_y=1/ny``, ``scale_z=2/nz`` give numpy ``irfft2``).  Im(DC)
    and Im(Nyquist) of the z axis are read as numpy reads them (their
    Hermitian parts).  CPU tensors run `fft_c2r_pair_plain`; CUDA tensors
    launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:3229 _c2r_pair_kernel``;
    bound and design as `fft_r2c_pair`, backwards: the y stages, the
    exchange, the untangle with the scale, the z stages."""
    _check_planes(re, im, 3, "fft_c2r_pair")
    B, ny, _ = re.shape
    _pair_gate(ny, nz)
    _check_spectrum(re, im, nz, False, "fft_c2r_pair")
    if re.device.type == "cpu":
        return fft_c2r_pair_plain(re, im, nz, scale_y, scale_z)
    y = re.new_empty((B, ny, nz))
    if B:
        _launch("fft_r2c_pair", "fft_c2r_pair", re.device,
                [re, im, y, B, *_r2c_pair_args(ny, nz, True, scale_y,
                                               re.device),
                 scale_z, *r2c_pair_layout(ny, nz)])
    return y


def _pair_gate(ny: int, nz: int) -> None:
    _check_length(ny)
    _check_r2c_length(nz)
    if r2c_pair_cluster(ny, nz) is None:
        raise _no_cluster("fft_r2c_pair", ny, nz)


# ---------------------------------------------------------------------------
# Convolution and two-factor wrappers (Rader, Bluestein and the lengths
# beyond `fft_lines`).
# ---------------------------------------------------------------------------

def _table_length(tab, what: str) -> int:
    if not isinstance(tab, torch.Tensor):
        raise TypeError(f"{what}: the table must be a torch tensor")
    return tab.shape[0]


def _check_table(tab, length: int, like: torch.Tensor, what: str) -> None:
    _table_length(tab, what)
    if (tuple(tab.shape) != (length, 2) or tab.dtype != torch.float32
            or not tab.is_contiguous()):
        raise ValueError(f"{what}: the table must be a contiguous float32 "
                         f"({length}, 2) tensor, got {tuple(tab.shape)} "
                         f"{tab.dtype}")
    if tab.device != like.device:
        raise ValueError(f"{what}: table on {tab.device}, planes on "
                         f"{like.device}")


def _two_plans(n: int, inverse: bool, device, split=None):
    n1, n2 = split or twofactor_split(n)
    p1, t1 = _plan(n1, inverse, 1.0, device)
    p2, t2 = _plan(n2, inverse, 1.0, device)
    return p1, p2, t1, t2


def _check_twofactor(n: int, what: str) -> None:
    if not twofactor_supports(n):
        raise NotImplementedError(
            f"{what}: length {n} is outside the two-factor kernels' range "
            f"(2 <= n <= {TWOFACTOR_MAX_N}, prime factors <= "
            f"{MAX_DIRECT_PRIME}); the engine runs longer lines on the long "
            "tier (cuda_engine.fft_long_p)")


def _conv_flags(conj_data: bool, xpow: bool) -> int:
    return (CONV_CONJ_DATA if conj_data else 0) | (CONV_XPOW if xpow else 0)


def _check_read_window(in_keep, n: int, what: str) -> int:
    """Bluestein's read window: the kept prefix ``in_keep`` of lines of n
    points, 1 <= in_keep <= n (0: none)."""
    in_keep = int(in_keep or 0)
    if not 0 <= in_keep <= n:
        raise ValueError(f"{what}: a read window of {in_keep} points of "
                         f"{n} (1 <= in_keep <= {n}; 0 for none)")
    return in_keep


def fft_conv(re: torch.Tensor, im: torch.Tensor, spectrum: torch.Tensor,
             chirp: Optional[torch.Tensor] = None, out=None,
             conj_data: bool = False, xpow: bool = False, scale: float = 1.0,
             in_keep: int = 0):
    """Circular convolution of each line of float32, float16 or bfloat16
    planes with a fixed kernel given by its spectrum: the inverse DFT,
    times ``scale``, of DFT(x) times the spectrum (an (L, 2) table,
    natural order).  Modes, by
    the planes' shape and the table's length L:

    * (B, n) planes, L = rows * n: line j times row j % rows (rows = 1: the
      scalar mode of Rader's convolution, `rader_spectrum`);
    * (B, mm, n) planes, mm = 2 or 3, L = mm * mm * n: out[o] = IDFT(sum_i
      K[o, i] DFT(x_i)) (`conv_matrix_supports`);
    * ``chirp`` (an (n, 2) table) and (B, n) planes, n < m = L: the
      Bluestein mode, the lines times the chirp, zero-padded to m,
      convolved, cropped to n and times the chirp again
      (`bluestein_chirp`, `bluestein_spectrum`).

    ``conj_data`` negates Im of DFT(x) before the multiply; ``xpow``
    divides the product by its modulus (cross-power spectrum).  ``scale``
    rides the inverse stages, after the multiply.
    ``out`` as for `fft_lines`.  CPU tensors run `fft_conv_plain`; CUDA
    tensors launch the kernel (float16 / bfloat16: its half-storage
    instantiation, every mode, the tables fp32, computing in fp32).

    Replaces ``vkfft_tpu/ops/pallas_engine.py:4579 _conv_v3_kernel`` in all
    its modes.  Bound by bytes (16 B a point of the planes, one read and
    one write, 8 B on half planes, and the table once a launch): a block
    holds its lines once each in shared memory (`conv_layout`: whole items
    of mm lines in the matrix mode) and runs the forward and the inverse
    passes of the walk in place, the multiply in one sweep between them;
    the pad never exists in device memory (``csrc/fft_conv.cu``).

    ``in_keep`` (the Bluestein mode; 1 <= in_keep <= n, 0 for none):
    Bluestein's read window, the windowed entry ``vk_fft_conv_zp`` (and its
    half twins, counted in `zp_launches`), which replaces
    ``_conv_v3_kernel``'s blu_in: only the first in_keep points of each
    line are read, the rest declared zero, and every n points written."""
    matrix = re.ndim == 3
    _check_planes(re, im, 3 if matrix else 2, "fft_conv", _HALF_DTYPES)
    mm = re.shape[1] if matrix else 1
    B, n = re.shape[0], re.shape[-1]
    L = _table_length(spectrum, "fft_conv")
    m = L if chirp is not None else n
    _check_length(m)
    rows = 1 if chirp is not None or matrix else L // n
    _check_table(spectrum, L, re, "fft_conv")
    if chirp is not None:
        if matrix or not 1 <= n < m:
            raise ValueError(f"fft_conv: Bluestein lines of {n} points pad "
                             f"to a longer spectrum than {m}")
        if conj_data or xpow:
            raise ValueError("fft_conv: the Bluestein mode has no "
                             "conj_data or xpow")
        _check_table(chirp, n, re, "fft_conv chirp")
        in_keep = _check_read_window(in_keep, n, "fft_conv")
    elif in_keep:
        raise ValueError("fft_conv: a read window needs the Bluestein mode")
    elif matrix:
        if L != mm * mm * n:
            raise ValueError(f"fft_conv: a ({mm}, {mm}, {n}) matrix "
                             f"spectrum has {mm * mm * n} points, got {L}")
        if not conv_matrix_supports(n, mm):
            raise NotImplementedError(
                f"fft_conv: {mm} coordinate lines of {n} points do not fit "
                "one block (mm = 2 or 3, two buffers within "
                f"{MAX_SMEM_BYTES} B of shared memory)")
    elif L % n:
        raise ValueError(f"fft_conv: lines of {n} points, a spectrum of {L}")

    def args():
        n1, n2 = conv_split(m, mm)
        pf1, tf1 = _plan(n1, False, 1.0, re.device, True)
        pf2, tf2 = _plan(n2, False, 1.0, re.device, True)
        pi1, ti1 = _plan(n1, True, 1.0, re.device, True)
        pi2, ti2 = _plan(n2, True, 1.0, re.device, True)
        twf = device_array(("twofactor_pair", m, False, 1.0), re.device,
                           lambda: twofactor_twiddle_pair(m, False))
        twi = device_array(("twofactor_pair", m, True, scale), re.device,
                           lambda: twofactor_twiddle_pair(m, True, scale))
        return (B * mm, n, mm, rows, _conv_flags(conj_data, xpow), pf1, pf2,
                pi1, pi2, tf1, tf2, ti1, ti2, twf, twi, spectrum, chirp,
                *conv_layout(m, mm)) + ((in_keep,) if in_keep else ())

    return _apply("fft_conv", re, im, out,
                  lambda: fft_conv_plain(re, im, spectrum, chirp, conj_data,
                                         xpow, scale, in_keep), args,
                  entry="fft_conv_zp" if in_keep else None)


def fft_twofactor(re: torch.Tensor, im: torch.Tensor, inverse: bool = False,
                  scale: float = 1.0, swapped: bool = False, out=None,
                  window: Optional[LineWindow] = None,
                  split: Optional[tuple] = None):
    """DFT of each line of (B, n) float32, float16 or bfloat16 planes, n =
    n1*n2 (``split``, default `twofactor_split`; the keep_intermediate_order
    route passes `split_lane_major`), times ``scale``.  The forward reads
    natural order and writes natural order, or with ``swapped`` the digit
    order [k2][k1] (position k2*n1 + k1 holds bin k1*n2 + k2); the inverse
    reads natural or, with ``swapped``, that order and writes natural
    order.  ``out`` as for `fft_lines`.  CPU tensors run
    `fft_twofactor_plain`; CUDA tensors launch the kernel (float16 /
    bfloat16: its half-storage instantiation, computing in fp32).

    Replaces ``vkfft_tpu/ops/pallas_engine.py:897 _fft_kernel_v2``.  Bound
    by bytes (16 B a point, one read and one write; 8 B on half planes): a
    block holds its
    lines once each in shared memory (`twofactor_layout`: at most 134 KB,
    at 16384; two blocks an SM at 7918, 10240 and 12288) and runs the
    n2-point column DFTs and the n1-point row DFTs in place on the whole
    line, the twiddle computed from its exponent in the last stage's
    write (``csrc/fft_twofactor.cu``).

    A zero-pad ``window``, natural order (not with ``swapped``), as for
    `fft_lines`: the windowed entry ``vk_fft_twofactor_zp`` (float32 and
    the half dtypes), which replaces ``_fft_kernel_v2``'s in_nonzero and
    out_keep."""
    if window is not None:
        n = window.n
        if swapped:
            raise ValueError("fft_twofactor: windows run natural order")
        _check_twofactor(n, "fft_twofactor")

        def layout():
            p1, p2, t1, t2 = _two_plans(n, inverse, re.device)
            tw = _twiddle_pair(n, inverse, scale, re.device)
            return (p1, p2, t1, t2, tw, *twofactor_layout(n))

        return _windowed_lines("fft_twofactor", re, im, inverse, scale, out,
                               window, _HALF_DTYPES, layout,
                               lambda: fft_twofactor_plain(
                                   re, im, inverse, scale, window=window))
    _check_planes(re, im, 2, "fft_twofactor", _HALF_DTYPES)
    B, n = re.shape
    _check_twofactor(n, "fft_twofactor")
    split = _check_split(n, split, "fft_twofactor")

    def args():
        p1, p2, t1, t2 = _two_plans(n, inverse, re.device, split)
        tw = _twiddle_pair(n, inverse, scale, re.device)
        return (B, p1, p2, t1, t2, tw, int(swapped),
                *twofactor_layout(n, split))

    return _apply("fft_twofactor", re, im, out,
                  lambda: fft_twofactor_plain(re, im, inverse, scale, swapped,
                                              split=split),
                  args)


def fft_conv_inv(re: torch.Tensor, im: torch.Tensor, spectrum: torch.Tensor,
                 dc=None, out=None, scale: float = 1.0):
    """Natural-order (B, n) float32, float16 or bfloat16 planes from a
    spectrum in
    `fft_twofactor`'s swapped order: the spectrum times ``spectrum`` (an
    (n, 2) table in the same swapped order, `rader_spectrum(...,
    layout="swapped")`), the two-factor inverse times ``scale`` (riding its
    twiddle), plus the per-line constant ``dc`` = (re, im), float32 (B,)
    tensors (float32 on every dtype of the planes), when given.
    ``out`` as for `fft_lines`.  CPU tensors run `fft_conv_inv_plain`;
    CUDA tensors launch the kernel (float16 / bfloat16: its half-storage
    instantiation, computing in fp32).

    Replaces ``vkfft_tpu/ops/pallas_engine.py:4421 _conv_inv_kernel``
    (``has_dc`` is ``dc``).  Bound by bytes, as `fft_twofactor`, whose
    block it runs at its layout (`twofactor_layout`): the lines read once
    into swapped positions, the multiply in one sweep over shared memory,
    the mirrored passes in place and the constant on the write
    (``csrc/fft_conv_inv.cu``)."""
    _check_planes(re, im, 2, "fft_conv_inv", _HALF_DTYPES)
    B, n = re.shape
    _check_twofactor(n, "fft_conv_inv")
    _check_table(spectrum, n, re, "fft_conv_inv")
    if dc is not None:
        for t in dc:
            _check_real(t, 1, "fft_conv_inv dc")
            if t.shape[0] != B or t.device != re.device:
                raise ValueError("fft_conv_inv: dc must be (B,) tensors on "
                                 "the planes' device")

    def args():
        p1, p2, t1, t2 = _two_plans(n, True, re.device)
        tw = device_array(("twofactor_pair", n, True, scale), re.device,
                           lambda: twofactor_twiddle_pair(n, True, scale))
        d = dc if dc is not None else (None, None)
        return (B, p1, p2, t1, t2, tw, spectrum, d[0], d[1],
                *twofactor_layout(n))

    return _apply("fft_conv_inv", re, im, out,
                  lambda: fft_conv_inv_plain(re, im, spectrum, dc, scale),
                  args)


def fft_conv_pair(re: torch.Tensor, im: torch.Tensor, spectrum: torch.Tensor,
                  chirp: Optional[torch.Tensor] = None, out=None,
                  conj_data: bool = False, xpow: bool = False,
                  scale: float = 1.0, in_keep=None, out_keep=None,
                  plane: Optional[tuple] = None):
    """A plane held in a thread-block cluster, in one of two modes.

    With ``chirp`` (an (n, 2) table), the Bluestein mode: each line of (B,
    n) float32, float16 or bfloat16 planes through a padded length m =
    len(spectrum) that `conv_pair_plan` splits into an (nc, ns) plane: the
    lines times the chirp, zero-padded to m, convolved with the spectrum
    (an (m, 2) table in the plane order, `bluestein_spectrum(...,
    layout="pair")`), cropped to n and times the chirp again.

    Without, the 2-D mode: each (ny, nz) plane of (B, ny, nz) float32,
    float16 or bfloat16 planes circularly convolved with a fixed kernel,
    the inverse 2-D DFT, times ``scale``, of its 2-D DFT (conjugated with
    ``conj_data``) times spectrum b % hp of the (hp * ny * nz, 2) table in
    natural (hp, ny, nz) order, divided by its modulus with ``xpow``; the
    plane must fit a cluster (`pair_cluster`).

    ``out`` as for `fft_lines`.  CPU tensors run `fft_conv_pair_plain`;
    CUDA tensors launch the kernel (on float16 / bfloat16 planes its
    half-storage instantiation, computing in fp32: ``vk_fft_conv_pair_f16``
    and ``_bf16`` in the Bluestein mode, ``vk_fft_conv2d_f16`` and
    ``_bf16`` in the 2-D mode, at the fp32 layouts).

    Replaces ``vkfft_tpu/ops/pallas_engine.py:2205 _conv_pair_kernel`` in
    both its modes.  Bluestein: bound by bytes at sample 7's 10007 (16 B a
    point of the line, one read and one write; the two m-point FFTs stand
    apart); the cluster holds the padded line once as a plane, each block
    running the nc and ns stages in place on its tile with the four-step
    twiddle and the spectrum on the last stage of the pass before them,
    the tiles exchanged in whole rounds over distributed shared memory.
    2-D: bound by bytes (16 B a point, one read and one write, and the
    spectrum once a launch); `fft_pair`'s plane (`conv2d_layout`) on the
    walk: each block reads its row tile, runs the nz stages, pushes the
    tile to the column tiles over distributed shared memory, runs the ny
    stages, multiplies in one sweep, and runs the inverse (the forward
    stages on conjugated data) back to its row tile, which it writes
    (``csrc/fft_conv_pair.cu``).

    Zero-pad corners of the 2-D mode (``in_keep`` = (ky, kz): only that
    corner of each plane is read, the rest declared zero; ``out_keep`` =
    (oy, oz): only that corner is written, (B, oy, oz) planes; 0 for an
    axis without a keep) launch its windowed entry (``vk_fft_conv2d_zp``
    and its half twins, counted in `zp_launches`), which replaces
    ``_conv_pair_kernel``'s in_keep / out_keep: the planes may then be a
    view (B, Ry, Rz) with its last dim contiguous, a corner of wider
    planes read in place or the corner itself, of the (ny, nz) ``plane``
    (default (Ry, Rz)); the rows past ky skip the forward's z stages, the
    rows past oy the inverse's.

    In the Bluestein mode ``in_keep`` (1 <= in_keep <= n, 0 or None for
    none) is Bluestein's read window: the windowed entry
    ``vk_fft_conv_pair_zp`` (and its half twins, counted in `zp_launches`),
    which replaces ``_conv_pair_kernel``'s in_keep in its Bluestein form,
    reads only the first in_keep points of each line (the rest declared
    zero) and writes every n points."""
    if chirp is None and (in_keep is not None or out_keep is not None
                          or plane is not None):
        return _fft_conv2d_window(re, im, spectrum, out, conj_data, xpow,
                                  scale, in_keep or (0, 0),
                                  out_keep or (0, 0), plane)
    if chirp is None:
        return _fft_conv2d(re, im, spectrum, out, conj_data, xpow, scale)
    _check_planes(re, im, 2, "fft_conv_pair", _HALF_DTYPES)
    B, n = re.shape
    m = _table_length(spectrum, "fft_conv_pair")
    if conv_pair_plan(m) is None:
        raise NotImplementedError(
            f"fft_conv_pair: a padded length {m} that fits no cluster plane "
            "(m <= 2^16); the engine runs longer Bluestein lengths on the "
            "long tier (cuda_engine.route)")
    layout = conv_pair_layout(m)
    nc, ns = layout[:2]
    _check_table(spectrum, m, re, "fft_conv_pair")
    if not 1 <= n < m:
        raise ValueError(f"fft_conv_pair: lines of {n} points for a padded "
                         f"length {m}")
    if conj_data or xpow or scale != 1.0 or out_keep is not None \
            or plane is not None:
        raise ValueError("fft_conv_pair: the Bluestein mode has no "
                         "conj_data, xpow, scale (the scale rides the "
                         "spectrum), out_keep or plane")
    _check_table(chirp, n, re, "fft_conv_pair chirp")
    in_keep = _check_read_window(in_keep, n, "fft_conv_pair")

    def args():
        dev = re.device
        pcf, tcf = _plan(nc, False, 1.0, dev, True)
        psf, tsf = _plan(ns, False, 1.0, dev, True)
        psi, tsi = _plan(ns, True, 1.0, dev, True)
        pci, tci = _plan(nc, True, 1.0, dev, True)
        tw = device_array(("twofactor_pair", m, False, 1.0), dev,
                           lambda: twofactor_twiddle_pair(m, False))
        return (B, n, pcf, psf, psi, pci, tcf, tsf, tsi, tci, tw, spectrum,
                chirp, *layout[2:]) + ((in_keep,) if in_keep else ())

    return _apply("fft_conv_pair", re, im, out,
                  lambda: fft_conv_pair_plain(re, im, spectrum, chirp,
                                              in_keep=in_keep), args,
                  entry="fft_conv_pair_zp" if in_keep else None)


def _fft_conv2d(re, im, spectrum, out, conj_data: bool, xpow: bool,
                scale: float):
    """The 2-D mode of `fft_conv_pair` (C entry ``vk_fft_conv2d``; on half
    planes ``vk_fft_conv2d_f16`` / ``_bf16``, at the same layout and fp32
    tables and spectrum)."""
    _check_planes(re, im, 3, "fft_conv_pair", _HALF_DTYPES)
    B, ny, nz = re.shape
    _check_length(ny)
    _check_length(nz)
    if pair_cluster(ny, nz) is None:
        raise _no_cluster("fft_conv_pair", ny, nz)
    L = _table_length(spectrum, "fft_conv_pair")
    if L % (ny * nz) or not L:
        raise ValueError(f"fft_conv_pair: a spectrum of (hp, {ny}, {nz}) "
                         f"points, got {L}")
    _check_table(spectrum, L, re, "fft_conv_pair")
    return _apply("fft_conv_pair", re, im, out,
                  lambda: fft_conv_pair_plain(re, im, spectrum, None,
                                              conj_data, xpow, scale),
                  lambda: (B, *_conv2d_args(ny, nz, L, spectrum, conj_data,
                                            xpow, scale, re.device)),
                  entry="fft_conv2d")


def _conv2d_args(ny: int, nz: int, L: int, spectrum, conj_data: bool,
                 xpow: bool, scale: float, dev) -> tuple:
    """The 2-D mode's launch arguments after the batch: hp, flags, scale,
    the plans, tables and twiddles of its axes' factors, the spectrum,
    then its layout (`conv2d_layout`)."""
    c, threads, smem, ((n1z, n2z), (n1y, n2y)) = conv2d_layout(ny, nz)
    plans = [_plan(k, False, 1.0, dev, True) for k in (n1z, n2z, n1y, n2y)]
    tw = [device_array(("twofactor_pair", k, False, 1.0), dev,
                       lambda k=k: twofactor_twiddle_pair(k, False))
          for k in (nz, ny)]
    return (L // (ny * nz), _conv_flags(conj_data, xpow), scale,
            *(p for p, _ in plans), *(t for _, t in plans), *tw,
            spectrum, c, threads, smem)


def _fft_conv2d_window(re, im, spectrum, out, conj_data: bool, xpow: bool,
                       scale: float, in_keep, out_keep, plane):
    """The windowed 2-D mode of `fft_conv_pair` (C entry
    ``vk_fft_conv2d_zp``, its PairWindow)."""
    what = "fft_conv_pair"
    _check_view(re, im, what, _HALF_DTYPES, (3,))
    B, Ry, Rz = re.shape
    ny, nz = plane or (Ry, Rz)
    _check_length(ny)
    _check_length(nz)
    if pair_cluster(ny, nz) is None:
        raise _no_cluster(what, ny, nz)
    ky = _check_keep(in_keep[0], ny, what) or ny
    kz = _check_keep(in_keep[1], nz, what) or nz
    oy = _check_keep(out_keep[0], ny, what) or ny
    oz = _check_keep(out_keep[1], nz, what) or nz
    if Ry not in (ny, ky) or Rz not in (nz, kz):
        raise ValueError(f"{what}: ({Ry}, {Rz}) planes for a ({ky}, {kz}) "
                         f"corner of ({ny}, {nz})")
    L = _table_length(spectrum, what)
    if L % (ny * nz) or not L:
        raise ValueError(f"{what}: a spectrum of (hp, {ny}, {nz}) points, "
                         f"got {L}")
    _check_table(spectrum, L, re, what)
    shape = (B, oy, oz)
    _window_out(re, im, out, shape)
    window = (ny, nz, ky, kz, oy, oz)
    if re.device.type == "cpu":
        yr, yi = fft_conv_pair_plain(re, im, spectrum, None, conj_data, xpow,
                                     scale, window=window)
        if out is None:
            return yr, yi
        out[0].copy_(yr)
        out[1].copy_(yi)
        return out
    yr, yi = out if out is not None else (re.new_empty(shape),
                                          im.new_empty(shape))
    if B:
        win = (ctypes.c_longlong * 8)(re.stride(0) if B > 1 else 0, oy * oz,
                                      re.stride(1) if Ry > 1 else Rz, oz,
                                      ky, kz, oy, oz)
        _launch(what, "fft_conv2d_zp" + _SUFFIX[re.dtype], re.device,
                [re, im, yr, yi, B,
                 *_conv2d_args(ny, nz, L, spectrum, conj_data, xpow, scale,
                               re.device), win], re.dtype)
    return yr, yi


# ---------------------------------------------------------------------------
# Real-to-real wrappers (DCT/DST types I-IV).
# ---------------------------------------------------------------------------

def _r2r_gate(ok: bool, what: str, n: int, rule: str) -> None:
    if not ok:
        raise NotImplementedError(
            f"{what}: length {n} is outside the kernel's range ({rule}, "
            f"the stage length <= {KERNEL_MAX_N} with prime factors <= "
            f"{KERNEL_MAX_PRIME}); the CUDA engine runs other lengths as the "
            "composition onto its FFT kernels (transforms/r2r.py)")


# The library of each R2R type's kernel.
DCT_LIBRARIES = {1: "fft_dct1", 2: "fft_dct23", 3: "fft_dct23", 4: "fft_dct4"}


def _dct_walk_args(n: int, type: int, scale: float, device,
                   dst: bool = False):
    """The plans, tables, twiddles and layout of an `fft_dct23` (type 2 or
    3), `fft_dct1` (type 1; DST-I with ``dst``) or `fft_dct4` (type 4)
    launch at length n."""
    inverse = type == 3
    if type == 1:
        n1, n2 = dct_split(dct1_length(n, dst), True)
        tw = device_array(("dct1_twiddle", n, dst, scale), device,
                          lambda: dct1_twiddle(n, dst, scale))
        layout = dct1_layout(n, dst)
    elif type == 4:
        n1, n2 = dct_split(dct4_points(n), True)
        tw = device_array(("dct4_twiddle", n, scale), device,
                          lambda: dct4_twiddle(n, scale))
        layout = dct4_layout(n)
    else:
        n1, n2 = dct_split(n)
        tw = device_array(("dct23_twiddle", n, inverse, scale), device,
                          lambda: dct23_twiddle(n, inverse, scale))
        layout = dct23_layout(n)
    p1, t1 = _plan(n1, inverse, 1.0, device, True)
    p2, t2 = _plan(n2, inverse, 1.0, device, True)
    return (p1, p2, t1, t2, tw, *layout)


def _dct_walk(x: torch.Tensor, type: int, dst: bool, scale: float, plain):
    """Shared body of `fft_dct1`, `fft_dct2`, `fft_dct3` and `fft_dct4`:
    ``plain()`` for a CPU tensor, else one launch on a fresh (B, n)
    output."""
    what = f"fft_dct{type}"
    _check_real(x, 2, what)
    n = x.shape[1]
    if type == 1:
        _r2r_gate(dct1_supports(n, dst), what, n, "n >= 3")
    else:
        _r2r_gate((dct4_supports if type == 4 else dct23_supports)(n), what,
                  n, "n >= 4")
    if type == 4 and n % 2 == 0:
        _check_aligned(x, what)
    if x.device.type == "cpu":
        return plain()
    y = torch.empty_like(x)
    if x.shape[0]:
        lead = (n, int(dst)) if type == 4 else (int(dst),)
        _launch(DCT_LIBRARIES[type], what, x.device,
                [x, y, x.shape[0], *lead,
                 *_dct_walk_args(n, type, scale, x.device, dst)])
    return y


def fft_dct2(x: torch.Tensor, dst: bool = False,
             scale: float = 1.0) -> torch.Tensor:
    """Unnormalized DCT-II (``dst``: DST-II) of each real line of (B, n)
    float32 ``x``, times ``scale``.  CPU tensors run `fft_dct23_plain`; CUDA
    tensors launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:2745 _dct2_kernel``.  Bound
    by bytes (4 B a point in, 4 B out).  Two lines ride one n-point
    complex pipeline: a block reads its lines by cp.async straight into
    Makhoul's order, runs the stages in place on the walk of
    ``csrc/inplace.cuh`` (`dct23_layout`), and writes each output from
    its two bins Z[k], Z[n-k], split and rotated (``csrc/fft_dct23.cu``)."""
    return _dct_walk(x, 2, dst, scale,
                     lambda: fft_dct23_plain(x, False, dst, scale))


def fft_dct3(x: torch.Tensor, dst: bool = False,
             scale: float = 1.0) -> torch.Tensor:
    """Unnormalized DCT-III (``dst``: DST-III) of each real line of (B, n)
    float32 ``x``, times ``scale``; ``scale=1/(2n)`` inverts `fft_dct2`.
    CPU tensors run `fft_dct23_plain`; CUDA tensors launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:2789 _dct3_kernel``; bound and
    layout as `fft_dct2`, backwards: the pair's pre-rotation in place after
    the read, the inverse stages, and Makhoul's order undone in the
    write."""
    return _dct_walk(x, 3, dst, scale,
                     lambda: fft_dct23_plain(x, True, dst, scale))


def fft_dct1(x: torch.Tensor, dst: bool = False,
             scale: float = 1.0) -> torch.Tensor:
    """Unnormalized DCT-I (``dst``: DST-I) of each real line of (B, n)
    float32 ``x``, times ``scale``.  CPU tensors run `fft_dct1_plain`; CUDA
    tensors launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:2958 _dct1_kernel``.  Bound
    by bytes (4 B a point in, 4 B out): a block reads its lines by
    cp.async straight into the 2(n -+ 1)-point extension as n -+ 1
    complex points (each float to its point and its mirror), runs the
    stages in place on the walk of ``csrc/inplace.cuh`` (`dct1_layout`)
    and writes the real (DCT) or imaginary (DST) bins, each pair of bins
    taken once for its two outputs (``csrc/fft_dct1.cu``)."""
    return _dct_walk(x, 1, dst, scale,
                     lambda: fft_dct1_plain(x, dst, scale))


def fft_dct4(x: torch.Tensor, dst: bool = False,
             scale: float = 1.0) -> torch.Tensor:
    """Unnormalized DCT-IV (``dst``: DST-IV) of each real line of (B, n)
    float32 ``x``, times ``scale``.  CPU tensors run `fft_dct4_plain`; CUDA
    tensors launch the kernel.

    Replaces ``vkfft_tpu/ops/pallas_engine.py:3080 _dct4_kernel``.  Bound
    by bytes: even n takes the n/2 complex trick, a pre-rotated n/2-point
    pipeline whose two outputs of each bin interleave in the write; odd n a
    real DFT of the same n points, the line permuted with signs (Chan and
    Ho; FFTW's odd REDFT11), two lines riding one complex pipeline, where
    the TPU kernel runs a 2n-point one.  Both on the walk of
    ``csrc/inplace.cuh`` (`dct4_layout`, ``csrc/fft_dct4.cu``)."""
    return _dct_walk(x, 4, dst, scale,
                     lambda: fft_dct4_plain(x, dst, scale))
