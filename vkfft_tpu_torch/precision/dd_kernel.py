"""The double-double FFT kernel: host side, plain versions and wrappers.

Port of ``vkfft_tpu/precision/dd_kernel.py``.  One CUDA C++ source,
``csrc/fft_dd.cu`` (EFTs in ``csrc/dd.cuh``), launched through
`cuda_kernels._launch` and counted as ``launches["fft_dd"]``, has three
launching C entries and ``vk_fft_dd_occupancy`` (`dd_occupancy`):

* ``vk_fft_dd_lines`` (`fft_dd_lines`) replaces
  ``vkfft_tpu/precision/dd_kernel.py:166 _dd_fft_kernel``: the dd DFT of
  each line of (B, n) quad planes, natural order in and out;
* ``vk_fft_dd_strided`` (`fft_dd_strided`) replaces ``:259
  _dd_strided_kernel``: the same along the middle axis of (P, n, S) quad
  planes, S contiguous, no transpose;
* ``vk_dd_pointwise`` (`dd_pointwise`): x * t + c, times a scale, for the
  few dd points no DFT pass carries (Rader's X0).

Both DFT entries take the dd products of the tier as options, where the
JAX package runs them as XLA ops between its kernels: a ``pre`` table
multiplied on the read, a ``post`` table on the write (the four-step
twiddle, the Bluestein chirps and spectra, Rader's spectrum), a per-line
``add`` (Rader's x0) and a dd ``scale`` (the inverse's 1/N), in the order
y = (DFT(x * pre) * post + add) * scale.  A table is (L, 4) float32 quads
(re.hi, re.lo, im.hi, im.lo), split exactly from host fp64, read at each
point's flat position modulo L.

Each DFT entry has two instantiations (`dd_variant`, the one place the
choice is made, passes it to the C entry): DD_POW2, whose stages take
radices 2, 4 and 8 only, for every power of two, built for three resident
blocks an SM; DD_GENERAL, with the odd radices 3..13 too, for every other
length, built for two.  `dd_occupancy` reads a kernel's resident blocks an
SM on the card.

The kernel takes every 13-smooth 2 <= n <= 4096 (`use_dd_kernel`): a line
of 4096 dd points in two shared-memory buffers is 128 KB, which a block
holds; the JAX package stops at 2048 for its VMEM and at radix 8, and runs
11- and 13-smooth lengths in its XLA stage pipeline.  The plain versions
(`dd_lines_plain`, `dd_strided_plain`) are the JAX kernels' stage walk
(``dd_kernel.py:131-163``) in torch: its radices (`dd_radices`), a full r x
r dd DFT per stage with the trivial-coefficient paths of `_coeff_kind`,
the new digit in front.  They share no table with the kernel, which runs
the fp32 kernels' plan (`cuda_kernels.stage_tables`) with its values
split into quads.  `plain_calls` counts their runs; on a card path it
stays 0.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.ops import cuda_kernels as ck
from vkfft_tpu_torch.planner.factorize import _group_radices, prime_factors
from vkfft_tpu_torch.planner.plan import build_stages
from vkfft_tpu_torch.precision.doubledouble import (DDComplex, dd_scalar,
                                                     split_scalar)

DD_KERNEL_MAX_N = 4096   # two buffers of 16 B points in a block: 128 KB
DD_MAX_PRIME = 13        # largest prime a stage of either walk takes
_DD_MAX_RADIX = 8        # the JAX walk's largest grouped radix
# The kernel's instantiations (kPow2, kGeneral in csrc/fft_dd.cu): the
# radices each one's stages take, and its DFT entries (kLines, kStrided).
DD_POW2, DD_GENERAL = 0, 1
DD_VARIANT_RADICES = {DD_POW2: frozenset((2, 4, 8)),
                      DD_GENERAL: frozenset((2, 3, 4, 5, 7, 8, 11, 13))}
DD_LINES, DD_STRIDED = 0, 1
_MAX_TABLE_LEN = (1 << 31) - 1  # the kernel walks a table with 32-bit ints

# Runs of the plain versions (`dd_lines_plain`, `dd_strided_plain`,
# `dd_pointwise_plain`), counted where they run.
plain_calls = 0


def _is_smooth(n: int) -> bool:
    return n == 1 or prime_factors(n)[-1] <= DD_MAX_PRIME


def use_dd_kernel(n: int) -> bool:
    """Whether `fft_dd_lines` and `fft_dd_strided` take length n: a
    13-smooth 2 <= n <= 4096."""
    return 2 <= n <= DD_KERNEL_MAX_N and _is_smooth(n)


@functools.lru_cache(maxsize=4096)
def dd_variant(n: int) -> int:
    """The instantiation of `fft_dd_lines`/`fft_dd_strided` that runs
    length n: DD_POW2 when every radix of the kernel's plan
    (`cuda_kernels.stage_radices`, the radices of `stage_tables`) is 2, 4
    or 8, which is every power of two, else DD_GENERAL.  The one place the
    choice is made; the C entry refuses a plan with a radix outside the
    variant it is given."""
    if not use_dd_kernel(n):
        raise _no_kernel("dd_variant", n)
    radices = set(ck.stage_radices(n))
    return (DD_POW2 if radices <= DD_VARIANT_RADICES[DD_POW2]
            else DD_GENERAL)


def dd_occupancy(variant: int, entry: int, n: int) -> int:
    """Resident blocks an SM of the kernel that ``variant`` and ``entry``
    (DD_LINES, DD_STRIDED) launch for length n at its widest block, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current card
    (C entry ``vk_fft_dd_occupancy``)."""
    fn = ck._library("fft_dd").vk_fft_dd_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(variant, entry, n, ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"vk_fft_dd_occupancy({variant}, {entry}, {n}) "
                           f"failed: CUDA error {err}")
    return blocks.value


def _no_kernel(what: str, n: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: length {n} is outside the dd kernel's range (13-smooth, "
        f"2 <= n <= {DD_KERNEL_MAX_N}); dd_fft.dd_route names the route of "
        "other lengths")


# ---------------------------------------------------------------------------
# Tables.
# ---------------------------------------------------------------------------

def quads(c) -> np.ndarray:
    """Complex128 values as (L, 4) float32 quads (re.hi, re.lo, im.hi,
    im.lo), each part split exactly from fp64."""
    c = np.asarray(c, np.complex128).ravel()
    out = np.empty((c.size, 4), np.float32)
    for k, part in ((0, c.real), (2, c.imag)):
        hi = part.astype(np.float32)
        out[:, k] = hi
        out[:, k + 1] = (part - hi.astype(np.float64)).astype(np.float32)
    return out


_DEVICE_QUADS: dict = {}


def device_quads(key: tuple, device, build) -> torch.Tensor:
    """Cached (L, 4) float32 device copy of the `quads` of the complex128
    values ``build()`` returns."""
    key = key + (str(torch.device(device)),)
    tab = _DEVICE_QUADS.get(key)
    if tab is None:
        tab = torch.from_numpy(quads(build())).to(device)
        _DEVICE_QUADS[key] = tab
    return tab


def quads_of(x: DDComplex) -> torch.Tensor:
    """dd points of any shape as (L, 4) quads (a copy)."""
    return torch.stack([p.reshape(-1) for p in x.planes()], dim=1).contiguous()


def ddc_of_quads(t: torch.Tensor) -> DDComplex:
    """(L, 4) quads as a length-L `DDComplex` (views)."""
    return DDComplex.of([t[:, k] for k in range(4)])


@functools.lru_cache(maxsize=256)
def dd_radices(n: int) -> tuple[int, ...]:
    """Stage radices of the JAX package's dd walk (``dd_fft._dd_radices``):
    primes above 8 first, then the rest grouped up to radix 8."""
    primes = prime_factors(n)
    big = tuple(sorted((p for p in primes if p > _DD_MAX_RADIX), reverse=True))
    small = [p for p in primes if p <= _DD_MAX_RADIX]
    return big + tuple(_group_radices(small, _DD_MAX_RADIX))


@functools.lru_cache(maxsize=256)
def dd_stage_tables(n: int, inverse: bool):
    """Per stage of the plain walk: (r, L, Mp, the r x r DFT matrix, the
    (r, Mp) twiddles as four fp32 planes split exactly from fp64, or None
    where Mp = 1) (``dd_kernel.py:101-119`` of the JAX package)."""
    stages = []
    for st in build_stages(n, dd_radices(n)):
        D = luts.dft_matrix(st.r, inverse)
        tw = None
        if st.Mp > 1:
            q = quads(luts.stage_twiddle(st.r, st.Mp, inverse))
            tw = tuple(np.ascontiguousarray(q[:, k].reshape(st.r, st.Mp))
                       for k in range(4))
        stages.append((st.r, st.L, st.Mp, D, tw))
    return tuple(stages)


# ---------------------------------------------------------------------------
# Plain versions: the JAX kernels' stage walk in torch.
# ---------------------------------------------------------------------------

def _coeff_kind(c: complex, tol: float = 1e-15) -> str:
    if abs(c - 1.0) < tol:
        return "one"
    if abs(c + 1.0) < tol:
        return "neg"
    if abs(c - 1j) < tol:
        return "i"
    if abs(c + 1j) < tol:
        return "negi"
    return "full"


def _scalar_cmul(x: DDComplex, c: complex) -> DDComplex:
    """x * c with c an exact host dd scalar; trivial coefficients skip the
    dd products (``dd_kernel.py:72-90``)."""
    kind = _coeff_kind(c)
    if kind == "one":
        return x
    if kind == "neg":
        return DDComplex(-x.re, -x.im)
    if kind == "i":
        return DDComplex(-x.im, x.re)
    if kind == "negi":
        return DDComplex(x.im, -x.re)
    cr, ci = dd_scalar(c.real), dd_scalar(c.imag)
    return DDComplex(x.re * cr - x.im * ci, x.re * ci + x.im * cr)


_PLAIN_TWIDDLES: dict = {}


def _twiddles(n: int, inverse: bool, device) -> list:
    """Per stage of `dd_stage_tables`, its (r, Mp) twiddle `DDComplex` on
    ``device``, or None."""
    key = (n, inverse, str(device))
    tws = _PLAIN_TWIDDLES.get(key)
    if tws is None:
        tws = [None if tw is None else DDComplex.of(
            [torch.from_numpy(p).to(device) for p in tw])
            for (_, _, _, _, tw) in dd_stage_tables(n, inverse)]
        _PLAIN_TWIDDLES[key] = tws
    return tws


def _stage_walk(x: DDComplex, n: int, inverse: bool) -> DDComplex:
    """The dd DFT along axis 1 of (Q, n, S) quad planes: each stage takes
    digit j of (L, r, Mp), runs the r x r dd DFT and the twiddle, and
    stacks the new digit in front (``dd_kernel.py:131-163``)."""
    Q, _, S = x.shape
    stages = dd_stage_tables(n, inverse)
    for (r, L, Mp, D, _), tw in zip(stages, _twiddles(n, inverse, x.device)):
        xs = x.reshape(Q, L, r, Mp, S)
        cols = [xs[:, :, j] for j in range(r)]
        outs = []
        for i in range(r):
            acc = _scalar_cmul(cols[0], complex(D[i, 0]))
            for j in range(1, r):
                acc = acc + _scalar_cmul(cols[j], complex(D[i, j]))
            if tw is not None:
                acc = acc * tw[i].reshape(Mp, 1)
            outs.append(acc)
        x = DDComplex.of([torch.stack([o.planes()[k] for o in outs], dim=1)
                          .reshape(Q, n, S) for k in range(4)])
    return x


def _at_flat(tab: torch.Tensor, shape) -> DDComplex:
    """Table entries at each point's flat position modulo its length."""
    count = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(count, device=tab.device) % tab.shape[0]
    return ddc_of_quads(tab[idx]).reshape(*shape)


def _epilogue(y: DDComplex, post, add, scale: float) -> DDComplex:
    """(y * post + add) * scale, ``add`` one quad per leading index."""
    if post is not None:
        y = y * _at_flat(post, y.shape)
    if add is not None:
        a = ddc_of_quads(add).reshape(-1, *([1] * (y.ndim - 1)))
        y = y + a
    if scale != 1.0:
        y = y * dd_scalar(scale)
    return y


def _count_plain() -> None:
    global plain_calls
    plain_calls += 1


def dd_lines_plain(x: DDComplex, inverse: bool, pre=None, post=None,
                   add=None, scale: float = 1.0) -> DDComplex:
    """Plain torch version of `fft_dd_lines`."""
    _count_plain()
    B, n = x.shape
    if pre is not None:
        x = x * _at_flat(pre, x.shape)
    y = _stage_walk(x.reshape(B, n, 1), n, inverse).reshape(B, n)
    return _epilogue(y, post, add, scale).contiguous()


def dd_strided_plain(x: DDComplex, inverse: bool, pre=None, post=None,
                     scale: float = 1.0) -> DDComplex:
    """Plain torch version of `fft_dd_strided`."""
    _count_plain()
    if pre is not None:
        x = x * _at_flat(pre, x.shape)
    y = _stage_walk(x, x.shape[1], inverse)
    return _epilogue(y, post, None, scale).contiguous()


def dd_pointwise_plain(x: DDComplex, table=None, add=None,
                       scale: float = 1.0) -> DDComplex:
    """Plain torch version of `dd_pointwise`."""
    _count_plain()
    return _epilogue(x, table, add, scale).contiguous()


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def _check_quads(x, ndim: int, what: str) -> None:
    if not isinstance(x, DDComplex):
        raise TypeError(f"{what}: input must be a DDComplex")
    planes = x.planes()
    for p in planes:
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{what}: planes must be torch tensors")
        if p.dtype != torch.float32:
            raise TypeError(f"{what}: dd planes are float32, got {p.dtype}")
        if p.ndim != ndim or p.shape != planes[0].shape:
            raise ValueError(f"{what}: planes must be four {ndim}-D tensors "
                             f"of one shape, got "
                             f"{[tuple(q.shape) for q in planes]}")
        if not p.is_contiguous():
            raise ValueError(f"{what}: planes must be contiguous")
        if p.device != planes[0].device:
            raise ValueError(f"{what}: planes on more than one device")


def _check_table(t, rows: Optional[int], like: torch.Tensor, what: str):
    """A quad table (None, or (L, 4) float32 on the planes' device; with
    ``rows``, L must be that).  Returns (tensor or None, L)."""
    if t is None:
        return None, 0
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
            or t.ndim != 2 or t.shape[1] != 4 or t.shape[0] < 1
            or not t.is_contiguous() or t.device != like.device):
        raise ValueError(f"{what}: a table is contiguous (L, 4) float32 "
                         "quads on the planes' device")
    if t.shape[0] > _MAX_TABLE_LEN:
        raise ValueError(f"{what}: a table holds fewer than 2^31 quads")
    if rows is not None and t.shape[0] != rows:
        raise ValueError(f"{what}: {t.shape[0]} rows of add for {rows} lines")
    return t, t.shape[0]


def _launch(entry: str, x: DDComplex, args) -> DDComplex:
    y = DDComplex.of([torch.empty_like(p) for p in x.planes()])
    if x.re.hi.numel():
        ck._launch("fft_dd", entry, x.device,
                   [*x.planes(), *y.planes(), *args])
    return y


def _plan_args(n: int, inverse: bool, device):
    """(plan ints as a C array, (L, 4) quad table) of the kernel for
    length n: the fp32 kernels' plan (`cuda_kernels.stage_tables`: radix
    8, 4 or 2 for the twos, then each odd prime; per stage its (r, Mp)
    twiddles and, for odd radices, the roots w_r^k), its fp64 values split
    exactly into quads."""
    ints, values = ck.stage_tables(n, inverse)
    return ((ctypes.c_int * len(ints))(*ints),
            device_quads(("dd_stages", n, inverse), device, lambda: values))


def fft_dd_lines(x: DDComplex, inverse: bool = False, pre=None, post=None,
                 add=None, scale: float = 1.0) -> DDComplex:
    """The dd DFT of each line of (B, n) quad planes, natural order:
    (DFT(x * pre) * post + add) * scale (see the module docstring).  CPU
    planes run `dd_lines_plain`; others launch the kernel.

    Replaces ``vkfft_tpu/precision/dd_kernel.py:166 _dd_fft_kernel``.  A
    block holds max(1, 2048/n) whole lines in shared memory through every
    stage, so device memory sees one read and one write of each point (32
    B of planes) and the tables (``csrc/fft_dd.cu``)."""
    _check_quads(x, 2, "fft_dd_lines")
    B, n = x.shape
    if not use_dd_kernel(n):
        raise _no_kernel("fft_dd_lines", n)
    like = x.re.hi
    pre, pre_len = _check_table(pre, None, like, "fft_dd_lines")
    post, post_len = _check_table(post, None, like, "fft_dd_lines")
    add, _ = _check_table(add, B, like, "fft_dd_lines")
    if x.device.type == "cpu":
        return dd_lines_plain(x, inverse, pre, post, add, scale)
    plan, table = _plan_args(n, inverse, x.device)
    s_hi, s_lo = split_scalar(scale)
    return _launch("fft_dd_lines", x, [B, plan, table, pre, pre_len, post,
                                       post_len, add, s_hi, s_lo,
                                       dd_variant(n)])


def fft_dd_strided(x: DDComplex, inverse: bool = False, pre=None, post=None,
                   scale: float = 1.0) -> DDComplex:
    """The dd DFT along the middle axis of (P, n, S) quad planes, S
    contiguous, natural order: (DFT(x * pre) * post) * scale, tables at the
    flat position modulo their length (an (n, S) table: the point's place
    in its plane).  CPU planes run `dd_strided_plain`; others launch.

    Replaces ``vkfft_tpu/precision/dd_kernel.py:259 _dd_strided_kernel``.
    A block transforms a tile of ts neighbouring columns across all n rows
    in shared memory (ts the largest power of two <= min(32, 2048/n), no
    wider than S rounded up to a power of two), reading each row of the
    tile as one run of each plane (``csrc/fft_dd.cu``)."""
    _check_quads(x, 3, "fft_dd_strided")
    P, n, S = x.shape
    if not use_dd_kernel(n):
        raise _no_kernel("fft_dd_strided", n)
    like = x.re.hi
    pre, pre_len = _check_table(pre, None, like, "fft_dd_strided")
    post, post_len = _check_table(post, None, like, "fft_dd_strided")
    if x.device.type == "cpu":
        return dd_strided_plain(x, inverse, pre, post, scale)
    plan, table = _plan_args(n, inverse, x.device)
    s_hi, s_lo = split_scalar(scale)
    return _launch("fft_dd_strided", x, [P, S, plan, table, pre, pre_len,
                                         post, post_len, s_hi, s_lo,
                                         dd_variant(n)])


def dd_pointwise(x: DDComplex, table=None, add=None,
                 scale: float = 1.0) -> DDComplex:
    """(x * table + add) * scale on (R, C) quad planes, the table at the
    flat position modulo its length, ``add`` one quad per row.  CPU planes
    run `dd_pointwise_plain`; others launch ``vk_dd_pointwise``."""
    _check_quads(x, 2, "dd_pointwise")
    R, C = x.shape
    like = x.re.hi
    table, t_len = _check_table(table, None, like, "dd_pointwise")
    add, _ = _check_table(add, R, like, "dd_pointwise")
    if x.device.type == "cpu":
        return dd_pointwise_plain(x, table, add, scale)
    s_hi, s_lo = split_scalar(scale)
    return _launch("dd_pointwise", x, [R, C, table, t_len, add, s_hi, s_lo])
