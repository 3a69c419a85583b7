"""Size factorization and algorithm selection — the planner core.

TPU-native analog of the reference scheduler's factorization logic
(``vkFFT_PlanManagement/vkFFT_HostFunctions/vkFFT_Scheduler.h:2289-2404``): the
reference factorizes each axis over radix 2..13, detects Rader-friendly primes,
and falls back to Bluestein with vendor-tuned padded sizes
(``vkFFT_Scheduler.h:2406-2578``).

On TPU the trade-offs differ: a radix-``r`` stage is a DFT-matrix contraction
that rides the MXU, so *any* factor up to ``MAX_DIRECT_PRIME`` is as cheap as a
classic butterfly — the per-stage cost model is ``sum(radices)`` complex MACs
per point, and the transform stays HBM-bandwidth-bound as long as that sum is
modest.  Hence:

* composite sizes are grouped into radices near 8-16 (MXU sweet spot, low
  flop total),
* primes up to ``MAX_DIRECT_PRIME`` get a direct DFT stage (no Rader needed
  where the reference needed it for p in 17..13),
* primes above that use Rader (p-1 decomposition) when p-1 is smooth, else
  Bluestein with a smooth padded size (reference: ``vkFFT_Scheduler.h:2324-2404``
  for the Rader scan, ``:2406-2578`` for Bluestein padding selection).
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Optional

# Largest prime factor executed as a direct DFT-matrix stage.  On the MXU a
# direct length-p DFT costs p MACs/point; the Pallas lane-major kernels take
# any factor up to one lane tile (128), so primes through 127 are cheaper
# direct than via Rader's two p-1 convolution FFTs.
MAX_DIRECT_PRIME = 127

# Largest composite radix we group small primes into.  16 is the sweet spot:
# the (r x r) DFT matrix occupies 2 sublane tiles and the stage count stays
# logarithmic.
MAX_GROUP_RADIX = 16

# Absolute ceiling for a single stage radix (one MXU lane tile).
MAX_STAGE_RADIX = 128


def prime_factors(n: int) -> list[int]:
    """Ascending prime factorization by trial division (reference:
    ``vkFFT_Scheduler.h:2295-2301`` does registered-radix division 2..13).

    Delegates to the native C++ planner core when it builds (same
    algorithm, ``native/planner_core.cpp``, `planner.native`); this Python
    body is the fallback."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    from vkfft_tpu_torch.planner import native
    nat = native.prime_factors(n)
    if nat is not None:
        return nat
    out: list[int] = []
    for p in (2, 3, 5, 7, 11, 13):
        while n % p == 0:
            out.append(p)
            n //= p
    f = 17
    while f * f <= n:
        while n % f == 0:
            out.append(f)
            n //= f
        f += 2
    if n > 1:
        out.append(n)
    return out


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    return prime_factors(n) == [n]


def _group_radices(primes: list[int], max_radix: int) -> list[int]:
    """Group a multiset of small primes into stage radices <= ``max_radix``.

    Greedy: repeatedly grow the current group by the largest prime that still
    fits; emit when nothing fits.  Power-of-two inputs get special-cased to a
    canonical 16/8/4 split (e.g. 4096 -> [16, 16, 16], 2^13 -> [16,16,16,2] ->
    rebalanced to [16,16,8,4])."""
    twos = sum(1 for p in primes if p == 2)
    odds = sorted((p for p in primes if p != 2), reverse=True)

    radices: list[int] = []
    # Fold odd primes first, pairing them up to max_radix.
    cur = 1
    for p in odds:
        if cur * p <= max_radix:
            cur *= p
        else:
            radices.append(cur)
            cur = p
    # Absorb powers of two into the last odd group while it fits.
    while twos and cur * 2 <= max_radix:
        cur *= 2
        twos -= 1
    if cur > 1:
        radices.append(cur)

    # Remaining pure powers of two: canonical 16-biased split with rebalance
    # so no trailing radix-2 stage (mirrors the pow-8-biased axis split at
    # vkFFT_Scheduler.h:2655-2708).
    if twos:
        four_bits = max_radix.bit_length() - 1  # log2(largest pow2 <= max_radix)
        while twos >= four_bits:
            radices.append(1 << four_bits)
            twos -= four_bits
        if twos:
            if twos == 1 and radices and radices[-1] in (8, 16) and radices[-1] % 2 == 0:
                # rebalance [..,16,2] -> [..,8,4] / [..,8,2] -> [..,4,4]
                last = radices.pop()
                radices.extend([last // 2, 4])
            else:
                radices.append(1 << twos)
    return sorted(radices, reverse=True)


class Algorithm(enum.Enum):
    """Which engine strategy a (sub-)size uses (reference kernel-type analog,
    ``vkFFT_Plan_FFT.h:682-696``)."""

    DIRECT = "direct"          # mixed-radix Stockham, all primes <= MAX_DIRECT_PRIME
    RADER = "rader"            # large prime via Rader p-1 convolution
    BLUESTEIN = "bluestein"    # anything else via chirp-z padding
    SPLIT = "split"            # composite with a large prime factor: one
                               # Cooley-Tukey split, each side planned
                               # recursively (reference: Rader primes inline
                               # as stage factors, vkFFT_Scheduler.h:2303-2404)


@dataclasses.dataclass(frozen=True)
class SizeDecomposition:
    """Factorization decision for one 1-D length."""

    n: int
    algorithm: Algorithm
    radices: tuple[int, ...]            # DIRECT: stage radices (product == n)
    bluestein_size: Optional[int] = None  # BLUESTEIN: padded FFT length M >= 2n-1
    rader_prime: Optional[int] = None     # RADER: the prime p (== n)
    split: Optional[tuple[int, int]] = None  # SPLIT: (a, b) with n == a*b

    @property
    def mac_per_point(self) -> int:
        """Complex MACs per point — the planner's stage cost model."""
        return sum(self.radices)


def _smooth_radices(n: int, max_radix: int = MAX_GROUP_RADIX) -> Optional[list[int]]:
    """Radix schedule for n if all prime factors <= MAX_DIRECT_PRIME else None."""
    primes = prime_factors(n)
    large = [p for p in primes if p > MAX_DIRECT_PRIME]
    if large:
        return None
    small = [p for p in primes if p <= max_radix]
    big_primes = sorted((p for p in primes if max_radix < p <= MAX_DIRECT_PRIME), reverse=True)
    return big_primes + _group_radices(small, max_radix)


@functools.lru_cache(maxsize=4096)
def next_smooth(n: int, smooth_primes: tuple[int, ...] = (2, 3, 5, 7, 11, 13)) -> int:
    """Smallest m >= n whose prime factors are all in ``smooth_primes``.

    Bluestein padded-size search: the reference consults per-vendor padding
    tables (``vkFFT_InitializeApp.h:32-427``); on TPU we instead minimise the
    stage cost directly over smooth candidates."""
    if n <= 1:
        return 1
    if smooth_primes == (2, 3, 5, 7, 11, 13):
        from vkfft_tpu_torch.planner import native
        nat = native.next_smooth(n)
        if nat is not None:
            return nat
    best = 1 << (n - 1).bit_length()  # next power of two always works

    def rec(value: int, idx: int) -> None:
        nonlocal best
        if value >= n:
            if value < best:
                best = value
            return
        if idx >= len(smooth_primes):
            return
        p = smooth_primes[idx]
        v = value
        while v < best:
            rec(v, idx + 1)
            v *= p

    rec(1, 0)
    return best


def _bluestein_padded_size(n: int) -> int:
    """Padded length M >= 2n-1 minimizing stage MAC cost among smooth sizes.

    Prefers slightly larger but cheaper sizes (reference picks from vendor
    tables with the same "bigger but faster" logic).

    Beyond the single-kernel range (M > 16384) the padded size is chosen as
    M = nc * ns with nc a lane-tile multiple and ns in the v3 single-kernel
    range, so the Bluestein convolution runs the fused 3-kernel long path
    (strided + single-kernel conv + strided) — execution structure beats a
    marginally smaller but structureless smooth M (the reference's
    vendor-table logic makes the same trade, ``vkFFT_Scheduler.h:
    2406-2578``).  Mirrored bit-for-bit in the native core
    (``vt_bluestein_size``)."""
    lo = 2 * n - 1
    if lo > 16384:  # MAX_SINGLE_KERNEL_N (ops layer)
        best = None
        for nc in (128, 256, 512, 1024):
            ns = next_smooth(-(-lo // nc))
            if ns <= 8192:  # _V3_MAX_N (ops layer)
                m = nc * ns
                if best is None or m < best:
                    best = m
        # Power-of-two M has all-K=128-class conv stages; a 2^12*5-style
        # smooth M drags a K=4 MXU tail.  e40 (round 4, real v5e): n=10007
        # via M=32768 is 14% faster than via M=20480 despite 1.6x the
        # data.  Prefer pow-2 when it costs at most ~1.7x the minimum.
        p2 = 1 << (lo - 1).bit_length()
        if best is not None and p2 <= (best * 17) // 10 \
                and (p2 // 128) <= 8192:
            return p2
        if best is not None:
            return best
    candidates = {next_smooth(lo)}
    # Also consider the next power of two and a couple of nearby smooth sizes.
    candidates.add(1 << (lo - 1).bit_length())
    c = next_smooth(lo)
    for _ in range(3):
        c = next_smooth(c + 1)
        candidates.add(c)

    def cost(m: int) -> float:
        radices = _smooth_radices(m)
        assert radices is not None
        # total MACs ~ m * sum(radices); amortize over the n useful points
        return m * (sum(radices) + 4) / n

    return min(candidates, key=cost)


RADER_MIN_PRIME = MAX_DIRECT_PRIME + 1
# Largest prime handled by Rader before falling to Bluestein (reference goes to
# ~10^4, vkFFT README.md:12; we allow the same order).
RADER_MAX_PRIME = 10007


@functools.lru_cache(maxsize=65536)
def decompose(n: int, allow_rader: bool = True) -> SizeDecomposition:
    """Choose the algorithm + stage radices for a 1-D length ``n``.

    Mirrors the decision cascade at ``vkFFT_Scheduler.h:2289-2578``:
    registered radices -> Rader primes -> Bluestein, except that "registered
    radices" here covers every prime <= MAX_DIRECT_PRIME via direct DFT
    stages.  Runs in the native C++ planner core when it builds
    (``vt_decompose``, ``native/planner_core.cpp``, `planner.native`: the
    reference's scheduler is native C, ours likewise); ``_decompose_py`` is
    the bit-identical fallback (parity asserted in
    ``tests/test_torch_native.py``)."""
    if n < 1:
        raise ValueError(f"FFT length must be positive, got {n}")
    from vkfft_tpu_torch.planner import native
    nat = native.decompose(n, allow_rader, MAX_DIRECT_PRIME, MAX_GROUP_RADIX,
                           RADER_MAX_PRIME)
    if nat is not None:
        algo, aux1, aux2, radices = nat
        if algo == 0:
            return SizeDecomposition(n=n, algorithm=Algorithm.DIRECT,
                                     radices=tuple(radices))
        if algo == 1:
            return SizeDecomposition(n=n, algorithm=Algorithm.RADER,
                                     radices=tuple(radices), rader_prime=aux1)
        if algo == 2:
            return SizeDecomposition(n=n, algorithm=Algorithm.BLUESTEIN,
                                     radices=tuple(radices),
                                     bluestein_size=aux1)
        return SizeDecomposition(n=n, algorithm=Algorithm.SPLIT, radices=(),
                                 split=(aux1, aux2))
    return _decompose_py(n, allow_rader)


def _decompose_py(n: int, allow_rader: bool = True) -> SizeDecomposition:
    """Pure-Python decomposition cascade (fallback + parity oracle for the
    native core)."""
    if n == 1:
        return SizeDecomposition(n=1, algorithm=Algorithm.DIRECT, radices=())

    radices = _smooth_radices(n)
    if radices is not None:
        return SizeDecomposition(n=n, algorithm=Algorithm.DIRECT, radices=tuple(radices))

    primes = prime_factors(n)
    # A single large prime with a smooth p-1 -> Rader; Rader for a large prime
    # *factor* (composite n) is handled by recursing in the axis planner later;
    # round 1 applies Rader only when n itself is the prime.
    if (
        allow_rader
        and len(primes) == 1
        and RADER_MIN_PRIME <= n <= RADER_MAX_PRIME
        and _smooth_radices(n - 1) is not None
    ):
        return SizeDecomposition(
            n=n,
            algorithm=Algorithm.RADER,
            radices=tuple(_smooth_radices(n - 1) or ()),
            rader_prime=n,
        )

    # Composite with one or more large prime factors: split out the largest
    # Rader-eligible prime as a Cooley-Tukey factor and plan both sides
    # recursively — the TPU rendition of the reference running Rader primes
    # inline as stage factors (vkFFT_Scheduler.h:2303-2404).  Cost: a
    # Rader-p transform of B*n/p lines + a smooth transform, far cheaper
    # than Bluestein-padding the whole axis to >= 2n.
    if allow_rader and len(primes) > 1:
        big = [p for p in primes if p > MAX_DIRECT_PRIME]
        for p in sorted(set(big), reverse=True):
            if (RADER_MIN_PRIME <= p <= RADER_MAX_PRIME
                    and _smooth_radices(p - 1) is not None):
                rest = n // p
                rest_d = _decompose_py(rest, allow_rader=allow_rader)
                if rest_d.algorithm is not Algorithm.BLUESTEIN:
                    return SizeDecomposition(
                        n=n, algorithm=Algorithm.SPLIT, radices=(),
                        split=(p, rest))

    m = _bluestein_padded_size(n)
    sub = _smooth_radices(m)
    assert sub is not None
    return SizeDecomposition(
        n=n,
        algorithm=Algorithm.BLUESTEIN,
        radices=tuple(sub),
        bluestein_size=m,
    )
