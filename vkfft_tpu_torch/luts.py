"""Host-side twiddle / LUT factory.

TPU analog of the reference LUT manager (``vkFFT_HostFunctions/
vkFFT_ManageLUT.h``): the reference precomputes per-stage twiddle tables,
4-step inter-upload twiddles, Rader ``g^k mod p`` tables and R2C
post-twiddles on the host in long double and uploads them via a staging
buffer.  Here every table is a host numpy array in float64/complex128;
engines cast to the working precision at trace time and XLA constant-folds
or stages them to VMEM.

All caches key on plan parameters only, mirroring the app-wide Rader kernel
dedup (``vkFFT_Structs.h:1181-1185``).
"""
from __future__ import annotations

import functools

import numpy as np

from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import AxisPlan, Stage


@functools.lru_cache(maxsize=512)
def dft_matrix(r: int, inverse: bool = False) -> np.ndarray:
    """(r, r) DFT matrix w^(i*j), w = exp(-+2*pi*i/r), complex128.

    The MXU-era replacement for the hand-unrolled radix butterflies of
    ``vkFFT_KernelsLevel1/vkFFT_RadixKernels.h:30`` — a radix stage becomes a
    constant-matrix contraction instead of generated butterfly code."""
    sign = 2.0j if inverse else -2.0j
    ij = np.outer(np.arange(r), np.arange(r)) % r
    return np.exp(sign * np.pi / r * ij)


@functools.lru_cache(maxsize=4096)
def stage_twiddle(r: int, Mp: int, inverse: bool = False) -> np.ndarray:
    """(r, Mp) inter-stage twiddle w_M^(i*m'), M = r*Mp (reference:
    ``VkFFT_AllocateLUT`` stage-offset math, ``vkFFT_ManageLUT.h:46-110``)."""
    M = r * Mp
    sign = 2.0j if inverse else -2.0j
    im = np.outer(np.arange(r), np.arange(Mp)) % M
    return np.exp(sign * np.pi / M * im)


@functools.lru_cache(maxsize=1024)
def bluestein_chirp(n: int, m: int, inverse: bool = False):
    """Bluestein chirp-z tables for length-n FFT via padded length-m circular
    convolution (reference: ``VkFFTGeneratePhaseVectors``,
    ``vkFFT_RecursiveFFTGenerators.h:35``; chirp built at ``:139-148``).

    Returns ``(a_chirp, b_fft)``:
      a_chirp[k] = exp(-+i*pi*k^2/n)        (n,)   pre/post multiplier
      b_fft      = FFT_m(b_pad)             (m,)   frequency-domain kernel,
    where b_pad wraps b[k] = conj(a_chirp[k]) circularly so the padded
    circular convolution equals the needed linear one.

    k^2 is reduced mod 2n before the complex exponential to keep fp64 phase
    accuracy at large n (the reference computes ``(k*k) % (2n)`` the same way,
    ``vkFFT_RecursiveFFTGenerators.h:139-148``).
    """
    k = np.arange(n, dtype=np.int64)
    ksq = (k * k) % (2 * n)
    sign = 1.0j if inverse else -1.0j
    a = np.exp(sign * np.pi / n * ksq)
    b = np.conj(a)
    b_pad = np.zeros(m, dtype=np.complex128)
    b_pad[:n] = b
    if n > 1:
        b_pad[m - n + 1:] = b[1:][::-1]
    # Host-side fp64 FFT of the chirp.  The reference does this by recursively
    # instantiating a nested VkFFT app on-device; numpy's fp64 FFT gives the
    # same (or better) precision for the one-time setup table.
    b_fft = np.fft.fft(b_pad)
    return a, b_fft


@functools.lru_cache(maxsize=256)
def bluestein_chirp_factors(n: int, ns: int, d1: int, d2: int, stride: int,
                            inverse: bool = False):
    """Separable factorization of the Bluestein chirp over the four-step
    digits of the padded index (round 5; reference fuses the chirp mult into
    every kernel's read/write — ``appendBluesteinMultiplication``,
    ``vkFFT_Bluestein.h:32`` — this is the TPU rendition for the 3-kernel
    long tier: the chirp rides the strided kernel's fused-factor machinery).

    Index algebra: padded index k = kc*ns + ks with kc = q1*stride + q2
    (q1 < d1, q2 < d2).  With A = q1*stride*ns, B = q2*ns, C = ks:
    k^2 = A^2 + 2AC  +  B^2 + 2BC + C^2  +  2AB — three exactly-separable
    groups.  Returns (T1 (d1, ns), T2 (d2, ns), T12 (d1, d2)) complex128
    with E(t) = exp(+-i*pi*(t mod 2n)/n); all phase integers reduced mod 2n
    in int64 before the exponential (same fp64-accuracy discipline as
    ``bluestein_chirp``)."""
    sign = 1.0j if inverse else -1.0j
    two_n = 2 * n

    def E(t):
        return np.exp(sign * np.pi / n * (t % two_n))

    q1 = np.arange(d1, dtype=np.int64)[:, None]
    q2 = np.arange(d2, dtype=np.int64)[:, None]
    ks = np.arange(ns, dtype=np.int64)[None, :]
    A = (q1 * stride * ns) % two_n
    B = (q2 * ns) % two_n
    C = ks % two_n
    T1 = E(A * A + 2 * A * C)                    # (d1, ns)
    T2 = E(B * B + 2 * B * C + C * C)            # (d2, ns)
    T12 = E(2 * A * B.T)                         # (d1, d2)
    return T1, T2, T12


@functools.lru_cache(maxsize=128)
def bluestein_chirp_rows(n: int, rows: int, ns: int, inverse: bool = False,
                         scale: float = 1.0):
    """FULL (rows, ns) chirp table over the four-step view k = kc*ns + ks —
    multiplied directly onto the strided kernel's (rows, S) state (round 5:
    at the long tier's small S the full table is KBs and beats the separable
    broadcast form, e44b).  Same mod-2n fp64 phase discipline as
    ``bluestein_chirp``; values at k >= n ride declared-zero/cropped rows."""
    sign = 1.0j if inverse else -1.0j
    two_n = 2 * n
    k = (np.arange(rows, dtype=np.int64)[:, None] * ns
         + np.arange(ns, dtype=np.int64)[None, :])
    t = (k % two_n) * (k % two_n) % two_n
    return np.exp(sign * np.pi / n * t) * scale


@functools.lru_cache(maxsize=128)
def fourstep_twiddle_full(nc: int, ns: int, inverse: bool = False):
    """FULL (nc, ns) four-step inter-pass twiddle w_m^(kc*ks), m = nc*ns
    (reference LUT_4step, ``vkFFT_ManageLUT.h`` — the reference also stores
    the full table)."""
    m = nc * ns
    sign = 2.0j if inverse else -2.0j
    kc = np.arange(nc, dtype=np.int64)[:, None]
    ks = np.arange(ns, dtype=np.int64)[None, :]
    return np.exp(sign * np.pi / m * ((kc * ks) % m))


@functools.lru_cache(maxsize=256)
def rader_tables(p: int):
    """Rader index/kernel tables for prime p (reference: generator search in
    ``VkFFTConstructRaderTree``, ``vkFFT_Scheduler.h:1733``; ``g^k mod p``
    LUTs in ``VkFFT_AllocateRaderUintLUT``, ``vkFFT_ManageLUT.h:1274``).

    Returns ``(perm, inv_perm, b_fft)`` for the length-(p-1) cyclic
    convolution formulation:
      perm[q]     = g^q mod p                  (p-1,)  input gather order
      inv_perm[q] = g^(-q) mod p               (p-1,)  output scatter order
      b_fft       = FFT_{p-1}(w_p^(g^(-q)))    (p-1,)  freq-domain kernel
    """
    g = _primitive_root(p)
    q = np.arange(p - 1, dtype=np.int64)
    perm = pow_mod_vec(g, q, p)
    g_inv = pow(g, p - 2, p)
    inv_perm = pow_mod_vec(g_inv, q, p)
    b = np.exp(-2.0j * np.pi / p * inv_perm)
    b_fft = np.fft.fft(b)
    return perm, inv_perm, b_fft


def pow_mod_vec(base: int, exps: np.ndarray, mod: int) -> np.ndarray:
    out = np.empty_like(exps)
    v = 1
    for i in range(len(exps)):
        out[i] = v
        v = (v * base) % mod
    return out


def _primitive_root(p: int) -> int:
    """Smallest primitive root mod prime p (reference generator search:
    ``vkFFT_Scheduler.h:2324-2340``)."""
    phi = p - 1
    factors = set()
    x = phi
    d = 2
    while d * d <= x:
        while x % d == 0:
            factors.add(d)
            x //= d
        d += 1
    if x > 1:
        factors.add(x)
    for g in range(2, p):
        if all(pow(g, phi // f, p) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root found for {p}")


@functools.lru_cache(maxsize=1024)
def ct_twiddle(a: int, b: int, inverse: bool = False) -> np.ndarray:
    """(b, a) Cooley-Tukey inter-factor twiddle w_n^(jb*ka), n = a*b
    (reference 4-step inter-upload twiddles, ``vkFFT_ManageLUT.h`` LUT_4step
    generalized to a Rader-bearing split)."""
    n = a * b
    sign = 2.0j if inverse else -2.0j
    jb = np.arange(b, dtype=np.int64)[:, None]
    ka = np.arange(a, dtype=np.int64)[None, :]
    return np.exp(sign * np.pi / n * ((jb * ka) % n))


def stage_tables(stages: tuple[Stage, ...], inverse: bool):
    """(dft, twiddle) numpy tables for every stage of a core FFT."""
    return [(dft_matrix(s.r, inverse), stage_twiddle(s.r, s.Mp, inverse)) for s in stages]


# ---------------------------------------------------------------------------
# Real-transform tables (R2C post-twiddles, DCT/DST rotations) — reference:
# ``PrePostProcessing/vkFFT_R2C.h`` and ``vkFFT_R2R.h``.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def r2c_post_twiddle(n: int, inverse: bool = False) -> np.ndarray:
    """(n//2+1,) twiddles w_n^k used to untangle a length-n real FFT computed
    as a length-n/2 complex FFT (reference: ``appendR2C_write``,
    ``vkFFT_R2C.h:450``)."""
    k = np.arange(n // 2 + 1)
    sign = 2.0j if inverse else -2.0j
    return np.exp(sign * np.pi / n * k)


def axis_tables(plan: AxisPlan, inverse: bool):
    """All numpy tables an engine needs for one axis plan."""
    if plan.algorithm is Algorithm.SPLIT:
        a, b = plan.decomp.split
        return {"split_tw": ct_twiddle(a, b, inverse)}
    tabs = {"stages": stage_tables(plan.stages, inverse)}
    if plan.algorithm is Algorithm.BLUESTEIN:
        m = plan.decomp.bluestein_size
        assert m is not None
        a, b_fft = bluestein_chirp(plan.n, m, inverse)
        tabs["bluestein"] = (a, b_fft)
        tabs["inv_stages"] = stage_tables(plan.stages, not inverse)
    elif plan.algorithm is Algorithm.RADER:
        # Rader executes the inverse transform by conjugation at the engine
        # level (ifft(x) = conj(fft(conj(x)))/n), so its sub-FFT tables are
        # always the forward/inverse pair of the p-1 convolution.
        perm, inv_perm, b_fft = rader_tables(plan.n)
        tabs["rader"] = (perm, inv_perm, b_fft)
        tabs["stages"] = stage_tables(plan.stages, False)
        tabs["inv_stages"] = stage_tables(plan.stages, True)
    return tabs
