"""Axis plan structures — the TPU analog of ``VkFFTAxis``/``VkFFTPlan``.

The reference fills a ~300-field ``specializationConstants`` struct per
(axis, upload) and emits a specialized kernel string
(``vkFFT_Plans/vkFFT_Plan_FFT.h:33-793``).  Here a plan is a small frozen
Python object: engines close over it to build specialized jitted functions, so
XLA's trace cache plays the role of the reference's compiled-kernel cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from vkfft_tpu_torch.planner.factorize import Algorithm, SizeDecomposition, decompose


@dataclasses.dataclass(frozen=True)
class Stage:
    """One Stockham radix stage.

    Invariant carried between stages (derivation in ``ops/jnp_engine.py``):
    after this stage the array holds partial DFTs of length ``L * r`` with
    ``Mp = M // r`` untransformed points per line.  ``M`` is the *pre-stage*
    remaining length, so the inter-stage twiddle is ``w_M^(i*m')`` with
    ``i < r``, ``m' < Mp`` (reference: stage loop at ``vkFFT_FFT.h:156-239``
    with ``stageSize``/``stageAngle`` bookkeeping).
    """

    r: int
    L: int   # product of radices before this stage
    M: int   # remaining length including this stage's radix (M = r * Mp)
    Mp: int  # remaining length after this stage


def build_stages(n: int, radices: tuple[int, ...]) -> tuple[Stage, ...]:
    stages = []
    L, M = 1, n
    for r in radices:
        assert M % r == 0, (n, radices)
        stages.append(Stage(r=r, L=L, M=M, Mp=M // r))
        L, M = L * r, M // r
    assert L == n and M == 1, (n, radices)
    return tuple(stages)


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """Complete execution recipe for one 1-D transform length."""

    n: int
    decomp: SizeDecomposition
    # Stages of the core mixed-radix FFT this axis actually runs:
    #  DIRECT   -> stages of n
    #  BLUESTEIN-> stages of the padded size M (forward & inverse reuse them)
    #  RADER    -> stages of p-1 (cyclic convolution length)
    stages: tuple[Stage, ...]

    @property
    def algorithm(self) -> Algorithm:
        return self.decomp.algorithm

    @property
    def core_n(self) -> int:
        """Length the Stockham core runs at (n, bluestein pad, or p-1).
        SPLIT plans have no single core; they recurse per factor."""
        if self.algorithm is Algorithm.BLUESTEIN:
            assert self.decomp.bluestein_size is not None
            return self.decomp.bluestein_size
        if self.algorithm is Algorithm.RADER:
            return self.n - 1
        return self.n

    def cache_key(self) -> tuple:
        return (self.n, self.algorithm.value, tuple(s.r for s in self.stages))


def plan_axis(n: int, allow_rader: bool = True) -> AxisPlan:
    """Plan one axis length (reference: ``VkFFTScheduler`` per-axis entry,
    ``vkFFT_Scheduler.h:2223``)."""
    decomp = decompose(n, allow_rader=allow_rader)
    if decomp.algorithm is Algorithm.SPLIT:
        return AxisPlan(n=n, decomp=decomp, stages=())
    core = decomp.n if decomp.algorithm is Algorithm.DIRECT else (
        decomp.bluestein_size or (n - 1))
    return AxisPlan(n=n, decomp=decomp, stages=build_stages(core, decomp.radices))
