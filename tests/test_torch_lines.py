"""`fft_lines` on the CPU: its layout rule (`lines_split`, `lines_layout`,
the one the C entry of ``csrc/fft_lines.cu`` checks) over every length it
takes, its twiddle's two tables, the arguments each launch passes (the C
library stubbed out, on meta tensors), and its plain version against the
JAX package's ``_fft_kernel_v3`` in interpret mode and numpy fp64 at the
lengths it runs as two factors.  The kernel itself runs only on the card
(chip_smoke.py, phases kernels and times)."""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkfft_tpu.ops import pallas_engine

from vkfft_tpu_torch.ops import cuda_kernels as ck, torch_engine

NUMPY_TOL = 5e-6
REF_TOL = 1e-5
# csrc/inplace.cuh: the radices of stage_fixed, the points a thread holds
# in a round of one (kPoints) and the items of a generic stage's round,
# each of a butterfly's output pairs (kGenericItems, kGenericPairs);
# csrc/stockham.cuh: kMaxStages
FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
POINTS = 12
GENERIC_PAIRS = 4
GENERIC_ITEMS = 2
MAX_STAGES = 16
LENGTHS = [n for n in range(2, ck.KERNEL_MAX_N + 1) if ck.kernel_supports(n)]


def _plan_table_points(m: int) -> int:
    """What the C entry's table_len reads off the plan ints of a factor of
    length m: where its last stage's twiddles or roots end."""
    if m == 1:
        return 0
    ints, _ = ck.stage_tables(m, False, 1.0, True)
    M, end = m, 0
    for s in range(ints[1]):
        r = ints[3 + s]
        tw_off, dft_off = ints[3 + MAX_STAGES + s], ints[3 + 2 * MAX_STAGES + s]
        M //= r
        end = max(end, dft_off + r if dft_off >= 0 else tw_off + r * M)
    return end


def _rounds_fit(m: int, threads: int) -> bool:
    """The C entry's rounds_fit: a round of `threads` holds a whole
    sequence of every stage of a factor of length m."""
    if m == 1:
        return True
    for r in ck.walk_radices(m):
        if r in FIXED_RADICES:
            if max(1, POINTS // r) * threads < m // r:
                return False
        elif (GENERIC_ITEMS * threads
              < m // r * -(-(r // 2 + 1) // GENERIC_PAIRS)):
            return False
    return True


@pytest.mark.parametrize("n", [n for n in range(2, 8193)
                               if ck.kernel_supports(n)][::7] + [4096, 8192])
def test_walk_radices(n):
    """The walk's stages are `stage_radices`' with the power of two as
    radix-16 stages where that makes fewer stages: the same length, the
    same odd primes, never more stages."""
    old, new = ck.stage_radices(n), ck.walk_radices(n)
    assert np.prod(new) == n and len(new) <= len(old)
    assert sorted(r for r in new if r % 2) == sorted(r for r in old if r % 2)
    if 16 in new:
        assert len(new) < len(old)
    else:
        assert new == old


def _threads(points: int, aim: int) -> int:
    return min(512, max(32, -(-(-(-points // aim)) // 32) * 32))


def test_layout_rule_every_length():
    """Every length the kernel takes gets a layout the C entry accepts: a
    split n1 * n2 = n with n1 >= n2, threads a multiple of 32 in 32..512
    (a thread for about 16 points in one pass, 32 in two factors), whole
    lines up to 16384 points, every stage's sequence within a round, and
    exactly the shared bytes of its lines and tables, at most 227 KB; one
    pass (n2 = 1) exactly where a block holds eight lines or more and the
    stages fit a round."""
    assert len(LENGTHS) == 2541
    two = 0
    for n in LENGTHS:
        n1, n2 = ck.lines_split(n)
        threads, lines, smem = ck.lines_layout(n)
        assert n1 * n2 == n and n1 >= n2, n
        assert lines == max(1, 4096 // n) and lines * n <= 16384, n
        one = lines >= 8 and _rounds_fit(n, _threads(lines * n, 16))
        assert (n2 == 1) == one, n
        assert threads == _threads(lines * n, 16 if one else 32), n
        assert _rounds_fit(n1, threads) and _rounds_fit(n2, threads), n
        points = (lines * n2 * (n1 | 1) + _plan_table_points(n1)
                  + _plan_table_points(n2) + 64 + -(-n // 64))
        assert smem == 8 * points <= ck.MAX_SMEM_BYTES, n
        two += n2 > 1
    assert two == 2195


@pytest.mark.parametrize("n,split", [(256, (256, 1)), (1024, (64, 16)),
                                     (2048, (128, 16)), (4096, (256, 16)),
                                     (3591, (63, 57)), (8192, (128, 64)),
                                     (7175, (175, 41)), (2, (2, 1)),
                                     (47, (47, 1))])
def test_split_of_named_lengths(n, split):
    """256 (16 lines a block, as 16 · 16) and the short lines run as one
    pass; lines of 513 points and up (fewer than 8 a block) as the two
    factors of fewest stages, then the most square: 1024 as 64 x 16, 4096
    as 256 x 16 (16 · 16 and 16), not 64 x 64 (8 · 8 twice)."""
    assert ck.lines_split(n) == split
    assert ck.walk_radices(256) == (16, 16)
    assert ck.walk_radices(1024) == (16, 16, 4)   # one pass: 2 lines a block
    if split[1] > 1:
        threads = ck.lines_layout(n)[0]
        cost = {(n // d, d): len(ck.walk_radices(n // d))
                + len(ck.walk_radices(d))
                for d in range(2, n) if n % d == 0 and n // d >= d
                and all(_rounds_fit(k, threads) for k in (n // d, d))}
        least = min(cost.values())
        assert cost[split] == least
        assert split[1] == max(p[1] for p, v in cost.items() if v == least)


@pytest.mark.parametrize("n", [256, 3591, 8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_tables(n, inverse):
    """hi[e >> 6] * lo[e & 63] is w_n^(+-k2*j1) * scale at every k2, j1 of
    the split (one pass: e = 0, the scale alone)."""
    scale = 0.25
    n1, n2 = ck.lines_split(n)
    pair = ck.twofactor_twiddle_pair(n, inverse, scale)
    lo, hi = pair[:64], pair[64:]
    e = (np.arange(n2)[:, None] * np.arange(n1)[None, :]).ravel()
    sign = 1 if inverse else -1
    want = np.exp(sign * 2j * np.pi * e / n) * scale
    assert np.abs(hi[e >> 6] * lo[e & 63] - want).max() < 1e-14


class _Recorder:
    """The C library stub: each ``vk_fft_lines`` call's arguments, the
    plans read back from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "vk_fft_lines":
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[5:7]]
                self.calls.append({"batch": args[4], "plans": plans,
                                   "layout": tuple(args[10:13])})
            return 0
        return call


@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(ck, "_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ck, "fft_lines_plain", None)
    ck.reset_launches()
    calls = torch_engine.calls
    yield lib
    assert torch_engine.calls == calls


@pytest.mark.parametrize("n", [256, 4096, 3591, 8192, 2])
def test_launch_arguments(monkeypatch, n):
    """Each direction launches once with the batch, the plans of
    `lines_split`'s two factors (unscaled: the scale rides the twiddle's
    tables) and the layout of `lines_layout`; in place when ``out`` is the
    input."""
    n1, n2 = ck.lines_split(n)
    B = 3
    x = (torch.empty(B, n, device="meta"), torch.empty(B, n, device="meta"))
    with _stubbed_launches(monkeypatch) as lib:
        for inverse in (False, True):
            y = ck.fft_lines(*x, inverse, 1.0 / n if inverse else 1.0)
            assert y[0].shape == (B, n) and y[1].shape == (B, n)
        y = ck.fft_lines(*x, out=x)
        assert y[0] is x[0] and y[1] is x[1]
        assert ck.launches == {k: 3 if k == "fft_lines" else 0
                               for k in ck.KERNEL_SOURCES}
    for call, inverse in zip(lib.calls, (False, True, False), strict=True):
        assert call["batch"] == B
        assert call["layout"] == ck.lines_layout(n)
        for ints, m in zip(call["plans"], (n1, n2)):
            assert ints == list(ck.stage_tables(m, inverse, 1.0, True)[0])


@pytest.mark.parametrize("n", [3591, 7175, 8192])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_v3_kernel_at_two_factor_lengths(n, inverse):
    """At the lengths the kernel runs as two factors the plain version
    (through the wrapper on CPU planes, in place) agrees with the JAX
    package's ``_fft_kernel_v3`` in interpret mode and with numpy."""
    rng = np.random.default_rng(n + inverse)
    re = rng.standard_normal((2, n)).astype(np.float32)
    im = rng.standard_normal((2, n)).astype(np.float32)
    scale = 1.0 / n if inverse else 0.5
    pallas_engine.set_interpret(True)
    try:
        rr, ri = pallas_engine.core_fft_planar_v3(
            jnp.asarray(re), jnp.asarray(im), n, inverse, scale=scale)
    finally:
        pallas_engine.set_interpret(False)
    tr, ti = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    got = ck.fft_lines(tr, ti, inverse, scale, out=(tr, ti))
    assert got[0] is tr and got[1] is ti
    g = tr.double().numpy() + 1j * ti.double().numpy()
    ref = np.asarray(rr, np.float64) + 1j * np.asarray(ri, np.float64)
    assert np.abs(g - ref).max() / np.abs(ref).max() <= REF_TOL
    x = re.astype(np.float64) + 1j * im
    want = (np.fft.ifft(x, axis=1) * n if inverse
            else np.fft.fft(x, axis=1)) * scale
    assert np.abs(g - want).max() / np.abs(want).max() <= NUMPY_TOL
