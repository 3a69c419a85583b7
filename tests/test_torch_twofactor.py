"""`fft_twofactor` on the CPU: its layout rule (`twofactor_layout`, the
one the C entry of ``csrc/fft_twofactor.cu`` checks) over every length it
takes, its inter-factor twiddle's two tables, the arguments each launch
passes (the C library stubbed out, on meta tensors), and its plain
version against numpy fp64 in both digit orders and directions.  The
kernel itself runs only on the card (chip_smoke.py, phases any_kernels
and any_times); tests/test_torch_any_length.py holds the plain version
against the JAX package's Pallas kernel in interpret mode."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from vkfft_tpu_torch.ops import cuda_kernels as ck, torch_engine

NUMPY_TOL = 5e-6
# the SM's shared memory (228 KB) and what the card reserves a block
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
# csrc/fft_twofactor.cu: the radices of stage_fixed, the points a thread
# holds in a round of one (kPoints) and the items of a generic stage's round,
# each of a butterfly's output pairs (kGenericItems, kGenericPairs)
FIXED_RADICES = (2, 3, 4, 5, 7, 8)
POINTS = 12
GENERIC_PAIRS = 4
GENERIC_ITEMS = 2
LENGTHS = [n for n in range(2, ck.TWOFACTOR_MAX_N + 1)
           if ck.twofactor_supports(n)]


def _plan_table_points(m: int) -> int:
    """What the C entry's table_len reads off the plan ints of a factor of
    length m: where its last stage's twiddles or roots end."""
    if m == 1:
        return 0
    ints, _ = ck.stage_tables(m, False)
    stages, M, end = ints[1], m, 0
    for s in range(stages):
        r, tw_off, dft_off = ints[3 + s], ints[19 + s], ints[35 + s]
        M //= r
        end = max(end, dft_off + r if dft_off >= 0 else tw_off + r * M)
    return end


def _rounds_fit(m: int, threads: int) -> bool:
    """The C entry's rounds_fit: a round of `threads` holds a whole
    sequence of every stage of a factor of length m."""
    if m == 1:
        return True
    for r in ck.stage_radices(m):
        if r in FIXED_RADICES:
            if (POINTS // r) * threads < m // r:
                return False
        elif (GENERIC_ITEMS * threads
              < m // r * -(-(r // 2 + 1) // GENERIC_PAIRS)):
            return False
    return True


def test_layout_rule_every_length():
    """Every length the kernel takes gets a layout the C entry accepts:
    threads a multiple of 32 in 32..512, whole lines up to 16384 points,
    every stage's sequence within a round, and exactly the shared bytes of
    its lines and tables, at most 227 KB."""
    assert len(LENGTHS) > 6000
    for n in LENGTHS:
        threads, lines, smem = ck.twofactor_layout(n)
        n1, n2 = ck.twofactor_split(n)
        assert threads % 32 == 0 and 32 <= threads <= ck.TWOFACTOR_THREADS, n
        assert lines >= 1 and lines * n <= ck.TWOFACTOR_MAX_N, n
        assert _rounds_fit(n1, threads) and _rounds_fit(n2, threads), n
        points = (lines * n2 * (n1 | 1) + _plan_table_points(n1)
                  + _plan_table_points(n2) + 64 + -(-n // 64))
        assert smem == 8 * points, n
        assert smem <= ck.MAX_SMEM_BYTES, (n, smem)


def test_layout_rule_at_split_lane_major():
    """The keep_intermediate_order route runs fft_twofactor at the JAX
    package's split_lane_major where that differs from twofactor_split (121
    lengths from 8208 on): the layout of that split is one the C entry
    accepts (n1 >= n2, every stage within a round, the exact shared
    bytes), and the wrapper takes the split."""
    from vkfft_tpu_torch.ops import cuda_engine
    from vkfft_tpu_torch.planner import plan_axis
    differ = [n for n in LENGTHS
              if cuda_engine.keep_order_kernel(plan_axis(n)) == "fft_twofactor"
              and ck.split_lane_major(n) != ck.twofactor_split(n)]
    assert len(differ) == 121 and differ[0] == 8208
    for n in differ:
        n1, n2 = ck.split_lane_major(n)
        threads, lines, smem = ck.twofactor_layout(n, (n1, n2))
        assert n1 >= n2 and n1 <= ck.TWOFACTOR_TILE, n
        assert threads % 32 == 0 and 32 <= threads <= ck.TWOFACTOR_THREADS
        assert lines == 1
        assert _rounds_fit(n1, threads) and _rounds_fit(n2, threads), n
        points = (n2 * (n1 | 1) + _plan_table_points(n1)
                  + _plan_table_points(n2) + 64 + -(-n // 64))
        assert smem == 8 * points <= ck.MAX_SMEM_BYTES, n
    with pytest.raises(ValueError):
        ck.fft_twofactor(torch.zeros(1, 8208), torch.zeros(1, 8208),
                         split=(108, 75))


@pytest.mark.parametrize("n", [n for n in LENGTHS if n < 200]
                         + [4095, 8190, 15979, 16384])
def test_table_points_match_the_c_rule(n):
    """The tables the host builds end where the C entry's table_len says,
    so the shared bytes the layout names are the ones the kernel fills."""
    for m in ck.twofactor_split(n):
        want = 0 if m == 1 else len(ck.stage_tables(m, False)[1])
        assert _plan_table_points(m) == want == ck._table_points(m)


@pytest.mark.parametrize("n,blocks", [(7918, 3), (10240, 2), (12288, 2),
                                      (16384, 1)])
def test_main_path_blocks_by_shared_memory(n, blocks):
    """One copy of the line: two or more blocks an SM by shared memory at
    the main path's lengths, one at 16384."""
    _, lines, smem = ck.twofactor_layout(n)
    assert lines == 1
    assert SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES) == blocks


@pytest.mark.parametrize("n", [2, 113, 134, 1000, 2048, 2050, 16384])
def test_short_lines_share_a_block(n):
    """Lines shorter than 2048 points share a block up to 2048 points, one
    thread for about 8 of them (a warp fewer would leave some over)."""
    threads, lines, _ = ck.twofactor_layout(n)
    assert lines == max(1, 2048 // n)
    points = lines * n
    assert threads == 512 or (threads - 32) * 8 < points <= threads * 8


@pytest.mark.parametrize("n", [6, 113, 134, 7918, 10240, 12288, 16384])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_tables(n, inverse):
    """hi[e >> 6] * lo[e & 63] is the n-point table w_n^(+-k2*j1) * scale
    at every k2, j1."""
    scale = 0.25
    n1, n2 = ck.twofactor_split(n)
    pair = ck.twofactor_twiddle_pair(n, inverse, scale)
    assert pair.shape == (64 + -(-n // 64),)
    lo, hi = pair[:64], pair[64:]
    e = (np.arange(n2)[:, None] * np.arange(n1)[None, :]).ravel()
    assert e.max() < n
    got = hi[e >> 6] * lo[e & 63]
    want = ck.twofactor_twiddle(n, inverse, scale)
    assert np.abs(got - want).max() < 1e-14


class _Recorder:
    """The C library stub: each ``vk_fft_twofactor`` call's arguments, the
    plans read back from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "vk_fft_twofactor":
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[5:7]]
                self.calls.append({"batch": args[4], "plans": plans,
                                   "swapped": args[10],
                                   "layout": tuple(args[11:14])})
            return 0
        return call


@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrapper's CUDA branch on meta tensors, every launch counted by
    `cuda_kernels._launch` and sent to the recorder; no plain version and
    no plain-engine call may run."""
    lib = _Recorder()
    monkeypatch.setattr(ck, "_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ck, "fft_twofactor_plain", None)
    ck.reset_launches()
    calls = torch_engine.calls
    yield lib
    assert torch_engine.calls == calls


@pytest.mark.parametrize("n", [10240, 7918, 16384, 113])
def test_launch_arguments(monkeypatch, n):
    """Each of the four forms launches once with the batch, the two
    factors' plans of `twofactor_split`, the order flag and the layout of
    `twofactor_layout`; the output has the input's shape (and is the
    input when ``out`` is)."""
    n1, n2 = ck.twofactor_split(n)
    B = 3
    x = (torch.empty(B, n, device="meta"), torch.empty(B, n, device="meta"))
    with _stubbed_launches(monkeypatch) as lib:
        for inverse in (False, True):
            for swapped in (False, True):
                y = ck.fft_twofactor(*x, inverse, 1.0 / n, swapped)
                assert y[0].shape == (B, n) and y[1].shape == (B, n)
        y = ck.fft_twofactor(*x, out=x)
        assert y[0] is x[0] and y[1] is x[1]
        assert ck.launches == {k: 5 if k == "fft_twofactor" else 0
                               for k in ck.KERNEL_SOURCES}
    forms = [(i, s) for i in (False, True) for s in (False, True)]
    forms.append((False, False))
    for call, (inverse, swapped) in zip(lib.calls, forms, strict=True):
        assert call["batch"] == B
        assert call["swapped"] == int(swapped)
        assert call["layout"] == ck.twofactor_layout(n)
        for ints, m in zip(call["plans"], (n1, n2)):
            assert ints == list(ck.stage_tables(m, inverse)[0])


def _numpy_dft(x, inverse, scale):
    n = x.shape[-1]
    return (np.fft.ifft(x, axis=-1) * n if inverse
            else np.fft.fft(x, axis=-1)) * scale


@pytest.mark.parametrize("n", [7918, 12288, 113])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("swapped", [False, True])
def test_plain_against_numpy(n, inverse, swapped):
    """The plain version, through the wrapper on CPU planes (in place:
    ``out`` its input), against numpy fp64 in both digit orders."""
    rng = np.random.default_rng(n + 2 * inverse + swapped)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    x = x.astype(np.complex64).astype(np.complex128)
    scale = 1.0 / n if inverse else 0.5
    want = _numpy_dft(x, inverse, scale)
    feed = x
    if swapped and inverse:
        # x is a spectrum, fed in swapped order
        feed = np.stack([ck.swapped_order(v).ravel() for v in x])
    elif swapped:
        want = np.stack([ck.swapped_order(v).ravel() for v in want])
    re = torch.from_numpy(feed.real.astype(np.float32))
    im = torch.from_numpy(feed.imag.astype(np.float32))
    plain = ck.fft_twofactor_plain(re, im, inverse, scale, swapped)
    got = ck.fft_twofactor(re, im, inverse, scale, swapped, out=(re, im))
    assert got[0] is re and got[1] is im
    assert torch.equal(re, plain[0]) and torch.equal(im, plain[1])
    g = re.double().numpy() + 1j * im.double().numpy()
    assert np.abs(g - want).max() / np.abs(want).max() <= NUMPY_TOL
