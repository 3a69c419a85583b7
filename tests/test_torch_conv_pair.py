"""`fft_conv_pair`'s Bluestein mode on the CPU: its layout rule
(`conv_pair_plan`, `conv_pair_layout`, the one the C entry of
``csrc/fft_conv_pair.cu`` checks) at every padded length the engine sends
it, the cluster sweep's layouts, the four-step twiddle's two root tables,
the arguments each launch passes (the C library stubbed out, on meta
tensors), and its plain version against the JAX package's
``_bluestein_pair_p`` in interpret mode on an odd-width plane.  The kernel
itself runs only on the card (chip_smoke.py, phases any_kernels and
any_times)."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from vkfft_tpu.ops import pallas_engine

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.planner.plan import plan_axis

REF_TOL = 1e-5
NUMPY_TOL = 5e-6
# csrc/inplace.cuh and csrc/fft_conv_pair.cu: the radices of stage_fixed,
# kPoints, kGenericPairs, kGenericItems, kXchg; csrc/stockham.cuh: kMaxStages
FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
POINTS = 12
GENERIC_PAIRS = 4
GENERIC_ITEMS = 2
XCHG = 16
MAX_STAGES = 16


def _served() -> dict:
    """{padded m: [n, ...]} of every 1-D length 5..16384 the engine's
    route sends to fft_conv_pair."""
    out = {}
    for n in range(5, 16385):
        for kernel, _, m in cuda_engine.route(plan_axis(n)) or ():
            if kernel == "fft_conv_pair":
                out.setdefault(m, []).append(n)
    return out


SERVED = _served()


def _plan_table_points(m: int) -> int:
    ints, _ = ck.stage_tables(m, False, 1.0, True)
    M, end = m, 0
    for s in range(ints[1]):
        r = ints[3 + s]
        tw_off, dft_off = ints[3 + MAX_STAGES + s], ints[3 + 2 * MAX_STAGES + s]
        M //= r
        end = max(end, dft_off + r if dft_off >= 0 else tw_off + r * M)
    return end


def _rounds_fit(m: int, threads: int) -> bool:
    for r in ck.walk_radices(m):
        if r in FIXED_RADICES:
            if max(1, POINTS // r) * threads < m // r:
                return False
        elif (GENERIC_ITEMS * threads
              < m // r * -(-(r // 2 + 1) // GENERIC_PAIRS)):
            return False
    return True


def _layout_ok(m, nc, ns, c, threads, smem) -> bool:
    """The C entry's pair_layout_ok."""
    return (c in (1, 2, 4, 8, 16) and nc % c == 0 and ns % c == 0
            and threads % 32 == 0 and 32 <= threads <= 512
            and nc // c * ns <= XCHG * threads
            and _rounds_fit(nc, threads) and _rounds_fit(ns, threads)
            and smem == 8 * ((nc // c) * (ns | 1) + 2 * _plan_table_points(nc)
                             + 2 * _plan_table_points(ns) + 64 + -(-m // 64))
            and smem <= ck.MAX_SMEM_BYTES)


def _stages(n: int) -> float:
    """The walk's stages of an n-point run, a generic radix r as r / 8."""
    return sum(1.0 if r in FIXED_RADICES else r / 8
               for r in ck.walk_radices(n))


def _planes(m):
    """Every (nc, ns) plane of m that the stages take with a cluster of at
    most 8192 points a block."""
    return [(a, m // a) for a in range(1, m + 1)
            if m % a == 0 and a <= m // a and ck.kernel_supports(a)
            and ck.kernel_supports(m // a)
            and any(a % c == 0 and (m // a) % c == 0 and m // c <= 8192
                    for c in (1, 2, 4, 8, 16))]


def _old_plane(m):
    """The plane rule before the cluster had one copy of the plane: the
    most square (nc, ns) whose two buffers fit a cluster of 16 blocks of
    128 KB."""
    best = None
    for nc in range(1, m + 1):
        if m % nc:
            continue
        ns = m // nc
        if nc > ns:
            break
        if ck.kernel_supports(nc) and ck.kernel_supports(ns) and any(
                nc % c == 0 and ns % c == 0 and 16 * m // c <= 128 * 1024
                for c in (1, 2, 4, 8, 16)):
            best = (nc, ns)
    return best


def test_layout_rule_every_served_length():
    """Every padded length the route sends to fft_conv_pair gets a layout
    the C entry accepts, on the plane of the fewest stages (then the most
    square): a cluster dividing both factors with at most 8192 points a
    block, threads that move the block's points in at most 16 a thread,
    whole sequences in a round and the exact shared bytes."""
    assert len(SERVED) == 49 and sum(map(len, SERVED.values())) == 2225
    for m in SERVED:
        nc, ns, c, threads, smem = ck.conv_pair_layout(m)
        assert (nc, ns, c) == ck.conv_pair_plan(m)
        cost = {p: _stages(p[0]) + _stages(p[1]) for p in _planes(m)}
        least = min(cost.values())
        assert cost[(nc, ns)] == least, m
        assert nc == max(p[0] for p, v in cost.items() if v == least), m
        assert nc * ns == m and nc <= ns and m // c <= ck.CONV_PAIR_TILE_MAX
        assert _layout_ok(m, nc, ns, c, threads, smem), m
        # the smallest cluster that fits
        assert c == min(k for k in (1, 2, 4, 8, 16) if nc % k == 0
                        and ns % k == 0 and m // k <= 8192)


def test_plan_covers_the_same_lengths_as_before():
    """Which padded lengths up to 2^16 have a cluster plane did not move."""
    for m in range(2, ck.CONV_PAIR_MAX_M + 1, 7):
        assert (ck.conv_pair_plan(m) is None) == (_old_plane(m) is None), m
    assert ck.conv_pair_plan(66560) is None


def test_cluster_sweep_layouts(monkeypatch):
    """At sample 7's m = 32768 (128 x 256 = (16·8)(16·16), four stages a
    direction): cluster 4 by the rule, two blocks an SM by shared memory;
    the sweep's clusters of 8 and 16 blocks (4096, 2048 points a block)
    have layouts the C entry takes, 2 (16384 points, more than a thread
    moves at 512 threads) has none."""
    m = 32768
    assert ck.conv_pair_layout(m)[:3] == (128, 256, 4)
    assert 233472 // (ck.conv_pair_layout(m)[4] + 1024) == 2
    rule = ck.conv_pair_plan
    for c, threads in ((4, 512), (8, 512), (16, 256)):
        monkeypatch.setattr(ck, "conv_pair_plan",
                            lambda k, c=c: (128, 256, c) if k == m else rule(k))
        nc, ns, got, t, smem = ck.conv_pair_layout(m)
        assert (got, t) == (c, threads)
        assert _layout_ok(m, nc, ns, c, t, smem)
    assert m // 2 > ck.CONV_PAIR_TILE_MAX == 16 * 512


@pytest.mark.parametrize("nc,ns", [(128, 256), (66, 126), (104, 160)])
def test_four_step_twiddle_root_tables(nc, ns):
    """hi[e >> 6] * lo[e & 63] at e = kc * js is the (nc, ns) four-step
    twiddle w_m^(kc*js) (the inverse conjugates it in the kernel)."""
    m = nc * ns
    pair = ck.twofactor_twiddle_pair(m, False)
    assert pair.shape == (64 + -(-m // 64),)
    lo, hi = pair[:64], pair[64:]
    e = (np.arange(nc)[:, None] * np.arange(ns)[None, :]).ravel()
    want = luts.fourstep_twiddle_full(nc, ns).ravel()
    assert np.abs(hi[e >> 6] * lo[e & 63] - want).max() < 1e-14


class _Recorder:
    """The C library stub: each ``vk_fft_conv_pair`` call's arguments, the
    plans read back from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "vk_fft_conv_pair":
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[6:10]]
                self.calls.append({"batch": args[4], "n": args[5],
                                   "plans": plans,
                                   "layout": tuple(args[17:20])})
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
    monkeypatch.setattr(ck, "fft_conv_pair_plain", None)
    ck.reset_launches()
    calls = torch_engine.calls
    yield lib
    assert torch_engine.calls == calls


@pytest.mark.parametrize("n", [10007, 4127, 8198])
def test_launch_arguments(monkeypatch, n):
    """One launch a call with the batch, n, the nc and ns plans forward and
    inverse (no scale, `walk_radices`) and the layout of
    `conv_pair_layout`; in place when ``out`` is the input."""
    m = plan_axis(n).decomp.bluestein_size
    nc, ns, c, _, _ = ck.conv_pair_layout(m)
    B = 3
    x = (torch.empty(B, n, device="meta"), torch.empty(B, n, device="meta"))
    spec = torch.empty(m, 2, device="meta")
    chirp = torch.empty(n, 2, device="meta")
    with _stubbed_launches(monkeypatch) as lib:
        y = ck.fft_conv_pair(*x, spec, chirp)
        assert y[0].shape == (B, n)
        y = ck.fft_conv_pair(*x, spec, chirp, out=x)
        assert y[0] is x[0] and y[1] is x[1]
        assert ck.launches == {k: 2 if k == "fft_conv_pair" else 0
                               for k in ck.KERNEL_SOURCES}
    for call in lib.calls:
        assert call["batch"] == B and call["n"] == n
        assert call["layout"] == ck.conv_pair_layout(m)[2:]
        for ints, (k, inverse) in zip(call["plans"], ((nc, False), (ns, False),
                                                      (ns, True), (nc, True))):
            assert ints == list(ck.stage_tables(k, inverse, 1.0, True)[0])


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_bluestein_pair_on_an_odd_width_plane(inverse):
    """n = 4127 pads to m = 8316 = 66 x 126, whose column tiles are 63
    points wide over 2 blocks: the plain version (through the wrapper on
    CPU planes, in place) agrees with the JAX package's Pallas Bluestein
    pair kernel in interpret mode and with numpy."""
    import jax.numpy as jnp

    from vkfft_tpu.pcomplex import Planar as JPlanar
    n = 4127
    m = plan_axis(n).decomp.bluestein_size
    assert ck.conv_pair_layout(m)[:3] == (66, 126, 2)
    rng = np.random.default_rng(n + inverse)
    re = rng.standard_normal((2, n)).astype(np.float32)
    im = rng.standard_normal((2, n)).astype(np.float32)
    tr, ti = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    got = ck.fft_conv_pair(tr, ti, ck.bluestein_spectrum(n, m, inverse, 1.0,
                                                         "cpu", "pair"),
                           ck.bluestein_chirp(n, m, inverse, "cpu"),
                           out=(tr, ti))
    assert got[0] is tr
    g = tr.double().numpy() + 1j * ti.double().numpy()
    pallas_engine.set_interpret(True)
    try:
        ref = pallas_engine._bluestein_pair_p(
            JPlanar(jnp.asarray(re), jnp.asarray(im)), n, m, inverse)
    finally:
        pallas_engine.set_interpret(False)
    r = np.asarray(ref.re, np.float64) + 1j * np.asarray(ref.im, np.float64)
    assert np.abs(g - r).max() / np.abs(r).max() <= REF_TOL
    x = re.astype(np.float64) + 1j * im
    want = np.fft.ifft(x, axis=1) * n if inverse else np.fft.fft(x, axis=1)
    assert np.abs(g - want).max() / np.abs(want).max() <= NUMPY_TOL
