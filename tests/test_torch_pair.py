"""`fft_pair` on the CPU: the planes it serves (`pair_cluster`, the same
set as before the kernel held its plane once), its layout rule
(`pair_layout`, `pair_splits`, the one the C entry of
``csrc/fft_pair.cu`` checks) over every served plane, the cluster sweep's
layouts at 256 x 256, the arguments each launch passes (the C library
stubbed out, on meta tensors), and its plain version against the JAX
package's ``_pair_kernel`` in interpret mode and numpy fp64, also on the
planes whose long axis runs as two factors.  The kernel itself runs only
on the card (chip_smoke.py, phases kernels and times)."""
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
# csrc/inplace.cuh: the fixed radices and the points a thread holds in a
# round; csrc/cluster.cuh: kXchg; csrc/stockham.cuh: kMaxStages
FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
XCHG = 16
MAX_STAGES = 16
LENGTHS = [n for n in range(2, 8193) if ck.kernel_supports(n)]


def _old_cluster(ny, nz):
    """The cluster rule of the kernel of two plane copies: the smallest
    cluster whose blocks need at most 32 KB of two buffers, else the
    largest that fits 128 KB."""
    if not (ck.kernel_supports(ny) and ck.kernel_supports(nz)):
        return None
    fits = [c for c in (1, 2, 4, 8, 16) if ny % c == 0 and nz % c == 0
            and 16 * ny * nz // c <= 128 * 1024]
    small = [c for c in fits if 16 * ny * nz // c <= 32 * 1024]
    return small[0] if small else (fits[-1] if fits else None)


def _served():
    out = []
    for ny in LENGTHS:
        for nz in LENGTHS:
            if ny * nz > 131072:
                break
            if ck.pair_cluster(ny, nz) is not None:
                out.append((ny, nz))
    return out


SERVED = _served()
# served planes with an axis of two factors at the rule's threads
# (4982 while a generic stage held 16 outputs a thread; 5198 since it
# holds 2 items of 4 output pairs, a butterfly's (r + 1) / 2 pairs)
TWO_FACTOR_PLANES = 5198


def _rounds_fit(m, threads):
    if m == 1:
        return True
    return all((max(1, 12 // r) * threads >= m // r) if r in FIXED_RADICES
               else 2 * threads >= m // r * -(-(r // 2 + 1) // 4)
               for r in ck.walk_radices(m))


def _table_points(m):
    """What the C entry's table_len reads off a factor's plan ints."""
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


def test_served_planes_are_unchanged():
    """Which planes have a pair cluster did not move: every (ny, nz) of
    kernel lengths up to 2^17 points against the old rule, and larger or
    out-of-range planes still refused."""
    seen = 0
    for ny in LENGTHS:
        for nz in LENGTHS:
            if ny * nz > 2 * 131072:
                break
            assert ck.pair_cluster(ny, nz) == _old_cluster(ny, nz), (ny, nz)
            seen += 1
    assert len(SERVED) == 54099 and seen > len(SERVED)
    for ny, nz in ((512, 512), (1, 64), (67, 64), (1000, 100), (8192, 32)):
        assert ck.pair_cluster(ny, nz) is None, (ny, nz)


def _layout_ok(ny, nz, c, threads, smem, splits):
    (n1z, n2z), (n1y, n2y) = splits
    points = ((ny // c) * n2z * (n1z | 1)
              + sum(_table_points(k) for k in (n1z, n2z, n1y, n2y))
              + 128 + -(-nz // 64) + -(-ny // 64))
    return (c in (1, 2, 4, 8, 16) and ny % c == 0 and nz % c == 0
            and threads % 32 == 0 and 32 <= threads <= 1024
            and ny * nz // c <= XCHG * threads
            and n1z * n2z == nz and n1y * n2y == ny
            and n1z >= n2z and n1y >= n2y
            and all(_rounds_fit(k, threads) for k in (n1z, n2z, n1y, n2y))
            and smem == 8 * points <= ck.MAX_SMEM_BYTES)


def test_layout_rule_every_served_plane():
    """Every served plane gets a layout the C entry accepts: the smallest
    cluster whose blocks hold at most 4096 points, else the largest (at
    most 8192 points a block), a multiple of 32 threads up to 512 for 16
    points a thread (so at most 16 of an exchange), each axis one pass
    where its stages fit a round and else two factors, and the exact
    shared bytes, at most 227 KB."""
    two = 0
    for ny, nz in SERVED:
        c, threads, smem = ck.pair_layout(ny, nz)
        splits = ck.pair_splits(ny, nz)
        fits = [k for k in (1, 2, 4, 8, 16) if ny % k == 0 and nz % k == 0]
        small = [k for k in fits if ny * nz // k <= 4096]
        assert c == (small[0] if small else fits[-1]), (ny, nz)
        assert ny * nz // c <= 8192 and threads <= 512
        assert threads == max(32, -(-(ny * nz // c) // 512) * 32)
        for n, (n1, n2) in zip((nz, ny), splits):
            assert (n2 == 1) == _rounds_fit(n, threads), (ny, nz)
        assert _layout_ok(ny, nz, c, threads, smem, splits), (ny, nz)
        two += splits[0][1] > 1 or splits[1][1] > 1
    assert two == TWO_FACTOR_PLANES


@pytest.mark.parametrize("n,threads,split", [
    (8064, 512, (112, 72)), (8192, 512, (128, 64)), (7182, 512, (114, 63)),
    (256, 512, (256, 1)), (8192, 1024, (8192, 1))])
def test_axis_factors(n, threads, split):
    """An axis one pass where its stages fit a round, else the two factors
    of fewest stages, then the most square, that fit."""
    got = ck._pair_factors(n, threads)
    assert got == split
    if split[1] > 1:
        cost = {(n // d, d): sum(1.0 if r in FIXED_RADICES else r / 8
                                 for k in (n // d, d)
                                 for r in ck.walk_radices(k))
                for d in range(2, n) if n % d == 0 and n // d >= d
                and ck.stage_radices(n // d) and ck.stage_radices(d)
                and _rounds_fit(n // d, threads) and _rounds_fit(d, threads)}
        least = min(cost.values())
        assert cost[split] == least
        assert split[1] == max(p[1] for p, v in cost.items() if v == least)


def test_cluster_sweep_layouts(monkeypatch):
    """At the main path's 256 x 256 (256 = 16 * 16, one pass each way): a
    cluster of 16 by the rule (4096 points, 256 threads); the sweep's
    clusters of 8 (8192 points, 512 threads) and 4 (16384 points, 1024
    threads, one block an SM by shared memory), and 8 points a thread,
    have layouts the C entry takes."""
    assert ck.pair_layout(256, 256)[:2] == (16, 256)
    assert ck.pair_splits(256, 256) == ((256, 1), (256, 1))
    # shared memory holds five such blocks an SM (registers four)
    assert 233472 // (ck.pair_layout(256, 256)[2] + 1024) == 5
    for tile, aim, want in ((16384, 16, (4, 1024)), (8192, 16, (8, 512)),
                            (8192, 8, (8, 1024)), (4096, 8, (16, 512))):
        monkeypatch.setattr(ck, "PAIR_TILE_POINTS", tile)
        monkeypatch.setattr(ck, "PAIR_AIM_POINTS", aim)
        c, threads, smem = ck.pair_layout(256, 256)
        assert (c, threads) == want
        assert _layout_ok(256, 256, c, threads, smem,
                          ck.pair_splits(256, 256))
        if c == 4:
            assert 233472 // (smem + 1024) == 1


class _Recorder:
    """The C library stub: each ``vk_fft_pair`` call's arguments, the plans
    read back from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "vk_fft_pair":
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[5:9]]
                self.calls.append({"batch": args[4], "plans": plans,
                                   "layout": tuple(args[15:18])})
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
    monkeypatch.setattr(ck, "fft_pair_plain", None)
    ck.reset_launches()
    calls = torch_engine.calls
    yield lib
    assert torch_engine.calls == calls


@pytest.mark.parametrize("ny,nz", [(256, 256), (2, 8064), (8064, 2),
                                   (47, 60), (16, 16)])
def test_launch_arguments(monkeypatch, ny, nz):
    """Each direction launches once with the batch, the unscaled plans of
    each axis's factors (z1, z2, y1, y2), the layout of `pair_layout`, the
    scale in the y axis's twiddle table; in place when ``out`` is the
    input."""
    (n1z, n2z), (n1y, n2y) = ck.pair_splits(ny, nz)
    B = 3
    x = (torch.empty(B, ny, nz, device="meta"),
         torch.empty(B, ny, nz, device="meta"))
    with _stubbed_launches(monkeypatch) as lib:
        scale = 1.0 / (ny * nz)
        for inverse in (False, True):
            y = ck.fft_pair(*x, inverse, scale if inverse else 1.0)
            assert y[0].shape == (B, ny, nz) and y[1].shape == (B, ny, nz)
        y = ck.fft_pair(*x, out=x)
        assert y[0] is x[0] and y[1] is x[1]
        assert ck.launches == {k: 3 if k == "fft_pair" else 0
                               for k in ck.KERNEL_SOURCES}
    for call, inverse in zip(lib.calls, (False, True, False), strict=True):
        assert call["batch"] == B
        assert call["layout"] == ck.pair_layout(ny, nz)
        for ints, m in zip(call["plans"], (n1z, n2z, n1y, n2y)):
            assert ints == list(ck.stage_tables(m, inverse, 1.0, True)[0])
    key = ("twofactor_pair", ny, True, scale, "meta")
    assert tuple(ck._DEVICE_TABLES[key].shape) == (64 + -(-ny // 64), 2)


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_pair_kernel_on_an_odd_plane(inverse):
    """On a (48, 60) plane (cluster 1, odd factors 3 and 5) the plain
    version agrees with the JAX package's ``_pair_kernel`` in interpret
    mode and with numpy, in place."""
    rng = np.random.default_rng(48 + inverse)
    re = rng.standard_normal((2, 48, 60)).astype(np.float32)
    im = rng.standard_normal((2, 48, 60)).astype(np.float32)
    scale = 1.0 / 2880 if inverse else 0.5
    pallas_engine.set_interpret(True)
    try:
        rr, ri = pallas_engine.fft_pair_planar(
            jnp.asarray(re), jnp.asarray(im), 48, 60, inverse, scale=scale)
    finally:
        pallas_engine.set_interpret(False)
    tr, ti = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    got = ck.fft_pair(tr, ti, inverse, scale, out=(tr, ti))
    assert got[0] is tr and got[1] is ti
    g = _c(tr.numpy(), ti.numpy())
    assert _rel(g, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    want = (np.fft.ifft2(x) * 2880 if inverse else np.fft.fft2(x)) * scale
    assert _rel(g, want) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(2, 2, 8064), (1, 8064, 2), (3, 2, 7182)])
def test_plain_on_two_factor_planes(shape):
    """On planes whose long axis the kernel runs as two factors the plain
    version agrees with numpy both ways."""
    rng = np.random.default_rng(sum(shape))
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    _, ny, nz = shape
    assert any(s[1] > 1 for s in ck.pair_splits(ny, nz))
    x = _c(re, im)
    yr, yi = ck.fft_pair(torch.from_numpy(re), torch.from_numpy(im), False)
    assert _rel(_c(yr, yi), np.fft.fft2(x)) <= NUMPY_TOL
    zr, zi = ck.fft_pair(yr, yi, True, 1.0 / (ny * nz))
    assert _rel(_c(zr, zi), x) <= NUMPY_TOL
