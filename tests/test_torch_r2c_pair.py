"""`fft_r2c_pair` / `fft_c2r_pair` on the CPU: the real planes they serve
(`r2c_pair_cluster`, the same set as before the kernels held a plane
once), their layout rule (`r2c_pair_layout`, `r2c_pair_splits`, the one
the C entries of ``csrc/fft_r2c_pair.cu`` check) over every served plane,
the cluster sweep's layouts at 256 x 256, the arguments each launch
passes (the C library stubbed out, on meta tensors), and the plain
versions against the JAX package's ``_r2c_pair_kernel`` /
``_c2r_pair_kernel`` in interpret mode, its jnp engine where the Pallas
kernels do not take the plane, and numpy fp64.  The kernels themselves
run only on the card (chip_smoke.py, phases real_kernels and
real_times)."""
import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
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


def _old_cluster(ny, m):
    """The cluster rule of the kernel of two plane copies on the (ny, m =
    nz/2) complex points: the smallest cluster whose blocks need at most
    32 KB of two buffers, else the largest that fits 128 KB."""
    if not (ck.kernel_supports(ny) and ck.kernel_supports(m)):
        return None
    fits = [c for c in (1, 2, 4, 8, 16) if ny % c == 0 and m % c == 0
            and 16 * ny * m // c <= 128 * 1024]
    small = [c for c in fits if 16 * ny * m // c <= 32 * 1024]
    return small[0] if small else (fits[-1] if fits else None)


def _served():
    out = []
    for ny in LENGTHS:
        for m in LENGTHS:
            if ny * m > 131072:
                break
            if ck.r2c_pair_cluster(ny, 2 * m) is not None:
                out.append((ny, 2 * m))
    return out


SERVED = _served()
# served real planes with an axis of two factors at the rule's threads
# (4982 while a generic stage held 16 outputs a thread; 5198 since it
# holds 2 items of 4 output pairs, a butterfly's (r + 1) / 2 pairs)
TWO_FACTOR_PLANES = 5198


def _rounds_fit(n, threads):
    if n == 1:
        return True
    return all((max(1, 12 // r) * threads >= n // r) if r in FIXED_RADICES
               else 2 * threads >= n // r * -(-(r // 2 + 1) // 4)
               for r in ck.walk_radices(n))


def _table_points(n):
    """What the C entry's table_len reads off a factor's plan ints."""
    if n == 1:
        return 0
    ints, _ = ck.stage_tables(n, False, 1.0, True)
    M, end = n, 0
    for s in range(ints[1]):
        r = ints[3 + s]
        tw_off, dft_off = ints[3 + MAX_STAGES + s], ints[3 + 2 * MAX_STAGES + s]
        M //= r
        end = max(end, dft_off + r if dft_off >= 0 else tw_off + r * M)
    return end


def _layout_ok(ny, nz, c, threads, smem, splits):
    """The C entry's check (layout_of): the cluster divides ny and m, a
    thread moves at most kXchg points of an exchange, every stage's round
    holds a whole sequence, and the shared bytes are exact: the row tile,
    the four stage tables, the z twiddles (the m-point inter-factor
    twiddle, the untangle's roots) and the y twiddle."""
    m = nz // 2
    (n1z, n2z), (n1y, n2y) = splits
    points = ((ny // c) * n2z * (n1z | 1)
              + sum(_table_points(k) for k in (n1z, n2z, n1y, n2y))
              + 64 + -(-m // 64) + 64 + (m // 2) // 64 + 1
              + 64 + -(-ny // 64))
    return (c in (1, 2, 4, 8, 16) and ny % c == 0 and m % c == 0
            and threads % 32 == 0 and 32 <= threads <= 1024
            and ny * m // c <= XCHG * threads
            and n1z * n2z == m and n1y * n2y == ny
            and n1z >= n2z and n1y >= n2y
            and all(_rounds_fit(k, threads) for k in (n1z, n2z, n1y, n2y))
            and smem == 8 * points <= ck.MAX_SMEM_BYTES)


def test_served_planes_are_unchanged():
    """Which real planes have a pair cluster did not move: every (ny, nz)
    of kernel lengths ny and nz/2 up to 2^18 complex points against the old
    rule, and odd nz, larger or out-of-range planes still refused."""
    seen = 0
    for ny in LENGTHS:
        for m in LENGTHS:
            if ny * m > 2 * 131072:
                break
            assert ck.r2c_pair_cluster(ny, 2 * m) == _old_cluster(ny, m), \
                (ny, m)
            seen += 1
    assert len(SERVED) == 54099 and seen > len(SERVED)
    for ny, nz in ((1024, 1024), (47, 360), (67, 64), (64, 67), (8, 2),
                   (2, 16386), (512, 1024)):
        assert ck.r2c_pair_cluster(ny, nz) is None, (ny, nz)


def test_layout_rule_every_served_plane():
    """Every served real plane gets a layout the C entries accept: on its
    (ny, m) complex points the smallest cluster whose blocks hold at most
    4096 points, else the largest (at most 8192 points a block), a
    multiple of 32 threads up to 512 for 16 points a thread (so at most 16
    of an exchange), each axis one pass where its stages fit a round and
    else two factors, and the exact shared bytes, at most 227 KB."""
    two = 0
    for ny, nz in SERVED:
        m = nz // 2
        c, threads, smem = ck.r2c_pair_layout(ny, nz)
        splits = ck.r2c_pair_splits(ny, nz)
        fits = [k for k in (1, 2, 4, 8, 16) if ny % k == 0 and m % k == 0]
        small = [k for k in fits if ny * m // k <= 4096]
        assert c == (small[0] if small else fits[-1]), (ny, nz)
        assert ny * m // c <= 8192 and threads <= 512
        assert threads == max(32, -(-(ny * m // c) // 512) * 32)
        for n, (n1, n2) in zip((m, ny), splits):
            assert (n2 == 1) == _rounds_fit(n, threads), (ny, nz)
        assert _layout_ok(ny, nz, c, threads, smem, splits), (ny, nz)
        two += splits[0][1] > 1 or splits[1][1] > 1
    assert two == TWO_FACTOR_PLANES


def test_cluster_sweep_layouts(monkeypatch):
    """At the main path's 256 x 256 (m = 128, one pass each way): a
    cluster of 8 by the rule (4096 points, 256 threads); the sweep's
    clusters of 4 (8192 points) and 16 (2048 points), and 8 points a
    thread, have layouts the C entries take."""
    assert ck.r2c_pair_layout(256, 256)[:2] == (8, 256)
    assert ck.r2c_pair_splits(256, 256) == ((128, 1), (256, 1))
    for tile, aim, want in ((8192, 16, (4, 512)), (8192, 8, (4, 1024)),
                            (2048, 16, (16, 128)), (4096, 8, (8, 512))):
        monkeypatch.setattr(ck, "PAIR_TILE_POINTS", tile)
        monkeypatch.setattr(ck, "PAIR_AIM_POINTS", aim)
        c, threads, smem = ck.r2c_pair_layout(256, 256)
        assert (c, threads) == want
        assert _layout_ok(256, 256, c, threads, smem,
                          ck.r2c_pair_splits(256, 256))


def test_generic_instantiation():
    """The forward kernel's instantiation with the generic stage serves
    exactly the planes with a prime factor above 7 in m = nz/2 or ny (the
    stages of the others all have a butterfly of their own): 44499 of the
    served planes, not the main path's 256 x 256."""
    generic = 0
    for ny, nz in SERVED:
        want = any(p > 7 for p in ck.prime_factors(nz // 2)
                   + ck.prime_factors(ny))
        assert ck.r2c_pair_generic(ny, nz) == want, (ny, nz)
        generic += want
    assert generic == 44499
    assert not ck.r2c_pair_generic(256, 256)
    assert ck.r2c_pair_generic(208, 208)


class _Recorder:
    """The C library stub: each launch's arguments, the plans read back
    from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name in ("vk_fft_r2c_pair", "vk_fft_c2r_pair"):
                inverse = name == "vk_fft_c2r_pair"
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[4:8]]
                self.calls.append({"entry": name, "batch": args[3],
                                   "plans": plans,
                                   "scale_z": args[14] if inverse else None,
                                   "layout": tuple(args[14 + inverse:
                                                        17 + inverse])})
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
    monkeypatch.setattr(ck, "fft_r2c_pair_plain", None)
    monkeypatch.setattr(ck, "fft_c2r_pair_plain", None)
    ck.reset_launches()
    calls = torch_engine.calls
    yield lib
    assert torch_engine.calls == calls


@pytest.mark.parametrize("ny,nz", [(256, 256), (2, 16128), (48, 6),
                                   (16, 94), (231, 4)])
def test_launch_arguments(monkeypatch, ny, nz):
    """Each direction launches once with the batch, the unscaled plans of
    each axis's factors (z1, z2 of nz/2, y1, y2), the layout of
    `r2c_pair_layout`, scale_z as an argument of the inverse and scale_y in
    its y twiddle table."""
    (n1z, n2z), (n1y, n2y) = ck.r2c_pair_splits(ny, nz)
    B = 3
    x = torch.empty(B, ny, nz, device="meta")
    with _stubbed_launches(monkeypatch) as lib:
        yr, yi = ck.fft_r2c_pair(x)
        assert yr.shape == yi.shape == (B, ny, nz // 2 + 1)
        z = ck.fft_c2r_pair(yr, yi, nz, 1.0 / ny, 2.0 / nz)
        assert z.shape == (B, ny, nz)
        assert ck.launches == {k: 2 if k == "fft_r2c_pair" else 0
                               for k in ck.KERNEL_SOURCES}
    for call, inverse in zip(lib.calls, (False, True), strict=True):
        assert call["entry"] == ("vk_fft_c2r_pair" if inverse
                                 else "vk_fft_r2c_pair")
        assert call["batch"] == B
        assert call["layout"] == ck.r2c_pair_layout(ny, nz)
        assert call["scale_z"] == (pytest.approx(2.0 / nz) if inverse
                                   else None)
        for ints, n in zip(call["plans"], (n1z, n2z, n1y, n2y)):
            assert ints == list(ck.stage_tables(n, inverse, 1.0, True)[0])
    twy = ck._DEVICE_TABLES[("twofactor_pair", ny, True, 1.0 / ny, "meta")]
    assert tuple(twy.shape) == (64 + -(-ny // 64), 2)
    twz = ck._DEVICE_TABLES[("r2c_twiddle", nz, True, "meta")]
    assert tuple(twz.shape) == (len(ck.r2c_twiddle(nz, True)), 2)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


@pytest.mark.parametrize("shape", [(1, 128, 256), (2, 256, 128)])
def test_plain_matches_pallas_pair_kernels(shape):
    """On planes of a cluster of 4 the plain versions agree with the JAX
    package's ``_r2c_pair_kernel`` / ``_c2r_pair_kernel`` in interpret
    mode, and with numpy."""
    _, ny, nz = shape
    assert ck.r2c_pair_layout(ny, nz)[0] == 4
    x = _real(shape, seed=ny + nz)
    pallas_engine.set_interpret(True)
    try:
        ref = pallas_engine.rfft2_pair_planar(jnp.asarray(x))
        yr, yi = ck.fft_r2c_pair(torch.from_numpy(x))
        back = pallas_engine.irfft2_pair_planar(jnp.asarray(yr.numpy()),
                                                jnp.asarray(yi.numpy()),
                                                ny, nz)
    finally:
        pallas_engine.set_interpret(False)
    got = _c(yr, yi)
    assert got.shape == (shape[0], ny, nz // 2 + 1)
    assert _rel(got, _c(ref.re, ref.im)) <= REF_TOL
    assert _rel(got, np.fft.rfft2(x.astype(np.float64))) <= NUMPY_TOL
    z = ck.fft_c2r_pair(yr, yi, nz, 1.0 / ny, 2.0 / nz)
    assert _rel(z.numpy(), np.asarray(back)) <= REF_TOL
    assert _rel(z.numpy(), x) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(2, 48, 6), (3, 16, 94), (2, 6, 1350),
                                   (2, 64, 180), (1, 2, 16128), (2, 231, 4)])
def test_plain_on_odd_tiles_and_two_factor_planes(shape):
    """On planes of odd column tiles (m/C odd: over 1 block and over 2)
    and of an axis run as two factors, which the Pallas kernels do not
    take, the plain versions agree with the JAX package's jnp engine and
    with numpy, both ways."""
    _, ny, nz = shape
    c = ck.r2c_pair_layout(ny, nz)[0]
    (_, n2z), (_, n2y) = ck.r2c_pair_splits(ny, nz)
    assert (nz // 2 // c) % 2 == 1 or n2z > 1 or n2y > 1
    x = _real(shape, seed=sum(shape))
    yr, yi = ck.fft_r2c_pair(torch.from_numpy(x))
    got = _c(yr, yi)
    ref = np.asarray(vk.rfft2(x, engine="jnp"))
    assert _rel(got, ref) <= REF_TOL
    assert _rel(got, np.fft.rfft2(x.astype(np.float64))) <= NUMPY_TOL
    z = ck.fft_c2r_pair(yr, yi, nz, 1.0 / ny, 2.0 / nz)
    back = vk.irfft2(torch.complex(yr, yi).numpy(), s=(ny, nz),
                     engine="jnp")
    assert _rel(z.numpy(), np.asarray(back)) <= REF_TOL
    assert _rel(z.numpy(), x) <= NUMPY_TOL
