"""`fft_conv_pair`'s 2-D mode on the CPU: its layout rule
(`conv2d_layout`, the one the C entry of ``csrc/fft_conv_pair.cu`` checks)
over the planes `pair_cluster` serves, the fusion rule's "pair" planes
(the same as before the kernel held one copy of its plane), the arguments
each launch passes (the C library stubbed out, on meta tensors), and the
kernel's index maps replayed in numpy: the row tile's read, the z passes,
the exchange to the column tiles, the y passes, the multiply at each
point's natural index, the mirrored passes on conjugated data, the
exchange back and the write, against numpy fp64.  The kernel itself runs
only on the card (chip_smoke.py, phases conv_kernels and conv_times)."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine

# csrc/inplace.cuh: the fixed radices, the points a thread holds in a round
# and a generic stage's items; csrc/cluster.cuh: kXchg; csrc/stockham.cuh:
# kMaxStages; csrc/fft_conv_pair.cu: kOddXchg, kPlaneThreads
FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
XCHG = 16
ODD_XCHG = 8
MAX_STAGES = 16
PLANE_THREADS = 1024
LENGTHS = [n for n in range(2, 8193) if ck.kernel_supports(n)]
# every SWEEP_STRIDE-th served plane, and named ones: odd primes, an axis
# of two factors, long and thin planes, the main path's 256 x 256
SWEEP_STRIDE = 5
NAMED = ((3, 5), (47, 60), (61, 64), (2, 8064), (8064, 2), (2, 7182),
         (4096, 2), (2, 4096), (256, 256), (81, 81), (16, 60), (59, 2),
         (128, 1024), (1024, 128), (512, 256))
SEED = 31


def _old_cluster(ny, nz):
    """The cluster rule of the kernels of two plane copies (the gate)."""
    if not (ck.kernel_supports(ny) and ck.kernel_supports(nz)):
        return None
    fits = [c for c in (1, 2, 4, 8, 16) if ny % c == 0 and nz % c == 0
            and 16 * ny * nz // c <= 128 * 1024]
    small = [c for c in fits if 16 * ny * nz // c <= 32 * 1024]
    return small[0] if small else (fits[-1] if fits else None)


def _swept():
    out = []
    for ny in LENGTHS:
        for nz in LENGTHS:
            if ny * nz > 131072:
                break
            if ck.pair_cluster(ny, nz) is not None:
                out.append((ny, nz))
    return out[::SWEEP_STRIDE] + list(NAMED)


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


def _entry_takes(ny, nz, c, threads, smem, splits):
    """The C entry's plane_layout_of: the cluster divides both axes, the
    threads move the block's points in at most kXchg each (kOddXchg where
    the column tile's width is odd), every factor's stages fit a round,
    and the shared bytes are exactly the tile area (the z factors' rows at
    the odd pitch n1z | 1) and the tables (four forward stage tables, both
    twiddles' two root tables)."""
    (n1z, n2z), (n1y, n2y) = splits
    points = ((ny // c) * n2z * (n1z | 1)
              + sum(_table_points(k) for k in (n1z, n2z, n1y, n2y))
              + 128 + -(-nz // 64) + -(-ny // 64))
    return (c in (1, 2, 4, 8, 16) and ny % c == 0 and nz % c == 0
            and threads % 32 == 0 and 32 <= threads <= PLANE_THREADS
            and ny * nz // c <= (ODD_XCHG if nz // c % 2 else XCHG) * threads
            and n1z * n2z == nz and n1y * n2y == ny
            and n1z >= n2z and n1y >= n2y
            and all(_rounds_fit(k, threads) for k in (n1z, n2z, n1y, n2y))
            and smem == 8 * points <= ck.MAX_SMEM_BYTES)


def test_layout_covers_the_served_planes():
    """Every swept plane `pair_cluster` serves gets a layout the C entry
    takes, within 227 KB and whole sequences a round: `fft_pair`'s own
    (the same cluster, threads, shared bytes and factors) where the column
    tile's width is even; where it is odd, `fft_pair`'s cluster with a
    thread for at most 8 points of the block (a multiple of 32, up to
    1024) and each axis one pass where its stages fit a round of those
    threads, else two factors; an odd-prime axis, a two-factor axis and
    the (4096, 2)-like planes among them."""
    swept = _swept()
    assert len(swept) > 10000
    two = odd = 0
    for ny, nz in swept:
        assert ck.pair_cluster(ny, nz) is not None, (ny, nz)
        c, threads, smem, splits = ck.conv2d_layout(ny, nz)
        assert _entry_takes(ny, nz, c, threads, smem, splits), (ny, nz)
        two += splits[0][1] > 1 or splits[1][1] > 1
        if nz // c % 2 == 0:
            assert (c, threads, smem) == ck.pair_layout(ny, nz), (ny, nz)
            assert splits == ck.pair_splits(ny, nz), (ny, nz)
            continue
        odd += 1
        assert c == ck.pair_layout(ny, nz)[0], (ny, nz)
        assert threads == max(32, -(-(ny * nz // c) // 256) * 32), (ny, nz)
        for n, (n1, n2) in zip((nz, ny), splits):
            assert (n2 == 1) == _rounds_fit(n, threads), (ny, nz)
            assert (n1, n2) == ck._pair_factors(n, threads), (ny, nz)
    assert two > 500 and odd > 1000
    assert ck.conv2d_layout(4096, 2)[:2] == (2, 256 * 2)
    assert not _entry_takes(4096, 2, *ck.pair_layout(4096, 2),
                            ck.pair_splits(4096, 2))
    # 256 x 256: 16 rows at pitch 257, a 304-point stage table an axis
    # (16 x 16 twiddles, 16 x 1 and two radix-16 roots), 68-point twiddles
    assert ck.conv2d_layout(256, 256) == (16, 256, 8 * (16 * 257 + 2 * 304
                                                        + 2 * 68),
                                          ((256, 1), (256, 1)))
    assert ck.conv2d_layout(8064, 2)[3] == ((2, 1), (112, 72))


@pytest.mark.parametrize("cluster,threads,delta", [
    (32, 256, 0), (16, 224, 0), (16, 2048, 0), (16, 256, 8), (16, 256, -8),
    (8, 256, 0)])
def test_entry_refuses_other_layouts(cluster, threads, delta):
    """At 256 x 256, a cluster, threads or shared bytes off the rule's
    fail the C entry's check (mirrored here): a cluster past 16, threads
    not a multiple of 32 or past 1024, bytes off by a float2, and a
    cluster of 8 at 256 threads (32 points a thread of the exchange)."""
    c, t, smem, splits = ck.conv2d_layout(256, 256)
    assert _entry_takes(256, 256, c, t, smem, splits)
    assert not _entry_takes(256, 256, cluster, threads, smem + delta, splits)


def _conv_cfg(shape):
    return vt.FFTConfig(shape=shape, convolution=True)


@pytest.mark.parametrize("ny", [2, 3, 47, 60, 64, 243, 256, 512, 1000, 4096,
                                8192])
def test_fusion_rule_pairs_the_same_planes(ny):
    """`conv_route` picks "pair" on exactly the planes of the gate before
    the kernel held one copy (the two-buffer cluster rule), at every kernel
    length nz of a stride through 2..8192 beside ny, and v3_rows or the
    composition elsewhere."""
    for nz in LENGTHS[::37] + [2, 64, 256, 8192]:
        if ny * nz > 1 << 18:
            continue
        mode = cuda_engine.conv_route(_conv_cfg((ny, nz)), 2)
        assert (mode == "pair") == (_old_cluster(ny, nz) is not None), (ny, nz)


class _Recorder:
    """The C library stub: each ``vk_fft_conv2d`` call's arguments, the
    plans read back from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "vk_fft_conv2d":
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[8:12]]
                self.calls.append({"batch": args[4], "hp": args[5],
                                   "flags": args[6], "scale": args[7],
                                   "plans": plans,
                                   "layout": tuple(args[19:22])})
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


@pytest.mark.parametrize("ny,nz,hp", [(256, 256, 1), (256, 256, 32),
                                      (2, 8064, 1), (8064, 2, 3),
                                      (47, 60, 3), (3, 5, 1)])
def test_launch_arguments(monkeypatch, ny, nz, hp):
    """One launch a call with the batch, hp, the flags and the scale, the
    forward walk plans (no scale) of each axis's factors (z1, z2, y1, y2)
    and the layout of `conv2d_layout`, their tables and both axes'
    unscaled forward twiddles built for it; in place when ``out`` is the
    input."""
    c, threads, smem, ((n1z, n2z), (n1y, n2y)) = ck.conv2d_layout(ny, nz)
    B = 3 * hp
    x = (torch.empty(B, ny, nz, device="meta"),
         torch.empty(B, ny, nz, device="meta"))
    spec = torch.empty(hp * ny * nz, 2, device="meta")
    scale = 1.0 / (ny * nz)
    for key in [k for k in ck._DEVICE_TABLES if k[-1] == "meta"]:
        del ck._DEVICE_TABLES[key]
    with _stubbed_launches(monkeypatch) as lib:
        y = ck.fft_conv_pair(*x, spec, conj_data=True, scale=scale)
        assert y[0].shape == (B, ny, nz) and y[1].shape == (B, ny, nz)
        y = ck.fft_conv_pair(*x, spec, out=x, xpow=True)
        assert y[0] is x[0] and y[1] is x[1]
        assert ck.launches == {k: 2 if k == "fft_conv_pair" else 0
                               for k in ck.KERNEL_SOURCES}
    for call, flags, s in zip(lib.calls, (ck.CONV_CONJ_DATA, ck.CONV_XPOW),
                              (scale, 1.0), strict=True):
        assert (call["batch"], call["hp"], call["flags"]) == (B, hp, flags)
        assert call["scale"] == s
        assert call["layout"] == (c, threads, smem)
        for ints, m in zip(call["plans"], (n1z, n2z, n1y, n2y)):
            assert ints == list(ck.stage_tables(m, False, 1.0, True)[0])
    # the tables the launches built: the factors' forward stage tables and
    # both axes' forward twiddles, nothing scaled and nothing inverse
    built = {k[:-1]: tuple(t.shape) for k, t in ck._DEVICE_TABLES.items()
             if k[-1] == "meta"}
    want = {("stages", m, False, 1.0, True):
            (len(ck.stage_tables(m, False, 1.0, True)[1]), 2)
            for m in (n1z, n2z, n1y, n2y)}
    want.update({("twofactor_pair", m, False, 1.0): (64 + -(-m // 64), 2)
                 for m in (nz, ny)})
    assert built == want


def _replay(x, spec, hp, conj_data, xpow, scale):
    """The kernel's steps on one plane after another, in complex128: each
    block's row tile at the z factors' places, its passes as DFTs of their
    sequences (the walk's stages leave each sequence in natural order) with
    the twiddle where the kernel fuses it, the exchanges and the sweep
    with the kernel's own index arithmetic."""
    B, ny, nz = x.shape
    c, _, _, ((n1z, n2z), (n1y, n2y)) = ck.conv2d_layout(ny, nz)
    rows, cols = ny // c, nz // c
    pz = n1z | 1
    sz = n2z * pz
    tile = rows * nz
    nzh, ch = nz // 2, cols // 2
    L = spec.reshape(hp, ny, nz)

    def row_at(r, k):
        k1 = k // n2z
        return r * sz + k1 + (k - k1 * n2z) * pz

    def run_pass(buf, k):
        y, mirrored = 2 <= k < 6, k >= 4
        row = bool(k & 1) != mirrored
        n1, n2 = (n1y, n2y) if y else (n1z, n2z)
        if y:
            seqs, S, qs, es, per = ((cols * n2, 1, n1 * cols, cols, n2) if row
                                    else (cols * n1, 1, cols, n1 * cols, n1))
        else:
            seqs, S, qs, es, per = ((rows * n2, sz, pz, 1, n2) if row
                                    else (rows * n1, sz, 1, pz, n1))
        n = n1 if row else n2
        if n == 1:
            return
        q = np.arange(seqs)
        hi, lo = q // per, q % per
        idx = (hi * S + lo * qs)[:, None] + es * np.arange(n)[None, :]
        v = np.fft.fft(buf[idx], axis=1)
        if n2 > 1 and row == mirrored:
            v = v * np.exp(-2j * np.pi * lo[:, None] * np.arange(n)[None, :]
                           / (n1 * n2))
        buf[idx] = v

    out = np.empty_like(x)
    for b in range(B):
        bufs = [np.full(rows * sz, np.nan, np.complex128) for _ in range(c)]
        for rank, buf in enumerate(bufs):   # the read, natural order
            u = np.arange(tile)
            line, t = u // nz, u % nz
            buf[line * sz + (t // n1z) * pz + t % n1z] = \
                x[b, rank * rows + line, t]
        for k in range(8):
            if k == 2:   # push: every row tile read, then stored
                new = np.full((c, rows * sz), np.nan, np.complex128)
                for rank, buf in enumerate(bufs):
                    r0 = rank * rows
                    if cols % 2 == 0:
                        p = np.arange(tile // 2)
                        r = p // nzh
                        k2 = p - r * nzh
                        owner = k2 // ch
                        at = 2 * ((r0 + r) * ch + k2 - owner * ch)
                        new[owner, at] = buf[row_at(r, 2 * k2)]
                        new[owner, at + 1] = buf[row_at(r, 2 * k2 + 1)]
                    else:
                        u = np.arange(tile)
                        r, kz = u // nz, u % nz
                        owner = kz // cols
                        new[owner, (r0 + r) * cols + kz - owner * cols] = \
                            buf[row_at(r, kz)]
                bufs = list(new)
            if k == 4:   # the multiply sweep
                for rank, buf in enumerate(bufs):
                    u = np.arange(tile)
                    q = u // cols
                    k2 = q // n1y
                    ky = (q - k2 * n1y) * n2y + k2
                    X = np.conj(buf[u]) if conj_data else buf[u]
                    Y = X * L[b % hp, ky, rank * cols + u - q * cols]
                    if xpow:
                        Y = Y / np.maximum(np.abs(Y), 1e-30)
                    buf[u] = np.conj(scale * Y)
            if k == 6:   # pull: every column tile read, then written
                held = np.stack(bufs)
                for rank, buf in enumerate(bufs):
                    r0 = rank * rows
                    if cols % 2 == 0:
                        p = np.arange(tile // 2)
                        r = p // nzh
                        k2 = p - r * nzh
                        owner = k2 // ch
                        at = 2 * ((r0 + r) * ch + k2 - owner * ch)
                        buf[:] = np.nan
                        buf[row_at(r, 2 * k2)] = held[owner, at]
                        buf[row_at(r, 2 * k2 + 1)] = held[owner, at + 1]
                    else:
                        u = np.arange(tile)
                        r, kz = u // nz, u % nz
                        owner = kz // cols
                        buf[:] = np.nan
                        buf[row_at(r, kz)] = held[
                            owner, (r0 + r) * cols + kz - owner * cols]
            for buf in bufs:
                run_pass(buf, k)
        for rank, buf in enumerate(bufs):   # the write, conjugated
            u = np.arange(tile)
            line, t = u // nz, u % nz
            out[b, rank * rows + line, t] = np.conj(
                buf[line * sz + (t // n1z) * pz + t % n1z])
    return out


@pytest.mark.parametrize("ny,nz,hp,conj_data,xpow", [
    (16, 16, 1, False, False), (64, 64, 3, True, False),
    (47, 60, 1, False, True), (3, 5, 2, True, True), (2, 8064, 1, True, False),
    (8064, 2, 1, False, True), (96, 60, 3, False, False),
    (128, 128, 1, True, True)])
def test_replayed_index_maps_match_numpy(ny, nz, hp, conj_data, xpow):
    """The kernel's index maps, replayed in numpy, give the circular
    convolution (numpy fp64, 1e-10 of its largest value): even and odd
    column tiles, clusters of 1 to 16 blocks, an axis of two factors (2 x
    8064: 112 x 72) either way round, hp spectra, both flags; seed 31."""
    rng = np.random.default_rng(SEED + ny + nz)
    B = 2 * hp
    x = rng.standard_normal((B, ny, nz)) + 1j * rng.standard_normal((B, ny, nz))
    spec = (rng.standard_normal((hp, ny, nz))
            + 1j * rng.standard_normal((hp, ny, nz)))
    scale = 1.0 / (ny * nz)
    got = _replay(x, spec, hp, conj_data, xpow, scale)
    X = np.fft.fft2(x)
    Y = (np.conj(X) if conj_data else X) * spec[np.arange(B) % hp]
    if xpow:
        Y = Y / np.maximum(np.abs(Y), 1e-30)
    want = np.fft.ifft2(Y) * (ny * nz * scale)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
