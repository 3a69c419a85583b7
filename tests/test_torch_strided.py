"""`fft_strided` on the CPU: its layout rule (`strided_layout`,
`strided_split`, the one the C entry of ``csrc/fft_strided.cu`` checks)
for every length it serves over several S, the layout sweep's tiles at n
= 256, the arguments each launch passes (the C library stubbed out, on
meta tensors; also in place), and its plain version against the JAX
package's ``_strided_kernel_v3`` (``strided_fft_planar``) and, through
the (P, n, R*nz) view, its ``_outer_kernel`` (``outer_fft_planar``), both
in interpret mode, and numpy fp64.  The kernel itself runs only on the
card (chip_smoke.py, phases kernels and times)."""
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
# round; csrc/stockham.cuh: kMaxStages
FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
MAX_STAGES = 16
LENGTHS = [n for n in range(2, 8193) if ck.kernel_supports(n)]
COLUMNS = (1, 3, 37, 4096, 65536)


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


def _old_columns(n, S):
    """The columns a block of the kernel of two tile copies took."""
    return min(max(1, min(32, 4096 // n)), S)


def _layout_ok(n, S, ts, threads, smem, split):
    """The C entry's check: 1 <= ts <= S, a multiple of 32 threads up to
    1024 whose rounds hold a whole sequence of every stage, and the exact
    shared bytes (the tile, both stage tables, the twiddle's two tables),
    at most 227 KB."""
    n1, n2 = split
    points = (ts * n + _table_points(n1) + _table_points(n2)
              + 64 + -(-n // 64))
    return (1 <= ts <= S and n1 * n2 == n and n1 >= n2
            and threads % 32 == 0 and 32 <= threads <= 1024
            and _rounds_fit(n1, threads) and _rounds_fit(n2, threads)
            and smem == 8 * points <= ck.MAX_SMEM_BYTES)


def test_layout_every_served_length():
    """Every length the kernel serves, over S in COLUMNS, gets a layout
    the C entry accepts: 4096 // n columns, at least 8 (a 32-byte sector a
    plane-row) where S and shared memory allow it (n <= 2048), more
    columns than the old kernel's single one from n = 4096 (S > 1), one
    pass where the one-pass tile holds 8 columns and its stages fit a
    round, else two factors."""
    for n in LENGTHS:
        fit = (ck.MAX_SMEM_BYTES // 8 - _table_points(n) - 64
               - -(-n // 64)) // n
        for S in COLUMNS:
            ts, threads, smem = ck.strided_layout(n, S)
            split = ck.strided_split(n, S)
            assert _layout_ok(n, S, ts, threads, smem, split), (n, S)
            assert threads == min(1024, max(32, -(-(ts * n) // 512) * 32))
            assert ts >= _old_columns(n, S), (n, S)
            if n <= 2048:
                assert ts == min(S, max(8, 4096 // n)), (n, S)
            if n >= 4096 and S > 1:
                assert ts > 1, (n, S)
            one = fit >= 8 and _rounds_fit(n, ck._strided_threads(
                min(S, max(8, 4096 // n)) * n))
            assert (split == (n, 1)) == one, (n, S)


@pytest.mark.parametrize("n,S,want", [
    (256, 65536, (16, 256, (256, 1))), (256, 33024, (16, 256, (256, 1))),
    (64, 262144, (64, 256, (64, 1))), (1024, 16384, (8, 512, (1024, 1))),
    (2048, 37, (8, 1024, (2048, 1))), (4096, 4096, (6, 1024, (256, 16))),
    (8192, 2048, (3, 1024, (128, 64))), (1024, 1, (1, 64, (64, 16))),
    (7, 3, (3, 32, (7, 1)))])
def test_named_layouts(n, S, want):
    """The main path's 256-point axis, the long axes' tiles (6 columns at
    4096 and 3 at 8192, where the old kernel read one) and a lone column
    too long for one pass at its threads."""
    ts, threads, _ = ck.strided_layout(n, S)
    assert (ts, threads, ck.strided_split(n, S)) == want


def test_layout_sweep_tiles(monkeypatch):
    """The layout sweep at n = 256 (chip_smoke.py): 8, 16, 32 and 64
    columns a block, each a layout the C entry takes."""
    for tile, ts in ((2048, 8), (4096, 16), (8192, 32), (16384, 64)):
        monkeypatch.setattr(ck, "STRIDED_TILE_POINTS", tile)
        for S in (65536, 33024):
            got = ck.strided_layout(256, S)
            assert got[0] == ts
            assert _layout_ok(256, S, *got, ck.strided_split(256, S))


class _Recorder:
    """The C library stub: each ``vk_fft_strided`` call's arguments, the
    plans read back from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "vk_fft_strided":
                plans = [list((ctypes.c_int * 51).from_address(a))
                         for a in args[6:8]]
                self.calls.append({"P": args[4],
                                   "S": args[5], "plans": plans,
                                   "layout": tuple(args[11:14])})
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
    monkeypatch.setattr(ck, "fft_strided_plain", None)
    ck.reset_launches()
    calls = torch_engine.calls
    yield lib
    assert torch_engine.calls == calls


@pytest.mark.parametrize("shape", [(1, 256, 65536), (256, 256, 256),
                                   (3, 8192, 5), (2, 1000, 1), (5, 47, 2)])
def test_launch_arguments(monkeypatch, shape):
    """Each direction launches once with P, S, the unscaled plans of the
    split's factors, the layout of `strided_layout` and the scale in the
    twiddle's table; in place, the output planes are the input's."""
    P, n, S = shape
    n1, n2 = ck.strided_split(n, S)
    x = (torch.empty(shape, device="meta"), torch.empty(shape, device="meta"))
    with _stubbed_launches(monkeypatch) as lib:
        for inverse in (False, True):
            y = ck.fft_strided(*x, inverse, 1.0 / n if inverse else 1.0)
            assert y[0].shape == y[1].shape == shape
        y = ck.fft_strided(*x, out=x)
        assert y[0] is x[0] and y[1] is x[1]
        assert ck.launches == {k: 3 if k == "fft_strided" else 0
                               for k in ck.KERNEL_SOURCES}
    for call, inverse in zip(lib.calls, (False, True, False), strict=True):
        assert (call["P"], call["S"]) == (P, S)
        assert call["layout"] == ck.strided_layout(n, S)
        for ints, m in zip(call["plans"], (n1, n2)):
            assert ints == list(ck.stage_tables(m, inverse, 1.0, True)[0])
    key = ("twofactor_pair", n, True, 1.0 / n, "meta")
    assert tuple(ck._DEVICE_TABLES[key].shape) == (64 + -(-n // 64), 2)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


@pytest.mark.parametrize("shape", [(3, 2, 5), (4, 48, 19), (2, 1024, 3),
                                   (3, 64, 37)])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_strided_kernel(shape, inverse):
    """P > 1, ragged S (not a multiple of any tile) and n = 2 / 48 / 1024:
    the plain version (through the wrapper on CPU planes, in place) agrees
    with the JAX package's ``_strided_kernel_v3`` in interpret mode and
    with numpy."""
    P, n, S = shape
    re, im = _planes(shape, seed=P * n + S + inverse)
    scale = 1.0 / n if inverse else 0.5
    pallas_engine.set_interpret(True)
    try:
        rr, ri = pallas_engine.strided_fft_planar(
            jnp.asarray(re), jnp.asarray(im), n, inverse, scale=scale)
    finally:
        pallas_engine.set_interpret(False)
    tr, ti = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    got = ck.fft_strided(tr, ti, inverse, scale, out=(tr, ti))
    assert got[0] is tr and got[1] is ti
    g = _c(tr.numpy(), ti.numpy())
    assert _rel(g, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    want = (np.fft.ifft(x, axis=1) * n if inverse
            else np.fft.fft(x, axis=1)) * scale
    assert _rel(g, want) <= NUMPY_TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_outer_view_matches_outer_kernel(inverse):
    """The leading axis of a (P, n, R, nz) array, which the JAX package
    runs in ``_outer_kernel``, through `fft_strided` on the (P, n, R * nz)
    view of the same memory: the same values, and numpy's."""
    P, n, R, nz = 2, 8, 3, 128
    assert pallas_engine.outer_available(n, R, nz)
    re, im = _planes((P, n, R, nz), seed=n + inverse)
    scale = 1.0 / n if inverse else 1.0
    pallas_engine.set_interpret(True)
    try:
        rr, ri = pallas_engine.outer_fft_planar(
            jnp.asarray(re), jnp.asarray(im), n, inverse, scale=scale)
    finally:
        pallas_engine.set_interpret(False)
    yr, yi = ck.fft_strided(torch.from_numpy(re).view(P, n, R * nz),
                            torch.from_numpy(im).view(P, n, R * nz),
                            inverse, scale)
    g = _c(yr.view(P, n, R, nz), yi.view(P, n, R, nz))
    assert _rel(g, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    want = (np.fft.ifft(x, axis=1) * n if inverse
            else np.fft.fft(x, axis=1)) * scale
    assert _rel(g, want) <= NUMPY_TOL
