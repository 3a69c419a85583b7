"""`fft_strided_tw` on the in-place walk (csrc/fft_strided_tw.cu) and the
long tier's reorder folded into a pass, on the CPU: its layout rule
(`strided_tw_layout`, `strided_tw_split`, the one its C entry checks) at
every length it serves over several S, the arguments each launch passes
(the C library stubbed out, on meta tensors), the transposed store and
read of its plain version against numpy's transpose of the plain pass,
the fold rule (`long_folds`) and the folded natural order against numpy
on splits that fold and splits that keep the transpose.  The kernel
itself runs only on the card (chip_smoke.py, phases long_kernels and
long_times)."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck

NUMPY_TOL = 5e-6
FIXED_RADICES = (2, 3, 4, 5, 7, 8, 16)
MAX_STAGES = 16
LENGTHS = [n for n in range(2, 8193) if ck.strided_tw_supports(n)]
COLUMNS = (1, 37, 65536)


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


def _layout_ok(n, S, ts, threads, smem, split):
    """The C entry's check: 1 <= ts <= S, a multiple of 32 threads up to
    1024 whose rounds hold a whole sequence of every stage, and the exact
    shared bytes (ts lines at tile_stride's stride: one pass of 1, 2, 4 or
    8 columns n rounded up to 16 / ts mod 16 where that fits, else (n2 *
    (n1 | 1)) | 1; both stage tables, the twiddle's two tables), at most
    227 KB."""
    n1, n2 = split
    tables = _table_points(n1) + _table_points(n2) + 64 + -(-n // 64)
    stride = (n2 * (n1 | 1)) | 1
    if n2 == 1 and ts in (1, 2, 4, 8):
        even = n1 + (16 // ts - n1) % 16
        assert even % 16 == 16 // ts % 16 and n1 <= even < n1 + 16
        if ts * even + tables <= ck.MAX_SMEM_BYTES // 8:
            stride = even
    points = ts * stride + tables
    return (1 <= ts <= S and n1 * n2 == n and n1 >= n2
            and threads % 32 == 0 and 32 <= threads <= 1024
            and _rounds_fit(n1, threads) and _rounds_fit(n2, threads)
            and smem == 8 * points <= ck.MAX_SMEM_BYTES)


def test_layout_every_served_length():
    """Every length the factor mode serves (n <= 8192, primes <= 127), over
    S in COLUMNS, gets a layout the C entry accepts: `fft_strided`'s
    columns (4096 // n, at least 8 where S and shared memory allow it),
    one pass where 8 padded columns fit beside the tables and the stages
    fit a round, else two factors."""
    assert len(LENGTHS) == 3678
    for n in LENGTHS:
        for S in COLUMNS:
            ts, threads, smem = ck.strided_tw_layout(n, S)
            split = ck.strided_tw_split(n, S)
            assert _layout_ok(n, S, ts, threads, smem, split), (n, S)
            assert threads == min(1024, max(32, -(-(ts * n) // 512) * 32))
            if n <= 2048:
                assert ts == min(S, max(8, 4096 // n)), (n, S)


@pytest.mark.parametrize("n,S,want", [
    (512, 2048, (8, 256, (512, 1))), (256, 65536, (16, 256, (256, 1))),
    (2048, 512, (8, 1024, (2048, 1))), (4096, 4096, (6, 1024, (256, 16))),
    (8192, 96, (3, 1024, (128, 64))), (343, 384, (11, 256, (343, 1))),
    (254, 101, (16, 256, (254, 1))), (1024, 1, (1, 64, (64, 16)))])
def test_named_layouts(n, S, want):
    """The 2^20 row's strided pass (512 over 2048 columns), three uploads'
    256-point passes, the long Bluestein's 343, a prime above 64, the long
    axes and a lone column too long for one pass at its threads."""
    ts, threads, _ = ck.strided_tw_layout(n, S)
    assert (ts, threads, ck.strided_tw_split(n, S)) == want


class _Recorder:
    """The C library stub: each `vk_fft_strided_tw` call's scalars, plans,
    factors and layout, read back while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            plans = [list((ctypes.c_int * 51).from_address(a))
                     for a in args[8:10]]
            factors = list((ctypes.c_longlong * 16).from_address(args[13]))
            self.calls.append({"scalars": args[4:8], "plans": plans,
                               "factors": factors, "tail": args[14:20]})
            return 0
        return call


@contextlib.contextmanager
def _recorded(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(ck, "_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launches()
    yield lib


@pytest.mark.parametrize("case", [
    ("natural", (16, 512, 2048), dict(post=ck.twiddle(1 << 20)), 0,
     (16, 512, 2048)),
    ("store transposed", (16, 512, 2048),
     dict(post=ck.twiddle(1 << 20), out_transposed=True), 2, (16, 2048, 512)),
    ("read transposed", (16, 2048, 512),
     dict(pre=ck.twiddle(1 << 20, True), in_transposed=True), 1,
     (16, 512, 2048)),
    ("interleaved", (8, 64, 32), dict(out_interleave=4), 0, (8, 64, 32)),
    ("fold three pass 2", (2, 64, 1024),
     dict(post=ck.twiddle(1 << 16, a=16, sd=16, sm=16)), 0, (2, 64, 1024))])
def test_launch_arguments(monkeypatch, case):
    """One launch a call with P, S, the live lengths, the walk plans of
    `strided_tw_split`'s factors, the factors as 8 ints each (the sm of
    the folded order's column digit among them), the interleaves, the
    mode and `strided_tw_layout`; the output's shape follows the mode."""
    _, shape, kw, mode, out_shape = case
    x = torch.empty(shape, device="meta")
    with _recorded(monkeypatch) as lib:
        y = ck.fft_strided(x, x, False, 0.5, **kw)
        assert tuple(y[0].shape) == out_shape
        assert ck.launches == {k: 1 if k == "fft_strided_tw" else 0
                               for k in ck.KERNEL_SOURCES}
    (call,) = lib.calls
    P, n, S = (shape[0], shape[2], shape[1]) if mode == 1 else shape
    assert call["scalars"] == (P, S, n * S, n * S)
    n1, n2 = ck.strided_tw_split(n, S)
    for ints, f in zip(call["plans"], (n1, n2)):
        assert ints == list(ck.stage_tables(f, False, 1.0, True)[0])
    want = [(kw[k].ints() if kw.get(k) else [0] * 8) for k in ("pre", "post")]
    assert call["factors"] == want[0] + want[1]
    assert call["tail"] == (1, kw.get("out_interleave", 1), mode,
                            *ck.strided_tw_layout(n, S))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("P,n,S", [(2, 16, 12), (3, 254, 5), (1, 96, 77)])
def test_transposed_plain_matches_numpy_transpose(P, n, S, inverse):
    """The plain version's transposed store is numpy's transpose of the
    plain pass's output, and its transposed read the plain pass of
    numpy's transpose of the input, with the factors on."""
    rng = np.random.default_rng(P * n + S)
    re, im = (torch.from_numpy(rng.standard_normal((P, n, S))
                               .astype(np.float32)) for _ in range(2))
    kw = (dict(pre=ck.twiddle(n * S, True)) if inverse
          else dict(post=ck.twiddle(n * S)))
    want = ck.fft_strided_plain(re, im, inverse, 0.5, **kw)
    got = ck.fft_strided(re, im, inverse, 0.5, out_transposed=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy().transpose(0, 2, 1))
    rt, it = (torch.from_numpy(np.ascontiguousarray(t.numpy()
                                                   .transpose(0, 2, 1)))
              for t in (re, im))
    got = ck.fft_strided(rt, it, inverse, 0.5, in_transposed=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_fold_rule():
    """The natural order folds where the last pass holds 8 columns or
    more: two uploads to ns = 2048 (2^21..2^23's ns = 4096 and 8192 keep
    the transpose), three uploads to ns = 2048 over na >= 8 columns;
    never on `fft_twofactor`'s lengths."""
    folds = {k: ck.long_folds(ck.long_split(1 << k)) for k in range(15, 31)}
    assert [k for k, f in folds.items() if not f] == [21, 22, 23, 30]
    assert ck.long_folds((512, 2048)) and not ck.long_folds((512, 4096))
    assert not ck.long_folds((3, 16129))
    assert not ck.long_folds((4, 4, 256)) and ck.long_folds((8, 4, 256))
    assert not ck.long_folds((512, 512, 4096))
    assert not ck.long_folds((103, 107, 9797))


@pytest.mark.parametrize("split", [(64, 512), (8, 4096), (8, 8, 512),
                                   (4, 8, 1024), (32, 1024)])
@pytest.mark.parametrize("inverse", [False, True])
def test_natural_order_matches_numpy(split, inverse):
    """`fft_long_p` in the natural order on splits that fold ((64, 512),
    (8, 8, 512), (32, 1024)) and that keep the transpose ((8, 4096): 3
    columns at 4096; (4, 8, 1024): na = 4 columns), both directions, in
    place of the caller's planes too, against numpy fp64."""
    n = int(np.prod(split))
    assert ck.long_folds(split) == (split not in ((8, 4096), (4, 8, 1024)))
    rng = np.random.default_rng(n + inverse)
    x = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    want = np.fft.ifft(x) * n * 0.5 if inverse else np.fft.fft(x) * 0.5
    for donate in (False, True):
        xp = vt.from_numpy_planar(x.real.astype(np.float32),
                                  x.imag.astype(np.float32), "cpu")
        y = cuda_engine.fft_long_p(xp, n, inverse, 0.5, split=split,
                                   donate=donate)
        got = y.re.numpy() + 1j * y.im.numpy()
        assert np.abs(got - want).max() / np.abs(want).max() <= NUMPY_TOL
