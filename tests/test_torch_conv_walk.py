"""`fft_conv` and `fft_conv_inv` on the in-place walk (csrc/fft_conv.cu,
csrc/fft_conv_inv.cu) and the walk's generic prime stage
(csrc/inplace.cuh stage_generic): `fft_conv`'s layout rule (`conv_layout`,
which its C entry checks) for every line length and coordinate count the
routes give it, the arguments each wrapper passes, the kernels' index maps
(where each point is read, multiplied, transformed and written) replayed in
numpy, and the generic stage replayed in numpy thread by thread (its
rounds, its clamped idle slots, its pairwise sums) against numpy.fft.  The
kernels themselves run only on the card (chip_smoke.py)."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from vkfft_tpu_torch import luts
from vkfft_tpu_torch.ops import cuda_engine as ce
from vkfft_tpu_torch.ops import cuda_kernels as ck
from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import plan_axis

FIXED = (2, 3, 4, 5, 7, 8, 16)
PAIRS, ITEMS = 4, 2          # csrc/inplace.cuh: kGenericPairs, kGenericItems
MAX_STAGES = 16              # csrc/stockham.cuh: kMaxStages
LENGTHS = [m for m in range(2, ck.KERNEL_MAX_N + 1) if ck.kernel_supports(m)]
PRIMES = [p for p in range(11, 128) if all(p % d for d in range(2, p))]


def _rounds_fit(n, threads):
    """csrc/inplace.cuh rounds_fit on the walk's radices, restated: a
    thread holds max(1, 12 // r) butterflies of a fixed radix r, 2 items of
    4 output pairs of a generic one (a butterfly's (r + 1) / 2 pairs)."""
    if n == 1:
        return True
    return all((max(1, 12 // r) * threads >= n // r) if r in FIXED
               else ITEMS * threads >= n // r * -(-(r // 2 + 1) // PAIRS)
               for r in ck.walk_radices(n))


def _table_points(n):
    """What the C entry's table_len reads off a factor's plan ints."""
    if n == 1:
        return 0
    ints, _ = ck.stage_tables(n, False, 1.0, True)
    M, end = n, 0
    for s in range(ints[1]):
        r = ints[3 + s]
        tw_off = ints[3 + MAX_STAGES + s]
        dft_off = ints[3 + 2 * MAX_STAGES + s]
        M //= r
        end = max(end, dft_off + r if dft_off >= 0 else tw_off + r * M)
    return end


def _conv_cases():
    """(m, mm) of every `fft_conv` launch the routes make: Rader's p - 1
    and Bluestein's padded m of the 1-D plans of 5..16384 (the fused long
    Bluestein's ns among them), the convolution modes' line lengths (every
    kernel length, matrix mm = 2 and 3 where `conv_matrix_supports`)."""
    cases = {(m, 1) for m in LENGTHS}
    for n in range(5, 16385):
        for kernel, plan, m in ce.route(plan_axis(n)) or ():
            if kernel == "fft_conv":
                cases.add((plan.n - 1 if plan.algorithm is Algorithm.RADER
                           else m, 1))
    cases |= {(m, mm) for m in LENGTHS for mm in (2, 3)
              if ck.conv_matrix_supports(m, mm)}
    return sorted(cases)


CASES = _conv_cases()


def test_conv_layout_every_case():
    """Every (m, mm) gets a layout the C entry accepts: lines a multiple of
    mm, mm * max(1, 8192 // (mm m)) of them, a multiple of 32 threads in
    32..512 near one for 16 points (one pass) or 32 (two factors), one
    pass exactly where a block holds 8 lines or more and the stages fit a
    round, else `fft_lines`' two factors of a lone line, every stage of
    both factors within a round, at most 16384 points a block, and exactly
    the shared bytes of the lines, both directions' stage tables and both
    twiddles, at most 227 KB."""
    assert len(CASES) > 2541
    one = 0
    for m, mm in CASES:
        threads, lines, smem = ck.conv_layout(m, mm)
        n1, n2 = ck.conv_split(m, mm)
        assert n1 * n2 == m and n1 >= n2, (m, mm)
        assert lines == mm * max(1, 8192 // (mm * m)), (m, mm)
        assert lines % mm == 0 and lines * m <= ck.TWOFACTOR_MAX_N, (m, mm)
        want_one = lines >= 8 and _rounds_fit(
            m, min(512, max(32, -(-(-(-lines * m // 16)) // 32) * 32)))
        assert (n2 == 1) == want_one, (m, mm)
        if n2 > 1:
            assert (n1, n2) == ck._lines_factors(m), (m, mm)
        aim = 16 if n2 == 1 else 32
        assert threads == min(512, max(32, -(-(-(-lines * m // aim)) // 32)
                                   * 32)), (m, mm)
        assert threads % 32 == 0 and 32 <= threads <= 512, (m, mm)
        assert _rounds_fit(n1, threads) and _rounds_fit(n2, threads), (m, mm)
        points = (lines * n2 * (n1 | 1)
                  + 2 * (_table_points(n1) + _table_points(n2) + 64
                         + -(-m // 64)))
        assert smem == 8 * points <= ck.MAX_SMEM_BYTES, (m, mm)
        one += n2 == 1
    assert 0 < one < len(CASES)


@pytest.mark.parametrize("m,mm,split,layout", [
    (5002, 1, (82, 61), (160, 1, 47368)),     # Rader 5003 (sample 7's 10006)
    (4096, 1, (256, 16), (256, 2, 73216)),    # v3_1d n = 4096
    (1024, 3, (64, 16), (192, 6, 52864)),     # sample 50's 3 x 3 matrix
    (512, 1, (512, 1), (512, 16, 76160)),     # v3_rows' 512-point rows
    (384, 1, (384, 1), (512, 21, 72680)),     # the long Bluestein's ns
    (539, 1, (539, 1), (512, 15, 75768)),     # Bluestein n = 263
    (61, 1, (61, 1), (512, 134, 68384)),      # a prime line, one pass
    (8192, 1, (128, 64), (256, 1, 72704)),    # the longest line
    (4840, 3, (88, 55), (480, 3, 122696)),    # the largest 3 x 3 matrix
])
def test_conv_layout_of_named_shapes(m, mm, split, layout):
    """The main path's shapes get the layouts recorded in PERF.md."""
    assert ck.conv_split(m, mm) == split
    assert ck.conv_layout(m, mm) == layout


def test_matrix_gate_unchanged():
    """The matrix mode serves the lengths it served when a block held two
    buffers of an item's lines: 16 mm m bytes within 227 KB."""
    for mm in (2, 3):
        got = [m for m in LENGTHS if ck.conv_matrix_supports(m, mm)]
        assert got == [m for m in LENGTHS
                       if 16 * mm * m <= ck.MAX_SMEM_BYTES]
    assert ck.conv_matrix_supports(4096, 3)
    assert not ck.conv_matrix_supports(8192, 3)


# ---------------------------------------------------------------------------
# Launch arguments, the C library stubbed out.
# ---------------------------------------------------------------------------

class _Recorder:
    """The C library stub: each call's arguments, the plans read back from
    their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            nplans = 4 if name == "vk_fft_conv" else 2
            lead = 9 if name == "vk_fft_conv" else 5
            plans = [list((ctypes.c_int * 51).from_address(a))
                     for a in args[lead:lead + nplans]]
            self.calls.append({"entry": name, "lead": args[4:lead],
                               "plans": plans, "ptrs": args[lead + nplans:-4],
                               "layout": tuple(args[-4:-1])})
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


def _meta(*shape):
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("mode,shape,L,chirp,kw", [
    ("scalar", (4, 5002), 5002, None, {}),
    ("scalar", (6, 4096), 4096, None, dict(conj_data=True, xpow=True)),
    ("rows", (14, 512), 7 * 512, None, dict(xpow=True)),
    ("matrix", (2, 3, 1024), 9 * 1024, None, dict(conj_data=True)),
    ("matrix", (5, 2, 96), 4 * 96, None, {}),
    ("bluestein", (3, 263), 539, 263, {}),
])
def test_conv_launch_arguments(monkeypatch, mode, shape, L, chirp, kw):
    """`fft_conv` launches once with its lines (B mm), n, mm, the rows, the
    flags, the unscaled walk plans of `conv_split`'s factors forward then
    inverse, the forward twiddle unscaled and the inverse one with the
    scale, the caller's spectrum and chirp, and `conv_layout`."""
    x = _meta(*shape)
    spec = _meta(L, 2)
    ch = _meta(chirp, 2) if chirp else None
    mm = shape[1] if len(shape) == 3 else 1
    m = L if chirp else shape[-1]
    with _recorded(monkeypatch) as lib:
        y = ck.fft_conv(x, x, spec, ch, scale=0.25, **kw)
        assert y[0].shape == x.shape
        assert ck.launches == {k: int(k == "fft_conv")
                               for k in ck.KERNEL_SOURCES}
    (call,) = lib.calls
    rows = 1 if mm > 1 or chirp else L // shape[-1]
    flags = (int(kw.get("conj_data", False))
             | 2 * int(kw.get("xpow", False)))
    assert call["entry"] == "vk_fft_conv"
    assert call["lead"] == (shape[0] * mm, shape[-1], mm, rows, flags)
    n1, n2 = ck.conv_split(m, mm)
    for ints, (f, inverse) in zip(call["plans"], ((n1, False), (n2, False),
                                                  (n1, True), (n2, True))):
        assert ints == list(ck.stage_tables(f, inverse, 1.0, True)[0])
    assert call["layout"] == ck.conv_layout(m, mm)
    for key, want in ((("twofactor_pair", m, False, 1.0, "meta"),
                       ck.twofactor_twiddle_pair(m, False)),
                      (("twofactor_pair", m, True, 0.25, "meta"),
                       ck.twofactor_twiddle_pair(m, True, 0.25))):
        assert tuple(ck._DEVICE_TABLES[key].shape) == (len(want), 2)


@pytest.mark.parametrize("n,dc", [(7918, True), (134, False), (2, True),
                                  (10240, False)])
def test_conv_inv_launch_arguments(monkeypatch, n, dc):
    """`fft_conv_inv` launches once with the batch, `fft_twofactor`'s
    inverse plans (`stage_radices`), the inverse twiddle's two tables with
    the scale, the spectrum, the constant's planes (null without dc) and
    `twofactor_layout`."""
    x = _meta(3, n)
    d = (_meta(3), _meta(3)) if dc else None
    with _recorded(monkeypatch) as lib:
        y = ck.fft_conv_inv(x, x, _meta(n, 2), d, scale=0.5)
        assert y[0].shape == x.shape
        assert ck.launches == {k: int(k == "fft_conv_inv")
                               for k in ck.KERNEL_SOURCES}
    (call,) = lib.calls
    assert call["entry"] == "vk_fft_conv_inv" and call["lead"] == (3,)
    n1, n2 = ck.twofactor_split(n)
    for ints, f in zip(call["plans"], (n1, n2)):
        assert ints == list(ck.stage_tables(f, True, 1.0)[0])
    assert call["layout"] == ck.twofactor_layout(n)
    key = ("twofactor_pair", n, True, 0.5, "meta")
    assert tuple(ck._DEVICE_TABLES[key].shape) == (64 + -(-n // 64), 2)


# ---------------------------------------------------------------------------
# The kernels' index maps replayed in numpy: the two-factor contract of
# csrc/twofactor.cuh on a block's (n2, P) matrices, each pass a DFT along
# its sequences, the hooks and sweeps at the indices the kernels compute.
# ---------------------------------------------------------------------------

def _w(m, e, inverse=False):
    return np.exp((2j if inverse else -2j) * np.pi * (e % m) / m)


def _columns(home, n1, n2, inverse, twiddle=None):
    """A column pass: the n2-point DFT down each column j1 < n1, output k2
    times twiddle(j1, k2) (the hook's seq * k)."""
    f = np.fft.ifft if inverse else np.fft.fft
    out = home.copy()
    out[:, :, :n1] = f(home[:, :, :n1], axis=1) * (n2 if inverse else 1)
    if twiddle is not None:
        out[:, :, :n1] *= twiddle(np.arange(n1)[None, None, :],
                                  np.arange(n2)[None, :, None])
    return out


def _rows(home, n1, inverse, hook=None):
    """A row pass: the n1-point DFT along each row k2, output k1 through
    hook(v, line, seq = k2, k = k1)."""
    f = np.fft.ifft if inverse else np.fft.fft
    out = home.copy()
    out[:, :, :n1] = f(home[:, :, :n1], axis=2) * (n1 if inverse else 1)
    if hook is not None:
        lines, n2 = home.shape[:2]
        out[:, :, :n1] = hook(out[:, :, :n1],
                              np.arange(lines)[:, None, None],
                              np.arange(n2)[None, :, None],
                              np.arange(n1)[None, None, :])
    return out


def _conv_replay(x, spec, m, mm, rows, chirp, conj, xpow, scale):
    """fft_conv's block on lines x (B, n), block by block: the read to (j
    / n1) * P + j % n1, the chirp sweep, the forward passes (the twiddle
    w_m^(j1 k2) on the columns' last stage), the multiply sweep over bin K
    = k1 * n2 + k2 at [k2][k1] (line q times row (line0 + q) % rows, or
    the matrix mix of an item's mm lines), the inverse passes (conj
    w_m^(k2 j1) * scale on the rows), the store of the first n points
    (times the chirp)."""
    B, n = x.shape
    n1, n2 = ck.conv_split(m, mm)
    P = n1 | 1
    per = ck.conv_layout(m, mm)[1]
    y = np.zeros_like(x)
    K = np.arange(m)
    at = (K % n2, K // n2)
    for line0 in range(0, B, per):
        nl = min(per, B - line0)
        home = np.zeros((nl, n2, P), complex)
        for j in range(n):
            home[:, j // n1, j % n1] = x[line0:line0 + nl, j]
        if chirp is not None:
            for j in range(m):
                home[:, j // n1, j % n1] = (home[:, j // n1, j % n1]
                                            * chirp[j] if j < n else 0)
        home = _columns(home, n1, n2, False, lambda j1, k2: _w(m, j1 * k2))
        home = _rows(home, n1, False)
        for it in range(nl // mm):
            xs = [home[it * mm + i][at] for i in range(mm)]
            xs = [np.conj(v) for v in xs] if conj else xs
            for o in range(mm):
                if mm == 1:
                    v = xs[0] * spec[((line0 + it) % rows) * m + K]
                else:
                    v = sum(xs[i] * spec[(o * mm + i) * m + K]
                            for i in range(mm))
                if xpow:
                    v = v / np.sqrt(np.abs(v) ** 2 + 1e-30)
                home[it * mm + o][at] = v
        home = _rows(home, n1, True,
                     lambda v, line, seq, k: v * _w(m, seq * k, True) * scale)
        home = _columns(home, n1, n2, True)
        for j in range(n):
            v = home[:, j // n1, j % n1]
            y[line0:line0 + nl, j] = v * chirp[j] if chirp is not None else v
    return y


def _numpy_conv(x, spec, m, mm, rows, conj, xpow, scale):
    """The function itself: ifft(fft(x) (conj) times the table, mixed or by
    row, cross-power) times m * scale."""
    X = np.fft.fft(x.reshape(-1, mm, m), axis=-1)
    X = np.conj(X) if conj else X
    if mm > 1:
        Y = np.einsum("oin,bin->bon", spec.reshape(mm, mm, m), X)
    else:
        K = spec.reshape(rows, m)
        Y = X[:, 0] * K[np.arange(X.shape[0]) % rows]
        Y = Y[:, None]
    if xpow:
        Y = Y / np.sqrt(np.abs(Y) ** 2 + 1e-30)
    return (np.fft.ifft(Y, axis=-1) * m * scale).reshape(x.shape)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("m,mm,rows,B", [
    (5002, 1, 1, 2), (96, 1, 1, 50), (512, 1, 7, 19), (64, 1, 3, 70),
    (1024, 3, 1, 4), (96, 2, 1, 90), (61, 1, 5, 73), (4096, 1, 2, 3)])
@pytest.mark.parametrize("conj,xpow", [(False, False), (True, True)])
def test_conv_index_maps_replayed(m, mm, rows, B, conj, xpow):
    """The kernel's maps, replayed block by block on the layout the wrapper
    passes (blocks of one pass and of two factors, partial last blocks,
    rows that wrap within a block), give the convolution."""
    x = _rand((B * mm, m), m + mm)
    spec = _rand(rows * m if mm == 1 else mm * mm * m, m + 1)
    got = _conv_replay(x, spec, m, mm, rows, None, conj, xpow, 1.0 / m)
    want = _numpy_conv(x, spec, m, mm, rows, conj, xpow, 1.0 / m)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n", [263, 467, 4007])
@pytest.mark.parametrize("inverse", [False, True])
def test_conv_bluestein_maps_replayed(n, inverse):
    """The Bluestein mode's maps (the read of n points into the m-point
    matrix, the chirp sweep zeroing [n, m), the store of the first n
    times the chirp) on the package's chirp and spectrum give the DFT."""
    m = plan_axis(n).decomp.bluestein_size
    assert m is not None and ck.kernel_supports(m)
    chirp, spec = luts.bluestein_chirp(n, m, inverse)
    x = _rand((3, n), n)
    got = _conv_replay(x, spec / m, m, 1, 1, chirp, False, False, 1.0)
    want = np.fft.ifft(x) * n if inverse else np.fft.fft(x)
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.parametrize("n,B", [(7918, 2), (134, 33), (2, 5), (4096, 3)])
def test_conv_inv_index_maps_replayed(n, B):
    """fft_conv_inv's maps: the swapped spectrum read to row k2, column k1
    (position t = k2 n1 + k1), times table[t], the mirrored passes, the
    natural order stored plus the line's constant, give the plain
    version's function."""
    n1, n2 = ck.twofactor_split(n)
    P = n1 | 1
    x = _rand((B, n), n)
    tab = _rand(n, n + 1)
    dc = _rand(B, n + 2)
    home = np.zeros((B, n2, P), complex)
    for t in range(n):
        home[:, t // n1, t % n1] = x[:, t] * tab[t]
    home = _rows(home, n1, True,
                 lambda v, line, seq, k: v * _w(n, seq * k, True) * 0.5)
    home = _columns(home, n1, n2, True)
    got = np.stack([home[:, j // n1, j % n1] for j in range(n)], 1)
    got = got + dc[:, None]
    natural = (x * tab).reshape(B, n2, n1).transpose(0, 2, 1).reshape(B, n)
    want = np.fft.ifft(natural) * n * 0.5 + dc[:, None]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The generic stage, replayed thread by thread.
# ---------------------------------------------------------------------------

def _generic_stage(buf, seqs, S, qs, es, per, R, L, Mp, tw, w, T, dtype):
    """stage_generic of csrc/inplace.cuh over `seqs` sequences (sequence q
    at (q // per) S + (q % per) qs, points es apart) of a buffer, with T
    threads: each round of Q whole sequences, each thread's ITEMS items o
    = tid + k T (clamped to the last), item o the group o // nb of
    butterfly o % nb (sequence fastest, then m, then l), its PAIRS pairs i
    = group * PAIRS + u clamped to H, the sums of s_j and d_j over j <= H
    in order with the roots at (i j) mod R, the outputs times the stage's
    twiddle, and only the stores of real slots made, after every read of
    the round.  Returns the buffer and how often each point was written."""
    H = R // 2
    groups = (H + PAIRS) // PAIRS
    per_seq = L * Mp
    Q = min(seqs, ITEMS * T // (per_seq * groups))
    assert Q >= 1
    out = buf.copy()
    writes = np.zeros(len(buf), int)
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    wr, wi = w.real.astype(dtype), w.imag.astype(dtype)
    for q0 in range(0, seqs, Q):
        nq = min(Q, seqs - q0)
        nb = nq * per_seq
        total = nb * groups
        o = np.arange(ITEMS * T)
        oc = np.minimum(o, total - 1)
        grp, b = oc // nb, oc % nb
        t, q = b // nq, b % nq
        l, m = t // Mp, t % Mp
        hi, lo = (q0 + q) // per, (q0 + q) % per
        base = hi * S + lo * qs
        src = base + (l * R * Mp + m) * es
        x = out[src[:, None] + np.arange(R)[None, :] * Mp * es].astype(ctype)
        i = np.minimum(grp[:, None] * PAIRS + np.arange(PAIRS)[None, :], H)
        A = np.repeat(x[:, :1], PAIRS, 1)
        Bs = np.zeros_like(A)
        e = np.zeros_like(i)
        for j in range(1, H + 1):
            sj = (x[:, j] + x[:, R - j])[:, None]
            dj = (x[:, j] - x[:, R - j])[:, None]
            e = e + i
            e = np.where(e >= R, e - R, e)
            A = A + sj * wr[e]
            Bs = Bs + dj * wi[e]
        Xi = A + 1j * Bs.astype(ctype)
        Xr = A - 1j * Bs.astype(ctype)
        ri = np.where(i > 0, R - i, 0)
        Xi = Xi * tw[i * Mp + m[:, None]].astype(ctype)
        Xr = Xr * tw[ri * Mp + m[:, None]].astype(ctype)
        dst = (base + (l * Mp + m) * es)[:, None]
        istep = L * Mp * es
        real = ((o < total)[:, None]
                & (grp[:, None] * PAIRS + np.arange(PAIRS)[None, :] <= H))
        for pos, v, ok in ((dst + i * istep, Xi, real),
                           (dst + ri * istep, Xr, real & (i > 0))):
            out[pos[ok]] = v[ok]
            np.add.at(writes, pos[ok], 1)
    return out, writes


def _stage_tables(R, Mp, inverse):
    M = R * Mp
    sign = 2j if inverse else -2j
    tw = np.exp(sign * np.pi / M * (np.outer(np.arange(R), np.arange(Mp))
                                    % M)).ravel()
    return tw, np.exp(sign * np.pi / R * np.arange(R))


def _stage_numpy(seq, R, L, Mp, tw, inverse):
    """The Stockham stage on one sequence: A'[(i L + l) Mp + m] = w_M^(i m)
    sum_j w_R^(i j) A[(l R + j) Mp + m]."""
    a = seq.reshape(L, R, Mp)
    X = np.fft.ifft(a, axis=1) * R if inverse else np.fft.fft(a, axis=1)
    X = X * tw.reshape(R, 1, Mp).transpose(1, 0, 2)
    return X.transpose(1, 0, 2).reshape(-1)


# (L, Mp, lines, per, layout, threads): a lone sequence in one round with
# idle slots, several a round with a partial last round, the fewest
# threads the round rule allows, row-like (qs = P, es = 1) and
# column-like (qs = 1, es = P) sequences
GEOMETRIES = [(1, 1, 3, 1, "rows", None), (1, 3, 2, 2, "cols", None),
              (2, 1, 5, 1, "rows", "fewest"), (4, 2, 2, 3, "cols", None),
              (1, 8, 1, 1, "rows", "fewest"), (3, 1, 7, 2, "rows", 64)]


@pytest.mark.parametrize("R", PRIMES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_generic_stage_replayed(R, dtype):
    """Every prime 11..127 over each geometry and direction: the rounds
    write every point of their sequences exactly once and nothing else,
    and the outputs are the Stockham stage's, against numpy.fft within
    1e-12 (fp64 replay) or 1e-6 (fp32) of the largest."""
    for L, Mp, lines, per, kind, threads in GEOMETRIES:
        n = L * R * Mp
        seqs = lines * per
        if kind == "rows":
            P = n | 1
            S, qs, es, size = per * P, P, 1, lines * per * P
        else:
            P = per | 1
            S, qs, es, size = n * P, 1, P, lines * n * P
        items = L * Mp * ((R // 2 + PAIRS) // PAIRS)
        T = (-(-items // ITEMS) if threads == "fewest"
             else threads or 32 * -(-items // 32) + 32)
        assert ITEMS * T >= items
        for inverse in (False, True):
            tw, w = _stage_tables(R, Mp, inverse)
            rng = np.random.default_rng(R * 7 + L)
            buf = rng.standard_normal(size) + 1j * rng.standard_normal(size)
            got, writes = _generic_stage(buf, seqs, S, qs, es, per, R, L, Mp,
                                         tw, w, T, dtype)
            touched = np.zeros(size, bool)
            for q in range(seqs):
                at = (q // per) * S + (q % per) * qs + np.arange(n) * es
                touched[at] = True
                want = _stage_numpy(buf[at], R, L, Mp, tw, inverse)
                tol = 1e-12 if dtype == np.float64 else 1e-6
                assert (np.abs(got[at] - want).max()
                        <= tol * np.abs(want).max()), (R, L, Mp, q, inverse)
            assert (writes[touched] == 1).all(), (R, L, Mp)
            assert (writes[~touched] == 0).all()
            np.testing.assert_array_equal(got[~touched], buf[~touched])


@pytest.mark.parametrize("R", PRIMES)
def test_generic_round_rule(R):
    """A generic radix-R butterfly is `generic_groups`(R) items of 4 of its
    (R + 1) / 2 output pairs, and a lone R-point sequence fits a round of
    T threads exactly when T holds them at 2 items a thread (the C
    entries' rounds_fit; a layout of fewer threads is refused)."""
    groups = ck.generic_groups(R)
    assert groups == -(-(R // 2 + 1) // PAIRS)
    assert (groups - 1) * PAIRS < (R + 1) // 2 <= groups * PAIRS
    for T in range(1, groups + 2):
        assert ck.walk_rounds_fit(R, T) == (ITEMS * T >= groups), (R, T)
        assert _rounds_fit(R, T) == (ITEMS * T >= groups)
