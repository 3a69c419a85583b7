"""The layout rules, tables and launch arguments of `fft_dct23`,
`fft_dct1` and `fft_dct4` on the in-place walk (csrc/fft_dct23.cu,
csrc/fft_dct1.cu, csrc/fft_dct4.cu, csrc/dct_walk.cuh): every served
length gets a layout the C entries
accept, the rotation tables hold their formulas, each wrapper passes its
rule's plans and layout, and the kernels' read, build and write index maps,
replayed in numpy on the tables and layouts the wrappers pass, give scipy's
transforms.  The kernels themselves run only on the card (chip_smoke.py)."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import scipy.fft as sfft
import torch

from vkfft_tpu_torch.ops import cuda_kernels as ck

DCT23_LENGTHS = [n for n in range(4, ck.KERNEL_MAX_N + 1)
                 if ck.dct23_supports(n)]
DCT4_LENGTHS = [n for n in range(4, 2 * ck.KERNEL_MAX_N + 1)
                if ck.dct4_supports(n)]
DCT1_CASES = [(n, dst) for dst in (False, True)
              for n in range(3, ck.KERNEL_MAX_N + 2) if ck.dct1_supports(n, dst)]
FIXED = (2, 3, 4, 5, 7, 8, 16)
ONE_PASS_23 = 344    # lengths whose DCT-II/III pipeline runs as one pass


def _rounds_fit(n, threads):
    """csrc/inplace.cuh rounds_fit on the walk's radices of an n-point
    factor, restated: a thread holds max(1, 12 // r) butterflies of a fixed
    radix r, 2 items of a generic radix r, each 4 of a butterfly's
    (r + 1) / 2 output pairs."""
    if n == 1:
        return True
    return all((max(1, 12 // r) * threads >= n // r) if r in FIXED
               else 2 * threads >= n // r * -(-(r // 2 + 1) // 4)
               for r in ck.walk_radices(n))


def _table_points(n):
    return 0 if n == 1 else len(ck.stage_tables(n, False, 1.0, True)[1])


def _rotation_points(count):
    return 64 + -(-count // 64)


def _check_rule(n, points, layout, twiddle_points, type4):
    """The layout rule: `fft_dct4` on `fft_r2c`'s block (2048 points, 16 a
    thread, one pass from 4 pipelines), `fft_dct23` on its own (4096, 32,
    from 8)."""
    block, aim, one_pass = (2048, 16, 4) if type4 else (4096, 32, 8)
    threads, lines, smem = layout
    n1, n2 = ck.dct_split(points, type4)
    assert n1 * n2 == points and n1 >= n2, n
    assert lines == max(1, block // points), n
    want = min(512, max(32, -(-(-(-lines * points // aim)) // 32) * 32))
    assert threads == want and threads % 32 == 0, n
    assert lines * points <= 16384, n
    for f in (n1, n2):
        assert f == 1 or ck.walk_radices(f) is not None, n
    assert _rounds_fit(n1, threads) and _rounds_fit(n2, threads), n
    one = lines >= one_pass and _rounds_fit(points, threads)
    assert (n1, n2) == ((points, 1) if one else ck._lines_factors(points)), n
    tables = _table_points(n1) + _table_points(n2)
    assert smem == 8 * (lines * n2 * (n1 | 1) + tables + twiddle_points), n
    assert smem <= ck.MAX_SMEM_BYTES, n
    return n2 == 1


def test_dct23_layout_rule_every_length():
    """Every length `fft_dct23` serves (n <= 8192) gets the layout its C
    entry accepts: pipelines of n points up to 4096 a block, a multiple of
    32 threads in 32..512 near one for 32 points, one pass where a block
    holds 8 pipelines or more and the stages fit, else `fft_lines`' two
    factors, each factor's stages within a round, and exactly the shared
    bytes of the pipelines, the stage tables and the twiddles (the
    inter-factor twiddle and the rotations: 2 (64 + ceil(n / 64)))."""
    assert len(DCT23_LENGTHS) == 2539
    one = 0
    for n in DCT23_LENGTHS:
        tw = ck.dct_twiddle_points(n, False)
        assert tw == 2 * _rotation_points(n)
        one += _check_rule(n, n, ck.dct23_layout(n), tw, False)
    assert one == ONE_PASS_23


def test_dct4_layout_rule_every_length():
    """The same for `fft_dct4` (n <= 16384, the gate unchanged) on the
    points of its pipeline, n/2 (even n, a line each) or n (odd n, two
    lines each), with its twiddles: the inter-factor twiddle, then the pre-
    and post-rotations (even n) or the one output factor (odd n)."""
    assert len(DCT4_LENGTHS) == 3153
    one = 0
    for n in DCT4_LENGTHS:
        points = ck.dct4_points(n)
        assert points == (n // 2 if n % 2 == 0 else n)
        tw = ck.dct_twiddle_points(n, True)
        assert tw == _rotation_points(points) + (
            _rotation_points(n // 2) + _rotation_points(n // 2 + 1)
            if n % 2 == 0 else 1)
        one += _check_rule(n, points, ck.dct4_layout(n), tw, True)
    assert one == 489


def test_dct1_layout_rule_every_length():
    """Every DCT-I / DST-I length `fft_dct1` serves gets the layout its C
    entry accepts: `fft_r2c`'s block on the M = n -+ 1 complex points of a
    line's extension (2048 points, 16 a thread, one pass from 4 lines),
    with its twiddles: the M-point inter-factor twiddle, then the
    untangle's w_2M^k, k <= M/2 (64 + M/128 + 1)."""
    assert len(DCT1_CASES) == 5080
    one = 0
    for n, dst in DCT1_CASES:
        M = ck.dct1_length(n, dst)
        tw = len(ck.dct1_twiddle(n, dst))
        assert tw == _rotation_points(M) + 64 + (M // 2) // 64 + 1
        one += _check_rule(n, M, ck.dct1_layout(n, dst), tw, True)
    assert one == 690


@pytest.mark.parametrize("n,dst,split,layout", [
    (1025, False, (64, 16), (128, 2, 18696)),
    (1023, True, (64, 16), (128, 2, 18696)),
    (256, False, (255, 1), (128, 8, 19776)),     # 3 * 5 * 17: generic stage
    (3, False, (2, 1), (128, 1024, 25632)),
    (3, True, (4, 1), (128, 512, 21552)),
    (8193, False, (128, 64), (512, 1, 70408))])
def test_dct1_layout_of_named_lengths(n, dst, split, layout):
    """The main path's DCT-I 1025 and DST-I 1023 (M = 1024: two lines of
    two factors a block), a generic stage, the shortest lines and the
    longest."""
    assert ck.dct_split(ck.dct1_length(n, dst), True) == split
    assert ck.dct1_layout(n, dst) == layout


@pytest.mark.parametrize("type4,n,split,layout", [
    (False, 32, (32, 1), (128, 128, 35120)),     # sample 101's 32^3 axes
    (False, 96, (96, 1), (128, 42, 34560)),      # sample 101's 96^2 axes
    (False, 255, (255, 1), (128, 16, 36112)),    # 3 * 5 * 17: generic stage
    (False, 256, (256, 1), (128, 16, 36416)),    # sample 100
    (False, 1024, (64, 16), (128, 4, 35392)),
    (False, 8192, (128, 64), (256, 1, 70912)),
    (True, 32, (16, 1), (128, 128, 19224)),
    (True, 96, (48, 1), (128, 42, 18584)),
    (True, 255, (255, 1), (128, 8, 19256)),      # odd: n, two lines each
    (True, 256, (128, 1), (128, 16, 19320)),
    (True, 1024, (512, 1), (128, 4, 22824)),
    (True, 4095, (65, 63), (256, 1, 35200)),     # odd: two factors
    (True, 8192, (256, 16), (256, 1, 38664)),
    (True, 16384, (128, 64), (512, 1, 72456)),
])
def test_dct_layout_of_named_lengths(type4, n, split, layout):
    """The main path's lengths (sample 100's 256 / 1024 / 255, sample 101's
    96 and 32) and the longest lines get the layouts recorded in PERF.md."""
    points = ck.dct4_points(n) if type4 else n
    assert ck.dct_split(points, type4) == split
    assert (ck.dct4_layout if type4 else ck.dct23_layout)(n) == layout


def _root(tab, e):
    """root() of csrc/real_walk.cuh: hi[e >> 6] * lo[e & 63]."""
    e = np.asarray(e)
    return tab[64 + (e >> 6)] * tab[e & 63]


@pytest.mark.parametrize("n", [4, 5, 96, 255, 1024, 8192])
@pytest.mark.parametrize("type3", [False, True])
def test_dct23_twiddle_tables(n, type3):
    """`dct23_twiddle`: the n-point inter-factor twiddle's two tables
    (inverse for type III, no scale), then the rotations: rot[k] = scale
    e^{-+i pi k / 2n} for every k < n."""
    scale = 0.37
    tw = ck.dct23_twiddle(n, type3, scale)
    pair = ck.twofactor_twiddle_pair(n, type3)
    np.testing.assert_array_equal(tw[:len(pair)], pair)
    assert len(tw) == ck.dct_twiddle_points(n, False)
    k = np.arange(n)
    want = scale * np.exp((1 if type3 else -1) * 0.5j * np.pi * k / n)
    assert np.abs(_root(tw[len(pair):], k) - want).max() < 1e-14


@pytest.mark.parametrize("n", [4, 5, 96, 255, 256, 4095, 16384])
def test_dct4_twiddle_tables(n):
    """`dct4_twiddle`: the pipeline's inter-factor twiddle, then for even n
    pre[j] = e^{-i pi (4j+1)/4n} (j < n/2) and post[k] = 2 scale e^{-i pi
    k/n} (k <= n/2); for odd n the one point sqrt(2) scale / 2."""
    scale = 0.37
    tw = ck.dct4_twiddle(n, scale)
    pair = ck.twofactor_twiddle_pair(ck.dct4_points(n), False)
    np.testing.assert_array_equal(tw[:len(pair)], pair)
    assert len(tw) == ck.dct_twiddle_points(n, True)
    rest = tw[len(pair):]
    if n % 2:
        np.testing.assert_allclose(rest, [np.sqrt(2.0) * scale / 2])
        return
    pre_n, post_n = n // 2, n // 2 + 1
    pre = np.exp(-1j * np.pi * (4 * np.arange(pre_n) + 1) / (4 * n))
    post = 2 * scale * np.exp(-1j * np.pi * np.arange(post_n) / n)
    got_pre = _root(rest, np.arange(pre_n))
    got_post = _root(rest[_rotation_points(pre_n):], np.arange(post_n))
    assert np.abs(got_pre - pre).max() < 1e-14
    assert np.abs(got_post - post).max() < 1e-14


class _Recorder:
    """The C library stub: each DCT entry's arguments, the plans read back
    from their ctypes arrays while the call lasts."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            lead = 5 if name == "vk_fft_dct4" else 4
            plans = [list((ctypes.c_int * 51).from_address(a))
                     for a in args[lead:lead + 2]]
            self.calls.append({"entry": name, "batch": args[2],
                               "lead": args[3:lead], "plans": plans,
                               "layout": tuple(args[lead + 5:lead + 8])})
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


@pytest.mark.parametrize("n", [32, 96, 255, 1024, 8192])
def test_dct23_launch_arguments(monkeypatch, n):
    """`fft_dct2` and `fft_dct3` launch once each with the batch, the flag,
    the unscaled walk plans of `dct_split`'s factors (inverse for type III)
    and `dct23_layout`; the scale rides the rotation table."""
    x = torch.empty(3, n, device="meta")
    with _recorded(monkeypatch) as lib:
        for type3, dst in ((False, False), (True, True)):
            y = (ck.fft_dct3 if type3 else ck.fft_dct2)(x, dst, 0.5)
            assert y.shape == x.shape
        assert ck.launches == {k: 2 if k == "fft_dct23" else 0
                               for k in ck.KERNEL_SOURCES}
    n1, n2 = ck.dct_split(n)
    for call, (entry, inverse, dst) in zip(
            lib.calls, [("vk_fft_dct2", False, 0), ("vk_fft_dct3", True, 1)],
            strict=True):
        assert (call["entry"], call["batch"], call["lead"]) == (entry, 3,
                                                                (dst,))
        assert call["layout"] == ck.dct23_layout(n)
        for ints, f in zip(call["plans"], (n1, n2)):
            assert ints == list(ck.stage_tables(f, inverse, 1.0, True)[0])
    tab = ck._DEVICE_TABLES[("dct23_twiddle", n, True, 0.5, "meta")]
    assert tuple(tab.shape) == (ck.dct_twiddle_points(n, False), 2)


@pytest.mark.parametrize("n,dst", [(3, False), (1025, False), (1023, True),
                                   (8193, False), (4, True)])
def test_dct1_twiddle_tables(n, dst):
    """`dct1_twiddle`: the M-point inter-factor twiddle's two tables with
    the scale, then the untangle's w_2M^k for every k <= M/2."""
    scale = 0.37
    M = ck.dct1_length(n, dst)
    tw = ck.dct1_twiddle(n, dst, scale)
    pair = ck.twofactor_twiddle_pair(M, False, scale)
    np.testing.assert_array_equal(tw[:len(pair)], pair)
    k = np.arange(M // 2 + 1)
    got = _root(tw[len(pair):], k)
    assert np.abs(got - np.exp(-1j * np.pi * k / M)).max() < 1e-14


@pytest.mark.parametrize("n,dst", [(3, False), (1025, False), (1023, True),
                                   (8193, False)])
def test_dct1_launch_arguments(monkeypatch, n, dst):
    """`fft_dct1` launches once with the batch, the flag, the forward
    walk plans of `dct_split`'s factors of M = n -+ 1 (no scale) and
    `dct1_layout`; the scale rides the twiddle table."""
    x = torch.empty(2, n, device="meta")
    with _recorded(monkeypatch) as lib:
        assert ck.fft_dct1(x, dst, 0.5).shape == x.shape
        assert ck.launches == {k: 1 if k == "fft_dct1" else 0
                               for k in ck.KERNEL_SOURCES}
    (call,) = lib.calls
    assert (call["entry"], call["batch"], call["lead"]) == (
        "vk_fft_dct1", 2, (int(dst),))
    assert call["layout"] == ck.dct1_layout(n, dst)
    n1, n2 = ck.dct_split(ck.dct1_length(n, dst), True)
    for ints, f in zip(call["plans"], (n1, n2)):
        assert ints == list(ck.stage_tables(f, False, 1.0, True)[0])
    tab = ck._DEVICE_TABLES[("dct1_twiddle", n, dst, 0.5, "meta")]
    assert tuple(tab.shape) == (len(ck.dct1_twiddle(n, dst)), 2)


@pytest.mark.parametrize("n", [32, 255, 256, 4095, 16384])
def test_dct4_launch_arguments(monkeypatch, n):
    """`fft_dct4` launches once with the batch, n, the flag, the forward
    walk plans of `dct_split`'s factors of its pipeline and
    `dct4_layout`."""
    x = torch.empty(2, n, device="meta")
    with _recorded(monkeypatch) as lib:
        assert ck.fft_dct4(x, True, 0.5).shape == x.shape
        assert ck.launches == {k: 1 if k == "fft_dct4" else 0
                               for k in ck.KERNEL_SOURCES}
    (call,) = lib.calls
    assert (call["entry"], call["batch"], call["lead"]) == ("vk_fft_dct4", 2,
                                                            (n, 1))
    assert call["layout"] == ck.dct4_layout(n)
    n1, n2 = ck.dct_split(ck.dct4_points(n), True)
    for ints, f in zip(call["plans"], (n1, n2)):
        assert ints == list(ck.stage_tables(f, False, 1.0, True)[0])


# ---------------------------------------------------------------------------
# The kernels' index maps replayed in numpy.
# ---------------------------------------------------------------------------

class _Home:
    """A block's pipelines in shared memory: point t = a * d + b of
    pipeline q at q * S + a * A + b * B (csrc/inplace.cuh Map: row-major
    (n2, n1) at pitch n1 | 1 in, transposed out)."""

    def __init__(self, lines, n1, n2):
        self.n, self.n1, self.n2, self.P = n1 * n2, n1, n2, n1 | 1
        self.S = n2 * self.P
        self.h = np.full(lines * self.S, np.nan, complex)

    def pos(self, u, out):
        q, t = divmod(u, self.n)
        if out:
            a, b = divmod(t, self.n2)
            return q * self.S + a + b * self.P
        a, b = divmod(t, self.n1)
        return q * self.S + a * self.P + b

    def dft(self, nl, inverse, first=0):
        """The passes: natural order in, the spectrum's natural order out;
        with ``first`` = 1 the one pass's Stockham stages after the first
        (csrc/stockham.cuh's recurrence) on the points the caller built."""
        for q in range(nl):
            z = np.array([self.h[self.pos(q * self.n + j, False)]
                          for j in range(self.n)])
            assert not np.isnan(z).any()
            if first:
                L, M = 1, self.n
                for s, r in enumerate(ck.walk_radices(self.n)):
                    Mp = M // r
                    if s >= first:
                        i, l, m = np.ix_(np.arange(r), np.arange(L),
                                         np.arange(Mp))
                        a = z.reshape(L, r, Mp)   # [l, j, m]
                        w = np.exp(-2j * np.pi * np.outer(np.arange(r),
                                                          np.arange(r)) / r)
                        y = np.einsum("ij,ljm->ilm", w, a)
                        y *= np.exp(-2j * np.pi * i * m / M)
                        z = y.reshape(-1)
                    L, M = L * r, Mp
                Z = z
            else:
                Z = np.fft.ifft(z) * self.n if inverse else np.fft.fft(z)
            for k in range(self.n):
                self.h[self.pos(q * self.n + k, True)] = Z[k]


def _set(home, at, part, v):
    c = home.h[at]
    c = 0j if np.isnan(c) else c
    home.h[at] = complex(v, c.imag) if part == 0 else complex(c.real, v)


def _replay_dct23(x, type3, dst, scale):
    B, n = x.shape
    n1, n2 = ck.dct_split(n)
    lines = ck.dct23_layout(n)[1]
    rot = ck.dct23_twiddle(n, type3, scale)[_rotation_points(n):]
    y = np.zeros_like(x)
    for b0 in range(0, B, 2 * lines):
        nl = min(2 * lines, B - b0)
        np_ = (nl + 1) // 2
        h = _Home(lines, n1, n2)
        x0 = x[b0:].ravel()
        # load_quads: one thread the floats (2s, 2s + 1) of both lines
        for t in range(np_ * ((n + 1) // 2)):
            q, s = divmod(t, (n + 1) // 2)
            if type3:
                e0, e1 = ((n - 1 - 2 * s, n - 2 - 2 * s) if dst
                          else (2 * s, 2 * s + 1))
            else:
                e0, e1 = s, n - 1 - s
            for line in (2 * q, 2 * q + 1):
                for e, i in ((e0, 2 * s), (e1, 2 * s + 1)):
                    if i >= n:
                        continue
                    v = 0.0 if line >= nl else x0[line * n + i]
                    if dst and not type3 and i & 1:
                        v = -v
                    _set(h, h.pos(q * n + e, False), line & 1, v)
        if type3:
            for t in range(np_ * (n // 2 + 1)):
                q, k = divmod(t, n // 2 + 1)
                kb = n - k if k else 0
                at, bt = h.pos(q * n + k, False), h.pos(q * n + kb, False)
                a, b = h.h[at], (h.h[bt] if k else 0j)
                ua = _root(rot, k) * complex(a.real + b.imag, a.imag - b.real)
                r = _root(rot, k)      # rot3[n-k] = i conj(rot3[k])
                ub = complex(r.imag, r.real) * complex(b.real + a.imag,
                                                       b.imag - a.real)
                h.h[at] = ua
                if k:
                    h.h[bt] = ub
        h.dft(np_, type3)
        for t in range(np_ * (n // 2 + 1)):
            q, k = divmod(t, n // 2 + 1)
            ya, yb = y[b0 + 2 * q], (y[b0 + 2 * q + 1]
                                     if 2 * q + 1 < nl else None)
            if type3:
                # csrc/fft_dct23.cu write_dct3: outputs 2k and 2k + 1
                v = h.h[h.pos(q * n + k, True)]
                w = h.h[h.pos(q * n + n - 1 - k, True)]
                s = -1.0 if dst else 1.0
                for o, val, sg in ((2 * k, v, 1.0), (2 * k + 1, w, s)):
                    if o < n:
                        ya[o] = sg * val.real
                        if yb is not None:
                            yb[o] = sg * val.imag
                continue
            # write_dct2: the bins k and n - k once for four outputs
            kb = n - k if k else 0
            a = h.h[h.pos(q * n + k, True)]
            b = h.h[h.pos(q * n + kb, True)]
            ok, ob = (n - 1 - k, n - 1 - kb) if dst else (k, kb)
            pair = k != 0 and 2 * k != n
            rk = _root(rot, k)
            rb = complex(-rk.imag, -rk.real)    # rot[n-k] = -i conj(rot[k])
            ya[ok] = (rk * complex(a.real + b.real, a.imag - b.imag)).real
            if pair:
                ya[ob] = (rb * complex(b.real + a.real, b.imag - a.imag)).real
            if yb is not None:
                yb[ok] = (rk * complex(a.imag + b.imag, b.real - a.real)).real
                if pair:
                    yb[ob] = (rb * complex(b.imag + a.imag,
                                           a.real - b.real)).real
    return y


def _re11_point(j, n):
    """csrc/fft_dct4.cu re11_point: (point, negated) of float j of an odd
    line."""
    n2 = n >> 1
    d = j - n2
    if d % 2 == 0:
        neg = d % 4 != 0
        return ((j + 2 * n - n2) >> 2 if neg else (d % (4 * n)) >> 2), neg
    e = 2 * n - 1 - j - n2
    neg = e % 4 == 0
    return (e >> 2 if neg else (4 * n - 1 - j - n2) >> 2), neg


def _re11_outputs(k, n, c, s):
    """csrc/fft_dct4.cu re11_outputs: ((p0, v0), (p1, v1)) of bin k."""
    def par(v, e):
        return -v if e & 1 else v
    n2 = n >> 1
    if k == 0:
        v = par(c, (n2 + 1) >> 1)
        return (n2, v), (n2, v)
    if k & 1:
        i = k >> 1
        return ((i, par(c, (i + 1) >> 1) + par(s, i >> 1)),
                (n - 1 - i, par(c, (n - i) >> 1) - par(s, (n - 1 - i) >> 1)))
    i = (k >> 1) - 1
    return ((n2 - 1 - i, par(c, (n2 - i) >> 1) - par(s, (n2 - 1 - i) >> 1)),
            (n2 + 1 + i, par(c, (n2 + i + 2) >> 1) + par(s, (n2 + 1 + i) >> 1)))


def test_re11_permutation_is_one_to_one():
    """Every float of an odd line goes to its own point: re11_point is a
    bijection of 0..n-1 at every odd n the kernel serves."""
    for n in [n for n in DCT4_LENGTHS if n % 2]:
        assert sorted(_re11_point(j, n)[0] for j in range(n)) == list(range(n))


def _replay_dct4(x, dst, scale):
    B, n = x.shape
    N = ck.dct4_points(n)
    n1, n2 = ck.dct_split(N, True)
    lines = ck.dct4_layout(n)[1]
    tw = ck.dct4_twiddle(n, scale)[_rotation_points(N):]
    y = np.zeros_like(x)
    if n % 2 == 0:
        m, pre, post = N, tw, tw[_rotation_points(N):]
        sg = -1.0 if dst else 1.0
        for b0 in range(0, B, lines):
            nl = min(lines, B - b0)
            h = _Home(lines, n1, n2)
            x0 = x[b0:].ravel()
            for u in range(nl * m):
                h.h[h.pos(u, False)] = complex(x0[2 * u], x0[2 * u + 1])
            c = _root(pre, m - 1) * _root(pre, 0)
            for t in range(nl * ((m + 1) // 2)):
                q, j = divmod(t, (m + 1) // 2)
                at = h.pos(q * m + j, False)
                bt = h.pos(q * m + m - 1 - j, False)
                a, b = h.h[at], h.h[bt]
                r = _root(pre, j)      # pre[m-1-j] = C conj(pre[j])
                wa = complex(a.real, sg * b.imag) * r
                wb = complex(b.real, sg * a.imag) * c * np.conj(r)
                h.h[at] = wa
                if at != bt:
                    h.h[bt] = wb
            h.dft(nl, False)
            for t in range(nl * ((m + 1) // 2)):
                q, j = divmod(t, (m + 1) // 2)
                jb = m - 1 - j
                a = h.h[h.pos(q * m + j, True)]
                b = h.h[h.pos(q * m + jb, True)]
                r, r1 = _root(post, j), _root(post, j + 1)
                # post[m-k] = -i conj(post[k])
                rots = {j: (r, r1), jb: (complex(-r1.imag, -r1.real),
                                         complex(-r.imag, -r.real))}
                for u, w, v in ((j, a, b), (jb, b, a)):
                    pair = ((rots[u][0] * w).real,
                            (np.conj(rots[u][1]) * v).real)
                    o = 2 * (m - 1 - u) if dst else 2 * u
                    y[b0 + q, o:o + 2] = pair[::-1] if dst else pair
        return y
    f = tw[0].real
    for b0 in range(0, B, 2 * lines):
        nl = min(2 * lines, B - b0)
        np_ = (nl + 1) // 2
        h = _Home(lines, n1, n2)
        x0 = x[b0:].ravel()
        for t in range(np_ * n):
            q, j = divmod(t, n)
            i, neg = _re11_point(j, n)
            neg = neg != bool(dst and j & 1)
            for line in (2 * q, 2 * q + 1):
                v = 0.0 if line >= nl else x0[line * n + j]
                _set(h, h.pos(q * n + i, False), line & 1, -v if neg else v)
        h.dft(np_, False)
        for t in range(np_ * (n // 2 + 1)):
            q, k = divmod(t, n // 2 + 1)
            a = h.h[h.pos(q * n + k, True)]
            b = h.h[h.pos(q * n + (n - k if k else 0), True)]
            for line, (c, s) in ((2 * q, (a.real + b.real, a.imag - b.imag)),
                                 (2 * q + 1, (a.imag + b.imag,
                                              b.real - a.real))):
                if line < nl:
                    for p, v in _re11_outputs(k, n, c, s):
                        y[b0 + line, n - 1 - p if dst else p] = f * v
    return y


def _replay_dct1(x, dst, scale):
    """csrc/fft_dct1.cu: load_extension's read (float x_i to extension
    point e = i + dst and its mirror 2M - e, DST-I's negated, DST-I's two
    zeros), the M-point DFT with the scale, write_dct1's pairs of bins."""
    B, n = x.shape
    M = ck.dct1_length(n, dst)
    n1, n2 = ck.dct_split(M, True)
    lines = ck.dct1_layout(n, dst)[1]
    ulo = ck.dct1_twiddle(n, dst, scale)[_rotation_points(M):]
    y = np.zeros_like(x)
    for b0 in range(0, B, lines):
        nl = min(lines, B - b0)
        h = _Home(lines, n1, n2)
        x0 = x[b0:].ravel()
        for t in range(nl * n):
            q, i = divmod(t, n)
            e = i + dst
            _set(h, h.pos(q * M + (e >> 1), False), e & 1, x0[t])
            if 0 < e < M:
                m = 2 * M - e
                _set(h, h.pos(q * M + (m >> 1), False), m & 1,
                     -x0[t] if dst else x0[t])
        if dst:
            for q in range(nl):
                _set(h, h.pos(q * M, False), 0, 0.0)
                _set(h, h.pos(q * M + (M >> 1), False), M & 1, 0.0)
        h.dft(nl, False)
        h.h *= scale
        for t in range(nl * (M // 2 + 1)):
            q, k = divmod(t, M // 2 + 1)
            a = h.h[h.pos(q * M + k, True)]
            b = h.h[h.pos(q * M + (M - k if k else 0), True)]
            yq = y[b0 + q]
            if k == 0:
                if not dst:
                    yq[0], yq[M] = a.real + a.imag, a.real - a.imag
                continue
            w = _root(ulo, k)
            E = complex(0.5 * (a.real + b.real), 0.5 * (a.imag - b.imag))
            wO = w * complex(0.5 * (a.imag + b.imag), 0.5 * (b.real - a.real))
            if dst:
                yq[k - 1] = -(E.imag + wO.imag)
                if 2 * k != M:
                    yq[M - k - 1] = E.imag - wO.imag
            else:
                yq[k] = E.real + wO.real
                if 2 * k != M:
                    yq[M - k] = E.real - wO.real
    return y


@pytest.mark.parametrize("n,dst", [
    (3, False), (4, False), (5, False), (9, False), (65, False), (256, False),
    (1025, False), (3001, False), (3, True), (4, True), (5, True), (9, True),
    (63, True), (1023, True), (4095, True)])
def test_dct1_index_maps_replayed_match_scipy(n, dst):
    """csrc/fft_dct1.cu's read, passes and write replayed in numpy on the
    twiddles (`dct1_twiddle`) and layout (`dct1_layout`) the wrapper
    passes, over up to three blocks and a line: even and odd M (a last
    pair of bins that is one bin), one pass and two factors (M = 1024,
    3000 as 75 x 40, 4096), the shortest lines."""
    scale = 0.37
    lines = ck.dct1_layout(n, dst)[1]
    B = min(3 * lines, 9) + 1
    x = np.random.default_rng(n + dst).standard_normal((B, n))
    got = _replay_dct1(x, dst, scale)
    want = scale * (sfft.dst if dst else sfft.dct)(x, type=1)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("type,n", [(2, 5), (2, 96), (3, 45), (3, 32),
                                    (2, 1024), (3, 1000), (2, 7), (3, 96),
                                    (4, 16), (4, 14),
                                    (4, 15), (4, 255), (4, 1023), (4, 2048)])
@pytest.mark.parametrize("dst", [False, True])
def test_index_maps_replayed_match_scipy(type, n, dst):
    """csrc/fft_dct23.cu's and csrc/fft_dct4.cu's read, build and write
    index maps, replayed in numpy on the tables (`dct23_twiddle`,
    `dct4_twiddle`) and layouts (`dct23_layout`, `dct4_layout`) the
    wrappers pass, over up to ten lines (three blocks where a block holds
    few): one pass and two factors (n = 1024 / 1000 for DCT-II / III, 1023
    and 2048 for DCT-IV), odd n / 2 (n = 14: a pair of points that is one
    point), the odd DCT-IV's permutation, an odd count of lines (the last
    pipeline of DCT-II/III and odd DCT-IV carries one)."""
    scale = 0.37
    lines = (ck.dct4_layout if type == 4 else ck.dct23_layout)(n)[1]
    per = lines if type == 4 and n % 2 == 0 else 2 * lines
    B = min(3 * per, 9) + 1
    x = np.random.default_rng(n + type).standard_normal((B, n))
    got = (_replay_dct4(x, dst, scale) if type == 4
           else _replay_dct23(x, type == 3, dst, scale))
    want = scale * (sfft.dst if dst else sfft.dct)(x, type=type)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
