"""The long tier on the port's CUDA engine, on the CPU: the factor mode of
`fft_strided` (its plain version, through the wrapper on CPU tensors)
against the JAX package's `_build_strided_call` in interpret mode, in the
`_strided_kernel` form and the v3 form, with every factor kind the long
tier uses (dim1/dim2, grid_mod, dim1_col/dim2_col, rows) and the in/out
keeps; `fft_long_p`/`fft_long3_p` against `fft_long_planar` /
`_fft_long3_planar` in interpret mode, natural and swapped order; each
long route's exact launches, counted by the wrappers on meta tensors with
the library call stubbed out and held to `cuda_engine.route`; the splits;
and long convolution, DCT and rfftn compositions against the jnp engine.
The CUDA kernels themselves run only on the card (chip_smoke.py)."""
import collections
import contextlib
import dataclasses
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft as sfft
import torch

import vkfft_tpu as vk
from vkfft_tpu import luts as jluts
from vkfft_tpu.ops import pallas_engine

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.planner.factorize import Algorithm
from vkfft_tpu_torch.planner.plan import plan_axis

NUMPY_TOL = 5e-6
REF_TOL = 1e-5


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    yield
    pallas_engine.set_interpret(False)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _sep(*args):
    return list(pallas_engine._sep_twiddle(*args))


def _full(t):
    return [np.real(t).astype(np.float32), np.imag(t).astype(np.float32)]


# ---------------------------------------------------------------------------
# The factor mode against `_build_strided_call` (interpret mode).
# ---------------------------------------------------------------------------

def _two(nc, ns, inverse):
    """The two-upload strided pass: (P, nc, ns), w_n^(kc*js) on the write
    (forward) or its conjugate on the read (inverse)."""
    n = nc * ns
    c1, c2 = pallas_engine.split_lane_major(nc)
    if inverse:
        kw = dict(fused="pre", factors=(("dim1", c2), ("dim2", c1)))
        tabs = _sep(c2, c1, ns, n, True) + _sep(c1, 1, ns, n, True)
        port = dict(pre=ck.twiddle(n, True))
    else:
        kw = dict(fused="post", factors=(("dim1", c1), ("dim2", c2)))
        tabs = _sep(c1, c2, ns, n, False) + _sep(c2, 1, ns, n, False)
        port = dict(post=ck.twiddle(n))
    return (2, nc, ns), nc, kw, tabs, port


def _grid_mod(na, nb, ns, inverse):
    """Three uploads, pass 2: (B*na, nb, ns), w_n^((kb*na + ka)*js) with ka
    the digit carried in P."""
    n = na * nb * ns
    b1, b2 = pallas_engine.split_lane_major(nb)
    if inverse:
        kw = dict(fused="pre", factors=(("dim1", b2), ("dim2", b1),
                                        ("grid_mod", na)))
        tabs = (_sep(b2, b1 * na, ns, n, True) + _sep(b1, na, ns, n, True)
                + _sep(na, 1, ns, n, True))
        port = dict(pre=ck.twiddle(n, True, a=na, pm=na, b=1))
    else:
        kw = dict(fused="post", factors=(("dim1", b1), ("dim2", b2),
                                         ("grid_mod", na)))
        tabs = (_sep(b1, b2 * na, ns, n, False) + _sep(b2, na, ns, n, False)
                + _sep(na, 1, ns, n, False))
        port = dict(post=ck.twiddle(n, a=na, pm=na, b=1))
    return (2 * na, nb, ns), nb, kw, tabs, port


def _col(na, nb, ns, inverse):
    """Three uploads, pass 1: (B, na, nb*ns), w_(na*nb)^(ka*jb), jb = s //
    ns."""
    nc = na * nb
    a1, a2 = pallas_engine.split_lane_major(na)
    if inverse:
        kw = dict(fused="pre", factors=(("dim1_col", a2, nb),
                                        ("dim2_col", a1, nb)))
        tabs = _sep(a2, a1, nb, nc, True) + _sep(a1, 1, nb, nc, True)
        port = dict(pre=ck.twiddle(nc, True, sd=ns))
    else:
        kw = dict(fused="post", factors=(("dim1_col", a1, nb),
                                         ("dim2_col", a2, nb)))
        tabs = _sep(a1, a2, nb, nc, False) + _sep(a2, 1, nb, nc, False)
        port = dict(post=ck.twiddle(nc, sd=ns))
    return (2, na, nb * ns), na, kw, tabs, port


# (id, case builder and its arguments); 166 = 83 * 2 is no v3 length, so
# the JAX package runs `_strided_kernel` (the two-factor form) for it
FACTOR_CASES = [
    ("two_v3_fwd", _two, (128, 64, False)),
    ("two_v3_inv", _two, (128, 64, True)),
    ("two_v1_fwd", _two, (166, 16, False)),
    ("two_v1_inv", _two, (166, 16, True)),
    ("grid_mod_v3_fwd", _grid_mod, (8, 32, 16, False)),
    ("grid_mod_v3_inv", _grid_mod, (8, 32, 16, True)),
    ("grid_mod_v1_fwd", _grid_mod, (4, 166, 8, False)),
    ("col_v3_fwd", _col, (32, 8, 16, False)),
    ("col_v3_inv", _col, (32, 8, 16, True)),
    ("col_v1_inv", _col, (166, 4, 8, True)),
]


@pytest.mark.parametrize("build,args", [c[1:] for c in FACTOR_CASES],
                         ids=[c[0] for c in FACTOR_CASES])
def test_factor_mode_matches_strided_call(interpret, build, args):
    """Each four-step twiddle form of the long tier: the port's descriptor
    (`ck.twiddle`) against the JAX package's separable tables, the scale
    riding the stages."""
    shape, n, kw, tabs, port = build(*args)
    inverse = args[-1]
    P, _, S = shape
    assert pallas_engine._use_v3(n) == (n != 166)
    re, im = _planes(shape, seed=sum(shape) + inverse)
    scale = 0.5
    run = pallas_engine._build_strided_call(n, inverse, P, S, True, "float32",
                                            scale=scale, **kw)
    rr, ri = run(jnp.asarray(re), jnp.asarray(im),
                 *[jnp.asarray(t) for t in tabs])
    got = ck.fft_strided(torch.from_numpy(re), torch.from_numpy(im), inverse,
                         scale, **port)
    assert got[0].shape == shape
    assert _rel(_c(*got), _c(rr, ri)) <= REF_TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_factor_mode_rows_and_keeps_match_strided_call(interpret, inverse):
    """The fused long Bluestein's strided passes (``pallas_engine.py:
    452-519``) at n = 3000, m = 64 * 128: the chirp (a full "rows" table in
    the JAX package) on the read with only the live rows read (in_keep),
    the four-step twiddle on the write; then the conjugate twiddle on the
    read and the chirp times the scale on the write with only the live
    rows written (out_keep).  The port reads the (B, n) line as the first n
    points of its (nc, ns) plane and writes only n points."""
    n, nc, ns, B = 3000, 64, 128, 2
    m = nc * ns
    rows = -(-n // ns)
    rows_buf = min(nc, -(-rows // 8) * 8)
    re, im = _planes((B, n), seed=31 + inverse)
    pad = ((0, 0), (0, rows_buf * ns - n))
    run = pallas_engine._build_strided_call(
        nc, False, B, ns, True, "float32", factors_pre=(("rows", nc),),
        factors_post=(("rows", nc),), in_keep=rows)
    rr, ri = run(jnp.asarray(np.pad(re, pad).reshape(B, rows_buf, ns)),
                 jnp.asarray(np.pad(im, pad).reshape(B, rows_buf, ns)),
                 *map(jnp.asarray,
                      _full(jluts.bluestein_chirp_rows(n, nc, ns, inverse))
                      + _full(jluts.fourstep_twiddle_full(nc, ns, False))))
    got = ck.fft_strided(torch.from_numpy(re), torch.from_numpy(im), False,
                         pre=ck.chirp(n, inverse), post=ck.twiddle(m),
                         plane=(nc, ns))
    assert got[0].shape == (B, m)
    assert _rel(_c(*got), _c(rr, ri).reshape(B, m)) <= REF_TOL
    # the inverse pass, from a spectrum in the swapped layout
    sr, si = _planes((B, nc, ns), seed=37 + inverse)
    scale = 1.0 / 3
    out_rows = -(-n // ns)
    run = pallas_engine._build_strided_call(
        nc, True, B, ns, True, "float32", factors_pre=(("rows", nc),),
        factors_post=(("rows", nc),), out_keep=out_rows)
    rr, ri = run(jnp.asarray(sr), jnp.asarray(si),
                 *map(jnp.asarray,
                      _full(jluts.fourstep_twiddle_full(nc, ns, True))
                      + _full(jluts.bluestein_chirp_rows(n, nc, ns, inverse,
                                                         scale=scale))))
    got = ck.fft_strided(torch.from_numpy(sr.reshape(B, m)),
                         torch.from_numpy(si.reshape(B, m)), True, scale,
                         pre=ck.twiddle(m, True), post=ck.chirp(n, inverse),
                         plane=(nc, ns), out_len=n)
    assert got[0].shape == (B, n)
    ref = _c(rr, ri).reshape(B, out_rows * ns)[:, :n]
    assert _rel(_c(*got), ref) <= REF_TOL


def test_factor_mode_matches_numpy():
    """The factor mode against its definition in numpy fp64, with live
    lengths that are not multiples of S and three uploads' pass 2 form."""
    nc, ns, B, n_in, n_out = 12, 20, 3, 229, 173
    re, im = _planes((B, n_in), seed=41)
    x = np.zeros((B, nc * ns), np.complex128)
    x[:, :n_in] = _c(re, im)
    f_pre = ck.twiddle(97, True, a=3, pm=3, b=1, sd=2)
    f_post = ck.chirp(n_out, False)

    def values(f, P):
        p = np.arange(P)[:, None, None]
        row = np.arange(nc)[None, :, None]
        s = np.arange(ns)[None, None, :]
        if f.kind == "chirp":
            e = (row * ns + s) ** 2 % f.N
        else:
            e = (row * f.a + p % f.pm * f.b) * (s // f.sd) % f.N
        return np.exp((2j if f.inverse else -2j) * np.pi * e / f.N)

    want = np.fft.fft(x.reshape(B, nc, ns) * values(f_pre, B), axis=1)
    want = (want * values(f_post, B)).reshape(B, -1)[:, :n_out]
    got = ck.fft_strided(*map(torch.from_numpy, (re, im)), pre=f_pre,
                         post=f_post, plane=(nc, ns), out_len=n_out)
    assert _rel(_c(*got), want) <= NUMPY_TOL


def test_factor_mode_checks():
    x = torch.zeros(2, 100)
    with pytest.raises(NotImplementedError, match="long tier"):
        ck.fft_strided(torch.zeros(1, 10000, 1), torch.zeros(1, 10000, 1),
                       pre=ck.twiddle(7))
    with pytest.raises(ValueError):
        ck.fft_strided(x, x, plane=(10, 5))            # 100 points > 50
    with pytest.raises(ValueError):
        ck.fft_strided(x, x, plane=(10, 10), out_len=101)
    with pytest.raises(ValueError):
        ck.fft_strided(x, x, plane=(10, 10), out_len=50, out=(x, x))
    assert ck.strided_tw_supports(166) and not ck.kernel_supports(166)
    assert not ck.strided_tw_supports(8192 * 2)
    before = dict(ck.launches)
    ck.fft_strided(x, x, plane=(10, 10))
    assert ck.launches == before
    # a transposed side takes whole planes, one side, no interleave and a
    # fresh output
    t = torch.zeros(2, 8, 6)
    for kw in (dict(in_transposed=True, out_transposed=True),
               dict(out_transposed=True, out_interleave=2),
               dict(in_transposed=True, out=(t, t))):
        with pytest.raises(ValueError):
            ck.fft_strided(t, t, **kw)
    # the C entry: four planes, P, S, the live lengths, the plans of the
    # two factors, their tables, the twiddle, the factors, the two
    # interleaves, the mode, then the layout
    assert set(ck._ENTRIES) == set(ck.KERNEL_SOURCES)
    # (and its half-storage entries, the same arguments on half planes;
    # the windowed entries of Bluestein's read window, the read bound after
    # the layout)
    assert ck._ENTRIES["fft_strided_tw"] == {
        **{f"fft_strided_tw{sfx}": "ppppqqqqppppppiiiiii"
           for sfx in ("", "_f16", "_bf16")},
        **{f"fft_strided_tw_zp{sfx}": "ppppqqqqppppppiiiiiiq"
           for sfx in ("", "_f16", "_bf16")}}


# ---------------------------------------------------------------------------
# The passes of the long tier against the JAX package's (interpret mode).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["natural", "swapped"])
@pytest.mark.parametrize("uploads", [2, 3])
def test_long_passes_match_reference(interpret, uploads, order):
    """`fft_long_p`/`fft_long3_p` on the JAX package's split of 32768
    ((128, 256); (8, 8, 512)) against `fft_long_planar` /
    `_fft_long3_planar`, both directions, and numpy.  Three uploads'
    swapped order differs: the JAX package leaves (ka, kb, ks), the port
    (kb, ka, ks), its middle digits in natural order (`long_order`)."""
    n, B = 32768, 2
    if uploads == 2:
        split = pallas_engine.split_long(n)
        ref_fn, port_fn = pallas_engine.fft_long_planar, cuda_engine.fft_long_p
    else:
        split = pallas_engine.split_long3(n)
        ref_fn, port_fn = (pallas_engine._fft_long3_planar,
                           cuda_engine.fft_long3_p)

    def to_port(a):
        a = np.asarray(a)
        if uploads == 3 and order == "swapped":
            na, nb, ns = split
            a = a.reshape(B, na, nb, ns).transpose(0, 2, 1, 3).reshape(B, n)
        return np.ascontiguousarray(a)

    re, im = _planes((B, n), seed=uploads * 10 + len(order))
    rr, ri = ref_fn(jnp.asarray(re), jnp.asarray(im), n, False, order=order)
    calls = torch_engine.calls
    y = port_fn(vt.from_numpy_planar(re, im), n, False, order=order,
                split=split)
    assert _rel(_c(y.re, y.im), _c(to_port(rr), to_port(ri))) <= REF_TOL
    want = np.fft.fft(_c(re, im))
    if order == "swapped":
        want = np.stack([ck.long_order(w, split).ravel() for w in want])
    assert _rel(_c(y.re, y.im), want) <= NUMPY_TOL
    zr, zi = ref_fn(rr, ri, n, True, order=order, scale=1.0 / n)
    z = port_fn(vt.from_numpy_planar(to_port(rr), to_port(ri)), n, True,
                1.0 / n, order=order, split=split)
    assert _rel(_c(z.re, z.im), _c(zr, zi)) <= REF_TOL
    assert _rel(_c(z.re, z.im), _c(re, im)) <= NUMPY_TOL
    assert torch_engine.calls == calls


def test_interleave_matches_numpy():
    """`fft_strided`'s interleaved layouts: the planes p = b*d + q read
    from and written to (P/d, n, d, S) memory."""
    d, B, n, S = 3, 2, 16, 8
    re, im = _planes((B * d, n, S), seed=7)
    x = _c(re, im)
    want = np.fft.fft(x, axis=1)
    got = ck.fft_strided(torch.from_numpy(re), torch.from_numpy(im),
                         out_interleave=d)
    laid = want.reshape(B, d, n, S).transpose(0, 2, 1, 3).reshape(B * d, n, S)
    assert _rel(_c(*got), laid) <= NUMPY_TOL
    back = ck.fft_strided(*got, True, 1.0 / n, in_interleave=d)
    assert _rel(_c(*back), x) <= NUMPY_TOL
    with pytest.raises(ValueError):
        ck.fft_strided(torch.from_numpy(re), torch.from_numpy(im),
                       out_interleave=4)              # 6 planes
    with pytest.raises(ValueError):
        ck.fft_strided(*got, in_interleave=d, out=got)


@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_modes_agree(inverse):
    """The fused long Bluestein and the composition on the long DIRECT
    routes (which the route takes only where m's lines fit no `fft_conv`)
    at n = 32771, m = 66560, both against numpy."""
    n, m = 32771, 66560
    assert plan_axis(n).decomp.bluestein_size == m
    re, im = _planes((2, n), seed=5 + inverse)
    want = (np.fft.ifft(_c(re, im)) * n if inverse
            else np.fft.fft(_c(re, im))) * 0.25
    for fn in (cuda_engine._bluestein_long_p,
               cuda_engine._bluestein_composed_p):
        y = fn(vt.from_numpy_planar(re, im), n, m, inverse, 0.25)
        assert _rel(_c(y.re, y.im), want) <= NUMPY_TOL, fn


# ---------------------------------------------------------------------------
# Routes, splits and launches.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch goes through
    `cuda_kernels._launch` and its counter, to a library stub that does
    nothing."""
    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launches()
    calls = torch_engine.calls
    yield ck.launches
    assert torch_engine.calls == calls


# DIRECT two uploads (16400, 2^20, 2^23 on fft_lines; 3 * 127^2 on
# fft_twofactor), three uploads (2^24, 2^26, 2^28; 97*101*103*107, four
# primes no two-upload split holds), the fused long Bluestein (32771,
# 65537, 99991), and a SPLIT around a Rader prime with a long factor
# (131 * 32768)
LONG_LENGTHS = [16400, 20480, 32768, 32771, 65537, 99991, 131 * 32768,
                3 * 127 * 127, 1 << 20, 1 << 23, 1 << 24, 1 << 26, 1 << 28,
                97 * 101 * 103 * 107]


@pytest.mark.parametrize("n", LONG_LENGTHS)
def test_long_route_launches(monkeypatch, n):
    """A forward and an inverse through FFTApplication launch exactly the
    kernels `route` names for one direction, twice, on meta tensors."""
    kernels = cuda_engine.route(plan_axis(n))
    assert kernels and "fft_strided_tw" in [k for k, _, _ in kernels]
    want = collections.Counter(k for k, _, _ in kernels)
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True),
                            engine="cuda")
    x = vt.Planar(torch.empty(1, n, device="meta"),
                  torch.empty(1, n, device="meta"))
    with _stubbed_launches(monkeypatch) as launches:
        y = app.inverse(app.forward(x))
        assert y.shape == (1, n)
        assert launches == {k: 2 * want[k] for k in ck.KERNEL_SOURCES}


@pytest.mark.parametrize("n", [n for n in LONG_LENGTHS
                               if plan_axis(n).algorithm is Algorithm.DIRECT])
def test_long_natural_order_folds_the_reorder(monkeypatch, n):
    """A forward and an inverse through FFTApplication, on meta tensors,
    call the tensor-op reorder (`swap_digits`) only where the split keeps
    it (`long_folds` false: ns = 8192, 16129, 9797 here), once a
    direction, and never where a pass stores or reads it transposed; the
    launches stay the route's, one a pass and direction."""
    reorders = []
    swap = ck.swap_digits
    monkeypatch.setattr(ck, "swap_digits",
                        lambda *a: reorders.append(a[1:]) or swap(*a))
    split = ck.long_split(n)
    want = collections.Counter(k for k, _, _ in cuda_engine.route(plan_axis(n)))
    assert sum(want.values()) == len(split)
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True),
                            engine="cuda")
    x = vt.Planar(torch.empty(2, n, device="meta"),
                  torch.empty(2, n, device="meta"))
    with _stubbed_launches(monkeypatch) as launches:
        y = app.inverse(app.forward(x))
        assert y.shape == (2, n)
        assert launches == {k: 2 * want[k] for k in ck.KERNEL_SOURCES}
    folds = ck.long_folds(split)
    assert len(reorders) == (0 if folds else 2), (split, reorders)
    assert folds == (split[-1] not in (8192, 16129, 9797)), split
    if folds:
        last = "fft_strided" if len(split) == 2 else "fft_strided_tw"
        assert want[last] >= 1 and want["fft_lines"] == 0


def test_composed_bluestein_launches(monkeypatch):
    """Where m's lines fit no `fft_conv` the route is the long forward and
    the long inverse of m; forced here at n = 32771 (m = 66560)."""
    monkeypatch.setattr(ck, "bluestein_long_split", lambda m: None)
    kernels = cuda_engine.route(plan_axis(32771))
    split = ck.long_split(66560)
    assert [(k, m) for k, _, m in kernels] == [
        ("fft_strided_tw", split[0]), ("fft_lines", split[1]),
        ("fft_lines", split[1]), ("fft_strided_tw", split[0])]
    x = vt.Planar(torch.empty(2, 32771, device="meta"),
                  torch.empty(2, 32771, device="meta"))
    with _stubbed_launches(monkeypatch) as launches:
        y = cuda_engine.fft_lines_p(x, plan_axis(32771), True, scale=0.5)
        assert y.shape == (2, 32771)
        assert launches == {k: (2 if k in ("fft_strided_tw", "fft_lines")
                                else 0) for k in ck.KERNEL_SOURCES}


def test_every_long_length_has_a_route():
    """Sampled lengths from 16385 to 2^28, and the named ones: each has a
    route whose every kernel holds its length, and the strided factors and
    the contiguous one multiply to the (padded) length."""
    lengths = (list(range(16385, 1 << 20, 4099)) + LONG_LENGTHS
               + [1 << k for k in range(15, 29)] + [67 * 71 * 73, 134 * 131])
    holds = {"fft_lines": ck.kernel_supports, "fft_conv": ck.kernel_supports,
             "fft_twofactor": ck.twofactor_supports,
             "fft_conv_inv": ck.twofactor_supports,
             "fft_conv_pair": lambda m: ck.conv_pair_plan(m) is not None,
             "fft_strided_tw": ck.strided_tw_supports,
             "fft_strided": ck.kernel_supports}
    for n in lengths:
        plan = plan_axis(n)
        kernels = cuda_engine.route(plan)
        assert kernels, n
        for kernel, _, m in kernels:
            assert holds[kernel](m), (n, kernel, m)
        if plan.algorithm is Algorithm.DIRECT and n > ck.TWOFACTOR_MAX_N:
            assert np.prod([m for _, _, m in kernels]) == n, n
    # the cost model: two uploads to 2^23, three from 2^24; two reach 2^27
    assert len(ck.long_split(1 << 23)) == 2
    assert len(ck.long_split(1 << 24)) == 3
    assert ck.long_split(1 << 27, 2) == (8192, 16384)
    assert ck.long_split(1 << 28, 2) is None
    assert ck.long_split(97 * 101 * 103 * 107, 2) is None
    assert ck.long_split(1 << 20, 3) is not None
    assert ck.long_split(3 * 127 * 127) == (3, 127 * 127)


def test_no_long_tier_refusal_is_left():
    """No message of the port names the long tier's ROADMAP item."""
    pkg = os.path.dirname(vt.__file__)
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    assert "queue 2 item 7" not in f.read(), name


@pytest.mark.parametrize("n,uploads", [(131 * 32768, 0), (1 << 16, 3)])
def test_long_lengths_match_reference(n, uploads):
    """A SPLIT with a long factor through FFTApplication, and a forced
    three-upload line, against the jnp engine and numpy, both ways."""
    re, im = _planes((1, n), seed=n % 1000)
    x = _c(re, im)
    ref = np.asarray(vk.fft(x.astype(np.complex64), engine="jnp"))
    calls = torch_engine.calls
    if uploads:
        y = cuda_engine.fft_long3_p(vt.from_numpy_planar(re, im), n)
        z = cuda_engine.fft_long3_p(y, n, True, 1.0 / n)
    else:
        app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True),
                                engine="cuda")
        y = app.forward(vt.from_numpy_planar(re, im))
        z = app.inverse(y)
    got = _c(y.re, y.im)
    assert _rel(got, ref) <= REF_TOL and _rel(got, np.fft.fft(x)) <= NUMPY_TOL
    assert _rel(_c(z.re, z.im), x) <= NUMPY_TOL
    assert torch_engine.calls == calls


# ---------------------------------------------------------------------------
# Compositions over long axes.
# ---------------------------------------------------------------------------

def test_long_convolution_composition_matches_jnp():
    """A 1-D convolution of n = 20480 (no fused mode holds it): the
    composition on the long routes against the jnp engine and numpy."""
    n = 20480
    rng = np.random.default_rng(20480)
    x = (rng.standard_normal((2, n))
         + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    h = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    cfg = vk.FFTConfig(shape=(n,), convolution=True)
    ref_app = vk.ConvolutionApplication(cfg, h, engine="jnp")
    xj = vk.Planar(jnp.asarray(x.real), jnp.asarray(x.imag))
    yr = ref_app(xj)
    ref = _c(yr.re, yr.im)
    want = np.fft.ifft(np.fft.fft(x.astype(np.complex128))
                       * np.fft.fft(h.astype(np.complex128)))
    app = vt.convolution_from_reference(
        dataclasses.asdict(cfg), np.asarray(ref_app.kernel_f.re),
        np.asarray(ref_app.kernel_f.im), engine="cuda", device="cpu")
    assert app.fusion_mode is None
    calls = torch_engine.calls
    y = app(vt.from_numpy_planar(x.real.copy(), x.imag.copy()))
    got = _c(y.re, y.im)
    assert _rel(got, ref) <= REF_TOL and _rel(got, want) <= NUMPY_TOL
    assert torch_engine.calls == calls


@pytest.mark.parametrize("family,type", [("dct", 2), ("dst", 4)])
def test_long_r2r_matches_jnp_and_scipy(family, type):
    """DCT-II and DST-IV of n = 20000 (beyond every R2R kernel): the
    composition on the long routes against the jnp engine and scipy, and
    the round trip."""
    n = 20000
    fwd, inv, ref_fn, sci = {"dct": (vt.dct, vt.idct, vk.dct, sfft.dct),
                             "dst": (vt.dst, vt.idst, vk.dst, sfft.dst)}[family]
    x = np.random.default_rng(n + type).standard_normal((2, n)).astype(
        np.float32)
    ref = np.asarray(ref_fn(x, type=type, engine="jnp"))
    want = sci(x.astype(np.float64), type=type)
    calls = torch_engine.calls
    y = fwd(torch.from_numpy(x), type=type, engine="cuda")
    assert _rel(y.numpy(), ref) <= REF_TOL and _rel(y.numpy(), want) <= NUMPY_TOL
    assert _rel(inv(y, type=type, engine="cuda").numpy(), x) <= REF_TOL
    assert torch_engine.calls == calls


def test_long_rfftn_matches_jnp():
    """rfftn/irfftn of (3, 40960): the real axis on the half-length route
    over the long tier, the other as lines."""
    shape = (3, 40960)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    ref = np.asarray(vk.rfftn(x, engine="jnp"))
    want = np.fft.rfftn(x.astype(np.float64))
    calls = torch_engine.calls
    X = vt.rfftn(torch.from_numpy(x), engine="cuda")
    assert _rel(X.numpy(), ref) <= REF_TOL and _rel(X.numpy(), want) <= NUMPY_TOL
    z = vt.irfftn(X, s=shape, engine="cuda")
    assert _rel(z.numpy(), x) <= NUMPY_TOL
    assert torch_engine.calls == calls
