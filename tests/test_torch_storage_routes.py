"""The storage tiers of C2C at every length, on the CPU: Rader, Bluestein,
SPLIT and the long tier under `Precision.HALF` / `Precision.BFLOAT16`.
The cuda engine's routing (the wrappers' plain versions on CPU tensors)
against the JAX package's jnp engine and its Pallas kernels in interpret
mode at the same tiers, and numpy fp64 at the reference's gates; each
route's exact launches of the half-storage instantiations on meta tensors
with the library call stubbed out; the long tier's per-upload scale of a
float16 inverse; the half entries' fp32 tables and layouts.  The kernels
themselves run only on the card (chip_smoke.py's storage phases)."""
import collections
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import Planar as JPlanar

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.pcomplex import widened
from vkfft_tpu_torch.planner.plan import plan_axis

TIERS = {"BFLOAT16": torch.bfloat16, "HALF": torch.float16}
# 4 storage ulps of max|ref| against the JAX package (tests/
# test_torch_storage.py), the reference's own gates against fp64
REF_TOL = {"BFLOAT16": 1.6e-2, "HALF": 2e-3}
NUMPY_TOL = {"BFLOAT16": 5e-2, "HALF": 5e-3}
# Rader on fft_conv (5003) and on fft_twofactor + fft_conv_inv (7919),
# Bluestein on fft_conv_pair (10007) and the fused long tier (65537),
# SPLIT (10006 = 5003 x 2), the long tier's two uploads (2^17)
LENGTHS = (7919, 10007, 10006, 5003, 1 << 17, 65537)
# The planes' amplitude: the JAX package's fp16 inverse puts the whole 1/N
# on its last upload, so at 2^17 and 65537 unit-variance planes overflow
# there (ROADMAP queue 3); at 1/16 (exact in both tiers) the reference stays
# in range.  The port's own range at unit variance and beyond is
# test_long_inverse_keeps_its_range's.
AMPLITUDE = 1.0 / 16


def _planes(shape, seed, amplitude=AMPLITUDE):
    rng = np.random.default_rng(seed)
    return tuple((amplitude * rng.standard_normal(shape)).astype(np.float32)
                 for _ in range(2))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jnp(p):
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


def _torch(p):
    return vt.to_numpy(widened(p)).astype(np.complex128)


def _apps(shape, tier, axes=None):
    kw = dict(shape=shape, normalize=True)
    if axes is not None:
        kw["fft_axes"] = axes
    ref = vk.FFTApplication(vk.FFTConfig(precision=vk.Precision[tier], **kw),
                            engine="jnp")
    port = vt.FFTApplication(vt.FFTConfig(precision=vt.Precision[tier], **kw),
                             engine="cuda", device="cpu")
    return ref, port


def _check_round_trip(tier, cfg_shape, shape, seed, axes=None):
    """Forward and normalized inverse of both packages on the same seeded
    planes (each application narrows them): the port's planes of the
    storage dtype, finite, within REF_TOL of the JAX package's and within
    the reference's gate of numpy fp64."""
    ref, port = _apps(cfg_shape, tier, axes)
    re, im = _planes(shape, seed)
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    dims = tuple(range(1, len(shape))) if axes is None else tuple(
        a + 1 for a in axes)
    jy = ref.forward(JPlanar(jnp.asarray(re), jnp.asarray(im)))
    py = port.forward(vt.from_numpy_planar(re, im))
    assert py.dtype == TIERS[tier] and str(jy.dtype) == str(py.dtype)[6:]
    assert np.isfinite(_torch(py)).all()
    assert _rel(_torch(py), _jnp(jy)) <= REF_TOL[tier]
    assert _rel(_torch(py), np.fft.fftn(x, axes=dims)) <= NUMPY_TOL[tier]
    jz, pz = ref.inverse(jy), port.inverse(py)
    assert pz.dtype == TIERS[tier] and np.isfinite(_torch(pz)).all()
    assert _rel(_torch(pz), _jnp(jz)) <= REF_TOL[tier]
    assert _rel(_torch(pz), x) <= NUMPY_TOL[tier]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("n", LENGTHS)
def test_routes_match_reference(tier, n):
    """Rader, Bluestein, SPLIT and the long tier at both tiers through
    FFTApplication on the cuda engine's routing (the wrappers' plain
    versions on CPU planes), forward and normalized inverse."""
    _check_round_trip(tier, (n,), (2, n), n)


@pytest.mark.parametrize("tier", list(TIERS))
def test_non_minor_rader_axis(tier):
    """A Rader axis that is not the minor one runs on the contiguous route
    (moved last, its lines, moved back) at the storage dtype."""
    _check_round_trip(tier, (7919, 4), (2, 7919, 4), 3, axes=(0,))


def test_rader_x0_rides_the_input():
    """On half planes `fft_conv`'s Rader route convolves x[perm] - x0 (the
    kernel sums to -1), not x0 added to the narrowed output, whose common
    rounding made the round trip's error coherent: at 5003 the round trip
    stays within two ulps of bf16 of numpy, as the two-factor route's does
    (the output-side x0 left it at 1.8e-2)."""
    re, im = _planes((2, 5003), 5003, 1.0)
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    for n, route in ((5003, "fft_conv"), (7919, "fft_twofactor")):
        assert cuda_engine.route(plan_axis(n))[0][0] == route
    app = vt.FFTApplication(vt.FFTConfig(shape=(5003,), normalize=True,
                                         precision=vt.Precision.BFLOAT16),
                            engine="cuda", device="cpu")
    z = app.inverse(app.forward(vt.from_numpy_planar(re, im)))
    assert _rel(_torch(z), x) <= 2 * 2.0 ** -8


@pytest.mark.parametrize("tier", list(TIERS))
def test_pallas_kernels_match_plain(tier):
    """The JAX package's fused Bluestein kernel (n = 100, m = 256) and its
    long tier (2^17) in interpret mode at the storage dtype against the
    port's plain versions on the same narrowed planes: `fft_conv`'s
    Bluestein mode and `fft_long_p` on the wrappers' plain versions."""
    dt = TIERS[tier]
    jdt = jnp.bfloat16 if tier == "BFLOAT16" else jnp.float16
    n, m = 100, 256   # any m >= 2n - 1 pads a Bluestein line
    re, im = _planes((3, n), 9)
    tr, ti = (torch.from_numpy(a).to(dt) for a in (re, im))
    N = 1 << 17
    lr, li = _planes((1, N), 10)
    pallas_engine.set_interpret(True)
    try:
        blue = pallas_engine.bluestein_fused_v3(
            JPlanar(jnp.asarray(re).astype(jdt), jnp.asarray(im).astype(jdt)),
            n, m, False)
        long_r, long_i = pallas_engine.fft_long_planar(
            jnp.asarray(lr).astype(jdt), jnp.asarray(li).astype(jdt), N,
            False)
    finally:
        pallas_engine.set_interpret(False)
    got = ck.fft_conv_plain(tr, ti, ck.bluestein_spectrum(n, m, False, 1.0,
                                                          "cpu"),
                            ck.bluestein_chirp(n, m, False, "cpu"))
    assert got[0].dtype == dt and str(blue.re.dtype) == str(dt)[6:]
    assert _rel(_torch(vt.Planar(*got)), _jnp(blue)) <= REF_TOL[tier]
    y = cuda_engine.fft_long_p(vt.from_numpy_planar(lr, li).astype(dt), N)
    assert y.dtype == dt and str(long_r.dtype) == str(dt)[6:]
    assert _rel(_torch(y), _jnp(JPlanar(long_r, long_i))) <= REF_TOL[tier]


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_long_inverse_keeps_its_range(monkeypatch, engine):
    """A float16 2^17 line at 4 sigma: its forward spectrum fits fp16 and,
    with each upload of the inverse scaled by its own factor's 1/n_k, so
    does the round trip, within fp16's gate of numpy; with the whole 1/N
    on the last upload (fp32's rule) the first upload's output passes
    65504 and the inverse is not finite."""
    n = 1 << 17
    re, im = _planes((1, n), 12, 4.0)
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True,
                                         precision=vt.Precision.HALF),
                            engine=engine, device="cpu")
    y = app.forward(vt.from_numpy_planar(re, im))
    assert np.isfinite(_torch(y)).all()
    z = app.inverse(y)
    assert z.dtype == torch.float16 and np.isfinite(_torch(z)).all()
    xn = _torch(vt.from_numpy_planar(re, im).astype(torch.float16))
    assert _rel(_torch(z), xn) <= NUMPY_TOL["HALF"]
    if engine == "cuda":
        assert cuda_engine._pass_scales(torch.float16, (512, 256), True,
                                        1.0 / n) == (1.0 / 512, 1.0 / 256)
        monkeypatch.setattr(cuda_engine, "_pass_scales",
                            lambda dt, f, inv, s: (1.0,) * (len(f) - 1) + (s,))
        last = app.inverse(y)
        assert not np.isfinite(_torch(last)).all()


def test_pass_scales():
    """fp32 keeps the whole scale on the last pass; half planes' inverse
    passes each take their own factor's 1/n_k and the last the rest (the
    caller's scale times the earlier factors)."""
    ps = cuda_engine._pass_scales
    assert ps(torch.float32, (256, 256, 256), True, 0.5) == (1.0, 1.0, 0.5)
    assert ps(torch.bfloat16, (512, 256), False, 0.5) == (1.0, 0.5)
    assert ps(torch.float16, (8, 4, 2), True, 1.0 / 64) == (0.125, 0.25,
                                                            1.0 / 64 * 32)
    assert ps(torch.bfloat16, (5003, 2), True, 1.0) == (1.0 / 5003, 5003.0)


# ---------------------------------------------------------------------------
# Launches on meta tensors.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed_launches(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch counted by
    `cuda_kernels._launch` and recorded as (C entry, arguments before the
    stream); no plain version and no plain-engine call may run."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args[:-1])) or 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    ck.reset_launches()
    before = torch_engine.calls
    yield calls
    assert torch_engine.calls == before


def _meta(shape, dtype=torch.float32):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


# (route, length, forced): each route of `cuda_engine.route` on the storage
# tiers; "composed" forces the composition on the long DIRECT routes, which
# the route takes only where m's lines fit no fft_conv
ROUTES = [("rader_conv", 5003), ("rader_twofactor", 7919),
          ("bluestein_conv", 1006), ("bluestein_pair", 10007),
          ("bluestein_twofactor", 4213), ("bluestein_long", 65537),
          ("bluestein_composed", 32771), ("split", 10006),
          ("two_uploads_folded", 1 << 17), ("two_uploads", 1 << 22),
          ("three_uploads_folded", 1 << 24), ("three_uploads_2^26", 1 << 26),
          ("three_uploads", 1 << 30)]
FIRST = {"rader_conv": "fft_conv", "rader_twofactor": "fft_twofactor",
         "bluestein_conv": "fft_conv", "bluestein_pair": "fft_conv_pair",
         "bluestein_twofactor": "fft_twofactor",
         "bluestein_long": "fft_strided_tw",
         "bluestein_composed": "fft_strided_tw", "split": "fft_conv"}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name,n", ROUTES, ids=[r for r, _ in ROUTES])
def test_route_launches(monkeypatch, tier, name, n):
    """FFTApplication under HALF / BFLOAT16 on float32 Planar input, a
    forward and a normalized inverse: exactly the half-storage launches
    `cuda_engine.route` names for each direction, on planes of the storage
    dtype; no fp32 or fp64 launch and no plain-engine call."""
    dt = TIERS[tier]
    sfx = ck._SUFFIX[dt]
    if name == "bluestein_composed":
        monkeypatch.setattr(ck, "bluestein_long_split", lambda m: None)
    plan = plan_axis(n)
    kernels = [k for k, _, _ in cuda_engine.route(plan)]
    if name in FIRST:
        assert kernels[0] == FIRST[name], kernels
    else:
        split = ck.long_split(n)
        assert (len(split), ck.long_folds(split)) == (
            3 if "three" in name else 2, "folded" in name or "2^26" in name)
    want = collections.Counter(2 * kernels)
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True,
                                         precision=vt.Precision[tier]),
                            engine="cuda")
    with _stubbed_launches(monkeypatch) as calls:
        y = app.forward(_meta((2, n)))
        assert y.dtype == dt
        z = app.inverse(y)
        assert z.shape == (2, n) and z.dtype == dt
    assert ck.storage_launches == {k: want.get(k[:-len(sfx)], 0)
                                   if k.endswith(sfx) else 0
                                   for k in ck.storage_launches}
    assert sum(ck.launches.values()) == sum(ck.f64_launches.values()) == 0
    assert all(e.endswith(sfx) for e, _ in calls)
    assert len(calls) == sum(want.values())


def test_storage_rule_is_fp32s():
    """`storage_axis_supports` holds wherever `supports` does: every route
    has its half instantiations, so the tiers run every length the fp32
    tier runs."""
    for n in list(range(1, 20000, 37)) + [n for _, n in ROUTES]:
        plan = plan_axis(n)
        assert cuda_engine.storage_axis_supports(plan) == cuda_engine.supports(
            plan), n
    for dt in TIERS.values():
        for n in (7919, 10007, 10006, 1 << 26):
            assert cuda_engine.axis_supports(plan_axis(n), dt)
            assert cuda_engine.storage_supports((8, n), (0, 1))
        cuda_engine.check_walk((4, 7919, 1 << 17), (0, 1, 2), dt)


@pytest.mark.parametrize("tier", list(TIERS))
def test_half_entries_take_fp32_tables_and_layouts(monkeypatch, tier):
    """The half entries of the other routes get the fp32 layouts
    (`strided_tw_layout`, `conv_layout`, `twofactor_layout`,
    `conv_pair_layout`, and `conv2d_layout` for the 2-D mode of
    fft_conv_pair), fp32 stage, twiddle, spectrum and chirp tables and fp32
    per-line constants, and write planes of the storage dtype; half
    per-line constants are refused."""
    dt = TIERS[tier]
    sfx = ck._SUFFIX[dt]
    dev = torch.device("meta")
    ck._DEVICE_TABLES.clear()
    with _stubbed_launches(monkeypatch) as calls:
        s = _meta((16, 512, 2048), dt)
        a = ck.fft_strided(s.re, s.im, post=ck.twiddle(1 << 20),
                           out_transposed=True)
        r = _meta((1676, 5002), dt)
        b = ck.fft_conv(r.re, r.im, ck.rader_spectrum(5003, 1.0, dev))
        t = _meta((1059, 7918), dt)
        dc = (torch.empty(1059, device=dev), torch.empty(1059, device=dev))
        c = ck.fft_conv_inv(t.re, t.im,
                            ck.rader_spectrum(7919, 1.0, dev, "swapped"),
                            dc=dc)
        p = _meta((838, 10007), dt)
        m = plan_axis(10007).decomp.bluestein_size
        d = ck.fft_conv_pair(p.re, p.im,
                             ck.bluestein_spectrum(10007, m, False, 1.0, dev,
                                                   "pair"),
                             ck.bluestein_chirp(10007, m, False, dev))
        q = _meta((4, 64, 64), dt)
        e = ck.fft_conv_pair(q.re, q.im, torch.empty(4096, 2, device=dev))
        with pytest.raises(TypeError, match="item 10"):
            ck.fft_conv_inv(t.re, t.im,
                            ck.rader_spectrum(7919, 1.0, dev, "swapped"),
                            dc=tuple(u.to(dt) for u in dc))
    assert [e for e, _ in calls] == [
        f"vk_{k}{sfx}" for k in ("fft_strided_tw", "fft_conv", "fft_conv_inv",
                                 "fft_conv_pair", "fft_conv2d")]
    assert calls[0][1][-3:] == ck.strided_tw_layout(512, 2048)
    assert calls[1][1][-3:] == ck.conv_layout(5002)
    assert calls[2][1][-3:] == ck.twofactor_layout(7918)
    assert calls[3][1][-3:] == ck.conv_pair_layout(m)[2:]
    assert calls[4][1][-3:] == ck.conv2d_layout(64, 64)[:3]
    assert all(y[0].dtype == dt for y in (a, b, c, d, e))
    assert a[0].shape == (16, 2048, 512)
    # every table of these launches fp32: no dtype in its key
    assert ck._DEVICE_TABLES and all(
        v.dtype == torch.float32 and not any("torch." in str(e) for e in k)
        for k, v in ck._DEVICE_TABLES.items())
    assert ck.storage_launches == {
        k: int(k.endswith(sfx) and k[:-len(sfx)] in (
            "fft_strided_tw", "fft_conv", "fft_conv_inv", "fft_conv_pair",
            "fft_conv2d"))
        for k in ck.storage_launches}


def test_plain_versions_round_once():
    """The new half plain versions widen, compute in fp32 and narrow once:
    the fp32 plain version's result, rounded."""
    rng = np.random.default_rng(3)
    tr, ti = (torch.from_numpy(rng.standard_normal((3, 130))
                               .astype(np.float32)) for _ in range(2))
    m = 256   # a Bluestein pad of 67-point lines (>= 2n - 1)
    cases = (  # (plain version, points of the lines, arguments after them)
        (ck.fft_conv_plain, 130, (ck.rader_spectrum(131, 0.5, "cpu"),)),
        (ck.fft_conv_inv_plain, 130,
         (ck.rader_spectrum(131, 0.5, "cpu", "swapped"), (tr[:, 0], ti[:, 0]),
          0.25)),
        (ck.fft_conv_plain, 67,
         (ck.bluestein_spectrum(67, m, True, 1.0, "cpu"),
          ck.bluestein_chirp(67, m, True, "cpu"))))
    for dt in TIERS.values():
        for fn, n, args in cases:
            hr, hi = tr[:, :n].to(dt), ti[:, :n].to(dt)
            got, want = fn(hr, hi, *args), fn(hr.float(), hi.float(), *args)
            assert got[0].dtype == dt
            assert torch.equal(got[0], want[0].to(dt))
            assert torch.equal(got[1], want[1].to(dt))
