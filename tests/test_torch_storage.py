"""The storage tiers of C2C on the port, on the CPU: `Precision.HALF` and
`Precision.BFLOAT16` narrow `Planar` input to float16 / bfloat16 planes and
compute every pass in fp32 (the reference's halfPrecisionMemoryOnly).  The
port's CPU path and the cuda engine's routing (the wrappers' plain versions
on CPU tensors) against the JAX package's jnp engine and its Pallas
kernels in interpret mode at the same tiers, and numpy fp64 at the
reference's gates; each route's exact launches of the half-storage
instantiations, counted by the wrappers on meta tensors with the library
call stubbed out; the refusals of what still has no kernel of its dtype
(float64 off the fp64 kernels, float64 real and convolution data, half
planes on the real kernels' own wrappers); the layout rules at the half
dtypes.  Rader, Bluestein, SPLIT and the long tier at the tiers are
tests/test_torch_storage_routes.py's, half real and convolution data
tests/test_torch_storage_real.py's.  The kernels themselves run
only on the card (chip_smoke.py's storage phases)."""
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
# 4 storage ulps of max|ref| (the unit roundoff 2^-8 of bf16, 2^-11 of
# fp16, times 4: one rounding of the input, one of the output, and the
# fp32 passes' different orders of sums between them)
REF_TOL = {"BFLOAT16": 1.6e-2, "HALF": 2e-3}
# the reference's own gates against fp64 (tests/test_precision_tiers.py)
NUMPY_TOL = {"BFLOAT16": 5e-2, "HALF": 5e-3}
F32_REF_TOL = 1e-5
SAMPLE_1002 = (8, 16, 32, 64, 128, 256, 512, 1024, 60, 100, 360)
SAMPLE_13 = (64, 256, 1024)


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jnp(p):
    """A JAX Planar as numpy complex128 (its planes widened exactly)."""
    return (np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64))


def _torch(p):
    """A port Planar as numpy complex128 (half planes widened exactly)."""
    return vt.to_numpy(widened(p)).astype(np.complex128)


def _pair(shape, seed, tier):
    """The same seeded float32 planes as a JAX and a port Planar; each
    application narrows them to the tier itself."""
    re, im = _planes(shape, seed)
    return (JPlanar(jnp.asarray(re), jnp.asarray(im)),
            vt.from_numpy_planar(re, im),
            re.astype(np.float64) + 1j * im.astype(np.float64))


def _apps(shape, tier, axes=None, engine="cuda"):
    kw = dict(shape=shape, normalize=True)
    if axes is not None:
        kw["fft_axes"] = axes
    ref = vk.FFTApplication(vk.FFTConfig(precision=vk.Precision[tier], **kw),
                            engine="jnp")
    port = vt.FFTApplication(vt.FFTConfig(precision=vt.Precision[tier], **kw),
                             engine=engine, device="cpu")
    return ref, port


def _check_round_trip(ref, port, jx, px, x, tier, axes):
    """Forward and normalized inverse of both packages: the port's planes
    of the storage dtype, within REF_TOL of the JAX package's and within
    the reference's gate of numpy fp64."""
    jy, py = ref.forward(jx), port.forward(px)
    assert py.dtype == TIERS[tier] and str(jy.dtype) == str(py.dtype)[6:]
    want = np.fft.fftn(x, axes=axes)
    assert _rel(_torch(py), _jnp(jy)) <= REF_TOL[tier]
    assert _rel(_torch(py), want) <= NUMPY_TOL[tier]
    jz, pz = ref.inverse(jy), port.inverse(py)
    assert pz.dtype == TIERS[tier]
    assert _rel(_torch(pz), _jnp(jz)) <= REF_TOL[tier]
    assert _rel(_torch(pz), x) <= NUMPY_TOL[tier]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("n", sorted(set(SAMPLE_1002 + SAMPLE_13)))
def test_lines_match_reference(tier, n):
    """Sample 1002's and sample 13's lengths through FFTApplication at
    both tiers, the cuda engine's routing on CPU planes (the wrappers'
    plain versions): forward and normalized inverse against the JAX
    package's jnp engine and numpy."""
    ref, port = _apps((n,), tier)
    _check_round_trip(ref, port, *_pair((4, n), n, tier), tier, (1,))


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_plane_matches_reference(tier, engine):
    """ex02's (16, 64) plane (the pair's route on the cuda engine) on
    both engines."""
    ref, port = _apps((16, 64), tier, engine=engine)
    _check_round_trip(ref, port, *_pair((2, 16, 64), 5, tier), tier, (1, 2))


VOLUME_AXES = [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("axes", VOLUME_AXES,
                         ids=["".join(map(str, a)) for a in VOLUME_AXES])
def test_volume_matches_reference(tier, axes):
    """An (8, 16, 32) volume over every axis subset: the strided and pair
    routes of non-minor axes, the 1/N on the last pass."""
    ref, port = _apps((8, 16, 32), tier, axes)
    _check_round_trip(ref, port, *_pair((2, 8, 16, 32), len(axes), tier),
                      tier, tuple(a + 1 for a in axes))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_fp16_inverse_keeps_its_range(engine):
    """A (64, 64, 64) fp16 volume whose forward spectrum fits fp16 but
    whose unnormalized inverse intermediate does not (its first inverse
    pass returns 64 times the 2-D spectrum of the other axes, past 65504):
    with each inverse pass scaled by its own axes' 1/n the round trip is
    finite and within fp16's gate; with the whole 1/N on the last pass
    (fp32's rule), the first pass is inf."""
    re, im = _planes((64, 64, 64), 12)
    x = vt.from_numpy_planar(10 * re, 10 * im)
    kw = dict(shape=(64, 64, 64), precision=vt.Precision.HALF)
    app = vt.FFTApplication(vt.FFTConfig(normalize=True, **kw),
                            engine=engine, device="cpu")
    y = app.forward(x)
    assert bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all())
    z = app.inverse(y)
    assert z.dtype == torch.float16
    assert bool(torch.isfinite(z.re).all() and torch.isfinite(z.im).all())
    xn = _torch(x.astype(torch.float16))
    assert _rel(_torch(z), xn) <= NUMPY_TOL["HALF"]
    first = vt.api.get_engine(engine).fft_axis_p(y, 0, plan_axis(64), True)
    assert not bool(torch.isfinite(first.re).all())


@pytest.mark.parametrize("tier", list(TIERS))
def test_pallas_kernels_match_plain(tier):
    """The JAX package's v3 and v2 Pallas kernels at the storage dtype in
    interpret mode against `fft_lines_plain` and `fft_twofactor_plain` on
    the same narrowed planes, n = 256, batch 4."""
    n = 256
    re, im = _planes((4, n), 9)
    jdt = jnp.bfloat16 if tier == "BFLOAT16" else jnp.float16
    jr, ji = jnp.asarray(re).astype(jdt), jnp.asarray(im).astype(jdt)
    tr = torch.from_numpy(re).to(TIERS[tier])
    ti = torch.from_numpy(im).to(TIERS[tier])
    pallas_engine.set_interpret(True)
    try:
        v3 = pallas_engine.core_fft_planar_v3(jr, ji, n, False)
        v2 = pallas_engine.core_fft_planar_v2(jr, ji, n, False)
    finally:
        pallas_engine.set_interpret(False)
    for (yr, yi), plain in ((v3, ck.fft_lines_plain(tr, ti, False)),
                            (v2, ck.fft_twofactor_plain(tr, ti, False))):
        assert str(yr.dtype) == str(plain[0].dtype)[6:]
        got = _torch(vt.Planar(*plain))
        assert _rel(got, _jnp(JPlanar(yr, yi))) <= REF_TOL[tier]


@pytest.mark.parametrize("tier", list(TIERS))
def test_narrowing_is_bit_identical(tier):
    """JAX's astype and torch's .to round float32 to the storage dtype
    alike (nearest even), so both packages start from the same planes;
    values at the halfway points and fp16's range included."""
    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.integers(
            -6, 5, 4000),
        np.float32([0.0, -0.0, 1 + 2 ** -9, 1 + 3 * 2 ** -9, 1 + 2 ** -12,
                    1 + 3 * 2 ** -12, 65504.0, 65519.0, 6e-8, 1e-40])]
    ).astype(np.float32)
    assert x.dtype == np.float32
    jdt = jnp.bfloat16 if tier == "BFLOAT16" else jnp.float16
    j = np.asarray(jnp.asarray(x).astype(jdt)).view(np.uint16)
    t = torch.from_numpy(x).to(TIERS[tier]).view(torch.int16).numpy()
    np.testing.assert_array_equal(j, t.view(np.uint16))


@pytest.mark.parametrize("tier", list(TIERS))
def test_complex_input_ignores_the_tier(tier):
    """Complex tensors and host arrays are not Planar: under HALF and
    BFLOAT16 they run at complex64 and come back complex64, matching the
    JAX package's non-Planar result at the fp32 tolerance."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 64))
         + 1j * rng.standard_normal((3, 64))).astype(np.complex64)
    ref, port = _apps((64,), tier)
    want = np.asarray(ref.forward(jnp.asarray(x)))
    got = port.forward(x)
    assert got.dtype == np.complex64 and _rel(got, want) <= F32_REF_TOL
    t = port.forward(torch.from_numpy(x))
    assert t.dtype == torch.complex64 and _rel(t.numpy(), want) <= F32_REF_TOL
    back = port.inverse(t)
    assert back.dtype == torch.complex64 and _rel(back.numpy(), x) <= 1e-6


def test_half_planar_under_single_runs_at_storage():
    """bf16 / fp16 Planar planes under SINGLE run at their dtype, as the
    JAX package's kernels run such planes, with the same numbers as the
    BFLOAT16 / HALF tiers give for the narrowed input."""
    re, im = _planes((3, 100), 11)
    for tier, dt in TIERS.items():
        p = vt.from_numpy_planar(re, im)
        single = vt.FFTApplication(vt.FFTConfig(shape=(100,)), engine="cuda",
                                   device="cpu").forward(p.astype(dt))
        tiered = vt.FFTApplication(vt.FFTConfig(
            shape=(100,), precision=vt.Precision[tier]), engine="cuda",
            device="cpu").forward(p)
        assert single.dtype == tiered.dtype == dt
        assert torch.equal(single.re, tiered.re)
        assert torch.equal(single.im, tiered.im)
        np.testing.assert_array_equal(vt.to_numpy(single),
                                      vt.to_numpy(widened(single)))


# Rader, Bluestein, SPLIT and the long tier: the storage tiers run them
# (tests/test_torch_storage_routes.py), and half real lines of 2n points
# and half convolution run too (tests/test_torch_storage_real.py); at these
# lengths what still refuses is float64 off the fp64 kernels and float64
# real and convolution data (ROADMAP queue 1 item 10.3)
REFUSED = (7919, 10007, 10006, 1 << 17)


@pytest.mark.parametrize("n", REFUSED)
def test_routes_without_storage_kernels_refuse(n):
    """At Rader, Bluestein, SPLIT and long lengths the cuda engine runs
    half planes, real half lines of 2n points (the n-point C2C at the half
    dtype, float32 planes out) and a half convolution (half planes out),
    and still refuses, naming ROADMAP queue 1 item 10, what has no kernel
    of its dtype: float64 planes (no fp64 kernel off `fft_lines`' DIRECT
    lengths), float64 real lines and a float64 convolution; the CPU torch
    engine runs every length (widened to fp32)."""
    plan = plan_axis(n)
    assert cuda_engine.storage_axis_supports(plan)
    assert cuda_engine.storage_supports((n,), (0,))
    assert not cuda_engine.f64_axis_supports(plan)
    x = vt.Planar(torch.zeros(1, n, dtype=torch.float64),
                  torch.zeros(1, n, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.fft_lines_p(x, plan)
    X = cuda_engine.rfft_lines_p(torch.ones(1, 2 * n, dtype=torch.bfloat16))
    assert X.dtype == torch.float32 and X.shape == (1, n + 1)
    # DC: twice the bin n of the n-point C2C, rounded to bfloat16
    assert abs(float(X.re[0, 0]) - 2 * n) <= 2 * n * 2 ** -8
    assert float(X.re[0, 1:].abs().max()) <= 1e-2 * n
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.rfft_lines_p(torch.zeros(1, 2 * n, dtype=torch.float64))
    y = cuda_engine.conv_fused_v3(vt.Planar(torch.ones(1, 64).half(),
                                            torch.zeros(1, 64).half()),
                                  64, torch.ones(64, 2), scale=1 / 64)
    assert y.dtype == torch.float16
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.conv_fused_v3(x[:, :64].contiguous(), 64,
                                  torch.zeros(64, 2))
    cfg = vt.FFTConfig(shape=(n,), precision=vt.Precision.HALF)
    y = vt.FFTApplication(cfg, engine="torch", device="cpu").forward(
        vt.Planar(torch.zeros(1, n), torch.zeros(1, n)))
    assert y.dtype == torch.float16


def test_storage_rule():
    """`storage_axis_supports`: every plan the fp32 tier runs (`supports`),
    n <= 4 as tensor ops; every route's kernels have half instantiations."""
    for n in range(1, 16400, 7):
        plan = plan_axis(n)
        assert cuda_engine.storage_axis_supports(plan), n
        assert all(k in ck.STORAGE_KERNELS
                   for k, _, _ in cuda_engine.route(plan)), n
    assert cuda_engine.storage_supports((64, 131, 10240), (0, 2))
    assert cuda_engine.storage_supports((64, 131, 10240), (1,))
    for dt in TIERS.values():
        assert cuda_engine.pair_supports(256, 256, dt)
        assert cuda_engine.pair_supports(16, 64, dt)
        assert cuda_engine.axis_supports(plan_axis(1024), dt)
        assert cuda_engine.axis_supports(plan_axis(131), dt)
        assert not cuda_engine.axis_supports(plan_axis(131), torch.float64)


def test_layouts_are_fp32s():
    """A half plane's point is a float2 in shared memory, so every layout
    rule gives the fp32 layout at both half dtypes."""
    for dt in TIERS.values():
        assert ck.point_bytes(dt) == 8
        for n in (2, 47, 60, 100, 256, 360, 1001, 1024, 4096, 8192):
            assert ck.lines_layout(n, dt) == ck.lines_layout(n)
            assert ck.lines_split(n, dt) == ck.lines_split(n)
            assert ck.kernel_supports(n, dt) and ck.twofactor_supports(n, dt)
            for S in (1, 33, 65536):
                assert ck.strided_layout(n, S, dt) == ck.strided_layout(n, S)
                assert ck.strided_split(n, S, dt) == ck.strided_split(n, S)
        for ny, nz in ((16, 64), (256, 256), (2, 8064), (47, 60)):
            assert ck.pair_cluster(ny, nz, dt) == ck.pair_cluster(ny, nz)
            assert ck.pair_layout(ny, nz, dt) == ck.pair_layout(ny, nz)
            assert ck.pair_splits(ny, nz, dt) == ck.pair_splits(ny, nz)
        assert ck.twofactor_supports(10240, dt)
        assert not ck.twofactor_supports(10240, torch.float64)


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


# (shape, launches of a forward and a normalized inverse): sample 2's
# rows, sample 7's DIRECT 10240, a tensor-op axis, ex02's plane, the cube
# (pair + strided), a non-minor two-factor axis (the contiguous route), a
# plane fp32's pair does not hold (two axis passes)
STORAGE_ROUTES = [((4, 256), {"fft_lines": 2}),
                  ((2, 1024), {"fft_lines": 2}),
                  ((2, 4096), {"fft_lines": 2}),
                  ((2, 10240), {"fft_twofactor": 2}),
                  ((3, 3), {}),
                  ((2, 16, 64), {"fft_pair": 2}),
                  ((2, 8, 256, 256), {"fft_pair": 2, "fft_strided": 2}),
                  ((2, 10240, 4), {"fft_twofactor": 2}),
                  ((2, 2, 16384), {"fft_twofactor": 2, "fft_strided": 2})]


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("shape,want", STORAGE_ROUTES,
                         ids=["x".join(map(str, s)) for s, _ in
                              STORAGE_ROUTES])
def test_storage_launches(monkeypatch, tier, shape, want):
    """FFTApplication under HALF / BFLOAT16 on float32 Planar input over
    every axis but the batch launches the half-storage instantiations
    only, exactly as the walk names them, on planes of the storage dtype;
    no fp32 or fp64 launch and no plain-engine call."""
    dt = TIERS[tier]
    sfx = ck._SUFFIX[dt]
    app = vt.FFTApplication(vt.FFTConfig(shape=shape[1:], normalize=True,
                                         precision=vt.Precision[tier]),
                            engine="cuda")
    with _stubbed_launches(monkeypatch) as calls:
        y = app.inverse(app.forward(_meta(shape)))
        assert y.shape == shape and y.dtype == dt
    assert ck.storage_launches == {k: want.get(k[:-len(sfx)], 0)
                                   if k.endswith(sfx) else 0
                                   for k in ck.storage_launches}
    assert sum(ck.launches.values()) == sum(ck.f64_launches.values()) == 0
    assert all(e.endswith(sfx) for e, _ in calls)
    assert len(calls) == sum(want.values())


@pytest.mark.parametrize("n", REFUSED)
def test_refusal_before_any_launch(monkeypatch, n):
    """What still has no kernel of its dtype is refused before the first
    launch: a C2C walk of float64 planes that meets an axis off the fp64
    kernels, also where an earlier axis has them; rfft of float64 lines
    and a convolution of float64 planes.  rfft of bfloat16 lines and a
    convolution of half planes run: the n-point route's half launches and
    one half fft_conv, nothing else."""
    conv = vt.ConvolutionApplication(
        vt.FFTConfig(shape=(64,), convolution=True),
        np.ones(64, np.complex64), engine="cuda",
        kernel_in_freq_domain=True, device="meta")
    with _stubbed_launches(monkeypatch) as calls:
        for shape in ((2, n), (2, 8, n)):
            app = vt.FFTApplication(vt.FFTConfig(shape=shape[1:]),
                                    engine="cuda")
            with pytest.raises(NotImplementedError, match="item 10"):
                app.forward(_meta(shape, torch.float64))
        with pytest.raises(NotImplementedError, match="item 10"):
            vt.rfft(torch.empty(2, 2 * n, dtype=torch.float64,
                                device="meta"), engine="cuda")
        with pytest.raises(NotImplementedError, match="item 10"):
            conv(_meta((2, 64), torch.float64))
        assert calls == []
        assert sum(ck.storage_launches.values()) == 0
        assert sum(ck.f64_launches.values()) == sum(ck.launches.values()) == 0
        X = vt.rfft(_meta((2, 2 * n), torch.bfloat16), engine="cuda")
        assert X.dtype == torch.float32 and X.shape == (2, n + 1)
        y = conv(_meta((2, 64), torch.float16))
        assert y.dtype == torch.float16
    route = [k for k, _, _ in cuda_engine.route(plan_axis(n))]
    assert sorted(e for e, _ in calls) == sorted(
        [f"vk_{k}_bf16" for k in route] + ["vk_fft_conv_f16"])
    assert sum(ck.f64_launches.values()) == sum(ck.launches.values()) == 0


def test_launch_arguments(monkeypatch):
    """The half entries get the fp32 layout and fp32 stage and twiddle
    tables (walk_radices: radix 16), on planes of the storage dtype, the
    2-D conv mode's (``vk_fft_conv2d_<dtype>``) too; the real kernels take
    no half dtype (the other C2C kernels' half entries:
    tests/test_torch_storage_routes.py)."""
    ck._DEVICE_TABLES.clear()
    outs = []
    with _stubbed_launches(monkeypatch) as calls:
        for dt in TIERS.values():
            x = _meta((3, 1024), dt)
            outs.append(ck.fft_lines(x.re, x.im, True, 0.5))
            t = _meta((2, 10240), dt)
            outs.append(ck.fft_twofactor(t.re, t.im, swapped=True))
            s = _meta((2, 256, 40), dt)
            outs.append(ck.fft_strided(s.re, s.im))
            p = _meta((2, 256, 256), dt)
            outs.append(ck.fft_pair(p.re, p.im))
            q = _meta((2, 32, 32), dt)
            outs.append(ck.fft_conv_pair(q.re, q.im,
                                         torch.empty(1024, 2, device="meta")))
            with pytest.raises(TypeError, match="item 10"):
                ck.fft_r2c(x.re)
    entries = [e for e, _ in calls]
    assert entries == [f"vk_{k}{ck._SUFFIX[dt]}" for dt in TIERS.values()
                       for k in ("fft_lines", "fft_twofactor", "fft_strided",
                                 "fft_pair", "fft_conv2d")]
    assert calls[0][1][-3:] == ck.lines_layout(1024)
    assert calls[1][1][-3:] == ck.twofactor_layout(10240)
    assert calls[2][1][-3:] == ck.strided_layout(256, 40)
    assert calls[3][1][-3:] == ck.pair_layout(256, 256)
    assert calls[4][1][-3:] == ck.conv2d_layout(32, 32)[:3]
    assert [y[0].dtype for y in outs] == [dt for dt in TIERS.values()
                                          for _ in range(5)]
    # every table of these launches fp32 (no dtype in its key), the stage
    # tables of the walk's radices
    tabs = [k for k in ck._DEVICE_TABLES if k[-1] == "meta"]
    assert tabs and all(ck._DEVICE_TABLES[k].dtype == torch.float32
                        and not any("torch." in str(e) for e in k)
                        for k in tabs)
    walk = {k[4] for k in tabs if k[0] == "stages" and k[1] in (1024, 256,
                                                                  40)}
    assert True in walk
    assert ck.storage_launches == {
        k: int(k.rsplit("_", 1)[0] in ("fft_lines", "fft_twofactor",
                                       "fft_strided", "fft_pair",
                                       "fft_conv2d"))
        for k in ck.storage_launches}


def test_plain_versions_round_once():
    """The half plain versions widen, compute in fp32 (the scale included)
    and narrow once: the fp32 plain version's result, rounded."""
    re, im = _planes((2, 16, 64), 3)
    tr, ti = torch.from_numpy(re), torch.from_numpy(im)
    for dt in TIERS.values():
        hr, hi = tr.to(dt), ti.to(dt)
        for got, want in (
                (ck.fft_pair_plain(hr, hi, True, 1 / 1024),
                 ck.fft_pair_plain(hr.float(), hi.float(), True, 1 / 1024)),
                (ck.fft_lines_plain(hr[0], hi[0], True, 0.25),
                 ck.fft_lines_plain(hr[0].float(), hi[0].float(), True,
                                    0.25)),
                (ck.fft_strided_plain(hr, hi, False, 0.5),
                 ck.fft_strided_plain(hr.float(), hi.float(), False, 0.5)),
                (ck.fft_twofactor_plain(hr[0], hi[0], False, swapped=True),
                 ck.fft_twofactor_plain(hr[0].float(), hi[0].float(), False,
                                        swapped=True))):
            assert got[0].dtype == dt
            assert torch.equal(got[0], want[0].to(dt))
            assert torch.equal(got[1], want[1].to(dt))


def test_ptxas_parser_holds_storage_kernels():
    """chip_smoke's toolchain phase names the half instantiations from
    ptxas's mangled names and holds each to its fp32 twin's line and no
    spill beyond the twin's."""
    import chip_smoke
    log = ("ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__f6fbb"
           "577_12_fft_lines_cu_208a4cd521fft_lines_bf16_kernelEPK13__nv_bflo"
           "at16S2_PS0_S3_xN5vkfft4PlanES5_PK6float2S8_S8_iiii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 64 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__ab5da29"
           "d_11_fft_pair_cu_208a4cd519fft_pair_f16_kernelEPK6__halfS2_PS0_S3"
           "_N5vkfft4PlanES5_S5_S5_PK6float2S8_S8_S8_S8_S8_NS_3GeoE' for "
           "'sm_90a'\n    8 bytes stack frame, 4 bytes spill stores, 4 bytes "
           "spill loads\nptxas info    : Used 64 registers, used 1 barriers, "
           "8 bytes cumulative stack size\n")
    rows = chip_smoke._ptxas_kernels(log)
    assert [r[0] for r in rows] == ["fft_lines_bf16_kernel",
                                    "fft_pair_f16_kernel"]
    lines = chip_smoke._ptxas_lines(log)
    assert chip_smoke._storage_ptxas_ok(lines) == {}
    bad = dict(lines, fft_lines_bf16_kernel=lines["fft_lines_bf16_kernel"]
               .replace("0 bytes spill stores", "8 bytes spill stores"))
    assert set(chip_smoke._storage_ptxas_ok(bad)) == {"fft_lines_bf16_kernel"}
    assert chip_smoke.STORAGE_TWINS["fft_pair_f16_kernel"] == "fft_pair_kernel"
    assert len(chip_smoke.STORAGE_TWINS) == 2 * len(ck.STORAGE_ENTRIES)
    assert {t for t in chip_smoke.STORAGE_TWINS.values()} == {
        f"{k}_kernel" for k in ck.STORAGE_ENTRIES}
