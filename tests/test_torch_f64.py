"""Native fp64 C2C on the port, on the CPU: `Precision.DOUBLE` routes
(`api.double_route`: the fp64 instantiations of `fft_lines`, `fft_strided`
and `fft_pair` where every transformed axis is theirs, the double-double
tier elsewhere) against the JAX package's jnp engine at complex128 (x64 is
on, tests/conftest.py) and numpy; each route's exact launches, counted by
the wrappers on meta tensors with the library call stubbed out; the fp64
layout rules and tables; `set_compute_mode`; and the precision flag of the
real kinds and of convolution, which run at the input's dtype as in the
JAX package.  The fp64 kernels themselves run only on the card
(chip_smoke.py's f64 phases)."""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

import vkfft_tpu as vk

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.planner.plan import plan_axis
from vkfft_tpu_torch.precision import dd_kernel
from vkfft_tpu_torch.precision.doubledouble import DDComplex

REF_TOL = 1e-13      # port vs the JAX package at complex128 (PERF.md §2)
NUMPY_TOL = 5e-14    # vs numpy fp64
F32_REF_TOL = 1e-5   # fp32 port vs the JAX package
F64 = torch.float64
# fft_lines' fp64 layout classes: a tensor op (n <= 4), one pass with many
# lines a block (16), a generic prime stage in one pass (47), radix 16 in
# one pass (256), two factors with generic stages (1001 = 7 * 11 * 13),
# two factors (1024, 4096), one line of two factors a block (8192)
LINES = (3, 16, 47, 256, 1001, 1024, 4096, 8192)


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _double(shape, **kw):
    return vt.FFTApplication(vt.FFTConfig(shape=shape,
                                          precision=vt.Precision.DOUBLE,
                                          **kw),
                             engine="cuda", device="cpu")


@pytest.mark.parametrize("n", LINES)
def test_lines_match_reference(n):
    """1-D lines through FFTApplication(DOUBLE) on the cuda engine (the fp64
    wrappers' plain versions on CPU tensors), both directions, normalized
    and not, against the JAX package at complex128 and numpy."""
    x = _cplx((2, n), n)
    ref = np.asarray(vk.fft(x, engine="jnp"))
    ref_inv = np.asarray(vk.ifft(x, engine="jnp"))
    assert ref.dtype == np.complex128
    want, want_inv = np.fft.fft(x), np.fft.ifft(x)
    for normalize in (True, False):
        app = _double((n,), normalize=normalize)
        assert app.double_route == "native"
        t = torch.from_numpy(x)
        y = app.forward(t)
        assert y.dtype == torch.complex128
        assert _rel(y, ref) <= REF_TOL and _rel(y, want) <= NUMPY_TOL
        z = app.inverse(t).numpy()
        scale = 1.0 if normalize else n
        assert _rel(z, ref_inv * scale) <= REF_TOL
        assert _rel(z, want_inv * scale) <= NUMPY_TOL
        h = app.forward(x)             # host complex128 in and out
        assert isinstance(h, np.ndarray) and h.dtype == np.complex128
        assert _rel(h, y.numpy()) == 0.0


@pytest.mark.parametrize("shape,axes", [((3, 64, 48), (1, 2)),
                                        ((2, 24, 32, 40), (1, 2, 3)),
                                        ((4, 16, 8), (0, 1))])
def test_pair_and_strided_match_reference(shape, axes):
    """A plane on `fft_pair` (64 x 48, both directions), a 3-D array whose
    leading axis runs `fft_strided` (24 x 32 x 40: the pair on the minor
    two), and a leading axis alone on `fft_strided` with its minor on
    `fft_lines` (16 x 8 of (4, 16, 8) over axes 0-1), float64 planes in and
    out, against the JAX package and numpy."""
    x = _cplx(shape, sum(shape))
    ref = np.asarray(vk.fftn(x, axes=axes, engine="jnp"))
    ref_inv = np.asarray(vk.ifftn(x, axes=axes, engine="jnp"))
    lead = min(axes)
    app = _double(shape[lead:], fft_axes=tuple(a - lead for a in axes),
                  normalize=True)
    assert app.double_route == "native"
    p = vt.from_numpy_planar(x.real.copy(), x.imag.copy())
    y = app.forward(p)
    assert isinstance(y, vt.Planar) and y.dtype == F64
    got = y.re.numpy() + 1j * y.im.numpy()
    assert _rel(got, ref) <= REF_TOL
    assert _rel(got, np.fft.fftn(x, axes=axes)) <= NUMPY_TOL
    z = app.inverse(p)
    got = z.re.numpy() + 1j * z.im.numpy()
    assert _rel(got, ref_inv) <= REF_TOL
    assert _rel(got, np.fft.ifftn(x, axes=axes)) <= NUMPY_TOL


def test_double_forms_and_routes():
    """The route is the config's, from its plans: covered lengths native,
    others (a Rader prime, a DIRECT length past fft_lines) the dd tier,
    each form coming back as it went in; DDComplex and float32 Planar stay
    on the dd tier; complex64 tensors widen to complex128."""
    assert vt.api.double_route(vt.FFTConfig(shape=(256,))) == "native"
    for shape in ((97,), (10240,), (8, 97)):
        assert vt.api.double_route(vt.FFTConfig(shape=shape)) == "dd"
    assert vt.api.double_route(vt.FFTConfig(shape=(8, 97),
                                            fft_axes=(0,))) == "native"
    x = _cplx((2, 97), 1)
    app = _double((97,), normalize=True)
    assert app.double_route == "dd"
    p = vt.from_numpy_planar(x.real.copy(), x.imag.copy())
    y = app.forward(p)
    assert isinstance(y, vt.Planar) and y.dtype == F64
    assert _rel(y.re.numpy() + 1j * y.im.numpy(), np.fft.fft(x)) <= NUMPY_TOL
    assert _rel(app.inverse(app.forward(x)), x) <= NUMPY_TOL
    native = _double((64,))
    t = native.forward(torch.from_numpy(_cplx((2, 64), 2).astype(np.complex64)))
    assert t.dtype == torch.complex128
    assert isinstance(native.forward(DDComplex.of(
        [torch.zeros(2, 64) for _ in range(4)])), DDComplex)
    assert isinstance(native.forward(vt.Planar(torch.zeros(2, 64),
                                               torch.zeros(2, 64))),
                      DDComplex)


def test_single_keeps_float64():
    """Under SINGLE, float64 planes keep their dtype: the fp64 route where
    it covers the axes (the plain versions here), item 10 elsewhere on
    the cuda engine; the torch engine takes any length."""
    x = _cplx((2, 8, 64), 3)
    t = torch.from_numpy(x)
    y = vt.fftn(t, engine="cuda")
    assert y.dtype == torch.complex128
    assert _rel(y, np.fft.fftn(x)) <= NUMPY_TOL
    r = torch.from_numpy(_cplx((2, 97), 4))
    with pytest.raises(NotImplementedError, match="item 10"):
        vt.fft(r, engine="cuda")
    assert _rel(vt.fft(r, engine="torch"), np.fft.fft(r.numpy())) <= NUMPY_TOL
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.fft_pair_p(vt.Planar(torch.zeros(2, 1024, 1024, dtype=F64),
                                         torch.zeros(2, 1024, 1024,
                                                     dtype=F64)), 1024, 1024)


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
    before = torch_engine.calls, dd_kernel.plain_calls
    yield calls
    assert (torch_engine.calls, dd_kernel.plain_calls) == before


def _meta(shape, dtype=F64):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


# (shape, fft launches of a forward and a normalized inverse)
F64_ROUTES = [((4, 256), {"fft_lines": 2}),
              ((2, 8192), {"fft_lines": 2}),
              ((2, 1001), {"fft_lines": 2}),
              ((3, 3), {}),                                  # tensor ops
              ((2, 256, 256), {"fft_pair": 2}),
              ((2, 16, 256, 256), {"fft_pair": 2, "fft_strided": 2}),
              ((2, 256, 512), {"fft_lines": 2, "fft_strided": 2}),
              ((2, 3, 96), {"fft_pair": 2})]


@pytest.mark.parametrize("shape,want", F64_ROUTES,
                         ids=["x".join(map(str, s)) for s, _ in F64_ROUTES])
def test_native_launches(monkeypatch, shape, want):
    """FFTApplication(DOUBLE) over every axis but the batch launches the
    fp64 instantiations only, exactly as the walk names them: the pair on
    the planes fp64 serves (256 x 256; 256 x 512 is fp32's only: two axis
    passes at fp64), fft_strided on the other axes, 1/N in the last."""
    app = vt.FFTApplication(vt.FFTConfig(shape=shape[1:],
                                         precision=vt.Precision.DOUBLE,
                                         normalize=True), engine="cuda")
    assert app.double_route == "native"
    assert ck.pair_cluster(256, 512) and not ck.pair_cluster(256, 512, F64)
    with _stubbed_launches(monkeypatch) as calls:
        y = app.inverse(app.forward(_meta(shape)))
        assert y.shape == shape and y.dtype == F64
    assert ck.f64_launches == {k: want.get(k, 0) for k in ck.F64_KERNELS}
    assert ck.launches == {k: 0 for k in ck.KERNEL_SOURCES}
    assert all(e.endswith("_f64") for e, _ in calls)
    assert len(calls) == sum(want.values())


@pytest.mark.parametrize("n,dd", [(97, 2), (10240, 2), (47, 0)])
def test_dd_launches(monkeypatch, n, dd):
    """DDComplex planes always run fft_dd; float64 planes of a length off
    the fp64 kernels run it too (97: Rader; 10240: fft_twofactor's), on a
    covered one (47) the fp64 lines."""
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,),
                                         precision=vt.Precision.DOUBLE,
                                         normalize=True), engine="cuda")
    quads = DDComplex.of([torch.empty(2, n, device="meta") for _ in range(4)])
    with _stubbed_launches(monkeypatch):
        app.inverse(app.forward(quads))
    assert ck.launches["fft_dd"] > 0 and sum(ck.f64_launches.values()) == 0
    with _stubbed_launches(monkeypatch):
        y = app.inverse(app.forward(_meta((2, n))))
        assert y.dtype == F64
    assert (ck.launches["fft_dd"] > 0) == (dd > 0)
    assert ck.f64_launches["fft_lines"] == (0 if dd else 2)
    # float32 Planar under DOUBLE: widened to the dd tier
    with _stubbed_launches(monkeypatch):
        y = app.forward(_meta((2, n), torch.float32))
        assert isinstance(y, DDComplex)
    assert ck.launches["fft_dd"] > 0 and sum(ck.f64_launches.values()) == 0


def test_single_launches(monkeypatch):
    """SINGLE on float64 planes: the fp64 kernels where they cover the
    axes, a refusal naming item 10 where they do not, before any launch."""
    with _stubbed_launches(monkeypatch):
        y = vt.fftn(_meta((2, 32, 256)), axes=(1, 2), engine="cuda")
        assert y.dtype == F64
    assert ck.f64_launches == {"fft_lines": 0, "fft_strided": 0,
                               "fft_pair": 1}
    with _stubbed_launches(monkeypatch) as calls:
        with pytest.raises(NotImplementedError, match="item 10"):
            vt.fft(_meta((2, 97)), engine="cuda")
        assert calls == []


def test_launch_arguments(monkeypatch):
    """The fp64 entries get float64 tables (the stage and twiddle tables
    not narrowed) and the layout of the rules at 16 B a point."""
    x = _meta((3, 1024))
    with _stubbed_launches(monkeypatch) as calls:
        ck.fft_lines(x.re, x.im, True, 0.5)
        s = _meta((2, 256, 40))
        ck.fft_strided(s.re, s.im)
        p = _meta((2, 256, 256))
        ck.fft_pair(p.re, p.im)
    entries = [e for e, _ in calls]
    assert entries == ["vk_fft_lines_f64", "vk_fft_strided_f64",
                       "vk_fft_pair_f64"]
    assert calls[0][1][-3:] == ck.lines_layout(1024, F64)
    assert calls[1][1][-3:] == ck.strided_layout(256, 40, F64)
    assert calls[2][1][-3:] == ck.pair_layout(256, 256, F64)
    tabs = [k for k, t in ck._DEVICE_TABLES.items()
            if k[-1] == "meta" and "torch.float64" in k]
    assert tabs and all(ck._DEVICE_TABLES[k].dtype == F64 for k in tabs)
    # the fp64 walk's plans: stage_radices', no radix 16
    stages = [k for k in tabs if k[0] == "stages"]
    assert stages and not any(k[4] for k in stages)
    assert 16 not in ck.stage_radices(256) and 16 in ck.walk_radices(256)


# ---------------------------------------------------------------------------
# Layout rules and tables (pure Python).
# ---------------------------------------------------------------------------

def _f64_rounds(split, threads):
    """The fp64 walk's rounds (one generic item, `stage_radices`)."""
    return all(ck.walk_rounds_fit(k, threads, False, ck.WALK_GENERIC_ITEMS_F64)
               for k in split)


def test_lines_layouts():
    """Every fft_lines length takes the fp64 kernel: fp32's threads and
    lines a block, at 16 B a point beside the fp64 walk's tables
    (`stage_radices`: no radix 16), at most 256 threads (kThreads64),
    within shared memory, every stage in a round of the fp64 walk."""
    for n in range(2, ck.KERNEL_MAX_N + 1):
        if not ck.kernel_supports(n):
            continue
        assert ck.kernel_supports(n, F64), n
        t32, l32, _ = ck.lines_layout(n)
        t, lines, b = ck.lines_layout(n, F64)
        n1, n2 = split = ck.lines_split(n, F64)
        assert (t, lines) == (t32, l32), n
        assert b == 16 * (lines * n2 * (n1 | 1) + ck._table_points(n1)
                          + ck._table_points(n2) + 64 + -(-n // 64)), n
        assert t <= ck.F64_THREADS["fft_lines"] and b <= ck.MAX_SMEM_BYTES
        assert _f64_rounds(split, t), n


@pytest.mark.parametrize("S", [1, 37, 4096])
def test_strided_layouts(S):
    """fft_strided's fp64 tile: within shared memory at 16 B a point, at
    most 512 threads, every stage in a round of the fp64 walk, and no more
    columns than the fp32 tile (16 at n = 256, 8 at 1024, 3 at 4096, 1 at
    8192 over wide S)."""
    for n in range(2, ck.KERNEL_MAX_N + 1, 7):
        if not ck.kernel_supports(n):
            continue
        ts, t, b = ck.strided_layout(n, S, F64)
        split = ck.strided_split(n, S, F64)
        assert 1 <= ts <= min(S, ck.strided_layout(n, S)[0]), (n, S)
        assert t <= ck.F64_THREADS["fft_strided"] and b <= ck.MAX_SMEM_BYTES
        assert _f64_rounds(split, t), (n, S)
        assert b == 16 * (ts * n + ck._strided_table_points(*split, False))
    if S == 4096:
        assert [ck.strided_layout(n, S, F64)[0] for n in (256, 1024, 4096,
                                                          8192)] == [16, 8,
                                                                     3, 1]


def test_pair_planes():
    """The planes fp64 `fft_pair` serves: those of fp32's gate at 32 B a
    point (256 x 256 among them, 256 x 512 not), each at fp32's cluster and
    threads (at most 256, 16 points a thread of an exchange), every stage
    in a round of the fp64 walk, at 16 B a point beside its tables."""
    served = 0
    for ny in range(2, 520, 3):
        for nz in (2, 12, 48, 60, 96, 256, 500, 512):
            c = ck.pair_cluster(ny, nz, F64)
            if c is None:
                continue
            served += 1
            assert ck.pair_cluster(ny, nz) is not None
            c32, t32, _ = ck.pair_layout(ny, nz)
            cl, t, b = ck.pair_layout(ny, nz, F64)
            splits = ck.pair_splits(ny, nz, F64)
            assert (cl, t) == (c32, t32), (ny, nz)
            assert t <= ck.F64_THREADS["fft_pair"]
            assert ny * nz // cl <= 16 * t and b <= ck.MAX_SMEM_BYTES
            assert all(_f64_rounds(sp, t) for sp in splits), (ny, nz)
            (n1z, n2z), _ = splits
            tabs = sum(ck._table_points(k) for sp in splits for k in sp)
            assert b == 16 * ((ny // cl) * n2z * (n1z | 1) + tabs + 128
                              + -(-nz // 64) + -(-ny // 64)), (ny, nz)
    assert served > 100
    assert ck.pair_cluster(256, 256, F64) == 16
    assert ck.pair_cluster(256, 512, F64) is None


def test_tables_in_fp64():
    """The fp64 kernels' tables carry the complex128 tables whole, where
    the fp32 ones round them."""
    dev = torch.device("cpu")
    for n in (7, 256, 1001):
        ints, tab = ck.stage_tables(n, True, 1.0, True)
        t64 = ck._device_table(n, True, 1.0, dev, True, F64)
        t32 = ck._device_table(n, True, 1.0, dev, True)
        assert ck.stage_tables(n, True, 1.0, False)[1].dtype == np.complex128
        assert t64.dtype == F64 and t32.dtype == torch.float32
        np.testing.assert_array_equal(t64.numpy()[:, 0], tab.real)
        np.testing.assert_array_equal(t64.numpy()[:, 1], tab.imag)
        assert np.abs(t32.numpy()[:, 0] - tab.real).max() > 0
    tw = ck.device_array(("twofactor_pair", 4096, False, 0.25), dev,
                         lambda: ck.twofactor_twiddle_pair(4096, False, 0.25),
                         F64)
    want = ck.twofactor_twiddle_pair(4096, False, 0.25)
    np.testing.assert_array_equal(tw.numpy()[:, 0] + 1j * tw.numpy()[:, 1],
                                  want)


def test_route_rule_is_the_axes():
    """`f64_supports` reads the plans alone: n <= 4, or DIRECT lengths of
    fft_lines' stages, on every transformed axis."""
    for n in list(range(1, 300)) + [1001, 4096, 8192, 8193, 10007, 10240]:
        plan = plan_axis(n)
        want = n <= 4 or (plan.algorithm.name == "DIRECT"
                          and ck.kernel_supports(n))
        assert cuda_engine.f64_axis_supports(plan) == want, n
        assert cuda_engine.f64_supports((5, n), (1,)) == want
    assert cuda_engine.f64_supports((97, 64), (1,))
    assert not cuda_engine.f64_supports((97, 64), (0, 1))


# ---------------------------------------------------------------------------
# set_compute_mode and the precision flag of the other kinds.
# ---------------------------------------------------------------------------

def test_set_compute_mode():
    """The JAX package's contract (tests/test_config_kinds.py): three
    modes, recorded process-wide, anything else a ValueError; every mode
    runs the fp32 kernels, so each gives the same result."""
    x = _cplx((2, 64), 5).astype(np.complex64)
    try:
        got = {}
        for mode in ("fp32_int8", "bf16", "fp32"):
            vt.set_compute_mode(mode)
            assert vt.get_compute_mode() == mode
            got[mode] = vt.fft(x, engine="cuda", device="cpu")
        with pytest.raises(ValueError):
            vt.set_compute_mode("nope")
        assert vt.get_compute_mode() == "fp32"
        for mode in got:
            np.testing.assert_array_equal(got[mode], got["fp32"])
        assert _rel(got["fp32"], np.fft.fft(x)) <= 3e-6
    finally:
        vt.set_compute_mode("fp32")


@pytest.mark.parametrize("precision", ["DOUBLE", "HALF", "BFLOAT16"])
def test_other_kinds_ignore_the_flag(precision):
    """R2C, DCT-II and a convolution under DOUBLE, HALF and BFLOAT16 run at
    the input's dtype, as the JAX package's `_real_transform` and
    `ConvolutionApplication` do: the same float32 results as the JAX
    package's on the same inputs; C2C under HALF and BFLOAT16 runs the
    storage tier (a Planar of the storage dtype out)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    for kind, kw in (("R2C", {}), ("DCT", {"rr_type": 2})):
        cfg = dict(shape=(64,), kind=kind, precision=precision, **kw)
        ref = vk.FFTApplication(vk.FFTConfig(**{
            **cfg, "kind": vk.TransformKind[kind],
            "precision": vk.Precision[precision]}), engine="jnp")
        app = vt.FFTApplication(vt.FFTConfig(**{
            **cfg, "kind": vt.TransformKind[kind],
            "precision": vt.Precision[precision]}), device="cpu")
        want = np.asarray(ref.forward(x))
        got = app.forward(x)
        assert got.dtype == want.dtype, kind
        assert _rel(got, want) <= F32_REF_TOL, kind
        back = app.inverse(got)
        assert _rel(back, np.asarray(ref.inverse(want))) <= F32_REF_TOL
    h = rng.standard_normal(16).astype(np.float32)
    data = (rng.standard_normal((2, 16))
            + 1j * rng.standard_normal((2, 16))).astype(np.complex64)
    jcfg = vk.FFTConfig(shape=(16,), convolution=True,
                        precision=vk.Precision[precision])
    ref_app = vk.ConvolutionApplication(jcfg, h, engine="jnp")
    want = np.asarray(ref_app(data))
    port = vt.convolution_from_reference(
        dataclasses.asdict(jcfg), np.asarray(ref_app.kernel_f.re),
        np.asarray(ref_app.kernel_f.im), device="cpu")
    assert port.config.precision is vt.Precision[precision]
    got = np.asarray(port(data))
    assert _rel(got, want) <= F32_REF_TOL
    if precision != "DOUBLE":
        y = vt.FFTApplication(vt.FFTConfig(
            shape=(16,), precision=vt.Precision[precision]),
            device="cpu").forward(vt.from_numpy_planar(
                data.real.astype(np.float32), data.imag.astype(np.float32)))
        assert isinstance(y, vt.Planar)
        assert y.dtype == vt.api.STORAGE[vt.Precision[precision]]


def test_ptxas_pin_parser():
    """chip_smoke's toolchain phase reads each kernel's ptxas line (stack
    frame, spills, registers) to hold every fp32 kernel to FP32_PTXAS and
    every fp64 instantiation to no spill; the pin names every fp32 kernel
    of the walk."""
    import chip_smoke
    log = ("ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__820"
           "3c8b8_12_fft_lines_cu_208a4cd520fft_lines_f64_kernelEPKdS1_PdS2_x"
           "N5vkfft4PlanES4_PK7double2S7_S7_iiii' for 'sm_90a'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 122 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__820"
           "3c8b8_12_fft_lines_cu_208a4cd516fft_lines_kernelEPKfS1_PfS2_x"
           "N5vkfft4PlanES4_PK6float2S7_S7_iiii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 64 registers, used 1 barriers\n")
    lines = chip_smoke._ptxas_lines(log)
    assert set(lines) == {"fft_lines_f64_kernel", "fft_lines_kernel"}
    assert lines["fft_lines_kernel"] == chip_smoke.FP32_PTXAS["fft_lines_kernel"]
    assert chip_smoke._ptxas_kernels(log)[0] == ("fft_lines_f64_kernel", 122,
                                                 0, 0)
    assert {"fft_lines_kernel", "fft_strided_kernel", "fft_pair_kernel",
            "fft_twofactor_kernel", "fft_conv2d_kernel"} <= set(
                chip_smoke.FP32_PTXAS)
