"""keep_intermediate_order in the torch port against the JAX package.

The port's forward on the cuda engine's routing (CPU planes: the kernels'
plain versions) against the JAX package's Pallas tl kernels in interpret
mode (``pallas_engine.set_interpret(True)``, as ``tests/test_planar.py``
runs them): the 1-D `TlSpectrum` of `fft_lines`' lengths decoded to
natural order, the v2 lengths' swapped `Planar` elementwise (where the
port's own two-factor split differs too), the 2-D pair's transposed
planes elementwise; the round trips, the contract riding the value, the
cases that ignore the flag, the bf16 tier, the gates beside the
reference's, and each route's exact launches on meta tensors.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine
from vkfft_tpu.pcomplex import TlSpectrum as JTlSpectrum

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels as ck, torch_engine
from vkfft_tpu_torch.planner import plan_axis
from vkfft_tpu_torch.planner.factorize import Algorithm

REF_TOL = 1e-5      # vs the JAX package's kernels
NUMPY_TOL = 5e-6    # vs numpy fp64
BF16_TOL = 1.6e-2   # 4 bf16 ulps of max|ref|


@pytest.fixture
def interpret():
    pallas_engine.set_interpret(True)
    try:
        yield
    finally:
        pallas_engine.set_interpret(False)


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _c(p):
    return (np.asarray(p.re.float() if isinstance(p.re, torch.Tensor)
                       else p.re, np.float64)
            + 1j * np.asarray(p.im.float() if isinstance(p.im, torch.Tensor)
                              else p.im, np.float64))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _apps(shape, **kw):
    """The port's app on the cuda engine's routing and the JAX package's on
    its pallas engine, of one config."""
    cfg = dict(shape=shape, normalize=True, keep_intermediate_order=True,
               **kw)
    return (vt.FFTApplication(vt.FFTConfig(**cfg), engine="cuda",
                              device="cpu"),
            vk.FFTApplication(vk.FFTConfig(**cfg), engine="pallas"))


def _inputs(re, im):
    return (vt.from_numpy_planar(re, im),
            vk.Planar(jnp.asarray(re), jnp.asarray(im)))


def _jax_tl_natural(Y, B):
    """The JAX package's 1-D TlSpectrum (steps, n, gb) as (B, n) natural
    lines (``tests/test_planar.py:101-109``)."""
    sw = _c(Y)
    steps, n, gb = sw.shape
    return np.moveaxis(sw, 1, 2).reshape(steps * gb, n)[:B]


@pytest.mark.parametrize("n,split", [(256, (256, 1)), (4096, (256, 16)),
                                     (8192, (128, 64))])
def test_tl_lines_match_reference(interpret, n, split):
    """fft_lines' lengths: a TlSpectrum of (B, n) lines in the swapped
    digit order of lines_split (natural at one pass), its contents the
    JAX package's TlSpectrum decoded its own way; the round trip gives the
    input back, in the JAX package too."""
    B = 3
    app, ref = _apps((n,))
    re, im = _data((B, n), n)
    x, xr = _inputs(re, im)
    Y, Yr = app.forward(x), ref.forward(xr)
    assert isinstance(Y, vt.TlSpectrum) and isinstance(Yr, JTlSpectrum)
    assert Y.shape == (B, n) and (Y.n, Y.n2, Y.split) == (n, 0, split)
    assert ck.lines_split(n) == split
    want = _jax_tl_natural(Yr, B)
    assert _rel(_c(Y.natural()), want) <= REF_TOL
    assert _rel(_c(Y.natural()), np.fft.fft(_c(x))) <= NUMPY_TOL
    # the planes themselves: the swapped order of split
    n1, n2 = split
    assert _rel(_c(Y), want.reshape(B, n1, n2).swapaxes(1, 2).reshape(B, n)) \
        <= REF_TOL
    z = app.inverse(Y)
    assert type(z) is vt.Planar and z.shape == (B, n)
    assert _rel(_c(z), _c(x)) <= NUMPY_TOL
    assert _rel(_c(z), _c(ref.inverse(Yr))) <= REF_TOL


@pytest.mark.parametrize("n", [134, 8320, 8208])
def test_v2_swapped_matches_reference(interpret, n):
    """The v2 lengths (fft_twofactor's): a plain Planar in the swapped
    order of split_lane_major both ways, elementwise the JAX package's, at
    8208 and 8320 too, where the port's own twofactor_split picks other
    factors."""
    B = 2
    app, ref = _apps((n,))
    re, im = _data((B, n), n)
    x, xr = _inputs(re, im)
    Y, Yr = app.forward(x), ref.forward(xr)
    assert type(Y) is vt.Planar and type(Yr) is vk.Planar
    assert _rel(_c(Y), _c(Yr)) <= REF_TOL
    n1, n2 = ck.split_lane_major(n)
    assert (n1, n2) == pallas_engine.split_lane_major(n)
    if n != 134:
        assert ck.twofactor_split(n) != (n1, n2)
    nat = np.fft.fft(_c(x))
    assert _rel(_c(Y), nat.reshape(B, n1, n2).swapaxes(1, 2).reshape(B, n)) \
        <= NUMPY_TOL
    # the inverse reads that order
    z, zr = app.inverse(Y), ref.inverse(Yr)
    assert _rel(_c(z), _c(zr)) <= REF_TOL
    assert _rel(_c(z), _c(x)) <= NUMPY_TOL


def test_tl_pair_matches_reference(interpret):
    """The 2-D pair: a TlSpectrum of (..., nz, ny) transposed planes,
    elementwise fft_pair_tl_planar's, the natural 2-D spectrum; a fresh
    application inverts it."""
    ny, nz = 128, 256
    app, ref = _apps((ny, nz))
    re, im = _data((2, ny, nz), 3)
    x, xr = _inputs(re, im)
    Y, Yr = app.forward(x), ref.forward(xr)
    assert isinstance(Y, vt.TlSpectrum) and isinstance(Yr, JTlSpectrum)
    assert Y.shape == Yr.shape == (2, nz, ny)
    assert (Y.n, Y.n2, Y.lead, Y.batch) == (ny, nz, (2,), 2)
    assert _rel(_c(Y), _c(Yr)) <= REF_TOL
    assert _rel(_c(Y.natural()), np.fft.fft2(_c(x))) <= NUMPY_TOL
    app2 = vt.FFTApplication(app.config, engine="cuda", device="cpu")
    z = app2.inverse(Y)
    assert z.shape == (2, ny, nz)
    assert _rel(_c(z), _c(x)) <= NUMPY_TOL
    assert _rel(_c(z), _c(ref.inverse(Yr))) <= REF_TOL


def test_tl_pair_two_factor_axis():
    """A pair with an axis on two factors (pair_splits) keeps each axis in
    natural order inside the transposed plane."""
    ny, nz = 2, 8064
    assert ck.pair_splits(ny, nz)[0][1] > 1
    app = vt.FFTApplication(vt.FFTConfig(shape=(ny, nz), normalize=True,
                                         keep_intermediate_order=True),
                            engine="cuda", device="cpu")
    x = vt.from_numpy_planar(*_data((3, ny, nz), 5))
    Y = app.forward(x)
    assert isinstance(Y, vt.TlSpectrum) and Y.shape == (3, nz, ny)
    assert _rel(np.swapaxes(_c(Y), -1, -2), np.fft.fft2(_c(x))) <= NUMPY_TOL
    assert _rel(_c(app.inverse(Y)), _c(x)) <= NUMPY_TOL


def test_tl_no_shape_collision(interpret):
    """Batches 100 and 128 each round-trip to their own batch
    (``tests/test_planar.py:121-146``): the contract rides the value."""
    n = 256
    app, _ = _apps((n,))
    xa = vt.from_numpy_planar(*_data((100, n), 1))
    xb = vt.from_numpy_planar(*_data((128, n), 2))
    Ya, Yb = app.forward(xa), app.forward(xb)
    assert isinstance(Ya, vt.TlSpectrum) and isinstance(Yb, vt.TlSpectrum)
    za, zb = app.inverse(Ya), app.inverse(Yb)
    assert za.shape == (100, n) and zb.shape == (128, n)
    assert _rel(_c(za), _c(xa)) <= NUMPY_TOL
    assert _rel(_c(zb), _c(xb)) <= NUMPY_TOL


def test_tl_contract_rides_the_value():
    """A fresh application of the same config inverts a TlSpectrum, leading
    dims and all; a mismatched config raises InvalidConfigError, 1-D and
    pair alike."""
    n = 4096
    cfg = vt.FFTConfig(shape=(n,), normalize=True,
                       keep_intermediate_order=True)
    x = vt.from_numpy_planar(*_data((2, 3, n), 7))
    Y = vt.FFTApplication(cfg, engine="cuda", device="cpu").forward(x)
    assert Y.lead == (2, 3) and Y.batch == 6 and Y.shape == (2, 3, n)
    z = vt.FFTApplication(cfg, engine="cuda", device="cpu").inverse(Y)
    assert z.shape == (2, 3, n) and _rel(_c(z), _c(x)) <= NUMPY_TOL
    # any engine's application of the config: the planes pick the routes
    z = vt.FFTApplication(cfg, engine="torch").inverse(Y)
    assert _rel(_c(z), _c(x)) <= NUMPY_TOL
    for other in (vt.FFTConfig(shape=(512,), normalize=True),
                  vt.FFTConfig(shape=(4, n), normalize=True),
                  vt.FFTConfig(shape=(n, 4), normalize=True)):
        with pytest.raises(InvalidConfigError):
            vt.FFTApplication(other, engine="cuda").inverse(Y)
    # the minor axis of an N-D config: the reference's inverse refuses its
    # own TlSpectrum there (vkfft_tpu/api.py:379-383); the port's takes it
    nd = vt.FFTConfig(shape=(3, 256), fft_axes=(1,), normalize=True,
                      keep_intermediate_order=True)
    x2 = vt.from_numpy_planar(*_data((2, 3, 256), 17))
    Y2 = vt.FFTApplication(nd, engine="cuda").forward(x2)
    assert isinstance(Y2, vt.TlSpectrum) and Y2.lead == (2, 3)
    assert _rel(_c(vt.FFTApplication(nd, engine="cuda").inverse(Y2)),
                _c(x2)) <= NUMPY_TOL
    P = vt.FFTApplication(vt.FFTConfig(shape=(128, 256),
                                       keep_intermediate_order=True),
                          engine="cuda").forward(
        vt.from_numpy_planar(*_data((128, 256), 8)))
    assert isinstance(P, vt.TlSpectrum) and P.lead == ()
    for other in (vt.FFTConfig(shape=(256, 128)), vt.FFTConfig(shape=(256,))):
        with pytest.raises(InvalidConfigError):
            vt.FFTApplication(other, engine="cuda").inverse(P)


def test_tl_arithmetic_keeps_the_wrapper():
    """+, -, *, conj and a scalar keep the wrapper and its contract, so a
    spectrum-domain product in the same layout inverts."""
    n = 1024
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True,
                                         keep_intermediate_order=True),
                            engine="cuda", device="cpu")
    x = vt.from_numpy_planar(*_data((2, n), 9))
    h = vt.from_numpy_planar(*_data((1, n), 10))
    Y, H = app.forward(x), app.forward(h)
    for v in (Y + H, Y - H, Y * H, Y.conj(), 2.0 * Y, Y * 0.5):
        assert isinstance(v, vt.TlSpectrum)
        assert (v.lead, v.batch, v.n, v.split) == (Y.lead, Y.batch, n,
                                                   Y.split)
    # circular convolution in the kept order
    got = _c(app.inverse(Y * H))
    want = np.fft.ifft(np.fft.fft(_c(x)) * np.fft.fft(_c(h)))
    assert _rel(got, want) <= NUMPY_TOL


def _ref_natural(cfg_kw, x):
    """The JAX package's natural forward of a config without the flag."""
    app = vk.FFTApplication(vk.FFTConfig(**cfg_kw), engine="pallas")
    return _c(app.forward(vk.Planar(jnp.asarray(x.re.numpy()),
                                    jnp.asarray(x.im.numpy()))))


def test_ignored_cases(interpret):
    """Where the flag is ignored each case returns the natural result, as
    the JAX package's: the torch engine, a complex tensor, DOUBLE, R2C,
    DCT, a convolution, a windowed config, a length off both routes."""
    n = 256
    x = vt.from_numpy_planar(*_data((2, n), 11))
    nat = np.fft.fft(_c(x))
    flag = dict(keep_intermediate_order=True)
    y = vt.FFTApplication(vt.FFTConfig(shape=(n,), **flag),
                          engine="torch").forward(x)
    assert type(y) is vt.Planar and _rel(_c(y), nat) <= NUMPY_TOL
    t = torch.complex(x.re, x.im)
    y = vt.FFTApplication(vt.FFTConfig(shape=(n,), **flag),
                          engine="cuda").forward(t)
    assert torch.is_tensor(y) and _rel(y.numpy(), nat) <= NUMPY_TOL
    y = vt.FFTApplication(vt.FFTConfig(shape=(n,), precision=vt.Precision
                                       .DOUBLE, **flag),
                          engine="cuda").forward(t)
    assert y.dtype == torch.complex128 and _rel(y.numpy(), nat) <= 1e-6
    ref = vk.FFTApplication(vk.FFTConfig(shape=(n,), kind=vk.TransformKind
                                         .R2C, **flag), engine="pallas")
    y = vt.FFTApplication(vt.FFTConfig(shape=(n,), kind=vt.TransformKind.R2C,
                                       **flag), engine="cuda").forward(x.re)
    yr = ref.forward(jnp.asarray(x.re.numpy()))
    assert _rel(_c(y) if isinstance(y, vt.Planar) else y.numpy(),
                _c(yr) if isinstance(yr, vk.Planar) else np.asarray(yr)) \
        <= REF_TOL
    y = vt.FFTApplication(vt.FFTConfig(shape=(n,), kind=vt.TransformKind.DCT,
                                       rr_type=2, **flag),
                          engine="cuda").forward(x.re)
    yr = vk.FFTApplication(vk.FFTConfig(shape=(n,), kind=vk.TransformKind.DCT,
                                        rr_type=2, **flag),
                           engine="pallas").forward(jnp.asarray(x.re.numpy()))
    assert _rel(y.numpy(), np.asarray(yr)) <= REF_TOL
    # a convolution ignores the flag (its fused mode and values unchanged)
    h = vt.from_numpy_planar(*_data((n,), 12))
    conv = vt.ConvolutionApplication(
        vt.FFTConfig(shape=(n,), convolution=True, **flag), h, engine="cuda",
        device="cpu")
    assert conv.fusion_mode == "v3_1d"
    want = np.fft.ifft(nat * np.fft.fft(_c(h)))
    assert _rel(_c(conv(x)), want) <= NUMPY_TOL
    # a windowed config: natural, the reference's values
    win = dict(shape=(n,), zeropad_input=((0, 100),))
    y = vt.FFTApplication(vt.FFTConfig(**win, **flag),
                          engine="cuda").forward(x)
    assert type(y) is vt.Planar
    assert _rel(_c(y), _ref_natural(dict(**win, **flag), x)) <= REF_TOL
    # off both routes (Rader 257; a length JAX's v2 does not take): natural
    for m in (257, 8215):
        xm = vt.from_numpy_planar(*_data((2, m), m))
        y = vt.FFTApplication(vt.FFTConfig(shape=(m,), **flag),
                              engine="cuda").forward(xm)
        assert type(y) is vt.Planar
        assert _rel(_c(y), np.fft.fft(_c(xm))) <= NUMPY_TOL
    # a non-minor axis: natural
    y = vt.FFTApplication(vt.FFTConfig(shape=(16, 32), fft_axes=(0,), **flag),
                          engine="cuda").forward(
        vt.from_numpy_planar(*_data((16, 32), 13)))
    assert type(y) is vt.Planar


@pytest.mark.parametrize("n", [256, 4096])
def test_bf16_tier_matches_reference(interpret, n):
    """Under BFLOAT16 the flag runs on bf16 planes (the JAX package narrows
    before its tl branch): within 4 storage ulps of the reference."""
    B = 2
    app = vt.FFTApplication(vt.FFTConfig(
        shape=(n,), normalize=True, keep_intermediate_order=True,
        precision=vt.Precision.BFLOAT16), engine="cuda", device="cpu")
    ref = vk.FFTApplication(vk.FFTConfig(
        shape=(n,), normalize=True, keep_intermediate_order=True,
        precision=vk.Precision.BFLOAT16), engine="pallas")
    re, im = _data((B, n), 20 + n)
    x, xr = _inputs(re, im)
    Y, Yr = app.forward(x), ref.forward(xr)
    assert isinstance(Y, vt.TlSpectrum) and Y.dtype == torch.bfloat16
    assert _rel(_c(Y.natural()), _jax_tl_natural(Yr, B)) <= BF16_TOL
    z = app.inverse(Y)
    assert z.dtype == torch.bfloat16
    assert _rel(_c(z), _c(ref.inverse(Yr))) <= BF16_TOL


def test_gates_match_the_reference():
    """keep_order_kernel's forms are the JAX package's branches at every
    DIRECT length 2..16384: fft_lines (and 2..4) where it runs its v3 tl
    form, fft_twofactor where its v2 kernel runs; the port's own copy of
    split_lane_major is the reference's at every length."""
    for n in range(2, 16385):
        assert ck.split_lane_major(n) == pallas_engine.split_lane_major(n), n
        plan = plan_axis(n)
        if plan.algorithm is not Algorithm.DIRECT:
            continue
        kernel = cuda_engine.keep_order_kernel(plan)
        v3 = pallas_engine._use_v3(n)
        v2 = pallas_engine._use_v2(n) and not v3
        assert (kernel in ("tiny", "fft_lines")) == v3, n
        assert (kernel == "fft_twofactor") == v2, n
    differ = [n for n in range(2, 16385)
              if cuda_engine.keep_order_kernel(plan_axis(n)) == "fft_twofactor"
              and ck.twofactor_split(n) != ck.split_lane_major(n)]
    assert len(differ) == 121 and differ[:2] == [8208, 8250]


def test_pair_gate_differences():
    """The port's pair_supports against the reference's pair_available on
    the planes the tests and the smoke run use: each package follows its
    own gate (the port takes planes of any DIRECT lengths a cluster holds;
    the reference wants 128-multiples)."""
    for ny, nz in ((128, 256), (256, 256)):
        assert cuda_engine.pair_supports(ny, nz)
        assert pallas_engine.pair_available(ny, nz)
    for ny, nz in ((2, 8064), (64, 64), (48, 60)):
        assert cuda_engine.pair_supports(ny, nz)
        assert not pallas_engine.pair_available(ny, nz)


# ---------------------------------------------------------------------------
# Launches on meta tensors (the C library stubbed out).
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _stubbed(monkeypatch):
    """The wrappers' CUDA branch on meta tensors: every launch recorded by
    its C entry; no plain version and no plain-engine call may run."""
    log = []
    real_launch = ck._launch

    def launch(name, entry, device, args, dtype=torch.float32):
        log.append(entry)
        return real_launch(name, entry, device, args, dtype)

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(ck, "_library", lambda name: Lib())
    monkeypatch.setattr(ck, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device=None: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*args, **kw):
        raise AssertionError("a plain version ran on meta planes")

    for name in ("fft_lines_plain", "fft_twofactor_plain", "fft_pair_plain"):
        monkeypatch.setattr(ck, name, no_plain)
    ck.reset_launches()
    before = torch_engine.calls
    yield log
    assert torch_engine.calls == before


def _meta(shape, dtype=torch.float32):
    return vt.Planar(torch.empty(shape, dtype=dtype, device="meta"),
                     torch.empty(shape, dtype=dtype, device="meta"))


@pytest.mark.parametrize("shape,dtype,want", [
    ((4096,), torch.float32, ["fft_lines_tl", "fft_lines_tl"]),
    ((256,), torch.float32, ["fft_lines_tl", "fft_lines_tl"]),
    ((4096,), torch.bfloat16, ["fft_lines_tl_bf16", "fft_lines_tl_bf16"]),
    ((10240,), torch.float32, ["fft_twofactor", "fft_twofactor"]),
    ((8208,), torch.float16, ["fft_twofactor_f16", "fft_twofactor_f16"]),
    ((256, 256), torch.float32, ["fft_pair_tl", "fft_pair_tl"]),
    ((128, 256), torch.float16, ["fft_pair_tl_f16", "fft_pair_tl_f16"]),
])
def test_round_trip_launches(monkeypatch, shape, dtype, want):
    """A kept-order round trip is two launches of its kernel's tl entry (or
    two swapped fft_twofactor launches at split_lane_major), nothing else:
    no reorder op, no natural launch."""
    prec = {torch.float32: vt.Precision.SINGLE,
            torch.bfloat16: vt.Precision.BFLOAT16,
            torch.float16: vt.Precision.HALF}[dtype]
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True,
                                         precision=prec,
                                         keep_intermediate_order=True),
                            engine="cuda")
    with _stubbed(monkeypatch) as log:
        x = _meta((3,) + shape)
        Y = app.forward(x)
        z = app.inverse(Y)
    assert log == want
    assert z.shape == (3,) + shape and z.dtype == dtype
    tl = {k: v for k, v in ck.tl_launches.items() if v}
    if want[0].startswith("fft_twofactor"):
        assert tl == {}
    else:
        assert tl == {want[0]: 2}
        assert sum(ck.launches.values()) == 0
        assert sum(ck.storage_launches.values()) == 0
