"""The torch port's FFTApplication and functional API against the JAX
package's (jnp engine, and one pallas case in interpret mode) and numpy,
plus the port's device rules, the CUDA route's refusals and the long
tier's lengths that it once refused."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vkfft_tpu as vk
from vkfft_tpu.ops import pallas_engine

import vkfft_tpu_torch as vt
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.ops import cuda_engine, cuda_kernels, torch_engine
from vkfft_tpu_torch.planner import plan_axis

NUMPY_TOL = 5e-6
REF_TOL = 1e-5


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _c(p):
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


def _numpy_fftn(x, axes, inverse, normalize):
    y = np.fft.ifftn(x, axes=axes) if inverse else np.fft.fftn(x, axes=axes)
    if inverse and not normalize:
        y = y * np.prod([x.shape[a] for a in axes])
    return y


def _compare_apps(shape, axes, normalize, ref_engine):
    ref_cfg = vk.FFTConfig(shape=shape, fft_axes=axes, normalize=normalize)
    cfg = vt.config_from_reference(dataclasses.asdict(ref_cfg))
    ref_app = vk.FFTApplication(ref_cfg, engine=ref_engine)
    app = vt.FFTApplication(cfg, device="cpu")
    re, im = _planes(shape, seed=sum(shape) + len(ref_cfg.axes))
    x = vt.from_numpy_planar(re, im)
    xr = vk.Planar(jnp.asarray(re), jnp.asarray(im))
    x64 = re.astype(np.float64) + 1j * im
    axes_ = ref_cfg.axes
    y = app.forward(x)
    yr = ref_app.forward(xr)
    assert isinstance(y, vt.Planar) and y.shape == shape
    assert _rel(_c(y), _c(yr)) <= REF_TOL
    assert _rel(_c(y), _numpy_fftn(x64, axes_, False, normalize)) <= NUMPY_TOL
    z = app.inverse(x)
    zr = ref_app.inverse(xr)
    assert _rel(_c(z), _c(zr)) <= REF_TOL
    assert _rel(_c(z), _numpy_fftn(x64, axes_, True, normalize)) <= NUMPY_TOL
    back = app.inverse(y)
    if normalize:
        assert _rel(_c(back), x64) <= NUMPY_TOL


@pytest.mark.parametrize("shape,axes", [
    ((4, 1024), None), ((4, 1024), (1,)),
    ((8, 12, 16), None), ((8, 12, 16), (0, 2)), ((8, 12, 16), (1,)),
    ((16, 16, 16), None), ((16, 16, 16), (0, 1)), ((16, 16, 16), (2,)),
])
@pytest.mark.parametrize("normalize", [False, True])
def test_application_matches_reference_jnp(shape, axes, normalize):
    _compare_apps(shape, axes, normalize, "jnp")


def test_application_matches_reference_pallas_interpret():
    pallas_engine.set_interpret(True)
    try:
        _compare_apps((16, 16, 16), None, True, "pallas")
    finally:
        pallas_engine.set_interpret(False)


@pytest.mark.parametrize("fn,ref_fn,axes_kw", [
    ("fft", np.fft.fft, {}), ("ifft", np.fft.ifft, {}),
    ("fft2", np.fft.fft2, {}), ("ifft2", np.fft.ifft2, {}),
    ("fftn", np.fft.fftn, {}), ("ifftn", np.fft.ifftn, {}),
    ("fftn", np.fft.fftn, {"axes": (0, 2)}),
])
def test_functional_api(fn, ref_fn, axes_kw):
    re, im = _planes((6, 10, 16), seed=11)
    x = (re + 1j * im).astype(np.complex64)
    got = getattr(vt, fn)(x, device="cpu", **axes_kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    want = ref_fn(x.astype(np.complex128), **axes_kw)
    assert _rel(got, want) <= NUMPY_TOL
    ref = np.asarray(getattr(vk, fn)(x, **axes_kw))
    assert _rel(got, ref) <= REF_TOL


@pytest.mark.parametrize("fn", ["fftn", "ifftn", "fft2", "ifft2"])
@pytest.mark.parametrize("engine", [None, "torch", "cuda"])
def test_empty_axes_return_the_input(fn, engine):
    """numpy's fftn over no axes is the input: host arrays come back as a
    complex array of the same values, tensors as a complex tensor, a
    Planar as itself, on every engine (once a bare ValueError of
    min(()))."""
    re, im = _planes((3, 4, 5), seed=11)
    x = re + 1j * im
    f = getattr(vt, fn)
    want = getattr(np.fft, "ifftn" if fn.startswith("i") else "fftn")(
        x, axes=())
    got = f(x, axes=(), engine=engine, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == x.shape
    np.testing.assert_array_equal(got, want.astype(np.complex64))
    t = torch.from_numpy(x.astype(np.complex64))
    assert torch.equal(f(t, axes=(), engine=engine), t)
    p = vt.from_complex(t)
    assert f(p, axes=(), engine=engine) is p


def test_torch_tensor_input_gives_tensor():
    re, im = _planes((3, 32), seed=12)
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    y = vt.fft(x)
    assert isinstance(y, torch.Tensor) and y.is_complex()
    assert _rel(y.numpy(), np.fft.fft(re + 1j * im.astype(np.float64))) <= NUMPY_TOL
    assert _rel(vt.ifft(y).numpy(), re + 1j * im.astype(np.float64)) <= NUMPY_TOL


def test_host_array_without_cpu_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.ones((2, 8), np.complex64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vt.fft(x)
    app = vt.FFTApplication(vt.FFTConfig(shape=(8,)))
    with pytest.raises(RuntimeError):
        app.forward(x)
    assert _rel(vt.fft(x, device="cpu"), np.fft.fft(x)) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(4, 256), (6, 8, 5), (3, 131), (2, 263, 4),
                                   (393,)])
def test_cpu_routes_reach_torch_engine(shape):
    re, im = _planes(shape, seed=13)
    x = vt.from_numpy_planar(re, im)
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True),
                            device="cpu")
    calls, launches = torch_engine.calls, dict(cuda_kernels.launches)
    y = app.inverse(app.forward(x))
    assert torch_engine.calls > calls
    assert cuda_kernels.launches == launches
    assert _rel(_c(y), re + 1j * im.astype(np.float64)) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(4, 256), (6, 8, 5), (2, 3, 4, 60),
                                   (5, 1, 7)])
def test_cuda_engine_route_on_cpu_planes_runs_plain_kernels(shape):
    """engine='cuda' on CPU planes goes through the kernels' wrappers, which
    take their plain versions for CPU tensors."""
    re, im = _planes(shape, seed=14)
    x = vt.from_numpy_planar(re, im)
    app = vt.FFTApplication(vt.FFTConfig(shape=shape, normalize=True),
                            engine="cuda")
    calls, launches = torch_engine.calls, dict(cuda_kernels.launches)
    y = app.forward(x)
    z = app.inverse(y)
    assert torch_engine.calls == calls
    assert cuda_kernels.launches == launches
    x64 = re.astype(np.float64) + 1j * im
    assert _rel(_c(y), np.fft.fftn(x64)) <= NUMPY_TOL
    assert _rel(_c(z), x64) <= NUMPY_TOL


@pytest.mark.parametrize("shape,axes,pair", [
    ((3, 16, 16), None, True), ((2, 4, 8, 12), (1, 2, 3), True),
    ((2, 4, 8, 12), (2, 3), True), ((2, 4, 8, 12), (1, 2), False),
    ((4, 1024), None, True), ((4, 1024), (1,), False),
    ((2, 1, 64), (1, 2), False),
    ((2, 512, 512), (1, 2), False),
])
def test_cuda_route_pair_kernel_on_minor_axes(monkeypatch, shape, axes, pair):
    """The CUDA engine runs the two minor axes as one fft_pair pass when
    both are transformed and the plane fits a cluster; the result matches
    numpy either way."""
    seen = []
    real = cuda_kernels.fft_pair

    def spy(re, im, inverse=False, scale=1.0, out=None):
        seen.append((tuple(re.shape), inverse, scale))
        return real(re, im, inverse, scale, out)

    monkeypatch.setattr(cuda_kernels, "fft_pair", spy)
    re, im = _planes(shape, seed=18)
    x64 = re.astype(np.float64) + 1j * im
    x = vt.from_numpy_planar(re, im)
    y = vt.fftn(x, axes=axes, engine="cuda")
    z = vt.ifftn(y, axes=axes, engine="cuda")
    ax = tuple(range(len(shape))) if axes is None else axes
    assert _rel(_c(y), np.fft.fftn(x64, axes=ax)) <= NUMPY_TOL
    assert _rel(_c(z), x64) <= NUMPY_TOL
    assert bool(seen) == pair
    if pair:
        ny, nz = shape[-2:]
        # forward first, unscaled; inverse last, carrying the 1/N
        assert seen[0][1:] == (False, 1.0) and seen[-1][1] is True
        assert seen[-1][2] == pytest.approx(1.0 / math.prod(
            shape[a] for a in ax))
        assert seen[0][0][-2:] == (ny, nz)


@pytest.mark.parametrize("shape,axes", [
    ((2, 1, 64), (1, 2)), ((3, 5, 1, 16), None), ((1, 8), None),
    ((4, 6, 1), None), ((2, 8, 12), None),
])
def test_cuda_route_leaves_input_unchanged(shape, axes):
    """Passes after the first write in place only over planes the walk made
    itself: a length-1 axis that hands back the caller's planes must not
    let the next pass overwrite them."""
    re, im = _planes(shape, seed=19)
    x = vt.from_numpy_planar(re.copy(), im.copy())
    for fn in (vt.fftn, vt.ifftn):
        y = fn(x, axes=axes, engine="cuda")
        np.testing.assert_array_equal(x.re.numpy(), re)
        np.testing.assert_array_equal(x.im.numpy(), im)
        z = fn(y, axes=axes, engine="cuda")
        assert z.shape == shape


# DIRECT lengths above 16384 and Bluestein lengths padded beyond 2^16: the
# long tier, which the CUDA engine once refused and now runs
@pytest.mark.parametrize("n", [16400, 20480, 32768, 32771, 65537, 99991])
def test_cuda_route_refuses_plans_outside_the_slice(n):
    """Each long-tier length through FFTApplication(engine="cuda") and the
    functional API on CPU planes (the wrappers' plain versions): within
    1e-5 of the JAX package's jnp engine and 5e-6 of numpy, both ways,
    with no call of the plain engine; a non-minor axis of that length runs
    moved last."""
    re, im = _planes((2, n), seed=15)
    x64 = re.astype(np.float64) + 1j * im
    assert cuda_engine.supports(plan_axis(n))
    assert cuda_engine.route(plan_axis(n))[0][0] == "fft_strided_tw"
    app = vt.FFTApplication(vt.FFTConfig(shape=(n,), normalize=True),
                            engine="cuda")
    calls = torch_engine.calls
    y = app.forward(vt.from_numpy_planar(re, im))
    ref = np.asarray(vk.fft(x64.astype(np.complex64), engine="jnp"))
    want = np.fft.fft(x64)
    assert _rel(_c(y), ref) <= REF_TOL and _rel(_c(y), want) <= NUMPY_TOL
    z = app.inverse(y)
    assert _rel(_c(z), x64) <= NUMPY_TOL
    f = vt.ifft(x64.astype(np.complex64), engine="cuda", device="cpu")
    ref = np.asarray(vk.ifft(x64.astype(np.complex64), engine="jnp"))
    assert _rel(f, ref) <= REF_TOL and _rel(f, np.fft.ifft(x64)) <= NUMPY_TOL
    xt = vt.Planar(torch.from_numpy(re.reshape(2, n, 1).copy()),
                   torch.from_numpy(im.reshape(2, n, 1).copy()))
    yt = cuda_engine.fft_axis_p(xt, 1, plan_axis(n))
    assert _rel(_c(yt).reshape(2, n), want) <= NUMPY_TOL
    assert torch_engine.calls == calls


def test_cuda_route_refuses_options_outside_the_slice():
    x = vt.from_numpy_planar(*_planes((2, 16), seed=16))
    # float64 planes: the fp64 kernels at a length they take (here their
    # plain versions), refused at one they do not (67: fft_twofactor's)
    y = cuda_engine.fft_lines_p(x.astype(torch.float64), plan_axis(16))
    assert y.dtype == torch.float64
    x64 = x.re.double().numpy() + 1j * x.im.double().numpy()
    assert _rel(_c(y), np.fft.fft(x64)) <= 5e-14
    x67 = vt.from_numpy_planar(*_planes((2, 67), seed=67))
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_engine.fft_lines_p(x67.astype(torch.float64), plan_axis(67))
    # zero-pad keeps run since queue 1 item 8.1: only the kept points
    # read, only the kept points written
    keep = torch.arange(16) < 4
    masked = vt.Planar(torch.where(keep, x.re, 0.0),
                       torch.where(keep, x.im, 0.0))
    y = cuda_engine.fft_axis_p(x, 1, plan_axis(16), in_keep=4)
    assert _rel(_c(y), np.fft.fft(_c(masked))) <= 5e-6
    y = cuda_engine.fft_axis_p(x, 1, plan_axis(16), out_keep=4)
    assert y.shape == (2, 4)
    assert _rel(_c(y), np.fft.fft(_c(x))[:, :4]) <= 5e-6
    # the five window configs build and run (their values:
    # tests/test_torch_zeropad.py)
    windowed = [
        dict(kind=vt.TransformKind.R2C, zeropad_input=((0, 8),)),
        dict(kind=vt.TransformKind.DCT, zeropad_input=((0, 8),)),
        dict(kind=vt.TransformKind.DST, rr_type=1, zeropad_output=((8, 16),)),
        dict(zeropad_input=((0, 8),)),
        dict(zeropad_output=((8, 16),)),
    ]
    for kw in windowed:
        app = vt.FFTApplication(vt.FFTConfig(shape=(16,), **kw),
                                engine="cuda", device="cpu")
        data = x if app.config.kind is vt.TransformKind.C2C else x.re
        assert app.forward(data).shape[-1] in (9, 16)
    # keep_intermediate_order runs (queue 1 item 8.2): the kept-order
    # forward matches the JAX package's tl kernel in interpret mode, and
    # the inverse gives the input back (tests/test_torch_keep_order.py)
    kio = vt.FFTConfig(shape=(16,), keep_intermediate_order=True,
                       normalize=True)
    Y = vt.FFTApplication(kio, engine="cuda").forward(x)
    assert isinstance(Y, vt.TlSpectrum) and Y.split == (16, 1)
    pallas_engine.set_interpret(True)
    try:
        Yr = vk.FFTApplication(vk.FFTConfig(shape=(16,), normalize=True,
                                            keep_intermediate_order=True),
                               engine="pallas").forward(
            vk.Planar(jnp.asarray(x.re.numpy()), jnp.asarray(x.im.numpy())))
    finally:
        pallas_engine.set_interpret(False)
    steps, n, gb = Yr.re.shape
    want = np.moveaxis(_c(Yr), 1, 2).reshape(steps * gb, n)[:2]
    assert _rel(_c(Y.natural()), want) <= REF_TOL
    assert _rel(_c(vt.FFTApplication(kio, engine="cuda").inverse(Y)),
                _c(x)) <= NUMPY_TOL
    # the storage tiers of C2C build and run on the cuda engine's routing
    for prec in (vt.Precision.BFLOAT16, vt.Precision.HALF):
        app = vt.FFTApplication(vt.FFTConfig(shape=(16,), precision=prec),
                                engine="cuda")
        assert app.forward(x).dtype == vt.api.STORAGE[prec]
    # the real kinds ignore the precision flag, as the JAX package's do
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,), kind=vt.TransformKind.R2C,
                                         precision=vt.Precision.DOUBLE),
                            engine="cuda")
    assert app.double_route is None
    with pytest.raises(InvalidConfigError):
        vt.FFTApplication(vt.FFTConfig(shape=(16,), convolution=True))
    with pytest.raises(InvalidConfigError):
        vt.FFTApplication(vt.FFTConfig(shape=(16,)), engine="pallas")


def test_shape_and_batch_checks():
    app = vt.FFTApplication(vt.FFTConfig(shape=(16,), batch=3), device="cpu")
    with pytest.raises(InvalidConfigError):
        app.forward(vt.from_numpy_planar(*_planes((2, 16), seed=17)))
    with pytest.raises(InvalidConfigError):
        app.forward(vt.from_numpy_planar(*_planes((3, 8), seed=17)))
    y = app.forward(vt.from_numpy_planar(*_planes((3, 16), seed=17)))
    assert y.shape == (3, 16)


def test_tiny_lengths_on_cuda_engine_route():
    for n in (1, 2, 3, 4):
        re, im = _planes((5, n), seed=n)
        x = vt.from_numpy_planar(re, im)
        for inverse in (False, True):
            y = cuda_engine.fft_lines_p(x, plan_axis(n), inverse, scale=0.5)
            x64 = re.astype(np.float64) + 1j * im
            want = (np.fft.ifft(x64, axis=1) * n if inverse
                    else np.fft.fft(x64, axis=1)) * 0.5
            assert _rel(_c(y), want) <= NUMPY_TOL
