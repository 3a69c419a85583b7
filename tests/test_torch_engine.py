"""The torch port's plain engine against the JAX package's jnp engine and
numpy fp64, for every planner algorithm, both directions, with a scale, on
every axis of a small 3-D array."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkfft_tpu.ops import jnp_engine
from vkfft_tpu.pcomplex import Planar as RefPlanar
from vkfft_tpu.planner import plan_axis as ref_plan_axis

from vkfft_tpu_torch.ops import torch_engine
from vkfft_tpu_torch.pcomplex import from_numpy_planar
from vkfft_tpu_torch.planner import Algorithm, plan_axis

# n -> the planner's algorithm for it
SIZES = {8: "direct", 60: "direct", 97: "direct", 131: "rader",
         263: "bluestein", 393: "split"}
NUMPY_TOL = 5e-6   # the fp32 gate of tests/test_pallas.py
REF_TOL = 1e-5     # both packages' fp32 rounding


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)
    return re, im


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _numpy_ref(re, im, axis, inverse, scale):
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    n = x.shape[axis]
    y = np.fft.ifft(x, axis=axis) * n if inverse else np.fft.fft(x, axis=axis)
    return y * scale


def test_sizes_cover_every_algorithm():
    algs = {plan_axis(n).algorithm.value for n in SIZES}
    assert algs == {a.value for a in Algorithm}
    for n, alg in SIZES.items():
        assert plan_axis(n).algorithm.value == alg


@pytest.mark.parametrize("n", sorted(SIZES))
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fft_axis_matches_jnp_engine(n, axis):
    shape = [3, 2, 4]
    shape[axis] = n
    re, im = _planes(tuple(shape), seed=n + axis)
    x = from_numpy_planar(re, im)
    xr = RefPlanar(jnp.asarray(re), jnp.asarray(im))
    for inverse in (False, True):
        scale = 1.0 / n if inverse else 0.5
        y = torch_engine.fft_axis_p(x, axis, plan_axis(n), inverse, scale=scale)
        ref = jnp_engine.fft_axis_p(xr, axis, ref_plan_axis(n), inverse,
                                    scale=scale)
        got = y.re.numpy() + 1j * y.im.numpy()
        want = np.asarray(ref.re) + 1j * np.asarray(ref.im)
        assert y.shape == tuple(shape) and y.dtype == torch.float32
        assert _rel(got, want) <= REF_TOL, (n, axis, inverse)
        assert _rel(got, _numpy_ref(re, im, axis, inverse, scale)) <= NUMPY_TOL


@pytest.mark.parametrize("n", sorted(SIZES))
def test_fft_lines_matches_jnp_engine(n):
    re, im = _planes((5, n), seed=7 * n)
    x = from_numpy_planar(re, im)
    xr = RefPlanar(jnp.asarray(re), jnp.asarray(im))
    for inverse in (False, True):
        y = torch_engine.fft_lines_p(x, plan_axis(n), inverse, scale=0.25)
        ref = jnp_engine.fft_lines_p(xr, ref_plan_axis(n), inverse, scale=0.25)
        got = y.re.numpy() + 1j * y.im.numpy()
        assert _rel(got, np.asarray(ref.re) + 1j * np.asarray(ref.im)) <= REF_TOL
        assert _rel(got, _numpy_ref(re, im, 1, inverse, 0.25)) <= NUMPY_TOL


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_fft_axis_keeps_match_jnp_engine(axis):
    shape = [6, 5, 4]
    shape[axis] = 16
    re, im = _planes(tuple(shape), seed=40 + axis)
    x = from_numpy_planar(re, im)
    xr = RefPlanar(jnp.asarray(re), jnp.asarray(im))
    y = torch_engine.fft_axis_p(x, axis, plan_axis(16), False, in_keep=5,
                                out_keep=9)
    ref = jnp_engine.fft_axis_p(xr, axis, ref_plan_axis(16), False, in_keep=5,
                                out_keep=9)
    assert y.shape == tuple(ref.shape)
    got = y.re.numpy() + 1j * y.im.numpy()
    assert _rel(got, np.asarray(ref.re) + 1j * np.asarray(ref.im)) <= REF_TOL


def test_fft_axis_rejects_wrong_length():
    re, im = _planes((4, 8), seed=1)
    with pytest.raises(ValueError):
        torch_engine.fft_axis_p(from_numpy_planar(re, im), 1, plan_axis(16))


def test_storage_tier_computes_in_fp32():
    re, im = _planes((3, 64), seed=2)
    x = from_numpy_planar(re, im).astype(torch.bfloat16)
    y = torch_engine.fft_lines_p(x, plan_axis(64), False)
    assert y.dtype == torch.bfloat16
    ref = np.fft.fft(x.re.float().numpy() + 1j * x.im.float().numpy(), axis=1)
    got = y.re.float().numpy() + 1j * y.im.float().numpy()
    assert _rel(got, ref) < 1e-2


def test_calls_counter_counts():
    before = torch_engine.calls
    re, im = _planes((2, 8), seed=3)
    torch_engine.fft_lines_p(from_numpy_planar(re, im), plan_axis(8))
    assert torch_engine.calls > before
