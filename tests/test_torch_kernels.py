"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode, as tests/test_pallas.py runs
them) and numpy fp64, the kernels' coverage, and the wrappers' checks.  The
CUDA kernels themselves run only on the card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkfft_tpu.ops import pallas_engine

from vkfft_tpu_torch.ops import cuda_kernels as ck

NUMPY_TOL = 5e-6
REF_TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
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


@pytest.mark.parametrize("n", [8, 47, 60, 64, 360, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_lines_plain_matches_v3_kernel(n, inverse):
    re, im = _planes((4, n), seed=n)
    scale = 1.0 / n if inverse else 0.5
    yr, yi = ck.fft_lines(torch.from_numpy(re), torch.from_numpy(im),
                          inverse, scale)
    rr, ri = pallas_engine.core_fft_planar_v3(jnp.asarray(re), jnp.asarray(im),
                                              n, inverse, scale=scale)
    got = _c(yr.numpy(), yi.numpy())
    assert _rel(got, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    want = (np.fft.ifft(x, axis=1) * n if inverse else np.fft.fft(x, axis=1))
    assert _rel(got, want * scale) <= NUMPY_TOL


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_strided_plain_matches_strided_kernel(n, inverse):
    re, im = _planes((2, n, 24), seed=n + 1)
    scale = 1.0 / n if inverse else 1.0
    yr, yi = ck.fft_strided(torch.from_numpy(re), torch.from_numpy(im),
                            inverse, scale)
    rr, ri = pallas_engine.strided_fft_planar(jnp.asarray(re), jnp.asarray(im),
                                              n, inverse, scale=scale)
    got = _c(yr.numpy(), yi.numpy())
    assert got.shape == (2, n, 24)
    assert _rel(got, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    want = (np.fft.ifft(x, axis=1) * n if inverse else np.fft.fft(x, axis=1))
    assert _rel(got, want * scale) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(1, 8, 1), (3, 47, 5), (1, 100, 33)])
def test_fft_strided_plain_ragged_shapes(shape):
    re, im = _planes(shape, seed=sum(shape))
    yr, yi = ck.fft_strided(torch.from_numpy(re), torch.from_numpy(im), False)
    assert _rel(_c(yr.numpy(), yi.numpy()),
                np.fft.fft(_c(re, im), axis=1)) <= NUMPY_TOL


@pytest.mark.parametrize("ny,nz", [(128, 128), (128, 256)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_pair_plain_matches_pair_kernel(ny, nz, inverse):
    re, im = _planes((2, ny, nz), seed=ny + nz)
    scale = 1.0 / (ny * nz) if inverse else 1.0
    yr, yi = ck.fft_pair(torch.from_numpy(re), torch.from_numpy(im),
                         inverse, scale)
    rr, ri = pallas_engine.fft_pair_planar(jnp.asarray(re), jnp.asarray(im),
                                           ny, nz, inverse, scale=scale)
    got = _c(yr.numpy(), yi.numpy())
    assert got.shape == (2, ny, nz)
    assert _rel(got, _c(rr, ri)) <= REF_TOL
    x = _c(re, im)
    want = np.fft.ifft2(x) * (ny * nz) if inverse else np.fft.fft2(x)
    assert _rel(got, want * scale) <= NUMPY_TOL


@pytest.mark.parametrize("shape", [(3, 2, 4), (2, 47, 60), (1, 8, 8192)])
def test_fft_pair_plain_odd_shapes(shape):
    re, im = _planes(shape, seed=sum(shape))
    yr, yi = ck.fft_pair(torch.from_numpy(re), torch.from_numpy(im), False)
    assert _rel(_c(yr.numpy(), yi.numpy()),
                np.fft.fft2(_c(re, im))) <= NUMPY_TOL


def test_pair_cluster_rule():
    for ny in (2, 8, 47, 60, 64, 128, 256, 512, 1000, 8192):
        for nz in (2, 12, 64, 256, 360, 512, 8192):
            c = ck.pair_cluster(ny, nz)
            if c is None:
                continue
            per_block = 16 * ny * nz // c
            assert c in ck.PAIR_CLUSTERS and ny % c == 0 and nz % c == 0
            assert per_block <= ck.PAIR_MAX_BLOCK_BYTES
            assert per_block <= ck.PAIR_BLOCK_BYTES or c == max(
                k for k in ck.PAIR_CLUSTERS if ny % k == 0 and nz % k == 0)
    assert ck.pair_cluster(256, 256) == 16
    assert ck.pair_cluster(16, 16) == 1
    for ny, nz in ((512, 512), (1, 64), (67, 64), (1000, 100)):
        assert ck.pair_cluster(ny, nz) is None, (ny, nz)


def test_kernel_coverage_is_superset_of_v3():
    for n in range(1, ck.KERNEL_MAX_N + 1):
        if pallas_engine._use_v3(n):
            assert ck.kernel_supports(n), n
    for n in (67, 2 * 67, 8192 + 2, 16384, 1):
        assert not ck.kernel_supports(n), n


def test_kernel_plans_fit_the_kernels():
    for n in range(2, ck.KERNEL_MAX_N + 1):
        rad = ck.kernel_radices(n)
        if rad is None:
            continue
        assert int(np.prod(rad)) == n
        assert len(rad) <= ck._MAX_STAGES
        assert all(r in (2, 4, 8) or (r % 2 and r <= ck.KERNEL_MAX_PRIME)
                   for r in rad)
    assert ck.kernel_radices(4096) == (8, 8, 8, 8)
    assert ck.kernel_radices(1024) == (8, 8, 4, 4)


@pytest.mark.parametrize("n,inverse,scale", [(60, False, 1.0), (7808, True, 0.5)])
def test_stage_tables_layout(n, inverse, scale):
    ints, table = ck.stage_tables(n, inverse, scale)
    rad = ck.kernel_radices(n)
    k = len(rad)
    S = ck._MAX_STAGES
    assert ints[:3] == (n, k, int(inverse))
    assert ints[3:3 + k] == rad
    tw_off = ints[3 + S:3 + S + k]
    dft_off = ints[3 + 2 * S:3 + 2 * S + k]
    M = n
    for s, r in enumerate(rad):
        Mp = M // r
        tw = table[tw_off[s]:tw_off[s] + r * Mp].reshape(r, Mp)
        expect = np.exp((2j if inverse else -2j) * np.pi / M
                        * np.outer(np.arange(r), np.arange(Mp)))
        np.testing.assert_allclose(tw, expect * (scale if s == 0 else 1.0),
                                   atol=1e-12)
        if r in (2, 4, 8):
            assert dft_off[s] == -1
        else:
            w = table[dft_off[s]:dft_off[s] + r]
            np.testing.assert_allclose(
                w, np.exp((2j if inverse else -2j) * np.pi / r * np.arange(r)),
                atol=1e-12)
        M = Mp
    assert len(table) == max(tw_off[-1] + rad[-1],
                             dft_off[-1] + rad[-1] if dft_off[-1] >= 0 else 0)


def test_wrapper_checks():
    re, im = _planes((4, 64), seed=5)
    t_re, t_im = torch.from_numpy(re), torch.from_numpy(im)
    # float64 planes run the fp64 instantiation (here its plain version),
    # float16 the half-storage one; other dtypes, and planes of two dtypes,
    # are refused
    yr, yi = ck.fft_lines(t_re.double(), t_im.double())
    assert yr.dtype == torch.float64
    assert _rel(_c(yr.numpy(), yi.numpy()), np.fft.fft(_c(re, im))) <= 5e-14
    yr, yi = ck.fft_lines(t_re.half(), t_im.half())
    assert yr.dtype == torch.float16
    assert _rel(_c(yr.float().numpy(), yi.float().numpy()),
                np.fft.fft(_c(re, im))) <= 5e-3
    with pytest.raises(TypeError):
        ck.fft_lines(t_re.int(), t_im.int())
    # the 2-D mode of fft_conv_pair runs float16 planes (its half-storage
    # instantiation's plain version here) and refuses float64
    yr, yi = ck.fft_conv_pair(t_re.half().reshape(4, 8, 8),
                              t_im.half().reshape(4, 8, 8), torch.zeros(64, 2))
    assert yr.dtype == torch.float16 and not bool(yr.any() or yi.any())
    with pytest.raises(TypeError):
        ck.fft_conv_pair(t_re.double().reshape(4, 8, 8),
                         t_im.double().reshape(4, 8, 8), torch.zeros(64, 2))
    with pytest.raises(TypeError):
        ck.fft_lines(t_re, t_im.double())
    with pytest.raises(ValueError):
        ck.fft_lines(t_re.t(), t_im.t())      # (64, 4) view, not contiguous
    with pytest.raises(ValueError):
        ck.fft_lines(t_re, t_im[:2])
    with pytest.raises(ValueError):
        ck.fft_lines(t_re.reshape(4, 8, 8), t_im.reshape(4, 8, 8))
    with pytest.raises(NotImplementedError):
        ck.fft_lines(torch.zeros(2, 67), torch.zeros(2, 67))
    with pytest.raises(NotImplementedError):
        ck.fft_strided(torch.zeros(1, 16384, 2), torch.zeros(1, 16384, 2))
    with pytest.raises(TypeError):
        ck.fft_strided(np.zeros((1, 8, 2), np.float32),
                       np.zeros((1, 8, 2), np.float32))
    with pytest.raises(NotImplementedError):
        ck.fft_pair(torch.zeros(1, 67, 8), torch.zeros(1, 67, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ck.fft_pair(torch.zeros(1, 512, 512), torch.zeros(1, 512, 512))
    with pytest.raises(ValueError):
        ck.fft_pair(t_re, t_im)                 # 2-D planes


def test_wrapper_out_in_place_and_no_launch_on_cpu():
    re, im = _planes((3, 8, 5), seed=6)
    t_re, t_im = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    before = dict(ck.launches)
    yr, yi = ck.fft_strided(t_re, t_im, False, out=(t_re, t_im))
    assert yr is t_re and yi is t_im
    assert _rel(_c(t_re.numpy(), t_im.numpy()),
                np.fft.fft(_c(re, im), axis=1)) <= NUMPY_TOL
    assert ck.launches == before
    re, im = _planes((2, 8, 12), seed=7)
    t_re, t_im = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    yr, yi = ck.fft_pair(t_re, t_im, True, 0.5, out=(t_re, t_im))
    assert yr is t_re and yi is t_im
    assert _rel(_c(t_re.numpy(), t_im.numpy()),
                np.fft.ifft2(_c(re, im)) * 48) <= NUMPY_TOL
    assert ck.launches == before


def test_build_key_follows_sources():
    key = ck._source_key()
    assert key == ck._source_key() and len(key) == 16
    for name in ck.KERNEL_SOURCES:
        path = ck.library_path(name)
        assert path.startswith(ck.BUILD_DIR) and key in path
