"""The port's distributed layer (`vkfft_tpu_torch.parallel`) against the
JAX package's (`vkfft_tpu.parallel`), on the CPU.

One gloo world of 8 ranks is spawned per module: each rank runs every case
of `RANK_CASES` on its own shard, as a rank of a torchrun job does, and
writes what it got; the JAX package computes the same cases in this process
on its 8 virtual CPU devices (`tests/conftest.py`), from the same seeded
numpy inputs.  Rank r's shard of each result is held against the shard the
JAX mesh places on the device of id r, the mesh coordinate rank r holds
(the port's meshes are built from the JAX meshes' device ids): <= 1e-5 of
the shard's max|ref| for complex64/float32 data, <= 1e-11 for complex128 on
the torch engine against the jnp engine, as `tests/test_parallel.py` holds
the JAX package; and against numpy fp64.

The ranks import neither JAX nor `vkfft_tpu`: this module imports them only
inside the parent's tests, and the ranks check `sys.modules`.
"""
from __future__ import annotations

import datetime
import os
import pathlib
import pickle
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 8
JOIN_S = 300          # the world's deadline: a hung collective fails
F32_TOL = 1e-5        # a rank's shard vs the JAX shard, of its max|ref|
F64_TOL = 1e-11       # complex128, torch engine vs the jnp engine
NUMPY_TOL = 5e-6      # fp32 data vs numpy fp64

# --- inputs, made alike in the ranks and in the parent ----------------------


def _cplx(shape, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


SLAB_SHAPES = [(16, 32), (8, 16, 12), (16, 8, 8)]
REAL_SHAPES = [(16, 8, 12), (8, 30), (16, 8, 7)]
EX09_SHAPE = (64, 32, 128)
TAIL_SHAPE = (16, 128, 128)

# --- the ranks ---------------------------------------------------------------


def _np(y):
    """numpy of a local result: a tensor, a `Planar` or a DTensor."""
    from torch.distributed.tensor import DTensor
    from vkfft_tpu_torch.pcomplex import Planar, to_numpy
    if isinstance(y, Planar):
        return to_numpy(Planar(*(t.to_local() if isinstance(t, DTensor)
                                 else t for t in (y.re, y.im))))
    if isinstance(y, DTensor):
        y = y.to_local()
    return y.detach().numpy()


def _error(fn):
    try:
        fn()
    except Exception as e:   # the type and message, held by the parent
        return type(e).__name__, str(e)
    return None


def _case_mesh_helper(par, ctx):
    m = par.fft_mesh(device_type="cpu")
    m2 = par.fft_mesh((4, 2), ("x", "y"), device_type="cpu")
    return {"m": m.mesh.numpy(), "m2": m2.mesh.numpy(),
            "names": m2.mesh_dim_names,
            "err": _error(lambda: par.fft_mesh((3, 2), ("x", "y"),
                                               device_type="cpu"))}


def _case_pfft(par, ctx):
    from vkfft_tpu_torch.parallel import pencil
    x = torch.from_numpy(_cplx((16, 64), 0))
    before = pencil.exchanges
    y = par.pfft(x, ctx["mesh"], engine="torch")
    return {"y": _np(y), "placements": repr(y.placements),
            "exchanges": pencil.exchanges - before}


def _slab_fftn(shape):
    def case(par, ctx):
        from vkfft_tpu_torch.parallel import pencil
        x = torch.from_numpy(_cplx(shape, int(np.prod(shape))))
        app = par.DistributedFFT(shape, ctx["mesh"], engine="torch")
        before = pencil.exchanges
        y = app.forward(app.shard_input(x))
        return {"y": _np(y), "exchanges": pencil.exchanges - before,
                "dtype": str(y.dtype)}
    return case


def _case_slab_roundtrip(par, ctx):
    shape = (16, 16, 8)
    x = torch.from_numpy(_cplx(shape, 1))
    app = par.DistributedFFT(shape, ctx["mesh"], engine="torch")
    y = app.forward(app.shard_input(x))
    return {"y": _np(y), "z": _np(app.inverse(y))}


def _case_slab_transpose_back(par, ctx):
    from vkfft_tpu_torch.parallel import pencil
    shape = (16, 16)
    x = torch.from_numpy(_cplx(shape, 2))
    app = par.DistributedFFT(shape, ctx["mesh"], engine="torch",
                             transpose_back=True)
    before = pencil.exchanges
    y = app.forward(app.shard_input(x))
    return {"y": _np(y), "exchanges": pencil.exchanges - before,
            "specs": (repr(app.input_spec()), repr(app.output_spec()))}


def _case_pencil_fftn(par, ctx):
    from vkfft_tpu_torch.parallel import pencil
    shape = (8, 8, 16)
    x = torch.from_numpy(_cplx(shape, 3))
    app = par.DistributedFFT(shape, ctx["mesh42"], engine="torch")
    before = pencil.exchanges
    y = app.forward(app.shard_input(x))
    n_fwd = pencil.exchanges - before
    return {"y": _np(y), "z": _np(app.inverse(y)), "exchanges": n_fwd,
            "specs": (repr(app.input_spec()), repr(app.output_spec()))}


def _case_pencil_transpose_back(par, ctx):
    # a (2, 2) mesh over ranks 0-3 (the JAX test's devices[:4]): building
    # it is collective, so every rank builds it; ranks 4-7 stop there
    m = par.fft_mesh((2, 2), ("px", "py"), ranks=range(4), device_type="cpu")
    if ctx["rank"] >= 4:
        return {"outside": m.get_coordinate() is None,
                "refused": _error(lambda: par.DistributedFFT(
                    (4, 4, 8), m, engine="torch"))}
    from vkfft_tpu_torch.parallel import pencil
    shape = (4, 4, 8)
    x = torch.from_numpy(_cplx(shape, 4))
    app = par.DistributedFFT(shape, m, engine="torch", transpose_back=True)
    before = pencil.exchanges
    y = app.forward(app.shard_input(x))
    n_fwd = pencil.exchanges - before
    return {"mesh": m.mesh.numpy(), "y": _np(y), "z": _np(app.inverse(y)),
            "exchanges": n_fwd}


def _case_pfftn_facade(par, ctx):
    from torch.distributed.tensor import Replicate, distribute_tensor
    x = torch.from_numpy(_cplx((8, 8), 5))
    y = par.pfftn(x, ctx["mesh"], engine="torch")
    z = par.pifftn(y, ctx["mesh"], engine="torch")
    # a DTensor of other placements is redistributed to the input's
    xd = distribute_tensor(x, ctx["mesh"], [Replicate()])
    y2 = par.pfftn(xd, ctx["mesh"], engine="torch")
    return {"y": _np(y), "z": _np(z), "y_placements": repr(y.placements),
            "z_placements": repr(z.placements), "global": tuple(y.shape),
            "y_dtensor_in": _np(y2)}


def _case_slab_reversed(par, ctx):
    # ranks in reverse order along the axis: a group numbers its ranks in
    # sorted order, so the exchange permutes its blocks
    shape = (16, 8, 12)
    m = par.fft_mesh(ranks=range(WORLD - 1, -1, -1), device_type="cpu")
    x = torch.from_numpy(_cplx(shape, 6))
    app = par.DistributedFFT(shape, m, engine="torch")
    y = app.forward(app.shard_input(x))
    return {"m": m.mesh.numpy(), "y": _np(y), "z": _np(app.inverse(y))}


def _case_divisibility(par, ctx):
    return {"err": _error(lambda: par.DistributedFFT(
        (12, 16), ctx["mesh"], engine="torch"))}


def _planar_case(mesh_key, shape, seed):
    def case(par, ctx):
        from vkfft_tpu_torch.pcomplex import from_numpy_planar
        x = _cplx(shape, seed, np.complex64)
        app = par.DistributedFFT(shape, ctx[mesh_key], engine="torch")
        p = app.shard_input(from_numpy_planar(x.real.copy(), x.imag.copy()))
        y = app.forward(p)
        return {"y": _np(y), "z": _np(app.inverse(y)),
                "dtype": str(y.re.dtype)}
    return case


def _case_hybrid_mesh(par, ctx):
    m = par.hybrid_fft_mesh((1, 4), (2, 1), ("x", "y"), device_type="cpu")
    return {"m": m.mesh.numpy(),
            "err": _error(lambda: par.hybrid_fft_mesh(
                (1, 4), (4, 1), ("x", "y"), device_type="cpu"))}


def _overlap(chunks):
    def case(par, ctx):
        from vkfft_tpu_torch.parallel import pencil
        shape = (8, 8, 16)
        x = torch.from_numpy(_cplx(shape, 11, np.complex64))
        ref_app = par.DistributedFFT(shape, ctx["mesh42"], engine="torch")
        app = par.DistributedFFT(shape, ctx["mesh42"], engine="torch",
                                 overlap_chunks=chunks)
        y_ref = ref_app.forward(ref_app.shard_input(x))
        before = pencil.exchanges
        y = app.forward(app.shard_input(x))
        n_fwd = pencil.exchanges - before
        z = app.inverse(y)
        return {"y_ref": _np(y_ref), "y": _np(y), "z": _np(z),
                "z_ref": _np(ref_app.inverse(y_ref)), "exchanges": n_fwd}
    return case


def _case_overlap_hybrid(par, ctx):
    shape = (8, 8, 16)
    m = par.hybrid_fft_mesh((1, 4), (2, 1), ("px", "py"), device_type="cpu")
    x = torch.from_numpy(_cplx(shape, 12, np.complex64))
    app = par.DistributedFFT(shape, m, engine="torch", overlap_chunks=2)
    y = app.forward(app.shard_input(x))
    return {"m": m.mesh.numpy(), "y": _np(y), "z": _np(app.inverse(y))}


def _case_tail_pair(par, ctx):
    # the cuda engine on CPU planes runs its kernels' plain versions: the
    # slab's routing (the minor pair in one fft_pair pass) without a card
    from vkfft_tpu_torch.pcomplex import from_numpy_planar
    x = _cplx(TAIL_SHAPE, 55, np.complex64)
    app = par.DistributedFFT(TAIL_SHAPE, ctx["mesh"], engine="cuda")
    p = app.shard_input(from_numpy_planar(x.real.copy(), x.imag.copy()))
    y = app.forward(p)
    return {"tail_pair": app._tail_pair, "y": _np(y),
            "z": _np(app.inverse(y))}


def _real_slab(shape):
    def case(par, ctx):
        from vkfft_tpu_torch.parallel import pencil
        x = torch.from_numpy(_real(shape, int(np.prod(shape))))
        before = pencil.exchanges
        X = par.prfftn(x, ctx["mesh"], engine="torch")
        n_fwd = pencil.exchanges - before
        back = par.pirfftn(X, shape, ctx["mesh"], engine="torch")
        return {"X": _np(X), "back": _np(back), "global": tuple(X.shape),
                "exchanges": n_fwd, "back_dtype": str(back.dtype)}
    return case


def _case_real_pencil(par, ctx):
    shape = (8, 8, 14)
    x = torch.from_numpy(_real(shape, 3))
    app = par.DistributedFFT(shape, ctx["mesh42"], engine="torch", real=True)
    X = app.forward(app.shard_input(x))
    return {"X": _np(X), "back": _np(app.inverse(X))}


def _case_real_validation(par, ctx):
    return {"err": _error(lambda: par.DistributedFFT(
        (8, 8, 12), ctx["mesh42"], engine="torch", real=True))}


def _case_conv(par, ctx):
    shape = (16, 8, 12)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    k = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    conv = par.DistributedConvolution(shape, ctx["mesh"], torch.from_numpy(k),
                                      engine="torch")
    y = conv(torch.from_numpy(x))
    return {"y": _np(y), "placements": repr(y.placements)}


def _case_conv_real(par, ctx):
    shape = (16, 8, 12)
    rng = np.random.default_rng(12)
    xr = rng.standard_normal(shape).astype(np.float32)
    kr = rng.standard_normal(shape).astype(np.float32)
    conv = par.DistributedConvolution(shape, ctx["mesh"], kr, engine="torch",
                                      real=True)
    return {"y": _np(conv(xr))}


def _case_ex09(par, ctx):
    """examples/ex09_distributed_mesh.py's flow on the port."""
    shape = EX09_SHAPE
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    xr = rng.standard_normal(shape).astype(np.float32)
    kr = rng.standard_normal(shape).astype(np.float32)
    mesh = par.fft_mesh((8,), device_type="cpu")
    mesh2 = par.fft_mesh((2, 4), axis_names=("x", "y"), device_type="cpu")
    X = par.pfftn(x, mesh)
    X2 = par.pfftn(x, mesh2)
    z = par.pifftn(X2, mesh2)
    Xr = par.prfftn(xr, mesh)
    back = par.pirfftn(Xr, shape, mesh)
    conv = par.DistributedConvolution(shape, mesh, kr, real=True)
    return {"X": _np(X), "X2": _np(X2), "z": _np(z), "Xr": _np(Xr),
            "back": _np(back), "conv": _np(conv(xr)),
            "engine": par.DistributedFFT(shape, mesh)._engine_name}


RANK_CASES = {
    "mesh_helper": _case_mesh_helper,
    "pfft": _case_pfft,
    **{f"slab_fftn_{i}": _slab_fftn(s) for i, s in enumerate(SLAB_SHAPES)},
    "slab_roundtrip": _case_slab_roundtrip,
    "slab_transpose_back": _case_slab_transpose_back,
    "pencil_fftn": _case_pencil_fftn,
    "pencil_transpose_back": _case_pencil_transpose_back,
    "pfftn_facade": _case_pfftn_facade,
    "slab_reversed": _case_slab_reversed,
    "divisibility": _case_divisibility,
    "slab_planar": _planar_case("mesh", (16, 16, 8), 9),
    "pencil_planar": _planar_case("mesh42", (8, 8, 16), 10),
    "hybrid_mesh": _case_hybrid_mesh,
    "overlap_2": _overlap(2),
    "overlap_4": _overlap(4),
    "overlap_hybrid": _case_overlap_hybrid,
    "tail_pair": _case_tail_pair,
    **{f"real_slab_{i}": _real_slab(s) for i, s in enumerate(REAL_SHAPES)},
    "real_pencil": _case_real_pencil,
    "real_validation": _case_real_validation,
    "conv": _case_conv,
    "conv_real": _case_conv_real,
    "ex09": _case_ex09,
}


def _rank_main(rank: int, path: str) -> None:
    """One rank of the gloo world: every case in order (building a mesh is
    collective, so every rank runs every case), its results pickled."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from vkfft_tpu_torch import parallel as par
    # the explicit form: coordinator (a file store), world size, rank
    started = [par.initialize_distributed(
        f"file://{path}/store", WORLD, rank, device_type="cpu",
        timeout=datetime.timedelta(seconds=JOIN_S))]
    started.append(par.initialize_distributed())   # idempotent
    ctx = {"rank": rank, "mesh": par.fft_mesh(device_type="cpu"),
           "mesh42": par.fft_mesh((4, 2), ("px", "py"), device_type="cpu")}
    out = {"jax_free": not [m for m in sys.modules if m.split(".")[0]
                            in ("jax", "jaxlib", "vkfft_tpu")],
           "initialize": started + [dist.get_backend(), dist.get_rank(),
                                    dist.get_world_size()]}
    for name, case in RANK_CASES.items():
        try:
            out[name] = case(par, ctx)
        except Exception:   # reported by the parent's test of the case
            out[name] = {"failed": traceback.format_exc()}
    with open(os.path.join(path, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{case: [rank 0's result, ..., rank 7's]} of one gloo world."""
    import torch.multiprocessing as mp
    path = str(tmp_path_factory.mktemp("gloo_world"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, path), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not alive, f"ranks still running after {JOIN_S} s: {alive}"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, codes
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(path, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    assert all(o["jax_free"] for o in ranks)
    return {name: [o[name] for o in ranks] for name in ranks[0]}


def test_initialize_distributed_explicit(world):
    """Each rank came up through `initialize_distributed` with an explicit
    coordinator, world size and rank (gloo for "cpu"), and a second call
    returned True without a second group."""
    assert world["initialize"] == [[True, True, "gloo", r, WORLD]
                                   for r in range(WORLD)]


def _results(world, name) -> list:
    got = world[name]
    failed = [g["failed"] for g in got if "failed" in g]
    assert not failed, failed[0]
    return got


# --- the JAX side -------------------------------------------------------------


def _jax():
    import jax
    import vkfft_tpu.parallel as jpar
    return jax, jpar


def _mesh_args(mesh):
    """A JAX mesh as the port's mesh arguments: axis names and the device
    ids as a numpy array (the ranks at each mesh coordinate)."""
    return tuple(mesh.axis_names), np.vectorize(lambda d: d.id)(mesh.devices)


def _shards(y) -> dict:
    """{device id: numpy shard} of a JAX global array or `Planar`."""
    from vkfft_tpu.pcomplex import Planar as JPlanar
    if isinstance(y, JPlanar):
        re, im = _shards(y.re), _shards(y.im)
        return {k: re[k] + 1j * im[k] for k in re}
    return {s.device.id: np.asarray(s.data) for s in y.addressable_shards}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _hold_shards(got: list, ref, tol: float, key: str, ranks=None) -> None:
    """Each rank's ``key`` against the JAX shard on its device id."""
    want = _shards(ref)
    for r in (range(WORLD) if ranks is None else ranks):
        err = _rel(got[r][key], want[r])
        assert err <= tol, (key, r, err)


def _hold_numpy(got: list, key: str, ref: np.ndarray, sl, tol: float,
                ranks=None) -> None:
    """Each rank's ``key`` against its block ``sl(r)`` of a numpy result."""
    for r in (range(WORLD) if ranks is None else ranks):
        err = _rel(got[r][key], ref[sl(r)])
        assert err <= tol, (key, r, err)


def _blocks(shape, mesh_shape, axes):
    """sl(r): rank r's block of ``shape`` on a mesh of ``mesh_shape`` with
    ranks in order, mesh axis i sharding array axis ``axes[i]``."""
    def sl(r):
        coord = np.unravel_index(r, mesh_shape)
        idx = [slice(None)] * len(shape)
        for c, p, a in zip(coord, mesh_shape, axes):
            b = shape[a] // p
            idx[a] = slice(c * b, (c + 1) * b)
        return tuple(idx)
    return sl


# --- the tests ------------------------------------------------------------------


def test_mesh_helper(world):
    got = _results(world, "mesh_helper")
    jax, jpar = _jax()
    names, ids = _mesh_args(jpar.fft_mesh())
    names2, ids2 = _mesh_args(jpar.fft_mesh((4, 2), ("x", "y")))
    with pytest.raises(ValueError) as e:
        jpar.fft_mesh((3, 2), ("x", "y"))
    for g in got:
        assert np.array_equal(g["m"], ids) and g["m"].size == 8
        assert np.array_equal(g["m2"], ids2) and g["m2"].shape == (4, 2)
        assert tuple(g["names"]) == names2
        assert g["err"] == ("ValueError", str(e.value))


def test_batch_sharded_pfft(world):
    got = _results(world, "pfft")
    jax, jpar = _jax()
    x = _cplx((16, 64), 0)
    ref = jpar.pfft(x, jpar.fft_mesh(), engine="jnp")
    _hold_shards(got, ref, F64_TOL, "y")
    _hold_numpy(got, "y", np.fft.fft(x), _blocks((16, 64), (8,), (0,)),
                1e-11)
    assert all(g["placements"] == "(Shard(dim=0),)" and g["exchanges"] == 0
               for g in got)


@pytest.mark.parametrize("i", range(len(SLAB_SHAPES)))
def test_slab_fftn(world, i):
    shape = SLAB_SHAPES[i]
    got = _results(world, f"slab_fftn_{i}")
    jax, jpar = _jax()
    x = _cplx(shape, int(np.prod(shape)))
    app = jpar.DistributedFFT(shape, jpar.fft_mesh(), engine="jnp")
    ref = app.forward(app.shard_input(x))
    _hold_shards(got, ref, F64_TOL, "y")
    _hold_numpy(got, "y", np.fft.fftn(x), _blocks(shape, (8,), (1,)), 1e-11)
    assert all(g["exchanges"] == 1 and g["dtype"] == "torch.complex128"
               for g in got)


def test_slab_roundtrip(world):
    got = _results(world, "slab_roundtrip")
    jax, jpar = _jax()
    shape = (16, 16, 8)
    x = _cplx(shape, 1)
    app = jpar.DistributedFFT(shape, jpar.fft_mesh(), engine="jnp")
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F64_TOL, "y")
    _hold_shards(got, app.inverse(y), F64_TOL, "z")
    _hold_numpy(got, "z", x, _blocks(shape, (8,), (0,)), 1e-11)


def test_slab_transpose_back_sharding(world):
    got = _results(world, "slab_transpose_back")
    jax, jpar = _jax()
    shape = (16, 16)
    x = _cplx(shape, 2)
    mesh = jpar.fft_mesh()
    app = jpar.DistributedFFT(shape, mesh, engine="jnp", transpose_back=True)
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F64_TOL, "y")
    _hold_numpy(got, "y", np.fft.fftn(x), _blocks(shape, (8,), (0,)), 1e-11)
    # the output sharding is the input's: axis 0 sharded, one exchange more
    assert str(y.sharding.spec) == str(type(y.sharding.spec)(
        mesh.axis_names[0], None))
    assert all(g["specs"] == ("(Shard(dim=0),)", "(Shard(dim=0),)")
               and g["exchanges"] == 2 for g in got)


def test_pencil_fftn(world):
    got = _results(world, "pencil_fftn")
    jax, jpar = _jax()
    shape = (8, 8, 16)
    x = _cplx(shape, 3)
    mesh = jpar.fft_mesh((4, 2), ("px", "py"))
    app = jpar.DistributedFFT(shape, mesh, engine="jnp")
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F64_TOL, "y")
    _hold_shards(got, app.inverse(y), F64_TOL, "z")
    _hold_numpy(got, "y", np.fft.fftn(x), _blocks(shape, (4, 2), (1, 2)),
                1e-11)
    _hold_numpy(got, "z", x, _blocks(shape, (4, 2), (0, 1)), 1e-11)
    assert all(g["exchanges"] == 2 and g["specs"] == (
        "(Shard(dim=0), Shard(dim=1))", "(Shard(dim=1), Shard(dim=2))")
        for g in got)


def test_pencil_transpose_back(world):
    got = _results(world, "pencil_transpose_back")
    jax, jpar = _jax()
    shape = (4, 4, 8)
    x = _cplx(shape, 4)
    mesh = jpar.fft_mesh((2, 2), ("px", "py"), devices=jax.devices()[:4])
    app = jpar.DistributedFFT(shape, mesh, engine="jnp", transpose_back=True)
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F64_TOL, "y", ranks=range(4))
    _hold_shards(got, app.inverse(y), F64_TOL, "z", ranks=range(4))
    _hold_numpy(got, "y", np.fft.fftn(x), _blocks(shape, (2, 2), (0, 1)),
                1e-11, ranks=range(4))
    ids = _mesh_args(mesh)[1]
    assert all(np.array_equal(got[r]["mesh"], ids)
               and got[r]["exchanges"] == 4 for r in range(4))
    for r in range(4, WORLD):
        assert got[r]["outside"]
        assert got[r]["refused"][0] == "InvalidConfigError"


def test_pfftn_facade(world):
    got = _results(world, "pfftn_facade")
    jax, jpar = _jax()
    x = _cplx((8, 8), 5)
    mesh = jpar.fft_mesh()
    y = jpar.pfftn(x, mesh, engine="jnp")
    _hold_shards(got, y, F64_TOL, "y")
    _hold_shards(got, jpar.pifftn(y, mesh, engine="jnp"), F64_TOL, "z")
    _hold_numpy(got, "z", x, _blocks((8, 8), (8,), (0,)), 1e-11)
    assert all(g["y_placements"] == "(Shard(dim=1),)"
               and g["z_placements"] == "(Shard(dim=0),)"
               and g["global"] == (8, 8)
               and np.array_equal(g["y_dtensor_in"], g["y"]) for g in got)


def test_slab_reversed_ranks(world):
    got = _results(world, "slab_reversed")
    jax, jpar = _jax()
    shape = (16, 8, 12)
    x = _cplx(shape, 6)
    mesh = jpar.fft_mesh(devices=jax.devices()[::-1])
    app = jpar.DistributedFFT(shape, mesh, engine="jnp")
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F64_TOL, "y")
    _hold_shards(got, app.inverse(y), F64_TOL, "z")
    ids = _mesh_args(mesh)[1]
    assert all(np.array_equal(g["m"], ids) for g in got)


def test_divisibility_validation(world):
    got = _results(world, "divisibility")
    jax, jpar = _jax()
    import vkfft_tpu as vt
    with pytest.raises(vt.FFTError) as e:
        jpar.DistributedFFT((12, 16), jpar.fft_mesh(), engine="jnp")
    assert all(g["err"] == ("InvalidConfigError", str(e.value)) for g in got)


@pytest.mark.parametrize("kind", ["slab", "pencil"])
def test_planar(world, kind):
    got = _results(world, f"{kind}_planar")
    jax, jpar = _jax()
    from vkfft_tpu.pcomplex import from_complex
    shape, seed = ((16, 16, 8), 9) if kind == "slab" else ((8, 8, 16), 10)
    x = _cplx(shape, seed, np.complex64)
    mesh = (jpar.fft_mesh() if kind == "slab"
            else jpar.fft_mesh((4, 2), ("px", "py")))
    app = jpar.DistributedFFT(shape, mesh, engine="jnp")
    y = app.forward(app.shard_input(from_complex(x)))
    _hold_shards(got, y, F32_TOL, "y")
    _hold_shards(got, app.inverse(y), F32_TOL, "z")
    out_axes = (1,) if kind == "slab" else (1, 2)
    in_axes = (0,) if kind == "slab" else (0, 1)
    mshape = (8,) if kind == "slab" else (4, 2)
    _hold_numpy(got, "y", np.fft.fftn(x.astype(np.complex128)),
                _blocks(shape, mshape, out_axes), NUMPY_TOL)
    _hold_numpy(got, "z", x, _blocks(shape, mshape, in_axes), NUMPY_TOL)
    assert all(g["dtype"] == "torch.float32" for g in got)


def test_hybrid_mesh(world):
    got = _results(world, "hybrid_mesh")
    jax, jpar = _jax()
    names, ids = _mesh_args(jpar.hybrid_fft_mesh((1, 4), (2, 1), ("x", "y")))
    assert ids.shape == (2, 4) and (np.diff(ids, axis=1) == 1).all()
    with pytest.raises(ValueError) as e:
        jpar.hybrid_fft_mesh((1, 4), (4, 1), ("x", "y"))
    for g in got:
        assert np.array_equal(g["m"], ids)
        assert g["err"] == ("ValueError", str(e.value))


def test_initialize_distributed_single_process_noop(monkeypatch):
    import torch.distributed as dist
    from vkfft_tpu_torch.parallel import initialize_distributed
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False   # no launcher env: a no-op
    assert initialize_distributed(device_type="cpu") is False
    with pytest.raises(ValueError, match="rank and the world size"):
        initialize_distributed(num_processes=2, device_type="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("chunks", [2, 4])
def test_pencil_overlap_chunks(world, chunks):
    """The chunked exchange and compute equal the monolithic stage bit for
    bit (the free-axis chunking changes scheduling only), and match the
    JAX package's chunked transform."""
    got = _results(world, f"overlap_{chunks}")
    jax, jpar = _jax()
    shape = (8, 8, 16)
    x = _cplx(shape, 11, np.complex64)
    mesh = jpar.fft_mesh((4, 2), ("px", "py"))
    app = jpar.DistributedFFT(shape, mesh, engine="jnp",
                              overlap_chunks=chunks)
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F32_TOL, "y")
    _hold_numpy(got, "z", x, _blocks(shape, (4, 2), (0, 1)), NUMPY_TOL)
    # stage 1 chunks axis 0 (2 a rank: not at 4), stage 2 axis 2 (8)
    want = {2: 2 + 2, 4: 1 + 4}[chunks]
    for g in got:
        assert np.array_equal(g["y"], g["y_ref"])
        assert np.array_equal(g["z"], g["z_ref"])
        assert g["exchanges"] == want


def test_slab_overlap_on_hybrid_mesh(world):
    got = _results(world, "overlap_hybrid")
    jax, jpar = _jax()
    shape = (8, 8, 16)
    x = _cplx(shape, 12, np.complex64)
    mesh = jpar.hybrid_fft_mesh((1, 4), (2, 1), ("px", "py"))
    app = jpar.DistributedFFT(shape, mesh, engine="jnp", overlap_chunks=2)
    y = app.forward(app.shard_input(x))
    _hold_shards(got, y, F32_TOL, "y")
    _hold_shards(got, app.inverse(y), F32_TOL, "z")
    ids = _mesh_args(mesh)[1]
    assert all(np.array_equal(g["m"], ids) for g in got)


def test_slab_tail_pair_fused(world):
    """The cuda engine fuses the two rank-local minor axes into one
    `fft_pair` pass; its plain version on the CPU against the JAX
    package's Pallas pair kernel in interpret mode."""
    got = _results(world, "tail_pair")
    jax, jpar = _jax()
    from vkfft_tpu.ops import pallas_engine as pe
    from vkfft_tpu.pcomplex import from_complex
    x = _cplx(TAIL_SHAPE, 55, np.complex64)
    pe.set_interpret(True)
    try:
        app = jpar.DistributedFFT(TAIL_SHAPE, jpar.fft_mesh(),
                                  engine="pallas")
        assert app._tail_pair
        y = app.forward(app.shard_input(from_complex(x)))
        z = app.inverse(y)
    finally:
        pe.set_interpret(False)
    assert all(g["tail_pair"] for g in got)
    _hold_shards(got, y, F32_TOL, "y")
    _hold_shards(got, z, F32_TOL, "z")
    _hold_numpy(got, "y", np.fft.fftn(x.astype(np.complex128)),
                _blocks(TAIL_SHAPE, (8,), (1,)), NUMPY_TOL)


@pytest.mark.parametrize("i", range(len(REAL_SHAPES)))
def test_slab_real_fftn(world, i):
    shape = REAL_SHAPES[i]
    got = _results(world, f"real_slab_{i}")
    jax, jpar = _jax()
    x = _real(shape, int(np.prod(shape)))
    mesh = jpar.fft_mesh()
    X = jpar.prfftn(x, mesh, engine="jnp")
    _hold_shards(got, X, F32_TOL, "X")
    _hold_shards(got, jpar.pirfftn(X, shape, mesh, engine="jnp"), F32_TOL,
                 "back")
    ref = np.fft.rfftn(x.astype(np.float64))
    _hold_numpy(got, "X", ref, _blocks(ref.shape, (8,), (1,)), NUMPY_TOL)
    _hold_numpy(got, "back", x, _blocks(shape, (8,), (0,)), NUMPY_TOL)
    assert all(g["global"] == ref.shape and g["exchanges"] == 1
               and g["back_dtype"] == "torch.float32" for g in got)


def test_pencil_real_fftn(world):
    got = _results(world, "real_pencil")
    jax, jpar = _jax()
    shape = (8, 8, 14)
    x = _real(shape, 3)
    app = jpar.DistributedFFT(shape, jpar.fft_mesh((4, 2), ("px", "py")),
                              engine="jnp", real=True)
    X = app.forward(app.shard_input(x))
    _hold_shards(got, X, F32_TOL, "X")
    _hold_shards(got, app.inverse(X), F32_TOL, "back")
    ref = np.fft.rfftn(x.astype(np.float64))
    _hold_numpy(got, "X", ref, _blocks(ref.shape, (4, 2), (1, 2)),
                NUMPY_TOL)


def test_real_half_spectrum_divisibility_validation(world):
    got = _results(world, "real_validation")
    jax, jpar = _jax()
    from vkfft_tpu.errors import InvalidConfigError
    with pytest.raises(InvalidConfigError) as e:
        jpar.DistributedFFT((8, 8, 12), jpar.fft_mesh((4, 2), ("px", "py")),
                            engine="jnp", real=True)
    assert all(g["err"] == ("InvalidConfigError", str(e.value)) for g in got)


def test_distributed_convolution(world):
    got = _results(world, "conv")
    jax, jpar = _jax()
    shape = (16, 8, 12)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    k = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    ref = jpar.DistributedConvolution(shape, jpar.fft_mesh(), k,
                                      engine="jnp")(x)
    _hold_shards(got, ref, F32_TOL, "y")
    want = np.fft.ifftn(np.fft.fftn(x.astype(np.complex128))
                        * np.fft.fftn(k.astype(np.complex128)))
    _hold_numpy(got, "y", want, _blocks(shape, (8,), (0,)), NUMPY_TOL)
    assert all(g["placements"] == "(Shard(dim=0),)" for g in got)


def test_distributed_convolution_real(world):
    got = _results(world, "conv_real")
    jax, jpar = _jax()
    shape = (16, 8, 12)
    rng = np.random.default_rng(12)
    xr = rng.standard_normal(shape).astype(np.float32)
    kr = rng.standard_normal(shape).astype(np.float32)
    ref = jpar.DistributedConvolution(shape, jpar.fft_mesh(), kr,
                                      engine="jnp", real=True)(xr)
    _hold_shards(got, ref, F32_TOL, "y")
    want = np.fft.irfftn(np.fft.rfftn(xr.astype(np.float64))
                         * np.fft.rfftn(kr.astype(np.float64)), s=shape,
                         axes=(0, 1, 2))
    _hold_numpy(got, "y", want, _blocks(shape, (8,), (0,)), NUMPY_TOL)


def test_ex09_flow(world):
    """The slice as a whole: examples/ex09_distributed_mesh.py's flow at
    (64, 32, 128), every result held shard by shard against the JAX
    package's and against numpy."""
    got = _results(world, "ex09")
    jax, jpar = _jax()
    shape = EX09_SHAPE
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    xr = rng.standard_normal(shape).astype(np.float32)
    kr = rng.standard_normal(shape).astype(np.float32)
    mesh = jpar.fft_mesh((8,))
    mesh2 = jpar.fft_mesh((2, 4), axis_names=("x", "y"))
    X = jpar.pfftn(x, mesh)
    X2 = jpar.pfftn(x, mesh2)
    Xr = jpar.prfftn(xr, mesh)
    _hold_shards(got, X, F32_TOL, "X")
    _hold_shards(got, X2, F32_TOL, "X2")
    _hold_shards(got, jpar.pifftn(X2, mesh2), F32_TOL, "z")
    _hold_shards(got, Xr, F32_TOL, "Xr")
    _hold_shards(got, jpar.pirfftn(Xr, shape, mesh), F32_TOL, "back")
    _hold_shards(got, jpar.DistributedConvolution(shape, mesh, kr,
                                                  real=True)(xr),
                 F32_TOL, "conv")
    ref = np.fft.fftn(x.astype(np.complex128))
    _hold_numpy(got, "X", ref, _blocks(shape, (8,), (1,)), NUMPY_TOL)
    _hold_numpy(got, "X2", ref, _blocks(shape, (2, 4), (1, 2)), NUMPY_TOL)
    _hold_numpy(got, "z", x, _blocks(shape, (2, 4), (0, 1)), NUMPY_TOL)
    rref = np.fft.rfftn(xr.astype(np.float64))
    _hold_numpy(got, "Xr", rref, _blocks(rref.shape, (8,), (1,)), NUMPY_TOL)
    _hold_numpy(got, "back", xr, _blocks(shape, (8,), (0,)), NUMPY_TOL)
    conv = np.fft.irfftn(rref * np.fft.rfftn(kr.astype(np.float64)), s=shape,
                         axes=(0, 1, 2))
    _hold_numpy(got, "conv", conv, _blocks(shape, (8,), (0,)), NUMPY_TOL)
    assert all(g["engine"] == "torch" for g in got)


def test_import_isolation():
    """`vkfft_tpu_torch.parallel` imports neither JAX nor `vkfft_tpu`."""
    code = ("import sys\n"
            "import vkfft_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vkfft_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
