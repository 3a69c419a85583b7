"""Slab/pencil-decomposed distributed FFTs over a device mesh.

Port of ``vkfft_tpu/parallel/pencil.py`` onto ``torch.distributed``: one
process per GPU, a ``DeviceMesh`` with named axes (`mesh`), and
``all_to_all_single`` over each mesh axis's process group (NCCL on GPUs,
gloo on the CPU), outside the kernels.  The reference lists "multiple GPU
job splitting" only as a future plan (README.md:24-25).  Design: the same
mathematics as the reference's four-step long-sequence decomposition
(``vkFFT_Scheduler.h:2651-2888``) lifted across GPUs: each rank transforms
the axes it holds whole with the port's kernels, and all-to-all exchanges
re-pencil the array so the remaining axes become local.

  slab  (1-D mesh, arrays >= 2-D):  local FFT over axes 1..d-1 (the two
        minor axes in one `fft_pair` pass where `pair_supports` holds),
        exchange (split axis 1, concat axis 0), local FFT over axis 0.
  pencil (2-D mesh, 3-D arrays):    FFT z; exchange over mesh axis 1
        (z<->y); FFT y; exchange over mesh axis 0 (y<->x); FFT x.

What each rank runs is the JAX package's ``shard_map`` body on its own
shard, so rank r's shard of a result is the shard the JAX mesh places on
the same mesh coordinate: the sharding contract (`input_spec`,
`output_spec`, as DTensor placements) is the JAX package's.  Outputs are
left in the transposed sharding by default, the distributed analog of the
reference's ``disableReorderFourStep`` (``vkFFT_Structs.h:221``): a
convolution does not care about the intermediate order and the inverse
undoes it; ``transpose_back=True`` adds the exchanges that restore the
input sharding.  `DistributedFFT.forward`/`inverse` take and return local
shards (a tensor or a `Planar` of local planes); the facades (`pfftn`,
`pifftn`, `prfftn`, `pirfftn`, `pfft`, `DistributedConvolution`) take a
global tensor or host array every rank holds, or a ``DTensor``, and return
``DTensor``s (a `Planar` of two for `Planar` input).

The inverse scales each local pass by its own axes' 1/n (the real inverse's
irfft its own axis, as numpy), so no pass of its own carries the 1/N; the
JAX package multiplies by 1/N after the last pass (``pencil.py:297-308``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from vkfft_tpu_torch import api
from vkfft_tpu_torch.errors import InvalidConfigError
from vkfft_tpu_torch.pcomplex import Planar, from_complex, to_complex
from vkfft_tpu_torch.planner.plan import plan_axis
from vkfft_tpu_torch.transforms import r2c

# Exchanges issued by this process (each one ``all_to_all_single``): a run
# reads it to show that a decomposition's collectives ran.
exchanges = 0


class _Exchange:
    """``jax.lax.all_to_all(x, name, split_axis, concat_axis, tiled=True)``
    over one mesh axis's process group, on `Planar` planes.

    The pack moves the split axis to the front as P blocks and stacks both
    planes, (P, 2, *block), one contiguous buffer (a copy, reading views as
    they are), so both planes ride ONE ``all_to_all_single``; the unpack
    puts the block from the rank at coordinate i at position i of the
    concat axis (a second copy; a view from one rank).  A group numbers
    its ranks in sorted order, not by mesh coordinate, so where the two
    differ (a mesh built from ranks out of order) the blocks are permuted
    to match."""

    def __init__(self, mesh: DeviceMesh, dim: int):
        self.group = mesh.get_group(dim)
        self.size = mesh.size(dim)
        coord = list(mesh.get_coordinate())
        coord[dim] = slice(None)
        along = mesh.mesh[tuple(coord)].tolist()
        # group rank of the rank at each coordinate along the axis
        rank_of = [dist.get_group_rank(self.group, r) for r in along]
        self._perm = None
        if rank_of != list(range(self.size)):
            self._perm = (torch.tensor(np.argsort(rank_of)),
                          torch.tensor(rank_of))

    def pack(self, x: Planar, split_axis: int) -> torch.Tensor:
        """(P, 2, *block): block g of both planes, for group rank g."""
        P, shape = self.size, x.shape
        b = shape[split_axis] // P

        def blocks(t):
            return t.reshape(shape[:split_axis] + (P, b)
                             + shape[split_axis + 1:]).movedim(split_axis, 0)

        send = torch.stack([blocks(x.re), blocks(x.im)], 1)
        if self._perm is not None:   # block g goes to group rank g
            send = send[self._perm[0].to(send.device)]
        return send

    def unpack(self, recv: torch.Tensor, concat_axis: int) -> Planar:
        """The planes of the received (P, 2, *block) buffer, block i at
        position i of ``concat_axis``."""
        if self._perm is not None:   # block g came from group rank g
            recv = recv[self._perm[1].to(recv.device)]
        block = recv.shape[2:]
        y = recv.movedim(0, 1 + concat_axis).reshape(
            (2,) + block[:concat_axis] + (self.size * block[concat_axis],)
            + block[concat_axis + 1:])
        return Planar(y[0], y[1])

    def start(self, x: Planar, split_axis: int, concat_axis: int):
        """Pack and issue the collective; `finish` waits and unpacks."""
        global exchanges
        send = self.pack(x, split_axis)
        recv = torch.empty_like(send)
        work = dist.all_to_all_single(recv, send, group=self.group,
                                      async_op=True)
        exchanges += 1
        return work, send, recv, concat_axis

    def finish(self, pending) -> Planar:
        work, _send, recv, concat_axis = pending
        work.wait()
        return self.unpack(recv, concat_axis)

    def run(self, x: Planar, split_axis: int, concat_axis: int) -> Planar:
        return self.finish(self.start(x, split_axis, concat_axis))


def _split(x: Planar, k: int, axis: int) -> list:
    return [Planar(r, i) for r, i in zip(x.re.chunk(k, axis),
                                         x.im.chunk(k, axis))]


def _concat(parts: list, axis: int) -> Planar:
    if len(parts) == 1:
        return parts[0]
    return Planar(torch.cat([p.re for p in parts], axis),
                  torch.cat([p.im for p in parts], axis))


def _overlapped(x: Planar, free_axis: int, chunks: int, xchg: _Exchange,
                split_axis: int, concat_axis: int, pre=None,
                post=None) -> Planar:
    """One exchange with a local FFT before it (``pre``, the inverse) or
    after it (``post``, the forward), run over ``chunks`` slices of ``x``
    along ``free_axis``, an axis touched by neither, so each chunk's chain
    is independent (the JAX package's ``_overlapped``, ``pencil.py:68-82``).
    Every chunk's collective is issued asynchronously before the first is
    waited on, and chunk i's ``post`` waits on chunk i's alone, so chunk
    i+1's exchange overlaps chunk i's transform; in the inverse, chunk i+1's
    transform overlaps chunk i's exchange.  The chunks are views of ``x``:
    the pack reads them in place, a local FFT of a non-minor axis copies
    them first.  The monolithic stage where the axis does not divide."""
    size = x.shape[free_axis]
    if chunks <= 1 or size % chunks or chunks > size:
        chunks = 1
    parts = _split(x, chunks, free_axis) if chunks > 1 else [x]
    pending = [xchg.start(pre(p) if pre is not None else p, split_axis,
                          concat_axis) for p in parts]
    outs = []
    for h in pending:
        y = xchg.finish(h)
        outs.append(post(y) if post is not None else y)
    return _concat(outs, free_axis)


def _mesh_names(mesh: DeviceMesh) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(names) if names else tuple(
        f"dim_{d}" for d in range(mesh.ndim))


def _device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's shards: the current CUDA device (each
    rank sets its own, `initialize_distributed`) or the CPU."""
    if mesh.device_type == "cuda":
        return api.resolve_device(torch.device(
            "cuda", torch.cuda.current_device()))
    return torch.device(mesh.device_type)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def _slices(mesh: DeviceMesh, shape, placements) -> tuple:
    """This rank's block of a global ``shape`` under ``placements``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise InvalidConfigError(
            f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    idx = [slice(None)] * len(shape)
    for d, pl in enumerate(placements):
        if isinstance(pl, Shard):
            b = shape[pl.dim] // mesh.size(d)
            idx[pl.dim] = slice(coord[d] * b, (coord[d] + 1) * b)
    return tuple(idx)


def _global_shape(x) -> tuple:
    return tuple((x.re if isinstance(x, Planar) else x).shape)


def _local_tensor(t, mesh: DeviceMesh, placements):
    """This rank's shard of ``t``: a ``DTensor``'s local tensor
    (redistributed to ``placements`` first where its own differ, a
    collective), else the block of a global tensor or host array every
    rank holds, on the rank's device."""
    placements = tuple(placements)
    if isinstance(t, DTensor):
        if t.device_mesh != mesh:
            raise InvalidConfigError(
                "DTensor operand lies on another mesh than the transform's")
        if tuple(t.placements) != placements:
            t = t.redistribute(mesh, placements)
        return t.to_local()
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(t))
    return t[_slices(mesh, t.shape, placements)].contiguous().to(
        _device(mesh))


def _local_of(x, mesh: DeviceMesh, placements):
    if isinstance(x, Planar):
        return Planar(_local_tensor(x.re, mesh, placements),
                      _local_tensor(x.im, mesh, placements))
    return _local_tensor(x, mesh, placements)


def _as_dtensor(y, mesh: DeviceMesh, placements, shape):
    """``DTensor``(s) of this rank's shard ``y`` of the global ``shape``."""
    def wrap(t):
        return DTensor.from_local(t, mesh, tuple(placements),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    if isinstance(y, Planar):
        return Planar(wrap(y.re), wrap(y.im))
    return wrap(y)


class DistributedFFT:
    """Planned multi-GPU N-D FFT application.

    Parameters
    ----------
    shape: global transform shape (the operand's whole shape).
    mesh:  1-axis `DeviceMesh` for slab decomposition, 2-axis (3-D arrays)
           for pencil decomposition; this rank must be in it.
    engine: the local engine ('torch'/'cuda'); by default 'cuda' on a
           "cuda" mesh, 'torch' on a "cpu" one.
    transpose_back: restore the input sharding after the transform.
    normalize: the inverse scales by 1/N.
    overlap_chunks: run each exchange and its local FFT in that many
           chunks along a free axis, the collectives asynchronous.
    real: a real transform (`prfftn`): local rfft over the last axis
           first, so every exchange moves the half spectrum.
    """

    def __init__(self, shape: tuple[int, ...], mesh: DeviceMesh,
                 engine: Optional[str] = None, transpose_back: bool = False,
                 normalize: bool = True, overlap_chunks: int = 1,
                 real: bool = False):
        self.shape = tuple(int(s) for s in shape)
        self.mesh = mesh
        self.engine = engine
        self.transpose_back = transpose_back
        self.normalize = normalize
        self.overlap_chunks = int(overlap_chunks)
        self.real = bool(real)
        self.axis_names = _mesh_names(mesh)
        ndim = len(self.shape)
        if len(self.axis_names) == 1:
            if ndim < 2:
                raise InvalidConfigError("slab decomposition needs >= 2-D arrays")
            self.kind = "slab"
        elif len(self.axis_names) == 2:
            if ndim != 3:
                raise InvalidConfigError("pencil decomposition implemented for 3-D arrays")
            self.kind = "pencil"
        else:
            raise InvalidConfigError("mesh must have 1 or 2 axes")

        # the real transform works on the half spectrum (n//2+1 bins) along
        # the last axis: the exchange that splits that axis must divide it
        self._half = self.shape[-1] // 2 + 1
        last_len = self._half if self.real else self.shape[-1]
        sizes = dict(zip(self.axis_names, mesh.mesh.shape))
        if self.kind == "slab":
            p = sizes[self.axis_names[0]]
            needed = {0: p}
            # the exchange splits axis 1: for 2-D real transforms that is
            # the half-spectrum axis
            if ndim == 2:
                if last_len % p:
                    raise InvalidConfigError(
                        f"axis 1 {'half-spectrum ' if self.real else ''}length "
                        f"{last_len} not divisible by mesh size {p}")
            else:
                needed[1] = p
        else:
            p1, p2 = sizes[self.axis_names[0]], sizes[self.axis_names[1]]
            # axis 1 is split by p2 on input and by p1 mid-transform
            needed = {0: p1}
            if last_len % p2:
                raise InvalidConfigError(
                    f"axis 2 {'half-spectrum ' if self.real else ''}length "
                    f"{last_len} not divisible by mesh size {p2}")
            if self.shape[1] % p1 or self.shape[1] % p2:
                raise InvalidConfigError(
                    f"axis 1 length {self.shape[1]} must divide by both mesh sizes {p1},{p2}")
        for ax, p in needed.items():
            if self.shape[ax] % p:
                raise InvalidConfigError(
                    f"axis {ax} length {self.shape[ax]} not divisible by mesh size {p}")
        if mesh.get_coordinate() is None:
            raise InvalidConfigError(
                f"rank {dist.get_rank()} is not in the mesh "
                f"{mesh.mesh.tolist()}")
        self.plans = {i: plan_axis(self.shape[i]) for i in range(ndim)}
        self._engine_name = engine or (
            "cuda" if mesh.device_type == "cuda" else "torch")
        self._eng = api.get_engine(self._engine_name)
        self._xchg = [_Exchange(mesh, d) for d in range(mesh.ndim)]
        # slab tail fusion: the two minor axes are both rank-local, one
        # pair kernel a rank (one local read and write less)
        self._tail_pair = self._pair_ok(torch.float32)

    def _pair_ok(self, dtype) -> bool:
        ok = getattr(self._eng, "pair_supports", None)
        return (ok is not None and self.kind == "slab"
                and len(self.shape) >= 3 and not self.real
                and ok(self.shape[-2], self.shape[-1], dtype))

    # -- sharding specs ----------------------------------------------------

    def input_spec(self) -> tuple:
        """DTensor placements of the operand, one per mesh axis: the
        JAX package's ``P(name, None, ...)`` (slab) and ``P(x, y, None)``
        (pencil).  Operands have rank exactly ``len(shape)``."""
        if self.kind == "slab":
            return (Shard(0),)
        return (Shard(0), Shard(1))

    def output_spec(self) -> tuple:
        if self.transpose_back:
            return self.input_spec()
        if self.kind == "slab":
            return (Shard(1),)
        return (Shard(1), Shard(2))

    def spectrum_shape(self) -> tuple:
        """Global shape of the forward result (the half spectrum when
        real)."""
        return self.shape[:-1] + (self._half,) if self.real else self.shape

    def local_shape(self, placements, shape=None) -> tuple:
        shape = self.shape if shape is None else tuple(shape)
        sl = _slices(self.mesh, shape, placements)
        return tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))

    # -- implementation ----------------------------------------------------

    def _fft(self, x: Planar, axis: int, inverse: bool, owned: bool) -> Planar:
        scale = 1.0 / self.shape[axis] if inverse and self.normalize else 1.0
        return self._eng.fft_axis_p(x, axis, self.plans[axis], inverse,
                                    donate=owned, scale=scale)

    def _rfft(self, t: torch.Tensor) -> Planar:
        # rfft reads a Planar's real plane and returns a Planar
        return r2c.rfft(Planar(t, t), axis=-1, engine=self._engine_name)

    def _irfft(self, x: Planar) -> torch.Tensor:
        # irfft scales its own axis by 1/n (numpy), normalized or not, as
        # the JAX package's real inverse does
        return r2c.irfft(x, n=self.shape[-1], axis=-1,
                         engine=self._engine_name)

    def _tail(self, x, inverse: bool, owned: bool):
        """The rank-local trailing axes: the real axis's rfft first
        (forward) or irfft last (inverse), or the minor pair in one
        kernel where it fuses."""
        ndim = len(self.shape)
        if self.real:
            if not inverse:
                x, owned = self._rfft(x), True
            for ax in range(1, ndim - 1):
                x, owned = self._fft(x, ax, inverse, owned), True
            return self._irfft(x) if inverse else x
        last = ndim
        if self._pair_ok(x.dtype):
            ny, nz = self.shape[-2:]
            scale = 1.0 / (ny * nz) if inverse and self.normalize else 1.0
            x = self._eng.fft_pair_p(x, ny, nz, inverse, donate=owned,
                                     scale=scale)
            last, owned = ndim - 2, True
        for ax in range(1, last):
            x, owned = self._fft(x, ax, inverse, owned), True
        return x

    def _fwd(self, x):
        """Forward on a local shard: `Planar` planes, or the real tensor
        of a real transform; `Planar` planes out."""
        oc, X = self.overlap_chunks, self._xchg
        ndim = len(self.shape)
        fft = lambda ax: lambda c: self._fft(c, ax, False, True)
        if self.kind == "slab":
            # (X/P, Y, Z, ...): the trailing axes, the exchange, axis 0,
            # chunked along the last axis (untouched by both) from 3-D
            x = self._tail(x, False, False)
            x = _overlapped(x, ndim - 1, oc if ndim >= 3 else 1, X[0], 1, 0,
                            post=fft(0))
            if self.transpose_back:
                x = X[0].run(x, 0, 1)
            return x
        # pencil, (X/P1, Y/P2, Z): each exchange and FFT chunked along its
        # free axis (0 for z<->y, 2 for y<->x)
        x = self._rfft(x) if self.real else self._fft(x, 2, False, False)
        x = _overlapped(x, 0, oc, X[1], 2, 1, post=fft(1))
        x = _overlapped(x, 2, oc, X[0], 1, 0, post=fft(0))
        if self.transpose_back:
            x = X[1].run(X[0].run(x, 0, 1), 1, 2)
        return x

    def _inv(self, x: Planar):
        """Inverse on a local spectrum shard: the exact reverse of `_fwd`'s
        dataflow; `Planar` planes out, or the real tensor of a real
        transform."""
        oc, X = self.overlap_chunks, self._xchg
        ndim = len(self.shape)
        owned = False
        if self.transpose_back:
            if self.kind == "slab":
                x = X[0].run(x, 1, 0)
            else:
                x = X[0].run(X[1].run(x, 2, 1), 1, 0)
            owned = True
        fft = lambda ax, own: lambda c: self._fft(c, ax, True, own)
        if self.kind == "slab":
            x = _overlapped(x, ndim - 1, oc if ndim >= 3 else 1, X[0], 0, 1,
                            pre=fft(0, owned))
            return self._tail(x, True, True)
        x = _overlapped(x, 2, oc, X[0], 0, 1, pre=fft(0, owned))
        x = _overlapped(x, 0, oc, X[1], 1, 2, pre=fft(1, True))
        return self._irfft(x) if self.real else self._fft(x, 2, True, True)

    def _check_local(self, x, placements, shape) -> None:
        got = _global_shape(x)
        if len(got) != len(self.shape):
            raise InvalidConfigError(
                f"DistributedFFT operands must have rank {len(self.shape)} "
                f"(the global transform shape {self.shape}); got rank "
                f"{len(got)}.  Fold batch dims into axis 0 or vmap.")
        want = self.local_shape(placements, shape)
        if got != want:
            raise InvalidConfigError(
                f"local shard of shape {got}; this rank's shard of "
                f"{tuple(shape)} under {placements} is {want}")

    def _forward_planes(self, x) -> Planar:
        self._check_local(x, self.input_spec(), self.shape)
        if self.real:
            t = x.re if isinstance(x, Planar) else x
            if t.is_complex():
                raise TypeError("prfftn input must be real")
            return self._fwd(t)
        return self._fwd(x if isinstance(x, Planar) else from_complex(x))

    def forward(self, x):
        """Forward transform of this rank's shard (`input_spec`): a
        `Planar` gives a `Planar` (a real transform reads its real plane),
        a tensor a complex tensor, of this rank's shard of the spectrum
        (`output_spec`)."""
        y = self._forward_planes(x)
        return y if isinstance(x, Planar) else to_complex(y)

    def inverse(self, x):
        """Inverse transform of this rank's spectrum shard (`output_spec`)
        back to its shard of the input sharding: `Planar` in, `Planar`
        out, a complex tensor in, a complex tensor out; a real transform
        returns a real tensor."""
        self._check_local(x, self.output_spec(), self.spectrum_shape())
        y = self._inv(x if isinstance(x, Planar) else from_complex(x))
        if self.real or isinstance(x, Planar):
            return y
        return to_complex(y)

    def shard_input(self, x):
        """This rank's shard (`input_spec`) of a global tensor, host array
        or `Planar` every rank holds, or of a ``DTensor``."""
        return _local_of(x, self.mesh, self.input_spec())

    def shard_spectrum(self, X):
        """This rank's shard (`output_spec`) of a global spectrum."""
        return _local_of(X, self.mesh, self.output_spec())


# -- functional facade ------------------------------------------------------

@functools.lru_cache(maxsize=128)
def _dist_for(shape, mesh, engine, transpose_back, overlap_chunks=1,
              real=False) -> DistributedFFT:
    return DistributedFFT(shape, mesh, engine=engine,
                          transpose_back=transpose_back,
                          overlap_chunks=overlap_chunks, real=real)


def pfftn(x, mesh: DeviceMesh, engine: Optional[str] = None,
          transpose_back: bool = False, overlap_chunks: int = 1):
    """Distributed forward N-D FFT of a global array (a tensor or host
    array every rank holds, or a ``DTensor``) over ``mesh``; the spectrum
    as a ``DTensor`` in the transform's output sharding."""
    app = _dist_for(_global_shape(x), mesh, engine, transpose_back,
                    overlap_chunks)
    y = app.forward(app.shard_input(x))
    return _as_dtensor(y, mesh, app.output_spec(), app.shape)


def pifftn(x, mesh: DeviceMesh, engine: Optional[str] = None,
           transpose_back: bool = False, overlap_chunks: int = 1):
    """Distributed inverse N-D FFT.  A global spectrum is taken with the
    expected *spectrum* sharding (`output_spec`), mirroring `pfftn`."""
    app = _dist_for(_global_shape(x), mesh, engine, transpose_back,
                    overlap_chunks)
    y = app.inverse(app.shard_spectrum(x))
    return _as_dtensor(y, mesh, app.input_spec(), app.shape)


def prfftn(x, mesh: DeviceMesh, engine: Optional[str] = None,
           transpose_back: bool = False, overlap_chunks: int = 1):
    """Distributed forward N-D *real* FFT: a local rfft over the
    (rank-local) last axis first, so every exchange moves the half
    spectrum, about half the bytes of embedding the data in a complex
    transform.  Returns the (..., n//2+1) half spectrum in the transform's
    output sharding."""
    app = _dist_for(_global_shape(x), mesh, engine, transpose_back,
                    overlap_chunks, True)
    y = app.forward(app.shard_input(x))
    return _as_dtensor(y, mesh, app.output_spec(), app.spectrum_shape())


def pirfftn(X, shape: tuple[int, ...], mesh: DeviceMesh,
            engine: Optional[str] = None, transpose_back: bool = False,
            overlap_chunks: int = 1):
    """Distributed inverse real FFT.  ``shape`` is the global *real* shape
    (the last axis is ambiguous from the half spectrum, like numpy's
    ``irfft(n=...)``)."""
    app = _dist_for(tuple(shape), mesh, engine, transpose_back,
                    overlap_chunks, True)
    y = app.inverse(app.shard_spectrum(X))
    return _as_dtensor(y, mesh, app.input_spec(), app.shape)


def pfft(x, mesh: DeviceMesh, engine: Optional[str] = None):
    """Batch-sharded 1-D FFT along the last axis: the leading batch dim
    sharded over the mesh's first axis (replicated over any other), no
    communication: the embarrassingly parallel layer (reference analog:
    threadblock-grid batch parallelism, ``vkFFT_RunApp.h:144-147``)."""
    shape = _global_shape(x)
    p = mesh.size(0)
    if shape[0] % p:
        raise InvalidConfigError(
            f"axis 0 length {shape[0]} not divisible by mesh size {p}")
    spec = (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)
    local = _local_of(x, mesh, spec)
    planes = local if isinstance(local, Planar) else from_complex(local)
    eng = api.get_engine(engine or (
        "cuda" if mesh.device_type == "cuda" else "torch"))
    y = eng.fft_axis_p(planes, planes.ndim - 1, plan_axis(shape[-1]), False)
    return _as_dtensor(y if isinstance(local, Planar) else to_complex(y),
                       mesh, spec, shape)


class DistributedConvolution:
    """Distributed frequency-domain convolution over a device mesh.

    The distributed rendition of the reference's fused convolution pipeline
    (``performConvolution``, ``vkFFT_FFT.h:241-351``): forward transform
    kept in the transposed sharding, spectrum multiply there
    (sharding-aligned: no collective), inverse transform.  Because forward
    and inverse share the ``transpose_back=False`` contract, the
    convolution pays no reorder exchange, the distributed analog of
    ``disableReorderFourStep`` (README.md:16).

    ``kernel`` and the operands are global (every rank holds them) or
    ``DTensor``s; ``real=True`` convolves real data with a real kernel
    through the half-spectrum pipeline (about half the exchanged bytes).
    """

    def __init__(self, shape: tuple[int, ...], mesh: DeviceMesh, kernel,
                 engine: Optional[str] = None, overlap_chunks: int = 1,
                 real: bool = False):
        self.fft = DistributedFFT(shape, mesh, engine=engine,
                                  transpose_back=False, normalize=True,
                                  overlap_chunks=overlap_chunks, real=real)
        kshape = _global_shape(kernel)
        if kshape != tuple(shape):
            raise InvalidConfigError(
                f"kernel shape {kshape} must equal transform shape {tuple(shape)}")
        self.kernel_f = self.fft._forward_planes(self.shard_input(kernel))

    def shard_input(self, x):
        return self.fft.shard_input(x)

    def __call__(self, x):
        """The convolution of a global operand (or ``DTensor``), as a
        ``DTensor`` in the input sharding: real for ``real=True``, a
        `Planar` of two for `Planar` input, else complex."""
        f = self.fft
        local = self.shard_input(x)
        y = f._inv(f._forward_planes(local) * self.kernel_f)
        if not f.real and not isinstance(local, Planar):
            y = to_complex(y)
        return _as_dtensor(y, f.mesh, f.input_spec(), f.shape)
