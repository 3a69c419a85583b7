"""Device-mesh helpers for distributed FFTs on ``torch.distributed``.

Port of ``vkfft_tpu/parallel/mesh.py``.  The reference is single-device and
lists multi-GPU splitting as future work (README.md:24-25); the JAX package
made the distributed layer first-class on a ``jax.sharding.Mesh``.  Here the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's
ranks, one process per GPU: each named mesh axis has its process group, and
the decompositions of `pencil` exchange over those groups with
``all_to_all_single`` (NCCL on GPUs, gloo on the CPU).

Building a mesh is collective: every rank of the world builds the same
meshes in the same order, including ranks the mesh leaves out.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vkfft_tpu_torch import api

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# torchrun's environment (RANK and WORLD_SIZE with MASTER_ADDR/PORT)
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _world_ranks(ranks) -> list:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() (torchrun, or "
            "an explicit coordinator) or torch.distributed."
            "init_process_group() before building a mesh")
    return list(range(dist.get_world_size())) if ranks is None else [
        int(r) for r in ranks]


def _device_mesh(device_type: str, rank_array: np.ndarray,
                 axis_names: Sequence[str]) -> DeviceMesh:
    if device_type == "cuda":
        api.resolve_device("cuda")   # raises without a GPU
    return DeviceMesh(device_type, torch.as_tensor(rank_array),
                      mesh_dim_names=tuple(axis_names))


def fft_mesh(axis_sizes: Optional[Sequence[int]] = None,
             axis_names: Sequence[str] = ("fft",), ranks=None,
             device_type: str = "cuda") -> DeviceMesh:
    """Build a mesh for distributed FFTs over ``ranks`` (the world's, in
    order, by default).

    With the default 1-axis layout, all ranks form one ring used for slab
    decomposition; pass two sizes (e.g. ``(4, 2)``) with names like
    ``("x", "y")`` for pencil decomposition.  Collective: every rank of the
    world calls it, those outside ``ranks`` too.
    """
    ranks = _world_ranks(ranks)
    n = len(ranks)
    if axis_sizes is None:
        axis_sizes = (n,) if len(axis_names) == 1 else None
    if axis_sizes is None or int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis_sizes {axis_sizes} must multiply to {n} devices")
    return _device_mesh(device_type,
                        np.asarray(ranks).reshape(tuple(axis_sizes)),
                        axis_names)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device_type: str = "cuda", **kwargs) -> bool:
    """Bring up the default process group, one process per GPU: NCCL for
    ``device_type="cuda"`` (the process's current device set to
    ``LOCAL_RANK``, or the rank modulo the GPUs of the host), gloo for
    ``"cpu"``.  Idempotent; a single process with no launcher environment
    is a no-op that returns False.

    Without arguments it reads torchrun's environment (``torchrun
    --nproc-per-node=N``); else ``coordinator_address`` ("host:port" or a
    URL such as ``file:///...``) is the ``init_method`` (torchrun's
    MASTER_ADDR/MASTER_PORT when None), ``num_processes`` the world size
    and ``process_id`` the rank (torchrun's WORLD_SIZE and RANK when
    None).  ``kwargs`` go to ``init_process_group`` (``timeout``, ...).
    Returns True when the process group is (already) initialized.
    """
    if dist.is_initialized():
        return True
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None or kwargs)
    if not explicit and not all(os.environ.get(k) for k in _LAUNCHER_ENV):
        return False
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r} is not one of "
                         f"{sorted(BACKENDS)}")
    rank = os.environ.get("RANK") if process_id is None else process_id
    world = (os.environ.get("WORLD_SIZE") if num_processes is None
             else num_processes)
    if rank is None or world is None:
        raise ValueError(
            "initialize_distributed needs the rank and the world size: "
            "process_id and num_processes, or torchrun's RANK and WORLD_SIZE")
    if device_type == "cuda":
        api.resolve_device("cuda")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else int(rank) % torch.cuda.device_count())
    init = coordinator_address or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(BACKENDS[device_type], init_method=init,
                            world_size=int(world), rank=int(rank), **kwargs)
    return True


def hybrid_fft_mesh(ici_axis_sizes: Sequence[int],
                    dcn_axis_sizes: Sequence[int],
                    axis_names: Sequence[str] = ("x", "y"), ranks=None,
                    device_type: str = "cuda") -> DeviceMesh:
    """Mesh whose axes factor as (DCN x ICI): axis i spans
    ``dcn_axis_sizes[i] * ici_axis_sizes[i]`` ranks, with the DCN (slow,
    inter-host) factor outermost so collectives along the *inner* mesh
    axes stay inside a host (NVLink).  For a pencil 3-D FFT across hosts,
    put the host dimension on axis 0: ``hybrid_fft_mesh((1, gpus), (hosts,
    1))`` gives a (hosts, gpus) mesh where the z<->y exchange (mesh axis 1)
    stays on one host and only the y<->x exchange crosses hosts.

    The ranks are laid out by the JAX package's single-process (dcn, ici)
    reshape and transposition (``vkfft_tpu/parallel/mesh.py:110-118``),
    which is exact under torchrun's host-major ranks: each host's
    ``LOCAL_WORLD_SIZE`` ranks, where that is set, must be one ICI block.
    """
    ranks = _world_ranks(ranks)
    ici = tuple(int(s) for s in ici_axis_sizes)
    dcn = tuple(int(s) for s in dcn_axis_sizes)
    if len(ici) != len(dcn) or len(ici) != len(axis_names):
        raise ValueError("ici/dcn axis sizes and names must align")
    total = tuple(a * b for a, b in zip(ici, dcn))
    if int(np.prod(total)) != len(ranks):
        raise ValueError(
            f"mesh {total} (= ici {ici} x dcn {dcn}) needs "
            f"{int(np.prod(total))} devices, have {len(ranks)}")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(np.prod(ici)) != int(local):
        raise ValueError(
            f"ici {ici} holds {int(np.prod(ici))} ranks, a host has "
            f"LOCAL_WORLD_SIZE={local}")
    rank_array = np.asarray(ranks).reshape(dcn + ici)
    order = [i for pair in zip(range(len(dcn)),
                               range(len(dcn), 2 * len(dcn)))
             for i in pair]
    rank_array = rank_array.transpose(order).reshape(total)
    return _device_mesh(device_type, rank_array, axis_names)
