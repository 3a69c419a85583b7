"""Multi-GPU distributed 3-D FFT over a device mesh.

No reference analog — VkFFT is single-GPU (its README lists multi-GPU as
future work); this is the framework's flagship extension.  The
decomposition is the classic slab/pencil scheme: shard one (slab) or two
(pencil) axes over the mesh, transform rank-local axes with the regular
kernels, and re-decompose with one ``all_to_all`` a mesh axis between
passes.

One process a rank, brought up by ``initialize_distributed`` with an
explicit coordinator, world size and rank: on the GPU a NCCL world of one
rank a visible card; with ``VKFFT_TPU_TORCH_EXAMPLES_CPU=1`` a gloo world of
8 ranks on the CPU (the JAX example's 8 virtual devices).  The twin of
``examples/ex09_distributed_mesh.py`` on the PyTorch port."""
import datetime
import math
import os
import sys
import tempfile

import numpy as np

from _common import host, setup, rel_err

SHAPE = (64, 32, 128)
CPU_WORLD = 8
JOIN_S = 300          # a hung collective fails the example


def pencil_sizes(world: int) -> tuple:
    """The most square (a, b) mesh of ``world`` ranks, a <= b."""
    a = max(d for d in range(1, math.isqrt(world) + 1) if world % d == 0)
    return a, world // a


def rank_main(rank: int, world: int, store: str, device_type: str) -> None:
    """One rank: the example's flow, each result gathered whole and held
    against numpy on every rank."""
    import torch
    import torch.distributed as dist

    from vkfft_tpu_torch import parallel

    torch.set_num_threads(1)
    parallel.initialize_distributed(
        f"file://{store}", world, rank, device_type=device_type,
        timeout=datetime.timedelta(seconds=JOIN_S))
    say = print if rank == 0 else (lambda *a, **k: None)

    rng = np.random.default_rng(8)
    x = (rng.standard_normal(SHAPE)
         + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)

    # 1-D mesh -> slab decomposition (one sharded axis)
    mesh = parallel.fft_mesh((world,), device_type=device_type)
    X = parallel.pfftn(x, mesh)
    err = rel_err(X.full_tensor(), np.fft.fftn(x))
    say(f"slab pfftn over {tuple(mesh.shape)} rel err {err:.2e}")
    assert err < 2e-6

    # 2-D mesh -> pencil decomposition (two sharded axes)
    mesh2 = parallel.fft_mesh(pencil_sizes(world), axis_names=("x", "y"),
                              device_type=device_type)
    X2 = parallel.pfftn(x, mesh2)
    err = rel_err(X2.full_tensor(), np.fft.fftn(x))
    say(f"pencil pfftn over {tuple(mesh2.shape)} rel err {err:.2e}")
    assert err < 2e-6

    # roundtrip through the distributed inverse
    z = parallel.pifftn(X2, mesh2)
    assert rel_err(z.full_tensor(), x) < 2e-6

    # distributed REAL transform: the local rfft runs before any all_to_all,
    # so the interconnect moves the half spectrum (~half the bytes)
    xr = rng.standard_normal(SHAPE).astype(np.float32)
    Xr = parallel.prfftn(xr, mesh)
    err = rel_err(Xr.full_tensor(), np.fft.rfftn(xr))
    say(f"slab prfftn rel err {err:.2e}  (half spectrum {tuple(Xr.shape)})")
    assert err < 2e-6
    back = parallel.pirfftn(Xr, SHAPE, mesh)
    assert rel_err(back.full_tensor(), xr) < 2e-6

    # distributed convolution: spectrum multiply in the transposed sharding —
    # zero reorder collectives (the distributed disableReorderFourStep)
    kr = rng.standard_normal(SHAPE).astype(np.float32)
    conv = parallel.DistributedConvolution(SHAPE, mesh, kr, real=True)
    got = host(conv(xr).full_tensor())
    ref = np.fft.irfftn(np.fft.rfftn(xr) * np.fft.rfftn(kr),
                        s=SHAPE, axes=(0, 1, 2))
    err = rel_err(got, ref)
    say(f"distributed real convolution rel err {err:.2e}")
    assert err < 2e-6

    # multi-host sketch (torchrun on each host sets the rendezvous):
    #   parallel.initialize_distributed()      # reads torchrun's environment
    #   mesh = parallel.hybrid_fft_mesh((1, gpus), (hosts, 1))
    #   X = parallel.pfftn(x, mesh, overlap_chunks=4)   # a2a/compute overlap
    dist.destroy_process_group()


def main():
    import torch
    import torch.multiprocessing as mp

    dev = setup()
    device_type = dev.type
    world = CPU_WORLD if device_type == "cpu" else torch.cuda.device_count()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, os.path.join(tmp, "store"),
                                   device_type))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(JOIN_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    print(f"{device_type} world of {world}: exit codes {codes}")
    if codes != [0] * world:
        sys.exit(1)
    print("ok")


if __name__ == "__main__":
    main()
