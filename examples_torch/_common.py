"""Shared example plumbing: the device the examples run on.

The examples run on the GPU.  ``VKFFT_TPU_TORCH_EXAMPLES_CPU=1`` (after the
JAX examples' ``VKFFT_TPU_EXAMPLES_CPU``) sends them to the CPU, where the
port runs its plain torch engine; without it and without a GPU they fail
rather than fall back."""
import os


def setup():
    """The torch device of the examples: the CPU when
    VKFFT_TPU_TORCH_EXAMPLES_CPU=1 (used by the tests), else the GPU."""
    import torch

    if os.environ.get("VKFFT_TPU_TORCH_EXAMPLES_CPU") == "1":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the examples run on the GPU "
                         "(VKFFT_TPU_TORCH_EXAMPLES_CPU=1 runs them on the CPU)")
    return torch.device("cuda")


def host(a):
    """A numpy array of a result: numpy, a torch tensor on any device, or
    planes."""
    import numpy as np
    import torch

    from vkfft_tpu_torch.pcomplex import Planar, to_numpy

    if isinstance(a, Planar):
        return to_numpy(a)
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel_err(got, ref):
    import numpy as np

    ref = host(ref)
    denom = np.abs(ref).max() or 1.0
    return np.abs(host(got) - ref).max() / denom
