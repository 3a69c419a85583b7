"""Distributed FFTs over a ``torch.distributed`` device mesh (port of
``vkfft_tpu/parallel``): `mesh` builds the meshes and the process group,
`pencil` the slab and pencil decompositions, the facades and the
distributed convolution.  ``vkfft_tpu_torch`` does not import it."""
from vkfft_tpu_torch.parallel.mesh import (
    fft_mesh,
    hybrid_fft_mesh,
    initialize_distributed,
)
from vkfft_tpu_torch.parallel.pencil import (
    DistributedConvolution,
    DistributedFFT,
    pfft,
    pfftn,
    pifftn,
    pirfftn,
    prfftn,
)
