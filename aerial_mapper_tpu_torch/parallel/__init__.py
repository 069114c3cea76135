"""parallel: see the twin package under aerial_mapper_tpu/parallel/. A mesh
runs in one process, or across the ranks of a ``torch.distributed`` group
(``distributed.initialize_distributed`` or ``torchrun``; the drivers then
build their meshes over every rank's devices). Patch
``parallel.mesh.default_devices`` itself to run logical shards."""

from aerial_mapper_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from aerial_mapper_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange_extended,
    halo_exchange_rows,
)
from aerial_mapper_tpu_torch.parallel.sharded import (  # noqa: F401
    BandedImages,
    RingPairOperands,
    band_image_operands,
    prepare_ring_pair_operands,
    shard_layers,
    sharded_backward_grid_update,
    sharded_dsm_update,
    sharded_map_step,
    unshard_layers,
)
