"""Process groups and tensor parallelism (port of
``deepspeed_tpu/parallel``): the bootstrap and the mesh's process groups
(:mod:`~deepspeed_tpu_torch.parallel.mesh`), the collectives of the
model axis (:mod:`~deepspeed_tpu_torch.parallel.collectives`), the
Megatron layers (:mod:`~deepspeed_tpu_torch.parallel.tensor_parallel`)
and the tensor-parallel pipeline blocks
(:mod:`~deepspeed_tpu_torch.parallel.pipe_tp`,
:mod:`~deepspeed_tpu_torch.parallel.pipe_auto`)."""

from deepspeed_tpu_torch.parallel.mesh import (  # noqa: F401
    AxisGroup,
    MeshGroups,
    destroy_distributed,
    dp_rank,
    dp_world_size,
    initialize_distributed,
)
