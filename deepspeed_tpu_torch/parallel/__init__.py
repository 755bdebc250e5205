"""Process groups and the parallel layers (port of
``deepspeed_tpu/parallel``): the bootstrap and the mesh's process groups
(:mod:`~deepspeed_tpu_torch.parallel.mesh`), the collectives
(:mod:`~deepspeed_tpu_torch.parallel.collectives`), the Megatron layers
(:mod:`~deepspeed_tpu_torch.parallel.tensor_parallel`), ring and
Ulysses attention (:mod:`~deepspeed_tpu_torch.parallel.sequence`), and
the pipeline blocks: tensor parallel
(:mod:`~deepspeed_tpu_torch.parallel.pipe_tp`,
:mod:`~deepspeed_tpu_torch.parallel.pipe_auto`), sequence parallel
(:mod:`~deepspeed_tpu_torch.parallel.pipe_sp`) and TP x expert
(:mod:`~deepspeed_tpu_torch.parallel.pipe_tp_moe`)."""

from deepspeed_tpu_torch.parallel.mesh import (  # noqa: F401
    AxisGroup,
    MeshGroups,
    destroy_distributed,
    dp_rank,
    dp_world_size,
    initialize_distributed,
)
from deepspeed_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    ring_attention_local,
    ulysses_attention,
    ulysses_attention_local,
)
