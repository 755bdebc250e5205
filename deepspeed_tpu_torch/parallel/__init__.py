"""Process groups for data parallelism (port of ``deepspeed_tpu/parallel``:
the bootstrap only; the JAX package's mesh axes other than ``data`` are
not ported)."""

from deepspeed_tpu_torch.parallel.mesh import (  # noqa: F401
    destroy_distributed,
    dp_rank,
    dp_world_size,
    initialize_distributed,
)
