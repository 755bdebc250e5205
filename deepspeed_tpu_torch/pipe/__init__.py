"""Pipeline-parallelism public surface (port of ``deepspeed_tpu/pipe``,
the reference's ``deepspeed/pipe/__init__.py``)."""

from deepspeed_tpu_torch.runtime.pipe.module import (
    LayerSpec,
    PipelineModule,
    TiedLayerSpec,
)

__all__ = ["PipelineModule", "LayerSpec", "TiedLayerSpec"]
