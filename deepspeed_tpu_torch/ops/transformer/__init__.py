"""The fused BERT-style transformer layer (port of
``deepspeed_tpu/ops/transformer/``)."""

from deepspeed_tpu_torch.ops.transformer.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
