"""Native-op registry (port of ``deepspeed_tpu/ops/op_builder``): the
builder names the JAX package exports, as thin classes over
:mod:`deepspeed_tpu_torch.ops._build`, so code that names them finds
their counterpart here."""

from deepspeed_tpu_torch.ops.op_builder.builder import (
    CPUAdamBuilder, OpBuilder, SparseAttnBuilder, UtilsBuilder)

ALL_OPS = {
    CPUAdamBuilder.NAME: CPUAdamBuilder,
    SparseAttnBuilder.NAME: SparseAttnBuilder,
    UtilsBuilder.NAME: UtilsBuilder,
}

__all__ = ["OpBuilder", "CPUAdamBuilder", "SparseAttnBuilder",
           "UtilsBuilder", "ALL_OPS"]
