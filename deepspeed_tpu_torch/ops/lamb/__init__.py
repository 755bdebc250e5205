"""LAMB (port of ``deepspeed_tpu/ops/lamb``)."""

from deepspeed_tpu_torch.ops.lamb.fused_lamb import (
    FusedLamb, LambState, init_lamb_state, lamb_step_, lamb_update)

__all__ = ["FusedLamb", "LambState", "init_lamb_state", "lamb_step_",
           "lamb_update"]
