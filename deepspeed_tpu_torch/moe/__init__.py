"""Mixture-of-Experts with expert parallelism (port of
``deepspeed_tpu/moe``): the routing, the expert-parallel MoE block
(:mod:`~deepspeed_tpu_torch.moe.layer`) and its pipeline body layer
(:mod:`~deepspeed_tpu_torch.moe.expert_pipe`)."""

from deepspeed_tpu_torch.moe.layer import (  # noqa: F401
    MoE,
    MoEConfig,
    compute_capacity,
    moe_param_spec,
    top_k_gating,
)

__all__ = ["MoE", "MoEConfig", "compute_capacity", "moe_param_spec",
           "top_k_gating"]
