"""TP attention and an expert-parallel MoE FFN in one pipeline block:
pipe x model x expert x data (port of
``deepspeed_tpu/parallel/pipe_tp_moe.py``).

:class:`TPMoEBlockLayer` runs the attention half tensor parallel over
the ``model`` group (column QKV, the rank's heads, row projection:
``parallel/pipe_tp.py``) and the FFN half as
:class:`~deepspeed_tpu_torch.moe.expert_pipe.ExpertParallelFFNLayer`
over the ``expert`` group. Each axis's collectives wrap exactly the
tensors that compute sharded on that axis consumes: over ``model`` only
the attention path is split (``replicated_input`` / ``row_parallel``),
the MoE half is replicated there; over ``expert`` only the FFN path is
split (its ``psum_grad`` / ``psum_combine``), the attention half is
replicated there. So the composition needs no new collective.

Leaves (JAX's names, flat): ``ln1_scale`` / ``ln1_bias``, ``mp_qkv``
``[3 * H/M * D, M]`` (head-major rows of this model rank), ``mp_qkv_b``,
``mp_proj`` ``[H/M * D, M]``, ``proj_b``, then the FFN's ``ln_scale``,
``ln_bias``, ``gate`` and ``expert_*`` banks. Used through
``tp_pipeline_module(..., block_cls=TPMoEBlockLayer, moe=...)``.
Activations may be ``(hidden, aux)`` tuples, as in the FFN layer. No
dropout (as in JAX).
"""

import torch
from torch import nn

from deepspeed_tpu_torch.moe.expert_pipe import ExpertParallelFFNLayer
from deepspeed_tpu_torch.moe.layer import MoEConfig
from deepspeed_tpu_torch.parallel.pipe_tp import (
    column_parallel,
    current_axis,
    layer_norm,
    local_attention,
    replicated_input,
    row_parallel,
    split_qkv_heads,
)
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    set_shard,
    shard_tensor,
)


class TPMoEBlockLayer(ExpertParallelFFNLayer):
    """Pre-LN causal block: TP attention + MoE FFN (module docstring).
    ``n_head`` must divide by the model group's size."""

    causal = True

    def __init__(self, d_model, n_head, hidden_dim=None,
                 moe: MoEConfig = None, model_axis="model",
                 expert_axis="expert", use_flash=False):
        super().__init__(d_model, hidden_dim or 4 * d_model, moe,
                         expert_axis)
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} does not divide by n_head "
                             f"{n_head}")
        self.tp = current_axis(model_axis)
        mp = 1 if self.tp is None else self.tp.size
        if n_head % mp:
            raise ValueError(f"n_head {n_head} does not divide the model "
                             f"axis ({mp})")
        self.d_model, self.n_head, self.use_flash = d_model, n_head, \
            use_flash
        D = d_model // n_head
        self.attn_full = {"mp_qkv": (3 * n_head * D, d_model),
                          "mp_proj": (n_head * D, d_model)}
        local = {"mp_qkv": (3 * n_head // mp * D, d_model),
                 "mp_qkv_b": (3 * n_head // mp * D,),
                 "mp_proj": (n_head // mp * D, d_model)}
        self.ln1_scale = nn.Parameter(torch.ones(d_model))
        self.ln1_bias = nn.Parameter(torch.zeros(d_model))
        for name, shape in local.items():
            p = nn.Parameter(torch.zeros(shape))
            if self.tp is not None:
                set_shard(p, Shard(0))
                p.tp_axis = self.tp
            self.register_parameter(name, p)
        self.proj_b = nn.Parameter(torch.zeros(d_model))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The attention kernels N(0, 0.02) drawn whole, each model rank
        keeping its rows, then the FFN's (its own order)."""
        for name, shape in self.attn_full.items():
            full = torch.empty(shape)
            nn.init.normal_(full, 0.0, 0.02, generator=generator)
            getattr(self, name).copy_(full if self.tp is None else
                                      shard_tensor(full, Shard(0),
                                                   self.tp.rank,
                                                   self.tp.size))
        self.mp_qkv_b.zero_()
        self.proj_b.zero_()
        self.ln1_scale.fill_(1.0)
        self.ln1_bias.zero_()
        super().reset_parameters(generator)

    def forward(self, x, ctx=None):
        aux_in = None
        if isinstance(x, tuple):
            x, aux_in = x
        dtype = x.dtype
        D = self.d_model // self.n_head
        h = layer_norm(x, self.ln1_scale, self.ln1_bias).to(dtype)
        qkv = column_parallel(replicated_input(h, self.tp), self.mp_qkv,
                              self.mp_qkv_b)
        q, k, v = split_qkv_heads(qkv, D)
        y = local_attention(q, k, v, causal=self.causal,
                            use_flash=self.use_flash)
        x = x + row_parallel(y, self.mp_proj, self.proj_b, self.tp)
        return super().forward(x if aux_in is None else (x, aux_in), ctx)
