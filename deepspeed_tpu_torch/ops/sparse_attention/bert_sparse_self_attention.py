"""BertSparseSelfAttention: drop-in sparse replacement for a BERT
self-attention sub-module (port of
``deepspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py``).

Analog of the reference's ``BertSparseSelfAttention``
(`deepspeed/ops/sparse_attention/bert_sparse_self_attention.py:9-78`):
BERT-named query/key/value projections feeding the layout-driven
:class:`SparseSelfAttention` core, taking the standard BERT additive
attention mask.
"""

from types import SimpleNamespace

import torch
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import Dense
from deepspeed_tpu_torch.ops.flash_attention import current_global_rows
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention,
    collapse_additive_mask,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig,
)


class BertSparseSelfAttention(nn.Module):
    """``forward(hidden_states, attention_mask, dropout_seed)`` ->
    context [B, T, hidden].

    ``num_attention_heads`` must divide ``hidden_size``;
    ``attention_mask`` is the BERT additive key-padding mask
    broadcastable to [B, 1, 1, T] (0 keep / large-negative pad), or
    None. Attention-prob dropout runs in the sparse core when a
    ``dropout_seed`` (an int) is given and ``attn_dropout_ratio > 0``.
    """

    def __init__(self, hidden_size, num_attention_heads, sparsity_config=None,
                 dtype=torch.float32, attn_dropout_ratio=0.0, device=None):
        super().__init__()
        assert hidden_size % num_attention_heads == 0, (
            f"hidden_size {hidden_size} not a multiple of heads "
            f"{num_attention_heads}")
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.attn_dropout_ratio = attn_dropout_ratio
        cfg = sparsity_config or FixedSparsityConfig(
            num_heads=num_attention_heads)
        self.core = SparseSelfAttention(cfg, key_padding_mask_mode="add")
        # flax nn.Dense(dtype=...) over fp32 params, lecun-normal init
        dtypes = SimpleNamespace(dtype=dtype, param_dtype=torch.float32)
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(hidden_size, hidden_size, dtypes,
                                      device))
            getattr(self, name).reset_parameters()

    def forward(self, hidden_states, attention_mask=None, dropout_seed=None):
        B, T, H = hidden_states.shape
        heads = self.num_attention_heads

        def heads_first(t):  # [B, T, H] -> [B, heads, T, hd]
            return t.reshape(B, T, heads, H // heads).transpose(1, 2)

        key_padding_mask = None
        if attention_mask is not None:
            key_padding_mask = collapse_additive_mask(attention_mask, B, T)
        rate, seed, offset = 0.0, None, 0
        if dropout_seed is not None and self.attn_dropout_ratio > 0.0:
            rate, seed = self.attn_dropout_ratio, dropout_seed
            offset = current_global_rows()[0] * heads
        ctx = self.core(heads_first(self.query(hidden_states)),
                        heads_first(self.key(hidden_states)),
                        heads_first(self.value(hidden_states)),
                        key_padding_mask=key_padding_mask,
                        dropout_rate=rate, dropout_seed=seed,
                        dropout_head_offset=offset)
        return ctx.transpose(1, 2).reshape(B, T, H)
