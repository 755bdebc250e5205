"""SparseSelfAttention: layout-driven sparse attention module (port of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

Analog of the reference module (`deepspeed/ops/sparse_attention/
sparse_self_attention.py:13`), which chains SDD matmul -> sparse softmax
-> DSD matmul; here the chain is one fused block-sparse flash-attention
call (`block_sparse_attention.py`). Tensors follow the reference
convention: [batch, heads, seq, head_dim].

Tensor parallelism: with ``model_size`` M > 1 the module runs model rank
``model_rank``'s ``num_heads / M`` heads ``[rank * hl, (rank + 1) *
hl)``: its layout (and so its LUT) is those heads' rows of the whole
layout, which matters under ``different_layout_per_head``, and the
kernels hash dropout at the unsharded head count (the caller's
``dropout_head_offset`` holds the rows before its own times the head
count plus the rank's first head, :attr:`first_head`).
"""

from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    block_sparse_attention,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig,
    SparsityConfig,
)


def collapse_additive_mask(attention_mask, B, T):
    """BERT-style additive mask broadcastable to [B, 1, 1, T] -> the
    [B, T] key-padding mask the sparse core consumes (mode "add")."""
    return attention_mask.float().expand(B, 1, 1, T).reshape(B, T)


class SparseSelfAttention:
    """Efficient sparse self attention (Generative Modeling with Sparse
    Transformers, arXiv:1904.10509).

    ``sparsity_config``: a :class:`SparsityConfig` subclass instance.
    ``key_padding_mask_mode`` / ``attn_mask_mode``: "add" (mask added to
    scores) or "mul" (zeros become -inf) - reference semantics.
    """

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", implementation="auto", model_rank=0,
                 model_size=1):
        if sparsity_config is None:
            sparsity_config = FixedSparsityConfig(num_heads=4)
        assert isinstance(sparsity_config, SparsityConfig)
        self.sparsity_config = sparsity_config
        assert key_padding_mask_mode in ("add", "mul")
        assert attn_mask_mode in ("add", "mul")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.implementation = implementation
        heads = sparsity_config.num_heads
        if heads % model_size:
            raise ValueError(f"sparsity config's {heads} heads do not "
                             f"divide the model axis ({model_size})")
        self.model_size = int(model_size)
        self.local_heads = heads // self.model_size
        self.first_head = int(model_rank) * self.local_heads
        # per-instance layout cache keyed by seq len - the analog of the
        # reference's per-seq-len ops cache (`sparse_self_attention.py:41-66`)
        self._layouts = {}

    def get_layout(self, seq_len):
        """The layout of this module's heads at ``seq_len`` (the whole
        layout's rows ``[first_head, first_head + local_heads)``)."""
        if seq_len not in self._layouts:
            whole = self.sparsity_config.make_layout(seq_len)
            self._layouts[seq_len] = whole[
                self.first_head:self.first_head + self.local_heads]
        return self._layouts[seq_len]

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None, dropout_rate=0.0, dropout_seed=None,
                 dropout_head_offset=0):
        """query/key/value: [B, H, T, D] -> attention context [B, H, T, D].
        ``dropout_rate``/``dropout_seed``: in-kernel attention-prob
        dropout (the counter-based mask of ops/flash_attention.py)."""
        bsz, num_heads, tgt_len, head_dim = query.shape
        if query.shape != key.shape or key.shape != value.shape:
            raise NotImplementedError(
                "only self-attention is supported for now")
        assert num_heads == self.local_heads, (
            f"tensor has {num_heads} heads, sparsity config expects "
            f"{self.local_heads}")

        layout = self.get_layout(tgt_len)
        causal = getattr(self.sparsity_config, "attention",
                         "bidirectional") == "unidirectional"
        out = block_sparse_attention(
            query.transpose(1, 2), key.transpose(1, 2),
            value.transpose(1, 2), layout, self.sparsity_config.block,
            causal=causal,
            sm_scale=float(head_dim) ** -0.5,
            rpe=rpe,
            key_padding_mask=key_padding_mask,
            attn_mask=attn_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask_mode=self.attn_mask_mode,
            implementation=self.implementation,
            dropout_rate=dropout_rate,
            dropout_seed=dropout_seed,
            dropout_head_offset=dropout_head_offset,
            dropout_num_heads=self.sparsity_config.num_heads)
        return out.transpose(1, 2)
