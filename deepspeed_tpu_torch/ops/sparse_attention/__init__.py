"""Block-sparse attention ops (port of
``deepspeed_tpu/ops/sparse_attention/``; ``SparseAttentionUtils`` is not
yet ported)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    VariableSparsityConfig,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    block_sparse_attention,
    build_lut,
    masked_dense_attention,
)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention,
)
from deepspeed_tpu_torch.ops.sparse_attention.bert_sparse_self_attention import (
    BertSparseSelfAttention,
)
