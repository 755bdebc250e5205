"""DeepSpeedTransformerLayer: the BERT-style transformer block (port of
``deepspeed_tpu/ops/transformer/transformer.py``).

Capability parity with the reference's CUDA transformer kernel
(`deepspeed/ops/transformer/transformer.py:41-111` config,
`csrc/transformer/ds_transformer_cuda.cpp:44-121` layer composition:
QKV GEMM -> attention -> dropouts -> layernorms -> bias-GeLU FFN), in
eager PyTorch. Three attention cores, as in the JAX layer:

- sparse (``sparsity_config``): ``SparseSelfAttention``, the block-sparse
  kernels K7/K8 (`ops/sparse_attention/`), the gather route with a mask;
- flash (``use_flash_attention``, no mask or a key-padding mask):
  ``ops/flash_attention.py:flash_attention`` (K1-K3) with the mask as a
  key bias;
- dense: plain torch softmax attention.

Weight names mirror the reference layer (attn_qkvw/attn_qkvb/attn_ow/
attn_ob/attn_nw/attn_nb/inter_w/inter_b/output_w/output_b/norm_w/norm_b),
matrices in the JAX ``[in, out]`` layout, so the JAX params load 1:1.

Numerics the parity rests on: the layer norm takes a two-pass variance
(``mean((x - mu)^2)``) in fp32, eps 1e-12, ``rsqrt``, then the fp32
affine and a cast to the compute dtype; GELU is exact (erf).

The remat knobs checkpoint the sub-blocks JAX wraps in ``jax.checkpoint``
(``transformer.py:248-277``), through
``runtime/activation_checkpointing/checkpointing.py:checkpoint`` (full
recompute; the hidden-dropout generator is replayed, the attention-prob
dropout is the counter hash): ``attn_dropout_checkpoint`` the attention
sub-block (QKV to the output dropout; on the sparse path K7 runs again in
the recompute), ``gelu_checkpoint`` the FFN, ``normalize_invertible``
each of the two layer norms. None of them changes an output or a
gradient bit.

Compute dtype: fp16 when ``fp16``, else fp32, as in the JAX config,
which has no bf16 flag: a BERT built in bf16 runs its encoder layers,
and their attention kernels, in fp32.

Dropout runs when the forward gets a ``dropout_seed`` (an int): the
attention-prob dropout of every core is the counter hash of
``ops/flash_attention.py`` at that seed (the dense core applies the same
multiplier), the hidden dropouts draw from a ``torch.Generator``. Neither
reproduces ``jax.random``; parity tests run at dropout 0.

**Tensor parallelism** (``tp``, a model-axis ``AxisGroup`` of M > 1
ranks; Megatron's layout, JAX ``bert_partition_specs``): the layer holds
model rank r's shard. ``attn_qkvw`` ``[H, 3H]`` and ``attn_qkvb`` are
column parallel as q, k and v blocks (``Shard(1, 3)`` / ``Shard(0, 3)``:
rank r owns whole heads ``[r * hl, (r + 1) * hl)`` of each), ``inter_w``
/ ``inter_b`` column parallel, ``attn_ow`` and ``output_w`` row parallel
(``Shard(0)``, the JAX ``[in, out]`` layout's input rows); the output
biases and the norms are replicated. The input of each column-parallel
product takes Megatron's ``f`` (``psum_grad``) and each row-parallel
product's partial sum ``g`` (``psum_combine``) before its bias. JAX's
``P(None, "model")`` on ``attn_qkvw`` splits the 3H columns in equal
contiguous pieces and lets GSPMD compute the unsharded function; the
port's q, k, v blocks compute the same function with no resharding, and
its converters cut a rank's heads from the whole leaf. Every attention
core runs at the rank's hl heads with the dropout hash at the heads'
global coordinates (``head_offset = row * heads + r * hl``, the head
count ``heads``); the hidden dropouts act on replicated activations and
draw the same masks on every rank of the group (the generator is seeded
by the data rank only).
"""

import json

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.flash_attention import (
    _dropout_multiplier_full,
    current_global_rows,
    dropout_generator,
    flash_attention,
    hidden_dropout,
)
from deepspeed_tpu_torch.parallel.collectives import psum_combine, psum_grad
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    set_shard,
    shard_tensor,
)

# the layer's split leaves under tensor parallelism (``[in, out]``
# matrices: a column-parallel one splits dim 1, a row-parallel one dim 0)
TP_SPECS = {"attn_qkvw": Shard(1, 3), "attn_qkvb": Shard(0, 3),
            "inter_w": Shard(1), "inter_b": Shard(0),
            "attn_ow": Shard(0), "output_w": Shard(0)}


class DeepSpeedTransformerConfig:
    """Mirror of the reference config surface
    (`ops/transformer/transformer.py:41-111`)."""

    def __init__(self,
                 batch_size=-1,
                 max_seq_length=-1,
                 hidden_size=-1,
                 intermediate_size=-1,
                 heads=-1,
                 attn_dropout_ratio=-1,
                 hidden_dropout_ratio=-1,
                 num_hidden_layers=-1,
                 initializer_range=-1,
                 local_rank=-1,
                 seed=-1,
                 fp16=False,
                 pre_layer_norm=True,
                 normalize_invertible=False,
                 gelu_checkpoint=False,
                 adjust_init_range=True,
                 attn_dropout_checkpoint=False,
                 stochastic_mode=False,
                 huggingface=False):
        self.batch_size = batch_size
        self.max_seq_length = max_seq_length
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size if intermediate_size > 0 \
            else 4 * hidden_size
        self.heads = heads
        self.attn_dropout_ratio = max(attn_dropout_ratio, 0.0)
        self.hidden_dropout_ratio = max(hidden_dropout_ratio, 0.0)
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range if initializer_range > 0 \
            else 0.02
        self.local_rank = local_rank
        self.seed = seed
        self.fp16 = fp16
        self.pre_layer_norm = pre_layer_norm
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.huggingface = huggingface

    @property
    def dtype(self):
        return torch.float16 if self.fp16 else torch.float32

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            setattr(config, key, value)
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def _is_key_padding_shape(shape, B, T):
    """True when an additive mask is broadcastable to [B, 1, 1, T], i.e.
    constant over query positions, so it collapses to a key-padding row."""
    if len(shape) > 4:
        return False
    padded = (1,) * (4 - len(shape)) + tuple(shape)
    ok_b = padded[0] in (1, B)
    ok_heads = padded[1] == 1
    ok_q = padded[2] == 1
    ok_k = padded[3] in (1, T)
    return ok_b and ok_heads and ok_q and ok_k


class DeepSpeedTransformerLayer(nn.Module):
    """One transformer encoder block (reference ``DeepSpeedTransformerLayer``).

    ``forward(hidden_states, attention_mask, dropout_seed, generator)``:
    ``hidden_states`` [B, T, H]; ``attention_mask`` the BERT-style
    additive mask broadcastable to [B, heads, T, T] (e.g. [B, 1, 1, T]
    with 0 for keep / -10000 for pad), or None. Params are fp32 on
    ``device``, drawn from ``generator`` as the JAX initializers draw
    them: N(0, initializer_range) for the QKV and intermediate weights,
    N(0, initializer_range / sqrt(2 L)) for the output projections when
    ``adjust_init_range``, zero biases, unit norm scales. With ``tp``
    (a model-axis group of more than one rank) the layer holds its
    model rank's shard (module docstring); each split leaf is drawn
    whole from ``generator`` and cut, so a seed gives the unsharded
    layer's weights.
    """

    def __init__(self, config, use_flash_attention=False,
                 sparsity_config=None, device=None, generator=None,
                 tp=None):
        super().__init__()
        self.config = config
        self.use_flash_attention = use_flash_attention
        self.sparsity_config = sparsity_config
        self.tp = tp if tp is not None and tp.size > 1 else None
        M = 1 if self.tp is None else self.tp.size
        rank = 0 if self.tp is None else self.tp.rank
        if config.heads % M or config.intermediate_size % M:
            raise ValueError(f"heads {config.heads} and intermediate size "
                             f"{config.intermediate_size} must divide the "
                             f"model axis ({M})")
        self.local_heads = config.heads // M
        self.sparse_core = None
        if sparsity_config is not None:
            from deepspeed_tpu_torch.ops.sparse_attention import (
                SparseSelfAttention)
            self.sparse_core = SparseSelfAttention(
                sparsity_config, key_padding_mask_mode="add",
                model_rank=rank, model_size=M)
        H, I = config.hidden_size, config.intermediate_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=device))

        self.attn_qkvw = param(H, 3 * H // M)
        self.attn_qkvb = param(3 * H // M)
        self.attn_ow = param(H // M, H)
        self.attn_ob = param(H)
        self.attn_nw = param(H)
        self.attn_nb = param(H)
        self.inter_w = param(H, I // M)
        self.inter_b = param(I // M)
        self.output_w = param(I // M, H)
        self.output_b = param(H)
        self.norm_w = param(H)
        self.norm_b = param(H)
        if self.tp is not None:
            for name, spec in TP_SPECS.items():
                set_shard(getattr(self, name), spec)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        cfg = self.config
        std = cfg.initializer_range
        # the reference shrinks the output-projection init by 1/sqrt(2L)
        out_std = std / (2.0 * max(cfg.num_hidden_layers, 1)) ** 0.5 \
            if cfg.adjust_init_range else std
        H, I = cfg.hidden_size, cfg.intermediate_size
        for w, s, full in ((self.attn_qkvw, std, (H, 3 * H)),
                           (self.attn_ow, out_std, (H, H)),
                           (self.inter_w, std, (H, I)),
                           (self.output_w, out_std, (I, H))):
            if self.tp is None:
                nn.init.normal_(w, 0.0, s, generator=generator)
            else:   # the whole leaf, then this rank's piece
                whole = torch.empty(full, dtype=w.dtype, device=w.device)
                nn.init.normal_(whole, 0.0, s, generator=generator)
                w.copy_(shard_tensor(whole, w.tp_shard, self.tp.rank,
                                     self.tp.size))
        for b in (self.attn_qkvb, self.attn_ob, self.attn_nb, self.inter_b,
                  self.output_b, self.norm_b):
            nn.init.zeros_(b)
        nn.init.ones_(self.attn_nw)
        nn.init.ones_(self.norm_w)

    def _layer_norm(self, x, w, b):
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + 1e-12)
        return (y * w + b).to(self.config.dtype)

    def _attention(self, xin, attention_mask, seed, generator):
        from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
            import collapse_additive_mask
        cfg = self.config
        dtype = cfg.dtype
        B, T, H = xin.shape
        heads = cfg.heads
        hd = H // heads
        hl = self.local_heads           # this rank's heads
        rate = cfg.attn_dropout_ratio if seed is not None else 0.0
        # the rows' global head coordinate (``global_rows``), and with a
        # model axis the rank's first head, hashed at ``heads`` a row
        offset = current_global_rows()[0] * heads if rate else 0
        num_heads = None
        if self.tp is not None:
            offset += self.tp.rank * hl
            num_heads = heads
            xin = psum_grad(xin, self.tp)
        qkv = xin @ self.attn_qkvw.to(dtype) + self.attn_qkvb.to(dtype)
        q, k, v = (t.reshape(B, T, hl, hd)
                   for t in qkv.split(hl * hd, dim=-1))
        if self.sparse_core is not None:
            kpm = None
            if attention_mask is not None:
                kpm = collapse_additive_mask(attention_mask, B, T)
            ctx = self.sparse_core(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                key_padding_mask=kpm, dropout_rate=rate,
                dropout_seed=seed if rate else None,
                dropout_head_offset=offset).transpose(1, 2)
            # (the core hashes at its config's head count itself)
        elif self.use_flash_attention and (
                attention_mask is None or
                _is_key_padding_shape(attention_mask.shape, B, T)):
            kbias = None
            if attention_mask is not None:
                kbias = collapse_additive_mask(attention_mask, B, T)
            ctx = flash_attention(q, k, v, causal=False, key_bias=kbias,
                                  dropout_rate=rate,
                                  dropout_seed=seed if rate else None,
                                  dropout_head_offset=offset,
                                  dropout_num_heads=num_heads)
        else:
            scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
            att = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
            if attention_mask is not None:
                att = att + attention_mask.float()
            att = torch.softmax(att, dim=-1).to(dtype)
            if rate:
                att = att * _dropout_multiplier_full(
                    B, hl, T, T, rate, seed, head_offset=offset,
                    num_heads=num_heads, device=att.device).to(dtype)
            ctx = torch.einsum("bhts,bshd->bthd", att, v)
        out = self._row_parallel(ctx.reshape(B, T, hl * hd), self.attn_ow,
                                 self.attn_ob)
        return hidden_dropout(out, cfg.hidden_dropout_ratio, generator)

    def _row_parallel(self, y, w, b):
        """``y @ w + b`` of a row-parallel ``w``: the partial products
        summed over the model group, then the replicated bias."""
        dtype = self.config.dtype
        part = y @ w.to(dtype)
        if self.tp is not None:
            part = psum_combine(part, self.tp)
        return part + b.to(dtype)

    def _ffn(self, xin, generator):
        dtype = self.config.dtype
        if self.tp is not None:
            xin = psum_grad(xin, self.tp)
        h = xin @ self.inter_w.to(dtype) + self.inter_b.to(dtype)
        h = F.gelu(h)
        h = self._row_parallel(h, self.output_w, self.output_b)
        return hidden_dropout(h, self.config.hidden_dropout_ratio, generator)

    def forward(self, hidden_states, attention_mask=None, dropout_seed=None,
                generator=None):
        """``dropout_seed`` (an int) turns training dropout on; the hidden
        dropouts draw from ``generator`` (made from the seed if None)."""
        if dropout_seed is None:
            generator = None
        elif generator is None:
            generator = dropout_generator(dropout_seed,
                                          hidden_states.device)
        from deepspeed_tpu_torch.runtime.activation_checkpointing.\
            checkpointing import checkpoint
        cfg = self.config
        x = hidden_states.to(cfg.dtype)

        def attention(xin):
            return self._attention(xin, attention_mask, dropout_seed,
                                   generator)

        def ffn(xin):
            return self._ffn(xin, generator)

        def ln_attn(xin):
            return self._layer_norm(xin, self.attn_nw, self.attn_nb)

        def ln_out(xin):
            return self._layer_norm(xin, self.norm_w, self.norm_b)

        def remat(fn, gen=None):
            # the generator rides as an argument so the recompute
            # replays its draws
            return lambda xin: checkpoint(lambda h, _g: fn(h), xin, gen,
                                          policy="nothing")

        if cfg.attn_dropout_checkpoint:
            attention = remat(attention, generator)
        if cfg.gelu_checkpoint:
            ffn = remat(ffn, generator)
        if cfg.normalize_invertible:
            ln_attn, ln_out = remat(ln_attn), remat(ln_out)
        if cfg.pre_layer_norm:
            x = x + attention(ln_attn(x))
            x = x + ffn(ln_out(x))
        else:
            x = ln_attn(x + attention(x))
            x = ln_out(x + ffn(x))
        return x
