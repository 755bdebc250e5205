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
    ``adjust_init_range``, zero biases, unit norm scales.
    """

    def __init__(self, config, use_flash_attention=False,
                 sparsity_config=None, device=None, generator=None):
        super().__init__()
        self.config = config
        self.use_flash_attention = use_flash_attention
        self.sparsity_config = sparsity_config
        self.sparse_core = None
        if sparsity_config is not None:
            from deepspeed_tpu_torch.ops.sparse_attention import (
                SparseSelfAttention)
            self.sparse_core = SparseSelfAttention(
                sparsity_config, key_padding_mask_mode="add")
        H, I = config.hidden_size, config.intermediate_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                            device=device))

        self.attn_qkvw = param(H, 3 * H)
        self.attn_qkvb = param(3 * H)
        self.attn_ow = param(H, H)
        self.attn_ob = param(H)
        self.attn_nw = param(H)
        self.attn_nb = param(H)
        self.inter_w = param(H, I)
        self.inter_b = param(I)
        self.output_w = param(I, H)
        self.output_b = param(H)
        self.norm_w = param(H)
        self.norm_b = param(H)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        cfg = self.config
        std = cfg.initializer_range
        # the reference shrinks the output-projection init by 1/sqrt(2L)
        out_std = std / (2.0 * max(cfg.num_hidden_layers, 1)) ** 0.5 \
            if cfg.adjust_init_range else std
        for w, s in ((self.attn_qkvw, std), (self.attn_ow, out_std),
                     (self.inter_w, std), (self.output_w, out_std)):
            nn.init.normal_(w, 0.0, s, generator=generator)
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
        rate = cfg.attn_dropout_ratio if seed is not None else 0.0
        # the rows' global head coordinate (``global_rows``)
        offset = current_global_rows()[0] * heads if rate else 0
        qkv = xin @ self.attn_qkvw.to(dtype) + self.attn_qkvb.to(dtype)
        q, k, v = (t.reshape(B, T, heads, hd) for t in qkv.split(H, dim=-1))
        if self.sparse_core is not None:
            kpm = None
            if attention_mask is not None:
                kpm = collapse_additive_mask(attention_mask, B, T)
            ctx = self.sparse_core(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                key_padding_mask=kpm, dropout_rate=rate,
                dropout_seed=seed if rate else None,
                dropout_head_offset=offset).transpose(1, 2)
        elif self.use_flash_attention and (
                attention_mask is None or
                _is_key_padding_shape(attention_mask.shape, B, T)):
            kbias = None
            if attention_mask is not None:
                kbias = collapse_additive_mask(attention_mask, B, T)
            ctx = flash_attention(q, k, v, causal=False, key_bias=kbias,
                                  dropout_rate=rate,
                                  dropout_seed=seed if rate else None,
                                  dropout_head_offset=offset)
        else:
            scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
            att = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
            if attention_mask is not None:
                att = att + attention_mask.float()
            att = torch.softmax(att, dim=-1).to(dtype)
            if rate:
                att = att * _dropout_multiplier_full(
                    B, heads, T, T, rate, seed, head_offset=offset,
                    device=att.device).to(dtype)
            ctx = torch.einsum("bhts,bshd->bthd", att, v)
        out = ctx.reshape(B, T, H) @ self.attn_ow.to(dtype) + \
            self.attn_ob.to(dtype)
        return hidden_dropout(out, cfg.hidden_dropout_ratio, generator)

    def _ffn(self, xin, generator):
        dtype = self.config.dtype
        h = xin @ self.inter_w.to(dtype) + self.inter_b.to(dtype)
        h = F.gelu(h)
        h = h @ self.output_w.to(dtype) + self.output_b.to(dtype)
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
