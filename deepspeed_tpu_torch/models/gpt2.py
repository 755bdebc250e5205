"""GPT-2 model family (the serving surface of
``deepspeed_tpu/models/gpt2.py``).

Pre-LN decoder with a tied embedding / output head, bf16 compute over
fp32 params by default. The modules reproduce the flax model's
numerics so converted weights give the same logits:

- ``LayerNorm`` has eps 1e-6 and takes its statistics in fp32
  (``E[x^2] - E[x]^2``, clipped at 0) with fp32 scale and bias, then
  casts to the compute dtype — flax ``nn.LayerNorm``.
- ``Dense`` casts its input, kernel and bias to the compute dtype
  before the product — flax ``nn.Dense(dtype=...)``.
- GELU is the tanh approximation.
- Embeddings are ``wte[ids].to(dtype) + wpe[positions].to(dtype)``.

Two forward paths: the uncached causal one (a full sequence; training
runs it, with flash attention when ``use_flash_attention``) and the
cached one (``kv_cache`` from `inference/cache.py`: this call's k/v are
written at explicit ``positions`` and attention runs over the whole
cache row under a position mask). The losses
(:func:`cross_entropy_loss`, :func:`chunked_cross_entropy_with_head`)
and :func:`make_gpt2_loss_fn` are ported; remat, ``scan_layers``,
progressive layer drop and fp8 are not yet (they raise).

Dropout runs only when the forward gets a ``dropout_seed`` (an int the
engine derives from its seed and step counter). Attention-prob dropout
is the counter hash of ``ops/flash_attention.py`` on both attention
routes, keyed per layer by ``fold_in_seed(seed, layer)``: bit-identical
to the JAX kernels for the same int32 seed. Hidden-state dropout draws
from a ``torch.Generator`` seeded with ``dropout_seed``. Neither seed
can match the JAX model's ``jax.random`` streams: that mismatch is
deliberate, and parity tests run with dropout 0.

:func:`convert_gpt2_params` turns the JAX package's param tree (as
numpy arrays) into a ``state_dict`` for :class:`GPT2LMHead`.
"""

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32   # master param dtype
    dropout: float = 0.0
    use_flash_attention: bool = False          # K1-K3 on the training path
    loss_chunk: int = 0              # >0: chunked cross-entropy over the
    #                                  vocab head (no [B, T, V] logits)
    remat: bool = False              # not yet ported
    scan_layers: bool = False        # not yet ported


# Sizes follow the reference perf-harness configs.
def gpt2_125m(**kw):
    return GPT2Config(n_embd=768, n_layer=12, n_head=12, **kw)


def gpt2_350m(**kw):
    return GPT2Config(n_embd=1024, n_layer=24, n_head=16, **kw)


def gpt2_760m(**kw):
    return GPT2Config(n_embd=1536, n_layer=24, n_head=16, **kw)


def gpt2_1_5b(**kw):
    return GPT2Config(n_embd=1600, n_layer=48, n_head=25, **kw)


def gpt2_2_7b(**kw):
    return GPT2Config(n_embd=2560, n_layer=32, n_head=32, **kw)


def gpt2_4b(**kw):
    return GPT2Config(n_embd=3072, n_layer=36, n_head=24, **kw)


def gpt2_tiny(**kw):
    """Test-size model."""
    kw.setdefault("vocab_size", 256)
    kw.setdefault("n_positions", 64)
    kw.setdefault("n_embd", 64)
    kw.setdefault("n_layer", 2)
    kw.setdefault("n_head", 4)
    return GPT2Config(**kw)


# flax lecun_normal: truncated normal at +-2 sigma, rescaled so the
# truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x.to(dtype) @ kernel.to(dtype) +
    bias.to(dtype)``. ``weight`` is stored ``[out, in]`` (torch
    convention; the flax kernel is its transpose)."""

    def __init__(self, n_in, n_out, cfg, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            n_out, n_in, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            n_out, dtype=cfg.param_dtype, device=device))

    def reset_parameters(self, generator=None):
        std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        w = self.weight.to(self.dtype)
        return torch.matmul(x.to(self.dtype), w.t()) + \
            self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: fp32 statistics and affine,
    eps 1e-6, result cast to the compute dtype."""

    def __init__(self, n, cfg, eps=1e-6, device=None):
        super().__init__()
        self.dtype = cfg.dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(
            n, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            n, dtype=cfg.param_dtype, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(self.dtype)


class CausalSelfAttention(nn.Module):
    """Causal attention; also the incremental-decode write/attend
    site. With ``kv_cache`` (a layer's ``{"k", "v"(, scales)}``
    buffers) the call writes this chunk's k/v and attends over the
    cache row."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.c_attn = Dense(C, 3 * C, cfg, device)
        self.c_proj = Dense(C, C, cfg, device)

    def forward(self, x, positions=None, kv_cache=None, attn_impl="dense",
                attn_block_k=128, attn_mask=None, drop=None):
        from deepspeed_tpu_torch.inference.cache import (
            attention_scale, cached_attention)
        from deepspeed_tpu_torch.ops.flash_attention import (
            dense_attention, flash_attention)

        cfg = self.cfg
        B, T, C = x.shape
        H = cfg.n_head
        q, k, v = self.c_attn(x).split(C, dim=-1)
        q = q.reshape(B, T, H, C // H)
        k = k.reshape(B, T, H, C // H)
        v = v.reshape(B, T, H, C // H)
        if kv_cache is not None:
            y, _ = cached_attention(q, k, v, kv_cache, positions,
                                    compute_dtype=cfg.dtype, impl=attn_impl,
                                    block_k=attn_block_k, mask=attn_mask)
        else:
            rate, seed = (0.0, None) if drop is None else \
                (drop.rate, drop.attn_seed)
            if cfg.use_flash_attention:
                y = flash_attention(q, k, v, causal=True, dropout_rate=rate,
                                    dropout_seed=seed)
            else:
                y = dense_attention(
                    q, k, v, causal=True,
                    sm_scale=attention_scale(C // H, cfg.dtype),
                    dropout_rate=rate, dropout_seed=seed)
        y = self.c_proj(y.reshape(B, T, C))
        return y if drop is None else drop.hidden(y)


class MLP(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        C = cfg.n_embd
        self.c_fc = Dense(C, 4 * C, cfg, device)
        self.c_proj = Dense(4 * C, C, cfg, device)

    def forward(self, x, drop=None):
        h = self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))
        return h if drop is None else drop.hidden(h)


class Block(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg, device=device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg, device=device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, drop=None, **attn_kw):
        x = x + self.attn(self.ln_1(x), drop=drop, **attn_kw)
        return x + self.mlp(self.ln_2(x), drop=drop)


class _Dropout:
    """One training forward's dropout: ``rate``, the hidden-state
    ``generator`` and the attention-prob hash seed of the current layer
    (``fold_in_seed(seed, layer)``)."""

    def __init__(self, rate, seed, generator, attn_seed=None):
        self.rate = rate
        self.seed = seed
        self.generator = generator
        self.attn_seed = attn_seed

    def layer(self, i):
        from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
        return _Dropout(self.rate, self.seed, self.generator,
                        fold_in_seed(self.seed, i))

    def hidden(self, x):
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class GPT2LMHead(nn.Module):
    """Decoder-only LM with tied embedding / output head.

    Params are created on ``device`` in ``cfg.param_dtype`` and drawn
    from ``generator`` (a ``torch.Generator`` on the same device) with
    the JAX model's initializers: wte N(0, 0.02), wpe N(0, 0.01), Dense
    kernels lecun-normal, biases 0, LayerNorm scale 1.
    """

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        for name in ("remat", "scan_layers"):
            if getattr(cfg, name):
                raise NotImplementedError(
                    f"GPT2Config.{name} is not yet ported to "
                    f"deepspeed_tpu_torch")
        self.config = cfg
        self.wte = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.n_embd, dtype=cfg.param_dtype,
            device=device))
        self.wpe = nn.Parameter(torch.empty(
            cfg.n_positions, cfg.n_embd, dtype=cfg.param_dtype,
            device=device))
        self.h = nn.ModuleList(Block(cfg, device)
                               for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=generator)
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.reset_parameters(generator)
            elif isinstance(mod, LayerNorm):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    @torch.no_grad()
    def cast_matmul_weights_(self):
        """Store the embeddings and Dense weights in the compute dtype
        (LayerNorm params stay fp32: they are applied in fp32). Every
        forward casts them to the compute dtype anyway, so the result is
        bit-identical; serving just stops paying the cast per step."""
        dtype = self.config.dtype
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.weight.data = mod.weight.data.to(dtype)
                mod.bias.data = mod.bias.data.to(dtype)
        self.wte.data = self.wte.data.to(dtype)
        self.wpe.data = self.wpe.data.to(dtype)
        return self

    def forward(self, input_ids, positions=None, kv_cache=None,
                attn_impl="dense", attn_block_k=128, dropout_seed=None,
                return_hidden=False):
        """Logits ``[B, T, vocab]`` in the compute dtype; with
        ``kv_cache``, ``(logits, kv_cache)`` (the cache updated in
        place). ``positions`` ``[B, T]`` places a chunk at explicit
        absolute positions (required with ``kv_cache``).
        ``dropout_seed`` (an int) turns on training dropout on the
        uncached path; ``return_hidden`` returns the final hidden states
        instead of logits (the chunked loss applies the head itself)."""
        from deepspeed_tpu_torch.inference.cache import attention_mask

        cfg = self.config
        B, T = input_ids.shape
        if positions is None:
            pos_emb = self.wpe[:T][None]
        else:
            pos_emb = self.wpe[positions]
        x = self.wte[input_ids].to(cfg.dtype) + pos_emb.to(cfg.dtype)
        drop = None
        if dropout_seed is not None and cfg.dropout > 0.0 and \
                kv_cache is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(int(dropout_seed) & 0xFFFFFFFFFFFFFFFF)
            drop = _Dropout(cfg.dropout, int(dropout_seed), gen)
            x = drop.hidden(x)
        if kv_cache is None:
            for i, block in enumerate(self.h):
                x = block(x, drop=None if drop is None else drop.layer(i))
        else:
            if positions is None:
                raise ValueError("the cached path needs explicit positions")
            attn_mask = None
            if attn_impl == "dense":
                # one position mask per step, shared by every layer
                attn_mask = attention_mask(kv_cache["h_0"], positions)
            for i, block in enumerate(self.h):
                x = block(x, positions=positions, kv_cache=kv_cache[f"h_{i}"],
                          attn_impl=attn_impl, attn_block_k=attn_block_k,
                          attn_mask=attn_mask)
        x = self.ln_f(x)
        if return_hidden:
            return x
        logits = torch.matmul(x, self.wte.to(cfg.dtype).t())
        if kv_cache is not None:
            return logits, kv_cache
        return logits


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy_sum_and_count(logits, labels, ignore_index=-100):
    """(summed token cross-entropy in fp32, valid-token count)."""
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    token_loss = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    token_loss = torch.where(mask, token_loss, 0.0)
    return token_loss.sum(), mask.sum()


def cross_entropy_loss(logits, labels, ignore_index=-100):
    """Mean token cross-entropy in fp32, masking ``ignore_index``."""
    total, count = cross_entropy_sum_and_count(logits, labels, ignore_index)
    return total / torch.clamp(count, min=1)


class _HeadMatmul(torch.autograd.Function):
    """``[B, c, M] x [M, V]`` head matmul at ``xc``'s dtype whose head
    cotangent is produced directly in fp32 (``models/gpt2.py:427-457``):
    the bf16 inputs widen exactly and the sum over rows runs in fp32, so
    the chunked head's gradient is rounded once, like the dense head's."""

    @staticmethod
    def forward(ctx, xc, head):
        ctx.save_for_backward(xc, head)
        return torch.matmul(xc, head.to(xc.dtype))

    @staticmethod
    def backward(ctx, g):
        xc, head = ctx.saved_tensors
        dx = torch.matmul(g, head.to(g.dtype).t())
        dhead = torch.matmul(xc.reshape(-1, xc.shape[-1]).float().t(),
                             g.reshape(-1, g.shape[-1]).float())
        return dx, dhead


def _chunk_loss(xc, lc, head, bias, ignore_index):
    logits = _HeadMatmul.apply(xc, head)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    total, count = cross_entropy_sum_and_count(logits, lc, ignore_index)
    return total, count


def chunked_cross_entropy_with_head(x, head, bias, labels, chunk,
                                    ignore_index=-100):
    """Cross-entropy against a vocab head without the [B, T, V] logits
    (``models/gpt2.py:460``): a loop over sequence chunks, each chunk's
    logits recomputed in the backward (``torch.utils.checkpoint``), the
    head and bias kept fp32 so their gradients accumulate in fp32.

    x: [B, T, M] final hidden states; head: [M, V]; bias: [V] or None;
    labels: [B, T]. Returns (loss sum, valid-token count)."""
    from torch.utils.checkpoint import checkpoint

    B, T, M = x.shape
    chunk = min(chunk, T)
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
    head = head.float()
    if bias is not None:
        bias = bias.float()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        s, c = checkpoint(_chunk_loss, x[:, sl], labels[:, sl], head, bias,
                          ignore_index, use_reentrant=False)
        total = total + s
        count = count + c
    return total, count


def chunked_cross_entropy_sum_and_count(x, wte, labels, chunk,
                                        ignore_index=-100):
    """Tied-head form: cross-entropy against ``wte.T``."""
    return chunked_cross_entropy_with_head(x, wte.t(), None, labels, chunk,
                                           ignore_index)


def make_gpt2_loss_fn(model):
    """``loss_fn(batch, rng=None)`` for the engine over ``model``'s
    params (``models/gpt2.py:521``). ``batch`` is a dict with
    ``input_ids`` [B, T] (labels default to the next-token shift, the
    last position ignored) or explicit ``labels``; ``rng`` is the
    engine's int dropout seed, None for a deterministic forward."""

    def loss_fn(batch, rng=None, pld_theta=None):
        if pld_theta is not None:
            raise NotImplementedError(
                "progressive layer drop is not yet ported to "
                "deepspeed_tpu_torch")
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat(
                [input_ids[:, 1:],
                 torch.full((input_ids.shape[0], 1), -100,
                            dtype=input_ids.dtype,
                            device=input_ids.device)], dim=1)
        chunk = model.config.loss_chunk
        if chunk:
            hidden = model(input_ids, dropout_seed=rng, return_hidden=True)
            total, count = chunked_cross_entropy_sum_and_count(
                hidden, model.wte.to(model.config.dtype), labels, chunk)
            return total / torch.clamp(count, min=1)
        return cross_entropy_loss(model(input_ids, dropout_seed=rng), labels)

    return loss_fn


# ---------------------------------------------------------------------------
# JAX param tree -> state_dict
# ---------------------------------------------------------------------------

_LAYER_KEY_RE = re.compile(r"^h_(\d+)$")
_DENSE = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
          ("mlp", "c_proj"))


def _unstack(params):
    """The ``scan_layers`` layout (one ``h`` subtree with a leading
    layer axis) as per-layer ``h_<i>`` subtrees."""
    def split(tree, i):
        if hasattr(tree, "items"):
            return {k: split(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    out = {k: v for k, v in params.items() if str(k) != "h"}
    leaf = params["h"]
    while hasattr(leaf, "items"):
        leaf = next(iter(leaf.values()))
    for i in range(np.asarray(leaf).shape[0]):
        out[f"h_{i}"] = split(params["h"], i)
    return out


def convert_gpt2_params(params):
    """The JAX package's GPT-2 param tree (nested mappings of numpy
    arrays, unrolled ``h_<i>`` or stacked ``h`` layout) as a
    :class:`GPT2LMHead` ``state_dict`` of fp32 CPU tensors.

    Flax ``Dense.kernel`` is ``[in, out]`` and becomes ``weight``
    ``[out, in]``; LayerNorm ``scale``/``bias`` become
    ``weight``/``bias``; the output head is tied to ``wte`` and has no
    entry of its own.
    """
    if "h" in params:
        params = _unstack(params)
    idxs = sorted(int(m.group(1)) for k in params
                  if (m := _LAYER_KEY_RE.match(str(k))))
    if idxs != list(range(len(idxs))):
        raise ValueError(f"non-contiguous layer indices: {idxs}")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"wte": t(params["wte"]), "wpe": t(params["wpe"]),
          "ln_f.weight": t(params["ln_f"]["scale"]),
          "ln_f.bias": t(params["ln_f"]["bias"])}
    for i in idxs:
        layer = params[f"h_{i}"]
        for ln in ("ln_1", "ln_2"):
            sd[f"h.{i}.{ln}.weight"] = t(layer[ln]["scale"])
            sd[f"h.{i}.{ln}.bias"] = t(layer[ln]["bias"])
        for mod, name in _DENSE:
            dense = layer[mod][name]
            sd[f"h.{i}.{mod}.{name}.weight"] = t(dense["kernel"]).t() \
                .contiguous()
            sd[f"h.{i}.{mod}.{name}.bias"] = t(dense["bias"])
    return sd
