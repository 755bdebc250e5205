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
cache row under a position mask; ``kv_page_table`` addresses a paged
pool, and ``truncate_layers`` runs only the first blocks, the
speculative draft's early exit). The losses
(:func:`cross_entropy_loss`, :func:`chunked_cross_entropy_with_head`)
and :func:`make_gpt2_loss_fn` are ported.

``scan_layers`` stores every block weight once, stacked on a leading
layer axis ``[L, ...]`` under the block's own names (``h.ln_1.weight``
is ``[L, C]``, ``h.attn.c_attn.weight`` ``[L, 3C, C]``): the JAX scanned
param tree. PyTorch has no ``lax.scan``, so the blocks still run in a
Python loop (what the flag means here is the layout and the numbers, not
compile time): each stacked leaf is taken apart once per forward with
``unbind(0)`` (its backward stacks the per-layer gradients once; indexing
``h[i]`` in the loop would make autograd write a whole ``[L, ...]`` zero
gradient per layer), and each layer runs a weightless template block
through ``torch.func.functional_call``. The stacked model's loss and
gradients equal the unrolled model's bit for bit, after
:func:`stack_gpt2_state_dict` / :func:`unstack_gpt2_state_dict`.

Progressive layer drop (``pld_theta`` on the training path, JAX
``models/gpt2.py:233-262``): sublayer ``l`` of ``L`` (attention, then the
MLP of each block) is kept with probability ``1 - (l+1)/L (1 - theta)``.
A dropped sublayer is not run at all, in both layouts (JAX's
``scan_layers`` degrades the skip to a multiplicative gate, which gives
the same values), except under ``scan_layers`` with fp8 state, where it
runs gated by 0 as JAX's does, so that its fp8 sites record what JAX's
record. The coins come from a CPU ``torch.Generator`` seeded
from the forward's ``dropout_seed`` (rank folded in, as the hidden
dropout's), drawn before each block, so a remat recompute sees the same
coins; they cannot match ``jax.random.bernoulli``.

fp8: each of the four ``Dense`` sites (``c_attn``, ``c_proj`` twice a
layer, ``c_fc``) runs :func:`deepspeed_tpu_torch.ops.fp8.fp8_linear`
when an :func:`~deepspeed_tpu_torch.ops.fp8.fp8_scope` is active (the
engine's ``fp8`` block); the head matmul and attention stay full
precision. The state keys are JAX's: a dropped sublayer's sites keep
their keys, and under ``scan_layers`` every layer shares the scanned
body's (``ops/fp8.py:scan_keys``).

``remat`` checkpoints each block on the training path through
``runtime/activation_checkpointing/checkpointing.py:checkpoint`` with
``remat_policy`` "full" (its ``nothing`` policy: keep only the block
input; the backward recomputes the block, K1 included), "dots" (keep
the matmul outputs, recompute the rest: like JAX's ``checkpoint_dots``,
which saves ``dot_general`` results only, so a K1 call's output is not
kept) or "nothing" (keep everything: the same as no remat). The
recompute draws the same hidden-dropout masks as the forward (the
block's generator state is restored for it), so remat changes no loss
or gradient bit.

Dropout runs only when the forward gets a ``dropout_seed`` (an int the
engine derives from its seed and step counter). Attention-prob dropout
is the counter hash of ``ops/flash_attention.py`` on both attention
routes, keyed per layer by ``fold_in_seed(seed, layer)``: bit-identical
to the JAX kernels for the same int32 seed. Hidden-state dropout draws
from a ``torch.Generator`` seeded with ``dropout_seed``. Neither seed
can match the JAX model's ``jax.random`` streams: that mismatch is
deliberate, and parity tests run with dropout 0. A data-parallel rank
runs its forward inside ``ops.flash_attention.global_rows``: its rows'
attention masks are then those of their global rows, and its hidden
masks its own.

:func:`convert_gpt2_params` turns the JAX package's param tree (as
numpy arrays) into a ``state_dict`` for :class:`GPT2LMHead`.

**Tensor parallelism** (``GPT2LMHead(cfg, mpu=...)``, Megatron's layout,
JAX ``gpt2_partition_specs``, ``models/gpt2.py:565-601``): the model
holds only the shard of its model rank (``mpu``'s model axis, ``M``
ranks). ``c_attn`` and ``c_fc`` are column parallel (``c_attn`` as q, k
and v blocks, so a rank owns ``n_head / M`` whole heads), both
``c_proj`` row parallel, ``wte`` split over the vocab, and ``wpe``, the
LayerNorms and every bias after a row-parallel sum replicated
(:func:`gpt2_partition_specs`). The embedding lookup is vocab parallel
(each rank looks up the ids it holds, zeros for the rest, summed over
the group: one nonzero term, so the sum is exact), and so are the tied
head and the loss (:func:`vocab_parallel_cross_entropy`: the max and the
sum of exponentials all-reduced over the group); ``forward`` gathers the
vocab for the logits it returns (serving samples from them).

*Vocab padding.* 50257 divides by neither 2 nor 4. JAX's GSPMD pads an
uneven shard; the port pads too: ``wte`` is ``ceil(V / M) * M`` rows,
split evenly, the rows past ``V`` zero. A padded row never enters the
softmax (its logit is set to -inf before the max and the sum, and it is
cut from gathered logits), no id looks it up, so its gradient is 0 and
Adam leaves it at 0; :func:`~deepspeed_tpu_torch.parallel.
tensor_parallel.unshard` drops it from a whole leaf.

*Stacked layers and the chunked loss.* Under ``scan_layers`` the stack
holds the TP block's shards (:class:`StackedBlocks`: each ``[L, ...]``
leaf split as its layer's leaf behind a replicated layer axis, JAX's
``gpt2_partition_specs`` of the scanned tree), and each layer runs the
block's collectives. ``loss_chunk`` takes
:func:`vocab_parallel_chunked_cross_entropy`: each chunk's logits over
the rank's vocab columns, the max and the sum reduced over the group a
chunk. :func:`gpt2_partition_specs`, :func:`shard_gpt2_state_dict` and
``convert_gpt2_params(scan_layers=True, model_size=M)`` cover both
layouts, so a checkpoint of either layout serves or resumes in the
other at any model size.

*Dropout across shards.* A rank's attention passes
``dropout_head_offset = row_offset * H + rank * H / M`` and
``dropout_num_heads = H`` to K1-K3, so its masks are the unsharded
model's at its heads, bit for bit. Hidden dropout runs on replicated
activations: its generator is seeded by the data rank only (the
engine's ``global_rows``), so every rank of a model group draws the
same mask. A TP model initialises each leaf whole from ``generator``,
in the unsharded model's order, and keeps its shard: the same seed gives
the unsharded model's weights.
"""

import dataclasses
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops import fp8 as fp8_ops
from deepspeed_tpu_torch.ops.flash_attention import (
    current_global_rows,
    dropout_generator,
    hidden_dropout,
)
from deepspeed_tpu_torch.parallel import collectives as tp_comm
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    padded_len,
    set_shard,
    shard_tensor,
)


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
    remat: bool = False              # activation checkpointing per block
    remat_policy: str = "full"       # "full" | "dots" | "nothing"
    scan_layers: bool = False        # layer-stacked [L, ...] params


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


def _tp_active(tp):
    return tp is not None and tp.size > 1


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x.to(dtype) @ kernel.to(dtype) +
    bias.to(dtype)``. ``weight`` is stored ``[out, in]`` (torch
    convention; the flax kernel is its transpose, which ZeRO's partition
    rule reads: ``reference_transposed``).

    With a model axis ``tp`` (an ``AxisGroup`` of more than one rank),
    ``mode`` "column" keeps rows ``r`` of each of the ``groups`` output
    blocks (the input's cotangent summed over the group: Megatron's
    ``f``) and "row" keeps the input columns ``r`` (the partial products
    summed over the group, then the bias: ``g``). ``pad`` (column mode)
    pads ``n_out`` with zero rows to a multiple of the axis (a vocab
    head: ``Shard(0, full=n_out)``)."""

    reference_transposed = ("weight",)

    def __init__(self, n_in, n_out, cfg, device=None, site="dense", tp=None,
                 mode=None, groups=1, pad=False):
        super().__init__()
        self.dtype = cfg.dtype
        self.site = site          # the fp8 state's site name
        self.tp = tp if _tp_active(tp) else None
        self.mode = mode if self.tp is not None else None
        self.fan_in = n_in
        self.full_shape = (n_out, n_in)
        w_shape, b_len = (n_out, n_in), n_out
        full = None
        if self.mode == "column":
            local = padded_len(n_out, tp.size) // tp.size if pad \
                else n_out // tp.size
            full = n_out if pad else None
            w_shape = (local, n_in)
            b_len = local
        elif self.mode == "row":
            w_shape = (n_out, n_in // tp.size)
        self.weight = nn.Parameter(torch.empty(
            w_shape, dtype=cfg.param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(
            b_len, dtype=cfg.param_dtype, device=device))
        if self.mode == "column":
            set_shard(self.weight, Shard(0, groups, full))
            set_shard(self.bias, Shard(0, groups, full))
        elif self.mode == "row":
            set_shard(self.weight, Shard(1))

    def reset_parameters(self, generator=None):
        std = math.sqrt(1.0 / self.fan_in) / _TRUNC_STD
        if self.tp is None:
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            # the whole leaf from the generator, then this rank's shard
            # (a stacked leaf: every layer's whole leaf)
            full = torch.empty(tuple(self.weight.shape[:-2]) +
                               self.full_shape, dtype=self.weight.dtype,
                               device=self.weight.device)
            nn.init.trunc_normal_(full, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            self.weight.copy_(shard_tensor(full, self.weight.tp_shard,
                                           self.tp.rank, self.tp.size))
        nn.init.zeros_(self.bias)

    def forward(self, x):
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if self.mode == "column":
            x = tp_comm.psum_grad(x, self.tp)
        if fp8_ops.site_active(self.site):
            y = fp8_ops.fp8_linear(x, w, self.site)
        else:
            y = torch.matmul(x, w.t())
        if self.mode == "row":
            y = tp_comm.psum_combine(y, self.tp)
        return y + self.bias.to(self.dtype)


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

    def __init__(self, cfg, device=None, tp=None):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.tp = tp if _tp_active(tp) else None
        self.c_attn = Dense(C, 3 * C, cfg, device, site="c_attn", tp=tp,
                            mode="column", groups=3)
        self.c_proj = Dense(C, C, cfg, device, site="c_proj", tp=tp,
                            mode="row")

    def forward(self, x, positions=None, kv_cache=None, attn_impl="dense",
                attn_block_k=128, attn_mask=None, kv_page_table=None,
                drop=None):
        from deepspeed_tpu_torch.inference.cache import (
            attention_scale, cached_attention)
        from deepspeed_tpu_torch.ops.flash_attention import (
            dense_attention, flash_attention)

        cfg = self.cfg
        B, T, C = x.shape
        H = cfg.n_head
        D = C // H
        M = 1 if self.tp is None else self.tp.size
        hl = H // M                       # the rank's heads
        q, k, v = self.c_attn(x).split(C // M, dim=-1)
        q = q.reshape(B, T, hl, D)
        k = k.reshape(B, T, hl, D)
        v = v.reshape(B, T, hl, D)
        if kv_cache is not None:
            y, _ = cached_attention(q, k, v, kv_cache, positions,
                                    compute_dtype=cfg.dtype, impl=attn_impl,
                                    block_k=attn_block_k, mask=attn_mask,
                                    page_table=kv_page_table)
        else:
            rate, seed, offset = (0.0, None, 0) if drop is None else \
                (drop.rate, drop.attn_seed, drop.row_offset * H)
            heads = None
            if self.tp is not None:       # the heads' global coordinates
                offset += self.tp.rank * hl
                heads = H
            if cfg.use_flash_attention:
                y = flash_attention(q, k, v, causal=True, dropout_rate=rate,
                                    dropout_seed=seed,
                                    dropout_head_offset=offset,
                                    dropout_num_heads=heads)
            else:
                y = dense_attention(
                    q, k, v, causal=True,
                    sm_scale=attention_scale(C // H, cfg.dtype),
                    dropout_rate=rate, dropout_seed=seed,
                    dropout_head_offset=offset, dropout_num_heads=heads)
        y = self.c_proj(y.reshape(B, T, hl * D))
        return y if drop is None else drop.hidden(y)


class MLP(nn.Module):
    def __init__(self, cfg, device=None, tp=None):
        super().__init__()
        C = cfg.n_embd
        self.c_fc = Dense(C, 4 * C, cfg, device, site="c_fc", tp=tp,
                          mode="column")
        self.c_proj = Dense(4 * C, C, cfg, device, site="c_proj", tp=tp,
                            mode="row")

    def forward(self, x, drop=None):
        h = self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))
        return h if drop is None else drop.hidden(h)


# the fp8 sites of a block's sublayers, in call order
ATTN_SITES = ("c_attn", "c_proj")
MLP_SITES = ("c_fc", "c_proj")


class Block(nn.Module):
    def __init__(self, cfg, device=None, tp=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg, device=device)
        self.attn = CausalSelfAttention(cfg, device, tp=tp)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg, device=device)
        self.mlp = MLP(cfg, device, tp=tp)

    def forward(self, x, drop=None, keep=(True, True), gate=False,
                **attn_kw):
        """``keep``: progressive layer drop's coins for the attention and
        the MLP sublayer. A dropped sublayer is not run and its fp8 sites
        keep their keys; with ``gate`` (JAX's scanned block) it runs and
        its output is multiplied by 0."""
        if keep[0] or gate:
            y = self.attn(self.ln_1(x), drop=drop, **attn_kw)
            x = x + (y if keep[0] else y * 0)
        else:
            fp8_ops.skip_sites(ATTN_SITES)
        if keep[1] or gate:
            y = self.mlp(self.ln_2(x), drop=drop)
            x = x + (y if keep[1] else y * 0)
        else:
            fp8_ops.skip_sites(MLP_SITES)
        return x


class _Dropout:
    """One training forward's dropout: ``rate``, the hidden-state
    ``generator`` and the attention-prob hash seed of the current layer
    (``fold_in_seed(seed, layer)``)."""

    def __init__(self, rate, seed, generator, attn_seed=None, row_offset=0):
        self.rate = rate
        self.seed = seed
        self.generator = generator
        self.attn_seed = attn_seed
        self.row_offset = row_offset    # this forward's first global row

    def layer(self, i):
        from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
        return _Dropout(self.rate, self.seed, self.generator,
                        fold_in_seed(self.seed, i), self.row_offset)

    def hidden(self, x):
        return hidden_dropout(x, self.rate, self.generator)


REMAT_POLICIES = ("full", "dots", "nothing")
# remat_policy -> activation checkpointing policy
_CHECKPOINT_POLICY = {"full": "nothing", "dots": "dots"}


def remat_block(block, x, drop, policy, keep=(True, True), gate=False):
    """``block(x, drop=drop, keep=keep, gate=gate)`` under activation
    checkpointing with ``policy`` ("full" or "dots"). The recompute
    replays the forward's state (``activation_checkpointing.
    checkpointing.replayable``): the hidden-dropout generator runs from
    where the block's forward started (and is put back where the forward
    left it), and the fp8 sites take the forward's state keys. ``block``
    is a :class:`Block` or one layer of :class:`StackedBlocks`."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing.\
        checkpointing import checkpoint
    return checkpoint(
        lambda h, d: block(h, drop=d, keep=keep, gate=gate), x, drop,
        policy=_CHECKPOINT_POLICY[policy])


PLD_STREAM = 0x504C44   # folded into the forward's seed for the PLD coins


def pld_keep_prob(layer, n_layer, theta):
    """Progressive layer drop's keep probability of block ``layer``'s
    sublayers (JAX ``Block``: ``1 - (l + 1) / L * (1 - theta)``)."""
    return 1.0 - (layer + 1) / n_layer * (1.0 - theta)


def pld_coins(theta, n_layer, seed):
    """``[(keep_attn, keep_mlp)] * n_layer`` for one forward: two draws a
    block, in order, from a CPU generator seeded from ``seed`` (the rank
    folded in as the hidden dropout's, ``dropout_generator``)."""
    from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
    gen = dropout_generator(fold_in_seed(seed, PLD_STREAM), "cpu")
    coins = []
    for i in range(n_layer):
        p = pld_keep_prob(i, n_layer, float(theta))
        a = bool(torch.rand((), generator=gen) < p)
        m = bool(torch.rand((), generator=gen) < p)
        coins.append((a, m))
    return coins


class _StackedLayer:
    """Layer ``i`` of a :class:`StackedBlocks`: the template block run on
    that layer's views of the stacked weights."""

    def __init__(self, template, params):
        self.template = template
        self.params = params

    def __call__(self, x, **kw):
        return torch.func.functional_call(self.template, self.params, (x,),
                                          kw)


class StackedBlocks(nn.Module):
    """``scan_layers``: every block weight stacked on a leading layer
    axis, under the block's own module names (``ln_1.weight`` ``[L, C]``,
    ``attn.c_attn.weight`` ``[L, 3C, C]``, ...). :meth:`layers` takes the
    stack apart once (``unbind(0)``); each layer runs a weightless
    template :class:`Block` (on the meta device, not a submodule) through
    ``functional_call``. The engine installs and gathers the stack as one
    unit (``install_as_one``): it runs as one module call.

    With a model axis ``tp`` the template is the TP block, each stacked
    leaf the ``[L, ...]`` stack of the rank's shards, split as the
    block's leaf behind a replicated layer axis (its :class:`~deepspeed_
    tpu_torch.parallel.tensor_parallel.Shard` one dim later: JAX
    ``gpt2_partition_specs`` prepends ``None`` to a stacked leaf's spec),
    and each layer runs the block's collectives."""

    install_as_one = True

    def __init__(self, cfg, device=None, tp=None):
        super().__init__()
        self.n_layer = cfg.n_layer
        shape = Block(cfg, device="meta", tp=tp)
        for name, child in shape.named_children():
            self.add_module(name, child)
        for mod in list(self.modules())[1:]:
            for pname, p in list(mod._parameters.items()):
                stacked = nn.Parameter(torch.empty(
                    (cfg.n_layer,) + tuple(p.shape), dtype=p.dtype,
                    device=device))
                spec = getattr(p, "tp_shard", None)
                if spec is not None:
                    set_shard(stacked, spec._replace(dim=spec.dim + 1))
                mod._parameters[pname] = stacked
        object.__setattr__(self, "_template",
                           Block(cfg, device="meta", tp=tp))

    def layers(self):
        """The layers as callables with a :class:`Block`'s ``forward``
        signature."""
        stacks = {name: p.unbind(0) for name, p in self.named_parameters()}
        return [_StackedLayer(self._template,
                              {name: t[i] for name, t in stacks.items()})
                for i in range(self.n_layer)]

    def forward(self, x, run):
        """``run(layers, x)``: the caller's loop over :meth:`layers`,
        inside this module's call (so the engine's per-module install
        hooks fire around it)."""
        return run(self.layers(), x)


class GPT2LMHead(nn.Module):
    """Decoder-only LM with tied embedding / output head.

    Params are created on ``device`` in ``cfg.param_dtype`` and drawn
    from ``generator`` (a ``torch.Generator`` on the same device) with
    the JAX model's initializers: wte N(0, 0.02), wpe N(0, 0.01), Dense
    kernels lecun-normal, biases 0, LayerNorm scale 1.

    ``mpu`` (``parallel.mesh.MeshGroups`` or any Megatron ``mpu``) with
    a model axis of ``M > 1`` ranks builds this rank's shard (module
    docstring, *Tensor parallelism*).
    """

    def __init__(self, cfg, device=None, generator=None, mpu=None):
        super().__init__()
        if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {cfg.remat_policy!r} not in "
                             f"{sorted(REMAT_POLICIES)}")
        from deepspeed_tpu_torch.parallel.mesh import model_axis_of
        self.config = cfg
        self.mpu = mpu
        tp = model_axis_of(mpu)
        self.tp = tp if _tp_active(tp) else None
        vocab = cfg.vocab_size
        if self.tp is not None:
            M = tp.size
            if cfg.n_head % M:
                raise ValueError(f"n_head {cfg.n_head} does not divide the "
                                 f"model axis ({M})")
            vocab = padded_len(cfg.vocab_size, M) // M
        self.wte = nn.Parameter(torch.empty(
            vocab, cfg.n_embd, dtype=cfg.param_dtype, device=device))
        if self.tp is not None:
            set_shard(self.wte, Shard(0, 1, full=cfg.vocab_size))
        self.wpe = nn.Parameter(torch.empty(
            cfg.n_positions, cfg.n_embd, dtype=cfg.param_dtype,
            device=device))
        self.h = StackedBlocks(cfg, device, tp=self.tp) \
            if cfg.scan_layers else \
            nn.ModuleList(Block(cfg, device, tp=self.tp)
                          for _ in range(cfg.n_layer))
        self.last_pld_coins = None    # the last PLD forward's coins
        self.ln_f = LayerNorm(cfg.n_embd, cfg, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if self.tp is None:
            nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        else:
            full = torch.empty(self.config.vocab_size, self.config.n_embd,
                               dtype=self.wte.dtype, device=self.wte.device)
            nn.init.normal_(full, 0.0, 0.02, generator=generator)
            self.wte.copy_(shard_tensor(full, self.wte.tp_shard,
                                        self.tp.rank, self.tp.size))
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

    def loss_fn(self, batch, rng=None, pld_theta=None):
        """The engine's default loss: :func:`make_gpt2_loss_fn` of this
        model."""
        return make_gpt2_loss_fn(self)(batch, rng, pld_theta)

    def forward(self, input_ids, positions=None, kv_cache=None,
                attn_impl="dense", attn_block_k=128, dropout_seed=None,
                return_hidden=False, kv_page_table=None,
                truncate_layers=None, pld_theta=None):
        """Logits ``[B, T, vocab]`` in the compute dtype; with
        ``kv_cache``, ``(logits, kv_cache)`` (the cache updated in
        place). ``positions`` ``[B, T]`` places a chunk at explicit
        absolute positions (required with ``kv_cache``).
        ``dropout_seed`` (an int) turns on training dropout on the
        uncached path, and with it ``pld_theta`` (progressive layer
        drop's keep parameter); ``return_hidden`` returns the final
        hidden states instead of logits (the chunked loss applies the
        head itself). ``kv_page_table`` (``[B, pages_per_row]`` int32)
        addresses a paged cache pool. ``truncate_layers`` (cached path
        only) runs only the first that many blocks, then ``ln_f`` and the
        tied head: the speculative draft's early exit. Under
        ``scan_layers`` the cache is stacked too (``{"h": {...}}`` with a
        leading layer axis) and each layer reads and writes its slice."""
        from deepspeed_tpu_torch.inference.cache import attention_mask

        cfg = self.config
        n_run = cfg.n_layer if truncate_layers is None \
            else int(truncate_layers)
        if not 0 < n_run <= cfg.n_layer:
            raise ValueError(
                f"truncate_layers {truncate_layers} outside "
                f"1..{cfg.n_layer}")
        if truncate_layers is not None and kv_cache is None:
            raise ValueError("truncate_layers is a decode-path knob "
                             "(requires kv_cache)")
        B, T = input_ids.shape
        if positions is None:
            pos_emb = self.wpe[:T][None]
        else:
            pos_emb = self.wpe[positions]
        x = self.embed(input_ids).to(cfg.dtype) + pos_emb.to(cfg.dtype)
        drop = None
        if dropout_seed is not None and cfg.dropout > 0.0 and \
                kv_cache is None:
            drop = _Dropout(cfg.dropout, int(dropout_seed),
                            dropout_generator(dropout_seed, x.device),
                            row_offset=current_global_rows()[0])
            x = drop.hidden(x)
        if kv_cache is None:
            coins = None
            if pld_theta is not None and dropout_seed is not None:
                coins = pld_coins(pld_theta, cfg.n_layer, int(dropout_seed))
            self.last_pld_coins = coins
            remat = cfg.remat and cfg.remat_policy != "nothing" and \
                torch.is_grad_enabled()

            def run(layers, x):
                # JAX's scanned block: every layer takes the body's fp8
                # keys, and a dropped sublayer runs gated
                enter = fp8_ops.scan_keys(ATTN_SITES + MLP_SITES) \
                    if cfg.scan_layers else None
                gate = enter is not None
                for i, block in enumerate(layers):
                    d = None if drop is None else drop.layer(i)
                    keep = (True, True) if coins is None else coins[i]
                    if enter is not None:
                        enter()
                    if not (any(keep) or gate):
                        fp8_ops.skip_sites(ATTN_SITES + MLP_SITES)
                        continue
                    x = remat_block(block, x, d, cfg.remat_policy, keep,
                                    gate) \
                        if remat else block(x, drop=d, keep=keep, gate=gate)
                return x

            x = self.h(x, run) if cfg.scan_layers else run(self.h, x)
        else:
            if positions is None:
                raise ValueError("the cached path needs explicit positions")
            if cfg.scan_layers:
                stack = kv_cache["h"]
                caches = [{k: t[i] for k, t in stack.items()}
                          for i in range(n_run)]
            else:
                caches = [kv_cache[f"h_{i}"] for i in range(n_run)]
            attn_mask = None
            if attn_impl == "dense":
                # one position mask per step, shared by every layer
                attn_mask = attention_mask(caches[0], positions,
                                           page_table=kv_page_table)

            def run(layers, x):
                for block, layer_cache in zip(layers, caches):
                    x = block(x, positions=positions, kv_cache=layer_cache,
                              attn_impl=attn_impl,
                              attn_block_k=attn_block_k,
                              attn_mask=attn_mask,
                              kv_page_table=kv_page_table)
                return x

            x = self.h(x, run) if cfg.scan_layers else run(self.h, x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        logits = self.head_logits(x)
        if self.tp is not None:           # the whole vocab, padding cut
            logits = gather_vocab(logits, self.tp, cfg.vocab_size)
        if kv_cache is not None:
            return logits, kv_cache
        return logits

    def embed(self, input_ids):
        """``wte[input_ids]``; with a model axis the vocab-parallel lookup
        (each rank's rows, zeros for ids it does not hold, summed over
        the group)."""
        return vocab_parallel_embed(self.wte, input_ids, self.tp)

    def head_logits(self, x):
        """The tied head: ``x @ wte.T`` in the compute dtype (this rank's
        vocab rows with a model axis: a column-parallel consumer of the
        replicated ``x``, whose cotangent Megatron's ``f`` sums)."""
        if self.tp is not None:
            x = tp_comm.psum_grad(x, self.tp)
        return torch.matmul(x, self.wte.to(self.config.dtype).t())


def vocab_parallel_embed(table, input_ids, tp):
    """``table[input_ids]``; with a model axis ``tp`` (``table`` this
    rank's vocab rows) each rank looks up the ids it holds, zeros for the
    rest, summed over the group: one nonzero term a row, so the sum is
    exact."""
    if tp is None:
        return table[input_ids]
    n = table.shape[0]
    local = input_ids.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return tp_comm.psum_combine(rows, tp)


def gather_vocab(local_logits, tp, vocab_size):
    """The whole-vocab logits from every rank's over its vocab rows
    (rank order, the padding cut); the backward keeps this rank's
    columns."""
    return _GatherVocab.apply(local_logits, tp)[..., :vocab_size]


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


class _GatherVocab(torch.autograd.Function):
    """Every rank's logits over its vocab rows, concatenated (rank
    order); the backward keeps this rank's columns of the cotangent."""

    @staticmethod
    def forward(ctx, logits, tp):
        ctx.tp, ctx.n = tp, logits.shape[-1]
        return tp_comm.all_gather(logits.contiguous(), tp,
                                  dim=logits.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.tp.rank, ctx.n
        return g[..., r * n:(r + 1) * n], None


def vocab_parallel_cross_entropy(local_logits, labels, tp, vocab_size,
                                 ignore_index=-100):
    """``(summed token cross-entropy in fp32, valid-token count)`` from
    each rank's logits over its vocab rows (Megatron's vocab-parallel
    loss): rows past ``vocab_size`` (padding) get -inf; the row max is
    all-reduced with MAX (a constant to the gradient, as JAX's
    ``log_softmax`` stops it), the sum of exponentials and the target's
    logit with a sum (``psum_combine``: every rank holds the same loss,
    so each partial takes its cotangent once)."""
    logits = local_logits.float()
    n = logits.shape[-1]
    lo = tp.rank * n
    cols = torch.arange(lo, lo + n, device=logits.device)
    logits = torch.where(cols < vocab_size, logits,
                         torch.full((), float("-inf"),
                                    device=logits.device))
    with torch.no_grad():
        m = tp_comm.all_reduce(logits.amax(-1), tp, op="max")
    shifted = logits - m[..., None]
    total_exp = tp_comm.psum_combine(torch.exp(shifted).sum(-1), tp)
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    local = safe - lo
    mine = (local >= 0) & (local < n)
    z = torch.gather(shifted, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    z = tp_comm.psum_combine(torch.where(mine, z, 0.0), tp)
    token_loss = torch.where(mask, torch.log(total_exp) - z, 0.0)
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


def _chunk_loss_vocab_parallel(xc, lc, head, bias, tp, vocab_size,
                               ignore_index):
    logits = _HeadMatmul.apply(xc, head)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    return vocab_parallel_cross_entropy(logits, lc, tp, vocab_size,
                                        ignore_index)


def vocab_parallel_chunked_cross_entropy(x, head, bias, labels, chunk, tp,
                                         vocab_size, ignore_index=-100):
    """:func:`chunked_cross_entropy_with_head` over a vocab split on the
    model axis ``tp``: ``head`` ``[M, V / tp]`` and ``bias`` ``[V / tp]``
    (or None) are this rank's vocab columns (padded past
    ``vocab_size``). Each chunk's logits are local; their max and sum of
    exponentials are reduced over the group per chunk
    (:func:`vocab_parallel_cross_entropy`), and the recompute in the
    backward runs those collectives again, in the same order on every
    rank. ``x`` takes Megatron's ``f`` once (its cotangent summed over
    the group), the head's gradient is this rank's columns. At one rank
    (``tp`` None or of size 1) it is :func:`chunked_cross_entropy_with_
    head`, bit for bit."""
    if tp is None or tp.size == 1:
        return chunked_cross_entropy_with_head(x, head, bias, labels, chunk,
                                               ignore_index)
    from torch.utils.checkpoint import checkpoint

    x = tp_comm.psum_grad(x, tp)
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
        s, c = checkpoint(_chunk_loss_vocab_parallel, x[:, sl],
                          labels[:, sl], head, bias, tp, int(vocab_size),
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
    engine's int dropout seed, None for a deterministic forward;
    ``pld_theta`` progressive layer drop's keep parameter (applied only
    with ``rng``, as in JAX)."""

    def loss_fn(batch, rng=None, pld_theta=None):
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat(
                [input_ids[:, 1:],
                 torch.full((input_ids.shape[0], 1), -100,
                            dtype=input_ids.dtype,
                            device=input_ids.device)], dim=1)
        chunk = model.config.loss_chunk
        tp = getattr(model, "tp", None)
        if tp is not None:
            hidden = model(input_ids, dropout_seed=rng, return_hidden=True,
                           pld_theta=pld_theta)
            if chunk:
                total, count = vocab_parallel_chunked_cross_entropy(
                    hidden, model.wte.to(model.config.dtype).t(), None,
                    labels, chunk, tp, model.config.vocab_size)
            else:
                total, count = vocab_parallel_cross_entropy(
                    model.head_logits(hidden), labels, tp,
                    model.config.vocab_size)
            return total / torch.clamp(count, min=1)
        if chunk:
            hidden = model(input_ids, dropout_seed=rng, return_hidden=True,
                           pld_theta=pld_theta)
            total, count = chunked_cross_entropy_sum_and_count(
                hidden, model.wte.to(model.config.dtype), labels, chunk)
            return total / torch.clamp(count, min=1)
        return cross_entropy_loss(
            model(input_ids, dropout_seed=rng, pld_theta=pld_theta), labels)

    return loss_fn


# ---------------------------------------------------------------------------
# JAX param tree -> state_dict
# ---------------------------------------------------------------------------

_LAYER_KEY_RE = re.compile(r"^h_(\d+)$")
_SD_LAYER_RE = re.compile(r"^h\.(\d+)\.(.+)$")
_DENSE = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
          ("mlp", "c_proj"))


def _stack(leaves):
    if torch.is_tensor(leaves[0]):
        return torch.stack(leaves, 0)
    return np.stack([np.asarray(x) for x in leaves], 0)


def _tree_map(fn, *trees):
    if hasattr(trees[0], "items"):
        return {k: _tree_map(fn, *(t[k] for t in trees))
                for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while hasattr(tree, "items"):
        tree = next(iter(tree.values()))
    return tree


def stack_gpt2_layer_params(params):
    """Unrolled JAX param tree (``h_0`` ... ``h_{L-1}``, nested mappings
    of numpy arrays or tensors) -> the ``scan_layers`` layout: one ``h``
    subtree whose leaves gain a leading layer axis; wte/wpe/ln_f pass
    through (JAX ``models/gpt2.py:607``). Bit-exact, and the inverse of
    :func:`unstack_gpt2_layer_params`."""
    idxs = sorted(int(m.group(1)) for k in params
                  if (m := _LAYER_KEY_RE.match(str(k))))
    if not idxs:
        raise ValueError("no per-layer 'h_<i>' entries to stack")
    if idxs != list(range(len(idxs))):
        raise ValueError(f"non-contiguous layer indices: {idxs}")
    out = {k: v for k, v in params.items()
           if not _LAYER_KEY_RE.match(str(k))}
    out["h"] = _tree_map(lambda *leaves: _stack(leaves),
                         *[params[f"h_{i}"] for i in idxs])
    return out


def unstack_gpt2_layer_params(params):
    """``scan_layers`` layout -> unrolled ``h_0`` ... ``h_{L-1}`` tree
    (JAX ``models/gpt2.py:634``)."""
    if "h" not in params:
        raise ValueError("no stacked 'h' entry to unstack")
    out = {k: v for k, v in params.items() if str(k) != "h"}
    stacked = params["h"]
    for i in range(_first_leaf(stacked).shape[0]):
        out[f"h_{i}"] = _tree_map(lambda leaf: leaf[i], stacked)
    return out


def stack_gpt2_state_dict(sd):
    """A :class:`GPT2LMHead` ``state_dict`` (``h.<i>.<name>``) as the
    ``scan_layers`` model's (``h.<name>``, ``[L, ...]``). Bit-exact."""
    layers = {}
    out = {}
    for key, t in sd.items():
        m = _SD_LAYER_RE.match(key)
        if m is None:
            out[key] = t
        else:
            layers.setdefault(m.group(2), {})[int(m.group(1))] = t
    for name, by_layer in layers.items():
        idxs = sorted(by_layer)
        if idxs != list(range(len(idxs))):
            raise ValueError(f"non-contiguous layer indices: {idxs}")
        out[f"h.{name}"] = torch.stack([by_layer[i] for i in idxs], 0)
    return out


def unstack_gpt2_state_dict(sd):
    """Inverse of :func:`stack_gpt2_state_dict`."""
    out = {}
    for key, t in sd.items():
        if key.startswith("h.") and not _SD_LAYER_RE.match(key):
            for i in range(t.shape[0]):
                out[f"h.{i}.{key[2:]}"] = t[i].clone()
        else:
            out[key] = t
    return out


def with_layout(model, scan_layers):
    """``model`` itself if its layout is ``scan_layers``'s, else a new
    :class:`GPT2LMHead` in the other layout holding the same weights
    (the state dict stacked or unstacked, bit for bit), on the same
    device; a model built for a model axis keeps its ``mpu`` and
    shard."""
    cfg = model.config
    if bool(cfg.scan_layers) == bool(scan_layers):
        return model
    sd = model.state_dict()
    sd = stack_gpt2_state_dict(sd) if scan_layers else \
        unstack_gpt2_state_dict(sd)
    out = GPT2LMHead(dataclasses.replace(cfg, scan_layers=bool(scan_layers)),
                     device="meta", mpu=model.mpu)
    specs = {n: getattr(p, "tp_shard", None)
             for n, p in out.named_parameters()}
    out.load_state_dict(sd, assign=True)
    for name, p in out.named_parameters():    # (assign drops the marks)
        if specs[name] is not None:
            set_shard(p, specs[name])
    return out


def _is_stacked_name(name):
    """A ``scan_layers`` block leaf (``h.<name>``, no layer index)."""
    return name.startswith("h.") and _SD_LAYER_RE.match(name) is None


def gpt2_partition_specs(state, vocab_size):
    """``{name: Shard or None}`` of a GPT-2 ``state_dict`` (names only are
    read): JAX ``gpt2_partition_specs``'s Megatron layout on the port's
    ``[out, in]`` weights (module docstring). A stacked block leaf of the
    ``scan_layers`` layout (``h.<name>``, ``[L, ...]``) is split as its
    layer's leaf behind a replicated layer axis: its spec's dim one
    later."""
    specs = {}
    for name in state:
        spec = _layer_spec(name, vocab_size)
        if spec is not None and _is_stacked_name(name):
            spec = spec._replace(dim=spec.dim + 1)
        specs[name] = spec
    return specs


def _layer_spec(name, vocab_size):
    """The :class:`Shard` of an unrolled GPT-2 leaf ``name``, or None."""
    if name == "wte":
        return Shard(0, 1, full=int(vocab_size))
    if name.endswith(("attn.c_attn.weight", "attn.c_attn.bias")):
        return Shard(0, 3)
    if name.endswith(("mlp.c_fc.weight", "mlp.c_fc.bias")):
        return Shard(0)
    if name.endswith("c_proj.weight"):
        return Shard(1)
    return None


def shard_gpt2_state_dict(state, model_rank, model_size, vocab_size=None):
    """Rank ``model_rank``'s shard of a whole GPT-2 ``state_dict`` under
    :func:`gpt2_partition_specs` (``wte`` padded when ``model_size`` does
    not divide the vocab)."""
    if model_size == 1:
        return dict(state)
    vocab = int(vocab_size if vocab_size is not None
                else state["wte"].shape[0])
    specs = gpt2_partition_specs(state, vocab)
    return {n: shard_tensor(t, specs[n], model_rank, model_size)
            for n, t in state.items()}


def convert_gpt2_params(params, scan_layers=False, model_rank=0,
                        model_size=1):
    """The JAX package's GPT-2 param tree (nested mappings of numpy
    arrays, unrolled ``h_<i>`` or stacked ``h`` layout) as a
    :class:`GPT2LMHead` ``state_dict`` of fp32 CPU tensors: the unrolled
    model's, or with ``scan_layers`` the stacked model's; with
    ``model_size > 1`` the shard of model rank ``model_rank`` of either
    layout (:func:`shard_gpt2_state_dict`).

    Flax ``Dense.kernel`` is ``[in, out]`` and becomes ``weight``
    ``[out, in]``; LayerNorm ``scale``/``bias`` become
    ``weight``/``bias``; the output head is tied to ``wte`` and has no
    entry of its own.
    """
    if "h" in params:
        params = unstack_gpt2_layer_params(params)
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
    if scan_layers:
        sd = stack_gpt2_state_dict(sd)
    return shard_gpt2_state_dict(sd, model_rank, model_size)
