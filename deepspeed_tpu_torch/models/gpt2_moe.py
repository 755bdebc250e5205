"""GPT-2 with MoE FFNs on every ``moe_every``-th block (port of
``deepspeed_tpu/models/gpt2_moe.py``).

Dense blocks are the port's GPT-2 :class:`~deepspeed_tpu_torch.models.
gpt2.Block` (its Megatron blocks at model > 1); an MoE block keeps the
attention half and replaces the MLP with :class:`~deepspeed_tpu_torch.
moe.layer.MoE` over the ``mpu``'s expert group, replicated over
``model`` (JAX ``gpt2_moe_partition_specs`` leaves the MoE half
unsplit on that axis). The loss is the token cross-entropy plus the
blocks' load-balancing aux terms.

The forward's ``deterministic`` picks the MoE capacity factor (JAX:
``rng is None``): the engine passes a dropout seed on every training
forward, whatever the dropout rate, and None in ``eval_batch``, so the
loss takes the training capacity exactly when the model is training.

:func:`convert_gpt2_moe_params` turns the JAX param tree into this
model's ``state_dict`` (Dense kernels transposed to ``[out, in]``, MoE
leaves in JAX's layout), cut to an expert rank and a model rank.
"""

import dataclasses
import re

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import (
    _DENSE,
    Block,
    CausalSelfAttention,
    GPT2Config,
    GPT2LMHead,
    LayerNorm,
    _Dropout,
    _tp_active,
    cross_entropy_loss,
    gpt2_partition_specs,
    vocab_parallel_cross_entropy,
)
from deepspeed_tpu_torch.moe.layer import MoE, MoEConfig, moe_param_spec
from deepspeed_tpu_torch.ops.flash_attention import (
    current_global_rows,
    dropout_generator,
)
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    padded_len,
    set_shard,
    shard_tensor,
)


@dataclasses.dataclass(frozen=True)
class GPT2MoEConfig(GPT2Config):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2            # every Nth block is MoE (GShard style)
    aux_loss_weight: float = 0.01


def gpt2_moe_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("n_positions", 64)
    kw.setdefault("n_embd", 64)
    kw.setdefault("n_layer", 2)
    kw.setdefault("n_head", 4)
    kw.setdefault("num_experts", 4)
    return GPT2MoEConfig(**kw)


def is_moe_layer(cfg, i):
    return cfg.moe_every > 0 and i % cfg.moe_every == cfg.moe_every - 1


class MoEBlock(nn.Module):
    """Pre-LN block: the GPT-2 attention, then the MoE FFN (flax
    LayerNorms, eps 1e-6). Returns ``(x, aux)``."""

    def __init__(self, cfg, device=None, tp=None, ep=None, data=None):
        super().__init__()
        C = cfg.n_embd
        self.ln_1 = LayerNorm(C, cfg, device=device)
        self.attn = CausalSelfAttention(cfg, device, tp=tp)
        self.ln_2 = LayerNorm(C, cfg, device=device)
        self.moe = MoE(MoEConfig(num_experts=cfg.num_experts,
                                 top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 aux_loss_weight=cfg.aux_loss_weight,
                                 dtype=cfg.dtype), 4 * C, C, group=ep,
                       device=device, data_group=data)

    def forward(self, x, drop=None, deterministic=True):
        x = x + self.attn(self.ln_1(x), drop=drop)
        y, aux = self.moe(self.ln_2(x), deterministic)
        return x + y, aux


class GPT2MoELMHead(GPT2LMHead):
    """Decoder LM with MoE FFNs every ``moe_every`` blocks; ``forward``
    returns ``(logits, total_aux_loss)``. ``mpu`` (``MeshGroups``): the
    model axis splits the dense half as GPT-2's Megatron layout, the
    expert axis the MoE banks (each rank holds ``E / ep`` experts), and
    the aux loss's means run over the data group's global batch. The
    training path only (no KV cache, scan_layers, remat or chunked
    loss)."""

    def __init__(self, cfg, device=None, generator=None, mpu=None):
        nn.Module.__init__(self)
        if cfg.scan_layers or cfg.loss_chunk or cfg.remat:
            raise NotImplementedError(
                "GPT-2 MoE runs the unrolled layers, the whole-vocab loss "
                "and no remat")
        from deepspeed_tpu_torch.parallel.mesh import (
            data_axis_of, expert_axis_of, model_axis_of)
        self.config = cfg
        self.mpu = mpu
        tp = model_axis_of(mpu)
        self.tp = tp if _tp_active(tp) else None
        ep = expert_axis_of(mpu)
        self.ep = ep if ep.size > 1 else None
        vocab = cfg.vocab_size
        if self.tp is not None:
            if cfg.n_head % tp.size:
                raise ValueError(f"n_head {cfg.n_head} does not divide the "
                                 f"model axis ({tp.size})")
            vocab = padded_len(cfg.vocab_size, tp.size) // tp.size
        self.wte = nn.Parameter(torch.empty(
            vocab, cfg.n_embd, dtype=cfg.param_dtype, device=device))
        if self.tp is not None:
            set_shard(self.wte, Shard(0, 1, full=cfg.vocab_size))
        self.wpe = nn.Parameter(torch.empty(
            cfg.n_positions, cfg.n_embd, dtype=cfg.param_dtype,
            device=device))
        self.h = nn.ModuleList(
            MoEBlock(cfg, device, tp=self.tp, ep=self.ep,
                     data=data_axis_of(mpu))
            if is_moe_layer(cfg, i) else Block(cfg, device, tp=self.tp)
            for i in range(cfg.n_layer))
        self.last_pld_coins = None
        self.ln_f = LayerNorm(cfg.n_embd, cfg, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        for mod in self.modules():
            if isinstance(mod, MoE):
                mod.reset_parameters(generator)

    def loss_fn(self, batch, rng=None):
        return make_gpt2_moe_loss_fn(self)(batch, rng)

    def forward(self, input_ids, deterministic=True, dropout_seed=None,
                return_hidden=False):
        """``(logits [B, T, vocab], aux)``; ``return_hidden`` gives the
        final hidden states in place of the logits. ``dropout_seed`` (an
        int) turns on training dropout; ``deterministic`` picks the MoE
        capacity factor (module docstring)."""
        cfg = self.config
        T = input_ids.shape[1]
        x = self.embed(input_ids).to(cfg.dtype) + \
            self.wpe[:T][None].to(cfg.dtype)
        drop = None
        if dropout_seed is not None and cfg.dropout > 0.0:
            drop = _Dropout(cfg.dropout, int(dropout_seed),
                            dropout_generator(dropout_seed, x.device),
                            row_offset=current_global_rows()[0])
            x = drop.hidden(x)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(self.h):
            d = None if drop is None else drop.layer(i)
            if isinstance(block, MoEBlock):
                x, aux = block(x, drop=d, deterministic=deterministic)
                aux_total = aux_total + aux
            else:
                x = block(x, drop=d)
        x = self.ln_f(x)
        if return_hidden:
            return x, aux_total
        logits = self.head_logits(x)
        if self.tp is not None:
            from deepspeed_tpu_torch.models.gpt2 import _GatherVocab
            logits = _GatherVocab.apply(logits, self.tp)[
                ..., :cfg.vocab_size]
        return logits, aux_total

    def routing(self):
        """``{layer: (kept, routed)}`` token counts per expert of each MoE
        block's last forward (``MoE.last_routing``)."""
        return {i: b.moe.last_routing for i, b in enumerate(self.h)
                if isinstance(b, MoEBlock)}


def make_gpt2_moe_loss_fn(model):
    """``loss_fn(batch, rng=None)``: cross-entropy (next-token shift, the
    last position ignored, or explicit ``labels``) plus the aux loss
    (JAX ``make_gpt2_moe_loss_fn``). ``rng`` is the engine's int dropout
    seed, None for a deterministic forward."""

    def loss_fn(batch, rng=None):
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat(
                [input_ids[:, 1:],
                 torch.full((input_ids.shape[0], 1), -100,
                            dtype=input_ids.dtype,
                            device=input_ids.device)], dim=1)
        hidden, aux = model(input_ids, deterministic=rng is None,
                            dropout_seed=rng, return_hidden=True)
        if model.tp is not None:
            total, count = vocab_parallel_cross_entropy(
                model.head_logits(hidden), labels, model.tp,
                model.config.vocab_size)
            ce = total / torch.clamp(count, min=1)
        else:
            ce = cross_entropy_loss(model.head_logits(hidden), labels)
        return ce + aux

    return loss_fn


def gpt2_moe_partition_specs(state, vocab_size):
    """``{name: Shard or None}`` of a GPT-2 MoE ``state_dict``: GPT-2's
    Megatron specs for the dense half, ``Shard(0, axis="expert")`` for
    the ``moe.expert_*`` banks (JAX ``gpt2_moe_partition_specs``)."""
    base = gpt2_partition_specs(state, vocab_size)
    return {n: moe_param_spec(n, state[n]) if ".moe." in n else base[n]
            for n in state}


_LAYER_KEY_RE = re.compile(r"^h_(\d+)$")


def convert_gpt2_moe_params(params, expert_rank=0, expert_size=1,
                            model_rank=0, model_size=1):
    """The JAX GPT-2 MoE param tree (nested mappings of numpy arrays) as a
    :class:`GPT2MoELMHead` ``state_dict`` of fp32 CPU tensors, cut to
    expert rank ``expert_rank`` of ``expert_size`` and model rank
    ``model_rank`` of ``model_size`` (whole leaves at 1 and 1)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    sd = {"wte": t(params["wte"]), "wpe": t(params["wpe"]),
          "ln_f.weight": t(params["ln_f"]["scale"]),
          "ln_f.bias": t(params["ln_f"]["bias"])}
    idxs = sorted(int(m.group(1)) for k in params
                  if (m := _LAYER_KEY_RE.match(str(k))))
    for i in idxs:
        layer = params[f"h_{i}"]
        for ln in ("ln_1", "ln_2"):
            sd[f"h.{i}.{ln}.weight"] = t(layer[ln]["scale"])
            sd[f"h.{i}.{ln}.bias"] = t(layer[ln]["bias"])
        for mod, name in _DENSE:
            if mod in layer:
                dense = layer[mod][name]
                sd[f"h.{i}.{mod}.{name}.weight"] = \
                    t(dense["kernel"]).t().contiguous()
                sd[f"h.{i}.{mod}.{name}.bias"] = t(dense["bias"])
        for leaf, v in (layer.get("moe") or {}).items():
            sd[f"h.{i}.moe.{leaf}"] = t(v)
    specs = gpt2_moe_partition_specs(sd, sd["wte"].shape[0])
    out = {}
    for name, x in sd.items():
        spec = specs[name]
        if spec is not None:
            rank, size = (expert_rank, expert_size) \
                if spec.axis == "expert" else (model_rank, model_size)
            x = shard_tensor(x, spec, rank, size)
        out[name] = x
    return out
