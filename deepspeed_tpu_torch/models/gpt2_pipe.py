"""GPT-2 as a PipelineModule (port of ``deepspeed_tpu/models/gpt2_pipe.py``).

An embedding prologue (tied with the LM head, the reference's
``TiedLayerSpec`` pattern), a homogeneous stack of the port's GPT-2
blocks (so K1-K3 run in every block when ``use_flash_attention``), and a
final-norm + tied-head epilogue.

The layers compute what :class:`~deepspeed_tpu_torch.models.gpt2.
GPT2LMHead` computes, op for op: the embedding ``wte[ids].to(dtype) +
wpe[:T].to(dtype)``, each block with its attention dropout keyed by the
block's global index, ``ln_f``, and the head ``x @ wte.to(dtype).T``.
So one seed drives the pipeline, its sequential oracle and the
unpipelined engine: :func:`lm_state_to_pipe` and
:func:`pipe_state_to_lm` move the weights between a ``GPT2LMHead``
``state_dict`` and the pipe layout (``runtime/pipe/pipeline.py``), bit
for bit, and :func:`convert_gpt2_pipe_params` turns the JAX package's
``PipelineParts.params`` into the pipe layout.
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import (
    _DENSE,
    Block,
    GPT2Config,
    LayerNorm,
    _Dropout,
    cross_entropy_sum_and_count,
)
from deepspeed_tpu_torch.ops.flash_attention import (
    current_global_rows,
    fold_in_seed,
)
from deepspeed_tpu_torch.runtime.pipe.module import (
    LayerSpec,
    PipelineModule,
    TiedLayerSpec,
)


def _drop(cfg, ctx):
    """The block's :class:`~deepspeed_tpu_torch.models.gpt2._Dropout` for
    ``ctx`` (None without a seed or at rate 0)."""
    if ctx is None or ctx.seed is None or cfg.dropout <= 0.0:
        return None
    return _Dropout(cfg.dropout, ctx.seed, ctx.generator,
                    None if ctx.layer is None else
                    fold_in_seed(ctx.seed, ctx.layer),
                    row_offset=current_global_rows()[0])


class GPT2Embed(nn.Module):
    """Prologue layer: ``{"input_ids"}`` -> hidden states; owns the tied
    ``wte`` / ``wpe``."""

    pipe_context = True

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.wte = nn.Parameter(torch.empty(
            config.vocab_size, config.n_embd, dtype=config.param_dtype))
        self.wpe = nn.Parameter(torch.empty(
            config.n_positions, config.n_embd, dtype=config.param_dtype))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=generator)

    def forward(self, micro, ctx=None):
        cfg = self.config
        ids = micro["input_ids"]
        T = ids.shape[1]
        x = self.wte[ids].to(cfg.dtype) + self.wpe[:T][None].to(cfg.dtype)
        drop = _drop(cfg, ctx)
        return x if drop is None else drop.hidden(x)


def tied_lm_head(module, x):
    """Epilogue forward of the tied embedding: logits = x @ wte^T
    (``TiedLayerSpec.forward_fn``)."""
    return torch.matmul(x, module.wte.to(x.dtype).t())


class GPT2BlockLayer(Block):
    """One transformer block of the pipelined body (the port's
    :class:`~deepspeed_tpu_torch.models.gpt2.Block`, its attention
    dropout keyed by the global layer index)."""

    pipe_context = True

    def __init__(self, config: GPT2Config):
        super().__init__(config)
        self.config = config

    def reset_parameters(self, generator=None):
        for mod in self.modules():
            if mod is not self and hasattr(mod, "reset_parameters"):
                mod.reset_parameters(generator)

    def forward(self, x, ctx=None):
        return super().forward(x, drop=_drop(self.config, ctx))

    @staticmethod
    def reference_leaves():
        """The block's leaves in JAX's flat order (the flax paths sorted)
        as ``(name, transposed)``: the order 1-bit Adam compresses a
        stage's body in (``runtime/fp16/onebit_adam.py``)."""
        return [(name, transposed) for name, _, transposed in
                sorted(_block_leaves(), key=lambda leaf: leaf[1])]


class GPT2FinalNorm(LayerNorm):
    """Epilogue ``ln_f``."""

    def __init__(self, config: GPT2Config):
        super().__init__(config.n_embd, config)
        self.config = config

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)


def gpt2_pipe_loss(logits, micro):
    """Per-micro-batch LM loss as (sum, token count): the weighted form
    makes the pipeline's global average exact under uneven ignore-index
    masks."""
    input_ids = micro["input_ids"]
    labels = micro.get("labels")
    if labels is None:
        labels = torch.cat(
            [input_ids[:, 1:],
             torch.full((input_ids.shape[0], 1), -100, dtype=input_ids.dtype,
                        device=input_ids.device)], dim=1)
    return cross_entropy_sum_and_count(logits, labels)


def gpt2_pipeline_module(config: GPT2Config, num_stages=None, seq_len=None,
                         activation_checkpoint_interval=0,
                         seed_layers=False) -> PipelineModule:
    """Spec list: [tied embed] + n_layer x [block] + [ln_f, tied head]."""
    T = seq_len or min(config.n_positions, 64)
    specs = [TiedLayerSpec("embed", GPT2Embed, config)]
    specs += [LayerSpec(GPT2BlockLayer, config)
              for _ in range(config.n_layer)]
    specs += [LayerSpec(GPT2FinalNorm, config),
              TiedLayerSpec("embed", GPT2Embed, config,
                            forward_fn=tied_lm_head)]
    example = {"input_ids": np.zeros((2, T), np.int32)}
    return PipelineModule(layers=specs,
                          num_stages=num_stages,
                          loss_fn=gpt2_pipe_loss,
                          seed_layers=seed_layers,
                          partition_method="uniform",
                          activation_checkpoint_interval=(
                              activation_checkpoint_interval),
                          example_input=example)


# ---------------------------------------------------------------------------
# weights: the JAX PipelineParts.params, GPT2LMHead and the pipe layout
# ---------------------------------------------------------------------------

def _block_leaves():
    """(port name, flax path, transposed) of a block's leaves."""
    out = []
    for ln in ("ln_1", "ln_2"):
        out.append((f"{ln}.weight", (ln, "scale"), False))
        out.append((f"{ln}.bias", (ln, "bias"), False))
    for mod, name in _DENSE:
        out.append((f"{mod}.{name}.weight", (mod, name, "kernel"), True))
        out.append((f"{mod}.{name}.bias", (mod, name, "bias"), False))
    return out


def convert_gpt2_pipe_params(params):
    """The JAX ``PipelineParts.params`` of ``gpt2_pipeline_module`` (nested
    mappings of numpy arrays: ``prologue``, ``body`` stacked ``[S, L/S,
    ...]``, ``epilogue``, ``tied``) in the port's pipe layout, as fp32 CPU
    tensors: ``tied.embed.wte`` / ``.wpe``, ``epilogue.layer_0.weight`` /
    ``.bias`` (ln_f) and ``body.<block param>`` ``[S, L/S, ...]`` (flax
    kernels ``[in, out]`` become ``weight`` ``[out, in]``)."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out = {"tied.embed.wte": t(params["tied"]["embed"]["wte"]),
           "tied.embed.wpe": t(params["tied"]["embed"]["wpe"])}
    ln_f = params["epilogue"]["layer_0"]
    out["epilogue.layer_0.weight"] = t(ln_f["scale"])
    out["epilogue.layer_0.bias"] = t(ln_f["bias"])
    body = params["body"]
    for name, path, transposed in _block_leaves():
        leaf = body
        for k in path:
            leaf = leaf[k]
        leaf = t(leaf)
        if transposed:
            leaf = leaf.transpose(-1, -2)
        out[f"body.{name}"] = leaf.contiguous()
    return out


def lm_state_to_pipe(sd, num_stages):
    """A :class:`GPT2LMHead` ``state_dict`` (unrolled ``h.<i>.<name>``) in
    the pipe layout over ``num_stages`` stages (bit for bit)."""
    n_layer = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("h."))
    if n_layer % num_stages:
        raise ValueError(f"{n_layer} pipelined layers do not divide evenly "
                         f"over {num_stages} stages; adjust n_layer or the "
                         f"pipe axis")
    lps = n_layer // num_stages
    out = {"tied.embed.wte": sd["wte"], "tied.embed.wpe": sd["wpe"],
           "epilogue.layer_0.weight": sd["ln_f.weight"],
           "epilogue.layer_0.bias": sd["ln_f.bias"]}
    for name, _, _ in _block_leaves():
        layers = torch.stack([sd[f"h.{i}.{name}"] for i in range(n_layer)])
        out[f"body.{name}"] = layers.reshape(
            (num_stages, lps) + tuple(layers.shape[1:]))
    return out


def pipe_state_to_lm(state):
    """The pipe layout as a :class:`GPT2LMHead` ``state_dict`` (inverse of
    :func:`lm_state_to_pipe`)."""
    out = {"wte": state["tied.embed.wte"], "wpe": state["tied.embed.wpe"],
           "ln_f.weight": state["epilogue.layer_0.weight"],
           "ln_f.bias": state["epilogue.layer_0.bias"]}
    for name, _, _ in _block_leaves():
        stacked = state[f"body.{name}"]
        flat = stacked.reshape((-1,) + tuple(stacked.shape[2:]))
        for i in range(flat.shape[0]):
            out[f"h.{i}.{name}"] = flat[i]
    return out
