"""BERT model family on DeepSpeedTransformerLayer (port of
``deepspeed_tpu/models/bert.py``).

The reference's flagship workload is BERT pretraining with the fused
transformer kernel (`docs/_tutorials/bert-pretraining.md`). This module
is the port's counterpart: embeddings + N transformer blocks + the MLM
(or span-QA) head, post-LN (classic BERT) by default or pre-LN, with the
block-sparse attention core when ``sparse_attention`` holds a
``SparsityConfig``. The modules reproduce the flax model's numerics so
converted weights give the same logits:

- the embeddings sum word, position and token-type rows in fp32, then a
  flax ``nn.LayerNorm(epsilon=1e-12)`` (``E[x^2] - E[x]^2`` statistics,
  fp32), dropout, and a cast to the compute dtype;
- the layers are :class:`DeepSpeedTransformerLayer` (two-pass variance
  layer norm, exact GELU), the additive mask is -10000 on padded keys;
- the MLM head is ``Dense`` -> exact GELU -> ``LayerNorm(1e-12)`` in the
  compute dtype -> the ``decoder`` Dense to the vocabulary.

The losses follow the port's engine convention ``loss_fn(batch, rng)``
(``rng`` the int dropout seed, None for a deterministic forward).
:func:`convert_bert_params` turns the JAX package's param tree (numpy
leaves) into a ``state_dict``.

**Tensor parallelism** (``BertForMaskedLM(cfg, mpu=...)`` /
``BertForQuestionAnswering(cfg, mpu=...)``, Megatron's layout, JAX
``bert_partition_specs``): the model holds its model rank's shard (M
ranks). The encoder layers are the Megatron form of
:class:`DeepSpeedTransformerLayer` (``ops/transformer/transformer.py``);
``word_embeddings`` is split over the vocab and looked up vocab-parallel
(``models/gpt2.py:vocab_parallel_embed``); the MLM ``decoder`` is column
parallel over the vocab, its kernel and its bias (JAX replicates the
1-D bias; the port splits it with its kernel's columns, which gives the
same whole leaf and gradient); the MLM loss is the vocab-parallel
cross-entropy (chunked under ``loss_chunk``:
``vocab_parallel_chunked_cross_entropy``), and ``forward`` gathers the
whole-vocab logits. A vocab the axis does not divide (30522 at 4) is
padded with zero rows, as GPT-2's ``wte``: their logits are -inf and
whole leaves drop them. Position and token-type tables, the MLM
transform, the QA head and the norms are replicated.
:func:`bert_partition_specs` gives each leaf's ``Shard``,
:func:`shard_bert_state_dict` a rank's shard of a whole state dict, and
``convert_bert_params(params, model_rank, model_size)`` converts straight
to a shard.
"""

import dataclasses
import re
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.models.gpt2 import (
    Dense,
    LayerNorm,
    cross_entropy_loss,
    gather_vocab,
    vocab_parallel_chunked_cross_entropy,
    vocab_parallel_cross_entropy,
    vocab_parallel_embed,
)
from deepspeed_tpu_torch.ops.flash_attention import (
    dropout_generator,
    fold_in_seed,
    hidden_dropout,
)
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from deepspeed_tpu_torch.ops.transformer.transformer import TP_SPECS
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    padded_len,
    set_shard,
    shard_tensor,
)


def _model_axis(mpu):
    """The model ``AxisGroup`` of ``mpu`` when it has more than one
    rank, else None."""
    from deepspeed_tpu_torch.parallel.mesh import model_axis_of
    tp = model_axis_of(mpu)
    return tp if tp is not None and tp.size > 1 else None


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    pre_layer_norm: bool = False      # classic BERT is post-LN
    dtype: torch.dtype = torch.float32         # compute dtype
    param_dtype: torch.dtype = torch.float32   # master param dtype
    use_flash_attention: bool = False
    # SparsityConfig instance -> every layer's attention goes block-sparse
    # (the SparseAttentionUtils adoption path; heads must match)
    sparse_attention: Optional[Any] = None
    loss_chunk: int = 0           # >0: chunked MLM cross-entropy (the
    #                               [B, T, vocab] logits never materialize)


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_hidden_layers", 24)
    kw.setdefault("num_attention_heads", 16)
    kw.setdefault("intermediate_size", 4096)
    return BertConfig(**kw)


def bert_tiny(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("hidden_size", 64)
    kw.setdefault("num_hidden_layers", 2)
    kw.setdefault("num_attention_heads", 4)
    kw.setdefault("intermediate_size", 128)
    kw.setdefault("max_position_embeddings", 64)
    return BertConfig(**kw)


def _ds_layer_config(cfg):
    return DeepSpeedTransformerConfig(
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        heads=cfg.num_attention_heads,
        attn_dropout_ratio=cfg.attention_probs_dropout_prob,
        hidden_dropout_ratio=cfg.hidden_dropout_prob,
        num_hidden_layers=cfg.num_hidden_layers,
        initializer_range=cfg.initializer_range,
        pre_layer_norm=cfg.pre_layer_norm,
        fp16=cfg.dtype == torch.float16)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg, device=None, tp=None):
        super().__init__()
        self.config = cfg
        self.tp = tp

        def table(n):
            return nn.Parameter(torch.empty(n, cfg.hidden_size,
                                            dtype=cfg.param_dtype,
                                            device=device))

        if tp is None:
            self.word_embeddings = table(cfg.vocab_size)
        else:           # this rank's vocab rows, the vocab padded
            self.word_embeddings = table(
                padded_len(cfg.vocab_size, tp.size) // tp.size)
            set_shard(self.word_embeddings,
                      Shard(0, 1, full=cfg.vocab_size))
        self.position_embeddings = table(cfg.max_position_embeddings)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        # flax nn.LayerNorm without a dtype: fp32 in and out
        self.LayerNorm = LayerNorm(cfg.hidden_size, SimpleNamespace(
            dtype=torch.float32, param_dtype=torch.float32), eps=1e-12,
            device=device)

    def forward(self, input_ids, token_type_ids=None, generator=None):
        cfg = self.config
        T = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = vocab_parallel_embed(self.word_embeddings, input_ids, self.tp) + \
            self.position_embeddings[:T][None] + \
            self.token_type_embeddings[token_type_ids]
        x = hidden_dropout(self.LayerNorm(x), cfg.hidden_dropout_prob,
                           generator)
        return x.to(cfg.dtype)


class BertModel(nn.Module):
    """Embeddings + encoder stack of DeepSpeedTransformerLayers."""

    def __init__(self, cfg, device=None, generator=None, tp=None):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg, device, tp)
        ds_cfg = _ds_layer_config(cfg)
        self.layer = nn.ModuleList(
            DeepSpeedTransformerLayer(
                ds_cfg, use_flash_attention=cfg.use_flash_attention,
                sparsity_config=cfg.sparse_attention, device=device,
                generator=generator, tp=tp)
            for _ in range(cfg.num_hidden_layers))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                dropout_seed=None):
        generator = None
        if dropout_seed is not None:
            generator = dropout_generator(dropout_seed, input_ids.device)
        x = self.embeddings(input_ids, token_type_ids, generator)
        additive_mask = None
        if attention_mask is not None:
            additive_mask = torch.where(
                attention_mask.bool(), 0.0, -10000.0)[:, None, None, :] \
                .float()
        for i, layer in enumerate(self.layer):
            seed = None if dropout_seed is None else \
                fold_in_seed(dropout_seed, i)
            x = layer(x, additive_mask, seed, generator)
        return x


def _init_tables_and_heads(model, cfg, generator):
    """The JAX initializers: embedding tables N(0, initializer_range),
    Dense heads lecun-normal with zero bias, LayerNorms 1 / 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BertEmbeddings):
                for t, n in ((mod.word_embeddings, cfg.vocab_size),
                             (mod.position_embeddings, None),
                             (mod.token_type_embeddings, None)):
                    if mod.tp is None or n is None:
                        nn.init.normal_(t, 0.0, cfg.initializer_range,
                                        generator=generator)
                        continue
                    # the whole table from the generator, then the shard
                    whole = torch.empty(n, t.shape[1], dtype=t.dtype,
                                        device=t.device)
                    nn.init.normal_(whole, 0.0, cfg.initializer_range,
                                    generator=generator)
                    t.copy_(shard_tensor(whole, t.tp_shard, mod.tp.rank,
                                         mod.tp.size))
            elif isinstance(mod, Dense):
                mod.reset_parameters(generator)


class BertForMaskedLM(nn.Module):
    """MLM head over the encoder (the BERT-pretraining objective).

    Params are created on ``device`` in fp32 and drawn from
    ``generator`` (a ``torch.Generator`` on the same device). ``mpu``
    with a model axis of M > 1 ranks builds this rank's shard (module
    docstring, *Tensor parallelism*)."""

    def __init__(self, cfg, device=None, generator=None, mpu=None):
        super().__init__()
        self.config = cfg
        self.mpu = mpu
        self.tp = _model_axis(mpu)
        self.bert = BertModel(cfg, device, generator, self.tp)
        self.transform = Dense(cfg.hidden_size, cfg.hidden_size, cfg, device)
        self.transform_ln = LayerNorm(cfg.hidden_size, cfg, eps=1e-12,
                                      device=device)
        self.decoder = Dense(cfg.hidden_size, cfg.vocab_size, cfg, device,
                             tp=self.tp, mode="column", pad=True)
        _init_tables_and_heads(self, cfg, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                dropout_seed=None, return_hidden=False):
        """The MLM logits ``[B, T, vocab]`` (with a model axis every
        rank's vocab columns gathered, the padding cut); with
        ``return_hidden`` the decoder's input."""
        x = self.bert(input_ids, attention_mask, token_type_ids,
                      dropout_seed)
        x = self.transform_ln(torch.nn.functional.gelu(self.transform(x)))
        if return_hidden:
            return x    # the losses apply the decoder themselves
        logits = self.decoder(x)
        if self.tp is not None:
            logits = gather_vocab(logits, self.tp, self.config.vocab_size)
        return logits

    def loss_fn(self, batch, rng=None):
        """The engine's default loss: :func:`make_bert_mlm_loss_fn` of
        this model."""
        return make_bert_mlm_loss_fn(self)(batch, rng)


def make_bert_mlm_loss_fn(model):
    """``loss_fn(batch, rng=None)``: batch has input_ids [B, T], labels
    [B, T] with -100 at unmasked positions, optional attention_mask /
    token_type_ids [B, T]; ``rng`` the int dropout seed.

    With ``config.loss_chunk > 0`` the [B, T, vocab] logits never
    materialize (chunked CE over the decoder head). With a model axis the
    loss is vocab parallel (the whole logits are never gathered)."""

    def loss_fn(batch, rng=None):
        args = (batch["input_ids"], batch.get("attention_mask"),
                batch.get("token_type_ids"))
        chunk = model.config.loss_chunk
        tp = getattr(model, "tp", None)
        labels = batch["labels"]
        if chunk:
            hidden = model(*args, dropout_seed=rng, return_hidden=True)
            total, count = vocab_parallel_chunked_cross_entropy(
                hidden, model.decoder.weight.t(), model.decoder.bias,
                labels, chunk, tp, model.config.vocab_size)
            return total / torch.clamp(count, min=1)
        if tp is not None:
            hidden = model(*args, dropout_seed=rng, return_hidden=True)
            total, count = vocab_parallel_cross_entropy(
                model.decoder(hidden), labels, tp, model.config.vocab_size)
            return total / torch.clamp(count, min=1)
        return cross_entropy_loss(model(*args, dropout_seed=rng), labels)

    return loss_fn


class BertForQuestionAnswering(nn.Module):
    """Span-prediction head over the encoder (the reference's
    BingBertSquad fine-tuning workload). Outputs (start_logits,
    end_logits), each [B, T]. ``mpu``: as :class:`BertForMaskedLM`'s."""

    def __init__(self, cfg, device=None, generator=None, mpu=None):
        super().__init__()
        self.config = cfg
        self.mpu = mpu
        self.tp = _model_axis(mpu)
        self.bert = BertModel(cfg, device, generator, self.tp)
        self.qa_outputs = Dense(cfg.hidden_size, 2, cfg, device)
        _init_tables_and_heads(self, cfg, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                dropout_seed=None):
        x = self.bert(input_ids, attention_mask, token_type_ids,
                      dropout_seed)
        start, end = self.qa_outputs(x).split(1, dim=-1)
        return start.squeeze(-1), end.squeeze(-1)

    def loss_fn(self, batch, rng=None):
        """The engine's default loss: :func:`make_bert_qa_loss_fn` of
        this model."""
        return make_bert_qa_loss_fn(self)(batch, rng)


def make_bert_qa_loss_fn(model):
    """``loss_fn(batch, rng=None)``: batch has input_ids [B, T],
    start_positions / end_positions [B] token indices, optional
    attention_mask: the mean of the start and end cross-entropies."""

    def loss_fn(batch, rng=None):
        start_logits, end_logits = model(
            batch["input_ids"], batch.get("attention_mask"),
            batch.get("token_type_ids"), dropout_seed=rng)
        return 0.5 * (cross_entropy_loss(start_logits,
                                         batch["start_positions"])
                      + cross_entropy_loss(end_logits,
                                           batch["end_positions"]))

    return loss_fn


# ---------------------------------------------------------------------------
# JAX param tree -> state_dict
# ---------------------------------------------------------------------------

_LAYER_RE = re.compile(r"^layer_(\d+)$")
_LAYER_PARAMS = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw",
                 "attn_nb", "inter_w", "inter_b", "output_w", "output_b",
                 "norm_w", "norm_b")
_TABLES = ("word_embeddings", "position_embeddings", "token_type_embeddings")
_DENSE = ("transform", "decoder", "qa_outputs")
_NORMS = ("bert/embeddings/LayerNorm", "transform_ln")


def _flatten(tree, prefix=()):
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _port_name(path):
    """(state_dict name, transpose?) of a JAX leaf path, or None."""
    *mod, leaf = path
    where = "/".join(mod)
    if len(mod) == 2 and mod[0] == "bert" and _LAYER_RE.match(mod[1]) \
            and leaf in _LAYER_PARAMS:
        return f"bert.layer.{_LAYER_RE.match(mod[1]).group(1)}.{leaf}", False
    if where == "bert/embeddings" and leaf in _TABLES:
        return f"bert.embeddings.{leaf}", False
    if where in _DENSE and leaf in ("kernel", "bias"):
        return f"{where}.{'weight' if leaf == 'kernel' else 'bias'}", \
            leaf == "kernel"
    if where in _NORMS and leaf in ("scale", "bias"):
        return (f"{where.replace('/', '.')}."
                f"{'weight' if leaf == 'scale' else 'bias'}"), False
    return None


def bert_partition_specs(state, vocab_size=None):
    """``{name: Shard or None}`` of a BERT ``state_dict`` (names only are
    read): JAX ``bert_partition_specs``'s Megatron layout (module
    docstring) with the port's q, k, v blocks of ``attn_qkvw`` and the
    ``decoder`` bias split with its kernel. ``vocab_size`` (default: the
    rows of ``word_embeddings``) is the unpadded vocab."""
    if vocab_size is None:
        vocab_size = state["bert.embeddings.word_embeddings"].shape[0]
    vocab = Shard(0, 1, full=int(vocab_size))
    specs = {}
    for name in state:
        leaf = name.rsplit(".", 1)[-1]
        if name in ("bert.embeddings.word_embeddings", "decoder.weight",
                    "decoder.bias"):
            specs[name] = vocab
        elif name.startswith("bert.layer.") and leaf in TP_SPECS:
            specs[name] = TP_SPECS[leaf]
        else:
            specs[name] = None
    return specs


def shard_bert_state_dict(state, model_rank, model_size, vocab_size=None):
    """Rank ``model_rank``'s shard of a whole BERT ``state_dict`` under
    :func:`bert_partition_specs` (the vocab leaves padded when
    ``model_size`` does not divide the vocab)."""
    if model_size == 1:
        return dict(state)
    specs = bert_partition_specs(state, vocab_size)
    return {n: shard_tensor(t, specs[n], model_rank, model_size)
            for n, t in state.items()}


def convert_bert_params(params, model_rank=0, model_size=1):
    """The JAX package's BERT param tree (``BertForMaskedLM`` or
    ``BertForQuestionAnswering``; nested mappings of numpy arrays) as a
    ``state_dict`` of fp32 CPU tensors; with ``model_size > 1`` the shard
    of model rank ``model_rank`` (:func:`shard_bert_state_dict`). Every
    leaf is used exactly once: a leaf the port has no place for raises
    ``ValueError``.

    Flax ``Dense.kernel`` ``[in, out]`` becomes ``weight`` ``[out, in]``;
    LayerNorm ``scale``/``bias`` become ``weight``/``bias``; the
    transformer layers' own matrices keep their ``[in, out]`` layout;
    ``layer_<i>`` becomes ``layer.<i>``.
    """
    sd = {}
    for path, leaf in _flatten(params).items():
        found = _port_name(path)
        if found is None:
            raise ValueError(f"convert_bert_params: no counterpart for "
                             f"{'/'.join(path)}")
        name, transpose = found
        x = torch.from_numpy(np.array(leaf, dtype=np.float32))
        sd[name] = x.t().contiguous() if transpose else x
    return shard_bert_state_dict(sd, model_rank, model_size)
