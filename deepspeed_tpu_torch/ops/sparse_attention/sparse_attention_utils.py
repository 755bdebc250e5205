"""SparseAttentionUtils: adopt sparse attention in an existing model (port
of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``).

The JAX package's models are immutable (config plus a params pytree), so
its helpers return new objects. Here a model is an ``nn.Module`` that
holds its weights:

- :meth:`SparseAttentionUtils.extend_position_embedding` takes a
  ``state_dict``-like mapping (returns a new one) or an ``nn.Module``
  (its position tables are replaced in place);
- :meth:`SparseAttentionUtils.
  replace_model_self_attention_with_sparse_self_attention` builds the
  same model class with sparse attention and ``max_position`` positions
  and loads the model's weights into it, the position tables extended
  (with ``params``, a ``state_dict``, it also returns that one
  extended);
- padding works on tensors with ``torch.nn.functional.pad``.

Argument names and error texts are the JAX package's.
"""

import dataclasses
from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig,
)
from deepspeed_tpu_torch.utils.logging import logger

POSITION_EMBEDDING_NAMES = ("position_embeddings", "wpe")


def _is_position_table(name, leaf):
    return leaf.ndim == 2 and any(
        n in POSITION_EMBEDDING_NAMES for n in name.split("."))


def _tiled(leaf, max_position):
    orig = leaf.shape[0]
    if max_position < orig:
        raise ValueError(f"max_position {max_position} < current {orig}")
    reps = -(-max_position // orig)  # ceil
    return leaf.repeat(reps, 1)[:max_position].contiguous()


class SparseAttentionUtils:
    """Utilities for integrating sparse attention into transformer models
    (the reference's class, ``sparse_attention_utils.py:14-17``)."""

    @staticmethod
    def extend_position_embedding(params, max_position):
        """Extend every position-embedding table (a 2-D leaf one of whose
        dotted name components is ``position_embeddings`` or ``wpe``) to
        ``max_position`` rows by replicating the learned rows, the
        reference's duplication scheme. ``params``: a mapping of names to
        tensors (a new mapping is returned) or an ``nn.Module`` (its
        tables are replaced in place and the module returned)."""
        extended = []
        if isinstance(params, nn.Module):
            for mod_name, mod in params.named_modules():
                for pname, p in list(mod._parameters.items()):
                    name = f"{mod_name}.{pname}" if mod_name else pname
                    if p is not None and _is_position_table(name, p):
                        orig = p.shape[0]
                        with torch.no_grad():
                            new = _tiled(p.detach(), max_position)
                        mod._parameters[pname] = nn.Parameter(
                            new, requires_grad=p.requires_grad)
                        extended.append((name, orig, max_position))
            new_params = params
        elif isinstance(params, Mapping):
            new_params = {}
            for name, leaf in params.items():
                if torch.is_tensor(leaf) and _is_position_table(name, leaf):
                    new_params[name] = _tiled(leaf, max_position)
                    extended.append((name, leaf.shape[0], max_position))
                else:
                    new_params[name] = leaf
        else:
            raise TypeError(f"extend_position_embedding takes a state_dict "
                            f"or an nn.Module, got {type(params).__name__}")
        if not extended:
            raise ValueError(
                "no position-embedding leaves found; supported names: "
                f"{POSITION_EMBEDDING_NAMES}")
        for name, orig, new in extended:
            logger.info(f"extended {name}: {orig} -> {new} positions")
        return new_params

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Bump a (HF-style) tokenizer's max length to ``max_position``
        (reference ``sparse_attention_utils.py:68-83``)."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position, sparsity_config=None, params=None):
        """A model of ``model``'s class with sparse self-attention and
        ``max_position`` positions, holding ``model``'s weights (the
        position tables extended by :meth:`extend_position_embedding`;
        the attention weights' shapes do not change). With ``params`` (a
        ``state_dict`` of the model) returns ``(model, params)`` with
        ``params`` extended too. Supported: the port's ``BertModel`` and
        ``BertForMaskedLM``."""
        from deepspeed_tpu_torch.models.bert import BertForMaskedLM, BertModel

        if isinstance(model, (BertModel, BertForMaskedLM)):
            if max_position < model.config.max_position_embeddings:
                raise ValueError(
                    f"max_position {max_position} is smaller than the "
                    f"model's current "
                    f"{model.config.max_position_embeddings}; position "
                    "tables are never shrunk")
            if sparsity_config is None:
                from deepspeed_tpu_torch.ops.sparse_attention.\
                    sparsity_config import FixedSparsityConfig
                sparsity_config = FixedSparsityConfig(
                    num_heads=model.config.num_attention_heads)
            assert isinstance(sparsity_config, SparsityConfig)
            grow = max_position > model.config.max_position_embeddings
            new_cfg = dataclasses.replace(
                model.config, sparse_attention=sparsity_config,
                max_position_embeddings=max_position)
            device = next(model.parameters()).device
            new_model = type(model)(new_cfg, device="meta")
            state = {k: v.detach() for k, v in model.state_dict().items()}
            if grow:
                state = SparseAttentionUtils.extend_position_embedding(
                    state, max_position)
            new_model.load_state_dict(
                {k: v.clone().to(device) for k, v in state.items()},
                assign=True)
            if params is not None:
                if grow:
                    params = SparseAttentionUtils.extend_position_embedding(
                        params, max_position)
                return new_model, params
            return new_model
        raise ValueError(
            f"{type(model).__name__} is not supported: only the in-package "
            "BERT family can be sparsified (the reference supports HF "
            "BERT/RoBERTa the same way)")

    @staticmethod
    def replace_self_attention_layer_with_sparse_self_attention_layer(
            hidden_size, num_attention_heads, sparsity_config,
            dtype=torch.float32):
        """A :class:`BertSparseSelfAttention` layer with the given
        geometry (reference ``sparse_attention_utils.py:123-149``)."""
        from deepspeed_tpu_torch.ops.sparse_attention.\
            bert_sparse_self_attention import BertSparseSelfAttention

        return BertSparseSelfAttention(
            hidden_size=hidden_size,
            num_attention_heads=num_attention_heads,
            sparsity_config=sparsity_config,
            dtype=dtype)

    @staticmethod
    def pad_to_block_size(block_size, input_ids, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0):
        """Pad the sequence dim up to a multiple of ``block_size``
        (reference ``sparse_attention_utils.py:151-208``). Returns
        ``(pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds)`` with None passed through. Padded
        key positions get ``attention_mask`` 0, so they are masked out."""
        seq_len = (input_ids if input_ids is not None
                   else inputs_embeds).shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return (0, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad2(x, value):
            if x is None:
                return None
            return F.pad(x, (0, pad_len), value=value)

        input_ids = pad2(input_ids, pad_token_id)
        attention_mask = pad2(attention_mask, 0)
        token_type_ids = pad2(token_type_ids, 0)
        position_ids = pad2(position_ids, 0)
        if inputs_embeds is not None:
            inputs_embeds = F.pad(inputs_embeds, (0, 0, 0, pad_len))
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Strip the padding added by :meth:`pad_to_block_size`
        (reference ``sparse_attention_utils.py:210-224``)."""
        if pad_len:
            sequence_output = sequence_output[:, :-pad_len]
        return sequence_output
