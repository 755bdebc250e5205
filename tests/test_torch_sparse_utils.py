"""The sparse-attention host helpers held to the JAX package's: the
cases of ``tests/unit/test_sparse_attention_utils.py`` run through both
``SparseAttentionUtils`` (padding, position-embedding extension, the
tokenizer bump, the sparse layer and model surgery, with BERT params
carried by ``convert_bert_params``); the C++ LUT builder against the
numpy builder and JAX's ``_build_lut_numpy`` on random layouts; the C++
flatten / unflatten round trip; and the ``op_builder`` names."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.sparse_attention import (
    DenseSparsityConfig as JaxDense,
    SparseAttentionUtils as JaxUtils,
)
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.op_builder.utils import flatten, unflatten
from deepspeed_tpu_torch.ops.sparse_attention import (
    BertSparseSelfAttention,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparseAttentionUtils,
)

# the modules (the packages export a function of the same name)
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")


def _bert(max_pos=64):
    jm = jbert.BertForMaskedLM(jbert.bert_tiny(
        dtype=jnp.float32, max_position_embeddings=max_pos))
    params = jbert.init_bert_params(jm, jax.random.PRNGKey(0), seq_len=64)
    tm = tbert.BertForMaskedLM(tbert.bert_tiny(
        dtype=torch.float32, max_position_embeddings=max_pos), device="cpu")
    tm.load_state_dict(tbert.convert_bert_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def test_pad_unpad_equal_jax():
    ids = np.arange(2 * 10, dtype=np.int32).reshape(2, 10)
    mask = np.ones((2, 10), np.int32)
    emb = np.arange(2 * 10 * 3, dtype=np.float32).reshape(2, 10, 3)
    got = SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
        inputs_embeds=torch.from_numpy(emb), pad_token_id=9)
    want = JaxUtils.pad_to_block_size(
        16, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        inputs_embeds=jnp.asarray(emb), pad_token_id=9)
    assert got[0] == want[0] == 6
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = torch.ones(2, 16, 4)
    assert SparseAttentionUtils.unpad_sequence_output(6, out).shape == \
        JaxUtils.unpad_sequence_output(6, jnp.ones((2, 16, 4))).shape
    t = torch.from_numpy(ids)
    pad_len, same, *_ = SparseAttentionUtils.pad_to_block_size(5, t)
    assert pad_len == 0 and same is t


def test_extend_position_embedding_equals_jax():
    _, params, tm = _bert()
    want = tbert.convert_bert_params(jax.tree_util.tree_map(
        np.asarray, JaxUtils.extend_position_embedding(params, 160)))
    got = SparseAttentionUtils.extend_position_embedding(
        tm.state_dict(), 160)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    name = "bert.embeddings.position_embeddings"
    assert got[name].shape[0] == 160
    # on the module itself, in place
    SparseAttentionUtils.extend_position_embedding(tm, 160)
    assert torch.equal(tm.state_dict()[name], want[name])
    for bad in ({"x": got[name]}, {"wpe_extra": got[name]}):
        with pytest.raises(ValueError, match="no position-embedding"):
            SparseAttentionUtils.extend_position_embedding(bad, 160)
    with pytest.raises(ValueError, match="max_position 8 < current"):
        SparseAttentionUtils.extend_position_embedding(tm.state_dict(), 8)


def test_update_tokenizer_max_length():
    class Tok:
        model_max_length = 512
        init_kwargs = {}

    tok = SparseAttentionUtils.update_tokenizer_model_max_length(Tok(), 4096)
    assert tok.model_max_length == 4096
    assert tok.init_kwargs["model_max_length"] == 4096


def test_sparse_layer_dense_layout_equals_jax():
    """The layer the helper builds equals the JAX one's output on the same
    weights (dense layout: also plain softmax attention)."""
    H, heads, B, T = 32, 2, 2, 64
    layer = SparseAttentionUtils.\
        replace_self_attention_layer_with_sparse_self_attention_layer(
            H, heads, DenseSparsityConfig(num_heads=heads, block=16))
    assert isinstance(layer, BertSparseSelfAttention)
    jlayer = JaxUtils.\
        replace_self_attention_layer_with_sparse_self_attention_layer(
            H, heads, JaxDense(num_heads=heads, block=16))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (B, T, H)))
    params = jlayer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    with torch.no_grad():
        for name in ("query", "key", "value"):
            p = params["params"][name]
            getattr(layer, name).weight.copy_(
                torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
            getattr(layer, name).bias.copy_(
                torch.from_numpy(np.asarray(p["bias"])))
        got = layer(torch.from_numpy(x)).numpy()
    want = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_model_surgery_equals_jax():
    """The sparse model holds the original weights (position table
    extended); with a dense layout it equals the original model and the
    JAX sparse model at the original positions."""
    jm, params, tm = _bert()
    sparse = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            tm, 128, DenseSparsityConfig(num_heads=4, block=16))
    jsparse, jparams = JaxUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            jm, 128, JaxDense(num_heads=4, block=16), params=params)
    assert sparse.config.sparse_attention is not None
    assert sparse.config.max_position_embeddings == 128
    ids = np.ones((2, 64), np.int32)
    with torch.no_grad():
        got = sparse(torch.from_numpy(ids).long()).numpy()
        orig = tm(torch.from_numpy(ids).long()).numpy()
    want = np.asarray(jsparse.apply({"params": jparams}, jnp.asarray(ids)))
    np.testing.assert_allclose(got, orig, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    for name, t in tbert.convert_bert_params(jax.tree_util.tree_map(
            np.asarray, jparams)).items():
        assert torch.equal(sparse.state_dict()[name], t), name
    model, sd = SparseAttentionUtils.\
        replace_model_self_attention_with_sparse_self_attention(
            tm, 64, FixedSparsityConfig(num_heads=4, block=16),
            params=tm.state_dict())
    assert sd.keys() == tm.state_dict().keys()
    with pytest.raises(ValueError, match="never shrunk"):
        SparseAttentionUtils.\
            replace_model_self_attention_with_sparse_self_attention(tm, 32)
    with pytest.raises(ValueError, match="is not supported"):
        SparseAttentionUtils.\
            replace_model_self_attention_with_sparse_self_attention(
                object(), 64)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 4), st.integers(1, 9), st.integers(1, 9),
       st.floats(0.0, 1.0), st.integers(0, 2 ** 31 - 1))
def test_cpp_lut_equals_numpy_and_jax(H, nq, nk, density, seed):
    rng = np.random.default_rng(seed)
    layout = (rng.random((H, nq, nk)) < density).astype(np.int64)
    got = tbsa.build_lut(layout)
    for want in (tbsa.build_lut_numpy(layout),
                 jbsa._build_lut_numpy(layout)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.lists(st.integers(0, 7), min_size=0, max_size=3),
                min_size=0, max_size=6), st.integers(0, 2 ** 31 - 1))
def test_flatten_unflatten_round_trip(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    tensors = [torch.randn(*s, generator=gen) if s else
               torch.randn((), generator=gen) for s in shapes]
    flat = flatten(tensors)
    want = torch.cat([t.reshape(-1) for t in tensors]) if tensors else \
        torch.zeros(0)
    assert torch.equal(flat, want)
    back = unflatten(flat, tensors)
    assert all(torch.equal(a, b) and a.shape == b.shape
               for a, b in zip(back, tensors))


def test_op_builder_names_and_errors():
    assert sorted(op_builder.ALL_OPS) == ["cpu_adam", "sparse_attn",
                                          "utils"]
    for cls in op_builder.ALL_OPS.values():
        assert cls().is_compatible()
    lib = op_builder.SparseAttnBuilder().load()
    assert lib is op_builder.SparseAttnBuilder().load()
    with pytest.raises(ValueError, match="fp32 CPU"):
        flatten([torch.zeros(3, dtype=torch.float16)])
    with pytest.raises(ValueError, match="holds 3 elements"):
        unflatten(torch.zeros(3), [torch.zeros(4)])
