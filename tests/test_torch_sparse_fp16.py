"""fp16 block-sparse attention: the port's K7 / K8a / K8b wrappers and an
fp16 BERT with sparse attention against the JAX package.

A JAX BERT built with ``dtype=float16`` runs its transformer layers in
fp16, so q, k and v reach the block-sparse kernels in fp16; the Pallas
kernels widen them to f32, compute, and round the outputs once to fp16
(``block_sparse_attention.py:263, 401, 471``). On the CPU the JAX
kernels run in interpret mode and the port's wrappers run their plain
versions (what the CUDA kernels are held to on the card). Inputs come
from ``numpy.random.default_rng``.

Tolerances: the kernels' fp16 outputs within one fp16 unit of JAX's
(rtol 2^-10): both compute in fp32 and round once, so only a value
whose f32 sums straddle a rounding boundary can differ, by one unit;
plus atol 1e-5 of the output's largest value for the fp32 summation
noise (the two sum in different orders), which sets the bound on the
values near 0 that cancellation leaves (dQ, dK); lse (f32) atol 1e-5.
The BERT encoder output and MLM logits within two fp16 units of their
largest value: both models round to fp16 after every layer op
(matmuls, layer norms, GELU) and the CPU backends round their fp16
matmuls at other points, so single unit flips carry through the layers
(measured: one unit at the top).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.sparse_attention import (
    FixedSparsityConfig as JaxFixed)
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig

jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
jsa = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")

B, H, D = 2, 2, 64
FP16_RTOL, SUM_ATOL_REL = 2.0 ** -10, 1e-5
LSE_ATOL = 1e-5
SEED = -987654321


def _fp16_close(got, want, name):
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=FP16_RTOL,
                               atol=SUM_ATOL_REL * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("block,causal,rate", [(16, False, 0.0),
                                               (16, True, 0.1),
                                               (32, False, 0.1),
                                               (32, True, 0.0)])
def test_fp16_kernels_match_pallas_interpret(block, causal, rate):
    """K7 (out, lse), K8a (dq), K8b (dk, dv) on fp16 inputs, blocks 16
    and 32, an empty q-block row."""
    t = 4 * block
    rng = np.random.default_rng(block + causal)
    q, k, v, g = (rng.standard_normal((B, t, H, D)).astype(np.float16)
                  for _ in range(4))
    layout = jsa.FixedSparsityConfig(
        H, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    layout[1, 2, :] = 0                        # an empty q-block row
    lut, nnz = jbsa.build_lut(layout)
    lut_t, nnz_t = jbsa.build_lut(layout.transpose(0, 2, 1))
    scale = D ** -0.5
    seed = jnp.int32(SEED) if rate else None
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = jbsa._pallas_impl(jq, jk, jv, lut, nnz, block, causal,
                                     scale, interpret=True,
                                     dropout_rate=rate, dropout_seed=seed)
    j_grads = jbsa._pallas_bwd_impl(jq, jk, jv, j_out, j_lse, jg, lut, nnz,
                                    lut_t, nnz_t, block, causal, scale,
                                    interpret=True, dropout_rate=rate,
                                    dropout_seed=seed)
    tq, tk, tv, tg = (torch.from_numpy(x.copy()) for x in (q, k, v, g))
    tl, tn, tlt, tnt = tbsa.layout_tables(layout, "cpu")
    kw = dict(causal=causal, sm_scale=scale, dropout_rate=rate,
              dropout_seed=SEED if rate else 0)
    out, lse = tbsa.block_sparse_attention_fwd(tq, tk, tv, tl, tn, block,
                                               **kw)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _fp16_close(out, j_out, "out")
    j_lse = np.asarray(j_lse).reshape(B * H, t)
    finite = np.isfinite(j_lse)
    # the empty row: lse -inf here, -inf + log(1e-30) there (never read)
    assert not finite.all() and not torch.isfinite(lse).numpy()[~finite] \
        .any()
    np.testing.assert_allclose(lse.numpy()[finite], j_lse[finite],
                               atol=LSE_ATOL, rtol=0)
    # the backward from JAX's own forward output and statistics, as its
    # bwd reads them (delta = rowsum(dO * O) in f32, :356)
    j_o = torch.from_numpy(np.asarray(j_out).astype(np.float32))
    delta = (tg.float() * j_o).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, t).contiguous()
    lse_in = torch.from_numpy(np.where(finite, j_lse, -np.inf)
                              .astype(np.float32))
    dq = tbsa.block_sparse_attention_bwd_dq(tq, tk, tv, tg, lse_in, delta,
                                            tl, tn, block, **kw)
    dk, dv = tbsa.block_sparse_attention_bwd_dkv(tq, tk, tv, tg, lse_in,
                                                 delta, tlt, tnt, block,
                                                 **kw)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), j_grads):
        assert got.dtype == torch.float16
        _fp16_close(got, want, name)


def test_fp16_sparse_bert_matches_jax(monkeypatch):
    """An fp16 BERT-tiny with Fixed block-sparse attention: its encoder
    runs in fp16 on both sides, the port's sparse core on the kernel
    route with fp16 q, k and v."""
    t = 64
    sp = dict(block=16, num_local_blocks=2)
    jcfg = jbert.bert_tiny(dtype=jnp.float16,
                           sparse_attention=JaxFixed(4, **sp))
    tcfg = tbert.bert_tiny(dtype=torch.float16,
                           sparse_attention=FixedSparsityConfig(4, **sp))
    jm = jbert.BertForMaskedLM(jcfg)
    params = jbert.init_bert_params(jm, jax.random.PRNGKey(0), seq_len=t)
    tm = tbert.BertForMaskedLM(tcfg, device="cpu")
    tm.load_state_dict(tbert.convert_bert_params(
        jax.tree_util.tree_map(np.asarray, params)))
    seen = []
    fwd = tbsa.block_sparse_attention_fwd

    def spy(q, *args, **kw):
        seen.append(q.dtype)
        return fwd(q, *args, **kw)

    monkeypatch.setattr(tbsa, "block_sparse_attention_fwd", spy)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, t)).astype(np.int32)
    tt = (np.arange(t) >= t // 2).astype(np.int32)[None].repeat(2, 0)
    want = jbert.BertModel(jcfg).apply({"params": params["bert"]},
                                       jnp.asarray(ids), None,
                                       jnp.asarray(tt))
    tids, ttt = torch.from_numpy(ids).long(), torch.from_numpy(tt).long()
    got = tm.bert(tids, None, ttt)
    assert want.dtype == jnp.float16 and got.dtype == torch.float16
    assert seen and set(seen) == {torch.float16}
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=2 * FP16_RTOL * np.abs(want).max(),
                               rtol=0)
    j_logits = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                                   None, jnp.asarray(tt))).astype(np.float32)
    logits = tm(tids, None, ttt)
    assert logits.dtype == torch.float16
    np.testing.assert_allclose(logits.detach().float().numpy(), j_logits,
                               atol=2 * FP16_RTOL * np.abs(j_logits).max(),
                               rtol=0)
