"""Head dims past 128: the port's flash attention (K1-K3) and block-sparse
attention (K7, K8a, K8b) take any head dim up to 256, as the JAX
package (which has no cap) computes them.

On the CPU the JAX Pallas kernels run in interpret mode and the port's
wrappers run their plain versions, which the CUDA kernels are held to
on the card (``chip_smoke.py``; the ``cuda``-marked tests in
``tests/test_torch_cuda_kernels.py``). Also pinned here: bf16 past head
dim 128 takes the FMA kernels (the tensor-core kernels hold up to 128),
and both kernel launchers refuse a head dim past 256 with the limit in
the message. Inputs come from ``numpy.random.default_rng``.

Tolerance: atol 1e-5 on f32 outputs and gradients of magnitude ~1, as
in the narrower tests: both sides accumulate in fp32, in different
orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
jsa = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")

B, T, H = 1, 64, 2
ATOL = 1e-5
SEED, OFFSET, NUM_HEADS = -987654321, 1, 3


def _inputs(seed, d, t=T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("d,causal,bias,rate", [(160, True, True, 0.1),
                                                (256, False, False, 0.0),
                                                (256, True, True, 0.1)])
def test_flash_attention_matches_pallas_interpret_past_128(d, causal, bias,
                                                           rate):
    q, k, v, g = _inputs(d + causal, d)
    kb = None
    if bias:
        kb = np.random.default_rng(d).standard_normal((B, T)) \
            .astype(np.float32)
        kb[:, 5::9] = jfa.MASK_BIAS
    drop = {} if not rate else dict(
        dropout_rate=rate, dropout_seed=SEED, dropout_head_offset=OFFSET,
        dropout_num_heads=NUM_HEADS)
    args = [jnp.asarray(x) for x in (q, k, v)]

    def f(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, key_bias=None if kb is None else jnp.asarray(kb),
            causal=causal, block_q=32, block_k=32, implementation="pallas",
            **drop)

    want_out, vjp = jax.vjp(f, *args)
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(
        *ts, causal=causal,
        key_bias=None if kb is None else torch.from_numpy(kb), **drop)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("block,causal,rate", [(16, False, 0.0),
                                               (16, True, 0.2),
                                               (32, False, 0.2)])
def test_block_sparse_matches_pallas_interpret_at_256(block, causal, rate):
    d, t = 256, 4 * block
    q, k, v, g = _inputs(block + causal, d, t)
    layout = jsa.FixedSparsityConfig(
        H, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    layout[1, 1, :] = 0                        # an empty q-block row
    lut, nnz = jbsa.build_lut(layout)
    lut_t, nnz_t = jbsa.build_lut(layout.transpose(0, 2, 1))
    scale = d ** -0.5
    seed = jnp.int32(SEED) if rate else None
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = jbsa._pallas_impl(jq, jk, jv, lut, nnz, block, causal,
                                     scale, interpret=True,
                                     dropout_rate=rate, dropout_seed=seed)
    j_grads = jbsa._pallas_bwd_impl(jq, jk, jv, j_out, j_lse, jg, lut, nnz,
                                    lut_t, nnz_t, block, causal, scale,
                                    interpret=True, dropout_rate=rate,
                                    dropout_seed=seed)
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tbsa.block_sparse_attention(
        *ts, layout, block, causal=causal, dropout_rate=rate,
        dropout_seed=SEED if rate else None)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), grads, j_grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("d,route", [(128, "tensor_core"), (136, "fma"),
                                     (160, "fma"), (256, "fma")])
def test_bf16_past_128_takes_the_fma_route(d, route):
    """The wgmma kernels hold a head of at most 128: an aligned bf16 call
    past it runs the FMA kernels, forward and backward."""
    shape = (2, 64, 4, d)
    q, k, v, g = (torch.zeros(shape, dtype=torch.bfloat16) for _ in "qkvg")
    stats = torch.zeros(2 * 4, 64)
    assert tfa.attention_route(q, k, v) == route
    assert tfa.attention_route(q, k, v, g, stats, stats) == route
    assert tfa.attention_route(q.float(), k.float(), v.float()) == "fma"


def test_launchers_refuse_past_256_naming_the_limit():
    """Both wrappers' kernel launchers check the head dim before they
    touch the kernel library, so CPU tensors show the check."""
    assert tfa.MAX_HEAD_DIM == tbsa.MAX_HEAD_DIM == 256
    q = torch.zeros((1, 32, 2, 264))
    stats = torch.zeros(2, 32)
    kw = dict(key_bias=None, dropout_num_heads=None, dropout_rate=0.0,
              dropout_seed=0, dropout_head_offset=0, causal=True,
              sm_scale=1.0)
    with pytest.raises(ValueError, match=r"head_dim <= 256, got 264"):
        tfa._launch(tfa.flash_attention_fwd, 0, q, q, q, None, None, None,
                    kw, out=q, lse_out=stats)
    lut = torch.zeros(2, 2, 1, dtype=torch.int32)
    nnz = torch.ones(2, 2, dtype=torch.int32)
    skw = dict(causal=False, sm_scale=1.0, dropout_rate=0.0, dropout_seed=0)
    with pytest.raises(ValueError, match=r"head_dim <= 256, got 264"):
        tbsa._launch(1, q, q, q, q, stats, stats, lut, nnz, 16, skw, dq=q)
