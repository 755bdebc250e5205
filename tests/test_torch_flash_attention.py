"""Flash attention for training: the port
(`deepspeed_tpu_torch/ops/flash_attention.py`) against the JAX package
(`deepspeed_tpu/ops/pallas/flash_attention.py`).

On the CPU the JAX Pallas kernels run in interpret mode
(``implementation="pallas"``, block_q = block_k = 32, as the JAX tests
run them) and the port's wrappers run their plain PyTorch versions,
which the CUDA kernels are held to on the card. Inputs come from
``numpy.random.default_rng``.

Tolerances: atol 1e-5 on f32 outputs, lse and gradients of magnitude
~1 — both sides accumulate in fp32, in different orders and block
sizes. The dropout mask is compared bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa
from tests.torch_threads import one_thread  # noqa: F401

# the module (the package re-exports its function under the same name)
jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

B, T, H, D = 2, 64, 2, 16
ATOL = 1e-5
SEED, OFFSET, NUM_HEADS = -987654321, 3, 5


def _inputs(seed, t=T, bias=False):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, t, H, D)).astype(np.float32)
                  for _ in range(4))
    kb = None
    if bias:
        kb = rng.standard_normal((B, t)).astype(np.float32)
        kb[:, 5::9] = jfa.MASK_BIAS
    return q, k, v, g, kb


def _drop_kw(rate):
    if not rate:
        return {}
    return dict(dropout_rate=rate, dropout_seed=SEED,
                dropout_head_offset=OFFSET, dropout_num_heads=NUM_HEADS)


def _jax_run(q, k, v, g, kb, causal, rate, impl):
    """JAX out and grads (dq, dk, dv[, dbias])."""
    kw = dict(causal=causal, block_q=32, block_k=32, implementation=impl,
              **_drop_kw(rate))
    args = [jnp.asarray(x) for x in (q, k, v)]
    if kb is not None:
        args.append(jnp.asarray(kb))

    def f(*a):
        bias = a[3] if len(a) > 3 else None
        return jfa.flash_attention(*a[:3], key_bias=bias, **kw)

    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port_run(q, k, v, g, kb, causal, rate):
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    bias = None
    if kb is not None:
        bias = torch.from_numpy(kb.copy()).requires_grad_()
    out = tfa.flash_attention(*ts, causal=causal, key_bias=bias,
                              **_drop_kw(rate))
    wrt = ts + ([bias] if bias is not None else [])
    grads = torch.autograd.grad(out, wrt, torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_pallas_kernels_in_interpret_mode(causal, bias, rate):
    q, k, v, g, kb = _inputs(0, bias=bias)
    want_out, want_grads = _jax_run(q, k, v, g, kb, causal, rate, "pallas")
    got_out, got_grads = _port_run(q, k, v, g, kb, causal, rate)
    np.testing.assert_allclose(got_out, want_out, atol=ATOL, rtol=0)
    assert len(got_grads) == len(want_grads) == 3 + bias
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), got_grads,
                               want_grads):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_pallas_forward(causal):
    q, k, v, _, kb = _inputs(1, bias=True)
    _, want = jfa._pallas_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, D ** -0.5,
        32, 32, interpret=True, key_bias=jnp.asarray(kb),
        dropout_rate=0.1, dropout_seed=jnp.int32(SEED),
        dropout_head_offset=jnp.int32(OFFSET), dropout_num_heads=NUM_HEADS)
    _, got = tfa.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        key_bias=torch.from_numpy(kb), causal=causal, **_drop_kw(0.1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_blockwise_xla(causal, rate):
    """T = 50 does not tile by 32: the JAX ``pallas`` route falls back to
    blockwise, so hold the port to ``implementation="xla"``."""
    q, k, v, g, kb = _inputs(2, t=50, bias=True)
    want_out, want_grads = _jax_run(q, k, v, g, kb, causal, rate, "xla")
    got_out, got_grads = _port_run(q, k, v, g, kb, causal, rate)
    np.testing.assert_allclose(got_out, want_out, atol=ATOL, rtol=0)
    for got, want in zip(got_grads, want_grads):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, -1, -2 ** 31, 2 ** 31 - 1, 123456789,
                                  -987654321])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_is_bit_identical(seed, rate):
    b, h, t, s = 2, 3, 40, 56
    want = jfa._dropout_multiplier_full(b, h, t, s, rate, jnp.int32(seed),
                                        head_offset=OFFSET,
                                        num_heads=NUM_HEADS)
    got = tfa._dropout_multiplier_full(b, h, t, s, rate, seed,
                                       head_offset=OFFSET,
                                       num_heads=NUM_HEADS)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, -5, 2 ** 31 - 1, -2 ** 31])
def test_fold_in_seed_matches(seed):
    for data in (0, 1, 7, 23, 1 << 20):
        want = int(jfa.fold_in_seed(jnp.int32(seed), jnp.int32(data)))
        assert tfa.fold_in_seed(seed, data) == want


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dense_and_blockwise_plain_versions_match_jax(rate):
    q, k, v, _, kb = _inputs(3, bias=True)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kw = _drop_kw(rate)
    want = jfa.dense_attention(jq, jk, jv, key_bias=jnp.asarray(kb), **kw)
    got = tfa.dense_attention(tq, tk, tv, key_bias=torch.from_numpy(kb),
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want = jfa._blockwise_attention(jq, jk, jv, True, D ** -0.5, block_k=16,
                                    key_bias=jnp.asarray(kb), **kw)
    got = tfa._blockwise_attention(tq, tk, tv, True, D ** -0.5, block_k=16,
                                   key_bias=torch.from_numpy(kb), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_key_padding_mask_is_a_hard_mask_without_a_gradient():
    q, k, v, _, _ = _inputs(4)
    mask = np.ones((B, T), bool)
    mask[:, 40:] = False
    want = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               causal=False, implementation="xla",
                               key_padding_mask=jnp.asarray(mask))
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=False,
                              key_padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_argument_errors_match_jax():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not in"):
        tfa.flash_attention(q, q, q, dropout_rate=1.5, dropout_seed=1)
    with pytest.raises(ValueError, match="< local heads"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1,
                            dropout_num_heads=0)


def test_wrappers_never_run_the_plain_version_off_the_cpu():
    """On a non-CPU device the wrappers launch their kernel or raise;
    the plain version is for CPU tensors only."""
    q = torch.zeros(1, 4, 1, 8, device="meta")
    lse = torch.zeros(1, 4, device="meta")
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
    assert before == (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_bwd_dq.launches,
                      tfa.flash_attention_bwd_dkv.launches)
