"""GPT-2's training side in the port (`deepspeed_tpu_torch/models/
gpt2.py`) against the JAX model (`deepspeed_tpu/models/gpt2.py`): the
cross-entropy losses, the chunked vocab head with its fp32 head
cotangent, the chunked-loss model path, and the attention-prob dropout
shared by the dense and flash routes.

Tolerances: f32 losses and gradients atol 1e-5 (sums over the 256-word
vocab and 2 x 24 tokens in different orders). bf16: the head and x
gradients atol 1e-4 on values up to ~0.13 (both sides widen the bf16
inputs exactly and accumulate in fp32, in different orders); the bias
gradient atol 2e-3 on values ~0.05, since both sides reduce it at the
bf16 logit dtype, a few bf16 units apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu_torch.models import gpt2 as tg

ATOL = 1e-5


def _logits_labels(seed, t=24, vocab=256):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, t, vocab)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, t)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    return logits, labels


def test_cross_entropy_matches_jax():
    logits, labels = _logits_labels(0)
    want_sum, want_n = jg.cross_entropy_sum_and_count(
        jnp.asarray(logits), jnp.asarray(labels))
    got_sum, got_n = tg.cross_entropy_sum_and_count(
        torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(got_n) == int(want_n) == 2 * 24 - 8
    np.testing.assert_allclose(float(got_sum), float(want_sum), rtol=1e-6)
    np.testing.assert_allclose(
        float(tg.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels))),
        float(jg.cross_entropy_loss(jnp.asarray(logits),
                                    jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 7, 64])
def test_chunked_head_loss_and_grads_match_jax(dtype, chunk):
    """Loss and the gradients of x, head and bias through the chunked
    head (7 does not divide T = 24; 64 is one chunk)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    head = (0.1 * rng.standard_normal((16, 256))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256)).astype(np.float32)
    _, labels = _logits_labels(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_loss(x, head, bias):
        total, count = jg.chunked_cross_entropy_with_head(
            x.astype(jdt), head, bias, jnp.asarray(labels), chunk)
        return total / count

    want, want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(head), jnp.asarray(bias))
    tx, th, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, head, bias))
    total, count = tg.chunked_cross_entropy_with_head(
        tx.to(tdt), th, tb, torch.from_numpy(labels), chunk)
    got = total / count
    got_g = torch.autograd.grad(got, (tx, th, tb))
    atol = {"x": ATOL, "head": ATOL, "bias": ATOL} if dtype == "float32" \
        else {"x": 1e-4, "head": 1e-4, "bias": 2e-3}
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    for name, g, w in zip(("x", "head", "bias"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=atol[name], err_msg=name)


@pytest.fixture(scope="module")
def jax_params():
    model = jg.GPT2LMHead(jg.gpt2_tiny(dtype=jnp.float32))
    return jax.jit(model.init)(jax.random.PRNGKey(3),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _port_model(params, **cfg):
    model = tg.GPT2LMHead(tg.gpt2_tiny(dtype=torch.float32, **cfg),
                          device="cpu")
    model.load_state_dict(tg.convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.mark.parametrize("flash", [False, True])
def test_chunked_loss_model_path_matches_jax(jax_params, flash):
    """``loss_chunk`` routes the model through ``return_hidden`` and the
    chunked tied head; the loss and every parameter's gradient match."""
    ids = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(np.int32)
    jmodel = jg.GPT2LMHead(jg.gpt2_tiny(dtype=jnp.float32, loss_chunk=8,
                                        use_flash_attention=flash))
    want, want_g = jax.jit(jax.value_and_grad(jg.make_gpt2_loss_fn(jmodel)))(
        jax_params, {"input_ids": jnp.asarray(ids)}, None)
    model = _port_model(jax_params, loss_chunk=8, use_flash_attention=flash)
    got = tg.make_gpt2_loss_fn(model)({"input_ids": torch.from_numpy(ids)})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    want_g = tg.convert_gpt2_params(jax.tree_util.tree_map(np.asarray,
                                                           want_g))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-6, err_msg=name)


def test_dense_and_flash_routes_draw_the_same_attention_dropout(jax_params):
    """With dropout on, the dense route applies the same counter-hash
    mask as the flash kernels (and the same hidden-dropout generator),
    so both routes give the same loss for one seed; a different seed
    gives a different loss, and no seed gives the deterministic one."""
    ids = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (2, 24)).astype(np.int64))
    losses = {}
    for flash in (False, True):
        model = _port_model(jax_params, dropout=0.2,
                            use_flash_attention=flash)
        fn = tg.make_gpt2_loss_fn(model)
        losses[flash] = [float(fn({"input_ids": ids}, rng))
                         for rng in (11, 12, None)]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    assert losses[True][0] != losses[True][1] != losses[True][2]


def test_unported_training_features_raise(jax_params):
    model = _port_model(jax_params)
    fn = tg.make_gpt2_loss_fn(model)
    with pytest.raises(NotImplementedError, match="progressive layer drop"):
        fn({"input_ids": torch.zeros(1, 4, dtype=torch.int64)}, 0,
           pld_theta=0.5)
    with pytest.raises(NotImplementedError, match="remat"):
        tg.GPT2LMHead(tg.gpt2_tiny(remat=True), device="cpu")
