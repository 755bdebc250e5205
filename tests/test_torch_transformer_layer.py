"""DeepSpeedTransformerLayer: the port
(`deepspeed_tpu_torch/ops/transformer/transformer.py`) against the JAX
layer (`deepspeed_tpu/ops/transformer/transformer.py`) on the same
params and inputs, forward and backward, for its three attention cores
(dense, flash, block-sparse) x pre/post layer norm x with/without a
BERT additive mask, in f32 at dropout 0.

On the CPU the JAX flash core runs its XLA path and the JAX sparse core
its gather route; the port's run the kernels' plain versions (the
sparse core with a mask takes the gather route on both sides).

Tolerances: outputs atol 2e-5 and gradients atol 5e-5 (magnitudes ~1
after the layer norms; fp32 sums in different orders through two
matmuls, a softmax and two layer norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import (
    FixedSparsityConfig as JaxFixed)
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JaxConfig,
    DeepSpeedTransformerLayer as JaxLayer,
    init_transformer_layer)
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)

B, T, HIDDEN, HEADS = 2, 64, 64, 4
OUT_ATOL, GRAD_ATOL = 2e-5, 5e-5
CFG = dict(batch_size=B, max_seq_length=T, hidden_size=HIDDEN,
           intermediate_size=128, heads=HEADS, attn_dropout_ratio=0.0,
           hidden_dropout_ratio=0.0, num_hidden_layers=2,
           initializer_range=0.1)


def _layers(core, pre_ln):
    sparse = dict(block=16, num_local_blocks=2)
    jax_layer = JaxLayer(
        JaxConfig(pre_layer_norm=pre_ln, **CFG),
        use_flash_attention=core == "flash",
        sparsity_config=JaxFixed(HEADS, **sparse) if core == "sparse"
        else None)
    port_layer = DeepSpeedTransformerLayer(
        DeepSpeedTransformerConfig(pre_layer_norm=pre_ln, **CFG),
        use_flash_attention=core == "flash",
        sparsity_config=FixedSparsityConfig(HEADS, **sparse)
        if core == "sparse" else None, device="cpu")
    return jax_layer, port_layer


@pytest.mark.parametrize("core", ["dense", "flash", "sparse"])
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_layer_forward_backward_match_jax(core, pre_ln, masked):
    jax_layer, port_layer = _layers(core, pre_ln)
    params = init_transformer_layer(jax_layer, jax.random.PRNGKey(1), B, T)
    port_layer.load_state_dict({n: torch.from_numpy(np.array(a))
                                for n, a in params.items()})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    g = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((B, 1, 1, T), np.float32)
        mask[1, ..., 40:] = -10000.0

    def f(p, xx):
        return jax_layer.apply({"params": p}, xx,
                               None if mask is None else jnp.asarray(mask))

    want, vjp = jax.vjp(f, params, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    got = port_layer(tx, None if mask is None else torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               atol=GRAD_ATOL, rtol=0)
    for name, p in port_layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_dp[name]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_per_query_mask_falls_back_to_the_dense_core():
    """A [B, 1, T, T] mask is not a key-padding row: the flash layer runs
    its dense core, as the JAX layer does."""
    jax_layer, port_layer = _layers("flash", False)
    params = init_transformer_layer(jax_layer, jax.random.PRNGKey(2), B, T)
    port_layer.load_state_dict({n: torch.from_numpy(np.array(a))
                                for n, a in params.items()})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, HIDDEN)).astype(np.float32)
    mask = np.where(np.tril(np.ones((T, T))), 0.0, -10000.0) \
        .astype(np.float32)[None, None].repeat(B, 0)
    want = jax_layer.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(mask))
    got = port_layer(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


def test_config_surface_matches_jax(tmp_path):
    raw = {"hidden_size": 32, "heads": 2, "fp16": True,
           "pre_layer_norm": False, "attn_dropout_ratio": 0.1}
    path = tmp_path / "layer.json"
    path.write_text(__import__("json").dumps(raw))
    for port, ref in ((DeepSpeedTransformerConfig.from_dict(raw),
                       JaxConfig.from_dict(raw)),
                      (DeepSpeedTransformerConfig.from_json_file(str(path)),
                       JaxConfig.from_json_file(str(path)))):
        assert {k: getattr(port, k) for k in vars(ref)} == vars(ref)
        assert port.dtype == torch.float16
    assert DeepSpeedTransformerConfig(hidden_size=8).intermediate_size == 32
    # the same knobs as JAX's, so no bf16 flag: fp16 or fp32 layers
    assert set(vars(DeepSpeedTransformerConfig())) == set(vars(JaxConfig()))
    assert DeepSpeedTransformerConfig().dtype == torch.float32


@pytest.mark.parametrize("knob", ["normalize_invertible", "gelu_checkpoint",
                                  "attn_dropout_checkpoint"])
def test_remat_knobs_are_not_yet_ported(knob):
    # ported: each knob checkpoints its sub-block and changes no bit
    # (tests/test_torch_activation_checkpointing.py holds the gradients)
    x = torch.randn(B, T, HIDDEN, generator=torch.Generator().manual_seed(0))
    outs = []
    for flags in ({}, {knob: True}):
        cfg = DeepSpeedTransformerConfig(**dict(CFG, **flags))
        layer = DeepSpeedTransformerLayer(
            cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        outs.append(layer(x))
    assert torch.equal(outs[0], outs[1])


def test_dropout_needs_a_seed_and_replays_with_it():
    """Dropout runs only with a dropout_seed; one seed replays the same
    output, another differs."""
    cfg = DeepSpeedTransformerConfig(**dict(CFG, attn_dropout_ratio=0.1,
                                            hidden_dropout_ratio=0.1))
    layer = DeepSpeedTransformerLayer(
        cfg, sparsity_config=FixedSparsityConfig(HEADS, block=16),
        device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, T, HIDDEN)).astype(np.float32))
    plain = DeepSpeedTransformerLayer(
        DeepSpeedTransformerConfig(**CFG),
        sparsity_config=FixedSparsityConfig(HEADS, block=16), device="cpu")
    plain.load_state_dict(layer.state_dict())
    # 1e-6: two forwards may split their CPU matmul sums differently
    torch.testing.assert_close(layer(x), plain(x), atol=1e-6, rtol=0)
    a, b, c = layer(x, dropout_seed=5), layer(x, dropout_seed=5), \
        layer(x, dropout_seed=6)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert float((a - c).detach().abs().max()) > 1e-2
