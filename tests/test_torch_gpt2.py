"""GPT-2: the port (`deepspeed_tpu_torch/models/gpt2.py`) against the
flax model (`deepspeed_tpu/models/gpt2.py`) from the same params.

Params are initialised in JAX and carried across with
``convert_gpt2_params``; token ids come from ``numpy.random``.

Tolerances: f32 logits atol 1e-5 (same arithmetic, summation order
differs); bf16 logits atol 2e-2 — each side rounds to bf16 after every
matmul, LayerNorm and GELU, and the two frameworks do not round at
exactly the same points (one or two bf16 ulps at logit magnitude ~1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.inference.cache import init_kv_cache, spec_for_model
from deepspeed_tpu_torch.models import gpt2 as tgpt2

T = 12


def _jax_params(seed=0, **kw):
    model = jgpt2.GPT2LMHead(jgpt2.gpt2_tiny(dtype=jnp.float32, **kw))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, dtype=torch.float32):
    model = tgpt2.GPT2LMHead(tgpt2.gpt2_tiny(dtype=dtype), device="cpu")
    model.load_state_dict(tgpt2.convert_gpt2_params(_numpy_tree(params)))
    return model.eval()


def _ids(seed, B=2):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def test_converter_round_trip():
    _, params = _jax_params()
    flat = _numpy_tree(params)
    model = _port_model(params)
    sd = model.state_dict()
    assert set(sd) == set(tgpt2.convert_gpt2_params(flat))
    np.testing.assert_array_equal(sd["wte"].numpy(), flat["wte"])
    np.testing.assert_array_equal(sd["ln_f.weight"].numpy(),
                                  flat["ln_f"]["scale"])
    for i in range(2):
        layer = flat[f"h_{i}"]
        np.testing.assert_array_equal(
            sd[f"h.{i}.attn.c_attn.weight"].numpy().T,
            layer["attn"]["c_attn"]["kernel"])
        np.testing.assert_array_equal(sd[f"h.{i}.mlp.c_proj.bias"].numpy(),
                                      layer["mlp"]["c_proj"]["bias"])
        np.testing.assert_array_equal(sd[f"h.{i}.ln_2.bias"].numpy(),
                                      layer["ln_2"]["bias"])


def test_converter_accepts_stacked_layout():
    _, params = _jax_params()
    unrolled = tgpt2.convert_gpt2_params(_numpy_tree(params))
    stacked = tgpt2.convert_gpt2_params(
        _numpy_tree(jgpt2.stack_gpt2_layer_params(params)))
    assert set(stacked) == set(unrolled)
    for name, t in unrolled.items():
        assert torch.equal(stacked[name], t), name


def test_converter_rejects_gaps():
    _, params = _jax_params()
    flat = dict(_numpy_tree(params))
    flat["h_3"] = flat.pop("h_1")
    with pytest.raises(ValueError, match="non-contiguous"):
        tgpt2.convert_gpt2_params(flat)


def test_uncached_forward_f32_matches_jax():
    model, params = _jax_params()
    ids = _ids(1)
    want = model.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_uncached_forward_bf16_matches_jax():
    _, params = _jax_params()
    jmodel = jgpt2.GPT2LMHead(jgpt2.gpt2_tiny())          # bf16 compute
    ids = _ids(2)
    want = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        got = _port_model(params, torch.bfloat16)(torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=0)


def test_cast_matmul_weights_is_bit_identical():
    _, params = _jax_params()
    ids = torch.from_numpy(_ids(3)).long()
    model = _port_model(params, torch.bfloat16)
    with torch.no_grad():
        before = model(ids)
        model.cast_matmul_weights_()
        after = model(ids)
    assert model.h[0].attn.c_attn.weight.dtype == torch.bfloat16
    assert model.h[0].ln_1.weight.dtype == torch.float32
    assert torch.equal(before, after)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_cached_decode_matches_full_forward(impl, kv):
    """Teacher-forced: a 4-token prefill chunk, then one token per
    decode call, must reproduce one full forward's logits (f32 atol
    1e-5 on plain storage; int8 storage within its codec error: k/v
    rounded to 1/127 of each head vector's absmax move these logits by
    up to ~5e-3, so atol 1e-2)."""
    _, params = _jax_params()
    model = _port_model(params)
    ids = torch.from_numpy(_ids(4)).long()
    cfg = model.config
    cache = init_kv_cache(spec_for_model(cfg, 2, 32, kv), "cpu")
    with torch.no_grad():
        full = model(ids)
        pos = torch.arange(4)[None].expand(2, 4)
        logits, _ = model(ids[:, :4], positions=pos, kv_cache=cache)
        steps = [logits]
        for t in range(4, T):
            pos = torch.full((2, 1), t)
            logits, _ = model(ids[:, t:t + 1], positions=pos, kv_cache=cache,
                              attn_impl=impl, attn_block_k=8)
            steps.append(logits)
    atol = 1e-5 if kv is None else 1e-2
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               atol=atol, rtol=0)


def test_init_matches_jax_initializer_scales():
    """Seeded torch init draws from the JAX model's distributions."""
    gen = torch.Generator().manual_seed(0)
    model = tgpt2.GPT2LMHead(tgpt2.gpt2_tiny(n_embd=256, n_head=4),
                             device="cpu", generator=gen)
    w = model.h[0].mlp.c_fc.weight                   # [4C, C], fan_in C
    assert abs(model.wte.std().item() - 0.02) < 2e-3
    assert abs(model.wpe.std().item() - 0.01) < 1e-3
    assert abs(w.std().item() - 256 ** -0.5) < 2e-3
    bound = 2 * 256 ** -0.5 / tgpt2._TRUNC_STD
    assert w.abs().max().item() <= bound + 1e-6
    again = tgpt2.GPT2LMHead(tgpt2.gpt2_tiny(n_embd=256, n_head=4),
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.wte, model.wte)
