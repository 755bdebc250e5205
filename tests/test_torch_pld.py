"""Progressive layer drop in the port
(`deepspeed_tpu_torch/runtime/progressive_layer_drop.py`, the ``Block``
path of `models/gpt2.py`, the engine's theta schedule).

- theta(t) equals JAX's ``ProgressiveLayerDrop`` and the JAX engine's
  fp32 ``theta_fn`` to 1e-7.
- At theta 1 every sublayer is kept: the port's PLD run equals its run
  without PLD bit for bit, and JAX's PLD run at the engine tolerance of
  ``tests/test_torch_train_engine.py`` (f32 losses rtol 1e-4).
- The coins (``pld_coins``, a CPU generator the port's own: they cannot
  match ``jax.random.bernoulli``) keep sublayer ``l`` at the rate
  ``1 - (l+1)/L (1 - theta)`` within a 5-sigma binomial bound.
- A dropped sublayer runs nothing: attention calls equal the kept
  attention coins, MLP calls the kept MLP coins, in both layouts.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn as jax_loss_fn
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
from deepspeed_tpu.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop as JaxPLD)
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop)

BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}


@pytest.mark.parametrize("theta,gamma", [(0.5, 0.001), (0.3, 0.05),
                                         (0.9, 1.0)])
def test_theta_schedule_equals_jax(theta, gamma):
    ours, theirs = ProgressiveLayerDrop(theta, gamma), JaxPLD(theta, gamma)
    params = {"theta": theta, "gamma": gamma}
    fake = types.SimpleNamespace(_config=types.SimpleNamespace(
        pld_enabled=True, pld_params=params))
    jax_fn = JaxEngine._pld_theta_fn(fake)
    engine = types.SimpleNamespace(progressive_layer_drop=ours)
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    for t in (0, 1, 7, 100, 2500):
        ours.update_state(t)
        theirs.update_state(t)
        assert abs(ours.get_theta() - theirs.get_theta()) <= 1e-7
        got = DeepSpeedEngine._pld_theta(engine, t)
        want = float(jax_fn(jnp.asarray(t, jnp.int32)))
        assert abs(got - want) <= 1e-7, (t, got, want)
    assert ours.get_state() == {"progressive_layer_drop": True,
                                "pld_theta": ours.get_theta()}


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}
            for _ in range(n)]


def _port_losses(params, config):
    model = tg.GPT2LMHead(tg.gpt2_tiny(dtype=torch.float32,
                                       use_flash_attention=True),
                          device="cpu")
    model.load_state_dict(tg.convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, params)))
    engine, _, _, _ = initialize(model=model, config=config, device="cpu")
    return [float(engine.train_batch(b)) for b in _batches()], model


def test_theta_one_run_equals_jax_and_the_plain_run(jax_params):
    config = dict(BASE, progressive_layer_drop={
        "enabled": True, "theta": 1.0, "gamma": 0.1})
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        config=dict(config), loss_fn=jax_loss_fn(model), params=jax_params,
        mesh=build_mesh({}, devices=jax.devices()[:1]))
    want = [float(jeng.train_batch(b)) for b in _batches()]
    got, tmodel = _port_losses(jax_params, config)
    plain, _ = _port_losses(jax_params, BASE)
    assert tmodel.last_pld_coins == [(True, True)] * 2
    assert got == plain
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("theta", [0.5, 0.2])
def test_keep_rates_follow_the_depth_schedule(theta):
    L, n = 6, 4000
    kept = np.zeros((L, 2))
    for seed in range(n):
        coins = tg.pld_coins(theta, L, seed)
        kept += np.array(coins, dtype=np.float64)
    for layer in range(L):
        p = tg.pld_keep_prob(layer, L, theta)
        sigma = np.sqrt(p * (1 - p) / n)
        for rate in kept[layer] / n:
            assert abs(rate - p) <= 5 * sigma + 1e-12, (layer, rate, p)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_a_dropped_sublayer_runs_nothing(monkeypatch, scan):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    calls = {"attn": 0, "mlp": 0}
    real_attn = fa.flash_attention
    real_mlp = tg.MLP.forward

    def attn(*args, **kwargs):
        calls["attn"] += 1
        return real_attn(*args, **kwargs)

    def mlp(self, *args, **kwargs):
        calls["mlp"] += 1
        return real_mlp(self, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", attn)
    monkeypatch.setattr(tg.MLP, "forward", mlp)
    model = tg.GPT2LMHead(tg.gpt2_tiny(
        dtype=torch.float32, use_flash_attention=True, n_layer=8,
        scan_layers=scan), device="cpu")
    ids = torch.zeros((2, 16), dtype=torch.int64)
    seen = set()
    for seed in range(6):
        calls.update(attn=0, mlp=0)
        model.loss_fn({"input_ids": ids}, seed, pld_theta=0.3)
        coins = np.array(model.last_pld_coins)
        assert calls["attn"] == coins[:, 0].sum()
        assert calls["mlp"] == coins[:, 1].sum()
        seen.add(int(coins.sum()))
    assert len(seen) > 1 and min(seen) < 16
    # without an rng (a deterministic forward) PLD does not apply
    model.loss_fn({"input_ids": ids}, None, pld_theta=0.3)
    assert model.last_pld_coins is None
