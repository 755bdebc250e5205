"""The training slice end to end: the port's ``initialize`` ->
``DeepSpeedEngine`` -> ``GPT2LMHead`` (flash attention) -> Adam against
``deepspeed_tpu.initialize`` on the same config, params and batches.

Params are initialised in JAX (``gpt2_tiny``, f32, dropout 0,
``use_flash_attention=True``) and carried across with
``convert_gpt2_params``; gradients convert through the same function.
The JAX engine runs on a one-device mesh, so both sides see world size
1 and the same micro-batch split. On the CPU the JAX flash route is its
blockwise XLA path and the port's is the kernels' plain versions.

Tolerances: f32 loss curves rtol 1e-4 over 5 steps (fp32 summation
order drifts through Adam); step-1 gradients atol 1e-6 (magnitudes
<= ~0.1); bf16 curves rtol 2e-2 (bf16 rounds activations at different
places in the two frameworks: flax LayerNorm takes the bf16-cast scale,
the port's takes the fp32 master).
"""

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
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)
from deepspeed_tpu_torch.ops import fused_adam as fused_adam_module
from deepspeed_tpu_torch.ops.fused_adam import fused_adam

STEPS = 5
T = 32
RTOL_F32 = 1e-4
GRAD_ATOL = 1e-6
RTOL_BF16 = 2e-2

BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
CONFIGS = {
    "adam": BASE,
    "accum2_clip_warmup_fused": dict(
        BASE, gradient_accumulation_steps=2, gradient_clipping=0.5,
        optimizer={"type": "Adam", "params": {"lr": 2e-3, "pallas": True}},
        scheduler={"type": "WarmupLR",
                   "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 2e-3,
                              "warmup_num_steps": 3}}),
    "adamw_decay_clip": dict(
        BASE, gradient_clipping=1.0,
        optimizer={"type": "AdamW",
                   "params": {"lr": 1e-3, "weight_decay": 0.1}}),
}


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (8, T)).astype(np.int32)}
            for _ in range(n)]


def _jax_engine(params, config, dtype=jnp.float32):
    model = JaxGPT2(jax_tiny(dtype=dtype, use_flash_attention=True))
    mesh = build_mesh({}, devices=jax.devices()[:1])
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=dict(config), loss_fn=jax_loss_fn(model), params=params,
        mesh=mesh)
    return engine, model


def _port_engine(params, config, dtype=torch.float32):
    model = GPT2LMHead(gpt2_tiny(dtype=dtype, use_flash_attention=True),
                       device="cpu")
    model.load_state_dict(convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, params)))
    engine, _, _, _ = initialize(model=model, config=dict(config),
                                 device="cpu")
    return engine


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_curve_matches_jax_engine(jax_params, name):
    config = CONFIGS[name]
    jeng, _ = _jax_engine(jax_params, config)
    teng = _port_engine(jax_params, config)
    want = [float(jeng.train_batch(b)) for b in _batches()]
    got = [float(teng.train_batch(b)) for b in _batches()]
    np.testing.assert_allclose(got, want, rtol=RTOL_F32)
    assert teng.global_steps == STEPS
    assert teng.micro_steps == STEPS * teng.gradient_accumulation_steps()
    assert int(teng.opt_state.step) == STEPS


def test_fused_optimizer_route_runs_k4(jax_params, monkeypatch):
    """Every step sends the update through the K4 wrapper, once, with or
    without ``pallas: true`` (its plain version here, on CPU tensors: no
    launch is counted)."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return fused_adam(*args, **kwargs)

    monkeypatch.setattr(fused_adam_module, "fused_adam", counting)
    before = fused_adam.launches
    for name in ("adam", "accum2_clip_warmup_fused"):
        teng = _port_engine(jax_params, CONFIGS[name])
        teng.train_batch(_batches(1)[0])
    assert len(calls) == 2
    assert fused_adam.launches == before


def test_step1_grads_match_jax(jax_params):
    batch = _batches(1)[0]
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    want = jax.jit(jax.grad(jax_loss_fn(model)))(
        jax_params, {"input_ids": jnp.asarray(batch["input_ids"])}, None)
    want = convert_gpt2_params(jax.tree_util.tree_map(np.asarray, want))
    teng = _port_engine(jax_params, BASE)
    loss = teng.forward(batch)
    teng.backward(loss)
    got = {n: p.grad for n, p in teng.module.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=n)


def test_forward_backward_step_api_matches_train_batch(jax_params):
    config = dict(BASE, gradient_accumulation_steps=2)
    a = _port_engine(jax_params, config)
    b = _port_engine(jax_params, config)
    batch = _batches(1)[0]
    a.train_batch(batch)
    for half in (slice(0, 4), slice(4, 8)):
        loss = b.forward({"input_ids": batch["input_ids"][half]})
        b.backward(loss)
        assert b.is_gradient_accumulation_boundary() == (half.start == 4)
        b.step()
    for pa, pb in zip(a.module.parameters(), b.module.parameters()):
        torch.testing.assert_close(pa, pb, atol=1e-7, rtol=0)
    assert a.global_steps == b.global_steps == 1


def test_bf16_loss_curve_tracks_jax_engine(jax_params):
    config = dict(BASE, bf16={"enabled": True})
    jeng, _ = _jax_engine(jax_params, config, dtype=jnp.bfloat16)
    teng = _port_engine(jax_params, config, dtype=torch.bfloat16)
    want = [float(jeng.train_batch(b)) for b in _batches()]
    got = [float(teng.train_batch(b)) for b in _batches()]
    np.testing.assert_allclose(got, want, rtol=RTOL_BF16)


@pytest.mark.parametrize("fused", [False, True])
def test_fp16_overflow_skips_the_step(jax_params, fused):
    """An inf injected into one gradient: the step is skipped (params,
    moments and the Adam step unchanged), ``skipped_steps`` +1, and the
    dynamic scale follows the hysteresis rule (delayed_shift 2: the
    first overflow only spends hysteresis). With and without the
    ``pallas`` key, which the engine accepts and ignores."""
    config = dict(BASE, fp16={"enabled": True, "initial_scale_power": 8},
                  optimizer={"type": "Adam",
                             "params": {"lr": 1e-3, "pallas": fused}})
    teng = _port_engine(jax_params, config, dtype=torch.float16)
    batches = _batches(3)
    teng.train_batch(batches[0])
    assert teng.skipped_steps == 0
    before = [p.detach().clone() for p in teng.module.parameters()]
    moments = [x.clone() for x in teng.opt_state.m + teng.opt_state.v]
    scale = teng.loss_scale
    handle = teng.module.wte.register_hook(
        lambda g: g * float("inf"))
    teng.train_batch(batches[1])
    handle.remove()
    assert teng.skipped_steps == 1
    assert int(teng.opt_state.step) == 1
    assert teng.loss_scale == scale
    for a, b in zip(before, teng.module.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(moments, teng.opt_state.m + teng.opt_state.v):
        assert torch.equal(a, b)
    loss = float(teng.train_batch(batches[2]))
    assert np.isfinite(loss) and teng.skipped_steps == 1
    assert int(teng.opt_state.step) == 2


def test_initialize_defaults_to_cuda_and_rejects_unported(jax_params,
                                                          monkeypatch):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize(model=model, config=BASE)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        initialize(model=model, config=BASE, training_data=[1],
                   device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        initialize(model=model, config=dict(
            BASE, zero_optimization={"stage": 1}), device="cpu")
    with pytest.raises(NotImplementedError, match="lamb"):
        initialize(model=model, config=dict(
            BASE, optimizer={"type": "Lamb", "params": {}}), device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        initialize(model=model, config=dict(
            BASE, optimizer={"type": "SGD", "params": {}}), device="cpu")
    with pytest.raises(ValueError, match="computes in"):
        initialize(model=model, config=dict(BASE, bf16={"enabled": True}),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="scan_layers"):
        GPT2LMHead(gpt2_tiny(scan_layers=True), device="cpu")


def test_dropout_training_is_deterministic_per_seed(jax_params):
    """Dropout on: the same engine seed replays the same curve (the step
    seed derives from (seed, global_steps)); another seed differs."""
    def curve(seed):
        model = GPT2LMHead(gpt2_tiny(dtype=torch.float32, dropout=0.1,
                                     use_flash_attention=True),
                           device="cpu")
        model.load_state_dict(convert_gpt2_params(
            jax.tree_util.tree_map(np.asarray, jax_params)))
        eng, _, _, _ = initialize(model=model, config=BASE, device="cpu",
                                  seed=seed)
        return [float(eng.train_batch(b)) for b in _batches(3)]

    a, b, c = curve(0), curve(0), curve(1)
    assert a == b
    assert a != c
