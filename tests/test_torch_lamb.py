"""LAMB and client optimizer objects in the port
(`deepspeed_tpu_torch/ops/lamb/fused_lamb.py`, the engine's optimizer
step).

- ``lamb_update`` equals JAX's ``lamb_update`` within rtol 1e-6 (f32)
  over three steps, with weight decay, with and without bias correction,
  on leaves that hit a zero param norm and both trust-ratio clamps.
- Engine LAMB loss curves equal the JAX engine's over 5 steps at the
  engine tolerance of ``tests/test_torch_train_engine.py`` (f32 rtol
  1e-4), with accumulation and clipping.
- ZeRO stages 1-3 at worlds 2 and 4 (gloo, ``tests/torch_zero_worker.py``)
  equal stage 0 in bf16 over 2 steps: losses within rtol 1e-5 and fp32
  masters within atol 1e-6 (each rank's squared norms are summed over
  the group by one all-reduce, in another order than stage 0's
  whole-leaf sums).
- An fp16 overflow skips the LAMB step: masters, moments and the step
  count stay.
- A client ``FusedAdam`` / ``FusedLamb`` object gives the config path's
  run bit for bit; any object with the ``init`` / ``update`` protocol
  runs functionally (loss curve within rtol 1e-5 of the config path's);
  a OneBitAdam object raises, naming its item.
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
from deepspeed_tpu.ops.lamb import LambState as JaxLambState
from deepspeed_tpu.ops.lamb import lamb_update as jax_lamb_update
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead, convert_gpt2_params, gpt2_tiny)
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import adam_update
from deepspeed_tpu_torch.ops.lamb import (
    FusedLamb, LambState, init_lamb_state, lamb_update)
from tests import torch_zero_harness as H
from tests.torch_threads import one_thread  # noqa: F401

LAMB = {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                   "max_coeff": 10.0, "min_coeff": 0.01}}
BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": LAMB}


def _leaves():
    rng = np.random.default_rng(0)
    p = [rng.normal(size=(6, 5)).astype(np.float32),
         np.zeros((7,), np.float32),                       # zero norm
         (1e4 * rng.normal(size=(4, 4))).astype(np.float32),  # ratio > 10
         (1e-6 * rng.normal(size=(9,))).astype(np.float32)]   # ratio < .01
    g = [rng.normal(size=x.shape).astype(np.float32) for x in p]
    return p, g


@pytest.mark.parametrize("bias_correction", [True, False])
def test_lamb_update_equals_jax(bias_correction):
    p, g = _leaves()
    kw = dict(lr=1e-2, beta1=0.9, beta2=0.99, eps=1e-6, weight_decay=0.1,
              bias_correction=bias_correction, max_coeff=10.0,
              min_coeff=0.01)
    tp = [torch.from_numpy(x) for x in p]
    ts = init_lamb_state(tp)
    jp = [jnp.asarray(x) for x in p]
    js = JaxLambState(m=[jnp.zeros_like(x) for x in jp],
                      v=[jnp.zeros_like(x) for x in jp],
                      step=jnp.asarray(0, jnp.int32))
    for step in range(3):
        tg_ = [torch.from_numpy(x * (step + 1)) for x in g]
        jg_ = [jnp.asarray(x * (step + 1)) for x in g]
        tp, ts = lamb_update(tp, tg_, ts, **kw)
        jp, js = jax_lamb_update(jp, jg_, js, **kw)
        for a, b in zip(tp + ts.m + ts.v, jp + list(js.m) + list(js.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-30)
        assert int(ts.step) == int(js.step) == step + 1
    # the zero leaf stayed put only by its zero update's ratio of 1
    assert np.abs(tp[1].numpy()).max() > 0


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _batches(n=5):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}
            for _ in range(n)]


def _port_engine(params, config, optimizer=None):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32,
                                 use_flash_attention=True), device="cpu")
    model.load_state_dict(convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, params)))
    engine, opt, _, _ = initialize(model=model, config=dict(config),
                                   optimizer=optimizer, device="cpu")
    assert opt is optimizer
    return engine


def _run(engine):
    losses = [float(engine.train_batch(b)) for b in _batches()]
    return losses, [m.clone() for m in engine._masters]


def test_engine_lamb_equals_jax(jax_params):
    config = dict(BASE, gradient_accumulation_steps=2,
                  gradient_clipping=1.0)
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    jeng, _, _, _ = deepspeed_tpu.initialize(
        config=dict(config), loss_fn=jax_loss_fn(model), params=jax_params,
        mesh=build_mesh({}, devices=jax.devices()[:1]))
    want = [float(jeng.train_batch(b)) for b in _batches()]
    engine = _port_engine(jax_params, config)
    got, _ = _run(engine)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert isinstance(engine.opt_state, LambState)
    assert int(engine.opt_state.step) == 5


def test_client_objects_give_the_config_run(jax_params):
    adam_cfg = dict(BASE, optimizer={"type": "Adam", "params": {
        "lr": 1e-3, "weight_decay": 0.01, "adam_w_mode": True}})
    want = _run(_port_engine(jax_params, adam_cfg))
    got = _run(_port_engine(jax_params, {
        k: v for k, v in adam_cfg.items() if k != "optimizer"},
        FusedAdam(lr=1e-3, weight_decay=0.01, adam_w_mode=True)))
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))

    p = LAMB["params"]
    want = _run(_port_engine(jax_params, BASE))
    lamb = FusedLamb(lr=p["lr"], weight_decay=p["weight_decay"],
                     max_coeff=p["max_coeff"], min_coeff=p["min_coeff"])
    got = _run(_port_engine(jax_params, {
        k: v for k, v in BASE.items() if k != "optimizer"}, lamb))
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


class _ProtocolAdam:
    """A client object that is neither of the port's classes: only the
    ``init`` / ``update`` protocol."""
    lr = 1e-3

    def init(self, params):
        return FusedAdam().init(params)

    def update(self, params, grads, state, lr=None, beta1=None):
        return adam_update(params, grads, state, lr=lr, beta1=beta1,
                           adam_w_mode=True)


def test_protocol_objects_run_and_onebit_raises(jax_params):
    cfg = {k: v for k, v in BASE.items() if k != "optimizer"}
    want = _run(_port_engine(jax_params, dict(cfg, optimizer={
        "type": "AdamW", "params": {"lr": 1e-3}})))
    engine = _port_engine(jax_params, cfg, _ProtocolAdam())
    start = [m.clone() for m in engine._masters]
    got = _run(engine)
    # the functional update takes 1 - beta in double before rounding, K4
    # in fp32: the curves agree to fp32 noise, which Adam amplifies on
    # elements whose gradient is ~0 (the c_attn key bias), so the masters
    # are held to having moved
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert all(not torch.equal(a, b) for a, b in zip(got[1], start))
    assert int(engine.opt_state.step) == 5

    # 1-bit Adam runs, by name and as a client object (one rank: its
    # compressed all-reduce has no exchange); AMSGrad raises the
    # reference's error
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
    with pytest.raises(RuntimeError, match="AMSGrad"):
        OnebitAdam(amsgrad=True)
    by_name = _port_engine(jax_params, dict(cfg, optimizer={
        "type": "OneBitAdam",
        "params": {"lr": 1e-3, "freeze_step": 2, "eps": 1e-4}}))
    client = _port_engine(jax_params, cfg,
                          OnebitAdam(lr=1e-3, freeze_step=2, eps=1e-4))
    assert by_name._opt_kind == client._opt_kind == "onebit"
    got, want = ([float(e.train_batch(b)) for b in _batches()[:3]]
                 for e in (by_name, client))
    assert np.isfinite(got).all() and got == want
    assert int(client.opt_state.step) == 3
    assert float(client.opt_state.worker_error.abs().sum()) > 0


# ---------------------------------------------------------------------------
# ZeRO stages 1-3 at worlds 2 and 4
# ---------------------------------------------------------------------------

STAGES = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def worlds(jax_params, tmp_path_factory):
    root = tmp_path_factory.mktemp("lamb")
    params = H.init_jax_params(use_flash_attention=False)
    state = H.save_port_state(params, root / "tiny.npz")
    cases = [dict(dtype="bf16", flash=False, stage=s, name=f"s{s}",
                  steps=2, keys={"optimizer": LAMB}) for s in STAGES]
    out = {}
    for world in (2, 4):
        H.spawn_world(world, cases, state, root / f"w{world}")
        out[world] = {f"s{s}": H.load_results(root / f"w{world}", f"s{s}",
                                              world) for s in STAGES}
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_lamb_equals_stage0(worlds, world, stage):
    base, _ = worlds[world]["s0"][0]
    for arrays, _ in worlds[world][f"s{stage}"]:
        np.testing.assert_allclose(arrays["losses"], base["losses"],
                                   rtol=1e-5)
        for key, want in base.items():
            if key.startswith("param/"):
                np.testing.assert_allclose(arrays[key], want, atol=1e-6,
                                           err_msg=key)


def test_an_fp16_overflow_skips_the_lamb_update(jax_params):
    """An fp16 step whose gradient overflows leaves every master, both
    moments and the step count as they were (JAX's ``select(overflow,
    old, new)``)."""
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float16,
                                 use_flash_attention=True), device="cpu")
    model.load_state_dict(convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, jax_params)))
    engine, _, _, _ = initialize(model=model, config=dict(
        BASE, fp16={"enabled": True, "initial_scale_power": 8}),
        device="cpu")
    engine.train_batch(_batches(1)[0])
    s = engine.opt_state
    before = [t.clone() for t in engine._masters + s.m + s.v]
    step = int(s.step)
    engine.backward(engine.forward(_batches(2)[1]))
    engine._grads[3].view(-1)[0] = float("inf")
    engine.step()
    assert bool(engine._last_metrics["overflow"])
    s = engine.opt_state
    after = engine._masters + s.m + s.v
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert int(s.step) == step == 1
