"""The pipeline with every stage in one process (``LocalTransport``) held
to the JAX package's: its 1F1B ``make_pipeline_value_and_grad_fn``, its
``sequential_loss_fn``, its GPipe ``make_pipeline_loss_fn`` and its
``PipelineEngine``, at pipe 2 and 4 on a sub-mesh of the conftest's
virtual CPU devices, with the params carried by
``convert_gpt2_pipe_params``.

Shapes are ``tests/unit/test_pipe.py``'s (vocab 64, seq 16, n_embd 32, 4
layers, 4 heads, f32, dropout 0); each JAX reference is computed once
(module-scoped fixture). Tolerances are the JAX test's
(``test_pipe.py:221-231``): loss rtol 2e-5, gradients rtol 1e-4 and atol
1e-6 at the loss scale 3.0. Against the port's own sequential oracle
(the same stage modules run one micro-batch at a time) the executor is
bit for bit."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2Config
from deepspeed_tpu.models.gpt2_pipe import (
    gpt2_pipeline_module as jax_pipeline_module)
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.pipe.pipeline import (
    build_pipeline_parts,
    make_pipeline_loss_fn,
    make_pipeline_value_and_grad_fn,
    sequential_loss_fn as jax_sequential_loss_fn,
)
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    gpt2_tiny,
)
from deepspeed_tpu_torch.models.gpt2_pipe import (
    convert_gpt2_pipe_params,
    gpt2_pipeline_module,
    lm_state_to_pipe,
    pipe_state_to_lm,
)
from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

VOCAB, SEQ, MICRO, ROWS = 64, 16, 4, 8
SCALE = 3.0
ADAM_EPS = {"type": "Adam", "params": {"lr": 1e-2, "eps": 1e-3}}


def jax_cfg(n_layer=4, dtype=jnp.float32):
    return GPT2Config(vocab_size=VOCAB, n_positions=SEQ, n_embd=32,
                      n_layer=n_layer, n_head=4, dropout=0.0, dtype=dtype)


def port_cfg(n_layer=4, dtype=torch.float32, **kw):
    return gpt2_tiny(vocab_size=VOCAB, n_positions=SEQ, n_embd=32,
                     n_layer=n_layer, n_head=4, dtype=dtype, **kw)


def batch_of(rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, VOCAB, (rows, SEQ))
            .astype(np.int32)}


def as_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def config(pipe, **extra):
    cfg = {"train_batch_size": ROWS, "gradient_accumulation_steps": MICRO,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "steps_per_print": 10 ** 9, "mesh": {"pipe": pipe}}
    cfg.update(extra)
    return cfg


def port_engine(pipe, state, n_layer=4, dtype=torch.float32, model_kw=None,
                stage_devices=None, **extra):
    module = gpt2_pipeline_module(port_cfg(n_layer, dtype,
                                           **(model_kw or {})), seq_len=SEQ)
    engine, _, _, _ = initialize(model=module, config=config(pipe, **extra),
                                 model_parameters=state, device="cpu",
                                 stage_devices=stage_devices)
    return engine


@pytest.fixture(scope="module")
def jax_ref():
    """Per pipe: the JAX params (pipe layout), the 1F1B loss and grads at
    SCALE, the sequential loss and the GPipe eval loss."""
    out = {}
    batch = batch_of()
    mb = {k: v.reshape((MICRO, ROWS // MICRO) + v.shape[1:])
          for k, v in batch.items()}
    for pipe in (2, 4):
        mesh = build_mesh({"pipe": pipe, "data": 1},
                          devices=jax.devices()[:pipe])
        module = jax_pipeline_module(jax_cfg(), seq_len=SEQ)
        parts = build_pipeline_parts(module, pipe, jax.random.PRNGKey(0),
                                     module.example_input)
        vag = make_pipeline_value_and_grad_fn(parts, mesh, MICRO)
        loss, grads = jax.jit(lambda p, b: vag(p, b, None, SCALE))(
            parts.params, batch)
        gpipe = jax.jit(make_pipeline_loss_fn(parts, mesh, MICRO))(
            parts.params, batch, None)
        seq = jax_sequential_loss_fn(parts, parts.params, mb)
        np_tree = jax.tree_util.tree_map(np.asarray, parts.params)
        out[pipe] = {
            "state": convert_gpt2_pipe_params(np_tree),
            "loss": float(loss), "gpipe": float(gpipe), "seq": float(seq),
            "grads": convert_gpt2_pipe_params(
                jax.tree_util.tree_map(np.asarray, grads))}
    return out


@pytest.mark.parametrize("pipe", [2, 4])
def test_1f1b_loss_and_grads_equal_jax(jax_ref, pipe):
    ref = jax_ref[pipe]
    engine = port_engine(pipe, ref["state"], stage_devices=["cpu"] * pipe)
    assert isinstance(engine, PipelineEngine) and engine.in_process
    loss, grads = engine.value_and_grad(as_torch(batch_of()), SCALE)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(float(loss), ref["seq"], rtol=2e-5)
    assert sorted(grads) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("pipe", [2, 4])
def test_eval_equals_jax_gpipe(jax_ref, pipe):
    engine = port_engine(pipe, jax_ref[pipe]["state"])
    got = float(engine.eval_batch(as_torch(batch_of())))
    np.testing.assert_allclose(got, jax_ref[pipe]["gpipe"], rtol=2e-5)


@pytest.mark.parametrize("pipe,interval", [(2, 0), (4, 0), (4, 1)])
def test_executor_equals_sequential_oracle_bitwise(jax_ref, pipe, interval):
    """The 1F1B executor's loss sums and every stage gradient equal the
    same stage modules run sequentially, backward in micro-batch order;
    activation checkpointing (interval 1) changes no bit."""
    engine = port_engine(pipe, jax_ref[pipe]["state"])
    stages = {s: copy.deepcopy(st) for s, st in engine.parts.stages.items()}
    for st in stages.values():
        for q in st.parameters():
            q.grad = torch.zeros_like(q)
    for st in engine.parts.stages.values():
        st.checkpoint_interval = interval
    micro = engine._split(as_torch(batch_of()))
    num, den = engine.executor.run(micro, train=True, scale=SCALE)
    o_num, o_den = pl.sequential_loss_fn(engine.parts, micro, scale=SCALE,
                                         stages=stages)
    assert torch.equal(num, o_num) and torch.equal(den, o_den)
    for s, st in engine.parts.stages.items():
        for (n, p), (_, q) in zip(st.named_parameters(),
                                  stages[s].named_parameters()):
            assert torch.equal(p.grad, q.grad), (s, n)
    # 1F1B holds at most S - s micro-batches on stage s
    assert engine.executor.max_in_flight == {
        s: min(MICRO, pipe - s) for s in range(pipe)}


def test_1f1b_in_flight_bound_independent_of_micro_batches(jax_ref):
    """At 16 micro-batches each stage still holds at most S - s graphs
    (JAX's ``test_1f1b_memory_independent_of_microbatches`` property)."""
    engine = port_engine(4, jax_ref[4]["state"], train_batch_size=32,
                         gradient_accumulation_steps=16)
    engine.train_batch(as_torch(batch_of(32)))
    assert engine.executor.max_in_flight == {s: 4 - s for s in range(4)}
    assert engine.p2p_counts()["messages"] == 2 * 3 * 16


@pytest.fixture(scope="module")
def jax_engine_run():
    """JAX's PipelineEngine at pipe 2: its initial params and 3 losses."""
    mesh = build_mesh({"pipe": 2, "data": 1}, devices=jax.devices()[:2])
    cfg = config(2, optimizer=ADAM_EPS)
    del cfg["mesh"]
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, model=jax_pipeline_module(jax_cfg(), seq_len=SEQ),
        mesh=mesh)
    state = convert_gpt2_pipe_params(jax.tree_util.tree_map(
        np.asarray, engine.params))
    losses = [float(engine.train_batch(batch_of(seed=i))) for i in range(3)]
    after = convert_gpt2_pipe_params(jax.tree_util.tree_map(
        np.asarray, engine.params))
    return state, losses, after


def test_engine_three_steps_equal_jax(jax_engine_run):
    """Losses rtol 1e-5; masters atol 2e-5 after 3 steps (Adam eps 1e-3,
    where its update is linear in a gradient near 0; at eps 1e-8 a
    gradient of 1e-9 moves its weight by lr times its sign, so
    differences far inside the gradient tolerance would show as lr)."""
    state, want, after = jax_engine_run
    engine = port_engine(2, state, optimizer=ADAM_EPS)
    got = [float(engine.train_batch(as_torch(batch_of(seed=i))))
           for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    masters = engine.pipe_state()
    for name, ref in after.items():
        np.testing.assert_allclose(masters[name].numpy(), ref.numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
    # the tied copies stayed equal, bit for bit
    for n, p in engine.parts.stages[0].tied.named_parameters():
        assert torch.equal(p, dict(
            engine.parts.stages[1].tied.named_parameters())[n])


def test_fp16_loss_scale_through_the_1f1b(jax_ref):
    """fp16 with the dynamic loss scale (JAX
    ``test_pipeline_engine_fp16_loss_scale``): the scale seeds the
    backward, training proceeds, the counters move; the first loss is
    JAX's f32 one within fp16's rounding."""
    engine = port_engine(2, jax_ref[2]["state"], dtype=torch.float16,
                         fp16={"enabled": True, "initial_scale_power": 10})
    batch = as_torch(batch_of())
    losses = [float(engine.train_batch(batch)) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert engine.loss_scale > 1.0
    np.testing.assert_allclose(losses[0], jax_ref[2]["loss"], rtol=1e-2)


def test_one_stage_equals_the_plain_engine(jax_ref):
    """S = 1 (DataParallelSchedule) against the unpipelined
    DeepSpeedEngine over 3 steps at the same weights: losses within 1e-6
    relative, masters within 1e-5 (the two normalize the loss in another
    order: sum / count per micro-batch against sums over the batch; Adam
    eps 1e-3 as in :func:`test_engine_three_steps_equal_jax`)."""
    state = jax_ref[2]["state"]
    engine = port_engine(1, lm_state_to_pipe(pipe_state_to_lm(state), 1),
                         optimizer=ADAM_EPS)
    plain = GPT2LMHead(port_cfg(), device="cpu")
    plain.load_state_dict(pipe_state_to_lm(state))
    ref, _, _, _ = initialize(model=plain, config=dict(
        config(1), mesh=None, optimizer=ADAM_EPS), device="cpu")
    for i in range(3):
        b = as_torch(batch_of(seed=i))
        np.testing.assert_allclose(float(engine.train_batch(b)),
                                   float(ref.train_batch(b)), rtol=1e-6)
    got = pipe_state_to_lm(engine.pipe_state())
    for name, p in plain.state_dict().items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_dropout_masks_follow_the_unpipelined_engine(jax_ref):
    """At dropout 0.1 a one-stage pipeline draws the unpipelined model's
    masks (micro-batch m's seed, attention keyed by the global layer,
    stage 0's hidden stream), so its losses are the plain engine's; a
    second stage draws hidden dropout from a stream of its own."""
    state = jax_ref[2]["state"]
    kw = {"model_kw": {"dropout": 0.1}, "optimizer": ADAM_EPS}
    one = port_engine(1, lm_state_to_pipe(pipe_state_to_lm(state), 1), **kw)
    two = port_engine(2, state, **kw)
    plain = GPT2LMHead(port_cfg(dropout=0.1), device="cpu")
    plain.load_state_dict(pipe_state_to_lm(state))
    ref, _, _, _ = initialize(model=plain, config=dict(
        config(1), mesh=None, optimizer=ADAM_EPS), device="cpu")
    b = as_torch(batch_of())
    got, want, other = (float(e.train_batch(b)) for e in (one, ref, two))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs(other - want) > 1e-4


def test_weights_round_trip_through_the_layouts(jax_ref):
    state = jax_ref[4]["state"]
    for pipe in (1, 2, 4):
        back = lm_state_to_pipe(pipe_state_to_lm(state), pipe)
        for name, t in state.items():
            assert torch.equal(back[name].reshape(t.shape), t), name


def test_checkpoint_round_trip_and_restage(jax_ref, tmp_path):
    """Resume at the same topology is bit-exact; a checkpoint saved at 4
    stages loads at 2 (only the body's leading split changes)."""
    batch = as_torch(batch_of())
    a = port_engine(4, jax_ref[4]["state"])
    a.train_batch(batch)
    a.save_checkpoint(str(tmp_path), tag="t1")
    snapshot = a.pipe_state()
    kept = {n: t.clone() for n, t in snapshot.items()}
    want = [float(a.train_batch(batch)) for _ in range(2)]
    # pipe_state() is a copy: later steps change none of its leaves
    assert all(torch.equal(snapshot[n], kept[n]) for n in kept)
    assert not torch.equal(a.pipe_state()["tied.embed.wte"],
                           kept["tied.embed.wte"])
    b = port_engine(4, None)
    b.load_checkpoint(str(tmp_path), tag="t1")
    assert [float(b.train_batch(batch)) for _ in range(2)] == want
    c = port_engine(2, None)
    c.load_checkpoint(str(tmp_path), tag="t1")
    fresh = port_engine(4, None)
    fresh.load_checkpoint(str(tmp_path), tag="t1")
    np.testing.assert_allclose(float(c.eval_batch(batch)),
                               float(fresh.eval_batch(batch)), rtol=1e-6)
    assert c.global_steps == 1
    np.testing.assert_allclose(float(c.train_batch(batch)), want[0],
                               rtol=1e-5)


def test_jax_error_texts_and_later_compositions(jax_ref):
    with pytest.raises(ValueError, match="divide evenly"):
        port_engine(4, None, n_layer=3)
    with pytest.raises(ValueError, match="progressive_layer_drop"):
        port_engine(2, None, progressive_layer_drop={"enabled": True})
    engine = port_engine(2, None)
    with pytest.raises(RuntimeError):
        engine.forward(as_torch(batch_of()))
    with pytest.raises(RuntimeError):
        engine.backward()
    with pytest.raises(RuntimeError):
        engine.step()
    with pytest.raises(ValueError, match="does not match the mesh pipe"):
        initialize(model=gpt2_pipeline_module(port_cfg(), num_stages=4),
                   config=config(2), device="cpu")
    bf16 = dict(dtype=torch.bfloat16, bf16={"enabled": True})
    for extra, item in [
            (dict(fp8={"enabled": True}), "F2"),
            (dict(optimizer={"type": "OneBitAdam", "params": {}}), "F5"),
            (dict(bf16, zero_optimization={"stage": 3}), "F1b"),
            (dict(bf16, zero_optimization={"stage": 2,
                                           "cpu_offload": True}), "F1b"),
            (dict(mesh={"pipe": 2, "model": 2}), "F2")]:
        with pytest.raises(NotImplementedError,
                           match=f"not yet ported.*item 5 {item}"):
            port_engine(2, None, **extra)
    with pytest.raises(ValueError, match="needs a PipelineModule"):
        initialize(model=GPT2LMHead(port_cfg(), device="cpu"),
                   config=config(2), device="cpu")
