"""The pipeline across processes (one process a stage rank,
``ProcessTransport`` over gloo) at pipe 2 x data 1, pipe 4 x data 1 and
pipe 2 x data 2, held to JAX's 1F1B ``make_pipeline_value_and_grad_fn``
on a same-size sub-mesh and, bit for bit, to the pipeline with every
stage of a replica in one process (``LocalTransport``); and ZeRO stage 2
inside each stage's data group.

Two worlds of ``tests/torch_pipe_worker.py`` processes (2 and 4 ranks)
are spawned once (module-scoped fixture) and run every case; the
one-process pipelines at data 1 run in this process. Every case starts
from the JAX params of ``build_pipeline_parts`` (``convert_gpt2_pipe_
params``). Tolerances against JAX are ``tests/unit/test_pipe.py``'s:
loss rtol 2e-5, gradients rtol 1e-4 and atol 1e-6 at the loss scale 3."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config
from deepspeed_tpu.models.gpt2_pipe import (
    gpt2_pipeline_module as jax_pipeline_module)
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.pipe.pipeline import (
    build_pipeline_parts,
    make_pipeline_value_and_grad_fn,
)
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny
from deepspeed_tpu_torch.models.gpt2_pipe import (
    convert_gpt2_pipe_params,
    gpt2_pipeline_module,
)
from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
from tests import torch_zero_harness as H

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_pipe_worker.py")
VOCAB, SEQ, MICRO, STEPS = 64, 16, 4, 2


def case(pipe, data, dtype="f32", stage=0, in_process=False):
    mesh = {"pipe": pipe, "data": data} if in_process else {"pipe": pipe}
    return {"mesh": mesh, "batch": 8 * data, "micro": MICRO,
            "steps": STEPS, "dtype": dtype, "stage": stage,
            "pipe": pipe, "data": data}


WORLDS = {
    2: {"a_p2d1": case(2, 1), "b_p2d2": case(2, 2, in_process=True),
        "b_p2d2_bf16_s2": case(2, 2, "bf16", 2, in_process=True)},
    4: {"a_p4d1": case(4, 1), "a_p2d2": case(2, 2),
        "a_p2d2_bf16_s0": case(2, 2, "bf16", 0),
        "a_p2d2_bf16_s2": case(2, 2, "bf16", 2)},
}
WORLD_OF = {name: w for w, cases in WORLDS.items() for name in cases}


def jax_parts(pipe):
    module = jax_pipeline_module(GPT2Config(
        vocab_size=VOCAB, n_positions=SEQ, n_embd=32, n_layer=4, n_head=4,
        dropout=0.0, dtype=jnp.float32), seq_len=SEQ)
    return build_pipeline_parts(module, pipe, jax.random.PRNGKey(0),
                                module.example_input)


def first_batch(c):
    rng = np.random.default_rng(0)
    return rng.integers(0, VOCAB, (c["batch"], SEQ)).astype(np.int64)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn both worlds; the JAX references; the one-process runs."""
    root = tmp_path_factory.mktemp("pipe_dp")
    params = jax.tree_util.tree_map(np.asarray, jax_parts(2).params)
    state = convert_gpt2_pipe_params(params)
    state_path = root / "state.npz"
    np.savez(state_path, **{k: v.numpy() for k, v in state.items()})
    out = {}
    for world, cases in WORLDS.items():
        d = root / f"world{world}"
        H.spawn_world(world, cases, state_path, d, worker=WORKER)
        for name in cases:
            out[name] = H.load_results(d, name, world)
    jax_ref = {}
    for pipe, data in ((2, 1), (4, 1), (2, 2)):
        parts = jax_parts(pipe)
        mesh = build_mesh({"pipe": pipe, "data": data},
                          devices=jax.devices()[:pipe * data])
        vag = make_pipeline_value_and_grad_fn(parts, mesh, MICRO)
        batch = {"input_ids": first_batch(case(pipe, data))
                 .astype(np.int32)}
        loss, grads = jax.jit(lambda p, b: vag(p, b, None, 3.0))(
            parts.params, batch)
        jax_ref[(pipe, data)] = (float(loss), convert_gpt2_pipe_params(
            jax.tree_util.tree_map(np.asarray, grads)))
    # every stage in this process (world 1), at data 1
    local = {}
    for pipe in (2, 4):
        c = case(pipe, 1)
        cfg = gpt2_tiny(vocab_size=VOCAB, n_positions=SEQ, n_embd=32,
                        n_layer=4, n_head=4, dtype=torch.float32)
        engine, _, _, _ = initialize(
            model=gpt2_pipeline_module(cfg, seq_len=SEQ),
            config={"train_batch_size": c["batch"],
                    "gradient_accumulation_steps": MICRO,
                    "steps_per_print": 10 ** 9, "mesh": c["mesh"],
                    "optimizer": {"type": "Adam",
                                  "params": {"lr": 1e-2, "eps": 1e-3}}},
            model_parameters=state, device="cpu")
        rng = np.random.default_rng(0)
        xs = [rng.integers(0, VOCAB, (c["batch"], SEQ)).astype(np.int64)
              for _ in range(STEPS)]
        loss, grads = engine.value_and_grad(
            {"input_ids": torch.from_numpy(xs[0])}, 3.0)
        losses = [float(engine.train_batch({"input_ids": torch.from_numpy(
            x)})) for x in xs]
        local[pipe] = {"vag_loss": float(loss), "grads": grads,
                       "losses": losses, "masters": engine.pipe_state()}
    return out, jax_ref, local


def pipe_layout(rows, kind, pipe, data_rank=0):
    """The ranks' ``kind`` arrays (grad / master) of one data replica in
    the pipe layout."""
    named = {}
    for arrays, meta in rows:
        if meta["data_rank"] != data_rank:
            continue
        prefix = f"{kind}/"
        for key, a in arrays.items():
            if not key.startswith(prefix):
                continue
            s, name = key[len(prefix):].split("/", 1)
            if s == "pipe":
                return {n.split("/", 2)[2]: torch.from_numpy(v)
                        for n, v in arrays.items()
                        if n.startswith(f"{kind}/pipe/")}
            named.setdefault(int(s), {})[name] = torch.from_numpy(a)
    return pl.to_pipe_layout(named, pipe, 4 // pipe)


@pytest.mark.parametrize("name", ["a_p2d1", "a_p4d1", "a_p2d2", "b_p2d2"])
def test_loss_and_grads_equal_jax(run, name):
    out, jax_ref, _ = run
    c = WORLDS[WORLD_OF[name]][name]
    rows = out[name]
    want_loss, want = jax_ref[(c["pipe"], c["data"])]
    for _, meta in rows:
        np.testing.assert_allclose(meta["vag_loss"], want_loss, rtol=2e-5)
    for d in range(c["data"]):
        got = pipe_layout(rows, "grad", c["pipe"], d)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("pipe", [2, 4])
def test_process_transport_equals_in_process_bitwise(run, pipe):
    """One process a stage rank == every stage in one process, data 1."""
    out, _, local = run
    rows = out[f"a_p{pipe}d1"]
    ref = local[pipe]
    for _, meta in rows:
        assert meta["vag_loss"] == ref["vag_loss"]
        assert meta["losses"] == ref["losses"]
    for kind, want in (("grad", ref["grads"]), ("master", ref["masters"])):
        got = pipe_layout(rows, kind, pipe)
        for key, w in want.items():
            assert torch.equal(got[key], w), (kind, key)


def test_process_transport_equals_in_process_bitwise_data2(run):
    """pipe 2 x data 2: 4 processes (one a stage rank) == 2 processes
    (each a replica's two stages), gradients, losses and masters."""
    out, _, _ = run
    a, b = out["a_p2d2"], out["b_p2d2"]
    assert {m["losses"][0] for _, m in a} == {m["losses"][0] for _, m in b}
    for d in range(2):
        for kind in ("grad", "master"):
            got, want = pipe_layout(a, kind, 2, d), pipe_layout(b, kind, 2, d)
            for key, w in want.items():
                assert torch.equal(got[key], w), (kind, d, key)


def test_zero2_within_each_stage_data_group(run):
    """ZeRO stage 2 inside each stage's data group: the losses and masters
    of stage 0's run, bit for bit (sums of two addends), under both
    transports."""
    out, _, _ = run
    s0, s2, b2 = (out[n] for n in ("a_p2d2_bf16_s0", "a_p2d2_bf16_s2",
                                   "b_p2d2_bf16_s2"))
    assert [m["losses"] for _, m in s0] == [m["losses"] for _, m in s2]
    assert np.isfinite(s2[0][1]["losses"]).all()
    for d in range(2):
        want = pipe_layout(s0, "master", 2, d)
        for other in (s2, b2):
            got = pipe_layout(other, "master", 2, d)
            for key, w in want.items():
                assert torch.equal(got[key], w), (d, key)


@pytest.mark.parametrize("name", ["a_p2d1", "a_p4d1", "a_p2d2"])
def test_p2p_messages_and_tied_copies(run, name):
    """Stage s sends M activations (s < S-1, after one meta message) and
    M gradients (s > 0) a step; the tied copies on the first and last
    stage end equal, bit for bit."""
    out, _, _ = run
    c = WORLDS[WORLD_OF[name]][name]
    S, M = c["pipe"], MICRO
    total = 0
    for arrays, meta in out[name]:
        (s,) = meta["stages"]
        want = M * (s < S - 1) + M * (s > 0)
        assert meta["p2p"]["messages"] == want
        assert meta["p2p"]["meta_messages"] == int(s < S - 1)
        assert meta["p2p"]["bytes"] == want * (8 // M) * SEQ \
            * 32 * 4
        total += meta["p2p"]["messages"]
    assert total == 2 * (S - 1) * M * c["data"]
    for d in range(c["data"]):
        tied = {}
        for arrays, meta in out[name]:
            if meta["data_rank"] == d and meta["stages"][0] in (0, S - 1):
                tied[meta["stages"][0]] = {
                    k.split("/", 2)[2]: v for k, v in arrays.items()
                    if k.startswith("master/") and "/tied." in k}
        for key, v in tied[0].items():
            assert np.array_equal(v, tied[S - 1][key]), key
