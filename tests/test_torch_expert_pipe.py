"""Expert parallelism inside the pipeline (``moe/expert_pipe.py``,
``parallel/pipe_tp_moe.py``) over gloo worlds of 2 and 4 processes:
JAX's ``tests/unit/test_expert_pipe.py`` and ``test_pipe_tp_moe.py``
modules (embed -> 2 MoE body layers -> head, the mean token
cross-entropy plus the Switch aux carried as ``(hidden, aux)`` tuple
activations; 4 experts, top 2, capacity factor 2.0).

- pipe 2 x expert 2 x data 2 equals pipe 2 x data 2 (expert 1): the
  loss rtol 1e-5 and every gradient rtol 2e-4 / atol 1e-6 (JAX's
  bounds), the gate's included (its aux part is exact only with the
  aux's 1/ep pre-scaling), and 2 steps' losses.
- One process a stage rank (``PipeMeshTopology``) equals every stage
  of an expert rank in one process, bit for bit.
- TP x expert blocks at pipe 2 x model 2 x expert 2 equal the same
  module fully replicated (pipe 2, one process, here), and JAX's
  ``make_pipeline_value_and_grad_fn`` of JAX's module at its weights:
  loss rtol 1e-5, gradients rtol 3e-4 / atol 1e-6 (JAX's bounds). The
  ``expert_combine`` overlap site at chunks 2 stays within those bounds
  of the plan off and runs its rings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.pipe.pipeline import (
    build_pipeline_parts,
    make_pipeline_value_and_grad_fn,
)
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.parallel.pipe_tp import convert_tp_pipe_params
from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
from tests import torch_sp_moe_cases as cases
from tests import torch_zero_harness as H
from tests.unit.test_pipe_tp_moe import _module as jax_tp_moe_module

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
D_MODEL, SEQ, ROWS, MICRO = 8, 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_reference():
    """JAX's TP x expert module (aux carried) at pipe 2, replicated: the
    value and gradients, its weights and its batch."""
    mesh = build_mesh({"pipe": 2, "model": 1, "expert": 1},
                      devices=jax.devices()[:2])
    module = jax_tp_moe_module(use_aux=True)
    rng = np.random.default_rng(0)
    micro = {"ids": rng.integers(0, 32, (2, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 32, (2, SEQ)).astype(np.int32)}
    parts = build_pipeline_parts(module, num_stages=2,
                                 rng=jax.random.PRNGKey(0),
                                 example_micro=micro)
    fn = jax.jit(make_pipeline_value_and_grad_fn(parts, mesh, MICRO))
    batch = {"ids": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32)}
    loss, grads = fn(parts.params, batch, None, jnp.float32(1.0))
    params = convert_tp_pipe_params(jax.tree_util.tree_map(np.asarray,
                                                           parts.params))
    return float(loss), convert_tp_pipe_params(
        jax.tree_util.tree_map(np.asarray, grads)), params, batch


def case(name, mesh, **kw):
    return dict({"name": name, "kind": "expert_pipe", "mesh": mesh,
                 "d_model": D_MODEL, "vocab": 32, "seq": SEQ, "rows": ROWS,
                 "micro": MICRO, "steps": 2, "aux": True,
                 "in_process_pipe": True}, **kw)


def replicated_run(c, state):
    """The TP x expert case at pipe 2 in this process (no model or
    expert axis): value and gradients of the first batch."""
    engine, _, _, _ = initialize(
        model=cases.expert_pipe_module(c), device="cpu",
        model_parameters=state,
        config={"train_batch_size": ROWS,
                "gradient_accumulation_steps": MICRO,
                "steps_per_print": 10 ** 9, "mesh": {"pipe": 2},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    with np.load(c["batch0"]) as z:
        b = {k: torch.from_numpy(z[k].astype(np.int64)) for k in z.files}
    loss, grads = engine.value_and_grad(b, 1.0)
    return float(loss), grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("expert_pipe")
    loss, grads, params, batch = jax_reference()
    state, b0 = str(root / "state.npz"), str(root / "batch.npz")
    np.savez(state, **{k: v.numpy() for k, v in params.items()})
    np.savez(b0, **batch)
    tp = dict(tp=True, state=state, batch0=b0)
    w2 = [case("e1d2", {"pipe": 2, "data": 2}),
          case("in_process", {"pipe": 2, "expert": 2})]
    w4 = [case("e2d2", {"pipe": 2, "expert": 2, "data": 2}),
          case("per_stage", {"pipe": 2, "expert": 2},
               in_process_pipe=False),
          case("tp_moe", {"pipe": 2, "model": 2, "expert": 2}, **tp),
          case("tp_moe_ov", {"pipe": 2, "model": 2, "expert": 2},
               overlap={"enabled": True, "chunks": 2}, **tp)]
    H.spawn_world(2, w2, state, root / "w2", worker=WORKER)
    H.spawn_world(4, w4, state, root / "w4", worker=WORKER)
    torch_state = {k: torch.from_numpy(np.load(state)[k]) for k in params}
    rep = replicated_run(case("rep", {}, **tp), torch_state)
    return root, {"jax": (loss, grads), "rep": rep}


def res(root, world, name):
    return H.load_results(root / f"w{world}", name, world)


def test_expert_sharded_pipeline_equals_replicated(run):
    root, _ = run
    want, want_meta = res(root, 2, "e1d2")[0]
    for arrays, meta in res(root, 4, "e2d2"):
        np.testing.assert_allclose(meta["vag_loss"], want_meta["vag_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(meta["losses"], want_meta["losses"],
                                   rtol=1e-5)
        grads = [k for k in want if k.startswith("grad/")]
        assert "grad/body.gate" in grads and \
            "grad/body.expert_w1" in grads
        for k in grads:
            np.testing.assert_allclose(arrays[k], want[k], rtol=2e-4,
                                       atol=1e-6, err_msg=k)


def test_one_process_a_stage_rank_equals_in_process(run):
    root, _ = run
    want, want_meta = res(root, 2, "in_process")[0]
    named = {"grad": {}, "master": {}}
    for arrays, meta in res(root, 4, "per_stage"):
        assert meta["losses"] == want_meta["losses"]
        assert meta["vag_loss"] == want_meta["vag_loss"]
        for k, v in arrays.items():
            kind, stage, name = k.split("/", 2)
            named[kind].setdefault(int(stage), {})[name] = \
                torch.from_numpy(v)
    for kind in ("grad", "master"):
        for name, t in pl.to_pipe_layout(named[kind], 2, 1).items():
            assert np.array_equal(t.numpy(), want[f"{kind}/{name}"]), \
                (kind, name)


@pytest.mark.parametrize("ref", ["jax", "replicated"])
def test_tp_expert_blocks_equal_replicated(run, ref):
    root, out = run
    loss, grads = out["jax"] if ref == "jax" else out["rep"]
    for arrays, meta in res(root, 4, "tp_moe"):
        np.testing.assert_allclose(meta["vag_loss"], loss, rtol=1e-5)
        for name, g in grads.items():
            np.testing.assert_allclose(arrays[f"grad/{name}"], g.numpy(),
                                       rtol=3e-4, atol=1e-6, err_msg=name)


def test_expert_combine_overlap_matches_plan_off(run):
    root, _ = run
    for (a, ma), (b, mb) in zip(res(root, 4, "tp_moe_ov"),
                                res(root, 4, "tp_moe")):
        np.testing.assert_allclose(ma["vag_loss"], mb["vag_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ma["losses"], mb["losses"], rtol=1e-5)
        for k, v in b.items():
            np.testing.assert_allclose(a[k], v, rtol=3e-4, atol=1e-6,
                                       err_msg=k)
        assert ma["counts"]["ppermute"]["calls"] > 0
        assert "ppermute" not in mb["counts"]
