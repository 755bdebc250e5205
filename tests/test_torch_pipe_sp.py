"""Sequence parallelism inside the pipeline (``parallel/pipe_sp.py``):
pipe 2 x seq 2 over gloo worlds of 2 and 4 processes, from JAX's
weights (``convert_tp_pipe_params``) and JAX's batch.

- pipe 2 x seq 2, every stage of a seq rank in one process (world 2),
  equals JAX's ``make_pipeline_value_and_grad_fn`` at pipe 2 x seq 2 and
  the port's seq 1 run (one process, here): loss rtol 1e-5, gradients
  rtol 3e-4 / atol 1e-6 (JAX ``tests/unit/test_pipe_sp.py``'s bounds),
  and two steps' losses and masters after them within the same bounds.
- One process a stage rank (``PipeMeshTopology``, world 4) equals the
  in-process layout bit for bit: the value-and-grad loss, the losses,
  the gradients and the masters.
- It trains through ``initialize()`` at pipe 2 x seq 2 x data 2 (world
  4): finite losses that fall over 6 steps.
- Hidden dropout hashes global token coordinates: each seq rank's
  multipliers are its slice of the seq-1 multipliers bit for bit, and a
  hidden-dropout-only run at seq 2 gives the seq-1 run's losses within
  JAX's rtol 3e-4.
- A scalar loss at seq 2 raises JAX's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.pipe_sp import sp_pipeline_module as jax_module
from deepspeed_tpu.runtime.pipe.pipeline import (
    build_pipeline_parts,
    make_pipeline_value_and_grad_fn,
)
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.parallel import pipe_sp
from deepspeed_tpu_torch.parallel.pipe_tp import convert_tp_pipe_params
from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
from tests import torch_zero_harness as H

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
VOCAB, D_MODEL, N_HEAD, SEQ, ROWS, MICRO = 32, 8, 2, 16, 8, 2
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 3e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_reference():
    """JAX's 1F1B value and gradients at pipe 2 x seq 2, its initial
    weights (the port's pipe layout) and its batch."""
    mesh = build_mesh({"pipe": 2, "seq": 2, "data": 1},
                      devices=jax.devices()[:4])
    module = jax_module(VOCAB, D_MODEL, N_HEAD, SEQ)
    rng = np.random.default_rng(0)
    micro = {"input_ids": rng.integers(0, VOCAB, (2, SEQ)).astype(
        np.int32)}
    parts = build_pipeline_parts(module, num_stages=2,
                                 rng=jax.random.PRNGKey(0),
                                 example_micro=micro)
    fn = jax.jit(make_pipeline_value_and_grad_fn(parts, mesh, MICRO))
    batch = {"input_ids": rng.integers(0, VOCAB, (ROWS, SEQ)).astype(
        np.int32)}
    loss, grads = fn(parts.params, batch, None, jnp.float32(1.0))
    params = convert_tp_pipe_params(jax.tree_util.tree_map(np.asarray,
                                                           parts.params))
    return float(loss), convert_tp_pipe_params(
        jax.tree_util.tree_map(np.asarray, grads)), params, batch


def case(name, mesh, **kw):
    return dict({"name": name, "kind": "pipe_sp", "mesh": mesh,
                 "vocab": VOCAB, "d_model": D_MODEL, "n_head": N_HEAD,
                 "seq": SEQ, "rows": ROWS, "micro": MICRO, "steps": 2,
                 "in_process_pipe": True},
                **kw)


def seq1_run(c, state):
    """The case at seq 1 in this process (pipe 2, every stage here)."""
    module = pipe_sp.sp_pipeline_module(
        VOCAB, D_MODEL, N_HEAD, SEQ, num_stages=2,
        dropout=c.get("dropout", 0.0), attn_dropout=c.get("attn_dropout"))
    engine, _, _, _ = initialize(
        model=module, device="cpu", model_parameters=state,
        config={"train_batch_size": ROWS,
                "gradient_accumulation_steps": MICRO,
                "steps_per_print": 10 ** 9, "mesh": {"pipe": 2},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    rng = np.random.default_rng(c.get("data_seed", 0))
    batches = [{"input_ids": rng.integers(0, VOCAB, (ROWS, SEQ))}
               for _ in range(c["steps"] + 1)]
    if c.get("batch0"):
        with np.load(c["batch0"]) as z:
            batches[0] = {k: z[k] for k in z.files}
    out = {}

    def t(b):
        return {k: torch.from_numpy(v.astype(np.int64)) for k, v in
                b.items()}
    if c.get("grads", True):
        loss, grads = engine.value_and_grad(t(batches[0]), 1.0)
        out["vag_loss"] = float(loss)
        out["grads"] = grads
    out["losses"] = [float(engine.train_batch(t(b))) for b in batches[1:]]
    out["masters"] = engine.pipe_state()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe_sp")
    loss, grads, params, batch = jax_reference()
    state, b0 = str(root / "state.npz"), str(root / "batch.npz")
    np.savez(state, **{k: v.numpy() for k, v in params.items()})
    np.savez(b0, **batch)
    base = dict(state=state, batch0=b0)
    sp2 = {"pipe": 2, "seq": 2}
    drop = dict(dropout=0.25, attn_dropout=0.0, steps=4, grads=False,
                data_seed=1, state=state)
    w2 = [case("sp2", sp2, hidden=True, scalar=True, **base),
          case("drop_s2", sp2, **drop)]
    w4 = [case("per_stage", sp2, in_process_pipe=False, **base),
          case("train", {"pipe": 2, "seq": 2, "data": 2}, steps=6,
               grads=False, data_seed=1)]
    H.spawn_world(2, w2, state, root / "w2", worker=WORKER)
    H.spawn_world(4, w4, state, root / "w4", worker=WORKER)
    torch_state = {k: torch.from_numpy(np.load(state)[k])
                   for k in params}
    s1 = seq1_run(case("s1", {}, **base), torch_state)
    d1 = seq1_run(case("d1", {}, **drop), torch_state)
    return root, {"jax": (loss, grads), "s1": s1, "d1": d1}


def res(root, world, name):
    return H.load_results(root / f"w{world}", name, world)


def test_seq2_matches_jax_1f1b(run):
    root, out = run
    loss, grads = out["jax"]
    for arrays, meta in res(root, 2, "sp2"):
        np.testing.assert_allclose(meta["vag_loss"], loss, rtol=LOSS_RTOL)
        assert sorted(k[5:] for k in arrays if k.startswith("grad/")) == \
            sorted(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(arrays[f"grad/{name}"], g.numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)


def test_seq2_equals_seq1(run):
    root, out = run
    s1 = out["s1"]
    for arrays, meta in res(root, 2, "sp2"):
        np.testing.assert_allclose(meta["vag_loss"], s1["vag_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(meta["losses"], s1["losses"],
                                   rtol=LOSS_RTOL)
        for name, g in s1["grads"].items():
            np.testing.assert_allclose(arrays[f"grad/{name}"], g.numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)
        for name, m in s1["masters"].items():
            np.testing.assert_allclose(arrays[f"master/{name}"], m.numpy(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=name)


def test_one_process_a_stage_rank_equals_in_process(run):
    root, _ = run
    want, want_meta = res(root, 2, "sp2")[0]
    named = {"grad": {}, "master": {}}
    for arrays, meta in res(root, 4, "per_stage"):
        assert meta["losses"] == want_meta["losses"]
        assert meta["vag_loss"] == want_meta["vag_loss"]
        for k, v in arrays.items():
            kind, stage, name = k.split("/", 2)
            named[kind].setdefault(int(stage), {})[name] = \
                torch.from_numpy(v)
    for kind in ("grad", "master"):
        layout = pl.to_pipe_layout(named[kind], 2, 1)
        assert sorted(layout) == sorted(
            k[len(kind) + 1:] for k in want if k.startswith(kind))
        for name, t in layout.items():
            assert np.array_equal(t.numpy(), want[f"{kind}/{name}"]), \
                (kind, name)


def test_trains_through_initialize_at_pipe_seq_data(run):
    root, _ = run
    rows = res(root, 4, "train")
    losses = rows[0][1]["losses"]
    assert all(m["losses"] == losses for _, m in rows)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_hidden_dropout_invariant_to_the_seq_split(run):
    root, out = run
    block = pipe_sp.SPBlockLayer(D_MODEL, N_HEAD, dropout=0.25)
    full = block._hidden_drop(torch.ones(2, SEQ, D_MODEL), 77, 1).numpy()
    t = SEQ // 2
    for r, (arrays, _) in enumerate(res(root, 2, "sp2")):
        assert np.array_equal(arrays["hidden"],
                              full[:, r * t:(r + 1) * t])
    assert 0 < (full == 0).mean() < 0.5
    for _, meta in res(root, 2, "drop_s2"):
        np.testing.assert_allclose(meta["losses"], out["d1"]["losses"],
                                   rtol=3e-4)
    assert meta["losses"] != out["s1"]["losses"]


def test_scalar_loss_at_seq2_raises(run):
    root, _ = run
    for _, meta in res(root, 2, "sp2"):
        assert meta["scalar_error"] == pl.SCALAR_LOSS_AT_SEQ
    assert pl.SCALAR_LOSS_AT_SEQ.startswith(
        "pipeline on a mesh with seq > 1 requires the weighted")
