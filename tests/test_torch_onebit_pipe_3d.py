"""The pipeline under 1-bit Adam at pipe 2 x model 2 x data 2 (JAX
``tests/unit/test_onebit_pipeline.py``'s 3D setup:
``tests/pipeline_fixtures.py:tiny_tp_pipeline_module``, vocab 32, d_model
8, 4 heads, 16 rows of 16 tokens, 4 micro-batches): one gloo world of 4
``tests/torch_tp_worker.py`` processes, every stage of a (data, model)
coordinate in one process over ``MeshGroups``, from the JAX engine's
initial weights (``convert_tp_pipe_params``) and on its batch, held to
JAX's ``PipelineEngine`` on the same mesh (lr 5e-4 and ``freeze_step`` 4:
JAX's own test notes the toy's per-leaf gradient scales make the
compressed stage unstable sooner).

- The warmup (steps 1-4) is Adam without bias correction on the dense
  mean: within JAX's rtol 2e-4 of JAX's losses.
- After the freeze (steps 5-6) the buffers are JAX's three (the
  model-sharded ``mp_*`` body leaves, the model-replicated body leaves,
  the rest): the toy has no tied layer, so its prologue (the embedding)
  and epilogue (the head) are the rest, each on its own stage (JAX
  compresses both in one buffer on every stage device). The step-6 loss
  (one compressed update) is held to JAX's within half of what the 1-bit
  compression moves JAX's loss from its Adam run without bias correction
  (the rest's scale and the body's server chunks differ, as in
  ``test_torch_onebit_pipe.py``; measured: 0.12 of it).
- The local gradients at step 1 equal JAX's data-local ones, and one
  compressed step (step 6) equals the 1-bit arithmetic applied here to
  JAX's three body buffers' order (``mp_*`` rows of the model rank, then
  the model-replicated body leaves) and the stage's rest, bit for bit
  (``test_torch_onebit_pipe.py``'s checks).
- Every model-replicated leaf bit for bit equal on the two model ranks
  of a data rank after the compressed steps; the same run with the
  replicated body leaves planted in the sharded leaves' buffer breaks
  that equality (so the gate reads).
"""

import jax.numpy as jnp  # noqa: F401  (the JAX engine's dtype default)
import numpy as np
import pytest

from deepspeed_tpu.parallel.pipe_tp import TPBlockLayer
from deepspeed_tpu_torch.parallel.pipe_tp import convert_tp_pipe_params
from tests import torch_zero_harness as H
from tests.pipeline_fixtures import tiny_tp_pipeline_module
from tests.test_torch_onebit_pipe import (
    MICRO,
    ROWS,
    SEQ,
    check_compressed_step,
    check_local_grads,
    jax_engine,
    jax_train,
    within_compression_noise,
)

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
STEPS = 6
MESH = {"pipe": 2, "model": 2, "data": 2}
ONEBIT = {"type": "OneBitAdam", "params": {"lr": 5e-4, "freeze_step": 4}}


def case(name, root, **kw):
    return dict({"name": name, "kind": "pipe_onebit", "mesh": MESH,
                 "in_process_pipe": True, "three_d": True, "rows": ROWS,
                 "micro": MICRO, "seq": SEQ, "opt": ONEBIT, "steps": STEPS,
                 "state": str(root / "state.npz"),
                 "batch": str(root / "batch.npz")}, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("onebit_pipe_3d")
    rng = np.random.default_rng(0)
    batch = {"ids": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32)}
    module = tiny_tp_pipeline_module(vocab=32, d_model=8, n_head=4,
                                     seq=SEQ, ids_key="ids",
                                     labels_key="labels",
                                     block_cls=TPBlockLayer)
    engine, params = jax_engine(module, MESH, ONEBIT)
    state = convert_tp_pipe_params(params)
    np.savez(root / "state.npz", **{k: v.numpy() for k, v in state.items()})
    np.savez(root / "batch.npz", **batch)
    cases = [case("ob", root, capture=[1, STEPS]),
             case("fault", root, steps=2, fault="rep_with_mp", opt=dict(
                 ONEBIT, params={"lr": 5e-4, "freeze_step": 0}))]
    # the port's world runs while the JAX engines do
    procs = H.start_world(4, cases, root / "state.npz", root / "w",
                          worker=WORKER)
    try:
        losses, grads = jax_train(engine, STEPS, batch, local=True)
        dense = jax_train(jax_engine(module, MESH, {
            "type": "Adam", "params": {"lr": 5e-4,
                                       "bias_correction": False}})[0],
            STEPS, batch)[0]
    except BaseException:
        H.stop_world(procs)
        raise
    H.wait_world(procs)
    return root, (losses, dense), params, grads


def res(root, name):
    return H.load_results(root / "w", name, 4)


def replicated_equal(ranks):
    """Every leaf not split over the model axis, bit for bit equal on
    the model ranks of each data rank."""
    by_data = {}
    for arrays, meta in ranks:
        by_data.setdefault(meta["data_rank"], []).append(arrays)
    for rows in by_data.values():
        assert len(rows) == 2
        for key, v in rows[0].items():
            if key.startswith("master/") and \
                    not key.split(".")[-1].startswith("mp_") \
                    and not np.array_equal(v, rows[1][key]):
                return False
    return True


def test_3d_local_gradients_are_jax(world):
    root, _, _, grads = world
    check_local_grads(res(root, "ob"), grads, convert_tp_pipe_params, 1,
                      model=2)


def test_3d_compressed_step_equals_the_reference(world):
    root, _, params, _ = world
    assert check_compressed_step(res(root, "ob"), params,
                                 convert_tp_pipe_params, STEPS,
                                 ONEBIT["params"]["lr"], model=2) == 8


def test_3d_warmup_and_compressed_stage_match_jax(world):
    root, (want, dense), _, _ = world
    assert np.isfinite(want).all() and want[-1] < want[0]
    ranks = res(root, "ob")
    for _, meta in ranks:
        losses = meta["losses"]
        np.testing.assert_allclose(losses[:5], want[:5], rtol=2e-4)
        within_compression_noise(losses, want, dense, 5)
        assert losses[-1] < losses[0]
        assert meta["step/0"] == meta["step/1"] == STEPS
        assert meta["error_abs/0"] > 0 and meta["error_abs/1"] > 0
        assert [k for k, _ in meta["groups/0"]] == \
            ["body_mp", "body_rep", "rest"]
    assert replicated_equal(ranks)


def test_3d_planted_fault_breaks_replicated_equality(world):
    root = world[0]
    ranks = res(root, "fault")
    assert [k for k, _ in ranks[0][1]["groups/0"]] == ["body_mp", "rest"]
    assert not replicated_equal(ranks)
