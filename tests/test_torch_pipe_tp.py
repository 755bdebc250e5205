"""Tensor parallelism inside the pipeline (``parallel/pipe_tp.py``):
pipe 2 x model 2 x data 2 in a gloo world of 4 processes (every stage of
a (data, model) coordinate in one process; also one process a stage
rank at data 1), held to JAX's
``tests/unit/test_pipe_tp.py``: the 1F1B ``make_pipeline_value_and_grad_fn``
of JAX's ``tiny_tp_pipeline_module`` (``tests/pipeline_fixtures.py``)
at the same mesh, loss rtol 1e-5 and gradients rtol 3e-4 / atol 1e-6
(JAX's own bounds), for the GPT-2 style and the BERT style block. The
weights are JAX's (``convert_tp_pipe_params``).

The ``tensor_parallel.overlap`` plan (JAX ``test_collective_matmul.py``'s
grid through the engine): chunks 1 is the plan-off run bit for bit;
chunks 2 and 4 (each way round the ring) reassociate the row-parallel
sums and the column-parallel gradient sums, and stay within rtol 1e-5 of
the plan-off loss and rtol 3e-4 / atol 1e-6 of its gradients.

Dropout invariance (JAX ``test_tp_pipeline_flash_dropout_invariant_to_
sharding``): with dropout 0.25 and flash attention, 3 steps at model 2
give the model 1 run's losses within JAX's rtol 3e-4, and differ from the
dropout-free run.

fp8 (JAX has no fp8 pipeline test; this runs JAX's ``PipelineEngine``
with ``fp8`` on at pipe 2 x model 2 directly): 3 steps of the same
batch from JAX's initial weights give JAX's losses within rtol 1e-4 (the
current scaling's qdq and its gradient are JAX's op for op; the
products sum in other orders, and a qdq that rounds differently moves
a loss by about one fp8 step of one element). With the fp8 wire (int8)
composed into an overlap plan at chunks 2 the losses stay within rtol
1e-2 of the plan-off fp8 run (every ring exchange quantized).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.pipe_tp import TPBertBlockLayer, TPBlockLayer
from deepspeed_tpu.runtime.pipe.pipeline import (
    build_pipeline_parts,
    make_pipeline_value_and_grad_fn,
)
from deepspeed_tpu_torch.parallel.pipe_tp import convert_tp_pipe_params
from tests import torch_zero_harness as H
from tests.pipeline_fixtures import tiny_tp_pipeline_module

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
D_MODEL, N_HEAD, SEQ, ROWS, MICRO = 8, 4, 8, 16, 4
MESH = {"pipe": 2, "model": 2, "data": 2}
OVERLAPS = [(1, False), (2, True), (4, True)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This process's torch work on one intra-op thread (the tiny shapes
    gain nothing from more, and the gloo workers and the other test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_reference(block_cls):
    mesh = build_mesh(MESH, devices=jax.devices()[:8])
    module = tiny_tp_pipeline_module(vocab=32, d_model=D_MODEL,
                                     n_head=N_HEAD, seq=SEQ, ids_key="ids",
                                     labels_key="labels",
                                     block_cls=block_cls)
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


def case(name, block="gpt", **kw):
    return dict({"name": name, "kind": "pipe_tp", "mesh": MESH,
                 "in_process_pipe": True, "rows": ROWS, "micro": MICRO,
                 "block": block, "steps": 0}, **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two spawns: world 4 (pipe 2 x model 2 x data 2 in process, and
    pipe 2 x model 2 one process a stage rank) and world 2 (model 1
    dropout runs, fp8, and the in-process side of the per-stage
    comparison)."""
    root = tmp_path_factory.mktemp("pipe_tp")
    out, w4, w2 = {}, [], []
    for block, cls in (("gpt", TPBlockLayer), ("bert", TPBertBlockLayer)):
        loss, grads, params, batch = jax_reference(cls)
        state, b0 = str(root / f"{block}.npz"), str(root / f"{block}_b.npz")
        np.savez(state, **{k: v.numpy() for k, v in params.items()})
        np.savez(b0, **batch)
        w4.append(case(f"off_{block}", block, batch0=b0, state=state))
        if block == "gpt":
            w4 += [case(f"ov{c}{int(b)}", block, batch0=b0, state=state,
                        overlap={"enabled": True, "chunks": c,
                                 "bidirectional": b})
                   for c, b in OVERLAPS]
            per = dict(batch0=b0, state=state, steps=2,
                       mesh={"pipe": 2, "model": 2})
            ov = {"enabled": True, "chunks": 2}
            w4.append(case("per_stage", **per, in_process_pipe=False,
                           overlap=ov))
            w2.append(case("in_process", **per, overlap=ov))
        out[block] = (loss, grads)
    drop = dict(block_kw={"use_flash": True, "dropout": 0.25}, steps=3,
                grads=False, load=False, data_seed=1)
    mesh1 = {"pipe": 2, "model": 1, "data": 2}
    w4.append(case("drop_m2", **drop))
    w2 += [case("drop_m1", **dict(drop, mesh=mesh1)),
           case("det_m1", **dict(drop, mesh=mesh1,
                                  block_kw={"use_flash": True}))]
    jax_losses, params, batch = jax_fp8_engine()
    np.savez(root / "fp8.npz", **{k: v.numpy() for k, v in params.items()})
    np.savez(root / "fp8_batch.npz", **batch)
    fp8 = dict(block_kw={}, steps=3, grads=False,
               batch_all=str(root / "fp8_batch.npz"),
               mesh={"pipe": 2, "model": 2}, fp8={"enabled": True},
               state=str(root / "fp8.npz"))
    w2 += [case("fp8", **fp8),
           case("fp8_wire", **dict(fp8, fp8={
               "enabled": True, "wire": {"enabled": True, "dtype": "int8"}},
               overlap={"enabled": True, "chunks": 2}))]
    out["fp8"] = jax_losses
    H.spawn_world(4, w4, root / "gpt.npz", root / "w4", worker=WORKER)
    H.spawn_world(2, w2, root / "gpt.npz", root / "w2", worker=WORKER)
    return root, out


def res(root, world, name):
    return H.load_results(root / f"w{world}", name, world)


def jax_fp8_engine():
    """JAX's PipelineEngine with fp8 at pipe 2 x model 2 x data 1: its
    initial weights, the batch and 3 losses on it."""
    import deepspeed_tpu
    mesh = build_mesh({"pipe": 2, "model": 2, "data": 1},
                      devices=jax.devices()[:4])
    module = tiny_tp_pipeline_module(vocab=32, d_model=D_MODEL,
                                     n_head=N_HEAD, seq=SEQ, ids_key="ids",
                                     labels_key="labels")
    engine, _, _, _ = deepspeed_tpu.initialize(
        config={"train_batch_size": ROWS,
                "gradient_accumulation_steps": MICRO,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
                "steps_per_print": 1000, "fp8": {"enabled": True}},
        model=module, mesh=mesh)
    params = convert_tp_pipe_params(jax.tree_util.tree_map(
        np.asarray, engine.params))
    rng = np.random.default_rng(1)
    batch = {"ids": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32)}
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    return losses, params, batch


def test_fp8_tp_pipeline_matches_jax_engine(run):
    root, out = run
    for _, meta in res(root, 2, "fp8"):
        np.testing.assert_allclose(meta["losses"], out["fp8"], rtol=1e-4)


def test_fp8_wire_in_the_overlap_plan(run):
    root, _ = run
    plain = res(root, 2, "fp8")
    for (_, mw), (_, mp) in zip(res(root, 2, "fp8_wire"), plain):
        np.testing.assert_allclose(mw["losses"], mp["losses"], rtol=1e-2)
        assert mw["losses"] != mp["losses"]       # the wire is lossy
        assert mw["counts"]["ppermute"]["calls"] > 0


@pytest.mark.parametrize("block", ["gpt", "bert"])
def test_tp_pipeline_matches_jax_1f1b(run, block):
    root, out = run
    loss, grads = out[block]
    for arrays, meta in res(root, 4, f"off_{block}"):
        np.testing.assert_allclose(meta["vag_loss"], loss, rtol=1e-5)
        for name, g in grads.items():
            np.testing.assert_allclose(arrays[f"grad/{name}"], g.numpy(),
                                       rtol=3e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("chunks,bidir", OVERLAPS)
def test_overlap_plan_matches_plan_off(run, chunks, bidir):
    root, _ = run
    off = res(root, 4, "off_gpt")
    got = res(root, 4, f"ov{chunks}{int(bidir)}")
    for (a, ma), (b, mb) in zip(got, off):
        if chunks == 1:
            assert ma["vag_loss"] == mb["vag_loss"]
            for key, v in b.items():
                assert np.array_equal(a[key], v), key
            continue
        np.testing.assert_allclose(ma["vag_loss"], mb["vag_loss"],
                                   rtol=1e-5)
        for key, v in b.items():
            np.testing.assert_allclose(a[key], v, rtol=3e-4, atol=1e-6,
                                       err_msg=key)
        # the chunked rings ran: ppermutes, in every chunk
        assert ma["counts"]["ppermute"]["calls"] > 0


def test_flash_dropout_invariant_to_sharding(run):
    root, _ = run
    m1 = res(root, 2, "drop_m1")[0][1]["losses"]
    det = res(root, 2, "det_m1")[0][1]["losses"]
    for _, meta in res(root, 4, "drop_m2"):
        np.testing.assert_allclose(meta["losses"], m1, rtol=3e-4)
    assert max(abs(a - b) for a, b in zip(m1, det)) > 1e-4


def test_one_process_a_stage_rank_equals_in_process(run):
    """pipe 2 x model 2 with one process a stage rank (the
    reference's 3-D layout, ``PipeModelDataParallelTopology``; stages
    talk through ``ProcessTransport``; 4 processes; the overlap plan at
    chunks 2) equals the layout with every stage of a model rank in one
    process: the value-and-grad
    loss, 2 steps' losses, the whole gradients and masters, bit for
    bit."""
    from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
    import torch
    root, _ = run
    per = res(root, 4, "per_stage")
    want, want_meta = res(root, 2, "in_process")[0]
    named = {"grad": {}, "master": {}}
    for arrays, meta in per:
        assert meta["losses"] == want_meta["losses"]
        assert meta["vag_loss"] == want_meta["vag_loss"]
        for key, v in arrays.items():
            kind, stage, name = key.split("/", 2)
            named[kind].setdefault(int(stage), {})[name] = \
                torch.from_numpy(v)
    assert sorted(named["master"]) == [0, 1]
    for kind in ("grad", "master"):
        layout = pl.to_pipe_layout(named[kind], 2, 1)
        for name, t in layout.items():
            assert np.array_equal(t.numpy(), want[f"{kind}/{name}"]), \
                (kind, name)
