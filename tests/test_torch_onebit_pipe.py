"""The pipeline under 1-bit Adam at pipe 2 x data 2 (JAX
``tests/unit/test_onebit_pipeline.py``'s setup: ``gpt2_tiny``, dropout
0, 16 rows of 16 tokens, 4 micro-batches): one gloo world of 2
``tests/torch_tp_worker.py`` processes, every stage of a data replica in
one process, from the JAX engine's initial weights
(``convert_gpt2_pipe_params``) and on its batch (each replica the rows
JAX's data shard holds), held to JAX's ``PipelineEngine`` on the same
mesh.

- The local gradients (step 1's input to the stage updates, after the
  tied sum and the scaling that makes their mean over the data group the
  gradient) equal JAX's ``direct_value_and_grad_local`` at the same
  weights: rtol 1e-4 of each leaf's largest entry (f32 sums of 4
  micro-batches in another order; a wrong scaling is off by 2x).
- One compressed step (step 4: error buffers in and out) equals, bit for
  bit, the 1-bit arithmetic of ``runtime/comm/compressed.py``
  (``compressed_worker`` / ``_server`` / ``_decode``) applied in this
  file to each buffer of the stage, both data ranks' inputs exchanged
  in-process: the body flat in JAX's order (the positions
  ``ravel_pytree`` gives each element of JAX's stacked leaves, read
  through ``convert_gpt2_pipe_params``), then the stage's prologue or
  epilogue, then the tied leaves, each padded by
  ``error_feedback_sizes`` and cut from the error buffers in that order.
  This holds the buffer split, the error slices and the moments' update
  exactly; the gradients' scaling is held by the check above.
- The warmup (steps 1-2 at ``freeze_step`` 2) is Adam without bias
  correction on the dense mean: within JAX's own rtol 2e-4 of JAX's
  losses, and of the port's Adam run without bias correction.
- After the freeze the body compresses as JAX's does; JAX's "rest"
  buffer holds the prologue, epilogue and tied leaves, which each of its
  stage devices holds whole, while a port stage holds only its own
  prologue or epilogue, so the tied leaves (held by both end stages)
  compress in a buffer of their own (``pipeline_onebit_groups``) and the
  rest's 1-bit scale differs. As a second check, each compressed step's
  loss is within half of what the 1-bit compression itself moves JAX's
  loss (JAX's 1-bit run against its Adam run without bias correction).
- JAX's own checks on the port: finite losses, below the first; the
  step counter; nonzero error buffers; the tied copies bit for bit equal
  on the first and the last stage after every compressed step; a client
  ``OnebitAdam`` object; and the same run with the tied leaves planted
  in the body's buffer breaks that equality (so the gate reads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu.models.gpt2_pipe import (
    gpt2_pipeline_module as jax_pipeline_module)
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.pipe.pipeline import _is_mp_leaf
from deepspeed_tpu_torch.models.gpt2_pipe import convert_gpt2_pipe_params
from deepspeed_tpu_torch.runtime.comm import compressed as pc
from tests import torch_zero_harness as H

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
ROWS, SEQ, MICRO, STEPS = 16, 16, 4, 6
MESH = {"pipe": 2, "data": 2}
ONEBIT = {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 2}}
NOBIAS = {"type": "Adam", "params": {"lr": 1e-3, "bias_correction": False}}


def jax_engine(module, mesh_shape, opt):
    """JAX's PipelineEngine on ``mesh_shape`` and its initial params
    (numpy)."""
    n = int(np.prod(list(mesh_shape.values())))
    engine, _, _, _ = deepspeed_tpu.initialize(
        config={"train_batch_size": ROWS,
                "gradient_accumulation_steps": MICRO, "optimizer": opt,
                "steps_per_print": 10 ** 9},
        model=module, mesh=build_mesh(mesh_shape, devices=jax.devices()[:n]))
    return engine, jax.tree_util.tree_map(np.asarray, engine.params)


def jax_train(engine, steps, batch, local=False):
    """``steps`` losses of ``engine`` on ``batch`` and, with ``local``,
    its data-local gradients before them (the 1-bit step's input:
    ``direct_value_and_grad_local`` at loss scale 1, a leading data
    axis), numpy."""
    grads = None
    if local:
        micro = jax.tree_util.tree_map(lambda x: x[0],
                                       engine._shard_batch(batch))
        local_fn = jax.jit(engine.loss_fn.direct_value_and_grad_local)
        grads = jax.tree_util.tree_map(np.asarray, local_fn(
            engine.params, micro, jax.random.PRNGKey(0),
            jnp.float32(1.0))[1])
    losses = [float(engine.train_batch(batch)) for _ in range(steps)]
    return np.array(losses), grads


def stage_view(tree, convert, names, stage, model_rank=0, model=1):
    """A JAX pipeline tree as one port stage's leaves by name (through
    ``convert``), at ``model_rank``: an ``mp_*`` body leaf keeps that
    rank's rows."""
    conv = convert(tree)
    out = {}
    for n in names:
        if n.startswith("body."):
            _, layer, leaf = n.split(".", 2)
            a = np.asarray(conv[f"body.{leaf}"])[stage, int(layer)]
            if model > 1 and leaf.startswith("mp_"):
                a = np.split(a, model)[model_rank]
        else:
            a = np.asarray(conv[n])
        out[n] = a
    return out


def jax_body_positions(params, stage, model_rank=0, model=1):
    """``params`` with each body leaf replaced by the positions JAX's
    1-bit step gives the elements of one (stage, model rank) device in
    its flat body buffers (``ravel_pytree`` of the local leaves in
    ``tree_leaves`` order; at ``model > 1`` the ``mp_*`` leaves and the
    others in two buffers), -1 elsewhere."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params["body"])
    off, leaves = {}, []
    for path, leaf in flat:
        kind = ("mp" if _is_mp_leaf(path, leaf) else "rep") \
            if model > 1 else "body"
        pos = np.full(leaf.shape, -1.0, np.float32)
        local = pos[stage]
        if kind == "mp":
            rows = leaf.shape[2] // model
            local = local[:, model_rank * rows:(model_rank + 1) * rows]
        start = off.get(kind, 0)
        local[...] = np.arange(start, start + local.size).reshape(
            local.shape)
        off[kind] = start + local.size
        leaves.append(pos)
    return dict(params, body=jax.tree_util.tree_unflatten(treedef, leaves))


def reference_buffers(names, shapes, positions, model=1):
    """One stage's buffers as ``[(kind, indices into the stage's flat
    params)]``: the body in JAX's order (``positions``, by name), then
    the stage's prologue or epilogue, then the tied leaves, in the
    stage's parameter order."""
    offs = np.cumsum([0] + [int(np.prod(s)) for s in shapes])
    body, rest, tied = {}, [], []
    for i, n in enumerate(names):
        span = np.arange(offs[i], offs[i + 1])
        if n.startswith("body."):
            leaf = n.split(".", 2)[2]
            kind = ("body_mp" if leaf.startswith("mp_") else "body_rep") \
                if model > 1 else "body"
            body.setdefault(kind, []).append(
                (positions[n].reshape(-1).astype(np.int64), span))
        else:
            (tied if n.startswith("tied.") else rest).append(span)
    out = []
    for kind in ("body", "body_mp", "body_rep"):
        if kind in body:
            idx = np.full(sum(len(s) for _, s in body[kind]), -1)
            for pos, span in body[kind]:
                idx[pos] = span
            assert (idx >= 0).all()
            out.append((kind, idx))
    out += [(k, np.concatenate(v)) for k, v in (("rest", rest),
                                                 ("tied", tied)) if v]
    return out


def onebit_reference(caps, buffers, lr, eps=1e-8, beta1=0.9):
    """One compressed 1-bit Adam step of a stage over its data ranks'
    captured inputs (``caps[d]``: flat ``p``, ``g``, ``m``, ``v``, ``we``,
    ``se``), each buffer through ``compressed_worker`` on every rank, the
    served chunks exchanged here, ``compressed_server``,
    ``compressed_decode``, then ``p - lr m / (sqrt(v) + eps)``. Returns
    each rank's ``p_new``, ``m_new``, ``we_new``, ``se_new``."""
    world = len(caps)
    c_b1 = float(np.float32(beta1))
    c_1mb1 = float(np.float32(1.0) - np.float32(beta1))
    t = torch.from_numpy
    outs = [{"p_new": c["p"].copy(), "m_new": c["m"].copy(), "we_new": [],
             "se_new": []} for c in caps]
    w_off = c_off = 0
    for _, idx in buffers:
        n = len(idx)
        padded, chunk = pc.error_feedback_sizes(n, world)
        packed, scales = [], []
        for c, o in zip(caps, outs):
            x = torch.zeros(padded)
            x[:n] = c_b1 * t(c["m"][idx]) + c_1mb1 * t(c["g"][idx])
            pk, sc, we = pc.compressed_worker(
                x, t(c["we"][w_off:w_off + padded]), world, n)
            packed.append(pk)
            scales.append(sc)
            o["we_new"].append(we.numpy())
        served = []
        for r, (c, o) in enumerate(zip(caps, outs)):
            sp, ss, se = pc.compressed_server(
                torch.stack([pk[r] for pk in packed]), torch.stack(scales),
                t(c["se"][c_off:c_off + chunk]), r, n)
            served.append((sp, ss))
            o["se_new"].append(se.numpy())
        avg = pc.compressed_decode(torch.stack([s for s, _ in served]),
                                   torch.stack([s for _, s in served]),
                                   n)[:n]
        for c, o in zip(caps, outs):
            update = avg / (torch.sqrt(t(c["v"][idx]))
                            + float(np.float32(eps)))
            o["p_new"][idx] = (t(c["p"][idx])
                               - float(np.float32(lr)) * update).numpy()
            o["m_new"][idx] = avg.numpy()
        w_off, c_off = w_off + padded, c_off + chunk
    for o in outs:
        o["we_new"] = np.concatenate(o["we_new"])
        o["se_new"] = np.concatenate(o["se_new"])
    return outs


def check_local_grads(ranks, jax_grads, convert, step, model=1):
    """Each stage's captured step-``step`` gradients against JAX's
    data-local ones at the same weights, leaf by leaf."""
    for arrays, meta in ranks:
        d, m = meta["data_rank"], meta["model_rank"]
        mine = jax.tree_util.tree_map(lambda a: a[d], jax_grads)
        for call, sid in enumerate(meta["stages"]):
            names = meta[f"names/{sid}"]
            want = stage_view(mine, convert, names, sid, m, model)
            got = arrays[f"cap/{step}/{call}/g"]
            off = 0
            for n in names:
                w = want[n]
                g = got[off:off + w.size].reshape(w.shape)
                off += w.size
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                    err_msg=n)


def check_compressed_step(ranks, params, convert, step, lr, model=1):
    """Each (stage, model rank)'s captured step-``step`` update equal, bit
    for bit, to :func:`onebit_reference` over its data ranks."""
    by = {}
    for arrays, meta in ranks:
        by.setdefault(meta["model_rank"], []).append((arrays, meta))
    checked = 0
    for m, rows in by.items():
        rows.sort(key=lambda r: r[1]["data_rank"])
        meta = rows[0][1]
        for call, sid in enumerate(meta["stages"]):
            names = meta[f"names/{sid}"]
            positions = stage_view(jax_body_positions(params, sid, m, model),
                                   convert, names, sid, m, model)
            buffers = reference_buffers(names, meta[f"shapes/{sid}"],
                                        positions, model)
            caps = [{k: a[f"cap/{step}/{call}/{k}"] for k in
                     ("p", "g", "m", "v", "we", "se", "p_new", "m_new",
                      "v_new", "we_new", "se_new")} for a, _ in rows]
            for c, want in zip(caps, onebit_reference(caps, buffers, lr)):
                assert np.array_equal(c["v_new"], c["v"])
                for k in ("p_new", "m_new", "we_new", "se_new"):
                    assert np.array_equal(c[k], want[k]), (sid, m, k)
                checked += 1
    return checked


def pipe_case(name, opt, root, **kw):
    return dict({"name": name, "kind": "pipe_onebit", "mesh": MESH,
                 "in_process_pipe": True,
                 "rows": ROWS, "micro": MICRO, "seq": SEQ, "opt": opt,
                 "steps": STEPS, "state": str(root / "state.npz"),
                 "batch": str(root / "batch.npz")}, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("onebit_pipe")
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 255, (ROWS, SEQ)).astype(np.int32)}
    module = jax_pipeline_module(jax_tiny(dropout=0.0, dtype=jnp.float32),
                                 seq_len=SEQ)
    engine, params = jax_engine(module, MESH, ONEBIT)
    state = convert_gpt2_pipe_params(params)
    np.savez(root / "state.npz", **{k: v.numpy() for k, v in state.items()})
    np.savez(root / "batch.npz", **batch)
    cases = [pipe_case("ob", ONEBIT, root, capture=[1, 4]),
             pipe_case("nobias", NOBIAS, root, steps=3),
             pipe_case("client", None, root, steps=1,
                       client={"lr": 1e-3, "freeze_step": 0}),
             pipe_case("fault", dict(ONEBIT, params={
                 "lr": 1e-3, "freeze_step": 0}), root, steps=2,
                 fault="tied_in_body")]
    # the port's world runs while the JAX engines do
    procs = H.start_world(2, cases, root / "state.npz", root / "w",
                          worker=WORKER)
    try:
        losses, grads = jax_train(engine, STEPS, batch, local=True)
        dense = jax_train(jax_engine(module, MESH, NOBIAS)[0], STEPS,
                          batch)[0]
    except BaseException:
        H.stop_world(procs)
        raise
    H.wait_world(procs)
    return root, (losses, dense), engine, params, grads


def res(root, name, world=2):
    return H.load_results(root / "w", name, world)


def within_compression_noise(got, want, dense, start):
    """Each loss from index ``start`` on within half of what 1-bit
    compression moved JAX's (``want``) from its dense run."""
    got, want, dense = (np.asarray(x)[start:] for x in (got, want, dense))
    bound = 0.5 * np.abs(want - dense) + 1e-6 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), (got, want, dense)


def test_local_gradients_are_jax(world):
    root, _, _, _, grads = world
    check_local_grads(res(root, "ob"), grads, convert_gpt2_pipe_params, 1)


def test_compressed_step_equals_the_reference(world):
    root, _, _, params, _ = world
    assert check_compressed_step(res(root, "ob"), params,
                                 convert_gpt2_pipe_params, 4,
                                 ONEBIT["params"]["lr"]) == 4


def test_warmup_is_adam_without_bias_correction(world):
    root, (want, _), _, _, _ = world
    nobias = res(root, "nobias")[0][1]["losses"]
    for _, meta in res(root, "ob"):
        np.testing.assert_allclose(meta["losses"][:3], want[:3], rtol=2e-4)
        np.testing.assert_allclose(meta["losses"][:3], nobias, rtol=2e-4)


def test_compressed_stage_trains_as_jax(world):
    root, (want, dense), engine, _, _ = world
    assert np.isfinite(want).all() and want[-1] < want[0]
    for a, meta in res(root, "ob"):
        losses = meta["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        within_compression_noise(losses, want, dense, 3)
        assert meta["step/0"] == meta["step/1"] == STEPS
        assert meta["error_abs/0"] > 0 and meta["error_abs/1"] > 0
        assert meta["groups/0"] == [["body", 12], ["tied", 2]]
        assert meta["groups/1"] == [["body", 12], ["rest", 2],
                                    ["tied", 2]]
        assert meta["tied_equal"]
    assert int(engine.opt_state.step) == STEPS


def test_client_object_and_planted_fault(world):
    root = world[0]
    for _, meta in res(root, "client"):
        assert np.isfinite(meta["losses"]).all()
        assert meta["step/0"] == 1 and meta["error_abs/1"] > 0
    for _, meta in res(root, "fault"):
        assert meta["groups/0"] == [["body", 14]]
        assert not meta["tied_equal"]
