"""The gradient compressors' runners for ``tests/torch_tp_worker.py``
(``tests/test_torch_onebit_dp.py``, ``tests/test_torch_onebit_pipe.py``,
``tests/test_torch_onebit_pipe_3d.py``): the chunk-server collectives,
the int8 and 1-bit all-reduces and 1-bit Adam's update over gloo, the
data-parallel engine's quantized and 1-bit steps on JAX's
``test_quantized_parity`` MLP, and the pipeline under 1-bit Adam. Each
runner takes ``(case, spec, groups)`` and returns ``(arrays, meta)``.
Imports only ``torch``, ``numpy`` and the port."""

import hashlib
import os

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.parallel import collectives as C
from deepspeed_tpu_torch.runtime.comm import compressed as pc
from deepspeed_tpu_torch.runtime.comm import quantized as pq
from deepspeed_tpu_torch.runtime.fp16 import onebit_adam as po

HIDDEN, NLAYERS = 128, 4


def rows_of(x, accum, data, d):
    """Data rank ``d``'s rows of a global batch (JAX ``_shard_batch``:
    global micro-batch k's rows ``[d*m, (d+1)*m)``)."""
    per = x.shape[0] // accum
    m = per // data
    return x.reshape((accum, per) + x.shape[1:])[:, d * m:(d + 1) * m] \
        .reshape((accum * m,) + x.shape[1:])


def mlp_batches(accum, steps):
    """JAX ``test_quantized_parity._batches``."""
    rng = np.random.default_rng(0)
    bs = 16 * accum
    w = rng.normal(size=(HIDDEN, HIDDEN)).astype(np.float32) * 0.1
    out = []
    for _ in range(steps):
        x = rng.normal(size=(bs, HIDDEN)).astype(np.float32)
        out.append({"x": x, "y": x @ w})
    return out


class _Linear(nn.Module):
    def __init__(self):
        super().__init__()
        # JAX's flat order: bias before kernel; kernel [in, out]
        self.bias = nn.Parameter(torch.zeros(HIDDEN))
        self.kernel = nn.Parameter(torch.zeros(HIDDEN, HIDDEN))


class MLP(nn.Module):
    """JAX ``test_quantized_parity``'s model with its flat layout, so a
    flat gradient cuts into the same int8 chunks on both sides. Inputs
    stay f32 (JAX promotes its bf16 params against them)."""

    def __init__(self, state):
        super().__init__()
        self.layers = nn.ModuleDict(
            {f"linear_{i}": _Linear() for i in range(NLAYERS)})
        with torch.no_grad():
            for n, p in self.named_parameters():
                p.copy_(torch.from_numpy(state[n.replace("layers.", "")]))

    def loss(self, batch, seed=None):
        x = batch["x"]
        for i in range(NLAYERS):
            layer = self.layers[f"linear_{i}"]
            x = x @ layer.kernel.float() + layer.bias.float()
            if i < NLAYERS - 1:
                x = torch.relu(x)
        return torch.mean(torch.square(x - batch["y"]))


def mlp_config(case):
    cfg = {"train_batch_size": 16 * case.get("accum", 1),
           "train_micro_batch_size_per_gpu": 16 // case["world"],
           "gradient_accumulation_steps": case.get("accum", 1),
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    cfg.update(case.get("keys", {}))
    return cfg


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _mlp_engine(case, spec, optimizer=None):
    with np.load(spec["state"]) as z:
        state = {k: z[k] for k in z.files}
    model = MLP(state)
    engine, _, _, _ = initialize(model=model, config=mlp_config(case),
                                 loss_fn=model.loss, optimizer=optimizer,
                                 device="cpu")
    return engine


def _mlp_steps(engine, case, batches, rank, errors=None):
    losses, digests = [], []
    for b in batches:
        mine = {k: torch.from_numpy(rows_of(v, case.get("accum", 1),
                                            case["world"], rank))
                for k, v in b.items()}
        losses.append(float(engine.train_batch(mine)))
        digests.append(_digest(engine.params))
        if errors is not None and hasattr(engine.opt_state, "worker_error"):
            errors.append(engine.opt_state.worker_error.numpy().copy())
    return losses, digests


def run_mlp(case, spec, groups):
    """The data-parallel engine on the MLP: ``steps`` steps (losses and
    each step's params digest); with ``ckpt`` a checkpoint after step
    ``ckpt`` and a second engine (and, with ``client``, a client
    ``OnebitAdam`` of the same hyperparameters) resumed from it."""
    rank = groups.global_rank
    batches = mlp_batches(case.get("accum", 1), case["steps"])
    opt = None
    if case.get("client"):
        opt = po.OnebitAdam(**case["client"])
    C.reset_collective_counts()
    engine = _mlp_engine(case, spec, opt)
    out, meta = {}, {}
    k = case.get("ckpt")
    errors = []
    losses, digests = _mlp_steps(engine, case, batches[:k], rank, errors)
    if k:
        path = os.path.join(spec["out"], f"ckpt_{case['name']}")
        engine.save_checkpoint(path, tag="t")
        more, more_d = _mlp_steps(engine, case, batches[k:], rank, errors)
        resumed = _mlp_engine(case, spec, opt)
        resumed.load_checkpoint(path, tag="t")
        meta["resumed"] = _mlp_steps(resumed, case, batches[k:], rank)[0]
        losses, digests = losses + more, digests + more_d
        meta["ckpt"] = path
    meta.update(losses=losses, digests=digests,
                counts=C.collective_counts(),
                comm=engine.comm.snapshot())
    for n, p in zip(engine._param_names(), engine.params):
        out[f"param/{n}"] = p.detach().numpy()
    for i, e in enumerate(errors):
        out[f"we/{i}"] = e
    s = engine.opt_state
    if hasattr(s, "worker_error"):
        out["worker_error"] = s.worker_error.numpy()
        out["server_error"] = s.server_error.numpy()
        meta["onebit_step"] = int(s.step)
    if engine._qcomm_res is not None:
        meta["residual_buckets"] = len(engine._qcomm_res["worker"])
        out["qres_worker"] = engine._qcomm_res["worker"][0].numpy()
    return out, meta


def run_exchanges(case, spec, groups):
    """The chunk-server pair, the int8 and 1-bit all-reduces (two calls
    each, error feedback carried) and 1-bit Adam's update over the data
    group, on this rank's rows of seeded inputs."""
    g = groups.axis("data")
    world, r = g.size, g.rank
    out, meta = {}, {}
    C.reset_collective_counts()
    stack = torch.arange(world * 3, dtype=torch.float32).reshape(world, 3) \
        + 100 * r
    q8 = torch.full((world, 5), r, dtype=torch.int8)
    got, got8 = C.scatter_to_chunk_servers((stack, q8), g)
    out["scatter"], out["scatter_i8"] = got.numpy(), got8.numpy()
    out["gather"] = C.gather_from_chunk_servers(
        torch.tensor(float(r)), g).numpy()
    meta["pair_counts"] = C.collective_counts()

    rng = np.random.default_rng(case["seed"])
    n = case["n_int8"]
    xs = [rng.normal(size=(world, n)).astype(np.float32) for _ in range(2)]
    wr, sr = torch.zeros(n), torch.zeros(n // world)
    for i, x in enumerate(xs):
        avg, wr, sr = pq.quantized_allreduce(
            torch.from_numpy(x[r]), g, chunk_size=case["chunk"],
            worker_residual=wr, server_residual=sr)
        out[f"q/{i}/avg"], out[f"q/{i}/w"], out[f"q/{i}/s"] = \
            avg.numpy(), wr.numpy(), sr.numpy()
    n1 = case["n_1bit"]
    padded, chunk = pc.error_feedback_sizes(n1, world)
    we, se = torch.zeros(padded), torch.zeros(chunk)
    for i in range(2):
        x = np.zeros((world, padded), np.float32)
        x[:, :n1] = rng.standard_normal((world, n1)).astype(np.float32)
        avg, we, se = pc.compressed_allreduce(torch.from_numpy(x[r]), we,
                                              se, g, n_valid=n1)
        out[f"c/{i}/avg"], out[f"c/{i}/w"], out[f"c/{i}/s"] = \
            avg.numpy(), we.numpy(), se.numpy()

    # 1-bit Adam's update: freeze_step 2 over 4 steps
    prng = np.random.default_rng(case["seed"] + 1)
    shapes = [(5, 7), (13,)]
    params = [torch.from_numpy(prng.normal(size=s).astype(np.float32))
              for s in shapes]
    grads = [[prng.normal(size=(world,) + s).astype(np.float32)
              for s in shapes] for _ in range(4)]
    state = po.init_onebit_state(params, world)
    for i, gs in enumerate(grads):
        params, state = po.onebit_adam_update(
            params, [torch.from_numpy(a[r]) for a in gs], state, lr=0.05,
            beta1=0.9, beta2=0.99, eps=1e-6, weight_decay=0.01,
            freeze_step=2, group=g)
        for j, p in enumerate(params):
            out[f"adam/{i}/p{j}"] = p.numpy()
        out[f"adam/{i}/we"] = state.worker_error.numpy()
    return out, meta


def _pipe_module(case):
    if case.get("three_d"):
        from tests.torch_tp_cases import fixture_module
        return fixture_module("gpt", seq=case["seq"])
    from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
    return gpt2_pipeline_module(gpt2_tiny(
        dtype=torch.float32, dropout=0.0, use_flash_attention=True),
        seq_len=case["seq"])


def _flat_np(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors]) \
        .numpy().copy()


def capture_updates(steps, out):
    """Wrap :func:`pipeline_onebit_update` so that the calls of the
    1-based ``steps`` record, in ``out`` under ``cap/<step>/<call>/``,
    their inputs and outputs flat in the stage's parameter order
    (masters ``p``, gradients ``g``, moments ``m`` / ``v``, error
    buffers ``we`` / ``se``; ``*_new`` after). Returns the undo."""
    right = po.pipeline_onebit_update
    seen = {}

    def capture(params, grads, state, groups, **kw):
        step = int(state.step) + 1
        inputs = {"p": _flat_np(params), "g": _flat_np(grads),
                  "m": _flat_np(state.m), "v": _flat_np(state.v),
                  "we": state.worker_error.numpy().copy(),
                  "se": state.server_error.numpy().copy()}
        new_p, new_s = right(params, grads, state, groups, **kw)
        if step in steps:
            call = seen.setdefault(step, 0)
            seen[step] += 1
            inputs.update(p_new=_flat_np(new_p), m_new=_flat_np(new_s.m),
                          v_new=_flat_np(new_s.v),
                          we_new=new_s.worker_error.numpy().copy(),
                          se_new=new_s.server_error.numpy().copy())
            for k, v in inputs.items():
                out[f"cap/{step}/{call}/{k}"] = v
        return new_p, new_s

    po.pipeline_onebit_update = capture
    return lambda: setattr(po, "pipeline_onebit_update", right)


def run_pipe_onebit(case, spec, groups):
    """A pipeline (every stage of this process's coordinate here) under
    ``opt`` for ``steps`` steps on JAX's batch: losses, the masters of
    every local stage and, for the fault checks, whether the tied copies
    and the model-replicated leaves agree. ``fault`` compresses the tied
    leaves in the body's buffer (``tied_in_body``) or the replicated
    body leaves with the sharded ones (``rep_with_mp``); ``capture``
    (step numbers) records those steps' stage updates
    (:func:`capture_updates`, one call a stage in stage order)."""
    from tests.torch_tp_cases import load_state
    out = {}
    undo = capture_updates(set(case.get("capture", ())), out)
    if case.get("fault"):
        plant_group_fault(case["fault"])
    try:
        module = _pipe_module(case)
        cfg = {"train_batch_size": case["rows"],
               "gradient_accumulation_steps": case["micro"],
               "steps_per_print": 10 ** 9, "mesh": case["mesh"]}
        if case.get("opt"):
            cfg["optimizer"] = case["opt"]
        engine, _, _, _ = initialize(
            model=module, config=cfg, optimizer=po.OnebitAdam(
                **case["client"]) if case.get("client") else None,
            model_parameters=load_state(case["state"]), device="cpu",
            mpu=groups if case.get("three_d") else None)
        d = engine.dp_rank
        with np.load(case["batch"]) as z:
            batch = {k: torch.from_numpy(rows_of(
                z[k].astype(np.int64), case["micro"],
                engine.dp_world_size, d)) for k in z.files}
        losses, norms = [], []
        for _ in range(case["steps"]):
            losses.append(float(engine.train_batch(batch)))
            norms.append(float(engine._last_metrics["grad_norm"]))
    finally:
        undo()
        if case.get("fault"):
            plant_group_fault(None)
    meta = {"losses": losses, "grad_norms": norms}
    for se in engine.stage_engines:
        sid = se.module.stage_id
        meta[f"names/{sid}"] = se._param_names()
        meta[f"shapes/{sid}"] = [list(p.shape) for p in se.params]
        for n, p in zip(se._param_names(), se.params):
            out[f"master/{sid}/{n}"] = p.detach().numpy()
        s = se.opt_state
        meta[f"step/{sid}"] = int(s.step)
        if hasattr(s, "worker_error"):
            meta[f"error_abs/{sid}"] = float(s.worker_error.abs().sum())
            meta[f"groups/{sid}"] = [[k, len(i)]
                                     for k, i in se._onebit_groups]
    meta["tied_equal"] = tied_equal(engine)
    meta["data_rank"] = engine.dp_rank
    meta["model_rank"] = engine._axes["model"].rank
    meta["stages"] = [se.module.stage_id for se in engine.stage_engines]
    return out, meta


def tied_equal(engine):
    """Each tied leaf bit for bit equal on every stage of this process
    that holds it (copies on the host)."""
    held = {}
    for se in engine.stage_engines:
        for n, p in se.module.named_parameters():
            if n.startswith("tied."):
                held.setdefault(n, []).append(p.detach().cpu())
    return all(torch.equal(ts[0], t) for ts in held.values() for t in ts)


_GROUPS = po.pipeline_onebit_groups


def plant_group_fault(fault):
    """Replace :func:`pipeline_onebit_groups` with a faulty grouping (or
    restore it with None): ``tied_in_body`` compresses the tied leaves in
    the body's buffer, ``rep_with_mp`` the model-replicated body leaves
    with the model-sharded ones."""
    def faulty(names, model_sharded, model=1, reference=None):
        groups = _GROUPS(names, model_sharded, model, reference)
        kinds = dict(groups)
        if fault == "tied_in_body" and "tied" in kinds:
            body = "body_mp" if "body_mp" in kinds else "body"
            kinds[body] = kinds[body] + kinds.pop("tied")
        if fault == "rep_with_mp" and "body_rep" in kinds:
            kinds["body_mp"] = kinds["body_mp"] + kinds.pop("body_rep")
        return [(k, sorted(v)) for k, v in kinds.items()]
    po.pipeline_onebit_groups = _GROUPS if fault is None else faulty


RUNNERS = {"mlp": run_mlp, "exchanges": run_exchanges,
           "pipe_onebit": run_pipe_onebit}
