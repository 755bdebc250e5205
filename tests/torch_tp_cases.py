"""The tensor-parallel worker's model-level runners
(``tests/torch_tp_worker.py``): TP layers, GPT-2 training and serving
through the port's entry points, and the TP pipeline. Each takes
``(case, spec, groups)`` (``groups`` the worker's
:class:`~deepspeed_tpu_torch.parallel.mesh.MeshGroups`) and returns
``(arrays, meta)``. Imports only ``torch``, ``numpy`` and the port."""

import importlib

import numpy as np
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    gpt2_tiny,
    shard_gpt2_state_dict,
)
from deepspeed_tpu_torch.parallel import collectives as C
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def load_state(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def global_batches(case, vocab=256, seq=16):
    rng = np.random.default_rng(case.get("data_seed", 0))
    return [rng.integers(0, vocab, (case["batch"], seq)).astype(np.int64)
            for _ in range(case["steps"])]


def replica_rows(x, accum, data, d):
    """Data replica ``d``'s rows of a global batch (JAX ``_shard_batch``:
    global micro-batch k's rows ``[d*m, (d+1)*m)``)."""
    per = x.shape[0] // accum
    m = per // data
    return x.reshape((accum, per) + x.shape[1:])[:, d * m:(d + 1) * m] \
        .reshape((accum * m,) + x.shape[1:])


def gpt2_config(case):
    kw = dict(case.get("model", {}))
    return gpt2_tiny(dtype=DTYPES[case.get("dtype", "f32")],
                     use_flash_attention=case.get("flash", True), **kw)


def engine_config(case):
    cfg = {"train_batch_size": case["batch"],
           "gradient_accumulation_steps": case.get("accum", 1),
           "steps_per_print": 10 ** 9, "mesh": case["mesh"],
           "optimizer": {"type": case.get("opt", "Adam"),
                         "params": {"lr": case.get("lr", 1e-3),
                                    "eps": case.get("eps", 1e-8)}}}
    if case.get("dtype") == "bf16":
        cfg["bf16"] = {"enabled": True}
    if case.get("zero"):
        cfg["zero_optimization"] = dict(case["zero"])
    if case.get("clip"):
        cfg["gradient_clipping"] = case["clip"]
    return cfg


def _recording(module, name, calls):
    """Record each call's dropout coordinates of ``module.name``."""
    fn = getattr(module, name)

    def wrapper(q, *args, **kw):
        if kw.get("dropout_rate", 0.0) > 0.0:
            B, T, H, _ = q.shape
            calls.append([B, H, T, int(kw.get("dropout_seed")),
                          int(kw.get("dropout_head_offset", 0)),
                          kw.get("dropout_num_heads")])
        return fn(q, *args, **kw)

    setattr(module, name, wrapper)
    return fn


def run_gpt2_train(case, spec, groups):
    """GPT-2 tiny through ``initialize`` at the case's mesh: the first
    batch's gradients (whole leaves, averaged over the data group),
    ``steps`` training steps, the whole masters after them, and with
    ``dropout`` every attention call's dropout coordinates."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        checkpointing as ck)
    tp, data = groups.axis("model"), groups.axis("data")
    sd = load_state(case.get("state", spec["state"]))
    cfg = gpt2_config(case)
    ck.reset()
    ck.configure(mpu_=groups, partition_activations=bool(
        case.get("partition")))
    segments = []
    apply = ck._PartitionedSegment.apply

    def counted(run, axis, *args):
        segments.append([int(a.numel()) for a in args if torch.is_tensor(a)])
        return apply(run, axis, *args)

    ck._PartitionedSegment.apply = counted
    model = GPT2LMHead(cfg, device="cpu", mpu=groups)
    model.load_state_dict(shard_gpt2_state_dict(sd, tp.rank, tp.size,
                                                cfg.vocab_size))
    specs = tpl.partition_specs(model)
    xs = global_batches(case, cfg.vocab_size)
    accum = case.get("accum", 1)
    out, meta = {}, {}

    def whole(name, t):
        pieces = C.all_gather(t.contiguous()[None], tp, dim=0)
        return tpl.unshard(list(pieces.unbind(0)), specs[name])

    if case.get("grads"):
        rows = torch.from_numpy(replica_rows(xs[0], 1, data.size,
                                             data.rank))
        loss = model.loss_fn({"input_ids": rows})
        loss.backward()
        for name, p in model.named_parameters():
            g = C.all_reduce(p.grad.clone(), data) / data.size
            out[f"grad/{name}"] = whole(name, g).numpy()
            p.grad = None
    calls = []
    if case.get("dropout"):
        fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
        _recording(fa, "flash_attention", calls)
        _recording(fa, "dense_attention", calls)
    engine, _, _, _ = initialize(model=model, config=engine_config(case),
                                 mpu=groups, device="cpu")
    C.reset_collective_counts()
    meta["losses"] = [float(engine.train_batch({"input_ids": torch.from_numpy(
        replica_rows(x, accum, data.size, data.rank))})) for x in xs]
    meta["counts"] = C.collective_counts()
    meta["calls"] = calls
    meta["mp_world_size"] = engine.mp_world_size
    meta["dp_world_size"] = engine.dp_world_size
    meta["grad_norm"] = float(engine._last_metrics["grad_norm"])
    meta["partitioned_segments"] = segments
    ck._PartitionedSegment.apply = apply
    if case.get("save"):
        engine.save_checkpoint(case["save"])
        meta["topology"] = engine._topology()
    state = engine._checkpoint_state_tree()["params"]
    for name, t in state.items():
        out[f"master/{name}"] = torch.as_tensor(t).float().numpy()
    if case.get("load"):
        fresh = GPT2LMHead(cfg, device="cpu", mpu=groups)
        e2, _, _, _ = initialize(model=fresh, config=engine_config(case),
                                 mpu=groups, device="cpu")
        e2.load_checkpoint(case["save"])
        x = xs[-1]
        rows = {"input_ids": torch.from_numpy(
            replica_rows(x, accum, data.size, data.rank))}
        meta["resumed"] = [float(engine.train_batch(rows)),
                           float(e2.train_batch(rows))]
    return out, meta


def run_tp_layers(case, spec, groups):
    """The column/row pair and ``TPTransformerBlock`` on this rank's
    shards of whole weights (``spec["state"]`` holds them under
    ``pair/`` and ``block/``): outputs, the loss's whole gradients."""
    tp = groups.axis("model")
    sd = load_state(spec["state"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 32)).astype(np.float32))
    out = {}
    col = tpl.ColumnParallelLinear(32, 64, tp)
    row = tpl.RowParallelLinear(64, 16, tp)
    tpl.load_sharded(col, {k[len("pair/c."):]: v for k, v in sd.items()
                           if k.startswith("pair/c.")}, tp)
    tpl.load_sharded(row, {k[len("pair/r."):]: v for k, v in sd.items()
                           if k.startswith("pair/r.")}, tp)
    out["pair"] = row(col(x)).detach().numpy()
    for flash in (False, True):
        block = tpl.TPTransformerBlock(32, 4, tp, use_flash=flash)
        tpl.load_sharded(block, {k[len("block/"):]: v for k, v in sd.items()
                                 if k.startswith("block/")}, tp)
        xg = x.clone().requires_grad_(True)
        y = block(xg)
        loss = (y.float() ** 2).mean()
        loss.backward()
        tag = "flash" if flash else "dense"
        out[f"{tag}/y"] = y.detach().numpy()
        out[f"{tag}/dx"] = xg.grad.numpy()
        specs = tpl.partition_specs(block)
        for name, p in block.named_parameters():
            pieces = C.all_gather(p.grad.contiguous()[None], tp, dim=0)
            out[f"{tag}/grad/{name}"] = tpl.unshard(
                list(pieces.unbind(0)), specs[name]).numpy()
    return out, {"specs": {n: list(s) if s is not None else None
                           for n, s in tpl.partition_specs(block).items()}}


RUNNERS = {"gpt2_train": run_gpt2_train, "tp_layers": run_tp_layers}


def run_serve(case, spec, groups):
    """GPT-2 tiny served by this rank's ``InferenceEngine`` over its shard
    (the case's ``config``): every request's greedy tokens, and the
    teacher-forced logits of two prompts."""
    from deepspeed_tpu_torch.inference import (
        ContinuousBatchingScheduler, InferenceEngine, Request)
    tp = groups.axis("model")
    sd = load_state(spec["state"])
    cfg = gpt2_tiny(dtype=torch.float32)
    model = GPT2LMHead(cfg, device="cpu", mpu=groups)
    engine = InferenceEngine(
        model, shard_gpt2_state_dict(sd, tp.rank, tp.size, cfg.vocab_size),
        config=case["config"], device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}", rng.integers(0, 256, n).tolist(),
                    max_new_tokens=6, arrival_step=i)
            for i, n in enumerate(case["prompts"])]
    done = ContinuousBatchingScheduler(engine).run(reqs)
    meta = {"tokens": {c.rid: list(map(int, c.tokens)) for c in done},
            "counts": engine.compile_counts(),
            "cache_heads": engine.spec.n_head}
    out = {}
    if engine.kv_layout == "ring":
        engine.reset()
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 256, n).tolist() for n in (7, 13)]
        forced = rng.integers(0, 256, (6, 2)).astype(np.int32)
        out["first"] = np.stack([np.asarray(engine.prefill(i, p))
                                 for i, p in enumerate(prompts)])
        pos = np.asarray([len(p) for p in prompts], np.int32)
        steps = []
        for toks in forced:
            _, logits = engine.decode(toks, pos)
            steps.append(np.asarray(logits))
            pos = pos + 1
        out["steps"] = np.stack(steps)
    return out, meta


RUNNERS["serve"] = run_serve


def fixture_module(block, vocab=32, d_model=8, n_head=4, seq=8, **block_kw):
    """``tests/pipeline_fixtures.py:tiny_tp_pipeline_module`` in the port:
    embed (``emb``) -> 2 TP blocks -> head (``w``), the mean token
    cross-entropy against ``labels``."""
    from torch import nn

    from deepspeed_tpu_torch.parallel import pipe_tp
    from deepspeed_tpu_torch.runtime.pipe.module import (
        LayerSpec, PipelineModule)

    class Embed(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Parameter(torch.zeros(vocab, d_model))

        @torch.no_grad()
        def reset_parameters(self, generator=None):
            nn.init.normal_(self.emb, 0.0, 0.1, generator=generator)

        def forward(self, micro):
            return self.emb[micro["ids"]]

    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.zeros(d_model, vocab))

        @torch.no_grad()
        def reset_parameters(self, generator=None):
            nn.init.normal_(self.w, 0.0, 0.1, generator=generator)

        def forward(self, x):
            return x @ self.w

    def loss(logits, micro):
        lp = torch.log_softmax(logits.float(), -1)
        return -torch.gather(lp, -1, micro["labels"][..., None].long()) \
            .mean()

    cls = {"gpt": pipe_tp.TPBlockLayer,
           "bert": pipe_tp.TPBertBlockLayer}[block]
    return PipelineModule(
        layers=[LayerSpec(Embed)] +
        [LayerSpec(cls, d_model, n_head, **block_kw) for _ in range(2)] +
        [LayerSpec(Head)], num_stages=2, loss_fn=loss)


def whole_pipe_tree(engine, tree, dim=2):
    """A tree of this rank's pieces made whole: each ``mp_*`` leaf
    gathered over the model group along ``dim`` (2 in the pipe layout's
    ``[S, L/S, rows, ...]``, 0 in a stage's own)."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import Shard, unshard
    tp = engine._tp
    out = {}
    for name, t in tree.items():
        t = torch.as_tensor(t)
        if tp is not None and name.split(".")[-1].startswith("mp_"):
            pieces = C.all_gather(t.contiguous()[None], tp, dim=0)
            t = unshard(list(pieces.unbind(0)), Shard(dim))
        out[name] = t
    return out


def run_pipe_tp(case, spec, groups):
    """The TP pipeline through ``initialize`` (every stage of this
    process's (data, model) coordinate here): ``value_and_grad`` of the
    first batch (whole grads, the pipe layout), then ``steps`` steps."""
    from deepspeed_tpu_torch.parallel.pipe_tp import tp_pipeline_module
    data = groups.axis("data")
    kw = dict(case.get("block_kw", {}))
    if case.get("module") == "tp_pipeline_module":
        module = tp_pipeline_module(case["vocab"], case["d_model"],
                                    case["n_head"], case["seq"],
                                    n_blocks=case.get("n_blocks", 2),
                                    num_stages=2, **kw)
    else:
        module = fixture_module(case.get("block", "gpt"), **kw)
    cfg = {"train_batch_size": case["rows"],
           "gradient_accumulation_steps": case["micro"],
           "steps_per_print": 10 ** 9, "mesh": case["mesh"],
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if case.get("overlap") is not None:
        cfg["tensor_parallel"] = {"overlap": case["overlap"]}
    if case.get("fp8"):
        cfg["fp8"] = case["fp8"]
    state = load_state(case.get("state", spec["state"])) \
        if case.get("load", True) else None
    # every stage of this (data, model) coordinate here, or (the mesh's
    # groups left unused) one process a stage rank of the engine's layout
    engine, _, _, _ = initialize(
        model=module, config=cfg, model_parameters=state, device="cpu",
        mpu=groups if case.get("in_process_pipe") else None,
        seed=case.get("seed", 0))
    rng = np.random.default_rng(case.get("data_seed", 0))
    d, rows = engine.dp_rank, case["rows"] // engine.dp_world_size

    def mine(b):
        return {k: torch.from_numpy(v[d * rows:(d + 1) * rows].astype(
            np.int64)) for k, v in b.items()}

    seq, vocab = case.get("seq", 8), case.get("vocab", 32)
    keys = ("ids", "labels") if case.get("module") is None \
        else ("input_ids",)
    batches = [{k: rng.integers(0, vocab, (case["rows"], seq))
                for k in keys} for _ in range(case.get("steps", 0) + 1)]
    if case.get("batch0"):          # the first batch given (JAX's)
        with np.load(case["batch0"]) as z:
            batches[0] = {k: z[k] for k in z.files}
    if case.get("batch_all"):       # every batch the given one
        with np.load(case["batch_all"]) as z:
            batches = [{k: z[k] for k in z.files}] * len(batches)
    out, meta = {}, {}
    C.reset_collective_counts()
    if case.get("grads", True):
        loss, grads = engine.value_and_grad(mine(batches[0]), 1.0)
        meta["vag_loss"] = float(loss)
        trees = {"": grads} if engine.in_process else grads
        for stage, tree in trees.items():
            for name, g in whole_pipe_tree(
                    engine, tree, 2 if engine.in_process else 0).items():
                out[f"grad/{stage}/{name}" if stage != "" else
                    f"grad/{name}"] = g.float().numpy()
    meta["losses"] = [float(engine.train_batch(mine(b)))
                      for b in batches[1:]]
    meta["counts"] = C.collective_counts()
    state = engine.pipe_state()
    trees = {"": state} if engine.in_process else state
    for stage, tree in trees.items():
        for name, t in tree.items():
            out[f"master/{stage}/{name}" if stage != "" else
                f"master/{name}"] = t.float().numpy()
    meta["stages"] = [se.module.stage_id for se in engine.stage_engines]
    return out, meta


RUNNERS["pipe_tp"] = run_pipe_tp
