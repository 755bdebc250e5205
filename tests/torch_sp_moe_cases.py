"""The sequence- and expert-parallel runners of the tensor-parallel
worker (``tests/torch_tp_worker.py``): ring and Ulysses attention, the
SP pipeline, the MoE layer, GPT-2 MoE through ``initialize`` and the
expert pipelines. Each takes ``(case, spec, groups)`` (``groups`` the
worker's :class:`~deepspeed_tpu_torch.parallel.mesh.MeshGroups`) and
returns ``(arrays, meta)``. Imports only ``torch``, ``numpy`` and the
port."""

import numpy as np
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.parallel import collectives as C
from deepspeed_tpu_torch.parallel.tensor_parallel import Shard, unshard

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def load(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def whole(t, group, dim=0):
    """Every rank's piece of ``t`` along ``dim`` over ``group``, joined."""
    if group is None or not group.active:
        return t
    pieces = C.all_gather(t.contiguous()[None], group, dim=0)
    return unshard(list(pieces.unbind(0)), Shard(dim))


# ---------------------------------------------------------------------------
# ring and Ulysses attention
# ---------------------------------------------------------------------------

def run_seq_attention(case, spec, groups):
    """Each variant of ``case["variants"]`` (``[fn, causal, dtype, rate,
    seed, plan_chunks]``) on this rank's ``[data, seq]`` block of the
    global inputs in ``spec["state"]`` (``q``, ``k``, ``v``, ``w``): the
    block's output and the local gradients of ``sum(out * w)``; with
    ``record`` the seeds Ulysses hands its attention."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    from deepspeed_tpu_torch.parallel import sequence as sp
    from deepspeed_tpu_torch.parallel.collectives import (
        OverlapPlan, overlap_scope)
    g = load(case.get("inputs", spec["state"]))
    out, meta = {}, {"seeds": {}}
    for fn, causal, dtype, rate, seed, chunks in case["variants"]:
        key = f"{fn}/{int(causal)}/{dtype}/{rate}/{chunks}"
        q, k, v = (sp._local_block(g[n], groups).to(DTYPES[dtype])
                   .requires_grad_(True) for n in ("q", "k", "v"))
        w = sp._local_block(g["w"], groups)
        seeds = []

        def attn(*a, **kw):
            seeds.append(kw.get("dropout_seed"))
            return flash_attention(*a, **kw)

        kw = dict(causal=causal, dropout_rate=rate,
                  dropout_seed=seed if rate else None)
        data = groups.axis("data")
        dg = data if data.size > 1 else None
        plan = OverlapPlan(chunks=chunks) if chunks > 1 else None
        with overlap_scope(plan):
            if fn == "ring":
                o = sp.ring_attention_local(q, k, v, groups.axis("seq"),
                                            data_group=dg, **kw)
            else:
                o = sp.ulysses_attention_local(q, k, v, groups.axis("seq"),
                                               attn_fn=attn, data_group=dg,
                                               **kw)
            (o.float() * w).sum().backward()
        out[key + "/out"] = o.detach().float().numpy()
        for n, t in (("dq", q), ("dk", k), ("dv", v)):
            out[f"{key}/{n}"] = t.grad.float().numpy()
        meta["seeds"][key] = seeds
    try:
        bad = torch.zeros(1, 4, case["bad_heads"], 2)
        sp.ulysses_attention_local(bad, bad, bad, groups.axis("seq"))
        meta["head_error"] = None
    except AssertionError as e:
        meta["head_error"] = str(e)
    return out, meta


# ---------------------------------------------------------------------------
# the SP pipeline
# ---------------------------------------------------------------------------

def _pipe_engine(module, case, groups, state=None):
    cfg = {"train_batch_size": case["rows"],
           "gradient_accumulation_steps": case["micro"],
           "steps_per_print": 10 ** 9, "mesh": case["mesh"],
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if case.get("overlap"):
        cfg["tensor_parallel"] = {"overlap": case["overlap"]}
    engine, _, _, _ = initialize(
        model=module, config=cfg, model_parameters=state, device="cpu",
        mpu=groups if case.get("in_process_pipe", True) else None,
        seed=case.get("seed", 0))
    return engine


def _pipe_results(engine, batches, grads=True):
    """``value_and_grad`` of the first batch (whole leaves, the pipe
    layout, or each stage's own names ``<stage>/<name>`` one process a
    stage rank), the next batches' losses and the masters."""
    d = engine.dp_rank
    out, meta = {}, {}

    def mine(b):
        rows = next(iter(b.values())).shape[0] // engine.dp_world_size
        return {k: torch.from_numpy(v[d * rows:(d + 1) * rows].astype(
            np.int64)) for k, v in b.items()}

    def trees(x):
        return {"": x} if engine.in_process else x

    def split_leaf(name, t, dim):
        leaf = name.split(".")[-1]
        for prefix, axis in (("mp_", "model"), ("expert_", "expert")):
            if leaf.startswith(prefix):
                return whole(t, engine._axes[axis], dim)
        return t

    C.reset_collective_counts()
    if grads:
        loss, g = engine.value_and_grad(mine(batches[0]), 1.0)
        meta["vag_loss"] = float(loss)
        for stage, tree in trees(g).items():
            for name, t in tree.items():
                t = split_leaf(name, t, 2 if engine.in_process else 0)
                out[f"grad/{stage}/{name}" if stage != "" else
                    f"grad/{name}"] = t.float().numpy()
    meta["losses"] = [float(engine.train_batch(mine(b)))
                      for b in batches[1:]]
    meta["counts"] = C.collective_counts()
    for stage, tree in trees(engine.pipe_state()).items():
        for name, t in tree.items():
            t = split_leaf(name, torch.as_tensor(t),
                           2 if engine.in_process else 0)
            out[f"master/{stage}/{name}" if stage != "" else
                f"master/{name}"] = t.float().numpy()
    meta["stages"] = [se.module.stage_id for se in engine.stage_engines]
    return out, meta


def _batches(case, keys=("input_ids",)):
    rng = np.random.default_rng(case.get("data_seed", 0))
    out = [{k: rng.integers(0, case["vocab"], (case["rows"], case["seq"]))
            for k in keys} for _ in range(case.get("steps", 0) + 1)]
    if case.get("batch0"):
        with np.load(case["batch0"]) as z:
            out[0] = {k: z[k] for k in z.files}
    return out


def run_pipe_sp(case, spec, groups):
    """The SP pipeline through ``initialize`` at the case's mesh (module
    ``[vocab, d_model, n_head, seq]``, JAX's weights with ``state``):
    value_and_grad, ``steps`` steps; ``hidden`` the hidden-dropout
    multipliers of this rank's chunk; ``scalar`` the scalar-loss error."""
    from deepspeed_tpu_torch.parallel import pipe_sp
    from deepspeed_tpu_torch.parallel.pipe_tp import axis_scope
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule
    module = pipe_sp.sp_pipeline_module(
        case["vocab"], case["d_model"], case["n_head"], case["seq"],
        n_blocks=case.get("n_blocks", 2), num_stages=2,
        dropout=case.get("dropout", 0.0),
        attn_dropout=case.get("attn_dropout"))
    state = load(case["state"]) if case.get("state") else None
    engine = _pipe_engine(module, case, groups, state)
    out, meta = _pipe_results(engine, _batches(case),
                              grads=case.get("grads", True))
    if case.get("hidden"):
        block = pipe_sp.SPBlockLayer(case["d_model"], case["n_head"],
                                     dropout=0.25)
        ones = torch.ones(2, case["seq"] // groups.axis("seq").size,
                          case["d_model"])
        with axis_scope(seq=groups.axis("seq")):
            out["hidden"] = block._hidden_drop(ones, 77, 1).numpy()
    if case.get("scalar"):
        scalar = PipelineModule(
            layers=module.specs,
            num_stages=2,
            loss_fn=lambda logits, micro: logits.float().mean())
        e2 = _pipe_engine(scalar, case, groups)
        try:
            e2.train_batch({"input_ids": torch.zeros(
                case["rows"] // e2.dp_world_size, case["seq"],
                dtype=torch.int64)})
            meta["scalar_error"] = None
        except ValueError as e:
            meta["scalar_error"] = str(e)
    return out, meta


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def run_moe_layer(case, spec, groups):
    """The MoE layer over the expert group from the whole weights in
    ``state`` (``moe.<leaf>``) on the global ``x`` of ``inputs``: output,
    the whole gradients of ``sum(y * w) + aux``, the input's gradient,
    and the routing counts."""
    from deepspeed_tpu_torch.moe.layer import MoE, MoEConfig
    g = load(case["inputs"])
    ep = groups.axis("expert")
    cfg = MoEConfig(**case["moe"])
    layer = MoE(cfg, case["hidden"], case["d_model"], group=ep)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(layer._local(g[f"moe.{name}"])
                    if name.startswith("expert_") else g[f"moe.{name}"])
    x = g["x"].clone().requires_grad_(True)
    y, aux = layer(x, deterministic=case.get("deterministic", False))
    ((y * g["w"]).sum() + aux).backward()
    out = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
           "dx": x.grad.numpy(), "kept": layer.last_routing[0].numpy(),
           "routed": layer.last_routing[1].numpy()}
    for name, p in layer.named_parameters():
        out[f"grad/{name}"] = (whole(p.grad, ep) if name.startswith(
            "expert_") else p.grad).numpy()
    return out, {"e_local": int(layer.expert_w1.shape[0])}


def run_gpt2_moe_train(case, spec, groups):
    """GPT-2 MoE tiny through ``initialize`` at the case's mesh from the
    JAX weights in ``state``: the losses of ``batches`` (one global batch
    a step, this data replica's rows), the whole masters after them."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
    from deepspeed_tpu_torch.models.gpt2_moe import (
        GPT2MoELMHead, gpt2_moe_tiny)
    data = groups.axis("data")
    full = load(case["state"])
    if case.get("dense"):
        cfg = gpt2_tiny(dtype=torch.float32, use_flash_attention=True)
        model = GPT2LMHead(cfg, device="cpu")
        model.load_state_dict(full)
    else:
        cfg = gpt2_moe_tiny(dtype=DTYPES[case.get("dtype", "f32")],
                            use_flash_attention=True)
        model = GPT2MoELMHead(cfg, device="cpu", mpu=groups)
        model.load_state_dict(_cut(full, model))
    conf = {"train_batch_size": case["batch"], "steps_per_print": 10 ** 9,
            "mesh": case["mesh"], "optimizer": {
                "type": "Adam", "params": {"lr": case.get("lr", 1e-3)}}}
    if case.get("dtype") == "bf16":
        conf["bf16"] = {"enabled": True}
    if case.get("zero") is not None:
        conf["zero_optimization"] = {"stage": case["zero"]}
    engine, _, _, _ = initialize(model=model, config=conf, device="cpu",
                                 mpu=None if case.get("dense") else groups)
    batches = load(case["batches"])
    losses = []
    for i in range(len(batches)):
        x = batches[f"b{i}"]
        m = x.shape[0] // data.size
        losses.append(float(engine.train_batch({"input_ids": x[
            data.rank * m:(data.rank + 1) * m].long()})))
    rows = {"input_ids": batches["b0"][
        data.rank * m:(data.rank + 1) * m].long()}
    meta = {"losses": losses, "grad_norm": float(
        engine._last_metrics["grad_norm"]),
        "dp_world_size": engine.dp_world_size,
        "eval": float(engine.eval_batch(rows))}
    out = {f"master/{n}": torch.as_tensor(t).float().numpy() for n, t in
           engine._checkpoint_state_tree()["params"].items()}
    if case.get("save"):
        # whole leaves on disk; a fresh engine resumes from them
        engine.save_checkpoint(case["save"])
        meta["topology"] = engine._topology()
        fresh = GPT2MoELMHead(cfg, device="cpu", mpu=groups)
        e2, _, _, _ = initialize(model=fresh, config=conf, device="cpu",
                                 mpu=groups)
        e2.load_checkpoint(case["save"])
        meta["resumed"] = [float(engine.train_batch(rows)),
                           float(e2.train_batch(rows))]
    return out, meta


def _cut(full, model):
    """This rank's pieces of the whole leaves ``full`` (by the model's
    split specs)."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import (
        partition_specs, shard_tensor)
    specs = partition_specs(model)
    out = {}
    for name, p in model.named_parameters():
        t = full[name]
        if specs.get(name) is not None:
            t = shard_tensor(t, specs[name], p.tp_axis.rank,
                             p.tp_axis.size)
        out[name] = t
    return out


# ---------------------------------------------------------------------------
# the expert pipelines
# ---------------------------------------------------------------------------

def expert_pipe_module(case):
    """JAX ``tests/unit/test_expert_pipe.py``'s module in the port (or
    ``test_pipe_tp_moe.py``'s with ``tp``): embed (``emb``) -> 2 MoE
    body layers -> head (``w``), the mean token cross-entropy against
    ``labels`` plus the carried aux."""
    from torch import nn

    from deepspeed_tpu_torch.moe.expert_pipe import ExpertParallelFFNLayer
    from deepspeed_tpu_torch.moe.layer import MoEConfig
    from deepspeed_tpu_torch.parallel.pipe_tp_moe import TPMoEBlockLayer
    from deepspeed_tpu_torch.runtime.pipe.module import (
        LayerSpec, PipelineModule)
    D, aux = case["d_model"], case.get("aux", False)

    class Embed(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Parameter(torch.zeros(32, D))

        @torch.no_grad()
        def reset_parameters(self, generator=None):
            nn.init.normal_(self.emb, 0.0, 0.1, generator=generator)

        def forward(self, micro):
            h = self.emb[micro["ids"]]
            return (h, torch.zeros(())) if aux else h

    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.zeros(D, 32))

        @torch.no_grad()
        def reset_parameters(self, generator=None):
            nn.init.normal_(self.w, 0.0, 0.1, generator=generator)

        def forward(self, x):
            if isinstance(x, tuple):
                return x[0] @ self.w, x[1]
            return x @ self.w

    def loss(out, micro):
        a = 0.0
        if isinstance(out, tuple):
            out, a = out
        lp = torch.log_softmax(out.float(), -1)
        return -torch.gather(lp, -1, micro["labels"][..., None].long()) \
            .mean() + a

    moe = MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0)
    body = LayerSpec(TPMoEBlockLayer, D, 4, 16, moe) if case.get("tp") \
        else LayerSpec(ExpertParallelFFNLayer, D, 16, moe)
    return PipelineModule(layers=[LayerSpec(Embed), body, body,
                                  LayerSpec(Head)],
                          num_stages=2, loss_fn=loss)


def run_expert_pipe(case, spec, groups):
    """The expert pipeline (``expert_pipe_module``) through
    ``initialize``: value_and_grad of the first batch (whole leaves),
    ``steps`` steps, the masters."""
    state = load(case["state"]) if case.get("state") else None
    engine = _pipe_engine(expert_pipe_module(case), case, groups, state)
    return _pipe_results(engine, _batches(case, ("ids", "labels")))


RUNNERS = {"seq_attention": run_seq_attention, "pipe_sp": run_pipe_sp,
           "moe_layer": run_moe_layer, "gpt2_moe_train": run_gpt2_moe_train,
           "expert_pipe": run_expert_pipe}
