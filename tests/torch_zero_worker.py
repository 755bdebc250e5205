"""One data-parallel rank of the ZeRO tests (``tests/test_torch_zero*.py``).

Run as ``python tests/torch_zero_worker.py SPEC.json`` in each of the
world's processes, with the launcher env the port reads
(``DS_TPU_COORDINATOR`` a ``file://`` store, ``DS_TPU_NUM_PROCESSES``,
``DS_TPU_PROCESS_ID``). It joins the gloo group through the port's
``initialize``, runs every case of the spec and writes one ``.npz`` a
case and rank into the spec's ``out`` directory. It imports only
``torch``, ``numpy`` and the port.
"""

import gc
import json
import os
import sys
import weakref

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepspeed_tpu_torch import initialize  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2LMHead,
    gpt2_tiny,
    stack_gpt2_state_dict,
)
from deepspeed_tpu_torch.parallel import (  # noqa: E402
    destroy_distributed,
    dp_rank,
    dp_world_size,
    initialize_distributed,
)
from deepspeed_tpu_torch.runtime.dataloader import (  # noqa: E402
    DeepSpeedDataLoader,
)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "fp16": torch.float16}


def model_config(case):
    kw = dict(case.get("model", {}))
    return gpt2_tiny(dtype=DTYPES[case["dtype"]],
                     use_flash_attention=case.get("flash", True), **kw)


def engine_config(case):
    cfg = {"train_batch_size": case.get("batch", 8),
           "gradient_accumulation_steps": case.get("accum", 2),
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam",
                         "params": {"lr": case.get("lr", 1e-2)}}}
    if case["dtype"] == "bf16":
        cfg["bf16"] = {"enabled": True}
    if case["dtype"] == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    zero = dict(case.get("zero", {}))
    if case.get("stage") or zero:
        zero.setdefault("stage", case.get("stage", 0))
        cfg["zero_optimization"] = zero
    if case.get("clip"):
        cfg["gradient_clipping"] = case["clip"]
    if case.get("amp"):
        # bf16 compute asked for by the amp key instead of bf16's
        del cfg["bf16"]
        cfg["amp"] = {"enabled": True}
    cfg.update(case.get("keys", {}))
    return cfg


def build(case, state):
    cfg = model_config(case)
    model = GPT2LMHead(cfg, device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    model.load_state_dict(stack_gpt2_state_dict(sd) if cfg.scan_layers
                          else sd)
    engine, _, _, _ = initialize(model=model, config=engine_config(case),
                                 device="cpu")
    return engine


def global_batches(case):
    rng = np.random.default_rng(case.get("data_seed", 0))
    vocab = case.get("model", {}).get("vocab_size", 256)
    return [rng.integers(0, vocab, (case.get("batch", 8), 32))
            .astype(np.int32) for _ in range(case.get("steps", 3))]


def local_rows(x, accum, world, rank):
    """Rank ``rank``'s rows of a global batch: global micro-batch k's rows
    ``[r*m, (r+1)*m)`` for each k (JAX ``_shard_batch``)."""
    per = x.shape[0] // accum
    m = per // world
    return x.reshape((accum, per) + x.shape[1:])[:, rank * m:(rank + 1) * m] \
        .reshape((accum * m,) + x.shape[1:])


def names_of(engine):
    return engine._param_names()


def whole_params(engine):
    """Every param whole (the stage-3 pieces gathered)."""
    if engine._offload:
        return dict(zip(names_of(engine), engine.cpu_optimizer.params()))
    if engine._stage == 3:
        return {n: engine._whole(i, m) for i, (n, m) in
                enumerate(zip(names_of(engine), engine._masters))}
    return {n: p.data for n, p in zip(names_of(engine), engine.params)}


def pieces_in_leaf_layout(engine, tensors):
    """Each of this rank's pieces with the split dimension moved back (the
    shape of the JAX device's shard)."""
    out = {}
    for i, (n, t) in enumerate(zip(names_of(engine), tensors)):
        part = engine._parts[i] if engine._parts else None
        if part is not None and part.sharded:
            t = t.movedim(0, part.dim)
        out[n] = t
    return out


def run_train(case, state, world, rank, out):
    engine = build(case, state)
    accum = case.get("accum", 2)
    losses, counts = [], None
    for x in global_batches(case):
        engine.comm.reset()
        losses.append(float(engine.train_batch(
            {"input_ids": local_rows(x, accum, world, rank)})))
        counts = engine.comm.snapshot()
    res = {"losses": np.array(losses)}
    if engine._fp8_flat is not None:
        res["fp8"] = engine._fp8_flat.numpy()
    for n, t in whole_params(engine).items():
        res[f"param/{n}"] = t.detach().float().numpy()
    if not engine._offload:
        s = engine.opt_state
        for key, ts in (("m", s.m), ("v", s.v)):
            for n, t in pieces_in_leaf_layout(engine, ts).items():
                res[f"{key}/{n}"] = t.numpy()
    meta = {"counts": counts, "world": world}
    if engine._fp8_keys is not None:
        meta["fp8_keys"] = engine._fp8_keys
    if engine._sparse:
        m = engine._last_metrics
        meta["sparse"] = [float(m["sparse_grad_dropped"]),
                          int(m["sparse_grad_dense_fallbacks"])]
    if engine._stage == 3:
        inst = engine._installer
        meta["plan"] = inst.plan.to_dict()
        meta["gathers"] = inst.gathers
        meta["regathers"] = inst.regathers
        meta["alive_after_forward"] = gathered_alive_after_forward(
            engine, global_batches(case)[0], accum, world, rank)
    if engine._stage >= 1 and not engine._offload:
        meta["dims"] = {n: p.dim for n, p in
                        zip(names_of(engine), engine._parts)}
        meta["param_bytes"] = sum(4 * p.numel for p in engine._parts)
        meta["replicated_bytes"] = sum(4 * p.numel for p in engine._parts
                                       if not p.sharded)
    if engine._offload:
        if case.get("dir"):
            engine.save_checkpoint(case["dir"], tag="last")
        engine._offload_sync_host_state()
        opt = engine.cpu_optimizer
        res["host/master"] = opt.master.numpy().copy()
        res["host/exp_avg"] = opt.exp_avg.numpy().copy()
        res["host/exp_avg_sq"] = opt.exp_avg_sq.numpy().copy()
    return res, meta


def gathered_alive_after_forward(engine, x, accum, world, rank):
    """How many of a stage-3 forward's gathered copies are still alive
    when the forward has returned and its graph is held (none, when the
    autograd graph saved none of them)."""
    inst = engine._installer
    refs = []
    gather = inst._gather

    def recording(i):
        t = gather(i)
        refs.append(weakref.ref(t._base if t._base is not None else t))
        return t

    inst._gather = recording
    try:
        micro = local_rows(x, accum, world, rank)[:x.shape[0] // accum
                                                  // world]
        loss = engine.forward({"input_ids": micro})
        gc.collect()
        alive = sum(r() is not None for r in refs)
        engine.backward(loss)
    finally:
        inst._gather = gather
    return {"gathered": len(refs), "alive": alive}


def run_overflow(case, state, world, rank, out):
    """fp16: an inf put into one rank's gradient skips the step on every
    rank."""
    engine = build(case, state)
    accum = case.get("accum", 2)
    x = local_rows(global_batches(case)[0], accum, world, rank)
    before = {n: t.clone() for n, t in whole_params(engine).items()}
    m = x.shape[0] // accum
    for k in range(accum):
        engine.backward(engine.forward({"input_ids": x[k * m:(k + 1) * m]}))
    if rank == case["poison_rank"]:
        g = engine.params[0].grad if engine._stage in (0, 1) \
            else engine._grads[0]
        g.view(-1)[0] = float("inf")
    engine.step()
    after = whole_params(engine)
    changed = any(not torch.equal(before[n], after[n]) for n in before)
    res = {"loss_scale": np.array(engine.loss_scale)}
    return res, {"skipped": engine.skipped_steps, "changed": changed,
                 "overflow": bool(engine._last_metrics["overflow"])}


def run_loader(case, state, world, rank, out):
    rows = np.arange(40, dtype=np.int64)[:, None].repeat(3, axis=1)
    loader = DeepSpeedDataLoader(rows, batch_size=8, seed=3)
    got = [b.numpy() for b in loader]
    return {"rows": np.stack(got)}, {"index": loader.process_index,
                                     "count": loader.process_count}


def run_checkpoint(case, state, world, rank, out):
    """Save at this world and stage after 2 steps, train 2 more (the
    uninterrupted run); a fresh engine at the same stage loads the
    checkpoint and trains the same 2 steps (the resumed run), and one
    at ``load_stage`` loads it and reports what it holds whole."""
    ckpt = case["dir"]
    accum = case.get("accum", 2)
    batches = [{"input_ids": local_rows(x, accum, world, rank)}
               for x in global_batches(dict(case, steps=4))]
    engine = build(case, state)
    for b in batches[:2]:
        engine.train_batch(b)
    engine.save_checkpoint(ckpt, tag="t2")
    saved = {f"param/{n}": t.detach().clone().numpy()
             for n, t in whole_params(engine).items()}
    for key, ts in (("m", engine.opt_state.m), ("v", engine.opt_state.v)):
        for i, (n, t) in enumerate(zip(names_of(engine), ts)):
            saved[f"{key}/{n}"] = engine._whole(i, t).numpy()
    cont = [float(engine.train_batch(b)) for b in batches[2:]]
    again = build(case, state)
    again.load_checkpoint(ckpt, tag="t2")
    resumed = [float(again.train_batch(b)) for b in batches[2:]]
    other = build(dict(case, stage=case["load_stage"]), state)
    other.load_checkpoint(ckpt, tag="t2")
    loaded = {f"param/{n}": t.detach().clone().numpy()
              for n, t in whole_params(other).items()}
    for key, ts in (("m", other.opt_state.m), ("v", other.opt_state.v)):
        for i, (n, t) in enumerate(zip(names_of(other), ts)):
            loaded[f"{key}/{n}"] = other._whole(i, t).numpy()
    res = {f"saved/{k}": v for k, v in saved.items()}
    res.update({f"loaded/{k}": v for k, v in loaded.items()})
    res["continued"] = np.array(cont)
    res["resumed"] = np.array(resumed)
    return res, {}


def run_eval(case, state, world, rank, out):
    """``eval_batch`` over rank r's rows ``[r*n, (r+1)*n)`` of a global
    batch (JAX ``_place_rows``), and ``forward`` of the same rows."""
    engine = build(case, state)
    x = global_batches(case)[0]
    n = x.shape[0] // world
    mine = {"input_ids": x[rank * n:(rank + 1) * n]}
    loss = engine.eval_batch(mine)
    return {"eval": np.array(float(loss)),
            "forward": np.array(float(engine.forward(mine)))}, {}


def _recording(module, name, calls, kind):
    """Wrap ``module.name`` (an attention entry taking q first) so each
    call appends its dropout coordinates to ``calls``."""
    inner = getattr(module, name)

    def wrapped(q, *args, **kw):
        if kw.get("dropout_rate"):
            calls.append({"kind": kind, "shape": list(q.shape),
                          "seed": int(kw["dropout_seed"]),
                          "offset": int(kw.get("dropout_head_offset", 0)),
                          "rate": float(kw["dropout_rate"])})
        return inner(q, *args, **kw)

    setattr(module, name, wrapped)


def bert_batches(case):
    rng = np.random.default_rng(case.get("data_seed", 0))
    n, t = case.get("batch", 8), 64
    out = []
    for _ in range(case.get("steps", 1)):
        labels = np.full((n, t), -100, np.int64)
        labels[:, ::7] = rng.integers(0, 256, labels[:, ::7].shape)
        out.append({"input_ids": rng.integers(0, 256, (n, t))
                    .astype(np.int32), "labels": labels})
    return out


def run_dropout(case, state, world, rank, out):
    """Training with dropout 0.1: the dropout coordinates of every
    attention call of one ``train_batch`` (K1 ``flash_attention_fwd``,
    ``dense_attention``, K7 ``block_sparse_attention_fwd``), then the
    ``forward`` loss of rows every rank is given alike."""
    import importlib
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    bsa = importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
    calls = []
    _recording(fa, "flash_attention_fwd", calls, "flash")
    _recording(fa, "dense_attention", calls, "dense")
    _recording(bsa, "block_sparse_attention_fwd", calls, "sparse")
    accum = case.get("accum", 2)
    if case.get("bert"):
        from deepspeed_tpu_torch.models import bert as tbert
        from deepspeed_tpu_torch.ops.sparse_attention import (
            FixedSparsityConfig,
        )
        cfg = tbert.bert_tiny(
            dtype=torch.float32, hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1,
            sparse_attention=FixedSparsityConfig(4, block=16,
                                                 num_local_blocks=2))
        model = tbert.BertForMaskedLM(
            cfg, device="cpu",
            generator=torch.Generator().manual_seed(0))
        engine, _, _, _ = initialize(model=model,
                                     config=engine_config(case),
                                     device="cpu")
        x = bert_batches(case)[0]
        mine = {k: local_rows(v, accum, world, rank) for k, v in x.items()}
        same = {k: v[:2] for k, v in x.items()}
    else:
        engine = build(dict(case, model=dict(case.get("model", {}),
                                             dropout=0.1)), state)
        x = global_batches(case)[0]
        mine = {"input_ids": local_rows(x, accum, world, rank)}
        same = {"input_ids": x[:2]}
    engine.train_batch(mine)
    step_calls = list(calls)
    loss = float(engine.forward(same))
    return {"forward": np.array(loss)}, {"calls": step_calls}


def run_gather(case, state, world, rank, out):
    """``Comm.all_gather_striped`` of each rank's random piece at 1, 2,
    3 and 4 stripes, each way, against one all-gather."""
    from deepspeed_tpu_torch.runtime.zero.comm import Comm
    comm = Comm()
    gen = torch.Generator().manual_seed(100 + rank)
    res = {}
    for n in (1, 7, 64, 1001):
        for dtype in (torch.float32, torch.bfloat16):
            piece = torch.randn(n, generator=gen).to(dtype)
            for chunks in (1, 2, 3, 4):
                for bidir in (False, True):
                    flat = torch.full((world * n,), float("nan"),
                                      dtype=dtype)
                    handle = comm.all_gather_striped(
                        flat, piece, chunks, bidir, async_op=bidir)
                    if handle is not None:
                        handle.wait()
                    res[f"{n}/{str(dtype)[6:]}/{chunks}/{int(bidir)}"] = \
                        flat.float().numpy()
    return res, {"counts": comm.snapshot()}


def run_wire(case, state, world, rank, out):
    """Stage 3 with the fp8 wire: every leaf as this rank's forward
    gather makes it (compute dtype, whole), with the gathers' counts;
    then the case's training steps, with the fp8 state and sparse
    metrics the run leaves."""
    engine = build(case, state)
    inst = engine._installer
    engine.comm.reset()
    res = {}
    with torch.no_grad():
        for i, n in enumerate(names_of(engine)):
            res[f"gathered/{n}"] = inst._gather(i).float().numpy()
    meta = {"counts": engine.comm.snapshot(), "plan": inst.plan.to_dict(),
            "pieces": {n: list(p.piece_shape) for n, p in
                       zip(names_of(engine), engine._parts) if p.sharded}}
    train, train_meta = run_train(case, state, world, rank, out)
    res.update(train)
    meta["train_counts"] = train_meta.pop("counts")
    meta.update(train_meta)
    return res, meta


def run_sum_order(case, state, world, rank, out):
    """A ``[rows, 8]`` f32 leaf holding ``case["values"][rank]`` in every
    element, summed over the group by the dense path's all-reduce and by
    the sparse path's CSR exchange and scatter-add (every row kept)."""
    from deepspeed_tpu_torch.runtime.csr_tensor import (
        csr_allreduce, dense_to_csr)
    from deepspeed_tpu_torch.runtime.zero.comm import Comm
    comm = Comm()
    rows = int(case.get("rows", 64))
    g = torch.full((rows, 8), float(case["values"][rank]))
    dense = g.clone()
    comm.all_reduce(dense)
    summed = csr_allreduce(dense_to_csr(g, rows), comm, average=False)
    sparse = torch.zeros_like(g)
    sparse.index_add_(0, summed.indices, summed.values)
    return {"dense": dense.numpy(), "sparse": sparse.numpy()}, {}


RUNNERS = {"train": run_train, "overflow": run_overflow,
           "loader": run_loader, "checkpoint": run_checkpoint,
           "eval": run_eval, "dropout": run_dropout, "gather": run_gather,
           "wire": run_wire, "sum_order": run_sum_order}


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    world, rank = dp_world_size(), dp_rank()
    try:
        states = {}
        for case in spec["cases"]:
            path = case.get("state", spec["state"])
            if path not in states:
                states[path] = dict(np.load(path))
            res, meta = RUNNERS[case.get("kind", "train")](
                case, states[path], world, rank, spec["out"])
            base = os.path.join(spec["out"], f"{case['name']}.{rank}")
            np.savez(base + ".npz", **res)
            with open(base + ".json", "w") as f:
                json.dump(meta, f)
        print(f"rank {rank} of {world}: {len(spec['cases'])} cases done",
              flush=True)
    finally:
        teardown()


def teardown():
    """Leave the group in order: the engines dropped (an installer waits
    on its pending prefetch gathers when released), then one barrier and
    ``destroy_distributed``."""
    gc.collect()
    destroy_distributed()

if __name__ == "__main__":
    main()
