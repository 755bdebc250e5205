"""The tensor-parallel worker's runners for BERT at a model axis and for
GPT-2 with ``scan_layers`` / ``loss_chunk`` at a model axis
(``tests/test_torch_bert_tp.py``, ``tests/test_torch_tp_scan.py``),
through the port's entry points. Each takes ``(case, spec, groups)``
and returns ``(arrays, meta)``. Imports only ``torch``, ``numpy`` and
the port."""

import importlib

import numpy as np
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    gpt2_tiny,
    shard_gpt2_state_dict,
    stack_gpt2_state_dict,
    unstack_gpt2_state_dict,
    with_layout,
)
from deepspeed_tpu_torch.ops.sparse_attention import (
    FixedSparsityConfig,
    VariableSparsityConfig,
)
from deepspeed_tpu_torch.parallel import collectives as C
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl
from tests.torch_tp_cases import (
    engine_config,
    global_batches,
    load_state,
    replica_rows,
)

BERT_T = 64


def sparsity(name):
    """The BERT test's sparse cores: ``fixed`` (Fixed, block 16, one
    layout), ``variable`` (Variable with a random block a row and a
    layout of its own a head)."""
    if name == "fixed":
        return FixedSparsityConfig(4, block=16, num_local_blocks=2)
    if name == "variable":
        return VariableSparsityConfig(4, block=16, num_random_blocks=1,
                                      local_window_blocks=[2],
                                      global_block_indices=[0],
                                      different_layout_per_head=True)
    return None


def bert_config(case):
    core = case.get("core", "dense")
    kw = dict(case.get("model", {}))
    dtype = torch.bfloat16 if case.get("dtype") == "bf16" else torch.float32
    return tbert.bert_tiny(dtype=dtype, use_flash_attention=core == "flash",
                           sparse_attention=sparsity(core), **kw)


def bert_batches(case):
    """``steps`` global MLM batches of ``batch`` x 64: every 7th position
    a label, token types split at the middle, and with ``masked`` a key
    padding mask that keeps at least half of each row."""
    vocab = case.get("model", {}).get("vocab_size", 256)
    rng = np.random.default_rng(case.get("data_seed", 0))
    n, out = case["batch"], []
    for _ in range(case["steps"]):
        ids = rng.integers(0, vocab, (n, BERT_T))
        labels = np.full((n, BERT_T), -100, np.int64)
        labels[:, ::7] = rng.integers(0, vocab, labels[:, ::7].shape)
        b = {"input_ids": ids, "labels": labels,
             "token_type_ids": (np.arange(BERT_T) >= BERT_T // 2)[None]
             .repeat(n, 0).astype(np.int64)}
        if case.get("masked"):
            b["attention_mask"] = (np.arange(BERT_T)[None] < rng.integers(
                BERT_T // 2, BERT_T + 1, (n, 1))).astype(np.int64)
        out.append(b)
    return out


def _rows(batch, accum, data):
    return {k: torch.from_numpy(replica_rows(v, accum, data.size,
                                             data.rank))
            for k, v in batch.items()}


def _record_dropout(calls):
    """Record every attention call's dropout coordinates ``[B, heads,
    T, seed, head_offset, num_heads]`` on the three BERT cores; returns
    the undo."""
    tr = importlib.import_module(
        "deepspeed_tpu_torch.ops.transformer.transformer")
    ssa = importlib.import_module(
        "deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention")
    saved = [(tr, "flash_attention"), (tr, "_dropout_multiplier_full"),
             (ssa, "block_sparse_attention")]
    fns = {(m, n): getattr(m, n) for m, n in saved}

    def kernel(fn):
        def wrapper(q, *args, **kw):
            if kw.get("dropout_rate", 0.0) > 0.0:
                B, T, H, _ = q.shape
                calls.append([B, H, T, int(kw["dropout_seed"]),
                              int(kw.get("dropout_head_offset", 0)),
                              kw.get("dropout_num_heads")])
            return fn(q, *args, **kw)
        return wrapper

    def dense(fn):
        def wrapper(B, H, T, S, rate, seed, head_offset=0, num_heads=None,
                    device=None):
            calls.append([B, H, T, int(seed), int(head_offset), num_heads])
            return fn(B, H, T, S, rate, seed, head_offset, num_heads, device)
        return wrapper

    tr.flash_attention = kernel(fns[(tr, "flash_attention")])
    tr._dropout_multiplier_full = dense(fns[(tr, "_dropout_multiplier_full")])
    ssa.block_sparse_attention = kernel(fns[(ssa, "block_sparse_attention")])

    def undo():
        for (m, n), fn in fns.items():
            setattr(m, n, fn)
    return undo


def _whole_state(engine):
    """The engine's checkpoint tree, whole leaves as numpy copies (a
    replicated leaf of the tree is the engine's own tensor)."""
    tree = engine._checkpoint_state_tree()
    leaves = [("master", tree["params"]), ("m", tree["opt_state"]["m"]),
              ("v", tree["opt_state"]["v"])]
    return {f"{kind}/{name}": torch.as_tensor(t).float().numpy().copy()
            for kind, sub in leaves for name, t in sub.items()}


def run_bert_train(case, spec, groups):
    """BERT tiny MLM through ``initialize`` at the case's mesh: the first
    batch's whole gradients (averaged over the data group), ``steps``
    steps, the whole masters and moments after them; ``save`` writes a
    checkpoint after the steps, ``load`` restores one into a fresh
    engine first; with ``dropout`` every attention call's dropout
    coordinates."""
    tp, data = groups.axis("model"), groups.axis("data")
    sd = load_state(case.get("state", spec["state"]))
    cfg = bert_config(case)
    model = tbert.BertForMaskedLM(cfg, device="cpu", mpu=groups)
    model.load_state_dict(tbert.shard_bert_state_dict(
        sd, tp.rank, tp.size, cfg.vocab_size))
    specs = tpl.partition_specs(model)
    batches = bert_batches(case)
    accum = case.get("accum", 1)
    out, meta = {}, {}
    if case.get("grads"):
        loss = model.loss_fn(_rows(batches[0], 1, data))
        loss.backward()
        for name, p in model.named_parameters():
            g = C.all_reduce(p.grad.clone(), data) / data.size
            pieces = C.all_gather(g.contiguous()[None], tp, dim=0)
            out[f"grad/{name}"] = tpl.unshard(list(pieces.unbind(0)),
                                              specs[name]).numpy()
            p.grad = None
    calls = []
    undo = _record_dropout(calls) if case.get("dropout") else None
    engine, _, _, _ = initialize(model=model, config=engine_config(case),
                                 mpu=groups, device="cpu")
    if case.get("load"):
        engine.load_checkpoint(case["load"])
        out.update({f"loaded/{k}": v
                    for k, v in _whole_state(engine).items()})
    C.reset_collective_counts()
    meta["losses"] = [float(engine.train_batch(_rows(b, accum, data)))
                      for b in batches]
    meta["counts"] = C.collective_counts()
    if undo is not None:
        undo()
    meta["calls"] = calls
    meta["mp_world_size"] = engine.mp_world_size
    meta["dp_world_size"] = engine.dp_world_size
    meta["local_heads"] = model.bert.layer[0].local_heads
    meta["shapes"] = {n: list(p.shape) for n, p in model.named_parameters()}
    out.update(_whole_state(engine))
    if case.get("save"):
        engine.save_checkpoint(case["save"])
        meta["topology"] = engine._topology()
    return out, meta


def qa_batch():
    """Two rows of span targets over padded inputs (the QA case's)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (2, BERT_T))
    mask = (np.arange(BERT_T)[None] < np.array([[40], [64]])).astype(
        np.int64)
    return {k: torch.from_numpy(v) for k, v in (
        ("input_ids", ids), ("attention_mask", mask),
        ("start_positions", rng.integers(0, 40, 2)),
        ("end_positions", rng.integers(0, 40, 2)))}


def run_bert_qa(case, spec, groups):
    """``BertForQuestionAnswering`` built for the case's model axis: the
    span logits and the loss of :func:`qa_batch`."""
    tp = groups.axis("model")
    sd = load_state(case.get("state", spec["state"]))
    model = tbert.BertForQuestionAnswering(bert_config(case), device="cpu",
                                           mpu=groups)
    model.load_state_dict(tbert.shard_bert_state_dict(sd, tp.rank, tp.size))
    b = qa_batch()
    start, end = model(b["input_ids"], b["attention_mask"])
    loss = tbert.make_bert_qa_loss_fn(model)(b)
    return ({"start": start.detach().numpy(), "end": end.detach().numpy()},
            {"loss": float(loss)})


def gpt2_scan_config(case):
    kw = dict(case.get("model", {}))
    return gpt2_tiny(dtype=torch.float32, use_flash_attention=True, **kw)


def _gpt2_model(case, spec, groups):
    """The case's model holding its rank's shard; ``via_layout`` builds
    the unrolled model and restacks it (``with_layout``)."""
    tp = groups.axis("model")
    cfg = gpt2_scan_config(case)
    sd = load_state(case.get("state", spec["state"]))
    if case.get("via_layout"):
        import dataclasses
        model = GPT2LMHead(dataclasses.replace(cfg, scan_layers=False),
                           device="cpu", mpu=groups)
        model.load_state_dict(shard_gpt2_state_dict(sd, tp.rank, tp.size,
                                                    cfg.vocab_size))
        return cfg, with_layout(model, cfg.scan_layers)
    if cfg.scan_layers:
        sd = stack_gpt2_state_dict(sd)
    model = GPT2LMHead(cfg, device="cpu", mpu=groups)
    model.load_state_dict(shard_gpt2_state_dict(sd, tp.rank, tp.size,
                                                cfg.vocab_size))
    return cfg, model


def run_gpt2_scan_train(case, spec, groups):
    """GPT-2 tiny (``scan_layers`` and / or ``loss_chunk`` in
    ``case["model"]``) through ``initialize`` at the case's mesh: the
    first batch's whole gradients and its whole-vocab and chunked losses
    (``grads``), ``steps`` steps, the whole masters (unrolled names) after
    them; ``save`` writes a checkpoint and ``serve`` then serves the
    saved masters through ``load_checkpoint_model(..., mpu=)`` at this
    mesh, greedy, in the ``scan_layers`` layout."""
    tp, data = groups.axis("model"), groups.axis("data")
    cfg, model = _gpt2_model(case, spec, groups)
    specs = tpl.partition_specs(model)
    xs = global_batches(case, cfg.vocab_size)
    accum = case.get("accum", 1)
    out, meta = {}, {}
    if case.get("grads"):
        from deepspeed_tpu_torch.models.gpt2 import (
            vocab_parallel_chunked_cross_entropy,
            vocab_parallel_cross_entropy)
        rows = torch.from_numpy(replica_rows(xs[0], 1, data.size,
                                             data.rank))
        loss = model.loss_fn({"input_ids": rows})
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            g = C.all_reduce(p.grad.clone(), data) / data.size
            pieces = C.all_gather(g.contiguous()[None], tp, dim=0)
            grads[name] = tpl.unshard(list(pieces.unbind(0)), specs[name])
            p.grad = None
        if cfg.scan_layers:
            grads = unstack_gpt2_state_dict(grads)
        out.update({f"grad/{k}": v.numpy() for k, v in grads.items()})
        with torch.no_grad():       # one batch's loss, chunked and whole
            labels = torch.cat([rows[:, 1:], torch.full(
                (rows.shape[0], 1), -100, dtype=rows.dtype)], dim=1)
            hidden = model(rows, return_hidden=True)
            total, count = vocab_parallel_chunked_cross_entropy(
                hidden, model.wte.t(), None, labels, 5, tp, cfg.vocab_size)
            meta["chunked_loss"] = float(total / count)
            total, count = vocab_parallel_cross_entropy(
                model.head_logits(hidden), labels, tp, cfg.vocab_size)
            meta["whole_loss"] = float(total / count)
    engine, _, _, _ = initialize(model=model, config=engine_config(case),
                                 mpu=groups, device="cpu")
    C.reset_collective_counts()
    meta["losses"] = [float(engine.train_batch({"input_ids": torch.from_numpy(
        replica_rows(x, accum, data.size, data.rank))})) for x in xs]
    meta["counts"] = C.collective_counts()
    meta["mp_world_size"] = engine.mp_world_size
    meta["shapes"] = {n: list(p.shape) for n, p in model.named_parameters()}
    state = engine._checkpoint_state_tree()["params"]
    state = {n: torch.as_tensor(t).float().clone() for n, t in state.items()}
    if cfg.scan_layers:
        state = unstack_gpt2_state_dict(state)
    out.update({f"master/{n}": t.numpy() for n, t in state.items()})
    if case.get("save"):
        engine.save_checkpoint(case["save"])
        meta["topology"] = engine._topology()
    if case.get("serve"):
        meta["tokens"] = serve_checkpoint(case["save"], groups,
                                          scan_layers=True)
    return out, meta


def serve_prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n).tolist() for n in (3, 9, 14, 6)]


def serve_checkpoint(path, mpu, scan_layers):
    """Greedy tokens of :func:`serve_prompts` served from the checkpoint
    at ``path`` by an ``InferenceEngine`` over ``mpu``'s model axis
    (None: one rank) in the given layout."""
    from deepspeed_tpu_torch.inference import (
        ContinuousBatchingScheduler, InferenceEngine, Request)
    from deepspeed_tpu_torch.inference.serve import load_checkpoint_model
    model, _ = load_checkpoint_model(path, n_head=4,
                                     scan_layers=scan_layers, mpu=mpu)
    engine = InferenceEngine(model, config={
        "max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
        "attention_impl": "flash", "attention_block_k": 8}, device="cpu")
    reqs = [Request(f"r{i}", p, max_new_tokens=6, arrival_step=i)
            for i, p in enumerate(serve_prompts())]
    done = ContinuousBatchingScheduler(engine).run(reqs)
    return {c.rid: list(map(int, c.tokens)) for c in done}


RUNNERS = {"bert_train": run_bert_train, "bert_qa": run_bert_qa,
           "gpt2_scan_train": run_gpt2_scan_train}
