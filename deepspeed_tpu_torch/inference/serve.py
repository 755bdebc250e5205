"""Serve CLI of the port: ``ds_tpu_serve`` (``deepspeed_tpu/inference/
serve.py``) over the ring, paged and speculative engine, a checkpoint,
a config file, the replica fleet and disaggregated tiers.

    python -m deepspeed_tpu_torch.inference.serve --synthetic 8
    python -m deepspeed_tpu_torch.inference.serve --requests stream.jsonl
    python -m deepspeed_tpu_torch.inference.serve --synthetic 4 \
        --attention flash --kv-cache-dtype int8 --expect-compiles 2 --json
    python -m deepspeed_tpu_torch.inference.serve --synthetic 6 \
        --kv-layout paged --shared-prefix 12 --expect-prefix-hits 1
    python -m deepspeed_tpu_torch.inference.serve --synthetic 6 \
        --speculative --spec-k 3 --draft-layers 1 --expect-compiles 3
    python -m deepspeed_tpu_torch.inference.serve --synthetic 4 \
        --config ds_config.json              # the config's inference block
    python -m deepspeed_tpu_torch.inference.serve --synthetic 4 \
        --checkpoint ckpts/run1 --n-head 12  # a training checkpoint
    python -m deepspeed_tpu_torch.inference.serve --synthetic 8 \
        --replicas 2 --kill-replica 0 --kill-at-step 3 \
        --expect-redispatch 1                # fleet with a SIGKILL
    python -m deepspeed_tpu_torch.inference.serve --synthetic 8 \
        --kv-layout paged --disaggregate --expect-compiles 2

The model is the test-size GPT-2 with seeded random params
(:func:`seeded_tiny_model`), or with ``--checkpoint`` the fp32 master
params of a checkpoint the port's training engine saved
(``runtime/resilience/checkpoint.py``; ``params`` keyed by
``GPT2LMHead`` state-dict names), its geometry read off the leaf
shapes and ``--n-head``. A request line is ``{"rid": "r0", "prompt":
[1, 2, 3], "max_new_tokens": 8, "eos_id": null, "arrival_step": 0}``
(only ``prompt`` required; a ``session_id`` parks the request's KV
pages on a paged engine).

``--config`` reads a DeepSpeed JSON config's ``inference`` block
(:class:`~deepspeed_tpu_torch.runtime.config.InferenceConfig`, with the
JAX package's checks); flags override it. ``--replicas N`` (N >= 2)
serves through the fleet router (``inference/fleet.py``,
``router.py``): process replicas (``fleet_worker.py``, one CUDA context
each) or threads (``--replica-backend thread``, one CUDA stream each).
``--disaggregate`` splits serving into a prefill tier and a decode
tier (``inference/disagg.py``) whose KV pages hand off through a
CRC-stamped file store (processes) or device-to-device (threads).
Every worker runs on ``--device``.

``--device`` picks where it runs: CUDA by default (no GPU is an
error, exit 2), ``--device cpu`` on the host. ``--expect-compiles N``
makes the exit code enforce the program contract (prefill + decode
signatures must total exactly N: 2, or 3 with ``--speculative`` —
prefill, draft, verify, with the plain decode program at 0).
``--expect-prefix-hits`` (paged) and ``--expect-min-accepted``
(speculative) add their own gates. ``--jsonl`` writes telemetry events
for ``ds_tpu_metrics summary`` serve mode.

``--expect-compiles`` applies per surviving replica with
``--replicas``, and counts distinct programs across the tiers with
``--disaggregate`` (2). ``--expect-redispatch N`` gates on the fleet
recovering. ``--scan-layers`` serves the same model with its weights
stacked (``GPT2Config.scan_layers``; a stacked KV cache, each layer's
slice fed to the decode kernels), in every mode.

Exit codes: 0 ok, 1 contract violation or unfinished requests,
2 usage errors.
"""

import argparse
import json
import sys

import numpy as np


def _build_requests(args, vocab_size, max_seq):
    from deepspeed_tpu_torch.inference.scheduler import Request
    if args.requests:
        reqs = []
        with open(args.requests) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                reqs.append(Request(
                    rid=str(d.get("rid", f"r{i}")),
                    prompt=[int(t) for t in d["prompt"]],
                    max_new_tokens=int(
                        d.get("max_new_tokens", args.max_new)),
                    eos_id=d.get("eos_id"),
                    arrival_step=int(d.get("arrival_step", 0)),
                    session_id=d.get("session_id"),
                    deadline_s=d.get("deadline_s", args.deadline_s),
                    queue_timeout_s=d.get("queue_timeout_s",
                                          args.queue_timeout_s)))
        return reqs
    # synthetic open-loop stream: varied prompt lengths spanning the
    # buckets, staggered arrivals, deterministic under --seed. With
    # --shared-prefix N every prompt opens with the same N tokens (a
    # common system prompt) so a paged engine's radix cache gets hits.
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, vocab_size, args.shared_prefix).tolist() \
        if args.shared_prefix else []
    reqs = []
    for i in range(args.synthetic):
        plen = int(rng.integers(2, max(3, args.synthetic_max_prompt)))
        tail = rng.integers(0, vocab_size, plen).tolist()
        prompt = (shared + tail)[:max_seq - 1]
        reqs.append(Request(
            rid=f"s{i}", prompt=prompt, max_new_tokens=args.max_new,
            arrival_step=int(i * args.arrival_every),
            deadline_s=args.deadline_s,
            queue_timeout_s=args.queue_timeout_s))
    return reqs


# gpt2_tiny's test vocab: the synthetic stream only needs the token
# range, so fleet and tier modes build no model in the parent
_TINY_VOCAB = 256


def seeded_tiny_model(seed, device, scan_layers=False):
    """The CLI's model: ``gpt2_tiny`` at n_embd 32 in f32, params drawn
    on ``device`` from a ``torch.Generator`` seeded with ``seed``. Fleet
    workers and tier replicas build theirs the same way, so every
    replica serves the same weights; ``scan_layers`` holds the same
    weights stacked (``models/gpt2.py:with_layout``)."""
    import torch

    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2LMHead, gpt2_tiny, with_layout)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    model = GPT2LMHead(gpt2_tiny(n_embd=32, dtype=torch.float32),
                       device=device, generator=gen)
    return with_layout(model, scan_layers)


def load_checkpoint_model(path, n_head, tag=None, scan_layers=False,
                          mpu=None):
    """A :class:`GPT2LMHead` holding a training checkpoint's fp32 master
    params (JAX ``_load_checkpoint_model``, ``serve.py:134``):
    ``(model, info)``. The geometry comes from the leaf shapes (vocab
    and width from ``wte``, positions from ``wpe``, depth from the
    ``h.<i>.`` names) and ``n_head``; the manifest's ``topology`` is
    reported. The layout converts (JAX ``serve.py:173-176``; the round
    trip is bit-exact): a per-layer checkpoint serves as
    ``scan_layers`` and a stacked one unrolled. The model is built on
    the host: the serving engine moves it to its device. Raises ``ValueError`` for a missing checkpoint,
    one with no ``params``, or a head count that does not divide the
    width. A checkpoint of a model-parallel run records its
    ``mesh_shape`` (JAX ``serve.py:166-171``); the port saves its leaves
    whole, so it serves at any model size: ``mpu`` with a model axis of
    M > 1 ranks builds this rank's shard of either layout
    (``models/gpt2.py:shard_gpt2_state_dict``), which an
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine` serves
    with a cache of its ``n_head / M`` heads."""
    import re

    import torch

    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2Config, GPT2LMHead, shard_gpt2_state_dict,
        stack_gpt2_state_dict, unstack_gpt2_state_dict)
    from deepspeed_tpu_torch.parallel.mesh import model_axis_of
    from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
        CheckpointCorruptError,
        CheckpointManager,
    )

    mgr = CheckpointManager()
    try:
        tag = mgr.resolve_tag(path, tag)
        if tag is None:
            raise ValueError(f"no valid checkpoint under {path}")
        state, _, ckpt = mgr.load(path, tag)
    except CheckpointCorruptError as e:
        raise ValueError(str(e)) from e
    if "params" not in state:
        raise ValueError(f"checkpoint {ckpt} carries no 'params'")
    topo = mgr.validate(ckpt).get("topology") or {}
    saved_tp = int((topo.get("mesh_shape") or {}).get("model", 1) or 1)
    if saved_tp > 1:
        print(f"note: checkpoint {tag} was saved on a model-parallel "
              f"mesh (model axis {saved_tp}); its leaves are saved "
              f"whole and serve as they are", file=sys.stderr)
    params = {k: torch.as_tensor(np.asarray(v, np.float32)
                                 if not torch.is_tensor(v) else v.float())
              for k, v in state["params"].items()}
    params = unstack_gpt2_state_dict(params)
    wte, wpe = params["wte"], params["wpe"]
    n_layer = len({int(m.group(1)) for k in params
                   for m in [re.match(r"^h\.(\d+)\.", k)] if m})
    n_embd = int(wte.shape[1])
    if n_embd % n_head:
        raise ValueError(f"--n-head {n_head} does not divide the "
                         f"checkpoint's n_embd {n_embd}")
    cfg = GPT2Config(vocab_size=int(wte.shape[0]),
                     n_positions=int(wpe.shape[0]), n_embd=n_embd,
                     n_layer=n_layer, n_head=n_head, dropout=0.0,
                     dtype=torch.float32, param_dtype=torch.float32,
                     scan_layers=bool(scan_layers))
    model = GPT2LMHead(cfg, device="cpu", mpu=mpu)
    if scan_layers:
        params = stack_gpt2_state_dict(params)
    tp = model_axis_of(mpu)
    model.load_state_dict(shard_gpt2_state_dict(params, tp.rank, tp.size,
                                                cfg.vocab_size))
    info = {"tag": tag, "path": ckpt, "n_layer": n_layer,
            "n_embd": n_embd, "vocab_size": cfg.vocab_size,
            "topology": topo}
    return model, info


def _config_inference(path):
    """The ``inference`` block of a DeepSpeed JSON config as the
    engine's config dict (JAX ``serve.py:834-869``)."""
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    with open(path) as f:
        raw = json.load(f)
    # a serving config need not carry training batch sizes: give the
    # validator trivial ones (world size 1) so only the block matters
    raw.setdefault("train_batch_size", 1)
    raw.setdefault("train_micro_batch_size_per_gpu", 1)
    inf = DeepSpeedConfig(raw, world_size=1).inference
    keys = ("max_batch", "seq_buckets", "prefill_chunk", "kv_cache_dtype",
            "max_new_tokens", "attention_impl", "attention_block_k",
            "temperature", "top_k", "top_p", "sampling_seed", "kv_layout",
            "page_size", "n_pages", "prefix_cache", "host_park_threshold",
            "replicas", "max_redispatch", "max_queue_depth", "deadline_s",
            "queue_timeout_s", "speculative", "disaggregated",
            "prefill_workers", "decode_workers", "prefill_max_batch",
            "decode_max_batch")
    return {k: getattr(inf, k) for k in keys}


def _check_args(parser, args):
    """The flag checks of the JAX CLI (``serve.py:702-815``)."""
    if not args.requests and not args.synthetic:
        parser.error("one of --requests or --synthetic N is required")
    if args.requests and args.synthetic:
        parser.error("--requests and --synthetic are mutually exclusive")
    if args.replicas < 1:
        parser.error("--replicas must be >= 1")
    if args.replicas == 1 and args.kill_replica is not None:
        parser.error("--kill-replica requires --replicas >= 2 (use "
                     "--kill-prefill-worker with --disaggregate)")
    if args.replicas == 1 and args.expect_redispatch is not None \
            and not args.disaggregate:
        parser.error("--expect-redispatch requires --replicas >= 2 "
                     "or --disaggregate")
    if args.disaggregate:
        if args.speculative:
            parser.error("--disaggregate excludes --speculative (the "
                         "draft/verify pair would break the one-"
                         "program-per-tier contract)")
        if args.replicas > 1:
            parser.error("--disaggregate and --replicas are mutually "
                         "exclusive; tiers scale via "
                         "--prefill-workers/--decode-workers")
    if args.kill_prefill_worker is not None:
        if not args.disaggregate:
            parser.error("--kill-prefill-worker requires --disaggregate")
        if args.replica_backend != "process":
            parser.error("--kill-prefill-worker needs --replica-backend "
                         "process (a thread cannot be SIGKILLed in "
                         "isolation)")
    for name in ("prefill_workers", "decode_workers"):
        v = getattr(args, name)
        if v is not None and v < 1:
            parser.error(f"--{name.replace('_', '-')} must be >= 1")
    if args.kill_replica is not None and \
            not 0 <= args.kill_replica < args.replicas:
        parser.error(f"--kill-replica {args.kill_replica} outside "
                     f"0..{args.replicas - 1}")
    if args.kill_replica is not None and \
            args.replica_backend != "process":
        parser.error("--kill-replica needs --replica-backend process "
                     "(a thread cannot be SIGKILLed in isolation)")
    if args.speculative and args.replicas > 1:
        parser.error("--speculative is single-replica only (the fleet "
                     "router has no variable-tokens-per-step protocol "
                     "yet)")
    if args.expect_min_accepted is not None and not args.speculative:
        parser.error("--expect-min-accepted requires --speculative")
    if args.spec_k < 1:
        parser.error("--spec-k must be >= 1")
    if args.draft_layers < 0:
        parser.error("--draft-layers must be >= 0 (0 = auto)")
    if args.n_head < 1:
        parser.error("--n-head must be >= 1")


def _wire_cfg(cfg):
    """An engine config as JSON for a worker's spec."""
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in cfg.items()}


def _router_bounds(args, inf_cfg):
    return dict(
        max_redispatch=(args.max_redispatch
                        if args.max_redispatch is not None
                        else int(inf_cfg.get("max_redispatch", 2))),
        max_queue_depth=(args.max_queue_depth
                         if args.max_queue_depth is not None
                         else int(inf_cfg.get("max_queue_depth", 8))),
        max_pending=args.max_pending)


def _ms(v):
    return "n/a" if v is None else f"{v * 1e3:.1f}ms"


def _run_fleet(args, inf_cfg, session, device):
    """Serve through the N-replica fleet router (JAX ``serve.py:203``)."""
    import os
    import tempfile

    from deepspeed_tpu_torch.inference import fleet as fleet_mod
    from deepspeed_tpu_torch.inference.router import FleetRouter

    workdir = os.path.abspath(
        args.workdir or tempfile.mkdtemp(prefix="ds-torch-fleet-"))
    max_seq = max(inf_cfg.get("seq_buckets", (16, 32)))
    requests = _build_requests(args, _TINY_VOCAB, max_seq)
    inject = None
    if args.kill_replica is not None:
        inject = {"kill": {"op": "decode_step",
                           "at_step": args.kill_at_step}}
    spec = {"inf_cfg": _wire_cfg(inf_cfg), "seed": args.seed,
            "device": str(device), "scan_layers": args.scan_layers}
    if args.replica_backend == "process":
        replicas = []
        for i in range(args.replicas):
            rspec = dict(spec, jsonl=os.path.join(
                workdir, f"replica{i}.jsonl"))
            replicas.append(fleet_mod.ProcessReplica(
                i, rspec, workdir, num_replicas=args.replicas,
                inject=inject if i == args.kill_replica else None,
                hang_timeout_s=args.hang_timeout_s,
                heartbeat_stale_s=args.heartbeat_stale_s).start())
        for r in replicas:
            r.wait_ready()
    else:
        from deepspeed_tpu_torch.inference.engine import InferenceEngine

        def factory():
            return InferenceEngine(
                seeded_tiny_model(args.seed, device, args.scan_layers),
                config=inf_cfg, device=device)

        replicas = [fleet_mod.ThreadReplica(i, factory).start()
                    for i in range(args.replicas)]
    router = FleetRouter(replicas, session=session,
                         **_router_bounds(args, inf_cfg))
    fr = router.run(requests, timeout_s=args.fleet_timeout)

    ok = fr.ok
    compiles_bad = []
    if args.expect_compiles is not None:
        for st in fr.stats:
            total = sum(n for n in st["compile_counts"].values()
                        if n is not None)
            if total != args.expect_compiles:
                compiles_bad.append((st["replica"], total))
        ok = ok and not compiles_bad
    redisp_ok = True
    if args.expect_redispatch is not None:
        redisp_ok = fr.redispatched_total >= args.expect_redispatch
        ok = ok and redisp_ok
    result = {
        "requests": len(requests),
        "completions": fr.completions,
        "fleet": {
            "replicas": fr.replicas, "backend": args.replica_backend,
            "replicas_dead": fr.replicas_dead,
            "dead_causes": dict(router.dead),
            "redispatched_total": fr.redispatched_total,
            "aborted": fr.aborted, "shed": fr.shed,
            "defers": fr.defers, "timeouts": fr.timeouts,
            "latency_s": fr.latency_s, "stats": fr.stats,
            "workdir": workdir},
        "device": str(device),
        "ok": ok,
    }
    if args.expect_compiles is not None:
        result["expect_compiles"] = args.expect_compiles
    if args.expect_redispatch is not None:
        result["expect_redispatch"] = args.expect_redispatch
    if args.as_json:
        print(json.dumps(result, indent=2, sort_keys=True))
        return 0 if ok else 1
    for c in fr.completions:
        extra = f", redispatched x{c['redispatched']}" \
            if c["redispatched"] else ""
        print(f"{c['rid']}: prompt {c['prompt_len']} tokens -> "
              f"{len(c['tokens'])} generated ({c['finish_reason']}, "
              f"replica {c['replica']}{extra})")
    fl = result["fleet"]
    print(f"{len(fr.completions)}/{len(requests)} requests completed on "
          f"{fl['replicas']} replica(s) ({fl['replicas_dead']} died: "
          f"{fl['dead_causes']}); redispatched="
          f"{fl['redispatched_total']} aborted={fl['aborted']} "
          f"shed={fl['shed']} timeouts={fl['timeouts']}; latency "
          f"p50={_ms(fr.latency_s['p50'])} p99={_ms(fr.latency_s['p99'])}")
    for st in fr.stats:
        cc = st["compile_counts"]
        print(f"replica {st['replica']}: {st['completed']} completed in "
              f"{st['steps']} step(s); compiles: "
              f"prefill={cc.get('prefill')} decode={cc.get('decode')}")
    if not ok:
        if compiles_bad:
            why = (f"replica compile counts {compiles_bad} != expected "
                   f"{args.expect_compiles}")
        elif not redisp_ok:
            why = (f"redispatched {fr.redispatched_total} < expected "
                   f"{args.expect_redispatch}")
        else:
            why = ("unfinished/aborted/shed/timed-out requests in the "
                   "fleet result")
        print(f"FAIL: {why}", file=sys.stderr)
    return 0 if ok else 1


def _run_disagg(args, inf_cfg, session, device):
    """Serve through disaggregated prefill/decode tiers (JAX
    ``serve.py:338``). Each tier holds one program from warmup to
    drain, so the fleet holds 2 whatever the worker counts. Process
    tiers hand KV off through a durable ``FileHandoffStore`` under
    ``workdir/handoff``; thread tiers through the consume-once
    device-to-device ``DeviceHandoffStore``."""
    import os
    import tempfile

    from deepspeed_tpu_torch.inference import fleet as fleet_mod
    from deepspeed_tpu_torch.inference.router import DisaggRouter

    workdir = os.path.abspath(
        args.workdir or tempfile.mkdtemp(prefix="ds-torch-disagg-"))
    max_seq = max(inf_cfg.get("seq_buckets", (16, 32)))
    requests = _build_requests(args, _TINY_VOCAB, max_seq)
    n_pre, n_dec = args.prefill_workers, args.decode_workers

    def tier_inf(tier):
        # tiers scale max_batch independently (0 / unset: the shared)
        cfg = {k: v for k, v in inf_cfg.items()
               if k not in ("disaggregated", "prefill_workers",
                            "decode_workers", "prefill_max_batch",
                            "decode_max_batch")}
        mb = (args.prefill_max_batch if tier == "prefill"
              else args.decode_max_batch)
        if mb is None:
            mb = int(inf_cfg.get(f"{tier}_max_batch", 0) or 0)
        if mb:
            cfg["max_batch"] = mb
        return cfg

    inject = None
    if args.kill_prefill_worker is not None:
        inject = {"kill": {"op": "prefill_chunk",
                           "at_step": args.kill_at_step}}
    if args.replica_backend == "process":
        from deepspeed_tpu_torch.inference.disagg import FileHandoffStore
        handoff_dir = os.path.join(workdir, "handoff")
        # the router shares the workers' durable store: parked() and
        # drop() are file probes, so recovery needs no device state here
        store = FileHandoffStore(handoff_dir)

        def spawn(i, tier, tag, inj):
            rspec = {"inf_cfg": _wire_cfg(tier_inf(tier)),
                     "seed": args.seed, "device": str(device),
                     "scan_layers": args.scan_layers,
                     "tier": tier, "handoff_dir": handoff_dir,
                     "jsonl": os.path.join(workdir, f"{tag}.jsonl")}
            return fleet_mod.TierProcessReplica(
                i, rspec, workdir, num_replicas=n_pre + n_dec,
                inject=inj, hang_timeout_s=args.hang_timeout_s,
                heartbeat_stale_s=args.heartbeat_stale_s).start()

        # indices unique across tiers: prefill 0..N-1, decode N..N+M-1
        prefill = [spawn(i, "prefill", f"prefill{i}",
                         inject if i == args.kill_prefill_worker
                         else None) for i in range(n_pre)]
        decode = [spawn(n_pre + j, "decode", f"decode{j}", None)
                  for j in range(n_dec)]
        for r in prefill + decode:
            r.wait_ready()
    else:
        from deepspeed_tpu_torch.inference.disagg import (
            DecodeWorker,
            DeviceHandoffStore,
            PrefillWorker,
        )
        from deepspeed_tpu_torch.inference.engine import InferenceEngine
        store = DeviceHandoffStore()

        def make_factory(tier):
            cfg_t = dict(tier_inf(tier), tier=tier)

            def factory():
                engine = InferenceEngine(
                    seeded_tiny_model(args.seed, device, args.scan_layers),
                    config=cfg_t,
                    device=device)
                cls = PrefillWorker if tier == "prefill" \
                    else DecodeWorker
                return cls(engine, store)
            return factory

        prefill = [fleet_mod.TierThreadReplica(
            i, make_factory("prefill")).start() for i in range(n_pre)]
        decode = [fleet_mod.TierThreadReplica(
            n_pre + j, make_factory("decode")).start()
            for j in range(n_dec)]
    router = DisaggRouter(prefill, decode, store, session=session,
                          **_router_bounds(args, inf_cfg))
    fr = router.run(requests, timeout_s=args.fleet_timeout)

    # every surviving worker holds exactly its own tier's program
    pins = {"prefill": {"prefill": 1, "decode": 0},
            "decode": {"prefill": 0, "decode": 1}}
    tier_bad, programs = [], set()
    for st in fr.stats:
        cc = st.get("compile_counts") or {}
        got = {"prefill": cc.get("prefill") or 0,
               "decode": cc.get("decode") or 0}
        programs.update(k for k, v in got.items() if v)
        if got != pins[st["tier"]]:
            tier_bad.append((st["replica"], st["tier"], got))
    total_compiles = len(programs)
    ok = fr.ok and not tier_bad
    compiles_ok = True
    if args.expect_compiles is not None:
        compiles_ok = total_compiles == args.expect_compiles
        ok = ok and compiles_ok
    redisp_ok = True
    if args.expect_redispatch is not None:
        redisp_ok = fr.redispatched_total >= args.expect_redispatch
        ok = ok and redisp_ok
    result = {
        "requests": len(requests),
        "completions": fr.completions,
        "disagg": {
            "backend": args.replica_backend,
            "prefill_workers": fr.prefill_replicas,
            "decode_workers": fr.decode_replicas,
            "replicas_dead": fr.replicas_dead,
            "dead_by_tier": fr.dead_by_tier,
            "dead_causes": dict(router.dead),
            "redispatched_total": fr.redispatched_total,
            "aborted": fr.aborted, "shed": fr.shed,
            "defers": fr.defers, "timeouts": fr.timeouts,
            "handoffs": fr.handoffs,
            "handoff_bytes": fr.handoff_bytes,
            "handoff_bytes_per_session": (
                fr.handoff_bytes / fr.handoffs if fr.handoffs else 0.0),
            "handoff_corrupt": fr.handoff_corrupt,
            "resumed_from_park": fr.resumed_from_park,
            "latency_s": fr.latency_s, "ttft_s": fr.ttft_s,
            "total_compiles": total_compiles,
            "stats": fr.stats, "workdir": workdir},
        "device": str(device),
        "ok": ok,
    }
    if args.expect_compiles is not None:
        result["expect_compiles"] = args.expect_compiles
    if args.expect_redispatch is not None:
        result["expect_redispatch"] = args.expect_redispatch
    if args.as_json:
        print(json.dumps(result, indent=2, sort_keys=True))
        return 0 if ok else 1
    for c in fr.completions:
        extra = ""
        if c.get("redispatched"):
            extra += f", redispatched x{c['redispatched']}"
        if c.get("restarts"):
            extra += f", re-prefilled x{c['restarts']}"
        print(f"{c['rid']}: prompt {c['prompt_len']} tokens -> "
              f"{len(c['tokens'])} generated ({c['finish_reason']}, "
              f"replica {c['replica']}{extra})")
    dg = result["disagg"]
    print(f"{len(fr.completions)}/{len(requests)} requests completed "
          f"across {dg['prefill_workers']}+{dg['decode_workers']} tiered "
          f"worker(s) ({dg['replicas_dead']} died: "
          f"{dg['dead_causes']}); redispatched="
          f"{dg['redispatched_total']} aborted={dg['aborted']} "
          f"timeouts={dg['timeouts']}")
    tt, lat = fr.ttft_s, fr.latency_s
    print(f"handoff: {dg['handoffs']} session(s), {dg['handoff_bytes']} "
          f"byte(s) ({dg['handoff_bytes_per_session']:.0f}/session), "
          f"corrupt={dg['handoff_corrupt']} resumed_from_park="
          f"{dg['resumed_from_park']}; ttft p50={_ms(tt['p50'])} "
          f"p99={_ms(tt['p99'])}; latency p99={_ms(lat['p99'])}; "
          f"programs {total_compiles}")
    if not ok:
        if tier_bad:
            why = (f"per-tier program pins violated: {tier_bad} (each "
                   f"worker must hold exactly its own tier's program)")
        elif not compiles_ok:
            why = (f"fleet program total {total_compiles} != expected "
                   f"{args.expect_compiles}")
        elif not redisp_ok:
            why = (f"redispatched {fr.redispatched_total} < expected "
                   f"{args.expect_redispatch}")
        else:
            why = ("unfinished/aborted/shed/timed-out requests in the "
                   "disaggregated result")
        print(f"FAIL: {why}", file=sys.stderr)
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.inference.serve",
        description="run the PyTorch serving engine over a request "
                    "stream (continuous batching, ring or paged KV cache, "
                    "optional self-speculative decoding)")
    parser.add_argument("--device", default=None,
                        help="cuda (default; exit 2 without a GPU) or cpu")
    parser.add_argument("--kv-cache-dtype", default=None,
                        help="cache storage: bf16, f32, or a codec name "
                             "(int8, f8e4m3fn, f8e5m2)")
    parser.add_argument("--max-batch", type=int, default=None,
                        help="override inference.max_batch")
    parser.add_argument("--seq-buckets", default=None,
                        help="override inference.seq_buckets, e.g. 16,32")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="override inference.prefill_chunk")
    parser.add_argument("--attention", default=None,
                        choices=("dense", "flash"),
                        help="decode attention: dense softmax or the "
                             "flash-decode kernel")
    parser.add_argument("--block-k", type=int, default=None,
                        help="flash-decode KV block size (must divide "
                             "max(seq_buckets))")
    parser.add_argument("--kv-layout", default=None,
                        choices=("ring", "paged"),
                        help="KV cache layout: per-row ring buffers or "
                             "the paged pool with radix prefix sharing")
    parser.add_argument("--page-size", type=int, default=None,
                        help="paged layout: tokens per KV page (0 = "
                             "auto; must be a multiple of "
                             "prefill_chunk and divide max seq bucket)")
    parser.add_argument("--n-pages", type=int, default=None,
                        help="paged layout: physical pool pages "
                             "(0 = auto; page 0 is the trash page)")
    parser.add_argument("--prefix-cache", dest="prefix_cache",
                        action="store_true", default=None,
                        help="paged layout: intern finished prompts in "
                             "the radix prefix cache (default on)")
    parser.add_argument("--no-prefix-cache", dest="prefix_cache",
                        action="store_false",
                        help="paged layout: disable prefix sharing")
    parser.add_argument("--park-threshold", type=float, default=None,
                        help="paged layout: evacuate parked sessions "
                             "to host RAM when the free-page fraction "
                             "drops below this (0 disables)")
    parser.add_argument("--shared-prefix", type=int, default=0,
                        help="synthetic stream: open every prompt with "
                             "the same N tokens (a shared system "
                             "prompt) to exercise the prefix cache")
    parser.add_argument("--expect-prefix-hits", type=int, default=None,
                        help="exit 1 unless the paged prefix cache "
                             "recorded at least this many hits")
    parser.add_argument("--speculative", action="store_true",
                        help="self-speculative decoding: draft k "
                             "tokens through the first draft_layers "
                             "blocks, verify all of them in one "
                             "full-depth forward")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="draft window: tokens drafted per verify "
                             "round (>= 1)")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="transformer blocks the draft pass runs "
                             "(0 = auto n_layer // 2)")
    parser.add_argument("--min-accept-to-grow", type=float, default=0.0,
                        help="adaptive draft length: grow the window "
                             "when mean accepted drafts/round clears "
                             "this, shrink when it doesn't (0 = fixed "
                             "window)")
    parser.add_argument("--expect-min-accepted", type=float,
                        default=None,
                        help="exit 1 unless mean accepted tokens per "
                             "speculative round clears this")
    parser.add_argument("--temperature", type=float, default=None,
                        help="sampling temperature (0 = greedy argmax, "
                             "the default)")
    parser.add_argument("--top-k", type=int, default=None,
                        help="keep only the k most likely tokens "
                             "(0 = disabled)")
    parser.add_argument("--top-p", type=float, default=None,
                        help="nucleus sampling mass (1.0 = disabled)")
    parser.add_argument("--requests", default=None,
                        help="JSONL request stream (one request/line)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic open-loop requests")
    parser.add_argument("--synthetic-max-prompt", type=int, default=24,
                        help="synthetic prompt length upper bound")
    parser.add_argument("--arrival-every", type=float, default=1.0,
                        help="synthetic arrival spacing in decode steps")
    parser.add_argument("--max-new", type=int, default=8,
                        help="default max_new_tokens per request")
    parser.add_argument("--seed", type=int, default=0,
                        help="params + synthetic stream + sampling seed")
    parser.add_argument("--deadline-s", type=float, default=None,
                        help="per-request total wall-clock deadline")
    parser.add_argument("--queue-timeout-s", type=float, default=None,
                        help="per-request bound on queue wait")
    parser.add_argument("--expect-compiles", type=int, default=None,
                        help="exit 1 unless prefill + decode program "
                             "signatures total exactly this")
    parser.add_argument("--jsonl", default=None,
                        help="write decode_step telemetry events here")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the result dict as JSON")
    parser.add_argument("--config", default=None,
                        help="DeepSpeed-style JSON config; its "
                             "'inference' block configures the engine")
    parser.add_argument("--checkpoint", default=None,
                        help="serve the params of this training "
                             "checkpoint dir instead of seeded random "
                             "weights")
    parser.add_argument("--ckpt-tag", default=None,
                        help="checkpoint tag to load (default: the "
                             "newest valid one)")
    parser.add_argument("--n-head", type=int, default=4,
                        help="attention heads for --checkpoint serving "
                             "(not recoverable from param shapes)")
    # -- fleet ---------------------------------------------------------
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve through an N-replica fleet behind "
                             "the admission router (N >= 2)")
    parser.add_argument("--replica-backend", default="process",
                        choices=("process", "thread"),
                        help="fleet replicas: subprocess workers "
                             "(SIGKILL-able) or in-process threads")
    parser.add_argument("--workdir", default=None,
                        help="fleet workdir (heartbeats, done markers, "
                             "replica logs); default: a temp dir")
    parser.add_argument("--max-redispatch", type=int, default=None,
                        help="redispatches before a request aborts")
    parser.add_argument("--max-queue-depth", type=int, default=None,
                        help="per-replica in-flight bound (the router "
                             "defers past it)")
    parser.add_argument("--max-pending", type=int, default=None,
                        help="global admission bound (the router sheds "
                             "past it)")
    parser.add_argument("--fleet-timeout", type=float, default=300.0,
                        help="whole-fleet drive-loop wall bound")
    parser.add_argument("--hang-timeout-s", type=float, default=None,
                        help="replica heartbeat stuck-in-step bound")
    parser.add_argument("--heartbeat-stale-s", type=float, default=None,
                        help="replica heartbeat staleness bound")
    parser.add_argument("--kill-replica", type=int, default=None,
                        help="arm a SIGKILL fault in this replica index")
    parser.add_argument("--kill-at-step", type=int, default=3,
                        help="decode step the armed kill fires at")
    parser.add_argument("--expect-redispatch", type=int, default=None,
                        help="exit 1 unless the fleet redispatched at "
                             "least this many requests")
    # -- disaggregated prefill/decode tiers ----------------------------
    parser.add_argument("--disaggregate", action="store_true",
                        help="split serving into a prefill tier and a "
                             "decode tier (one program each; KV pages "
                             "hand off between tiers)")
    parser.add_argument("--prefill-workers", type=int, default=None,
                        help="prefill-tier worker count (default from "
                             "config, else 1)")
    parser.add_argument("--decode-workers", type=int, default=None,
                        help="decode-tier worker count (default from "
                             "config, else 1)")
    parser.add_argument("--prefill-max-batch", type=int, default=None,
                        help="prefill-tier max_batch (0/unset = shared)")
    parser.add_argument("--decode-max-batch", type=int, default=None,
                        help="decode-tier max_batch (0/unset = shared)")
    parser.add_argument("--kill-prefill-worker", type=int, default=None,
                        help="arm a SIGKILL mid-prefill-chunk in this "
                             "prefill-tier worker (process backend)")
    parser.add_argument("--scan-layers", action="store_true",
                        help="serve the scan_layers model variant (the "
                             "same weights stacked; stacked KV cache)")
    args = parser.parse_args(argv)
    _check_args(parser, args)

    from deepspeed_tpu_torch import resolve_device
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler)
    from deepspeed_tpu_torch.telemetry.session import TelemetrySession

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        parser.error(str(e))

    inf_cfg = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4}
    if args.config:
        try:
            inf_cfg = _config_inference(args.config)
        except (OSError, ValueError) as e:
            parser.error(f"--config {args.config}: {e}")
    overrides = {"max_batch": args.max_batch,
                 "prefill_chunk": args.prefill_chunk,
                 "kv_cache_dtype": args.kv_cache_dtype,
                 "attention_impl": args.attention,
                 "attention_block_k": args.block_k,
                 "temperature": args.temperature,
                 "top_k": args.top_k, "top_p": args.top_p,
                 "kv_layout": args.kv_layout, "page_size": args.page_size,
                 "n_pages": args.n_pages,
                 "prefix_cache": args.prefix_cache,
                 "host_park_threshold": args.park_threshold}
    inf_cfg.update({k: v for k, v in overrides.items() if v is not None})
    if args.speculative:
        inf_cfg["speculative"] = {
            "enabled": True, "k": args.spec_k,
            "draft_layers": args.draft_layers,
            "min_accept_to_grow": args.min_accept_to_grow}
    if args.seq_buckets is not None:
        inf_cfg["seq_buckets"] = tuple(
            int(b) for b in args.seq_buckets.split(",") if b.strip())
    if args.expect_prefix_hits is not None and \
            inf_cfg.get("kv_layout", "ring") != "paged":
        parser.error("--expect-prefix-hits requires --kv-layout paged")
    # --seed doubles as the sampling seed (a non-default --seed beats
    # the config's)
    if args.seed != 0 or "sampling_seed" not in inf_cfg:
        inf_cfg["sampling_seed"] = args.seed

    session = None
    if args.jsonl:
        from deepspeed_tpu_torch.telemetry.exporters import JsonlExporter
        session = TelemetrySession(exporters=[JsonlExporter(args.jsonl)])

    # the config's fleet / deadline knobs apply where the flags stay at
    # their defaults (0 in the config block means disabled)
    args.replicas = max(args.replicas,
                        int(inf_cfg.get("replicas", 1) or 1))
    if args.deadline_s is None:
        args.deadline_s = inf_cfg.get("deadline_s") or None
    if args.queue_timeout_s is None:
        args.queue_timeout_s = inf_cfg.get("queue_timeout_s") or None
    args.disaggregate = args.disaggregate or \
        bool(inf_cfg.get("disaggregated"))
    if args.disaggregate:
        if inf_cfg.get("kv_layout", "ring") != "paged":
            parser.error("--disaggregate requires --kv-layout paged (the "
                         "prefill->decode handoff is a KV page copy)")
        if inf_cfg.get("speculative"):
            parser.error("config enables speculative decoding but the "
                         "serve is disaggregated; the tiers pin one "
                         "program each")
        if args.checkpoint:
            parser.error("--disaggregate serves the seeded test model "
                         "only (no --checkpoint)")
        if args.prefill_workers is None:
            args.prefill_workers = int(
                inf_cfg.get("prefill_workers", 1) or 1)
        if args.decode_workers is None:
            args.decode_workers = int(
                inf_cfg.get("decode_workers", 1) or 1)
        if args.kill_prefill_worker is not None and not \
                0 <= args.kill_prefill_worker < args.prefill_workers:
            parser.error(f"--kill-prefill-worker "
                         f"{args.kill_prefill_worker} outside "
                         f"0..{args.prefill_workers - 1}")
        return _run_disagg(args, inf_cfg, session, device)
    if args.replicas > 1:
        if inf_cfg.get("speculative"):
            parser.error("config enables speculative decoding but the "
                         "serve is fleet-mode; run single-replica")
        if args.checkpoint:
            parser.error("--checkpoint serving is single-replica only")
        return _run_fleet(args, inf_cfg, session, device)

    ckpt_info = None
    if args.checkpoint:
        try:
            model, ckpt_info = load_checkpoint_model(
                args.checkpoint, args.n_head, args.ckpt_tag,
                args.scan_layers)
        except ValueError as e:
            parser.error(f"--checkpoint: {e}")
    else:
        model = seeded_tiny_model(args.seed, device, args.scan_layers)
    cfg = model.config
    try:
        engine = InferenceEngine(model, config=inf_cfg, session=session,
                                 device=device)
    except ValueError as e:
        parser.error(str(e))
    sched = ContinuousBatchingScheduler(engine)
    requests = _build_requests(args, cfg.vocab_size, engine.max_seq)
    completions = sched.run(requests)
    if session is not None:
        session.close()

    counts = engine.compile_counts()
    total_compiles = sum(counts.values())
    result = {
        "requests": len(requests),
        "completions": [
            {"rid": c.rid, "prompt_len": c.prompt_len,
             "tokens": c.tokens, "finish_reason": c.finish_reason,
             "bucket": c.bucket, "slot": c.slot, "steps": c.steps,
             "prefix_hit": c.prefix_hit, "resumed": c.resumed,
             "prefill_chunks": c.prefill_chunks,
             "prefill_chunks_skipped": c.prefill_chunks_skipped}
            for c in completions],
        "decode_steps": sched.step_count,
        "compile_counts": counts,
        "cache": engine.cache_facts(),
        "attention": {"impl": engine.attention_impl,
                      "block_k": engine.attention_block_k},
        "sampling": {"temperature": engine.temperature,
                     "top_k": engine.top_k, "top_p": engine.top_p,
                     "seed": engine.sampling_seed},
        "device": str(device),
    }
    if sched.paging is not None:
        result["paging"] = sched.paging.facts()
    if engine.speculative is not None:
        result["speculative"] = engine.speculative.facts()
    if ckpt_info is not None:
        result["checkpoint"] = ckpt_info
    ok = len(completions) == len(requests)
    if args.expect_compiles is not None:
        result["expect_compiles"] = args.expect_compiles
        ok = ok and total_compiles == args.expect_compiles
    prefix_hits_ok = True
    if args.expect_prefix_hits is not None:
        hits = result["paging"]["prefix_hits"]
        result["expect_prefix_hits"] = args.expect_prefix_hits
        prefix_hits_ok = hits >= args.expect_prefix_hits
        ok = ok and prefix_hits_ok
    accepted_ok = True
    if args.expect_min_accepted is not None:
        mean_acc = result["speculative"]["mean_accepted"]
        result["expect_min_accepted"] = args.expect_min_accepted
        accepted_ok = mean_acc >= args.expect_min_accepted
        ok = ok and accepted_ok
    result["ok"] = ok

    if args.as_json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        for c in completions:
            extra = ""
            if c.prefix_hit or c.resumed:
                kind = "resumed" if c.resumed else "prefix hit"
                extra = (f", {kind}: skipped "
                         f"{c.prefill_chunks_skipped} prefill chunk(s)")
            print(f"{c.rid}: prompt {c.prompt_len} tokens -> "
                  f"{len(c.tokens)} generated ({c.finish_reason}, "
                  f"bucket {c.bucket}, slot {c.slot}{extra})")
        compiles = (f"prefill={counts['prefill']} "
                    f"decode={counts['decode']}")
        if engine.speculative is not None:
            compiles += (f" draft={counts['draft']} "
                         f"verify={counts['verify']}")
        print(f"{len(completions)}/{len(requests)} requests completed "
              f"in {sched.step_count} decode step(s) on {device}; "
              f"compiles: {compiles}")
        if ckpt_info is not None:
            print(f"checkpoint: tag {ckpt_info['tag']} "
                  f"({ckpt_info['n_layer']}L/{ckpt_info['n_embd']}d, "
                  f"vocab {ckpt_info['vocab_size']}, saved topology "
                  f"{ckpt_info['topology']})")
        if engine.speculative is not None:
            sp = result["speculative"]
            print(f"speculative: k={sp['k']} "
                  f"draft_layers={sp['draft_layers']}/{sp['n_layer']}, "
                  f"mean accepted {sp['mean_accepted']:.3f} "
                  f"tokens/round over {sp['row_rounds']} row-round(s), "
                  f"draft efficiency {sp['draft_efficiency']:.3f}")
        if sched.paging is not None:
            pg = result["paging"]
            print(f"paged KV: {pg['pages_resident']}/{pg['n_pages']} "
                  f"pages resident, prefix hits {pg['prefix_hits']}/"
                  f"misses {pg['prefix_misses']}, host-parked "
                  f"{pg['sessions_parked_host']} session(s)")
        if not ok:
            if len(completions) != len(requests):
                why = "unfinished requests"
            elif not prefix_hits_ok:
                why = (f"prefix hits "
                       f"{result['paging']['prefix_hits']} < expected "
                       f"{args.expect_prefix_hits}")
            elif not accepted_ok:
                why = (f"mean accepted "
                       f"{result['speculative']['mean_accepted']:.3f} "
                       f"< expected {args.expect_min_accepted}")
            else:
                why = (f"compile count {total_compiles} != expected "
                       f"{args.expect_compiles}")
            print(f"FAIL: {why}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
