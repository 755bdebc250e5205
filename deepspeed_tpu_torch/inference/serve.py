"""Serve CLI of the port: the single-replica ring, paged and
speculative paths of ``ds_tpu_serve`` (``deepspeed_tpu/inference/
serve.py``).

    python -m deepspeed_tpu_torch.inference.serve --synthetic 8
    python -m deepspeed_tpu_torch.inference.serve --requests stream.jsonl
    python -m deepspeed_tpu_torch.inference.serve --synthetic 4 \
        --attention flash --kv-cache-dtype int8 --expect-compiles 2 --json
    python -m deepspeed_tpu_torch.inference.serve --synthetic 6 \
        --kv-layout paged --shared-prefix 12 --expect-prefix-hits 1
    python -m deepspeed_tpu_torch.inference.serve --synthetic 6 \
        --speculative --spec-k 3 --draft-layers 1 --expect-compiles 3

The model is the test-size GPT-2 with seeded random params — the CLI
exercises and measures the serving engine, it does not ship
checkpoints. A request line is ``{"rid": "r0", "prompt": [1, 2, 3],
"max_new_tokens": 8, "eos_id": null, "arrival_step": 0}`` (only
``prompt`` required; a ``session_id`` parks the request's KV pages on
a paged engine).

``--device`` picks where it runs: CUDA by default (no GPU is an
error, exit 2), ``--device cpu`` on the host. ``--expect-compiles N``
makes the exit code enforce the program contract (prefill + decode
signatures must total exactly N: 2, or 3 with ``--speculative`` —
prefill, draft, verify, with the plain decode program at 0).
``--expect-prefix-hits`` (paged) and ``--expect-min-accepted``
(speculative) add their own gates. ``--jsonl`` writes telemetry events
for ``ds_tpu_metrics summary`` serve mode.

The JAX CLI's fleet (``--replicas`` > 1), disaggregated, ``--config``,
``--checkpoint`` and ``--scan-layers`` routes are not ported yet: they
exit 2 with "not yet ported".

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


# routes of the JAX CLI that this port does not have yet
_NOT_PORTED = ("config", "scan_layers", "checkpoint", "replicas",
               "disaggregate")


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
    # routes of the JAX CLI that are recognized but not yet ported
    parser.add_argument("--config", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--scan-layers", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--replicas", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--disaggregate", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    for name in _NOT_PORTED:
        value = getattr(args, name)
        if name == "replicas" and value == 1:
            continue
        if value:
            parser.error(f"--{name.replace('_', '-')} is not yet ported "
                         f"to deepspeed_tpu_torch")
    if not args.requests and not args.synthetic:
        parser.error("one of --requests or --synthetic N is required")
    if args.requests and args.synthetic:
        parser.error("--requests and --synthetic are mutually exclusive")
    if args.expect_min_accepted is not None and not args.speculative:
        parser.error("--expect-min-accepted requires --speculative")
    if args.spec_k < 1:
        parser.error("--spec-k must be >= 1")
    if args.draft_layers < 0:
        parser.error("--draft-layers must be >= 0 (0 = auto)")
    if args.expect_prefix_hits is not None and args.kv_layout != "paged":
        parser.error("--expect-prefix-hits requires --kv-layout paged")

    import torch

    from deepspeed_tpu_torch import resolve_device
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler)
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
    from deepspeed_tpu_torch.telemetry.session import TelemetrySession

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        parser.error(str(e))

    inf_cfg = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
               "sampling_seed": args.seed}
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

    session = None
    if args.jsonl:
        from deepspeed_tpu_torch.telemetry.exporters import JsonlExporter
        session = TelemetrySession(exporters=[JsonlExporter(args.jsonl)])

    cfg = gpt2_tiny(n_embd=32, dtype=torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = GPT2LMHead(cfg, device=device, generator=gen)
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
