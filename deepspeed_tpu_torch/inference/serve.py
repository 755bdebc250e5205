"""Serve CLI of the port: the single-replica ring path of
``ds_tpu_serve`` (``deepspeed_tpu/inference/serve.py``).

    python -m deepspeed_tpu_torch.inference.serve --synthetic 8
    python -m deepspeed_tpu_torch.inference.serve --requests stream.jsonl
    python -m deepspeed_tpu_torch.inference.serve --synthetic 4 \
        --attention flash --kv-cache-dtype int8 --expect-compiles 2 --json

The model is the test-size GPT-2 with seeded random params — the CLI
exercises and measures the serving engine, it does not ship
checkpoints. A request line is ``{"rid": "r0", "prompt": [1, 2, 3],
"max_new_tokens": 8, "eos_id": null, "arrival_step": 0}`` (only
``prompt`` required).

``--device`` picks where it runs: CUDA by default (no GPU is an
error, exit 2), ``--device cpu`` on the host. ``--expect-compiles N``
makes the exit code enforce the two-program contract (prefill +
decode signatures must total exactly N). ``--jsonl`` writes telemetry
events for ``ds_tpu_metrics summary`` serve mode.

The JAX CLI's fleet, disaggregated, paged, speculative, ``--config``,
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
                    deadline_s=d.get("deadline_s", args.deadline_s),
                    queue_timeout_s=d.get("queue_timeout_s",
                                          args.queue_timeout_s)))
        return reqs
    # synthetic open-loop stream: varied prompt lengths spanning the
    # buckets, staggered arrivals, deterministic under --seed
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.synthetic):
        plen = int(rng.integers(2, max(3, args.synthetic_max_prompt)))
        prompt = rng.integers(0, vocab_size, plen).tolist()[:max_seq - 1]
        reqs.append(Request(
            rid=f"s{i}", prompt=prompt, max_new_tokens=args.max_new,
            arrival_step=int(i * args.arrival_every),
            deadline_s=args.deadline_s,
            queue_timeout_s=args.queue_timeout_s))
    return reqs


# routes of the JAX CLI that this port does not have yet
_NOT_PORTED = ("config", "scan_layers", "kv_layout", "speculative",
               "checkpoint", "replicas", "disaggregate")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.inference.serve",
        description="run the PyTorch serving engine over a request "
                    "stream (continuous batching, ring KV cache)")
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
    parser.add_argument("--kv-layout", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--speculative", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--checkpoint", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--replicas", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--disaggregate", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    for name in _NOT_PORTED:
        value = getattr(args, name)
        if name == "kv_layout" and value == "ring":
            continue
        if name == "replicas" and value == 1:
            continue
        if value:
            parser.error(f"--{name.replace('_', '-')} is not yet ported "
                         f"to deepspeed_tpu_torch")
    if not args.requests and not args.synthetic:
        parser.error("one of --requests or --synthetic N is required")
    if args.requests and args.synthetic:
        parser.error("--requests and --synthetic are mutually exclusive")

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
                 "top_k": args.top_k, "top_p": args.top_p}
    inf_cfg.update({k: v for k, v in overrides.items() if v is not None})
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
             "bucket": c.bucket, "slot": c.slot, "steps": c.steps}
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
    ok = len(completions) == len(requests)
    if args.expect_compiles is not None:
        result["expect_compiles"] = args.expect_compiles
        ok = ok and total_compiles == args.expect_compiles
    result["ok"] = ok

    if args.as_json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        for c in completions:
            print(f"{c.rid}: prompt {c.prompt_len} tokens -> "
                  f"{len(c.tokens)} generated ({c.finish_reason}, "
                  f"bucket {c.bucket}, slot {c.slot})")
        print(f"{len(completions)}/{len(requests)} requests completed "
              f"in {sched.step_count} decode step(s) on {device}; "
              f"compiles: prefill={counts['prefill']} "
              f"decode={counts['decode']}")
        if not ok:
            if len(completions) != len(requests):
                why = "unfinished requests"
            else:
                why = (f"compile count {total_compiles} != expected "
                       f"{args.expect_compiles}")
            print(f"FAIL: {why}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
