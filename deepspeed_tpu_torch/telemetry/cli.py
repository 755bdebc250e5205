"""``ds_tpu_metrics`` for the port: tail / summarize / diff / aggregate
telemetry JSONL logs, and render flight-recorder postmortems (port of
``deepspeed_tpu/telemetry/cli.py``)::

    python -m deepspeed_tpu_torch.telemetry.cli summary run.jsonl

The event schema (``ds-tpu-telemetry/1``) and the flight-dump schema are
the JAX package's, so this CLI reads a log or dump either package wrote,
and gives the JAX CLI's output for the same log and flags. Five
subcommands over the log a run writes when ``telemetry.jsonl_path`` is
set:

- ``summary LOG``: step count, wall time, step-time stats (mean / p50 /
  p95), the per-phase breakdown with shares, tokens/sec, and an MFU
  estimate: achieved TFLOP/s = tokens/sec x flops/token, MFU = achieved
  / peak, the peak by default one H100 SXM's dense bf16 rate (989
  TFLOP/s); plus recompile / health-guard / checkpoint event counts.
  Serving logs (``decode_step`` events) get a serve-mode summary
  instead (tokens/sec, per-token latency p50/p95/p99, batch occupancy,
  queue depth), with the fleet and speculative blocks where the log has
  their events.
- ``tail LOG -n 20``: the last N events, one line each.
- ``diff A B``: per-metric regression table between two runs;
  ``--fail-over PCT`` exits 1 when mean step time regressed more.
- ``aggregate LOG...``: merge per-host logs of one run (events carry
  ``process_index``/``hostname``), print the per-step cross-host skew
  table and the straggler ranking; serving-fleet logs aggregate into
  per-replica rows and the merged fleet block instead. A torn heartbeat
  file gets one bounded re-read before it is reported as no-heartbeat.
- ``postmortem DUMP``: render a flight-recorder dump
  (``telemetry/flight.py``): what fired, the watchdog's verdict, every
  thread's in-flight phase path and stack, the step's collectives, and
  the event-timeline tail.

Exit codes: 0 ok, 1 no step events (summary) / regression past
``--fail-over`` (diff) / no overlapping steps (aggregate) / unreadable
dump (postmortem), 2 usage errors / unreadable files.

flops/token resolution for MFU (first hit wins): ``--flops-per-token``
flag > the run's ``compile`` event > its ``run_start`` event. Without
any, the summary reports throughput but skips MFU.
"""

import argparse
import json
import os
import sys

from deepspeed_tpu_torch.telemetry.events import SCHEMA_VERSION

# One H100 SXM's dense bf16 peak, TFLOP/s (the rate chip_smoke.py's MFU
# uses); pass --peak-tflops for another card.
DEFAULT_PEAK_TFLOPS = 989.0


def read_events(path):
    """Parse a JSONL log, skipping blank/corrupt lines (a live run may
    be mid-write on the last line)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                evt = json.loads(line)
            except ValueError:
                continue
            if isinstance(evt, dict):
                events.append(evt)
    return events


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _resolve_flops_per_token(events, flops_per_token=None):
    if flops_per_token:
        return float(flops_per_token)
    for kind in ("compile", "run_start"):
        for evt in events:
            if evt.get("event") == kind and evt.get("flops_per_token"):
                return float(evt["flops_per_token"])
    return None


def _wire_bytes_per_step(events):
    """Per-step collective wire accounting from the run's ``compile``
    event (`collective_bytes_by_dtype`): total bytes moved by collectives
    per step, and how many of them travel in 1-byte quantized form
    (u8/s8/f8 element dtypes — the int8/fp8 wire codecs)."""
    for evt in reversed(events):
        bd = evt.get("collective_bytes_by_dtype") \
            if evt.get("event") == "compile" else None
        if not bd:
            continue
        total = wire = 0
        for op, per_dtype in bd.items():
            if not isinstance(per_dtype, dict):   # the "total" rollup
                continue
            for dt, b in per_dtype.items():
                total += int(b)
                if dt in ("u8", "s8") or dt.startswith("f8"):
                    wire += int(b)
        return {"total_bytes": total, "quantized_bytes": wire,
                "quantized_share": (wire / total) if total else 0.0}
    return None


def _kernel_summary(events):
    """Kernel facts from the latest ``compile`` event carrying them: a
    log the JAX package wrote with its compile audit's per-Pallas-kernel
    analysis (VMEM working set and elided-DMA fraction, the VMEM
    high-water, the byte-weighted elision rollup). The port's compile
    event carries none, so its logs render without this block."""
    for evt in reversed(events):
        ks = evt.get("kernels") if evt.get("event") == "compile" else None
        if not ks or not ks.get("kernels"):
            continue
        per = {
            name: {"vmem_bytes": int(kd.get("vmem_bytes") or 0),
                   "elided_dma_fraction": kd.get("elided_dma_fraction")}
            for name, kd in ks["kernels"].items()}
        dense = int(ks.get("dense_bytes") or 0)
        dma = int(ks.get("dma_bytes") or 0)
        return {
            "per_kernel": per,
            "vmem_high_water_bytes": max(
                (k["vmem_bytes"] for k in per.values()), default=0),
            "vmem_budget_bytes": int(ks.get("vmem_budget_bytes") or 0),
            "elided_dma_fraction": (1.0 - dma / dense) if dense else None,
            "expected_elision": ks.get("expected_elision"),
        }
    return None


def _summarize_fleet(events):
    """Fleet block: router-level serving events (`inference/router.py`
    — replica deaths, drains/redispatches, aborts, shed/defer
    backpressure, per-request latency). None when the log carries no
    fleet events at all."""
    kinds = {}
    for e in events:
        kinds.setdefault(e.get("event"), []).append(e)
    done = (kinds.get("fleet_done") or [None])[-1] or {}
    completes = kinds.get("request_complete", [])
    deaths = kinds.get("replica_dead", [])
    if not done and not (completes or deaths or
                         kinds.get("fleet_redispatch")):
        return None
    lat = sorted(float(e["latency_s"]) for e in completes
                 if e.get("latency_s") is not None)
    reasons = {}
    for e in completes:
        r = e.get("finish_reason", "?")
        reasons[r] = reasons.get(r, 0) + 1
    causes = {}
    for e in deaths:
        c = e.get("cause", "?")
        causes[c] = causes.get(c, 0) + 1
    recover = [float(e["time_to_recover_s"])
               for e in kinds.get("replica_recovered", [])
               if e.get("time_to_recover_s")]
    return {
        "requests": done.get("requests", len(completes)),
        "completions": len(completes) or done.get("completions", 0),
        "finish_reasons": reasons,
        "replicas": done.get("replicas"),
        "replicas_dead": {
            "count": len(deaths) or done.get("replicas_dead", 0),
            "by_cause": causes,
        },
        "redispatched": len(kinds.get("fleet_redispatch", ()))
        or done.get("redispatched_total", 0),
        "aborted": len(kinds.get("request_aborted", ()))
        or done.get("aborted", 0),
        "shed": len(kinds.get("fleet_shed", ())) or done.get("shed", 0),
        "defers": len(kinds.get("fleet_defer", ()))
        or done.get("defers", 0),
        "timeouts": len(kinds.get("request_timeout", ()))
        or done.get("timeouts", 0),
        "request_latency_s": {
            "p50": _percentile(lat, 0.50),
            "p95": _percentile(lat, 0.95),
            "p99": _percentile(lat, 0.99),
            "max": lat[-1] if lat else None,
        },
        "mean_time_to_recover_s": (sum(recover) / len(recover))
        if recover else None,
        "ok": done.get("ok"),
    }


def _summarize_disagg(events):
    """Disaggregated-tier block: per-tier rows (prefill vs decode)
    with the TTFT split and queue waits by tier, plus the handoff
    ledger. Reads the router's ``request_prefilled`` /
    ``request_complete`` / ``disagg_done`` events and the tier
    workers' ``prefill_step`` / ``decode_step`` events — a merged
    ``aggregate`` over router + per-tier worker JSONLs sees both
    sides; a single worker log still gets its own tier's row. None
    when the log carries no disaggregation events at all."""
    kinds = {}
    for e in events:
        kinds.setdefault(e.get("event"), []).append(e)
    done = (kinds.get("disagg_done") or [None])[-1] or {}
    prefilled = kinds.get("request_prefilled", [])
    if not done and not prefilled and not (
            kinds.get("prefill_step") or kinds.get("disagg_reprefill")):
        return None
    completes = kinds.get("request_complete", [])

    def _pct(vals):
        vals = sorted(vals)
        return {"p50": _percentile(vals, 0.50),
                "p95": _percentile(vals, 0.95),
                "p99": _percentile(vals, 0.99),
                "max": vals[-1] if vals else None}

    # TTFT: stamped on request_prefilled as the token leaves the
    # prefill tier; completion records echo it for single-log reads
    ttft = [float(e["ttft_s"]) for e in prefilled
            if e.get("ttft_s") is not None]
    if not ttft:
        ttft = [float(e["ttft_s"]) for e in completes
                if e.get("ttft_s") is not None]
    qw_prefill = [float(e["queue_wait_s"]) for e in prefilled
                  if e.get("queue_wait_s") is not None]
    qw_decode = [float(e["decode_queue_wait_s"]) for e in completes
                 if e.get("decode_queue_wait_s") is not None]
    by_tier = {}
    for kind in ("fleet_dispatch", "fleet_redispatch"):
        for e in kinds.get(kind, ()):
            t = e.get("tier")
            if t:
                row = by_tier.setdefault(
                    t, {"dispatched": 0, "redispatched": 0})
                row["dispatched" if kind == "fleet_dispatch"
                    else "redispatched"] += 1
    pre_steps = kinds.get("prefill_step", [])
    dec_steps = kinds.get("decode_step", [])
    pre_wall = [float(e["wall_s"]) for e in pre_steps
                if e.get("wall_s") is not None]
    dec_wall = [float(e["wall_s"]) for e in dec_steps
                if e.get("wall_s") is not None]
    handoffs = done.get("handoffs", len(prefilled))
    handoff_bytes = done.get("handoff_bytes", sum(
        int(e.get("handoff_bytes") or 0) for e in prefilled))
    return {
        "tiers": {
            "prefill": {
                "steps": len(pre_steps),
                "step_s": _pct(pre_wall),
                "wall_s": sum(pre_wall),
                "dispatched": by_tier.get("prefill", {}).get(
                    "dispatched", 0),
                "redispatched": by_tier.get("prefill", {}).get(
                    "redispatched", 0),
                "queue_wait_s": _pct(qw_prefill),
            },
            "decode": {
                "steps": len(dec_steps),
                "step_s": _pct(dec_wall),
                "wall_s": sum(dec_wall),
                "dispatched": by_tier.get("decode", {}).get(
                    "dispatched", 0),
                "redispatched": by_tier.get("decode", {}).get(
                    "redispatched", 0),
                "queue_wait_s": _pct(qw_decode),
            },
        },
        "ttft_s": _pct(ttft),
        "handoffs": handoffs,
        "handoff_bytes": handoff_bytes,
        "handoff_bytes_per_session": (handoff_bytes / handoffs)
        if handoffs else None,
        "handoff_corrupt": done.get(
            "handoff_corrupt", len(kinds.get("handoff_corrupt", ()))),
        "reprefills": len(kinds.get("disagg_reprefill", ()))
        or done.get("redispatched_total", 0),
        "resumed_from_park": done.get("resumed_from_park", 0),
        "dead_by_tier": done.get("dead_by_tier") or {},
        "ok": done.get("ok"),
    }


def summarize(events, flops_per_token=None, peak_tflops=DEFAULT_PEAK_TFLOPS):
    """Aggregate a run's events into the summary dict. None when the
    log holds neither step events nor resilience events (a supervisor's
    log is all restarts and recoveries — still worth a summary)."""
    steps = [e for e in events if e.get("event") == "step"]
    decode = [e for e in events if e.get("event") == "decode_step"]
    fleet = _summarize_fleet(events)
    disagg = _summarize_disagg(events)
    if not steps and (decode or fleet or disagg):
        serve = _summarize_serve(decode, fleet=fleet)
        if serve is not None:
            serve["kernels"] = _kernel_summary(events)
            serve["disagg"] = disagg
        return serve
    if not steps and not any(
            e.get("event") in ("restart", "recovery_ladder",
                               "checkpoint_fallback", "supervisor_done")
            for e in events):
        return None
    walls = sorted(float(e["wall_s"]) for e in steps
                   if e.get("wall_s") is not None)
    total_s = sum(walls)
    phases = {}
    for evt in steps:
        for name, secs in (evt.get("phases") or {}).items():
            phases.setdefault(name, []).append(float(secs))
    phase_stats = {
        name: {"total_s": sum(vals),
               "mean_s": sum(vals) / len(vals),
               "share": (sum(vals) / total_s) if total_s else 0.0}
        for name, vals in sorted(phases.items())}
    guard_actions = {}
    for evt in events:
        if evt.get("event") == "health_guard":
            action = evt.get("action", "?")
            guard_actions[action] = guard_actions.get(action, 0) + 1
    restart_causes = {}
    ladder_tiers = {}
    recover_secs = []
    for evt in events:
        kind = evt.get("event")
        if kind == "restart":
            cause = evt.get("cause", "?")
            restart_causes[cause] = restart_causes.get(cause, 0) + 1
            if evt.get("time_to_recover_s") is not None:
                recover_secs.append(float(evt["time_to_recover_s"]))
        elif kind == "recovery_ladder":
            tier = evt.get("tier", "?")
            ladder_tiers[tier] = ladder_tiers.get(tier, 0) + 1
    saves = [e for e in events if e.get("event") == "checkpoint_save"]
    save_secs = [float(e["duration_s"]) for e in saves
                 if e.get("duration_s") is not None]
    tokens = sum(int(e.get("tokens") or 0) for e in steps)
    tokens_per_s = tokens / total_s if total_s and tokens else None
    fpt = _resolve_flops_per_token(events, flops_per_token)
    mfu = None
    if tokens_per_s and fpt:
        achieved_tflops = tokens_per_s * fpt / 1e12
        mfu = {"flops_per_token": fpt,
               "peak_tflops": float(peak_tflops),
               "achieved_tflops": achieved_tflops,
               "mfu": achieved_tflops / float(peak_tflops)}
    losses = [float(e["loss"]) for e in steps
              if e.get("loss") is not None]
    return {
        "schema": SCHEMA_VERSION,
        "steps": len(steps),
        "flavor": steps[-1].get("flavor") if steps else None,
        "wall_s": total_s,
        "step_s": {
            "mean": (total_s / len(walls)) if walls else None,
            "p50": _percentile(walls, 0.50),
            "p95": _percentile(walls, 0.95),
            "min": walls[0] if walls else None,
            "max": walls[-1] if walls else None,
        },
        "phases": phase_stats,
        "tokens": tokens or None,
        "tokens_per_s": tokens_per_s,
        "mfu": mfu,
        "collective_wire": _wire_bytes_per_step(events),
        "kernels": _kernel_summary(events),
        "last_loss": losses[-1] if losses else None,
        "events": {
            "recompile": sum(1 for e in events
                             if e.get("event") == "recompile"),
            "health_guard": guard_actions,
            "checkpoint_save": {
                "count": len(saves),
                "mean_s": (sum(save_secs) / len(save_secs))
                if save_secs else None,
            },
            "checkpoint_load": sum(
                1 for e in events if e.get("event") == "checkpoint_load"),
            "checkpoint_fallback": sum(
                1 for e in events
                if e.get("event") == "checkpoint_fallback"),
            "restart": {
                "count": sum(restart_causes.values()),
                "by_cause": restart_causes,
                "mean_time_to_recover_s": (
                    sum(recover_secs) / len(recover_secs))
                if recover_secs else None,
            },
            "recovery_ladder": {
                "count": sum(ladder_tiers.values()),
                "by_tier": ladder_tiers,
            },
        },
    }


def _summarize_serve(decode, fleet=None):
    """Serve-mode summary over ``decode_step`` events. Per-token latency
    samples: every token a decode step produced experienced that step's
    host wall, so the sample list is each step's wall repeated
    ``tokens`` times — the open-loop analog of per-request latency
    without having to join request ids across events."""
    walls = sorted(float(e["wall_s"]) for e in decode
                   if e.get("wall_s") is not None)
    total_s = sum(walls)
    tokens = sum(int(e.get("tokens") or 0) for e in decode)
    lat = sorted(x for e in decode if e.get("wall_s") is not None
                 for x in [float(e["wall_s"])] * int(e.get("tokens") or 0))
    occ = [float(e["occupancy"]) for e in decode
           if e.get("occupancy") is not None]
    qd = [float(e["queue_depth"]) for e in decode
          if e.get("queue_depth") is not None]
    # Paged-KV extras: a paged scheduler stamps each decode_step with
    # the allocator census and the cumulative radix counters, so the
    # last event carries the final tallies and the per-step series
    # gives resident cache bytes per live session (the paged win: only
    # occupied pages count, not max_seq rows).
    pg_events = [e for e in decode if e.get("pages_resident") is not None]
    paging = None
    if pg_events:
        last = pg_events[-1]
        hits = int(last.get("prefix_hits") or 0)
        misses = int(last.get("prefix_misses") or 0)
        # free + resident excludes the reserved trash page 0
        n_pages = int(last["pages_free"]) + \
            int(last["pages_resident"]) + 1
        page_bytes = float(last.get("cache_bytes") or 0) / max(n_pages, 1)
        per_sess = [int(e["pages_resident"]) * page_bytes
                    / int(e.get("batch") or 1)
                    for e in pg_events if int(e.get("batch") or 0)]
        paging = {
            "pages": {"free": int(last["pages_free"]),
                      "resident": int(last["pages_resident"]),
                      "total": n_pages},
            "prefix": {"hits": hits, "misses": misses,
                       "hit_rate": hits / (hits + misses)
                       if (hits + misses) else None},
            "sessions_admitted": int(last.get("sessions_admitted") or 0),
            "sessions_parked_host": int(
                last.get("sessions_parked_host") or 0),
            "cache_bytes_total": int(last.get("cache_bytes") or 0),
            "cache_bytes_per_session": {
                "mean": (sum(per_sess) / len(per_sess))
                if per_sess else None,
                "max": max(per_sess) if per_sess else None,
            },
        }
    # Speculative extras: a speculative scheduler stamps each
    # decode_step with the round's accept tallies and the draft/verify
    # wall split, so the summary can report accepted tokens per round
    # (the speedup lever) and where the wall went.
    sp_events = [e for e in decode
                 if e.get("accepted_tokens") is not None]
    speculative = None
    if sp_events:
        acc = sum(int(e["accepted_tokens"]) for e in sp_events)
        drafts = sum(int(e.get("accepted_drafts") or 0)
                     for e in sp_events)
        drafted = sum(int(e.get("draft_tokens") or 0)
                      for e in sp_events)
        row_rounds = sum(int(e.get("batch") or 0) for e in sp_events)
        dw = sum(float(e.get("draft_wall_s") or 0) for e in sp_events)
        vw = sum(float(e.get("verify_wall_s") or 0) for e in sp_events)
        speculative = {
            "rounds": len(sp_events),
            "row_rounds": row_rounds,
            "accepted_tokens": acc,
            "mean_accepted": acc / row_rounds if row_rounds else None,
            "draft_efficiency": drafts / drafted if drafted else None,
            "draft_len_last": int(sp_events[-1].get("draft_len") or 0),
            "wall_split": {
                "draft_s": dw, "verify_s": vw,
                "draft_frac": dw / (dw + vw) if (dw + vw) else None},
            "effective_tokens_per_s": acc / (dw + vw)
            if (dw + vw) else None,
        }
    return {
        "schema": SCHEMA_VERSION,
        "mode": "serve",
        "flavor": "serve",
        "steps": len(decode),
        "wall_s": total_s,
        "step_s": {
            "mean": (total_s / len(walls)) if walls else None,
            "p50": _percentile(walls, 0.50),
            "p95": _percentile(walls, 0.95),
            "min": walls[0] if walls else None,
            "max": walls[-1] if walls else None,
        },
        "tokens": tokens or None,
        "tokens_per_s": tokens / total_s if total_s and tokens else None,
        "phases": {},   # serve steps have no train phases; diff expects the key
        "latency_s": {
            "mean": (sum(lat) / len(lat)) if lat else None,
            "p50": _percentile(lat, 0.50),
            "p95": _percentile(lat, 0.95),
            "p99": _percentile(lat, 0.99),
        },
        "batch_occupancy": {
            "mean": (sum(occ) / len(occ)) if occ else None,
            "min": min(occ) if occ else None,
            "max": max(occ) if occ else None,
        },
        "queue_depth": {
            "mean": (sum(qd) / len(qd)) if qd else None,
            "max": max(qd) if qd else None,
        },
        "paging": paging,
        "speculative": speculative,
        "fleet": fleet,
        "mfu": None,
    }


def _fmt_s(v):
    if v is None:
        return "-"
    return f"{v * 1e3:.2f}ms" if v < 1.0 else f"{v:.3f}s"


def print_serve_summary(s, out=None):
    print(f"serve summary (schema {s['schema']})", file=out)
    print(f"  decode steps {s['steps']}, wall {s['wall_s']:.3f}s, "
          f"step time mean {_fmt_s(s['step_s']['mean'])} "
          f"p50 {_fmt_s(s['step_s']['p50'])} "
          f"p95 {_fmt_s(s['step_s']['p95'])}", file=out)
    if s["tokens"]:
        print(f"  tokens {s['tokens']}, throughput "
              f"{s['tokens_per_s']:,.1f} tokens/s", file=out)
    lat = s["latency_s"]
    if lat["p50"] is not None:
        print(f"  per-token latency p50 {_fmt_s(lat['p50'])} "
              f"p95 {_fmt_s(lat['p95'])} p99 {_fmt_s(lat['p99'])}",
              file=out)
    occ = s["batch_occupancy"]
    if occ["mean"] is not None:
        print(f"  batch occupancy mean {occ['mean'] * 100:.1f}% "
              f"(min {occ['min'] * 100:.0f}%, max {occ['max'] * 100:.0f}%)",
              file=out)
    qd = s["queue_depth"]
    if qd["mean"] is not None:
        print(f"  queue depth mean {qd['mean']:.2f}, max {qd['max']:.0f}",
              file=out)
    pg = s.get("paging")
    if pg:
        cps = pg["cache_bytes_per_session"]
        mean_kb = (f"{cps['mean'] / 1024:.1f}KB"
                   if cps["mean"] is not None else "-")
        print(f"  paged KV: {pg['pages']['resident']}/"
              f"{pg['pages']['total']} pages resident, cache "
              f"{mean_kb}/session (pool "
              f"{pg['cache_bytes_total'] / 1024:.0f}KB)", file=out)
        pf = pg["prefix"]
        rate = (f"{pf['hit_rate'] * 100:.0f}%"
                if pf["hit_rate"] is not None else "-")
        print(f"  prefix cache: {pf['hits']} hits / {pf['misses']} "
              f"misses (hit rate {rate}), sessions admitted "
              f"{pg['sessions_admitted']}, parked to host "
              f"{pg['sessions_parked_host']}", file=out)
    sp = s.get("speculative")
    if sp:
        mean = (f"{sp['mean_accepted']:.3f}"
                if sp["mean_accepted"] is not None else "-")
        eff = (f"{sp['draft_efficiency'] * 100:.1f}%"
               if sp["draft_efficiency"] is not None else "-")
        print(f"  speculative: {sp['accepted_tokens']} tokens over "
              f"{sp['row_rounds']} row-round(s), mean accepted {mean} "
              f"tokens/round, draft efficiency {eff}, draft window "
              f"{sp['draft_len_last']}", file=out)
        ws = sp["wall_split"]
        frac = (f"{ws['draft_frac'] * 100:.0f}%"
                if ws["draft_frac"] is not None else "-")
        etps = (f"{sp['effective_tokens_per_s']:,.1f}"
                if sp["effective_tokens_per_s"] is not None else "-")
        print(f"  speculative wall: draft {_fmt_s(ws['draft_s'])} / "
              f"verify {_fmt_s(ws['verify_s'])} ({frac} drafting), "
              f"effective {etps} tokens/s", file=out)
    if s.get("kernels"):
        print_kernel_block(s["kernels"], out=out)
    if s.get("fleet"):
        print_fleet_block(s["fleet"], out=out)
    if s.get("disagg"):
        print_disagg_block(s["disagg"], out=out)


def print_disagg_block(dg, out=None):
    bps = dg.get("handoff_bytes_per_session")
    print(f"  disagg: {dg['handoffs']} handoff(s), "
          f"{dg['handoff_bytes'] / 1024:,.1f}KB"
          + (f" ({bps / 1024:.1f}KB/session)" if bps else "")
          + f", {dg['handoff_corrupt']} corrupt, "
          f"{dg['resumed_from_park']} resumed from park", file=out)
    tt = dg["ttft_s"]
    if tt["p50"] is not None:
        print(f"  disagg ttft p50 {_fmt_s(tt['p50'])} "
              f"p95 {_fmt_s(tt['p95'])} p99 {_fmt_s(tt['p99'])}",
              file=out)
    for tier in ("prefill", "decode"):
        row = dg["tiers"][tier]
        qs = row["queue_wait_s"]
        dead = (dg.get("dead_by_tier") or {}).get(tier, 0)
        line = (f"  {tier} tier: {row['steps']} step(s), "
                f"wall {row['wall_s']:.3f}s, step p50 "
                f"{_fmt_s(row['step_s']['p50'])} p95 "
                f"{_fmt_s(row['step_s']['p95'])}, dispatched "
                f"{row['dispatched']} (redispatched "
                f"{row['redispatched']}, dead {dead})")
        if qs["p50"] is not None:
            line += (f", queue wait p50 {_fmt_s(qs['p50'])} "
                     f"p95 {_fmt_s(qs['p95'])}")
        print(line, file=out)


def print_kernel_block(kn, out=None):
    budget = kn.get("vmem_budget_bytes") or 0
    frac = kn.get("elided_dma_fraction")
    frac_s = f"{frac * 100:.1f}%" if frac is not None else "-"
    line = (f"  kernels: VMEM high-water "
            f"{kn['vmem_high_water_bytes'] / 1024:,.1f}KB")
    if budget:
        line += f" / {budget / (1 << 20):.0f}MB budget"
    line += f", elided DMA {frac_s}"
    if kn.get("expected_elision") is not None:
        line += f" (contract >= {kn['expected_elision'] * 100:.1f}%)"
    print(line, file=out)
    for name, kd in kn["per_kernel"].items():
        ef = kd.get("elided_dma_fraction")
        ef_s = f"{ef * 100:5.1f}%" if ef is not None else "    -"
        print(f"    {name:<14s} VMEM {kd['vmem_bytes'] / 1024:>9,.1f}KB  "
              f"elided DMA {ef_s}", file=out)


def print_fleet_block(fl, out=None):
    rd = fl["replicas_dead"]
    causes = ", ".join(f"{k}={v}" for k, v in
                       sorted(rd["by_cause"].items())) or "none"
    reasons = ", ".join(f"{k}={v}" for k, v in
                        sorted(fl["finish_reasons"].items())) or "-"
    print(f"  fleet: {fl['requests']} request(s) -> "
          f"{fl['completions']} completion(s) [{reasons}], "
          f"{fl['redispatched']} redispatch(es), {fl['aborted']} "
          f"aborted, {fl['shed']} shed, {fl['timeouts']} timeout(s), "
          f"{fl['defers']} defer episode(s)", file=out)
    ttr = fl["mean_time_to_recover_s"]
    print(f"  fleet replicas: {fl['replicas'] or '?'} total, "
          f"{rd['count']} dead [{causes}]"
          + (f", mean recover {_fmt_s(ttr)}" if ttr else ""), file=out)
    rl = fl["request_latency_s"]
    if rl["p50"] is not None:
        print(f"  fleet request latency p50 {_fmt_s(rl['p50'])} "
              f"p95 {_fmt_s(rl['p95'])} p99 {_fmt_s(rl['p99'])} "
              f"max {_fmt_s(rl['max'])}", file=out)


def print_summary(s, out=None):
    if s.get("mode") == "serve":
        return print_serve_summary(s, out)
    print(f"run summary ({s['flavor'] or 'unknown'} flavor, schema "
          f"{s['schema']})", file=out)
    print(f"  steps {s['steps']}, wall {s['wall_s']:.3f}s, "
          f"step time mean {_fmt_s(s['step_s']['mean'])} "
          f"p50 {_fmt_s(s['step_s']['p50'])} "
          f"p95 {_fmt_s(s['step_s']['p95'])}", file=out)
    if s["phases"]:
        print("  phase breakdown (host wall, share of step time):",
              file=out)
        for name, ps in s["phases"].items():
            print(f"    {name:<14s} mean {_fmt_s(ps['mean_s']):>10s}  "
                  f"total {_fmt_s(ps['total_s']):>10s}  "
                  f"{ps['share'] * 100:5.1f}%", file=out)
    if s["tokens_per_s"]:
        print(f"  throughput {s['tokens_per_s']:,.0f} tokens/s", file=out)
    if s["mfu"]:
        m = s["mfu"]
        print(f"  MFU {m['mfu'] * 100:.1f}% "
              f"({m['achieved_tflops']:.1f} / {m['peak_tflops']:.0f} "
              f"TFLOPS at {m['flops_per_token']:,.0f} flops/token)",
              file=out)
    if s.get("collective_wire"):
        w = s["collective_wire"]
        print(f"  collective wire {w['total_bytes'] / 1024:,.1f}KB/step, "
              f"{w['quantized_bytes'] / 1024:,.1f}KB "
              f"({w['quantized_share'] * 100:.1f}%) in 1-byte quantized "
              f"form", file=out)
    if s.get("kernels"):
        print_kernel_block(s["kernels"], out=out)
    ev = s["events"]
    guards = ", ".join(f"{k}={v}" for k, v in
                       sorted(ev["health_guard"].items())) or "none"
    save_mean = ev["checkpoint_save"]["mean_s"]
    print(f"  events: {ev['recompile']} recompile(s), health guards "
          f"[{guards}], {ev['checkpoint_save']['count']} checkpoint "
          f"save(s)"
          + (f" (mean {_fmt_s(save_mean)})" if save_mean else "")
          + f", {ev['checkpoint_load']} load(s)", file=out)
    rst = ev.get("restart") or {}
    lad = ev.get("recovery_ladder") or {}
    fallbacks = ev.get("checkpoint_fallback", 0)
    if rst.get("count") or lad.get("count") or fallbacks:
        causes = ", ".join(f"{k}={v}" for k, v in
                           sorted((rst.get("by_cause") or {}).items())) \
            or "none"
        tiers = ", ".join(f"{k}={v}" for k, v in
                          sorted((lad.get("by_tier") or {}).items())) \
            or "none"
        ttr = rst.get("mean_time_to_recover_s")
        print(f"  resilience: {rst.get('count', 0)} restart(s) [{causes}]"
              + (f" mean recover {_fmt_s(ttr)}" if ttr else "")
              + f", {lad.get('count', 0)} recovery ladder load(s) "
              f"[{tiers}], {fallbacks} checkpoint fallback(s)", file=out)
    if s["last_loss"] is not None:
        print(f"  last loss {s['last_loss']:.6g}", file=out)


# Metrics the diff table compares; (label, getter, lower_is_better).
def _diff_rows(a, b):
    def step_stat(s, key):
        return s["step_s"][key]

    rows = [
        ("step_s.mean", step_stat(a, "mean"), step_stat(b, "mean"), True),
        ("step_s.p50", step_stat(a, "p50"), step_stat(b, "p50"), True),
        ("step_s.p95", step_stat(a, "p95"), step_stat(b, "p95"), True),
        ("tokens_per_s", a["tokens_per_s"], b["tokens_per_s"], False),
        ("mfu", a["mfu"]["mfu"] if a["mfu"] else None,
         b["mfu"]["mfu"] if b["mfu"] else None, False),
    ]
    for name in sorted(set(a["phases"]) | set(b["phases"])):
        rows.append((f"phase.{name}.mean_s",
                     a["phases"].get(name, {}).get("mean_s"),
                     b["phases"].get(name, {}).get("mean_s"), True))
    sa, sb = a.get("speculative"), b.get("speculative")
    if sa or sb:
        rows.append(("speculative.mean_accepted",
                     (sa or {}).get("mean_accepted"),
                     (sb or {}).get("mean_accepted"), False))
        rows.append(("speculative.effective_tokens_per_s",
                     (sa or {}).get("effective_tokens_per_s"),
                     (sb or {}).get("effective_tokens_per_s"), False))
    return rows


def diff_summaries(a, b):
    """Regression table between run A (baseline) and run B. Returns
    (rows, step_mean_delta_pct); each row is
    {metric, a, b, delta_pct, regression}."""
    out = []
    step_mean_delta = None
    for metric, va, vb, lower_better in _diff_rows(a, b):
        delta = None
        if va and vb:
            delta = (vb - va) / va * 100.0
        regression = None
        if delta is not None:
            regression = delta > 0 if lower_better else delta < 0
        if metric == "step_s.mean":
            step_mean_delta = delta
        out.append({"metric": metric, "a": va, "b": vb,
                    "delta_pct": delta, "regression": regression})
    return out, step_mean_delta


def print_diff(rows, out=None):
    print(f"{'metric':<24s} {'A':>12s} {'B':>12s} {'delta':>9s}",
          file=out)
    for r in rows:
        def fmt(v):
            if v is None:
                return "-"
            return f"{v:.5g}"
        delta = "-" if r["delta_pct"] is None else f"{r['delta_pct']:+.1f}%"
        mark = " <-- regression" if r["regression"] else ""
        print(f"{r['metric']:<24s} {fmt(r['a']):>12s} "
              f"{fmt(r['b']):>12s} {delta:>9s}{mark}", file=out)


def print_tail(events, as_json, out=None):
    if as_json:
        print(json.dumps(events, indent=2, default=str), file=out)
        return
    for evt in events:
        extra = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in evt.items()
            if k not in ("schema", "event", "t", "phases")
            and isinstance(v, (str, int, float, bool)))
        print(f"{evt.get('t', 0):.3f} {evt.get('event', '?'):<16s} "
              f"{extra}", file=out)


# ---------------------------------------------------------------------------
# aggregate: multi-host skew + straggler ranking
# ---------------------------------------------------------------------------

def host_label(events, path):
    """Identity of the process that wrote this log: the run_start (or any
    step) event's hostname/process_index stamp, else the file name."""
    for kind in ("run_start", "step"):
        for evt in events:
            if evt.get("event") == kind and \
                    evt.get("process_index") is not None:
                host = evt.get("hostname") or "host"
                return f"{host}/p{evt['process_index']}"
    return os.path.basename(path)


def aggregate(logs, no_heartbeat=()):
    """Merge per-host logs of one run. ``logs`` is ``[(label, events)]``;
    returns the aggregation dict, or None when no step appears in at
    least two logs (nothing cross-host to compare) and no host is known
    dead. ``no_heartbeat`` lists hosts that never produced a usable
    log/heartbeat (``{"host", "status": "no-heartbeat", "reason"}``
    rows) — a crashed host must show up in the report, not crash it.

    The straggler ranking orders hosts by mean *excess* wall — how much
    slower than the fastest host they were, averaged over every shared
    step — which is robust to a globally slow phase (all hosts slow
    together shows zero excess everywhere).
    """
    hosts = [dict(row) for row in no_heartbeat]
    per_step = {}
    serve_hosts = []
    all_events = []
    for label, events in logs:
        all_events.extend(events)
        decode = [e for e in events if e.get("event") == "decode_step"
                  and e.get("wall_s") is not None]
        prefill = [e for e in events if e.get("event") == "prefill_step"
                   and e.get("wall_s") is not None]
        if decode:
            d_walls = [float(e["wall_s"]) for e in decode]
            toks = sum(int(e.get("tokens") or 0) for e in decode)
            serve_hosts.append({
                "host": label,
                "decode_steps": len(decode),
                "tokens": toks,
                "tokens_per_s": (toks / sum(d_walls))
                if sum(d_walls) and toks else None,
                "last_step": decode[-1].get("step"),
            })
        if prefill:
            # a disaggregated prefill-tier worker log: no decode steps,
            # one prefill_step per admission
            p_walls = [float(e["wall_s"]) for e in prefill]
            serve_hosts.append({
                "host": label,
                "tier": "prefill",
                "decode_steps": 0,
                "prefill_steps": len(prefill),
                "tokens": None,
                "tokens_per_s": None,
                "prefills_per_s": (len(prefill) / sum(p_walls))
                if sum(p_walls) else None,
                "last_step": prefill[-1].get("step"),
            })
        steps = [e for e in events if e.get("event") == "step"
                 and e.get("wall_s") is not None]
        if steps or (not decode and not prefill):
            walls = [float(e["wall_s"]) for e in steps]
            hosts.append({
                "host": label,
                "steps": len(steps),
                "mean_wall_s": sum(walls) / len(walls) if walls else None,
                "last_step": steps[-1].get("step") if steps else None,
            })
        for e in steps:
            per_step.setdefault(int(e.get("step", -1)),
                                {})[label] = float(e["wall_s"])
    fleet = _summarize_fleet(all_events)
    disagg = _summarize_disagg(all_events)
    shared = {s: w for s, w in per_step.items() if len(w) >= 2}
    if not shared and not no_heartbeat and not serve_hosts \
            and fleet is None and disagg is None:
        return None
    step_rows = []
    excess = {h["host"]: [] for h in hosts}
    slow_count = {h["host"]: 0 for h in hosts}
    for s in sorted(shared):
        walls = shared[s]
        fastest = min(walls.values())
        slowest = max(walls, key=walls.get)
        step_rows.append({"step": s, "walls": walls,
                          "skew_s": max(walls.values()) - fastest,
                          "slowest": slowest})
        slow_count[slowest] += 1
        for label, w in walls.items():
            excess[label].append(w - fastest)
    ranking = [{"host": label,
                "mean_excess_s": sum(ex) / len(ex),
                "slowest_steps": slow_count[label],
                "shared_steps": len(ex)}
               for label, ex in excess.items() if ex]
    ranking.sort(key=lambda r: -r["mean_excess_s"])
    return {"schema": SCHEMA_VERSION, "hosts": hosts,
            "steps": step_rows, "straggler_ranking": ranking,
            "serve_hosts": serve_hosts, "fleet": fleet,
            "disagg": disagg}


def print_aggregate(agg, n_steps=10, out=None):
    n_logs = len(agg["hosts"]) + len(agg.get("serve_hosts") or ())
    print(f"cross-host aggregation ({n_logs} host logs, "
          f"schema {agg['schema']})", file=out)
    for h in agg["hosts"]:
        if h.get("status") == "no-heartbeat":
            print(f"  {h['host']:<24s} NO HEARTBEAT "
                  f"({h.get('reason', 'missing')}) — host crashed "
                  f"before/while reporting", file=out)
            continue
        mean = _fmt_s(h["mean_wall_s"])
        print(f"  {h['host']:<24s} {h['steps']} step(s), "
              f"mean {mean}, last step {h['last_step']}", file=out)
    rows = agg["steps"][-max(0, n_steps):]
    if rows:
        print(f"  per-step skew (last {len(rows)} shared steps; "
              f"skew = slowest - fastest wall):", file=out)
        for r in rows:
            walls = " ".join(f"{label}={_fmt_s(w)}"
                             for label, w in sorted(r["walls"].items()))
            print(f"    step {r['step']:>6d}  skew {_fmt_s(r['skew_s']):>9s}"
                  f"  slowest {r['slowest']}  [{walls}]", file=out)
    if agg["steps"] or agg["straggler_ranking"]:
        print("  straggler ranking (mean wall excess over the fastest "
              "host per shared step):", file=out)
        for i, r in enumerate(agg["straggler_ranking"], start=1):
            print(f"    {i}. {r['host']:<24s} "
                  f"+{_fmt_s(r['mean_excess_s'])} "
                  f"mean excess, slowest on {r['slowest_steps']}/"
                  f"{r['shared_steps']} steps", file=out)
        top = agg["straggler_ranking"][0] \
            if agg["straggler_ranking"] else None
        if top and top["mean_excess_s"] > 0:
            print(f"  => straggler: {top['host']}", file=out)
    for h in agg.get("serve_hosts") or ():
        if h.get("tier") == "prefill":
            pps = (f"{h['prefills_per_s']:,.1f} prefills/s"
                   if h.get("prefills_per_s") else "-")
            print(f"  replica {h['host']:<22s} [prefill tier] "
                  f"{h['prefill_steps']} prefill step(s), {pps}, "
                  f"last step {h['last_step']}", file=out)
            continue
        tps = (f"{h['tokens_per_s']:,.1f} tokens/s"
               if h["tokens_per_s"] else "-")
        print(f"  replica {h['host']:<22s} {h['decode_steps']} decode "
              f"step(s), {h['tokens']} tokens, {tps}, last step "
              f"{h['last_step']}", file=out)
    if agg.get("fleet"):
        print_fleet_block(agg["fleet"], out=out)
    if agg.get("disagg"):
        print_disagg_block(agg["disagg"], out=out)


# ---------------------------------------------------------------------------
# postmortem: render one flight-recorder dump
# ---------------------------------------------------------------------------

def print_postmortem(dump, n_events=15, out=None):
    meta = dump.get("meta") or {}
    host = meta.get("hostname", "?")
    pidx = meta.get("process_index", "?")
    print(f"flight-recorder postmortem ({dump.get('schema')})", file=out)
    print(f"  reason   {dump.get('reason')}", file=out)
    print(f"  host     {host} process {pidx}/"
          f"{meta.get('process_count', '?')} pid {dump.get('pid')}",
          file=out)
    print(f"  t        {dump.get('t')}", file=out)
    if meta:
        facts = " ".join(f"{k}={v}" for k, v in sorted(meta.items())
                         if k not in ("hostname", "process_index",
                                      "process_count"))
        if facts:
            print(f"  run      {facts}", file=out)
    wd = dump.get("watchdog")
    if wd:
        print(f"  watchdog step {wd.get('step')} stuck in "
              f"'{wd.get('phase')}' for {wd.get('elapsed_s')}s "
              f"(deadline {wd.get('deadline_s')}s = "
              f"{wd.get('deadline_factor')} x median "
              f"{wd.get('median_wall_s')}s)", file=out)
        print(f"  verdict  {wd.get('verdict')}", file=out)
        for s in wd.get("stragglers") or []:
            if s.get("status") == "no-heartbeat":
                print(f"    straggler p{s.get('process_index')}: "
                      f"no-heartbeat ({s.get('reason', 'missing')}) — "
                      f"process died before/while writing its heartbeat",
                      file=out)
                continue
            print(f"    straggler p{s.get('process_index')} "
                  f"({s.get('hostname')}): step {s.get('step')} "
                  f"({s.get('behind_steps')} behind), phase "
                  f"'{s.get('phase')}', beat {s.get('beat_age_s')}s ago",
                  file=out)
    exc = dump.get("exception")
    if exc:
        print(f"  exception {exc.get('type')}: {exc.get('message')}",
              file=out)
    in_flight = dump.get("in_flight_phases") or {}
    if in_flight:
        print("  in-flight phases:", file=out)
        for thread, path in sorted(in_flight.items()):
            print(f"    {thread:<24s} {path}", file=out)
    for t in dump.get("threads") or []:
        flag = " daemon" if t.get("daemon") else ""
        print(f"  thread {t.get('name')}{flag}:", file=out)
        for line in (t.get("stack") or [])[-8:]:
            for part in line.splitlines():
                print(f"    {part}", file=out)
    colls = dump.get("collectives") or []
    counted = [c for c in colls if "calls" in c]
    if counted:
        # the port's rows: what the step had issued when the dump fired
        print(f"  collectives issued in the step "
              f"({len(counted)} kind(s)):", file=out)
        for c in counted[:20]:
            print(f"    {str(c.get('site')):<28s} axis={c.get('axis')} "
                  f"{c.get('primitive')} calls={c.get('calls')} "
                  f"bytes={c.get('bytes')}", file=out)
    elif colls:
        print(f"  collectives traced into the step "
              f"({len(colls)} site(s)):", file=out)
        for c in colls[:20]:
            print(f"    {c.get('site'):<28s} axis={c.get('axis')} "
                  f"{c.get('primitive')} chunks={c.get('chunks')} "
                  f"hops={c.get('hops')} chained={c.get('chained')}",
                  file=out)
    events = dump.get("events") or []
    tail = events[-max(0, n_events):]
    if tail:
        print(f"  timeline tail (last {len(tail)} of {len(events)} "
              f"events):", file=out)
        print_tail(tail, False, out=out)
    phases = dump.get("phase_log") or []
    if phases:
        print(f"  last phase transitions:", file=out)
        for p in phases[-10:]:
            dur = f" ({p['duration_s'] * 1e3:.2f}ms)" \
                if p.get("duration_s") is not None else ""
            print(f"    {p.get('t', 0):.3f} {p.get('kind'):<6s}"
                  f"{p.get('path')}{dur}", file=out)


def print_heartbeat_status(directory, expected_count=None, out=None):
    """One line per process in a heartbeat dir — live heartbeats plus
    the expected-but-silent ``no-heartbeat`` processes."""
    from deepspeed_tpu_torch.telemetry.watchdog import scan_heartbeats
    heartbeats, no_heartbeat = scan_heartbeats(
        directory, expected_count=expected_count)
    print(f"  heartbeat dir {directory}: {len(heartbeats)} heartbeat "
          f"file(s), {len(no_heartbeat)} silent", file=out)
    for hb in sorted(heartbeats,
                     key=lambda h: h.get("process_index") or 0):
        state = (f"in step for {hb.get('step_elapsed_s')}s"
                 if hb.get("in_step") else "between steps")
        print(f"    p{hb.get('process_index')} ({hb.get('hostname')}): "
              f"step {hb.get('step')}, phase '{hb.get('phase')}', "
              f"{state}", file=out)
    for gone in no_heartbeat:
        print(f"    p{gone['process_index']}: no-heartbeat "
              f"({gone['reason']})", file=out)


def _load(parser, path):
    try:
        return read_events(path)
    except OSError as exc:
        parser.error(f"cannot read log: {exc}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ds_tpu_metrics",
        description="Summarize, tail, and diff deepspeed_tpu_torch telemetry "
                    "JSONL logs (step-time breakdown, MFU estimate, "
                    "regression diffs).")
    sub = parser.add_subparsers(dest="cmd")

    p_sum = sub.add_parser("summary", help="aggregate one run's log")
    p_sum.add_argument("log")
    p_sum.add_argument("--json", action="store_true", dest="as_json")
    p_sum.add_argument("--flops-per-token", type=float, default=None,
                       help="model flops per token for the MFU estimate "
                            "(default: the log's compile/run_start stamp)")
    p_sum.add_argument("--peak-tflops", type=float,
                       default=DEFAULT_PEAK_TFLOPS,
                       help="per-device peak TFLOPS for MFU (default "
                            f"{DEFAULT_PEAK_TFLOPS:.0f}, H100 SXM dense "
                            f"bf16)")

    p_tail = sub.add_parser("tail", help="print the last N events")
    p_tail.add_argument("log")
    p_tail.add_argument("-n", type=int, default=10)
    p_tail.add_argument("--json", action="store_true", dest="as_json")
    p_tail.add_argument("--event", default=None,
                        help="only events of this type")

    p_diff = sub.add_parser("diff",
                            help="regression table between two runs")
    p_diff.add_argument("log_a", help="baseline run log")
    p_diff.add_argument("log_b", help="candidate run log")
    p_diff.add_argument("--json", action="store_true", dest="as_json")
    p_diff.add_argument("--flops-per-token", type=float, default=None)
    p_diff.add_argument("--peak-tflops", type=float,
                        default=DEFAULT_PEAK_TFLOPS)
    p_diff.add_argument("--fail-over", type=float, default=None,
                        metavar="PCT",
                        help="exit 1 when mean step time regressed by "
                             "more than PCT percent")

    p_agg = sub.add_parser(
        "aggregate",
        help="merge per-host logs: cross-host skew + straggler ranking")
    p_agg.add_argument("logs", nargs="+",
                       help="one telemetry JSONL log per host/process")
    p_agg.add_argument("-n", type=int, default=10,
                       help="shared steps shown in the skew table")
    p_agg.add_argument("--json", action="store_true", dest="as_json")
    p_agg.add_argument("--heartbeats", default=None, metavar="DIR",
                       help="also scan this heartbeat dir and list "
                            "processes with no usable hb-p*.json as "
                            "no-heartbeat hosts")
    p_agg.add_argument("--expect-hosts", type=int, default=None,
                       help="expected process count: indices in "
                            "range(N) with no heartbeat file at all are "
                            "reported as no-heartbeat")

    p_pm = sub.add_parser(
        "postmortem", help="render a flight-recorder crash dump")
    p_pm.add_argument("dump", help="flight-*.json dump file")
    p_pm.add_argument("-n", type=int, default=15,
                      help="events shown in the timeline tail")
    p_pm.add_argument("--json", action="store_true", dest="as_json")
    p_pm.add_argument("--heartbeats", default=None, metavar="DIR",
                      help="also render the heartbeat dir's per-process "
                           "status (silent hosts show as no-heartbeat)")
    p_pm.add_argument("--expect-hosts", type=int, default=None,
                      help="expected process count for --heartbeats")

    args = parser.parse_args(argv)
    if args.cmd is None:
        parser.error("a subcommand is required: summary, tail, diff, "
                     "aggregate, or postmortem")

    if args.cmd == "summary":
        s = summarize(_load(parser, args.log),
                      flops_per_token=args.flops_per_token,
                      peak_tflops=args.peak_tflops)
        if s is None:
            print("no step events in log", file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(s, indent=2, sort_keys=True))
        else:
            print_summary(s)
        return 0

    if args.cmd == "tail":
        events = _load(parser, args.log)
        if args.event:
            events = [e for e in events if e.get("event") == args.event]
        print_tail(events[-max(0, args.n):], args.as_json)
        return 0

    if args.cmd == "aggregate":
        logs = []
        no_heartbeat = []
        for path in args.logs:
            try:
                events = read_events(path)
            except OSError as exc:
                # A crashed host may never have opened (or half-wrote)
                # its log — report it, don't die on it.
                no_heartbeat.append({
                    "host": os.path.basename(path),
                    "status": "no-heartbeat",
                    "reason": f"unreadable log ({exc})"})
                continue
            logs.append((host_label(events, path), events))
        if args.heartbeats:
            from deepspeed_tpu_torch.telemetry.watchdog import scan_heartbeats
            _, silent = scan_heartbeats(
                args.heartbeats, expected_count=args.expect_hosts)
            no_heartbeat.extend(
                {"host": f"p{g['process_index']}",
                 "status": "no-heartbeat", "reason": g["reason"]}
                for g in silent)
        agg = aggregate(logs, no_heartbeat=no_heartbeat)
        if agg is None:
            print("no step appears in two or more logs — nothing "
                  "cross-host to compare", file=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(agg, indent=2, sort_keys=True))
        else:
            print_aggregate(agg, n_steps=args.n)
        return 0

    if args.cmd == "postmortem":
        from deepspeed_tpu_torch.telemetry.flight import read_dump
        try:
            dump = read_dump(args.dump)
        except (OSError, ValueError) as exc:
            # A host killed mid-dump leaves a truncated/absent file —
            # degrade to whatever else we can report instead of a usage
            # error.
            print(f"cannot read dump {args.dump}: {exc} — host produced "
                  f"no usable flight dump (no-heartbeat)",
                  file=sys.stderr)
            if args.heartbeats:
                print_heartbeat_status(args.heartbeats,
                                       expected_count=args.expect_hosts,
                                       out=sys.stderr)
            return 1
        if args.as_json:
            print(json.dumps(dump, indent=2, sort_keys=True, default=str))
        else:
            print_postmortem(dump, n_events=args.n)
            if args.heartbeats:
                print_heartbeat_status(args.heartbeats,
                                       expected_count=args.expect_hosts)
        return 0

    # diff
    sa = summarize(_load(parser, args.log_a),
                   flops_per_token=args.flops_per_token,
                   peak_tflops=args.peak_tflops)
    sb = summarize(_load(parser, args.log_b),
                   flops_per_token=args.flops_per_token,
                   peak_tflops=args.peak_tflops)
    if sa is None or sb is None:
        which = args.log_a if sa is None else args.log_b
        print(f"no step events in log {which}", file=sys.stderr)
        return 1
    rows, step_mean_delta = diff_summaries(sa, sb)
    if args.as_json:
        print(json.dumps({"schema": SCHEMA_VERSION, "rows": rows,
                          "step_mean_delta_pct": step_mean_delta},
                         indent=2, sort_keys=True))
    else:
        print_diff(rows)
    if args.fail_over is not None and step_mean_delta is not None \
            and step_mean_delta > args.fail_over:
        print(f"FAIL: mean step time regressed "
              f"{step_mean_delta:+.1f}% (> {args.fail_over}%)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
