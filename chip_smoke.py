#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``deepspeed_tpu_torch``) on one
NVIDIA GPU: builds the port's CUDA kernels from this checkout, holds
each against its plain PyTorch version, times it, serves GPT-2 125M and
trains GPT-2 350M at full width through the port's main paths.

    python3 chip_smoke.py                 # every phase (one GPU)
    python3 chip_smoke.py --kernels-only  # device, build, kernel checks

Phases, each printing one JSON line:

1. ``device``  — ``nvidia-smi`` name and power limit (also printed as
   its own line), torch and CUDA versions.
2. ``build``   — every kernel built from ``deepspeed_tpu_torch/ops/
   csrc`` (one ``nvcc`` per source, all started together); seconds and
   the ``ptxas`` register/shared-memory report.
3. ``kernel_check`` — the CUDA ``flash_decode`` against
   ``flash_decode_reference`` on the card: B=8, S=512, H=12/D=64 and
   H=16/D=96 (plus H=4/D=256), positions {0, 63, 127, 128, 300, 511}
   and random ones, storage bf16/f32/int8/f8e4m3fn/f8e5m2 under bf16
   and f32 queries; a poisoned-tail bitwise check per storage dtype.
4. ``kernel_timing`` — median CUDA-event time per call of the kernel,
   of its plain version and of ``F.scaled_dot_product_attention`` on
   the bf16 cache (a yardstick only; the port never calls it), against
   the bound of moving the occupied cache once at the card's HBM rate.
5. ``serve``   — GPT-2 125M (bf16, seeded random params) served through
   ``InferenceEngine`` + ``ContinuousBatchingScheduler`` with flash
   decode, once with a bf16 and once with an int8 KV cache: a warmup
   request, then 24 requests (prompts 8-120 tokens, 32 new tokens,
   one arrival per decode step). Checks: every request completes,
   ``compile_counts() == {"prefill": 1, "decode": 1}``, the kernel ran
   n_layer times per decode step, and teacher-forced decode logits of
   the flash engine match a dense engine on the same params.
6. ``train_kernel_check`` — flash attention K1 (out, lse), K2 (dq) and
   K3 (dk, dv, dbias partials) against their plain versions on the card:
   B 2-8, T 128/1000/1024, H 16, D 64 and 128, bf16 and f32, causal and
   not, with and without a key bias, dropout 0 and 0.1 at a nonzero head
   offset; the K1 dropout mask read back bitwise against
   ``dropout_multiplier``; fused Adam K4 against its plain version over
   3 steps and a skipped one, both modes, leaves of odd sizes.
7. ``train_kernel_timing`` — CUDA-event ms per call of K1, K2, K3 at the
   training shape (B 8, T 1024, H 16, D 64, bf16, causal) and of K4
   over GPT-2 350M's 292 leaves, beside their plain versions, their
   bounds and the library yardsticks (``F.scaled_dot_product_attention``
   forward and backward, ``torch.optim.AdamW(fused=True)``; the port
   never calls them). Before K4 is timed, one K4 step over those 292
   leaves is held against its plain version on copies of them.
8. ``train`` — GPT-2 350M (n_positions 1024, bf16 over fp32 masters,
   flash attention, seeded random params) through ``initialize`` with
   the JAX bench's config (train_batch_size 8, bf16, Adam lr 1e-4 with
   ``pallas: true``): 2 warmup and 10 timed ``train_batch`` steps on a
   fixed batch. Reports tokens/s, step p50, MFU, peak memory and a
   profiler window. Then 3 steps with gradient_accumulation_steps 2
   from the same params, once with flash and once with dense attention.
   Checks: finite, falling loss; K1, K2, K3 launched n_layer times per
   micro-batch and K4 once per step; flash and dense losses within a
   bf16 tolerance at every step, and their first micro-batch's c_attn
   weight gradients (the q, k and v rows) within a relative tolerance.

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before the last line; without a CUDA device it exits 1 at once.
"""

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and ops/s by the
# operand type the kernel computes on.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 67e12, "int8": 1979e12,
                  "float8_e4m3fn": 1979e12, "float8_e5m2": 1979e12}

B, S = 8, 512
FIXED_POSITIONS = (0, 63, 127, 128, 300, 511)
SERVE_BLOCK_K = 128     # the engine's default attention_block_k
N_LAYER = 12


def emit(obj):
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_device(torch):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    smi = proc.stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})
    return smi


def phase_build():
    from deepspeed_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(_build.KERNELS)) as ex:
        futures = {name: ex.submit(_build.load_library, name)
                   for name in _build.KERNELS}
        for name, fut in futures.items():
            fut.result()            # raises with the compiler output
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: _build.build_info[name]
                      for name in _build.KERNELS}})


def _positions(torch, rng):
    extra = rng.integers(0, S, B - len(FIXED_POSITIONS))
    pos = np.concatenate([FIXED_POSITIONS, extra]).astype(np.int32)
    return torch.from_numpy(pos).cuda()


def _cache(torch, storage, shape, gen):
    """k or v in ``storage`` (+ f32 scales for a codec) from N(0, 1)."""
    from deepspeed_tpu_torch.inference.cache import _quantize
    from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
    x = torch.randn(shape, generator=gen, device="cuda")
    if storage in CODECS:
        return _quantize(x, storage)
    return x.to(getattr(torch, storage)), None


# a bf16 / f16 output is one rounding of an fp32 value the kernel and the
# plain version each compute to ~1e-6: they may differ by one unit in
# the last place, which is at most 2^-7 (bf16) / 2^-10 (f16) of |out|
RTOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}
ATOL = 2e-5
STORAGES = ("bfloat16", "float32", "int8", "f8e4m3fn", "f8e5m2")


def phase_kernel_check(torch):
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_reference)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases, worst = [], 0.0
    shapes = [(8, 12, 64), (8, 16, 96), (4, 4, 256)]
    for b, h, d in shapes:
        for storage in STORAGES:
            for qdt in ("bfloat16", "float32"):
                if d == 256 and qdt == "float32":
                    continue
                k, ks = _cache(torch, storage, (b, S, h, d), gen)
                v, vs = _cache(torch, storage, (b, S, h, d), gen)
                q = torch.randn((b, 1, h, d), generator=gen,
                                device="cuda").to(getattr(torch, qdt))
                pos = _positions(torch, rng)[:b]
                scales = (ks, vs) if ks is not None else ()
                out = flash_decode(q, k, v, pos, *scales,
                                   block_k=SERVE_BLOCK_K)
                ref = flash_decode_reference(q, k, v, pos, *scales,
                                             block_k=SERVE_BLOCK_K)
                torch.cuda.synchronize()
                diff = (out.float() - ref.float()).abs()
                allowed = ATOL + RTOL[qdt] * ref.float().abs()
                ok = bool(torch.isfinite(out.float()).all()) and \
                    bool((diff <= allowed).all())
                err = float(diff.max())
                worst = max(worst, err)
                case = {"B": b, "H": h, "D": d, "storage": storage,
                        "q": qdt, "max_abs_err": err, "atol": ATOL,
                        "rtol": RTOL[qdt], "ok": ok}
                if qdt == "bfloat16" and d == 64:
                    case["poison_bitwise"] = _poison_check(
                        torch, flash_decode, q, k, v, pos, ks, vs, out)
                    ok = ok and case["poison_bitwise"]
                cases.append(case)
                if not ok:
                    emit({"phase": "kernel_check", "failed": case})
                    fail(f"flash_decode disagrees with its plain "
                         f"version: {case}")
    emit({"phase": "kernel_check", "cases": len(cases),
          "max_abs_err": worst, "results": cases})
    return worst


def _fill(torch, x, mask, value):
    """``x`` with the [B, S] ``mask`` slots set to ``value`` (fp8
    storage is written through its bytes)."""
    y = x.clone()
    if y.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        bits = torch.tensor(value).to(y.dtype).view(torch.uint8).item()
        y.view(torch.uint8)[mask] = bits
    else:
        y[mask] = value
    return y


def _poison_check(torch, flash_decode, q, k, v, pos, ks, vs, clean):
    """Slots past each row's position hold huge garbage (a recycled
    ring row's previous tenant): the output must not change a bit."""
    dead = torch.arange(S, device="cuda")[None, :] > pos[:, None].long()
    big = 100.0 if k.dtype == torch.int8 else 1e4 if ks is None else 400.0
    scales = ()
    if ks is not None:
        scales = (_fill(torch, ks, dead, 1e4), _fill(torch, vs, dead, 1e4))
    out = flash_decode(q, _fill(torch, k, dead, big),
                       _fill(torch, v, dead, -big), pos, *scales,
                       block_k=SERVE_BLOCK_K)
    torch.cuda.synchronize()
    return bool(torch.equal(out, clean))


def _events_ms(torch, fn, n_calls, sleep_cycles=0):
    """CUDA-event ms per call over ``fn(i)`` for i in range(n_calls);
    with ``sleep_cycles`` the device first spins that long, so the host
    has queued every call before the first one runs. Returns the ms and
    whether the device was still spinning when the host finished."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for i in range(n_calls):
        fn(i)
    end.record()
    host_ahead = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / n_calls, host_ahead


def _span_ms(torch, fn, n_calls):
    """Mean CUDA-event span of each call on its own (start and end
    recorded around every call)."""
    spans = []
    for i in range(n_calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(i)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / n_calls


def _time_ms(torch, fn, n_calls, reps=5):
    """``(device_ms, host_paced_ms, host_syncs)`` per call, medians
    over ``reps``.

    ``host_paced_ms``: calls issued back to back as a caller issues
    them, so host launch overhead shows when it exceeds the device
    time. ``device_ms``: the same calls queued behind a device-side
    spin long enough for the host to get ahead, so the events time the
    device work alone (checked: the spin must outlast the enqueue). A
    call that waits on the device inside (``host_syncs``) cannot be
    queued ahead; its device_ms is then the mean event span of each
    call on its own, which includes the host's re-launch gaps."""
    _events_ms(torch, fn, n_calls)                      # warmup
    paced = statistics.median(
        _events_ms(torch, fn, n_calls)[0] for _ in range(reps))
    # spin for twice the host-paced time at up to 2 GHz clocks
    cycles = int(2 * paced * n_calls * 1e-3 * 2e9)
    device, misses = [], 0
    while len(device) < reps:
        ms, ahead = _events_ms(torch, fn, n_calls, cycles)
        if ahead:
            device.append(ms)
            continue
        misses += 1
        cycles *= 2
        if misses == 3:
            spans = [_span_ms(torch, fn, n_calls) for _ in range(reps)]
            return statistics.median(spans), paced, True
    return statistics.median(device), paced, False


def _bound(torch, pos, H, D, storage, qbytes):
    """Least time for one call: bytes it must move (q, occupied k/v and
    scales, positions read once; out written once) at the HBM rate, or
    its flops at the peak for the storage type, whichever is larger."""
    from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
    keys = int((pos.long().clamp(max=S - 1) + 1).sum())
    quant = storage in CODECS
    dtype = CODECS[storage].dtype if quant else getattr(torch, storage)
    nbytes = 2 * keys * H * D * dtype.itemsize + 2 * B * H * D * qbytes \
        + 4 * B
    if quant:
        nbytes += 2 * keys * H * 4
    flops = 4 * keys * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[str(dtype).replace("torch.", "")] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def phase_kernel_timing(torch):
    """Time the kernel on the 125M decode shape over N_LAYER separate
    layer caches in turn (150+ MB, past the 50 MB L2: each call finds
    its layer cold, as the decode step does)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode, flash_decode_reference)
    H, D = 12, 64
    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    # positions the serve stream's decode steps see: prompts of 8-120
    # tokens plus up to 32 generated ones
    mixes = {"serve_mix": torch.from_numpy(
        rng.integers(8, 152, B).astype(np.int32)).cuda(),
        "full": torch.full((B,), S - 1, dtype=torch.int32, device="cuda")}
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    results = {}
    for storage in ("bfloat16", "int8"):
        layers = [(_cache(torch, storage, (B, S, H, D), gen),
                   _cache(torch, storage, (B, S, H, D), gen))
                  for _ in range(N_LAYER)]

        def args(i):
            (k, ks), (v, vs) = layers[i % N_LAYER]
            return (q, k, v), (ks, vs) if ks is not None else ()

        for mix, pos in mixes.items():
            def kern(i):
                base, sc = args(i)
                flash_decode(*base, pos, *sc, block_k=SERVE_BLOCK_K)

            def plain(i):
                base, sc = args(i)
                flash_decode_reference(*base, pos, *sc,
                                       block_k=SERVE_BLOCK_K)

            ms, paced, kern_sync = _time_ms(torch, kern, 10 * N_LAYER)
            plain_ms, plain_paced, plain_sync = _time_ms(torch, plain,
                                                         2 * N_LAYER)
            bound, by, nbytes = _bound(torch, pos, H, D, storage, 2)
            row = {"ms": ms, "host_paced_ms": paced, "host_syncs": kern_sync,
                   "plain_ms": plain_ms,
                   "plain_host_paced_ms": plain_paced,
                   "plain_host_syncs": plain_sync, "bound_ms": bound,
                   "bound_by": by, "bytes": nbytes,
                   "roofline_share": bound / ms, "positions": pos.tolist(),
                   "library_ms": None}
            if storage == "bfloat16":
                mask = (torch.arange(S, device="cuda")[None, :]
                        <= pos[:, None].long())[:, None, None, :]

                def lib(i):
                    (k, _), (v, _) = layers[i % N_LAYER]
                    F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), attn_mask=mask)

                (row["library_ms"], row["library_host_paced_ms"],
                 row["library_host_syncs"]) = _time_ms(torch, lib,
                                                       10 * N_LAYER)
            results[f"{storage}/{mix}"] = row
    emit({"phase": "kernel_timing", "shape": [B, S, H, D],
          "results": results})
    return results


def _make_model(torch, seed):
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_125m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return GPT2LMHead(gpt2_125m(), device="cuda", generator=gen)


def _engine(torch, kv, impl, session=None):
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(
        _make_model(torch, 0), session=session, device="cuda",
        config={"max_batch": B, "seq_buckets": (128, 512),
                "prefill_chunk": 64, "kv_cache_dtype": kv,
                "attention_impl": impl})


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


# teacher-forced flash vs dense logits, bf16 compute: the dense path
# rounds scores and probabilities to bf16, the kernel keeps them fp32;
# over 12 random-init layers that stays well under 0.05 on logits of
# magnitude ~1
TEACHER_FORCED_ATOL = 0.05


def _teacher_forced_diff(torch, kv):
    """Same params, same prompts, same forced tokens through a flash and
    a dense engine: max |logit difference| over every decode step and
    row."""
    rng = np.random.default_rng(2)
    flash = _engine(torch, kv, "flash")
    dense = _engine(torch, kv, "dense")
    lens = rng.integers(8, 150, B)
    prompts = [rng.integers(0, 50257, n).tolist() for n in lens]
    worst, scale = 0.0, 0.0
    for eng in (flash, dense):
        for i, p in enumerate(prompts):
            eng.prefill(i, p)
    pos = lens.astype(np.int32)
    for _ in range(8):
        toks = rng.integers(0, 50257, B).astype(np.int32)
        _, lf = flash.decode(toks, pos)
        _, ld = dense.decode(toks, pos)
        if not (np.isfinite(lf).all() and lf.shape == (B, 50257)):
            fail(f"flash decode logits not finite / wrong shape {lf.shape}")
        worst = max(worst, float(np.abs(lf - ld).max()))
        scale = max(scale, float(np.abs(ld).max()))
        pos = pos + 1
    del flash, dense
    return worst, scale


def _profile_decode(torch, engine, steps=10):
    """Where a decode step's time goes: ``torch.profiler`` over
    ``steps`` full-batch decode steps (positions mid-stream) — host
    wall, device busy time (sum of kernel self times) and its share of
    the wall, and the kernels that take most of it. Device fields are
    None when the profiler records no device time."""
    rng = np.random.default_rng(3)
    vocab = engine.model.config.vocab_size
    pos = rng.integers(8, 152, B).astype(np.int32)
    toks = rng.integers(0, vocab, B).astype(np.int32)
    engine.decode(toks, pos)
    return _profile(torch, lambda: engine.decode(toks, pos), steps)


def _profile(torch, step, steps):
    """``torch.profiler`` over ``steps`` calls of ``step()``: host wall
    per step, device busy time (sum of kernel self times), its share of
    the wall, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((us / steps / 1e3, e.count // steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy if kernels else None,
            "device_busy_share": busy / wall_ms if kernels else None,
            "kernels_per_step": sum(k[1] for k in kernels),
            "top_kernels": [{"name": name[:80], "ms_per_step": ms,
                             "calls_per_step": n}
                            for ms, n, name in kernels[:8]]}


def phase_serve(torch, kv):
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler, Request)
    from deepspeed_tpu_torch.ops.flash_decode import flash_decode
    from deepspeed_tpu_torch.telemetry.session import TelemetrySession

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    session = TelemetrySession(history=1_000_000)
    engine = _engine(torch, kv, "flash", session=session)
    sched = ContinuousBatchingScheduler(engine)
    rng = np.random.default_rng(0)
    vocab = engine.model.config.vocab_size
    warmup = Request("warmup", rng.integers(0, vocab, 8).tolist(),
                     max_new_tokens=4)
    reqs = [Request(f"r{i}",
                    rng.integers(0, vocab,
                                 int(rng.integers(8, 120))).tolist(),
                    max_new_tokens=32, arrival_step=i)
            for i in range(24)]
    flash_decode.launches = 0
    t0 = time.perf_counter()
    sched.run([warmup])
    n0 = len(session.events.recent(event="decode_step"))
    t1 = time.perf_counter()
    completions = sched.run(reqs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_decode.launches
    steps = session.events.recent(event="decode_step")
    evts = steps[n0:]
    walls = [float(e["wall_s"]) for e in evts]
    tokens = sum(int(e["tokens"]) for e in evts)
    lat = [w for e in evts for w in [float(e["wall_s"])] * int(e["tokens"])]
    counts = engine.compile_counts()
    done = [c for c in completions if c.rid != "warmup"]
    row = {"phase": "serve", "model": "gpt2_125m", "kv_cache_dtype": kv,
           "attention": "flash", "requests": len(reqs),
           "completed": len(done),
           "finish_reasons": sorted({c.finish_reason for c in done}),
           "decode_steps": len(steps), "kernel_launches": launches,
           "launches_per_step": launches / max(len(steps), 1),
           "tokens": tokens,
           "tokens_per_s": tokens / max(sum(walls), 1e-9),
           "tokens_per_s_wall": tokens / (t2 - t1),
           "warmup_s": t1 - t0,
           "p50_ms": _percentile(lat, 0.50) * 1e3,
           "p99_ms": _percentile(lat, 0.99) * 1e3,
           "latency_samples": len(lat),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "compile_counts": counts,
           "cache_bytes": engine.cache_facts()["bytes"]}
    row["decode_profile"] = _profile_decode(torch, engine)
    del engine, sched
    diff, scale = _teacher_forced_diff(torch, kv)
    row.update(teacher_forced_max_abs_diff=diff,
               teacher_forced_logit_scale=scale,
               teacher_forced_atol=TEACHER_FORCED_ATOL)
    emit(row)
    if len(done) != len(reqs) or \
            row["finish_reasons"] != ["max_new_tokens"]:
        fail(f"not every request completed: {row}")
    if counts != {"prefill": 1, "decode": 1}:
        fail(f"compile_counts {counts} != {{'prefill': 1, 'decode': 1}}")
    if launches != N_LAYER * len(steps) or not steps:
        fail(f"flash_decode launched {launches} times over {len(steps)} "
             f"decode steps; expected {N_LAYER} per step")
    if not diff <= TEACHER_FORCED_ATOL:
        fail(f"flash vs dense teacher-forced logits differ by {diff} > "
             f"{TEACHER_FORCED_ATOL}")
    return row


# ---------------------------------------------------------------------------
# training slice: flash attention K1-K3, fused Adam K4, GPT-2 350M
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D = 8, 1024, 16, 64
TRAIN_LAYERS = 24
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
HEAD_OFFSET, NUM_HEADS = 3, 24      # a head shard's global coordinates
BF16_PEAK_FLOPS = 989e12             # H100 SXM dense bf16
# K1-K3 outputs are one rounding of fp32 sums that the kernel and the
# plain version take in different orders: up to one unit in the last
# place of the output type (relative), plus fp32 summation noise of
# ~1e-5 of the largest value
TRAIN_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}
TRAIN_ATOL_REL = 1e-5
# flash vs dense engines on the same params and batch, bf16: the dense
# route rounds scores, probabilities and their gradients to bf16, the
# kernels keep them in fp32. Losses (~11 nats) over 3 steps: the gap
# measured at step 1 is ~1e-4, so 5e-3 leaves 50x. The c_attn weight
# gradients of the first micro-batch (the q, k and v rows: what dq, dk
# and dv feed), as ||flash - dense|| / ||dense|| over the 24 layers:
# bf16 rounding of each value (2^-9 to 2^-8) puts the honest gap at a
# few percent at most; a wrong K2 or K3 gives ~1.
TRAIN_LOSS_ATOL = 5e-3
TRAIN_GRAD_RTOL = 0.05
# K4 against its plain version, relative to the leaf's largest value
ADAM_RTOL = 1e-6


def _attn_inputs(torch, b, t, h, d, dtype, bias, gen):
    """q, k, v as strided views of one fused [B, T, 3, H, D] tensor (as
    the model's c_attn output gives them), dO, and a key bias with every
    7th key hard-masked."""
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
    qkv = qkv.to(dtype)
    q, k, v = qkv.unbind(2)
    g = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dtype)
    kb = None
    if bias:
        from deepspeed_tpu_torch.ops.flash_attention import MASK_BIAS
        kb = torch.randn((b, t), generator=gen, device="cuda")
        kb[:, 3::7] = MASK_BIAS
    return q, k, v, g, kb


def _close(torch, got, want, rtol):
    """(max |diff|, within atol + rtol * |want|) for one output."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    allowed = TRAIN_ATOL_REL * float(want.abs().max()) + rtol * want.abs()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= allowed).all())
    return float(diff.max()), ok


def _attn_case(torch, fa, b, t, h, d, dtype, causal, bias, rate, gen):
    q, k, v, g, kb = _attn_inputs(torch, b, t, h, d, getattr(torch, dtype),
                                  bias, gen)
    kw = dict(key_bias=kb, causal=causal, dropout_rate=rate,
              dropout_seed=-123456789, dropout_head_offset=HEAD_OFFSET,
              dropout_num_heads=NUM_HEADS)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * ref_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, ref_lse, delta, **kw)
    ref_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, ref_lse, delta,
                                                 **kw)
    dk, dv, db = fa.flash_attention_bwd_dkv(q, k, v, g, ref_lse, delta, **kw)
    ref_dk, ref_dv, ref_db = fa.flash_attention_bwd_dkv_reference(
        q, k, v, g, ref_lse, delta, **kw)
    torch.cuda.synchronize()
    rtol = TRAIN_RTOL[dtype]
    checks = {"out": _close(torch, out, ref_out, rtol),
              "lse": _close(torch, lse, ref_lse, TRAIN_RTOL["float32"]),
              "dq": _close(torch, dq, ref_dq, rtol),
              "dk": _close(torch, dk, ref_dk, rtol),
              "dv": _close(torch, dv, ref_dv, rtol)}
    if bias:
        checks["dbias"] = _close(torch, db, ref_db, TRAIN_RTOL["float32"])
    case = {"B": b, "T": t, "H": h, "D": d, "dtype": dtype,
            "causal": causal, "bias": bias, "dropout": rate,
            "max_abs_err": {n: c[0] for n, c in checks.items()},
            "ok": all(c[1] for c in checks.values())}
    return case


def _dropout_bitwise(torch, fa):
    """K1's dropout mask, read back: with q = k = 0 every probability is
    1/S and v = I (S = D = 64) makes out[t, d] = mult(t, d) / S, so
    ``out * S`` must equal ``dropout_multiplier`` bit for bit."""
    b, t, h, s = 2, 128, TRAIN_H, 64
    q = torch.zeros((b, t, h, s), device="cuda")
    k = torch.zeros((b, s, h, s), device="cuda")
    v = torch.eye(s, device="cuda")[None, :, None, :].expand(
        b, s, h, s).contiguous()
    ok = True
    for seed, rate in ((-123456789, 0.1), (7, 0.5), (2 ** 31 - 1, 0.25)):
        out, _ = fa.flash_attention_fwd(
            q, k, v, causal=False, dropout_rate=rate, dropout_seed=seed,
            dropout_head_offset=HEAD_OFFSET, dropout_num_heads=NUM_HEADS)
        mult = fa._dropout_multiplier_full(b, h, t, s, rate, seed,
                                           HEAD_OFFSET, NUM_HEADS,
                                           device="cuda")
        ok = ok and bool(torch.equal(out.permute(0, 2, 1, 3) * s, mult))
    return ok


ADAM_SIZES = (1, 3, 517, 4099, 65536 + 5, 300001)


def _adam_leaves(torch, gen, misaligned):
    leaves = []
    for i, n in enumerate(ADAM_SIZES):
        group = []
        for _ in range(4):
            base = torch.empty(n + 1, device="cuda")
            x = base[1:] if (misaligned and i % 2) else base[:n]
            group.append(x)
        p, g, m, v = group
        p.copy_(torch.randn(n, generator=gen, device="cuda"))
        g.copy_(torch.randn(n, generator=gen, device="cuda"))
        m.zero_()
        v.zero_()
        leaves.append(group)
    return leaves


def _adam_compare(kern, plain):
    """(max |diff|, all within ADAM_RTOL) over paired K4 / plain
    tensors."""
    worst, ok = 0.0, True
    for a, b in zip(kern, plain):
        err = float((a - b).abs().max())
        worst = max(worst, err)
        ok = ok and err <= ADAM_RTOL * (1.0 + float(b.abs().max()))
    return worst, ok


def _adam_check(torch):
    """K4 against its plain version: 3 steps then a skipped one, both
    modes, odd leaf sizes, some leaves 4 bytes off 16-byte alignment."""
    from deepspeed_tpu_torch.ops.fused_adam import (
        adam_hyperparams, fused_adam, fused_adam_reference)
    worst, ok = 0.0, True
    for adam_w in (True, False):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        kern = _adam_leaves(torch, gen, misaligned=True)
        plain = [[x.clone() for x in group] for group in kern]
        for step in range(1, 5):
            skip = 1.0 if step == 4 else 0.0
            hyper = adam_hyperparams(1e-3, 0.9, 0.999, 1e-8, 0.01,
                                     1.0 - 0.9 ** step, 1.0 - 0.999 ** step,
                                     skip, "cuda")
            before = [x.clone() for group in kern for x in group]
            for leaves, fn in ((kern, fused_adam),
                               (plain, fused_adam_reference)):
                p, g, m, v = (list(c) for c in zip(*leaves))
                fn(p, g, m, v, hyper, adam_w_mode=adam_w)
            torch.cuda.synchronize()
            err, step_ok = _adam_compare((x for gr in kern for x in gr),
                                         (x for gr in plain for x in gr))
            worst, ok = max(worst, err), ok and step_ok
            if skip:
                after = [x for group in kern for x in group]
                ok = ok and all(torch.equal(a, b)
                                for a, b in zip(before, after))
    return worst, ok


def phase_train_kernel_check(torch):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    grid = [(2, 128, TRAIN_H, 64, dt, c, bias, r)
            for dt in ("bfloat16", "float32") for c in (True, False)
            for bias in (False, True) for r in (0.0, 0.1)]
    grid += [(2, 1000, TRAIN_H, 64, "bfloat16", True, True, 0.1),
             (2, 1000, TRAIN_H, 64, "float32", False, False, 0.1),
             (TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D, "bfloat16", True, False,
              0.0),
             (2, 1000, TRAIN_H, 128, "bfloat16", True, True, 0.1),
             (2, 128, TRAIN_H, 128, "float32", False, True, 0.0)]
    cases = []
    for spec in grid:
        case = _attn_case(torch, fa, *spec, gen)
        cases.append(case)
        if not case["ok"]:
            emit({"phase": "train_kernel_check", "failed": case})
            fail(f"flash attention kernels disagree with their plain "
                 f"versions: {case}")
    bitwise = _dropout_bitwise(torch, fa)
    adam_err, adam_ok = _adam_check(torch)
    errs = {
        "K1": max(max(c["max_abs_err"]["out"], c["max_abs_err"]["lse"])
                  for c in cases),
        "K2": max(c["max_abs_err"]["dq"] for c in cases),
        "K3": max(max(v for n, v in c["max_abs_err"].items()
                      if n in ("dk", "dv", "dbias")) for c in cases),
        "K4": adam_err}
    emit({"phase": "train_kernel_check", "cases": len(cases),
          "dropout_mask_bitwise": bitwise, "adam_ok": adam_ok,
          "max_abs_err": errs, "rtol": TRAIN_RTOL,
          "atol_rel": TRAIN_ATOL_REL, "results": cases})
    if not bitwise:
        fail("K1's dropout mask differs from dropout_multiplier")
    if not adam_ok:
        fail(f"fused_adam disagrees with its plain version ({adam_err})")
    return errs


def _causal_pairs(b, h, t):
    return b * h * t * (t + 1) // 2


def _gpt2_shapes(cfg):
    """The 292 param shapes of GPT-2 (wte, wpe, 12 per layer, ln_f)."""
    c = cfg.n_embd
    layer = [(c,), (c,), (3 * c, c), (3 * c,), (c, c), (c,), (c,), (c,),
             (4 * c, c), (4 * c,), (c, 4 * c), (c,)]
    return ([(cfg.vocab_size, c), (cfg.n_positions, c)]
            + layer * cfg.n_layer + [(c,), (c,)])


def phase_train_kernel_timing(torch):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.models.gpt2 import gpt2_350m
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import (
        adam_hyperparams, fused_adam, fused_adam_reference)
    b, t, h, d = TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_D
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v, g, _ = _attn_inputs(torch, b, t, h, d, torch.bfloat16, False,
                                 gen)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    pairs = _causal_pairs(b, h, t)
    io = 2 * b * t * h * d                     # bytes of one bf16 tensor
    rows = {}

    def row(name, kern, plain, flops, nbytes, dtype, lib=None):
        """The bound takes the operations at the peak for the inputs'
        type (bf16 tensor cores for K1-K3), the least time the card could
        take; ``fp32_ops_ms`` is the same count at the fp32 (CUDA-core)
        peak, the rate the current K1-K3 multiply at."""
        ms, paced, _ = _time_ms(torch, kern, 10)
        plain_ms, _, plain_sync = _time_ms(torch, plain, 3)
        t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        r = {"ms": ms, "host_paced_ms": paced, "plain_ms": plain_ms,
             "plain_host_syncs": plain_sync, "flops": flops,
             "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "fp32_ops_ms": flops / PEAK_OPS_PER_S["float32"] * 1e3,
             "library_ms": None}
        if lib is not None:
            r["library_ms"] = _time_ms(torch, lib, 10)[0]
        r["roofline_share"] = r["bound_ms"] / ms
        rows[name] = r

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_in = [x.detach().requires_grad_() for x in (qt, kt, vt)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_in, is_causal=True)
    g_t = g.transpose(1, 2)
    row("K1", lambda i: fa.flash_attention_fwd(q, k, v),
        lambda i: fa.flash_attention_fwd_reference(q, k, v),
        4 * pairs * d, 4 * io + 4 * b * h * t, "bfloat16",
        lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))

    def sdpa_bwd(i):
        torch.autograd.grad(sdpa_out, sdpa_in, g_t, retain_graph=True)

    row("K2", lambda i: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta),
        lambda i: fa.flash_attention_bwd_dq_reference(q, k, v, g, lse,
                                                       delta),
        6 * pairs * d, 5 * io + 8 * b * h * t, "bfloat16", sdpa_bwd)
    row("K3", lambda i: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta),
        lambda i: fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse,
                                                       delta),
        8 * pairs * d, 6 * io + 8 * b * h * t, "bfloat16", sdpa_bwd)
    del sdpa_out, sdpa_in

    # K4 over GPT-2 350M's leaves (354.8 M fp32 elements) with the main
    # path's hyperparameters (Adam, lr 1e-4, step 1, so L2 mode): one
    # step against the plain version on copies of the same leaves, then
    # the timing
    shapes = _gpt2_shapes(gpt2_350m())
    p, gr, m, vv = ([torch.randn(s, generator=gen, device="cuda") * 0.02
                     for s in shapes] for _ in range(4))
    for x in vv:
        x.abs_()
    n = sum(x.numel() for x in p)
    hyper = adam_hyperparams(1e-4, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001, 0.0,
                             "cuda")
    plain = [[x.clone() for x in xs] for xs in (p, m, vv)]
    fused_adam(p, gr, m, vv, hyper, adam_w_mode=False)
    fused_adam_reference(plain[0], gr, plain[1], plain[2], hyper,
                         adam_w_mode=False)
    torch.cuda.synchronize()
    k4_err, k4_ok = _adam_compare(p + m + vv, sum(plain, []))
    del plain
    if not k4_ok:
        fail(f"fused_adam disagrees with its plain version over the 350M "
             f"leaves ({k4_err})")
    lib_params = [torch.nn.Parameter(x.clone()) for x in p]
    for lp, x in zip(lib_params, gr):
        lp.grad = x.clone()
    adamw = torch.optim.AdamW(lib_params, lr=1e-4, fused=True)
    row("K4", lambda i: fused_adam(p, gr, m, vv, hyper, adam_w_mode=False),
        lambda i: fused_adam_reference(p, gr, m, vv, hyper,
                                       adam_w_mode=False),
        15 * n, 28 * n, "float32", lambda i: adamw.step())
    rows["K4"].update(leaves=len(p), elements=n, max_abs_err=k4_err)
    del p, gr, m, vv, lib_params, adamw
    torch.cuda.empty_cache()
    emit({"phase": "train_kernel_timing", "shape": [b, t, h, d],
          "dtype": "bfloat16", "causal": True, "results": rows})
    return rows


def _train_engine(torch, flash, extra=None):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_350m
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = GPT2LMHead(gpt2_350m(n_positions=TRAIN_T, dropout=0.0,
                                 use_flash_attention=flash, loss_chunk=0),
                       device="cuda", generator=gen)
    config = {"train_batch_size": TRAIN_B, "bf16": {"enabled": True},
              "optimizer": {"type": "Adam",
                            "params": {"lr": 1e-4, "pallas": True}},
              "steps_per_print": 10 ** 9, **(extra or {})}
    engine, _, _, _ = initialize(model=model, config=config)
    return engine


def _flash_counters():
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    return {"K1": fa.flash_attention_fwd, "K2": fa.flash_attention_bwd_dq,
            "K3": fa.flash_attention_bwd_dkv, "K4": fused_adam}


def model_flops_per_token(cfg, seq_len):
    """Matmul FLOPs per token, fwd + bwd (the JAX bench's formula,
    ``bench.py:39-48``): 6x the block and tied-head weights plus the
    attention score/value matmuls."""
    block_params = cfg.n_layer * (12 * cfg.n_embd ** 2 + 13 * cfg.n_embd)
    lm_head = cfg.vocab_size * cfg.n_embd
    attention = 12 * cfg.n_layer * cfg.n_embd * seq_len
    return 6 * (block_params + 2 * cfg.n_embd + lm_head) + attention


def _accum_run(torch, flash, batch, counters):
    """3 steps with gradient accumulation 2 (micro-batch 4) from the
    seeded params. Step 1 goes through forward / backward / step, so the
    c_attn weight gradients of its first micro-batch are read before
    the update. Returns the losses, those gradients per layer, the
    kernel launches of the 3 steps and the peak memory."""
    engine = _train_engine(torch, flash,
                           extra={"gradient_accumulation_steps": 2})
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    half = TRAIN_B // 2
    micro_losses, grads = [], None
    for i in range(2):
        loss = engine.forward({k: x[i * half:(i + 1) * half]
                               for k, x in batch.items()})
        engine.backward(loss)
        micro_losses.append(float(loss.detach()))
        if grads is None:
            grads = [blk.attn.c_attn.weight.grad.clone()
                     for blk in engine.module.h]
    engine.step()
    losses = [sum(micro_losses) / 2] + \
        [float(engine.train_batch(batch)) for _ in range(2)]
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    del engine
    torch.cuda.empty_cache()
    return losses, grads, launches, peak


def _grad_rel_err(torch, got, want, c):
    """||got - want|| / ||want|| over the layers, for each of the q, k
    and v row blocks of the c_attn weight gradient."""
    out = {}
    for i, part in enumerate("qkv"):
        a = torch.cat([g[i * c:(i + 1) * c].flatten() for g in got])
        b = torch.cat([w[i * c:(i + 1) * c].flatten() for w in want])
        out[part] = float((a - b).norm() / b.norm())
    return out


def phase_train(torch):
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 50257, (TRAIN_B, TRAIN_T))
             .astype(np.int32)}
    counters = _flash_counters()

    engine = _train_engine(torch, flash=True)
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    losses, walls = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append(time.perf_counter() - t0)
    launches = {n: c.launches for n, c in counters.items()}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    timed = walls[TRAIN_WARMUP:]
    tokens = TRAIN_B * TRAIN_T
    cfg = engine.module.config
    fpt = model_flops_per_token(cfg, TRAIN_T)
    tps = tokens * len(timed) / sum(timed)
    profile = _profile(torch, lambda: engine.train_batch(batch), 2)
    del engine
    torch.cuda.empty_cache()

    accum_losses, flash_grads, accum_launches, _ = _accum_run(
        torch, True, batch, counters)
    # the same params and micro-batches through dense attention
    dense_losses, dense_grads, _, dense_peak = _accum_run(
        torch, False, batch, counters)
    grad_err = _grad_rel_err(torch, flash_grads, dense_grads, cfg.n_embd)
    loss_gap = max(abs(a - b) for a, b in
                   zip([losses[0]] + accum_losses, dense_losses[:1]
                       + dense_losses))
    del flash_grads, dense_grads

    row = {"phase": "train", "model": "gpt2_350m", "batch": TRAIN_B,
           "seq": TRAIN_T, "dtype": "bfloat16", "attention": "flash",
           "optimizer": "adam (fused K4)", "losses": losses,
           "step_wall_s": walls, "tokens_per_s": tps,
           "step_p50_ms": statistics.median(timed) * 1e3,
           "model_flops_per_token": fpt,
           "mfu": tps * fpt / BF16_PEAK_FLOPS,
           "max_memory_allocated": peak, "launches": launches,
           "steps": steps, "profile": profile,
           "accum2_losses": accum_losses, "accum2_launches": accum_launches,
           "dense_accum2_losses": dense_losses,
           "dense_accum2_max_memory_allocated": dense_peak,
           "flash_vs_dense_loss_gap": loss_gap,
           "loss_atol": TRAIN_LOSS_ATOL,
           "flash_vs_dense_c_attn_grad_rel_err": grad_err,
           "grad_rtol": TRAIN_GRAD_RTOL}
    emit(row)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training loss not finite and falling: {losses}")
    want = {"K1": TRAIN_LAYERS * steps, "K2": TRAIN_LAYERS * steps,
            "K3": TRAIN_LAYERS * steps, "K4": steps}
    if launches != want:
        fail(f"kernel launches {launches} != {want} over {steps} steps")
    want2 = {"K1": 2 * TRAIN_LAYERS * 3, "K2": 2 * TRAIN_LAYERS * 3,
             "K3": 2 * TRAIN_LAYERS * 3, "K4": 3}
    if accum_launches != want2 or not all(np.isfinite(accum_losses)):
        fail(f"accumulation run: launches {accum_launches} != {want2} or "
             f"losses {accum_losses}")
    if not loss_gap <= TRAIN_LOSS_ATOL:
        fail(f"flash losses {losses[0]}, {accum_losses} vs dense "
             f"{dense_losses}: gap {loss_gap} > {TRAIN_LOSS_ATOL}")
    if not all(e <= TRAIN_GRAD_RTOL for e in grad_err.values()):
        fail(f"flash vs dense c_attn gradients differ by {grad_err} > "
             f"{TRAIN_GRAD_RTOL} (relative)")
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel checks")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the GPU only")
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the deepspeed_tpu_torch package must sit beside this "
             f"script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device(torch)
    phase_build()
    worst = phase_kernel_check(torch)
    train_errs = phase_train_kernel_check(torch)
    if args.kernels_only:
        print(smi, flush=True)
        return 0
    timing = phase_kernel_timing(torch)
    serves = [phase_serve(torch, kv) for kv in (None, "int8")]
    train_timing = phase_train_kernel_timing(torch)
    train = phase_train(torch)
    t = timing["bfloat16/serve_mix"]
    kernels = [{
        "name": "flash_decode", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_decode.py:193",
        "launches": sum(s["kernel_launches"] for s in serves),
        "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]
    train_src = {
        "K1": ("flash_attention_fwd", "flash_attention.cu",
               "deepspeed_tpu/ops/pallas/flash_attention.py:275"),
        "K2": ("flash_attention_bwd_dq", "flash_attention.cu",
               "deepspeed_tpu/ops/pallas/flash_attention.py:489"),
        "K3": ("flash_attention_bwd_dkv", "flash_attention.cu",
               "deepspeed_tpu/ops/pallas/flash_attention.py:556"),
        "K4": ("fused_adam", "fused_adam.cu",
               "deepspeed_tpu/ops/pallas/fused_adam.py:30")}
    for key, (name, src, replaces) in train_src.items():
        r = train_timing[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": train["launches"][key],
            "max_abs_err": max(train_errs[key], r.get("max_abs_err", 0.0)),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
