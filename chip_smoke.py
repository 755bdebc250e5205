#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``deepspeed_tpu_torch``) on one
NVIDIA GPU: builds the port's CUDA kernels from this checkout, holds
each against its plain PyTorch version, times it, and serves GPT-2 125M
at full width through the port's main path.

    python3 chip_smoke.py                 # every phase (one GPU)
    python3 chip_smoke.py --kernels-only  # device, build, kernel check

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
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    vocab = engine.model.config.vocab_size
    pos = rng.integers(8, 152, B).astype(np.int32)
    toks = rng.integers(0, vocab, B).astype(np.int32)
    engine.decode(toks, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.decode(toks, pos)
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernel check")
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
    if args.kernels_only:
        print(smi, flush=True)
        return 0
    timing = phase_kernel_timing(torch)
    serves = [phase_serve(torch, kv) for kv in (None, "int8")]
    t = timing["bfloat16/serve_mix"]
    emit({"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_decode.py:193",
        "launches": sum(s["kernel_launches"] for s in serves),
        "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
