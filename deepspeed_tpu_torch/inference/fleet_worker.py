"""One serving-fleet replica worker: ``python -m
deepspeed_tpu_torch.inference.fleet_worker`` (port of
``deepspeed_tpu/inference/fleet_worker.py``).

Spawned by `inference/fleet.py:ProcessReplica` under the ``ds_tpu_run``
supervisor env contract. Protocol, all JSONL:

- stdin (router → worker): ``{"cmd": "submit", "request": {...}}`` and
  ``{"cmd": "stop"}``.
- stdout (worker → router): ``{"type": "ready", "pid": ...}`` once the
  engine is built, one ``{"type": "completion", "completion": {...}}``
  per finished request as it finishes (streamed — the router must see
  progress before the replica drains, or a mid-stream death would lose
  completed work), and a final ``{"type": "stats", ...}`` /
  ``{"type": "preempted", ...}``.
- ``hb-p<idx>.json`` heartbeat file in the workdir every loop tick
  (same schema as the hang watchdog's), suppressed while an armed
  ``heartbeat_stall`` fault is in effect.

Lifecycle contract (mirrors training workers):

- ``DS_TPU_SERVE_SPEC`` (env) carries the engine recipe: the inference
  config block, the params seed, the ``device`` (default the card; the
  CPU tests pass ``"cpu"``), optional ``jsonl`` telemetry path. The
  model is the serve CLI's test-size GPT-2 (``gpt2_tiny`` at n_embd
  32, f32), its params drawn from a ``torch.Generator`` seeded with the
  seed on the device, as ``inference/serve.py`` seeds its model
  (stacked when the spec's ``scan_layers`` is true).
- Faults arm from ``DS_TPU_SERVE_INJECT`` only when
  ``DS_TPU_RUN_RESTART_COUNT`` is 0 (first attempt).
- Clean stop: drain, report stats, write ``done-p<idx:05d>``, exit 0.
- SIGTERM (``PreemptionHandler``): finish the CURRENT decode step, emit
  a durable ``preemption`` telemetry event, flush completed-so-far
  completions, exit 0 WITHOUT the done marker — which is exactly what
  ``classify_exit`` reads as a preemption.
- SIGKILL / injected decode faults: the process dies mid-stream; the
  router's health check classifies and redispatches.

Stdout is the wire. Before anything else runs, the worker keeps a
private handle on the stdout it was given for the protocol and points
file descriptor 1 (and ``sys.stdout``) at stderr, so whatever torch,
the kernel build (``ops/_build.py``) or the package logger prints
lands in the replica's log instead of corrupting the JSONL stream.
"""

import collections
import json
import os
import socket
import sys
import threading
import time


_WIRE = None       # the protocol's stream (the original stdout)


def _claim_stdout():
    """Keep the original stdout for the protocol; send fd 1 and
    ``sys.stdout`` to stderr."""
    global _WIRE
    sys.stdout.flush()
    _WIRE = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr


def _out(msg):
    wire = _WIRE if _WIRE is not None else sys.stdout
    wire.write(json.dumps(msg) + "\n")
    wire.flush()


def _write_heartbeat(workdir, index, step, busy):
    from deepspeed_tpu_torch.telemetry.watchdog import heartbeat_path
    hb = {
        "t": time.time(),
        "hostname": socket.gethostname(),
        "process_index": index,
        "pid": os.getpid(),
        "step": step,
        "phase": "serve",
        "in_step": busy,
        "step_elapsed_s": 0.0,
    }
    path = heartbeat_path(workdir, index)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(hb, f)
        os.replace(tmp, path)
    except OSError:
        pass


class _CommandReader:
    """Blocking stdin reader on a daemon thread. select() over a
    buffered sys.stdin is a trap — readline() can pull several lines
    into Python's buffer while select() sees an empty fd, stranding
    commands — so a thread does blocking readline() and the serve loop
    drains the deque non-blockingly."""

    def __init__(self):
        self._lines = collections.deque()
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="fleet-worker-stdin")
        self._t.start()

    def _loop(self):
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                self._lines.append(json.loads(line))
            except ValueError:
                pass
        self._lines.append({"cmd": "stop"})     # EOF: router is gone

    def drain(self):
        cmds = []
        while self._lines:
            try:
                cmds.append(self._lines.popleft())
            except IndexError:
                break
        return cmds


def _request_from(d):
    from deepspeed_tpu_torch.inference.scheduler import Request
    return Request(
        rid=str(d["rid"]),
        prompt=[int(t) for t in d["prompt"]],
        max_new_tokens=int(d.get("max_new_tokens", 16)),
        eos_id=d.get("eos_id"),
        arrival_step=int(d.get("arrival_step", 0)),
        session_id=d.get("session_id"),
        deadline_s=d.get("deadline_s"),
        queue_timeout_s=d.get("queue_timeout_s"),
        redispatched=int(d.get("redispatched", 0)),
        restarts=int(d.get("restarts", 0)))


def _decode_launches():
    """The decode kernels' launch counts in this process (K5 ring, K6
    paged): what ``chip_smoke.py`` reads off a worker's ``stats``."""
    from deepspeed_tpu_torch.ops.flash_decode import (
        flash_decode,
        flash_decode_paged,
    )
    return {"flash_decode": flash_decode.launches,
            "flash_decode_paged": flash_decode_paged.launches}


def _tier_loop(worker, engine, handler, reader, session, workdir,
               index):
    """Serve loop for a disaggregated TIER worker (``spec["tier"]``):
    same lifecycle contract as the colocated loop below — streamed
    outputs, heartbeats, preemption/stop semantics — but driving a
    `inference/disagg.py` PrefillWorker/DecodeWorker instead of the
    colocated scheduler. Handoff outputs travel as their own JSONL
    kinds (``prefilled``/``handoff_corrupt``/...)."""
    from deepspeed_tpu_torch.runtime.resilience import fault_injection

    def _steps():
        return worker.sched.step_count if hasattr(worker, "sched") \
            else worker.steps

    reported = 0
    stalled_until = 0.0
    stopping = False
    while True:
        if not worker.has_work and not stopping:
            time.sleep(0.002)
        for cmd in reader.drain():
            if cmd.get("cmd") == "submit":
                worker.submit(_request_from(cmd["request"]),
                              cmd.get("handoff"))
            elif cmd.get("cmd") == "stop":
                stopping = True

        has_work = worker.has_work
        if has_work:
            worker.step()       # kill/decode fault probes fire inside

        for out in worker.drain_outputs():
            kind = out.pop("kind", "completion")
            if kind == "completion":
                reported += 1
                _out({"type": "completion", "completion": out})
            else:
                _out({"type": kind, "payload": out})

        now = time.time()
        stall = fault_injection.heartbeat_stall_seconds(_steps())
        if stall:
            stalled_until = now + stall
        if now >= stalled_until:
            _write_heartbeat(workdir, index, _steps(), has_work)

        if handler.preempted:
            if session is not None:
                session.emit("preemption", step=_steps(),
                             completed=reported, replica=index,
                             tier=worker.tier)
                session.close()
            _out({"type": "preempted", "completed": reported,
                  "steps": _steps(), "tier": worker.tier})
            return 0            # exit 0, NO done marker -> preemption

        if stopping and not has_work:
            break

    _out(dict(worker.stats(), type="stats", replica=index,
              launches=_decode_launches()))
    if session is not None:
        session.close()
    from deepspeed_tpu_torch.runtime.supervisor.supervisor import done_path
    with open(done_path(workdir, index), "w") as f:
        f.write("done\n")
    return 0


def main():
    index = int(os.environ.get("DS_TPU_RUN_PROCESS_INDEX", "0"))
    workdir = os.environ.get("DS_TPU_RUN_WORKDIR", os.getcwd())
    restart_count = int(os.environ.get("DS_TPU_RUN_RESTART_COUNT", "0"))
    spec = json.loads(os.environ["DS_TPU_SERVE_SPEC"])
    _claim_stdout()

    from deepspeed_tpu_torch.runtime.resilience import fault_injection
    if restart_count == 0:
        fault_injection.arm_from_env()

    from deepspeed_tpu_torch import resolve_device
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.fleet import completion_dict
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler)
    from deepspeed_tpu_torch.inference.serve import seeded_tiny_model
    from deepspeed_tpu_torch.runtime.resilience.preemption import (
        PreemptionHandler)

    session = None
    if spec.get("jsonl"):
        from deepspeed_tpu_torch.telemetry.exporters import JsonlExporter
        from deepspeed_tpu_torch.telemetry.session import TelemetrySession
        session = TelemetrySession(
            exporters=[JsonlExporter(spec["jsonl"])])

    device = resolve_device(spec.get("device"))
    model = seeded_tiny_model(int(spec.get("seed", 0)), device,
                              bool(spec.get("scan_layers", False)))
    tier = spec.get("tier")
    inf_cfg = dict(spec.get("inf_cfg") or {})
    if tier:
        inf_cfg["tier"] = tier
    engine = InferenceEngine(model, config=inf_cfg, session=session,
                             device=device)

    if tier:
        from deepspeed_tpu_torch.inference.disagg import (
            DecodeWorker, FileHandoffStore, PrefillWorker)
        store = FileHandoffStore(spec["handoff_dir"])
        worker = (PrefillWorker if tier == "prefill"
                  else DecodeWorker)(engine, store, session=session)
        handler = PreemptionHandler().install()
        reader = _CommandReader()
        _out({"type": "ready", "pid": os.getpid(), "replica": index,
              "tier": tier})
        return _tier_loop(worker, engine, handler, reader, session,
                          workdir, index)

    sched = ContinuousBatchingScheduler(engine)

    handler = PreemptionHandler().install()
    reader = _CommandReader()
    _out({"type": "ready", "pid": os.getpid(), "replica": index})

    reported = 0
    stalled_until = 0.0
    stopping = False
    while True:
        idle = not (sched.queue or any(
            s is not None for s in sched.slots))
        if idle and not stopping:
            time.sleep(0.002)
        for cmd in reader.drain():
            if cmd.get("cmd") == "submit":
                sched.submit(_request_from(cmd["request"]))
            elif cmd.get("cmd") == "stop":
                stopping = True

        has_work = bool(sched.queue) or any(
            s is not None for s in sched.slots)
        if has_work:
            sched.step()        # kill/decode fault probes fire inside

        for c in sched.completions[reported:]:
            _out({"type": "completion", "completion": completion_dict(c)})
        reported = len(sched.completions)

        now = time.time()
        stall = fault_injection.heartbeat_stall_seconds(sched.step_count)
        if stall:
            stalled_until = now + stall
        if now >= stalled_until:
            _write_heartbeat(workdir, index, sched.step_count, has_work)

        if handler.preempted:
            # SIGTERM: the current decode step already finished above.
            if session is not None:
                session.emit("preemption", step=sched.step_count,
                             completed=reported, replica=index)
                session.close()
            _out({"type": "preempted", "completed": reported,
                  "steps": sched.step_count})
            return 0            # exit 0, NO done marker -> preemption

        if stopping and not has_work:
            break

    counts = engine.compile_counts()
    _out({"type": "stats", "compile_counts": counts,
          "steps": sched.step_count, "completed": reported,
          "replica": index, "launches": _decode_launches()})
    if session is not None:
        session.close()
    from deepspeed_tpu_torch.runtime.supervisor.supervisor import done_path
    with open(done_path(workdir, index), "w") as f:
        f.write("done\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
