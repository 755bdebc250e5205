"""Serving fleet replicas: the executors behind the admission router
(port of ``deepspeed_tpu/inference/fleet.py``).

Two interchangeable backends behind one duck-typed handle contract
(``index``/``start``/``submit``/``poll``/``check``/``stop``/``kill``/
``reap``), so `inference/router.py:FleetRouter` never knows which it is
driving:

- :class:`ProcessReplica` — a real subprocess running
  `inference/fleet_worker.py` under the ``ds_tpu_run`` supervisor's env
  contract (``DS_TPU_RUN_PROCESS_INDEX`` / ``DS_TPU_RUN_RESTART_COUNT``
  / done markers), speaking JSONL over stdin/stdout and writing the
  ``hb-p<idx>.json`` heartbeat files. Death classification is the
  supervisor's own: ``classify_exit`` on the exit code + done marker,
  ``heartbeat_verdict`` on the heartbeat file. This is the backend the
  SIGKILL soak and the CI fleet smoke run — the process genuinely dies.
- :class:`ThreadReplica` — an in-process thread around any engine the
  ``engine_factory`` returns (including the stub engines the unit tests
  use), with the same lifecycle semantics simulated:
  ``kill()`` stops the loop mid-flight without reporting (a crash),
  ``preempt()`` finishes the current decode step and exits cleanly
  without its done flag (a preemption), an unhandled scheduler
  exception (e.g. the injected decode fault) is a crash, and a stalled
  loop past ``step_timeout_s`` reads as a hang. Fast enough for tier-1.

Both report completions as plain dicts (:func:`completion_dict`) so the
router's bookkeeping is backend-agnostic.

Thread replicas on one card: each replica's thread builds its engine
and runs its loop on a CUDA stream of its own (:func:`_replica_stream`),
so replicas' kernels order within their stream and overlap across
streams. The decode kernels' ticket buffers are kept per (device,
stream), and their cache dict, the kernel library's first build and
the wrappers' ``.launches`` counters are guarded by a lock
(``ops/flash_decode.py``). Process replicas each own a CUDA context.
"""

import contextlib

import collections
import json
import os
import subprocess
import sys
import threading
import time

from deepspeed_tpu_torch.runtime.supervisor.state import CAUSE_HANG
from deepspeed_tpu_torch.runtime.supervisor.supervisor import (
    classify_exit,
    done_path,
    heartbeat_verdict,
)
from deepspeed_tpu_torch.telemetry.watchdog import heartbeat_path

COMPLETION_FIELDS = (
    "rid", "prompt_len", "tokens", "finish_reason", "bucket", "slot",
    "steps", "prefix_hit", "resumed", "prefill_chunks",
    "prefill_chunks_skipped", "redispatched", "restarts")

REQUEST_FIELDS = (
    "rid", "prompt", "max_new_tokens", "eos_id", "arrival_step",
    "session_id", "deadline_s", "queue_timeout_s", "redispatched",
    "restarts")


def completion_dict(c):
    """A scheduler ``Completion`` as the wire/router dict."""
    return {k: getattr(c, k) for k in COMPLETION_FIELDS}


def request_dict(r):
    """A scheduler ``Request`` as the wire dict. ``submit_t`` stays
    home: monotonic clocks don't travel between processes — the router
    enforces the global deadline, the worker re-clocks its own."""
    return {k: getattr(r, k) for k in REQUEST_FIELDS}


@contextlib.contextmanager
def _replica_stream():
    """A CUDA stream of the replica's own as the thread's current stream
    (a no-op without a card); the stream's work is finished on exit."""
    import torch
    if not torch.cuda.is_available():
        yield
        return
    stream = torch.cuda.Stream()
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        stream.synchronize()


class ThreadReplica:
    """In-process replica: one scheduler loop on a daemon thread."""

    def __init__(self, index, engine_factory, step_timeout_s=None):
        self.index = int(index)
        self.engine_factory = engine_factory
        self.step_timeout_s = step_timeout_s
        self._inbox = collections.deque()
        self._outbox = collections.deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._kill = threading.Event()
        self._preempt = threading.Event()
        self._done_flag = False         # the done-marker analogue
        self._preempted = False
        self._error = None
        self._stats = None
        self._last_progress = time.monotonic()
        self._busy = False
        self._thread = None
        self._reported = 0

    # -- lifecycle -----------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-replica-{self.index}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self):
        with _replica_stream():
            self._serve()

    def _serve(self):
        try:
            from deepspeed_tpu_torch.inference.scheduler import (
                ContinuousBatchingScheduler)
            engine = self.engine_factory()
            sched = ContinuousBatchingScheduler(engine)
            while True:
                if self._kill.is_set():
                    return          # SIGKILL analogue: vanish mid-flight
                with self._lock:
                    while self._inbox:
                        sched.submit(self._inbox.popleft())
                has_work = bool(sched.queue) or any(
                    s is not None for s in sched.slots)
                if has_work:
                    self._busy = True
                    sched.step()    # fault probes live inside
                    self._last_progress = time.monotonic()
                    self._busy = False
                with self._lock:
                    new = sched.completions[self._reported:]
                    self._reported = len(sched.completions)
                    for c in new:
                        self._outbox.append(completion_dict(c))
                if self._preempt.is_set():
                    # SIGTERM analogue: current step finished above;
                    # report completed-so-far and exit WITHOUT the done
                    # flag, so the router classifies a preemption.
                    self._preempted = True
                    return
                if not has_work:
                    if self._stop.is_set():
                        counts = engine.compile_counts() if hasattr(
                            engine, "compile_counts") else {}
                        self._stats = {
                            "compile_counts": counts,
                            "steps": sched.step_count,
                            "completed": len(sched.completions),
                        }
                        self._done_flag = True
                        return
                    time.sleep(0.0005)
        except BaseException as e:      # noqa: BLE001 - crash envelope
            self._error = e

    # -- router-facing handle ------------------------------------------

    def submit(self, request):
        with self._lock:
            self._inbox.append(request)

    def poll(self):
        with self._lock:
            out = list(self._outbox)
            self._outbox.clear()
        return out

    def check(self, now=None):
        """Failure cause, or None while healthy — mirroring the
        supervisor's classifier over thread state: a dead thread's
        "exit code" is its error/done flag, a stalled busy loop past
        ``step_timeout_s`` is a hang."""
        now = time.monotonic() if now is None else now
        if self._thread is not None and not self._thread.is_alive():
            rc = 1 if (self._error is not None or
                       self._kill.is_set()) else 0
            return classify_exit(rc, self._done_flag)
        if self.step_timeout_s is not None and self._busy and \
                now - self._last_progress > self.step_timeout_s:
            return CAUSE_HANG
        return None

    def stop(self, timeout=30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        return self._stats

    def kill(self):
        self._kill.set()

    def preempt(self):
        self._preempt.set()

    def reap(self):
        """Post-death cleanup (pipes for processes; nothing here)."""


class TierThreadReplica(ThreadReplica):
    """In-process TIER replica for disaggregated serving: the factory
    returns a `inference/disagg.py` ``PrefillWorker``/``DecodeWorker``
    instead of an engine, and the loop drives its submit/step/
    drain_outputs surface. Lifecycle semantics are ThreadReplica's
    exactly — kill vanishes mid-flight, preempt finishes the step and
    exits without the done flag, an unhandled exception is a crash —
    so the DisaggRouter health-checks both backends identically."""

    def submit(self, request, meta=None):
        with self._lock:
            self._inbox.append((request, meta))

    def _serve(self):
        try:
            worker = self.engine_factory()
            while True:
                if self._kill.is_set():
                    return          # SIGKILL analogue: vanish mid-flight
                with self._lock:
                    while self._inbox:
                        req, meta = self._inbox.popleft()
                        worker.submit(req, meta)
                has_work = worker.has_work
                if has_work:
                    self._busy = True
                    worker.step()   # fault probes live inside
                    self._last_progress = time.monotonic()
                    self._busy = False
                with self._lock:
                    self._outbox.extend(worker.drain_outputs())
                if self._preempt.is_set():
                    self._preempted = True
                    return
                if not has_work:
                    if self._stop.is_set():
                        self._stats = worker.stats()
                        self._done_flag = True
                        return
                    time.sleep(0.0005)
        except BaseException as e:      # noqa: BLE001 - crash envelope
            self._error = e


class ProcessReplica:
    """Subprocess replica: `fleet_worker.py` over JSONL pipes.

    ``spec`` is the worker's build recipe (inference config, params
    seed, ``device``, optional per-replica telemetry jsonl) passed
    through the
    ``DS_TPU_SERVE_SPEC`` env var; ``inject`` (optional) becomes this
    replica's ``DS_TPU_SERVE_INJECT`` so a harness can arm faults in
    exactly one replica of the fleet.
    """

    def __init__(self, index, spec, workdir, num_replicas=1,
                 inject=None, env=None,
                 hang_timeout_s=None, heartbeat_stale_s=None,
                 restart_count=0):
        self.index = int(index)
        self.spec = dict(spec)
        self.workdir = os.path.abspath(workdir)
        self.num_replicas = int(num_replicas)
        self.inject = inject
        self.base_env = dict(env) if env is not None \
            else dict(os.environ)
        self.hang_timeout_s = hang_timeout_s
        self.heartbeat_stale_s = heartbeat_stale_s
        self.restart_count = int(restart_count)
        self.proc = None
        self._outbox = collections.deque()
        self._lock = threading.Lock()
        self._reader = None
        self._stats = None
        self.ready = threading.Event()

    # -- lifecycle -----------------------------------------------------

    def start(self):
        os.makedirs(self.workdir, exist_ok=True)
        env = dict(self.base_env)
        # The worker runs with cwd=workdir, so the repo root must be on
        # PYTHONPATH explicitly (the parent usually has it via its cwd).
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p)
        env.update({
            "DS_TPU_RUN_PROCESS_INDEX": str(self.index),
            "DS_TPU_RUN_NUM_WORKERS": str(self.num_replicas),
            "DS_TPU_RUN_RESTART_COUNT": str(self.restart_count),
            "DS_TPU_RUN_ATTEMPT": "1",
            "DS_TPU_RUN_WORKDIR": self.workdir,
            "DS_TPU_SERVE_SPEC": json.dumps(self.spec),
        })
        if self.inject is not None:
            env["DS_TPU_SERVE_INJECT"] = json.dumps(self.inject)
        log_dir = os.path.join(self.workdir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_f = open(os.path.join(log_dir,
                                  f"replica{self.index}.log"), "ab")
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m",
                 "deepspeed_tpu_torch.inference.fleet_worker"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=log_f, cwd=self.workdir, env=env, text=True,
                bufsize=1)
        finally:
            log_f.close()               # the child holds its own fd
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"fleet-reader-{self.index}", daemon=True)
        self._reader.start()
        return self

    def _read_loop(self):
        try:
            for line in self.proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue        # stray print from the worker
                kind = msg.get("type")
                if kind == "completion":
                    with self._lock:
                        self._outbox.append(msg["completion"])
                elif kind in ("prefilled", "handoff_corrupt",
                              "handoff_missing", "handoff_error"):
                    # disaggregated tier outputs: the payload
                    # travels as-is, tagged with its kind so the
                    # DisaggRouter can route it.
                    with self._lock:
                        self._outbox.append(
                            dict(msg["payload"], kind=kind))
                elif kind == "ready":
                    self.ready.set()
                elif kind in ("stats", "preempted"):
                    self._stats = msg
        except (OSError, ValueError):
            pass                    # pipe died with the worker

    def wait_ready(self, timeout=120.0):
        """Block until the worker reports its engine is built."""
        if not self.ready.wait(timeout):
            raise TimeoutError(
                f"replica {self.index} never reported ready "
                f"(see {self.workdir}/logs/replica{self.index}.log)")
        return self

    # -- router-facing handle ------------------------------------------

    def _send(self, msg):
        try:
            self.proc.stdin.write(json.dumps(msg) + "\n")
            self.proc.stdin.flush()
        except (OSError, ValueError):
            pass        # dead replica: the health check will notice

    def submit(self, request):
        self._send({"cmd": "submit", "request": request_dict(request)})

    def poll(self):
        with self._lock:
            out = list(self._outbox)
            self._outbox.clear()
        return out

    def check(self, now=None):
        rc = self.proc.poll()
        cause = classify_exit(
            rc, os.path.exists(done_path(self.workdir, self.index)))
        if cause is not None or rc is not None:
            return cause
        hb = self._read_heartbeat()
        return heartbeat_verdict(
            hb, time.time(), hang_timeout_s=self.hang_timeout_s,
            heartbeat_stale_s=self.heartbeat_stale_s)

    def _read_heartbeat(self):
        try:
            with open(heartbeat_path(self.workdir, self.index)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stop(self, timeout=60.0):
        self._send({"cmd": "stop"})
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        if self._reader is not None:
            self._reader.join(timeout=5.0)
        return self._stats

    def kill(self):
        """Hard SIGKILL — the soak path when the harness kills from
        outside rather than via an armed ``inject_kill``."""
        try:
            self.proc.kill()
        except OSError:
            pass

    def terminate(self):
        """SIGTERM: the worker's PreemptionHandler finishes the step,
        reports completed-so-far, and exits 0 without its done marker."""
        try:
            self.proc.terminate()
        except OSError:
            pass

    def reap(self):
        """Close pipes after death so fds don't leak across a long
        fleet run."""
        try:
            self.proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        for stream in (self.proc.stdin, self.proc.stdout):
            try:
                if stream is not None:
                    stream.close()
            except OSError:
                pass


class TierProcessReplica(ProcessReplica):
    """Subprocess TIER replica: the worker boots with ``spec["tier"]``
    set to ``"prefill"``/``"decode"`` and a shared ``handoff_dir``,
    builds the matching tier engine + worker, and speaks the same JSONL
    protocol plus the handoff kinds (``prefilled``/``handoff_corrupt``/
    ``handoff_missing``/``handoff_error``). A decode-tier submit
    carries the :class:`~deepspeed_tpu_torch.inference.disagg.HandoffMeta`
    dict alongside the request."""

    def submit(self, request, meta=None):
        msg = {"cmd": "submit", "request": request_dict(request)}
        if meta is not None:
            msg["handoff"] = dict(meta)
        self._send(msg)


def build_process_fleet(n, spec, workdir, inject=None, inject_replica=0,
                        env=None, hang_timeout_s=None,
                        heartbeat_stale_s=None):
    """Spawn and ready-wait ``n`` :class:`ProcessReplica` workers in
    ``workdir`` (shared heartbeat/done-marker dir, per-replica logs).
    ``inject`` arms the fault spec in ``inject_replica`` only."""
    replicas = []
    for i in range(n):
        replicas.append(ProcessReplica(
            i, spec, workdir, num_replicas=n,
            inject=inject if i == inject_replica else None,
            env=env, hang_timeout_s=hang_timeout_s,
            heartbeat_stale_s=heartbeat_stale_s).start())
    for r in replicas:
        r.wait_ready()
    return replicas
