"""Continuous batching: the host-side admit/evict/pad loop (the ring
path of ``deepspeed_tpu/inference/scheduler.py``).

The decode step always runs the full ``[max_batch]`` row block; this
scheduler is everything around it — an open-loop request queue, slot
assignment (the ring: a finished request's row goes straight to the
next arrival), per-request sequence budgets from ``seq_buckets``, and
the pad arrays that keep inactive rows shape-stable.

Buckets: a request's budget is the smallest ``seq_bucket`` that fits
``prompt + max_new_tokens`` (clamped to the largest). The bucket caps
how far the row may fill — a metadata cap, not a program shape.

Every decode step emits one ``decode_step`` telemetry event (tokens
produced, live batch, occupancy, queue depth, host wall) through the
session, which ``ds_tpu_metrics summary`` reads in serve mode.
"""

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.resilience import fault_injection


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_step`` > 0 makes the stream
    open-loop: the scheduler won't admit the request before its decode
    step count reaches it. ``deadline_s`` bounds the request's total
    wall clock from first submit, ``queue_timeout_s`` its wait for a
    cache row — either expiry finishes it with the ``timeout`` reason.
    ``submit_t`` is the monotonic clock at submit."""
    rid: str
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival_step: int = 0
    deadline_s: Optional[float] = None
    queue_timeout_s: Optional[float] = None
    submit_t: Optional[float] = None


@dataclasses.dataclass
class Completion:
    rid: str
    prompt_len: int
    tokens: List[int]           # generated ids (includes eos when hit)
    finish_reason: str          # "max_new_tokens" | "eos" | "length" |
                                # "timeout" | "incomplete"
    bucket: int
    slot: int                   # -1: never held a row (queued timeout)
    steps: int                  # decode steps this request was live for


@dataclasses.dataclass
class _Slot:
    request: Request
    bucket: int
    next_pos: int               # position the pending token feeds at
    pending: int                # last sampled token (next decode input)
    generated: List[int]
    admitted_step: int


class ContinuousBatchingScheduler:
    def __init__(self, engine, session=None):
        self.engine = engine
        self.session = session if session is not None else engine.session
        self.queue = collections.deque()
        self.slots = [None] * engine.max_batch
        self.step_count = 0
        self.completions = []

    # -- request lifecycle --------------------------------------------------

    def submit(self, request):
        if not request.prompt:
            raise ValueError(f"request {request.rid}: empty prompt")
        if len(request.prompt) >= self.engine.max_seq:
            raise ValueError(
                f"request {request.rid}: prompt length "
                f"{len(request.prompt)} does not fit the largest seq "
                f"bucket {self.engine.max_seq}")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"request {request.rid}: max_new_tokens must be >= 1")
        if request.submit_t is None:
            request.submit_t = time.monotonic()
        self.queue.append(request)

    def _bucket_for(self, request):
        need = len(request.prompt) + request.max_new_tokens
        for b in self.engine.seq_buckets:
            if need <= b:
                return b
        return self.engine.max_seq      # clamp: generation truncates

    def _finish(self, i, reason):
        s = self.slots[i]
        self.completions.append(Completion(
            rid=s.request.rid, prompt_len=len(s.request.prompt),
            tokens=list(s.generated), finish_reason=reason, bucket=s.bucket,
            slot=i, steps=self.step_count - s.admitted_step))
        self.slots[i] = None            # row back on the ring

    def _finish_unstarted(self, request, reason):
        """Record a completion for a request that never held a row."""
        self.completions.append(Completion(
            rid=request.rid, prompt_len=len(request.prompt), tokens=[],
            finish_reason=reason, bucket=self._bucket_for(request),
            slot=-1, steps=0))

    def _check_finished(self, i):
        s = self.slots[i]
        if s.request.eos_id is not None and \
                s.pending == s.request.eos_id:
            self._finish(i, "eos")
        elif len(s.generated) >= s.request.max_new_tokens:
            self._finish(i, "max_new_tokens")
        elif s.next_pos >= s.bucket:
            self._finish(i, "length")   # bucket budget exhausted

    def _expire(self):
        """Typed ``timeout`` finishes: queued requests past their queue
        timeout (or total deadline) drop without taking a row; live rows
        past their deadline finish with what they generated so far."""
        now = time.monotonic()

        def _queued_expired(r):
            waited = now - r.submit_t if r.submit_t is not None else 0.0
            return ((r.queue_timeout_s is not None and
                     waited > r.queue_timeout_s) or
                    (r.deadline_s is not None and waited > r.deadline_s))

        expired = [r for r in self.queue if _queued_expired(r)]
        if expired:
            self.queue = collections.deque(
                r for r in self.queue if not _queued_expired(r))
        for r in expired:
            self._finish_unstarted(r, "timeout")
            if self.session is not None:
                self.session.emit("request_timeout", rid=r.rid,
                                  where="queue", step=self.step_count)
        for i, s in enumerate(self.slots):
            if s is None or s.request.deadline_s is None or \
                    s.request.submit_t is None:
                continue
            if now - s.request.submit_t > s.request.deadline_s:
                self._finish(i, "timeout")
                if self.session is not None:
                    self.session.emit("request_timeout",
                                      rid=s.request.rid, where="decode",
                                      step=self.step_count)

    def _admit(self):
        for i in range(len(self.slots)):
            if self.slots[i] is not None:
                continue
            if not self.queue or \
                    self.queue[0].arrival_step > self.step_count:
                break
            req = self.queue.popleft()
            last_logits = self.engine.prefill(i, req.prompt)
            first = self.engine.sample_first(last_logits)
            self.slots[i] = _Slot(
                request=req, bucket=self._bucket_for(req),
                next_pos=len(req.prompt), pending=first,
                generated=[first], admitted_step=self.step_count)
            self._check_finished(i)

    # -- the decode loop ----------------------------------------------------

    def step(self):
        """Admit what the queue allows, then run one decode step over
        the live rows. Returns True while there is (or will be) work
        left."""
        self._expire()
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self.step_count += 1        # idle tick (open-loop gap)
            return bool(self.queue)
        mb = self.engine.max_batch
        tokens = np.zeros(mb, np.int32)
        positions = np.zeros(mb, np.int32)
        for i in active:
            tokens[i] = self.slots[i].pending
            positions[i] = self.slots[i].next_pos
        fault_injection.maybe_kill("decode_step", self.step_count)
        fault_injection.maybe_fail_decode(self.step_count)
        t0 = time.perf_counter()
        next_tokens, _ = self.engine.decode(tokens, positions)
        wall = time.perf_counter() - t0
        self.step_count += 1
        for i in active:
            s = self.slots[i]
            s.next_pos += 1
            s.pending = int(next_tokens[i])
            s.generated.append(s.pending)
            self._check_finished(i)
        self._emit(len(active), wall)
        return bool(self.queue) or any(s is not None for s in self.slots)

    def run(self, requests=None, max_steps=100000):
        """Drain ``requests`` (plus anything already queued) through the
        decode loop; returns the completions in finish order (cumulative
        across calls). Exhausting ``max_steps`` finishes every live row
        and queued request with the ``incomplete`` reason and emits one
        ``scheduler_incomplete`` warning event."""
        for r in requests or ():
            self.submit(r)
        steps = 0
        while steps < max_steps:
            if not self.step():
                break
            steps += 1
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if live or self.queue:
            for i in live:
                self._finish(i, "incomplete")
            queued = len(self.queue)
            while self.queue:
                self._finish_unstarted(self.queue.popleft(), "incomplete")
            if self.session is not None:
                self.session.emit(
                    "scheduler_incomplete", level="warning",
                    step=self.step_count, max_steps=max_steps,
                    live_rows=len(live), queued=queued)
        return list(self.completions)

    # -- telemetry ----------------------------------------------------------

    def _emit(self, batch, wall_s):
        if self.session is None:
            return
        occ = batch / float(self.engine.max_batch)
        self.session.emit(
            "decode_step", step=self.step_count, tokens=batch,
            batch=batch, occupancy=occ, queue_depth=len(self.queue),
            wall_s=wall_s)
        reg = self.session.registry
        reg.histogram("decode_step_seconds",
                      help="host wall per decode step").observe(wall_s)
        reg.counter("decode_tokens_total",
                    help="tokens generated by decode steps").inc(batch)
        reg.gauge("decode_batch_occupancy",
                  help="live rows / max_batch").set(occ)
        reg.gauge("decode_queue_depth",
                  help="requests waiting for a cache row").set(
                      len(self.queue))
