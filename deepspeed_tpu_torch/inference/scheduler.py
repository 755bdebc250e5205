"""Continuous batching: the host-side admit/evict/pad loop (port of
``deepspeed_tpu/inference/scheduler.py``, without the fleet and
disaggregated hooks).

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

With a paged engine (``kv_layout = "paged"``) the scheduler delegates
page mapping to `inference/paging.py:PagedCacheManager`: admission
walks the radix prefix cache (shared pages mapped, prefill resumed
mid-prompt), each decode step grows rows' mappings page by page, and a
finished request carrying a ``session_id`` parks its pages (device
first, host RAM under pressure) instead of freeing them. The decode
step just receives the ``[max_batch, pages_per_row]`` tables the
manager maintains, at that fixed width every step. With a speculative
engine a step is a whole draft/verify round (:meth:`_spec_step`).
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
    step count reaches it. ``session_id`` (paged engines) parks the
    request's KV pages at completion so a follow-up request on the same
    session resumes without re-prefilling its history. ``deadline_s``
    bounds the request's total wall clock from first submit,
    ``queue_timeout_s`` its wait for a cache row — either expiry
    finishes it with the ``timeout`` reason. ``redispatched`` /
    ``restarts`` are stamped by the fleet router when a replica death
    forces a re-prefill elsewhere; ``submit_t`` is the monotonic clock at
    first submit and survives redispatch, so the deadline spans
    retries."""
    rid: str
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    arrival_step: int = 0
    session_id: Optional[str] = None
    deadline_s: Optional[float] = None
    queue_timeout_s: Optional[float] = None
    redispatched: int = 0       # replica-death redispatches (router)
    restarts: int = 0           # total re-executions (router)
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
    prefix_hit: bool = False    # admitted on shared radix pages
    resumed: bool = False       # admitted by resuming a parked session
    prefill_chunks: int = 0     # prefill chunks actually run
    prefill_chunks_skipped: int = 0
    redispatched: int = 0       # times redispatched across replicas
    restarts: int = 0           # times its execution restarted


@dataclasses.dataclass
class _Slot:
    request: Request
    bucket: int
    next_pos: int               # position the pending token feeds at
    pending: int                # last sampled token (next decode input)
    generated: List[int]
    admitted_step: int
    paging: object = None       # RowPaging when the engine is paged


class ContinuousBatchingScheduler:
    def __init__(self, engine, session=None):
        self.engine = engine
        self.session = session if session is not None else engine.session
        self.queue = collections.deque()
        self.slots = [None] * engine.max_batch
        self.step_count = 0
        self.completions = []
        self.paging = None
        if getattr(engine, "kv_layout", "ring") == "paged":
            from deepspeed_tpu_torch.inference.paging import (
                PagedCacheManager)
            self.paging = PagedCacheManager(engine, session=self.session)

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

    def admit_prefilled(self, request, row, first_token):
        """Seed a slot from another tier's finished prefill
        (disaggregated serving, JAX ``scheduler.py:133``): the prompt's
        KV already sits in this engine's pool on ``row``'s pages
        (installed by the KV handoff) and ``first_token`` was sampled
        from the prefill tier's logits, so admission here runs no
        prefill. Returns False when no slot is free (the caller keeps
        the handoff queued)."""
        for i in range(len(self.slots)):
            if self.slots[i] is not None:
                continue
            if request.submit_t is None:
                request.submit_t = time.monotonic()
            self.slots[i] = _Slot(
                request=request, bucket=self._bucket_for(request),
                next_pos=len(request.prompt), pending=first_token,
                generated=[first_token],
                admitted_step=self.step_count, paging=row)
            # eos / single-token budgets can finish right here, where
            # the colocated loop's post-admission check fires
            self._check_finished(i)
            return True
        return False

    def occupancy(self):
        live = sum(1 for s in self.slots if s is not None)
        return live / float(self.engine.max_batch)

    def _bucket_for(self, request):
        need = len(request.prompt) + request.max_new_tokens
        for b in self.engine.seq_buckets:
            if need <= b:
                return b
        return self.engine.max_seq      # clamp: generation truncates

    def _finish(self, i, reason):
        s = self.slots[i]
        comp = Completion(
            rid=s.request.rid, prompt_len=len(s.request.prompt),
            tokens=list(s.generated), finish_reason=reason, bucket=s.bucket,
            slot=i, steps=self.step_count - s.admitted_step,
            redispatched=s.request.redispatched,
            restarts=s.request.restarts)
        if s.paging is not None:
            comp.prefix_hit = s.paging.prefix_hit
            comp.resumed = s.paging.resumed
            comp.prefill_chunks = s.paging.prefill_chunks
            comp.prefill_chunks_skipped = s.paging.prefill_chunks_skipped
            # KV on the pages covers the prompt plus every generated
            # token that fed a later decode step (the LAST sampled
            # token was never written)
            kv_tokens = list(s.request.prompt) + s.generated[:-1]
            self.paging.release(s.paging, kv_tokens=kv_tokens,
                                session_id=s.request.session_id)
        self.completions.append(comp)
        self.slots[i] = None            # row back on the ring

    def _finish_unstarted(self, request, reason):
        """Record a completion for a request that never held a row."""
        self.completions.append(Completion(
            rid=request.rid, prompt_len=len(request.prompt), tokens=[],
            finish_reason=reason, bucket=self._bucket_for(request),
            slot=-1, steps=0, redispatched=request.redispatched,
            restarts=request.restarts))

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
            req = self.queue[0]
            row = None
            if self.paging is not None:
                row = self.paging.admit(req.prompt,
                                        session_id=req.session_id)
                if row is None:
                    # the pool can't back the prompt even after the
                    # eviction ladder: leave the request queued and let
                    # running rows finish and free pages
                    break
                self.queue.popleft()
                last_logits = self.engine.prefill(
                    i, req.prompt,
                    page_table=row.table(self.paging.pages_per_row),
                    start=row.start)
                self.paging.after_prefill(row, req.prompt)
            else:
                self.queue.popleft()
                last_logits = self.engine.prefill(i, req.prompt)
            first = self.engine.sample_first(last_logits)
            self.slots[i] = _Slot(
                request=req, bucket=self._bucket_for(req),
                next_pos=len(req.prompt), pending=first,
                generated=[first], admitted_step=self.step_count,
                paging=row)
            self._check_finished(i)

    # -- the decode loop ----------------------------------------------------

    def _batch(self, active):
        """The step's ``[max_batch]`` token and position pads, and the
        ``[max_batch, pages_per_row]`` page tables (None for a ring
        engine; inactive rows all trash)."""
        mb = self.engine.max_batch
        tokens = np.zeros(mb, np.int32)
        positions = np.zeros(mb, np.int32)
        for i in active:
            tokens[i] = self.slots[i].pending
            positions[i] = self.slots[i].next_pos
        page_tables = None
        if self.paging is not None:
            page_tables = np.zeros((mb, self.paging.pages_per_row), np.int32)
            for i in active:
                page_tables[i] = self.slots[i].paging.table(
                    self.paging.pages_per_row)
        return tokens, positions, page_tables

    def step(self):
        """Admit what the queue allows, then run one decode step over
        the live rows. Returns True while there is (or will be) work
        left. With a speculative engine the step is a whole draft/verify
        round and rows advance by their accepted length
        (:meth:`_spec_step`)."""
        self._expire()
        self._admit()
        spec = getattr(self.engine, "speculative", None)
        if spec is not None:
            return self._spec_step(spec)
        if self.paging is not None:
            # grow each live row's mapping to cover this step's write
            # BEFORE building the tables; a row the pool can't grow even
            # after the eviction ladder is length-finished
            for i, s in enumerate(self.slots):
                if s is not None and \
                        not self.paging.ensure_position(s.paging,
                                                        s.next_pos):
                    self._finish(i, "length")
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self.step_count += 1        # idle tick (open-loop gap)
            return bool(self.queue)
        tokens, positions, page_tables = self._batch(active)
        fault_injection.maybe_kill("decode_step", self.step_count)
        fault_injection.maybe_fail_decode(self.step_count)
        t0 = time.perf_counter()
        if page_tables is None:
            next_tokens, _ = self.engine.decode(tokens, positions)
        else:
            next_tokens, _ = self.engine.decode(tokens, positions,
                                                page_tables=page_tables)
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

    def _spec_step(self, spec):
        """One speculative round: j chained draft calls + one
        verify-accept call, then a per-row consume walk over the
        variable-length accepted blocks.

        A row needs ``k + 1`` slots of headroom before the round (the
        verify chunk writes positions ``next_pos..next_pos+k``; past
        ``max_seq`` the ring write would clamp the chunk onto valid
        history and a paged table lookup would clamp to the last page):
        rows inside that margin length-finish now, at most k tokens
        early. Paged rows also grow their mapping to cover every
        potentially-ACCEPTED write (``next_pos + j``); pad writes past
        the mapping land on the trash page."""
        k = spec.k
        j = spec.draft_len()
        for i, s in enumerate(self.slots):
            if s is not None and s.next_pos + k + 1 > self.engine.max_seq:
                self._finish(i, "length")
        if self.paging is not None:
            for i, s in enumerate(self.slots):
                if s is not None and not self.paging.ensure_span(
                        s.paging, s.next_pos, s.next_pos + j):
                    self._finish(i, "length")
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            self.step_count += 1        # idle tick (open-loop gap)
            return bool(self.queue)
        mb = self.engine.max_batch
        tokens, positions, page_tables = self._batch(active)
        fault_injection.maybe_kill("decode_step", self.step_count)
        fault_injection.maybe_fail_decode(self.step_count)
        # draft: j chained truncated-forward calls of ONE program
        chunk = np.zeros((mb, k + 1), np.int32)
        chunk[:, 0] = tokens
        q_dists = None
        cur, cur_pos = tokens, positions.copy()
        t0 = time.perf_counter()
        for t in range(j):
            cur, q = spec.draft(cur, cur_pos, page_tables=page_tables)
            chunk[:, t + 1] = cur
            if q is not None:
                if q_dists is None:
                    q_dists = np.zeros((mb, k, q.shape[-1]), np.float32)
                q_dists[:, t] = q
            cur_pos = cur_pos + 1
        draft_wall = time.perf_counter() - t0
        # verify: one full-depth teacher-forced call over [B, k+1]
        pos_chunk = positions[:, None] + \
            np.arange(k + 1, dtype=np.int32)[None, :]
        draft_len = np.zeros(mb, np.int32)
        draft_len[active] = j
        t1 = time.perf_counter()
        acc, out = spec.verify(chunk, pos_chunk, draft_len, q_dists=q_dists,
                               page_tables=page_tables)
        verify_wall = time.perf_counter() - t1
        self.step_count += 1
        # consume: walk each row's accepted block token by token so eos /
        # token budget / bucket edges bind MID-CHUNK exactly where the
        # plain loop would have stopped
        emitted = accepted = 0
        for i in active:
            s = self.slots[i]
            accepted += int(acc[i])
            for t in range(int(acc[i]) + 1):
                s.next_pos += 1
                s.pending = int(out[i, t])
                s.generated.append(s.pending)
                emitted += 1
                self._check_finished(i)
                if self.slots[i] is None:
                    break
        spec.observe(len(active), len(active) * j, accepted, emitted)
        self._emit(len(active), draft_wall + verify_wall, tokens=emitted,
                   spec_stats={"accepted_tokens": emitted,
                               "accepted_drafts": accepted,
                               "draft_tokens": len(active) * j,
                               "draft_len": j,
                               "draft_wall_s": draft_wall,
                               "verify_wall_s": verify_wall})
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

    def _emit(self, batch, wall_s, tokens=None, spec_stats=None):
        if self.session is None:
            return
        occ = batch / float(self.engine.max_batch)
        tokens = batch if tokens is None else tokens
        extra = dict(spec_stats or {})
        if self.paging is not None:
            pg = self.paging
            extra.update(pages_free=pg.allocator.free_pages,
                         pages_resident=pg.allocator.resident_pages,
                         prefix_hits=pg.prefix_hits,
                         prefix_misses=pg.prefix_misses,
                         sessions_admitted=pg.sessions_admitted,
                         sessions_parked_host=len(pg.host_store),
                         cache_bytes=pg.page_bytes() * pg.engine.n_pages)
        self.session.emit(
            "decode_step", step=self.step_count, tokens=tokens,
            batch=batch, occupancy=occ, queue_depth=len(self.queue),
            wall_s=wall_s, **extra)
        reg = self.session.registry
        reg.histogram("decode_step_seconds",
                      help="host wall per decode step").observe(wall_s)
        reg.counter("decode_tokens_total",
                    help="tokens generated by decode steps").inc(tokens)
        if spec_stats is not None:
            reg.histogram(
                "accepted_tokens",
                help="tokens emitted per row per speculative round "
                     "(accepted drafts + correction)").observe(
                         spec_stats["accepted_tokens"] / float(batch))
            drafted = spec_stats["draft_tokens"]
            reg.gauge(
                "draft_efficiency",
                help="fraction of drafted tokens verify accepted").set(
                    spec_stats["accepted_drafts"] / float(drafted)
                    if drafted else 0.0)
        reg.gauge("decode_batch_occupancy",
                  help="live rows / max_batch").set(occ)
        reg.gauge("decode_queue_depth",
                  help="requests waiting for a cache row").set(
                      len(self.queue))
        if self.paging is not None:
            pg = self.paging
            reg.gauge("kv_pages_free",
                      help="unallocated pool pages").set(
                          pg.allocator.free_pages)
            reg.gauge("kv_pages_resident",
                      help="allocated pool pages (live + parked + "
                           "interned)").set(pg.allocator.resident_pages)
            hits = reg.counter("prefix_hits",
                               help="admissions that mapped shared "
                                    "radix pages")
            hits.inc(pg.prefix_hits - hits.value)
            misses = reg.counter("prefix_misses",
                                 help="admissions with no interned "
                                      "prefix")
            misses.inc(pg.prefix_misses - misses.value)
