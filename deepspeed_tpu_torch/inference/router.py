"""Admission router for the serving fleet: one global queue, N replicas
(a copy of ``deepspeed_tpu/inference/router.py``: pure host logic).

The router owns every request from submit to completion. Replicas
(`inference/fleet.py` — subprocess workers or in-process threads) are
pure executors: the router assigns each admitted request to the
least-loaded healthy replica, keeps its OWN authoritative copy of every
in-flight request, and health-checks replicas with the training
supervisor's classifier (`runtime/supervisor/supervisor.py:
classify_exit`/``heartbeat_verdict`` over the ``hb-p<idx>.json``
heartbeat files) plus a decode-step liveness deadline.

When a replica dies — crash, hang, or preemption — its in-flight
requests drain straight back to the router queue and redispatch to
healthy replicas as re-prefills after an exponential backoff. Greedy
decode is request-local deterministic (per-row KV, fixed program
shapes, replicas share seeded params), so a redispatched request's
tokens are identical to an uninterrupted run: callers observe
exactly-once COMPLETION on top of at-least-once EXECUTION, with the
retry count recorded on the completion (``redispatched``/``restarts``).

Bounds, so nothing grows or retries forever:

- ``max_redispatch`` — a request drained more times than this finishes
  with the ``aborted`` reason (and :class:`RequestAbortedError` when
  ``raise_on_abort``), emitted as a durable ``request_aborted`` event.
- ``max_queue_depth`` — per-replica in-flight bound; when every healthy
  replica is at it the router DEFERS dispatch (``fleet_defer``).
- ``max_pending`` — global admission bound; a submit past it is SHED
  with the ``shed`` reason (``fleet_shed``) instead of queueing
  unboundedly.
- ``deadline_s``/``queue_timeout_s`` (per request) — enforced on the
  router queue here and inside each replica's scheduler; either way the
  request finishes with the typed ``timeout`` reason.
"""

import collections
import dataclasses
import time
from typing import Dict, List, Optional


class RequestAbortedError(RuntimeError):
    """A request exhausted its redispatch budget: every attempt landed
    on a replica that died before completing it."""

    def __init__(self, rid, redispatched):
        self.rid = rid
        self.redispatched = redispatched
        super().__init__(
            f"request {rid!r} aborted after {redispatched} "
            f"redispatches (replica died every time)")


@dataclasses.dataclass
class _Queued:
    request: object                 # scheduler.Request
    not_before: float = 0.0         # redispatch backoff gate
    meta: object = None             # HandoffMeta dict (decode tier)


@dataclasses.dataclass
class FleetResult:
    completions: List[dict]         # finish order, one per request
    ok: bool
    replicas: int
    replicas_dead: int
    redispatched_total: int
    aborted: int
    shed: int
    defers: int
    timeouts: int
    stats: List[dict]               # surviving replicas' final stats
    latency_s: Dict[str, Optional[float]]   # p50/p95/p99/max

    def by_rid(self):
        return {c["rid"]: c for c in self.completions}


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class FleetRouter:
    """See the module docstring. ``replicas`` are started handles from
    `inference/fleet.py` (anything with submit/poll/check/stop/kill)."""

    def __init__(self, replicas, session=None,
                 max_redispatch=2,
                 max_queue_depth=8,
                 max_pending=None,
                 backoff_base_s=0.05,
                 backoff_cap_s=2.0,
                 poll_interval_s=0.002,
                 raise_on_abort=False):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas = list(replicas)
        self.session = session
        self.max_redispatch = int(max_redispatch)
        self.max_queue_depth = int(max_queue_depth)
        self.max_pending = (int(max_pending) if max_pending is not None
                            else None)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.poll_interval_s = float(poll_interval_s)
        self.raise_on_abort = bool(raise_on_abort)

        self.queue = collections.deque()        # _Queued
        self.assigned = {r.index: {} for r in self.replicas}
        self.dead = {}                          # index -> cause
        self.completions = []
        self.completed_rids = set()             # exactly-once gate
        self.redispatched_total = 0
        self.aborted = 0
        self.shed = 0
        self.defers = 0
        self.timeouts = 0
        self._deferring = False
        self._recovering = {}   # index -> (t_detect, {rids not yet out})
        self._submit_t = {}     # rid -> wall-clock submit (latency)

    # -- telemetry -----------------------------------------------------

    def _emit(self, event, **fields):
        if self.session is not None:
            try:
                self.session.emit(event, **fields)
            except Exception:       # telemetry never kills the fleet
                pass

    # -- submission ----------------------------------------------------

    def _outstanding(self):
        return len(self.queue) + sum(
            len(v) for v in self.assigned.values())

    def submit(self, request):
        """Admit one request, or shed it at the global pending bound."""
        if request.rid in self._submit_t:
            raise ValueError(f"duplicate rid {request.rid!r}")
        self._submit_t[request.rid] = time.monotonic()
        if request.submit_t is None:
            request.submit_t = self._submit_t[request.rid]
        if self.max_pending is not None and \
                self._outstanding() >= self.max_pending:
            self.shed += 1
            self._record(request, tokens=[], finish_reason="shed",
                         replica=None)
            self._emit("fleet_shed", rid=request.rid,
                       outstanding=self._outstanding(),
                       max_pending=self.max_pending)
            return False
        self.queue.append(_Queued(request))
        return True

    # -- completion plumbing -------------------------------------------

    def _record(self, request, tokens, finish_reason, replica,
                extra=None):
        """One exactly-once completion record for ``request``."""
        if request.rid in self.completed_rids:
            return
        self.completed_rids.add(request.rid)
        now = time.monotonic()
        comp = {
            "rid": request.rid, "prompt_len": len(request.prompt),
            "tokens": list(tokens), "finish_reason": finish_reason,
            "bucket": 0, "slot": -1, "steps": 0,
            "prefix_hit": False, "resumed": False,
            "prefill_chunks": 0, "prefill_chunks_skipped": 0,
            "redispatched": request.redispatched,
            "restarts": request.restarts,
            "replica": replica,
            "latency_s": now - self._submit_t[request.rid],
        }
        if extra:
            comp.update(extra)
        self.completions.append(comp)
        self._emit("request_complete", rid=comp["rid"], replica=replica,
                   finish_reason=finish_reason, tokens=len(comp["tokens"]),
                   latency_s=round(comp["latency_s"], 6),
                   redispatched=comp["redispatched"],
                   restarts=comp["restarts"],
                   # disaggregated runs tag completions with the tier
                   # and the ttft/queue-wait split for the metrics CLI
                   **{k: comp[k] for k in
                      ("tier", "ttft_s", "decode_queue_wait_s")
                      if k in comp})

    def _collect(self):
        """Drain every live replica's finished completions."""
        for rep in self.replicas:
            if rep.index in self.dead:
                continue
            for c in rep.poll():
                req = self.assigned[rep.index].pop(c["rid"], None)
                if req is None or c["rid"] in self.completed_rids:
                    continue    # duplicate / already completed elsewhere
                self._record(
                    req, tokens=c["tokens"],
                    finish_reason=c["finish_reason"], replica=rep.index,
                    extra={k: c[k] for k in
                           ("bucket", "slot", "steps", "prefix_hit",
                            "resumed", "prefill_chunks",
                            "prefill_chunks_skipped") if k in c})

    # -- health / drain / redispatch -----------------------------------

    def _healthy(self):
        return [r for r in self.replicas if r.index not in self.dead]

    def _check_health(self, now):
        for rep in self.replicas:
            if rep.index in self.dead:
                continue
            cause = rep.check(now)
            if cause is None:
                continue
            self.dead[rep.index] = cause
            in_flight = self.assigned[rep.index]
            self._emit("replica_dead", replica=rep.index, cause=cause,
                       in_flight=len(in_flight))
            rep.reap()
            self._drain(rep.index, now)

    def _drain(self, index, now):
        """Requeue a dead replica's in-flight requests (bounded retry
        with exponential backoff), aborting the over-budget ones."""
        drained = self.assigned[index]
        self.assigned[index] = {}
        recovering = set()
        for rid, req in drained.items():
            req.redispatched += 1
            req.restarts += 1
            if req.redispatched > self.max_redispatch or \
                    not self._healthy():
                self.aborted += 1
                self._record(req, tokens=[], finish_reason="aborted",
                             replica=index)
                self._emit("request_aborted", rid=rid,
                           redispatched=req.redispatched,
                           last_replica=index)
                if self.raise_on_abort:
                    raise RequestAbortedError(rid, req.redispatched)
                continue
            backoff = min(self.backoff_cap_s, self.backoff_base_s *
                          (2 ** (req.redispatched - 1)))
            req.arrival_step = 0    # re-prefill immediately on arrival
            self.queue.append(_Queued(req, not_before=now + backoff))
            recovering.add(rid)
            self.redispatched_total += 1
            self._emit("fleet_redispatch", rid=rid, from_replica=index,
                       redispatched=req.redispatched,
                       backoff_s=round(backoff, 4))
        if recovering:
            self._recovering[index] = (now, recovering)
        else:
            self._emit("replica_recovered", replica=index,
                       time_to_recover_s=0.0, redispatched=0)

    def _note_dispatched(self, rid, now):
        """Close a replica's recovery window once its last drained
        request is back on a healthy replica."""
        for index, (t_detect, rids) in list(self._recovering.items()):
            rids.discard(rid)
            if not rids:
                del self._recovering[index]
                self._emit("replica_recovered", replica=index,
                           time_to_recover_s=round(now - t_detect, 6),
                           redispatched=self.redispatched_total)

    # -- deadlines on the router queue ---------------------------------

    def _expire(self, now):
        if not self.queue:
            return
        keep = collections.deque()
        for item in self.queue:
            req = item.request
            waited = now - req.submit_t if req.submit_t is not None \
                else 0.0
            expired = ((req.queue_timeout_s is not None and
                        waited > req.queue_timeout_s) or
                       (req.deadline_s is not None and
                        waited > req.deadline_s))
            if expired:
                self.timeouts += 1
                self._record(req, tokens=[], finish_reason="timeout",
                             replica=None)
                self._emit("request_timeout", rid=req.rid,
                           where="router_queue",
                           waited_s=round(waited, 6))
            else:
                keep.append(item)
        self.queue = keep

    # -- dispatch ------------------------------------------------------

    def _dispatch(self, now):
        ready = [q for q in self.queue if q.not_before <= now]
        if not ready:
            return
        dispatched = []
        for item in ready:
            candidates = [r for r in self._healthy()
                          if len(self.assigned[r.index])
                          < self.max_queue_depth]
            if not candidates:
                if not self._deferring:
                    self.defers += 1
                    self._deferring = True
                    self._emit("fleet_defer", queued=len(self.queue),
                               max_queue_depth=self.max_queue_depth)
                break
            self._deferring = False
            rep = min(candidates,
                      key=lambda r: (len(self.assigned[r.index]),
                                     r.index))
            req = item.request
            self.assigned[rep.index][req.rid] = req
            rep.submit(req)
            dispatched.append(item)
            self._emit("fleet_dispatch", rid=req.rid, replica=rep.index,
                       redispatched=req.redispatched,
                       queue_depth=len(self.assigned[rep.index]))
            self._note_dispatched(req.rid, now)
        if dispatched:
            gone = set(id(d) for d in dispatched)
            self.queue = collections.deque(
                q for q in self.queue if id(q) not in gone)

    # -- the drive loop ------------------------------------------------

    def run(self, requests=(), timeout_s=120.0):
        """Drive every request (plus anything already submitted) to a
        completion, draining and redispatching around replica deaths.
        Returns a :class:`FleetResult`; ``ok`` means every submitted
        request completed with a generative reason (no aborts, sheds,
        timeouts, or fleet-level truncation)."""
        for r in requests:
            self.submit(r)
        t0 = time.monotonic()
        while self.queue or any(self.assigned[r.index]
                                for r in self._healthy()):
            now = time.monotonic()
            self._collect()
            self._check_health(now)
            self._expire(now)
            self._dispatch(now)
            if not self._healthy() and (
                    self.queue or any(self.assigned.values())):
                # every replica is dead: drain whatever is left into
                # aborted completions rather than spinning forever
                for rep in self.replicas:
                    if self.assigned[rep.index]:
                        self._drain(rep.index, now)
                while self.queue:
                    req = self.queue.popleft().request
                    self.aborted += 1
                    self._record(req, tokens=[],
                                 finish_reason="aborted", replica=None)
                    self._emit("request_aborted", rid=req.rid,
                               redispatched=req.redispatched,
                               last_replica=None)
                break
            if time.monotonic() - t0 > timeout_s:
                for rep in self._healthy():
                    for rid, req in list(
                            self.assigned[rep.index].items()):
                        self._record(req, tokens=[],
                                     finish_reason="incomplete",
                                     replica=rep.index)
                    self.assigned[rep.index] = {}
                while self.queue:
                    self._record(self.queue.popleft().request,
                                 tokens=[], finish_reason="incomplete",
                                 replica=None)
                self._emit("scheduler_incomplete", level="warning",
                           where="fleet", timeout_s=timeout_s)
                break
            time.sleep(self.poll_interval_s)
        self._collect()
        return self._finish()

    def _finish(self):
        stats = []
        for rep in self._healthy():
            st = rep.stop()
            if st is not None:
                st = dict(st, replica=rep.index)
                stats.append(st)
                self._emit("replica_stats", **st)
        lat = sorted(c["latency_s"] for c in self.completions
                     if c.get("latency_s") is not None)
        latency = {"p50": _percentile(lat, 0.50),
                   "p95": _percentile(lat, 0.95),
                   "p99": _percentile(lat, 0.99),
                   "max": lat[-1] if lat else None}
        generative = ("max_new_tokens", "eos", "length")
        ok = (len(self.completions) == len(self._submit_t) and
              all(c["finish_reason"] in generative
                  for c in self.completions))
        result = FleetResult(
            completions=list(self.completions), ok=ok,
            replicas=len(self.replicas), replicas_dead=len(self.dead),
            redispatched_total=self.redispatched_total,
            aborted=self.aborted, shed=self.shed, defers=self.defers,
            timeouts=self.timeouts, stats=stats, latency_s=latency)
        self._emit("fleet_done", ok=ok,
                   requests=len(self._submit_t),
                   completions=len(self.completions),
                   replicas=len(self.replicas),
                   replicas_dead=len(self.dead),
                   dead_causes=dict(self.dead),
                   redispatched_total=self.redispatched_total,
                   aborted=self.aborted, shed=self.shed,
                   defers=self.defers, timeouts=self.timeouts,
                   latency_p99_s=latency["p99"])
        return result


@dataclasses.dataclass
class DisaggResult:
    """Outcome of a disaggregated run: the fleet-level fields plus the
    handoff ledger and per-tier stats/latency splits."""
    completions: List[dict]
    ok: bool
    prefill_replicas: int
    decode_replicas: int
    replicas_dead: int
    dead_by_tier: Dict[str, int]
    redispatched_total: int
    aborted: int
    shed: int
    defers: int
    timeouts: int
    handoffs: int
    handoff_bytes: int
    handoff_corrupt: int
    resumed_from_park: int
    stats: List[dict]               # surviving replicas, tier-tagged
    latency_s: Dict[str, Optional[float]]
    ttft_s: Dict[str, Optional[float]]

    def by_rid(self):
        return {c["rid"]: c for c in self.completions}


class DisaggRouter(FleetRouter):
    """Tiered admission router for disaggregated serving .

    New requests dispatch to the PREFILL tier; a worker's ``prefilled``
    output moves the request (now pure admission metadata — the KV
    pages travel through the handoff store) onto the DECODE tier's
    queue, and only the decode tier produces its completion. Both
    tiers reuse the fleet machinery unchanged: least-loaded dispatch
    under ``max_queue_depth``, supervisor-classified health checks,
    exponential-backoff redispatch bounded by ``max_redispatch``,
    exactly-once completion records.

    Tier-aware recovery is the one new rule: a dead PREFILL worker's
    in-flight requests simply re-prefill elsewhere (nothing durable was
    lost), while a dead DECODE worker's requests re-prefill ONLY when
    their pages weren't parked — a durable handoff (``store.parked``)
    re-enters the decode queue and resumes from the parked snapshot. A
    CRC-rotted handoff (``handoff_corrupt``) always cold re-prefills:
    never serve from a rotten page.
    """

    def __init__(self, prefill_replicas, decode_replicas, store,
                 session=None, **kwargs):
        if not prefill_replicas or not decode_replicas:
            raise ValueError("disaggregation needs >= 1 replica per tier")
        super().__init__(list(prefill_replicas) + list(decode_replicas),
                         session=session, **kwargs)
        self.store = store
        self.tier_of = {}
        for r in prefill_replicas:
            self.tier_of[r.index] = "prefill"
        for r in decode_replicas:
            if r.index in self.tier_of:
                raise ValueError(
                    f"replica index {r.index} appears in both tiers")
            self.tier_of[r.index] = "decode"
        self.prefill_replicas = list(prefill_replicas)
        self.decode_replicas = list(decode_replicas)
        self.decode_queue = collections.deque()     # _Queued with meta
        self.handoffs = 0
        self.handoff_bytes = 0
        self.handoff_corrupt = 0
        self.resumed_from_park = 0
        self._metas = {}            # rid -> handoff meta dict (decode leg)
        self._extras = {}           # rid -> prefill-side completion fields
        self._prefilled_t = {}      # rid -> monotonic handoff time
        self._dispatch_t = {}       # rid -> monotonic prefill dispatch
        self.ttft = {}              # rid -> seconds to first token

    # -- tier plumbing -------------------------------------------------

    def _tier_healthy(self, tier):
        return [r for r in self.replicas
                if r.index not in self.dead and
                self.tier_of[r.index] == tier]

    def _outstanding(self):
        return (len(self.queue) + len(self.decode_queue) +
                sum(len(v) for v in self.assigned.values()))

    def _requeue_prefill(self, req, now, why):
        """Route a request back to the prefill tier (cold re-prefill),
        bounded exactly like a fleet redispatch."""
        req.restarts += 1
        if req.restarts > self.max_redispatch + 1 or \
                not self._tier_healthy("prefill"):
            self.aborted += 1
            self._record(req, tokens=[], finish_reason="aborted",
                         replica=None)
            self._emit("request_aborted", rid=req.rid,
                       redispatched=req.redispatched, why=why)
            if self.raise_on_abort:
                raise RequestAbortedError(req.rid, req.redispatched)
            return
        self._metas.pop(req.rid, None)
        self.queue.append(_Queued(req, not_before=now))
        self._emit("disagg_reprefill", rid=req.rid, why=why,
                   restarts=req.restarts)

    # -- collection ----------------------------------------------------

    def _collect(self):
        now = time.monotonic()
        for rep in self.replicas:
            if rep.index in self.dead:
                continue
            tier = self.tier_of[rep.index]
            for c in rep.poll():
                kind = c.get("kind", "completion")
                rid = c["rid"]
                req = self.assigned[rep.index].pop(rid, None)
                if req is None or rid in self.completed_rids:
                    if kind != "completion":
                        self.store.drop(rid)
                    continue
                if kind == "prefilled":
                    self.handoffs += 1
                    self.handoff_bytes += c.get("handoff_bytes", 0)
                    self._metas[rid] = c["handoff"]
                    self._extras[rid] = {
                        k: c[k] for k in
                        ("prefix_hit", "prefill_chunks",
                         "prefill_chunks_skipped", "handoff_bytes")
                        if k in c}
                    self._extras[rid]["prefill_replica"] = rep.index
                    self._prefilled_t[rid] = now
                    ttft = now - req.submit_t \
                        if req.submit_t is not None else None
                    self.ttft[rid] = ttft
                    qwait = None
                    if rid in self._dispatch_t and \
                            req.submit_t is not None:
                        qwait = self._dispatch_t[rid] - req.submit_t
                    self._emit(
                        "request_prefilled", rid=rid, replica=rep.index,
                        tier="prefill",
                        ttft_s=round(ttft, 6) if ttft is not None
                        else None,
                        queue_wait_s=round(qwait, 6)
                        if qwait is not None else None,
                        handoff_bytes=c.get("handoff_bytes", 0),
                        parked=bool(c["handoff"].get("parked")))
                    self.decode_queue.append(
                        _Queued(req, meta=c["handoff"]))
                elif kind in ("handoff_corrupt", "handoff_missing"):
                    self.handoff_corrupt += 1
                    self.store.drop(rid)
                    self._emit("handoff_corrupt", level="warning",
                               rid=rid, replica=rep.index, kind=kind)
                    self._requeue_prefill(req, now, why=kind)
                elif kind == "handoff_error":
                    self.aborted += 1
                    self.store.drop(rid)
                    self._record(req, tokens=[],
                                 finish_reason="handoff_error",
                                 replica=rep.index,
                                 extra={"error": c.get("error")})
                else:
                    extra = {k: c[k] for k in
                             ("bucket", "slot", "steps", "prefix_hit",
                              "resumed", "prefill_chunks",
                              "prefill_chunks_skipped") if k in c}
                    extra.update(self._extras.pop(rid, {}))
                    extra["tier"] = tier
                    if rid in self.ttft and self.ttft[rid] is not None:
                        extra["ttft_s"] = self.ttft[rid]
                    if rid in self._prefilled_t:
                        extra.setdefault("decode_queue_wait_s", None)
                    self._record(req, tokens=c["tokens"],
                                 finish_reason=c["finish_reason"],
                                 replica=rep.index, extra=extra)
                    self.store.drop(rid)

    # -- tier-aware drain ----------------------------------------------

    def _drain(self, index, now):
        tier = self.tier_of.get(index, "prefill")
        if tier == "prefill":
            super()._drain(index, now)
            return
        drained = self.assigned[index]
        self.assigned[index] = {}
        recovering = set()
        for rid, req in drained.items():
            req.redispatched += 1
            req.restarts += 1
            if req.redispatched > self.max_redispatch:
                self.aborted += 1
                self._record(req, tokens=[], finish_reason="aborted",
                             replica=index)
                self._emit("request_aborted", rid=rid,
                           redispatched=req.redispatched,
                           last_replica=index)
                if self.raise_on_abort:
                    raise RequestAbortedError(rid, req.redispatched)
                continue
            backoff = min(self.backoff_cap_s, self.backoff_base_s *
                          (2 ** (req.redispatched - 1)))
            self.redispatched_total += 1
            recovering.add(rid)
            if self.store.parked(rid) and rid in self._metas:
                # durable handoff: the parked snapshot survives the
                # worker, so the request resumes on another decode
                # worker without re-running prefill.
                self.resumed_from_park += 1
                self.decode_queue.append(_Queued(
                    req, not_before=now + backoff,
                    meta=self._metas[rid]))
                self._emit("fleet_redispatch", rid=rid,
                           from_replica=index, tier="decode",
                           resumed_from_park=True,
                           redispatched=req.redispatched,
                           backoff_s=round(backoff, 4))
            else:
                # in-process handoff was consumed with the worker (or
                # the snapshot is gone): only the prompt survives, so
                # the request re-prefills from scratch.
                self.store.drop(rid)
                self._metas.pop(rid, None)
                req.arrival_step = 0
                self.queue.append(_Queued(req, not_before=now + backoff))
                self._emit("fleet_redispatch", rid=rid,
                           from_replica=index, tier="decode",
                           resumed_from_park=False,
                           redispatched=req.redispatched,
                           backoff_s=round(backoff, 4))
        if recovering:
            self._recovering[index] = (now, recovering)
        else:
            self._emit("replica_recovered", replica=index,
                       time_to_recover_s=0.0, redispatched=0)

    # -- tiered dispatch -----------------------------------------------

    def _dispatch_tier(self, queue, tier, now):
        ready = [q for q in queue if q.not_before <= now]
        if not ready:
            return queue
        dispatched = []
        for item in ready:
            candidates = [r for r in self._tier_healthy(tier)
                          if len(self.assigned[r.index])
                          < self.max_queue_depth]
            if not candidates:
                if not self._deferring:
                    self.defers += 1
                    self._deferring = True
                    self._emit("fleet_defer", tier=tier,
                               queued=len(queue),
                               max_queue_depth=self.max_queue_depth)
                break
            self._deferring = False
            rep = min(candidates,
                      key=lambda r: (len(self.assigned[r.index]),
                                     r.index))
            req = item.request
            self.assigned[rep.index][req.rid] = req
            if tier == "decode":
                rep.submit(req, item.meta)
                if req.rid in self._prefilled_t:
                    # `now` predates _collect's stamp when the handoff
                    # and the dispatch land in the same loop tick
                    wait = max(0.0, now - self._prefilled_t[req.rid])
                    self._extras.setdefault(req.rid, {})[
                        "decode_queue_wait_s"] = wait
            else:
                self._dispatch_t[req.rid] = now
                rep.submit(req)
            dispatched.append(item)
            self._emit("fleet_dispatch", rid=req.rid, tier=tier,
                       replica=rep.index,
                       redispatched=req.redispatched,
                       queue_depth=len(self.assigned[rep.index]))
            self._note_dispatched(req.rid, now)
        if dispatched:
            gone = set(id(d) for d in dispatched)
            return collections.deque(
                q for q in queue if id(q) not in gone)
        return queue

    def _dispatch(self, now):
        self.queue = self._dispatch_tier(self.queue, "prefill", now)
        self.decode_queue = self._dispatch_tier(
            self.decode_queue, "decode", now)

    def _abort_queue(self, queue, why):
        n = 0
        while queue:
            req = queue.popleft().request
            if req.rid in self.completed_rids:
                continue
            self.aborted += 1
            self._record(req, tokens=[], finish_reason="aborted",
                         replica=None)
            self._emit("request_aborted", rid=req.rid,
                       redispatched=req.redispatched, why=why)
            n += 1
        return n

    # -- the drive loop ------------------------------------------------

    def run(self, requests=(), timeout_s=120.0):
        for r in requests:
            self.submit(r)
        t0 = time.monotonic()
        while self.queue or self.decode_queue or any(
                self.assigned[r.index] for r in self._healthy()):
            now = time.monotonic()
            self._collect()
            self._check_health(now)
            self._expire(now)
            self._dispatch(now)
            if not self._tier_healthy("prefill") and self.queue:
                self._abort_queue(self.queue, "prefill_tier_dead")
            if not self._tier_healthy("decode") and self.decode_queue:
                self._abort_queue(self.decode_queue, "decode_tier_dead")
            if not self._healthy():
                for rep in self.replicas:
                    if self.assigned[rep.index]:
                        self._drain(rep.index, now)
                self._abort_queue(self.queue, "fleet_dead")
                self._abort_queue(self.decode_queue, "fleet_dead")
                break
            if time.monotonic() - t0 > timeout_s:
                for rep in self._healthy():
                    for rid, req in list(
                            self.assigned[rep.index].items()):
                        self._record(req, tokens=[],
                                     finish_reason="incomplete",
                                     replica=rep.index)
                    self.assigned[rep.index] = {}
                for queue in (self.queue, self.decode_queue):
                    while queue:
                        self._record(queue.popleft().request,
                                     tokens=[],
                                     finish_reason="incomplete",
                                     replica=None)
                self._emit("scheduler_incomplete", level="warning",
                           where="disagg_fleet", timeout_s=timeout_s)
                break
            time.sleep(self.poll_interval_s)
        self._collect()
        return self._finish()

    def _finish(self):
        stats = []
        for rep in self._healthy():
            st = rep.stop()
            if st is not None:
                st = dict(st, replica=rep.index,
                          tier=self.tier_of[rep.index])
                stats.append(st)
                self._emit("replica_stats", **st)
        lat = sorted(c["latency_s"] for c in self.completions
                     if c.get("latency_s") is not None)
        latency = {"p50": _percentile(lat, 0.50),
                   "p95": _percentile(lat, 0.95),
                   "p99": _percentile(lat, 0.99),
                   "max": lat[-1] if lat else None}
        tt = sorted(v for v in self.ttft.values() if v is not None)
        ttft = {"p50": _percentile(tt, 0.50),
                "p95": _percentile(tt, 0.95),
                "p99": _percentile(tt, 0.99),
                "max": tt[-1] if tt else None}
        dead_by_tier = {"prefill": 0, "decode": 0}
        for idx in self.dead:
            dead_by_tier[self.tier_of[idx]] += 1
        generative = ("max_new_tokens", "eos", "length")
        ok = (len(self.completions) == len(self._submit_t) and
              all(c["finish_reason"] in generative
                  for c in self.completions))
        result = DisaggResult(
            completions=list(self.completions), ok=ok,
            prefill_replicas=len(self.prefill_replicas),
            decode_replicas=len(self.decode_replicas),
            replicas_dead=len(self.dead), dead_by_tier=dead_by_tier,
            redispatched_total=self.redispatched_total,
            aborted=self.aborted, shed=self.shed, defers=self.defers,
            timeouts=self.timeouts, handoffs=self.handoffs,
            handoff_bytes=self.handoff_bytes,
            handoff_corrupt=self.handoff_corrupt,
            resumed_from_park=self.resumed_from_park,
            stats=stats, latency_s=latency, ttft_s=ttft)
        self._emit("disagg_done", ok=ok,
                   requests=len(self._submit_t),
                   completions=len(self.completions),
                   prefill_replicas=len(self.prefill_replicas),
                   decode_replicas=len(self.decode_replicas),
                   replicas_dead=len(self.dead),
                   dead_by_tier=dead_by_tier,
                   dead_causes=dict(self.dead),
                   redispatched_total=self.redispatched_total,
                   handoffs=self.handoffs,
                   handoff_bytes=self.handoff_bytes,
                   handoff_corrupt=self.handoff_corrupt,
                   resumed_from_park=self.resumed_from_park,
                   aborted=self.aborted, shed=self.shed,
                   defers=self.defers, timeouts=self.timeouts,
                   latency_p99_s=latency["p99"],
                   ttft_p99_s=ttft["p99"])
        return result
