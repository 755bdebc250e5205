"""Disaggregated prefill/decode serving: tier workers and the KV
handoff between them (port of ``deepspeed_tpu/inference/disagg.py``).

The colocated scheduler interleaves chunked prefill with decode inside
one loop, so a long prompt's chunk train steals decode steps from every
live row on the replica. Disaggregation splits the two programs onto
separate *tiers*: prefill workers only ever run the
prefill program (writing paged KV and sampling the first token), decode
workers only ever run the decode step, and a finished prompt moves
between them through an explicit KV **handoff**. Each tier therefore
pins exactly ONE program from warmup to drain — the fleet
holds 2 programs total instead of 2 per replica — and the tiers scale
independently (N prefill workers against M decode workers, each with
its own ``max_batch``). In the port a "program" is one of the engine's
two input signatures (``InferenceEngine.compile_counts``).

The handoff is admission METADATA, never a program shape: what travels
is the page contents plus a tiny :class:`HandoffMeta` record (first
token, KV frontier, page geometry), and the decode tier installs the
pages through the same ``scatter_pages`` seam session page-in uses.
Two transports implement one store contract
(``park``/``install``/``parked``/``peek``/``drop``):

- :class:`DeviceHandoffStore` — in-process: ``gather_pages_device``
  snapshots the pages into fresh device tensors (``index_select``
  copies, never views of the pool the next prefill writes in place)
  and ``install`` is a device-to-device scatter.
  Consume-once: a decode worker that dies after installing re-prefills,
  because nothing durable was parked.
- :class:`FileHandoffStore` — cross-process: pages ride the host page
  tier's discipline (CRC-stamped with ``runtime/resilience/checksums.py``,
  verified at install, :class:`HostPageCorruptError` on rot → cold
  re-prefill)
  through an npz file in a shared directory. The file is RETAINED until
  the request completes, so a dead decode worker resumes from the
  parked snapshot instead of re-prefilling.

:class:`PrefillWorker` / :class:`DecodeWorker` are the per-tier loops
(driven by tier replicas in `fleet.py` or a worker process in
`fleet_worker.py`); :class:`DisaggCoordinator` drives both tiers
synchronously in one process — deterministic, thread-free — for parity
tests, ``audit_disagg`` and the bench A/B row.
"""

import collections
import json
import os
import threading
import time

import numpy as np
import torch

from deepspeed_tpu_torch.inference.paging import (
    HostPageCorruptError,
    PagedCacheManager,
    RowPaging,
    _flip_first_byte,
)
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler,
)
from deepspeed_tpu_torch.runtime.resilience import fault_injection
from deepspeed_tpu_torch.runtime.resilience.checksums import (
    iter_leaves,
    leaf_checksums,
)

META_FIELDS = ("rid", "prompt_len", "first_token", "next_pos",
               "page_size", "pages_per_row", "n_pages", "parked")


class HandoffMeta:
    """The admission metadata half of a KV handoff: everything the
    decode tier needs to seed a slot WITHOUT running prefill. Geometry
    fields (``page_size``/``pages_per_row``) are carried so the decode
    tier can refuse a cross-geometry handoff before touching its pool —
    the static half of that pin lives in ``rule_decode``."""

    def __init__(self, rid, prompt_len, first_token, next_pos,
                 page_size, pages_per_row, n_pages, parked):
        self.rid = str(rid)
        self.prompt_len = int(prompt_len)
        self.first_token = int(first_token)
        self.next_pos = int(next_pos)
        self.page_size = int(page_size)
        self.pages_per_row = int(pages_per_row)
        self.n_pages = int(n_pages)
        self.parked = bool(parked)

    def to_dict(self):
        return {k: getattr(self, k) for k in META_FIELDS}

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: d[k] for k in META_FIELDS})


class DeviceHandoffStore:
    """In-process handoff transport: page snapshots held as immutable
    device arrays, consume-once (``install`` pops). ``parked`` is
    always False — nothing here survives a worker death, so the router
    re-prefills instead of resuming.

    Tier threads each run on a CUDA stream of their own
    (``fleet._replica_stream``), so the snapshot's copy is queued on the
    prefill tier's stream and its install on the decode tier's. ``park``
    records an event after the copy and ``install`` makes its stream wait
    for it; ``install`` also marks each snapshot tensor as used on its
    stream, so the caching allocator does not hand the snapshot's memory
    back to the prefill stream until the install has read it."""

    durable = False

    def __init__(self):
        self._held = {}     # rid -> (device tensors, meta, nbytes, event)
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._held)

    def park(self, rid, engine, page_ids, meta):
        vals = engine.gather_pages_device(page_ids)
        leaves = [leaf for _, leaf in iter_leaves(vals)]
        nbytes = sum(int(leaf.nbytes) for leaf in leaves)
        ready = None
        if leaves and torch.is_tensor(leaves[0]) and leaves[0].is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(leaves[0].device))
        with self._lock:
            self._held[rid] = (vals, meta, nbytes, ready)
        return nbytes

    def install(self, rid, engine, page_ids):
        with self._lock:
            vals, meta, _, ready = self._held.pop(rid)  # KeyError if gone
        if ready is not None:
            leaves = [leaf for _, leaf in iter_leaves(vals)]
            stream = torch.cuda.current_stream(leaves[0].device)
            stream.wait_event(ready)
            for leaf in leaves:
                leaf.record_stream(stream)
        engine.scatter_pages(page_ids, vals)
        return meta

    def parked(self, rid):
        return False

    def peek(self, rid):
        with self._lock:
            held = self._held.get(rid)
        return held[1] if held is not None else None

    def drop(self, rid):
        with self._lock:
            self._held.pop(rid, None)


class FileHandoffStore:
    """Cross-process handoff transport: CRC-stamped npz snapshots in a
    shared directory, written atomically and retained until ``drop`` —
    a handed-off session IS parked, so a dead decode worker resumes
    from the file instead of re-prefilling. Verification failure at
    install removes the snapshot (rotted bytes help nobody) and raises
    :class:`HostPageCorruptError`, which the decode worker surfaces as
    a ``handoff_corrupt`` message → the router cold re-prefills."""

    durable = True

    def __init__(self, dirpath):
        self.dir = os.path.abspath(dirpath)
        os.makedirs(self.dir, exist_ok=True)

    def _stem(self, rid):
        import zlib
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in str(rid))
        return os.path.join(
            self.dir, f"{safe}-{zlib.crc32(str(rid).encode()):08x}")

    def park(self, rid, engine, page_ids, meta):
        host = engine.gather_pages(page_ids)
        checksums = leaf_checksums(host)
        if fault_injection.corrupt_host_pages(rid):
            # harness-injected rot: flip one byte of the first leaf
            # after the CRCs were stamped, so install() must detect it
            host = _flip_first_byte(host)
        paths = [path for path, _ in iter_leaves(host)]
        leaves = [np.asarray(leaf) for _, leaf in iter_leaves(host)]
        nbytes = sum(int(leaf.nbytes) for leaf in leaves)
        stem = self._stem(rid)
        with open(stem + ".npz.tmp", "wb") as f:
            np.savez(f, **{f"leaf_{i}": leaf
                           for i, leaf in enumerate(leaves)})
        os.replace(stem + ".npz.tmp", stem + ".npz")
        with open(stem + ".json.tmp", "w") as f:
            json.dump({"meta": meta.to_dict(), "checksums": checksums,
                       "paths": paths, "nbytes": nbytes}, f)
        os.replace(stem + ".json.tmp", stem + ".json")
        return nbytes

    def install(self, rid, engine, page_ids):
        stem = self._stem(rid)
        try:
            with open(stem + ".json") as f:
                manifest = json.load(f)
        except OSError:
            raise KeyError(rid)
        tree = {}
        with np.load(stem + ".npz") as z:
            for i, path in enumerate(manifest["paths"]):
                node, keys = tree, path.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = z[f"leaf_{i}"]
        actual = leaf_checksums(tree)
        if actual != manifest["checksums"]:
            bad = sorted(k for k in manifest["checksums"]
                         if actual.get(k) != manifest["checksums"][k])
            self.drop(rid)
            raise HostPageCorruptError(rid, bad)
        engine.scatter_pages(page_ids, tree)
        return HandoffMeta.from_dict(manifest["meta"])

    def parked(self, rid):
        return os.path.exists(self._stem(rid) + ".json")

    def peek(self, rid):
        try:
            with open(self._stem(rid) + ".json") as f:
                return HandoffMeta.from_dict(json.load(f)["meta"])
        except OSError:
            return None

    def drop(self, rid):
        stem = self._stem(rid)
        for ext in (".npz", ".json"):
            try:
                os.remove(stem + ext)
            except OSError:
                pass


def _bucket_for(engine, request):
    """Smallest seq bucket fitting prompt + budget (the scheduler's
    rule, shared so the prefill tier's early finishes bucket the same
    way the decode tier would have)."""
    need = len(request.prompt) + request.max_new_tokens
    for b in engine.seq_buckets:
        if need <= b:
            return b
    return engine.max_seq


class PrefillWorker:
    """The prefill tier's loop: admit → chunked prefill → sample first
    token → hand the pages off. Never calls the decode program, so the
    engine's decode signature count stays zero for the worker's whole
    life (``engine.tier == "prefill"`` turns that into a hard raise).

    A request whose FIRST token already finishes it (eos, a 1-token
    budget, a bucket-clamped prompt) completes here and never travels —
    the same outcome the colocated loop's post-admission check
    produces. Everything else becomes a ``prefilled`` output carrying
    the :class:`HandoffMeta` for the router to dispatch decode-side.
    """

    tier = "prefill"

    def __init__(self, engine, store, session=None):
        if getattr(engine, "kv_layout", "ring") != "paged":
            raise ValueError(
                "disaggregated tiers require kv_layout='paged' — the "
                "KV handoff is a page copy")
        if getattr(engine, "tier", None) not in (None, "prefill"):
            raise ValueError(
                f"PrefillWorker needs a prefill-tier engine, got "
                f"tier={engine.tier!r}")
        self.engine = engine
        self.store = store
        self.session = session if session is not None \
            else engine.session
        self.paging = PagedCacheManager(engine, session=self.session)
        self.queue = collections.deque()
        self.outbox = []
        self.steps = 0
        self.prefills = 0
        self.handoffs = 0
        self.handoff_bytes = 0
        self.completed = 0

    @property
    def has_work(self):
        return bool(self.queue)

    def submit(self, request, meta=None):
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

    def drain_outputs(self):
        out, self.outbox = self.outbox, []
        return out

    def _complete(self, req, tokens, reason, row=None):
        comp = {
            "kind": "completion", "rid": req.rid,
            "prompt_len": len(req.prompt), "tokens": list(tokens),
            "finish_reason": reason,
            "bucket": _bucket_for(self.engine, req), "slot": 0,
            "steps": 0, "resumed": False,
            "prefix_hit": row.prefix_hit if row else False,
            "prefill_chunks": row.prefill_chunks if row else 0,
            "prefill_chunks_skipped":
                row.prefill_chunks_skipped if row else 0,
            "redispatched": req.redispatched, "restarts": req.restarts,
            "tier": "prefill"}
        if row is not None:
            self.paging.release(row)
        self.completed += 1
        self.outbox.append(comp)

    def step(self):
        """Prefill ONE queued request end to end (admission → handoff
        or local completion). Returns True while the queue holds more
        work."""
        if not self.queue:
            return False
        req = self.queue.popleft()
        # Cross-tier session parking is future work: the prefill tier
        # only reuses prompt KV through the radix prefix cache.
        row = self.paging.admit(req.prompt, session_id=None)
        if row is None:
            # This worker frees its pages synchronously after every
            # handoff, so a dry pool here is PERMANENT (the prompt
            # outsizes the pool even with every radix leaf evicted) —
            # a typed completion beats an admission spin.
            self._complete(req, [], "incomplete", row=None)
            return bool(self.queue)
        t0 = time.perf_counter()
        last_logits = self.engine.prefill(
            0, req.prompt,
            page_table=row.table(self.paging.pages_per_row),
            start=row.start)
        self.paging.after_prefill(row, req.prompt)
        first = self.engine.sample_first(last_logits)
        wall = time.perf_counter() - t0
        self.steps += 1
        self.prefills += 1
        self._emit(req, row, wall)
        reason = None
        if req.eos_id is not None and first == req.eos_id:
            reason = "eos"
        elif req.max_new_tokens <= 1:
            reason = "max_new_tokens"
        elif len(req.prompt) >= _bucket_for(self.engine, req):
            reason = "length"
        if reason is not None:
            self._complete(req, [first], reason, row=row)
            return bool(self.queue)
        meta = HandoffMeta(
            rid=req.rid, prompt_len=len(req.prompt), first_token=first,
            next_pos=len(req.prompt), page_size=self.engine.page_size,
            pages_per_row=self.engine.pages_per_row,
            n_pages=len(row.pages), parked=self.store.durable)
        nbytes = self.store.park(req.rid, self.engine, row.pages, meta)
        # The row's references drop; interned prefix pages survive via
        # the radix tree's own refs, so later prompts still hit them.
        self.paging.release(row)
        self.handoffs += 1
        self.handoff_bytes += nbytes
        self.outbox.append({
            "kind": "prefilled", "rid": req.rid,
            "prompt_len": len(req.prompt), "handoff": meta.to_dict(),
            "handoff_bytes": nbytes, "prefix_hit": row.prefix_hit,
            "prefill_chunks": row.prefill_chunks,
            "prefill_chunks_skipped": row.prefill_chunks_skipped,
            "wall_s": wall})
        return bool(self.queue)

    def _emit(self, req, row, wall_s):
        if self.session is None:
            return
        self.session.emit(
            "prefill_step", tier="prefill", rid=req.rid, step=self.steps,
            prompt_len=len(req.prompt), chunks=row.prefill_chunks,
            chunks_skipped=row.prefill_chunks_skipped,
            prefix_hit=row.prefix_hit, queue_depth=len(self.queue),
            wall_s=wall_s,
            pages_free=self.paging.allocator.free_pages)
        reg = self.session.registry
        reg.histogram(
            "prefill_step_seconds",
            help="host wall per prefill-tier admission").observe(wall_s)
        reg.counter(
            "prefill_requests_total",
            help="requests prefilled by the prefill tier").inc()

    def stats(self):
        counts = self.engine.compile_counts() if hasattr(
            self.engine, "compile_counts") else {}
        return {"tier": "prefill", "compile_counts": counts,
                "steps": self.steps, "completed": self.completed,
                "prefills": self.prefills, "handoffs": self.handoffs,
                "handoff_bytes": self.handoff_bytes}


class DecodeWorker:
    """The decode tier's loop: install handed-off pages, seed a slot
    through ``admit_prefilled`` (no prefill call — the prefill
    signature count stays zero, and ``engine.tier == "decode"`` makes
    any slip a hard raise), then run the plain continuous-batching
    decode loop.

    Handoff failures are typed outputs, not crashes: a CRC-rotted
    snapshot (``handoff_corrupt``) or a consumed/missing one
    (``handoff_missing``) tells the router to cold re-prefill; a
    geometry mismatch (``handoff_error``) is a config bug re-prefill
    can't fix, reported as a failed completion."""

    tier = "decode"

    def __init__(self, engine, store, session=None):
        if getattr(engine, "kv_layout", "ring") != "paged":
            raise ValueError(
                "disaggregated tiers require kv_layout='paged' — the "
                "KV handoff is a page copy")
        if getattr(engine, "tier", None) not in (None, "decode"):
            raise ValueError(
                f"DecodeWorker needs a decode-tier engine, got "
                f"tier={engine.tier!r}")
        self.engine = engine
        self.store = store
        self.session = session if session is not None \
            else engine.session
        self.sched = ContinuousBatchingScheduler(
            engine, session=self.session)
        self.pending = collections.deque()   # (request, HandoffMeta)
        self.outbox = []
        self._reported = 0
        self.installed = 0
        self.corrupt = 0
        self.completed = 0

    @property
    def has_work(self):
        return bool(self.pending) or bool(self.sched.queue) or any(
            s is not None for s in self.sched.slots)

    def submit(self, request, meta=None):
        if meta is None:
            raise ValueError(
                f"request {request.rid}: the decode tier only accepts "
                f"handoffs (no prefill program here)")
        if not isinstance(meta, HandoffMeta):
            meta = HandoffMeta.from_dict(meta)
        # Cross-tier session parking is future work: pages parked here
        # could never be resumed (admission happens on the other tier),
        # so they would leak in this pool until eviction pressure.
        request.session_id = None
        self.pending.append((request, meta))

    def drain_outputs(self):
        out, self.outbox = self.outbox, []
        return out

    def _free(self, pages):
        for p in pages:
            self.sched.paging.allocator.decref(p)

    def _try_install(self):
        pg = self.sched.paging
        while self.pending:
            if all(s is not None for s in self.sched.slots):
                return
            req, meta = self.pending[0]
            if meta.page_size != pg.page_size or \
                    meta.pages_per_row != pg.pages_per_row:
                self.pending.popleft()
                self.outbox.append({
                    "kind": "handoff_error", "rid": req.rid,
                    "error": f"handoff geometry mismatch: prefill tier "
                             f"page_size={meta.page_size}/"
                             f"pages_per_row={meta.pages_per_row}, "
                             f"decode tier {pg.page_size}/"
                             f"{pg.pages_per_row}"})
                continue
            pages, dry = [], False
            for _ in range(meta.n_pages):
                p = pg._alloc_with_pressure()
                if p is None:
                    dry = True
                    break
                pages.append(p)
            if dry:
                self._free(pages)
                if any(s is not None for s in self.sched.slots):
                    return          # live rows will free pages; retry
                # nothing live and the ladder is dry: this handoff can
                # never land in this pool — typed completion, not a spin
                self.pending.popleft()
                self.outbox.append({
                    "kind": "completion", "rid": req.rid,
                    "prompt_len": meta.prompt_len, "tokens": [],
                    "finish_reason": "incomplete",
                    "bucket": _bucket_for(self.engine, req), "slot": -1,
                    "steps": 0, "prefix_hit": False, "resumed": False,
                    "prefill_chunks": 0, "prefill_chunks_skipped": 0,
                    "redispatched": req.redispatched,
                    "restarts": req.restarts, "tier": "decode"})
                self.completed += 1
                continue
            try:
                self.store.install(req.rid, self.engine, pages)
            except KeyError:
                self._free(pages)
                self.pending.popleft()
                self.outbox.append(
                    {"kind": "handoff_missing", "rid": req.rid})
                continue
            except HostPageCorruptError:
                self._free(pages)
                self.pending.popleft()
                self.corrupt += 1
                self.outbox.append(
                    {"kind": "handoff_corrupt", "rid": req.rid})
                if self.session is not None:
                    self.session.emit(
                        "handoff_corrupt", level="warning", rid=req.rid,
                        tier="decode")
                continue
            self.pending.popleft()
            row = RowPaging(pages=pages, start=0, resumed=True)
            self.sched.admit_prefilled(req, row, meta.first_token)
            self.installed += 1

    def step(self):
        self._try_install()
        if bool(self.sched.queue) or any(
                s is not None for s in self.sched.slots):
            self.sched.step()
        new = self.sched.completions[self._reported:]
        self._reported = len(self.sched.completions)
        if new:
            from deepspeed_tpu_torch.inference.fleet import (
                completion_dict)
            for c in new:
                self.completed += 1
                self.outbox.append(dict(completion_dict(c),
                                        kind="completion",
                                        tier="decode"))
        return self.has_work

    def stats(self):
        counts = self.engine.compile_counts() if hasattr(
            self.engine, "compile_counts") else {}
        return {"tier": "decode", "compile_counts": counts,
                "steps": self.sched.step_count,
                "completed": self.completed,
                "installed": self.installed, "corrupt": self.corrupt}


class DisaggCoordinator:
    """Both tiers driven synchronously in one process: round-robin
    dispatch into N prefill workers, least-loaded dispatch of finished
    handoffs into M decode workers, corrupt handoffs recycled as cold
    re-prefills. Deterministic (no threads, no wall-clock scheduling),
    which is exactly what the parity tests and ``chip_smoke.py`` need: same request stream in, same tokens out, while
    each tier's ``compile_counts()`` pins one program."""

    def __init__(self, prefill_engines, decode_engines, store=None,
                 session=None):
        if not prefill_engines or not decode_engines:
            raise ValueError("need >= 1 engine per tier")
        self.store = store if store is not None else DeviceHandoffStore()
        self.prefill = [PrefillWorker(e, self.store, session=session)
                        for e in prefill_engines]
        self.decode = [DecodeWorker(e, self.store, session=session)
                       for e in decode_engines]
        self.session = session
        self.completions = []
        self.handoffs = 0
        self.handoff_bytes = 0
        self.reprefills = 0
        self._requests = {}
        self._rr = 0

    def _submit_prefill(self, request):
        self._requests[request.rid] = request
        self.prefill[self._rr % len(self.prefill)].submit(request)
        self._rr += 1

    def _decode_target(self):
        def load(w):
            live = sum(1 for s in w.sched.slots if s is not None)
            free = w.engine.max_batch - live
            return (len(w.pending) - free, len(w.pending))
        return min(self.decode, key=load)

    def _route(self, out):
        kind = out.get("kind")
        if kind == "prefilled":
            self.handoffs += 1
            self.handoff_bytes += out["handoff_bytes"]
            req = self._requests[out["rid"]]
            self._decode_target().submit(
                req, HandoffMeta.from_dict(out["handoff"]))
        elif kind in ("handoff_corrupt", "handoff_missing"):
            # cold re-prefill: never serve from a rotten page
            req = self._requests[out["rid"]]
            req.restarts += 1
            self.reprefills += 1
            self.store.drop(out["rid"])
            self.prefill[self._rr % len(self.prefill)].submit(req)
            self._rr += 1
        elif kind == "handoff_error":
            raise RuntimeError(out["error"])
        else:                       # completion
            self.completions.append(out)
            self.store.drop(out["rid"])

    def run(self, requests, max_rounds=100000):
        """Drain ``requests`` through both tiers; completion dicts in
        finish order (each tagged with the tier that finished it)."""
        for r in requests:
            self._submit_prefill(r)
        for _ in range(max_rounds):
            busy = False
            for w in self.prefill:
                if w.has_work:
                    busy = True
                    w.step()
                for out in w.drain_outputs():
                    self._route(out)
            for w in self.decode:
                if w.has_work:
                    busy = True
                    w.step()
                for out in w.drain_outputs():
                    self._route(out)
            if not busy and not any(w.has_work for w in self.prefill) \
                    and not any(w.has_work for w in self.decode):
                break
        return list(self.completions)

    def tier_stats(self):
        """Per-tier aggregates, compile counts summed across each
        tier's workers — the numbers the 2-program contract pins."""
        def agg(workers):
            counts = {"prefill": 0, "decode": 0}
            stats = [w.stats() for w in workers]
            for s in stats:
                for k, v in s["compile_counts"].items():
                    counts[k] = counts.get(k, 0) + v
            return {"workers": len(workers), "compile_counts": counts,
                    "per_worker": stats}
        out = {"prefill": agg(self.prefill), "decode": agg(self.decode)}
        out["handoffs"] = self.handoffs
        out["handoff_bytes"] = self.handoff_bytes
        out["handoff_bytes_per_session"] = (
            self.handoff_bytes // self.handoffs if self.handoffs else 0)
        out["reprefills"] = self.reprefills
        return out
