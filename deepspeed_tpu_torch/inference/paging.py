"""Host-side paging for the paged KV cache: allocator, radix-tree
prefix cache, and the host-RAM tier for parked sessions (port of
``deepspeed_tpu/inference/paging.py``).

Everything in this module is admission-time METADATA. The engine's
programs only ever see the statically-shaped page pool and fixed-width
int32 page tables (`inference/cache.py` paged layout); what this
module decides — which physical page backs which logical span, which
prompt pages are shared between requests, which parked session's pages
live in host RAM right now — changes the *contents* of those tables,
never a program's input shape. That is the whole design: allocator
churn, prefix hits and park/resume ride the serving loop without
touching the 2-program contract (`engine.compile_counts`).

Three cooperating pieces, driven by :class:`PagedCacheManager`:

- :class:`PageAllocator` — free list + per-page refcounts over the
  pool. Physical page 0 is reserved as the TRASH page (unallocated
  table entries and inactive decode rows point at it), so every
  device-side gather/scatter is in-bounds by construction.
- :class:`RadixPrefixCache` — a radix tree over prompt tokens with
  fixed ``page_size``-token edges: one node per interned page, children
  keyed by the next page's token tuple. A request whose prompt walks
  ``m`` nodes shares those ``m`` physical pages (refcounted — the
  sharing IS copy-on-write at page granularity: writes only ever land
  in pages past the shared span, so divergence allocates private pages
  instead of copying) and prefill resumes at token ``m * page_size``.
- :class:`HostPageStore` — parked sessions' pages evacuated to host
  RAM under allocator pressure, snapshot-isolated (copied, never a
  view of the pool) and CRC-stamped per leaf
  (`runtime/resilience/checksums.py`); resume pages them back in
  through freshly allocated device pages. The snapshot's leaves are
  numpy arrays of the pool's raw bytes: numpy has no bf16 or fp8, so
  those leaves travel as same-width integer views
  (`engine.gather_pages`).

Whole-page sharing only: a prefix hit maps ``min(matched, floor((len
(prompt)-1)/page_size))`` pages, never a partial page — partial-page
sharing would need a device-side copy program (a third program) for
the divergent tail, whereas whole pages make COW semantics emerge from
"writes never target shared pages".
"""

import dataclasses
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.resilience import fault_injection
from deepspeed_tpu_torch.runtime.resilience.checksums import (
    iter_leaves,
    leaf_checksums,
    tree_nbytes,
)

TRASH_PAGE = 0


class OutOfPagesError(RuntimeError):
    """The pool has no free page and nothing left to evict."""


class HostPageCorruptError(RuntimeError):
    """A parked session's host-RAM snapshot failed CRC verification at
    page-in. Scattering rotted bytes into the pool would poison the
    session's whole continuation, so the snapshot is unusable — but the
    PROMPT still exists, so the scheduler recovers by dropping the
    parked pages and re-prefilling from scratch instead of crashing
    the engine (`PagedCacheManager.admit` catches this)."""

    def __init__(self, session_id, bad_leaves):
        self.session_id = session_id
        self.bad_leaves = list(bad_leaves)
        super().__init__(
            f"host page tier: CRC mismatch for session {session_id!r} "
            f"on {len(self.bad_leaves)} leaves "
            f"(first: {self.bad_leaves[:3]})")


class PageAllocator:
    """Free-list page allocator with refcounts over ``n_pages``
    physical pages; page 0 (the trash page) is never handed out."""

    def __init__(self, n_pages):
        self.n_pages = int(n_pages)
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is reserved), got "
                f"{self.n_pages}")
        # LIFO free list: recently freed pages are re-used first, which
        # keeps the working set of hot pages small.
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._refs = np.zeros(self.n_pages, np.int32)

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def resident_pages(self):
        """Allocated pages (excluding trash)."""
        return self.n_pages - 1 - len(self._free)

    def alloc(self):
        """One free physical page id (refcount 1), or None when the
        pool is exhausted — callers run their eviction ladder then."""
        if not self._free:
            return None
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def incref(self, page):
        if page == TRASH_PAGE:
            raise ValueError("cannot take a reference on the trash page")
        if self._refs[page] < 1:
            raise ValueError(f"incref on free page {page}")
        self._refs[page] += 1

    def decref(self, page):
        if self._refs[page] < 1:
            raise ValueError(f"decref on free page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def refcount(self, page):
        return int(self._refs[page])


class _RadixNode:
    __slots__ = ("chunk", "page", "children", "parent", "last_use")

    def __init__(self, chunk, page, parent):
        self.chunk = chunk          # page_size-token tuple (edge label)
        self.page = page            # physical page holding this span's KV
        self.children = {}          # chunk tuple -> _RadixNode
        self.parent = parent
        self.last_use = 0


class RadixPrefixCache:
    """Radix tree over prompt tokens with fixed ``page_size``-token
    edges. Each node owns one allocator reference on its page; a
    matching request takes its OWN reference per shared page, so a node
    evicted mid-flight never frees a page a live row still maps."""

    def __init__(self, allocator, page_size):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._root = _RadixNode(None, None, None)
        self._clock = 0
        self._nodes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return self._nodes

    def _chunks(self, tokens):
        ps = self.page_size
        for i in range(0, (len(tokens) // ps) * ps, ps):
            yield tuple(tokens[i:i + ps])

    def match(self, tokens):
        """Longest interned prefix: a list of physical page ids, one
        per matched full page. Touches the walked nodes' LRU clocks and
        bumps the hit/miss counters."""
        self._clock += 1
        node, pages = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages

    def insert(self, tokens, pages):
        """Intern a prompt's full pages (``pages[i]`` backs tokens
        ``[i*ps, (i+1)*ps)``). New nodes take one reference per page;
        already-interned spans are left as-is (same tokens ⟹ same KV
        bytes — prefill is deterministic)."""
        self._clock += 1
        node = self._root
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            child = node.children.get(chunk)
            if child is None:
                self.allocator.incref(pages[i])
                child = _RadixNode(chunk, pages[i], node)
                node.children[chunk] = child
                self._nodes += 1
            child.last_use = self._clock
            node = child

    def evict_one(self):
        """Drop the least-recently-used LEAF (interior nodes anchor
        their descendants' prefixes) and release its page reference.
        Returns True if something was evicted."""
        victim = None
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif victim is None or node.last_use < victim.last_use:
                victim = node
        if victim is None:
            return False
        del victim.parent.children[victim.chunk]
        self.allocator.decref(victim.page)
        self._nodes -= 1
        return True


class HostPageStore:
    """Parked sessions' page snapshots in host RAM, CRC-stamped on the
    way in and verified on the way out (the hot-checkpoint tier's
    corruption discipline — resuming a session from silently rotted
    host memory would poison its whole continuation)."""

    def __init__(self):
        self._parked = {}           # session_id -> (tree, checksums, nbytes)

    def __len__(self):
        return len(self._parked)

    def __contains__(self, session_id):
        return session_id in self._parked

    @property
    def nbytes(self):
        return sum(n for _, _, n in self._parked.values())

    def park(self, session_id, host_pages):
        """Keep ``host_pages`` (a nested dict of numpy arrays) under
        ``session_id``, CRC-stamped."""
        nbytes = tree_nbytes(host_pages)
        checksums = leaf_checksums(host_pages)
        if fault_injection.corrupt_host_pages(session_id):
            # Harness-injected rot: flip one byte in the first leaf
            # AFTER the CRCs were stamped, so take() must detect it.
            host_pages = _flip_first_byte(host_pages)
        self._parked[session_id] = (host_pages, checksums, nbytes)

    def take(self, session_id):
        """Remove and return a parked snapshot after CRC verification.

        A failed verification removes the snapshot anyway (rotted bytes
        are useless to every future caller) and raises
        :class:`HostPageCorruptError`."""
        tree, checksums, _ = self._parked.pop(session_id)
        actual = leaf_checksums(tree)
        if actual != checksums:
            bad = sorted(k for k in checksums
                         if actual.get(k) != checksums[k])
            raise HostPageCorruptError(session_id, bad)
        return tree

    def drop(self, session_id):
        self._parked.pop(session_id, None)


def _flip_first_byte(tree):
    """A copy of the nested dict ``tree`` whose first leaf (in
    checksum order) has its first byte inverted."""
    first, _ = next(iter_leaves(tree))

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        if prefix[:-1] != first:
            return node
        buf = np.array(node)
        buf.reshape(-1).view(np.uint8)[0] ^= 0xFF
        return buf

    return walk(tree, "")


@dataclasses.dataclass
class _ParkedSession:
    """A finished-but-retained session: its KV-covered token history
    and the pages that hold it — on device (``pages``) or evacuated to
    the host tier (``on_device=False``; the snapshot lives in the
    :class:`HostPageStore` under the session id)."""
    tokens: List[int]               # tokens whose KV the pages cover
    next_pos: int                   # KV frontier (== len(tokens))
    pages: List[int]                # physical ids (valid on device)
    on_device: bool
    last_use: int = 0


@dataclasses.dataclass
class RowPaging:
    """Per-slot paging state while a request is live."""
    pages: List[int]                # logical page idx -> physical id
    start: int                      # prefill resume point (chunk-aligned)
    prefix_hit: bool = False
    resumed: bool = False
    prefill_chunks: int = 0         # chunks actually run
    prefill_chunks_skipped: int = 0

    def table(self, pages_per_row):
        t = np.zeros(pages_per_row, np.int32)
        t[:len(self.pages)] = self.pages
        return t


class PagedCacheManager:
    """The scheduler's paging brain: admission (prefix match → page
    mapping → mid-prompt prefill plan), per-step page growth, and the
    park/evacuate/resume ladder. Owns the allocator, the radix tree and
    the host store; talks to the engine only through
    ``gather_pages``/``scatter_pages`` and static facts."""

    def __init__(self, engine, session=None):
        if engine.kv_layout != "paged":
            raise ValueError("PagedCacheManager requires a paged engine")
        self.engine = engine
        self.session = session
        self.page_size = engine.page_size
        self.pages_per_row = engine.pages_per_row
        self.allocator = PageAllocator(engine.n_pages)
        self.radix = RadixPrefixCache(self.allocator, self.page_size) \
            if engine.prefix_cache else None
        self.host_store = HostPageStore()
        self.sessions: Dict[str, _ParkedSession] = {}
        self._clock = 0
        self.sessions_admitted = 0
        self.sessions_parked = 0
        self.sessions_resumed = 0
        self.pages_evacuated = 0
        self.pages_paged_in = 0
        self.host_pages_corrupt = 0

    # -- bookkeeping ---------------------------------------------------------

    def _pages_for(self, n_tokens):
        return -(-int(n_tokens) // self.page_size)

    def page_bytes(self):
        """Device bytes of ONE physical page across all layers (pool
        bytes / n_pages) — the unit the bytes/session accounting and
        the bench A/B row count in."""
        from deepspeed_tpu_torch.inference.cache import kv_cache_nbytes
        return kv_cache_nbytes(self.engine.cache) // self.engine.n_pages

    # NB: the radix tree defines __len__, so an EMPTY tree is falsy —
    # these guards must be identity checks or a cold cache would
    # report zero misses until its first insert.
    @property
    def prefix_hits(self):
        return self.radix.hits if self.radix is not None else 0

    @property
    def prefix_misses(self):
        return self.radix.misses if self.radix is not None else 0

    def facts(self):
        return {
            "page_size": self.page_size,
            "n_pages": self.engine.n_pages,
            "pages_free": self.allocator.free_pages,
            "pages_resident": self.allocator.resident_pages,
            "page_bytes": self.page_bytes(),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "radix_nodes": len(self.radix) if self.radix is not None
                           else 0,
            "sessions_admitted": self.sessions_admitted,
            "sessions_parked_device": sum(
                1 for s in self.sessions.values() if s.on_device),
            "sessions_parked_host": len(self.host_store),
            "sessions_resumed": self.sessions_resumed,
            "pages_evacuated": self.pages_evacuated,
            "pages_paged_in": self.pages_paged_in,
            "host_pages_corrupt": self.host_pages_corrupt,
            "host_tier_bytes": self.host_store.nbytes,
        }

    # -- eviction ladder -----------------------------------------------------

    def _alloc_with_pressure(self):
        """One page, running the pressure ladder on exhaustion: radix
        LRU leaves first (pure cache — losing one only costs future
        prefill skips), then parked device sessions to the host tier.
        Returns None only when both ladders are dry."""
        page = self.allocator.alloc()
        while page is None:
            if self.radix is not None and self.radix.evict_one():
                page = self.allocator.alloc()
                continue
            if self._evacuate_lru_session():
                page = self.allocator.alloc()
                continue
            return None
        return page

    def _evacuate_lru_session(self):
        victims = [(s.last_use, sid) for sid, s in self.sessions.items()
                   if s.on_device]
        if not victims:
            return False
        _, sid = min(victims)
        self._evacuate(sid)
        return True

    def _evacuate(self, sid):
        """Move one device-parked session's pages to the host tier and
        free the device pages. The gather runs OUTSIDE the two programs:
        parking cost is admission-path latency, never a decode-step
        host transfer."""
        sess = self.sessions[sid]
        self.host_store.park(sid, self.engine.gather_pages(sess.pages))
        for p in sess.pages:
            self.allocator.decref(p)
        self.pages_evacuated += len(sess.pages)
        sess.pages = []
        sess.on_device = False

    def maybe_evacuate(self):
        """Threshold-driven background parking: while the free-pool
        fraction sits below ``host_park_threshold``, push the LRU
        device-parked session out to host RAM."""
        thresh = self.engine.host_park_threshold
        if thresh <= 0.0:
            return
        while (self.allocator.free_pages / float(self.engine.n_pages)
               < thresh) and self._evacuate_lru_session():
            pass

    # -- admission -----------------------------------------------------------

    def admit(self, prompt, session_id=None):
        """Page plan for a new request: resume its parked session if
        the prompt extends one, else walk the radix tree for a shared
        prefix; allocate private pages for the rest of the prompt span.
        Returns a :class:`RowPaging` or None when the pool can't back
        the request right now (the scheduler leaves it queued)."""
        self._clock += 1
        n = len(prompt)
        chunk = self.engine.prefill_chunk
        pages: List[int] = []
        start = 0
        prefix_hit = resumed = False

        sess = self.sessions.get(session_id) if session_id else None
        if sess is not None and 0 < sess.next_pos <= n and \
                list(prompt[:sess.next_pos]) == sess.tokens:
            # session resume: the parked pages already hold KV for
            # prompt[:next_pos]; prefill restarts at the chunk floor of
            # the frontier (deterministically rewriting the partial
            # chunk — same tokens, same bytes).
            del self.sessions[session_id]
            if not sess.on_device:
                n_need = self._pages_for(sess.next_pos)
                fresh = []
                for _ in range(n_need):
                    p = self._alloc_with_pressure()
                    if p is None:
                        for q in fresh:
                            self.allocator.decref(q)
                        self.sessions[session_id] = sess
                        return None
                    fresh.append(p)
                try:
                    self.engine.scatter_pages(
                        fresh, self.host_store.take(session_id))
                except HostPageCorruptError:
                    # The rotted snapshot is gone (take() dropped it);
                    # free the landing pages and fall through to a cold
                    # admission — the session survives as a plain
                    # re-prefill from the prompt.
                    for q in fresh:
                        self.allocator.decref(q)
                    self.host_pages_corrupt += 1
                    sess = None
                else:
                    self.pages_paged_in += len(fresh)
                    sess.pages = fresh
                    sess.on_device = True
            if sess is not None:
                pages = list(sess.pages)  # row takes the session's refs
                start = (min(sess.next_pos, n - 1) // chunk) * chunk
                resumed = True
        if not resumed and self.radix is not None:
            # cap at floor((n-1)/ps): the LAST prompt token always
            # prefills (its logits seed sampling), so a prompt that is
            # entirely interned still runs its final page's chunks.
            matched = self.radix.match(prompt)
            m = min(len(matched), (n - 1) // self.page_size)
            if m:
                for p in matched[:m]:
                    self.allocator.incref(p)
                pages = list(matched[:m])
                start = m * self.page_size
                prefix_hit = True

        fresh = []
        for _ in range(len(pages), self._pages_for(n)):
            p = self._alloc_with_pressure()
            if p is None:
                for q in fresh:
                    self.allocator.decref(q)
                if resumed:
                    # roll the resume back: re-park on device
                    sess.pages = pages
                    self.sessions[session_id] = sess
                else:
                    for q in pages:
                        self.allocator.decref(q)
                return None
            fresh.append(p)
        pages.extend(fresh)

        self.sessions_admitted += 1
        if resumed:
            self.sessions_resumed += 1
        padded_chunks = -(-n // chunk)
        return RowPaging(
            pages=pages, start=start, prefix_hit=prefix_hit,
            resumed=resumed,
            prefill_chunks=padded_chunks - start // chunk,
            prefill_chunks_skipped=start // chunk)

    def after_prefill(self, row, prompt):
        """Intern the freshly prefilled prompt's full pages so later
        requests sharing the prefix hit them."""
        if self.radix is not None:
            self.radix.insert(prompt, row.pages)

    def ensure_position(self, row, pos):
        """Grow the row's mapping to cover a write at ``pos`` (the next
        decode step). False when the pool is dry even after the
        pressure ladder — the scheduler length-finishes the row."""
        li = pos // self.page_size
        if li < len(row.pages):
            return True
        if li >= self.pages_per_row:
            return False
        page = self._alloc_with_pressure()
        if page is None:
            return False
        row.pages.append(page)
        return True

    def ensure_span(self, row, start, end):
        """Grow the row's mapping to cover writes at every position in
        ``[start, end]`` — the speculative round's potentially-ACCEPTED
        frontier (``next_pos .. next_pos + draft_len``; an accepted
        draft's KV must land on a real page, while pad/rejected writes
        past the mapping harmlessly hit the trash page). Walks page by
        page so a multi-page draft window can't skip an allocation;
        False length-finishes the row exactly like
        :meth:`ensure_position`."""
        for pos in range(start, end + 1):
            if not self.ensure_position(row, pos):
                return False
        return True

    # -- release / park ------------------------------------------------------

    def release(self, row, kv_tokens=None, session_id=None):
        """Return a finished row's pages. With a ``session_id`` the
        pages PARK instead (retained on device, LRU-evacuated to host
        under pressure) keyed by the token history their KV covers, so
        a follow-up request on the session resumes without re-prefill;
        otherwise every reference drops back to the allocator."""
        self._clock += 1
        if session_id and kv_tokens:
            covered = min(len(kv_tokens),
                          len(row.pages) * self.page_size)
            old = self.sessions.pop(session_id, None)
            if old is not None and old.on_device:
                for p in old.pages:
                    self.allocator.decref(p)
            self.host_store.drop(session_id)
            self.sessions[session_id] = _ParkedSession(
                tokens=list(kv_tokens[:covered]), next_pos=covered,
                pages=list(row.pages), on_device=True,
                last_use=self._clock)
            self.sessions_parked += 1
            self.maybe_evacuate()
        else:
            for p in row.pages:
                self.allocator.decref(p)
        row.pages = []


def prompt_fingerprint(prompt):
    """Stable id for synthetic/serve bookkeeping (crc of the ids)."""
    return zlib.crc32(np.asarray(prompt, np.int64).tobytes()) & 0xFFFFFFFF
