"""Host-side paging: the port's `deepspeed_tpu_torch/inference/paging.py`
against the JAX package's `deepspeed_tpu/inference/paging.py`.

Every scenario runs the SAME operation sequence on both modules and
records what it observes — page ids, refcounts, radix matches and
evictions, ``RowPaging`` plans, ``facts()``, errors — into a trace; the
two traces must be equal. The cases follow the JAX package's own
`tests/unit/test_paged_cache.py`: the allocator, the radix tree, the
host store, the manager's admission / copy-on-write / park / resume
ladder, and CRC corruption leading to a cold re-prefill.

The manager talks to its engine through geometry facts and
``gather_pages``/``scatter_pages`` only, so a stub pool stands in for
the engine: numpy leaves on the JAX side, torch tensors holding the
same values on the port's side.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paging as jpaging
from deepspeed_tpu.runtime.resilience import fault_injection as jfaults
from deepspeed_tpu_torch.inference import paging as tpaging
from deepspeed_tpu_torch.runtime.resilience import fault_injection as tfaults

SIDES = {"jax": (jpaging, jfaults), "port": (tpaging, tfaults)}


class _PoolEngine:
    """Duck-typed engine: geometry facts plus a one-layer pool that
    gather/scatter move pages of."""

    kv_layout = "paged"

    def __init__(self, side, n_pages=6, page_size=4, pages_per_row=4,
                 prefill_chunk=4, prefix_cache=True, host_park_threshold=0.0):
        self.side = side
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_row = pages_per_row
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.host_park_threshold = host_park_threshold
        pool = np.random.default_rng(0).standard_normal(
            (n_pages, page_size, 2, 2)).astype(np.float32)
        leaf = pool if side == "jax" else torch.from_numpy(pool)
        self.cache = {"h_0": {"k": leaf}}

    def pool(self):
        return np.asarray(self.cache["h_0"]["k"]).copy()

    def gather_pages(self, page_ids):
        ids = np.asarray(page_ids)
        return {"h_0": {"k": np.asarray(self.cache["h_0"]["k"])[ids].copy()}}

    def scatter_pages(self, page_ids, host_pages):
        vals = host_pages["h_0"]["k"]
        if self.side == "port":
            vals = torch.from_numpy(vals)
        self.cache["h_0"]["k"][np.asarray(page_ids)] = vals


def _row(row):
    return None if row is None else dataclasses.asdict(row)


def _error(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


# -- scenarios: each takes (module, faults, side) and returns a trace ------

def allocator(m, _faults, _side):
    trace = []
    trace.append(_error(lambda: m.PageAllocator(1)))
    alloc = m.PageAllocator(5)
    pages = [alloc.alloc() for _ in range(4)]
    trace.append(("pages", pages, alloc.alloc(), alloc.free_pages,
                  alloc.resident_pages))
    alloc.decref(pages[1])
    alloc.decref(pages[3])
    trace.append(("lifo", alloc.alloc(), alloc.alloc()))
    alloc.incref(pages[0])
    trace.append(("refs", alloc.refcount(pages[0]), alloc.refcount(0)))
    alloc.decref(pages[0])
    alloc.decref(pages[0])
    trace.append(_error(lambda: alloc.incref(m.TRASH_PAGE)))
    trace.append(_error(lambda: alloc.incref(pages[0])))
    trace.append(_error(lambda: alloc.decref(pages[0])))
    trace.append(("end", alloc.free_pages, alloc.resident_pages))
    return trace


def radix(m, _faults, _side):
    alloc = m.PageAllocator(8)
    tree = m.RadixPrefixCache(alloc, 4)
    a = list(range(10))
    trace = [("miss", tree.match(a), tree.hits, tree.misses)]
    pa = [alloc.alloc(), alloc.alloc()]
    tree.insert(a, pa)
    tree.insert(a, pa)                        # idempotent
    trace.append(("hit", tree.match(a), len(tree),
                  [alloc.refcount(p) for p in pa]))
    b = a[:4] + [50, 51, 52, 53]
    trace.append(("longest", tree.match(b), tree.match(a[:3])))
    pb = alloc.alloc()
    tree.insert(b, [pa[0], pb])
    tree.match(a)                             # a's leaf is now MRU
    for p in pa + [pb]:
        alloc.decref(p)
    evictions = []
    while True:
        before = {p: alloc.refcount(p) for p in pa + [pb]}
        if not tree.evict_one():
            break
        evictions.append((len(tree), before))
    trace.append(("evict", evictions, alloc.resident_pages, tree.hits,
                  tree.misses))
    return trace


def host_store(m, faults, _side):
    store = m.HostPageStore()
    tree = {"h_0": {"k": np.arange(12, dtype=np.float32).reshape(3, 4),
                    "v": np.ones((3, 4), np.int16)}}
    store.park("s0", tree)
    trace = [("parked", "s0" in store, len(store), store.nbytes)]
    out = store.take("s0")
    trace.append(("take", out["h_0"]["k"].tolist(), out["h_0"]["v"].dtype.str,
                  len(store), store.nbytes))
    store.park("s1", {"h_0": {"k": np.zeros((2, 2), np.float32)}})
    store.drop("s1")
    store.drop("s1")
    faults.clear_faults()
    faults.inject_page_corruption(session_id="s2")
    store.park("s3", {"h_0": {"k": np.zeros(4, np.float32)}})   # not armed
    store.park("s2", tree)
    trace.append(("s3 clean", store.take("s3")["h_0"]["k"].tolist()))
    try:
        store.take("s2")
    except m.HostPageCorruptError as e:
        trace.append(("corrupt", e.session_id, len(e.bad_leaves),
                      "CRC mismatch" in str(e)))
    trace.append(("after", "s2" in store, len(store)))
    faults.clear_faults()
    return trace


def _mgr(m, side, **kw):
    eng = _PoolEngine(side, **kw)
    return eng, m.PagedCacheManager(eng)


def manager_admission(m, _faults, side):
    trace = []
    _, mgr = _mgr(m, side)
    row = mgr.admit(list(range(10)))
    trace.append(("cold", _row(row), mgr.facts()))
    _, mgr = _mgr(m, side)
    prompt = list(range(8))
    first = mgr.admit(prompt)
    mgr.after_prefill(first, prompt)
    again = mgr.admit(prompt)
    trace.append(("hit", _row(first), _row(again),
                  mgr.allocator.refcount(first.pages[0]), mgr.facts()))
    _, mgr = _mgr(m, side, n_pages=8)
    ra = mgr.admit(prompt)
    mgr.after_prefill(ra, prompt)
    rb = mgr.admit(prompt[:4] + [60, 61, 62, 63])
    trace.append(("cow", _row(ra), _row(rb)))
    _, mgr = _mgr(m, side, n_pages=4)
    live = mgr.admit(prompt)
    trace.append(("dry", _row(live), _row(mgr.admit(list(range(100, 108)))),
                  mgr.allocator.free_pages))
    _, mgr = _mgr(m, side, n_pages=4)
    row = mgr.admit(prompt)
    mgr.after_prefill(row, prompt)
    mgr.release(row)
    row2 = mgr.admit(list(range(50, 60)))
    trace.append(("pressure", _row(row2), mgr.facts()))
    _, mgr = _mgr(m, side, n_pages=6, pages_per_row=2)
    row = mgr.admit([1, 2, 3])
    trace.append(("grow", mgr.ensure_position(row, 3),
                  mgr.ensure_position(row, 4), mgr.ensure_position(row, 8),
                  _row(row), row.table(4).tolist()))
    _, mgr = _mgr(m, side, n_pages=9)
    row = mgr.admit([1, 2, 3])
    trace.append(("span", mgr.ensure_span(row, 3, 9), _row(row),
                  mgr.ensure_span(row, 10, 17), _row(row)))
    return trace


def manager_sessions(m, _faults, side):
    trace = []
    prompt = list(range(8))
    _, mgr = _mgr(m, side, n_pages=8)
    row = mgr.admit(prompt, session_id="s")
    mgr.release(row, kv_tokens=prompt + [9], session_id="s")
    trace.append(("parked", mgr.facts()))
    r2 = mgr.admit(prompt + [9, 10, 11], session_id="s")
    trace.append(("resumed", _row(r2), mgr.sessions_resumed, mgr.facts()))
    _, mgr = _mgr(m, side, n_pages=8)
    row = mgr.admit(prompt, session_id="s")
    mgr.release(row, kv_tokens=prompt + [9], session_id="s")
    trace.append(("other prompt",
                  _row(mgr.admit(list(range(40, 48)), session_id="s"))))
    # host tier: threshold 0.9 evacuates at release, resume pages in
    eng, mgr = _mgr(m, side, n_pages=8, host_park_threshold=0.9)
    row = mgr.admit(prompt, session_id="s")
    pages = list(row.pages)
    want = eng.pool()[np.asarray(pages)]
    mgr.release(row, kv_tokens=prompt, session_id="s")
    trace.append(("evacuated", mgr.facts()))
    eng.cache["h_0"]["k"][np.asarray(pages)] = 0.0     # pages recycled
    r2 = mgr.admit(prompt + [9], session_id="s")
    got = eng.pool()[np.asarray(r2.pages[:2])]
    trace.append(("paged in", _row(r2), mgr.facts(),
                  bool(np.array_equal(got, want))))
    # LRU evacuation under allocator pressure (threshold 0)
    _, mgr = _mgr(m, side, n_pages=6)
    for sid, base in (("a", 0), ("b", 100)):
        r = mgr.admit(list(range(base, base + 8)), session_id=sid)
        mgr.release(r, kv_tokens=list(range(base, base + 8)), session_id=sid)
    r = mgr.admit(list(range(200, 212)))
    trace.append(("ladder", _row(r), mgr.facts()))
    return trace


def corruption(m, faults, side):
    faults.clear_faults()
    trace = []
    prompt = list(range(8))
    eng, mgr = _mgr(m, side, n_pages=8, host_park_threshold=0.9)
    row = mgr.admit(prompt, session_id="s")
    faults.inject_page_corruption(session_id="s")
    mgr.release(row, kv_tokens=prompt, session_id="s")
    trace.append(("parked", mgr.facts()))
    r2 = mgr.admit(prompt + [9], session_id="s")
    trace.append(("cold re-prefill", _row(r2), mgr.host_pages_corrupt,
                  mgr.facts()))
    eng, mgr = _mgr(m, side, n_pages=8, host_park_threshold=0.9)
    row = mgr.admit(prompt, session_id="s")
    mgr.release(row, kv_tokens=prompt, session_id="s")
    r2 = mgr.admit(prompt + [9], session_id="s")
    trace.append(("clean", _row(r2), mgr.host_pages_corrupt))
    faults.clear_faults()
    return trace


SCENARIOS = [allocator, radix, host_store, manager_admission,
             manager_sessions, corruption]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_same_operations_give_the_same_trace(scenario):
    traces = {side: scenario(m, f, side) for side, (m, f) in SIDES.items()}
    assert traces["port"] == traces["jax"]
    assert traces["port"]                 # the scenario observed something


def test_manager_behaviour_pins():
    """The trace is not vacuous: the behaviours it records."""
    m = tpaging
    _, mgr = _mgr(m, "port")
    prompt = list(range(8))
    first = mgr.admit(prompt)
    mgr.after_prefill(first, prompt)
    again = mgr.admit(prompt)
    assert again.prefix_hit and again.start == 4
    assert again.pages[0] == first.pages[0] != again.pages[1]
    assert mgr.allocator.refcount(first.pages[0]) == 3
    facts = mgr.facts()
    assert facts["pages_free"] + facts["pages_resident"] == \
        facts["n_pages"] - 1
    assert facts["page_bytes"] * facts["n_pages"] == 6 * 4 * 2 * 2 * 4
    # empty radix tree is falsy, yet counts its misses
    _, mgr = _mgr(m, "port")
    assert len(mgr.radix) == 0 and not mgr.radix
    mgr.admit([1, 2, 3])
    assert mgr.prefix_misses == 1


def test_prompt_fingerprint_matches_jax():
    for prompt in ([1, 2, 3], list(range(100)), [50256]):
        assert tpaging.prompt_fingerprint(prompt) == \
            jpaging.prompt_fingerprint(prompt)
