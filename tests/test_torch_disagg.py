"""The port's disaggregated prefill/decode serving
(``deepspeed_tpu_torch/inference/disagg.py``, the router's
``DisaggRouter``, the engine's tiers and ``gather_pages_device``),
mirroring ``tests/unit/test_disagg.py`` on the CPU.

- Handoff stores: the metadata round trip, the consume-once device
  store, the durable file store and its CRC rot check.
- Tier pins: a prefill-tier engine raises on decode, a decode-tier one
  on prefill, and after a stream each tier holds exactly one program.
- Parity: the coordinator's and the threaded router's greedy streams
  equal JAX's ``DisaggCoordinator`` stream on params converted from the
  JAX init (``convert_gpt2_params``), bit for bit, and the colocated
  port engine's; with int8 KV and flash decode they equal the colocated
  port engine's.
- Failure typing, the tier-aware drain of a dead decode worker on
  scripted fakes, the config block, one process-tier serve through the
  file store.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.disagg import (
    DisaggCoordinator as JaxCoordinator,
)
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu_torch.inference.disagg import (
    META_FIELDS,
    DecodeWorker,
    DeviceHandoffStore,
    DisaggCoordinator,
    FileHandoffStore,
    HandoffMeta,
    PrefillWorker,
)
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.paging import HostPageCorruptError
from deepspeed_tpu_torch.inference.router import DisaggRouter
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHead,
    convert_gpt2_params,
)
from deepspeed_tpu_torch.runtime.resilience import fault_injection
from tests.unit.test_disagg import _FakeReplica, _FakeStore, _PoolEngine

PREFILL_PIN = {"prefill": 1, "decode": 0}
DECODE_PIN = {"prefill": 0, "decode": 1}

# the shared request stream: prompt lengths straddle both seq buckets
# and the page boundary, so handoffs carry 1..3 pages
_rng = np.random.default_rng(7)
PROTOS = [(f"r{i}", _rng.integers(0, 64, 3 + 4 * i).tolist(), 4)
          for i in range(4)]
GEOMETRY = dict(vocab_size=64, n_positions=64, n_embd=32, n_layer=2,
                n_head=4)


def _requests(cls=Request):
    return [cls(rid, list(prompt), max_new_tokens=m)
            for rid, prompt, m in PROTOS]


def _engine_config(kvdt=None, impl="dense", **knobs):
    return {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
            "kv_cache_dtype": kvdt, "attention_impl": impl,
            "attention_block_k": 8, "kv_layout": "paged", **knobs}


@pytest.fixture(scope="module")
def jax_model():
    model = JaxGPT2(JaxConfig(dtype=jnp.float32, **GEOMETRY))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


_STATE = {}


@pytest.fixture(scope="module", autouse=True)
def _port_state(jax_model):
    _STATE["params"] = convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, jax_model[1]))
    yield
    _STATE.clear()


def _build(kvdt=None, impl="dense", **knobs):
    model = GPT2LMHead(GPT2Config(dtype=torch.float32, **GEOMETRY),
                       device="cpu")
    return InferenceEngine(model, _STATE["params"],
                           config=_engine_config(kvdt, impl, **knobs),
                           device="cpu")


def _oracle(kvdt=None, impl="dense"):
    """Colocated single-engine greedy stream: {rid: tokens}."""
    sched = ContinuousBatchingScheduler(_build(kvdt, impl))
    for r in _requests():
        sched.submit(r)
    sched.run()
    return {c.rid: list(c.tokens) for c in sched.completions}


@pytest.fixture(scope="module")
def oracle_f32():
    return _oracle()


@pytest.fixture(scope="module")
def jax_disagg_f32(jax_model):
    model, params = jax_model

    def build(**knobs):
        return JaxEngine(model, params, config=_engine_config(**knobs))
    coord = JaxCoordinator([build(tier="prefill")],
                           [build(tier="decode", max_batch=3)])
    return {c["rid"]: list(c["tokens"])
            for c in coord.run(_requests(JaxRequest))}


def test_port_oracle_is_the_jax_disagg_stream(oracle_f32, jax_disagg_f32):
    assert oracle_f32 == jax_disagg_f32


def test_handoff_meta_roundtrip():
    meta = HandoffMeta(rid=17, prompt_len=12.0, first_token=5,
                       next_pos=12, page_size=8, pages_per_row=4,
                       n_pages=2, parked=1)
    d = meta.to_dict()
    assert set(d) == set(META_FIELDS)
    back = HandoffMeta.from_dict(d)
    # constructor coerces: rid -> str, counts -> int, parked -> bool
    assert back.rid == "17" and back.prompt_len == 12
    assert back.parked is True
    assert back.to_dict() == d


def _meta(rid="a", n_pages=2):
    return HandoffMeta(rid=rid, prompt_len=7, first_token=3, next_pos=7,
                       page_size=8, pages_per_row=4, n_pages=n_pages,
                       parked=False)


def test_device_store_consume_once():
    src = _PoolEngine(fill=2.0)
    dst = _PoolEngine(fill=0.0)
    store = DeviceHandoffStore()
    assert not store.parked("a")
    nbytes = store.park("a", src, [1, 2], _meta())
    # 2 leaves x 2 pages x 3 f32
    assert nbytes == 2 * 2 * 3 * 4
    assert len(store) == 1
    assert store.parked("a") is False       # device arrays never park
    assert store.peek("a").rid == "a"
    meta = store.install("a", dst, [3, 4])
    assert meta.first_token == 3
    np.testing.assert_array_equal(dst.cache["k"][3:5],
                                  src.cache["k"][1:3])
    np.testing.assert_array_equal(dst.cache["v"][3:5],
                                  src.cache["v"][1:3])
    # consume-once: the snapshot left with the install
    assert store.peek("a") is None
    with pytest.raises(KeyError):
        store.install("a", dst, [3, 4])
    store.drop("a")                          # idempotent no-op


def test_file_store_durable_roundtrip(tmp_path):
    src = _PoolEngine(fill=5.0)
    dst = _PoolEngine(fill=0.0)
    store = FileHandoffStore(str(tmp_path))
    assert store.durable
    store.park("b", src, [0, 3], _meta("b"))
    assert store.parked("b")
    assert store.peek("b").prompt_len == 7
    meta = store.install("b", dst, [1, 2])
    assert meta.rid == "b"
    np.testing.assert_array_equal(dst.cache["k"][[1, 2]],
                                  src.cache["k"][[0, 3]])
    # durable: RETAINED after install (a dead decode worker resumes)
    assert store.parked("b")
    store.install("b", dst, [1, 2])
    store.drop("b")
    assert not store.parked("b")
    with pytest.raises(KeyError):
        store.install("b", dst, [1, 2])


def test_file_store_crc_rot_detected_and_deleted(tmp_path):
    fault_injection.clear_faults()
    src = _PoolEngine(fill=1.0)
    dst = _PoolEngine(fill=0.0)
    store = FileHandoffStore(str(tmp_path))
    try:
        fault_injection.inject_page_corruption(session_id="rot",
                                               times=1)
        store.park("rot", src, [1, 2], _meta("rot"))
        assert store.parked("rot")
        with pytest.raises(HostPageCorruptError):
            store.install("rot", dst, [3, 4])
        # rotted bytes help nobody: the snapshot is gone
        assert not store.parked("rot")
        # the destination pool was never scattered into
        np.testing.assert_array_equal(
            dst.cache["k"], _PoolEngine(fill=0.0).cache["k"])
    finally:
        fault_injection.clear_faults()


# ---------------------------------------------------------------------------
# tier pins: each engine runs exactly one of the two programs
# ---------------------------------------------------------------------------

def test_tier_engine_pins_other_program_off():
    pre = _build(tier="prefill")
    with pytest.raises(RuntimeError, match="decode program is pinned"):
        pre.decode(np.zeros(2, np.int32), np.zeros(2, np.int32),
                   page_tables=np.zeros((2, 4), np.int32))
    dec = _build(tier="decode")
    with pytest.raises(RuntimeError, match="prefill program is pinned"):
        dec.prefill(0, [1, 2, 3],
                    page_table=np.zeros(4, np.int32))
    # the guard fires before any program runs: both counts stay zero
    assert pre.compile_counts() == {"prefill": 0, "decode": 0}
    assert dec.compile_counts() == {"prefill": 0, "decode": 0}


def test_tier_requires_paged_layout():
    with pytest.raises(ValueError, match="paged"):
        _build(tier="prefill", kv_layout="ring")


def test_workers_reject_wrong_tier_engine():
    store = DeviceHandoffStore()
    with pytest.raises(ValueError, match="prefill-tier"):
        PrefillWorker(_build(tier="decode"), store)
    with pytest.raises(ValueError, match="decode-tier"):
        DecodeWorker(_build(tier="prefill"), store)


# ---------------------------------------------------------------------------
# coordinator parity vs the colocated oracle
# ---------------------------------------------------------------------------

def _run_coordinator(kvdt=None, impl="dense", store=None):
    pre = _build(kvdt, impl, tier="prefill")
    dec = _build(kvdt, impl, tier="decode", max_batch=3)
    coord = DisaggCoordinator([pre], [dec], store=store)
    comps = coord.run(_requests())
    return coord, comps


PARITY_CASES = [
    pytest.param(None, "dense", id="dense-f32"),
    pytest.param("int8", "dense", id="dense-int8"),
    pytest.param(None, "flash", id="flash-f32"),
    pytest.param("int8", "flash", id="flash-int8"),
]


@pytest.mark.parametrize("kvdt,impl", PARITY_CASES)
def test_disagg_stream_matches_colocated_oracle(kvdt, impl, oracle_f32):
    oracle = oracle_f32 if (kvdt, impl) == (None, "dense") \
        else _oracle(kvdt, impl)
    coord, comps = _run_coordinator(kvdt, impl)
    assert {c["rid"]: c["tokens"] for c in comps} == oracle
    # every request crossed the handoff and finished decode-side
    assert all(c["tier"] == "decode" for c in comps)
    stats = coord.tier_stats()
    assert stats["handoffs"] == len(PROTOS)
    assert stats["handoff_bytes_per_session"] > 0
    assert stats["reprefills"] == 0
    # the 2-program contract: one program per tier, total 2
    assert stats["prefill"]["compile_counts"] == PREFILL_PIN
    assert stats["decode"]["compile_counts"] == DECODE_PIN


def test_disagg_tiers_scale_independently(oracle_f32):
    """2 prefill workers against 2 decode workers (different
    max_batch per tier): same tokens, and EVERY worker still pins
    exactly its own single program."""
    pres = [_build(tier="prefill") for _ in range(2)]
    decs = [_build(tier="decode", max_batch=3) for _ in range(2)]
    coord = DisaggCoordinator(pres, decs)
    comps = coord.run(_requests())
    assert {c["rid"]: c["tokens"] for c in comps} == oracle_f32
    stats = coord.tier_stats()
    for w in stats["prefill"]["per_worker"]:
        assert w["compile_counts"] == PREFILL_PIN
    for w in stats["decode"]["per_worker"]:
        assert w["compile_counts"] == DECODE_PIN


def test_corrupt_handoff_cold_reprefills(tmp_path, oracle_f32):
    """A CRC-rotted file handoff surfaces as `handoff_corrupt`; the
    coordinator recycles the request through a cold re-prefill and the
    final tokens are still oracle-identical (never serve from a rotten
    page)."""
    fault_injection.clear_faults()
    try:
        fault_injection.inject_page_corruption(session_id="r1",
                                               times=1)
        coord, comps = _run_coordinator(
            store=FileHandoffStore(str(tmp_path)))
        assert coord.reprefills == 1
        assert {c["rid"]: c["tokens"] for c in comps} == oracle_f32
        by_rid = {c["rid"]: c for c in comps}
        assert by_rid["r1"]["restarts"] == 1
        stats = coord.tier_stats()
        assert stats["prefill"]["compile_counts"] == PREFILL_PIN
        assert stats["decode"]["compile_counts"] == DECODE_PIN
    finally:
        fault_injection.clear_faults()


def test_prefill_tier_completes_one_token_requests():
    """A request whose first token finishes it never travels: it
    completes on the prefill tier with no handoff parked."""
    store = DeviceHandoffStore()
    worker = PrefillWorker(_build(tier="prefill"), store)
    worker.submit(Request("one", [1, 2, 3], max_new_tokens=1))
    worker.step()
    outs = worker.drain_outputs()
    assert len(outs) == 1
    comp = outs[0]
    assert comp["kind"] == "completion" and comp["tier"] == "prefill"
    assert comp["finish_reason"] == "max_new_tokens"
    assert len(comp["tokens"]) == 1
    assert len(store) == 0 and worker.handoffs == 0


def test_prefill_worker_rejects_malformed_requests():
    worker = PrefillWorker(_build(tier="prefill"), DeviceHandoffStore())
    with pytest.raises(ValueError, match="empty prompt"):
        worker.submit(Request("e", [], max_new_tokens=2))
    with pytest.raises(ValueError, match="does not fit"):
        worker.submit(Request("l", list(range(40)), max_new_tokens=2))


# ---------------------------------------------------------------------------
# decode worker failure typing
# ---------------------------------------------------------------------------

def test_decode_worker_types_handoff_failures():
    eng = _build(tier="decode")
    worker = DecodeWorker(eng, DeviceHandoffStore())
    with pytest.raises(ValueError, match="only accepts handoffs"):
        worker.submit(Request("no-meta", [1, 2], max_new_tokens=2))

    # geometry mismatch: a config bug re-prefill can't fix
    bad = HandoffMeta(rid="geo", prompt_len=4, first_token=1,
                      next_pos=4, page_size=eng.page_size * 2,
                      pages_per_row=eng.pages_per_row, n_pages=1,
                      parked=False)
    worker.submit(Request("geo", [1, 2, 3, 4], max_new_tokens=2), bad)
    worker.step()
    outs = worker.drain_outputs()
    assert [o["kind"] for o in outs] == ["handoff_error"]
    assert "geometry mismatch" in outs[0]["error"]

    # missing snapshot (consumed with a dead worker): re-prefillable
    gone = HandoffMeta(rid="gone", prompt_len=4, first_token=1,
                       next_pos=4, page_size=eng.page_size,
                       pages_per_row=eng.pages_per_row, n_pages=1,
                       parked=False)
    worker.submit(Request("gone", [1, 2, 3, 4], max_new_tokens=2), gone)
    worker.step()
    outs = worker.drain_outputs()
    assert [o["kind"] for o in outs] == ["handoff_missing"]
    assert worker.installed == 0


# ---------------------------------------------------------------------------
# tier-aware drain: scripted fakes, deterministic branches
# ---------------------------------------------------------------------------

def _fake_router(store, **kwargs):
    pre = [_FakeReplica(0)]
    dec = [_FakeReplica(1), _FakeReplica(2)]
    return DisaggRouter(pre, dec, store, **kwargs), pre, dec


def test_drain_dead_decode_resumes_from_park():
    store = _FakeStore(parked_rids={"a"})
    router, _, _ = _fake_router(store)
    req = Request("a", [1, 2, 3], max_new_tokens=4)
    router._metas["a"] = {"page_size": 8}
    router.assigned[1]["a"] = req
    router._drain(1, now=100.0)
    # durable handoff survived the worker: resume, don't re-prefill
    assert router.resumed_from_park == 1
    assert len(router.decode_queue) == 1
    item = router.decode_queue[0]
    assert item.meta == {"page_size": 8}
    assert item.not_before > 100.0          # backoff gate
    assert len(router.queue) == 0
    assert store.dropped == []
    assert req.redispatched == 1 and req.restarts == 1


def test_drain_dead_decode_unparked_reprefills():
    store = _FakeStore()                    # nothing parked
    router, _, _ = _fake_router(store)
    req = Request("a", [1, 2, 3], max_new_tokens=4, arrival_step=5)
    router._metas["a"] = {"page_size": 8}
    router.assigned[1]["a"] = req
    router._drain(1, now=100.0)
    # only the prompt survived: back to the prefill tier from scratch
    assert router.resumed_from_park == 0
    assert len(router.decode_queue) == 0
    assert len(router.queue) == 1
    assert "a" in store.dropped
    assert "a" not in router._metas
    assert req.arrival_step == 0            # admit immediately


def test_drain_dead_decode_over_budget_aborts():
    import time as _time
    store = _FakeStore(parked_rids={"a"})
    router, _, _ = _fake_router(store, max_redispatch=0)
    req = Request("a", [1, 2, 3], max_new_tokens=4)
    router._submit_t["a"] = _time.monotonic()
    router.assigned[1]["a"] = req
    router._drain(1, now=100.0)
    assert router.aborted == 1
    assert len(router.decode_queue) == 0 and len(router.queue) == 0
    assert router.completions[0]["finish_reason"] == "aborted"


def test_drain_dead_prefill_requeues_to_prefill_tier():
    router, _, _ = _fake_router(_FakeStore())
    req = Request("a", [1, 2, 3], max_new_tokens=4)
    router.assigned[0]["a"] = req
    router._drain(0, now=100.0)
    assert len(router.queue) == 1 and len(router.decode_queue) == 0
    assert router.redispatched_total == 1


def test_requeue_prefill_bounded_like_a_redispatch():
    import time as _time
    router, _, _ = _fake_router(_FakeStore(), max_redispatch=1)
    req = Request("a", [1, 2, 3], max_new_tokens=4)
    router._submit_t["a"] = _time.monotonic()
    router._metas["a"] = {"page_size": 8}
    router._requeue_prefill(req, now=0.0, why="handoff_corrupt")
    assert len(router.queue) == 1 and req.restarts == 1
    assert "a" not in router._metas
    # budget: restarts may reach max_redispatch + 1, not beyond
    req2 = Request("b", [1], max_new_tokens=2, restarts=2)
    router._submit_t["b"] = _time.monotonic()
    router._requeue_prefill(req2, now=0.0, why="handoff_missing")
    assert router.aborted == 1
    assert router.completions[0]["rid"] == "b"


# ---------------------------------------------------------------------------
# threaded end-to-end: DisaggRouter over TierThreadReplicas
# ---------------------------------------------------------------------------

def test_disagg_router_thread_backend_end_to_end(oracle_f32):
    from deepspeed_tpu_torch.inference.fleet import TierThreadReplica

    store = DeviceHandoffStore()

    def prefill_factory():
        return PrefillWorker(_build(tier="prefill"), store)

    def decode_factory():
        return DecodeWorker(_build(tier="decode", max_batch=3), store)

    pre = TierThreadReplica(0, prefill_factory).start()
    dec = TierThreadReplica(1, decode_factory).start()
    router = DisaggRouter([pre], [dec], store, max_redispatch=2)
    result = router.run(requests=_requests(), timeout_s=120.0)
    assert result.ok
    assert {c["rid"]: c["tokens"]
            for c in result.completions} == oracle_f32
    assert result.handoffs == len(PROTOS)
    assert result.handoff_bytes > 0
    assert result.replicas_dead == 0
    assert result.ttft_s["p50"] is not None
    # per-tier stats ride the result, tagged with their tier, and the
    # fleet-wide census is exactly 2 programs
    by_tier = {s["tier"]: s for s in result.stats}
    assert by_tier["prefill"]["compile_counts"] == PREFILL_PIN
    assert by_tier["decode"]["compile_counts"] == DECODE_PIN
    comps = result.by_rid()
    assert all(c["tier"] == "decode" for c in comps.values())
    assert all(c.get("ttft_s") is not None for c in comps.values())


# ---------------------------------------------------------------------------
# satellites: config, rules, tune, metrics
# ---------------------------------------------------------------------------

def test_disagg_config_block_and_validation():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({"train_batch_size": 16, "inference": {
        "kv_layout": "paged", "disaggregated": True,
        "prefill_workers": 2, "decode_workers": 3,
        "prefill_max_batch": 4}})
    inf = cfg.inference
    assert inf.disaggregated is True
    assert (inf.prefill_workers, inf.decode_workers) == (2, 3)
    assert (inf.prefill_max_batch, inf.decode_max_batch) == (4, 0)
    # defaults: colocated
    inf0 = DeepSpeedConfig({"train_batch_size": 16}).inference
    assert inf0.disaggregated is False
    assert (inf0.prefill_workers, inf0.decode_workers) == (1, 1)

    def bad(block, match):
        with pytest.raises(ValueError, match=match):
            DeepSpeedConfig({"train_batch_size": 16,
                             "inference": block})

    bad({"disaggregated": True}, "paged")
    bad({"kv_layout": "paged", "disaggregated": True, "replicas": 2},
        "replicas")
    bad({"kv_layout": "paged", "disaggregated": True,
         "speculative": {"enabled": True}}, "speculative")
    bad({"disaggregated": 1}, "bool")
    bad({"prefill_workers": 0}, "prefill_workers")
    bad({"decode_max_batch": -1}, "decode_max_batch")


def test_gather_pages_device_is_a_copy():
    """The device snapshot is a fresh tensor, never a view of the pool:
    a later in-place pool write does not reach it."""
    eng = _build()
    leaf = eng.cache["h_0"]["k"]
    leaf[1].fill_(3.0)
    snap = eng.gather_pages_device([1])
    assert snap["h_0"]["k"].data_ptr() != leaf.data_ptr()
    leaf[1].fill_(-1.0)
    assert bool((snap["h_0"]["k"] == 3.0).all())
    # and it scatters back, device to device
    eng.scatter_pages([2], snap)
    assert bool((eng.cache["h_0"]["k"][2] == 3.0).all())


def test_process_tiers_serve_through_the_file_store(tmp_path):
    """``serve --disaggregate`` with process tiers on the CPU (the file
    store between two ``fleet_worker.py`` processes): the streams equal
    the colocated engine's at the same seed, and each tier holds one
    program."""
    import argparse
    import json
    import subprocess
    import sys

    from deepspeed_tpu_torch.inference import serve
    repo = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    argv = ["--device", "cpu", "--synthetic", "5", "--max-new", "4",
            "--kv-layout", "paged"]
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.serve",
         *argv, "--disaggregate", "--expect-compiles", "2", "--json",
         "--workdir", str(tmp_path)], cwd=repo, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tiers = json.loads(out.stdout)
    args = argparse.Namespace(requests=None, synthetic=5, seed=0,
                              shared_prefix=0, synthetic_max_prompt=24,
                              max_new=4, arrival_every=1.0,
                              deadline_s=None, queue_timeout_s=None)
    cfg = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
           "kv_layout": "paged", "sampling_seed": 0}
    engine = InferenceEngine(serve.seeded_tiny_model(0, "cpu"),
                             config=cfg, device="cpu")
    want = {c.rid: list(c.tokens) for c in
            ContinuousBatchingScheduler(engine).run(
                serve._build_requests(args, 256, engine.max_seq))}
    assert {c["rid"]: c["tokens"] for c in tiers["completions"]} == want
    dg = tiers["disagg"]
    assert dg["handoffs"] == 5 and dg["handoff_bytes"] > 0
    assert dg["total_compiles"] == 2
    assert sorted(s["tier"] for s in dg["stats"]) == ["decode", "prefill"]
