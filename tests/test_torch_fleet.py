"""The port's serving fleet (``deepspeed_tpu_torch/inference/router.py``,
``fleet.py``, ``fleet_worker.py``, and the scheduler's robustness
knobs), mirroring ``tests/unit/test_fleet.py`` on the CPU.

- The JAX file's cases, on its model-free ``StubEngine`` behind
  :class:`ThreadReplica` or scripted replica fakes: scheduler deadlines
  and ``max_steps`` exhaustion, the wire format, the router's
  exactly-once bookkeeping, redispatch and abort budgets, shed and
  defer, and thread kill / preempt / hang / crash classification.
- Parity: a fleet of port thread replicas whose engines hold params
  converted from the JAX init (``convert_gpt2_params``) returns, for
  every request, the JAX thread fleet's greedy stream bit for bit, with
  and without a replica killed mid-flight.
- One process fleet (``fleet_worker.py`` on the CPU, ``device`` "cpu"):
  a worker SIGKILLed mid-decode; its requests are redispatched and every
  stream equals the port's one-engine stream at the same seed.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import fleet as jfleet
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.router import FleetRouter as JaxRouter
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.fleet import (
    ThreadReplica,
    build_process_fleet,
    completion_dict,
    request_dict,
)
from deepspeed_tpu_torch.inference.router import (
    FleetRouter,
    RequestAbortedError,
)
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)
from deepspeed_tpu_torch.runtime.supervisor.state import (
    CAUSE_CRASH,
    CAUSE_HANG,
    CAUSE_PREEMPTION,
)
from deepspeed_tpu_torch.telemetry.session import TelemetrySession
from tests.unit.test_inference_engine import StubEngine


# ---------------------------------------------------------------------------
# scheduler robustness: deadlines, queue timeouts, max_steps exhaustion
# ---------------------------------------------------------------------------

class _SlowEngine(StubEngine):
    """Stub whose decode burns wall clock, so deadlines expire
    mid-generation without the test sleeping."""

    def __init__(self, decode_sleep_s, **kw):
        super().__init__(**kw)
        self.decode_sleep_s = decode_sleep_s

    def decode(self, tokens, positions):
        time.sleep(self.decode_sleep_s)
        return super().decode(tokens, positions)


class TestSchedulerRobustness:
    def test_queue_timeout_finishes_without_a_row(self):
        session = TelemetrySession()
        eng = StubEngine(max_batch=1, session=session)
        sched = ContinuousBatchingScheduler(eng)
        sched.submit(Request("hog", [1, 2], max_new_tokens=6))
        sched.submit(Request("late", [3], max_new_tokens=4,
                             queue_timeout_s=0.0))
        comps = {c.rid: c for c in sched.run()}
        assert comps["hog"].finish_reason == "max_new_tokens"
        late = comps["late"]
        assert late.finish_reason == "timeout"
        assert late.slot == -1 and late.tokens == []
        evts = session.events.recent(event="request_timeout")
        assert evts and evts[0]["where"] == "queue"

    def test_deadline_expires_mid_decode_keeps_partial_tokens(self):
        session = TelemetrySession()
        eng = _SlowEngine(0.05, max_batch=1, session=session)
        sched = ContinuousBatchingScheduler(eng)
        comps = sched.run([Request("d", [1, 2], max_new_tokens=50,
                                   deadline_s=0.001)])
        assert comps[0].finish_reason == "timeout"
        assert comps[0].slot == 0           # it held a row
        assert comps[0].tokens              # partial generation kept
        evts = session.events.recent(event="request_timeout")
        assert evts and evts[-1]["where"] == "decode"

    def test_max_steps_exhaustion_is_typed_incomplete(self):
        session = TelemetrySession()
        eng = StubEngine(max_batch=1, session=session)
        sched = ContinuousBatchingScheduler(eng)
        comps = sched.run([Request("live", [1, 2], max_new_tokens=50),
                           Request("queued", [3], max_new_tokens=50)],
                          max_steps=3)
        by = {c.rid: c for c in comps}
        assert by["live"].finish_reason == "incomplete"
        assert by["live"].tokens            # generated-so-far kept
        assert by["queued"].finish_reason == "incomplete"
        assert by["queued"].slot == -1 and by["queued"].tokens == []
        evts = session.events.recent(event="scheduler_incomplete")
        assert len(evts) == 1
        assert evts[0]["level"] == "warning"
        assert evts[0]["live_rows"] == 1 and evts[0]["queued"] == 1


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

class TestWireFormat:
    def test_request_dict_excludes_submit_t(self):
        r = Request("a", [1, 2], max_new_tokens=3, deadline_s=1.0,
                    redispatched=2, restarts=2)
        r.submit_t = 123.0
        d = request_dict(r)
        assert "submit_t" not in d
        assert d["rid"] == "a" and d["redispatched"] == 2
        assert d["deadline_s"] == 1.0

    def test_completion_dict_round_trips_scheduler_output(self):
        comps = ContinuousBatchingScheduler(StubEngine()).run(
            [Request("a", [1, 2], max_new_tokens=2)])
        d = completion_dict(comps[0])
        assert d["rid"] == "a"
        assert d["finish_reason"] == "max_new_tokens"
        assert d["redispatched"] == 0 and d["restarts"] == 0


# ---------------------------------------------------------------------------
# scripted replicas: deterministic router bookkeeping
# ---------------------------------------------------------------------------

class _InstantReplica:
    """Completes everything on the next poll."""

    def __init__(self, index):
        self.index = index
        self._pending = []
        self.stopped = False

    def submit(self, req):
        self._pending.append(req)

    def poll(self):
        out = [dict(completion_dict_for(req), slot=0)
               for req in self._pending]
        self._pending = []
        return out

    def check(self, now=None):
        return None

    def stop(self, timeout=None):
        self.stopped = True
        return {"compile_counts": {"prefill": 1, "decode": 1},
                "steps": 1, "completed": 1}

    def kill(self):
        pass

    def reap(self):
        pass


def completion_dict_for(req, reason="max_new_tokens"):
    return {"rid": req.rid, "prompt_len": len(req.prompt),
            "tokens": [7] * req.max_new_tokens, "finish_reason": reason,
            "bucket": 16, "slot": 0, "steps": req.max_new_tokens,
            "prefix_hit": False, "resumed": False, "prefill_chunks": 0,
            "prefill_chunks_skipped": 0,
            "redispatched": req.redispatched, "restarts": req.restarts}


class _HoldingReplica(_InstantReplica):
    """Accepts work, never completes it; optionally dies (with
    ``cause``) on the first health check after receiving work."""

    def __init__(self, index, die_with=None):
        super().__init__(index)
        self.die_with = die_with

    def poll(self):
        return []

    def check(self, now=None):
        if self.die_with is not None and self._pending:
            return self.die_with
        return None


def _reqs(n, **kw):
    return [Request(f"r{i}", [1, 2, 3], max_new_tokens=2, **kw)
            for i in range(n)]


class TestRouterBookkeeping:
    def test_happy_path_exactly_once(self):
        session = TelemetrySession()
        router = FleetRouter([_InstantReplica(0), _InstantReplica(1)],
                             session=session)
        fr = router.run(_reqs(5), timeout_s=10.0)
        assert fr.ok and len(fr.completions) == 5
        assert len({c["rid"] for c in fr.completions}) == 5
        assert fr.replicas_dead == 0 and fr.redispatched_total == 0
        assert len(fr.stats) == 2
        assert fr.latency_s["p99"] is not None
        done = session.events.recent(event="fleet_done")
        assert done and done[-1]["ok"]

    def test_death_drains_and_redispatches(self):
        session = TelemetrySession()
        router = FleetRouter(
            [_HoldingReplica(0, die_with=CAUSE_CRASH),
             _InstantReplica(1)],
            session=session, backoff_base_s=0.0)
        fr = router.run(_reqs(4), timeout_s=10.0)
        assert fr.ok and len(fr.completions) == 4
        assert fr.replicas_dead == 1
        assert router.dead == {0: CAUSE_CRASH}
        # replica 0 held half the fleet's requests; every one finished
        # elsewhere with the retry stamped on the completion
        redone = [c for c in fr.completions if c["redispatched"]]
        assert len(redone) == 2 == fr.redispatched_total
        assert all(c["restarts"] == 1 and c["replica"] == 1
                   for c in redone)
        assert session.events.recent(event="replica_dead")
        assert len(session.events.recent(event="fleet_redispatch")) == 2
        rec = session.events.recent(event="replica_recovered")
        assert rec and rec[-1]["time_to_recover_s"] >= 0.0

    def test_redispatch_budget_becomes_typed_abort(self):
        session = TelemetrySession()
        router = FleetRouter(
            [_HoldingReplica(0, die_with=CAUSE_CRASH),
             _HoldingReplica(1, die_with=CAUSE_CRASH)],
            session=session, max_redispatch=1, backoff_base_s=0.0)
        fr = router.run(_reqs(1), timeout_s=10.0)
        assert not fr.ok
        assert fr.completions[0]["finish_reason"] == "aborted"
        assert fr.aborted == 1 and fr.replicas_dead == 2
        evts = session.events.recent(event="request_aborted")
        assert evts and evts[0]["rid"] == "r0"

    def test_raise_on_abort(self):
        router = FleetRouter(
            [_HoldingReplica(0, die_with=CAUSE_CRASH)],
            max_redispatch=0, raise_on_abort=True, backoff_base_s=0.0)
        with pytest.raises(RequestAbortedError) as exc:
            router.run(_reqs(1), timeout_s=10.0)
        assert exc.value.rid == "r0"

    def test_shed_at_max_pending(self):
        session = TelemetrySession()
        router = FleetRouter([_InstantReplica(0)], session=session,
                             max_pending=1)
        reqs = _reqs(3)
        assert router.submit(reqs[0]) is True
        assert router.submit(reqs[1]) is False      # shed
        fr = router.run([reqs[2]], timeout_s=10.0)  # shed too
        assert fr.shed == 2
        shed = [c for c in fr.completions
                if c["finish_reason"] == "shed"]
        assert {c["rid"] for c in shed} == {"r1", "r2"}
        assert session.events.recent(event="fleet_shed")

    def test_duplicate_rid_rejected(self):
        router = FleetRouter([_InstantReplica(0)])
        router.submit(Request("a", [1], max_new_tokens=1))
        with pytest.raises(ValueError, match="duplicate rid"):
            router.submit(Request("a", [1], max_new_tokens=1))

    def test_defer_and_router_queue_timeout(self):
        session = TelemetrySession()
        router = FleetRouter([_HoldingReplica(0)], session=session,
                             max_queue_depth=1)
        reqs = _reqs(2, queue_timeout_s=0.05)
        fr = router.run(reqs, timeout_s=0.4)
        by = fr.by_rid()
        # r0 took the only queue-depth slot and was held forever
        # (fleet-level wall timeout truncates it); r1 could never
        # dispatch and timed out on the router's own queue.
        assert by["r1"]["finish_reason"] == "timeout"
        assert by["r0"]["finish_reason"] == "incomplete"
        assert fr.timeouts == 1 and fr.defers >= 1
        assert session.events.recent(event="fleet_defer")
        assert session.events.recent(event="request_timeout")
        assert session.events.recent(event="scheduler_incomplete")

    def test_duplicate_replica_report_dropped(self):
        class _DupReplica(_InstantReplica):
            def poll(self):
                out = super().poll()
                return out + [dict(c) for c in out]   # report twice

        router = FleetRouter([_DupReplica(0)])
        fr = router.run(_reqs(2), timeout_s=10.0)
        assert len(fr.completions) == 2
        assert len({c["rid"] for c in fr.completions}) == 2


# ---------------------------------------------------------------------------
# thread replicas: kill / preempt / hang / crash semantics
# ---------------------------------------------------------------------------

def _stub_factory(**kw):
    def factory():
        return StubEngine(**kw)
    return factory


class TestThreadReplica:
    def test_serves_and_reports_stats(self):
        rep = ThreadReplica(0, _stub_factory(max_batch=2)).start()
        rep.submit(Request("a", [1, 2], max_new_tokens=2))
        deadline = time.monotonic() + 5.0
        out = []
        while not out and time.monotonic() < deadline:
            out = rep.poll()
            time.sleep(0.001)
        assert out and out[0]["rid"] == "a"
        assert rep.check() is None
        stats = rep.stop()
        assert stats["completed"] == 1 and stats["steps"] >= 1

    def test_crash_classification(self):
        def exploding():
            eng = StubEngine()

            def boom(tokens, positions):
                raise RuntimeError("injected decode fault")
            eng.decode = boom
            return eng

        rep = ThreadReplica(0, exploding).start()
        rep.submit(Request("a", [1, 2], max_new_tokens=4))
        deadline = time.monotonic() + 5.0
        while rep.check() is None and time.monotonic() < deadline:
            time.sleep(0.001)
        assert rep.check() == CAUSE_CRASH

    def test_kill_classification(self):
        rep = ThreadReplica(0, _stub_factory()).start()
        rep.kill()
        deadline = time.monotonic() + 5.0
        while rep.check() is None and time.monotonic() < deadline:
            time.sleep(0.001)
        assert rep.check() == CAUSE_CRASH

    def test_preempt_classification(self):
        rep = ThreadReplica(0, _stub_factory()).start()
        rep.preempt()
        deadline = time.monotonic() + 5.0
        while rep.check() is None and time.monotonic() < deadline:
            time.sleep(0.001)
        assert rep.check() == CAUSE_PREEMPTION

    def test_hang_detection(self):
        gate = threading.Event()

        def gated():
            eng = StubEngine()
            real = eng.decode

            def stuck(tokens, positions):
                gate.wait(timeout=30.0)
                return real(tokens, positions)
            eng.decode = stuck
            return eng

        rep = ThreadReplica(0, gated, step_timeout_s=0.05).start()
        rep.submit(Request("a", [1, 2], max_new_tokens=2))
        try:
            deadline = time.monotonic() + 5.0
            cause = None
            while cause is None and time.monotonic() < deadline:
                cause = rep.check()
                time.sleep(0.005)
            assert cause == CAUSE_HANG
        finally:
            gate.set()          # release the daemon thread

    def test_fleet_of_thread_replicas_survives_a_kill(self):
        session = TelemetrySession()
        reps = [ThreadReplica(i, _stub_factory(max_batch=2)).start()
                for i in range(2)]
        router = FleetRouter(reps, session=session, backoff_base_s=0.0,
                             max_queue_depth=2)
        # kill replica 0 shortly after dispatch starts
        killer = threading.Timer(0.05, reps[0].kill)
        killer.start()
        try:
            fr = router.run(_reqs(6), timeout_s=30.0)
        finally:
            killer.cancel()
        assert len(fr.completions) == 6
        assert all(c["finish_reason"] == "max_new_tokens"
                   for c in fr.completions)
        assert fr.ok
        # token streams are deterministic: every request decoded the
        # same StubEngine sequence regardless of which replica ran it
        tokens = {tuple(c["tokens"]) for c in fr.completions}
        assert len(tokens) == 1
        if fr.replicas_dead:
            assert router.dead.get(0) == CAUSE_CRASH
            assert fr.redispatched_total >= 1


# ---------------------------------------------------------------------------
# parity with the JAX fleet, and the process fleet
# ---------------------------------------------------------------------------

CONFIG = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
          "attention_impl": "flash", "attention_block_k": 8}
PROMPT_LENS = (3, 9, 14, 20, 6, 11)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _stream(cls, max_new=6):
    rng = np.random.default_rng(3)
    return [cls(f"r{i}", rng.integers(0, 256, n).tolist(),
                max_new_tokens=max_new)
            for i, n in enumerate(PROMPT_LENS)]


def _port_factory(params):
    state = convert_gpt2_params(jax.tree_util.tree_map(np.asarray, params))

    def factory():
        model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
        return InferenceEngine(model, state, config=CONFIG, device="cpu")
    return factory


def _tokens(fr):
    return {c["rid"]: list(c["tokens"]) for c in fr.completions}


@pytest.fixture(scope="module")
def jax_fleet_stream(jax_params):
    model, params = jax_params
    reps = [jfleet.ThreadReplica(
        i, lambda: JaxEngine(model, params, config=CONFIG)).start()
        for i in range(2)]
    fr = JaxRouter(reps, backoff_base_s=0.0).run(_stream(JaxRequest),
                                                 timeout_s=120.0)
    assert fr.ok
    return _tokens(fr)


def test_thread_fleet_streams_equal_the_jax_fleet(jax_params,
                                                  jax_fleet_stream):
    reps = [ThreadReplica(i, _port_factory(jax_params[1])).start()
            for i in range(2)]
    fr = FleetRouter(reps, backoff_base_s=0.0).run(_stream(Request),
                                                   timeout_s=120.0)
    assert fr.ok and fr.replicas_dead == 0
    assert _tokens(fr) == jax_fleet_stream
    assert {c["replica"] for c in fr.completions} == {0, 1}
    for st in fr.stats:
        assert st["compile_counts"] == {"prefill": 1, "decode": 1}


def test_thread_fleet_with_a_killed_replica_keeps_the_jax_streams(
        jax_params, jax_fleet_stream):
    factory = _port_factory(jax_params[1])
    started = threading.Event()

    def slow_factory():
        engine = factory()
        real = engine.decode

        def decode(*a, **kw):
            started.set()
            time.sleep(0.01)
            return real(*a, **kw)
        engine.decode = decode
        return engine

    reps = [ThreadReplica(0, slow_factory).start(),
            ThreadReplica(1, factory).start()]

    def kill_when_busy():
        started.wait(30.0)
        reps[0].kill()

    killer = threading.Thread(target=kill_when_busy, daemon=True)
    killer.start()
    fr = FleetRouter(reps, backoff_base_s=0.0).run(_stream(Request),
                                                   timeout_s=120.0)
    killer.join(30.0)
    assert fr.ok and fr.replicas_dead == 1 and fr.redispatched_total >= 1
    assert _tokens(fr) == jax_fleet_stream


def test_process_fleet_survives_a_sigkill(tmp_path):
    """Two ``fleet_worker.py`` processes on the CPU; replica 0 SIGKILLs
    itself at decode step 2. Every request completes, the dead one's
    are redispatched, and each stream equals the port's one-engine
    stream at the same seed (the serve CLI's seeded model)."""
    from deepspeed_tpu_torch.inference.serve import seeded_tiny_model
    seed = 5
    spec = {"inf_cfg": {"max_batch": 2, "seq_buckets": [16, 32],
                        "prefill_chunk": 4, "attention_impl": "flash",
                        "attention_block_k": 8},
            "seed": seed, "device": "cpu"}
    reps = build_process_fleet(
        2, spec, str(tmp_path), inject={"kill": {"op": "decode_step",
                                                 "at_step": 2}})
    try:
        fr = FleetRouter(reps, backoff_base_s=0.0).run(
            _stream(Request), timeout_s=120.0)
    finally:
        for r in reps:
            if r.proc.poll() is None:
                r.kill()
            r.reap()
    assert fr.ok and fr.replicas_dead == 1
    assert fr.redispatched_total >= 1
    engine = InferenceEngine(seeded_tiny_model(seed, "cpu"),
                             config=dict(spec["inf_cfg"]), device="cpu")
    want = {c.rid: list(c.tokens) for c in
            ContinuousBatchingScheduler(engine).run(_stream(Request))}
    assert _tokens(fr) == want
    (stats,) = fr.stats
    assert stats["compile_counts"] == {"prefill": 1, "decode": 1}
    # CPU workers run the plain versions: no kernel launched
    assert stats["launches"] == {"flash_decode": 0,
                                 "flash_decode_paged": 0}


def test_module_surface_is_jax_free():
    import deepspeed_tpu_torch.inference.fleet as fleet
    import deepspeed_tpu_torch.inference.router as router
    for mod in (fleet, router):
        assert "jax" not in getattr(mod, "__dict__", {})
