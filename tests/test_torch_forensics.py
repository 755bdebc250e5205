"""Runtime forensics: the port's flight recorder, hang watchdog, anomaly
detector and crash hooks (``deepspeed_tpu_torch/telemetry/flight.py``,
``watchdog.py``) against the JAX package's (``tests/unit/
test_forensics.py``).

- A dump the port writes is read by JAX's ``read_dump`` and rendered by
  JAX's ``postmortem``, as by the port's.
- Deadlines, firings, anomaly trips, heartbeat scans and straggler
  rankings equal JAX's for the same walls, clocks and heartbeat files.
- An injected hang inside the port engine's dispatch trips the watchdog
  (deadlines and hangs in tenths of a second) and dumps the in-flight
  ``dispatch/injected_hang``; SIGTERM dumps and then the engine's
  preemption checkpoint still happens; SIGQUIT dumps and the process
  goes on.
- ``action: "abort"`` and ``maybe_kill("step")`` end their process: they
  run in child processes with timeouts of their own.
"""

import contextlib
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry.session as jsession
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.telemetry import cli as jcli
from deepspeed_tpu.telemetry import flight as jflight
from deepspeed_tpu.telemetry import watchdog as jwd
import deepspeed_tpu_torch.telemetry.session as tsession
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.resilience import fault_injection as fi
from deepspeed_tpu_torch.runtime.resilience.preemption import (
    PreemptedError,
    PreemptionHandler,
)
from deepspeed_tpu_torch.telemetry import (
    FlightRecorder,
    HangWatchdog,
    JsonlExporter,
    StepAnomalyDetector,
    TelemetrySession,
    install_crash_hooks,
    uninstall_crash_hooks,
)
from deepspeed_tpu_torch.telemetry import cli as tcli
from deepspeed_tpu_torch.telemetry import watchdog as twd
from deepspeed_tpu_torch.telemetry.exporters import DURABLE_EVENTS
from deepspeed_tpu_torch.telemetry.flight import FLIGHT_SCHEMA, read_dump
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
MIN_DEADLINE_S = 0.2        # the engine's watchdog floor here
HANG_S = 0.8                # an injected hang: 4 floors


@pytest.fixture(autouse=True)
def _isolate_process_hooks():
    """Engines install process-global crash hooks and a default session;
    neither may leak across tests."""
    jsession._default_session = tsession._default_session = None
    fi.clear_faults()
    yield
    fi.clear_faults()
    uninstall_crash_hooks()
    jsession._default_session = tsession._default_session = None


def _engine(extra=None):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    engine, _, _, _ = initialize(model=model, config=dict(BASE, **(extra
                                                                   or {})),
                                 device="cpu")
    return engine


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (8, 16)).astype(np.int32)}


def _drain_signals(seconds=0.2):
    """Give a just-sent signal a bytecode boundary to be delivered on."""
    deadline = time.time() + seconds
    while time.time() < deadline:
        time.sleep(0.01)


def _render(cli, argv):
    """(exit code, stdout, stderr) of ``cli.main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_dump_roundtrips_through_both_readers(tmp_path):
    rec = FlightRecorder(tmp_path, history=4,
                         meta={"process_index": 3, "flavor": "dense"})
    for i in range(10):
        rec.export({"event": "step", "step": i})
    rec.record_phase("enter", "dispatch")
    rec.record_phase("exit", "dispatch", duration_s=0.01)
    rec.set_collective_source(lambda: [{"site": "ring", "axis": "data"}])
    path = rec.dump("unit_test")
    assert os.path.basename(path).startswith("flight-p00003-unit_test-")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    dump = read_dump(path)
    assert jflight.read_dump(path) == dump
    assert dump["schema"] == FLIGHT_SCHEMA == jflight.FLIGHT_SCHEMA
    assert dump["reason"] == "unit_test"
    assert dump["meta"]["flavor"] == "dense"
    assert [e["step"] for e in dump["events"]] == [6, 7, 8, 9]
    assert [p["kind"] for p in dump["phase_log"]] == ["enter", "exit"]
    assert dump["collectives"] == [{"site": "ring", "axis": "data"}]
    assert any(t["name"] == "MainThread" and t["stack"]
               for t in dump["threads"])
    # the same keys as a JAX dump of the same record
    jrec = jflight.FlightRecorder(tmp_path / "jax", history=4,
                                  meta={"process_index": 3})
    assert set(read_dump(jrec.dump("unit_test"))) == set(dump)


def test_read_dump_rejects_non_flight_json_as_jax(tmp_path):
    p = tmp_path / "not_a_dump.json"
    p.write_text(json.dumps({"schema": "ds-tpu-telemetry/1"}))
    with pytest.raises(ValueError) as got:
        read_dump(str(p))
    with pytest.raises(ValueError) as want:
        jflight.read_dump(str(p))
    assert str(got.value) == str(want.value)
    assert "not a flight-recorder dump" in str(got.value)


def test_dump_sees_in_flight_span_path_and_live_collectives(tmp_path):
    rec = FlightRecorder(tmp_path)
    session = TelemetrySession(flight=rec)
    rec.set_collective_source(lambda: [{"site": "comm0/all_reduce",
                                        "axis": "data",
                                        "primitive": "all_reduce",
                                        "calls": 2, "bytes": 64}])
    with session.span("dispatch"):
        with session.span("compile"):
            snap = rec.snapshot("probe")
    assert snap["in_flight_phases"]["MainThread"] == "dispatch/compile"
    assert snap["collectives"][0]["calls"] == 2
    assert "MainThread" not in rec.snapshot("probe")["in_flight_phases"]
    rec.set_collective_source(lambda: 1 / 0)    # contained, never raises
    assert rec.snapshot("probe")["collectives"][0]["site"] == "unavailable"


def test_unhandled_exception_dumps_flight(tmp_path, capsys):
    rec = FlightRecorder(tmp_path, meta={"process_index": 0})
    install_crash_hooks(rec, signals=())
    try:
        sys.excepthook(ValueError, ValueError("boom"), None)
    finally:
        uninstall_crash_hooks()
    dumps = sorted(tmp_path.glob("flight-*-exception-*.json"))
    dump = read_dump(str(dumps[0]))
    assert dump["exception"]["type"] == "ValueError"
    assert dump["exception"]["message"] == "boom"
    assert "boom" in capsys.readouterr().err


def test_sigquit_dumps_and_process_keeps_running(tmp_path):
    rec = FlightRecorder(tmp_path)
    install_crash_hooks(rec, signals=(signal.SIGQUIT,))
    try:
        os.kill(os.getpid(), signal.SIGQUIT)
        _drain_signals()
    finally:
        uninstall_crash_hooks()
    dumps = list(tmp_path.glob("flight-*-signal-SIGQUIT-*.json"))
    assert dumps and read_dump(str(dumps[0]))["reason"] == "signal:SIGQUIT"


def test_sigterm_dumps_then_chains_preemption_latch(tmp_path):
    handler = PreemptionHandler().install()
    rec = FlightRecorder(tmp_path).install(signals=(signal.SIGTERM,))
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        _drain_signals()
        assert list(tmp_path.glob("flight-*-signal-SIGTERM-*.json"))
        assert handler.preempted
    finally:
        rec.uninstall()
        handler.uninstall()
        handler.clear()


def test_sigterm_through_the_engine_dumps_and_still_checkpoints(tmp_path):
    """The engine installs the flight hooks after its preemption handler:
    a SIGTERM (the fault harness's, a real signal) dumps the flight
    record, then the latch saves the preemption checkpoint at the next step
    boundary and raises ``PreemptedError`` with its path; the log has
    the durable ``preemption`` event."""
    log, dumps, ckpt = tmp_path / "run.jsonl", tmp_path / "dumps", \
        tmp_path / "ckpt"
    engine = _engine({
        "telemetry": {"enabled": True, "jsonl_path": str(log),
                      "crash_dump_dir": str(dumps)},
        "resilience": {"save_dir": str(ckpt),
                       "preemption": {"save_on_sigterm": True},
                       "fault_injection": {"enabled": True}}})
    fi.simulate_preemption(2)
    try:
        with pytest.raises(PreemptedError) as err:
            for i in range(4):
                engine.train_batch(_batch(i))
    finally:
        engine._preemption.uninstall()
        engine.telemetry.close()
    assert engine.global_steps == 2
    assert os.path.isdir(err.value.checkpoint_path)
    assert err.value.checkpoint_path.endswith("global_step2")
    assert list(dumps.glob("flight-p00000-signal-SIGTERM-*.json"))
    pre = [e for e in tcli.read_events(str(log))
           if e["event"] == "preemption"]
    assert pre == [dict(pre[0], step=2, path=err.value.checkpoint_path)]
    assert "preemption" in DURABLE_EVENTS


# ---------------------------------------------------------------------------
# the hang watchdog and the anomaly detector, against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("walls,factor,floor", [
    ((0.02, 0.04), 3.0, 0.05), ((0.01, 0.01), 2.0, 10.0),
    ((0.3, 0.1, 0.2, 5.0, 0.25), 3.0, 0.2), ((0.01,), 3.0, 0.05)])
def test_watchdog_deadline_equals_jax(walls, factor, floor):
    got = twd.HangWatchdog(deadline_factor=factor, min_deadline_s=floor)
    want = jwd.HangWatchdog(deadline_factor=factor, min_deadline_s=floor)
    for i, w in enumerate(walls):
        for wd in (got, want):
            wd.step_end(i, w)
        assert got.median_wall() == want.median_wall()
        assert got.deadline_s() == want.deadline_s()
    assert got.deadline_s() is None if len(walls) < 2 else \
        got.deadline_s() == max(floor, factor * statistics.median(walls))


def test_watchdog_fires_once_per_step_as_jax(tmp_path):
    records = []
    for mod in (twd, jwd):
        t = [100.0]
        wd = mod.HangWatchdog(deadline_factor=2.0, min_deadline_s=0.01,
                              heartbeat_dir=str(tmp_path / mod.__name__),
                              hostname="host-a", clock=lambda: t[0])
        for i in range(4):
            wd.step_end(i, 0.01)
        wd.step_start(4)
        wd.beat("dispatch/device_wait")
        fired = wd.check(now=101.0)
        assert wd.check(now=102.0) is None      # the same step never again
        wd.step_end(4, 1.0)
        wd.step_start(5)
        again = wd.check(now=110.0)
        records.append((fired, again))
    assert records[0] == records[1]
    fired = records[0][0]
    assert (fired["step"], fired["phase"], fired["verdict"]) == \
        (4, "dispatch/device_wait", twd.VERDICT_THIS_HOST)
    assert fired["elapsed_s"] == pytest.approx(1.0)


def _heartbeat_dir(root, beats, now):
    os.makedirs(root, exist_ok=True)
    for pidx, step, host in beats:
        with open(twd.heartbeat_path(root, pidx), "w") as f:
            json.dump({"t": now, "process_index": pidx, "hostname": host,
                       "step": step, "phase": "dispatch"}, f)


@pytest.mark.parametrize("beats,count", [
    (((1, 5, "host-b"), (2, 3, "host-c"), (3, 6, "host-d")), 4),
    (((1, 5, "host-b"),), 3),        # p2 never wrote: blamed first
    (((1, 6, "host-b"),), 2)])       # everyone current: this host
def test_straggler_ranking_equals_jax(tmp_path, beats, count):
    verdicts = []
    for mod in (twd, jwd):
        root = str(tmp_path / mod.__name__)
        wd = mod.HangWatchdog(deadline_factor=2.0, min_deadline_s=0.01,
                              heartbeat_dir=root, process_index=0,
                              process_count=count, hostname="host-a")
        for i in range(4):
            wd.step_end(i, 0.01)
        wd.step_start(6)
        wd._write_heartbeat()
        _heartbeat_dir(root, beats, time.time())
        verdict, stragglers = wd.classify()
        verdicts.append((verdict, [
            {k: v for k, v in s.items() if k != "beat_age_s"}
            for s in stragglers]))
    assert verdicts[0] == verdicts[1]
    verdict, stragglers = verdicts[0]
    if count == 4:
        assert verdict == twd.VERDICT_STRAGGLER
        assert [s["process_index"] for s in stragglers] == [2, 1]
    elif count == 3:
        assert stragglers[0]["process_index"] == 2
        assert stragglers[0]["status"] == "no-heartbeat"
    else:
        assert verdict == twd.VERDICT_THIS_HOST and stragglers == []


def test_watchdog_rejects_unknown_action_as_jax():
    with pytest.raises(ValueError) as got:
        twd.HangWatchdog(action="page_oncall")
    with pytest.raises(ValueError) as want:
        jwd.HangWatchdog(action="page_oncall")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("walls", [
    [0.01] * 5 + [0.05] + [0.05] * 9,
    [0.2, 0.1, 0.1, 0.3, 0.1, 0.1, 0.25, 0.9, 0.1, float("inf"), 0.1]])
def test_anomaly_trips_equal_jax(walls):
    got = StepAnomalyDetector(factor=2.0, window=8, min_history=5)
    want = jwd.StepAnomalyDetector(factor=2.0, window=8, min_history=5)
    trips = [(got.observe(w), want.observe(w)) for w in walls]
    assert all(a == b for a, b in trips)
    assert any(a is not None for a, _ in trips)
    assert trips[-1][0] is None     # a plateau rebaselines


def test_watchdog_hot_hooks_under_one_percent_of_step_wall():
    engine = _engine({"telemetry": {"enabled": True}})
    for _ in range(4):
        engine.train_batch(_batch())
    median_wall = statistics.median(
        e["wall_s"] for e in engine.metrics_history)
    engine.telemetry.close()
    wd = HangWatchdog(min_deadline_s=60.0)
    n = 20000
    t0 = time.perf_counter()
    for i in range(n):
        wd.step_start(i)
        wd.beat("data_load")
        wd.beat("dispatch")
        wd.beat("dispatch/device_wait")
        wd.step_end(i, 0.001)
    per_step = (time.perf_counter() - t0) / n
    assert per_step < 0.01 * median_wall, (per_step, median_wall)


# ---------------------------------------------------------------------------
# the engine: an injected hang, a slow step
# ---------------------------------------------------------------------------

def test_injected_hang_trips_watchdog_and_both_postmortems_render(tmp_path):
    dump_dir = tmp_path / "forensics"
    log = tmp_path / "run.jsonl"
    engine = _engine({
        "telemetry": {"enabled": True, "jsonl_path": str(log),
                      "crash_dump_dir": str(dump_dir),
                      "watchdog": {"enabled": True, "deadline_factor": 2.0,
                                   "min_deadline_s": MIN_DEADLINE_S}},
        "resilience": {"fault_injection": {"enabled": True}}})
    try:
        for i in range(4):
            engine.train_batch(_batch(i))
        fi.inject_hang(at_step=4, seconds=HANG_S)
        engine.train_batch(_batch())
        wd = engine.telemetry.watchdog
        assert len(wd.fired) == 1
        fired = wd.fired[0]
        assert fired["step"] == 4
        assert fired["verdict"] == twd.VERDICT_THIS_HOST
        assert fired["elapsed_s"] < HANG_S
        assert fired["deadline_s"] == pytest.approx(MIN_DEADLINE_S)
        assert engine.telemetry.events.recent(event="watchdog")
        assert os.path.exists(twd.heartbeat_path(dump_dir, 0))
    finally:
        engine.telemetry.close()
        uninstall_crash_hooks()
    (dump_path,) = sorted(dump_dir.glob("flight-p00000-watchdog-*.json"))
    dump = jflight.read_dump(str(dump_path))
    assert dump["watchdog"]["step"] == 4
    assert dump["in_flight_phases"]["MainThread"] == "dispatch/injected_hang"
    assert any("injected_hang" in "\n".join(t["stack"])
               for t in dump["threads"])
    assert any(e.get("event") == "step" for e in dump["events"])
    assert [e["event"] for e in tcli.read_events(str(log))].count(
        "watchdog") == 1
    for cli in (tcli, jcli):
        rc, out, _ = _render(cli, ["postmortem", str(dump_path)])
        assert rc == 0
        for text in ("reason   watchdog", twd.VERDICT_THIS_HOST,
                     "dispatch/injected_hang", "thread MainThread",
                     "timeline tail"):
            assert text in out, (cli.__name__, text)


def test_slow_step_arms_trace_capture(tmp_path):
    dump_dir = tmp_path / "forensics"
    engine = _engine({
        "telemetry": {"enabled": True, "crash_dump_dir": str(dump_dir),
                      "anomaly_trace": {"enabled": True, "factor": 3.0,
                                        "capture_steps": 1}},
        "resilience": {"fault_injection": {"enabled": True}}})
    try:
        for i in range(6):
            engine.train_batch(_batch(i))
        fi.inject_hang(at_step=6, seconds=0.4)
        engine.train_batch(_batch())
        anomalies = engine.telemetry.events.recent(event="anomaly")
        assert len(anomalies) == 1
        assert "step wall" in anomalies[0]["reason"]
        assert anomalies[0]["trace_dir"] == str(dump_dir / "anomaly_traces")
        assert engine.trace_profiler.armed_reason == anomalies[0]["reason"]
        for i in range(2):
            engine.train_batch(_batch(i))
        found = [f for _, _, fs in os.walk(dump_dir / "anomaly_traces")
                 for f in fs]
        assert any("trace" in f for f in found), found
    finally:
        engine.telemetry.close()
        uninstall_crash_hooks()


def test_guard_abort_dumps_the_flight_record_first(tmp_path):
    from deepspeed_tpu_torch.runtime.resilience.guards import (
        HealthGuardAbort)
    dump_dir = tmp_path / "forensics"
    engine = _engine({
        "telemetry": {"enabled": True, "crash_dump_dir": str(dump_dir)},
        "resilience": {"fault_injection": {"enabled": True},
                       "guards": {"nan_grads": {"action": "abort"}}}})
    fi.inject_nan_grads([1])
    try:
        engine.train_batch(_batch())
        with pytest.raises(HealthGuardAbort):
            engine.train_batch(_batch())
    finally:
        engine.telemetry.close()
    (path,) = dump_dir.glob("flight-*-guard_abort-nan_grads-*.json")
    assert read_dump(str(path))["guard_trip"]["guard"] == "nan_grads"


def test_dump_collectives_are_what_the_step_issued(tmp_path):
    """The engine's collective source: the data group's and the mesh's
    counted collectives since the step began (the calls the collectives
    record, made here by hand: a world-1 group issues none), each as its
    kind, calls and bytes; both postmortems render them."""
    from deepspeed_tpu_torch.parallel import collectives as tp_comm
    dump_dir = tmp_path / "forensics"
    engine = _engine({"telemetry": {"enabled": True,
                                    "crash_dump_dir": str(dump_dir)}})
    try:
        engine.comm._record("all_reduce", 4096)      # before the step
        engine._coll_base = engine._collective_counts()
        for _ in range(2):
            engine.comm._record("all_reduce", 1024)
        engine.comm._record("all_gather", 512)
        tp_comm._count("ppermute", torch.zeros(8, dtype=torch.bfloat16))
        path = engine._dump_flight("probe")
    finally:
        engine.telemetry.close()
        tp_comm.reset_collective_counts()
    rows = {r["site"]: r for r in read_dump(path)["collectives"]}
    assert rows["comm0/all_reduce"] == {
        "site": "comm0/all_reduce", "axis": "data",
        "primitive": "all_reduce", "calls": 2, "bytes": 2048}
    assert (rows["comm0/all_gather"]["calls"],
            rows["comm0/all_gather"]["bytes"]) == (1, 512)
    assert (rows["mesh/ppermute"]["calls"],
            rows["mesh/ppermute"]["bytes"]) == (1, 16)
    for cli in (tcli, jcli):
        rc, out, _ = _render(cli, ["postmortem", path])
        assert rc == 0 and "comm0/all_reduce" in out
    assert "calls=2 bytes=2048" in _render(tcli, ["postmortem", path])[1]


def test_engine_step_events_carry_process_identity(tmp_path):
    log = tmp_path / "log.jsonl"
    engine = _engine({"telemetry": {"enabled": True,
                                    "jsonl_path": str(log)}})
    engine.train_batch(_batch())
    engine.telemetry.close()
    by_type = {e["event"]: e for e in tcli.read_events(str(log))}
    for name in ("run_start", "step"):
        assert by_type[name]["process_index"] == 0
        assert by_type[name]["hostname"]
    assert by_type["run_start"]["process_count"] == 1


def test_jsonl_exporter_is_readable_before_close(tmp_path):
    path = tmp_path / "log.jsonl"
    ex = JsonlExporter(str(path))
    ex.export({"event": "run_start", "t": 1.0})
    ex.export({"event": "step", "t": 2.0, "step": 0})
    ex.export({"event": "health_guard", "t": 3.0, "guard": "nan_grads"})
    assert [e["event"] for e in tcli.read_events(str(path))] == [
        "run_start", "step", "health_guard"]
    ex.close()
    assert {"run_start", "health_guard", "recompile", "preemption",
            "watchdog", "anomaly"} <= DURABLE_EVENTS


# ---------------------------------------------------------------------------
# config validation, heartbeat scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [
    {"enabled": True, "watchdog": {"enabled": True}},
    {"enabled": True, "watchdog": {"enabled": False, "deadline": 3}},
    {"enabled": True, "anomaly_trace": {"factor": -1}},
    {"enabled": True, "crash_dump_dir": "d",
     "watchdog": {"enabled": True, "action": "page_oncall"}}])
def test_forensics_config_errors_are_jax(block):
    cfg = dict(BASE, telemetry=block)
    with pytest.raises(ValueError) as want:
        JaxConfig(cfg, world_size=1)
    with pytest.raises(ValueError) as got:
        DeepSpeedConfig(cfg)
    assert str(got.value) == str(want.value)


def test_scan_heartbeats_equals_jax(tmp_path):
    now = time.time()
    with open(twd.heartbeat_path(tmp_path, 0), "w") as f:
        json.dump({"t": now, "process_index": 0, "step": 5}, f)
    with open(twd.heartbeat_path(tmp_path, 1), "w") as f:
        f.write('{"t": 123.4, "process_ind')      # killed mid-json.dump
    got = twd.scan_heartbeats(str(tmp_path), expected_count=3)
    assert got == jwd.scan_heartbeats(str(tmp_path), expected_count=3)
    heartbeats, silent = got
    assert [hb["process_index"] for hb in heartbeats] == [0]
    assert sorted((g["process_index"], g["reason"]) for g in silent) == \
        [(1, "unparseable"), (2, "missing")]
    missing = twd.scan_heartbeats(str(tmp_path / "nope"), expected_count=2)
    assert missing == jwd.scan_heartbeats(str(tmp_path / "nope"),
                                          expected_count=2)
    assert [g["reason"] for g in missing[1]] == ["missing", "missing"]


def test_torn_heartbeat_gets_one_bounded_reread(tmp_path, monkeypatch):
    path = twd.heartbeat_path(tmp_path, 0)
    with open(path, "w") as f:
        f.write('{"t": 123.4, "process_ind')
    sleeps = []

    def repair(seconds):
        sleeps.append(seconds)
        with open(path, "w") as f:
            json.dump({"t": 123.4, "process_index": 0, "step": 7}, f)

    monkeypatch.setattr(twd, "_retry_sleep", repair)
    heartbeats, silent = twd.scan_heartbeats(str(tmp_path),
                                             expected_count=1)
    assert sleeps == [twd._TORN_RETRY_SLEEP_S]
    assert [hb["step"] for hb in heartbeats] == [7] and silent == []
    with open(path, "w") as f:
        f.write('{"t": 123.4, "process_ind')
    sleeps.clear()
    monkeypatch.setattr(twd, "_retry_sleep", sleeps.append)
    heartbeats, silent = twd.scan_heartbeats(str(tmp_path),
                                             expected_count=1)
    assert len(sleeps) == 1 and heartbeats == []
    assert [(g["process_index"], g["reason"]) for g in silent] == \
        [(0, "unparseable")]


# ---------------------------------------------------------------------------
# the ends of a process: abort and maybe_kill("step"), in children
# ---------------------------------------------------------------------------

CHILD = """
import json, resource, sys
import numpy as np, torch
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.runtime.resilience import fault_injection as fi
resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
mode, root = sys.argv[1], sys.argv[2]
tele = {"enabled": True, "jsonl_path": root + "/run.jsonl",
        "crash_dump_dir": root}
if mode == "abort":
    tele["watchdog"] = {"enabled": True, "min_deadline_s": %(floor)r,
                        "action": "abort"}
engine, _, _, _ = initialize(
    model=GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu"),
    device="cpu", config={
        "train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "telemetry": tele,
        "resilience": {"fault_injection": {"enabled": True}}})
batch = {"input_ids": np.random.default_rng(0).integers(
    0, 256, (8, 16)).astype(np.int32)}
if mode == "abort":
    fi.inject_hang(at_step=3, seconds=%(hang)r)
else:
    fi.inject_kill("step", at_step=2)
for _ in range(5):
    engine.train_batch(batch)
print("survived")
""" % {"floor": MIN_DEADLINE_S, "hang": 10 * HANG_S}


@pytest.mark.parametrize("mode,signum", [("abort", signal.SIGABRT),
                                         ("kill", signal.SIGKILL)])
def test_abort_and_step_kill_end_the_child(tmp_path, mode, signum):
    """``watchdog.action: abort``: the child dumps, prints its stacks and
    dies by SIGABRT within the hang; ``inject_kill("step", at_step=2)``:
    the child dies by SIGKILL inside step 2's dispatch, after two whole
    step events (every line of its log parseable)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", CHILD, mode,
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == -signum, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    events = [json.loads(line) for line in open(tmp_path / "run.jsonl")]
    steps = [e["step"] for e in events if e["event"] == "step"]
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("flight-")]
    if mode == "abort":
        assert steps == [1, 2, 3]
        assert [e["event"] for e in events].count("watchdog") == 1
        assert len(dumps) == 1 and "watchdog" in dumps[0]
        assert "in train_batch" in proc.stderr     # the stacks printed
    else:
        assert steps == [1, 2] and dumps == []     # SIGKILL: no hook runs
