"""Telemetry on the training step: the port (``deepspeed_tpu_torch/
telemetry/``, the engines' spans and events) against the JAX package
(``deepspeed_tpu/telemetry/``, ``tests/unit/test_telemetry.py`` and
``test_profiler.py``).

- The registry, the event envelope, the exporters and the config block
  are held to JAX's on the same operations: the Prometheus text byte for
  byte, the JSONL keys, the defaults and the error texts.
- The same tiny GPT-2 (f32, flash, params from JAX) through both engines
  with telemetry on gives the same sequence of events with the same
  keys, apart from :data:`JAX_ONLY_KEYS` (facts read off the compiled
  step's HLO), and step losses within the GPT-2 parity rtol 1e-4 of
  ``test_torch_train_engine.py``. One JAX run, in a module fixture.
- All seven step flavors emit step events at world 1; the disabled path
  is inert; the trace window writes a Chrome trace whose ranges are the
  spans; ``compilation_cache_dir`` misses in one child process and hits
  in a second; TensorBoard writes scalars, or warns and disables.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu.telemetry.session as jsession
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn as jax_loss_fn
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
import deepspeed_tpu_torch.telemetry as ttel
import deepspeed_tpu_torch.telemetry.session as tsession
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)
from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 32
STEPS = 3
LOSS_RTOL = 1e-4            # test_torch_train_engine.py's f32 curve rtol
BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
# the JAX compile event's facts read off the compiled step's HLO: an
# eager step has no counterpart (runtime/engine.py:_stamp_compile_facts)
JAX_ONLY_KEYS = {"compile": {"collective_bytes", "collective_bytes_by_dtype",
                             "while_loops", "static_peak_bytes",
                             "static_temp_peak_bytes"}}


@pytest.fixture(autouse=True)
def _reset_default_sessions():
    """An engine installs itself as the process default (first wins):
    isolate the tests from each other's winners."""
    jsession._default_session = tsession._default_session = None
    yield
    jsession._default_session = tsession._default_session = None


def _read(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (8, T)).astype(np.int32)}
            for _ in range(n)]


def _port_gpt2(dtype=torch.float32, params=None):
    model = GPT2LMHead(gpt2_tiny(dtype=dtype, use_flash_attention=True),
                       device="cpu")
    if params is not None:
        model.load_state_dict(convert_gpt2_params(
            jax.tree_util.tree_map(np.asarray, params)))
    return model


def _port_engine(extra=None, dtype=torch.float32, params=None, **kw):
    engine, _, _, _ = initialize(model=_port_gpt2(dtype, params),
                                 config=dict(BASE, **(extra or {})),
                                 device="cpu", **kw)
    return engine


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _registry_ops(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("steps_total", help="steps done")
    c.inc()
    c.inc(3)
    g = reg.gauge("loss", help="last loss")
    g.set(2.5)
    g.inc(0.5)
    g.dec(1.0)
    for name, labels in (("events_total", {"event": "step"}),
                         ("events_total", {"event": "compile"}),
                         ("events_total", {"event": 'q"uo\\te\n'})):
        reg.counter(name, labels=labels, help="by type").inc(2)
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    ph = reg.histogram("phase_seconds", labels={"phase": "dispatch"},
                       help="host wall seconds per step phase")
    for v in (0.0004, 0.003, 0.2, 400.0):
        ph.observe(v)
    return reg, c, g, h


def test_registry_operations_equal_jax():
    """Counters, gauges and histograms hold the same values, buckets and
    snapshot as JAX's after the same operations; a negative increment
    raises in both."""
    (treg, tc, tg, th), (jreg, jc, jg, jh) = \
        _registry_ops(ttel), _registry_ops(jtel)
    assert (tc.value, tg.value) == (jc.value, jg.value) == (4.0, 2.0)
    assert th.cumulative_buckets() == jh.cumulative_buckets()
    assert th.cumulative_buckets()[-1] == (float("inf"), 3)
    assert (th.count, th.sum, th.min, th.max) == \
        (jh.count, jh.sum, jh.min, jh.max)
    assert treg.snapshot() == jreg.snapshot()
    for c in (tc, jc):
        with pytest.raises(ValueError, match="must be >= 0"):
            c.inc(-1)


def test_registry_labels_and_kind_conflict_as_jax():
    for pkg in (ttel, jtel):
        reg = pkg.MetricsRegistry()
        a = reg.counter("events", labels={"event": "step"})
        assert reg.counter("events", labels={"event": "step"}) is a
        with pytest.raises(ValueError) as err:
            reg.gauge("events")
        assert str(err.value) == ("metric 'events' already registered as "
                                  "counter, requested gauge")


def test_prometheus_text_is_byte_equal_to_jax():
    text = _registry_ops(ttel)[0].to_prometheus()
    assert text == _registry_ops(jtel)[0].to_prometheus()
    assert 'ds_tpu_lat_bucket{le="+Inf"} 3' in text
    assert "# HELP ds_tpu_steps_total steps done" in text


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_nesting_paths_and_accumulation():
    session = ttel.TelemetrySession()
    with session.span("dispatch") as outer:
        with session.span("compile") as inner:
            time.sleep(0.002)
    with session.span("dispatch"):
        pass
    assert (outer.path, inner.path) == ("dispatch", "dispatch/compile")
    phases = session.drain_phases()
    assert set(phases) == {"dispatch", "compile"}
    assert phases["dispatch"] >= phases["compile"] > 0
    assert session.drain_phases() == {}
    series = session.registry.snapshot()["phase_seconds"]["series"]
    assert {s["labels"]["phase"] for s in series} == {"dispatch", "compile"}


def test_span_exception_safety():
    session = ttel.TelemetrySession()
    with pytest.raises(RuntimeError):
        with session.span("outer"):
            with session.span("inner"):
                raise RuntimeError("boom")
    assert set(session.drain_phases()) == {"outer", "inner"}
    with session.span("after"):
        pass
    assert set(session.drain_phases()) == {"after"}


def test_null_span_is_reusable_noop():
    s = ttel.null_span("anything")
    for _ in range(3):
        with s:
            pass
    assert ttel.null_span() is s


def test_spans_are_profiler_ranges():
    """A span opens a ``torch.profiler`` range ``ds_tpu/<path>`` (where
    JAX opens a ``TraceAnnotation``)."""
    from torch.profiler import ProfilerActivity, profile
    session = ttel.TelemetrySession()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with session.span("dispatch"):
            with session.span("host_adam"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"ds_tpu/dispatch", "ds_tpu/dispatch/host_adam"} <= names


# ---------------------------------------------------------------------------
# event log + exporters
# ---------------------------------------------------------------------------

def _session_ops(pkg, path, prom):
    reg = pkg.MetricsRegistry()
    session = pkg.TelemetrySession(
        registry=reg, exporters=[
            pkg.JsonlExporter(str(path)),
            pkg.PrometheusTextfileExporter(str(prom), reg, write_every=2)])
    session.emit("run_start", flavor="dense")
    session.step_event(step=1, wall_s=0.25, loss=2.0,
                       phases={"dispatch": 0.2})
    session.emit("health_guard", guard="nan_grads", action="warn", step=1,
                 reason="non-finite")
    session.close()
    return session


def test_jsonl_envelope_and_prometheus_textfile_equal_jax(tmp_path):
    port = _session_ops(ttel, tmp_path / "p.jsonl", tmp_path / "p.prom")
    jx = _session_ops(jtel, tmp_path / "j.jsonl", tmp_path / "j.prom")
    got, want = _read(tmp_path / "p.jsonl"), _read(tmp_path / "j.jsonl")
    assert [e["event"] for e in got] == ["run_start", "step",
                                         "health_guard"]
    for a, b in zip(got, want):
        assert a["schema"] == b["schema"] == jtel.SCHEMA_VERSION
        assert isinstance(a["t"], float)
        assert {k: v for k, v in a.items() if k != "t"} == \
            {k: v for k, v in b.items() if k != "t"}
    assert (tmp_path / "p.prom").read_text() == \
        (tmp_path / "j.prom").read_text()
    assert port.registry.snapshot() == jx.registry.snapshot()
    from deepspeed_tpu.telemetry.exporters import DURABLE_EVENTS as jdur
    from deepspeed_tpu_torch.telemetry.exporters import DURABLE_EVENTS
    assert DURABLE_EVENTS == jdur


def test_console_exporter_lines_equal_jax():
    import io
    evt = {"schema": jtel.SCHEMA_VERSION, "event": "step", "t": 1.0,
           "step": 3, "wall_s": 0.123456789, "phases": {"dispatch": 0.1,
                                                         "n": 2},
           "flavor": "dense", "tags": ["x"], "ok": True}
    out = []
    for pkg in (ttel, jtel):
        buf = io.StringIO()
        ex = pkg.ConsoleExporter(stream=buf)
        ex.export(evt)
        pkg.ConsoleExporter(stream=buf, events=("compile",)).export(evt)
        out.append(buf.getvalue())
    assert out[0] == out[1] and out[0].startswith("[telemetry] step")


def test_throwing_exporter_is_contained(tmp_path):
    class Boom:
        def export(self, event):
            raise RuntimeError("exporter died")

        def close(self):
            pass

    path = tmp_path / "run.jsonl"
    session = ttel.TelemetrySession(
        exporters=[Boom(), ttel.JsonlExporter(str(path))])
    session.emit("step", step=1)
    session.emit("step", step=2)
    session.close()
    assert [e["step"] for e in _read(path)] == [1, 2]


def test_event_ring_buffer_bounded():
    session = ttel.TelemetrySession(history=4)
    for i in range(10):
        session.emit("step", step=i)
    assert [e["step"] for e in session.events.recent()] == [6, 7, 8, 9]
    assert session.events.recent(2, event="step")[0]["step"] == 8


def test_session_default_first_wins():
    a, b = ttel.TelemetrySession(), ttel.TelemetrySession()
    assert ttel.set_default_session(a, replace=False) is a
    assert ttel.set_default_session(b, replace=False) is a
    assert ttel.get_default_session() is a
    assert ttel.set_default_session(b) is b


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_telemetry_config_defaults_equal_jax():
    got, want = DeepSpeedConfig(BASE), JaxConfig(BASE, world_size=1)
    assert repr(got.telemetry) == repr(want.telemetry)
    assert got.telemetry.enabled is False
    for attr in ("profiling_params", "compilation_cache_dir",
                 "tensorboard_enabled", "tensorboard_output_path",
                 "tensorboard_job_name", "wall_clock_breakdown",
                 "memory_breakdown"):
        assert getattr(got, attr) == getattr(want, attr), attr
    block = {"enabled": True, "jsonl_path": "x.jsonl", "history": 3,
             "flops_per_token": 1e6, "crash_dump_dir": "d",
             "watchdog": {"enabled": True, "min_deadline_s": 2.0},
             "anomaly_trace": {"enabled": True, "capture_steps": 2}}
    cfg = dict(BASE, telemetry=block, tensorboard={
        "enabled": True, "output_path": "tb", "job_name": "j"},
        profiling={"trace_dir": "t", "trace_num_steps": 1},
        compilation_cache_dir="cache")
    got, want = DeepSpeedConfig(cfg), JaxConfig(cfg, world_size=1)
    assert repr(got.telemetry) == repr(want.telemetry)
    assert vars(got.telemetry) == vars(want.telemetry)
    for attr in ("profiling_params", "compilation_cache_dir",
                 "tensorboard_enabled", "tensorboard_output_path",
                 "tensorboard_job_name"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("bad", [
    {"enabled": "yes"}, {"jsonl_path": 7}, {"history": 0},
    {"history": True}, {"prometheus_write_every": 0},
    {"flops_per_token": -1}, {"console": 3}, {"stamp_static_facts": 1},
    {"jsonl_pth": "/tmp/x.jsonl"}, {"crash_dump_dir": 3},
    {"flight_history": 0}, {"watchdog": {"deadline": 3}},
    {"watchdog": {"enabled": 1}}, {"watchdog": {"min_deadline_s": 0}},
    {"watchdog": {"enabled": True}},
    {"crash_dump_dir": "d", "watchdog": {"action": "page_oncall"}},
    {"anomaly_trace": {"factor": -1}}, {"anomaly_trace": {"window": 0}},
    {"anomaly_trace": {"color": 1}}])
def test_telemetry_config_rejects_as_jax(bad):
    cfg = dict(BASE, telemetry=bad)
    with pytest.raises(ValueError) as want:
        JaxConfig(cfg, world_size=1)
    with pytest.raises(ValueError) as got:
        DeepSpeedConfig(cfg)
    assert str(got.value) == str(want.value)
    assert "telemetry" in str(got.value)


def test_breakdown_keys_log_timers_and_allocator_memory(monkeypatch):
    """``wall_clock_breakdown`` logs each step's synchronized wall and
    ``memory_breakdown`` the allocator's figures (no "nothing is broken
    down" warning any more); the throughput timer counts samples."""
    from deepspeed_tpu_torch.runtime import config as tconfig
    from deepspeed_tpu_torch.telemetry import timers
    warned, logged = [], []
    monkeypatch.setattr(tconfig.logger, "warning", warned.append)
    monkeypatch.setattr(timers, "log_dist",
                        lambda msg, ranks=None: logged.append(msg))
    engine = _port_engine({"wall_clock_breakdown": True,
                           "memory_breakdown": True})
    assert warned == []
    for b in _batches(3):
        engine.train_batch(b)
    assert len(logged) == 3
    assert all(m.startswith("time (ms) | train_batch: ") and
               m.endswith("| memory stats unavailable") for m in logged)
    assert engine.tput_timer.global_step_count == 3
    assert engine.tput_timer.avg_samples_per_sec() > 0
    stats = timers.SynchronizedWallClockTimer.memory_stats()
    assert stats is None        # no card here; on one: allocator bytes


# ---------------------------------------------------------------------------
# the engines against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _run_with_telemetry(engine, tmp, tag):
    losses = [float(engine.train_batch(b)) for b in _batches()]
    engine.save_checkpoint(str(tmp / f"{tag}_ckpt"))
    assert engine.load_checkpoint(str(tmp / f"{tag}_ckpt"))[0] is not None
    engine.telemetry.close()
    return losses


@pytest.fixture(scope="module")
def jax_events(jax_params, tmp_path_factory):
    """JAX's engine on the tiny GPT-2 with telemetry on: its events and
    losses (the one JAX reference of the event tests)."""
    tmp = tmp_path_factory.mktemp("jax_telemetry")
    log = tmp / "jax.jsonl"
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=dict(BASE, telemetry={"enabled": True,
                                     "jsonl_path": str(log),
                                     "flops_per_token": 1e6}),
        loss_fn=jax_loss_fn(model), params=jax_params,
        mesh=build_mesh({}, devices=jax.devices()[:1]))
    losses = _run_with_telemetry(engine, tmp, "jax")
    jsession._default_session = None
    return _read(log), losses


def test_engine_events_and_keys_equal_jax(jax_params, jax_events, tmp_path):
    want, want_losses = jax_events
    log = tmp_path / "port.jsonl"
    engine = _port_engine({"telemetry": {"enabled": True,
                                         "jsonl_path": str(log),
                                         "flops_per_token": 1e6}},
                          params=jax_params)
    losses = _run_with_telemetry(engine, tmp_path, "port")
    got = _read(log)
    assert [e["event"] for e in got] == [e["event"] for e in want] == [
        "run_start", "compile", "step", "step", "step", "checkpoint_save",
        "checkpoint_load"]
    for g, w in zip(got, want):
        only = JAX_ONLY_KEYS.get(w["event"], set())
        assert set(g) == set(w) - only, w["event"]
        if w["event"] == "step":
            assert set(g["phases"]) == set(w["phases"]) == {"dispatch",
                                                            "device_wait"}
            assert g["tokens"] == w["tokens"] == 8 * T
        for key in ("flavor", "step", "tag", "topology", "zero_stage",
                    "batch_tokens", "flops_per_token", "process_index"):
            if key in w:
                assert g[key] == w[key], (w["event"], key)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        [e["loss"] for e in got if e["event"] == "step"], want_losses,
        rtol=LOSS_RTOL)
    assert [e["step"] for e in engine.metrics_history] == [1, 2, 3]
    assert ttel.get_default_session() is engine.telemetry


@pytest.mark.parametrize("flavor", ["dense", "zero1", "zero2", "zero3",
                                    "offload", "quantized", "pipeline"])
def test_all_step_flavors_emit_step_events(tmp_path, flavor):
    """Every step flavor of JAX's ``test_telemetry.py:413`` at world 1:
    two schema-versioned step events with phases, and the compile event,
    stamped with the flavor (JAX ``analysis/audit.py:_engine_flavor``)."""
    path = tmp_path / f"{flavor}.jsonl"
    cfg = {"telemetry": {"enabled": True, "jsonl_path": str(path)},
           "bf16": {"enabled": True}}
    zero = {"zero1": {"stage": 1}, "zero2": {"stage": 2},
            "zero3": {"stage": 3, "gather_chunks": 2},
            "offload": {"stage": 2, "cpu_offload": True}}
    if flavor in zero:
        cfg["zero_optimization"] = zero[flavor]
    if flavor == "quantized":
        del cfg["bf16"]
        cfg["comm_quantization"] = {"enabled": True, "chunk_size": 512,
                                    "bucket_mb": 4}
    rows, seq = 8, 16
    if flavor == "pipeline":
        del cfg["bf16"]
        cfg.update(gradient_accumulation_steps=2, mesh={"pipe": 2})
        module = gpt2_pipeline_module(
            gpt2_tiny(dtype=torch.float32, n_positions=seq), seq_len=seq)
        engine, _, _, _ = initialize(model=module, config=dict(BASE, **cfg),
                                     device="cpu", stage_devices=["cpu"] * 2)
        assert engine._forensics_extra() == {"num_stages": 2,
                                             "micro_batches": 2}
    else:
        engine = _port_engine(cfg, dtype=torch.float32
                              if flavor == "quantized" else torch.bfloat16)
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 255, (rows, seq)).astype(np.int32)}
    engine.train_batch(batch)
    engine.train_batch(batch)
    engine.telemetry.close()
    events = _read(path)
    steps = [e for e in events if e["event"] == "step"]
    assert len(steps) == 2
    for e in steps:
        assert e["schema"] == jtel.SCHEMA_VERSION
        assert e["flavor"] == flavor
        assert e["wall_s"] > 0 and {"dispatch", "device_wait"} <= \
            set(e["phases"])
    comp = next(e for e in events if e["event"] == "compile")
    assert comp["flavor"] == flavor
    run_start = events[0]
    assert run_start["event"] == "run_start" and run_start["flavor"] == \
        flavor
    if flavor == "offload":
        assert "host_adam" in steps[0]["phases"]


def test_health_guard_and_hot_snapshot_events(tmp_path):
    """A planted NaN gradient under a ``warn`` guard: one health_guard
    event with JAX's payload (``GuardTrip.as_event``), before the step
    event; the hot tier emits hot_snapshot."""
    from deepspeed_tpu.runtime.resilience.guards import GuardTrip
    from deepspeed_tpu_torch.runtime.resilience import fault_injection as fi
    log = tmp_path / "run.jsonl"
    engine = _port_engine({
        "telemetry": {"enabled": True, "jsonl_path": str(log)},
        "resilience": {"fault_injection": {"enabled": True},
                       "guards": {"nan_grads": {"action": "warn"}},
                       "hot_checkpoint": {"enabled": True,
                                          "interval_steps": 1}}})
    fi.clear_faults()
    try:
        fi.inject_nan_grads([1])
        for b in _batches(2):
            engine.train_batch(b)
    finally:
        fi.clear_faults()
        engine._hot_store.close()
        engine.telemetry.close()
    kinds = [e["event"] for e in _read(log)]
    hg = next(e for e in _read(log) if e["event"] == "health_guard")
    want = GuardTrip("nan_grads", "warn", 1, "x").as_event()
    assert set(hg) - {"schema", "event", "t"} == set(want)
    assert (hg["guard"], hg["action"]) == ("nan_grads", "warn")
    assert kinds.index("health_guard") < len(kinds) - 1 - \
        kinds[::-1].index("step")
    assert kinds.count("hot_snapshot") == 2


def test_metrics_history_ring_is_bounded():
    engine = _port_engine({"telemetry": {"enabled": True, "history": 2}})
    for b in _batches(5):
        engine.train_batch(b)
    assert [e["step"] for e in engine.metrics_history] == [4, 5]


def test_disabled_telemetry_is_inert(monkeypatch):
    """No telemetry block: no session, no history, no default session,
    and the step waits for the device nowhere new."""
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    waits = []
    monkeypatch.setattr(engine_mod, "_device_wait", waits.append)
    engine = _port_engine()
    assert engine.telemetry is None and engine.summary_writer is None
    engine.train_batch(_batches(1)[0])
    assert len(engine.metrics_history) == 0
    assert ttel.get_default_session() is None
    assert waits == []


def test_disabled_overhead_is_one_noop_check():
    """The per-step cost with telemetry off: one attribute check and the
    shared null span (well under any step's wall: < 50 us an
    iteration, JAX's bound)."""
    tele = None
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        span = tele.span if tele is not None else ttel.null_span
        with span("data_load"):
            pass
        with span("dispatch"):
            pass
    per_iter = (time.perf_counter() - t0) / n
    assert per_iter < 50e-6, f"null-span path costs {per_iter * 1e6:.1f}us"


# ---------------------------------------------------------------------------
# compilation_cache_dir: the kernel build cache
# ---------------------------------------------------------------------------

CACHE_CHILD = """
import json, sys
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.telemetry import compile_cache
compile_cache.apply(sys.argv[1])
_build.load_host_library("flatten_unflatten")
print(json.dumps(dict(compile_cache.counts(),
                      seconds=_build.build_info["flatten_unflatten"]
                      ["seconds"])))
"""


def test_compilation_cache_dir_misses_then_hits_across_processes(tmp_path):
    """A host library built by g++ into a fresh ``compilation_cache_dir``
    in one child process (a miss, the library left in the directory),
    then found there by a second (a hit, no build)."""
    cache = tmp_path / "kernel_cache"
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", CACHE_CHILD,
                               str(cache)], capture_output=True, text=True,
                              env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    cold, warm = runs
    assert (cold["hits"], cold["misses"]) == (0, 1) and cold["seconds"] > 0
    assert (warm["hits"], warm["misses"]) == (1, 0) and warm["seconds"] == 0
    assert [f for f in os.listdir(cache) if f.endswith(".so")]


def test_compile_event_carries_the_cache_counts(tmp_path):
    """With the key set the engine points the builds at it before any
    build, and the compile event carries the hit / miss counts (JAX
    stamps them only then too)."""
    from deepspeed_tpu_torch.ops import _build
    old = _build.BUILD_DIR
    log = tmp_path / "run.jsonl"
    try:
        engine = _port_engine({
            "compilation_cache_dir": str(tmp_path / "cache"),
            "telemetry": {"enabled": True, "jsonl_path": str(log)}})
        assert _build.BUILD_DIR == (tmp_path / "cache").resolve()
        engine.train_batch(_batches(1)[0])
        engine.telemetry.close()
    finally:
        _build.set_build_dir(old)
    comp = next(e for e in _read(log) if e["event"] == "compile")
    assert comp["compile_seconds"] > 0
    assert isinstance(comp["compile_cache_hits"], int)
    assert isinstance(comp["compile_cache_misses"], int)


# ---------------------------------------------------------------------------
# tensorboard
# ---------------------------------------------------------------------------

def test_tensorboard_writes_scalars(tmp_path, monkeypatch):
    """Rank 0's scalars go through ``torch.utils.tensorboard`` into an
    event file under ``output_path/<job id>/<job_name>``. (TensorFlow, an
    optional dependency of TensorBoard that takes seconds to import, is
    kept out: TensorBoard then writes through its own stub.)"""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    engine = _port_engine({"tensorboard": {
        "enabled": True, "output_path": str(tmp_path), "job_name": "job"}})
    for b in _batches(2):
        engine.train_batch(b)
    engine.summary_writer.close()
    run_dir = tmp_path / os.environ.get("DLWS_JOB_ID", "local") / "job"
    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    assert {"Train/loss", "Train/lr"} <= set(acc.Tags()["scalars"])
    assert [s.step for s in acc.Scalars("Train/loss")] == [1, 2]


def test_tensorboard_unavailable_warns_and_disables(monkeypatch):
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    said = []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(engine_mod.logger, "warning", said.append)
    engine = _port_engine({"tensorboard": {"enabled": True}})
    assert engine.summary_writer is None
    assert said == ["tensorboard unavailable; disabling"]
    engine.train_batch(_batches(1)[0])


# ---------------------------------------------------------------------------
# the trace window (test_profiler.py)
# ---------------------------------------------------------------------------

def _traces(d):
    return [f for _, _, fs in os.walk(d) for f in fs if "trace" in f]


def test_trace_profiler_disabled_by_default():
    p = ttel.TraceProfiler()
    assert not p.enabled
    p.before_step(0)
    p.after_step(0, 0.01)
    assert p.summary() == (0.01, 0.01, 0.01)


def test_unknown_profiling_key_raises_jax_text():
    with pytest.raises(ValueError) as want:
        jtel.TraceProfiler(trace_dir="x", trace_steps=2)
    with pytest.raises(ValueError) as got:
        ttel.TraceProfiler(trace_dir="x", trace_steps=2)
    assert str(got.value) == str(want.value)


def test_engine_captures_trace_window_with_span_ranges(tmp_path):
    trace_dir = tmp_path / "trace"
    engine = _port_engine({"wall_clock_breakdown": True, "profiling": {
        "trace_dir": str(trace_dir), "trace_start_step": 1,
        "trace_num_steps": 2}, "telemetry": {"enabled": True}})
    for b in _batches(4):
        engine.train_batch(b)
    (trace,) = _traces(trace_dir)
    with open(trace_dir / trace) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for span in ("ds_tpu/dispatch", "ds_tpu/device_wait"):
        assert names.count(span) == 2, span
    mean_s, min_s, max_s = engine.trace_profiler.summary()
    assert 0 < min_s <= mean_s <= max_s


def test_trace_window_at_step_zero_and_past_the_end(tmp_path):
    engine = _port_engine({"profiling": {
        "trace_dir": str(tmp_path / "zero"), "trace_start_step": 0,
        "trace_num_steps": 1}})
    for b in _batches(2):
        engine.train_batch(b)
    assert not engine.trace_profiler._active
    assert _traces(tmp_path / "zero")
    p = ttel.TraceProfiler(trace_dir=str(tmp_path / "end"),
                           trace_start_step=0, trace_num_steps=5)
    for step in range(2):
        p.before_step(step)
        p.after_step(step, 0.01)
    assert p._active
    p.close()
    assert not p._active and _traces(tmp_path / "end")
    assert p.close() is None                 # idempotent: atexit re-entry


def test_rearm_second_trace_window_in_one_process(tmp_path):
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    p = ttel.TraceProfiler(trace_dir=first, trace_start_step=0,
                           trace_num_steps=1)
    p.before_step(0)
    assert not p.arm(1, 1)
    p.after_step(0, 0.01)
    assert p.arm(2, 1, trace_dir=second, reason="recompile storm")
    assert p.armed_reason == "recompile storm"
    p.before_step(1)
    assert not p._active
    p.before_step(2)
    p.after_step(2, 0.01)
    assert _traces(first) and _traces(second)
    assert not ttel.TraceProfiler().arm(0, 1)
    assert not p.arm(3, 0)


def test_device_report_prints_the_devices():
    import io
    buf = io.StringIO()
    ttel.device_report(out=buf)
    text = buf.getvalue()
    for word in ("platform", "global devices", "device 0"):
        assert word in text
