"""TelemetrySession: one registry + one event log + the span API (port
of ``deepspeed_tpu/telemetry/session.py``).

The engine owns a session when the ``telemetry`` config block enables
it; code that runs outside an engine method reaches the
*process-default* session via :func:`get_default_session`, so its
events land in the same log. The serving loop builds sessions of its own
(``TelemetrySession(exporters=..., history=...)``) and only emits.

Span durations accumulate per phase name between ``drain_phases()``
calls: the engine drains once per step and stamps the result into that
step's event, so nested or repeated spans within a step sum.

The session is also the forensics hub: when the config enables them it
owns a :class:`~deepspeed_tpu_torch.telemetry.flight.FlightRecorder`
(which rides the exporter fan-out and also receives every span
transition) and a
:class:`~deepspeed_tpu_torch.telemetry.watchdog.HangWatchdog` (which
every span entry and exit feeds as a heartbeat).
"""

from deepspeed_tpu_torch.telemetry.events import EventLog
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from deepspeed_tpu_torch.telemetry.spans import Span

_default_session = None


def get_default_session():
    """The process-default session, or None when telemetry is off."""
    return _default_session


def set_default_session(session, replace=True):
    """Install ``session`` as the process default. ``replace=False``
    keeps an already-installed session (the first engine wins)."""
    global _default_session
    if _default_session is not None and not replace:
        return _default_session
    _default_session = session
    return session


class TelemetrySession:
    def __init__(self, registry=None, exporters=(), history=256,
                 flight=None, watchdog=None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.flight = flight
        self.watchdog = watchdog
        if flight is not None:
            exporters = list(exporters) + [flight]
        self.events = EventLog(exporters=exporters, history=history)
        if watchdog is not None and watchdog.session is None:
            watchdog.session = self
        self._phases = {}

    @classmethod
    def from_config(cls, tcfg, meta=None):
        """A session from a validated ``TelemetryConfig``.

        ``meta`` (process identity and run facts from the engine) is
        stamped into the flight recorder's dumps and names the
        watchdog's heartbeat file; the forensics pieces exist only when
        the config enables them.
        """
        from deepspeed_tpu_torch.telemetry.exporters import (
            ConsoleExporter, JsonlExporter, PrometheusTextfileExporter)
        registry = MetricsRegistry()
        exporters = []
        if tcfg.jsonl_path:
            exporters.append(JsonlExporter(tcfg.jsonl_path))
        if tcfg.console:
            exporters.append(ConsoleExporter())
        if tcfg.prometheus_textfile:
            exporters.append(PrometheusTextfileExporter(
                tcfg.prometheus_textfile, registry,
                write_every=tcfg.prometheus_write_every))
        meta = dict(meta or {})
        flight = watchdog = None
        if tcfg.crash_dump_dir:
            from deepspeed_tpu_torch.telemetry.flight import FlightRecorder
            flight = FlightRecorder(tcfg.crash_dump_dir,
                                    history=tcfg.flight_history, meta=meta)
        if tcfg.watchdog_enabled:
            from deepspeed_tpu_torch.telemetry.watchdog import HangWatchdog
            watchdog = HangWatchdog(
                flight=flight,
                deadline_factor=tcfg.watchdog_deadline_factor,
                min_deadline_s=tcfg.watchdog_min_deadline_s,
                action=tcfg.watchdog_action,
                heartbeat_dir=tcfg.crash_dump_dir,
                process_index=meta.get("process_index", 0),
                process_count=meta.get("process_count", 1),
                hostname=meta.get("hostname"))
        return cls(registry=registry, exporters=exporters,
                   history=tcfg.history, flight=flight, watchdog=watchdog)

    # -- spans ---------------------------------------------------------
    def span(self, name):
        return Span(name, self)

    def _enter_phase(self, name, path):
        wd = self.watchdog
        if wd is not None:
            wd.beat(path)
        if self.flight is not None:
            self.flight.record_phase("enter", path)

    def _record_phase(self, name, path, duration_s):
        self._phases[name] = self._phases.get(name, 0.0) + duration_s
        self.registry.histogram(
            "phase_seconds", labels={"phase": name},
            help="host wall seconds per step phase").observe(duration_s)
        wd = self.watchdog
        if wd is not None:
            wd.beat(path)
        if self.flight is not None:
            self.flight.record_phase("exit", path, duration_s)

    def drain_phases(self):
        """Per-phase seconds accumulated since the last drain (one step's
        phase breakdown); resets the accumulator."""
        phases, self._phases = self._phases, {}
        return phases

    # -- events --------------------------------------------------------
    def emit(self, event, **fields):
        self.registry.counter(
            "events_total", labels={"event": event},
            help="telemetry events emitted by type").inc()
        return self.events.emit(event, **fields)

    def step_event(self, **fields):
        """Emit one per-step event and update the step-level metrics."""
        wall = fields.get("wall_s")
        if wall is not None:
            self.registry.histogram(
                "step_seconds",
                help="end-to-end host wall seconds per optimizer step"
            ).observe(wall)
        if fields.get("loss") is not None:
            self.registry.gauge("loss", help="last step loss").set(
                fields["loss"])
        self.registry.counter("steps_total",
                              help="optimizer steps completed").inc()
        return self.emit("step", **fields)

    def close(self):
        if self.watchdog is not None:
            self.watchdog.stop()
        self.events.close()
