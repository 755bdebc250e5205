"""TelemetrySession: one metrics registry + one event log (the serving
subset of ``deepspeed_tpu/telemetry/session.py``; phase spans, the
flight recorder and the hang watchdog are not ported yet).
"""

from deepspeed_tpu_torch.telemetry.events import EventLog
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry


class TelemetrySession:
    def __init__(self, registry=None, exporters=(), history=256):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.events = EventLog(exporters=exporters, history=history)

    def emit(self, event, **fields):
        self.registry.counter(
            "events_total", labels={"event": event},
            help="telemetry events emitted by type").inc()
        return self.events.emit(event, **fields)

    def close(self):
        self.events.close()
