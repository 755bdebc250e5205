"""Runtime telemetry (port of ``deepspeed_tpu/telemetry``): metrics
registry, step-phase spans, the schema-versioned event log, exporters,
the trace-window profiler, the flight recorder and the hang watchdog.

The event schema is the JAX package's (``ds-tpu-telemetry/1``), so a
log the port writes reads the same in either package's
``ds_tpu_metrics`` (``python -m deepspeed_tpu_torch.telemetry.cli``).

- :class:`MetricsRegistry`: typed counters / gauges / histograms with
  labels and Prometheus text rendering (``registry.py``).
- :class:`TelemetrySession` / :func:`get_default_session`: registry,
  event log and span API bundled per run (``session.py``).
- :func:`null_span`: the telemetry-off no-op fast path (``spans.py``).
- The synchronized timers and the ``torch.profiler`` trace window
  (``timers.py``, ``profiler.py``).
- The forensics layer: :class:`FlightRecorder` (black-box ring and
  atomic crash dumps, ``flight.py``), :class:`HangWatchdog` /
  :class:`StepAnomalyDetector` (``watchdog.py``).
- ``compile_cache.py``: ``compilation_cache_dir``, the directory of the
  kernel builds, and its hit / miss counts.
"""

from deepspeed_tpu_torch.telemetry.events import SCHEMA_VERSION, EventLog
from deepspeed_tpu_torch.telemetry.exporters import (
    ConsoleExporter,
    JsonlExporter,
    PrometheusTextfileExporter,
)
from deepspeed_tpu_torch.telemetry.flight import (
    FlightRecorder,
    install_crash_hooks,
    uninstall_crash_hooks,
)
from deepspeed_tpu_torch.telemetry.profiler import (
    TraceProfiler,
    device_report,
)
from deepspeed_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deepspeed_tpu_torch.telemetry.session import (
    TelemetrySession,
    get_default_session,
    set_default_session,
)
from deepspeed_tpu_torch.telemetry.spans import Span, null_span
from deepspeed_tpu_torch.telemetry.timers import (
    SynchronizedWallClockTimer,
    ThroughputTimer,
)
from deepspeed_tpu_torch.telemetry.watchdog import (
    HangWatchdog,
    StepAnomalyDetector,
)

__all__ = [
    "ConsoleExporter",
    "Counter",
    "EventLog",
    "FlightRecorder",
    "Gauge",
    "HangWatchdog",
    "Histogram",
    "JsonlExporter",
    "MetricsRegistry",
    "PrometheusTextfileExporter",
    "SCHEMA_VERSION",
    "Span",
    "StepAnomalyDetector",
    "SynchronizedWallClockTimer",
    "TelemetrySession",
    "ThroughputTimer",
    "TraceProfiler",
    "device_report",
    "get_default_session",
    "install_crash_hooks",
    "null_span",
    "set_default_session",
    "uninstall_crash_hooks",
]
