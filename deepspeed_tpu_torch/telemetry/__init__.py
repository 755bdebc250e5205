"""Telemetry: the event log, metrics registry, session and JSONL
exporter of ``deepspeed_tpu/telemetry`` with the same event schema
(``ds-tpu-telemetry/1``), so ``ds_tpu_metrics summary`` reads the
port's serve logs unchanged."""

from deepspeed_tpu_torch.telemetry.events import SCHEMA_VERSION, EventLog
from deepspeed_tpu_torch.telemetry.exporters import JsonlExporter
from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry
from deepspeed_tpu_torch.telemetry.session import TelemetrySession

__all__ = ["SCHEMA_VERSION", "EventLog", "JsonlExporter",
           "MetricsRegistry", "TelemetrySession"]
