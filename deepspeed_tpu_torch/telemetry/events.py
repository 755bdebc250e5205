"""Schema-versioned structured event log (port of
``deepspeed_tpu/telemetry/events.py``).

Every record is one JSON object with a fixed envelope::

    {"schema": "ds-tpu-telemetry/1",   # version tag, bump on breaking
     "event":  "step",                 # event type
     "t":      1756000000.123,        # unix seconds (host clock)
     ...payload fields per type...}

The schema is the JAX package's, so either package's ``ds_tpu_metrics``
reads a log the other wrote. Event types the port emits: ``run_start``,
``compile`` (once, after the first step's dispatch), ``step`` (per-step
metrics and phase breakdown), ``health_guard``, ``anomaly``,
``watchdog``, ``preemption``, ``checkpoint_save`` / ``checkpoint_load``,
``hot_snapshot``, ``recovery_ladder``, and the serving loop's
``decode_step`` and fleet events.

The log keeps a bounded in-memory ring (the engine re-exposes the step
slice as ``engine.metrics_history``) and fans each event out to the
configured exporters. A throwing exporter is disabled with one warning
instead of propagating: telemetry must never kill a run.
"""

import collections
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger

SCHEMA_VERSION = "ds-tpu-telemetry/1"


class EventLog:
    """Bounded ring of events + exporter fan-out.

    ``emit`` serializes under a lock: the hang watchdog emits its
    ``watchdog`` event from its own daemon thread, and interleaved
    exporter writes would corrupt the JSONL line stream.
    """

    def __init__(self, exporters=(), history=256):
        self.exporters = list(exporters)
        self._ring = collections.deque(maxlen=int(history))
        self._dead = set()
        self._lock = threading.Lock()

    def emit(self, event, **fields):
        evt = {"schema": SCHEMA_VERSION, "event": event, "t": time.time()}
        evt.update(fields)
        with self._lock:
            self._ring.append(evt)
            for ex in self.exporters:
                if id(ex) in self._dead:
                    continue
                try:
                    ex.export(evt)
                except Exception as e:
                    self._dead.add(id(ex))
                    logger.warning(
                        f"telemetry: exporter {type(ex).__name__} failed "
                        f"({e}); disabling it for the rest of the run")
        return evt

    def recent(self, n=None, event=None):
        evts = list(self._ring)
        if event is not None:
            evts = [e for e in evts if e.get("event") == event]
        return evts if n is None else evts[-n:]

    def close(self):
        for ex in self.exporters:
            try:
                ex.close()
            except Exception:
                pass
