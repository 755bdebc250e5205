"""Pluggable telemetry exporters: JSONL file, console table, Prometheus
textfile (port of ``deepspeed_tpu/telemetry/exporters.py``).

All three are push-style (``export(event)`` per event) plus ``close()``
for final flushes. The matrix:

==================  =========================  =======================
exporter            carries                    consumer
==================  =========================  =======================
JsonlExporter       every event, verbatim      ``ds_tpu_metrics``,
                                               offline analysis
ConsoleExporter     one compact line/event     humans tailing a run
PrometheusTextfile  registry snapshot           node_exporter textfile
Exporter            (metrics, not events)       collector / scrapers
==================  =========================  =======================

The Prometheus exporter is event-*triggered* but registry-*sourced*: it
rewrites the textfile atomically (tmp + rename, the collector contract)
every ``write_every`` events and on close.
"""

import atexit
import json
import os
import sys

# Events worth an fsync: the ones a postmortem needs to out-survive the
# process that wrote them. Everything else gets flush-per-line only.
DURABLE_EVENTS = frozenset({
    "run_start", "health_guard", "recompile", "preemption", "watchdog",
    "anomaly", "restart", "recovery_ladder", "checkpoint_fallback",
    # serving fleet: replica deaths and aborted requests are
    # exactly the events a post-incident aggregate must not lose
    "replica_dead", "request_aborted", "scheduler_incomplete",
})


class JsonlExporter:
    """Append one JSON line per event; flushed per write so ``tail -f``
    and a mid-run ``ds_tpu_metrics summary`` always see whole lines.

    The tail of a crashed run must not die in buffers: the first open
    registers an atexit close, and :data:`DURABLE_EVENTS` (guard trips,
    recompiles, preemption, watchdog/anomaly firings) additionally
    ``fsync`` so they reach disk even if the process is killed next."""

    def __init__(self, path):
        self.path = str(path)
        self._f = None

    def export(self, event):
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "a")
            atexit.register(self.close)
        self._f.write(json.dumps(event, default=str) + "\n")
        self._f.flush()
        if event.get("event") in DURABLE_EVENTS:
            os.fsync(self._f.fileno())

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class ConsoleExporter:
    """One aligned ``[telemetry]`` line per event (scalars only —
    nested payloads like the step's phase dict are summarized)."""

    def __init__(self, stream=None, events=None):
        self.stream = stream
        self.events = set(events) if events else None

    def export(self, event):
        kind = event.get("event", "?")
        if self.events is not None and kind not in self.events:
            return
        out = self.stream or sys.stderr
        parts = []
        for k, v in event.items():
            if k in ("schema", "event", "t"):
                continue
            if isinstance(v, float):
                parts.append(f"{k}={v:.6g}")
            elif isinstance(v, (str, int, bool)) or v is None:
                parts.append(f"{k}={v}")
            elif isinstance(v, dict) and all(
                    isinstance(x, (int, float)) for x in v.values()):
                body = " ".join(f"{kk}={vv:.4g}" if isinstance(vv, float)
                                else f"{kk}={vv}"
                                for kk, vv in v.items())
                parts.append(f"{k}=[{body}]")
            else:
                parts.append(f"{k}=...")
        print(f"[telemetry] {kind:<16s} " + " ".join(parts), file=out)

    def close(self):
        pass


class PrometheusTextfileExporter:
    """Write ``registry.to_prometheus()`` to ``path`` atomically every
    ``write_every`` events (and on close). Point a node_exporter
    ``--collector.textfile.directory`` at the parent dir."""

    def __init__(self, path, registry, write_every=20):
        self.path = str(path)
        self.registry = registry
        self.write_every = max(1, int(write_every))
        self._n = 0

    def export(self, event):
        self._n += 1
        if self._n % self.write_every == 0:
            self.write()

    def write(self):
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.registry.to_prometheus())
        os.replace(tmp, self.path)

    def close(self):
        self.write()
