"""The JSONL telemetry exporter (copy of ``JsonlExporter`` from
``deepspeed_tpu/telemetry/exporters.py``)."""

import atexit
import json
import os

# Events worth an fsync: the ones a postmortem needs to out-survive the
# process that wrote them. Everything else gets flush-per-line only.
DURABLE_EVENTS = frozenset({"run_start", "scheduler_incomplete"})


class JsonlExporter:
    """Append one JSON line per event, flushed per write so ``tail -f``
    and a mid-run ``ds_tpu_metrics summary`` always see whole lines.
    The first open registers an atexit close; :data:`DURABLE_EVENTS`
    additionally ``fsync``."""

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
