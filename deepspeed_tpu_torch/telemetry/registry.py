"""Metrics registry: typed counters / gauges / histograms (the part of
``deepspeed_tpu/telemetry/registry.py`` the serving loop feeds; bucket
counts and the Prometheus rendering wait for a port of that exporter).

A *family* (one name, one kind, one help string) fans out into
per-label-set series. All operations are plain-python dict updates.
"""

import threading

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic count (events, tokens)."""

    __slots__ = ("labels", "value")

    def __init__(self, labels=None):
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Last-write-wins scalar (occupancy, queue depth)."""

    __slots__ = ("labels", "value")

    def __init__(self, labels=None):
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v):
        self.value = float(v)


class Histogram:
    """Distribution summary: count, sum, min, max."""

    __slots__ = ("labels", "count", "sum", "min", "max")

    def __init__(self, labels=None):
        self.labels = dict(labels or {})
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0


_KINDS = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class _Family:
    """One metric name: one kind, one help string, many label series."""

    __slots__ = ("name", "kind", "help", "series")

    def __init__(self, name, kind, help=""):
        self.name = name
        self.kind = kind
        self.help = help
        self.series = {}

    def child(self, labels=None):
        key = _label_key(labels)
        metric = self.series.get(key)
        if metric is None:
            metric = self.series[key] = _KINDS[self.kind](labels)
        return metric


class MetricsRegistry:
    """Name -> typed metric family; get-or-create on access.
    Re-registering a name under a different kind raises."""

    def __init__(self):
        self._families = {}
        self._lock = threading.Lock()

    def _family(self, name, kind, help=""):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name, labels=None, help=""):
        return self._family(name, COUNTER, help).child(labels)

    def gauge(self, name, labels=None, help=""):
        return self._family(name, GAUGE, help).child(labels)

    def histogram(self, name, labels=None, help=""):
        return self._family(name, HISTOGRAM, help).child(labels)
