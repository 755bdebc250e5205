"""Process-wide metrics registry: typed counters / gauges / histograms
(port of ``deepspeed_tpu/telemetry/registry.py``).

Every host-side number the engine, the resilience layer or the serving
loop reports flows through one of three metric kinds, each with labels
the Prometheus way: a *family* (one name, one kind, one help string)
fans out into per-label-set series, e.g. ``phase_seconds{phase=
"dispatch"}`` and ``phase_seconds{phase="device_wait"}`` are two series
of one family.

All operations are plain-python dict updates on the hot path (no torch,
no I/O); exporters (``telemetry/exporters.py``) snapshot the registry
when they need to materialize it. :meth:`MetricsRegistry.to_prometheus`
renders the same text as the JAX package's for the same operations.
"""

import bisect
import threading

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Log-spaced seconds buckets sized for host phases: sub-ms null-span
# noise up through multi-minute compiles. Prometheus-style upper bounds;
# +Inf is implicit.
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic count (events, steps, retries)."""

    __slots__ = ("labels", "value")

    def __init__(self, labels=None):
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, n=1.0):
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        self.value += n

    def sample(self):
        return {"value": self.value}


class Gauge:
    """Last-write-wins scalar (loss, lr, queue depth)."""

    __slots__ = ("labels", "value")

    def __init__(self, labels=None):
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def inc(self, n=1.0):
        self.value += n

    def dec(self, n=1.0):
        self.value -= n

    def sample(self):
        return {"value": self.value}


class Histogram:
    """Distribution with count/sum/min/max plus fixed cumulative-style
    buckets (upper bounds; +Inf implicit) for the Prometheus exporter."""

    __slots__ = ("labels", "bounds", "bucket_counts", "count", "sum",
                 "min", "max")

    def __init__(self, labels=None, buckets=DEFAULT_TIME_BUCKETS):
        self.labels = dict(labels or {})
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * len(self.bounds)
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
        i = bisect.bisect_left(self.bounds, v)
        if i < len(self.bounds):
            self.bucket_counts[i] += 1
        # past the last bound -> only the implicit +Inf bucket (== count)

    @property
    def mean(self):
        return self.sum / self.count if self.count else 0.0

    def cumulative_buckets(self):
        """[(upper_bound, cumulative_count), ...] ending with +Inf."""
        out, running = [], 0
        for bound, n in zip(self.bounds, self.bucket_counts):
            running += n
            out.append((bound, running))
        out.append((float("inf"), self.count))
        return out

    def sample(self):
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean}


_KINDS = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class _Family:
    """One metric name: one kind, one help string, many label series."""

    __slots__ = ("name", "kind", "help", "buckets", "series")

    def __init__(self, name, kind, help="", buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.series = {}   # label_key -> metric instance

    def child(self, labels=None):
        key = _label_key(labels)
        metric = self.series.get(key)
        if metric is None:
            if self.kind == HISTOGRAM:
                metric = Histogram(labels,
                                   buckets=self.buckets or
                                   DEFAULT_TIME_BUCKETS)
            else:
                metric = _KINDS[self.kind](labels)
            self.series[key] = metric
        return metric


class MetricsRegistry:
    """Name -> typed metric family; get-or-create on access, so call
    sites never pre-register. Re-registering a name under a different
    kind is a bug and raises."""

    def __init__(self):
        self._families = {}
        self._lock = threading.Lock()

    def _family(self, name, kind, help="", buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, buckets=buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name, labels=None, help=""):
        return self._family(name, COUNTER, help).child(labels)

    def gauge(self, name, labels=None, help=""):
        return self._family(name, GAUGE, help).child(labels)

    def histogram(self, name, labels=None, help="", buckets=None):
        return self._family(name, HISTOGRAM, help,
                            buckets=buckets).child(labels)

    def snapshot(self):
        """JSON-friendly view of every series (tests, console export)."""
        out = {}
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            out[fam.name] = {
                "kind": fam.kind,
                "help": fam.help,
                "series": [dict(labels=m.labels, **m.sample())
                           for m in fam.series.values()],
            }
        return out

    def to_prometheus(self, prefix="ds_tpu_"):
        """Prometheus text exposition format (textfile-collector ready)."""
        lines = []
        with self._lock:
            families = sorted(self._families.values(),
                              key=lambda f: f.name)
        for fam in families:
            name = prefix + fam.name
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for metric in fam.series.values():
                lbl = _fmt_labels(metric.labels)
                if fam.kind == HISTOGRAM:
                    for bound, n in metric.cumulative_buckets():
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(metric.labels, le=le)} {n}")
                    lines.append(f"{name}_sum{lbl} {metric.sum}")
                    lines.append(f"{name}_count{lbl} {metric.count}")
                else:
                    lines.append(f"{name}{lbl} {metric.value}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels, le=None):
    items = sorted(labels.items())
    if le is not None:
        items = items + [("le", le)]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")
