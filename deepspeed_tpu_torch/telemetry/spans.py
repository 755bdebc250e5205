"""Step-phase spans: nestable wall-time scopes that show up in a
``torch.profiler`` trace (port of ``deepspeed_tpu/telemetry/spans.py``).

``session.span("dispatch")`` is a context manager that (1) records the
scope's wall seconds into the session's per-step phase accumulator and
the ``phase_seconds{phase=...}`` histogram, and (2) opens a
``torch.profiler.record_function`` range named ``ds_tpu/<path>``, so a
trace captured by ``TraceProfiler`` (``telemetry/profiler.py``) shows
the host phases as named ranges beside the kernels they launched. The
JAX package opens a ``jax.profiler.TraceAnnotation`` there.

Spans nest: the engine's offload host-Adam phase runs inside the
``dispatch`` span, and ``Span.path`` carries the full ``a/b`` nesting
path (per thread). Exit is exception-safe: a phase that raises still
records its duration and closes its range before re-raising.

The disabled fast path is :func:`null_span`: a module-level singleton
whose ``__enter__``/``__exit__`` do nothing, so an engine with telemetry
off pays one attribute check and one no-op context manager per phase.

Every thread's span stack is also registered in a process-global map so
the forensics layer (``telemetry/flight.py``, ``telemetry/watchdog.py``)
can read *other* threads' in-flight phase paths: "which phase is the
main thread stuck in" is what a hang dump must answer.
:func:`live_phase_paths` snapshots that map.

torch is imported at the first span, not here: the metrics CLI reads
flight dumps through this module without loading torch.
"""

import threading
import time

_local = threading.local()
# thread ident -> that thread's live span stack (the same list object
# _local.stack aliases); entries for exited threads are pruned on read
_live_stacks = {}
_record_function = []       # [the torch.profiler.record_function class]


def _range_class():
    if not _record_function:
        try:
            from torch.profiler import record_function
        except Exception:    # no torch: spans time without ranges
            record_function = None
        _record_function.append(record_function)
    return _record_function[0]


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _live_stacks[threading.get_ident()] = stack
    return stack


def live_phase_paths():
    """``{thread_ident: "a/b" in-flight span path}`` for every thread
    currently inside at least one span. Reads are lock-free snapshots:
    a concurrently-mutating stack at worst yields a one-frame-stale
    path, which is fine for forensics."""
    live = {t.ident for t in threading.enumerate()}
    out = {}
    for ident, stack in list(_live_stacks.items()):
        if ident not in live:
            _live_stacks.pop(ident, None)
            continue
        path = "/".join(stack)
        if path:
            out[ident] = path
    return out


class Span:
    """One timed, profiler-visible scope. Created via
    ``TelemetrySession.span``."""

    __slots__ = ("name", "path", "duration_s", "_session", "_t0",
                 "_range")

    def __init__(self, name, session=None):
        self.name = name
        self.path = name
        self.duration_s = None
        self._session = session
        self._t0 = None
        self._range = None

    def __enter__(self):
        stack = _stack()
        stack.append(self.name)
        self.path = "/".join(stack)
        cls = _range_class()
        if cls is not None:
            self._range = cls(f"ds_tpu/{self.path}")
            self._range.__enter__()
        if self._session is not None:
            self._session._enter_phase(self.name, self.path)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.duration_s = time.perf_counter() - self._t0
        try:
            if self._range is not None:
                self._range.__exit__(exc_type, exc, tb)
        finally:
            stack = _stack()
            if stack and stack[-1] == self.name:
                stack.pop()
            if self._session is not None:
                self._session._record_phase(self.name, self.path,
                                            self.duration_s)
        return False   # never swallow the phase's exception


class _NullSpan:
    """Singleton no-op context manager: the telemetry-off fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def null_span(name=None):
    """Drop-in for ``session.span`` when telemetry is disabled."""
    return _NULL_SPAN
