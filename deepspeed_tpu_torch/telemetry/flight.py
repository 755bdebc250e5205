"""Flight recorder: an always-on black box for "why did the run stop"
(port of ``deepspeed_tpu/telemetry/flight.py``; the dump schema is the
JAX package's, so either package's ``read_dump`` and ``postmortem``
read a dump of the other).

The :class:`FlightRecorder` keeps a bounded in-memory ring of

- recent telemetry **events** (it plugs into the session's exporter
  fan-out, so it sees exactly what the JSONL log sees),
- **phase-span transitions** (enter/exit of every ``session.span``
  scope, fed by ``telemetry/spans.py``), and
- the step's **collectives**. JAX records the collective sites it traced
  into the compiled step; the port runs eagerly and records what it
  counts at run time instead: the engine's data-group collectives
  (``runtime/zero/comm.py:Comm.snapshot``) and the mesh collectives
  (``parallel/collectives.py:collective_counts``) issued since the step
  began, each as its kind, calls and bytes. The engine installs a
  source (:meth:`FlightRecorder.set_collective_source`) that is read at
  dump time, so a dump of a hung step says what the step had issued when
  it stopped.

On demand it dumps all of it, plus ``faulthandler``-style stacks of
every live Python thread and the per-thread in-flight span path,
atomically (tmp + rename) to a crash-dump directory.
``python -m deepspeed_tpu_torch.telemetry.cli postmortem <dump>``
renders a dump; ``telemetry/watchdog.py`` fires one on hangs.

Dumps are triggered by (see :func:`install_crash_hooks`):

- an **unhandled exception** (chained ``sys.excepthook``),
- **SIGTERM** (dump first, then the chained preemption handler of
  ``runtime/resilience/preemption.py`` runs) and **SIGQUIT** (dump and
  thread stacks on stderr; the process keeps running),
- a **health-guard abort** (the engine dumps before raising), and
- the **hang watchdog** expiring.

Everything here is exception-contained: forensics must never be the
thing that kills the run.
"""

import json
import os
import signal
import sys
import threading
import time
import traceback
import collections

from deepspeed_tpu_torch.telemetry.spans import live_phase_paths
from deepspeed_tpu_torch.utils.logging import logger

FLIGHT_SCHEMA = "ds-tpu-flight/1"


def thread_stacks():
    """``faulthandler``-style stacks of all live Python threads, as
    structured data: ``[{name, ident, daemon, stack: [lines...]}]``."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append({
            "name": t.name if t is not None else f"thread-{ident}",
            "ident": ident,
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)],
        })
    return out


class FlightRecorder:
    """Bounded black-box ring + atomic crash dumps.

    Implements the exporter protocol (``export``/``close``) so a
    :class:`~deepspeed_tpu_torch.telemetry.events.EventLog` fans events into
    the ring exactly like any other exporter; phase transitions arrive
    through the session hooks, the step's collectives from its
    collective source.
    """

    def __init__(self, dump_dir, history=512, meta=None):
        self.dump_dir = str(dump_dir)
        self.meta = dict(meta or {})
        self._events = collections.deque(maxlen=int(history))
        self._phases = collections.deque(maxlen=int(history))
        self._collective_source = None
        self._lock = threading.Lock()
        self._dumps = 0

    # -- exporter protocol (events fan in) ----------------------------
    def export(self, event):
        with self._lock:
            self._events.append(dict(event))

    def close(self):
        pass

    # -- session hooks -------------------------------------------------
    def record_phase(self, kind, path, duration_s=None):
        """One span transition: ``kind`` is ``"enter"`` or ``"exit"``."""
        rec = {"t": time.time(), "kind": kind, "path": path}
        if duration_s is not None:
            rec["duration_s"] = round(duration_s, 6)
        with self._lock:
            self._phases.append(rec)

    def set_collective_source(self, source):
        """``source()`` -> the rows of the collectives the current step
        has issued (``{"site", "axis", "primitive", "calls", "bytes"}``),
        read at every snapshot; None removes it."""
        self._collective_source = source

    # -- dumping -------------------------------------------------------
    def snapshot(self, reason, extra=None):
        """The dump payload as a dict (no I/O)."""
        with self._lock:
            events = list(self._events)
            phases = list(self._phases)
        collectives = []
        source = self._collective_source
        if source is not None:
            try:
                collectives = [dict(r) for r in source()]
            except Exception as e:   # forensics never kills the run
                collectives = [{"site": "unavailable", "error": str(e)}]
        names = {t.ident: t.name for t in threading.enumerate()}
        in_flight = {names.get(ident, f"thread-{ident}"): path
                     for ident, path in live_phase_paths().items()}
        snap = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "t": time.time(),
            "pid": os.getpid(),
            "meta": dict(self.meta),
            "in_flight_phases": in_flight,
            "threads": thread_stacks(),
            "events": events,
            "phase_log": phases,
            "collectives": collectives,
        }
        if extra:
            snap.update(extra)
        return snap

    def dump(self, reason, extra=None):
        """Atomically write one dump file; returns its path (or None —
        a failing dump logs one warning and never raises)."""
        try:
            snap = self.snapshot(reason, extra=extra)
            os.makedirs(self.dump_dir, exist_ok=True)
            with self._lock:
                self._dumps += 1
                seq = self._dumps
            tag = str(reason).replace(":", "-").replace("/", "-")
            pidx = self.meta.get("process_index", 0)
            name = (f"flight-p{int(pidx):05d}-{tag}-"
                    f"{int(snap['t'] * 1000)}-{seq}.json")
            path = os.path.join(self.dump_dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            logger.warning("flight recorder: dumped %s record to %s",
                           reason, path)
            return path
        except Exception as e:   # pragma: no cover - disk-full etc.
            logger.warning("flight recorder: dump failed (%s)", e)
            return None

    # -- crash hooks ---------------------------------------------------
    def install(self, signals=(signal.SIGTERM, getattr(signal, "SIGQUIT",
                                                       None))):
        install_crash_hooks(self, signals=signals)
        return self

    def uninstall(self):
        uninstall_crash_hooks(self)


def read_dump(path):
    """Parse + validate one flight-recorder dump (the ``postmortem``
    CLI's loader). Raises ``ValueError`` on a non-dump JSON file."""
    with open(path) as f:
        dump = json.load(f)
    if not isinstance(dump, dict) or \
            dump.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(
            f"{path} is not a flight-recorder dump "
            f"(expected schema {FLIGHT_SCHEMA!r}, "
            f"got {dump.get('schema') if isinstance(dump, dict) else dump!r})")
    return dump


# ---------------------------------------------------------------------------
# process-level crash hooks (one set per process; re-install swaps the
# target recorder, so tests / multiple engines never stack handlers)
# ---------------------------------------------------------------------------

_hooks = {"recorder": None, "excepthook": None, "signals": {}}


def _on_unhandled(exc_type, exc, tb):
    rec = _hooks["recorder"]
    if rec is not None:
        try:
            rec.dump("exception", extra={"exception": {
                "type": exc_type.__name__,
                "message": str(exc),
                "traceback": traceback.format_exception(exc_type, exc, tb),
            }})
        except Exception:   # pragma: no cover
            pass
    prev = _hooks["excepthook"]
    (prev or sys.__excepthook__)(exc_type, exc, tb)


def _on_signal(signum, frame):
    rec = _hooks["recorder"]
    name = signal.Signals(signum).name
    if rec is not None:
        try:
            rec.dump(f"signal:{name}")
        except Exception:   # pragma: no cover
            pass
    prev = _hooks["signals"].get(signum, (None,))[0]
    if signum == getattr(signal, "SIGQUIT", None):
        # Operator "where is it stuck" signal: stacks on stderr too
        # (the satellite faulthandler registration prints the same when
        # no recorder is installed), then keep running.
        try:
            import faulthandler
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:   # pragma: no cover
            pass
        if callable(prev):
            prev(signum, frame)
        return
    if callable(prev):
        prev(signum, frame)     # e.g. the preemption latch
    elif prev == signal.SIG_DFL:
        # restore + re-deliver so default semantics (terminate) hold
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_crash_hooks(recorder, signals=(signal.SIGTERM,
                                           getattr(signal, "SIGQUIT",
                                                   None))):
    """Point the process crash hooks at ``recorder``. First call chains
    ``sys.excepthook`` and the given signals; later calls only swap the
    recorder (handlers never stack). Off the main thread, signal
    chaining degrades to excepthook-only (CPython restriction)."""
    _hooks["recorder"] = recorder
    if _hooks["excepthook"] is None and sys.excepthook is not _on_unhandled:
        _hooks["excepthook"] = sys.excepthook
        sys.excepthook = _on_unhandled
    if threading.current_thread() is not threading.main_thread():
        return
    for sig in signals:
        if sig is None or sig in _hooks["signals"]:
            continue
        try:
            prev = signal.signal(sig, _on_signal)
        except (ValueError, OSError):   # pragma: no cover - exotic envs
            continue
        _hooks["signals"][sig] = (prev,)


def uninstall_crash_hooks(recorder=None):
    """Restore the chained hooks (tests). A no-op when ``recorder`` is
    given and is not the installed one."""
    if recorder is not None and _hooks["recorder"] is not recorder:
        return
    _hooks["recorder"] = None
    if _hooks["excepthook"] is not None:
        sys.excepthook = _hooks["excepthook"]
        _hooks["excepthook"] = None
    if threading.current_thread() is threading.main_thread():
        for sig, (prev,) in list(_hooks["signals"].items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):   # pragma: no cover
                pass
            _hooks["signals"].pop(sig, None)
