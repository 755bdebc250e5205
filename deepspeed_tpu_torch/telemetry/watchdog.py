"""Hang watchdog and step-wall anomaly detection (port of
``deepspeed_tpu/telemetry/watchdog.py``).

A hung collective is invisible from inside the step: every process
blocks in ``device_wait`` (or, over gloo, inside a host-staged
collective) and nothing raises. The :class:`HangWatchdog` is a daemon
thread fed two cheap signals from the training loop,
``step_start``/``step_end`` (the engine's step boundary) and ``beat``
(every span transition, wired through ``TelemetrySession``), that

1. learns a deadline from a **rolling median** of completed step walls
   (``deadline = max(min_deadline_s, deadline_factor * median)``),
2. writes a per-process **heartbeat file** each poll tick
   (:func:`heartbeat_path`; the serving fleet's workers write the same
   file, ``inference/fleet_worker.py``), so every process can see how
   far its peers got, and
3. on expiry classifies the hang, ``this_host_stuck`` (we are the
   laggard) or ``waiting_on_straggler`` (a peer is behind us; ranked),
   emits a ``watchdog`` telemetry event, and dumps the flight record
   (``telemetry/flight.py``).

``action: "dump"`` (default) fires at most once per hung step and lets
the run continue if the step ever completes; ``action: "abort"`` prints
all thread stacks and terminates the process with SIGABRT so a cluster
supervisor can restart it.

:class:`StepAnomalyDetector` is the third forensics trigger: a
step-wall regression against the same rolling median arms the
``TraceProfiler`` to capture the next K steps (``runtime/engine.py``).
"""

import collections
import json
import math
import os
import signal
import socket
import sys
import threading
import time

from deepspeed_tpu_torch.utils.logging import logger

WATCHDOG_ACTION_DUMP = "dump"
WATCHDOG_ACTION_ABORT = "abort"
WATCHDOG_ACTIONS = (WATCHDOG_ACTION_DUMP, WATCHDOG_ACTION_ABORT)

VERDICT_THIS_HOST = "this_host_stuck"
VERDICT_STRAGGLER = "waiting_on_straggler"

_HB_PREFIX = "hb-p"


def heartbeat_path(directory, process_index):
    return os.path.join(directory, f"{_HB_PREFIX}{int(process_index):05d}.json")


def _hb_index(name):
    """Process index encoded in a heartbeat filename, or None."""
    try:
        return int(name[len(_HB_PREFIX):-len(".json")])
    except ValueError:
        return None


# One bounded re-read before a heartbeat file is classified as
# unparseable. The writer is tmp+os.replace atomic, but a reader racing
# a slow replace (or a file torn by a mid-write kill that a healthy
# watchdog is about to overwrite) can observe truncated JSON once; a
# single retry separates "torn right now" from "torn forever" without
# letting a truly corrupt file stall the scan. ``_retry_sleep`` is a
# module hook so tests can repair/observe the file between the reads.
_TORN_RETRY_SLEEP_S = 0.05
_retry_sleep = time.sleep


def _read_heartbeat_file(path):
    """Parse one heartbeat file with one bounded re-read retry; None
    when both attempts fail."""
    for attempt in (0, 1):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            if attempt == 0:
                _retry_sleep(_TORN_RETRY_SLEEP_S)
    return None


def scan_heartbeats(directory, expected_count=None):
    """``(heartbeats, no_heartbeat)`` for ``directory``.

    ``heartbeats`` is every parseable per-process heartbeat file.
    ``no_heartbeat`` lists the processes that SHOULD have reported but
    did not — a half-written file (killed mid-``json.dump``, though the
    writer's tmp+``os.replace`` makes that rare; each file gets one
    bounded re-read via :func:`_read_heartbeat_file` before the
    ``unparseable`` verdict sticks), or, with ``expected_count``, an
    index in ``range(expected_count)`` with no file at all (the process
    died before its watchdog ever wrote).
    Each entry is ``{"process_index", "status": "no-heartbeat",
    "reason": "missing"|"unparseable"}`` — JSON-safe, so consumers
    (``classify``, ``ds_tpu_metrics``, the supervisor) can report the
    host instead of raising.
    """
    heartbeats = []
    unparseable = set()
    seen = set()
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        names = []
    for name in names:
        if not (name.startswith(_HB_PREFIX) and name.endswith(".json")):
            continue
        idx = _hb_index(name)
        hb = _read_heartbeat_file(os.path.join(directory, name))
        if hb is None:
            if idx is not None:
                unparseable.add(idx)
            continue
        if isinstance(hb, dict):
            heartbeats.append(hb)
            pi = hb.get("process_index")
            seen.add(idx if pi is None else pi)
        elif idx is not None:
            unparseable.add(idx)
    expected = range(int(expected_count)) if expected_count else \
        sorted(unparseable)
    no_heartbeat = [
        {"process_index": idx, "status": "no-heartbeat",
         "reason": "unparseable" if idx in unparseable else "missing"}
        for idx in expected if idx not in seen
    ]
    return heartbeats, no_heartbeat


def read_heartbeats(directory):
    """All parseable per-process heartbeat files in ``directory``."""
    return scan_heartbeats(directory)[0]


class HangWatchdog:
    """Daemon thread that turns "no progress" into a flight dump.

    The training-loop hooks (``step_start``/``step_end``/``beat``) are
    attribute stores only — no locks, no allocation — so the enabled
    steady-state overhead stays within the pinned <=1% budget.
    """

    def __init__(self, flight=None, deadline_factor=3.0, min_deadline_s=60.0,
                 action=WATCHDOG_ACTION_DUMP, heartbeat_dir=None,
                 process_index=0, process_count=1, hostname=None,
                 window=32, warmup_steps=2, poll_interval_s=None,
                 session=None, clock=time.monotonic):
        if action not in WATCHDOG_ACTIONS:
            raise ValueError(f"watchdog action must be one of "
                             f"{WATCHDOG_ACTIONS}, got {action!r}")
        self.flight = flight
        self.session = session
        self.deadline_factor = float(deadline_factor)
        self.min_deadline_s = float(min_deadline_s)
        self.action = action
        self.heartbeat_dir = heartbeat_dir
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.hostname = hostname or socket.gethostname()
        self.warmup_steps = max(1, int(warmup_steps))
        self._clock = clock
        self._walls = collections.deque(maxlen=int(window))
        if poll_interval_s is None:
            poll_interval_s = min(1.0, max(0.02, self.min_deadline_s / 10.0))
        self.poll_interval_s = float(poll_interval_s)
        # hot-path state (single-writer: the training thread)
        self._step = -1
        self._step_t0 = None
        self._beat_t = None
        self._beat_phase = None
        # watchdog-thread state
        self._fired_step = None
        self.fired = []          # record of firings (tests / postmortem)
        self._stop = threading.Event()
        self._thread = None

    # -- training-loop hooks (hot path: keep allocation-free) ----------
    def step_start(self, step):
        self._step = step
        self._beat_phase = "step"
        self._beat_t = self._step_t0 = self._clock()

    def step_end(self, step, wall_s):
        self._step_t0 = None
        self._beat_t = self._clock()
        self._walls.append(wall_s)

    def beat(self, phase):
        self._beat_phase = phase
        self._beat_t = self._clock()

    # -- deadline ------------------------------------------------------
    def median_wall(self):
        if not self._walls:
            return None
        walls = sorted(self._walls)
        n = len(walls)
        mid = n // 2
        if n % 2:
            return walls[mid]
        return 0.5 * (walls[mid - 1] + walls[mid])

    def deadline_s(self):
        """Current deadline, or None while fewer than ``warmup_steps``
        steps have completed (never fire on the compile step)."""
        if len(self._walls) < self.warmup_steps:
            return None
        return max(self.min_deadline_s,
                   self.deadline_factor * self.median_wall())

    # -- lifecycle -----------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="ds-tpu-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        self._write_heartbeat(final=True)

    def _run(self):
        while not self._stop.wait(self.poll_interval_s):
            try:
                self._write_heartbeat()
                self.check()
            except Exception as e:   # pragma: no cover - forensics never kills
                logger.warning("hang watchdog: poll failed (%s)", e)

    # -- heartbeat files -----------------------------------------------
    def _write_heartbeat(self, final=False):
        if not self.heartbeat_dir:
            return
        t0 = self._step_t0
        hb = {
            "t": time.time(),
            "hostname": self.hostname,
            "process_index": self.process_index,
            "pid": os.getpid(),
            "step": self._step,
            "phase": self._beat_phase,
            "in_step": t0 is not None and not final,
            "step_elapsed_s": round(self._clock() - t0, 3)
            if t0 is not None else 0.0,
        }
        try:
            os.makedirs(self.heartbeat_dir, exist_ok=True)
            path = heartbeat_path(self.heartbeat_dir, self.process_index)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(hb, f)
            os.replace(tmp, path)
        except OSError as e:   # pragma: no cover
            logger.warning("hang watchdog: heartbeat write failed (%s)", e)

    # -- firing --------------------------------------------------------
    def check(self, now=None):
        """One expiry check (the poll loop's body; callable from tests).
        Returns the firing record when the watchdog fires, else None."""
        t0 = self._step_t0
        if t0 is None:
            return None
        step = self._step
        if self._fired_step == step:
            return None
        deadline = self.deadline_s()
        if deadline is None:
            return None
        elapsed = (now if now is not None else self._clock()) - t0
        if elapsed <= deadline:
            return None
        self._fired_step = step
        verdict, stragglers = self.classify()
        fired = {
            "step": step,
            "phase": self._beat_phase,
            "elapsed_s": round(elapsed, 3),
            "deadline_s": round(deadline, 3),
            "median_wall_s": round(self.median_wall(), 6),
            "deadline_factor": self.deadline_factor,
            "verdict": verdict,
            "stragglers": stragglers,
            "action": self.action,
            "process_index": self.process_index,
            "hostname": self.hostname,
        }
        self.fired.append(fired)
        logger.warning(
            "hang watchdog: step %d stuck in %s for %.1fs "
            "(deadline %.1fs = max(%.1fs, %.1f x median %.3fs)) -> %s",
            step, self._beat_phase, elapsed, deadline, self.min_deadline_s,
            self.deadline_factor, self.median_wall() or 0.0, verdict)
        if self.session is not None:
            try:
                self.session.emit("watchdog", **fired)
            except Exception:   # pragma: no cover
                pass
        if self.flight is not None:
            self.flight.dump("watchdog", extra={"watchdog": fired})
        if self.action == WATCHDOG_ACTION_ABORT:
            self._abort()
        return fired

    def classify(self):
        """(verdict, stragglers): who to blame, from peer heartbeats.

        A peer is a straggler when it is on an earlier step, or on the
        same step with a beat at least half a deadline staler than ours
        — then we are ``waiting_on_straggler`` at the collective.
        Otherwise (no peers, or every peer at/above our step and fresh)
        the stall is local: ``this_host_stuck``. A peer with no
        parseable heartbeat at all (crashed before its watchdog ever
        wrote, or killed mid-write) is the prime suspect: it is listed
        first with ``status: "no-heartbeat"`` and null step fields.
        """
        if not self.heartbeat_dir or self.process_count <= 1:
            return VERDICT_THIS_HOST, []
        now = time.time()
        grace = 0.5 * (self.deadline_s() or self.min_deadline_s)
        mine = None
        peers = []
        heartbeats, no_heartbeat = scan_heartbeats(
            self.heartbeat_dir, expected_count=self.process_count)
        for hb in heartbeats:
            if hb.get("process_index") == self.process_index:
                mine = hb
            else:
                peers.append(hb)
        my_step = self._step
        my_age = now - mine["t"] if mine else 0.0
        stragglers = [
            {"process_index": gone["process_index"], "hostname": None,
             "step": None, "behind_steps": None, "phase": None,
             "beat_age_s": None, "status": "no-heartbeat",
             "reason": gone["reason"]}
            for gone in no_heartbeat
            if gone["process_index"] != self.process_index
        ]
        for hb in peers:
            step = hb.get("step", -1)
            age = now - hb.get("t", now)
            behind_steps = my_step - step
            if behind_steps > 0 or (behind_steps == 0 and
                                    age > my_age + grace):
                stragglers.append({
                    "process_index": hb.get("process_index"),
                    "hostname": hb.get("hostname"),
                    "step": step,
                    "behind_steps": behind_steps,
                    "phase": hb.get("phase"),
                    "beat_age_s": round(age, 3),
                })
        stragglers.sort(key=lambda s: (s.get("status") == "no-heartbeat",
                                       s.get("behind_steps") or 0,
                                       s.get("beat_age_s") or 0.0),
                        reverse=True)
        if stragglers:
            return VERDICT_STRAGGLER, stragglers
        return VERDICT_THIS_HOST, []

    def _abort(self):   # pragma: no cover - terminates the process
        try:
            import faulthandler
            faulthandler.dump_traceback(file=sys.stderr)
        except Exception:
            pass
        logger.error("hang watchdog: action=abort, raising SIGABRT")
        os.kill(os.getpid(), signal.SIGABRT)


class StepAnomalyDetector:
    """Rolling-baseline step-wall regression detector.

    ``observe(wall_s)`` returns a reason string when this step's wall
    exceeds ``factor`` x the rolling median of the previous ``window``
    steps (after ``min_history`` clean steps — the compile step never
    trips it), else None. The engine maps a trip — plus recompiles and
    guard trips, which arrive through their own emit sites — onto
    ``TraceProfiler.arm()``.
    """

    def __init__(self, factor=2.0, window=32, min_history=5):
        self.factor = float(factor)
        self.min_history = max(2, int(min_history))
        self._walls = collections.deque(maxlen=int(window))

    def observe(self, wall_s):
        walls = sorted(self._walls)
        reason = None
        if len(walls) >= self.min_history:
            mid = len(walls) // 2
            median = walls[mid] if len(walls) % 2 else \
                0.5 * (walls[mid - 1] + walls[mid])
            if median > 0 and wall_s > self.factor * median and \
                    math.isfinite(wall_s):
                reason = (f"step wall {wall_s * 1e3:.1f}ms > "
                          f"{self.factor:g} x median {median * 1e3:.1f}ms")
        # a regressed wall still enters the baseline: a real plateau
        # shift re-baselines instead of tripping forever
        self._walls.append(wall_s)
        return reason
