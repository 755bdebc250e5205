"""Deterministic fault injection: the serving, checkpoint, training and
host-Adam seams of ``deepspeed_tpu/runtime/resilience/fault_injection.py``.

A process-global registry of *armed* faults that the serving and
training paths probe at fixed seams. Every probe is a no-op unless a
test armed the matching fault.

- ``kill`` — :func:`maybe_kill` delivers a hard signal (default
  SIGKILL) to the process itself, inside the training engine's dispatch
  span (``op="step"``), the scheduler's decode step
  (``op="decode_step"``) or the engine's chunked-prefill loop
  (``op="prefill_chunk"``). It never raises: the process just dies.
- ``decode_exception`` — :func:`maybe_fail_decode` raises
  :class:`InjectedDecodeError` from inside the scheduler's decode step.
- ``page_corruption`` — :func:`corrupt_host_pages` tells the host page
  tier (`inference/paging.py:HostPageStore`) to flip one byte of a
  parked snapshot after its CRCs were stamped, so resume must detect it.
- ``io_failure`` — :func:`maybe_fail_io` raises :class:`InjectedIOError`
  (an ``OSError``) inside a checkpoint save or load, after the state
  files are staged and before the checkpoint is published.
- ``heartbeat_stall`` — :func:`heartbeat_stall_seconds` tells a serving
  replica worker to stop writing heartbeats for a while (it looks dead
  without dying).
- ``nan_grads`` — :func:`grad_fault_value` gives the training engine a
  NaN multiplier for its gradients at the armed steps (the engine reads
  it only with ``resilience.fault_injection.enabled``).
- ``preemption`` — :func:`preemption_due` tells the training engine, at
  the top of the armed step, to deliver itself a real SIGTERM (the
  installed preemption handler's path).
- ``host_adam`` — :func:`maybe_fail_host_adam` raises
  :class:`InjectedHostAdamError` when a host-Adam range update starts,
  before the C++ kernel touches any buffer.
- ``hang`` — :func:`hang_seconds` tells the training engine to sleep
  inside the dispatch span of the armed step (a stuck collective or a
  straggler, as the hang watchdog sees it).

The JAX file's ``inject_reshard_failure`` comes with elasticity.

Use :func:`clear_faults` to disarm everything between tests;
:func:`arm_from_env` arms a subprocess replica from
``DS_TPU_SERVE_INJECT``.
"""

import os
import signal
import threading

_lock = threading.Lock()
_faults = {}


class InjectedIOError(OSError):
    """Checkpoint I/O failure injected by the fault harness."""


class InjectedHostAdamError(RuntimeError):
    """Host-Adam worker failure injected by the fault harness, raised
    before the C++ kernel runs: the master and moment buffers are
    untouched, so a resubmission is exact (``host_state_clean``)."""

    host_state_clean = True


class InjectedDecodeError(RuntimeError):
    """Decode-step failure injected into the scheduler loop. Not caught
    inside the serving loop: a decode-step exception is a crash."""


def clear_faults():
    """Disarm all faults."""
    with _lock:
        _faults.clear()


def active_faults():
    """Names of the currently armed faults (for assertions in tests)."""
    with _lock:
        return sorted(_faults)


def inject_nan_grads(at_steps):
    """Arm NaN gradients for the given engine global steps (0-based)."""
    with _lock:
        _faults["nan_grads"] = {"at_steps": set(int(s) for s in at_steps)}


def grad_fault_value(step):
    """The multiplier folded into the gradients at ``step``: NaN where
    armed, else 1.0."""
    with _lock:
        entry = _faults.get("nan_grads")
        if entry is not None and int(step) in entry["at_steps"]:
            return float("nan")
    return 1.0


def simulate_preemption(at_step):
    """Arm a simulated preemption (SIGTERM) before engine step
    ``at_step``."""
    with _lock:
        _faults["preemption"] = {"at_step": int(at_step)}


def preemption_due(step):
    """True exactly once, when ``step`` reaches the armed preemption
    point."""
    with _lock:
        entry = _faults.get("preemption")
        if entry is not None and int(step) >= entry["at_step"]:
            _faults.pop("preemption", None)
            return True
    return False


def inject_hang(at_step, seconds):
    """Arm a one-shot host-side sleep of ``seconds`` inside the dispatch
    phase of engine global step ``at_step``."""
    with _lock:
        _faults["hang"] = {"at_step": int(at_step),
                           "seconds": float(seconds)}


def hang_seconds(step):
    """Seconds the engine should sleep at ``step`` (0.0 = not armed).
    Fires exactly once, at the first step >= the armed point."""
    with _lock:
        entry = _faults.get("hang")
        if entry is not None and int(step) >= entry["at_step"]:
            _faults.pop("hang", None)
            return entry["seconds"]
    return 0.0


KILL_OPS = ("step", "decode_step", "prefill_chunk")


def inject_kill(op="decode_step", at_step=None, signum=signal.SIGKILL):
    """Arm a hard self-delivered signal at the first ``op`` probe whose
    step (engine global step, scheduler decode step, or prefill chunk
    index) is >= ``at_step``. ``op="step"`` fires inside the training
    engine's dispatch span and must name its step (JAX's fires at the
    next step without one; the port refuses that, so a kill meant for a
    serving seam cannot land in a training step). The default SIGKILL
    cannot be caught, so no preemption handler, atexit hook or flight
    recorder runs."""
    if op not in KILL_OPS:
        raise ValueError(f"kill op must be one of {KILL_OPS}, got {op!r}")
    if op == "step" and at_step is None:
        raise ValueError("kill op 'step' needs at_step: the engine global "
                         "step to die in")
    with _lock:
        _faults[f"kill:{op}"] = {
            "at_step": None if at_step is None else int(at_step),
            "signum": int(signum),
        }


def maybe_kill(op, step=None):
    """Probe called at the kill seams; delivers the armed signal to this
    process (and for SIGKILL never returns)."""
    with _lock:
        entry = _faults.get(f"kill:{op}")
        if entry is None:
            return
        if entry["at_step"] is not None and (
                step is None or int(step) < entry["at_step"]):
            return
        _faults.pop(f"kill:{op}", None)
        signum = entry["signum"]
    os.kill(os.getpid(), signum)


def inject_decode_exception(at_step, times=1):
    """Arm ``times`` decode-step exceptions starting at the first
    scheduler step >= ``at_step``."""
    with _lock:
        _faults["decode_exception"] = {"at_step": int(at_step),
                                       "times": int(times)}


def maybe_fail_decode(step):
    """Probe called from inside the scheduler's decode step; raises
    :class:`InjectedDecodeError` while armed."""
    with _lock:
        entry = _faults.get("decode_exception")
        if entry is None or int(step) < entry["at_step"]:
            return
        entry["times"] -= 1
        _pop_if_exhausted("decode_exception", entry)
    raise InjectedDecodeError(
        f"injected decode-step failure at step {step}")


def _pop_if_exhausted(name, entry):
    if entry["times"] <= 0:
        _faults.pop(name, None)


def inject_page_corruption(session_id=None, times=1):
    """Arm host-page corruption: the next ``times`` sessions parked to
    the host tier (or only ``session_id``'s parks, when given) get one
    byte flipped AFTER their CRCs are stamped, so resume detects it."""
    with _lock:
        _faults["page_corruption"] = {
            "session_id": session_id, "times": int(times)}


def corrupt_host_pages(session_id):
    """Probe called by the host page store at park time; True when the
    harness wants this session's snapshot corrupted."""
    with _lock:
        entry = _faults.get("page_corruption")
        if entry is None:
            return False
        if entry["session_id"] is not None and \
                entry["session_id"] != session_id:
            return False
        entry["times"] -= 1
        _pop_if_exhausted("page_corruption", entry)
    return True


def inject_io_failure(op="save", times=1):
    """Arm ``times`` consecutive failures of checkpoint ``op`` ("save" or
    "load")."""
    with _lock:
        _faults[f"io_failure:{op}"] = {"times": int(times)}


def maybe_fail_io(op):
    """Probe called from inside checkpoint I/O; raises if armed."""
    with _lock:
        name = f"io_failure:{op}"
        entry = _faults.get(name)
        if entry is None:
            return
        entry["times"] -= 1
        _pop_if_exhausted(name, entry)
    raise InjectedIOError(f"injected checkpoint {op} failure")


def inject_host_adam_failure(times=1):
    """Arm ``times`` consecutive host-Adam range-update failures."""
    with _lock:
        _faults["host_adam"] = {"times": int(times)}


def maybe_fail_host_adam():
    """Probe called as a host-Adam range update starts; raises if
    armed."""
    with _lock:
        entry = _faults.get("host_adam")
        if entry is None:
            return
        entry["times"] -= 1
        _pop_if_exhausted("host_adam", entry)
    raise InjectedHostAdamError("injected host-Adam worker failure")


# --------------------------------------------------------------------------
# Serving: heartbeat stall (replica looks dead without dying)
# --------------------------------------------------------------------------

def inject_heartbeat_stall(at_step, seconds):
    """Arm a one-shot heartbeat blackout: from the first scheduler step
    >= ``at_step`` the replica worker suppresses heartbeat writes for
    ``seconds`` while continuing to serve."""
    with _lock:
        _faults["heartbeat_stall"] = {"at_step": int(at_step),
                                      "seconds": float(seconds)}


def heartbeat_stall_seconds(step):
    """Seconds the replica should suppress heartbeat writes starting at
    ``step`` (0.0 = not armed). Fires exactly once."""
    with _lock:
        entry = _faults.get("heartbeat_stall")
        if entry is not None and int(step) >= entry["at_step"]:
            _faults.pop("heartbeat_stall", None)
            return entry["seconds"]
    return 0.0


# --------------------------------------------------------------------------
# Env-var arming (subprocess serving replicas)
# --------------------------------------------------------------------------

INJECT_ENV = "DS_TPU_SERVE_INJECT"


def arm_from_env(env=None):
    """Arm faults described by the ``DS_TPU_SERVE_INJECT`` env var, a
    JSON object like ``{"kill": {"op": "decode_step", "at_step": 4},
    "decode_exception": {"at_step": 2}, "heartbeat_stall": {"at_step":
    3, "seconds": 30}, "page_corruption": {}}``. Subprocess replica
    workers call this on startup (first attempt only); returns the list
    of armed fault names."""
    import json
    raw = (env if env is not None else os.environ).get(INJECT_ENV)
    if not raw:
        return []
    spec = json.loads(raw)
    armed = []
    if "kill" in spec:
        k = spec["kill"] or {}
        inject_kill(op=k.get("op", "decode_step"),
                    at_step=k.get("at_step"),
                    signum=int(k.get("signum", signal.SIGKILL)))
        armed.append("kill")
    if "decode_exception" in spec:
        d = spec["decode_exception"] or {}
        inject_decode_exception(at_step=d.get("at_step", 0),
                                times=d.get("times", 1))
        armed.append("decode_exception")
    if "heartbeat_stall" in spec:
        h = spec["heartbeat_stall"] or {}
        inject_heartbeat_stall(at_step=h.get("at_step", 0),
                               seconds=h.get("seconds", 60.0))
        armed.append("heartbeat_stall")
    if "page_corruption" in spec:
        p = spec["page_corruption"] or {}
        inject_page_corruption(session_id=p.get("session_id"),
                               times=p.get("times", 1))
        armed.append("page_corruption")
    return armed
