"""Deterministic fault injection: the serving seams of
``deepspeed_tpu/runtime/resilience/fault_injection.py``.

A process-global registry of *armed* faults that the serving path
probes at fixed seams. Every probe is a no-op unless a test armed the
matching fault.

- ``kill`` — :func:`maybe_kill` delivers a hard signal (default
  SIGKILL) to the process itself, inside the scheduler's decode step
  (``op="decode_step"``) or the engine's chunked-prefill loop
  (``op="prefill_chunk"``). It never raises: the process just dies.
- ``decode_exception`` — :func:`maybe_fail_decode` raises
  :class:`InjectedDecodeError` from inside the scheduler's decode step.

Use :func:`clear_faults` to disarm everything between tests.
"""

import os
import signal
import threading

_lock = threading.Lock()
_faults = {}


class InjectedDecodeError(RuntimeError):
    """Decode-step failure injected into the scheduler loop. Not caught
    inside the serving loop: a decode-step exception is a crash."""


def clear_faults():
    """Disarm all faults."""
    with _lock:
        _faults.clear()


KILL_OPS = ("decode_step", "prefill_chunk")


def inject_kill(op="decode_step", at_step=None, signum=signal.SIGKILL):
    """Arm a hard self-delivered signal at the first ``op`` probe whose
    step (scheduler decode step, or prefill chunk index) is >=
    ``at_step``."""
    if op not in KILL_OPS:
        raise ValueError(f"kill op must be one of {KILL_OPS}, got {op!r}")
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
        if entry["times"] <= 0:
            _faults.pop("decode_exception", None)
    raise InjectedDecodeError(
        f"injected decode-step failure at step {step}")
