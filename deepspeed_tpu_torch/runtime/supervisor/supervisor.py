"""The worker-death classifiers of the ``ds_tpu_run`` supervisor (a copy
of ``done_path``, ``classify_exit`` and ``heartbeat_verdict`` from
``deepspeed_tpu/runtime/supervisor/supervisor.py:64-110``).

Worker contract: on clean completion a worker creates
``<workdir>/done-p<idx:05d>`` (:func:`done_path`); exit 0 without it
reads as a preemption. A live worker writes the hang watchdog's
heartbeat file ``hb-p<idx:05d>.json`` (``telemetry/watchdog.py``).
"""

import os

from deepspeed_tpu_torch.runtime.supervisor.state import (
    CAUSE_CRASH,
    CAUSE_HANG,
    CAUSE_PREEMPTION,
)


def done_path(workdir, index):
    """Path of the done marker worker ``index`` writes on completion."""
    return os.path.join(workdir, f"done-p{int(index):05d}")


def classify_exit(returncode, done_marker_exists):
    """Failure cause for an exited worker, or None.

    ``None`` while still running (``returncode is None``) or on a clean
    completion (exit 0 with the done marker); exit 0 without the marker
    reads as :data:`CAUSE_PREEMPTION`; any nonzero exit is
    :data:`CAUSE_CRASH`."""
    if returncode is None:
        return None
    if returncode == 0 and done_marker_exists:
        return None
    return CAUSE_PREEMPTION if returncode == 0 else CAUSE_CRASH


def heartbeat_verdict(hb, now, hang_timeout_s=None,
                      heartbeat_stale_s=None):
    """:data:`CAUSE_HANG` when a live process's heartbeat says it is
    stuck (``in_step`` past ``hang_timeout_s``) or has gone stale (last
    write older than ``heartbeat_stale_s``); None otherwise. ``hb`` is a
    parsed ``hb-p<idx>.json`` dict (or None: no verdict, a worker that
    has not started reporting is covered by its exit code)."""
    if hb is None:
        return None
    stuck = (hang_timeout_s is not None
             and hb.get("in_step")
             and float(hb.get("step_elapsed_s") or 0.0)
             > float(hang_timeout_s))
    stale = (heartbeat_stale_s is not None
             and now - float(hb.get("t") or now)
             > float(heartbeat_stale_s))
    return CAUSE_HANG if (stuck or stale) else None
