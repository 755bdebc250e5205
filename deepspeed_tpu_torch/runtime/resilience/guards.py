"""Step health guards: NaN/Inf gradients, loss spikes, loss-scale
collapse (a copy of ``deepspeed_tpu/runtime/resilience/guards.py``:
torch-free host logic).

Detection is split between the device and the host:

- **NaN/Inf gradients** are detected on the device in the engine's
  gradient epilogue: when the guard is enabled the engine runs the
  finiteness check even for fp32 and bf16 runs (where it is normally
  skipped, one host read a step) and, for the ``skip_step`` action,
  folds the verdict into the overflow flag, so the existing overflow
  skip keeps the masters and the optimizer state.
- **Loss spike** and **scale collapse** are host-side: they need
  history across steps (a rolling loss median; consecutive steps at the
  minimum scale), which the per-step metrics already carry.

:meth:`StepHealthMonitor.observe` consumes one step's health signals
and returns the list of :class:`GuardTrip`\\ s; the *engine* executes
the configured action (``warn`` logs, ``skip_step`` happened on the
device, ``rollback_to_checkpoint`` goes down the restore ladder,
``abort`` raises :class:`HealthGuardAbort`). Trip counters are in the
engine's per-step metrics dict.
"""

import logging
import math
from collections import deque
from dataclasses import dataclass

logger = logging.getLogger(__name__)

ACTION_WARN = "warn"
ACTION_SKIP_STEP = "skip_step"
ACTION_ROLLBACK = "rollback_to_checkpoint"
ACTION_ABORT = "abort"
VALID_ACTIONS = (ACTION_WARN, ACTION_SKIP_STEP, ACTION_ROLLBACK,
                 ACTION_ABORT)

GUARD_NAN = "nan_grads"
GUARD_LOSS_SPIKE = "loss_spike"
GUARD_SCALE_COLLAPSE = "scale_collapse"


class HealthGuardAbort(RuntimeError):
    """A health guard with action=abort tripped; training must stop.
    Carries the :class:`GuardTrip` so supervisors can log the guard and
    the step."""

    def __init__(self, trip):
        super().__init__(f"health guard '{trip.guard}' aborted training at "
                         f"step {trip.step}: {trip.reason}")
        self.trip = trip


@dataclass(frozen=True)
class GuardTrip:
    guard: str      # GUARD_* name
    action: str     # ACTION_* the engine must take
    step: int       # engine global step the trip fired on
    reason: str     # human-readable diagnosis

    def as_event(self):
        """Flat payload for the telemetry ``health_guard`` event."""
        return {"guard": self.guard, "action": self.action,
                "step": self.step, "reason": self.reason}


class StepHealthMonitor:
    """Host-side health state machine fed once per optimizer step.

    ``nan_action`` / ``spike_action`` / ``collapse_action`` are ACTION_*
    strings or None (guard disabled). ``fp16_dynamic`` tells the NaN
    guard that gradient overflow is *expected* dynamics (the loss scaler
    handles it), so only a non-finite loss counts as a NaN trip there.
    """

    def __init__(self, nan_action=None, spike_action=None,
                 collapse_action=None, fp16_dynamic=False,
                 spike_window=20, spike_factor=10.0, spike_min_history=5,
                 collapse_patience=10, min_scale=1.0):
        self.nan_action = nan_action
        self.spike_action = spike_action
        self.collapse_action = collapse_action
        self.fp16_dynamic = fp16_dynamic
        self.spike_window = int(spike_window)
        self.spike_factor = float(spike_factor)
        self.spike_min_history = int(spike_min_history)
        self.collapse_patience = int(collapse_patience)
        self.min_scale = float(min_scale)

        self._loss_history = deque(maxlen=self.spike_window)
        self._steps_at_min_scale = 0
        self.trip_counts = {GUARD_NAN: 0, GUARD_LOSS_SPIKE: 0,
                            GUARD_SCALE_COLLAPSE: 0}

    def reset_history(self):
        """Called by the engine after a restore: pre-restore history
        would re-trip against post-restore losses."""
        self._loss_history.clear()
        self._steps_at_min_scale = 0

    def observe(self, step, loss, grad_nonfinite, cur_scale):
        """Feed one step's health signals; returns [GuardTrip, ...].

        ``loss`` is the host float loss, ``grad_nonfinite`` the device
        finiteness check's verdict, ``cur_scale`` the loss scale after
        this step's update (None for non-fp16 runs).
        """
        trips = []
        step = int(step)
        loss = float(loss)
        loss_bad = not math.isfinite(loss)

        if self.nan_action is not None:
            nonfinite = bool(grad_nonfinite) and not self.fp16_dynamic
            if nonfinite or loss_bad:
                what = "loss" if loss_bad else "gradients"
                trips.append(GuardTrip(
                    GUARD_NAN, self.nan_action, step,
                    f"non-finite {what} detected (loss={loss})"))
                self.trip_counts[GUARD_NAN] += 1

        if self.spike_action is not None and not loss_bad:
            if len(self._loss_history) >= self.spike_min_history:
                baseline = sorted(self._loss_history)[
                    len(self._loss_history) // 2]
                threshold = self.spike_factor * abs(baseline)
                if threshold > 0 and abs(loss) > threshold:
                    trips.append(GuardTrip(
                        GUARD_LOSS_SPIKE, self.spike_action, step,
                        f"loss {loss:.6g} exceeds {self.spike_factor}x the "
                        f"rolling median {baseline:.6g}"))
                    self.trip_counts[GUARD_LOSS_SPIKE] += 1
            self._loss_history.append(loss)

        if self.collapse_action is not None and cur_scale is not None:
            if float(cur_scale) <= self.min_scale:
                self._steps_at_min_scale += 1
            else:
                self._steps_at_min_scale = 0
            if self._steps_at_min_scale >= self.collapse_patience:
                trips.append(GuardTrip(
                    GUARD_SCALE_COLLAPSE, self.collapse_action, step,
                    f"loss scale pinned at min ({self.min_scale}) for "
                    f"{self._steps_at_min_scale} consecutive steps — every "
                    "step is overflowing"))
                self.trip_counts[GUARD_SCALE_COLLAPSE] += 1
                self._steps_at_min_scale = 0  # one trip per episode

        for t in trips:
            logger.warning("health guard trip: %s at step %d (action=%s): %s",
                           t.guard, t.step, t.action, t.reason)
        return trips

    def metrics(self):
        """Trip counters for the engine's per-step metrics dict."""
        return {
            "health/nan_trips": self.trip_counts[GUARD_NAN],
            "health/loss_spike_trips": self.trip_counts[GUARD_LOSS_SPIKE],
            "health/scale_collapse_trips":
                self.trip_counts[GUARD_SCALE_COLLAPSE],
        }
