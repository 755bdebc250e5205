"""Resilience (port of ``deepspeed_tpu/runtime/resilience``):
preemption-safe checkpoints, retry with backoff and deterministic fault
injection.

- :mod:`checkpoint` — atomic (tmp dir + rename) checkpoint writes with a
  per-leaf CRC32 manifest, retention GC, load-time validation and
  newest-valid fallback, retry around all I/O, optional async saves.
- :mod:`retry` — bounded retry-with-backoff used by checkpoint I/O and
  the offload host-Adam futures.
- :mod:`fault_injection` — deterministic fault hooks (serving kills and
  decode failures, page corruption, checkpoint I/O failures, host-Adam
  worker failures, the training engine's NaN gradients and
  preemption).
- :mod:`checksums` — per-leaf CRC32 stamps.
- :mod:`preemption` — the SIGTERM latch the serving fleet's workers
  and the training engine check between steps, and
  :class:`PreemptedError`.
- :mod:`guards` — step health guards (NaN gradients, loss spikes,
  loss-scale collapse) and their actions.
- :mod:`hotckpt` — the in-memory hot checkpoint tier (CRC-stamped host
  snapshots, an optional local mirror), the first rung of the training
  engine's restore ladder (hot RAM, hot mirror, disk).
"""

from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
    CheckpointCorruptError,
    CheckpointIOError,
    CheckpointManager,
)
from deepspeed_tpu_torch.runtime.resilience.guards import (
    GuardTrip,
    HealthGuardAbort,
    StepHealthMonitor,
)
from deepspeed_tpu_torch.runtime.resilience.hotckpt import (
    HotCheckpointCorruptError,
    HotCheckpointStore,
)
from deepspeed_tpu_torch.runtime.resilience.preemption import (
    PreemptedError,
    PreemptionHandler,
)
from deepspeed_tpu_torch.runtime.resilience.retry import (
    HostAdamError,
    RetryExhaustedError,
    future_result_with_retry,
    retry_with_backoff,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointIOError",
    "CheckpointManager",
    "GuardTrip",
    "HealthGuardAbort",
    "HotCheckpointCorruptError",
    "HotCheckpointStore",
    "PreemptedError",
    "PreemptionHandler",
    "StepHealthMonitor",
    "HostAdamError",
    "RetryExhaustedError",
    "retry_with_backoff",
    "future_result_with_retry",
]
