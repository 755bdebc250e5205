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
  worker failures).
- :mod:`checksums` — per-leaf CRC32 stamps.
- :mod:`preemption` — the SIGTERM latch the serving fleet's workers
  check between steps.

Step health guards, the hot in-memory tier and the training engine's
preemption checkpoints are not ported yet.
"""

from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
    CheckpointCorruptError,
    CheckpointIOError,
    CheckpointManager,
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
    "HostAdamError",
    "RetryExhaustedError",
    "retry_with_backoff",
    "future_result_with_retry",
]
