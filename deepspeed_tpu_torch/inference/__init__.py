"""PyTorch serving engine (ring or paged KV cache, flash decode,
self-speculative decoding, a replica fleet, disaggregated tiers).

- :mod:`.cache` — ring-buffer KV cache and the paged pool, optionally
  stored int8/fp8.
- :mod:`.engine` — the prefill and decode programs over GPT-2, and the
  host page tier's gather/scatter.
- :mod:`.paging` — page allocator, radix prefix cache, host page store
  and the paged cache manager.
- :mod:`.speculative` — the draft and verify programs.
- :mod:`.scheduler` — continuous batching over an open-loop queue,
  emitting ``decode_step`` telemetry events.
- :mod:`.router` / :mod:`.fleet` / :mod:`.fleet_worker` — multi-replica
  serving: an admission router owning the global queue in front of N
  replicas (worker processes or in-process threads), with heartbeat
  health checks, dead-replica drain and redispatch, deadlines and
  backpressure.
- :mod:`.disagg` — disaggregated serving: prefill and decode tiers and
  the KV handoff between them.
- :mod:`.serve` — the serve CLI
  (``python -m deepspeed_tpu_torch.inference.serve``).
"""

from deepspeed_tpu_torch.inference.cache import (
    KVCacheSpec,
    cache_dtype_census,
    init_kv_cache,
    kv_cache_nbytes,
    spec_for_model,
)
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.fleet import (
    ProcessReplica,
    ThreadReplica,
    build_process_fleet,
)
from deepspeed_tpu_torch.inference.paging import HostPageCorruptError
from deepspeed_tpu_torch.inference.router import (
    FleetResult,
    FleetRouter,
    RequestAbortedError,
)
from deepspeed_tpu_torch.inference.scheduler import (
    Completion,
    ContinuousBatchingScheduler,
    Request,
)

__all__ = ["KVCacheSpec", "cache_dtype_census", "init_kv_cache",
           "kv_cache_nbytes", "spec_for_model", "InferenceEngine",
           "ProcessReplica", "ThreadReplica", "build_process_fleet",
           "HostPageCorruptError", "FleetResult", "FleetRouter",
           "RequestAbortedError", "Completion",
           "ContinuousBatchingScheduler", "Request"]
