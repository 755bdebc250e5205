"""PyTorch serving engine (ring KV cache, flash decode).

- :mod:`.cache` — ring-buffer KV cache, optionally stored int8/fp8.
- :mod:`.engine` — the prefill and decode programs over GPT-2.
- :mod:`.scheduler` — continuous batching over an open-loop queue,
  emitting ``decode_step`` telemetry events.
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
from deepspeed_tpu_torch.inference.scheduler import (
    Completion,
    ContinuousBatchingScheduler,
    Request,
)

__all__ = ["KVCacheSpec", "cache_dtype_census", "init_kv_cache",
           "kv_cache_nbytes", "spec_for_model", "InferenceEngine",
           "Completion", "ContinuousBatchingScheduler", "Request"]
