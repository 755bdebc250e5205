"""ZeRO config keys and defaults (a copy of
``deepspeed_tpu/runtime/zero/constants.py``; same names, same values).

The bucket-size and stage-3 schedule knobs are accepted for config
compatibility; the port runs ZeRO-Offload on one device and nothing of
the sharded stages yet.
"""

ZERO_FORMAT = """
ZeRO optimization should be enabled as:
"zero_optimization": {
  "stage": [0|1|2|3],
  "allgather_partitions": [true|false],
  "allgather_bucket_size": 500000000,
  "reduce_scatter": [true|false],
  "contiguous_gradients": [true|false],
  "overlap_comm": [true|false],
  "reduce_bucket_size": 500000000,
  "load_from_fp32_weights": [true|false],
  "cpu_offload": [true|false],
  "gather_on_use": [true|false],
  "gather_chunks": 1,
  "prefetch": [true|false],
  "bidirectional": [true|false]
}
"""

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
# The reference caps at stage 2 (`zero/constants.py:33`); the TPU framework
# also implements stage 3 (parameter sharding) since on TPU it is the same
# GSPMD annotation mechanism.
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS

ZERO_OPTIMIZATION_STAGE = "stage"
ZERO_OPTIMIZATION_STAGE_DEFAULT = ZERO_OPTIMIZATION_DISABLED

ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS = "allgather_partitions"
ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT = True

ZERO_OPTIMIZATION_REDUCE_SCATTER = "reduce_scatter"
ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT = True

ZERO_OPTIMIZATION_OVERLAP_COMM = "overlap_comm"
ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT = False

ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT = False

ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT = 500000000

ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT = 500000000
ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED = "allgather_size"

ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS = "load_from_fp32_weights"
ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT = True

ZERO_OPTIMIZATION_CPU_OFFLOAD = "cpu_offload"
ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT = False

# Move device->host gradients at 16 bit (the reference ALWAYS moves fp16
# grads to pinned host memory, stage2.py:793; fp32 here is the stricter
# default, 16-bit halves the D2H wire for big offload models).
ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS = "offload_16bit_grads"
ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS_DEFAULT = False

ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT = "elastic_checkpoint"
ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT = True

# Chunk size (MB of fp32 elements) of the offload host-phase pipeline:
# D2H of chunk k+1 overlaps the C++ Adam + bf16 convert (+ the chunked
# param H2D upload) of chunk k. Smaller chunks overlap at finer grain
# but pay more per-call overhead; the reference's analogous knob buckets
# its async grad copies (stage2.py allreduce/allgather bucket sizes).
ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB = "offload_chunk_mb"
ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB_DEFAULT = 64

# --- stage-3 gather-on-use schedule ---------------------------------------
# When True (and stage >= 3 with a 16-bit compute dtype), parameters are
# all-gathered explicitly at point of use through the ring primitives in
# `parallel/collectives.py` instead of leaving gather placement to GSPMD.
# False falls back to the legacy spec-sharded caster
# (`zero/sharding.py:make_param_caster`) — kept as the A/B baseline.
ZERO_OPTIMIZATION_GATHER_ON_USE = "gather_on_use"
ZERO_OPTIMIZATION_GATHER_ON_USE_DEFAULT = True

# Ring chunking of each per-leaf gather: 1 = a single tiled all-gather
# (bit-identical to the spec-sharded baseline); k > 1 splits every leaf
# into k stripes moved by dep-chained ppermute rings so stripe transfers
# interleave with the consuming matmuls.
ZERO_OPTIMIZATION_GATHER_CHUNKS = "gather_chunks"
ZERO_OPTIMIZATION_GATHER_CHUNKS_DEFAULT = 1

# Dep-chain the per-leaf gathers so leaf i+1's gather is issued behind
# leaf i's (the prefetch schedule). Required when gather_chunks > 1: the
# chain is also the rendezvous-safety invariant for concurrent rings.
ZERO_OPTIMIZATION_PREFETCH = "prefetch"
ZERO_OPTIMIZATION_PREFETCH_DEFAULT = True

# Alternate ring direction per chunk so both link directions carry
# stripes simultaneously (even stripes clockwise, odd counter-clockwise).
ZERO_OPTIMIZATION_BIDIRECTIONAL = "bidirectional"
ZERO_OPTIMIZATION_BIDIRECTIONAL_DEFAULT = False

ZERO_OPTIMIZATION_DEFAULT = {
    ZERO_OPTIMIZATION_STAGE: ZERO_OPTIMIZATION_STAGE_DEFAULT,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS:
        ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_SCATTER: ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE:
        ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS:
        ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE:
        ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS:
        ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT,
    ZERO_OPTIMIZATION_CPU_OFFLOAD: ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT,
    ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS:
        ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS_DEFAULT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT:
        ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT,
    ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB:
        ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB_DEFAULT,
    ZERO_OPTIMIZATION_GATHER_ON_USE:
        ZERO_OPTIMIZATION_GATHER_ON_USE_DEFAULT,
    ZERO_OPTIMIZATION_GATHER_CHUNKS:
        ZERO_OPTIMIZATION_GATHER_CHUNKS_DEFAULT,
    ZERO_OPTIMIZATION_PREFETCH: ZERO_OPTIMIZATION_PREFETCH_DEFAULT,
    ZERO_OPTIMIZATION_BIDIRECTIONAL:
        ZERO_OPTIMIZATION_BIDIRECTIONAL_DEFAULT,
}
