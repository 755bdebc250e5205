"""DeepSpeed JSON config keys and defaults read by the dense training
path and the sparse-attention section (a copy of the matching entries of
``deepspeed_tpu/runtime/constants.py``; same names, same values)."""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer and lr scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

#############################################
# FP16 / BF16
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False

#############################################
# Gradient clipping
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# Sparse attention
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = SPARSE_FIXED_MODE
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3


#############################################
# Top-level keys the JAX config reads (deepspeed_tpu/runtime/constants.py)
#############################################
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False
FP32_ALLREDUCE = "fp32_allreduce"
FP32_ALLREDUCE_DEFAULT = False
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
VOCABULARY_SIZE = "vocabulary_size"
VOCABULARY_SIZE_DEFAULT = None
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
TENSORBOARD = "tensorboard"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
PROFILING = "profiling"
COMPILATION_CACHE_DIR = "compilation_cache_dir"
PIPELINE = "pipeline"
PIPELINE_STAGES = "stages"
PIPELINE_STAGES_DEFAULT = None
PIPELINE_PARTITION = "partition"
PIPELINE_PARTITION_DEFAULT = "best"
PIPELINE_SEED_LAYERS = "seed_layers"
PIPELINE_SEED_LAYERS_DEFAULT = False
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL = "activation_checkpoint_interval"
PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT = 0
MESH = "mesh"
MESH_DEFAULT = None
# the int8 chunk-scaled gradient all-reduce (runtime/comm/quantized.py),
# JAX's keys and defaults
COMM_QUANTIZATION = "comm_quantization"
COMM_QUANTIZATION_ENABLED = "enabled"
COMM_QUANTIZATION_ENABLED_DEFAULT = False
COMM_QUANTIZATION_BITS = "bits"
COMM_QUANTIZATION_BITS_DEFAULT = 8
COMM_QUANTIZATION_CHUNK_SIZE = "chunk_size"
COMM_QUANTIZATION_CHUNK_SIZE_DEFAULT = 512
COMM_QUANTIZATION_BUCKET_MB = "bucket_mb"
COMM_QUANTIZATION_BUCKET_MB_DEFAULT = 4
COMM_QUANTIZATION_ERROR_FEEDBACK = "error_feedback"
COMM_QUANTIZATION_ERROR_FEEDBACK_DEFAULT = False
RESILIENCE = "resilience"
ELASTICITY = "elasticity"
ANALYSIS = "analysis"
TENSOR_PARALLEL = "tensor_parallel"
# the overlap block of the TP layers' collective matmuls
# (parallel/collectives.py), JAX's keys and defaults
TP_OVERLAP = "overlap"
TP_OVERLAP_ENABLED = "enabled"
TP_OVERLAP_ENABLED_DEFAULT = False
TP_OVERLAP_CHUNKS = "chunks"
TP_OVERLAP_CHUNKS_DEFAULT = 4
TP_OVERLAP_BIDIRECTIONAL = "bidirectional"
TP_OVERLAP_BIDIRECTIONAL_DEFAULT = False
TP_OVERLAP_SITES = "sites"
TP_OVERLAP_SITES_DEFAULT = None  # None = no per-site overrides
TP_OVERLAP_WIRE_DTYPE = "wire_dtype"
TP_OVERLAP_WIRE_DTYPE_DEFAULT = None
TP_OVERLAP_WIRE_CHUNK = "wire_chunk"
TP_OVERLAP_WIRE_CHUNK_DEFAULT = 512
FP8 = "fp8"
FP8_ENABLED = "enabled"
FP8_ENABLED_DEFAULT = False
FP8_MARGIN = "margin"
FP8_MARGIN_DEFAULT = 0
FP8_AMAX_HISTORY_LEN = "amax_history_len"
FP8_AMAX_HISTORY_LEN_DEFAULT = 16
FP8_SITES = "sites"
FP8_SITES_DEFAULT = None         # None = no per-site overrides
FP8_WIRE = "wire"
FP8_WIRE_ENABLED = "enabled"
FP8_WIRE_ENABLED_DEFAULT = False
FP8_WIRE_DTYPE = "dtype"
FP8_WIRE_DTYPE_DEFAULT = "f8e4m3fn"
FP8_WIRE_CHUNK_SIZE = "chunk_size"
FP8_WIRE_CHUNK_SIZE_DEFAULT = 512
TELEMETRY = "telemetry"


#############################################
# Inference / serving (``inference/``): the ``inference`` block's keys
# and defaults, as ``deepspeed_tpu/runtime/constants.py`` has them
# (``InferenceConfig`` in ``runtime/config.py`` documents each)
#############################################
INFERENCE = "inference"
INFERENCE_MAX_BATCH = "max_batch"
INFERENCE_MAX_BATCH_DEFAULT = 8
INFERENCE_SEQ_BUCKETS = "seq_buckets"
INFERENCE_SEQ_BUCKETS_DEFAULT = (128, 512)
INFERENCE_PREFILL_CHUNK = "prefill_chunk"
INFERENCE_PREFILL_CHUNK_DEFAULT = 32
INFERENCE_KV_CACHE_DTYPE = "kv_cache_dtype"
INFERENCE_KV_CACHE_DTYPE_DEFAULT = None
INFERENCE_MAX_NEW_TOKENS = "max_new_tokens"
INFERENCE_MAX_NEW_TOKENS_DEFAULT = 64
INFERENCE_ATTENTION_IMPL = "attention_impl"
INFERENCE_ATTENTION_IMPL_DEFAULT = "dense"
INFERENCE_ATTENTION_BLOCK_K = "attention_block_k"
INFERENCE_ATTENTION_BLOCK_K_DEFAULT = 128
INFERENCE_TEMPERATURE = "temperature"
INFERENCE_TEMPERATURE_DEFAULT = 0.0
INFERENCE_TOP_K = "top_k"
INFERENCE_TOP_K_DEFAULT = 0
INFERENCE_TOP_P = "top_p"
INFERENCE_TOP_P_DEFAULT = 1.0
INFERENCE_SAMPLING_SEED = "sampling_seed"
INFERENCE_SAMPLING_SEED_DEFAULT = 0
INFERENCE_KV_LAYOUT = "kv_layout"
INFERENCE_KV_LAYOUT_DEFAULT = "ring"
INFERENCE_PAGE_SIZE = "page_size"
INFERENCE_PAGE_SIZE_DEFAULT = 0
INFERENCE_N_PAGES = "n_pages"
INFERENCE_N_PAGES_DEFAULT = 0
INFERENCE_PREFIX_CACHE = "prefix_cache"
INFERENCE_PREFIX_CACHE_DEFAULT = True
INFERENCE_HOST_PARK_THRESHOLD = "host_park_threshold"
INFERENCE_HOST_PARK_THRESHOLD_DEFAULT = 0.25
INFERENCE_REPLICAS = "replicas"
INFERENCE_REPLICAS_DEFAULT = 1
INFERENCE_MAX_REDISPATCH = "max_redispatch"
INFERENCE_MAX_REDISPATCH_DEFAULT = 2
INFERENCE_MAX_QUEUE_DEPTH = "max_queue_depth"
INFERENCE_MAX_QUEUE_DEPTH_DEFAULT = 8
INFERENCE_DEADLINE_S = "deadline_s"
INFERENCE_DEADLINE_S_DEFAULT = 0.0
INFERENCE_QUEUE_TIMEOUT_S = "queue_timeout_s"
INFERENCE_QUEUE_TIMEOUT_S_DEFAULT = 0.0
INFERENCE_DISAGGREGATED = "disaggregated"
INFERENCE_DISAGGREGATED_DEFAULT = False
INFERENCE_PREFILL_WORKERS = "prefill_workers"
INFERENCE_PREFILL_WORKERS_DEFAULT = 1
INFERENCE_DECODE_WORKERS = "decode_workers"
INFERENCE_DECODE_WORKERS_DEFAULT = 1
INFERENCE_PREFILL_MAX_BATCH = "prefill_max_batch"
INFERENCE_PREFILL_MAX_BATCH_DEFAULT = 0
INFERENCE_DECODE_MAX_BATCH = "decode_max_batch"
INFERENCE_DECODE_MAX_BATCH_DEFAULT = 0
INFERENCE_SPECULATIVE = "speculative"
INFERENCE_SPECULATIVE_ENABLED = "enabled"
INFERENCE_SPECULATIVE_ENABLED_DEFAULT = False
INFERENCE_SPECULATIVE_K = "k"
INFERENCE_SPECULATIVE_K_DEFAULT = 4
INFERENCE_SPECULATIVE_DRAFT_LAYERS = "draft_layers"
INFERENCE_SPECULATIVE_DRAFT_LAYERS_DEFAULT = 0
INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW = "min_accept_to_grow"
INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW_DEFAULT = 0.0
