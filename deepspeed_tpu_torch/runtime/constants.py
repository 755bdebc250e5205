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
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedTpuJobName"
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
# the resilience block (runtime/resilience/), JAX's keys and defaults:
# preemption-safe checkpoints, auto-resume, step health guards, the hot
# in-memory checkpoint tier and fault injection
RESILIENCE = "resilience"
RESILIENCE_AUTO_RESUME = "auto_resume"
RESILIENCE_AUTO_RESUME_DEFAULT = False
RESILIENCE_SAVE_DIR = "save_dir"
RESILIENCE_SAVE_DIR_DEFAULT = None
RESILIENCE_SAVE_INTERVAL_STEPS = "save_interval_steps"
RESILIENCE_SAVE_INTERVAL_STEPS_DEFAULT = 0  # 0 = no periodic saves
RESILIENCE_CHECKPOINT = "checkpoint"
RESILIENCE_CKPT_ASYNC_SAVE = "async_save"
RESILIENCE_CKPT_ASYNC_SAVE_DEFAULT = False
RESILIENCE_CKPT_KEEP_LAST_N = "keep_last_n"
RESILIENCE_CKPT_KEEP_LAST_N_DEFAULT = 0  # 0 = keep everything
RESILIENCE_CKPT_IO_RETRIES = "io_retries"
RESILIENCE_CKPT_IO_RETRIES_DEFAULT = 3
RESILIENCE_CKPT_IO_RETRY_BASE_S = "io_retry_base_s"
RESILIENCE_CKPT_IO_RETRY_BASE_S_DEFAULT = 0.05
RESILIENCE_CKPT_IO_TIMEOUT_S = "io_timeout_s"
RESILIENCE_CKPT_IO_TIMEOUT_S_DEFAULT = None  # None = no deadline
RESILIENCE_GUARDS = "guards"
RESILIENCE_GUARD_ACTION = "action"
RESILIENCE_GUARD_NAN = "nan_grads"
RESILIENCE_GUARD_NAN_ACTION_DEFAULT = None  # disabled
RESILIENCE_GUARD_LOSS_SPIKE = "loss_spike"
RESILIENCE_GUARD_LOSS_SPIKE_ACTION_DEFAULT = None  # disabled
RESILIENCE_GUARD_LOSS_SPIKE_WINDOW = "window"
RESILIENCE_GUARD_LOSS_SPIKE_WINDOW_DEFAULT = 20
RESILIENCE_GUARD_LOSS_SPIKE_FACTOR = "factor"
RESILIENCE_GUARD_LOSS_SPIKE_FACTOR_DEFAULT = 10.0
RESILIENCE_GUARD_LOSS_SPIKE_MIN_HISTORY = "min_history"
RESILIENCE_GUARD_LOSS_SPIKE_MIN_HISTORY_DEFAULT = 5
RESILIENCE_GUARD_SCALE_COLLAPSE = "scale_collapse"
RESILIENCE_GUARD_SCALE_COLLAPSE_ACTION_DEFAULT = None  # disabled
RESILIENCE_GUARD_SCALE_COLLAPSE_PATIENCE = "patience"
RESILIENCE_GUARD_SCALE_COLLAPSE_PATIENCE_DEFAULT = 10
RESILIENCE_PREEMPTION = "preemption"
RESILIENCE_PREEMPTION_SAVE_ON_SIGTERM = "save_on_sigterm"
RESILIENCE_PREEMPTION_SAVE_ON_SIGTERM_DEFAULT = False
RESILIENCE_FAULT_INJECTION = "fault_injection"
RESILIENCE_FAULT_INJECTION_ENABLED = "enabled"
RESILIENCE_FAULT_INJECTION_ENABLED_DEFAULT = False
RESILIENCE_HOT_CHECKPOINT = "hot_checkpoint"
RESILIENCE_HOT_ENABLED = "enabled"
RESILIENCE_HOT_ENABLED_DEFAULT = False
RESILIENCE_HOT_INTERVAL_STEPS = "interval_steps"
RESILIENCE_HOT_INTERVAL_STEPS_DEFAULT = 1
RESILIENCE_HOT_CAPACITY = "capacity"
RESILIENCE_HOT_CAPACITY_DEFAULT = 1
RESILIENCE_HOT_MIRROR_DIR = "mirror_dir"
RESILIENCE_HOT_MIRROR_DIR_DEFAULT = None  # None = RAM-only tier
RESILIENCE_HOT_MIRROR_KEEP = "mirror_keep"
RESILIENCE_HOT_MIRROR_KEEP_DEFAULT = 1
RESILIENCE_HOST_ADAM_RETRIES = "host_adam_retries"
RESILIENCE_HOST_ADAM_RETRIES_DEFAULT = 2
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
# Runtime telemetry (telemetry/, JAX's keys and defaults): metrics
# registry, step-phase spans, and the schema-versioned JSONL event log
# the ds_tpu_metrics CLI reads. Disabled by default: the engine's hot
# path then pays one no-op check per phase.
TELEMETRY = "telemetry"
TELEMETRY_ENABLED = "enabled"
TELEMETRY_ENABLED_DEFAULT = False
TELEMETRY_JSONL_PATH = "jsonl_path"
TELEMETRY_JSONL_PATH_DEFAULT = None  # None = in-memory ring only
TELEMETRY_CONSOLE = "console"
TELEMETRY_CONSOLE_DEFAULT = False
TELEMETRY_PROMETHEUS_TEXTFILE = "prometheus_textfile"
TELEMETRY_PROMETHEUS_TEXTFILE_DEFAULT = None
TELEMETRY_PROMETHEUS_WRITE_EVERY = "prometheus_write_every"
TELEMETRY_PROMETHEUS_WRITE_EVERY_DEFAULT = 20
# Bounded event ring (engine.metrics_history): last N step events kept
# in memory so tests/health guards can assert without file I/O.
TELEMETRY_HISTORY = "history"
TELEMETRY_HISTORY_DEFAULT = 256
# JAX stamps the compiled step's static facts (collective bytes, static
# peak memory, from its HLO) into the `compile` event; the port reads and
# checks the key and has no such facts (runtime/engine.py:
# _stamp_compile_facts lists what its compile event carries).
TELEMETRY_STAMP_STATIC_FACTS = "stamp_static_facts"
TELEMETRY_STAMP_STATIC_FACTS_DEFAULT = True
# Model flops per token for the MFU estimate (0 = unknown; the
# ds_tpu_metrics CLI can also supply it at read time).
TELEMETRY_FLOPS_PER_TOKEN = "flops_per_token"
TELEMETRY_FLOPS_PER_TOKEN_DEFAULT = 0

# Runtime forensics (telemetry/flight.py, telemetry/watchdog.py):
# setting crash_dump_dir turns on the flight recorder — a bounded
# black-box ring of events / span transitions / the step's collectives
# dumped atomically there (plus all-thread stacks) on unhandled
# exception, SIGTERM/SIGQUIT, guard-trip abort, or watchdog firing.
# It also holds per-process heartbeat files and watchdog dumps, so the
# nested watchdog block requires it.
TELEMETRY_CRASH_DUMP_DIR = "crash_dump_dir"
TELEMETRY_CRASH_DUMP_DIR_DEFAULT = None
TELEMETRY_FLIGHT_HISTORY = "flight_history"
TELEMETRY_FLIGHT_HISTORY_DEFAULT = 512
# Hang watchdog: daemon thread fed per-phase heartbeats from the span
# stack; fires when a step's elapsed wall exceeds
# max(min_deadline_s, deadline_factor * rolling-median step wall).
TELEMETRY_WATCHDOG = "watchdog"
TELEMETRY_WATCHDOG_ENABLED = "enabled"
TELEMETRY_WATCHDOG_ENABLED_DEFAULT = False
TELEMETRY_WATCHDOG_DEADLINE_FACTOR = "deadline_factor"
TELEMETRY_WATCHDOG_DEADLINE_FACTOR_DEFAULT = 3.0
TELEMETRY_WATCHDOG_MIN_DEADLINE_S = "min_deadline_s"
TELEMETRY_WATCHDOG_MIN_DEADLINE_S_DEFAULT = 60.0
# "dump" = flight dump once per hung step, run continues if the step
# ever completes; "abort" = dump + thread stacks + SIGABRT so a cluster
# supervisor restarts the process.
TELEMETRY_WATCHDOG_ACTION = "action"
TELEMETRY_WATCHDOG_ACTION_DEFAULT = "dump"
# Anomaly-triggered trace capture: a step-wall regression past factor x
# rolling median (or a guard trip) arms the profiling
# block's TraceProfiler to capture the next capture_steps steps.
TELEMETRY_ANOMALY_TRACE = "anomaly_trace"
TELEMETRY_ANOMALY_TRACE_ENABLED = "enabled"
TELEMETRY_ANOMALY_TRACE_ENABLED_DEFAULT = False
TELEMETRY_ANOMALY_TRACE_FACTOR = "factor"
TELEMETRY_ANOMALY_TRACE_FACTOR_DEFAULT = 2.0
TELEMETRY_ANOMALY_TRACE_WINDOW = "window"
TELEMETRY_ANOMALY_TRACE_WINDOW_DEFAULT = 32
TELEMETRY_ANOMALY_TRACE_CAPTURE_STEPS = "capture_steps"
TELEMETRY_ANOMALY_TRACE_CAPTURE_STEPS_DEFAULT = 3


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
