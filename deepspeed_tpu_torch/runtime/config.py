"""DeepSpeed JSON/dict config, dense training subset (port of
``deepspeed_tpu/runtime/config.py`` and ``config_utils.py``).

Ported: the batch triple solver (``train_batch_size = micro_batch *
grad_accum * world_size``) and ``_batch_assertion``, ``fp16`` / ``bf16``
with the loss-scale arguments, the ``optimizer`` and ``scheduler``
sections (``optimizer.params.pallas`` accepted; every step runs the fused
kernel K4), ``gradient_clipping``, ``steps_per_print`` and the
``sparse_attention`` section (:func:`get_sparse_attention`), the
``zero_optimization`` section (:class:`DeepSpeedZeroConfig`): stages 0-3
over the data-parallel processes (``world_size`` is the process group's),
with or without ZeRO-Offload (``cpu_offload: true``), ``gather_on_use``,
``prefetch``, ``gather_chunks`` and ``bidirectional`` (the stage-3
gather's schedule, ``runtime/zero/stage3.py``), and the ``inference``
block (:class:`InferenceConfig`, with the JAX package's checks).

The top-level keys the JAX config reads and leaves to the engine's
discretion are read with its meaning: ``prescale_gradients`` and
``gradient_predivide_factor`` are no-ops (the cross-process mean runs in
fp32, JAX ``engine.py:1115-1121``), ``fp32_allreduce`` and
``disable_allgather`` are read and unused, ``zero_allow_untested_optimizer``
and ``dump_state`` are plain reads (``dump_state`` logs the config),
``vocabulary_size`` warns when not a multiple of 8, ``amp`` computes in
bf16 (JAX ``engine.py:416``), ``wall_clock_breakdown`` logs each step's
synchronized wall and ``memory_breakdown`` adds the CUDA allocator's
figures to that line (``telemetry/timers.py``).

The operations keys: ``telemetry`` (:class:`TelemetryConfig`, JAX's
keys, defaults and checks), ``profiling`` (the ``torch.profiler`` trace
window, ``telemetry/profiler.py``), ``tensorboard`` (``enabled``,
``output_path``, ``job_name``: the engine's scalars through
``torch.utils.tensorboard``) and ``compilation_cache_dir`` (the
directory of the kernel builds, ``telemetry/compile_cache.py``).

The training-feature keys: ``activation_checkpointing``
(:class:`~deepspeed_tpu_torch.runtime.activation_checkpointing.config.
DeepSpeedActivationCheckpointingConfig`), ``progressive_layer_drop``
(``enabled`` and the schedule's ``theta`` / ``gamma``),
``sparse_gradients`` and ``fp8`` (:class:`Fp8Config`, with the JAX
package's checks: fp8 is incompatible with OneBitAdam, sparse gradients
and ZeRO-Offload).

The gradient compressors: ``comm_quantization`` (:class:`CommQuantization
Config`, the int8 all-reduce of ``runtime/comm/quantized.py``, with JAX's
checks: 8 bits, an even chunk, ZeRO <= 2, not with OneBitAdam, sparse
gradients, offload or the fp8 wire) and ``optimizer.type: OneBitAdam``
(``runtime/fp16/onebit_adam.py``, ``freeze_step`` among its params).

The pipeline keys: ``pipeline`` (``stages``, ``partition``,
``seed_layers``, ``activation_checkpoint_interval``, read with JAX's
defaults as ``config.pipeline``) and ``mesh`` (``config.mesh_shape``);
``runtime/pipe/engine.py`` reads both.

The ``resilience`` block (:class:`ResilienceConfig`, JAX's keys, defaults
and checks) configures the engine's preemption-safe checkpoints, the
restore ladder, the step health guards and fault injection.

The keys whose features later work ports raise "not yet ported" with the
``ROADMAP.md`` item that ports them (:data:`_LATER_KEYS`); any other key
raises as unknown. Key names and error texts are the JAX package's.
"""

import collections
import json

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.constants import (
    BF16, BF16_ENABLED, BF16_ENABLED_DEFAULT, FP16, FP16_ENABLED,
    FP16_ENABLED_DEFAULT, FP16_HYSTERESIS, FP16_HYSTERESIS_DEFAULT,
    FP16_INITIAL_SCALE_POWER, FP16_INITIAL_SCALE_POWER_DEFAULT,
    FP16_LOSS_SCALE, FP16_LOSS_SCALE_DEFAULT, FP16_LOSS_SCALE_WINDOW,
    FP16_LOSS_SCALE_WINDOW_DEFAULT, FP16_MIN_LOSS_SCALE,
    FP16_MIN_LOSS_SCALE_DEFAULT, GRADIENT_ACCUMULATION_STEPS,
    GRADIENT_ACCUMULATION_STEPS_DEFAULT, GRADIENT_CLIPPING,
    GRADIENT_CLIPPING_DEFAULT, OPTIMIZER, OPTIMIZER_PARAMS,
    OPTIMIZER_TYPE_DEFAULT, SCHEDULER, SCHEDULER_PARAMS,
    SCHEDULER_TYPE_DEFAULT, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT,
    TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT,
    TRAIN_MICRO_BATCH_SIZE_PER_GPU, TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT,
    TYPE, SPARSE_ATTENTION, SPARSE_ATTENTION_TYPE,
    SPARSE_ATTENTION_TYPE_DEFAULT, SPARSE_BIGBIRD_MODE, SPARSE_BLOCK,
    SPARSE_BLOCK_DEFAULT, SPARSE_BSLONGFORMER_MODE, SPARSE_DENSE_MODE,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT, SPARSE_FIXED_MODE,
    SPARSE_GLOBAL_BLOCK_END_INDICES, SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT,
    SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT, SPARSE_LOCAL_WINDOW_BLOCKS,
    SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT, SPARSE_MODE, SPARSE_MODE_DEFAULT,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT, SPARSE_NUM_GLOBAL_BLOCKS,
    SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT, SPARSE_NUM_LOCAL_BLOCKS,
    SPARSE_NUM_LOCAL_BLOCKS_DEFAULT, SPARSE_NUM_RANDOM_BLOCKS,
    SPARSE_NUM_RANDOM_BLOCKS_DEFAULT, SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
    SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT, SPARSE_VARIABLE_MODE)
from deepspeed_tpu_torch.runtime.constants import (
    INFERENCE, INFERENCE_ATTENTION_BLOCK_K,
    INFERENCE_ATTENTION_BLOCK_K_DEFAULT, INFERENCE_ATTENTION_IMPL,
    INFERENCE_ATTENTION_IMPL_DEFAULT, INFERENCE_DEADLINE_S,
    INFERENCE_DEADLINE_S_DEFAULT, INFERENCE_DECODE_MAX_BATCH,
    INFERENCE_DECODE_MAX_BATCH_DEFAULT, INFERENCE_DECODE_WORKERS,
    INFERENCE_DECODE_WORKERS_DEFAULT, INFERENCE_DISAGGREGATED,
    INFERENCE_DISAGGREGATED_DEFAULT, INFERENCE_HOST_PARK_THRESHOLD,
    INFERENCE_HOST_PARK_THRESHOLD_DEFAULT, INFERENCE_KV_CACHE_DTYPE,
    INFERENCE_KV_CACHE_DTYPE_DEFAULT, INFERENCE_KV_LAYOUT,
    INFERENCE_KV_LAYOUT_DEFAULT, INFERENCE_MAX_BATCH,
    INFERENCE_MAX_BATCH_DEFAULT, INFERENCE_MAX_NEW_TOKENS,
    INFERENCE_MAX_NEW_TOKENS_DEFAULT, INFERENCE_MAX_QUEUE_DEPTH,
    INFERENCE_MAX_QUEUE_DEPTH_DEFAULT, INFERENCE_MAX_REDISPATCH,
    INFERENCE_MAX_REDISPATCH_DEFAULT, INFERENCE_N_PAGES,
    INFERENCE_N_PAGES_DEFAULT, INFERENCE_PAGE_SIZE,
    INFERENCE_PAGE_SIZE_DEFAULT, INFERENCE_PREFILL_CHUNK,
    INFERENCE_PREFILL_CHUNK_DEFAULT, INFERENCE_PREFILL_MAX_BATCH,
    INFERENCE_PREFILL_MAX_BATCH_DEFAULT, INFERENCE_PREFILL_WORKERS,
    INFERENCE_PREFILL_WORKERS_DEFAULT, INFERENCE_PREFIX_CACHE,
    INFERENCE_PREFIX_CACHE_DEFAULT, INFERENCE_QUEUE_TIMEOUT_S,
    INFERENCE_QUEUE_TIMEOUT_S_DEFAULT, INFERENCE_REPLICAS,
    INFERENCE_REPLICAS_DEFAULT, INFERENCE_SAMPLING_SEED,
    INFERENCE_SAMPLING_SEED_DEFAULT, INFERENCE_SEQ_BUCKETS,
    INFERENCE_SEQ_BUCKETS_DEFAULT, INFERENCE_SPECULATIVE,
    INFERENCE_SPECULATIVE_DRAFT_LAYERS,
    INFERENCE_SPECULATIVE_DRAFT_LAYERS_DEFAULT, INFERENCE_SPECULATIVE_ENABLED,
    INFERENCE_SPECULATIVE_ENABLED_DEFAULT, INFERENCE_SPECULATIVE_K,
    INFERENCE_SPECULATIVE_K_DEFAULT, INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW,
    INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW_DEFAULT, INFERENCE_TEMPERATURE,
    INFERENCE_TEMPERATURE_DEFAULT, INFERENCE_TOP_K, INFERENCE_TOP_K_DEFAULT,
    INFERENCE_TOP_P, INFERENCE_TOP_P_DEFAULT)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.runtime.zero.constants import (
    MAX_STAGE_ZERO_OPTIMIZATION, ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED)

ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER]

TENSOR_CORE_ALIGN_SIZE = 8

# the top-level keys the port reads
_PORTED_KEYS = frozenset((
    TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    GRADIENT_ACCUMULATION_STEPS, STEPS_PER_PRINT, FP16, BF16, OPTIMIZER,
    SCHEDULER, GRADIENT_CLIPPING, SPARSE_ATTENTION, ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
    C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR, C.FP32_ALLREDUCE,
    C.DISABLE_ALLGATHER, C.ZERO_ALLOW_UNTESTED_OPTIMIZER, C.DUMP_STATE,
    C.VOCABULARY_SIZE, C.AMP, C.WALL_CLOCK_BREAKDOWN, C.MEMORY_BREAKDOWN,
    C.INFERENCE, C.ACTIVATION_CHECKPOINTING, C.PROGRESSIVE_LAYER_DROP,
    C.SPARSE_GRADIENTS, C.FP8, C.PIPELINE, C.MESH, C.TENSOR_PARALLEL,
    C.COMM_QUANTIZATION, C.RESILIENCE, C.TELEMETRY, C.TENSORBOARD,
    C.PROFILING, C.COMPILATION_CACHE_DIR))

# the keys the JAX config reads whose features are not ported yet, each
# with the ROADMAP.md section 1 item that ports it
_LATER_KEYS = {
    C.ELASTICITY: "item 6 (slice G, operations)",
    C.ANALYSIS: "item 6 (slice G, operations)",
}


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_pipeline_config(param_dict):
    """The ``pipeline`` section with defaults (JAX ``config.py:230``)."""
    defaults = {
        C.PIPELINE_STAGES: C.PIPELINE_STAGES_DEFAULT,
        C.PIPELINE_PARTITION: C.PIPELINE_PARTITION_DEFAULT,
        C.PIPELINE_SEED_LAYERS: C.PIPELINE_SEED_LAYERS_DEFAULT,
        C.PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL:
            C.PIPELINE_ACTIVATION_CHECKPOINT_INTERVAL_DEFAULT,
    }
    config = dict(defaults)
    config.update(param_dict.get(C.PIPELINE, {}) or {})
    return config


def get_mesh_config(param_dict):
    """The ``mesh`` axes ``{"data": N|None, "model": M, "pipe": P, "seq":
    S, "expert": E}`` or None (JAX ``config.py:244``). The port runs
    every axis: ``pipe`` x ``data`` alone as
    ``parallel/mesh.py:pipe_data_topology`` lays it out, with ``model``,
    ``seq`` or ``expert`` over ``parallel/mesh.py:MeshGroups``."""
    return param_dict.get(C.MESH, C.MESH_DEFAULT)


def get_amp_enabled(param_dict):
    if C.AMP in param_dict:
        return get_scalar_param(param_dict[C.AMP], C.AMP_ENABLED,
                                C.AMP_ENABLED_DEFAULT)
    return False


def get_amp_params(param_dict):
    if C.AMP in param_dict:
        amp_params = dict(param_dict[C.AMP])
        amp_params.pop(C.AMP_ENABLED, None)
        return amp_params
    return False


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while parsing a JSON config."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = collections.Counter([pair[0] for pair in ordered_pairs])
        keys = [key for key, value in counter.items() if value > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d


def get_sparse_gradients_enabled(param_dict):
    return get_scalar_param(param_dict, C.SPARSE_GRADIENTS,
                            C.SPARSE_GRADIENTS_DEFAULT)


def get_pld_enabled(param_dict):
    if C.PROGRESSIVE_LAYER_DROP in param_dict:
        return get_scalar_param(param_dict[C.PROGRESSIVE_LAYER_DROP],
                                C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT)
    return False


def get_pld_params(param_dict):
    if C.PROGRESSIVE_LAYER_DROP in param_dict:
        pld_params = dict(param_dict[C.PROGRESSIVE_LAYER_DROP])
        pld_params.pop(C.PLD_ENABLED, None)
        return pld_params
    return False


class TensorParallelConfig:
    """The ``tensor_parallel`` block (JAX ``config.py:539-570``): its
    ``overlap`` sub-block opts the TP pipeline blocks' collectives into
    the chunked rings of ``parallel/collectives.py``."""

    def __init__(self, param_dict):
        sub = param_dict.get(C.TENSOR_PARALLEL, {}) or {}
        ov = sub.get(C.TP_OVERLAP, {}) or {}
        self.overlap_enabled = get_scalar_param(
            ov, C.TP_OVERLAP_ENABLED, C.TP_OVERLAP_ENABLED_DEFAULT)
        self.overlap_chunks = get_scalar_param(
            ov, C.TP_OVERLAP_CHUNKS, C.TP_OVERLAP_CHUNKS_DEFAULT)
        self.overlap_bidirectional = get_scalar_param(
            ov, C.TP_OVERLAP_BIDIRECTIONAL,
            C.TP_OVERLAP_BIDIRECTIONAL_DEFAULT)
        self.overlap_sites = get_scalar_param(
            ov, C.TP_OVERLAP_SITES, C.TP_OVERLAP_SITES_DEFAULT)
        self.overlap_wire_dtype = get_scalar_param(
            ov, C.TP_OVERLAP_WIRE_DTYPE, C.TP_OVERLAP_WIRE_DTYPE_DEFAULT)
        self.overlap_wire_chunk = get_scalar_param(
            ov, C.TP_OVERLAP_WIRE_CHUNK, C.TP_OVERLAP_WIRE_CHUNK_DEFAULT)

    def overlap_plan(self):
        """The resolved :class:`~deepspeed_tpu_torch.parallel.collectives.
        OverlapPlan`, or None when overlap is disabled."""
        if not self.overlap_enabled:
            return None
        from deepspeed_tpu_torch.parallel.collectives import OverlapPlan
        wd = self.overlap_wire_dtype
        return OverlapPlan(chunks=int(self.overlap_chunks),
                           bidirectional=bool(self.overlap_bidirectional),
                           sites=dict(self.overlap_sites or {}),
                           wire_dtype=(str(wd) if wd else None),
                           wire_chunk=int(self.overlap_wire_chunk))


class CommQuantizationConfig:
    """Typed view of the ``comm_quantization`` block (JAX
    ``CommQuantizationConfig``): the int8 chunk-scaled gradient
    all-reduce (``runtime/comm/quantized.py``)."""

    def __init__(self, param_dict):
        sub = param_dict.get(C.COMM_QUANTIZATION, {}) or {}
        self.enabled = get_scalar_param(sub, C.COMM_QUANTIZATION_ENABLED,
                                        C.COMM_QUANTIZATION_ENABLED_DEFAULT)
        self.bits = get_scalar_param(sub, C.COMM_QUANTIZATION_BITS,
                                     C.COMM_QUANTIZATION_BITS_DEFAULT)
        self.chunk_size = get_scalar_param(
            sub, C.COMM_QUANTIZATION_CHUNK_SIZE,
            C.COMM_QUANTIZATION_CHUNK_SIZE_DEFAULT)
        self.bucket_mb = get_scalar_param(
            sub, C.COMM_QUANTIZATION_BUCKET_MB,
            C.COMM_QUANTIZATION_BUCKET_MB_DEFAULT)
        self.error_feedback = get_scalar_param(
            sub, C.COMM_QUANTIZATION_ERROR_FEEDBACK,
            C.COMM_QUANTIZATION_ERROR_FEEDBACK_DEFAULT)

    def __repr__(self):
        return (f"CommQuantizationConfig(enabled={self.enabled}, "
                f"bits={self.bits}, chunk_size={self.chunk_size}, "
                f"bucket_mb={self.bucket_mb}, "
                f"error_feedback={self.error_feedback})")


class ResilienceConfig:
    """Typed view of the ``resilience`` block (JAX ``ResilienceConfig``,
    its keys and defaults): preemption-safe checkpointing, auto-resume,
    step health guards, the hot checkpoint tier and fault injection
    (``runtime/resilience/``; the engine wiring is in
    ``runtime/engine.py``)."""

    def __init__(self, param_dict):
        sub = param_dict.get(C.RESILIENCE, {}) or {}
        self.auto_resume = get_scalar_param(
            sub, C.RESILIENCE_AUTO_RESUME, C.RESILIENCE_AUTO_RESUME_DEFAULT)
        self.save_dir = get_scalar_param(sub, C.RESILIENCE_SAVE_DIR,
                                         C.RESILIENCE_SAVE_DIR_DEFAULT)
        self.save_interval_steps = get_scalar_param(
            sub, C.RESILIENCE_SAVE_INTERVAL_STEPS,
            C.RESILIENCE_SAVE_INTERVAL_STEPS_DEFAULT)
        ckpt = sub.get(C.RESILIENCE_CHECKPOINT, {}) or {}
        self.async_save = get_scalar_param(
            ckpt, C.RESILIENCE_CKPT_ASYNC_SAVE,
            C.RESILIENCE_CKPT_ASYNC_SAVE_DEFAULT)
        self.keep_last_n = get_scalar_param(
            ckpt, C.RESILIENCE_CKPT_KEEP_LAST_N,
            C.RESILIENCE_CKPT_KEEP_LAST_N_DEFAULT)
        self.io_retries = get_scalar_param(
            ckpt, C.RESILIENCE_CKPT_IO_RETRIES,
            C.RESILIENCE_CKPT_IO_RETRIES_DEFAULT)
        self.io_retry_base_s = get_scalar_param(
            ckpt, C.RESILIENCE_CKPT_IO_RETRY_BASE_S,
            C.RESILIENCE_CKPT_IO_RETRY_BASE_S_DEFAULT)
        self.io_timeout_s = get_scalar_param(
            ckpt, C.RESILIENCE_CKPT_IO_TIMEOUT_S,
            C.RESILIENCE_CKPT_IO_TIMEOUT_S_DEFAULT)
        guards = sub.get(C.RESILIENCE_GUARDS, {}) or {}
        nan = guards.get(C.RESILIENCE_GUARD_NAN, {}) or {}
        self.nan_guard_action = get_scalar_param(
            nan, C.RESILIENCE_GUARD_ACTION,
            C.RESILIENCE_GUARD_NAN_ACTION_DEFAULT)
        spike = guards.get(C.RESILIENCE_GUARD_LOSS_SPIKE, {}) or {}
        self.loss_spike_action = get_scalar_param(
            spike, C.RESILIENCE_GUARD_ACTION,
            C.RESILIENCE_GUARD_LOSS_SPIKE_ACTION_DEFAULT)
        self.loss_spike_window = get_scalar_param(
            spike, C.RESILIENCE_GUARD_LOSS_SPIKE_WINDOW,
            C.RESILIENCE_GUARD_LOSS_SPIKE_WINDOW_DEFAULT)
        self.loss_spike_factor = get_scalar_param(
            spike, C.RESILIENCE_GUARD_LOSS_SPIKE_FACTOR,
            C.RESILIENCE_GUARD_LOSS_SPIKE_FACTOR_DEFAULT)
        self.loss_spike_min_history = get_scalar_param(
            spike, C.RESILIENCE_GUARD_LOSS_SPIKE_MIN_HISTORY,
            C.RESILIENCE_GUARD_LOSS_SPIKE_MIN_HISTORY_DEFAULT)
        collapse = guards.get(C.RESILIENCE_GUARD_SCALE_COLLAPSE, {}) or {}
        self.scale_collapse_action = get_scalar_param(
            collapse, C.RESILIENCE_GUARD_ACTION,
            C.RESILIENCE_GUARD_SCALE_COLLAPSE_ACTION_DEFAULT)
        self.scale_collapse_patience = get_scalar_param(
            collapse, C.RESILIENCE_GUARD_SCALE_COLLAPSE_PATIENCE,
            C.RESILIENCE_GUARD_SCALE_COLLAPSE_PATIENCE_DEFAULT)
        preempt = sub.get(C.RESILIENCE_PREEMPTION, {}) or {}
        self.save_on_sigterm = get_scalar_param(
            preempt, C.RESILIENCE_PREEMPTION_SAVE_ON_SIGTERM,
            C.RESILIENCE_PREEMPTION_SAVE_ON_SIGTERM_DEFAULT)
        fi = sub.get(C.RESILIENCE_FAULT_INJECTION, {}) or {}
        self.fault_injection = get_scalar_param(
            fi, C.RESILIENCE_FAULT_INJECTION_ENABLED,
            C.RESILIENCE_FAULT_INJECTION_ENABLED_DEFAULT)
        hot = sub.get(C.RESILIENCE_HOT_CHECKPOINT, {}) or {}
        self.hot_enabled = get_scalar_param(
            hot, C.RESILIENCE_HOT_ENABLED, C.RESILIENCE_HOT_ENABLED_DEFAULT)
        self.hot_interval_steps = get_scalar_param(
            hot, C.RESILIENCE_HOT_INTERVAL_STEPS,
            C.RESILIENCE_HOT_INTERVAL_STEPS_DEFAULT)
        self.hot_capacity = get_scalar_param(
            hot, C.RESILIENCE_HOT_CAPACITY, C.RESILIENCE_HOT_CAPACITY_DEFAULT)
        self.hot_mirror_dir = get_scalar_param(
            hot, C.RESILIENCE_HOT_MIRROR_DIR,
            C.RESILIENCE_HOT_MIRROR_DIR_DEFAULT)
        self.hot_mirror_keep = get_scalar_param(
            hot, C.RESILIENCE_HOT_MIRROR_KEEP,
            C.RESILIENCE_HOT_MIRROR_KEEP_DEFAULT)
        self.host_adam_retries = get_scalar_param(
            sub, C.RESILIENCE_HOST_ADAM_RETRIES,
            C.RESILIENCE_HOST_ADAM_RETRIES_DEFAULT)

    @property
    def guards_enabled(self):
        return any(a is not None for a in (self.nan_guard_action,
                                           self.loss_spike_action,
                                           self.scale_collapse_action))

    @property
    def enabled(self):
        return bool(self.auto_resume or self.save_interval_steps or
                    self.guards_enabled or self.save_on_sigterm or
                    self.fault_injection or self.save_dir)

    def __repr__(self):
        return (f"ResilienceConfig(auto_resume={self.auto_resume}, "
                f"save_dir={self.save_dir!r}, "
                f"save_interval_steps={self.save_interval_steps}, "
                f"async_save={self.async_save}, "
                f"keep_last_n={self.keep_last_n}, "
                f"guards=[nan={self.nan_guard_action}, "
                f"loss_spike={self.loss_spike_action}, "
                f"scale_collapse={self.scale_collapse_action}], "
                f"save_on_sigterm={self.save_on_sigterm}, "
                f"fault_injection={self.fault_injection})")


class Fp8Config:
    """Typed view of the ``fp8`` block (JAX ``Fp8Config``): ``enabled``
    turns the model's hooked matmuls into delayed-scaling fp8
    (``ops/fp8.py``); ``margin`` / ``amax_history_len`` tune the recipe
    and ``sites`` holds per-site ``{"enabled": bool}`` overrides. The
    ``wire`` sub-block quantizes stage 3's param gathers with a codec of
    ``runtime/comm/codecs.py``."""

    def __init__(self, param_dict):
        sub = param_dict.get(C.FP8, {}) or {}
        self.enabled = get_scalar_param(sub, C.FP8_ENABLED,
                                        C.FP8_ENABLED_DEFAULT)
        self.margin = get_scalar_param(sub, C.FP8_MARGIN,
                                       C.FP8_MARGIN_DEFAULT)
        self.amax_history_len = get_scalar_param(
            sub, C.FP8_AMAX_HISTORY_LEN, C.FP8_AMAX_HISTORY_LEN_DEFAULT)
        self.sites = get_scalar_param(sub, C.FP8_SITES, C.FP8_SITES_DEFAULT)
        wire = sub.get(C.FP8_WIRE, {}) or {}
        self.wire_enabled = get_scalar_param(wire, C.FP8_WIRE_ENABLED,
                                             C.FP8_WIRE_ENABLED_DEFAULT)
        self.wire_dtype = get_scalar_param(wire, C.FP8_WIRE_DTYPE,
                                           C.FP8_WIRE_DTYPE_DEFAULT)
        self.wire_chunk_size = get_scalar_param(
            wire, C.FP8_WIRE_CHUNK_SIZE, C.FP8_WIRE_CHUNK_SIZE_DEFAULT)

    def plan(self):
        """The resolved :class:`~deepspeed_tpu_torch.ops.fp8.Fp8Plan`, or
        None when fp8 matmuls are disabled."""
        if not self.enabled:
            return None
        from deepspeed_tpu_torch.ops.fp8 import Fp8Plan
        return Fp8Plan(margin=int(self.margin),
                       amax_history_len=int(self.amax_history_len),
                       sites=dict(self.sites or {}))

    def active_wire_dtype(self):
        """The codec name for quantized gathers, or None."""
        return str(self.wire_dtype) if self.wire_enabled else None

    def __repr__(self):
        return (f"Fp8Config(enabled={self.enabled}, "
                f"margin={self.margin}, "
                f"amax_history_len={self.amax_history_len}, "
                f"sites={self.sites!r}, "
                f"wire_enabled={self.wire_enabled}, "
                f"wire_dtype={self.wire_dtype!r}, "
                f"wire_chunk_size={self.wire_chunk_size})")


def get_fp16_enabled(param_dict):
    if FP16 in param_dict:
        return get_scalar_param(param_dict[FP16], FP16_ENABLED,
                                FP16_ENABLED_DEFAULT)
    return False


def get_bf16_enabled(param_dict):
    if BF16 in param_dict:
        return get_scalar_param(param_dict[BF16], BF16_ENABLED,
                                BF16_ENABLED_DEFAULT)
    return False


def get_loss_scale(param_dict):
    if get_fp16_enabled(param_dict):
        return get_scalar_param(param_dict[FP16], FP16_LOSS_SCALE,
                                FP16_LOSS_SCALE_DEFAULT)
    return FP16_LOSS_SCALE_DEFAULT


def get_initial_dynamic_scale(param_dict):
    if get_fp16_enabled(param_dict):
        power = get_scalar_param(param_dict[FP16], FP16_INITIAL_SCALE_POWER,
                                 FP16_INITIAL_SCALE_POWER_DEFAULT)
    else:
        power = FP16_INITIAL_SCALE_POWER_DEFAULT
    return 2 ** power


def get_dynamic_loss_scale_args(param_dict):
    if not get_fp16_enabled(param_dict):
        return None
    fp16_dict = param_dict[FP16]
    dynamic_keys = (FP16_INITIAL_SCALE_POWER, FP16_LOSS_SCALE_WINDOW,
                    FP16_MIN_LOSS_SCALE, FP16_HYSTERESIS)
    if not any(k in fp16_dict for k in dynamic_keys):
        return None
    return {
        "init_scale": 2 ** get_scalar_param(
            fp16_dict, FP16_INITIAL_SCALE_POWER,
            FP16_INITIAL_SCALE_POWER_DEFAULT),
        "scale_window": get_scalar_param(fp16_dict, FP16_LOSS_SCALE_WINDOW,
                                         FP16_LOSS_SCALE_WINDOW_DEFAULT),
        "delayed_shift": get_scalar_param(fp16_dict, FP16_HYSTERESIS,
                                          FP16_HYSTERESIS_DEFAULT),
        "min_scale": get_scalar_param(fp16_dict, FP16_MIN_LOSS_SCALE,
                                      FP16_MIN_LOSS_SCALE_DEFAULT),
    }


def get_optimizer_name(param_dict):
    if OPTIMIZER in param_dict and TYPE in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][TYPE]
    return OPTIMIZER_TYPE_DEFAULT


def get_optimizer_params(param_dict):
    if get_optimizer_name(param_dict) is not None and \
            OPTIMIZER_PARAMS in param_dict[OPTIMIZER]:
        return param_dict[OPTIMIZER][OPTIMIZER_PARAMS]
    return None


def get_scheduler_name(param_dict):
    if SCHEDULER in param_dict and TYPE in param_dict[SCHEDULER]:
        return param_dict[SCHEDULER][TYPE]
    return SCHEDULER_TYPE_DEFAULT


def get_scheduler_params(param_dict):
    if get_scheduler_name(param_dict) is not None and \
            SCHEDULER_PARAMS in param_dict[SCHEDULER]:
        return param_dict[SCHEDULER][SCHEDULER_PARAMS]
    return None


def get_sparse_attention(param_dict):
    """Parse the sparse_attention section into kwargs for a SparsityConfig.

    Mirrors the mode dispatch of the reference (`runtime/config.py:177-345`)
    and of the JAX package (`deepspeed_tpu/runtime/config.py:167-227`).
    """
    if SPARSE_ATTENTION not in param_dict:
        return None
    sparsity = param_dict[SPARSE_ATTENTION]
    mode = get_scalar_param(sparsity, SPARSE_MODE, SPARSE_MODE_DEFAULT)

    common = {
        SPARSE_MODE: mode,
        SPARSE_BLOCK: get_scalar_param(sparsity, SPARSE_BLOCK, SPARSE_BLOCK_DEFAULT),
        SPARSE_DIFFERENT_LAYOUT_PER_HEAD: get_scalar_param(
            sparsity, SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
            SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT),
    }
    if mode == SPARSE_DENSE_MODE:
        return common
    if mode == SPARSE_FIXED_MODE:
        extra_keys = [
            (SPARSE_NUM_LOCAL_BLOCKS, SPARSE_NUM_LOCAL_BLOCKS_DEFAULT),
            (SPARSE_NUM_GLOBAL_BLOCKS, SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
            (SPARSE_ATTENTION_TYPE, SPARSE_ATTENTION_TYPE_DEFAULT),
            (SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
             SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT),
            (SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
             SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT),
        ]
    elif mode == SPARSE_VARIABLE_MODE:
        extra_keys = [
            (SPARSE_NUM_RANDOM_BLOCKS, SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
            (SPARSE_LOCAL_WINDOW_BLOCKS, SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT),
            (SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT),
            (SPARSE_GLOBAL_BLOCK_END_INDICES,
             SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT),
            (SPARSE_ATTENTION_TYPE, SPARSE_ATTENTION_TYPE_DEFAULT),
            (SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
             SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT),
        ]
    elif mode == SPARSE_BIGBIRD_MODE:
        extra_keys = [
            (SPARSE_NUM_RANDOM_BLOCKS, SPARSE_NUM_RANDOM_BLOCKS_DEFAULT),
            (SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
             SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT),
            (SPARSE_NUM_GLOBAL_BLOCKS, SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT),
        ]
    elif mode == SPARSE_BSLONGFORMER_MODE:
        extra_keys = [
            (SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
             SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT),
            (SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT),
            (SPARSE_GLOBAL_BLOCK_END_INDICES,
             SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT),
        ]
    else:
        raise NotImplementedError(
            f"Given sparsity mode, {mode}, has not been implemented yet!")
    for key, default in extra_keys:
        common[key] = get_scalar_param(sparsity, key, default)
    return common


class InferenceConfig:
    """Typed view of the ``inference`` block: the serving engine's
    configuration (``inference/``; a copy of the JAX package's
    ``InferenceConfig``, ``config.py:637``, checked by
    :meth:`DeepSpeedConfig._check_inference` as JAX checks it).

    ``max_batch`` sizes the KV cache's rows (the decode program's fixed
    batch); ``seq_buckets`` are host-side per-request length budgets
    (the cache is sized to their max; no bucket is a program shape);
    ``prefill_chunk`` fixes the chunked-prefill shape;
    ``kv_cache_dtype`` selects plain (``bf16``/``f32``) or codec
    -quantized (``int8``/``f8e4m3fn``/``f8e5m2``) cache storage."""

    KEYS = (INFERENCE_MAX_BATCH, INFERENCE_SEQ_BUCKETS,
            INFERENCE_PREFILL_CHUNK, INFERENCE_KV_CACHE_DTYPE,
            INFERENCE_MAX_NEW_TOKENS, INFERENCE_ATTENTION_IMPL,
            INFERENCE_ATTENTION_BLOCK_K, INFERENCE_TEMPERATURE,
            INFERENCE_TOP_K, INFERENCE_TOP_P, INFERENCE_SAMPLING_SEED,
            INFERENCE_KV_LAYOUT, INFERENCE_PAGE_SIZE, INFERENCE_N_PAGES,
            INFERENCE_PREFIX_CACHE, INFERENCE_HOST_PARK_THRESHOLD,
            INFERENCE_REPLICAS, INFERENCE_MAX_REDISPATCH,
            INFERENCE_MAX_QUEUE_DEPTH, INFERENCE_DEADLINE_S,
            INFERENCE_QUEUE_TIMEOUT_S, INFERENCE_SPECULATIVE,
            INFERENCE_DISAGGREGATED, INFERENCE_PREFILL_WORKERS,
            INFERENCE_DECODE_WORKERS, INFERENCE_PREFILL_MAX_BATCH,
            INFERENCE_DECODE_MAX_BATCH)

    SPECULATIVE_KEYS = (INFERENCE_SPECULATIVE_ENABLED,
                        INFERENCE_SPECULATIVE_K,
                        INFERENCE_SPECULATIVE_DRAFT_LAYERS,
                        INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW)

    def __init__(self, param_dict):
        sub = param_dict.get(INFERENCE, {}) or {}
        self._given_keys = tuple(sub)
        self.max_batch = get_scalar_param(sub, INFERENCE_MAX_BATCH,
                                          INFERENCE_MAX_BATCH_DEFAULT)
        buckets = get_scalar_param(sub, INFERENCE_SEQ_BUCKETS,
                                   INFERENCE_SEQ_BUCKETS_DEFAULT)
        self.seq_buckets = tuple(buckets) if buckets is not None else ()
        self.prefill_chunk = get_scalar_param(
            sub, INFERENCE_PREFILL_CHUNK, INFERENCE_PREFILL_CHUNK_DEFAULT)
        self.kv_cache_dtype = get_scalar_param(
            sub, INFERENCE_KV_CACHE_DTYPE, INFERENCE_KV_CACHE_DTYPE_DEFAULT)
        self.max_new_tokens = get_scalar_param(
            sub, INFERENCE_MAX_NEW_TOKENS, INFERENCE_MAX_NEW_TOKENS_DEFAULT)
        self.attention_impl = get_scalar_param(
            sub, INFERENCE_ATTENTION_IMPL, INFERENCE_ATTENTION_IMPL_DEFAULT)
        self.attention_block_k = get_scalar_param(
            sub, INFERENCE_ATTENTION_BLOCK_K,
            INFERENCE_ATTENTION_BLOCK_K_DEFAULT)
        self.temperature = get_scalar_param(
            sub, INFERENCE_TEMPERATURE, INFERENCE_TEMPERATURE_DEFAULT)
        self.top_k = get_scalar_param(sub, INFERENCE_TOP_K,
                                      INFERENCE_TOP_K_DEFAULT)
        self.top_p = get_scalar_param(sub, INFERENCE_TOP_P,
                                      INFERENCE_TOP_P_DEFAULT)
        self.sampling_seed = get_scalar_param(
            sub, INFERENCE_SAMPLING_SEED, INFERENCE_SAMPLING_SEED_DEFAULT)
        self.kv_layout = get_scalar_param(
            sub, INFERENCE_KV_LAYOUT, INFERENCE_KV_LAYOUT_DEFAULT)
        self.page_size = get_scalar_param(
            sub, INFERENCE_PAGE_SIZE, INFERENCE_PAGE_SIZE_DEFAULT)
        self.n_pages = get_scalar_param(
            sub, INFERENCE_N_PAGES, INFERENCE_N_PAGES_DEFAULT)
        self.prefix_cache = get_scalar_param(
            sub, INFERENCE_PREFIX_CACHE, INFERENCE_PREFIX_CACHE_DEFAULT)
        self.host_park_threshold = get_scalar_param(
            sub, INFERENCE_HOST_PARK_THRESHOLD,
            INFERENCE_HOST_PARK_THRESHOLD_DEFAULT)
        self.replicas = get_scalar_param(
            sub, INFERENCE_REPLICAS, INFERENCE_REPLICAS_DEFAULT)
        self.max_redispatch = get_scalar_param(
            sub, INFERENCE_MAX_REDISPATCH, INFERENCE_MAX_REDISPATCH_DEFAULT)
        self.max_queue_depth = get_scalar_param(
            sub, INFERENCE_MAX_QUEUE_DEPTH,
            INFERENCE_MAX_QUEUE_DEPTH_DEFAULT)
        self.deadline_s = get_scalar_param(
            sub, INFERENCE_DEADLINE_S, INFERENCE_DEADLINE_S_DEFAULT)
        self.queue_timeout_s = get_scalar_param(
            sub, INFERENCE_QUEUE_TIMEOUT_S, INFERENCE_QUEUE_TIMEOUT_S_DEFAULT)
        self.disaggregated = get_scalar_param(
            sub, INFERENCE_DISAGGREGATED, INFERENCE_DISAGGREGATED_DEFAULT)
        self.prefill_workers = get_scalar_param(
            sub, INFERENCE_PREFILL_WORKERS,
            INFERENCE_PREFILL_WORKERS_DEFAULT)
        self.decode_workers = get_scalar_param(
            sub, INFERENCE_DECODE_WORKERS,
            INFERENCE_DECODE_WORKERS_DEFAULT)
        self.prefill_max_batch = get_scalar_param(
            sub, INFERENCE_PREFILL_MAX_BATCH,
            INFERENCE_PREFILL_MAX_BATCH_DEFAULT)
        self.decode_max_batch = get_scalar_param(
            sub, INFERENCE_DECODE_MAX_BATCH,
            INFERENCE_DECODE_MAX_BATCH_DEFAULT)
        spec = sub.get(INFERENCE_SPECULATIVE, {}) or {}
        self._speculative_raw = spec
        self._speculative_given_keys = tuple(spec) \
            if isinstance(spec, dict) else ()
        self.speculative_enabled = get_scalar_param(
            spec, INFERENCE_SPECULATIVE_ENABLED,
            INFERENCE_SPECULATIVE_ENABLED_DEFAULT) \
            if isinstance(spec, dict) else None
        self.speculative_k = get_scalar_param(
            spec, INFERENCE_SPECULATIVE_K,
            INFERENCE_SPECULATIVE_K_DEFAULT) \
            if isinstance(spec, dict) else None
        self.speculative_draft_layers = get_scalar_param(
            spec, INFERENCE_SPECULATIVE_DRAFT_LAYERS,
            INFERENCE_SPECULATIVE_DRAFT_LAYERS_DEFAULT) \
            if isinstance(spec, dict) else None
        self.speculative_min_accept_to_grow = get_scalar_param(
            spec, INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW,
            INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW_DEFAULT) \
            if isinstance(spec, dict) else None

    @property
    def speculative(self):
        """The validated block in the dict form the engine's
        ``build_speculative`` consumes (None when disabled)."""
        if not self.speculative_enabled:
            return None
        return {
            INFERENCE_SPECULATIVE_ENABLED: True,
            INFERENCE_SPECULATIVE_K: self.speculative_k,
            INFERENCE_SPECULATIVE_DRAFT_LAYERS:
                self.speculative_draft_layers,
            INFERENCE_SPECULATIVE_MIN_ACCEPT_TO_GROW:
                self.speculative_min_accept_to_grow,
        }

    def __repr__(self):
        return (f"InferenceConfig(max_batch={self.max_batch}, "
                f"seq_buckets={self.seq_buckets}, "
                f"prefill_chunk={self.prefill_chunk}, "
                f"kv_cache_dtype={self.kv_cache_dtype!r}, "
                f"max_new_tokens={self.max_new_tokens}, "
                f"attention_impl={self.attention_impl!r}, "
                f"attention_block_k={self.attention_block_k}, "
                f"temperature={self.temperature}, top_k={self.top_k}, "
                f"top_p={self.top_p}, "
                f"sampling_seed={self.sampling_seed}, "
                f"kv_layout={self.kv_layout!r}, "
                f"page_size={self.page_size}, n_pages={self.n_pages}, "
                f"prefix_cache={self.prefix_cache}, "
                f"host_park_threshold={self.host_park_threshold}, "
                f"replicas={self.replicas}, "
                f"max_redispatch={self.max_redispatch}, "
                f"max_queue_depth={self.max_queue_depth}, "
                f"deadline_s={self.deadline_s}, "
                f"queue_timeout_s={self.queue_timeout_s}, "
                f"disaggregated={self.disaggregated}, "
                f"prefill_workers={self.prefill_workers}, "
                f"decode_workers={self.decode_workers}, "
                f"prefill_max_batch={self.prefill_max_batch}, "
                f"decode_max_batch={self.decode_max_batch})")



class TelemetryConfig:
    """Typed view of the ``telemetry`` block (JAX's keys and defaults):
    the runtime telemetry session (``telemetry/``): metrics registry,
    step-phase spans, the schema-versioned JSONL event log, the
    JSONL / console / Prometheus-textfile exporters, and the forensics
    (``crash_dump_dir``, ``watchdog``, ``anomaly_trace``)."""

    KEYS = (C.TELEMETRY_ENABLED, C.TELEMETRY_JSONL_PATH, C.TELEMETRY_CONSOLE,
            C.TELEMETRY_PROMETHEUS_TEXTFILE, C.TELEMETRY_PROMETHEUS_WRITE_EVERY,
            C.TELEMETRY_HISTORY, C.TELEMETRY_STAMP_STATIC_FACTS,
            C.TELEMETRY_FLOPS_PER_TOKEN, C.TELEMETRY_CRASH_DUMP_DIR,
            C.TELEMETRY_FLIGHT_HISTORY, C.TELEMETRY_WATCHDOG,
            C.TELEMETRY_ANOMALY_TRACE)
    WATCHDOG_KEYS = (C.TELEMETRY_WATCHDOG_ENABLED,
                     C.TELEMETRY_WATCHDOG_DEADLINE_FACTOR,
                     C.TELEMETRY_WATCHDOG_MIN_DEADLINE_S,
                     C.TELEMETRY_WATCHDOG_ACTION)
    ANOMALY_KEYS = (C.TELEMETRY_ANOMALY_TRACE_ENABLED,
                    C.TELEMETRY_ANOMALY_TRACE_FACTOR,
                    C.TELEMETRY_ANOMALY_TRACE_WINDOW,
                    C.TELEMETRY_ANOMALY_TRACE_CAPTURE_STEPS)

    def __init__(self, param_dict):
        sub = param_dict.get(C.TELEMETRY, {}) or {}
        self._given_keys = tuple(sub)
        self.enabled = get_scalar_param(sub, C.TELEMETRY_ENABLED,
                                        C.TELEMETRY_ENABLED_DEFAULT)
        self.jsonl_path = get_scalar_param(sub, C.TELEMETRY_JSONL_PATH,
                                           C.TELEMETRY_JSONL_PATH_DEFAULT)
        self.console = get_scalar_param(sub, C.TELEMETRY_CONSOLE,
                                        C.TELEMETRY_CONSOLE_DEFAULT)
        self.prometheus_textfile = get_scalar_param(
            sub, C.TELEMETRY_PROMETHEUS_TEXTFILE,
            C.TELEMETRY_PROMETHEUS_TEXTFILE_DEFAULT)
        self.prometheus_write_every = get_scalar_param(
            sub, C.TELEMETRY_PROMETHEUS_WRITE_EVERY,
            C.TELEMETRY_PROMETHEUS_WRITE_EVERY_DEFAULT)
        self.history = get_scalar_param(sub, C.TELEMETRY_HISTORY,
                                        C.TELEMETRY_HISTORY_DEFAULT)
        self.stamp_static_facts = get_scalar_param(
            sub, C.TELEMETRY_STAMP_STATIC_FACTS,
            C.TELEMETRY_STAMP_STATIC_FACTS_DEFAULT)
        self.flops_per_token = get_scalar_param(
            sub, C.TELEMETRY_FLOPS_PER_TOKEN,
            C.TELEMETRY_FLOPS_PER_TOKEN_DEFAULT)
        self.crash_dump_dir = get_scalar_param(
            sub, C.TELEMETRY_CRASH_DUMP_DIR, C.TELEMETRY_CRASH_DUMP_DIR_DEFAULT)
        self.flight_history = get_scalar_param(
            sub, C.TELEMETRY_FLIGHT_HISTORY, C.TELEMETRY_FLIGHT_HISTORY_DEFAULT)
        wd = sub.get(C.TELEMETRY_WATCHDOG, {}) or {}
        self._watchdog_given_keys = tuple(wd)
        self.watchdog_enabled = get_scalar_param(
            wd, C.TELEMETRY_WATCHDOG_ENABLED,
            C.TELEMETRY_WATCHDOG_ENABLED_DEFAULT)
        self.watchdog_deadline_factor = get_scalar_param(
            wd, C.TELEMETRY_WATCHDOG_DEADLINE_FACTOR,
            C.TELEMETRY_WATCHDOG_DEADLINE_FACTOR_DEFAULT)
        self.watchdog_min_deadline_s = get_scalar_param(
            wd, C.TELEMETRY_WATCHDOG_MIN_DEADLINE_S,
            C.TELEMETRY_WATCHDOG_MIN_DEADLINE_S_DEFAULT)
        self.watchdog_action = get_scalar_param(
            wd, C.TELEMETRY_WATCHDOG_ACTION, C.TELEMETRY_WATCHDOG_ACTION_DEFAULT)
        an = sub.get(C.TELEMETRY_ANOMALY_TRACE, {}) or {}
        self._anomaly_given_keys = tuple(an)
        self.anomaly_trace_enabled = get_scalar_param(
            an, C.TELEMETRY_ANOMALY_TRACE_ENABLED,
            C.TELEMETRY_ANOMALY_TRACE_ENABLED_DEFAULT)
        self.anomaly_trace_factor = get_scalar_param(
            an, C.TELEMETRY_ANOMALY_TRACE_FACTOR,
            C.TELEMETRY_ANOMALY_TRACE_FACTOR_DEFAULT)
        self.anomaly_trace_window = get_scalar_param(
            an, C.TELEMETRY_ANOMALY_TRACE_WINDOW,
            C.TELEMETRY_ANOMALY_TRACE_WINDOW_DEFAULT)
        self.anomaly_trace_capture_steps = get_scalar_param(
            an, C.TELEMETRY_ANOMALY_TRACE_CAPTURE_STEPS,
            C.TELEMETRY_ANOMALY_TRACE_CAPTURE_STEPS_DEFAULT)

    def __repr__(self):
        return (f"TelemetryConfig(enabled={self.enabled}, "
                f"jsonl_path={self.jsonl_path!r}, "
                f"console={self.console}, "
                f"prometheus_textfile={self.prometheus_textfile!r}, "
                f"history={self.history}, "
                f"stamp_static_facts={self.stamp_static_facts}, "
                f"flops_per_token={self.flops_per_token}, "
                f"crash_dump_dir={self.crash_dump_dir!r}, "
                f"watchdog_enabled={self.watchdog_enabled}, "
                f"anomaly_trace_enabled={self.anomaly_trace_enabled})")



class DeepSpeedConfig:
    """Typed view of a DeepSpeed config dict or JSON file, world size 1
    unless given."""

    def __init__(self, json_file_or_dict, world_size=1):
        if isinstance(json_file_or_dict, dict):
            param_dict = json_file_or_dict
        else:
            with open(json_file_or_dict, "r") as f:
                param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        self._param_dict = param_dict
        later = sorted(set(param_dict) & set(_LATER_KEYS))
        if later:
            raise ValueError(
                "DeepSpeedConfig: " + "; ".join(
                    f"{k!r} is not yet ported to deepspeed_tpu_torch "
                    f"(ROADMAP.md section 1 {_LATER_KEYS[k]})"
                    for k in later))
        unknown = sorted(set(param_dict) - _PORTED_KEYS)
        if unknown:
            raise ValueError(
                f"DeepSpeedConfig: unknown key(s) {unknown}; the port "
                f"reads {sorted(_PORTED_KEYS)}")
        self.world_size = world_size
        self._initialize_params(param_dict)
        self._configure_train_batch_size()
        self._do_error_check()
        self._do_warning_check()
        if self.dump_state:
            self.print("DeepSpeedEngine configuration")

    def _initialize_params(self, param_dict):
        self.train_batch_size = get_scalar_param(
            param_dict, TRAIN_BATCH_SIZE, TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = get_scalar_param(
            param_dict, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = get_scalar_param(
            param_dict, GRADIENT_ACCUMULATION_STEPS,
            GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = get_scalar_param(
            param_dict, STEPS_PER_PRINT, STEPS_PER_PRINT_DEFAULT)

        self.fp16_enabled = get_fp16_enabled(param_dict)
        self.bf16_enabled = get_bf16_enabled(param_dict)
        self.loss_scale = get_loss_scale(param_dict)
        self.initial_dynamic_scale = get_initial_dynamic_scale(param_dict)
        self.dynamic_loss_scale_args = get_dynamic_loss_scale_args(
            param_dict)

        self.optimizer_name = get_optimizer_name(param_dict)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = get_optimizer_params(param_dict)
        self.scheduler_name = get_scheduler_name(param_dict)
        self.scheduler_params = get_scheduler_params(param_dict)
        self.gradient_clipping = get_scalar_param(
            param_dict, GRADIENT_CLIPPING, GRADIENT_CLIPPING_DEFAULT)
        self.sparse_attention = get_sparse_attention(param_dict)
        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0
        self.amp_enabled = get_amp_enabled(param_dict)
        self.amp_params = get_amp_params(param_dict)
        # JAX keeps these as no-ops: its cross-replica mean is fp32
        self.prescale_gradients = get_scalar_param(
            param_dict, C.PRESCALE_GRADIENTS, C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = get_scalar_param(
            param_dict, C.GRADIENT_PREDIVIDE_FACTOR,
            C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        # read, never used (as in JAX)
        self.fp32_allreduce = get_scalar_param(
            param_dict, C.FP32_ALLREDUCE, C.FP32_ALLREDUCE_DEFAULT)
        self.disable_allgather = get_scalar_param(
            param_dict, C.DISABLE_ALLGATHER, C.DISABLE_ALLGATHER_DEFAULT)
        self.zero_allow_untested_optimizer = get_scalar_param(
            param_dict, C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.dump_state = get_scalar_param(param_dict, C.DUMP_STATE,
                                           C.DUMP_STATE_DEFAULT)
        self.vocabulary_size = get_scalar_param(
            param_dict, C.VOCABULARY_SIZE, C.VOCABULARY_SIZE_DEFAULT)
        self.wall_clock_breakdown = get_scalar_param(
            param_dict, C.WALL_CLOCK_BREAKDOWN,
            C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = get_scalar_param(
            param_dict, C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT)
        # the torch.profiler trace window (telemetry/profiler.py):
        # {"trace_dir", "trace_start_step", "trace_num_steps", "history"},
        # checked by TraceProfiler when the engine builds it, as in JAX
        self.profiling_params = param_dict.get(C.PROFILING, None)
        # the directory of the kernel builds (telemetry/compile_cache.py)
        self.compilation_cache_dir = get_scalar_param(
            param_dict, C.COMPILATION_CACHE_DIR, None)
        tb = param_dict.get(C.TENSORBOARD) or {}
        self.tensorboard_enabled = get_scalar_param(
            tb, C.TENSORBOARD_ENABLED, C.TENSORBOARD_ENABLED_DEFAULT)
        self.tensorboard_output_path = get_scalar_param(
            tb, C.TENSORBOARD_OUTPUT_PATH, C.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.tensorboard_job_name = get_scalar_param(
            tb, C.TENSORBOARD_JOB_NAME, C.TENSORBOARD_JOB_NAME_DEFAULT)
        self.telemetry = TelemetryConfig(param_dict)
        self.inference = InferenceConfig(param_dict)
        from deepspeed_tpu_torch.runtime.activation_checkpointing.config \
            import DeepSpeedActivationCheckpointingConfig
        self.activation_checkpointing_config = \
            DeepSpeedActivationCheckpointingConfig(param_dict)
        self.pld_enabled = get_pld_enabled(param_dict)
        self.pld_params = get_pld_params(param_dict)
        self.sparse_gradients_enabled = get_sparse_gradients_enabled(
            param_dict)
        self.fp8 = Fp8Config(param_dict)
        self.comm_quantization = CommQuantizationConfig(param_dict)
        self.resilience = ResilienceConfig(param_dict)
        self.tensor_parallel = TensorParallelConfig(param_dict)
        self.pipeline = get_pipeline_config(param_dict)
        self.mesh_shape = get_mesh_config(param_dict)

    def _do_warning_check(self):
        """JAX ``_do_warning_check`` (``config.py:1666``)."""
        vocab = self.vocabulary_size
        if vocab and vocab % TENSOR_CORE_ALIGN_SIZE != 0:
            logger.warning(
                "DeepSpeedConfig: vocabulary size {} is not aligned to {}, "
                "may import tensor core utilization.".format(
                    vocab, TENSOR_CORE_ALIGN_SIZE))

    def print(self, name):
        logger.info("{}:".format(name))
        for arg in sorted(vars(self)):
            if arg != "_param_dict":
                dots = "." * (29 - len(arg))
                logger.info("  {} {} {}".format(arg, dots,
                                                getattr(self, arg)))
        logger.info("  json = {}".format(
            json.dumps(self._param_dict, sort_keys=True, indent=4,
                       separators=(",", ":"))))

    def _batch_assertion(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if not train_batch > 0:
            raise AssertionError(
                f"Train batch size: {train_batch} has to be greater than 0")
        if not micro_batch > 0:
            raise AssertionError(
                f"Micro batch size per gpu: {micro_batch} has to be greater "
                f"than 0")
        if not grad_acc > 0:
            raise AssertionError(
                f"Gradient accumulation steps: {grad_acc} has to be greater "
                f"than 0")
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise AssertionError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train_batch} != {micro_batch} * {grad_acc} * "
                f"{self.world_size}")

    def _set_batch_related_parameters(self):
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch is not None and micro_batch is not None and \
                grad_acc is not None:
            pass
        elif train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise ValueError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided")

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        self._batch_assertion()

    def _do_error_check(self):
        self._check_zero3()
        self._check_fp8()
        self._check_tensor_parallel()
        self._check_inference()
        if self.zero_enabled:
            assert self.fp16_enabled or self.bf16_enabled, (
                "DeepSpeedConfig: ZeRO is only supported with fp16 or bf16 "
                "enabled")
            assert self.zero_optimization_stage <= \
                MAX_STAGE_ZERO_OPTIMIZATION, (
                    f"DeepSpeedConfig: Maximum supported ZeRO stage is "
                    f"{MAX_STAGE_ZERO_OPTIMIZATION}")
        if self.fp16_enabled and self.bf16_enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
        self._check_comm_quantization()
        self._check_resilience()
        self._check_telemetry()

    def _check_telemetry(self):
        """JAX ``config.py:1483-1567``: its checks and texts."""
        tl = self.telemetry
        unknown = sorted(set(tl._given_keys) - set(tl.KEYS))
        if unknown:
            raise ValueError(
                f"telemetry: unknown key(s) {unknown}; "
                f"allowed: {sorted(tl.KEYS)}")
        for name, v in (("enabled", tl.enabled),
                        ("console", tl.console),
                        ("stamp_static_facts", tl.stamp_static_facts)):
            if not isinstance(v, bool):
                raise ValueError(
                    f"telemetry: {name} must be a bool, got {v!r}")
        for name, v in (("jsonl_path", tl.jsonl_path),
                        ("prometheus_textfile", tl.prometheus_textfile)):
            if v is not None and not isinstance(v, str):
                raise ValueError(
                    f"telemetry: {name} must be a path string or null, "
                    f"got {v!r}")
        for name, v, lo in (
                ("history", tl.history, 1),
                ("prometheus_write_every", tl.prometheus_write_every, 1)):
            if isinstance(v, bool) or not isinstance(v, int) or v < lo:
                raise ValueError(
                    f"telemetry: {name} must be an int >= {lo}, "
                    f"got {v!r}")
        fpt = tl.flops_per_token
        if isinstance(fpt, bool) or \
                not isinstance(fpt, (int, float)) or fpt < 0:
            raise ValueError(
                f"telemetry: flops_per_token must be a non-negative "
                f"number (0 = unknown), got {fpt!r}")
        self._check_telemetry_forensics(tl)

    def _check_telemetry_forensics(self, tl):
        from deepspeed_tpu_torch.telemetry.watchdog import WATCHDOG_ACTIONS
        if tl.crash_dump_dir is not None and \
                not isinstance(tl.crash_dump_dir, str):
            raise ValueError(
                f"telemetry: crash_dump_dir must be a path string or "
                f"null, got {tl.crash_dump_dir!r}")
        fh = tl.flight_history
        if isinstance(fh, bool) or not isinstance(fh, int) or fh < 1:
            raise ValueError(
                f"telemetry: flight_history must be an int >= 1, "
                f"got {fh!r}")
        for label, given, allowed in (
                ("watchdog", tl._watchdog_given_keys, tl.WATCHDOG_KEYS),
                ("anomaly_trace", tl._anomaly_given_keys, tl.ANOMALY_KEYS)):
            unknown = sorted(set(given) - set(allowed))
            if unknown:
                raise ValueError(
                    f"telemetry: unknown {label} key(s) {unknown}; "
                    f"allowed: {sorted(allowed)}")
        for name, v in (("watchdog.enabled", tl.watchdog_enabled),
                        ("anomaly_trace.enabled", tl.anomaly_trace_enabled)):
            if not isinstance(v, bool):
                raise ValueError(
                    f"telemetry: {name} must be a bool, got {v!r}")
        for name, v in (
                ("watchdog.deadline_factor", tl.watchdog_deadline_factor),
                ("watchdog.min_deadline_s", tl.watchdog_min_deadline_s),
                ("anomaly_trace.factor", tl.anomaly_trace_factor)):
            if isinstance(v, bool) or not isinstance(v, (int, float)) \
                    or v <= 0:
                raise ValueError(
                    f"telemetry: {name} must be a positive number, "
                    f"got {v!r}")
        if tl.watchdog_action not in WATCHDOG_ACTIONS:
            raise ValueError(
                f"telemetry: watchdog.action must be one of "
                f"{list(WATCHDOG_ACTIONS)}, got {tl.watchdog_action!r}")
        for name, v in (
                ("anomaly_trace.window", tl.anomaly_trace_window),
                ("anomaly_trace.capture_steps",
                 tl.anomaly_trace_capture_steps)):
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"telemetry: {name} must be an int >= 1, got {v!r}")
        if tl.watchdog_enabled and not tl.crash_dump_dir:
            raise ValueError(
                "telemetry: watchdog.enabled requires crash_dump_dir — "
                "the watchdog writes its heartbeat files and flight "
                "dumps there")

    def _check_resilience(self):
        """JAX ``config.py:1590-1664``: its checks and texts."""
        from deepspeed_tpu_torch.runtime.resilience.guards import (
            ACTION_ROLLBACK, ACTION_SKIP_STEP, VALID_ACTIONS)
        rz = self.resilience
        if rz.auto_resume and not rz.save_dir:
            raise ValueError(
                "resilience: auto_resume requires save_dir — there is "
                "nowhere to discover checkpoints from")
        if rz.save_interval_steps and not rz.save_dir:
            raise ValueError(
                "resilience: save_interval_steps requires save_dir")
        if rz.save_interval_steps < 0:
            raise ValueError(
                f"resilience: save_interval_steps must be >= 0, "
                f"got {rz.save_interval_steps}")
        if rz.keep_last_n < 0:
            raise ValueError(
                f"resilience: checkpoint.keep_last_n must be >= 0 "
                f"(0 keeps everything), got {rz.keep_last_n}")
        if rz.io_retries < 1:
            raise ValueError(
                f"resilience: checkpoint.io_retries must be >= 1, "
                f"got {rz.io_retries}")
        guard_actions = {
            "nan_grads": rz.nan_guard_action,
            "loss_spike": rz.loss_spike_action,
            "scale_collapse": rz.scale_collapse_action,
        }
        for guard, action in guard_actions.items():
            if action is None:
                continue
            if action not in VALID_ACTIONS:
                raise ValueError(
                    f"resilience: guards.{guard}.action must be one of "
                    f"{list(VALID_ACTIONS)} (or omitted to disable), "
                    f"got {action!r}")
            if action == ACTION_ROLLBACK and not rz.save_dir:
                raise ValueError(
                    f"resilience: guards.{guard}.action="
                    f"'rollback_to_checkpoint' requires save_dir — there "
                    "is no checkpoint to roll back to")
            if action == ACTION_SKIP_STEP and guard != "nan_grads":
                raise ValueError(
                    f"resilience: guards.{guard} detects the problem only "
                    "after the update has been applied, so 'skip_step' is "
                    "impossible — use 'warn', 'rollback_to_checkpoint' or "
                    "'abort'")
        if rz.scale_collapse_action is not None and not self.fp16_enabled:
            raise ValueError(
                "resilience: guards.scale_collapse watches the dynamic "
                "fp16 loss scale; it requires fp16 to be enabled")
        if rz.loss_spike_action is not None and \
                rz.loss_spike_min_history < 1:
            raise ValueError(
                f"resilience: guards.loss_spike.min_history must be >= 1, "
                f"got {rz.loss_spike_min_history}")
        if rz.scale_collapse_action is not None and \
                rz.scale_collapse_patience < 1:
            raise ValueError(
                f"resilience: guards.scale_collapse.patience must be >= 1, "
                f"got {rz.scale_collapse_patience}")
        if rz.hot_enabled:
            if rz.hot_interval_steps < 1:
                raise ValueError(
                    f"resilience: hot_checkpoint.interval_steps must be "
                    f">= 1 when the tier is enabled, "
                    f"got {rz.hot_interval_steps}")
            if rz.hot_capacity < 1:
                raise ValueError(
                    f"resilience: hot_checkpoint.capacity must be >= 1, "
                    f"got {rz.hot_capacity}")
            if rz.hot_mirror_keep < 1:
                raise ValueError(
                    f"resilience: hot_checkpoint.mirror_keep must be "
                    f">= 1, got {rz.hot_mirror_keep}")

    def _check_comm_quantization(self):
        """JAX ``config.py:1044-1066``: its checks and texts."""
        cq = self.comm_quantization
        if not cq.enabled:
            return
        assert cq.bits == 8, (
            f"comm_quantization: only 8-bit quantization is "
            f"implemented, got bits={cq.bits}")
        assert cq.chunk_size > 0 and cq.chunk_size % 2 == 0, (
            f"comm_quantization: chunk_size must be a positive even "
            f"int, got {cq.chunk_size}")
        assert cq.bucket_mb > 0, (
            f"comm_quantization: bucket_mb must be positive, "
            f"got {cq.bucket_mb}")
        assert self.zero_optimization_stage <= 2, (
            "comm_quantization covers the dense-DP / ZeRO-1/2 gradient "
            "sync; ZeRO-3 shards params per-use and has no full-grad "
            "all-reduce to quantize")
        assert self.optimizer_name != ONEBIT_ADAM_OPTIMIZER, (
            "comm_quantization and OneBitAdam both replace the "
            "gradient all-reduce — enable one comm compressor only")
        assert not self.sparse_gradients_enabled, (
            "comm_quantization is incompatible with sparse_gradients "
            "(the CSR path runs its own per-leaf exchange)")
        assert self.zero_config.cpu_offload is not True, (
            "comm_quantization requires the in-jit update path; "
            "ZeRO-Offload steps the optimizer on host")

    def _check_tensor_parallel(self):
        """JAX ``config.py:1391-1450``: its checks and texts."""
        from deepspeed_tpu_torch.parallel.collectives import OVERLAP_SITES
        from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
        tp = self.tensor_parallel

        def _bool(name, v):
            if not isinstance(v, bool):
                raise ValueError(
                    f"tensor_parallel.overlap: {name} must be a bool, "
                    f"got {v!r}")

        def _chunks(name, v):
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"tensor_parallel.overlap: {name} must be an int >= 1,"
                    f" got {v!r}")

        def _wire(name, v):
            if v is not None and v not in CODECS:
                raise ValueError(
                    f"tensor_parallel.overlap: {name} must be one of "
                    f"{sorted(CODECS)} (or null), got {v!r}")

        _bool("enabled", tp.overlap_enabled)
        _bool("bidirectional", tp.overlap_bidirectional)
        _chunks("chunks", tp.overlap_chunks)
        _wire("wire_dtype", tp.overlap_wire_dtype)
        _chunks("wire_chunk", tp.overlap_wire_chunk)
        sites = tp.overlap_sites
        if sites is None:
            return
        if not isinstance(sites, dict):
            raise ValueError(
                f"tensor_parallel.overlap: sites must be a dict of "
                f"per-site overrides, got {sites!r}")
        for site, ov in sites.items():
            if site not in OVERLAP_SITES:
                raise ValueError(
                    f"tensor_parallel.overlap: unknown site {site!r}; "
                    f"known: {list(OVERLAP_SITES)}")
            if not isinstance(ov, dict):
                raise ValueError(
                    f"tensor_parallel.overlap: sites[{site!r}] must be a "
                    f"dict, got {ov!r}")
            for key, v in ov.items():
                if key in (C.TP_OVERLAP_ENABLED, C.TP_OVERLAP_BIDIRECTIONAL):
                    _bool(f"sites[{site!r}].{key}", v)
                elif key in (C.TP_OVERLAP_CHUNKS, C.TP_OVERLAP_WIRE_CHUNK):
                    _chunks(f"sites[{site!r}].{key}", v)
                elif key == C.TP_OVERLAP_WIRE_DTYPE:
                    _wire(f"sites[{site!r}].{key}", v)
                else:
                    raise ValueError(
                        f"tensor_parallel.overlap: unknown key {key!r} in "
                        f"sites[{site!r}]; allowed: "
                        f"[{C.TP_OVERLAP_ENABLED!r}, "
                        f"{C.TP_OVERLAP_CHUNKS!r}, "
                        f"{C.TP_OVERLAP_BIDIRECTIONAL!r}, "
                        f"{C.TP_OVERLAP_WIRE_DTYPE!r}, "
                        f"{C.TP_OVERLAP_WIRE_CHUNK!r}]")

    def _check_zero3(self):
        """The stage-3 schedule keys (JAX ``config.py:1362``), then the
        ones the port does not run."""
        zc = self.zero_config

        def _bool(name, v):
            if not isinstance(v, bool):
                raise ValueError(
                    f"zero_optimization: {name} must be a bool, got {v!r}")

        _bool("gather_on_use", zc.gather_on_use)
        _bool("prefetch", zc.prefetch)
        _bool("bidirectional", zc.bidirectional)
        chunks = zc.gather_chunks
        if isinstance(chunks, bool) or not isinstance(chunks, int) or \
                chunks < 1:
            raise ValueError(
                f"zero_optimization: gather_chunks must be an int >= 1, "
                f"got {chunks!r}")

    def _check_fp8(self):
        """JAX ``_check_fp8`` (``config.py:1297``)."""
        from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
        f8 = self.fp8
        if not isinstance(f8.enabled, bool):
            raise ValueError(
                f"fp8: enabled must be a bool, got {f8.enabled!r}")
        if not isinstance(f8.wire_enabled, bool):
            raise ValueError(
                f"fp8.wire: enabled must be a bool, got "
                f"{f8.wire_enabled!r}")
        if isinstance(f8.margin, bool) or not isinstance(f8.margin, int) \
                or f8.margin < 0:
            raise ValueError(
                f"fp8: margin must be an int >= 0, got {f8.margin!r}")
        hl = f8.amax_history_len
        if isinstance(hl, bool) or not isinstance(hl, int) or hl < 1:
            raise ValueError(
                f"fp8: amax_history_len must be an int >= 1, got {hl!r}")
        if f8.sites is not None:
            if not isinstance(f8.sites, dict):
                raise ValueError(
                    f"fp8: sites must be a dict of per-site overrides, "
                    f"got {f8.sites!r}")
            for site, ov in f8.sites.items():
                if not isinstance(ov, dict):
                    raise ValueError(
                        f"fp8: sites[{site!r}] must be a dict, got {ov!r}")
                for key, v in ov.items():
                    if key != C.FP8_ENABLED:
                        raise ValueError(
                            f"fp8: unknown key {key!r} in sites[{site!r}];"
                            f" allowed: [{C.FP8_ENABLED!r}]")
                    if not isinstance(v, bool):
                        raise ValueError(
                            f"fp8: sites[{site!r}].{key} must be a bool, "
                            f"got {v!r}")
        if f8.wire_enabled:
            if f8.wire_dtype not in CODECS:
                raise ValueError(
                    f"fp8.wire: dtype must be one of {sorted(CODECS)}, "
                    f"got {f8.wire_dtype!r}")
            wc = f8.wire_chunk_size
            if isinstance(wc, bool) or not isinstance(wc, int) or wc < 1:
                raise ValueError(
                    f"fp8.wire: chunk_size must be an int >= 1, "
                    f"got {wc!r}")
            if self.comm_quantization.enabled:
                raise ValueError(
                    "fp8.wire and comm_quantization both quantize the "
                    "gradient exchange — enable one comm compressor only")
        if f8.enabled or f8.wire_enabled:
            if self.optimizer_name == ONEBIT_ADAM_OPTIMIZER:
                raise ValueError(
                    "fp8 is incompatible with OneBitAdam (both rewrite "
                    "the gradient exchange/state threading)")
            if self.sparse_gradients_enabled:
                raise ValueError(
                    "fp8 is incompatible with sparse_gradients (the CSR "
                    "path runs its own per-leaf exchange)")
            if self.zero_config.cpu_offload is True:
                raise ValueError(
                    "fp8 requires the in-jit update path; ZeRO-Offload "
                    "steps the optimizer on host")

    def _check_inference(self):
        from deepspeed_tpu_torch.runtime.comm.codecs import CODECS
        inf = self.inference
        unknown = sorted(set(inf._given_keys) - set(inf.KEYS))
        if unknown:
            raise ValueError(
                f"inference: unknown key(s) {unknown}; "
                f"allowed: {sorted(inf.KEYS)}")
        mb = inf.max_batch
        if isinstance(mb, bool) or not isinstance(mb, int) or mb < 1:
            raise ValueError(
                f"inference: max_batch must be an int >= 1, got {mb!r}")
        pc = inf.prefill_chunk
        if isinstance(pc, bool) or not isinstance(pc, int) or pc < 1:
            raise ValueError(
                f"inference: prefill_chunk must be an int >= 1, "
                f"got {pc!r}")
        buckets = inf.seq_buckets
        if not buckets:
            raise ValueError("inference: seq_buckets must be non-empty")
        prev = 0
        for b in buckets:
            if isinstance(b, bool) or not isinstance(b, int) or b < 1:
                raise ValueError(
                    f"inference: seq_buckets must be positive ints, "
                    f"got {b!r}")
            if b <= prev:
                raise ValueError(
                    f"inference: seq_buckets must be strictly increasing,"
                    f" got {list(buckets)}")
            if b % pc:
                raise ValueError(
                    f"inference: every seq bucket must be a multiple of "
                    f"prefill_chunk={pc}; got bucket {b}")
            prev = b
        kvd = inf.kv_cache_dtype
        if kvd is not None and kvd not in ("bf16", "f32", "fp32") \
                and kvd not in CODECS:
            raise ValueError(
                f"inference: kv_cache_dtype must be None, 'bf16', 'f32',"
                f" or a codec name from {sorted(CODECS)}; got {kvd!r}")
        mn = inf.max_new_tokens
        if isinstance(mn, bool) or not isinstance(mn, int) or mn < 1:
            raise ValueError(
                f"inference: max_new_tokens must be an int >= 1, "
                f"got {mn!r}")
        if inf.attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"inference: attention_impl must be 'dense' or 'flash', "
                f"got {inf.attention_impl!r}")
        bk = inf.attention_block_k
        if isinstance(bk, bool) or not isinstance(bk, int) or bk < 1:
            raise ValueError(
                f"inference: attention_block_k must be an int >= 1, "
                f"got {bk!r}")
        temp = inf.temperature
        if isinstance(temp, bool) or \
                not isinstance(temp, (int, float)) or temp < 0:
            raise ValueError(
                f"inference: temperature must be a number >= 0, "
                f"got {temp!r}")
        tk = inf.top_k
        if isinstance(tk, bool) or not isinstance(tk, int) or tk < 0:
            raise ValueError(
                f"inference: top_k must be an int >= 0, got {tk!r}")
        tp = inf.top_p
        if isinstance(tp, bool) or not isinstance(tp, (int, float)) \
                or not 0 < tp <= 1:
            raise ValueError(
                f"inference: top_p must be in (0, 1], got {tp!r}")
        seed = inf.sampling_seed
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise ValueError(
                f"inference: sampling_seed must be an int, got {seed!r}")
        if inf.kv_layout not in ("ring", "paged"):
            raise ValueError(
                f"inference: kv_layout must be 'ring' or 'paged', "
                f"got {inf.kv_layout!r}")
        ps = inf.page_size
        if isinstance(ps, bool) or not isinstance(ps, int) or ps < 0:
            raise ValueError(
                f"inference: page_size must be an int >= 0 (0 = auto), "
                f"got {ps!r}")
        if inf.kv_layout == "paged" and ps:
            if ps % pc:
                raise ValueError(
                    f"inference: page_size must be a multiple of "
                    f"prefill_chunk={pc}; got {ps}")
            if max(buckets) % ps:
                raise ValueError(
                    f"inference: page_size must divide the largest seq "
                    f"bucket {max(buckets)}; got {ps}")
        npg = inf.n_pages
        if isinstance(npg, bool) or not isinstance(npg, int) or npg < 0:
            raise ValueError(
                f"inference: n_pages must be an int >= 0 (0 = auto), "
                f"got {npg!r}")
        if npg == 1:
            raise ValueError(
                "inference: n_pages must be >= 2 when set (page 0 is "
                "the reserved trash page); got 1")
        if not isinstance(inf.prefix_cache, bool):
            raise ValueError(
                f"inference: prefix_cache must be a bool, "
                f"got {inf.prefix_cache!r}")
        hp = inf.host_park_threshold
        if isinstance(hp, bool) or not isinstance(hp, (int, float)) \
                or not 0 <= hp < 1:
            raise ValueError(
                f"inference: host_park_threshold must be in [0, 1), "
                f"got {hp!r}")
        nr = inf.replicas
        if isinstance(nr, bool) or not isinstance(nr, int) or nr < 1:
            raise ValueError(
                f"inference: replicas must be an int >= 1, got {nr!r}")
        mrd = inf.max_redispatch
        if isinstance(mrd, bool) or not isinstance(mrd, int) or mrd < 0:
            raise ValueError(
                f"inference: max_redispatch must be an int >= 0, "
                f"got {mrd!r}")
        mqd = inf.max_queue_depth
        if isinstance(mqd, bool) or not isinstance(mqd, int) or mqd < 1:
            raise ValueError(
                f"inference: max_queue_depth must be an int >= 1, "
                f"got {mqd!r}")
        for name, val in (("deadline_s", inf.deadline_s),
                          ("queue_timeout_s", inf.queue_timeout_s)):
            if val is None:
                continue        # also "disabled", like 0
            if isinstance(val, bool) or \
                    not isinstance(val, (int, float)) or val < 0:
                raise ValueError(
                    f"inference: {name} must be a number >= 0 "
                    f"(0 = disabled), got {val!r}")
        if not isinstance(inf.disaggregated, bool):
            raise ValueError(
                f"inference: disaggregated must be a bool, "
                f"got {inf.disaggregated!r}")
        for name, val in (("prefill_workers", inf.prefill_workers),
                          ("decode_workers", inf.decode_workers)):
            if isinstance(val, bool) or not isinstance(val, int) \
                    or val < 1:
                raise ValueError(
                    f"inference: {name} must be an int >= 1, "
                    f"got {val!r}")
        for name, val in (("prefill_max_batch", inf.prefill_max_batch),
                          ("decode_max_batch", inf.decode_max_batch)):
            if isinstance(val, bool) or not isinstance(val, int) \
                    or val < 0:
                raise ValueError(
                    f"inference: {name} must be an int >= 0 "
                    f"(0 = max_batch), got {val!r}")
        if inf.disaggregated:
            if inf.kv_layout != "paged":
                raise ValueError(
                    "inference: disaggregated serving requires "
                    "kv_layout='paged' — the prefill->decode handoff "
                    "is a KV page copy")
            if inf.replicas > 1:
                raise ValueError(
                    "inference: disaggregated and replicas > 1 are "
                    "mutually exclusive — tiers scale via "
                    "prefill_workers/decode_workers")
            if inf.speculative_enabled:
                raise ValueError(
                    "inference: disaggregated and speculative are "
                    "mutually exclusive — the draft/verify pair would "
                    "break the one-program-per-tier contract")
        if not isinstance(inf._speculative_raw, dict):
            raise ValueError(
                f"inference: speculative must be a dict block, "
                f"got {inf._speculative_raw!r}")
        spec_unknown = sorted(set(inf._speculative_given_keys)
                              - set(inf.SPECULATIVE_KEYS))
        if spec_unknown:
            raise ValueError(
                f"inference: speculative: unknown key(s) {spec_unknown};"
                f" allowed: {sorted(inf.SPECULATIVE_KEYS)}")
        if not isinstance(inf.speculative_enabled, bool):
            raise ValueError(
                f"inference: speculative.enabled must be a bool, "
                f"got {inf.speculative_enabled!r}")
        sk = inf.speculative_k
        if isinstance(sk, bool) or not isinstance(sk, int) or sk < 1:
            # the validated config is strict (k >= 1: a 0-token draft
            # is a misconfiguration, not a mode); only the ENGINE's
            # dict path treats k=0 as a degenerate disable
            raise ValueError(
                f"inference: speculative.k must be an int >= 1, "
                f"got {sk!r}")
        sd = inf.speculative_draft_layers
        if isinstance(sd, bool) or not isinstance(sd, int) or sd < 0:
            raise ValueError(
                f"inference: speculative.draft_layers must be an int "
                f">= 0 (0 = auto: n_layer // 2), got {sd!r}")
        sg = inf.speculative_min_accept_to_grow
        if isinstance(sg, bool) or not isinstance(sg, (int, float)) \
                or sg < 0:
            raise ValueError(
                f"inference: speculative.min_accept_to_grow must be a "
                f"number >= 0, got {sg!r}")
        if inf.speculative_enabled:
            if sk + 1 >= max(buckets):
                # the verify chunk writes k+1 slots per round; a k
                # within one chunk of the largest bucket leaves no
                # room to generate anything
                raise ValueError(
                    f"inference: speculative.k={sk} leaves no headroom "
                    f"in the largest seq bucket {max(buckets)} (need "
                    f"k + 1 < max bucket)")
            if nr > 1:
                # the fleet router's drain/redispatch bookkeeping is
                # written against the 2-program engine; speculative
                # serving is single-replica until the router learns
                # the 3-program contract
                raise ValueError(
                    f"inference: speculative decoding is mutually "
                    f"exclusive with replicas > 1 (got replicas={nr}); "
                    f"run speculative engines single-replica")

