"""ZeRO optimization config object (a copy of
``deepspeed_tpu/runtime/zero/config.py``: same keys, defaults and legacy
boolean form ``"zero_optimization": true``, the deprecated
``allgather_size`` key included).

The port reads every key; what runs is decided in ``runtime/config.py``:
stages 0-3 over the data-parallel processes, with or without
``cpu_offload``; ``gather_chunks`` and ``bidirectional`` shape the
stage-3 gathers (``runtime/zero/comm.py:Comm.all_gather_striped``).
"""

from deepspeed_tpu_torch.runtime.zero.constants import (
    ZERO_FORMAT,
    ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_BIDIRECTIONAL,
    ZERO_OPTIMIZATION_BIDIRECTIONAL_DEFAULT,
    ZERO_OPTIMIZATION_GATHER_CHUNKS,
    ZERO_OPTIMIZATION_GATHER_CHUNKS_DEFAULT,
    ZERO_OPTIMIZATION_GATHER_ON_USE,
    ZERO_OPTIMIZATION_GATHER_ON_USE_DEFAULT,
    ZERO_OPTIMIZATION_PREFETCH,
    ZERO_OPTIMIZATION_PREFETCH_DEFAULT,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT,
    ZERO_OPTIMIZATION_CPU_OFFLOAD,
    ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT,
    ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS,
    ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS_DEFAULT,
    ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB,
    ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB_DEFAULT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT,
    ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
    ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT,
    ZERO_OPTIMIZATION_OPTIMIZER_STATES,
    ZERO_OPTIMIZATION_OVERLAP_COMM,
    ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_SCATTER,
    ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT,
    ZERO_OPTIMIZATION_STAGE,
    ZERO_OPTIMIZATION_STAGE_DEFAULT,
)


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


class DeepSpeedZeroConfig:
    def __init__(self, param_dict):
        self.stage = None
        self.contiguous_gradients = None
        self.reduce_scatter = None
        self.reduce_bucket_size = None
        self.allgather_partitions = None
        self.allgather_bucket_size = None
        self.overlap_comm = None
        self.load_from_fp32_weights = None
        self.cpu_offload = None
        self.offload_16bit_grads = None
        self.offload_chunk_mb = None
        self.elastic_checkpoint = None
        self.gather_on_use = None
        self.gather_chunks = None
        self.prefetch = None
        self.bidirectional = None

        if ZERO_OPTIMIZATION in param_dict:
            zero_config_dict = param_dict[ZERO_OPTIMIZATION]
            if isinstance(zero_config_dict, bool):
                zero_config_dict = self.read_zero_config_deprecated(param_dict)
        else:
            zero_config_dict = {}
        self._initialize(zero_config_dict)

    def read_zero_config_deprecated(self, param_dict):
        # Legacy `"zero_optimization": true` boolean form → stage 1.
        zero_config_dict = {
            ZERO_OPTIMIZATION_STAGE:
                ZERO_OPTIMIZATION_OPTIMIZER_STATES
                if param_dict[ZERO_OPTIMIZATION] else 0
        }
        if ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED in param_dict:
            zero_config_dict[ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE] = \
                param_dict[ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED]
        return zero_config_dict

    def _initialize(self, zero_config_dict):
        self.stage = get_scalar_param(zero_config_dict,
                                      ZERO_OPTIMIZATION_STAGE,
                                      ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.contiguous_gradients = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
            ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_bucket_size = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
            ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT)
        self.reduce_scatter = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_REDUCE_SCATTER,
            ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT)
        self.overlap_comm = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_OVERLAP_COMM,
            ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT)
        self.allgather_partitions = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
            ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT)
        self.allgather_bucket_size = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
            ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        self.load_from_fp32_weights = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
            ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT)
        self.cpu_offload = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_CPU_OFFLOAD,
            ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self.offload_16bit_grads = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS,
            ZERO_OPTIMIZATION_OFFLOAD_16BIT_GRADS_DEFAULT)
        self.offload_chunk_mb = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB,
            ZERO_OPTIMIZATION_OFFLOAD_CHUNK_MB_DEFAULT)
        self.elastic_checkpoint = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
            ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT)
        self.gather_on_use = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_GATHER_ON_USE,
            ZERO_OPTIMIZATION_GATHER_ON_USE_DEFAULT)
        self.gather_chunks = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_GATHER_CHUNKS,
            ZERO_OPTIMIZATION_GATHER_CHUNKS_DEFAULT)
        self.prefetch = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_PREFETCH,
            ZERO_OPTIMIZATION_PREFETCH_DEFAULT)
        self.bidirectional = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_BIDIRECTIONAL,
            ZERO_OPTIMIZATION_BIDIRECTIONAL_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        return str(self.__dict__)
