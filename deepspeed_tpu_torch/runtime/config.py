"""DeepSpeed JSON/dict config, dense training subset (port of
``deepspeed_tpu/runtime/config.py`` and ``config_utils.py``).

Ported: the batch triple solver (``train_batch_size = micro_batch *
grad_accum * world_size``) and ``_batch_assertion``, ``fp16`` / ``bf16``
with the loss-scale arguments, the ``optimizer`` and ``scheduler``
sections (``optimizer.params.pallas`` kept: it routes Adam to the fused
kernel K4), ``gradient_clipping`` and ``steps_per_print``. Key names
and error texts are the JAX package's. Every other top-level section
raises "not yet ported" instead of being silently ignored.
"""

import collections
import json

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
    TYPE)

ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER]

# top-level keys of the dense path; anything else is a feature of the JAX
# package the port does not run yet
_PORTED_KEYS = frozenset((
    TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    GRADIENT_ACCUMULATION_STEPS, STEPS_PER_PRINT, FP16, BF16, OPTIMIZER,
    SCHEDULER, GRADIENT_CLIPPING))


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while parsing a JSON config."""
    d = dict((k, v) for k, v in ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = collections.Counter([pair[0] for pair in ordered_pairs])
        keys = [key for key, value in counter.items() if value > 1]
        raise ValueError("Duplicate keys in DeepSpeed config: {}".format(keys))
    return d


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
        unported = sorted(set(param_dict) - _PORTED_KEYS)
        if unported:
            raise ValueError(
                f"DeepSpeedConfig: {unported} not yet ported to "
                f"deepspeed_tpu_torch (the dense training path reads "
                f"{sorted(_PORTED_KEYS)})")
        self.world_size = world_size
        self._initialize_params(param_dict)
        self._configure_train_batch_size()
        self._do_error_check()

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
        if self.fp16_enabled and self.bf16_enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")
