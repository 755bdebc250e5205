"""Learning-rate schedules: LRRangeTest, OneCycle, WarmupLR,
WarmupDecayLR (port of ``deepspeed_tpu/runtime/lr_schedules.py``).

Each schedule is a host function ``lr_at(step)`` (and ``mom_at(step)``
for OneCycle) of the optimizer-step counter, evaluated in float32 as the
JAX schedules are, returning a Python float. The engine reads it once
per step and hands it to the optimizer with the other hyperparameters,
so nothing waits on the device.
"""

import math

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

_f32 = np.float32


class _Schedule:
    """Base: stateful step API around a pure per-step lr computation."""

    def __init__(self, last_batch_iteration=-1):
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        raise NotImplementedError

    def get_lr(self):
        if self.last_batch_iteration < 0:
            logger.warning("Attempting to get learning rate from scheduler "
                           "before it has started")
            return [0.0]
        return [self.lr_at(self.last_batch_iteration)]

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_Schedule):
    """LR range test: lr = min_lr * (1 + step_rate * interval(step))."""

    def __init__(self, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1,
                 optimizer=None):
        super().__init__(last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        interval = _f32(step) / _f32(self.step_size)
        if self.staircase:
            interval = np.floor(interval)
        return float(_f32(self.min_lr) *
                     (_f32(1) + _f32(self.step_rate) * interval))


class OneCycle(_Schedule):
    """1-cycle policy: triangular lr cycle then post-cycle decay; momentum
    cycling through ``mom_at(step)``."""

    def __init__(self, cycle_min_lr, cycle_max_lr, decay_lr_rate=0.0,
                 cycle_first_step_size=2000, cycle_second_step_size=None,
                 cycle_first_stair_count=0, cycle_second_stair_count=None,
                 decay_step_size=0, cycle_momentum=True, cycle_min_mom=0.8,
                 cycle_max_mom=0.9, decay_mom_rate=0.0,
                 last_batch_iteration=-1, optimizer=None):
        super().__init__(last_batch_iteration)
        first = float(cycle_first_step_size)
        second = float(cycle_second_step_size) \
            if cycle_second_step_size is not None else first
        self.total_size = first + second
        self.step_ratio = first / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = cycle_first_stair_count \
            if cycle_second_stair_count is None else cycle_second_stair_count
        self.decay_step_size = decay_step_size
        self.min_lr = cycle_min_lr
        self.max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.cycle_momentum = cycle_momentum
        self.min_mom = cycle_min_mom
        self.max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def _scale_factor(self, step):
        step = _f32(step)
        total = _f32(self.total_size)
        cycle = np.floor(_f32(1) + step / total)
        x = _f32(1) + step / total - cycle
        ratio = _f32(self.step_ratio)
        return x / ratio if x <= ratio else (x - _f32(1)) / (ratio - _f32(1))

    def _decay_interval(self, step):
        return (_f32(step) - _f32(self.total_size)) / \
            _f32(max(self.decay_step_size, 1))

    def lr_at(self, step):
        if _f32(step) <= _f32(self.total_size):
            return float(_f32(self.min_lr) + _f32(self.max_lr - self.min_lr)
                         * self._scale_factor(step))
        return float(_f32(self.min_lr) * (
            _f32(1) + _f32(self.decay_lr_rate) * self._decay_interval(step)))

    def mom_at(self, step):
        if _f32(step) <= _f32(self.total_size):
            return float(_f32(self.max_mom) - _f32(self.max_mom -
                                                   self.min_mom)
                         * self._scale_factor(step))
        return float(_f32(self.max_mom) * (
            _f32(1) + _f32(self.decay_mom_rate) * self._decay_interval(step)))

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        return [(self.mom_at(max(self.last_batch_iteration, 0)), 0.99)]


class WarmupLR(_Schedule):
    """Log-warmup from min_lr to max_lr over warmup_num_steps, then flat."""

    def __init__(self, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1,
                 optimizer=None):
        super().__init__(last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.delta_lr = warmup_max_lr - warmup_min_lr
        self.warmup_num_steps = warmup_num_steps
        self.inverse_log_warm_up = _f32(1.0) / _f32(
            math.log(float(warmup_num_steps)))

    def _gamma(self, step):
        if _f32(step) < _f32(self.warmup_num_steps):
            return self.inverse_log_warm_up * np.log(_f32(step) + _f32(1))
        return _f32(1.0)

    def lr_at(self, step):
        return float(_f32(self.min_lr) + _f32(self.delta_lr) *
                     self._gamma(step))


class WarmupDecayLR(WarmupLR):
    """Log-warmup then linear decay to zero at total_num_steps."""

    def __init__(self, total_num_steps, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 last_batch_iteration=-1, optimizer=None):
        self.total_num_steps = total_num_steps
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         last_batch_iteration)
        if self.total_num_steps < self.warmup_num_steps:
            logger.warning(
                "total_num_steps {} is less than warmup_num_steps {}".format(
                    total_num_steps, warmup_num_steps))

    def _gamma(self, step):
        if _f32(step) < _f32(self.warmup_num_steps):
            return self.inverse_log_warm_up * np.log(_f32(step) + _f32(1))
        return max(_f32(0.0), (_f32(self.total_num_steps) - _f32(step)) /
                   _f32(max(1.0, self.total_num_steps -
                            self.warmup_num_steps)))


SCHEDULE_REGISTRY = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_scheduler(name, params):
    """Instantiate a schedule by config name."""
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(
            f"unknown lr schedule {name}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](**params)
