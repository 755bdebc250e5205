"""Static and dynamic loss scaling (port of
``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The state is a tuple of 0-d device tensors and :func:`update_loss_scale`
is a pure function built from ``torch.where``, so the overflow-driven
update runs on the device inside the train step without a host sync,
as the JAX version runs inside ``jit``. The stateful ``LossScaler`` /
``DynamicLossScaler`` classes keep the reference's host API.
"""

from typing import NamedTuple

import torch


class LossScaleState(NamedTuple):
    cur_scale: torch.Tensor           # f32 scalar
    cur_iter: torch.Tensor            # i32 scalar
    last_overflow_iter: torch.Tensor  # i32 scalar
    cur_hysteresis: torch.Tensor      # i32 scalar


def init_loss_scale_state(init_scale=2 ** 32, delayed_shift=1, device=None):
    def t(x, dtype):
        return torch.tensor(x, dtype=dtype, device=device)
    return LossScaleState(cur_scale=t(init_scale, torch.float32),
                          cur_iter=t(0, torch.int32),
                          last_overflow_iter=t(-1, torch.int32),
                          cur_hysteresis=t(delayed_shift, torch.int32))


def update_loss_scale(state, overflow, scale_factor=2.0, scale_window=1000,
                      min_scale=1.0, delayed_shift=1,
                      consecutive_hysteresis=False):
    """Pure DynamicLossScaler.update_scale (``loss_scaler.py:35``):
    ``overflow`` a bool tensor (or bool)."""
    overflow = torch.as_tensor(overflow, device=state.cur_scale.device)
    # overflow branch
    shift_now = (state.cur_hysteresis == 1) | (delayed_shift == 1)
    scale_on_overflow = torch.where(
        shift_now,
        torch.clamp(state.cur_scale / scale_factor, min=min_scale),
        state.cur_scale)
    hyst_on_overflow = torch.where(shift_now, state.cur_hysteresis,
                                   state.cur_hysteresis - 1)
    # no-overflow branch
    window_hit = torch.remainder(state.cur_iter - state.last_overflow_iter,
                                 scale_window) == 0
    scale_on_ok = torch.where(window_hit, state.cur_scale * scale_factor,
                              state.cur_scale)
    if consecutive_hysteresis:
        hyst_on_ok = torch.full_like(state.cur_hysteresis, delayed_shift)
    else:
        hyst_on_ok = torch.where(
            window_hit, torch.full_like(state.cur_hysteresis, delayed_shift),
            state.cur_hysteresis)
    return LossScaleState(
        cur_scale=torch.where(overflow, scale_on_overflow, scale_on_ok),
        cur_iter=state.cur_iter + 1,
        last_overflow_iter=torch.where(overflow, state.cur_iter,
                                       state.last_overflow_iter),
        cur_hysteresis=torch.where(overflow, hyst_on_overflow,
                                   hyst_on_ok).to(torch.int32))


class LossScalerBase:
    def __init__(self, cur_scale):
        self.cur_scale = cur_scale

    @property
    def loss_scale(self):
        return self.cur_scale

    def scale_gradient(self, grads):
        return [g * self.loss_scale for g in grads]

    def update_scale(self, overflow):
        pass

    def backward(self, loss):
        """The scaled loss to differentiate."""
        return loss * self.loss_scale


class LossScaler(LossScalerBase):
    """Static loss scale (reference ``loss_scaler.py:56``)."""

    def __init__(self, scale=1):
        super().__init__(scale)

    def has_overflow(self, params):
        return False


class DynamicLossScaler(LossScalerBase):
    """Stateful wrapper with reference semantics, backed by
    :func:`update_loss_scale`."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0,
                 scale_window=1000, min_scale=1, delayed_shift=1,
                 consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.cur_iter = 0
        self.last_overflow_iter = -1
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis

    def _state(self):
        return LossScaleState(
            cur_scale=torch.tensor(self.cur_scale, dtype=torch.float32),
            cur_iter=torch.tensor(self.cur_iter, dtype=torch.int32),
            last_overflow_iter=torch.tensor(self.last_overflow_iter,
                                            dtype=torch.int32),
            cur_hysteresis=torch.tensor(self.cur_hysteresis,
                                        dtype=torch.int32))

    def update_scale(self, overflow):
        new = update_loss_scale(
            self._state(), bool(overflow), scale_factor=self.scale_factor,
            scale_window=self.scale_window, min_scale=self.min_scale,
            delayed_shift=self.delayed_shift,
            consecutive_hysteresis=self.consecutive_hysteresis)
        self.cur_scale = float(new.cur_scale)
        self.cur_iter = int(new.cur_iter)
        self.last_overflow_iter = int(new.last_overflow_iter)
        self.cur_hysteresis = int(new.cur_hysteresis)

    def has_overflow(self, grads):
        return any(not bool(torch.isfinite(g).all()) for g in grads)


def CreateLossScaler(static_loss_scale=None, dynamic_scale_args=None):
    """Static scale -> LossScaler, else dynamic."""
    if static_loss_scale is not None and static_loss_scale > 0:
        return LossScaler(scale=static_loss_scale)
    if dynamic_scale_args is not None:
        return DynamicLossScaler(**dynamic_scale_args)
    return DynamicLossScaler()
