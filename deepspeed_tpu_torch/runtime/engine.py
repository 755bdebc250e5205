"""DeepSpeedEngine, dense path on one device (port of
``deepspeed_tpu/runtime/engine.py``).

One ``train_batch`` is the JAX compiled train step (``engine.py:1023``)
run eagerly:

- gradient accumulation: a Python loop over the micro-batches (the JAX
  ``lax.scan``), each one ``(loss * scale).backward()`` into the fp32
  master params' ``.grad``;
- fp32 master params, cast to the compute dtype inside the forward (the
  port's ``Dense`` / embedding casts, as the JAX engine casts the tree);
- :func:`grad_epilogue`: unscale and average, the fp16 overflow check,
  the global norm and clipping, in place on the gradients;
- Adam / AdamW: every step is one launch of the fused kernel K4
  (``ops/fused_adam.py``), with or without ``optimizer.params.pallas``
  (the JAX engine's choice between XLA and its Pallas kernel);
- the fp16 overflow skip and :func:`loss_scale_epilogue` on device
  tensors (``torch.where``, no host sync); counters as in
  ``DeviceState``.

Nothing in a step waits on the device except the ``steps_per_print``
log line. ZeRO, offload, 1-bit Adam, LAMB, sparse gradients, comm
quantization, fp8, the pipeline, progressive layer drop, telemetry,
checkpoints and the data loader are not yet ported: their config blocks
raise in ``runtime/config.py`` and their arguments raise here.

Randomness: the step's dropout seed is an int32 derived from
``(seed, global_steps)`` with ``fold_in_seed`` (micro-batch ``i`` folds
in ``i``; the forward/backward API uses stream 1 and ``micro_steps``),
and the model seeds its hidden-dropout ``torch.Generator`` from it. This
deliberately does not reproduce the JAX engine's ``jax.random`` stream;
the attention-prob dropout mask is still the bit-identical counter hash
for a given int32 seed.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import init_adam_state
from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
from deepspeed_tpu_torch.ops.fused_adam import fused_adam_update
from deepspeed_tpu_torch.runtime.config import (
    ADAM_OPTIMIZER,
    DeepSpeedConfig,
    LAMB_OPTIMIZER,
    ONEBIT_ADAM_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    init_loss_scale_state,
    update_loss_scale,
)
from deepspeed_tpu_torch.runtime.lr_schedules import (
    OneCycle,
    get_lr_scheduler,
)
from deepspeed_tpu_torch.runtime.utils import (
    check_overflow,
    clip_by_global_norm,
    global_norm,
)
from deepspeed_tpu_torch.utils.logging import log_dist


class DeviceState(NamedTuple):
    """Step state kept on the device (0-d tensors)."""
    loss_scale: Any              # LossScaleState
    global_step: torch.Tensor    # i32: optimizer-step boundaries seen
    skipped_steps: torch.Tensor  # i32: overflow-skipped steps
    consecutive_skipped: torch.Tensor  # i32: current skip streak


def grad_epilogue(grads, scale, accum, fp16, clip):
    """Unscale and average over micro-batches, the fp16 overflow check,
    the global norm and clipping (``engine.py:99``), IN PLACE on
    ``grads`` (the engine's ``.grad`` buffers, so the fused optimizer's
    leaf table keeps its pointers). Returns ``(overflow, nonfinite,
    grad_norm, applied_norm)`` as 0-d device tensors."""
    denom = scale * accum
    for g in grads:
        g.div_(denom)
    device = grads[0].device
    if fp16:
        nonfinite = check_overflow(grads)
        overflow = nonfinite
    else:
        nonfinite = overflow = torch.zeros((), dtype=torch.bool,
                                           device=device)
    grad_norm = global_norm(grads)
    applied_norm = grad_norm
    if clip > 0:
        clipped = clip_by_global_norm(grads, clip, norm=grad_norm)
        for g, c in zip(grads, clipped):
            g.copy_(c)
        applied_norm = global_norm(grads)
    return overflow, nonfinite, grad_norm, applied_norm


def loss_scale_epilogue(dstate, overflow, fp16, dynamic, scale_args):
    """Dynamic-loss-scale update and step/skip counters
    (``engine.py:141``)."""
    if fp16 and dynamic:
        new_scale = update_loss_scale(dstate.loss_scale, overflow,
                                      **scale_args)
    else:
        new_scale = dstate.loss_scale
    ovf = overflow.to(torch.int32)
    return DeviceState(
        loss_scale=new_scale,
        global_step=dstate.global_step + 1,
        skipped_steps=dstate.skipped_steps + ovf,
        consecutive_skipped=(dstate.consecutive_skipped + 1) * ovf)


def step_metrics(loss_sum, accum, grad_norm, applied_norm, lr, scale,
                 overflow, dstate=None, nonfinite=None):
    """The step's metrics dict (``engine.py:159``); values stay on the
    device until read."""
    out = {"loss": loss_sum / accum, "grad_norm": grad_norm,
           "applied_grad_norm": applied_norm, "lr": lr,
           "loss_scale": scale, "overflow": overflow}
    if dstate is not None:
        out["skipped_steps"] = dstate.skipped_steps
        out["consecutive_skipped_steps"] = dstate.consecutive_skipped
    if nonfinite is not None:
        out["grad_nonfinite"] = nonfinite
    return out


def make_grad_accumulator(loss_fn, accum):
    """``accumulate(params, micro_batches, seeds, scale) -> loss_sum``
    (``engine.py:182``): for each of the ``accum`` micro-batches, the
    scaled loss's backward adds into the params' ``.grad``. Returns the
    unscaled loss sum (a 0-d f32 tensor, detached)."""

    def accumulate(micro_batches, seeds, scale):
        if len(micro_batches) != accum:
            raise ValueError(f"expected {accum} micro-batches, got "
                             f"{len(micro_batches)}")
        loss_sum = None
        for micro, seed in zip(micro_batches, seeds):
            loss = loss_fn(micro, seed)
            (loss * scale).backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum

    return accumulate


_NOT_YET = ("not yet ported to deepspeed_tpu_torch (the dense training "
            "path runs on one device)")


class DeepSpeedEngine:
    """Training engine around an ``nn.Module`` with fp32 master params
    and ``loss_fn(batch, rng) -> scalar loss``."""

    def __init__(self, model, loss_fn, config, device, optimizer=None,
                 model_parameters=None, lr_scheduler=None, seed=0):
        if optimizer is not None:
            raise NotImplementedError(f"client optimizer objects are "
                                      f"{_NOT_YET}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.module = model
        self.loss_fn = loss_fn
        self.device = device
        self.seed = int(seed)
        self._config = DeepSpeedConfig(config, world_size=1)

        if self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif self._config.bf16_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        model_dtype = getattr(getattr(model, "config", None), "dtype",
                              self.compute_dtype)
        if model_dtype != self.compute_dtype:
            raise ValueError(
                f"the model computes in {model_dtype} but the config asks "
                f"for {self.compute_dtype}: build the model with "
                f"dtype={self.compute_dtype}")
        self.dynamic_loss_scale = (self._config.fp16_enabled and
                                   self._config.loss_scale == 0)
        self.static_loss_scale = float(self._config.loss_scale) \
            if self._config.fp16_enabled and self._config.loss_scale > 0 \
            else 1.0

        self.params = [p for p in (model.parameters()
                                   if model_parameters is None
                                   else model_parameters)
                       if p.requires_grad]
        for p in self.params:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError(
                    f"master params must be fp32 on {device}, got "
                    f"{p.dtype} on {p.device}")
            if p.grad is None:
                p.grad = torch.zeros_like(p)

        self.micro_steps = 0
        self.global_steps = 0
        self._configure_optimizer()
        self._configure_lr_scheduler(lr_scheduler)
        self.opt_state = init_adam_state(self.params)
        self.device_state = self._init_device_state()
        self._accumulate = make_grad_accumulator(
            loss_fn, self._config.gradient_accumulation_steps)
        self._pending_loss = None
        self._micro_loss_sum = None     # forward/backward API, this step
        self._last_metrics = {}

    # ------------------------------------------------------------------
    # configuration accessors
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bf16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    @property
    def config(self):
        return self._config

    @property
    def loss_scale(self):
        if self.dynamic_loss_scale:
            return float(self.device_state.loss_scale.cur_scale)
        return self.static_loss_scale

    @property
    def skipped_steps(self):
        return int(self.device_state.skipped_steps)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _configure_optimizer(self):
        """Adam / AdamW from the config (``engine.py:785-865``)."""
        name = (self._config.optimizer_name or ADAM_OPTIMIZER).lower()
        opt = dict(self._config.optimizer_params or {})
        self._base_lr = opt.pop("lr", 1e-3)
        self._betas = tuple(opt.pop("betas", (0.9, 0.999)))
        self._eps = opt.pop("eps", 1e-8)
        self._weight_decay = opt.pop("weight_decay", 0.0)
        self._bias_correction = opt.pop("bias_correction", True)
        self.optimizer_name = name
        if name in (LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER):
            raise NotImplementedError(f"optimizer {name!r} is {_NOT_YET}")
        if name not in (ADAM_OPTIMIZER, "adamw"):
            raise ValueError(f"unknown optimizer {name!r}; supported: adam, "
                             f"adamw, lamb, onebitadam")
        self._adam_w_mode = opt.pop("adam_w_mode", name == "adamw")
        # "pallas" is accepted for config compatibility and chooses
        # nothing: every step runs K4, whose wrapper runs its plain
        # version on CPU tensors
        opt.pop("pallas", None)

    def _configure_lr_scheduler(self, client_scheduler):
        """Schedule resolution (``engine.py:867``): host functions of the
        optimizer-step counter."""
        self.lr_scheduler = client_scheduler
        if client_scheduler is None and \
                self._config.scheduler_name is not None:
            self.lr_scheduler = get_lr_scheduler(
                self._config.scheduler_name,
                self._config.scheduler_params or {})
        sched = self.lr_scheduler
        if sched is not None and hasattr(sched, "lr_at"):
            self._lr_fn = sched.lr_at
        elif sched is not None and hasattr(sched, "get_lr"):
            def lr_fn(step):
                lrs = sched.get_lr()
                return float(lrs[0] if isinstance(lrs, (list, tuple))
                             else lrs)
            self._lr_fn = lr_fn
        else:
            base = float(self._base_lr)
            self._lr_fn = lambda step: base
        if isinstance(sched, OneCycle) and sched.cycle_momentum:
            self._mom_fn = sched.mom_at
        else:
            beta1 = float(self._betas[0])
            self._mom_fn = lambda step: beta1

    def _scale_args(self):
        args = dict(scale_factor=2.0, scale_window=1000, min_scale=1.0,
                    delayed_shift=1, consecutive_hysteresis=False)
        a = self._config.dynamic_loss_scale_args
        if a:
            args.update(scale_window=a.get("scale_window", 1000),
                        min_scale=a.get("min_scale", 1.0),
                        delayed_shift=a.get("delayed_shift", 1))
        return args

    def _init_device_state(self):
        init_scale = float(self._config.initial_dynamic_scale) \
            if self.dynamic_loss_scale else self.static_loss_scale
        a = self._config.dynamic_loss_scale_args or {}
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return DeviceState(
            loss_scale=init_loss_scale_state(
                init_scale, a.get("delayed_shift", 1), device=self.device),
            global_step=zero, skipped_steps=zero, consecutive_skipped=zero)

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _scale(self):
        if self._config.fp16_enabled and self.dynamic_loss_scale:
            return self.device_state.loss_scale.cur_scale
        return self.static_loss_scale

    def _to_device(self, batch):
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device)
                for k, v in batch.items()}

    def _micro_batches(self, batch):
        accum = self._config.gradient_accumulation_steps
        expected = self._config.train_batch_size
        placed = self._to_device(batch)
        for name, x in placed.items():
            if x.shape[0] != expected:
                raise ValueError(
                    f"train_batch expects {expected} rows "
                    f"(train_batch_size), got {x.shape[0]} for {name!r}")
        micro = expected // accum
        return [{k: x[i * micro:(i + 1) * micro] for k, x in placed.items()}
                for i in range(accum)]

    def _step_seed(self, stream, counter):
        return fold_in_seed(fold_in_seed(self.seed, stream), counter)

    @torch.no_grad()
    def _apply_step(self, loss_sum, accum):
        """Everything after the backward: epilogue, optimizer, overflow
        skip, loss scale and counters. Returns the metrics dict."""
        fp16 = self._config.fp16_enabled
        clip = float(self._config.gradient_clipping or 0.0)
        scale = self._scale()
        grads = [p.grad for p in self.params]
        overflow, nonfinite, grad_norm, applied_norm = grad_epilogue(
            grads, scale, accum, fp16, clip)
        lr = float(self._lr_fn(self.global_steps))
        beta1 = float(self._mom_fn(self.global_steps))
        self.opt_state = fused_adam_update(
            [p.data for p in self.params], grads, self.opt_state, lr=lr,
            beta1=beta1, beta2=self._betas[1], eps=self._eps,
            weight_decay=self._weight_decay, adam_w_mode=self._adam_w_mode,
            bias_correction=self._bias_correction,
            skip=overflow if fp16 else None)
        self.device_state = loss_scale_epilogue(
            self.device_state, overflow, fp16, self.dynamic_loss_scale,
            self._scale_args())
        torch._foreach_zero_(grads)
        metrics = step_metrics(loss_sum, accum, grad_norm, applied_norm, lr,
                               scale, overflow, dstate=self.device_state,
                               nonfinite=nonfinite)
        self.global_steps += 1
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
        if self.global_steps % self._config.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped="
                     f"{self.skipped_steps}, lr={lr:.6g}, "
                     f"loss={float(metrics['loss']):.5f}", ranks=[0])
        self._last_metrics = metrics
        return metrics

    def train_batch(self, batch=None):
        """One optimizer step over a global batch (``engine.py:2537``):
        ``batch`` is a dict of arrays or tensors with leading dim
        ``train_batch_size``. Returns the mean loss (a 0-d tensor)."""
        if batch is None:
            raise ValueError("no training_data given; pass a batch "
                             "explicitly (the data loader is "
                             f"{_NOT_YET})")
        accum = self._config.gradient_accumulation_steps
        micro = self._micro_batches(batch)
        step_seed = self._step_seed(0, self.global_steps)
        seeds = [fold_in_seed(step_seed, i) for i in range(accum)]
        self.module.train()
        loss_sum = self._accumulate(micro, seeds, self._scale())
        self.micro_steps += accum
        return self._apply_step(loss_sum, accum)["loss"]

    @torch.no_grad()
    def eval_batch(self, batch):
        """Forward-only loss over a batch (no dropout, no state change)."""
        return self.loss_fn(self._to_device(batch), None)

    # ------------------------------------------------------------------
    # forward/backward/step API (``engine.py:2837-2928``)
    # ------------------------------------------------------------------
    def forward(self, batch):
        """The micro-batch loss, with its autograd graph for
        :meth:`backward`."""
        seed = self._step_seed(1, self.micro_steps)
        self._pending_loss = self.loss_fn(self._to_device(batch), seed)
        return self._pending_loss

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def backward(self, loss=None):
        """Accumulate the scaled gradient of the micro-batch loss."""
        if loss is None:
            loss = self._pending_loss
        if loss is None:
            raise ValueError("call forward(batch) first or pass the loss")
        (loss * self._scale()).backward()
        loss_sum = loss.detach().float()
        if self._micro_loss_sum is not None:
            loss_sum = loss_sum + self._micro_loss_sum
        self._micro_loss_sum = loss_sum
        self.micro_steps += 1
        self._pending_loss = None
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % \
            self._config.gradient_accumulation_steps == 0

    def step(self):
        """Apply the accumulated gradients at the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._micro_loss_sum is None:
            raise ValueError("no gradients accumulated")
        loss_sum, self._micro_loss_sum = self._micro_loss_sum, None
        self._apply_step(loss_sum, self._config.gradient_accumulation_steps)
