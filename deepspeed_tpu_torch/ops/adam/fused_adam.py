"""Fused Adam / AdamW optimizer (port of
``deepspeed_tpu/ops/adam/fused_adam.py``).

:func:`adam_update` is the functional update: it returns new tensors
and leaves its inputs alone, with the per-leaf arithmetic of the
one-pass in-place kernel K4 (:mod:`deepspeed_tpu_torch.ops.fused_adam`),
which the engine runs on every step.
"""

from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch.ops.fused_adam import (
    adam_leaf_update,
    bias_corrections,
)


class AdamState(NamedTuple):
    m: Any              # first moments, fp32, one per param leaf
    v: Any              # second moments, fp32
    step: torch.Tensor  # int32 scalar: applied (non-skipped) steps


def init_adam_state(params):
    """Zero moments beside ``params`` (a list of tensors), step 0 on the
    params' device."""
    params = list(params)
    device = params[0].device if params else None
    return AdamState(
        m=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params],
        v=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params],
        step=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def adam_update(params, grads, state, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, adam_w_mode=True, bias_correction=True):
    """One Adam(W) step (``fused_adam.py:32``). Returns
    ``(new_params, new_state)``; ADAM_MODE_0 (``adam_w_mode``) decouples
    weight decay from the moments, ADAM_MODE_1 folds ``weight_decay * p``
    into the gradient. The arithmetic is K4's
    (:func:`adam_leaf_update`), with the hyperparameters as Python
    floats as the JAX XLA update takes them."""
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, state.m, state.v):
        p_n, m_n, v_n = adam_leaf_update(
            p.to(torch.float32), g.to(torch.float32), m, v, lr, beta1, beta2,
            eps, weight_decay, bc1, bc2, adam_w_mode)
        new_p.append(p_n.to(p.dtype))
        new_m.append(m_n)
        new_v.append(v_n)
    return new_p, AdamState(m=new_m, v=new_v, step=step)


class FusedAdam:
    """API-parity wrapper around the functional update: the reference
    constructor surface (lr, betas, eps, weight_decay, adam_w_mode,
    bias_correction); ``amsgrad`` is rejected the same way."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.params = None if params is None else list(params)
        self.state = init_adam_state(self.params) if params is not None \
            else None

    def init(self, params):
        return init_adam_state(params)

    def update(self, params, grads, state, lr=None, beta1=None):
        return adam_update(
            params, grads, state,
            lr=self.lr if lr is None else lr,
            beta1=self.betas[0] if beta1 is None else beta1,
            beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction)

    def step(self, grads):
        """Imperative convenience: updates the held params and state."""
        if self.params is None:
            raise ValueError("construct with params to use .step()")
        self.params, self.state = self.update(self.params, grads,
                                              self.state)
        return self.params
