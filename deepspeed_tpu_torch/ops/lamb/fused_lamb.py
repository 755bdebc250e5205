"""Fused LAMB optimizer (port of ``deepspeed_tpu/ops/lamb/fused_lamb.py``).

The JAX LAMB is ``jnp``, not a Pallas kernel, so the port's is plain
PyTorch: ``torch._foreach_*`` over the leaves for the moments and the
update (the same arithmetic, leaf by leaf), then the per-tensor trust
ratio with the reference kernel's clamp (``max_coeff`` / ``min_coeff``).

:func:`lamb_update` is the functional update (new tensors, the JAX
signature). :func:`lamb_step_` is the engine's, in place on its fp32
masters and moments: under ZeRO a rank holds only pieces of each leaf,
so the per-leaf squared norms of the params and of the update are summed
over the data group by one all-reduce of an ``[n_leaves, 2]`` vector
(GSPMD sums them implicitly in JAX); an fp16 overflow leaves every
tensor, and the step count, as it was (JAX ``select(overflow, old,
new)``).
"""

from typing import Any, NamedTuple

import torch

from deepspeed_tpu_torch.ops.fused_adam import bias_corrections


class LambState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def init_lamb_state(params):
    params = list(params)
    device = params[0].device if params else None
    return LambState(
        m=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params],
        v=[torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params],
        step=torch.zeros((), dtype=torch.int32, device=device))


def _moments_and_update(p32, g32, m, v, beta1, beta2, eps, weight_decay,
                        bc1, bc2):
    """The new moments and the un-ratioed update of every leaf."""
    m_new = torch._foreach_mul(m, beta1)
    torch._foreach_add_(m_new, torch._foreach_mul(g32, 1.0 - beta1))
    v_new = torch._foreach_mul(v, beta2)
    torch._foreach_add_(v_new, torch._foreach_mul(
        torch._foreach_mul(g32, g32), 1.0 - beta2))
    denom = torch._foreach_sqrt(torch._foreach_div(v_new, bc2))
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(torch._foreach_div(m_new, bc1), denom)
    if weight_decay != 0.0:
        torch._foreach_add_(update, torch._foreach_mul(p32, weight_decay))
    return m_new, v_new, update


def _ratios(p_norm, u_norm, eps, max_coeff, min_coeff):
    one = torch.ones_like(p_norm)
    ratio = torch.where(u_norm > 0, p_norm / (u_norm + eps), one)
    ratio = torch.clamp(ratio, min_coeff, max_coeff)
    return torch.where(p_norm > 0, ratio, one)


def _sq_norms(xs):
    return torch.stack([(x * x).sum() for x in xs])


@torch.no_grad()
def lamb_update(params, grads, state, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, bias_correction=True, max_coeff=10.0,
                min_coeff=0.01):
    """One LAMB step (JAX ``lamb_update``): Adam-style moments, a
    per-tensor trust ratio. Returns ``(new_params, new_state)``."""
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
    p32 = [p.to(torch.float32) for p in params]
    g32 = [g.to(torch.float32) for g in grads]
    m_new, v_new, update = _moments_and_update(
        p32, g32, list(state.m), list(state.v), beta1, beta2, eps,
        weight_decay, bc1, bc2)
    ratio = _ratios(_sq_norms(p32).sqrt(), _sq_norms(update).sqrt(), eps,
                    max_coeff, min_coeff)
    new_p = [(p - (lr * r) * u).to(orig.dtype)
             for p, r, u, orig in zip(p32, ratio.unbind(0), update, params)]
    return new_p, LambState(m=list(m_new), v=list(v_new), step=step)


@torch.no_grad()
def lamb_step_(masters, grads, state, lr, beta1=0.9, beta2=0.999, eps=1e-8,
               weight_decay=0.0, bias_correction=True, max_coeff=10.0,
               min_coeff=0.01, skip=None, reduce=None, counted=None):
    """The engine's LAMB step, in place on the fp32 ``masters`` and
    ``state.m`` / ``state.v`` (each rank's pieces under ZeRO). ``reduce``
    sums a tensor over the data group (in place); ``counted[i]`` False
    leaves leaf ``i``'s squares out of the sum on this rank (a
    replicated leaf counts on rank 0 only). ``skip`` (a bool device
    tensor) makes the step a no-op. Returns the new state."""
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
    m_new, v_new, update = _moments_and_update(
        masters, grads, state.m, state.v, beta1, beta2, eps, weight_decay,
        bc1, bc2)
    sq = torch.stack([_sq_norms(masters), _sq_norms(update)], 1)
    if reduce is not None:
        if counted is not None:
            sq = sq * torch.tensor(counted, dtype=sq.dtype,
                                   device=sq.device)[:, None]
        reduce(sq)
    ratio = _ratios(sq[:, 0].sqrt(), sq[:, 1].sqrt(), eps, max_coeff,
                    min_coeff)
    new_p = [p - (lr * r) * u
             for p, r, u in zip(masters, ratio.unbind(0), update)]
    if skip is not None:
        new_p, m_new, v_new = (
            [torch.where(skip, o, n) for n, o in zip(new, old)]
            for new, old in ((new_p, masters), (m_new, state.m),
                             (v_new, state.v)))
        step = torch.where(skip, state.step, step)
    for dst, src in ((masters, new_p), (state.m, m_new), (state.v, v_new)):
        torch._foreach_copy_(dst, src)
    return state._replace(step=step)


class FusedLamb:
    """The reference constructor surface around :func:`lamb_update`
    (``init`` / ``update``, the protocol a client optimizer object
    follows); the engine runs a ``FusedLamb`` it is given through
    :func:`lamb_step_` with these hyperparameters."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 max_grad_norm=0.0, max_coeff=10.0, min_coeff=0.01,
                 amsgrad=False):
        if amsgrad:
            raise RuntimeError(
                "FusedLamb does not support the AMSGrad variant.")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.params = None if params is None else list(params)
        self.state = init_lamb_state(self.params) \
            if params is not None else None

    def init(self, params):
        return init_lamb_state(params)

    def update(self, params, grads, state, lr=None, beta1=None):
        return lamb_update(
            params, grads, state,
            lr=self.lr if lr is None else lr,
            beta1=self.betas[0] if beta1 is None else beta1,
            beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay,
            bias_correction=self.bias_correction,
            max_coeff=self.max_coeff, min_coeff=self.min_coeff)

    def step(self, grads):
        if self.params is None:
            raise ValueError("construct with params to use .step()")
        self.params, self.state = self.update(self.params, grads,
                                              self.state)
        return self.params
