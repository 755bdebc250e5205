"""1-bit Adam: error-feedback momentum compression for data parallelism
(port of ``deepspeed_tpu/runtime/fp16/onebit_adam.py``, the reference's
``OnebitAdam``, ``runtime/fp16/onebit_adam.py:18``).

A ``freeze_step`` warmup of Adam *without* bias correction on the dense
mean of the ranks' local gradients; then the compression stage: the
second moment ``v`` frozen, each rank folds its local gradient into its
momentum and the momenta are averaged by the 1-bit error-feedback
all-reduce (``runtime/comm/compressed.py``). The update is
``m / (sqrt(v) + eps) + wd * p`` on the fp32 masters. The arithmetic is
plain PyTorch on the tensors' device, in the JAX function's order and
fp32 coefficients (``1 - beta1`` in fp32, as the JAX engine passes
``beta1`` as an fp32 array).

State is explicit tensors (:class:`OnebitAdamState`): the moments by
leaf, the applied-step counter (0-d int32), this rank's worker error
``[padded_n]`` and the error of the chunk it serves ``[chunk]`` (JAX
keeps the ``[world, padded_n]`` and ``[padded_n]`` arrays sharded over
the data axis; rank r's rows are these).

The pipeline composition (``runtime/pipe/engine.py``) runs one update a
stage engine, over separately compressed buffers
(:func:`pipeline_onebit_groups`): the whole-buffer scale of the 1-bit
compression couples every leaf in a buffer, so copies that must stay
equal (a tied leaf on its stages, a model-replicated leaf on its model
ranks) must be compressed in buffers of the same content on every
holder (JAX ``onebit_adam.py:105-114``).
"""

from typing import Any, List, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.parallel import collectives as C
from deepspeed_tpu_torch.runtime.comm.compressed import (
    compressed_allreduce,
    error_feedback_sizes,
)

__all__ = ["OnebitAdamState", "OnebitAdam", "init_onebit_state",
           "onebit_adam_update", "body_reference_order",
           "pipeline_onebit_groups", "pipeline_onebit_splits",
           "init_pipeline_onebit_state"]


class OnebitAdamState(NamedTuple):
    m: List[torch.Tensor]           # momentum by leaf, fp32
    v: List[torch.Tensor]           # second moment by leaf (frozen later)
    step: torch.Tensor              # i32: applied steps
    worker_error: torch.Tensor      # [padded_n] this rank's residual
    server_error: torch.Tensor      # [chunk] residual of the served chunk


def param_count(params):
    return sum(int(p.numel()) for p in params)


def init_onebit_state(params, world, device=None):
    """Zero state for ``params`` (a list of tensors) over ``world`` data
    ranks."""
    device = device if device is not None else (
        params[0].device if params else None)
    padded, chunk = error_feedback_sizes(param_count(params), world)
    return OnebitAdamState(
        m=[torch.zeros(p.shape, dtype=torch.float32, device=device)
           for p in params],
        v=[torch.zeros(p.shape, dtype=torch.float32, device=device)
           for p in params],
        step=torch.zeros((), dtype=torch.int32, device=device),
        worker_error=torch.zeros(padded, dtype=torch.float32, device=device),
        server_error=torch.zeros(chunk, dtype=torch.float32, device=device))


def _flat(tensors):
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]) \
        if tensors else torch.zeros(0, dtype=torch.float32)


def _unflat(flat, like, dtype=None):
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(
            dtype if dtype is not None else t.dtype))
        off += n
    return out


def _f32(x):
    return float(np.float32(x))


def onebit_adam_update(params, local_grads, state, lr, beta1=0.9,
                       beta2=0.999, eps=1e-8, weight_decay=0.0,
                       freeze_step=100, group=None):
    """One 1-bit Adam step over ``group`` (the data group's
    :class:`~deepspeed_tpu_torch.parallel.mesh.AxisGroup`; None or a
    group of one: this rank alone). ``local_grads`` are this rank's
    *unaveraged* gradients. Step ``state.step + 1 <= freeze_step`` (read
    on the host) averages them densely (one all-reduce) and updates both
    moments; a later step folds them into the momentum and averages that
    with :func:`~deepspeed_tpu_torch.runtime.comm.compressed.
    compressed_allreduce`, ``v`` frozen. Returns ``(new_params,
    new_state)``: new tensors, the inputs unchanged."""
    world = group.size if group is not None and group.active else 1
    step = state.step + 1
    warmup = int(state.step) + 1 <= freeze_step
    g = _flat(local_grads)
    m = _flat(state.m)
    v = _flat(state.v)
    n = g.shape[0]
    b1 = np.float32(beta1)
    c_b1, c_1mb1 = float(b1), float(np.float32(1.0) - b1)
    c_b2, c_1mb2 = _f32(beta2), _f32(1.0 - beta2)
    we, se = state.worker_error, state.server_error
    if warmup:
        g_avg = g
        if world > 1:
            g_avg = C.all_reduce(g.clone(), group) / world
        m_new = c_b1 * m + c_1mb1 * g_avg
        v_new = c_b2 * v + c_1mb2 * torch.square(g_avg)
    else:
        m_local = c_b1 * m + c_1mb1 * g
        m_pad = torch.zeros(we.shape[-1], dtype=torch.float32,
                            device=g.device)
        m_pad[:n] = m_local
        m_avg, we, se = compressed_allreduce(m_pad, we, se, group,
                                             n_valid=n)
        m_new, v_new = m_avg[:n], v
    p32 = _flat(params)
    update = m_new / (torch.sqrt(v_new) + _f32(eps))
    if weight_decay != 0.0:
        update = update + _f32(weight_decay) * p32
    new_p = p32 - _f32(lr) * update
    return _unflat(new_p, params), OnebitAdamState(
        m=_unflat(m_new, state.m, torch.float32),
        v=_unflat(v_new, state.v, torch.float32),
        step=step, worker_error=we, server_error=se)


class OnebitAdam:
    """The reference's constructor (``runtime/fp16/onebit_adam.py:18-60``)
    with the functional ``init`` / ``update`` the engine calls."""

    def __init__(self, params=None, deepspeed=None, lr=1e-3,
                 freeze_step=100000, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, amsgrad=False,
                 cuda_aware=False):
        if amsgrad:
            raise RuntimeError("1-bit Adam does not support the AMSGrad "
                               "variant.")
        self.lr = lr
        self.freeze_step = freeze_step
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params, world=1):
        return init_onebit_state(params, world)

    def update(self, params, grads, state, lr=None, beta1=None, group=None):
        return onebit_adam_update(
            params, grads, state, lr=self.lr if lr is None else lr,
            beta1=self.betas[0] if beta1 is None else beta1,
            beta2=self.betas[1], eps=self.eps,
            weight_decay=self.weight_decay, freeze_step=self.freeze_step,
            group=group)


# ---------------------------------------------------------------------------
# the pipeline composition
# ---------------------------------------------------------------------------

def body_reference_order(names, reference=None):
    """The stage's body leaves (``body.<layer>.<leaf>``) in JAX's flat
    order, as ``(indices, transposed indices)``: JAX ravels a stage's
    body as its stacked leaves, leaf after leaf in the layer's flat
    order, each ``[L/S, ...]`` layer after layer. ``reference`` is that
    order for one layer, ``(leaf name, transposed)`` pairs (a transposed
    leaf is ``[out, in]`` here and ``[in, out]`` in JAX); without it, the
    layer's own parameter order."""
    at = {}
    for i, n in enumerate(names):
        if n.startswith("body."):
            _, layer, leaf = n.split(".", 2)
            at[(int(layer), leaf)] = i
    layers = sorted({layer for layer, _ in at})
    if reference is None:
        reference = [(leaf, False) for layer, leaf in at
                     if layer == layers[0]]
    order = [at[(layer, leaf)] for leaf, _ in reference for layer in layers]
    transposed = {at[(layer, leaf)] for leaf, t in reference if t
                  for layer in layers}
    return order, transposed


def pipeline_onebit_groups(names, model_sharded, model=1, reference=None):
    """The separately compressed buffers of one pipeline stage, in order,
    as ``[(kind, [leaf indices])]`` over the stage engine's params
    (``names`` their stage param names, ``model_sharded[i]`` whether
    leaf i is split over the model axis); empty buffers are left out:

    - the body (``body.*``), in JAX's flat order
      (:func:`body_reference_order` of ``reference``): one buffer, or at
      ``model > 1`` the model-sharded leaves (``body_mp``) apart from the
      model-replicated ones (``body_rep``), so the replicated copies see
      the same scale on every model rank;
    - ``rest``: the stage's own prologue or epilogue leaves;
    - ``tied``: the tied leaves, which the first and the last stage both
      hold (equal gradients after the tied sum): their buffer has the
      same content on every holder.

    JAX compresses prologue, epilogue and tied leaves in one buffer,
    which every one of its stage devices holds whole; a port stage holds
    only its own prologue or epilogue, so the tied leaves get a buffer of
    their own."""
    body = body_reference_order(names, reference)[0]
    groups = []
    if model > 1:
        groups.append(("body_mp", [i for i in body if model_sharded[i]]))
        groups.append(("body_rep", [i for i in body
                                    if not model_sharded[i]]))
    else:
        groups.append(("body", body))
    groups.append(("rest", [i for i, n in enumerate(names)
                            if not n.startswith(("body.", "tied."))]))
    groups.append(("tied", [i for i, n in enumerate(names)
                            if n.startswith("tied.")]))
    return [(kind, idx) for kind, idx in groups if idx]


def pipeline_onebit_splits(sizes, world):
    """``[(padded_n, chunk)]`` of each buffer of :func:`pipeline_onebit_
    groups` (``sizes`` their element counts): the error buffers of a
    stage concatenate them in that order."""
    return [error_feedback_sizes(n, world) for n in sizes]


def init_pipeline_onebit_state(params, groups, world, device=None):
    """Zero state of one pipeline stage: the moments by leaf and the
    error buffers of every group of ``groups`` (:func:`pipeline_onebit_
    groups`) concatenated (worker ``[sum padded]``, server ``[sum
    chunk]``)."""
    device = device if device is not None else params[0].device
    splits = pipeline_onebit_splits(
        [sum(int(params[i].numel()) for i in idx) for _, idx in groups],
        world)
    return OnebitAdamState(
        m=[torch.zeros(p.shape, dtype=torch.float32, device=device)
           for p in params],
        v=[torch.zeros(p.shape, dtype=torch.float32, device=device)
           for p in params],
        step=torch.zeros((), dtype=torch.int32, device=device),
        worker_error=torch.zeros(sum(p for p, _ in splits),
                                 dtype=torch.float32, device=device),
        server_error=torch.zeros(sum(c for _, c in splits),
                                 dtype=torch.float32, device=device))


def _select(flag, old, new):
    return torch.where(flag, old, new)


def pipeline_onebit_update(params, grads, state, groups, lr, beta1, beta2,
                           eps, weight_decay, freeze_step, group,
                           overflow, transposed=()):
    """One stage's 1-bit step: :func:`onebit_adam_update` on each buffer
    of ``groups`` with its slices of the error buffers, every buffer at
    the same step, the leaves of ``transposed`` (indices) flattened
    transposed (:func:`body_reference_order`); an ``overflow`` (0-d bool)
    keeps the old masters and state. Returns ``(new_params by leaf,
    new_state)``."""
    def t(i, x):
        return x.mT if i in transposed else x

    world = group.size if group is not None and group.active else 1
    splits = pipeline_onebit_splits(
        [sum(int(params[i].numel()) for i in idx) for _, idx in groups],
        world)
    new_p = list(params)
    new_m, new_v = list(state.m), list(state.v)
    wes, ses = [], []
    w_off = c_off = 0
    step = state.step
    for (_, idx), (padded, chunk) in zip(groups, splits):
        sub = OnebitAdamState(
            m=[t(i, state.m[i]) for i in idx],
            v=[t(i, state.v[i]) for i in idx], step=state.step,
            worker_error=state.worker_error[w_off:w_off + padded],
            server_error=state.server_error[c_off:c_off + chunk])
        w_off, c_off = w_off + padded, c_off + chunk
        ps, st = onebit_adam_update(
            [t(i, params[i]) for i in idx], [t(i, grads[i]) for i in idx],
            sub, lr=lr,
            beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
            freeze_step=freeze_step, group=group)
        for j, i in enumerate(idx):
            new_p[i] = _select(overflow, params[i], t(i, ps[j]))
            new_m[i] = _select(overflow, state.m[i], t(i, st.m[j]))
            new_v[i] = _select(overflow, state.v[i], t(i, st.v[j]))
        wes.append(st.worker_error)
        ses.append(st.server_error)
        step = st.step
    return new_p, OnebitAdamState(
        m=new_m, v=new_v, step=_select(overflow, state.step, step),
        worker_error=_select(overflow, state.worker_error, torch.cat(wes)),
        server_error=_select(overflow, state.server_error, torch.cat(ses)))
