"""Mixture-of-Experts with expert parallelism over the ``expert`` mesh
axis (port of ``deepspeed_tpu/moe/layer.py``).

- :func:`top_k_gating`: GShard/Switch static-shape routing as one-hot
  dispatch and combine tensors, bit for bit JAX's: ``argmax`` takes the
  first maximum, top-2 renormalizes over the selected experts BEFORE the
  capacity drop (JAX's deliberate divergence from DeepSpeed's
  ``top2gating``), a token's queue position is a cumsum along the
  sequence, and the Switch load-balancing loss is computed on the
  pre-capacity top-1 assignment.
- :func:`compute_capacity`: ``C = max(min_capacity, ceil(k * S * cf /
  E))``, capped at S; ``cf`` is ``eval_capacity_factor`` when
  ``deterministic`` (JAX: no rng, the engine's eval), else
  ``capacity_factor``.
- :class:`MoE`: the expert FFN block. JAX shards the banked weights
  ``[E, ...]`` over ``expert`` and lets GSPMD insert the all-to-alls.
  Here the module holds the ``E / ep`` experts of its expert
  :class:`~deepspeed_tpu_torch.parallel.mesh.AxisGroup` (``group``):
  the tokens are replicated over ``expert`` (rows shard over ``data``
  only), every rank routes all of them, runs its experts on its slice of
  the dispatch, and the outputs are summed with ``psum_combine``;
  ``psum_grad`` on the input and on ``gate`` sums the local experts'
  partial cotangents. The aux loss is computed from the whole routing
  on every rank, so its differentiable path is pre-scaled by 1/ep (the
  remainder detached) and ``psum_grad``'s sum lands at exactly 1x. With
  a ``data_group`` the aux loss's two means (the top-1 load fractions
  and the mean router probabilities) are taken over the global batch,
  as JAX's engine computes the loss over the global batch. This is the
  function JAX's GSPMD computes, written as JAX's ``moe/expert_pipe.py``
  writes it; :func:`expert_parallel_ffn` is that function, and
  :class:`ExpertBanks` its leaves, for both :class:`MoE` and the
  pipeline's ``moe/expert_pipe.py:ExpertParallelFFNLayer``.

The dispatch, expert FFN and combine are einsums outside any kernel, as
in JAX (no Pallas kernel runs here). ``expert_*`` leaves carry
``Shard(0, axis="expert")`` (:func:`moe_param_spec`), so the engine
reduces their gradients over ``data`` only and saves them whole.
"""

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.parallel.collectives import (
    matmul_psum_overlap,
    psum_combine,
    psum_grad,
)
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    set_shard,
    shard_tensor,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2                   # 1 = Switch, 2 = GShard
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    aux_loss_weight: float = 0.01
    dtype: Any = torch.float32


def compute_capacity(seq_len, cfg: MoEConfig, deterministic):
    cf = cfg.eval_capacity_factor if deterministic else cfg.capacity_factor
    cap = max(cfg.min_capacity,
              int(math.ceil(cfg.top_k * seq_len * cf / cfg.num_experts)))
    return min(cap, seq_len)


def _gating(logits, top_k, capacity, data=None):
    """:func:`top_k_gating` and the pre-capacity ``[B, S, E]`` choices;
    ``data`` (a data :class:`AxisGroup`) takes the aux loss's two means
    over the global batch (:func:`_global_mean`)."""
    B, S, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    dispatch = torch.zeros_like(probs)
    gates = torch.zeros_like(probs)
    masked = probs
    for _ in range(top_k):
        onehot = F.one_hot(torch.argmax(masked, dim=-1), E).float()
        dispatch = dispatch + onehot
        gates = gates + probs * onehot
        masked = masked * (1.0 - onehot)
    if top_k > 1:
        # renormalized over the selected experts before the capacity drop
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    position = (torch.cumsum(dispatch, dim=1) - 1.0) * dispatch
    within = (position < capacity).float() * dispatch
    gates = gates * within
    pos = F.one_hot(position.long().clamp(0, capacity - 1),
                    capacity).float() * within[..., None]
    top1 = F.one_hot(torch.argmax(probs, dim=-1), E).float()
    aux = E * torch.sum(_global_mean(top1.mean(dim=(0, 1)), data) *
                        _global_mean(probs.mean(dim=(0, 1)), data))
    return pos, gates[..., None] * pos, aux, dispatch


def _global_mean(x, data):
    """The mean of ``x`` over the data group's ranks (each a mean over
    its rows): the global batch's mean, as JAX's GSPMD engine computes
    the loss over the global batch. Forward and backward are sums
    (JAX's ``psum`` and its transpose): every rank's loss holds the whole
    aux and the engine averages the ranks' gradients, so each rank's
    rows take the global cotangent once."""
    if data is None or not data.active:
        return x
    return psum_grad(psum_combine(x, data), data) / data.size


def top_k_gating(logits, top_k, capacity):
    """Static-shape top-k routing (JAX ``top_k_gating``): ``logits`` ``[B,
    S, E]`` -> ``(dispatch [B, S, E, C]`` one-hot, ``combine [B, S, E,
    C]`` gate-weighted, the aux loss). Tokens past an expert's capacity
    are dropped (combine weight zero)."""
    return _gating(logits, top_k, capacity)[:3]


def moe_param_spec(name, leaf):
    """The :class:`~deepspeed_tpu_torch.parallel.tensor_parallel.Shard`
    of an MoE leaf by name (JAX ``moe_param_spec``): ``expert_*`` leaves
    split their bank dim over ``expert``, the rest replicated (None).
    JAX's optional second split of the FFN hidden dim over ``model`` is
    not taken: the port's MoE is replicated over ``model``."""
    if name.split(".")[-1].startswith("expert_") and \
            getattr(leaf, "ndim", 0) >= 1:
        return Shard(0, axis="expert")
    return None


def expert_ffn(h, disp, w1, b1, w2, b2, dtype):
    """The local experts on their slice of the dispatch ``[B, S, e, C]``:
    the dispatched tokens through each expert's tanh-GELU FFN, ``[B, e,
    C, M]``."""
    de = torch.einsum("bsec,bsm->becm", disp.to(dtype), h.to(dtype))
    hh = F.gelu(torch.einsum("becm,emh->bech", de, w1.to(dtype)) +
                b1.to(dtype)[None, :, None], approximate="tanh")
    eo = torch.einsum("bech,ehm->becm", hh, w2.to(dtype)) + \
        b2.to(dtype)[None, :, None]
    return eo


def prescale_aux(aux, group):
    """The aux loss with its differentiable path pre-scaled by 1/ep and
    the rest detached (JAX ``expert_pipe.py:158-167``): every rank's
    backward carries the whole aux gradient into ``psum_grad``'d
    tensors, whose sum then lands at 1x."""
    if group is None or not group.active:
        return aux
    n = group.size
    return aux / n + (aux * (1.0 - 1.0 / n)).detach()


def expert_parallel_ffn(h, gate, banks, cfg: MoEConfig, group,
                        deterministic, dtype, data_group=None, plan=None):
    """The expert-parallel MoE FFN (module docstring) on tokens ``h``
    ``[B, S, M]``, replicated over the expert ``group`` (None: one rank):
    ``gate`` ``[M, E]``, ``banks`` this rank's ``(w1, b1, w2, b2)``, the
    experts computed in ``dtype``. ``data_group`` takes the aux loss's
    means over the global batch; ``plan``, an ``expert_combine`` overlap
    plan of more than one chunk, runs the combine through
    ``matmul_psum_overlap``'s chunked ring and the ``psum_grad`` s as
    chunked rings. Returns ``(y [B, S, M]`` in ``dtype``, the aux times
    ``aux_loss_weight`` pre-scaled by 1/ep (:func:`prescale_aux`), the
    ``(kept, routed)`` token counts per expert ``[E]``)."""
    C = compute_capacity(h.shape[1], cfg, deterministic)
    if group is not None:
        # the local experts' partial cotangents summed over the axis
        kw = {} if plan is None else {
            "chunks": plan.chunks, "bidirectional": plan.bidirectional}
        h = psum_grad(h, group, **kw)
        gate = psum_grad(gate, group, **kw)
    disp, comb, aux, chosen = _gating(h.float() @ gate.float(), cfg.top_k,
                                      C, data_group)
    w1, b1, w2, b2 = banks
    e_loc = w1.shape[0]
    off = 0 if group is None else group.rank * e_loc
    eo = expert_ffn(h, disp[:, :, off:off + e_loc], w1, b1, w2, b2, dtype)
    comb_l = comb[:, :, off:off + e_loc].to(dtype)
    if plan is not None:
        # the combine as one matmul over the flattened (e_loc, C)
        # contraction, fused with the cross-expert sum's rings
        B, S, _, Cc = comb_l.shape
        y = matmul_psum_overlap(
            comb_l.reshape(B, S, e_loc * Cc),
            eo.reshape(B, e_loc * Cc, eo.shape[-1]), group,
            chunks=plan.chunks, bidirectional=plan.bidirectional)
    else:
        y = torch.einsum("bsec,becm->bsm", comb_l, eo)
        if group is not None:
            y = psum_combine(y, group)
    with torch.no_grad():
        routing = (disp.sum(dim=(0, 1, 3)), chosen.sum(dim=(0, 1)))
    return y, cfg.aux_loss_weight * prescale_aux(aux, group), routing


class ExpertBanks(nn.Module):
    """The MoE leaves of an expert group: ``gate`` ``[M, E]``
    (replicated), ``expert_w1`` ``[E/ep, M, H]``, ``expert_b1`` ``[E/ep,
    H]``, ``expert_w2`` ``[E/ep, H, M]``, ``expert_b2`` ``[E/ep, M]``
    (JAX's layouts; ``Shard(0, axis="expert")`` on the banks)."""

    def _register_banks(self, config: MoEConfig, d_model, hidden_dim,
                        group, device=None):
        E = config.num_experts
        self.group = group if group is not None and group.size > 1 \
            else None
        ep = 1 if self.group is None else self.group.size
        if E % ep:
            raise ValueError(f"num_experts {E} does not divide the expert "
                             f"axis ({ep})")
        self.full_shapes = {"expert_w1": (E, d_model, hidden_dim),
                            "expert_b1": (E, hidden_dim),
                            "expert_w2": (E, hidden_dim, d_model),
                            "expert_b2": (E, d_model)}
        self.gate = nn.Parameter(torch.zeros(d_model, E, device=device))
        for name, shape in self.full_shapes.items():
            p = nn.Parameter(torch.zeros((E // ep,) + shape[1:],
                                         device=device))
            if self.group is not None:
                set_shard(p, Shard(0, axis="expert"))
                p.tp_axis = self.group
            self.register_parameter(name, p)

    @torch.no_grad()
    def _reset_banks(self, generator=None):
        """N(0, 0.02) ``gate`` and kernels, the banks drawn whole and cut
        to this rank's experts; zero biases."""
        nn.init.normal_(self.gate, 0.0, 0.02, generator=generator)
        for name in ("expert_w1", "expert_w2"):
            full = torch.empty(self.full_shapes[name],
                               device=self.gate.device)
            nn.init.normal_(full, 0.0, 0.02, generator=generator)
            getattr(self, name).copy_(self._local(full))
        self.expert_b1.zero_()
        self.expert_b2.zero_()

    def _local(self, full):
        """This rank's experts of a whole bank ``[E, ...]``."""
        if self.group is None:
            return full
        return shard_tensor(full, Shard(0, axis="expert"), self.group.rank,
                            self.group.size)

    def banks(self):
        return (self.expert_w1, self.expert_b1, self.expert_w2,
                self.expert_b2)


class MoE(ExpertBanks):
    """Expert-parallel MoE FFN block (module docstring): ``forward(x,
    deterministic)`` with x ``[B, S, M]`` -> ``(y [B, S, M],
    aux_loss_weight * aux)``; the leaves of :class:`ExpertBanks`.
    ``last_routing`` holds the last forward's ``(kept, routed)`` token
    counts per expert (``[E]`` f32 tensors: assignments within capacity,
    and all top-k assignments)."""

    def __init__(self, config: MoEConfig, hidden_dim, d_model, group=None,
                 device=None, data_group=None):
        super().__init__()
        self.config = config
        self.data_group = data_group
        self.hidden_dim, self.d_model = hidden_dim, d_model
        self._register_banks(config, d_model, hidden_dim, group, device)
        self.last_routing = None

    def reset_parameters(self, generator=None):
        self._reset_banks(generator)

    def forward(self, x, deterministic=True):
        y, aux, self.last_routing = expert_parallel_ffn(
            x, self.gate, self.banks(), self.config, self.group,
            deterministic, self.config.dtype, self.data_group)
        return y.to(x.dtype), aux
