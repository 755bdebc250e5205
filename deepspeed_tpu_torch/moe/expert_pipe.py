"""Expert parallelism inside the pipeline: pipe x expert (port of
``deepspeed_tpu/moe/expert_pipe.py``).

:class:`ExpertParallelFFNLayer` is a pipeline body layer: a pre-LN MoE
FFN block whose ``expert_*`` leaves are split over the ``expert`` group
it was built in (the pipeline engine builds its stages inside
``parallel/pipe_tp.py:axis_scope``): each rank holds ``E / ep`` experts
(``Shard(0, axis="expert")``; the pipe layout holds whole leaves). The
tokens stay replicated across the expert axis; each rank runs its
experts on its slice of the (replicated) dispatch and one
``psum_combine`` sums the outputs, the all-to-all-free form JAX writes
for pipeline micro-batches. ``psum_grad`` on the normed input and on
``gate`` sums the local experts' partial cotangents. Under the
``expert_combine`` overlap site the combine is
``matmul_psum_overlap``'s chunked ring, and the ``psum_grad``\\ s run as
chunked rings too.

Activations may be a plain ``[B, S, M]`` tensor or a ``(hidden, aux)``
tuple: the Switch loss then accumulates into ``aux`` (times
``MoEConfig.aux_loss_weight``) and rides the pipeline to the loss. The
aux is computed from the whole routing on every rank, so its
differentiable path is pre-scaled by 1/ep with the remainder detached
(``moe/layer.py:prescale_aux``). The capacity is the eval one when the
micro-batch has no dropout seed (the engine's eval stream; every
training forward has one), as JAX's ``rng is None``.
"""

import torch

from deepspeed_tpu_torch.moe.layer import (
    ExpertBanks,
    MoEConfig,
    expert_parallel_ffn,
)
from deepspeed_tpu_torch.parallel.collectives import overlap_plan
from deepspeed_tpu_torch.parallel.pipe_tp import current_axis, layer_norm


class ExpertParallelFFNLayer(ExpertBanks):
    """Pipeline body layer: pre-LN MoE FFN, manual expert parallelism
    (module docstring). Leaves: ``ln_scale`` / ``ln_bias`` ``[M]``, then
    those of :class:`~deepspeed_tpu_torch.moe.layer.ExpertBanks`. Its
    LayerNorm is eps 1e-5 with ``mean((x - mean)^2)``
    (``pipe_tp.layer_norm``), not flax's."""

    pipe_context = True

    def __init__(self, d_model, hidden_dim, moe: MoEConfig = None,
                 axis_name="expert"):
        super().__init__()
        self.moe = moe or MoEConfig()
        self.ln_scale = torch.nn.Parameter(torch.ones(d_model))
        self.ln_bias = torch.nn.Parameter(torch.zeros(d_model))
        self._register_banks(self.moe, d_model, hidden_dim,
                             current_axis(axis_name))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The banks (:meth:`ExpertBanks._reset_banks`), unit LayerNorm
        scale and zero bias."""
        self._reset_banks(generator)
        self.ln_scale.fill_(1.0)
        self.ln_bias.zero_()

    def forward(self, x, ctx=None):
        aux_in = None
        if isinstance(x, tuple):
            x, aux_in = x
        h = layer_norm(x, self.ln_scale, self.ln_bias).to(x.dtype)
        plan = overlap_plan("expert_combine") if self.group is not None \
            else None
        if plan is not None and plan.chunks <= 1:
            plan = None
        y, aux, _ = expert_parallel_ffn(
            h, self.gate, self.banks(), self.moe, self.group,
            ctx is None or ctx.seed is None, x.dtype, plan=plan)
        out = x + y.to(x.dtype)
        if aux_in is None:
            return out
        return out, aux_in + aux
