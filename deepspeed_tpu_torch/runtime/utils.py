"""Overflow check, global norm and clipping over a list of gradient
tensors (port of ``deepspeed_tpu/runtime/utils.py:27-90``). Each returns
a 0-d device tensor and never syncs with the host. Over ZeRO pieces the
norm is the global one: :func:`global_norm` takes the ranks' sum of
squares (``all_reduce``), counting each replicated leaf on one rank."""

import torch


def has_inf_or_nan(x):
    return ~torch.isfinite(x.float()).all()


def check_overflow(grads):
    """True (a bool tensor) iff any gradient holds an inf or a nan."""
    grads = list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([has_inf_or_nan(g) for g in grads]).any()


def global_norm(tensors, all_reduce=None, counted=None):
    """Global L2 norm (f32) over a list of tensors. With ``all_reduce``
    (an in-place sum over the ranks of a 1-element tensor) the tensors
    are this rank's pieces and the squares are summed over the ranks
    first; ``counted[i]`` false leaves tensor i out on this rank (a
    replicated leaf, counted on rank 0 only)."""
    tensors = list(tensors)
    device = tensors[0].device if tensors else None
    if counted is not None:
        tensors = [t for t, c in zip(tensors, counted) if c]
    if tensors:
        sq = torch.stack([torch.sum(torch.square(t.float()))
                          for t in tensors]).sum()
    else:
        sq = torch.zeros((), dtype=torch.float32, device=device)
    if all_reduce is not None:
        sq = all_reduce(sq.reshape(1)).reshape(())
    return torch.sqrt(sq)


def clip_by_global_norm(tensors, max_norm, norm=None, eps=1e-6):
    """The tensors scaled so their global norm is at most ``max_norm``
    (scale ``min(1, max_norm / (norm + eps))``, the reference's clip)."""
    tensors = list(tensors)
    if norm is None:
        norm = global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + eps), max=1.0)
    return [(t * scale).to(t.dtype) for t in tensors]
