"""Overflow check, global norm and clipping over a list of gradient
tensors (port of ``deepspeed_tpu/runtime/utils.py:27-90``, one device,
so no cross-shard ``axis_names``). Each returns a 0-d device tensor and
never syncs with the host."""

import torch


def has_inf_or_nan(x):
    return ~torch.isfinite(x.float()).all()


def check_overflow(grads):
    """True (a bool tensor) iff any gradient holds an inf or a nan."""
    grads = list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([has_inf_or_nan(g) for g in grads]).any()


def global_norm(tensors):
    """Global L2 norm (f32) over a list of tensors."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    sq = torch.stack([torch.sum(torch.square(t.float())) for t in tensors])
    return torch.sqrt(sq.sum())


def clip_by_global_norm(tensors, max_norm, norm=None, eps=1e-6):
    """The tensors scaled so their global norm is at most ``max_norm``
    (scale ``min(1, max_norm / (norm + eps))``, the reference's clip)."""
    tensors = list(tensors)
    if norm is None:
        norm = global_norm(tensors)
    scale = torch.clamp(max_norm / (norm + eps), max=1.0)
    return [(t * scale).to(t.dtype) for t in tensors]
