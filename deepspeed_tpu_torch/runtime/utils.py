"""Overflow check, global norm and clipping over a list of gradient
tensors (port of ``deepspeed_tpu/runtime/utils.py:27-90``). Each returns
a 0-d device tensor and never syncs with the host. Over ZeRO pieces the
norm is the global one: :func:`global_norm` takes the ranks' sum of
squares (``all_reduce``), counting each replicated leaf on one rank.
The pipeline's stage partitioning math (:func:`partition_uniform`,
:func:`partition_balanced`) is copied from the JAX module too."""

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


# ---------------------------------------------------------------------------
# Partitioning math (a copy of ``deepspeed_tpu/runtime/utils.py:103-177``,
# the reference's ``partition_uniform`` :295 and ``partition_balanced``
# :361): pipeline stage assignment, plain Python at setup time.
# ---------------------------------------------------------------------------

def prefix_sum_inc(weights):
    """Inclusive prefix sum of a list."""
    out = []
    total = 0
    for w in weights:
        total += w
        out.append(total)
    return out


def partition_uniform(num_items, num_parts):
    """Even split boundaries: len == num_parts+1, remainder spread across
    the leading parts."""
    parts = [(p * num_items) // num_parts for p in range(num_parts)]
    parts.append(num_items)
    return parts


def _feasible(weights, num_parts, bottleneck):
    """Greedy check: can ``weights`` split into <= num_parts contiguous
    chunks each with sum <= bottleneck?"""
    parts_used = 1
    current = 0
    for w in weights:
        if w > bottleneck:
            return False
        if current + w > bottleneck:
            parts_used += 1
            current = w
            if parts_used > num_parts:
                return False
        else:
            current += w
    return True


def partition_balanced(weights, num_parts, eps=1e-3):
    """Boundaries minimizing the max part weight (contiguous partition):
    binary search the bottleneck, then lay out chunks greedily while
    keeping every trailing part non-empty."""
    num_items = len(weights)
    if num_items <= num_parts:
        # Degenerate: one item (or empty) per part.
        parts = list(range(num_items + 1))
        parts += [num_items] * (num_parts - num_items)
        return parts

    lo = max(weights) if weights else 0
    hi = sum(weights)
    while lo < hi:
        mid = (lo + hi) // 2 if isinstance(lo, int) and isinstance(hi, int) \
            else (lo + hi) / 2
        if _feasible(weights, num_parts, mid):
            hi = mid
        else:
            lo = mid + 1 if isinstance(mid, int) else mid + eps
    bottleneck = hi

    # Greedy layout, reserving enough items for the remaining parts.
    parts = [0]
    idx = 0
    for p in range(num_parts):
        remaining_parts = num_parts - p - 1
        current = 0
        while idx < num_items - remaining_parts:
            if current + weights[idx] > bottleneck and current > 0:
                break
            current += weights[idx]
            idx += 1
        parts.append(idx)
    parts[-1] = num_items
    return parts
