"""Token sampling for the decode step (port of
``deepspeed_tpu/inference/sampling.py``).

Temperature -> top-k -> top-p over fp32 logits, on the logits' device,
drawing from an explicit ``torch.Generator`` (the engine seeds it from
``sampling_seed``). ``temperature == 0.0`` is greedy argmax and draws
no randomness, so a greedy serve is reproducible regardless of seed.
A torch generator and a JAX key give different draws from the same
seed: only greedy streams are comparable across the two packages.
"""

import torch

# Additive knockout for filtered logits: exp() underflows to exactly
# 0.0 in fp32, so a filtered token's probability is exactly zero.
_FILTERED = -1e30


def _apply_top_k(logits, top_k):
    """Keep the ``top_k`` largest logits per row; knock out the rest.
    0 (or >= vocab) disables the filter."""
    vocab = logits.shape[-1]
    if not top_k or top_k >= vocab:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, _FILTERED)


def _apply_top_p(logits, top_p):
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability reaches ``top_p`` (1.0 disables). The top token always
    survives (its exclusive cumulative mass is 0 < top_p)."""
    if top_p >= 1.0:
        return logits
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    keep = cum < top_p
    cutoff = torch.where(keep, sorted_desc, float("inf")).amin(
        dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits, _FILTERED)


def filtered_logits(logits, temperature, top_k=0, top_p=1.0):
    """The temperature -> top-k -> top-p pipeline as fp32 logits (the
    distribution :func:`sample_logits` samples from)."""
    if temperature <= 0.0:
        raise ValueError(
            f"filtered_logits needs temperature > 0, got {temperature}")
    scaled = logits.float() / float(temperature)
    scaled = _apply_top_k(scaled, int(top_k))
    return _apply_top_p(scaled, float(top_p))


def sample_logits(logits, generator, temperature=0.0, top_k=0, top_p=1.0):
    """Sample next tokens (int32 ``[...]``) from ``[..., vocab]`` logits,
    drawing from ``generator`` (a ``torch.Generator`` on the logits'
    device) unless greedy."""
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = filtered_logits(logits, temperature, top_k, top_p)
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tokens = torch.multinomial(flat, 1, generator=generator)
    return tokens.reshape(probs.shape[:-1]).to(torch.int32)
