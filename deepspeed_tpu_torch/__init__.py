"""PyTorch + CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The JAX package (``deepspeed_tpu``) stays the reference: module paths
here mirror it, so each counterpart is found by name, and the parity
tests (``tests/test_torch_*.py``) hold every ported module to the JAX
function it replaces. This package imports ``torch`` and never ``jax``,
``flax`` or ``deepspeed_tpu``; where it needs a JAX-free helper from
the reference it keeps its own copy.

Ported so far: GPT-2 serving on the ring KV cache
(:mod:`deepspeed_tpu_torch.inference`), with flash decode as a
hand-written ``sm_90a`` CUDA kernel (:mod:`deepspeed_tpu_torch.ops`).

Nothing heavy is imported here: submodules load on first use.
"""

version = "0.3.0"
__version__ = version


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the GPU. Asking for CUDA (explicitly or by default)
    on a machine without one raises instead of falling back to the
    CPU: a run that silently lands on the host would report host
    numbers under the GPU's name. The CPU is used only when the caller
    asks for it (``device="cpu"``), as the CPU tests do.
    """
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the host explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"deepspeed_tpu_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev
