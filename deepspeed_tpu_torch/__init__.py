"""PyTorch + CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The JAX package (``deepspeed_tpu``) stays the reference: module paths
here mirror it, so each counterpart is found by name, and the parity
tests (``tests/test_torch_*.py``) hold every ported module to the JAX
function it replaces. This package imports ``torch`` and never ``jax``,
``flax`` or ``deepspeed_tpu``; where it needs a JAX-free helper from
the reference it keeps its own copy.

Ported so far: GPT-2 serving on the ring KV cache
(:mod:`deepspeed_tpu_torch.inference`), with flash decode as a
hand-written ``sm_90a`` CUDA kernel (:mod:`deepspeed_tpu_torch.ops`);
and GPT-2 training through :func:`initialize` and the engine's dense
path (:mod:`deepspeed_tpu_torch.runtime`), with the flash-attention
forward / backward and the fused Adam as hand-written CUDA kernels.

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


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, seed=0, device=None):
    """Build the training engine (``deepspeed_tpu/__init__.py:28``).

    ``model`` is an ``nn.Module`` holding fp32 master params (moved to
    ``device``); ``loss_fn(batch, rng)`` defaults to ``model.loss_fn``
    or, for a :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHead`, to
    ``make_gpt2_loss_fn(model)``. ``config`` is a DeepSpeed config dict
    or JSON path (or ``args.deepspeed_config``). Runs on CUDA unless
    ``device="cpu"``. Returns ``(engine, optimizer, dataloader,
    lr_scheduler)``; the data loader is not yet ported, so it is None.
    """
    from deepspeed_tpu_torch.models.gpt2 import (
        GPT2LMHead, make_gpt2_loss_fn)
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    not_yet = {"training_data": training_data, "mpu": mpu,
               "collate_fn": collate_fn}
    given = sorted(k for k, v in not_yet.items() if v is not None)
    if given:
        raise NotImplementedError(
            f"initialize: {given} not yet ported to deepspeed_tpu_torch")
    if model is None:
        raise ValueError("initialize needs the model (an nn.Module)")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("config (dict or json path) required")
    dev = resolve_device(device)
    model.to(dev)
    if loss_fn is None:
        loss_fn = getattr(model, "loss_fn", None)
    if loss_fn is None and isinstance(model, GPT2LMHead):
        loss_fn = make_gpt2_loss_fn(model)
    if loss_fn is None:
        raise ValueError("pass loss_fn(batch, rng) or a model exposing "
                         ".loss_fn")
    engine = DeepSpeedEngine(model, loss_fn, config, dev,
                             optimizer=optimizer,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, seed=seed)
    return engine, None, None, engine.lr_scheduler
