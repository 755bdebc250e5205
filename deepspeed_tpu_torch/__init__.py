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
GPT-2 training through :func:`initialize` and the engine's dense
path (:mod:`deepspeed_tpu_torch.runtime`), with the flash-attention
forward / backward and the fused Adam as hand-written CUDA kernels;
paged serving with flash decode over page tables; BERT MLM training
with block-sparse attention (:mod:`deepspeed_tpu_torch.models.bert`,
:mod:`deepspeed_tpu_torch.ops.sparse_attention`), whose forward, dQ and
dK/dV are hand-written CUDA kernels too; ZeRO-Offload training (the
C++ host Adam, :mod:`deepspeed_tpu_torch.ops.adam.cpu_adam`), GPT-2's
remat, the data loader and preemption-safe checkpoints; and data
parallelism across processes (:mod:`deepspeed_tpu_torch.parallel`, one
process a GPU over NCCL) with ZeRO stages 0-3
(:mod:`deepspeed_tpu_torch.runtime.zero`) and offload across processes;
and pipeline parallelism over a ``pipe`` x ``data`` topology
(:mod:`deepspeed_tpu_torch.pipe`, :mod:`deepspeed_tpu_torch.runtime.pipe`).

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


def _check_plain_mesh(config):
    """A model that is not a PipelineModule runs on the data axis only."""
    from deepspeed_tpu_torch.parallel.mesh import check_mesh_axes
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    raw = config if isinstance(config, dict) else \
        DeepSpeedConfig(config)._param_dict
    check_mesh_axes(raw.get("mesh"))
    pipe = (raw.get("mesh") or {}).get("pipe") or \
        (raw.get("pipeline") or {}).get("stages") or 1
    if int(pipe) > 1:
        raise ValueError(f"a pipeline of {pipe} stages needs a "
                         f"PipelineModule (deepspeed_tpu_torch.pipe)")


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, seed=0, device=None,
               stage_devices=None):
    """Build the training engine (``deepspeed_tpu/__init__.py:28``).

    ``model`` is an ``nn.Module`` holding fp32 master params. The
    engine moves it to ``device``, except under ZeRO-Offload, where the
    masters stay in host RAM and the device gets only their
    compute-dtype copy (so build a large model on the host).
    ``loss_fn(batch, rng)`` defaults to ``model.loss_fn`` (the port's
    GPT-2 and BERT models each have one). ``config`` is a DeepSpeed
    config dict or JSON path (or ``args.deepspeed_config``).
    ``training_data`` (an indexable dataset) and ``collate_fn`` build the
    engine's data loader, as JAX's ``deepspeed_io`` does. Runs on CUDA
    unless ``device="cpu"``. With the ``DS_TPU_*`` launcher env (or a
    process group already up) the engine joins the data-parallel group
    (:func:`deepspeed_tpu_torch.parallel.initialize_distributed`) and
    each process passes its ``train_batch_size // world`` rows. Returns
    ``(engine, optimizer, dataloader, lr_scheduler)``; the optimizer is
    the client's object (``optimizer``: the port's ``FusedAdam`` or
    ``FusedLamb``, or any object with JAX's ``init`` / ``update``
    protocol), None without one.

    A :class:`deepspeed_tpu_torch.pipe.PipelineModule` routes to the
    :class:`~deepspeed_tpu_torch.runtime.pipe.engine.PipelineEngine`
    (JAX ``__init__.py:47-110``): its ``loss_fn`` is the module's,
    ``model_parameters`` (optional) its weights in the pipe layout, and
    the ``mesh`` key lays its stages over the processes;
    ``stage_devices`` runs every stage in this process, stage s on
    ``stage_devices[s]``.
    """
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    if mpu is not None:
        raise NotImplementedError(
            "initialize: ['mpu'] not yet ported to deepspeed_tpu_torch")
    if model is None:
        raise ValueError("initialize needs the model (an nn.Module)")
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("config (dict or json path) required")
    dev = resolve_device(device)
    if isinstance(model, PipelineModule):
        from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
        engine = PipelineEngine(model, config, dev, optimizer=optimizer,
                                model_parameters=model_parameters,
                                lr_scheduler=lr_scheduler, seed=seed,
                                training_data=training_data,
                                collate_fn=collate_fn,
                                stage_devices=stage_devices)
        return engine, engine.client_optimizer, \
            engine.training_dataloader, engine.lr_scheduler
    _check_plain_mesh(config)
    if loss_fn is None:
        loss_fn = getattr(model, "loss_fn", None)
    if loss_fn is None:
        raise ValueError("pass loss_fn(batch, rng) or a model exposing "
                         ".loss_fn")
    engine = DeepSpeedEngine(model, loss_fn, config, dev,
                             optimizer=optimizer,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, seed=seed,
                             training_data=training_data,
                             collate_fn=collate_fn)
    return engine, engine.client_optimizer, \
        engine.training_dataloader, engine.lr_scheduler
