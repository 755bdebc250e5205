"""Activation checkpointing (port of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

:func:`checkpoint` runs a model segment under
``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward instead of kept, as ``jax.checkpoint`` does.
The policies of :func:`make_policy`:

- ``nothing``: keep only the segment's inputs; full recompute;
- ``dots``: keep the matmul outputs (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``addbmm``; GPT-2's remat "dots" is this policy),
  recompute the rest (JAX ``checkpoint_dots``);
- ``dots_no_batch``: keep ``mm`` / ``addmm`` outputs, not the batched
  products (JAX ``checkpoint_dots_with_no_batch_dims``);
- ``everything``: keep everything; no recompute;
- ``offload`` (the default under ``cpu_checkpointing``): keep
  everything, in host memory (``torch.autograd.graph.save_on_cpu``,
  pinned when the card is there), in place of JAX's pinned-host offload
  policy.

A callable policy is used as a selective-checkpoint policy
(``(ctx, op, *args, **kwargs) -> CheckpointPolicy``).

Randomness: ``jax.checkpoint`` replays dropout because JAX keys are
values. The port's models draw dropout from explicit ``torch.Generator``
objects, which ``preserve_rng_state`` does not replay, so the recompute
is run by :func:`replayable`: the generators among the segment's
arguments (or held by an argument as ``.generator``) and the
:class:`RNGKeyTracker`'s streams start the recompute where the forward
started, and are put back where the forward left them; the fp8 sites
take the forward's state keys (``ops/fp8.py:snapshot``). The default
generators are replayed by ``preserve_rng_state``. Attention-prob
dropout is the counter hash and replays by construction.

``partition_activations`` with a model axis of M ranks (``configure(
mpu_=...)``; the engine passes its ``mpu``): a full-recompute segment
(policy ``nothing``) keeps 1/M of each tensor input on each rank (the
flattened input cut in M pieces, the reference's flatten-and-split,
where JAX's ``_partition_constraint`` shards the trailing dim) and
all-gathers them over the model group before its recompute
(:class:`_PartitionedSegment`); the gradients do not change. Without a
model axis, or under another policy (which keeps its saved tensors),
it is a no-op, as JAX's is outside a mesh. ``contiguous_memory_
optimization`` is read and recorded, as in JAX. ``profile`` times each
checkpointed call with a :class:`~deepspeed_tpu_torch.telemetry.timers.
SynchronizedWallClockTimer`; ``synchronize_checkpoint_boundary``
synchronizes the card after each.
"""

import contextlib
import copy

import torch

from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig)
from deepspeed_tpu_torch.telemetry.timers import SynchronizedWallClockTimer

__all__ = [
    "configure", "is_configured", "reset", "checkpoint",
    "checkpoint_sequential", "make_policy", "replayable", "RNGKeyTracker",
    "get_rng_tracker", "model_parallel_seed",
]

_config = None
_timers = None
_mpu = None


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Configure the module from a ``DeepSpeedConfig`` (or a config
    dict) or explicit kwargs (JAX ``configure``); ``mpu_`` gives
    ``partition_activations`` its model axis."""
    global _config, _timers, _mpu
    if mpu_ is not None:
        _mpu = mpu_
    if deepspeed_config is not None:
        cfg = getattr(deepspeed_config, "activation_checkpointing_config",
                      None)
        if cfg is None:
            cfg = DeepSpeedActivationCheckpointingConfig(
                deepspeed_config if isinstance(deepspeed_config, dict)
                else {})
        else:
            # the caller's config object is never mutated
            cfg = copy.copy(cfg)
    else:
        cfg = DeepSpeedActivationCheckpointingConfig({})
    if partition_activations is not None:
        cfg.partition_activations = partition_activations
    if contiguous_checkpointing is not None:
        cfg.contiguous_memory_optimization = contiguous_checkpointing
    if num_checkpoints is not None:
        cfg.number_checkpoints = num_checkpoints
    if checkpoint_in_cpu is not None:
        cfg.cpu_checkpointing = checkpoint_in_cpu
    if synchronize is not None:
        cfg.synchronize_checkpoint_boundary = synchronize
    if profile is not None:
        cfg.profile = profile
    _config = cfg
    if cfg.profile and _timers is None:
        _timers = SynchronizedWallClockTimer()
    return cfg


def is_configured():
    return _config is not None


def set_mpu(mpu_):
    """The model axis ``partition_activations`` splits over (the
    engine's ``mpu`` when the user configured the module first)."""
    global _mpu
    _mpu = mpu_


def reset():
    """Drop the configuration and the RNG tracker's streams."""
    global _config, _timers, _mpu
    _config = None
    _timers = None
    _mpu = None
    _RNG_TRACKER.reset()


def _cfg():
    return _config if _config is not None else \
        DeepSpeedActivationCheckpointingConfig({})


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

_ALL_DOTS = ("mm", "bmm", "addmm", "baddbmm", "addbmm")
_NO_BATCH_DOTS = ("mm", "addmm")


def _keep_ops(names):
    ops = frozenset(getattr(torch.ops.aten, n).default for n in names)

    def policy(ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


_NAMED_POLICIES = {
    "nothing": lambda: "nothing",
    "dots": lambda: _keep_ops(_ALL_DOTS),
    "dots_no_batch": lambda: _keep_ops(_NO_BATCH_DOTS),
    "everything": lambda: "everything",
    "offload": lambda: "offload",
}


def make_policy(name=None):
    """A policy by name, or the configured default (``offload`` under
    ``cpu_checkpointing``, else ``nothing``): a selective-checkpoint
    policy function, or one of the names ``nothing`` / ``everything`` /
    ``offload``. A callable passes through."""
    if callable(name):
        return name
    if name is None:
        name = "offload" if _cfg().cpu_checkpointing else "nothing"
    try:
        return _NAMED_POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown checkpoint policy {name!r}; "
            f"one of {sorted(_NAMED_POLICIES)}")


# ---------------------------------------------------------------------------
# replay of the forward's state in the recompute
# ---------------------------------------------------------------------------

def _generators(args):
    out = []

    def visit(a):
        if isinstance(a, torch.Generator):
            out.append(a)
        elif isinstance(getattr(a, "generator", None), torch.Generator):
            out.append(a.generator)
        elif isinstance(a, (list, tuple)):
            for b in a:
                visit(b)

    for a in args:
        visit(a)
    return list({id(g): g for g in out}.values())


def replayable(function, generators=()):
    """``function`` for a checkpoint: its first call (the forward) runs
    as it is and notes where ``generators``, the RNG tracker's streams
    and the fp8 scope's call counts stand; a later call (the recompute)
    runs from there, then puts them back where the forward left them."""
    from deepspeed_tpu_torch.ops import fp8
    snap = []

    def run(*args, **kwargs):
        if not snap:
            snap.append(([(g, g.get_state()) for g in generators],
                         _RNG_TRACKER.get_states(), fp8.snapshot()))
            return function(*args, **kwargs)
        gens, tracker, f8 = snap[0]
        after = [(g, g.get_state()) for g, _ in gens]
        tracker_after = _RNG_TRACKER.get_states()
        for g, state in gens:
            g.set_state(state)
        _RNG_TRACKER.set_states(tracker)
        try:
            with fp8.replaying(f8):
                return function(*args, **kwargs)
        finally:
            for g, state in after:
                g.set_state(state)
            _RNG_TRACKER.set_states(tracker_after)

    return run


# ---------------------------------------------------------------------------
# checkpoint()
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _profiled(name):
    if _cfg().profile and _timers is not None:
        _timers(name).start()
        try:
            yield
        finally:
            _timers(name).stop()
            _timers.log([name])
    else:
        yield


_TENSOR = object()       # a tensor argument's place in a segment's inputs


class _PartitionedSegment(torch.autograd.Function):
    """A full-recompute segment whose tensor inputs are kept as this
    rank's 1/M piece of their flattened values, all-gathered over the
    model group before the recompute (``partition_activations``)."""

    @staticmethod
    def forward(ctx, run, tp, *args):
        ctx.run, ctx.tp = run, tp
        ctx.kinds, kept, ctx.geometry = [], [], []
        for a in args:
            if torch.is_tensor(a):
                flat = a.detach().reshape(-1)
                n = -(-flat.numel() // tp.size)
                flat = torch.nn.functional.pad(
                    flat, (0, n * tp.size - flat.numel()))
                kept.append(flat[tp.rank * n:(tp.rank + 1) * n].clone())
                ctx.geometry.append((a.shape, a.requires_grad))
                ctx.kinds.append(_TENSOR)
            else:
                ctx.kinds.append(a)
        ctx.save_for_backward(*kept)
        with torch.no_grad():
            return run(*args)

    @staticmethod
    def backward(ctx, *grads):
        from deepspeed_tpu_torch.parallel.collectives import all_gather
        pieces = iter(ctx.saved_tensors)
        geometry = iter(ctx.geometry)
        inputs = []
        for kind in ctx.kinds:
            if kind is not _TENSOR:
                inputs.append(kind)
                continue
            shape, needs = next(geometry)
            whole = all_gather(next(pieces), ctx.tp, dim=0)
            x = whole[:int(torch.Size(shape).numel())].reshape(shape)
            inputs.append(x.detach().requires_grad_(needs))
        with torch.enable_grad():
            out = ctx.run(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if torch.is_tensor(o) and o.requires_grad and g is not None]
        torch.autograd.backward([o for o, _ in pairs],
                                [g for _, g in pairs])
        return (None, None) + tuple(
            x.grad if torch.is_tensor(x) and x.requires_grad else None
            for x in inputs)


def _partition_axis():
    """The model axis ``partition_activations`` splits over, or None."""
    if not _cfg().partition_activations or _mpu is None:
        return None
    from deepspeed_tpu_torch.parallel.mesh import model_axis_of
    tp = model_axis_of(_mpu)
    return tp if tp.active else None


def checkpoint(function, *args, policy=None, static_argnums=(),
               prevent_cse=False):
    """``function(*args)`` with its activations recomputed in the
    backward under ``policy`` (see the module docstring). Dropout drawn
    from generators among ``args`` replays bit for bit.
    ``static_argnums`` and ``prevent_cse`` are JAX tracing knobs with
    nothing to do here (accepted for the signature)."""
    del static_argnums, prevent_cse
    cfg = _cfg()
    pol = make_policy(policy)
    tp = _partition_axis() if pol == "nothing" and \
        torch.is_grad_enabled() else None
    with _profiled("activation_checkpoint"):
        if tp is not None:
            run = replayable(function, _generators(args))
            out = _PartitionedSegment.apply(run, tp, *args)
        elif pol == "everything":
            out = function(*args)
        elif pol == "offload":
            with torch.autograd.graph.save_on_cpu(
                    pin_memory=torch.cuda.is_available()):
                out = function(*args)
        else:
            from torch.utils.checkpoint import (
                checkpoint as torch_checkpoint,
                create_selective_checkpoint_contexts)
            kw = {}
            if pol != "nothing":
                kw["context_fn"] = \
                    lambda: create_selective_checkpoint_contexts(pol)
            run = replayable(function, _generators(args))
            out = torch_checkpoint(run, *args, use_reentrant=False,
                                   preserve_rng_state=True, **kw)
    if cfg.synchronize_checkpoint_boundary and torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def checkpoint_sequential(functions, x, num_checkpoints=None, policy=None):
    """Apply ``functions`` in order, checkpointed in ``num_checkpoints``
    segments (default: the config's ``number_checkpoints``, else one per
    function), the segment bounds ``round(i * n / segments)`` as JAX
    cuts them."""
    n = len(functions)
    segs = num_checkpoints or _cfg().number_checkpoints or n
    segs = max(1, min(segs, n))
    bounds = [round(i * n / segs) for i in range(segs + 1)]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if lo == hi:
            continue

        def segment(y, fns=tuple(functions[lo:hi])):
            for f in fns:
                y = f(y)
            return y

        x = checkpoint(segment, x, policy=policy)
    return x


# ---------------------------------------------------------------------------
# named RNG streams
# ---------------------------------------------------------------------------

class RNGKeyTracker:
    """Named random streams (JAX ``RNGKeyTracker``): ``add(name, seed)``
    registers one, ``fork(name)`` yields a fresh ``torch.Generator``
    seeded from ``(seed, n)`` for the stream's n-th fork
    (``fold_in_seed``, the JAX ``fold_in`` of the stream's key), so the
    streams are deterministic and a checkpoint's recompute forks what its
    forward forked."""

    def __init__(self):
        self._seeds = {}
        self._counts = {}

    def reset(self):
        self._seeds.clear()
        self._counts.clear()

    def get_states(self):
        return dict(self._seeds), dict(self._counts)

    def set_states(self, states):
        seeds, counts = states
        self._seeds = dict(seeds)
        self._counts = dict(counts)

    def add(self, name, seed):
        if name in self._seeds:
            raise Exception(f"RNG stream {name} already present")
        self._seeds[name] = int(seed)
        self._counts[name] = 0

    @contextlib.contextmanager
    def fork(self, name="model-parallel-rng", device=None):
        """Yield the stream's next generator, on ``device`` (default the
        card when there is one, else the CPU)."""
        from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
        if name not in self._seeds:
            raise Exception(f"RNG stream {name} not added")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        gen = torch.Generator(device=device)
        gen.manual_seed(fold_in_seed(self._seeds[name], self._counts[name])
                        & 0xFFFFFFFF)
        self._counts[name] += 1
        yield gen


_RNG_TRACKER = RNGKeyTracker()
_MODEL_PARALLEL_RNG = "model-parallel-rng"


def get_rng_tracker():
    return _RNG_TRACKER


def model_parallel_seed(seed, model_parallel_rank=0, offset=2718):
    """Seed two streams as Megatron does (JAX ``model_parallel_seed``): a
    ``default`` stream the same on every model-parallel rank and a
    ``model-parallel-rng`` stream offset per rank."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("default", seed)
    _RNG_TRACKER.add(_MODEL_PARALLEL_RNG,
                     seed + offset + model_parallel_rank)
    return _RNG_TRACKER
