"""DeepSpeedEngine (port of ``deepspeed_tpu/runtime/engine.py``): the
dense path under data parallelism with ZeRO stages 0-3, ZeRO-Offload
(also across processes), the data loader and checkpoints.

One ``train_batch`` is the JAX compiled train step (``engine.py:1023``)
run eagerly:

- gradient accumulation: a Python loop over the micro-batches (the JAX
  ``lax.scan``), each one ``(loss * scale).backward()`` into fp32
  gradients;
- fp32 master params; under bf16 / fp16 the forward sees their
  compute-dtype copies, put in the model's place by
  :class:`~deepspeed_tpu_torch.runtime.zero.stage3.ParamInstaller` (the
  JAX engine's ``cast_params``: LayerNorm scales round too, and a tied
  leaf's two uses sum in the compute dtype);
- :func:`grad_epilogue`: unscale and average, the fp16 overflow check,
  the global norm and clipping, in place on the gradients;
- Adam / AdamW: every step is one launch of the fused kernel K4
  (``ops/fused_adam.py``) over the rank's pieces, with or without
  ``optimizer.params.pallas`` (the JAX engine's choice between XLA and
  its Pallas kernel); LAMB (``ops/lamb/fused_lamb.py:lamb_step_``, plain
  PyTorch as JAX's is ``jnp``), its per-leaf norms summed over the data
  group under ZeRO; a client optimizer object (``initialize(optimizer=
  ...)``): the port's ``FusedAdam`` runs K4 and ``FusedLamb`` the LAMB
  step with the object's hyperparameters, any other object with JAX's
  ``init`` / ``update`` protocol runs functionally on the masters;
- the fp16 overflow skip and :func:`loss_scale_epilogue` on device
  tensors (``torch.where``, no host sync); counters as in
  ``DeviceState``.

Nothing in a step waits on the device except the ``steps_per_print``
log line, and what the config asks for: telemetry, ``wall_clock_
breakdown``, a trace window, TensorBoard or the resilience guards.

**Data parallelism** (one process a device, joined by
:func:`~deepspeed_tpu_torch.parallel.initialize_distributed` from the
``DS_TPU_*`` env or an existing group: NCCL on CUDA, gloo on the CPU).
Each process passes its ``train_batch_size // world`` rows; rank r's
micro-batch k is global micro-batch k's rows ``[r*m, (r+1)*m)`` (JAX
``_shard_batch``). Every collective goes through the engine's
:class:`~deepspeed_tpu_torch.runtime.zero.comm.Comm`, which counts them.
The stages, each computing what the JAX engine computes at that stage
and world size, with the leaf partition of ``runtime/zero/sharding.py``:

- stage 0: the accumulated fp32 gradient is all-reduced; the norm is
  local (the gradient is replicated); K4 over the whole leaves;
- stage 1: the accumulated gradient is reduce-scattered into the rank's
  pieces; K4 updates the rank's fp32 master pieces and their moments;
  the updated masters are all-gathered into the replicated params;
- stage 2: each leaf's gradient is reduce-scattered into a sharded fp32
  accumulator as soon as the backward has produced it (a
  post-accumulate-grad hook), so no whole gradient is carried across
  micro-batches; then as stage 1;
- stage 3: the params live only as fp32 pieces, gathered on use
  (``runtime/zero/stage3.py``); the gradient arrives reduce-scattered;
  K4 updates the pieces in place.

From stage 1 on the norm is global: each rank's sum of squares over its
pieces (a replicated leaf on rank 0 only), all-reduced. The fp16
overflow flag is all-reduced with MAX, so every rank skips together; the
reported loss is the ranks' mean. World 1 is a partition into one piece:
with a group of one (the card in ``chip_smoke.py``) every collective is
issued, and changes no number.

**ZeRO-Offload** (``zero_optimization.cpu_offload``, at any stage, as in
JAX ``engine.py:440``): the fp32 masters and both moments live in host
RAM in :class:`~deepspeed_tpu_torch.ops.adam.cpu_adam.DeepSpeedCPUAdam`,
and the device holds only the compute-dtype params, as views of one flat
buffer. The model is never moved to the device in fp32. A step:

- loss and gradients on the device, differentiated with respect to the
  compute-dtype params (JAX ``make_grad_accumulator`` over the offload
  params): each micro-batch's 16-bit gradient is added into one flat
  fp32 accumulator, as JAX's scan carry;
- :func:`grad_epilogue` on that buffer (overflow, norm, clip) and the
  loss scale, on the device;
- with ``offload_16bit_grads`` under bf16 the gradient crosses to the
  host in bf16 (fp32 otherwise, and always under fp16);
- the host phase (:meth:`DeepSpeedEngine._host_phase`), pipelined by
  chunk: every chunk's D2H is issued on a copy stream, then chunk k's
  bytes are widened while a worker thread runs the C++ Adam and the bf16
  convert of the chunks before it; each finished chunk's params start
  their H2D on an upload stream. An event on the upload stream orders
  the next forward after the uploads, and the next host phase's rewrite
  of the copy-back buffer after them too. ``last_host_phase_s`` records
  its wall;
- an fp16 step that overflows skips the host update (JAX ``:1640``).

Across processes (JAX ``_train_batch_offload_dp``, ``engine.py:1685``)
the flat buffer is cut into ``world`` contiguous rows: the device
gradient is reduce-scattered into the rank's row, the epilogue runs on
the row (global norm), the C++ Adam updates only the row's range of the
host master, and the updated 16-bit rows are all-gathered into every
rank's device params. :meth:`DeepSpeedEngine._offload_sync_host_state`
makes every rank's host buffers whole again (before a checkpoint).

**Progressive layer drop** (``progressive_layer_drop``): the step's
theta is JAX's ``(1 - theta_bar) exp(-gamma t) + theta_bar`` in fp32 at
the step counter ``t`` (``engine.py:1005``), passed to ``loss_fn`` as
``pld_theta``.

**fp8** (``fp8``, JAX ``engine.py:184-320, 1061-1215``): the loss of
every micro-batch runs inside ``ops/fp8.py:fp8_scope`` with the step's
input amax histories; each micro-batch adds its updated ones into a
zeroed ``new_state`` of its own (a key used by several layers, as under
``scan_layers``, sums them, as JAX's gradient of the state does); the
step takes the max over its micro-batches, MAX all-reduces it over
the data group (the amax of the global batch), and replaces the state
with it, except after an fp16 overflow, which keeps the old
histories. The first step allocates the state after a discovery forward
(no gradient, no dropout) that records the sites' keys. Not
checkpointed, as in JAX. ``fp8.wire`` moves stage 3's gathers quantized
(``runtime/zero/stage3.py``).

**Sparse gradients** (``sparse_gradients``, ZeRO stage 0 only, JAX
``engine.py:1848-1990``): the leaves the embedding regex (or
``engine.sparse_grad_predicate``) flags are sparsified to their top-k
rows by L1 mass (k the rank's token count) and exchanged as CSR
(index/value all-gather, ``runtime/csr_tensor.py``); a leaf whose
top-k would drop mass (a tied embedding) falls back to the dense
all-reduce by a MAX vote; ``sparse_grad_dropped`` and
``sparse_grad_dense_fallbacks`` are in the step's metrics.

**Tensor parallelism** (``initialize(mpu=...)`` or a model built with
one, and ``mesh`` ``{"data": N, "model": M}``): the model holds the
shard of its model rank (``models/gpt2.py``), ``mp_world_size`` is M
and ``param_specs`` (default: the model's ``partition_specs``) says
which leaves are split. The engine's :class:`Comm` runs over the data
group only: gradients are reduced there, and ZeRO 1-3 and offload shard
each model rank's leaves over it. The overflow vote and the global
norm also cross the model group: a split leaf's sum of squares is
summed over it, a replicated one counted on model rank 0 only (JAX's
GSPMD norm of the global arrays). fp8's amax histories take the max
over both groups. Checkpoints hold whole leaves (each split leaf
gathered over the model group, its vocab padding cut) and record
``mesh_shape`` in their topology, as JAX's do; they load at any model
size. LAMB sums each split leaf's norms over the model group too.
Sparse gradients refuse a model axis (JAX: pure data parallelism
only).

**The seq and expert axes** (``mesh`` ``{"seq": S}`` or ``{"expert":
E, "data": N}``): rows are sharded over ``data`` only, so every rank of
a data replica's seq and expert groups runs that replica's rows (JAX
``engine.py:2383-2409``), and a dense model computes replicated over
them; without an ``mpu`` the engine builds ``MeshGroups(mesh)``. A
:class:`~deepspeed_tpu_torch.models.gpt2_moe.GPT2MoELMHead` built with
the ``mpu`` holds ``E / ep`` experts of each MoE block; its ``expert_*``
leaves are split over the expert axis (``Shard(0, axis="expert")``):
their gradients are reduced over ``data`` only, and the norm, clipping
and the fp16 vote sum a split leaf's squares over the axis it is split
over and count a replicated leaf once (on rank 0 of every split axis),
which is JAX's norm of the whole leaves. Checkpoints save whole leaves;
ZeRO 1-2 partition each rank's leaves over the data group as before.

**Activation checkpointing** (``activation_checkpointing``): the engine
configures ``runtime/activation_checkpointing/checkpointing.py`` from
the config unless the user already has (JAX ``engine.py:594-600``).

**The gradient compressors** (pure data parallelism, JAX
``engine.py:1345-1520, 2048-2150``):

- ``comm_quantization`` (ZeRO 0-2): each rank's accumulated gradient is
  unscaled before the exchange, the fp16 overflow voted on the local
  gradients (an overflowed step ships zeros), then averaged by the
  bucketed int8 all-reduce (``runtime/comm/quantized.py``; its
  error-feedback residuals are engine state). Stage 0 keeps the average,
  stages 1 and 2 the rank's piece of it: no dense gradient collective
  runs, and stage 2 accumulates whole local gradients as stage 1 does.
  The epilogue then runs at scale 1 on the average;
- 1-bit Adam (``optimizer.type: OneBitAdam`` or a client
  ``OnebitAdam``; ZeRO 0): the gradients stay local. The epilogue votes
  the overflow by MAX, reports the ranks' mean local norm and clips by
  their max; ``runtime/fp16/onebit_adam.py`` averages them densely
  through ``freeze_step``, then averages the momentum with the 1-bit
  all-reduce. An overflowed step keeps the masters and the whole state.
  Checkpoints add the error buffers in JAX's global layout; another data
  world restarts error feedback from zero.

**Resilience** (the ``resilience`` block, JAX ``engine.py:614-690,
1235-1290, 2725-2760, 3274-3360``): the checkpoint manager takes the
block's retention, retries, deadline and async saves; ``save_dir`` with
``save_interval_steps`` saves every that many steps; the hot tier
(``runtime/resilience/hotckpt.py``) snapshots the checkpoint tree to
host RAM every ``hot_checkpoint.interval_steps`` (CRC-stamped on a
worker thread, mirrored under ``mirror_dir``). The guards
(``runtime/resilience/guards.py``) read each step's loss, finiteness
verdict and scale on the host (one sync a step); the NaN guard runs the
finiteness check in fp32 and bf16 too, and ``skip_step`` folds it into
the overflow skip; ``rollback_to_checkpoint`` goes down the restore
ladder (hot RAM, hot mirror, disk: ``_restore_ladder``), ``abort``
raises ``HealthGuardAbort``. ``save_on_sigterm`` latches SIGTERM and,
at the next :meth:`train_batch`, saves and raises ``PreemptedError``
with the checkpoint's path; ``auto_resume`` runs the ladder at
construction. ``fault_injection.enabled`` lets the fault harness plant
NaN gradients and a preemption. ``host_adam_retries`` and
``checkpoint.io_timeout_s`` go to the host Adam. A pipeline's stage
engines run none of it, as JAX's pipeline runs none.

**Telemetry** (the ``telemetry``, ``profiling``, ``tensorboard``,
``wall_clock_breakdown`` / ``memory_breakdown`` and
``compilation_cache_dir`` keys, JAX ``engine.py:533-657, 2547-2800``):
:meth:`DeepSpeedEngine.train_batch` runs its host phases in spans
(``data_load``, ``dispatch``, ``injected_hang``, ``host_adam``,
``device_wait``) of a :class:`~deepspeed_tpu_torch.telemetry.session.
TelemetrySession` and emits JAX's events (``run_start``, one
``compile``, ``step`` with the drained phases, ``health_guard``,
``anomaly``, ``preemption``, ``checkpoint_save`` / ``_load``,
``hot_snapshot``, ``recovery_ladder``) into the session's exporters;
``metrics_history`` keeps the last ``history`` step events. The spans
are ``torch.profiler`` ranges, so the ``profiling`` window's Chrome
trace shows them beside the kernels. ``crash_dump_dir`` adds the flight
recorder (crash hooks installed after the preemption handler, the
step's collectives as its collective source) and ``watchdog`` the hang
watchdog; ``anomaly_trace`` arms the trace window on a step-wall
regression or a guard trip. With telemetry off a step pays one
``is None`` check and the shared no-op span, and waits for nothing.
``compilation_cache_dir`` is the directory of the kernel builds
(``telemetry/compile_cache.py``), applied before the first build.

The pipeline is ``runtime/pipe/engine.py:PipelineEngine``, which
runs one engine of this class per stage: its ``comm`` is the stage's
data group (:class:`Comm` over a sub-group), its model the stage's
layers; the stage engines run no telemetry of their own.

**Data** (``training_data``): :meth:`DeepSpeedEngine.deepspeed_io` builds
a :class:`~deepspeed_tpu_torch.runtime.dataloader.DeepSpeedDataLoader`
of ``train_batch_size`` rows, and ``train_batch()`` without a batch
pulls from it through a ``RepeatingLoader``.

**Checkpoints** (:meth:`DeepSpeedEngine.save_checkpoint`,
:meth:`DeepSpeedEngine.load_checkpoint`, JAX ``engine.py:2993-3270``):
written through :class:`~deepspeed_tpu_torch.runtime.resilience.
CheckpointManager` (atomic, CRC32 manifest, one ``.npy`` a leaf). The
state is the fp32 masters (``params``, by module param name), the
optimizer state (K4's per-leaf ``m``, ``v`` and ``step`` on the dense
path; the host Adam's flat ``exp_avg``, ``exp_avg_sq`` and ``step``
under offload) and the device counters; ``meta.json`` holds the step
counters, the seed, the lr scheduler, the data cursor and
``client_state``. Every leaf is saved whole: the ranks gather their
pieces, rank 0 writes and the others wait at a barrier; on load every
rank reads the whole leaves and keeps its pieces. So a dense checkpoint
from any stage and world loads at any other (JAX
``test_checkpoint_elastic_resharding``); one saved with another offload
setting raises :class:`CheckpointTopologyError`.

Randomness: the step's dropout seed is an int32 derived from
``(seed, global_steps)`` with ``fold_in_seed`` (micro-batch ``i`` folds
in ``i``; the forward/backward API uses stream 1 and ``micro_steps``),
and the model seeds its hidden-dropout ``torch.Generator`` from it. This
deliberately does not reproduce the JAX engine's ``jax.random`` stream;
the attention-prob dropout mask is still the bit-identical counter hash
for a given int32 seed.
"""

import atexit
import collections
import contextlib
import json
import os
import re
import signal
import socket
import time
import weakref
from typing import Any, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import fp8 as fp8_ops
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam, init_adam_state
from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed, global_rows
from deepspeed_tpu_torch.ops.fused_adam import fused_adam_update
from deepspeed_tpu_torch.ops.lamb.fused_lamb import (
    FusedLamb,
    init_lamb_state,
    lamb_step_,
)
from deepspeed_tpu_torch.runtime.config import (
    ADAM_OPTIMIZER,
    DeepSpeedConfig,
    LAMB_OPTIMIZER,
    ONEBIT_ADAM_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.comm.quantized import (
    init_residuals,
    quantized_allreduce_tree,
)
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import (
    OnebitAdam,
    init_onebit_state,
)
from deepspeed_tpu_torch.runtime.resilience import fault_injection
from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
    CheckpointManager,
)
from deepspeed_tpu_torch.runtime.resilience.guards import (
    ACTION_ABORT,
    ACTION_ROLLBACK,
    ACTION_SKIP_STEP,
    HealthGuardAbort,
    StepHealthMonitor,
)
from deepspeed_tpu_torch.runtime.resilience.hotckpt import (
    HotCheckpointCorruptError,
    HotCheckpointStore,
)
from deepspeed_tpu_torch.runtime.resilience.preemption import (
    PreemptedError,
    PreemptionHandler,
)
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (
    init_loss_scale_state,
    update_loss_scale,
)
from deepspeed_tpu_torch.runtime.dataloader import (
    DeepSpeedDataLoader,
    RepeatingLoader,
)
from deepspeed_tpu_torch.runtime.lr_schedules import (
    OneCycle,
    get_lr_scheduler,
)
from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop,
)
from deepspeed_tpu_torch.parallel import collectives as tp_comm
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl
from deepspeed_tpu_torch.runtime.zero.comm import Comm
from deepspeed_tpu_torch.runtime.zero.sharding import (
    Partition,
    is_transposed,
)
from deepspeed_tpu_torch.runtime.zero.stage3 import ParamInstaller
from deepspeed_tpu_torch.runtime.utils import (
    check_overflow,
    clip_by_global_norm,
    global_norm,
)
from deepspeed_tpu_torch.telemetry import compile_cache
from deepspeed_tpu_torch.telemetry.profiler import TraceProfiler
from deepspeed_tpu_torch.telemetry.session import (
    TelemetrySession,
    set_default_session,
)
from deepspeed_tpu_torch.telemetry.spans import null_span
from deepspeed_tpu_torch.telemetry.timers import (
    SynchronizedWallClockTimer,
    ThroughputTimer,
)
from deepspeed_tpu_torch.telemetry.watchdog import StepAnomalyDetector
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class DeviceState(NamedTuple):
    """Step state kept on the device (0-d tensors)."""
    loss_scale: Any              # LossScaleState
    global_step: torch.Tensor    # i32: optimizer-step boundaries seen
    skipped_steps: torch.Tensor  # i32: overflow-skipped steps
    consecutive_skipped: torch.Tensor  # i32: current skip streak


def grad_epilogue(grads, scale, accum, fp16, clip, comm=None,
                  sharded=False, counted=None, split=(), average=True,
                  vote=None, norm_reduce=None, clip_norm_reduce=None,
                  detect_nonfinite=False, nan_skip=False):
    """Unscale and average over micro-batches, the fp16 overflow check,
    the global norm and clipping (``engine.py:99``), IN PLACE on
    ``grads`` (the engine's gradient buffers, so the fused optimizer's
    leaf table keeps its pointers). Returns ``(overflow, nonfinite,
    grad_norm, applied_norm)`` as 0-d device tensors.

    With ``comm`` (an active :class:`Comm`) the gradients are summed
    over its ranks: they are averaged by the world size too, and the
    overflow flag is voted (MAX) so every rank skips together. With
    ``sharded`` they are this rank's pieces and the norm is the global
    one (``counted``: see :func:`global_norm`); else they are replicated
    and the local norm is the global one. ``split`` (the model and
    expert axes of more than one rank) votes the overflow and sums the
    squares over each of those groups too (``counted`` then leaves a
    leaf out on every rank but rank 0 of each axis it is not split
    over).

    The gradient compressors (JAX ``engine.py:99``'s hooks): ``average``
    False leaves out the division by the world size (the quantized
    exchange averaged already); ``vote`` replaces the fp16 overflow vote
    over ``comm``; ``norm_reduce`` maps the local norm to the reported
    one and ``clip_norm_reduce`` to the one clipping divides by (1-bit
    Adam's local gradients: the ranks' mean and max).

    The NaN guard (JAX's ``detect_nonfinite`` / ``nan_skip``):
    ``detect_nonfinite`` runs the finiteness check (voted as above) in
    fp32 and bf16 too, where it is otherwise skipped; ``nan_skip`` also
    folds its verdict into ``overflow``, so the overflow skip drops the
    update. ``nonfinite`` is always the check's own verdict."""
    world = comm.world if comm is not None and average else 1
    denom = scale * accum * world if world > 1 else scale * accum
    for g in grads:
        g.div_(denom)
    device = grads[0].device
    if fp16 or detect_nonfinite:
        nonfinite = check_overflow(grads)
        if vote is not None:
            nonfinite = vote(nonfinite)
        elif comm is not None:
            nonfinite = comm.any_flag(nonfinite)
        if split:
            flag = nonfinite.to(torch.float32).reshape(1)
            for g in split:
                flag = tp_comm.all_reduce(flag, g, op="max")
            nonfinite = flag.reshape(()) > 0
    else:
        nonfinite = torch.zeros((), dtype=torch.bool, device=device)
    overflow = nonfinite if (fp16 or nan_skip) else \
        torch.zeros((), dtype=torch.bool, device=device)
    reduce = None
    if (sharded and comm is not None) or split:
        def reduce(t):
            if sharded and comm is not None:
                comm.all_reduce(t, stat=True)
            for g in split:
                t = tp_comm.all_reduce(t, g)
            return t
    def nr(n):
        return norm_reduce(n) if norm_reduce is not None else n

    local = global_norm(grads, reduce, counted)
    grad_norm = nr(local)
    applied_norm = grad_norm
    if clip > 0:
        clipped = clip_by_global_norm(
            grads, clip, norm=clip_norm_reduce(local)
            if clip_norm_reduce is not None else grad_norm)
        for g, c in zip(grads, clipped):
            g.copy_(c)
        applied_norm = nr(global_norm(grads, reduce, counted))
    return overflow, nonfinite, grad_norm, applied_norm


def loss_scale_epilogue(dstate, overflow, fp16, dynamic, scale_args):
    """Dynamic-loss-scale update and step/skip counters
    (``engine.py:141``)."""
    if fp16 and dynamic:
        new_scale = update_loss_scale(dstate.loss_scale, overflow,
                                      **scale_args)
    else:
        new_scale = dstate.loss_scale
    ovf = overflow.to(torch.int32)
    return DeviceState(
        loss_scale=new_scale,
        global_step=dstate.global_step + 1,
        skipped_steps=dstate.skipped_steps + ovf,
        consecutive_skipped=(dstate.consecutive_skipped + 1) * ovf)


def step_metrics(loss_sum, accum, grad_norm, applied_norm, lr, scale,
                 overflow, dstate=None, nonfinite=None):
    """The step's metrics dict (``engine.py:159``); values stay on the
    device until read."""
    out = {"loss": loss_sum / accum, "grad_norm": grad_norm,
           "applied_grad_norm": applied_norm, "lr": lr,
           "loss_scale": scale, "overflow": overflow}
    if dstate is not None:
        out["skipped_steps"] = dstate.skipped_steps
        out["consecutive_skipped_steps"] = dstate.consecutive_skipped
    if nonfinite is not None:
        out["grad_nonfinite"] = nonfinite
    return out


def _backward(loss, scale):
    (loss * scale).backward()


def make_grad_accumulator(loss_fn, accum, after_backward=None,
                          backward=_backward):
    """``accumulate(micro_batches, seeds, scale) -> loss_sum``
    (``engine.py:182``): for each of the ``accum`` micro-batches,
    ``backward(loss, scale)`` adds the scaled loss's gradient into the
    params' ``.grad`` (then ``after_backward()`` runs, when given: the
    offload path folds the 16-bit gradient into its fp32 accumulator
    there). Returns the unscaled loss sum (a 0-d f32 tensor,
    detached)."""

    def accumulate(micro_batches, seeds, scale):
        if len(micro_batches) != accum:
            raise ValueError(f"expected {accum} micro-batches, got "
                             f"{len(micro_batches)}")
        loss_sum = None
        for micro, seed in zip(micro_batches, seeds):
            loss = loss_fn(micro, seed)
            backward(loss, scale)
            if after_backward is not None:
                after_backward()
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum

    return accumulate


def _batch_tokens(batch):
    """Rows x the second dim of the batch's first leaf: tokens for LM
    batches (``[rows, seq]`` ids), rows x features otherwise (JAX
    ``engine.py:2563-2569``); None for no batch."""
    if batch is None:
        return None
    # the first leaf in key order, as JAX's tree_leaves takes it
    first = batch[sorted(batch)[0]] if isinstance(batch, dict) else batch
    shape = tuple(np.shape(first))
    return int(shape[0]) * (int(shape[1]) if len(shape) > 1 else 1)


def _device_wait(t):
    """Wait until the card has run the work queued before ``t`` on its
    stream (the step's loss is the last value a step computes); a CPU
    tensor is ready."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def _int_elements(micro_batches):
    """The integer elements of a rank's micro-batches (JAX's sparse
    token budget: every integer leaf of the local batch)."""
    return sum(int(x.numel()) for mb in micro_batches for x in mb.values()
               if not x.is_floating_point() and not x.is_complex() and
               x.dtype != torch.bool)


class CheckpointTopologyError(ValueError):
    """The checkpoint was saved with another offload setting than this
    engine runs (its flat host state and the dense per-leaf state do not
    convert into each other)."""


class DeepSpeedEngine:
    """Training engine around an ``nn.Module`` with fp32 master params
    and ``loss_fn(batch, rng) -> scalar loss``."""

    def __init__(self, model, loss_fn, config, device, optimizer=None,
                 model_parameters=None, lr_scheduler=None, seed=0,
                 training_data=None, collate_fn=None, comm=None, mpu=None,
                 param_specs=None):
        # the data-parallel group: the DS_TPU_* env or an existing group
        # (NCCL on CUDA, gloo on the CPU); one process without either is
        # world 1. ``comm``: the collectives over another group (a
        # pipeline stage's data group); ``mpu``: the model and data
        # groups of tensor parallelism
        mesh.initialize_distributed(device=device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        comm_given = comm
        self.module = model
        self.loss_fn = loss_fn
        self.device = device
        self.seed = int(seed)
        self.mpu = mpu if mpu is not None else getattr(model, "mpu", None)
        if self.mpu is None and comm is None:
            # a seq or expert axis over a dense model: compute replicated
            # over it, rows sharded over data only (JAX engine.py:2383)
            raw = config if isinstance(config, dict) else \
                DeepSpeedConfig(config)._param_dict
            shape = dict(raw.get("mesh") or {})
            if any(int(shape.get(a) or 1) > 1 for a in ("seq", "expert")):
                self.mpu = mesh.MeshGroups(shape)
        tp = mesh.model_axis_of(self.mpu)
        self._tp = tp if tp.size > 1 else None
        ep = mesh.expert_axis_of(self.mpu)
        self._ep = ep if ep.size > 1 else None
        # the axes a leaf may be split over (its Shard names one)
        self._split_axes = {a: g for a, g in (("model", self._tp),
                                              ("expert", self._ep))
                            if g is not None}
        self.mp_world_size = tp.size
        if comm is None and self.mpu is not None:
            data = mesh.data_axis_of(self.mpu)
            comm = Comm(group=data.pg) if data.pg is not None else Comm()
        self.comm = comm if comm is not None else Comm()
        self.dp_world_size = self.comm.world
        self.dp_rank = self.comm.rank
        self._config = DeepSpeedConfig(config,
                                       world_size=self.dp_world_size)
        if self._config.compilation_cache_dir:
            # before any kernel or host op is built (telemetry/
            # compile_cache.py)
            compile_cache.apply(self._config.compilation_cache_dir)
        want = int((self._config.mesh_shape or {}).get("model") or 1)
        if want != self.mp_world_size and (want > 1 or self._tp):
            raise ValueError(
                f"the mesh's model axis is {want} but the model was built "
                f"for {self.mp_world_size} model-parallel ranks: build it "
                f"with mpu=MeshGroups(mesh) and pass the same mpu")

        if self._config.fp16_enabled:
            self.compute_dtype = torch.float16
        elif self._config.bf16_enabled or self._config.amp_enabled:
            self.compute_dtype = torch.bfloat16
        else:
            self.compute_dtype = torch.float32
        model_dtype = getattr(getattr(model, "config", None), "dtype",
                              self.compute_dtype)
        if model_dtype != self.compute_dtype:
            raise ValueError(
                f"the model computes in {model_dtype} but the config asks "
                f"for {self.compute_dtype}: build the model with "
                f"dtype={self.compute_dtype}")
        self.dynamic_loss_scale = (self._config.fp16_enabled and
                                   self._config.loss_scale == 0)
        self.static_loss_scale = float(self._config.loss_scale) \
            if self._config.fp16_enabled and self._config.loss_scale > 0 \
            else 1.0

        self.params = [p for p in (model.parameters()
                                   if model_parameters is None
                                   else model_parameters)
                       if p.requires_grad]
        # the fp32 masters' bytes (this process's leaves, before any
        # partition), for the compile event
        self._param_bytes = 4 * sum(p.numel() for p in self.params)
        specs = dict(tpl.partition_specs(model))
        specs.update(param_specs or {})
        names = self._param_names()
        self._tp_specs = [
            spec if spec is not None and spec.axis in self._split_axes
            else None for spec in (specs.get(n) for n in names)]
        if self._config.sparse_gradients_enabled:
            for axis, group in (("expert", self._ep), ("model", self._tp)):
                if group is not None:
                    raise AssertionError(
                        f"sparse_gradients supports pure data parallelism; "
                        f"mesh axis {axis!r} has size {group.size}")
        self.micro_steps = 0
        self.global_steps = 0
        self._configure_optimizer(optimizer)
        self._configure_lr_scheduler(lr_scheduler)
        zc = self._config.zero_config
        self._offload = bool(self._config.zero_enabled and zc.cpu_offload)
        self._configure_training_features(model)
        self._configure_compressors(comm_given)
        if zc.offload_16bit_grads and not self._offload:
            log_dist("offload_16bit_grads: true has no effect without "
                     "cpu_offload: true (grads only cross the wire on the "
                     "offload path)", ranks=[0])
        if zc.offload_16bit_grads and self._offload and \
                self._config.fp16_enabled:
            log_dist("offload_16bit_grads: true is inert under fp16 "
                     "compute (grads are unscaled on device before "
                     "transfer; fp16 would flush sub-6e-5 components). "
                     "Grads transfer at fp32 — use bf16 to get the "
                     "16-bit wire", ranks=[0])
        self._stage = self._config.zero_optimization_stage \
            if self._config.zero_enabled else 0
        self._installer = None
        if self._offload:
            self._configure_offload(model)
            self.opt_state = None
        else:
            self.cpu_optimizer = None
            self._configure_dense(model)
        self.device_state = self._init_device_state()
        self._pending_loss = None
        self._micro_loss_sum = None     # forward/backward API, this step
        self._micro_tokens = 0          # ... and its integer batch elements
        self._last_metrics = {}
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        self._data_iter = RepeatingLoader(self.training_dataloader) \
            if self.training_dataloader is not None else None
        self._configure_resilience(comm_given)
        self._configure_telemetry(own=comm_given is None)
        # an explicit user configure() beforehand wins over the config's
        from deepspeed_tpu_torch.runtime.activation_checkpointing import (
            checkpointing as act_ckpt)
        if not act_ckpt.is_configured():
            act_ckpt.configure(mpu_=self.mpu, deepspeed_config=self._config)
        elif self.mpu is not None:
            act_ckpt.set_mpu(self.mpu)
        if self._resilience_on and self._config.resilience.auto_resume:
            resumed = self._restore_ladder()
            if resumed:
                log_dist(f"resilience: auto-resumed from {resumed} at "
                         f"step {self.global_steps}", ranks=[0])
            else:
                log_dist("resilience: auto_resume found no valid "
                         "checkpoint; starting fresh", ranks=[0])

    def _configure_resilience(self, comm_given):
        """The ``resilience`` block (JAX ``engine.py:614-690``): the
        checkpoint manager's retention, retries and async saves, the hot
        tier, the step health guards, the SIGTERM latch and the host
        Adam's retries. A pipeline's stage engines (``comm`` given) keep
        the plain manager: JAX's pipeline runs no resilience either."""
        rz = self._config.resilience
        own = comm_given is None
        self._resilience_on = own and (rz.enabled or rz.hot_enabled)
        self._fault_on = own and bool(rz.fault_injection)
        self._nan_detect = own and rz.nan_guard_action is not None
        self._nan_skip = own and rz.nan_guard_action == ACTION_SKIP_STEP
        self._ckpt_manager = CheckpointManager(
            save_dir=rz.save_dir, keep_last_n=rz.keep_last_n,
            async_save=rz.async_save, io_retries=rz.io_retries,
            io_retry_base_s=rz.io_retry_base_s,
            io_timeout_s=rz.io_timeout_s) if own else CheckpointManager()
        self._hot_store = None
        self._health_monitor = None
        self._preemption = None
        # the last hot snapshot's {"tag", "ms", "bytes"} and the last
        # restore's {"tier", "source", "ms"}
        self.last_hot_snapshot = None
        self.last_recovery = None
        if not own:
            return
        if rz.hot_enabled:
            self._hot_store = HotCheckpointStore(
                capacity=rz.hot_capacity, mirror_dir=rz.hot_mirror_dir,
                mirror_keep=rz.hot_mirror_keep,
                process_index=mesh.dp_rank())
        if rz.guards_enabled:
            self._health_monitor = StepHealthMonitor(
                nan_action=rz.nan_guard_action,
                spike_action=rz.loss_spike_action,
                collapse_action=rz.scale_collapse_action,
                fp16_dynamic=self._config.fp16_enabled and
                self.dynamic_loss_scale,
                spike_window=rz.loss_spike_window,
                spike_factor=rz.loss_spike_factor,
                spike_min_history=rz.loss_spike_min_history,
                collapse_patience=rz.scale_collapse_patience,
                min_scale=self._scale_args()["min_scale"])
        if rz.save_on_sigterm:
            self._preemption = PreemptionHandler().install()
        if self._offload:
            self.cpu_optimizer.host_adam_retries = rz.host_adam_retries
            self.cpu_optimizer.host_adam_timeout_s = rz.io_timeout_s

    # ------------------------------------------------------------------
    # telemetry (JAX ``engine.py:533-592, 649-657, 961-971, 2412-2512``)
    # ------------------------------------------------------------------
    def _configure_telemetry(self, own=True):
        """The synchronized timers, the trace window (``profiling``), the
        ``telemetry`` session with its forensics, and the TensorBoard
        writer. ``own`` is False for a pipeline's stage engines: the
        pipeline engine runs these for the whole step."""
        cfg = self._config
        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=cfg.train_micro_batch_size_per_gpu *
            cfg.gradient_accumulation_steps,
            num_workers=self.dp_world_size,
            steps_per_output=cfg.steps_per_print)
        self.trace_profiler = TraceProfiler(**(cfg.profiling_params or {})) \
            if own else TraceProfiler()
        if self.trace_profiler.enabled:
            atexit.register(self.trace_profiler.close)
        tl = cfg.telemetry
        self.telemetry = None
        self.metrics_history = collections.deque(maxlen=tl.history)
        self.summary_writer = None
        self._batch_tokens = None
        self._anomaly_detector = None
        self._dispatched = False       # a train_batch has run
        self._coll_base = None         # collective counts at step start
        # process identity on run_start / step events and flight dumps:
        # the join key of ``ds_tpu_metrics aggregate``
        self._proc_meta = {"process_index": mesh.dp_rank(),
                           "process_count": mesh.dp_world_size(),
                           "hostname": socket.gethostname()}
        if not own:
            return
        if tl.enabled:
            self.telemetry = TelemetrySession.from_config(
                tl, meta={**self._proc_meta,
                          "flavor": self._telemetry_flavor(),
                          **self._forensics_extra()})
            set_default_session(self.telemetry, replace=False)
            atexit.register(self.telemetry.close)
            if tl.anomaly_trace_enabled:
                self._anomaly_detector = StepAnomalyDetector(
                    factor=tl.anomaly_trace_factor,
                    window=tl.anomaly_trace_window)
            self.telemetry.emit(
                "run_start",
                flavor=self._telemetry_flavor(),
                train_batch_size=cfg.train_batch_size,
                gradient_accumulation_steps=cfg.gradient_accumulation_steps,
                zero_stage=self.zero_optimization_stage(),
                dp_world_size=self.dp_world_size,
                mp_world_size=self.mp_world_size,
                n_devices=mesh.dp_world_size(),
                fp16=self.fp16_enabled(),
                bf16=self.bfloat16_enabled(),
                flops_per_token=tl.flops_per_token or None,
                **self._proc_meta,
                **self._forensics_extra())
        if cfg.tensorboard_enabled and self._proc_meta["process_index"] == 0:
            self.summary_writer = self._get_summary_writer()
        # forensics: after the preemption handler, so a SIGTERM dumps the
        # flight record first and then sets the checkpoint latch
        if self.telemetry is not None:
            flight = self.telemetry.flight
            if flight is not None:
                # weakly: the process-wide crash hooks keep the recorder
                rows = weakref.WeakMethod(self._collective_rows)
                flight.set_collective_source(
                    lambda: rows()() if rows() is not None else [])
                flight.install()
            if self.telemetry.watchdog is not None:
                self.telemetry.watchdog.start()

    def _get_summary_writer(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:
            logger.warning("tensorboard unavailable; disabling")
            return None
        base = os.environ.get("DLWS_JOB_ID", "local")
        log_dir = os.path.join(self._config.tensorboard_output_path or
                               os.path.join(".", "runs"), base,
                               self._config.tensorboard_job_name)
        os.makedirs(log_dir, exist_ok=True)
        return SummaryWriter(log_dir=log_dir)

    def _telemetry_flavor(self):
        """The step flavor on telemetry events: the taxonomy of JAX
        ``analysis/audit.py:_engine_flavor`` (dense, zero1-3, offload,
        quantized, onebit, sparse, fp8; the pipeline engine says
        pipeline)."""
        cfg = self._config
        if self._offload:
            return "offload"
        if cfg.comm_quantization.enabled:
            return "quantized"
        if (cfg.optimizer_name or "").lower() == ONEBIT_ADAM_OPTIMIZER or \
                getattr(self, "_opt_kind", None) == "onebit":
            return "onebit"
        if cfg.sparse_gradients_enabled:
            return "sparse"
        if cfg.fp8.enabled or cfg.fp8.wire_enabled:
            return "fp8"
        stage = self.zero_optimization_stage()
        return f"zero{stage}" if stage else "dense"

    def _forensics_extra(self):
        """Extra run facts on run_start events and flight-dump meta; the
        pipeline engine adds its topology."""
        return {}

    def _comms(self):
        """The data-group collectives whose counts a flight dump reads."""
        return [self.comm]

    def _collective_counts(self):
        return ([c.snapshot() for c in self._comms()],
                tp_comm.collective_counts())

    def _collective_rows(self):
        """The collectives issued since the current step began (since
        the process began, outside a step): the flight recorder's
        collective source. One row per kind and group, with its calls
        and bytes."""
        base_comm, base_mesh = self._coll_base or ([], {})
        now_comm, now_mesh = self._collective_counts()
        rows = []

        def add(site, axis, kind, row, old):
            calls = row["calls"] - old.get("calls", 0)
            if calls:
                rows.append({"site": site, "axis": axis, "primitive": kind,
                             "calls": calls,
                             "bytes": row["bytes"] - old.get("bytes", 0)})

        for i, snap in enumerate(now_comm):
            old = base_comm[i] if i < len(base_comm) else {}
            for kind, row in snap.items():
                add(f"comm{i}/{kind}", "data", kind, row,
                    old.get(kind, {}))
        for kind, row in now_mesh.items():
            add(f"mesh/{kind}", "mesh", kind, row, base_mesh.get(kind, {}))
        return rows

    @staticmethod
    def _scalar_metrics(metrics):
        """Host-scalar view of a step's metrics for the step event
        (missing keys are absent)."""
        out = {}
        for key in ("loss", "lr", "grad_norm", "applied_grad_norm",
                    "loss_scale"):
            if key in metrics:
                try:
                    out[key] = float(metrics[key])
                except Exception:
                    pass
        for key, cast in (("overflow", bool), ("grad_nonfinite", bool),
                          ("skipped_steps", int),
                          ("consecutive_skipped_steps", int)):
            if key in metrics:
                try:
                    out[key] = cast(metrics[key])
                except Exception:
                    pass
        return out

    def _stamp_compile_facts(self, step, compile_seconds):
        """The one-shot ``compile`` event (JAX ``engine.py:2449-2512``).
        ``compile_seconds`` is the first step's host wall through its
        dispatch, kernel loads and builds included. It carries the step
        (``step``, the 0-based index of that first step, as JAX's), the
        flavor, ``flops_per_token``, ``batch_tokens``, the fp32
        masters' ``param_bytes`` and, with ``compilation_cache_dir`` set,
        the kernel build cache's ``compile_cache_hits`` / ``_misses``.
        The JAX event's facts read off the compiled step's HLO
        (``collective_bytes``, ``collective_bytes_by_dtype``,
        ``while_loops``, ``static_peak_bytes``,
        ``static_temp_peak_bytes``) have no counterpart in an eager
        step and are absent."""
        tl = self._config.telemetry
        facts = {"step": step,
                 "flavor": self._telemetry_flavor(),
                 "flops_per_token": tl.flops_per_token or None,
                 "batch_tokens": self._batch_tokens,
                 "compile_seconds": round(compile_seconds, 4),
                 "param_bytes": int(self._param_bytes)}
        if self._config.compilation_cache_dir:
            cc = compile_cache.counts()
            facts["compile_cache_hits"] = cc["hits"]
            facts["compile_cache_misses"] = cc["misses"]
        self.telemetry.emit("compile", **facts)

    def _dump_flight(self, reason, extra=None):
        """Dump the flight record when the recorder is configured (no-op
        otherwise); never raises."""
        flight = self.telemetry.flight if self.telemetry is not None \
            else None
        if flight is not None:
            return flight.dump(reason, extra=extra)
        return None

    def _arm_anomaly_trace(self, reason):
        """Anomaly-triggered trace capture: arm the trace window for the
        next ``capture_steps`` steps (no-op when anomaly_trace is off, a
        window is active, or no trace dir is resolvable)."""
        if self._anomaly_detector is None or self.telemetry is None:
            return
        tl = self._config.telemetry
        trace_dir = self.trace_profiler.trace_dir
        if trace_dir is None and tl.crash_dump_dir:
            trace_dir = os.path.join(tl.crash_dump_dir, "anomaly_traces")
        if not self.trace_profiler.arm(
                self.global_steps, tl.anomaly_trace_capture_steps,
                trace_dir=trace_dir, reason=reason):
            return
        self.telemetry.emit(
            "anomaly", step=self.global_steps, reason=reason,
            capture_steps=tl.anomaly_trace_capture_steps,
            trace_dir=self.trace_profiler.trace_dir)

    # ------------------------------------------------------------------
    # resilience: preemption, guards, the hot tier and the restore ladder
    # (JAX ``engine.py:1235-1290, 2725-2760, 3274-3360``)
    # ------------------------------------------------------------------
    def _check_preemption(self):
        """The step-boundary preemption point (the top of
        :meth:`train_batch`). The fault harness delivers a real SIGTERM
        to this process, so the production signal path is what runs;
        the handler only latches a flag, and the save and the raise
        happen here, where the engine's state is consistent."""
        if self._fault_on and \
                fault_injection.preemption_due(self.global_steps):
            if self._preemption is not None:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                # no handler (save_on_sigterm off): preempt directly
                # rather than let the default SIGTERM kill the process
                self._preempt_now()
        if self._preemption is not None and self._preemption.preempted:
            self._preempt_now()

    def _preempt_now(self):
        rz = self._config.resilience
        path = None
        if rz.save_dir:
            tag = f"global_step{self.global_steps}"
            self.save_checkpoint(rz.save_dir, tag=tag)
            self._ckpt_manager.wait()   # the exit must not race the write
            path = self._ckpt_manager.ckpt_path(rz.save_dir, tag)
        if self.telemetry is not None:
            self.telemetry.emit("preemption", step=self.global_steps,
                                path=str(path) if path else None)
        raise PreemptedError(
            f"preempted at step {self.global_steps}" +
            (f"; checkpoint saved to {path}" if path
             else "; no resilience.save_dir configured — nothing saved"),
            checkpoint_path=path)

    def _after_step_resilience(self, metrics):
        """After a step: the guards (one host read of the loss, the
        finiteness verdict and the scale), their actions, the hot
        snapshot and the periodic disk save."""
        rz = self._config.resilience
        if self._health_monitor is not None:
            fp16_dyn = self._config.fp16_enabled and self.dynamic_loss_scale
            trips = self._health_monitor.observe(
                step=self.global_steps - 1, loss=float(metrics["loss"]),
                grad_nonfinite=bool(metrics["grad_nonfinite"]),
                cur_scale=float(metrics["loss_scale"]) if fp16_dyn
                else None)
            metrics = dict(metrics)
            metrics.update(self._health_monitor.metrics())
            for trip in trips:
                if self.telemetry is not None:
                    # before the action: a rollback or an abort must not
                    # keep the trip off the record
                    self.telemetry.emit("health_guard", **trip.as_event())
                    self._arm_anomaly_trace(f"health_guard:{trip.guard}")
                self._apply_guard_trip(trip)
        if self._hot_store is not None and \
                self.global_steps % rz.hot_interval_steps == 0:
            self._hot_snapshot()
        if rz.save_interval_steps and rz.save_dir and \
                self.global_steps % rz.save_interval_steps == 0:
            self.save_checkpoint(rz.save_dir)
        return metrics

    def _apply_guard_trip(self, trip):
        """One trip's action: ``warn`` and ``skip_step`` need nothing
        here (logged; skipped on the device); ``rollback_to_checkpoint``
        goes down the restore ladder and aborts when nothing is there;
        ``abort`` raises :class:`HealthGuardAbort`, after dumping the
        flight record (JAX ``engine.py:1299-1316``)."""
        if trip.action == ACTION_ROLLBACK:
            path = self._restore_ladder()
            if path is None:
                self._dump_flight(f"guard_abort:{trip.guard}",
                                  extra={"guard_trip": trip.as_event()})
                raise HealthGuardAbort(trip)
            log_dist(f"health guard '{trip.guard}' rolled back to {path} "
                     f"(step {self.global_steps})", ranks=[0])
        elif trip.action == ACTION_ABORT:
            self._dump_flight(f"guard_abort:{trip.guard}",
                              extra={"guard_trip": trip.as_event()})
            raise HealthGuardAbort(trip)

    def _hot_snapshot(self):
        """One hot snapshot: the checkpoint tree copied to host RAM (the
        CRC stamp and the mirror write on the store's worker)."""
        t0 = time.perf_counter()
        tag = f"step{self.global_steps}"
        snap = self._hot_store.snapshot(tag, self._checkpoint_state_tree(),
                                        self._checkpoint_meta(None),
                                        topology=self._topology())
        self.last_hot_snapshot = {
            "tag": tag, "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": snap.nbytes}
        if self.telemetry is not None:
            self.telemetry.emit(
                "hot_snapshot", step=self.global_steps, tag=tag,
                mirrored=bool(self._hot_store.mirror_dir),
                duration_s=round(time.perf_counter() - t0, 6))

    def _install_hot_restore(self, got, tier):
        """Install a hot ``(state, meta, topology)``; False when its
        topology is not this engine's (a restart on another mesh falls
        through to the disk tier, whose whole leaves load anywhere)."""
        state, meta, topology = got

        def plain(topo):
            return json.loads(json.dumps(topo))

        here = plain(self._topology())
        if plain(topology) != here:
            logger.warning("hot restore (%s): snapshot topology %s is not "
                           "this engine's %s; falling through", tier,
                           topology, here)
            return False
        self._install_restored_state(state, meta, True, True)
        return True

    def _restore_ladder(self):
        """Restore the newest state down the ladder: the hot RAM tier,
        the hot mirror, the newest valid disk checkpoint (``resolve_tag``
        scans past a torn newest one). Returns what served it ("<hot_
        ram>", "<hot_mirror:dir>" or the checkpoint path), or None when
        nothing is loadable; :attr:`last_recovery` holds the rung and its
        time."""
        rz = self._config.resilience
        t0 = time.perf_counter()

        def served(tier, source):
            self.last_recovery = {"tier": tier, "source": str(source),
                                  "ms": (time.perf_counter() - t0) * 1e3}
            if getattr(self, "telemetry", None) is not None:
                self.telemetry.emit(
                    "recovery_ladder", tier=tier, source=str(source),
                    step=self.global_steps,
                    duration_s=round(time.perf_counter() - t0, 6),
                    error=None)
            return source

        if self._hot_store is not None:
            try:
                got = self._hot_store.restore()
            except HotCheckpointCorruptError as e:
                logger.warning("hot RAM restore rejected: %s", e)
                got = None
            if got is not None and self._install_hot_restore(got,
                                                             "hot_ram"):
                return served("hot_ram", "<hot_ram>")
            if rz.hot_mirror_dir and os.path.isdir(rz.hot_mirror_dir):
                try:
                    got = HotCheckpointStore.load_mirror(
                        rz.hot_mirror_dir, self._checkpoint_state_tree())
                except HotCheckpointCorruptError as e:
                    logger.warning("hot mirror restore rejected: %s", e)
                    got = None
                if got is not None and self._install_hot_restore(
                        got, "hot_mirror"):
                    return served("hot_mirror",
                                  f"<hot_mirror:{rz.hot_mirror_dir}>")
        if not rz.save_dir or \
                self._ckpt_manager.resolve_tag(rz.save_dir, None) is None:
            return None
        path, _ = self.load_checkpoint(rz.save_dir)
        return None if path is None else served("disk", path)

    # ------------------------------------------------------------------
    # configuration accessors
    # ------------------------------------------------------------------
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bf16_enabled

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def steps_per_print(self):
        return self._config.steps_per_print

    @property
    def config(self):
        return self._config

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def zero_optimization(self):
        return self._config.zero_enabled

    @property
    def zero3_plan(self):
        """The stage-3 :class:`~deepspeed_tpu_torch.runtime.zero.stage3.
        Zero3Plan`, or None below stage 3."""
        inst = self._installer
        return inst.plan if inst is not None else None

    @property
    def loss_scale(self):
        if self.dynamic_loss_scale:
            return float(self.device_state.loss_scale.cur_scale)
        return self.static_loss_scale

    @property
    def skipped_steps(self):
        return int(self.device_state.skipped_steps)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _configure_optimizer(self, client_optimizer=None):
        """The optimizer (``engine.py:746-865``): a client object, else
        Adam / AdamW or LAMB from the config. ``self._opt_kind`` is
        "adam" (K4), "lamb" or "client" (the object's functional
        ``update``)."""
        self.client_optimizer = None
        if client_optimizer is not None and \
                not isinstance(client_optimizer, str):
            name = type(client_optimizer).__name__.lower()
            opt = client_optimizer
            self.client_optimizer = opt
            self.optimizer_name = name
            self._base_lr = getattr(opt, "lr", 1e-3)
            self._betas = tuple(getattr(opt, "betas", (0.9, 0.999)))
            self._eps = getattr(opt, "eps", 1e-8)
            self._weight_decay = getattr(opt, "weight_decay", 0.0)
            self._bias_correction = getattr(opt, "bias_correction", True)
            if name == ONEBIT_ADAM_OPTIMIZER:
                self._configure_onebit(opt)
            elif isinstance(opt, FusedAdam):
                self._opt_kind = "adam"
                self._adam_w_mode = opt.adam_w_mode
            elif isinstance(opt, FusedLamb):
                self._opt_kind = "lamb"
                self._lamb_coeffs = (opt.max_coeff, opt.min_coeff)
            else:
                self._opt_kind = "client"
            return
        name = (self._config.optimizer_name or ADAM_OPTIMIZER).lower()
        opt = dict(self._config.optimizer_params or {})
        self._base_lr = opt.pop("lr", 1e-3)
        self._betas = tuple(opt.pop("betas", (0.9, 0.999)))
        self._eps = opt.pop("eps", 1e-8)
        self._weight_decay = opt.pop("weight_decay", 0.0)
        self._bias_correction = opt.pop("bias_correction", True)
        self.optimizer_name = name
        if name == ONEBIT_ADAM_OPTIMIZER:
            self._configure_onebit(OnebitAdam(
                lr=self._base_lr, freeze_step=opt.pop("freeze_step", 100000),
                betas=self._betas, eps=self._eps,
                weight_decay=self._weight_decay,
                amsgrad=opt.pop("amsgrad", False)))
            return
        if name == LAMB_OPTIMIZER:
            self._opt_kind = "lamb"
            self._lamb_coeffs = (opt.pop("max_coeff", 10.0),
                                 opt.pop("min_coeff", 0.01))
            return
        if name not in (ADAM_OPTIMIZER, "adamw"):
            raise ValueError(f"unknown optimizer {name!r}; supported: adam, "
                             f"adamw, lamb, onebitadam")
        self._opt_kind = "adam"
        self._adam_w_mode = opt.pop("adam_w_mode", name == "adamw")
        # "pallas" is accepted for config compatibility and chooses
        # nothing: every step runs K4, whose wrapper runs its plain
        # version on CPU tensors
        opt.pop("pallas", None)

    def _configure_onebit(self, opt):
        """1-bit Adam (JAX ``engine.py:753-819``): the fp16 optimizer
        path of the reference, so ZeRO stage 0 only, over pure data
        parallelism; ``opt`` (a client :class:`OnebitAdam`, or one built
        from the config) supplies the hyperparameters and ``freeze_step``.
        A pipeline's stage engines take its buffers apart
        (``runtime/pipe/engine.py``)."""
        stage = self._config.zero_optimization_stage \
            if self._config.zero_enabled else 0
        assert stage == 0, ("OneBitAdam is not compatible with ZeRO "
                            "(reference scope: fp16 optimizer path only)")
        self._opt_kind = "onebit"
        self._onebit = opt
        self._base_lr = opt.lr
        self._betas = tuple(opt.betas)
        self._eps = opt.eps
        self._weight_decay = opt.weight_decay

    def _check_pure_data(self, what):
        """JAX's check of the compressors' steps (``engine.py:1352,
        2057``): every mesh axis but ``data`` of size 1 (``initialize``
        sends a ``pipe`` axis to the pipeline, which checks its stage
        engines itself)."""
        for ax, of in (("model", mesh.model_axis_of),
                       ("expert", mesh.expert_axis_of),
                       ("seq", mesh.seq_axis_of)):
            size = of(self.mpu).size
            assert size == 1, (f"{what} supports pure data parallelism; "
                               f"mesh axis {ax!r} has size {size}")

    def _init_opt_state(self, masters):
        if self._opt_kind == "adam":
            return init_adam_state(masters)
        if self._opt_kind == "lamb":
            return init_lamb_state(masters)
        if self._opt_kind == "onebit":
            return init_onebit_state(masters, self.dp_world_size)
        return self.client_optimizer.init(masters)

    def _configure_training_features(self, model):
        """Progressive layer drop, fp8 and sparse gradients: their
        checks and state (``engine.py:529-532``; the fp8 state is
        allocated on the first step)."""
        cfg = self._config
        self.progressive_layer_drop = None
        if cfg.pld_enabled:
            self.progressive_layer_drop = ProgressiveLayerDrop(
                **(cfg.pld_params or {}))
        self._fp8_plan = cfg.fp8.plan()
        self._fp8_wire = cfg.fp8.active_wire_dtype()
        self._fp8_keys = None
        self._fp8_flat = self._fp8_state = None
        self._fp8_new = self._fp8_micro = None
        self._sparse = bool(cfg.sparse_gradients_enabled)
        self._sparse_warned = False
        self._sparse_leaf_flags = None
        if self._sparse:
            # (ZeRO-Offload needs a stage >= 1, so this covers it too)
            assert not cfg.zero_enabled, (
                "sparse_gradients is incompatible with ZeRO (the "
                "reference's CSR path is the non-ZeRO allreduce "
                "fallback, engine.py:1127)")

    def _configure_compressors(self, comm_given):
        """The gradient compressors' checks (JAX ``engine.py:1352-1360,
        2057-2061``): ``comm_quantization`` (:attr:`_qcomm`) and 1-bit
        Adam run over pure data parallelism; a pipeline's stage engines
        (``comm`` given) are checked by the pipeline."""
        cq = self._config.comm_quantization
        self._qcomm = cq if cq.enabled else None
        self._qcomm_res = None
        if self._opt_kind == "onebit":
            self._sparse = False        # 1-bit Adam's exchange wins
        if comm_given is not None:
            return
        if self._opt_kind == "onebit":
            self._check_pure_data("OneBitAdam")
        if self._qcomm is not None:
            self._check_pure_data("comm_quantization")

    def _pld_theta(self, step):
        """Progressive layer drop's theta at step ``step`` in fp32 (the
        JAX step's ``theta_fn``), or None when PLD is off."""
        pld = self.progressive_layer_drop
        if pld is None:
            return None
        f32 = np.float32
        theta_bar = f32(pld.theta)
        return float((f32(1.0) - theta_bar) *
                     np.exp(f32(-pld.gamma) * f32(step)) + theta_bar)

    def _configure_lr_scheduler(self, client_scheduler):
        """Schedule resolution (``engine.py:867``): host functions of the
        optimizer-step counter."""
        self.lr_scheduler = client_scheduler
        if client_scheduler is None and \
                self._config.scheduler_name is not None:
            self.lr_scheduler = get_lr_scheduler(
                self._config.scheduler_name,
                self._config.scheduler_params or {})
        sched = self.lr_scheduler
        if sched is not None and hasattr(sched, "lr_at"):
            self._lr_fn = sched.lr_at
        elif sched is not None and hasattr(sched, "get_lr"):
            def lr_fn(step):
                lrs = sched.get_lr()
                return float(lrs[0] if isinstance(lrs, (list, tuple))
                             else lrs)
            self._lr_fn = lr_fn
        else:
            base = float(self._base_lr)
            self._lr_fn = lambda step: base
        if isinstance(sched, OneCycle) and sched.cycle_momentum:
            self._mom_fn = sched.mom_at
        else:
            beta1 = float(self._betas[0])
            self._mom_fn = lambda step: beta1

    def _configure_dense(self, model):
        """The fp32 masters, gradients and Adam moments of the dense path
        at the ZeRO stage (the module docstring), and the installer of
        the compute-dtype params."""
        dev, stage = self.device, self._stage
        world, rank = self.dp_world_size, self.dp_rank
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f"master params must be fp32, got "
                                 f"{p.dtype}")
        installs = stage == 3 or self.compute_dtype != torch.float32
        owners = self._owners(model) if stage >= 1 or installs else None
        self._parts = [Partition.of(p.shape, world, rank,
                                    is_transposed(*owners[i][:2]))
                       for i, p in enumerate(self.params)] \
            if stage >= 1 else None
        # a replicated leaf counts in the norm on rank 0 only
        self._counted = [part.sharded or rank == 0
                         for part in self._parts] if stage >= 1 else None
        with torch.no_grad():
            if stage == 3:
                pieces = [part.piece(p).to(dev) for p, part in
                          zip(self.params, self._parts)]
                for p in self.params:
                    p.data = torch.empty(0, dtype=p.dtype, device=dev)
                model.to(dev)           # buffers; the params are pieces
                for pc in pieces:
                    pc.requires_grad_(True)
                    pc.grad = torch.zeros_like(pc)
                self._pieces = pieces
                self._masters = [pc.detach() for pc in pieces]
                self._grads = [pc.grad for pc in pieces]
            else:
                model.to(dev)
                for p in self.params:
                    if p.device != dev:
                        raise ValueError(f"master params must be on {dev}, "
                                         f"got {p.device}")
                    if (stage != 2 or self._qcomm is not None) and \
                            p.grad is None:
                        p.grad = torch.zeros_like(p)
                if stage == 0:
                    self._masters = [p.data for p in self.params]
                    self._grads = [p.grad for p in self.params]
                else:
                    self._masters = [part.piece(p) for p, part in
                                     zip(self.params, self._parts)]
                    # stage 1: the reduce-scatter's output (a replicated
                    # leaf's all-reduced gradient is its .grad); stage 2:
                    # the sharded accumulator
                    self._grads = [
                        p.grad if stage == 1 and not part.sharded else
                        torch.zeros(part.piece_shape, dtype=torch.float32,
                                    device=dev)
                        for p, part in zip(self.params, self._parts)]
                if stage == 2 and self._qcomm is None:
                    # (the quantized exchange needs the whole local
                    # gradient: stage 2 then accumulates as stage 1)
                    for i, p in enumerate(self.params):
                        p.grad = None
                        p.register_post_accumulate_grad_hook(
                            self._stage2_hook(i))
        self.opt_state = self._init_opt_state(self._masters)
        if self._qcomm is not None and self._qcomm.error_feedback:
            self._qcomm_res = init_residuals(
                [p.numel() for p in self.params], world,
                self._qcomm_bucket_bytes(), int(self._qcomm.chunk_size),
                device=dev)
        zc = self._config.zero_config
        if installs:
            masters = self._pieces if stage == 3 else self.params
            self._installer = ParamInstaller(
                model, [(owners[i][0], owners[i][1], p, masters[i],
                         self._parts[i] if self._parts else None,
                         owners[i][2])
                        for i, p in enumerate(self.params)],
                self.compute_dtype, self.comm, gather=stage == 3,
                prefetch=bool(zc.prefetch),
                gather_chunks=int(zc.gather_chunks),
                bidirectional=bool(zc.bidirectional),
                wire_dtype=self._fp8_wire,
                wire_chunk=int(self._config.fp8.wire_chunk_size))

    def _owners(self, model):
        """``(module, name, unit)`` owning each trained param: ``unit``
        is the module whose call installs it (the module itself, or the
        outermost enclosing one marked ``install_as_one``, e.g. a
        ``scan_layers`` stack)."""
        index = {id(p): i for i, p in enumerate(self.params)}
        mods = dict(model.named_modules())

        def unit(path, module):
            parts = path.split(".") if path else []
            for k in range(len(parts) + 1):
                m = mods[".".join(parts[:k])]
                if getattr(m, "install_as_one", False):
                    return m
            return module

        owners = {}
        for path, module in mods.items():
            for name, p in module._parameters.items():
                i = index.get(id(p)) if p is not None else None
                if i is None:
                    continue
                if i in owners:
                    raise ValueError(
                        f"param {name!r} is registered in two modules: "
                        f"the engine installs each param in one place")
                owners[i] = (module, name, unit(path, module))
        if len(owners) != len(self.params):
            raise ValueError("every trained param must belong to the model")
        return owners

    def _stage2_hook(self, i):
        """Stage 2: leaf ``i``'s micro-batch gradient, reduce-scattered
        into the sharded accumulator as soon as the backward has made it,
        then dropped. The hook lives on the param (held by C++, out of
        the garbage collector's reach), so it holds the engine weakly:
        else a dropped engine would keep its buffers alive."""
        engine = weakref.ref(self)

        def hook(p):
            self = engine()
            if self is None:
                return
            part, acc = self._parts[i], self._grads[i]
            with torch.no_grad():
                g = p.grad
                if part.sharded:
                    out = torch.empty_like(acc)
                    self.comm.reduce_scatter(out, part.rank_major(g))
                    acc.add_(out)
                else:
                    acc.add_(self.comm.all_reduce(g))
            p.grad = None

        return hook

    def _loss(self, batch, seed, pld_theta=None):
        """``loss_fn`` with the compute-dtype params in the model, over
        this rank's rows of a global batch: rank r's ``n`` rows are the
        global rows ``[r*n, (r+1)*n)`` (JAX ``_shard_batch`` and
        ``_place_rows`` assemble each micro-batch from the processes'
        rows in rank order), and the models draw those rows' dropout
        masks (``global_rows``). Under fp8 the forward runs in the
        step's fp8 scope; ``pld_theta`` goes to ``loss_fn`` when PLD is
        on."""
        rows = next(iter(batch.values())).shape[0]
        install = self._installer.forward() if self._installer is not None \
            else contextlib.nullcontext()
        scope = contextlib.nullcontext()
        if self._fp8_new is not None:
            micro = None
            if torch.is_grad_enabled():
                self._fp8_micro = torch.zeros_like(self._fp8_new)
                micro = fp8_ops.unflatten_state(self._fp8_micro,
                                                self._fp8_keys)
            scope = fp8_ops.fp8_scope(self._fp8_plan, self._fp8_state,
                                      micro)
        kw = {} if pld_theta is None else {"pld_theta": pld_theta}
        with global_rows(self.dp_rank * rows, self.dp_rank), install, \
                scope:
            return self.loss_fn(batch, seed, **kw)

    # -- fp8 state (JAX ``_ensure_fp8_state``, ``engine.py:1162``) ----------
    def _fp8_begin_step(self, micro):
        """Allocate the state on first use (a discovery forward records
        the sites' keys in call order; zero histories give scale 1), and
        this step's zeroed updates: each micro-batch's forward and
        backward add their histories into a zeroed buffer of their own
        (``_fp8_micro``), folded into the step's by elementwise max after
        its backward (JAX's accumulation)."""
        if self._fp8_plan is None:
            return
        plan = self._fp8_plan
        if self._fp8_keys is None:
            keys = []
            with torch.no_grad(), \
                    fp8_ops.fp8_scope(plan, discover=keys):
                self._loss(micro, None)
            self._fp8_keys = keys
            self._fp8_flat = torch.zeros(
                len(keys), 3, int(plan.amax_history_len),
                dtype=torch.float32, device=self.device)
            self._fp8_state = fp8_ops.unflatten_state(self._fp8_flat, keys)
            log_dist(f"fp8: delayed scaling active over {len(keys)} dot "
                     f"site(s)", ranks=[0])
        if self._fp8_new is None:
            self._fp8_new = torch.zeros_like(self._fp8_flat)

    def _fp8_end_step(self, overflow):
        """The step's histories: the global batch's (MAX over the data
        group), or the old ones after an fp16 overflow."""
        if self._fp8_new is None:
            return
        new = self._fp8_new
        if self.comm.active:
            self.comm.all_reduce(new, op="max", stat=True)
        self._split_reduce(new, op="max")
        if self._config.fp16_enabled:
            new = torch.where(overflow, self._fp8_flat, new)
        self._fp8_flat = new
        self._fp8_state = fp8_ops.unflatten_state(new, self._fp8_keys)
        self._fp8_new = None

    @property
    def fp8_state(self):
        """``{"<site>:<idx>": {"in", "kernel", "out"}}`` amax histories
        (None before the first fp8 step)."""
        return self._fp8_state

    def _backward(self, loss, scale):
        scope = self._installer.backward() if self._installer is not None \
            else contextlib.nullcontext()
        with scope:
            (loss * scale).backward()
        if self._fp8_micro is not None:
            torch.maximum(self._fp8_new, self._fp8_micro, out=self._fp8_new)
            self._fp8_micro = None

    def _configure_offload(self, model):
        """ZeRO-Offload setup (JAX ``engine.py:457-506``): the host Adam
        takes the fp32 masters from the params where they are (the
        caller's host model), and the device receives only their
        compute-dtype copy, as views of one flat buffer."""
        from deepspeed_tpu_torch.ops.adam.cpu_adam import (
            RANGE_ALIGN, DeepSpeedCPUAdam)
        if self.optimizer_name not in (ADAM_OPTIMIZER, "adamw"):
            raise AssertionError(
                f"cpu_offload supports adam/adamw, got {self.optimizer_name}")
        chunk_mb = self._config.zero_config.offload_chunk_mb
        if not chunk_mb or float(chunk_mb) <= 0:
            raise ValueError(
                f"offload_chunk_mb must be a positive number of MB, "
                f"got {chunk_mb!r}")
        # fractional MB allowed; floor at 64 KB so a tiny value cannot
        # degenerate into one worker submission per element
        self._offload_chunk_bytes = max(
            64 << 10, int(float(chunk_mb) * (1 << 20)))
        dev = self.device
        bf16 = self.compute_dtype == torch.bfloat16
        # bf16 only: it shares fp32's exponent range, so casting the
        # unscaled gradient is safe; fp16 would flush small components
        self._grads_16bit = bool(self._config.zero_config.offload_16bit_grads
                                 and bf16)
        self.cpu_optimizer = DeepSpeedCPUAdam(
            self.params, lr=self._base_lr, betas=self._betas, eps=self._eps,
            weight_decay=self._weight_decay,
            bias_correction=self._bias_correction,
            adamw_mode=self._adam_w_mode, pin_memory=dev.type == "cuda",
            landing_dtype=torch.bfloat16 if self._grads_16bit else None,
            bf16_copy_back=bf16)
        opt = self.cpu_optimizer
        # across processes (JAX engine.py:501): the flat buffer as
        # `world` rows of `chunk` elements (a SIMD-aligned row length, so
        # each rank's Adam range starts on a RANGE_ALIGN boundary); rank
        # r updates [r*chunk, r*chunk + n) of the host master
        world = self.dp_world_size
        self._offload_dp = world > 1
        chunk = -(-opt.total // world)
        chunk = -(-chunk // RANGE_ALIGN) * RANGE_ALIGN
        padded = chunk * world if self._offload_dp else opt.total
        self._off_chunk = chunk
        self._off_lo = self.dp_rank * chunk
        self._off_n = max(0, min(chunk, opt.total - self._off_lo))
        self._dev_flat = torch.zeros(padded, dtype=self.compute_dtype,
                                     device=dev)
        with torch.no_grad():
            for p, off, size, shape in zip(self.params, opt.offsets,
                                           opt.sizes, opt.shapes):
                p.data = self._dev_flat[off:off + size].view(shape)
                p.grad = None
        model.to(dev)        # buffers; the params are on the device now
        self._grad32 = torch.zeros(padded, dtype=torch.float32, device=dev)
        if self._offload_dp:
            self._grad_row = torch.zeros(chunk, dtype=torch.float32,
                                         device=dev)
            self._row16 = torch.zeros(chunk, dtype=self.compute_dtype,
                                      device=dev)
        self._grad32_views = [self._grad32[off:off + size].view(shape)
                              for off, size, shape in
                              zip(opt.offsets, opt.sizes, opt.shapes)]
        self._wire = torch.empty(opt.total, dtype=torch.bfloat16,
                                 device=dev) if self._grads_16bit else None
        self._upload_stream = torch.cuda.Stream(dev) \
            if dev.type == "cuda" else None
        self._upload_done = None
        self._upload_spans = []
        self.last_host_phase_s = 0.0
        self._upload_offload_params()

    def _fold_grads(self):
        """Add the micro-batch's compute-dtype gradients into the fp32
        accumulator and drop them (JAX's fp32 scan carry)."""
        with torch.no_grad():
            grads = [p.grad for p in self.params]
            torch._foreach_add_(self._grad32_views, grads)
            for p in self.params:
                p.grad = None

    def fold_on_accumulate(self):
        """Fold each param's compute-dtype gradient into the fp32
        accumulator as soon as a backward has accumulated it (offload
        only): the pipeline's stages run their micro-batches' backwards
        interleaved, with no point between them where
        :meth:`_fold_grads` could run, and a backward accumulates each
        leaf once (a tied leaf's uses summed first), so folding there is
        the fold after each micro-batch. The hook holds the engine
        weakly, as :meth:`_stage2_hook` does."""
        engine = weakref.ref(self)

        def hook_of(i):
            def hook(p):
                self = engine()
                if self is None:
                    return
                with torch.no_grad():
                    self._grad32_views[i].add_(p.grad)
                p.grad = None
            return hook

        for i, p in enumerate(self.params):
            p.register_post_accumulate_grad_hook(hook_of(i))

    def _wait_for_params(self):
        """Order the device's next use of the params after the last
        upload."""
        if self._offload and self._upload_done is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._upload_done)

    def _upload(self, lo, hi, src):
        """Copy flat ``src[lo:hi]`` into the device params (on the upload
        stream on CUDA, timed by an event pair)."""
        if self._upload_stream is None:
            self._dev_flat[lo:hi].copy_(src[lo:hi])
            return
        with torch.cuda.stream(self._upload_stream):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self._dev_flat[lo:hi].copy_(src[lo:hi], non_blocking=True)
            end.record()
        self._upload_spans.append((start, end, (hi - lo) *
                                   self._dev_flat.element_size()))

    def _begin_uploads(self):
        if self._upload_done is not None:
            # the copy-back buffer is rewritten only after the last
            # step's uploads have read it
            self._upload_done.synchronize()
        self._upload_spans = []
        if self._upload_stream is not None:
            self._upload_stream.wait_stream(
                torch.cuda.current_stream(self.device))

    def _end_uploads(self):
        if self._upload_stream is not None:
            self._upload_done = torch.cuda.Event()
            self._upload_done.record(self._upload_stream)

    @torch.no_grad()
    def _upload_offload_params(self):
        """The device params from the host masters (init and load; JAX
        ``engine.py:1524``): the C++ bf16 convert under bf16, a cast of
        the masters otherwise."""
        opt = self.cpu_optimizer
        self._begin_uploads()
        src = opt.params_bf16_flat() \
            if self.compute_dtype == torch.bfloat16 else opt.master
        self._upload(0, opt.total, src)
        self._end_uploads()

    @torch.no_grad()
    def _host_phase(self, lr, beta1):
        """The offload step's host half (JAX ``engine.py:1622``): the
        gradient to host RAM, the C++ Adam on the masters, the params
        back, pipelined by chunk."""
        t0 = time.perf_counter()
        opt = self.cpu_optimizer
        wire = self._wire if self._grads_16bit else self._grad32
        self._begin_uploads()
        if self.compute_dtype == torch.bfloat16:
            def upload_chunk(li, lj):
                self._upload(opt.offsets[li], opt.offsets[lj],
                             opt._bf16_buf)

            opt.step_overlapped(wire, lr=lr, beta1=beta1, bf16_out=True,
                                chunk_bytes=self._offload_chunk_bytes,
                                on_chunk=upload_chunk)
        else:
            opt.step_overlapped(wire, lr=lr, beta1=beta1,
                                chunk_bytes=self._offload_chunk_bytes)
            self._upload(0, opt.total, opt.master)
        self._end_uploads()
        self.last_host_phase_s = time.perf_counter() - t0

    @torch.no_grad()
    def _host_phase_dp(self, lr, beta1):
        """The offload step's host half across processes (JAX
        ``_train_batch_offload_dp``): the rank's gradient row to host
        RAM, the C++ Adam (and bf16 convert) on the row's range of the
        master, the updated row back to the device, and every rank's row
        all-gathered into the device params."""
        t0 = time.perf_counter()
        opt = self.cpu_optimizer
        lo, n = self._off_lo, self._off_n
        opt._step += 1
        opt.last_adam_s = opt.last_convert_s = 0.0
        bf16 = self.compute_dtype == torch.bfloat16
        if n:
            row = self._grad_row[:n]
            if self._grads_16bit:       # the 16-bit wire, widened on host
                row = row.to(torch.bfloat16)
            opt._grad_buf[lo:lo + n].copy_(row)
            opt._update_range(opt._step, lr, beta1, lo, n, bf16)
            src = opt._bf16_buf if bf16 else opt.master
            self._row16[:n].copy_(src[lo:lo + n])
        self.comm.all_gather(self._dev_flat, self._row16)
        self.last_host_phase_s = time.perf_counter() - t0

    @torch.no_grad()
    def _offload_sync_host_state(self):
        """Every rank's host master and moments made whole (each rank
        updates only its row's range): an fp32 all-gather of the rows
        through the device (JAX ``engine.py:1828``)."""
        opt = self.cpu_optimizer
        lo, n, chunk = self._off_lo, self._off_n, self._off_chunk
        row = torch.zeros(chunk, dtype=torch.float32, device=self.device)
        whole = torch.empty(chunk * self.dp_world_size,
                            dtype=torch.float32, device=self.device)
        for buf in (opt.master, opt.exp_avg, opt.exp_avg_sq):
            row.zero_()
            row[:n].copy_(buf[lo:lo + n])
            self.comm.all_gather(whole, row)
            buf.copy_(whole[:opt.total])

    def host_phase_stats(self):
        """The last host phase: its wall, the C++ Adam's and the bf16
        convert's seconds (summed over chunks), and on CUDA the D2H and
        H2D device seconds and bytes (the copies' event spans, summed).
        Reading the events waits for the uploads."""
        opt = self.cpu_optimizer
        out = {"host_phase_s": self.last_host_phase_s,
               "adam_s": opt.last_adam_s, "convert_s": opt.last_convert_s}
        if self._upload_stream is not None:
            self._upload_done.synchronize()
            out["h2d_s"] = sum(a.elapsed_time(b) for a, b, _ in
                               self._upload_spans) / 1e3
            out["h2d_bytes"] = sum(n for _, _, n in self._upload_spans)
            out["d2h_s"], out["d2h_bytes"] = opt.last_d2h
        return out

    def _scale_args(self):
        args = dict(scale_factor=2.0, scale_window=1000, min_scale=1.0,
                    delayed_shift=1, consecutive_hysteresis=False)
        a = self._config.dynamic_loss_scale_args
        if a:
            args.update(scale_window=a.get("scale_window", 1000),
                        min_scale=a.get("min_scale", 1.0),
                        delayed_shift=a.get("delayed_shift", 1))
        return args

    def _init_device_state(self):
        init_scale = float(self._config.initial_dynamic_scale) \
            if self.dynamic_loss_scale else self.static_loss_scale
        a = self._config.dynamic_loss_scale_args or {}
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return DeviceState(
            loss_scale=init_loss_scale_state(
                init_scale, a.get("delayed_shift", 1), device=self.device),
            global_step=zero, skipped_steps=zero, consecutive_skipped=zero)

    # ------------------------------------------------------------------
    # the train step
    # ------------------------------------------------------------------
    def _scale(self):
        if self._config.fp16_enabled and self.dynamic_loss_scale:
            return self.device_state.loss_scale.cur_scale
        return self.static_loss_scale

    def _to_device(self, batch):
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device)
                for k, v in batch.items()}

    def _micro_batches(self, batch):
        """This process's rows as ``accum`` micro-batches (JAX
        ``_shard_batch``): rank r's micro-batch k holds global micro-batch
        k's rows ``[r*m, (r+1)*m)``."""
        accum = self._config.gradient_accumulation_steps
        n_proc = self.dp_world_size
        expected = self._config.train_batch_size // n_proc
        placed = self._to_device(batch)
        for name, x in placed.items():
            if x.shape[0] != expected:
                raise ValueError(
                    f"train_batch expects {expected} rows per process "
                    f"(train_batch_size {self._config.train_batch_size} / "
                    f"{n_proc} processes), got {x.shape[0]} for {name!r}")
        micro = expected // accum
        return [{k: x[i * micro:(i + 1) * micro] for k, x in placed.items()}
                for i in range(accum)]

    def _step_seed(self, stream, counter):
        return fold_in_seed(fold_in_seed(self.seed, stream), counter)

    def _reduce_grads(self):
        """The step's fp32 gradients, summed over the ranks: stage 0
        all-reduces each leaf; stage 1 reduce-scatters each into the
        rank's piece; stages 2 and 3 already hold the pieces."""
        comm = self.comm
        if self._stage == 0:
            if comm.active:
                for g in self._grads:
                    comm.all_reduce(g)
        elif self._stage == 1:
            for p, part, g in zip(self.params, self._parts, self._grads):
                if part.sharded:
                    comm.reduce_scatter(g, part.rank_major(p.grad))
                else:
                    comm.all_reduce(g)
        return self._grads

    def _qcomm_bucket_bytes(self):
        return int(self._qcomm.bucket_mb) * 1024 * 1024

    def _reduce_grads_quantized(self, scale, accum):
        """The step's gradients through the int8 exchange (JAX
        ``_make_quantized_train_step``, ``engine.py:1345-1520``): each
        rank's accumulated gradient is unscaled *before* the exchange
        (absmax scales of finite values; residuals that do not depend
        on the loss scale); under fp16 the overflow is voted (MAX) on the
        local gradients and an overflowed step ships zeros; then the
        bucketed :func:`~deepspeed_tpu_torch.runtime.comm.quantized.
        quantized_allreduce_tree` (residuals as engine state with
        ``error_feedback``). Stage 0 keeps the average, stages 1-2 the
        rank's piece of it. Returns the gradients and the vote."""
        local = [p.grad for p in self.params]
        denom = scale * accum
        for g in local:
            g.div_(denom)
        voted = torch.zeros((), dtype=torch.bool, device=self.device)
        if self._config.fp16_enabled:
            voted = self.comm.any_flag(check_overflow(local))
            for g in local:
                g.copy_(torch.where(voted, torch.zeros_like(g), g))
        avg, self._qcomm_res = quantized_allreduce_tree(
            local, self.comm.axis(), chunk_size=int(self._qcomm.chunk_size),
            bucket_bytes=self._qcomm_bucket_bytes(),
            residuals=self._qcomm_res)
        if self._stage == 0:
            for g, a in zip(self._grads, avg):
                g.copy_(a)
        else:
            for part, g, a in zip(self._parts, self._grads, avg):
                g.copy_(part.piece(a) if part.sharded else a)
        return self._grads, voted

    def _refresh_params(self):
        """Stages 1-2: the updated master pieces all-gathered into the
        replicated params (the one param-sized refresh gather)."""
        for p, part, m in zip(self.params, self._parts, self._masters):
            if not part.sharded:
                p.data.copy_(m)
            elif part.dim == 0:
                self.comm.all_gather(p.data.view(-1), m)
            else:
                flat = torch.empty(part.numel, dtype=m.dtype,
                                   device=m.device)
                self.comm.all_gather(flat, m)
                p.data.copy_(part.from_gathered(flat))

    def _sparse_flags(self):
        """Which leaves take the CSR path (JAX ``_sparse_grad_flags``,
        ``engine.py:1848``): 2-D leaves a component of whose name matches
        the embedding regex, or ``engine.sparse_grad_predicate(names,
        leaf)`` when set (``names`` the param name's components)."""
        pat = re.compile(
            r"embed|wte|wpe|vocab|token|lookup|(?:^|[._/])emb(?:[._/]|$)",
            re.I)
        pred = getattr(self, "sparse_grad_predicate", None) or (
            lambda names, leaf: leaf.ndim == 2 and
            any(pat.search(n) for n in names))
        names = self._param_names()
        flags = [bool(pred(n.split("."), p))
                 for n, p in zip(names, self.params)]
        if not any(flags):
            logger.warning(
                "sparse_gradients is enabled but the embedding predicate "
                "matched NO parameter leaves — every gradient will use the "
                "dense allreduce path. Set engine.sparse_grad_predicate to "
                "select your embedding tables (param path names: %s).",
                names[:16])
        return flags

    def _reduce_grads_sparse(self, tokens):
        """Stage 0 with sparse gradients (JAX
        ``_make_sparse_grad_train_step``): a flagged leaf with more rows
        than the rank's ``tokens`` is cut to its top-``tokens`` rows by L1
        mass and summed over the ranks as CSR (index/value all-gather,
        scatter-add), unless a MAX vote over the ranks finds the cut
        would drop mass (more than 1e-6 of the leaf's L1): then it takes
        the dense all-reduce, as every other leaf does. Returns the
        gradients and ``(dropped, fallbacks)``."""
        from deepspeed_tpu_torch.runtime.csr_tensor import (
            csr_allreduce, dense_to_csr)
        comm = self.comm
        grads = self._grads
        if self._sparse_leaf_flags is None:
            self._sparse_leaf_flags = self._sparse_flags()
        cands = [i for i, f in enumerate(self._sparse_leaf_flags)
                 if f and 0 < tokens < grads[i].shape[0]]
        dev = self.device
        dropped = torch.zeros((), dtype=torch.float32, device=dev)
        fallbacks = torch.zeros((), dtype=torch.int32, device=dev)
        dense = set(range(len(grads))) - set(cands)
        if cands:
            csrs = {i: dense_to_csr(grads[i], min(tokens, grads[i].shape[0]))
                    for i in cands}
            vote = torch.stack([torch.stack([
                (grads[i].abs().sum().float() -
                 csrs[i].values.abs().sum().float()),
                grads[i].abs().sum().float()]) for i in cands])
            if comm.active:
                comm.all_reduce(vote, op="max", stat=True)
            use_dense = vote[:, 0] > 1e-6 * vote[:, 1]
            dropped = torch.where(use_dense, vote[:, 0], 0.0).sum()
            fallbacks = use_dense.sum().to(torch.int32)
            for i, fall_back in zip(cands, use_dense.tolist()):
                if fall_back:
                    dense.add(i)
                    continue
                summed = csr_allreduce(csrs[i], comm, average=False)
                grads[i].zero_()
                grads[i].index_add_(0, summed.indices, summed.values)
        if comm.active:
            for i in sorted(dense):
                comm.all_reduce(grads[i])
        return grads, (dropped, fallbacks)

    def offload_leaf_views(self):
        """``(leaf indices, views)``: the offload gradient buffer cut into
        its leaves (this rank's row's part of each, across processes)."""
        opt = self.cpu_optimizer
        if not self._offload_dp:
            return list(range(len(self._grad32_views))), self._grad32_views
        lo, chunk = self._off_lo, self._off_chunk
        idx, views = [], []
        for i, (off, size) in enumerate(zip(opt.offsets, opt.sizes)):
            a, b = max(off, lo), min(off + size, lo + chunk)
            if a < b:
                idx.append(i)
                views.append(self._grad_row[a - lo:b - lo])
        return idx, views

    def _split_reduce(self, t, op="sum"):
        """``t`` summed (or maxed) over each split axis's group, in
        place."""
        for g in self._split_axes.values():
            t = tp_comm.all_reduce(t, g, op=op)
        return t

    def _leaf_counted(self, i):
        """Leaf ``i`` counts in norms on this rank: on every split axis
        it is split over that axis or this rank is the axis's rank 0 (a
        replicated copy counts once)."""
        spec = self._tp_specs[i]
        return all(g.rank == 0 or (spec is not None and spec.axis == a)
                   for a, g in self._split_axes.items())

    def _tp_counted(self, grads, counted):
        """``counted`` with the split axes (:meth:`_leaf_counted`;
        offload's leaf views are counted where they are cut, in
        :meth:`_apply_step`)."""
        if not self._split_axes or self._offload:
            return counted
        base = counted if counted is not None else [True] * len(grads)
        return [c and self._leaf_counted(i) for i, c in enumerate(base)]

    def _optimizer_step(self, grads, lr, beta1, overflow, sharded):
        """The update of the masters by the configured optimizer."""
        skip = overflow if self._config.fp16_enabled or self._nan_skip \
            else None
        if self._opt_kind == "adam":
            self.opt_state = fused_adam_update(
                self._masters, grads, self.opt_state,
                lr=lr, beta1=beta1, beta2=self._betas[1], eps=self._eps,
                weight_decay=self._weight_decay,
                adam_w_mode=self._adam_w_mode,
                bias_correction=self._bias_correction, skip=skip)
        elif self._opt_kind == "lamb":
            # each leaf's norms over its pieces: the data group's (ZeRO)
            # and the model group's (a split leaf; a replicated one
            # counted on model rank 0)
            data = sharded and self.comm.active
            reduce = None
            if data or self._split_axes:
                def reduce(t):
                    if data:
                        self.comm.all_reduce(t, stat=True)
                    return self._split_reduce(t)
            self.opt_state = lamb_step_(
                self._masters, grads, self.opt_state, lr=lr, beta1=beta1,
                beta2=self._betas[1], eps=self._eps,
                weight_decay=self._weight_decay,
                bias_correction=self._bias_correction,
                max_coeff=self._lamb_coeffs[0],
                min_coeff=self._lamb_coeffs[1], skip=skip, reduce=reduce,
                counted=self._tp_counted(
                    grads, self._counted if sharded else None))
        else:
            # a client object's functional update, or 1-bit Adam's over
            # the data group; an overflow keeps the old masters and state
            # (JAX's select)
            if self._opt_kind == "onebit":
                new_p, new_s = self._onebit.update(
                    self._masters, grads, self.opt_state, lr=lr,
                    beta1=beta1, group=self.comm.axis())
            else:
                new_p, new_s = self.client_optimizer.update(
                    self._masters, grads, self.opt_state, lr=lr,
                    beta1=beta1)
            for m, n in zip(self._masters, new_p):
                m.copy_(n if skip is None else torch.where(skip, m, n))
            if skip is not None:
                new_s = type(new_s)(*[
                    [torch.where(skip, o, n) for o, n in zip(old, new)]
                    if isinstance(old, (list, tuple)) else
                    torch.where(skip, old, new)
                    for old, new in zip(self.opt_state, new_s)])
            self.opt_state = new_s

    def _apply_step(self, loss_sum, accum, tokens=0):
        """Everything after the backward (:meth:`_step_math`), then the
        resilience and the log line. Returns the metrics dict."""
        metrics = self._after_step(self._step_math(loss_sum, accum, tokens))
        self._log_step(metrics)
        return metrics

    @torch.no_grad()
    def _step_math(self, loss_sum, accum, tokens=0):
        """Everything after the backward: the gradients' reduction, the
        epilogue, the optimizer, overflow skip, loss scale and counters.
        Returns the metrics dict. ``tokens``: this rank's integer batch
        elements (the sparse-gradient budget)."""
        fp16 = self._config.fp16_enabled
        clip = float(self._config.gradient_clipping or 0.0)
        scale = self._scale()
        comm = self.comm if self.comm.active else None
        offload_dp = self._offload and self._offload_dp
        epi = dict(comm=comm)
        # offload: one flat fp32 buffer (the epilogue's norm is then one
        # reduction, in another summation order than the per-leaf one);
        # across processes, the rank's row of it
        if self._offload:
            if offload_dp:
                self.comm.reduce_scatter(self._grad_row, self._grad32)
                grads = [self._grad_row]
            else:
                grads = [self._grad32]
            sharded, counted = offload_dp, None
            if self._split_axes:
                # leaf by leaf: a replicated leaf counts on rank 0 of
                # each split axis
                idx, grads = self.offload_leaf_views()
                counted = [self._leaf_counted(i) for i in idx]
        elif self._opt_kind == "onebit":
            # local gradients: the overflow voted by MAX, the norm the
            # ranks' mean, clipping by their max (JAX engine.py:2090-2101)
            grads, sharded, counted = self._grads, False, None
            epi = dict(comm=None)
            if comm is not None:
                def top(n):
                    y = n.reshape(1).clone()
                    return comm.all_reduce(y, "max", stat=True).reshape(())

                epi.update(vote=comm.any_flag, norm_reduce=comm.mean_scalar,
                           clip_norm_reduce=top)
        elif self._sparse:
            grads, sparse_stats = self._reduce_grads_sparse(tokens)
            sharded, counted = False, None
        elif self._qcomm is not None:
            # unscaled before the exchange: the epilogue's scale and
            # accumulation are 1, its vote ORs in the local one
            grads, voted = self._reduce_grads_quantized(scale, accum)
            sharded, counted = self._stage >= 1, self._counted
            epi = dict(comm=comm, average=False,
                       vote=lambda o: o | voted)
        else:
            grads = self._reduce_grads()
            sharded, counted = self._stage >= 1, self._counted
        counted = self._tp_counted(grads, counted)
        if self._fault_on:
            # the fault harness's gradient multiplier (NaN when armed)
            fault = fault_injection.grad_fault_value(self.global_steps)
            if fault != 1.0:
                torch._foreach_mul_(grads, fault)
        unscaled = self._qcomm is not None     # (config: not with 1-bit)
        overflow, nonfinite, grad_norm, applied_norm = grad_epilogue(
            grads, 1.0 if unscaled else scale, 1 if unscaled else accum,
            fp16, clip, sharded=sharded, counted=counted,
            split=list(self._split_axes.values()),
            detect_nonfinite=self._nan_detect, nan_skip=self._nan_skip,
            **epi)
        lr = float(self._lr_fn(self.global_steps))
        beta1 = float(self._mom_fn(self.global_steps))
        if self._offload:
            if self._grads_16bit and not offload_dp:
                self._wire.copy_(self._grad32)
            if not bool(overflow):      # waits for the device step
                with (self.telemetry.span if self.telemetry is not None
                      else null_span)("host_adam"):
                    if offload_dp:
                        self._host_phase_dp(lr, beta1)
                    else:
                        self._host_phase(lr, beta1)
        else:
            self._optimizer_step(grads, lr, beta1, overflow, sharded)
            if self._stage in (1, 2):
                self._refresh_params()
        self._fp8_end_step(overflow)
        self.device_state = loss_scale_epilogue(
            self.device_state, overflow, fp16, self.dynamic_loss_scale,
            self._scale_args())
        torch._foreach_zero_(grads)
        if offload_dp:
            self._grad32.zero_()
        elif self._stage in (1, 2) and not self._offload and \
                (self._stage == 1 or self._qcomm is not None):
            torch._foreach_zero_([p.grad for p in self.params])
        if comm is not None:
            loss_sum = comm.mean_scalar(loss_sum)
        metrics = step_metrics(loss_sum, accum, grad_norm, applied_norm, lr,
                               scale, overflow, dstate=self.device_state,
                               nonfinite=nonfinite)
        if self._sparse:
            metrics["sparse_grad_dropped"], \
                metrics["sparse_grad_dense_fallbacks"] = sparse_stats
            if not self._sparse_warned and float(sparse_stats[0]) > 1e-7:
                self._sparse_warned = True
                log_dist(
                    f"sparse_gradients: {int(sparse_stats[1])} embedding "
                    f"leaf(s) fell back to the dense all-reduce (top-k "
                    f"would drop {float(sparse_stats[0]):.3g} of L1 gradient "
                    f"mass, e.g. a tied embedding); set "
                    f"engine.sparse_grad_predicate to exclude them",
                    ranks=[0])
        self.global_steps += 1
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
        return metrics

    @torch.no_grad()
    def _after_step(self, metrics):
        """After a step's math: the resilience (guards, hot snapshot,
        periodic save). Returns the metrics (with the guards' counters
        when they run)."""
        if self._resilience_on:
            metrics = self._after_step_resilience(metrics)
        self._last_metrics = metrics
        return metrics

    def _log_step(self, metrics):
        """The ``steps_per_print`` line and the TensorBoard scalars (JAX
        ``engine.py:2783-2804``); both read the step's values on the
        host."""
        if self.global_steps % self._config.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped="
                     f"{self.skipped_steps}, lr={float(metrics['lr']):.6g}, "
                     f"loss={float(metrics['loss']):.5f}", ranks=[0])
            summ = self.trace_profiler.summary()
            if summ is not None:
                mean_s, min_s, max_s = summ
                log_dist(f"device step time: mean={mean_s * 1e3:.1f}ms "
                         f"min={min_s * 1e3:.1f}ms max={max_s * 1e3:.1f}ms",
                         ranks=[0])
        writer = self.summary_writer
        if writer is not None:
            writer.add_scalar("Train/loss", float(metrics["loss"]),
                              self.global_steps)
            writer.add_scalar("Train/lr", float(metrics["lr"]),
                              self.global_steps)
            if self._config.fp16_enabled:
                writer.add_scalar("Train/loss_scale",
                                  float(metrics["loss_scale"]),
                                  self.global_steps)

    # the pipeline engine's middle stages may pass no batch
    _batch_optional = False

    def train_batch(self, batch=None):
        """One optimizer step over a global batch (``engine.py:2537``):
        ``batch`` is a dict of arrays or tensors with leading dim
        ``train_batch_size``, or None to pull the next one from the
        engine's data loader. Returns the mean loss (a 0-d tensor).

        Under telemetry the step runs in the spans ``data_load``,
        ``dispatch`` (``injected_hang`` inside it under fault injection,
        ``host_adam`` under offload) and ``device_wait``, the one wait for
        the card (on the loss's stream), and emits a ``step`` event (and
        once a ``compile`` event). Without telemetry, timers or a trace
        window the step waits for nothing new."""
        # a pending preemption saves and raises here, before this step
        # takes a batch (the saved data cursor must not run ahead of the
        # optimizer state)
        if self._resilience_on:
            self._check_preemption()
        tele = self.telemetry
        span = tele.span if tele is not None else null_span
        watchdog = tele.watchdog if tele is not None else None
        step = self.global_steps
        step_wall_t0 = time.perf_counter() if tele is not None else 0.0
        if watchdog is not None:
            watchdog.step_start(step)
        if tele is not None and tele.flight is not None:
            self._coll_base = self._collective_counts()
        if batch is None and self._data_iter is not None:
            with span("data_load"):
                batch = next(self._data_iter)
        elif batch is None and not self._batch_optional:
            raise ValueError("no training_data given; pass a batch "
                             "explicitly")
        first = not self._dispatched
        if tele is not None and self._batch_tokens is None:
            self._batch_tokens = _batch_tokens(batch)
        wall_clock = self._config.wall_clock_breakdown
        self.trace_profiler.before_step(step)
        # synchronized timing only for wall_clock_breakdown runs and the
        # steps inside the trace window
        timed = wall_clock or self.trace_profiler.in_window(step)
        step_t0 = time.perf_counter() if timed else None
        if wall_clock:
            self.timers("train_batch").start()
            self.tput_timer.start()
        with span("dispatch"):
            if self._fault_on:
                # a hard death inside the step, then a stuck step (the
                # watchdog's seam)
                fault_injection.maybe_kill("step", step)
                hang_s = fault_injection.hang_seconds(step)
                if hang_s > 0.0:
                    with span("injected_hang"):
                        time.sleep(hang_s)
            compile_t0 = time.perf_counter()
            metrics = self._dispatch(batch)
        self._dispatched = True
        if first and tele is not None:
            self._stamp_compile_facts(step, time.perf_counter() - compile_t0)
        if timed or tele is not None:
            # the step's wall covers the device's work: device_wait is
            # the dispatch slack (near zero when the host is the bound)
            with span("device_wait"):
                _device_wait(metrics["loss"])
        if wall_clock:
            self.tput_timer.stop()
            self.timers("train_batch").stop()
            self.timers.log(["train_batch"],
                            memory_breakdown=self._config.memory_breakdown)
        self.trace_profiler.after_step(
            step, None if step_t0 is None else
            time.perf_counter() - step_t0)
        metrics = self._after_step(metrics)
        if tele is not None:
            step_wall = time.perf_counter() - step_wall_t0
            if watchdog is not None:
                watchdog.step_end(step, step_wall)
            evt = tele.step_event(
                step=self.global_steps,
                flavor=self._telemetry_flavor(),
                wall_s=step_wall,
                phases={k: round(v, 6)
                        for k, v in tele.drain_phases().items()},
                tokens=self._batch_tokens,
                process_index=self._proc_meta["process_index"],
                hostname=self._proc_meta["hostname"],
                **self._scalar_metrics(metrics))
            self.metrics_history.append(evt)
            if self._anomaly_detector is not None:
                reason = self._anomaly_detector.observe(step_wall)
                if reason is not None:
                    self._arm_anomaly_trace(reason)
        self._log_step(metrics)
        return metrics["loss"]

    def _dispatch(self, batch):
        """The step's work on the host's side: the micro-batches'
        forwards and backwards and :meth:`_step_math`; returns its
        metrics."""
        accum = self._config.gradient_accumulation_steps
        micro = self._micro_batches(batch)
        self._wait_for_params()
        step_seed = self._step_seed(0, self.global_steps)
        seeds = [fold_in_seed(step_seed, i) for i in range(accum)]
        self.module.train()
        theta = self._pld_theta(self.global_steps)
        self._fp8_begin_step(micro[0])

        def loss(b, seed):
            return self._loss(b, seed, theta)

        # built per call: stored, its bound methods would tie the engine
        # into a reference cycle that only the cyclic collector frees
        accumulate = make_grad_accumulator(
            loss, accum,
            after_backward=self._fold_grads if self._offload else None,
            backward=self._backward)
        loss_sum = accumulate(micro, seeds, self._scale())
        self.micro_steps += accum
        return self._step_math(loss_sum, accum, tokens=_int_elements(micro))

    @torch.no_grad()
    def eval_batch(self, batch):
        """Forward-only loss over the global batch (no dropout, no state
        change; JAX ``engine.py:2806``): each process passes its rows,
        and the ranks' losses are averaged over the data group, as
        :meth:`train_batch` averages its loss."""
        self._wait_for_params()
        loss = self._loss(self._to_device(batch), None)
        if self.comm.active:
            loss = self.comm.mean_scalar(loss)
        return loss

    # ------------------------------------------------------------------
    # forward/backward/step API (``engine.py:2837-2928``)
    # ------------------------------------------------------------------
    def forward(self, batch):
        """This rank's micro-batch loss, with dropout and its autograd
        graph, for :meth:`backward` to differentiate. JAX's ``forward``
        returns :meth:`eval_batch`'s global value instead and recomputes
        the gradient in ``backward``; the port keeps the graph of the
        loss it returns (``ROADMAP.md`` §3)."""
        seed = self._step_seed(1, self.micro_steps)
        self._wait_for_params()
        placed = self._to_device(batch)
        self._fp8_begin_step(placed)
        self._micro_tokens += _int_elements([placed])
        self._pending_loss = self._loss(
            placed, seed, self._pld_theta(self.global_steps))
        return self._pending_loss

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def backward(self, loss=None):
        """Accumulate the scaled gradient of the micro-batch loss."""
        if loss is None:
            loss = self._pending_loss
        if loss is None:
            raise ValueError("call forward(batch) first or pass the loss")
        self._backward(loss, self._scale())
        if self._offload:
            self._fold_grads()
        loss_sum = loss.detach().float()
        if self._micro_loss_sum is not None:
            loss_sum = loss_sum + self._micro_loss_sum
        self._micro_loss_sum = loss_sum
        self.micro_steps += 1
        self._pending_loss = None
        return loss

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % \
            self._config.gradient_accumulation_steps == 0

    def step(self):
        """Apply the accumulated gradients at the accumulation boundary."""
        if not self.is_gradient_accumulation_boundary():
            return
        if self._micro_loss_sum is None:
            raise ValueError("no gradients accumulated")
        loss_sum, self._micro_loss_sum = self._micro_loss_sum, None
        tokens, self._micro_tokens = self._micro_tokens, 0
        self._apply_step(loss_sum, self._config.gradient_accumulation_steps,
                         tokens=tokens)

    # ------------------------------------------------------------------
    # data (``engine.py:975``)
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, route=None,
                     collate_fn=None, num_local_io_workers=None,
                     data_sampler=None):
        """The loader over ``dataset`` that yields this process's
        ``train_batch_size // world`` rows a batch (drop_last; the
        JAX loader's strided split), as torch CPU tensors."""
        if batch_size is None:
            batch_size = self._config.train_batch_size
        # each process emits its batch_size // world rows (the loader's
        # defaults are the group's rank and world)
        return DeepSpeedDataLoader(dataset, batch_size=batch_size,
                                   collate_fn=collate_fn, drop_last=True)

    # ------------------------------------------------------------------
    # checkpoints (``engine.py:2930-3270``)
    # ------------------------------------------------------------------
    def _topology(self):
        """``meta``'s topology (JAX ``_topology``, ``engine.py:2936``);
        ``mesh_shape`` with a model axis."""
        topo = {"world_size": mesh.dp_world_size(),
                "dp_world_size": self.dp_world_size,
                "zero_stage": self.zero_optimization_stage(),
                "offload": self._offload}
        if self._split_axes:
            topo["mesh_shape"] = {"data": self.dp_world_size,
                                  "model": self.mp_world_size}
            if self._ep is not None:
                topo["mesh_shape"]["expert"] = self._ep.size
        return topo

    def _tp_whole(self, i, t):
        """Leaf ``i`` whole over the axis it is split over, from this
        rank's ``t`` (every rank's piece all-gathered, the padding
        cut)."""
        spec = self._tp_specs[i]
        if spec is None:
            return t
        pieces = tp_comm.all_gather(t.contiguous()[None],
                                    self._split_axes[spec.axis], dim=0)
        return tpl.unshard(list(pieces.unbind(0)), spec)

    def _tp_local(self, i, full):
        """This rank's piece of the whole leaf ``full`` (along the axis
        it is split over)."""
        spec = self._tp_specs[i]
        if spec is None:
            return full
        g = self._split_axes[spec.axis]
        return tpl.shard_tensor(full, spec, g.rank, g.size)

    def _whole(self, i, piece):
        """Leaf ``i`` whole over the data group from this rank's fp32
        ``piece`` (an fp32 all-gather; the piece itself at stage 0)."""
        part = self._parts[i] if self._parts else None
        if part is None or not part.sharded:
            return piece
        flat = torch.empty(part.numel, dtype=piece.dtype,
                           device=piece.device)
        self.comm.all_gather(flat, piece.contiguous())
        return part.from_gathered(flat).contiguous()

    def _param_names(self):
        names = {id(p): n for n, p in self.module.named_parameters()}
        return [names.get(id(p), f"param_{i}")
                for i, p in enumerate(self.params)]

    def _checkpoint_state_tree(self):
        """The state a checkpoint holds: fp32 masters by param name, the
        optimizer state and the device counters (0-d tensors)."""
        names = self._param_names()
        W = self._tp_whole
        if self._offload:
            opt = self.cpu_optimizer
            params = {n: W(i, t) for i, (n, t) in
                      enumerate(zip(names, opt.params()))}
            if self._split_axes:
                def flat(buf):
                    return torch.cat([
                        W(i, buf[o:o + k].view(sh)).reshape(-1)
                        for i, (o, k, sh) in enumerate(zip(
                            opt.offsets, opt.sizes, opt.shapes))])
                opt_state = {"exp_avg": flat(opt.exp_avg),
                             "exp_avg_sq": flat(opt.exp_avg_sq),
                             "step": np.int64(opt._step)}
            else:
                opt_state = {"exp_avg": opt.exp_avg,
                             "exp_avg_sq": opt.exp_avg_sq,
                             "step": np.int64(opt._step)}
        else:
            s = self.opt_state
            if self._stage == 3:
                params = {n: W(i, self._whole(i, m)) for i, (n, m) in
                          enumerate(zip(names, self._masters))}
            else:
                params = {n: W(i, p.data)
                          for i, (n, p) in enumerate(zip(names, self.params))}
            opt_state = {
                "m": {n: W(i, self._whole(i, m))
                      for i, (n, m) in enumerate(zip(names, s.m))},
                "v": {n: W(i, self._whole(i, v))
                      for i, (n, v) in enumerate(zip(names, s.v))},
                "step": s.step}
            if self._opt_kind == "onebit":
                opt_state.update(self._onebit_error_tree())
        ds = self.device_state
        return {"params": params, "opt_state": opt_state,
                "device_state": {
                    "cur_scale": ds.loss_scale.cur_scale,
                    "cur_iter": ds.loss_scale.cur_iter,
                    "last_overflow_iter": ds.loss_scale.last_overflow_iter,
                    "cur_hysteresis": ds.loss_scale.cur_hysteresis,
                    "global_step": ds.global_step,
                    "skipped_steps": ds.skipped_steps,
                    "consecutive_skipped": ds.consecutive_skipped}}

    def _onebit_error_tree(self):
        """1-bit Adam's error buffers in JAX's global layout: the worker
        errors ``[world, padded_n]`` (row r rank r's) and the server errors
        ``[padded_n]`` (chunk r rank r's), gathered over the data
        group."""
        s = self.opt_state
        we, se = s.worker_error, s.server_error
        world = self.dp_world_size
        out = {"worker_error": torch.empty((world,) + tuple(we.shape),
                                           dtype=we.dtype, device=we.device),
               "server_error": torch.empty(world * se.numel(),
                                           dtype=se.dtype, device=se.device)}
        self.comm.all_gather(out["worker_error"], we)
        self.comm.all_gather(out["server_error"], se)
        return out

    def _restore_onebit_errors(self, o):
        """This rank's rows of the saved error buffers; saved at another
        data-parallel world (or not saved), error feedback restarts from
        zero, with JAX's warning (``engine.py:3063-3080``)."""
        s = self.opt_state
        world, rank = self.dp_world_size, self.dp_rank
        want = (world,) + tuple(s.worker_error.shape)
        we = o.get("worker_error")
        se = o.get("server_error")
        if we is None or tuple(np.shape(we)) != want:
            logger.warning(
                "onebit error buffers saved for a different dp world "
                "size; resetting error feedback to zero")
            s.worker_error.zero_()
            s.server_error.zero_()
            return
        chunk = s.server_error.numel()
        s.worker_error.copy_(torch.as_tensor(np.asarray(we))[rank])
        s.server_error.copy_(torch.as_tensor(np.asarray(se)).reshape(-1)[
            rank * chunk:(rank + 1) * chunk])

    def _checkpoint_meta(self, client_state):
        """The JSON sidecar (``engine.py:2993``)."""
        sched = self.lr_scheduler
        return {
            "global_steps": self.global_steps,
            "micro_steps": self.micro_steps,
            # the dropout stream's base: resume must not depend on the
            # resuming process passing the same seed to initialize()
            "seed": self.seed,
            "lr_scheduler": sched.state_dict()
            if sched is not None and hasattr(sched, "state_dict") else None,
            "dataloader": self._data_iter.state_dict()
            if self._data_iter is not None else None,
            "client_state": client_state or {},
        }

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write one checkpoint under ``save_dir`` (atomic; see
        :class:`~deepspeed_tpu_torch.runtime.resilience.CheckpointManager`).
        ``tag`` defaults to ``global_step<N>``. Raises
        :class:`~deepspeed_tpu_torch.runtime.resilience.CheckpointIOError`
        when I/O fails past the retry budget."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        t0 = time.perf_counter()
        with (self.telemetry.span if self.telemetry is not None
              else null_span)("checkpoint"):
            if self._offload and self._upload_done is not None:
                self._upload_done.synchronize()
            if self._offload and self._offload_dp:
                self._offload_sync_host_state()
            # every rank gathers (collectives); rank 0 writes, the rest
            # wait
            state = self._checkpoint_state_tree()
            if mesh.dp_rank() == 0:
                meta = self._checkpoint_meta(client_state)
                meta["topology"] = self._topology()
                path = self._ckpt_manager.save(
                    save_dir, tag, state, meta, save_latest=save_latest,
                    extra_manifest={"topology": self._topology()})
                log_dist(f"saved checkpoint {path}", ranks=[0])
            if self.mpu is not None and mesh.is_initialized():
                import torch.distributed as dist
                dist.barrier()
            else:
                self.comm.barrier()
        self._emit_checkpoint_save(save_dir, tag, t0)
        return True

    def _emit_checkpoint_save(self, save_dir, tag, t0):
        """The ``checkpoint_save`` event (JAX ``engine.py:3040-3046``);
        under ``async_save`` its duration is the staging's."""
        if self.telemetry is not None:
            self.telemetry.emit(
                "checkpoint_save", step=self.global_steps, tag=tag,
                path=str(self._ckpt_manager.ckpt_path(save_dir, tag)),
                duration_s=round(time.perf_counter() - t0, 6),
                async_save=bool(self._ckpt_manager.async_save))

    def _emit_checkpoint_load(self, path, meta, t0):
        """The ``checkpoint_load`` event (JAX ``engine.py:3172-3178``):
        ``topology`` is "same" when the checkpoint's topology is this
        engine's, "elastic" when the whole leaves were laid out anew."""
        if self.telemetry is not None:
            saved = meta.get("topology") or {}
            same = json.loads(json.dumps(saved)) == \
                json.loads(json.dumps(self._topology()))
            self.telemetry.emit(
                "checkpoint_load", step=self.global_steps, path=str(path),
                duration_s=round(time.perf_counter() - t0, 6),
                topology="same" if same else "elastic",
                saved_dp_world_size=saved.get("dp_world_size"),
                dp_world_size=self.dp_world_size)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore the engine from a checkpoint under ``load_dir``:
        ``tag=None`` loads the newest valid one (the ``latest`` pointer
        when it validates, else a scan past corrupt or partial ones); an
        explicit tag is strict. Returns ``(path, client_state)``, or
        ``(None, {})`` when nothing valid is there."""
        t0 = time.perf_counter()
        mgr = self._ckpt_manager
        mgr.wait()
        resolved = mgr.resolve_tag(load_dir, tag)
        if resolved is None:
            log_dist(f"no valid checkpoint found at {load_dir}; cannot "
                     f"load", ranks=[0])
            return None, {}
        manifest = mgr.validate(mgr.ckpt_path(load_dir, resolved))
        saved = manifest.get("topology") or {}
        here = self._topology()
        # leaves are saved whole: stage and world may change on load
        if "offload" in saved and saved["offload"] != here["offload"]:
            raise CheckpointTopologyError(
                f"checkpoint {resolved!r} was saved under {saved}, this "
                f"engine runs {here}: the offload setting changed (the "
                f"host Adam's flat state and the per-leaf dense state do "
                f"not convert into each other)")
        state, meta, path = mgr.load(load_dir, resolved)
        self._install_restored_state(state, meta, load_optimizer_states,
                                     load_lr_scheduler_states)
        log_dist(f"loaded checkpoint {path}", ranks=[0])
        self._emit_checkpoint_load(path, meta, t0)
        return path, meta.get("client_state", {})

    @torch.no_grad()
    def _install_restored_state(self, state, meta, load_optimizer_states,
                                load_lr_scheduler_states):
        names = self._param_names()
        saved = state["params"]
        missing = sorted(set(names) - set(saved))
        if missing or len(saved) != len(names):
            raise ValueError(
                f"checkpoint params {sorted(saved)[:4]}... do not match the "
                f"model's ({len(saved)} saved, {len(names)} here; missing "
                f"{missing[:4]}): checkpoint is from a different model")

        def tensor(x):
            return torch.as_tensor(np.asarray(x)) \
                if not torch.is_tensor(x) else x

        def check_shape(name, got, want):
            if tuple(got.shape) != tuple(want):
                raise ValueError(
                    f"checkpoint leaf {name} has shape {tuple(got.shape)}, "
                    f"expected {tuple(want)}: checkpoint is from a "
                    f"different model shape")

        L = self._tp_local
        if self._offload:
            opt = self.cpu_optimizer
            for i, (name, off, size, shape) in enumerate(zip(
                    names, opt.offsets, opt.sizes, opt.shapes)):
                leaf = L(i, tensor(saved[name]))
                check_shape(name, leaf, shape)
                opt.master[off:off + size].copy_(leaf.reshape(-1))
            if load_optimizer_states:
                o = state["opt_state"]
                for key, buf in (("exp_avg", opt.exp_avg),
                                 ("exp_avg_sq", opt.exp_avg_sq)):
                    flat = tensor(o[key]).reshape(-1)
                    if self._split_axes:   # whole leaves, in order
                        at, parts = 0, []
                        for i, name in enumerate(names):
                            n = int(np.prod(tensor(saved[name]).shape))
                            whole = flat[at:at + n].view(
                                tensor(saved[name]).shape)
                            parts.append(L(i, whole).reshape(-1))
                            at += n
                        flat = torch.cat(parts)
                    buf.copy_(flat)
                opt._step = int(np.asarray(o["step"]))
            self._upload_offload_params()
        else:
            def mine(i, full):
                # this rank's piece of a whole leaf
                return full if self._parts is None else \
                    self._parts[i].piece(full)

            for i, (name, p) in enumerate(zip(names, self.params)):
                leaf = L(i, tensor(saved[name]))
                check_shape(name, leaf, self._parts[i].shape
                            if self._stage == 3 else p.shape)
                if self._stage < 3:
                    p.data.copy_(leaf)
                if self._stage >= 1:
                    self._masters[i].copy_(mine(i, leaf))
            if load_optimizer_states:
                o = state["opt_state"]
                for i, (name, m, v) in enumerate(zip(
                        names, self.opt_state.m, self.opt_state.v)):
                    m.copy_(mine(i, L(i, tensor(o["m"][name]))))
                    v.copy_(mine(i, L(i, tensor(o["v"][name]))))
                self.opt_state = self.opt_state._replace(
                    step=torch.as_tensor(int(np.asarray(o["step"])),
                                         dtype=torch.int32,
                                         device=self.device))
                if self._opt_kind == "onebit":
                    self._restore_onebit_errors(o)
        ds = state["device_state"]

        def dev(key, dtype):
            return torch.as_tensor(np.asarray(ds[key]), dtype=dtype,
                                   device=self.device)

        self.device_state = DeviceState(
            loss_scale=type(self.device_state.loss_scale)(
                cur_scale=dev("cur_scale", torch.float32),
                cur_iter=dev("cur_iter", torch.int32),
                last_overflow_iter=dev("last_overflow_iter", torch.int32),
                cur_hysteresis=dev("cur_hysteresis", torch.int32)),
            global_step=dev("global_step", torch.int32),
            skipped_steps=dev("skipped_steps", torch.int32),
            consecutive_skipped=dev("consecutive_skipped", torch.int32))
        self.global_steps = int(meta["global_steps"])
        self.micro_steps = int(meta["micro_steps"])
        if meta.get("seed") is not None:
            self.seed = int(meta["seed"])
        sched = self.lr_scheduler
        if load_lr_scheduler_states and meta.get("lr_scheduler") and \
                sched is not None and hasattr(sched, "load_state_dict"):
            sched.load_state_dict(meta["lr_scheduler"])
        if meta.get("dataloader") is not None and self._data_iter is not None:
            self._data_iter.load_state_dict(meta["dataloader"])
        if self._health_monitor is not None:
            # the pre-restore loss history would trip the spike guard
            self._health_monitor.reset_history()
