"""PipelineEngine: train a PipelineModule over a ``pipe`` x ``data``
topology (port of ``deepspeed_tpu/runtime/pipe/engine.py``, the
reference's ``runtime/pipe/engine.py:152``).

The ``mesh`` config key lays the stages over the processes
(``parallel/mesh.py:pipe_data_topology``):

- **one process a stage rank** (``world == pipe * data``, the reference's
  layout, ranks by ``PipeDataParallelTopology``): stages talk through
  :class:`~deepspeed_tpu_torch.runtime.pipe.pipeline.ProcessTransport`
  (gloo on the CPU, NCCL across cards);
- **every stage of a data replica in one process** (``world == data``,
  one process included): :class:`~deepspeed_tpu_torch.runtime.pipe.
  pipeline.LocalTransport` and one controller, each stage on its device
  from ``stage_devices`` (default: the engine's device for all). This is
  the only way a pipeline of two or more stages runs on one card: NCCL
  refuses two ranks on one device.

Each stage this process runs gets an engine of its own, a
:class:`~deepspeed_tpu_torch.runtime.engine.DeepSpeedEngine` over the
stage's layers and the stage's data group: its fp32 masters, its ZeRO
stage 0-2 partition and collectives, its compute-dtype param installer,
its optimizer state and one K4 launch a step. A train batch is
``gradient_accumulation_steps`` micro-batches through the 1F1B stream
(``TrainSchedule``; ``DataParallelSchedule`` at one stage), so the
engine-level accumulation is 1. Then, as the stream's last instructions:

1. ``ReduceTiedGrads``: each tied key's gradient summed over the stages
   that hold a copy (before clipping and the overflow check, so the norm
   counts the leaf once, on its first stage);
2. ``ReduceGrads``: each stage's gradients over its data group (its
   stage's engine, as at that ZeRO stage; stage 2 already reduced them
   as the backward made them);
3. the epilogue over every stage: the gradients divided by the loss
   scale times the total weight (the token count summed over
   micro-batches and the data group, JAX ``pipeline.py:689-692``); the
   fp16 overflow vote and the global norm over every stage (each stage's
   sum of squares, summed in stage order, so both transports give the
   same bits), clipping;
4. ``OptimizerStep``: each stage's update (K4 once a stage), the ZeRO
   refresh, then the loss scale and counters.

``train_batch`` returns ``sum(loss_sum) / max(sum(weight), 1)`` over the
micro-batches and the data group; ``eval_batch`` runs the
``InferenceSchedule`` (JAX's GPipe loss). Only the first stage needs the
inputs and only the last the labels: a process that runs neither may
pass ``None``. Each data replica passes ``train_batch_size // data``
rows.

Checkpoints hold the pipe layout (``runtime/pipe/pipeline.py``: the body
stacked ``[stages, layers/stage, ...]``, one copy of each tied leaf), the
optimizer moments in the same layout, and ``pipe`` and ``data`` in the
topology of their manifest and meta; they resume bit for bit at the same
topology and load at another stage count (JAX's restage: only the
body's leading split changes).

Inside a stage, as JAX's engine runs them over the pipeline's params:

- **ZeRO stage 3**: the stage's params live as fp32 pieces and are
  gathered on use (``runtime/zero/stage3.py``). Each forward and each
  backward of the 1F1B stream runs in its own installer scope: a
  forward releases what it gathered when it ends, and a backward
  gathers every leaf its saved tensors name again (the saved-tensor
  hooks keep no gathered copy in a micro-batch's graph), so a backward
  that runs after later micro-batches' forwards never reads a released
  buffer. The pieces' gradients arrive reduce-scattered and accumulate
  over the micro-batches.
- **ZeRO-Offload**: each stage engine has its own host C++ Adam over the
  stage's params. A stage's compute-dtype gradient is folded into its
  fp32 accumulator as each backward makes it
  (:meth:`DeepSpeedEngine.fold_on_accumulate`); the tied sum, the data
  group's reduce-scatter (across processes), the pipeline's epilogue,
  then each stage's host phase run on that accumulator.
- **sparse gradients** (ZeRO stage 0): after the tied sum, a stage's
  flagged leaves take the CSR exchange over its data group
  (:meth:`DeepSpeedEngine._reduce_grads_sparse`), the token budget the
  replica's integer batch elements. A tied copy's gradient is the sum
  over its holders before the vote, so every holder votes on the same
  summed leaf (a tied embedding falls back to the dense all-reduce on
  each). JAX's sparse step refuses a mesh with pipe > 1
  (``engine.py:1915``); the port runs it at any pipe, and at pipe 1 it
  is JAX's.

With a ``model`` mesh axis (``parallel/pipe_tp.py``) every stage of a
(data, model) coordinate runs in one process over ``MeshGroups``
(``world == data * model``, or an ``mpu`` or ``stage_devices`` given),
or one process a stage rank of the reference's 3-D layout
(``PipeMeshTopology``: pipe outermost, model innermost; ``world ==
pipe * data * model``; the grid is the ``mpu``): the stages'
engines reduce over the data group, the norm and the overflow vote
cross the model group (model rank 0 counts the loss), and the executor
runs inside the ``tensor_parallel.overlap`` plan. ``fp8`` runs every stage in a
stateless ``fp8_scope``: JAX's current scaling of the layers' matmuls
(JAX ``engine.py:137-150``), its wire composed into the overlap plan.

The ``seq`` and ``expert`` axes take the same two layouts (every stage
of a (data, expert, seq, model) coordinate in one process over
``MeshGroups``, or one process a stage rank of ``PipeMeshTopology``,
pipe outermost); the stages are built and run inside
``parallel/pipe_tp.py:axis_scope`` with the mesh's groups
(``parallel/pipe_sp.py``, ``moe/expert_pipe.py``,
``parallel/pipe_tp_moe.py``). At seq > 1 the loss must be the weighted
``(loss_sum, weight)`` (a scalar raises JAX's ``ValueError``); both are
summed over ``pipe``, ``data`` and ``seq``, and every stage's gradients
are summed over ``seq`` (partial sums of replicated leaves) before the
epilogue (JAX ``pipeline.py:490-503, 920-965``). Leaves split over
``expert`` (``expert_*`` banks) are never averaged across it: their
gradients reduce over ``data``, and the norm and the fp16 vote cross
the expert group as they cross the model group.

**1-bit Adam** (``OneBitAdam`` by name or a client ``OnebitAdam``,
ZeRO 0, over pipe x model x data; JAX ``engine.py:2152-2410``): each
stage skips the dense all-reduce over its data group and keeps its
*local* gradients (the tied sum still runs), scaled so that their mean
over the data group is the gradient. The overflow is voted as above;
each data rank's norm is taken over the whole model (the stages' sums of
squares, a tied or model-replicated leaf counted once); the reported
norm is the data ranks' mean, clipping divides by their max. Each stage
engine then runs ``runtime/fp16/onebit_adam.py:pipeline_onebit_update``
over separately compressed buffers (``pipeline_onebit_groups``): the
body (at model > 1 the model-sharded leaves apart from the replicated
ones), flat in JAX's order (its stacked leaves, from the body layer's
``reference_leaves``), the stage's own prologue or epilogue, the tied
leaves. A buffer's
1-bit scale is its whole norm, so a copy that must stay equal is
compressed in a buffer of the same content on every holder: the tied
leaves on the first and the last stage, a model-replicated leaf on
every model rank. Checkpoints add each stage's error buffers.

**Telemetry**: ``train_batch`` is the base engine's, around
:meth:`PipelineEngine._dispatch` (the 1F1B stream and the step), so the
pipeline step runs under the same spans and emits the same events with
flavor ``pipeline``; its run_start events and flight dumps add
``num_stages`` and ``micro_batches``, and a dump's collectives count the
pipeline's and every local stage's data group. The stage engines run no
session of their own.

What JAX's engine refuses, this one refuses with its text (progressive
layer drop, uneven layers, ``forward`` / ``backward`` / ``step``,
``auto_axes``, ``comm_quantization``).
"""

import contextlib
import time
from typing import Any, List, NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.parallel.collectives import all_reduce
from deepspeed_tpu_torch.parallel.pipe_tp import axis_scope
from deepspeed_tpu_torch.runtime.config import (
    DeepSpeedConfig,
    ONEBIT_ADAM_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.dataloader import (
    DeepSpeedDataLoader,
    RepeatingLoader,
)
from deepspeed_tpu_torch.runtime.fp16 import onebit_adam
from deepspeed_tpu_torch.runtime.engine import (
    DeepSpeedEngine,
    _int_elements,
    loss_scale_epilogue,
    step_metrics,
)
from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule
from deepspeed_tpu_torch.runtime.pipe.schedule import (
    InferenceSchedule,
    TrainSchedule,
)
from deepspeed_tpu_torch.runtime.pipe.topology import (
    PipeDataParallelTopology,
    PipeMeshTopology,
    PipelineParallelGrid,
)
from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
    CheckpointManager,
)
from deepspeed_tpu_torch.runtime.utils import check_overflow
from deepspeed_tpu_torch.runtime.zero.comm import Comm
from deepspeed_tpu_torch.telemetry.spans import null_span
from deepspeed_tpu_torch.utils.logging import log_dist

class _StageGrads(NamedTuple):
    """A stage's reduced gradients for the pipeline's epilogue: the
    buffers (scaled in place), their param names, whether each counts in
    the norm on this rank, whether they are data-group pieces (summed
    over the group in the norm), and the sparse exchange's
    ``(dropped, fallbacks)``."""
    grads: List[torch.Tensor]
    names: List[str]
    counted: List[bool]
    sharded: bool
    sparse: Any = None


def _stage_masters(se):
    """A copy of a stage engine's fp32 masters by param name, whole (the
    host Adam's under offload, gathered at ZeRO stage 3)."""
    names = se._param_names()
    if se._offload:
        if se._offload_dp:
            se._offload_sync_host_state()
        return {n: se._tp_whole(i, t.detach()).clone()
                for i, (n, t) in enumerate(zip(
                    names, se.cpu_optimizer.params()))}
    if se._stage == 3:
        return {n: se._tp_whole(i, se._whole(i, m)).detach().clone()
                for i, (n, m) in enumerate(zip(names, se._masters))}
    return {n: se._tp_whole(i, p.detach()).clone()
            for i, (n, p) in enumerate(zip(names, se.params))}


def _config_dict(config):
    if isinstance(config, dict):
        return config
    return DeepSpeedConfig(config)._param_dict


class PipelineEngine(DeepSpeedEngine):
    """Training engine for :class:`PipelineModule` models (module
    docstring). It does not run :class:`DeepSpeedEngine`'s constructor:
    its per-stage engines hold the params, and it keeps the state the
    stages share (the config, counters, loss scale, lr schedule)."""

    def __init__(self, model, config, device, optimizer=None,
                 model_parameters=None, lr_scheduler=None, seed=0,
                 training_data=None, collate_fn=None, stage_devices=None,
                 mpu=None):
        if not isinstance(model, PipelineModule):
            raise AssertionError("PipelineEngine requires a PipelineModule")
        mesh.initialize_distributed(device=device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        raw = _config_dict(config)
        world, rank = mesh.dp_world_size(), mesh.dp_rank()
        stages_cfg = (raw.get("pipeline") or {}).get("stages")
        mesh_cfg = dict(raw.get("mesh") or {})
        self.mpu = None
        inner = mesh.inner_size(mesh_cfg)
        if inner > 1:
            pipe = int(mesh_cfg.get("pipe") or stages_cfg or 1)
            if stages_cfg is not None and int(stages_cfg) != pipe:
                raise ValueError(f"pipeline stages {stages_cfg} do not "
                                 f"match the mesh pipe axis ({pipe})")
            mesh.check_mesh_axes(mesh_cfg)
            in_process = stage_devices is not None or mpu is not None or \
                world % (pipe * inner) != 0 or \
                (mesh_cfg.get("data") is not None and
                 int(mesh_cfg["data"]) * inner == world)
            if in_process:
                # every stage of a (data, expert, seq, model) coordinate
                # in one process
                self.mpu = mpu if mpu is not None else mesh.MeshGroups(
                    mesh_cfg, in_process_pipe=True)
                data = self.mpu.get_data_parallel_world_size()
                rank = self.mpu.get_data_parallel_rank()
            else:
                # one process a stage rank over the whole mesh (pipe
                # outermost, then data, expert, seq, model innermost)
                data = world // (pipe * inner)
        else:
            pipe, data, in_process = mesh.pipe_data_topology(
                raw.get("mesh"), world, stages=stages_cfg,
                in_process=True if stage_devices is not None else None)
        if model.num_stages is not None and model.num_stages != pipe:
            raise ValueError(
                f"PipelineModule(num_stages={model.num_stages}) does not "
                f"match the mesh pipe axis ({pipe})")
        if pipe < 2:
            log_dist("pipe axis is 1: pipeline degenerates to sequential "
                     "execution (DataParallelSchedule)", ranks=[0])
        probe = DeepSpeedConfig(raw, world_size=data)
        if probe.pld_enabled:
            raise ValueError(
                "progressive_layer_drop is not supported with "
                "PipelineModule: the hand-scheduled 1F1B program takes no "
                "pld_theta (stage bodies are homogeneous scans)")
        self._check_compositions(model, probe, optimizer)
        if model.partition_method not in ("uniform", "parameters"):
            log_dist(
                f"partition_method={model.partition_method!r}: the "
                f"pipeline splits the homogeneous body uniformly (for equal "
                f"layers this equals the parameter-balanced split); the "
                f"requested policy is recorded but not load-bearing",
                ranks=[0])

        self.module = model
        self.num_stages = pipe
        self.micro_batches = probe.gradient_accumulation_steps
        self.in_process = in_process
        self.seed = int(seed)
        self.device = device
        topo = PipeDataParallelTopology(num_pp=pipe, num_dp=data) \
            if inner == 1 else PipeMeshTopology(
                pipe, data, *(int(mesh_cfg.get(a) or 1)
                              for a in mesh.INNER_AXES))
        if in_process:
            self.grid = None
            local_ids = list(range(pipe))
            self.dp_rank = rank
            devices = [torch.device(d) for d in stage_devices] \
                if stage_devices is not None else [device] * pipe
            if len(devices) != pipe:
                raise ValueError(f"stage_devices names {len(devices)} "
                                 f"devices for {pipe} stages")
        else:
            self.grid = PipelineParallelGrid(
                topo, rank=rank, process_groups=mesh.is_initialized())
            if inner > 1:
                self.mpu = self.grid        # Megatron's mpu accessors
            local_ids = [self.grid.stage_id]
            self.dp_rank = self.grid.data_parallel_id
            devices = [device]
        self.dp_world_size = data
        # the groups the layers are built and run with (pipe_tp.axis_scope)
        self._axes = {"model": mesh.model_axis_of(self.mpu),
                      "seq": mesh.seq_axis_of(self.mpu),
                      "expert": mesh.expert_axis_of(self.mpu),
                      "data": mesh.AxisGroup("data", data, self.dp_rank)}
        self._seq = self._axes["seq"]
        with axis_scope(**self._axes):
            self.parts = pl.build_pipeline_parts(
                model, pipe, seed=seed, stage_ids=local_ids,
                init=model_parameters is None)
        if model_parameters is not None:
            for st in self.parts.stages.values():
                pl.load_stage_state(st, model_parameters, pipe,
                                    self.parts.layers_per_stage)
        compute = torch.float16 if probe.fp16_enabled else (
            torch.bfloat16 if probe.bf16_enabled or probe.amp_enabled
            else torch.float32)
        for st in self.parts.stages.values():
            for layer in st.modules():
                dtype = getattr(getattr(layer, "config", None), "dtype",
                                compute)
                if dtype != compute:
                    raise ValueError(
                        f"the model computes in {dtype} but the config asks "
                        f"for {compute}: build the model with "
                        f"dtype={compute}")
        # one engine a local stage, over the stage's data group
        self.stage_engines = []

        def data_comm():
            if self.mpu is not None:
                return Comm(group=self.mpu.get_data_parallel_group())
            return Comm() if in_process else \
                Comm(group=self.grid.dp_process_group)

        for sid, dev in zip(local_ids, devices):
            self.stage_engines.append(DeepSpeedEngine(
                self.parts.stages[sid], None, raw, dev, optimizer=optimizer,
                lr_scheduler=lr_scheduler, seed=seed, comm=data_comm(),
                mpu=self.mpu))
        for se in self.stage_engines:
            if se._offload:
                se.fold_on_accumulate()
        first = self.stage_engines[0]
        self._onebit = first._opt_kind == "onebit"
        if self._onebit:
            model = self._axes["model"].size
            for se in self.stage_engines:
                sharded = [spec is not None and spec.axis == "model"
                           for spec in se._tp_specs]
                names = se._param_names()
                layer = se.module.body[0] if len(se.module.body) else None
                ref = layer.reference_leaves() \
                    if hasattr(layer, "reference_leaves") else None
                se._onebit_groups = onebit_adam.pipeline_onebit_groups(
                    names, sharded, model, ref)
                se._onebit_transposed = onebit_adam.body_reference_order(
                    names, ref)[1]
                se.opt_state = onebit_adam.init_pipeline_onebit_state(
                    se._masters, se._onebit_groups, se.dp_world_size)
        self._stage_offload = first._offload
        self._config = first._config
        self.compute_dtype = first.compute_dtype
        self.dynamic_loss_scale = first.dynamic_loss_scale
        self.static_loss_scale = first.static_loss_scale
        self.client_optimizer = first.client_optimizer
        self.optimizer_name = first.optimizer_name
        self.lr_scheduler = first.lr_scheduler
        self._lr_fn, self._mom_fn = first._lr_fn, first._mom_fn
        self._stage = first._stage
        # the base engine's state the stage engines hold instead
        self._offload = False
        self._installer = self.cpu_optimizer = None
        self.progressive_layer_drop = self._fp8_state = None
        # the loss, votes and norms: over every process, or over the data
        # group when every stage of a (data, model) coordinate runs here
        # (its model ranks hold the same values)
        self.comm = data_comm() if in_process and self.mpu is not None \
            else Comm()
        self._tp = first._tp
        self._split_axes = first._split_axes    # the model, expert groups
        # JAX runtime/pipe/engine.py:137-150: the overlap plan, with the
        # fp8 wire composed into it, and fp8 current scaling of the
        # layers' matmuls (a scope without state)
        cfg = first._config
        self._overlap = cfg.tensor_parallel.overlap_plan()
        self._fp8 = cfg.fp8.plan()
        if cfg.fp8.wire_enabled and self._overlap is not None:
            import dataclasses
            self._overlap = dataclasses.replace(
                self._overlap, wire_dtype=cfg.fp8.active_wire_dtype(),
                wire_chunk=int(cfg.fp8.wire_chunk_size))
        self.micro_steps = 0
        self.global_steps = 0
        self.device_state = self._init_device_state()
        self._last_metrics = {}
        self.local_stages = [
            pl.LocalStage(se.module, se.device,
                          forward_scope=self._scope(se, "forward"),
                          backward_scope=self._scope(se, "backward"))
            for se in self.stage_engines]
        self.transport = pl.LocalTransport() if in_process else \
            pl.ProcessTransport(self.grid, device)
        self.executor = pl.PipeExecutor(self.local_stages, pipe,
                                        self.transport, self.parts.loss_fn,
                                        seq=self._seq.size)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        self._data_iter = RepeatingLoader(self.training_dataloader) \
            if self.training_dataloader is not None else None
        self._ckpt_manager = CheckpointManager()
        # the base engine's step telemetry (spans, events, the trace
        # window, forensics) over the whole pipeline step; its resilience
        # stays off, its fault seams follow the config
        self._resilience_on = False
        self._fault_on = bool(cfg.resilience.fault_injection)
        self.mp_world_size = self._axes["model"].size
        self._param_bytes = sum(se._param_bytes for se in self.stage_engines)
        self._configure_telemetry(own=True)
        where = "all stages in one process" if in_process else \
            "one stage a process"
        log_dist(
            f"PipelineEngine: stages={pipe}, data={data}, "
            f"micro_batches={self.micro_batches}, "
            f"layers_per_stage={self.parts.layers_per_stage}, "
            f"tied={self.parts.tied_keys()}, {where}", ranks=[0])

    @staticmethod
    def _check_compositions(model, cfg, optimizer):
        auto_axes = tuple(getattr(model, "auto_axes", ()) or ())
        if auto_axes:
            # JAX's engine refuses it with this text
            # (deepspeed_tpu/runtime/pipe/engine.py:120-136)
            raise NotImplementedError(
                f"PipelineModule(auto_axes={auto_axes!r}) through the "
                "engine is experimental and currently disabled: the "
                "in-process CPU runtime deadlocks on the pipeline's "
                "ppermutes when params are placed sharded over an auto "
                "axis. Use make_pipeline_value_and_grad_fn(...) directly "
                "(works, see tests/unit/test_pipe_auto.py) or the "
                "manual-collective TP blocks (parallel/pipe_tp.py)")
        if cfg.comm_quantization.enabled:
            # JAX engine.py:1356-1360
            raise AssertionError(
                "comm_quantization needs jax.grad-able loss_fn (the "
                "pipeline's direct value-and-grad runs its own data-plane "
                "reduction)")
        name = type(optimizer).__name__.lower() \
            if optimizer is not None and not isinstance(optimizer, str) \
            else (cfg.optimizer_name or "").lower()
        if name == ONEBIT_ADAM_OPTIMIZER:
            for ax, size in dict(cfg.mesh_shape or {}).items():
                size = int(size or 1)
                assert ax in ("data", "pipe", "model") or size == 1, (
                    f"pipeline OneBitAdam supports pipe x model x data "
                    f"meshes; axis {ax!r} has size {size}")

    @staticmethod
    def _scope(stage_engine, kind):
        def scope():
            inst = stage_engine._installer
            if inst is None:
                return contextlib.nullcontext()
            return inst.forward() if kind == "forward" else inst.backward()
        return scope

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def train_schedule(self, stage_id=0):
        """The 1F1B instruction stream the executor runs on a stage."""
        return TrainSchedule(micro_batches=self.micro_batches,
                             stages=self.num_stages, stage_id=stage_id)

    def inference_schedule(self, stage_id=0):
        return InferenceSchedule(micro_batches=self.micro_batches,
                                 stages=self.num_stages, stage_id=stage_id)

    def is_gradient_accumulation_boundary(self):
        """A train batch always ends on the boundary."""
        return True

    def p2p_counts(self):
        """The last call's stage-to-stage messages and bytes (sent by
        this process's stages)."""
        return self.transport.counts.snapshot()

    def pipe_state(self):
        """A copy of this process's stages' fp32 masters in the pipe
        layout."""
        named = {se.module.stage_id: _stage_masters(se)
                 for se in self.stage_engines}
        return pl.to_pipe_layout(named, self.num_stages,
                                 self.parts.layers_per_stage) \
            if self.in_process else named

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            "PipelineEngine executes whole train batches: use "
            "train_batch(batch) / eval_batch(batch) (reference "
            "pipe/engine.py raises the same)")

    def backward(self, *args, **kwargs):
        raise RuntimeError(
            "PipelineEngine executes whole train batches: use "
            "train_batch(batch) (reference pipe/engine.py raises the same)")

    def step(self, *args, **kwargs):
        raise RuntimeError(
            "PipelineEngine executes whole train batches: use "
            "train_batch(batch) (reference pipe/engine.py raises the same)")

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _loads_batch(self):
        return any(se.module.is_first or se.module.is_last
                   for se in self.stage_engines)

    def _split(self, batch):
        """This replica's rows as the step's micro-batches (``None``s
        where no local stage loads them)."""
        M = self.micro_batches
        if batch is None:
            if self._loads_batch():
                raise ValueError("the first and the last stage need the "
                                 "batch")
            return [None] * M
        expected = self._config.train_batch_size // self.dp_world_size
        placed = self._to_device(batch)
        for name, x in placed.items():
            if x.shape[0] != expected:
                raise ValueError(
                    f"train_batch expects {expected} rows per data replica "
                    f"(train_batch_size {self._config.train_batch_size} / "
                    f"{self.dp_world_size} replicas), got {x.shape[0]} for "
                    f"{name!r}")
        rows = expected // M
        return [{k: x[i * rows:(i + 1) * rows] for k, x in placed.items()}
                for i in range(M)]

    def _row_offset(self, micro):
        rows = next(iter(m for m in micro if m is not None),
                    {"_": torch.zeros(0)})
        n = next(iter(rows.values())).shape[0]
        return self.dp_rank * n

    def _global_pair(self, num, den):
        """``(sum(loss_sum), sum(weight))`` over the last stages of every
        data replica and every seq rank (the other processes add zeros;
        JAX ``pipeline.py:490-503``)."""
        pair = torch.stack([num, den]).to(self.device)
        if not any(se.module.is_last for se in self.stage_engines) or \
                (self.grid is not None and
                 any(g.rank != 0 for g in self._split_axes.values())):
            # one process a stage rank: every model and expert rank holds
            # the loss; their rank 0 counts it (seq ranks hold partials)
            pair = torch.zeros_like(pair)
        if self.comm.active:
            self.comm.all_reduce(pair, stat=True)
        if self.grid is None:
            all_reduce(pair, self._seq)
        return pair[0], pair[1]

    def _run(self, *args, **kwargs):
        """The executor inside the mesh's groups, the
        ``tensor_parallel.overlap`` plan and the fp8 plan (current
        scaling)."""
        from deepspeed_tpu_torch.ops.fp8 import fp8_scope
        from deepspeed_tpu_torch.parallel.collectives import overlap_scope
        with axis_scope(**self._axes), overlap_scope(self._overlap), \
                fp8_scope(self._fp8):
            return self.executor.run(*args, **kwargs)

    def _backprop(self, batch, scale):
        """The 1F1B stream over the batch, then ``ReduceTiedGrads`` and
        ``ReduceGrads``: returns each local stage's gradient buffers (the
        scaled sums) and the global ``(sum(loss_sum), sum(weight))``."""
        micro = self._split(batch)
        step_seed = self._step_seed(0, self.global_steps)
        seeds = [fold_in_seed(step_seed, i)
                 for i in range(self.micro_batches)]
        for st in self.local_stages:
            st.module.train()
        for se in self.stage_engines:
            se._wait_for_params()
        num, den = self._run(
            micro, train=True, seeds=seeds, scale=scale,
            row_offset=self._row_offset(micro), data_rank=self.dp_rank)
        tokens = _int_elements([m for m in micro if m is not None])
        with torch.no_grad():
            self._reduce_tied_grads()
            per_stage = [self._reduce_stage(se, tokens)
                         for se in self.stage_engines]
            # seq ranks hold partial sums of every (replicated) leaf
            # (JAX pipeline.py:920-965)
            for sg in per_stage:
                for g in sg.grads:
                    all_reduce(g, self._seq)
            num, den = self._global_pair(num, den)
        return per_stage, num, den

    def _reduce_stage(self, se, tokens):
        """``ReduceGrads`` of one stage over its data group, as its
        engine reduces them (the ZeRO stage, offload's reduce-scatter
        into the rank's row, or the sparse exchange): a
        :class:`_StageGrads`."""
        names = se._param_names()
        if se._offload:
            if not se._offload_dp:
                return _StageGrads(se._grad32_views, names,
                                   [True] * len(names), False)
            se.comm.reduce_scatter(se._grad_row, se._grad32)
            idx, views = se.offload_leaf_views()
            return _StageGrads(views, [names[i] for i in idx],
                               [True] * len(idx), True)
        if se._sparse:
            grads, stats = se._reduce_grads_sparse(tokens)
            return _StageGrads(grads, names, [True] * len(names), False,
                               stats)
        if se._opt_kind == "onebit":
            # local gradients: 1-bit Adam averages them itself
            counted = se._tp_counted(se._grads, None)
            return _StageGrads(se._grads, names, counted if counted
                               is not None else [True] * len(names), False)
        grads = se._reduce_grads()
        sharded = se._stage >= 1
        counted = se._tp_counted(grads, se._counted if sharded else None)
        return _StageGrads(grads, names, counted if counted is not None
                           else [True] * len(names), sharded)

    # a process that runs neither the first nor the last stage passes None
    _batch_optional = True

    def _dispatch(self, batch):
        """One optimizer step over a global batch (module docstring),
        inside the base engine's ``train_batch`` (spans, events, the
        trace window); returns its metrics."""
        scale = self._scale()
        per_stage, num, den = self._backprop(batch, scale)
        self.micro_steps += self.micro_batches
        return self._apply_pipe_step(per_stage, num, den, scale)

    def _telemetry_flavor(self):
        return "pipeline"

    def _forensics_extra(self):
        """The pipeline's topology on run_start events and flight-dump
        meta (JAX ``pipe/engine.py:202-207``): a postmortem of a hung
        1F1B stream needs the stages and micro-batches."""
        return {"num_stages": self.num_stages,
                "micro_batches": self.micro_batches}

    def _comms(self):
        return [self.comm] + [se.comm for se in self.stage_engines]

    @torch.no_grad()
    def _drop_grads(self, per_stage):
        for se, sg in zip(self.stage_engines, per_stage):
            if se._offload:
                se._grad32.zero_()
                if se._offload_dp:
                    se._grad_row.zero_()
                continue
            torch._foreach_zero_(sg.grads)
            if se._stage == 1:
                torch._foreach_zero_([p.grad for p in se.params])

    def value_and_grad(self, batch, scale=1.0):
        """``(loss, grads)`` of the batch without a step: JAX
        ``make_pipeline_value_and_grad_fn``'s result (the gradients of
        ``scale`` times the loss, summed over the data group, fp32) at
        ZeRO stage 0. In the pipe layout when every stage runs here,
        else ``{stage: {stage param name: grad}}``. The engine's state
        does not change."""
        if self._stage != 0 or self._stage_offload:
            raise ValueError("value_and_grad reads whole gradients: ZeRO "
                             "stage 0 only")
        per_stage, num, den = self._backprop(batch, scale)
        D = torch.clamp(den, min=1.0)
        named = {se.module.stage_id: {
            n: (g / D.to(g.device)).detach().cpu()
            for n, g in zip(sg.names, sg.grads)}
            for se, sg in zip(self.stage_engines, per_stage)}
        self._drop_grads(per_stage)
        grads = pl.to_pipe_layout(named, self.num_stages,
                                  self.parts.layers_per_stage) \
            if self.in_process else named
        return num / D, grads

    def sequential_check(self, batch, scale=1.0):
        """The 1F1B executor against the sequential oracle on the same
        stage modules (``pipeline.sequential_loss_fn``, each micro-batch's
        backward right after its forward, in the same forward and
        backward scopes), both from zero gradients at the step's seeds.
        Returns ``{"executor": (num, den, grads), "oracle": (num, den,
        grads)}`` with each stage's raw gradient sums (before the tied
        and data reductions) in parameter order. Every stage in this
        process, ZeRO stage 0; the engine's state does not change."""
        if not self.in_process or self._stage != 0 or \
                self._stage_offload:
            raise ValueError("sequential_check runs every stage here at "
                             "ZeRO stage 0")
        micro = self._split(batch)
        step_seed = self._step_seed(0, self.global_steps)
        seeds = [fold_in_seed(step_seed, i)
                 for i in range(self.micro_batches)]
        params = [p for se in self.stage_engines for p in se.params]
        out = {}
        for kind in ("executor", "oracle"):
            if kind == "executor":
                num, den = self._run(
                    micro, train=True, seeds=seeds, scale=scale,
                    row_offset=self._row_offset(micro),
                    data_rank=self.dp_rank)
            else:
                with axis_scope(**self._axes):
                    num, den = pl.sequential_loss_fn(
                        self.parts, micro, seeds=seeds, scale=scale,
                        stages={st.stage_id: st
                                for st in self.local_stages},
                        row_offset=self._row_offset(micro),
                        data_rank=self.dp_rank, seq=self._seq.size)
            with torch.no_grad():
                out[kind] = (num, den, [p.grad.clone() for p in params])
                for p in params:
                    p.grad.zero_()
        return out

    @torch.no_grad()
    def eval_batch(self, batch):
        """Forward-only loss over the global batch through the inference
        stream (no dropout, no state change)."""
        micro = self._split(batch)
        for st in self.local_stages:
            st.module.eval()
        num, den = self._run(
            micro, train=False, row_offset=self._row_offset(micro),
            data_rank=self.dp_rank)
        num, den = self._global_pair(num, den)
        return num / torch.clamp(den, min=1.0)

    # ------------------------------------------------------------------
    # the step's reductions and update
    # ------------------------------------------------------------------
    def _tied_buffers(self, se):
        """``{key: [gradient buffers of the key's leaves]}`` of a stage:
        ``.grad`` at ZeRO stages 0-1, the sharded accumulator at 2."""
        names = se._param_names()
        out = {}
        for i, name in enumerate(names):
            if name.startswith("tied."):
                key = name.split(".")[1]
                if se._offload:
                    buf = se._grad32_views[i]
                elif se._stage >= 2:
                    buf = se._grads[i]
                else:
                    buf = se.params[i].grad
                out.setdefault(key, []).append(buf)
        return out

    def _reduce_tied_grads(self):
        """Each tied key's gradient summed over the stages holding it."""
        for key in self.parts.tied_keys():
            holders = self.parts.tied_holders(key)
            if len(holders) < 2:
                continue
            local = {se.module.stage_id: self._tied_buffers(se)[key]
                     for se in self.stage_engines
                     if se.module.stage_id in holders}
            if self.in_process:
                bufs = [local[s] for s in holders]
                with torch.no_grad():
                    for leaves in zip(*bufs):
                        total = leaves[0].to(leaves[-1].device)
                        for g in leaves[1:]:
                            total = total + g.to(total.device)
                        for g in leaves:
                            g.copy_(total.to(g.device))
            elif local:
                import torch.distributed as dist
                group = self.grid.tied_process_group
                for g in next(iter(local.values())):
                    dist.all_reduce(g, group=group)

    def _stage_sq(self, se, sg):
        """A stage's sum of squares over its counted gradient leaves
        (a tied copy counts on its first holder only), over its data
        group when the leaves are ZeRO pieces or offload rows."""
        first = se.module.stage_id == 0
        sq = [torch.sum(torch.square(g.float()))
              for g, c, n in zip(sg.grads, sg.counted, sg.names)
              if c and (first or not n.startswith("tied."))]
        total = torch.stack(sq).sum() if sq else \
            torch.zeros((), dtype=torch.float32, device=se.device)
        if sg.sharded and se.comm.active:
            total = se.comm.all_reduce(total.reshape(1).clone(),
                                       stat=True).reshape(())
        return total

    def _global_norm(self, per_stage):
        """The norm over every stage: each stage's sum of squares, summed
        in stage order (gathered over the pipe group across processes)."""
        sq = [self._stage_sq(se, sg)
              for se, sg in zip(self.stage_engines, per_stage)]
        if self.in_process:
            vec = torch.stack([s.to(self.device) for s in sq])
        else:
            import torch.distributed as dist
            vec = torch.zeros(self.num_stages, dtype=torch.float32,
                              device=self.device)
            parts = [torch.zeros(1, dtype=torch.float32, device=self.device)
                     for _ in range(self.num_stages)]
            if self.num_stages > 1:
                dist.all_gather(parts, sq[0].reshape(1).to(self.device),
                                group=self.grid.pp_process_group)
            else:
                parts = [sq[0].reshape(1)]
            vec = torch.cat(parts)
        total = vec.sum().reshape(1)
        for g in self._split_axes.values():     # split leaves' pieces
            total = all_reduce(total, g)
        return torch.sqrt(total.reshape(()))

    @staticmethod
    def _onebit_stage_update(se, sg, lr, beta1, overflow):
        """One stage's 1-bit update over its buffers, in place on its
        masters and state."""
        opt = se._onebit
        new_p, se.opt_state = onebit_adam.pipeline_onebit_update(
            se._masters, sg.grads, se.opt_state, se._onebit_groups, lr=lr,
            beta1=beta1, beta2=opt.betas[1], eps=opt.eps,
            weight_decay=opt.weight_decay, freeze_step=opt.freeze_step,
            group=se.comm.axis(), overflow=overflow.to(se.device),
            transposed=se._onebit_transposed)
        for m, n in zip(se._masters, new_p):
            m.copy_(n)

    @torch.no_grad()
    def _apply_pipe_step(self, per_stage, num, den, scale):
        cfg = self._config
        fp16 = cfg.fp16_enabled
        clip = float(cfg.gradient_clipping or 0.0)
        D = torch.clamp(den, min=1.0)
        loss = num / D
        denom = scale * D
        if self._onebit:
            # local gradients whose mean over the data group is the
            # gradient (JAX pipeline.py:941-948)
            denom = denom / self.stage_engines[0].dp_world_size
        for sg in per_stage:
            for g in sg.grads:
                g.div_(denom.to(g.device))
        if fp16:
            flags = [check_overflow(sg.grads).to(self.device)
                     for sg in per_stage]
            overflow = torch.stack(flags).any()
            overflow = self.comm.any_flag(overflow)
            flag = overflow.float().reshape(1)
            for g in self._split_axes.values():
                flag = all_reduce(flag, g, op="max")
            overflow = flag.reshape(()) > 0
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        grad_norm = clip_by = self._global_norm(per_stage)
        comm = self.stage_engines[0].comm
        if self._onebit and comm.active and comm.world > 1:
            # JAX engine.py:2347-2364: each data rank's norm over the
            # whole model; reported, their mean, and clipping by their
            # max, so every rank applies the same factor
            norm = grad_norm.reshape(1).float()
            grad_norm = (comm.all_reduce(norm.clone(), stat=True)
                         / comm.world).reshape(())
            clip_by = comm.all_reduce(norm.clone(), "max",
                                      stat=True).reshape(())
        applied = grad_norm
        if clip > 0:
            coef = torch.clamp(clip / (clip_by + 1e-6), max=1.0)
            for sg in per_stage:
                for g in sg.grads:
                    g.copy_((g * coef.to(g.device)).to(g.dtype))
            applied = grad_norm * coef if self._onebit \
                else self._global_norm(per_stage)
        lr = float(self._lr_fn(self.global_steps))
        beta1 = float(self._mom_fn(self.global_steps))
        for se, sg in zip(self.stage_engines, per_stage):
            if self._onebit:
                self._onebit_stage_update(se, sg, lr, beta1, overflow)
                continue
            if se._offload:
                if se._grads_16bit and not se._offload_dp:
                    se._wire.copy_(se._grad32)
                if not bool(overflow):      # waits for the device step
                    if se._offload_dp:
                        se._host_phase_dp(lr, beta1)
                    else:
                        se._host_phase(lr, beta1)
                continue
            se._optimizer_step(sg.grads, lr, beta1, overflow.to(se.device),
                               sg.sharded)
            if se._stage in (1, 2):
                se._refresh_params()
        sparse = [sg.sparse for sg in per_stage if sg.sparse is not None]
        self._drop_grads(per_stage)
        self.device_state = loss_scale_epilogue(
            self.device_state, overflow, fp16, self.dynamic_loss_scale,
            self._scale_args())
        metrics = step_metrics(loss, 1, grad_norm, applied, lr, scale,
                               overflow, dstate=self.device_state,
                               nonfinite=overflow)
        if sparse:
            metrics["sparse_grad_dropped"] = sum(
                d.to(self.device) for d, _ in sparse)
            metrics["sparse_grad_dense_fallbacks"] = sum(
                f.to(self.device) for _, f in sparse)
        self.global_steps += 1
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
        self._last_metrics = metrics
        return metrics

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def deepspeed_io(self, dataset, batch_size=None, route=None,
                     collate_fn=None, num_local_io_workers=None,
                     data_sampler=None):
        """The loader of this data replica's ``train_batch_size // data``
        rows a batch."""
        if batch_size is None:
            batch_size = self._config.train_batch_size
        return DeepSpeedDataLoader(dataset, batch_size=batch_size,
                                   collate_fn=collate_fn, drop_last=True,
                                   process_index=self.dp_rank,
                                   process_count=self.dp_world_size)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _topology(self):
        topo = {"world_size": mesh.dp_world_size(),
                "dp_world_size": self.dp_world_size,
                "pipe": self.num_stages, "data": self.dp_world_size,
                "zero_stage": self.zero_optimization_stage(),
                "offload": self._stage_offload}
        if self.mpu is not None:
            topo["mesh_shape"] = {"data": self.dp_world_size,
                                  "pipe": self.num_stages,
                                  "model": self._axes["model"].size}
            topo["mesh_shape"].update({a: self._axes[a].size
                                       for a in ("expert", "seq")
                                       if self._axes[a].size > 1})
        return topo

    def _stage_trees(self):
        """``{stage: {"params", "m", "v"}}`` of this process's stages
        (whole leaves, by stage param name), and the Adam step."""
        trees, step = {}, None
        for se in self.stage_engines:
            if se._offload:
                if se._upload_done is not None:
                    se._upload_done.synchronize()
                if se._offload_dp:
                    se._offload_sync_host_state()
            t = se._checkpoint_state_tree()
            o = t["opt_state"]
            if se._offload:     # the host Adam's flat moments, by leaf
                opt = se.cpu_optimizer
                leaves = list(zip(se._param_names(), opt.offsets,
                                  opt.sizes, opt.shapes))
                o = {k: {n: flat[off:off + size].view(shape)
                         for n, off, size, shape in leaves}
                     for k, flat in (("m", o["exp_avg"]),
                                     ("v", o["exp_avg_sq"]))}
                o["step"] = np.int64(opt._step)
            trees[se.module.stage_id] = {
                k: {n: torch.as_tensor(v).detach().cpu()
                    for n, v in d.items()}
                for k, d in (("params", t["params"]), ("m", o["m"]),
                             ("v", o["v"]))}
            if "worker_error" in o:         # 1-bit Adam's, gathered
                trees[se.module.stage_id]["onebit"] = {
                    k: o[k].detach().cpu()
                    for k in ("worker_error", "server_error")}
            step = o["step"]
        return trees, step

    def _gathered_trees(self):
        """Every stage's trees at rank 0 (data replica 0's stages)."""
        trees, step = self._stage_trees()
        if self.in_process or not mesh.is_initialized():
            return trees, step
        import torch.distributed as dist
        mine = trees if self.dp_rank == 0 else {}
        got = [None] * mesh.dp_world_size()
        dist.all_gather_object(got, mine)
        out = {}
        for g in got:
            out.update(g)
        return out, step

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write one checkpoint (the pipe layout; module docstring)."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        t0 = time.perf_counter()
        with (self.telemetry.span if self.telemetry is not None
              else null_span)("checkpoint"):
            self._save_pipe_checkpoint(save_dir, tag, client_state,
                                       save_latest)
        self._emit_checkpoint_save(save_dir, tag, t0)
        return True

    def _save_pipe_checkpoint(self, save_dir, tag, client_state,
                              save_latest):
        trees, step = self._gathered_trees()
        if mesh.dp_rank() == 0:
            S, L = self.num_stages, self.parts.layers_per_stage

            def layout(kind):
                return pl.to_pipe_layout(
                    {s: t[kind] for s, t in trees.items()}, S, L)

            ds = self.device_state
            opt_state = {"m": layout("m"), "v": layout("v"), "step": step}
            if self._onebit:
                opt_state["onebit"] = {f"stage_{s}": t["onebit"]
                                       for s, t in trees.items()}
            state = {"params": layout("params"),
                     "opt_state": opt_state,
                     "device_state": {
                         "cur_scale": ds.loss_scale.cur_scale,
                         "cur_iter": ds.loss_scale.cur_iter,
                         "last_overflow_iter":
                             ds.loss_scale.last_overflow_iter,
                         "cur_hysteresis": ds.loss_scale.cur_hysteresis,
                         "global_step": ds.global_step,
                         "skipped_steps": ds.skipped_steps,
                         "consecutive_skipped": ds.consecutive_skipped}}
            meta = self._checkpoint_meta(client_state)
            meta["topology"] = self._topology()
            path = self._ckpt_manager.save(
                save_dir, tag, state, meta, save_latest=save_latest,
                extra_manifest={"topology": self._topology()})
            log_dist(f"saved checkpoint {path}", ranks=[0])
        self.comm.barrier()

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore from a checkpoint under ``load_dir`` (any stage count:
        the body restages). Returns ``(path, client_state)``, or ``(None,
        {})`` when nothing valid is there."""
        t0 = time.perf_counter()
        mgr = self._ckpt_manager
        mgr.wait()
        resolved = mgr.resolve_tag(load_dir, tag)
        if resolved is None:
            log_dist(f"no valid checkpoint found at {load_dir}; cannot "
                     f"load", ranks=[0])
            return None, {}
        mgr.validate(mgr.ckpt_path(load_dir, resolved))
        state, meta, path = mgr.load(load_dir, resolved)
        S, L = self.num_stages, self.parts.layers_per_stage
        saved = (meta.get("topology") or {}).get("pipe")
        if saved is not None and int(saved) != S:
            log_dist(f"restaging checkpoint {resolved!r} from {saved} to "
                     f"{S} stages", ranks=[0])
        opt = state["opt_state"]
        for se in self.stage_engines:
            st = se.module
            m = pl.stage_view(opt["m"], st, S, L)
            v = pl.stage_view(opt["v"], st, S, L)
            o = {"m": m, "v": v, "step": opt["step"]}
            if self._onebit:
                o.update((opt.get("onebit") or {}).get(
                    f"stage_{st.stage_id}", {}))
            if se._offload:         # back to the host Adam's flat form
                names = se._param_names()
                o = {k: torch.cat([torch.as_tensor(np.asarray(d[n]))
                                   .reshape(-1) for n in names])
                     for k, d in (("exp_avg", m), ("exp_avg_sq", v))}
                o["step"] = opt["step"]
            view = {"params": pl.stage_view(state["params"], st, S, L),
                    "opt_state": o,
                    "device_state": state["device_state"]}
            se._install_restored_state(view, meta, load_optimizer_states,
                                       load_lr_scheduler_states)
        self.device_state = self.stage_engines[0].device_state
        self.global_steps = int(meta["global_steps"])
        self.micro_steps = int(meta["micro_steps"])
        if meta.get("seed") is not None:
            self.seed = int(meta["seed"])
        if meta.get("dataloader") is not None and self._data_iter is not None:
            self._data_iter.load_state_dict(meta["dataloader"])
        log_dist(f"loaded checkpoint {path}", ranks=[0])
        self._emit_checkpoint_load(path, meta, t0)
        return path, meta.get("client_state", {})
