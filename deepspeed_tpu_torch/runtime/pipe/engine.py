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

What JAX's engine refuses, this one refuses with its text (progressive
layer drop, uneven layers, ``forward`` / ``backward`` / ``step``).
Compositions JAX accepts that later ROADMAP sub-items port raise "not
yet ported": fp8 in the pipeline and ``auto_axes`` (F2), 1-bit Adam
(F5), and ZeRO stage 3, ZeRO-Offload and sparse gradients inside a
stage (F1b).
"""

import contextlib

import torch

from deepspeed_tpu_torch.ops.flash_attention import fold_in_seed
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.runtime.config import (
    DeepSpeedConfig,
    ONEBIT_ADAM_OPTIMIZER,
)
from deepspeed_tpu_torch.runtime.dataloader import (
    DeepSpeedDataLoader,
    RepeatingLoader,
)
from deepspeed_tpu_torch.runtime.engine import (
    DeepSpeedEngine,
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
    PipelineParallelGrid,
)
from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
    CheckpointManager,
)
from deepspeed_tpu_torch.runtime.utils import check_overflow
from deepspeed_tpu_torch.runtime.zero.comm import Comm
from deepspeed_tpu_torch.utils.logging import log_dist

_NOT_YET = "not yet ported to deepspeed_tpu_torch"


def _later(what, item):
    return NotImplementedError(
        f"{what} in a pipeline is {_NOT_YET} (ROADMAP.md section 1 item 5 "
        f"{item})")


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
                 training_data=None, collate_fn=None, stage_devices=None):
        if not isinstance(model, PipelineModule):
            raise AssertionError("PipelineEngine requires a PipelineModule")
        mesh.initialize_distributed(device=device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        raw = _config_dict(config)
        world, rank = mesh.dp_world_size(), mesh.dp_rank()
        stages_cfg = (raw.get("pipeline") or {}).get("stages")
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
        topo = PipeDataParallelTopology(num_pp=pipe, num_dp=data)
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
            local_ids = [self.grid.stage_id]
            self.dp_rank = self.grid.data_parallel_id
            devices = [device]
        self.dp_world_size = data
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
        for sid, dev in zip(local_ids, devices):
            comm = Comm() if in_process else \
                Comm(group=self.grid.dp_process_group)
            self.stage_engines.append(DeepSpeedEngine(
                self.parts.stages[sid], None, raw, dev, optimizer=optimizer,
                lr_scheduler=lr_scheduler, seed=seed, comm=comm))
        first = self.stage_engines[0]
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
        self.comm = Comm()          # every process: loss, votes, norms
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
                                        self.transport, self.parts.loss_fn)
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        self._data_iter = RepeatingLoader(self.training_dataloader) \
            if self.training_dataloader is not None else None
        self._ckpt_manager = CheckpointManager()
        where = "all stages in one process" if in_process else \
            "one stage a process"
        log_dist(
            f"PipelineEngine: stages={pipe}, data={data}, "
            f"micro_batches={self.micro_batches}, "
            f"layers_per_stage={self.parts.layers_per_stage}, "
            f"tied={self.parts.tied_keys()}, {where}", ranks=[0])

    @staticmethod
    def _check_compositions(model, cfg, optimizer):
        if tuple(getattr(model, "auto_axes", ()) or ()):
            raise _later(f"PipelineModule(auto_axes={model.auto_axes!r})",
                         "F2 (tensor parallelism)")
        if cfg.fp8.enabled:
            raise _later("fp8 (current scaling of the TP blocks' matmuls, "
                         "JAX runtime/pipe/engine.py:141-150)",
                         "F2 (tensor parallelism)")
        name = type(optimizer).__name__.lower() \
            if optimizer is not None and not isinstance(optimizer, str) \
            else (cfg.optimizer_name or "").lower()
        if name == ONEBIT_ADAM_OPTIMIZER:
            raise _later("OneBitAdam", "F5 (1-bit Adam)")
        zc = cfg.zero_config
        if cfg.zero_enabled and zc.cpu_offload:
            raise _later("ZeRO-Offload", "F1b (the pipeline's ZeRO "
                         "stage 3, offload and sparse gradients)")
        if cfg.zero_enabled and cfg.zero_optimization_stage >= 3:
            raise _later("ZeRO stage 3", "F1b (the pipeline's ZeRO "
                         "stage 3, offload and sparse gradients)")
        if cfg.sparse_gradients_enabled:
            raise _later("sparse_gradients", "F1b (the pipeline's ZeRO "
                         "stage 3, offload and sparse gradients)")

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
        named = {se.module.stage_id: pl.stage_state(se.module)
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
        data replica (the other processes add zeros)."""
        pair = torch.stack([num, den]).to(self.device)
        if not any(se.module.is_last for se in self.stage_engines):
            pair = torch.zeros_like(pair)
        if self.comm.active:
            self.comm.all_reduce(pair, stat=True)
        return pair[0], pair[1]

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
        num, den = self.executor.run(
            micro, train=True, seeds=seeds, scale=scale,
            row_offset=self._row_offset(micro), data_rank=self.dp_rank)
        with torch.no_grad():
            self._reduce_tied_grads()
            per_stage = [se._reduce_grads() for se in self.stage_engines]
            num, den = self._global_pair(num, den)
        return per_stage, num, den

    def train_batch(self, batch=None):
        """One optimizer step over a global batch (module docstring).
        Returns the loss (a 0-d tensor)."""
        if batch is None and self._data_iter is not None:
            batch = next(self._data_iter)
        scale = self._scale()
        per_stage, num, den = self._backprop(batch, scale)
        self.micro_steps += self.micro_batches
        return self._apply_pipe_step(per_stage, num, den, scale)["loss"]

    @torch.no_grad()
    def _drop_grads(self, per_stage):
        for se, grads in zip(self.stage_engines, per_stage):
            torch._foreach_zero_(grads)
            if se._stage == 1:
                torch._foreach_zero_([p.grad for p in se.params])

    def value_and_grad(self, batch, scale=1.0):
        """``(loss, grads)`` of the batch without a step: JAX
        ``make_pipeline_value_and_grad_fn``'s result (the gradients of
        ``scale`` times the loss, summed over the data group, fp32) at
        ZeRO stage 0. In the pipe layout when every stage runs here,
        else ``{stage: {stage param name: grad}}``. The engine's state
        does not change."""
        if self._stage != 0:
            raise ValueError("value_and_grad reads whole gradients: ZeRO "
                             "stage 0 only")
        per_stage, num, den = self._backprop(batch, scale)
        D = torch.clamp(den, min=1.0)
        named = {se.module.stage_id: {
            n: (g / D.to(g.device)).detach().cpu()
            for n, g in zip(se._param_names(), grads)}
            for se, grads in zip(self.stage_engines, per_stage)}
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
        if not self.in_process or self._stage != 0:
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
                num, den = self.executor.run(
                    micro, train=True, seeds=seeds, scale=scale,
                    row_offset=self._row_offset(micro),
                    data_rank=self.dp_rank)
            else:
                num, den = pl.sequential_loss_fn(
                    self.parts, micro, seeds=seeds, scale=scale,
                    stages={st.stage_id: st for st in self.local_stages},
                    row_offset=self._row_offset(micro),
                    data_rank=self.dp_rank)
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
        num, den = self.executor.run(
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
                buf = se._grads[i] if se._stage == 2 else \
                    se.params[i].grad
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

    def _stage_sq(self, se, grads, sharded):
        """A stage's sum of squares over its counted gradient leaves
        (a tied copy counts on its first holder only), over its data
        group when the leaves are ZeRO pieces."""
        names = se._param_names()
        counted = se._counted if sharded else [True] * len(grads)
        first = se.module.stage_id == 0
        sq = [torch.sum(torch.square(g.float()))
              for g, c, n in zip(grads, counted, names)
              if c and (first or not n.startswith("tied."))]
        total = torch.stack(sq).sum() if sq else \
            torch.zeros((), dtype=torch.float32, device=se.device)
        if sharded and se.comm.active:
            total = se.comm.all_reduce(total.reshape(1).clone(),
                                       stat=True).reshape(())
        return total

    def _global_norm(self, per_stage, sharded):
        """The norm over every stage: each stage's sum of squares, summed
        in stage order (gathered over the pipe group across processes)."""
        sq = [self._stage_sq(se, g, sharded)
              for se, g in zip(self.stage_engines, per_stage)]
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
        return torch.sqrt(vec.sum())

    @torch.no_grad()
    def _apply_pipe_step(self, per_stage, num, den, scale):
        cfg = self._config
        fp16 = cfg.fp16_enabled
        clip = float(cfg.gradient_clipping or 0.0)
        sharded = self._stage >= 1
        D = torch.clamp(den, min=1.0)
        loss = num / D
        denom = scale * D
        for grads in per_stage:
            for g in grads:
                g.div_(denom.to(g.device))
        if fp16:
            flags = [check_overflow(g).to(self.device) for g in per_stage]
            overflow = torch.stack(flags).any()
            overflow = self.comm.any_flag(overflow)
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        grad_norm = self._global_norm(per_stage, sharded)
        applied = grad_norm
        if clip > 0:
            coef = torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
            for grads in per_stage:
                for g in grads:
                    g.copy_((g * coef.to(g.device)).to(g.dtype))
            applied = self._global_norm(per_stage, sharded)
        lr = float(self._lr_fn(self.global_steps))
        beta1 = float(self._mom_fn(self.global_steps))
        for se, grads in zip(self.stage_engines, per_stage):
            se._optimizer_step(grads, lr, beta1, overflow.to(se.device),
                               sharded)
            if se._stage in (1, 2):
                se._refresh_params()
        self._drop_grads(per_stage)
        self.device_state = loss_scale_epilogue(
            self.device_state, overflow, fp16, self.dynamic_loss_scale,
            self._scale_args())
        metrics = step_metrics(loss, 1, grad_norm, applied, lr, scale,
                               overflow, dstate=self.device_state,
                               nonfinite=overflow)
        self.global_steps += 1
        if self.lr_scheduler is not None and \
                hasattr(self.lr_scheduler, "step"):
            self.lr_scheduler.step()
        if self.global_steps % cfg.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped="
                     f"{self.skipped_steps}, lr={lr:.6g}, "
                     f"loss={float(loss):.5f}", ranks=[0])
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
        return {"world_size": mesh.dp_world_size(),
                "dp_world_size": self.dp_world_size,
                "pipe": self.num_stages, "data": self.dp_world_size,
                "zero_stage": self.zero_optimization_stage(),
                "offload": False}

    def _stage_trees(self):
        """``{stage: {"params", "m", "v"}}`` of this process's stages
        (whole leaves, by stage param name), and the Adam step."""
        trees, step = {}, None
        for se in self.stage_engines:
            t = se._checkpoint_state_tree()
            o = t["opt_state"]
            trees[se.module.stage_id] = {
                k: {n: torch.as_tensor(v).detach().cpu()
                    for n, v in d.items()}
                for k, d in (("params", t["params"]), ("m", o["m"]),
                             ("v", o["v"]))}
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
        trees, step = self._gathered_trees()
        if mesh.dp_rank() == 0:
            S, L = self.num_stages, self.parts.layers_per_stage

            def layout(kind):
                return pl.to_pipe_layout(
                    {s: t[kind] for s, t in trees.items()}, S, L)

            ds = self.device_state
            state = {"params": layout("params"),
                     "opt_state": {"m": layout("m"), "v": layout("v"),
                                   "step": step},
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
        return True

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore from a checkpoint under ``load_dir`` (any stage count:
        the body restages). Returns ``(path, client_state)``, or ``(None,
        {})`` when nothing valid is there."""
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
            view = {"params": pl.stage_view(state["params"], st, S, L),
                    "opt_state": {
                        "m": pl.stage_view(opt["m"], st, S, L),
                        "v": pl.stage_view(opt["v"], st, S, L),
                        "step": opt["step"]},
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
        return path, meta.get("client_state", {})
