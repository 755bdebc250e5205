"""Pipeline execution: the stages' parts, the sequential oracle, and the
executor of the 1F1B and inference instruction streams (port of
``deepspeed_tpu/runtime/pipe/pipeline.py``).

The JAX package compiles a train batch into one XLA program: stages sit
at coordinates of the ``pipe`` mesh axis, activations rotate with
``lax.ppermute``, and each stage recomputes its forward in its backward
(one ``jax.vjp`` a tick). The port is a PyTorch design with the same
results:

- **Parts.** :func:`split_specs` cuts the module's specs into prologue /
  body / epilogue (the body: the longest run of identical specs, which
  must divide evenly by the stage count). :func:`build_pipeline_parts`
  builds, for each stage this process runs, a :class:`StageModule`
  holding that stage's layers as ``nn.Module``\\ s: stage 0 the prologue,
  the last stage the epilogue, every stage ``L/S`` body layers. A stage
  that uses a tied key (GPT-2's embedding on stage 0 and its head on the
  last stage) holds its own copy of the tied layer; the engine sums their
  gradients across those stages after the backward, so the copies stay
  equal (the reference's tied all-reduce, ``pipe/module.py:405-474``;
  AD does it in JAX).
- **Params.** Layer ``i`` (in spec order, a tied key at its first
  occurrence) is initialized from ``base_seed + i`` with ``seed_layers``,
  else from ``fold_in_seed(seed, i)``, on the CPU, so every process and
  every stage layout builds the same weights. :func:`stage_state` and
  :func:`load_stage_state` move a stage's params to and from the *pipe
  layout*: one flat mapping ``{"prologue.<...>", "tied.<key>.<...>",
  "epilogue.<...>", "body.<name>": [S, L/S, ...]}`` (the JAX
  ``PipelineParts.params`` with the body stacked), which checkpoints and
  ``model_parameters`` use.
- **Autograd.** Each in-flight micro-batch keeps its autograd graph (the
  reference's and torch's way) until its backward; the received
  activation is a leaf with ``requires_grad``, and its ``.grad`` is the
  gradient sent upstream. With ``activation_checkpoint_interval`` k > 0
  the body runs in checkpointed chunks of k layers
  (``runtime/activation_checkpointing``), whose recompute replays the
  stage's dropout generator. JAX's recompute and the port's saved graphs
  give the same gradients.
- **Activations** are a tensor or a tuple of tensors (an MoE body's
  ``(hidden, aux)``): each leaf travels, takes its gradient and sends it
  back; a leaf that carries no gradient (a constant aux of 0) is sent a
  zero cotangent.
- **Loss.** ``loss_fn(output, micro)`` returns ``(loss_sum, weight)`` or
  a scalar (weight 1); at seq > 1 a scalar raises (JAX
  ``pipeline.py:445-450``). Backward seeds are the loss scale on each
  micro-batch's loss sum; the engine divides the gradients by ``scale``
  times the total weight over micro-batches and the data group (JAX
  ``pipeline.py:689-692``), and the loss is ``sum(loss_sum) /
  max(sum(weight), 1)``.
- **Executor.** :class:`PipeExecutor` interprets each local stage's
  ``TrainSchedule`` (or ``InferenceSchedule``) stream round by round: in
  a round every local stage runs its instructions in order, so a send of
  round r is always received in a later round. Two transports carry the
  same streams: :class:`LocalTransport` (every stage of a data replica
  in one process, each on its device from a list: one controller, the
  counterpart of JAX's single controller) and :class:`ProcessTransport`
  (one process a stage rank: ``isend`` / blocking ``recv`` over the pair
  groups, gloo on the CPU and NCCL across cards; a send is waited for one
  round after it was issued, by when its receiver has posted the
  receive, so no pair deadlocks). Both count messages and bytes a call.
- **Dropout.** Micro-batch m's seed is the plain engine's,
  ``fold_in_seed(step_seed, m)``. Attention dropout keys each body layer
  by its global index, as the unpipelined model does; the hidden-dropout
  generator is the plain model's on stage 0 and
  ``fold_in_seed(seed, PIPE_STAGE_STREAM + s)``'s on stage s > 0. JAX
  draws its pipeline's seeds from ``jax.random`` (per micro-batch,
  stage, section and layer), which cannot be matched.

:func:`sequential_loss_fn` is the oracle: the same stage modules run one
micro-batch at a time through every stage, each micro-batch's backward
right after its forward.
"""

import collections
import contextlib
import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.ops.flash_attention import (
    dropout_generator,
    fold_in_seed,
    global_rows,
)
from deepspeed_tpu_torch.runtime.pipe import schedule as sched
from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, TiedLayerSpec

# folded into a micro-batch's seed for the hidden-dropout generator of
# stage s > 0 (stage 0 draws the unpipelined model's stream)
PIPE_STAGE_STREAM = 0x50495045


def _leaves(x):
    """An activation's tensors: the tuple's, or the tensor itself."""
    return list(x) if isinstance(x, tuple) else [x]


def _like(x, leaves):
    """``leaves`` in the structure of activation ``x``."""
    return tuple(leaves) if isinstance(x, tuple) else leaves[0]


def _to(x, device):
    return _like(x, [t.to(device) for t in _leaves(x)])


def _detach(x):
    return _like(x, [t.detach() for t in _leaves(x)])


def _spec_signature(spec: LayerSpec):
    """Two specs with the same signature build structurally-identical
    layers (the homogeneous body)."""
    return (spec.typename, spec.module_args,
            tuple(sorted(spec.module_kwargs.items())),
            isinstance(spec, TiedLayerSpec))


def split_specs(specs: List[LayerSpec]):
    """(prologue, body, epilogue): body = the longest run of
    signature-identical non-tied specs."""
    best_lo, best_hi = 0, 0
    i = 0
    while i < len(specs):
        if isinstance(specs[i], TiedLayerSpec):
            i += 1
            continue
        j = i
        sig = _spec_signature(specs[i])
        while j < len(specs) and _spec_signature(specs[j]) == sig:
            j += 1
        if j - i > best_hi - best_lo:
            best_lo, best_hi = i, j
        i = j
    return specs[:best_lo], specs[best_lo:best_hi], specs[best_hi:]


class PipeContext:
    """One micro-batch's forward on one stage: its dropout ``seed`` (None:
    no dropout), the ``stage_id``, the global index of the body ``layer``
    being run (None outside the body) and the stage's hidden-dropout
    ``generator`` (a checkpointed chunk's recompute replays it)."""

    def __init__(self, seed, stage_id, layer=None, generator=None):
        self.seed = seed
        self.stage_id = stage_id
        self.layer = layer
        self.generator = generator

    @classmethod
    def for_stage(cls, seed, stage_id, device):
        if seed is None:
            return cls(None, stage_id)
        stream = seed if stage_id == 0 else \
            fold_in_seed(seed, PIPE_STAGE_STREAM + stage_id)
        return cls(int(seed), stage_id,
                   generator=dropout_generator(stream, device))

    def at_layer(self, i):
        return PipeContext(self.seed, self.stage_id, i, self.generator)


def _call(layer, x, ctx):
    if getattr(layer, "pipe_context", False):
        return layer(x, ctx=ctx)
    return layer(x)


def _hooked(layer, fn, x):
    """``fn()`` run inside ``layer``'s forward hooks, as a call of the
    layer would run: a tied layer's ``forward_fn`` reads its params
    without calling it, and ZeRO stage 3's installer gathers them in a
    pre-hook and releases them in a post-hook."""
    args = (x,)
    for hook in layer._forward_pre_hooks.values():
        hook(layer, args)
    out = fn()
    for hook in layer._forward_hooks.values():
        hook(layer, args, out)
    return out


def _seeded_init(layer, seed):
    """Initialize ``layer`` from ``seed`` on the CPU: its
    ``reset_parameters(generator=...)`` where it takes one, else its own
    ``reset_parameters()`` under a forked, seeded global RNG."""
    reset = getattr(layer, "reset_parameters", None)
    if reset is None:
        return
    seed = int(seed) & 0xFFFFFFFF
    gen = torch.Generator()
    gen.manual_seed(seed)
    try:
        reset(generator=gen)
    except TypeError:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            reset()


class StageModule(nn.Module):
    """One stage's layers: ``prologue`` (stage 0, by ``layer_<idx>``),
    ``body`` (``L/S`` layers, local index), ``epilogue`` (last stage) and
    ``tied`` (a copy of each tied layer this stage uses, by key)."""

    def __init__(self, parts, stage_id):
        super().__init__()
        self.stage_id = int(stage_id)
        self.num_stages = parts.num_stages
        self.is_first = self.stage_id == 0
        self.is_last = self.stage_id == parts.num_stages - 1
        self.first_layer = self.stage_id * parts.layers_per_stage
        self.checkpoint_interval = int(parts.checkpoint_interval or 0)
        self.prologue = nn.ModuleDict()
        self.body = nn.ModuleList()
        self.epilogue = nn.ModuleDict()
        self.tied = nn.ModuleDict()
        self._pro, self._epi = [], []     # (spec, section, name)

    def _run_layer(self, spec, section, name, x, ctx):
        if isinstance(spec, TiedLayerSpec):
            layer = self.tied[spec.key]
            if spec.forward_fn is not None:
                return _hooked(layer, lambda: spec.forward_fn(layer, x), x)
        else:
            layer = getattr(self, section)[name]
        return _call(layer, x, ctx)

    def _chunk(self, lo, hi):
        def run(x, ctx):
            for j in range(lo, hi):
                x = _call(self.body[j], x, ctx.at_layer(self.first_layer + j))
            return x
        return run

    def run_body(self, x, ctx):
        n = len(self.body)
        k = self.checkpoint_interval
        if k <= 0 or not torch.is_grad_enabled():
            return self._chunk(0, n)(x, ctx)
        from deepspeed_tpu_torch.runtime.activation_checkpointing.\
            checkpointing import checkpoint
        for lo in range(0, n, k):
            x = checkpoint(self._chunk(lo, min(lo + k, n)), x, ctx)
        return x

    def forward(self, x, ctx=None):
        """Stage 0 takes the micro-batch, the others the received
        activation; the last stage returns the model output (what
        ``loss_fn`` takes), the others the activation to send."""
        if ctx is None:
            ctx = PipeContext(None, self.stage_id)
        if self.is_first:
            for spec, section, name in self._pro:
                x = self._run_layer(spec, section, name, x, ctx)
        x = self.run_body(x, ctx)
        if self.is_last:
            for spec, section, name in self._epi:
                x = self._run_layer(spec, section, name, x, ctx)
        return x


@dataclasses.dataclass
class PipelineParts:
    """The stages this process builds, from a PipelineModule."""
    num_stages: int
    layers_per_stage: int
    prologue_specs: List[LayerSpec]
    body_specs: List[LayerSpec]
    epilogue_specs: List[LayerSpec]
    loss_fn: Callable
    checkpoint_interval: int
    stages: Dict[int, StageModule]

    def tied_holders(self, key):
        """The stage ids that hold a copy of tied key ``key``."""
        out = []
        if any(isinstance(s, TiedLayerSpec) and s.key == key
               for s in self.prologue_specs):
            out.append(0)
        if any(isinstance(s, TiedLayerSpec) and s.key == key
               for s in self.epilogue_specs) and \
                self.num_stages - 1 not in out:
            out.append(self.num_stages - 1)
        return out

    def tied_keys(self):
        keys = []
        for spec in self.prologue_specs + self.epilogue_specs:
            if isinstance(spec, TiedLayerSpec) and spec.key not in keys:
                keys.append(spec.key)
        return keys


def build_pipeline_parts(module, num_stages, seed=0, stage_ids=None,
                         init=True):
    """Build the :class:`StageModule` of each of ``stage_ids`` (default:
    all) on the CPU, with the layer seeds of the module docstring
    (``init=False`` leaves the params as the layers' constructors make
    them, for a caller that loads weights next)."""
    pro_specs, body_specs, epi_specs = split_specs(module.specs)
    if not body_specs:
        raise ValueError("PipelineModule needs a homogeneous run of layer "
                         "specs to pipeline (the transformer blocks)")
    if len(body_specs) % num_stages != 0:
        raise ValueError(
            f"{len(body_specs)} pipelined layers do not divide evenly over "
            f"{num_stages} stages; adjust n_layer or the pipe axis")
    if module.loss_fn is None:
        raise ValueError("PipelineModule.loss_fn required for training")
    lps = len(body_specs) // num_stages
    stage_ids = list(range(num_stages)) if stage_ids is None \
        else [int(s) for s in stage_ids]
    parts = PipelineParts(
        num_stages=num_stages, layers_per_stage=lps,
        prologue_specs=pro_specs, body_specs=body_specs,
        epilogue_specs=epi_specs, loss_fn=module.loss_fn,
        checkpoint_interval=module.activation_checkpoint_interval,
        stages={})

    def layer_seed(i):
        if module.seed_layers:
            return module.base_seed + i
        return fold_in_seed(seed, i)

    # each spec's seed index; a tied key takes its first occurrence's
    index, first_tied, idx = [], {}, 0
    for spec in module.specs:
        if isinstance(spec, TiedLayerSpec):
            first_tied.setdefault(spec.key, idx)
            index.append(first_tied[spec.key])
        else:
            index.append(idx)
        idx += 1
    n_pro, n_body = len(pro_specs), len(body_specs)

    def built(spec, i):
        layer = spec.build()
        if init:
            _seeded_init(layer, layer_seed(index[i]))
        return layer

    for s in stage_ids:
        stage = StageModule(parts, s)
        sections = []
        if stage.is_first:
            sections.append(("prologue", stage._pro, pro_specs, 0))
        if stage.is_last:
            sections.append(("epilogue", stage._epi, epi_specs,
                             n_pro + n_body))
        for section, order, specs, base in sections:
            for idx, spec in enumerate(specs):
                if isinstance(spec, TiedLayerSpec):
                    if spec.key not in stage.tied:
                        stage.tied[spec.key] = built(spec, base + idx)
                    order.append((spec, section, spec.key))
                else:
                    name = f"layer_{idx}"
                    getattr(stage, section)[name] = built(spec, base + idx)
                    order.append((spec, section, name))
        for j in range(lps):
            g = s * lps + j
            stage.body.append(built(body_specs[g], n_pro + g))
        parts.stages[s] = stage
    return parts


# ---------------------------------------------------------------------------
# the pipe layout of the params
# ---------------------------------------------------------------------------

def _body_name(name):
    """``body.<j>.<rest>`` -> ``(j, rest)``, else None."""
    parts = name.split(".", 2)
    if parts[0] != "body" or len(parts) < 3:
        return None
    return int(parts[1]), parts[2]


def to_pipe_layout(named, num_stages, layers_per_stage):
    """``{stage_id: {stage param name: tensor}}`` of every stage ->
    the flat pipe layout (body leaves stacked ``[S, L/S, ...]``, a tied
    leaf from the first stage holding it)."""
    out, body = {}, {}
    for s in sorted(named):
        for name, t in named[s].items():
            b = _body_name(name)
            if b is None:
                out.setdefault(name, t)
            else:
                body.setdefault(b[1], {})[(s, b[0])] = t
    for rest, by in body.items():
        rows = [torch.stack([torch.as_tensor(by[(s, j)])
                             for j in range(layers_per_stage)])
                for s in range(num_stages)]
        out[f"body.{rest}"] = torch.stack(rows)
    return out


def restage(leaf, num_stages, layers_per_stage, name="body"):
    """A stacked body leaf ``[S0, L0, ...]`` as ``[S, L/S, ...]``: only the
    leading ``[stages, layers/stage]`` split may change (JAX
    ``engine.py:3083-3120``)."""
    leaf = torch.as_tensor(np.asarray(leaf)) if not torch.is_tensor(leaf) \
        else leaf
    want = (num_stages, layers_per_stage)
    if tuple(leaf.shape[:2]) == want:
        return leaf
    if leaf.ndim < 3 or leaf.shape[0] * leaf.shape[1] != \
            num_stages * layers_per_stage:
        raise ValueError(
            f"checkpoint leaf {name} has shape {tuple(leaf.shape)}, engine "
            f"expects {want + tuple(leaf.shape[2:])}: not a pipeline "
            "restage (only the leading [stages, layers/stage] dims may "
            "refactor) — checkpoint is from a different model")
    return leaf.reshape(want + tuple(leaf.shape[2:]))


def stage_view(pipe_state, stage, num_stages, layers_per_stage):
    """The pipe-layout mapping ``pipe_state`` as stage ``stage``'s param
    names (``stage`` a :class:`StageModule`; body leaves restaged)."""
    out = {}
    for name, _ in stage.named_parameters():
        b = _body_name(name)
        if b is None:
            if name not in pipe_state:
                raise ValueError(f"pipe state has no leaf {name!r}")
            out[name] = pipe_state[name]
        else:
            key = f"body.{b[1]}"
            if key not in pipe_state:
                raise ValueError(f"pipe state has no leaf {key!r}")
            stacked = restage(pipe_state[key], num_stages, layers_per_stage,
                              key)
            out[name] = stacked[stage.stage_id, b[0]]
    return out


def stage_state(stage):
    """A copy of a stage's params by name: a snapshot that later steps do
    not change and that does not keep the stage's tensors alive."""
    return {n: p.detach().clone() for n, p in stage.named_parameters()}


@torch.no_grad()
def load_stage_state(stage, pipe_state, num_stages, layers_per_stage):
    """Copy the pipe-layout ``pipe_state`` (whole leaves) into ``stage``'s
    params (a tensor-parallel leaf takes its model rank's rows)."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import shard_tensor
    view = stage_view(pipe_state, stage, num_stages, layers_per_stage)
    for name, p in stage.named_parameters():
        src = view[name]
        src = torch.as_tensor(np.asarray(src)) if not torch.is_tensor(src) \
            else src
        axis = getattr(p, "tp_axis", None)
        if axis is not None and axis.size > 1:     # a TP leaf: its rows
            src = shard_tensor(src, p.tp_shard, axis.rank, axis.size)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"pipe state leaf {name} has shape "
                             f"{tuple(src.shape)}, the stage "
                             f"{tuple(p.shape)}")
        p.copy_(src.to(p.dtype))


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

SCALAR_LOSS_AT_SEQ = (
    "pipeline on a mesh with seq > 1 requires the weighted "
    "(loss_sum, weight) loss form: a scalar mean loss cannot "
    "express seq-sharded token counts, so losses and grads "
    "would be silently mis-scaled by the seq degree")


def _as_pair(res, seq=1):
    if isinstance(res, tuple):
        num, den = res
        return num.float(), torch.as_tensor(den).float()
    if seq > 1:
        raise ValueError(SCALAR_LOSS_AT_SEQ)
    return res.float(), torch.ones((), dtype=torch.float32,
                                   device=res.device)


def sequential_loss_fn(parts, micro_batches, seeds=None, scale=None,
                       stages=None, row_offset=0, data_rank=0, seq=1):
    """The non-pipelined execution of the same stage modules: each
    micro-batch through every stage in order, its loss pair from the last
    one. Returns ``(sum(loss_sum), sum(weight))`` (f32 0-d tensors; the
    loss is their ratio, JAX ``pipeline.py:343-372``). With ``scale`` each
    micro-batch's ``loss_sum * scale`` is differentiated right after its
    forward (into the params' ``.grad``, in micro-batch order).
    ``stages`` (default ``parts.stages``) maps every stage id to its
    :class:`StageModule` or :class:`LocalStage` (whose scopes the
    forwards and the backward then run in)."""
    stages = parts.stages if stages is None else stages
    local = [st if isinstance(st, LocalStage) else
             LocalStage(st, next(st.parameters()).device)
             for _, st in sorted(stages.items())]
    num = den = None
    grad = torch.enable_grad() if scale is not None else torch.no_grad()
    with grad, global_rows(row_offset, data_rank):
        for m, micro in enumerate(micro_batches):
            seed = None if seeds is None else seeds[m]
            x = micro
            for st in local:
                x = {k: v.to(st.device) for k, v in x.items()} \
                    if st.stage_id == 0 else _to(x, st.device)
                with st.forward_scope():
                    x = st.module(x, PipeContext.for_stage(
                        seed, st.stage_id, st.device))
                    if st.stage_id == parts.num_stages - 1:
                        n, d = _as_pair(parts.loss_fn(x, {
                            k: v.to(st.device) for k, v in micro.items()}),
                            seq)
            if scale is not None:
                with contextlib.ExitStack() as scopes:
                    for st in local:
                        scopes.enter_context(st.backward_scope())
                    (n * scale).backward()
            n, d = n.detach(), d.detach()
            num = n if num is None else num + n
            den = d if den is None else den + d
    return num, den


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

class _Counts:
    def __init__(self):
        self.reset()

    def reset(self):
        self.messages = 0
        self.bytes = 0
        self.meta_messages = 0

    def add(self, x):
        for t in _leaves(x):
            self.messages += 1
            self.bytes += t.numel() * t.element_size()

    def snapshot(self):
        return {"messages": self.messages, "bytes": self.bytes,
                "meta_messages": self.meta_messages}


class LocalTransport:
    """Every stage of a data replica in this process: a send queues the
    tensor for the neighbour stage, which takes it in a later round on
    its own device. Counts what a stage-to-stage link would carry."""

    def __init__(self):
        self.counts = _Counts()
        self._queues = collections.defaultdict(collections.deque)

    def begin(self):
        self._queues.clear()
        self.counts.reset()

    def _send(self, kind, dst, m, t):
        self.counts.add(t)
        self._queues[(kind, dst)].append((m, t))

    def _recv(self, kind, dst, m, device):
        q = self._queues[(kind, dst)]
        if not q:
            raise RuntimeError(f"stage {dst}: no {kind} for micro-batch "
                               f"{m} has been sent")
        got, t = q.popleft()
        if got != m:
            raise RuntimeError(f"stage {dst}: {kind} of micro-batch {got} "
                               f"arrived where {m} was expected")
        return _to(t, device)

    def send_act(self, src, m, t):
        self._send("act", src + 1, m, t)

    def recv_act(self, dst, m, device):
        return self._recv("act", dst, m, device)

    def send_grad(self, src, m, t):
        self._send("grad", src - 1, m, t)

    def recv_grad(self, dst, m, like):
        return self._recv("grad", dst, m, _leaves(like)[0].device)

    def end_round(self, r):
        pass

    def finish(self):
        if any(self._queues.values()):
            raise RuntimeError("pipeline messages left unreceived")


_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_META_LEAF = 8          # dtype, ndim, up to 6 dims
_META_LEAVES = 4
_META_LEN = 1 + _META_LEAF * _META_LEAVES


class ProcessTransport:
    """One process a stage rank: ``isend`` and blocking ``recv`` with the
    neighbour stage's global rank, over the pair's process group. An
    activation's shape and dtype go ahead of the first one of each call
    (a meta message, counted apart). Over gloo a CUDA tensor crosses
    through a host copy (gloo's point-to-point reads host memory only:
    the ranks of one card, ``parallel/mesh.py:check_backend``)."""

    def __init__(self, grid, device):
        self.counts = _Counts()
        self.grid = grid
        self.device = device
        s, S = grid.stage_id, grid.pipe_parallel_size
        self.prev = grid.stage_to_global(s - 1) if s > 0 else None
        self.next = grid.stage_to_global(s + 1) if s < S - 1 else None
        self._pending = []          # (round, work, tensor) of the sends
        self._round = 0
        self._meta_sent = False
        self._meta = None
        import torch.distributed as dist
        self._host = torch.device(device).type == "cuda" and \
            dist.is_initialized() and \
            str(dist.get_backend()).lower() == "gloo"

    def _group(self, peer):
        me = self.grid.global_rank
        return self.grid.p2p_process_groups[tuple(sorted((me, peer)))]

    def begin(self):
        self._meta_sent = False
        self._meta = None
        self.counts.reset()

    def _isend(self, t, peer):
        import torch.distributed as dist
        t = t.cpu() if self._host else t.contiguous()
        work = dist.isend(t, peer, group=self._group(peer))
        self._pending.append((self._round, work, t))

    def _recv_into(self, buf, peer):
        import torch.distributed as dist
        into = torch.empty_like(buf, device="cpu") if self._host else buf
        dist.irecv(into, peer, group=self._group(peer)).wait()
        if self._host:
            buf.copy_(into)
        return buf

    def send_act(self, src, m, x):
        leaves = _leaves(x)
        if not self._meta_sent:
            # one message: the leaf count (0: a plain tensor), then each
            # leaf's dtype, rank and shape
            meta = torch.zeros(_META_LEN, dtype=torch.int64)
            meta[0] = len(leaves) if isinstance(x, tuple) else 0
            for i, t in enumerate(leaves):
                o = 1 + i * _META_LEAF
                meta[o] = _DTYPES.index(t.dtype)
                meta[o + 1] = t.ndim
                meta[o + 2:o + 2 + t.ndim] = torch.tensor(t.shape)
            self._isend(meta.to(leaves[0].device), self.next)
            self.counts.meta_messages += 1
            self._meta_sent = True
        self.counts.add(x)
        for t in leaves:
            self._isend(t, self.next)

    def recv_act(self, dst, m, device):
        if self._meta is None:
            meta = self._recv_into(torch.zeros(
                _META_LEN, dtype=torch.int64, device=self.device), self.prev)
            meta = meta.tolist()
            k = meta[0]
            self._meta = (k > 0, [
                (_DTYPES[meta[o]], tuple(meta[o + 2:o + 2 + meta[o + 1]]))
                for o in (1 + i * _META_LEAF for i in range(max(k, 1)))])
        is_tuple, leaves = self._meta
        got = [self._recv_into(torch.empty(shape, dtype=dtype,
                                           device=self.device), self.prev)
               for dtype, shape in leaves]
        return tuple(got) if is_tuple else got[0]

    def send_grad(self, src, m, x):
        self.counts.add(x)
        for t in _leaves(x):
            self._isend(t, self.prev)

    def recv_grad(self, dst, m, like):
        return _like(like, [self._recv_into(torch.empty_like(t), self.next)
                            for t in _leaves(like)])

    def end_round(self, r):
        """Wait for the sends issued before round ``r``: their receivers
        post the receives in round ``r`` at the latest."""
        self._round = r + 1
        keep = []
        for rr, work, t in self._pending:
            if rr < r:
                work.wait()
            else:
                keep.append((rr, work, t))
        self._pending = keep

    def finish(self):
        for _, work, _ in self._pending:
            work.wait()
        self._pending = []
        self._round = 0


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class LocalStage:
    """A stage this process runs: its module, device, and the scopes its
    forward and backward run in (the stage engine's param installer)."""

    def __init__(self, module, device, forward_scope=None,
                 backward_scope=None):
        self.module = module
        self.stage_id = module.stage_id
        self.device = torch.device(device)
        self.forward_scope = forward_scope or contextlib.nullcontext
        self.backward_scope = backward_scope or contextlib.nullcontext


_REDUCTIONS = (sched.ReduceTiedGrads, sched.ReduceGrads,
               sched.OptimizerStep)


class PipeExecutor:
    """Runs the instruction streams of the local stages, round by round
    (module docstring). ``stages``: the :class:`LocalStage` list in stage
    order; ``transport``: :class:`LocalTransport` or
    :class:`ProcessTransport`; ``loss_fn(output, micro)``."""

    def __init__(self, stages, num_stages, transport, loss_fn, seq=1):
        self.stages = list(stages)
        self.num_stages = int(num_stages)
        self.transport = transport
        self.loss_fn = loss_fn
        self.seq = int(seq)             # the seq axis size
        self.max_in_flight = {}      # stage -> most micro-batches held

    def _streams(self, schedule_cls, M):
        if self.num_stages == 1 and schedule_cls is sched.TrainSchedule:
            schedule_cls = sched.DataParallelSchedule
        return {st.stage_id: list(schedule_cls(M, self.num_stages,
                                               st.stage_id).steps())
                for st in self.stages}

    def run(self, micro_batches, train, seeds=None, scale=None,
            row_offset=0, data_rank=0):
        """Every micro-batch through the local stages: the 1F1B stream
        (``train``, with each backward seeded by ``scale``) or the
        inference one (no grad). ``micro_batches``: the list of this data
        replica's micro-batches (None entries where this process does not
        load them). Returns ``(sum(loss_sum), sum(weight))`` over the
        micro-batches on the last stage (zeros elsewhere)."""
        M = len(micro_batches)
        streams = self._streams(
            sched.TrainSchedule if train else sched.InferenceSchedule, M)
        self.transport.begin()
        self.max_in_flight = {st.stage_id: 0 for st in self.stages}
        dev = self.stages[-1].device
        self._num = torch.zeros((), dtype=torch.float32, device=dev)
        self._den = torch.zeros((), dtype=torch.float32, device=dev)
        self._bufs = {st.stage_id: {} for st in self.stages}
        self._live = {st.stage_id: 0 for st in self.stages}
        n_rounds = max(len(v) for v in streams.values())
        grad = torch.enable_grad() if train else torch.no_grad()
        with grad, global_rows(row_offset, data_rank):
            for r in range(n_rounds):
                for st in self.stages:
                    steps = streams[st.stage_id]
                    if r < len(steps):
                        for cmd in steps[r]:
                            if not isinstance(cmd, _REDUCTIONS):
                                self._exec(st, cmd, micro_batches, train,
                                           seeds, scale)
                self.transport.end_round(r)
        self.transport.finish()
        self._bufs = None
        return self._num, self._den

    def _exec(self, st, cmd, micro_batches, train, seeds, scale):
        s = st.stage_id
        first, last = s == 0, s == self.num_stages - 1
        buf = self._bufs[s]
        b, m = cmd.buffer_id, cmd.micro_batch_id
        if isinstance(cmd, sched.LoadMicroBatch):
            micro = micro_batches[m]
            buf[b] = {"m": m, "micro": {k: v.to(st.device)
                                        for k, v in micro.items()}}
        elif isinstance(cmd, sched.RecvActivation):
            x = _detach(self.transport.recv_act(s, m, st.device))
            if train:
                for t in _leaves(x):
                    if t.is_floating_point():
                        t.requires_grad_(True)
            buf.setdefault(b, {"m": m})["x"] = x
        elif isinstance(cmd, sched.ForwardPass):
            slot = buf[b]
            micro = slot.pop("micro", None)
            ctx = PipeContext.for_stage(
                None if seeds is None else seeds[m], s, st.device)
            with st.forward_scope():
                out = st.module(micro if first else slot["x"], ctx)
                if last:
                    num, den = _as_pair(self.loss_fn(out, micro), self.seq)
            if last:
                self._num += num.detach().to(self._num.device)
                self._den += den.detach().to(self._den.device)
                slot["loss"] = num
            else:
                slot["out"] = out
            if train:
                self._live[s] += 1
                self.max_in_flight[s] = max(self.max_in_flight[s],
                                            self._live[s])
            elif last:
                buf.pop(b)
        elif isinstance(cmd, sched.SendActivation):
            slot = buf[b]
            self.transport.send_act(s, m, _detach(slot["out"]))
            if not train:
                buf.pop(b)
        elif isinstance(cmd, sched.RecvGrad):
            buf[b]["gout"] = self.transport.recv_grad(s, m, buf[b]["out"])
        elif isinstance(cmd, sched.BackwardPass):
            slot = buf.pop(b)
            with st.backward_scope():
                if last:
                    (slot["loss"] * scale).backward()
                else:
                    pairs = [(o, g) for o, g in zip(_leaves(slot["out"]),
                                                    _leaves(slot["gout"]))
                             if o.requires_grad]
                    torch.autograd.backward([o for o, _ in pairs],
                                            [g for _, g in pairs])
            self._live[s] -= 1
            if not first:
                x = slot["x"]
                buf[b] = {"m": m, "gin": _like(x, [
                    t.grad if t.grad is not None else torch.zeros_like(t)
                    for t in _leaves(x)])}
        elif isinstance(cmd, sched.SendGrad):
            self.transport.send_grad(s, m, buf.pop(b)["gin"])
        else:
            raise RuntimeError(f"unknown pipeline instruction {cmd!r}")
