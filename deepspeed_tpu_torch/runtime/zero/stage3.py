"""The params a training forward sees: compute-dtype copies of the fp32
masters, installed into the model for the forward (port of the JAX
engine's ``cast_params``, ``engine.py:223``, and of
``deepspeed_tpu/runtime/zero/stage3.py``'s gather-on-use).

The JAX engine casts the whole fp32 param tree to the compute dtype
before the model runs, so every leaf (LayerNorm scales included) enters
the model rounded to bf16 or fp16, and the gradient of a leaf used twice
(GPT-2's tied ``wte``) is summed in the compute dtype before it widens
to fp32. :class:`ParamInstaller` does the same here, in one of two modes:

- **cast** (stages 0-2 under bf16 / fp16): at the start of the forward
  every master is cast (``.to(dtype)``, differentiable) and the copy is
  put in its module's place; the masters go back when the forward ends.
- **gather on use** (stage 3): the params live only as each rank's fp32
  pieces. Just before a module runs, each of its pieces is cast to the
  compute dtype and then all-gathered (cast-then-gather: the wire moves
  16-bit, ``sharding.py:124-163``), in the order the modules first ran;
  with ``prefetch`` the next module's gathers are issued before this
  one's run (``async_op``; each is waited on before its use). A
  module's gathered copies are dropped when it returns (the root
  module's, which the loss may read after the model returns, when the
  loss does). The gradient is a custom ``autograd.Function``
  (:class:`_GatherCast`): its backward casts the cotangent to fp32
  first, then reduce-scatters it into the piece's gradient (the
  ``custom_vjp`` of ``stage3.py:158-171``); a tied leaf's uses sum into
  one cotangent, so one reduce-scatter a leaf and micro-batch.

The gathered copies are not kept from the forward to the backward (the
JAX ``zero3_remat_policy``, ``stage3.py:55-62``): ``saved_tensors_hooks``
pack a saved view of a gathered copy as its leaf and geometry, and the
backward gathers the leaf again. Each module's leaves are gathered again
once, when the gradient reaches the module's output (a tensor hook: the
DeepSpeed stage-3 pre-backward gather); an unpack, or the recompute of a
checkpointed block (``models/gpt2.py:remat_block``), takes the same
copy. So every sharded leaf is gathered twice per micro-batch, once each
way. A leaf the rule leaves replicated is cast, not gathered, and its
gradient is all-reduced.

The fp8 wire (``fp8.wire``, JAX ``stage3.py:80-142`` and
``collectives.py:_wire_all_gather_monolithic``): each gather, forward
and backward, moves the rank's compute-dtype piece encoded by
``runtime/comm/codecs.py:encode_wire`` (per-chunk scales packed with the
payload, one uint8 all-gather); every other rank's row is decoded into
its slot and the rank's own piece is placed exactly. The backward
reduce-scatter stays full precision.

A ``scan_layers`` stack installs as one unit: its leaves' ``unit`` is
the stack module (``install_as_one``), whose call gathers them all.
"""

import contextlib
import dataclasses
import weakref

import torch


@dataclasses.dataclass(frozen=True)
class Zero3Plan:
    """Static facts of the gather-on-use schedule (JAX
    ``stage3.py:65-80``)."""
    gather_leaves: int           # sharded leaves gathered per use
    gather_chunks: int           # ring stripes per leaf (1 = all-gather)
    prefetch: bool               # next module's gathers issued early
    bidirectional: bool          # alternate ring direction per stripe
    max_gather_bytes: int        # largest single gathered leaf
    total_gather_bytes: int      # all gathered leaves (compute dtype)
    wire_dtype: str = None       # codec name when gathers move quantized

    def to_dict(self):
        return dataclasses.asdict(self)


class _Leaf:
    __slots__ = ("module", "name", "param", "master", "part", "unit")

    def __init__(self, module, name, param, master, part, unit=None):
        self.module = module      # the module owning the param
        self.name = name          # its attribute name there
        self.param = param        # the module's Parameter object
        self.master = master      # fp32 master: the Parameter or a piece
        self.part = part          # Partition (gather mode) or None
        # the module whose call installs it (``install_as_one``)
        self.unit = module if unit is None else unit


class _SavedGathered:
    """A saved view of a gathered copy, held as its leaf and geometry."""
    __slots__ = ("idx", "size", "stride", "offset")

    def __init__(self, idx, t):
        self.idx = idx
        self.size = tuple(t.size())
        self.stride = t.stride()
        self.offset = t.storage_offset()


class _GatherCast(torch.autograd.Function):
    """piece (fp32) -> the whole leaf in the compute dtype; backward:
    the cotangent to fp32, then reduce-scattered into the piece (or
    all-reduced, for a replicated leaf)."""

    @staticmethod
    def forward(ctx, piece, owner, idx):
        ctx.owner, ctx.idx = owner, idx
        return owner._gather(idx)

    @staticmethod
    def backward(ctx, grad):
        return ctx.owner._reduce_grad(ctx.idx, grad), None, None


class _Finishing:
    """A collective's handle whose ``wait()`` also runs ``finish``."""

    def __init__(self, work, finish):
        self.work, self.finish = work, finish

    def wait(self):
        self.work.wait()
        self.finish()


class ParamInstaller:
    """Puts compute-dtype params into ``model`` for each forward.

    ``leaves`` is a list of ``(module, name, param, master, part)``:
    ``master`` is the fp32 tensor the optimizer updates (the Parameter
    itself in cast mode, the rank's piece in gather mode) and ``part``
    its :class:`~deepspeed_tpu_torch.runtime.zero.sharding.Partition`
    (gather mode only), optionally followed by the ``unit`` module whose
    call installs it. ``comm`` is the engine's
    :class:`~deepspeed_tpu_torch.runtime.zero.comm.Comm`; ``wire_dtype``
    (a codec name) quantizes gather mode's all-gathers in chunks of
    ``wire_chunk``.
    """

    def __init__(self, model, leaves, dtype, comm, gather, prefetch=True,
                 gather_chunks=1, bidirectional=False, wire_dtype=None,
                 wire_chunk=512):
        self.model = model
        self.wire_dtype = wire_dtype if gather else None
        self.wire_chunk = int(wire_chunk)
        self.dtype = dtype
        self.comm = comm
        self.gather = bool(gather)
        self.prefetch = bool(prefetch) and self.gather
        # each gather striped into this many collectives
        # (``Comm.all_gather_striped``)
        self.gather_chunks = int(gather_chunks)
        self.bidirectional = bool(bidirectional)
        self.leaves = [_Leaf(*x) for x in leaves]
        self._by_module = {}
        for i, leaf in enumerate(self.leaves):
            self._by_module.setdefault(leaf.unit, []).append(i)
        self._installed = {}      # idx -> the tensor in the module's place
        self._live = {}           # gathered storage ptr -> idx (forward)
        self._live_of = {}        # idx -> its gathered storage ptr
        self._bwd = {}            # idx -> regathered flat copy (backward)
        self._cast = {}           # idx -> cast copy of the last forward
        self._pending = {}        # idx -> (flat, work, source): prefetches
        self._order = []          # modules in the order they first ran
        self._pos = {}
        self._recorded = False
        self._phase = None        # "forward" | "backward" | None
        self.gathers = 0          # forward gathers (prefetches included)
        self.regathers = 0        # backward gathers
        if self.gather:
            # the model holds the hooks; they hold this installer (and its
            # pieces) weakly, so a dropped engine frees them
            ref = weakref.ref(self)

            def pre(module, args):
                inst = ref()
                if inst is not None:
                    inst._pre_hook(module, args)

            def post(module, args, out):
                inst = ref()
                if inst is not None:
                    inst._post_hook(module, args, out)

            for module in self._by_module:
                module.register_forward_pre_hook(pre)
                module.register_forward_hook(post)
            self.plan = self._make_plan()
        else:
            self.plan = None

    def _make_plan(self):
        item = torch.empty((), dtype=self.dtype).element_size()
        sizes = [leaf.part.numel * item for leaf in self.leaves
                 if leaf.part.sharded]
        return Zero3Plan(
            gather_leaves=len(sizes), gather_chunks=self.gather_chunks,
            prefetch=self.prefetch, bidirectional=self.bidirectional,
            max_gather_bytes=max(sizes, default=0),
            total_gather_bytes=sum(sizes), wire_dtype=self.wire_dtype)

    # -- scopes -------------------------------------------------------------
    @contextlib.contextmanager
    def forward(self):
        """The scope of one loss computation: params installed, and in
        gather mode the saved-tensor hooks that keep gathered copies out
        of the autograd graph."""
        self._phase = "forward"
        hooks = contextlib.nullcontext()
        if self.gather and torch.is_grad_enabled():
            hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, self._unpack)
        try:
            if not self.gather:
                for i in range(len(self.leaves)):
                    self._install(i, self.leaves[i].master.to(self.dtype))
                if torch.is_grad_enabled():
                    # the backward's recompute runs on these copies
                    self._cast = dict(self._installed)
            with hooks:
                yield
        finally:
            for i in list(self._installed):
                self._release(i)
            for flat, work, _ in self._pending.values():
                if work is not None:
                    work.wait()
            self._pending.clear()
            self._live.clear()
            self._live_of.clear()
            if self._order:
                self._recorded = True
            self._phase = None

    @contextlib.contextmanager
    def backward(self):
        """The scope of one backward: gathers here are regathers. In cast
        mode the last forward's copies are put back for it, so a
        checkpointed block's recompute reads the tensors its forward
        read (a selective checkpoint's op log sees no cast it did not
        see in the forward)."""
        self._phase = "backward"
        try:
            for i, t in self._cast.items():
                self._install(i, t)
            self._cast = {}
            yield
        finally:
            # a checkpointed block's recompute stops once it has what the
            # backward needs, so its last modules may never return
            for i in list(self._installed):
                self._release(i)
            self._bwd.clear()
            self._phase = None

    # -- install / release ---------------------------------------------------
    def _install(self, i, t):
        leaf = self.leaves[i]
        leaf.module._parameters[leaf.name] = t
        self._installed[i] = t

    def _release(self, i):
        leaf = self.leaves[i]
        leaf.module._parameters[leaf.name] = leaf.param
        self._installed.pop(i, None)
        # once released the copy may be freed and its address reused by
        # an activation, which must then be saved as itself
        ptr = self._live_of.pop(i, None)
        if ptr is not None:
            self._live.pop(ptr, None)

    def _pre_hook(self, module, args):
        # the installing ops stay out of any dispatch mode (a selective
        # checkpoint's op log must see the same ops in the forward and
        # in the recompute, and the two install differently)
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            self._install_module(module)

    def _install_module(self, module):
        idxs = self._by_module[module]
        if self._phase == "backward":
            # a checkpointed block's recompute: the backward's copies,
            # requiring grad as in the forward so the same tensors are
            # saved
            grad = torch.is_grad_enabled()
            for i in idxs:
                leaf = self.leaves[i]
                if leaf.part.sharded:
                    t = leaf.part.from_gathered(self._regathered(i))
                    t = t.detach().requires_grad_(grad)
                else:
                    t = leaf.master.to(self.dtype, copy=True)
                self._install(i, t)
            return
        if not self._recorded and module not in self._pos:
            self._pos[module] = len(self._order)
            self._order.append(module)
        grad = torch.is_grad_enabled()
        for i in idxs:
            if i not in self._installed:
                t = _GatherCast.apply(self.leaves[i].master, self, i)
                if grad and self.leaves[i].part.sharded:
                    # (grad mode is off inside the Function's forward)
                    ptr = t.untyped_storage().data_ptr()
                    self._live[ptr] = i
                    self._live_of[i] = ptr
                self._install(i, t)
        if self.prefetch and self._recorded and module in self._pos:
            nxt = self._pos[module] + 1
            if nxt < len(self._order):
                for i in self._by_module[self._order[nxt]]:
                    self._issue_prefetch(i)

    def _post_hook(self, module, args, out):
        if self._phase == "forward" and torch.is_grad_enabled():
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for o in outs:
                if torch.is_tensor(o) and o.requires_grad:
                    o.register_hook(
                        lambda g, m=module: self._pre_backward(m))
        if module is self.model and self._phase == "forward":
            return      # the loss may read the root's params after it
        for i in self._by_module[module]:
            self._release(i)

    def _pre_backward(self, module):
        for i in self._by_module[module]:
            if self.leaves[i].part.sharded:
                self._regathered(i)

    # -- collectives -----------------------------------------------------------
    def _issue_prefetch(self, i):
        leaf = self.leaves[i]
        if not leaf.part.sharded or i in self._pending or \
                i in self._installed:
            return
        src = leaf.master.detach().to(self.dtype)
        flat = torch.empty(leaf.part.numel, dtype=self.dtype,
                           device=src.device)
        work = self._all_gather(flat, src, async_op=True)
        self.gathers += 1
        self._pending[i] = (flat, work, src)

    def _gather(self, i):
        """The whole leaf ``i`` in the compute dtype (forward)."""
        leaf = self.leaves[i]
        if not leaf.part.sharded:
            return leaf.master.detach().to(self.dtype, copy=True)
        hit = self._pending.pop(i, None)
        if hit is not None:
            flat, work, _ = hit
            if work is not None:
                work.wait()
        else:
            src = leaf.master.detach().to(self.dtype)
            flat = torch.empty(leaf.part.numel, dtype=self.dtype,
                               device=src.device)
            self._all_gather(flat, src)
            self.gathers += 1
        return leaf.part.from_gathered(flat)

    def _all_gather(self, flat, src, async_op=False):
        if self.wire_dtype is not None:
            return self._wire_gather(flat, src, async_op)
        return self.comm.all_gather_striped(
            flat, src, self.gather_chunks, self.bidirectional,
            async_op=async_op)

    def _wire_gather(self, flat, src, async_op):
        """The quantized all-gather: the piece encoded once, the wire
        buffers all-gathered, each other rank's row decoded into its
        slot and this rank's piece placed exactly."""
        from deepspeed_tpu_torch.runtime.comm.codecs import (
            decode_wire, encode_wire)
        comm, codec, chunk = self.comm, self.wire_dtype, self.wire_chunk
        src = src.reshape(-1)
        n = src.numel()
        wire = encode_wire(src, codec, chunk)
        rows = torch.empty(comm.world * wire.numel(), dtype=torch.uint8,
                           device=src.device)
        work = comm.all_gather(rows, wire, async_op=async_op)

        def finish():
            per_rank = rows.view(comm.world, -1)
            for r in range(comm.world):
                dst = flat[r * n:(r + 1) * n]
                if r == comm.rank:
                    dst.copy_(src)
                else:
                    dst.copy_(decode_wire(per_rank[r], codec, (n,),
                                          flat.dtype, chunk))

        if work is None:
            finish()
            return None
        return _Finishing(work, finish)

    def _regathered(self, i):
        """Leaf ``i`` gathered again for the backward (once per
        backward): the flat copy."""
        flat = self._bwd.get(i)
        if flat is None:
            leaf = self.leaves[i]
            src = leaf.master.detach().to(self.dtype)
            flat = torch.empty(leaf.part.numel, dtype=self.dtype,
                               device=src.device)
            self._all_gather(flat, src)
            self.regathers += 1
            self._bwd[i] = flat
        return flat

    def _reduce_grad(self, i, grad):
        """The cotangent of leaf ``i`` (compute dtype, whole leaf) as the
        piece's fp32 gradient summed over the ranks."""
        leaf = self.leaves[i]
        self._bwd.pop(i, None)
        g = grad.float()
        if not leaf.part.sharded:
            g = g.clone(memory_format=torch.contiguous_format) \
                if g is grad else g.contiguous()
            return self.comm.all_reduce(g)
        out = torch.empty(leaf.part.piece_shape, dtype=torch.float32,
                          device=g.device)
        return self.comm.reduce_scatter(out, leaf.part.rank_major(g))

    # -- saved tensors -----------------------------------------------------------
    def _pack(self, t):
        if not self._live:
            return t
        i = self._live.get(t.untyped_storage().data_ptr())
        if i is None:
            return t
        return _SavedGathered(i, t)

    def _unpack(self, x):
        if not isinstance(x, _SavedGathered):
            return x
        return self._regathered(x.idx).as_strided(x.size, x.stride,
                                                  x.offset)
