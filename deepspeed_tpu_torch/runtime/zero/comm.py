"""The ZeRO collectives, counted.

Every collective of the data-parallel step goes through :class:`Comm`:
the gradient all-reduce (stage 0), the gradient reduce-scatter (stages
1-3), the param all-gather (the refresh after a sharded update at stages
1-2, the per-use gathers at stage 3) and the scalar votes (loss mean,
global norm, fp16 overflow). Each call adds to a count of calls and
bytes by kind, the port's analog of what the JAX package reads off the
compiled HLO (``analysis/hlo.py:collective_bytes``,
``tests/unit/test_zero_comm_volume.py``). Bytes are those of the whole
tensor: the all-reduce's operand, the reduce-scatter's input, the
all-gather's output. Scalar votes are counted apart, under ``stat``.

Without a process group (one process, world 1) nothing is issued or
counted: a reduce-scatter or all-gather is then a copy, an all-reduce
leaves its operand as it is. With a group of one (the card in
``chip_smoke.py``) every collective is issued.
"""

import torch

from deepspeed_tpu_torch.parallel import mesh

KINDS = ("all_reduce", "reduce_scatter", "all_gather")


def _nbytes(t):
    return t.numel() * t.element_size()


class Comm:
    """Counted collectives over the data-parallel group: the default
    group, or ``group`` (a pipeline stage's data group)."""

    def __init__(self, group=None):
        self.active = mesh.is_initialized()
        self.group = group
        if self.active and group is not None:
            import torch.distributed as dist
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        else:
            self.world = mesh.dp_world_size()
            self.rank = mesh.dp_rank()
        self.reset()

    def reset(self):
        """Zero every count."""
        self.counts = {k: {"calls": 0, "bytes": 0} for k in KINDS}
        self.stat = {"calls": 0, "bytes": 0}

    def _record(self, kind, nbytes, stat=False):
        row = self.stat if stat else self.counts[kind]
        row["calls"] += 1
        row["bytes"] += int(nbytes)

    def snapshot(self):
        """The counts as a plain dict (``stat`` beside the kinds)."""
        out = {k: dict(v) for k, v in self.counts.items()}
        out["stat"] = dict(self.stat)
        return out

    def all_reduce(self, t, op="sum", stat=False):
        """In place over the group (``op`` "sum" or "max")."""
        if not self.active:
            return t
        import torch.distributed as dist
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        dist.all_reduce(t, op=red, group=self.group)
        self._record("all_reduce", _nbytes(t), stat)
        return t

    def reduce_scatter(self, out, inp):
        """Sum ``inp`` (contiguous, ``world * out.numel()`` elements,
        rank r's part at [r*n, (r+1)*n)) over the group into ``out``."""
        if not self.active:
            out.copy_(inp.reshape(out.shape))
            return out
        import torch.distributed as dist
        dist.reduce_scatter_tensor(out.view(-1), inp.reshape(-1),
                                 group=self.group)
        self._record("reduce_scatter", _nbytes(inp))
        return out

    def all_gather(self, out, inp, async_op=False):
        """Concatenate every rank's contiguous ``inp`` into ``out``
        (``world * inp.numel()`` elements, rank order). With
        ``async_op`` returns the work handle (wait on it before reading
        ``out``), else None."""
        if not self.active:
            out.copy_(inp.reshape(out.shape))
            return None
        import torch.distributed as dist
        work = dist.all_gather_into_tensor(out.view(-1), inp.reshape(-1),
                                            group=self.group,
                                            async_op=async_op)
        self._record("all_gather", _nbytes(out))
        return work

    def all_gather_striped(self, out, inp, chunks=1, bidirectional=False,
                           async_op=False):
        """:meth:`all_gather` of ``inp`` into ``out`` in ``chunks``
        collectives: stripe c of every rank's ``inp`` (a contiguous
        ``ceil(n / chunks)`` elements) is gathered by collective c and
        copied into place, so ``out`` holds what one all-gather writes,
        bit for bit (the stripes only move data). This is the port of
        the JAX stage-3 ``gather_chunks`` (``stage3.py``), whose stripes
        are ``ppermute`` rounds of the TPU ring; NCCL and gloo schedule
        each collective's ring or tree themselves, so a stripe is the
        unit the port can shape. ``bidirectional`` issues the stripes
        alternately from the front and the back of the leaf (0, C-1, 1,
        C-2, ...), the nearest a library collective comes to the JAX
        ring's alternating direction: NCCL already drives both
        directions of each NVLink within every collective, and gloo's
        ring runs one way; on either it reorders the collectives and
        never changes a result. Each stripe lands in a buffer of its own
        and is copied into place, so on NCCL and gloo ``chunks > 1``
        costs one extra copy of the gathered leaf over one all-gather:
        the two keys keep the JAX config's meaning, not a speed-up.
        With ``async_op`` returns a handle whose
        ``wait()`` waits for every stripe and copies them into ``out``;
        else None."""
        if chunks <= 1:
            return self.all_gather(out, inp, async_op=async_op)
        inp = inp.reshape(-1)
        n = inp.numel()
        step = max(1, -(-n // chunks))
        stripes = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
        if bidirectional:
            front, back = 0, len(stripes) - 1
            order = []
            while front <= back:
                order.append(front)
                if back != front:
                    order.append(back)
                front, back = front + 1, back - 1
            stripes = [stripes[c] for c in order]
        world = out.numel() // max(n, 1)
        parts = []
        for lo, hi in stripes:
            buf = torch.empty(world * (hi - lo), dtype=out.dtype,
                              device=out.device)
            work = self.all_gather(buf, inp[lo:hi], async_op=async_op)
            parts.append((lo, hi, buf, work))
        handle = _Striped(out.view(world, n), parts)
        if async_op:
            return handle
        handle.wait()
        return None

    def barrier(self):
        if self.active:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def mean_scalar(self, x):
        """A 0-d tensor averaged over the group (a ``stat`` vote)."""
        if not self.active:
            return x
        y = x.detach().float().reshape(1).clone()
        self.all_reduce(y, "sum", stat=True)
        return (y / self.world).reshape(())

    def any_flag(self, flag):
        """A 0-d bool tensor, true on every rank iff true on one (a MAX
        ``stat`` vote)."""
        if not self.active:
            return flag
        y = flag.to(torch.float32).reshape(1)
        self.all_reduce(y, "max", stat=True)
        return (y > 0).reshape(())


class _Striped:
    """The pending stripes of :meth:`Comm.all_gather_striped`."""

    def __init__(self, out, parts):
        self.out = out              # [world, n] view of the output
        self.parts = parts          # (lo, hi, gathered buffer, work)

    def wait(self):
        world = self.out.shape[0]
        for lo, hi, buf, work in self.parts:
            if work is not None:
                work.wait()
            self.out[:, lo:hi].copy_(buf.view(world, hi - lo))
        self.parts = []
