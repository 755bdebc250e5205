"""The model axis's collectives over ``torch.distributed`` (port of
``deepspeed_tpu/parallel/collectives.py``).

Every function takes a :class:`~deepspeed_tpu_torch.parallel.mesh.
AxisGroup` where JAX takes a mesh axis name. A group of one (or none)
is the JAX package outside ``manual_axes``: no collective runs. The
backwards are ``torch.autograd.Function``\\ s where JAX has a
``custom_vjp``.

- Megatron's conjugate pair: :func:`psum_grad` (``f``: identity
  forward, sum of the cotangent backward) and :func:`psum_combine`
  (``g``: sum forward, identity backward: the output is consumed
  replicated, so each rank's partial takes the output's cotangent once).
- Rings: :func:`ring_psum` (rotate-accumulate: ``buf = ppermute(buf);
  acc += buf`` for n-1 hops, so rank r sums ``x_r + x_{r-1} + ...`` in
  that order) and :func:`ring_all_gather`, each in ``chunks`` stripes of
  the trailing (or gathered) dim, odd stripes the other way round the
  ring with ``bidirectional``.
- The collective matmuls (:func:`matmul_psum_overlap`,
  :func:`matmul_reduce_scatter`, :func:`all_gather_matmul_overlap`,
  :func:`all_to_all_overlap`): the product split into ``chunks``
  pieces, each piece's exchange a ring of ``ppermute``\\ s. JAX pipelines
  the ring of chunk i against the matmul of chunk i+1 inside one XLA
  program; eager PyTorch issues them in the same order, each ``ppermute``
  waited on before its sum. The backwards run the transposed schedule
  (reduce-scatter and all-gather are each other's transpose).
  ``chunks=1`` is the monolithic collective: :func:`matmul_psum_overlap`
  at one chunk *is* ``psum_combine(a @ b)``, bit for bit. The matmuls
  are ``torch.matmul``, as JAX's are ``jnp.dot`` outside any kernel.
- The quantized wire (``wire_dtype``, a codec of
  ``runtime/comm/codecs.py``): a contribution is encoded once at its
  origin (payload and per-chunk scales in one uint8 buffer), decoded and
  summed in fp32 by each receiver, the rank's own contribution exact;
  the travelling accumulator of :func:`matmul_reduce_scatter`'s ring is
  re-encoded every hop (JAX's documented exception). At ``chunks=1`` a
  wire is the bracketed form: encode, one all-gather (or all-to-all) of
  the wire buffers, decode-sum in ascending rank order.
- :class:`SitePlan`, :class:`OverlapPlan`, :func:`overlap_scope`,
  :func:`overlap_plan`: the ``tensor_parallel.overlap`` config block as
  the layers read it, per call site (:data:`OVERLAP_SITES`).
- :func:`record_collective_sites`: a log of :class:`SiteRecord`\\ s, one
  per collective group a helper issues (JAX logs them while tracing;
  here while running).
- The chunk-server pair (:func:`scatter_to_chunk_servers`,
  :func:`gather_from_chunk_servers`): the two phases the int8 and the
  1-bit all-reduces ride (``runtime/comm/quantized.py``,
  ``runtime/comm/compressed.py``); the scatter is the batched
  all-to-all, the gather an all-gather.

JAX's ``manual_axes`` / ``axis_is_manual`` and ``barrier_after`` have no
counterpart: explicit groups say where a collective runs, and eager
collectives issue in program order on every rank.

Every collective is counted (:func:`collective_counts`: calls and bytes
by kind, and the bytes by dtype). On one card the model group runs gloo on CUDA tensors
(``parallel/mesh.py``): gloo stages ``all_reduce``, ``broadcast`` and
``all_gather`` through host memory itself; ``ppermute``, all-to-all and
reduce-scatter are staged here explicitly, through a host copy
(:data:`STAGED` records which ran so).
"""

import contextlib
import dataclasses

import torch

from deepspeed_tpu_torch.runtime.comm.codecs import (
    decode_wire,
    encode_wire,
    get_codec,
)

# ---------------------------------------------------------------------------
# counted primitives
# ---------------------------------------------------------------------------

_COUNTS = {}
STAGED = set()       # kinds staged through host memory (gloo, CUDA)
_HOST_STAGED = ("ppermute", "all_to_all", "reduce_scatter")


def reset_collective_counts():
    _COUNTS.clear()
    STAGED.clear()


def collective_counts():
    """``{kind: {"calls", "bytes", "dtypes": {dtype: bytes}}}`` since the
    last reset (bytes of the operand sent by this rank: the all-reduce's
    tensor, the all-gather's output, the ppermute's buffer, the
    all-to-all's whole stack)."""
    return {k: dict(v, dtypes=dict(v["dtypes"])) for k, v in _COUNTS.items()}


def _count(kind, t):
    row = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "dtypes": {}})
    nbytes = t.numel() * t.element_size()
    row["calls"] += 1
    row["bytes"] += nbytes
    key = str(t.dtype).replace("torch.", "")
    row["dtypes"][key] = row["dtypes"].get(key, 0) + nbytes


def _dist():
    import torch.distributed as dist
    return dist


def _on_host(group, t, kind):
    """True when ``t`` must cross ``group`` through a host copy."""
    if t.device.type != "cuda" or kind not in _HOST_STAGED:
        return False
    if str(_dist().get_backend(group.pg)).lower() != "gloo":
        return False
    STAGED.add(kind)
    return True


def all_reduce(t, group, op="sum"):
    """``t`` summed (or maxed) over the group, in place."""
    if group is None or not group.active:
        return t
    dist = _dist()
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    dist.all_reduce(t, op=red, group=group.pg)
    _count("all_reduce", t)
    return t


def all_gather(t, group, dim=0):
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if group is None or not group.active:
        return t
    dist = _dist()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t.contiguous(), group=group.pg)
    out = torch.cat(parts, dim=dim)
    _count("all_gather", out)
    return out


def ppermute(t, group, shift=1):
    """Send ``t`` to the rank ``shift`` ahead on the ring and return what
    the rank ``shift`` behind sent (JAX ``lax.ppermute`` with the perm
    ``i -> i + shift``)."""
    if group is None or not group.active:
        return t
    n, r = group.size, group.rank
    if shift % n == 0:
        return t
    dist = _dist()
    host = _on_host(group, t, "ppermute")
    send = (t.cpu() if host else t).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, group.ranks[(r + shift) % n],
                      group.pg),
           dist.P2POp(dist.irecv, recv, group.ranks[(r - shift) % n],
                      group.pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count("ppermute", send)
    return recv.to(t.device) if host else recv


def _all_to_all(x, group, split_dim, concat_dim):
    """Tiled all-to-all: piece i of ``x`` along ``split_dim`` goes to rank
    i; the received pieces are concatenated along ``concat_dim`` in
    source-rank order (JAX ``lax.all_to_all(..., tiled=True)``). Every
    send and receive is posted in one ``batch_isend_irecv`` (a grouped
    send / receive on NCCL, as its own all-to-all does; gloo has no
    all-to-all in every torch build)."""
    n, r = group.size, group.rank
    dist = _dist()
    host = _on_host(group, x, "all_to_all")
    src = x.cpu() if host else x
    pieces = [p.contiguous() for p in src.chunk(n, dim=split_dim)]
    outs = [pieces[r] if i == r else torch.empty_like(pieces[0])
            for i in range(n)]
    ops = []
    for i in range(n):
        if i != r:
            ops.append(dist.P2POp(dist.isend, pieces[i], group.ranks[i],
                                  group.pg))
            ops.append(dist.P2POp(dist.irecv, outs[i], group.ranks[i],
                                  group.pg))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count("all_to_all", src)
    out = torch.cat(outs, dim=concat_dim)
    return out.to(x.device) if host else out


def _reduce_scatter_last(y, group):
    """``y`` summed over the group, rank r keeping slice r of its last
    dim (JAX ``psum_scatter(..., scatter_dimension=-1, tiled=True)``)."""
    n = group.size
    dist = _dist()
    host = _on_host(group, y, "reduce_scatter")
    src = y.cpu() if host else y
    m_loc = src.shape[-1] // n
    inp = src.reshape(-1, n, m_loc).transpose(0, 1).reshape(-1)
    out = torch.empty(inp.numel() // n, dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, inp, group=group.pg)
    _count("reduce_scatter", inp)
    out = out.reshape(src.shape[:-1] + (m_loc,))
    return out.to(y.device) if host else out


# ---------------------------------------------------------------------------
# the chunk-server pair
# ---------------------------------------------------------------------------

def _map_leaves(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(fn(v) for v in tree)
    return fn(tree)


def scatter_to_chunk_servers(tree, group):
    """Chunk-server scatter: every leaf of ``tree`` (a tensor, or a tuple
    or list of them) is a ``[world, ...]`` stack of per-destination rows;
    rank r receives every rank's row r, stacked in source-rank order (JAX
    ``parallel/collectives.py:93``, one ``all_to_all`` a leaf). The
    reduce-scatter half of the chunk-server topology: the reference's
    gather to chunk servers (``custom_collectives.py:23``)."""
    if group is None or not group.active:
        return tree
    return _map_leaves(lambda v: _all_to_all(v, group, 0, 0), tree)


def gather_from_chunk_servers(tree, group):
    """Chunk-server gather: every rank contributes its served (reduced)
    chunk, a tensor of any shape; all ranks receive the ``[world, ...]``
    stack (JAX ``parallel/collectives.py:107``, one ``all_gather`` a
    leaf)."""
    return _map_leaves(lambda v: all_gather(v[None], group, dim=0)
                       if group is not None and group.active else v[None],
                       tree)


# ---------------------------------------------------------------------------
# Megatron's f and g
# ---------------------------------------------------------------------------

class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, chunks, bidirectional, wire_dtype,
                wire_chunk):
        ctx.args = (group, chunks, bidirectional, wire_dtype, wire_chunk)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, chunks, bidirectional, wire_dtype, wire_chunk = ctx.args
        if chunks > 1 or wire_dtype is not None:
            g = ring_psum(g, group, chunks=chunks,
                          bidirectional=bidirectional,
                          wire_dtype=wire_dtype, wire_chunk=wire_chunk)
        else:
            g = all_reduce(g.contiguous().clone(), group)
        return g, None, None, None, None, None


def psum_grad(x, group, chunks=1, bidirectional=False, wire_dtype=None,
              wire_chunk=512):
    """Megatron ``f``: identity forward; the cotangent summed over
    ``group`` backward (a chunked :func:`ring_psum` with ``chunks > 1``
    or a wire; one all-reduce otherwise)."""
    if group is None or not group.active:
        return x
    return _PsumGrad.apply(x, group, int(chunks), bool(bidirectional),
                           wire_dtype, int(wire_chunk))


class _PsumCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_combine(x, group):
    """Megatron ``g``: the partials summed over ``group`` forward; the
    cotangent passed through backward (identity)."""
    if group is None or not group.active:
        return x
    return _PsumCombine.apply(x, group)


# ---------------------------------------------------------------------------
# overlap plan
# ---------------------------------------------------------------------------

OVERLAP_SITES = ("row_parallel", "column_parallel", "expert_combine",
                 "ulysses")


@dataclasses.dataclass(frozen=True)
class SitePlan:
    """Resolved overlap parameters of one call site."""
    chunks: int = 1
    bidirectional: bool = False
    wire_dtype: str = None
    wire_chunk: int = 512


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """The ``tensor_parallel.overlap`` block, resolved: the chunk count,
    ring direction and wire codec, with per-site overrides
    (``{site: {"enabled", "chunks", "bidirectional", "wire_dtype",
    "wire_chunk"}}``)."""
    chunks: int = 4
    bidirectional: bool = False
    sites: dict = dataclasses.field(default_factory=dict)
    wire_dtype: str = None
    wire_chunk: int = 512

    def site(self, name):
        """The :class:`SitePlan` of ``name``, or None when disabled."""
        ov = (self.sites or {}).get(name) or {}
        if ov.get("enabled", True) is False:
            return None
        wd = ov.get("wire_dtype", self.wire_dtype)
        return SitePlan(
            chunks=int(ov.get("chunks", self.chunks)),
            bidirectional=bool(ov.get("bidirectional", self.bidirectional)),
            wire_dtype=(str(wd) if wd else None),
            wire_chunk=int(ov.get("wire_chunk", self.wire_chunk)))


_OVERLAP_PLAN = None


@contextlib.contextmanager
def overlap_scope(plan):
    """Make ``plan`` (an :class:`OverlapPlan`, or None: off) the active
    plan of the layers run inside the block (the pipeline engine wraps
    its stages' forwards and backwards in it)."""
    global _OVERLAP_PLAN
    prev = _OVERLAP_PLAN
    _OVERLAP_PLAN = plan
    try:
        yield
    finally:
        _OVERLAP_PLAN = prev


def overlap_plan(site):
    """The active :class:`SitePlan` of ``site``, or None."""
    if _OVERLAP_PLAN is None:
        return None
    return _OVERLAP_PLAN.site(site)


# ---------------------------------------------------------------------------
# collective-site log
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One collective group a helper issued: the helper (``site``), the
    axis, the primitive family, its chunk rings and hops, and whether its
    permutes are ordered (always, eagerly)."""
    site: str
    axis: str
    primitive: str
    chunks: int = 1
    hops: int = 1
    chained: bool = True


_SITE_LOG = None


@contextlib.contextmanager
def record_collective_sites():
    """Collect :class:`SiteRecord`\\ s of the helpers run inside the block
    (yields the list; the innermost recorder wins)."""
    global _SITE_LOG
    prev, log = _SITE_LOG, []
    _SITE_LOG = log
    try:
        yield log
    finally:
        _SITE_LOG = prev


def log_collective_site(site, axis, primitive, chunks=1, hops=1,
                        chained=True):
    if _SITE_LOG is not None:
        _SITE_LOG.append(SiteRecord(site, str(axis), primitive,
                                    int(chunks), int(hops), bool(chained)))


# ---------------------------------------------------------------------------
# rings
# ---------------------------------------------------------------------------

def _chunk_slices(size, chunks):
    """``(start, size)`` pairs splitting ``size`` into at most ``chunks``
    pieces, the remainder spread over the leading ones (10/4 -> 3,3,2,2)."""
    k = max(1, min(int(chunks), int(size)))
    base, rem = divmod(int(size), k)
    out, start = [], 0
    for i in range(k):
        sz = base + (1 if i < rem else 0)
        out.append((start, sz))
        start += sz
    return out


def _shift(bidirectional, j):
    return -1 if bidirectional and j % 2 == 1 else 1


def _wire_psum_monolithic(x, group, codec, wire_chunk, site="ring_psum"):
    """Encode once, all-gather the wire buffers, decode-sum in ascending
    rank order with this rank's own contribution exact (fp32)."""
    codec = get_codec(codec)
    wire = encode_wire(x, codec, wire_chunk)
    log_collective_site(site, group.name, "all_gather")
    rows = all_gather(wire[None], group, dim=0)
    xf = x.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(group.size):
        acc = acc + (xf if i == group.rank else decode_wire(
            rows[i], codec, x.shape, torch.float32, wire_chunk))
    return acc.to(x.dtype)


def _wire_all_gather_monolithic(x, group, dim, codec, wire_chunk,
                                site="ring_all_gather"):
    codec = get_codec(codec)
    wire = encode_wire(x, codec, wire_chunk)
    log_collective_site(site, group.name, "all_gather")
    rows = all_gather(wire[None], group, dim=0)
    pieces = [x if i == group.rank else decode_wire(
        rows[i], codec, x.shape, x.dtype, wire_chunk)
        for i in range(group.size)]
    return torch.cat(pieces, dim=dim)


def ring_psum(x, group, chunks=1, bidirectional=False, wire_dtype=None,
              wire_chunk=512):
    """Rotate-accumulate ring sum over ``group`` (n-1 ``ppermute`` hops a
    stripe), in ``chunks`` stripes of the trailing dim; a wire encodes
    each stripe once at its origin (``chunks <= 1``: the bracketed
    monolithic form)."""
    if group is None or not group.active:
        return x
    n = group.size
    if wire_dtype is not None and (x.ndim == 0 or chunks <= 1):
        return _wire_psum_monolithic(x, group, wire_dtype, wire_chunk)
    codec = get_codec(wire_dtype) if wire_dtype is not None else None
    slices = [None] if x.ndim == 0 or chunks <= 1 else \
        _chunk_slices(x.shape[-1], chunks)
    log_collective_site("ring_psum", group.name, "ppermute",
                        chunks=len(slices), hops=n - 1)
    outs = []
    for j, sl in enumerate(slices):
        piece = x if sl is None else x[..., sl[0]:sl[0] + sl[1]]
        shift = _shift(bidirectional, j)
        if codec is None:
            acc, buf = piece, piece
            for _ in range(n - 1):
                buf = ppermute(buf, group, shift)
                acc = acc + buf
            outs.append(acc)
        else:
            acc = piece.float()
            buf = encode_wire(piece, codec, wire_chunk)
            for _ in range(n - 1):
                buf = ppermute(buf, group, shift)
                acc = acc + decode_wire(buf, codec, piece.shape,
                                        torch.float32, wire_chunk)
            outs.append(acc.to(x.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def ring_all_gather(x, group, axis=0, chunks=1, bidirectional=False,
                    dep=None, site="ring_all_gather", wire_dtype=None,
                    wire_chunk=512):
    """Every rank's shard of ``x`` gathered along ``axis``; returns
    ``(gathered, dep)`` as JAX does (``dep`` is passed through: eager
    collectives are ordered already). ``chunks <= 1`` is one all-gather;
    else each stripe of the local shard travels the ring (n-1 hops) and
    lands at its owner's offset. A wire moves stripes encoded and places
    the rank's own exactly."""
    if group is None or not group.active:
        return x, dep
    n, r = group.size, group.rank
    axis = axis % x.ndim
    k_loc = x.shape[axis]
    if wire_dtype is not None and (chunks <= 1 or k_loc < 2):
        return _wire_all_gather_monolithic(x, group, axis, wire_dtype,
                                           wire_chunk, site=site), dep
    if chunks <= 1 or k_loc < 2:
        log_collective_site(site, group.name, "all_gather")
        return all_gather(x, group, dim=axis), dep
    codec = get_codec(wire_dtype) if wire_dtype is not None else None
    slices = _chunk_slices(k_loc, chunks)
    log_collective_site(site, group.name, "ppermute", chunks=len(slices),
                        hops=n - 1)
    shape = list(x.shape)
    shape[axis] = n * k_loc
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    for j, (st, sz) in enumerate(slices):
        shift = _shift(bidirectional, j)
        stripe = x.narrow(axis, st, sz)
        buf = stripe if codec is None else encode_wire(stripe, codec,
                                                       wire_chunk)
        for h in range(n):
            if h:
                buf = ppermute(buf, group, shift)
            src = (r - shift * h) % n
            if codec is None or h == 0:
                piece = buf if codec is None else stripe
            else:
                piece = decode_wire(buf, codec, stripe.shape, x.dtype,
                                    wire_chunk)
            out.narrow(axis, src * k_loc + st, sz).copy_(piece)
    return out, dep


# ---------------------------------------------------------------------------
# collective matmuls
# ---------------------------------------------------------------------------

def _local_matmul_chunked(a, b, chunks):
    """``concat_j(a @ b[..., sl_j])``: the backward of the overlapped
    forms is the vjp of this, chunk for chunk."""
    slices = _chunk_slices(b.shape[-1], chunks)
    if len(slices) == 1:
        return torch.matmul(a, b)
    return torch.cat([torch.matmul(a, b[..., st:st + sz])
                      for st, sz in slices], dim=-1)


def _vjp(fn, inputs, g):
    """The cotangents of ``inputs`` under ``fn`` for the output cotangent
    ``g``."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in inputs]
        y = fn(*xs)
        return torch.autograd.grad(y, xs, g, allow_unused=True)


class _MatmulPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, group, chunks, bidirectional, wire_dtype,
                wire_chunk):
        ctx.save_for_backward(a, b)
        ctx.chunks = chunks
        n = group.size
        if chunks <= 1 or n == 1 or b.shape[-1] < 2:
            y = torch.matmul(a, b)
            if n > 1 and wire_dtype is not None:
                return _wire_psum_monolithic(y, group, wire_dtype,
                                             wire_chunk,
                                             site="matmul_psum_overlap")
            if n > 1:
                log_collective_site("matmul_psum_overlap", group.name,
                                    "psum")
            return all_reduce(y, group)
        codec = get_codec(wire_dtype) if wire_dtype is not None else None
        slices = _chunk_slices(b.shape[-1], chunks)
        log_collective_site("matmul_psum_overlap", group.name, "ppermute",
                            chunks=len(slices), hops=n - 1)
        outs = []
        for j, (st, sz) in enumerate(slices):
            p = torch.matmul(a, b[..., st:st + sz])
            shift = _shift(bidirectional, j)
            if codec is None:
                acc, buf = p, p
                for _ in range(n - 1):
                    buf = ppermute(buf, group, shift)
                    acc = acc + buf
                outs.append(acc)
            else:
                acc = p.float()
                buf = encode_wire(p, codec, wire_chunk)
                for _ in range(n - 1):
                    buf = ppermute(buf, group, shift)
                    acc = acc + decode_wire(buf, codec, p.shape,
                                            torch.float32, wire_chunk)
                outs.append(acc.to(p.dtype))
        return torch.cat(outs, dim=-1)

    @staticmethod
    def backward(ctx, g):
        # the combine's transpose is the identity (the output is consumed
        # replicated); the matmul transposes chunk for chunk
        a, b = ctx.saved_tensors
        ga, gb = _vjp(lambda x, w: _local_matmul_chunked(x, w, ctx.chunks),
                      (a, b), g)
        return ga, gb, None, None, None, None, None


def matmul_psum_overlap(a, b, group, chunks=1, bidirectional=False,
                        wire_dtype=None, wire_chunk=512):
    """Overlapped ``psum_combine(a @ b)``: ``a`` ``[..., K]`` a local
    partial, ``b`` ``[K, M]`` this rank's rows of the contraction; the
    output ``[..., M]`` replicated. ``chunks`` pieces of ``M``, each
    reduced by its ring; ``chunks=1`` is ``psum_combine(a @ b)`` bit for
    bit. Backward: no collective."""
    if group is None or not group.active:
        return torch.matmul(a, b)
    return _MatmulPsum.apply(a, b, group, int(chunks), bool(bidirectional),
                             None if wire_dtype is None else str(wire_dtype),
                             int(wire_chunk))


def _wire_reduce_scatter_monolithic(y, group, codec, wire_chunk):
    """Per-destination shards encoded once and exchanged by one
    all-to-all of the wire buffers; each rank decode-sums what it got in
    ascending rank order, its own contribution exact."""
    codec = get_codec(codec)
    n, r = group.size, group.rank
    m_loc = y.shape[-1] // n
    shards = [y[..., d * m_loc:(d + 1) * m_loc] for d in range(n)]
    wires = torch.stack([encode_wire(s, codec, wire_chunk)
                         for s in shards])
    log_collective_site("matmul_reduce_scatter", group.name, "all_to_all")
    recv = _all_to_all(wires, group, 0, 0)
    own = shards[r].float()
    acc = torch.zeros(own.shape, dtype=torch.float32, device=y.device)
    for i in range(n):
        acc = acc + (own if i == r else decode_wire(
            recv[i], codec, own.shape, torch.float32, wire_chunk))
    return acc.to(y.dtype)


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, group, chunks, bidirectional, wire_dtype,
                wire_chunk):
        ctx.save_for_backward(a, b)
        ctx.args = (group, chunks, wire_dtype, wire_chunk)
        n, r = group.size, group.rank
        M = b.shape[-1]
        if M % n:
            raise ValueError(f"matmul_reduce_scatter: output dim {M} must "
                             f"divide the axis size {n}")
        m_loc = M // n
        if chunks <= 1 or m_loc < 2:
            y = torch.matmul(a, b)
            if wire_dtype is not None:
                return _wire_reduce_scatter_monolithic(y, group, wire_dtype,
                                                       wire_chunk)
            log_collective_site("matmul_reduce_scatter", group.name,
                                "reduce_scatter")
            return _reduce_scatter_last(y, group)
        codec = get_codec(wire_dtype) if wire_dtype is not None else None
        log_collective_site("matmul_reduce_scatter", group.name,
                            "ppermute", chunks=chunks, hops=n - 1)
        outs = []
        for j, (st, sz) in enumerate(_chunk_slices(m_loc, chunks)):
            shift = _shift(bidirectional, j)
            # the accumulator destined for rank d visits every rank once
            # and lands at d: at step t this rank adds its contribution
            # for destination (r - shift * (1 + t)) mod n
            acc = None
            for t in range(n):
                dest = (r - shift * (1 + t)) % n
                contrib = torch.matmul(
                    a, b[..., dest * m_loc + st:dest * m_loc + st + sz])
                if codec is not None:
                    contrib = contrib.float()
                if t == 0:
                    acc = contrib
                elif codec is None:
                    acc = ppermute(acc, group, shift) + contrib
                else:
                    hop = ppermute(encode_wire(acc, codec, wire_chunk),
                                   group, shift)
                    acc = decode_wire(hop, codec, contrib.shape,
                                      torch.float32, wire_chunk) + contrib
            outs.append(acc if codec is None else
                        acc.to(torch.result_type(a, b)))
        return torch.cat(outs, dim=-1)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        group, chunks, wire_dtype, wire_chunk = ctx.args
        n, r = group.size, group.rank
        m_loc = g.shape[-1]
        if chunks <= 1:
            if wire_dtype is None:
                ghat = all_gather(g.contiguous(), group, dim=g.ndim - 1)
            else:
                ghat = _wire_all_gather_monolithic(
                    g, group, g.ndim - 1, wire_dtype, wire_chunk,
                    site="matmul_reduce_scatter")
            ga, gb = _vjp(torch.matmul, (a, b), ghat)
            return ga, gb, None, None, None, None, None
        codec = get_codec(wire_dtype) if wire_dtype is not None else None
        buf = g if codec is None else encode_wire(g, codec, wire_chunk)
        ga = gb = None
        for h in range(n):
            if h:
                buf = ppermute(buf, group, 1)
            src = (r - h) % n
            if codec is None or h == 0:
                shard = buf if codec is None else g
            else:
                shard = decode_wire(buf, codec, g.shape, g.dtype,
                                    wire_chunk)
            da, db = _vjp(lambda x, w, s=src: torch.matmul(
                x, w[..., s * m_loc:(s + 1) * m_loc]), (a, b), shard)
            ga = da if ga is None else ga + da
            gb = db if gb is None else gb + db
        return ga, gb, None, None, None, None, None


def matmul_reduce_scatter(a, b, group, chunks=1, bidirectional=False,
                          wire_dtype=None, wire_chunk=512):
    """Overlapped ``psum_scatter(a @ b)``: each rank keeps its shard of
    the reduced product's last dim (``M`` divisible by the group size).
    ``chunks > 1`` stripes the shard width and runs a ring
    reduce-scatter a stripe; the backward ring-gathers the cotangent."""
    if group is None or not group.active:
        return torch.matmul(a, b)
    return _MatmulReduceScatter.apply(
        a, b, group, int(chunks), bool(bidirectional),
        None if wire_dtype is None else str(wire_dtype), int(wire_chunk))


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, chunks, bidirectional):
        ctx.save_for_backward(x, w)
        ctx.args = (group, chunks)
        n, r = group.size, group.rank
        k_loc = x.shape[-1]
        if w.shape[-2] != n * k_loc:
            raise ValueError(
                f"all_gather_matmul_overlap: w contraction dim "
                f"{w.shape[-2]} != axis size {n} x local width {k_loc}")
        if chunks <= 1 or k_loc < 2:
            log_collective_site("all_gather_matmul", group.name,
                                "all_gather")
            xhat = all_gather(x.contiguous(), group, dim=x.ndim - 1)
            return torch.matmul(xhat, w)
        log_collective_site("all_gather_matmul", group.name, "ppermute",
                            chunks=chunks, hops=n - 1)
        out = None
        for j, (st, sz) in enumerate(_chunk_slices(k_loc, chunks)):
            shift = _shift(bidirectional, j)
            buf = x[..., st:st + sz]
            for h in range(n):
                if h:
                    buf = ppermute(buf, group, shift)
                src = (r - shift * h) % n
                t = torch.matmul(
                    buf, w[..., src * k_loc + st:src * k_loc + st + sz, :])
                out = t if out is None else out + t
        return out

    @staticmethod
    def backward(ctx, g):
        # the cotangent is taken once (replicated output); dx is the
        # local row block, dw needs every shard of x again: a ring
        x, w = ctx.saved_tensors
        group, chunks = ctx.args
        n, r = group.size, group.rank
        k_loc = x.shape[-1]
        if chunks <= 1:
            xhat = all_gather(x.contiguous(), group, dim=x.ndim - 1)
            dxhat, gw = _vjp(torch.matmul, (xhat, w), g)
            return dxhat[..., r * k_loc:(r + 1) * k_loc], gw, None, None, \
                None
        buf = x
        gx = gw = None
        for h in range(n):
            if h:
                buf = ppermute(buf, group, 1)
            src = (r - h) % n
            dxx, dgw = _vjp(lambda xx, ww, s=src: torch.matmul(
                xx, ww[..., s * k_loc:(s + 1) * k_loc, :]), (buf, w), g)
            if h == 0:
                gx = dxx
            gw = dgw if gw is None else gw + dgw
        return gx, gw, None, None, None


def all_gather_matmul_overlap(x, w, group, chunks=1, bidirectional=False):
    """Overlapped ``all_gather(x) @ w``: ``x`` ``[..., K/n]`` this rank's
    shard of the contraction, ``w`` ``[K, M]`` replicated; the output
    replicated. ``chunks=1`` is one all-gather and one matmul."""
    if group is None or not group.active:
        return torch.matmul(x, w)
    return _AllGatherMatmul.apply(x, w, group, int(chunks),
                                  bool(bidirectional))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, chunks):
        ctx.args = (group, split_axis, concat_axis, chunks)
        return _all_to_all_overlap(x, group, split_axis, concat_axis,
                                   chunks)

    @staticmethod
    def backward(ctx, g):
        # a permutation of elements: its transpose swaps the axes
        group, split_axis, concat_axis, chunks = ctx.args
        return _all_to_all_overlap(g.contiguous(), group, concat_axis,
                                   split_axis, chunks), None, None, None, \
            None


def _all_to_all_overlap(x, group, split_axis, concat_axis, chunks):
    n, r = group.size, group.rank
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all_overlap: split dim "
                         f"{x.shape[split_axis]} not divisible by axis "
                         f"size {n}")
    if chunks <= 1:
        log_collective_site("all_to_all_overlap", group.name, "all_to_all")
        return _all_to_all(x, group, split_axis, concat_axis)
    log_collective_site("all_to_all_overlap", group.name, "ppermute",
                        hops=n - 1)
    piece = x.shape[split_axis] // n
    recvd = [None] * n
    for h in range(n):
        dst = (r + h) % n
        send = x.narrow(split_axis, dst * piece, piece).contiguous()
        recv = send if h == 0 else ppermute(send, group, h)
        recvd[(r - h) % n] = recv
    return torch.cat(recvd, dim=concat_axis)


def all_to_all_overlap(x, group, split_axis, concat_axis, chunks=1):
    """Tiled all-to-all (piece i of ``split_axis`` to rank i, received
    pieces concatenated along ``concat_axis`` in source order);
    ``chunks > 1`` runs it as n-1 shift-``ppermute``\\ s plus the local
    piece."""
    if group is None or not group.active:
        return x
    return _AllToAll.apply(x, group, split_axis % x.ndim,
                           concat_axis % x.ndim, int(chunks))
