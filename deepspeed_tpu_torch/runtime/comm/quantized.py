"""Int8 chunk-scaled quantized all-reduce with bucketing (port of
``deepspeed_tpu/runtime/comm/quantized.py``).

The gradient exchange of the data-parallel step in int8 (EQuARX,
arXiv:2506.17615), over a data group
(:class:`~deepspeed_tpu_torch.parallel.mesh.AxisGroup`):

1. the worker adds its residual (error feedback, optional) and cuts the
   flat gradient into ``chunk_size`` pieces, each int8 against its own
   absmax (``scale = absmax / 127``, round half to even: the codec of
   ``runtime/comm/codecs.py``);
2. the chunk-server scatter: rank r receives every rank's int8 copy of
   shard r (``parallel/collectives.py:scatter_to_chunk_servers``);
3. the server decodes and takes the mean of its shard in fp32, adds its
   own residual, re-quantizes it;
4. the gather (``gather_from_chunk_servers``) gives every rank every
   shard in int8, decoded to fp32.

Every rank decodes the same int8 payloads against the same scales, so the
average is bit for bit equal on every rank. Wire cost per rank on a ring
of N (send basis, n fp32 elements, chunk c): the all-to-all moves
(N-1)/N (n + 4n/c) bytes and the all-gather the same, against
2 (N-1)/N 4n for the fp32 ring all-reduce: 4 / (1 + 4/c), about 3.97x
at c = 512.

Each phase is a function of the tensors the exchange moves
(:func:`quantized_worker`, :func:`quantized_server`,
:func:`quantized_decode`), so a caller can run every rank's arithmetic
in one process; :func:`quantized_allreduce` composes them around the two
collectives. The residuals are the caller's state: this rank's worker
row ``[padded_n]`` and its served shard ``[padded_n / world]`` (JAX keeps
``[world, ...]`` stacks sharded over the axis; row r is rank r's).

:func:`bucket_plan` / :func:`quantized_allreduce_tree` group the leaves
into ~``bucket_bytes`` buckets of consecutive leaves, one exchange each
(the reference's ``allreduce_bucket``, ``engine.py:1082``).
"""

import torch

from deepspeed_tpu_torch.parallel.collectives import (
    gather_from_chunk_servers,
    scatter_to_chunk_servers,
)
from deepspeed_tpu_torch.runtime.comm.codecs import (
    decode_chunks,
    encode_chunks,
)

__all__ = [
    "quantize_chunks", "dequantize_chunks", "quantized_allreduce",
    "quantized_allreduce_sizes", "bucket_plan", "init_residuals",
    "quantized_allreduce_tree", "quantized_worker", "quantized_server",
    "quantized_decode",
]


def quantize_chunks(x, chunk_size):
    """Flat ``x`` (length a multiple of ``chunk_size``) as ``(q, scales)``:
    ``q`` ``[n_chunks, chunk_size]`` int8 in [-127, 127], ``scales``
    ``[n_chunks]`` fp32 ``absmax / 127`` (an all-zero chunk has scale 0
    and decodes to exact zeros)."""
    return encode_chunks(x, chunk_size, "int8")


def dequantize_chunks(q, scales, dtype=torch.float32):
    """Inverse of :func:`quantize_chunks` (up to rounding): flat."""
    return decode_chunks(q, scales, dtype)


def quantized_allreduce_sizes(n, world, chunk_size):
    """``(padded_n, shard)``: ``padded_n`` the smallest multiple of
    ``world * chunk_size`` >= n (every rank serves whole chunks)."""
    align = world * chunk_size
    padded = ((n + align - 1) // align) * align
    return padded, padded // world


def quantized_worker(x, world, chunk_size, worker_residual=None):
    """Phase 1 on a rank: ``(q [world, cps, c], scales [world, cps],
    new_worker_residual)`` of flat ``x`` plus the residual (None without
    error feedback); row r goes to rank r."""
    n = x.shape[-1]
    shard = n // world
    if shard * world != n or shard % chunk_size:
        raise ValueError(f"buffer of {n} not aligned for world {world} x "
                         f"chunk {chunk_size}; use "
                         f"quantized_allreduce_sizes()")
    ef = worker_residual is not None
    corrected = x + worker_residual if ef else x
    q, scales = quantize_chunks(corrected, chunk_size)
    new_worker = corrected - dequantize_chunks(q, scales) if ef else None
    cps = shard // chunk_size
    return (q.reshape(world, cps, chunk_size), scales.reshape(world, cps),
            new_worker)


def quantized_server(recv_q, recv_s, chunk_size, server_residual=None):
    """Phase 2 on the server: every rank's int8 copy of the served shard
    (``[world, cps, c]`` and ``[world, cps]``) decoded and averaged in
    fp32, plus the server residual, re-quantized: ``(q2 [cps, c],
    s2 [cps], new_server_residual)``."""
    shard = recv_q.shape[1] * chunk_size
    avg = (recv_q.to(torch.float32) * recv_s[:, :, None]) \
        .mean(dim=0).reshape(shard)
    ef = server_residual is not None
    if ef:
        avg = avg + server_residual
    q2, s2 = quantize_chunks(avg, chunk_size)
    new_server = avg - dequantize_chunks(q2, s2) if ef else None
    return q2, s2, new_server


def quantized_decode(all_q, all_s, chunk_size):
    """Phase 3: the gathered shards (``[world, cps, c]``, ``[world, cps]``)
    as the flat fp32 average."""
    return dequantize_chunks(all_q.reshape(-1, chunk_size),
                             all_s.reshape(-1))


def quantized_allreduce(x, group, chunk_size=512, worker_residual=None,
                        server_residual=None):
    """Int8 chunk-scaled *averaging* all-reduce of flat ``x`` over
    ``group`` (``x.numel()`` a multiple of ``world * chunk_size``).
    ``worker_residual`` ``[n]`` and ``server_residual`` ``[n / world]``
    (both or neither) turn on error feedback. Returns ``(avg,
    new_worker_residual, new_server_residual)``, the residuals None
    without error feedback."""
    world = group.size if group is not None and group.active else 1
    q, s, new_worker = quantized_worker(x, world, chunk_size,
                                        worker_residual)
    recv_q, recv_s = scatter_to_chunk_servers((q, s), group)
    q2, s2, new_server = quantized_server(recv_q, recv_s, chunk_size,
                                          server_residual)
    all_q, all_s = gather_from_chunk_servers((q2, s2), group)
    return quantized_decode(all_q, all_s, chunk_size), new_worker, \
        new_server


def bucket_plan(leaves, world, bucket_bytes, chunk_size):
    """Greedy in-order packing of flat leaf sizes (``leaves``: element
    counts) into buckets that close once they hold >= ``bucket_bytes`` of
    fp32. Returns ``[(leaf_slice, n, padded_n)]``."""
    per_bucket = max(int(bucket_bytes) // 4, 1)
    buckets = []
    start, total = 0, 0
    for i, size in enumerate(leaves):
        total += int(size)
        if total >= per_bucket:
            padded, _ = quantized_allreduce_sizes(total, world, chunk_size)
            buckets.append((slice(start, i + 1), total, padded))
            start, total = i + 1, 0
    if total > 0 or not buckets:
        total = max(total, 1)
        padded, _ = quantized_allreduce_sizes(total, world, chunk_size)
        buckets.append((slice(start, len(leaves)), total, padded))
    return buckets


def init_residuals(sizes, world, bucket_bytes, chunk_size, device=None):
    """Zero error-feedback state for :func:`quantized_allreduce_tree` over
    leaves of ``sizes`` elements: per bucket, this rank's worker residual
    ``[padded_n]`` and the residual of the shard it serves
    ``[padded_n / world]``."""
    plan = bucket_plan(sizes, world, bucket_bytes, chunk_size)
    return {
        "worker": [torch.zeros(padded, dtype=torch.float32, device=device)
                   for _, _, padded in plan],
        "server": [torch.zeros(padded // world, dtype=torch.float32,
                               device=device) for _, _, padded in plan],
    }


def quantized_allreduce_tree(grads, group, chunk_size=512,
                             bucket_bytes=4 * 1024 * 1024, residuals=None):
    """Bucketed int8 averaging all-reduce of a list of tensors: one
    :func:`quantized_allreduce` a bucket of :func:`bucket_plan`.
    ``residuals`` is :func:`init_residuals`' state, or None (no error
    feedback). Returns ``(averages, new_residuals)``: fp32 tensors of
    the leaves' shapes, and the residuals (None without them)."""
    world = group.size if group is not None and group.active else 1
    plan = bucket_plan([g.numel() for g in grads], world, bucket_bytes,
                       chunk_size)
    out = [None] * len(grads)
    new_res = {"worker": [], "server": []} if residuals is not None \
        else None
    for b, (sl, n, padded) in enumerate(plan):
        members = grads[sl]
        flat = torch.cat([m.reshape(-1).to(torch.float32)
                          for m in members]) if len(members) > 1 else \
            members[0].reshape(-1).to(torch.float32)
        if padded > n:
            flat = torch.cat([flat, flat.new_zeros(padded - n)])
        we = residuals["worker"][b] if residuals is not None else None
        se = residuals["server"][b] if residuals is not None else None
        avg, we2, se2 = quantized_allreduce(
            flat, group, chunk_size=chunk_size, worker_residual=we,
            server_residual=se)
        if new_res is not None:
            new_res["worker"].append(we2)
            new_res["server"].append(se2)
        off = 0
        for j, m in zip(range(sl.start, sl.stop), members):
            out[j] = avg[off:off + m.numel()].reshape(m.shape)
            off += m.numel()
    return out, new_res
