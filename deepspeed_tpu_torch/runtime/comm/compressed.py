"""Error-feedback 1-bit compressed all-reduce (port of
``deepspeed_tpu/runtime/comm/compressed.py``): the reference's
``Compressed_Allreduce`` (``runtime/fp16/onebit_adam.py:104-228``) over
the chunk-server pair of ``parallel/collectives.py``.

Per rank, over a data group of N (an
:class:`~deepspeed_tpu_torch.parallel.mesh.AxisGroup`):

1. worker: ``x + worker_error`` with the padding zeroed, compressed to
   its signs (bit-packed, :func:`pack_signs`) and one scale
   ``||x||_2 / sqrt(n_valid)``; the new worker error is what the
   compression lost (zero on the padding);
2. the scatter: rank r receives every rank's packed chunk r, and every
   rank's scale (an all-gather of the scalars);
3. server: the chunk's mean of ``sign * scale`` plus the server error,
   zeroed past the chunk's valid length ``clip(n_valid - r * chunk, 0,
   chunk)`` (so padding never gathers error), compressed again (the
   scale over the valid length);
4. the gather: every rank's packed chunk and scale, decoded.

Every rank decodes the same bits and scales: the average is bit for bit
equal on every rank. Wire per rank: ~n/4 bytes of packed signs each way
plus 4-byte scales, against 8n for an fp32 ring all-reduce.

Each phase is a function of the exchanged tensors
(:func:`compressed_worker`, :func:`compressed_server`,
:func:`compressed_decode`); :func:`compressed_allreduce` composes them
around the collectives. The codecs and the arithmetic are plain PyTorch
on the tensors' device (JAX computes them with ``jnp`` outside any
kernel).
"""

import torch

from deepspeed_tpu_torch.parallel.collectives import (
    gather_from_chunk_servers,
    scatter_to_chunk_servers,
)

__all__ = ["pack_signs", "unpack_signs", "compressed_allreduce",
           "error_feedback_sizes", "compressed_worker",
           "compressed_server", "compressed_decode"]


def _pow2(device):
    return torch.tensor([1 << i for i in range(8)], dtype=torch.uint8,
                        device=device)


def pack_signs(signs):
    """A ``[..., n]`` bool tensor (True = +1) packed into ``[..., n/8]``
    uint8, bit i of byte k weighted 2^i (``n % 8 == 0``; the analog of
    ``cupy.packbits``, ``custom_collectives.py:33``)."""
    *lead, n = signs.shape
    if n % 8:
        raise ValueError(f"pack_signs needs n % 8 == 0, got {n}")
    bits = signs.reshape(*lead, n // 8, 8).to(torch.uint8)
    return (bits * _pow2(signs.device)).sum(dim=-1, dtype=torch.uint8)


def unpack_signs(packed, dtype=torch.float32):
    """Inverse of :func:`pack_signs`: ``[..., m]`` uint8 -> ``[..., 8m]``
    of +1 / -1 in ``dtype``."""
    *lead, m = packed.shape
    bits = (packed[..., None] & _pow2(packed.device)) > 0
    one = torch.ones((), dtype=dtype, device=packed.device)
    return torch.where(bits, one, -one).reshape(*lead, m * 8)


def _sign_scale(x, valid, n_valid):
    """``(signs, scale, residual)`` of ``x`` over its ``valid`` elements:
    ``scale = ||x||_2 / sqrt(n_valid)``, the residual ``x - scale *
    sign(x)`` zeroed where invalid (reference onebit_adam.py:122-139)."""
    x = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))
    scale = torch.linalg.vector_norm(x) / torch.sqrt(
        torch.as_tensor(n_valid, dtype=x.dtype, device=x.device))
    signs = x >= 0
    one = torch.ones((), dtype=x.dtype, device=x.device)
    sgn = torch.where(signs, one, -one)
    residual = torch.where(valid, x - scale * sgn,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return signs, scale, residual


def error_feedback_sizes(n, world):
    """``(padded_n, chunk)`` for an n-element buffer over ``world`` ranks:
    padded to a multiple of ``8 * world`` so every chunk packs to whole
    bytes."""
    align = 8 * world
    padded = ((n + align - 1) // align) * align
    return padded, padded // world


def compressed_worker(x, worker_error, world, n_valid):
    """Phase 1 on a rank: ``(packed [world, chunk/8], scale,
    new_worker_error)``; row r goes to rank r."""
    padded_n = x.shape[-1]
    chunk = padded_n // world
    if chunk * world != padded_n or chunk % 8:
        raise ValueError(f"buffer of {padded_n} not aligned for world "
                         f"{world}; use error_feedback_sizes()")
    valid = torch.arange(padded_n, device=x.device) < n_valid
    signs, scale, new_worker = _sign_scale(x + worker_error, valid,
                                           n_valid)
    return pack_signs(signs).reshape(world, chunk // 8), scale, new_worker


def compressed_server(recv, scales, server_error, rank, n_valid):
    """Phase 2 on rank ``rank``: every rank's packed copy of the served
    chunk (``[world, chunk/8]``) and every rank's scale (``[world]``)
    averaged, plus the server error, compressed again: ``(packed
    [chunk/8], scale, new_server_error)``."""
    chunk = recv.shape[-1] * 8
    decoded = unpack_signs(recv) * scales[:, None]
    chunk_avg = decoded.mean(dim=0) + server_error
    chunk_valid = min(max(int(n_valid) - rank * chunk, 0), chunk)
    valid = torch.arange(chunk, device=recv.device) < chunk_valid
    signs, scale, new_server = _sign_scale(chunk_avg, valid,
                                           max(chunk_valid, 1))
    return pack_signs(signs), scale, new_server


def compressed_decode(all_packed, all_scales, n_valid):
    """Phase 3: the gathered chunks (``[world, chunk/8]``, ``[world]``) as
    the flat average, zero past ``n_valid``."""
    avg = (unpack_signs(all_packed) * all_scales[:, None]).reshape(-1)
    valid = torch.arange(avg.shape[0], device=avg.device) < n_valid
    return torch.where(valid, avg, torch.zeros((), dtype=avg.dtype,
                                                device=avg.device))


def compressed_allreduce(x, worker_error, server_error, group,
                         n_valid=None):
    """1-bit error-feedback *averaging* all-reduce of flat ``x`` over
    ``group``. Per rank: ``x`` ``[padded_n]`` (:func:`error_feedback_
    sizes`), ``worker_error`` ``[padded_n]`` this rank's residual,
    ``server_error`` ``[chunk]`` the residual of the chunk it serves.
    Returns ``(avg, new_worker_error, new_server_error)``; ``avg`` is
    bit for bit equal on every rank."""
    world = group.size if group is not None and group.active else 1
    rank = group.rank if world > 1 else 0
    if n_valid is None:
        n_valid = x.shape[-1]
    packed, scale, new_worker = compressed_worker(x, worker_error, world,
                                                  n_valid)
    recv = scatter_to_chunk_servers(packed, group)
    scales = gather_from_chunk_servers(scale, group)
    s_packed, s_scale, new_server = compressed_server(
        recv, scales, server_error, rank, n_valid)
    all_packed, all_scales = gather_from_chunk_servers(
        (s_packed, s_scale), group)
    return compressed_decode(all_packed, all_scales, n_valid), new_worker, \
        new_server
