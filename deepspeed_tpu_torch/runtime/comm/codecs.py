"""Codec registry and the chunk / wire codecs (port of
``deepspeed_tpu/runtime/comm/codecs.py``) on torch dtypes.

One codec = one storage dtype plus the largest magnitude it holds.
``encode_chunks`` / ``decode_chunks`` quantize with a per-chunk absmax
scale (int8 rounds half to even and clips, the fp8 codecs saturate-cast);
``encode_wire`` / ``decode_wire`` pack the payload and its f32 scales
into one flat uint8 buffer, byte for byte JAX's, which the stage-3 fp8
wire all-gathers (``runtime/zero/stage3.py``). The KV cache keeps its
own absmax recipe (`inference/cache.py:_quantize`).
"""

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Codec:
    """A storage format: target dtype + largest representable magnitude."""

    name: str
    dtype: torch.dtype
    qmax: float
    integer: bool = False


CODECS = {
    "int8": Codec("int8", torch.int8, 127.0, integer=True),
    "f8e4m3fn": Codec("f8e4m3fn", torch.float8_e4m3fn, 448.0),
    "f8e5m2": Codec("f8e5m2", torch.float8_e5m2, 57344.0),
}


def get_codec(codec):
    """Resolve a codec name (or pass through a Codec / None)."""
    if codec is None or isinstance(codec, Codec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {codec!r}; expected one of "
            f"{sorted(CODECS)}")


def encode_chunks(x, chunk_size, codec="int8"):
    """Flatten ``x`` into ``chunk_size`` chunks and quantize each with a
    per-chunk absmax scale (JAX ``encode_chunks``): ``(q [n_chunks,
    chunk_size]`` in the codec dtype, ``scales`` f32 ``[n_chunks])``."""
    codec = get_codec(codec)
    chunks = x.reshape(-1, chunk_size).to(torch.float32)
    absmax = chunks.abs().amax(dim=1)
    scale = absmax / codec.qmax
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    scaled = chunks / safe[:, None]
    if codec.integer:
        q = torch.clamp(torch.round(scaled), -codec.qmax, codec.qmax)
    else:
        q = torch.clamp(scaled, -codec.qmax, codec.qmax)
    return q.to(codec.dtype), scale


def decode_chunks(q, scales, dtype=torch.float32):
    """Inverse of :func:`encode_chunks`: ``q.numel()`` values in
    ``dtype``, the product taken in ``dtype``."""
    return (q.to(dtype) * scales[:, None].to(dtype)).reshape(-1)


def _itemsize(codec):
    return torch.empty((), dtype=codec.dtype).element_size()


def wire_layout(shape, codec, chunk_size=512):
    """``(n, c, n_chunks, payload_bytes, total_bytes)`` of the packed
    wire buffer for a payload of ``shape`` (JAX ``wire_layout``)."""
    codec = get_codec(codec)
    n = int(math.prod(shape)) if shape else 1
    c = max(1, min(int(chunk_size), int(n)))
    n_chunks = -(-n // c)
    payload_bytes = n_chunks * c * _itemsize(codec)
    return n, c, n_chunks, payload_bytes, payload_bytes + 4 * n_chunks


def wire_nbytes(shape, codec, chunk_size=512):
    """Bytes on the wire for one encoded payload of ``shape``."""
    return wire_layout(shape, codec, chunk_size)[-1]


def encode_wire(x, codec, chunk_size=512):
    """Quantize ``x`` and pack payload and f32 scales into one flat
    uint8 buffer ``[payload_bytes | 4 * n_chunks]`` (JAX
    ``encode_wire``; the same bytes): one collective operand."""
    codec = get_codec(codec)
    n, c, n_chunks, _, _ = wire_layout(x.shape, codec, chunk_size)
    flat = x.reshape(-1).to(torch.float32)
    pad = n_chunks * c - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scales = encode_chunks(flat, c, codec)
    return torch.cat([q.reshape(-1).view(torch.uint8),
                      scales.view(torch.uint8)])


def decode_wire(wire, codec, shape, dtype=torch.float32, chunk_size=512):
    """Inverse of :func:`encode_wire`: ``shape`` in ``dtype``."""
    codec = get_codec(codec)
    n, c, n_chunks, payload_bytes, total = wire_layout(shape, codec,
                                                       chunk_size)
    q = wire[:payload_bytes].clone().view(codec.dtype) \
        .reshape(n_chunks, c)
    scales = wire[payload_bytes:total].clone().view(torch.float32)
    flat = decode_chunks(q, scales, torch.float32)[:n]
    return flat.reshape(shape).to(dtype)
