"""Codec registry (the ``Codec``/``CODECS``/``get_codec`` part of
``deepspeed_tpu/runtime/comm/codecs.py``) on torch dtypes.

One codec = one storage dtype plus the largest magnitude it holds; the
absmax recipe that uses them lives where they are used
(`inference/cache.py:_quantize` for the KV cache).
"""

import dataclasses

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
