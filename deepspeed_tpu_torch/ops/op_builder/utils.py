"""flatten / unflatten of fp32 CPU tensors through the C++ helper
(``ops/csrc/flatten_unflatten.cpp``, the JAX package's
``csrc/utils/flatten_unflatten.cpp``): the apex-style
``_flatten_dense_tensors`` / ``_unflatten_dense_tensors`` pair. The copy
is bytes only, so a round trip is exact."""

import ctypes

import torch

from deepspeed_tpu_torch.ops.op_builder.builder import UtilsBuilder

_BUILDER = UtilsBuilder()


def _check(tensors):
    for t in tensors:
        if t.device.type != "cpu" or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(
                f"flatten / unflatten take contiguous fp32 CPU tensors, got "
                f"{t.dtype} on {t.device} (contiguous {t.is_contiguous()})")


def _pointers(tensors):
    pf = ctypes.POINTER(ctypes.c_float)
    return (pf * len(tensors))(*[ctypes.cast(t.data_ptr(), pf)
                                 for t in tensors])


def _sizes(tensors):
    return (ctypes.c_int64 * len(tensors))(*[t.numel() for t in tensors])


def flatten(tensors):
    """The tensors' elements back to back in one new 1-D fp32 tensor."""
    tensors = list(tensors)
    _check(tensors)
    lib = _BUILDER.load()
    out = torch.empty(sum(t.numel() for t in tensors), dtype=torch.float32)
    if tensors:
        lib.ds_flatten(_pointers(tensors), _sizes(tensors), len(tensors),
                       ctypes.cast(out.data_ptr(),
                                   ctypes.POINTER(ctypes.c_float)))
    return out


def unflatten(flat, like):
    """New tensors shaped as ``like``'s, filled from ``flat`` in order."""
    like = list(like)
    _check([flat])
    n = sum(t.numel() for t in like)
    if flat.numel() != n:
        raise ValueError(f"flat buffer holds {flat.numel()} elements, the "
                         f"tensors {n}")
    outs = [torch.empty(t.shape, dtype=torch.float32) for t in like]
    if outs:
        _BUILDER.load().ds_unflatten(
            ctypes.cast(flat.data_ptr(), ctypes.POINTER(ctypes.c_float)),
            _sizes(outs), len(outs), _pointers(outs))
    return outs
