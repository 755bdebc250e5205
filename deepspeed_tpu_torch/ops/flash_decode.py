"""Flash decode over the serving ring KV cache.

Port of ``deepspeed_tpu/ops/pallas/flash_decode.py:flash_decode``: the
decode step attends one query token per row over that row's cache
``k``/``v`` ``[B, S, H, D]``, admitting cache index ``s`` iff ``s <=
positions[b]``, with int8 / fp8 storage dequantized on the fly through
per-(row, position, head) f32 scales.

On CUDA tensors :func:`flash_decode` launches the hand-written
``sm_90a`` kernel in ``ops/csrc/flash_decode.cu`` (built from source at
first use, see ``ops/_build.py``); a build or launch failure raises.
On CPU tensors it runs :func:`flash_decode_reference`, the plain
PyTorch version of the same arithmetic, which the CPU tests hold to
the JAX kernel and ``chip_smoke.py`` holds the CUDA kernel to.
``flash_decode.launches`` counts kernel launches (plain-version calls
do not count), so a run can show that its decode steps went through
the kernel.
"""

import ctypes
import functools

import torch

# ``deepspeed_tpu/ops/pallas/flash_attention.py:DEFAULT_MASK_VALUE``:
# the score of a masked key; exp() of it minus any live max is an
# exact 0 in fp32.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

DEFAULT_BLOCK_K = 128
MAX_HEAD_DIM = 256

# dtype codes of ops/csrc/flash_decode.cu
_DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
    torch.int8: 3, torch.float8_e4m3fn: 4, torch.float8_e5m2: 5,
}
_Q_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


class KernelGeometryError(ValueError):
    """Invalid flash-decode block geometry, raised at call time.
    Subclasses ``ValueError``, as in the JAX package."""


def _validate_block_k(block_k, extent, extent_name):
    """Clamp and validate ``block_k`` against the KV extent it tiles:
    >= 1, clamped to ``extent``, and dividing it. (The JAX package's
    further sublane-tile rule is a constraint of the TPU compiler's
    register tiling and has no counterpart on the GPU.)"""
    block_k = int(block_k)
    if block_k < 1:
        raise KernelGeometryError(
            f"attention block_k must be >= 1, got {block_k}")
    block_k = min(block_k, int(extent))
    if extent % block_k:
        raise KernelGeometryError(
            f"{extent_name} {extent} must be a multiple of attention "
            f"block_k {block_k}")
    return block_k


def _check_args(q, k, v, k_scale, v_scale, block_k):
    B, S, H, D = k.shape
    if tuple(q.shape) != (B, 1, H, D):
        raise ValueError(
            f"flash_decode takes one query token per row: q shape "
            f"{tuple(q.shape)} != {(B, 1, H, D)}")
    block_k = _validate_block_k(block_k, S, "max_seq")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    return block_k


def flash_decode_reference(q, k, v, positions, k_scale=None, v_scale=None,
                           block_k=DEFAULT_BLOCK_K):
    """Plain PyTorch flash decode, block by block as the TPU kernel
    runs it: per ``block_k`` KV block, rows whose position reaches the
    block update an online-softmax state (fp32 max, sum, acc); masked
    keys inside a live block score ``DEFAULT_MASK_VALUE``. Same
    argument contract and scaling order as :func:`flash_decode`."""
    block_k = _check_args(q, k, v, k_scale, v_scale, block_k)
    B, S, H, D = k.shape
    pos = positions.to(device=k.device, dtype=torch.long).reshape(B)
    qf = q[:, 0].float()                                    # [B, H, D]
    acc = torch.zeros(B, H, D, dtype=torch.float32, device=k.device)
    m = torch.full((B, H), float("-inf"), dtype=torch.float32,
                   device=k.device)
    l = torch.zeros(B, H, dtype=torch.float32, device=k.device)
    scale = D ** -0.5
    for k0 in range(0, S, block_k):
        run = (k0 <= pos)[:, None]                           # [B, 1]
        kb = k[:, k0:k0 + block_k].float()                   # [B, bk, H, D]
        s = torch.einsum("bhd,bshd->bhs", qf, kb)
        if k_scale is not None:
            s = s * k_scale[:, k0:k0 + block_k].permute(0, 2, 1)
        s = s * scale
        k_pos = torch.arange(k0, k0 + block_k, device=k.device)
        s = torch.where(k_pos[None, None, :] <= pos[:, None, None], s,
                        DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = torch.where(run, l * corr + pr.sum(-1), l)
        m = torch.where(run, m_new, m)
        if v_scale is not None:
            pr = pr * v_scale[:, k0:k0 + block_k].permute(0, 2, 1)
        vb = v[:, k0:k0 + block_k].float()
        upd = acc * corr[..., None] + torch.einsum("bhs,bshd->bhd", pr, vb)
        acc = torch.where(run[..., None], upd, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out[:, None].to(q.dtype)


def flash_decode(q, k, v, positions, k_scale=None, v_scale=None,
                 block_k=DEFAULT_BLOCK_K):
    """Split-K flash decode over one layer's cache buffers.

    ``q``: ``[B, 1, H, D]`` compute-dtype query (f32, bf16 or f16).
    ``k``/``v``: ``[B, S, H, D]`` cache buffers in STORAGE dtype —
    compute dtype, or int8 / float8_e4m3fn / float8_e5m2 with
    ``k_scale``/``v_scale`` ``[B, S, H]`` f32 absmax scales
    (`inference/cache.py` layout). They are read in place through their
    strides (the head dim must be contiguous). ``positions``: ``[B]``
    int, each row's current write position. Returns ``[B, 1, H, D]``
    in ``q.dtype``.

    ``block_k`` is validated as the JAX kernel validates it (>= 1,
    clamped to S, dividing S; else :class:`KernelGeometryError`) and
    sets the plain version's block walk. The CUDA kernel has no KV
    block grid: its warps walk the occupied keys directly, so the value
    does not change its result beyond fp32 summation order.
    """
    block_k = _check_args(q, k, v, k_scale, v_scale, block_k)
    tensors = [q, k, v, positions] + (
        [k_scale, v_scale] if k_scale is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"flash_decode inputs span devices {sorted(map(str, devices))}")
    device = q.device
    if device.type == "cpu":
        return flash_decode_reference(q, k, v, positions, k_scale,
                                      v_scale, block_k=block_k)
    if device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, got {device}")
    return _launch(q, k, v, positions, k_scale, v_scale)


flash_decode.launches = 0


@functools.lru_cache(None)
def _library():
    from deepspeed_tpu_torch.ops._build import load_library
    lib = load_library("flash_decode")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_decode_launch.argtypes = (
        [p] * 7 + [i] * 4 + [ctypes.c_float] + [i64] * 16 + [i, i, p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, positions, k_scale, v_scale):
    B, S, H, D = k.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(
            f"flash_decode kernel takes head_dim <= {MAX_HEAD_DIM}, got {D}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"flash_decode: query dtype {q.dtype} not in "
                        f"{_Q_DTYPES}")
    if k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"flash_decode: cache dtypes k={k.dtype} "
                        f"v={v.dtype} unsupported or mismatched")
    quant = k_scale is not None
    if quant != (k.dtype in (torch.int8, torch.float8_e4m3fn,
                             torch.float8_e5m2)):
        raise TypeError(
            f"flash_decode: {k.dtype} storage "
            f"{'must not' if quant else 'needs'} k/v scales")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_decode: {name} head dim must be "
                             f"contiguous, strides {t.stride()}")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != (B, S, H):
                raise ValueError(
                    f"flash_decode: {name} must be f32 [B, S, H], got "
                    f"{t.dtype} {tuple(t.shape)}")
    pos = positions.reshape(B).to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _library()
    if quant:
        ks, vs = k_scale, v_scale
        scale_args = (ks.data_ptr(), vs.data_ptr())
        scale_strides = (*ks.stride(), *vs.stride())
    else:
        scale_args = (None, None)
        scale_strides = (0,) * 6
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scale_args,
            pos.data_ptr(), out.data_ptr(),
            B, S, H, D, float(D ** -0.5),
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *scale_strides,
            out.stride(0), out.stride(2),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], stream)
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_decode kernel launch failed: {msg}")
    flash_decode.launches += 1
    return out
