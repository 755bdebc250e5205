"""Flash attention for training: forward, dQ and dK/dV kernels.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py``. Three TPU
kernels become three hand-written ``sm_90a`` CUDA kernels in
``ops/csrc/flash_attention.cu`` (built from source at first use, see
``ops/_build.py``):

- K1 :func:`flash_attention_fwd` (``_pallas_fwd``): online-softmax
  attention over KV tiles, writing the output and the row logsumexp;
- K2 :func:`flash_attention_bwd_dq` (``_pallas_bwd`` dq_kernel): dQ
  accumulated over KV tiles from lse and ``delta = rowsum(dO * O)``;
- K3 :func:`flash_attention_bwd_dkv` (``_pallas_bwd`` dkv_kernel): dK and
  dV accumulated over Q tiles, plus the per-head key-bias gradient
  partials when a bias is given.

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its kernel on CUDA tensors (a build or launch failure raises; there is
no fallback), and counts kernel launches in ``.launches``.
:func:`flash_attention` is the public, differentiable entry
(a ``torch.autograd.Function``); ``delta`` and the head-sum of the
dbias partials are plain torch ops, as the JAX code leaves them to XLA.

Layout: q ``[B, T, H, D]``, k/v ``[B, S, H, D]`` as in the JAX package;
the kernels read them in place through their strides (the head dim must
be contiguous), so no head-folded copy is made. lse and delta are f32
``[B * H, T]``, the JAX ``[B * H, T, 1]`` without its unit axis.

Attention-prob dropout is the counter-based hash of
:func:`dropout_multiplier`: plain int32 arithmetic on global
(head, query, key) coordinates, so the kernels, the plain versions and
the JAX package draw bit-identical masks for one int32 seed.
"""

import ctypes
import functools
import numbers

import torch

# ``flash_attention.py:31,34``: the score of a masked key, and the
# additive form of a hard key mask (exp(s - 1e9) is an exact 0 in fp32)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MASK_BIAS = -1e9

# counter-based dropout: the top 24 bits of a murmur3 fmix32 hash
# against round(keep_prob * 2^24) (``flash_attention.py:36-76``)
_DROPOUT_RESOLUTION = 1 << 24
_M32 = 0xFFFFFFFF
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_FOLD = 0x7F4A7C15

# tile of the CUDA kernels (rows of a Q tile = keys of a KV tile)
BLOCK = 64
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# the counter hash, in int64 holding uint32 values
# ---------------------------------------------------------------------------

def _u32(x):
    return torch.as_tensor(x, dtype=torch.int64) & _M32


def _mul32(h, c):
    """``h * c mod 2^32`` for ``h`` in [0, 2^32) without int64
    overflow: split ``h`` into 16-bit halves."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h):
    """murmur3 finalizer over uint32 values (``flash_attention.py:106``;
    the JAX shifts are logical, which int64 holding a uint32 gives)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_C2)
    return h ^ (h >> 16)


def _to_int32(h):
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def _keep_threshold(rate):
    return int(round((1.0 - rate) * _DROPOUT_RESOLUTION))


def dropout_multiplier(seed, head, q_pos, k_pos, rate):
    """Attention-prob dropout multiplier, 0 or ``1 / keep_prob``, at
    global coordinates (head, q_pos, k_pos): bit-identical to the JAX
    ``dropout_multiplier`` (:45). ``seed``/``head`` ints or int tensors,
    ``q_pos``/``k_pos`` int tensors that broadcast; returns fp32."""
    h = (_mul32(_u32(q_pos), _GOLDEN) + _mul32(_u32(k_pos), _FMIX_C2)
         + _mul32(_u32(head), _FMIX_C1) + _u32(seed)) & _M32
    keep = (_fmix32(h) >> 8) < _keep_threshold(rate)
    return keep.to(torch.float32) * torch.tensor(1.0 / (1.0 - rate),
                                                 dtype=torch.float32)


def fold_in_seed(seed, data):
    """Mix ``data`` into an int32 dropout seed with full avalanche
    (``flash_attention.py:116``). Python ints in, Python int out."""
    h = _u32(seed) ^ _mul32(_u32(data), _FOLD)
    return int(_to_int32(_fmix32(h)))


def _global_heads(B, H, head_offset=0, num_heads=None):
    """[B, H] global head coordinate ``b * Hg + head_offset + h``."""
    Hg = H if num_heads is None else int(num_heads)
    return (torch.arange(B)[:, None] * Hg + head_offset
            + torch.arange(H)[None, :])


def _dropout_multiplier_full(B, H, T, S, rate, seed, head_offset=0,
                             num_heads=None, device=None):
    """The [B, H, T, S] multiplier the kernels generate tile-wise
    (``flash_attention.py:128``)."""
    bh = _global_heads(B, H, head_offset, num_heads).to(device)
    return dropout_multiplier(
        seed, bh[:, :, None, None],
        torch.arange(T, device=device)[None, None, :, None],
        torch.arange(S, device=device)[None, None, None, :], rate)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _to_key_bias(key_padding_mask, key_bias):
    """The public mask args as one additive f32 [B, S] bias, or None."""
    if key_padding_mask is not None and key_bias is not None:
        raise ValueError("pass key_padding_mask OR key_bias, not both")
    if key_padding_mask is not None:
        return torch.where(key_padding_mask.bool(), 0.0,
                           MASK_BIAS).to(torch.float32)
    if key_bias is not None:
        return key_bias.to(torch.float32)
    return None


def dense_attention(q, k, v, causal=True, sm_scale=None,
                    key_padding_mask=None, key_bias=None,
                    dropout_rate=0.0, dropout_seed=None,
                    dropout_head_offset=0, dropout_num_heads=None):
    """Plain softmax attention (``flash_attention.py:145``); q, k, v
    ``[B, T, H, D]`` -> ``[B, T, H, D]``, with the shared hash dropout
    applied to the normalized probs."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    bias = _to_key_bias(key_padding_mask, key_bias)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * sm_scale
    T, S = scores.shape[-2:]
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, DEFAULT_MASK_VALUE)
    if bias is not None:
        scores = scores + bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        B, _, H, _ = q.shape
        probs = probs * _dropout_multiplier_full(
            B, H, T, S, dropout_rate, dropout_seed, dropout_head_offset,
            dropout_num_heads, device=q.device)
    return torch.einsum("bhts,bshd->bthd", probs.to(q.dtype), v)


def _blockwise_attention(q, k, v, causal, sm_scale, block_k=256,
                         key_bias=None, dropout_rate=0.0, dropout_seed=None,
                         dropout_head_offset=0, dropout_num_heads=None,
                         return_lse=False):
    """Online-softmax attention over KV blocks
    (``flash_attention.py:180``): memory O(T * block_k) per head. With
    ``return_lse`` also the f32 row logsumexp ``[B * H, T]`` the
    backward consumes (``m + log(max(l, 1e-30))``, as K1 writes it)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    dev = q.device
    qf = q.float() * sm_scale
    bh = _global_heads(B, H, dropout_head_offset,
                       dropout_num_heads).to(dev)[:, :, None, None]
    q_pos = torch.arange(T, device=dev)
    acc = torch.zeros(B, H, T, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, T), float("-inf"), device=dev)
    l = torch.zeros(B, H, T, device=dev)
    block_k = min(block_k, S)
    for k0 in range(0, S, block_k):
        k_pos = torch.arange(k0, min(k0 + block_k, S), device=dev)
        kb = k[:, k0:k0 + block_k].float()
        s = torch.einsum("bthd,bshd->bhts", qf, kb)
        if causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                            DEFAULT_MASK_VALUE)
        if key_bias is not None:
            s = s + key_bias[:, None, None, k0:k0 + block_k].float()
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        m = m_new
        if dropout_rate > 0.0:
            p = p * dropout_multiplier(dropout_seed, bh,
                                       q_pos[None, None, :, None],
                                       k_pos[None, None, None, :],
                                       dropout_rate)
        acc = acc * corr[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p, v[:, k0:k0 + block_k].float())
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l_safe)).reshape(B * H, T)


def flash_attention_fwd_reference(q, k, v, key_bias=None, causal=True,
                                  sm_scale=None, dropout_rate=0.0,
                                  dropout_seed=0, dropout_head_offset=0,
                                  dropout_num_heads=None):
    """Plain K1: ``(out [B, T, H, D], lse f32 [B * H, T])``, walking KV
    blocks of :data:`BLOCK` keys as the kernel does."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _blockwise_attention(
        q, k, v, causal, sm_scale, block_k=BLOCK, key_bias=key_bias,
        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        dropout_head_offset=dropout_head_offset,
        dropout_num_heads=dropout_num_heads, return_lse=True)


def _bwd_probs(q, k, v, g, lse, delta, key_bias, causal, sm_scale,
               dropout_rate, dropout_seed, dropout_head_offset,
               dropout_num_heads):
    """The backward's recomputed [B, H, T, S] tiles, whole:
    ``(p, dropout multiplier or None, dp (dropped), delta [B, H, T, 1])``."""
    B, T, H, _ = q.shape
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.exp(s - lse.reshape(B, H, T, 1))
    dp = torch.einsum("bthd,bshd->bhts", g.float(), v.float())
    mult = None
    if dropout_rate > 0.0:
        mult = _dropout_multiplier_full(
            B, H, T, S, dropout_rate, dropout_seed, dropout_head_offset,
            dropout_num_heads, device=q.device)
        dp = dp * mult
    return p, mult, dp, delta.reshape(B, H, T, 1)


def flash_attention_bwd_dq_reference(q, k, v, g, lse, delta, key_bias=None,
                                     causal=True, sm_scale=None,
                                     dropout_rate=0.0, dropout_seed=0,
                                     dropout_head_offset=0,
                                     dropout_num_heads=None):
    """Plain K2: dq ``[B, T, H, D]`` in q's dtype
    (``ds = p * (dp - delta) * sm_scale``, ``dq = ds @ k``)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p, _, dp, delta = _bwd_probs(q, k, v, g, lse, delta, key_bias, causal,
                                 sm_scale, dropout_rate, dropout_seed,
                                 dropout_head_offset, dropout_num_heads)
    ds = p * (dp - delta) * sm_scale
    return torch.einsum("bhts,bshd->bthd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                      key_bias=None, causal=True,
                                      sm_scale=None, dropout_rate=0.0,
                                      dropout_seed=0, dropout_head_offset=0,
                                      dropout_num_heads=None):
    """Plain K3: ``(dk, dv, dbias_partials)`` — dk/dv ``[B, S, H, D]`` in
    k's dtype, and with a key bias the per-head column sums of the
    pre-scale dS as f32 ``[B * H, S]`` (else None)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    p, mult, dp, delta = _bwd_probs(q, k, v, g, lse, delta, key_bias,
                                    causal, sm_scale, dropout_rate,
                                    dropout_seed, dropout_head_offset,
                                    dropout_num_heads)
    pd = p if mult is None else p * mult
    dv = torch.einsum("bhts,bthd->bshd", pd, g.float()).to(v.dtype)
    ds0 = p * (dp - delta)
    dk = torch.einsum("bhts,bthd->bshd", ds0 * sm_scale,
                      q.float()).to(k.dtype)
    dbias = None
    if key_bias is not None:
        B, _, H, _ = q.shape
        dbias = ds0.sum(dim=2).reshape(B * H, k.shape[1])
    return dk, dv, dbias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(q, k, v, key_bias, extra=()):
    """Validate the inputs; True for CUDA tensors, False for CPU ones."""
    B, T, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (H, D) or \
            v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match "
                         "([B, T, H, D] and [B, S, H, D])")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype} differ")
    if key_bias is not None and tuple(key_bias.shape) != (B, k.shape[1]):
        raise ValueError(f"flash_attention: key_bias shape "
                         f"{tuple(key_bias.shape)} != {(B, k.shape[1])}")
    tensors = [q, k, v, *extra] + ([key_bias] if key_bias is not None
                                   else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flash_attention inputs span devices "
                         f"{sorted(map(str, devices))}")
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {device}")
    return device.type == "cuda"


def _options(q, key_bias, causal, sm_scale, dropout_rate, dropout_seed,
             dropout_head_offset, dropout_num_heads):
    """The keyword arguments every kernel and plain version takes, with
    the defaults resolved."""
    if dropout_rate and not 0.0 < dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
    return dict(key_bias=key_bias, causal=causal,
                sm_scale=q.shape[-1] ** -0.5 if sm_scale is None
                else sm_scale,
                dropout_rate=float(dropout_rate or 0.0),
                dropout_seed=0 if dropout_seed is None else int(dropout_seed),
                dropout_head_offset=dropout_head_offset,
                dropout_num_heads=dropout_num_heads)


def flash_attention_fwd(q, k, v, key_bias=None, causal=True, sm_scale=None,
                        dropout_rate=0.0, dropout_seed=0,
                        dropout_head_offset=0, dropout_num_heads=None):
    """K1: ``(out [B, T, H, D] in q's dtype, lse f32 [B * H, T])``."""
    kw = _options(q, key_bias, causal, sm_scale, dropout_rate, dropout_seed,
                  dropout_head_offset, dropout_num_heads)
    if not _on_cuda(q, k, v, key_bias):
        return flash_attention_fwd_reference(q, k, v, **kw)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch(0, q, k, v, None, None, None, kw, out=out, lse_out=lse)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, g, lse, delta, key_bias=None,
                           causal=True, sm_scale=None, dropout_rate=0.0,
                           dropout_seed=0, dropout_head_offset=0,
                           dropout_num_heads=None):
    """K2: dq ``[B, T, H, D]`` in q's dtype. ``g`` is dO ``[B, T, H, D]``;
    ``lse``/``delta`` f32 ``[B * H, T]``."""
    kw = _options(q, key_bias, causal, sm_scale, dropout_rate, dropout_seed,
                  dropout_head_offset, dropout_num_heads)
    if not _on_cuda(q, k, v, key_bias, (g, lse, delta)):
        return flash_attention_bwd_dq_reference(q, k, v, g, lse, delta, **kw)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(1, q, k, v, g, lse, delta, kw, dq=dq)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, g, lse, delta, key_bias=None,
                            causal=True, sm_scale=None, dropout_rate=0.0,
                            dropout_seed=0, dropout_head_offset=0,
                            dropout_num_heads=None):
    """K3: ``(dk, dv, dbias_partials)`` as
    :func:`flash_attention_bwd_dkv_reference`."""
    kw = _options(q, key_bias, causal, sm_scale, dropout_rate, dropout_seed,
                  dropout_head_offset, dropout_num_heads)
    if not _on_cuda(q, k, v, key_bias, (g, lse, delta)):
        return flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                 **kw)
    B, _, H, _ = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    dbias = None
    if key_bias is not None:
        dbias = torch.empty((B * H, k.shape[1]), dtype=torch.float32,
                            device=q.device)
    _launch(2, q, k, v, g, lse, delta, kw, dk=dk, dv=dv, dbias=dbias)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv, dbias


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _Params(ctypes.Structure):
    """Mirror of ``AttnParams`` in ops/csrc/flash_attention.cu: every
    field 8 bytes wide, so the two layouts cannot drift by padding."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "g", "bias", "lse", "delta",
        "out", "lse_out", "dq", "dk", "dv", "dbias")] + \
        [(name, ctypes.c_int64) for name in (
            "B", "T", "S", "H", "D", "causal", "dropping", "seed",
            "head_offset", "num_heads", "keep_threshold",
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh",
            "v_sb", "v_st", "v_sh", "g_sb", "g_st", "g_sh")] + \
        [("sm_scale", ctypes.c_double), ("inv_keep", ctypes.c_double)]


@functools.lru_cache(None)
def _library():
    from deepspeed_tpu_torch.ops._build import load_library
    lib = load_library("flash_attention")
    lib.flash_attention_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(_Params), ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(which, q, k, v, g, lse, delta, kw, out=None, lse_out=None,
            dq=None, dk=None, dv=None, dbias=None):
    B, T, H, D = q.shape
    S = k.shape[1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{tuple(_DTYPE_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} head dim must be "
                             f"contiguous, strides {t.stride()}")
    if g is not None and (g.shape != q.shape or g.dtype != q.dtype):
        raise ValueError(f"flash_attention: dO {tuple(g.shape)} {g.dtype} "
                         f"!= q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or
                              tuple(t.shape) != (B * H, T) or
                              not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"f32 [B*H, T], got {t.dtype} "
                             f"{tuple(t.shape)}")
    bias = kw["key_bias"]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    num_heads = H if kw["dropout_num_heads"] is None else \
        int(kw["dropout_num_heads"])
    rate = kw["dropout_rate"]
    gs = g.stride() if g is not None else (0,) * 4
    p = _Params(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), g=_ptr(g),
        bias=_ptr(bias), lse=_ptr(lse), delta=_ptr(delta),
        out=_ptr(out), lse_out=_ptr(lse_out),
        dq=_ptr(dq), dk=_ptr(dk), dv=_ptr(dv), dbias=_ptr(dbias),
        B=B, T=T, S=S, H=H, D=D, causal=int(bool(kw["causal"])),
        dropping=int(rate > 0.0), seed=kw["dropout_seed"],
        head_offset=int(kw["dropout_head_offset"]), num_heads=num_heads,
        keep_threshold=_keep_threshold(rate) if rate > 0.0 else 0,
        q_sb=q.stride(0), q_st=q.stride(1), q_sh=q.stride(2),
        k_sb=k.stride(0), k_st=k.stride(1), k_sh=k.stride(2),
        v_sb=v.stride(0), v_st=v.stride(1), v_sh=v.stride(2),
        g_sb=gs[0], g_st=gs[1], g_sh=gs[2],
        sm_scale=float(kw["sm_scale"]),
        inv_keep=1.0 / (1.0 - rate) if rate > 0.0 else 1.0)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(which, ctypes.byref(p),
                                         _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel {which} launch "
                           f"failed: {msg}")


# ---------------------------------------------------------------------------
# public, differentiable entry
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """K1 forward; K2 + K3 backward (FlashAttention-2 split)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, causal, sm_scale, dropout_rate,
                dropout_seed, dropout_head_offset, dropout_num_heads):
        kw = dict(causal=causal, sm_scale=sm_scale,
                  dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                  dropout_head_offset=dropout_head_offset,
                  dropout_num_heads=dropout_num_heads)
        out, lse = flash_attention_fwd(q, k, v, key_bias, **kw)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        B, T, H, _ = q.shape
        g = g.contiguous()
        # delta = rowsum(dO * O), in torch as the JAX code leaves it to
        # XLA (:456); [B, T, H] -> [B * H, T]
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(B * H, T).contiguous()
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, key_bias,
                                    **ctx.kw)
        dk, dv, dbias_part = flash_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                     key_bias, **ctx.kw)
        dbias = None
        if key_bias is not None and ctx.needs_input_grad[3]:
            dbias = dbias_part.reshape(B, H, -1).sum(1).to(key_bias.dtype)
        return dq, dk, dv, dbias, None, None, None, None, None, None


def flash_attention(q, k, v, causal=True, sm_scale=None,
                    key_padding_mask=None, key_bias=None,
                    dropout_rate=0.0, dropout_seed=None,
                    dropout_head_offset=0, dropout_num_heads=None):
    """Memory-efficient attention, q/k/v ``[B, T, H, D]`` -> ``[B, T, H,
    D]``, differentiable in q, k, v and ``key_bias``
    (``flash_attention.py:726``). ``key_padding_mask`` [B, S] bool (True
    = attend) or ``key_bias`` [B, S] additive f32. ``dropout_rate`` /
    ``dropout_seed`` (an int32 value): in-kernel attention-prob dropout
    from the counter hash at global head coordinates
    (``dropout_head_offset`` / ``dropout_num_heads`` for a head shard).

    One route: the CUDA kernels for CUDA tensors, their plain versions
    for CPU tensors (the JAX ``implementation`` switch has no
    counterpart)."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if dropout_rate:
        if not isinstance(dropout_rate, (int, float)):
            raise TypeError("dropout_rate must be a static Python float")
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        if dropout_num_heads is not None:
            if not isinstance(dropout_num_heads, numbers.Integral):
                raise TypeError("dropout_num_heads must be a static int")
            if dropout_num_heads < q.shape[2]:
                raise ValueError(
                    f"dropout_num_heads {dropout_num_heads} < local heads "
                    f"{q.shape[2]}")
        dropout_seed = int(dropout_seed)
    bias = _to_key_bias(key_padding_mask, key_bias)
    if key_padding_mask is not None:
        bias = bias.detach()
    return _FlashAttention.apply(
        q, k, v, bias, bool(causal), float(sm_scale),
        float(dropout_rate or 0.0), dropout_seed or 0,
        int(dropout_head_offset), dropout_num_heads)
