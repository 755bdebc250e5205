"""Ring-buffer KV cache (the ring layout of
``deepspeed_tpu/inference/cache.py``).

One cache = one statically-shaped buffer per layer, ``[max_batch,
max_seq, n_head, head_dim]`` for keys and values, keyed ``h_<i>`` like
the model's layers. Rows are the ring: a finished request's row is
handed to the next admitted request and simply overwritten.

The cache is mutated in place — the PyTorch form of the JAX engine's
buffer donation: every write lands in the engine's one set of buffers,
so the cache never exists twice on the device.

Causality comes from explicit positions, not shapes: every write lands
at the token's absolute position and every read masks cache index
``s`` unless ``s <= query position``. A slot past a row's live prefix
is either stale (the row's previous tenant) or garbage from a padded
prefill chunk — both masked, and both overwritten before the mask ever
exposes them.

Optional int8/fp8 storage uses the codec recipe (absmax scale into the
codec's ``qmax``, zero guard, round+clip for int) at per-(row,
position, head) scale granularity.
"""

import dataclasses
from typing import Optional

import torch

from deepspeed_tpu_torch.runtime.comm.codecs import CODECS, get_codec


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static shape + storage format of one engine's KV cache."""
    n_layer: int
    max_batch: int
    max_seq: int
    n_head: int
    head_dim: int
    dtype: torch.dtype = torch.bfloat16  # storage (codec dtype if quantized)
    codec: Optional[str] = None     # None | "int8" | "f8e4m3fn" | "f8e5m2"


def spec_for_model(cfg, max_batch, max_seq, kv_cache_dtype=None):
    """Resolve a :class:`KVCacheSpec` from a ``GPT2Config`` and the
    ``kv_cache_dtype`` knob (None = model compute dtype, "bf16"/"f32" =
    plain storage, a codec name = quantized storage)."""
    codec = None
    if kv_cache_dtype is None:
        dtype = cfg.dtype
    elif kv_cache_dtype == "bf16":
        dtype = torch.bfloat16
    elif kv_cache_dtype in ("f32", "fp32"):
        dtype = torch.float32
    elif kv_cache_dtype in CODECS:
        codec = kv_cache_dtype
        dtype = CODECS[kv_cache_dtype].dtype
    else:
        raise ValueError(
            f"kv_cache_dtype must be None, 'bf16', 'f32', or a codec "
            f"name from {sorted(CODECS)}; got {kv_cache_dtype!r}")
    if max_seq > cfg.n_positions:
        raise ValueError(
            f"max seq bucket {max_seq} exceeds the model's n_positions "
            f"{cfg.n_positions}")
    return KVCacheSpec(
        n_layer=cfg.n_layer, max_batch=int(max_batch),
        max_seq=int(max_seq), n_head=cfg.n_head,
        head_dim=cfg.n_embd // cfg.n_head, dtype=dtype, codec=codec)


def init_kv_cache(spec, device):
    """Zero-filled cache ``{"h_<i>": {"k", "v"(, "k_scale",
    "v_scale")}}`` on ``device``."""
    shape = (spec.max_batch, spec.max_seq, spec.n_head, spec.head_dim)

    def layer():
        leaves = {"k": torch.zeros(shape, dtype=spec.dtype, device=device),
                  "v": torch.zeros(shape, dtype=spec.dtype, device=device)}
        if spec.codec is not None:
            for name in ("k_scale", "v_scale"):
                leaves[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device)
        return leaves

    return {f"h_{i}": layer() for i in range(spec.n_layer)}


def _leaves(cache):
    for layer in cache.values():
        yield from layer.items()


def kv_cache_nbytes(cache):
    return sum(t.numel() * t.element_size() for _, t in _leaves(cache))


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def cache_dtype_census(cache):
    """``{dtype_str: leaf count}`` over the cache's k/v payload leaves
    (scales excluded); dtype names as numpy spells them."""
    census = {}
    for key, t in _leaves(cache):
        if key.endswith("_scale"):
            continue
        dt = _dtype_name(t.dtype)
        census[dt] = census.get(dt, 0) + 1
    return census


def _codec_of(layer_cache):
    """Recover the storage codec from the cache leaves: quantized
    caches are the ones with scale leaves, and the payload dtype names
    the codec."""
    if "k_scale" not in layer_cache:
        return None
    dt = layer_cache["k"].dtype
    for codec in CODECS.values():
        if codec.dtype == dt:
            return codec
    raise ValueError(
        f"quantized KV cache stores dtype {dt} which matches no codec "
        f"in {sorted(CODECS)}")


def _quantize(x, codec):
    """Per-(row, position, head) absmax quantization (the head vector
    is the chunk)."""
    codec = get_codec(codec)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = absmax / codec.qmax
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    scaled = xf / safe[..., None]
    if codec.integer:
        q = torch.clamp(torch.round(scaled), -codec.qmax, codec.qmax)
    else:
        q = torch.clamp(scaled, -codec.qmax, codec.qmax)
    return q.to(codec.dtype), scale


def _dequantize(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def write_kv(layer_cache, k_new, v_new, positions):
    """Write one chunk's keys/values (``[B, T, H, D]``, compute dtype)
    into a layer's cache IN PLACE at ``positions`` [B, T] (contiguous
    per row); quantizes on the way in when the cache stores a codec
    dtype. Returns ``layer_cache``.

    A row's write starts at ``positions[:, 0]`` clamped so the chunk
    fits the buffer — the start clamp of the JAX package's
    ``dynamic_update_slice``."""
    B, T = positions.shape
    S = layer_cache["k"].shape[1]
    start = positions[:, 0].long().clamp(0, S - T)
    rows = torch.arange(B, device=positions.device)[:, None]
    cols = start[:, None] + torch.arange(T, device=positions.device)
    codec = _codec_of(layer_cache)
    if codec is None:
        updates = {"k": k_new, "v": v_new}
    else:
        k_q, k_s = _quantize(k_new, codec)
        v_q, v_s = _quantize(v_new, codec)
        updates = {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}
    for name, val in updates.items():
        buf = layer_cache[name]
        buf[rows, cols] = val.to(buf.dtype)
    return layer_cache


def read_kv(layer_cache, dtype):
    """The full ``[B, S, H, D]`` key/value buffers in compute ``dtype``
    (dequantized when stored quantized)."""
    codec = _codec_of(layer_cache)
    if codec is None:
        return layer_cache["k"].to(dtype), layer_cache["v"].to(dtype)
    return (_dequantize(layer_cache["k"], layer_cache["k_scale"], dtype),
            _dequantize(layer_cache["v"], layer_cache["v_scale"], dtype))


def attention_mask(layer_cache, positions):
    """The dense path's ``[B, T, S]`` position mask (cache index ``s``
    visible to the query at position ``p`` iff ``s <= p``), computed
    once per step by the model and shared by every layer."""
    S = layer_cache["k"].shape[-3]
    return (torch.arange(S, device=positions.device)[None, None, :]
            <= positions[:, :, None])


def attention_scale(head_dim, dtype):
    """``1 / sqrt(head_dim)`` rounded as the JAX model computes it (in
    the compute dtype), as a Python float so multiplying by it costs no
    host-to-device copy."""
    return float(1.0 / torch.sqrt(torch.tensor(head_dim, dtype=dtype)))


def _flash_attend(q, layer_cache, positions, block_k):
    """Flash attention straight over the STORAGE buffers: quantized
    caches feed int8/f8 payloads + f32 scales to the kernel
    (`ops/flash_decode.py`), never a dequantized copy."""
    from deepspeed_tpu_torch.ops.flash_decode import flash_decode

    scales = ()
    if "k_scale" in layer_cache:
        scales = (layer_cache["k_scale"], layer_cache["v_scale"])
    return flash_decode(q, layer_cache["k"], layer_cache["v"],
                        positions[:, 0], *scales, block_k=block_k)


def cached_attention(q, k_new, v_new, layer_cache, positions,
                     compute_dtype, impl="dense", block_k=128, mask=None):
    """Write this chunk's k/v, then attend over the whole cache row.

    ``q``/``k_new``/``v_new``: ``[B, T, H, D]`` (T = 1 for a decode
    step, ``prefill_chunk`` for a prefill chunk); ``positions``:
    ``[B, T]`` absolute token positions, contiguous per row. Returns
    ``(y [B, T, H, D], layer_cache)`` (the cache updated in place).

    ``impl="flash"`` routes decode steps (T == 1) through the flash
    decode kernel; prefill chunks (T > 1) always use the dense path.
    ``mask``: a precomputed :func:`attention_mask` (dense path only).
    """
    layer_cache = write_kv(layer_cache, k_new, v_new, positions)
    if impl == "flash" and q.shape[1] == 1:
        y = _flash_attend(q, layer_cache, positions, block_k)
        return y.to(compute_dtype), layer_cache
    k_full, v_full = read_kv(layer_cache, compute_dtype)
    att = torch.einsum("bthd,bshd->bhts", q, k_full) * \
        attention_scale(q.shape[-1], compute_dtype)
    if mask is None:
        mask = attention_mask(layer_cache, positions)
    att = torch.where(mask[:, None], att, torch.finfo(att.dtype).min)
    att = torch.softmax(att.float(), dim=-1).to(compute_dtype)
    y = torch.einsum("bhts,bshd->bthd", att, v_full)
    return y, layer_cache


def slice_rows(cache, slot):
    """The one-row sub-cache at row ``slot``: views into the cache, so
    writes through them land in the cache itself."""
    return {name: {k: t.narrow(0, slot, 1) for k, t in layer.items()}
            for name, layer in cache.items()}


def update_rows(cache, rows_tree, slot):
    """Inverse of :func:`slice_rows`: write a row block back. A view
    from :func:`slice_rows` already aliases its rows, so only a
    detached block is copied."""
    for name, layer in rows_tree.items():
        for key, rows in layer.items():
            dst = cache[name][key].narrow(0, slot, rows.shape[0])
            if rows.data_ptr() != dst.data_ptr():
                dst.copy_(rows)
    return cache
