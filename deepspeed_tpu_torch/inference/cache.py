"""Ring-buffer KV cache and its paged generalization (both layouts of
``deepspeed_tpu/inference/cache.py``).

One cache = one statically-shaped buffer per layer, ``[max_batch,
max_seq, n_head, head_dim]`` for keys and values, keyed ``h_<i>`` like
the model's layers. Rows are the ring: a finished request's row is
handed to the next admitted request and simply overwritten.

The cache is mutated in place — the PyTorch form of the JAX engine's
buffer donation: every write lands in the engine's one set of buffers,
so the cache never exists twice on the device.

The **paged** layout (``KVCacheSpec.page_size > 0``) replaces the
per-row ring with one pool of fixed-size pages per layer, ``[n_pages,
page_size, n_head, head_dim]``, addressed through per-row page tables
(``[B, pages_per_row]`` int32) that reach the programs as plain data.
Pool and table shapes are static, so page allocation, prefix sharing
and host-tier park/resume (`inference/paging.py`) change only table
contents. Physical page 0 is the TRASH page: the allocator never hands
it out, unallocated table entries point at it, and inactive decode rows
write their garbage token there, so every gather and scatter stays
in bounds without per-row branches.

Causality comes from explicit positions, not shapes: every write lands
at the token's absolute position and every read masks cache index
``s`` unless ``s <= query position``. A slot past a row's live prefix
is either stale (the row's previous tenant) or garbage from a padded
prefill chunk — both masked, and both overwritten before the mask ever
exposes them.

A ``scan_layers`` model's cache is stacked like its params
(``KVCacheSpec.stacked``): one ``h`` subtree whose leaves carry a
leading layer axis, ``[L, max_batch, max_seq, H, D]`` (or ``[L,
n_pages, ...]``); each layer reads and writes its slice, a view, so K5
and K6 get one layer's contiguous buffer as before. :func:`batch_axis`
says where the row (or page) axis of a subtree is.

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
    stacked: bool = False           # scan_layers layout (leading layer axis)
    page_size: int = 0              # 0 = ring layout; >0 = paged pool
    n_pages: int = 0                # pool pages incl. the trash page

    @property
    def paged(self):
        return self.page_size > 0

    @property
    def pages_per_row(self):
        """Page-table width: pages covering one row's max_seq span."""
        return self.max_seq // self.page_size if self.paged else 0


def spec_for_model(cfg, max_batch, max_seq, kv_cache_dtype=None,
                   page_size=0, n_pages=0, model_size=1):
    """Resolve a :class:`KVCacheSpec` from a ``GPT2Config`` and the
    ``kv_cache_dtype`` knob (None = model compute dtype, "bf16"/"f32" =
    plain storage, a codec name = quantized storage). ``page_size > 0``
    selects the paged pool; ``n_pages=0`` then defaults to ring-capacity
    parity plus the trash page. ``model_size`` (tensor parallelism) keeps
    this rank's ``n_head / model_size`` heads (:func:`kv_partition_specs`)."""
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
    page_size, n_pages = int(page_size), int(n_pages)
    if page_size:
        if max_seq % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq {max_seq}")
        if not n_pages:
            # ring-capacity parity: every row can fill its full max_seq
            # span at once, plus the reserved trash page
            n_pages = int(max_batch) * (int(max_seq) // page_size) + 1
        if n_pages < 2:
            raise ValueError(
                f"n_pages must be >= 2 (page 0 is the trash page), "
                f"got {n_pages}")
    return KVCacheSpec(
        n_layer=cfg.n_layer, max_batch=int(max_batch),
        max_seq=int(max_seq), n_head=cfg.n_head // int(model_size),
        head_dim=cfg.n_embd // cfg.n_head, dtype=dtype, codec=codec,
        stacked=bool(cfg.scan_layers), page_size=page_size,
        n_pages=n_pages if page_size else 0)


def kv_partition_specs(spec):
    """``{subtree: {leaf: split dim}}``: the cache's head axis split over
    the model axis (JAX ``cache.py:166``), the scales with their heads.
    Each rank allocates only its heads (``spec_for_model(...,
    model_size)``), so decode attention runs on them with no collective
    and the row-parallel ``c_proj`` sum is the only combine. The ring's
    row axis and the pool's page axis sit in the same slot, so one spec
    covers both layouts."""
    lead = 1 if spec.stacked else 0
    per_layer = {"k": lead + 2, "v": lead + 2}
    if spec.codec is not None:
        per_layer.update(k_scale=lead + 2, v_scale=lead + 2)
    if spec.stacked:
        return {"h": per_layer}
    return {f"h_{i}": dict(per_layer) for i in range(spec.n_layer)}


def init_kv_cache(spec, device):
    """Zero-filled cache ``{"h_<i>": {"k", "v"(, "k_scale",
    "v_scale")}}`` on ``device``: ``[max_batch, max_seq, H, D]`` rows
    (ring) or ``[n_pages, page_size, H, D]`` pool pages (paged); with
    ``spec.stacked`` one ``{"h": ...}`` subtree of ``[n_layer, ...]``
    leaves."""
    if spec.paged:
        shape = (spec.n_pages, spec.page_size, spec.n_head, spec.head_dim)
    else:
        shape = (spec.max_batch, spec.max_seq, spec.n_head, spec.head_dim)
    if spec.stacked:
        shape = (spec.n_layer,) + shape

    def layer():
        leaves = {"k": torch.zeros(shape, dtype=spec.dtype, device=device),
                  "v": torch.zeros(shape, dtype=spec.dtype, device=device)}
        if spec.codec is not None:
            for name in ("k_scale", "v_scale"):
                leaves[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=device)
        return leaves

    if spec.stacked:
        return {"h": layer()}
    return {f"h_{i}": layer() for i in range(spec.n_layer)}


def batch_axis(name):
    """The row (ring) or page (paged) axis of the cache subtree
    ``name``: 1 for the stacked ``h`` (after the layer axis), else 0."""
    return 1 if name == "h" else 0


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


def attention_mask(layer_cache, positions, page_table=None):
    """The dense path's ``[B, T, S]`` position mask (cache index ``s``
    visible to the query at position ``p`` iff ``s <= p``), computed
    once per step by the model and shared by every layer. With a paged
    cache ``S`` is ``pages_per_row * page_size``, read off the table."""
    if page_table is not None:
        S = page_table.shape[-1] * layer_cache["k"].shape[-3]
    else:
        S = layer_cache["k"].shape[-3]
    return (torch.arange(S, device=positions.device)[None, None, :]
            <= positions[:, :, None])


def attention_scale(head_dim, dtype):
    """``1 / sqrt(head_dim)`` rounded as the JAX model computes it (in
    the compute dtype), as a Python float so multiplying by it costs no
    host-to-device copy."""
    return float(1.0 / torch.sqrt(torch.tensor(head_dim, dtype=dtype)))


def _scales(layer_cache):
    if "k_scale" in layer_cache:
        return (layer_cache["k_scale"], layer_cache["v_scale"])
    return ()


def _flash_attend(q, layer_cache, positions, block_k):
    """Flash attention straight over the STORAGE buffers: quantized
    caches feed int8/f8 payloads + f32 scales to the kernel
    (`ops/flash_decode.py`), never a dequantized copy."""
    from deepspeed_tpu_torch.ops.flash_decode import flash_decode

    return flash_decode(q, layer_cache["k"], layer_cache["v"],
                        positions[:, 0], *_scales(layer_cache),
                        block_k=block_k)


# ---------------------------------------------------------------------------
# paged pool ops
# ---------------------------------------------------------------------------

def paged_write_kv(layer_cache, k_new, v_new, positions, page_table):
    """Write one chunk's keys/values into the page pool IN PLACE through
    a page table. ``layer_cache`` holds ``[n_pages, page_size, H, D]``
    pool leaves; ``page_table`` is ``[B, pages_per_row]`` int32 of
    physical page ids (0 = trash for unallocated slots); positions are
    contiguous per row as in :func:`write_kv`. Every token lands at
    ``(table[b, p // page_size], p % page_size)``, which covers the
    three shapes the engine writes:

    - decode (``T == 1``): one ``[H, D]`` vector per row. Inactive rows
      sit at position 0 with table entry 0 and collide on the trash page
      (duplicate scatter indices: one of them wins, none is ever read).
    - prefill (``B == 1``): the engine pins ``page_size %
      prefill_chunk == 0`` and chunk-aligned starts, so the chunk fills
      one slice of one page (the JAX package writes it as one
      ``dynamic_update_slice``; the bytes land in the same slots).
    - speculative verify (``T > 1``, any ``B``): a chunk may straddle a
      page boundary; positions past a row's allocated pages hit table
      entry 0 and land on the trash page. (The JAX package sends a
      ``B == 1`` verify chunk down its one-page prefill slice, which
      shifts a straddling chunk onto earlier slots; per-token addressing
      has no such case.)

    Every index is computed on the device: no host sync. Quantization
    on the way in mirrors :func:`write_kv` (per-(page, slot, head)
    scales)."""
    page_size = layer_cache["k"].shape[-3]
    pos = positions.long()
    logical = (pos // page_size).clamp(max=page_table.shape[1] - 1)
    pages = page_table.long().gather(1, logical)
    offs = pos % page_size
    codec = _codec_of(layer_cache)
    if codec is None:
        updates = {"k": k_new, "v": v_new}
    else:
        k_q, k_s = _quantize(k_new, codec)
        v_q, v_s = _quantize(v_new, codec)
        updates = {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}
    for name, val in updates.items():
        buf = layer_cache[name]
        buf[pages, offs] = val.to(buf.dtype)
    return layer_cache


def paged_read_kv(layer_cache, page_table, dtype):
    """Gather each row's pages into contiguous ``[B, S, H, D]``
    key/value buffers in compute ``dtype`` (S = pages_per_row *
    page_size): the dense path's view of the pool. Trash / unallocated
    entries gather page 0's garbage, which the position mask hides."""
    codec = _codec_of(layer_cache)
    idx = page_table.long()

    def gather(buf):
        g = buf[idx]                            # [B, n_pt, ps, ...]
        return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                         + tuple(g.shape[3:]))

    if codec is None:
        return (gather(layer_cache["k"]).to(dtype),
                gather(layer_cache["v"]).to(dtype))
    return (_dequantize(gather(layer_cache["k"]),
                        gather(layer_cache["k_scale"]), dtype),
            _dequantize(gather(layer_cache["v"]),
                        gather(layer_cache["v_scale"]), dtype))


def _flash_attend_paged(q, layer_cache, positions, page_table, block_k):
    """Paged twin of :func:`_flash_attend`: the kernel reads KV blocks
    straight out of the pool through the page table
    (`ops/flash_decode.py:flash_decode_paged`); no pool-sized gather is
    ever made."""
    from deepspeed_tpu_torch.ops.flash_decode import flash_decode_paged

    return flash_decode_paged(q, layer_cache["k"], layer_cache["v"],
                              positions[:, 0], page_table,
                              *_scales(layer_cache), block_k=block_k)


def cached_attention(q, k_new, v_new, layer_cache, positions,
                     compute_dtype, impl="dense", block_k=128, mask=None,
                     page_table=None):
    """Write this chunk's k/v, then attend over the whole cache row.

    ``q``/``k_new``/``v_new``: ``[B, T, H, D]`` (T = 1 for a decode
    step, ``prefill_chunk`` for a prefill chunk); ``positions``:
    ``[B, T]`` absolute token positions, contiguous per row. Returns
    ``(y [B, T, H, D], layer_cache)`` (the cache updated in place).

    ``impl="flash"`` routes decode steps (T == 1) through the flash
    decode kernel; prefill chunks (T > 1) always use the dense path.
    ``mask``: a precomputed :func:`attention_mask` (dense path only).
    ``page_table`` (``[B, pages_per_row]`` int32) switches to the paged
    layout: writes go through :func:`paged_write_kv`, the dense path
    attends over :func:`paged_read_kv`'s gathered view, and flash decode
    steps run the paged kernel. The attention math is layout-blind.
    """
    if page_table is None:
        layer_cache = write_kv(layer_cache, k_new, v_new, positions)
        if impl == "flash" and q.shape[1] == 1:
            y = _flash_attend(q, layer_cache, positions, block_k)
            return y.to(compute_dtype), layer_cache
        k_full, v_full = read_kv(layer_cache, compute_dtype)
    else:
        layer_cache = paged_write_kv(layer_cache, k_new, v_new, positions,
                                     page_table)
        if impl == "flash" and q.shape[1] == 1:
            y = _flash_attend_paged(q, layer_cache, positions, page_table,
                                    block_k)
            return y.to(compute_dtype), layer_cache
        k_full, v_full = paged_read_kv(layer_cache, page_table,
                                       compute_dtype)
    att = torch.einsum("bthd,bshd->bhts", q, k_full) * \
        attention_scale(q.shape[-1], compute_dtype)
    if mask is None:
        mask = attention_mask(layer_cache, positions, page_table)
    att = torch.where(mask[:, None], att, torch.finfo(att.dtype).min)
    att = torch.softmax(att.float(), dim=-1).to(compute_dtype)
    y = torch.einsum("bhts,bshd->bthd", att, v_full)
    return y, layer_cache


def slice_rows(cache, slot):
    """The one-row sub-cache at row ``slot``: views into the cache, so
    writes through them land in the cache itself."""
    return {name: {k: t.narrow(batch_axis(name), slot, 1)
                   for k, t in layer.items()}
            for name, layer in cache.items()}


def update_rows(cache, rows_tree, slot):
    """Inverse of :func:`slice_rows`: write a row block back. A view
    from :func:`slice_rows` already aliases its rows, so only a
    detached block is copied."""
    for name, layer in rows_tree.items():
        for key, rows in layer.items():
            axis = batch_axis(name)
            dst = cache[name][key].narrow(axis, slot, rows.shape[axis])
            if rows.data_ptr() != dst.data_ptr():
                dst.copy_(rows)
    return cache
