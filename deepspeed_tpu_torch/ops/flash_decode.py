"""Flash decode over the serving KV cache: the ring layout and the
paged pool.

Port of ``deepspeed_tpu/ops/pallas/flash_decode.py``:
:func:`flash_decode` attends one query token per row over that row's
ring cache ``k``/``v`` ``[B, S, H, D]``, admitting cache index ``s``
iff ``s <= positions[b]``, with int8 / fp8 storage dequantized on the
fly through per-(row, position, head) f32 scales.
:func:`flash_decode_paged` does the same over a page pool ``[n_pages,
page_size, H, D]`` through per-row page tables.

On CUDA tensors both launch the hand-written ``sm_90a`` kernels in
``ops/csrc/flash_decode.cu`` (built from source at first use, see
``ops/_build.py``); a build or launch failure raises. On CPU tensors
they run :func:`flash_decode_reference` /
:func:`flash_decode_paged_reference`, the plain PyTorch versions of the
same arithmetic, which the CPU tests hold to the JAX kernels and
``chip_smoke.py`` holds the CUDA kernels to. ``flash_decode.launches``
and ``flash_decode_paged.launches`` count kernel launches (plain-version
calls do not count), so a run can show which kernel its decode steps
went through.
"""

import ctypes
import functools
import threading

import torch

from deepspeed_tpu_torch.ops.head_dim import n_col

# ``deepspeed_tpu/ops/pallas/flash_attention.py:DEFAULT_MASK_VALUE``:
# the score of a masked key; exp() of it minus any live max is an
# exact 0 in fp32.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

DEFAULT_BLOCK_K = 128
# keys of key index a CTA of the CUDA kernels takes (kChunk in
# ops/csrc/flash_decode.cu); a row's live chunks merge in chunk order
DECODE_CHUNK = 128

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


def _block_walk(q, pos, S, block_k, fetch):
    """The TPU kernel's block walk in plain PyTorch: per ``block_k`` KV
    block, rows whose position reaches the block update an online-
    softmax state (fp32 max, sum, acc); masked keys inside a live block
    score ``DEFAULT_MASK_VALUE``. ``fetch(ki, run)`` returns block
    ``ki``'s ``(k, v, k_scale, v_scale)`` for every row, ``[B, bk, H,
    D]`` and ``[B, bk, H]`` (scales None when unquantized); ``run``
    ``[B]`` says which rows use it."""
    B, _, H, D = q.shape
    qf = q[:, 0].float()                                    # [B, H, D]
    acc = torch.zeros(B, H, D, dtype=torch.float32, device=q.device)
    m = torch.full((B, H), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(B, H, dtype=torch.float32, device=q.device)
    scale = D ** -0.5
    for ki in range(S // block_k):
        k0 = ki * block_k
        run = k0 <= pos                                     # [B]
        kb, vb, ksb, vsb = fetch(ki, run)
        s = torch.einsum("bhd,bshd->bhs", qf, kb.float())
        if ksb is not None:
            s = s * ksb.permute(0, 2, 1)
        s = s * scale
        k_pos = torch.arange(k0, k0 + block_k, device=q.device)
        s = torch.where(k_pos[None, None, :] <= pos[:, None, None], s,
                        DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        run = run[:, None]                                  # [B, 1]
        l = torch.where(run, l * corr + pr.sum(-1), l)
        m = torch.where(run, m_new, m)
        if vsb is not None:
            pr = pr * vsb.permute(0, 2, 1)
        upd = acc * corr[..., None] + torch.einsum("bhs,bshd->bhd", pr,
                                                   vb.float())
        acc = torch.where(run[..., None], upd, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out[:, None].to(q.dtype)


def flash_decode_reference(q, k, v, positions, k_scale=None, v_scale=None,
                           block_k=DEFAULT_BLOCK_K):
    """Plain PyTorch flash decode, block by block as the TPU kernel
    runs it (:func:`_block_walk`). Same argument contract and scaling
    order as :func:`flash_decode`."""
    block_k = _check_args(q, k, v, k_scale, v_scale, block_k)
    B, S = k.shape[:2]
    pos = positions.to(device=k.device, dtype=torch.long).reshape(B)

    def fetch(ki, run):
        sl = slice(ki * block_k, (ki + 1) * block_k)
        if k_scale is None:
            return k[:, sl], v[:, sl], None, None
        return k[:, sl], v[:, sl], k_scale[:, sl], v_scale[:, sl]

    return _block_walk(q, pos, S, block_k, fetch)


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
    block grid: its CTAs split the occupied keys into chunks of
    :data:`DECODE_CHUNK` and merge them in chunk order within the one
    launch, so the value does not change its result beyond fp32
    summation order.
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


def _check_paged_args(q, k, v, page_tables, k_scale, v_scale, block_k):
    n_pages, page_size, H, D = k.shape
    B = q.shape[0]
    if tuple(q.shape) != (B, 1, H, D):
        raise ValueError(
            f"flash_decode_paged takes one query token per row: q "
            f"shape {tuple(q.shape)} != {(B, 1, H, D)}")
    if page_tables.shape[0] != B:
        raise ValueError(
            f"page_tables rows {page_tables.shape[0]} != batch {B}")
    block_k = _validate_block_k(block_k, page_size, "page_size")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    return block_k


def flash_decode_paged_reference(q, k, v, positions, page_tables,
                                 k_scale=None, v_scale=None,
                                 block_k=DEFAULT_BLOCK_K):
    """Plain PyTorch paged flash decode: :func:`_block_walk` with each
    row's logical block index clamped to ``positions[b] // block_k``
    BEFORE the page-table lookup (the JAX kernel's index map), and the
    pool read only for rows whose position reaches the block. A table
    entry past a row's occupancy is therefore never used to index the
    pool, whatever it holds. Same argument contract as
    :func:`flash_decode_paged`."""
    block_k = _check_paged_args(q, k, v, page_tables, k_scale, v_scale,
                                block_k)
    page_size = k.shape[1]
    B, n_pt = page_tables.shape
    bpp = page_size // block_k                  # kv blocks per page
    pos = positions.to(device=k.device, dtype=torch.long).reshape(B)
    table = page_tables.to(device=k.device, dtype=torch.long)
    rows = torch.arange(B, device=k.device)
    last = torch.div(pos, block_k, rounding_mode="floor")

    def fetch(ki, run):
        kc = last.clamp(0, ki)
        page = torch.where(run, table[rows, kc // bpp], 0)[:, None]
        slots = ((kc % bpp) * block_k)[:, None] + \
            torch.arange(block_k, device=k.device)
        if k_scale is None:
            return k[page, slots], v[page, slots], None, None
        return (k[page, slots], v[page, slots], k_scale[page, slots],
                v_scale[page, slots])

    return _block_walk(q, pos, n_pt * page_size, block_k, fetch)


def flash_decode_paged(q, k, v, positions, page_tables, k_scale=None,
                       v_scale=None, block_k=DEFAULT_BLOCK_K):
    """Flash decode over a paged KV pool.

    ``q``: ``[B, 1, H, D]`` as in :func:`flash_decode`. ``k``/``v``:
    the POOL buffers ``[n_pages, page_size, H, D]`` in storage dtype
    (scales ``[n_pages, page_size, H]`` when quantized —
    `inference/cache.py` paged layout). ``page_tables``: ``[B,
    pages_per_row]`` int32 physical page ids per row (0 = the trash
    page for unallocated slots). ``positions``: ``[B]`` int write
    positions, same mask contract as :func:`flash_decode` over ``S =
    pages_per_row * page_size``. Returns ``[B, 1, H, D]`` in
    ``q.dtype``.

    Only table entries that cover a key ``s <= min(positions[b], S -
    1)`` are read; entries past a row's occupancy may hold any value,
    out-of-range ids included. ``block_k`` clamps to ``page_size`` and
    must divide it (:class:`KernelGeometryError`); it sets the plain
    version's block walk, while the CUDA kernel splits the occupied keys
    into chunks of :data:`DECODE_CHUNK` as :func:`flash_decode` does (so
    over an in-order table the two kernels agree bit for bit). The table
    and positions are read on the device: no host sync, no host-side
    check of table values.
    """
    block_k = _check_paged_args(q, k, v, page_tables, k_scale, v_scale,
                                block_k)
    tensors = [q, k, v, positions, page_tables] + (
        [k_scale, v_scale] if k_scale is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"flash_decode_paged inputs span devices "
            f"{sorted(map(str, devices))}")
    device = q.device
    if device.type == "cpu":
        return flash_decode_paged_reference(q, k, v, positions, page_tables,
                                            k_scale, v_scale,
                                            block_k=block_k)
    if device.type != "cuda":
        raise ValueError(
            f"flash_decode_paged runs on cuda or cpu, got {device}")
    return _launch_paged(q, k, v, positions, page_tables, k_scale, v_scale)


flash_decode_paged.launches = 0


def _library():
    # one build per process, whichever serving thread launches first
    with _build_lock:
        return _load_library()


_build_lock = threading.Lock()


@functools.lru_cache(None)
def _load_library():
    from deepspeed_tpu_torch.ops._build import load_library
    lib = load_library("flash_decode")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.flash_decode_launch.argtypes = (
        [p] * 9 + [i] * 5 + [ctypes.c_float] + [i64] * 16 + [i, i, p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_paged_launch.argtypes = (
        [p] * 10 + [i] * 6 + [ctypes.c_float] + [i64] * 17 + [i, i, p])
    lib.flash_decode_paged_launch.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(name, q, k, v, k_scale, v_scale, scale_shape):
    """The kernel's own contract: dtypes, scales, strides (any head dim:
    past 256 the launch splits it into ``n_col(D)`` column chunks)."""
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"{name}: query dtype {q.dtype} not in "
                        f"{_Q_DTYPES}")
    if k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"{name}: cache dtypes k={k.dtype} "
                        f"v={v.dtype} unsupported or mismatched")
    quant = k_scale is not None
    if quant != (k.dtype in (torch.int8, torch.float8_e4m3fn,
                             torch.float8_e5m2)):
        raise TypeError(
            f"{name}: {k.dtype} storage "
            f"{'must not' if quant else 'needs'} k/v scales")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} head dim must be "
                             f"contiguous, strides {t.stride()}")
    if quant:
        for tname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32 or tuple(t.shape) != scale_shape:
                raise ValueError(
                    f"{name}: {tname} must be f32 {list(scale_shape)}, "
                    f"got {t.dtype} {tuple(t.shape)}")
        return (k_scale.data_ptr(), v_scale.data_ptr()), \
            (*k_scale.stride(), *v_scale.stride())
    return (None, None), (0,) * 6


# (device index, stream) -> int32 tickets, zero between launches: each
# launch's merging CTAs reset what they counted, so one zero-filled
# buffer per stream serves every later launch (and a CUDA graph replay).
# Serving threads (``inference/fleet.py:ThreadReplica``, one CUDA stream
# each) launch concurrently: the lock makes the buffer's grow-and-replace
# and the wrappers' ``.launches`` counts atomic.
_tickets = {}
_lock = threading.Lock()


def _scratch(q, n_rows, S, D, stream):
    """The launch's chunk-partial workspace (f32, uninitialised) and the
    stream's ticket buffer, at least ``n_rows`` = B * H long."""
    n_chunks = -(-S // DECODE_CHUNK)
    ws = torch.empty(n_rows * n_chunks * (D + 2), dtype=torch.float32,
                     device=q.device)
    key = (q.device.index, stream)
    with _lock:
        tickets = _tickets.get(key)
        if tickets is None or tickets.numel() < n_rows:
            tickets = torch.zeros(n_rows, dtype=torch.int32,
                                  device=q.device)
            _tickets[key] = tickets
    return ws, tickets


def _raise_on(lib, err, name):
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def _launch(q, k, v, positions, k_scale, v_scale):
    B, S, H, D = k.shape
    scale_args, scale_strides = _check_launch(
        "flash_decode", q, k, v, k_scale, v_scale, (B, S, H))
    pos = positions.reshape(B).to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, tickets = _scratch(q, B * H, S, D, stream)
        err = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scale_args,
            pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
            tickets.data_ptr(), B, S, H, D, n_col(D),
            float(D ** -0.5),
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *scale_strides,
            out.stride(0), out.stride(2),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], stream)
    _raise_on(lib, err, "flash_decode")
    with _lock:
        flash_decode.launches += 1
    return out


def _launch_paged(q, k, v, positions, page_tables, k_scale, v_scale):
    n_pages, page_size, H, D = k.shape
    B, n_pt = page_tables.shape
    scale_args, scale_strides = _check_launch(
        "flash_decode_paged", q, k, v, k_scale, v_scale,
        (n_pages, page_size, H))
    pos = positions.reshape(B).to(torch.int32).contiguous()
    table = page_tables.to(torch.int32)
    if table.stride(1) != 1:
        table = table.contiguous()
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ws, tickets = _scratch(q, B * H, n_pt * page_size, D, stream)
        err = lib.flash_decode_paged_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *scale_args,
            pos.data_ptr(), table.data_ptr(), out.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(),
            B, n_pt * page_size, H, D, n_col(D), page_size,
            float(D ** -0.5),
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *scale_strides, table.stride(0),
            out.stride(0), out.stride(2),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], stream)
    _raise_on(lib, err, "flash_decode_paged")
    with _lock:
        flash_decode_paged.launches += 1
    return out
