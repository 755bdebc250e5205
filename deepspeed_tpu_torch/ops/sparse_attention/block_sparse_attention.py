"""Block-sparse attention: forward, dQ and dK/dV kernels over a layout.

Port of ``deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py``.
A ``SparsityConfig`` layout ``[H, nb, nb]`` (0/1 per block pair) becomes
lookup tables: for each (head, q-block) the nonzero k-blocks (the
forward LUT) and for each (head, k-block) the nonzero q-blocks (the
transposed LUT). Three TPU kernels become hand-written ``sm_90a`` CUDA
kernels in ``ops/csrc/block_sparse_attention.cu``:

- K7 :func:`block_sparse_attention_fwd` (``_pallas_impl``): each
  (b * h, q-block) walks its LUT row with an online softmax, writing the
  output and the row logsumexp;
- K8a :func:`block_sparse_attention_bwd_dq` (``_pallas_bwd_impl``
  dq_kernel): dQ over the forward LUT from lse and
  ``delta = rowsum(dO * O)``;
- K8b :func:`block_sparse_attention_bwd_dkv` (``_pallas_bwd_impl``
  dkv_kernel): dK and dV over the transposed LUT.

All three multiply on the tensor cores (``mma.sync`` m16n8k8) in TF32 at
fp32 precision: each operand x enters as ``tf32_split(x)``'s hi and lo
and each product as hi.hi + hi.lo + lo.hi in fp32. bf16 and fp16 inputs
are exact in TF32 and skip their lo terms; K7's q * sm_scale (rounded
to f32, as the JAX kernel forms it) is exact on them when sm_scale is a
power of two (:func:`scaled_q_exact`). f32, bf16 and fp16 inputs; the
kernel library is built once per type and part (forward, backward).
Any head dim: past 256 a launch splits the output columns into
``ops.head_dim.n_col(D)`` chunks, one CTA each.

Each wrapper runs its plain PyTorch version (``*_reference``, the
kernel's walk and arithmetic, vectorised over heads and blocks) on CPU
tensors and launches its kernel on CUDA tensors (a build or launch
failure raises; there is no fallback), and counts kernel launches in
``.launches``. :func:`block_sparse_attention` is the public,
differentiable entry: with no rpe and no mask it takes the kernel route
(a ``torch.autograd.Function``; the JAX name of that route, ``pallas``,
is accepted), and with any of them the gather route ``xla`` (plain
torch, differentiated by autograd), as the JAX package chooses.
Unlike the JAX ``auto``, which takes the gather route off the TPU, the
port's ``auto`` takes the kernel route on the CPU too: there it runs
the kernels' plain versions. :func:`masked_dense_attention` is the
parity oracle.

Layout: q, k, v ``[B, T, H, D]`` as in the JAX package; the kernels
read them in place through their strides (the head dim must be
contiguous). lse and delta are f32 ``[B * H, T]``, the JAX
``[B * H, T, 1]`` without its unit axis. The LUTs are int32 tensors on
the inputs' device, built by the C++ builder and uploaded once per (layout,
device), as the JAX package caches them per layout: a call makes no
host-to-device copy. Attention-prob dropout is the counter hash of
``ops/flash_attention.py`` at head ``b * H + h`` and global positions.
"""

import ctypes
import functools
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    _dropout_multiplier_full,
    _keep_threshold,
    dropout_multiplier,
)
from deepspeed_tpu_torch.ops.head_dim import n_col

BLOCKS = (16, 32, 64, 128)     # layout blocks the kernels are built for
# the storage types, each its own build of the source (BSA_DTYPE)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# LUT construction (``block_sparse_attention.py:42-99``): the OpenMP C++
# builder (``ops/csrc/lut_builder.cpp``); the numpy builder is its plain
# version, for tests only
# ---------------------------------------------------------------------------

def build_lut_numpy(layout):
    """The plain version of :func:`build_lut` (JAX ``_build_lut_numpy``)."""
    layout = np.asarray(layout)
    H, nq, _ = layout.shape
    nnz = layout.sum(axis=-1).astype(np.int32)
    max_nnz = max(int(nnz.max()), 1)
    lut = np.zeros((H, nq, max_nnz), dtype=np.int32)
    for h in range(H):
        for qi in range(nq):
            cols = np.nonzero(layout[h, qi])[0]
            lut[h, qi, :len(cols)] = cols
    return lut, nnz


def build_lut(layout):
    """Per-(head, q-block) list of nonzero k-block indices, built by the
    C++ builder (``SparseAttnBuilder``; JAX ``_build_lut_native``). A
    build failure raises: unlike the JAX package, the port never falls
    back to the numpy builder.

    layout: [H, nq, nk] 0/1 array ->
      lut: [H, nq, max_nnz] int32 (k-block index; padded entries are 0)
      nnz: [H, nq] int32 (valid entries per row)
    """
    from deepspeed_tpu_torch.ops.op_builder import SparseAttnBuilder

    lib = SparseAttnBuilder().load(verbose=False)
    layout = np.asarray(layout)
    H, nq, nk = layout.shape
    flat = np.ascontiguousarray(layout.reshape(-1), dtype=np.int64)
    p64 = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    max_nnz = max(int(lib.ds_lut_max_nnz(p64, H, nq, nk)), 1)
    lut = np.zeros((H, nq, max_nnz), dtype=np.int32)
    nnz = np.zeros((H, nq), dtype=np.int32)
    lib.ds_build_lut(
        p64, H, nq, nk, max_nnz,
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nnz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return lut, nnz


@functools.lru_cache(maxsize=64)
def _device_tables(layout_bytes, layout_shape, device):
    """``(lut, nnz, lut_t, nnz_t)`` as int32 tensors on ``device``: the
    forward LUT and the transposed one (``build_lut(layout.transpose(0,
    2, 1))``, :551), built and uploaded once per (layout, device), as the
    JAX package caches its LUTs per layout (:96)."""
    layout = np.frombuffer(layout_bytes, dtype=np.int64).reshape(layout_shape)
    lut, nnz = build_lut(layout)
    lut_t, nnz_t = build_lut(layout.transpose(0, 2, 1))
    return tuple(torch.from_numpy(x).to(device)
                 for x in (lut, nnz, lut_t, nnz_t))


def layout_tables(layout, device):
    """The cached device LUTs of ``layout`` (see :func:`_device_tables`)."""
    layout = np.ascontiguousarray(np.asarray(layout).astype(np.int64))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _device_tables(layout.tobytes(), layout.shape, device)


# ---------------------------------------------------------------------------
# gather route ``xla`` (differentiable by autograd; carries rpe / masks)
# ---------------------------------------------------------------------------

def _heads_blocks(x, block):
    """[B, T, H, D] -> [B, H, nb, block, D]."""
    B, T, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, H, T // block, block, D)


def _gather_blocks(xb, lut):
    """xb [B, H, nb, block, ...] at each head's LUT -> [B, H, nq,
    max_nnz, block, ...]."""
    H = lut.shape[0]
    h_idx = torch.arange(H, device=lut.device)[:, None, None]
    return xb[:, h_idx, lut.long()]


def _mask_to_additive(m, mode):
    m = m.float()
    if mode == "mul":
        # reference softmax_fwd.tr:103 - zero entries become -inf
        return torch.where(m == 0, DEFAULT_MASK_VALUE, 0.0)
    return m


def _xla_impl(q, k, v, lut, nnz, block, causal, sm_scale, rpe=None,
              key_padding_mask=None, attn_mask=None,
              key_padding_mask_mode="add", attn_mask_mode="mul",
              dropout_rate=0.0, dropout_seed=None, dropout_head_offset=0):
    """Gather each head's LUT k/v blocks and softmax over them
    (``block_sparse_attention.py:106``). q, k, v [B, T, H, D]; lut/nnz
    int tensors per :func:`build_lut`. Returns [B, T, H, D]. Counts its
    calls in ``.calls`` (a run can show it never took this route)."""
    _xla_impl.calls += 1
    B, T, H, D = q.shape
    nq = T // block
    max_nnz = lut.shape[-1]
    dev = q.device
    lut = lut.long()
    qh = _heads_blocks(q.float(), block) * sm_scale       # [B,H,nq,blk,D]
    kg = _gather_blocks(_heads_blocks(k.float(), block), lut)
    vg = _gather_blocks(_heads_blocks(v.float(), block), lut)
    s = torch.einsum("bhqrd,bhqjcd->bhqrjc", qh, kg)      # [B,H,nq,r,j,c]

    in_block = torch.arange(block, device=dev)
    q_pos = torch.arange(nq, device=dev)[:, None] * block + in_block
    k_pos = lut[..., None] * block + in_block             # [H,nq,nnz,blk]
    valid = torch.arange(max_nnz, device=dev) < nnz.to(dev)[..., None]
    mask = valid[:, :, None, :, None]                     # [H,nq,1,nnz,1]
    if causal:
        mask = mask & (k_pos[:, :, None] <= q_pos[None, :, :, None, None])
    if rpe is not None:
        # rpe [B, H, T, T] added to the scaled scores (softmax_fwd.tr:117)
        r = rpe.float().reshape(B, H, nq, block, nq, block) \
            .permute(0, 1, 2, 4, 3, 5)                    # [B,H,nq,nk,r,c]
        h_idx = torch.arange(H, device=dev)[:, None, None]
        q_idx = torch.arange(nq, device=dev)[None, :, None]
        s = s + r[:, h_idx, q_idx, lut].permute(0, 1, 2, 4, 3, 5)
    if key_padding_mask is not None:
        kp = _mask_to_additive(key_padding_mask, key_padding_mask_mode)
        kp = kp.reshape(B, nq, block)[:, lut]             # [B,H,nq,nnz,blk]
        s = s + kp[:, :, :, None]
    if attn_mask is not None:
        a = _mask_to_additive(attn_mask, attn_mask_mode) \
            .reshape(nq, block, nq, block).permute(0, 2, 1, 3)
        q_idx = torch.arange(nq, device=dev)[None, :, None]
        s = s + a[q_idx, lut].permute(0, 1, 3, 2, 4)[None]
    s = torch.where(mask[None], s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s.reshape(B, H, nq, block, max_nnz * block), dim=-1)
    p = p.reshape(B, H, nq, block, max_nnz, block)
    if dropout_rate > 0.0:
        bh = torch.arange(B, device=dev)[:, None] * H + \
            dropout_head_offset + torch.arange(H, device=dev)
        p = p * dropout_multiplier(
            dropout_seed, bh[:, :, None, None, None, None],
            q_pos[None, None, :, :, None, None],
            k_pos[None, :, :, None, :, :], dropout_rate)
    out = torch.einsum("bhqrjc,bhqjcd->bhqrd", p, vg)
    return out.reshape(B, H, T, D).permute(0, 2, 1, 3).to(q.dtype)


_xla_impl.calls = 0


# ---------------------------------------------------------------------------
# plain versions of K7, K8a, K8b: the kernels' walk over the LUT, one LUT
# column j at a time for every (b, h, block) at once
# ---------------------------------------------------------------------------

def tf32_split(x):
    """``(hi, lo)`` f32 tensors: the operands the K8 kernels feed the
    tensor cores for an fp32 value x. ``hi`` is x rounded to TF32 (10
    explicit mantissa bits) to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: on the 13 low mantissa bits of the
    magnitude, a carry moving into the exponent; ``lo`` the same rounding
    of ``x - hi`` (exact in fp32). hi.hi + hi.lo + lo.hi leaves out only
    lo.lo, about 2^-22 of a product. A value with its 13 low bits zero
    (every bf16 value) has ``lo == 0``; NaN stays NaN."""

    def rna(v):
        # on the int32 view: adding half a step to the magnitude bits
        # rounds it half away from zero for either sign (only a NaN's
        # bits can wrap, and NaN is kept)
        out = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
        return torch.where(torch.isnan(v), v, out)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def scaled_q_exact(dtype, sm_scale):
    """Whether K7's left operand of S, q * sm_scale rounded to f32, is
    exact in TF32 for every q of ``dtype``: a 2-byte q (8 or 11
    significant bits) times a power of two keeps its bits (f32's range
    holds every scaled value, fp16 subnormals too), so the kernel skips
    its lo pass; any other scale, or an f32 q, has a lo term."""
    return (torch.empty((), dtype=dtype).element_size() == 2 and
            sm_scale > 0 and math.frexp(sm_scale)[0] == 0.5)


def _pair_positions(lut_j, block, device):
    """Global positions of the own block rows and of the visited block
    for LUT column ``lut_j`` [H, nb]: ([nb, blk, 1], [H, nb, 1, blk])."""
    nb = lut_j.shape[1]
    in_block = torch.arange(block, device=device)
    own = (torch.arange(nb, device=device)[:, None] * block
           + in_block)[:, :, None]
    other = (lut_j.long()[..., None] * block + in_block)[:, :, None, :]
    return own, other


def _drop_tile(seed, B, H, q_pos, k_pos, rate, device, head_offset=0):
    """The kernels' dropout multiplier of a tile at the global head
    coordinate ``b * H + head_offset + h``."""
    bh = torch.arange(B, device=device)[:, None] * H + head_offset + \
        torch.arange(H, device=device)
    return dropout_multiplier(seed, bh[:, :, None, None, None], q_pos,
                              k_pos, rate)


def _gather_column(xb, lut_j):
    """xb [B, H, nb, blk, ...] at LUT column ``lut_j`` [H, nb]."""
    H = lut_j.shape[0]
    return xb[:, torch.arange(H, device=lut_j.device)[:, None],
              lut_j.long()]


def block_sparse_attention_fwd_reference(q, k, v, lut, nnz, block,
                                         causal=False, sm_scale=None,
                                         dropout_rate=0.0, dropout_seed=0,
                                         dropout_head_offset=0):
    """Plain K7: ``(out [B, T, H, D] in q's dtype, lse f32 [B * H, T])``
    (``_pallas_impl``, :241-293): q pre-scaled before the dot, the
    causal mask's finite value, ``l`` over the undropped and the
    accumulator over the dropped probabilities."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    dev = q.device
    nq = T // block
    lut, nnz = torch.as_tensor(lut), torch.as_tensor(nnz).to(dev)
    qb = _heads_blocks(q.float(), block) * sm_scale         # [B,H,nq,r,D]
    kb = _heads_blocks(k.float(), block)
    vb = _heads_blocks(v.float(), block)
    m = torch.full((B, H, nq, block), float("-inf"), device=dev)
    l = torch.zeros((B, H, nq, block), device=dev)
    acc = torch.zeros((B, H, nq, block, D), device=dev)
    for j in range(lut.shape[-1]):
        lut_j = lut[..., j].to(dev)
        valid = (j < nnz)[None, :, :, None]                   # [1,H,nq,1]
        s = torch.einsum("bhqrd,bhqcd->bhqrc", qb, _gather_column(kb, lut_j))
        q_pos, k_pos = _pair_positions(lut_j, block, dev)
        if causal:
            s = torch.where(k_pos <= q_pos, s, DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1)
        if dropout_rate > 0.0:
            p = p * _drop_tile(dropout_seed, B, H, q_pos, k_pos,
                               dropout_rate, dev, dropout_head_offset)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhqrc,bhqcd->bhqrd", p, _gather_column(vb, lut_j))
        m = torch.where(valid, m_new, m)
        l = torch.where(valid, l_new, l)
        acc = torch.where(valid[..., None], acc_new, acc)
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).reshape(B, H, T, D).permute(0, 2, 1, 3)
    # an empty row keeps m = -inf: out 0, lse -inf
    return out.to(q.dtype), (m + torch.log(l_safe)).reshape(B * H, T)


def _bwd_column(qb, kb, vb, gb, lse_b, delta_b, lut_j, block, causal,
                sm_scale, dropout_rate, dropout_seed, head_offset,
                transposed):
    """One LUT column of the backward: ``(pd, ds, q, k, dO)``, the
    visited tiles' dropped probabilities and scaled dS [B, H, nb, rows,
    cols] (rows = queries) as the kernels form them, and the operand
    blocks they pair. ``transposed``: the own blocks are k-blocks and the
    visited ones q-blocks (K8b)."""
    B, H = qb.shape[:2]
    dev = qb.device
    own, other = _pair_positions(lut_j, block, dev)
    if transposed:
        qg, gg = _gather_column(qb, lut_j), _gather_column(gb, lut_j)
        lse_g = _gather_column(lse_b, lut_j)[..., None]
        delta_g = _gather_column(delta_b, lut_j)[..., None]
        kg, vg = kb, vb
        q_pos, k_pos = other.transpose(-1, -2), own.transpose(-1, -2)
    else:
        kg, vg = _gather_column(kb, lut_j), _gather_column(vb, lut_j)
        qg, gg = qb, gb
        lse_g, delta_g = lse_b[..., None], delta_b[..., None]
        q_pos, k_pos = own, other
    s = torch.einsum("bhqrd,bhqcd->bhqrc", qg, kg) * sm_scale
    if causal:
        s = torch.where(k_pos <= q_pos, s, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse_g)
    dp = torch.einsum("bhqrd,bhqcd->bhqrc", gg, vg)
    pd = p
    if dropout_rate > 0.0:
        mult = _drop_tile(dropout_seed, B, H, q_pos, k_pos, dropout_rate,
                          dev, head_offset)
        dp = dp * mult
        pd = p * mult
    ds = p * (dp - delta_g) * sm_scale
    return pd, ds, qg, kg, gg


def _bwd_operands(q, k, v, g, lse, delta, block):
    B, T, H, _ = q.shape
    nb = T // block
    return ([_heads_blocks(x.float(), block) for x in (q, k, v, g)]
            + [x.float().reshape(B, H, nb, block) for x in (lse, delta)])


def block_sparse_attention_bwd_dq_reference(q, k, v, g, lse, delta, lut, nnz,
                                            block, causal=False,
                                            sm_scale=None, dropout_rate=0.0,
                                            dropout_seed=0,
                                            dropout_head_offset=0):
    """Plain K8a: dq ``[B, T, H, D]`` in q's dtype (``dq_kernel``,
    :381-419): ``p = exp(s * sm_scale - lse)``, the dropped ``dp``,
    ``ds = p * (dp - delta) * sm_scale``, ``dq = sum ds @ k`` over the
    forward LUT. ``g`` is dO; ``lse``/``delta`` f32 ``[B * H, T]``."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    dev = q.device
    qb, kb, vb, gb, lse_b, delta_b = _bwd_operands(q, k, v, g, lse, delta,
                                                   block)
    lut, nnz = torch.as_tensor(lut), torch.as_tensor(nnz).to(dev)
    dq = torch.zeros_like(qb)
    for j in range(lut.shape[-1]):
        lut_j = lut[..., j].to(dev)
        _, ds, _, kg, _ = _bwd_column(qb, kb, vb, gb, lse_b, delta_b, lut_j,
                                      block, causal, sm_scale, dropout_rate,
                                      dropout_seed, dropout_head_offset,
                                      transposed=False)
        valid = (j < nnz)[None, :, :, None, None]
        # an invalid column may hold -inf - -inf: keep it out of the sum
        dq = dq + torch.where(valid, torch.einsum("bhqrc,bhqcd->bhqrd", ds,
                                                  kg), 0.0)
    return dq.reshape(B, H, T, D).permute(0, 2, 1, 3).to(q.dtype)


def block_sparse_attention_bwd_dkv_reference(q, k, v, g, lse, delta, lut_t,
                                             nnz_t, block, causal=False,
                                             sm_scale=None, dropout_rate=0.0,
                                             dropout_seed=0,
                                             dropout_head_offset=0):
    """Plain K8b: ``(dk, dv)`` ``[B, T, H, D]`` in k's / v's dtype
    (``dkv_kernel``, :450-498) over the transposed LUT ``lut_t`` /
    ``nnz_t``: ``dv = sum (p * mult)^T @ dO``, ``dk = sum ds^T @ q``."""
    B, T, H, D = q.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    dev = q.device
    qb, kb, vb, gb, lse_b, delta_b = _bwd_operands(q, k, v, g, lse, delta,
                                                   block)
    lut_t, nnz_t = torch.as_tensor(lut_t), torch.as_tensor(nnz_t).to(dev)
    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    for j in range(lut_t.shape[-1]):
        lut_j = lut_t[..., j].to(dev)
        pd, ds, qg, _, gg = _bwd_column(qb, kb, vb, gb, lse_b, delta_b,
                                        lut_j, block, causal, sm_scale,
                                        dropout_rate, dropout_seed,
                                        dropout_head_offset, transposed=True)
        valid = (j < nnz_t)[None, :, :, None, None]
        dv = dv + torch.where(valid, torch.einsum("bhqrc,bhqrd->bhqcd", pd,
                                                  gg), 0.0)
        dk = dk + torch.where(valid, torch.einsum("bhqrc,bhqrd->bhqcd", ds,
                                                  qg), 0.0)

    def out(x, like):
        return x.reshape(B, H, T, D).permute(0, 2, 1, 3).to(like.dtype)

    return out(dk, k), out(dv, v)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cuda(q, k, v, block, tables, extra=()):
    """Validate the inputs; True for CUDA tensors, False for CPU ones."""
    B, T, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"block_sparse_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ "
                         "(self-attention, [B, T, H, D])")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"block_sparse_attention: dtypes q={q.dtype} "
                        f"k={k.dtype} v={v.dtype} differ")
    if T % block:
        raise ValueError(f"block_sparse_attention: seq len {T} is not a "
                         f"multiple of the block {block}")
    lut, nnz = tables
    if tuple(nnz.shape) != (H, T // block) or lut.shape[:2] != nnz.shape:
        raise ValueError(f"block_sparse_attention: LUT {tuple(lut.shape)} / "
                         f"nnz {tuple(nnz.shape)} do not cover {H} heads "
                         f"x {T // block} blocks")
    devices = {t.device for t in (q, k, v, lut, nnz, *extra)}
    if len(devices) != 1:
        raise ValueError(f"block_sparse_attention inputs span devices "
                         f"{sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_sparse_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return q.device.type == "cuda"


def _options(q, causal, sm_scale, dropout_rate, dropout_seed,
             dropout_head_offset):
    if dropout_rate and not 0.0 < dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
    return dict(causal=bool(causal),
                sm_scale=q.shape[-1] ** -0.5 if sm_scale is None
                else float(sm_scale),
                dropout_rate=float(dropout_rate or 0.0),
                dropout_seed=0 if dropout_seed is None else int(dropout_seed),
                dropout_head_offset=int(dropout_head_offset))


def block_sparse_attention_fwd(q, k, v, lut, nnz, block, causal=False,
                               sm_scale=None, dropout_rate=0.0,
                               dropout_seed=0, dropout_head_offset=0):
    """K7: ``(out [B, T, H, D] in q's dtype, lse f32 [B * H, T])``;
    ``lut``/``nnz`` the forward LUT as int32 tensors on q's device."""
    kw = _options(q, causal, sm_scale, dropout_rate, dropout_seed,
                  dropout_head_offset)
    if not _on_cuda(q, k, v, block, (lut, nnz)):
        return block_sparse_attention_fwd_reference(q, k, v, lut, nnz, block,
                                                    **kw)
    B, T, H, D = q.shape
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    _launch(0, q, k, v, None, None, None, lut, nnz, block, kw, out=out,
            lse_out=lse)
    block_sparse_attention_fwd.launches += 1
    return out, lse


def block_sparse_attention_bwd_dq(q, k, v, g, lse, delta, lut, nnz, block,
                                  causal=False, sm_scale=None,
                                  dropout_rate=0.0, dropout_seed=0,
                                  dropout_head_offset=0):
    """K8a: dq ``[B, T, H, D]`` in q's dtype over the forward LUT."""
    kw = _options(q, causal, sm_scale, dropout_rate, dropout_seed,
                  dropout_head_offset)
    if not _on_cuda(q, k, v, block, (lut, nnz), (g, lse, delta)):
        return block_sparse_attention_bwd_dq_reference(
            q, k, v, g, lse, delta, lut, nnz, block, **kw)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(1, q, k, v, g, lse, delta, lut, nnz, block, kw, dq=dq)
    block_sparse_attention_bwd_dq.launches += 1
    return dq


def block_sparse_attention_bwd_dkv(q, k, v, g, lse, delta, lut_t, nnz_t,
                                   block, causal=False, sm_scale=None,
                                   dropout_rate=0.0, dropout_seed=0,
                                   dropout_head_offset=0):
    """K8b: ``(dk, dv)`` ``[B, T, H, D]`` over the transposed LUT."""
    kw = _options(q, causal, sm_scale, dropout_rate, dropout_seed,
                  dropout_head_offset)
    if not _on_cuda(q, k, v, block, (lut_t, nnz_t), (g, lse, delta)):
        return block_sparse_attention_bwd_dkv_reference(
            q, k, v, g, lse, delta, lut_t, nnz_t, block, **kw)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch(2, q, k, v, g, lse, delta, lut_t, nnz_t, block, kw, dk=dk, dv=dv)
    block_sparse_attention_bwd_dkv.launches += 1
    return dk, dv


block_sparse_attention_fwd.launches = 0
block_sparse_attention_bwd_dq.launches = 0
block_sparse_attention_bwd_dkv.launches = 0


class _Params(ctypes.Structure):
    """Mirror of ``SparseParams`` in ops/csrc/block_sparse_attention.cu:
    every field 8 bytes wide, so the two layouts cannot drift by
    padding."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "g", "lse", "delta", "lut", "nnz", "out", "lse_out",
        "dq", "dk", "dv")] + \
        [(name, ctypes.c_int64) for name in (
            "B", "T", "H", "D", "block", "max_nnz", "causal", "dropping",
            "seed", "keep_threshold", "head_offset", "n_col", "q_exact",
            "q_sb", "q_st", "q_sh", "k_sb", "k_st", "k_sh",
            "v_sb", "v_st", "v_sh", "g_sb", "g_st", "g_sh")] + \
        [("sm_scale", ctypes.c_double), ("inv_keep", ctypes.c_double)]


@functools.lru_cache(None)
def _library(dtype, which):
    """The kernel library of kernel ``which`` (0 K7, 1 K8a, 2 K8b) for
    storage type ``dtype``: the source compiled with ``-DBSA_DTYPE=<code>
    -DBSA_PART=<0 forward, 1 backward>``."""
    from deepspeed_tpu_torch.ops._build import load_library
    lib = load_library("block_sparse_attention",
                       (_DTYPE_CODES[dtype], int(which != 0)))
    lib.block_sparse_attention_launch.argtypes = [
        ctypes.c_int, ctypes.POINTER(_Params), ctypes.c_int,
        ctypes.c_void_p]
    lib.block_sparse_attention_launch.restype = ctypes.c_int
    lib.block_sparse_attention_error_string.argtypes = [ctypes.c_int]
    lib.block_sparse_attention_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(which, q, k, v, g, lse, delta, lut, nnz, block, kw, out=None,
            lse_out=None, dq=None, dk=None, dv=None):
    B, T, H, D = q.shape
    if block not in BLOCKS:
        raise ValueError(f"block_sparse_attention kernels take blocks "
                         f"{BLOCKS}, got {block}")
    cols = n_col(D)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"block_sparse_attention: dtype {q.dtype} not in "
                        f"{tuple(_DTYPE_CODES)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"block_sparse_attention: {name} head dim must "
                             f"be contiguous, strides {t.stride()}")
    if g is not None and (g.shape != q.shape or g.dtype != q.dtype):
        raise ValueError(f"block_sparse_attention: dO {tuple(g.shape)} "
                         f"{g.dtype} != q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32 or
                              tuple(t.shape) != (B * H, T) or
                              not t.is_contiguous()):
            raise ValueError(f"block_sparse_attention: {name} must be "
                             f"contiguous f32 [B*H, T], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("lut", lut), ("nnz", nnz)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"block_sparse_attention: {name} must be a "
                             f"contiguous int32 tensor, got {t.dtype}")
    rate = kw["dropout_rate"]
    gs = g.stride() if g is not None else (0,) * 4
    p = _Params(
        q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), g=_ptr(g),
        lse=_ptr(lse), delta=_ptr(delta), lut=lut.data_ptr(),
        nnz=nnz.data_ptr(), out=_ptr(out), lse_out=_ptr(lse_out),
        dq=_ptr(dq), dk=_ptr(dk), dv=_ptr(dv),
        B=B, T=T, H=H, D=D, block=block, max_nnz=lut.shape[-1],
        causal=int(kw["causal"]), dropping=int(rate > 0.0),
        seed=kw["dropout_seed"],
        keep_threshold=_keep_threshold(rate) if rate > 0.0 else 0,
        head_offset=kw.get("dropout_head_offset", 0),
        n_col=cols, q_exact=int(scaled_q_exact(q.dtype, kw["sm_scale"])),
        q_sb=q.stride(0), q_st=q.stride(1), q_sh=q.stride(2),
        k_sb=k.stride(0), k_st=k.stride(1), k_sh=k.stride(2),
        v_sb=v.stride(0), v_st=v.stride(1), v_sh=v.stride(2),
        g_sb=gs[0], g_st=gs[1], g_sh=gs[2],
        sm_scale=kw["sm_scale"],
        inv_keep=1.0 / (1.0 - rate) if rate > 0.0 else 1.0)
    lib = _library(q.dtype, which)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.block_sparse_attention_launch(which, ctypes.byref(p),
                                                _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        msg = lib.block_sparse_attention_error_string(err).decode()
        raise RuntimeError(f"block_sparse_attention kernel {which} launch "
                           f"failed: {msg}")


# ---------------------------------------------------------------------------
# public, differentiable entry
# ---------------------------------------------------------------------------

class _BlockSparseAttention(torch.autograd.Function):
    """K7 forward; K8a + K8b backward (``_make_sparse_fn``, :540-579)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, block, kw):
        lut, nnz, _, _ = tables
        out, lse = block_sparse_attention_fwd(q, k, v, lut, nnz, block, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tables, ctx.block, ctx.kw = tables, block, kw
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        lut, nnz, lut_t, nnz_t = ctx.tables
        B, T, H, _ = q.shape
        g = g.contiguous()
        # delta = rowsum(dO * O), in torch as the JAX code leaves it to
        # XLA (:356); [B, T, H] -> [B * H, T]
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(B * H, T).contiguous()
        dq = block_sparse_attention_bwd_dq(q, k, v, g, lse, delta, lut, nnz,
                                           ctx.block, **ctx.kw)
        dk, dv = block_sparse_attention_bwd_dkv(q, k, v, g, lse, delta,
                                                lut_t, nnz_t, ctx.block,
                                                **ctx.kw)
        return dq, dk, dv, None, None, None


def block_sparse_attention(q, k, v, layout, block, causal=False,
                           sm_scale=None, rpe=None, key_padding_mask=None,
                           attn_mask=None, key_padding_mask_mode="add",
                           attn_mask_mode="mul", implementation="auto",
                           dropout_rate=0.0, dropout_seed=None,
                           dropout_head_offset=0):
    """Fused block-sparse attention (``block_sparse_attention.py:582``).

    q, k, v: [B, T, H, D]; layout: [H, T // block, T // block] 0/1 (numpy,
    from ``SparsityConfig.make_layout``). rpe: [B, H, T, T];
    key_padding_mask: [B, T]; attn_mask: [T, T] (mask semantics per the
    reference softmax op, `softmax.py:219`). ``dropout_rate`` /
    ``dropout_seed`` (an int32 value): in-kernel attention-prob dropout
    with the flash kernels' counter-based mask, the same bits on every
    route at the same (head, q, k) coordinates. ``dropout_head_offset``
    is added to every row's head coordinate ``b * H + h``: a process
    that holds rows ``[r*B, (r+1)*B)`` of a global batch passes
    ``r * B * H`` and draws those rows' masks.

    ``implementation``: ``"auto"`` takes the kernel route (``"pallas"``,
    K7/K8 on CUDA tensors, their plain versions on CPU tensors) unless
    rpe or a mask is given, then the gather route ``"xla"``.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    T = q.shape[1]
    layout = np.asarray(layout).astype(np.int64)
    assert layout.shape[0] == q.shape[2], (
        f"layout heads {layout.shape[0]} != tensor heads {q.shape[2]}")
    assert layout.shape[1] * block == T, (
        f"layout covers {layout.shape[1] * block} positions, seq len is {T}")
    if dropout_rate:
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        dropout_seed = int(dropout_seed)

    has_extras = (rpe is not None or key_padding_mask is not None or
                  attn_mask is not None)
    if implementation == "auto":
        implementation = "xla" if has_extras else "pallas"
    tables = layout_tables(layout, q.device)
    if implementation == "pallas":
        assert not has_extras, (
            "rpe/masks route through implementation='xla'")
        kw = dict(causal=bool(causal), sm_scale=float(sm_scale),
                  dropout_rate=float(dropout_rate or 0.0),
                  dropout_seed=int(dropout_seed or 0),
                  dropout_head_offset=int(dropout_head_offset))
        return _BlockSparseAttention.apply(q, k, v, tables, block, kw)
    if implementation == "xla":
        lut, nnz = tables[:2]
        return _xla_impl(q, k, v, lut, nnz, block, causal, sm_scale,
                         rpe=rpe, key_padding_mask=key_padding_mask,
                         attn_mask=attn_mask,
                         key_padding_mask_mode=key_padding_mask_mode,
                         attn_mask_mode=attn_mask_mode,
                         dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed,
                         dropout_head_offset=dropout_head_offset)
    raise ValueError(f"unknown implementation {implementation!r}")


def masked_dense_attention(q, k, v, layout, block, causal=False,
                           sm_scale=None, rpe=None, key_padding_mask=None,
                           attn_mask=None, key_padding_mask_mode="add",
                           attn_mask_mode="mul", dropout_rate=0.0,
                           dropout_seed=None, dropout_head_offset=0):
    """Dense attention with the layout applied as an elementwise mask
    (``block_sparse_attention.py:640``): the parity oracle for the
    sparse kernels."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    B, T, H, D = q.shape
    dev = q.device
    allowed = torch.from_numpy(np.asarray(layout) != 0).to(dev) \
        .repeat_interleave(block, 1).repeat_interleave(block, 2)  # [H,T,T]
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * sm_scale
    if rpe is not None:
        scores = scores + rpe.float()
    if key_padding_mask is not None:
        scores = scores + _mask_to_additive(
            key_padding_mask, key_padding_mask_mode)[:, None, None, :]
    if attn_mask is not None:
        scores = scores + _mask_to_additive(attn_mask,
                                            attn_mask_mode)[None, None]
    mask = allowed[None]
    if causal:
        tri = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        mask = mask & tri[None, None]
    scores = torch.where(mask, scores, DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = probs * _dropout_multiplier_full(
            B, H, T, T, dropout_rate, dropout_seed,
            head_offset=dropout_head_offset, device=dev)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)
