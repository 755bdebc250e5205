"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX (the GPU machine need not have it) and
skip without a CUDA device; ``--noconftest`` keeps the JAX test
harness in ``tests/conftest.py`` out of the run:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

``chip_smoke.py`` runs the full-width matrix; these are the small,
fast cases (flash decode K5/K6, flash attention K1-K3 with the bf16
tensor-core K1/K2/K3, the FMA route for bf16 off TMA's rule, and the
wgmma tile check, fused Adam K4, block-sparse attention K7/K8 (K7 on
the TF32 tensor cores in f32, bf16 and fp16; fp16 K8); K1-K3 and K7/K8
at head dim 256; K1-K3, K5/K6 and K7/K8 at head dims 320 and 512, in
column chunks of 256). Tolerance atol 1e-5 on f32 outputs of magnitude
~1: both sides accumulate in fp32, in a different order; where a test
says so, chip_smoke.py's gate (``_close``: one unit of the output type
plus 1e-5 of the largest value).
"""

import importlib

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.cache import _quantize
from deepspeed_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_reference,
    flash_decode_reference,
)

B, S, H, D = 3, 32, 4, 64
POSITIONS = np.array([5, 0, S - 1], np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "int8", "f8e4m3fn", "f8e5m2"])
def test_flash_decode_kernel_matches_plain_version(cuda, codec):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((B, 1, H, D), (B, S, H, D),
                                            (B, S, H, D)))
    pos = torch.from_numpy(POSITIONS).to(cuda)
    if codec is None:
        args, scales = (k, v), ()
    else:
        (kq, ks), (vq, vs) = _quantize(k, codec), _quantize(v, codec)
        args, scales = (kq, vq), (ks, vs)
    before = flash_decode.launches
    got = flash_decode(q, *args, pos, *scales, block_k=8)
    assert flash_decode.launches == before + 1
    want = flash_decode_reference(q, *args, pos, *scales, block_k=8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# --- paged flash decode K6 ---------------------------------------------------
# Page size 8, 4 pages a row (S = 32), shuffled physical ids; positions on
# page edges. Same atol as K5.
PS, PPR, N_PAGES = 8, 4, 16
PAGED_POS = np.array([7, 8, S - 1], np.int32)


def _paged_inputs(cuda, codec):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((B, 1, H, D),
                                            (N_PAGES, PS, H, D),
                                            (N_PAGES, PS, H, D)))
    table = torch.from_numpy(rng.permutation(np.arange(1, N_PAGES))[
        :B * PPR].reshape(B, PPR).astype(np.int32)).to(cuda)
    if codec is None:
        return q, (k, v), (), table
    (kq, ks), (vq, vs) = _quantize(k, codec), _quantize(v, codec)
    return q, (kq, vq), (ks, vs), table


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "int8"])
def test_flash_decode_paged_kernel_matches_plain_version(cuda, codec):
    q, kv, scales, table = _paged_inputs(cuda, codec)
    pos = torch.from_numpy(PAGED_POS).to(cuda)
    before = (flash_decode.launches, flash_decode_paged.launches)
    got = flash_decode_paged(q, *kv, pos, table, *scales, block_k=8)
    assert (flash_decode.launches, flash_decode_paged.launches) == \
        (before[0], before[1] + 1)
    want = flash_decode_paged_reference(q, *kv, pos, table, *scales,
                                        block_k=8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "int8"])
def test_flash_decode_paged_kernel_ignores_poisoned_tail(cuda, codec):
    """Table entries past each row's occupancy hold out-of-range ids and
    the trash page holds huge values: the output does not move a bit."""
    q, (k, v), scales, table = _paged_inputs(cuda, codec)
    pos = torch.tensor([3, PS + 1, 2 * PS], dtype=torch.int32, device=cuda)
    clean = flash_decode_paged(q, k, v, pos, table, *scales, block_k=8)
    bad = table.clone()
    for b in range(B):
        bad[b, int(pos[b]) // PS + 1:] = 10 ** 9
    k2, v2 = k.clone(), v.clone()
    k2[0] = 100 if codec else 1e4
    v2[0] = -100 if codec else -1e4
    scales2 = tuple(x.clone() for x in scales)
    for x in scales2:
        x[0] = 1e4
    got = flash_decode_paged(q, k2, v2, pos, bad, *scales2, block_k=8)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)


@pytest.mark.cuda
def test_flash_decode_paged_kernel_equals_ring_kernel_in_order(cuda):
    """Over an in-order table onto the same bytes as the ring rows, K6
    and K5 share their walk: bitwise equal."""
    rng = np.random.default_rng(4)
    q, ring_k, ring_v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((B, 1, H, D), (B, S, H, D),
                                            (B, S, H, D)))
    pool_k = ring_k.reshape(B * PPR, PS, H, D)
    pool_v = ring_v.reshape(B * PPR, PS, H, D)
    table = torch.arange(B * PPR, dtype=torch.int32, device=cuda).reshape(
        B, PPR)
    pos = torch.from_numpy(PAGED_POS).to(cuda)
    assert torch.equal(flash_decode_paged(q, pool_k, pool_v, pos, table),
                       flash_decode(q, ring_k, ring_v, pos))


# --- the decode kernels' 128-key chunks --------------------------------------
# S 512 in 4 chunks, page size 16 (chunks and pages do not line up);
# positions on chunk edges, rows live in chunk 0 only, a negative one and
# one past S. f32 rows are read as 16-byte vectors (D 36: 9 of them,
# not a power of two); int8 rows at D 64 too, and at D 36 (36 bytes) one
# element a lane a load. Each call is one launch; the merge tickets are
# back at 0 after it.
EDGE_POS = np.array([127, 128, 255, 256, 511, 60, -1, 700], np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("d", [64, 36])
def test_split_decode_at_chunk_edges(cuda, d, codec):
    fd = importlib.import_module("deepspeed_tpu_torch.ops.flash_decode")
    rng = np.random.default_rng(9)
    b, s, h, ps = len(EDGE_POS), 512, 3, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((b, 1, h, d), (b, s, h, d),
                                            (b, s, h, d)))
    if codec is None:
        kv, scales = (k, v), ()
    else:
        (kq, ks), (vq, vs) = _quantize(k, codec), _quantize(v, codec)
        kv, scales = (kq, vq), (ks, vs)
    pos = torch.from_numpy(EDGE_POS).to(cuda)
    pool = (b * s // ps, ps, h, d)
    table = torch.arange(b * s // ps, dtype=torch.int32,
                         device=cuda).reshape(b, s // ps)
    before = (flash_decode.launches, flash_decode_paged.launches)
    ring = flash_decode(q, *kv, pos, *scales, block_k=ps)
    paged = flash_decode_paged(q, *(x.view(pool) for x in kv), pos, table,
                               *(x.view(pool[:3]) for x in scales),
                               block_k=ps)
    torch.cuda.synchronize()
    assert (flash_decode.launches, flash_decode_paged.launches) == \
        (before[0] + 1, before[1] + 1)
    assert all(int(t.abs().sum()) == 0 for t in fd._tickets.values())
    want = flash_decode_reference(q, *kv, pos, *scales, block_k=ps)
    torch.testing.assert_close(ring, want, atol=1e-5, rtol=0)
    assert torch.equal(paged, ring)
    assert torch.equal(ring[6], torch.zeros_like(ring[6]))


# --- training kernels: flash attention K1-K3, fused Adam K4 ----------------
# K1-K3 at f32: both sides sum in fp32 in different orders (atol 2e-5 on
# values of magnitude ~1); K4 runs the plain version's operations in the
# same order without fused multiply-adds, so it matches bit for bit.

@pytest.mark.cuda
@pytest.mark.parametrize("causal,bias,rate", [(True, False, 0.0),
                                              (True, True, 0.1),
                                              (False, True, 0.0),
                                              (False, False, 0.1)])
def test_flash_attention_kernels_match_plain_versions(cuda, causal, bias,
                                                      rate):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(1)
    b, t, h, d = 2, 100, 3, 32
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda) for _ in range(4))
    kb = torch.from_numpy(rng.standard_normal((b, t)).astype(
        np.float32)).to(cuda) if bias else None
    kw = dict(key_bias=kb, causal=causal, dropout_rate=rate,
              dropout_seed=-77, dropout_head_offset=2, dropout_num_heads=5)
    counts = (fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g * want_out).sum(-1).permute(0, 2, 1).reshape(b * h, t) \
        .contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, want_lse, delta, **kw)
    dkv = fa.flash_attention_bwd_dkv(q, k, v, g, want_lse, delta, **kw)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, want_lse,
                                                  delta, **kw)
    want_dkv = fa.flash_attention_bwd_dkv_reference(q, k, v, g, want_lse,
                                                    delta, **kw)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == tuple(
                c + 1 for c in counts)
    for got, want in [(out, want_out), (lse, want_lse), (dq, want_dq),
                      *zip(dkv, want_dkv)]:
        if want is None:
            assert got is None
            continue
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


# bf16 K1, K2 and K3 run on the tensor cores (TMA-fed wgmma, P and dS as a
# bf16 hi + lo pair): held to their plain versions at chip_smoke.py's gate
# (one unit in bf16's last place plus 1e-5 of the largest value).

def _bf16_attn_inputs(cuda, b, t, h, d, fused, seed):
    rng = np.random.default_rng(seed)
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3, h, d)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
            np.float32)).to(cuda, torch.bfloat16) for _ in range(3))
    g = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    kb = torch.from_numpy(rng.standard_normal((b, t)).astype(
        np.float32)).to(cuda)
    return q, k, v, g, kb


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,fused,causal", [(1000, 128, True, True),
                                              (1000, 64, False, False),
                                              (200, 40, True, True)])
def test_bf16_tensor_core_kernels_match_plain_versions(cuda, t, d, fused,
                                                       causal):
    import chip_smoke
    from deepspeed_tpu_torch.ops import flash_attention as fa
    q, k, v, g, kb = _bf16_attn_inputs(cuda, 2, t, 4, d, fused, 5)
    kw = dict(key_bias=kb, causal=causal, dropout_rate=0.1,
              dropout_seed=-77, dropout_head_offset=2, dropout_num_heads=5)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(2 * 4, t).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, want_lse, delta, **kw)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, want_lse,
                                                  delta, **kw)
    dk, dv, db = fa.flash_attention_bwd_dkv(q, k, v, g, want_lse, delta, **kw)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, g, want_lse, delta,
                                                **kw)
    rtol = chip_smoke.TRAIN_RTOL
    for got, ref, tol in [(out, want_out, rtol["bfloat16"]),
                          (lse, want_lse, rtol["float32"]),
                          (dq, want_dq, rtol["bfloat16"]),
                          (dk, want[0], rtol["bfloat16"]),
                          (dv, want[1], rtol["bfloat16"]),
                          (db, want[2], rtol["float32"])]:
        err, ok = chip_smoke._close(torch, got, ref, tol)
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("causal,bias,rate", [(True, True, 0.1),
                                              (False, False, 0.0)])
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_dq_runs_on_the_tensor_cores(cuda, d, causal, bias, rate):
    """K2 on bf16 inputs that meet TMA's rule: ``dq_wgmma_kernel`` (one
    tensor-core launch), held to its plain version at chip_smoke.py's
    gate, T 1000 (not a multiple of the 128-row CTA or 64-key tile)."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import flash_attention as fa
    t = 1000
    q, k, v, g, kb = _bf16_attn_inputs(cuda, 2, t, 4, d, True, 7)
    kw = dict(key_bias=kb if bias else None, causal=causal,
              dropout_rate=rate, dropout_seed=-77, dropout_head_offset=2,
              dropout_num_heads=5)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(2 * 4, t).contiguous()
    before = dict(fa.flash_attention_bwd_dq.routes)
    dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw)
    want = fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta, **kw)
    assert fa.flash_attention_bwd_dq.routes == dict(
        before, tensor_core=before["tensor_core"] + 1)
    err, ok = chip_smoke._close(torch, dq, want,
                                chip_smoke.TRAIN_RTOL["bfloat16"])
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_kernels_at_head_dim_256(cuda, dtype):
    """K1-K3 at D 256 (K2 and K3 on 32-row tiles) against their plain
    versions at chip_smoke.py's gate; every dtype, bf16 included, takes
    the FMA route past D 128."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import flash_attention as fa
    b, t, h, d = 2, 200, 2, 256
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda, getattr(torch, dtype)) for _ in range(4))
    kb = torch.from_numpy(rng.standard_normal((b, t)).astype(
        np.float32)).to(cuda)
    kw = dict(key_bias=kb, causal=True, dropout_rate=0.1, dropout_seed=-77,
              dropout_head_offset=2, dropout_num_heads=5)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [dict(w.routes) for w in wrappers]
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, want_lse, delta, **kw)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, want_lse,
                                                  delta, **kw)
    dk, dv, db = fa.flash_attention_bwd_dkv(q, k, v, g, want_lse, delta, **kw)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, g, want_lse, delta,
                                                **kw)
    for w, was in zip(wrappers, before):
        assert w.routes == dict(was, fma=was["fma"] + 1)
    rtol = chip_smoke.TRAIN_RTOL
    for got, ref, tol in [(out, want_out, rtol[dtype]),
                          (lse, want_lse, rtol["float32"]),
                          (dq, want_dq, rtol[dtype]),
                          (dk, want[0], rtol[dtype]),
                          (dv, want[1], rtol[dtype]),
                          (db, want[2], rtol["float32"])]:
        err, ok = chip_smoke._close(torch, got, ref, tol)
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["misaligned", "d36"])
def test_bf16_view_off_the_tma_alignment_raises(cuda, layout):
    """bf16 inputs off TMA's rule no longer raise: a view one element
    into its storage (2 bytes off the boundary) and a head dim of 36
    (72-byte rows) run K1, K2 and K3 on the hand-written FMA kernels, one
    FMA-route launch each, and match the plain versions at chip_smoke.py's
    bf16 gate."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import flash_attention as fa
    d = 64 if layout == "misaligned" else 36
    q, k, v, g, kb = _bf16_attn_inputs(cuda, 2, 200, 4, d, False, 8)
    if layout == "misaligned":
        q, k, v, g = (chip_smoke._off_by_one(torch, x) for x in (q, k, v, g))
    kw = dict(key_bias=kb, causal=True, dropout_rate=0.1, dropout_seed=-77,
              dropout_head_offset=2, dropout_num_heads=5)
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    before = [dict(w.routes) for w in wrappers]
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(2 * 4, 200).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, want_lse, delta, **kw)
    dk, dv, db = fa.flash_attention_bwd_dkv(q, k, v, g, want_lse, delta,
                                            **kw)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, want_lse,
                                                  delta, **kw)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, g, want_lse, delta,
                                                **kw)
    for w, b in zip(wrappers, before):
        assert w.routes == dict(b, fma=b["fma"] + 1)
    rtol = chip_smoke.TRAIN_RTOL
    for got, ref, tol in [(out, want_out, rtol["bfloat16"]),
                          (lse, want_lse, rtol["float32"]),
                          (dq, want_dq, rtol["bfloat16"]),
                          (dk, want[0], rtol["bfloat16"]),
                          (dv, want[1], rtol["bfloat16"]),
                          (db, want[2], rtol["float32"])]:
        err, ok = chip_smoke._close(torch, got, ref, tol)
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("mn_major", [False, True])
@pytest.mark.parametrize("n,kd", [(64, 64), (64, 128), (128, 64),
                                  (128, 128)])
def test_wgmma_tile_product_matches_matmul(cuda, mn_major, n, kd):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((64, kd)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(
        (kd, n) if mn_major else (n, kd)).astype(np.float32)).to(
            cuda, torch.bfloat16)
    got = fa.wgmma_tile_product(a, b, mn_major)
    bf = (b if mn_major else b.T).float().cpu()
    want = a.float().cpu() @ bf
    # exact bf16 products; two orders of kd fp32 additions, each within
    # kd 2^-24 sum |a b| of the exact sum
    bound = 2 * kd * 2.0 ** -24 * (a.float().cpu().abs() @ bf.abs())
    assert ((got.cpu() - want).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_kernel_matches_plain_version(cuda, adam_w_mode):
    from deepspeed_tpu_torch.ops.fused_adam import (
        adam_hyperparams, fused_adam, fused_adam_reference)
    rng = np.random.default_rng(2)
    sizes = (1, 7, 4100, 70001)
    leaves = [[torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(cuda) for _ in range(4)] for n in sizes]
    for group in leaves:
        group[3].abs_()
    plain = [[x.clone() for x in group] for group in leaves]
    before = fused_adam.launches
    for step in (1, 2, 3):
        hyper = adam_hyperparams(1e-2, 0.9, 0.999, 1e-8, 0.01,
                                 1 - 0.9 ** step, 1 - 0.999 ** step, 0.0,
                                 cuda)
        fused_adam(*(list(c) for c in zip(*leaves)), hyper,
                   adam_w_mode=adam_w_mode)
        fused_adam_reference(*(list(c) for c in zip(*plain)), hyper,
                             adam_w_mode=adam_w_mode)
    assert fused_adam.launches == before + 3
    for a, b in zip(sum(leaves, []), sum(plain, [])):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gpt2_train_step_goes_through_the_kernels(cuda):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16,
                                 use_flash_attention=True),
                       device=cuda, generator=gen)
    engine, _, _, _ = initialize(model=model, config={
        "train_batch_size": 4, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                 "pallas": True}}})
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (4, 64)).astype(np.int32)}
    counts = [fa.flash_attention_fwd.launches, fused_adam.launches]
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert fa.flash_attention_fwd.launches == counts[0] + 3 * 2
    assert fused_adam.launches == counts[1] + 3


# --- block-sparse attention K7, K8a, K8b -----------------------------------
# f32 against the plain versions (atol 2e-5, as K1-K3: fp32 sums in a
# different order); head 1 has an empty q-block row (out 0, lse -inf,
# dq 0) and no q-block of head 0 visits the last k-block (dk = dv = 0).
# The module by path: the package re-exports its entry function under
# the module's name.
BSA = "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention"

def _sparse_layout(block, t, h, causal):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    layout = FixedSparsityConfig(
        h, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    layout[1, 1, :] = 0
    layout[0, :, -1] = 0
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("block,causal,rate", [(16, False, 0.0),
                                               (32, True, 0.1),
                                               (64, False, 0.1),
                                               (128, True, 0.0)])
def test_block_sparse_kernels_match_plain_versions(cuda, block, causal,
                                                   rate):
    bsa = importlib.import_module(BSA)
    rng = np.random.default_rng(5)
    b, h, d = 2, 3, 64
    t = 4 * block
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda) for _ in range(4))
    lut, nnz, lut_t, nnz_t = bsa.layout_tables(
        _sparse_layout(block, t, h, causal), cuda)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=-99)
    counters = (bsa.block_sparse_attention_fwd,
                bsa.block_sparse_attention_bwd_dq,
                bsa.block_sparse_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, nnz, block, **kw)
    want_out, want_lse = bsa.block_sparse_attention_fwd_reference(
        q, k, v, lut, nnz, block, **kw)
    delta = (g * want_out).sum(-1).permute(0, 2, 1).reshape(b * h, t) \
        .contiguous()
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, g, want_lse, delta, lut,
                                           nnz, block, **kw)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, g, want_lse, delta,
                                                lut_t, nnz_t, block, **kw)
    want_dq = bsa.block_sparse_attention_bwd_dq_reference(
        q, k, v, g, want_lse, delta, lut, nnz, block, **kw)
    want_dk, want_dv = bsa.block_sparse_attention_bwd_dkv_reference(
        q, k, v, g, want_lse, delta, lut_t, nnz_t, block, **kw)
    assert [c.launches for c in counters] == [n + 1 for n in before]
    empty = torch.isinf(want_lse)
    assert bool(empty.any()) and torch.equal(torch.isinf(lse), empty)
    assert torch.equal(out[1, block:2 * block, 1],
                       torch.zeros_like(out[1, block:2 * block, 1]))
    assert torch.equal(dk[:, -block:, 0], torch.zeros_like(dk[:, -block:, 0]))
    for got, want in [(out, want_out), (lse.masked_fill(empty, 0.0),
                                        want_lse.masked_fill(empty, 0.0)),
                      (dq, want_dq), (dk, want_dk), (dv, want_dv)]:
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_kernels_at_a_head_offset_match_plain_versions(cuda,
                                                                   dtype):
    """A data-parallel rank's rows: K7/K8a/K8b with dropout at a nonzero
    ``dropout_head_offset`` against their plain versions."""
    bsa = importlib.import_module(BSA)
    rng = np.random.default_rng(11)
    block, b, h, d = 64, 2, 3, 64
    t = 4 * block
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(4))
    lut, nnz, lut_t, nnz_t = bsa.layout_tables(
        _sparse_layout(block, t, h, False), cuda)
    kw = dict(dropout_rate=0.1, dropout_seed=-99,
              dropout_head_offset=5 * b * h)
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, nnz, block, **kw)
    want_out, want_lse = bsa.block_sparse_attention_fwd_reference(
        q, k, v, lut, nnz, block, **kw)
    delta = (g.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, g, want_lse, delta, lut,
                                           nnz, block, **kw)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, g, want_lse, delta,
                                                lut_t, nnz_t, block, **kw)
    want = [bsa.block_sparse_attention_bwd_dq_reference(
        q, k, v, g, want_lse, delta, lut, nnz, block, **kw),
        *bsa.block_sparse_attention_bwd_dkv_reference(
            q, k, v, g, want_lse, delta, lut_t, nnz_t, block, **kw)]
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for got, ref in zip((out, dq, dk, dv), (want_out, *want)):
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=tol)


def _sparse_results(cuda, block, causal, rate, dtype, d, seed, b=2, h=3):
    """K7, K8a and K8b against their plain versions on one input set:
    ``{name: (got, want, rtol)}`` at chip_smoke.py's gate, and the
    launch counts each wrapper moved by."""
    import chip_smoke
    bsa = importlib.import_module(BSA)
    rng = np.random.default_rng(seed)
    t = 4 * block
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda, getattr(torch, dtype)) for _ in range(4))
    lut, nnz, lut_t, nnz_t = bsa.layout_tables(
        _sparse_layout(block, t, h, causal), cuda)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=-99)
    counters = (bsa.block_sparse_attention_fwd,
                bsa.block_sparse_attention_bwd_dq,
                bsa.block_sparse_attention_bwd_dkv)
    before = [c.launches for c in counters]
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, lut, nnz, block, **kw)
    want_out, want_lse = bsa.block_sparse_attention_fwd_reference(
        q, k, v, lut, nnz, block, **kw)
    delta = (g.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, g, want_lse, delta, lut,
                                           nnz, block, **kw)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(q, k, v, g, want_lse, delta,
                                                lut_t, nnz_t, block, **kw)
    want_dq = bsa.block_sparse_attention_bwd_dq_reference(
        q, k, v, g, want_lse, delta, lut, nnz, block, **kw)
    want_dk, want_dv = bsa.block_sparse_attention_bwd_dkv_reference(
        q, k, v, g, want_lse, delta, lut_t, nnz_t, block, **kw)
    empty = torch.isinf(want_lse)
    assert bool(empty.any()) and torch.equal(torch.isinf(lse), empty)
    rtol = chip_smoke.TRAIN_RTOL
    results = {"out": (out, want_out, rtol[dtype]),
               "lse": (lse.masked_fill(empty, 0.0),
                       want_lse.masked_fill(empty, 0.0), rtol["float32"]),
               "dq": (dq, want_dq, rtol[dtype]),
               "dk": (dk, want_dk, rtol[dtype]),
               "dv": (dv, want_dv, rtol[dtype])}
    return results, [c.launches - n for c, n in zip(counters, before)]


def _assert_close(results, names):
    import chip_smoke
    for name in names:
        got, want, tol = results[name]
        err, ok = chip_smoke._close(torch, got, want, tol)
        assert ok, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("block,causal,rate,dtype", [
    (16, False, 0.1, "float32"), (64, True, 0.0, "float32"),
    (32, True, 0.1, "bfloat16"), (128, False, 0.0, "bfloat16")])
def test_block_sparse_kernels_at_head_dim_256(cuda, block, causal, rate,
                                              dtype):
    """K7, K8a and K8b at D 256 against their plain versions at
    chip_smoke.py's gate (K8 on 32-row tiles with the head split over
    warps)."""
    results, _ = _sparse_results(cuda, block, causal, rate, dtype, 256,
                                 seed=6)
    _assert_close(results, ("out", "lse", "dq", "dk", "dv"))


@pytest.mark.cuda
def test_bert_sparse_train_step_goes_through_the_kernels(cuda):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.bert import BertForMaskedLM, bert_tiny
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    bsa = importlib.import_module(BSA)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    model = BertForMaskedLM(bert_tiny(
        dtype=torch.bfloat16, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1,
        sparse_attention=FixedSparsityConfig(4, block=16,
                                             num_local_blocks=2)),
        device=cuda, generator=gen)
    engine, _, _, _ = initialize(model=model, config={
        "train_batch_size": 4, "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    rng = np.random.default_rng(0)
    labels = np.full((4, 64), -100, np.int64)
    labels[:, ::7] = rng.integers(0, 256, labels[:, ::7].shape)
    batch = {"input_ids": rng.integers(0, 256, (4, 64)).astype(np.int32),
             "labels": labels}
    counts = [bsa.block_sparse_attention_fwd.launches,
              bsa.block_sparse_attention_bwd_dkv.launches, bsa._xla_impl.calls]
    losses = [float(engine.train_batch(batch)) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert [bsa.block_sparse_attention_fwd.launches,
            bsa.block_sparse_attention_bwd_dkv.launches,
            bsa._xla_impl.calls] == [counts[0] + 6, counts[1] + 6, counts[2]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d,block,causal", [(64, 64, False), (64, 16, True),
                                            (128, 32, True),
                                            (256, 16, False)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k7_tensor_core_kernel_matches_plain_version(cuda, dtype, d, block,
                                                     causal, rate):
    """K7 (``fwd_mma_kernel``: mma.sync TF32, the online softmax in the
    fragment) against its plain version, out and lse, with an empty
    q-block row; bf16 and fp16 at D 64 / 256 drop the lo term of the
    scaled q (sm_scale a power of two), at D 128 keep it."""
    results, launches = _sparse_results(cuda, block, causal, rate, dtype,
                                        d, seed=d + block)
    assert launches == [1, 1, 1]
    _assert_close(results, ("out", "lse"))


@pytest.mark.cuda
@pytest.mark.parametrize("block,causal,rate", [(16, True, 0.1),
                                               (64, False, 0.0),
                                               (128, True, 0.1)])
def test_fp16_block_sparse_backward_matches_plain_versions(cuda, block,
                                                           causal, rate):
    """fp16 K8a and K8b (the 2-byte path: exact in TF32) at D 64."""
    results, _ = _sparse_results(cuda, block, causal, rate, "float16", 64,
                                 seed=block)
    _assert_close(results, ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d,block", [(320, 16), (512, 32)])
def test_block_sparse_kernels_past_head_dim_256(cuda, dtype, d, block):
    """K7, K8a and K8b at head dims split into column chunks of 256."""
    results, _ = _sparse_results(cuda, block, True, 0.1, dtype, d, seed=d)
    _assert_close(results, ("out", "lse", "dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_attention_kernels_past_head_dim_256(cuda, dtype, d):
    """K1-K3 on the FMA route at head dims split into column chunks of
    256, causal with a key bias and dropout (dbias from chunk 0)."""
    import chip_smoke
    from deepspeed_tpu_torch.ops import flash_attention as fa
    b, t, h = 2, 150, 2
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(cuda, getattr(torch, dtype)) for _ in range(4))
    kb = torch.from_numpy(rng.standard_normal((b, t)).astype(
        np.float32)).to(cuda)
    kw = dict(key_bias=kb, causal=True, dropout_rate=0.1, dropout_seed=-77,
              dropout_head_offset=2, dropout_num_heads=5)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * want_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * h, t).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, g, want_lse, delta, **kw)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, g, want_lse,
                                                  delta, **kw)
    dk, dv, db = fa.flash_attention_bwd_dkv(q, k, v, g, want_lse, delta, **kw)
    want = fa.flash_attention_bwd_dkv_reference(q, k, v, g, want_lse, delta,
                                                **kw)
    rtol = chip_smoke.TRAIN_RTOL
    for got, ref, tol in [(out, want_out, rtol[dtype]),
                          (lse, want_lse, rtol["float32"]),
                          (dq, want_dq, rtol[dtype]),
                          (dk, want[0], rtol[dtype]),
                          (dv, want[1], rtol[dtype]),
                          (db, want[2], rtol["float32"])]:
        err, ok = chip_smoke._close(torch, got, ref, tol)
        assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_decode_kernels_past_head_dim_256(cuda, codec, d):
    """K5 and K6 (an in-order table over the same bytes) at head dims
    split into column chunks of 256, positions across 128-key chunks."""
    rng = np.random.default_rng(d)
    s = 384
    q = torch.from_numpy(rng.standard_normal((B, 1, H, d)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((B, s, H, d)).astype(
        np.float32)).to(cuda) for _ in range(2))
    pos = torch.tensor([5, 200, s - 1], dtype=torch.int32, device=cuda)
    if codec is None:
        (k, v), scales = (k.bfloat16(), v.bfloat16()), ()
    else:
        (k, ks), (v, vs) = _quantize(k, codec), _quantize(v, codec)
        scales = (ks, vs)
    got = flash_decode(q, k, v, pos, *scales, block_k=128)
    want = flash_decode_reference(q, k, v, pos, *scales, block_k=128)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-5,
                               rtol=2.0 ** -7)
    per_row = s // 128
    table = torch.arange(B * per_row, dtype=torch.int32,
                         device=cuda).reshape(B, per_row)
    pool = [x.reshape((B * per_row, 128) + x.shape[2:])
            for x in (k, v) + scales]
    paged = flash_decode_paged(q, pool[0], pool[1], pos, table, *pool[2:],
                               block_k=128)
    assert torch.equal(paged, got)
