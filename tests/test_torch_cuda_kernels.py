"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX (the GPU machine need not have it) and
skip without a CUDA device; ``--noconftest`` keeps the JAX test
harness in ``tests/conftest.py`` out of the run:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

``chip_smoke.py`` runs the full-width matrix; these are the small,
fast cases. Tolerance atol 1e-5 on f32 outputs of magnitude ~1: both
sides accumulate in fp32, in a different order.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.cache import _quantize
from deepspeed_tpu_torch.ops.flash_decode import (
    flash_decode,
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
