"""The arithmetic of the tensor-core flash-attention kernels (bf16 K1, K2
and K3 in ``deepspeed_tpu_torch/ops/csrc/flash_attention.cu``), emulated
on the CPU, against the reference.

Those kernels multiply bf16 operands on the tensor cores with fp32
accumulation. Q.K^T and dO.V^T of bf16 inputs are exact products summed
in fp32, as the reference's f32 dots. P.V (K1), dS.K (K2), P^T.dO and
dS^T.Q (K3) have an fp32 left operand; the kernels feed it as two bf16
operands, hi = bf16(x) and lo = bf16(x - hi), into one fp32
accumulator. These tests pin why: with the split, every element of out,
dQ, dK and dV stays inside the gate ``chip_smoke.py`` holds the kernels
to (``_close`` with ``TRAIN_RTOL["bfloat16"]`` and ``TRAIN_ATOL_REL``),
against the port's plain versions and against the JAX Pallas kernels
(interpret mode); with one bf16 rounding of P and dS (what
FlashAttention-2/3 do) more than 1% of the elements break it.

They also pin the wrapper's TMA legality rule (:func:`tma_violation`)
as a function of shape, strides, item size and address, and the route
rule built on it (:func:`attention_route`). Inputs come from
``numpy.random.default_rng``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.ops import flash_attention as tfa
from tests.torch_threads import one_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")

B, T, H, D = 2, 128, 4, 64
SEED, OFFSET, NUM_HEADS = -123456789, 3, 24
KEYS = 128          # keys of a K / V tile of the tensor-core K1
RTOL = chip_smoke.TRAIN_RTOL["bfloat16"]
# single rounding breaks the gate on 5-12% of the elements at this shape
SINGLE_MIN_BROKEN = 0.01


def _split(x, two_terms):
    """x as the bf16 operands the kernel feeds: [hi] or [hi, lo]."""
    hi = x.to(torch.bfloat16).float()
    if not two_terms:
        return [hi]
    return [hi, (x - hi).to(torch.bfloat16).float()]


def _emulated_fwd(q, k, v, kb, causal, rate, two_terms):
    """K1 on bf16 inputs: S from exact products in fp32, sm_scale, masks,
    bias, an online softmax over 128-key tiles in fp32, O += P.V with P
    split (or rounded once), out rounded to bf16."""
    b, t, h, d = q.shape
    s_len = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * d ** -0.5
    if causal:
        keep = torch.ones(t, s_len, dtype=torch.bool).tril()
        s = torch.where(keep, s, tfa.DEFAULT_MASK_VALUE)
    if kb is not None:
        s = s + kb[:, None, None, :]
    mult = None
    if rate:
        mult = tfa._dropout_multiplier_full(b, h, t, s_len, rate, SEED,
                                            OFFSET, NUM_HEADS)
    m = torch.full((b, h, t), float("-inf"))
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, d)
    for k0 in range(0, s_len, KEYS):
        tile = s[..., k0:k0 + KEYS]
        m_new = torch.maximum(m, tile.amax(-1))
        p = torch.exp(tile - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        m = m_new
        if mult is not None:
            p = p * mult[..., k0:k0 + KEYS]
        acc = acc * corr[..., None]
        for part in _split(p, two_terms):
            acc = acc + torch.einsum("bhts,bshd->bhtd", part,
                                     v[:, k0:k0 + KEYS].float())
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _emulated_dkv(q, k, v, g, lse, delta, kb, causal, rate, two_terms):
    """K3 on bf16 inputs: P and dS0 in fp32 from exact products, then
    dV += (P mult)^T.dO and dK += (dS0 sm_scale)^T.Q with the fp32
    operand split (or rounded once)."""
    sm_scale = q.shape[-1] ** -0.5
    p, mult, dp, dl = tfa._bwd_probs(q, k, v, g, lse, delta, kb, causal,
                                     sm_scale, rate, SEED, OFFSET, NUM_HEADS)
    pd = p if mult is None else p * mult
    ds = p * (dp - dl) * sm_scale
    dv = sum(torch.einsum("bhts,bthd->bshd", x, g.float())
             for x in _split(pd, two_terms))
    dk = sum(torch.einsum("bhts,bthd->bshd", x, q.float())
             for x in _split(ds, two_terms))
    return dk.to(k.dtype), dv.to(v.dtype)


DQ_KEYS = 64        # keys of a K / V tile of the tensor-core K2


def _emulated_dq(q, k, v, g, lse, delta, kb, causal, rate, two_terms):
    """K2 on bf16 inputs: S and dP from exact products in fp32, P and dS
    in fp32, then dQ += dS.K over 64-key tiles into one fp32 accumulator,
    with dS split (or rounded once); dq rounded to bf16."""
    sm_scale = q.shape[-1] ** -0.5
    p, _, dp, dl = tfa._bwd_probs(q, k, v, g, lse, delta, kb, causal,
                                  sm_scale, rate, SEED, OFFSET, NUM_HEADS)
    ds = p * (dp - dl) * sm_scale
    dq = torch.zeros(q.shape, dtype=torch.float32)
    for k0 in range(0, k.shape[1], DQ_KEYS):
        kt = k[:, k0:k0 + DQ_KEYS].float()
        for part in _split(ds[..., k0:k0 + DQ_KEYS], two_terms):
            dq = dq + torch.einsum("bhts,bshd->bthd", part, kt)
    return dq.to(q.dtype)


def _inputs(seed, bias):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    kb = None
    if bias:
        kb = rng.standard_normal((B, T)).astype(np.float32)
        kb[:, 3::7] = tfa.MASK_BIAS
    return q, k, v, g, kb


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _broken_share(got, want):
    """The share of elements outside ``chip_smoke._close``'s gate; the
    gate itself is asserted through ``_close``."""
    got, want = got.float(), want.float()
    allowed = chip_smoke.TRAIN_ATOL_REL * float(want.abs().max()) + \
        RTOL * want.abs()
    return float(((got - want).abs() > allowed).float().mean())


def _both_roundings(q, k, v, g, kb, causal, rate, lse, delta):
    out = {}
    for two in (True, False):
        o = _emulated_fwd(q, k, v, kb, causal, rate, two)
        dk, dv = _emulated_dkv(q, k, v, g, lse, delta, kb, causal, rate, two)
        out[two] = {"out": o, "dk": dk, "dv": dv}
    return out


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_split_keeps_the_plain_versions_gate_and_single_rounding_breaks_it(
        causal, bias, rate):
    q, k, v, g, kb = (None if x is None else torch.from_numpy(x)
                      for x in _inputs(0, bias))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    kw = dict(key_bias=kb, causal=causal, dropout_rate=rate,
              dropout_seed=SEED, dropout_head_offset=OFFSET,
              dropout_num_heads=NUM_HEADS)
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * ref_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, T).contiguous()
    ref_dk, ref_dv, _ = tfa.flash_attention_bwd_dkv_reference(
        q, k, v, g, ref_lse, delta, **kw)
    want = {"out": ref_out, "dk": ref_dk, "dv": ref_dv}
    got = _both_roundings(q, k, v, g, kb, causal, rate, ref_lse, delta)
    for name, ref in want.items():
        err, ok = chip_smoke._close(torch, got[True][name], ref, RTOL)
        assert ok, f"split {name}: max abs err {err}"
        assert not chip_smoke._close(torch, got[False][name], ref, RTOL)[1]
        assert _broken_share(got[False][name], ref) > SINGLE_MIN_BROKEN


def _jax_out_and_grads(q, k, v, g, kb, causal, rate):
    """The JAX Pallas kernels (interpret mode, 64-row blocks) on bf16
    inputs: out, dk, dv as f32 numpy."""
    kw = dict(causal=causal, block_q=64, block_k=64,
              implementation="pallas")
    if rate:
        kw.update(dropout_rate=rate, dropout_seed=SEED,
                  dropout_head_offset=OFFSET, dropout_num_heads=NUM_HEADS)
    bias = None if kb is None else jnp.asarray(kb)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, key_bias=bias, **kw)

    args = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    dq, dk, dv = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    return {name: np.array(x.astype(jnp.float32)) for name, x in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.mark.parametrize("causal,bias,rate", [(True, True, 0.1),
                                              (False, False, 0.0)])
def test_split_keeps_the_jax_kernels_gate(causal, bias, rate):
    """The same gate against the JAX kernels themselves on bf16 inputs;
    lse and delta from the port's plain forward, as the kernels get
    them."""
    qn, kn, vn, gn, kbn = _inputs(1, bias)
    q, k, v, g = (_bf16(x) for x in (qn, kn, vn, gn))
    kb = None if kbn is None else torch.from_numpy(kbn)
    kw = dict(key_bias=kb, causal=causal, dropout_rate=rate,
              dropout_seed=SEED, dropout_head_offset=OFFSET,
              dropout_num_heads=NUM_HEADS)
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * ref_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, T).contiguous()
    got = _both_roundings(q, k, v, g, kb, causal, rate, ref_lse, delta)
    jax_out = _jax_out_and_grads(qn, kn, vn, gn, kbn, causal, rate)
    for name in ("out", "dk", "dv"):
        want = torch.from_numpy(jax_out[name])
        err, ok = chip_smoke._close(torch, got[True][name], want, RTOL)
        assert ok, f"split {name} vs JAX: max abs err {err}"
        assert _broken_share(got[False][name], want) > SINGLE_MIN_BROKEN


# --- K2 on the tensor cores ------------------------------------------------
# dQ = sum over keys of dS K: with dS as hi + lo every element stays in
# the gate; one bf16 rounding of dS (2^-9 of each term) breaks it where
# the sum cancels (on 10-12% of the elements at this shape).

def _dq_case(seed, causal, bias, rate):
    qn, kn, vn, gn, kbn = _inputs(seed, bias)
    q, k, v, g = (_bf16(x) for x in (qn, kn, vn, gn))
    kb = None if kbn is None else torch.from_numpy(kbn)
    kw = dict(key_bias=kb, causal=causal, dropout_rate=rate,
              dropout_seed=SEED, dropout_head_offset=OFFSET,
              dropout_num_heads=NUM_HEADS)
    ref_out, ref_lse = tfa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (g.float() * ref_out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, T).contiguous()
    got = {two: _emulated_dq(q, k, v, g, ref_lse, delta, kb, causal, rate,
                             two) for two in (True, False)}
    return (qn, kn, vn, gn, kbn), got, tfa.flash_attention_bwd_dq_reference(
        q, k, v, g, ref_lse, delta, **kw)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_split_keeps_the_plain_versions_gate_and_single_rounding_breaks_it(
        causal, bias, rate):
    _, got, ref = _dq_case(0, causal, bias, rate)
    err, ok = chip_smoke._close(torch, got[True], ref, RTOL)
    assert ok, f"split dq: max abs err {err}"
    assert not chip_smoke._close(torch, got[False], ref, RTOL)[1]
    assert _broken_share(got[False], ref) > SINGLE_MIN_BROKEN


@pytest.mark.parametrize("causal,bias,rate", [(True, True, 0.1),
                                              (False, False, 0.0)])
def test_dq_split_keeps_the_jax_kernels_gate(causal, bias, rate):
    """The same gate against the JAX Pallas dQ (interpret mode) on bf16
    inputs; lse and delta from the port's plain forward."""
    inputs, got, _ = _dq_case(1, causal, bias, rate)
    want = torch.from_numpy(_jax_out_and_grads(*inputs, causal, rate)["dq"])
    err, ok = chip_smoke._close(torch, got[True], want, RTOL)
    assert ok, f"split dq vs JAX: max abs err {err}"
    assert _broken_share(got[False], want) > SINGLE_MIN_BROKEN


# --- the TMA legality rule -------------------------------------------------

FUSED = (2, 128, 16, 64), (128 * 3 * 16 * 64, 3 * 16 * 64, 64, 1)


@pytest.mark.parametrize("shape,strides,itemsize,address,why", [
    (*FUSED, 2, 4096, None),                              # c_attn view
    (*FUSED, 2, 4096 + 2 * 16 * 64, None),                # its k slice
    ((2, 128, 16, 64), (128 * 16 * 64, 16 * 64, 64, 1), 2, 256, None),
    ((2, 100, 3, 100), (30000, 300, 100, 1), 2, 256, "dim 1's stride"),
    ((2, 100, 1, 100), (10000, 104, 100, 1), 2, 256, None),   # H 1
    ((1, 1000, 2, 40), (7, 80, 40, 1), 2, 512, None),         # B 1
    ((2, 100, 4, 36), (14400, 144, 36, 1), 2, 512, "dim 2's stride"),
    ((2, 128, 16, 64), (128 * 16 * 64, 16 * 64, 64, 1), 2, 258,
     "2 bytes off"),
    ((2, 128, 16, 64), (128 * 16 * 64, 1, 128 * 64, 128), 2, 256,
     "not contiguous"),
    ((256,), (1,), 4, 1024 + 4 * 2, "8 bytes off"),            # flat lse
    ((256,), (1,), 4, 1024 + 4 * 4, None),
])
def test_tma_violation_is_a_function_of_the_layout(shape, strides, itemsize,
                                                   address, why):
    got = tfa.tma_violation(shape, strides, itemsize, address)
    if why is None:
        assert got is None
    else:
        assert got is not None and why in got


def test_wrapper_rule_rejects_a_misaligned_bf16_view():
    """The route rule (:func:`attention_route`, decided once per call):
    TMA's rule rejects a bf16 view one element into its storage (2 bytes
    off the boundary) and a head dim of 36 (72-byte rows) from the tensor
    cores, so any of K1's (q, k, v) or K2/K3's (q, k, v, dO, lse, delta)
    that breaks it sends the call to the FMA kernels; aligned bf16 sets
    take the tensor cores, and f32 always takes the FMA kernels."""
    shape = (2, 64, 4, 64)
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=torch.bfloat16)
    view = base[1:1 + n].view(shape)
    assert tfa.tma_violation(tuple(view.shape), view.stride(), 2,
                             view.data_ptr()) is not None
    good = {name: base[8:8 + n].view(shape) for name in "qkvg"}
    stats = torch.zeros(2 * 4 * 64 + 1)
    good.update(lse=stats[:-1].view(8, 64), delta=stats[:-1].view(8, 64))
    fwd, bwd = ("q", "k", "v"), ("q", "k", "v", "g", "lse", "delta")

    def route(names, **swap):
        t = dict(good, **swap)
        return tfa.attention_route(*(t[name] for name in names))

    for names in (fwd, bwd):
        assert route(names) == "tensor_core"
        assert route(names, **{n_: t.float() for n_, t in good.items()
                               if n_ in "qkvg"}) == "fma"
        for name in names:
            bad = view if name in "qkvg" else stats[1:].view(8, 64)
            assert route(names, **{name: bad}) == "fma", name
    d36 = {name: torch.zeros((2, 64, 4, 36), dtype=torch.bfloat16)
           for name in "qkvg"}
    assert route(fwd, **d36) == route(bwd, **d36) == "fma"
    # the route a CPU call would take is recorded nowhere: CPU tensors
    # run the plain versions, which count no launch
    before = dict(tfa.flash_attention_fwd.routes)
    tfa.flash_attention_fwd(view, good["k"], good["v"])
    assert tfa.flash_attention_fwd.routes == before


@pytest.mark.parametrize("mn_major", [False, True])
@pytest.mark.parametrize("n,kd", [(64, 64), (128, 128), (128, 64)])
def test_tile_product_plain_version(mn_major, n, kd):
    rng = np.random.default_rng(2)
    a = _bf16(rng.standard_normal((64, kd)).astype(np.float32))
    b = _bf16(rng.standard_normal((kd, n) if mn_major else (n, kd))
              .astype(np.float32))
    got = tfa.wgmma_tile_product(a, b, mn_major)
    want = a.float() @ (b.float() if mn_major else b.float().T)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError):
        tfa.wgmma_tile_product(a[:32], b, mn_major)
