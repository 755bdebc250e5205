"""The arithmetic of the tensor-core block-sparse backward kernels (K8a
``dq_mma_kernel`` and K8b ``dkv_mma_kernel`` in
``deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu``), emulated on
the CPU, against the reference.

Those kernels multiply on the tensor cores in TF32 (``mma.sync``
m16n8k8). TF32 keeps 10 explicit mantissa bits, so each fp32 operand x
enters as two: hi = tf32(x) and lo = tf32(x - hi), rounded to nearest
with ties away from zero (``cvt.rna.tf32.f32``; the port's plain model
is :func:`tf32_split`). Every product is hi.hi + hi.lo + lo.hi in fp32,
which leaves out only lo.lo (about 2^-22 of it). These tests pin the
split's rounding rule on hand-picked values, that bf16 values need no
lo term (so the bf16 kernels skip those passes), and why there are
three passes: emulated K8a and K8b with every product (S, dP, then dQ,
or dV and dK) through the split stay inside the gate ``chip_smoke.py``
holds them to on f32 (``_close`` with ``TRAIN_RTOL["float32"]``, 1e-4,
and ``TRAIN_ATOL_REL``, 1e-5 of the largest value) against the port's
plain versions and against the JAX Pallas kernels (interpret mode);
one TF32 pass breaks it on more than a quarter of the elements. Inputs come
from ``numpy.random.default_rng``.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from tests.torch_threads import one_thread  # noqa: F401

jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")

B, H, D = 2, 2, 64
SEED = -123456789
RTOL = chip_smoke.TRAIN_RTOL["float32"]
# one TF32 pass breaks the gate on 29-68% of the elements of dQ, dK and
# dV at these shapes (dV of the causal block-64 layout the least)
SINGLE_MIN_BROKEN = 0.25


def _rna_reference(x):
    """x rounded to 11 significant bits, to nearest, ties away from zero,
    by float64 arithmetic (no bit tricks); the quantum never falls below
    TF32's subnormal spacing 2^-136."""
    if x == 0.0 or math.isnan(x):
        return x
    m, e = math.frexp(abs(x))                 # |x| = m 2^e, m in [0.5, 1)
    quantum = max(2.0 ** (e - 11), 2.0 ** -136)
    r = math.floor(abs(x) / quantum + 0.5) * quantum
    return math.copysign(r, x)


def _f32(x):
    return float(np.float32(x))


@pytest.mark.parametrize("x", [
    1.0, -1.0, 0.0, -0.0,
    1.0 + 2.0 ** -11,                          # a tie: away from zero
    -(1.0 + 2.0 ** -11),
    1.0 + 2.0 ** -10 + 2.0 ** -11,             # a tie above an odd step
    1.0 + 2.0 ** -11 - 2.0 ** -23,             # just below the tie
    1.0 + 2.0 ** -11 + 2.0 ** -23,             # just above it
    2.0 - 2.0 ** -12,                          # carries into the exponent
    -(2.0 - 2.0 ** -12),
    2.0 - 2.0 ** -10,                          # the largest TF32 below 2
    2.0 ** -126,                               # the smallest normal
    2.0 ** -126 * (1 + 2.0 ** -11),            # a tie at the smallest normal
    2.0 ** -140 * 1.5,                         # subnormals
    -(2.0 ** -130) * 1.3,
    2.0 ** 127 * (1 + 2.0 ** -11),             # a tie at the top exponent
    3.14159265, -2.718281828, 1e-30, 7e20,
])
def test_tf32_split_rounds_to_nearest_ties_away(x):
    x = _f32(x)
    hi, lo = tbsa.tf32_split(torch.tensor([x], dtype=torch.float32))
    hi, lo = float(hi[0]), float(lo[0])
    assert hi == _rna_reference(x)
    assert math.copysign(1.0, hi) == math.copysign(1.0, x)
    assert lo == _rna_reference(_f32(x - hi))
    # hi carries 11 significant bits, lo the next 11: what remains of x
    # is at most half a step of lo (near the bottom of the range, half
    # of TF32's subnormal step)
    assert abs(x - hi - lo) <= 2.0 ** -22 * abs(x) + 2.0 ** -137


def test_tf32_split_of_nan_and_of_an_array_elementwise():
    hi, lo = tbsa.tf32_split(torch.tensor([float("nan")]))
    assert math.isnan(float(hi[0]))
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)) \
        .astype(np.float32)
    hi, lo = tbsa.tf32_split(torch.from_numpy(x))
    assert [float(h) for h in hi[:64]] == [_rna_reference(float(v))
                                          for v in x[:64]]
    # both halves have their 13 low mantissa bits clear
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (torch.from_numpy(x).double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * torch.from_numpy(x).double().abs())
                .all())


def test_lo_is_zero_for_bf16_values():
    """bf16 keeps 7 explicit mantissa bits, so a bf16 value is exact in
    TF32: hi == x and lo == 0. The bf16 kernels therefore take one pass
    for Q.K^T and dO.V^T and two for the products with dS or P."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(8192) *
                          10.0 ** rng.integers(-20, 20, 8192))
                         .astype(np.float32)).to(torch.bfloat16).float()
    hi, lo = tbsa.tf32_split(x)
    assert torch.equal(hi, x)
    assert not lo.any()


# --- K8a and K8b emulated --------------------------------------------------

def _dot(eq, a, b, passes):
    """One kernel product: 3 passes (lo.hi + hi.lo + hi.hi, the small
    terms first) or a single TF32 pass (hi.hi), summed in fp32."""
    ah, al = tbsa.tf32_split(a)
    bh, bl = tbsa.tf32_split(b)
    if passes == 1:
        return torch.einsum(eq, ah, bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _emulated_dq(q, k, v, g, lse, delta, lut, nnz, block, causal, rate,
                 passes):
    """K8a: per visited k-block, S = Q.K^T and dP = dO.V^T, p, the
    dropped dP and dS in fp32, then dQ += dS.K; every product by
    :func:`_dot`."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    qb, kb, vb, gb, lse_b, delta_b = tbsa._bwd_operands(q, k, v, g, lse,
                                                        delta, block)
    dq = torch.zeros_like(qb)
    for j in range(lut.shape[-1]):
        lut_j = lut[..., j]
        kg = tbsa._gather_column(kb, lut_j)
        vg = tbsa._gather_column(vb, lut_j)
        q_pos, k_pos = tbsa._pair_positions(lut_j, block, "cpu")
        s = _dot("bhqrd,bhqcd->bhqrc", qb, kg, passes) * scale
        if causal:
            s = torch.where(k_pos <= q_pos, s, DEFAULT_MASK_VALUE)
        p = torch.exp(s - lse_b[..., None])
        dp = _dot("bhqrd,bhqcd->bhqrc", gb, vg, passes)
        if rate:
            dp = dp * tbsa._drop_tile(SEED, b, h, q_pos, k_pos, rate, "cpu")
        ds = p * (dp - delta_b[..., None]) * scale
        valid = (j < nnz)[None, :, :, None, None]
        dq = dq + torch.where(
            valid, _dot("bhqrc,bhqcd->bhqrd", ds, kg, passes), 0.0)
    return dq.reshape(b, h, t, d).permute(0, 2, 1, 3)


def _emulated_dkv(q, k, v, g, lse, delta, lut_t, nnz_t, block, causal, rate,
                  passes):
    """K8b: per visited q-block, S and dP (the kernel forms their
    transposes, the same products), p, the dropped p and dS in fp32,
    then dV += P^T.dO and dK += dS^T.Q; every product by :func:`_dot`."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    qb, kb, vb, gb, lse_b, delta_b = tbsa._bwd_operands(q, k, v, g, lse,
                                                        delta, block)
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    for j in range(lut_t.shape[-1]):
        lut_j = lut_t[..., j]
        own, other = tbsa._pair_positions(lut_j, block, "cpu")
        q_pos, k_pos = other.transpose(-1, -2), own.transpose(-1, -2)
        qg, gg = tbsa._gather_column(qb, lut_j), tbsa._gather_column(gb, lut_j)
        lse_g = tbsa._gather_column(lse_b, lut_j)[..., None]
        delta_g = tbsa._gather_column(delta_b, lut_j)[..., None]
        s = _dot("bhqrd,bhqcd->bhqrc", qg, kb, passes) * scale
        if causal:
            s = torch.where(k_pos <= q_pos, s, DEFAULT_MASK_VALUE)
        p = torch.exp(s - lse_g)
        dp = _dot("bhqrd,bhqcd->bhqrc", gg, vb, passes)
        pd = p
        if rate:
            mult = tbsa._drop_tile(SEED, b, h, q_pos, k_pos, rate, "cpu")
            dp, pd = dp * mult, p * mult
        ds = p * (dp - delta_g) * scale
        valid = (j < nnz_t)[None, :, :, None, None]
        dv = dv + torch.where(
            valid, _dot("bhqrc,bhqrd->bhqcd", pd, gg, passes), 0.0)
        dk = dk + torch.where(
            valid, _dot("bhqrc,bhqrd->bhqcd", ds, qg, passes), 0.0)

    def out(x):
        return x.reshape(b, h, t, d).permute(0, 2, 1, 3)

    return out(dk), out(dv)


def _layout(block, t, causal):
    """The bench's Fixed layout family with an empty q-block row (head 1)
    and a k-block no q-block of head 0 visits."""
    layout = FixedSparsityConfig(
        H, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    layout[1, 1, :] = 0
    layout[0, :, -1] = 0
    return layout


def _inputs(seed, t):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, D)).astype(np.float32)
            for _ in range(4)]


def _emulated_grads(q, k, v, g, lse, delta, layout, block, causal, rate,
                    passes):
    lut, nnz, lut_t, nnz_t = tbsa.layout_tables(layout, "cpu")
    dq = _emulated_dq(q, k, v, g, lse, delta, lut, nnz, block, causal, rate,
                      passes)
    dk, dv = _emulated_dkv(q, k, v, g, lse, delta, lut_t, nnz_t, block,
                           causal, rate, passes)
    return {"dq": dq, "dk": dk, "dv": dv}


def _broken_share(got, want):
    """The share of elements outside ``chip_smoke._close``'s f32 gate."""
    allowed = chip_smoke.TRAIN_ATOL_REL * float(want.abs().max()) + \
        RTOL * want.abs()
    return float(((got - want).abs() > allowed).float().mean())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [16, 64])
def test_three_passes_keep_the_f32_gate_and_one_pass_breaks_it(block, causal,
                                                               rate):
    t = 4 * block
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(block + causal, t))
    layout = _layout(block, t, causal)
    lut, nnz, lut_t, nnz_t = tbsa.layout_tables(layout, "cpu")
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=SEED)
    out, lse = tbsa.block_sparse_attention_fwd_reference(q, k, v, lut, nnz,
                                                         block, **kw)
    assert bool(torch.isinf(lse).any())        # the empty row is covered
    delta = (g * out).sum(-1).permute(0, 2, 1).reshape(B * H, t) \
        .contiguous()
    want = {"dq": tbsa.block_sparse_attention_bwd_dq_reference(
        q, k, v, g, lse, delta, lut, nnz, block, **kw)}
    want["dk"], want["dv"] = tbsa.block_sparse_attention_bwd_dkv_reference(
        q, k, v, g, lse, delta, lut_t, nnz_t, block, **kw)
    three = _emulated_grads(q, k, v, g, lse, delta, layout, block, causal,
                            rate, 3)
    one = _emulated_grads(q, k, v, g, lse, delta, layout, block, causal,
                          rate, 1)
    for name, ref in want.items():
        err, ok = chip_smoke._close(torch, three[name], ref, RTOL)
        assert ok, f"3-pass {name}: max abs err {err}"
        assert not chip_smoke._close(torch, one[name], ref, RTOL)[1]
        assert _broken_share(one[name], ref) > SINGLE_MIN_BROKEN, name


@pytest.mark.parametrize("block,causal,rate", [(16, True, 0.1),
                                               (64, False, 0.0)])
def test_three_passes_keep_the_jax_kernels_gate(block, causal, rate):
    """The same gate against the JAX Pallas backward (interpret mode) on
    f32 inputs; lse and delta from the JAX forward, as the JAX backward
    forms them."""
    t = 4 * block
    qn, kn, vn, gn = _inputs(7 + block, t)
    layout = _layout(block, t, causal)
    lut, nnz = jbsa.build_lut(layout)
    lut_t, nnz_t = jbsa.build_lut(layout.transpose(0, 2, 1))
    scale = D ** -0.5
    seed = jnp.int32(SEED) if rate else None
    jq, jk, jv, jg = (jnp.asarray(x) for x in (qn, kn, vn, gn))
    j_out, j_lse = jbsa._pallas_impl(jq, jk, jv, lut, nnz, block, causal,
                                     scale, interpret=True,
                                     dropout_rate=rate, dropout_seed=seed)
    j_grads = jbsa._pallas_bwd_impl(jq, jk, jv, j_out, j_lse, jg, lut, nnz,
                                    lut_t, nnz_t, block, causal, scale,
                                    interpret=True, dropout_rate=rate,
                                    dropout_seed=seed)
    q, k, v, g = (torch.from_numpy(x) for x in (qn, kn, vn, gn))
    lse = torch.from_numpy(np.asarray(j_lse)[..., 0].copy())
    out = torch.from_numpy(np.asarray(j_out).copy())
    delta = (g * out).sum(-1).permute(0, 2, 1).reshape(B * H, t) \
        .contiguous()
    got = _emulated_grads(q, k, v, g, lse, delta, layout, block, causal,
                          rate, 3)
    one = _emulated_grads(q, k, v, g, lse, delta, layout, block, causal,
                          rate, 1)
    for name, want in zip(("dq", "dk", "dv"), j_grads):
        want = torch.from_numpy(np.asarray(want).copy())
        err, ok = chip_smoke._close(torch, got[name], want, RTOL)
        assert ok, f"3-pass {name} vs JAX: max abs err {err}"
        assert _broken_share(one[name], want) > SINGLE_MIN_BROKEN, name
