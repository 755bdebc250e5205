"""Block-sparse attention: the port
(`deepspeed_tpu_torch/ops/sparse_attention/`) against the JAX package
(`deepspeed_tpu/ops/sparse_attention/`).

On the CPU the JAX Pallas kernels run in interpret mode
(``_pallas_impl`` / ``_pallas_bwd_impl`` with ``interpret=True``, and
``implementation="pallas", interpret=True`` through ``jax.grad``, as the
JAX package's own tests run them); the port's wrappers run their plain
PyTorch versions, which the CUDA kernels are held to on the card. Inputs
come from ``numpy.random.default_rng``.

Tolerances: atol 1e-5 on f32 outputs, lse and gradients of magnitude
~1 (both sides accumulate in fp32, in different orders); layouts, LUTs
and the parsed config are compared exactly, and the dropout mask is the
same counter hash on both sides (bit-identical), so dropout cases keep
the same tolerance.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jsa
import deepspeed_tpu_torch.ops.sparse_attention as tsa
from deepspeed_tpu.runtime.config import get_sparse_attention as jax_parse
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.torch_threads import one_thread  # noqa: F401

# the modules (each package re-exports a function under the module name)
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")

B, H, D = 2, 4, 16
ATOL = 1e-5
SEED = -24680


def _configs(pkg, block=16):
    """Every layout family, shared and per-head, by name."""
    return {
        "dense": pkg.DenseSparsityConfig(H, block=block),
        "fixed": pkg.FixedSparsityConfig(H, block=block, num_local_blocks=2),
        "fixed_uni_per_head": pkg.FixedSparsityConfig(
            H, block=block, different_layout_per_head=True,
            num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional", num_different_global_patterns=4),
        "fixed_horizontal": pkg.FixedSparsityConfig(
            H, block=block, num_local_blocks=4, num_global_blocks=2,
            horizontal_global_attention=True),
        "variable_per_head": pkg.VariableSparsityConfig(
            H, block=block, different_layout_per_head=True,
            num_random_blocks=1, local_window_blocks=[1, 2],
            global_block_indices=[0, 3], global_block_end_indices=[1, 5],
            seed=7),
        "bigbird_per_head": pkg.BigBirdSparsityConfig(
            H, block=block, different_layout_per_head=True,
            num_random_blocks=2, num_sliding_window_blocks=3, seed=11),
        "bigbird": pkg.BigBirdSparsityConfig(H, block=block),
        "bslongformer": pkg.BSLongformerSparsityConfig(
            H, block=block, num_sliding_window_blocks=3,
            global_block_indices=[0, 4]),
    }


# ---------------------------------------------------------------------------
# layouts, LUTs, config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_configs(jsa)))
@pytest.mark.parametrize("seq_len", [64, 128, 160])
def test_layouts_equal_jax(name, seq_len):
    want = _configs(jsa)[name].make_layout(seq_len)
    got = _configs(tsa)[name].make_layout(seq_len)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(_configs(jsa)))
def test_luts_equal_jax(name):
    layout = _configs(jsa)[name].make_layout(128)
    for lay in (layout, layout.transpose(0, 2, 1)):
        for got, want in zip(tsa.build_lut(lay), jbsa._build_lut_numpy(lay)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_layout_errors_match_jax():
    with pytest.raises(ValueError, match="dividable"):
        tsa.FixedSparsityConfig(H, block=16).make_layout(100)
    with pytest.raises(ValueError, match="dividable"):
        tsa.FixedSparsityConfig(H, num_local_blocks=3, num_global_blocks=2)
    with pytest.raises(NotImplementedError, match="directional"):
        tsa.FixedSparsityConfig(H, attention="sideways")
    with pytest.raises(ValueError, match="Number of different layouts"):
        tsa.FixedSparsityConfig(H, num_different_global_patterns=2)


def test_device_tables_are_cached_per_layout():
    layout = _configs(tsa)["fixed"].make_layout(64)
    a = tbsa.layout_tables(layout, "cpu")
    assert tbsa.layout_tables(layout.copy(), "cpu") is a
    lut_t, nnz_t = tsa.build_lut(layout.transpose(0, 2, 1))
    assert np.array_equal(a[2].numpy(), lut_t)
    assert np.array_equal(a[3].numpy(), nnz_t)
    assert all(t.dtype == torch.int32 for t in a)


SPARSE_BLOCKS = {
    "fixed": {"mode": "fixed", "block": 32, "num_local_blocks": 8,
              "attention": "unidirectional"},
    "dense": {"mode": "dense", "different_layout_per_head": True},
    "variable": {"mode": "variable", "num_random_blocks": 2,
                 "global_block_end_indices": [3]},
    "bigbird": {"mode": "bigbird", "num_sliding_window_blocks": 5},
    "bslongformer": {"mode": "bslongformer", "global_block_indices": [0, 2],
                     "global_block_end_indices": [1, 4]},
    "default": {},
}


@pytest.mark.parametrize("name", sorted(SPARSE_BLOCKS))
def test_sparse_attention_config_parses_as_jax(name):
    raw = {"train_batch_size": 8, "sparse_attention": SPARSE_BLOCKS[name]}
    assert DeepSpeedConfig(raw).sparse_attention == jax_parse(raw)
    assert DeepSpeedConfig({"train_batch_size": 8}).sparse_attention is None


def test_unknown_sparse_mode_raises_the_jax_error():
    raw = {"train_batch_size": 8, "sparse_attention": {"mode": "strided"}}
    with pytest.raises(NotImplementedError) as want:
        jax_parse(raw)
    with pytest.raises(NotImplementedError) as got:
        DeepSpeedConfig(raw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the interpret-mode kernels
# ---------------------------------------------------------------------------

def _inputs(seed, t):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, D)).astype(np.float32)
            for _ in range(4)]


def _kernel_layout(block, t, causal):
    """A Fixed layout with an empty q-block row (head 1) and a k-block
    no q-block of head 0 visits."""
    layout = jsa.FixedSparsityConfig(
        H, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    layout[1, 1, :] = 0
    layout[0, :, -1] = 0
    return layout


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_kernel_plain_versions_match_jax_interpret(block, causal, rate):
    t = 4 * block
    q, k, v, g = _inputs(block + causal, t)
    layout = _kernel_layout(block, t, causal)
    lut, nnz = jbsa.build_lut(layout)
    lut_t, nnz_t = jbsa.build_lut(layout.transpose(0, 2, 1))
    scale = D ** -0.5
    seed = jnp.int32(SEED) if rate else None
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = jbsa._pallas_impl(jq, jk, jv, lut, nnz, block, causal,
                                     scale, interpret=True,
                                     dropout_rate=rate, dropout_seed=seed)
    j_grads = jbsa._pallas_bwd_impl(jq, jk, jv, j_out, j_lse, jg, lut, nnz,
                                    lut_t, nnz_t, block, causal, scale,
                                    interpret=True, dropout_rate=rate,
                                    dropout_seed=seed)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    kw = dict(causal=causal, sm_scale=scale, dropout_rate=rate,
              dropout_seed=SEED)
    out, lse = tbsa.block_sparse_attention_fwd(
        tq, tk, tv, torch.from_numpy(lut), torch.from_numpy(nnz), block,
        **kw)
    want_lse = np.asarray(j_lse)[..., 0]
    empty = np.isinf(want_lse)
    assert empty.any() and np.array_equal(np.isinf(lse.numpy()), empty)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy()[~empty], want_lse[~empty],
                               atol=ATOL, rtol=0)
    delta = (tg * out).sum(-1).permute(0, 2, 1).reshape(B * H, t) \
        .contiguous()
    dq = tbsa.block_sparse_attention_bwd_dq(
        tq, tk, tv, tg, lse, delta, torch.from_numpy(lut),
        torch.from_numpy(nnz), block, **kw)
    dk, dv = tbsa.block_sparse_attention_bwd_dkv(
        tq, tk, tv, tg, lse, delta, torch.from_numpy(lut_t),
        torch.from_numpy(nnz_t), block, **kw)
    for got, want in zip((dq, dk, dv), j_grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.2)])
def test_autograd_matches_jax_grad_through_interpret_kernels(causal, rate):
    block, t = 16, 64
    q, k, v, g = _inputs(3, t)
    layout = _kernel_layout(block, t, causal)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=SEED if rate else None)

    def f(*a):
        return jbsa.block_sparse_attention(*a, layout, block,
                                           implementation="pallas",
                                           interpret=True, **kw)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tbsa.block_sparse_attention(*ts, layout, block, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=0)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the gather route and the masked-dense oracle
# ---------------------------------------------------------------------------

def _extras(seed, t, which):
    rng = np.random.default_rng(seed)
    kw = {}
    if "rpe" in which:
        kw["rpe"] = rng.standard_normal((B, H, t, t)).astype(np.float32)
    if "kpm_add" in which:
        m = np.zeros((B, t), np.float32)
        m[1, t // 2:] = -10000.0
        kw.update(key_padding_mask=m, key_padding_mask_mode="add")
    if "kpm_mul" in which:
        m = np.ones((B, t), np.float32)
        m[0, 5:9] = 0.0
        kw.update(key_padding_mask=m, key_padding_mask_mode="mul")
    if "attn_mul" in which:
        kw.update(attn_mask=np.tril(np.ones((t, t), np.float32)),
                  attn_mask_mode="mul")
    if "attn_add" in which:
        kw.update(attn_mask=rng.standard_normal((t, t)).astype(np.float32),
                  attn_mask_mode="add")
    return kw


EXTRAS = [("rpe",), ("kpm_add",), ("kpm_mul", "attn_add"),
          ("attn_mul", "rpe"), ("kpm_add", "attn_mul")]


@pytest.mark.parametrize("which", EXTRAS, ids="+".join)
@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.2)])
def test_gather_route_matches_jax_xla(which, causal, rate):
    block, t = 16, 64
    q, k, v, g = _inputs(4, t)
    layout = _configs(jsa)["bigbird_per_head"].make_layout(t)
    extras = _extras(5, t, which)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    j_extras = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                for n, x in extras.items()}

    def f(*a):
        return jbsa.block_sparse_attention(*a, layout, block,
                                           implementation="xla",
                                           **j_extras, **kw)

    j_out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))
    t_extras = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                for n, x in extras.items()}
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    before = tbsa._xla_impl.calls
    out = tbsa.block_sparse_attention(*ts, layout, block, **t_extras, **kw)
    assert tbsa._xla_impl.calls == before + 1
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=0)
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("which", [(), ("rpe", "kpm_mul", "attn_add"),
                                   ("kpm_add", "attn_mul")], ids=str)
@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.2)])
def test_masked_dense_matches_jax(which, causal, rate):
    block, t = 16, 64
    q, k, v, _ = _inputs(6, t)
    layout = _configs(jsa)["fixed_uni_per_head"].make_layout(t)
    extras = _extras(7, t, which)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    want = jbsa.masked_dense_attention(
        *(jnp.asarray(x) for x in (q, k, v)), layout, block,
        **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
           for n, x in extras.items()}, **kw)
    got = tbsa.masked_dense_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), layout, block,
        **{n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
           for n, x in extras.items()}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_kernel_route_equals_masked_dense_without_empty_rows():
    """With no empty row the kernels' plain versions and the dense oracle
    compute one function (the port against itself, JAX not involved)."""
    block, t = 16, 64
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(8, t))
    layout = _configs(tsa)["variable_per_head"].make_layout(t)
    for causal in (False, True):
        got = tsa.block_sparse_attention(q, k, v, layout, block,
                                         causal=causal)
        want = tsa.masked_dense_attention(q, k, v, layout, block,
                                          causal=causal)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_route_choice_and_argument_checks():
    block, t = 16, 64
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(9, t))
    layout = _configs(tsa)["fixed"].make_layout(t)
    before = tbsa._xla_impl.calls
    tsa.block_sparse_attention(q, k, v, layout, block)
    tsa.block_sparse_attention(q, k, v, layout, block,
                               implementation="pallas")
    assert tbsa._xla_impl.calls == before
    with pytest.raises(AssertionError, match="xla"):
        tsa.block_sparse_attention(q, k, v, layout, block,
                                   key_padding_mask=torch.zeros(B, t),
                                   implementation="pallas")
    with pytest.raises(ValueError, match="unknown implementation"):
        tsa.block_sparse_attention(q, k, v, layout, block,
                                   implementation="triton")
    with pytest.raises(ValueError, match="requires dropout_seed"):
        tsa.block_sparse_attention(q, k, v, layout, block, dropout_rate=0.1)
    with pytest.raises(AssertionError, match="layout heads"):
        tsa.block_sparse_attention(q[:, :, :2], k[:, :, :2], v[:, :, :2],
                                   layout, block)
    with pytest.raises(AssertionError, match="seq len"):
        tsa.block_sparse_attention(q, k, v, layout, 32)


def test_wrappers_never_run_the_plain_version_off_the_cpu(monkeypatch):
    """On a device other than the CPU the wrapper raises instead of
    running its plain version (on CUDA it launches the kernel)."""
    called = []
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        monkeypatch.setattr(tbsa, f"block_sparse_attention_{name}_reference",
                            lambda *a, **kw: called.append(1))
    q = torch.zeros(1, 32, 2, 8, device="meta")
    lut = torch.zeros(2, 2, 1, dtype=torch.int32, device="meta")
    nnz = torch.ones(2, 2, dtype=torch.int32, device="meta")
    lse = torch.zeros(2, 32, device="meta")
    before = tbsa.block_sparse_attention_fwd.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbsa.block_sparse_attention_fwd(q, q, q, lut, nnz, 16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbsa.block_sparse_attention_bwd_dq(q, q, q, q, lse, lse, lut, nnz, 16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbsa.block_sparse_attention_bwd_dkv(q, q, q, q, lse, lse, lut, nnz,
                                            16)
    assert called == [] and tbsa.block_sparse_attention_fwd.launches == before


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [False, True])
def test_sparse_self_attention_matches_jax(mask):
    t = 64
    q, k, v, _ = _inputs(10, t)
    jcfg = jsa.FixedSparsityConfig(H, block=16, num_local_blocks=2,
                                   attention="unidirectional")
    tcfg = tsa.FixedSparsityConfig(H, block=16, num_local_blocks=2,
                                   attention="unidirectional")
    kpm = None
    if mask:
        kpm = np.zeros((B, t), np.float32)
        kpm[0, -7:] = -10000.0
    heads_first = [np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                   for x in (q, k, v)]
    want = jsa.SparseSelfAttention(jcfg)(
        *(jnp.asarray(x) for x in heads_first),
        key_padding_mask=None if kpm is None else jnp.asarray(kpm))
    core = tsa.SparseSelfAttention(tcfg)
    got = core(*(torch.from_numpy(x) for x in heads_first),
               key_padding_mask=None if kpm is None
               else torch.from_numpy(kpm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert core.get_layout(t) is core.get_layout(t)
    with pytest.raises(NotImplementedError, match="self-attention"):
        core(torch.from_numpy(heads_first[0]),
             torch.from_numpy(heads_first[1][:, :, :32]),
             torch.from_numpy(heads_first[2]))


def test_bert_sparse_self_attention_matches_jax():
    t, hidden = 64, H * D
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, t, hidden)).astype(np.float32)
    mask = np.zeros((B, 1, 1, t), np.float32)
    mask[1, ..., 50:] = -10000.0
    jmod = jsa.BertSparseSelfAttention(
        hidden, H, jsa.FixedSparsityConfig(H, block=16, num_local_blocks=2))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    tmod = tsa.BertSparseSelfAttention(
        hidden, H, tsa.FixedSparsityConfig(H, block=16, num_local_blocks=2))
    tmod.load_state_dict({
        f"{n}.{'weight' if leaf == 'kernel' else 'bias'}":
            torch.from_numpy(np.array(a).T.copy() if leaf == "kernel"
                             else np.array(a))
        for n in ("query", "key", "value")
        for leaf, a in params[n].items()})
    got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
