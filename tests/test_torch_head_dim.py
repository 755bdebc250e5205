"""Head dims past 128 and past 256: the port's flash attention (K1-K3),
block-sparse attention (K7, K8a, K8b) and flash decode (K5 ring, K6
paged) take any head dim, as the JAX package (which has no cap)
computes them.

On the CPU the JAX Pallas kernels run in interpret mode and the port's
wrappers run their plain versions, which the CUDA kernels are held to
on the card (``chip_smoke.py``; the ``cuda``-marked tests in
``tests/test_torch_cuda_kernels.py``). Past 256 the parity runs at
head dims 264, 320 and 512 (B 1, T 64; decode: 3 rows at positions 5,
0 and 31 of a 32-slot cache). Also pinned here: bf16 past
head dim 128 takes the FMA kernels (the tensor-core kernels hold up to
128); the column chunks a launch splits a head into
(``ops.head_dim.n_col``, at the width the kernel sources hold) and that
every launcher hands their count to its kernel as the grid's chunk
extent; when K7 drops the lo term of its
scaled q. Inputs come from ``numpy.random.default_rng``.

Tolerance: atol 1e-5 on f32 outputs and gradients of magnitude ~1, as
in the narrower tests: both sides accumulate in fp32, in different
orders.
"""

import contextlib
import ctypes
import importlib
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_decode import (
    flash_decode as jax_flash_decode,
    flash_decode_paged as jax_flash_decode_paged)
import chip_smoke
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import head_dim
from tests.torch_threads import one_thread  # noqa: F401

jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")
jbsa = importlib.import_module(
    "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
jsa = importlib.import_module("deepspeed_tpu.ops.sparse_attention")
tbsa = importlib.import_module(
    "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention")
# the package re-exports each entry function under its module's name
tfd = importlib.import_module("deepspeed_tpu_torch.ops.flash_decode")

B, T, H = 1, 64, 2
ATOL = 1e-5
SEED, OFFSET, NUM_HEADS = -987654321, 1, 3


def _inputs(seed, d, t=T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, t, H, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("d,causal,bias,rate", [(160, True, True, 0.1),
                                                (256, False, False, 0.0),
                                                (256, True, True, 0.1),
                                                (264, True, True, 0.1),
                                                (320, False, False, 0.0),
                                                (512, True, True, 0.1),
                                                (512, False, False, 0.0)])
def test_flash_attention_matches_pallas_interpret_past_128(d, causal, bias,
                                                           rate):
    q, k, v, g = _inputs(d + causal, d)
    kb = None
    if bias:
        kb = np.random.default_rng(d).standard_normal((B, T)) \
            .astype(np.float32)
        kb[:, 5::9] = jfa.MASK_BIAS
    drop = {} if not rate else dict(
        dropout_rate=rate, dropout_seed=SEED, dropout_head_offset=OFFSET,
        dropout_num_heads=NUM_HEADS)
    args = [jnp.asarray(x) for x in (q, k, v)]

    def f(q_, k_, v_):
        return jfa.flash_attention(
            q_, k_, v_, key_bias=None if kb is None else jnp.asarray(kb),
            causal=causal, block_q=32, block_k=32, implementation="pallas",
            **drop)

    want_out, vjp = jax.vjp(f, *args)
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(
        *ts, causal=causal,
        key_bias=None if kb is None else torch.from_numpy(kb), **drop)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


def _block_sparse_case(d, block, causal, rate, t=None):
    t = t or 4 * block
    q, k, v, g = _inputs(block + causal, d, t)
    layout = jsa.FixedSparsityConfig(
        H, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    layout[1, 1, :] = 0                        # an empty q-block row
    lut, nnz = jbsa.build_lut(layout)
    lut_t, nnz_t = jbsa.build_lut(layout.transpose(0, 2, 1))
    scale = d ** -0.5
    seed = jnp.int32(SEED) if rate else None
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = jbsa._pallas_impl(jq, jk, jv, lut, nnz, block, causal,
                                     scale, interpret=True,
                                     dropout_rate=rate, dropout_seed=seed)
    j_grads = jbsa._pallas_bwd_impl(jq, jk, jv, j_out, j_lse, jg, lut, nnz,
                                    lut_t, nnz_t, block, causal, scale,
                                    interpret=True, dropout_rate=rate,
                                    dropout_seed=seed)
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = tbsa.block_sparse_attention(
        *ts, layout, block, causal=causal, dropout_rate=rate,
        dropout_seed=SEED if rate else None)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=ATOL, rtol=0)
    for name, got, want in zip(("dq", "dk", "dv"), grads, j_grads):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("block,causal,rate", [(16, False, 0.0),
                                               (16, True, 0.2),
                                               (32, False, 0.2)])
def test_block_sparse_matches_pallas_interpret_at_256(block, causal, rate):
    _block_sparse_case(256, block, causal, rate)


@pytest.mark.parametrize("d,block,causal,rate", [(264, 16, True, 0.2),
                                                 (320, 32, False, 0.2),
                                                 (320, 16, False, 0.0),
                                                 (512, 16, True, 0.0),
                                                 (512, 32, True, 0.2)])
def test_block_sparse_matches_pallas_interpret_past_256(d, block, causal,
                                                        rate):
    """Forward and backward at head dims the kernels split into column
    chunks, blocks 16 and 32 at T 64, an empty q-block row."""
    _block_sparse_case(d, block, causal, rate, t=64)


DECODE_B, DECODE_S, DECODE_H = 3, 32, 2
DECODE_POS = np.array([5, 0, DECODE_S - 1], np.int32)


@pytest.mark.parametrize("d", [264, 320, 512])
def test_flash_decode_ring_matches_jax_past_256(d):
    rng = np.random.default_rng(d)
    q = rng.standard_normal((DECODE_B, 1, DECODE_H, d)).astype(np.float32)
    k, v = (rng.standard_normal((DECODE_B, DECODE_S, DECODE_H, d))
            .astype(np.float32) for _ in range(2))
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(DECODE_POS), block_k=16)
    got = tfd.flash_decode(*(torch.from_numpy(x) for x in
                             (q, k, v, DECODE_POS)), block_k=16)
    assert got.shape == (DECODE_B, 1, DECODE_H, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("d", [264, 320, 512])
def test_flash_decode_paged_matches_jax_past_256(d):
    page, per_row = 8, DECODE_S // 8
    n_pages = 1 + DECODE_B * per_row
    rng = np.random.default_rng(d + 1)
    q = rng.standard_normal((DECODE_B, 1, DECODE_H, d)).astype(np.float32)
    k, v = (rng.standard_normal((n_pages, page, DECODE_H, d))
            .astype(np.float32) for _ in range(2))
    table = rng.permutation(np.arange(1, n_pages)).reshape(
        DECODE_B, per_row).astype(np.int32)
    want = jax_flash_decode_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(DECODE_POS), jnp.asarray(table), block_k=page)
    got = tfd.flash_decode_paged(*(torch.from_numpy(x) for x in
                                   (q, k, v, DECODE_POS, table)),
                                 block_k=page)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("d,route", [(128, "tensor_core"), (136, "fma"),
                                     (160, "fma"), (256, "fma")])
def test_bf16_past_128_takes_the_fma_route(d, route):
    """The wgmma kernels hold a head of at most 128: an aligned bf16 call
    past it runs the FMA kernels, forward and backward."""
    shape = (2, 64, 4, d)
    q, k, v, g = (torch.zeros(shape, dtype=torch.bfloat16) for _ in "qkvg")
    stats = torch.zeros(2 * 4, 64)
    assert tfa.attention_route(q, k, v) == route
    assert tfa.attention_route(q, k, v, g, stats, stats) == route
    assert tfa.attention_route(q.float(), k.float(), v.float()) == "fma"


@pytest.mark.parametrize("d,plan", [
    (1, [(0, 1)]), (64, [(0, 64)]), (256, [(0, 256)]),
    (257, [(0, 256), (256, 1)]), (264, [(0, 256), (256, 8)]),
    (320, [(0, 256), (256, 64)]), (512, [(0, 256), (256, 256)]),
    (600, [(0, 256), (256, 256), (512, 88)])])
def test_column_chunk_plan(d, plan):
    """The CTAs a launch gives a head (``n_col``: one per chunk of at most
    256 columns, in order, covering every column once): chunk c owns
    columns [c * COLUMN_CHUNK, min(d, (c + 1) * COLUMN_CHUNK))."""
    w = head_dim.COLUMN_CHUNK
    assert head_dim.n_col(d) == len(plan)
    assert [(c * w, min(w, d - c * w))
            for c in range(head_dim.n_col(d))] == plan
    assert sum(n for _, n in plan) == d


def test_column_chunk_width_matches_the_kernel_sources():
    """The wrappers' chunk width is the one the CUDA sources compile
    (``kColChunk``), and every source that splits a head reads it from
    the one shared header."""
    csrc = Path(tfa.__file__).parent / "csrc"
    header = (csrc / "column_chunk.cuh").read_text()
    assert f"constexpr int kColChunk = {head_dim.COLUMN_CHUNK};" in header
    for src in ("flash_attention.cu", "block_sparse_attention.cu",
                "flash_decode.cu"):
        text = (csrc / src).read_text()
        assert "kColChunk =" not in text
        assert "column_chunks(" in text


@pytest.mark.parametrize("name,key", [
    ("_ZN58_GLOBAL__N__33860b1f_25_block_sparse_attention_cu_16c286df14"
     "fwd_mma_kernelIfLi64ELi256ELb1EEEv12SparseParamsi",
     "K7<float32,64,256,wide>"),
    ("_ZN58_GLOBAL__N__33860b1f_25_block_sparse_attention_cu_16c286df14"
     "fwd_mma_kernelIfLi64ELi256ELb0EEEv12SparseParamsi",
     "K7<float32,64,256>"),
    ("dq_mma_kernelI13__nv_bfloat16Li32ELi128ELb0EEEv12SparseParamsi",
     "K8a<bfloat16,32,128>"),
    ("dkv_mma_kernelI6__halfLi16ELi256ELb1EEEv12SparseParamsi",
     "K8b<float16,16,256,wide>"),
    ("fwd_wgmma_kernelILi64EEEv10AttnParams", None)])
def test_build_check_names_each_block_sparse_instance(name, key):
    """``chip_smoke.py``'s build phase counts HMMA and spills per K7 / K8
    instance by its mangled name: the kDmax-256 instance that holds the
    column chunks' code (``kWide``) is one of its own, and other
    kernels are not counted."""
    assert chip_smoke._sparse_instance(name) == key


def test_column_chunks_refuse_an_empty_head():
    with pytest.raises(ValueError, match="head_dim must be >= 1"):
        head_dim.n_col(0)


class _Recorder:
    """Stands in for a kernel library: records each launch's arguments
    and reports success, so the launchers run on CPU tensors."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tfa, "_library", lambda: rec)
    monkeypatch.setattr(tfd, "_library", lambda: rec)
    monkeypatch.setattr(tbsa, "_library", lambda *a: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return rec


def _params(args):
    return ctypes.cast(args[1], ctypes.POINTER(
        type(args[1]._obj))).contents


@pytest.mark.parametrize("d", [64, 256, 264, 512])
def test_every_launcher_hands_the_chunk_count_to_its_kernel(recorder, d):
    """K1-K3, K7/K8 and K5/K6 launch with ``n_col(d)`` chunk CTAs per
    head, the extent the kernels check against ceil(d / 256); no
    launcher refuses a head past 256."""
    n_col = head_dim.n_col(d)
    q = torch.zeros((1, 32, 2, d))
    stats = torch.zeros(2, 32)
    kw = dict(key_bias=None, dropout_num_heads=None, dropout_rate=0.0,
              dropout_seed=0, dropout_head_offset=0, causal=True,
              sm_scale=1.0)
    tfa._launch(tfa.flash_attention_fwd, 0, q, q, q, None, None, None, kw,
                out=q, lse_out=stats)
    lut = torch.zeros(2, 2, 1, dtype=torch.int32)
    nnz = torch.ones(2, 2, dtype=torch.int32)
    skw = dict(causal=False, sm_scale=1.0, dropout_rate=0.0, dropout_seed=0)
    tbsa._launch(1, q, q, q, q, stats, stats, lut, nnz, 16, skw, dq=q)
    qd = torch.zeros((2, 1, 2, d))
    cache = torch.zeros((2, 16, 2, d))
    pos = torch.tensor([3, 15], dtype=torch.int32)
    tfd._launch(qd, cache, cache, pos, None, None)
    tfd._launch_paged(qd, cache, cache, pos,
                      torch.tensor([[0], [1]], dtype=torch.int32), None,
                      None)
    names = [name for name, _ in recorder.calls]
    assert names == ["flash_attention_launch",
                     "block_sparse_attention_launch", "flash_decode_launch",
                     "flash_decode_paged_launch"]
    assert _params(recorder.calls[0][1]).n_col == n_col
    assert _params(recorder.calls[1][1]).n_col == n_col
    # the decode entries take D then the chunk count
    assert recorder.calls[2][1][12:14] == (d, n_col)
    assert recorder.calls[3][1][13:15] == (d, n_col)


@pytest.mark.parametrize("dtype,scale,exact", [
    (torch.bfloat16, 64 ** -0.5, True), (torch.float16, 256 ** -0.5, True),
    (torch.float16, 0.5, True), (torch.bfloat16, 96 ** -0.5, False),
    (torch.float16, 320 ** -0.5, False), (torch.float32, 0.125, False)])
def test_k7_drops_the_lo_term_of_q_only_when_it_is_exact(recorder, dtype,
                                                        scale, exact):
    """K7 forms q * sm_scale in f32: on a 2-byte q times a power of two
    it is exact in TF32 (``q_exact``), else it keeps its lo term; the
    plain model of that rounding (``tf32_split``) agrees on every fp16
    and bf16 value."""
    assert tbsa.scaled_q_exact(dtype, scale) == exact
    q = torch.zeros((1, 32, 2, 64), dtype=dtype)
    stats = torch.zeros(2, 32)
    lut = torch.zeros(2, 2, 1, dtype=torch.int32)
    nnz = torch.ones(2, 2, dtype=torch.int32)
    kw = dict(causal=False, sm_scale=scale, dropout_rate=0.0,
              dropout_seed=0)
    tbsa._launch(0, q, q, q, None, None, None, lut, nnz, 16, kw, out=q,
                 lse_out=stats)
    assert _params(recorder.calls[0][1]).q_exact == int(exact)
    if dtype != torch.float32:
        every = torch.arange(-32768, 32768, dtype=torch.int32).to(
            torch.int16).view(dtype).float()
        every = every[torch.isfinite(every)]
        _, lo = tbsa.tf32_split(every * torch.tensor(scale,
                                                     dtype=torch.float32))
        assert bool((lo == 0).all()) == exact
