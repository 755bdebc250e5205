"""Two data-parallel behaviours of the port's engine at world 2 (gloo),
held to the JAX engine on a 2-device sub-mesh.

- ``eval_batch`` returns the loss over the global batch: each process
  passes its rows (rank r the rows ``[r*n, (r+1)*n)``, JAX
  ``_place_rows``), and the ranks' losses are averaged, as JAX's one
  program over the assembled global array computes it.
- Each rank draws its rows' attention-dropout masks at their global
  coordinates. JAX runs the model once over the global batch, so row b
  of micro-batch i on rank r (global row ``r*m + b``, JAX
  ``_shard_batch``) hashes head coordinate ``(r*m + b) * H + h``. The
  worker records every attention call of a ``train_batch`` with
  dropout 0.1 (its seed, head offset and shape, at the wrappers of K1,
  the dense route and K7); the multiplier those arguments give through
  the port's plain versions must equal JAX's ``_dropout_multiplier_full``
  over the global batch at the rank's rows, bit for bit, on the dense
  path (GPT-2, flash and dense attention) and on the block-sparse path
  (BERT with a Fixed layout). The hidden-dropout generator folds in the
  rank, so two ranks fed the same rows return different ``forward``
  losses.

``gpt2_tiny`` in f32 from the JAX init (``convert_gpt2_params``); BERT
from the port's own seeded init (its weights do not enter the mask).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import (
    _dropout_multiplier_full as jax_multiplier,
)
from deepspeed_tpu_torch.ops.flash_attention import _dropout_multiplier_full
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    _drop_tile,
)
from tests import torch_zero_harness as H

WORLD = 2
F32 = dict(dtype="f32", lr=1e-3, steps=1)
CASES = {
    "eval_flash": dict(F32, kind="eval", flash=True),
    "eval_dense": dict(F32, kind="eval", flash=False),
    "drop_flash": dict(F32, kind="dropout", flash=True),
    "drop_dense": dict(F32, kind="dropout", flash=False),
    "drop_sparse": dict(F32, kind="dropout", bert=True),
}
LOSS_RTOL = 1e-5        # test_torch_zero_parity.py's f32 rtol


@pytest.fixture(scope="module")
def params():
    return H.init_jax_params(use_flash_attention=True)


@pytest.fixture(scope="module")
def world(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_faults")
    state = H.save_port_state(params, root / "tiny.npz")
    H.spawn_world(WORLD, [dict(c, name=n) for n, c in CASES.items()],
                  state, root / "out")
    return {n: H.load_results(root / "out", n, WORLD) for n in CASES}


@pytest.mark.parametrize("name", ["eval_flash", "eval_dense"])
def test_eval_batch_is_the_jax_global_loss(params, world, name):
    case = CASES[name]
    engine, _ = H.jax_engine(params, case, WORLD)
    x = H.jax_batches(case)[0]
    want = float(engine.eval_batch({"input_ids": x}))
    rows = world[name]
    got = [float(arrays["eval"]) for arrays, _ in rows]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=LOSS_RTOL)
    # each rank's own rows give another value: the mean is what moved
    mine = [float(arrays["forward"]) for arrays, _ in rows]
    assert mine[0] != mine[1]


def _port_mask(call):
    B, T, Hh, _ = call["shape"]
    if call["kind"] == "sparse":
        pos = torch.arange(T)
        return _drop_tile(call["seed"], B, Hh, pos[None, :, None],
                          pos[None, None, :], call["rate"], "cpu",
                          call["offset"])[:, :, 0].numpy()
    return _dropout_multiplier_full(B, Hh, T, T, call["rate"], call["seed"],
                                    call["offset"]).numpy()


@pytest.mark.parametrize("name", ["drop_flash", "drop_dense", "drop_sparse"])
def test_each_rank_draws_the_jax_masks_of_its_global_rows(world, name):
    rows = world[name]
    calls = [meta["calls"] for _, meta in rows]
    kind = {"drop_flash": "flash", "drop_dense": "dense",
            "drop_sparse": "sparse"}[name]
    assert calls[0] and all(c["kind"] == kind for c in calls[0])
    assert len(calls[0]) == len(calls[1])
    for per_rank in zip(*calls):
        # one seed for the global micro-batch, as JAX's one program
        assert len({c["seed"] for c in per_rank}) == 1
        B, T, Hh, _ = per_rank[0]["shape"]
        c0 = per_rank[0]
        want = np.asarray(jax_multiplier(
            WORLD * B, Hh, T, T, c0["rate"], jnp.int32(c0["seed"])))
        for rank, call in enumerate(per_rank):
            assert call["offset"] == rank * B * Hh
            got = _port_mask(call)
            np.testing.assert_array_equal(got, want[rank * B:(rank + 1) * B])
            assert (got == 0).any()


@pytest.mark.parametrize("name", ["drop_flash", "drop_dense", "drop_sparse"])
def test_ranks_fed_the_same_rows_drop_differently(world, name):
    losses = [float(arrays["forward"]) for arrays, _ in world[name]]
    assert np.isfinite(losses).all()
    assert losses[0] != losses[1]


# ---------------------------------------------------------------------------
# the block-sparse kernels' head offset (this process)
# ---------------------------------------------------------------------------

BSA = "deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention"


def _sparse_case(block, t, heads, causal):
    import importlib
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig
    jbsa = importlib.import_module(
        "deepspeed_tpu.ops.sparse_attention.block_sparse_attention")
    layout = FixedSparsityConfig(
        heads, block=block, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional" if causal else "bidirectional") \
        .make_layout(t)
    return jbsa, jbsa.build_lut(layout), \
        jbsa.build_lut(layout.transpose(0, 2, 1))


@pytest.mark.parametrize("causal", [False, True])
def test_sparse_plain_kernels_at_an_offset_are_jax_global_rows(causal):
    """Rank 1's rows through K7/K8a/K8b's plain versions at
    ``head_offset = B * H`` equal rows ``[B, 2B)`` of the JAX interpret
    kernels over the global batch of 2B rows."""
    import importlib
    bsa = importlib.import_module(BSA)
    block, t, heads, d, b, rate, seed = 16, 64, 2, 8, 2, 0.2, 1234
    jbsa, (lut, nnz), (lut_t, nnz_t) = _sparse_case(block, t, heads, causal)
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((2 * b, t, heads, d))
                  .astype(np.float32) for _ in range(4))
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    j_out, j_lse = jbsa._pallas_impl(jq, jk, jv, lut, nnz, block, causal,
                                     scale, interpret=True,
                                     dropout_rate=rate,
                                     dropout_seed=jnp.int32(seed))
    j_grads = jbsa._pallas_bwd_impl(jq, jk, jv, j_out, j_lse, jg, lut, nnz,
                                    lut_t, nnz_t, block, causal, scale,
                                    interpret=True, dropout_rate=rate,
                                    dropout_seed=jnp.int32(seed))
    mine = slice(b, 2 * b)
    tq, tk, tv, tg = (torch.from_numpy(x[mine]) for x in (q, k, v, g))
    kw = dict(causal=causal, sm_scale=scale, dropout_rate=rate,
              dropout_seed=seed, dropout_head_offset=b * heads)
    out, lse = bsa.block_sparse_attention_fwd(
        tq, tk, tv, torch.from_numpy(lut), torch.from_numpy(nnz), block,
        **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[mine],
                               atol=2e-5, rtol=0)
    delta = (tg * out).sum(-1).permute(0, 2, 1).reshape(b * heads, t) \
        .contiguous()
    dq = bsa.block_sparse_attention_bwd_dq(
        tq, tk, tv, tg, lse, delta, torch.from_numpy(lut),
        torch.from_numpy(nnz), block, **kw)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(
        tq, tk, tv, tg, lse, delta, torch.from_numpy(lut_t),
        torch.from_numpy(nnz_t), block, **kw)
    for got, want in zip((dq, dk, dv), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[mine],
                                   atol=2e-5, rtol=0)
    # at offset 0 the rows would draw rank 0's masks: another result
    out0, _ = bsa.block_sparse_attention_fwd(
        tq, tk, tv, torch.from_numpy(lut), torch.from_numpy(nnz), block,
        **dict(kw, dropout_head_offset=0))
    assert not torch.allclose(out0, out, atol=1e-3)
