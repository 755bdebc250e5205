"""CSR sparse gradients in the port (`deepspeed_tpu_torch/runtime/
csr_tensor.py` and the engine's sparse-gradient step at ZeRO stage 0).

- ``dense_to_csr`` / ``to_dense`` / ``add`` / ``embedding_grad_csr``
  give JAX's dense results bit for bit (f32), and the same rows.
- At world 2 (gloo, ``tests/torch_zero_worker.py``; GPT-2 tiny at
  ``n_positions`` 512 so that the untied ``wpe`` takes the CSR exchange)
  a ``sparse_gradients`` run equals the dense stage-0 run bit for bit in
  f32, losses and fp32 masters: a row's sum over two ranks is one sum of
  the same two values. At world 4 the dense all-reduce adds the four
  ranks' rows in gloo's order and the CSR scatter-add in rank order, so
  the run agrees to fp32 rounding (losses rtol 1e-6, fp32 masters at
  relative L2 1e-5 a leaf, the measure of ``test_torch_config_keys.py``).
  No order of a row's addends reproduces gloo's: its ring gives the same
  four addends different sums at different positions of one buffer (a
  quarter of the elements take another association), so bit equality
  there would need gloo's chunking of each leaf, and NCCL's on the card
  is another. The CSR sum is held bit for bit to the rank-order sum.
  The tied ``wte`` falls back to the dense
  all-reduce, counted in ``sparse_grad_dense_fallbacks``, its lost mass
  in ``sparse_grad_dropped``; the losses equal the JAX sparse step's
  (rtol 1e-5, ``tests/test_torch_zero_parity.py``).
- Dropout: the port's sparse step draws dropout as its dense path does
  (``global_rows``), not as JAX's sparse step (which folds the data index
  into its key, ``engine.py:1946``); ``jax.random`` cannot be matched
  either way, so the JAX comparison runs at dropout 0.
- ZeRO stages above 0 raise JAX's assertion.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import csr_tensor as jcsr
from deepspeed_tpu_torch.runtime import csr_tensor as tcsr
from tests import torch_zero_harness as H

MODEL = {"n_positions": 512}
# a rank's value in the sum-order case: 1 + 2^-24 rounds back to 1
SUM_ORDER_VALUES = [1.0, 2.0 ** -24, 2.0 ** -24, -1.0]


def _dense(rows=40, d=6, live=12, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, d), np.float32)
    idx = rng.choice(rows, live, replace=False)
    x[idx] = rng.standard_normal((live, d)).astype(np.float32)
    return x


@pytest.mark.parametrize("k", [None, 12, 20, 5])
def test_dense_to_csr_and_back_equal_jax(k):
    x = _dense()
    t = tcsr.dense_to_csr(torch.from_numpy(x), k)
    j = jcsr.dense_to_csr(jnp.asarray(x), k)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    live = np.abs(x).sum(1) > 0
    kk = x.shape[0] if k is None else k
    assert t.indices.numel() == np.asarray(j.indices).size == kk
    # the rows with mass are the same rows
    tl = {int(i) for i in t.indices if live[int(i)]}
    jl = {int(i) for i in np.asarray(j.indices) if live[int(i)]}
    assert tl == jl
    assert t.sparse_size() == int(j.sparse_size())


def test_add_and_embedding_grad_equal_jax():
    a, b = _dense(seed=1), _dense(seed=2)
    t = tcsr.dense_to_csr(torch.from_numpy(a), 12).add(
        tcsr.dense_to_csr(torch.from_numpy(b), 12))
    j = jcsr.dense_to_csr(jnp.asarray(a), 12).add(
        jcsr.dense_to_csr(jnp.asarray(b), 12))
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 30, (4, 7))
    dout = rng.standard_normal((4, 7, 5)).astype(np.float32)
    t = tcsr.embedding_grad_csr(torch.from_numpy(ids),
                                torch.from_numpy(dout), 30)
    j = jcsr.embedding_grad_csr(jnp.asarray(ids), jnp.asarray(dout), 30)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    # and the duplicate ids summed, as the embedding's gradient
    table = torch.zeros(30, 5, requires_grad=True)
    table[torch.from_numpy(ids)].backward(torch.from_numpy(dout))
    np.testing.assert_allclose(t.to_dense().numpy(), table.grad.numpy(),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("csr")
    params = H.init_jax_params(use_flash_attention=False, **MODEL)
    state = H.save_port_state(params, root / "tiny.npz")
    base = dict(dtype="f32", flash=False, lr=1e-3, model=MODEL)
    cases = [dict(base, name="dense"),
             dict(base, name="sparse", keys={"sparse_gradients": True}),
             dict(name="order", kind="sum_order", values=SUM_ORDER_VALUES)]
    out = {}
    for world in (2, 4):
        H.spawn_world(world, cases, state, root / f"w{world}")
        out[world] = {c["name"]: H.load_results(root / f"w{world}",
                                                c["name"], world)
                      for c in cases}
    return params, base, out


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_step_equals_dense_stage0_bitwise(worlds, world):
    _, _, out = worlds
    for (got, meta), (want, _) in zip(out[world]["sparse"],
                                      out[world]["dense"]):
        if world == 2:
            np.testing.assert_array_equal(got["losses"], want["losses"])
        else:
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-6)
        for key, w in want.items():
            if not key.startswith("param/"):
                continue
            if world == 2:
                np.testing.assert_array_equal(got[key], w, err_msg=key)
                continue
            a, b = got[key], w
            if key.endswith("attn.c_attn.bias"):
                # the key third's true gradient is 0: Adam scales the
                # rounding noise there to steps of lr (as in
                # tests/test_torch_config_keys.py), so it is left out
                C = b.shape[0] // 3
                a, b = np.delete(a, np.s_[C:2 * C]), \
                    np.delete(b, np.s_[C:2 * C])
            err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert err <= 1e-5, (key, err)
        dropped, fallbacks = meta["sparse"]
        assert fallbacks == 1 and dropped > 0     # the tied wte
        # wpe's exchange was the CSR all-gather: the counted gathers
        counts = meta["counts"]["all_gather"]
        assert counts["calls"] == 2               # its indices and values


@pytest.mark.parametrize("world", [2, 4])
def test_dense_sum_order_is_no_rule_of_a_row(worlds, world):
    """Every rank holds one value in every element of a leaf (1, 2^-24,
    2^-24, -1), whose sum depends on the association. The CSR exchange
    gives the rank-order sum everywhere. At world 2 the dense all-reduce
    gives it too (one sum of two values); at world 4 it gives the same
    addends more than one sum across the buffer, none of them the
    rank-order one."""
    _, _, out = worlds
    want = np.float32(0)
    for v in SUM_ORDER_VALUES[:world]:
        want = np.float32(want + np.float32(v))
    for res, _ in out[world]["order"]:
        assert (res["sparse"] == want).all()
        sums = np.unique(res["dense"])
        if world == 2:
            assert (res["dense"] == want).all()
        else:
            assert len(sums) > 1 and want not in sums, sums


def test_sparse_step_follows_jax(worlds):
    params, base, out = worlds
    case = dict(base, keys={"sparse_gradients": True})
    losses, _, _ = H.jax_run(params, case, 2)
    np.testing.assert_allclose(out[2]["sparse"][0][0]["losses"], losses,
                               rtol=1e-5)


def test_zero_stages_raise_as_jax(worlds):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
    params, base, _ = worlds
    case = dict(base, dtype="bf16", stage=1,
                keys={"sparse_gradients": True})
    engine, _ = H.jax_engine(params, case, 1)
    with pytest.raises(AssertionError) as want:
        engine.train_batch({"input_ids": H.jax_batches(case)[0]})
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16, **MODEL),
                       device="cpu")
    with pytest.raises(AssertionError) as got:
        initialize(model=model, config=H.jax_config(case), device="cpu")
    assert str(got.value) == str(want.value)
