"""GPT-2 ``scan_layers`` in the port (`deepspeed_tpu_torch/models/gpt2.py`:
``StackedBlocks``, the layout converters, and ``--scan-layers`` serving).

- The stacked model (one ``[L, ...]`` Parameter per block weight, under
  ``h``) gives the unrolled model's loss and gradients bit for bit after
  ``stack_gpt2_state_dict`` / ``unstack_gpt2_state_dict``, with remat
  off, "full" and "dots", at hidden dropout 0.1 (f32).
- Against JAX's scanned model (``scan_layers=True``) the loss agrees
  within rtol 1e-6 and the gradients within atol 1e-6 (the tolerance of
  ``tests/test_torch_gpt2_remat.py``) with remat off and "dots" (the
  JAX side under ``jax.checkpoint`` with that policy). JAX's own
  scanned remat "full" case is red at this flax
  (``tests/unit/test_gpt2_scan.py``, ``ROADMAP.md`` section 3), so the
  port's "full" is held to its unrolled model only.
- ``stack_gpt2_layer_params`` / ``unstack_gpt2_layer_params`` equal
  JAX's on the same tree, round trip bit for bit, and raise JAX's errors.
- ``--scan-layers`` serving: greedy streams (f32) of the stacked model
  equal the unrolled model's bit for bit, on the ring cache, the paged
  pool and the speculative draft/verify pair.
- Under ZeRO stages 2 and 3 at world 2 (gloo, bf16,
  ``tests/torch_zero_worker.py``) the stacked model's losses and fp32
  masters equal the unrolled model's bit for bit: a stacked weight is
  split as JAX splits the scanned leaf (its layout's largest dimension
  that divides the world), and stage 3 gathers the stack when ``h``
  runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import gpt2 as tg
from tests.torch_threads import one_thread  # noqa: F401


def _ids(seed=0, b=2, t=24):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int64))


def _pair(remat=False, policy="full", dropout=0.1, n_layer=3):
    cfg = tg.gpt2_tiny(dtype=torch.float32, dropout=dropout, remat=remat,
                       remat_policy=policy, use_flash_attention=True,
                       loss_chunk=8, n_layer=n_layer)
    gen = torch.Generator().manual_seed(0)
    unrolled = tg.GPT2LMHead(cfg, device="cpu", generator=gen)
    stacked = tg.GPT2LMHead(dataclasses.replace(cfg, scan_layers=True),
                            device="cpu")
    stacked.load_state_dict(tg.stack_gpt2_state_dict(unrolled.state_dict()))
    return unrolled, stacked


def _loss_and_grads(model, ids, seed):
    model.zero_grad()
    loss = model.loss_fn({"input_ids": ids}, seed)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_stacked_model_holds_one_param_per_block_weight():
    _, stacked = _pair()
    shapes = {n: tuple(p.shape) for n, p in stacked.named_parameters()}
    assert shapes["h.attn.c_attn.weight"] == (3, 192, 64)
    assert shapes["h.ln_1.weight"] == (3, 64)
    assert shapes["h.mlp.c_proj.bias"] == (3, 64)
    assert not any(n.startswith("h.0") for n in shapes)
    assert len(shapes) == 4 + 12


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")],
                         ids=["off", "full", "dots"])
def test_stacked_equals_unrolled_bitwise(remat, policy):
    unrolled, stacked = _pair(remat, policy)
    ids = _ids()
    want, want_g = _loss_and_grads(unrolled, ids, 7)
    got, got_g = _loss_and_grads(stacked, ids, 7)
    assert torch.equal(got, want)
    got_g = tg.unstack_gpt2_state_dict(got_g)
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        assert torch.equal(got_g[name], g), name


def test_stacked_backward_stacks_each_gradient_once(monkeypatch):
    """The loop takes each stack apart once (``unbind``), not by
    indexing it per layer, so no ``[L, ...]`` zero gradient is made per
    layer (``select_backward``)."""
    _, stacked = _pair(dropout=0.0)
    seen = []
    real = torch.Tensor.unbind

    def counting(self, dim=0):
        seen.append(tuple(self.shape))
        return real(self, dim)

    monkeypatch.setattr(torch.Tensor, "unbind", counting)
    stacked.loss_fn({"input_ids": _ids()}, None).backward()
    assert len(seen) == 12      # the 12 block weights, once each


@pytest.mark.parametrize("policy", [None, "dots"], ids=["off", "dots"])
def test_stacked_matches_jax_scanned_model(policy):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import gpt2 as jg

    jmodel = jg.GPT2LMHead(jg.gpt2_tiny(
        dtype=jnp.float32, loss_chunk=8, use_flash_attention=True,
        scan_layers=True, n_layer=3))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    assert "h" in params
    ids = _ids(4)
    loss_fn = jg.make_gpt2_loss_fn(jmodel)
    batch = {"input_ids": jnp.asarray(ids.numpy().astype(np.int32))}

    def loss(p):
        return loss_fn(p, batch, None)

    if policy == "dots":
        loss = jax.checkpoint(loss,
                              policy=jax.checkpoint_policies.checkpoint_dots)
    want, want_g = jax.jit(jax.value_and_grad(loss))(params)
    numpy = jax.tree_util.tree_map(np.asarray, params)
    model = tg.GPT2LMHead(tg.gpt2_tiny(
        dtype=torch.float32, loss_chunk=8, use_flash_attention=True,
        scan_layers=True, n_layer=3, remat=policy is not None,
        remat_policy=policy or "full"), device="cpu")
    model.load_state_dict(tg.convert_gpt2_params(numpy, scan_layers=True))
    got, got_g = _loss_and_grads(model, ids, None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want_g = tg.convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, want_g), scan_layers=True)
    for name, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   atol=1e-6, err_msg=name)


def _jax_unrolled_tree():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import gpt2 as jg
    jmodel = jg.GPT2LMHead(jg.gpt2_tiny(dtype=jnp.float32, n_layer=3))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    return jg, params


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if hasattr(a[k], "items"):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


def test_layer_stacking_equals_jax_and_round_trips():
    import jax
    jg, params = _jax_unrolled_tree()
    numpy = jax.tree_util.tree_map(np.asarray, params)
    stacked = tg.stack_gpt2_layer_params(numpy)
    _assert_tree_equal(stacked, jax.tree_util.tree_map(
        np.asarray, jg.stack_gpt2_layer_params(params)))
    _assert_tree_equal(tg.unstack_gpt2_layer_params(stacked), numpy)
    # the converter takes either layout into either state dict
    sd = tg.convert_gpt2_params(numpy)
    sd_stacked = tg.convert_gpt2_params(stacked, scan_layers=True)
    for name, t in tg.stack_gpt2_state_dict(sd).items():
        assert torch.equal(sd_stacked[name], t), name
    back = tg.unstack_gpt2_state_dict(sd_stacked)
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name


@pytest.mark.parametrize("case", ["gap", "none", "unstack"])
def test_converter_errors_match_jax(case):
    import jax
    jg, params = _jax_unrolled_tree()
    numpy = jax.tree_util.tree_map(np.asarray, params)
    if case == "gap":
        tree = dict(numpy)
        tree["h_7"] = tree.pop("h_1")
        fns = (jg.stack_gpt2_layer_params, tg.stack_gpt2_layer_params)
    elif case == "none":
        tree = {k: v for k, v in numpy.items() if not k.startswith("h_")}
        fns = (jg.stack_gpt2_layer_params, tg.stack_gpt2_layer_params)
    else:
        tree = numpy
        fns = (jg.unstack_gpt2_layer_params, tg.unstack_gpt2_layer_params)
    with pytest.raises(ValueError) as want:
        fns[0](tree)
    with pytest.raises(ValueError) as got:
        fns[1](tree)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# --scan-layers serving
# ---------------------------------------------------------------------------

SERVE = {
    "ring": {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
             "attention_impl": "flash", "attention_block_k": 8},
    "paged": {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
              "attention_impl": "flash", "kv_layout": "paged",
              "host_park_threshold": 0.9},
    "speculative": {"max_batch": 2, "seq_buckets": (16, 32),
                    "prefill_chunk": 4, "attention_impl": "flash",
                    "kv_layout": "paged",
                    "speculative": {"enabled": True, "k": 3,
                                    "draft_layers": 1}},
}


def _streams(scan_layers, config):
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.inference.scheduler import (
        ContinuousBatchingScheduler, Request)
    from deepspeed_tpu_torch.inference.serve import seeded_tiny_model
    engine = InferenceEngine(seeded_tiny_model(0, "cpu", scan_layers),
                             config=config, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=f"r{i}", prompt=rng.integers(
        0, 256, int(rng.integers(3, 12))).tolist(), max_new_tokens=6,
        arrival_step=i) for i in range(5)]
    done = ContinuousBatchingScheduler(engine).run(reqs)
    return engine, {c.rid: list(c.tokens) for c in done}


@pytest.mark.parametrize("layout", sorted(SERVE))
def test_scan_layers_streams_equal_unrolled(layout):
    _, want = _streams(False, SERVE[layout])
    engine, got = _streams(True, SERVE[layout])
    assert engine.spec.stacked and set(engine.cache) == {"h"}
    assert engine.cache["h"]["k"].shape[0] == engine.spec.n_layer
    assert got == want and len(got) == 5


# ---------------------------------------------------------------------------
# ZeRO at world 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zero_world(tmp_path_factory):
    from tests import torch_zero_harness as H
    root = tmp_path_factory.mktemp("scan_zero")
    params = H.init_jax_params(use_flash_attention=False)
    state = H.save_port_state(params, root / "tiny.npz")
    cases = [dict(dtype="bf16", flash=False, stage=stage, steps=2,
                  name=f"{'scan' if scan else 'unrolled'}{stage}",
                  model={"scan_layers": scan})
             for stage in (2, 3) for scan in (False, True)]
    H.spawn_world(2, cases, state, root / "out")
    return {c["name"]: H.load_results(root / "out", c["name"], 2)
            for c in cases}


@pytest.mark.parametrize("stage", [2, 3])
def test_stacked_equals_unrolled_under_zero(zero_world, stage):
    for (got, meta), (want, _) in zip(zero_world[f"scan{stage}"],
                                      zero_world[f"unrolled{stage}"]):
        np.testing.assert_array_equal(got["losses"], want["losses"])
        stacked = tg.unstack_gpt2_state_dict(
            {k[len("param/"):]: torch.from_numpy(v)
             for k, v in got.items() if k.startswith("param/")})
        for key, w in want.items():
            if key.startswith("param/"):
                np.testing.assert_array_equal(
                    stacked[key[len("param/"):]].numpy(), w, err_msg=key)
        if stage == 3:
            assert meta["plan"]["gather_leaves"] == 4 + 12
