"""MoE and expert parallelism (``moe/layer.py``, ``models/gpt2_moe.py``)
held to the JAX package.

- Routing: the capacity math; ``top_k_gating``'s dispatch equal to
  JAX's exactly and its combine and aux within 1e-6 (top 1 and top 2,
  with and without overflow, first-maximum ties); the capacity drop
  keeps the first tokens in sequence order; top 1 routes task gradient
  into the gate; minimizing the aux balances the experts.
- The MoE layer against JAX's ``MoE`` at JAX's tolerance (rtol 2e-4,
  atol 2e-5), output and gradients, at the training and the eval
  capacity.
- Expert parallelism (gloo, world 4): expert 2 (x data 2) and expert 4
  equal expert 1 in output, aux, routing counts and every gradient,
  ``gate`` included, within 1e-5 (the psums reassociate); without the
  aux's 1/ep pre-scaling the gate's gradient would be ep times its aux
  part.
- GPT-2 MoE tiny through ``initialize()`` at ``{"expert": 2, "data":
  2}`` matches JAX's engine at the same mesh for 3 f32 steps (losses
  rtol 1e-5; JAX's weights); under bf16, ZeRO 1 and 2 equal ZeRO 0;
  its checkpoint holds whole expert banks and resumes bit for bit.
- A dense GPT-2 at ``{"seq": 2, "data": 2}`` and ``{"expert": 2,
  "data": 2}`` runs replicated over the axis with rows over ``data``
  only: its losses and masters equal the ``{"data": 2}`` run's bit for
  bit (world 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.gpt2_moe import GPT2MoELMHead as JaxGPT2MoE
from deepspeed_tpu.models.gpt2_moe import (
    gpt2_moe_partition_specs,
    init_gpt2_moe_params,
    make_gpt2_moe_loss_fn,
)
from deepspeed_tpu.models.gpt2_moe import gpt2_moe_tiny as jax_moe_tiny
from deepspeed_tpu.moe.layer import MoE as JaxMoE
from deepspeed_tpu.moe.layer import MoEConfig as JaxMoEConfig
from deepspeed_tpu.moe.layer import compute_capacity as jax_capacity
from deepspeed_tpu.moe.layer import top_k_gating as jax_gating
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.models.gpt2_moe import convert_gpt2_moe_params
from deepspeed_tpu_torch.moe.layer import (
    MoE,
    MoEConfig,
    compute_capacity,
    top_k_gating,
)
from tests import torch_zero_harness as H

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
M, HID, E = 16, 32, 4
LAYER = dict(num_experts=E, top_k=2, capacity_factor=1.25)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_capacity_math():
    cfg = MoEConfig(num_experts=4, top_k=2, capacity_factor=1.0,
                    min_capacity=1)
    assert compute_capacity(16, cfg, deterministic=False) == 8
    cfg2 = MoEConfig(num_experts=8, top_k=1, capacity_factor=1.0,
                     min_capacity=4)
    assert compute_capacity(16, cfg2, deterministic=False) == 4
    cfg3 = MoEConfig(num_experts=1, top_k=2, capacity_factor=4.0)
    assert compute_capacity(8, cfg3, deterministic=False) == 8
    for S in (8, 64, 1024):
        for k in (1, 2):
            for det in (True, False):
                kw = dict(num_experts=8, top_k=k, capacity_factor=1.25)
                assert compute_capacity(S, MoEConfig(**kw), det) == \
                    jax_capacity(S, JaxMoEConfig(**kw), det)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cap", [3, 16])
def test_gating_equals_jax(k, cap):
    rng = np.random.default_rng(k * 10 + cap)
    logits = rng.standard_normal((2, 16, E)).astype(np.float32)
    logits[0, :4] = 0.5            # ties: the first maximum wins
    want = jax_gating(jnp.asarray(logits), k, cap)
    got = top_k_gating(torch.from_numpy(logits), k, cap)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


def test_capacity_drops_overflow_tokens():
    logits = torch.full((1, 8, 4), -10.0)
    logits[:, :, 0] = 10.0
    dispatch, _, _ = top_k_gating(logits, top_k=1, capacity=3)
    assert float(dispatch[0, :, 0].sum()) == 3.0
    assert float(dispatch[0, :3, 0].sum()) == 3.0


def test_top1_router_receives_task_gradient():
    cfg = MoEConfig(num_experts=4, top_k=1, capacity_factor=4.0,
                    min_capacity=16, aux_loss_weight=0.0)
    g = torch.Generator()
    g.manual_seed(0)
    layer = MoE(cfg, 8, 16)
    layer.reset_parameters(g)
    x = torch.randn(2, 8, 16, generator=g)
    y, _ = layer(x)
    (y ** 2).sum().backward()
    assert float(layer.gate.grad.abs().max()) > 0


def test_aux_loss_balances_experts():
    g = torch.Generator()
    g.manual_seed(0)
    x = torch.randn(4, 32, 16, generator=g)
    wg = (torch.randn(16, 8, generator=g) * 2.0).requires_grad_(True)

    def aux_of(w):
        return top_k_gating(x @ w, top_k=1, capacity=32)[2]

    a0 = float(aux_of(wg).detach())
    for _ in range(50):
        gr, = torch.autograd.grad(aux_of(wg), wg)
        with torch.no_grad():
            wg -= 0.5 * gr
    a1 = float(aux_of(wg).detach())
    assert a1 < a0 and a1 < 1.15


def layer_inputs():
    """JAX's MoE layer params, an input and a cotangent."""
    layer = JaxMoE(JaxMoEConfig(**LAYER), hidden_dim=HID)
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 16, M))
    params = layer.init(jax.random.PRNGKey(1), x)["params"]
    w = np.random.default_rng(3).standard_normal((2, 16, M)).astype(
        np.float32)
    return layer, params, np.asarray(x), w


def port_layer(params, group=None):
    layer = MoE(MoEConfig(**LAYER), HID, M, group=group)
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(layer._local(t(params[n])))
    return layer


def run_port_layer(layer, x, w, deterministic):
    x = t(x).requires_grad_(True)
    y, aux = layer(x, deterministic=deterministic)
    ((y * t(w)).sum() + aux).backward()
    return y.detach(), aux.detach(), x.grad, \
        {n: p.grad for n, p in layer.named_parameters()}


@pytest.mark.parametrize("deterministic", [False, True])
def test_moe_layer_matches_jax(deterministic):
    layer, params, x, w = layer_inputs()

    def loss(p, xx):
        y, aux = layer.apply({"params": p}, xx, deterministic=deterministic)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    py, paux, pdx, pgrads = run_port_layer(port_layer(params), x, w,
                                           deterministic)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(py.numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(float(paux), float(aux), **tol)
    np.testing.assert_allclose(pdx.numpy(), np.asarray(gx), **tol)
    for n, g in pgrads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(gp[n]), **tol,
                                   err_msg=n)


def gpt2_moe_jax(world_batches):
    """JAX's engine at expert 2 x data 2 over the batches; its initial
    weights in the port's layout."""
    model = JaxGPT2MoE(jax_moe_tiny(dtype=jnp.float32))
    params = init_gpt2_moe_params(model, jax.random.PRNGKey(0))
    state = convert_gpt2_moe_params(jax.tree_util.tree_map(np.asarray,
                                                           params))
    mesh = build_mesh({"expert": 2, "data": 2}, devices=jax.devices()[:4])
    engine, _, _, _ = deepspeed_tpu.initialize(
        config={"train_batch_size": 8, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        loss_fn=make_gpt2_moe_loss_fn(model), params=params,
        param_specs=gpt2_moe_partition_specs(params), mesh=mesh)
    losses = [float(engine.train_batch({"input_ids": b}))
              for b in world_batches]
    return losses, state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    layer, params, x, w = layer_inputs()
    np.savez(root / "layer.npz", x=x, w=w,
             **{f"moe.{n}": np.asarray(v) for n, v in params.items()})
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 255, (8, 32)).astype(np.int64)
               for _ in range(3)]
    np.savez(root / "batches.npz", **{f"b{i}": b for i, b in
                                      enumerate(batches)})
    losses, state = gpt2_moe_jax(batches)
    np.savez(root / "moe.npz", **{k: v.numpy() for k, v in state.items()})
    g = torch.Generator()
    g.manual_seed(0)
    dense = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu",
                       generator=g)
    np.savez(root / "dense.npz", **{k: v.detach().numpy()
                                    for k, v in dense.state_dict().items()})
    common = dict(batches=str(root / "batches.npz"), batch=8)
    layer_case = dict(kind="moe_layer", inputs=str(root / "layer.npz"),
                      moe=LAYER, hidden=HID, d_model=M)
    w4 = [dict(name="e4", mesh={"expert": 4}, **layer_case),
          dict(name="e2", mesh={"expert": 2, "data": 2}, **layer_case),
          dict(name="gpt2_moe", kind="gpt2_moe_train",
               mesh={"expert": 2, "data": 2}, state=str(root / "moe.npz"),
               save=str(root / "ckpt"), **common),
          dict(name="bf16_z0", kind="gpt2_moe_train", zero=0,
               dtype="bf16", mesh={"expert": 2, "data": 2},
               state=str(root / "moe.npz"), **common),
          dict(name="bf16_z1", kind="gpt2_moe_train", zero=1,
               dtype="bf16", mesh={"expert": 2, "data": 2},
               state=str(root / "moe.npz"), **common),
          dict(name="bf16_z2", kind="gpt2_moe_train", zero=2,
               dtype="bf16", mesh={"expert": 2, "data": 2},
               state=str(root / "moe.npz"), **common)]
    w4 += [dict(name=f"dense_{a}", kind="gpt2_moe_train", dense=True,
                mesh={a: 2, "data": 2}, state=str(root / "dense.npz"),
                **common) for a in ("seq", "expert")]
    w2 = [dict(name="dense_data", kind="gpt2_moe_train", dense=True,
               mesh={"data": 2}, state=str(root / "dense.npz"), **common)]
    H.spawn_world(4, w4, root / "moe.npz", root / "w4", worker=WORKER)
    H.spawn_world(2, w2, root / "moe.npz", root / "w2", worker=WORKER)
    ref = {d: run_port_layer(port_layer(params), x, w, d)
           for d in (False,)}
    return root, {"jax_losses": losses, "expert1": ref[False]}


def res(root, world, name):
    return H.load_results(root / f"w{world}", name, world)


@pytest.mark.parametrize("name,ep", [("e2", 2), ("e4", 4)])
def test_expert_parallel_equals_expert_1(run, name, ep):
    root, out = run
    y, aux, dx, grads = out["expert1"]
    for arrays, meta in res(root, 4, name):
        assert meta["e_local"] == E // ep
        np.testing.assert_allclose(arrays["y"], y.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(arrays["aux"], aux.numpy(), rtol=1e-6)
        np.testing.assert_allclose(arrays["dx"], dx.numpy(), rtol=1e-5,
                                   atol=1e-6)
        for n, g in grads.items():
            np.testing.assert_allclose(arrays[f"grad/{n}"], g.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
        assert arrays["kept"].sum() < arrays["routed"].sum()  # drops
        np.testing.assert_array_equal(arrays["routed"],
                                      arrays["routed"].round())


def test_gpt2_moe_through_initialize_matches_jax_engine(run):
    root, out = run
    rows = res(root, 4, "gpt2_moe")
    for _, meta in rows:
        assert meta["losses"] == rows[0][1]["losses"]
        assert meta["dp_world_size"] == 2
        np.testing.assert_allclose(meta["losses"], out["jax_losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("stage", [1, 2])
def test_gpt2_moe_zero_partitions_expert_leaves(run, stage):
    """bf16 over f32 masters: ZeRO 1 and 2 over the data group (each
    rank's expert shards partitioned) equal ZeRO 0, losses and whole
    masters within 1e-6."""
    root, _ = run
    z0, zs = res(root, 4, "bf16_z0"), res(root, 4, f"bf16_z{stage}")
    for (a, ma), (b, mb) in zip(z0, zs):
        np.testing.assert_allclose(mb["losses"], ma["losses"], rtol=1e-6)
        assert np.isfinite(ma["losses"]).all()
        for k, v in a.items():
            np.testing.assert_allclose(b[k], v, rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def test_gpt2_moe_checkpoint_holds_whole_leaves_and_resumes(run):
    """The checkpoint holds each expert bank whole (``[E, ...]``) and
    records the expert axis; a fresh engine at the same mesh loaded from
    it takes the next step bit for bit."""
    root, _ = run
    for arrays, meta in res(root, 4, "gpt2_moe"):
        assert arrays["master/h.1.moe.expert_w1"].shape == (E, 64, 256)
        assert meta["topology"]["mesh_shape"] == {
            "data": 2, "model": 1, "expert": 2}
        a, b = meta["resumed"]
        assert a == b


@pytest.mark.parametrize("axis", ["seq", "expert"])
def test_dense_model_replicated_over_the_axis(run, axis):
    root, _ = run
    (want, want_meta), = res(root, 2, "dense_data")[:1]
    for arrays, meta in res(root, 4, f"dense_{axis}"):
        assert meta["dp_world_size"] == 2
        assert meta["losses"] == want_meta["losses"]
        for k, v in want.items():
            assert np.array_equal(arrays[k], v), k
