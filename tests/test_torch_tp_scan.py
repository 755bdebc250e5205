"""GPT-2 at a model axis with ``scan_layers`` and with ``loss_chunk``
(``models/gpt2.py``: ``StackedBlocks`` over the TP block, and
``vocab_parallel_chunked_cross_entropy``) through ``initialize()`` in
gloo worlds of 4 and 2 processes, held to the JAX engine at the same
mesh (``param_specs=gpt2_partition_specs(params)`` of the stacked tree,
which prepends a replicated layer axis to each block leaf's spec) and to
the port's unrolled model.

GPT-2 tiny (vocab 256, 2 layers, 4 heads, n_embd 64), f32, flash
attention (K1-K3's plain versions), dropout 0, Adam lr 1e-3 and eps
1e-3, 3 steps of 8 x 16 tokens; ``loss_chunk`` 8 (two chunks a row).
The tolerances are ``tests/test_torch_tp_train.py``'s: losses rtol
1e-5, gradients atol 1e-5, masters after 3 steps atol 2e-5. The JAX
references run at ``{"data": 2, "model": 2}`` (GSPMD computes the
unsharded function at any mesh; the model-4 runs are held to them too).

At model 2 the stacked model (the unrolled TP model restacked by
``with_layout``, which keeps each leaf's split) has the unrolled model's
losses, gradients and masters bit for bit (the same block arithmetic,
unbound from the stack). A stacked checkpoint saved at model 2 serves
unrolled at model 1 with the greedy stream the stacked model serves at
model 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_partition_specs
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn as jax_loss_fn
from deepspeed_tpu.models.gpt2 import stack_gpt2_layer_params
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    chunked_cross_entropy_with_head,
    convert_gpt2_params,
    gpt2_partition_specs as port_specs,
    gpt2_tiny,
    shard_gpt2_state_dict,
    vocab_parallel_chunked_cross_entropy,
)
from deepspeed_tpu_torch.parallel.mesh import AxisGroup
from deepspeed_tpu_torch.parallel.tensor_parallel import Shard
from tests import torch_zero_harness as H
from tests.torch_f6_cases import serve_checkpoint
from tests.torch_threads import one_thread  # noqa: F401
from tests.torch_tp_cases import global_batches

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
LOSS_RTOL, GRAD_ATOL, MASTER_ATOL = 1e-5, 1e-5, 2e-5
STEPS, BATCH, CHUNK = 3, 8, 8
D2M2, M4 = {"data": 2, "model": 2}, {"model": 4}
VARIANTS = {"scan": {"scan_layers": True}, "chunk": {"loss_chunk": CHUNK}}


def case(name, mesh, variant, **kw):
    return dict({"name": name, "kind": "gpt2_scan_train", "mesh": mesh,
                 "batch": BATCH, "steps": STEPS, "lr": 1e-3, "eps": 1e-3,
                 "grads": True, "model": dict(variant)}, **kw)


def jax_ref(params, variant):
    """The JAX engine at {"data": 2, "model": 2} on the variant's tree
    (stacked under ``scan_layers``): losses, whole masters after the
    steps and the first batch's gradients, as unrolled port leaves."""
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, **variant))
    if variant.get("scan_layers"):
        params = stack_gpt2_layer_params(params)
    cfg = {"train_batch_size": BATCH, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                    "eps": 1e-3}}}
    xs = [{"input_ids": jnp.asarray(x.astype(np.int32))}
          for x in global_batches({"batch": BATCH, "steps": STEPS})]
    loss_fn = jax_loss_fn(model)
    grads = jax.jit(jax.grad(loss_fn))(params, xs[0])
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, loss_fn=loss_fn, params=params,
        param_specs=gpt2_partition_specs(params),
        mesh=build_mesh(D2M2, devices=jax.devices()[:4]))
    losses = [float(engine.train_batch(x)) for x in xs]

    def port(tree):
        return convert_gpt2_params(jax.tree_util.tree_map(np.asarray, tree))

    return losses, port(engine.params), port(grads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_scan")
    params = H.init_jax_params()
    state = H.save_port_state(params, root / "state.npz")
    w4 = [case(f"{m}_{v}", mesh, VARIANTS[v])
          for m, mesh in (("d2m2", D2M2), ("m4", M4)) for v in VARIANTS]
    both = {"scan_layers": True, "loss_chunk": CHUNK}
    w2 = [case("m2_unrolled", {"model": 2}, {}),
          case("m2_scan", {"model": 2}, VARIANTS["scan"], via_layout=True),
          case("m2_both", {"model": 2}, both, grads=False,
               save=str(root / "ckpt"), serve=True)]
    procs = H.start_world(4, w4, state, root / "w4", worker=WORKER) + \
        H.start_world(2, w2, state, root / "w2", worker=WORKER)
    try:
        ref = {v: jax_ref(params, kw) for v, kw in VARIANTS.items()}
    finally:
        H.wait_world(procs[:4])
        H.wait_world(procs[4:])
    return root, ref


def results(root, world, name):
    return H.load_results(root / {4: "w4", 2: "w2"}[world], name, world)


@pytest.mark.parametrize("mesh", ["d2m2", "m4"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_losses_gradients_and_masters_equal_jax_engine(run, variant, mesh):
    root, ref = run
    want, after, grads = ref[variant]
    for arrays, meta in results(root, 4, f"{mesh}_{variant}"):
        assert meta["mp_world_size"] == (2 if mesh == "d2m2" else 4)
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        for leaf, v in grads.items():
            np.testing.assert_allclose(arrays[f"grad/{leaf}"], v.numpy(),
                                       rtol=0, atol=GRAD_ATOL, err_msg=leaf)
        for leaf, v in after.items():
            np.testing.assert_allclose(arrays[f"master/{leaf}"], v.numpy(),
                                       rtol=0, atol=MASTER_ATOL,
                                       err_msg=leaf)


def test_stacked_leaves_split_behind_the_layer_axis(run):
    root, _ = run
    shapes = results(root, 4, "m4_scan")[0][1]["shapes"]
    assert shapes["h.attn.c_attn.weight"] == [2, 48, 64]
    assert shapes["h.attn.c_proj.weight"] == [2, 64, 16]
    assert shapes["h.mlp.c_fc.bias"] == [2, 64]
    assert shapes["h.ln_1.weight"] == [2, 64]
    specs = port_specs({n: None for n in shapes}, 256)
    assert specs["h.attn.c_attn.weight"] == Shard(1, 3)
    assert specs["h.attn.c_proj.weight"] == Shard(2)
    assert specs["h.mlp.c_fc.bias"] == Shard(1)
    assert specs["h.ln_1.weight"] is None
    assert port_specs({"h.0.attn.c_attn.weight": None}, 256)[
        "h.0.attn.c_attn.weight"] == Shard(0, 3)


def test_stacked_equals_unrolled_at_model2_bitwise(run):
    root, _ = run
    for (a, ma), (b, mb) in zip(results(root, 2, "m2_scan"),
                                results(root, 2, "m2_unrolled")):
        assert ma["losses"] == mb["losses"]
        assert set(a) == set(b)
        for key, v in b.items():
            assert np.array_equal(a[key], v), key


@pytest.mark.parametrize("mesh", ["d2m2", "m4"])
def test_chunked_loss_within_tolerance_of_whole_vocab_loss(run, mesh):
    root, _ = run
    for _, meta in results(root, 4, f"{mesh}_chunk"):
        np.testing.assert_allclose(meta["chunked_loss"], meta["whole_loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("size", [None, 1])
def test_vocab_parallel_chunked_loss_is_the_chunked_loss_at_one_rank(size):
    """With no model axis, or one of a single rank, the vocab-parallel
    chunked loss is ``chunked_cross_entropy_with_head``: its value and
    its gradients bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 13, 16, generator=g)
    head = torch.randn(16, 40, generator=g)
    bias = torch.randn(40, generator=g)
    labels = torch.randint(0, 40, (2, 13), generator=g)
    labels[0, 3] = -100
    tp = None if size is None else AxisGroup("model")
    outs = []
    for fn in (chunked_cross_entropy_with_head,
               lambda *a: vocab_parallel_chunked_cross_entropy(*a, tp, 40)):
        xs = [t.clone().requires_grad_(True) for t in (x, head, bias)]
        total, count = fn(xs[0], xs[1], xs[2], labels, 5)
        (total / count).backward()
        outs.append([total.detach(), count] + [t.grad for t in xs])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_stacked_checkpoint_at_model2_serves_unrolled_at_model1(run):
    """``m2_both`` (stacked, chunked loss) saved whole at model 2 and
    served stacked at model 2 from its checkpoint; served unrolled at
    model 1 from the same checkpoint, the greedy streams are equal."""
    root, _ = run
    want = serve_checkpoint(str(root / "ckpt"), None, scan_layers=False)
    for _, meta in results(root, 2, "m2_both"):
        assert meta["topology"]["mesh_shape"] == {"data": 1, "model": 2}
        assert meta["tokens"] == want


def test_converter_shards_the_stacked_layout(run):
    """``convert_gpt2_params(scan_layers=True, model_size=2)`` is the
    stacked whole state cut by the stacked specs: rank r's layer l is the
    unrolled shard's layer l."""
    params = jax.tree_util.tree_map(np.asarray, H.init_jax_params())
    whole = convert_gpt2_params(params)
    for r in range(2):
        stacked = convert_gpt2_params(params, scan_layers=True,
                                      model_rank=r, model_size=2)
        flat = shard_gpt2_state_dict(whole, r, 2, 256)
        for name, t in stacked.items():
            if name.startswith("h."):
                for i in range(t.shape[0]):
                    assert torch.equal(t[i], flat[f"h.{i}.{name[2:]}"])
            else:
                assert torch.equal(t, flat[name])
    model = GPT2LMHead(gpt2_tiny(scan_layers=True), device="meta")
    assert set(stacked) == set(model.state_dict())
