"""GPT-2 tensor-parallel training through ``initialize()`` (Megatron's
layout, ``models/gpt2.py``) in gloo worlds of 4 processes, held to the
JAX engine at the same mesh (``deepspeed_tpu.initialize(...,
param_specs=gpt2_partition_specs(params), mesh=build_mesh(mesh))``, the
JAX test ``test_gpt2_tp_training_matches_dp_through_engine``) and to the
port at model 1.

Meshes ``{"data": 2, "model": 2}`` and ``{"model": 4}``; GPT-2 tiny
(vocab 256, 2 layers, 4 heads, n_embd 64), f32, flash attention (K1-K3's
plain versions), dropout 0, Adam lr 1e-3 and eps 1e-3, 3 steps of 8 x
16 tokens. The tolerances are ``tests/test_torch_gpt2_train.py``'s f32
ones: losses rtol 1e-5, gradients atol 1e-5 (a split sum over the vocab
and the hidden dim reassociates), masters after 3 steps atol 2e-5. Adam's
eps is 1e-3, as in ``tests/test_torch_pipe.py``: the key bias's true
gradient is 0 (softmax ignores a shift of every score), and at eps 1e-8
Adam moves it by lr times the sign of its rounding noise.

With dropout 0.1 at ``{"model": 2}`` every attention call of a rank
draws the model-1 run's multipliers at its heads, bit for bit (the
heads' global coordinates), and the hidden masks are the model-1 run's
too (both seeded by data rank 0), so the loss is the model-1 loss.

A vocab of 250 (not a multiple of 4) pads ``wte`` to 252 rows; the run
equals the model-1 run's, and the checkpoint, saved whole, holds 250
rows and resumes at model 4 bit for bit.
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
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)
from deepspeed_tpu_torch.ops.flash_attention import _dropout_multiplier_full
from tests import torch_zero_harness as H
from tests.torch_tp_cases import global_batches

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
LOSS_RTOL, GRAD_ATOL, MASTER_ATOL = 1e-5, 1e-5, 2e-5
ADAM_EPS = 1e-3
STEPS, BATCH = 3, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This process's torch work on one intra-op thread (the tiny shapes
    gain nothing from more, and the gloo workers and the other test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case(name, mesh, **kw):
    return dict({"name": name, "kind": "gpt2_train", "mesh": mesh,
                 "batch": BATCH, "steps": STEPS, "lr": 1e-3,
                 "eps": ADAM_EPS, "grads": True}, **kw)


def jax_params(vocab=256):
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, vocab_size=vocab))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two spawns: world 4 (every model-4 and {data 2, model 2} case, the
    padded vocab among them) and world 2 (dropout, remat)."""
    root = tmp_path_factory.mktemp("tp_train")
    params = jax_params()
    state = H.save_port_state(params, root / "state.npz")
    pad = H.save_port_state(jax_params(250), root / "pad.npz")
    bf16 = dict(dtype="bf16", grads=False, flash=False, accum=2, steps=2)
    cases = [case("d2m2", {"data": 2, "model": 2}),
             case("m4", {"model": 4}),
             case("m4_accum", {"model": 4}, accum=2),
             case("pad", {"model": 4}, grads=False,
                  model={"vocab_size": 250}, save=str(root / "ckpt"),
                  load=True, state=pad)] + \
        [case(f"bf16_s{z}", {"data": 2, "model": 2}, zero={"stage": z},
              **bf16) for z in (0, 1, 2, 3)] + \
        [case("bf16_off", {"data": 2, "model": 2},
              zero={"stage": 2, "cpu_offload": True}, **bf16),
         case("lamb", {"data": 2, "model": 2}, opt="Lamb", grads=False),
         case("bf16_lamb_s2", {"data": 2, "model": 2}, opt="Lamb",
              zero={"stage": 2}, **bf16),
         case("bf16_lamb_s0", {"data": 2, "model": 2}, opt="Lamb",
              zero={"stage": 0}, **bf16)]
    H.spawn_world(4, cases, state, root / "w4", worker=WORKER)
    remat = {"remat": True, "remat_policy": "full"}
    H.spawn_world(2, [case("drop", {"model": 2}, grads=False,
                           model={"dropout": 0.1}, dropout=True, steps=1),
                      case("remat", {"model": 2}, model=remat),
                      case("remat_part", {"model": 2}, model=remat,
                           partition=True)],
                  state, root / "w2", worker=WORKER)
    return root, params


def results(root, world, name):
    return H.load_results(root / {4: "w4", 2: "w2"}[world], name, world)


def jax_run(params, mesh, accum=1):
    model = JaxGPT2(jax_tiny(dtype=jnp.float32))
    devices = jax.devices()[:int(np.prod(list(mesh.values())))]
    cfg = {"train_batch_size": BATCH, "gradient_accumulation_steps": accum,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-3, "eps": ADAM_EPS}}}
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, loss_fn=jax_loss_fn(model), params=params,
        param_specs=gpt2_partition_specs(params),
        mesh=build_mesh(mesh, devices=devices))
    xs = global_batches({"batch": BATCH, "steps": STEPS})
    losses = [float(engine.train_batch({"input_ids": x.astype(np.int32)}))
              for x in xs]
    after = convert_gpt2_params(jax.tree_util.tree_map(np.asarray,
                                                       engine.params))
    return losses, after


def port_model1(state_path, accum=1, steps=STEPS, opt="Adam", **model_kw):
    sd = {k: torch.from_numpy(v) for k, v in np.load(state_path).items()}
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32,
                                 use_flash_attention=True, **model_kw),
                       device="cpu")
    model.load_state_dict(sd)
    engine, _, _, _ = initialize(model=model, device="cpu", config={
        "train_batch_size": BATCH, "gradient_accumulation_steps": accum,
        "steps_per_print": 10 ** 9,
        "optimizer": {"type": opt,
                      "params": {"lr": 1e-3, "eps": ADAM_EPS}}})
    xs = global_batches({"batch": BATCH, "steps": steps},
                        model_kw.get("vocab_size", 256))
    return [float(engine.train_batch({"input_ids": torch.from_numpy(x)}))
            for x in xs], engine


@pytest.mark.parametrize("name,mesh", [
    ("d2m2", {"data": 2, "model": 2}), ("m4", {"model": 4})])
def test_losses_and_masters_equal_jax_engine(run, name, mesh):
    root, params = run
    want, after = jax_run(params, mesh)
    for arrays, meta in results(root, 4, name):
        assert meta["mp_world_size"] == mesh["model"]
        assert meta["dp_world_size"] == mesh.get("data", 1)
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        for leaf, ref in after.items():
            np.testing.assert_allclose(arrays[f"master/{leaf}"],
                                       ref.numpy(), rtol=0,
                                       atol=MASTER_ATOL, err_msg=leaf)


@pytest.fixture(scope="module")
def jax_grads(run):
    _, params = run
    x = global_batches({"batch": BATCH, "steps": 1})[0].astype(np.int32)
    model = JaxGPT2(jax_tiny(dtype=jnp.float32))
    grads = jax.jit(jax.grad(lambda p: jax_loss_fn(model)(
        p, {"input_ids": jnp.asarray(x)})))(params)
    return convert_gpt2_params(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("name", ["d2m2", "m4"])
def test_first_gradients_equal_jax(run, jax_grads, name):
    root, _ = run
    want = jax_grads
    for arrays, _ in results(root, 4, name):
        for leaf, ref in want.items():
            np.testing.assert_allclose(arrays[f"grad/{leaf}"], ref.numpy(),
                                       rtol=0, atol=GRAD_ATOL,
                                       err_msg=leaf)


def test_model4_with_accumulation_equals_the_port_at_model1(run):
    root, _ = run
    for name, accum in (("m4", 1), ("m4_accum", 2)):
        want, _ = port_model1(root / "state.npz", accum=accum)
        for _, meta in results(root, 4, name):
            np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)


def test_norm_counts_each_leaf_once(run):
    """The global norm at model 4 is the model-1 run's: split leaves
    summed over the group, replicated ones counted once."""
    root, _ = run
    _, engine = port_model1(root / "state.npz")
    want = float(engine._last_metrics["grad_norm"])
    for _, meta in results(root, 4, "m4"):
        np.testing.assert_allclose(meta["grad_norm"], want, rtol=1e-5)


def test_collectives_of_a_step(run):
    """At {data 2, model 2} a step all-reduces the activations over the
    model group (the embedding, and two ``g`` and two ``f`` a layer) and
    the gradients over the data group; nothing else."""
    root, _ = run
    for _, meta in results(root, 4, "d2m2"):
        counts = meta["counts"]
        assert set(counts) <= {"all_reduce", "all_gather"}
        assert counts["all_reduce"]["calls"] > 0


def test_vocab_padding_is_invisible(run):
    """vocab 250 at model 4: wte is split as 4 x 63 rows, the last 2
    zero; the losses are the model-1 run's, the checkpoint holds the
    whole 250 x 64 leaf, and a fresh engine resumes from it bit for
    bit."""
    root, _ = run
    want, engine = port_model1(root / "pad.npz", vocab_size=250)
    masters = {n: p.detach() for n, p in engine.module.named_parameters()}
    for arrays, meta in results(root, 4, "pad"):
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        assert arrays["master/wte"].shape == (250, 64)
        np.testing.assert_allclose(arrays["master/wte"],
                                   masters["wte"].numpy(), rtol=0,
                                   atol=MASTER_ATOL)
        assert meta["topology"]["mesh_shape"] == {"data": 1, "model": 4}
        a, b = meta["resumed"]
        assert a == b


def test_dropout_masks_and_loss_equal_model1(run):
    """Dropout 0.1 at model 2 (flash): each call's dropout coordinates
    give the model-1 call's multipliers at the rank's heads, bit for
    bit, and the hidden masks agree too, so the step's loss is the
    model-1 loss."""
    root, _ = run
    import importlib
    fa = importlib.import_module("deepspeed_tpu_torch.ops.flash_attention")
    calls = []
    orig = fa.flash_attention

    def rec(q, *a, **kw):
        if kw.get("dropout_rate", 0.0) > 0:
            B, T, Hh, _ = q.shape
            calls.append([B, Hh, T, int(kw["dropout_seed"]),
                          int(kw.get("dropout_head_offset", 0)),
                          kw.get("dropout_num_heads")])
        return orig(q, *a, **kw)

    fa.flash_attention = rec
    try:
        want, _ = port_model1(root / "state.npz", steps=1, dropout=0.1)
    finally:
        fa.flash_attention = orig
    assert len(calls) == 2          # a layer each
    for r, (_, meta) in enumerate(results(root, 2, "drop")):
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        assert len(meta["calls"]) == len(calls)
        for got, ref in zip(meta["calls"], calls):
            B, Hl, T, seed, off, heads = got
            assert heads == 4 and Hl == 2 and off == r * 2
            mine = _dropout_multiplier_full(B, Hl, T, T, 0.1, seed, off,
                                            heads)
            full = _dropout_multiplier_full(ref[0], ref[1], T, T, 0.1,
                                            ref[3], ref[4], ref[5])
            assert seed == ref[3]
            assert torch.equal(mine, full[:, r * 2:(r + 1) * 2])


def test_partition_activations_changes_no_gradient(run):
    """GPT-2 with remat "full" at model 2: with ``partition_activations``
    each checkpointed block keeps half of its input on each rank and
    gathers it for the recompute; the gradients, losses and masters are
    those of the unpartitioned remat run, bit for bit."""
    root, _ = run
    for (a, ma), (b, mb) in zip(results(root, 2, "remat_part"),
                                results(root, 2, "remat")):
        assert ma["losses"] == mb["losses"]
        for key, v in b.items():
            assert np.array_equal(a[key], v), key
        # the two blocks of every micro-batch's forward, partitioned
        assert len(ma["partitioned_segments"]) == 2 * STEPS + 2
        assert mb["partitioned_segments"] == []


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_shard_over_the_data_group_bitwise(run, stage):
    """bf16 at {data 2, model 2}: ZeRO 1-3 cut each model rank's leaves
    over its data group; losses and whole masters equal stage 0's bit for
    bit, as the data-parallel engine's stages do."""
    root, _ = run
    for (a, ma), (b, mb) in zip(results(root, 4, f"bf16_s{stage}"),
                                results(root, 4, "bf16_s0")):
        assert ma["losses"] == mb["losses"]
        for key, v in b.items():
            assert np.array_equal(a[key], v), key


def test_offload_under_a_model_axis_follows_stage0(run):
    """ZeRO-Offload at {data 2, model 2}: the host Adam over each model
    rank's shard, its row of it on each data rank, against the dense
    engine at stage 0 with ``tests/test_torch_offload.py``'s bounds
    (losses rtol 2e-2, masters atol 2 x steps x lr: the offload and the
    dense bf16 engines part by up to lr a step on some leaves at world 1
    and 4 without a model axis too)."""
    root, _ = run
    for (a, ma), (b, mb) in zip(results(root, 4, "bf16_off"),
                                results(root, 4, "bf16_s0")):
        np.testing.assert_allclose(ma["losses"][:1], mb["losses"][:1],
                                   rtol=2e-5)
        np.testing.assert_allclose(ma["losses"], mb["losses"], rtol=2e-2)
        for key, v in b.items():
            if key.startswith("master/"):
                np.testing.assert_allclose(a[key], v, rtol=0,
                                           atol=2 * STEPS * 1e-3,
                                           err_msg=key)


def test_tp_checkpoint_serves(run, capsys):
    """``serve --checkpoint`` reads a model-4 checkpoint (JAX
    ``serve.py:166-171`` reads its ``mesh_shape``): its leaves are whole,
    so it serves at model 1 as saved, with a note naming the axis."""
    from deepspeed_tpu_torch.inference.serve import load_checkpoint_model
    root, _ = run
    model, info = load_checkpoint_model(str(root / "ckpt"), n_head=4)
    assert info["topology"]["mesh_shape"] == {"data": 1, "model": 4}
    assert "model-parallel mesh (model axis 4)" in capsys.readouterr().err
    arrays = results(root, 4, "pad")[0][0]
    assert model.wte.shape == (250, 64)
    # the saved masters are those after the last step before the save
    assert np.array_equal(model.wte.detach().numpy(), arrays["master/wte"])


def test_lamb_under_a_model_axis(run):
    """LAMB's per-leaf trust ratios over split leaves: a split leaf's
    norms summed over the model group, a replicated one's counted once.
    f32 at {data 2, model 2} equals the port's model-1 LAMB (losses rtol
    1e-5, masters atol 2e-5); bf16 at ZeRO 2 equals ZeRO 0 within
    ``tests/test_torch_lamb.py``'s ZeRO bounds (losses rtol 1e-5, masters
    atol 1e-6: each leaf's squares summed over the data group too, in
    another order)."""
    root, _ = run
    want, engine = port_model1(root / "state.npz", opt="Lamb")
    masters = {n: p.detach().numpy() for n, p in
               engine.module.named_parameters()}
    for arrays, meta in results(root, 4, "lamb"):
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        for name, ref in masters.items():
            np.testing.assert_allclose(arrays[f"master/{name}"], ref,
                                       rtol=0, atol=MASTER_ATOL,
                                       err_msg=name)
    for (a, ma), (b, mb) in zip(results(root, 4, "bf16_lamb_s2"),
                                results(root, 4, "bf16_lamb_s0")):
        np.testing.assert_allclose(ma["losses"], mb["losses"], rtol=1e-5)
        for key, v in b.items():
            np.testing.assert_allclose(a[key], v, rtol=0, atol=1e-6,
                                       err_msg=key)
