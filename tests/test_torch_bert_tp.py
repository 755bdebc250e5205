"""BERT tensor parallelism (Megatron's layout: ``models/bert.py``,
``ops/transformer/transformer.py``) through ``initialize()`` in gloo
worlds of 4 and 2 processes, held to the JAX engine at the same mesh
(``deepspeed_tpu.initialize(..., param_specs=bert_partition_specs(params),
mesh=build_mesh(...))``) and to the port at model 1.

``bert_tiny`` (vocab 256, 2 layers, 4 heads, hidden 64), f32, MLM over
8 x 64 tokens, dropout 0, Adam lr 1e-3 and eps 1e-3, 3 steps, at
``{"data": 2, "model": 2}`` and ``{"model": 4}``. Each attention core:
dense and flash (K1-K3's plain versions, the key padding mask as a key
bias) with a padding mask; sparse (K7/K8's plain versions) with the
Fixed layout and with a Variable layout that has a random block a row
and a layout of its own a head (``different_layout_per_head``: a rank's
heads take their own rows of the layout). JAX's GSPMD runs every core
at a model axis, so each is held to the JAX engine at ``{"data": 2,
"model": 2}`` (GSPMD computes the unsharded function at any mesh; the
port's model-4 runs are held to the same reference). The tolerances are
``tests/test_torch_tp_train.py``'s: losses rtol 1e-5, gradients atol
1e-5, masters after 3 steps atol 2e-5. In bf16 at ``{"data": 2,
"model": 2}``, ZeRO 1 and 2 equal ZeRO 0 bit for bit.

With dropout 0.1 at ``{"model": 2}`` every attention call of a rank
draws the model-1 run's multipliers at its heads, bit for bit (the
heads' global coordinates: ``head_offset`` the rank's first head, the
head count the model's), and the hidden masks are the model-1 run's, so
the loss is the model-1 loss. A vocab of 250 pads ``word_embeddings``
and the ``decoder`` to 252 rows at model 4; a checkpoint saved whole at
``{"data": 2, "model": 2}`` resumes at ``{"model": 4}`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.sparse_attention import (
    FixedSparsityConfig as JaxFixed,
    VariableSparsityConfig as JaxVariable,
)
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops.flash_attention import _dropout_multiplier_full
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    block_sparse_attention,
)
from tests import torch_zero_harness as H
from tests.torch_f6_cases import BERT_T, bert_batches, bert_config
from tests.torch_threads import one_thread  # noqa: F401

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
LOSS_RTOL, GRAD_ATOL, MASTER_ATOL = 1e-5, 1e-5, 2e-5
STEPS, BATCH = 3, 8
CORES = ("dense", "flash", "fixed", "variable")
D2M2, M4 = {"data": 2, "model": 2}, {"model": 4}


def case(name, core, mesh, **kw):
    return dict({"name": name, "kind": "bert_train", "mesh": mesh,
                 "core": core, "batch": BATCH, "steps": STEPS, "lr": 1e-3,
                 "eps": 1e-3, "masked": core in ("dense", "flash"),
                 "grads": True}, **kw)


def jax_sparsity(core):
    if core == "fixed":
        return JaxFixed(4, block=16, num_local_blocks=2)
    if core == "variable":
        return JaxVariable(4, block=16, num_random_blocks=1,
                           local_window_blocks=[2], global_block_indices=[0],
                           different_layout_per_head=True)
    return None


def jax_model(core, **kw):
    return jbert.BertForMaskedLM(jbert.bert_tiny(
        dtype=jnp.float32, use_flash_attention=core == "flash",
        sparse_attention=jax_sparsity(core), **kw))


def jax_params():
    model = jbert.BertForMaskedLM(jbert.bert_tiny(dtype=jnp.float32))
    return jbert.init_bert_params(model, jax.random.PRNGKey(0),
                                  seq_len=BERT_T)


def save_state(sd, path):
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return str(path)


VOCAB_LEAVES = ("bert.embeddings.word_embeddings", "decoder.weight",
                "decoder.bias")


def jax_batches(c):
    return [{k: jnp.asarray(v.astype(np.int32)) for k, v in b.items()}
            for b in bert_batches(c)]


def jax_run(params, core, c):
    """The JAX engine at {"data": 2, "model": 2}: the losses, the whole
    masters after the steps, and (dense and fixed) the first batch's
    gradients."""
    model = jax_model(core)
    cfg = {"train_batch_size": BATCH, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                    "eps": 1e-3}}}
    loss_fn = jbert.make_bert_mlm_loss_fn(model)
    xs = jax_batches(c)
    grads = None
    if core in ("dense", "fixed"):
        grads = tbert.convert_bert_params(jax.tree_util.tree_map(
            np.asarray, jax.jit(jax.grad(loss_fn))(params, xs[0])))
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=cfg, loss_fn=loss_fn, params=params,
        param_specs=jbert.bert_partition_specs(params),
        mesh=build_mesh(D2M2, devices=jax.devices()[:4]))
    losses = [float(engine.train_batch(x)) for x in xs]
    after = tbert.convert_bert_params(jax.tree_util.tree_map(
        np.asarray, engine.params))
    return losses, after, grads


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def run(tmp_path_factory, params):
    """One world of 4 (every core at both meshes, the dense one saving
    at {data 2, model 2} for the resume at model 4, the padded vocab,
    ZeRO 0-2 in bf16) and one of 2
    (dropout on each core, the QA head), started together; the JAX
    references run meanwhile."""
    root = tmp_path_factory.mktemp("bert_tp")
    sd = tbert.convert_bert_params(jax.tree_util.tree_map(np.asarray,
                                                          params))
    state = save_state(sd, root / "state.npz")
    # vocab 250: the same model's first 250 vocab rows
    pad = save_state({k: v[:250] if k in VOCAB_LEAVES else v
                      for k, v in sd.items()}, root / "pad.npz")
    qa_model = tbert.BertForQuestionAnswering(
        bert_config({}), device="cpu",
        generator=torch.Generator().manual_seed(0))
    qa = save_state({k: v.detach() for k, v in
                     qa_model.state_dict().items()}, root / "qa.npz")
    ckpt = str(root / "ckpt")
    w4 = [case(f"d2m2_{c}", c, D2M2, save=ckpt if c == "dense" else None)
          for c in CORES] + \
        [case(f"m4_{c}", c, M4, grads=c in ("dense", "fixed"))
         for c in CORES] + \
        [case("resume", "dense", M4, grads=False, load=ckpt, steps=1,
              data_seed=5),
         case("pad", "dense", M4, grads=False, state=pad,
              model={"vocab_size": 250})] + \
        [case(f"bf16_s{z}", "dense", D2M2, grads=False, dtype="bf16",
              zero={"stage": z}, steps=2) for z in (0, 1, 2)]
    drop = {"hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}
    w2 = [case(f"drop_{c}", c, {"model": 2}, grads=False, steps=1,
               dropout=True, model=drop) for c in ("dense", "flash", "fixed")]
    w2.append(case("qa", "dense", {"model": 2}, kind="bert_qa", state=qa,
                   grads=False))
    procs = H.start_world(4, w4, state, root / "w4", worker=WORKER) + \
        H.start_world(2, w2, state, root / "w2", worker=WORKER)
    try:
        ref = {c: jax_run(params, c, case("", c, D2M2)) for c in CORES}
    finally:
        H.wait_world(procs[:4])
        H.wait_world(procs[4:])
    return root, ref


def results(root, world, name):
    return H.load_results(root / {4: "w4", 2: "w2"}[world], name, world)


def port_model1(state_path, c):
    """The port at model 1 on the case's batches: losses, engine."""
    sd = {k: torch.from_numpy(v) for k, v in np.load(state_path).items()}
    model = tbert.BertForMaskedLM(bert_config(c), device="cpu")
    model.load_state_dict(sd)
    engine, _, _, _ = initialize(model=model, device="cpu", config={
        "train_batch_size": BATCH, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "eps": 1e-3}}})
    return [float(engine.train_batch({k: torch.from_numpy(v)
                                      for k, v in b.items()}))
            for b in bert_batches(c)], engine


@pytest.mark.parametrize("mesh", ["d2m2", "m4"])
@pytest.mark.parametrize("core", CORES)
def test_losses_and_masters_equal_jax_engine(run, core, mesh):
    root, ref = run
    want, after, _ = ref[core]
    for arrays, meta in results(root, 4, f"{mesh}_{core}"):
        assert meta["mp_world_size"] == (2 if mesh == "d2m2" else 4)
        assert meta["local_heads"] == (2 if mesh == "d2m2" else 1)
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        for leaf, v in after.items():
            np.testing.assert_allclose(arrays[f"master/{leaf}"], v.numpy(),
                                       rtol=0, atol=MASTER_ATOL,
                                       err_msg=leaf)


@pytest.mark.parametrize("mesh", ["d2m2", "m4"])
@pytest.mark.parametrize("core", ["dense", "fixed"])
def test_first_gradients_equal_jax(run, core, mesh):
    root, ref = run
    want = ref[core][2]
    for arrays, _ in results(root, 4, f"{mesh}_{core}"):
        for leaf, v in want.items():
            np.testing.assert_allclose(arrays[f"grad/{leaf}"], v.numpy(),
                                       rtol=0, atol=GRAD_ATOL, err_msg=leaf)


def test_leaves_are_split_as_megatron(run):
    """At model 4: q, k, v blocks of whole heads, the row-parallel output
    projections, the vocab leaves split, everything else whole."""
    root, _ = run
    shapes = results(root, 4, "m4_dense")[0][1]["shapes"]
    layer = "bert.layer.0."
    assert shapes[layer + "attn_qkvw"] == [64, 48]
    assert shapes[layer + "attn_qkvb"] == [48]
    assert shapes[layer + "attn_ow"] == [16, 64]
    assert shapes[layer + "inter_w"] == [64, 32]
    assert shapes[layer + "output_w"] == [32, 64]
    assert shapes[layer + "attn_ob"] == [64]
    assert shapes["bert.embeddings.word_embeddings"] == [64, 64]
    assert shapes["decoder.weight"] == [64, 64]
    assert shapes["decoder.bias"] == [64]
    assert shapes["bert.embeddings.position_embeddings"] == [64, 64]
    specs = tbert.bert_partition_specs(
        {n: None for n in shapes}, vocab_size=256)
    assert specs[layer + "attn_qkvw"] == (1, 3, None, "model")
    assert specs["decoder.bias"] == (0, 1, 256, "model")
    assert specs["transform.weight"] is None


@pytest.mark.parametrize("stage", [1, 2])
def test_zero_stages_shard_over_the_data_group_bitwise(run, stage):
    """bf16 at {data 2, model 2}: ZeRO 1 and 2 cut each model rank's
    leaves over its data group; losses and whole masters and moments
    equal stage 0's bit for bit, as GPT-2's at a model axis do."""
    root, _ = run
    for (a, ma), (b, mb) in zip(results(root, 4, f"bf16_s{stage}"),
                                results(root, 4, "bf16_s0")):
        assert ma["losses"] == mb["losses"]
        for key, v in b.items():
            assert np.array_equal(a[key], v), key


def test_dropout_masks_and_loss_equal_model1(run):
    """Dropout 0.1 at model 2 on the dense, flash and sparse cores: each
    attention call's coordinates give the model-1 call's multipliers at
    the rank's heads, bit for bit, and the step's loss is the model-1
    loss."""
    root, _ = run
    from tests.torch_f6_cases import _record_dropout
    for core in ("dense", "flash", "fixed"):
        c = case(f"drop_{core}", core, {"model": 2}, steps=1, model={
            "hidden_dropout_prob": 0.1,
            "attention_probs_dropout_prob": 0.1})
        calls = []
        undo = _record_dropout(calls)
        try:
            want, _ = port_model1(root / "state.npz", c)
        finally:
            undo()
        assert len(calls) == 2          # a layer each
        for r, (_, meta) in enumerate(results(root, 2, c["name"])):
            np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
            assert len(meta["calls"]) == len(calls)
            for got, ref in zip(meta["calls"], calls):
                B, Hl, T, seed, off, heads = got
                assert heads == 4 and Hl == 2 and off == r * 2, got
                assert seed == ref[3]
                mine = _dropout_multiplier_full(B, Hl, T, T, 0.1, seed, off,
                                                heads)
                full = _dropout_multiplier_full(ref[0], ref[1], T, T, 0.1,
                                                ref[3], ref[4], ref[5])
                assert torch.equal(mine, full[:, r * 2:(r + 1) * 2])


def test_sparse_kernels_hash_the_global_head():
    """K7/K8's plain versions: with the head count given they hash head
    ``b * num_heads + head_offset + h``; a rank's 2 heads of 4 give the
    whole run's outputs and gradients at those heads, bit for bit; at
    one rank the head count changes no bit."""
    g = torch.Generator().manual_seed(0)
    B, T, H, D, blk = 2, 64, 4, 16, 16
    q, k, v, do = (torch.randn(B, T, H, D, generator=g) for _ in range(4))
    layout = np.random.default_rng(0).integers(0, 2, (H, 4, 4))
    layout[:, np.arange(4), np.arange(4)] = 1
    def run(qq, kk, vv, lay, **extra):
        kw = dict(dict(dropout_rate=0.2, dropout_seed=123,
                       dropout_head_offset=8), **extra)
        xs = [t.clone().requires_grad_(True) for t in (qq, kk, vv)]
        out = block_sparse_attention(*xs, lay, blk, **kw)
        out.backward(do[:, :, :qq.shape[2]] if qq.shape[2] < H else do)
        return [out.detach()] + [t.grad for t in xs]

    base = run(q, k, v, layout)
    same = run(q, k, v, layout, dropout_num_heads=H)
    for a, b in zip(base, same):
        assert torch.equal(a, b)
    whole = run(q, k, v, layout, dropout_head_offset=0)
    for r in range(2):
        sl = slice(r * 2, (r + 1) * 2)
        got = block_sparse_attention(
            q[:, :, sl], k[:, :, sl], v[:, :, sl], layout[sl], blk,
            dropout_rate=0.2, dropout_seed=123, dropout_head_offset=r * 2,
            dropout_num_heads=H)
        assert torch.equal(got, whole[0][:, :, sl])


def test_vocab_padding_is_invisible(run):
    """Vocab 250 at model 4: the vocab leaves are 4 x 63 rows, the last 2
    zero; the losses are the model-1 run's and the whole masters hold
    250 rows."""
    root, _ = run
    c = case("pad", "dense", M4, model={"vocab_size": 250})
    want, engine = port_model1(root / "pad.npz", c)
    masters = {n: p.detach() for n, p in engine.module.named_parameters()}
    for arrays, meta in results(root, 4, "pad"):
        assert meta["shapes"]["decoder.bias"] == [63]
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)
        for name in VOCAB_LEAVES:
            assert arrays[f"master/{name}"].shape[0] == 250
            np.testing.assert_allclose(arrays[f"master/{name}"],
                                       masters[name].numpy(), rtol=0,
                                       atol=MASTER_ATOL)


def test_whole_checkpoint_resumes_at_another_model_size(run):
    """Saved whole at {data 2, model 2}, loaded at model 4: the masters
    and Adam moments a model-4 rank holds, made whole, are the saved
    ones bit for bit, and the next step's loss is the port's at model 1
    resumed from the same checkpoint."""
    root, _ = run
    saved, meta = results(root, 4, "d2m2_dense")[0]
    assert meta["topology"]["mesh_shape"] == {"data": 2, "model": 2}
    c = case("", "dense", M4, steps=1, data_seed=5)
    sd = {k: torch.from_numpy(v) for k, v in
          np.load(root / "state.npz").items()}
    model = tbert.BertForMaskedLM(bert_config(c), device="cpu")
    model.load_state_dict(sd)
    engine, _, _, _ = initialize(model=model, device="cpu", config={
        "train_batch_size": BATCH, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3, "eps": 1e-3}}})
    engine.load_checkpoint(str(root / "ckpt"))
    want = [float(engine.train_batch({k: torch.from_numpy(v)
                                      for k, v in b.items()}))
            for b in bert_batches(c)]
    for arrays, meta in results(root, 4, "resume"):
        for key, v in saved.items():
            if not key.startswith("grad/"):
                assert np.array_equal(arrays[f"loaded/{key}"], v), key
        np.testing.assert_allclose(meta["losses"], want, rtol=LOSS_RTOL)


def test_qa_head_at_model2_equals_model1(run):
    """``BertForQuestionAnswering(cfg, mpu=...)`` at model 2: the span
    logits and the loss equal the one-rank model's."""
    root, _ = run
    sd = {k: torch.from_numpy(v) for k, v in np.load(root / "qa.npz").items()}
    model = tbert.BertForQuestionAnswering(bert_config({}), device="cpu")
    model.load_state_dict(sd)
    from tests.torch_f6_cases import qa_batch
    b = qa_batch()
    start, end = model(b["input_ids"], b["attention_mask"])
    loss = tbert.make_bert_qa_loss_fn(model)(b)
    for arrays, meta in results(root, 2, "qa"):
        np.testing.assert_allclose(arrays["start"], start.detach().numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(arrays["end"], end.detach().numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(meta["loss"], float(loss), rtol=1e-5)


def test_converter_gives_a_rank_its_shard(params):
    """``convert_bert_params(params, model_rank, model_size)`` is the
    whole converted state cut by ``bert_partition_specs``: q, k, v blocks
    of whole heads; a vocab leaf is padded where the axis does not divide
    it (256 at 3 ranks: 86 rows a rank, the last 2 zero)."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    whole = tbert.convert_bert_params(tree)
    for r in range(2):
        got = tbert.convert_bert_params(tree, model_rank=r, model_size=2)
        want = tbert.shard_bert_state_dict(whole, r, 2)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    qkv = whole["bert.layer.0.attn_qkvw"]
    got = tbert.convert_bert_params(tree, model_rank=1, model_size=2)
    # rank 1: heads 2-3 of q, of k and of v (16 columns each)
    want = torch.cat([qkv[:, 32:64], qkv[:, 96:128], qkv[:, 160:192]], 1)
    assert torch.equal(got["bert.layer.0.attn_qkvw"], want)
    pad = tbert.shard_bert_state_dict(whole, 2, 3)["decoder.bias"]
    assert pad.shape == (86,) and torch.equal(pad[-2:], torch.zeros(2))
