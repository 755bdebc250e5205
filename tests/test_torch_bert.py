"""BERT: the port (`deepspeed_tpu_torch/models/bert.py`) against the JAX
model (`deepspeed_tpu/models/bert.py`), and BERT MLM training through
the port's ``initialize`` against ``deepspeed_tpu.initialize``.

Params are initialised in JAX (``bert_tiny``, f32, dropout 0) and
carried across with ``convert_bert_params``; gradients convert through
the same function. The sparse model uses block 16 at T 64: on the CPU
the JAX sparse core runs its gather route and the port's the block-sparse
kernels' plain versions (with an attention mask both take the gather
route). The JAX engine runs on a one-device mesh, so both sides see
world size 1 and the same micro-batch split.

Tolerances: logits atol 2e-5 and losses rtol 1e-6 (f32, one forward);
gradients atol 1e-6 plus rtol 1e-5 (most leaves are <= ~0.1; the
token-type table's gradient sums every token of the batch to ~1, where
fp32 sums taken in another order differ by ~1e-6); f32 loss curves
rtol 1e-4 over 5 Adam steps (fp32 summation order drifts through
Adam).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.sparse_attention import (
    FixedSparsityConfig as JaxFixed)
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from tests.torch_threads import one_thread  # noqa: F401

T = 64
LOGIT_ATOL, LOSS_RTOL, GRAD_ATOL, GRAD_RTOL, CURVE_RTOL = \
    2e-5, 1e-6, 1e-6, 1e-5, 1e-4
STEPS = 5


def _cfgs(sparse=True, **kw):
    sp = dict(block=16, num_local_blocks=2)
    return (jbert.bert_tiny(dtype=jnp.float32,
                            sparse_attention=JaxFixed(4, **sp) if sparse
                            else None, **kw),
            tbert.bert_tiny(dtype=torch.float32,
                            sparse_attention=FixedSparsityConfig(4, **sp)
                            if sparse else None, **kw))


def _models(head="mlm", **kw):
    jcfg, tcfg = _cfgs(**kw)
    jcls, tcls = ((jbert.BertForMaskedLM, tbert.BertForMaskedLM)
                  if head == "mlm" else
                  (jbert.BertForQuestionAnswering,
                   tbert.BertForQuestionAnswering))
    jm = jcls(jcfg)
    params = jbert.init_bert_params(jm, jax.random.PRNGKey(0), seq_len=T)
    tm = tcls(tcfg, device="cpu")
    tm.load_state_dict(tbert.convert_bert_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _batch(seed=0, n=2, masked=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (n, T)).astype(np.int32)
    labels = np.full((n, T), -100, np.int64)
    labels[:, ::7] = rng.integers(0, 256, labels[:, ::7].shape)
    batch = {"input_ids": ids, "labels": labels,
             "token_type_ids": (np.arange(T) >= T // 2).astype(np.int32)[
                 None].repeat(n, 0)}
    if masked:
        batch["attention_mask"] = (np.arange(T)[None] <
                                   rng.integers(T // 2, T + 1, (n, 1))) \
            .astype(np.int32)
    return batch


def _grads_close(jgrads, model):
    want = tbert.convert_bert_params(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=n)


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("chunk", [0, 24])
def test_mlm_logits_loss_and_grads_match_jax(sparse, masked, chunk):
    jm, params, tm = _models(sparse=sparse, loss_chunk=chunk)
    batch = _batch(masked=masked)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    want_logits = jax.jit(jm.apply)({"params": params}, jb["input_ids"],
                                    jb.get("attention_mask"),
                                    jb["token_type_ids"])
    got_logits = tm(tb["input_ids"], tb.get("attention_mask"),
                    tb["token_type_ids"])
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(want_logits), atol=LOGIT_ATOL,
                               rtol=0)
    want, jgrads = jax.jit(jax.value_and_grad(
        jbert.make_bert_mlm_loss_fn(jm)))(params, jb)
    loss = tbert.make_bert_mlm_loss_fn(tm)(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(jgrads, tm)


@pytest.mark.parametrize("pre_ln", [False, True])
def test_qa_head_matches_jax(pre_ln):
    jm, params, tm = _models("qa", pre_layer_norm=pre_ln)
    batch = _batch(1, masked=True)
    rng = np.random.default_rng(2)
    batch["start_positions"] = rng.integers(0, T, 2)
    batch["end_positions"] = rng.integers(0, T, 2)
    del batch["labels"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    (js, je) = jax.jit(jm.apply)({"params": params}, jb["input_ids"],
                                 jb["attention_mask"], jb["token_type_ids"])
    ts, te = tm(tb["input_ids"], tb["attention_mask"], tb["token_type_ids"])
    for got, want in ((ts, js), (te, je)):
        assert tuple(got.shape) == (2, T)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
    want, jgrads = jax.jit(jax.value_and_grad(
        jbert.make_bert_qa_loss_fn(jm)))(params, jb)
    loss = tbert.make_bert_qa_loss_fn(tm)(tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    _grads_close(jgrads, tm)


def test_bf16_model_runs_its_encoder_in_fp32_as_jax_does():
    """A BERT built in bf16 rounds the embeddings to bf16, runs its
    encoder layers (the sparse core included) in fp32, since the layer
    config has no bf16 flag, and its MLM head in bf16, on both sides."""
    sp = dict(block=16, num_local_blocks=2)
    jcfg = jbert.bert_tiny(dtype=jnp.bfloat16,
                           sparse_attention=JaxFixed(4, **sp))
    tcfg = tbert.bert_tiny(dtype=torch.bfloat16,
                           sparse_attention=FixedSparsityConfig(4, **sp))
    jm = jbert.BertForMaskedLM(jcfg)
    params = jbert.init_bert_params(jm, jax.random.PRNGKey(0), seq_len=T)
    tm = tbert.BertForMaskedLM(tcfg, device="cpu")
    tm.load_state_dict(tbert.convert_bert_params(
        jax.tree_util.tree_map(np.asarray, params)))
    batch = _batch()
    ids, tt = batch["input_ids"], batch["token_type_ids"]
    want = jbert.BertModel(jcfg).apply({"params": params["bert"]},
                                       jnp.asarray(ids), None,
                                       jnp.asarray(tt))
    got = tm.bert(torch.from_numpy(ids).long(), None,
                  torch.from_numpy(tt).long())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)
    logits = tm(torch.from_numpy(ids).long(), None,
                torch.from_numpy(tt).long())
    assert logits.dtype == torch.bfloat16


def test_convert_uses_every_leaf_once():
    # seq_len T: the shape the other tests already traced (the leaves do
    # not depend on it)
    jm = jbert.BertForMaskedLM(_cfgs()[0])
    params = jax.tree_util.tree_map(
        np.asarray, jbert.init_bert_params(jm, jax.random.PRNGKey(0),
                                           seq_len=T))
    sd = tbert.convert_bert_params(params)
    assert len(sd) == len(jax.tree_util.tree_leaves(params))
    model = tbert.BertForMaskedLM(_cfgs()[1], device="cpu")
    assert set(sd) == set(model.state_dict())
    extra = dict(params, pooler={"kernel": np.zeros((64, 64), np.float32)})
    with pytest.raises(ValueError, match="no counterpart for pooler/kernel"):
        tbert.convert_bert_params(extra)
    bad = {"bert": dict(params["bert"], layer_0=dict(
        params["bert"]["layer_0"], extra_w=np.zeros(3, np.float32)))}
    with pytest.raises(ValueError, match="layer_0/extra_w"):
        tbert.convert_bert_params(bad)


# ---------------------------------------------------------------------------
# training through initialize
# ---------------------------------------------------------------------------

CONFIGS = {
    "adam": {"train_batch_size": 8, "steps_per_print": 10 ** 9,
             "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
    "accum2_clip": {"train_batch_size": 8, "steps_per_print": 10 ** 9,
                    "gradient_accumulation_steps": 2,
                    "gradient_clipping": 0.5,
                    "sparse_attention": {"mode": "fixed", "block": 16},
                    "optimizer": {"type": "AdamW",
                                  "params": {"lr": 2e-3,
                                             "weight_decay": 0.01}}},
}


def _train_batches(n=STEPS):
    return [{k: v for k, v in _batch(10 + i, n=8).items()
             if k != "token_type_ids"} for i in range(n)]


@pytest.fixture(scope="module")
def sparse_params():
    jm = jbert.BertForMaskedLM(_cfgs()[0])
    return jm, jbert.init_bert_params(jm, jax.random.PRNGKey(3), seq_len=T)


def _port_engine(params, config, seed=0, **kw):
    model = tbert.BertForMaskedLM(_cfgs(**kw)[1], device="cpu")
    model.load_state_dict(tbert.convert_bert_params(
        jax.tree_util.tree_map(np.asarray, params)))
    engine, _, _, _ = initialize(model=model, config=dict(config),
                                 device="cpu", seed=seed)
    return engine


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sparse_bert_loss_curve_matches_jax_engine(sparse_params, name):
    jm, params = sparse_params
    config = CONFIGS[name]
    jeng, _, _, _ = deepspeed_tpu.initialize(
        config=dict(config), loss_fn=jbert.make_bert_mlm_loss_fn(jm),
        params=params, mesh=build_mesh({}, devices=jax.devices()[:1]))
    teng = _port_engine(params, config)
    want = [float(jeng.train_batch(b)) for b in _train_batches()]
    got = [float(teng.train_batch(b)) for b in _train_batches()]
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    assert got[-1] < got[0]
    assert teng.global_steps == STEPS
    assert teng.config.sparse_attention == \
        deepspeed_tpu.runtime.config.get_sparse_attention(config)


def test_sparse_bert_step1_grads_match_jax(sparse_params):
    jm, params = sparse_params
    batch = _train_batches(1)[0]
    want = jax.jit(jax.grad(jbert.make_bert_mlm_loss_fn(jm)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    teng = _port_engine(params, CONFIGS["adam"])
    teng.backward(teng.forward(batch))
    _grads_close(want, teng.module)


def test_dropout_training_is_deterministic_per_seed(sparse_params):
    """Dropout on (hidden and attention-prob): the same engine seed
    replays the same curve, another seed differs. Same-seed curves are
    held to rtol 1e-6, not bit for bit: the CPU matmuls may split their
    sums differently between two runs when other processes load the
    cores; other masks move the loss by ~1e-2."""
    _, params = sparse_params

    def curve(seed):
        eng = _port_engine(params, CONFIGS["adam"], seed=seed,
                           hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1)
        return [float(eng.train_batch(b)) for b in _train_batches(3)]

    a, b, c = curve(0), curve(0), curve(1)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    assert max(abs(x - y) for x, y in zip(a, c)) > 1e-3
