"""Activation checkpointing in the port
(`deepspeed_tpu_torch/runtime/activation_checkpointing/`) and the three
remat flags of ``DeepSpeedTransformerLayer``.

- Every policy (``nothing``, ``dots``, ``dots_no_batch``, ``everything``,
  ``offload``) gives the un-checkpointed loss and gradients bit for bit,
  hidden dropout included: the recompute replays the generator it is
  given, and the RNG tracker's forks.
- ``checkpoint_sequential`` cuts the same segments as JAX's for every
  length and ``number_checkpoints``.
- ``RNGKeyTracker`` / ``get_rng_tracker`` / ``model_parallel_seed``
  have JAX's API and raise JAX's errors; ``make_policy`` too; the
  engine configures the module from its config unless the user has.
- ``normalize_invertible``, ``gelu_checkpoint`` and
  ``attn_dropout_checkpoint``, one at a time and together, give the
  flag-free layer's outputs and gradients bit for bit, on the dense,
  flash and block-sparse cores, at dropout 0.1.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.activation_checkpointing import (
    checkpointing as jax_ckpt)
from deepspeed_tpu_torch.ops.flash_attention import hidden_dropout
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from deepspeed_tpu_torch.runtime.activation_checkpointing import (
    checkpointing as ckpt)

POLICIES = ("nothing", "dots", "dots_no_batch", "everything", "offload")


@pytest.fixture(autouse=True)
def _fresh_module():
    ckpt.reset()
    yield
    ckpt.reset()


def _weights(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(16, 32, generator=g, requires_grad=True),
            torch.randn(32, 16, generator=g, requires_grad=True),
            torch.randn(4, 5, 16, generator=g, requires_grad=True)]


def _segment(x, w1, w2, gen):
    h = torch.nn.functional.gelu(x @ w1)
    h = hidden_dropout(h, 0.1, gen)
    s = torch.bmm(h, h.transpose(1, 2)).softmax(-1)
    with ckpt.get_rng_tracker().fork("default", device="cpu") as g2:
        s = hidden_dropout(s, 0.2, g2)
    return torch.bmm(s, h) @ w2


def _loss_and_grads(policy):
    w1, w2, x = _weights()
    ckpt.model_parallel_seed(5)
    gen = torch.Generator().manual_seed(11)
    if policy is None:
        y = _segment(x, w1, w2, gen)
    else:
        y = ckpt.checkpoint(_segment, x, w1, w2, gen, policy=policy)
    y = y + 0.5 * _segment(y, w1, w2, gen)    # the generator moves on
    loss = (y * y).mean()
    loss.backward()
    return loss.detach(), [t.grad for t in (w1, w2, x)]


@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_gives_the_plain_gradients_bitwise(policy):
    want, want_g = _loss_and_grads(None)
    got, got_g = _loss_and_grads(policy)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


def test_recompute_replays_the_generators():
    """Counter-evidence: the same segment with the generator state not
    restored (plain ``torch.utils.checkpoint``) changes the gradients."""
    from torch.utils.checkpoint import checkpoint
    want, want_g = _loss_and_grads(None)
    w1, w2, x = _weights()
    ckpt.model_parallel_seed(5)
    gen = torch.Generator().manual_seed(11)
    y = checkpoint(_segment, x, w1, w2, gen, use_reentrant=False)
    y = y + 0.5 * _segment(y, w1, w2, gen)
    (y * y).mean().backward()
    assert any(not torch.equal(t.grad, g)
               for t, g in zip((w1, w2, x), want_g))


@pytest.mark.parametrize("n", range(1, 8))
@pytest.mark.parametrize("segments", [None, 1, 2, 3, 10])
def test_checkpoint_sequential_segments_as_jax(monkeypatch, n, segments):
    def recorder(store):
        def fake(fn, x, policy=None):
            store.append(len(fn.__defaults__[0]))
            return fn(x)
        return fake

    want, got = [], []
    monkeypatch.setattr(jax_ckpt, "checkpoint", recorder(want))
    monkeypatch.setattr(ckpt, "checkpoint", recorder(got))
    fns = [(lambda k: (lambda v: v * 2 + k))(k) for k in range(n)]
    jax_out = jax_ckpt.checkpoint_sequential(fns, 1, segments)
    port_out = ckpt.checkpoint_sequential(fns, 1, segments)
    assert got == want and port_out == jax_out
    # and from the configured number_checkpoints
    jax_ckpt.configure(num_checkpoints=3)
    ckpt.configure(num_checkpoints=3)
    want.clear()
    got.clear()
    jax_ckpt.checkpoint_sequential(fns, 1)
    ckpt.checkpoint_sequential(fns, 1)
    jax_ckpt.reset()
    assert got == want


def test_checkpoint_sequential_runs_and_matches_the_plain_chain():
    w1, w2, x = _weights()
    fns = [lambda v: torch.tanh(v @ w1) @ w2] * 5
    y = ckpt.checkpoint_sequential(fns, x, 2)
    y.sum().backward()
    want = [t.grad.clone() for t in (w1, w2, x)]
    for t in (w1, w2, x):
        t.grad = None
    z = x
    for f in fns:
        z = f(z)
    assert torch.equal(y, z)
    z.sum().backward()
    assert all(torch.equal(t.grad, g) for t, g in zip((w1, w2, x), want))


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_rng_tracker_api_and_errors_match_jax():
    for mod in (jax_ckpt, ckpt):
        mod.model_parallel_seed(7, model_parallel_rank=1)
    jt, pt = jax_ckpt.get_rng_tracker(), ckpt.get_rng_tracker()
    assert set(pt.get_states()[0]) == set(jt.get_states()[0]) == {
        "default", "model-parallel-rng"}
    assert _raised(lambda: pt.add("default", 1)) == \
        _raised(lambda: jt.add("default", 1))

    def fork(tracker):
        with tracker.fork("nope"):
            pass

    assert _raised(lambda: fork(pt)) == _raised(lambda: fork(jt))
    states = pt.get_states()
    with pt.fork() as a:
        first = torch.rand(3, generator=a)
    with pt.fork() as b:
        second = torch.rand(3, generator=b)
    assert not torch.equal(first, second)
    pt.set_states(states)
    with pt.fork() as c:
        assert torch.equal(torch.rand(3, generator=c), first)
    assert pt.get_states()[1]["model-parallel-rng"] == 1
    for mod in (jax_ckpt, ckpt):
        mod.reset()
    assert pt.get_states() == ({}, {})
    jax_ckpt.reset()


def test_policies_configure_and_engine_wiring(tmp_path):
    assert _raised(lambda: ckpt.make_policy("sometimes")) == \
        _raised(lambda: jax_ckpt.make_policy("sometimes"))
    assert ckpt.make_policy(None) == "nothing"
    ckpt.configure(checkpoint_in_cpu=True)
    assert ckpt.make_policy(None) == "offload"
    ckpt.reset()
    assert not ckpt.is_configured()
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
    section = {"partition_activations": True, "number_checkpoints": 4,
               "contiguous_memory_optimization": True,
               "cpu_checkpointing": True, "profile": True,
               "synchronize_checkpoint_boundary": True}
    config = {"train_batch_size": 2, "activation_checkpointing": section}
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    initialize(model=model, config=config, device="cpu")
    assert ckpt.is_configured()
    got = vars(ckpt._cfg())
    assert got == {k: section[k] for k in got}
    # a user's configure() beforehand wins
    ckpt.configure(num_checkpoints=2)
    initialize(model=model, config=config, device="cpu")
    assert ckpt._cfg().number_checkpoints == 2
    # profile: the checkpointed call is timed
    ckpt.configure(profile=True)
    w1, w2, x = _weights()
    ckpt.checkpoint(lambda v: v @ w1, x).sum().backward()
    assert "activation_checkpoint" in ckpt._timers.timers


# ---------------------------------------------------------------------------
# BERT's three flags
# ---------------------------------------------------------------------------

FLAGS = ("normalize_invertible", "gelu_checkpoint", "attn_dropout_checkpoint")
CFG = dict(batch_size=2, max_seq_length=64, hidden_size=64,
           intermediate_size=128, heads=4, attn_dropout_ratio=0.1,
           hidden_dropout_ratio=0.1, num_hidden_layers=2,
           initializer_range=0.1)


def _layer_run(core, pre_ln, flags):
    cfg = DeepSpeedTransformerConfig(pre_layer_norm=pre_ln,
                                     **dict(CFG, **flags))
    sparse = FixedSparsityConfig(4, block=16, num_local_blocks=2) \
        if core == "sparse" else None
    layer = DeepSpeedTransformerLayer(
        cfg, use_flash_attention=core == "flash", sparsity_config=sparse,
        device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    y = layer(x, dropout_seed=1234)
    (y * y).sum().backward()
    return y.detach(), [p.grad for p in layer.parameters()] + [x.grad]


@pytest.mark.parametrize("core", ["dense", "flash", "sparse"])
@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre", "post"])
@pytest.mark.parametrize("flags", [(f,) for f in FLAGS] + [FLAGS],
                         ids=list(FLAGS) + ["all"])
def test_bert_checkpoint_flags_change_no_bit(core, pre_ln, flags):
    want, want_g = _layer_run(core, pre_ln, {})
    got, got_g = _layer_run(core, pre_ln, dict.fromkeys(flags, True))
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)
