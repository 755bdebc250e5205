"""GPT-2's ``remat`` in the port (`deepspeed_tpu_torch/models/gpt2.py`):
each block under ``torch.utils.checkpoint`` with the JAX model's policies
("full", "dots", "nothing", `deepspeed_tpu/models/gpt2.py:308-319`).

Remat must change no bit: the same losses and gradients as remat off, in
f32, with dropout 0 and with dropout 0.1 (the recompute draws the
forward's hidden-dropout masks from the block's saved generator state).
Against the JAX model under the same policy the loss matches within
rtol 1e-6 and the gradients within atol 1e-6, the tolerance of the
port's chunked-loss model-path test (`tests/test_torch_gpt2_train.py`),
at dropout 0 (the two packages' dropout streams differ by design). The
JAX model's own ``remat=True`` does not trace with this flax (its block
takes ``deterministic`` as a traced argument under ``nn.remat`` and
raises ``TracerBoolConversionError``; `tests/unit/test_gpt2_scan.py`'s
remat case fails the same way), so the JAX side is its loss under
``jax.checkpoint`` with that policy: the same policies, one level up.

JAX is imported inside the parity test only, so the ``cuda`` case runs
on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_gpt2_remat.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.ops import flash_attention as fa_module
from tests.torch_threads import one_thread  # noqa: F401

POLICIES = ("full", "dots", "nothing")


def _ids(seed=0, b=2, t=24):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int64))


def _model(remat, policy="full", dropout=0.0, flash=True, chunk=8):
    gen = torch.Generator()
    gen.manual_seed(0)
    return tg.GPT2LMHead(tg.gpt2_tiny(
        dtype=torch.float32, dropout=dropout, remat=remat,
        remat_policy=policy, use_flash_attention=flash, loss_chunk=chunk),
        device="cpu", generator=gen)


def _loss_and_grads(model, ids, seed):
    loss = model.loss_fn({"input_ids": ids}, seed)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_remat_is_bitwise_neutral(policy, dropout, flash):
    ids = _ids()
    want, want_g = _loss_and_grads(_model(False, dropout=dropout,
                                          flash=flash), ids, 7)
    got, got_g = _loss_and_grads(_model(True, policy, dropout, flash),
                                 ids, 7)
    assert torch.equal(got, want)
    for name, g in got_g.items():
        assert torch.equal(g, want_g[name]), name


def test_recompute_without_the_saved_generator_state_would_differ():
    """Counter-evidence for the dropout case: a recompute that draws its
    own masks (the generator where the forward left it) changes the
    gradients, so the bitwise test above does hold the saved state to
    account."""
    ids = _ids()
    want, want_g = _loss_and_grads(_model(False, dropout=0.1), ids, 7)
    real = tg.remat_block

    def fresh_masks(block, x, drop, policy, keep=(True, True), gate=False):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(lambda h: block(h, drop=drop, keep=keep,
                                          gate=gate), x,
                          use_reentrant=False, preserve_rng_state=False)

    tg.remat_block = fresh_masks
    try:
        got, got_g = _loss_and_grads(_model(True, dropout=0.1), ids, 7)
    finally:
        tg.remat_block = real
    assert torch.equal(got, want)       # the forward is the same
    assert any(not torch.equal(g, want_g[n]) for n, g in got_g.items())


@pytest.mark.parametrize("policy,attention_calls", [
    ("full", 4), ("dots", 4), ("nothing", 2)])
def test_recompute_runs_attention_again(monkeypatch, policy,
                                        attention_calls):
    """"full" and "dots" recompute each block in the backward, K1
    included (dots keeps matmul outputs only, as JAX's checkpoint_dots
    keeps dot_general results only); "nothing" keeps everything."""
    calls = []
    real = fa_module.flash_attention

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fa_module, "flash_attention", counting)
    _loss_and_grads(_model(True, policy), _ids(), None)
    assert len(calls) == attention_calls        # 2 layers


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        _model(True, "everything")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_model(policy):
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import gpt2 as jg

    jmodel = jg.GPT2LMHead(jg.gpt2_tiny(
        dtype=jnp.float32, loss_chunk=8, use_flash_attention=True))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    ids = _ids(4)
    jax_policy = {"full": None,
                  "dots": jax.checkpoint_policies.checkpoint_dots,
                  "nothing": jax.checkpoint_policies.everything_saveable}
    loss_fn = jg.make_gpt2_loss_fn(jmodel)
    batch = {"input_ids": jnp.asarray(ids.numpy().astype(np.int32))}
    remat_loss = jax.checkpoint(lambda p: loss_fn(p, batch, None),
                                policy=jax_policy[policy])
    want, want_g = jax.jit(jax.value_and_grad(remat_loss))(params)
    model = _model(True, policy)
    model.load_state_dict(tg.convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, params)))
    got, got_g = _loss_and_grads(model, ids, None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want_g = tg.convert_gpt2_params(jax.tree_util.tree_map(np.asarray,
                                                           want_g))
    for name, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   atol=1e-6, err_msg=name)


@pytest.mark.cuda
def test_remat_lowers_peak_memory_at_gpt2_350m():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    peaks, losses = {}, {}
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 50257, (4, 1024)).astype(np.int64)).cuda()
    for remat in (False, True):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        model = tg.GPT2LMHead(tg.gpt2_350m(
            n_positions=1024, use_flash_attention=True, loss_chunk=512,
            remat=remat), device="cuda", generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = model.loss_fn({"input_ids": ids}, None)
        loss.backward()
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        losses[remat] = float(loss)
        del model, loss
        torch.cuda.empty_cache()
    assert losses[True] == losses[False]
    assert peaks[True] < 0.7 * peaks[False], peaks


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_under_the_16bit_engine_is_bitwise_neutral(policy):
    """Under a bf16 engine the forward reads the installer's cast copies
    of the masters; the recompute reads them too (the installer puts
    them back for the backward), so "dots"' selective checkpoint sees
    the forward's ops and remat changes no loss or master bit."""
    from deepspeed_tpu_torch import initialize
    runs = []
    for remat in (False, True):
        model = tg.GPT2LMHead(tg.gpt2_tiny(
            dtype=torch.bfloat16, remat=remat, remat_policy=policy,
            use_flash_attention=True), device="cpu",
            generator=torch.Generator().manual_seed(0))
        engine, _, _, _ = initialize(model=model, config={
            "train_batch_size": 4, "bf16": {"enabled": True},
            "gradient_accumulation_steps": 2}, device="cpu")
        ids = _ids(b=4, t=16).numpy()
        losses = [float(engine.train_batch({"input_ids": ids}))
                  for _ in range(3)]
        runs.append((losses, [m.clone() for m in engine._masters]))
    assert runs[1][0] == runs[0][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[1][1], runs[0][1]))
