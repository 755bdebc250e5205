"""ZeRO-Offload in the port's engine (`deepspeed_tpu_torch/runtime/
engine.py`) against the JAX package's offload engine on the same config,
params and batches (``gpt2_tiny`` with flash attention, params made in
JAX and carried across with ``convert_gpt2_params``).

ZeRO needs fp16 or bf16 in both packages, so every case is 16-bit:
losses within rtol 2e-2 over 4 steps, the tolerance of the port's
dense-engine bf16 tests (both frameworks round activations to 16 bits
at different places); the overflow-skip counters exactly. Then the
port's own contract: what crosses to the host (bf16 with
``offload_16bit_grads`` under bf16, fp32 under fp16, as JAX's
``tests/unit/test_cpu_adam.py::test_offload_16bit_grads_wire_dtype``
pins), the device params equal to bf16(masters) bit for bit, no fp32
param on the device, and the config checks JAX makes.

JAX is imported inside the parity tests only, so the ``cuda`` cases run
on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_offload.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)

STEPS = 4
T = 32
RTOL_16BIT = 2e-2

BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
OFFLOAD = {"stage": 2, "cpu_offload": True}
CASES = {
    "bf16_16bit_grads": dict(
        BASE, bf16={"enabled": True},
        zero_optimization=dict(OFFLOAD, offload_16bit_grads=True)),
    "bf16_chunk_1mb": dict(
        BASE, bf16={"enabled": True},
        zero_optimization=dict(OFFLOAD, offload_chunk_mb=1)),
    "bf16_small_chunks_accum2_clip_adamw": dict(
        BASE, bf16={"enabled": True}, gradient_accumulation_steps=2,
        gradient_clipping=0.5,
        optimizer={"type": "AdamW",
                   "params": {"lr": 1e-3, "weight_decay": 0.1}},
        zero_optimization=dict(OFFLOAD, offload_chunk_mb=0.05,
                               offload_16bit_grads=True)),
    # at a loss scale of 2^20 the fp16 gradients overflow: the first
    # steps are skipped (the host update too) and the scale backs off
    "fp16_overflow_skip": dict(
        BASE, fp16={"enabled": True, "initial_scale_power": 20},
        zero_optimization=dict(OFFLOAD, offload_16bit_grads=True)),
}
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (8, T)).astype(np.int32)}
            for _ in range(n)]


def _dtype(name):
    return DTYPES[name.split("_")[0]]


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
    from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_engine(params, config, dtype):
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
    from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
    from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn
    from deepspeed_tpu.parallel.mesh import build_mesh
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    model = JaxGPT2(jax_tiny(dtype=jdt, use_flash_attention=True))
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=dict(config), loss_fn=make_gpt2_loss_fn(model),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        mesh=build_mesh({}, devices=jax.devices()[:1]))
    return engine


def _port_model(params, dtype, **cfg):
    model = GPT2LMHead(gpt2_tiny(dtype=dtype, use_flash_attention=True,
                                 **cfg), device="cpu")
    model.load_state_dict(convert_gpt2_params(params))
    return model


def _port_engine(params, config, dtype, **cfg):
    engine, _, _, _ = initialize(model=_port_model(params, dtype, **cfg),
                                 config=dict(config), device="cpu")
    return engine


@pytest.mark.parametrize("name", sorted(CASES))
def test_offload_engine_follows_jax(jax_params, name):
    config = CASES[name]
    dtype = _dtype(name)
    jeng = _jax_engine(jax_params, config, dtype)
    teng = _port_engine(jax_params, config, dtype)
    want = [float(jeng.train_batch(b)) for b in _batches()]
    got = [float(teng.train_batch(b)) for b in _batches()]
    np.testing.assert_allclose(got, want, rtol=RTOL_16BIT)
    assert teng.skipped_steps == int(jeng.device_state.skipped_steps)
    assert teng.cpu_optimizer._step == jeng.cpu_optimizer._step
    assert teng.global_steps == jeng.global_steps == STEPS
    if name.startswith("fp16"):
        assert 0 < teng.skipped_steps < STEPS
    # the masters, leaf by leaf (the two flat layouts order leaves
    # differently). An Adam step moves an element by about lr at most, so
    # where the 16-bit gradients of the two frameworks differ in sign
    # (elements near 0) the masters part by up to 2 lr a step; over all
    # elements the two updates agree within 10% (norm of the difference
    # over the norm of JAX's update)
    want_m = convert_gpt2_params(jeng.cpu_optimizer.params())
    start = convert_gpt2_params(jax_params)
    names = [n for n, _ in teng.module.named_parameters()]
    got_u, want_u = [], []
    for name, leaf in zip(names, teng.cpu_optimizer.params()):
        np.testing.assert_allclose(leaf.numpy(), want_m[name].numpy(),
                                   atol=2 * STEPS * 1e-3, err_msg=name)
        got_u.append((leaf - start[name]).reshape(-1))
        want_u.append((want_m[name] - start[name]).reshape(-1))
    got_u, want_u = torch.cat(got_u), torch.cat(want_u)
    assert float((got_u - want_u).norm() / want_u.norm()) < 0.1


@pytest.mark.parametrize("name,wire", [("bf16_16bit_grads", torch.bfloat16),
                                       ("bf16_chunk_1mb", torch.float32),
                                       ("fp16_overflow_skip", torch.float32)])
def test_wire_dtype_matches_jax(jax_params, name, wire):
    """bf16 gradients reach the host only with offload_16bit_grads under
    bf16; under fp16 the flag is inert (fp32 on the wire), as in JAX."""
    teng = _port_engine(jax_params, CASES[name], _dtype(name))
    seen = []
    real = teng.cpu_optimizer.step_overlapped

    def spy(grads, **kw):
        seen.append(grads.dtype)
        return real(grads, **kw)

    teng.cpu_optimizer.step_overlapped = spy
    for b in _batches():
        teng.train_batch(b)
    assert seen and set(seen) == {wire}


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_params_are_bf16_of_the_host_masters(jax_params, name):
    dtype = _dtype(name)
    teng = _port_engine(jax_params, CASES[name], dtype)
    for b in _batches(3):
        teng.train_batch(b)
    opt = teng.cpu_optimizer
    assert torch.equal(teng._dev_flat, opt.master.to(dtype))
    assert {p.dtype for p in teng.module.parameters()} == {dtype}
    for p, leaf in zip(teng.params, opt.params()):
        assert p.data_ptr() >= teng._dev_flat.data_ptr()
        assert torch.equal(p, leaf.to(dtype))


def test_offload_keeps_fp32_grad_accumulation_across_micro_batches(
        jax_params):
    """The fp32 carry: accumulating two micro-batches' bf16 gradients in
    fp32 equals their fp32 sum, not a bf16 one."""
    teng = _port_engine(jax_params, CASES[
        "bf16_small_chunks_accum2_clip_adamw"], torch.bfloat16)
    batch = {k: torch.as_tensor(v) for k, v in _batches(1)[0].items()}
    grads = []
    for i in range(2):
        loss = teng.forward({k: v[i * 4:(i + 1) * 4] for k, v in
                             batch.items()})
        loss.backward()
        grads.append([p.grad.float().clone() for p in teng.params])
        for p in teng.params:
            p.grad = None
    teng._grad32.zero_()
    for i in range(2):
        teng.backward(teng.forward({k: v[i * 4:(i + 1) * 4]
                                    for k, v in batch.items()}))
    for view, g0, g1 in zip(teng._grad32_views, *grads):
        assert torch.equal(view, g0 + g1)
    teng.step()
    assert teng.global_steps == 1 and teng.cpu_optimizer._step == 1


def test_offload_config_checks(jax_params):
    base = CASES["bf16_16bit_grads"]
    # offload takes adam / adamw only (JAX asserts it)
    with pytest.raises(AssertionError, match="adam/adamw, got lamb"):
        _port_engine(jax_params, dict(
            base, optimizer={"type": "Lamb", "params": {}}), torch.bfloat16)
    with pytest.raises(ValueError, match="offload_chunk_mb"):
        _port_engine(jax_params, dict(base, zero_optimization=dict(
            OFFLOAD, offload_chunk_mb=0)), torch.bfloat16)
    with pytest.raises(AssertionError, match="fp16 or bf16"):
        _port_engine(jax_params, dict(BASE, zero_optimization=OFFLOAD),
                     torch.float32)
    # a stage without offload runs the dense ZeRO path
    eng = _port_engine(jax_params, dict(base, zero_optimization={"stage": 2}),
                       torch.bfloat16)
    assert eng.zero_optimization_stage() == 2 and eng.cpu_optimizer is None
    # the legacy boolean form is stage 1
    eng = _port_engine(jax_params, dict(base, zero_optimization=True),
                       torch.bfloat16)
    assert eng.zero_optimization_stage() == 1 and eng.cpu_optimizer is None
    # one process: the offload step is not the one across processes
    eng = _port_engine(jax_params, base, torch.bfloat16)
    assert eng.dp_world_size == 1 and not eng._offload_dp
    # stage 3 with offload runs the offload path, as in JAX
    eng = _port_engine(jax_params, dict(base, zero_optimization=dict(
        OFFLOAD, stage=3)), torch.bfloat16)
    assert eng.zero_optimization() and eng.zero_optimization_stage() == 3
    assert eng.cpu_optimizer is not None and eng.opt_state is None


def test_initialize_leaves_the_host_model_unmoved_until_offload(
        jax_params):
    """The masters are taken from the caller's host params; the device
    (here the CPU standing in) gets only the compute-dtype copy, and the
    engine never holds fp32 params."""
    model = _port_model(jax_params, torch.bfloat16)
    host = {n: p.detach().clone() for n, p in model.named_parameters()}
    engine, _, _, _ = initialize(model=model, config=CASES[
        "bf16_16bit_grads"], device="cpu")
    opt = engine.cpu_optimizer
    names = [n for n, _ in model.named_parameters()]
    for name, leaf in zip(names, opt.params()):
        assert torch.equal(leaf, host[name])
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_engine(config, seed=0, **cfg):
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16,
                                 use_flash_attention=True, **cfg),
                       device="cpu", generator=gen)
    engine, _, _, _ = initialize(model=model, config=dict(config))
    return engine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_offload_on_the_card_keeps_bf16_params_and_pinned_buffers(cuda):
    engine = _cuda_engine(CASES["bf16_16bit_grads"], n_embd=128)
    opt = engine.cpu_optimizer
    for buf in (opt.master, opt.exp_avg, opt.exp_avg_sq, opt._grad_buf,
                opt._landing, opt._bf16_buf):
        assert buf.is_pinned()
    for b in _batches(3):
        loss = engine.train_batch(b)
    assert np.isfinite(float(loss))
    assert all(p.is_cuda and p.dtype == torch.bfloat16
               for p in engine.module.parameters())
    torch.cuda.synchronize()
    assert torch.equal(engine._dev_flat.cpu(), opt.master.to(torch.bfloat16))
    stats = engine.host_phase_stats()
    assert stats["d2h_bytes"] == 2 * opt.total
    assert stats["h2d_bytes"] == 2 * opt.total


@pytest.mark.cuda
def test_overlapped_host_phase_equals_the_serial_one_on_the_card(cuda):
    """The pipelined host phase (small chunks) against a one-chunk one
    and against the host Adam's serial step on the same gradients."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    small = dict(CASES["bf16_16bit_grads"], zero_optimization=dict(
        OFFLOAD, offload_16bit_grads=True, offload_chunk_mb=0.05))
    whole = dict(CASES["bf16_16bit_grads"], zero_optimization=dict(
        OFFLOAD, offload_16bit_grads=True, offload_chunk_mb=1024))
    a = _cuda_engine(small, n_embd=128)
    b = _cuda_engine(whole, n_embd=128)
    serial = DeepSpeedCPUAdam(a.cpu_optimizer.params(), lr=1e-3)
    for batch in _batches(3):
        la, lb = a.train_batch(batch), b.train_batch(batch)
        assert float(la) == float(lb)
        serial.step([a.cpu_optimizer._grad_buf[o:o + s]
                     for o, s in zip(a.cpu_optimizer.offsets,
                                     a.cpu_optimizer.sizes)])
        assert torch.equal(a.cpu_optimizer.master, b.cpu_optimizer.master)
        assert torch.equal(a.cpu_optimizer.master, serial.master)
