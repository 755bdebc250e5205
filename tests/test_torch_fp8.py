"""fp8 delayed scaling and the stage-3 fp8 wire in the port
(`deepspeed_tpu_torch/ops/fp8.py`, the engine's fp8 state,
`runtime/comm/codecs.py`, `runtime/zero/stage3.py`).

- ``compute_scale``, ``update_history`` and ``quantize_dequantize``
  equal JAX's bit for bit (e4m3 and e5m2, f32 and bf16, margins 0 and
  2, an all-zero history).
- The engine's state keys are JAX's discovery, in order (site overrides
  included); the histories after a step of accumulation 2 equal JAX's
  (rtol 1e-5: amaxes of activations and cotangents summed in other
  orders); a remat
  run's histories and losses equal the plain run's bit for bit; an fp16
  step that overflows keeps the old histories, as JAX's does.
- An fp8 run in bf16 follows JAX's fp8 run within the bf16 engine
  tolerance (rtol 2e-2, ``tests/test_torch_train_engine.py``).
- ``encode_wire`` / ``decode_wire`` give JAX's bytes and values, and at
  world 2 (gloo, ``tests/torch_zero_worker.py``) stage 3's wire-gathered
  params hold each rank's own piece exactly and the other's as JAX's
  codec decodes it, bit for bit, and JAX's ``make_gather_on_use_caster``
  with the wire within one fp8 step; the wire moves ``wire_nbytes`` a
  gather. With fp8 matmuls on as well, the run's losses follow JAX's
  (rtol 2e-2) and both ranks hold the same (MAX-reduced) histories.
- fp8 with ``scan_layers`` equals JAX's: the scanned body's keys twice
  over (the first half never runs), one key a site shared by the layers,
  their histories summed (``ROADMAP.md`` section 3); remat changes no
  bit of it.
- Under progressive layer drop each sublayer keeps its keys (a dropped
  one's histories are zero), as JAX's ``lax.cond`` does; under
  ``scan_layers`` a dropped sublayer runs gated, as JAX's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn as jax_loss_fn
from deepspeed_tpu.ops import fp8 as jfp8
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.comm import codecs as jcodecs
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead, convert_gpt2_params, gpt2_tiny, stack_gpt2_state_dict)
from deepspeed_tpu_torch.ops import fp8 as tfp8
from deepspeed_tpu_torch.runtime.comm import codecs as tcodecs
from tests import torch_zero_harness as H
from tests.torch_threads import one_thread  # noqa: F401

BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "fp8": {"enabled": True, "amax_history_len": 4}}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("margin", [0, 2])
def test_qdq_and_scales_equal_jax_bitwise(dtype, margin):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 48)) *
         np.exp(rng.uniform(-9, 9, (64, 48)))).astype(np.float32)
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(JDT[dtype])
    for hist in (np.zeros(4, np.float32),
                 np.array([3.5, 1e4, 0.0, 7e-3], np.float32)):
        for qmax, tdt, jdt in ((448.0, torch.float8_e4m3fn,
                                jnp.float8_e4m3fn),
                               (57344.0, torch.float8_e5m2,
                                jnp.float8_e5m2)):
            ts = tfp8.compute_scale(torch.from_numpy(hist), qmax, margin)
            js = jfp8.compute_scale(jnp.asarray(hist), qmax, margin)
            np.testing.assert_array_equal(_np(ts), _np(js))
            got = tfp8.quantize_dequantize(tx, ts, qmax, tdt)
            want = jfp8.quantize_dequantize(jx, js, qmax, jdt)
            assert got.dtype == dtype
            np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(
            _np(tfp8.update_history(torch.from_numpy(hist), tx)),
            _np(jfp8.update_history(jnp.asarray(hist), jx)))


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}
            for _ in range(n)]


def _jax_run(params, config, dtype=jnp.float32, n=3, **model_kw):
    model = JaxGPT2(jax_tiny(dtype=dtype, use_flash_attention=True,
                             **model_kw))
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=dict(config), loss_fn=jax_loss_fn(model), params=params,
        mesh=build_mesh({}, devices=jax.devices()[:1]))
    losses = [float(engine.train_batch(b)) for b in _batches(n)]
    return losses, engine


def _port_run(params, config, dtype=torch.float32, n=3, **model_kw):
    model = GPT2LMHead(gpt2_tiny(dtype=dtype, use_flash_attention=True,
                                 **model_kw), device="cpu")
    sd = convert_gpt2_params(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict(stack_gpt2_state_dict(sd)
                          if model_kw.get("scan_layers") else sd)
    engine, _, _, _ = initialize(model=model, config=dict(config),
                                 device="cpu")
    losses = [float(engine.train_batch(b)) for b in _batches(n)]
    return losses, engine


def _histories(state):
    return {k: {s: _np(v) for s, v in b.items()} for k, b in state.items()}


def _jax_discovery(params, fp8):
    """The keys JAX's discovery pass records, in call order (the
    engine's state dict itself is a pytree, its keys sorted)."""
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    plan = jfp8.Fp8Plan(sites=fp8.get("sites") or {})
    keys = []
    batch = {"input_ids": jnp.asarray(_batches(1)[0]["input_ids"][:4])}

    def probe(p):
        with jfp8.fp8_scope(plan, None, keys):
            return jax_loss_fn(model)(p, batch, None)

    jax.eval_shape(probe, params)
    return keys


@pytest.mark.parametrize("sites", [None, {"c_fc": {"enabled": False}}],
                         ids=["all", "no_c_fc"])
def test_keys_and_accumulated_histories_equal_jax(jax_params, sites):
    fp8 = dict(BASE["fp8"], **({"sites": sites} if sites else {}))
    config = dict(BASE, gradient_accumulation_steps=2, fp8=fp8)
    want_l, jeng = _jax_run(jax_params, config, n=1)
    got_l, teng = _port_run(jax_params, config, n=1)
    assert teng._fp8_keys == _jax_discovery(jax_params, fp8)
    assert sorted(teng._fp8_keys) == list(jeng._fp8_state)
    if sites:
        assert not any(k.startswith("c_fc") for k in teng._fp8_keys)
    want = _histories(jeng._fp8_state)
    got = _histories(teng.fp8_state)
    for key, bundle in want.items():
        for slot, h in bundle.items():
            assert h[0] > 0 and (h[1:] == 0).all(), (key, slot)
            np.testing.assert_allclose(got[key][slot], h, rtol=1e-5,
                                       err_msg=f"{key}/{slot}")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)


def test_remat_rolls_the_histories_once_per_step(jax_params):
    plain_l, plain = _port_run(jax_params, BASE)
    remat_l, remat = _port_run(jax_params, BASE, remat=True)
    dots_l, dots = _port_run(jax_params, BASE, remat=True,
                             remat_policy="dots")
    assert remat_l == plain_l == dots_l
    for eng in (remat, dots):
        assert torch.equal(eng._fp8_flat, plain._fp8_flat)
    # the first step's histories against JAX's (later steps drift with
    # Adam's amplification of fp32 noise)
    want = _histories(_jax_run(jax_params, BASE, n=1)[1]._fp8_state)
    for key, bundle in _histories(_port_run(jax_params, BASE, n=1,
                                            remat=True)[1]
                                  .fp8_state).items():
        for slot, h in bundle.items():
            np.testing.assert_allclose(h, want[key][slot], rtol=1e-5)
    # 3 steps of history 4: the oldest slot is still empty
    assert (plain._fp8_flat[:, :, :3] > 0).all()
    assert (plain._fp8_flat[:, :, 3] == 0).all()


def test_an_overflowed_step_keeps_the_old_histories(jax_params):
    config = dict(BASE, fp16={"enabled": True, "initial_scale_power": 31})
    _, jeng = _jax_run(jax_params, config, jnp.float16, n=1)
    _, teng = _port_run(jax_params, config, torch.float16, n=1)
    assert bool(jeng._last_metrics["overflow"])
    assert bool(teng._last_metrics["overflow"])
    for eng_state in (_histories(jeng._fp8_state),
                      _histories(teng.fp8_state)):
        assert all((h == 0).all() for b in eng_state.values()
                   for h in b.values())
    # the port's step with an inf put into one gradient, after a clean
    # step: every history stays what the clean step left
    _, teng = _port_run(jax_params, BASE, n=1)
    before = teng._fp8_flat.clone()
    teng._config.fp16_enabled = True      # the overflow vote runs
    batch = _batches(1)[0]
    loss = teng.forward(batch)
    teng.backward(loss)
    teng._grads[0].view(-1)[0] = float("inf")
    teng.step()
    assert bool(teng._last_metrics["overflow"])
    assert torch.equal(teng._fp8_flat, before)


def test_bf16_fp8_run_follows_jax(jax_params):
    config = dict(BASE, bf16={"enabled": True})
    want, _ = _jax_run(jax_params, config, jnp.bfloat16, n=4)
    got, teng = _port_run(jax_params, config, torch.bfloat16, n=4)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    plain, _ = _port_run(jax_params, dict(config, fp8={"enabled": False}),
                         torch.bfloat16, n=4)
    assert got != plain         # the fp8 matmuls ran


def _scanned(params):
    from deepspeed_tpu.models.gpt2 import stack_gpt2_layer_params
    return stack_gpt2_layer_params(params)


@pytest.mark.parametrize("accum", [1, 2])
def test_fp8_with_scan_layers_equals_jax(jax_params, accum):
    """JAX's scanned model traces its block twice under ``fp8_scope``
    (flax's shape pass, whose keys never run, then the scan body), so
    its state has the body's keys twice over, the first half stays zero,
    and every layer uses the second half: a key's updated history is the
    sum of the layers' (the cotangent of a value closed over by
    ``lax.scan``), max-combined over micro-batches. The port's keys,
    histories (rtol 1e-5: amaxes summed in other orders) and losses
    (rtol 1e-4) are JAX's."""
    config = dict(BASE, gradient_accumulation_steps=accum)
    want_l, jeng = _jax_run(_scanned(jax_params), config, n=1,
                            scan_layers=True)
    got_l, teng = _port_run(jax_params, config, n=1, scan_layers=True)
    assert teng._fp8_keys == ["c_attn:0", "c_proj:0", "c_fc:0", "c_proj:1",
                              "c_attn:1", "c_proj:2", "c_fc:1", "c_proj:3"]
    assert sorted(teng._fp8_keys) == list(jeng._fp8_state)
    want = _histories(jeng._fp8_state)
    got = _histories(teng.fp8_state)
    for key, bundle in want.items():
        live = key in teng._fp8_keys[4:]
        for slot, h in bundle.items():
            assert (h[0] > 0) == live, (key, slot)
            np.testing.assert_allclose(got[key][slot], h, rtol=1e-5,
                                       err_msg=f"{key}/{slot}")
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    # the sum over the layers: with a non-zero history the older slots
    # are n_layer times the input's
    state = teng._fp8_flat.clone()
    batch = {"input_ids": torch.from_numpy(_batches(1)[0]["input_ids"])}
    new = torch.zeros_like(state)
    with tfp8.fp8_scope(teng._fp8_plan,
                        tfp8.unflatten_state(state, teng._fp8_keys),
                        tfp8.unflatten_state(new, teng._fp8_keys)):
        loss = teng.module.loss_fn(batch, None)
    loss.backward()
    n_layer = teng.module.config.n_layer
    assert torch.equal(new[4:, :, 1:], n_layer * state[4:, :, :-1])
    assert not new[:4].any()


def test_fp8_with_scan_layers_under_remat_equals_plain(jax_params):
    """A recompute records nothing, so remat leaves the scanned model's
    summed histories and losses bit for bit as they are."""
    config = dict(BASE, gradient_accumulation_steps=2)
    plain_l, plain = _port_run(jax_params, config, n=2, scan_layers=True)
    for policy in ("full", "dots"):
        got_l, eng = _port_run(jax_params, config, n=2, scan_layers=True,
                               remat=True, remat_policy=policy)
        assert got_l == plain_l
        assert torch.equal(eng._fp8_flat, plain._fp8_flat)


def _pld_model(scan_layers):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32, n_layer=4,
                                 scan_layers=scan_layers), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    keys = []
    batch = {"input_ids": torch.from_numpy(
        _batches(1)[0]["input_ids"][:4])}
    with torch.no_grad(), tfp8.fp8_scope(tfp8.Fp8Plan(amax_history_len=4),
                                         discover=keys):
        model.loss_fn(batch, None)
    return model, keys, batch


def _pld_step(model, keys, batch, seed, theta):
    """One forward and backward at PLD ``theta`` from zero histories:
    the updated histories and the forward's coins."""
    plan = tfp8.Fp8Plan(amax_history_len=4)
    state = torch.zeros(len(keys), 3, 4)
    new = torch.zeros_like(state)
    with tfp8.fp8_scope(plan, tfp8.unflatten_state(state, keys),
                        tfp8.unflatten_state(new, keys)):
        loss = model.loss_fn(batch, seed, pld_theta=theta)
    loss.backward()
    return new, model.last_pld_coins


def test_fp8_keys_under_pld_stay_with_their_layers():
    """JAX's ``lax.cond`` traces the untaken branch, so each sublayer
    keeps its state keys whatever the coins, and a dropped one's
    histories come back zero. A key's ``kernel`` history holds the amax
    of the weight that used it: for every kept sublayer it equals the
    run at theta 1 (its own layer's weight), and a dropped sublayer's
    bundle is zero, also where a later sublayer was kept."""
    model, keys, batch = _pld_model(False)
    full, _ = _pld_step(model, keys, batch, 0, 1.0)
    assert (full[:, :, 0] > 0).all()
    for seed in range(64):
        new, coins = _pld_step(model, keys, batch, seed, 0.3)
        flat = [c for pair in coins for c in pair]
        if False in flat and True in flat[flat.index(False):]:
            break
    else:
        raise AssertionError("no draw dropped a sublayer before a kept one")
    L = len(coins)
    for i, (keep_a, keep_m) in enumerate(coins):
        for key, kept in ((f"c_attn:{i}", keep_a),
                          (f"c_proj:{2 * i}", keep_a),
                          (f"c_fc:{i}", keep_m),
                          (f"c_proj:{2 * i + 1}", keep_m)):
            row = keys.index(key)
            if kept:
                assert torch.equal(new[row, 1], full[row, 1]), key
                assert (new[row, :, 0] > 0).all(), key
            else:
                assert not new[row].any(), key
    assert len(keys) == 4 * L


def test_fp8_keys_under_pld_with_scan_layers_run_the_gated_sublayers():
    """JAX's scanned block gates a dropped sublayer by 0 instead of
    skipping it, so its sites still run and record: the summed
    ``kernel`` histories are the theta-1 run's (every layer's weight)."""
    model, keys, batch = _pld_model(True)
    full, _ = _pld_step(model, keys, batch, 0, 1.0)
    for seed in range(64):
        new, coins = _pld_step(model, keys, batch, seed, 0.3)
        if not all(c for pair in coins for c in pair):
            break
    else:
        raise AssertionError("no draw dropped a sublayer")
    assert torch.equal(new[:, 1], full[:, 1])
    assert not new[:4].any() and (new[4:, :2, 0] > 0).all()


@pytest.mark.parametrize("block,err", [
    ({"fp8": {"enabled": True}, "sparse_gradients": True}, None),
    ({"fp8": {"enabled": True}, "zero_optimization": {
        "stage": 2, "cpu_offload": True}, "bf16": {"enabled": True}}, None),
    ({"fp8": {"enabled": True, "margin": -1}}, None),
    ({"fp8": {"enabled": True, "sites": {"c_fc": {"on": True}}}}, None),
    ({"fp8": {"wire": {"enabled": True, "dtype": "int4"}}}, None),
    ({"fp8": {"wire": {"enabled": True, "chunk_size": 0}}}, None)])
def test_config_checks_raise_as_jax(block, err):
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = dict({"train_batch_size": 8}, **block)
    with pytest.raises(ValueError) as want:
        JaxConfig(cfg, world_size=1)
    with pytest.raises(ValueError) as got:
        DeepSpeedConfig(cfg)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", sorted(tcodecs.CODECS))
@pytest.mark.parametrize("n,chunk", [(1000, 64), (37, 512), (512, 512)])
def test_wire_round_trip_equals_jax(codec, n, chunk):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    x[:5] = 0.0
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        tx = torch.from_numpy(x).to(dtype)
        jx = jnp.asarray(x).astype(jdt)
        tw = tcodecs.encode_wire(tx, codec, chunk)
        jw = jcodecs.encode_wire(jx, codec, chunk)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert tw.numel() == tcodecs.wire_nbytes((n,), codec, chunk) == \
            jcodecs.wire_nbytes((n,), codec, chunk)
        np.testing.assert_array_equal(
            _np(tcodecs.decode_wire(tw, codec, (n,), dtype, chunk)),
            _np(jcodecs.decode_wire(jw, codec, (n,), jdt, chunk)))


WIRE = {"enabled": True, "dtype": "f8e4m3fn", "chunk_size": 64}


def _jax_wire_reference(params, case):
    """One JAX engine: its gather-on-use caster's output on the initial
    params, by rank, the bf16 params whole, then its run's losses and
    fp8 keys."""
    from deepspeed_tpu.runtime.zero.stage3 import make_gather_on_use_caster
    engine, mesh = H.jax_engine(params, case, 2)
    cast, plan = make_gather_on_use_caster(
        engine.params, engine._shardings["param"], mesh, jnp.bfloat16,
        wire_dtype=WIRE["dtype"], wire_chunk=WIRE["chunk_size"])
    out = jax.jit(cast)(engine.params)
    devices = list(mesh.devices.reshape(-1))
    whole = convert_gpt2_params(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)).astype(np.float32),
        engine.params))
    casters = [convert_gpt2_params(jax.tree_util.tree_map(
        lambda a: next(np.asarray(s.data).astype(np.float32)
                       for s in a.addressable_shards if s.device == d), out))
        for d in devices]
    losses = [float(engine.train_batch({"input_ids": x}))
              for x in H.jax_batches(case)]
    return {"casters": casters, "whole": whole, "losses": losses,
            "fp8_keys": list(engine._fp8_state),
            "wire_dtype": plan.wire_dtype}


@pytest.fixture(scope="module")
def wire_world(tmp_path_factory):
    """The port's two-rank run, and JAX's reference computed in this
    process while the ranks run."""
    root = tmp_path_factory.mktemp("fp8_wire")
    params = H.init_jax_params(use_flash_attention=False)
    state = H.save_port_state(params, root / "tiny.npz")
    case = dict(kind="wire", dtype="bf16", flash=False, stage=3,
                name="wire", keys={"fp8": {"enabled": True, "wire": WIRE}})
    procs = H.start_world(2, [case], state, root / "out")
    try:
        ref = _jax_wire_reference(params, case)
    except BaseException:
        H.stop_world(procs)
        raise
    H.wait_world(procs)
    return ref, H.load_results(root / "out", "wire", 2)


def test_stage3_wire_gathers_equal_jax(wire_world):
    """Rank r's gathered leaf: its own piece exact, the other rank's
    piece JAX's ``decode_wire(encode_wire(piece))`` bit for bit. JAX's
    jitted caster itself differs from its own codec functions by one fp8
    step on a few chunks (XLA rewrites the per-chunk division), so the
    port is held to the caster within one e4m3 step (rtol 1/8)."""
    ref, rows = wire_world
    whole = ref["whole"]
    for rank, (arrays, meta) in enumerate(rows):
        caster = ref["casters"][rank]
        for name, w in caster.items():
            got = arrays[f"gathered/{name}"]
            np.testing.assert_allclose(got, w.numpy(), rtol=0.125,
                                       atol=1e-6, err_msg=name)
            if name not in meta["pieces"]:
                np.testing.assert_array_equal(got, whole[name].numpy())
        assert meta["plan"]["wire_dtype"] == WIRE["dtype"] == \
            ref["wire_dtype"]
        want_bytes = sum(2 * tcodecs.wire_nbytes(s, WIRE["dtype"], 64)
                         for s in meta["pieces"].values())
        assert meta["counts"]["all_gather"]["bytes"] == want_bytes
        assert np.isfinite(arrays["losses"]).all()
    # fp8 matmuls over the wire-gathered params, histories MAX-reduced
    # over the two ranks: JAX's run within the bf16 engine tolerance
    for arrays, meta in rows:
        np.testing.assert_allclose(arrays["losses"], ref["losses"],
                                   rtol=2e-2)
        assert sorted(meta["fp8_keys"]) == ref["fp8_keys"]
    np.testing.assert_array_equal(rows[0][0]["fp8"], rows[1][0]["fp8"])
    # the pieces: rank r's own exact, the other's JAX's eager codec
    wte = whole["wte"].numpy()          # split along dim 0 at world 2
    half = wte.shape[0] // 2
    for rank, (arrays, _) in enumerate(rows):
        got = arrays["gathered/wte"]
        own = slice(rank * half, (rank + 1) * half)
        other = slice((1 - rank) * half, (2 - rank) * half)
        np.testing.assert_array_equal(got[own], wte[own])
        piece = jnp.asarray(wte[other]).astype(jnp.bfloat16)
        dec = jcodecs.decode_wire(
            jcodecs.encode_wire(piece, WIRE["dtype"], 64), WIRE["dtype"],
            piece.shape, jnp.bfloat16, 64)
        np.testing.assert_array_equal(got[other], _np(dec))
