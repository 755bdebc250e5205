"""The gradient compressors across processes: one gloo world of 2
``tests/torch_tp_worker.py`` processes (the runners of
``tests/torch_onebit_cases.py``) runs every data-parallel case, held to
the JAX package on the same seeded inputs:

- the chunk-server pair (what each rank receives; the calls, bytes and
  dtypes ``collective_counts()`` records);
- the int8 and the 1-bit all-reduce over gloo, two calls each with the
  residuals carried: bit for bit the per-rank arithmetic of
  ``tests/test_torch_comm_compress.py`` (the exchange only moves bytes),
  every rank the same average;
- 1-bit Adam's update at world 2 against JAX's under ``shard_map``, both
  branches (rtol 1e-6: the same f32 formula; the compressed branch's
  scales within f32 reduction order);
- the engine on JAX's ``test_quantized_parity`` MLP (its flat layout, so
  the int8 chunks hold the same elements): ``comm_quantization`` at ZeRO
  0, at ZeRO 2 with accumulation 2 and error feedback (bf16), under fp16
  with overflowing steps, and 1-bit Adam (freeze_step 2, by name and as
  a client object, checkpointed and resumed), each against JAX's
  ``initialize()`` at data 2. Both ranks' params are bit for bit equal
  after every step.

Engine tolerances: the f32 gradients of the two frameworks differ by
matmul summation order (~1e-7 relative); the int8 exchange moves an
element on a rounding edge by one step (1/127 of its chunk's absmax),
and Adam's step is lr-sized, so the f32 loss curves stay within rtol
1e-4 over 6 steps (JAX's own pin against the fp32 sync is 5e-3). bf16
rounds the params the two frameworks cast (the same) and the products
(in another order): rtol 2e-3. 1-bit Adam's warmup is Adam without bias
correction on the dense mean (rtol 1e-6 against the port's own K4 run);
after the freeze each rank's momentum signs and scales are the same
f32 functions of the same values, so the curves stay within rtol 1e-4
of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.runtime.fp16 import onebit_adam as jo
from deepspeed_tpu.utils.compat import shard_map
from tests import torch_onebit_cases as OC
from tests import torch_zero_harness as H
from tests.test_torch_comm_compress import port_compressed, port_quantized

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
WORLD, STEPS = 2, 6
# eps 1e-4: at 1e-8 a param whose gradient stayed 0 through the warmup (a
# dead ReLU's bias) steps by lr x scale / eps after the freeze, and both
# frameworks' runs blow up to nan by step 6
ONEBIT = {"type": "OneBitAdam",
          "params": {"lr": 1e-3, "freeze_step": 2, "eps": 1e-4}}
QCOMM = {"enabled": True, "chunk_size": 64, "bucket_mb": 1}


def mlp_case(name, **kw):
    return dict({"name": name, "kind": "mlp", "mesh": {"data": WORLD},
                 "world": WORLD, "steps": STEPS}, **kw)


CASES = {
    "q0": mlp_case("q0", keys={"comm_quantization": QCOMM}),
    "q2": mlp_case("q2", accum=2, keys={
        "comm_quantization": dict(QCOMM, error_feedback=True),
        "zero_optimization": {"stage": 2}, "bf16": {"enabled": True}}),
    "q16": mlp_case("q16", keys={
        "comm_quantization": QCOMM,
        "fp16": {"enabled": True, "initial_scale_power": 24}}),
    "ob": mlp_case("ob", keys={"optimizer": ONEBIT}, ckpt=3),
    "nobias": mlp_case("nobias", keys={"optimizer": {
        "type": "Adam", "params": {"lr": 1e-3, "eps": 1e-4,
                                   "bias_correction": False}}}),
}
CLIENT = mlp_case("ob_client", client={"lr": 1e-3, "freeze_step": 2,
                                       "eps": 1e-4})
EXCHANGES = {"name": "exchanges", "kind": "exchanges",
             "mesh": {"data": WORLD}, "seed": 11, "n_int8": WORLD * 64 * 3,
             "chunk": 64, "n_1bit": 100}


def jax_params():
    keys = jax.random.split(jax.random.PRNGKey(0), OC.NLAYERS)
    return {f"linear_{i}": {
        "kernel": jax.random.normal(k, (OC.HIDDEN, OC.HIDDEN),
                                    jnp.float32) * 0.05,
        "bias": jnp.zeros((OC.HIDDEN,), jnp.float32)}
        for i, k in enumerate(keys)}


def jax_loss(params, batch, rng=None):
    x = batch["x"]
    for i in range(OC.NLAYERS):
        layer = params[f"linear_{i}"]
        x = x @ layer["kernel"] + layer["bias"]
        if i < OC.NLAYERS - 1:
            x = jax.nn.relu(x)
    return jnp.mean(jnp.square(x - batch["y"]))


def jax_run(case):
    cfg = OC.mlp_config(case)
    engine, _, _, _ = deepspeed_tpu.initialize(
        params=jax_params(), loss_fn=jax_loss, config=cfg,
        mesh=build_mesh({"data": WORLD}, devices=jax.devices()[:WORLD]))
    losses, engine.errors = [], []
    for b in OC.mlp_batches(case.get("accum", 1), STEPS):
        losses.append(float(engine.train_batch(b)))
        if hasattr(engine.opt_state, "worker_error"):
            engine.errors.append(np.asarray(engine.opt_state.worker_error))
    return np.array(losses), engine


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("onebit_dp")
    flat = {f"linear_{i}.{k}": np.asarray(v)
            for i in range(OC.NLAYERS)
            for k, v in jax_params()[f"linear_{i}"].items()}
    np.savez(root / "mlp.npz", **flat)
    cases = [EXCHANGES, CLIENT] + list(CASES.values())
    H.spawn_world(WORLD, cases, root / "mlp.npz", root / "w", worker=WORKER)
    jax_ref = {name: jax_run(c) for name, c in CASES.items()
               if name != "nobias"}
    return root, jax_ref


def res(root, name):
    return H.load_results(root / "w", name, WORLD)


def test_chunk_server_pair_over_gloo(world):
    root, _ = world
    for r, (a, meta) in enumerate(res(root, "exchanges")):
        want = np.stack([np.arange(r * 3, r * 3 + 3) + 100.0 * s
                         for s in range(WORLD)])
        assert np.array_equal(a["scatter"], want)
        assert np.array_equal(a["scatter_i8"],
                              np.repeat(np.arange(WORLD, dtype=np.int8)[
                                  :, None], 5, axis=1))
        assert np.array_equal(a["gather"], np.arange(WORLD, dtype=float))
        counts = meta["pair_counts"]
        # the whole stack counted: 2 x 3 f32 and 2 x 5 int8
        assert counts["all_to_all"] == {
            "calls": 2, "bytes": 34, "dtypes": {"float32": 24, "int8": 10}}
        assert counts["all_gather"] == {
            "calls": 1, "bytes": 8, "dtypes": {"float32": 8}}


def test_allreduces_over_gloo_equal_the_arithmetic(world):
    root, _ = world
    ranks = res(root, "exchanges")
    rng = np.random.default_rng(EXCHANGES["seed"])
    n, c = EXCHANGES["n_int8"], EXCHANGES["chunk"]
    rw = [torch.zeros(n) for _ in range(WORLD)]
    rs = [torch.zeros(n // WORLD) for _ in range(WORLD)]
    for i in range(2):
        xs = rng.normal(size=(WORLD, n)).astype(np.float32)
        avg, rw, rs, _ = port_quantized(xs, True, c, rw, rs)
        for r, (a, _) in enumerate(ranks):
            assert np.array_equal(a[f"q/{i}/avg"], avg[0].numpy())
            assert np.array_equal(a[f"q/{i}/w"], rw[r].numpy())
            assert np.array_equal(a[f"q/{i}/s"], rs[r].numpy())
    n1 = EXCHANGES["n_1bit"]
    padded = ranks[0][0]["c/0/w"].shape[0]
    we = np.zeros((WORLD, padded), np.float32)
    se = np.zeros((WORLD, padded // WORLD), np.float32)
    for i in range(2):
        xs = np.zeros((WORLD, padded), np.float32)
        xs[:, :n1] = rng.standard_normal((WORLD, n1)).astype(np.float32)
        avg, we, se, _, _ = port_compressed(xs, we, se, n1)
        for r, (a, _) in enumerate(ranks):
            assert np.array_equal(a[f"c/{i}/avg"], avg)
            assert np.array_equal(a[f"c/{i}/w"], we[r])
            assert np.array_equal(a[f"c/{i}/s"], se[r])


def test_onebit_update_over_gloo_equals_jax(world):
    root, _ = world
    ranks = res(root, "exchanges")
    prng = np.random.default_rng(EXCHANGES["seed"] + 1)
    shapes = [(5, 7), (13,)]
    params = {f"p{j}": jnp.asarray(prng.normal(size=s).astype(np.float32))
              for j, s in enumerate(shapes)}
    grads = [[prng.normal(size=(WORLD,) + s).astype(np.float32)
              for s in shapes] for _ in range(4)]
    specs = jo.OnebitAdamState(m=P(), v=P(), step=P(),
                               worker_error=P("data", None),
                               server_error=P("data"))

    def body(p, g, s):
        return jo.onebit_adam_update(
            p, {k: v[0] for k, v in g.items()}, s, lr=jnp.float32(0.05),
            beta1=jnp.float32(0.9), beta2=0.99, eps=1e-6,
            weight_decay=0.01, freeze_step=2, axis_name="data")

    f = jax.jit(shard_map(
        body, mesh=Mesh(np.array(jax.devices()[:WORLD]), ("data",)),
        in_specs=(P(), P("data"), specs), out_specs=(P(), specs),
        check_vma=False))
    state = jo.init_onebit_state(params, WORLD)
    for i, gs in enumerate(grads):
        params, state = f(params, {f"p{j}": jnp.asarray(g)
                                   for j, g in enumerate(gs)}, state)
        for a, _ in ranks:
            for j in range(len(shapes)):
                np.testing.assert_allclose(a[f"adam/{i}/p{j}"],
                                           np.asarray(params[f"p{j}"]),
                                           rtol=1e-6, atol=1e-7)
        we = np.asarray(state.worker_error)
        for r, (a, _) in enumerate(ranks):
            np.testing.assert_allclose(a[f"adam/{i}/we"], we[r],
                                       rtol=1e-5, atol=1e-6)
        assert (np.abs(we).sum() > 0) == (i >= 2)


def _ranks_agree(ranks):
    return all(m["digests"] == ranks[0][1]["digests"] for _, m in ranks)


@pytest.mark.parametrize("name,rtol", [("q0", 1e-4), ("q2", 2e-3),
                                       ("q16", 1e-4)])
def test_quantized_engine_equals_jax(world, name, rtol):
    root, jax_ref = world
    want, engine = jax_ref[name]
    ranks = res(root, name)
    assert _ranks_agree(ranks)
    for a, meta in ranks:
        np.testing.assert_allclose(meta["losses"], want, rtol=rtol)
        # no dense gradient collective: the engine's group carried only
        # the scalar votes and (ZeRO 2) the params' refresh gather
        comm = meta["comm"]
        assert comm["all_reduce"]["calls"] == 0
        assert comm["reduce_scatter"]["calls"] == 0
        assert (comm["all_gather"]["calls"] > 0) == (name == "q2")
        # the int8 payload and its f32 chunk scales: chunk / 4 to one
        wire = meta["counts"]["all_to_all"]["dtypes"]
        assert wire["int8"] == QCOMM["chunk_size"] // 4 * wire["float32"]
    if name == "q2":
        assert all(m["residual_buckets"] == 1 for _, m in ranks)
        assert np.abs(ranks[0][0]["qres_worker"]).sum() > 0
        assert engine._qcomm_residuals is not None
    if name == "q16":
        assert 0 < int(engine.device_state.skipped_steps) < STEPS


def test_onebit_engine_equals_jax(world):
    root, jax_ref = world
    want, engine = jax_ref["ob"]
    ranks = res(root, "ob")
    nobias = res(root, "nobias")[0][1]["losses"]
    client = res(root, "ob_client")
    assert _ranks_agree(ranks) and _ranks_agree(client)
    assert np.isfinite(want).all()
    for (a, meta), (ca, cmeta) in zip(ranks, client):
        np.testing.assert_allclose(meta["losses"], want, rtol=1e-4)
        # the warmup is Adam without bias correction (steps 1-2, and
        # step 3's loss is the last warmup update's)
        np.testing.assert_allclose(meta["losses"][:3], nobias[:3],
                                   rtol=1e-6)
        assert meta["losses"][3:] != nobias[3:]
        assert meta["onebit_step"] == STEPS
        assert np.abs(a["worker_error"]).sum() > 0
        # resumed from the step-3 checkpoint: bit for bit
        assert meta["resumed"] == meta["losses"][3:]
        # the client object runs the same update
        assert cmeta["losses"] == meta["losses"]
        assert cmeta["digests"] == meta["digests"]
    # the worker residual after the first compressed step: the same f32
    # functions of momenta that differ by summation order (relative L2
    # 1e-5). Later, an element whose momentum straddles 0 between the
    # frameworks flips its sign and moves by twice the scale (measured:
    # 2 of 66048 at step 4), so later buffers are not compared
    for r, (a, _) in enumerate(ranks):
        for i in range(STEPS):
            want_we = engine.errors[i][r]
            if i < 2:
                assert not want_we.any() and not a[f"we/{i}"].any()
            elif i == 2:
                rel = np.linalg.norm(a[f"we/{i}"] - want_we) / \
                    np.linalg.norm(want_we)
                assert rel < 1e-5, rel


def test_onebit_checkpoint_at_another_world_resets_errors(world,
                                                          monkeypatch):
    """The world-2 checkpoint loaded by one process: the moments and the
    step load, the error buffers restart from zero with JAX's warning."""
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    root, _ = world
    ckpt = res(root, "ob")[0][1]["ckpt"]
    said = []
    monkeypatch.setattr(engine_mod.logger, "warning", said.append)
    case = dict(CASES["ob"], world=1)
    spec = {"state": str(root / "mlp.npz")}
    engine = OC._mlp_engine(case, spec)
    engine.load_checkpoint(ckpt, tag="t")
    assert said == ["onebit error buffers saved for a different dp world "
                    "size; resetting error feedback to zero"]
    assert int(engine.opt_state.step) == 3
    assert float(engine.opt_state.worker_error.abs().sum()) == 0.0
    assert float(sum(m.abs().sum() for m in engine.opt_state.m)) > 0


def test_onebit_refuses_zero(world):
    root, _ = world
    spec = {"state": str(root / "mlp.npz")}
    with pytest.raises(AssertionError, match="not compatible with ZeRO"):
        OC._mlp_engine(mlp_case("z", world=1, keys={
            "optimizer": ONEBIT, "zero_optimization": {"stage": 1},
            "bf16": {"enabled": True}}), spec)
