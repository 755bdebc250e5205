"""The gradient compressors' codecs and arithmetic in one process
(``runtime/comm/quantized.py``, ``runtime/comm/compressed.py``,
``runtime/fp16/onebit_adam.py``, ``parallel/collectives.py``'s
chunk-server pair, the ``comm_quantization`` config), held to the JAX
package's functions on the same numpy-seeded inputs; the JAX
all-reduces run under ``shard_map`` on the virtual CPU mesh, the port's
as its per-rank phases with the exchange done by hand (every rank's
arithmetic in this process, nothing spawned).

Derived bounds:

- int8: the first quantization of equal f32 inputs is exact (the same
  ``absmax / 127`` and the same round-half-to-even of the same
  quotient) as JAX runs it eagerly. Under ``jit`` XLA takes
  ``absmax / 127`` as a product with the reciprocal (a scale one ulp
  apart) and contracts ``x - q * scale`` into one FMA, so the worker
  residuals agree within two ulps of the chunk's absmax. The server
  averages the ranks' decoded chunks in f32, in another summation order
  than XLA's: the mean may move by a few ulps, the re-quantization's
  scale by an ulp, and a value on a rounding edge by one int8 step. So
  the averages differ by at most one step of the chunk's second scale
  (plus a few ulps), and the server residuals likewise.
- 1-bit: the worker compression takes the same f32 inputs, so its signs
  are equal and its scale (an L2 norm) is within f32 reduction-order
  error (rtol 1e-6). The server's chunk mean then differs by ulps: its
  signs are equal except within ulps of 0 (none occur at these seeds:
  checked, not assumed), and the decoded average is within rtol 1e-5.
- 1-bit Adam's update: the same f32 formula, so within a few ulps
  (rtol 1e-6) in both branches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.runtime.comm import compressed as jc
from deepspeed_tpu.runtime.comm import quantized as jq
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.fp16 import onebit_adam as jo
from deepspeed_tpu.utils.compat import shard_map
from deepspeed_tpu_torch.parallel.collectives import (
    gather_from_chunk_servers,
    scatter_to_chunk_servers,
)
from deepspeed_tpu_torch.runtime.comm import compressed as pc
from deepspeed_tpu_torch.runtime.comm import quantized as pq
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import onebit_adam as po

WORLD, CHUNK = 4, 64


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def test_pack_signs_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    signs = rng.random((3, 64)) > 0.5
    got = pc.pack_signs(t(signs))
    want = np.asarray(jc.pack_signs(jnp.asarray(signs)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 8)
    assert np.array_equal(got.numpy(), want)
    # bit i of byte k is element 8k + i, True = +1
    assert int(pc.pack_signs(t(np.eye(8, dtype=bool)[3]))[0]) == 8
    back = pc.unpack_signs(got)
    assert np.array_equal(back.numpy(),
                          np.asarray(jc.unpack_signs(jnp.asarray(want))))
    assert np.array_equal(back.numpy(), np.where(signs, 1.0, -1.0))
    with pytest.raises(ValueError, match="n % 8 == 0"):
        pc.pack_signs(torch.ones(12, dtype=torch.bool))


@pytest.mark.parametrize("n,world", [(100, 8), (128, 8), (1, 2), (513, 4)])
def test_sizes_equal_jax(n, world):
    assert pc.error_feedback_sizes(n, world) == \
        jc.error_feedback_sizes(n, world)
    assert pq.quantized_allreduce_sizes(n, world, CHUNK) == \
        jq.quantized_allreduce_sizes(n, world, CHUNK)


def test_quantize_chunks_equal_jax_bit_for_bit():
    """Random values, an all-zero chunk, and exact half steps (127.5 /
    127 of the absmax rounds to even, 126.5 to 126)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, CHUNK)).astype(np.float32)
    x[2] = 0.0
    x[3] = 0.0
    x[3, 0] = 127.0
    x[3, 1:6] = [0.5, 1.5, 2.5, -0.5, 126.5]
    flat = x.reshape(-1)
    q, s = pq.quantize_chunks(t(flat), CHUNK)
    jq_, js = jq.quantize_chunks(jnp.asarray(flat), CHUNK)
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq_))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert q[3, 1:6].tolist() == [0, 2, 2, 0, 126]
    back = pq.dequantize_chunks(q, s)
    assert np.array_equal(back.numpy(),
                          np.asarray(jq.dequantize_chunks(jq_, js)))
    assert (back.numpy()[2 * CHUNK:3 * CHUNK] == 0).all()


# ---------------------------------------------------------------------------
# the int8 all-reduce
# ---------------------------------------------------------------------------

def port_quantized(xs, ef, chunk=CHUNK, rw=None, rs=None):
    """Every rank's phases of ``quantized_allreduce``, the scatter and
    the gather done by hand: ``(avg [world, n], worker, server)``."""
    world, n = xs.shape
    if ef and rw is None:
        rw = [torch.zeros(n) for _ in range(world)]
        rs = [torch.zeros(n // world) for _ in range(world)]
    phase1 = [pq.quantized_worker(t(xs[r]), world, chunk,
                                  rw[r] if ef else None)
              for r in range(world)]
    served = []
    for r in range(world):
        recv_q = torch.stack([phase1[s][0][r] for s in range(world)])
        recv_s = torch.stack([phase1[s][1][r] for s in range(world)])
        served.append(pq.quantized_server(recv_q, recv_s, chunk,
                                          rs[r] if ef else None))
    all_q = torch.stack([q2 for q2, _, _ in served])
    all_s = torch.stack([s2 for _, s2, _ in served])
    avg = pq.quantized_decode(all_q, all_s, chunk)
    worker = [w for _, _, w in phase1]
    server = [s for _, _, s in served]
    return (torch.stack([avg] * world), worker, server, all_s)


def jax_quantized(xs, ef):
    world, n = xs.shape

    def body(x, rw, rs):
        avg, w2, s2 = jq.quantized_allreduce(
            x[0], "data", chunk_size=CHUNK,
            worker_residual=rw[0] if ef else None,
            server_residual=rs[0] if ef else None)
        if not ef:
            w2, s2 = rw[0], rs[0]
        return avg[None], w2[None], s2[None]

    f = jax.jit(shard_map(body, mesh=mesh(world),
                          in_specs=(P("data", None),) * 3,
                          out_specs=(P("data", None),) * 3,
                          check_vma=False))
    out = f(jnp.asarray(xs), jnp.zeros((world, n), jnp.float32),
            jnp.zeros((world, n // world), jnp.float32))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("ef", [False, True])
def test_quantized_allreduce_equals_jax(ef):
    rng = np.random.default_rng(2)
    n = WORLD * CHUNK * 2
    xs = rng.normal(size=(WORLD, n)).astype(np.float32)
    avg, worker, server, s2 = port_quantized(xs, ef)
    javg, jworker, jserver = jax_quantized(xs, ef)
    # one step of the served chunk's second scale, every element
    step = np.repeat(s2.numpy().reshape(-1), CHUNK)
    for r in range(WORLD):
        assert np.all(np.abs(avg[r].numpy() - javg[r]) <= step + 1e-6)
        assert torch.equal(avg[r], avg[0])
    # the double quantization stays near the f32 mean (JAX's own bound)
    exact = xs.mean(axis=0)
    assert np.linalg.norm(avg[0].numpy() - exact) / \
        np.linalg.norm(exact) < 0.02
    if ef:
        for r in range(WORLD):
            ulp = 2 * np.repeat(np.spacing(np.abs(xs[r]).reshape(
                -1, CHUNK).max(axis=1)), CHUNK)
            assert np.all(np.abs(worker[r].numpy() - jworker[r]) <= ulp)
            chunk_step = np.repeat(s2[r].numpy(), CHUNK)
            assert np.all(np.abs(server[r].numpy() - jserver[r])
                          <= chunk_step + 1e-6)


def test_quantized_error_feedback_residual_is_the_codec_error():
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(WORLD, WORLD * CHUNK)).astype(np.float32)
    _, worker, _, _ = port_quantized(xs, True)
    q, s = pq.quantize_chunks(t(xs[0]), CHUNK)
    assert torch.equal(worker[0], t(xs[0]) - pq.dequantize_chunks(q, s))
    with pytest.raises(ValueError, match="not aligned"):
        pq.quantized_worker(torch.zeros(100), WORLD, CHUNK)


def test_bucket_plan_and_residuals_equal_jax():
    sizes = [300, 64, 5000, 12, 12, 2048, 7]
    for bucket_bytes in (4, 4096, 8000, 1 << 20):
        got = pq.bucket_plan(sizes, WORLD, bucket_bytes, CHUNK)
        assert got == jq.bucket_plan(sizes, WORLD, bucket_bytes, CHUNK)
    res = pq.init_residuals(sizes, WORLD, 8000, CHUNK)
    plan = pq.bucket_plan(sizes, WORLD, 8000, CHUNK)
    assert [tuple(w.shape) for w in res["worker"]] == \
        [(p,) for _, _, p in plan]
    assert [tuple(s.shape) for s in res["server"]] == \
        [(p // WORLD,) for _, _, p in plan]


@pytest.mark.parametrize("ef", [False, True])
def test_quantized_allreduce_tree_equals_jax_at_world_1(ef):
    """The bucketing, padding and unpacking around the exchange: one
    rank (no collective), two buckets, twice (the residuals carry);
    within one int8 step of the largest chunk scale (the jitted scale's
    ulp can move a value across a rounding edge)."""
    rng = np.random.default_rng(5)
    shapes = [(7, 9), (300,), (4, 4, 4), (1,), (65,)]
    trees = [[rng.normal(size=sh).astype(np.float32) for sh in shapes]
             for _ in range(2)]
    sizes = [int(np.prod(sh)) for sh in shapes]
    res = pq.init_residuals(sizes, 1, 1024, CHUNK) if ef else None
    jres = jax.tree_util.tree_map(
        lambda a: a[0], jq.init_residuals(
            {f"l{i}": jnp.zeros(sh) for i, sh in enumerate(shapes)},
            1, 1024, CHUNK)) if ef else None

    def jfn(leaves, r):
        tree = {f"l{i}": a for i, a in enumerate(leaves)}
        out, r2 = jq.quantized_allreduce_tree(
            tree, "data", chunk_size=CHUNK, bucket_bytes=1024, residuals=r)
        return [out[f"l{i}"] for i in range(len(leaves))], r2

    f = jax.jit(shard_map(jfn, mesh=mesh(1), in_specs=(P(), P()),
                          out_specs=(P(), P()), check_vma=False))
    for leaves in trees:
        got, res = pq.quantized_allreduce_tree(
            [t(a) for a in leaves], None, chunk_size=CHUNK,
            bucket_bytes=1024, residuals=res)
        want, jres = f([jnp.asarray(a) for a in leaves], jres)
        assert len(pq.bucket_plan(sizes, 1, 1024, CHUNK)) == 2
        step = max(np.abs(a).max() for a in leaves) / 127 * 1.001
        for g, w, a in zip(got, want, leaves):
            assert tuple(g.shape) == a.shape
            assert np.abs(g.numpy() - np.asarray(w)).max() <= step
        if ef:
            for key in ("worker", "server"):
                for a, b in zip(res[key], jres[key]):
                    assert np.abs(a.numpy() - np.asarray(b)).max() <= step


# ---------------------------------------------------------------------------
# the 1-bit all-reduce
# ---------------------------------------------------------------------------

def port_compressed(xs, we, se, n_valid):
    world = xs.shape[0]
    phase1 = [pc.compressed_worker(t(xs[r]), t(we[r]), world, n_valid)
              for r in range(world)]
    scales = torch.stack([s for _, s, _ in phase1])
    served = [pc.compressed_server(
        torch.stack([phase1[s][0][r] for s in range(world)]), scales,
        t(se[r]), r, n_valid) for r in range(world)]
    avg = pc.compressed_decode(torch.stack([p for p, _, _ in served]),
                               torch.stack([s for _, s, _ in served]),
                               n_valid)
    return (avg.numpy(), np.stack([w.numpy() for _, _, w in phase1]),
            np.stack([s.numpy() for _, _, s in served]),
            scales.numpy(), served)


def jax_compressed(xs, we, se, n_valid):
    world = xs.shape[0]

    def body(x, w, s):
        avg, w2, s2 = jc.compressed_allreduce(x[0], w[0], s[0], "data",
                                              n_valid=n_valid)
        return avg[None], w2[None], s2[None]

    f = jax.jit(shard_map(body, mesh=mesh(world),
                          in_specs=(P("data", None),) * 3,
                          out_specs=(P("data", None),) * 3,
                          check_vma=False))
    return [np.asarray(o) for o in f(jnp.asarray(xs), jnp.asarray(we),
                                     jnp.asarray(se))]


@pytest.mark.parametrize("n", [100, 256])
def test_compressed_allreduce_equals_jax(n):
    """Two calls (the second carries the error buffers); n = 100 pads to
    128 at world 4, so rank 3 serves only padding and rank 0's chunk is
    whole: the padding never gathers error."""
    padded, chunk = pc.error_feedback_sizes(n, WORLD)
    rng = np.random.default_rng(6)
    we = np.zeros((WORLD, padded), np.float32)
    se = np.zeros((WORLD, chunk), np.float32)
    jwe, jse = we.copy(), se.copy()
    for _ in range(2):
        xs = np.zeros((WORLD, padded), np.float32)
        xs[:, :n] = rng.standard_normal((WORLD, n)).astype(np.float32)
        avg, we2, se2, scales, served = port_compressed(xs, we, se, n)
        javg, jwe2, jse2 = jax_compressed(xs, jwe, jse, n)
        # worker: the same inputs, so the same signs; the scale within
        # reduction-order error
        corrected = np.where(np.arange(padded) < n, xs + we, 0.0)
        want_scale = np.linalg.norm(corrected, axis=1) / np.sqrt(n)
        np.testing.assert_allclose(scales, want_scale, rtol=1e-6)
        np.testing.assert_allclose(we2, jwe2, rtol=1e-5, atol=1e-6)
        # server: no chunk mean within ulps of 0 at this seed
        for r in range(WORLD):
            np.testing.assert_allclose(avg, javg[r], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(se2, jse2, rtol=1e-5, atol=1e-6)
        assert np.all(avg[n:] == 0) and np.all(we2[:, n:] == 0)
        for r in range(WORLD):
            valid = min(max(n - r * chunk, 0), chunk)
            assert np.all(se2[r, valid:] == 0)
        we, se, jwe, jse = we2, se2, jwe2, jse2
    with pytest.raises(ValueError, match="not aligned"):
        pc.compressed_worker(torch.zeros(100), torch.zeros(100), WORLD, 100)


def test_chunk_server_pair_without_a_group():
    """One rank: the scatter passes its stacks through, the gather adds
    the rank dim (a scalar becomes ``[1]``)."""
    x = torch.arange(6.0).reshape(1, 6)
    s = torch.tensor(2.0)
    assert scatter_to_chunk_servers((x, s), None) == (x, s)
    gx, gs = gather_from_chunk_servers((x[0], s), None)
    assert tuple(gx.shape) == (1, 6) and tuple(gs.shape) == (1,)


# ---------------------------------------------------------------------------
# 1-bit Adam's update
# ---------------------------------------------------------------------------

def test_onebit_adam_update_equals_jax_in_both_branches():
    """One rank: freeze_step 2, so steps 1-2 take the dense branch and
    3-4 the compressed one (weight decay on; beta1 an f32 array, as the
    JAX engine passes it)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 7), "b": (13,)}
    params = {k: rng.normal(size=sh).astype(np.float32)
              for k, sh in shapes.items()}
    grads = [{k: rng.normal(size=sh).astype(np.float32)
              for k, sh in shapes.items()} for _ in range(4)]
    kw = dict(beta2=0.99, eps=1e-6, weight_decay=0.01, freeze_step=2)

    def jfn(p, g, s):
        return jo.onebit_adam_update(p, g, s, lr=jnp.float32(0.05),
                                     beta1=jnp.float32(0.9),
                                     axis_name="data", **kw)

    state = jo.init_onebit_state(params, 1)
    specs = jo.OnebitAdamState(m=P(), v=P(), step=P(),
                               worker_error=P("data", None),
                               server_error=P("data"))
    f = jax.jit(shard_map(jfn, mesh=mesh(1),
                          in_specs=(P(), P(), specs),
                          out_specs=(P(), specs), check_vma=False))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    names = sorted(shapes)          # JAX's flat order
    pp = [t(params[k]).clone() for k in names]
    ps = po.init_onebit_state(pp, 1)
    assert tuple(ps.worker_error.shape) == state.worker_error.shape[1:]
    assert tuple(ps.server_error.shape) == state.server_error.shape
    for step, g in enumerate(grads, 1):
        jp, state = f(jp, {k: jnp.asarray(v) for k, v in g.items()}, state)
        pp, ps = po.onebit_adam_update(pp, [t(g[k]) for k in names], ps,
                                       lr=0.05, beta1=0.9, **kw)
        for k, p in zip(names, pp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
        for k, m in zip(names, ps.m):
            np.testing.assert_allclose(m.numpy(), np.asarray(state.m[k]),
                                       rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(ps.worker_error.numpy(),
                                   np.asarray(state.worker_error)[0],
                                   rtol=1e-5, atol=1e-7)
        assert int(ps.step) == int(state.step) == step
        frozen = step > 2
        assert bool((ps.worker_error != 0).any()) == frozen


def test_onebit_adam_constructor_and_state():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        po.OnebitAdam(amsgrad=True)
    opt = po.OnebitAdam(lr=2e-3, freeze_step=7, betas=(0.8, 0.9), eps=1e-5,
                        weight_decay=0.1)
    assert (opt.lr, opt.freeze_step, opt.betas, opt.eps,
            opt.weight_decay) == (2e-3, 7, (0.8, 0.9), 1e-5, 0.1)
    st = opt.init([torch.zeros(3, 4), torch.zeros(5)], world=4)
    assert tuple(st.worker_error.shape) == (32,)       # 17 -> 8 * 4
    assert tuple(st.server_error.shape) == (8,)
    assert st.step.dtype == torch.int32 and int(st.step) == 0


def test_pipeline_groups_keep_shared_copies_apart():
    names = ["tied.embed.wte", "body.0.mp_w", "body.0.ln.weight",
             "epilogue.layer_0.weight", "body.1.mp_w", "body.1.ln.weight"]
    sharded = [False, True, False, False, True, False]
    # the body leaf after leaf, each layer after layer (JAX's stacking)
    assert po.pipeline_onebit_groups(names, sharded, 1) == [
        ("body", [1, 4, 2, 5]), ("rest", [3]), ("tied", [0])]
    assert po.pipeline_onebit_groups(
        names, sharded, 1, [("ln.weight", False), ("mp_w", True)]) == [
        ("body", [2, 5, 1, 4]), ("rest", [3]), ("tied", [0])]
    assert po.pipeline_onebit_groups(names, sharded, 2) == [
        ("body_mp", [1, 4]), ("body_rep", [2, 5]), ("rest", [3]),
        ("tied", [0])]
    params = [torch.zeros(3), torch.zeros(4, 2), torch.zeros(5),
              torch.zeros(1), torch.zeros(4, 2), torch.zeros(5)]
    groups = po.pipeline_onebit_groups(names, sharded, 2)
    st = po.init_pipeline_onebit_state(params, groups, 2)
    splits = po.pipeline_onebit_splits([16, 10, 1, 3], 2)
    assert splits == [(16, 8), (16, 8), (16, 8), (16, 8)]
    assert tuple(st.worker_error.shape) == (64,)
    assert tuple(st.server_error.shape) == (32,)


def test_body_order_is_jax_ravel_of_stacked_leaves():
    """Two layers a stage: the port's GPT-2 stage body, flattened in
    ``body_reference_order`` (transposed leaves transposed), is JAX's
    ``ravel_pytree`` of the stage's stacked body leaves."""
    from jax.flatten_util import ravel_pytree

    from deepspeed_tpu_torch.models.gpt2_pipe import (
        GPT2BlockLayer, convert_gpt2_pipe_params)
    rng = np.random.default_rng(3)
    S, L, D = 2, 2, 8
    shapes = {"attn": {"c_attn": {"kernel": (D, 3 * D), "bias": (3 * D,)},
                       "c_proj": {"kernel": (D, D), "bias": (D,)}},
              "ln_1": {"scale": (D,), "bias": (D,)},
              "ln_2": {"scale": (D,), "bias": (D,)},
              "mlp": {"c_fc": {"kernel": (D, 4 * D), "bias": (4 * D,)},
                      "c_proj": {"kernel": (4 * D, D), "bias": (D,)}}}
    body = jax.tree_util.tree_map(
        lambda sh: rng.normal(size=(S, L) + sh).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    tree = {"tied": {"embed": {"wte": np.zeros((4, D), np.float32),
                               "wpe": np.zeros((4, D), np.float32)}},
            "epilogue": {"layer_0": {"scale": np.zeros(D, np.float32),
                                     "bias": np.zeros(D, np.float32)}},
            "body": body}
    conv = convert_gpt2_pipe_params(tree)
    leaves = [n[len("body."):] for n in conv if n.startswith("body.")]
    for stage in range(S):
        names = [f"body.{l}.{n}" for l in range(L) for n in leaves]
        values = [conv[f"body.{n}"][stage, l] for l in range(L)
                  for n in leaves]
        order, transposed = po.body_reference_order(
            names, GPT2BlockLayer.reference_leaves())
        flat = torch.cat([(values[i].mT if i in transposed else values[i])
                          .reshape(-1) for i in order])
        want = ravel_pytree(jax.tree_util.tree_map(lambda a: a[stage],
                                                   body))[0]
        np.testing.assert_array_equal(flat.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _cfg(extra=None, **quant):
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "comm_quantization": {"enabled": True, **quant}}
    cfg.update(extra or {})
    return cfg


def test_comm_quantization_parses_as_jax():
    for cfg in (_cfg(chunk_size=256, bucket_mb=2, error_feedback=True),
                _cfg(), {"train_batch_size": 8}):
        got = DeepSpeedConfig(cfg, world_size=8).comm_quantization
        want = JaxConfig(cfg, world_size=8).comm_quantization
        assert repr(got) == repr(want)


@pytest.mark.parametrize("bad", [
    _cfg(bits=4),
    _cfg(chunk_size=0),
    _cfg(chunk_size=511),
    _cfg(bucket_mb=0),
    _cfg(extra={"zero_optimization": {"stage": 3},
                "bf16": {"enabled": True}}),
    _cfg(extra={"sparse_gradients": True}),
    _cfg(extra={"optimizer": {"type": "OneBitAdam",
                              "params": {"lr": 1e-3}},
                "fp16": {"enabled": True}}),
    _cfg(extra={"zero_optimization": {"stage": 1, "cpu_offload": True},
                "bf16": {"enabled": True}}),
    _cfg(extra={"fp8": {"wire": {"enabled": True}}}),
    {"train_batch_size": 8, "fp8": {"enabled": True},
     "optimizer": {"type": "OneBitAdam", "params": {}}},
])
def test_rejects_what_jax_rejects_with_its_text(bad):
    with pytest.raises((AssertionError, ValueError)) as want:
        JaxConfig(bad, world_size=8)
    with pytest.raises(type(want.value)) as got:
        DeepSpeedConfig(bad, world_size=8)
    assert str(got.value) == str(want.value)
