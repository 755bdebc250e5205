"""Ring and Ulysses attention (``parallel/sequence.py``) over gloo worlds
of 2 and 4 processes, held to JAX's ``ring_attention`` /
``ulysses_attention`` on a sub-mesh of the 8-device CPU mesh of the same
shape: seq 2, seq 4 and seq 2 x data 2.

Each rank runs its ``[data, seq]`` block of seeded global inputs
``[2, 32, 4, 8]`` and the local gradients of ``sum(out * w)``; the test
compares them with the same block of JAX's output and of JAX's
gradients of the global loss. Bounds: f32 outputs rtol / atol 1e-5 and
gradients 1e-4 (JAX ``test_sequence_parallel.py``'s own); bf16 ring
outputs 2e-2 and gradients 5e-2 (JAX accumulates the travelling
gradients in bf16, the port in f32). Ring dropout (rate 0.2, seed 17)
against JAX's ring under the same seed within the f32 bounds: the hash
masks are the same bits (a mask that differed anywhere would move an
output by O(1)); at data 2 the data rank is folded in, and two copies of
one row on the two data ranks draw different masks. Ulysses hands its
attention the seed ``fold_in_seed(fold_in_seed(seed, seq rank), data
rank)`` (then ``fold_in_seed(., j)`` for head group j under a chunked
``ulysses`` overlap plan), equal to JAX's ``fold_in_seed`` chain; the
chunked plan without dropout equals the plan-off output within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import fold_in_seed
from deepspeed_tpu.parallel.collectives import OverlapPlan, overlap_scope
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.sequence import (
    ring_attention as jax_ring,
    ulysses_attention as jax_ulysses,
)
from deepspeed_tpu_torch.parallel import mesh as port_mesh
from deepspeed_tpu_torch.parallel import sequence as sp
from tests import torch_zero_harness as H

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
B, T, NH, D = 2, 32, 4, 8
MESHES = {"s2": ({"seq": 2}, 2), "s4": ({"seq": 4}, 4),
          "s2d2": ({"seq": 2, "data": 2}, 4)}
# fn, causal, dtype, dropout rate, seed, ulysses plan chunks
VARIANTS = [("ring", True, "f32", 0.0, 0, 1),
            ("ring", False, "f32", 0.0, 0, 1),
            ("ulysses", True, "f32", 0.0, 0, 1),
            ("ulysses", False, "f32", 0.0, 0, 1),
            ("ring", True, "bf16", 0.0, 0, 1),
            ("ring", True, "f32", 0.2, 17, 1),
            ("ring", False, "f32", 0.2, 17, 1),
            ("ulysses", True, "f32", 0.2, 17, 1),
            ("ulysses", True, "f32", 0.0, 0, 2),
            ("ulysses", True, "f32", 0.2, 17, 2)]
DUP = [("ring", True, "f32", 0.3, 3, 1), ("ring", True, "f32", 0.0, 0, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key(v):
    fn, causal, dtype, rate, _, chunks = v
    return f"{fn}/{int(causal)}/{dtype}/{rate}/{chunks}"


def inputs(dup=False):
    rng = np.random.default_rng(0)
    out = {n: rng.standard_normal((B, T, NH, D)).astype(np.float32)
           for n in ("q", "k", "v", "w")}
    if dup:             # row 1 a copy of row 0
        for n in ("q", "k", "v"):
            out[n][1] = out[n][0]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    np.savez(root / "in.npz", **inputs())
    np.savez(root / "dup.npz", **inputs(dup=True))
    w2 = [dict(name="s2", kind="seq_attention", mesh=MESHES["s2"][0],
               variants=VARIANTS, bad_heads=3)]
    w4 = [dict(name="s4", kind="seq_attention", mesh=MESHES["s4"][0],
               variants=VARIANTS, bad_heads=2),
          dict(name="s2d2", kind="seq_attention", mesh=MESHES["s2d2"][0],
               variants=VARIANTS, bad_heads=3),
          dict(name="dup", kind="seq_attention", mesh=MESHES["s2d2"][0],
               variants=DUP, bad_heads=3, inputs=str(root / "dup.npz"))]
    H.spawn_world(2, w2, root / "in.npz", root / "w2", worker=WORKER)
    H.spawn_world(4, w4, root / "in.npz", root / "w4", worker=WORKER)
    return root


def results(root, name):
    shape, world = MESHES["s2d2" if name == "dup" else name]
    rows = H.load_results(root / f"w{world}", name, world)
    full = port_mesh.normalize_mesh_shape(shape, world)
    return [(port_mesh.mesh_coords(r, full), arrays, meta)
            for r, (arrays, meta) in enumerate(rows)]


_JAX = {}


def jax_reference(name, v):
    """JAX's output and gradients of the global ``sum(out * w)`` on the
    same-shape sub-mesh (computed once per mesh and variant)."""
    if (name, v) in _JAX:
        return _JAX[name, v]
    shape, world = MESHES[name]
    mesh = build_mesh(shape, devices=jax.devices()[:world])
    fn, causal, dtype, rate, seed, _ = v
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    g = inputs()
    q, k, vv = (jnp.asarray(g[n]).astype(dt) for n in ("q", "k", "v"))
    attn = jax_ring if fn == "ring" else jax_ulysses
    kw = {"dropout_rate": rate, "dropout_seed": jnp.int32(seed)} \
        if rate else {}

    def fwd_bwd(a, b, c, w):
        out, vjp = jax.vjp(lambda x, y, z: attn(x, y, z, mesh,
                                                causal=causal, **kw),
                           a, b, c)
        return (out,) + tuple(vjp(w.astype(out.dtype)))

    res = [np.asarray(x, np.float32) for x in
           jax.jit(fwd_bwd)(q, k, vv, jnp.asarray(g["w"]))]
    _JAX[name, v] = res
    return res


def block(x, c, shape, world):
    full = port_mesh.normalize_mesh_shape(shape, world)
    b, t = x.shape[0] // full["data"], x.shape[1] // full["seq"]
    return x[c["data"] * b:(c["data"] + 1) * b,
             c["seq"] * t:(c["seq"] + 1) * t]


@pytest.mark.parametrize("name", ["s2", "s4", "s2d2"])
@pytest.mark.parametrize("v", [v for v in VARIANTS if v[5] == 1],
                         ids=lambda v: key(v))
def test_matches_jax(run, name, v):
    """Forward and gradients against JAX's on every rank's block."""
    bf16 = v[2] == "bf16"
    tol = 2e-2 if bf16 else 1e-5
    gtol = 5e-2 if bf16 else 1e-4
    ref = jax_reference(name, v)
    shape, world = MESHES[name]
    for c, arrays, _ in results(run, name):
        got = [arrays[f"{key(v)}/{n}"] for n in ("out", "dq", "dk", "dv")]
        for i, (a, want) in enumerate(zip(got, ref)):
            t = tol if i == 0 else gtol
            np.testing.assert_allclose(a, block(want, c, shape, world),
                                       rtol=t, atol=t,
                                       err_msg=f"{key(v)} {i} {c}")


@pytest.mark.parametrize("name", ["s2", "s4", "s2d2"])
def test_ulysses_seeds_are_the_fold_in_seed_chain(run, name):
    """The seed Ulysses hands its attention (each head group's under the
    chunked plan) against JAX's ``fold_in_seed`` chain."""
    shape, _ = MESHES[name]
    for c, _, meta in results(run, name):
        seed = fold_in_seed(jnp.int32(17), c["seq"])
        if shape.get("data", 1) > 1:
            seed = fold_in_seed(seed, c["data"])
        want = [int(seed)]
        assert meta["seeds"]["ulysses/1/f32/0.2/1"] == want
        n = shape["seq"]
        groups = min(2, NH // n)
        want = [int(fold_in_seed(seed, j)) for j in range(groups)] \
            if groups > 1 else [int(seed)]
        assert meta["seeds"]["ulysses/1/f32/0.2/2"] == want
        assert meta["seeds"]["ulysses/1/f32/0.0/1"] == [None]


@pytest.mark.parametrize("name", ["s2", "s4", "s2d2"])
def test_chunked_ulysses_plan_equals_plan_off(run, name):
    for _, arrays, _ in results(run, name):
        for n in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(
                arrays[f"ulysses/1/f32/0.0/2/{n}"],
                arrays[f"ulysses/1/f32/0.0/1/{n}"], rtol=1e-6, atol=1e-6)


def test_chunked_ulysses_matches_jax_plan(run):
    """JAX's chunked Ulysses under the same plan (seq 2: two head
    groups), dropout included: the same folded seeds, the same output."""
    shape, world = MESHES["s2"]
    mesh = build_mesh(shape, devices=jax.devices()[:world])
    g = inputs()
    with overlap_scope(OverlapPlan(chunks=2)):
        want = np.asarray(jax.jit(lambda a, b, c: jax_ulysses(
            a, b, c, mesh, causal=True, dropout_rate=0.2,
            dropout_seed=jnp.int32(17)))(
            *(jnp.asarray(g[n]) for n in ("q", "k", "v"))))
    for c, arrays, _ in results(run, "s2"):
        np.testing.assert_allclose(arrays["ulysses/1/f32/0.2/2/out"],
                                   block(want, c, shape, world),
                                   rtol=1e-5, atol=1e-5)


def test_ring_dropout_data_shards_decorrelated(run):
    """Two copies of one row on the two data ranks: different masks with
    dropout (the data rank is folded into the seed), equal outputs
    without."""
    by = {(c["data"], c["seq"]): a for c, a, _ in results(run, "dup")}
    for s in (0, 1):
        a, b = by[0, s], by[1, s]
        drop, plain = key(DUP[0]) + "/out", key(DUP[1]) + "/out"
        assert not np.allclose(a[drop], b[drop])
        np.testing.assert_array_equal(a[plain], b[plain])


@pytest.mark.parametrize("name,n,heads", [("s2", 2, 3), ("s4", 4, 2)])
def test_ulysses_head_divisibility(run, name, n, heads):
    for _, _, meta in results(run, name):
        assert meta["head_error"] == \
            f"heads {heads} must divide seq-parallel degree {n}"


@pytest.mark.parametrize("fn", [sp.ring_attention_local,
                                sp.ulysses_attention_local])
def test_dropout_requires_seed(fn):
    q = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="dropout_seed"):
        fn(q, q, q, None, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"not in \[0, 1\)"):
        fn(q, q, q, None, dropout_rate=1.5, dropout_seed=1)


def test_ring_at_one_rank_is_dense_with_the_same_mask():
    """No group: the ring is dense attention (the same hash mask),
    forward and gradients, in one process."""
    from deepspeed_tpu_torch.ops.flash_attention import dense_attention
    g = {n: torch.from_numpy(a) for n, a in inputs().items()}
    for causal in (True, False):
        outs = []
        for f in (lambda a, b, c: sp.ring_attention_local(
                a, b, c, None, causal=causal, dropout_rate=0.2,
                dropout_seed=17),
                lambda a, b, c: dense_attention(
                    a, b, c, causal=causal, dropout_rate=0.2,
                    dropout_seed=17)):
            x = [g[n].clone().requires_grad_(True) for n in "qkv"]
            o = f(*x)
            (o * g["w"]).sum().backward()
            outs.append([o.detach()] + [t.grad for t in x])
        for a, b in zip(*outs):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("seq_rank,data_rank", [(0, None), (1, None),
                                                (3, 0), (2, 1)])
def test_ring_dropout_multipliers_equal_jax_bitwise(seq_rank, data_rank):
    """The multipliers the ring draws for a chunk (``_Ring._chunk`` at
    its global coordinates, the data rank folded into the seed) equal
    JAX's ``dropout_multiplier`` at the same coordinates, bit for bit."""
    import types

    from deepspeed_tpu.ops.pallas.flash_attention import (
        dropout_multiplier as jax_mult)
    t_loc, src = 8, 1
    seed = 17 if data_rank is None else int(
        fold_in_seed(jnp.int32(17), data_rank))
    q_pos = seq_rank * t_loc + torch.arange(t_loc)
    bh = (torch.arange(B)[:, None] * NH + torch.arange(NH)[None, :])
    ctx = types.SimpleNamespace(q_pos=q_pos, bh=bh[:, :, None, None],
                                causal=False, rate=0.2,
                                seed=sp.fold_in_seed(17, data_rank)
                                if data_rank is not None else 17)
    assert ctx.seed == seed
    _, mult = sp._Ring._chunk(ctx, torch.zeros(B, t_loc, NH, D),
                              torch.zeros(B, t_loc, NH, D), src, 0)
    k_pos = src * t_loc + np.arange(t_loc)
    want = jax_mult(jnp.int32(seed),
                    jnp.asarray(bh.numpy())[:, :, None, None],
                    jnp.asarray(q_pos.numpy())[None, None, :, None],
                    jnp.asarray(k_pos)[None, None, None, :], 0.2)
    assert np.array_equal(mult.numpy(), np.asarray(want))
