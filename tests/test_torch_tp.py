"""The Megatron layers (``parallel/tensor_parallel.py``) in gloo worlds of
2 and 4 processes, held to JAX's ``parallel/tensor_parallel.py`` as its
``tests/unit/test_tensor_parallel.py`` holds it: the column -> row pair
equals one dense two-layer product, and ``TPTransformerBlock``'s output
and gradients (loss ``mean(y ** 2)``) equal the unsharded flax block's
(JAX's test: sharding is a layout, not a change of math), on the dense
and on the flash route (K1-K3's plain versions on the CPU). Tolerances:
JAX's, rtol 1e-5 and atol 1e-5 on values, rtol 1e-4 and atol 1e-5 on
gradients. Each rank holds only its shard; the whole gradients are
gathered for the comparison.

Also here: the partition specs (JAX ``partition_specs`` as shard
dims), the shard / unshard round trip (vocab padding included), the
mesh's canonical axis order and groups, and ``logical_constraint``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel.tensor_parallel import (
    ColumnParallelLinear as JaxColumn,
    RowParallelLinear as JaxRow,
    TPTransformerBlock as JaxBlock,
    unbox_params,
)
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.parallel import tensor_parallel as tpl
from tests import torch_zero_harness as H

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This process's torch work on one intra-op thread (the tiny shapes
    gain nothing from more, and the gloo workers and the other test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(p):
    return {"weight": np.asarray(p["kernel"]).T.copy(),
            "bias": np.asarray(p["bias"])}


def block_state(params):
    """The flax block's params under the port's names, whole."""
    out = {}
    for ln in ("ln_1", "ln_2"):
        out[f"{ln}.weight"] = np.asarray(params[ln]["scale"])
        out[f"{ln}.bias"] = np.asarray(params[ln]["bias"])
    for mod, name in (("attn", "c_attn"), ("attn", "c_proj"),
                      ("mlp", "c_fc"), ("mlp", "c_proj")):
        for k, v in _dense(params[mod][name]).items():
            out[f"{mod}.{name}.{k}"] = v
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_layers")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, 8, 32)).astype(np.float32))
    col, row = JaxColumn(64, name="c"), JaxRow(16, name="r")
    cp = unbox_params(col.init(jax.random.PRNGKey(1), x)["params"])
    rp = unbox_params(row.init(jax.random.PRNGKey(2),
                               jnp.zeros((2, 8, 64)))["params"])
    pair = row.apply({"params": rp}, col.apply({"params": cp}, x))
    block = JaxBlock(n_head=4)
    bp = unbox_params(block.init(jax.random.PRNGKey(3), x)["params"])

    def loss(p):
        y = block.apply({"params": p}, x)
        return jnp.mean(y.astype(jnp.float32) ** 2)

    y = block.apply({"params": bp}, x)
    grads = jax.grad(loss)(bp)
    dx = jax.grad(lambda xx: jnp.mean(
        block.apply({"params": bp}, xx).astype(jnp.float32) ** 2))(x)
    state = {f"pair/c.{k}": v for k, v in _dense(cp).items()}
    state.update({f"pair/r.{k}": v for k, v in _dense(rp).items()})
    state.update({f"block/{k}": v for k, v in block_state(bp).items()})
    np.savez(root / "state.npz", **state)
    out = {}
    for world in (2, 4):
        H.spawn_world(world, [{"name": "l", "kind": "tp_layers"}],
                      root / "state.npz", root / f"w{world}", worker=WORKER)
        out[world] = H.load_results(root / f"w{world}", "l", world)
    return out, np.asarray(pair), np.asarray(y), np.asarray(dx), \
        block_state(grads)


@pytest.mark.parametrize("world", [2, 4])
def test_column_row_pair_matches_dense(ref, world):
    out, pair, _, _, _ = ref
    for res, _ in out[world]:
        np.testing.assert_allclose(res["pair"], pair, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route", ["dense", "flash"])
def test_tp_block_loss_and_grads_match_replicated_oracle(ref, world, route):
    out, _, y, dx, grads = ref
    for res, _ in out[world]:
        np.testing.assert_allclose(res[f"{route}/y"], y, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res[f"{route}/dx"], dx, rtol=1e-4,
                                   atol=1e-5)
        for name, g in grads.items():
            np.testing.assert_allclose(res[f"{route}/grad/{name}"], g,
                                       rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_partition_specs_extracted_from_the_layers(ref, world):
    """JAX: c_attn / c_fc kernels ``P(None, "model")`` (the port's
    ``[out, in]`` weights: dim 0, c_attn as its q, k, v blocks),
    c_proj ``P("model", None)`` (dim 1), LayerNorms replicated."""
    out = ref[0]
    for _, meta in out[world]:
        specs = meta["specs"]
        assert specs["attn.c_attn.weight"] == [0, 3, None, "model"]
        assert specs["attn.c_proj.weight"] == [1, 1, None, "model"]
        assert specs["mlp.c_fc.weight"] == [0, 1, None, "model"]
        assert specs["mlp.c_proj.weight"] == [1, 1, None, "model"]
        assert specs["ln_1.weight"] is None
        assert specs["attn.c_proj.bias"] is None


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("spec", [tpl.Shard(0), tpl.Shard(1),
                                  tpl.Shard(0, 3), tpl.Shard(0, 1, 250)])
def test_shard_unshard_round_trip(size, spec):
    rows = 250 if spec.full else 72
    full = torch.randn(rows, 12 if spec.dim == 0 else 24)
    pieces = [tpl.shard_tensor(full, spec, r, size) for r in range(size)]
    assert len({tuple(p.shape) for p in pieces}) == 1
    assert torch.equal(tpl.unshard(pieces, spec), full)
    if spec.groups == 3:      # rank r holds block r of q, k and v
        q, k, v = full.chunk(3)
        n = 24 // size
        for r, p in enumerate(pieces):
            assert torch.equal(p, torch.cat([q[r * n:(r + 1) * n],
                                             k[r * n:(r + 1) * n],
                                             v[r * n:(r + 1) * n]]))
    if spec.full:             # the padded rows are zero
        tail = pieces[-1][-(tpl.padded_len(250, size) - 250) or None:]
        if tpl.padded_len(250, size) > 250:
            assert not tail.any()


def test_mesh_axes_order_and_coords():
    """JAX's canonical order, ``model`` innermost: a rank's coordinates
    are its C-order unravel over the shape."""
    assert mesh.MESH_AXES == ("data", "pipe", "expert", "seq", "model")
    shape = mesh.normalize_mesh_shape({"model": 2}, 8)
    assert shape == {"data": 4, "pipe": 1, "expert": 1, "seq": 1,
                     "model": 2}
    coords = [mesh.mesh_coords(r, shape) for r in range(8)]
    assert [(c["data"], c["model"]) for c in coords] == \
        [(r // 2, r % 2) for r in range(8)]
    assert all(mesh.mesh_rank(c, shape) == r for r, c in enumerate(coords))
    with pytest.raises(ValueError, match="do not divide"):
        mesh.normalize_mesh_shape({"model": 3}, 8)
    # every axis runs: the seq and expert axes lay out like the others
    mesh.check_mesh_axes({"seq": 2})
    mesh.check_mesh_axes({"expert": 2})
    with pytest.raises(ValueError, match="are not mesh axes"):
        mesh.check_mesh_axes({"tensor": 2})
    shape = mesh.normalize_mesh_shape({"expert": 2, "seq": 2}, 8)
    assert [(c["data"], c["expert"], c["seq"]) for c in (
        mesh.mesh_coords(r, shape) for r in range(8))] == \
        [(r // 4, r // 2 % 2, r % 2) for r in range(8)]
    mesh.check_mesh_axes({"model": 4, "data": 2, "pipe": 2})


def test_world1_mpu_is_one_rank_on_each_axis():
    groups = mesh.MeshGroups({"model": 1})
    assert groups.get_model_parallel_world_size() == 1
    assert groups.get_data_parallel_world_size() == 1
    assert groups.get_model_parallel_rank() == 0
    assert not groups.axis("model").active


def test_logical_constraint_is_the_identity():
    x = torch.randn(4, 4)
    assert tpl.logical_constraint(x, ("data", "model"), None) is x
