"""Data parallelism with ZeRO stages 0-3 across processes, held to the
JAX engine at the same world size.

The port runs in ``world`` gloo processes (``tests/torch_zero_worker.py``,
spawned once per world by a module-scoped fixture); the JAX engine runs
in this process on ``build_mesh({"data": world}, devices=jax.devices()
[:world])`` of the conftest's virtual CPU devices, from the same params
(``convert_gpt2_params``) and the same global batches, 3 steps of
accumulation 2, Adam lr 1e-3 (the port's single-process parity tests'
rate; at 1e-2 the two frameworks' bf16 roundings drift past 1e-4 within
3 steps, at stage 0 as at the others).

Cases: ``gpt2_tiny`` in f32 at stage 0 (flash attention) and in bf16 at
stages 0-3 and stage 2 with clipping (dense attention), and an
odd-width GPT-2 (n_embd 15) in fp16 at stages 1-3, whose LayerNorms and
``c_attn`` divide by neither 2 nor 4 and so stay replicated.

Tolerances: losses rtol 1e-5 (f32), 1e-4 (fp16, bf16; the bf16 flash
route drifts past 1e-4 from JAX's at world 1 already, a property of
the two attention implementations, so bf16 runs dense attention
here). Adam moments: each rank's piece has exactly the shape
of the JAX device's shard (that pins the split dimension and the
replicated leaves); where the dtype lets the two frameworks' gradients
agree (f32, fp16) the values too, at 1e-4 (f32) and 5e-2 (fp16) relative
L2 per leaf, while a piece held against another rank's shard misses by
far more.
"""

import numpy as np
import pytest

from tests import torch_zero_harness as H
from tests.torch_threads import one_thread  # noqa: F401

WORLDS = (2, 4)
ODD = {"n_embd": 15, "n_head": 3}

BF16 = dict(dtype="bf16", flash=False, lr=1e-3)
ODD_FP16 = dict(dtype="fp16", flash=False, lr=1e-3, model=ODD)
CASES = {
    "f32_s0": dict(dtype="f32", stage=0, flash=True, lr=1e-3),
    "bf16_s0": dict(BF16, stage=0),
    "bf16_s1": dict(BF16, stage=1),
    "bf16_s2": dict(BF16, stage=2),
    "bf16_s3": dict(BF16, stage=3),
    "bf16_s2_clip": dict(BF16, stage=2, clip=0.5),
    "odd_fp16_s1": dict(ODD_FP16, stage=1),
    "odd_fp16_s2": dict(ODD_FP16, stage=2),
    "odd_fp16_s3": dict(ODD_FP16, stage=3),
}
LOSS_RTOL = {"f32": 1e-5, "fp16": 1e-4, "bf16": 1e-4}
MOMENT_RTOL = {"f32": 1e-4, "fp16": 5e-2}


@pytest.fixture(scope="module")
def params():
    return {"tiny": H.init_jax_params(use_flash_attention=True),
            "odd": H.init_jax_params(use_flash_attention=False, **ODD)}


@pytest.fixture(scope="module")
def runs(params, tmp_path_factory):
    """Per world: the port's per-rank results and the JAX engine's
    losses and moment shards, for every case (both worlds' processes run
    while the JAX engines do)."""
    root = tmp_path_factory.mktemp("zero_parity")
    states = {k: H.save_port_state(p, root / f"{k}.npz")
              for k, p in params.items()}
    cases = [dict(c, name=name,
                  state=states["odd" if "model" in c else "tiny"])
             for name, c in CASES.items()]
    worlds = {world: H.start_world(world, cases, states["tiny"],
                                   root / f"w{world}")
              for world in WORLDS}
    out = {}
    try:
        for world in WORLDS:
            for name, case in CASES.items():
                losses, engine, mesh = H.jax_run(
                    params["odd" if "model" in case else "tiny"], case,
                    world)
                out[world, name] = {
                    "jax_losses": losses,
                    "jax_m": H.device_shards(engine.opt_state.m, mesh),
                    "jax_v": H.device_shards(engine.opt_state.v, mesh)}
    except BaseException:
        for procs in worlds.values():
            H.stop_world(procs)
        raise
    for world, procs in worlds.items():
        H.wait_world(procs)
        for name in CASES:
            out[world, name]["port"] = H.load_results(root / f"w{world}",
                                                      name, world)
    return out


GRID = [(w, n) for w in WORLDS for n in CASES]
ZERO_GRID = [(w, n) for w, n in GRID if CASES[n]["stage"] >= 1]


@pytest.mark.parametrize("world,name", GRID)
def test_losses_match_jax_engine(runs, world, name):
    r = runs[world, name]
    got = r["port"][0][0]["losses"]
    np.testing.assert_allclose(got, r["jax_losses"],
                               rtol=LOSS_RTOL[CASES[name]["dtype"]])
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("world,name", GRID)
def test_every_rank_holds_the_same_state(runs, world, name):
    """Every rank reports the same losses and holds the same params
    after the last step (at stage 3, the same gathered params)."""
    rows = runs[world, name]["port"]
    first = rows[0][0]
    for arrays, _ in rows[1:]:
        np.testing.assert_array_equal(arrays["losses"], first["losses"])
        for key in first:
            if key.startswith("param/"):
                np.testing.assert_array_equal(arrays[key], first[key],
                                              err_msg=key)


@pytest.mark.parametrize("world,name", ZERO_GRID)
def test_moment_pieces_are_the_jax_device_shards(runs, world, name):
    """Rank r's m and v pieces are JAX device r's shards: same shape for
    every leaf (the partition rule, replicated leaves included) and,
    where the dtype allows, the same values."""
    r = runs[world, name]
    rows = r["port"]
    dims = rows[0][1]["dims"]
    rtol = MOMENT_RTOL.get(CASES[name]["dtype"])
    for key in ("m", "v"):
        shards = r[f"jax_{key}"]
        for leaf, per_device in shards.items():
            for rank in range(world):
                got = rows[rank][0][f"{key}/{leaf}"]
                want = per_device[rank]
                assert got.shape == want.shape, (key, leaf, rank)
                if rtol is None:
                    continue
                scale = np.linalg.norm(want)
                if scale == 0:      # rows no token reaches (wpe's tail)
                    np.testing.assert_array_equal(got, want)
                    continue
                err = np.linalg.norm(got - want) / scale
                assert err <= rtol, (key, leaf, rank, err)
                other = per_device[(rank + 1) % world]
                if dims[leaf] is not None and key == "m" and \
                        np.linalg.norm(other) > 0:
                    miss = np.linalg.norm(got - other) / scale
                    assert miss > 10 * rtol, (key, leaf, rank, miss)
    if "model" in CASES[name]:
        # the odd width leaves LayerNorms and c_attn replicated
        assert dims["h.0.ln_1.weight"] is None
        assert dims["h.0.attn.c_attn.weight"] is None
        assert any(d is not None for d in dims.values())
