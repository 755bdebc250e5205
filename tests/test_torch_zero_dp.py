"""The port's data-parallel engine across two gloo processes: what the
collectives move, stage 3's gather-on-use, the fp16 overflow vote, the
data loader's split, checkpoints across stage and world, and
ZeRO-Offload across processes; then the config and bootstrap checks
(in this process).

One module-scoped fixture spawns the world of ``tests/torch_zero_worker.
py`` processes once for every case; each assertion is its own
parametrized test. Communication volume is read off the engine's
``Comm`` counters (``runtime/zero/comm.py``), per step, against the
formulas of the ZeRO stages with P the fp32 bytes of the params (bytes
of the whole tensor: the all-reduce's operand, the reduce-scatter's
input, the all-gather's output):

- stage 0: one all-reduce of P, nothing else;
- stage 1: a reduce-scatter of P and the one param-sized refresh
  all-gather (P);
- stage 2: a reduce-scatter of P per micro-batch and the refresh;
- stage 3: all-gathers of P/2 (bf16) in each forward and again in each
  backward, and a reduce-scatter of P per micro-batch; per micro-batch,
  no more than stage 1 moves per step (``tests/unit/
  test_zero_comm_volume.py``'s claim).

A replicated leaf (none in ``gpt2_tiny`` at world 2) would move by
all-reduce instead; ``test_torch_zero_parity.py`` covers those.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.zero.sharding import partition_dim
from tests import torch_zero_harness as H
from tests.torch_threads import one_thread  # noqa: F401

WORLD = 2
BF16 = dict(dtype="bf16", flash=False, lr=1e-3, steps=2)
COMM = {f"comm_s{s}": dict(BF16, stage=s) for s in range(4)}
COMM.update({f"comm_s{s}_accum1": dict(BF16, stage=s, accum=1)
             for s in (1, 3)})
FLASH3 = dict(dtype="bf16", flash=True, lr=1e-3, steps=2, stage=3)
REMAT = {"gather_s3": FLASH3,
         "gather_s3_remat_full": dict(FLASH3, model={
             "remat": True, "remat_policy": "full"}),
         "gather_s3_remat_dots": dict(FLASH3, model={
             "remat": True, "remat_policy": "dots"}),
         "gather_s3_no_prefetch": dict(FLASH3, zero={"prefetch": False})}
OVERFLOW = {f"overflow_s{s}": dict(kind="overflow", dtype="fp16",
                                   stage=s, flash=False, poison_rank=1)
            for s in range(4)}
OTHER = {"loader": dict(kind="loader", dtype="f32"),
         "offload": dict(dtype="bf16", flash=False, lr=1e-3, steps=3,
                         zero={"stage": 2, "cpu_offload": True})}
CKPT = dict(kind="checkpoint", dtype="bf16", flash=False, lr=1e-3,
            stage=1, load_stage=3)


@pytest.fixture(scope="module")
def params():
    return H.init_jax_params(use_flash_attention=True)


@pytest.fixture(scope="module")
def world(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("zero_dp")
    state = H.save_port_state(params, root / "tiny.npz")
    ckpt_dir = str(root / "ckpt")
    offload_dir = str(root / "offload_ckpt")
    cases = {**COMM, **REMAT, **OVERFLOW, **OTHER,
             "offload": dict(OTHER["offload"], dir=offload_dir),
             "checkpoint": dict(CKPT, dir=ckpt_dir)}
    H.spawn_world(WORLD, [dict(c, name=n) for n, c in cases.items()],
                  state, root / "out")
    results = {n: H.load_results(root / "out", n, WORLD) for n in cases}
    return {"results": results, "ckpt": ckpt_dir, "state": state,
            "offload_ckpt": offload_dir}


def _counts(world, name):
    """Rank 0's collective counts over the case's last step."""
    return world["results"][name][0][1]["counts"]


# ---------------------------------------------------------------------------
# communication volume
# ---------------------------------------------------------------------------

def _formula(stage, p, accum):
    half = p // 2
    return {0: {"all_reduce": p, "reduce_scatter": 0, "all_gather": 0},
            1: {"all_reduce": 0, "reduce_scatter": p, "all_gather": p},
            2: {"all_reduce": 0, "reduce_scatter": accum * p,
                "all_gather": p},
            3: {"all_reduce": 0, "reduce_scatter": accum * p,
                "all_gather": 2 * accum * half}}[stage]


@pytest.mark.parametrize("name", sorted(COMM))
def test_collective_bytes_per_step_follow_the_stage(world, name):
    case = COMM[name]
    counts = _counts(world, name)
    p = sum(a.nbytes for k, a in world["results"][name][0][0].items()
            if k.startswith("param/"))
    want = _formula(case["stage"], p, case.get("accum", 2))
    got = {k: counts[k]["bytes"] for k in want}
    assert got == want, (got, want)
    # the scalar votes: the loss mean, and from stage 1 the global norm
    assert counts["stat"]["calls"] == (1 if case["stage"] == 0 else 2)


def test_stage0_moves_only_all_reduces(world):
    counts = _counts(world, "comm_s0")
    assert counts["reduce_scatter"]["calls"] == 0
    assert counts["all_gather"]["calls"] == 0
    assert counts["all_reduce"]["calls"] == len(
        [k for k in world["results"]["comm_s0"][0][0]
         if k.startswith("param/")])


def test_stage3_moves_no_more_than_stage1(world):
    def total(name):
        counts = _counts(world, name)
        return sum(counts[k]["bytes"] for k in
                   ("all_reduce", "reduce_scatter", "all_gather"))
    assert total("comm_s3_accum1") <= total("comm_s1_accum1")


# ---------------------------------------------------------------------------
# stage 3: gather on use, again in the backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REMAT))
def test_stage3_gathers_each_leaf_twice_per_micro_batch(world, name):
    case = REMAT[name]
    _, meta = world["results"][name][0]
    leaves = meta["plan"]["gather_leaves"]
    micro = case["steps"] * case.get("accum", 2)
    assert meta["gathers"] == micro * leaves
    assert meta["regathers"] == micro * leaves
    assert meta["counts"]["all_gather"]["calls"] == \
        2 * case.get("accum", 2) * leaves


@pytest.mark.parametrize("name", sorted(REMAT))
def test_no_gathered_copy_outlives_the_forward(world, name):
    _, meta = world["results"][name][0]
    alive = meta["alive_after_forward"]
    assert alive["gathered"] == meta["plan"]["gather_leaves"]
    assert alive["alive"] == 0


@pytest.mark.parametrize("name", sorted(set(REMAT) - {"gather_s3"}))
def test_remat_and_prefetch_change_no_bit(world, name):
    want = world["results"]["gather_s3"][0][0]
    got = world["results"][name][0][0]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# the fp16 overflow vote
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(OVERFLOW))
def test_inf_on_one_rank_skips_the_step_on_every_rank(world, name):
    for arrays, meta in world["results"][name]:
        assert meta["overflow"] and meta["skipped"] == 1
        assert not meta["changed"]
    scales = [float(a["loss_scale"]) for a, _ in world["results"][name]]
    assert scales[0] == scales[1]


# ---------------------------------------------------------------------------
# the data loader
# ---------------------------------------------------------------------------

def test_each_rank_takes_the_jax_loaders_strided_rows(world):
    from deepspeed_tpu.runtime.dataloader import (
        DeepSpeedDataLoader as JaxLoader)
    rows = np.arange(40, dtype=np.int64)[:, None].repeat(3, axis=1)
    for rank, (arrays, meta) in enumerate(world["results"]["loader"]):
        assert (meta["index"], meta["count"]) == (rank, WORLD)
        want = np.stack(list(JaxLoader(rows, batch_size=8, seed=3,
                                       process_index=rank,
                                       process_count=WORLD)))
        np.testing.assert_array_equal(arrays["rows"], want)


# ---------------------------------------------------------------------------
# checkpoints across stage and world
# ---------------------------------------------------------------------------

def _leaf_keys(arrays, prefix):
    return sorted(k[len(prefix):] for k in arrays if k.startswith(prefix))


def test_checkpoint_loads_at_another_stage_on_the_same_world(world):
    for arrays, _ in world["results"]["checkpoint"]:
        keys = _leaf_keys(arrays, "saved/")
        assert keys == _leaf_keys(arrays, "loaded/")
        for k in keys:
            np.testing.assert_array_equal(arrays[f"loaded/{k}"],
                                          arrays[f"saved/{k}"], err_msg=k)


def test_resume_is_bit_exact_against_the_uninterrupted_run(world):
    for arrays, _ in world["results"]["checkpoint"]:
        np.testing.assert_array_equal(arrays["resumed"], arrays["continued"])


def test_checkpoint_from_two_processes_loads_in_one(world):
    """Saved at world 2, stage 1; loaded here at world 1, stage 0."""
    saved = world["results"]["checkpoint"][0][0]
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16,
                                 use_flash_attention=False), device="cpu")
    engine, _, _, _ = initialize(model=model, config={
        "train_batch_size": 8, "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        device="cpu")
    engine.load_checkpoint(world["ckpt"], tag="t2")
    names = engine._param_names()
    for n, p, m, v in zip(names, engine.params, engine.opt_state.m,
                          engine.opt_state.v):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved[f"saved/param/{n}"])
        np.testing.assert_array_equal(m.numpy(), saved[f"saved/m/{n}"])
        np.testing.assert_array_equal(v.numpy(), saved[f"saved/v/{n}"])
    assert engine.global_steps == 2


# ---------------------------------------------------------------------------
# ZeRO-Offload across processes
# ---------------------------------------------------------------------------

def test_offload_across_processes_matches_the_single_process_oracle(
        world, params):
    """The JAX single-process offload engine on the global batch is the
    oracle (``tests/unit/test_multihost.py``'s), within rtol 1e-4."""
    case = OTHER["offload"]
    engine, _ = H.jax_engine(params, case, 1)
    assert engine._offload
    want = [float(engine.train_batch({"input_ids": x}))
            for x in H.jax_batches(case)]
    got = world["results"]["offload"][0][0]["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_offload_checkpoint_from_two_processes_loads_in_one(world):
    """Saved by two offload processes (each host state made whole
    first), loaded by one: the same host masters and moments."""
    rows = world["results"]["offload"]
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16,
                                 use_flash_attention=False), device="cpu")
    engine, _, _, _ = initialize(model=model, config={
        "train_batch_size": 8, "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": 2, "cpu_offload": True},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        device="cpu")
    engine.load_checkpoint(world["offload_ckpt"], tag="last")
    opt = engine.cpu_optimizer
    np.testing.assert_array_equal(opt.master.numpy(),
                                  rows[0][0]["host/master"])
    np.testing.assert_array_equal(opt.exp_avg.numpy(),
                                  rows[0][0]["host/exp_avg"])
    np.testing.assert_array_equal(opt.exp_avg_sq.numpy(),
                                  rows[0][0]["host/exp_avg_sq"])


def test_offload_host_state_is_identical_across_processes(world):
    rows = world["results"]["offload"]
    for key in ("host/master", "host/exp_avg", "host/exp_avg_sq"):
        np.testing.assert_array_equal(rows[0][0][key], rows[1][0][key])
    np.testing.assert_array_equal(rows[0][0]["losses"], rows[1][0]["losses"])


# ---------------------------------------------------------------------------
# config and bootstrap (this process, no group)
# ---------------------------------------------------------------------------

ZERO_BASE = {"train_batch_size": 8, "bf16": {"enabled": True}}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stages_without_offload_are_accepted(stage):
    cfg = DeepSpeedConfig(dict(ZERO_BASE,
                               zero_optimization={"stage": stage}))
    assert cfg.zero_optimization_stage == stage
    assert cfg.zero_config.cpu_offload is False


@pytest.mark.parametrize("zero,what", [
    ({"stage": 3, "gather_chunks": 2}, "gather_chunks"),
    ({"stage": 3, "bidirectional": True}, "bidirectional"),
])
def test_ring_schedule_settings_raise_not_yet_ported(zero, what):
    # ported: each stage-3 gather striped into gather_chunks collectives,
    # bidirectional alternating their order (runtime/zero/comm.py);
    # tests/test_torch_config_keys.py holds them bit-identical to one
    # all-gather
    cfg = DeepSpeedConfig(dict(ZERO_BASE, zero_optimization=zero))
    assert getattr(cfg.zero_config, what) == zero[what]


def test_fp8_gather_wire_raises_not_yet_ported():
    # ported: the fp8 section and its stage-3 gather wire are read
    # (tests/test_torch_fp8.py runs the wire)
    cfg = DeepSpeedConfig(dict(ZERO_BASE, zero_optimization={"stage": 3},
                               fp8={"enabled": True,
                                    "wire": {"enabled": True}}))
    assert cfg.fp8.active_wire_dtype() == "f8e4m3fn"
    assert cfg.fp8.plan().amax_history_len == 16


@pytest.mark.parametrize("zero", [{"gather_chunks": 0},
                                  {"prefetch": "yes"},
                                  {"gather_on_use": 1}])
def test_malformed_stage3_keys_raise(zero):
    with pytest.raises(ValueError, match="zero_optimization"):
        DeepSpeedConfig(dict(ZERO_BASE,
                             zero_optimization=dict(zero, stage=3)))


def test_zero_still_needs_16_bit_compute():
    with pytest.raises(AssertionError, match="fp16 or bf16"):
        DeepSpeedConfig({"train_batch_size": 8,
                         "zero_optimization": {"stage": 1}})


@pytest.mark.parametrize("env,msg", [
    ({"DS_TPU_NUM_PROCESSES": "2", "DS_TPU_PROCESS_ID": "0"},
     "DS_TPU_COORDINATOR is missing"),
    ({"DS_TPU_NUM_PROCESSES": "2", "DS_TPU_COORDINATOR": "127.0.0.1:1"},
     "DS_TPU_PROCESS_ID is missing"),
])
def test_partial_launcher_env_raises_jax_message(monkeypatch, env, msg):
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=msg):
        mesh.initialize_distributed(device="cpu")
    assert not mesh.is_initialized()


def test_one_process_without_env_is_world_one(monkeypatch):
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.initialize_distributed(device="cpu") == 1
    assert (mesh.dp_world_size(), mesh.dp_rank()) == (1, 0)
    assert not mesh.is_initialized()


def test_cuda_engine_takes_nccl_or_raises(monkeypatch):
    import torch.distributed as dist
    assert mesh.backend_for("cpu") == "gloo"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    assert mesh.backend_for("cuda") == "nccl"
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh.backend_for("cuda")
    # a gloo group serves a CUDA engine only when every rank is on one
    # device (the model axis on one card); an NCCL group never serves a
    # CPU engine
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setattr(mesh, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(mesh, "ranks_share_one_device", lambda d: False)
    with pytest.raises(RuntimeError, match="only when every rank is on "
                                           "one physical device"):
        mesh.check_backend("cuda")
    monkeypatch.setattr(mesh, "ranks_share_one_device", lambda d: True)
    mesh.check_backend("cuda")
    mesh.check_backend("cpu")
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    with pytest.raises(RuntimeError, match="needs 'gloo'"):
        mesh.check_backend("cpu")


SHAPES = [(50257, 1024), (1024, 50257), (1024,), (3072, 1024),
          (1024, 1024), (15,), (45, 15), (60, 15), (1024, 4096), ()]


@pytest.mark.parametrize("world_size", [1, 2, 4, 8])
def test_partition_dim_is_the_jax_rule(world_size):
    from jax.sharding import PartitionSpec
    from deepspeed_tpu.runtime.zero.sharding import zero_partition_spec
    for shape in SHAPES:
        spec = tuple(zero_partition_spec(shape, PartitionSpec(), world_size))
        want = spec.index("data") if "data" in spec else None
        got = partition_dim(shape, world_size)
        if world_size == 1:
            # JAX shards nothing at world 1; the port cuts one piece
            assert want is None and got == (0 if shape else None)
        else:
            assert got == want, (shape, world_size, got, want)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_a_dropped_engine_frees_its_state(stage):
    """A dropped engine's buffers go at once, without the cyclic
    collector: the hooks it leaves on the model (stage 2's gradient hooks
    on the params, stage 3's module hooks) hold it weakly, and it holds
    no closure over itself."""
    import gc
    import weakref
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16), device="cpu")
    engine, _, _, _ = initialize(model=model, config=dict(
        ZERO_BASE, train_batch_size=4,
        zero_optimization={"stage": stage}), device="cpu")
    engine.train_batch({"input_ids": np.zeros((4, 8), np.int64)})
    refs = [weakref.ref(engine), weakref.ref(engine._masters[0]),
            weakref.ref(engine.opt_state.m[0])]
    gc.collect()
    gc.disable()
    try:
        del engine
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
    assert model is not None        # the model outlives its engine


@pytest.mark.parametrize("stage", [0, 3])
def test_bf16_forward_sees_the_jax_cast_params(stage):
    """Under bf16 the model sees every param rounded to bf16, LayerNorm
    scales included, as the JAX engine casts the tree before its model
    (``engine.py:223``); at stage 3 the gathered copy is that cast."""
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16), device="cpu")
    with torch.no_grad():
        model.h[0].ln_1.weight.uniform_(0.5, 1.5)   # not bf16-exact
    engine, _, _, _ = initialize(model=model, config=dict(
        ZERO_BASE, train_batch_size=4,
        zero_optimization={"stage": stage}), device="cpu")
    names = engine._param_names()
    master = engine._masters[names.index("h.0.ln_1.weight")].clone()
    seen = []
    model.h[0].ln_1.register_forward_pre_hook(
        lambda m, args: seen.append(m.weight.detach().clone()))
    engine.train_batch({"input_ids": np.zeros((4, 8), np.int64)})
    assert seen and seen[0].dtype == torch.bfloat16
    assert torch.equal(seen[0], master.to(torch.bfloat16))
    assert not torch.equal(seen[0].float(), master)


def test_a_process_passes_its_share_of_the_batch():
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16), device="cpu")
    engine, _, _, _ = initialize(model=model, config=dict(
        ZERO_BASE, zero_optimization={"stage": 1}), device="cpu")
    with pytest.raises(ValueError, match=r"expects 8 rows per process "
                       r"\(train_batch_size 8 / 1 processes\), got 4"):
        engine.train_batch({"input_ids": np.zeros((4, 8), np.int64)})


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_offload_steps_at_every_stage_in_one_process(stage):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16), device="cpu")
    engine, _, _, _ = initialize(model=model, config=dict(
        ZERO_BASE, train_batch_size=4,
        zero_optimization={"stage": stage, "cpu_offload": True}),
        device="cpu")
    assert not engine._offload_dp
    losses = [float(engine.train_batch(
        {"input_ids": np.zeros((4, 8), np.int64)})) for _ in range(2)]
    assert np.all(np.isfinite(losses)) and losses[1] < losses[0]
