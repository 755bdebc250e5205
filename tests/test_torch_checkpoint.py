"""Checkpoints in the port: ``CheckpointManager``
(`deepspeed_tpu_torch/runtime/resilience/checkpoint.py`, the JAX
manager's contract with one ``.npy`` a leaf) and the engine's
``save_checkpoint`` / ``load_checkpoint``.

Kill-and-resume is bit-exact (the JAX repo's
`tests/model/test_kill_and_resume.py` variants the port runs: fp32
dense, bf16 dense and bf16 offload with ``offload_chunk_mb`` 1): a run
checkpointed after step 3 and resumed by a fresh engine built from
other params and another seed gives the uninterrupted run's losses,
params and data position exactly, with dropout on. A JAX-written
checkpoint, read by the JAX engine's own ``load_checkpoint`` and
converted with ``convert_gpt2_params``, resumes in the port and
continues to the JAX engine's next losses within rtol 1e-4 (the f32
tolerance of `tests/test_torch_train_engine.py`).
"""

import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)
from deepspeed_tpu_torch.runtime.engine import CheckpointTopologyError
from deepspeed_tpu_torch.runtime.resilience import (
    CheckpointCorruptError,
    CheckpointIOError,
    CheckpointManager,
    fault_injection,
)
from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
    MANIFEST_NAME,
    TMP_PREFIX,
)
from tests.torch_threads import one_thread  # noqa: F401

TOTAL, SAVE_AT = 6, 3
T = 16
BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 0.0,
                                 "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 4}}}
VARIANTS = {
    "fp32-dense": (torch.float32, {}),
    "bf16-dense": (torch.bfloat16, {"bf16": {"enabled": True}}),
    "bf16-offload": (torch.bfloat16, {
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": 2, "cpu_offload": True,
                              "offload_chunk_mb": 1}}),
}


class TokenDataset:
    def __init__(self, n=40, seed=0):
        self.ids = np.random.default_rng(seed).integers(
            0, 256, (n, T)).astype(np.int64)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


def _engine(variant, seed=0, dropout=0.1):
    dtype, extra = VARIANTS[variant]
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = GPT2LMHead(gpt2_tiny(dtype=dtype, dropout=dropout,
                                 use_flash_attention=True),
                       device="cpu", generator=gen)
    engine, _, _, _ = initialize(model=model, config=dict(BASE, **extra),
                                 device="cpu", seed=seed,
                                 training_data=TokenDataset())
    return engine


def _masters(engine):
    if engine.cpu_optimizer is not None:
        return engine.cpu_optimizer.master.clone()
    return torch.cat([p.detach().reshape(-1) for p in engine.params])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kill_and_resume_bit_exact(tmp_path, variant):
    full = _engine(variant)
    full_curve = [float(full.train_batch()) for _ in range(TOTAL)]

    killed = _engine(variant)
    killed_curve = [float(killed.train_batch()) for _ in range(SAVE_AT)]
    killed.save_checkpoint(str(tmp_path), client_state={"note": "k"})
    served = killed._data_iter.samples_served
    del killed

    # other params and another seed: the checkpoint decides everything
    resumed = _engine(variant, seed=123)
    path, client = resumed.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == f"global_step{SAVE_AT}"
    assert client == {"note": "k"}
    assert resumed.global_steps == SAVE_AT
    assert resumed._data_iter.samples_served == served == SAVE_AT * 8
    resumed_curve = [float(resumed.train_batch())
                     for _ in range(TOTAL - SAVE_AT)]
    assert killed_curve == full_curve[:SAVE_AT]
    assert resumed_curve == full_curve[SAVE_AT:]
    assert torch.equal(_masters(resumed), _masters(full))
    assert resumed.lr_scheduler.state_dict() == full.lr_scheduler.state_dict()


def _save_steps(engine, root, tags, **kw):
    for tag in tags:
        engine.train_batch()
        engine.save_checkpoint(root, tag=tag, **kw)


def _leaf_file(root, tag, leaf="params/wte"):
    return os.path.join(root, tag, "state", *leaf.split("/")) + ".npy"


def test_truncated_leaf_makes_resolve_tag_fall_back(tmp_path):
    root = str(tmp_path)
    engine = _engine("fp32-dense")
    _save_steps(engine, root, ["s1", "s2"])
    want = _masters(engine)
    engine.train_batch()
    with open(_leaf_file(root, "s2"), "r+b") as f:
        f.truncate(100)                 # a partial write
    mgr = CheckpointManager()
    assert mgr.resolve_tag(root) == "s1"
    with pytest.raises(CheckpointCorruptError, match="size mismatch"):
        mgr.resolve_tag(root, "s2")     # an explicit tag is strict
    fresh = _engine("fp32-dense", seed=5)
    path, _ = fresh.load_checkpoint(root)
    assert os.path.basename(path) == "s1" and fresh.global_steps == 1
    assert not torch.equal(_masters(fresh), want)


def test_flipped_byte_fails_the_leaf_checksum(tmp_path):
    root = str(tmp_path)
    _save_steps(_engine("bf16-offload"), root, ["s1"])
    leaf = _leaf_file(root, "s1", "opt_state/exp_avg")
    with open(leaf, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(CheckpointCorruptError, match="checksum mismatch"):
        CheckpointManager().load(root, "s1")


def test_tmp_dir_left_behind_is_never_loaded(tmp_path):
    """A save that dies after its state files are written leaves only
    ``.tmp.<tag>``: the previous checkpoints, ``latest`` and loads are
    untouched, and a later save of the same tag overwrites it."""
    root = str(tmp_path)
    engine = _engine("fp32-dense")
    _save_steps(engine, root, ["s1"])
    engine.train_batch()
    mgr = engine._ckpt_manager
    fault_injection.clear_faults()
    try:
        fault_injection.inject_io_failure("save", times=mgr.io_retries)
        with pytest.raises(CheckpointIOError):
            engine.save_checkpoint(root, tag="s2")
    finally:
        fault_injection.clear_faults()
    assert os.path.isdir(os.path.join(root, TMP_PREFIX + "s2"))
    assert not os.path.exists(os.path.join(root, "s2"))
    assert [t for t, _, _ in mgr.list_checkpoints(root)] == ["s1"]
    with open(os.path.join(root, "latest")) as f:
        assert f.read() == "s1"
    fresh = _engine("fp32-dense", seed=5)
    path, _ = fresh.load_checkpoint(root)
    assert os.path.basename(path) == "s1"
    # one transient failure is retried: the save goes through
    fault_injection.inject_io_failure("save", times=1)
    try:
        engine.save_checkpoint(root, tag="s2")
    finally:
        fault_injection.clear_faults()
    assert not os.path.exists(os.path.join(root, TMP_PREFIX + "s2"))
    assert mgr.resolve_tag(root) == "s2"


def test_keep_last_n_prunes_the_oldest(tmp_path):
    root = str(tmp_path)
    engine = _engine("bf16-dense")
    engine._ckpt_manager = CheckpointManager(keep_last_n=2)
    _save_steps(engine, root, ["a", "b", "c", "d"])
    assert sorted(os.listdir(root)) == ["c", "d", "latest"]
    assert [t for t, _, _ in
            engine._ckpt_manager.list_checkpoints(root)] == ["d", "c"]


def test_async_save_matches_the_sync_one(tmp_path):
    engine = _engine("bf16-offload")
    engine.train_batch()
    mgr = CheckpointManager(async_save=True)
    engine._ckpt_manager = mgr
    engine.save_checkpoint(str(tmp_path / "a"), tag="t")
    engine.train_batch()                 # mutates the buffers meanwhile
    mgr.wait()
    engine._ckpt_manager = CheckpointManager()
    state_a, meta_a, _ = mgr.load(str(tmp_path / "a"), "t")
    assert meta_a["global_steps"] == 1
    fresh = _engine("bf16-offload", seed=7)
    fresh._ckpt_manager = CheckpointManager()
    fresh.load_checkpoint(str(tmp_path / "a"))
    assert fresh.global_steps == 1 and fresh.cpu_optimizer._step == 1


def test_bf16_leaves_read_back_with_numpy_alone(tmp_path):
    x = torch.randn(5, 7).to(torch.bfloat16)
    state = {"a": {"x": x, "y": np.arange(6, dtype=np.int32)},
             "step": np.int64(3)}
    mgr = CheckpointManager()
    path = mgr.save(str(tmp_path), "t", state, {"global_steps": 3})
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["arrays"]["a/x"]["dtype"] == "bfloat16"
    assert manifest["arrays"]["a/y"]["dtype"] == "int32"
    bits = np.load(os.path.join(path, manifest["arrays"]["a/x"]["file"]))
    assert bits.dtype == np.uint16 and bits.shape == (5, 7)
    got, meta, _ = mgr.load(str(tmp_path), "t")
    assert got["a"]["x"].dtype == torch.bfloat16
    assert torch.equal(got["a"]["x"], x)
    np.testing.assert_array_equal(got["a"]["y"], np.arange(6))
    assert int(got["step"]) == 3 and meta == {"global_steps": 3}


def test_another_offload_setting_raises_typed(tmp_path):
    root = str(tmp_path)
    _save_steps(_engine("bf16-offload"), root, ["s1"])
    with pytest.raises(CheckpointTopologyError, match="offload"):
        _engine("bf16-dense").load_checkpoint(root)


def test_load_without_optimizer_or_scheduler_states(tmp_path):
    root = str(tmp_path)
    engine = _engine("bf16-offload")
    _save_steps(engine, root, ["s1", "s2"])
    fresh = _engine("bf16-offload", seed=9)
    before = fresh.cpu_optimizer.exp_avg.clone()
    sched = fresh.lr_scheduler.state_dict()
    fresh.load_checkpoint(root, load_optimizer_states=False,
                          load_lr_scheduler_states=False)
    assert torch.equal(fresh.cpu_optimizer.exp_avg, before)
    assert fresh.cpu_optimizer._step == 0
    assert fresh.lr_scheduler.state_dict() == sched
    assert torch.equal(fresh.cpu_optimizer.master,
                       engine.cpu_optimizer.master)
    assert fresh.load_checkpoint(str(tmp_path / "empty")) == (None, {})


def test_jax_written_checkpoint_resumes_in_the_port(tmp_path):
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
    from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
    from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn
    from deepspeed_tpu.parallel.mesh import build_mesh

    config = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, use_flash_attention=True))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (8, 32)).astype(np.int32)}
               for _ in range(5)]

    def jax_engine():
        return deepspeed_tpu.initialize(
            config=dict(config), loss_fn=make_gpt2_loss_fn(model),
            params=params, mesh=build_mesh({}, devices=jax.devices()[:1]))[0]

    jeng = jax_engine()
    for b in batches[:3]:
        jeng.train_batch(b)
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="j3")
    want = [float(jeng.train_batch(b)) for b in batches[3:]]

    # the JAX engine's own reader, then the port's format
    reader = jax_engine()
    reader.load_checkpoint(str(tmp_path / "jax"), tag="j3")

    def host(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    ds = reader.device_state
    state = {
        "params": convert_gpt2_params(host(reader.params)),
        "opt_state": {"m": convert_gpt2_params(host(reader.opt_state.m)),
                      "v": convert_gpt2_params(host(reader.opt_state.v)),
                      "step": np.asarray(reader.opt_state.step)},
        "device_state": {
            "cur_scale": np.asarray(ds.loss_scale.cur_scale),
            "cur_iter": np.asarray(ds.loss_scale.cur_iter),
            "last_overflow_iter": np.asarray(
                ds.loss_scale.last_overflow_iter),
            "cur_hysteresis": np.asarray(ds.loss_scale.cur_hysteresis),
            "global_step": np.asarray(ds.global_step),
            "skipped_steps": np.asarray(ds.skipped_steps),
            "consecutive_skipped": np.asarray(ds.consecutive_skipped)}}
    meta = {"global_steps": reader.global_steps,
            "micro_steps": reader.micro_steps, "seed": 0,
            "lr_scheduler": None, "dataloader": None, "client_state": {}}
    CheckpointManager().save(
        str(tmp_path / "port"), "j3", state, meta,
        extra_manifest={"topology": {"world_size": 1, "zero_stage": 0,
                                     "offload": False}})

    port_model = GPT2LMHead(gpt2_tiny(dtype=torch.float32,
                                      use_flash_attention=True),
                            device="cpu")
    teng, _, _, _ = initialize(model=port_model, config=dict(config),
                               device="cpu")
    teng.load_checkpoint(str(tmp_path / "port"))
    assert teng.global_steps == 3 and int(teng.opt_state.step) == 3
    got = [float(teng.train_batch(b)) for b in batches[3:]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
