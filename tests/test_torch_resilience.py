"""Resilience in the port's training engine (``runtime/resilience/``,
``runtime/engine.py``): the counterpart of each engine-level case of
JAX's ``tests/unit/test_fault_injection.py`` and of each case of
``tests/unit/test_hot_checkpoint.py``, and the restore ladder.

Every injected fault is either recovered or fails with a typed error:

- NaN gradients (the guard's device check runs in fp32 too; ``skip_step``
  keeps the masters, so a run continues bit for bit as a run whose step
  never updated);
- checkpoint I/O failures mid-write (retried; exhausted, a typed error
  and a clean layout);
- preemption (a real SIGTERM through the installed handler: the
  checkpoint lands, ``PreemptedError`` is raised, a fresh engine with
  another seed and ``auto_resume`` continues the loss curve bit for
  bit). The SIGTERM cases run in a child process, so the signal and the
  handler stay out of the test process;
- host-Adam worker failures on the offload path;
- the hot tier: snapshots that nothing aliases, CRC checks, capacity
  eviction and the mirror; rollback and auto-resume down the ladder hot
  RAM, hot mirror, disk (a torn newest disk checkpoint falls back to the
  one before it).

The model is a two-layer MLP with an MSE loss (JAX's
``tests/unit/simple_model.py``), f32 unless a case says otherwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:       # run as a script (the SIGTERM child)
    sys.path.insert(0, ROOT)

from deepspeed_tpu_torch import initialize  # noqa: E402
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig  # noqa: E402
from deepspeed_tpu_torch.runtime.resilience import (  # noqa: E402
    HealthGuardAbort,
    fault_injection,
)
from deepspeed_tpu_torch.runtime.resilience.checkpoint import (  # noqa: E402
    CheckpointIOError,
)
from deepspeed_tpu_torch.runtime.resilience.hotckpt import (  # noqa: E402
    MIRROR_LATEST_NAME,
    MIRROR_PREFIX,
    MIRROR_STATE_NAME,
    HotCheckpointCorruptError,
    HotCheckpointStore,
)
from deepspeed_tpu_torch.runtime.resilience.retry import (  # noqa: E402
    HostAdamError,
)

BATCH, HIDDEN = 16, 10


class MLP(nn.Module):
    """Two linear layers, ReLU between, MSE against ``y``; weights
    N(0, 0.1) from ``seed``."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = nn.ParameterList(
            nn.Parameter(torch.randn(HIDDEN, HIDDEN, generator=g) * 0.1)
            for _ in range(2))
        self.b = nn.ParameterList(nn.Parameter(torch.zeros(HIDDEN))
                                  for _ in range(2))

    def loss_fn(self, batch, rng=None):
        x = batch["x"]
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x.to(w.dtype) @ w + b
            if i == 0:
                x = torch.relu(x)
        return ((x.float() - batch["y"]) ** 2).mean()


def config(**overrides):
    cfg = {"train_batch_size": BATCH, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(overrides)
    return cfg


def make_engine(seed=0, **cfg):
    engine, _, _, _ = initialize(model=MLP(seed), config=config(**cfg),
                                 device="cpu", seed=seed)
    return engine


def random_batch(seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(size=(BATCH, HIDDEN)).astype(
        np.float32)) for k in ("x", "y")}


def run_steps(engine, n, start=0):
    return [float(engine.train_batch(random_batch(start + i)))
            for i in range(n)]


def masters(engine):
    return [p.detach().clone() for p in engine.module.parameters()]


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture
def faults():
    fault_injection.clear_faults()
    yield fault_injection
    fault_injection.clear_faults()


# ---------------------------------------------------------------------------
# the config block
# ---------------------------------------------------------------------------

def test_resilience_block_is_read_with_jax_defaults():
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    for block in ({}, {"save_dir": "/x", "auto_resume": True,
                       "guards": {"nan_grads": {"action": "skip_step"}},
                       "hot_checkpoint": {"enabled": True, "capacity": 2}}):
        got = DeepSpeedConfig(config(resilience=block)).resilience
        want = JaxConfig(config(resilience=block)).resilience
        assert repr(got) == repr(want)
        for attr in ("hot_interval_steps", "hot_capacity", "io_retries",
                     "host_adam_retries", "loss_spike_window",
                     "scale_collapse_patience", "hot_mirror_keep"):
            assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("block,match", [
    ({"auto_resume": True}, "auto_resume requires save_dir"),
    ({"save_interval_steps": 2}, "save_interval_steps requires save_dir"),
    ({"guards": {"loss_spike": {"action": "skip_step"}}},
     "'skip_step' is impossible"),
    ({"guards": {"nan_grads": {"action": "explode"}}}, "must be one of"),
    ({"guards": {"nan_grads": {"action": "rollback_to_checkpoint"}}},
     "requires save_dir"),
    ({"guards": {"scale_collapse": {"action": "warn"}}},
     "requires fp16"),
    ({"hot_checkpoint": {"enabled": True, "interval_steps": 0}},
     "interval_steps must be"),
    ({"checkpoint": {"io_retries": 0}}, "io_retries must be >= 1")])
def test_resilience_block_raises_jax_errors(block, match):
    with pytest.raises(ValueError, match=match):
        DeepSpeedConfig(config(resilience=block))


# ---------------------------------------------------------------------------
# NaN gradients (JAX TestNanGradInjection)
# ---------------------------------------------------------------------------

def test_skip_step_keeps_params_finite(faults):
    eng = make_engine(resilience={
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "skip_step"}}})
    faults.inject_nan_grads(at_steps=[1])
    run_steps(eng, 3)
    m = eng._last_metrics
    assert int(m["skipped_steps"]) == 1
    assert m["health/nan_trips"] == 1
    for p in eng.module.parameters():
        assert bool(torch.isfinite(p).all())


def test_skipped_step_matches_clean_run_params(faults):
    """A skipped NaN step leaves the masters and the Adam state as they
    were, so the run goes on as a run that never took that update: bit
    for bit equal to a clean run of the other batches (constant lr, no
    dropout)."""
    eng = make_engine(resilience={
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "skip_step"}}})
    faults.inject_nan_grads(at_steps=[1])
    run_steps(eng, 1)
    before = masters(eng)
    run_steps(eng, 1, start=1)          # the poisoned step
    assert_same(before, masters(eng))
    run_steps(eng, 1, start=2)
    clean = make_engine()
    run_steps(clean, 1)
    run_steps(clean, 1, start=2)
    assert_same(masters(clean), masters(eng))


def test_warn_only_does_not_skip(faults):
    eng = make_engine(resilience={
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "warn"}}})
    faults.inject_nan_grads(at_steps=[1])
    run_steps(eng, 2)
    m = eng._last_metrics
    assert m["health/nan_trips"] == 1
    assert int(m["skipped_steps"]) == 0


def test_abort_raises_typed_error(faults):
    eng = make_engine(resilience={
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "abort"}}})
    faults.inject_nan_grads(at_steps=[1])
    run_steps(eng, 1)
    with pytest.raises(HealthGuardAbort) as ei:
        run_steps(eng, 1, start=1)
    assert ei.value.trip.guard == "nan_grads"


def test_rollback_restores_pre_fault_state(faults, tmp_path):
    eng = make_engine(resilience={
        "save_dir": str(tmp_path),
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "rollback_to_checkpoint"}}})
    run_steps(eng, 2)
    eng.save_checkpoint(str(tmp_path))
    saved = masters(eng)
    faults.inject_nan_grads(at_steps=[2])
    run_steps(eng, 1, start=2)
    assert eng.global_steps == 2
    assert_same(saved, masters(eng))
    assert eng.last_recovery["tier"] == "disk"


def test_injection_disabled_is_inert(faults):
    faults.inject_nan_grads(at_steps=[0, 1])
    armed = run_steps(make_engine(), 2)
    faults.clear_faults()
    assert armed == run_steps(make_engine(), 2)


# ---------------------------------------------------------------------------
# checkpoint I/O (JAX TestCheckpointIOInjection)
# ---------------------------------------------------------------------------

def test_mid_write_failure_recovers_via_retry(faults, tmp_path):
    eng = make_engine(resilience={
        "save_dir": str(tmp_path), "fault_injection": {"enabled": True},
        "checkpoint": {"io_retries": 3, "io_retry_base_s": 0.001}})
    run_steps(eng, 1)
    faults.inject_io_failure("save", times=1)
    assert eng.save_checkpoint(str(tmp_path))
    path, _ = eng.load_checkpoint(str(tmp_path))
    assert path is not None


def test_exhausted_retries_typed_error_and_clean_layout(faults, tmp_path):
    eng = make_engine(resilience={
        "save_dir": str(tmp_path), "fault_injection": {"enabled": True},
        "checkpoint": {"io_retries": 2, "io_retry_base_s": 0.001}})
    run_steps(eng, 1)
    eng.save_checkpoint(str(tmp_path), tag="good")
    faults.inject_io_failure("save", times=10)
    with pytest.raises(CheckpointIOError):
        eng.save_checkpoint(str(tmp_path), tag="bad")
    faults.clear_faults()
    assert not os.path.isdir(tmp_path / "bad")
    path, _ = eng.load_checkpoint(str(tmp_path))
    assert path.endswith("good")


# ---------------------------------------------------------------------------
# preemption (JAX TestPreemptionInjection), in a child process
# ---------------------------------------------------------------------------

def _preemption_child(out_dir):
    """Both SIGTERM cases of JAX's suite; writes ``result.json``."""
    from deepspeed_tpu_torch.runtime.resilience import PreemptedError
    torch.set_num_threads(1)
    res = {}
    clean = run_steps(make_engine(), 5)
    d1 = os.path.join(out_dir, "a")
    eng = make_engine(resilience={
        "save_dir": d1, "preemption": {"save_on_sigterm": True},
        "fault_injection": {"enabled": True}})
    fault_injection.simulate_preemption(at_step=2)
    try:
        run_steps(eng, 5)
        res["raised"] = False
    except PreemptedError as e:
        res.update(raised=True, steps=eng.global_steps,
                   path=e.checkpoint_path, code=e.code,
                   isdir=os.path.isdir(e.checkpoint_path or ""))
    eng._preemption.uninstall()
    d2 = os.path.join(out_dir, "b")
    eng = make_engine(resilience={
        "save_dir": d2, "preemption": {"save_on_sigterm": True},
        "fault_injection": {"enabled": True}})
    fault_injection.simulate_preemption(at_step=3)
    losses = []
    try:
        for i in range(5):
            losses.append(float(eng.train_batch(random_batch(i))))
    except PreemptedError:
        pass
    eng._preemption.uninstall()
    res["before"] = len(losses)
    resumed = make_engine(seed=123, resilience={"save_dir": d2,
                                                "auto_resume": True})
    res["resumed_at"] = resumed.global_steps
    losses += run_steps(resumed, 2, start=3)
    res["losses"], res["clean"] = losses, clean
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    out = tmp_path_factory.mktemp("preempt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out / "result.json") as f:
        return json.load(f)


def test_sigterm_checkpoints_and_raises(preempted):
    assert preempted["raised"]
    assert preempted["steps"] == 2
    assert preempted["path"] is not None and preempted["isdir"]
    assert preempted["code"] == 0       # SystemExit(0): a clean exit


def test_resume_after_preemption_is_bit_exact(preempted):
    assert preempted["before"] == 3
    assert preempted["resumed_at"] == 3
    assert preempted["losses"] == preempted["clean"]


# ---------------------------------------------------------------------------
# host Adam (JAX TestHostAdamInjection)
# ---------------------------------------------------------------------------

OFFLOAD = {"zero_optimization": {"stage": 2, "cpu_offload": True},
           "bf16": {"enabled": True}}


def test_pre_kernel_failure_resubmits_exactly(faults):
    eng = make_engine(**OFFLOAD, resilience={
        "fault_injection": {"enabled": True}, "host_adam_retries": 2})
    l0 = run_steps(eng, 1)
    faults.inject_host_adam_failure(times=1)
    l1 = run_steps(eng, 1, start=1)
    clean = make_engine(**OFFLOAD)
    assert l0 + l1 == run_steps(clean, 2)
    assert torch.equal(clean.cpu_optimizer.master, eng.cpu_optimizer.master)


def test_exhausted_host_adam_retries_typed_error(faults):
    eng = make_engine(**OFFLOAD, resilience={
        "fault_injection": {"enabled": True}, "host_adam_retries": 1})
    run_steps(eng, 1)
    faults.inject_host_adam_failure(times=10)
    with pytest.raises(HostAdamError):
        run_steps(eng, 1, start=1)


def test_retries_disabled_typed_error(faults):
    eng = make_engine(**OFFLOAD, resilience={
        "fault_injection": {"enabled": True}, "host_adam_retries": 0})
    run_steps(eng, 1)
    faults.inject_host_adam_failure(times=1)
    with pytest.raises(HostAdamError) as ei:
        run_steps(eng, 1, start=1)
    assert "retries are disabled" in str(ei.value)


# ---------------------------------------------------------------------------
# guards without injection (JAX TestGuardsWithoutInjection)
# ---------------------------------------------------------------------------

def test_loss_spike_abort():
    eng = make_engine(resilience={"guards": {"loss_spike": {
        "action": "abort", "factor": 2.0, "min_history": 3}}})
    run_steps(eng, 4)
    big = random_batch(99)
    big["y"] = big["y"] + 1000.0
    with pytest.raises(HealthGuardAbort) as ei:
        eng.train_batch(big)
    assert ei.value.trip.guard == "loss_spike"


def test_scale_collapse_warn(faults):
    eng = make_engine(
        fp16={"enabled": True, "loss_scale": 0, "initial_scale_power": 2,
              "loss_scale_window": 1000},
        resilience={"fault_injection": {"enabled": True},
                    "guards": {"scale_collapse": {"action": "warn",
                                                  "patience": 2}}})
    faults.inject_nan_grads(at_steps=range(10))
    run_steps(eng, 10)
    assert eng._last_metrics["health/scale_collapse_trips"] >= 1
    assert int(eng._last_metrics["consecutive_skipped_steps"]) >= 1


# ---------------------------------------------------------------------------
# the hot tier (JAX tests/unit/test_hot_checkpoint.py)
# ---------------------------------------------------------------------------

def make_state(step):
    return {"params": {"w": np.arange(8, dtype=np.float32) + step,
                       "b": np.zeros(4, np.float32)},
            "step": np.asarray(step, np.int32)}


def make_template():
    return {"params": {"w": np.zeros(8, np.float32),
                       "b": np.zeros(4, np.float32)},
            "step": np.asarray(0, np.int32)}


@pytest.fixture
def store():
    s = HotCheckpointStore(capacity=2)
    yield s
    s.close()


def test_hot_round_trip(store):
    store.snapshot("step3", make_state(3), {"global_steps": 3},
                   topology={"world": 1})
    state, meta, topology = store.restore()
    assert meta["global_steps"] == 3 and topology == {"world": 1}
    np.testing.assert_array_equal(state["params"]["w"],
                                  make_state(3)["params"]["w"])


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_hot_snapshot_is_isolated(store, kind):
    """Changing the source after ``snapshot()`` does not reach the held
    copy: a torch tensor's ``.numpy()`` would alias it."""
    src = make_state(5)
    if kind == "torch":
        src["params"]["w"] = torch.from_numpy(src["params"]["w"])
    store.snapshot("step5", src, {})
    src["params"]["w"][:] = -1.0
    state, _, _ = store.restore()
    np.testing.assert_array_equal(state["params"]["w"],
                                  make_state(5)["params"]["w"])


def test_hot_capacity_evicts_oldest(store):
    for step in (1, 2, 3):
        store.snapshot(f"step{step}", make_state(step), {"s": step})
    store.wait()
    assert [s.tag for s in store._snaps] == ["step2", "step3"]
    assert store.restore()[1]["s"] == 3


def test_hot_restore_none_when_empty(store):
    assert store.restore() is None


def test_hot_corruption_detected_on_restore(store):
    store.snapshot("step1", make_state(1), {})
    store.wait()
    store._snaps[-1].state["params"]["w"][0] += 1.0
    with pytest.raises(HotCheckpointCorruptError) as ei:
        store.restore()
    assert "crc mismatch" in str(ei.value)


def test_hot_unstamped_snapshot_is_corrupt(store):
    snap = store.snapshot("step1", make_state(1), {})
    store.wait()
    snap.checksums = None
    with pytest.raises(HotCheckpointCorruptError):
        store.restore(snap)


def test_hot_mirror_write_and_load(tmp_path):
    store = HotCheckpointStore(capacity=1, mirror_dir=str(tmp_path))
    store.snapshot("step7", make_state(7), {"global_steps": 7},
                   topology={"world": 2})
    store.close()
    state, meta, topology = HotCheckpointStore.load_mirror(
        str(tmp_path), make_template())
    assert meta["global_steps"] == 7 and topology == {"world": 2}
    np.testing.assert_array_equal(state["params"]["w"],
                                  make_state(7)["params"]["w"])


def test_hot_mirror_gc_keeps_newest(tmp_path):
    store = HotCheckpointStore(capacity=1, mirror_dir=str(tmp_path),
                               mirror_keep=2)
    for step in range(4):
        store.snapshot(f"step{step}", make_state(step), {"s": step})
        store.wait()
    store.close()
    kept = sorted(n for n in os.listdir(tmp_path)
                  if n.startswith(MIRROR_PREFIX) and n != MIRROR_LATEST_NAME)
    assert kept == ["hot-step2", "hot-step3"]


def test_hot_mirror_load_skips_corrupt_newest(tmp_path):
    store = HotCheckpointStore(capacity=1, mirror_dir=str(tmp_path),
                               mirror_keep=2)
    for step in (1, 2):
        store.snapshot(f"step{step}", make_state(step), {"s": step})
        store.wait()
    store.close()
    victim = tmp_path / "hot-step2" / MIRROR_STATE_NAME
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    _, meta, _ = HotCheckpointStore.load_mirror(str(tmp_path),
                                                make_template())
    assert meta["s"] == 1


def test_hot_mirror_rejects_mismatched_template(tmp_path):
    store = HotCheckpointStore(capacity=1, mirror_dir=str(tmp_path))
    store.snapshot("step1", make_state(1), {})
    store.close()
    template = make_template()
    template["params"]["extra"] = np.zeros(2, np.float32)
    assert HotCheckpointStore.load_mirror(str(tmp_path), template) is None


def test_hot_mirror_load_empty_dir(tmp_path):
    assert HotCheckpointStore.load_mirror(str(tmp_path),
                                          make_template()) is None
    assert HotCheckpointStore.load_mirror(str(tmp_path / "missing"),
                                          make_template()) is None


# ---------------------------------------------------------------------------
# the restore ladder in the engine
# ---------------------------------------------------------------------------

HOT = {"enabled": True, "interval_steps": 1}


def test_rollback_restores_the_hot_snapshot_bitwise(faults, tmp_path):
    """A NaN step under ``rollback_to_checkpoint`` with the hot tier:
    the engine restores the last step's snapshot from RAM (no disk
    checkpoint exists), its masters, Adam state and step counter bit for
    bit."""
    eng = make_engine(resilience={
        "save_dir": str(tmp_path), "hot_checkpoint": HOT,
        "fault_injection": {"enabled": True},
        "guards": {"nan_grads": {"action": "rollback_to_checkpoint"}}})
    run_steps(eng, 2)
    saved, m = masters(eng), [t.clone() for t in eng.opt_state.m]
    assert eng.last_hot_snapshot["tag"] == "step2"
    assert eng.last_hot_snapshot["bytes"] > 0
    faults.inject_nan_grads(at_steps=[2])
    run_steps(eng, 1, start=2)
    assert eng.global_steps == 2
    assert eng.last_recovery["tier"] == "hot_ram"
    assert_same(saved, masters(eng))
    assert_same(m, eng.opt_state.m)
    assert not os.listdir(tmp_path)


def test_auto_resume_from_the_hot_mirror(tmp_path):
    """Fresh engines (other seeds) with ``auto_resume``: one with the hot
    tier takes the newest mirror snapshot before the disk checkpoint,
    one without it the disk checkpoint; both go on as the first engine
    does, bit for bit."""
    rz = {"save_dir": str(tmp_path / "disk"), "auto_resume": True,
          "save_interval_steps": 1,
          "hot_checkpoint": dict(HOT, mirror_dir=str(tmp_path / "hot"))}
    eng = make_engine(resilience=rz)
    assert eng.last_recovery is None and eng.global_steps == 0
    run_steps(eng, 3)
    eng._hot_store.wait()
    mirror = make_engine(seed=7, resilience=rz)
    disk = make_engine(seed=9, resilience=dict(rz, hot_checkpoint={}))
    assert mirror.last_recovery["tier"] == "hot_mirror"
    assert disk.last_recovery["tier"] == "disk"
    want = run_steps(eng, 2, start=3)
    for other in (mirror, disk):
        assert other.global_steps == 3
        assert run_steps(other, 2, start=3) == want
        assert_same(masters(eng), masters(other))


def test_auto_resume_falls_back_past_a_torn_newest(tmp_path):
    """The newest disk checkpoint torn (a leaf file cut short): the
    ladder loads the one before it."""
    rz = {"save_dir": str(tmp_path), "save_interval_steps": 1}
    eng = make_engine(resilience=rz)
    run_steps(eng, 3)
    newest = tmp_path / "global_step3" / "state" / "params"
    victim = next(p for p in sorted(newest.rglob("*.npy")))
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    fresh = make_engine(seed=3, resilience=dict(rz, auto_resume=True))
    assert fresh.global_steps == 2
    assert fresh.last_recovery["source"].endswith("global_step2")


if __name__ == "__main__":
    _preemption_child(sys.argv[1])
