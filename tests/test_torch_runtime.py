"""The training runtime's host pieces against the JAX package: the
config subset (`runtime/config.py`, cases of `tests/unit/test_config.py`
with the same errors and messages), the lr schedules
(`runtime/lr_schedules.py`), the loss-scale state machine
(`runtime/fp16/loss_scaler.py`) and the norm / clip / overflow helpers
(`runtime/utils.py`).

Tolerances: lr schedules rtol 1e-6 (both evaluate in float32; the
port's log/floor run in numpy); loss-scale sequences exact; norms
rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_ls
from deepspeed_tpu.runtime import utils as jax_utils
from deepspeed_tpu_torch.runtime import lr_schedules as lr
from deepspeed_tpu_torch.runtime import utils
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

VALID = {
    "all_three": ({"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
                   "gradient_accumulation_steps": 2}, 4),
    "infer_accum": ({"train_batch_size": 32,
                     "train_micro_batch_size_per_gpu": 4}, 4),
    "infer_micro": ({"train_batch_size": 32,
                     "gradient_accumulation_steps": 2}, 4),
    "infer_train": ({"train_micro_batch_size_per_gpu": 4,
                     "gradient_accumulation_steps": 2}, 4),
    "only_train": ({"train_batch_size": 32}, 4),
    "only_micro": ({"train_micro_batch_size_per_gpu": 3}, 1),
    "fp16_dynamic": ({"train_batch_size": 8, "fp16": {
        "enabled": True, "loss_scale": 0, "initial_scale_power": 16,
        "loss_scale_window": 500, "hysteresis": 3, "min_loss_scale": 2}}, 1),
    "fp16_static": ({"train_batch_size": 8,
                     "fp16": {"enabled": True, "loss_scale": 128}}, 1),
    "bf16": ({"train_batch_size": 8, "bf16": {"enabled": True}}, 1),
    "sections": ({"train_batch_size": 8,
                  "optimizer": {"type": "Adam",
                                "params": {"lr": 1e-3, "pallas": True}},
                  "scheduler": {"type": "WarmupLR",
                                "params": {"warmup_num_steps": 10}},
                  "gradient_clipping": 1.0, "steps_per_print": 5}, 1),
}
FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "fp16_enabled", "bf16_enabled",
          "loss_scale", "initial_dynamic_scale", "dynamic_loss_scale_args",
          "optimizer_name", "optimizer_params", "scheduler_name",
          "scheduler_params", "gradient_clipping", "steps_per_print")


@pytest.mark.parametrize("name", sorted(VALID))
def test_config_fields_match_jax(name):
    d, world = VALID[name]
    want = JaxConfig(dict(d), world_size=world)
    got = DeepSpeedConfig(dict(d), world_size=world)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field


ERRORS = {
    "inconsistent_triple": {"train_batch_size": 33,
                            "train_micro_batch_size_per_gpu": 4,
                            "gradient_accumulation_steps": 2},
    "no_batch": {},
    "fp16_and_bf16": {"train_batch_size": 8, "fp16": {"enabled": True},
                      "bf16": {"enabled": True}},
    "zero_batch": {"train_batch_size": 0},
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_config_errors_match_jax(name):
    d = ERRORS[name]
    with pytest.raises((AssertionError, ValueError)) as want:
        JaxConfig(dict(d), world_size=4)
    with pytest.raises(want.type) as got:
        DeepSpeedConfig(dict(d), world_size=4)
    assert str(got.value) == str(want.value)


def test_duplicate_json_keys_rejected(tmp_path):
    p = tmp_path / "ds_config.json"
    p.write_text('{"train_batch_size": 8, "train_batch_size": 16}')
    with pytest.raises(ValueError, match="Duplicate keys"):
        DeepSpeedConfig(str(p))


def test_json_file_load(tmp_path):
    p = tmp_path / "ds_config.json"
    p.write_text('{"train_batch_size": 16, "fp16": {"enabled": true}}')
    cfg = DeepSpeedConfig(str(p), world_size=2)
    assert cfg.train_micro_batch_size_per_gpu == 8 and cfg.fp16_enabled


@pytest.mark.parametrize("block", ["zero_optimization", "pipeline", "mesh",
                                   "sparse_attention", "fp8", "telemetry"])
def test_unported_blocks_raise(block):
    with pytest.raises(ValueError, match="not yet ported"):
        DeepSpeedConfig({"train_batch_size": 8, block: {}})


# ---------------------------------------------------------------------------
# lr schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "LRRangeTest": {"lr_range_test_min_lr": 1e-3,
                    "lr_range_test_step_size": 7,
                    "lr_range_test_step_rate": 2.0,
                    "lr_range_test_staircase": True},
    "OneCycle": {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                 "decay_lr_rate": 0.1, "cycle_first_step_size": 10,
                 "cycle_second_step_size": 6, "decay_step_size": 4,
                 "cycle_min_mom": 0.8, "cycle_max_mom": 0.95,
                 "decay_mom_rate": 0.05},
    "WarmupLR": {"warmup_min_lr": 1e-5, "warmup_max_lr": 3e-3,
                 "warmup_num_steps": 12},
    "WarmupDecayLR": {"total_num_steps": 30, "warmup_min_lr": 0.0,
                      "warmup_max_lr": 2e-3, "warmup_num_steps": 8},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    want = jax_lr.get_lr_scheduler(name, dict(SCHEDULES[name]))
    got = lr.get_lr_scheduler(name, dict(SCHEDULES[name]))
    steps = range(0, 40)
    np.testing.assert_allclose([got.lr_at(s) for s in steps],
                               [float(want.lr_at(s)) for s in steps],
                               rtol=1e-6)
    if name == "OneCycle":
        np.testing.assert_allclose([got.mom_at(s) for s in steps],
                                   [float(want.mom_at(s)) for s in steps],
                                   rtol=1e-6)
    for _ in range(3):
        got.step()
        want.step()
    assert got.get_lr() == pytest.approx(want.get_lr(), rel=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        lr.get_lr_scheduler("Cosine", {})


# ---------------------------------------------------------------------------
# loss scaling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delayed_shift,consecutive",
                         [(1, False), (2, False), (3, True)])
def test_loss_scale_sequence_matches_jax(delayed_shift, consecutive):
    rng = np.random.default_rng(delayed_shift)
    overflows = rng.random(60) < 0.3
    kw = dict(scale_factor=2.0, scale_window=4, min_scale=1.0,
              delayed_shift=delayed_shift,
              consecutive_hysteresis=consecutive)
    js = jax_ls.init_loss_scale_state(2.0 ** 10, delayed_shift)
    ts = ls.init_loss_scale_state(2.0 ** 10, delayed_shift)
    for ovf in overflows:
        js = jax_ls.update_loss_scale(js, bool(ovf), **kw)
        ts = ls.update_loss_scale(ts, torch.tensor(bool(ovf)), **kw)
        assert [float(x) for x in ts] == [float(x) for x in js]


def test_stateful_scalers_match_jax():
    want = jax_ls.DynamicLossScaler(init_scale=2 ** 8, scale_window=3,
                                    delayed_shift=2)
    got = ls.DynamicLossScaler(init_scale=2 ** 8, scale_window=3,
                               delayed_shift=2)
    for ovf in (False, True, True, False, False, False, True, False):
        want.update_scale(ovf)
        got.update_scale(ovf)
        assert (got.cur_scale, got.cur_iter, got.last_overflow_iter,
                got.cur_hysteresis) == (want.cur_scale, want.cur_iter,
                                        want.last_overflow_iter,
                                        want.cur_hysteresis)
    assert got.has_overflow([torch.tensor([1.0, float("inf")])])
    assert not got.has_overflow([torch.ones(3)])
    assert isinstance(ls.CreateLossScaler(static_loss_scale=8),
                      ls.LossScaler)
    assert ls.CreateLossScaler(dynamic_scale_args={
        "init_scale": 4, "scale_window": 2, "delayed_shift": 1,
        "min_scale": 1}).cur_scale == 4


# ---------------------------------------------------------------------------
# norms, clipping, overflow
# ---------------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((3,), (4, 5), (17,))]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_norm_and_clip_match_jax(max_norm):
    tree = _tree(0)
    want_norm = float(jax_utils.global_norm([jnp.asarray(x) for x in tree]))
    got_norm = float(utils.global_norm([torch.from_numpy(x) for x in tree]))
    assert got_norm == pytest.approx(want_norm, rel=1e-6)
    want = jax_utils.clip_by_global_norm([jnp.asarray(x) for x in tree],
                                         max_norm)
    got = utils.clip_by_global_norm([torch.from_numpy(x) for x in tree],
                                    max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_overflow_check():
    tree = [torch.from_numpy(x) for x in _tree(1)]
    assert not bool(utils.check_overflow(tree))
    tree[1][2, 3] = float("nan")
    assert bool(utils.check_overflow(tree))
    tree[1][2, 3] = float("-inf")
    assert bool(utils.check_overflow(tree))
