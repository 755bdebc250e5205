"""The top-level config keys the JAX config reads, in the port.

- Each key is accepted and read as the JAX ``DeepSpeedConfig`` reads it
  (this process).
- At world 2 over gloo (``tests/torch_zero_worker.py``), a run with the
  key set gives the losses and fp32 masters of the run without it, bit
  for bit, and the JAX engine's losses with the key (rtol of
  ``test_torch_zero_parity.py``). ``prescale_gradients`` and
  ``gradient_predivide_factor`` are no-ops as in JAX (its cross-replica
  mean is fp32), ``fp32_allreduce`` / ``disable_allgather`` /
  ``zero_allow_untested_optimizer`` / ``dump_state`` / ``vocabulary_size``
  / ``wall_clock_breakdown`` / ``memory_breakdown`` are read; ``amp``
  computes in bf16, so an ``amp`` run is the ``bf16`` run.
- ``zero_optimization.gather_chunks`` 2 and 4 and ``bidirectional``
  stripe each stage-3 all-gather into that many collectives: the gathers
  are bit-identical to one all-gather, so losses and masters are too.
- The training-feature keys ``activation_checkpointing``,
  ``progressive_layer_drop`` (theta 1: every sublayer kept),
  ``sparse_gradients`` and ``fp8`` are read as JAX reads them, and a run
  with each at world 2 gives the JAX engine's losses with the key.
- The ``inference`` block parses to the values of JAX's
  ``InferenceConfig``, and bad blocks raise JAX's errors.
- The keys whose features later work ports raise, naming their item.
"""

import numpy as np
import pytest

import deepspeed_tpu.runtime.config as jcfg
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests import torch_zero_harness as H

WORLD = 2
BASE = {"train_batch_size": 8, "steps_per_print": 10 ** 9}
F32 = dict(dtype="f32", flash=False, lr=1e-3)
BF16 = dict(dtype="bf16", flash=False, lr=1e-3)
KEYS = {
    "prescale_gradients": True,
    "gradient_predivide_factor": 2.0,
    "fp32_allreduce": True,
    "disable_allgather": True,
    "zero_allow_untested_optimizer": True,
    "dump_state": True,
    "vocabulary_size": 250,
    "wall_clock_breakdown": True,
    "memory_breakdown": True,
}
# the training-feature keys: read as JAX reads them, and a run with each
# (world 2) follows JAX's run with it
FEATURES = {
    "activation_checkpointing": {"partition_activations": True,
                                 "number_checkpoints": 3,
                                 "cpu_checkpointing": True},
    "progressive_layer_drop": {"enabled": True, "theta": 1.0,
                               "gamma": 0.01},
    "sparse_gradients": True,
    "fp8": {"enabled": True, "margin": 1, "amax_history_len": 8},
}
FEATURE_VIEW = {
    "activation_checkpointing": lambda c: vars(
        c.activation_checkpointing_config),
    "progressive_layer_drop": lambda c: (c.pld_enabled, c.pld_params),
    "sparse_gradients": lambda c: c.sparse_gradients_enabled,
    "fp8": lambda c: repr(c.fp8),
}
STRIPED = {"s3_chunks2": {"gather_chunks": 2},
           "s3_chunks4": {"gather_chunks": 4},
           "s3_bidirectional": {"bidirectional": True},
           "s3_chunks4_bidirectional": {"gather_chunks": 4,
                                        "bidirectional": True}}
CASES = {"f32": F32, "bf16": BF16, "amp": dict(BF16, amp=True),
         "s3_chunks1": dict(BF16, stage=3),
         "gather": dict(kind="gather", dtype="f32")}
CASES.update({f"key_{k}": dict(F32, keys={k: v}) for k, v in KEYS.items()})
CASES.update({f"key_{k}": dict(F32, keys={k: v})
              for k, v in FEATURES.items()})
CASES.update({n: dict(BF16, stage=3, zero=dict(z, stage=3))
              for n, z in STRIPED.items()})
LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-4}
FP8_LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def params():
    return H.init_jax_params(use_flash_attention=False)


@pytest.fixture(scope="module")
def world(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("config_keys")
    state = H.save_port_state(params, root / "tiny.npz")
    H.spawn_world(WORLD, [dict(c, name=n) for n, c in CASES.items()],
                  state, root / "out")
    return {n: H.load_results(root / "out", n, WORLD) for n in CASES}


def _same_run(a, b):
    for (x, _), (y, _) in zip(a, b):
        np.testing.assert_array_equal(x["losses"], y["losses"])
        for key in x:
            if key.startswith("param/"):
                np.testing.assert_array_equal(x[key], y[key], err_msg=key)


# ---------------------------------------------------------------------------
# the keys read (this process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(KEYS) + ["amp"] + sorted(FEATURES))
def test_each_key_is_read_as_jax_reads_it(key):
    if key in FEATURES:
        cfg = dict(BASE, **{key: FEATURES[key]})
        view = FEATURE_VIEW[key]
        port = view(DeepSpeedConfig(cfg))
        assert port == view(jcfg.DeepSpeedConfig(cfg, world_size=1))
        assert port != view(DeepSpeedConfig(BASE))
        return
    body = {"enabled": True} if key == "amp" else KEYS[key]
    cfg = dict(BASE, **{key: body})
    port = DeepSpeedConfig(cfg)
    want = jcfg.DeepSpeedConfig(cfg, world_size=1)
    attr = "amp_enabled" if key == "amp" else key
    assert getattr(port, attr) == getattr(want, attr)
    assert getattr(port, attr) != getattr(DeepSpeedConfig(BASE), attr)


def test_vocabulary_size_off_8_warns(monkeypatch):
    from deepspeed_tpu_torch.runtime import config
    said = []
    monkeypatch.setattr(config.logger, "warning", said.append)
    DeepSpeedConfig(dict(BASE, vocabulary_size=50257))
    assert len(said) == 1 and "not aligned to 8" in said[0]
    DeepSpeedConfig(dict(BASE, vocabulary_size=50304))
    assert len(said) == 1


@pytest.mark.parametrize("key,item", [
    ("telemetry", "item 6"), ("tensor_parallel", "item 5 F2"),
    ("comm_quantization", "item 5 F5"),
    ("resilience", "item 6"), ("elasticity", "item 6"),
    ("analysis", "item 6"), ("tensorboard", "item 6"),
    ("profiling", "item 6"), ("compilation_cache_dir", "item 6")])
def test_later_keys_name_their_item(key, item):
    with pytest.raises(ValueError, match=f"{key}.*not yet ported.*{item}"):
        DeepSpeedConfig(dict(BASE, **{key: {}}))


@pytest.mark.parametrize("key,value,attr,want", [
    ("pipeline", {}, "pipeline",
     {"stages": None, "partition": "best", "seed_layers": False,
      "activation_checkpoint_interval": 0}),
    ("pipeline", {"stages": 4, "activation_checkpoint_interval": 1},
     "pipeline", {"stages": 4, "partition": "best", "seed_layers": False,
                  "activation_checkpoint_interval": 1}),
    ("mesh", {"pipe": 2, "data": None}, "mesh_shape",
     {"pipe": 2, "data": None})])
def test_pipeline_and_mesh_keys_read_as_jax(key, value, attr, want):
    """The pipeline keys are read with JAX's defaults
    (``config.py:230-246``): JAX's own reader gives the same."""
    from deepspeed_tpu.runtime import config as jax_config
    got = getattr(DeepSpeedConfig(dict(BASE, **{key: value})), attr)
    assert got == want
    reader = jax_config.get_pipeline_config if key == "pipeline" else \
        jax_config.get_mesh_config
    assert reader({key: value}) == want


def test_unknown_keys_raise():
    with pytest.raises(ValueError, match="unknown key"):
        DeepSpeedConfig(dict(BASE, no_such_key=1))


# ---------------------------------------------------------------------------
# training with each key (world 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(KEYS))
def test_a_key_changes_no_bit_of_the_run(world, key):
    _same_run(world[f"key_{key}"], world["f32"])


def test_amp_is_the_bf16_run(world):
    _same_run(world["amp"], world["bf16"])


@pytest.mark.parametrize("name", sorted(KEYS) + ["amp"] + sorted(FEATURES))
def test_a_run_with_the_key_equals_jax(params, world, name):
    """Losses at the parity rtol; in f32 the fp32 masters too, at the
    f32 moments' relative L2 of ``test_torch_zero_parity.py`` per leaf
    (bf16 values differ across frameworks, ``ROADMAP.md`` section 3).
    An fp8 run is held to its losses only, at rtol 1e-3: the qdq of
    operands one fp32 ulp apart can land one fp8 step apart, and such a
    step moves the next losses by about 1e-4 (its first two steps agree
    at 1e-5)."""
    case = CASES["amp" if name == "amp" else f"key_{name}"]
    losses, engine, _ = H.jax_run(params, case, WORLD)
    arrays = world["amp" if name == "amp" else f"key_{name}"][0][0]
    np.testing.assert_allclose(
        arrays["losses"], losses,
        rtol=FP8_LOSS_RTOL if name == "fp8" else LOSS_RTOL[case["dtype"]])
    if case["dtype"] != "f32" or name == "fp8":
        return
    from jax.tree_util import tree_map
    from deepspeed_tpu_torch.models.gpt2 import convert_gpt2_params
    want = convert_gpt2_params(tree_map(np.asarray, engine.params))
    for leaf, w in want.items():
        got, w = arrays[f"param/{leaf}"], w.numpy()
        assert got.shape == w.shape, leaf
        if leaf.endswith("attn.c_attn.bias"):
            # the key third's true gradient is 0 (softmax ignores a bias
            # on every key alike): Adam scales both frameworks' rounding
            # noise there to steps of lr, so it is left out
            C = w.shape[0] // 3
            keys = np.s_[C:2 * C]
            got, w = np.delete(got, keys), np.delete(w, keys)
        err = np.linalg.norm(got - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-5, (leaf, err)


@pytest.mark.parametrize("name", sorted(STRIPED))
def test_striped_stage3_gathers_change_no_bit(world, name):
    _same_run(world[name], world["s3_chunks1"])
    chunks = CASES[name]["zero"].get("gather_chunks", 1)
    one = world["s3_chunks1"][0][1]["counts"]["all_gather"]
    got = world[name][0][1]["counts"]["all_gather"]
    assert got["bytes"] == one["bytes"]
    # every leaf of gpt2_tiny has at least 4 elements a rank
    assert got["calls"] == chunks * one["calls"]
    plan = world[name][0][1]["plan"]
    assert plan["gather_chunks"] == chunks
    assert plan["bidirectional"] == \
        CASES[name]["zero"].get("bidirectional", False)


def test_striped_gather_is_one_all_gather_bit_for_bit(world):
    rows = world["gather"]
    for arrays, _ in rows:
        for key, got in arrays.items():
            n, dtype, chunks, bidir = key.split("/")
            want = arrays[f"{n}/{dtype}/1/0"]
            np.testing.assert_array_equal(got, want, err_msg=key)
            assert not np.isnan(got).any()
    # the two ranks gathered the same whole
    for key in rows[0][0]:
        np.testing.assert_array_equal(rows[0][0][key], rows[1][0][key])


# ---------------------------------------------------------------------------
# the inference block
# ---------------------------------------------------------------------------

INFERENCE_OK = [
    {},
    {"max_batch": 8, "seq_buckets": [128, 512], "prefill_chunk": 64,
     "kv_cache_dtype": "int8", "attention_impl": "flash"},
    {"kv_layout": "paged", "page_size": 128, "n_pages": 33,
     "prefix_cache": False, "host_park_threshold": 0.5,
     "prefill_chunk": 64, "seq_buckets": [128, 512]},
    {"replicas": 3, "max_redispatch": 1, "max_queue_depth": 4,
     "deadline_s": 2.5, "queue_timeout_s": None},
    {"kv_layout": "paged", "disaggregated": True, "prefill_workers": 2,
     "decode_workers": 1, "prefill_max_batch": 2, "decode_max_batch": 4},
    {"speculative": {"enabled": True, "k": 4, "draft_layers": 6,
                     "min_accept_to_grow": 1.5}},
    {"temperature": 0.7, "top_k": 40, "top_p": 0.9, "sampling_seed": 3},
]
INFERENCE_BAD = [
    {"max_batch": 0}, {"seq_buckets": [100, 64]}, {"seq_buckets": [48]},
    {"prefill_chunk": 0}, {"kv_cache_dtype": "int4"},
    {"attention_impl": "sparse"}, {"attention_block_k": True},
    {"temperature": -1}, {"top_k": -1}, {"top_p": 0.0},
    {"sampling_seed": 1.5}, {"kv_layout": "tree"}, {"page_size": -1},
    {"kv_layout": "paged", "page_size": 48}, {"n_pages": 1},
    {"prefix_cache": 1}, {"host_park_threshold": 1.0}, {"replicas": 0},
    {"max_redispatch": -1}, {"max_queue_depth": 0}, {"deadline_s": -1},
    {"disaggregated": 1}, {"disaggregated": True},
    {"kv_layout": "paged", "disaggregated": True, "replicas": 2},
    {"prefill_workers": 0}, {"decode_max_batch": -1},
    {"speculative": 3}, {"speculative": {"enabled": True, "j": 1}},
    {"speculative": {"enabled": True, "k": 0}},
    {"speculative": {"enabled": True, "k": 511}},
    {"speculative": {"enabled": True}, "replicas": 2},
    {"no_such": 1},
]


def _inference_view(cfg):
    inf = cfg.inference
    return {k: v for k, v in vars(inf).items()} | \
        {"speculative": inf.speculative}


@pytest.mark.parametrize("block", INFERENCE_OK)
def test_inference_block_parses_as_jax(block):
    cfg = dict(BASE, inference=block)
    assert _inference_view(DeepSpeedConfig(cfg)) == \
        _inference_view(jcfg.DeepSpeedConfig(cfg, world_size=1))


@pytest.mark.parametrize("block", INFERENCE_BAD)
def test_bad_inference_blocks_raise_as_jax(block):
    cfg = dict(BASE, inference=block)
    with pytest.raises(ValueError) as want:
        jcfg.DeepSpeedConfig(cfg, world_size=1)
    with pytest.raises(ValueError) as got:
        DeepSpeedConfig(cfg)
    assert str(got.value) == str(want.value)
