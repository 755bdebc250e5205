"""Serving a training checkpoint, and serving from a config file, with
the port's serve CLI (``deepspeed_tpu_torch/inference/serve.py``) on the
CPU.

- ``--checkpoint``: a checkpoint the port's training engine saved
  (``runtime/resilience/checkpoint.py``; its ``params`` keyed by
  ``GPT2LMHead`` state-dict names) serves the same greedy stream, bit
  for bit, as an engine built straight from the training engine's fp32
  params; the geometry comes from the leaf shapes and ``--n-head``, and
  ``--ckpt-tag`` picks an older tag. Bad checkpoints are usage errors.
- ``--config``: a JSON file's ``inference`` block serves what the same
  flags serve.
"""

import json

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.inference import serve
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny

SERVE = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4}
STEPS = 3


def _train(tmp_path, dtype, zero=None):
    """A gpt2_tiny training engine after STEPS Adam steps, with a
    checkpoint saved at every step (tags ``step1`` ..)."""
    gen = torch.Generator().manual_seed(0)
    model = GPT2LMHead(gpt2_tiny(dtype=dtype), device="cpu", generator=gen)
    config = {"train_batch_size": 4, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if dtype == torch.bfloat16:
        config["bf16"] = {"enabled": True}
    if zero is not None:
        config["zero_optimization"] = {"stage": zero}
    engine, _, _, _ = initialize(model=model, config=config, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(1, STEPS + 1):
        engine.train_batch({"input_ids": rng.integers(0, 256, (4, 32))})
        engine.save_checkpoint(str(tmp_path), tag=f"step{step}")
    return engine


def _fp32_params(engine):
    return {n: t.detach().float().clone() for n, t in
            engine._checkpoint_state_tree()["params"].items()}


def _requests_file(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "requests.jsonl"
    with open(path, "w") as f:
        for i, n in enumerate((3, 9, 14, 6)):
            f.write(json.dumps({"rid": f"q{i}", "max_new_tokens": 6,
                                "prompt": rng.integers(0, 256, n)
                                .tolist()}) + "\n")
    return str(path)


def _direct_stream(params, requests):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    engine = InferenceEngine(model, params, config=SERVE, device="cpu")
    reqs = []
    with open(requests) as f:
        for line in f:
            d = json.loads(line)
            reqs.append(Request(d["rid"], d["prompt"],
                                max_new_tokens=d["max_new_tokens"]))
    return {c.rid: list(c.tokens)
            for c in ContinuousBatchingScheduler(engine).run(reqs)}


def _serve_json(capsys, *argv):
    capsys.readouterr()         # what training logged
    assert serve.main(["--device", "cpu", "--json", *argv]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("dtype,zero", [(torch.float32, None),
                                        (torch.bfloat16, 1)],
                         ids=["f32", "bf16_zero1"])
def test_served_checkpoint_streams_the_training_params(tmp_path, capsys,
                                                       dtype, zero):
    ckpt = tmp_path / "ckpt"
    engine = _train(ckpt, dtype, zero)
    requests = _requests_file(tmp_path)
    want = _direct_stream(_fp32_params(engine), requests)
    out = _serve_json(capsys, "--checkpoint", str(ckpt), "--n-head", "4",
                      "--requests", requests)
    got = {c["rid"]: c["tokens"] for c in out["completions"]}
    assert got == want
    info = out["checkpoint"]
    assert info["tag"] == f"step{STEPS}"
    assert (info["n_layer"], info["n_embd"], info["vocab_size"]) == \
        (2, 64, 256)
    assert info["topology"]["zero_stage"] == (zero or 0)
    assert out["compile_counts"] == {"prefill": 1, "decode": 1}


def test_ckpt_tag_serves_an_older_checkpoint(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    _train(ckpt, torch.float32)
    requests = _requests_file(tmp_path)
    from deepspeed_tpu_torch.runtime.resilience.checkpoint import (
        CheckpointManager)
    state, _, _ = CheckpointManager().load(str(ckpt), "step1")
    want = _direct_stream({k: torch.from_numpy(np.asarray(v)) for k, v in
                           state["params"].items()}, requests)
    out = _serve_json(capsys, "--checkpoint", str(ckpt), "--ckpt-tag",
                      "step1", "--n-head", "4", "--requests", requests)
    assert out["checkpoint"]["tag"] == "step1"
    assert {c["rid"]: c["tokens"] for c in out["completions"]} == want
    latest = _serve_json(capsys, "--checkpoint", str(ckpt), "--n-head",
                         "4", "--requests", requests)
    assert {c["rid"]: c["tokens"] for c in latest["completions"]} != want


@pytest.mark.parametrize("argv,msg", [
    (["--n-head", "3"], "does not divide"),
    (["--ckpt-tag", "nope"], "--checkpoint"),
])
def test_bad_checkpoint_serves_are_usage_errors(tmp_path, capsys, argv,
                                                msg):
    ckpt = tmp_path / "ckpt"
    _train(ckpt, torch.float32)
    with pytest.raises(SystemExit) as info:
        serve.main(["--device", "cpu", "--synthetic", "2",
                    "--checkpoint", str(ckpt), *argv])
    assert info.value.code == 2
    assert msg in capsys.readouterr().err


def test_checkpoint_serving_is_single_replica(capsys):
    with pytest.raises(SystemExit) as info:
        serve.main(["--device", "cpu", "--synthetic", "2",
                    "--checkpoint", "ckpt", "--replicas", "2"])
    assert info.value.code == 2
    assert "single-replica" in capsys.readouterr().err


def test_config_file_serves_what_the_same_flags_serve(tmp_path, capsys):
    block = {"max_batch": 3, "seq_buckets": [16, 32], "prefill_chunk": 8,
             "kv_cache_dtype": "int8", "attention_impl": "flash",
             "attention_block_k": 8, "kv_layout": "paged",
             "page_size": 8, "sampling_seed": 0}
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps({"inference": block}))
    common = ["--synthetic", "5", "--max-new", "5", "--seed", "2"]
    by_config = _serve_json(capsys, "--config", str(cfg), *common)
    by_flags = _serve_json(
        capsys, *common, "--max-batch", "3", "--seq-buckets", "16,32",
        "--prefill-chunk", "8", "--kv-cache-dtype", "int8", "--attention",
        "flash", "--block-k", "8", "--kv-layout", "paged", "--page-size",
        "8")
    assert by_config["completions"] == by_flags["completions"]
    assert by_config["cache"] == by_flags["cache"]
    assert by_config["cache"]["max_batch"] == 3
    assert by_config["cache"]["kv_layout"] == "paged"


def test_bad_config_file_raises_the_jax_check(tmp_path, capsys):
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps({"inference": {"max_batch": 0}}))
    with pytest.raises(SystemExit) as info:
        serve.main(["--device", "cpu", "--synthetic", "2", "--config",
                    str(cfg)])
    assert info.value.code == 2
    assert "max_batch must be an int >= 1" in capsys.readouterr().err
