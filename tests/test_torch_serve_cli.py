"""The port's serve CLI (``python -m deepspeed_tpu_torch.inference.serve``)
in subprocesses, on the CPU."""

import json
import os
import subprocess
import sys

import pytest
from tests.torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--synthetic", "4", "--max-new", "4",
        "--attention", "flash", "--block-k", "8"]


def _serve(*args):
    return subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.serve", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_flash_serve_meets_the_two_program_contract():
    proc = _serve(*BASE, "--expect-compiles", "2", "--json")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["ok"] is True
    assert out["compile_counts"] == {"prefill": 1, "decode": 1}
    assert len(out["completions"]) == 4
    assert out["attention"] == {"impl": "flash", "block_k": 8}
    assert out["device"] == "cpu"


def test_violated_compile_count_exits_1():
    proc = _serve(*BASE, "--expect-compiles", "3")
    assert proc.returncode == 1
    assert "compile count 2 != expected 3" in proc.stderr


def test_int8_sampled_serve_writes_telemetry(tmp_path):
    log = tmp_path / "serve.jsonl"
    proc = _serve(*BASE, "--kv-cache-dtype", "int8", "--temperature", "0.8",
                  "--top-k", "16", "--top-p", "0.9", "--seed", "3",
                  "--expect-compiles", "2", "--jsonl", str(log))
    assert proc.returncode == 0, proc.stderr
    assert "4/4 requests completed" in proc.stdout
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert any(e["event"] == "decode_step" for e in events)


def test_paged_route_hits_the_prefix_cache():
    proc = _serve(*BASE, "--arrival-every", "1", "--kv-layout", "paged",
                  "--shared-prefix", "12", "--expect-prefix-hits", "1",
                  "--expect-compiles", "2")
    assert proc.returncode == 0, proc.stderr
    assert "4/4 requests completed" in proc.stdout
    assert "paged KV:" in proc.stdout and "prefix hit" in proc.stdout


def test_speculative_route_runs_three_programs():
    proc = _serve(*BASE, "--speculative", "--spec-k", "3", "--draft-layers",
                  "1", "--expect-compiles", "3", "--json")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out["compile_counts"] == {"prefill": 1, "decode": 0, "draft": 1,
                                     "verify": 1}
    assert out["speculative"]["k"] == 3
    assert out["speculative"]["mean_accepted"] >= 1.0


@pytest.mark.parametrize("route,message", [
    (["--expect-prefix-hits", "1"], "requires --kv-layout paged"),
    (["--expect-min-accepted", "1.0"], "requires --speculative"),
    (["--speculative", "--spec-k", "0"], "--spec-k must be >= 1")])
def test_gates_without_their_route_exit_2(route, message, capsys):
    from deepspeed_tpu_torch.inference.serve import main
    with pytest.raises(SystemExit) as info:
        main(BASE + route)
    assert info.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("route", [["--replicas", "2"], ["--disaggregate"],
                                   ["--scan-layers"],
                                   ["--checkpoint", "ckpt"],
                                   ["--config", "ds.json"]])
def test_unported_routes_exit_2(route, capsys):
    # --scan-layers is the one route still refused; the others are
    # ported and reach their own checks (here each one's usage error:
    # a kill index outside the fleet, a ring layout under
    # disaggregation, a missing checkpoint or config file)
    from deepspeed_tpu_torch.inference.serve import main
    extra = {"--replicas": ["--kill-replica", "2"]}.get(route[0], [])
    if route[0] == "--scan-layers":
        # ported: the stacked model serves (tests/test_torch_gpt2_scan.py
        # holds its streams to the unrolled model's)
        assert main(BASE + route) == 0
        assert "not yet ported" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as info:
        main(BASE + route + extra)
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" not in err
    assert {"--replicas": "--kill-replica 2 outside 0..1",
            "--disaggregate": "requires --kv-layout paged",
            "--checkpoint": "no valid checkpoint under ckpt",
            "--config": "--config ds.json"}[route[0]] in err


def test_default_device_without_gpu_exits_2():
    """No ``--device``: the CLI runs on CUDA or refuses (no silent CPU
    fallback). Without a GPU that is a usage error."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch\n"
         "torch.cuda.is_available = lambda: False\n"
         "from deepspeed_tpu_torch.inference.serve import main\n"
         "sys.exit(main(['--synthetic', '2']))"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr
