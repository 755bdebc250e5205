"""The port's serve CLI (``python -m deepspeed_tpu_torch.inference.serve``)
in subprocesses, on the CPU."""

import json
import os
import subprocess
import sys

import pytest

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


@pytest.mark.parametrize("route", [["--replicas", "2"], ["--disaggregate"],
                                   ["--kv-layout", "paged"],
                                   ["--speculative"], ["--scan-layers"],
                                   ["--checkpoint", "ckpt"],
                                   ["--config", "ds.json"]])
def test_unported_routes_exit_2(route, capsys):
    from deepspeed_tpu_torch.inference.serve import main
    with pytest.raises(SystemExit) as info:
        main(BASE + route)
    assert info.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


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
