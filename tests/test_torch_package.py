"""Package rules of the PyTorch port.

The import guard is an AST scan, not a ``sys.modules`` check: a test
process has JAX loaded already (the parity tests import both packages),
so only the source says what the port itself imports.
"""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")


def _sources():
    root = os.path.join(REPO, "deepspeed_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = list(_sources())
    assert len(sources) > 20
    bad = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p)) &
                                            set(FORBIDDEN))
           for p in sources}
    assert {p: r for p, r in bad.items() if r} == {}


def test_engine_without_gpu_raises_instead_of_falling_back(monkeypatch):
    from deepspeed_tpu_torch import resolve_device
    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(model, device=device)
    for config in ({"kv_layout": "paged"},
                   {"speculative": {"enabled": True, "k": 2}},
                   {"kv_layout": "paged",
                    "speculative": {"enabled": True, "k": 2}}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(model, config=config)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        resolve_device("meta")


def test_flash_decode_on_a_non_cpu_device_never_runs_the_plain_version():
    """The wrapper takes its plain version only for CPU tensors."""
    from deepspeed_tpu_torch.ops.flash_decode import flash_decode
    q = torch.zeros(1, 1, 1, 8, device="meta")
    kv = torch.zeros(1, 8, 1, 8, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    before = flash_decode.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_decode(q, kv, kv, pos, block_k=8)
    assert flash_decode.launches == before


def test_flash_decode_paged_on_a_non_cpu_device_never_runs_the_plain_version(
        monkeypatch):
    """K6's wrapper takes its plain version only for CPU tensors."""
    import importlib
    fd = importlib.import_module("deepspeed_tpu_torch.ops.flash_decode")
    called = []
    monkeypatch.setattr(fd, "flash_decode_paged_reference",
                        lambda *a, **k: called.append(1))
    q = torch.zeros(2, 1, 1, 8, device="meta")
    pool = torch.zeros(5, 8, 1, 8, device="meta")
    pos = torch.zeros(2, dtype=torch.int32, device="meta")
    table = torch.zeros(2, 4, dtype=torch.int32, device="meta")
    before = fd.flash_decode_paged.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        fd.flash_decode_paged(q, pool, pool, pos, table, block_k=8)
    assert called == [] and fd.flash_decode_paged.launches == before


def test_kernel_sources_ship_with_the_package():
    from deepspeed_tpu_torch.ops import _build
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert os.path.join(REPO, ".torch_ext") == str(_build.BUILD_DIR)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".torch_ext/" in f.read().split()


# a kernel's wrapper sits where the JAX module it ports sits
WRAPPER_DIRS = {"block_sparse_attention": "ops/sparse_attention"}


def test_scan_covers_the_training_slice_and_every_kernel_wrapper():
    """The import guard reads every module of the package, the training
    runtime, the paged and speculative serving modules, the BERT /
    sparse-attention slice and each kernel's wrapper (``ops/<name>.py``
    beside ``ops/csrc/<name>.cu``, or under the JAX module's own
    directory) among them."""
    from deepspeed_tpu_torch.ops import _build
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    wrappers = {f"deepspeed_tpu_torch/{WRAPPER_DIRS.get(name, 'ops')}/"
                f"{name}.py" for name in _build.KERNELS}
    training = {f"deepspeed_tpu_torch/{m}.py" for m in (
        "__init__", "runtime/engine", "runtime/config", "runtime/constants",
        "runtime/lr_schedules", "runtime/utils", "runtime/fp16/loss_scaler",
        "ops/adam/fused_adam", "models/gpt2")}
    serving = {f"deepspeed_tpu_torch/{m}.py" for m in (
        "inference/cache", "inference/engine", "inference/scheduler",
        "inference/serve", "inference/paging", "inference/speculative",
        "runtime/resilience/fault_injection",
        "runtime/resilience/checksums")}
    bert = {f"deepspeed_tpu_torch/{m}.py" for m in (
        "models/bert", "ops/transformer/transformer",
        "ops/sparse_attention/sparsity_config",
        "ops/sparse_attention/sparse_self_attention",
        "ops/sparse_attention/bert_sparse_self_attention")}
    assert len(wrappers) == 4
    assert wrappers | training | serving | bert <= scanned


@pytest.mark.parametrize("module", [
    "inference/router.py", "inference/fleet.py", "inference/fleet_worker.py",
    "inference/disagg.py", "runtime/supervisor/state.py",
    "runtime/supervisor/supervisor.py", "telemetry/watchdog.py",
    "runtime/resilience/preemption.py", "telemetry/__init__.py",
    "telemetry/registry.py", "telemetry/events.py", "telemetry/exporters.py",
    "telemetry/spans.py", "telemetry/session.py", "telemetry/timers.py",
    "telemetry/profiler.py", "telemetry/compile_cache.py",
    "telemetry/flight.py", "telemetry/cli.py"])
def test_the_scan_covers_the_serving_fleet_modules(module):
    path = os.path.join(REPO, "deepspeed_tpu_torch", module)
    assert path in set(_sources())
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("module", [
    "parallel/sequence.py", "parallel/pipe_sp.py",
    "parallel/pipe_tp_moe.py", "moe/__init__.py", "moe/layer.py",
    "moe/expert_pipe.py", "models/gpt2_moe.py"])
def test_the_scan_covers_the_sequence_and_expert_modules(module):
    path = os.path.join(REPO, "deepspeed_tpu_torch", module)
    assert path in set(_sources())
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_fleet_worker_without_a_device_needs_the_card(tmp_path):
    """A worker whose spec names no device runs on the card, and with
    no card it fails (exit 1, "no CUDA device") instead of serving on
    the CPU."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               DS_TPU_SERVE_SPEC=json.dumps({"inf_cfg": {}, "seed": 0}),
               DS_TPU_RUN_WORKDIR=str(tmp_path),
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.inference.fleet_worker"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120, input="")
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""        # nothing reached the wire
