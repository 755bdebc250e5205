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


def test_kernel_sources_ship_with_the_package():
    from deepspeed_tpu_torch.ops import _build
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert os.path.join(REPO, ".torch_ext") == str(_build.BUILD_DIR)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".torch_ext/" in f.read().split()


def test_scan_covers_the_training_slice_and_every_kernel_wrapper():
    """The import guard reads every module of the package, the training
    runtime and each kernel's wrapper (``ops/<name>.py`` beside
    ``ops/csrc/<name>.cu``) among them."""
    from deepspeed_tpu_torch.ops import _build
    scanned = {os.path.relpath(p, REPO) for p in _sources()}
    wrappers = {f"deepspeed_tpu_torch/ops/{name}.py"
                for name in _build.KERNELS}
    training = {f"deepspeed_tpu_torch/{m}.py" for m in (
        "__init__", "runtime/engine", "runtime/config", "runtime/constants",
        "runtime/lr_schedules", "runtime/utils", "runtime/fp16/loss_scaler",
        "ops/adam/fused_adam", "models/gpt2")}
    assert len(wrappers) == 3
    assert wrappers | training <= scanned
