"""The data-parallel engine on the card: an NCCL group of one process,
ZeRO stages 0 and 3 on a small GPT-2 (flash attention, bf16), and the
rule that a CUDA engine never runs its collectives over gloo. These
tests need a GPU and skip without one; they import no JAX, so they run
on a GPU machine with:

    python -m pytest --noconftest tests/test_torch_zero_cuda.py -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from deepspeed_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def group(cuda, tmp_path):
    """A one-process group on a file store; ``backend(name)`` starts
    it."""
    def start(backend):
        import torch.distributed as dist
        dist.init_process_group(backend, init_method=f"file://{tmp_path}/s",
                                world_size=1, rank=0)
    yield start
    mesh.destroy_distributed()


def _engine(stage, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = GPT2LMHead(gpt2_tiny(dtype=torch.bfloat16, n_embd=256,
                                 n_head=4, n_layer=4, n_positions=256,
                                 use_flash_attention=True),
                       device=device, generator=gen)
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "bf16": {"enabled": True}, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    if stage:
        cfg["zero_optimization"] = {"stage": stage}
    engine, _, _, _ = initialize(model=model, config=cfg, device=device)
    return engine


def test_nccl_world_one_stage3_equals_stage0(cuda, group):
    os.environ.pop("DS_TPU_NUM_PROCESSES", None)
    group("nccl")
    from deepspeed_tpu_torch.ops import flash_attention as fa
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 256, (4, 128)).astype(
        np.int32)} for _ in range(3)]
    runs = {}
    for stage in (0, 3):
        fa.flash_attention_fwd.launches = 0
        engine = _engine(stage, cuda)
        assert engine.comm.active and engine.comm.world == 1
        losses = []
        for b in batches:
            engine.comm.reset()
            losses.append(float(engine.train_batch(b)))
        counts = engine.comm.snapshot()
        p = sum(4 * m.numel() for m in engine._masters)
        if stage == 0:
            assert counts["all_reduce"]["bytes"] == p
            assert counts["all_gather"]["bytes"] == 0
        else:
            assert counts["reduce_scatter"]["bytes"] == 2 * p
            assert counts["all_gather"]["bytes"] == 2 * 2 * (p // 2)
        assert fa.flash_attention_fwd.launches == 3 * 2 * 4
        runs[stage] = (losses, [m.detach().cpu() for m in engine._masters])
        del engine
    assert runs[3][0] == runs[0][0]
    for a, b in zip(runs[3][1], runs[0][1]):
        assert torch.equal(a, b)


def test_cuda_engine_refuses_a_gloo_group(cuda, group):
    group("gloo")
    with pytest.raises(RuntimeError, match="needs 'nccl'"):
        _engine(1, cuda)
