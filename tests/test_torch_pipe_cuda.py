"""The pipeline on the card: GPT-2 125M in f32 (flash attention, K1-K3
on the FMA route) as two stages on ``cuda:0``, where the 1F1B executor's
loss sums and every raw stage gradient must equal the sequential oracle
on the same stage modules bit for bit (``chip_smoke.py``'s
``train_pipe`` gate at this size), and a step keeps the tied copies
equal. Needs a GPU and skips without one; it imports no JAX, so it runs
on a GPU machine with:

    python -m pytest --noconftest tests/test_torch_pipe_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.models.gpt2 import gpt2_125m
from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module

pytestmark = pytest.mark.cuda

T, ROWS, MICRO = 1024, 8, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_125m_f32_two_stages_equal_the_sequential_oracle(cuda):
    cfg = gpt2_125m(n_positions=T, dropout=0.0, dtype=torch.float32,
                    use_flash_attention=True)
    engine, _, _, _ = initialize(
        model=gpt2_pipeline_module(cfg, seq_len=T),
        config={"train_batch_size": ROWS,
                "gradient_accumulation_steps": MICRO,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                "mesh": {"pipe": 2}, "steps_per_print": 10 ** 9})
    rng = np.random.default_rng(0)
    batch = {"input_ids": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (ROWS, T)).astype(np.int64))}
    got = engine.sequential_check(batch)
    (en, ed, eg), (on, od, og) = got["executor"], got["oracle"]
    assert torch.equal(en, on) and torch.equal(ed, od)
    assert all(torch.equal(a, b) for a, b in zip(eg, og))
    loss = float(engine.train_batch(batch))
    assert np.isfinite(loss)
    first = dict(engine.parts.stages[0].tied.named_parameters())
    last = dict(engine.parts.stages[1].tied.named_parameters())
    assert all(torch.equal(first[n], last[n]) for n in first)
