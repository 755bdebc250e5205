"""Disaggregated serving with thread tiers on the card: the prefill and
the decode tier each run on a CUDA stream of their own, so every KV
handoff through ``DeviceHandoffStore`` is copied on one stream and
installed on the other. The greedy streams must equal the colocated
engine's, bit for bit. These tests import no JAX and skip without a CUDA
device:

    python -m pytest --noconftest tests/test_torch_cuda_serving.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.disagg import (
    DecodeWorker,
    DeviceHandoffStore,
    PrefillWorker,
)
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.fleet import TierThreadReplica
from deepspeed_tpu_torch.inference.router import DisaggRouter
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler,
    Request,
)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

GEOMETRY = dict(vocab_size=512, n_positions=256, n_embd=256, n_layer=4,
                n_head=4, dtype=torch.float32)
CONFIG = {"max_batch": 4, "seq_buckets": (64, 128), "prefill_chunk": 16,
          "attention_impl": "flash", "kv_layout": "paged"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _requests():
    rng = np.random.default_rng(5)
    return [Request(f"r{i}", rng.integers(0, 512, int(rng.integers(
        8, 100))).tolist(), max_new_tokens=16) for i in range(24)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_thread_tiers_on_the_card_give_the_colocated_stream(
        cuda, kv_cache_dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = GPT2LMHead(GPT2Config(**GEOMETRY), device=cuda,
                        generator=gen).state_dict()

    def build(**knobs):
        return InferenceEngine(
            GPT2LMHead(GPT2Config(**GEOMETRY), device=cuda), params,
            config=dict(CONFIG, kv_cache_dtype=kv_cache_dtype, **knobs),
            device=cuda)

    want = {c.rid: list(c.tokens)
            for c in ContinuousBatchingScheduler(build()).run(_requests())}
    store = DeviceHandoffStore()
    pre = TierThreadReplica(
        0, lambda: PrefillWorker(build(tier="prefill"), store)).start()
    dec = TierThreadReplica(
        1, lambda: DecodeWorker(build(tier="decode"), store)).start()
    result = DisaggRouter([pre], [dec], store).run(_requests(),
                                                   timeout_s=300.0)
    assert result.ok
    assert result.handoffs == len(want)
    assert {c["rid"]: c["tokens"] for c in result.completions} == want
    assert len(store) == 0
