"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX (the GPU machine need not have it) and
skip without a CUDA device; ``--noconftest`` keeps the JAX test
harness in ``tests/conftest.py`` out of the run:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q

``chip_smoke.py`` runs the full-width matrix; these are the small,
fast cases. Tolerance atol 1e-5 on f32 outputs of magnitude ~1: both
sides accumulate in fp32, in a different order.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.cache import _quantize
from deepspeed_tpu_torch.ops.flash_decode import (
    flash_decode,
    flash_decode_reference,
)

B, S, H, D = 3, 32, 4, 64
POSITIONS = np.array([5, 0, S - 1], np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "int8", "f8e4m3fn", "f8e5m2"])
def test_flash_decode_kernel_matches_plain_version(cuda, codec):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for shape in ((B, 1, H, D), (B, S, H, D),
                                            (B, S, H, D)))
    pos = torch.from_numpy(POSITIONS).to(cuda)
    if codec is None:
        args, scales = (k, v), ()
    else:
        (kq, ks), (vq, vs) = _quantize(k, codec), _quantize(v, codec)
        args, scales = (kq, vq), (ks, vs)
    before = flash_decode.launches
    got = flash_decode(q, *args, pos, *scales, block_k=8)
    assert flash_decode.launches == before + 1
    want = flash_decode_reference(q, *args, pos, *scales, block_k=8)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
