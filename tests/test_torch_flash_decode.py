"""Flash decode: the port (`deepspeed_tpu_torch/ops/flash_decode.py`)
against the JAX kernel (`deepspeed_tpu/ops/pallas/flash_decode.py`).

On the CPU the JAX kernel runs in Pallas interpret mode (as its own
tests run it) and the port's wrapper runs its plain PyTorch version,
which is what the CUDA kernel is held to on the card. Inputs come from
``numpy.random.default_rng``; quantized caches feed the SAME payload
bytes and scales to both sides.

Tolerance: atol 1e-5 on outputs of magnitude ~1 — both sides accumulate
in fp32 with the same block walk; only the order of the in-block sums
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.cache import _quantize as jax_quantize
from deepspeed_tpu.ops.pallas.flash_decode import (
    flash_decode as jax_flash_decode)
from deepspeed_tpu_torch.ops.flash_decode import (
    KernelGeometryError,
    flash_decode,
)

B, S, H = 3, 32, 4
POSITIONS = np.array([5, 0, S - 1], np.int32)
ATOL = 1e-5

_TORCH_DTYPES = {"int8": torch.int8, "f8e4m3fn": torch.float8_e4m3fn,
                 "f8e5m2": torch.float8_e5m2}


def _inputs(seed, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v


def _to_torch(x, dtype=None):
    """A JAX/numpy array as a torch tensor with the same bytes (fp8
    goes through a uint8 view: numpy has no native fp8)."""
    a = np.asarray(x)
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("D", [8, 64])
@pytest.mark.parametrize("block_k", [8, 16, 32])
def test_f32_matches_jax(D, block_k):
    q, k, v = _inputs(0, D)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(POSITIONS), block_k=block_k)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(POSITIONS),
                       block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("codec", ["int8", "f8e4m3fn", "f8e5m2"])
def test_quantized_matches_jax_on_shared_buffers(codec):
    q, k, v = _inputs(1, 16)
    kq, ks = jax_quantize(jnp.asarray(k), codec)
    vq, vs = jax_quantize(jnp.asarray(v), codec)
    want = jax_flash_decode(jnp.asarray(q), kq, vq, jnp.asarray(POSITIONS),
                            k_scale=ks, v_scale=vs, block_k=8)
    dt = _TORCH_DTYPES[codec]
    got = flash_decode(torch.from_numpy(q), _to_torch(kq, dt),
                       _to_torch(vq, dt), torch.from_numpy(POSITIONS),
                       k_scale=_to_torch(ks), v_scale=_to_torch(vs),
                       block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bf16_query_output_dtype_matches_jax():
    """A bf16 query returns bf16 (cast after the fp32 normalize), as
    the JAX kernel does; values agree to one bf16 rounding."""
    q, k, v = _inputs(2, 16)
    want = jax_flash_decode(jnp.asarray(q, jnp.bfloat16),
                            jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16),
                            jnp.asarray(POSITIONS), block_k=8)
    got = flash_decode(torch.from_numpy(q).bfloat16(),
                       torch.from_numpy(k).bfloat16(),
                       torch.from_numpy(v).bfloat16(),
                       torch.from_numpy(POSITIONS), block_k=8)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want32,
                               atol=1e-5, rtol=2.0 ** -7)


def test_poisoned_tail_changes_nothing():
    """Slots past a row's position (a recycled ring row's previous
    tenant) must not move the output by a single bit."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 16))
    pos = torch.tensor([5, 0, 8], dtype=torch.int32)
    clean = flash_decode(q, k, v, pos, block_k=8)
    dead = torch.arange(S)[None, :] > pos[:, None]
    k2, v2 = k.clone(), v.clone()
    k2[dead] = 1e4
    v2[dead] = -1e4
    poisoned = flash_decode(q, k2, v2, pos, block_k=8)
    assert torch.equal(poisoned, clean)


def test_negative_position_attends_to_nothing():
    """A row at position -1 runs no KV block: zeros, as in JAX."""
    q, k, v = _inputs(4, 8)
    pos = np.array([-1, 3, 7], np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos), block_k=8)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(pos),
                       block_k=8)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return info


@pytest.mark.parametrize("block_k", [0, -4, 12])
def test_geometry_errors_match_jax(block_k):
    q, k, v = _inputs(5, 8)
    jax_err = _message(lambda: jax_flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(POSITIONS), block_k=block_k))
    port_err = _message(lambda: flash_decode(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(POSITIONS), block_k=block_k))
    assert port_err.type is KernelGeometryError
    assert str(port_err.value) == str(jax_err.value)


def test_shape_and_scale_errors_match_jax():
    q, k, v = _inputs(6, 8)
    bad_q = q[:, :, :2]
    for args, kw in (((bad_q, k, v, POSITIONS), {}),
                     ((q, k, v, POSITIONS), {"k_scale": np.ones((B, S, H),
                                                                np.float32)})):
        jax_err = _message(lambda: jax_flash_decode(
            *(jnp.asarray(a) for a in args),
            **{n: jnp.asarray(a) for n, a in kw.items()}, block_k=8))
        port_err = _message(lambda: flash_decode(
            *(torch.from_numpy(a) for a in args),
            **{n: torch.from_numpy(a) for n, a in kw.items()}, block_k=8))
        # torch.Size prints like a tuple once converted; same text
        assert str(port_err.value) == str(jax_err.value)


def test_block_k_clamps_to_cache_length():
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 8))
    pos = torch.from_numpy(POSITIONS)
    np.testing.assert_array_equal(
        flash_decode(q, k, v, pos, block_k=4 * S).numpy(),
        flash_decode(q, k, v, pos, block_k=S).numpy())
