"""Paged flash decode: the port
(`deepspeed_tpu_torch/ops/flash_decode.py:flash_decode_paged`) against
the JAX kernel (`deepspeed_tpu/ops/pallas/flash_decode.py:
flash_decode_paged`).

On the CPU the JAX kernel runs in Pallas interpret mode (as its own
tests run it) and the port's wrapper runs its plain PyTorch version,
which is what the CUDA kernel is held to on the card. Inputs come from
``numpy.random.default_rng``; page tables hold shuffled, non-monotonic
physical ids; positions sit on page edges. Quantized pools feed the
SAME payload bytes and scales to both sides.

Tolerance: atol 1e-5 on f32 outputs of magnitude ~1 (both sides
accumulate in fp32 with the same block walk; only the order of the
in-block sums differs), and one bf16 rounding (rtol 2^-7) for a bf16
query.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.cache import _quantize as jax_quantize
from deepspeed_tpu.ops.pallas.flash_decode import (
    flash_decode_paged as jax_paged)
from deepspeed_tpu_torch.ops.flash_decode import (
    KernelGeometryError,
    flash_decode,
    flash_decode_paged,
)

B, H, PS, PPR = 4, 4, 16, 4         # page_size 16, 4 pages a row: S = 64
S = PS * PPR
N_PAGES = 1 + B * PPR + 3           # the trash page and 3 spare pages
POSITIONS = np.array([0, PS - 1, PS, S - 1], np.int32)
ATOL = 1e-5

_TORCH_DTYPES = {"int8": torch.int8, "f8e4m3fn": torch.float8_e4m3fn,
                 "f8e5m2": torch.float8_e5m2}


def _inputs(seed, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((N_PAGES, PS, H, D)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PS, H, D)).astype(np.float32)
    ids = rng.permutation(np.arange(1, N_PAGES))[:B * PPR]
    table = ids.reshape(B, PPR).astype(np.int32)
    return q, k, v, table


def _to_torch(x, dtype=None):
    """A JAX/numpy array as a torch tensor with the same bytes (fp8
    goes through a uint8 view: numpy has no native fp8)."""
    a = np.asarray(x)
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("D", [8, 64])
@pytest.mark.parametrize("block_k", [4, 8, PS])
def test_f32_matches_jax(D, block_k):
    q, k, v, table = _inputs(0, D)
    assert not (np.diff(table.reshape(-1)) > 0).all()   # non-monotonic
    want = jax_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(POSITIONS), jnp.asarray(table),
                     block_k=block_k)
    got = flash_decode_paged(*_t(q, k, v, POSITIONS, table),
                             block_k=block_k)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("codec", ["int8", "f8e4m3fn", "f8e5m2"])
def test_quantized_matches_jax_on_shared_buffers(codec):
    q, k, v, table = _inputs(1, 16)
    kq, ks = jax_quantize(jnp.asarray(k), codec)
    vq, vs = jax_quantize(jnp.asarray(v), codec)
    want = jax_paged(jnp.asarray(q), kq, vq, jnp.asarray(POSITIONS),
                     jnp.asarray(table), k_scale=ks, v_scale=vs, block_k=8)
    dt = _TORCH_DTYPES[codec]
    got = flash_decode_paged(
        torch.from_numpy(q), _to_torch(kq, dt), _to_torch(vq, dt),
        torch.from_numpy(POSITIONS), torch.from_numpy(table),
        k_scale=_to_torch(ks), v_scale=_to_torch(vs), block_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_bf16_query_output_dtype_matches_jax():
    q, k, v, table = _inputs(2, 16)
    want = jax_paged(jnp.asarray(q, jnp.bfloat16),
                     jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), jnp.asarray(POSITIONS),
                     jnp.asarray(table), block_k=8)
    qt, kt, vt, pt, tt = _t(q, k, v, POSITIONS, table)
    got = flash_decode_paged(qt.bfloat16(), kt.bfloat16(), vt.bfloat16(),
                             pt, tt, block_k=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL, rtol=2.0 ** -7)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_poisoned_trash_page_and_table_tail_change_nothing(codec):
    """Entries past a row's occupancy may hold anything, out-of-range
    ids included, and the trash page may hold huge garbage: the output
    must not move by a single bit."""
    q, k, v, table = (torch.from_numpy(a) for a in _inputs(3, 16))
    scales = ()
    if codec is not None:
        from deepspeed_tpu_torch.inference.cache import _quantize
        (k, ks), (v, vs) = _quantize(k, codec), _quantize(v, codec)
        scales = (ks, vs)
    pos = torch.tensor([3, PS - 1, PS + 2, S - 1], dtype=torch.int32)
    clean = flash_decode_paged(q, k, v, pos, table, *scales, block_k=8)
    k2, v2, poisoned_table = k.clone(), v.clone(), table.clone()
    k2[0] = 100 if codec else 1e4
    v2[0] = -100 if codec else -1e4
    scales2 = tuple(x.clone() for x in scales)
    for x in scales2:
        x[0] = 1e4
    used = (pos // PS).long()
    for b in range(B):
        poisoned_table[b, used[b] + 1:] = [10 ** 9, -7, 0, N_PAGES][
            b % 4]
    got = flash_decode_paged(q, k2, v2, pos, poisoned_table, *scales2,
                             block_k=8)
    assert torch.equal(got, clean)


def test_in_order_table_equals_the_ring_kernel():
    """Row b mapped to its pages in order over the same bytes as a
    ring row: the paged and ring plain versions walk the same blocks."""
    q, _, _, _ = _inputs(4, 16)
    rng = np.random.default_rng(4)
    ring_k = rng.standard_normal((B, S, H, 16)).astype(np.float32)
    ring_v = rng.standard_normal((B, S, H, 16)).astype(np.float32)
    pool_k = np.concatenate([np.zeros((1, PS, H, 16), np.float32),
                             ring_k.reshape(B * PPR, PS, H, 16)])
    pool_v = np.concatenate([np.zeros((1, PS, H, 16), np.float32),
                             ring_v.reshape(B * PPR, PS, H, 16)])
    table = (1 + np.arange(B * PPR, dtype=np.int32)).reshape(B, PPR)
    paged = flash_decode_paged(*_t(q, pool_k, pool_v, POSITIONS, table),
                               block_k=8)
    ring = flash_decode(*_t(q, ring_k, ring_v, POSITIONS), block_k=8)
    assert torch.equal(paged, ring)


def test_negative_position_attends_to_nothing():
    q, k, v, table = _inputs(5, 8)
    pos = np.array([-1, 3, 7, 40], np.int32)
    want = jax_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(pos), jnp.asarray(table), block_k=8)
    got = flash_decode_paged(*_t(q, k, v, pos, table), block_k=8)
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return info


@pytest.mark.parametrize("block_k", [0, -4, 12])
def test_geometry_errors_match_jax(block_k):
    q, k, v, table = _inputs(6, 8)
    jax_err = _message(lambda: jax_paged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(POSITIONS), jnp.asarray(table), block_k=block_k))
    port_err = _message(lambda: flash_decode_paged(
        *_t(q, k, v, POSITIONS, table), block_k=block_k))
    assert port_err.type is KernelGeometryError
    assert str(port_err.value) == str(jax_err.value)
    if block_k == 12:
        assert "page_size" in str(port_err.value)


def test_shape_table_and_scale_errors_match_jax():
    q, k, v, table = _inputs(7, 8)
    scale = np.ones((N_PAGES, PS, H), np.float32)
    for args, kw in (((q[:, :, :2], k, v, POSITIONS, table), {}),
                     ((q, k, v, POSITIONS, table[:3]), {}),
                     ((q, k, v, POSITIONS, table), {"k_scale": scale})):
        jax_err = _message(lambda: jax_paged(
            *(jnp.asarray(a) for a in args),
            **{n: jnp.asarray(a) for n, a in kw.items()}, block_k=8))
        port_err = _message(lambda: flash_decode_paged(
            *_t(*args), **{n: torch.from_numpy(a) for n, a in kw.items()},
            block_k=8))
        assert str(port_err.value) == str(jax_err.value)


def test_block_k_clamps_to_page_size():
    q, k, v, table = _t(*_inputs(8, 8))
    pos = torch.from_numpy(POSITIONS)
    assert torch.equal(flash_decode_paged(q, k, v, pos, table, block_k=4 * S),
                       flash_decode_paged(q, k, v, pos, table, block_k=PS))
