"""Ring KV cache: the port (`deepspeed_tpu_torch/inference/cache.py`)
against the JAX package (`deepspeed_tpu/inference/cache.py`) on the
same numpy inputs.

Tolerances: quantized payloads must be byte-identical and scales equal
to rtol 1e-6 (the same fp32 absmax arithmetic); attention outputs agree
to atol 2e-6 in f32 (only summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import cache as jcache
from deepspeed_tpu_torch.inference import cache as tcache

B, S, H, D = 2, 16, 4, 8
CODECS = ["int8", "f8e4m3fn", "f8e5m2"]
_TORCH = {"int8": torch.int8, "f8e4m3fn": torch.float8_e4m3fn,
          "f8e5m2": torch.float8_e5m2, "f32": torch.float32}
_JAX = {"int8": jnp.int8, "f8e4m3fn": jnp.float8_e4m3fn,
        "f8e5m2": jnp.float8_e5m2, "f32": jnp.float32}


def _bytes(x):
    """Raw bytes of a JAX array or torch tensor (fp8 has no numpy
    dtype on the torch side)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return x.view(torch.uint8).numpy()
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _layers(storage):
    """An empty layer cache on each side."""
    quant = storage in CODECS
    jl = {"k": jnp.zeros((B, S, H, D), _JAX[storage]),
          "v": jnp.zeros((B, S, H, D), _JAX[storage])}
    tl = {"k": torch.zeros((B, S, H, D), dtype=_TORCH[storage]),
          "v": torch.zeros((B, S, H, D), dtype=_TORCH[storage])}
    if quant:
        for name in ("k_scale", "v_scale"):
            jl[name] = jnp.zeros((B, S, H), jnp.float32)
            tl[name] = torch.zeros((B, S, H), dtype=torch.float32)
    return jl, tl


def _assert_layer_equal(jl, tl):
    assert sorted(jl) == sorted(tl)
    for name in jl:
        if name.endswith("_scale"):
            np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(_bytes(tl[name]), _bytes(jl[name]))


def _chunk(rng, T):
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("codec", CODECS)
def test_quantize_matches_jax(codec):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 5, H, D)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                              # zero-vector guard
    jq, js = jcache._quantize(jnp.asarray(x), codec)
    tq, ts = tcache._quantize(torch.from_numpy(x), codec)
    assert tq.dtype == _TORCH[codec]
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    np.testing.assert_allclose(
        _f32(tcache._dequantize(tq, ts, torch.float32)),
        _f32(jcache._dequantize(jq, js, jnp.float32)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("storage", ["f32"] + CODECS)
def test_write_and_read_kv_match_jax(storage):
    rng = np.random.default_rng(1)
    jl, tl = _layers(storage)
    # a 4-token prefill chunk per row at different starts, then a decode
    # write, then a chunk that would overrun the buffer (start clamps)
    for T, starts in ((4, (0, 5)), (1, (4, 9)), (4, (14, 2))):
        _, k, v = _chunk(rng, T)
        pos = np.asarray(starts, np.int32)[:, None] + np.arange(T)[None]
        jl = jcache.write_kv(jl, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos, jnp.int32))
        out = tcache.write_kv(tl, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos.astype(np.int32)))
        assert out is tl                          # updated in place
        _assert_layer_equal(jl, tl)
    jk, jv = jcache.read_kv(jl, jnp.float32)
    tk, tv = tcache.read_kv(tl, torch.float32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)


@pytest.mark.parametrize("storage", ["f32", "int8", "f8e4m3fn"])
@pytest.mark.parametrize("impl,T", [("dense", 4), ("dense", 1),
                                    ("flash", 1)])
def test_cached_attention_matches_jax(storage, impl, T):
    rng = np.random.default_rng(2)
    jl, tl = _layers(storage)
    # history: rows filled to different depths
    _, k, v = _chunk(rng, 8)
    pos = np.stack([np.arange(8), np.arange(3, 11)]).astype(np.int32)
    jl = jcache.write_kv(jl, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tcache.write_kv(tl, torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(pos))
    q, k, v = _chunk(rng, T)
    pos = np.asarray([8, 11], np.int32)[:, None] + np.arange(T)[None]
    pos = pos.astype(np.int32)
    jy, jl = jcache.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl, jnp.asarray(pos),
        jnp.float32, impl=impl, block_k=8)
    ty, tl = tcache.cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tl,
        torch.from_numpy(pos), torch.float32, impl=impl, block_k=8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-6, rtol=0)
    _assert_layer_equal(jl, tl)


def test_attention_mask_matches_jax():
    jl, tl = _layers("f32")
    pos = np.asarray([[3, 4], [0, 1]], np.int32)
    np.testing.assert_array_equal(
        tcache.attention_mask(tl, torch.from_numpy(pos)).numpy(),
        np.asarray(jcache.attention_mask(jl, jnp.asarray(pos))))


@pytest.mark.parametrize("kv", [None, "bf16", "f32", "int8", "f8e5m2"])
def test_spec_census_and_bytes_match_jax(kv):
    from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
    from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny
    jspec = jcache.spec_for_model(jax_tiny(), 2, 32, kv)
    tspec = tcache.spec_for_model(gpt2_tiny(), 2, 32, kv)
    jc = jcache.init_kv_cache(jspec)
    tc = tcache.init_kv_cache(tspec, "cpu")
    assert sorted(tc) == sorted(jc)
    assert tcache.cache_dtype_census(tc) == jcache.cache_dtype_census(jc)
    assert tcache.kv_cache_nbytes(tc) == jcache.kv_cache_nbytes(jc)


def test_spec_rejects_what_jax_rejects():
    from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tcache.spec_for_model(gpt2_tiny(), 2, 32, "int4")
    with pytest.raises(ValueError, match="n_positions"):
        tcache.spec_for_model(gpt2_tiny(), 2, 128)


def test_slice_rows_writes_through_to_the_cache():
    _, tl = _layers("int8")
    cache = {"h_0": tl}
    row = tcache.slice_rows(cache, 1)
    rng = np.random.default_rng(3)
    _, k, v = (torch.from_numpy(a[:1]) for a in _chunk(rng, 2))
    tcache.write_kv(row["h_0"], k, v, torch.tensor([[3, 4]], dtype=torch.int32))
    assert tcache.update_rows(cache, row, 1) is cache
    assert cache["h_0"]["k"][1, 3:5].any() and not cache["h_0"]["k"][0].any()
    detached = {"h_0": {n: t.clone() for n, t in row["h_0"].items()}}
    detached["h_0"]["k_scale"].fill_(2.0)
    tcache.update_rows(cache, detached, 1)
    assert bool((cache["h_0"]["k_scale"][1] == 2.0).all())
