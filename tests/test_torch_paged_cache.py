"""Paged KV pool: the paged half of the port's
`deepspeed_tpu_torch/inference/cache.py` against the JAX package's
`deepspeed_tpu/inference/cache.py` on the same numpy inputs.

Pool writes and gathers must be byte-identical (f32 and the int8 /
fp8 codecs: the same fp32 absmax arithmetic on both sides); attention
outputs agree to atol 1e-6 in f32 (only summation order differs). The
trash page (page 0) is excluded from write comparisons where inactive
rows collide on it: which of several duplicate scatter writes wins is
unspecified on both sides, and nothing ever reads it through a live
mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import cache as jcache
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu_torch.inference import cache as tcache
from deepspeed_tpu_torch.models.gpt2 import GPT2Config

PS, PPR, H, D = 8, 4, 4, 8          # page_size 8, 4 pages a row: S = 32
N_PAGES = 12
CODECS = ["int8", "f8e4m3fn", "f8e5m2"]
_TORCH = {"int8": torch.int8, "f8e4m3fn": torch.float8_e4m3fn,
          "f8e5m2": torch.float8_e5m2, "f32": torch.float32}
_JAX = {"int8": jnp.int8, "f8e4m3fn": jnp.float8_e4m3fn,
        "f8e5m2": jnp.float8_e5m2, "f32": jnp.float32}
TABLE = np.array([[5, 2, 9, 0], [7, 11, 3, 0], [0, 0, 0, 0]], np.int32)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return x.view(torch.uint8).numpy()
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _pools(storage, seed=0):
    """The same random pool on each side (codec pools hold quantized
    random payloads)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_PAGES, PS, H, D)).astype(np.float32)
    y = rng.standard_normal((N_PAGES, PS, H, D)).astype(np.float32)
    if storage == "f32":
        return ({"k": jnp.asarray(x), "v": jnp.asarray(y)},
                {"k": torch.from_numpy(x.copy()),
                 "v": torch.from_numpy(y.copy())})
    kq, ks = jcache._quantize(jnp.asarray(x), storage)
    vq, vs = jcache._quantize(jnp.asarray(y), storage)
    jl = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    tl = {}
    for name, a in jl.items():
        raw = np.asarray(a)
        if name in ("k", "v") and storage != "int8":
            tl[name] = torch.from_numpy(raw.view(np.uint8).copy()).view(
                _TORCH[storage])
        else:
            tl[name] = torch.from_numpy(raw.copy())
    return jl, tl


def _assert_pool_equal(jl, tl, skip_trash=False):
    lo = 1 if skip_trash else 0
    assert sorted(jl) == sorted(tl)
    for name in jl:
        np.testing.assert_array_equal(_bytes(tl[name])[lo:],
                                      _bytes(jl[name])[lo:], err_msg=name)


def _cfgs():
    return (GPT2Config(vocab_size=64, n_positions=64, n_embd=32, n_layer=2,
                       n_head=4, dtype=torch.float32),
            JaxConfig(vocab_size=64, n_positions=64, n_embd=32, n_layer=2,
                      n_head=4, dtype=jnp.float32))


def test_spec_defaults_match_jax():
    tcfg, jcfg = _cfgs()
    for kw in ({"page_size": 8}, {"page_size": 16, "n_pages": 5},
               {"page_size": 0}):
        t = tcache.spec_for_model(tcfg, 2, 32, **kw)
        j = jcache.spec_for_model(jcfg, 2, 32, **kw)
        assert (t.paged, t.page_size, t.n_pages, t.pages_per_row) == \
            (j.paged, j.page_size, j.n_pages, j.pages_per_row)
    assert tcache.spec_for_model(tcfg, 2, 32, page_size=8).n_pages == 9


@pytest.mark.parametrize("kw", [{"page_size": 12},
                                {"page_size": 8, "n_pages": 1}])
def test_spec_errors_match_jax(kw):
    tcfg, jcfg = _cfgs()
    with pytest.raises(ValueError) as jerr:
        jcache.spec_for_model(jcfg, 2, 32, **kw)
    with pytest.raises(ValueError) as terr:
        tcache.spec_for_model(tcfg, 2, 32, **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kv", [None, "bf16", "int8", "f8e5m2"])
def test_pool_shapes_and_dtype_census_match_jax(kv):
    tcfg, jcfg = _cfgs()
    t = tcache.init_kv_cache(
        tcache.spec_for_model(tcfg, 2, 32, kv, page_size=8), "cpu")
    j = jcache.init_kv_cache(jcache.spec_for_model(jcfg, 2, 32, kv,
                                                   page_size=8))
    for name in j:
        for leaf in j[name]:
            assert tuple(t[name][leaf].shape) == j[name][leaf].shape
    assert t["h_0"]["k"].shape == (9, 8, 4, 8)
    assert tcache.cache_dtype_census(t) == jcache.cache_dtype_census(j)
    assert tcache.kv_cache_nbytes(t) == jcache.kv_cache_nbytes(j)


def _chunk(seed, B, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, H, D)).astype(np.float32))


CASES = {
    # decode: one token per row; row 2 is inactive (position 0, trash)
    "decode": (np.array([[3], [17], [0]], np.int32), TABLE, True),
    # prefill: one row, one chunk inside page TABLE[0, 1]
    "prefill": (np.arange(8, 12, dtype=np.int32)[None], TABLE[:1], False),
    # verify: rows straddle a page edge; row 1 runs past its pages
    "verify": (np.array([[6, 7, 8, 9], [22, 23, 24, 25]], np.int32),
               np.array([[5, 2, 9, 0], [7, 11, 3, 0]], np.int32), True),
}


@pytest.mark.parametrize("storage", ["f32"] + CODECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_write_matches_jax_bitwise(storage, case):
    positions, table, trash_hit = CASES[case]
    B, T = positions.shape
    k, v = _chunk(1, B, T)
    jl, tl = _pools(storage)
    jnew = jcache.paged_write_kv(jl, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(positions), jnp.asarray(table))
    tout = tcache.paged_write_kv(tl, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(positions),
                                 torch.from_numpy(table))
    assert tout is tl                      # written in place
    _assert_pool_equal(jnew, tl, skip_trash=trash_hit)
    # every write past the trash page landed where the table says
    pages = table[np.arange(B)[:, None],
                  np.minimum(positions // PS, PPR - 1)]
    if case == "prefill":
        pages = np.broadcast_to(table[0, positions[0, 0] // PS], (1, T))
    live = pages != 0
    got = tl["k"][torch.from_numpy(pages[live]),
                  torch.from_numpy((positions % PS)[live])]
    if storage == "f32":
        np.testing.assert_array_equal(got.numpy(), k[live])


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_single_row_verify_chunk_straddling_a_page(storage):
    """A speculative verify chunk of ONE row (max_batch 1) that crosses a
    page edge lands token by token where the table says: bitwise what
    the JAX package writes for the same row inside a two-row batch (its
    one-row branch would shift the chunk back into the first page)."""
    positions = np.array([[6, 7, 8, 9]], np.int32)
    table = np.array([[5, 2, 9, 0]], np.int32)
    k, v = _chunk(6, 1, 4)
    jl, tl = _pools(storage)
    pad = np.zeros((1, 4), np.int32)          # a second row on the trash
    jnew = jcache.paged_write_kv(
        jl, jnp.asarray(np.concatenate([k, k])),
        jnp.asarray(np.concatenate([v, v])),
        jnp.asarray(np.concatenate([positions, pad])),
        jnp.asarray(np.concatenate([table, np.zeros_like(table)])))
    tcache.paged_write_kv(tl, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(positions),
                          torch.from_numpy(table))
    _assert_pool_equal(jnew, tl, skip_trash=True)
    if storage == "f32":
        got = tl["k"][torch.tensor([5, 5, 2, 2]), torch.tensor([6, 7, 0, 1])]
        np.testing.assert_array_equal(got.numpy(), k[0])


@pytest.mark.parametrize("storage", ["f32"] + CODECS)
def test_paged_read_matches_jax_bitwise(storage):
    jl, tl = _pools(storage, seed=2)
    jk, jv = jcache.paged_read_kv(jl, jnp.asarray(TABLE), jnp.float32)
    tk, tv = tcache.paged_read_kv(tl, torch.from_numpy(TABLE), torch.float32)
    assert tuple(tk.shape) == (3, PPR * PS, H, D)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("T", [1, 4])
def test_cached_attention_paged_matches_jax(impl, T):
    """Write + attend through a page table, f32: outputs agree to
    atol 1e-6 and the pools stay byte-identical."""
    rng = np.random.default_rng(3)
    table = np.array([[5, 2, 9, 4], [7, 11, 3, 1]], np.int32)
    if T == 1:
        positions = np.array([[13], [30]], np.int32)
    else:
        positions = np.array([[14, 15, 16, 17], [4, 5, 6, 7]], np.int32)
    q = rng.standard_normal((2, T, H, D)).astype(np.float32)
    k, v = _chunk(4, 2, T)
    jl, tl = _pools("f32", seed=5)
    jy, jnew = jcache.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jl,
        jnp.asarray(positions), jnp.float32, impl=impl, block_k=4,
        page_table=jnp.asarray(table))
    ty, _ = tcache.cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tl,
        torch.from_numpy(positions), torch.float32, impl=impl, block_k=4,
        page_table=torch.from_numpy(table))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                               rtol=0)
    _assert_pool_equal(jnew, tl)


def test_attention_mask_reads_the_sequence_length_off_the_table():
    tl = _pools("f32")[1]
    pos = torch.tensor([[3], [31]])
    mask = tcache.attention_mask(tl, pos, torch.from_numpy(TABLE[:2]))
    want = jcache.attention_mask(_pools("f32")[0], jnp.asarray(pos.numpy()),
                                 jnp.asarray(TABLE[:2]))
    assert tuple(mask.shape) == (2, 1, PPR * PS)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
