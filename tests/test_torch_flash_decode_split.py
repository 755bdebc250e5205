"""The split of the decode kernels (K5 ring and K6 paged in
``deepspeed_tpu_torch/ops/csrc/flash_decode.cu``), modelled on the CPU,
against the reference.

The kernels split each row's live keys into chunks of
``DECODE_CHUNK`` (128) keys of key index, one CTA a chunk. A CTA reads
only the keys ``s <= min(positions[b], S - 1)`` of its chunk (a paged
CTA stages the (page, slot) of exactly those keys, so only the table
entries that cover them are read), forms the chunk's fp32 softmax
partial (m, l, acc), and the row's last CTA merges the partials in
chunk order 0, 1, ..., n - 1. :func:`_chunked_decode` does the same
arithmetic in PyTorch; these tests hold it to the port's plain versions
(``flash_decode_reference``, ``flash_decode_paged_reference``) and to
the JAX ``flash_decode_paged`` (Pallas interpret mode), over f32 and
quantized (int8, fp8) storage, at positions on chunk edges, rows whose
live keys lie in chunk 0 only, a negative position and one past S, and
a poisoned table tail. The paged walk over an in-order table equals the
ring walk bit for bit, as the kernels do.

Tolerance: atol 1e-5 on outputs of magnitude ~1 (fp32 sums in another
order than the plain versions' block walk). Inputs come from
``numpy.random.default_rng``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.cache import _quantize as jax_quantize
from deepspeed_tpu.ops.pallas.flash_decode import (
    flash_decode_paged as jax_paged)
from deepspeed_tpu_torch.ops.flash_decode import (
    DECODE_CHUNK,
    flash_decode_paged_reference,
    flash_decode_reference,
)

fd = importlib.import_module("deepspeed_tpu_torch.ops.flash_decode")

B, H, PS, PPR = 8, 2, 64, 8         # page_size 64, 8 pages a row: S = 512
S = PS * PPR
N_PAGES = 1 + B * PPR + 3           # the trash page and 3 spare pages
# chunk edges (last / first key of a chunk), rows live in chunk 0 only
# (60, 127), a negative position (zeros) and one past S
POSITIONS = np.array([127, 128, 255, 256, 511, 60, -1, 700], np.int32)
ATOL = 1e-5

_TORCH_DTYPES = {"int8": torch.int8, "f8e4m3fn": torch.float8_e4m3fn,
                 "f8e5m2": torch.float8_e5m2}


def _chunked_decode(q, k, v, positions, k_scale=None, v_scale=None,
                    table=None):
    """The kernels' split: per row, per live chunk of DECODE_CHUNK keys,
    the fp32 partial (m, l, acc) with score = (q . k) * k_scale * D^-0.5
    and the value scale on the probabilities after l takes them; the
    partials merged in chunk order; out = acc / max(l, 1e-30) in q's
    dtype. ``table`` None: ``k``/``v`` are a ring [B, S, H, D]; else a
    pool [n_pages, page_size, H, D] addressed through ``table``."""
    b_rows, _, h, d = q.shape
    s_len = k.shape[1] if table is None else table.shape[1] * k.shape[1]
    out = torch.zeros((b_rows, 1, h, d), dtype=torch.float32)
    for b in range(b_rows):
        pos = int(positions[b])
        if pos < 0:
            continue                    # attends to nothing: zeros
        last = min(pos, s_len - 1)
        parts = []
        for c0 in range(0, last + 1, DECODE_CHUNK):
            keys = torch.arange(c0, min(last, c0 + DECODE_CHUNK - 1) + 1)
            if table is None:
                lead, slot = torch.full_like(keys, b), keys
            else:                       # only entries covering live keys
                lead = table[b, keys // k.shape[1]].long()
                slot = keys % k.shape[1]
            x = torch.einsum("hd,nhd->hn", q[b, 0].float(),
                             k[lead, slot].float())
            if k_scale is not None:
                x = x * k_scale[lead, slot].T
            x = x * d ** -0.5
            m = x.amax(-1)
            e = torch.exp(x - m[:, None])
            l = e.sum(-1)
            if v_scale is not None:
                e = e * v_scale[lead, slot].T
            parts.append((m, l, torch.einsum("hn,nhd->hd", e,
                                             v[lead, slot].float())))
        m_all = parts[0][0]
        for m, _, _ in parts[1:]:
            m_all = torch.maximum(m_all, m)
        l_all = torch.zeros(h)
        acc = torch.zeros(h, d)
        for m, l, a in parts:           # chunk order 0, 1, ..., n - 1
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            acc = acc + a * w[:, None]
        out[b, 0] = acc / torch.clamp(l_all, min=1e-30)[:, None]
    return out.to(q.dtype)


def _inputs(seed, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, d)).astype(np.float32)
    k = rng.standard_normal((N_PAGES, PS, H, d)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PS, H, d)).astype(np.float32)
    ids = rng.permutation(np.arange(1, N_PAGES))[:B * PPR]
    return q, k, v, ids.reshape(B, PPR).astype(np.int32)


def _to_torch(x, dtype=None):
    """A JAX/numpy array as a torch tensor with the same bytes (fp8
    goes through a uint8 view: numpy has no native fp8)."""
    a = np.asarray(x)
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return torch.from_numpy(a.view(np.uint8).copy()).view(dtype)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("d", [16, 64])
def test_f32_split_matches_the_plain_version_and_jax(d):
    q, k, v, table = _inputs(0, d)
    got = _chunked_decode(*(torch.from_numpy(x) for x in (q, k, v)),
                          torch.from_numpy(POSITIONS),
                          table=torch.from_numpy(table))
    plain = flash_decode_paged_reference(
        *(torch.from_numpy(x) for x in (q, k, v, POSITIONS, table)),
        block_k=PS)
    want = jax_paged(*(jnp.asarray(x) for x in (q, k, v, POSITIONS, table)),
                     block_k=PS)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert not got[6].any()                     # negative position
    s_max = _chunked_decode(*(torch.from_numpy(x) for x in (q, k, v)),
                            torch.full((B,), S - 1, dtype=torch.int32),
                            table=torch.from_numpy(table))
    assert torch.equal(got[7], s_max[7])        # past S: every key


@pytest.mark.parametrize("codec", ["int8", "f8e4m3fn", "f8e5m2"])
def test_quantized_split_matches_the_plain_version(codec):
    """Shared quantized buffers (the JAX codec's bytes and scales) into
    the model, the port's plain version and, for int8, the JAX kernel."""
    q, k, v, table = _inputs(1, 16)
    kq, ks = jax_quantize(jnp.asarray(k), codec)
    vq, vs = jax_quantize(jnp.asarray(v), codec)
    dt = _TORCH_DTYPES[codec]
    args = (torch.from_numpy(q), _to_torch(kq, dt), _to_torch(vq, dt),
            torch.from_numpy(POSITIONS))
    scales = dict(k_scale=_to_torch(ks), v_scale=_to_torch(vs))
    got = _chunked_decode(*args, table=torch.from_numpy(table), **scales)
    plain = flash_decode_paged_reference(*args, torch.from_numpy(table),
                                         block_k=PS, **scales)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    if codec == "int8":
        want = jax_paged(jnp.asarray(q), kq, vq, jnp.asarray(POSITIONS),
                         jnp.asarray(table), k_scale=ks, v_scale=vs,
                         block_k=PS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_ring_split_matches_the_ring_plain_version():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, 32)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, H, 32)).astype(
        np.float32)) for _ in range(2))
    pos = torch.from_numpy(POSITIONS)
    np.testing.assert_allclose(
        _chunked_decode(q, k, v, pos).numpy(),
        flash_decode_reference(q, k, v, pos, block_k=128).numpy(),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("codec", [None, "int8"])
def test_poisoned_table_tail_and_trash_page_change_nothing(codec):
    """Table entries past a row's occupancy hold out-of-range ids (an
    index error if the split read one) and the trash page holds huge
    values: the output does not move by a single bit."""
    q, k, v, table = (torch.from_numpy(a) for a in _inputs(3, 16))
    scales = {}
    if codec is not None:
        from deepspeed_tpu_torch.inference.cache import _quantize
        (k, ks), (v, vs) = _quantize(k, codec), _quantize(v, codec)
        scales = dict(k_scale=ks, v_scale=vs)
    pos = torch.from_numpy(POSITIONS)
    clean = _chunked_decode(q, k, v, pos, table=table, **scales)
    k2, v2, bad = k.clone(), v.clone(), table.clone()
    k2[0] = 100 if codec else 1e4
    v2[0] = -100 if codec else -1e4
    scales2 = {n: x.clone() for n, x in scales.items()}
    for x in scales2.values():
        x[0] = 1e4
    used = pos.long().clamp(max=S - 1) // PS
    for b in range(B):
        bad[b, int(used[b]) + 1:] = 10 ** 9
    assert torch.equal(_chunked_decode(q, k2, v2, pos, table=bad,
                                       **scales2), clean)


def test_in_order_table_equals_the_ring_split_bitwise():
    """Row b on its pages in order over the same bytes as ring row b: the
    paged split gathers the same values as the ring split, chunk for
    chunk, so the two agree bit for bit (the kernels' K6 == K5)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, 16)).astype(
        np.float32))
    ring_k, ring_v = (torch.from_numpy(rng.standard_normal(
        (B, S, H, 16)).astype(np.float32)) for _ in range(2))
    table = torch.arange(B * PPR, dtype=torch.int32).reshape(B, PPR)
    pos = torch.from_numpy(POSITIONS)
    paged = _chunked_decode(q, ring_k.reshape(B * PPR, PS, H, 16),
                            ring_v.reshape(B * PPR, PS, H, 16), pos,
                            table=table)
    assert torch.equal(paged, _chunked_decode(q, ring_k, ring_v, pos))


def test_scratch_is_one_ticket_buffer_per_stream_that_grows():
    """The wrapper's scratch: an f32 workspace of B*H x ceil(S / 128) x
    (D + 2) partials a launch, and one zeroed int32 ticket buffer per
    (device, stream), reused while it is long enough."""
    q = torch.zeros(1)
    key = (q.device.index, -1)
    try:
        ws, tickets = fd._scratch(q, 6, 300, 64, -1)
        assert ws.numel() == 6 * 3 * 66 and ws.dtype == torch.float32
        assert tickets.numel() == 6 and not tickets.any()
        assert fd._scratch(q, 4, 128, 8, -1)[1] is tickets
        grown = fd._scratch(q, 10, 128, 8, -1)[1]
        assert grown.numel() == 10 and grown is fd._tickets[key]
    finally:
        fd._tickets.pop(key, None)
