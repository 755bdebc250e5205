"""The model axis's collectives (``parallel/collectives.py``) in gloo
worlds of 2 and 4 processes, held to the dense computation JAX's
``tests/unit/test_collective_matmul.py`` holds its library to, computed
here by JAX on the same inputs: forward values and gradients of
``matmul_psum_overlap``, ``matmul_reduce_scatter``,
``all_gather_matmul_overlap`` (both the contraction shard's and the
replicated weight's), ``all_to_all_overlap``, ``ring_psum``,
``ring_all_gather`` and ``psum_grad``'s backward, at chunks 1, 2 and 4,
each way round the ring. Tolerances are the JAX test's: rtol 1e-5, atol
1e-6 (chunking reassociates an fp32 sum). ``chunks=1`` of
``matmul_psum_overlap`` equals ``psum_combine(a @ b)`` bit for bit, and
every data movement (all-to-all, all-gather, the ring gather) is exact.

The quantized wire's bound is derived here, not copied (the JAX test's
own ``test_ring_psum_wire_error_bounded`` fails at the seed): a remote
contribution x is encoded in chunks of 16 with the scale s = absmax /
qmax of its chunk. int8 rounds x / s to the nearest integer, so its
decode errs by at most s / 2 per element; f8e4m3fn keeps 3 mantissa
bits, so it errs by at most 2^-4 |x| on the normal range and by half
its smallest subnormal, 2^-10 s, below it. Each product and quotient
in f32 adds at most one rounding of the value, and the fp32 sum of n
terms one rounding a term: the bound per element is the sum over the
n-1 remote contributions of those codec errors, plus 4 n 2^-24 times
the sum of the magnitudes. The rank's own contribution enters exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu_torch.parallel.collectives import _chunk_slices
from tests import torch_zero_harness as H
from tests.torch_tp_worker import B, K, M_EVEN, M_ODD, T, rand

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
GRID = [(1, False), (2, False), (2, True), (4, False), (4, True)]
WIRE_GRID = [(1, False), (2, True), (4, True)]
CODECS = ["int8", "f8e4m3fn"]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    root = tmp_path_factory.mktemp("collectives")
    case = {"name": "c", "kind": "collectives", "grid": GRID,
            "wire_grid": WIRE_GRID, "codecs": CODECS}
    for world in (2, 4):
        H.spawn_world(world, [case], root / "none.npz", root / f"w{world}",
                      worker=WORKER)
        out[world] = H.load_results(root / f"w{world}", "c", world)
    return out


def dense(a, b, w):
    """JAX's dense oracle: loss, d/da, d/db of sum((a @ b) * w)."""
    a, b, w = jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)
    y = a @ b
    return (np.asarray(jnp.sum(y * w)),
            np.asarray(jnp.einsum("btm,km->btk", w, b)),
            np.asarray(jnp.einsum("btk,btm->km", a, w)))


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("m", [M_ODD, M_EVEN])
@pytest.mark.parametrize("chunks,bidir", GRID)
def test_matmul_psum_overlap_matches_dense(worlds, world, m, chunks, bidir):
    loss, ga, gb = dense(rand(0, (B, T, K)), rand(1, (K, m)),
                         rand(2, (B, T, m)))
    kl = K // world
    for r, (res, _) in enumerate(worlds[world]):
        key = f"mpo/{m}/{chunks}/{int(bidir)}"
        close(res[key + "/loss"], loss)
        close(res[key + "/ga"], ga[..., r * kl:(r + 1) * kl])
        close(res[key + "/gb"], gb[r * kl:(r + 1) * kl])


@pytest.mark.parametrize("world", [2, 4])
def test_matmul_psum_overlap_chunks1_bitexact(worlds, world):
    for res, _ in worlds[world]:
        for m in (M_ODD, M_EVEN):
            assert np.array_equal(res[f"mpo1/{m}"], res[f"mono/{m}"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks,bidir", GRID)
def test_matmul_reduce_scatter_matches_psum_scatter(worlds, world, chunks,
                                                    bidir):
    loss, ga, gb = dense(rand(0, (B, T, K)), rand(1, (K, M_EVEN)),
                         rand(2, (B, T, M_EVEN)))
    kl = K // world
    total = 0.0
    for r, (res, _) in enumerate(worlds[world]):
        key = f"mrs/{chunks}/{int(bidir)}"
        total += float(res[key + "/loss"])
        close(res[key + "/ga"], ga[..., r * kl:(r + 1) * kl])
        close(res[key + "/gb"], gb[r * kl:(r + 1) * kl])
    np.testing.assert_allclose(total, loss, rtol=RTOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks,bidir", GRID)
def test_all_gather_matmul_matches_dense(worlds, world, chunks, bidir):
    loss, gx, gw = dense(rand(0, (B, T, K)), rand(1, (K, M_EVEN)),
                         rand(2, (B, T, M_EVEN)))
    kl = K // world
    for r, (res, _) in enumerate(worlds[world]):
        key = f"agm/{chunks}/{int(bidir)}"
        close(res[key + "/loss"], loss)
        close(res[key + "/gx"], gx[..., r * kl:(r + 1) * kl])
        close(res[key + "/gw"], gw)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_all_to_all_overlap_matches_lax(worlds, world, chunks):
    """Tiled all-to-all (split the last dim, concatenate along T), as
    ``lax.all_to_all(..., tiled=True)`` lays it out: exact, and its
    gradient is the transposed exchange."""
    xs = [rand(10 + r, (B, T, 2 * world)) for r in range(world)]
    wt = rand(11, (B, world * T, 2))
    for r, (res, _) in enumerate(worlds[world]):
        want = np.concatenate([x[..., 2 * r:2 * r + 2] for x in xs], 1)
        assert np.array_equal(res[f"a2a/{chunks}/y"], want)
        gx = np.zeros_like(xs[r])
        for d in range(world):
            gx[..., 2 * d:2 * d + 2] = wt[:, r * T:(r + 1) * T]
        assert np.array_equal(res[f"a2a/{chunks}/gx"], gx)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks,bidir", GRID)
def test_ring_psum_and_all_gather_match_lax(worlds, world, chunks, bidir):
    xs = rand(20, (world, T, M_ODD))
    want = np.asarray(jnp.sum(jnp.asarray(xs), axis=0))
    for res, _ in worlds[world]:
        close(res[f"ring/{chunks}/{int(bidir)}"], want)
        assert np.array_equal(res[f"rag/{chunks}/{int(bidir)}"],
                              xs.reshape(world * T, M_ODD))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("chunks", [1, 4])
def test_psum_grad_backward_matches_psum(worlds, world, chunks):
    """The replicated input's gradient is the sum of every rank's
    column-parallel part: dense ``c @ w.T``."""
    wf = rand(31, (K, M_EVEN))
    c = rand(32, (B, T, M_EVEN // world))
    ml = M_EVEN // world
    want = sum(np.asarray(jnp.einsum("btm,km->btk", jnp.asarray(c),
                                     jnp.asarray(wf[:, r * ml:(r + 1) * ml])))
               for r in range(world))
    for res, _ in worlds[world]:
        close(res[f"pg/{chunks}/gh"], want)


def _chunk_bound(x, codec, chunk=16):
    """Per-element bound of one remote contribution's decode error (the
    module docstring's derivation)."""
    flat = x.reshape(-1)
    pad = (-flat.size) % chunk
    blocks = np.pad(np.abs(flat), (0, pad)).reshape(-1, chunk)
    qmax = {"int8": 127.0, "f8e4m3fn": 448.0}[codec]
    s = np.repeat(blocks.max(1) / qmax, chunk)[:flat.size]
    if codec == "int8":
        err = 0.5 * s
    else:
        err = 2.0 ** -4 * np.abs(flat) + 2.0 ** -10 * s
    return (err + 2 * 2.0 ** -24 * np.abs(flat)).reshape(x.shape)


def _sum_bound(parts, codec, own):
    n = len(parts)
    remote = sum(_chunk_bound(p, codec) for i, p in enumerate(parts)
                 if i != own)
    return remote + 4 * n * 2.0 ** -24 * sum(np.abs(p) for p in parts)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("chunks,bidir", WIRE_GRID)
def test_ring_psum_wire_error_bounded(worlds, world, codec, chunks, bidir):
    """The ring's stripes are encoded whole, so a stripe's chunks of 16
    are the stripe's, not the tensor's: the bound takes each stripe."""
    xs = rand(20, (world, T, M_ODD))
    want = xs.sum(0)
    slices = [(0, M_ODD)] if chunks <= 1 else _chunk_slices(M_ODD, chunks)
    for r, (res, _) in enumerate(worlds[world]):
        got = res[f"wire/{codec}/{chunks}/{int(bidir)}/ring"]
        for st, sz in slices:
            parts = [x[..., st:st + sz] for x in xs]
            bound = _sum_bound(parts, codec, r)
            err = np.abs(got[..., st:st + sz] - want[..., st:st + sz])
            assert (err <= bound).all(), (codec, chunks, float(
                (err - bound).max()))
        # a bound that a lost contribution would break: it is tight
        assert np.abs(got - want).max() > 0 or codec == "int8"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("chunks,bidir", WIRE_GRID)
def test_matmul_psum_overlap_wire_error_bounded(worlds, world, codec,
                                                chunks, bidir):
    """The partial products are the contributions; the backward moves no
    wire, so the gradients keep the dense tolerance."""
    a, b = rand(0, (B, T, K)), rand(1, (K, M_ODD))
    w = rand(2, (B, T, M_ODD))
    kl = K // world
    parts = [a[..., r * kl:(r + 1) * kl] @ b[r * kl:(r + 1) * kl]
             for r in range(world)]
    _, ga, gb = dense(a, b, w)
    slices = [(0, M_ODD)] if chunks <= 1 else _chunk_slices(M_ODD, chunks)
    for r, (res, _) in enumerate(worlds[world]):
        key = f"wire/{codec}/{chunks}/{int(bidir)}"
        bound = np.concatenate([_sum_bound(
            [p[..., st:st + sz] for p in parts], codec, r)
            for st, sz in slices], -1)
        loss_bound = float((bound * np.abs(w)).sum()) + 1e-5
        exact = float((sum(parts) * w).sum())
        assert abs(float(res[key + "/mpo"]) - exact) <= loss_bound
        close(res[key + "/ga"], ga[..., r * kl:(r + 1) * kl])
        close(res[key + "/gb"], gb[r * kl:(r + 1) * kl])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("codec", CODECS)
def test_ring_all_gather_wire_places_own_shard_exactly(worlds, world,
                                                       codec):
    xs = rand(20, (world, T, M_ODD))
    for chunks, bidir in WIRE_GRID:
        for r, (res, _) in enumerate(worlds[world]):
            got = res[f"wire/{codec}/{chunks}/{int(bidir)}/rag"] \
                .reshape(world, T, M_ODD)
            assert np.array_equal(got[r], xs[r])
            # each stripe of rows travels encoded on its own
            slices = [(0, T)] if chunks <= 1 else _chunk_slices(T, chunks)
            for i in range(world):
                for st, sz in slices:
                    rows = xs[i][st:st + sz]
                    assert (np.abs(got[i][st:st + sz] - rows) <=
                            _chunk_bound(rows, codec)).all()


@pytest.mark.parametrize("world", [2, 4])
def test_site_log_and_counts(worlds, world):
    for _, meta in worlds[world]:
        assert meta["sites"] == [
            ["matmul_psum_overlap", "model", "ppermute", 4, world - 1],
            ["ring_psum", "model", "ppermute", 2, world - 1]]
        assert meta["counts"]["ppermute"]["calls"] == 6 * (world - 1)


def test_overlap_plan_resolves_sites():
    from deepspeed_tpu_torch.parallel.collectives import (
        OverlapPlan, SitePlan, overlap_plan, overlap_scope)
    plan = OverlapPlan(chunks=4, bidirectional=True, sites={
        "row_parallel": {"chunks": 2},
        "column_parallel": {"enabled": False},
        "ulysses": {"wire_dtype": "int8", "wire_chunk": 64}})
    assert overlap_plan("row_parallel") is None
    with overlap_scope(plan):
        assert overlap_plan("row_parallel") == SitePlan(2, True)
        assert overlap_plan("column_parallel") is None
        assert overlap_plan("expert_combine") == SitePlan(4, True)
        assert overlap_plan("ulysses") == SitePlan(4, True, "int8", 64)
        with overlap_scope(None):
            assert overlap_plan("expert_combine") is None
    assert overlap_plan("expert_combine") is None


def test_chunk_slices_cover_and_spread():
    assert _chunk_slices(10, 4) == [(0, 3), (3, 3), (6, 2), (8, 2)]
    for size, chunks in ((10, 4), (7, 3), (1, 5), (16, 16)):
        slices = _chunk_slices(size, chunks)
        assert sum(s for _, s in slices) == size
        assert [st for st, _ in slices] == list(np.cumsum(
            [0] + [s for _, s in slices])[:-1])
