"""Paged serving end to end: the port's paged InferenceEngine +
ContinuousBatchingScheduler against the JAX package's, and the paging
behaviours of the JAX package's `tests/unit/test_paged_parity.py` on
the port.

Model: ``gpt2_tiny`` in f32, initialised in JAX and carried across
with ``convert_gpt2_params``. Config: max_batch 2, seq buckets (16,
32), prefill chunk 4, so the auto page size is 8 and a row's table is
4 pages wide; flash decode (the paged kernel's plain version on the
CPU, Pallas interpret mode on the JAX side) with block_k 8.

Tolerances: greedy streams in f32 must be token-identical;
teacher-forced logits agree to atol 2e-6 (f32) and 1e-4 (int8: both
sides quantize the same k/v), as in `test_torch_serving.py`. Every
test ends on the 2-program pin: allocator churn, prefix hits and
park/resume never change a program's input signature.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler,
    Request as JaxRequest,
)
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu_torch.inference import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)

CONFIG = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
          "attention_impl": "flash", "attention_block_k": 8,
          "kv_layout": "paged"}
TWO = {"prefill": 1, "decode": 1}


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


@pytest.fixture(scope="module")
def state(jax_params):
    return convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, jax_params[1]))


def _engine(state, **overrides):
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    return InferenceEngine(model, state, config=dict(CONFIG, **overrides),
                           device="cpu")


def _shared_stream(cls, seed=0, n=5, max_new=5):
    """A 12-token shared system prompt plus 2-6 tokens each, one arrival
    per decode step."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, 12).tolist()
    return [cls(f"r{i}", base + rng.integers(0, 256, 2 + i).tolist(),
                max_new_tokens=max_new, arrival_step=i) for i in range(n)]


def _serve(sched, requests):
    for r in requests:
        sched.submit(r)
    sched.run()
    return {c.rid: c for c in sched.completions}


def test_greedy_stream_token_identical_to_jax(jax_params, state):
    model, params = jax_params
    jeng = JaxEngine(model, params, config=CONFIG)
    jsched = JaxScheduler(jeng)
    jout = _serve(jsched, _shared_stream(JaxRequest))
    teng = _engine(state)
    tsched = ContinuousBatchingScheduler(teng)
    tout = _serve(tsched, _shared_stream(Request))
    assert sorted(tout) == sorted(jout)
    for rid, want in jout.items():
        got = tout[rid]
        assert got.tokens == want.tokens, rid
        assert (got.finish_reason, got.slot, got.steps, got.prefix_hit,
                got.prefill_chunks, got.prefill_chunks_skipped) == \
            (want.finish_reason, want.slot, want.steps, want.prefix_hit,
             want.prefill_chunks, want.prefill_chunks_skipped), rid
    assert any(c.prefix_hit for c in tout.values())
    assert tsched.paging.facts() == jsched.paging.facts()
    assert jeng.compile_counts() == TWO and teng.compile_counts() == TWO
    jfacts = {k: v for k, v in jeng.cache_facts().items() if k != "stacked"}
    assert teng.cache_facts() == jfacts


def _teacher_forced(engine, prompts, forced, tables):
    first = [np.asarray(engine.prefill(i, p, page_table=tables[i]))
             for i, p in enumerate(prompts)]
    pos = np.asarray([len(p) for p in prompts], np.int32)
    steps = []
    for toks in forced:
        _, logits = engine.decode(toks, pos, page_tables=tables)
        steps.append(np.asarray(logits))
        pos = pos + 1
    return np.stack(first), np.stack(steps)


@pytest.mark.parametrize("kv,atol", [(None, 2e-6), ("int8", 1e-4)])
def test_teacher_forced_logits_match_jax(jax_params, state, kv, atol):
    """Shuffled, non-monotonic page tables; prompts end mid-page and
    the forced steps cross a page edge."""
    model, params = jax_params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (7, 13)]
    forced = rng.integers(0, 256, (6, 2)).astype(np.int32)
    tables = np.array([[6, 2, 8, 3], [5, 1, 7, 4]], np.int32)
    jeng = JaxEngine(model, params, config=dict(CONFIG, kv_cache_dtype=kv))
    teng = _engine(state, kv_cache_dtype=kv)
    jfirst, jsteps = _teacher_forced(jeng, prompts, forced, tables)
    tfirst, tsteps = _teacher_forced(teng, prompts, forced, tables)
    np.testing.assert_allclose(tfirst, jfirst, atol=atol, rtol=0)
    np.testing.assert_allclose(tsteps, jsteps, atol=atol, rtol=0)
    assert teng.cache_facts()["dtype_census"] == \
        jeng.cache_facts()["dtype_census"]
    assert teng.cache_facts()["bytes"] == jeng.cache_facts()["bytes"]
    assert teng.compile_counts() == TWO


def test_prefix_hit_matches_cold_prefill(state):
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, 12).tolist()
    tail_a = rng.integers(0, 256, 2).tolist()
    tail_b = rng.integers(0, 256, 3).tolist()
    warm_eng = _engine(state)
    warm = ContinuousBatchingScheduler(warm_eng)
    done = _serve(warm, [Request("a", base + tail_a, max_new_tokens=4)])
    assert not done["a"].prefix_hit
    hit = _serve(warm, [Request("b", base + tail_b, max_new_tokens=4)])["b"]
    assert hit.prefix_hit and hit.prefill_chunks_skipped == 2
    cold = ContinuousBatchingScheduler(_engine(state))
    ref = _serve(cold, [Request("b", base + tail_b, max_new_tokens=4)])["b"]
    assert not ref.prefix_hit
    assert hit.tokens == ref.tokens
    assert warm_eng.compile_counts() == TWO


def test_cow_divergence_leaves_shared_pages_intact(state):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, 12).tolist()
    tail_a = rng.integers(0, 256, 2).tolist()
    tail_b = rng.integers(0, 256, 2).tolist()
    eng = _engine(state)
    sched = ContinuousBatchingScheduler(eng)
    first = _serve(sched, [Request("a0", base + tail_a,
                                   max_new_tokens=4)])["a0"]
    shared = sched.paging.radix.match(base + tail_a)
    before = [eng.cache["h_0"]["k"][p].clone() for p in shared]
    _serve(sched, [Request("b", base + tail_b, max_new_tokens=4)])
    again = _serve(sched, [Request("a1", base + tail_a,
                                   max_new_tokens=4)])["a1"]
    assert again.prefix_hit and again.tokens == first.tokens
    assert shared and all(torch.equal(eng.cache["h_0"]["k"][p], b)
                          for p, b in zip(shared, before))
    assert eng.compile_counts() == TWO


def test_prefix_cache_off_never_hits(state):
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, 12).tolist()
    sched = ContinuousBatchingScheduler(_engine(state, prefix_cache=False))
    done = _serve(sched, [Request("a", base + [1], max_new_tokens=3)])
    done2 = _serve(sched, [Request("b", base + [2], max_new_tokens=3)])
    assert not done["a"].prefix_hit and not done2["b"].prefix_hit
    assert sched.paging.facts()["prefix_hits"] == 0
    assert sched.paging.radix is None


@pytest.mark.parametrize("kv", [None, "int8"])
def test_host_parked_session_resumes_bit_exact(state, kv):
    """Park threshold 0.9 sends the finished session's pages to host
    RAM at once (int8 payloads and f32 scales as raw bytes); the
    follow-up pages them back in and must continue exactly like a cold
    engine prefilling the whole history."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, 10).tolist()
    eng = _engine(state, host_park_threshold=0.9, kv_cache_dtype=kv)
    sched = ContinuousBatchingScheduler(eng)
    c0 = _serve(sched, [Request("r0", prompt, max_new_tokens=3,
                                session_id="s0")])["r0"]
    facts = sched.paging.facts()
    assert facts["sessions_parked_host"] == 1 and facts["pages_evacuated"] > 0
    follow = prompt + c0.tokens
    c1 = _serve(sched, [Request("r1", follow, max_new_tokens=3,
                                session_id="s0")])["r1"]
    assert c1.resumed and c1.prefill_chunks_skipped > 0
    facts = sched.paging.facts()
    assert facts["pages_paged_in"] > 0 and facts["sessions_resumed"] == 1
    cold = ContinuousBatchingScheduler(_engine(state, kv_cache_dtype=kv))
    ref = _serve(cold, [Request("r1", follow, max_new_tokens=3)])["r1"]
    assert c1.tokens == ref.tokens
    assert eng.compile_counts() == TWO


def test_gather_scatter_round_trip_is_bytewise_for_bf16(state):
    """numpy has no bf16: host snapshots carry bf16 pool leaves as
    int16 views, copied (a later pool write must not reach them)."""
    eng = _engine(state, kv_cache_dtype="bf16")
    leaf = eng.cache["h_1"]["v"]
    leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                           .manual_seed(0)).to(leaf.dtype))
    want = leaf[[3, 5]].clone()
    snap = eng.gather_pages([3, 5])
    assert snap["h_1"]["v"].dtype == np.int16
    leaf[3] = 0                             # the snapshot is a copy
    eng.scatter_pages([6, 7], snap)
    assert torch.equal(leaf[[6, 7]], want)


def test_ring_and_paged_greedy_streams_agree(state):
    streams = {}
    for layout in ("ring", "paged"):
        eng = _engine(state, kv_layout=layout)
        done = _serve(ContinuousBatchingScheduler(eng),
                      _shared_stream(Request, seed=6))
        streams[layout] = {rid: c.tokens for rid, c in done.items()}
        assert eng.compile_counts() == TWO
    assert streams["ring"] == streams["paged"]


def test_paged_config_validation_matches_jax(jax_params, state):
    model, params = jax_params
    for bad in ({"page_size": 6}, {"page_size": 12},
                {"attention_block_k": 12, "page_size": 16},
                {"host_park_threshold": 1.0},
                {"host_park_threshold": -0.1}, {"kv_layout": "tiles"},
                {"n_pages": 1}):
        with pytest.raises(ValueError) as jerr:
            JaxEngine(model, params, config=dict(CONFIG, **bad))
        with pytest.raises(ValueError) as terr:
            _engine(state, **bad)
        assert str(terr.value) == str(jerr.value), bad
    eng = _engine(state)
    assert (eng.page_size, eng.n_pages, eng.pages_per_row,
            eng.attention_block_k) == (8, 9, 4, 8)
