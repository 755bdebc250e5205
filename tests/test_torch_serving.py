"""Serving slice end to end: the port's InferenceEngine +
ContinuousBatchingScheduler against the JAX package's on one request
stream, from the same params (initialised in JAX, carried across with
``convert_gpt2_params``).

Config: max_batch 2, seq buckets (16, 32), prefill chunk 4, flash
decode with block_k 8; prompts span both buckets and arrive one per
decode step. Greedy streams from f32 storage must be token-identical.
With int8 storage the teacher-forced logits are compared instead of
free generation (one near-tie argmax flip would fork the streams):
both sides quantize the same k/v, so they agree to atol 1e-4.
"""

import signal

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
          "attention_impl": "flash", "attention_block_k": 8}
PROMPT_LENS = (3, 9, 14, 20, 6, 11)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _port_engine(params, **overrides):
    state = convert_gpt2_params(jax.tree_util.tree_map(np.asarray, params))
    model = GPT2LMHead(gpt2_tiny(dtype=torch.float32), device="cpu")
    return InferenceEngine(model, state, config=dict(CONFIG, **overrides),
                           device="cpu")


def _stream(cls, seed=0, max_new=6):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", rng.integers(0, 256, n).tolist(),
                max_new_tokens=max_new, arrival_step=i)
            for i, n in enumerate(PROMPT_LENS)]


def _by_rid(completions):
    return {c.rid: c for c in completions}


def test_greedy_stream_token_identical_to_jax(jax_params):
    model, params = jax_params
    jeng = JaxEngine(model, params, config=CONFIG)
    jout = _by_rid(JaxScheduler(jeng).run(_stream(JaxRequest)))
    teng = _port_engine(params)
    sched = ContinuousBatchingScheduler(teng)
    tout = _by_rid(sched.run(_stream(Request)))
    assert sorted(tout) == sorted(jout)
    assert {c.bucket for c in tout.values()} == {16, 32}
    for rid, want in jout.items():
        got = tout[rid]
        assert got.tokens == want.tokens, rid
        assert (got.finish_reason, got.bucket, got.slot, got.steps) == \
            (want.finish_reason, want.bucket, want.slot, want.steps), rid
    assert jeng.compile_counts() == {"prefill": 1, "decode": 1}
    assert teng.compile_counts() == {"prefill": 1, "decode": 1}


def _teacher_forced(engine, prompts, forced):
    """Prefill each prompt into its row, then feed ``forced`` tokens
    [steps, rows]; returns (prefill last logits, decode logits)."""
    first = [np.asarray(engine.prefill(i, p)) for i, p in enumerate(prompts)]
    pos = np.asarray([len(p) for p in prompts], np.int32)
    steps = []
    for toks in forced:
        _, logits = engine.decode(toks, pos)
        steps.append(np.asarray(logits))
        pos = pos + 1
    return np.stack(first), np.stack(steps)


@pytest.mark.parametrize("kv,atol", [(None, 2e-6), ("int8", 1e-4)])
def test_teacher_forced_logits_match_jax(jax_params, kv, atol):
    model, params = jax_params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (7, 13)]
    forced = rng.integers(0, 256, (6, 2)).astype(np.int32)
    jeng = JaxEngine(model, params, config=dict(CONFIG, kv_cache_dtype=kv))
    teng = _port_engine(params, kv_cache_dtype=kv)
    jfirst, jsteps = _teacher_forced(jeng, prompts, forced)
    tfirst, tsteps = _teacher_forced(teng, prompts, forced)
    assert tsteps.dtype == np.float32 and tsteps.shape == jsteps.shape
    np.testing.assert_allclose(tfirst, jfirst, atol=atol, rtol=0)
    np.testing.assert_allclose(tsteps, jsteps, atol=atol, rtol=0)
    assert teng.cache_facts()["dtype_census"] == \
        jeng.cache_facts()["dtype_census"]
    assert teng.cache_facts()["bytes"] == jeng.cache_facts()["bytes"]


SAMPLING = {"temperature": 0.8, "top_k": 16, "top_p": 0.9,
            "sampling_seed": 3}


def test_sampled_stream_reproducible_under_one_seed(jax_params):
    _, params = jax_params
    runs = []
    for _ in range(2):
        eng = _port_engine(params, **SAMPLING)
        runs.append({c.rid: c.tokens for c in
                     ContinuousBatchingScheduler(eng).run(_stream(Request))})
        assert eng.compile_counts() == {"prefill": 1, "decode": 1}
    assert runs[0] == runs[1]
    other = _port_engine(params, **dict(SAMPLING, sampling_seed=4))
    changed = {c.rid: c.tokens for c in
               ContinuousBatchingScheduler(other).run(_stream(Request))}
    assert changed != runs[0]


def test_sampled_tokens_stay_in_top_k_support(jax_params):
    _, params = jax_params
    eng = _port_engine(params, **SAMPLING)
    rng = np.random.default_rng(2)
    for i, n in enumerate((5, 12)):
        eng.prefill(i, rng.integers(0, 256, n).tolist())
    toks = rng.integers(0, 256, 2).astype(np.int32)
    pos = np.asarray([5, 12], np.int32)
    for _ in range(8):
        toks, logits = eng.decode(toks, pos)
        kth = np.sort(logits, axis=-1)[:, -SAMPLING["top_k"]]
        assert (logits[np.arange(2), toks] >= kth).all()
        pos = pos + 1


def test_config_rejects_what_jax_rejects(jax_params):
    _, params = jax_params
    for bad in ({"seq_buckets": (10, 32)}, {"max_batch": 0},
                {"attention_impl": "sparse"}, {"top_p": 0.0},
                {"attention_block_k": 12}, {"kv_cache_dtype": "int4"}):
        with pytest.raises(ValueError):
            _port_engine(params, **bad)
    for unported in ({"kv_layout": "paged"},
                     {"speculative": {"enabled": True, "k": 2}}):
        with pytest.raises(ValueError, match="not yet ported"):
            _port_engine(params, **unported)


def test_scheduler_timeouts_and_telemetry(jax_params, tmp_path):
    from deepspeed_tpu_torch.telemetry import JsonlExporter, TelemetrySession
    _, params = jax_params
    path = tmp_path / "serve.jsonl"
    session = TelemetrySession(exporters=[JsonlExporter(path)])
    eng = _port_engine(params)
    sched = ContinuousBatchingScheduler(eng, session=session)
    reqs = _stream(Request)
    reqs[-1].queue_timeout_s = 0.0
    reqs[-1].arrival_step = 1000
    done = _by_rid(sched.run(reqs))
    session.close()
    assert done[reqs[-1].rid].finish_reason == "timeout"
    assert done[reqs[-1].rid].slot == -1
    events = [e for e in session.events.recent()
              if e["event"] == "decode_step"]
    assert events and all(e["schema"] == "ds-tpu-telemetry/1"
                          for e in events)
    assert sum(e["tokens"] for e in events) == sum(
        len(c.tokens) - 1 for c in done.values() if c.slot >= 0)
    assert len(path.read_text().splitlines()) == len(session.events.recent())
    tokens = session.registry.counter("decode_tokens_total").value
    assert tokens == sum(e["tokens"] for e in events)
    assert session.registry.histogram("decode_step_seconds").count == \
        len(events)


def test_fault_seams_fire_in_the_serving_loop(jax_params):
    from deepspeed_tpu_torch.runtime.resilience import fault_injection as fi
    _, params = jax_params
    fi.clear_faults()
    try:
        fi.inject_decode_exception(at_step=2)
        sched = ContinuousBatchingScheduler(_port_engine(params))
        with pytest.raises(fi.InjectedDecodeError):
            sched.run(_stream(Request))
        assert sched.step_count == 2
        # a kill armed with a catchable signal lands at its prefill chunk
        hits = []
        old = signal.signal(signal.SIGUSR1, lambda *_: hits.append(1))
        try:
            fi.inject_kill("prefill_chunk", at_step=1, signum=signal.SIGUSR1)
            eng = _port_engine(params)
            eng.prefill(0, list(range(3)))             # one chunk: no hit
            assert hits == []
            eng.prefill(0, list(range(9)))             # chunk 1 fires
        finally:
            signal.signal(signal.SIGUSR1, old)
        assert hits == [1]
        with pytest.raises(ValueError, match="kill op"):
            fi.inject_kill("step")
    finally:
        fi.clear_faults()
