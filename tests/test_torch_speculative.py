"""Self-speculative decoding: the port's
`deepspeed_tpu_torch/inference/speculative.py` against the JAX
package's `deepspeed_tpu/inference/speculative.py`.

- ``greedy_accept`` is exact against JAX on the same tensors.
- ``rejection_accept`` draws from a ``torch.Generator``, which cannot
  reproduce ``jax.random``; it passes the statistical pins of the JAX
  package's `tests/unit/test_speculative.py` instead.
- Greedy speculative streams (f32) are token-identical to the plain
  engine's and to the JAX speculative engine's, on the ring and the
  paged layout; the contract is three programs with decode at 0.
- Degenerate configs fall back to two programs; validation errors
  match JAX.

Model: ``gpt2_tiny(n_embd=32)`` in f32, initialised in JAX and carried
across with ``convert_gpt2_params``; max_batch 2, seq buckets (16,
32), prefill chunk 4, k 3, one draft layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import speculative as jspec
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
from deepspeed_tpu_torch.inference import speculative as tspec
from deepspeed_tpu_torch.models.gpt2 import (
    GPT2LMHead,
    convert_gpt2_params,
    gpt2_tiny,
)
from tests.torch_threads import one_thread  # noqa: F401

SPEC = {"enabled": True, "k": 3, "draft_layers": 1}
BASE = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4}
THREE = {"prefill": 1, "decode": 0, "draft": 1, "verify": 1}


@pytest.fixture(scope="module")
def jax_params():
    model = JaxGPT2(jax_tiny(n_embd=32, dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


@pytest.fixture(scope="module")
def state(jax_params):
    return convert_gpt2_params(
        jax.tree_util.tree_map(np.asarray, jax_params[1]))


def _config(speculative, overrides):
    cfg = dict(BASE, **overrides)
    if speculative is not None:
        cfg["speculative"] = speculative
    return cfg


def _engine(state, speculative=SPEC, **overrides):
    model = GPT2LMHead(gpt2_tiny(n_embd=32, dtype=torch.float32),
                       device="cpu")
    return InferenceEngine(model, state,
                           config=_config(speculative, overrides),
                           device="cpu")


def _stream(cls, n=5, seed=1, max_new=5):
    rng = np.random.default_rng(seed)
    return [cls(f"r{i}", rng.integers(0, 256,
                                      int(rng.integers(2, 20))).tolist(),
                max_new_tokens=max_new) for i in range(n)]


def _tokens(sched, requests):
    return {c.rid: (c.tokens, c.finish_reason) for c in sched.run(requests)}


# -- accept rules ------------------------------------------------------------

GREEDY_CASES = [
    ([[5, 6, 7, 9]], [[1, 5, 6, 7]], [3]),        # all match: bonus
    ([[5, 6, 7, 9]], [[1, 4, 6, 7]], [3]),        # first mismatch
    ([[5, 6, 7, 9]], [[1, 5, 6, 8]], [3]),        # partial prefix
    ([[5, 6, 7, 9]], [[1, 5, 6, 7]], [1]),        # draft_len masks padding
    ([[5, 6, 7, 9], [5, 6, 7, 9]], [[1, 5, 6, 7], [1, 4, 6, 7]], [3, 3]),
    ([[2, 2, 2, 2], [3, 1, 4, 1]], [[0, 2, 2, 2], [9, 3, 1, 4]], [0, 2]),
]


@pytest.mark.parametrize("pred,tokens,draft_len", GREEDY_CASES)
def test_greedy_accept_is_exact_against_jax(pred, tokens, draft_len):
    jacc, jout = jspec.greedy_accept(jnp.asarray(pred, jnp.int32),
                                     jnp.asarray(tokens, jnp.int32),
                                     jnp.asarray(draft_len, jnp.int32))
    tacc, tout = tspec.greedy_accept(
        torch.tensor(pred, dtype=torch.int32),
        torch.tensor(tokens, dtype=torch.int32),
        torch.tensor(draft_len, dtype=torch.int32))
    assert tacc.tolist() == np.asarray(jacc).tolist()
    assert tout.dtype == torch.int32
    assert tout.tolist() == np.asarray(jout).tolist()


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_rejection_identical_distributions_always_accept():
    V = 4
    p = torch.nn.functional.one_hot(torch.tensor([2, 1, 3]), V).float()[None]
    q = p[:, :2]
    tokens = torch.tensor([[0, 2, 1]], dtype=torch.int32)
    acc, out = tspec.rejection_accept(p, tokens, torch.tensor([2]), q,
                                      _gen(0))
    assert int(acc[0]) == 2
    assert out[0].tolist() == [2, 1, 3]


def test_rejection_zero_target_mass_always_rejects():
    V = 4
    p = torch.nn.functional.one_hot(torch.tensor([3]), V).float()[None]
    p = p.expand(1, 2, V).contiguous()
    q = torch.nn.functional.one_hot(torch.tensor([1]), V).float()[None]
    tokens = torch.tensor([[0, 1]], dtype=torch.int32)
    acc, out = tspec.rejection_accept(p, tokens, torch.tensor([1]), q,
                                      _gen(0))
    assert int(acc[0]) == 0
    assert int(out[0, 0]) == 3              # residual == p, token 3


def test_rejection_empirical_accept_rate_matches_min_mass():
    """Accepts d ~ q with total probability sum_x min(p(x), q(x)), over
    4096 i.i.d. rows."""
    B, V = 4096, 4
    p_row = torch.tensor([0.5, 0.3, 0.1, 0.1])
    q_row = torch.tensor([0.1, 0.3, 0.5, 0.1])
    gen = _gen(7)
    drafts = torch.multinomial(q_row.expand(B, V), 1, replacement=True,
                               generator=gen)[:, 0].to(torch.int32)
    tokens = torch.stack([torch.zeros(B, dtype=torch.int32), drafts], dim=1)
    probs = p_row.expand(B, 2, V).contiguous()
    q = q_row.expand(B, 1, V).contiguous()
    acc, _ = tspec.rejection_accept(probs, tokens,
                                    torch.ones(B, dtype=torch.int32), q, gen)
    expected = float(torch.minimum(p_row, q_row).sum())
    rate = float((acc == 1).float().mean())
    assert rate == pytest.approx(expected, abs=0.03)


# -- greedy parity -----------------------------------------------------------

@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_greedy_streams_identical_to_plain_and_to_jax(jax_params, state,
                                                      layout):
    model, params = jax_params
    spec = _engine(state, kv_layout=layout)
    plain = _engine(state, speculative=None, kv_layout=layout)
    spec_out = _tokens(ContinuousBatchingScheduler(spec), _stream(Request))
    plain_out = _tokens(ContinuousBatchingScheduler(plain), _stream(Request))
    jeng = JaxEngine(model, params,
                     config=_config(SPEC, {"kv_layout": layout}))
    jax_out = _tokens(JaxScheduler(jeng), _stream(JaxRequest))
    assert spec_out == plain_out == jax_out
    assert spec.compile_counts() == THREE == jeng.compile_counts()
    assert plain.compile_counts() == {"prefill": 1, "decode": 1}
    facts = spec.speculative.facts()
    jfacts = jeng.speculative.facts()
    assert facts == jfacts
    assert facts["mean_accepted"] >= 1.0 and facts["rounds"] > 0


def test_single_row_paged_speculation_matches_plain(state):
    """max_batch 1: every verify chunk is a one-row write, and those
    that straddle a page edge must still land token by token."""
    spec = _engine(state, kv_layout="paged", max_batch=1)
    plain = _engine(state, speculative=None, kv_layout="paged", max_batch=1)
    reqs = lambda: _stream(Request, n=4, max_new=10)  # noqa: E731
    assert _tokens(ContinuousBatchingScheduler(spec), reqs()) == \
        _tokens(ContinuousBatchingScheduler(plain), reqs())
    assert spec.compile_counts() == THREE


def test_flash_int8_draft_matches_dense_int8_plain(state):
    """The draft runs flash decode (the ring kernel's plain version
    here), verify is dense by design; the stream still equals the plain
    dense engine's."""
    spec = _engine(state, attention_impl="flash", attention_block_k=8,
                   kv_cache_dtype="int8")
    plain = _engine(state, speculative=None, kv_cache_dtype="int8")
    assert _tokens(ContinuousBatchingScheduler(spec), _stream(Request)) == \
        _tokens(ContinuousBatchingScheduler(plain), _stream(Request))
    assert spec.compile_counts() == THREE


def test_sampled_serve_three_programs_and_progress(state):
    eng = _engine(state, temperature=0.8, top_k=16, top_p=0.9,
                  sampling_seed=3, kv_layout="paged")
    comps = ContinuousBatchingScheduler(eng).run(_stream(Request, n=4))
    assert len(comps) == 4
    assert eng.compile_counts() == THREE
    facts = eng.speculative.facts()
    assert facts["mean_accepted"] >= 1.0
    assert 0.0 <= facts["draft_efficiency"] <= 1.0


def test_length_finish_before_max_seq_overrun(jax_params, state):
    model, params = jax_params
    req = [Request("r0", list(range(8)), max_new_tokens=12)]
    spec_c = ContinuousBatchingScheduler(
        _engine(state, seq_buckets=(16,))).run(list(req))[0]
    plain_c = ContinuousBatchingScheduler(
        _engine(state, speculative=None, seq_buckets=(16,))).run(list(req))[0]
    jeng = JaxEngine(model, params, config=_config(SPEC,
                                                   {"seq_buckets": (16,)}))
    jax_c = JaxScheduler(jeng).run(
        [JaxRequest("r0", list(range(8)), max_new_tokens=12)])[0]
    assert spec_c.finish_reason == "length" == jax_c.finish_reason
    assert spec_c.tokens == jax_c.tokens
    assert 8 + len(spec_c.tokens) <= 16
    assert len(plain_c.tokens) - len(spec_c.tokens) <= SPEC["k"] + 1
    assert spec_c.tokens == plain_c.tokens[:len(spec_c.tokens)]


# -- fallback, controller, validation -----------------------------------------

@pytest.mark.parametrize("speculative", [
    {"enabled": True, "k": 0}, {"enabled": True, "k": 3, "draft_layers": 2},
    {"enabled": False, "k": 3}, None])
def test_degenerate_configs_fall_back_to_two_programs(state, speculative):
    eng = _engine(state, speculative=speculative)
    assert eng.speculative is None
    assert eng.compile_counts() == {"prefill": 0, "decode": 0}
    out = _tokens(ContinuousBatchingScheduler(eng), _stream(Request, n=3))
    assert len(out) == 3
    assert eng.compile_counts() == {"prefill": 1, "decode": 1}


def test_adaptive_controller_matches_jax(jax_params, state):
    model, params = jax_params
    grow = dict(SPEC, min_accept_to_grow=1.0)
    engines = (_engine(state, speculative=grow),
               JaxEngine(model, params, config=_config(grow, {})))
    rounds = [(2, 4, 2, 4), (2, 6, 6, 8), (2, 6, 0, 2), (2, 4, 0, 2),
              (2, 2, 0, 2), (2, 2, 0, 2)]
    seen = []
    for eng in engines:
        spec = eng.speculative
        spec._j = 2
        lens = []
        for r in rounds:
            spec.observe(*r)
            lens.append(spec.draft_len())
        seen.append((lens, spec.facts()))
    assert seen[0] == seen[1]
    assert seen[0][0] == [3, 3, 2, 1, 1, 1]


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_validation_errors_match_jax(jax_params, state):
    model, params = jax_params
    jplain = JaxEngine(model, params, config=BASE)
    tplain = _engine(state, speculative=None)
    for kw in ({"k": 2, "draft_layers": 2}, {"k": 2, "draft_layers": 0},
               {"k": 32, "draft_layers": 1}, {"k": 0, "draft_layers": 1},
               {"k": 2, "draft_layers": 1, "min_accept_to_grow": -1.0}):
        assert _error(lambda: tspec.SpeculativeDecoder(tplain, **kw)) == \
            _error(lambda: jspec.SpeculativeDecoder(jplain, **kw))
    bad = {"enabled": True, "k": -1}
    assert _error(lambda: _engine(state, speculative=bad)) == _error(
        lambda: JaxEngine(model, params, config=_config(bad, {})))
