"""Tensor-parallel serving (``inference/engine.py``, ``inference/cache.py``
with a GPT-2 built for a model axis) in gloo worlds of 2 processes, one
engine a rank over its shard, held to JAX's ``InferenceEngine(mesh=
{"model": 2})`` and to the port's one-rank engine on the same request
stream (``tests/test_torch_serving.py``'s: max_batch 2, buckets (16, 32),
prefill chunk 4, flash decode with block_k 8, six prompts over both
buckets). f32 greedy streams are token-identical on the ring (K5) and
paged (K6) layouts, on every rank; the cache holds n_head / 2 heads a
rank; teacher-forced f32 logits agree with JAX's to atol 2e-6, the
single-engine test's tolerance (the row-parallel sums reassociate)."""

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
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.inference import (
    ContinuousBatchingScheduler,
    InferenceEngine,
    Request,
)
from deepspeed_tpu_torch.models.gpt2 import GPT2LMHead, gpt2_tiny
from tests import torch_zero_harness as H

WORKER = H.WORKER.replace("torch_zero_worker", "torch_tp_worker")
CONFIG = {"max_batch": 2, "seq_buckets": (16, 32), "prefill_chunk": 4,
          "attention_impl": "flash", "attention_block_k": 8}
PAGED = dict(CONFIG, kv_layout="paged", page_size=8)
PROMPT_LENS = (3, 9, 14, 20, 6, 11)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This process's torch work on one intra-op thread (the tiny shapes
    gain nothing from more, and the gloo workers and the other test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_serve")
    model = JaxGPT2(jax_tiny(dtype=jnp.float32))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    state = H.save_port_state(params, root / "state.npz")
    cases = [{"name": "ring", "kind": "serve", "config": CONFIG,
              "prompts": PROMPT_LENS, "mesh": {"model": 2}},
             {"name": "paged", "kind": "serve", "config": PAGED,
              "prompts": PROMPT_LENS, "mesh": {"model": 2}},
             {"name": "ring_int8", "kind": "serve",
              "config": dict(CONFIG, kv_cache_dtype="int8"),
              "prompts": PROMPT_LENS, "mesh": {"model": 2}}]
    H.spawn_world(2, cases, state, root, worker=WORKER)
    return root, model, params, state


def _stream(cls):
    rng = np.random.default_rng(0)
    return [cls(f"r{i}", rng.integers(0, 256, n).tolist(),
                max_new_tokens=6, arrival_step=i)
            for i, n in enumerate(PROMPT_LENS)]


def port_stream(state, config):
    sd = {k: torch.from_numpy(v) for k, v in np.load(state).items()}
    eng = InferenceEngine(GPT2LMHead(gpt2_tiny(dtype=torch.float32),
                                     device="cpu"), sd, config=config,
                          device="cpu")
    return {c.rid: list(map(int, c.tokens)) for c in
            ContinuousBatchingScheduler(eng).run(_stream(Request))}


@pytest.mark.parametrize("name,config", [("ring", CONFIG),
                                         ("paged", PAGED)])
def test_greedy_streams_equal_model1_and_every_rank(served, name, config):
    root, _, _, state = served
    want = port_stream(state, config)
    for _, meta in H.load_results(root, name, 2):
        assert meta["tokens"] == want
        assert meta["counts"] == {"prefill": 1, "decode": 1}
        assert meta["cache_heads"] == 2


def test_greedy_streams_equal_jax_tp_engine(served):
    root, model, params, _ = served
    mesh = build_mesh({"model": 2}, devices=jax.devices()[:2])
    jeng = JaxEngine(model, params, config=CONFIG, mesh=mesh)
    jout = {c.rid: list(map(int, c.tokens))
            for c in JaxScheduler(jeng).run(_stream(JaxRequest))}
    for name in ("ring", "paged"):
        for _, meta in H.load_results(root, name, 2):
            assert meta["tokens"] == jout


def test_teacher_forced_logits_match_jax_tp_engine(served):
    root, model, params, _ = served
    mesh = build_mesh({"model": 2}, devices=jax.devices()[:2])
    for name, kv, atol in (("ring", None, 2e-6), ("ring_int8", "int8",
                                                  1e-4)):
        jeng = JaxEngine(model, params,
                         config=dict(CONFIG, kv_cache_dtype=kv), mesh=mesh)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 256, n).tolist() for n in (7, 13)]
        forced = rng.integers(0, 256, (6, 2)).astype(np.int32)
        first = np.stack([np.asarray(jeng.prefill(i, p))
                          for i, p in enumerate(prompts)])
        pos = np.asarray([len(p) for p in prompts], np.int32)
        steps = []
        for toks in forced:
            _, logits = jeng.decode(toks, pos)
            steps.append(np.asarray(logits))
            pos = pos + 1
        for arrays, _ in H.load_results(root, name, 2):
            np.testing.assert_allclose(arrays["first"], first, atol=atol,
                                       rtol=0)
            np.testing.assert_allclose(arrays["steps"], np.stack(steps),
                                       atol=atol, rtol=0)


def test_kv_partition_specs_split_the_head_axis():
    from deepspeed_tpu_torch.inference.cache import (
        kv_partition_specs, spec_for_model)
    cfg = gpt2_tiny(dtype=torch.float32)
    spec = spec_for_model(cfg, 2, 32, "int8", model_size=2)
    assert spec.n_head == cfg.n_head // 2
    specs = kv_partition_specs(spec)
    assert specs["h_0"] == {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2}
    stacked = spec_for_model(gpt2_tiny(dtype=torch.float32,
                                       scan_layers=True), 2, 32)
    assert kv_partition_specs(stacked) == {"h": {"k": 3, "v": 3}}
