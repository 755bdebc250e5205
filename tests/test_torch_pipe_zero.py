"""The pipeline's remaining compositions: ZeRO stage 3, ZeRO-Offload and
sparse gradients inside a stage (``runtime/pipe/engine.py``).

Stage 3 gathers each stage's params on use while up to ``pipe``
micro-batches of the stage are in flight (1F1B); its losses and masters
must equal the stage 0 pipeline's bit for bit, as the plain engine's
stage 3 equals its stage 0 (``tests/test_torch_zero_dp.py``). Offload
runs one host C++ Adam a stage; it computes Adam in another order than
K4's plain version, so it is held to stage 0 at 2e-5 (losses, relative:
a master one f32 step apart can round to another bf16 param)
and 2e-6 (masters, absolute; lr 1e-2, 2 steps in one process, one
step across processes), and its device
params to bf16(masters) bit for bit. Sparse gradients take the CSR
exchange for the position table (``n_positions`` 256, far more rows
than a rank's tokens) and the dense all-reduce for the tied ``wte`` (a
MAX vote), and equal the dense pipeline bit for bit (at world 2 one CSR
sum is one addition, as the all-reduce's).

JAX's ``PipelineEngine`` runs none of these three here. ZeRO needs fp16
or bf16 in both configs, and JAX's engine raises under either (its
1F1B's ``lax.cond`` branches return the epilogue's and the tied leaves'
cotangents in the compute dtype on one side and fp32 on the other,
``deepspeed_tpu/runtime/pipe/pipeline.py:882-885``). Its sparse step
refuses a mesh with pipe > 1 (``engine.py:1915``), and at pipe 1 its
pipeline fails in this JAX (a ``shard_map`` context-mesh mismatch,
``pipeline.py:608``). So each composition is held to the port's stage 0
pipeline, which ``tests/test_torch_pipe.py`` and
``tests/test_torch_pipe_dp.py`` hold to JAX's 1F1B; the weights are
JAX's.

World 1 runs in this process (``LocalTransport``); world 2 runs two gloo
processes of ``tests/torch_pipe_worker.py`` at pipe 2 x data 2 (every
stage of a replica in one process) and pipe 1 x data 2, spawned once.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config
from deepspeed_tpu.models.gpt2_pipe import (
    gpt2_pipeline_module as jax_pipeline_module)
from deepspeed_tpu.runtime.pipe.pipeline import build_pipeline_parts
from deepspeed_tpu_torch.models.gpt2_pipe import convert_gpt2_pipe_params
from deepspeed_tpu_torch.runtime.pipe import pipeline as pl
from tests import torch_zero_harness as H
from tests.test_torch_pipe import (
    ADAM_EPS,
    as_torch,
    batch_of,
    port_engine,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_pipe_worker.py")
BF16 = dict(dtype=torch.bfloat16, bf16={"enabled": True})
STEPS = 2
OFFLOAD_LOSS_RTOL, OFFLOAD_MASTER_ATOL = 2e-5, 2e-6
JAX_LOSS_RTOL, JAX_MASTER_ATOL = 1e-5, 2e-5
POSITIONS = 256       # the position table's rows: more than a rank's tokens


def run_local(steps=STEPS, **extra):
    engine = port_engine(2, None, optimizer=ADAM_EPS, **extra)
    losses = [float(engine.train_batch(as_torch(batch_of(seed=i))))
              for i in range(steps)]
    return losses, engine.pipe_state(), engine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The tiny stages run on one intra-op thread (beside the other test
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stage0(one_thread):
    return run_local(**BF16)


@pytest.fixture(scope="module")
def stage3(one_thread):
    return run_local(**BF16, zero_optimization={"stage": 3})


@pytest.mark.parametrize("zero", [{"stage": 3},
                                  {"stage": 3, "gather_chunks": 2,
                                   "prefetch": False}],
                         ids=["plain", "chunks2_no_prefetch"])
def test_stage3_equals_stage0_bitwise(stage0, stage3, zero):
    want, masters, _ = stage0
    got, state, engine = stage3 if zero == {"stage": 3} else \
        run_local(**BF16, zero_optimization=zero)
    assert got == want
    for name, t in masters.items():
        assert torch.equal(state[name], t), name
    # two micro-batches were in flight on stage 0 (1F1B at pipe 2), and
    # every backward gathered its leaves again
    assert engine.executor.max_in_flight[0] == 2
    for se in engine.stage_engines:
        inst = se._installer
        assert inst.gather and inst.regathers > 0
        assert not inst._installed and not inst._bwd


def test_stage3_backward_never_reads_a_released_leaf(stage3):
    """Every leaf a backward reads was gathered for it: the regathers of
    a step cover every sharded leaf of each micro-batch's backward, and
    a released param's storage is empty (reading it would raise)."""
    engine = stage3[2]
    for se in engine.stage_engines:
        inst = se._installer
        before = inst.regathers
        engine.train_batch(as_torch(batch_of(seed=7)))
        sharded = sum(leaf.part.sharded for leaf in inst.leaves)
        assert inst.regathers - before >= engine.micro_batches * sharded
        for leaf in inst.leaves:
            assert leaf.module._parameters[leaf.name] is leaf.param
            assert leaf.param.numel() == 0


def test_offload_pipeline_follows_stage0(stage0):
    want, masters, _ = stage0
    got, state, engine = run_local(
        **BF16, zero_optimization={"stage": 2, "cpu_offload": True})
    np.testing.assert_allclose(got, want, rtol=OFFLOAD_LOSS_RTOL)
    for name, t in masters.items():
        np.testing.assert_allclose(state[name].numpy(), t.numpy(), rtol=0,
                                   atol=OFFLOAD_MASTER_ATOL, err_msg=name)
    for se in engine.stage_engines:
        assert se._offload and se.cpu_optimizer._step == STEPS
        for p, m in zip(se.params, se.cpu_optimizer.params()):
            assert torch.equal(p.data, m.to(torch.bfloat16))


def test_sparse_pipeline_equals_dense_bitwise():
    want, masters, _ = run_local()
    got, state, engine = run_local(sparse_gradients=True)
    assert got == want
    for name, t in masters.items():
        assert torch.equal(state[name], t), name
    m = engine._last_metrics
    assert "sparse_grad_dense_fallbacks" in m


@pytest.mark.parametrize("zero", [{"stage": 3},
                                  {"stage": 2, "cpu_offload": True}],
                         ids=["stage3", "offload"])
def test_checkpoint_resumes_bitwise(zero, tmp_path):
    kw = dict(BF16, zero_optimization=zero)
    a = port_engine(2, None, optimizer=ADAM_EPS, **kw)
    a.train_batch(as_torch(batch_of(seed=0)))
    a.save_checkpoint(str(tmp_path))
    want = [float(a.train_batch(as_torch(batch_of(seed=i))))
            for i in (1, 2)]
    b = port_engine(2, None, optimizer=ADAM_EPS, **kw)
    b.load_checkpoint(str(tmp_path))
    got = [float(b.train_batch(as_torch(batch_of(seed=i)))) for i in (1, 2)]
    assert got == want
    sa, sb = a.pipe_state(), b.pipe_state()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------

def wcase(pipe, dtype="bf16", **kw):
    mesh = {"pipe": pipe, "data": 2}
    return dict({"mesh": mesh, "batch": 16, "micro": 4, "steps": STEPS,
                 "dtype": dtype, "positions": POSITIONS}, **kw)


CASES = {
    "s0": wcase(2),
    "s3": wcase(2, stage=3),
    "off": wcase(2, stage=2, zero={"cpu_offload": True}),
    "s0_1": dict(wcase(2), steps=1),
    "off_1": dict(wcase(2, stage=2, zero={"cpu_offload": True}), steps=1),
    "d2": wcase(2, "f32"),
    "sp2": wcase(2, "f32", sparse=True),
    "d1": wcase(1, "f32"),
    "sp1": wcase(1, "f32", sparse=True),
}


def jax_cfg(positions):
    return GPT2Config(vocab_size=64, n_positions=positions, n_embd=32,
                      n_layer=4, n_head=4, dropout=0.0,
                      dtype=jax.numpy.float32)


def jax_params():
    """JAX's initial pipeline params (``n_positions`` 256), in the pipe
    layout."""
    module = jax_pipeline_module(jax_cfg(POSITIONS), seq_len=16)
    parts = build_pipeline_parts(module, 2, jax.random.PRNGKey(0),
                                 module.example_input)
    return convert_gpt2_pipe_params(jax.tree_util.tree_map(
        np.asarray, parts.params))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world-2 cases, from JAX's initial params."""
    root = tmp_path_factory.mktemp("pipe_zero")
    state = jax_params()
    path = root / "state.npz"
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    H.spawn_world(2, CASES, path, root, worker=WORKER)
    return root


def results(root, name):
    return H.load_results(root, name, 2)


def assert_same_run(root, a, b):
    for (xa, ma), (xb, mb) in zip(results(root, a), results(root, b)):
        assert ma["losses"] == mb["losses"], (a, b)
        for key, v in xa.items():
            if key.startswith("master/"):
                assert np.array_equal(v, xb[key]), (a, b, key)


def test_world2_stage3_equals_stage0_bitwise(world2):
    assert_same_run(world2, "s3", "s0")


def test_world2_offload_follows_stage0(world2):
    """Losses over 2 steps; masters after one (later, a master one f32
    step apart rounds to another bf16 param now and then, and the runs
    part by more)."""
    root = world2
    for (_, mo), (_, m0) in zip(results(root, "off"), results(root, "s0")):
        np.testing.assert_allclose(mo["losses"], m0["losses"],
                                   rtol=OFFLOAD_LOSS_RTOL)
    for (xo, _), (x0, _) in zip(results(root, "off_1"),
                                results(root, "s0_1")):
        for key, v in x0.items():
            if key.startswith("master/"):
                np.testing.assert_allclose(xo[key], v, rtol=0,
                                           atol=OFFLOAD_MASTER_ATOL,
                                           err_msg=key)
                dev = "device/" + key[len("master/"):]
                assert np.array_equal(
                    xo[dev], torch.from_numpy(xo[key]).bfloat16()
                    .float().numpy()), dev


@pytest.mark.parametrize("pipe", [1, 2])
def test_world2_sparse_equals_dense_bitwise(world2, pipe):
    root = world2
    assert_same_run(root, f"sp{pipe}", f"d{pipe}")
    for _, meta in results(root, f"sp{pipe}"):
        # the position table (256 rows, 128 tokens a rank) took the CSR
        # exchange: all-gathers of indices and values on its stage; the
        # vocab (64 rows) is below the budget and stays dense
        assert meta["sparse_fallbacks"] == [0] * STEPS
        assert meta["gathers"][0] == 2 * STEPS
    for _, meta in results(root, f"d{pipe}"):
        assert meta["gathers"][0] == 0
