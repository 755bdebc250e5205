"""``parallel/pipe_auto.py``: a torch module (the port's
``TPTransformerBlock``) wrapped as a pipeline body layer, held to JAX's
``tests/unit/test_pipe_auto.py``: the wrapped block's partition specs
(column-parallel ``c_attn`` / ``c_fc`` and row-parallel ``c_proj``
split, LayerNorms replicated), the engine's refusal of ``auto_axes``
with JAX's error, and the wrapped layers through the pipeline against
JAX's 1F1B of ``FlaxPipelineLayer(TPTransformerBlock)`` at pipe 2 (loss
rtol 1e-5, gradients rtol 3e-4 / atol 1e-6, JAX's bounds), from JAX's
weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu.parallel.pipe_auto import FlaxPipelineLayer as JaxLayer
from deepspeed_tpu.parallel.tensor_parallel import (
    TPTransformerBlock as JaxBlock)
from deepspeed_tpu.runtime.pipe.module import LayerSpec as JaxSpec
from deepspeed_tpu.runtime.pipe.module import PipelineModule as JaxModule
from deepspeed_tpu.runtime.pipe.pipeline import (
    build_pipeline_parts,
    make_pipeline_value_and_grad_fn,
)
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.parallel.pipe_auto import TorchPipelineLayer
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    TPTransformerBlock,
)
from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule

D_MODEL, N_HEAD, SEQ, ROWS, MICRO = 8, 4, 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """This process's torch work on one intra-op thread (the tiny shapes
    gain nothing from more, and the gloo workers and the other test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JEmbed:
    def init(self, rng, micro):
        return {"emb": jax.random.normal(rng, (32, D_MODEL)) * 0.1}

    def apply(self, params, micro, rng=None):
        return params["emb"][micro["ids"]]


class _JHead:
    def init(self, rng, x):
        return {"w": jax.random.normal(rng, (D_MODEL, 32)) * 0.1}

    def apply(self, params, x, rng=None):
        return x @ params["w"]


def _jloss(out, micro):
    lp = jax.nn.log_softmax(out.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(lp, micro["labels"][..., None],
                                         axis=-1))


class _Embed(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Parameter(torch.zeros(32, D_MODEL))

    def forward(self, micro):
        return self.emb[micro["ids"]]


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(D_MODEL, 32))

    def forward(self, x):
        return x @ self.w


def _loss(out, micro):
    lp = torch.log_softmax(out.float(), -1)
    return -torch.gather(lp, -1, micro["labels"][..., None].long()).mean()


def port_module(auto_axes=()):
    return PipelineModule(
        layers=[LayerSpec(_Embed)] +
        [LayerSpec(TorchPipelineLayer, TPTransformerBlock, D_MODEL, N_HEAD)
         for _ in range(2)] + [LayerSpec(_Head)],
        num_stages=2, loss_fn=_loss, auto_axes=auto_axes)


def _to_port(tree):
    """JAX's pipe params of the wrapped module under the port's names
    (flax kernels ``[.., in, out]`` as ``weight`` ``[.., out, in]``)."""
    out = {}

    def walk(prefix, t):
        for k, v in t.items():
            name = f"{prefix}.{k}"
            if hasattr(v, "items"):
                walk(name, v)
                continue
            a = torch.from_numpy(np.array(v, dtype=np.float32))
            if name.startswith("body."):
                name = "body.module" + name[len("body"):]
                if k == "kernel":
                    name, a = name[:-len("kernel")] + "weight", \
                        a.transpose(-1, -2).contiguous()
                elif k == "scale":
                    name = name[:-len("scale")] + "weight"
            out[name] = a
    for section, t in tree.items():
        walk(section, t)
    return out


@pytest.fixture(scope="module")
def jax_run():
    module = JaxModule(
        layers=[JaxSpec(_JEmbed)] +
        [JaxSpec(JaxLayer, JaxBlock, n_head=N_HEAD) for _ in range(2)] +
        [JaxSpec(_JHead)], num_stages=2, loss_fn=_jloss,
        example_input={"ids": np.zeros((2, SEQ), np.int32),
                       "labels": np.zeros((2, SEQ), np.int32)},
        auto_axes=("model",))
    rng = np.random.default_rng(0)
    micro = {"ids": rng.integers(0, 32, (2, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 32, (2, SEQ)).astype(np.int32)}
    parts = build_pipeline_parts(module, num_stages=2,
                                 rng=jax.random.PRNGKey(0),
                                 example_micro=micro)
    mesh = build_mesh({"pipe": 2, "model": 1, "data": 1},
                      devices=jax.devices()[:2])
    fn = jax.jit(make_pipeline_value_and_grad_fn(
        parts, mesh, MICRO, auto_axes=("model",)))
    batch = {"ids": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 32, (ROWS, SEQ)).astype(np.int32)}
    loss, grads = fn(parts.params, batch, None, jnp.float32(1.0))
    np_tree = jax.tree_util.tree_map(np.asarray, parts.params)
    return (float(loss), _to_port(jax.tree_util.tree_map(np.asarray, grads)),
            _to_port(np_tree), batch)


def test_wrapped_block_matches_jax_1f1b(jax_run):
    loss, grads, params, batch = jax_run
    engine, _, _, _ = initialize(
        model=port_module(), model_parameters=params, device="cpu",
        config={"train_batch_size": ROWS,
                "gradient_accumulation_steps": MICRO,
                "steps_per_print": 10 ** 9, "mesh": {"pipe": 2},
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}})
    got, port_grads = engine.value_and_grad(
        {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), loss, rtol=1e-5)
    assert sorted(port_grads) == sorted(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(port_grads[name].numpy(), g.numpy(),
                                   rtol=3e-4, atol=1e-6, err_msg=name)


def test_placement_specs_split_the_kernels():
    """JAX ``test_auto_tp_placement_specs_shard_kernels_over_model``: the
    column and row kernels are split, the LayerNorms replicated."""
    layer = TorchPipelineLayer(TPTransformerBlock, D_MODEL, N_HEAD)
    specs = layer.param_partition_specs()
    assert specs["module.attn.c_attn.weight"] == Shard(0, 3)
    assert specs["module.mlp.c_fc.weight"] == Shard(0)
    assert specs["module.attn.c_proj.weight"] == Shard(1)
    assert specs["module.mlp.c_proj.weight"] == Shard(1)
    assert specs["module.ln_1.weight"] is None
    assert specs["module.attn.c_proj.bias"] is None


def test_auto_tp_engine_gated_with_clear_error():
    """The engine refuses ``auto_axes`` with JAX's error and text."""
    with pytest.raises(NotImplementedError,
                       match=r"auto_axes=\('model',\)\) through the engine "
                             r"is experimental"):
        initialize(model=port_module(auto_axes=("model",)), device="cpu",
                   config={"train_batch_size": ROWS,
                           "gradient_accumulation_steps": MICRO,
                           "mesh": {"pipe": 2},
                           "optimizer": {"type": "Adam",
                                         "params": {"lr": 1e-2}}})
