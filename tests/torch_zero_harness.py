"""Shared parts of the ZeRO tests (``tests/test_torch_zero*.py``): gloo
worlds of ``tests/torch_zero_worker.py`` processes, and the JAX engine on
a sub-mesh of the same size.

:func:`spawn_world` writes the spec, starts one worker a rank with the
launcher env (``DS_TPU_COORDINATOR`` a ``file://`` store under the
test's directory), waits for each with its own timeout, kills every
worker still running when a wait runs out, and fails with the tail of
the failed worker's stderr. :func:`load_results` reads back what the
workers wrote.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import deepspeed_tpu
from deepspeed_tpu.models.gpt2 import GPT2LMHead as JaxGPT2
from deepspeed_tpu.models.gpt2 import gpt2_tiny as jax_tiny
from deepspeed_tpu.models.gpt2 import make_gpt2_loss_fn as jax_loss_fn
from deepspeed_tpu.parallel.mesh import build_mesh
from deepspeed_tpu_torch.models.gpt2 import convert_gpt2_params

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_zero_worker.py")
SPAWN_TIMEOUT_S = 180


def init_jax_params(**model_kw):
    model = JaxGPT2(jax_tiny(dtype=jnp.float32, **model_kw))
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]


def save_port_state(params, path):
    state = convert_gpt2_params(jax.tree_util.tree_map(np.asarray, params))
    np.savez(path, **{k: v.numpy() for k, v in state.items()})
    return str(path)


def spawn_world(world, cases, state_path, out_dir, timeout=SPAWN_TIMEOUT_S,
                worker=WORKER):
    """Run ``cases`` in ``world`` gloo processes of ``worker`` (the ZeRO
    worker by default); returns their stdout."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"cases": cases, "state": str(state_path),
                   "out": out_dir}, f)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ)
    env.update({"DS_TPU_COORDINATOR": f"file://{store}",
                "DS_TPU_NUM_PROCESSES": str(world),
                "OMP_NUM_THREADS": "1"})
    procs = []
    for rank in range(world):
        penv = dict(env, DS_TPU_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, worker, spec], env=penv, cwd=out_dir,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                raise AssertionError(
                    f"rank {rank} of {world} timed out after {timeout} s:"
                    f"\n{err[-3000:]}")
            if p.returncode != 0:
                raise AssertionError(
                    f"rank {rank} of {world} exited {p.returncode}:\n"
                    f"{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def load_results(out_dir, name, world):
    """``[(arrays, meta)]`` of case ``name``, one per rank."""
    rows = []
    for rank in range(world):
        base = os.path.join(str(out_dir), f"{name}.{rank}")
        with np.load(base + ".npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(base + ".json") as f:
            rows.append((arrays, json.load(f)))
    return rows


def jax_config(case):
    """The JAX engine's config for a worker case (the same keys)."""
    cfg = {"train_batch_size": case.get("batch", 8),
           "gradient_accumulation_steps": case.get("accum", 2),
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam",
                         "params": {"lr": case.get("lr", 1e-2)}}}
    if case["dtype"] == "bf16":
        cfg["bf16"] = {"enabled": True}
    if case["dtype"] == "fp16":
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8}
    zero = dict(case.get("zero", {}))
    if case.get("stage") or zero:
        zero.setdefault("stage", case.get("stage", 0))
        cfg["zero_optimization"] = zero
    if case.get("clip"):
        cfg["gradient_clipping"] = case["clip"]
    if case.get("amp"):
        # bf16 compute asked for by the amp key instead of bf16's
        del cfg["bf16"]
        cfg["amp"] = {"enabled": True}
    cfg.update(case.get("keys", {}))
    return cfg


def jax_batches(case):
    rng = np.random.default_rng(case.get("data_seed", 0))
    vocab = case.get("model", {}).get("vocab_size", 256)
    return [rng.integers(0, vocab, (case.get("batch", 8), 32))
            .astype(np.int32) for _ in range(case.get("steps", 3))]


def jax_engine(params, case, world):
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16,
             "fp16": jnp.float16}[case["dtype"]]
    model = JaxGPT2(jax_tiny(dtype=dtype,
                             use_flash_attention=case.get("flash", True),
                             **case.get("model", {})))
    mesh = build_mesh({"data": world}, devices=jax.devices()[:world])
    engine, _, _, _ = deepspeed_tpu.initialize(
        config=jax_config(case), loss_fn=jax_loss_fn(model), params=params,
        mesh=mesh)
    return engine, mesh


def jax_run(params, case, world):
    """The JAX engine's losses over the case's batches, and the engine."""
    engine, mesh = jax_engine(params, case, world)
    losses = [float(engine.train_batch({"input_ids": x}))
              for x in jax_batches(case)]
    return np.array(losses), engine, mesh


def device_shards(tree, mesh):
    """``{port name: [device r's shard of the leaf]}`` of a JAX param-
    shaped tree (Dense kernels transposed to the port's ``[out, in]``)."""
    devices = list(mesh.devices.reshape(-1))
    by_device = []
    for d in devices:
        leaf_shards = jax.tree_util.tree_map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == d), tree)
        by_device.append(convert_gpt2_params(leaf_shards))
    return {n: [np.asarray(sd[n]) for sd in by_device]
            for n in by_device[0]}
