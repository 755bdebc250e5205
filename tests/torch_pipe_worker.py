"""One rank of the pipeline tests across processes
(``tests/test_torch_pipe_dp.py``).

Run as ``python tests/torch_pipe_worker.py SPEC.json`` in each of the
world's processes, with the launcher env the port reads
(``DS_TPU_COORDINATOR`` a ``file://`` store, ``DS_TPU_NUM_PROCESSES``,
``DS_TPU_PROCESS_ID``). For every case of the spec it builds the
``gpt2_tiny`` pipeline through ``initialize`` from the spec's weights
(the pipe layout, an ``.npz``), takes ``value_and_grad`` of the first
batch at the loss scale 3 (ZeRO stage 0 cases), then trains ``steps``
batches. It writes its gradients (``grad/<stage>/<name>``, or
``grad/pipe/<name>`` in the pipe layout when every stage runs in the
process) and its stages' masters (``master/<stage>/<name>``) into
``<case>.<rank>.npz``, and its losses, stages, data rank and p2p counts
into ``<case>.<rank>.json``. It imports only ``torch``, ``numpy`` and
the port.
"""

import gc
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepspeed_tpu_torch import initialize  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny  # noqa: E402
from deepspeed_tpu_torch.models.gpt2_pipe import (  # noqa: E402
    gpt2_pipeline_module,
)
from deepspeed_tpu_torch.parallel import mesh  # noqa: E402
from deepspeed_tpu_torch.runtime.pipe.engine import (  # noqa: E402
    _stage_masters,
)

VOCAB, SEQ = 64, 16
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def engine_config(case):
    cfg = {"train_batch_size": case["batch"],
           "gradient_accumulation_steps": case["micro"],
           "steps_per_print": 10 ** 9, "mesh": case["mesh"],
           "optimizer": {"type": "Adam",
                         "params": {"lr": 1e-2, "eps": 1e-3}}}
    if case["dtype"] == "bf16":
        cfg["bf16"] = {"enabled": True}
    if case.get("stage") or case.get("zero"):
        cfg["zero_optimization"] = dict(case.get("zero") or {},
                                        stage=case.get("stage", 0))
    if case.get("sparse"):
        cfg["sparse_gradients"] = True
    return cfg


def batches(case):
    """The global batches (every process makes the same)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, VOCAB, (case["batch"], SEQ)).astype(np.int64)
            for _ in range(case["steps"])]


def run(case, state, out, rank):
    cfg = gpt2_tiny(vocab_size=VOCAB, n_positions=case.get("positions", SEQ),
                    n_embd=32, n_layer=4, n_head=4,
                    dtype=DTYPES[case["dtype"]])
    engine, _, _, _ = initialize(
        model=gpt2_pipeline_module(cfg, seq_len=SEQ),
        config=engine_config(case), model_parameters=state, device="cpu")
    data, d = engine.dp_world_size, engine.dp_rank
    rows = case["batch"] // data

    def mine(x):
        loads = any(se.module.is_first or se.module.is_last
                    for se in engine.stage_engines)
        return {"input_ids": torch.from_numpy(
            x[d * rows:(d + 1) * rows])} if loads else None

    arrays, meta = {}, {"stages": [se.module.stage_id
                                   for se in engine.stage_engines],
                        "data_rank": d, "in_process": engine.in_process}
    xs = batches(case)
    if not case.get("stage") and not case.get("zero") and \
            not case.get("sparse"):
        loss, grads = engine.value_and_grad(mine(xs[0]), 3.0)
        meta["vag_loss"] = float(loss)
        if engine.in_process:       # the pipe layout
            grads = {"pipe": grads}
        for s, by in grads.items():
            for name, g in by.items():
                arrays[f"grad/{s}/{name}"] = g.float().numpy()
    meta["losses"] = []
    for x in xs:
        meta["losses"].append(float(engine.train_batch(mine(x))))
        if case.get("sparse"):
            m = engine._last_metrics
            meta.setdefault("sparse_fallbacks", []).append(
                int(m["sparse_grad_dense_fallbacks"]))
    meta["p2p"] = engine.p2p_counts()
    meta["gathers"] = [se.comm.counts["all_gather"]["calls"]
                       for se in engine.stage_engines]
    for se in engine.stage_engines:
        for name, t in _stage_masters(se).items():
            arrays[f"master/{se.module.stage_id}/{name}"] = \
                t.float().numpy()
        if se._offload:     # the device params: the masters' bf16 copy
            for name, p in se.module.named_parameters():
                arrays[f"device/{se.module.stage_id}/{name}"] = \
                    p.detach().float().numpy()
    base = os.path.join(out, f"{case['name']}.{rank}")
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(meta, f)


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    with np.load(spec["state"]) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    mesh.initialize_distributed(device="cpu")
    rank = mesh.dp_rank()
    try:
        for name, case in spec["cases"].items():
            run(dict(case, name=name), state, spec["out"], rank)
    finally:
        # every engine dropped, then one barrier before the group goes
        gc.collect()
        mesh.destroy_distributed()


if __name__ == "__main__":
    main()
