"""One rank of the tensor-, sequence- and expert-parallel tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_tp*.py``,
``tests/test_torch_pipe_tp.py``, ``tests/test_torch_sequence.py``,
``tests/test_torch_pipe_sp.py``, ``tests/test_torch_moe.py``,
``tests/test_torch_expert_pipe.py``, ``tests/test_torch_onebit_*.py``,
``tests/test_torch_bert_tp.py``, ``tests/test_torch_tp_scan.py``).

Run as ``python tests/torch_tp_worker.py SPEC.json`` in each of the
world's processes with the launcher env the port reads (through
``tests/torch_zero_harness.py:spawn_world``). It joins the gloo group,
runs every case of the spec (``kind`` picks the runner) and writes
``<case>.<rank>.npz`` and ``<case>.<rank>.json`` into the spec's ``out``
directory. It imports only ``torch``, ``numpy`` and the port.
"""

import gc
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepspeed_tpu_torch.parallel import collectives as C  # noqa: E402
from deepspeed_tpu_torch.parallel import mesh  # noqa: E402

B, T, K = 2, 3, 8
M_ODD, M_EVEN = 10, 8


def rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def value_and_grad(fn, weight, *args):
    """``(loss, grads)`` of ``sum(fn(*args) * weight)``."""
    xs = [t(a, True) for a in args]
    loss = (fn(*xs) * t(weight)).sum()
    loss.backward()
    return loss.detach().numpy(), [x.grad.numpy() for x in xs]


def run_collectives(case, spec, groups):
    """Every collective of ``parallel/collectives.py`` on this rank's
    shards of seeded inputs: the forward values and the local grads."""
    group = groups.axis("model")
    n, r = group.size, group.rank
    out, meta = {}, {}
    kl = K // n

    a, w2 = rand(0, (B, T, K)), rand(2, (B, T, M_ODD))
    for m in (M_ODD, M_EVEN):
        b = rand(1, (K, m))
        w = rand(2, (B, T, m))
        for chunks, bidir in case["grid"]:
            key = f"mpo/{m}/{chunks}/{int(bidir)}"
            loss, (ga, gb) = value_and_grad(
                lambda al, bl: C.matmul_psum_overlap(
                    al, bl, group, chunks=chunks, bidirectional=bidir),
                w, a[..., r * kl:(r + 1) * kl], b[r * kl:(r + 1) * kl])
            out[key + "/loss"], out[key + "/ga"], out[key + "/gb"] = \
                loss, ga, gb
        # chunks=1 against psum_combine(a @ b), the monolithic form
        al, bl = t(a[..., r * kl:(r + 1) * kl]), t(b[r * kl:(r + 1) * kl])
        out[f"mono/{m}"] = C.psum_combine(al @ bl, group).numpy()
        out[f"mpo1/{m}"] = C.matmul_psum_overlap(al, bl, group,
                                                 chunks=1).numpy()

    b = rand(1, (K, M_EVEN))
    w = rand(2, (B, T, M_EVEN))
    ml = M_EVEN // n
    for chunks, bidir in case["grid"]:
        key = f"mrs/{chunks}/{int(bidir)}"
        loss, (ga, gb) = value_and_grad(
            lambda al, bl: C.matmul_reduce_scatter(
                al, bl, group, chunks=chunks, bidirectional=bidir),
            w[..., r * ml:(r + 1) * ml], a[..., r * kl:(r + 1) * kl],
            b[r * kl:(r + 1) * kl])
        out[key + "/loss"], out[key + "/ga"], out[key + "/gb"] = \
            loss, ga, gb

        key = f"agm/{chunks}/{int(bidir)}"
        loss, (gx, gw) = value_and_grad(
            lambda xl, wf: C.all_gather_matmul_overlap(
                xl, wf, group, chunks=chunks, bidirectional=bidir),
            w, a[..., r * kl:(r + 1) * kl], b)
        out[key + "/loss"], out[key + "/gx"], out[key + "/gw"] = \
            loss, gx, gw

    x = rand(10 + r, (B, T, 2 * n))
    wt = rand(11, (B, n * T, 2))
    for chunks in (1, 2, 4):
        loss, (gx,) = value_and_grad(
            lambda xl: C.all_to_all_overlap(xl, group, 2, 1, chunks=chunks),
            wt, x)
        out[f"a2a/{chunks}/loss"], out[f"a2a/{chunks}/gx"] = loss, gx
        out[f"a2a/{chunks}/y"] = C.all_to_all_overlap(
            t(x), group, 2, 1, chunks=chunks).numpy()

    xs = rand(20, (n, T, M_ODD))
    for chunks, bidir in case["grid"]:
        out[f"ring/{chunks}/{int(bidir)}"] = C.ring_psum(
            t(xs[r]), group, chunks=chunks, bidirectional=bidir).numpy()
        g, _ = C.ring_all_gather(t(xs[r]), group, axis=0, chunks=chunks,
                                 bidirectional=bidir)
        out[f"rag/{chunks}/{int(bidir)}"] = g.numpy()

    h = rand(30, (B, T, K))
    wf = rand(31, (K, M_EVEN))
    c = rand(32, (B, T, ml))
    for chunks in (1, 4):
        loss, (gh,) = value_and_grad(
            lambda hh: C.psum_grad(hh, group, chunks=chunks) @ t(
                wf[:, r * ml:(r + 1) * ml]), c, h)
        out[f"pg/{chunks}/gh"] = gh

    for codec in case["codecs"]:
        for chunks, bidir in case["wire_grid"]:
            key = f"wire/{codec}/{chunks}/{int(bidir)}"
            out[key + "/ring"] = C.ring_psum(
                t(xs[r]), group, chunks=chunks, bidirectional=bidir,
                wire_dtype=codec, wire_chunk=16).numpy()
            loss, (ga, gb) = value_and_grad(
                lambda al, bl: C.matmul_psum_overlap(
                    al, bl, group, chunks=chunks, bidirectional=bidir,
                    wire_dtype=codec, wire_chunk=16),
                w2, a[..., r * kl:(r + 1) * kl],
                rand(1, (K, M_ODD))[r * kl:(r + 1) * kl])
            out[key + "/mpo"], out[key + "/ga"], out[key + "/gb"] = \
                loss, ga, gb
            g, _ = C.ring_all_gather(t(xs[r]), group, axis=0,
                                     chunks=chunks, bidirectional=bidir,
                                     wire_dtype=codec, wire_chunk=16)
            out[key + "/rag"] = g.numpy()

    C.reset_collective_counts()
    with C.record_collective_sites() as log:
        C.matmul_psum_overlap(al, bl, group, chunks=4)
        C.ring_psum(t(xs[r]), group, chunks=2)
    meta["sites"] = [[s.site, s.axis, s.primitive, s.chunks, s.hops]
                     for s in log]
    meta["counts"] = C.collective_counts()
    return out, meta


RUNNERS = {"collectives": run_collectives}


def _runners():
    """The runners of the other TP test files and of the sequence and
    expert tests, imported on first use."""
    from tests import (torch_f6_cases, torch_onebit_cases,
                       torch_sp_moe_cases, torch_tp_cases)
    return dict(RUNNERS, **torch_tp_cases.RUNNERS,
                **torch_sp_moe_cases.RUNNERS, **torch_onebit_cases.RUNNERS,
                **torch_f6_cases.RUNNERS)


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    mesh.initialize_distributed(device="cpu")
    rank = mesh.dp_rank()
    try:
        runners = _runners()
        groups = {}
        for case in spec["cases"]:
            key = json.dumps(case.get("mesh") or {"model": None},
                             sort_keys=True)
            if key not in groups:
                groups[key] = mesh.MeshGroups(case.get("mesh") or {
                    "model": mesh.dp_world_size()},
                    in_process_pipe=bool(case.get("in_process_pipe")))
            res, meta = runners[case["kind"]](case, spec, groups[key])
            base = os.path.join(spec["out"], f"{case['name']}.{rank}")
            np.savez(base + ".npz", **res)
            with open(base + ".json", "w") as f:
                json.dump(meta, f)
    finally:
        gc.collect()
        mesh.destroy_distributed()


if __name__ == "__main__":
    main()
