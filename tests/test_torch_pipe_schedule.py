"""The pipeline's copied host modules against the JAX package's: the
instruction schedules (their streams equal JAX's instruction for
instruction, and they hold the assertions of ``tests/unit/
test_pipe_schedule.py``), the topology and grid, the partitioning math,
``PipelineModule``'s partitions, and the port's ``pipe`` x ``data``
layout of the ``mesh`` key. No devices, no spawned processes."""

import numpy as np
import pytest

from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.pipe import schedule as J
from deepspeed_tpu.runtime.pipe import topology as JT
from deepspeed_tpu_torch.parallel import mesh
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.pipe import schedule as S
from deepspeed_tpu_torch.runtime.pipe import topology as TT


def _flat(sched):
    return [cmd for step in sched for cmd in step]


def _as_tuples(steps):
    return [[(type(c).__name__, tuple(sorted(c.kwargs.items())))
             for c in step] for step in steps]


@pytest.mark.parametrize("kind", ["TrainSchedule", "InferenceSchedule",
                                  "DataParallelSchedule"])
@pytest.mark.parametrize("micro", [1, 4, 6])
@pytest.mark.parametrize("stages", [1, 2, 4])
def test_streams_equal_jax(kind, micro, stages):
    if kind == "DataParallelSchedule" and stages != 1:
        stages = 1
    for sid in range(stages):
        port = getattr(S, kind)(micro, stages, sid)
        ref = getattr(J, kind)(micro, stages, sid)
        assert _as_tuples(port.steps()) == _as_tuples(ref.steps())
        assert port.num_pipe_buffers() == ref.num_pipe_buffers()


# --- the assertions of tests/unit/test_pipe_schedule.py, on the copy ------

@pytest.mark.parametrize("micro,stages", [(1, 1), (4, 1), (1, 4), (4, 4),
                                          (8, 4), (3, 5), (16, 2)])
def test_train_schedule_covers_all_microbatches(micro, stages):
    for sid in range(stages):
        cmds = _flat(S.TrainSchedule(micro, stages, sid))
        fwd = [c.micro_batch_id for c in cmds if isinstance(c, S.ForwardPass)]
        bwd = [c.micro_batch_id for c in cmds
               if isinstance(c, S.BackwardPass)]
        assert sorted(fwd) == list(range(micro))
        assert sorted(bwd) == list(range(micro))


@pytest.mark.parametrize("micro,stages", [(4, 4), (8, 4), (3, 5), (16, 2)])
def test_train_schedule_forward_before_backward(micro, stages):
    for sid in range(stages):
        seen_fwd = set()
        for step in S.TrainSchedule(micro, stages, sid):
            for cmd in step:
                if isinstance(cmd, S.ForwardPass):
                    seen_fwd.add(cmd.micro_batch_id)
                if isinstance(cmd, S.BackwardPass):
                    assert cmd.micro_batch_id in seen_fwd


@pytest.mark.parametrize("micro,stages", [(4, 4), (8, 4), (3, 5)])
def test_train_schedule_sends_precede_recvs(micro, stages):
    per_stage = [list(S.TrainSchedule(micro, stages, sid).steps())
                 for sid in range(stages)]

    def round_of(sid, klass, mb):
        for r, step in enumerate(per_stage[sid]):
            for cmd in step:
                if isinstance(cmd, klass) and \
                        getattr(cmd, "micro_batch_id", None) == mb:
                    return r
        return None

    for sid in range(1, stages):
        for mb in range(micro):
            assert round_of(sid - 1, S.SendActivation, mb) < \
                round_of(sid, S.RecvActivation, mb)
    for sid in range(stages - 1):
        for mb in range(micro):
            assert round_of(sid + 1, S.SendGrad, mb) < \
                round_of(sid, S.RecvGrad, mb)


@pytest.mark.parametrize("micro,stages", [(2, 2), (8, 4), (3, 5)])
def test_train_schedule_buffer_bounds(micro, stages):
    for sid in range(stages):
        sched = S.TrainSchedule(micro, stages, sid)
        expected = micro if micro <= stages - sid else stages - sid + 1
        assert sched.num_pipe_buffers() == expected
        for cmd in _flat(sched):
            if hasattr(cmd, "buffer_id"):
                assert 0 <= cmd.buffer_id < sched.num_pipe_buffers()


def test_train_schedule_epilogue_and_steady_state():
    names = [type(c).__name__ for c in _flat(S.TrainSchedule(4, 2, 0))[-3:]]
    assert names == ["ReduceTiedGrads", "ReduceGrads", "OptimizerStep"]
    live = peak = 0
    for step in S.TrainSchedule(8, 4, 0):
        for cmd in step:
            live += isinstance(cmd, S.ForwardPass)
            live -= isinstance(cmd, S.BackwardPass)
            peak = max(peak, live)
    assert peak <= 4 + 1


@pytest.mark.parametrize("micro,stages", [(1, 1), (4, 2), (6, 3)])
def test_inference_schedule_wavefront(micro, stages):
    for sid in range(stages):
        steps = list(S.InferenceSchedule(micro, stages, sid).steps())
        assert len(steps) == micro + stages - 1
        for r, step in enumerate(steps):
            fwd = [c for c in step if isinstance(c, S.ForwardPass)]
            if fwd:
                assert fwd[0].micro_batch_id == r - sid
    for sid, expect_load in [(0, True), (1, False), (2, True)]:
        cmds = _flat(S.InferenceSchedule(4, 3, sid))
        assert any(isinstance(c, S.LoadMicroBatch) for c in cmds) == \
            expect_load


def test_data_parallel_schedule_and_instructions():
    sched = S.DataParallelSchedule(micro_batches=3, stages=1, stage_id=0)
    steps = list(sched.steps())
    assert len(steps) == 3 and sched.num_pipe_buffers() == 1
    assert any(isinstance(c, S.OptimizerStep) for c in steps[-1])
    a = S.ForwardPass(1, stage_id=0, micro_batch_id=3)
    assert a == S.ForwardPass(1, stage_id=0, micro_batch_id=3)
    assert a != S.ForwardPass(2, stage_id=0, micro_batch_id=3)
    assert "micro_batch_id=3" in repr(a)


# --- topology, grid, partitions -------------------------------------------

@pytest.mark.parametrize("pipe,data", [(1, 4), (2, 2), (4, 1), (2, 3)])
def test_topology_and_grid_equal_jax(pipe, data):
    port = TT.PipeDataParallelTopology(pipe, data)
    ref = JT.PipeDataParallelTopology(pipe, data)
    assert {tuple(k): v for k, v in port.mapping.items()} == \
        {tuple(k): v for k, v in ref.mapping.items()}
    for axis in ("pipe", "data"):
        assert port.get_axis_comm_lists(axis) == \
            ref.get_axis_comm_lists(axis)
    for rank in range(pipe * data):
        g, j = TT.PipelineParallelGrid(port, rank=rank), \
            JT.PipelineParallelGrid(ref, rank=rank)
        assert (g.stage_id, g.data_parallel_id, g.p2p_groups,
                g.dp_groups, g.pp_groups, g.mesh_shape()) == \
            (j.stage_id, j.data_parallel_id, j.p2p_groups, j.dp_groups,
             j.pp_groups, j.mesh_shape())
        if pipe > 1:
            assert g.stage_to_global(0) == j.stage_to_global(0)
    m = TT.PipeModelDataParallelTopology(2, 2, 2)
    assert m.get_rank_repr(5) == JT.PipeModelDataParallelTopology(
        2, 2, 2).get_rank_repr(5)


@pytest.mark.parametrize("seed", range(6))
def test_partitions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    weights = rng.integers(0, 50, rng.integers(1, 30)).tolist()
    for parts in (1, 2, 3, 4, 7):
        assert tutils.partition_balanced(weights, parts) == \
            jutils.partition_balanced(weights, parts)
        assert tutils.partition_uniform(len(weights), parts) == \
            jutils.partition_uniform(len(weights), parts)


def test_pipeline_module_partitions_equal_jax():
    from deepspeed_tpu.models.gpt2 import GPT2Config
    from deepspeed_tpu.models.gpt2_pipe import (
        gpt2_pipeline_module as jax_module)
    from deepspeed_tpu_torch.models.gpt2 import gpt2_tiny
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipeline_module
    port = gpt2_pipeline_module(gpt2_tiny(n_layer=6))
    ref = jax_module(GPT2Config(vocab_size=64, n_positions=16, n_embd=32,
                                n_layer=6, n_head=4))
    for method in ("uniform", "parameters", "type:GPT2BlockLayer"):
        port.partition_method = ref.partition_method = method
        port._partition = ref._partition = None
        for n in (1, 2, 3, 4):
            assert port.partition_layers(n) == ref.partition_layers(n)
    assert port.tied_keys() == ref.tied_keys() == ["embed"]
    assert [s.typename.__name__ for s in port.stage_layers(0, 3)] == \
        [s.typename.__name__ for s in ref.stage_layers(0, 3)]


@pytest.mark.parametrize("cfg,world,want", [
    ({"pipe": 4}, 1, (4, 1, True)), ({"pipe": 2}, 2, (2, 1, False)),
    ({"pipe": 2}, 4, (2, 2, False)), ({"pipe": 2, "data": 2}, 2,
                                       (2, 2, True)),
    ({"pipe": 2, "data": 2}, 4, (2, 2, False)), (None, 1, (1, 1, True))])
def test_mesh_lays_out_pipe_by_data(cfg, world, want):
    assert mesh.pipe_data_topology(cfg, world) == want


@pytest.mark.parametrize("axis", ["seq", "expert"])
def test_mesh_axes_past_pipe_and_data_lay_out_by_mesh_groups(axis):
    """A seq or expert axis lays its processes out by MeshGroups in JAX's
    axis order (data, pipe, expert, seq, model), not pipe x data: 8
    processes at pipe 2 x axis 2 leave data 2, the axis's ranks
    consecutive (model 1 innermost), the pipe axis outermost but data;
    in a pipeline every stage of a coordinate runs in one process
    (``in_process_pipe``: pipe leaves the shape)."""
    with pytest.raises(ValueError, match="lays its processes out by "
                                         "MeshGroups"):
        mesh.pipe_data_topology({"pipe": 2, axis: 2}, 4)
    with pytest.raises(ValueError, match="does not cover"):
        mesh.pipe_data_topology({"pipe": 2, "data": 3}, 4)
    shape = mesh.normalize_mesh_shape({"pipe": 2, axis: 2}, 8)
    assert shape == {"data": 2, "pipe": 2, "expert": 1, "seq": 1,
                     "model": 1, axis: 2}
    coords = [mesh.mesh_coords(r, shape) for r in range(8)]
    assert [c[axis] for c in coords] == [0, 1] * 4
    assert [c["pipe"] for c in coords] == [0, 0, 1, 1] * 2
    assert [c["data"] for c in coords] == [0] * 4 + [1] * 4
    assert all(mesh.mesh_rank(c, shape) == r for r, c in enumerate(coords))
    assert mesh.inner_size({"pipe": 2, axis: 2, "model": 2}) == 4
    # every stage of a coordinate in one process: 4 processes, data 2
    assert mesh.normalize_mesh_shape({axis: 2}, 4)["data"] == 2


@pytest.mark.parametrize("shape,world,want", [
    ({"model": 2}, 4, {"data": 2, "model": 2}),
    ({"data": 2, "model": 2}, 4, {"data": 2, "model": 2}),
    ({"model": 4}, 4, {"data": 1, "model": 4}),
    ({"pipe": 2, "model": 2}, 8, {"data": 2, "pipe": 2, "model": 2})])
def test_mesh_model_axis_is_innermost(shape, world, want):
    """The model axis (ported, PR 14) takes JAX's canonical order: a
    rank's coordinates are its C-order unravel, ``model`` fastest."""
    full = mesh.normalize_mesh_shape(shape, world)
    assert {a: n for a, n in full.items() if n > 1 or a == "data"} == want
    model = full["model"]
    for r in range(world):
        assert mesh.mesh_coords(r, full)["model"] == r % model
    with pytest.raises(ValueError, match="does not cover"):
        mesh.normalize_mesh_shape({"model": 2, "data": 3}, 4)
    with pytest.raises(ValueError, match="lays its processes out by "
                                         "MeshGroups"):
        mesh.pipe_data_topology(dict(shape, pipe=2), world)
