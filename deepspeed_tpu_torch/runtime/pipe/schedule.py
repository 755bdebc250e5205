"""Pipeline instruction schedules (a copy of
``deepspeed_tpu/runtime/pipe/schedule.py``, the reference's schedule ISA:
``TrainSchedule``, ``InferenceSchedule``, ``DataParallelSchedule`` and the
instruction classes).

Schedules are pure-Python generators of per-step instruction lists. The
JAX package compiles the whole batch into one XLA program and keeps these
streams as the specification of its order; the port executes them:
``runtime/pipe/pipeline.py`` interprets each stage's stream, one process
a stage rank or every stage of a data replica in one process, tick by
tick.

The 1F1B order comes from an explicit event simulation of the policy, so
its invariants (send before receive, forward before backward, buffer
bounds) follow from the simulation.
"""

from functools import lru_cache as _functools_lru_cache
from typing import List


class PipeSchedule:
    """Base class: yields lists of :class:`PipeInstruction` per step.

    Args mirror the reference (`schedule.py:33`): ``micro_batches`` (per
    train-batch micro-batches), ``stages`` (pipeline depth), ``stage_id``
    (which stage this schedule drives).
    """

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        assert stages > 0 and micro_batches > 0
        assert 0 <= stage_id < stages
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    def steps(self):
        raise NotImplementedError()

    def num_pipe_buffers(self):
        """Upper bound on concurrently-live activation buffers."""
        return self.micro_batches

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only wavefront: microbatch ``m`` runs on stage ``s`` at round
    ``m + s`` (reference `schedule.py:129`)."""

    def num_pipe_buffers(self):
        return 2  # double buffer: recv next while computing current

    def steps(self):
        total = self.micro_batches + self.stages - 1
        for round_id in range(total):
            cmds: List[PipeInstruction] = []
            m = round_id - self.stage_id
            if self._valid_micro_batch(m):
                buf = m % self.num_pipe_buffers()
                if self.is_first_stage or self.is_last_stage:
                    cmds.append(LoadMicroBatch(buf, stage_id=self.stage_id,
                                               micro_batch_id=m))
                if not self.is_first_stage:
                    cmds.append(RecvActivation(buf, stage_id=self.stage_id,
                                               micro_batch_id=m))
                cmds.append(ForwardPass(buf, stage_id=self.stage_id,
                                        micro_batch_id=m))
                if not self.is_last_stage:
                    cmds.append(SendActivation(buf, stage_id=self.stage_id,
                                               micro_batch_id=m))
            yield cmds


class TrainSchedule(PipeSchedule):
    """1F1B: warmup forwards, steady alternation, cooldown backwards, then
    gradient reduction and the optimizer step (reference `schedule.py:182`).
    """

    @staticmethod
    def buffers_for(micro_batches, stages, stage_id):
        """In-flight activations at stage s are bounded by the 1F1B depth
        remaining to the last stage (reference `schedule.py:243-247`)."""
        if micro_batches <= stages - stage_id:
            return micro_batches
        return stages - stage_id + 1

    def num_pipe_buffers(self):
        return self.buffers_for(self.micro_batches, self.stages,
                                self.stage_id)

    def _warmup(self, stage_id):
        """Forwards issued before the first backward under 1F1B."""
        return min(self.micro_batches, self.stages - stage_id)

    def _simulate(self):
        """Round-based event simulation of all stages; returns
        per-stage, per-round instruction lists. The simulation is
        stage-independent, so it's computed once per (M, S)."""
        return _simulate_rounds(self.micro_batches, self.stages)

    def steps(self):
        for round_cmds in self._simulate():
            yield list(round_cmds[self.stage_id])
        # epilogue: tied-weight reduction, DP gradient reduction, step
        yield [ReduceTiedGrads(stage_id=self.stage_id),
               ReduceGrads(stage_id=self.stage_id),
               OptimizerStep(stage_id=self.stage_id)]


@_functools_lru_cache(maxsize=128)
def _simulate_rounds(M, S):
    """Round-based event simulation of all S stages for M microbatches."""
    def warmup(s):
        return min(M, S - s)

    # Activations/gradients that have *arrived* and await consumption.
    acts_in = [list(range(M)) if s == 0 else [] for s in range(S)]
    grads_in = [[] for _ in range(S)]
    fwds_done = [0] * S
    bwds_done = [0] * S
    rounds = []  # rounds[r][s] -> [instructions]
    while any(b < M for b in bwds_done):
        round_cmds = [[] for _ in range(S)]
        # arrivals produced this round, delivered for the *next* round
        act_arrivals = []   # (stage, micro_batch)
        grad_arrivals = []
        for s in range(S):
            cmds = round_cmds[s]
            # 1F1B in-flight bound: at most warmup(s) forwards may be
            # outstanding (forwarded but not yet backwarded) — this is
            # what caps activation memory at the pipeline depth.
            in_flight = fwds_done[s] - bwds_done[s]
            fwd_ready = (bool(acts_in[s]) and fwds_done[s] < M
                         and in_flight < warmup(s))
            bwd_ready = bool(grads_in[s])
            # Once warmup forwards are in flight, prefer backward
            # whenever one is ready.
            do_bwd = bwd_ready and (fwds_done[s] >= warmup(s)
                                    or not fwd_ready)
            if do_bwd:
                m = grads_in[s].pop(0)
                buf = m % TrainSchedule.buffers_for(M, S, s)
                if s != S - 1:
                    cmds.append(RecvGrad(buf, stage_id=s,
                                         micro_batch_id=m))
                cmds.append(BackwardPass(buf, stage_id=s,
                                         micro_batch_id=m))
                if s != 0:
                    cmds.append(SendGrad(buf, stage_id=s,
                                         micro_batch_id=m))
                    grad_arrivals.append((s - 1, m))
                bwds_done[s] += 1
            elif fwd_ready:
                m = acts_in[s].pop(0)
                buf = m % TrainSchedule.buffers_for(M, S, s)
                if s == 0 or s == S - 1:
                    cmds.append(LoadMicroBatch(buf, stage_id=s,
                                               micro_batch_id=m))
                if s != 0:
                    cmds.append(RecvActivation(buf, stage_id=s,
                                               micro_batch_id=m))
                cmds.append(ForwardPass(buf, stage_id=s,
                                        micro_batch_id=m))
                if s != S - 1:
                    cmds.append(SendActivation(buf, stage_id=s,
                                               micro_batch_id=m))
                    act_arrivals.append((s + 1, m))
                else:
                    # Loss is local to the last stage: its backward is
                    # ready the round after its forward.
                    grad_arrivals.append((s, m))
                fwds_done[s] += 1
            # else: bubble
        for s, m in act_arrivals:
            acts_in[s].append(m)
        for s, m in grad_arrivals:
            grads_in[s].append(m)
        rounds.append(round_cmds)
    return rounds


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule: plain grad-accumulated DP training
    (reference `schedule.py:281`)."""

    def num_pipe_buffers(self):
        return 1

    def steps(self):
        for m in range(self.micro_batches):
            cmds = [LoadMicroBatch(0, stage_id=0, micro_batch_id=m),
                    ForwardPass(0, stage_id=0, micro_batch_id=m),
                    BackwardPass(0, stage_id=0, micro_batch_id=m)]
            if m == self.micro_batches - 1:
                cmds.extend([ReduceGrads(stage_id=0),
                             OptimizerStep(stage_id=0)])
            yield cmds


# ---------------------------------------------------------------------------
# Instruction ISA (reference `schedule.py:317-477`)
# ---------------------------------------------------------------------------
class PipeInstruction:
    """A step in the pipeline program; carries arbitrary kwargs
    (``stage_id``, ``micro_batch_id``...)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.kwargs.items())
        return f"{self.name}({args})"

    def __eq__(self, other):
        return (type(self) is type(other)) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Apply the optimizer at the end of the train batch."""


class ReduceGrads(PipeInstruction):
    """Reduce accumulated gradients over the data-parallel axis."""


class ReduceTiedGrads(PipeInstruction):
    """Reduce gradients of tied modules over the stages that share them."""


class BufferOpInstruction(PipeInstruction):
    """Instruction operating on a pipeline buffer slot."""

    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """Load micro-batch ``micro_batch_id`` into ``buffer_id`` (first stage
    loads inputs, last stage loads labels)."""


class ForwardPass(BufferOpInstruction):
    """Run the stage forward on ``buffer_id``."""


class BackwardPass(BufferOpInstruction):
    """Run the stage backward for ``buffer_id``."""


class SendActivation(BufferOpInstruction):
    """Send ``buffer_id`` activations to the next stage."""


class RecvActivation(BufferOpInstruction):
    """Receive activations for ``buffer_id`` from the previous stage."""


class SendGrad(BufferOpInstruction):
    """Send input-activation gradients for ``buffer_id`` upstream."""


class RecvGrad(BufferOpInstruction):
    """Receive output-activation gradients for ``buffer_id`` downstream."""
