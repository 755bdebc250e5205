"""N-D process topology for hybrid parallelism (a copy of
``deepspeed_tpu/runtime/pipe/topology.py``: ``ProcessTopology``,
``PipeDataParallelTopology``, ``PipeModelDataParallelTopology`` and
``PipelineParallelGrid``, the reference's ``runtime/pipe/topology.py``).

Axes are named; ranks map to coordinates in row-major (last axis
fastest) order. The JAX package turns a topology into its mesh axes;
the port also turns it into ``torch.distributed`` groups:
``PipelineParallelGrid(..., process_groups=True)`` builds each stage's
data group, each data replica's pipe group, the tied group (the first
and last stage of a pipe group) and the stage-to-stage pairs (every
process calls ``new_group`` for every group, in the same order).
"""

import itertools
from collections import namedtuple

# the JAX package's canonical mesh axis order (``parallel/mesh.py``)
MESH_AXES = ("data", "pipe", "expert", "seq", "model")


class ProcessTopology:
    """Cartesian product of named axes ↔ global ranks.

    ``axes`` orders dimensions outermost-first; ``dims`` gives their sizes.
    """

    def __init__(self, axes, dims):
        assert len(axes) == len(dims)
        self.axes = list(axes)
        self.dims = list(int(d) for d in dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping = {}
        for rank, coord in enumerate(itertools.product(
                *[range(d) for d in self.dims])):
            self.mapping[self.ProcessCoord(*coord)] = rank

    def get_rank(self, **coord_kwargs):
        """Global rank of the process at the given full coordinate."""
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"get_rank() needs all axes {self.axes}, "
                             f"got {sorted(coord_kwargs)}")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, f"coord {key} not in topology"
        return self.mapping[key]

    def get_axis_names(self):
        return list(self.axes)

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"),
                      inner_sep="_", outer_sep="-"):
        """String like ``model_00`` used in checkpoint filenames (reference
        `topology.py:80`): all axes except the omitted ones."""
        omit = set(omit_axes)
        coord = self.get_coord(rank)
        parts = [f"{axis}{inner_sep}{getattr(coord, axis):02d}"
                 for axis in self.axes if axis not in omit]
        return outer_sep.join(parts)

    def get_dim(self, axis):
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def get_coord(self, rank):
        for coord, r in self.mapping.items():
            if r == rank:
                return coord
        raise ValueError(f"rank {rank} not in topology")

    def get_axis_comm_lists(self, axis):
        """Groups of ranks that vary only along ``axis`` — the communicator
        building-block (reference `topology.py:107`)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for combo in itertools.product(
                *[range(self.get_dim(a)) for a in other_axes]):
            fixed = dict(zip(other_axes, combo))
            ranks = [self.get_rank(**{axis: i, **fixed})
                     for i in range(self.get_dim(axis))]
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs):
        """Ranks whose coordinates match all given axis=value filters."""
        def matches(coord):
            return all(getattr(coord, k) == v
                       for k, v in filter_kwargs.items())
        return sorted(r for c, r in self.mapping.items() if matches(c))

    def get_axis_list(self, axis, idx):
        """Ranks with coordinate ``idx`` along ``axis``."""
        return sorted(r for c, r in self.mapping.items()
                      if getattr(c, axis) == idx)

    def world_size(self):
        n = 1
        for d in self.dims:
            n *= d
        return n

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """pipe × data hybrid (reference `topology.py:236`): pipe outermost so a
    dp group's ranks are neighbours."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """pipe × data × model 3-D hybrid (reference `topology.py:246`)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Rank bookkeeping over a topology: stage ids, per-axis group ranks,
    stage-to-stage neighbors (reference ``PipelineParallelGrid``,
    `topology.py:252`). ``rank`` defaults to 0 (single-controller JAX hosts
    drive all ranks; per-rank views exist for parity and multi-host).
    The port's engine passes its process's rank."""

    def __init__(self, topology=None, rank=0, world_size=None,
                 process_groups=False):
        if topology is None:
            assert world_size is not None, "topology or world_size required"
            topology = PipeDataParallelTopology(num_pp=1, num_dp=world_size)
        self._topo = topology
        self.global_rank = rank
        self.world_size = topology.world_size()

        self.data_parallel_size = max(topology.get_dim("data"), 1)
        self.pipe_parallel_size = max(topology.get_dim("pipe"), 1)
        self.model_parallel_size = max(topology.get_dim("model"), 1)
        assert self.world_size == (self.data_parallel_size *
                                   self.pipe_parallel_size *
                                   self.model_parallel_size)

        self.stage_id = self.get_stage_id()
        self.data_parallel_id = self.get_data_parallel_id()

        # group rank-lists per axis (the reference builds dist groups
        # here; the port builds them in _build_p2p_groups when asked)
        self.dp_groups = topology.get_axis_comm_lists("data")
        self.pp_groups = topology.get_axis_comm_lists("pipe")
        self.mp_groups = (topology.get_axis_comm_lists("model")
                          if "model" in topology.get_axis_names() else [])

        # p2p: successor/predecessor stage for this rank's pipe group
        self.dp_process_group = self.pp_process_group = None
        self.tied_process_group = None
        self.p2p_process_groups = {}
        self.p2p_groups = self._build_p2p_groups(process_groups)

    def get_stage_id(self):
        if "pipe" not in self._topo.get_axis_names():
            return 0
        return getattr(self._topo.get_coord(self.global_rank), "pipe")

    def get_data_parallel_id(self):
        if "data" not in self._topo.get_axis_names():
            return 0
        return getattr(self._topo.get_coord(self.global_rank), "data")

    def _build_p2p_groups(self, process_groups=False):
        """Consecutive stage pairs within each pipe group (reference
        ``topology.py:299``: the 2-rank groups p2p.py sends through). With
        ``process_groups`` (a ``torch.distributed`` world of this
        topology's size is up) also builds this rank's data, pipe and
        tied groups and a group for every pair, keyed ``(lo, hi)``."""
        pairs = []
        for ranks in self.pp_groups:
            for i in range(len(ranks)):
                pairs.append([ranks[i], ranks[(i + 1) % len(ranks)]])
        if process_groups:
            import torch.distributed as dist
            me = self.global_rank
            for ranks in self.dp_groups:
                g = dist.new_group(ranks)
                if me in ranks:
                    self.dp_process_group = g
            for ranks in self.pp_groups:
                g = dist.new_group(ranks)
                if me in ranks:
                    self.pp_process_group = g
            if self.pipe_parallel_size > 1:
                for ranks in self.pp_groups:
                    tied = [ranks[0], ranks[-1]]
                    g = dist.new_group(tied)
                    if me in tied:
                        self.tied_process_group = g
            for key in sorted({tuple(sorted(p)) for p in pairs
                               if p[0] != p[1]}):
                g = dist.new_group(list(key))
                if me in key:
                    self.p2p_process_groups[key] = g
        return pairs

    # --- stage neighbors -------------------------------------------------
    def stage_to_global(self, stage_id, **kwargs):
        """Global rank of ``stage_id`` holding all other coords equal."""
        coord = self._topo.get_coord(self.global_rank)
        me = coord._asdict()
        me.update(kwargs)
        me["pipe"] = stage_id
        return self._topo.get_rank(**me)

    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self.pipe_parallel_size - 1

    # --- reference-parity accessors --------------------------------------
    def get_global_rank(self):
        return self.global_rank

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_data_parallel_rank(self):
        return self.data_parallel_id

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_model_parallel_rank(self):
        if "model" not in self._topo.get_axis_names():
            return 0
        return getattr(self._topo.get_coord(self.global_rank), "model")

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    # --- mesh bridge ------------------------------------------------------
    def mesh_shape(self):
        """{axis: size} dict in canonical mesh-axis order (the JAX
        package's ``build_mesh`` input)."""
        shape = {axis: 1 for axis in MESH_AXES}
        for axis in self._topo.get_axis_names():
            if axis in shape:
                shape[axis] = self._topo.get_dim(axis)
        return shape
