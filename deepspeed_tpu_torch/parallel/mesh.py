"""Process-group bootstrap (port of ``deepspeed_tpu/parallel/mesh.py``'s
``initialize_distributed``).

The JAX package joins its processes with ``jax.distributed.initialize``
and names the data-parallel group as the ``data`` axis of a mesh. Here
the group is a ``torch.distributed`` process group: one process per
device, every process a data-parallel rank.

- :func:`initialize_distributed` reads the launcher env the JAX package
  reads (``DS_TPU_COORDINATOR``, ``DS_TPU_NUM_PROCESSES``,
  ``DS_TPU_PROCESS_ID``) or explicit arguments, and raises the JAX
  package's partial-env errors.
- The backend follows the device: NCCL for ``cuda``, gloo only for
  ``cpu``. A CUDA engine without NCCL raises; it never falls back to
  gloo.
- A group that is already initialized is used as it is (its backend is
  checked against the device). One process without the env is world 1
  and needs no group.

On the card each rank runs on ``cuda:LOCAL_RANK`` (``LOCAL_RANK``
defaults to the process id modulo the visible devices).

The ``mesh`` config key (:func:`pipe_data_topology`) lays a pipeline
over the processes as ``pipe`` x ``data``: one process a stage rank, or
every stage of a data replica in one process. A mesh with a ``model``,
``seq`` or ``expert`` axis lays its processes out by
:class:`MeshGroups`.

**The model, seq and expert axes** (tensor, sequence and expert
parallelism). :class:`MeshGroups` lays the
processes over JAX's canonical axis order ``("data", "pipe", "expert",
"seq", "model")`` (``deepspeed_tpu/parallel/mesh.py:21``), ``model``
innermost: a process's coordinates are the C-order unravel of its rank
over the mesh shape, so the ranks of one model group are consecutive.
It builds one process group per axis line (every process builds every
group, in the same order, as ``torch.distributed.new_group`` needs) and
answers Megatron's ``mpu`` questions (``get_model_parallel_rank`` ...
``get_data_parallel_group``, and ``get_seq_parallel_*`` /
``get_expert_parallel_*`` for the other two axes): it is what
``initialize(mpu=...)`` takes. A pipeline with any of these axes runs
every stage of a (data, expert, seq, model) coordinate in one process
(``in_process_pipe``), or one process a stage rank over the whole mesh,
pipe outermost. Rows are sharded over ``data`` only: every rank of a
data replica's seq, expert and model groups gets that replica's rows
(JAX ``engine.py:2383-2409``, ``PartitionSpec(None, "data")``), and a
dense model's compute is replicated over ``seq`` and ``expert``.

**gloo on CUDA tensors.** A CUDA engine runs NCCL, with one exception:
when every rank of the group runs on one physical device (their CUDA
UUIDs agree), gloo is allowed, since NCCL refuses two ranks on one
device. That is how these axes run on one card: their collectives
go through gloo, which stages CUDA tensors through host memory for
``all_reduce``, ``broadcast`` and ``all_gather``; the others
(``parallel/collectives.py``) stage them explicitly. Ranks on several
devices with gloo raise.
"""

import os

import torch

ENV_COORDINATOR = "DS_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "DS_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "DS_TPU_PROCESS_ID"


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized():
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def backend_for(device):
    """The process-group backend for ``device``: ``nccl`` on CUDA (raises
    when this torch has no NCCL), ``gloo`` on the CPU."""
    device = torch.device(device)
    dist = _dist()
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "deepspeed_tpu_torch: a CUDA engine needs the NCCL backend, "
                "and this torch has none (gloo is used only on the CPU)")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def check_backend(device):
    """Raise unless the initialized group's backend is the one
    :func:`backend_for` gives ``device``: a CUDA engine runs gloo only
    when every rank of the group is on one physical device
    (:func:`ranks_share_one_device`)."""
    if not is_initialized():
        return
    device = torch.device(device)
    got = str(_dist().get_backend()).lower()
    if device.type == "cuda" and got == "gloo":
        if ranks_share_one_device(device):
            return
        raise RuntimeError(
            "deepspeed_tpu_torch: gloo runs a CUDA engine only when every "
            "rank is on one physical device (NCCL refuses two ranks on "
            "one device); these ranks are on several: use NCCL")
    want = backend_for(device)
    if got != want:
        raise RuntimeError(
            f"deepspeed_tpu_torch: the process group runs {got!r}, but an "
            f"engine on {device} needs {want!r}")


def device_uuid(device):
    """The CUDA device's UUID (a string), the physical card's name."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(torch.cuda.get_device_properties(device).uuid)


def ranks_share_one_device(device):
    """True iff every rank of the world group runs on the physical CUDA
    device this rank's ``device`` is (an ``all_gather_object`` of the
    UUIDs)."""
    dist = _dist()
    mine = device_uuid(device)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return all(u == mine for u in every)


def _init_method(address):
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda", backend=None):
    """Join the data-parallel process group (the reference's
    ``dist.init_process_group``; JAX ``mesh.py:26``).

    Defaults come from ``DS_TPU_COORDINATOR`` (``host:port``, or a
    ``tcp://`` / ``file://`` URL), ``DS_TPU_NUM_PROCESSES`` and
    ``DS_TPU_PROCESS_ID``. One process without them is a no-op (world
    1). ``device`` picks the backend (:func:`backend_for`) unless
    ``backend`` names one (``"gloo"`` on CUDA: every rank on one device,
    :func:`check_backend`); on CUDA the process's current device becomes
    ``cuda:LOCAL_RANK``. Returns the world size."""
    if is_initialized():
        check_backend(device)
        return dp_world_size()
    explicit_coordinator = coordinator_address is not None
    if coordinator_address is None:
        coordinator_address = os.environ.get(ENV_COORDINATOR)
    if num_processes is None and ENV_NUM_PROCESSES in os.environ:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])
    if not explicit_coordinator and num_processes in (None, 1):
        return 1
    if coordinator_address is None:
        raise RuntimeError(
            "DS_TPU_NUM_PROCESSES is set but DS_TPU_COORDINATOR is "
            "missing — partial launcher env")
    if num_processes is None:
        raise RuntimeError(
            "DS_TPU_COORDINATOR is set but DS_TPU_NUM_PROCESSES is "
            "missing — partial launcher env")
    if process_id is None:
        # the JAX package auto-detects it on TPU pods only; here never
        raise RuntimeError(
            "DS_TPU_NUM_PROCESSES is set but DS_TPU_PROCESS_ID is "
            "missing — partial launcher env (process_id only "
            "auto-detects on TPU pods)")
    backend = backend or backend_for(device)
    dist = _dist()
    kwargs = {}
    if torch.device(device).type == "cuda" and backend == "gloo":
        dev = torch.device(device)
        if dev.index is not None:
            torch.cuda.set_device(dev)
    if backend == "nccl":
        dev = torch.device(device)
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=int(num_processes),
        rank=int(process_id), **kwargs)
    check_backend(device)
    return dp_world_size()


def destroy_distributed():
    """Leave the process group in order (no-op without one): every rank
    first waits for the others at a barrier, so none tears its gloo
    pairs down while a peer still sends on them (a rank that exits under
    a live group can abort in the pair threads' destructors, "terminate
    called without an active exception")."""
    if is_initialized():
        dist = _dist()
        dist.barrier()
        dist.destroy_process_group()


def dp_world_size():
    """Data-parallel world size: the group's, or 1 without one."""
    return _dist().get_world_size() if is_initialized() else 1


def dp_rank():
    """This process's data-parallel rank: the group's, or 0."""
    return _dist().get_rank() if is_initialized() else 0


# the JAX package's canonical axis order (deepspeed_tpu/parallel/mesh.py:21)
MESH_AXES = ("data", "pipe", "expert", "seq", "model")

# the axes past pipe and data: a mesh with any of them above 1 lays its
# processes out by MeshGroups
INNER_AXES = ("expert", "seq", "model")


def check_mesh_axes(mesh_config):
    """Raise for a ``mesh`` key that is not a mesh axis."""
    cfg = dict(mesh_config or {})
    unknown = sorted(set(cfg) - set(MESH_AXES))
    if unknown:
        raise ValueError(f"mesh axes {unknown} are not mesh axes "
                         f"('data', 'pipe', 'expert', 'seq', 'model')")


def inner_size(mesh_config):
    """The product of the mesh's ``expert``, ``seq`` and ``model`` sizes."""
    cfg = dict(mesh_config or {})
    n = 1
    for axis in INNER_AXES:
        n *= int(cfg.get(axis) or 1)
    return n


def pipe_data_topology(mesh_config, world, stages=None, in_process=None):
    """``(pipe, data, in_process)`` of a pipeline over ``world``
    processes, from the ``mesh`` config (JAX ``normalize_mesh_shape``:
    unset axes are 1 and a ``data`` of None absorbs what is left).

    ``in_process`` picks the transport: True runs every stage of a data
    replica in one process (``world == data``), False one process a
    stage rank (``world == pipe * data``, ranks laid out by
    ``PipeDataParallelTopology``: rank = stage * data + replica). None
    decides from the mesh: a ``data`` that covers the world, or a world
    that ``pipe`` does not divide (one process included), runs in
    process. ``stages`` (``pipeline.stages`` or the module's) is the
    pipe size when the mesh names none, and must agree when it does."""
    check_mesh_axes(mesh_config)
    cfg = dict(mesh_config or {})
    if inner_size(cfg) > 1:
        raise ValueError("a mesh with a model, seq or expert axis lays its "
                         "processes out by MeshGroups (every stage of a "
                         "(data, expert, seq, model) coordinate in one "
                         "process), not pipe x data")
    pipe = cfg.get("pipe")
    if pipe is None:
        pipe = stages or 1
    elif stages is not None and int(stages) != int(pipe):
        raise ValueError(f"pipeline stages {stages} do not match the mesh "
                         f"pipe axis ({pipe})")
    pipe = int(pipe)
    data = cfg.get("data")
    if in_process is None:
        if data is not None:
            in_process = int(data) == world and pipe * int(data) != world
        else:
            in_process = world % pipe != 0 or world == 1
    if data is None:
        data = world if in_process else world // pipe
    data = int(data)
    want = data if in_process else pipe * data
    if want != world:
        raise ValueError(
            f"mesh {cfg} (pipe {pipe}, data {data}) does not cover "
            f"{world} processes ("
            f"{'all stages' if in_process else 'one stage'} a process)")
    return pipe, data, bool(in_process)


def normalize_mesh_shape(mesh_config, world):
    """``{axis: size}`` over every axis of :data:`MESH_AXES` for
    ``world`` processes (JAX ``normalize_mesh_shape``): unset axes are 1
    and a ``data`` of None absorbs what is left."""
    check_mesh_axes(mesh_config)
    cfg = dict(mesh_config or {})
    shape, denom = {}, 1
    for axis in MESH_AXES[1:]:
        shape[axis] = int(cfg.get(axis) or 1)
        denom *= shape[axis]
    if world % denom:
        raise ValueError(f"mesh axes {cfg} (product {denom}) do not divide "
                         f"{world} processes")
    data = cfg.get("data")
    data = world // denom if data is None else int(data)
    if data * denom != world:
        raise ValueError(f"mesh {cfg} with data={data} does not cover "
                         f"{world} processes")
    shape["data"] = data
    return {a: shape[a] for a in MESH_AXES}


def mesh_coords(rank, shape):
    """``{axis: index}`` of ``rank``: the C-order unravel over the shape in
    :data:`MESH_AXES` order (``model`` fastest)."""
    out, rest = {}, int(rank)
    for axis in reversed(MESH_AXES):
        out[axis] = rest % shape[axis]
        rest //= shape[axis]
    return {a: out[a] for a in MESH_AXES}


def mesh_rank(coords, shape):
    """The inverse of :func:`mesh_coords`."""
    r = 0
    for axis in MESH_AXES:
        r = r * shape[axis] + int(coords[axis])
    return r


class AxisGroup:
    """One mesh axis as this process sees it: its ``size``, this
    process's ``rank`` along it, the global ``ranks`` of the line in axis
    order and the process group over them (``pg``; None without a world
    group). Every collective of ``parallel/collectives.py`` takes one."""

    def __init__(self, name, size=1, rank=0, ranks=None, pg=None):
        self.name = name
        self.size = int(size)
        self.rank = int(rank)
        self.ranks = list(ranks) if ranks is not None else [0]
        self.pg = pg

    @property
    def active(self):
        """Collectives run (more than one rank on the axis)."""
        return self.size > 1 and self.pg is not None

    def __repr__(self):
        return (f"AxisGroup({self.name!r}, size={self.size}, "
                f"rank={self.rank})")


class MeshGroups:
    """The process groups of a mesh over the world (module docstring):
    the port's Megatron ``mpu``. ``mesh_config`` is the ``mesh`` config
    key; ``in_process_pipe`` lays the processes over ``data`` x
    ``model`` only (every pipeline stage of a coordinate in one
    process). Without a process group it is world 1: every axis of size
    1, no collectives."""

    def __init__(self, mesh_config=None, in_process_pipe=False):
        cfg = dict(mesh_config or {})
        world, rank = dp_world_size(), dp_rank()
        if in_process_pipe:
            cfg = {k: v for k, v in cfg.items() if k != "pipe"}
        self.shape = normalize_mesh_shape(cfg, world)
        self.coords = mesh_coords(rank, self.shape)
        self.world, self.global_rank = world, rank
        self.axes = {}
        dist = _dist() if is_initialized() else None
        for axis in MESH_AXES:
            mine = None
            others = [a for a in MESH_AXES if a != axis]
            lines = {}
            for r in range(world):
                c = mesh_coords(r, self.shape)
                lines.setdefault(tuple(c[a] for a in others), []).append(r)
            # the engine's collectives run over data and model groups of
            # any size (a group of one issues them and changes nothing)
            build = dist is not None and (
                axis in ("data", "model") or self.shape[axis] > 1)
            for key in sorted(lines):
                ranks = lines[key]
                pg = dist.new_group(ranks) if build else None
                if rank in ranks:
                    mine = AxisGroup(axis, len(ranks), ranks.index(rank),
                                     ranks, pg)
            self.axes[axis] = mine

    def axis(self, name):
        return self.axes[name]

    # -- Megatron's mpu (deepspeed_tpu/__init__.py:34,69,83) --------------
    def get_model_parallel_rank(self):
        return self.axes["model"].rank

    def get_model_parallel_world_size(self):
        return self.axes["model"].size

    def get_model_parallel_group(self):
        return self.axes["model"].pg

    def get_data_parallel_rank(self):
        return self.axes["data"].rank

    def get_data_parallel_world_size(self):
        return self.axes["data"].size

    def get_data_parallel_group(self):
        return self.axes["data"].pg

    def get_pipe_parallel_rank(self):
        return self.axes["pipe"].rank

    def get_pipe_parallel_world_size(self):
        return self.axes["pipe"].size

    def get_pipe_parallel_group(self):
        return self.axes["pipe"].pg

    def get_seq_parallel_rank(self):
        return self.axes["seq"].rank

    def get_seq_parallel_world_size(self):
        return self.axes["seq"].size

    def get_seq_parallel_group(self):
        return self.axes["seq"].pg

    def get_expert_parallel_rank(self):
        return self.axes["expert"].rank

    def get_expert_parallel_world_size(self):
        return self.axes["expert"].size

    def get_expert_parallel_group(self):
        return self.axes["expert"].pg


def _axis_of(mpu, name, kind):
    """The ``kind`` ("model", "data", "seq" or "expert") :class:`AxisGroup`
    of an ``mpu``: a :class:`MeshGroups`, or any object with Megatron's
    ``get_<kind>_parallel_*`` accessors (an ``mpu`` without the seq or
    expert ones has one rank there; one without the model or data ones
    raises); no ``mpu`` is one rank."""
    if mpu is None:
        return AxisGroup(name)
    if isinstance(mpu, MeshGroups):
        return mpu.axis(name)
    if (kind in ("seq", "expert")
            and not hasattr(mpu, f"get_{kind}_parallel_world_size")):
        return AxisGroup(name)
    pg = getattr(mpu, f"get_{kind}_parallel_group")()
    size = int(getattr(mpu, f"get_{kind}_parallel_world_size")())
    ranks = None
    if pg is not None and is_initialized():
        dist = _dist()
        ranks = [dist.get_global_rank(pg, i) for i in range(size)]
    return AxisGroup(name, size, getattr(mpu, f"get_{kind}_parallel_rank")(),
                     ranks, pg)


def model_axis_of(mpu):
    """The model :class:`AxisGroup` of an ``mpu`` (:func:`_axis_of`)."""
    return _axis_of(mpu, "model", "model")


def data_axis_of(mpu):
    """The data :class:`AxisGroup` of an ``mpu`` (:func:`_axis_of`)."""
    return _axis_of(mpu, "data", "data")


def seq_axis_of(mpu):
    """The seq :class:`AxisGroup` of an ``mpu`` (:func:`_axis_of`)."""
    return _axis_of(mpu, "seq", "seq")


def expert_axis_of(mpu):
    """The expert :class:`AxisGroup` of an ``mpu`` (:func:`_axis_of`)."""
    return _axis_of(mpu, "expert", "expert")
