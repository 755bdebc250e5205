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
    :func:`backend_for` gives ``device``: a CUDA engine never runs its
    collectives over gloo."""
    if not is_initialized():
        return
    want = backend_for(device)
    got = str(_dist().get_backend()).lower()
    if got != want:
        raise RuntimeError(
            f"deepspeed_tpu_torch: the process group runs {got!r}, but an "
            f"engine on {torch.device(device)} needs {want!r}")


def _init_method(address):
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda"):
    """Join the data-parallel process group (the reference's
    ``dist.init_process_group``; JAX ``mesh.py:26``).

    Defaults come from ``DS_TPU_COORDINATOR`` (``host:port``, or a
    ``tcp://`` / ``file://`` URL), ``DS_TPU_NUM_PROCESSES`` and
    ``DS_TPU_PROCESS_ID``. One process without them is a no-op (world
    1). ``device`` picks the backend (:func:`backend_for`); on CUDA the
    process's current device becomes ``cuda:LOCAL_RANK``. Returns the
    world size."""
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
    backend = backend_for(device)
    dist = _dist()
    kwargs = {}
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
    return dp_world_size()


def destroy_distributed():
    """Leave the process group (no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()


def dp_world_size():
    """Data-parallel world size: the group's, or 1 without one."""
    return _dist().get_world_size() if is_initialized() else 1


def dp_rank():
    """This process's data-parallel rank: the group's, or 0."""
    return _dist().get_rank() if is_initialized() else 0
