"""A torch module as a pipeline body layer (port of
``deepspeed_tpu/parallel/pipe_auto.py``).

JAX's ``FlaxPipelineLayer`` lifts an unmodified flax module into the
1F1B body and hands its GSPMD partition metadata to the pipeline, with
the ``model`` axis left in GSPMD's auto mode (``PipelineModule(
auto_axes=("model",))``). Explicit TP has no auto mode: a layer holds
its shard and runs its collectives, as ``parallel/tensor_parallel.py``'s
layers do. :class:`TorchPipelineLayer` wraps such a module constructor:
the module is built with the model group the pipeline builds its stages
in (``parallel/pipe_tp.py:axis_scope``; passed as ``group=``),
and :meth:`TorchPipelineLayer.param_partition_specs` gives each param's
shard dim (``tensor_parallel.partition_specs``), the counterpart of
JAX's placement specs. The pipeline loads and gathers those leaves by
them.

Through the engine JAX refuses ``auto_axes`` with a
``NotImplementedError`` (``deepspeed_tpu/runtime/pipe/engine.py:
120-136``); the port's ``PipelineEngine`` raises the same error with the
same text. A module of wrapped layers without ``auto_axes`` runs through
the engine at any model size.
"""

import inspect

from torch import nn

from deepspeed_tpu_torch.parallel.pipe_tp import current_axis
from deepspeed_tpu_torch.parallel.tensor_parallel import partition_specs


class TorchPipelineLayer(nn.Module):
    """``module_ctor(*args, **kwargs)`` (given the current model group as
    ``group=`` when it takes one) as a pipeline layer: ``forward(x)`` is
    the module's."""

    def __init__(self, module_ctor, *args, **kwargs):
        super().__init__()
        takes = inspect.signature(module_ctor).parameters
        if "group" in takes and "group" not in kwargs:
            kwargs["group"] = current_axis("model")
        self.module = module_ctor(*args, **kwargs)

    def reset_parameters(self, generator=None):
        for mod in self.module.modules():
            reset = getattr(mod, "reset_parameters", None)
            if reset is not None:
                try:
                    reset(generator=generator)
                except TypeError:
                    reset()

    def param_partition_specs(self, params=None):
        """``{param name (under this layer): Shard or None}``."""
        return {f"module.{n}": s
                for n, s in partition_specs(self.module).items()}

    def forward(self, x):
        return self.module(x)
