"""Pipeline module: layer specs and stage partitioning (port of
``deepspeed_tpu/runtime/pipe/module.py``, the reference's
``PipelineModule`` / ``LayerSpec`` / ``TiedLayerSpec``).

A pipeline model is a sequence of layer specs; stages are assigned by the
same partitioning policies (``uniform`` / ``parameters`` / ``type:regex``)
with the shared ``partition_balanced`` math (``runtime/utils.py``).

Where the JAX package's spec builds an object with ``init(rng, x)`` and
``apply(params, x, rng)``, here ``LayerSpec.build()`` returns an
``nn.Module`` that holds its params: the pipeline
(``runtime/pipe/pipeline.py``) builds only the layers of the stages a
process runs, initializes each from a seed, and calls it. A layer whose
class sets ``pipe_context = True`` is called as ``layer(x, ctx=ctx)``
with the micro-batch's :class:`~deepspeed_tpu_torch.runtime.pipe.
pipeline.PipeContext` (its dropout seed and global layer index); any
other module as ``layer(x)``. A ``TiedLayerSpec``'s ``forward_fn`` is
called as ``forward_fn(module, x)``.
"""

import re
from typing import Any, Callable, List, Optional

from deepspeed_tpu_torch.runtime.utils import (partition_balanced,
                                               partition_uniform)
from deepspeed_tpu_torch.utils.logging import logger


class LayerSpec:
    """Deferred layer: builds lazily so only the owning stage materializes
    params (the reference's motivation at ``pipe/module.py:23``).

    ``typename`` is a factory (an ``nn.Module`` class) called with the
    spec's arguments; the module it returns holds the layer's params.
    """

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not callable(typename):
            raise RuntimeError("LayerSpec requires a callable typename")

    def build(self, log=False):
        if log:
            logger.info(f"building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self):
        name = getattr(self.typename, "__name__", str(self.typename))
        args = ", ".join(
            [repr(a) for a in self.module_args] +
            [f"{k}={v!r}" for k, v in self.module_kwargs.items()])
        return f"LayerSpec({name}, {args})"


class TiedLayerSpec(LayerSpec):
    """Layer whose parameters are shared with every other layer of the same
    ``key`` (reference ``pipe/module.py:71``). Each stage that uses the
    key holds its own copy; the pipeline sums their gradients across
    those stages after the backward, so the copies stay equal."""

    def __init__(self, key, typename, *module_args,
                 forward_fn=None, tied_weight_attr="embedding",
                 **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


class PipelineModule:
    """A model defined as a list of LayerSpecs partitioned into stages.

    Args mirror the reference (`pipe/module.py:85`): ``layers``,
    ``num_stages``, ``loss_fn``, ``partition_method``,
    ``activation_checkpoint_interval``, ``seed_layers``.
    """

    def __init__(self,
                 layers: List[Any],
                 num_stages: Optional[int] = None,
                 topology=None,
                 loss_fn: Optional[Callable] = None,
                 seed_layers: bool = False,
                 base_seed: int = 1234,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0,
                 example_input: Any = None,
                 auto_axes=()):
        self.specs = [
            spec if isinstance(spec, LayerSpec) else LayerSpec(spec)
            if callable(spec) else spec
            for spec in layers
        ]
        self.num_stages = num_stages
        self.topology = topology
        # loss_fn(output, micro_batch) -> (loss_sum, weight) or a scalar
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        # the JAX package's GSPMD-mode mesh axes (``parallel/pipe_auto.
        # py``): the port's engine raises for any (ROADMAP F2)
        self.auto_axes = tuple(auto_axes)
        # the JAX package infers param shapes from it; the port's modules
        # carry their own, so it is only recorded
        self.example_input = example_input
        self._partition = None

    def __len__(self):
        return len(self.specs)

    # -- partitioning (reference pipe/module.py:348 ``_partition_layers``) ---
    def partition_layers(self, num_stages=None, weights=None):
        """Compute stage boundaries: list of len num_stages+1.

        ``parameters``: balance by per-layer parameter count (caller provides
        ``weights``; falls back to uniform when absent).
        ``uniform``: balance by layer count.
        ``type:regex``: balance by count of layers whose class name matches.
        """
        num_stages = num_stages or self.num_stages
        assert num_stages, "num_stages required"
        method = (self.partition_method or "parameters").lower()

        if method == "uniform":
            parts = partition_uniform(len(self.specs), num_stages)
        elif method == "parameters":
            if weights is None:
                parts = partition_uniform(len(self.specs), num_stages)
            else:
                parts = partition_balanced(weights, num_stages)
        elif method.startswith("type:"):
            layertype = method.split(":", 1)[1]
            binary_weights = [0] * len(self.specs)
            for idx, spec in enumerate(self.specs):
                name = getattr(spec.typename, "__name__", "")
                if re.match(layertype, name, re.IGNORECASE):
                    binary_weights[idx] = 1
            parts = partition_balanced(binary_weights, num_stages)
        elif method == "profile":
            raise NotImplementedError("profile-based partitioning TBD")
        else:
            raise NotImplementedError(f"Partitioning method {method}")

        self._partition = parts
        return parts

    def stage_layers(self, stage_id, num_stages=None, weights=None):
        """Spec slice owned by ``stage_id``."""
        if self._partition is None:
            self.partition_layers(num_stages, weights)
        lo, hi = self._partition[stage_id], self._partition[stage_id + 1]
        return self.specs[lo:hi]

    def tied_keys(self):
        keys = []
        for spec in self.specs:
            if isinstance(spec, TiedLayerSpec) and spec.key not in keys:
                keys.append(spec.key)
        return keys
