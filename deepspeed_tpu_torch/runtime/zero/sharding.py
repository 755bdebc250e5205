"""ZeRO partitioning over the data-parallel ranks (port of
``deepspeed_tpu/runtime/zero/sharding.py``).

The JAX package declares ZeRO as shardings over the mesh's ``data`` axis
and lets XLA place the collectives; here each rank holds its pieces as
tensors and :mod:`~deepspeed_tpu_torch.runtime.zero.comm` moves them.
The partition is the JAX one, so rank r's piece holds what JAX device r's
shard holds:

- :func:`partition_dim` is ``zero_partition_spec``'s choice
  (``sharding.py:33-62``) over a plain shape: a leaf is split along its
  largest dimension that divides by the world size (the first of equal
  ones); a leaf with no such dimension stays replicated. At world 1 the
  JAX function shards nothing; the port makes the whole leaf one piece
  along dim 0, so the card runs the same collectives as at world N.
  The rule reads the leaf in the JAX package's layout: a module that
  stores a param transposed from it (``Dense.weight`` is ``[out, in]``,
  the flax kernel ``[in, out]``) names it in ``reference_transposed``,
  and the tie between equal dimensions breaks as it does in JAX.
- A piece is kept **contiguous** (K4 refuses strided leaves): the split
  dimension is moved to the front (``movedim``) and rank r takes rows
  ``[r*n, (r+1)*n)``. GPT-2's ``wte`` [50257, 1024] is split along dim 1
  at world 2, 4 or 8, so its piece is ``wte.T``'s rows, and a gather
  concatenates along the moved dimension and moves it back.
"""

import dataclasses

import torch


def partition_dim(shape, world):
    """The dimension a leaf of ``shape`` is split along over ``world``
    ranks, or None (replicated)."""
    shape = tuple(shape)
    if not shape:
        return None
    if world == 1:
        return 0
    best_dim, best_size = None, 0
    for dim, size in enumerate(shape):
        if size % world == 0 and size > best_size:
            best_dim, best_size = dim, size
    return best_dim


@dataclasses.dataclass(frozen=True)
class Partition:
    """One leaf's split over the ranks: ``dim`` None is replicated."""
    shape: tuple
    dim: object
    world: int
    rank: int

    @classmethod
    def of(cls, shape, world, rank, transposed=False):
        """The partition of a leaf of ``shape``; ``transposed``: the
        leaf's last two dimensions are swapped from the JAX package's (a
        2-D ``[out, in]`` weight, or a ``scan_layers`` stack of them)."""
        shape = tuple(shape)
        if transposed and len(shape) >= 2 and world > 1:
            n = len(shape)
            swap = list(range(n - 2)) + [n - 1, n - 2]
            d = partition_dim([shape[i] for i in swap], world)
            return cls(shape, None if d is None else swap[d], world, rank)
        return cls(shape, partition_dim(shape, world), world, rank)

    @property
    def sharded(self):
        return self.dim is not None

    @property
    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def moved_shape(self):
        """The leaf's shape with the split dimension first."""
        d = self.dim
        return (self.shape[d],) + self.shape[:d] + self.shape[d + 1:]

    @property
    def piece_shape(self):
        if not self.sharded:
            return self.shape
        moved = self.moved_shape
        return (moved[0] // self.world,) + moved[1:]

    def rank_major(self, full):
        """``full`` laid out so each rank's piece is contiguous and in
        rank order (the reduce-scatter's input; no copy when the split
        is along dim 0)."""
        return full.movedim(self.dim, 0).contiguous()

    def piece(self, full):
        """A new contiguous tensor holding this rank's piece of ``full``
        (the whole leaf, copied, when replicated)."""
        if not self.sharded:
            return full.detach().clone()
        n = self.piece_shape[0]
        rows = full.detach().movedim(self.dim, 0)[self.rank * n:
                                                  (self.rank + 1) * n]
        return rows.clone(memory_format=torch.contiguous_format)

    def from_gathered(self, flat):
        """The leaf from the all-gather of every rank's piece (a flat
        tensor of ``numel`` elements in rank order): a view, strided when
        the split is not along dim 0."""
        return flat.view(self.moved_shape).movedim(0, self.dim)


def is_transposed(module, name):
    """Whether ``module`` stores its param ``name`` transposed from the
    JAX package's layout."""
    return name in getattr(module, "reference_transposed", ())
