"""Block-sparsity layout configurations (a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, which imports
no JAX: the same classes, arguments, errors and layouts).

Capability parity with the reference's `deepspeed/ops/sparse_attention/
sparsity_config.py:9-663` (SparsityConfig + Dense/Fixed/Variable/BigBird/
BSLongformer):

- layouts are NumPy ``int64`` arrays ``[num_heads, nb, nb]`` (nb = seq_len //
  block) built with vectorized index math instead of per-cell loops;
- random patterns (Variable/BigBird) draw from a seeded ``np.random.Generator``
  so layouts are reproducible across hosts and equal the JAX package's;
- the same layout tensor drives the CUDA block-sparse kernels, the gather
  route and the masked-dense oracle (`block_sparse_attention.py`).
"""

import numpy as np


class SparsityConfig:
    """Base class: shared properties of block-sparse attention patterns
    (reference `sparsity_config.py:9`)."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        """Zero layout ``[num_heads, nb, nb]``; seq_len must divide block."""
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence Length, {seq_len}, needs to be dividable by "
                f"Block size {self.block}!")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        """Share head 0's layout with all heads unless per-head layouts were
        requested (reference `sparsity_config.py:48`)."""
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks present — the dense pattern kept for comparison
    (reference `sparsity_config.py:63`)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _check_attention(attention, horizontal_global_attention):
    if attention not in ("unidirectional", "bidirectional"):
        raise NotImplementedError(
            'only "uni/bi-directional" attentions are supported for now!')
    if attention != "bidirectional" and horizontal_global_attention:
        raise ValueError(
            'only "bi-directional" attentions can support horizontal global '
            'attention!')


def _local_window(layout, h, start, end, attention):
    """Mark the dense window [start, end); unidirectional keeps the lower
    triangle only."""
    rows = np.arange(start, end)
    if attention == "unidirectional":
        r, c = np.meshgrid(rows, rows, indexing="ij")
        layout[h][np.ix_(rows, rows)] |= (c <= r).astype(np.int64)
    else:
        layout[h][np.ix_(rows, rows)] = 1


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern from "Generative Modeling with Sparse Transformers"
    (arXiv:1904.10509), as customized by the reference
    (`sparsity_config.py:94`): dense local windows of ``num_local_blocks``
    plus vertical (and optionally horizontal) global stripes anchored at
    each window's representative block(s)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_local_blocks=4,
                 num_global_blocks=1,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"Number of blocks in a local window, {num_local_blocks}, "
                f"must be dividable by number of global blocks, "
                f"{num_global_blocks}!")
        _check_attention(attention, horizontal_global_attention)
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "Number of different layouts cannot be more than one when "
                "you have set a single layout for all heads! Set "
                "different_layout_per_head to True.")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"Number of layout versions (num_different_global_patterns), "
                f"{num_different_global_patterns}, cannot be larger than "
                f"number of local window blocks divided by number of global "
                f"blocks, {num_local_blocks // num_global_blocks}!")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        for i in range(0, nb, self.num_local_blocks):
            _local_window(layout, h, i, min(i + self.num_local_blocks, nb),
                          self.attention)
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        g = self.num_global_blocks
        # Representative blocks count back from the end of each window; with
        # per-head patterns head h uses the (h mod P)-th from the back.
        first = self.num_local_blocks - \
            (1 + h % self.num_different_global_patterns) * g
        end = nb - (nb % self.num_local_blocks)
        for i in range(first, end, self.num_local_blocks):
            first_row = 0 if self.attention == "bidirectional" else i
            layout[h, first_row:, i:i + g] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + g, :] = 1
        if end < nb:  # short trailing window
            start = min(end + first, nb - g)
            first_row = 0 if self.attention == "bidirectional" else start
            layout[h, first_row:, start:start + g] = 1
            if self.horizontal_global_attention:
                layout[h, start:start + g, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed-style pattern with user-controlled knobs (reference
    `sparsity_config.py:243`): per-row random blocks, a list of local window
    sizes (last one repeats), and explicit global block indices/ranges."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=0,
                 local_window_blocks=None,
                 global_block_indices=None,
                 global_block_end_indices=None,
                 attention="bidirectional",
                 horizontal_global_attention=False,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        _check_attention(attention, horizontal_global_attention)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = list(local_window_blocks or [4])
        self.global_block_indices = list(global_block_indices or [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, "
                    f"{len(self.global_block_indices)}, must be same as "
                    f"global block end indices length, "
                    f"{len(global_block_end_indices)}!")
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be "
                        f"smaller than global block end index, {end_idx}!")
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def set_random_layout(self, h, layout):
        _random_layout(layout, h, self.num_random_blocks, self.seed)
        return layout

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        start = 0
        for size in self.local_window_blocks:
            end = min(start + size, nb)
            _local_window(layout, h, start, end, self.attention)
            start += size
        # remaining rows reuse the last window size
        size = self.local_window_blocks[-1]
        for i in range(start, nb, size):
            _local_window(layout, h, i, min(i + size, nb), self.attention)
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start_idx, end_idx in spans:
            if start_idx >= nb:
                continue
            end_idx = min(end_idx, nb)
            if self.horizontal_global_attention:
                layout[h, start_idx:end_idx, :] = 1
            first_row = 0 if self.attention == "bidirectional" else start_idx
            layout[h, first_row:, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


def _random_layout(layout, h, num_random_blocks, seed):
    """Per-row random blocks from a (seed, head)-keyed Generator — same for
    all hosts, unlike the reference's global ``random`` module."""
    nb = layout.shape[1]
    if nb < num_random_blocks:
        raise ValueError(
            f"Number of random blocks, {num_random_blocks}, must be "
            f"smaller than overal number of blocks in a row, {nb}!")
    rng = np.random.default_rng((seed, h))
    for row in range(nb):
        cols = rng.choice(nb, size=num_random_blocks, replace=False)
        layout[h, row, cols] = 1


def _sliding_window(layout, h, num_window_blocks):
    """Symmetric sliding window of ``num_window_blocks`` around the diagonal."""
    nb = layout.shape[1]
    if nb < num_window_blocks:
        raise ValueError(
            f"Number of sliding window blocks, {num_window_blocks}, must be "
            f"smaller than overal number of blocks in a row, {nb}!")
    w = num_window_blocks // 2
    r = np.arange(nb)
    dist = np.abs(r[:, None] - r[None, :])
    layout[h][dist <= w] = 1


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (arXiv:2007.14062) ITC pattern: random + sliding window +
    leading global blocks (reference `sparsity_config.py:421`)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=1,
                 num_sliding_window_blocks=3,
                 num_global_blocks=1,
                 seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.seed = seed

    def set_random_layout(self, h, layout):
        _random_layout(layout, h, self.num_random_blocks, self.seed)
        return layout

    def set_sliding_window_layout(self, h, layout):
        _sliding_window(layout, h, self.num_sliding_window_blocks)
        return layout

    def set_global_layout_itc(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_global_blocks:
            raise ValueError(
                f"Number of global blocks, {self.num_global_blocks}, must be "
                f"smaller than overal number of blocks in a row, {nb}!")
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (arXiv:2004.05150): sliding window + global
    rows/columns at chosen block indices (reference `sparsity_config.py:544`)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices=None,
                 global_block_end_indices=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices or [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, "
                    f"{len(self.global_block_indices)}, must be same as "
                    f"global block end indices length, "
                    f"{len(global_block_end_indices)}!")
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be "
                        f"smaller than global block end index, {end_idx}!")
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h, layout):
        _sliding_window(layout, h, self.num_sliding_window_blocks)
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start_idx, end_idx in spans:
            if start_idx >= nb:
                continue
            end_idx = min(end_idx, nb)
            layout[h, start_idx:end_idx, :] = 1
            layout[h, :, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
