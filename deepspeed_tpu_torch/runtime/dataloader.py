"""Data loading (port of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` and ``RepeatingLoader`` with the JAX loader's
contract: the batch order is a pure function of ``(seed, epoch)`` (the
same numpy ``default_rng(seed + epoch)`` shuffle, so both packages yield
the same rows in the same order), ``drop_last``, the per-process strided
shard, and the global *sample* cursor that a checkpoint restores, also
at a different batch size. Batches come out as torch CPU tensors (the
default collate stacks numpy samples and wraps them); the engine moves
them to its device.
"""

import math

import numpy as np
import torch


class RepeatingLoader:
    """Wrap an iterator to restart on StopIteration (reference :10).

    On each restart, advances the wrapped loader's epoch (when it supports
    ``set_epoch``) so shuffling differs across epochs — the engine path's
    analog of advancing a DistributedSampler's epoch.
    """

    def __init__(self, loader):
        self.loader = loader
        self.epoch = 0
        self.batches_served = 0
        self.samples_served = 0
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.epoch += 1
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(self.epoch)
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        self.batches_served += 1
        self.samples_served += _batch_rows(batch)
        return batch

    # -- resume (runtime/resilience auto-resume restores data position) --
    def state_dict(self):
        # samples_served is the global sample cursor: unlike the batch
        # index it survives a batch-size change on resume (the same
        # position counted in different-sized batches)
        return {"epoch": self.epoch,
                "batches_served": self.batches_served,
                "samples_served": self.samples_served}

    def load_state_dict(self, state):
        """Fast-forward to the saved position by replaying the stream from
        the start: batch order is a pure function of (seed, epoch), so
        redrawing reproduces the exact sequence — the resumed run sees
        bit-identical batches to an uninterrupted one. Replay cost is one
        collate per skipped batch (no device transfer).

        Position is the global *sample* cursor when the checkpoint has
        one (so it lands correctly at a different batch size); older
        checkpoints fall back to the batch index."""
        self.epoch = 0
        self.batches_served = 0
        self.samples_served = 0
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(0)
        self.data_iter = iter(self.loader)
        target_samples = state.get("samples_served")
        if target_samples is None:
            for _ in range(int(state["batches_served"])):
                next(self)
            return
        while self.samples_served < int(target_samples):
            next(self)
        if self.samples_served != int(target_samples):
            # New batch size does not divide the saved cursor: land on
            # the next batch boundary (at most one batch of overlap is
            # re-served, never silently skipped data).
            import logging
            logging.getLogger(__name__).warning(
                "dataloader resume: saved sample cursor %s is not a "
                "multiple of the current batch size; resuming at %s",
                target_samples, self.samples_served)


def _batch_rows(batch):
    """Number of rows in a collated batch (leading dim of its first
    array), for the global sample cursor."""
    first = batch
    while isinstance(first, dict):
        first = next(iter(first.values()))
    while isinstance(first, (tuple, list)):
        first = first[0]
    shape = np.shape(first)
    return int(shape[0]) if shape else 1


def _stack(arrays):
    return torch.from_numpy(np.stack([np.asarray(a) for a in arrays]))


def _default_collate(samples):
    """Stack a list of samples (dicts of arrays, tuples, or arrays) into
    torch CPU tensors."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([s[i] for s in samples])
                           for i in range(len(first)))
    return _stack(samples)


class DeepSpeedDataLoader:
    """Batched loader over an indexable dataset with per-process sharding.

    ``batch_size`` is the global batch (the engine asks for the train
    batch). With ``process_count`` > 1 each process sees a strided
    subset of the dataset and emits its ``batch_size // process_count``
    share. ``process_index`` and ``process_count`` default to the
    data-parallel group's rank and world size (0 and 1 without a group),
    as the JAX loader's default to ``jax.process_index()`` /
    ``jax.process_count()``.
    """

    def __init__(self,
                 dataset,
                 batch_size,
                 collate_fn=None,
                 shuffle=True,
                 seed=0,
                 drop_last=True,
                 process_index=None,
                 process_count=None):
        if process_index is None or process_count is None:
            from deepspeed_tpu_torch.parallel import mesh
            process_index, process_count = mesh.dp_rank(), \
                mesh.dp_world_size()
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

        n = len(dataset)
        self.num_local = n // process_count if drop_last \
            else math.ceil(n / process_count)
        self.local_batch = batch_size // process_count
        assert self.local_batch >= 1, (
            f"batch_size {batch_size} < process_count {process_count}")
        self.len = self.num_local // self.local_batch if drop_last \
            else math.ceil(self.num_local / self.local_batch)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def state_dict(self):
        return {"epoch": self.epoch}

    def load_state_dict(self, state):
        self.set_epoch(int(state["epoch"]))

    def __len__(self):
        return self.len

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # Strided per-process shard (DistributedSampler semantics).
        local = order[self.process_index::self.process_count][:self.num_local]
        for i in range(self.len):
            idx = local[i * self.local_batch:(i + 1) * self.local_batch]
            if len(idx) == 0:
                return
            yield self.collate_fn([self.dataset[int(j)] for j in idx])
