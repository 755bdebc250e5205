"""In-memory hot-checkpoint tier: seconds-scale recovery for benign
restarts (port of ``deepspeed_tpu/runtime/resilience/hotckpt.py``).

Disk checkpoints (:mod:`~deepspeed_tpu_torch.runtime.resilience.
checkpoint`) are the durable tier, but every recovery through them
replays up to ``save_interval_steps`` of work and pays a full write and
read. :class:`HotCheckpointStore` keeps a second, cheaper tier: frequent
device-to-host snapshots held in RAM, so a guard-trip rollback resumes
from the last step or two.

- **Snapshot isolation**: :meth:`HotCheckpointStore.snapshot` copies
  every leaf into host numpy memory that the snapshot owns
  (``checkpoint.py:host_tree``: a CUDA tensor is copied to the host, a
  CPU tensor's bytes are copied too, since its ``.numpy()`` would alias
  the live parameter that the next step updates in place).
- **CRC stamping**: each snapshot is crc32-stamped per leaf on a
  background worker thread (:mod:`~deepspeed_tpu_torch.runtime.
  resilience.checksums`); :meth:`HotCheckpointStore.restore` checks the
  stamps before handing the tree back, so a corrupted snapshot raises
  :class:`HotCheckpointCorruptError` instead of resuming from garbage
  (the restore ladder then falls through to disk).
- **Capacity**: the store holds the ``capacity`` newest snapshots and
  evicts the oldest.
- **Mirror**: with ``mirror_dir`` each snapshot is also written to a
  local directory (``hot-<tag>/state.npz`` and ``hot.json``, written
  into a tmp dir and renamed); in RAM the tier dies with the process,
  the mirror lets a restarted process skip the disk checkpoint.

The store knows nothing about the engine: it moves nested dicts of
leaves. The engine's restore ladder (``runtime/engine.py``) decides hot
RAM, then the hot mirror, then disk.
"""

import collections
import json
import logging
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from deepspeed_tpu_torch.runtime.resilience.checkpoint import BF16, host_tree
from deepspeed_tpu_torch.runtime.resilience.checksums import (
    iter_leaves,
    leaf_checksums,
)

logger = logging.getLogger(__name__)

MIRROR_PREFIX = "hot-"
MIRROR_TMP_PREFIX = ".tmp.hot-"
MIRROR_STATE_NAME = "state.npz"
MIRROR_META_NAME = "hot.json"
MIRROR_LATEST_NAME = "hot-latest"


class HotCheckpointCorruptError(RuntimeError):
    """A hot snapshot (RAM or mirror) failed CRC or structure
    validation."""

    def __init__(self, what, reason):
        super().__init__(f"corrupt hot checkpoint ({what}): {reason}")
        self.what = what
        self.reason = reason


class HotSnapshot:
    """One host-RAM snapshot: tag, state tree (host numpy), meta,
    topology, the leaves' logical dtypes and their CRC stamps."""

    __slots__ = ("tag", "state", "meta", "topology", "dtypes", "checksums",
                 "t", "nbytes")

    def __init__(self, tag, state, meta, topology, dtypes):
        self.tag = str(tag)
        self.state = state
        self.meta = meta
        self.topology = topology
        self.dtypes = dtypes
        self.checksums = None   # stamped by the background worker
        self.t = time.time()
        self.nbytes = sum(int(a.nbytes) for _, a in iter_leaves(state))


def _typed(state, dtypes):
    """bf16 leaves (held as their uint16 bits) back to ``torch.bfloat16``
    tensors; every other leaf stays numpy."""
    bf16 = [k for k, d in (dtypes or {}).items() if d == BF16]
    if not bf16:
        return state
    import torch
    for key in bf16:
        node = state
        keys = key.split("/")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = torch.from_numpy(
            node[keys[-1]].view(np.int16)).view(torch.bfloat16)
    return state


def _dicts(tree):
    """``tree``'s dicts copied, its leaves shared."""
    if isinstance(tree, dict):
        return {k: _dicts(v) for k, v in tree.items()}
    return tree


class HotCheckpointStore:
    """Up to ``capacity`` recent snapshots in host RAM, optionally
    mirrored under ``mirror_dir`` (the newest ``mirror_keep`` kept)."""

    def __init__(self, capacity=1, mirror_dir=None, mirror_keep=1,
                 process_index=0):
        self.capacity = max(1, int(capacity))
        self.mirror_dir = os.path.abspath(mirror_dir) if mirror_dir \
            else None
        self.mirror_keep = max(1, int(mirror_keep))
        self.process_index = int(process_index)
        self._snaps = collections.deque(maxlen=self.capacity)
        self._pool = None
        self._pending = None

    # ------------------------------------------------------------------
    # snapshot
    # ------------------------------------------------------------------
    def snapshot(self, tag, state, meta, topology=None):
        """Copy ``state`` (a nested dict of tensors or arrays) to host RAM
        and keep it; the CRC stamping and the mirror write run on a
        background worker (:meth:`wait` joins it; :meth:`restore`
        does)."""
        self.wait()     # surface a previous stamping or mirror failure
        host, dtypes = host_tree(state)
        snap = HotSnapshot(tag, host, meta, topology, dtypes)
        self._snaps.append(snap)
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="hot_ckpt")
        self._pending = self._pool.submit(self._stamp_and_mirror, snap)
        return snap

    def _stamp_and_mirror(self, snap):
        snap.checksums = leaf_checksums(snap.state)
        if self.mirror_dir:
            self._write_mirror(snap)

    def wait(self):
        """Join the in-flight stamp / mirror job, raising its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def latest(self):
        """The newest snapshot (CRC stamped: joins the background job),
        or None when the store is empty."""
        if not self._snaps:
            return None
        self.wait()
        return self._snaps[-1]

    # ------------------------------------------------------------------
    # restore (RAM tier)
    # ------------------------------------------------------------------
    def restore(self, snap=None):
        """``(state, meta, topology)`` from the newest (or the given)
        snapshot after CRC verification; the state's leaves are the
        snapshot's own arrays (the engine copies them into its tensors;
        a caller must not write them). Raises
        :class:`HotCheckpointCorruptError` on a mismatch: callers fall
        through to the next rung."""
        if snap is None:
            snap = self.latest()
        else:
            self.wait()
        if snap is None:
            return None
        if snap.checksums is None:
            raise HotCheckpointCorruptError(
                f"ram:{snap.tag}", "snapshot was never CRC-stamped")
        actual = leaf_checksums(snap.state)
        if actual != snap.checksums:
            bad = sorted(k for k in snap.checksums
                         if actual.get(k) != snap.checksums[k])
            raise HotCheckpointCorruptError(
                f"ram:{snap.tag}",
                f"crc mismatch on {len(bad)} leaves (first: {bad[:3]})")
        return (_typed(_dicts(snap.state), snap.dtypes), snap.meta,
                snap.topology)

    # ------------------------------------------------------------------
    # mirror tier
    # ------------------------------------------------------------------
    def _write_mirror(self, snap):
        final = os.path.join(self.mirror_dir, MIRROR_PREFIX + snap.tag)
        tmp = os.path.join(self.mirror_dir, MIRROR_TMP_PREFIX + snap.tag)
        try:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
            arrays = dict(iter_leaves(snap.state))
            with open(os.path.join(tmp, MIRROR_STATE_NAME), "wb") as f:
                np.savez(f, **arrays)
            with open(os.path.join(tmp, MIRROR_META_NAME), "w") as f:
                json.dump({"tag": snap.tag, "t": snap.t,
                           "process_index": self.process_index,
                           "meta": snap.meta, "topology": snap.topology,
                           "dtypes": snap.dtypes,
                           "checksums": snap.checksums}, f)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            latest_tmp = os.path.join(self.mirror_dir,
                                      MIRROR_LATEST_NAME + ".tmp")
            with open(latest_tmp, "w") as f:
                f.write(snap.tag)
            os.replace(latest_tmp,
                       os.path.join(self.mirror_dir, MIRROR_LATEST_NAME))
            self._gc_mirror()
        except OSError as e:
            # the mirror speeds recovery up; a failed write costs
            # recovery time, never correctness
            logger.warning("hot-checkpoint mirror write failed: %s", e)
            shutil.rmtree(tmp, ignore_errors=True)

    def _gc_mirror(self):
        entries = []
        for name in os.listdir(self.mirror_dir):
            path = os.path.join(self.mirror_dir, name)
            if name.startswith(MIRROR_PREFIX) and os.path.isdir(path):
                entries.append((os.path.getmtime(path), path))
            elif name.startswith(MIRROR_TMP_PREFIX):
                shutil.rmtree(path, ignore_errors=True)
        entries.sort(reverse=True)
        for _, path in entries[self.mirror_keep:]:
            shutil.rmtree(path, ignore_errors=True)

    @staticmethod
    def load_mirror(mirror_dir, template):
        """``(state, meta, topology)`` from the newest usable mirror
        snapshot under ``mirror_dir``, rebuilt on ``template``'s nested
        dict structure (the mirror stores leaves by path; the restoring
        process supplies the structure, its freshly built state tree).
        Returns None when the directory holds no usable mirror: a torn
        or corrupt one is skipped with a warning."""
        mirror_dir = os.path.abspath(mirror_dir)
        candidates = []
        try:
            with open(os.path.join(mirror_dir, MIRROR_LATEST_NAME)) as f:
                tag = f.read().strip()
            if tag:
                candidates.append(
                    os.path.join(mirror_dir, MIRROR_PREFIX + tag))
        except OSError:
            pass
        try:
            extra = [os.path.join(mirror_dir, n)
                     for n in os.listdir(mirror_dir)
                     if n.startswith(MIRROR_PREFIX)
                     and os.path.isdir(os.path.join(mirror_dir, n))]
            extra.sort(key=os.path.getmtime, reverse=True)
            candidates.extend(p for p in extra if p not in candidates)
        except OSError:
            return None
        for path in candidates:
            try:
                return HotCheckpointStore._load_one_mirror(path, template)
            except Exception as e:
                # a torn mirror can fail anywhere in the decode (zip, npy
                # header, json, CRC): skip to the next one
                logger.warning("skipping unusable hot mirror %s: %s",
                               path, e)
        return None

    @staticmethod
    def _load_one_mirror(path, template):
        with open(os.path.join(path, MIRROR_META_NAME)) as f:
            doc = json.load(f)
        state = {}
        with np.load(os.path.join(path, MIRROR_STATE_NAME)) as npz:
            for key, _ in iter_leaves(template):
                if key not in npz.files:
                    raise HotCheckpointCorruptError(
                        path, f"mirror missing leaf {key}: snapshot is "
                        "from a different state tree")
                node = state
                keys = key.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = np.array(npz[key])
        checksums = doc.get("checksums")
        if checksums:
            actual = leaf_checksums(state)
            for key, rec in checksums.items():
                got = actual.get(key)
                if got is None or got["crc32"] != rec["crc32"]:
                    raise HotCheckpointCorruptError(
                        path, f"crc mismatch for leaf {key}")
        return (_typed(state, doc.get("dtypes")), doc.get("meta"),
                doc.get("topology"))

    def close(self):
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            self._snaps.clear()
