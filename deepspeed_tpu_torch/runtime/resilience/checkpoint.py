"""Preemption-safe checkpoint I/O (port of
``deepspeed_tpu/runtime/resilience/checkpoint.py``): atomic writes,
integrity manifests, retention GC, validated discovery, bounded-retry
I/O and async saves, with the JAX manager's contract.

- **Atomic save**: the state files, ``meta.json`` and ``manifest.json``
  are written into ``<save_dir>/.tmp.<tag>``, and the directory is
  published with one ``os.rename``. A kill at any point leaves either
  the complete previous layout or an ignorable tmp dir. The ``latest``
  pointer is written to a tmp file and ``os.replace``-d.
- **Integrity manifest**: ``manifest.json`` records a file inventory
  (relative path -> byte size), a per-leaf CRC32
  (:mod:`~deepspeed_tpu_torch.runtime.resilience.checksums`) and, under
  ``arrays``, each leaf's file, dtype and shape.
- **Validation + fallback**: :meth:`CheckpointManager.resolve_tag`
  returns the newest checkpoint that passes cheap validation (manifest
  present, inventory sizes match), scanning past a corrupt or partial
  newest one; :meth:`CheckpointManager.load` verifies every leaf
  against its CRC32 and raises the typed :class:`CheckpointCorruptError`.
- **Retention GC**: ``keep_last_n`` prunes the oldest complete
  checkpoints after each save.
- **Retry**: every I/O phase runs under
  :func:`~deepspeed_tpu_torch.runtime.resilience.retry.retry_with_backoff`.
- **Async save**: with ``async_save`` the state is copied to host numpy
  before :meth:`CheckpointManager.save` returns, and the write runs on
  one worker thread; :meth:`CheckpointManager.wait` (also called at the
  start of the next save) surfaces its failure.

**State format.** The JAX manager writes orbax, which needs JAX. This
one writes each leaf of the nested state dict as one ``.npy`` file under
``state/`` (the dict path as directories), so a checkpoint reads back
with numpy alone. bfloat16, which numpy lacks, is saved as its
``uint16`` bit pattern and its dtype recorded in the manifest; it loads
back as a ``torch.bfloat16`` tensor. Every other leaf loads as numpy.
"""

import json
import logging
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from deepspeed_tpu_torch.runtime.resilience import fault_injection
from deepspeed_tpu_torch.runtime.resilience.checksums import (
    iter_leaves,
    leaf_checksums,
)
from deepspeed_tpu_torch.runtime.resilience.retry import (
    RetryExhaustedError,
    retry_with_backoff,
)

logger = logging.getLogger(__name__)

STATE_SUBDIR = "state"
META_NAME = "meta.json"
MANIFEST_NAME = "manifest.json"
LATEST_NAME = "latest"
TMP_PREFIX = ".tmp."
# the JAX manifest's version 2 sections, "arrays" holding the file of
# each leaf; no "topology" section yet (elastic loads are not ported)
MANIFEST_VERSION = 2
# A tmp dir younger than this survives retention GC: it may be another
# process's in-flight async save (see the JAX module).
TMP_GC_GRACE_S = 900.0
BF16 = "bfloat16"


def _newest_mtime(root):
    """Newest mtime anywhere under ``root``."""
    newest = 0.0
    try:
        newest = os.path.getmtime(root)
        for dirpath, _, filenames in os.walk(root):
            newest = max(newest, os.path.getmtime(dirpath))
            for name in filenames:
                newest = max(newest,
                             os.path.getmtime(os.path.join(dirpath, name)))
    except OSError:
        return time.time()
    return newest


class CheckpointIOError(RuntimeError):
    """Checkpoint I/O failed after exhausting retries. A failed save
    leaves only a tmp dir; the previous checkpoints are untouched."""


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed validation (truncated write, bad checksum,
    unreadable state). Carries the offending path and reason."""

    def __init__(self, path, reason):
        super().__init__(f"corrupt checkpoint at {path}: {reason}")
        self.path = path
        self.reason = reason


def to_host(leaf):
    """One state leaf as a host numpy array that owns its bytes, and its
    logical dtype name: a torch tensor (any device) or anything numpy
    takes. bfloat16 comes back as its ``uint16`` bit pattern."""
    if hasattr(leaf, "detach"):          # a torch tensor
        import torch
        # a device tensor's host copy is already the caller's own; a
        # host tensor's bytes are copied (its numpy view would alias)
        fresh = leaf.device.type != "cpu"
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            arr, dtype = t.view(torch.int16).numpy().view(np.uint16), BF16
        else:
            arr = t.numpy()
            dtype = str(arr.dtype)
        return (arr if fresh else arr.copy()), dtype
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def host_tree(state):
    """``(tree of numpy arrays, {path: dtype})`` for a nested dict of
    leaves, copied off the caller's buffers."""
    out, dtypes = {}, {}
    for path, leaf in iter_leaves(state):
        arr, dtype = to_host(leaf)
        dtypes[path] = dtype
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return out, dtypes


def _leaf_file(path):
    return os.path.join(STATE_SUBDIR, *path.split("/")) + ".npy"


def _file_inventory(root, skip={MANIFEST_NAME}):
    inv = {}
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root)
            if rel in skip:
                continue
            inv[rel] = os.path.getsize(full)
    return inv


class CheckpointManager:
    def __init__(self, save_dir=None, keep_last_n=0, async_save=False,
                 io_retries=3, io_retry_base_s=0.05, io_timeout_s=None,
                 tmp_gc_grace_s=TMP_GC_GRACE_S):
        self.save_dir = os.path.abspath(save_dir) if save_dir else None
        self.keep_last_n = int(keep_last_n)
        self.async_save = bool(async_save)
        self.io_retries = int(io_retries)
        self.io_retry_base_s = float(io_retry_base_s)
        self.io_timeout_s = io_timeout_s
        self.tmp_gc_grace_s = float(tmp_gc_grace_s)
        self._pool = None
        self._pending = None
        self._active_tmp = None

    # ------------------------------------------------------------------
    # paths
    # ------------------------------------------------------------------
    @staticmethod
    def ckpt_path(save_dir, tag):
        return os.path.abspath(os.path.join(save_dir, str(tag)))

    @staticmethod
    def _tmp_path(save_dir, tag):
        # deterministic: a crashed attempt's leftover is overwritten by
        # the retry of the same tag
        return os.path.abspath(os.path.join(save_dir, TMP_PREFIX + str(tag)))

    def _retry(self, fn, what):
        try:
            return retry_with_backoff(
                fn, what=what, attempts=self.io_retries,
                base_delay_s=self.io_retry_base_s,
                timeout_s=self.io_timeout_s, retry_on=(OSError,))
        except RetryExhaustedError as e:
            raise CheckpointIOError(str(e)) from e

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------
    def save(self, save_dir, tag, state, meta, save_latest=True,
             async_save=None, extra_manifest=None):
        """Atomically write one checkpoint; returns its final path.

        ``state`` is a nested dict whose leaves are torch tensors (any
        device) or numpy arrays / scalars; ``meta`` is JSON-serializable.
        The leaves are copied to host numpy before this returns, so the
        caller may go on mutating its buffers; with async the write then
        runs on a worker (:meth:`wait` joins it).
        """
        self.wait()  # surface a previous async failure before overwriting
        use_async = self.async_save if async_save is None else async_save
        host, dtypes = host_tree(state)
        if use_async:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt_save")
            self._pending = self._pool.submit(
                self._save_sync, save_dir, tag, host, dtypes, meta,
                save_latest, extra_manifest)
            return self.ckpt_path(save_dir, tag)
        return self._save_sync(save_dir, tag, host, dtypes, meta,
                               save_latest, extra_manifest)

    def wait(self):
        """Join an in-flight async save, raising its error if it failed."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _save_sync(self, save_dir, tag, host, dtypes, meta, save_latest,
                   extra_manifest=None):
        save_dir = os.path.abspath(save_dir)
        final = self.ckpt_path(save_dir, tag)
        tmp = self._tmp_path(save_dir, tag)

        def write():
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(os.path.join(tmp, STATE_SUBDIR), exist_ok=True)
            self._active_tmp = tmp
            arrays = {}
            for path, arr in iter_leaves(host):
                rel = _leaf_file(path)
                full = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(full), exist_ok=True)
                np.save(full, arr, allow_pickle=False)
                arrays[path] = {"file": rel, "dtype": dtypes[path],
                                "shape": list(arr.shape)}
            # worst-case interrupt point: state on disk, checkpoint not
            # yet valid or published
            fault_injection.maybe_fail_io("save")
            with open(os.path.join(tmp, META_NAME), "w") as f:
                json.dump(meta, f)
            manifest = dict(extra_manifest or {})
            manifest.update({
                "format_version": MANIFEST_VERSION,
                "tag": str(tag),
                "global_steps": meta.get("global_steps"),
                "inventory": _file_inventory(tmp),
                "checksums": leaf_checksums(host),
                "arrays": arrays,
            })
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.rename(tmp, final)

        try:
            self._retry(write, what=f"checkpoint save {final}")
        finally:
            self._active_tmp = None
        if save_latest:
            self._retry(lambda: self._write_latest(save_dir, tag),
                        what=f"latest pointer {save_dir}")
        if self.keep_last_n > 0:
            self._gc(save_dir, keep=self.keep_last_n)
        return final

    @staticmethod
    def _write_latest(save_dir, tag):
        tmp = os.path.join(save_dir, LATEST_NAME + ".tmp")
        with open(tmp, "w") as f:
            f.write(str(tag))
        os.replace(tmp, os.path.join(save_dir, LATEST_NAME))

    # ------------------------------------------------------------------
    # discovery + validation
    # ------------------------------------------------------------------
    def list_checkpoints(self, save_dir):
        """``(tag, global_steps, path)`` for every checkpoint dir, newest
        first; tmp dirs are never listed, and entries without a readable
        manifest or meta rank by mtime with global_steps None (oldest)."""
        save_dir = os.path.abspath(save_dir)
        if not os.path.isdir(save_dir):
            return []
        out = []
        for name in os.listdir(save_dir):
            path = os.path.join(save_dir, name)
            if not os.path.isdir(path) or name.startswith(TMP_PREFIX):
                continue
            steps = None
            for sidecar in (MANIFEST_NAME, META_NAME):
                try:
                    with open(os.path.join(path, sidecar)) as f:
                        steps = json.load(f).get("global_steps")
                    break
                except (OSError, ValueError):
                    pass
            out.append((name, steps, path))
        out.sort(key=lambda t: (t[1] is not None, t[1] or 0,
                                os.path.getmtime(t[2])), reverse=True)
        return out

    def validate(self, path):
        """Cheap structural validation (``state/``, ``meta.json``,
        ``manifest.json``, every inventory file at its recorded size);
        returns the manifest or raises :class:`CheckpointCorruptError`.
        Leaf bytes are checked at load time, against their CRC32."""
        if not os.path.isdir(path):
            raise CheckpointCorruptError(path, "not a directory")
        if not os.path.isdir(os.path.join(path, STATE_SUBDIR)):
            raise CheckpointCorruptError(path, "missing state/ subdir")
        try:
            with open(os.path.join(path, META_NAME)) as f:
                json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                path, f"missing/unreadable {META_NAME} ({e})") from e
        try:
            with open(os.path.join(path, MANIFEST_NAME)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                path, f"missing/unreadable {MANIFEST_NAME} ({e})") from e
        for rel, size in (manifest.get("inventory") or {}).items():
            full = os.path.join(path, rel)
            if not os.path.isfile(full):
                raise CheckpointCorruptError(
                    path, f"inventory file missing: {rel}")
            actual = os.path.getsize(full)
            if actual != size:
                raise CheckpointCorruptError(
                    path, f"inventory size mismatch for {rel}: "
                    f"manifest says {size} bytes, found {actual}")
        return manifest

    def is_valid(self, path):
        try:
            self.validate(path)
            return True
        except CheckpointCorruptError as e:
            logger.warning("skipping invalid checkpoint: %s", e)
            return False

    def resolve_tag(self, load_dir, tag=None):
        """The tag to load, or None if nothing valid. An explicit ``tag``
        is strict (it must validate); ``tag=None`` tries the ``latest``
        pointer, then the newest checkpoint that validates, logging each
        one it skips."""
        load_dir = os.path.abspath(load_dir)
        if tag is not None:
            self.validate(self.ckpt_path(load_dir, tag))
            return str(tag)
        tried = set()

        def usable(name, path):
            if name in tried:
                return False
            tried.add(name)
            return self.is_valid(path)

        latest = os.path.join(load_dir, LATEST_NAME)
        if os.path.isfile(latest):
            with open(latest) as f:
                pointed = f.read().strip()
            if pointed and usable(pointed, self.ckpt_path(load_dir, pointed)):
                return pointed
            logger.warning(
                "latest pointer %r is stale or its checkpoint is invalid; "
                "scanning %s for the newest valid checkpoint",
                pointed, load_dir)
        for name, _, path in self.list_checkpoints(load_dir):
            if usable(name, path):
                return name
        return None

    # ------------------------------------------------------------------
    # load
    # ------------------------------------------------------------------
    def load(self, load_dir, tag):
        """Read one validated checkpoint: ``(state, meta, path)``, the
        state a nested dict of numpy arrays (``torch.bfloat16`` tensors
        for bf16 leaves). A read failure or checksum mismatch raises
        :class:`CheckpointCorruptError`."""
        path = self.ckpt_path(load_dir, tag)
        manifest = self.validate(path)
        fault_injection.maybe_fail_io("load")
        arrays = manifest.get("arrays") or {}
        if not arrays:
            raise CheckpointCorruptError(path, "manifest lists no arrays")

        def read():
            raw = {}
            for key, rec in arrays.items():
                node = raw
                keys = key.split("/")
                for k in keys[:-1]:
                    node = node.setdefault(k, {})
                node[keys[-1]] = np.load(os.path.join(path, rec["file"]),
                                         allow_pickle=False)
            return raw

        try:
            raw = self._retry(read, what=f"checkpoint read {path}")
        except CheckpointIOError:
            raise
        except Exception as e:
            raise CheckpointCorruptError(
                path, f"state read failed ({type(e).__name__}: {e})") from e
        checksums = manifest.get("checksums")
        if checksums is not None:
            self._verify_checksums(path, raw, checksums)
        with open(os.path.join(path, META_NAME)) as f:
            meta = json.load(f)
        return self._typed(raw, arrays), meta, path

    @staticmethod
    def _typed(raw, arrays):
        """bf16 leaves (stored as uint16) back to ``torch.bfloat16``."""
        bf16 = [k for k, rec in arrays.items() if rec["dtype"] == BF16]
        if not bf16:
            return raw
        import torch
        for key in bf16:
            node = raw
            keys = key.split("/")
            for k in keys[:-1]:
                node = node[k]
            bits = node[keys[-1]]
            node[keys[-1]] = torch.from_numpy(
                bits.view(np.int16)).view(torch.bfloat16)
        return raw

    @staticmethod
    def _verify_checksums(path, state, checksums):
        actual = leaf_checksums(state)
        if set(actual) != set(checksums):
            missing = sorted(set(checksums) - set(actual))
            extra = sorted(set(actual) - set(checksums))
            raise CheckpointCorruptError(
                path, f"state tree structure differs from manifest "
                f"(missing leaves: {missing[:4]}, extra: {extra[:4]})")
        for key, rec in checksums.items():
            if actual[key]["crc32"] != rec["crc32"]:
                raise CheckpointCorruptError(
                    path, f"checksum mismatch for leaf {key}: array bytes "
                    "changed on disk since save")

    # ------------------------------------------------------------------
    # retention GC
    # ------------------------------------------------------------------
    def _gc(self, save_dir, keep):
        ckpts = self.list_checkpoints(save_dir)
        for name, _, path in ckpts[keep:]:
            try:
                shutil.rmtree(path)
                logger.info("retention GC removed checkpoint %s", path)
            except OSError as e:
                logger.warning("retention GC failed for %s: %s", path, e)
        # a tmp dir is reaped only when it is not this manager's write,
        # belongs to no kept checkpoint and has been quiet for the grace
        # window (it may be a peer's in-flight async save)
        live = {t for t, _, _ in ckpts[:keep]}
        now = time.time()
        for name in os.listdir(save_dir):
            if not name.startswith(TMP_PREFIX):
                continue
            path = os.path.join(save_dir, name)
            if path == self._active_tmp or name[len(TMP_PREFIX):] in live:
                continue
            if now - _newest_mtime(path) < self.tmp_gc_grace_s:
                continue
            shutil.rmtree(path, ignore_errors=True)
            logger.info("retention GC removed stale tmp dir %s", path)

    def close(self):
        self.wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
