"""Per-leaf CRC stamps over a nested dict of host arrays (the
``_leaf_checksums`` discipline of
``deepspeed_tpu/runtime/resilience/checkpoint.py``).

A snapshot parked in host RAM is stamped when it is taken and checked
when it is read back; a leaf whose bytes, dtype or shape changed in
between shows up as a mismatched key. Keys are the ``/``-joined dict
path (``"h_0/k"``).
"""

import zlib

import numpy as np


def iter_leaves(tree, prefix=""):
    """``(path, leaf)`` over a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from iter_leaves(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def leaf_checksums(tree):
    """``{path: {"crc32", "dtype", "shape"}}`` for every numpy leaf of
    the nested dict ``tree``."""
    out = {}
    for path, leaf in iter_leaves(tree):
        arr = np.ascontiguousarray(leaf)
        out[path] = {"crc32": zlib.crc32(arr.tobytes()),
                     "dtype": str(arr.dtype), "shape": list(arr.shape)}
    return out


def tree_nbytes(tree):
    """Total bytes of the numpy leaves of ``tree``."""
    return sum(int(np.asarray(leaf).nbytes) for _, leaf in iter_leaves(tree))
