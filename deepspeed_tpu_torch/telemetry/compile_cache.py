"""``compilation_cache_dir`` in the port: where the kernel builds live,
and their hit / miss counters (the counterpart of
``deepspeed_tpu/telemetry/compile_cache.py``).

For the JAX package the key names XLA's persistent compilation cache.
The port compiles no graphs; what it compiles is its kernels. Each CUDA
source is built by ``nvcc`` and each host op by ``g++`` into a library
named after a digest of its source and flags (``ops/_build.py``), so the
build directory already is a persistent, content-addressed compile
cache. ``compilation_cache_dir`` names that directory (default:
``.torch_ext/`` at the root of the checkout): a second process, or a
restart, pointed at the same directory loads the libraries a first one
built and runs no compiler.

:func:`counts` gives the hits (a library found in the directory) and
misses (a build that ran) of ``load_library`` and
``load_host_library``; the engine's one-shot ``compile`` event carries
them when the key is set.

The key has to reach ``ops/_build.py`` before a library is loaded: the
engine applies it (:func:`apply`) first thing in its constructor. A
library this process loaded before then stays loaded from where it was
built, and a later load of it counts as neither a hit nor a miss.
"""

from deepspeed_tpu_torch.ops import _build


def apply(directory):
    """Point the kernel builds at ``directory`` (created at the first
    build). Returns the resolved path."""
    _build.set_build_dir(directory)
    return str(_build.BUILD_DIR)


def counts():
    """``{"hits": int, "misses": int}`` since the process started or
    the last :func:`reset`."""
    return dict(_build.cache_counts)


def reset():
    """Zero the counters (test helper)."""
    _build.cache_counts["hits"] = 0
    _build.cache_counts["misses"] = 0
