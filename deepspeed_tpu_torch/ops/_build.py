"""Build the port's CUDA kernels from the sources in this package.

Each kernel source under ``ops/csrc/`` exposes a plain C interface and
is compiled by ``nvcc`` into its own shared library, then loaded with
``ctypes``. No PyTorch headers are included, which keeps a build at
seconds instead of the minutes a ``torch.utils.cpp_extension`` build
takes, and needs no ``ninja``.

Builds happen at first use, never at import, into ``.torch_ext/`` at
the root of the checkout (listed in ``.gitignore``). A library is named
after a hash of its source and flags, so an edited source rebuilds and
an unchanged one is reused; the compile writes a temporary file and
renames it into place, so concurrent first uses never load a partial
library. A source listed in ``VARIANTS`` is built once per value of its
macros, each into a library of its own, so those builds too run side by
side (each library holds a share of the source's instances).

The host ops (``HOST_KERNELS``: the C++ Adam of ZeRO-Offload, the
block-sparse LUT builder and the flatten / unflatten helper) are built
the same way by ``g++`` with OpenMP and the SIMD flags the CPU reports
(:func:`load_host_library`).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("flash_decode", "flash_attention", "fused_adam",
           "block_sparse_attention")                # csrc/<name>.cu
# name -> (macros, values): the source built once per tuple of values
# (block_sparse_attention once per storage type, BSA_DTYPE 0 f32, 1 bf16,
# 2 fp16, and part, BSA_PART 0 the forward K7, 1 the backward K8a / K8b)
VARIANTS = {"block_sparse_attention": (
    ("BSA_DTYPE", "BSA_PART"), tuple((d, k) for d in (0, 1, 2)
                                     for k in (0, 1)))}
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v") + ARCH_FLAGS


def libraries():
    """``(name, variant)`` of every library the kernel sources build
    into (variant None for a source built once)."""
    return [(name, v) for name in KERNELS
            for v in (VARIANTS[name][1] if name in VARIANTS else (None,))]


HOST_KERNELS = ("cpu_adam", "lut_builder",
                "flatten_unflatten")                # csrc/<name>.cpp
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp")


def host_simd_flags(cpuinfo=None):
    """The SIMD flags of the host build, from ``/proc/cpuinfo``: the
    choice of ``deepspeed_tpu/ops/op_builder/builder.py`` (AVX-512F,
    then AVX2 always with FMA, whose kernels use fused multiply-adds)."""
    if cpuinfo is None:
        try:
            cpuinfo = Path("/proc/cpuinfo").read_text()
        except OSError:
            cpuinfo = ""
    flags = []
    if "avx512f" in cpuinfo:
        flags.append("-mavx512f")
    if "avx2" in cpuinfo:
        flags += ["-mavx2", "-mfma"]
    elif "fma" in cpuinfo:
        flags.append("-mfma")
    return tuple(flags)


def library_key(name, variant=None):
    """The name a library goes by in ``build_info``: the source's name,
    with ``.<value>`` per macro for a variant build."""
    return name if variant is None else ".".join(
        [name] + [str(v) for v in variant])


# one lock per library, so builds of different libraries run side by side
_locks = {library_key(*lib): threading.Lock() for lib in libraries()}
_locks.update((name, threading.Lock()) for name in HOST_KERNELS)
_libs = {}
# library key -> {"seconds": build wall (0.0 when reused), "ptxas": [lines
# of ptxas -v, with each function's spill line]}
build_info = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME unset and no nvcc on PATH): the "
        "port's CUDA kernels are built from source at first use")


def _compile(key, cmd, so):
    """Run ``cmd`` (its output path last) into a temporary file and
    rename it to ``so``; records the wall and the compiler's report
    lines in ``build_info[key]``. Raises ``RuntimeError`` with the
    compiler output when the build fails."""
    tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, str(tmp)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed building {key} (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    # ptxas -v: each entry function, its registers and its spills
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "ptxas" in ln or "spill" in ln]
    build_info[key] = {"seconds": seconds, "ptxas": ptxas}


def load_host_library(name):
    """Build (if needed) and load the host op ``csrc/<name>.cpp`` with
    ``g++ -fopenmp`` and :func:`host_simd_flags`; returns the
    ``ctypes.CDLL``. Raises ``RuntimeError`` when ``g++`` is missing or
    the build fails: a host op never falls back to a plain version."""
    if name not in HOST_KERNELS:
        raise ValueError(f"no host library {name!r}: {HOST_KERNELS}")
    flags = HOST_FLAGS + host_simd_flags()
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cpp"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(flags).encode()).hexdigest()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{name}-{digest[:16]}.so"
        if so.exists():
            build_info[name] = {"seconds": 0.0, "ptxas": []}
        else:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(
                    f"g++ not found on PATH: the host op {name} is built "
                    f"from source at first use")
            _compile(name, [gxx, *flags, str(src), "-o"], so)
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib


def load_library(name, variant=None):
    """Build (if needed) and load ``csrc/<name>.cu`` (for a source in
    ``VARIANTS``, its build with the macros set to the values of
    ``variant``); returns the ``ctypes.CDLL``. Raises ``RuntimeError``
    with the compiler output when the build fails."""
    if variant is not None:
        variant = tuple(variant)
    key = library_key(name, variant)
    if (variant is None) != (name not in VARIANTS) or \
            (variant is not None and variant not in VARIANTS[name][1]):
        raise ValueError(f"no library {key!r}: variants {VARIANTS}")
    flags = NVCC_FLAGS if variant is None else NVCC_FLAGS + tuple(
        f"-D{m}={v}" for m, v in zip(VARIANTS[name][0], variant))
    with _locks[key]:
        lib = _libs.get(key)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        # the shared headers are part of every source's digest
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(flags).encode()
        ).hexdigest()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{key}-{digest[:16]}.so"
        if so.exists():
            build_info[key] = {"seconds": 0.0, "ptxas": []}
        else:
            _compile(key, [_nvcc(), *flags, str(src), "-o"], so)
        lib = ctypes.CDLL(str(so))
        _libs[key] = lib
        return lib
