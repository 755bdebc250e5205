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
library.
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
KERNELS = ("flash_decode", "flash_attention", "fused_adam")  # csrc/<name>.cu
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v") + ARCH_FLAGS

_lock = threading.Lock()
_libs = {}
# name -> {"seconds": build wall (0.0 when reused), "ptxas": [lines]}
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


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the
    ``ctypes.CDLL``. Raises ``RuntimeError`` with the compiler output
    when the build fails."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{name}-{digest[:16]}.so"
        if so.exists():
            build_info[name] = {"seconds": 0.0, "ptxas": []}
        else:
            tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed building {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stdout}"
                    f"{proc.stderr}")
            os.replace(tmp, so)
            ptxas = [ln for ln in (proc.stdout + proc.stderr).splitlines()
                     if "ptxas" in ln]
            build_info[name] = {"seconds": seconds, "ptxas": ptxas}
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
