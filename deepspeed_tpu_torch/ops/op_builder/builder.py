"""The host-op builders (port of ``deepspeed_tpu/ops/op_builder/
builder.py:138-200``).

Each class names one ``ops/csrc/<LIBRARY>.cpp`` source; ``load()`` builds
it with ``g++ -fopenmp`` through
:func:`~deepspeed_tpu_torch.ops._build.load_host_library` (content-hashed
into ``.torch_ext/``, at first use) and returns the ``ctypes.CDLL`` with
its functions' argument types set, as the JAX builders do. A build that
fails raises: nothing falls back to a plain version.
"""

import ctypes

from deepspeed_tpu_torch.ops import _build


class OpBuilder:
    """Base class: subclasses set ``NAME`` (the JAX op name) and
    ``LIBRARY`` (the port's ``ops/csrc/<LIBRARY>.cpp``)."""

    NAME = None
    LIBRARY = None

    def __init__(self):
        self._lib = None

    def sources(self):
        return [_build.CSRC / f"{self.LIBRARY}.cpp"]

    def is_compatible(self):
        """Can this op build here (``g++`` on the PATH)?"""
        import shutil
        return shutil.which("g++") is not None

    def jit_load(self, verbose=True):
        return _build.load_host_library(self.LIBRARY)

    def load(self, verbose=True):
        if self._lib is None:
            self._lib = self.jit_load(verbose=verbose)
            self._declare(self._lib)
        return self._lib

    def _declare(self, lib):
        """Set the library's argument and return types."""


class CPUAdamBuilder(OpBuilder):
    """Host AdamW for ZeRO-Offload (``ops/csrc/cpu_adam.cpp``; its
    wrapper, ``ops/adam/cpu_adam.py``, declares its own signatures)."""

    NAME = "cpu_adam"
    LIBRARY = "cpu_adam"


class SparseAttnBuilder(OpBuilder):
    """Block-sparse LUT construction (``ops/csrc/lut_builder.cpp``)."""

    NAME = "sparse_attn"
    LIBRARY = "lut_builder"

    def _declare(self, lib):
        i64 = ctypes.c_int64
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.ds_build_lut.argtypes = [p64, i64, i64, i64, i64, p32, p32]
        lib.ds_build_lut.restype = None
        lib.ds_lut_max_nnz.argtypes = [p64, i64, i64, i64]
        lib.ds_lut_max_nnz.restype = i64


class UtilsBuilder(OpBuilder):
    """flatten / unflatten packing (``ops/csrc/flatten_unflatten.cpp``;
    torch wrapper: :mod:`deepspeed_tpu_torch.ops.op_builder.utils`)."""

    NAME = "utils"
    LIBRARY = "flatten_unflatten"

    def _declare(self, lib):
        i64 = ctypes.c_int64
        pf = ctypes.POINTER(ctypes.c_float)
        ppf = ctypes.POINTER(pf)
        pi64 = ctypes.POINTER(i64)
        lib.ds_flatten.argtypes = [ppf, pi64, ctypes.c_int32, pf]
        lib.ds_flatten.restype = None
        lib.ds_unflatten.argtypes = [pf, pi64, ctypes.c_int32, ppf]
        lib.ds_unflatten.restype = None
