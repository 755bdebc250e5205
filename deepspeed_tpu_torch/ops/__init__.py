"""Hand-written GPU kernels of the port, each beside its plain PyTorch
version (``ops/csrc/`` holds the CUDA sources, ``ops/_build.py``
compiles them at first use)."""

from deepspeed_tpu_torch.ops.flash_decode import (
    DEFAULT_MASK_VALUE,
    KernelGeometryError,
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_reference,
    flash_decode_reference,
)

__all__ = ["DEFAULT_MASK_VALUE", "KernelGeometryError", "flash_decode",
           "flash_decode_paged", "flash_decode_paged_reference",
           "flash_decode_reference"]
