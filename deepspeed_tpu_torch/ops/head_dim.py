"""The column chunks of a wide head, shared by every attention launcher.

The port's attention kernels (flash attention K1-K3 on the FMA route,
block-sparse K7/K8, flash decode K5/K6) take any head dim. A CTA holds
at most ``COLUMN_CHUNK`` output columns: past it a launch gives each
head ``n_col(D)`` CTAs along the grid's chunk axis, chunk ``c`` owning
columns ``[c * COLUMN_CHUNK, min(D, (c + 1) * COLUMN_CHUNK))``, and every
one of them forms the full scores (streamed over the head dim in windows
of ``COLUMN_CHUNK``). ``ops/csrc/column_chunk.cuh`` holds the same width
(``kColChunk``), and each kernel checks the count it is handed.
"""

COLUMN_CHUNK = 256


def n_col(head_dim):
    """The CTAs a launch gives each head: ceil(head_dim / COLUMN_CHUNK),
    1 at or below 256."""
    head_dim = int(head_dim)
    if head_dim < 1:
        raise ValueError(f"head_dim must be >= 1, got {head_dim}")
    return -(-head_dim // COLUMN_CHUNK)
