"""Row-sparse (CSR-style) tensors for sparse embedding gradients (port
of ``deepspeed_tpu/runtime/csr_tensor.py``).

A :class:`CSRTensor` is ``(indices [k], values [k, d], dense_rows)``:
``dense[indices[i]] += values[i]``, duplicate indices summing (the
reference's repeated-index sum). :func:`dense_to_csr` keeps a dense
gradient's top-``k`` rows by L1 mass; :func:`csr_allreduce` sums a CSR
tensor over the data-parallel group as an all-gather of indices and
values (comm volume ``world * k * (d + 1)`` words against the dense
all-reduce's ``2 * rows * d``), through the engine's counted
:class:`~deepspeed_tpu_torch.runtime.zero.comm.Comm`.
"""

import dataclasses

import torch

__all__ = ["CSRTensor", "csr_allreduce", "embedding_grad_csr",
           "dense_to_csr"]


@dataclasses.dataclass
class CSRTensor:
    indices: torch.Tensor     # [k] int64 row ids (duplicates allowed)
    values: torch.Tensor      # [k, d]
    dense_rows: int

    def to_dense(self):
        """Scatter-add into a zero ``[dense_rows, d]`` tensor (duplicate
        indices accumulate, in order)."""
        out = torch.zeros((self.dense_rows,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.indices, self.values)

    def sparse_size(self):
        return self.values.numel() + self.indices.numel()

    def add(self, other):
        assert self.dense_rows == other.dense_rows
        return CSRTensor(indices=torch.cat([self.indices, other.indices]),
                         values=torch.cat([self.values, other.values]),
                         dense_rows=self.dense_rows)


def dense_to_csr(dense, k=None):
    """The top-``k`` rows of a dense ``[rows, ...]`` gradient by L1 mass
    (``k`` defaults to every row). Rows past the support come out with
    zero values, harmless under scatter-add."""
    rows = dense.shape[0]
    k = rows if k is None else min(k, rows)
    mass = dense.abs().sum(dim=tuple(range(1, dense.ndim)))
    idx = torch.topk(mass, k).indices
    return CSRTensor(indices=idx, values=dense[idx], dense_rows=rows)


def embedding_grad_csr(ids, dout, vocab_size):
    """The gradient of ``table[ids]`` w.r.t. ``table`` in CSR form
    (``ids.numel()`` rows; the dense ``[vocab, d]`` tensor is never
    built)."""
    d = dout.shape[-1]
    return CSRTensor(indices=ids.reshape(-1).long(),
                     values=dout.reshape(-1, d), dense_rows=vocab_size)


def csr_allreduce(csr, comm, average=True):
    """``csr`` summed (or averaged) over ``comm``'s group: the ranks'
    indices and values all-gathered, concatenated in rank order (still
    duplicated; :meth:`CSRTensor.to_dense` resolves them). Without a
    group it is ``csr`` itself (averaged over a world of 1)."""
    world = comm.world
    k = csr.indices.shape[0]
    idx = torch.empty(world * k, dtype=csr.indices.dtype,
                      device=csr.indices.device)
    vals = torch.empty((world * k,) + tuple(csr.values.shape[1:]),
                       dtype=csr.values.dtype, device=csr.values.device)
    comm.all_gather(idx, csr.indices.contiguous())
    comm.all_gather(vals, csr.values.contiguous())
    if average:
        vals = vals / world
    return CSRTensor(indices=idx, values=vals, dense_rows=csr.dense_rows)
