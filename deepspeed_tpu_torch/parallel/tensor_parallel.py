"""Megatron-style tensor-parallel layers (port of
``deepspeed_tpu/parallel/tensor_parallel.py``).

The JAX layers annotate their params with the mesh axis each dim is
split over and let GSPMD insert the collectives. Here each layer holds
only its shard and runs the collectives itself over the model
:class:`~deepspeed_tpu_torch.parallel.mesh.AxisGroup` (``group``; None
or a group of one is the unsharded layer):

- :class:`ColumnParallelLinear`: the output dim split. Its input is the
  replicated activation, so it takes Megatron's ``f``
  (:func:`~deepspeed_tpu_torch.parallel.collectives.psum_grad`: the
  input's cotangent summed over the group); its output stays split.
- :class:`RowParallelLinear`: the input dim split; each rank's partial
  product is summed over the group (``g``,
  :func:`~deepspeed_tpu_torch.parallel.collectives.psum_combine`) and
  the replicated bias is added once, after the sum.
- :class:`TPMultiHeadAttention`, :class:`TPMLP` and
  :class:`TPTransformerBlock`: the Megatron split of attention (each
  rank owns ``n_head / M`` whole heads: its q, k and v columns from the
  column-parallel ``c_attn``) and of the MLP (the hidden dim never
  crosses ranks); LayerNorms and the residual stream replicated.
  ``use_flash`` runs the flash kernels K1-K3 on the rank's heads.

Weights are stored as torch's ``[out, in]``, the transpose of the flax
kernel. A column-parallel weight shards dim 0, a row-parallel one dim 1.
``c_attn``'s output is three blocks (q, k, v); rank r takes block
``[r]`` of each (``Shard(0, groups=3)``), the heads it owns. JAX's
``PartitionSpec(None, "model")`` on the ``[C, 3C]`` kernel splits the
columns evenly instead and lets GSPMD move q, k and v to the heads' owners;
the math is the same, so the port's layout is the Megatron one and its
converters (:func:`shard_tensor`) take a rank's heads from the whole
JAX leaf.

:func:`partition_specs` maps each leaf name to its :class:`Shard` (None:
replicated): what ``initialize(param_specs=...)`` takes. JAX's
``logical_constraint`` (a GSPMD sharding hint on an activation) has no
counterpart in explicit TP: :func:`logical_constraint` is the identity.
"""

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.parallel.collectives import psum_combine, psum_grad


class Shard(NamedTuple):
    """How a leaf is split over the mesh axis ``axis`` (``"model"``, or
    ``"expert"`` for an MoE bank): along ``dim``, in ``groups`` equal
    blocks each split evenly (rank r takes piece r of every block);
    ``full`` is the whole leaf's length along ``dim`` when the split
    pads it (a vocab that the axis size does not divide: the whole leaf
    is padded with zero rows to a multiple, and the padding is cut off
    again by :func:`unshard`)."""
    dim: int
    groups: int = 1
    full: Optional[int] = None
    axis: str = "model"


def padded_len(n, size):
    """``n`` rounded up to a multiple of ``size``."""
    return -(-int(n) // int(size)) * int(size)


def shard_tensor(full, spec, rank, size):
    """Rank ``rank``'s piece of the whole leaf ``full`` (a tensor or numpy
    array) under ``spec`` (None: the leaf itself)."""
    if spec is None or size == 1:
        return full
    t = torch.as_tensor(full)
    dim = spec.dim % t.ndim
    n = t.shape[dim]
    if spec.full is not None and n % (size * spec.groups):
        pad = [0, 0] * (t.ndim - dim - 1) + [0, padded_len(n, size) - n]
        t = F.pad(t, pad)
    blocks = t.chunk(spec.groups, dim=dim)
    return torch.cat([b.chunk(size, dim=dim)[rank] for b in blocks],
                     dim=dim).contiguous()


def unshard(pieces, spec):
    """The whole leaf from every rank's piece, in rank order (the inverse
    of :func:`shard_tensor`)."""
    if spec is None or len(pieces) == 1:
        return pieces[0]
    dim = spec.dim % pieces[0].ndim
    per = [p.chunk(spec.groups, dim=dim) for p in pieces]
    whole = torch.cat([torch.cat([p[g] for p in per], dim=dim)
                       for g in range(spec.groups)], dim=dim)
    if spec.full is not None:
        whole = whole.narrow(dim, 0, spec.full)
    return whole.contiguous()


def set_shard(param, spec):
    """Mark ``param`` as split by ``spec`` (read by
    :func:`partition_specs`)."""
    param.tp_shard = spec
    return param


def partition_specs(module):
    """``{param name: Shard or None}`` of ``module``'s params (the
    counterpart of JAX ``partition_specs`` over boxed params)."""
    return {name: getattr(p, "tp_shard", None)
            for name, p in module.named_parameters()}


def logical_constraint(x, *spec, mesh=None):
    """The identity. JAX's ``logical_constraint`` pins an activation's
    GSPMD sharding; explicit TP has no propagation to hint, each rank
    holds what its layer computed."""
    return x


def _split(n, group, what):
    size = 1 if group is None else group.size
    if n % size:
        raise ValueError(f"{what} {n} does not divide the model axis "
                         f"({size})")
    return n // size


_TRUNC_STD = 0.87962566103423978     # flax lecun_normal's truncation


class _Linear(nn.Module):
    def __init__(self, weight_shape, bias_len, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(weight_shape,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(bias_len, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator=None, std=None):
        """flax's ``normal(0.02)`` when ``std`` is given, else its
        lecun-normal (over the whole layer's fan-in)."""
        if std is None:
            std = math.sqrt(1.0 / self.fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            nn.init.normal_(self.weight, 0.0, std, generator=generator)
        nn.init.zeros_(self.bias)


class ColumnParallelLinear(_Linear):
    """``[n_in] -> [n_out / M]``: weight ``[n_out / M, n_in]`` (with
    ``groups`` output blocks, rank r's rows of each), bias
    ``[n_out / M]``. The input is replicated: Megatron's ``f`` sums its
    cotangent over the group."""

    def __init__(self, n_in, n_out, group=None, groups=1,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        local = _split(n_out // groups, group, "column-parallel width") * \
            groups
        super().__init__((local, n_in), local, dtype, param_dtype, device)
        self.group = group
        self.fan_in = n_in
        spec = Shard(0, groups)
        set_shard(self.weight, spec)
        set_shard(self.bias, spec)

    def forward(self, x):
        x = psum_grad(x, self.group).to(self.dtype)
        return torch.matmul(x, self.weight.to(self.dtype).t()) + \
            self.bias.to(self.dtype)


class RowParallelLinear(_Linear):
    """``[n_in / M] -> [n_out]``: weight ``[n_out, n_in / M]``; the
    partial products summed over the group (Megatron's ``g``), then the
    replicated bias ``[n_out]``."""

    def __init__(self, n_in, n_out, group=None, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        local = _split(n_in, group, "row-parallel width")
        super().__init__((n_out, local), n_out, dtype, param_dtype, device)
        self.group = group
        self.fan_in = n_in
        set_shard(self.weight, Shard(1))

    def forward(self, y):
        part = torch.matmul(y.to(self.dtype),
                            self.weight.to(self.dtype).t())
        return psum_combine(part, self.group) + self.bias.to(self.dtype)


class TPMultiHeadAttention(nn.Module):
    """Self-attention over the rank's ``n_head / M`` heads: column-parallel
    ``c_attn`` (its q, k and v columns), row-parallel ``c_proj``.
    ``use_flash`` runs K1-K3; else scores in f32 scaled by 1/sqrt(D),
    masked with the f32 minimum, softmax, cast back (JAX's dense path).
    ``dropout_rate`` / ``dropout_seed`` drop attention probs with the
    counter hash at the heads' global coordinates (``head_offset`` the
    rank's first head plus ``row_offset * n_head``)."""

    def __init__(self, n_embd, n_head, group=None, causal=True,
                 use_flash=False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.n_head, self.causal, self.use_flash = n_head, causal, use_flash
        self.dtype = dtype
        self.group = group
        self.h_local = _split(n_head, group, "n_head")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.c_attn = ColumnParallelLinear(n_embd, 3 * n_embd, group,
                                           groups=3, **kw)
        self.c_proj = RowParallelLinear(n_embd, n_embd, group, **kw)

    def head_offset(self, row_offset=0):
        rank = 0 if self.group is None else self.group.rank
        return row_offset * self.n_head + rank * self.h_local

    def forward(self, x, dropout_rate=0.0, dropout_seed=None, row_offset=0):
        from deepspeed_tpu_torch.ops.flash_attention import (
            dense_attention, flash_attention)
        B, T, C = x.shape
        D = C // self.n_head
        q, k, v = self.c_attn(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, T, self.h_local, D) for t in (q, k, v))
        kw = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                  dropout_head_offset=self.head_offset(row_offset),
                  dropout_num_heads=self.n_head)
        if self.use_flash:
            y = flash_attention(q, k, v, causal=self.causal, **kw)
        elif dropout_rate > 0.0:
            y = dense_attention(q, k, v, causal=self.causal, **kw)
        else:
            att = torch.einsum("bthd,bshd->bhts", q, k).float() * \
                (1.0 / math.sqrt(D))
            if self.causal:
                mask = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                             device=x.device))
                att = torch.where(mask, att, torch.finfo(torch.float32).min)
            att = torch.softmax(att, dim=-1).to(self.dtype)
            y = torch.einsum("bhts,bshd->bthd", att, v)
        return self.c_proj(y.to(self.dtype).reshape(B, T, self.h_local * D))


class TPMLP(nn.Module):
    """Column-parallel ``c_fc``, tanh GELU, row-parallel ``c_proj``."""

    def __init__(self, n_embd, group=None, hidden_mult=4,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.c_fc = ColumnParallelLinear(n_embd, hidden_mult * n_embd,
                                         group, **kw)
        self.c_proj = RowParallelLinear(hidden_mult * n_embd, n_embd, group,
                                        **kw)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class TPTransformerBlock(nn.Module):
    """Pre-LN block of the TP pieces; LayerNorms (flax's: eps 1e-6, fp32
    statistics) and the residual stream replicated."""

    def __init__(self, n_embd, n_head, group=None, causal=True,
                 use_flash=False, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, LayerNorm
        cfg = GPT2Config(dtype=dtype, param_dtype=param_dtype)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln_1 = LayerNorm(n_embd, cfg, device=device)
        self.attn = TPMultiHeadAttention(n_embd, n_head, group, causal,
                                         use_flash, **kw)
        self.ln_2 = LayerNorm(n_embd, cfg, device=device)
        self.mlp = TPMLP(n_embd, group, **kw)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def load_sharded(module, state, group=None):
    """Load a whole ``state_dict`` into a TP module: each leaf cut to this
    rank's piece by the module's :func:`partition_specs`."""
    specs = partition_specs(module)
    rank, size = (0, 1) if group is None else (group.rank, group.size)
    module.load_state_dict({n: shard_tensor(v, specs.get(n), rank, size)
                            for n, v in state.items()})
    return module
