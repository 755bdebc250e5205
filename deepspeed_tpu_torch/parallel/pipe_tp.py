"""Tensor parallelism inside the pipeline (port of
``deepspeed_tpu/parallel/pipe_tp.py``): pipe x model x data.

The layer functions take the model :class:`~deepspeed_tpu_torch.parallel.
mesh.AxisGroup` (None, or a group of one, runs replicated with no
collective, as JAX's outside ``manual_axes``):

- :func:`replicated_input`: Megatron ``f`` on a replicated tensor that
  column-parallel compute consumes (a chunked ring backward under the
  ``column_parallel`` overlap site);
- :func:`column_parallel` / :func:`row_parallel`: the conjugate matmul
  pair (row: one ``psum_combine``, or under the ``row_parallel`` overlap
  site :func:`~deepspeed_tpu_torch.parallel.collectives.
  matmul_psum_overlap`);
- :func:`split_qkv_heads` and :func:`local_attention`: the head-major
  QKV packing (each rank's rows hold whole heads) and attention over the
  local heads, K1-K3 under ``use_flash``, dropout hashed at the heads'
  global coordinates (``head_offset``, ``n_heads_global``).

:class:`TPBlockLayer` (GPT-2 style, pre-LN, causal) and
:class:`TPBertBlockLayer` (post-LN, bidirectional) are built from them
and hold JAX's leaves: ``mp_*`` leaves carry their shard dim first and
hold only the rank's rows (``mp_qkv`` ``[n_head_local * 3 * D, M]``,
``mp_proj`` ``[n_head_local * D, M]``, ``mp_fc`` / ``mp_fc_out``
``[ffn_local, M]``, ``mp_qkv_b`` / ``mp_fc_b``); the LayerNorms and the
biases added after a row-parallel sum are replicated. A block takes its
model group when it is built: the pipeline engine builds the stages
inside :func:`axis_scope` (every stage of a (data, model)
coordinate in a process, or one process a stage rank); built outside
one, a block holds the whole leaves and runs replicated. Dropout: the attention masks hash
global head coordinates (a sharded run draws the unsharded run's masks
bit for bit) and the hidden masks come from the stage's generator,
which every rank of a model group seeds alike.

:func:`tp_pipeline_module` wires embed -> ``n_blocks`` TP blocks -> head
with JAX's masked next-token loss in the ``(loss_sum, count)`` form.

fp8 (the ``fp8`` config block; the pipeline engine runs its stages in
a stateless ``ops.fp8.fp8_scope``): each rank's local GEMM takes JAX's
current scaling (:func:`_local_dot`, ``fp8_dot_general``'s manual path:
both operands qdq'd to ``float8_e4m3fn`` at their current amax, the
output's cotangent to ``float8_e5m2``), sites ``column_parallel`` and
``row_parallel``; an overlapped row-parallel product qdq's its operands
before the ring and its output's cotangent after (:func:`_fp8_bracket`).
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops import fp8 as fp8_ops
from deepspeed_tpu_torch.ops.flash_attention import (
    current_global_rows,
    fold_in_seed,
    hidden_dropout,
)
from deepspeed_tpu_torch.parallel.collectives import (
    matmul_psum_overlap,
    overlap_plan,
    psum_combine,
    psum_grad,
)
from deepspeed_tpu_torch.parallel.tensor_parallel import (
    Shard,
    set_shard,
    shard_tensor,
)

_AXES = contextvars.ContextVar("pipe_tp_axes", default={})


@contextlib.contextmanager
def axis_scope(**axes):
    """Layers built or run inside the block take ``axes`` (``AxisGroup``
    s by mesh axis name) as their groups: the pipeline engine builds its
    stages in it, and runs them in it (the counterpart of JAX's
    ``shard_map``, inside which every mesh axis is manual)."""
    token = _AXES.set(dict(_AXES.get(), **axes))
    try:
        yield
    finally:
        _AXES.reset(token)


def current_axis(name="model"):
    """The group layers built now take for axis ``name``, or None (no
    scope, or a group of one)."""
    axis = _AXES.get().get(name)
    return axis if axis is not None and axis.size > 1 else None


def scope_axis(name):
    """The scope's group for axis ``name`` of any size, or None outside a
    scope that names it (JAX ``axis_is_manual``)."""
    return _AXES.get().get(name)


def _local_dot(x, w, site):
    """``x @ w`` (``w`` ``[in, out]``), through JAX's current scaling
    when the active fp8 scope enables ``site``."""
    if fp8_ops.site_active(site):
        return fp8_ops.fp8_linear(x, w.t(), site)
    return torch.matmul(x, w)


def _fp8_bracket(x, w, site):
    """The operands of an overlapped product qdq'd at their current
    amax, and the unquantizer of its output (JAX ``_fp8_bracket``), or
    the operands as they are."""
    if not fp8_ops.site_active(site):
        return x, w, lambda y: y
    m = fp8_ops.scope_margin()
    return fp8_ops.in_qdq_current(x, m), fp8_ops.in_qdq_current(w, m), \
        lambda y: fp8_ops.out_qdq_current(y, m)


def replicated_input(h, group):
    """Megatron ``f``: identity forward, the cotangent summed over
    ``group`` backward (a chunked ring under an active
    ``column_parallel`` overlap plan)."""
    if group is None:
        return h
    plan = overlap_plan("column_parallel")
    if plan is not None and (plan.chunks > 1 or plan.wire_dtype):
        return psum_grad(h, group, chunks=plan.chunks,
                         bidirectional=plan.bidirectional,
                         wire_dtype=plan.wire_dtype,
                         wire_chunk=plan.wire_chunk)
    return psum_grad(h, group)


def column_parallel(h, w, b=None):
    """``h @ w.T`` (+ ``b``) with ``w`` ``[out_local, M]``: no
    communication (the caller applies :func:`replicated_input` once to
    ``h``)."""
    y = _local_dot(h, w.to(h.dtype).t(), "column_parallel")
    return y if b is None else y + b.to(h.dtype)


def row_parallel(y, w, b, group):
    """``y @ w`` with ``w`` ``[in_local, M]``: the partials summed over
    ``group`` (one ``psum_combine``; under an active ``row_parallel``
    overlap plan, :func:`matmul_psum_overlap` in its chunks), then the
    replicated ``b``."""
    w = w.to(y.dtype)
    if group is not None:
        plan = overlap_plan("row_parallel")
        if plan is not None and (plan.chunks > 1 or plan.wire_dtype):
            yq, wq, unq = _fp8_bracket(y, w, "row_parallel")
            part = unq(matmul_psum_overlap(
                yq, wq, group, chunks=plan.chunks,
                bidirectional=plan.bidirectional,
                wire_dtype=plan.wire_dtype, wire_chunk=plan.wire_chunk))
        else:
            part = psum_combine(_local_dot(y, w, "row_parallel"), group)
    else:
        part = _local_dot(y, w, "row_parallel")
    return part if b is None else part + b.to(y.dtype)


def split_qkv_heads(qkv, d_head):
    """Head-major unpack: ``[B, T, h_local * 3 * D]`` -> ``(q, k, v)``,
    each ``[B, T, h_local, D]``."""
    B, T, three_hd = qkv.shape
    h_local = three_hd // (3 * d_head)
    qkv = qkv.reshape(B, T, h_local, 3, d_head)
    return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]


def local_attention(q, k, v, causal, use_flash=False, dropout_rate=0.0,
                    dropout_seed=None, head_offset=0, n_heads_global=None):
    """Attention over the rank's heads (``[B, T, h_local, D]``), K1-K3
    under ``use_flash``, the dropout hash at global head coordinates.
    Returns ``[B, T, h_local * D]``."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        dense_attention, flash_attention)
    B, T, h_local, D = q.shape
    fn = flash_attention if use_flash else dense_attention
    y = fn(q, k, v, causal=causal, dropout_rate=dropout_rate,
           dropout_seed=dropout_seed, dropout_head_offset=head_offset,
           dropout_num_heads=n_heads_global)
    return y.reshape(B, T, h_local * D)


def layer_norm(x, scale, bias, eps=1e-5):
    """JAX ``pipe_tp.layer_norm``: statistics in ``x``'s dtype."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class TPBlockLayer(nn.Module):
    """GPT-2 style pre-LN causal block, tensor parallel over the model
    group it was built in (module docstring). ``n_head`` must divide by
    the group's size."""

    causal = True
    pipe_context = True

    def __init__(self, d_model, n_head, ffn_mult=4, axis_name="model",
                 use_flash=False, dropout=0.0):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} does not divide by n_head "
                             f"{n_head}")
        self.group = current_axis(axis_name)
        M = 1 if self.group is None else self.group.size
        if n_head % M:
            raise ValueError(f"n_head {n_head} does not divide the model "
                             f"axis ({M})")
        self.d_model, self.n_head = d_model, n_head
        self.ffn = ffn_mult * d_model
        self.use_flash, self.dropout = use_flash, float(dropout)
        D = d_model // n_head
        hl = n_head // M
        self.full_shapes = {
            "mp_qkv": (3 * n_head * D, d_model), "mp_qkv_b": (3 * n_head * D,),
            "mp_proj": (n_head * D, d_model), "mp_fc": (self.ffn, d_model),
            "mp_fc_b": (self.ffn,), "mp_fc_out": (self.ffn, d_model)}
        local = {"mp_qkv": (3 * hl * D, d_model), "mp_qkv_b": (3 * hl * D,),
                 "mp_proj": (hl * D, d_model),
                 "mp_fc": (self.ffn // M, d_model),
                 "mp_fc_b": (self.ffn // M,),
                 "mp_fc_out": (self.ffn // M, d_model)}
        for name in ("ln1_scale", "ln1_bias", "proj_b", "ln2_scale",
                     "ln2_bias", "fc_out_b"):
            self.register_parameter(name, nn.Parameter(torch.zeros(
                d_model)))
        for name, shape in local.items():
            p = nn.Parameter(torch.zeros(shape))
            if self.group is not None:
                set_shard(p, Shard(0))
                p.tp_axis = self.group
            self.register_parameter(name, p)
        with torch.no_grad():
            self.ln1_scale.fill_(1.0)
            self.ln2_scale.fill_(1.0)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """N(0, 0.02) kernels drawn whole, in JAX's leaf order, each rank
        keeping its rows; zero biases, unit LayerNorm scales."""
        for name in ("mp_qkv", "mp_proj", "mp_fc", "mp_fc_out"):
            full = torch.empty(self.full_shapes[name])
            nn.init.normal_(full, 0.0, 0.02, generator=generator)
            p = getattr(self, name)
            p.copy_(full if self.group is None else shard_tensor(
                full, Shard(0), self.group.rank, self.group.size))
        for name in ("mp_qkv_b", "mp_fc_b", "proj_b", "fc_out_b",
                     "ln1_bias", "ln2_bias"):
            getattr(self, name).zero_()
        self.ln1_scale.fill_(1.0)
        self.ln2_scale.fill_(1.0)

    def reference_leaves(self):
        """The block's leaves in JAX's flat order (its keys sorted), none
        transposed: the order 1-bit Adam compresses a stage's body in
        (``runtime/fp16/onebit_adam.py``)."""
        return [(name, False) for name in
                sorted(n for n, _ in self.named_parameters())]

    def _drop_ctx(self, ctx):
        """``(rate, attention seed, head offset, hidden drop)``: the
        attention seed keyed by the body layer's global index, the head
        offset the global rows' and this rank's first head; the hidden
        masks from the stage's generator (seeded alike on every model
        rank, apart on every data rank)."""
        if ctx is None or ctx.seed is None or self.dropout == 0.0:
            return 0.0, None, 0, lambda t: t
        rank = 0 if self.group is None else self.group.rank
        hl = self.mp_qkv.shape[0] // (3 * (self.d_model // self.n_head))
        offset = current_global_rows()[0] * self.n_head + rank * hl
        seed = fold_in_seed(ctx.seed, ctx.layer)
        return self.dropout, seed, offset, \
            lambda t: hidden_dropout(t, self.dropout, ctx.generator)

    def _attention(self, h, drop):
        rate, seed, offset, _ = drop
        D = self.d_model // self.n_head
        qkv = column_parallel(replicated_input(h, self.group), self.mp_qkv,
                              self.mp_qkv_b)
        q, k, v = split_qkv_heads(qkv, D)
        y = local_attention(q, k, v, causal=self.causal,
                            use_flash=self.use_flash, dropout_rate=rate,
                            dropout_seed=seed, head_offset=offset,
                            n_heads_global=self.n_head)
        return row_parallel(y, self.mp_proj, self.proj_b, self.group)

    def _mlp(self, h):
        ff = F.gelu(column_parallel(replicated_input(h, self.group),
                                    self.mp_fc, self.mp_fc_b),
                    approximate="tanh")
        return row_parallel(ff, self.mp_fc_out, self.fc_out_b, self.group)

    def forward(self, x, ctx=None):
        drop = self._drop_ctx(ctx)
        dtype = x.dtype
        h = layer_norm(x, self.ln1_scale, self.ln1_bias).to(dtype)
        x = x + drop[3](self._attention(h, drop))
        h2 = layer_norm(x, self.ln2_scale, self.ln2_bias).to(dtype)
        return x + drop[3](self._mlp(h2))


class TPBertBlockLayer(TPBlockLayer):
    """BERT style post-LN bidirectional block from the same pieces and
    leaves (``ln1`` after attention, ``ln2`` after the FFN)."""

    causal = False

    def forward(self, x, ctx=None):
        drop = self._drop_ctx(ctx)
        dtype = x.dtype
        x = layer_norm(x + drop[3](self._attention(x, drop)),
                       self.ln1_scale, self.ln1_bias).to(dtype)
        return layer_norm(x + drop[3](self._mlp(x)), self.ln2_scale,
                          self.ln2_bias).to(dtype)


class _Embed(nn.Module):
    def __init__(self, vocab, d_model, ids_key, carry_aux=False):
        super().__init__()
        self.ids_key, self.carry_aux = ids_key, carry_aux
        self.emb = nn.Parameter(torch.zeros(vocab, d_model))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.emb, 0.0, 0.1, generator=generator)

    def forward(self, micro):
        h = self.emb[micro[self.ids_key]]
        if self.carry_aux:      # an MoE body's (hidden, aux) activations
            return h, torch.zeros((), dtype=torch.float32, device=h.device)
        return h


class _Head(nn.Module):
    def __init__(self, vocab, d_model):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_model, vocab))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.w, 0.0, 0.1, generator=generator)

    def forward(self, x):
        if isinstance(x, tuple):
            x, aux = x
            return torch.matmul(x, self.w), aux
        return torch.matmul(x, self.w)


def _next_token_loss(ids_key):
    def loss(logits, micro):
        aux = None
        if isinstance(logits, tuple):
            logits, aux = logits
        ids = micro[ids_key]
        B, _ = ids.shape
        labels = torch.cat([ids[:, 1:], torch.full(
            (B, 1), -100, dtype=ids.dtype, device=ids.device)], dim=1)
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        lp = torch.log_softmax(logits.float(), dim=-1)
        tok = -torch.gather(lp, -1, safe[..., None])[..., 0]
        tok = torch.where(valid, tok, 0.0)
        count = valid.sum().float()
        if aux is not None:     # the mean loss plus the carried aux
            return tok.sum() + aux * count, count
        return tok.sum(), count
    return loss


def tp_pipeline_module(vocab, d_model, n_head, seq_len, n_blocks=2,
                       num_stages=None, ids_key="input_ids",
                       block_cls=TPBlockLayer, carry_aux=False, **block_kw):
    """The dp x pp x tp PipelineModule (JAX ``tp_pipeline_module``): embed
    -> ``n_blocks`` x ``block_cls`` -> head, the masked next-token loss
    ``(loss_sum, count)`` (the last position ignored). ``block_kw``
    (``use_flash``, ``dropout``; ``moe`` for ``parallel/pipe_tp_moe.py:
    TPMoEBlockLayer``) goes to every block. ``carry_aux`` makes the
    activations ``(hidden, aux)`` tuples from a zero aux, for MoE blocks
    to add their Switch loss to; the loss is then the token mean plus
    the aux."""
    from deepspeed_tpu_torch.runtime.pipe.module import (
        LayerSpec, PipelineModule)
    return PipelineModule(
        layers=[LayerSpec(_Embed, vocab, d_model, ids_key, carry_aux)] +
        [LayerSpec(block_cls, d_model, n_head, **block_kw)
         for _ in range(n_blocks)] +
        [LayerSpec(_Head, vocab, d_model)],
        num_stages=num_stages, loss_fn=_next_token_loss(ids_key))


def convert_tp_pipe_params(params):
    """JAX ``PipelineParts.params`` of a TP pipeline (nested mappings of
    numpy arrays) in the port's pipe layout: each leaf's path joined with
    dots (``prologue.layer_0.emb``, ``body.mp_qkv`` ``[S, L/S, ...]``,
    ``epilogue.layer_0.w``), fp32 CPU tensors, whole. The leaves keep
    JAX's layout (``mp_*`` shard dim first)."""
    import numpy as np
    out = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if hasattr(v, "items"):
                walk(name, v)
            else:
                out[name] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk("", params)
    return out

