"""Sequence parallelism inside the pipeline: pipe x seq x data (port of
``deepspeed_tpu/parallel/pipe_sp.py``).

The pipeline engine builds and runs its stages inside
:func:`~deepspeed_tpu_torch.parallel.pipe_tp.axis_scope`, which names
the seq and data groups of this process (JAX: the pipeline's
``shard_map``, inside which every mesh axis is manual). Outside a scope
every piece is the dense computation, so one module definition serves
the sharded run and its oracle; inside one at seq 1 it is the same
computation through Ulysses with no collective.

- :class:`SPEmbedLayer` (prologue) embeds the whole micro-batch and
  keeps this rank's token chunk: activations travel the pipeline at
  ``[B, T/n, M]``.
- :class:`SPBlockLayer`: pre-LN (``pipe_tp.layer_norm``, eps 1e-5),
  Ulysses attention over the seq group
  (:func:`~deepspeed_tpu_torch.parallel.sequence.ulysses_attention_local`:
  K1-K3 on the card over ``H/n`` heads), weights replicated. Hidden
  dropout hashes the GLOBAL token coordinate with ``fold_in_seed(seed,
  1000 + sub)``, so it is invariant to the seq split bit for bit;
  attention dropout folds the seq rank in (Ulysses), so it is not. The
  data rank is folded into the layer's seed.
- :class:`SPHeadLayer` (an untied ``[M, V]`` head) and
  :func:`make_sp_token_loss`: the weighted ``(loss_sum, count)`` over
  this rank's chunk, its labels from the FULL micro-batch ids (the last
  token of chunk r is supervised by the first id of chunk r+1). The
  pipeline sums both over ``pipe``, ``data`` and ``seq`` and sums the
  gradients over ``seq`` (``runtime/pipe/engine.py``).

Leaves keep JAX's names and layouts (``qkv`` ``[M, 3M]`` applied as ``h
@ qkv``), so ``parallel/pipe_tp.py:convert_tp_pipe_params`` converts a
JAX SP pipeline's params. ``n_head`` must divide by the seq size.
"""

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.ops.flash_attention import (
    dense_attention,
    dropout_multiplier,
    fold_in_seed,
)
from deepspeed_tpu_torch.parallel.pipe_tp import layer_norm, scope_axis
from deepspeed_tpu_torch.parallel.sequence import ulysses_attention_local

SEQ_AXIS = "seq"


def _seq_info():
    """``(n, idx)`` of the scope's seq group, else ``(1, 0)``."""
    seq = scope_axis(SEQ_AXIS)
    if seq is None:
        return 1, 0
    return seq.size, seq.rank


class SPEmbedLayer(nn.Module):
    """Prologue: token + position embedding of the whole micro-batch,
    sliced to this seq rank's chunk (leaves ``wte`` ``[V, M]``, ``wpe``
    ``[max_pos, M]``, replicated; their gradients are per-chunk partials
    the pipeline sums over seq)."""

    def __init__(self, vocab, d_model, max_pos, ids_key="input_ids"):
        super().__init__()
        self.ids_key = ids_key
        self.wte = nn.Parameter(torch.zeros(vocab, d_model))
        self.wpe = nn.Parameter(torch.zeros(max_pos, d_model))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.wte, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wpe, 0.0, 0.01, generator=generator)

    def forward(self, micro):
        ids = micro[self.ids_key].long()
        T = ids.shape[1]
        x = self.wte[ids] + self.wpe[:T]
        n, idx = _seq_info()
        assert T % n == 0, (
            f"seq len {T} must divide the seq-parallel degree {n}")
        t = T // n
        return x[:, idx * t:(idx + 1) * t]


class SPBlockLayer(nn.Module):
    """Pre-LN causal block on seq-local activations ``[B, T/n, M]``,
    Ulysses attention over the seq group (module docstring)."""

    pipe_context = True

    def __init__(self, d_model, n_head, ffn_mult=4, dropout=0.0,
                 attn_dropout=None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} does not divide by n_head "
                             f"{n_head}")
        M = d_model
        self.d_model, self.n_head, self.ffn = M, n_head, ffn_mult * M
        self.dropout = float(dropout)
        self.attn_dropout = self.dropout if attn_dropout is None \
            else float(attn_dropout)
        shapes = {"ln1_scale": (M,), "ln1_bias": (M,), "ln2_scale": (M,),
                  "ln2_bias": (M,), "qkv": (M, 3 * M), "qkv_b": (3 * M,),
                  "proj": (M, M), "proj_b": (M,), "fc": (M, self.ffn),
                  "fc_b": (self.ffn,), "fc_out": (self.ffn, M),
                  "fc_out_b": (M,)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        with torch.no_grad():
            self.ln1_scale.fill_(1.0)
            self.ln2_scale.fill_(1.0)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for name in ("qkv", "proj", "fc", "fc_out"):
            nn.init.normal_(getattr(self, name), 0.0, 0.02,
                            generator=generator)
        for name in ("qkv_b", "proj_b", "fc_b", "fc_out_b", "ln1_bias",
                     "ln2_bias"):
            getattr(self, name).zero_()
        self.ln1_scale.fill_(1.0)
        self.ln2_scale.fill_(1.0)

    def _attention(self, q, k, v, rate, seed):
        seq = scope_axis(SEQ_AXIS)
        if seq is not None:
            return ulysses_attention_local(q, k, v, seq, causal=True,
                                           dropout_rate=rate,
                                           dropout_seed=seed)
        # outside the pipeline's scope: full-sequence causal attention
        return dense_attention(q, k, v, causal=True, dropout_rate=rate,
                               dropout_seed=seed)

    def _hidden_drop(self, t, seed, sub):
        """Hidden dropout at GLOBAL (row, token, feature) coordinates:
        the mask a token draws does not depend on which seq rank holds
        it. The seed is re-mixed per sublayer so these coordinates do
        not collide with the attention masks'."""
        B, t_loc, M = t.shape
        _, idx = _seq_info()
        dev = t.device
        pos = idx * t_loc + torch.arange(t_loc, device=dev)
        return t * dropout_multiplier(
            fold_in_seed(seed, 1000 + sub),
            torch.arange(B, device=dev)[:, None, None], pos[None, :, None],
            torch.arange(M, device=dev)[None, None, :],
            self.dropout).to(t.dtype)

    def forward(self, x, ctx=None):
        B, t_loc, M = x.shape
        H = self.n_head
        D = M // H
        dtype = x.dtype
        rate, seed = 0.0, None
        hidden = lambda t, sub: t       # noqa: E731
        if ctx is not None and ctx.seed is not None and (
                self.dropout > 0.0 or self.attn_dropout > 0.0):
            seed = fold_in_seed(ctx.seed, ctx.layer or 0)
            data = scope_axis("data")
            if data is not None:        # batch shards draw their own
                seed = fold_in_seed(seed, data.rank)
            rate = self.attn_dropout
            if self.dropout > 0.0:
                hidden = lambda t, sub: self._hidden_drop(  # noqa: E731
                    t, seed, sub)

        def dense(h, w, b):
            return torch.matmul(h, w.to(dtype)) + b.to(dtype)

        h = layer_norm(x, self.ln1_scale, self.ln1_bias).to(dtype)
        q, k, v = dense(h, self.qkv, self.qkv_b).split(M, dim=-1)
        y = self._attention(q.reshape(B, t_loc, H, D),
                            k.reshape(B, t_loc, H, D),
                            v.reshape(B, t_loc, H, D), rate, seed)
        x = x + hidden(dense(y.reshape(B, t_loc, M), self.proj,
                             self.proj_b), 1)
        h2 = layer_norm(x, self.ln2_scale, self.ln2_bias).to(dtype)
        ff = F.gelu(dense(h2, self.fc, self.fc_b), approximate="tanh")
        return x + hidden(dense(ff, self.fc_out, self.fc_out_b), 2)


class SPHeadLayer(nn.Module):
    """Epilogue: ``[B, T/n, M]`` -> seq-local logits ``[B, T/n, V]``."""

    def __init__(self, d_model, vocab):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_model, vocab))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        nn.init.normal_(self.w, 0.0, 0.02, generator=generator)

    def forward(self, x):
        return torch.matmul(x, self.w.to(x.dtype))


def make_sp_token_loss(ids_key="input_ids"):
    """Weighted next-token cross-entropy over this rank's chunk:
    ``(loss_sum, count)`` (module docstring); only the global last token
    is ignored."""

    def loss(logits, micro):
        ids = micro[ids_key]
        B, T = ids.shape
        n, idx = _seq_info()
        t = T // n
        labels = torch.cat([ids[:, 1:], torch.full(
            (B, 1), -100, dtype=ids.dtype, device=ids.device)], dim=1)
        labels = labels[:, idx * t:(idx + 1) * t]
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        lp = torch.log_softmax(logits.float(), dim=-1)
        tok = -torch.gather(lp, -1, safe[..., None])[..., 0]
        tok = torch.where(valid, tok, 0.0)
        return tok.sum(), valid.sum().float()

    return loss


def sp_pipeline_module(vocab, d_model, n_head, seq_len, n_blocks=2,
                       num_stages=None, ids_key="input_ids", dropout=0.0,
                       attn_dropout=None):
    """The PipelineModule of the SP layers (JAX ``sp_pipeline_module``):
    embed -> ``n_blocks`` x :class:`SPBlockLayer` -> head, with
    :func:`make_sp_token_loss`."""
    from deepspeed_tpu_torch.runtime.pipe.module import (
        LayerSpec, PipelineModule)
    return PipelineModule(
        layers=[LayerSpec(SPEmbedLayer, vocab, d_model, seq_len, ids_key)] +
        [LayerSpec(SPBlockLayer, d_model, n_head, dropout=dropout,
                   attn_dropout=attn_dropout) for _ in range(n_blocks)] +
        [LayerSpec(SPHeadLayer, d_model, vocab)],
        num_stages=num_stages, loss_fn=make_sp_token_loss(ids_key))
