"""Sequence parallelism: ring attention and Ulysses (port of
``deepspeed_tpu/parallel/sequence.py``).

Every function takes the seq :class:`~deepspeed_tpu_torch.parallel.mesh.
AxisGroup` where JAX takes the ``seq`` axis name (None, or a group of
one, is one rank: no collective runs).

- **Ring attention** (:func:`ring_attention_local`, JAX ``:49-130``): q
  stays put, k and v rotate around the group with n-1 ``ppermute``\\ s,
  and the online softmax accumulates in f32. With ``causal`` a chunk
  that lies wholly in the future skips its arithmetic but not its
  rotation: every rank sends every hop. JAX differentiates the scan;
  here the backward is written out (:class:`_Ring`): it recomputes each
  chunk's probabilities from the forward's row logsumexp while k and v
  travel the same ring again, their gradients accumulating in f32 as
  they travel, and one last hop brings each chunk's gradient home. So
  the backward's collectives run in one fixed order on every rank. A
  chunk's rows go 1024 at a time (the ``[B, H, rows, T/n]`` scores and
  dropout hash stay bounded at long sequences).
  Dropout is the counter hash at global ``(b * H + h, q_pos, k_pos)``
  coordinates (``ops/flash_attention.py:dropout_multiplier``), the data
  rank folded into the seed when a data group is given.
- **Ulysses** (:func:`ulysses_attention_local`, JAX ``:133-210``): a
  tiled all-to-all ``[B, T/n, H, D] -> [B, T, H/n, D]``, the port's
  :func:`~deepspeed_tpu_torch.ops.flash_attention.flash_attention` (the
  K1-K3 kernels on CUDA tensors) over the whole sequence, and the
  all-to-all back. The seed is folded with the seq rank, then with the
  data rank; under an active ``ulysses`` overlap plan the heads are
  split into groups, each folding its index into the seed and
  exchanging through ``all_to_all_overlap``.

The standalone :func:`ring_attention` and :func:`ulysses_attention` take
global ``[B, T, H, D]`` tensors and the mesh's groups, and return this
rank's ``[data, seq]`` block.
"""

import torch

from deepspeed_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    dropout_multiplier,
    flash_attention,
    fold_in_seed,
)
from deepspeed_tpu_torch.parallel.collectives import (
    all_to_all_overlap,
    overlap_plan,
    ppermute,
)


def _check_dropout_args(dropout_rate, dropout_seed):
    if dropout_rate:
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")


def _size_rank(group):
    if group is None or not group.active:
        return 1, 0 if group is None else group.rank
    return group.size, group.rank


class _Ring(torch.autograd.Function):
    """The ring's forward (JAX ``ring_attention_local``) and its
    backward (module docstring). Each chunk's rows are taken
    ``ROWS`` at a time, which bounds the ``[B, H, rows, T_local]``
    temporaries (the scores, the dropout hash) without changing any
    row's arithmetic."""

    ROWS = 1024

    @staticmethod
    def _chunk(ctx, qf, kf, src, r0):
        """Rows ``[r0, r0 + rows)`` of chunk ``src``'s scores ``[B, H,
        rows, S]`` (f32, causal-masked at global positions) and their
        dropout multiplier (or None)."""
        T = kf.shape[1]
        dev = qf.device
        k_pos = src * T + torch.arange(T, device=dev)
        q_pos = ctx.q_pos[r0:r0 + qf.shape[1]]
        s = torch.einsum("bthd,bshd->bhts", qf, kf)
        if ctx.causal:
            s = torch.where(k_pos[None, :] <= q_pos[:, None], s,
                            DEFAULT_MASK_VALUE)
        mult = None
        if ctx.rate > 0.0:
            mult = dropout_multiplier(ctx.seed, ctx.bh,
                                      q_pos[None, None, :, None],
                                      k_pos[None, None, None, :], ctx.rate)
        return s, mult

    @staticmethod
    def _rows(T):
        return [(r0, min(r0 + _Ring.ROWS, T))
                for r0 in range(0, T, _Ring.ROWS)]

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale, rate, seed):
        n, idx = _size_rank(group)
        B, T, H, D = q.shape
        dev = q.device
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        ctx.rate, ctx.seed, ctx.n, ctx.idx = rate, seed, n, idx
        ctx.q_pos = idx * T + torch.arange(T, device=dev)
        ctx.bh = (torch.arange(B, device=dev)[:, None] * H +
                  torch.arange(H, device=dev)[None, :])[:, :, None, None]
        qf = q.float() * sm_scale
        acc = torch.zeros(B, H, T, D, dtype=torch.float32, device=dev)
        m = torch.full((B, H, T), float("-inf"), dtype=torch.float32,
                       device=dev)
        l = torch.zeros(B, H, T, dtype=torch.float32, device=dev)
        kc, vc = k, v
        for t in range(n):
            if t:       # every hop runs, a skipped chunk's too
                kc = ppermute(kc, group, 1)
                vc = ppermute(vc, group, 1)
            src = (idx - t) % n
            if causal and src > idx:
                continue        # wholly in the future
            kf, vf = kc.float(), vc.float()
            for r0, r1 in _Ring._rows(T):
                s, mult = _Ring._chunk(ctx, qf[:, r0:r1], kf, src, r0)
                m_old = m[..., r0:r1]
                m_new = torch.maximum(m_old, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m_old - m_new)
                l[..., r0:r1] = l[..., r0:r1] * corr + p.sum(-1)
                if mult is not None:
                    p = p * mult
                acc[:, :, r0:r1] = acc[:, :, r0:r1] * corr[..., None] + \
                    torch.einsum("bhts,bshd->bhtd", p, vf)
                m[..., r0:r1] = m_new
        # causal rows always see their own chunk, so l > 0 everywhere
        out = (acc / l[..., None]).transpose(1, 2)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, n, idx = ctx.group, ctx.n, ctx.idx
        T = q.shape[1]
        qf = q.float() * ctx.sm_scale
        gf = g.float()
        delta = (gf * out).sum(-1).transpose(1, 2)          # [B, H, T]
        dqf = torch.zeros_like(qf)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(n):
            if t:
                kc = ppermute(kc, group, 1)
                vc = ppermute(vc, group, 1)
                dk = ppermute(dk, group, 1)
                dv = ppermute(dv, group, 1)
            src = (idx - t) % n
            if ctx.causal and src > idx:
                continue
            kf, vf = kc.float(), vc.float()
            for r0, r1 in _Ring._rows(T):
                s, mult = _Ring._chunk(ctx, qf[:, r0:r1], kf, src, r0)
                p = torch.exp(s - lse[..., r0:r1, None])
                pd = p if mult is None else p * mult
                g_rows = gf[:, r0:r1]
                dv = dv + torch.einsum("bhts,bthd->bshd", pd, g_rows)
                dp = torch.einsum("bthd,bshd->bhts", g_rows, vf)
                if mult is not None:
                    dp = dp * mult
                ds = p * (dp - delta[..., r0:r1, None])
                dqf[:, r0:r1] += torch.einsum("bhts,bshd->bthd", ds, kf)
                dk = dk + torch.einsum("bhts,bthd->bshd", ds, qf[:, r0:r1])
        if n > 1:       # the last chunk's gradients back to their owner
            dk = ppermute(dk, group, 1)
            dv = ppermute(dv, group, 1)
        dq = dqf * ctx.sm_scale
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def ring_attention_local(q, k, v, group, causal=True, sm_scale=None,
                         dropout_rate=0.0, dropout_seed=None,
                         data_group=None):
    """Ring attention over ``group`` (JAX ``ring_attention_local``).

    q, k, v: ``[B, T_local, H, D]``, this rank's sequence chunk (chunk r
    of the global sequence on seq rank r). Returns the local ``[B,
    T_local, H, D]`` output, the corresponding slice of full attention
    over the global sequence. ``dropout_rate`` / ``dropout_seed``: the
    hash mask at global sequence coordinates (every seq rank draws the
    same bits for the same element); ``data_group`` (given when a data
    axis is bound) folds the data rank into the seed."""
    _check_dropout_args(dropout_rate, dropout_seed)
    seed = 0
    if dropout_rate:
        seed = int(dropout_seed)
        if data_group is not None:
            seed = fold_in_seed(seed, data_group.rank)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Ring.apply(q, k, v, group, bool(causal), float(sm_scale),
                       float(dropout_rate or 0.0), seed)


def ulysses_attention_local(q, k, v, group, causal=True, sm_scale=None,
                            attn_fn=None, dropout_rate=0.0,
                            dropout_seed=None, data_group=None):
    """Ulysses over ``group`` (JAX ``ulysses_attention_local``).

    q, k, v: ``[B, T_local, H, D]`` seq chunks with H divisible by the
    group size. All-to-all to ``[B, T, H/n, D]``, ``attn_fn`` (default
    :func:`~deepspeed_tpu_torch.ops.flash_attention.flash_attention`) on
    the full sequence, all-to-all back. Dropout goes to ``attn_fn`` with
    the seq rank folded into the seed, then the data rank
    (``data_group``); under an active ``ulysses`` overlap plan the heads
    run in groups, each folding its index into the seed too."""
    _check_dropout_args(dropout_rate, dropout_seed)
    n, rank = _size_rank(group)
    H = q.shape[2]
    assert H % n == 0, f"heads {H} must divide seq-parallel degree {n}"
    if attn_fn is None:
        attn_fn = flash_attention
    kwargs = {}
    if dropout_rate > 0.0:
        seed = fold_in_seed(int(dropout_seed), rank)
        if data_group is not None:
            seed = fold_in_seed(seed, data_group.rank)
        kwargs = {"dropout_rate": dropout_rate, "dropout_seed": seed}

    plan = overlap_plan("ulysses")
    c = 0
    if plan is not None and plan.chunks > 1 and n > 1:
        # groups keep each group's head count divisible by n: the
        # largest divisor of H/n that is <= plan.chunks
        h_loc = H // n
        c = min(plan.chunks, h_loc)
        while c > 1 and h_loc % c:
            c -= 1
    if c > 1:
        h_grp = H // c
        outs = []
        for j in range(c):
            gkw = dict(kwargs)
            if gkw:
                gkw["dropout_seed"] = fold_in_seed(gkw["dropout_seed"], j)
            grp = [all_to_all_overlap(t[:, :, j * h_grp:(j + 1) * h_grp],
                                      group, 2, 1, chunks=c)
                   for t in (q, k, v)]
            og = attn_fn(*grp, causal=causal, sm_scale=sm_scale, **gkw)
            outs.append(all_to_all_overlap(og, group, 1, 2, chunks=c))
        return torch.cat(outs, dim=2)
    out = attn_fn(*(all_to_all_overlap(t, group, 2, 1) for t in (q, k, v)),
                  causal=causal, sm_scale=sm_scale, **kwargs)
    return all_to_all_overlap(out, group, 1, 2)


def _local_block(x, groups):
    """This rank's ``[data, seq]`` block of a global ``[B, T, ...]``."""
    data, seq = groups.axis("data"), groups.axis("seq")
    b, t = x.shape[0] // data.size, x.shape[1] // seq.size
    return x[data.rank * b:(data.rank + 1) * b,
             seq.rank * t:(seq.rank + 1) * t]


def _seq_sharded_call(local_fn, groups, q, k, v):
    data = groups.axis("data")
    return local_fn(*(_local_block(t, groups) for t in (q, k, v)),
                    groups.axis("seq"),
                    data_group=data if data.size > 1 else None)


def ring_attention(q, k, v, groups, causal=True, sm_scale=None,
                   dropout_rate=0.0, dropout_seed=None):
    """Standalone ring attention (JAX ``ring_attention``): q, k, v are
    the global ``[B, T, H, D]`` tensors, ``groups`` the mesh's
    :class:`~deepspeed_tpu_torch.parallel.mesh.MeshGroups`. Returns this
    rank's ``[data, seq]`` block of the output: rows ``[d * B/D, (d+1) *
    B/D)`` of data rank d and positions ``[s * T/S, (s+1) * T/S)`` of seq
    rank s. The data rank is folded into the dropout seed only when the
    data axis has more than one rank, as in JAX."""
    return _seq_sharded_call(
        lambda ql, kl, vl, g, data_group: ring_attention_local(
            ql, kl, vl, g, causal=causal, sm_scale=sm_scale,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
            data_group=data_group), groups, q, k, v)


def ulysses_attention(q, k, v, groups, causal=True, sm_scale=None,
                      attn_fn=None, dropout_rate=0.0, dropout_seed=None):
    """Standalone Ulysses attention (JAX ``ulysses_attention``): as
    :func:`ring_attention`, this rank's ``[data, seq]`` block of the
    output of the global ``[B, T, H, D]`` inputs."""
    return _seq_sharded_call(
        lambda ql, kl, vl, g, data_group: ulysses_attention_local(
            ql, kl, vl, g, causal=causal, sm_scale=sm_scale,
            attn_fn=attn_fn, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, data_group=data_group),
        groups, q, k, v)
