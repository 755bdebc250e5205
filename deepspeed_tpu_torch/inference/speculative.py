"""Self-speculative decoding: truncated-depth draft + one-shot verify
(port of ``deepspeed_tpu/inference/speculative.py``).

The draft is the SAME network cut short — the first ``draft_layers``
blocks, then the usual ``ln_f`` + tied head
(``GPT2LMHead(truncate_layers=...)``) — so there is no second weight
set, and the draft shares the KV cache up to its own layers.

A speculative round at row position ``p`` with pending token ``t0``:

1. **draft** (``j`` calls of one program): feed ``t0`` at ``p``, sample
   ``d1``; feed ``d1`` at ``p+1``, sample ``d2``; … Each call runs the
   truncated forward (flash decode when the engine serves flash) and
   writes the draft layers' KV at its position.
2. **verify** (ONE full-depth call, dense attention): teacher-force
   ``[t0, d1..dj]`` (padded to the static width ``k+1``) at positions
   ``p..p+k``. Verify writes every layer's KV for the whole window, so
   it overwrites whatever the draft wrote there.
3. **accept** (on the device, no host round trip): the longest draft
   prefix that matches. Greedy: exact argmax match. Sampled: the
   rejection-sampling rule — accept ``d_{i+1}`` when ``u_i *
   q_i(d_{i+1}) <= p_i(d_{i+1})`` under the same temperature / top-k /
   top-p filters, with the correction drawn from the normalized
   residual ``max(p - q, 0)``. ``m`` accepted drafts emit ``m+1``
   tokens, so every round makes progress.

**Rollback is bookkeeping.** Rejected-tail KV (ring slots / paged
slots past ``p+m``) is left stale: the next round rewrites every slot
it reads before reading it, and the position mask hides everything
past the query position; a paged row's writes past its allocated pages
land on the trash page.

The program contract grows from 2 to **3** — prefill, draft, verify —
held warmup-to-drain; the plain decode program runs 0 times in a
speculative serve. Degenerate configs (``k == 0`` or ``draft_layers >=
n_layer``) build no decoder and fall back to the 2-program path.
Random draws come from the engine's ``torch.Generator``: they cannot
match the JAX package's ``jax.random`` draws, so only greedy streams
compare across the two packages.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.inference.engine import _cfg_get, _signature
from deepspeed_tpu_torch.inference.sampling import (
    filtered_logits,
    sample_logits,
)

DEFAULT_DRAFT_LAYERS = 0        # 0 = auto: n_layer // 2
DEFAULT_SPECULATIVE_K = 4


def _emit_tokens(tokens, acc, corr):
    """The emitted-token block: slot ``t < acc`` carries the accepted
    draft ``d_{t+1}``, slot ``t == acc`` the correction/bonus, later
    slots are dead padding the host never reads."""
    B, k1 = tokens.shape
    pos = torch.arange(k1, device=tokens.device)[None, :]
    shifted = torch.cat(
        [tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                    device=tokens.device)], dim=1)
    acc = acc[:, None]
    out = torch.where(pos < acc, shifted,
                      torch.where(pos == acc, corr[:, None].to(tokens.dtype),
                                  torch.zeros_like(shifted)))
    return out.to(torch.int32)


def _accepted(ok):
    """Length of each row's all-True prefix of ``ok`` ``[B, k]``."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)


def greedy_accept(pred, tokens, draft_len):
    """Greedy verify-accept. ``pred`` ``[B, k+1]`` argmax of the
    teacher-forced full-depth logits; ``tokens`` ``[B, k+1]`` =
    ``[pending, d1..dj, pad]``; ``draft_len`` ``[B]`` clamps how many
    drafts are real (padding can never be accepted). Returns
    ``(acc_len [B], out_tokens [B, k+1])``: ``acc_len`` accepted
    drafts, so ``acc_len + 1`` tokens emit (the slot at ``acc_len`` is
    the correction, or the bonus token when everything matched)."""
    k = tokens.shape[1] - 1
    i = torch.arange(k, device=tokens.device)[None, :]
    ok = (i < draft_len[:, None]) & (pred[:, :-1] == tokens[:, 1:])
    acc = _accepted(ok)
    corr = pred.gather(1, acc[:, None].long())[:, 0]
    return acc, _emit_tokens(tokens, acc, corr)


def rejection_accept(probs, tokens, draft_len, q_dists, generator):
    """Rejection-sampling verify-accept, vectorized.

    ``probs`` ``[B, k+1, V]``: verify (target) probabilities under the
    serving filters; ``q_dists`` ``[B, k, V]``: the draft distributions
    each ``d_{i+1}`` was sampled from (zeros past ``draft_len`` — a zero
    q never wins an accept test). Accept ``d_{i+1}`` iff ``u_i *
    q_i(d_{i+1}) <= p_i(d_{i+1})``; the correction at the first
    rejection samples the normalized residual ``max(p - q, 0)``
    (falling back to ``p`` when the residual mass underflows), and the
    all-accepted bonus slot sees q == 0, so its residual is ``p_j``.
    Draws come from ``generator``. Returns ``(acc_len, out_tokens)``."""
    B, k1, V = probs.shape
    k = k1 - 1
    u = torch.rand((B, k), generator=generator, device=probs.device)
    drafts = tokens[:, 1:].long()
    p_d = probs[:, :k].gather(2, drafts[..., None])[..., 0]
    q_d = q_dists.gather(2, drafts[..., None])[..., 0]
    i = torch.arange(k, device=probs.device)[None, :]
    ok = (i < draft_len[:, None]) & (u * q_d <= p_d)
    acc = _accepted(ok)
    idx = acc.long()[:, None, None].expand(B, 1, V)
    p_m = probs.gather(1, idx)[:, 0]
    q_pad = torch.cat([q_dists, torch.zeros((B, 1, V), dtype=q_dists.dtype,
                                            device=q_dists.device)], dim=1)
    q_m = q_pad.gather(1, idx)[:, 0]
    residual = torch.clamp(p_m - q_m, min=0.0)
    mass = residual.sum(dim=-1, keepdim=True)
    corr_probs = torch.where(mass > 1e-9, residual, p_m)
    corr = torch.multinomial(corr_probs, 1, generator=generator)[:, 0]
    return acc, _emit_tokens(tokens, acc, corr)


class SpeculativeDecoder:
    """The draft-step and verify-accept programs plus their host
    bookkeeping, hung off an :class:`InferenceEngine` as
    ``engine.speculative``. Shares the engine's model, cache and
    sampling generator: it adds programs, not state."""

    def __init__(self, engine, k, draft_layers, min_accept_to_grow=0.0):
        n_layer = engine.model.config.n_layer
        if k < 1:
            raise ValueError(f"speculative k must be >= 1, got {k}")
        if not 0 < draft_layers < n_layer:
            raise ValueError(
                f"speculative draft_layers must be in 1..{n_layer - 1} "
                f"(0 < draft_layers < n_layer), got {draft_layers}")
        if k + 1 >= engine.max_seq:
            raise ValueError(
                f"speculative k={k} leaves no room in max_seq="
                f"{engine.max_seq} (need k + 1 < max_seq)")
        self.engine = engine
        self.k = int(k)
        self.draft_layers = int(draft_layers)
        self.min_accept_to_grow = float(min_accept_to_grow)
        if self.min_accept_to_grow < 0:
            raise ValueError(
                f"speculative min_accept_to_grow must be >= 0, got "
                f"{min_accept_to_grow}")
        # adaptive draft length: a host-side controller over the [B]
        # draft_len input — j is data, so varying it changes no shape
        self._j = self.k
        self.rounds = 0
        self.row_rounds = 0             # sum of active rows over rounds
        self.accepted_total = 0         # accepted DRAFT tokens
        self.emitted_total = 0          # tokens emitted (drafts + corrections)
        self.drafted_total = 0          # draft tokens proposed
        self._signatures = {"draft": set(), "verify": set()}

    # -- the two programs ---------------------------------------------------

    def _page_args(self, page_tables):
        return () if page_tables is None else (page_tables,)

    @torch.no_grad()
    def _draft_fn(self, tokens, positions, page_tables):
        eng = self.engine
        self._signatures["draft"].add(_signature(
            tokens, positions, *self._page_args(page_tables)))
        logits, _ = eng.model(
            tokens[:, None], positions=positions[:, None],
            kv_cache=eng.cache, attn_impl=eng.attention_impl,
            attn_block_k=eng.attention_block_k, kv_page_table=page_tables,
            truncate_layers=self.draft_layers)
        logits = logits[:, 0].float()
        nxt = sample_logits(logits, eng._generator,
                            temperature=eng.temperature, top_k=eng.top_k,
                            top_p=eng.top_p)
        if eng.temperature == 0.0:
            # greedy: accept is an exact match, no draft distribution
            return nxt, None
        q = torch.softmax(filtered_logits(logits, eng.temperature, eng.top_k,
                                          eng.top_p), dim=-1)
        return nxt, q

    @torch.no_grad()
    def _verify_fn(self, tokens, positions, draft_len, q_dists, page_tables):
        eng = self.engine
        self._signatures["verify"].add(_signature(
            tokens, positions, *self._page_args(page_tables), draft_len,
            q_dists))
        # always dense: the flash-decode kernels take one query per row;
        # the dense path's position mask handles T = k+1
        logits, _ = eng.model(
            tokens, positions=positions, kv_cache=eng.cache,
            attn_impl="dense", attn_block_k=eng.attention_block_k,
            kv_page_table=page_tables)
        logits = logits.float()
        if eng.temperature == 0.0:
            pred = torch.argmax(logits, dim=-1).to(torch.int32)
            return greedy_accept(pred, tokens, draft_len)
        probs = torch.softmax(filtered_logits(logits, eng.temperature,
                                              eng.top_k, eng.top_p), dim=-1)
        return rejection_accept(probs, tokens, draft_len, q_dists,
                                eng._generator)

    # -- host API -----------------------------------------------------------

    def draft_len(self):
        """Current global draft length j (1..k) for the next round."""
        return self._j

    def observe(self, active_rows, drafted, accepted_drafts, emitted):
        """Per-round controller + counters. ``drafted`` / ``accepted_
        drafts`` count DRAFT tokens proposed/accepted over the round's
        ``active_rows``; ``emitted`` counts every token the scheduler
        consumed (accepted drafts + one correction/bonus per row). With
        ``min_accept_to_grow > 0`` the draft length grows by one toward
        k while the round's mean acceptance clears the threshold and
        shrinks (floor 1) when it doesn't; the default 0.0 pins j = k."""
        self.rounds += 1
        self.row_rounds += int(active_rows)
        self.drafted_total += int(drafted)
        self.accepted_total += int(accepted_drafts)
        self.emitted_total += int(emitted)
        if self.min_accept_to_grow > 0 and active_rows:
            mean = accepted_drafts / float(active_rows)
            if mean >= self.min_accept_to_grow:
                self._j = min(self.k, self._j + 1)
            else:
                self._j = max(1, self._j - 1)

    def _tables(self, page_tables):
        eng = self.engine
        if eng.kv_layout != "paged":
            return None
        if page_tables is None:
            raise ValueError("paged speculation requires page_tables")
        return eng._tensor(page_tables)

    def draft(self, tokens, positions, page_tables=None):
        """One draft step: ``[max_batch]`` tokens/positions in,
        ``(next_tokens, q_dist_or_None)`` out (numpy). ``q`` is the
        filtered draft distribution each token was sampled from (None
        for greedy engines)."""
        eng = self.engine
        nxt, q = self._draft_fn(eng._tensor(tokens), eng._tensor(positions),
                                self._tables(page_tables))
        return nxt.cpu().numpy(), None if q is None else q.cpu().numpy()

    def _q_arg(self, q_dists):
        eng = self.engine
        if eng.temperature == 0.0:
            # greedy verify never reads q; a fixed tiny dummy keeps the
            # signature shape-stable
            return torch.zeros((1,), dtype=torch.float32, device=eng.device)
        return torch.from_numpy(np.asarray(q_dists, np.float32)).to(
            eng.device)

    def verify(self, tokens, positions, draft_len, q_dists=None,
               page_tables=None):
        """The one full-depth verify-accept call. ``tokens`` ``[B,
        k+1]`` = ``[pending, d1..dj, pad]``; ``positions`` ``[B, k+1]``
        their absolute slots; ``draft_len`` ``[B]`` real drafts per row
        (0 for inactive rows); ``q_dists`` ``[B, k, V]`` for sampled
        engines. Returns ``(acc_len [B], out_tokens [B, k+1])`` numpy —
        row i emits ``out_tokens[i, :acc_len[i] + 1]``."""
        eng = self.engine
        acc, out = self._verify_fn(
            eng._tensor(tokens), eng._tensor(positions),
            eng._tensor(draft_len), self._q_arg(q_dists),
            self._tables(page_tables))
        return acc.cpu().numpy(), out.cpu().numpy()

    # -- contract surface ---------------------------------------------------

    def compile_counts(self):
        return {name: len(sigs) for name, sigs in self._signatures.items()}

    def facts(self):
        return {
            "k": self.k,
            "draft_layers": self.draft_layers,
            "n_layer": self.engine.model.config.n_layer,
            "min_accept_to_grow": self.min_accept_to_grow,
            "draft_len": self._j,
            "rounds": self.rounds,
            "row_rounds": self.row_rounds,
            "drafted_total": self.drafted_total,
            "accepted_total": self.accepted_total,
            "emitted_total": self.emitted_total,
            # tokens a row advances per round (the plain loop is 1.0)
            "mean_accepted": (self.emitted_total
                              / float(max(self.row_rounds, 1))),
            # fraction of proposed draft tokens that survived verify
            "draft_efficiency": (self.accepted_total
                                 / float(max(self.drafted_total, 1))),
        }


def build_speculative(engine, config):
    """Parse the ``inference.speculative`` block and hang a
    :class:`SpeculativeDecoder` off the engine — or None when disabled
    OR degenerate (``k == 0`` / ``draft_layers >= n_layer``: a draft as
    deep as the model verifies nothing, so these configs fall back to
    the 2-program path)."""
    spec_cfg = _cfg_get(config, "speculative", None)
    if not spec_cfg:
        return None
    enabled = bool(_cfg_get(spec_cfg, "enabled", True))
    k = int(_cfg_get(spec_cfg, "k", DEFAULT_SPECULATIVE_K))
    draft_layers = int(_cfg_get(spec_cfg, "draft_layers",
                                DEFAULT_DRAFT_LAYERS))
    grow = float(_cfg_get(spec_cfg, "min_accept_to_grow", 0.0))
    if not enabled or k == 0:
        return None
    if k < 0:
        raise ValueError(f"speculative k must be >= 0, got {k}")
    n_layer = engine.model.config.n_layer
    if draft_layers == 0:
        draft_layers = n_layer // 2
    if draft_layers >= n_layer or draft_layers <= 0:
        # degenerate depth (including n_layer == 1): plain decode
        return None
    return SpeculativeDecoder(engine, k, draft_layers,
                              min_accept_to_grow=grow)
