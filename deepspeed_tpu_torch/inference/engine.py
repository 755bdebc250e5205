"""InferenceEngine: the two programs of the serving path (ring layout
of ``deepspeed_tpu/inference/engine.py``).

- **prefill** — one chunk of one prompt: ``[1, prefill_chunk]`` tokens
  at explicit positions, written into cache row ``slot``. Long prompts
  are a host loop over same-shaped chunks.
- **decode** — one token for every row at once: ``[max_batch]``
  tokens at per-row positions over the full cache. Inactive rows
  compute garbage at position 0 and the scheduler ignores them.

Everything shape-varying (live requests, prompt lengths, per-request
``seq_buckets`` budgets) is host-side bookkeeping padded to these two
static shapes. PyTorch runs eagerly and compiles nothing, so
:meth:`compile_counts` counts the distinct input shape/dtype
signatures each program has run with: ``{"prefill": 1, "decode": 1}``
from warmup to drain is the same contract the JAX engine pins with its
jit caches (a later step captures each as a CUDA graph).

The engine runs on ``device`` (default: the GPU, raising when there is
none); the KV cache is updated in place.
"""

import numpy as np
import torch

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.inference.cache import (
    cache_dtype_census,
    init_kv_cache,
    kv_cache_nbytes,
    slice_rows,
    spec_for_model,
    update_rows,
)
from deepspeed_tpu_torch.inference.sampling import sample_logits

DEFAULT_MAX_BATCH = 8
DEFAULT_SEQ_BUCKETS = (128, 512)
DEFAULT_PREFILL_CHUNK = 32
DEFAULT_ATTENTION_BLOCK_K = 128


def _cfg_get(config, key, default):
    if config is None:
        return default
    if isinstance(config, dict):
        v = config.get(key, default)
    else:
        v = getattr(config, key, default)
    return default if v is None else v


def _signature(*tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


class InferenceEngine:
    """Autoregressive decode over a :class:`~deepspeed_tpu_torch.models.
    gpt2.GPT2LMHead`.

    ``params``: an optional ``state_dict`` loaded into ``model`` (e.g.
    from :func:`~deepspeed_tpu_torch.models.gpt2.convert_gpt2_params`).
    ``config``: a dict (or attribute object) with the JAX engine's
    ``inference`` keys. ``session``: an optional
    :class:`~deepspeed_tpu_torch.telemetry.session.TelemetrySession` the
    scheduler emits ``decode_step`` events through. ``device``: where
    the engine runs (None = CUDA; raises without a GPU).

    The engine takes ownership of ``model``: it moves it to ``device``
    and stores its matmul weights in the compute dtype
    (:meth:`GPT2LMHead.cast_matmul_weights_`, bit-identical outputs).
    """

    def __init__(self, model, params=None, config=None, session=None,
                 device=None):
        self.device = resolve_device(device)
        cfg = model.config
        self.max_batch = int(_cfg_get(config, "max_batch",
                                      DEFAULT_MAX_BATCH))
        buckets = _cfg_get(config, "seq_buckets", DEFAULT_SEQ_BUCKETS)
        self.seq_buckets = tuple(sorted(int(b) for b in buckets))
        self.prefill_chunk = int(_cfg_get(config, "prefill_chunk",
                                          DEFAULT_PREFILL_CHUNK))
        self.kv_cache_dtype = _cfg_get(config, "kv_cache_dtype", None)
        self.attention_impl = str(_cfg_get(config, "attention_impl",
                                           "dense"))
        self.attention_block_k = int(_cfg_get(config, "attention_block_k",
                                              DEFAULT_ATTENTION_BLOCK_K))
        self.temperature = float(_cfg_get(config, "temperature", 0.0))
        self.top_k = int(_cfg_get(config, "top_k", 0))
        self.top_p = float(_cfg_get(config, "top_p", 1.0))
        self.sampling_seed = int(_cfg_get(config, "sampling_seed", 0))
        self.kv_layout = str(_cfg_get(config, "kv_layout", "ring"))
        if self.kv_layout != "ring":
            raise ValueError(
                f"inference.kv_layout {self.kv_layout!r} is not yet "
                f"ported (ring only)")
        for key in ("tier", "speculative"):
            spec = _cfg_get(config, key, None)
            if spec and (not isinstance(spec, dict) or
                         spec.get("enabled", True)):
                raise ValueError(f"inference.{key} is not yet ported")
        if self.attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"inference.attention.impl must be 'dense' or 'flash', "
                f"got {self.attention_impl!r}")
        if self.temperature < 0.0:
            raise ValueError(f"sampling temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got "
                             f"{self.top_p}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got "
                             f"{self.max_batch}")
        if not self.seq_buckets or min(self.seq_buckets) < 1:
            raise ValueError(f"seq_buckets must be non-empty positive "
                             f"ints, got {self.seq_buckets}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{self.prefill_chunk}")
        for b in self.seq_buckets:
            if b % self.prefill_chunk:
                raise ValueError(
                    f"every seq bucket must be a multiple of "
                    f"prefill_chunk={self.prefill_chunk}; got bucket {b}")
        self.max_seq = max(self.seq_buckets)
        self.attention_block_k = min(self.attention_block_k, self.max_seq)
        if self.attention_block_k < 1 or \
                self.max_seq % self.attention_block_k:
            raise ValueError(
                f"attention block_k {self.attention_block_k} must be a "
                f"positive divisor of max_seq {self.max_seq}")
        self.spec = spec_for_model(cfg, self.max_batch, self.max_seq,
                                   self.kv_cache_dtype)
        self.session = session

        if params is not None:
            model.load_state_dict(params)
        model.requires_grad_(False)
        self.model = model.to(self.device).cast_matmul_weights_().eval()
        self.cache = init_kv_cache(self.spec, self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.sampling_seed)
        self._signatures = {"prefill": set(), "decode": set()}

    # -- the two programs ---------------------------------------------------

    @torch.no_grad()
    def _prefill_fn(self, tokens, positions, slot):
        self._signatures["prefill"].add(_signature(tokens, positions))
        row = slice_rows(self.cache, slot)
        logits, row = self.model(tokens, positions=positions, kv_cache=row)
        update_rows(self.cache, row, slot)
        # fp32 on the way out: host-side sampling/parity reads full
        # precision regardless of compute dtype
        return logits.float()

    @torch.no_grad()
    def _decode_fn(self, tokens, positions):
        self._signatures["decode"].add(_signature(tokens, positions))
        logits, _ = self.model(
            tokens[:, None], positions=positions[:, None],
            kv_cache=self.cache, attn_impl=self.attention_impl,
            attn_block_k=self.attention_block_k)
        logits = logits[:, 0].float()
        next_tokens = sample_logits(
            logits, self._generator, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p)
        return next_tokens, logits

    def _tensor(self, array):
        return torch.from_numpy(np.asarray(array, np.int32)).to(self.device)

    # -- host API -----------------------------------------------------------

    def prefill(self, slot, prompt):
        """Chunked prefill of ``prompt`` (token ids) into cache row
        ``slot``; returns the fp32 logits at the last prompt token
        (``[vocab]``, numpy)."""
        n = len(prompt)
        if not 0 < n <= self.max_seq:
            raise ValueError(
                f"prompt length {n} outside (0, max_seq={self.max_seq}]")
        chunk = self.prefill_chunk
        padded = -(-n // chunk) * chunk
        toks = np.zeros((1, padded), np.int32)
        toks[0, :n] = np.asarray(prompt, np.int32)
        last_chunk = (n - 1) // chunk
        from deepspeed_tpu_torch.runtime.resilience import fault_injection
        last = None
        for ci in range(padded // chunk):
            fault_injection.maybe_kill("prefill_chunk", ci)
            tc = self._tensor(toks[:, ci * chunk:(ci + 1) * chunk])
            pc = self._tensor(
                np.arange(ci * chunk, (ci + 1) * chunk)[None, :])
            logits = self._prefill_fn(tc, pc, int(slot))
            if ci == last_chunk:
                last = logits[0, (n - 1) % chunk].cpu().numpy()
        return last

    def decode(self, tokens, positions):
        """One decode step for every cache row at once. ``tokens`` /
        ``positions``: ``[max_batch]`` int arrays (inactive rows padded
        with zeros — their outputs are meaningless and ignored).
        Returns ``(next_tokens [max_batch], logits [max_batch, vocab])``
        as numpy; sampling runs on the device before the copy back."""
        nxt, logits = self._decode_fn(self._tensor(tokens),
                                      self._tensor(positions))
        return nxt.cpu().numpy(), logits.cpu().numpy()

    def sample_first(self, last_logits):
        """Sample the FIRST generated token from prefill's last-prompt-
        token logits (``[vocab]`` numpy) with the decode step's sampling
        pipeline and generator."""
        logits = torch.from_numpy(
            np.asarray(last_logits, np.float32)).to(self.device)
        tok = sample_logits(logits, self._generator,
                            temperature=self.temperature,
                            top_k=self.top_k, top_p=self.top_p)
        return int(tok)

    def reset(self):
        """Zero the cache (rows all free)."""
        self.cache = init_kv_cache(self.spec, self.device)

    # -- contract surface ---------------------------------------------------

    def compile_counts(self):
        """Distinct input signatures each program has run with,
        ``{"prefill": n, "decode": n}``: 1/1 after warmup and forever
        after is the contract; growth means a shape or dtype leaked
        into a program boundary."""
        return {name: len(sigs) for name, sigs in self._signatures.items()}

    def cache_facts(self):
        """Static cache facts for audits and the serve result."""
        return {"bytes": kv_cache_nbytes(self.cache),
                "dtype_census": cache_dtype_census(self.cache),
                "kv_cache_dtype": self.kv_cache_dtype,
                "kv_layout": self.kv_layout,
                "max_batch": self.max_batch,
                "max_seq": self.max_seq,
                "seq_buckets": list(self.seq_buckets),
                "prefill_chunk": self.prefill_chunk}
