"""InferenceEngine: the two programs of the serving path (ring and
paged layouts of ``deepspeed_tpu/inference/engine.py``).

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

``kv_layout="paged"`` swaps the ring rows for a page pool
(`inference/cache.py` paged layout): both programs take fixed-shape
int32 page tables as plain data, so page allocation, prefix sharing
and host-tier park/resume (`inference/paging.py`) are admission-time
metadata under the same 2-program contract. An ``inference.
speculative`` block hangs a draft/verify pair off the engine
(`inference/speculative.py`): the contract is then 3 programs and the
plain decode program runs 0 times.

``inference.tier`` ("prefill" or "decode", paged only) pins a
disaggregated tier's engine to one of the two programs
(``inference/disagg.py``); :meth:`gather_pages_device` snapshots pages
for the in-process KV handoff.

The engine runs on ``device`` (default: the GPU, raising when there is
none); the KV cache is updated in place.

**Tensor parallelism.** A GPT-2 built with an ``mpu`` whose model axis
has M ranks (``models/gpt2.py``) holds its rank's shard; every rank runs
its own engine over it, on the same requests in the same order. The
cache holds the rank's ``n_head / M`` heads (``cache.kv_partition_specs``;
K5 and K6 run on them), the row-parallel ``c_proj`` sums over the model
group, and the logits are all-gathered over the vocab before sampling.
Every rank samples from the same logits with the same seeded generator,
so every rank emits the same token.
"""

import numpy as np
import torch

from deepspeed_tpu_torch import resolve_device
from deepspeed_tpu_torch.inference.cache import (
    batch_axis,
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
DEFAULT_HOST_PARK_THRESHOLD = 0.25

# numpy has no bf16 or fp8: host page snapshots carry those pool leaves
# as integer views of the same width
_HOST_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
              torch.float8_e4m3fn: torch.uint8,
              torch.float8_e5m2: torch.uint8}


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
        self.page_size = int(_cfg_get(config, "page_size", 0))
        self.n_pages = int(_cfg_get(config, "n_pages", 0))
        self.prefix_cache = bool(_cfg_get(config, "prefix_cache", True))
        self.host_park_threshold = float(_cfg_get(
            config, "host_park_threshold", DEFAULT_HOST_PARK_THRESHOLD))
        # disaggregated serving: a tiered engine runs one of the two
        # programs, "prefill" writes paged KV and never decodes,
        # "decode" resumes handed-off pages and never prefills; calling
        # the other program raises, so each tier's compile_counts()
        # holds one entry and the other stays at zero
        tier = _cfg_get(config, "tier", None)
        self.tier = str(tier) if tier else None
        if self.tier not in (None, "prefill", "decode"):
            raise ValueError(
                f"inference tier must be 'prefill' or 'decode', got "
                f"{self.tier!r}")
        if self.tier is not None and self.kv_layout != "paged":
            raise ValueError(
                "tiered (disaggregated) engines require kv_layout="
                "'paged' — the KV handoff is a page copy")
        if self.attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"inference.attention.impl must be 'dense' or 'flash', "
                f"got {self.attention_impl!r}")
        if self.kv_layout not in ("ring", "paged"):
            raise ValueError(
                f"inference.kv_layout must be 'ring' or 'paged', got "
                f"{self.kv_layout!r}")
        if not 0.0 <= self.host_park_threshold < 1.0:
            raise ValueError(
                f"host_park_threshold must be in [0, 1), got "
                f"{self.host_park_threshold}")
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
        if self.kv_layout == "paged":
            if not self.page_size:
                # auto: two prefill chunks per page
                self.page_size = min(2 * self.prefill_chunk, self.max_seq)
            if self.page_size % self.prefill_chunk:
                # a prefill chunk must land inside ONE page
                raise ValueError(
                    f"page_size {self.page_size} must be a multiple of "
                    f"prefill_chunk {self.prefill_chunk}")
            if self.max_seq % self.page_size:
                raise ValueError(
                    f"page_size {self.page_size} must divide max_seq "
                    f"{self.max_seq}")
            # a flash KV block must not straddle a page boundary
            self.attention_block_k = min(self.attention_block_k,
                                         self.page_size)
            if self.page_size % self.attention_block_k:
                raise ValueError(
                    f"attention block_k {self.attention_block_k} must "
                    f"divide page_size {self.page_size}")
        else:
            self.page_size = 0
            self.n_pages = 0
        # tensor parallelism: the model holds its model rank's shard
        # (models/gpt2.py) and the cache this rank's heads
        tp = getattr(model, "tp", None)
        self.model_parallel_size = tp.size if tp is not None else 1
        self.spec = spec_for_model(cfg, self.max_batch, self.max_seq,
                                   self.kv_cache_dtype,
                                   page_size=self.page_size,
                                   n_pages=self.n_pages,
                                   model_size=self.model_parallel_size)
        self.n_pages = self.spec.n_pages
        self.pages_per_row = self.spec.pages_per_row
        self.session = session

        if params is not None:
            model.load_state_dict(params)
        model.requires_grad_(False)
        self.model = model.to(self.device).cast_matmul_weights_().eval()
        self.cache = init_kv_cache(self.spec, self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.sampling_seed)
        self._signatures = {"prefill": set(), "decode": set()}

        # speculative decoding: a draft + verify pair hung off the
        # engine, or None when the block is absent, disabled or
        # degenerate (then the 2-program contract is unchanged)
        from deepspeed_tpu_torch.inference.speculative import (
            build_speculative)
        self.speculative = build_speculative(self, config)
        if self.tier is not None and self.speculative is not None:
            raise ValueError(
                "inference.speculative cannot combine with a tiered "
                "(disaggregated) engine — the draft/verify pair would "
                "break the one-program-per-tier contract")

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
    def _decode_fn(self, tokens, positions, page_tables=None):
        self._signatures["decode"].add(_signature(
            tokens, positions, *(() if page_tables is None
                                 else (page_tables,))))
        logits, _ = self.model(
            tokens[:, None], positions=positions[:, None],
            kv_cache=self.cache, attn_impl=self.attention_impl,
            attn_block_k=self.attention_block_k, kv_page_table=page_tables)
        logits = logits[:, 0].float()
        next_tokens = sample_logits(
            logits, self._generator, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p)
        return next_tokens, logits

    @torch.no_grad()
    def _prefill_fn_paged(self, tokens, positions, page_table):
        # the paged prefill addresses the POOL through the chunk's page
        # table: no row slice, the whole cache is written in place
        self._signatures["prefill"].add(
            _signature(tokens, positions, page_table))
        logits, _ = self.model(tokens, positions=positions,
                               kv_cache=self.cache,
                               kv_page_table=page_table)
        return logits.float()

    def _tensor(self, array):
        return torch.from_numpy(np.asarray(array, np.int32)).to(self.device)

    # -- host API -----------------------------------------------------------

    def prefill(self, slot, prompt, page_table=None, start=0):
        """Chunked prefill of ``prompt`` (token ids) into cache row
        ``slot``; returns the fp32 logits at the last prompt token
        (``[vocab]``, numpy).

        Paged layout: ``page_table`` (``[pages_per_row]`` ints, pages
        covering the prompt allocated by the scheduler) addresses the
        pool instead of ``slot``, and ``start`` (chunk-aligned) resumes
        mid-prompt: a prefix-cache hit skips the chunks the shared
        pages already hold, a parked-session resume restarts at the
        session's frontier. Every chunk has the same ``[1,
        prefill_chunk]`` shape, so the skipped span's KV is the bytes a
        cold prefill would have written."""
        if self.tier == "decode":
            raise RuntimeError(
                "decode-tier engine: the prefill program is pinned off "
                "— prefill belongs to the prefill tier")
        n = len(prompt)
        if not 0 < n <= self.max_seq:
            raise ValueError(
                f"prompt length {n} outside (0, max_seq={self.max_seq}]")
        chunk = self.prefill_chunk
        padded = -(-n // chunk) * chunk
        toks = np.zeros((1, padded), np.int32)
        toks[0, :n] = np.asarray(prompt, np.int32)
        last_chunk = (n - 1) // chunk
        paged = self.kv_layout == "paged"
        if paged:
            if page_table is None:
                raise ValueError("paged prefill requires a page_table")
            pt = self._tensor(np.asarray(page_table).reshape(1, -1))
        # the last chunk always runs (it produces the logits the first
        # sampled token reads), so a resume start clamps to it
        start = min(int(start), last_chunk * chunk) if paged else 0
        if start % chunk:
            raise ValueError(
                f"prefill start {start} must be chunk-aligned "
                f"(chunk={chunk})")
        from deepspeed_tpu_torch.runtime.resilience import fault_injection
        last = None
        for ci in range(start // chunk, padded // chunk):
            fault_injection.maybe_kill("prefill_chunk", ci)
            tc = self._tensor(toks[:, ci * chunk:(ci + 1) * chunk])
            pc = self._tensor(
                np.arange(ci * chunk, (ci + 1) * chunk)[None, :])
            if paged:
                logits = self._prefill_fn_paged(tc, pc, pt)
            else:
                logits = self._prefill_fn(tc, pc, int(slot))
            if ci == last_chunk:
                last = logits[0, (n - 1) % chunk].cpu().numpy()
        return last

    def decode(self, tokens, positions, page_tables=None):
        """One decode step for every cache row at once. ``tokens`` /
        ``positions``: ``[max_batch]`` int arrays (inactive rows padded
        with zeros — their outputs are meaningless and ignored).
        Returns ``(next_tokens [max_batch], logits [max_batch, vocab])``
        as numpy; sampling runs on the device before the copy back.
        Paged layout also takes the ``[max_batch, pages_per_row]`` page
        tables (inactive rows all zeros: their garbage token lands on
        the trash page)."""
        if self.tier == "prefill":
            raise RuntimeError(
                "prefill-tier engine: the decode program is pinned off "
                "— decode belongs to the decode tier")
        pt = None
        if self.kv_layout == "paged":
            if page_tables is None:
                raise ValueError("paged decode requires page_tables")
            pt = self._tensor(page_tables)
        nxt, logits = self._decode_fn(self._tensor(tokens),
                                      self._tensor(positions), pt)
        return nxt.cpu().numpy(), logits.cpu().numpy()

    # -- host-RAM page tier (paged layout only) -----------------------------

    def gather_pages(self, page_ids):
        """Snapshot the given physical pages to host RAM: a per-layer
        ``{"h_<i>": {"k": [n, page_size, H, D], ...}}`` dict (a stacked
        cache's one ``h`` entry, ``[L, n, ...]``) of numpy
        COPIES (a later in-place pool write must not reach the parked
        bytes). bf16 and fp8 leaves travel as integer views of the same
        width (numpy has neither); :meth:`scatter_pages` views them
        back. Runs outside the two programs: parking is admission-time
        host work."""
        ids = self._tensor(page_ids).long()
        out = {}
        for name, layer in self.cache.items():
            out[name] = {}
            for key, leaf in layer.items():
                g = leaf.index_select(batch_axis(name), ids)
                if g.dtype in _HOST_VIEW:
                    g = g.view(_HOST_VIEW[g.dtype])
                out[name][key] = g.cpu().numpy().copy()
        return out

    def gather_pages_device(self, page_ids):
        """Like :meth:`gather_pages` but the snapshot stays on the
        device: the same nested dict of fresh tensors, never a host
        round trip (JAX ``engine.py:447``). This is the in-process
        disaggregated handoff's source half: the decode tier scatters
        these tensors straight into its own pool (:meth:`scatter_pages`
        takes device values), so the prefill-to-decode page copy is
        device to device. ``index_select`` copies: the snapshot is never
        a view of the pool, which the next prefill writes in place."""
        ids = self._tensor(page_ids).long()
        return {name: {key: leaf.index_select(batch_axis(name), ids)
                       for key, leaf in layer.items()}
                for name, layer in self.cache.items()}

    def scatter_pages(self, page_ids, host_pages):
        """Inverse of :meth:`gather_pages` / :meth:`gather_pages_device`:
        write a page snapshot (numpy, or tensors on any device) back
        into (freshly allocated) physical pages — the resume half of
        the host tier and the install half of a KV handoff."""
        ids = self._tensor(page_ids).long()
        for name, layer in self.cache.items():
            for key, leaf in layer.items():
                vals = host_pages[name][key]
                if not torch.is_tensor(vals):
                    vals = torch.from_numpy(np.ascontiguousarray(vals))
                vals = vals.to(self.device)
                if leaf.dtype in _HOST_VIEW and vals.dtype != leaf.dtype:
                    vals = vals.view(leaf.dtype)
                leaf.index_copy_(batch_axis(name), ids,
                                 vals.to(leaf.dtype))

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
        ``{"prefill": n, "decode": n}`` (plus ``draft`` and ``verify``
        with speculation on): 1 each after warmup and forever after is
        the contract; growth means a shape or dtype leaked into a
        program boundary."""
        counts = {name: len(sigs) for name, sigs in self._signatures.items()}
        if self.speculative is not None:
            counts.update(self.speculative.compile_counts())
        return counts

    def cache_facts(self):
        """Static cache facts for audits and the serve result."""
        facts = {"bytes": kv_cache_nbytes(self.cache),
                 "dtype_census": cache_dtype_census(self.cache),
                 "kv_cache_dtype": self.kv_cache_dtype,
                 "kv_layout": self.kv_layout,
                 "max_batch": self.max_batch,
                 "max_seq": self.max_seq,
                 "seq_buckets": list(self.seq_buckets),
                 "prefill_chunk": self.prefill_chunk}
        if self.kv_layout == "paged":
            facts.update(page_size=self.page_size, n_pages=self.n_pages,
                         pages_per_row=self.pages_per_row)
        if self.tier is not None:
            facts["tier"] = self.tier
        if self.speculative is not None:
            facts["speculative"] = self.speculative.facts()
        return facts
