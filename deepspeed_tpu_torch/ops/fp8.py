"""fp8 matmuls with per-tensor delayed scaling (port of
``deepspeed_tpu/ops/fp8.py``).

The contract is the JAX package's: each forward operand of a hooked
matmul is quantize-dequantized (``qdq``) to ``float8_e4m3fn`` (qmax
448), the backward cotangent of its output to ``float8_e5m2`` (qmax
57344); ``scale = max(history) / (qmax / 2**margin)``, an all-zero
history giving scale 1; each use rolls the current ``|x|`` max into the
front of its history. On the CPU, ``clamp`` then the saturating cast to
the fp8 dtype rounds to nearest even as ``ml_dtypes`` does, so qdq and
the scales equal the JAX functions bit for bit.

The state is ``{"<site>:<idx>": {"in": [H], "kernel": [H], "out":
[H]}}``, ``idx`` the site's call index within one forward (JAX's
trace-order index). Where JAX makes the updated histories the
"gradient" of the state (``custom_vjp``), the port adds them into a
second dict of the same keys, ``new_state``, as the forward (the
operands' histories) and the backward (the cotangent's) produce them:
the sum over a forward's uses of a key is that gradient. The engine
gives every micro-batch a zeroed ``new_state`` and takes the elementwise
max over the step's micro-batches (JAX's accumulation), so the
histories roll once per step, never once per forward. A remat recompute
(:func:`replaying`) records nothing: JAX's cotangent counts each use
once.

A site that does not run in a forward keeps its key: a dropped PLD
sublayer advances its sites' call counts (:func:`skip_sites`), as JAX's
``lax.cond`` traces the untaken branch, and its histories come back
all-zero, the cotangent of the untaken branch. Under ``scan_layers``
the JAX model traces its block twice (flax's shape pass, whose keys
never run, then the scan body) and every layer uses the body's keys, so
their histories sum over the layers; :func:`scan_keys` reproduces that.

The product is JAX's: the matmul of the dequantized operands in the
compute dtype, forward and backward (the backward's on the dequantized
operands and the quantized cotangent).

:func:`fp8_scope` declares the plan (and state) active for the
forwards run inside it, like JAX's trace-time scope: no scope means
:func:`site_active` is False and the model's ``Dense`` runs its plain
matmul. Without a state (and not discovering) the scope gives JAX's
current scaling (``fp8_dot_general``'s manual path, which the pipeline
runs): :func:`in_qdq_current` on both operands, the matmul, then
:func:`out_qdq_current`. JAX differentiates ``in_qdq_current`` as
written, so its gradient is not straight through: the cotangent times
the scale is cast to ``float8_e4m3fn`` on its way back (the transpose of
the cast), the clamp halves it at a tie, and the scale's own gradient
reaches the operand's largest element through the max.
:class:`_InQdqCurrent` is that gradient, op for op.
"""

import contextlib
import dataclasses

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def compute_scale(history, qmax, margin=0):
    """Delayed scale from an amax history: ``max(h) / (qmax /
    2**margin)``, an all-zero history bootstrapping to scale 1."""
    amax = history.max()
    amax = torch.where(amax > 0.0, amax, torch.ones_like(amax))
    return (amax / (qmax / (2.0 ** margin))).to(torch.float32)


def update_history(history, x):
    """Roll the current ``|x|`` max into the front of the history."""
    amax = x.detach().abs().max().to(torch.float32)
    return torch.cat([amax[None], history[:-1]])


def quantize(x, scale, qmax, dtype):
    """``x / scale`` clamped to ``[-qmax, qmax]`` and cast to the fp8
    ``dtype`` (the stored operand)."""
    scaled = x.to(torch.float32) / scale
    return torch.clamp(scaled, -qmax, qmax).to(dtype)


def quantize_dequantize(x, scale, qmax, dtype):
    """Scale into the fp8 range, saturate-cast to ``dtype`` and back, in
    ``x``'s dtype (JAX ``quantize_dequantize``)."""
    q = quantize(x, scale, qmax, dtype)
    return (q.to(torch.float32) * scale).to(x.dtype)


class _InQdqCurrent(torch.autograd.Function):
    """``quantize_dequantize(x, s, 448, e4m3fn)`` with ``s`` from the
    current amax, and the gradient JAX's autodiff gives it (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, margin):
        c = E4M3_MAX / (2.0 ** margin)
        raw = x.detach().abs().max().to(torch.float32)
        amax = torch.where(raw > 0.0, raw, torch.ones_like(raw))
        s = amax / c
        scaled = x.to(torch.float32) / s
        q = torch.clamp(scaled, -E4M3_MAX, E4M3_MAX) \
            .to(torch.float8_e4m3fn).to(torch.float32)
        ctx.save_for_backward(x, scaled, q, raw, s)
        ctx.c = c
        return (q * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scaled, q, raw, s = ctx.saved_tensors
        g = g.to(torch.float32)
        g_s = (g * q).sum()                      # y = q * s
        g_q = (g * s).to(torch.float8_e4m3fn).to(torch.float32)
        # clip = minimum(maximum(scaled, -qmax), qmax): 1/2 at a tie
        lo = torch.maximum(scaled, torch.full_like(scaled, -E4M3_MAX))
        d = torch.where(scaled > -E4M3_MAX, 1.0,
                        torch.where(scaled == -E4M3_MAX, 0.5, 0.0)) * \
            torch.where(lo < E4M3_MAX, 1.0,
                        torch.where(lo == E4M3_MAX, 0.5, 0.0))
        g_scaled = g_q * d
        g_x = g_scaled / s                       # scaled = x / s
        g_s = g_s - (g_scaled * scaled / s).sum()
        if raw > 0:     # s = max|x| / c: the max's elements share it
            hit = (x.detach().abs().to(torch.float32) == raw)
            g_amax = g_s / ctx.c / hit.sum()
            g_x = g_x + torch.where(hit, torch.sign(x.detach().float())
                                    * g_amax, 0.0)
        return g_x.to(x.dtype), None


def in_qdq_current(x, margin=0):
    """JAX ``in_qdq_current``: the forward operand's qdq to
    ``float8_e4m3fn`` at the scale of its current amax, with JAX's
    gradient (:class:`_InQdqCurrent`)."""
    return _InQdqCurrent.apply(x, int(margin))


def out_qdq_current(y, margin=0):
    """JAX ``out_qdq_current``: the identity forward; the backward qdq's
    the cotangent to ``float8_e5m2`` at its current amax's scale."""
    return _OutQdq.apply(y, None, None, None, int(margin))


def current_scaling_matmul(x, w, margin=0):
    """``x @ w.T`` (``w`` ``[out, in]``) as JAX's ``fp8_dot_general``
    runs it without a state: both operands through
    :func:`in_qdq_current`, the product, then :func:`out_qdq_current`."""
    return out_qdq_current(torch.matmul(in_qdq_current(x, margin),
                                        in_qdq_current(w, margin).t()),
                           margin)


def _current_scale(x, qmax, margin):
    amax = x.detach().abs().max().to(torch.float32)
    amax = torch.where(amax > 0.0, amax, torch.ones_like(amax))
    return amax / (qmax / (2.0 ** margin))


@dataclasses.dataclass(frozen=True)
class Fp8Plan:
    """The resolved ``fp8`` config block: scaling margin, history length
    and per-site overrides (``{site: {"enabled": bool}}``)."""
    margin: int = 0
    amax_history_len: int = 16
    sites: dict = dataclasses.field(default_factory=dict)

    def site_enabled(self, name):
        ov = (self.sites or {}).get(name) or {}
        return ov.get("enabled", True) is not False


def init_history(length, device=None):
    """A fresh all-zero amax history (bootstraps to scale 1)."""
    return torch.zeros(int(length), dtype=torch.float32, device=device)


def init_state_bundle(length, device=None):
    """Zero state of one fp8 site: the histories of the two forward
    operands and of the backward cotangent."""
    return {"in": init_history(length, device),
            "kernel": init_history(length, device),
            "out": init_history(length, device)}


class _Scope:
    __slots__ = ("plan", "state", "new_state", "discover", "counts",
                 "replay")

    def __init__(self, plan, state, new_state, discover):
        self.plan = plan
        self.state = state
        self.new_state = new_state
        self.discover = discover
        self.counts = {}
        self.replay = False

    def keyed(self):
        return self.state is not None or self.discover is not None

    def next_key(self, site):
        """The site's next ``"<site>:<idx>"`` key (recorded when
        discovering)."""
        idx = self.counts.get(site, 0)
        self.counts[site] = idx + 1
        key = f"{site}:{idx}"
        if self.discover is not None and key not in self.discover:
            self.discover.append(key)
        return key


_SCOPE = None


@contextlib.contextmanager
def fp8_scope(plan, state=None, new_state=None, discover=None):
    """Make ``plan`` (an :class:`Fp8Plan`) active for the forwards run
    inside. ``state``: the step's input histories by key, with
    ``new_state`` (same keys) receiving the updates; ``state=None``
    selects stateless current scaling. ``discover`` (a list) records the
    keys the forward uses, in call order, and runs every site at scale 1
    (the engine's discovery pass)."""
    global _SCOPE
    prev = _SCOPE
    _SCOPE = None if plan is None else _Scope(plan, state, new_state,
                                              discover)
    try:
        yield
    finally:
        _SCOPE = prev


def scope_margin():
    """The active plan's scaling margin."""
    return int(_SCOPE.plan.margin)


def site_active(site):
    """Whether a matmul at ``site`` runs in fp8 now."""
    return _SCOPE is not None and _SCOPE.plan.site_enabled(site)


def snapshot():
    """The active scope and its call counts, for a recompute to replay
    the forward's keys (``activation_checkpointing.replayable``)."""
    return None if _SCOPE is None else (_SCOPE, dict(_SCOPE.counts))


@contextlib.contextmanager
def replaying(snap):
    """Run a recompute inside the scope of ``snap`` (from
    :func:`snapshot`) with its call counts and no history records, then
    put back the scope that was active."""
    global _SCOPE
    prev = _SCOPE
    if snap is not None:
        scope, counts = snap
        saved, replay = scope.counts, scope.replay
        scope.counts, scope.replay = dict(counts), True
        _SCOPE = scope
    try:
        yield
    finally:
        if snap is not None:
            snap[0].counts, snap[0].replay = saved, replay
        _SCOPE = prev


def skip_sites(sites):
    """Advance the call counts of ``sites`` that a forward does not run
    (a dropped sublayer's), so later sites keep their keys."""
    scope = _SCOPE
    if scope is None or not scope.keyed():
        return
    for site in sites:
        if scope.plan.site_enabled(site):
            scope.next_key(site)


def scan_keys(sites):
    """JAX's keys for a scanned stack whose block runs ``sites``: the
    shape pass's keys are taken (and never run), and the returned
    function, called before each layer, gives every layer the body's
    keys. None outside a keyed scope."""
    scope = _SCOPE
    if scope is None or not scope.keyed():
        return None
    skip_sites(sites)
    base = dict(scope.counts)

    def enter_layer():
        scope.counts = dict(base)

    return enter_layer


def _record(new_state, key, slot, hist):
    if new_state is not None:
        new_state[key][slot].add_(hist)


class _QdqMatmul(torch.autograd.Function):
    """``qdq(x) @ qdq(w).T`` against the delayed (or current) scales;
    straight-through gradients (qdq is the identity inside the
    representable range), the backward's products on the dequantized
    operands."""

    @staticmethod
    def forward(ctx, x, w, hists, new_state, key, margin):
        x2 = x.reshape(-1, x.shape[-1])
        if hists is None:
            sx = _current_scale(x2, E4M3_MAX, margin)
            sw = _current_scale(w, E4M3_MAX, margin)
        else:
            sx = compute_scale(hists["in"], E4M3_MAX, margin)
            sw = compute_scale(hists["kernel"], E4M3_MAX, margin)
            _record(new_state, key, "in", update_history(hists["in"], x2))
            _record(new_state, key, "kernel",
                    update_history(hists["kernel"], w))
        xd = quantize_dequantize(x2, sx, E4M3_MAX, torch.float8_e4m3fn)
        wd = quantize_dequantize(w, sw, E4M3_MAX, torch.float8_e4m3fn)
        y = xd @ wd.t()
        ctx.save_for_backward(xd, wd)
        ctx.x_shape = x.shape
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xd, wd = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g2 @ wd).reshape(ctx.x_shape)
        dw = g2.t() @ xd
        return dx, dw, None, None, None, None


class _OutQdq(torch.autograd.Function):
    """Identity forward; the backward quantize-dequantizes the cotangent
    to ``float8_e5m2`` and records its history."""

    @staticmethod
    def forward(ctx, y, hist, new_state, key, margin):
        ctx.hist, ctx.new_state, ctx.key, ctx.margin = \
            hist, new_state, key, margin
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if ctx.hist is None:
            scale = _current_scale(g, E5M2_MAX, ctx.margin)
        else:
            scale = compute_scale(ctx.hist, E5M2_MAX, ctx.margin)
            _record(ctx.new_state, ctx.key, "out",
                    update_history(ctx.hist, g))
        return quantize_dequantize(g, scale, E5M2_MAX,
                                   torch.float8_e5m2), \
            None, None, None, None


def fp8_linear(x, w, site):
    """``x @ w.T`` (``w`` ``[out, in]``, both in the compute dtype) as an
    fp8 matmul under the active scope; call only when
    :func:`site_active`. Advances the site's call count and uses (or
    discovers) the state key ``"<site>:<idx>"``."""
    scope = _SCOPE
    margin = int(scope.plan.margin)
    if not scope.keyed():
        return current_scaling_matmul(x, w, margin)
    hists = new_state = key = None
    if scope.keyed():
        key = scope.next_key(site)
        if scope.discover is not None:
            hists = init_state_bundle(scope.plan.amax_history_len,
                                      x.device)
        else:
            hists = scope.state[key]
            new_state = None if scope.replay else scope.new_state
    y = _QdqMatmul.apply(x, w, hists, new_state, key, margin)
    return _OutQdq.apply(y, None if hists is None else hists["out"],
                         new_state, key, margin)


def unflatten_state(flat, keys):
    """The ``[n_keys, 3, H]`` tensor the engine keeps (slots in, kernel,
    out) as ``{key: bundle}`` of views."""
    return {k: {"in": flat[i, 0], "kernel": flat[i, 1], "out": flat[i, 2]}
            for i, k in enumerate(keys)}
