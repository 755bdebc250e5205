"""Fused Adam: the port's K4 plain version (`ops/fused_adam.py`, what
the CUDA kernel is held to on the card) against the JAX Pallas kernel
(`deepspeed_tpu/ops/pallas/fused_adam.py:pallas_adam_update`, interpret
mode), and the port's functional `ops/adam/fused_adam.py:adam_update`
against the JAX one, over 5 steps from the same numpy inputs.

Tolerance: atol 1e-6 on params of magnitude ~1 moved by lr 1e-2 per
step — both sides compute in fp32 with the same operation order; only
``beta ** step`` of the bias correction may round differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.fused_adam import (
    adam_update as jax_adam_update,
    init_adam_state as jax_init,
)
from deepspeed_tpu.ops.pallas.fused_adam import pallas_adam_update
from deepspeed_tpu_torch.ops.adam.fused_adam import (
    AdamState,
    FusedAdam,
    adam_update,
    init_adam_state,
)
from deepspeed_tpu_torch.ops.fused_adam import (
    adam_hyperparams,
    fused_adam,
    fused_adam_reference,
    fused_adam_update,
)

SIZES = ((1,), (3,), (11, 47), (1031,))   # odd leaf sizes, one 2-D
STEPS = 5
ATOL = 1e-6
HP = dict(lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def _params(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SIZES]


def _grads(seed, step):
    rng = np.random.default_rng(1000 * seed + step)
    return [rng.standard_normal(s).astype(np.float32) for s in SIZES]


def _assert_trees(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_plain_k4_matches_pallas_kernel(adam_w_mode, bias_correction):
    kw = dict(HP, adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jp = [jnp.asarray(p) for p in _params(0)]
    js = jax_init(jp)
    tp = [torch.from_numpy(p) for p in _params(0)]
    ts = init_adam_state(tp)
    for step in range(STEPS):
        g = _grads(0, step)
        jp, js = pallas_adam_update(jp, [jnp.asarray(x) for x in g], js,
                                    interpret=True, **kw)
        ts = fused_adam_update(tp, [torch.from_numpy(x) for x in g], ts,
                               **kw)
    _assert_trees(tp, jp)
    _assert_trees(ts.m, js.m)
    _assert_trees(ts.v, js.v)
    assert int(ts.step) == int(js.step) == STEPS


@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_update_matches_jax(adam_w_mode, bias_correction):
    kw = dict(HP, adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    jp = [jnp.asarray(p) for p in _params(1)]
    js = jax_init(jp)
    tp = [torch.from_numpy(p) for p in _params(1)]
    ts = init_adam_state(tp)
    for step in range(STEPS):
        g = _grads(1, step)
        jp, js = jax_adam_update(jp, [jnp.asarray(x) for x in g], js, **kw)
        tp, ts = adam_update(tp, [torch.from_numpy(x) for x in g], ts, **kw)
    _assert_trees(tp, jp)
    _assert_trees(ts.m, js.m)
    _assert_trees(ts.v, js.v)
    assert int(ts.step) == STEPS


def test_skip_flag_leaves_every_leaf_and_the_step_alone():
    tp = [torch.from_numpy(p) for p in _params(2)]
    ts = init_adam_state(tp)
    g = [torch.from_numpy(x) for x in _grads(2, 0)]
    ts = fused_adam_update(tp, g, ts, **HP)
    before = [x.clone() for x in tp + ts.m + ts.v]
    ts = fused_adam_update(tp, g, ts, skip=torch.tensor(True), **HP)
    for a, b in zip(before, tp + ts.m + ts.v):
        assert torch.equal(a, b)
    assert int(ts.step) == 1


def test_wrapper_validates_and_never_runs_the_plain_version_off_the_cpu():
    p = [torch.zeros(4, device="meta")]
    hyper = torch.zeros(8, device="meta")
    before = fused_adam.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_adam(p, p, p, p, hyper)
    assert fused_adam.launches == before
    cpu = [torch.zeros(4)]
    with pytest.raises(ValueError, match="f32 \\[8\\]"):
        fused_adam(cpu, cpu, cpu, cpu, torch.zeros(7))
    with pytest.raises(ValueError, match="leaf 0"):
        fused_adam(cpu, [torch.zeros(5)], cpu, cpu, torch.zeros(8))


def test_reference_is_the_kernel_math_in_order():
    """One element by hand, in the order of `fused_adam.py:32-44`
    (L2 mode: decay folded into the gradient)."""
    p, g = torch.tensor([0.5]), torch.tensor([-2.0])
    m, v = torch.tensor([0.1]), torch.tensor([0.2])
    hyper = adam_hyperparams(0.1, 0.9, 0.99, 1e-8, 0.5, 0.19, 0.0199, 0.0,
                             "cpu")
    fused_adam_reference([p], [g], [m], [v], hyper, adam_w_mode=False)
    f = np.float32
    gg = f(-2.0) + f(0.5) * f(0.5)
    mn = f(0.9) * f(0.1) + (f(1) - f(0.9)) * gg
    vn = f(0.99) * f(0.2) + (f(1) - f(0.99)) * gg * gg
    upd = (mn / f(0.19)) / (np.sqrt(vn / f(0.0199)) + f(1e-8))
    assert float(m) == float(mn) and float(v) == float(vn)
    assert float(p) == float(f(0.5) - f(0.1) * upd)


def test_fused_adam_wrapper_class():
    params = [torch.from_numpy(p) for p in _params(3)]
    opt = FusedAdam(params, lr=1e-2)
    assert isinstance(opt.state, AdamState)
    new = opt.step([torch.ones_like(p) for p in params])
    assert int(opt.state.step) == 1
    for p0, p1 in zip(params, new):
        assert torch.all(p1 < p0)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(params, amsgrad=True)
