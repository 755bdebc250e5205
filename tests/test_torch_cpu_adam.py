"""The port's host Adam (``ops/adam/cpu_adam.py``) against the JAX
package's ``DeepSpeedCPUAdam`` and against its plain torch version.

Both packages build the same C++ source (the port keeps a byte-identical
copy), so on the same inputs the port equals JAX bit for bit: masters,
both moments and the bf16 copy-back, over several steps. The plain
version differs from the kernel by one unit in the last place of fp32
(the SIMD body's FMAs and reciprocal against separate mul-adds and a
division): rtol 1e-6, plus 1e-7 of the buffer's largest magnitude where
a sum cancels to near 0 (there the error is the operands' unit, not the
result's). ``step_overlapped`` equals ``step`` bit for bit at chunk
sizes below, at and above a leaf (its ranges start on 16-element
boundaries, so every element takes the kernel path it takes in one
whole-buffer call).

JAX is imported inside the parity tests only, so the ``cuda`` cases
run on a GPU machine without it:

    python -m pytest --noconftest tests/test_torch_cpu_adam.py -m cuda -q
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.adam.cpu_adam import (
    DeepSpeedCPUAdam,
    RANGE_ALIGN,
    adam_plain,
)
from deepspeed_tpu_torch.runtime.resilience import (
    HostAdamError,
    fault_injection,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a leaf of 4096 elements: chunk budgets below, at and above one leaf
SIZES = ((1024, 16), (4096,), (7,), (513, 3), (64, 64), (3,))
LEAF_BYTES = 4096 * 4
RTOL, ATOL_REL = 1e-6, 1e-7

MODES = {
    "adamw_decay": dict(lr=0.01, betas=(0.9, 0.99), weight_decay=0.01,
                        adamw_mode=True),
    "adam_l2_decay": dict(lr=0.01, betas=(0.9, 0.999), weight_decay=0.05,
                          adamw_mode=False),
    "adam_no_bias_correction": dict(lr=1e-3, betas=(0.8, 0.95),
                                    bias_correction=False),
}
# per-step (lr, beta1) overrides: None keeps the constructor's
OVERRIDES = [(None, None), (0.005, None), (None, 0.85), (0.002, 0.7)]


def _params(seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in sizes]


def _grads(rng, sizes=SIZES, dtype=np.float32):
    return [rng.standard_normal(s).astype(dtype) for s in sizes]


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_cpp_source_is_byte_identical_to_the_jax_package():
    assert filecmp.cmp(os.path.join(REPO, "csrc", "adam", "cpu_adam.cpp"),
                       os.path.join(REPO, "deepspeed_tpu_torch", "ops",
                                    "csrc", "cpu_adam.cpp"), shallow=False)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_matches_jax_cpu_adam_bitwise(mode):
    import ml_dtypes
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxAdam

    params = _params()
    jax_opt = JaxAdam(params, **MODES[mode])
    port = DeepSpeedCPUAdam(_torch(params), bf16_copy_back=True,
                            **MODES[mode])
    rng = np.random.default_rng(1)
    for lr, beta1 in OVERRIDES:
        grads = _grads(rng)
        jax_opt.step(grads, lr=lr, beta1=beta1)
        port.step(_torch(grads), lr=lr, beta1=beta1)
    for name in ("master", "exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      getattr(jax_opt, name))
    assert port._step == jax_opt._step == len(OVERRIDES)
    want = np.asarray(jax_opt.params_bf16_flat()).view(np.uint16)
    got = port.params_bf16_flat().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    for leaf, want_leaf in zip(port.params(), jax_opt.params()):
        np.testing.assert_array_equal(leaf.numpy(), want_leaf)


def test_matches_jax_with_bf16_gradients():
    """16-bit gradients widen exactly: the port's landing + widen feeds
    the kernel what JAX's ``np.asarray(g, float32)`` does."""
    import ml_dtypes
    from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxAdam

    params = _params()
    jax_opt = JaxAdam(params, **MODES["adamw_decay"])
    port = DeepSpeedCPUAdam(_torch(params), landing_dtype=torch.bfloat16,
                            **MODES["adamw_decay"])
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = [g.astype(ml_dtypes.bfloat16) for g in _grads(rng)]
        jax_opt.step(grads)
        port.step([torch.from_numpy(g.view(np.int16).copy())
                   .view(torch.bfloat16) for g in grads])
    np.testing.assert_array_equal(port.master.numpy(), jax_opt.master)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_matches_plain_version(mode):
    """Each step from the kernel's state before it (no drift between the
    two trajectories), over several steps and overrides."""
    kw = MODES[mode]
    port = DeepSpeedCPUAdam(_torch(_params()), **kw)
    rng = np.random.default_rng(3)
    for step, (lr, beta1) in enumerate(OVERRIDES, 1):
        master, m, v = (port.master.clone(), port.exp_avg.clone(),
                        port.exp_avg_sq.clone())
        grads = _torch(_grads(rng))
        port.step(grads, lr=lr, beta1=beta1)
        adam_plain(master, torch.cat([g.reshape(-1) for g in grads]), m, v,
                   step, kw["lr"] if lr is None else lr,
                   kw["betas"][0] if beta1 is None else beta1, kw["betas"][1],
                   1e-8, kw.get("weight_decay", 0.0),
                   kw.get("adamw_mode", True),
                   kw.get("bias_correction", True))
        for got, want in ((port.master, master), (port.exp_avg, m),
                          (port.exp_avg_sq, v)):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=RTOL,
                atol=ATOL_REL * float(want.abs().max()))


@pytest.mark.parametrize("chunk_bytes", [64, LEAF_BYTES, 5 * LEAF_BYTES,
                                         1 << 26],
                         ids=["below_a_leaf", "at_a_leaf", "above_a_leaf",
                              "one_chunk"])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_step_overlapped_equals_step_bitwise(chunk_bytes, grad_dtype):
    params = _torch(_params())
    kw = dict(MODES["adamw_decay"], bf16_copy_back=True,
              landing_dtype=grad_dtype if grad_dtype != torch.float32
              else None)
    serial = DeepSpeedCPUAdam(params, **kw)
    overlap = DeepSpeedCPUAdam(params, **kw)
    rng = np.random.default_rng(4)
    plan = overlap._chunk_plan(chunk_bytes)
    for lr, beta1 in OVERRIDES:
        grads = [g.to(grad_dtype) for g in _torch(_grads(rng))]
        serial.step(grads, lr=lr, beta1=beta1)
        seen = []
        out = overlap.step_overlapped(
            grads, lr=lr, beta1=beta1, bf16_out=True,
            chunk_bytes=chunk_bytes,
            on_chunk=lambda lo, hi: seen.append(
                (lo, hi, torch.equal(
                    overlap.master[overlap.offsets[lo]:overlap.offsets[hi]],
                    serial.master[serial.offsets[lo]:serial.offsets[hi]]))))
        # on_chunk: every chunk once, in order, its leaves final by then
        assert seen == [(lo, hi, True) for lo, hi, _, _ in plan]
        for name in ("master", "exp_avg", "exp_avg_sq"):
            assert torch.equal(getattr(overlap, name), getattr(serial, name))
        assert torch.equal(out, serial.params_bf16_flat())
    # the flat form (one tensor of every element) lands the same bytes
    flat = DeepSpeedCPUAdam(params, **kw)
    rng = np.random.default_rng(4)
    for lr, beta1 in OVERRIDES:
        grads = torch.cat([g.reshape(-1) for g in _torch(_grads(rng))])
        flat.step_overlapped(grads.to(grad_dtype), lr=lr, beta1=beta1,
                             bf16_out=True, chunk_bytes=chunk_bytes)
    assert torch.equal(flat.master, serial.master)


def test_overlapped_step_under_thread_switch_stress():
    """Many leaves in tiny chunks with the interpreter switching threads
    every microsecond: the worker's ranges and the calling thread's
    landing and widening never step on each other (a lost or doubled
    range would break the bitwise match)."""
    import sys
    sizes = [(int(n),) for n in
             np.random.default_rng(8).integers(1, 200, 300)]
    params = _torch(_params(sizes=sizes))
    kw = dict(bf16_copy_back=True, landing_dtype=torch.bfloat16)
    serial = DeepSpeedCPUAdam(params, **kw)
    overlap = DeepSpeedCPUAdam(params, **kw)
    rng = np.random.default_rng(9)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            grads = [g.to(torch.bfloat16) for g in
                     _torch(_grads(rng, sizes=sizes))]
            serial.step(grads)
            overlap.step_overlapped(grads, bf16_out=True, chunk_bytes=64)
    finally:
        sys.setswitchinterval(old)
    assert len(overlap._chunks) == len(sizes)
    assert torch.equal(overlap.master, serial.master)
    assert torch.equal(overlap._bf16_buf, serial.params_bf16_flat())


def test_undeclared_buffers_raise():
    """The landing and copy-back buffers come from the constructor only:
    a step that needs one it was not given raises before any update."""
    port = DeepSpeedCPUAdam(_torch(_params()))
    master = port.master.clone()
    grads = [g.to(torch.bfloat16) for g in
             _torch(_grads(np.random.default_rng(10)))]
    with pytest.raises(ValueError, match="landing_dtype"):
        port.step(grads)
    with pytest.raises(ValueError, match="landing_dtype"):
        port.step_overlapped(grads, chunk_bytes=LEAF_BYTES)
    with pytest.raises(ValueError, match="bf16_copy_back"):
        port.step_overlapped([g.float() for g in grads], bf16_out=True)
    with pytest.raises(ValueError, match="bf16_copy_back"):
        port.params_bf16_flat()
    fp16 = DeepSpeedCPUAdam(_torch(_params()), landing_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="landing_dtype"):
        fp16.step([g.to(torch.float16) for g in grads])
    assert port._step == 0 and torch.equal(port.master, master)


def test_chunk_plan_is_leaf_aligned_and_ranges_simd_aligned():
    port = DeepSpeedCPUAdam(_torch(_params()))
    for chunk_bytes in (64, LEAF_BYTES, 5 * LEAF_BYTES, 1 << 26):
        plan = port._chunk_plan(chunk_bytes)
        assert [c[0] for c in plan] == [0] + [c[1] for c in plan[:-1]]
        assert plan[-1][1] == len(SIZES)
        assert sum(c[3] for c in plan) == port.total
        starts = port._range_starts(plan)
        assert starts[0] == 0 and all(s % RANGE_ALIGN == 0 for s in starts)
        assert all(off - RANGE_ALIGN < s <= off
                   for s, (_, _, off, _) in zip(starts, plan))


def test_state_dict_round_trip_resumes_bitwise():
    params = _torch(_params())
    a = DeepSpeedCPUAdam(params, **MODES["adamw_decay"])
    rng = np.random.default_rng(5)
    steps = [_torch(_grads(rng)) for _ in range(4)]
    for g in steps[:2]:
        a.step(g)
    b = DeepSpeedCPUAdam(_torch(_params(seed=9)), **MODES["adamw_decay"])
    b.load_state_dict(a.state_dict())
    for g in steps[2:]:
        a.step(g)
        b.step(g)
    assert torch.equal(a.master, b.master) and a._step == b._step == 4


def test_retry_guard_resubmits_failures_before_the_kernel():
    params = _torch(_params())
    clean = DeepSpeedCPUAdam(params, **MODES["adamw_decay"])
    guarded = DeepSpeedCPUAdam(params, **MODES["adamw_decay"])
    grads = _torch(_grads(np.random.default_rng(6)))
    clean.step_overlapped(grads, chunk_bytes=LEAF_BYTES)
    fault_injection.clear_faults()
    try:
        fault_injection.inject_host_adam_failure(times=2)
        with pytest.raises(HostAdamError, match="retries are disabled"):
            guarded.step_overlapped(grads, chunk_bytes=LEAF_BYTES)
        # the failed step returned with no range still running: restart
        # it from the state before it
        guarded.load_state_dict(DeepSpeedCPUAdam(
            params, **MODES["adamw_decay"]).state_dict())
        fault_injection.clear_faults()
        guarded.host_adam_retries = 3
        fault_injection.inject_host_adam_failure(times=2)
        guarded.step_overlapped(grads, chunk_bytes=LEAF_BYTES)
    finally:
        fault_injection.clear_faults()
    assert torch.equal(guarded.master, clean.master)


def test_host_build_picks_the_jax_builders_simd_flags():
    assert _build.host_simd_flags("flags: sse avx2 fma avx512f") == (
        "-mavx512f", "-mavx2", "-mfma")
    assert _build.host_simd_flags("flags: sse avx2") == ("-mavx2", "-mfma")
    assert _build.host_simd_flags("flags: sse fma") == ("-mfma",)
    assert _build.host_simd_flags("flags: sse") == ()
    assert set(_build.HOST_FLAGS) >= {"-O3", "-fopenmp", "-shared", "-fPIC"}
    width = DeepSpeedCPUAdam(_torch(_params())).simd_width()
    assert width in (1, 8, 16)


def test_pinning_without_cuda_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this torch can pin")
    with pytest.raises(RuntimeError):
        DeepSpeedCPUAdam(_torch(_params()), pin_memory=True)


def test_amsgrad_is_refused():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        DeepSpeedCPUAdam(_torch(_params()), amsgrad=True)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pinned_buffers_are_pinned(cuda):
    opt = DeepSpeedCPUAdam(_torch(_params()), pin_memory=True,
                           landing_dtype=torch.bfloat16, bf16_copy_back=True)
    for buf in (opt.master, opt.exp_avg, opt.exp_avg_sq, opt._grad_buf,
                opt._landing, opt._bf16_buf):
        assert buf.is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_overlapped_from_the_card_equals_serial_bitwise(cuda, grad_dtype):
    params = _torch(_params())
    kw = dict(MODES["adamw_decay"], bf16_copy_back=True, pin_memory=True,
              landing_dtype=torch.bfloat16)
    serial = DeepSpeedCPUAdam(params, **kw)
    overlap = DeepSpeedCPUAdam(params, **kw)
    rng = np.random.default_rng(7)
    for lr, beta1 in OVERRIDES:
        grads = [g.to(grad_dtype) for g in _torch(_grads(rng))]
        serial.step(grads, lr=lr, beta1=beta1)
        out = overlap.step_overlapped([g.to(cuda) for g in grads], lr=lr,
                                      beta1=beta1, bf16_out=True,
                                      chunk_bytes=LEAF_BYTES)
        assert torch.equal(overlap.master, serial.master)
        assert torch.equal(out, serial.master.to(torch.bfloat16))
    seconds, nbytes = overlap.last_d2h
    assert seconds > 0 and nbytes == overlap.total * (
        2 if grad_dtype == torch.bfloat16 else 4)
