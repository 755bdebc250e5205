"""One-pass fused Adam(W) over a list of fp32 leaves — K4.

Port of ``deepspeed_tpu/ops/pallas/fused_adam.py``. On CUDA tensors
:func:`fused_adam` makes ONE launch of the hand-written ``sm_90a``
kernel in ``ops/csrc/fused_adam.cu`` for the whole leaf list (a
multi-tensor apply over a device table of chunks, the reference's
``multi_tensor_adam.cu`` shape); a build or launch failure raises. On
CPU tensors it runs :func:`fused_adam_reference`, the plain PyTorch
version with the same arithmetic in the same order. ``fused_adam.launches``
counts kernel launches.

Both update p, m and v in place (the TPU kernel aliases its outputs onto
its inputs; here the port mutates the engine's own buffers). The
hyperparameters ride in an f32[8] device vector — lr, beta1, beta2,
eps, weight_decay, bias_correction1, bias_correction2, skip — so one
launch serves every step of an lr schedule without a host sync; slot 7
(0 in the JAX kernel) carries the fp16 overflow verdict, and a nonzero
value leaves every leaf unchanged.
"""

import ctypes
import functools

import torch

CHUNK = 1 << 16         # elements per CTA of the multi-tensor launch

# the last leaf table built, reused while the leaves keep their storage
_table_cache = {}


def adam_hyperparams(lr, beta1, beta2, eps, weight_decay, bc1, bc2, skip,
                     device):
    """The f32[8] hyperparameter vector on ``device``. ``bc1``, ``bc2``
    and ``skip`` may be device tensors (no host sync); the rest are
    host numbers, copied in one non-blocking transfer."""
    host = torch.tensor([lr, beta1, beta2, eps, weight_decay],
                        dtype=torch.float32)
    device = torch.device(device)
    if device.type == "cuda":
        host = host.pin_memory().to(device, non_blocking=True)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).reshape(1)

    return torch.cat([host, f32(bc1), f32(bc2), f32(skip)])


def _check(params, grads, exp_avgs, exp_avg_sqs, hyper):
    n = len(params)
    if not (len(grads) == len(exp_avgs) == len(exp_avg_sqs) == n) or n == 0:
        raise ValueError(
            f"fused_adam: {n} params, {len(grads)} grads, {len(exp_avgs)} "
            f"exp_avgs, {len(exp_avg_sqs)} exp_avg_sqs")
    device = hyper.device
    if hyper.dtype != torch.float32 or tuple(hyper.shape) != (8,):
        raise ValueError(f"fused_adam: hyper must be f32 [8], got "
                         f"{hyper.dtype} {tuple(hyper.shape)}")
    for group in (params, grads, exp_avgs, exp_avg_sqs):
        for i, t in enumerate(group):
            if t.dtype != torch.float32 or t.device != device or \
                    not t.is_contiguous() or \
                    t.shape != params[i].shape:
                raise ValueError(
                    f"fused_adam: leaf {i} must be contiguous f32 "
                    f"{tuple(params[i].shape)} on {device}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adam runs on cuda or cpu, got {device}")
    return device.type == "cuda"


def adam_leaf_update(p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2,
                     adam_w_mode):
    """One fp32 leaf's new ``(p, m, v)``: the Adam arithmetic of the
    port, in the order of the kernel (``fused_adam.py:32-44``). The
    hyperparameters are 0-d f32 tensors (the kernel's vector, ``1 - b``
    taken in fp32) or Python floats (the XLA update's weakly typed
    constants, ``1 - b`` rounded once to fp32)."""
    g = g if adam_w_mode else g + wd * p
    m_new = b1 * m + (1.0 - b1) * g
    v_new = b2 * v + (1.0 - b2) * g * g
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if adam_w_mode:
        upd = upd + wd * p
    return p - lr * upd, m_new, v_new


def bias_corrections(step, beta1, beta2, bias_correction):
    """``1 - beta ** step`` for both moments as fp32 tensors on
    ``step``'s device, or ``1.0, 1.0`` without bias correction."""
    if not bias_correction:
        return 1.0, 1.0
    sf = step.to(torch.float32)
    return tuple(1.0 - torch.full((), b, dtype=torch.float32,
                                  device=step.device) ** sf
                 for b in (beta1, beta2))


@torch.no_grad()
def fused_adam_reference(params, grads, exp_avgs, exp_avg_sqs, hyper,
                         adam_w_mode=True):
    """Plain K4, in place: :func:`adam_leaf_update` over each leaf with
    the hyperparameters read from ``hyper``."""
    lr, b1, b2, eps, wd, bc1, bc2, skip = hyper.unbind(0)
    keep = skip != 0
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        p_new, m_new, v_new = adam_leaf_update(p, g, m, v, lr, b1, b2, eps,
                                               wd, bc1, bc2, adam_w_mode)
        p.copy_(torch.where(keep, p, p_new))
        m.copy_(torch.where(keep, m, m_new))
        v.copy_(torch.where(keep, v, v_new))


def fused_adam(params, grads, exp_avgs, exp_avg_sqs, hyper,
               adam_w_mode=True):
    """K4: update every leaf's p, m (exp_avg) and v (exp_avg_sq) in place
    from its gradient; ``hyper`` is the f32[8] vector of
    :func:`adam_hyperparams`. All tensors contiguous f32 on one device."""
    if not _check(params, grads, exp_avgs, exp_avg_sqs, hyper):
        return fused_adam_reference(params, grads, exp_avgs, exp_avg_sqs,
                                    hyper, adam_w_mode)
    leaves, chunks = _tables(params, grads, exp_avgs, exp_avg_sqs)
    lib = _library()
    with torch.cuda.device(hyper.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_adam_launch(leaves.data_ptr(), chunks.data_ptr(),
                                    hyper.data_ptr(), chunks.shape[0],
                                    CHUNK, int(bool(adam_w_mode)), stream)
    if err != 0:
        msg = lib.fused_adam_error_string(err).decode()
        raise RuntimeError(f"fused_adam kernel launch failed: {msg}")
    fused_adam.launches += 1


fused_adam.launches = 0


def _tables(params, grads, exp_avgs, exp_avg_sqs):
    """Device tables of the launch: leaves [n, 5] (p, g, m, v pointers,
    numel) and chunks [n_chunks, 2] (leaf, first element). Built once
    per set of storages and reused while the engine keeps its buffers
    (it zeroes gradients in place, so their pointers hold)."""
    key = tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 p.numel())
                for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs))
    hit = _table_cache.get("last")
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    device = params[0].device
    leaves = torch.tensor(key, dtype=torch.int64)
    chunks = torch.tensor(
        [(i, start) for i, row in enumerate(key)
         for start in range(0, row[4], CHUNK)], dtype=torch.int64)
    leaves = leaves.to(device)
    chunks = chunks.to(device)
    _table_cache["last"] = (key, leaves, chunks)
    return leaves, chunks


@functools.lru_cache(None)
def _library():
    from deepspeed_tpu_torch.ops._build import load_library
    lib = load_library("fused_adam")
    p = ctypes.c_void_p
    lib.fused_adam_launch.argtypes = [p, p, p, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int, p]
    lib.fused_adam_launch.restype = ctypes.c_int
    lib.fused_adam_error_string.argtypes = [ctypes.c_int]
    lib.fused_adam_error_string.restype = ctypes.c_char_p
    return lib


def fused_adam_update(params, grads, state, lr, beta1=0.9, beta2=0.999,
                      eps=1e-8, weight_decay=0.0, adam_w_mode=True,
                      bias_correction=True, skip=None):
    """The engine's optimizer step (``pallas_adam_update``'s contract,
    in place): updates ``params`` and ``state.m``/``state.v`` through
    :func:`fused_adam` and returns the new ``AdamState``. ``skip`` (a
    bool device tensor, the fp16 overflow verdict) turns the step into a
    no-op that does not advance ``state.step``."""
    step = state.step + 1
    bc1, bc2 = bias_corrections(step, beta1, beta2, bias_correction)
    flag = 0.0 if skip is None else skip.to(torch.float32)
    hyper = adam_hyperparams(lr, beta1, beta2, eps, weight_decay, bc1, bc2,
                             flag, step.device)
    fused_adam(params, grads, state.m, state.v, hyper, adam_w_mode)
    if skip is not None:
        step = torch.where(skip, state.step, step)
    return state._replace(step=step)
