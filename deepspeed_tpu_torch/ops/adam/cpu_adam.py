"""DeepSpeedCPUAdam: the host-RAM optimizer behind ZeRO-Offload (port of
``deepspeed_tpu/ops/adam/cpu_adam.py``).

The fp32 masters and both Adam moments live in host memory as flat
torch CPU buffers, and every update runs DeepSpeed's AVX-512 / AVX2 +
OpenMP C++ Adam (``ops/csrc/cpu_adam.cpp``, the same source as the JAX
package's, built by ``ops/_build.py:load_host_library``) over them,
through ``ctypes``. :func:`adam_plain` is the same AdamW in plain torch
over the same buffers: the tests hold the kernel against it, and no
engine runs it.

Buffers (one flat element per param element, leaves in order):

- ``master``, ``exp_avg``, ``exp_avg_sq``: fp32;
- ``_grad_buf``: the fp32 gradient the kernel reads;
- ``_landing`` (with ``landing_dtype``): where 16-bit gradients land
  from the device before the widen into ``_grad_buf``;
- ``_bf16_buf`` (with ``bf16_copy_back``): the bf16 copy of the masters
  for the device upload.

Every buffer is declared to the constructor; a step that needs one it
was not given raises.

With ``pin_memory`` (the engine asks for it when its device is CUDA)
they are carved out of one pinned allocation, made once: the caching
host allocator rounds a block up to a power of two, so six blocks would
waste far more than one. A CPU-only torch cannot pin, and then the
constructor raises; it never falls back to pageable memory.

Bitwise contract: the kernel's SIMD body and its scalar tail round
differently (FMA against separate mul-adds), so :meth:`step_overlapped`
runs its ranges on 16-element boundaries (:data:`RANGE_ALIGN`): every
element then takes the path it takes in one whole-buffer call, and the
overlapped step equals :meth:`step` bit for bit. The chunk plan itself
stays leaf-aligned (the unit of the device copies and of ``on_chunk``).
"""

import bisect
import concurrent.futures
import ctypes
import itertools
import time

import torch

from deepspeed_tpu_torch.ops._build import load_host_library

_ids = itertools.count()
# multiple of the widest SIMD body (AVX-512: 16 floats) and a cache line
RANGE_ALIGN = 16
_PF = ctypes.POINTER(ctypes.c_float)
_PU16 = ctypes.POINTER(ctypes.c_uint16)


def load_cpu_adam():
    """The C++ Adam library with its ``ctypes`` signatures (those of
    ``deepspeed_tpu/ops/op_builder/builder.py:CPUAdamBuilder``)."""
    lib = load_host_library("cpu_adam")
    i64, f32 = ctypes.c_int64, ctypes.c_float
    lib.ds_create_adam.argtypes = [ctypes.c_int, f32, f32, f32, f32, f32,
                                   ctypes.c_int, ctypes.c_int]
    lib.ds_create_adam.restype = ctypes.c_int
    lib.ds_destroy_adam.argtypes = [ctypes.c_int]
    lib.ds_destroy_adam.restype = ctypes.c_int
    lib.ds_adam_step.argtypes = [ctypes.c_int, i64, f32, f32, _PF, _PF,
                                 _PF, _PF, i64]
    lib.ds_adam_step.restype = ctypes.c_int
    lib.ds_fp32_to_bf16.argtypes = [_PF, _PU16, i64]
    lib.ds_fp32_to_bf16.restype = None
    lib.ds_simd_width.restype = ctypes.c_int
    return lib


def _fptr(t, off=0):
    return ctypes.cast(ctypes.c_void_p(t.data_ptr() + 4 * off), _PF)


def _u16ptr(t, off=0):
    return ctypes.cast(ctypes.c_void_p(t.data_ptr() + 2 * off), _PU16)


@torch.no_grad()
def adam_plain(master, grad, exp_avg, exp_avg_sq, step, lr, beta1=0.9,
               beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True,
               bias_correction=True):
    """The C++ kernel's update in plain torch, in place on the flat fp32
    buffers (the scalar path of ``cpu_adam.cpp``: decoupled decay at the
    raw lr, L2 decay folded into the gradient otherwise). ``step`` is the
    1-based applied-step count."""
    f32 = torch.float32
    one = torch.tensor(1.0, dtype=f32)
    b1, b2 = torch.tensor(beta1, dtype=f32), torch.tensor(beta2, dtype=f32)
    bc1, bc2_sqrt = one, one
    if bias_correction:
        bc1 = one - b1 ** step
        bc2_sqrt = torch.sqrt(one - b2 ** step)
    step_size = torch.tensor(lr, dtype=f32) / bc1
    g = grad
    if not adamw_mode and weight_decay != 0.0:
        g = g + weight_decay * master
    exp_avg.mul_(b1).add_((one - b1) * g)
    exp_avg_sq.mul_(b2).add_((one - b2) * g * g)
    denom = torch.sqrt(exp_avg_sq) / bc2_sqrt + eps
    lr_wd = lr * weight_decay if adamw_mode else 0.0
    master.sub_(step_size * (exp_avg / denom) + lr_wd * master)


class DeepSpeedCPUAdam:
    """Flat-buffer host AdamW over a list of param tensors.

    ``params`` (tensors on any device, any float dtype) seed the fp32
    masters. ``step(grads)`` takes the matching gradient tensors (any
    device, fp32 or 16-bit), runs one C++ update over the whole buffer
    and returns the masters as fp32 views, one per leaf.
    """

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, adamw_mode=True,
                 amsgrad=False, pin_memory=False, landing_dtype=None,
                 bf16_copy_back=False):
        if amsgrad:
            raise RuntimeError("CPUAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.pin_memory = bool(pin_memory)
        self.lib = load_cpu_adam()
        self.opt_id = next(_ids)
        self.lib.ds_create_adam(
            self.opt_id, ctypes.c_float(lr), ctypes.c_float(betas[0]),
            ctypes.c_float(betas[1]), ctypes.c_float(eps),
            ctypes.c_float(weight_decay), int(adamw_mode),
            int(bias_correction))

        params = list(params)
        self.shapes = [tuple(p.shape) for p in params]
        self.sizes = [int(p.numel()) for p in params]
        self.total = sum(self.sizes)
        self.offsets = list(itertools.accumulate([0] + self.sizes))
        buffers = [("master", torch.float32), ("exp_avg", torch.float32),
                   ("exp_avg_sq", torch.float32),
                   ("_grad_buf", torch.float32)]
        if landing_dtype is not None:
            buffers.append(("_landing", landing_dtype))
        if bf16_copy_back:
            buffers.append(("_bf16_buf", torch.bfloat16))
        self._landing = self._bf16_buf = None
        for name, buf in zip([n for n, _ in buffers],
                             self._allocate([d for _, d in buffers])):
            setattr(self, name, buf)
        with torch.no_grad():
            for p, off, size in zip(params, self.offsets, self.sizes):
                self.master[off:off + size].copy_(p.detach().reshape(-1))
        self.exp_avg.zero_()
        self.exp_avg_sq.zero_()
        self._step = 0
        self._pool = None        # lazy 1-thread worker for step_overlapped
        self._copy_stream = None
        self._chunks = None
        self._chunk_bytes = None
        # Resilience: bounded resubmission of range updates that failed
        # BEFORE the C++ kernel touched the buffers (errors flagged
        # ``host_state_clean``); a mid-kernel failure may have half-applied
        # the moments, so it surfaces as a typed HostAdamError.
        self.host_adam_retries = 0
        self.host_adam_timeout_s = None
        # the last step's seconds in the C++ Adam and in the bf16 convert
        # (summed over ranges), and its D2H (device seconds, bytes)
        self.last_adam_s = 0.0
        self.last_convert_s = 0.0
        self.last_d2h = (0.0, 0)

    def _allocate(self, dtypes):
        """One flat buffer of ``total`` elements per dtype, carved out of
        a single allocation (pinned with ``pin_memory``), each starting on
        a 64-byte boundary."""
        starts, nbytes = [], 0
        for dtype in dtypes:
            starts.append(nbytes)
            size = self.total * torch.empty((), dtype=dtype).element_size()
            nbytes += -(-size // 64) * 64
        arena = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                            pin_memory=self.pin_memory)
        if self.pin_memory and not arena.is_pinned():
            raise RuntimeError("pinned host allocation failed")
        out = []
        for dtype, start in zip(dtypes, starts):
            size = self.total * torch.empty((), dtype=dtype).element_size()
            out.append(arena[start:start + size].view(dtype))
        return out

    def _declared(self, name, dtype, flag):
        """The flat buffer ``name`` of ``dtype``; the constructor's
        ``flag`` declares it, and a step that needs an undeclared one
        raises."""
        buf = getattr(self, name)
        if buf is None or buf.dtype != dtype:
            raise ValueError(f"a {dtype} {name.strip('_')} buffer was not "
                             f"declared to the constructor ({flag})")
        return buf

    def __del__(self):
        try:
            if self._pool is not None:
                # the worker calls ds_adam_step on this opt_id: wait for it
                self._pool.shutdown(wait=True)
            self.lib.ds_destroy_adam(self.opt_id)
        except Exception:
            pass

    def simd_width(self):
        """The SIMD width the kernel was built with (16 AVX-512, 8 AVX2,
        1 scalar)."""
        return int(self.lib.ds_simd_width())

    # -- core --------------------------------------------------------------
    def _land(self, grads, lo, hi, non_blocking=False):
        """Copy leaves ``lo..hi-1`` of ``grads`` (a list of leaves, or one
        flat tensor: then one copy) into the landing buffer of their
        dtype (``_grad_buf`` for fp32)."""
        dtype = grads.dtype if torch.is_tensor(grads) else grads[0].dtype
        dst = self._grad_buf if dtype == torch.float32 else self._landing
        if torch.is_tensor(grads):
            a, b = self.offsets[lo], self.offsets[hi]
            dst[a:b].copy_(grads[a:b], non_blocking=non_blocking)
            return
        for k in range(lo, hi):
            o, s = self.offsets[k], self.sizes[k]
            dst[o:o + s].copy_(grads[k].detach().reshape(-1),
                               non_blocking=non_blocking)

    def _widen(self, dtype, lo, hi):
        """16-bit landed leaves ``lo..hi-1`` widened into ``_grad_buf``."""
        if hi > lo and dtype != torch.float32:
            a, b = self.offsets[lo], self.offsets[hi]
            self._grad_buf[a:b].copy_(self._landing[a:b])

    def _check_grads(self, grads):
        """``grads`` as a list of leaves, or as one flat tensor of
        ``total`` elements, with a landing buffer for their dtype; returns
        ``(grads, dtype, on_cuda)``."""
        if torch.is_tensor(grads):
            grads = grads.detach()
            if grads.dim() != 1 or grads.numel() != self.total:
                raise ValueError(f"a flat gradient must have {self.total} "
                                 f"elements, got {tuple(grads.shape)}")
            dtype, on_cuda = grads.dtype, grads.is_cuda
        else:
            grads = list(grads)
            if len(grads) != len(self.sizes):
                raise ValueError(f"expected {len(self.sizes)} gradient "
                                 f"leaves, got {len(grads)}")
            if len({g.dtype for g in grads}) != 1:
                raise ValueError("gradient leaves of mixed dtypes")
            dtype, on_cuda = grads[0].dtype, grads[0].is_cuda
        if dtype != torch.float32:
            self._declared("_landing", dtype, "landing_dtype")
        return grads, dtype, on_cuda

    def step(self, grads, lr=None, beta1=None):
        """One Adam step over the whole buffer; returns the updated
        masters (fp32 views). ``lr`` / ``beta1`` override the
        constructor's values (schedules)."""
        grads, dtype, _ = self._check_grads(grads)
        n = len(self.sizes)
        with torch.no_grad():
            self._land(grads, 0, n)
            self._widen(dtype, 0, n)
        self._step += 1
        t0 = time.perf_counter()
        rc = self.lib.ds_adam_step(
            self.opt_id, ctypes.c_int64(self._step),
            ctypes.c_float(-1.0 if lr is None else lr),
            ctypes.c_float(-1.0 if beta1 is None else beta1),
            _fptr(self.master), _fptr(self._grad_buf), _fptr(self.exp_avg),
            _fptr(self.exp_avg_sq), ctypes.c_int64(self.total))
        self.last_adam_s = time.perf_counter() - t0
        self.last_convert_s = 0.0
        if rc != 0:
            raise RuntimeError(f"ds_adam_step failed with {rc}")
        return self.params()

    # -- overlapped step ---------------------------------------------------
    def _chunk_plan(self, chunk_bytes):
        """Group whole leaves into contiguous flat ranges of ~chunk_bytes
        of fp32 (``(leaf_lo, leaf_hi, off, n)``); a leaf larger than the
        target gets a chunk of its own."""
        target = max(1, chunk_bytes // 4)
        chunks = []
        i = 0
        while i < len(self.sizes):
            j, n = i, 0
            while j < len(self.sizes) and (n == 0 or
                                           n + self.sizes[j] <= target):
                n += self.sizes[j]
                j += 1
            chunks.append((i, j, self.offsets[i], n))
            i = j
        return chunks

    def _range_starts(self, chunks):
        """Start of each chunk's Adam range: its offset rounded down to
        :data:`RANGE_ALIGN` (the first at 0). Range k is [starts[k],
        starts[k+1]), the last ends at ``total``."""
        return [0] + [off - off % RANGE_ALIGN for _, _, off, _ in chunks[1:]]

    def _update_range(self, step, lr, beta1, off, n, to_bf16):
        """Adam (and with ``to_bf16`` the bf16 convert) on the flat range
        [off, off+n). The kernel is elementwise and reads only its
        config, so range calls on SIMD-aligned bounds equal one
        whole-buffer call bit for bit."""
        t0 = time.perf_counter()
        rc = self.lib.ds_adam_step(
            self.opt_id, ctypes.c_int64(step), ctypes.c_float(lr),
            ctypes.c_float(beta1), _fptr(self.master, off),
            _fptr(self._grad_buf, off), _fptr(self.exp_avg, off),
            _fptr(self.exp_avg_sq, off), ctypes.c_int64(n))
        t1 = time.perf_counter()
        self.last_adam_s += t1 - t0
        if rc != 0:
            raise RuntimeError(f"ds_adam_step failed with {rc}")
        if to_bf16:
            self.lib.ds_fp32_to_bf16(_fptr(self.master, off),
                                     _u16ptr(self._bf16_buf, off),
                                     ctypes.c_int64(n))
            self.last_convert_s += time.perf_counter() - t1

    def _guarded_update_range(self, step, lr, beta1, off, n, to_bf16):
        """Worker entry: the fault probe fires before the kernel, so an
        injected failure is always pre-mutation (exactly resubmittable)."""
        from deepspeed_tpu_torch.runtime.resilience import fault_injection
        fault_injection.maybe_fail_host_adam()
        return self._update_range(step, lr, beta1, off, n, to_bf16)

    def submit_update_range(self, step, lr, beta1, off, n, to_bf16):
        """Submit one guarded range update to the worker; pair each future
        with :meth:`drain_update` (same args) to collect it."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        return self._pool.submit(self._guarded_update_range, step, lr,
                                 beta1, off, n, to_bf16)

    def drain_update(self, fut, step, lr, beta1, off, n, to_bf16):
        """Wait for a submitted range update, resubmitting pre-mutation
        failures up to ``host_adam_retries`` times with backoff; exhausted
        retries and mid-kernel failures raise a typed ``HostAdamError``."""
        from deepspeed_tpu_torch.runtime.resilience.retry import (
            HostAdamError, future_result_with_retry)
        what = f"host-Adam range [{off}, {off + n})"
        try:
            return fut.result(timeout=self.host_adam_timeout_s)
        except Exception as e:
            if not getattr(e, "host_state_clean", False):
                raise HostAdamError(
                    f"{what} failed mid-update ({type(e).__name__}: {e}); "
                    "host master/moment buffers may be partially updated — "
                    "restore from the last checkpoint") from e
            if self.host_adam_retries <= 0:
                raise HostAdamError(
                    f"{what} failed before touching host state "
                    f"({type(e).__name__}: {e}) and retries are disabled "
                    "(host_adam_retries=0)") from e
            return future_result_with_retry(
                lambda: self.submit_update_range(step, lr, beta1, off, n,
                                                 to_bf16),
                what=what, attempts=self.host_adam_retries,
                timeout_s=self.host_adam_timeout_s)

    def step_overlapped(self, grads, lr=None, beta1=None, bf16_out=False,
                        chunk_bytes=1 << 26, on_chunk=None):
        """One Adam step with the host phase software-pipelined.

        Every chunk's device-to-host copy is issued up front on a copy
        stream (CUDA gradients; one event a chunk), then per leaf-aligned
        chunk the calling thread waits for chunk k's bytes and widens
        16-bit ones into the fp32 buffer while a worker thread runs the
        C++ Adam (and with ``bf16_out`` the bf16 convert) of the chunks
        before it: ``ctypes`` releases the GIL, so copy and compute
        overlap.

        ``on_chunk(leaf_lo, leaf_hi)`` runs on the calling thread, in
        chunk order, once every element of the chunk's leaves is updated
        (and converted): the engine starts each chunk's upload there.
        Returns the masters (fp32 views), or with ``bf16_out`` the flat
        bf16 copy of the masters.
        """
        grads, dtype, on_cuda = self._check_grads(grads)
        if self._chunks is None or chunk_bytes != self._chunk_bytes:
            self._chunks = self._chunk_plan(chunk_bytes)
            self._chunk_bytes = chunk_bytes
        chunks = self._chunks
        if bf16_out:
            self._declared("_bf16_buf", torch.bfloat16, "bf16_copy_back")
        starts = self._range_starts(chunks)
        ends = starts[1:] + [self.total]
        # the range that finishes each chunk's last element
        done_at = [max(bisect.bisect_right(starts, off + n - 1) - 1, 0)
                   for _, _, off, n in chunks]
        events = []
        self.last_adam_s = self.last_convert_s = 0.0
        with torch.no_grad():
            if on_cuda:
                device = grads.device if torch.is_tensor(grads) \
                    else grads[0].device
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(device)
                stream = self._copy_stream
                stream.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(stream):
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    for li, lj, _, _ in chunks:
                        self._land(grads, li, lj, non_blocking=True)
                        events.append(torch.cuda.Event(enable_timing=True))
                        events[-1].record(stream)
            self._step += 1
            step = self._step
            eff_lr = -1.0 if lr is None else lr
            eff_b1 = -1.0 if beta1 is None else beta1
            futs = []
            for k, (li, lj, _, _) in enumerate(chunks):
                if on_cuda:
                    events[k].synchronize()
                else:
                    self._land(grads, li, lj)
                self._widen(dtype, li, lj)
                futs.append(self.submit_update_range(
                    step, eff_lr, eff_b1, starts[k], ends[k] - starts[k],
                    bf16_out))
            j = 0
            try:
                for k, f in enumerate(futs):
                    # propagate worker failures in order, retrying clean
                    # ones
                    self.drain_update(f, step, eff_lr, eff_b1, starts[k],
                                      ends[k] - starts[k], bf16_out)
                    while j < len(chunks) and done_at[j] <= k:
                        if on_chunk is not None:
                            on_chunk(chunks[j][0], chunks[j][1])
                        j += 1
            except BaseException:
                # leave no range running behind the caller's back: the
                # ones not started are cancelled, the running one waited
                for f in futs:
                    f.cancel()
                concurrent.futures.wait(futs)
                raise
            if on_cuda:
                nbytes = self.total * torch.empty(
                    (), dtype=dtype).element_size()
                self.last_d2h = (start.elapsed_time(events[-1]) / 1e3,
                                 nbytes)
        if bf16_out:
            return self._bf16_buf
        return self.params()

    def params(self):
        """Current masters as fp32 views, one per leaf (no copy)."""
        return [self.master[off:off + size].view(shape)
                for off, size, shape in zip(self.offsets, self.sizes,
                                            self.shapes)]

    def params_bf16_flat(self):
        """Masters converted to bf16 by the C++ kernel into the flat
        copy-back buffer (returned; the next step rewrites it)."""
        out = self._declared("_bf16_buf", torch.bfloat16, "bf16_copy_back")
        self.lib.ds_fp32_to_bf16(_fptr(self.master), _u16ptr(out),
                                 ctypes.c_int64(self.total))
        return out

    # -- checkpoint --------------------------------------------------------
    def state_dict(self):
        return {"master": self.master.clone(), "exp_avg": self.exp_avg.clone(),
                "exp_avg_sq": self.exp_avg_sq.clone(), "step": self._step}

    def load_state_dict(self, state):
        with torch.no_grad():
            for name in ("master", "exp_avg", "exp_avg_sq"):
                getattr(self, name).copy_(
                    torch.as_tensor(state[name]).reshape(-1).float())
        self._step = int(state["step"])

