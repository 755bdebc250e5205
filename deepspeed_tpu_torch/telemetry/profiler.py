"""Device-time profiling: a ``torch.profiler`` trace window and per-step
timings (port of ``deepspeed_tpu/telemetry/profiler.py``).

The JAX package captures a ``jax.profiler`` (xprof) trace for a window
of steps; the port captures a ``torch.profiler`` trace of the same
window, with the CPU activity and, on the card, the CUDA activity, and
writes it as one Chrome trace (``trace-step<N>-p<pid>.json``, viewable
in Perfetto or ``chrome://tracing``) into ``trace_dir`` when the window
closes. The step-phase spans (``telemetry/spans.py``) open
``record_function`` ranges, so the trace shows ``ds_tpu/dispatch``,
``ds_tpu/device_wait`` and the rest as named ranges beside the kernels.

Config surface (``wall_clock_breakdown`` drives the synchronized timers;
this is the trace window)::

    "profiling": {
        "trace_dir": "/tmp/trace",        # where the Chrome traces go
        "trace_start_step": 10,            # first traced optimizer step
        "trace_num_steps": 3               # how many steps to capture
    }

:func:`device_report` prints what ``torch.cuda`` says of the devices.
"""

import collections
import os

from deepspeed_tpu_torch.utils.logging import log_dist

_KNOWN_KEYS = ("trace_dir", "trace_start_step", "trace_num_steps",
               "history")


class TraceProfiler:
    """Captures a ``torch.profiler`` trace for a configured step window
    and keeps a rolling record of synchronized per-step durations."""

    def __init__(self, trace_dir=None, trace_start_step=0,
                 trace_num_steps=0, history=100, **unknown):
        if unknown:
            raise ValueError(
                f"unknown 'profiling' config keys {sorted(unknown)}; "
                f"supported: {list(_KNOWN_KEYS)}")
        self.trace_dir = trace_dir
        self.start_step = int(trace_start_step)
        self.num_steps = int(trace_num_steps)
        self._active = False
        self._prof = None
        self._first = None
        self.armed_reason = None
        self.traces = []           # the Chrome traces written, in order
        self.step_times = collections.deque(maxlen=history)

    @property
    def enabled(self):
        return self.trace_dir is not None and self.num_steps > 0

    def arm(self, start_step, num_steps, trace_dir=None, reason=None):
        """(Re-)point the capture window at a future step: the
        anomaly-triggered capture path (a step-wall regression or a guard
        trip arms the *next* ``num_steps`` steps). Re-arming after a
        window closed is supported; an in-flight window is never
        disturbed. Returns True when armed."""
        if self._active:
            return False
        if trace_dir is not None:
            self.trace_dir = str(trace_dir)
        if self.trace_dir is None or int(num_steps) <= 0:
            return False
        self.start_step = int(start_step)
        self.num_steps = int(num_steps)
        self.armed_reason = reason
        log_dist(f"profiler: armed {self.num_steps}-step trace window at "
                 f"step {self.start_step}"
                 f"{f' ({reason})' if reason else ''} -> {self.trace_dir}",
                 ranks=[0])
        return True

    def in_window(self, global_step):
        """True only for steps inside the trace window: the engine syncs
        per-step timing for these (and for wall_clock_breakdown runs),
        not for the whole run."""
        return self.enabled and (
            self.start_step <= global_step <
            self.start_step + self.num_steps)

    def before_step(self, global_step):
        if not self.enabled or self._active:
            return
        if self.in_window(global_step):
            import atexit

            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._active = True
            self._first = global_step
            # a window past the end of the run still writes its trace
            atexit.register(self.close)
            log_dist(f"profiler: trace started at step {global_step} "
                     f"-> {self.trace_dir}", ranks=[0])

    def after_step(self, global_step, duration=None):
        if duration is not None:
            self.step_times.append(duration)
        if self._active and \
                global_step >= self.start_step + self.num_steps - 1:
            self.close(global_step)

    def close(self, global_step=None):
        """Stop an in-flight trace and write it (idempotent; also called
        at interpreter exit so a run ending inside the window still
        writes its trace). Returns the trace's path, or None."""
        if not self._active:
            return None
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        self._active = False
        prof.__exit__(None, None, None)
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir,
                            f"trace-step{self._first}-p{os.getpid()}.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)
        log_dist(f"profiler: trace stopped"
                 f"{f' after step {global_step}' if global_step is not None else ''}"
                 f" -> {path}", ranks=[0])
        return path

    def summary(self):
        """(mean, min, max) of recorded synchronized step seconds."""
        if not self.step_times:
            return None
        ts = list(self.step_times)
        return sum(ts) / len(ts), min(ts), max(ts)


def device_report(out=None):
    """Print the devices ``torch.cuda`` sees: the platform, each card's
    name, compute capability and memory, and the count; ``cpu`` and one
    host device without a card."""
    import sys

    import torch

    out = out or sys.stdout
    print("-" * 64, file=out)
    print("device topology", file=out)
    print("-" * 64, file=out)
    if not torch.cuda.is_available():
        print(f"{'platform':.<30} cpu", file=out)
        print(f"{'device kind':.<30} host CPU "
              f"({torch.get_num_threads()} threads)", file=out)
        print(f"{'local devices':.<30} 1", file=out)
        print(f"{'global devices':.<30} 1", file=out)
        print("  device 0: cpu", file=out)
        return
    n = torch.cuda.device_count()
    print(f"{'platform':.<30} cuda {torch.version.cuda}", file=out)
    print(f"{'device kind':.<30} {torch.cuda.get_device_name(0)}",
          file=out)
    print(f"{'local devices':.<30} {n}", file=out)
    print(f"{'global devices':.<30} {n}", file=out)
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        print(f"  device {i}: {props.name} sm_{props.major}{props.minor} "
              f"{props.total_memory / 2**30:.1f} GiB "
              f"{props.multi_processor_count} SMs", file=out)
