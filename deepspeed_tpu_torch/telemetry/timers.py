"""Wall-clock and throughput timers (port of
``deepspeed_tpu/telemetry/timers.py``).

:class:`SynchronizedWallClockTimer`: named timers whose spans are CUDA
event pairs on the card (read after an event synchronize, so queued
device work is counted) and the host's wall clock elsewhere; these are
the timers behind ``wall_clock_breakdown``, and ``memory_breakdown``
adds the CUDA caching allocator's figures to their log line.
:class:`ThroughputTimer`: samples a second, synchronized at its ends.
The un-synchronized per-phase spans live in ``telemetry/spans.py``.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _synchronize():
    """Wait for the card's queued work (the JAX package waits with
    ``jax.effects_barrier()``); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Group of named timers, synchronized against async device
    execution."""

    class Timer:
        def __init__(self, name):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self._cuda = torch.cuda.is_available()
            self._start = None

        def _now(self):
            if self._cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                return ev
            return time.time()

        def _span(self, end):
            if self._cuda:
                end.synchronize()
                return self._start.elapsed_time(end) / 1e3
            return end - self._start

        def start(self):
            assert not self.started_, \
                f"timer {self.name_} has already been started"
            self._start = self._now()
            self.started_ = True

        def stop(self, reset=False):
            assert self.started_, f"timer {self.name_} is not started"
            span = self._span(self._now())
            self.elapsed_ = span if reset else self.elapsed_ + span
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started_ = self.started_
            if self.started_:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started_:
                self.start()
            return elapsed_

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    @staticmethod
    def memory_stats():
        """The CUDA caching allocator's bytes on the current device:
        ``{"allocated", "reserved", "max_allocated"}``, or None without
        a card."""
        if not torch.cuda.is_available():
            return None
        return {"allocated": torch.cuda.memory_allocated(),
                "reserved": torch.cuda.memory_reserved(),
                "max_allocated": torch.cuda.max_memory_allocated()}

    @classmethod
    def memory_usage(cls):
        """The allocator's figures as one log fragment, in GB."""
        stats = cls.memory_stats()
        if stats is None:
            return "memory stats unavailable"
        return (f"allocated {stats['allocated'] / 2**30:.2f}GB "
                f"reserved {stats['reserved'] / 2**30:.2f}GB "
                f"max_allocated {stats['max_allocated'] / 2**30:.2f}GB")

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False,
            ranks=None):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = self.timers[name].elapsed(reset=reset) * \
                    1000.0 / normalizer
                string += f" | {name}: {elapsed_time:.2f}"
        if memory_breakdown:
            string += " | " + self.memory_usage()
        log_dist(string, ranks=ranks or [0])


class ThroughputTimer:
    """Samples/sec tracker printed every ``steps_per_output`` steps."""

    def __init__(self,
                 batch_size,
                 num_workers,
                 start_step=2,
                 steps_per_output=50,
                 monitor_memory=False,
                 logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = batch_size if batch_size else 1
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            _synchronize()
            self.start_time = time.time()

    def stop(self, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        self.global_step_count += 1
        if self.start_time > 0:
            _synchronize()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            if report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                self.logging(
                    f"{self.global_step_count}/{self.micro_step_count}, "
                    f"SamplesPerSec={self.avg_samples_per_sec():.4f}")
                if self.monitor_memory:
                    self.logging(SynchronizedWallClockTimer.memory_usage())

    def avg_samples_per_sec(self):
        if self.global_step_count > 0 and self.total_elapsed_time > 0:
            samples_per_step = self.batch_size * self.num_workers
            total_step_offset = self.global_step_count - self.start_step
            avg_time_per_step = self.total_elapsed_time / \
                max(total_step_offset, 1)
            return samples_per_step / avg_time_per_step
        return float("-inf")
