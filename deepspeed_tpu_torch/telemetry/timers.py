"""``SynchronizedWallClockTimer`` (port of the class of that name in
``deepspeed_tpu/telemetry/timers.py``): named timers whose spans are CUDA
event pairs on the card (read after an event synchronize, so queued
device work is counted) and the host's wall clock elsewhere."""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist


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
    def memory_usage():
        """The card's allocator: in use and reserved, in GB."""
        if not torch.cuda.is_available():
            return "memory stats unavailable"
        return (f"in_use {torch.cuda.memory_allocated() / 2**30:.2f}GB "
                f"reserved {torch.cuda.memory_reserved() / 2**30:.2f}GB")

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
