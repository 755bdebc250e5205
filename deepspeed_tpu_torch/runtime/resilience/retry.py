"""Bounded retry-with-backoff for host-side I/O and worker futures (a copy
of ``deepspeed_tpu/runtime/resilience/retry.py``).

Checkpoint I/O (state files, manifest/meta json, directory renames) and
the ZeRO-Offload host-Adam futures are the two places the engine blocks
on work that can fail transiently (filesystem hiccups on preempted pods,
worker-thread exceptions). Both get the same policy: a bounded number of
attempts with exponential backoff and an overall deadline, after which a
typed :class:`RetryExhaustedError` carries the last underlying failure.
"""

import logging
import time

logger = logging.getLogger(__name__)


class RetryExhaustedError(RuntimeError):
    """All retry attempts failed (or the overall deadline expired).

    ``last_error`` holds the final underlying exception; it is also
    chained as ``__cause__`` so tracebacks stay actionable.
    """

    def __init__(self, what, attempts, last_error):
        super().__init__(
            f"{what} failed after {attempts} attempt(s): "
            f"{type(last_error).__name__}: {last_error}"
        )
        self.attempts = attempts
        self.last_error = last_error


class HostAdamError(RuntimeError):
    """A ZeRO-Offload host-Adam worker raised and retries were exhausted.

    Raised instead of letting the raw worker exception surface from a
    future so callers can distinguish an optimizer-worker failure (host
    state may be mid-update) from ordinary training errors.
    """


def retry_with_backoff(fn, *, what, attempts=3, base_delay_s=0.05,
                       timeout_s=None, retry_on=(Exception,),
                       sleep=time.sleep, clock=time.monotonic):
    """Call ``fn()`` with up to ``attempts`` tries and exponential backoff.

    ``timeout_s`` bounds the total wall time across attempts (checked
    before each retry sleep; a started attempt is never interrupted).
    Non-``retry_on`` exceptions propagate immediately. ``sleep``/``clock``
    are injectable for tests.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    deadline = None if timeout_s is None else clock() + timeout_s
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - retry loop
            last = e
            remaining = attempts - 1 - i
            if remaining == 0:
                break
            if deadline is not None and clock() >= deadline:
                logger.warning("%s: deadline expired after attempt %d/%d",
                               what, i + 1, attempts)
                break
            delay = base_delay_s * (2 ** i)
            if deadline is not None:
                delay = min(delay, max(0.0, deadline - clock()))
            logger.warning("%s: attempt %d/%d failed (%s: %s); retrying in %.3fs",
                           what, i + 1, attempts, type(e).__name__, e, delay)
            sleep(delay)
    raise RetryExhaustedError(what, i + 1, last) from last


def future_result_with_retry(submit, *, what, attempts=3,
                             base_delay_s=0.05, timeout_s=None):
    """Drain a worker future, resubmitting on failure.

    ``submit`` is a zero-arg callable that (re)submits the work and
    returns a ``concurrent.futures.Future``; each attempt waits on a
    fresh future so a failed submission can be retried. Exactly-once
    semantics are the caller's responsibility — only pass work that is
    safe to resubmit (e.g. host-Adam range updates that failed before
    mutating the master buffers). Raises :class:`HostAdamError` (chained
    to a :class:`RetryExhaustedError`) when attempts run out.
    """
    def attempt():
        fut = submit()
        return fut.result(timeout=timeout_s)

    try:
        return retry_with_backoff(attempt, what=what, attempts=attempts,
                                  base_delay_s=base_delay_s,
                                  timeout_s=timeout_s)
    except RetryExhaustedError as e:
        raise HostAdamError(str(e)) from e
