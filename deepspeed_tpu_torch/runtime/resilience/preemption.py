"""Graceful preemption: catch SIGTERM, act at the next step boundary,
exit cleanly (a copy of ``deepspeed_tpu/runtime/resilience/
preemption.py``).

Spot and preemptible capacity announce eviction with SIGTERM and a
grace window. The serving fleet's workers (``inference/fleet_worker.py``)
finish the current decode step, report what completed and exit 0
without their done marker. The training engine (``resilience.
preemption.save_on_sigterm``) saves a checkpoint at the next step
boundary and raises :class:`PreemptedError` with its path. The handler
only sets a flag: all actual work happens synchronously at the next
step boundary, where the state is consistent (signal-handler-safe: no
I/O, no locks in the handler itself).
"""

import faulthandler
import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptedError(SystemExit):
    """Raised at a step boundary after SIGTERM once the engine has saved
    a preemption checkpoint. Subclasses SystemExit so an unhandled
    preemption exits cleanly (code 0 — the work was safely persisted)
    instead of dumping a traceback; supervisors that want to keep the
    process alive can still catch it explicitly."""

    def __init__(self, message, checkpoint_path=None):
        super().__init__(0)
        self.message = message
        self.checkpoint_path = checkpoint_path

    def __str__(self):
        return self.message


class PreemptionHandler:
    """Flag-based SIGTERM latch checked between steps.

    ``install()`` chains any pre-existing SIGTERM handler (it is invoked
    after the flag is set) and is idempotent. The handler is installed
    only on the main thread — Python restricts ``signal.signal`` to it —
    and on other threads :meth:`install` degrades to flag-only mode,
    where :meth:`trigger` (used by the fault-injection harness) is the
    only way the flag gets set.
    """

    def __init__(self, signum=signal.SIGTERM):
        self.signum = signum
        self._flag = threading.Event()
        self._prev_handler = None
        self._installed = False

    def install(self):
        if self._installed:
            return self
        if threading.current_thread() is threading.main_thread():
            self._prev_handler = signal.signal(self.signum, self._on_signal)
            self._installed = True
            self._register_sigquit_dump()
        else:
            logger.warning(
                "PreemptionHandler.install() called off the main thread; "
                "SIGTERM will not be caught (flag-only mode)")
        return self

    def _register_sigquit_dump(self):
        """Register a faulthandler all-thread stack dump on SIGQUIT, so
        any resilience-enabled run answers ``kill -QUIT <pid>`` with
        "where is every thread stuck" on stderr — no config needed.
        ``chain=False``: with no prior Python handler the previous
        disposition is SIG_DFL, and chaining would re-raise into it
        (terminate + core) — replacing keeps the process running. The
        flight recorder's own SIGQUIT handler, installed later,
        supersedes this and prints the same stacks itself."""
        sigquit = getattr(signal, "SIGQUIT", None)
        if sigquit is None:       # pragma: no cover - non-POSIX
            return
        try:
            faulthandler.register(sigquit, chain=False)
            self._sigquit_registered = True
        except (AttributeError, ValueError, OSError):  # pragma: no cover
            self._sigquit_registered = False

    def uninstall(self):
        if self._installed:
            signal.signal(self.signum, self._prev_handler or signal.SIG_DFL)
            self._installed = False
            self._prev_handler = None
            if getattr(self, "_sigquit_registered", False):
                try:
                    faulthandler.unregister(signal.SIGQUIT)
                except (AttributeError, ValueError):  # pragma: no cover
                    pass
                self._sigquit_registered = False

    def _on_signal(self, signum, frame):
        self._flag.set()
        logger.warning("received signal %d: will checkpoint and exit at "
                       "the next step boundary", signum)
        if callable(self._prev_handler):
            self._prev_handler(signum, frame)

    def trigger(self):
        """Set the preemption flag directly (fault-injection path)."""
        self._flag.set()

    @property
    def preempted(self):
        return self._flag.is_set()

    def clear(self):
        self._flag.clear()
