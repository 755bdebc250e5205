"""Failure causes of a supervised worker (a copy of the ``CAUSE_*``
constants of ``deepspeed_tpu/runtime/supervisor/state.py``).

The training supervisor and the serving fleet's router classify every
worker death into one of these; the cause drives telemetry and policy.
"""

CAUSE_CRASH = "crash"            # nonzero/negative exit code
CAUSE_HANG = "hang"              # heartbeat shows a stuck step
CAUSE_PREEMPTION = "preemption"  # clean exit 0 without a done marker
