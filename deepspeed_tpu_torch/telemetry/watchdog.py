"""The hang watchdog's heartbeat file naming (``heartbeat_path`` of
``deepspeed_tpu/telemetry/watchdog.py:51``). Serving workers write one
``hb-p<idx:05d>.json`` per loop tick; the fleet router reads it. The
watchdog itself is not ported yet (``ROADMAP.md`` section 1, item 6).
"""

import os

_HB_PREFIX = "hb-p"


def heartbeat_path(directory, process_index):
    return os.path.join(directory,
                        f"{_HB_PREFIX}{int(process_index):05d}.json")
