"""ZeRO (port of ``deepspeed_tpu/runtime/zero``): the config section, the
partition rule (``sharding.py``), the counted collectives (``comm.py``)
and the stage-3 gather-on-use (``stage3.py``); the stages' steps and
ZeRO-Offload run in ``runtime/engine.py``."""
