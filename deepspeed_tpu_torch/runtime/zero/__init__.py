"""ZeRO (port of ``deepspeed_tpu/runtime/zero``): the config section;
ZeRO-Offload runs in ``runtime/engine.py``."""
