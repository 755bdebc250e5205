"""What the serving fleet takes from the ``ds_tpu_run`` supervisor of
``deepspeed_tpu/runtime/supervisor/``: the failure causes and the exit /
heartbeat classifiers. The supervisor itself and its launcher are not
ported yet (``ROADMAP.md`` section 1, item 6)."""
