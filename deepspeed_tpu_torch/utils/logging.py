"""Logging utilities (copy of ``deepspeed_tpu/utils/logging.py``).

A singleton package logger plus a rank-filtered ``log_dist``. The rank
comes from ``torch.distributed`` when a process group is up, else 0.
"""

import functools
import logging
import sys

LOG_NAME = "deepspeed_tpu_torch"


@functools.lru_cache(None)
def _create_logger(name=LOG_NAME, level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setLevel(level)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        logger_.addHandler(handler)
    return logger_


logger = _create_logger()


def _process_index():
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except ImportError:
        pass
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given process ranks.

    ``ranks=None`` or ``ranks=[-1]`` logs on every process.
    """
    should_log = ranks is None or (len(ranks) > 0 and ranks[0] == -1)
    if not should_log:
        should_log = _process_index() in set(ranks)
    if should_log:
        rank = _process_index()
        logger.log(level, f"[Rank {rank}] {message}")
