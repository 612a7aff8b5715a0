"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

In the port "rank" is the ``torch.distributed`` rank when a process
group is up, else the ``RANK`` environment variable, else 0."""
from __future__ import annotations

import functools
import logging
import os
import sys

_LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


class LoggerFactory:
    @staticmethod
    def create_logger(name: str = "deepspeed_tpu_torch", level: int = logging.INFO) -> logging.Logger:
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            handler = logging.StreamHandler(stream=sys.stdout)
            handler.setFormatter(logging.Formatter(_LOG_FORMAT))
            handler.setLevel(level)
            logger_.addHandler(handler)
        return logger_


logger = LoggerFactory.create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given ranks (default: rank 0 only);
    ``ranks=[-1]`` logs on every rank."""
    my_rank = _process_index()
    if ranks is None:
        ranks = [0]
    if -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message: str) -> None:
    _warn_once_impl(message)


@functools.lru_cache(maxsize=None)
def _warn_once_impl(message: str) -> None:
    logger.warning(message)
