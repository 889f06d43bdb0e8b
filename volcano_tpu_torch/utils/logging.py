"""V-leveled logging in the spirit of klog.

A copy of ``volcano_tpu/utils/logging.py``.

``VLOG_LEVEL`` env var (default 0) controls verbosity; metrics/latency
logging lives in volcano_tpu_torch.scheduler.metrics.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVEL = int(os.environ.get("VLOG_LEVEL", "0"))

_logger = logging.getLogger("volcano_tpu_torch")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s %(message)s"))
    _logger.addHandler(handler)
    _logger.setLevel(logging.INFO)


def v(level: int) -> bool:
    return _LEVEL >= level


def get_logger(name: str = "volcano_tpu_torch") -> logging.Logger:
    """Child logger sharing the root handler/level."""
    if name == "volcano_tpu_torch" or name.startswith("volcano_tpu_torch."):
        return logging.getLogger(name)
    return _logger.getChild(name)


def info(msg: str, *args, level: int = 0) -> None:
    if _LEVEL >= level:
        _logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def error(msg: str, *args) -> None:
    _logger.error(msg, *args)
