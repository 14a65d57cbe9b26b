"""Leveled, throttle-capable logger (E14).

Rebuild of the MRPT logging macros the reference uses pervasively —
``MRPT_LOG_DEBUG/INFO/WARN/ERROR`` and the rate-limited
``MRPT_LOG_THROTTLE_ERROR(1.0, ...)`` used on the scan-drop path
(reference src/LidarOdometry.cpp:175), with per-module verbosity
(``getMinLoggingLevel()``, :136).

A copy of ``mola_fe_lidar_tpu/utils/logging.py``: the port imports nothing of the
JAX package. ``tests/test_torch_copies.py`` holds the two equal where they
overlap.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

_THROTTLE_STATE: Dict[str, float] = {}


class ThrottledLogger(logging.LoggerAdapter):
    """stdlib logger + the rate-limited ``error_throttle(period_s, msg)``."""

    def _throttle_ok(self, key: str, period: float) -> bool:
        now = time.monotonic()
        last = _THROTTLE_STATE.get(key, -1e18)
        if now - last >= period:
            _THROTTLE_STATE[key] = now
            return True
        return False

    def _log_throttle(self, level: int, period: float, msg: str, *args) -> None:
        if self._throttle_ok(f"{self.logger.name}:{msg}", period):
            self.logger.log(level, msg, *args)

    def error_throttle(self, period: float, msg: str, *args) -> None:
        self._log_throttle(logging.ERROR, period, msg, *args)


def get_logger(name: str, level: str | int | None = None) -> ThrottledLogger:
    logger = logging.getLogger(f"mola_fe_lidar_tpu_torch.{name}")
    if level is not None:
        if isinstance(level, str):
            level = getattr(logging, level.upper())
        logger.setLevel(level)
    if not logging.getLogger("mola_fe_lidar_tpu_torch").handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(name)s: %(message)s", "%H:%M:%S"))
        root = logging.getLogger("mola_fe_lidar_tpu_torch")
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return ThrottledLogger(logger, {})
