"""Structured logging (counterpart of ``pypardis_tpu/utils/log.py``).

A package logger (``pypardis_tpu_torch``) and the reference's
``LOGGING`` flag name as a switch; :func:`log_phase` writes one line per
phase and always records an ``events.log.<phase>`` event in the current
telemetry recorder, so the log stream and the run report agree.
"""

from __future__ import annotations

import logging

# The reference's flag name (its dbscan.py:9), read here.
LOGGING = False

_logger = logging.getLogger("pypardis_tpu_torch")


def get_logger() -> logging.Logger:
    return _logger


def enable(level: int = logging.INFO) -> None:
    """Attach a stderr handler at ``level``."""
    global LOGGING
    LOGGING = True
    if not _logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("[%(name)s %(levelname)s] %(message)s")
        )
        _logger.addHandler(h)
    _logger.setLevel(level)


def log_phase(phase: str, **fields) -> None:
    """One structured line per pipeline phase.

    Always recorded as an ``events.log.<phase>`` event in the current
    recorder (:mod:`pypardis_tpu_torch.obs`).  The line is emitted when
    the logger is enabled for INFO (standard ``logging`` configuration,
    or :func:`enable`); setting ``LOGGING = True`` directly attaches the
    handler on the next call.
    """
    from ..obs import current
    from ..obs.registry import sanitize_segment

    current().event(f"log.{sanitize_segment(phase)}", **fields)
    if LOGGING and not _logger.handlers:
        enable()
    if _logger.isEnabledFor(logging.INFO):
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        _logger.info("%s %s", phase, kv)
