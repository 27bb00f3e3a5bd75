"""The per-run telemetry recorder (counterpart of
``pypardis_tpu/obs/recorder.py``'s :class:`RunRecorder`, its metrics
registry only).

The gateway publishes its residency, admission and latency numbers into
its recorder's :attr:`RunRecorder.metrics`.  The JAX recorder's tracer
spans, event log, flight recorder and the ambient ``current()`` recorder
are not ported yet (ROADMAP A16).
"""

from __future__ import annotations

from .registry import MetricsRegistry


class RunRecorder:
    """Holds one :class:`~.registry.MetricsRegistry` (``metrics``)."""

    def __init__(self):
        self.metrics = MetricsRegistry()
