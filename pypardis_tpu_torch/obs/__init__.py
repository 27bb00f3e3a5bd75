"""Observability (counterpart of ``pypardis_tpu/obs``): the bounded
latency :class:`Histogram`, the :class:`MetricsRegistry` and a
:class:`RunRecorder` that holds one.  Spans, the event log, the flight
recorder, run reports and the export plane are ROADMAP A16."""

from .export import Histogram
from .recorder import RunRecorder
from .registry import MetricsRegistry, sanitize_segment, validate_key

__all__ = ["Histogram", "MetricsRegistry", "RunRecorder",
           "sanitize_segment", "validate_key"]
