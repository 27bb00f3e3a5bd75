"""Observability (counterpart of ``pypardis_tpu/obs``).

* :class:`MetricsRegistry`: counters, gauges, timings and bounded
  latency histograms under one dotted key schema (``phase.cluster``,
  ``sharded.halo_factor``, ``events.pair_overflow``, ...);
* :class:`Tracer` and spans: nestable wall-time spans that can wait for
  the card's work (``sync_on``), exported as Chrome-trace JSON;
* :class:`RunRecorder`: one per fit, holding the registry, the tracer
  and the event log; library layers reach the active one through
  :func:`current`, so no signature threads a telemetry handle;
* :func:`build_run_report` / :func:`format_summary`: the schema'd
  ``DBSCAN.report()`` dict and its one-screen rendering;
* :class:`FlightRecorder` / :func:`replay`: the crash-safe JSONL sink
  (``DBSCAN(flight=...)`` / ``PPTORCH_FLIGHT``) and its post-mortem;
* :class:`ResourceSampler`: the per-fit watermark thread behind
  ``report()["resources"]``;
* :func:`heartbeat`: per-round progress lines (``PPTORCH_HEARTBEAT``);
* :class:`Histogram` / :func:`attach_exporters`: the live plane (the
  JSONL snapshotter, ``PPTORCH_METRICS_SNAPSHOT``, and the OpenMetrics
  scrape endpoint, ``PPTORCH_METRICS_PORT``).

The file formats and schema strings are the JAX package's, so either
package's readers take the other's reports, traces and flight files.
The JAX fleet replay (``FleetReplay``) waits for the multi-process layer
(ROADMAP A10).
"""

from .export import Histogram, attach_exporters, last_http_port
from .flight import (
    FLIGHT_SCHEMA,
    FlightRecorder,
    FlightReplay,
    flight_note,
    heartbeat,
    open_flight,
    replay,
)
from .recorder import RunRecorder, current, event, span, use_recorder
from .registry import MetricsRegistry, sanitize_segment, validate_key
from .report import REPORT_SCHEMA, build_run_report, format_summary
from .resources import ResourceSampler
from .trace import Tracer

__all__ = [
    "MetricsRegistry",
    "Tracer",
    "RunRecorder",
    "current",
    "use_recorder",
    "span",
    "event",
    "build_run_report",
    "format_summary",
    "REPORT_SCHEMA",
    "FLIGHT_SCHEMA",
    "FlightRecorder",
    "FlightReplay",
    "Histogram",
    "attach_exporters",
    "last_http_port",
    "flight_note",
    "heartbeat",
    "open_flight",
    "replay",
    "ResourceSampler",
    "sanitize_segment",
    "validate_key",
]
