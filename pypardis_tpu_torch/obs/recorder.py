"""The per-run telemetry recorder and the ambient current recorder
(counterpart of ``pypardis_tpu/obs/recorder.py``).

One :class:`RunRecorder` per fit bundles the metrics registry, the
tracer and the event log.  Library layers never take a recorder
argument: they call :func:`current` (or the module-level :func:`span` /
:func:`event`), which resolves to the innermost recorder the calling
thread made current, or to a process-wide ambient one when that thread
runs no fit, so bare calls into ``parallel.sharded`` and the serving
stack still record somewhere harmless.  The current recorder is kept
per thread (the JAX package keeps one per process): a compaction's
refit on a background thread and a fit on the caller's thread each
record into their own.  The gateway publishes into its own recorder's
:attr:`RunRecorder.metrics`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

from .registry import MetricsRegistry, _py
from .trace import Tracer


class RunRecorder:
    """Registry + tracer + event log for one run.

    Events are the discrete occurrences of the ladders: pair-budget
    overflows, merge-round retries, kernel builds.  Each appends a
    timestamped dict and bumps the ``events.<kind>`` counter, so the
    report shows counts without replaying the log.
    """

    # Event-log retention cap (the counters keep exact totals past it):
    # the process-ambient recorder lives forever.
    MAX_EVENTS = 16_384

    def __init__(self, device=None):
        self.metrics = MetricsRegistry()
        self.tracer = Tracer(device=device)
        self.events: List[Dict] = []
        # Optional crash-safe JSONL sink (obs.flight.FlightRecorder);
        # attach_flight wires it into the tracer and the registry.
        self.flight = None

    def attach_flight(self, flight) -> None:
        """Stream this recorder's telemetry into ``flight``: span opens
        and closes, events, gauge/counter/timing writes land in its
        append-only JSONL file as they happen."""
        flight.set_epoch(self.tracer.epoch_s)
        self.flight = flight
        self.tracer.sink = flight
        self.metrics.sink = flight

    def span(self, name: str, sync: bool = False, **attrs):
        return self.tracer.span(name, sync=sync, **attrs)

    def event(self, kind: str, **fields) -> None:
        self.metrics.inc(f"events.{kind}")
        if len(self.events) < self.MAX_EVENTS:
            self.events.append(
                {
                    "kind": kind,
                    "t_s": time.perf_counter() - self.tracer.epoch_s,
                    **{k: _py(v) for k, v in fields.items()},
                }
            )
        if self.flight is not None:
            self.flight.event(kind, fields)

    def event_counts(self) -> Dict[str, int]:
        """{event kind -> count} from the counters."""
        pre = "events."
        return {
            k[len(pre):]: int(v)
            for k, v in self.metrics.counters_with_prefix(pre).items()
        }


# Process-wide fallback: telemetry emitted outside any fit lands here
# instead of being dropped.
_AMBIENT = RunRecorder()
# The calling thread's current recorder (``rec``), set by use_recorder.
_local = threading.local()


def current() -> RunRecorder:
    rec = getattr(_local, "rec", None)
    return rec if rec is not None else _AMBIENT


@contextlib.contextmanager
def use_recorder(rec: RunRecorder):
    """Install ``rec`` as the calling thread's current recorder for the
    enclosed block (saved and restored, so nested fits each keep their
    own)."""
    prev = getattr(_local, "rec", None)
    _local.rec = rec
    try:
        yield rec
    finally:
        _local.rec = prev


def span(name: str, sync: bool = False, **attrs):
    """Span on whatever recorder is current."""
    return current().span(name, sync=sync, **attrs)


def event(kind: str, **fields) -> None:
    """Event on whatever recorder is current."""
    current().event(kind, **fields)
