"""Serving: out-of-sample cluster assignment through a core-point index
(counterpart of ``pypardis_tpu/serve``).  The replicated engine, live
updates, ingest and the gateway are later slices (ROADMAP A10, A15)."""

from .engine import DeadlineExceeded, QueryEngine, QueueFull
from .index import CorePointIndex, build_index

__all__ = [
    "CorePointIndex", "QueryEngine", "build_index", "QueueFull",
    "DeadlineExceeded",
]
