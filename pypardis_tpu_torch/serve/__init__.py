"""Serving: out-of-sample cluster assignment through a core-point index,
live inserts and deletes, and streaming ingest (counterpart of
``pypardis_tpu/serve``).  The replicated engine, the gateway and the
load harness are later slices (ROADMAP A10, A15's second half)."""

from .engine import DeadlineExceeded, QueryEngine, QueueFull
from .index import CorePointIndex, build_index
from .ingest import Compactor, IngestQueue, WriteTicket
from .live import LiveModel

__all__ = [
    "CorePointIndex", "QueryEngine", "build_index", "QueueFull",
    "DeadlineExceeded", "LiveModel", "IngestQueue", "Compactor",
    "WriteTicket",
]
