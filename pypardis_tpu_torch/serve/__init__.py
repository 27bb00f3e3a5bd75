"""Serving: out-of-sample cluster assignment through a core-point index,
live inserts and deletes, streaming ingest, the multi-tenant gateway and
the load harnesses (counterpart of ``pypardis_tpu/serve``).  The
replicated engine is a later slice (ROADMAP A10)."""

from .engine import DeadlineExceeded, QueryEngine, QueueFull
from .gateway import (
    GatewayError,
    ModelGateway,
    ModelNotRegistered,
    StaleModelHandle,
    TenantQuotaExceeded,
)
from .index import CorePointIndex, build_index
from .ingest import Compactor, IngestQueue, WriteTicket
from .live import LiveModel
from .load import gateway_load, sustained_load

__all__ = [
    "CorePointIndex", "QueryEngine", "build_index", "QueueFull",
    "DeadlineExceeded", "LiveModel", "IngestQueue", "Compactor",
    "WriteTicket", "ModelGateway", "GatewayError", "ModelNotRegistered",
    "StaleModelHandle", "TenantQuotaExceeded", "gateway_load",
    "sustained_load",
]
