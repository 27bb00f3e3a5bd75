"""Partitioned fits and label merging (counterpart of
``pypardis_tpu/parallel``): :func:`sharded_dbscan`, the KD route's
chained form on one card, :func:`global_morton_dbscan`, the
global-Morton route's chained form on one card, and the host merge's
union-find.  The collectives and the fused multi-device steps are later
slices (ROADMAP A10-A12)."""

from .global_morton import global_morton_dbscan
from .sharded import sharded_dbscan

__all__ = ["global_morton_dbscan", "sharded_dbscan"]
