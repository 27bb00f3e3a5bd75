"""Partitioned fits and label merging (counterpart of
``pypardis_tpu/parallel``): :func:`sharded_dbscan`, the KD route (its
chained form on one device, its fused step on a :class:`Mesh` of
several), :func:`global_morton_dbscan`, the global-Morton route (its
mesh engine with the tile-granular boundary ring, and its chained form
on one card), the sweep's global neighbour-pair graphs on a mesh
(:func:`sweep_graph_sharded`, :func:`sweep_graph_global_morton`), the
device mesh, the ring halo exchanges,
:func:`sharded_dbscan_device` (a tensor already on the device) and the
host merge's union-find.  The multi-process layer is a later slice
(ROADMAP A10's rest)."""

from .global_morton import global_morton_dbscan, sweep_graph_global_morton
from .mesh import Mesh, default_mesh
from .sharded import (
    SweepGraphOverflow,
    sharded_dbscan,
    sharded_dbscan_device,
    sweep_graph_sharded,
)

__all__ = [
    "Mesh",
    "default_mesh",
    "global_morton_dbscan",
    "sharded_dbscan",
    "sharded_dbscan_device",
    "SweepGraphOverflow",
    "sweep_graph_global_morton",
    "sweep_graph_sharded",
]
