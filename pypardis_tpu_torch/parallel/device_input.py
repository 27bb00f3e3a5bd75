"""Routing and laying out a tensor that already lies on the device
(counterpart of ``pypardis_tpu/parallel/device_input.py``).

The reference's ``train(rdd)`` takes data that is already distributed;
no one process holds it whole.  The port's counterpart is a tensor on the
card: the KD split planes come from a small host subsample
(:func:`~.sharded.sharded_dbscan_device`), and everything that touches
all N points runs in torch on the tensor's device: the tree's routing
(:func:`device_route`), the partition counts, the Morton-sorted
``(P, k, cap)`` owned slabs and each partition's box
(:func:`device_owned_layout`).  The ring exchange then collects the
halos on the mesh, so the ``(N, k)`` coordinates never come back to the
host.

The boxes are the tight boxes of each partition's routed members in the
recentred float32 frame, not the KD split boxes: every owned point lies
inside its tight box, so the 2*eps argument of the halo holds, and a
tighter box only shrinks the halo.

Every step is the JAX program's operation sequence, so ``pid`` and the
counts are bitwise the JAX package's.  The slab coordinates are not:
the recentring mean is a float32 reduction whose summation order
differs between XLA and torch (ROADMAP §C, facts about the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hierarchy import _lexsort
from ..ops.pipeline import _device_morton_words

_BIG = 3e38


def tree_arrays(tree):
    """The split tree ``[(parent, axis, boundary, left, right)]`` (the
    ``KDPartitioner.tree`` records, in construction order) as flat numpy
    arrays ``(parent, axis, boundary, right)``; a left child keeps its
    parent's label, so only the right label is needed.  The boundaries
    are rounded to float32."""
    if not tree:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32), np.zeros(0, np.int32))
    return (np.array([t[0] for t in tree], np.int32),
            np.array([t[1] for t in tree], np.int32),
            np.array([t[2] for t in tree], np.float32),
            np.array([t[4] for t in tree], np.int32))


def device_route(points, parent, axis, boundary, right):
    """Replay the split tree on ``points``' device: the ``(N,)`` int32
    partition label of each point.  One masked column compare per split
    record, in float32 (``>=`` goes right, a strict ``<`` stays left,
    as ``partition.route_tree``); a point within a float32 ULP of a
    plane may route otherwise than the host's float64 replay, which the
    layout absorbs (its boxes come from the routed members)."""
    n = points.shape[0]
    labels = torch.zeros(n, dtype=torch.int32, device=points.device)
    for p, a, b, r in zip(np.asarray(parent).tolist(),
                          np.asarray(axis).tolist(),
                          np.asarray(boundary, np.float32),
                          np.asarray(right).tolist()):
        col = points[:, a].to(torch.float32)
        go_right = (labels == p) & (col >= torch.tensor(
            b, dtype=torch.float32, device=points.device))
        labels = torch.where(go_right, r, labels)
    return labels


def device_partition_counts(pid, *, p_total):
    """The ``(p_total,)`` int32 point count of each partition slot."""
    return torch.zeros(p_total, dtype=torch.int32,
                       device=pid.device).index_add_(
        0, pid.long(), torch.ones_like(pid))


def device_owned_layout(points, pid, counts, *, p_total, cap):
    """The routed points as Morton-sorted owned slabs, on ``points``'
    device.  Returns ``(owned, mask, gid, lo, hi)``: ``(P, k, cap)``
    float32 rows recentred on the mean (taken in the input's dtype, an
    integer input in float64), ``(P, cap)`` masks and gids (``N`` in
    empty slots), and each slot's tight ``(P, k)`` box in that frame
    (empty slots inverted, ``(+3e38, -3e38)``).

    One stable lexsort keyed ``(pid, Morton words)`` orders the points
    by partition and then spatially (the host layout's per-partition
    ``spatial_order``); a 1-D slot -> source map places them and the
    rows are gathered through it, never scattered."""
    n, k = points.shape
    dev = points.device
    x = points if points.is_floating_point() else points.to(torch.float64)
    xc = (x - x.mean(dim=0)).to(torch.float32)
    words = _device_morton_words(xc.T, torch.ones(n, dtype=torch.bool,
                                                  device=dev))
    # The primary key last: the partition, then the words from the most
    # significant.
    perm = _lexsort(list(reversed(words)) + [pid])
    pid_s = pid[perm].long()
    start = torch.cumsum(counts, 0) - counts
    within = torch.arange(n, device=dev) - start[pid_s]
    src = torch.full((p_total * cap,), n, dtype=torch.int64, device=dev)
    src[pid_s * cap + within] = torch.arange(n, device=dev)
    mask = src < n
    rows = perm[src.clamp_max(n - 1)]
    owned = torch.where(mask[:, None], xc[rows], 0.0)
    gid = torch.where(mask, rows, n).to(torch.int32)
    owned = owned.reshape(p_total, cap, k)
    mask = mask.reshape(p_total, cap)
    lo = torch.where(mask[:, :, None], owned, _BIG).amin(dim=1)
    hi = torch.where(mask[:, :, None], owned, -_BIG).amax(dim=1)
    return (owned.transpose(1, 2).contiguous(), mask,
            gid.reshape(p_total, cap), lo, hi)
