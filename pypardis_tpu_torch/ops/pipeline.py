"""On-device single-shard DBSCAN pipeline (counterpart of
``pypardis_tpu/ops/pipeline.py``).

Everything between the host's centred, zero-padded ``(d, cap)`` float32
staging copy and the packed result runs on the device:

* quantize + interleave Morton code words (bit-exact float32 arithmetic,
  uint32 words held in int64);
* lexsort the words: stable ``torch.sort`` passes, least-significant
  word first;
* gather the points into sorted order in the ``(d, cap)`` layout;
* segment-break padding, so spatially distant runs never share a tile;
* :func:`~pypardis_tpu_torch.ops.labels.dbscan_fixed_size`;
* map kernel-slot root indices back to input order and pack ``(root,
  core)`` into one int32 row, fetched once beside the five int64 pair
  stats (``band_pairs`` passes 2^31 on a 1M x 512 fit, so the stats do
  not ride in the int32 row as they do in the JAX package).

The layout fixes the cluster numbering (ids follow the minimum core
index in kernel-slot order), so it is ported operation for operation.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_kernels import _pallas_block
from .distances import PAIR_GROUP, eps2_f32
from .labels import dbscan_fixed_size
from .precision import PAIR_STATS_WIDTH, norm_precision_mode
from ..obs import current as obs_current
from ..obs import span as obs_span
from ..partition import interleave_bit_words, morton_plan

_U32_ALL = 0xFFFFFFFF


def _device_morton_words(x, mask):
    """Per-point Morton code as a list of int64 tensors holding uint32
    words (most significant first), masked-last.

    ``x``: (d, cap) float32, centred; ``mask``: (cap,) bool.  Invalid
    points get all-ones codes so a stable sort keeps them at the end.
    Quantization is the JAX package's float32 op sequence: ``(x - lo) /
    span * 2^bits``, truncated to int32, clipped.  For d > 32 the code
    keeps the 32 highest-variance axes (variance in float64, ties to
    the lower axis index).
    """
    d, cap = x.shape
    k, bits = morton_plan(d)
    inval = torch.tensor(_U32_ALL, dtype=torch.int64, device=x.device)
    if k == 0:
        return [torch.where(mask, 0, inval)]
    if d > k:
        xm = x.double() * mask[None, :]
        n_valid = max(int(mask.sum()), 1)
        mean = xm.sum(dim=1, keepdim=True) / n_valid
        var = (((x.double() - mean) ** 2) * mask[None, :]).sum(dim=1)
        order = torch.sort(-var, stable=True).indices[:k]
        x = x[torch.sort(order).values]
    big = torch.tensor(3.0e38, dtype=torch.float32, device=x.device)
    lo = torch.where(mask[None, :], x, big).amin(dim=1, keepdim=True)
    hi = torch.where(mask[None, :], x, -big).amax(dim=1, keepdim=True)
    span = torch.clamp_min(hi - lo, float(np.finfo(np.float32).tiny))
    scale = torch.tensor(float(1 << bits), dtype=torch.float32,
                         device=x.device)
    q = torch.clamp(
        ((x - lo) / span * scale).to(torch.int32), 0, (1 << bits) - 1
    ).to(torch.int64)
    words = interleave_bit_words(
        [q[a] for a in range(q.shape[0])],
        bits,
        32,
        lambda: torch.zeros(cap, dtype=torch.int64, device=x.device),
        lambda v: v,
    )
    return [torch.where(mask, w, inval) for w in words]


def _layout_perm(words):
    """Lexsort of the words, most significant first: stable sorts from
    the least significant word up.  Returns int64 indices."""
    perm = torch.arange(words[0].shape[0], device=words[0].device)
    for w in reversed(words):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    return perm


def _layout_gather(points_t, perm, n):
    """Points in sorted order, plus the validity mask (invalid points
    sort last, so ``arange(cap) < n`` survives the permutation)."""
    cap = points_t.shape[1]
    return (
        points_t[:, perm].contiguous(),
        torch.arange(cap, device=points_t.device) < n,
    )


def _segment_break_layout(xs, mask, perm, eps, block: int, bt: int):
    """Re-lay sorted points so spatially distant runs never share a tile.

    Where consecutive sorted points jump farther than 4*eps a fresh
    ``block``-aligned segment starts; at most the ``bt`` largest jumps
    break.  Returns ``(ys, mask2, owner)`` with capacity ``cap + (bt + 1)
    * block``: coordinates, validity and each slot's original point id
    (``cap`` for pad slots).
    """
    d, cap = xs.shape
    dev = xs.device
    cap2 = cap + (bt + 1) * block
    d2 = ((xs[:, 1:] - xs[:, :-1]) ** 2).sum(dim=0)
    pair_ok = mask[1:] & mask[:-1]
    jump = torch.cat([
        torch.zeros(1, dtype=xs.dtype, device=dev),
        torch.where(pair_ok, d2, 0.0),
    ])
    base = 16.0 * eps2_f32(eps)
    n_big = int((jump > base).sum())
    kth = 0.0
    if n_big > bt:
        kth = float(torch.topk(jump, bt).values[-1])
    brk = jump > max(base, kth)
    seg = torch.cumsum(brk.to(torch.int64), 0)
    seg_len = torch.zeros(bt + 1, dtype=torch.int64, device=dev)
    seg_len.index_add_(0, seg, torch.ones_like(seg))
    padded = -(-seg_len // block) * block
    seg_tgt0 = torch.cumsum(padded, 0) - padded
    seg_src0 = torch.cumsum(seg_len, 0) - seg_len
    target = seg_tgt0[seg] + torch.arange(cap, device=dev) - seg_src0[seg]
    ys = torch.zeros((d, cap2), dtype=xs.dtype, device=dev)
    ys[:, target] = xs
    mask2 = torch.zeros(cap2, dtype=torch.bool, device=dev)
    mask2[target] = mask
    owner = torch.full((cap2,), cap, dtype=torch.int64, device=dev)
    owner[target] = perm
    return ys, mask2, owner


def _pipeline_layout(points_t, eps, n, block: int, sort: bool,
                     precision: str = "high"):
    """Morton sort + segment-break padding.  Returns ``(xs, mask,
    owner)``; without sorting, the identity layout."""
    d, cap = points_t.shape
    dev = points_t.device
    if not sort:
        return (
            points_t, torch.arange(cap, device=dev) < n,
            torch.arange(cap, device=dev),
        )
    mask = torch.arange(cap, device=dev) < n
    perm = _layout_perm(_device_morton_words(points_t, mask))
    xs, mask = _layout_gather(points_t, perm, n)
    # Segments align to whole PAIR_GROUPs of kernel tiles, so the
    # extraction's group boxes never union across segments; one break
    # per alignment unit, and only where tile pruning pays (low d, many
    # tiles).
    align = PAIR_GROUP * _pallas_block(
        block, cap, d, norm_precision_mode(precision)
    )
    bt = max(64, cap // align)
    if cap >= 16 * block and d <= 64:
        return _segment_break_layout(xs, mask, perm, eps, block=align, bt=bt)
    return xs, mask, perm


def _pipeline_pack(roots_s, core_s, pair_stats, owner, *, cap):
    """Kernel-slot results -> ``(row, stats)`` on the host: ``row`` the
    (cap,) int32 ``(root + 1) | core << 30`` per point in input order
    (the JAX package's row without its stats tail), ``stats`` the (5,)
    int64 pair stats."""
    if cap >= 1 << 30:
        raise ValueError(f"cap {cap} overflows the packed-label encoding")
    capk = roots_s.shape[0]
    valid = roots_s >= 0
    tgt = torch.clamp(roots_s, 0, capk - 1).long()
    roots_g = torch.where(valid, owner[tgt], -1)
    packed = ((roots_g + 1) | (core_s.to(torch.int64) << 30)).to(torch.int32)
    out = torch.zeros(cap + 1, dtype=torch.int32, device=roots_s.device)
    out[torch.clamp(owner, 0, cap)] = packed
    return out[:cap].cpu(), pair_stats.to(torch.int64).cpu()


def unpack_pipeline_result(packed):
    """Host-side decode of :func:`_pipeline_pack`'s ``(row, stats)``:
    ``(roots, core, total, budget, passes, band_pairs,
    rescored_tiles)``, the stats as Python ints."""
    row, stats = packed
    body = np.asarray(row)
    roots = (body & 0x3FFFFFFF) - 1
    core = (body >> 30) > 0
    stats = np.asarray(stats, dtype=np.int64)
    if stats.shape != (PAIR_STATS_WIDTH,):
        raise ValueError(f"pair stats of shape {stats.shape}")
    return (roots, core) + tuple(int(v) for v in stats)


def dbscan_device_pipeline(
    points_t,
    eps,
    n,
    min_samples: int,
    block: int = 1024,
    precision: str = "high",
    backend: str = "auto",
    sort: bool = True,
    pair_budget: int | None = None,
    sketch=None,
    metric: str = "euclidean",
):
    """``points_t``: (d, cap) float32, centred, zero-padded past ``n``,
    on the device that runs the fit.  ``sketch`` and ``metric``
    (Euclidean or cityblock): handed to
    :func:`~pypardis_tpu_torch.ops.labels.dbscan_fixed_size`; the
    layout is the same for both metrics, as in the JAX package (its
    segment break tests a Euclidean jump, which only affects pruning).
    Returns ``(packed, kernel_tiles)``: the host ``(row, stats)`` numpy
    pair of :func:`_pipeline_pack` (decode with
    :func:`unpack_pipeline_result`) and the kernel grid's tile count
    (the report's ``live_pair_fraction`` denominator: the segment break
    pads the kernel capacity past ``cap``).

    Telemetry on the current recorder: the spans ``pipeline.layout``
    (waits for the layout's device work at its end) and
    ``pipeline.cluster`` (``mode="fused"``; it ends with the packed
    result on the host), and the tile count as the
    ``pipeline.kernel_tiles`` gauge."""
    cap = points_t.shape[1]
    with obs_span("pipeline.layout", sort=bool(sort)) as sp:
        xs, mask, owner = _pipeline_layout(
            points_t, eps, n, block=block, sort=sort, precision=precision
        )
        sp.sync_on(xs)
    d, capk = xs.shape
    tile = _pallas_block(block, capk, d, norm_precision_mode(precision))
    tiles = max(1, capk // tile)
    obs_current().metrics.set("pipeline.kernel_tiles", tiles)
    with obs_span("pipeline.cluster", mode="fused"):
        roots_s, core_s, pair_stats = dbscan_fixed_size(
            xs, eps, min_samples, mask, block=block, precision=precision,
            backend=backend, pair_budget=pair_budget, sketch=sketch,
            metric=metric,
        )
        row, stats = _pipeline_pack(roots_s, core_s, pair_stats, owner,
                                    cap=cap)
        return (row.numpy(), stats.numpy()), tiles


# ---------------------------------------------------------------------------
# The amortized sweep: ONE layout and ONE pair emission at eps_max, then
# one relabel per (eps, min_samples) config over the cached graph in
# kernel-slot space, packed through _pipeline_pack as a fit is.
#
# Why a config's labels equal a fit at that config although the layout
# was built at eps_max: eps enters the layout only through the segment
# break, which inserts pad slots between sorted runs.  Its targets
# ``seg_tgt0[seg] + i - seg_src0[seg]`` strictly increase with the
# sorted position i (each segment's padded length is at least its
# length), and the Morton words and the sort do not read eps.  So the
# real points keep one relative slot order at every eps; the min core
# slot of a cluster, mapped back through ``owner``, is the same input
# row, and densify_labels numbers by that row.  Each point's
# coordinates are the same float32 values in every layout, so its d^2
# to any other point is the same bits too.
# ---------------------------------------------------------------------------


def sweep_graph_pipeline(points_t, eps, n, metric: str = "euclidean",
                         block: int = 1024, precision: str = "high",
                         sort: bool = True, edge_budget: int | None = None,
                         edge_cap: int | None = None):
    """Layout at the sweep's ``eps`` (its eps_max) and the graph over it.
    Returns ``((gi, gj, dval), mask_k, owner, cap, stats)``: the graph
    in kernel-slot space on the points' device and the ``[edge_total,
    edge_budget, tile_total, tile_budget]`` of
    :func:`~.distances.neighbor_pair_graph` (an edge total past its
    budget invalidates the graph; ``edge_cap`` is its ``cap``)."""
    from .distances import neighbor_pair_graph

    cap = points_t.shape[1]
    with obs_span("sweep.layout", sort=bool(sort)) as sp:
        xs, mask_k, owner = _pipeline_layout(
            points_t, eps, n, block=block, sort=sort, precision=precision
        )
        sp.sync_on(xs)
    d, capk = xs.shape
    tile = _pallas_block(block, capk, d, norm_precision_mode(precision))
    with obs_span("sweep.extract") as sp:
        gi, gj, dval, stats = neighbor_pair_graph(
            xs, mask_k, eps, metric=metric, tile=tile, budget=edge_budget,
            cap=edge_cap,
        )
        sp.sync_on((gi, gj, dval))
    return (gi, gj, dval), mask_k, owner, cap, stats


def sweep_config_pack(gi, gj, dval, mask_k, owner, eps, min_samples,
                      edge_stats, *, cap, metric: str = "euclidean",
                      max_rounds: int = 64):
    """One config's relabel over the cached graph, in the fit's wire
    format (decode with :func:`unpack_pipeline_result`; the pair stats
    carry ``[edge_total, edge_budget, passes, 0, 0]``)."""
    from .labels import graph_dbscan

    labels, core, passes = graph_dbscan(
        gi.long(), gj.long(), dval, mask_k, eps, min_samples,
        metric=metric, max_rounds=max_rounds,
    )
    pair_stats = torch.tensor(
        [int(edge_stats[0]), int(edge_stats[1]), passes, 0, 0],
        dtype=torch.int64,
    )
    row, stats = _pipeline_pack(labels, core, pair_stats, owner, cap=cap)
    return row.numpy(), stats.numpy()
