"""On-device single-shard DBSCAN pipeline (counterpart of
``pypardis_tpu/ops/pipeline.py``).

Everything between the host's centred, zero-padded ``(d, cap)`` float32
staging copy and the packed result runs on the device:

* quantize + interleave Morton code words (bit-exact float32 arithmetic,
  uint32 words held in int64);
* lexsort the words: stable ``torch.sort`` passes, least-significant
  word first;
* gather the points into sorted order in the ``(d, cap)`` layout;
* segment-break padding, so spatially distant runs never share a tile
  (the layout is kept across fits through the staging cache's
  ``pipeline_layout`` route, :func:`cached_layout`);
* :func:`~pypardis_tpu_torch.ops.labels.dbscan_fixed_size` (the fused
  route), or past :data:`STEP_THRESHOLD` kernel slots the host-stepped
  route (:func:`_cluster_stepped`: the prepare stage, the rounds in
  batches, the border);
* map kernel-slot root indices back to input order and pack ``(root,
  core)`` into one int32 row, fetched once beside the five int64 pair
  stats (``band_pairs`` passes 2^31 on a 1M x 512 fit, so the stats do
  not ride in the int32 row as they do in the JAX package).

The layout fixes the cluster numbering (ids follow the minimum core
index in kernel-slot order), so it is ported operation for operation.
Both routes run their dispatches under the transient ladder
(:func:`_transient_retry`), with the ``pipeline.cluster`` and
``stepped.batch`` fault sites inside it.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .cuda_kernels import _pallas_block
from .distances import PAIR_GROUP, eps2_f32
from .labels import (
    dbscan_border,
    dbscan_fixed_size,
    dbscan_prepare,
    dbscan_rounds,
    finish_labels,
    truncated_result,
)
from .precision import PAIR_STATS_WIDTH, norm_precision_mode
from ..obs import current as obs_current
from ..obs import event as obs_event
from ..obs import heartbeat as obs_heartbeat
from ..obs import span as obs_span
from ..partition import interleave_bit_words, morton_plan
from ..utils import faults
from ..utils.log import log_phase
from ..utils.retry import DEFAULT_WAITS, Retrier

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


LAYOUT_ROUTE = "pipeline_layout"


def cached_layout(points_t, eps, n, *, block: int, sort: bool,
                  precision: str = "high", layout_key=None):
    """:func:`_pipeline_layout` through the staging cache's
    ``pipeline_layout`` route (the JAX package's): with a ``layout_key``
    a hit returns the cached ``(xs, mask, owner)`` and builds nothing,
    else the layout is built from ``points_t`` (a tensor, or a
    zero-argument callable making it, called only on a miss) and cached
    with ``aux={"cap": cap}``.  Nothing downstream writes into these
    tensors, so later fits share them.  Returns ``(xs, mask, owner, cap,
    hit)``, ``owner`` int32 either way."""
    from ..parallel import staging

    if layout_key is not None:
        cached = staging.device_get(LAYOUT_ROUTE, layout_key)
        if cached is not None:
            (xs, mask, owner), aux = cached
            return xs, mask, owner, int(aux["cap"]), True
    if callable(points_t):
        points_t = points_t()
    cap = points_t.shape[1]
    xs, mask, owner = _pipeline_layout(points_t, eps, n, block=block,
                                       sort=sort, precision=precision)
    # int32 as in the JAX layout (cap < 2^30, see _pipeline_pack): the
    # cached bytes are the JAX route's.
    owner = owner.to(torch.int32)
    if layout_key is not None:
        staging.device_put_cached(LAYOUT_ROUTE, layout_key,
                                  (xs, mask, owner), aux={"cap": cap})
    return xs, mask, owner, cap, False


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


# Kernel capacities from here on run the host-stepped route: the rounds
# in batches of ROUND_BATCH, each batch one call with its own retry
# scope and snapshot, instead of one fused loop.  The JAX package's
# threshold (2^25 kernel slots) and batch (8), read per fit from
# PPTORCH_STEP_THRESHOLD and PPTORCH_ROUND_BATCH.
STEP_THRESHOLD = 1 << 25
MAX_ROUNDS = 64
ROUND_BATCH = 8


def _env_int(name: str, default: int) -> int:
    env = os.environ.get(name)
    return int(env) if env else int(default)


def _transient_retry(stage, fn):
    """Run a device stage under the transient ladder
    (:class:`~pypardis_tpu_torch.utils.retry.Retrier` at
    :data:`~pypardis_tpu_torch.utils.retry.DEFAULT_WAITS`, counters
    ``retry.<stage>.*``).  Only the injected ``UNAVAILABLE`` signature is
    transient on the card: a CUDA error raises at once."""
    return Retrier(stage, waits=DEFAULT_WAITS).run(fn)


def _cluster_stepped(xs, mask, owner, eps, *, cap, min_samples, block,
                     precision, backend, pair_budget, sketch, metric,
                     jobstate=None):
    """The host-stepped route (the JAX package's ``_cluster_stepped``):
    :func:`~.labels.dbscan_prepare` once (B1, or B3 with the sketch),
    then :func:`~.labels.dbscan_rounds` in batches of ``batch_k`` rounds
    (B2 or B4), each batch under the transient ladder with the
    ``stepped.batch`` fault site, then :func:`~.labels.dbscan_border`
    after a non-converged exit, and the pack.

    A batch runs all its ``batch_k`` rounds, past the fixpoint too, so
    the min-label launches are ``batches * batch_k`` (+1 for the border)
    and the fit's passes the JAX count, ``1 + batches * batch_k + (0 if
    converged else 1)``.  The loop is serial: the JAX package's
    speculative dispatch of batch ``b + 1`` before ``b``'s flag is read
    is not ported, because the port's rounds wait for the card inside
    their pointer jumps, so it could overlap only the flag's read and
    would cost the batch after the fixpoint.  ``stepped.speculate`` is
    always False.

    ``jobstate``: after each consumed batch, at the cadence, the state
    ``f`` (one (capk,) copy to the host) is snapshotted under the
    budget tag ``pair_budget or 0``.  A resume recomputes the prepare
    stage (B1 once again), restores ``f`` and runs the remaining batches
    from the full validity mask; it records the ``jobstate_restore``
    event (``route="stepped"``; the JAX stepped route records none).

    Gauges (``report()["stepped"]``): ``stepped.prepare_s``,
    ``rounds_s``, ``border_s``, ``pack_s``, ``batches`` (consumed),
    ``batch_size``, ``dispatched_batches``, ``speculate``,
    ``converged``; the heartbeat ``stepped.rounds`` per batch.
    """
    t0 = time.perf_counter()
    st = _transient_retry("prepare", lambda: dbscan_prepare(
        xs, eps, min_samples, mask, block=block, precision=precision,
        backend=backend, pair_budget=pair_budget, sketch=sketch,
        metric=metric,
    ))
    if st["core"] is None:
        return _pipeline_pack(*truncated_result(st), owner, cap=cap)
    capk = xs.shape[1]
    f, live = st["f0"], mask
    budget_tag = int(pair_budget or 0)
    resumed = 0
    if jobstate is not None:
        saved = jobstate.stepped_restore(budget_tag, capk)
        if saved is not None:
            f = torch.from_numpy(
                np.asarray(saved[0], np.int32)).to(xs.device)
            resumed = int(saved[1])
            obs_event("jobstate_restore", route="stepped", batches=resumed)
    prepare_s = time.perf_counter() - t0
    batch_k = max(1, min(_env_int("PPTORCH_ROUND_BATCH", ROUND_BATCH),
                         (1 << 27) // max(capk, 1)))
    max_batches = max(-(-MAX_ROUNDS // batch_k) - resumed, 1)
    batches = 0
    converged = False
    g = f
    t_rounds = time.perf_counter()
    for _ in range(max_batches):
        def some_rounds(f=f, live=live):
            faults.maybe_fail("stepped.batch")
            return dbscan_rounds(st, f, live, batch_k, until_fixpoint=False)

        f, g, live, changed, _r = _transient_retry("round", some_rounds)
        batches += 1
        obs_heartbeat("stepped.rounds", batches, max_batches, t_rounds)
        if jobstate is not None and jobstate.due():
            # The (capk,) copy is the snapshot's cost, paid only at the
            # cadence.
            jobstate.stepped_note(f.cpu().numpy(), resumed + batches,
                                  budget_tag)
        if not changed:  # the last round was a fixpoint
            converged = True
            break
    rounds_s = time.perf_counter() - t_rounds
    log_phase(
        "stepped_rounds", batches=batches, batch_size=batch_k,
        converged=converged, speculate=False, dispatched=batches,
        seconds=round(rounds_s, 2),
    )
    border_s = 0.0
    if not converged:
        t_b = time.perf_counter()
        g = _transient_retry("border", lambda: dbscan_border(st, f, live))
        border_s = time.perf_counter() - t_b
    passes = 1 + batches * batch_k + (0 if converged else 1)
    pair_stats = torch.cat([
        torch.tensor([st["total"], st["budget"], passes],
                     dtype=torch.int64),
        st["band"],
    ])
    t_p = time.perf_counter()
    labels = finish_labels(f, g, st["core"], mask)
    out = _transient_retry("pack", lambda: _pipeline_pack(
        labels, st["core"], pair_stats, owner, cap=cap))
    m = obs_current().metrics
    m.set("stepped.prepare_s", round(prepare_s, 6))
    m.set("stepped.rounds_s", round(rounds_s, 6))
    m.set("stepped.border_s", round(border_s, 6))
    m.set("stepped.pack_s", round(time.perf_counter() - t_p, 6))
    m.set("stepped.batches", batches)
    m.set("stepped.batch_size", batch_k)
    m.set("stepped.dispatched_batches", batches)
    m.set("stepped.speculate", False)
    m.set("stepped.converged", converged)
    return out


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
    jobstate=None,
    layout_key=None,
):
    """``points_t``: (d, cap) float32, centred, zero-padded past ``n``,
    on the device that runs the fit, or a zero-argument callable making
    it, called only when the layout is built (``layout_key``: see
    :func:`cached_layout`).  ``sketch`` and ``metric``
    (Euclidean or cityblock): handed to
    :func:`~pypardis_tpu_torch.ops.labels.dbscan_fixed_size`; the
    layout is the same for both metrics, as in the JAX package (its
    segment break tests a Euclidean jump, which only affects pruning).
    Returns ``(packed, kernel_tiles)``: the host ``(row, stats)`` numpy
    pair of :func:`_pipeline_pack` (decode with
    :func:`unpack_pipeline_result`) and the kernel grid's tile count
    (the report's ``live_pair_fraction`` denominator: the segment break
    pads the kernel capacity past ``cap``).

    A Euclidean fit whose kernel capacity reaches ``PPTORCH_STEP_THRESHOLD``
    (default :data:`STEP_THRESHOLD`, read per call) takes the
    host-stepped route (:func:`_cluster_stepped`, labels byte-identical
    to the fused route's), which snapshots into ``jobstate`` and resumes
    from it.  The fused route runs under the transient ladder with the
    ``pipeline.cluster`` fault site inside it.

    Telemetry on the current recorder: the spans ``pipeline.layout``
    (waits for the layout's device work at its end) and
    ``pipeline.cluster`` (``mode="fused"``, or ``mode="stepped"`` with
    its ``capacity``; it ends with the packed result on the host), and
    the tile count as the ``pipeline.kernel_tiles`` gauge."""
    with obs_span("pipeline.layout", sort=bool(sort)) as sp:
        xs, mask, owner, cap, hit = cached_layout(
            points_t, eps, n, block=block, sort=sort, precision=precision,
            layout_key=layout_key,
        )
        sp.set(cached=hit)
        sp.sync_on(xs)
    d, capk = xs.shape
    tile = _pallas_block(block, capk, d, norm_precision_mode(precision))
    tiles = max(1, capk // tile)
    obs_current().metrics.set("pipeline.kernel_tiles", tiles)
    if (capk >= _env_int("PPTORCH_STEP_THRESHOLD", STEP_THRESHOLD)
            and metric == "euclidean"):
        with obs_span("pipeline.cluster", mode="stepped") as sp:
            row, stats = _cluster_stepped(
                xs, mask, owner, eps, cap=cap, min_samples=min_samples,
                block=block, precision=precision, backend=backend,
                pair_budget=pair_budget, sketch=sketch, metric=metric,
                jobstate=jobstate,
            )
            sp.set(capacity=int(capk))
            return (row.numpy(), stats.numpy()), tiles

    def run_cluster():
        faults.maybe_fail("pipeline.cluster")
        roots_s, core_s, pair_stats = dbscan_fixed_size(
            xs, eps, min_samples, mask, block=block, precision=precision,
            backend=backend, pair_budget=pair_budget, sketch=sketch,
            metric=metric,
        )
        return _pipeline_pack(roots_s, core_s, pair_stats, owner, cap=cap)

    with obs_span("pipeline.cluster", mode="fused"):
        row, stats = _transient_retry("cluster", run_cluster)
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
                         edge_cap: int | None = None, layout_key=None):
    """Layout at the sweep's ``eps`` (its eps_max) and the graph over it.
    Returns ``((gi, gj, dval), mask_k, owner, cap, stats)``: the graph
    in kernel-slot space on the points' device and the ``[edge_total,
    edge_budget, tile_total, tile_budget]`` of
    :func:`~.distances.neighbor_pair_graph` (an edge total past its
    budget invalidates the graph; ``edge_cap`` is its ``cap``).
    ``points_t`` and ``layout_key`` as in :func:`dbscan_device_pipeline`
    (the same ``pipeline_layout`` route: a sweep after a fit at the same
    eps ceiling lays out nothing)."""
    from .distances import neighbor_pair_graph

    with obs_span("sweep.layout", sort=bool(sort)) as sp:
        xs, mask_k, owner, cap, hit = cached_layout(
            points_t, eps, n, block=block, sort=sort, precision=precision,
            layout_key=layout_key,
        )
        sp.set(cached=hit)
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
