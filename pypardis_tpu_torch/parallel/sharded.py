"""The KD route: per-partition fits over owned + halo slabs, then a
label merge (counterpart of ``pypardis_tpu/parallel/sharded.py``): its
chained form on one device and its fused step on a mesh.

The reference's algorithm (its ``dbscan.py:104-165``): KD partitions,
each partition's box widened by 2*eps, DBSCAN inside every widened box,
then a merge of the partitions' labels.  Here each partition's owned
points and its halo (the points inside its 2*eps-widened box that it
does not own) are laid out on the host as one ``(k, cap + hcap)``
float32 slab, recentred on the dataset's float64 mean and Morton-sorted
per part; :func:`~pypardis_tpu_torch.ops.labels.dbscan_fixed_size`
clusters each slab on the card (B1/B2, or B3/B4 with the sketch on);
local roots map to global ids; and the merge reconciles them:

* ``merge="device"``: min-label propagation over the bipartite
  point <-> cluster graph in torch on the card (:func:`_merge_from_tables`;
  on a mesh over every shard's tables, which is what the JAX package's
  ``pmin``/``pmax`` over the mesh axis compute);
* ``merge="host"``: a union-find over the compact occurrence tables
  (:func:`~pypardis_tpu_torch.parallel.merge.merge_occurrences`).

Why the 2*eps halo makes home-run results exact: every point within eps
of a partition's box has its whole eps-ball inside the box widened by
2*eps, so each owned point's core flag, cluster links and border attach
are decided in its home run; links across partitions come from halo
duplicates that are core somewhere.  Only points core in their home
partition link clusters, and merged clusters take the least root id
(the reference's ``aggregator.py:38-45``).

On one device (the chained route) every halo point is clustered again
in every foreign partition, as in the JAX package (``owner_computes``
is reported False): ``stats["duplicated_work_factor"]`` measures that
cost.  Each partition's dispatch is retried through transient faults,
and a jobstate resumes a killed fit from its finished partitions.  On a
:class:`~.mesh.Mesh` of more than one device (the fused step) the
partitions are sharded over the mesh and, with ``owner_computes``, each
partition counts its owned rows only: the owners' core verdicts are
gathered, the halo slots take them and relay labels between the owned
clusters they touch (:func:`_mesh_run`).  On both an OOM of the device
merge finishes that merge on the host (see :func:`sharded_dbscan`).

``halo="ring"`` lays out only the owned slabs and collects each
partition's halo on the mesh (:mod:`.halo`), with an ``hcap`` ladder
around the same passes and merges (:func:`_ring_ladder`); a memmap
streams into the shards one partition at a time
(:func:`build_owned_shards_streaming`); a tensor already on the device
is routed and laid out there (:func:`sharded_dbscan_device`,
:mod:`.device_input`).  ``mode="global_morton"`` hands the fit to the
global-Morton route (:mod:`.global_morton`: its mesh engine, or its
chained form on one card).

Host input goes through the staging cache (:mod:`.staging`): the slabs a
fit ships stay on the device, keyed by the content of the input and the
partition tree, the shard count, the block and the devices, owned slabs
without eps and halo slabs with it (``host_owned``/``host_halo`` on the
fused step, ``ring_owned`` on the ring, ``chained_owned``/
``chained_halo`` on the chained route).  A warm refit of the same data
builds and ships none of them; after an eps change only the halos.
Every copy runs under :func:`~.staging.transfer` (the
``staging.device_put`` fault site; an OOM there evicts the cache and
retries).  The streaming build and a tensor's route cache nothing.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import time
from typing import Optional

import numpy as np
import torch

from ..geometry import BoxStack
from ..obs import current as obs_current
from ..obs import event as obs_event
from ..obs import heartbeat as obs_heartbeat
from ..obs import span as obs_span
from ..obs import use_recorder
from ..ops.cuda_kernels import _pallas_block
from ..ops.distances import INT_INF
from ..ops.labels import (
    dbscan_fixed_size,
    oc_counts_banded,
    oc_extract,
    oc_propagate_banded,
)
from ..ops.sketch import check_sketch_spec, effective_k, sketch_dims
from ..partition import expanded_members, spatial_order
from ..utils.budget import run_ladders
from ..utils.hints import dispatch_tag
from ..utils.retry import (
    is_degradable_error,
    note_degraded,
    note_giveup,
    note_retry,
)
from ..utils.shaping import clamp_block, round_up, row_chunks
from ..utils.validate import check_precision, norm_metric
from . import staging
from .halo import ring_halo_exchange_multi
from .mesh import Mesh, as_mesh, gather, shard_max

# Above this point count merge="auto" reconciles labels on the host: the
# device merge holds several (N+1,) int32 arrays beside the slabs, the
# host merge only the compact per-slot tables.  The JAX package's value,
# kept as it is: the crossover has not been measured on the card (PERF.md
# gives one 1M reading of each merge).
MERGE_HOST_AUTO = 32_000_000


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def _expanded_frame_meta(points, partitioner, eps):
    """The frame every slab shares: ``(center, exp_lo, exp_hi,
    labels)``, the float64 dataset mean, each sorted partition's
    2*eps-widened box recentred on it as float32 ``(P, k)`` bounds, and
    the sorted partition labels.  The ring filter decides halo
    membership in these numbers; the bounds are widened by 4 ULPs of
    their own magnitude, so a point the float64 box keeps cannot fall
    one float32 ULP outside after recentring (the JAX package's
    arithmetic, bit for bit)."""
    points = np.asarray(points)
    center = points.mean(axis=0, dtype=np.float64)
    labels = sorted(partitioner.partitions)
    exp = BoxStack.from_boxes(
        partitioner.bounding_boxes[l] for l in labels).expand(2 * eps)
    exp_lo = (exp.lower - center).astype(np.float32)
    exp_hi = (exp.upper - center).astype(np.float32)
    exp_lo = exp_lo - 4 * np.spacing(np.abs(exp_lo), dtype=np.float32)
    exp_hi = exp_hi + 4 * np.spacing(np.abs(exp_hi), dtype=np.float32)
    return center, exp_lo, exp_hi, labels


def _recentre_rows(points, idx, center, chunk: int = 1 << 20):
    """``(points[idx] - center)`` as float32, gathered in chunks so the
    float64 temporary stays at ``chunk`` rows."""
    sub = np.empty((len(idx), points.shape[1]), np.float32)
    for s in range(0, len(idx), chunk):
        e = min(s + chunk, len(idx))
        np.subtract(points[idx[s:e]], center, out=sub[s:e], casting="unsafe")
    return sub


def _sorted_members(points, idx, center):
    """``(idx, rows)``: partition ``idx`` Morton-sorted in the recentred
    float32 frame, and its recentred rows in that order.  The one
    definition of a slab's order, which a restored partition's gids
    (:func:`_replay_gids`) must reproduce."""
    sub = _recentre_rows(points, idx, center)
    order = spatial_order(sub)
    return idx[order], sub[order]


def _fill_slab(slab, mask, gid, j, points, idx, center):
    """Write partition ``idx`` (:func:`_sorted_members`'s order) into
    slot ``j`` of the ``(P, k, cap)`` slab (the port's ``(d, N)``
    layout: the JAX package's ``(P, cap, k)`` rows transposed, the same
    float32 bits) and its ``(P, cap)`` mask and gid rows.  Returns the
    sorted index array."""
    if len(idx):
        idx, rows = _sorted_members(points, idx, center)
        for s, e in row_chunks(len(idx), rows.shape[1]):
            slab[j, :, s:e] = rows[s:e].T
    mask[j, : len(idx)] = True
    gid[j, : len(idx)] = idx
    return idx


# Host threads that fill a stacked layout's partition slabs at once:
# numpy's gathers, Morton keys and sorts release the interpreter lock,
# so four partitions fill in about a third of the serial time (1M x
# 16-D over 4 partitions).  Each thread holds one partition's recentred
# rows and keys at a time.
_LAYOUT_THREADS = 4


def _fill_slabs(slab, mask, gid, points, idx_list, center):
    """:func:`_fill_slab` for each index array of ``idx_list`` into slots
    ``0..``, on up to :data:`_LAYOUT_THREADS` host threads (each slot is
    written by one thread, so the bits are the serial fill's).  Returns
    the sorted index arrays in slot order."""
    def fill(j):
        return _fill_slab(slab, mask, gid, j, points, idx_list[j], center)

    workers = min(_LAYOUT_THREADS, len(idx_list))
    if workers <= 1:
        return [fill(j) for j in range(len(idx_list))]
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix="pptorch-layout") as pool:
        return list(pool.map(fill, range(len(idx_list))))


def _layout_geometry(partitioner, labels, n_shards, block):
    """``(p_real, p_total, part_idx, cap)``: the partition count rounded
    up to the shard count, each partition's owned indices and the owned
    capacity (the largest partition, rounded up to ``block``)."""
    p_real = len(labels)
    p_total = round_up(max(p_real, n_shards), n_shards)
    part_idx = [partitioner.partitions[l] for l in labels]
    cap = round_up(max(len(i) for i in part_idx), block)
    return p_real, p_total, part_idx, cap


def _partition_sizes(part_idx, p_total):
    """Per-slot point counts, padding slots as zeros."""
    sizes = [int(len(i)) for i in part_idx]
    return sizes + [0] * (p_total - len(sizes))


def _owned_stats(owned_idx, cap, p_total, n):
    return {
        "owned_cap": cap,
        "n_shard_partitions": p_total,
        "pad_waste": float(p_total * cap) / max(n, 1) - 1.0,
        "partition_sizes": _partition_sizes(owned_idx, p_total),
    }


def _alloc_filled(shape, dtype, fill):
    return np.full(shape, fill, dtype)


def _staged_alloc(bufs: list):
    """An allocator drawing from the staging pool; every buffer it hands
    out lands in ``bufs``, for :func:`~.staging.give_back_after_put`."""

    def alloc(shape, dtype, fill):
        a = staging.borrow(shape, dtype)
        a.fill(fill)
        bufs.append(a)
        return a

    return alloc


def _owned_layout(points, center, partitioner, labels, n_shards, block,
                  alloc=_alloc_filled):
    """``(P, k, cap)`` owned slabs, Morton-sorted per partition, with
    their ``(P, cap)`` masks and gids (``n`` in padding slots), in
    buffers from ``alloc(shape, dtype, fill)``."""
    n, k = points.shape
    _p_real, p_total, part_idx, cap = _layout_geometry(
        partitioner, labels, n_shards, block
    )
    owned = alloc((p_total, k, cap), np.float32, 0.0)
    owned_mask = alloc((p_total, cap), bool, False)
    owned_gid = alloc((p_total, cap), np.int32, n)
    owned_idx = _fill_slabs(owned, owned_mask, owned_gid, points, part_idx,
                            center)
    return owned_idx, (owned, owned_mask, owned_gid), cap, p_total


def _pad_inverted_boxes(exp_lo, exp_hi, p_total):
    """The widened boxes padded to ``p_total`` with inverted ``(+3e38,
    -3e38)`` boxes: a padding slot's ring filter matches nothing."""
    pad = p_total - exp_lo.shape[0]
    if pad > 0:
        k = exp_lo.shape[1]
        exp_lo = np.concatenate([exp_lo, np.full((pad, k), np.float32(3e38))])
        exp_hi = np.concatenate([exp_hi,
                                 np.full((pad, k), np.float32(-3e38))])
    return exp_lo, exp_hi


def build_owned_shards(points, partitioner, eps, n_shards, block):
    """The ring route's layout: the ``(P, k, cap)`` owned slabs, masks
    and gids of :func:`build_shards` (numpy, on the host) and the
    ``(P, k)`` widened boxes, padding slots inverted; no halo is built
    on the host (the ring exchange collects it).  Returns ``(arrays,
    exp_lo, exp_hi, labels, stats)``."""
    points = np.asarray(points)
    center, exp_lo, exp_hi, labels = _expanded_frame_meta(
        points, partitioner, eps)
    owned_idx, arrays, cap, p_total = _owned_layout(
        points, center, partitioner, labels, n_shards, block)
    exp_lo, exp_hi = _pad_inverted_boxes(exp_lo, exp_hi, p_total)
    return (arrays, exp_lo, exp_hi, labels,
            _owned_stats(owned_idx, cap, p_total, len(points)))


def build_owned_shards_streaming(points, partitioner, eps, block, mesh):
    """:func:`build_owned_shards` for data that host RAM must not hold
    (an ``np.memmap`` over a file, or any row-indexable ``(N, k)``
    array): each partition's slab is gathered from ``points`` in chunks
    (:func:`_fill_slab`), copied to its shard's device and dropped
    before the next, and each shard's ``(L, k, cap)`` slab is
    concatenated on its device.  Peak anonymous host memory is one
    partition's slab and its sort, plus the partition index lists.

    Returns ``(shards, exp_lo, exp_hi, labels, stats)``: ``shards`` one
    ``(owned, mask, gid)`` per shard on its device, the rest as
    :func:`build_owned_shards` returns them, with ``stats["input"] ==
    "stream"``."""
    n, k = points.shape
    center, exp_lo, exp_hi, labels = _expanded_frame_meta(
        points, partitioner, eps)
    p_real, p_total, part_idx, cap = _layout_geometry(
        partitioner, labels, mesh.size, block)
    per = p_total // mesh.size
    exp_lo, exp_hi = _pad_inverted_boxes(exp_lo, exp_hi, p_total)
    shards = []
    for s in range(mesh.size):
        dev = mesh.device(s)
        pieces = ([], [], [])
        for p in range(s * per, (s + 1) * per):
            ow = np.zeros((1, k, cap), np.float32)
            ms = np.zeros((1, cap), bool)
            gd = np.full((1, cap), n, np.int32)
            if p < p_real:
                _fill_slab(ow, ms, gd, 0, points, part_idx[p], center)
            for piece, host in zip(pieces, (ow, ms, gd)):
                piece.append(torch.from_numpy(host).to(dev))
            del ow, ms, gd
        shards.append(tuple(torch.cat(piece) for piece in pieces))
        del pieces
    stats = dict(_owned_stats(part_idx, cap, p_total, n), input="stream")
    return shards, exp_lo, exp_hi, labels, stats


def _halo_sets(points, partitioner, eps, labels):
    """Each partition's halo: the points inside its 2*eps-widened box
    that it does not own (a replay of the split tree with widened
    comparisons in float64, never an (N, P, k) membership temp)."""
    members = expanded_members(partitioner.tree, points, 2 * eps)
    return [arr[~own] for arr, own in (members[l] for l in labels)]


def _halo_cap(halo_idx, block):
    return round_up(max(max((len(h) for h in halo_idx), default=1), 1),
                    block)


def _halo_stats(halo_idx, hcap, n, k):
    n_halo = sum(len(h) for h in halo_idx)
    return {
        "halo_factor": float(n_halo) / max(n, 1),
        "halo_cap": hcap,
        # The duplicated float32 coordinate bytes the halo build ships.
        "halo_bytes": int(n_halo) * k * 4,
    }


def _halo_slabs(points, halo_idx, center, p_total, block,
                alloc=_alloc_filled):
    """``(P, k, hcap)`` halo slabs of the halo sets ``halo_idx``
    (:func:`_halo_sets`) with masks and gids, and their stats."""
    n, k = points.shape
    hcap = _halo_cap(halo_idx, block)
    halo = alloc((p_total, k, hcap), np.float32, 0.0)
    halo_mask = alloc((p_total, hcap), bool, False)
    halo_gid = alloc((p_total, hcap), np.int32, n)
    _fill_slabs(halo, halo_mask, halo_gid, points, halo_idx, center)
    return (halo, halo_mask, halo_gid), _halo_stats(halo_idx, hcap, n, k)


def build_shards(points, partitioner, eps, n_shards, block, stage=None):
    """Lay out the points as ``(P, k, cap)`` owned and ``(P, k, hcap)``
    halo slabs (numpy, on the host), with masks and global ids; ``P`` is
    the partition count rounded up to a multiple of ``n_shards`` (the
    mesh size), the padding slots fully masked; padding rows and slots
    carry gid ``n``, the dump row of the merge's scatters.  Returns
    ``((owned, owned_mask, owned_gid, halo, halo_mask, halo_gid),
    stats)``.  The chained route builds one partition's slab at a time
    (:func:`_partition_slab`); this whole layout is the fused
    multi-device step's (:func:`_mesh_run`).  ``stage`` (a dict) gains
    the seconds of the halo sets (``halo_sets``) and of the rest
    (``slab_build``)."""
    points = np.asarray(points)
    t0 = time.perf_counter()
    center, _lo, _hi, labels = _expanded_frame_meta(points, partitioner,
                                                    eps)
    owned_idx, arrays_o, cap, p_total = _owned_layout(
        points, center, partitioner, labels, n_shards, block
    )
    t1 = time.perf_counter()
    halo_idx = _halo_sets(points, partitioner, eps, labels)
    t2 = time.perf_counter()
    arrays_h, h_stats = _halo_slabs(points, halo_idx, center, p_total,
                                    block)
    if stage is not None:
        stage["halo_sets"] = t2 - t1
        stage["slab_build"] = (t1 - t0) + (time.perf_counter() - t2)
    stats = {**_owned_stats(owned_idx, cap, p_total, len(points)),
             **h_stats}
    return (*arrays_o, *arrays_h), stats


def _slab_hcap(cap, hcap, block, k, mode):
    """The halo capacity a partition's ``cap + hcap`` slab runs at: its
    rows must be a multiple of the fit's tile (``_pallas_block``), or
    ``dbscan_fixed_size`` refuses the slab.  With ``cap`` and ``hcap``
    multiples of ``block`` the tile divides them already; for a block
    whose halving stops short of a divisor the halo slab is padded with
    empty rows (never other points) until it does."""
    while (cap + hcap) % _pallas_block(block, cap + hcap, k, mode):
        hcap = round_up(cap + hcap,
                        _pallas_block(block, cap + hcap, k, mode)) - cap
    return hcap


def _chained_layout(points, partitioner, eps, block, precision):
    """The chained route's geometry, no slab built: ``(layout, stats)``.
    ``layout`` holds the float64 ``center``, each partition's owned
    (``part_idx``) and halo (``halo_idx``) indices, ``cap``, ``hcap``
    (the halo slab's rows, :func:`_slab_hcap`), ``block`` (clamped to
    the largest partition, as the JAX driver clamps it) and
    ``halo_sets_s``, the halo sets' seconds; ``stats`` the owned and
    halo stats of :func:`build_shards`."""
    n, k = points.shape
    block = clamp_block(block, max(len(p) for p in
                                   partitioner.partitions.values()))
    center, _lo, _hi, labels = _expanded_frame_meta(points, partitioner,
                                                    eps)
    _p_real, p_total, part_idx, cap = _layout_geometry(
        partitioner, labels, 1, block)
    t = time.perf_counter()
    halo_idx = _halo_sets(points, partitioner, eps, labels)
    halo_s = time.perf_counter() - t
    hcap = _halo_cap(halo_idx, block)
    stats = {**_owned_stats(part_idx, cap, p_total, n),
             **_halo_stats(halo_idx, hcap, n, k)}
    hcap = _slab_hcap(cap, hcap, block, k, check_precision(precision))
    stats["halo_cap"] = hcap
    layout = dict(center=center, part_idx=part_idx, halo_idx=halo_idx,
                  cap=cap, hcap=hcap, block=block, halo_sets_s=halo_s)
    return layout, stats


def _fill_rows(pts, msk, gid, points, idx, center):
    """Fill one partition's owned or halo rows: ``pts`` ``(k, rows)``,
    ``msk`` and ``gid`` overwritten whole, partition ``idx`` Morton-
    sorted from row 0, empty rows past it carrying gid ``n``."""
    pts.fill(0.0)
    msk.fill(False)
    gid.fill(len(points))
    _fill_slab(pts[None], msk[None], gid[None], 0, points, idx, center)


def _partition_slab(pts, msk, gid, points, layout, p):
    """Fill partition ``p``'s ``(k, cap + hcap)`` slab ``pts``, its mask
    ``msk`` and gids ``gid`` (numpy, overwritten whole): the owned points
    Morton-sorted from row 0, empty rows up to ``cap``, then the halo
    points Morton-sorted from row ``cap``; empty rows carry gid ``n``."""
    cap = layout["cap"]
    for idx, rows in ((layout["part_idx"][p], slice(None, cap)),
                      (layout["halo_idx"][p], slice(cap, None))):
        _fill_rows(pts[:, rows], msk[rows], gid[rows], points, idx,
                   layout["center"])


# ---------------------------------------------------------------------------
# per-partition clustering
# ---------------------------------------------------------------------------


class _Spans:
    """Busy time of the per-partition clustering: CUDA events recorded
    on the current stream around each partition on the card (the span
    from its first operation to its last, read after the loop), the
    host clock around each (synchronous) partition on the CPU.  Not
    recorder spans: those read the host clock and would need a sync per
    partition to cover the card's work, which these events avoid."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events, self.host_s = [], 0.0

    def run(self, fn):
        if self.cuda:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn()
            e.record()
            self.events.append((s, e))
            return out
        t = time.perf_counter()
        out = fn()
        self.host_s += time.perf_counter() - t
        return out

    def seconds(self) -> float:
        """The busy seconds so far (waits for the last span to end)."""
        if self.events:
            self.events[-1][1].synchronize()
        return self.host_s + sum(
            s.elapsed_time(e) for s, e in self.events) / 1e3


def _global_labels(lab, gid):
    """Local root slots -> global root ids through the slab's gids."""
    return torch.where(lab >= 0, gid[lab.clamp_min(0).long()],
                       -1).to(torch.int32)


def _cluster_partition(pts, msk, gid, *, eps, min_samples, metric, block,
                       precision, backend, pair_budget, sketch=None):
    """One partition's ``(k, cap + hcap)`` slab through
    ``dbscan_fixed_size``; local roots map to global ids.  Returns
    ``(glab, core, pair_stats)``."""
    lab, cor, ps = dbscan_fixed_size(
        pts, eps, min_samples, msk, block=block, precision=precision,
        backend=backend, pair_budget=pair_budget, metric=metric,
        sketch=sketch,
    )
    return _global_labels(lab, gid), cor, ps


def _stack_tables(glabs, cores, pstats, cap):
    """Per-partition ``(cap + hcap,)`` outputs -> ``(own_glab, own_core,
    halo_glab)`` of shapes ``(P, cap)``, ``(P, cap)``, ``(P, hcap)`` and
    the pair stats' maximum over partitions (the JAX convention: the
    budget is shared, so the largest total binds)."""
    own_glab = torch.stack([g[:cap] for g in glabs])
    halo_glab = torch.stack([g[cap:] for g in glabs])
    own_core = torch.stack([c[:cap] for c in cores])
    pair_stats = torch.stack(pstats).max(dim=0).values
    return own_glab, own_core, halo_glab, pair_stats


# ---------------------------------------------------------------------------
# the device merge
# ---------------------------------------------------------------------------


def _replicated_core(own_core, og, n1):
    """``(N+1,)`` home-run core flags from the owned tables; padding
    slots hit the dump row ``n1 - 1``, cleared after."""
    core_g = torch.zeros(n1, dtype=torch.bool, device=og.device)
    core_g[og.reshape(-1).long()[own_core.reshape(-1)]] = True
    core_g[n1 - 1] = False
    return core_g


def _pointer_jump_map(m, syncs):
    """Chase canonical labels ``m -> m[m]`` to a fixpoint (INT32_MAX
    entries stay); one host sync per step."""
    n1 = m.shape[0]
    while True:
        nxt = torch.where(m != INT_INF, m[m.clamp(0, n1 - 1).long()], m)
        syncs[0] += 1
        if not bool((nxt != m).any()):
            return nxt
        m = nxt


def _merge_round(lab_map, home_label, core_g, h_gid, h_lab, h_core, syncs):
    """One round of the bipartite merge: points take the least canonical
    label over their core occurrences (home and halo), clusters the
    least over their member points, then pointer jumping.  Returns
    ``(new_map, changed)``; ``changed`` is read on the host."""
    n1 = lab_map.shape[0]
    dev = lab_map.device
    inf = torch.full((n1,), INT_INF, dtype=torch.int32, device=dev)

    def lookup(lab):
        return torch.where(lab >= 0, lab_map[lab.clamp(0, n1 - 1).long()],
                           INT_INF)

    # point_min[g]: the least canonical label over g's core occurrences.
    pm_home = torch.where(core_g, lookup(home_label), INT_INF)
    halo_vals = torch.where(h_core, lookup(h_lab), INT_INF)
    pm_halo = inf.clone().scatter_reduce_(0, h_gid, halo_vals, "amin")
    pm = torch.minimum(pm_home, pm_halo)

    # cluster_min[l]: the least point_min over its member occurrences.
    home_ok = core_g & (home_label >= 0)
    home_tgt = torch.where(core_g, home_label, n1 - 1).clamp(0, n1 - 1)
    new_map = lab_map.clone().scatter_reduce_(
        0, home_tgt.long(), torch.where(home_ok, pm, INT_INF), "amin")
    halo_ok = h_core & (h_lab >= 0)
    halo_tgt = torch.where(halo_ok, h_lab, n1 - 1)
    local = inf.clone().scatter_reduce_(
        0, halo_tgt.long(), torch.where(halo_ok, pm[h_gid], INT_INF),
        "amin")
    new_map = _pointer_jump_map(torch.minimum(new_map, local), syncs)
    syncs[0] += 1
    return new_map, bool((new_map != lab_map).any())


def _merge_loop(lab_map, home_label, core_g, h_gid, h_lab, h_core,
                max_rounds, syncs):
    """Rounds of :func:`_merge_round` until nothing changes or
    ``max_rounds`` ran.  Returns ``(lab_map, rounds, converged)``:
    ``converged`` is False when the last round allowed still changed
    labels, and the result may then be under-merged (the caller retries
    or raises)."""
    changed, rounds = True, 0
    while changed and rounds < max_rounds:
        lab_map, changed = _merge_round(
            lab_map, home_label, core_g, h_gid, h_lab, h_core, syncs)
        rounds += 1
    return lab_map, rounds, not changed


def _merge_from_tables(own_glab, own_core, og, hg, halo_glab, *, n_points,
                       merge_rounds, syncs=None, core_g=None):
    """The device merge: per-slot label tables -> ``(final, core,
    rounds, converged)``, ``final`` and ``core`` of shape ``(N,)`` on
    the tables' device.  Scatters run over ``(N+1,)`` int32 arrays whose
    last row is the dump row of padding slots.  ``syncs`` (a one-item
    list) counts the host syncs: one per round and one per pointer-jump
    step.  ``core_g``: the ``(N+1,)`` flags the owner-computes step
    already built (:func:`_replicated_core`) before its propagation.

    On a mesh the tables are every shard's, stacked on one device: a
    scatter-min over all shards' occurrences is the JAX step's ``pmin``
    of the per-device scatter-mins, so the rounds are its rounds.  Halo
    gids past ``n_points`` (padding, and the ring's empty slots) hit
    the dump row."""
    syncs = [0] if syncs is None else syncs
    n1 = n_points + 1
    dev = own_glab.device
    og_flat = og.reshape(-1).long()
    home_label = torch.full((n1,), -1, dtype=torch.int32, device=dev)
    home_label.scatter_reduce_(0, og_flat, own_glab.reshape(-1), "amax")
    if core_g is None:
        core_g = _replicated_core(own_core, og, n1)
    home_label[n1 - 1] = -1

    # An empty ring-halo slot's gid (INT32_MAX) reads as the dump row:
    # the JAX scatters drop it out of bounds.
    h_gid = hg.reshape(-1).long().clamp_max(n_points)
    h_lab = halo_glab.reshape(-1)
    h_core = core_g[h_gid.clamp(0, n1 - 1)] & (h_gid < n_points)
    lab_map = torch.arange(n1, dtype=torch.int32, device=dev)
    lab_map, rounds, converged = _merge_loop(
        lab_map, home_label, core_g, h_gid, h_lab, h_core, merge_rounds,
        syncs)
    final = torch.where(
        home_label >= 0, lab_map[home_label.clamp(0, n1 - 1).long()], -1)
    final = torch.where(final == INT_INF, -1, final)
    return final[:n_points], core_g[:n_points], rounds, converged


# ---------------------------------------------------------------------------
# the host merge and the finish
# ---------------------------------------------------------------------------


def _host_merge_finish(n, og, own_glab, own_core, halo_gid, halo_glab):
    """The host merge: ``(N,)`` home labels and core flags from the owned
    tables, then the union of the halo occurrence tables
    (:func:`~.merge.merge_occurrences`).  Tables may be tensors on any
    device or numpy arrays."""
    from .merge import merge_occurrences

    own_glab, own_core, og, halo_gid, halo_glab = (
        _np(a).reshape(-1)
        for a in (own_glab, own_core, og, halo_gid, halo_glab))
    sel = og < n
    home_label = np.full(n, -1, np.int32)
    home_label[og[sel]] = own_glab[sel]
    core = np.zeros(n, bool)
    core[og[sel]] = own_core[sel]
    labels, _mapping = merge_occurrences(home_label, core, halo_gid,
                                         halo_glab)
    return labels, core


def _sharding_cache_key(points, partitioner, n_shards, block, devices):
    """The content key under which a KD route's device slabs are reused
    (the JAX package's): the input's and the partition tree's
    fingerprints, the shard count, the block and the devices the slabs
    live on, as strings (``Mesh(["cuda:0"] * 4)`` is a key of its own).
    Identity is never trusted: an input mutated in place rebuilds."""
    return (
        staging.points_fingerprint(points),
        staging.partitioner_fingerprint(partitioner),
        int(n_shards),
        int(block),
        tuple(str(d) for d in devices),
    )


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _canonicalize_roots(labels, core) -> np.ndarray:
    """Relabel each cluster to its least core-member gid, so the labels
    do not depend on the slabs' order and match the single-device root
    convention."""
    n = len(labels)
    valid = (labels >= 0) & core
    mins = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(mins, labels[valid], np.arange(n)[valid])
    out = labels.copy()
    sel = labels >= 0
    out[sel] = mins[labels[sel]].astype(labels.dtype)
    return out


def _exec_stats(stats, *, pstats, block, k, precision, n,
                metric="euclidean", oc_on=False, sketch=None):
    """The execution telemetry: ``owner_computes`` (``oc_on``: each slab
    counts only its owned rows; off, as on the KD route, every halo
    duplicate is clustered again), ``duplicated_work_factor`` (slots
    whose core flag is computed, over dataset points), the staging
    cache's ``staged_bytes_reused`` and ``staged_bytes``, and from the pair
    stats (a (5,) row or rows of them; each column's maximum binds) the
    live pairs, kernel passes, band stats, the fit's tile (the port's
    ``_pallas_block``) and the slab's tiles."""
    p_total = int(stats["n_shard_partitions"])
    cap = int(stats["owned_cap"])
    hcap = int(stats.get("halo_cap", 0))
    stats["owner_computes"] = bool(oc_on)
    stats["duplicated_work_factor"] = float(
        p_total * (cap if oc_on else cap + hcap)) / max(n, 1)
    reused, shipped = staging.fit_stats()
    stats["staged_bytes_reused"] = int(reused)
    stats["staged_bytes"] = int(shipped)
    ps = [int(v) for v in _np(pstats).reshape(-1, 5).max(axis=0)]
    stats["live_pairs"] = ps[0]
    stats["kernel_passes"] = ps[2]
    stats["band_pairs"] = ps[3]
    stats["rescored_tiles"] = ps[4]
    stats["kernel_block"] = int(_pallas_block(
        block, max(cap + hcap, 1), int(k), check_precision(precision)))
    stats["kernel_tiles"] = -(-max(cap + hcap, 1) // stats["kernel_block"])
    stats["sketch_k"] = int(
        sketch_dims(int(k), metric) if sketch is None
        else effective_k(check_sketch_spec(sketch), int(k))
        if metric == "euclidean" else 0)
    return stats


# ---------------------------------------------------------------------------
# the overlapped loop
# ---------------------------------------------------------------------------


class _SlabRing:
    """Two rotating host buffers for one partition's ``(k, rows)`` slab,
    mask and gid, each shipped to ``device`` as fresh tensors.

    On the card the buffers are pinned and the copy runs
    ``non_blocking`` on a side stream; :meth:`ship` returns the copy's
    event and :meth:`wait` makes the current stream wait on it.  The
    rule that keeps an in-flight copy from reading a buffer being
    rewritten: :meth:`acquire` of slot ``p % 2`` first waits for the
    copy that last read that slot (partition ``p - 2``'s) to finish.
    On the CPU the copy is synchronous and there is no event."""

    def __init__(self, k, rows, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.host = [self._alloc(k, rows) for _ in range(2)]
        self.pending = [None, None]

    def _alloc(self, k, rows):
        pin = self.cuda
        return (torch.empty((k, rows), dtype=torch.float32, pin_memory=pin),
                torch.empty(rows, dtype=torch.bool, pin_memory=pin),
                torch.empty(rows, dtype=torch.int32, pin_memory=pin))

    def acquire(self, p):
        """The numpy views of slot ``p % 2``, once no copy reads it."""
        slot = p % 2
        if self.pending[slot] is not None:
            self.pending[slot].synchronize()
            self.pending[slot] = None
        return tuple(t.numpy() for t in self.host[slot])

    def ship(self, p):
        """Copy slot ``p % 2`` to the device: ``(tensors, event)``."""
        slot = p % 2
        if not self.cuda:
            return tuple(t.clone() for t in self.host[slot]), None
        with torch.cuda.stream(self.stream):
            out = tuple(t.to(self.device, non_blocking=True)
                        for t in self.host[slot])
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.pending[slot] = ev
        return out, ev

    def wait(self, tensors, ev):
        """Order the current stream after the copy; the tensors were
        allocated on the side stream, so mark their use here."""
        if ev is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in tensors:
            t.record_stream(cur)

    def close(self):
        """Wait for the copies still reading the buffers, then drop both
        (pinned on the card) buffers."""
        for ev in self.pending:
            if ev is not None:
                ev.synchronize()
        self.pending = [None, None]
        self.host = []


def _replay_gids(points, layout, p, device):
    """Partition ``p``'s ``(cap + hcap,)`` gid row without its slab (a
    partition restored from a snapshot): the owned and halo indices in
    the order :func:`_partition_slab` sorts them, ``n`` past them."""
    cap, n = layout["cap"], len(points)
    row = np.full(cap + layout["hcap"], n, np.int32)
    for idx, off in ((layout["part_idx"][p], 0), (layout["halo_idx"][p], cap)):
        if len(idx):
            row[off:off + len(idx)] = _sorted_members(
                points, idx, layout["center"])[0]
    return row, torch.from_numpy(row).to(device)


# The staging cache's routes of the chained route: each partition's
# owned ``(pts, mask, gid)`` keyed without eps, its halo with it.
CHAINED_OWNED, CHAINED_HALO = "chained_owned", "chained_halo"


def _chained_tables_overlap(
    points, layout, *, eps, min_samples, metric, precision, backend,
    pair_budget, device, stage, passes, jobstate=None, sketch=None,
    base_key=None,
):
    """The per-partition loop: each partition's slab built on the host
    (:func:`_partition_slab` into a :class:`_SlabRing` buffer), shipped
    and clustered on the card.

    One background host thread builds and ships the next partition's
    slab while the card clusters this one: the port's round loop syncs
    the host every round, so the build cannot ride on asynchronous
    dispatch as in the JAX package.  Each partition's slab is freed once
    its tables are out.

    With ``base_key`` (:func:`_sharding_cache_key`) the partitions'
    device slabs go through the staging cache, as in the JAX package:
    their owned rows on ``chained_owned`` (keyed without eps) and halo
    rows on ``chained_halo`` (keyed with it).  A warm refit builds and
    ships nothing and clusters each partition's cached owned and halo
    rows joined on the device; after an eps change the host builds and
    ships the halos alone.  A cold fit caches clones of its slabs'
    owned and halo rows (a partition slab outlives nothing else).  The
    host merge's gid tables of a cached part are one fetch from the
    device.

    Fault tolerance (the JAX route's): each dispatch runs under a
    :class:`~pypardis_tpu_torch.utils.retry.Retrier` with the
    ``chained.partition`` fault site inside it; a retry re-dispatches
    from the slab already on the device (the dispatch consumes nothing).
    With ``jobstate`` the partitions snapshotted under this pair budget
    (tag ``pair_budget or 0``) are restored, not built nor dispatched
    (``jobstate_restore`` event, ``route="chained"``), and each
    dispatched partition's tables are noted at the cadence; a fit that
    restored partitions caches nothing.  On an error that leaves the
    loop, the builder thread is joined and the ring's buffers dropped
    before the error propagates, so no thread of a failed attempt
    outlives it, and nothing is cached.

    Returns ``(glabs, cores, pstats, gid_o_host, gid_h_host, gid_dev,
    overlap_efficiency)``: per-partition labels, cores and pair stats,
    the host gid tables the host merge reads, the device gid rows the
    device merge reads, and the loop's device-busy seconds (the sum of
    :class:`_Spans`, CUDA-event spans on the card) over its wall
    seconds.  ``stage`` gains the build's seconds (``slab_build``), the
    busy seconds (``device``) and the loop's wall (``loop``)."""
    from ..utils import faults
    from ..utils.retry import Retrier

    n, k = points.shape
    cap, hcap = layout["cap"], layout["hcap"]
    p_total = len(layout["part_idx"])
    budget_tag = int(pair_budget or 0)
    restored = (jobstate.chained_restore(budget_tag)
                if jobstate is not None else {})
    if restored:
        obs_event("jobstate_restore", route="chained",
                  partitions=len(restored))
    live = [p for p in range(p_total) if p not in restored]
    own_c = halo_c = None
    if base_key is not None:
        hit = staging.device_get(CHAINED_OWNED, base_key)
        if hit is not None:
            own_c = [hit[0][3 * p:3 * p + 3] for p in range(p_total)]
        hit = staging.device_get(CHAINED_HALO, base_key + (float(eps),))
        if hit is not None:
            halo_c = [hit[0][3 * p:3 * p + 3] for p in range(p_total)]
    # What the host builds per partition: the whole slab (cold), its
    # owned or halo rows alone (the other part cached), or nothing.
    built = ("slab" if own_c is None and halo_c is None
             else "owned" if own_c is None
             else "halo" if halo_c is None else None)
    rows = {"slab": cap + hcap, "owned": cap, "halo": hcap}.get(built)
    ring = _SlabRing(k, rows, device) if live and built else None
    caching = base_key is not None and not restored
    gid_o_host = np.full((p_total, cap), n, np.int32)
    gid_h_host = np.full((p_total, hcap), n, np.int32)
    build_s = [0.0]
    # The builder thread's retries and faults count on the fit's recorder.
    recorder = obs_current()

    def build(p, i):
        if ring is None:
            return None
        t = time.perf_counter()
        pts, msk, gid = ring.acquire(i)
        if built == "slab":
            _partition_slab(pts, msk, gid, points, layout, p)
            gid_o_host[p] = gid[:cap]
            gid_h_host[p] = gid[cap:]
        else:
            owned = built == "owned"
            _fill_rows(pts, msk, gid, points,
                       layout["part_idx" if owned else "halo_idx"][p],
                       layout["center"])
            (gid_o_host if owned else gid_h_host)[p] = gid
        with use_recorder(recorder):
            out = staging.transfer(lambda: ring.ship(i))
        build_s[0] += time.perf_counter() - t
        return out

    spans = _Spans(device)
    glabs, cores, pstats, gid_dev = [], [], [], []
    new_own, new_halo = [], []
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="pptorch-slab-builder")
    try:
        nxt = pool.submit(build, live[0], 0) if live else None
        t_loop = time.perf_counter()
        i = 0  # the next live partition's index in ``live``
        for p in range(p_total):
            if p in restored:
                glab, cor, ps = restored[p]
                row, gid = _replay_gids(points, layout, p, device)
                gid_o_host[p], gid_h_host[p] = row[:cap], row[cap:]
                glabs.append(torch.from_numpy(
                    np.asarray(glab, np.int32)).to(device))
                cores.append(torch.from_numpy(
                    np.asarray(cor, bool)).to(device))
                pstats.append(torch.from_numpy(np.asarray(ps, np.int64)))
                gid_dev.append(gid)
                obs_heartbeat("chained.partitions", p + 1, p_total, t_loop)
                continue
            shipped = nxt.result()
            i += 1
            if i < len(live):
                # THE overlap: the next partition's build and copy run
                # while the card clusters this one.
                nxt = pool.submit(build, live[i], i)
            if shipped is not None:
                ring.wait(*shipped)
            if built == "slab":
                pts, msk, gid = shipped[0]
                if caching:
                    new_own.append(tuple(
                        t[..., :cap].clone() for t in shipped[0]))
                    new_halo.append(tuple(
                        t[..., cap:].clone() for t in shipped[0]))
            else:
                own = own_c[p] if own_c is not None else shipped[0]
                halo = halo_c[p] if halo_c is not None else shipped[0]
                if built and caching:
                    (new_own if built == "owned" else new_halo).append(
                        shipped[0])
                pts, msk, gid = (torch.cat([o, h], dim=-1)
                                 for o, h in zip(own, halo))
            del shipped

            def one_partition():
                faults.maybe_fail("chained.partition")
                return spans.run(lambda: _cluster_partition(
                    pts, msk, gid, eps=eps, min_samples=min_samples,
                    metric=metric, block=layout["block"],
                    precision=precision, backend=backend,
                    pair_budget=pair_budget, sketch=sketch,
                ))

            glab, cor, ps = Retrier("chained.partition").run(one_partition)
            glabs.append(glab)
            cores.append(cor)
            pstats.append(ps)
            passes.append(int(ps[2]))
            gid_dev.append(gid)
            del pts, msk
            # Per-partition progress with a partitions-remaining ETA
            # (the flight file always, a log line under
            # PPTORCH_HEARTBEAT).
            obs_heartbeat("chained.partitions", p + 1, p_total, t_loop)
            if jobstate is not None and jobstate.due():
                # The tables' copy to the host is the snapshot's cost,
                # paid only at the cadence.
                jobstate.chained_note(p, glab.cpu().numpy(),
                                      cor.cpu().numpy(), ps.numpy(),
                                      budget_tag)
        wall = time.perf_counter() - t_loop
    finally:
        # Join the builder (a build in flight finishes; none queued
        # starts) and drop the pinned buffers, on success and on error.
        pool.shutdown(wait=True, cancel_futures=True)
        if ring is not None:
            ring.close()
    # The host merge's gid tables of the cached parts: one fetch each.
    for cached, host in ((own_c, gid_o_host), (halo_c, gid_h_host)):
        if cached is not None and live:
            got = torch.stack([cached[p][2] for p in live]).cpu().numpy()
            host[live] = got
    if caching:
        for route, key, fresh in (
                (CHAINED_OWNED, base_key, new_own),
                (CHAINED_HALO, base_key + (float(eps),), new_halo)):
            if fresh:
                staging.device_put_cached(
                    route, key, tuple(t for tr in fresh for t in tr))
    busy = spans.seconds()
    stage["slab_build"] = stage.get("slab_build", 0.0) + build_s[0]
    stage["device"] = stage.get("device", 0.0) + busy
    stage["loop"] = stage.get("loop", 0.0) + wall
    eff = busy / wall if wall > 0 else 0.0
    return glabs, cores, pstats, gid_o_host, gid_h_host, gid_dev, eff


def _sharded_hint_key(owned_shape, halo_cap, block, precision, eps, metric):
    """Pair-budget hint key of the chained route (the JAX package's):
    both capacities, the block, precision, eps, metric, the dispatch tag
    and the resolved sketch k."""
    nt = (int(owned_shape[-2]) + int(halo_cap)) // max(int(block), 1)
    sk = sketch_dims(int(owned_shape[-1]), metric)
    return (
        "sharded", dispatch_tag(nt), tuple(owned_shape), int(halo_cap),
        block, precision, float(eps), str(metric), sk,
    )


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item}); the port runs the KD "
        f"route: chained on one device, fused on a mesh, with host or "
        f"ring halos"
    )


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    return int(np.asarray(getattr(mesh, "devices", mesh)).size)


def sharded_dbscan(
    points,
    partitioner,
    eps: float,
    min_samples: int,
    metric="euclidean",
    block: int = 1024,
    mesh=None,
    precision: str = "high",
    backend: str = "auto",
    halo: str = "host",
    hcap: Optional[int] = None,
    merge: str = "auto",
    pair_budget: Optional[int] = None,
    merge_rounds: int = 32,
    stream: Optional[bool] = None,
    owner_computes: bool = True,
    overlap: Optional[bool] = None,
    mode: str = "kd",
    jobstate=None,
    device=None,
    sketch=None,
):
    """Cluster ``points`` (N, k) over ``partitioner``'s KD partitions.
    Returns ``(labels, core, stats)``: labels are global root ids (each
    cluster's least core-point index, -1 noise) in input order.

    ``mesh``: None or a 1-device mesh runs the chained route on one card
    (the JAX package's ``mesh=default_mesh(1)``): per-partition fits
    over owned + halo slabs, partition ``p + 1``'s slab built and
    shipped on a host thread while the card clusters partition ``p``
    (``stats["overlap_efficiency"]`` with more than one partition), then
    the label merge.  A :class:`~.mesh.Mesh` of more than one device
    runs the fused multi-device step (the JAX ``_sharded_step_fused``):
    the stacked layout (:func:`build_shards`, partitions padded to a
    multiple of the mesh size with empty slots), each shard's partitions
    on its device, and with ``owner_computes`` (the default there) only
    owned rows counted, halo slots taking their owners' core verdicts
    and relaying labels.  Shards run one after another from this thread:
    the round loop reads a flag from the device every round, so on
    distinct cards they do not overlap yet (ROADMAP A10's rest); on a
    mesh that repeats one card that is what the card would do anyway.

    ``merge``: ``"device"`` (torch, the tables of every shard on the
    mesh's first device), ``"host"`` (union-find over the occurrence
    tables; under owner-computes the host also relays the owners' core
    verdicts between the two passes) or ``"auto"`` (host from
    :data:`MERGE_HOST_AUTO` points, or under host-RSS pressure,
    :func:`~pypardis_tpu_torch.obs.resources.memory_pressure`); labels
    are byte-identical under both.

    ``pair_budget`` and ``merge_rounds`` run the ladders of
    :func:`~pypardis_tpu_torch.utils.budget.run_ladders`: one rerun at
    the exact pair total (the budget is shared by every partition of
    every shard, so the largest total binds), one merge retry at 4x the
    rounds, then an error; never a truncated or under-merged result.  A
    kernel that fails raises: there is no fallback to the plain
    versions, and a layout whose tile cannot split the owned prefix
    raises ``ValueError``.

    ``mode="global_morton"`` runs :func:`~.global_morton.
    global_morton_dbscan` on ``mesh`` (the partitioner unread, ``chain``
    from ``PPTORCH_GM_CHAIN``): its mesh engine, or on one device with
    ``chain > 1`` its chained form.  ``owner_computes`` is
    reported False on the chained route, as the JAX package reports it.
    ``overlap`` is accepted for the JAX signature and changes nothing:
    the JAX switch turns off an overlap that rides on asynchronous
    dispatch, which the port's slab-building thread does not.

    ``halo``: ``"host"`` builds each partition's halo on the host (the
    routes above); ``"ring"`` lays out only the owned slabs
    (:func:`build_owned_shards`), ships each shard's to its device and
    collects the halos there by the ring exchange
    (:func:`ring_exchange_step`; a mesh of None runs it on a 1-device
    mesh of ``device``), then runs the fused step's passes and merge on
    the owned + ring-halo slabs (owner-computes off on a 1-device mesh
    of several partitions, the JAX ``_oc_applies``).  ``hcap`` caps the
    ring's halo buffer per partition (rounded up to ``block``) and an
    overflow raises; None starts at half the owned capacity and doubles
    on overflow, up to 4 attempts (:func:`_ring_ladder`).  ``hcap`` is
    unread under ``halo="host"``, as in JAX.  ``stream``: build the
    owned slabs one partition at a time from ``points``
    (:func:`build_owned_shards_streaming`), so an ``np.memmap`` larger
    than host RAM clusters from disk; it needs ``halo="ring"`` (a
    ``ValueError`` otherwise), and None turns it on for a memmap under
    the ring.

    Fault tolerance, as in the JAX package: on the chained route each
    partition's dispatch runs under a retry with the
    ``chained.partition`` fault site and ``jobstate``
    (:class:`~pypardis_tpu_torch.utils.jobstate.JobState`) restores the
    partitions a killed run snapshotted; the fused step takes
    ``jobstate`` and snapshots nothing, as in JAX.  On both, an
    OOM-class failure of the device merge itself (the
    ``sharded.execute`` fault site) finishes that merge on the host from
    the tables the run produced (``note_degraded("merge_host")``,
    ``stats["merge"] == "host"``).  No other failure degrades: an OOM in
    a partition's clustering, which the host merge would not cure, and
    a kernel error raise.  (The JAX routes rerun the whole fit under the
    host merge after an OOM anywhere in it.)  ``device``: None runs on
    the card (and raises without CUDA); ``"cpu"`` runs the kernels'
    plain versions; a mesh's devices must be of its type.  ``sketch``:
    the fits' sketch spec (None reads ``PPTORCH_SKETCH``).

    Stats beyond the JAX package's: ``stage_s`` (seconds of the halo
    sets, the host slab build, the copies to the mesh (``ship``), the
    ring exchange (``exchange``, every ``hcap`` attempt; CUDA events on
    the card), the per-partition busy time (``device``), the clustering
    loop's wall and the merge), ``partition_passes`` (each partition's kernel
    passes, every ladder attempt, 0 where its pair list overflowed) and,
    under the device merge, ``merge_host_syncs``.

    Telemetry on the current recorder, as in the JAX package: the spans
    ``sharded.build_shards`` (the geometry and halo sets),
    ``sharded.execute`` (the partitions and the device merge, through
    the ladders; on the ring also the exchange) and
    ``sharded.merge_host``, the ladders' events (the ring's
    ``halo_overflow`` and its ``ring.hcap`` retries among them) and, on
    the chained route, the heartbeat ``chained.partitions``.
    """
    from ..dbscan import resolve_device
    from ..utils import faults

    faults.from_env()
    n_mesh = _mesh_size(mesh)
    if mode == "global_morton":
        from .global_morton import global_morton_dbscan

        # The partitioner and the KD knobs go unread, as in the JAX
        # package; ``chain`` comes from PPTORCH_GM_CHAIN.
        return global_morton_dbscan(
            points, eps=eps, min_samples=min_samples, metric=metric,
            block=block, mesh=mesh, precision=precision, backend=backend,
            merge=merge, pair_budget=pair_budget, merge_rounds=merge_rounds,
            stream=stream, jobstate=jobstate, device=device)
    if mode != "kd":
        raise ValueError(f"mode must be 'kd' or 'global_morton', got {mode!r}")
    if halo not in ("host", "ring"):
        raise ValueError(f"halo must be 'host' or 'ring', got {halo!r}")
    metric = norm_metric(metric)
    if merge not in ("auto", "device", "host"):
        raise ValueError(f"merge must be auto|device|host, got {merge!r}")
    dev = resolve_device(device)
    if n_mesh > 1 or halo == "ring":
        mesh = as_mesh(mesh) if mesh is not None else Mesh([dev])
        if mesh.device_type != dev.type:
            raise ValueError(
                f"the mesh's devices are {mesh.device_type} but the fit "
                f"runs on {dev.type}"
            )
    if stream is None:
        stream = halo == "ring" and isinstance(points, np.memmap)
    if stream and halo != "ring":
        raise ValueError(
            "stream=True requires halo='ring': the streaming build never "
            "materializes host halo slabs"
        )
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    points = np.asarray(points)
    n, k = points.shape
    if merge == "auto":
        # Under host-RSS pressure (PPTORCH_RSS_SOFT_LIMIT crossed) the
        # host merge is taken at once: the device merge's (N+1,) arrays
        # come back to the host as well.
        from ..obs.resources import memory_pressure

        merge = (
            "host" if n >= MERGE_HOST_AUTO or memory_pressure()
            else "device"
        )
    kw = dict(metric=metric, block=block, mesh=mesh, precision=precision,
              backend=backend, merge=merge, pair_budget=pair_budget,
              merge_rounds=merge_rounds, owner_computes=owner_computes,
              sketch=sketch)
    staging.begin_fit()
    if halo == "ring":
        return _ring_run(points, partitioner, eps, min_samples, hcap=hcap,
                         stream=stream, **kw)
    if n_mesh > 1:
        return _mesh_run(points, partitioner, eps, min_samples, dev=dev,
                         **kw)
    return _chained_run(
        points, partitioner, eps, min_samples, metric=metric, block=block,
        precision=precision, backend=backend, merge=merge,
        pair_budget=pair_budget, merge_rounds=merge_rounds,
        jobstate=jobstate, dev=dev, sketch=sketch)


def _chained_run(points, partitioner, eps, min_samples, *, metric, block,
                 precision, backend, merge, pair_budget, merge_rounds,
                 jobstate, dev, sketch=None):
    """The chained route under a resolved ``merge``: the layout, the
    partition loop and the merge through the ladders (the body of
    :func:`sharded_dbscan`)."""
    from ..utils import faults

    n, k = points.shape
    with obs_span("sharded.build_shards", halo="host"):
        layout, stats = _chained_layout(points, partitioner, eps, block,
                                        precision)
    block = layout["block"]
    base_key = _sharding_cache_key(points, partitioner, 1, block, [dev])
    stage = {"halo_sets": layout["halo_sets_s"]}
    passes = []
    eff_cell = [0.0]

    def cluster(pb):
        glabs, cores, pstats, gid_o, gid_h, gid_dev, eff = (
            _chained_tables_overlap(
                points, layout, eps=eps, min_samples=min_samples,
                metric=metric, precision=precision, backend=backend,
                pair_budget=pb, device=dev, stage=stage, passes=passes,
                jobstate=jobstate, sketch=sketch, base_key=base_key,
            ))
        eff_cell[0] = eff
        tables = _stack_tables(glabs, cores, pstats, layout["cap"])
        og_dev = torch.stack([g[:layout["cap"]] for g in gid_dev])
        hg_dev = torch.stack([g[layout["cap"]:] for g in gid_dev])
        return tables, (og_dev, hg_dev), (gid_o, gid_h)

    # The clustering reruns only for a new pair budget; a merge-rounds
    # retry reuses its tables.
    memo = {}
    syncs = [0]
    spilled = []

    def run_step(pb, mr):
        if "out" not in memo or memo["pb"] != pb:
            memo.update(pb=pb, out=cluster(pb))
        (own_glab, own_core, halo_glab, pstats), gid_dev, gid_host = (
            memo["out"])
        total, budget = int(pstats[0]), int(pstats[1])
        if total > budget or merge == "host" or spilled:
            # The host union-find merge is exact: no rounds ladder.
            return (None, pstats), (total, budget), True
        t = time.perf_counter()
        try:
            faults.maybe_fail("sharded.execute")
            final, core, rounds, converged = _merge_from_tables(
                own_glab, own_core, gid_dev[0], gid_dev[1], halo_glab,
                n_points=n, merge_rounds=mr, syncs=syncs,
            )
        except Exception as e:  # noqa: BLE001 — re-raised unless an OOM
            if not is_degradable_error(e):
                raise
            # The degradation rung: an OOM-class failure of the device
            # merge (its (N+1,) arrays are the fit's hungriest
            # allocation) finishes on the host from the tables this run
            # produced; the labels are byte-identical.  The partitions'
            # dispatches are done and the builder thread joined.
            note_degraded("merge_host", mode="kd", error=str(e)[:160])
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            spilled.append(True)
            return (None, pstats), (total, budget), True
        stage["merge"] = stage.get("merge", 0.0) + time.perf_counter() - t
        return ((final, core, rounds), pstats), (total, budget), converged

    with obs_span("sharded.execute", halo="host", merge=merge,
                  overlap=True):
        out, pstats = run_ladders(
            run_step,
            _sharded_hint_key((len(layout["part_idx"]), layout["cap"], k),
                              layout["hcap"], block, precision, eps,
                              metric) + (False,),
            pair_budget, merge_rounds)
    t = time.perf_counter()
    if merge == "host" or spilled:
        own_glab, own_core, halo_glab, _ps = memo["out"][0]
        gid_o, gid_h = memo["out"][2]
        with obs_span("sharded.merge_host"):
            final, core = _host_merge_finish(
                n, gid_o, own_glab, own_core, gid_h, halo_glab)
        stats = dict(stats, merge="host")
    else:
        final, core, rounds = out
        final, core = _np(final), _np(core)
        stats = dict(stats, merge="device", merge_rounds=int(rounds),
                     merge_converged=True, merge_host_syncs=syncs[0])
    stage["merge"] = stage.get("merge", 0.0) + time.perf_counter() - t
    if len(layout["part_idx"]) > 1:
        stats["overlap_efficiency"] = round(float(eff_cell[0]), 4)
    _exec_stats(stats, pstats=pstats, block=block, k=k,
                precision=precision, n=n, metric=metric, sketch=sketch)
    stats["stage_s"] = stage
    stats["partition_passes"] = passes
    return _canonicalize_roots(final.astype(np.int32), core), core, stats


# ---------------------------------------------------------------------------
# the fused multi-device step (a mesh of more than one device)
# ---------------------------------------------------------------------------


def _on(device):
    """The context a shard's work runs in: its card as the current CUDA
    device (so events and streams are its own), nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _check_mesh_tile(block, cap, hcap, k, mode, oc_on):
    """The KD layout's tile (``_pallas_block`` over ``cap + hcap`` rows)
    must divide the slab, and under owner-computes the owned prefix too:
    the owner-computes filters split the tile-pair list at ``cap //
    tile``.  A misaligned layout raises; nothing runs the plain versions
    in its place."""
    n = cap + hcap
    tile = _pallas_block(block, n, k, mode)
    if n % tile or (oc_on and cap % tile):
        raise ValueError(
            f"block={block} cannot tile the KD shard layout: its tile "
            f"{tile} does not divide the owned capacity (cap={cap}) and "
            f"the slab (cap + hcap={n}); use a power-of-two block"
        )


def _joined_slabs(owned, halos):
    """Each shard's partitions as ``(k, cap + hcap)`` slabs, masks and
    gids on the shard's device, joined there from its ``(L, k, cap)``
    owned and ``(L, k, hcap)`` halo triples (:func:`_mesh_build_cached`):
    partition ``j`` lives on shard ``j // L``, as the JAX layout shards
    its leading axis.  Returns a list (one per shard) of ``(pts, msk,
    gid)`` lists."""
    return [[tuple(torch.cat([o[j], h[j]], dim=-1) for o, h in zip(ow, ha))
             for j in range(ow[0].shape[0])]
            for ow, ha in zip(owned, halos)]


HOST_OWNED, HOST_HALO, RING_OWNED = "host_owned", "host_halo", "ring_owned"


def _per_shard(flat):
    """A cached flat tuple of per-shard triples, as triples."""
    return [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]


def _ship_cached(route, key, arrays, mesh, aux):
    """Ship ``(P, ...)`` host arrays as per-shard triples
    (:func:`_ship_owned`) under the staging cache's transfer (its
    ``staging.device_put`` site and OOM rung), cached on ``route``."""
    shards = staging.transfer(lambda: _ship_owned(arrays, mesh))
    staging.device_put_cached(route, key,
                              tuple(t for tr in shards for t in tr), aux=aux)
    return shards


def _mesh_build_cached(points, partitioner, eps, mesh, block, stage):
    """The fused step's layout through the staging cache (the JAX
    ``_host_build_cached``): the owned slabs on ``host_owned`` (keyed
    without eps) and the halo slabs on ``host_halo`` (keyed with it),
    each a per-shard triple on its device.  A hit builds and ships
    nothing; after an eps change only the halo sets and slabs are built.
    Returns ``(owned, halos, stats, bufs)``: ``bufs`` the pool buffers
    the build borrowed (:func:`~.staging.give_back_after_put` them once
    the fit's results are on the host).  ``stage`` gains the seconds of
    the halo sets (``halo_sets``), the host build (``slab_build``) and
    the copies (``ship``), 0 for a part that hit."""
    devices = [mesh.device(s) for s in range(mesh.size)]
    base = _sharding_cache_key(points, partitioner, mesh.size, block,
                               devices)
    cached_o = staging.device_get(HOST_OWNED, base)
    cached_h = staging.device_get(HOST_HALO, base + (float(eps),))
    bufs = []
    for key in ("halo_sets", "slab_build", "ship"):
        stage.setdefault(key, 0.0)
    if cached_o is None or cached_h is None:
        center, _lo, _hi, labels = _expanded_frame_meta(points, partitioner,
                                                        eps)
    if cached_o is None:
        t = time.perf_counter()
        owned_idx, arrays, cap, p_total = _owned_layout(
            points, center, partitioner, labels, mesh.size, block,
            alloc=_staged_alloc(bufs))
        o_stats = _owned_stats(owned_idx, cap, p_total, len(points))
        t1 = time.perf_counter()
        owned = _ship_cached(HOST_OWNED, base, arrays, mesh, o_stats)
        stage["slab_build"] += t1 - t
        stage["ship"] += time.perf_counter() - t1
    else:
        owned, o_stats = _per_shard(cached_o[0]), cached_o[1]
    if cached_h is None:
        t = time.perf_counter()
        halo_idx = _halo_sets(points, partitioner, eps, labels)
        t1 = time.perf_counter()
        arrays, h_stats = _halo_slabs(
            points, halo_idx, center, int(o_stats["n_shard_partitions"]),
            block, alloc=_staged_alloc(bufs))
        t2 = time.perf_counter()
        halos = _ship_cached(HOST_HALO, base + (float(eps),), arrays, mesh,
                             h_stats)
        stage["halo_sets"] += t1 - t
        stage["slab_build"] += t2 - t1
        stage["ship"] += time.perf_counter() - t2
    else:
        halos, h_stats = _per_shard(cached_h[0]), cached_h[1]
    return owned, halos, {**o_stats, **h_stats}, bufs


def _legacy_shard(slabs, *, cluster_kw, spans, passes):
    """The owner-computes-off body of one shard (the JAX
    ``_device_cluster_merge``'s clustering): every partition's whole
    owned + halo slab through ``dbscan_fixed_size``, halo duplicates
    clustered again.  Returns ``(glabs, cores, stats row)``, the row the
    column maximum over the shard's partitions."""
    glabs, cores, rows = [], [], []
    for pts, msk, gid in slabs:
        glab, cor, ps = spans.run(
            lambda: _cluster_partition(pts, msk, gid, **cluster_kw))
        glabs.append(glab)
        cores.append(cor)
        rows.append(ps)
        passes.append(int(ps[2]))
    return glabs, cores, torch.stack(rows).max(dim=0).values


def _oc_counts_shard(slabs, *, cap, min_samples, oc_kw, spans):
    """Owner-computes pass 1 of one shard (the JAX ``_oc_counts_device``):
    each partition's pair list over its whole slab, then its owned rows'
    counts (B1, or B3 with the sketch).  Returns ``(own_cores, extracted,
    band)``; a partition whose list passed its budget gets no pass
    (``None`` core) and the caller reruns at the exact total."""
    cores, extracted, bands = [], [], []
    for pts, msk, _gid in slabs:
        def counts():
            ex = oc_extract(pts, oc_kw["eps"], msk, owned=cap,
                            **{k: v for k, v in oc_kw.items()
                               if k != "eps"})
            if ex["total"] > ex["budget"]:
                return ex, None, torch.zeros(2, dtype=torch.int64)
            core, band = oc_counts_banded(ex, min_samples)
            return ex, core, band

        ex, core, band = spans.run(counts)
        extracted.append(ex)
        cores.append(core)
        bands.append(band)
    return cores, extracted, torch.stack(bands).max(dim=0).values


def _oc_tables_shard(slabs, core_alls, extracted, counts_band, *, spans,
                     passes):
    """Owner-computes pass 2 of one shard (the JAX ``_oc_tables_device``):
    relay propagation with the owners' core flags (halo slots relay
    labels, no halo x halo tile pair runs), local roots mapped to global
    ids.  Returns ``(glabs, stats row)``: the row's live pairs are each
    list less its halo x halo pairs, its passes ``1 + the most min-label
    passes`` and its band the counts pass's plus the propagation's, as
    the JAX row."""
    glabs, lives, budgets, props, bands = [], [], [], [], []
    for (_pts, _msk, gid), core_all, ex in zip(slabs, core_alls, extracted):
        lab, p_i, band_i = spans.run(lambda: oc_propagate_banded(ex,
                                                                 core_all))
        glabs.append(_global_labels(lab, gid))
        lives.append(ex["total"] - ex["hh_pairs"])
        budgets.append(ex["budget"])
        props.append(int(p_i))
        bands.append(band_i)
        passes.append(1 + int(p_i))
    band = torch.stack(bands).max(dim=0).values + counts_band
    row = torch.cat([torch.tensor([max(lives), max(budgets),
                                   1 + max(props)], dtype=torch.int64),
                     band.to(torch.int64)])
    return glabs, row


def _overflow_row(extracted):
    """A shard's stats row after an overflowed pass 1: no pass ran."""
    return torch.tensor(
        [max(e["total"] - e["hh_pairs"] for e in extracted),
         max(e["budget"] for e in extracted), 0, 0, 0], dtype=torch.int64)


def _core_on(core_g, device, cache):
    """``core_g`` on ``device``: one copy per distinct card (none on the
    card that holds it), never one per shard."""
    key = str(device)
    if key not in cache:
        cache[key] = core_g.to(device)
    return cache[key]


def _on_device(table, device):
    """A gid table (numpy or a tensor) as a tensor on ``device``."""
    if isinstance(table, torch.Tensor):
        return table.to(device)
    return torch.from_numpy(table).to(device)


def _mesh_cluster(shards, og, hg, *, mesh, oc_on, relay, n, cap,
                  min_samples, cluster_kw, spans, passes):
    """The per-shard clustering of the fused step, shard after shard.

    ``oc_on`` off: every partition's slab clustered whole.  On: pass 1
    (owned-row counts), the owners' verdicts gathered into the ``(N+1,)``
    ``core_g`` (``relay="device"``: on the mesh's first device, the JAX
    ``pmax``; ``"host"``: in numpy, the JAX ``_oc_host_tables`` relay),
    each shard's halo slots reading their flags on its own device, then
    pass 2 (relay propagation).

    ``og``/``hg``: the stacked ``(P, cap)`` owned and ``(P, hcap)`` halo
    gids, numpy or tensors.  Returns ``(tables, stats_rows, (total,
    budget), core_g)``:
    ``tables`` per shard ``[(glab, core), ...]`` (None after an
    overflow), ``stats_rows`` one (5,) row per shard, ``(total,
    budget)`` the largest full pair list against its budget (the
    ladder's), ``core_g`` the device relay's flags (else None)."""
    rows, tables = [], []
    if not oc_on:
        overflow = (0, 0)
        for s, slabs in enumerate(shards):
            with _on(mesh.device(s)):
                glabs, cores, row = _legacy_shard(
                    slabs, cluster_kw=cluster_kw, spans=spans,
                    passes=passes)
            tables.append(list(zip(glabs, cores)))
            rows.append(row)
            overflow = max(overflow, (int(row[0]), int(row[1])))
        return tables, rows, overflow, None
    oc_kw = {k: v for k, v in cluster_kw.items() if k != "min_samples"}
    counted = []
    for s, slabs in enumerate(shards):
        with _on(mesh.device(s)):
            counted.append(_oc_counts_shard(
                slabs, cap=cap, min_samples=min_samples, oc_kw=oc_kw,
                spans=spans))
    exs = [e for _c, ex, _b in counted for e in ex]
    total = max(e["total"] for e in exs)
    budget = max(e["budget"] for e in exs)
    if total > budget:
        passes.extend([0] * len(exs))
        return None, [_overflow_row(ex) for _c, ex, _b in counted], (
            total, budget), None
    own_cores = [c for cores, _e, _b in counted for c in cores]
    dev0 = mesh.device(0)
    core_g = None
    if relay == "device":
        core_g = _replicated_core(
            gather(own_cores, dev0), _on_device(og, dev0), n + 1)
    else:
        og_np, hg_np = _np(og), _np(hg)
        core_full = np.zeros(n + 1, bool)
        sel = og_np.reshape(-1) < n
        core_full[og_np.reshape(-1)[sel]] = torch.stack(
            [c.cpu() for c in own_cores]).numpy().reshape(-1)[sel]
        halo_core_np = core_full[np.clip(hg_np, 0, n)] & (hg_np < n)
    copies = {}
    j = 0
    for s, (slabs, (cores, ex, band)) in enumerate(zip(shards, counted)):
        dev = mesh.device(s)
        with _on(dev):
            core_alls = []
            for (_pts, msk, gid), own in zip(slabs, cores):
                hgid, hmsk = gid[cap:], msk[cap:]
                if relay == "device":
                    halo_core = (_core_on(core_g, dev, copies)[
                        hgid.clamp(0, n).long()] & (hgid < n) & hmsk)
                else:
                    halo_core = torch.from_numpy(halo_core_np[j]).to(dev)
                core_alls.append(torch.cat([own, halo_core]))
                j += 1
            glabs, row = _oc_tables_shard(slabs, core_alls, ex, band,
                                          spans=spans, passes=passes)
        tables.append(list(zip(glabs, cores)))
        rows.append(row)
    return tables, rows, (total, budget), core_g


def _stacked_tables(tables, cap, device):
    """Per-shard ``(glab, core)`` lists -> ``(own_glab, own_core,
    halo_glab)`` of shapes ``(P, cap)``, ``(P, cap)``, ``(P, hcap)`` on
    ``device``, partitions in shard order (the JAX layout's)."""
    flat = [t for shard in tables for t in shard]
    return (gather([g[:cap] for g, _c in flat], device),
            gather([c[:cap] for _g, c in flat], device),
            gather([g[cap:] for g, _c in flat], device))


def _mesh_ladders(shards, og, hg, *, n, cap, mesh, oc_on, merge,
                  cluster_kw, pair_budget, merge_rounds, hint_key, stage,
                  passes, syncs):
    """The fused step's passes (:func:`_mesh_cluster`) and the device
    merge through the ladders (:func:`~pypardis_tpu_torch.utils.budget.
    run_ladders`), shared by the host-halo and ring layouts.  ``shards``:
    one list of ``(pts, msk, gid)`` slabs per shard on its device;
    ``og``/``hg``: the stacked gid tables.  Returns ``(out, pstats,
    tables)``: ``out`` the device merge's ``(final, core, rounds)``, or
    None when the host finishes the merge (``merge="host"``, or an
    OOM-class failure of the device merge), and then ``tables`` the
    per-shard ``(glab, core)`` lists it reads."""
    from ..utils import faults

    dev0 = mesh.device(0)
    min_samples = cluster_kw["min_samples"]
    spilled, memo = [], {}

    def cluster(pb):
        spans = _Spans(dev0)
        t_loop = time.perf_counter()
        out = _mesh_cluster(
            shards, og, hg, mesh=mesh, oc_on=oc_on,
            relay="host" if merge == "host" else "device", n=n, cap=cap,
            min_samples=min_samples,
            cluster_kw=dict(cluster_kw, pair_budget=pb), spans=spans,
            passes=passes)
        stage["device"] = stage.get("device", 0.0) + spans.seconds()
        stage["loop"] = (stage.get("loop", 0.0)
                         + time.perf_counter() - t_loop)
        return out

    def run_step(pb, mr):
        if "out" not in memo or memo["pb"] != pb:
            memo.update(pb=pb, out=cluster(pb))
        tables, rows, (total, budget), core_g = memo["out"]
        # Each column's maximum over the shards (the JAX rows' pmax).
        pstats = shard_max([r.cpu() for r in rows], torch.device("cpu"))
        if total > budget or merge == "host" or spilled:
            # The host union-find merge is exact: no rounds ladder.
            return (None, pstats), (total, budget), True
        t = time.perf_counter()
        try:
            faults.maybe_fail("sharded.execute")
            own_glab, own_core, halo_glab = _stacked_tables(tables, cap,
                                                            dev0)
            final, core, rounds, converged = _merge_from_tables(
                own_glab, own_core, _on_device(og, dev0),
                _on_device(hg, dev0), halo_glab, n_points=n,
                merge_rounds=mr, syncs=syncs, core_g=core_g)
        except Exception as e:  # noqa: BLE001 — re-raised unless an OOM
            if not is_degradable_error(e):
                raise
            # The degradation rung, as on the chained route: an OOM of
            # the device merge finishes on the host from these tables.
            note_degraded("merge_host", mode="kd", error=str(e)[:160])
            if dev0.type == "cuda":
                torch.cuda.empty_cache()
            spilled.append(True)
            return (None, pstats), (total, budget), True
        stage["merge"] = stage.get("merge", 0.0) + time.perf_counter() - t
        return ((final, core, rounds), pstats), (total, budget), converged

    out, pstats = run_ladders(run_step, hint_key, pair_budget, merge_rounds)
    return out, pstats, memo["out"][0] if out is None else None


def _mesh_finish(out, tables, og, hg, *, n, cap, stats, stage, syncs):
    """The merge's end: the host union-find over ``tables`` (when
    :func:`_mesh_ladders` left it to the host) or the device merge's
    outputs fetched.  Returns ``(final, core, stats)`` as numpy, the
    stats with the merge's own."""
    t = time.perf_counter()
    if out is None:
        with obs_span("sharded.merge_host"):
            own_glab, own_core, halo_glab = _stacked_tables(
                tables, cap, torch.device("cpu"))
            final, core = _host_merge_finish(n, og, own_glab, own_core,
                                             hg, halo_glab)
        stats = dict(stats, merge="host")
    else:
        final, core, rounds = out
        final, core = _np(final), _np(core)
        stats = dict(stats, merge="device", merge_rounds=int(rounds),
                     merge_converged=True, merge_host_syncs=syncs[0])
    stage["merge"] = stage.get("merge", 0.0) + time.perf_counter() - t
    return final, core, stats


def _mesh_run(points, partitioner, eps, min_samples, *, metric, block,
              mesh, precision, backend, merge, pair_budget, merge_rounds,
              owner_computes, sketch, dev):
    """The fused multi-device step (the JAX package's
    ``_sharded_step_fused`` and ``sharded_step_local`` /
    ``_oc_host_tables`` with their caller): the stacked layout on the
    host, each shard's partitions on its device, the per-shard passes
    and the merge, through the ladders.  See :func:`sharded_dbscan`."""
    n, k = points.shape
    mode = check_precision(precision)
    block = clamp_block(block, max(len(p) for p in
                                   partitioner.partitions.values()))
    stage = {}
    with obs_span("sharded.build_shards", halo="host"):
        owned, halos, stats, bufs = _mesh_build_cached(
            points, partitioner, eps, mesh, block, stage)
    p_total, cap, hcap = (int(stats["n_shard_partitions"]),
                          int(stats["owned_cap"]), int(stats["halo_cap"]))
    # The JAX _oc_applies: owner-computes runs on every mesh of more than
    # one device (only the 1-device chained route reports it off).
    oc_on = bool(owner_computes)
    _check_mesh_tile(block, cap, hcap, k, mode, oc_on)
    shards = _joined_slabs(owned, halos)
    dev0 = mesh.device(0)
    og = gather([o[2] for o in owned], dev0).reshape(p_total, cap)
    hg = gather([h[2] for h in halos], dev0).reshape(p_total, hcap)
    del owned, halos
    passes, syncs = [], [0]
    with obs_span("sharded.execute", halo="host", merge=merge):
        out, pstats, tables = _mesh_ladders(
            shards, og, hg, n=n, cap=cap, mesh=mesh, oc_on=oc_on,
            merge=merge,
            cluster_kw=dict(eps=eps, min_samples=min_samples,
                            metric=metric, block=block,
                            precision=precision, backend=backend,
                            sketch=sketch),
            pair_budget=pair_budget, merge_rounds=merge_rounds,
            hint_key=_sharded_hint_key((p_total, cap, k), hcap, block,
                                       precision, eps, metric) + (oc_on,),
            stage=stage, passes=passes, syncs=syncs)
    final, core, stats = _mesh_finish(out, tables, og, hg, n=n, cap=cap,
                                      stats=stats, stage=stage, syncs=syncs)
    staging.give_back_after_put(bufs, dev0)
    _exec_stats(stats, pstats=pstats, block=block, k=k, precision=precision,
                n=n, metric=metric, oc_on=oc_on, sketch=sketch)
    stats["stage_s"] = stage
    stats["partition_passes"] = passes
    return _canonicalize_roots(final.astype(np.int32), core), core, stats


# ---------------------------------------------------------------------------
# the ring route: owned slabs on the mesh, halos by the ring exchange
# ---------------------------------------------------------------------------


def _ring_halo_bytes(stats, hcap, k):
    """The float32 halo-buffer bytes a ring fit fills (capacity, not
    occupancy: the exchange fills fixed-size buffers)."""
    return int(stats["n_shard_partitions"]) * int(hcap) * int(k) * 4


def _oc_applies(owner_computes, mesh, p_total) -> bool:
    """Whether the owner-computes step runs (the JAX rule): everywhere
    but a 1-device mesh of several partitions."""
    return bool(owner_computes) and not (mesh.size == 1
                                         and int(p_total) > 1)


def _with_boxes(owned, exp_lo, exp_hi, mesh):
    """Per-shard ``(owned, mask, gid)`` tensors with their shard's
    ``(L, k)`` widened boxes as float32 tensors on its device."""
    per = exp_lo.shape[0] // mesh.size
    return [(o, m, g,
             *(torch.as_tensor(np.ascontiguousarray(b[s * per:(s + 1) * per]),
                               dtype=torch.float32).to(mesh.device(s))
               for b in (exp_lo, exp_hi)))
            for s, (o, m, g) in enumerate(owned)]


def _ship_owned(arrays, mesh):
    """:func:`build_owned_shards`' ``(P, k, cap)`` slabs, masks and gids
    as one ``(L, k, cap)`` / ``(L, cap)`` triple per shard on its device
    (partition ``j`` on shard ``j // L``)."""
    per = arrays[0].shape[0] // mesh.size
    return [tuple(torch.from_numpy(a[s * per:(s + 1) * per]).to(
        mesh.device(s)) for a in arrays) for s in range(mesh.size)]


def ring_exchange_step(shards, *, mesh, hcap, stage=None):
    """The ring halo exchange (the JAX ``ring_exchange_step``):
    ``shards`` holds one ``(owned, mask, gid, exp_lo, exp_hi)`` per
    shard on its device (:func:`~.halo.ring_halo_exchange_multi`'s
    shapes).  Returns one ``(halo, halo_mask, halo_gid, overflow)`` per
    shard.  ``stage`` (a dict) gains the exchange's seconds under
    ``"exchange"``: CUDA events on the card (the exchange queues without
    a sync), the host clock on the CPU."""
    spans = _Spans(mesh.device(0))
    out = spans.run(lambda: ring_halo_exchange_multi(
        *([sh[i] for sh in shards] for i in range(5)), int(hcap), mesh))
    if stage is not None:
        stage["exchange"] = stage.get("exchange", 0.0) + spans.seconds()
    return out


def _ring_slabs(shards, halos):
    """Each shard's partitions as ``(k, cap + hcap)`` slabs of owned and
    ring-halo rows, with masks and gids, on the shard's device."""
    return _joined_slabs([sh[:3] for sh in shards], [h[:3] for h in halos])


def _ring_ladder(shards, *, n, k, cap, p_total, mesh, oc_on, merge, hcap,
                 cluster_kw, pair_budget, merge_rounds, stage, passes,
                 syncs):
    """The ``hcap`` ladder around the fused step's ladders (the JAX
    ``_ring_ladder``): the ring exchange at ``hcap`` (rounded up to the
    block; None starts at ``round_up(max(block, cap // 2), block)``),
    then the passes and the merge (:func:`_mesh_ladders`) on the owned +
    halo slabs.  The overflow is read right after the exchange (one
    sync, before any pass; the JAX ladder raises ``_HaloOverflow`` out
    of its cluster step instead, with the same counts): a
    ``halo_overflow`` event, and without an explicit ``hcap`` a
    ``ring.hcap`` retry at twice the capacity, up to 4 attempts; then
    ``note_giveup`` and a ``RuntimeError``.  Returns ``(out, pstats,
    tables, og, hg, hcap)``: :func:`_mesh_ladders`' outputs, the stacked
    gid tables on the mesh's first device and the capacity that held."""
    block = cluster_kw["block"]
    mode = check_precision(cluster_kw["precision"])
    explicit = hcap is not None
    this_hcap = (round_up(int(hcap), block) if explicit
                 else round_up(max(block, cap // 2), block))
    attempts = 1 if explicit else 4
    dev0 = mesh.device(0)
    while True:
        _check_mesh_tile(block, cap, this_hcap, k, mode, oc_on)
        halos = ring_exchange_step(shards, mesh=mesh, hcap=this_hcap,
                                   stage=stage)
        if sum(int(h[3].sum()) for h in halos):
            obs_event("halo_overflow", hcap=this_hcap, retry=attempts > 1)
            attempts -= 1
            if attempts <= 0:
                err = RuntimeError(
                    f"ring halo buffer overflow at hcap={this_hcap}; "
                    f"pass a larger hcap"
                    if explicit
                    else f"ring halo buffer overflow persisted up to "
                    f"hcap={this_hcap}"
                )
                note_giveup("ring.hcap", err)
                raise err
            note_retry("ring.hcap", 0.0,
                       RuntimeError(f"halo overflow at hcap={this_hcap}"))
            this_hcap *= 2
            continue
        og = gather([sh[2] for sh in shards], dev0).reshape(p_total, cap)
        hg = gather([h[2] for h in halos], dev0).reshape(p_total, this_hcap)
        # hcap changes the tile count, so it keys the hint too.
        hint_key = _sharded_hint_key(
            (p_total, cap, k), this_hcap, block, cluster_kw["precision"],
            cluster_kw["eps"], cluster_kw["metric"]) + (bool(oc_on),)
        out, pstats, tables = _mesh_ladders(
            _ring_slabs(shards, halos), og, hg, n=n, cap=cap, mesh=mesh,
            oc_on=oc_on, merge=merge, cluster_kw=cluster_kw,
            pair_budget=pair_budget, merge_rounds=merge_rounds,
            hint_key=hint_key, stage=stage, passes=passes, syncs=syncs)
        return out, pstats, tables, og, hg, this_hcap


def _ring_execute(shards, stats, *, n, k, mesh, owner_computes, merge,
                  hcap, cluster_kw, pair_budget, merge_rounds, stage,
                  span_kw):
    """The ring's execution and finish over laid-out ``shards`` (one
    ``(owned, mask, gid, exp_lo, exp_hi)`` per shard on its device),
    shared by the host-input and device-input routes: the ladders under
    the ``sharded.execute`` span, the merge's end, the JAX ring stats
    (``halo_exchange``, the ``halo_cap`` that held, ``halo_bytes``; no
    ``halo_factor``: the host never sees the halo sets) and the
    execution stats.  Returns ``(labels, core, stats)``."""
    p_total, cap = int(stats["n_shard_partitions"]), int(stats["owned_cap"])
    oc_on = _oc_applies(owner_computes, mesh, p_total)
    passes, syncs = [], [0]
    with obs_span("sharded.execute", halo="ring", merge=merge, **span_kw):
        out, pstats, tables, og, hg, used = _ring_ladder(
            shards, n=n, k=k, cap=cap, p_total=p_total, mesh=mesh,
            oc_on=oc_on, merge=merge, hcap=hcap, cluster_kw=cluster_kw,
            pair_budget=pair_budget, merge_rounds=merge_rounds,
            stage=stage, passes=passes, syncs=syncs)
    stats = dict(stats, halo_exchange="ring", halo_cap=used,
                 halo_bytes=_ring_halo_bytes(stats, used, k))
    final, core, stats = _mesh_finish(out, tables, og, hg, n=n, cap=cap,
                                      stats=stats, stage=stage, syncs=syncs)
    if stats["merge"] == "device":
        # The JAX ring route reports its device merge without the key.
        del stats["merge"]
    _exec_stats(stats, pstats=pstats, block=cluster_kw["block"], k=k,
                precision=cluster_kw["precision"], n=n,
                metric=cluster_kw["metric"], oc_on=oc_on,
                sketch=cluster_kw["sketch"])
    stats["stage_s"] = stage
    stats["partition_passes"] = passes
    return _canonicalize_roots(final.astype(np.int32), core), core, stats


def _ring_run(points, partitioner, eps, min_samples, *, metric, block, mesh,
              precision, backend, merge, pair_budget, merge_rounds,
              owner_computes, sketch, hcap, stream):
    """The ring route from host input (``halo="ring"``): the owned
    layout, in RAM through the staging cache (:func:`_ring_build_cached`)
    or streamed (:func:`build_owned_shards_streaming`, never cached),
    then :func:`_ring_execute`.  See :func:`sharded_dbscan`."""
    n, k = points.shape
    block = clamp_block(block, max(len(p) for p in
                                   partitioner.partitions.values()))
    stage = {}
    with obs_span("sharded.build_shards", halo="ring", stream=bool(stream)):
        t = time.perf_counter()
        if stream:
            owned, exp_lo, exp_hi, _labels, stats = (
                build_owned_shards_streaming(points, partitioner, eps,
                                             block, mesh))
            stage["slab_build"] = time.perf_counter() - t
        else:
            owned, exp_lo, exp_hi, stats, bufs = _ring_build_cached(
                points, partitioner, eps, mesh, block, stage)
        shards = _with_boxes(owned, exp_lo, exp_hi, mesh)
    out = _ring_execute(
        shards, stats, n=n, k=k, mesh=mesh, owner_computes=owner_computes,
        merge=merge, hcap=hcap,
        cluster_kw=dict(eps=eps, min_samples=min_samples, metric=metric,
                        block=block, precision=precision, backend=backend,
                        sketch=sketch),
        pair_budget=pair_budget, merge_rounds=merge_rounds, stage=stage,
        span_kw={})
    if not stream:
        staging.give_back_after_put(bufs, mesh.device(0))
    return out


def _ring_build_cached(points, partitioner, eps, mesh, block, stage):
    """The ring route's owned slabs through the staging cache's
    ``ring_owned`` route (the JAX ``_ring_build_cached``; keyed without
    eps); the widened boxes are eps's and rebuilt every fit.  Returns
    ``(owned, exp_lo, exp_hi, stats, bufs)`` as :func:`build_owned_shards`
    and :func:`_ship_owned` give them, ``bufs`` the borrowed pool
    buffers.  ``stage`` gains ``slab_build`` and ``ship`` (0 on a
    hit)."""
    devices = [mesh.device(s) for s in range(mesh.size)]
    base = _sharding_cache_key(points, partitioner, mesh.size, block,
                               devices)
    t = time.perf_counter()
    center, exp_lo, exp_hi, labels = _expanded_frame_meta(points, partitioner,
                                                          eps)
    cached = staging.device_get(RING_OWNED, base)
    bufs = []
    stage["ship"] = 0.0
    if cached is None:
        owned_idx, arrays, cap, p_total = _owned_layout(
            points, center, partitioner, labels, mesh.size, block,
            alloc=_staged_alloc(bufs))
        stats = _owned_stats(owned_idx, cap, p_total, len(points))
        t1 = time.perf_counter()
        owned = _ship_cached(RING_OWNED, base, arrays, mesh, stats)
        stage["ship"] = time.perf_counter() - t1
        stage["slab_build"] = t1 - t
    else:
        owned, stats = _per_shard(cached[0]), cached[1]
        stage["slab_build"] = time.perf_counter() - t
    exp_lo, exp_hi = _pad_inverted_boxes(exp_lo, exp_hi,
                                         int(stats["n_shard_partitions"]))
    return owned, exp_lo, exp_hi, dict(stats), bufs


def sharded_dbscan_device(
    points,
    eps: float,
    min_samples: int,
    metric="euclidean",
    block: int = 1024,
    mesh=None,
    precision: str = "high",
    backend: str = "auto",
    hcap: Optional[int] = None,
    pair_budget: Optional[int] = None,
    merge_rounds: int = 32,
    max_partitions: Optional[int] = None,
    split_method: str = "min_var",
    sample_size: int = 262_144,
    seed: int = 0,
    merge: str = "auto",
    owner_computes: bool = True,
    device=None,
    sketch=None,
):
    """Cluster an ``(N, k)`` tensor that lies on the mesh's device type
    without bringing its coordinates to the host (the JAX
    ``sharded_dbscan_device``, the counterpart of the reference's
    ``train(rdd)`` on distributed data).

    The KD split planes come from a seeded host subsample
    (``sample_size`` rows, ``seed``; only those rows are fetched); the
    routing, the Morton slab layout and the boxes run on the device
    (:mod:`.device_input`), the boxes are widened by 2*eps and 4 ULPs in
    float32, and the ring route clusters and merges
    (:func:`_ring_execute`, the ``hcap`` ladder included).  The host
    sees the subsample, the ``(P,)`` counts, the gid and label tables
    and the ``(N,)`` results.  ``merge`` as in :func:`sharded_dbscan`;
    ``"host"`` fetches only the occurrence tables.

    ``mesh``: a :class:`~.mesh.Mesh` (None: :func:`~.mesh.default_mesh`
    on the card, one CPU device under ``device="cpu"``).  A tensor on
    another device type than the mesh's is moved to the mesh's first
    device, as a single-device fit moves it.  Partition ``j`` lives on
    shard ``j // L``.  Returns ``(labels, core, stats, partitioner,
    pid)``: ``pid`` the ``(N,)`` int32 routed partition of each point,
    on the device; ``partitioner`` the subsample's ``KDPartitioner``,
    whose tree routed the points."""
    from ..dbscan import resolve_device
    from ..partition import KDPartitioner
    from .device_input import (
        device_owned_layout,
        device_partition_counts,
        device_route,
        tree_arrays,
    )
    from .mesh import default_mesh

    metric = norm_metric(metric)
    if merge not in ("auto", "device", "host"):
        raise ValueError(f"merge must be auto|device|host, got {merge!r}")
    dev = resolve_device(device)
    if mesh is None:
        mesh = default_mesh() if dev.type == "cuda" else Mesh([dev])
    mesh = as_mesh(mesh)
    if mesh.device_type != dev.type:
        raise ValueError(
            f"the mesh's devices are {mesh.device_type} but the fit runs on "
            f"{dev.type}"
        )
    if not isinstance(points, torch.Tensor):
        raise TypeError("sharded_dbscan_device takes a torch.Tensor")
    if points.device.type != mesh.device_type:
        points = points.to(mesh.device(0))
    n, k = points.shape
    # The route caches nothing (a tensor is never fingerprinted), as in
    # the JAX package: its counters read this fit's zeros.
    staging.begin_fit()
    stage = {}
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    if n > sample_size:
        sel = np.sort(rng.choice(n, size=sample_size, replace=False))
        sample = points[torch.from_numpy(sel).to(points.device)]
    else:
        sample = points
    part = KDPartitioner(
        sample.cpu().numpy(),
        max_partitions=(mesh.size if max_partitions is None
                        else int(max_partitions)),
        split_method=split_method, sample_size=None)
    p_total = round_up(max(part.n_partitions, mesh.size), mesh.size)
    with obs_span("sharded.build_shards", halo="ring", input="device"):
        pid = device_route(points, *tree_arrays(part.tree))
        counts = device_partition_counts(pid, p_total=p_total)
        sizes = [int(c) for c in counts.cpu()]
        block = clamp_block(block, max(sizes))
        cap = round_up(max(max(sizes), 1), block)
        owned, msk, gid, lo, hi = device_owned_layout(
            points, pid, counts, p_total=p_total, cap=cap)
        two_eps = torch.tensor(2 * eps, dtype=torch.float32,
                               device=lo.device)
        inf = torch.tensor(float("inf"), dtype=torch.float32,
                           device=lo.device)
        exp_lo, exp_hi = lo - two_eps, hi + two_eps
        exp_lo = exp_lo - 4 * (torch.nextafter(exp_lo.abs(), inf)
                               - exp_lo.abs())
        exp_hi = exp_hi + 4 * (torch.nextafter(exp_hi.abs(), inf)
                               - exp_hi.abs())
        per = p_total // mesh.size
        shards = [tuple(a[s * per:(s + 1) * per].to(mesh.device(s))
                        for a in (owned, msk, gid, exp_lo, exp_hi))
                  for s in range(mesh.size)]
        del owned, msk, gid
    stage["slab_build"] = time.perf_counter() - t
    if merge == "auto":
        merge = "host" if n >= MERGE_HOST_AUTO else "device"
    stats = {
        "owned_cap": cap,
        "n_shard_partitions": p_total,
        "pad_waste": float(p_total * cap) / max(n, 1) - 1.0,
        "partition_sizes": sizes,
        "input": "device",
    }
    labels, core, stats = _ring_execute(
        shards, stats, n=n, k=k, mesh=mesh, owner_computes=owner_computes,
        merge=merge, hcap=hcap,
        cluster_kw=dict(eps=eps, min_samples=min_samples, metric=metric,
                        block=block, precision=precision, backend=backend,
                        sketch=sketch),
        pair_budget=pair_budget, merge_rounds=merge_rounds, stage=stage,
        span_kw={"input": "device"})
    return labels, core, stats, part, pid
