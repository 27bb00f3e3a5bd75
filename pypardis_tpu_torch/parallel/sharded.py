"""The KD route on one card: per-partition fits over owned + halo slabs,
then a label merge (counterpart of ``pypardis_tpu/parallel/sharded.py``,
its single-device chained form).

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
  the JAX package's ``pmin``/``pmax`` over the mesh axis are the
  identity on one card);
* ``merge="host"``: a union-find over the compact occurrence tables
  (:func:`~pypardis_tpu_torch.parallel.merge.merge_occurrences`).

Why the 2*eps halo makes home-run results exact: every point within eps
of a partition's box has its whole eps-ball inside the box widened by
2*eps, so each owned point's core flag, cluster links and border attach
are decided in its home run; links across partitions come from halo
duplicates that are core somewhere.  Only points core in their home
partition link clusters, and merged clusters take the least root id
(the reference's ``aggregator.py:38-45``).

Every halo point is clustered again in every foreign partition, as in
the JAX package's chained route (``owner_computes`` is reported False):
``stats["duplicated_work_factor"]`` measures that cost.  Each
partition's dispatch is retried through transient faults, a jobstate
resumes a killed fit from its finished partitions, and an OOM of the
device merge finishes that merge on the host (see :func:`sharded_dbscan`).
The fused multi-device steps, owner-computes on this route, the ring
exchange and streaming input are later slices (ROADMAP A10-A12) and
raise ``NotImplementedError`` here (``mode="global_morton"`` runs the
global-Morton route's chained form, :mod:`.global_morton`); the staging
cache's evict-and-retry rung comes with that cache.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Optional

import numpy as np
import torch

from ..obs import heartbeat as obs_heartbeat
from ..obs import span as obs_span
from ..ops.cuda_kernels import _pallas_block
from ..ops.distances import INT_INF
from ..ops.labels import dbscan_fixed_size
from ..ops.sketch import sketch_dims
from ..partition import expanded_members, spatial_order
from ..utils.budget import run_ladders
from ..utils.hints import dispatch_tag
from ..utils.retry import is_degradable_error, note_degraded
from ..utils.shaping import clamp_block, round_up, row_chunks
from ..utils.validate import check_precision, norm_metric

# Above this point count merge="auto" reconciles labels on the host: the
# device merge holds several (N+1,) int32 arrays beside the slabs, the
# host merge only the compact per-slot tables.  The JAX package's value,
# kept as it is: the crossover has not been measured on the card (PERF.md
# gives one 1M reading of each merge).
MERGE_HOST_AUTO = 32_000_000


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def _expanded_frame_meta(points, partitioner):
    """The frame every slab shares: ``(center, labels)``, the float64
    dataset mean and the sorted partition labels.  (The JAX function
    also returns the 2*eps-widened boxes, which only its ring route
    reads.)"""
    center = np.asarray(points).mean(axis=0, dtype=np.float64)
    return center, sorted(partitioner.partitions)


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


def _owned_layout(points, center, partitioner, labels, n_shards, block):
    """``(P, k, cap)`` owned slabs, Morton-sorted per partition, with
    their ``(P, cap)`` masks and gids (``n`` in padding slots)."""
    n, k = points.shape
    _p_real, p_total, part_idx, cap = _layout_geometry(
        partitioner, labels, n_shards, block
    )
    owned = np.zeros((p_total, k, cap), np.float32)
    owned_mask = np.zeros((p_total, cap), bool)
    owned_gid = np.full((p_total, cap), n, np.int32)
    owned_idx = [
        _fill_slab(owned, owned_mask, owned_gid, j, points, idx, center)
        for j, idx in enumerate(part_idx)
    ]
    return owned_idx, (owned, owned_mask, owned_gid), cap, p_total


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


def _halo_slabs(points, partitioner, eps, labels, center, p_total, block):
    """``(P, k, hcap)`` halo slabs with masks and gids, and their stats."""
    n, k = points.shape
    halo_idx = _halo_sets(points, partitioner, eps, labels)
    hcap = _halo_cap(halo_idx, block)
    halo = np.zeros((p_total, k, hcap), np.float32)
    halo_mask = np.zeros((p_total, hcap), bool)
    halo_gid = np.full((p_total, hcap), n, np.int32)
    for j, hi in enumerate(halo_idx):
        _fill_slab(halo, halo_mask, halo_gid, j, points, hi, center)
    return (halo, halo_mask, halo_gid), _halo_stats(halo_idx, hcap, n, k)


def build_shards(points, partitioner, eps, n_shards, block):
    """Lay out the points as ``(P, k, cap)`` owned and ``(P, k, hcap)``
    halo slabs (numpy, on the host), with masks and global ids; padding
    slots carry gid ``n``, the dump row of the merge's scatters.
    Returns ``((owned, owned_mask, owned_gid, halo, halo_mask,
    halo_gid), stats)``.  The chained route builds one partition's slab
    at a time (:func:`_partition_slab`); this whole layout is the one
    the stacked multi-device steps take (ROADMAP A10)."""
    points = np.asarray(points)
    center, labels = _expanded_frame_meta(points, partitioner)
    owned_idx, arrays_o, cap, p_total = _owned_layout(
        points, center, partitioner, labels, n_shards, block
    )
    arrays_h, h_stats = _halo_slabs(
        points, partitioner, eps, labels, center, p_total, block
    )
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
    center, labels = _expanded_frame_meta(points, partitioner)
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


def _partition_slab(pts, msk, gid, points, layout, p):
    """Fill partition ``p``'s ``(k, cap + hcap)`` slab ``pts``, its mask
    ``msk`` and gids ``gid`` (numpy, overwritten whole): the owned points
    Morton-sorted from row 0, empty rows up to ``cap``, then the halo
    points Morton-sorted from row ``cap``; empty rows carry gid ``n``."""
    cap = layout["cap"]
    pts.fill(0.0)
    msk.fill(False)
    gid.fill(len(points))
    for idx, rows in ((layout["part_idx"][p], slice(None, cap)),
                      (layout["halo_idx"][p], slice(cap, None))):
        _fill_slab(pts[None, :, rows], msk[None, rows], gid[None, rows], 0,
                   points, idx, layout["center"])


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
        return self.host_s + sum(
            s.elapsed_time(e) for s, e in self.events) / 1e3


def _cluster_partition(pts, msk, gid, *, eps, min_samples, metric, block,
                       precision, backend, pair_budget):
    """One partition's ``(k, cap + hcap)`` slab through
    ``dbscan_fixed_size``; local roots map to global ids.  Returns
    ``(glab, core, pair_stats)``."""
    lab, cor, ps = dbscan_fixed_size(
        pts, eps, min_samples, msk, block=block, precision=precision,
        backend=backend, pair_budget=pair_budget, metric=metric,
    )
    glab = torch.where(lab >= 0, gid[lab.clamp_min(0).long()], -1)
    return glab.to(torch.int32), cor, ps


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
                       merge_rounds, syncs=None):
    """The device merge: per-slot label tables -> ``(final, core,
    rounds, converged)``, ``final`` and ``core`` of shape ``(N,)`` on
    the tables' device.  Scatters run over ``(N+1,)`` int32 arrays whose
    last row is the dump row of padding slots.  ``syncs`` (a one-item
    list) counts the host syncs: one per round and one per pointer-jump
    step."""
    syncs = [0] if syncs is None else syncs
    n1 = n_points + 1
    dev = own_glab.device
    og_flat = og.reshape(-1).long()
    home_label = torch.full((n1,), -1, dtype=torch.int32, device=dev)
    home_label.scatter_reduce_(0, og_flat, own_glab.reshape(-1), "amax")
    core_g = _replicated_core(own_core, og, n1)
    home_label[n1 - 1] = -1

    h_gid = hg.reshape(-1).long()
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
                metric="euclidean", oc_on=False):
    """The execution telemetry: ``owner_computes`` (``oc_on``: each slab
    counts only its owned rows; off, as on the KD route, every halo
    duplicate is clustered again), ``duplicated_work_factor`` (slots
    whose core flag is computed, over dataset points), and from the pair
    stats (a (5,) row or rows of them; each column's maximum binds) the
    live pairs, kernel passes, band stats, the fit's tile (the port's
    ``_pallas_block``) and the slab's tiles."""
    p_total = int(stats["n_shard_partitions"])
    cap = int(stats["owned_cap"])
    hcap = int(stats.get("halo_cap", 0))
    stats["owner_computes"] = bool(oc_on)
    stats["duplicated_work_factor"] = float(
        p_total * (cap if oc_on else cap + hcap)) / max(n, 1)
    ps = [int(v) for v in _np(pstats).reshape(-1, 5).max(axis=0)]
    stats["live_pairs"] = ps[0]
    stats["kernel_passes"] = ps[2]
    stats["band_pairs"] = ps[3]
    stats["rescored_tiles"] = ps[4]
    stats["kernel_block"] = int(_pallas_block(
        block, max(cap + hcap, 1), int(k), check_precision(precision)))
    stats["kernel_tiles"] = -(-max(cap + hcap, 1) // stats["kernel_block"])
    stats["sketch_k"] = int(sketch_dims(int(k), metric))
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


def _chained_tables_overlap(
    points, layout, *, eps, min_samples, metric, precision, backend,
    pair_budget, device, stage, passes, jobstate=None,
):
    """The per-partition loop: each partition's slab built on the host
    (:func:`_partition_slab` into a :class:`_SlabRing` buffer), shipped
    and clustered on the card.

    One background host thread builds and ships the next partition's
    slab while the card clusters this one: the port's round loop syncs
    the host every round, so the build cannot ride on asynchronous
    dispatch as in the JAX package.  Each partition's slab is freed once
    its tables are out.

    Fault tolerance (the JAX route's): each dispatch runs under a
    :class:`~pypardis_tpu_torch.utils.retry.Retrier` with the
    ``chained.partition`` fault site inside it; a retry re-dispatches
    from the slab already on the device (the dispatch consumes nothing).
    With ``jobstate`` the partitions snapshotted under this pair budget
    (tag ``pair_budget or 0``) are restored, not built nor dispatched
    (``jobstate_restore`` event, ``route="chained"``), and each
    dispatched partition's tables are noted at the cadence.  On an error
    that leaves the loop, the builder thread is joined and the ring's
    buffers dropped before the error propagates, so no thread of a
    failed attempt outlives it.

    Returns ``(glabs, cores, pstats, gid_o_host, gid_h_host, gid_dev,
    overlap_efficiency)``: per-partition labels, cores and pair stats,
    the host gid tables the host merge reads, the device gid rows the
    device merge reads, and the loop's device-busy seconds (the sum of
    :class:`_Spans`, CUDA-event spans on the card) over its wall
    seconds.  ``stage`` gains the build's seconds (``slab_build``), the
    busy seconds (``device``) and the loop's wall (``loop``)."""
    from ..obs import event as obs_event
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
    ring = _SlabRing(k, cap + hcap, device) if live else None
    gid_o_host = np.full((p_total, cap), n, np.int32)
    gid_h_host = np.full((p_total, hcap), n, np.int32)
    build_s = [0.0]

    def build(p, i):
        t = time.perf_counter()
        pts, msk, gid = ring.acquire(i)
        _partition_slab(pts, msk, gid, points, layout, p)
        gid_o_host[p] = gid[:cap]
        gid_h_host[p] = gid[cap:]
        out = ring.ship(i)
        build_s[0] += time.perf_counter() - t
        return out

    spans = _Spans(device)
    glabs, cores, pstats, gid_dev = [], [], [], []
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
            slab, ev = nxt.result()
            i += 1
            if i < len(live):
                # THE overlap: the next partition's build and copy run
                # while the card clusters this one.
                nxt = pool.submit(build, live[i], i)
            ring.wait(slab, ev)
            pts, msk, gid = slab

            def one_partition():
                faults.maybe_fail("chained.partition")
                return spans.run(lambda: _cluster_partition(
                    pts, msk, gid, eps=eps, min_samples=min_samples,
                    metric=metric, block=layout["block"],
                    precision=precision, backend=backend,
                    pair_budget=pair_budget,
                ))

            glab, cor, ps = Retrier("chained.partition").run(one_partition)
            glabs.append(glab)
            cores.append(cor)
            pstats.append(ps)
            passes.append(int(ps[2]))
            gid_dev.append(gid)
            del slab, pts, msk
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
        f"route's chained form on one card (mode='kd', halo='host')"
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
):
    """Cluster ``points`` (N, k) over ``partitioner``'s KD partitions on
    one card.  Returns ``(labels, core, stats)``: labels are global root
    ids (each cluster's least core-point index, -1 noise) in input order.

    The JAX package's ``sharded_dbscan(..., mesh=default_mesh(1))``:
    per-partition fits over owned + halo slabs, then the label merge.
    ``merge``: ``"device"`` (torch on the card), ``"host"`` (union-find
    over the occurrence tables) or ``"auto"`` (host from
    :data:`MERGE_HOST_AUTO` points, or under host-RSS pressure,
    :func:`~pypardis_tpu_torch.obs.resources.memory_pressure`); labels
    are byte-identical under both.  Partition ``p + 1``'s slab is built
    and shipped on a host thread while the card clusters partition ``p``
    (``stats["overlap_efficiency"]`` with more than one partition).

    ``pair_budget`` and ``merge_rounds`` run the ladders of
    :func:`~pypardis_tpu_torch.utils.budget.run_ladders`: one rerun at
    the exact pair total, one merge retry at 4x the rounds, then an
    error; never a truncated or under-merged result.  A kernel that
    fails raises: there is no fallback to the plain versions.

    ``mode="global_morton"`` runs :func:`~.global_morton.
    global_morton_dbscan` (the partitioner unread, ``chain`` from
    ``PPTORCH_GM_CHAIN``).  ``owner_computes`` is accepted and reported
    False, as the JAX package's chained route reports it.  ``overlap``
    is accepted for the JAX signature and changes nothing: the JAX
    switch turns off an overlap that rides on asynchronous dispatch,
    which the port's builder thread does not.  ``halo="ring"``,
    ``stream``, ``hcap`` and a mesh of more than one device raise
    ``NotImplementedError``.

    Fault tolerance, as in the JAX package's chained route: each
    partition's dispatch runs under a retry with the
    ``chained.partition`` fault site; ``jobstate``
    (:class:`~pypardis_tpu_torch.utils.jobstate.JobState`) restores the
    partitions a killed run snapshotted and notes each finished one; an
    OOM-class failure of the device merge itself (the
    ``sharded.execute`` fault site) finishes that merge on the host from
    the tables the run produced (``note_degraded("merge_host")``,
    ``stats["merge"] == "host"``).  No other failure degrades: an OOM in
    a partition's dispatch, which the host merge would not cure, and a
    kernel error raise.  (The JAX chained route reruns the whole fit
    under the host merge after an OOM anywhere in it.)  ``device``: None
    runs on the card (and raises without CUDA); ``"cpu"`` runs the
    kernels' plain versions.

    Stats beyond the JAX package's: ``stage_s`` (seconds of the halo
    sets, the host slab build, the per-partition busy time, the
    clustering loop's wall and the merge), ``partition_passes`` (each
    partition dispatch's kernel passes, every ladder attempt, 0 where
    its pair list overflowed) and, under the device merge,
    ``merge_host_syncs``.

    Telemetry on the current recorder, as in the JAX package: the spans
    ``sharded.build_shards`` (the geometry and halo sets),
    ``sharded.execute`` (the partitions and the device merge, through
    the ladders) and ``sharded.merge_host``, the ladders' events and the
    heartbeat ``chained.partitions``.
    """
    from ..dbscan import resolve_device
    from ..utils import faults

    faults.from_env()
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
    if halo == "ring":
        _refuse("halo='ring'", "A10/A11")
    if halo != "host":
        raise ValueError(f"halo must be 'host' or 'ring', got {halo!r}")
    if stream:
        _refuse("stream=True", "A10/A11")
    if hcap is not None:
        _refuse("hcap (the ring halo's capacity)", "A10/A11")
    if _mesh_size(mesh) > 1:
        _refuse("a mesh of more than one device", "A10/A11")
    metric = norm_metric(metric)
    if merge not in ("auto", "device", "host"):
        raise ValueError(f"merge must be auto|device|host, got {merge!r}")
    dev = resolve_device(device)
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
    return _chained_run(
        points, partitioner, eps, min_samples, metric=metric, block=block,
        precision=precision, backend=backend, merge=merge,
        pair_budget=pair_budget, merge_rounds=merge_rounds,
        jobstate=jobstate, dev=dev)


def _chained_run(points, partitioner, eps, min_samples, *, metric, block,
                 precision, backend, merge, pair_budget, merge_rounds,
                 jobstate, dev):
    """The chained route under a resolved ``merge``: the layout, the
    partition loop and the merge through the ladders (the body of
    :func:`sharded_dbscan`)."""
    from ..utils import faults

    n, k = points.shape
    with obs_span("sharded.build_shards", halo="host"):
        layout, stats = _chained_layout(points, partitioner, eps, block,
                                        precision)
    block = layout["block"]
    stage = {"halo_sets": layout["halo_sets_s"]}
    passes = []
    eff_cell = [0.0]

    def cluster(pb):
        glabs, cores, pstats, gid_o, gid_h, gid_dev, eff = (
            _chained_tables_overlap(
                points, layout, eps=eps, min_samples=min_samples,
                metric=metric, precision=precision, backend=backend,
                pair_budget=pb, device=dev, stage=stage, passes=passes,
                jobstate=jobstate,
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
                precision=precision, n=n, metric=metric)
    stats["stage_s"] = stage
    stats["partition_passes"] = passes
    return _canonicalize_roots(final.astype(np.int32), core), core, stats
