"""The global-Morton route (counterpart of
``pypardis_tpu/parallel/global_morton.py``): its mesh engine and its
chained form on one card.

The KD route (:mod:`.sharded`) duplicates every point within 2*eps of a
partition's box into that partition's halo and clusters it again there.
The global-Morton route clusters each point exactly once
(``duplicated_work_factor == 1.0``):

* the whole dataset is keyed by one global Morton order, taken by an
  external sample-sort over row chunks with an on-disk spill
  (:func:`~pypardis_tpu_torch.partition.morton_range_split_streaming`),
  and cut into ``chain`` contiguous ranges that equalise estimated work;
* each range's slab is its rows in that order, with the fused layout's
  segment breaks (a fresh tile where consecutive rows jump farther than
  4*eps, :func:`_segment_plan_from_d2`), followed by its boundary cover:
  every tile of another range whose box lies within eps of one of this
  range's tile boxes (:func:`_chain_boundary_tiles`), each in its own
  tile-aligned slot;
* pass A runs the owner-computes counts range by range (B1, or B3 with
  the sketch past 128 axes; :func:`~pypardis_tpu_torch.ops.labels.
  oc_counts_banded`) into a host ``(N,)`` core table; pass B rebuilds
  each slab from the spill and runs relay propagation (B2, or B4;
  :func:`~pypardis_tpu_torch.ops.labels.oc_propagate_banded`) with the
  boundary slots' core flags taken from their owners;
* pass B's labels are the KD route's occurrence tables, which the host
  union-find merges (:func:`~.merge.merge_occurrences`).

Only one range's owned + boundary slab is on the card at a time, and on
the host only that slab, one spill read and the ``(N,)`` label and core
tables: the route clusters a disk-backed ``np.memmap`` larger than host
RAM.

The mesh engine (:func:`_gm_mesh_dbscan`; more than one device, or one
with ``chain <= 1``) gives each device of a :class:`~.mesh.Mesh` one
contiguous Morton range (:func:`build_morton_shards`, or
:func:`build_morton_shards_streaming` from a memmap) and ships only
boundary TILES: each shard selects its tiles within eps of another
shard's tile boxes (:func:`~.halo.boundary_send_select`, the sketch
tightening its set past 128 axes), the buffers ride ``P - 1`` ring hops
(:func:`~.halo.ring_tile_round`: shard ``s`` hands its buffer to
``s + 1``), each shard keeps the tiles that reach its own and then the
rows within eps of its tile boxes (:func:`_gm_flatten_step`).  The owned
rows' counts run over the owned slab before the exchange and over the
boundary columns after it (:func:`~..ops.labels.oc_counts_delta`; their
sum is the fused counts bitwise), relay propagation gives each shard's
occurrence tables, and the merge is a host-stepped cross-shard
min-label fixpoint (:func:`_gm_fixpoint`) or the host union-find.  One
process drives every shard, one after another.

Labels are the JAX route's, byte for byte, on both forms, and those of
the fused single-card fit after :func:`~.sharded._canonicalize_roots`.
Both forms run the Euclidean and the cityblock metric (the L1 passes,
the sketch off); the tile selections stay Euclidean box gaps, which
bound the cityblock distance from below too.  :func:`sweep_graph_global_morton`
is the sweep's one distance pass over the same shards.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..obs import current as obs_current
from ..obs import event as obs_event
from ..obs import heartbeat as obs_heartbeat
from ..obs import span as obs_span
from ..ops.distances import INT_INF
from ..ops.labels import (
    gm_backend,
    oc_counts_banded,
    oc_extract,
    oc_propagate_banded,
    oc_raw_counts,
)
from ..partition import morton_range_split_streaming
from ..utils import faults
from ..utils.budget import run_ladders
from ..utils.hints import dispatch_tag
from ..utils.retry import Retrier, note_giveup, note_retry
from ..utils.shaping import clamp_block, round_up
from ..utils.validate import check_precision, norm_metric, validate_params
from . import staging
from .merge import merge_occurrences
from .sharded import (
    _Spans,
    _canonicalize_roots,
    _exec_stats,
    _mesh_size,
)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def _segbreak_skip(m, k, block, eps) -> bool:
    """Whether a range keeps the identity layout: the fused engine's
    gates (small or past 64 axes), or ``PPTORCH_GM_SEGBREAK=0``."""
    return bool(
        m == 0 or eps is None or m < 4 * block or k > 64
        or os.environ.get("PPTORCH_GM_SEGBREAK", "1") == "0"
    )


def _segment_plan_from_d2(d2, m, block, eps):
    """The break plan of a range from its consecutive-row squared jumps
    ``d2``: a break where a jump passes (4 eps)^2, at most one per tile
    (the largest win), each segment padded to whole tiles.  Returns
    ``(brk_pos, tgt0, src0, plen)``, small arrays from which any span's
    slab slots rebuild (:func:`_plan_targets`), and the padded length."""
    thr = np.float32(16.0) * np.float32(eps) ** 2
    bt = max(1, m // block)
    brk = d2 > thr
    if int(brk.sum()) > bt:
        kth = np.partition(d2, -bt)[-bt]
        brk = d2 > max(thr, kth)
    seg = np.concatenate([[0], np.cumsum(brk)]).astype(np.int64)
    seg_len = np.bincount(seg)
    padded = -(-seg_len // block) * block
    tgt0 = np.cumsum(padded) - padded
    src0 = np.cumsum(seg_len) - seg_len
    return np.flatnonzero(brk), tgt0, src0, int(padded.sum())


def _plan_targets(plan, off, ln):
    """Slab slots of rows ``[off, off + ln)`` of a range under its break
    plan (identity when ``plan`` is None): a break at jump p separates
    rows p and p + 1, so a row's segment is the count of breaks before
    it."""
    idx = np.arange(off, off + ln, dtype=np.int64)
    if plan is None:
        return idx
    brk_pos, tgt0, src0 = plan
    seg = np.searchsorted(brk_pos, idx, side="left")
    return tgt0[seg] + idx - src0[seg]


def _segment_layout_from_d2(d2, m, block, eps):
    """``(target, padded_len)`` from precomputed jumps."""
    if m == 0:
        return np.empty(0, np.int64), 0
    brk_pos, tgt0, src0, plen = _segment_plan_from_d2(d2, m, block, eps)
    return _plan_targets((brk_pos, tgt0, src0), 0, m), plen


def _gm_segment_layout(rows, block, eps):
    """``(target, padded_len)``: the slab slot of each of a range's
    sorted ``rows`` and the block-multiple capacity it needs (the
    in-RAM form of :func:`_stream_range_plan`)."""
    m, k = rows.shape
    if _segbreak_skip(m, k, block, eps):
        return np.arange(m, dtype=np.int64), round_up(m, block)
    d2 = np.sum((rows[1:] - rows[:-1]) ** 2, axis=1)
    return _segment_layout_from_d2(d2, m, block, eps)


def _stream_range_plan(split, s, block, eps):
    """Range ``s``'s break plan and extent box, read piece by piece from
    the spill: the jumps ``d2`` (elementwise, so the in-RAM diff's bits)
    and the extrema.  Returns ``(plan, plen, lo, hi)``, ``plan`` None
    for the identity layout."""
    a, b = int(split.starts[s]), int(split.starts[s + 1])
    m, k = b - a, split.k
    lo = np.full(k, np.float32(np.inf), np.float32)
    hi = np.full(k, np.float32(-np.inf), np.float32)
    skip = _segbreak_skip(m, k, block, eps)
    if m == 0:
        return None, 0, lo, hi
    d2 = None if skip else np.empty(max(m - 1, 0), np.float32)
    prev = None
    for off, _ids, rows in split.iter_range_rows(s):
        np.minimum(lo, rows.min(axis=0), out=lo)
        np.maximum(hi, rows.max(axis=0), out=hi)
        if d2 is not None:
            if prev is not None and off > 0:
                d2[off - 1] = np.sum((rows[0] - prev) ** 2)
            if len(rows) > 1:
                diff = rows[1:] - rows[:-1]
                d2[off:off + len(rows) - 1] = np.sum(diff * diff, axis=1)
            prev = rows[-1].copy()
    if skip:
        return None, round_up(m, block), lo, hi
    brk_pos, tgt0, src0, plen = _segment_plan_from_d2(d2, m, block, eps)
    return (brk_pos, tgt0, src0), plen, lo, hi


# ---------------------------------------------------------------------------
# the boundary cover
# ---------------------------------------------------------------------------


def _chain_boundary_tiles(split, starts, block, eps, n, n_ranges):
    """Each range's boundary cover from the streamed global tile boxes:
    tile t covers range s iff its box lies within eps of some tile box of
    s (outside s).  Every cross-range eps-pair lies in a tile pair whose
    boxes are within eps, so the cover is exact; a union-box prefilter
    cuts the exact test to the candidate frontier.  Returns
    ``(tile_sel, boundary_rows)``."""
    tlo, thi = split.tile_lo, split.tile_hi
    _nt, k = tlo.shape
    eps2 = np.float32(eps) ** 2
    tile_sel, brows = [], []
    for s in range(n_ranges):
        a, b = int(starts[s]), int(starts[s + 1])
        if b <= a:
            tile_sel.append(np.empty(0, np.int64))
            brows.append(0)
            continue
        ts, te = a // block, -(-b // block)
        ulo = tlo[ts:te].min(axis=0)
        uhi = thi[ts:te].max(axis=0)
        gap_u = np.maximum(0.0, np.maximum(ulo[None] - thi, tlo - uhi[None]))
        cand = np.flatnonzero(np.sum(gap_u * gap_u, axis=1) <= eps2)
        cand = cand[(cand < ts) | (cand >= te)]
        if len(cand):
            keep = np.zeros(len(cand), bool)
            rlo, rhi = tlo[ts:te], thi[ts:te]
            # ~8M elements of gap at a time, as _weights_from_boxes.
            step = max(1, (1 << 23) // max((te - ts) * k, 1))
            for c0 in range(0, len(cand), step):
                c1 = min(c0 + step, len(cand))
                g = np.maximum(
                    0.0,
                    np.maximum(rlo[None] - thi[cand[c0:c1], None],
                               tlo[cand[c0:c1], None] - rhi[None]),
                )
                keep[c0:c1] = (np.sum(g * g, axis=-1) <= eps2).any(axis=1)
            cand = cand[keep]
        tile_sel.append(cand)
        brows.append(int(sum(min((int(t) + 1) * block, n) - int(t) * block
                             for t in cand)))
    return tile_sel, brows


def _chain_fill_boundary(split, tiles, bcap, block, n, k):
    """``(k, bcap)`` boundary slab of one range, with its mask and gids
    (``n`` in empty slots): each selected tile in its own block-aligned
    slot (the boxes stay the senders' tiles), contiguous tile runs read
    from the spill at once.  The JAX ``(bcap, k)`` rows, transposed."""
    bp = np.zeros((k, bcap), np.float32)
    bm = np.zeros(bcap, bool)
    bg = np.full(bcap, n, np.int32)
    if len(tiles) == 0:
        return bp, bm, bg
    run_starts = np.flatnonzero(np.concatenate([[True], np.diff(tiles) > 1]))
    run_ends = np.append(run_starts[1:], len(tiles))
    slot = 0
    for r0, r1 in zip(run_starts, run_ends):
        t0, t1 = int(tiles[r0]), int(tiles[r1 - 1]) + 1
        ids_r, rows_r = split.row_span(t0 * block, min(t1 * block, n))
        for j in range(t1 - t0):
            p0 = j * block
            p1 = min(p0 + block, len(ids_r))
            dst = slot * block
            bp[:, dst:dst + (p1 - p0)] = rows_r[p0:p1].T
            bm[dst:dst + (p1 - p0)] = True
            bg[dst:dst + (p1 - p0)] = ids_r[p0:p1]
            slot += 1
    return bp, bm, bg


def _range_slab(split, s, plan, tiles, cap, bcap, block, n):
    """Range ``s``'s ``(k, cap + bcap)`` slab, its mask and the gids of
    its owned and boundary slots, rebuilt from the spill: the range's
    rows at their break-plan slots from row 0, empty rows up to ``cap``,
    then the boundary cover (:func:`_chain_fill_boundary`)."""
    k = split.k
    pts = np.zeros((k, cap + bcap), np.float32)
    msk = np.zeros(cap + bcap, bool)
    og = np.full(cap, n, np.int32)
    for off, ids, rows in split.iter_range_rows(s):
        tgt = _plan_targets(plan, off, len(ids))
        pts[:, tgt] = rows.T
        msk[tgt] = True
        og[tgt] = ids
    bp, bm, bg = _chain_fill_boundary(split, tiles, bcap, block, n, k)
    pts[:, cap:] = bp
    msk[cap:] = bm
    return pts, msk, og, bg


def _restored_gids(split, plans, s, cap, n):
    """A restored range's owned gids, replayed from the spill (its order
    is deterministic, so they are the killed run's)."""
    og = np.full(cap, n, np.int32)
    for off, ids, _rows in split.iter_range_rows(s):
        og[_plan_targets(plans[s], off, len(ids))] = ids
    return og


def _restored_bgids(split, tiles, bcap, block, n):
    """A restored range's boundary gids."""
    return _chain_fill_boundary(split, tiles, bcap, block, n, split.k)[2]


# ---------------------------------------------------------------------------
# the two chained passes
# ---------------------------------------------------------------------------


def _stats_row(ex, passes, band):
    """A pass's (5,) stats row, the JAX package's: the live pairs the
    pass's lists keep (the full list less its (boundary, boundary) tile
    pairs), the budget, the kernel passes and the band stats."""
    return torch.tensor(
        [ex["total"] - ex["hh_pairs"], ex["budget"], passes,
         int(band[0]), int(band[1])], dtype=torch.int64)


def _gm_chain_counts(pts, msk, *, owned, eps, min_samples, block, precision,
                     backend, pair_budget, metric="euclidean"):
    """One range's owner-computes counts pass: owned rows count against
    owned and boundary columns.  Returns ``(own_core (owned,) or None,
    stats row, (total, budget))``, the last the full list's: ``None``
    and 0 passes where it passed its budget (no kernel ran)."""
    ex = oc_extract(pts, eps, msk, owned=owned, block=block,
                    precision=precision, backend=backend,
                    pair_budget=pair_budget, metric=metric)
    if ex["total"] > ex["budget"]:
        return None, _stats_row(ex, 0, (0, 0)), (ex["total"], ex["budget"])
    core, band = oc_counts_banded(ex, min_samples)
    return core, _stats_row(ex, 1, band), (ex["total"], ex["budget"])


def _gm_chain_propagate(pts, msk, core_all, gid, *, owned, eps, block,
                        precision, backend, pair_budget, metric="euclidean"):
    """One range's relay propagation with host-supplied core flags.
    Returns ``(glabel (rows,), stats row)``: global root-gid labels over
    the owned and boundary slots (the occurrence tables' wire format);
    the stats row carries ``1 + passes``, as the JAX row does.  Raises
    on an overflow, which pass A would have met first."""
    ex = oc_extract(pts, eps, msk, owned=owned, block=block,
                    precision=precision, backend=backend,
                    pair_budget=pair_budget, metric=metric)
    if ex["total"] > ex["budget"]:
        raise RuntimeError("the propagation's pair list passed its budget "
                           "after the counts pass's fitted")
    labels, passes, band = oc_propagate_banded(ex, core_all)
    glabel = torch.where(labels >= 0, gid[labels.clamp_min(0).long()], -1)
    return glabel.to(torch.int32), _stats_row(ex, 1 + passes, band)


# ---------------------------------------------------------------------------
# the chained route
# ---------------------------------------------------------------------------


def _gm_chained_dbscan(points, eps, min_samples, *, block, precision,
                       backend, pair_budget, merge_rounds, n_ranges, device,
                       jobstate=None, metric="euclidean"):
    """Chained single-card global-Morton clustering of a streamed
    dataset: its Morton ranges visit the card one at a time (see the
    module's docstring).  Returns ``(labels, core, stats)``.

    Each range's pass runs under a
    :class:`~pypardis_tpu_torch.utils.retry.Retrier` with the
    ``gm.chained_range`` fault site inside it (a retry re-dispatches from
    the slab already on the card); ``gm.execute`` fires once per ladder
    attempt.  With ``jobstate`` each range's propagation tables are noted
    at the cadence, keyed by the attempt's pair budget, and a resumed fit
    restores them: a restored range is neither built nor dispatched in
    either pass (``jobstate_restore`` event, ``route="gm_chained"``).
    A kernel failure raises."""
    n, k = points.shape
    n1 = n + 1
    dev = torch.device(device)
    stage = {}
    t_wall = time.perf_counter()
    split = morton_range_split_streaming(points, n_ranges, eps=eps,
                                         block=block)
    stage["split"] = time.perf_counter() - t_wall
    try:
        with obs_span("gm.build", chained=True, ranges=n_ranges):
            plans, plens, sizes = [], [], []
            for s in range(n_ranges):
                plan, plen, _lo, _hi = _stream_range_plan(split, s, block,
                                                          eps)
                plans.append(plan)
                plens.append(plen)
                sizes.append(int(split.starts[s + 1] - split.starts[s]))
            cap = round_up(max(plens + [1]), block)
        t_build = time.perf_counter() - t_wall

        t0 = time.perf_counter()
        with obs_span("gm.exchange", chained=True):
            tile_sel, brows = _chain_boundary_tiles(
                split, split.starts, block, eps, n, n_ranges)
            btiles = max((len(c) for c in tile_sel), default=0)
            bcap = round_up(max(btiles, 1) * block, block)
        t_exchange = time.perf_counter() - t0

        mode = check_precision(precision)
        hint_key = (
            "gm_chain", dispatch_tag((cap + bcap) // block),
            (n_ranges, cap, k), bcap, block, mode, float(eps), metric,
        )
        t_exec_cell = [0.0]
        spans = _Spans(dev)
        passes = []

        def slab(s):
            t = time.perf_counter()
            pts, msk, og, bg = _range_slab(split, s, plans[s], tile_sel[s],
                                           cap, bcap, block, n)
            out = (torch.from_numpy(pts).to(dev),
                   torch.from_numpy(msk).to(dev), og, bg)
            stage["slab_build"] = stage.get("slab_build", 0.0) + (
                time.perf_counter() - t)
            return out

        def run_step(pb, _mr):
            t_exec = time.perf_counter()
            faults.maybe_fail("gm.execute")
            # Snapshots key by the attempt's pair budget: tables computed
            # under a budget that overflowed are never replayed.
            budget_tag = int(pb or 0)
            restored = (jobstate.chained_restore(budget_tag)
                        if jobstate is not None else {})
            if restored:
                obs_event("jobstate_restore", route="gm_chained",
                          partitions=len(restored))
            core_full = np.zeros(n1, bool)
            rows_ps, lists = [], []
            ran = {}
            t_loop = time.perf_counter()
            with obs_span("gm.execute", merge="host", chained=True):
                # Pass A: exact owner core verdicts, range by range.  No
                # slab is kept between the passes: pass B rebuilds each
                # from the spill.
                for s in range(n_ranges):
                    if s in restored:
                        _glab, core_r, _ps = restored[s]
                        og = _restored_gids(split, plans, s, cap, n)
                        sel = og < n
                        core_full[og[sel]] = core_r[:cap][sel]
                        continue
                    pts, msk, og, _bg = slab(s)

                    def one_counts(pts=pts, msk=msk):
                        faults.maybe_fail("gm.chained_range")
                        return spans.run(lambda: _gm_chain_counts(
                            pts, msk, owned=cap, eps=float(eps),
                            min_samples=int(min_samples), block=block,
                            precision=mode, backend=backend,
                            pair_budget=pb, metric=metric))

                    core, ps, tb = Retrier("gm.chained_range").run(
                        one_counts)
                    rows_ps.append(ps)
                    lists.append(tb)
                    ran[s] = int(core is not None)
                    if core is not None:
                        sel = og < n
                        core_full[og[sel]] = core.cpu().numpy()[sel]
                    del pts, msk, core
                    obs_heartbeat("gm.chained_counts", s + 1, n_ranges,
                                  t_loop)
                # Every range's list has the same budget (one slab
                # shape); the largest total binds.
                need = (max((t for t, _b in lists), default=0),
                        min((b for _t, b in lists), default=0))
                if need[0] > need[1]:
                    # A truncated list: no propagation; the ladder reruns
                    # every range at the largest total.
                    passes.extend(ran.values())
                    t_exec_cell[0] = time.perf_counter() - t_exec
                    return None, need, True
                # Pass B: relay propagation with the global core flags.
                home_label = np.full(n, -1, np.int32)
                halo_gids, halo_labs = [], []
                t_loop2 = time.perf_counter()
                for s in range(n_ranges):
                    if s in restored:
                        glab_r, _core_r, ps_r = restored[s]
                        og = _restored_gids(split, plans, s, cap, n)
                        bg = _restored_bgids(split, tile_sel[s], bcap, block,
                                             n)
                        rows_ps.append(torch.from_numpy(
                            np.asarray(ps_r, np.int64)))
                    else:
                        pts, msk, og, bg = slab(s)
                        gid_full = np.concatenate([og, bg])
                        core_all = torch.from_numpy(
                            core_full[np.clip(gid_full, 0, n)]
                            & (gid_full < n)).to(dev)
                        gid_t = torch.from_numpy(gid_full).to(dev)

                        def one_prop(pts=pts, msk=msk, core_all=core_all,
                                     gid_t=gid_t):
                            faults.maybe_fail("gm.chained_range")
                            return spans.run(lambda: _gm_chain_propagate(
                                pts, msk, core_all, gid_t, owned=cap,
                                eps=float(eps), block=block, precision=mode,
                                backend=backend, pair_budget=pb,
                                metric=metric))

                        glab, ps = Retrier("gm.chained_range").run(one_prop)
                        glab_r = glab.cpu().numpy()
                        rows_ps.append(ps)
                        passes.append(ran[s] + int(ps[2]) - 1)
                        del pts, msk, core_all, gid_t, glab
                        if jobstate is not None and jobstate.due():
                            jobstate.chained_note(
                                s, glab_r,
                                core_full[np.clip(og, 0, n)] & (og < n),
                                ps.numpy(), budget_tag)
                    sel = og < n
                    home_label[og[sel]] = glab_r[:cap][sel]
                    hsel = bg < n
                    halo_gids.append(bg[hsel])
                    halo_labs.append(glab_r[cap:][hsel])
                    obs_heartbeat("gm.chained_propagate", s + 1, n_ranges,
                                  t_loop2)
            t_exec_cell[0] = time.perf_counter() - t_exec
            # One row per range and pass (a restored range: its pass-B
            # row), the JAX stats rows: each column's maximum binds.
            pstats = torch.stack(rows_ps)
            out = (home_label, core_full[:n], np.concatenate(halo_gids),
                   np.concatenate(halo_labs))
            return (out, pstats), need, True

        (home_label, core, halo_gid, halo_lab), pstats = run_ladders(
            run_step, hint_key, pair_budget, merge_rounds)
        stage["device"] = spans.seconds()
        t0 = time.perf_counter()
        with obs_span("gm.merge_host", chained=True):
            labels, _mapping = merge_occurrences(home_label, core, halo_gid,
                                                 halo_lab)
        t_merge = time.perf_counter() - t0

        boundary_rows = int(sum(brows))
        boundary_tiles = int(sum(len(c) for c in tile_sel))
        tile_bytes = boundary_tiles * block * k * 4
        stats = {
            "owned_cap": cap,
            "n_shard_partitions": n_ranges,
            "pad_waste": float(n_ranges * cap) / max(n, 1) - 1.0,
            "partition_sizes": sizes,
            "input": "stream",
            **split.stats,
            "mode": "global_morton",
            "halo_exchange": "chained_tiles",
            "chained": True,
            "ring_rounds": 0,
            "fixpoint_rounds": 0,
            "merge": "host",
            "boundary_tiles": boundary_tiles,
            "boundary_rows": boundary_rows,
            "sent_tiles": boundary_tiles,
            "boundary_tile_bytes": tile_bytes,
            # The host's tile selection is already box-exact and nothing
            # rides a ring: the box twins are the actuals.
            "sent_tiles_box": boundary_tiles,
            "boundary_bytes_box": tile_bytes,
            "boundary_tile_caps": [int(btiles), int(btiles)],
            "exchange_tile": int(block),
            "halo_factor": float(boundary_rows) / max(n, 1),
            "halo_bytes": tile_bytes,
            "halo_cap": int(bcap),
            "parity": {"starts": [int(x) for x in split.starts],
                       "box_lo": [], "box_hi": []},
            "gm_build_s": round(t_build, 6),
            "gm_exchange_s": round(t_exchange, 6),
            "gm_execute_s": round(t_exec_cell[0], 6),
            "gm_merge_s": round(t_merge, 6),
            "exchange_overlap_efficiency": 0.0,
        }
        _exec_stats(stats, oc_on=True, pstats=pstats, block=block, k=k,
                    precision=mode, n=n, metric=metric)
        stats["duplicated_work_factor"] = 1.0
        # The staging cache's counters: this route caches nothing (its
        # ranges visit the card once), as in the JAX package.
        reused, shipped = staging.fit_stats()
        stats["staged_bytes_reused"] = int(reused)
        stats["staged_bytes"] = int(shipped)
        stats["stage_s"] = stage
        stats["partition_passes"] = passes
        return _canonicalize_roots(labels, core), core, stats
    finally:
        split.close()




# ---------------------------------------------------------------------------
# the mesh engine: shard builds
# ---------------------------------------------------------------------------

GM_OWNED, GM_BOUNDARY = "gm_owned", "gm_boundary"


def _mesh_devices(mesh):
    return [mesh.device(s) for s in range(mesh.size)]


def _gm_cache_key(points, n_shards, block, devices):
    """The staging key of a fit's owned shards (the JAX ``_gm_cache_key``):
    the input's content, the shard count, the block and the devices, NOT
    eps, so an eps change reuses the owned slabs (only the boundary
    tiles depend on eps).  Their layout (the range cuts and segment
    breaks) is the first fit's eps's; any contiguous split and any break
    placement give the same labels.  The shard count tells a 4-shard from
    an 8-shard layout on a mesh that repeats one card, whose devices all
    read ``cuda:0``."""
    return (
        "gm",
        staging.points_fingerprint(points),
        int(n_shards),
        int(block),
        tuple(str(d) for d in devices),
    )


def _flat(lists):
    """Per-shard lists ``(a, b, c)`` as one flat tuple for the cache."""
    return tuple(t for lst in lists for t in lst)


def _unflat(flat, parts: int = 3):
    """The cache's flat tuple back as ``parts`` per-shard lists."""
    p = len(flat) // parts
    return tuple(list(flat[i * p:(i + 1) * p]) for i in range(parts))


def build_morton_shards(points, n_shards, block, mesh, eps=None):
    """``(owned, mask, gid)`` over the global Morton ranges, one ``(k,
    cap)``, ``(cap,)``, ``(cap,)`` tensor per shard on its device (the
    JAX ``build_morton_shards``; its ``(P, cap, k)`` rows transposed).

    Each shard's rows keep the global Morton order, with the fused
    layout's segment breaks (:func:`_gm_segment_layout`); the ranges are
    work-balanced when ``eps`` is given (:func:`~..partition.
    morton_range_split`).  Cached on the ``gm_owned`` route under
    :func:`_gm_cache_key`.  Returns ``(arrays, aux, host_bufs, base)``:
    ``aux`` the layout stats with the ``parity`` extras (order, starts,
    per-shard boxes), ``host_bufs`` the pooled buffers to give back."""
    from ..partition import morton_range_split
    from .sharded import _recentre_rows, _staged_alloc

    points = np.asarray(points)
    n, k = points.shape
    devices = _mesh_devices(mesh)
    base = _gm_cache_key(points, n_shards, block, devices)
    cached = staging.device_get(GM_OWNED, base)
    if cached is not None:
        return _unflat(cached[0]), cached[1], [], base
    order, starts, center = morton_range_split(points, n_shards, eps=eps,
                                               block=block)
    shard_rows = []
    for s in range(n_shards):
        idx = order[int(starts[s]):int(starts[s + 1])]
        rows = _recentre_rows(points, idx, center)
        target, plen = _gm_segment_layout(rows, block, eps)
        shard_rows.append((idx, rows, target, plen))
    cap = round_up(max([p for *_, p in shard_rows] + [1]), block)
    bufs: list = []
    alloc = _staged_alloc(bufs)
    owned = alloc((n_shards, k, cap), np.float32, 0)
    msk = alloc((n_shards, cap), bool, False)
    gid = alloc((n_shards, cap), np.int32, n)
    lo = np.full((n_shards, k), np.inf)
    hi = np.full((n_shards, k), -np.inf)
    sizes = []
    for s, (idx, rows, target, _plen) in enumerate(shard_rows):
        sizes.append(int(len(idx)))
        if len(idx):
            owned[s][:, target] = rows.T
            msk[s, target] = True
            gid[s, target] = idx
            lo[s] = rows.min(axis=0) + center
            hi[s] = rows.max(axis=0) + center
    aux = {
        "owned_cap": cap,
        "n_shard_partitions": n_shards,
        "pad_waste": float(n_shards * cap) / max(n, 1) - 1.0,
        "partition_sizes": sizes,
        "parity": {
            "order": order,
            "starts": [int(x) for x in starts],
            "box_lo": lo.tolist(),
            "box_hi": hi.tolist(),
        },
    }
    arrays = staging.transfer(lambda: tuple(
        [torch.from_numpy(a[s]).to(devices[s]) for s in range(n_shards)]
        for a in (owned, msk, gid)))
    staging.device_put_cached(GM_OWNED, base, _flat(arrays), aux=aux)
    return arrays, aux, bufs, base


def build_morton_shards_streaming(points, n_shards, block, mesh, eps=None):
    """The out-of-core twin of :func:`build_morton_shards` (the JAX
    ``build_morton_shards_streaming``): ``points`` is any row-sliceable
    array, typically a disk-backed ``np.memmap``.  The global Morton
    order comes from the external sample-sort (:func:`~..partition.
    morton_range_split_streaming`: the in-RAM order, starts and centre),
    and each shard's slab is assembled on its device from the spill's
    pieces (a zeroed slab, the pieces scattered in at their break-plan
    slots, the mask from the gids), so the host never holds a slab.  The
    layout is the in-RAM build's byte for byte.  Returns its contract;
    ``aux["parity"]`` has the starts and boxes but no order (the O(N)
    permutation is what this build avoids)."""
    from ..partition import morton_range_split_streaming

    n, k = points.shape
    devices = _mesh_devices(mesh)
    base = _gm_cache_key(points, n_shards, block, devices)
    cached = staging.device_get(GM_OWNED, base)
    if cached is not None:
        return _unflat(cached[0]), cached[1], [], base
    split = morton_range_split_streaming(points, n_shards, eps=eps,
                                         block=block)
    try:
        plans, plens, sizes = [], [], []
        lo = np.full((n_shards, k), np.inf)
        hi = np.full((n_shards, k), -np.inf)
        for s in range(n_shards):
            plan, plen, rlo, rhi = _stream_range_plan(split, s, block, eps)
            plans.append(plan)
            plens.append(plen)
            m = int(split.starts[s + 1] - split.starts[s])
            sizes.append(m)
            if m:
                lo[s] = rlo + split.center
                hi[s] = rhi + split.center
        cap = round_up(max(plens + [1]), block)
        # One controller drives every shard, so it assembles them all (the
        # process layer's controllers assemble their own devices' only).
        owned, msk, gid = [], [], []
        for s in range(n_shards):
            dev = devices[s]
            ow = torch.zeros((k, cap), dtype=torch.float32, device=dev)
            gd = torch.full((cap,), n, dtype=torch.int32, device=dev)
            for off, ids, rows in split.iter_range_rows(s, chunk=1 << 19):
                tgt = _plan_targets(plans[s], off, len(ids))

                def put(ow=ow, gd=gd, tgt=tgt, rows=rows, ids=ids):
                    t = torch.from_numpy(tgt).to(dev)
                    ow[:, t] = torch.from_numpy(np.ascontiguousarray(
                        rows.T)).to(dev)
                    gd[t] = torch.from_numpy(ids).to(dev)

                staging.transfer(put)
            owned.append(ow)
            msk.append(gd != n)
            gid.append(gd)
        aux = {
            "owned_cap": cap,
            "n_shard_partitions": n_shards,
            "pad_waste": float(n_shards * cap) / max(n, 1) - 1.0,
            "partition_sizes": sizes,
            "input": "stream",
            **split.stats,
            "parity": {
                "starts": [int(x) for x in split.starts],
                "box_lo": lo.tolist(),
                "box_hi": hi.tolist(),
            },
        }
    finally:
        split.close()
    arrays = (owned, msk, gid)
    staging.device_put_cached(GM_OWNED, base, _flat(arrays), aux=aux)
    return arrays, aux, [], base


# ---------------------------------------------------------------------------
# the mesh engine: the boundary-tile exchange
# ---------------------------------------------------------------------------


def _gm_plan_step(owned, mask, eps, *, gtile, mesh):
    """The exchange's exact capacity plan from tile boxes alone (the JAX
    ``_gm_plan_step``): per shard the tiles it must SEND (its tiles
    within eps of another shard's) and RECEIVE (other shards' tiles
    within eps of its own).  Sizing the buffers from it makes the
    ``btcap`` ladder a backstop.  Returns ``(n_send, n_recv)``, (P,)
    int numpy arrays."""
    from ..ops.distances import cross_tile_live
    from .halo import remote_boxes, shard_tiles

    P = mesh.size
    boxes = [shard_tiles(owned[s], mask[s], gtile)[2:] for s in range(P)]
    los = [b[0] for b in boxes]
    his = [b[1] for b in boxes]
    n_send, n_recv = np.zeros(P, np.int64), np.zeros(P, np.int64)
    for s in range(P):
        rem_lo, rem_hi = remote_boxes(los, his, s, mesh.device(s))
        n_send[s] = int(cross_tile_live(los[s], his[s], rem_lo, rem_hi,
                                        eps).sum())
        n_recv[s] = int(cross_tile_live(rem_lo, rem_hi, los[s], his[s],
                                        eps).sum())
    return n_send, n_recv


def _gm_select_step(owned, mask, gid, eps, *, gtile, btcap, bcap, mesh,
                    sketch=0):
    """The send-side selection (:func:`~.halo.boundary_send_select`) and
    each shard's empty receive buffer (the JAX ``_gm_select_step``).
    Returns per shard the ten selection outputs followed by ``(r_pts
    (bcap, k, gtile), r_msk, r_gid, r_val (bcap,), r_ovf)``."""
    from .halo import EMPTY_GID, boundary_send_select

    sel = boundary_send_select(owned, mask, gid, eps, gtile=gtile,
                               btcap=btcap, mesh=mesh, sketch=sketch)
    out = []
    for s, sl in enumerate(sel):
        dev = mesh.device(s)
        k = owned[s].shape[0]
        out.append(sl + (
            torch.zeros((bcap, k, gtile), dtype=owned[s].dtype, device=dev),
            torch.zeros((bcap, gtile), dtype=torch.bool, device=dev),
            torch.full((bcap, gtile), EMPTY_GID, dtype=torch.int32,
                       device=dev),
            torch.zeros(bcap, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        ))
    return out


def _flatten_gap_d2(pts_kr, lo, hi, chunk_elems: int = 1 << 24):
    """Each row's least squared box gap to the tiles ``lo``/``hi`` (nt, k):
    ``pts_kr`` is ``(k, rows)``.  The gap is summed over the axes in
    index order, one float32 add at a time; tiles go in chunks so the
    ``(chunk, rows)`` temporaries stay at ``chunk_elems`` elements (the
    JAX ``scan`` over the tiles)."""
    k, rows = pts_kr.shape
    acc = torch.full((rows,), 3e38, dtype=torch.float32,
                     device=pts_kr.device)
    step = max(1, chunk_elems // max(rows, 1))
    for t0 in range(0, lo.shape[0], step):
        lo_c, hi_c = lo[t0:t0 + step], hi[t0:t0 + step]
        d2 = None
        for a in range(k):
            x = pts_kr[a][None, :]
            g = torch.clamp_min(torch.maximum(lo_c[:, a:a + 1] - x,
                                              x - hi_c[:, a:a + 1]), 0.0)
            d2 = g * g if d2 is None else d2 + g * g
        acc = torch.minimum(acc, d2.amin(dim=0))
    return acc


def _gm_flatten_step(recvs, my_lo, my_hi, eps, *, mesh):
    """Row-granular retention of the tile-granular transport (the JAX
    ``_gm_flatten_step``), per shard: a received row stays valid iff its
    squared box gap to SOME of the shard's tiles is <= eps^2 (exact: an
    eps-neighbour of a point lies within eps of the point's tile box).
    Rows are not repacked across tiles, so each kept tile keeps its
    sender's tight box; tiles are ordered by their least surviving gid
    (stable), empty ones last.  Returns per shard ``(bnd (k, rows), bmsk
    (rows,), bgid (rows,), tiles, kept_rows, kept_tiles)``, the last
    three 0-d tensors."""
    from .halo import EMPTY_GID

    e2 = float(np.float32(eps) * np.float32(eps))
    out = []
    for s in range(mesh.size):
        p, m, g, v, _ovf = recvs[s]
        bcap, k, blk = p.shape
        rows = bcap * blk
        pts_kr = p.permute(1, 0, 2).reshape(k, rows)
        msk = (m & v[:, None]).reshape(rows)
        d2 = _flatten_gap_d2(pts_kr, my_lo[s], my_hi[s])
        keep = (msk & (d2 <= e2)).reshape(bcap, blk)
        gidq = torch.where(keep, g, EMPTY_GID).to(torch.int32)
        tile_key = gidq.amin(dim=1)
        order = torch.argsort(tile_key, stable=True)
        out.append((
            p[order].permute(1, 0, 2).reshape(k, rows),
            keep[order].reshape(rows),
            gidq[order].reshape(rows),
            v.sum().to(torch.int32),
            keep.sum().to(torch.int32),
            (tile_key < EMPTY_GID).sum().to(torch.int32),
        ))
    return out


def _gm_exchange(arrays, eps, *, mesh, gtile, bt, bc, round_hook=None,
                 sketch=0):
    """The boundary-tile exchange (the JAX ``_gm_exchange``): the
    selection, ``P - 1`` ring rounds, each its own span under the retry
    layer (the ``gm.ring_round`` site; a round is pure in its inputs, so
    a retry recomputes the same round; each round's overflow read is its
    sync), then the flatten.  The boundary slabs are cut to the mesh's
    most kept tiles.  Returns ``((bnd, bmsk, bgid) per-shard lists,
    xstats, send_need, recv_overflow)``: ``send_need`` the exact most
    boundary tiles of a shard, ``recv_overflow`` the most accepted tiles
    a receive buffer dropped.  ``round_hook`` runs after every round;
    ``xstats["ring_wall_s"]`` is the ring loop's wall."""
    from .dist import fetch_np
    from .halo import ring_tile_round

    owned, omsk, ogid = arrays
    n_dev = mesh.size
    k = owned[0].shape[0]
    with obs_span("gm.exchange", ring_rounds=max(n_dev - 1, 0), btcap=bt,
                  bcap=bc) as sp:
        sel = _gm_select_step(owned, omsk, ogid, eps, gtile=gtile, btcap=bt,
                              bcap=bc, mesh=mesh, sketch=sketch)
        bufs = [o[:5] for o in sel]
        recvs = [o[10:] for o in sel]
        my_lo = [o[7] for o in sel]
        my_hi = [o[8] for o in sel]
        t_ring = time.perf_counter()
        for r in range(n_dev - 1):
            with obs_span("gm.ring_round", round=r) as rs:

                def one_round(bufs=bufs, recvs=recvs):
                    faults.maybe_fail("gm.ring_round")
                    out = ring_tile_round(bufs, recvs, my_lo, my_hi, eps,
                                          mesh)
                    fetch_np([rv[4] for rv in out[1]])
                    return out

                bufs, recvs = Retrier("gm.ring_round").run(one_round)
                rs.sync_on([rv[4] for rv in recvs])
            if round_hook is not None:
                round_hook()
            obs_heartbeat("gm.ring", r + 1, n_dev - 1, t_ring)
        ring_wall = time.perf_counter() - t_ring
        flat = _gm_flatten_step(recvs, my_lo, my_hi, eps, mesh=mesh)
        n_send_np = fetch_np([o[5] for o in sel])
        recv_ovf_np = fetch_np([rv[4] for rv in recvs])
        tiles_np = fetch_np([f[3] for f in flat])
        rows_np = fetch_np([f[4] for f in flat])
        mt = max(1, int(fetch_np([f[5] for f in flat]).max()))
        gr = mt * gtile
        bnd = [f[0][:, :gr].contiguous() for f in flat]
        bmsk = [f[1][:gr].contiguous() for f in flat]
        bgid = [f[2][:gr].contiguous() for f in flat]
        sent_tiles = int(np.minimum(n_send_np, bt).sum())
        sent_tiles_box = int(np.minimum(fetch_np([o[9] for o in sel]),
                                        bt).sum())
        xstats = {
            "boundary_tiles": int(tiles_np.sum()),
            "boundary_rows": int(rows_np.sum()),
            "sent_tiles": sent_tiles,
            # The coordinate bytes one circulation of the ring carries.
            "boundary_tile_bytes": sent_tiles * gtile * k * 4,
            # Their full-d-box-only twins (equal with the sketch off).
            "sent_tiles_box": sent_tiles_box,
            "boundary_bytes_box": sent_tiles_box * gtile * k * 4,
            "boundary_tile_caps": [int(bt), int(bc)],
            "exchange_tile": int(gtile),
            "ring_wall_s": round(ring_wall, 6),
        }
        sp.set(boundary_tiles=xstats["boundary_tiles"],
               sent_tiles=sent_tiles)
        # Accumulated over the capacity ladder's attempts: every byte a
        # circulation carried.
        m = obs_current().metrics
        m.inc("gm.ring_bytes_sent",
              xstats["boundary_tile_bytes"] * max(n_dev - 1, 0))
        m.inc("gm.ring_tiles_kept", xstats["boundary_tiles"])
    send_need = int(n_send_np.max()) if n_send_np.size else 0
    recv_ovf = int(recv_ovf_np.max()) if recv_ovf_np.size else 0
    return (bnd, bmsk, bgid), xstats, send_need, recv_ovf


def _gm_boundary_tiles(arrays, eps, *, mesh, block, btcap, base,
                       round_hook=None, sketch=0):
    """The exchange behind its capacity ladder and the staging cache
    (route ``gm_boundary``, keyed by the owned key, eps and the sketch):
    a warm refit at the same eps skips the exchange.

    The ``gm.exchange`` fault site fires first.  ``btcap=None`` (and no
    ``PPTORCH_GM_BTCAP``) sizes the send and receive buffers from the
    exact plan (:func:`_gm_plan_step`) and doubles them on an overflow
    (``gm.btcap`` retries, six attempts); an explicit ``btcap`` (the
    argument or the knob) is a contract: a send overflow raises naming
    the need and the knobs, since a dropped boundary tile would be a
    wrong label."""
    faults.maybe_fail("gm.exchange")
    bkey = base + ("boundary", float(eps), int(sketch))
    cached = staging.device_get(GM_BOUNDARY, bkey)
    if cached is not None:
        return _unflat(cached[0]), cached[1]
    n_dev = mesh.size
    cap = arrays[0][0].shape[1]
    if btcap is None:
        env_btcap = os.environ.get("PPTORCH_GM_BTCAP")
        if env_btcap:
            btcap = int(env_btcap)
    # The exchange tile is the kernel block: the flatten's row mask
    # recovers what a coarse tile over-ships.
    gtile = block
    bstep = block // gtile
    nt = cap // gtile
    explicit = btcap is not None
    bc_hard = round_up(max(n_dev - 1, 1) * nt, bstep)
    if explicit:
        bt = min(max(1, int(btcap)), nt)
        bc = min(round_up(max(1, 2 * bt), bstep), bc_hard)
    else:
        n_send_pd, n_recv_pd = _gm_plan_step(arrays[0], arrays[1], eps,
                                             gtile=gtile, mesh=mesh)
        bt = min(max(1, int(n_send_pd.max())), nt)
        bc = min(round_up(max(1, int(n_recv_pd.max())), bstep), bc_hard)
    attempts = 6
    while True:
        out, xstats, send_need, recv_ovf = _gm_exchange(
            arrays, eps, mesh=mesh, gtile=gtile, bt=bt, bc=bc,
            round_hook=round_hook, sketch=sketch)
        send_ovf = max(0, send_need - bt)
        if send_ovf == 0 and recv_ovf == 0:
            break
        obs_event("halo_overflow", mode="global_morton", send=send_ovf,
                  recv=recv_ovf, btcap=bt, bcap=bc)
        if send_ovf and explicit:
            err = RuntimeError(
                f"global-Morton boundary-tile send buffer overflow: "
                f"btcap={bt} but this mesh/eps needs {send_need} tiles "
                f"per device; pass btcap>={send_need} "
                f"(global_morton_dbscan(btcap=...)) or set "
                f"PPTORCH_GM_BTCAP={send_need}, or leave btcap unset "
                f"for the auto-doubling ladder"
            )
            note_giveup("gm.btcap", err)
            raise err
        attempts -= 1
        if attempts <= 0:
            err = RuntimeError(
                f"global-Morton boundary-tile buffer overflow persisted "
                f"through 6 capacity retries (btcap={bt}, bcap={bc}); "
                f"pass a larger btcap (global_morton_dbscan(btcap=...) "
                f"or PPTORCH_GM_BTCAP)"
            )
            note_giveup("gm.btcap", err)
            raise err
        note_retry("gm.btcap", 0.0, RuntimeError(
            f"boundary-tile overflow (send={send_ovf}, recv={recv_ovf}) "
            f"at btcap={bt}, bcap={bc}"))
        if send_ovf:
            bt = min(nt, max(send_need, 2 * bt))
        if recv_ovf:
            bc = min(bc_hard, round_up(max(bc + recv_ovf, 2 * bc), bstep))
    staging.device_put_cached(GM_BOUNDARY, bkey, _flat(out), aux=xstats)
    return out, xstats


# ---------------------------------------------------------------------------
# the mesh engine: counts, clustering and the fixpoint
# ---------------------------------------------------------------------------


def _oc_kwargs(oc_kw, pair_budget):
    return dict(block=oc_kw["block"], precision=oc_kw["precision"],
                backend=oc_kw["backend"], metric=oc_kw["metric"],
                pair_budget=pair_budget)


def _gm_owned_counts_step(owned, omsk, *, oc_kw, pair_budget, mesh, spans):
    """The owned slabs' raw counts (owned rows x owned columns), run
    before the exchange (the JAX ``_gm_owned_counts_step``).  Returns
    ``(counts, stats, ran)``: per shard its ``(cap,)`` counts (None where
    its list passed the budget and no pass ran), the (P, 4) int64 rows
    ``[total, budget, band_pairs, rescored_tiles]`` and the passes run."""
    from .sharded import _on

    counts, rows, ran = [], [], 0
    for s in range(mesh.size):
        cap = owned[s].shape[1]

        def one(s=s, cap=cap):
            ex = oc_extract(owned[s], oc_kw["eps"], omsk[s], owned=cap,
                            **_oc_kwargs(oc_kw, pair_budget))
            if ex["total"] > ex["budget"]:
                return None, ex, torch.zeros(2, dtype=torch.int64)
            c, band = oc_raw_counts(ex)
            return c, ex, band

        with _on(mesh.device(s)):
            c, ex, band = spans.run(one)
        ran += int(c is not None)
        counts.append(c)
        rows.append([ex["total"], ex["budget"], int(band[0]), int(band[1])])
    return counts, np.asarray(rows, np.int64), ran


def _gm_cluster(slabs, og, *, n, cap, mesh, relay, min_samples, oc_kw,
                pair_budget, owned_counts, omsk, spans, passes):
    """The owner-computes clustering of every shard's ``owned +
    boundary`` slab (the JAX ``_gm_cluster_step``, or with ``relay=
    "host"`` its ``_oc_host_tables``): each slab's pair list; the owned
    rows' core flags (B1/B3 over owned rows and every column, or with
    ``owned_counts`` the overlapped form: those counts plus the boundary
    delta :func:`~..ops.labels.oc_counts_delta`, thresholded once); the
    owners' verdicts gathered (``relay="device"``: the ``(N+1,)``
    ``core_g`` on the mesh's first device, the JAX ``pmax``; ``"host"``:
    in numpy); the boundary slots' flags read from them; relay
    propagation (B2/B4).

    Returns ``(out, rows, (total, budget), dstats)``: ``out`` is None
    after an overflow, else ``(tables, core_g)`` with ``tables`` per
    shard ``(glab, own_core)``; ``rows`` the per-shard (5,) stats rows
    (the counts pass's band zero under the overlap); ``dstats`` the
    delta pass's (P, 4) rows under the overlap, else None."""
    from ..ops.labels import oc_counts_banded, oc_counts_delta
    from .mesh import gather
    from .sharded import (
        _on, _oc_tables_shard, _overflow_row, _replicated_core,
    )

    P = mesh.size
    exs = []
    for s, (pts, msk, _gid) in enumerate(slabs):
        with _on(mesh.device(s)):
            exs.append(spans.run(lambda pts=pts, msk=msk: oc_extract(
                pts, oc_kw["eps"], msk, owned=cap,
                **_oc_kwargs(oc_kw, pair_budget))))
    total = max(e["total"] for e in exs)
    budget = max(e["budget"] for e in exs)
    if total > budget:
        passes.extend([0] * P)
        return None, [_overflow_row([e]) for e in exs], (total, budget), None
    cores, cbands, drows = [], [], []
    for s, ex in enumerate(exs):
        with _on(mesh.device(s)):
            if owned_counts is not None:
                delta, dband = spans.run(lambda ex=ex: oc_counts_delta(ex))
                core = (torch.clamp_min(owned_counts[s] + delta, 1)
                        >= min_samples) & omsk[s]
                cband = torch.zeros(2, dtype=torch.int64)
                drows.append([ex["total"] - ex["hh_pairs"], ex["budget"],
                              int(dband[0]), int(dband[1])])
            else:
                core, cband = spans.run(
                    lambda ex=ex: oc_counts_banded(ex, min_samples))
        cores.append(core)
        cbands.append(cband)
    dev0 = mesh.device(0)
    core_g = None
    if relay == "device":
        core_g = _replicated_core(gather(cores, dev0), og.to(dev0), n + 1)
        copies = {}
    else:
        og_np = og.cpu().numpy().reshape(-1)
        core_full = np.zeros(n + 1, bool)
        sel = og_np < n
        core_full[og_np[sel]] = torch.stack(
            [c.cpu() for c in cores]).numpy().reshape(-1)[sel]
    tables, rows = [], []
    for s, ((pts, msk, gid), ex) in enumerate(zip(slabs, exs)):
        dev = mesh.device(s)
        hgid, hmsk = gid[cap:], msk[cap:]
        with _on(dev):
            if relay == "device":
                if str(dev) not in copies:
                    copies[str(dev)] = core_g.to(dev)
                halo_core = (copies[str(dev)][hgid.clamp(0, n).long()]
                             & (hgid < n) & hmsk)
            else:
                hg_np = hgid.cpu().numpy()
                halo_core = torch.from_numpy(
                    core_full[np.clip(hg_np, 0, n)] & (hg_np < n)).to(dev)
            shard_passes = []
            glabs, row = _oc_tables_shard(
                [(pts, msk, gid)], [torch.cat([cores[s], halo_core])], [ex],
                cbands[s], spans=spans, passes=shard_passes)
        passes.append(shard_passes[0])
        tables.append((glabs[0], cores[s]))
        rows.append(row)
    dstats = np.asarray(drows, np.int64) if owned_counts is not None else None
    return (tables, core_g), rows, (total, budget), dstats


def _fold_overlap_stats(rows, ostats, dstats):
    """The cluster step's (P, 5) rows with the overlapped counts passes
    folded in (the JAX ``_fold_overlap_stats``): the owned and delta
    passes' bands added, one more kernel pass, and the delta rows
    appended (their totals are the combined slab's)."""
    ps = np.stack([np.asarray(r, np.int64) for r in rows])
    if dstats is None:
        return ps
    ps[:, 3:5] += ostats[:, 2:4] + dstats[:, 2:4]
    ps[:, 2] += 1
    extra = np.zeros((dstats.shape[0], ps.shape[1]), np.int64)
    extra[:, :2] = dstats[:, :2]
    return np.vstack([ps, extra])


def _gm_fixpoint(home_label, core_g, bgid, b_glab, *, n_points,
                 merge_rounds, jobstate=None, budget_tag=0, syncs=None):
    """The host-stepped fixpoint over the ``(N+1,)`` tables on the mesh's
    first device (the JAX ``_gm_fixpoint``): each round (the JAX
    ``_gm_fixpoint_step``) is :func:`~.sharded._merge_round` over every
    shard's boundary tables, its own span (``gm.fixpoint_round``) under
    the retry layer (the ``gm.fixpoint_round`` site; a round is pure in
    ``lab_map``, so a retry recomputes it), its ``changed`` read as the
    convergence probe.
    With ``jobstate`` each round's ``lab_map`` is noted at the cadence,
    keyed by the pair budget that built the tables, and a resumed fit
    starts from it: min-label propagation is monotone toward its one
    fixpoint from any intermediate state of the same tables.  Returns
    ``(lab_map, rounds, converged)``."""
    from .sharded import _merge_round

    syncs = [0] if syncs is None else syncs
    n = int(n_points)
    n1 = n + 1
    dev = home_label.device
    h_gid = bgid.reshape(-1).long().clamp_max(n)
    h_lab = b_glab.reshape(-1)
    h_core = core_g[h_gid] & (h_gid < n)
    lab_map = torch.arange(n1, dtype=torch.int32, device=dev)
    rounds = 0
    if jobstate is not None:
        saved = jobstate.gm_restore(int(budget_tag), n1)
        if saved is not None:
            lab_map = torch.from_numpy(np.asarray(saved[0],
                                                  np.int32)).to(dev)
            rounds = min(int(saved[1]), max(merge_rounds - 1, 0))
            obs_event("jobstate_restore", route="gm_fixpoint", round=rounds)
    converged = False
    t0 = time.perf_counter()
    while rounds < merge_rounds:
        with obs_span("gm.fixpoint_round", round=rounds):

            def one_round(lab_map=lab_map):
                faults.maybe_fail("gm.fixpoint_round")
                return _merge_round(lab_map, home_label, core_g, h_gid,
                                    h_lab, h_core, syncs)

            lab_map, changed = Retrier("gm.fixpoint_round").run(one_round)
        rounds += 1
        obs_heartbeat("gm.fixpoint", rounds, merge_rounds, t0)
        if jobstate is not None and jobstate.due():
            jobstate.gm_note(lab_map.cpu().numpy(), rounds, int(budget_tag))
        if not changed:
            converged = True
            break
    return lab_map, rounds, converged


def _gm_mesh_dbscan(points, eps, min_samples, *, metric, block, mesh,
                    precision, backend, merge, pair_budget, merge_rounds,
                    btcap, stream, chain, jobstate, dev):
    """The mesh engine (the body of the JAX ``global_morton_dbscan`` on a
    mesh): see :func:`global_morton_dbscan`."""
    from ..obs.resources import memory_pressure
    from ..ops.sketch import sketch_dims
    from ..utils.budget import pair_overflow
    from ..utils.hints import PAIR_BUDGET_HINTS
    from ..utils.retry import is_degradable_error, note_degraded
    from .dist import fetch_np
    from .mesh import gather
    from .sharded import MERGE_HOST_AUTO, _host_merge_finish

    n, k = points.shape
    if merge == "auto":
        # Under host-RSS pressure the host merge is taken at once, before
        # the replicated (N+1,) arrays exist.
        merge = ("host" if n >= MERGE_HOST_AUTO or memory_pressure()
                 else "device")
    n_shards = mesh.size
    dev0 = mesh.device(0)
    mode = check_precision(precision)
    block = clamp_block(block, -(-n // max(n_shards, 1)))
    staging.begin_fit()
    stage = {}
    t0 = time.perf_counter()
    with obs_span("gm.build", stream=bool(stream)):
        builder = (build_morton_shards_streaming if stream
                   else build_morton_shards)
        arrays, bstats, host_bufs, base = builder(points, n_shards, block,
                                                  mesh, eps=eps)
    t_build = time.perf_counter() - t0
    owned, omsk, ogid = arrays
    cap = int(bstats["owned_cap"])
    # The ring's sketch tightening rides the sketch the kernels run (0
    # for cityblock, whose passes run unsketched).
    sk_gm = int(sketch_dims(k, metric))
    oc_kw = dict(eps=float(eps), block=block, precision=mode,
                 backend=backend, metric=metric)
    spans = _Spans(dev0)
    passes = []
    # The exchange/compute overlap: the owned x owned counts (most of the
    # counts pass) go before the exchange, the boundary delta after it;
    # owned + delta is the fused counts bitwise (disjoint column sets).
    # The JAX gate: the owned slab runs the kernels or the pair-list
    # dispatch, both Euclidean only; cityblock's passes count in one go.
    overlap = (os.environ.get("PPTORCH_GM_OVERLAP", "1") != "0"
               and n_shards > 1 and metric == "euclidean")
    counts_ready = [None]
    t_counts0 = 0.0
    owned_counts = ostats = None
    if overlap:
        okey = ("gm_owned", dispatch_tag(cap // block), (n_shards, cap, k),
                block, mode, float(eps), metric)
        pb_env = os.environ.get("PPTORCH_PAIR_BUDGET")
        pb_owned = (int(pb_env) if pb_env
                    else pair_budget if pair_budget is not None
                    else PAIR_BUDGET_HINTS.get(okey))
        t_counts0 = time.perf_counter()
        owned_counts, ostats, ran = _gm_owned_counts_step(
            owned, omsk, oc_kw=oc_kw, pair_budget=pb_owned, mesh=mesh,
            spans=spans)
        stage["owned_passes"] = ran
        need = pair_overflow(int(ostats[:, 0].max()),
                             int(ostats[:, 1].max()))
        if need:
            # One exact-total redispatch, and the hint seeded.
            pb_owned = int(need)
            owned_counts, ostats, ran = _gm_owned_counts_step(
                owned, omsk, oc_kw=oc_kw, pair_budget=pb_owned, mesh=mesh,
                spans=spans)
            stage["owned_passes"] += ran
            if pair_overflow(int(ostats[:, 0].max()),
                             int(ostats[:, 1].max())):
                raise RuntimeError(
                    f"global-Morton owned-counts pair budget overflow "
                    f"persisted after an exact-total retry (budget "
                    f"{pb_owned}); pass pair_budget or PPTORCH_PAIR_BUDGET")
            PAIR_BUDGET_HINTS.put(okey, pb_owned)
        # The readiness probe: an event after the counts on each card,
        # queried (never waited on) after every ring round.  On the CPU
        # the counts ran before the exchange started.
        marks = []
        if dev0.type == "cuda":
            for d in mesh.distinct():
                with torch.cuda.device(d):
                    ev = torch.cuda.Event()
                    ev.record()
                    marks.append(ev)

        def counts_hook():
            if counts_ready[0] is None and all(e.query() for e in marks):
                counts_ready[0] = time.perf_counter()

    t0 = time.perf_counter()
    (bnd, bmsk, bgid), xstats = _gm_boundary_tiles(
        arrays, eps, mesh=mesh, block=block, btcap=btcap, base=base,
        round_hook=counts_hook if overlap else None, sketch=sk_gm)
    t_exchange_raw = time.perf_counter() - t0
    xstats = dict(xstats)
    ring_wall = float(xstats.pop("ring_wall_s", 0.0) or 0.0)
    brows = int(bnd[0].shape[1])
    # The combined slab's tile must split it at the owned prefix (raises).
    gm_backend(backend, metric, cap + brows, cap, block, k, mode, dev0)
    t_hidden = overlap_eff = 0.0
    if overlap:
        t_done = (counts_ready[0] if counts_ready[0] is not None
                  else time.perf_counter())
        t_hidden = max(0.0, min(t_done - t_counts0, ring_wall,
                                t_exchange_raw))
        overlap_eff = t_hidden / ring_wall if ring_wall > 1e-9 else 0.0
    t_exchange = max(t_exchange_raw - t_hidden, 0.0)
    hint_key = ("gm", dispatch_tag((cap + brows) // block),
                (n_shards, cap, k), brows, block, mode, float(eps), metric)
    stats = {k_: bstats[k_]
             for k_ in ("owned_cap", "n_shard_partitions", "pad_waste",
                        "partition_sizes", "parity", "input",
                        "stream_buckets", "stream_max_bucket_rows",
                        "stream_sample_rows", "spill_bytes")
             if k_ in bstats}
    stats.update(xstats)
    stats.update(
        mode="global_morton",
        halo_exchange="morton_ring",
        ring_rounds=max(n_shards - 1, 0),
        halo_factor=float(xstats["boundary_rows"]) / max(n, 1),
        halo_bytes=int(xstats["boundary_tile_bytes"]),
        halo_cap=brows,
    )
    slabs = [(torch.cat([owned[s], bnd[s]], dim=1),
              torch.cat([omsk[s], bmsk[s]]),
              torch.cat([ogid[s], bgid[s]])) for s in range(n_shards)]
    og = gather(ogid, dev0)
    relay = "host" if merge == "host" else "device"
    memo = {}

    def cluster(pb):
        if memo.get("pb", -1) != pb:
            memo.update(pb=pb, out=_gm_cluster(
                slabs, og, n=n, cap=cap, mesh=mesh, relay=relay,
                min_samples=int(min_samples), oc_kw=oc_kw, pair_budget=pb,
                owned_counts=owned_counts, omsk=omsk, spans=spans,
                passes=passes))
        out, rows, need, dstats = memo["out"]
        return out, _fold_overlap_stats(rows, ostats, dstats), need

    syncs = [0]
    if merge == "host":

        def run_step(pb, _mr):
            faults.maybe_fail("gm.execute")
            out, pstats, need = cluster(pb)
            # The host union-find merge is exact: no rounds ladder.
            return (out, pstats), need, True

        t0 = time.perf_counter()
        with obs_span("gm.execute", merge="host"):
            (out, pstats) = run_ladders(run_step, hint_key, pair_budget,
                                        merge_rounds)
        t_execute = time.perf_counter() - t0
        t0 = time.perf_counter()
        with obs_span("gm.merge_host"):
            tables = out[0]
            labels, core = _host_merge_finish(
                n, og, torch.stack([g[:cap].cpu() for g, _c in tables]),
                torch.stack([c.cpu() for _g, c in tables]),
                fetch_np(bgid), torch.stack([g[cap:].cpu()
                                             for g, _c in tables]))
        t_merge = time.perf_counter() - t0
        stats.update(merge="host", fixpoint_rounds=0)
    else:
        rounds_cell, merge_s_cell = [0], [0.0]

        def run_step(pb, mr):
            faults.maybe_fail("gm.execute")
            out, pstats, need = cluster(pb)
            if out is None:
                return None, need, True
            tables, core_g = out
            n1 = n + 1
            home_label = torch.full((n1,), -1, dtype=torch.int32,
                                    device=dev0)
            home_label.scatter_reduce_(
                0, og.reshape(-1).long(),
                gather([g[:cap] for g, _c in tables], dev0).reshape(-1),
                "amax")
            home_label[n1 - 1] = -1
            t_fix = time.perf_counter()
            with obs_span("gm.fixpoint") as sp:
                lab_map, rounds, converged = _gm_fixpoint(
                    home_label, core_g, gather(bgid, dev0),
                    gather([g[cap:] for g, _c in tables], dev0),
                    n_points=n, merge_rounds=mr, jobstate=jobstate,
                    budget_tag=int(pb or 0), syncs=syncs)
                sp.set(rounds=rounds, converged=converged)
            merge_s_cell[0] = time.perf_counter() - t_fix
            rounds_cell[0] = rounds
            return ((home_label, core_g, lab_map), pstats), need, converged

        t0 = time.perf_counter()
        with obs_span("gm.execute", merge="device"):
            try:
                (home_label, core_g, lab_map), pstats = run_ladders(
                    run_step, hint_key, pair_budget, merge_rounds)
            except Exception as e:  # noqa: BLE001 — re-raised unless OOM
                if not is_degradable_error(e):
                    raise
                # The degradation rung: the device merge's replicated
                # (N+1,) arrays are this mode's largest; rerun with the
                # host union-find (byte-identical labels).
                note_degraded("merge_host", mode="global_morton",
                              error=str(e)[:160])
                if dev0.type == "cuda":
                    torch.cuda.empty_cache()
                staging.give_back_after_put(host_bufs, dev0)
                return global_morton_dbscan(
                    points, eps=eps, min_samples=min_samples, metric=metric,
                    block=block,
                    mesh=mesh, precision=precision, backend=backend,
                    merge="host", pair_budget=pair_budget,
                    merge_rounds=merge_rounds, btcap=btcap, stream=stream,
                    chain=chain, jobstate=jobstate, device=dev0)
        t_merge = merge_s_cell[0]
        t_execute = time.perf_counter() - t0 - t_merge
        final = torch.where(
            home_label >= 0, lab_map[home_label.clamp(0, n).long()], -1)
        final = torch.where(final == INT_INF, -1, final)
        labels = final[:n].cpu().numpy().astype(np.int32)
        core = core_g[:n].cpu().numpy()
        stats.update(merge="device", merge_rounds=int(rounds_cell[0]),
                     merge_converged=True,
                     fixpoint_rounds=int(rounds_cell[0]),
                     merge_host_syncs=syncs[0])
    stage["device"] = spans.seconds()
    # The four phases sum to about the wall: the ring seconds the owned
    # counts overlapped count as compute, not exchange.
    stats.update(
        gm_build_s=round(t_build, 6),
        gm_exchange_s=round(t_exchange, 6),
        gm_execute_s=round(max(t_execute, 0.0) + t_hidden, 6),
        gm_merge_s=round(t_merge, 6),
        exchange_overlap_efficiency=round(float(overlap_eff), 6),
    )
    _exec_stats(stats, oc_on=True, pstats=pstats, block=block, k=k,
                precision=mode, n=n, metric=metric)
    stats["duplicated_work_factor"] = 1.0
    stats["stage_s"] = stage
    stats["partition_passes"] = passes
    staging.give_back_after_put(host_bufs, dev0)
    return _canonicalize_roots(labels, core), core, stats


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _as_gm_mesh(mesh, dev):
    """``mesh`` as a :class:`~.mesh.Mesh` on ``dev``'s device type: None
    is every visible card (the JAX ``default_mesh()``; one CPU device on
    the CPU), an int ``P`` the first ``P`` cards (``P`` CPU shards on the
    CPU)."""
    from .mesh import Mesh, as_mesh, default_mesh

    if mesh is None or isinstance(mesh, int):
        if dev.type == "cuda":
            return default_mesh(mesh)
        return Mesh([dev] * (1 if mesh is None else int(mesh)))
    mesh = as_mesh(mesh)
    if mesh.device_type != dev.type:
        raise ValueError(
            f"the mesh's devices are {mesh.device_type} but the fit runs "
            f"on {dev.type}"
        )
    return mesh


def global_morton_dbscan(
    points,
    eps: float,
    min_samples: int,
    metric="euclidean",
    block: int = 1024,
    mesh=None,
    precision: str = "high",
    backend: str = "auto",
    merge: str = "auto",
    pair_budget: Optional[int] = None,
    merge_rounds: int = 32,
    btcap: Optional[int] = None,
    stream: Optional[bool] = None,
    chain: Optional[int] = None,
    jobstate=None,
    device=None,
):
    """Cluster ``points`` (N, k) with zero row duplication.  Returns
    ``(labels, core, stats)``: labels are global root ids (each
    cluster's least core-point index, -1 noise) in input order.

    The mesh engine (the JAX ``global_morton_dbscan`` on a mesh, or on
    one device with ``chain <= 1``): shards are contiguous ranges of the
    global Morton order, one per device of ``mesh``
    (:func:`build_morton_shards`, or :func:`build_morton_shards_streaming`
    for a memmap or ``stream=True``); only boundary TILES ride the ring
    (:func:`_gm_boundary_tiles`: the exact capacity plan, the ``btcap``
    ladder, the flatten's row filter); the owned rows count against
    owned and boundary columns, with the owned x owned bulk run before
    the exchange (``PPTORCH_GM_OVERLAP``, on by default on more than one
    shard); relay propagation gives each shard's occurrence tables; and
    the merge is the host-stepped cross-shard fixpoint
    (``merge="device"``, :func:`_gm_fixpoint`) or the host union-find
    (``"host"``; ``"auto"`` picks the host from
    :data:`~.sharded.MERGE_HOST_AUTO` points or under host-RSS
    pressure).  An OOM-class failure of the device route reruns the fit
    under the host merge (``note_degraded("merge_host")``).  Labels are
    the JAX engine's byte for byte.

    ``mesh``: a :class:`~.mesh.Mesh` (it may repeat one card), an int
    ``P`` (the first ``P`` cards; ``P`` CPU shards on the CPU) or None
    (every visible card).  On one device ``chain`` (or
    ``PPTORCH_GM_CHAIN``) > 1 runs the chained form instead
    (:func:`_gm_chained_dbscan`: ranges visit the card in turn; every
    input streams, the merge is the host union-find).  ``btcap`` caps
    each shard's send buffer in tiles of ``block`` rows (also
    ``PPTORCH_GM_BTCAP``); a too-small explicit cap raises naming the
    need.  ``block`` is clamped to the shard size, ``pair_budget`` and
    ``merge_rounds`` run the ladders of :func:`~pypardis_tpu_torch.utils.
    budget.run_ladders`.

    ``stats`` carries every key of the JAX engine's (the ``gm_*_s``
    phases, ``exchange_overlap_efficiency``, the ``boundary_*`` and
    ``sent_tiles*`` gauges, ``halo_factor``, ``halo_cap``,
    ``ring_rounds``, ``fixpoint_rounds``, ``duplicated_work_factor ==
    1.0``, the staging counters) and the port's ``stage_s`` (the passes'
    device time, ``owned_passes``: the overlapped owned-slab counts
    passes run) and ``partition_passes`` (per shard and cluster
    attempt: 1 for its counts pass, the fused one or the overlap's
    boundary delta, plus its min-label passes; 0 where its pair list
    overflowed and nothing ran).  Fault sites: ``gm.exchange``,
    ``gm.ring_round``, ``gm.execute``, ``gm.fixpoint_round`` (and
    ``gm.chained_range`` on the chained form); ``jobstate`` snapshots
    and resumes the device fixpoint.

    ``metric``: ``"euclidean"`` or ``"cityblock"`` (the L1 passes, the
    sketch and the overlap off, as in the JAX engine); cosine and
    haversine reach the engine through
    :class:`~pypardis_tpu_torch.DBSCAN`'s frames, and passed here they
    raise ``ValueError``, as the JAX normalizer does.
    ``device``: None runs on the card (and raises without CUDA);
    ``"cpu"`` runs the kernels' plain versions.  There is no fallback: a
    misaligned slab (a non-power-of-two ``block``) and a kernel failure
    raise.
    """
    from ..dbscan import resolve_device

    faults.from_env()
    validate_params(eps, min_samples)
    if merge not in ("auto", "device", "host"):
        raise ValueError(f"merge must be auto|device|host, got {merge!r}")
    metric = norm_metric(metric)
    dev = resolve_device(device)
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    # np.asarray would strip a memmap down to the array it maps.
    if not isinstance(points, np.memmap):
        points = np.asarray(points)
    n = points.shape[0]
    if stream is None:
        stream = isinstance(points, np.memmap)
    if chain is None:
        chain = int(os.environ.get("PPTORCH_GM_CHAIN") or 0)
    if _mesh_size(mesh) == 1 and int(chain) > 1:
        # btcap and merge go unread on the chained form, as in the JAX
        # package: its boundary cover is selected on the host and its
        # merge is the host union-find.
        t0 = time.perf_counter()
        staging.begin_fit()
        block_c = clamp_block(block, -(-n // int(chain)))
        labels, core, stats = _gm_chained_dbscan(
            points, eps, min_samples, block=block_c, precision=precision,
            backend=backend, pair_budget=pair_budget,
            merge_rounds=merge_rounds, n_ranges=int(chain), device=dev,
            jobstate=jobstate, metric=metric,
        )
        stats["gm_total_s"] = round(time.perf_counter() - t0, 6)
        return labels, core, stats
    return _gm_mesh_dbscan(
        points, eps, min_samples, metric=metric, block=block,
        mesh=_as_gm_mesh(mesh, dev),
        precision=precision, backend=backend, merge=merge,
        pair_budget=pair_budget, merge_rounds=merge_rounds, btcap=btcap,
        stream=stream, chain=chain, jobstate=jobstate, dev=dev)


# ---------------------------------------------------------------------------
# the sweep's graph over the Morton ranges
# ---------------------------------------------------------------------------


def sweep_graph_global_morton(points, eps, *, block: int = 1024, mesh=None,
                              metric: str = "euclidean",
                              btcap: Optional[int] = None,
                              edge_budget: Optional[int] = None,
                              pair_budget: Optional[int] = None,
                              cap_edges: Optional[int] = None, device=None):
    """ONE distance pass at ``eps`` (the sweep's eps_max) over the
    global-Morton shards: the global neighbour-pair graph (the JAX
    ``sweep_graph_global_morton``).

    The range build is the eps-free ``gm_owned`` route (a sweep after a
    fit restages nothing) and the boundary tiles ride the ring at eps_max
    (:func:`_gm_boundary_tiles`, route ``gm_boundary``, on more than one
    shard): a tile within eps_c of a shard's rows is within eps_max of
    them, so every config's neighbours are covered.  Each shard's owned
    rows emit on its device over its owned + boundary slab
    (:func:`~.sharded._sweep_slab_graph`), the boundary slots are column
    evidence only, and the pieces are joined on the mesh's first device:
    no duplicated rows, each directed edge emitted once by its owner.

    Returns ``((gi, gj, dval), stats)``: int32 / int32 / float32 tensors
    in global-id space on the mesh's first device, and the JAX stats
    (``halo_exchange="morton_ring"``, the boundary-tile gauges,
    ``duplicated_work_factor == 1.0``).  A boundary slab that is not a
    whole number of ``block`` rows raises ``RuntimeError``.  ``mesh``,
    ``device`` and ``btcap`` as in :func:`global_morton_dbscan`; the
    graph's d^2 is exact in every precision mode, so the function takes
    no ``precision``."""
    from ..dbscan import resolve_device
    from ..ops.distances import sweep_max_edges
    from .sharded import _gather_graph, _on, _sweep_slab_graph

    mesh = _as_gm_mesh(mesh, resolve_device(device))
    metric = norm_metric(metric)
    points = np.asarray(points)
    n = points.shape[0]
    n_shards = mesh.size
    block = clamp_block(block, -(-n // max(n_shards, 1)))
    if cap_edges is None:
        cap_edges = sweep_max_edges()
    with obs_span("sweep.build", mode="global_morton"):
        arrays, bstats, host_bufs, base = build_morton_shards(
            points, n_shards, block, mesh, eps=eps)
    owned, omsk, ogid = arrays
    cap = int(bstats["owned_cap"])
    if n_shards > 1:
        with obs_span("sweep.exchange", mode="global_morton"):
            (bnd, bmsk, bgid), xstats = _gm_boundary_tiles(
                arrays, eps, mesh=mesh, block=block, btcap=btcap, base=base)
        brows = int(bnd[0].shape[1])
        if brows % block:
            raise RuntimeError(
                f"boundary rows {brows} not a multiple of block {block}")
    else:
        brows = 0
        xstats = {"boundary_tiles": 0, "boundary_rows": 0,
                  "boundary_tile_bytes": 0, "ring_rounds": 0}
    parts = []
    eb, pb = edge_budget, pair_budget
    with obs_span("sweep.extract", mode="global_morton", shards=n_shards):
        for s in range(n_shards):
            if brows:
                pts = torch.cat([owned[s], bnd[s]], dim=1)
                msk = torch.cat([omsk[s], bmsk[s]])
                gid = torch.cat([ogid[s], bgid[s]])
            else:
                pts, msk, gid = owned[s], omsk[s], ogid[s]
            with _on(mesh.device(s)):
                gi, gj, dv, eb, pb = _sweep_slab_graph(
                    pts, msk, gid, eps, owned_rows=cap, metric=metric,
                    block=block, edge_budget=eb, pair_budget=pb,
                    cap_edges=cap_edges)
            parts.append((gi, gj, dv))
    dev0 = mesh.device(0)
    graph = _gather_graph(parts, dev0, cap_edges)
    del parts
    staging.give_back_after_put(host_bufs, dev0)
    pairs = int(graph[0].numel())
    stats = {
        "mode": "global_morton",
        "halo_exchange": "morton_ring",
        "owner_computes": True,
        "duplicated_work_factor": 1.0,
        "graph_pairs": pairs,
        "graph_bytes": pairs * 12,
        "n_partitions": int(n_shards),
        **{k_: bstats[k_] for k_ in (
            "owned_cap", "pad_waste", "partition_sizes",
            "n_shard_partitions") if k_ in bstats},
        **{k_: xstats[k_] for k_ in (
            "boundary_tiles", "boundary_rows", "boundary_tile_bytes",
            "ring_rounds") if k_ in xstats},
    }
    return graph, stats
