"""The global-Morton route's chained form on one card (counterpart of
``pypardis_tpu/parallel/global_morton.py``, its 1-device chained route).

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
RAM.  Labels are the JAX route's, byte for byte, and those of the fused
single-card fit after :func:`~.sharded._canonicalize_roots`.

The mesh engine (``chain <= 1``, or more than one device), its ring
exchange and device fixpoint, ``btcap``, ``merge="device"`` and metrics
other than the Euclidean are later slices (ROADMAP A12) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..obs import event as obs_event
from ..obs import heartbeat as obs_heartbeat
from ..obs import span as obs_span
from ..ops.labels import oc_counts_banded, oc_extract, oc_propagate_banded
from ..partition import morton_range_split_streaming
from ..utils import faults
from ..utils.budget import run_ladders
from ..utils.hints import dispatch_tag
from ..utils.retry import Retrier
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
                     backend, pair_budget):
    """One range's owner-computes counts pass: owned rows count against
    owned and boundary columns.  Returns ``(own_core (owned,) or None,
    stats row, (total, budget))``, the last the full list's: ``None``
    and 0 passes where it passed its budget (no kernel ran)."""
    ex = oc_extract(pts, eps, msk, owned=owned, block=block,
                    precision=precision, backend=backend,
                    pair_budget=pair_budget)
    if ex["total"] > ex["budget"]:
        return None, _stats_row(ex, 0, (0, 0)), (ex["total"], ex["budget"])
    core, band = oc_counts_banded(ex, min_samples)
    return core, _stats_row(ex, 1, band), (ex["total"], ex["budget"])


def _gm_chain_propagate(pts, msk, core_all, gid, *, owned, eps, block,
                        precision, backend, pair_budget):
    """One range's relay propagation with host-supplied core flags.
    Returns ``(glabel (rows,), stats row)``: global root-gid labels over
    the owned and boundary slots (the occurrence tables' wire format);
    the stats row carries ``1 + passes``, as the JAX row does.  Raises
    on an overflow, which pass A would have met first."""
    ex = oc_extract(pts, eps, msk, owned=owned, block=block,
                    precision=precision, backend=backend,
                    pair_budget=pair_budget)
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
                       jobstate=None):
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
            (n_ranges, cap, k), bcap, block, mode, float(eps), "euclidean",
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
                            pair_budget=pb))

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
                                backend=backend, pair_budget=pb))

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
                    precision=mode, n=n)
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
# the driver
# ---------------------------------------------------------------------------


def _refuse(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item}); the port runs the "
        f"global-Morton route's chained form on one card "
        f"(mesh=1, chain > 1, merge='host')"
    )


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
    """Cluster ``points`` (N, k) with zero row duplication, chained
    through one card: ``chain`` (or ``PPTORCH_GM_CHAIN``) contiguous
    Morton ranges visit the card in turn (:func:`_gm_chained_dbscan`).
    Returns ``(labels, core, stats)``: labels are global root ids (each
    cluster's least core-point index, -1 noise) in input order.

    The JAX package's ``global_morton_dbscan(points, mesh=default_mesh(1),
    chain=R)``: every input, a ``np.memmap`` or an array in RAM, streams
    through the external sample-sort (``stream`` is accepted and changes
    nothing on this route, as in the JAX package), and the merge is the
    host union-find (``merge`` ``"auto"`` or ``"host"``).  ``block`` is
    clamped to the range size as the JAX driver clamps it.
    ``pair_budget`` and ``merge_rounds`` run the ladders of
    :func:`~pypardis_tpu_torch.utils.budget.run_ladders`.

    ``stats`` carries every key of the JAX chained route's (the staging
    counters from :func:`~.staging.fit_stats`: the route caches nothing,
    so a fit reuses nothing), ``gm_total_s``, and the
    port's own ``stage_s`` (the split, the host slab builds and the
    passes' device time from CUDA events) and ``partition_passes`` (per
    range dispatched, every ladder attempt: 1 for its counts pass if it
    ran, plus its min-label passes).

    ``device``: None runs on the card (and raises without CUDA);
    ``"cpu"`` runs the kernels' plain versions.  There is no fallback:
    a misaligned slab (a non-power-of-two ``block``), a kernel failure,
    a mesh of more than one device, ``chain <= 1`` (the mesh engine),
    ``btcap``, ``merge="device"`` and a metric other than the Euclidean
    raise.
    """
    from ..dbscan import resolve_device

    faults.from_env()
    validate_params(eps, min_samples)
    if merge not in ("auto", "device", "host"):
        raise ValueError(f"merge must be auto|device|host, got {merge!r}")
    if _mesh_size(mesh) > 1:
        _refuse("the global-Morton mesh engine on more than one device",
                "A10/A12, §A items 5-6")
    if chain is None:
        chain = int(os.environ.get("PPTORCH_GM_CHAIN") or 0)
    if int(chain) <= 1:
        _refuse(f"chain={chain}: the global-Morton mesh engine (its "
                f"1-device form runs when chain <= 1)", "A12, §A item 6")
    if btcap is not None:
        _refuse("btcap (the ring exchange's send buffer)", "A12, §A item 6")
    if merge == "device":
        _refuse("merge='device' (the device fixpoint, _gm_fixpoint)",
                "A12, §A item 6")
    if norm_metric(metric) != "euclidean":
        _refuse(f"metric={norm_metric(metric)!r} on the global-Morton route",
                "A12, §A item 7")
    dev = resolve_device(device)
    if isinstance(points, torch.Tensor):
        points = points.detach().cpu().numpy()
    # np.asarray would strip a memmap down to the array it maps.
    if not isinstance(points, np.memmap):
        points = np.asarray(points)
    n = points.shape[0]
    t0 = time.perf_counter()
    staging.begin_fit()
    block_c = clamp_block(block, -(-n // int(chain)))
    labels, core, stats = _gm_chained_dbscan(
        points, eps, min_samples, block=block_c, precision=precision,
        backend=backend, pair_budget=pair_budget, merge_rounds=merge_rounds,
        n_ranges=int(chain), device=dev, jobstate=jobstate,
    )
    stats["gm_total_s"] = round(time.perf_counter() - t0, 6)
    return labels, core, stats
