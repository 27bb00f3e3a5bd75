"""Tile boxes, live tile-pair extraction and the plain pair passes
(counterpart of ``pypardis_tpu/ops/distances.py``).

Coordinates travel in the ``(d, N)`` layout, N a multiple of the tile;
tile ``t`` is the column block ``[:, t*tile:(t+1)*tile]``.  Tile-level
pruning happens here, once per fit: :func:`live_tile_pairs` emits the
row-major list of (row tile, col tile) pairs whose bounding boxes lie
within eps, and every kernel pass walks that list.

The plain passes (:func:`counts_over_pairs`, :func:`minlab_over_pairs`)
are the kernels' plain PyTorch versions: the same pair list, the same
d^2 arithmetic — ``(x_a - y_a)^2`` summed over the axes in index order,
each operation rounded on its own (no fused multiply-add) — so they are
bitwise equal to the CUDA kernels in ``csrc/pair_kernels.cu`` on any
data.  The sketch passes (:func:`counts_over_pairs_sketch`,
:func:`minlab_over_pairs_sketch`) add the slab gate of
``csrc/sketch_kernels.cu`` in the same operation order, stats included.
The bf16 passes of ``precision="mixed"`` / ``"default"``
(:func:`counts_over_pairs_mixed`, :func:`minlab_over_pairs_mixed`,
:func:`counts_over_pairs_default`, :func:`minlab_over_pairs_default`)
recentre on the row tile's centre, round the operands to bf16 once and
take the cross term as an FP32 product of the rounded values (exact
products, so only the order of the sum differs from the kernels'
tensor-core accumulation); the squared norms, the band and the exact
rescore are the kernels' own operations.
B1's tensor-core kernel (d <= 64) decides most pairs from that bf16
d2f within a proven band and the rest exactly, so its counts are
:func:`counts_over_pairs`'; :func:`certified_count_walk` emulates it.
The CPU path runs them; on the card they are only the yardstick the
kernels are held against.
"""

from __future__ import annotations

import os

import numpy as np
import torch

INT_INF = 2**31 - 1
# Finite stand-in for +/-inf in padded tile boxes: differences of two
# bounds must not produce inf-inf NaNs.
_BIG = 3e38

# Tiles per group in the two-level extraction (group boxes prune first,
# only surviving group pairs expand to tile pairs).  The segment-break
# layout aligns segments to whole groups, so a group never unions boxes
# across segments.
PAIR_GROUP = 4

# Elements per gap / d^2 temporary: keeps chunked temporaries ~256MB.
_CHUNK_ELEMS = 1 << 26


def eps2_f32(eps) -> float:
    """eps^2 rounded as float32 arithmetic rounds it (eps to float32,
    then one float32 product), as a Python float holding that exact
    float32 value."""
    e = np.float32(eps)
    return float(e * e)


def tile_bounds(pts_t: torch.Tensor, msk: torch.Tensor):
    """(nt, d, tile) tiles (any strides) + (nt, tile) mask -> (nt, d)
    lower / upper bounds over valid points; empty tiles get the
    inverted box (+BIG, -BIG), whose squared gap to anything overflows
    to inf, so it never pairs.  (The JAX kernels use 2e19 there; any
    sentinel whose square overflows float32 prunes the same pairs.)"""
    valid = msk[:, None, :]
    big = torch.tensor(_BIG, dtype=pts_t.dtype, device=pts_t.device)
    lo = torch.where(valid, pts_t, big).amin(dim=2)
    hi = torch.where(valid, pts_t, -big).amax(dim=2)
    return lo, hi


def default_pair_budget(nt: int) -> int:
    """Default live-pair capacity: 48 pairs per row tile (at least 4096).
    Callers detect overflow through the exact total and rerun."""
    return max(4096, 48 * nt)


def _pad_boxes(lo, hi, n_to):
    pad = max(0, n_to - lo.shape[0])
    if pad == 0:
        return lo, hi
    fill = lo.new_full((pad, lo.shape[1]), _BIG)
    return torch.cat([lo, fill]), torch.cat([hi, -fill])


def eps_threshold(eps, metric: str = "euclidean") -> float:
    """The pair passes' float32 threshold: eps^2 (:func:`eps2_f32`) for
    the Euclidean metric, eps itself for cityblock."""
    if metric == "cityblock":
        return float(np.float32(eps))
    return eps2_f32(eps)


def _box_gap_live(rlo, rhi, clo, chi, thr, metric="euclidean"):
    """Box-to-box gap within the threshold, broadcast the JAX way: row
    boxes gain an axis before the feature axis.  Euclidean sums the
    squared per-axis gaps against eps^2, cityblock the gaps against eps
    (the L1 form of the JAX package's ``tile_skip_mask``)."""
    gap = torch.clamp_min(
        torch.maximum(clo - rhi[..., None, :], rlo[..., None, :] - chi), 0.0
    )
    if metric == "cityblock":
        return gap.sum(dim=-1) <= thr
    return (gap * gap).sum(dim=-1) <= thr


def cross_tile_live(lo_r, hi_r, lo_c, hi_c, eps, metric="euclidean"):
    """(nt_r,) bool: row tile i's box lies within eps of ANY column box
    (the JAX ``cross_tile_live``).  The global-Morton engine's boundary
    test: row boxes are one shard's tiles, column boxes the other
    shards' (gathered).  A column tile whose box clears eps of every row
    box holds no eps-neighbour of a row point, so the row's shard never
    needs it.  Inverted (+BIG, -BIG) boxes (empty tiles, padding, a
    shard's own tiles) are never live: their squared gap overflows to
    inf.  Chunked so the (chunk, nc, d) gap stays at :data:`_CHUNK_ELEMS`
    elements."""
    nt, d = lo_r.shape
    nc = lo_c.shape[0]
    out = torch.zeros(nt, dtype=torch.bool, device=lo_r.device)
    if nt == 0 or nc == 0:
        return out
    thr = eps_threshold(eps, metric)
    chunk = max(1, min(nt, -(-_CHUNK_ELEMS // max(nc * d, 1))))
    for s in range(0, nt, chunk):
        out[s:s + chunk] = _box_gap_live(
            lo_r[s:s + chunk], hi_r[s:s + chunk], lo_c[None], hi_c[None],
            thr, metric).any(dim=1)
    return out


def sketch_slab_t(tiles_t, q):
    """``(nt, d, g)`` tiles x ``(d, k)`` projection -> ``(nt, k + 1, g)``
    sketch slabs (the JAX ``_sketch_slab_t``): rows ``0..k-1`` the
    projection ``Q^T x``, row ``k`` the residual norm ``sqrt(max(|x|^2 -
    |Q^T x|^2, 0))``.  Each column depends on its own point only.  The
    projection is a float64 product rounded once to float32, as the
    kernels' :func:`~.cuda_kernels.sketch_stage` computes it (the JAX
    HIGHEST float32 product may differ in the last bits; the gate band
    certifies either rounding)."""
    q64 = torch.as_tensor(np.asarray(q), dtype=torch.float64,
                          device=tiles_t.device)
    nt, d, g = tiles_t.shape
    proj = torch.empty((nt, q64.shape[1], g), dtype=torch.float32,
                       device=tiles_t.device)
    step = max(1, (1 << 24) // max(d * g, 1))
    for s in range(0, nt, step):
        proj[s:s + step] = torch.einsum(
            "dk,tdg->tkg", q64, tiles_t[s:s + step].double()).float()
    full = (tiles_t * tiles_t).sum(dim=1, keepdim=True)
    res = torch.sqrt(torch.clamp_min(
        full - (proj * proj).sum(dim=1, keepdim=True), 0.0))
    return torch.cat([proj, res], dim=1)


def live_tile_pairs(lo, hi, eps, lo_col=None, hi_col=None, budget=None,
                    metric="euclidean"):
    """Row-major list of tile pairs whose bounding boxes lie within eps
    (in ``metric``: Euclidean or cityblock).

    ``lo``/``hi``: (nt, d) float32 row-tile bounds; ``lo_col``/``hi_col``
    default to the same boxes.  Returns ``(rows, cols, total)``: int32
    tensors of length ``budget`` (padding entries row == nt, col == 0)
    and ``total``, the TRUE live-pair count as a Python int.  When
    ``total > budget`` pairs were dropped and results built from the
    list are invalid; the exact total makes one rerun enough.

    Two-level, like the JAX extraction it mirrors entry for entry:
    groups of :data:`PAIR_GROUP` tiles prune first (a tile box lies
    inside its group's box, so no live tile pair hides behind a pruned
    group pair), surviving group pairs expand to tile pairs in
    group-pair order, the first ``budget`` live ones are kept, and a
    stable sort on the row tile makes the list row-major.
    """
    nt, d = lo.shape
    dev = lo.device
    if lo_col is None:
        lo_col, hi_col = lo, hi
    if budget is None:
        budget = default_pair_budget(nt)
    budget = min(budget, nt * nt)
    thr = eps_threshold(eps, metric)
    G = PAIR_GROUP
    ng = -(-nt // G)
    tlo_r, thi_r = _pad_boxes(lo, hi, (ng + 1) * G)
    tlo_c, thi_c = _pad_boxes(lo_col, hi_col, (ng + 1) * G)
    tlo_rg, thi_rg = tlo_r.reshape(ng + 1, G, d), thi_r.reshape(ng + 1, G, d)
    tlo_cg, thi_cg = tlo_c.reshape(ng + 1, G, d), thi_c.reshape(ng + 1, G, d)
    glo_r, ghi_r = tlo_rg.amin(dim=1), thi_rg.amax(dim=1)
    glo_c, ghi_c = tlo_cg.amin(dim=1)[:ng], thi_cg.amax(dim=1)[:ng]

    # Level 1: live group pairs, row-major.
    budget_g = min(max(2 * budget, 8192), ng * ng)
    chunk_g = max(1, min(ng, -(-_CHUNK_ELEMS // max(ng * d, 1))))
    live_g = torch.cat([
        _box_gap_live(glo_r[s:s + chunk_g], ghi_r[s:s + chunk_g],
                      glo_c[None], ghi_c[None], thr, metric).reshape(-1)
        for s in range(0, ng, chunk_g)
    ])
    gidx = torch.nonzero(live_g).reshape(-1)
    total_g = int(gidx.numel())
    gidx = gidx[:budget_g]
    rows_g = gidx // ng
    cols_g = gidx % ng

    # Level 2: expand surviving group pairs to tile pairs.
    chunk_p = max(1, _CHUNK_ELEMS // (G * G * max(d, 1)))
    iota = torch.arange(G, device=dev)
    rid_parts, cid_parts = [], []
    for s in range(0, int(gidx.numel()), chunk_p):
        a = rows_g[s:s + chunk_p]
        b = cols_g[s:s + chunk_p]
        live = _box_gap_live(
            tlo_rg[a], thi_rg[a], tlo_cg[b][:, None], thi_cg[b][:, None],
            thr, metric,
        ).reshape(-1)
        idx = torch.nonzero(live).reshape(-1)
        p, ij = idx // (G * G), idx % (G * G)
        rid_parts.append(a[p] * G + iota[ij // G])
        cid_parts.append(b[p] * G + iota[ij % G])
    if rid_parts:
        rid = torch.cat(rid_parts)
        cid = torch.cat(cid_parts)
    else:
        rid = cid = torch.zeros(0, dtype=torch.int64, device=dev)
    total_t = int(rid.numel())
    rows = torch.full((budget,), nt, dtype=torch.int64, device=dev)
    cols = torch.zeros(budget, dtype=torch.int64, device=dev)
    keep = min(total_t, budget)
    rows[:keep] = torch.clamp_max(rid[:keep], nt)
    cols[:keep] = torch.clamp_max(cid[:keep], nt - 1)
    order = torch.sort(rows, stable=True).indices
    # A group-level overflow also invalidates the list; fold it into the
    # total (the JAX package's saturated product, float32 then int).
    total = total_t
    if total_g > budget_g:
        g_need = int(min(
            float(torch.tensor(float(total_g * G * G), dtype=torch.float32)),
            float(1 << 30),
        ))
        total = max(total, g_need)
    return rows[order].to(torch.int32), cols[order].to(torch.int32), total


def row_offsets(rows: torch.Tensor, nt: int) -> torch.Tensor:
    """CSR offsets (nt + 1,) int32 of a row-sorted pair list: the pairs
    of row tile r are ``[off[r], off[r + 1])``; padding rows (== nt)
    fall past ``off[nt]``."""
    return torch.searchsorted(
        rows.contiguous(),
        torch.arange(nt + 1, dtype=rows.dtype, device=rows.device),
    ).to(torch.int32)


def _pair_d2(x, y):
    """(d, P, br) x (d, P, bc) -> (P, br, bc) squared distances: the
    axis-ordered sum of separately rounded squares, the kernels'
    arithmetic."""
    d2 = torch.zeros(
        (x.shape[1], x.shape[2], y.shape[2]), dtype=torch.float32,
        device=x.device,
    )
    for a in range(x.shape[0]):
        df = x[a][:, :, None] - y[a][:, None, :]
        d2 += df * df
    return d2


def _pair_l1(x, y):
    """(d, P, br) x (d, P, bc) -> (P, br, bc) L1 distances: ``|x_a -
    y_a|`` summed over the axes in index order, each operation rounded
    on its own.  Cityblock has no kernel in the JAX package either
    (only the Euclidean metric goes through Pallas), so this pass is
    its implementation on the card too."""
    d1 = torch.zeros(
        (x.shape[1], x.shape[2], y.shape[2]), dtype=torch.float32,
        device=x.device,
    )
    for a in range(x.shape[0]):
        d1 += (x[a][:, :, None] - y[a][:, None, :]).abs()
    return d1


def pair_dist(metric: str = "euclidean"):
    """The pair passes' distance: :func:`_pair_d2` or :func:`_pair_l1`."""
    return _pair_l1 if metric == "cityblock" else _pair_d2


def _entries(row_ptr, cols, nt, device):
    """The CSR pair list as (row tile, col tile) int64 entries."""
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(nt, device=device), counts)
    return rows, cols[:int(row_ptr[-1])].long()


def _identity(pts, tile, combine):
    """(nt, tile) int32 of the pass's identity: 0 for counts, INT32_MAX
    for minima."""
    return torch.full(
        (pts.shape[1] // tile, tile), 0 if combine == "sum" else INT_INF,
        dtype=torch.int32, device=pts.device,
    )


def _batches(pts, row_ptr, cols, tile):
    """The pair list's entries in batches: yields ``(s, r, c)``, the
    first entry and the row and column tiles (P,) of each batch, sized
    for (P, tile, tile) temporaries of ~64MB on the CPU, ~256MB on the
    card."""
    rows, cols = _entries(row_ptr, cols, pts.shape[1] // tile, pts.device)
    elems = _CHUNK_ELEMS if pts.is_cuda else _CHUNK_ELEMS // 4
    chunk = max(1, elems // (tile * tile))
    for s in range(0, int(rows.numel()), chunk):
        yield s, rows[s:s + chunk], cols[s:s + chunk]


def _reduce_rows(out, r, v, adj, combine):
    """Fold a batch's verdicts ``adj`` (P, tile, tile) into the (nt,
    tile) ``out``: the count of columns with a non-zero value
    (``"sum"``) or the least column value (``"min"``, non-sources carry
    INT32_MAX), ``v`` (P, 1, tile) the columns' values."""
    if combine == "sum":
        part = (adj & (v != 0)).sum(dim=-1, dtype=torch.int32)
        out.index_add_(0, r, part)
    else:
        cand = torch.where(adj, v, INT_INF).amin(dim=-1)
        out.scatter_reduce_(
            0, r[:, None].expand(-1, out.shape[1]), cand, reduce="amin"
        )


def _pair_verdicts(pts, colval, row_ptr, cols, eps2, tile,
                   metric="euclidean"):
    """B1/B2's FP32 verdicts over the pair list, a batch of entries at a
    time: yields ``(s, r, v, adj)``, the batch's first entry ``s``, row
    tiles ``r`` (P,), column values ``v`` (P, 1, tile) and the pairs
    within eps ``adj`` (P, tile, tile), columns of any value.  ``eps2``
    is the metric's threshold (:func:`eps_threshold`)."""
    d = pts.shape[0]
    tiles = pts.reshape(d, -1, tile)
    vals = colval.reshape(-1, tile)
    dist = pair_dist(metric)
    for s, r, c in _batches(pts, row_ptr, cols, tile):
        yield s, r, vals[c][:, None, :], dist(tiles[:, r],
                                              tiles[:, c]) <= eps2


def _live_only(out, live_rows):
    """``out`` (N,) with INT32_MAX on the rows outside ``live_rows``
    (None: every row)."""
    return out if live_rows is None else torch.where(live_rows, out, INT_INF)


def _over_pairs(pts, colval, row_ptr, cols, eps2, tile, combine,
                metric="euclidean"):
    out = _identity(pts, tile, combine)
    for _s, r, v, adj in _pair_verdicts(pts, colval, row_ptr, cols, eps2,
                                        tile, metric):
        _reduce_rows(out, r, v, adj, combine)
    return out.reshape(-1)


def counts_over_pairs(pts, mask, row_ptr, cols, eps2, tile,
                      metric="euclidean"):
    """Plain version of the count kernel: for every point, the number of
    columns j with ``mask[j] != 0`` and ``d^2 <= eps2`` over the live
    column tiles of its row tile.  ``pts`` (d, N) float32, ``mask`` (N,)
    int32, ``row_ptr`` (nt+1,) int32, ``cols`` int32, ``eps2`` the
    float32 eps^2 (:func:`eps2_f32`).  Rows whose tile has no live pair
    get 0; invalid rows get a count the caller masks.  With
    ``metric="cityblock"`` the distance is :func:`_pair_l1` and ``eps2``
    the float32 eps (:func:`eps_threshold`)."""
    return _over_pairs(pts, mask, row_ptr, cols, eps2, tile, "sum", metric)


def minlab_over_pairs(pts, labels, row_ptr, cols, eps2, tile,
                      live_rows=None, metric="euclidean"):
    """Plain version of the min-label kernel: for every point, the
    minimum ``labels[j]`` over columns within eps (non-source columns
    carry INT32_MAX, so they never win); INT32_MAX where none is, and
    on every row outside ``live_rows`` (an optional (N,) bool: the rows
    the caller still needs, see :func:`minlab_pairs_walk`).  ``metric``
    as in :func:`counts_over_pairs`."""
    return _live_only(
        _over_pairs(pts, labels, row_ptr, cols, eps2, tile, "min", metric),
        live_rows)


def axis_sq(v):
    """Squared norms over dim 0, summed axis by axis in index order with
    each operation rounded on its own: the kernels' own sum."""
    acc = v[0] * v[0]
    for a in range(1, v.shape[0]):
        acc = acc + v[a] * v[a]
    return acc


def bf16_round(v):
    """Round to bf16 (nearest even) and back: the fast pass's operands."""
    return v.to(torch.bfloat16).float()


def fast_band(nx, ny, gx, gy):
    """The mixed classification band at recentred norm maxima ``nx``/
    ``ny`` and frame norm maxima ``gx``/``gy`` (float32 tensors):
    ``band_halfwidth(nx, ny) + exact_slack(gx, gy)``, the JAX package's
    ``_mixed_band_t``, each operation in float32 in the order the
    kernels take it."""
    from .precision import band_halfwidth, exact_slack

    return band_halfwidth(nx, ny) + exact_slack(gx, gy)


def tile_norms(pts, row_mask, tile, centers):
    """(nt, 2) float32 ``[nx, gx]`` per row tile over the rows of
    ``row_mask``: the largest recentred norm ``|x - c|`` (``c`` the
    tile's row of ``centers``) and the largest frame norm ``|x|``, 0
    for an empty tile (the masked ``_nmax_t`` of the JAX package)."""
    d, n = pts.shape
    nt = n // tile
    t3 = pts.reshape(d, nt, tile)
    m2 = row_mask.reshape(nt, tile)
    nx = torch.sqrt(torch.where(
        m2, axis_sq(t3 - centers.T[:, :, None]), 0.0).amax(dim=1))
    gx = torch.sqrt(torch.where(m2, axis_sq(t3), 0.0).amax(dim=1))
    return torch.stack([nx, gx], dim=1).contiguous()


def _fast_d2(xt, yt, ctr):
    """The bf16 fast pass for a batch of tile pairs: ``xt`` (d, P, br)
    rows, ``yt`` (d, P, bc) columns, ``ctr`` (P, d) each pair's row-tile
    centre -> ``(d2f, yy)``: ``d2f`` (P, br, bc) ``(|x-c|^2 + |y-c|^2) -
    2 bf16(x-c).bf16(y-c)`` and ``yy`` (P, bc) the columns' ``|y-c|^2``.
    Products of bf16 values are exact in FP32 (and in TF32), so no
    global matmul setting changes them."""
    c = ctr.T[:, :, None]
    xc = xt - c
    yc = yt - c
    xx = axis_sq(xc)
    yy = axis_sq(yc)
    dot = torch.bmm(bf16_round(xc).permute(1, 2, 0),
                    bf16_round(yc).permute(1, 0, 2))
    return (xx[:, :, None] + yy[:, None, :]) - 2.0 * dot, yy


def _fast_verdicts(pts, colval, row_ptr, cols, eps2, tile, combine, mode,
                   centers, rnorm=None):
    """The bf16 pair kernels' verdicts over the pair list, a batch of
    entries at a time.

    ``"default"``: the verdict is ``d2f <= eps2``.  ``"mixed"``: per
    pair-list entry the band is :func:`fast_band` at the row tile's
    ``rnorm`` and, over the entry's valid (``combine="sum"``: mask !=
    0) or source (``"min"``: label != INT32_MAX) columns, ``ny = max
    |y - c|`` and ``gy = max |y|``; a pair with ``|d2f - eps2| <=
    band`` and a valid column takes the exact ``_pair_d2`` verdict,
    every other pair the fast one.  Yields ``(s, r, v, adj, amb)``: as
    :func:`_pair_verdicts`, plus the in-band pairs ``amb`` (P, tile,
    tile) with a valid column (None under ``"default"``)."""
    d = pts.shape[0]
    tiles = pts.reshape(d, -1, tile)
    vals = colval.reshape(-1, tile)
    for s, r, c in _batches(pts, row_ptr, cols, tile):
        yt = tiles[:, c]
        d2f, yy = _fast_d2(tiles[:, r], yt, centers[r])
        v = vals[c]
        valid = (v != 0) if combine == "sum" else (v != INT_INF)
        adj = d2f <= eps2
        amb = None
        if mode == "mixed":
            ny = torch.sqrt(torch.where(valid, yy, 0.0).amax(dim=1))
            gy = torch.sqrt(torch.where(valid, axis_sq(yt), 0.0).amax(dim=1))
            band = fast_band(rnorm[r, 0], ny, rnorm[r, 1], gy)
            amb = ((d2f - eps2).abs() <= band[:, None, None]) & valid[:, None]
            need = amb.flatten(1).any(dim=1)
            if bool(need.any()):
                d2 = _pair_d2(tiles[:, r[need]], yt[:, need])
                adj[need] = torch.where(amb[need], d2 <= eps2, adj[need])
        yield s, r, v[:, None, :], adj, amb


def _fast_over_pairs(pts, colval, row_ptr, cols, eps2, tile, combine, mode,
                     centers, rnorm=None):
    """The bf16 pair kernels' arithmetic (:func:`_fast_verdicts`)
    reduced per row.  Stats (``"sum"`` only) count the in-band pairs of
    valid rows and columns, and the entries holding one."""
    out = _identity(pts, tile, combine)
    vals = colval.reshape(-1, tile)
    n_band = torch.zeros((), dtype=torch.int64, device=pts.device)
    n_resc = torch.zeros((), dtype=torch.int64, device=pts.device)
    for _s, r, v, adj, amb in _fast_verdicts(
            pts, colval, row_ptr, cols, eps2, tile, combine, mode, centers,
            rnorm):
        if amb is not None and combine == "sum":
            st = amb & (vals[r] != 0)[:, :, None]
            n_band += st.sum()
            n_resc += st.flatten(1).any(dim=1).sum()
        _reduce_rows(out, r, v, adj, combine)
    return out.reshape(-1), torch.stack([n_band, n_resc])


def counts_over_pairs_mixed(pts, mask, row_ptr, cols, eps2, tile, centers,
                            rnorm):
    """Plain version of B1 under ``precision="mixed"``: the counts of
    :func:`counts_over_pairs` (equal to them on any data, on the rows
    of the mask ``rnorm`` was taken over) through the bf16 fast pass and
    the per-pair exact rescore.  ``centers`` (nt, d) the row tiles' box
    centres over ``mask`` and ``rnorm`` their (nt, 2) :func:`tile_norms`
    over it.  Returns ``(counts,
    stats)``, ``stats`` the (2,) int64 ``[band_pairs,
    rescored_tiles]``."""
    return _fast_over_pairs(pts, mask, row_ptr, cols, eps2, tile, "sum",
                            "mixed", centers, rnorm)


def minlab_over_pairs_mixed(pts, labels, row_ptr, cols, eps2, tile,
                            centers, rnorm, live_rows=None):
    """Plain version of B2 under ``precision="mixed"``: the result of
    :func:`minlab_over_pairs` on the rows ``rnorm`` covers (no stats;
    ``live_rows`` as there)."""
    return _live_only(
        _fast_over_pairs(pts, labels, row_ptr, cols, eps2, tile, "min",
                         "mixed", centers, rnorm)[0], live_rows)


def counts_over_pairs_default(pts, mask, row_ptr, cols, eps2, tile,
                              centers):
    """Plain version of B1 under ``precision="default"``: every pair
    decided by the bf16 pass alone (lossy)."""
    return _fast_over_pairs(pts, mask, row_ptr, cols, eps2, tile, "sum",
                            "default", centers)[0]


def minlab_over_pairs_default(pts, labels, row_ptr, cols, eps2, tile,
                              centers, live_rows=None):
    """Plain version of B2 under ``precision="default"`` (``live_rows``
    as in :func:`minlab_over_pairs`)."""
    return _live_only(
        _fast_over_pairs(pts, labels, row_ptr, cols, eps2, tile, "min",
                         "default", centers)[0], live_rows)


def _sketch_gate(pts, slab, k, colval, row_ptr, cols, eps2, band, tile,
                 combine):
    """The sketch kernels' gate over the pair list, a batch of entries
    at a time.  Per pair: ``t2`` the axis-ordered (skp)-row slab
    distance, ``up = t2 + (4 rx) ry``; sure-in ``up <= eps2 - band``,
    sure-out ``t2 - band > eps2``.  Yields ``(s, r, c, v, sure_in,
    amb)`` per batch: its first entry ``s``, row and column tiles ``r``,
    ``c`` (P,), column values ``v`` (P, 1, tile), the sure-in pairs
    (P, tile, tile) and the in-band ones whose column is valid."""
    stiles = slab.reshape(slab.shape[0], -1, tile)
    vals = colval.reshape(-1, tile)
    lo = float(np.float32(eps2) - np.float32(band))
    for s, r, c in _batches(pts, row_ptr, cols, tile):
        sx, sy = stiles[:, r], stiles[:, c]
        t2 = _pair_d2(sx, sy)
        up = t2 + (4.0 * sx[k])[:, :, None] * sy[k][:, None, :]
        sure_in = up <= lo
        v = vals[c][:, None, :]
        valid = (v != 0) if combine == "sum" else (v != INT_INF)
        amb = ~(sure_in | ((t2 - band) > eps2)) & valid
        yield s, r, c, v, sure_in, amb


def _sketch_verdicts(pts, slab, k, colval, row_ptr, cols, eps2, band,
                     tile, combine, centers=None):
    """The sketch kernels' per-pair verdicts over the pair list, a batch
    of entries at a time: the gate of :func:`_sketch_gate`, and every
    in-band pair the exact ``_pair_d2`` against eps2 — or, with the row
    tiles' ``centers``
    (``precision="default"``), the bf16 pass's ``d2f`` of
    :func:`_fast_d2`.  Yields ``(s, r, v, adj, amb, need)`` per batch:
    its first entry ``s``, row tiles ``r`` (P,), column values ``v`` (P,
    1, tile), the pairs within eps whose column is valid ``adj`` (P,
    tile, tile), the in-band ones ``amb`` and the entries holding one
    ``need`` (P,)."""
    tiles = pts.reshape(pts.shape[0], -1, tile)
    for s, r, c, v, sure_in, amb in _sketch_gate(
            pts, slab, k, colval, row_ptr, cols, eps2, band, tile, combine):
        valid = (v != 0) if combine == "sum" else (v != INT_INF)
        need = amb.flatten(1).any(dim=1)
        adj = sure_in
        if bool(need.any()):
            # The rescore only where a tile holds an in-band pair: the
            # verdict is the same at any granularity.
            if centers is None:
                d2 = _pair_d2(tiles[:, r[need]], tiles[:, c[need]])
            else:
                d2 = _fast_d2(tiles[:, r[need]], tiles[:, c[need]],
                              centers[r[need]])[0]
            adj[need] = torch.where(amb[need], d2 <= eps2, sure_in[need])
        yield s, r, v, adj & valid, amb, need


def _sketch_over_pairs(pts, slab, k, colval, row_ptr, cols, eps2, band,
                       tile, combine, centers=None):
    """The sketch kernels' arithmetic (:func:`_sketch_verdicts`) reduced
    per row.  Stats count the in-band pairs whose column is valid (rows
    unmasked) and the pair-list entries holding one."""
    out = _identity(pts, tile, combine)
    n_band = torch.zeros((), dtype=torch.int64, device=pts.device)
    n_resc = torch.zeros((), dtype=torch.int64, device=pts.device)
    for _s, r, v, adj, amb, need in _sketch_verdicts(
            pts, slab, k, colval, row_ptr, cols, eps2, band, tile, combine,
            centers):
        n_band += amb.sum()
        n_resc += need.sum()
        _reduce_rows(out, r, v, adj, combine)
    return out.reshape(-1), torch.stack([n_band, n_resc])


def counts_over_pairs_sketch(pts, mask, row_ptr, cols, slab, k, eps2,
                             band, tile, centers=None):
    """Plain version of the sketch count kernel (B3): the counts of
    :func:`counts_over_pairs` (equal to them on any data), decided
    through the slab gate.  ``slab`` (skp, N) float32 with row ``k``
    the residual norm; ``band`` the gate's float32 halfwidth;
    ``centers`` (nt, d) the row tiles' centres for the bf16 rescore of
    ``precision="default"`` (None: the exact rescore of ``"high"`` and
    ``"mixed"``).  Returns ``(counts, stats)``, ``stats`` a (2,) int64
    tensor ``[band_pairs, rescored_tiles]``."""
    return _sketch_over_pairs(pts, slab, k, mask, row_ptr, cols, eps2,
                              band, tile, "sum", centers)


def minlab_over_pairs_sketch(pts, labels, row_ptr, cols, slab, k, eps2,
                             band, tile, centers=None):
    """Plain version of the sketch min-label kernel (B4): the result of
    :func:`minlab_over_pairs` through the slab gate (no stats)."""
    return _sketch_over_pairs(pts, slab, k, labels, row_ptr, cols, eps2,
                              band, tile, "min", centers)[0]


# Columns per chunk of the min-label kernels' block walk (B2, B4).
SKIP_CHUNK = 32


def minlab_group(d: int, mode: str = "high") -> int:
    """The 32-column chunks B2's kernel instance for ``d`` and ``mode``
    stages per barrier (its group, fixed in ``csrc/pair_kernels.cu``):
    two under ``"mixed"``/``"default"`` (``FP_GROUP``, the bf16
    kernel's 64-column buffer); under ``"high"``/``"highest"`` one past
    64 axes (the axis-sliced path), else ``pp_group``: eight, or as many
    as fit 48 KB of shared memory at the instance's width (d rounded up
    to 4, 8, 16, 32 or 64), five at 64."""
    if mode in ("mixed", "default"):
        return 2
    if d > 64:
        return 1
    dc = next(w for w in (4, 8, 16, 32, 64) if d <= w)
    return min(8, 49152 // (4 * (dc + 1) * SKIP_CHUNK))


def _label_bound_walk(batches, labels, row_ptr, tile, rows_per_block,
                      group, live_rows=None):
    """The min-label kernels' block walk (B2's and B4's label-bound
    skip) over per-batch verdicts ``batches`` (``(s, r, v, adj)`` as
    :func:`_pair_verdicts` yields them).

    A block holds ``rows_per_block`` rows of a row tile and walks its
    entries in CSR order, 32 columns at a time, keeping each row's
    running minimum ``m_r`` (from INT32_MAX).  Its bound is the max of
    ``m_r`` over its rows in ``live_rows`` (all rows when None); it
    evaluates a chunk only when the chunk's least label is below the
    bound, and then lowers each ``m_r`` by the chunk's labels within
    eps.  The bound is refreshed after every ``group`` evaluated chunks
    (the chunks a kernel stages per barrier).  Kernels also pass over
    whole entries whose tile's least label is not below the bound;
    every chunk of such an entry fails the chunk test, so the count is
    the same.  Rows outside ``live_rows`` get INT32_MAX.  Returns
    ``(best, evaluated)``: (N,) int32 and the (block, chunk) pairs
    evaluated, a Python int."""
    n = labels.shape[0]
    nt = n // tile
    dev = labels.device
    best = torch.full((nt, tile), INT_INF, dtype=torch.int32, device=dev)
    per_tile = (row_ptr[1:] - row_ptr[:-1]).long()
    live = torch.nonzero(per_tile).reshape(-1)
    if live.numel() == 0:
        return best.reshape(-1), 0
    nl = int(live.numel())
    slot = torch.full((nt,), -1, dtype=torch.int64, device=dev)
    slot[live] = torch.arange(nl, device=dev)
    rows = torch.repeat_interleave(torch.arange(nt, device=dev), per_tile)
    pos = (torch.arange(rows.numel(), device=dev)
           - row_ptr[:-1].long()[rows])
    max_e = int(per_tile.max())
    nch = -(-tile // SKIP_CHUNK)
    wpad = nch * SKIP_CHUNK - tile
    nb = -(-tile // rows_per_block)
    rpad = nb * rows_per_block
    # Per (live row tile, entry, chunk): each row's least label within
    # eps in the chunk, and the chunk's least label.
    cand = torch.full((nl, max_e, nch, rpad), INT_INF, dtype=torch.int32,
                      device=dev)
    lmin = torch.full((nl, max_e, nch), INT_INF, dtype=torch.int32,
                      device=dev)
    for s, r, v, adj in batches:
        p = r.numel()
        cv = torch.where(adj, v, INT_INF)
        vv = v[:, 0, :]
        if wpad:
            cv = torch.nn.functional.pad(cv, (0, wpad), value=INT_INF)
            vv = torch.nn.functional.pad(vv, (0, wpad), value=INT_INF)
        cm = cv.reshape(p, tile, nch, SKIP_CHUNK).amin(dim=-1)
        sl, ps = slot[r], pos[s:s + p]
        cand[sl, ps, :, :tile] = cm.transpose(1, 2)
        lmin[sl, ps] = vv.reshape(p, nch, SKIP_CHUNK).amin(dim=-1)
    cand = cand.reshape(nl, max_e * nch, nb, rows_per_block)
    lmin = lmin.reshape(nl, max_e * nch)
    inb = (torch.arange(rpad, device=dev) < tile).expand(nl, rpad)
    if live_rows is not None:
        lr = torch.nn.functional.pad(live_rows.reshape(nt, tile)[live],
                                     (0, rpad - tile), value=False)
        inb = inb & lr
    inb = inb.reshape(nl, nb, rows_per_block)
    m = torch.full((nl, nb, rows_per_block), INT_INF, dtype=torch.int32,
                   device=dev)

    def bound_of(m):
        return torch.where(inb, m, -INT_INF - 1).amax(dim=-1)

    bound = bound_of(m)
    fill = torch.zeros((nl, nb), dtype=torch.int64, device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(max_e * nch):
        ev = lmin[:, t, None] < bound
        evaluated += ev.sum()
        m = torch.where(ev[..., None], torch.minimum(m, cand[:, t]), m)
        fill += ev
        close = fill >= group
        fill = torch.where(close, 0, fill)
        bound = torch.where(close, bound_of(m), bound)
    m = torch.where(inb, m, INT_INF)
    best[live] = m.reshape(nl, rpad)[:, :tile]
    return best.reshape(-1), int(evaluated)


def minlab_skip_walk(pts, labels, row_ptr, cols, slab, k, eps2, band, tile,
                     centers=None, rows_per_block=256):
    """Plain emulation of B4's label-bound walk (``csrc/
    sketch_kernels.cu``): the result of :func:`minlab_over_pairs_sketch`
    and the number of (block, 32-column chunk) pairs the kernel
    evaluates, by :func:`_label_bound_walk` over
    :func:`_sketch_verdicts`' own verdicts, one chunk staged per barrier.
    Returns ``(best, evaluated)``, ``best`` (N,) int32 and
    ``evaluated`` a Python int.  The fit never calls this: the card
    checks, the tests and, on the CPU, the wrapper's ``evaluated=``
    do."""
    batches = ((s, r, v, adj) for s, r, v, adj, _a, _n in _sketch_verdicts(
        pts, slab, k, labels, row_ptr, cols, eps2, band, tile, "min",
        centers))
    return _label_bound_walk(batches, labels, row_ptr, tile, rows_per_block,
                             1)


def minlab_pairs_walk(pts, labels, row_ptr, cols, eps2, tile, mode="high",
                      centers=None, rnorm=None, *, live_rows=None,
                      group=None, rows_per_block=None):
    """Plain emulation of B2's label-bound walk (``csrc/
    pair_kernels.cu``, every mode): the result of
    :func:`minlab_over_pairs` (``"high"``/``"highest"``),
    :func:`minlab_over_pairs_mixed` or :func:`minlab_over_pairs_default`
    (``centers``/``rnorm`` as there) and the (block, 32-column chunk)
    pairs the kernel evaluates, by :func:`_label_bound_walk` over the
    plain version's own verdicts, in blocks of 256 rows (the FP32
    kernel) or 128 (the bf16 kernel) staging :func:`minlab_group`
    chunks per barrier.  ``live_rows``: the rows the caller still
    needs; the rest leave the bound and get INT32_MAX.  ``group`` /
    ``rows_per_block`` stand in for the kernel's, for tests of the walk
    itself.  Returns ``(best,
    evaluated)``.  The fit never calls this: the card checks, the tests
    and, on the CPU, the wrappers' ``evaluated=`` do."""
    fast = mode in ("mixed", "default")
    if fast:
        batches = ((s, r, v, adj) for s, r, v, adj, _a in _fast_verdicts(
            pts, labels, row_ptr, cols, eps2, tile, "min", mode, centers,
            rnorm))
    else:
        batches = _pair_verdicts(pts, labels, row_ptr, cols, eps2, tile)
    return _label_bound_walk(
        batches, labels, row_ptr, tile,
        rows_per_block or (128 if fast else 256),
        group or minlab_group(pts.shape[0], mode), live_rows)


def _round_up_f32(v: float) -> float:
    f = np.float32(v)
    if float(f) < v:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


def certified_band_coefs(d: int):
    """``(c_cross, c_acc, c_norm)`` of B3's certified band (the
    derivation is in the header of ``csrc/sketch_kernels.cu``, whose
    launch takes the same expressions): ``1.25 2 h``, ``1.25 2^-20 K h``
    and ``1.25 (3 d + 12) 2^-24 h`` in float64, ``K`` = d padded to 16
    and ``h = 1 / (1 - (2 d + 8 K + 64) 2^-24)`` (infinite where that
    is not positive), each rounded up to float32 and returned as a
    Python float holding that value."""
    K = -(-int(d) // 16) * 16
    hd = 1.0 - (2.0 * d + 8.0 * K + 64.0) * 2.0**-24
    h = 1.0 / hd if hd > 0.0 else float("inf")
    return (_round_up_f32(2.5 * h),
            _round_up_f32(1.25 * 2.0**-20 * K * h),
            _round_up_f32(1.25 * (3.0 * d + 12.0) * 2.0**-24 * h))


def _cert_norms(v):
    """Per point of ``v`` (d, ...) recentred float32 values: ``(|v|^2,
    |v|, |v'|, |v' - v|)``, ``v'`` the bf16 rounding, each sum axis-
    ordered in float32 and each root correctly rounded."""
    vh = bf16_round(v)
    sq = axis_sq(v)
    return (sq, torch.sqrt(sq), torch.sqrt(axis_sq(vh)),
            torch.sqrt(axis_sq(vh - v)))


def _certified_terms(xt, yt, ctr):
    """:func:`certified_d2`'s ``(d2f, band_p)`` and, per pair, ``|X'|
    |Y'|`` and ``S = |X|^2 + |Y|^2`` (float32)."""
    d = xt.shape[0]
    c = ctr.T[:, :, None]
    xc, yc = xt - c, yt - c
    dot = torch.bmm(bf16_round(xc).permute(1, 2, 0),
                    bf16_round(yc).permute(1, 0, 2))
    xx, xn, xh, xe = (t[:, :, None] for t in _cert_norms(xc))
    yy, _yn, yh, ye = (t[:, None, :] for t in _cert_norms(yc))
    s = xx + yy
    d2f = s - 2.0 * dot
    f32 = dict(dtype=torch.float32, device=xt.device)
    c_cross, c_acc, c_norm = (torch.tensor(v, **f32)
                              for v in certified_band_coefs(d))
    cross = xe * yh + xn * ye
    hh = xh * yh
    b = c_cross * cross + c_acc * hh
    return d2f, b + (c_norm * s + torch.tensor(2.0**-100, **f32)), hh, s


def certified_d2(xt, yt, ctr):
    """B3's certified rescore terms for a batch of tile pairs (``xt``
    (d, P, br) rows, ``yt`` (d, P, bc) columns, ``ctr`` (P, d) each
    pair's row-tile centre): ``(d2f, band_p)``, both (P, br, bc)
    float32: ``d2f`` as in :func:`_fast_d2` and ``band_p = ((c_cross (xe
    yh + xn ye)) + c_acc (xh yh)) + ((c_norm (xx + yy)) + 2^-100)`` from
    the rows' and columns' :func:`_cert_norms` and
    :func:`certified_band_coefs`, each operation in float32 as the
    kernel takes it.  The band bounds ``|d2f - d2|``, ``d2`` the exact
    ``_pair_d2``, for any order of the cross term's sum."""
    return _certified_terms(xt, yt, ctr)[:2]


def certified_rescore_walk(pts, mask, row_ptr, cols, slab, k, eps2, band,
                           tile, centers):
    """Plain emulation of B3's certified rescore (``csrc/
    sketch_kernels.cu``, the exact modes): for the in-band pairs of
    :func:`_sketch_gate`, ``d2f`` from the bf16-rounded operands
    recentred on the row tile's ``centers`` (nt, d) and the per-pair
    ``band_p`` of :func:`certified_d2`; ``d2f + band_p < eps2`` is
    certainly in, ``d2f - band_p > eps2`` certainly out, and every other
    pair is queued and decided by the exact axis-ordered d^2.  Returns
    ``(counts, rescored_pairs, fragile)``: counts (N,) int32, equal to
    :func:`counts_over_pairs_sketch`'s when the band is sound, the
    queued pairs as a Python int, and the fragile pairs, which bound
    ``|kernel - emulation|`` of the queued count.  The kernel sums in
    its own order, so a pair whose ``fl(d2f + band_p)`` or ``fl(d2f -
    band_p)`` lies within ``w`` of eps2 may fall on the other side
    there, with ``w = 1.25 (2^-19 K |X'| |Y'| + (2 d + 12) 2^-24 S +
    (2 d + 52) 2^-24 band_p)`` from the header's bounds: two orders of
    the cross term (its (3), twice), of the squared norms (its (1),
    twice) and of the band's norms, and the roundings of ``d2f`` and of
    the two tests; ``S = |X|^2 + |Y|^2``, ``K`` = d padded to 16.  The
    fit never calls this: the tests, the card checks and, on the CPU,
    the wrapper's ``rescored_pairs=`` do."""
    d, n = pts.shape
    nt = n // tile
    tiles = pts.reshape(d, nt, tile)
    out = torch.zeros((nt, tile), dtype=torch.int32, device=pts.device)
    rescored = n_fragile = 0
    K = -(-d // 16) * 16
    u = 2.0**-24
    for _s, r, c, v, sure_in, amb in _sketch_gate(
            pts, slab, k, mask, row_ptr, cols, eps2, band, tile, "sum"):
        adj = sure_in & (v != 0)
        need = amb.flatten(1).any(dim=1)
        if bool(need.any()):
            rn, cn, an = r[need], c[need], amb[need]
            d2f, bp, hh, sc = _certified_terms(tiles[:, rn], tiles[:, cn],
                                               centers[rn])
            hi, lo = d2f + bp, d2f - bp
            cin = an & (hi < eps2)
            queued = an & ~cin & ~(lo > eps2)
            w = 1.25 * (2.0**-19 * K * hh.double()
                        + (2 * d + 12) * u * sc.double()
                        + (2 * d + 52) * u * bp.double())
            e2 = float(np.float32(eps2))
            n_fragile += int((an & (((hi.double() - e2).abs() <= w)
                                    | ((lo.double() - e2).abs() <= w))).sum())
            p, i, j = torch.nonzero(queued, as_tuple=True)
            step = max(1, _CHUNK_ELEMS // (4 * d))
            for q in range(0, int(p.numel()), step):
                pq, iq, jq = p[q:q + step], i[q:q + step], j[q:q + step]
                d2 = axis_sq(tiles[:, rn[pq], iq] - tiles[:, cn[pq], jq])
                cin[pq, iq, jq] = d2 <= eps2
            adj[need] |= cin
            rescored += int(p.numel())
        out.index_add_(0, r, adj.sum(dim=-1, dtype=torch.int32))
    return out.reshape(-1), rescored, n_fragile


# Columns per band chunk of B1's tensor-core kernel (``B1_CH`` in
# ``csrc/pair_kernels.cu``): one certified band per (row, chunk).
B1_CHUNK = 64


def _fma_f32(a, b, c):
    """``fl(a b + c)`` of float32 tensors: the product is exact in
    float64 and the sum is rounded there, then to float32 (a double
    rounding that can differ from the card's fused multiply-add by one
    ulp, which :func:`certified_count_walk`'s fragile pairs cover)."""
    return (a.double() * b.double() + c.double()).float()


def _fadd_dir(a, b, up: bool):
    """``a + b`` of float32 tensors rounded up (or down): the nearest sum
    and its exact error (Knuth's two-sum, every step in float32), stepped
    one ulp where the error points that way; an infinite or NaN sum
    stays as it is."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    step = torch.nextafter(s, torch.full_like(s, np.inf if up else -np.inf))
    return torch.where(e > 0 if up else e < 0, step, s)


def b1_chunk_band(xc, yc, valid):
    """The certified band of B1's tensor-core kernel (``csrc/
    pair_kernels.cu``) for a batch of tile pairs: ``xc`` (d, P, br) rows
    and ``yc`` (d, P, bc) columns recentred on the row tile's centre,
    ``valid`` (P, bc) the valid columns.  One band per row and chunk of
    :data:`B1_CHUNK` columns: B3's per-pair band (:func:`certified_d2`)
    at the chunk's maxima over its valid columns of ``|Y|^2``, ``|Y'|``
    and ``|Y' - Y|``, as ``alpha YH + beta YE + c_norm YY + delta`` with
    the row's ``alpha = c_cross |X' - X| + c_acc |X'|``, ``beta = c_cross
    |X|`` and ``delta = c_norm |X|^2 + 2^-100``, the sum by three fused
    multiply-adds (:func:`_fma_f32`).  Every term is non-negative and
    monotone in the column norms, so the band bounds ``|d2f - d2|`` for
    every pair of the chunk.  Returns (P, br, bc) float32, each column
    carrying its chunk's band."""
    d = xc.shape[0]
    P, bc = valid.shape
    nch = -(-bc // B1_CHUNK)
    pad = nch * B1_CHUNK - bc
    xx, xn, xh, xe = _cert_norms(xc)
    yy, _yn, yh, ye = _cert_norms(yc)

    def cmax(v):
        v = torch.nn.functional.pad(torch.where(valid, v, 0.0), (0, pad))
        return v.reshape(P, nch, B1_CHUNK).amax(dim=-1)[:, None, :]

    f32 = dict(dtype=torch.float32, device=xc.device)
    c_cross, c_acc, c_norm = (torch.tensor(v, **f32)
                              for v in certified_band_coefs(d))
    alpha = (c_cross * xe + c_acc * xh)[:, :, None]
    beta = (c_cross * xn)[:, :, None]
    delta = (c_norm * xx + torch.tensor(2.0**-100, **f32))[:, :, None]
    band = _fma_f32(alpha, cmax(yh), _fma_f32(
        beta, cmax(ye), _fma_f32(c_norm, cmax(yy), delta)))
    return band.repeat_interleave(B1_CHUNK, dim=2)[:, :, :bc]


def certified_count_walk(pts, mask, row_ptr, cols, eps2, tile, centers,
                         rnorm=None):
    """Plain emulation of B1's tensor-core kernel in its exact modes
    (``csrc/pair_kernels.cu``, ``b1_tc_kernel``, d <= 64): for every pair
    of the list, the cross term ``dot`` of the bf16-rounded operands
    recentred on the row tile's ``centers`` (nt, d) (as :func:`_fast_d2`),
    ``t = fl(|Y|^2 - 2 dot)`` and the band of :func:`b1_chunk_band`; a
    pair counts when ``|X|^2 + t < lo`` (``lo = eps2 - band`` rounded
    down) and not when ``|X|^2 + t > hi`` (``hi = eps2 + band`` rounded
    up), both in real arithmetic (bounds on ``t`` rounded outward, as the
    kernel takes them), and every other pair with a valid column is
    queued and decided by the exact axis-ordered d^2.  Returns
    ``(counts, rescored_pairs, fragile)``: counts (N,) int32, equal to
    :func:`counts_over_pairs`' when the band is sound, the queued pairs
    as a Python int, and the fragile pairs, which bound ``|kernel -
    emulation|`` of the queued count: pairs whose ``t`` lies within ``w``
    of a bound, with ``w`` as in :func:`certified_rescore_walk`, since the
    kernel sums the cross term in its own order.  With the row tiles' ``rnorm``
    (``"mixed"``) the first element is ``(counts, stats)``, ``stats``
    the (2,) int64 ``[band_pairs, rescored_tiles]`` of the reference
    band over the same ``d2f`` (those of :func:`counts_over_pairs_mixed`).
    The fit never calls this: the tests, the card checks and, on the
    CPU, the wrapper's ``rescored_pairs=`` do."""
    d, n = pts.shape
    nt = n // tile
    tiles = pts.reshape(d, nt, tile)
    vals = mask.reshape(nt, tile)
    out = torch.zeros((nt, tile), dtype=torch.int32, device=pts.device)
    rescored = n_fragile = 0
    n_band = torch.zeros((), dtype=torch.int64, device=pts.device)
    n_resc = torch.zeros((), dtype=torch.int64, device=pts.device)
    K = -(-d // 16) * 16
    u = 2.0**-24
    e2 = torch.tensor(eps2, dtype=torch.float32, device=pts.device)
    for _s, r, c in _batches(pts, row_ptr, cols, tile):
        xt, yt = tiles[:, r], tiles[:, c]
        ctr = centers[r].T[:, :, None]
        xc, yc = xt - ctr, yt - ctr
        dot = torch.bmm(bf16_round(xc).permute(1, 2, 0),
                        bf16_round(yc).permute(1, 0, 2))
        xx, _xn, xh, _xe = (v[:, :, None] for v in _cert_norms(xc))
        yy, _yn, yh, _ye = (v[:, None, :] for v in _cert_norms(yc))
        valid = vals[c] != 0
        band = b1_chunk_band(xc, yc, valid)
        # The kernel's t = fl(|Y|^2 - 2 dot) against the row's bounds:
        # |X|^2 + t < lo and > hi in real arithmetic.
        t = yy - 2.0 * dot
        lo = _fadd_dir(_fadd_dir(e2, -band, up=False), -xx, up=True)
        hi = _fadd_dir(_fadd_dir(e2, band, up=True), -xx, up=False)
        vcol = valid[:, None, :]
        cin = (t < lo) & vcol
        queued = ~(t < lo) & ~(t > hi) & vcol
        w = 1.25 * (2.0**-19 * K * (xh * yh).double()
                    + (2 * d + 12) * u * (xx + yy).double()
                    + (2 * d + 52) * u * band.double())
        n_fragile += int((vcol & (((t.double() - lo.double()).abs() <= w)
                                  | ((t.double() - hi.double()).abs()
                                     <= w))).sum())
        p, i, j = torch.nonzero(queued, as_tuple=True)
        step = max(1, _CHUNK_ELEMS // (4 * d))
        for q in range(0, int(p.numel()), step):
            pq, iq, jq = p[q:q + step], i[q:q + step], j[q:q + step]
            d2 = axis_sq(tiles[:, r[pq], iq] - tiles[:, c[pq], jq])
            cin[pq, iq, jq] = d2 <= eps2
        rescored += int(p.numel())
        out.index_add_(0, r, cin.sum(dim=-1, dtype=torch.int32))
        if rnorm is not None:
            # The reference's d2f of _fast_d2 and its band per entry.
            d2f = (xx + yy) - 2.0 * dot
            ny = torch.sqrt(torch.where(valid, yy[:, 0], 0.0).amax(dim=1))
            gy = torch.sqrt(torch.where(valid, axis_sq(yt), 0.0).amax(dim=1))
            bref = fast_band(rnorm[r, 0], ny, rnorm[r, 1], gy)
            st = (((d2f - eps2).abs() <= bref[:, None, None]) & vcol
                  & (vals[r] != 0)[:, :, None])
            n_band += st.sum()
            n_resc += st.flatten(1).any(dim=1).sum()
    counts = out.reshape(-1)
    if rnorm is not None:
        counts = (counts, torch.stack([n_band, n_resc]))
    return counts, rescored, n_fragile


# ---------------------------------------------------------------------------
# The amortized sweep's neighbour-pair graph: one emission at eps_max of
# every (i, j, dval) over the live pair list, re-thresholded per config
# (:func:`~.labels.graph_dbscan`).  ``dval`` is the pair passes' own
# arithmetic (:func:`_pair_d2`'s axis-ordered sum of separately rounded
# squares, or :func:`_pair_l1`), so ``dval <= threshold(eps_c)`` is the
# kernels' verdict at every config, bit for bit.
# ---------------------------------------------------------------------------


def sweep_max_edges() -> int:
    """Cap on the sweep graph, in edges (``PPTORCH_SWEEP_MAX_PAIRS``,
    default 2^26, 768 MiB at 12 bytes per edge).  Past it a sweep runs
    per-config fits instead: the graph is an amortization, never a
    correctness requirement."""
    return int(os.environ.get("PPTORCH_SWEEP_MAX_PAIRS", str(1 << 26)))


def default_edge_budget(n: int) -> int:
    """Default graph slab: 96 directed edges per row, at least 2^16, at
    most the sweep cap (a graph past the cap is never kept).  The
    emission returns the exact total, so one retry always suffices."""
    return min(max(1 << 16, 96 * n), max(1, sweep_max_edges()))


def neighbor_pair_graph(points, mask, eps, metric: str = "euclidean",
                        tile: int = 1024, budget: int | None = None,
                        pair_budget: int | None = None,
                        cap: int | None = None,
                        row_tiles: int | None = None):
    """Every ``(i, j, dval)`` with ``dval`` within eps over the live tile
    pairs, into a budgeted slab.

    ``points`` (d, N) float32, N a multiple of ``tile``; ``mask`` (N,)
    bool.  Self-pairs ride in the graph, as the passes count them.
    Returns ``(gi, gj, dval, stats)``: int32 / int32 / float32 slabs of
    ``budget`` entries in pair-list order (padding ``dval = +inf``,
    inert at any eps) and ``stats`` the exact ``[edge_total,
    edge_budget, tile_total, tile_budget]`` as Python ints.  Edges past
    the budget are counted but dropped: the graph is then invalid and
    the caller retries once with the exact total.  A tile list past its
    budget is extracted again at its exact total before any edge is
    emitted, so the edge total is always exact.  With ``cap`` the
    emission stops once the total passes it (the caller then gives the
    graph up): ``edge_total`` is only known to exceed ``cap`` then.
    ``row_tiles`` restricts the emitting rows to the first ``row_tiles``
    tiles (owner-computes: the owned prefix emits, boundary and halo
    slots are column evidence only); the tile totals stay the whole
    list's and the default ``budget`` sizes for the emitting rows.  One
    route: torch ops on the tensor's device.
    """
    d, n = points.shape
    nt = n // tile
    dev = points.device
    tiles = points.reshape(d, nt, tile).transpose(0, 1)
    msk = mask.reshape(nt, tile)
    lo, hi = tile_bounds(tiles, msk)
    if pair_budget is None:
        pair_budget = default_pair_budget(nt)
    pair_budget = min(int(pair_budget), nt * nt)
    rows, cols, tile_total = live_tile_pairs(lo, hi, eps, budget=pair_budget,
                                             metric=metric)
    if tile_total > pair_budget:
        pair_budget = min(-(-tile_total // 4096) * 4096, nt * nt)
        rows, cols, tile_total = live_tile_pairs(
            lo, hi, eps, budget=pair_budget, metric=metric
        )
    rt = nt if row_tiles is None else min(int(row_tiles), nt)
    if rt < nt:
        keep = rows < rt
        rows, cols = rows[keep], cols[keep]
    budget = (default_edge_budget(rt * tile) if budget is None
              else int(budget))
    gi = torch.zeros(budget, dtype=torch.int32, device=dev)
    gj = torch.zeros(budget, dtype=torch.int32, device=dev)
    dv = torch.full((budget,), float("inf"), dtype=torch.float32,
                    device=dev)
    thr = eps_threshold(eps, metric)
    dist = pair_dist(metric)
    pts_t = points.reshape(d, nt, tile)
    total = 0
    for _s, r, c in _batches(points, row_offsets(rows, nt), cols, tile):
        val = dist(pts_t[:, r], pts_t[:, c])
        live = (val <= thr) & msk[r][:, :, None] & msk[c][:, None, :]
        if total >= budget:
            # The slab is full: count only.
            total += int(live.sum())
        else:
            p, i, j = torch.nonzero(live, as_tuple=True)
            m = int(p.numel())
            keep = min(m, budget - total)
            p, i, j = p[:keep], i[:keep], j[:keep]
            gi[total:total + keep] = (r[p] * tile + i).int()
            gj[total:total + keep] = (c[p] * tile + j).int()
            dv[total:total + keep] = val[p, i, j]
            total += m
        if cap is not None and total > cap:
            break
    return gi, gj, dv, [total, budget, int(tile_total), int(pair_budget)]
