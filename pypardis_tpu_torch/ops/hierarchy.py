"""Density hierarchy over one cached neighbour-pair graph (counterpart
of ``pypardis_tpu/ops/hierarchy.py``).

The sweep's graph at a ceiling ``eps_max`` holds every ``(i, j, d2)``
pair within it, and so the whole DBSCAN family below the ceiling
(OPTICS, Ankerst et al. 1999).  HDBSCAN* (Campello et al. 2013) reduces
that family to a minimum spanning tree over mutual-reachability
distances plus a stability rule:

  ``mreach(i, j) = max(core_k(i), core_k(j), d(i, j))``

with ``core_k(p)`` the distance to p's ``min_samples``-th neighbour.
Cutting the MST at a threshold gives the core-core components of a
DBSCAN fit at that eps, so every cut, the condensed tree and the
excess-of-mass flat cut come out of the one graph without another
distance pass.

Everything runs in one id space (the fit's kernel slots) on the slab;
the caller maps labels back to input rows.  Thresholds are in the
kernels' frame (squared L2, or L1 for cityblock) and compare in float32
as :func:`~.labels.graph_dbscan` does, which is what makes
:meth:`Hierarchy.labels_at_thr` byte-identical to the relabel at the
same threshold:

* ``cd2(p) <= thr`` iff p has at least ``min_samples`` row entries
  within thr (the k-th smallest of its row), the relabel's
  ``max(counts, 1) >= min_samples`` core rule for ``min_samples >= 2``
  (``min_samples <= 1`` pins cd2 to 0, the self-count clamp);
* a candidate edge has ``mreach2 <= thr`` iff the pair is adjacent at
  thr and both ends are core at thr, so the thr-prefix components of
  the mutual-reachability graph are the core-core components; and
* any MST keeps each threshold's connectivity (Kruskal's prefix
  property), so a union-find over the MST edges with ``w <= thr``
  (about n edges instead of the pair list) gives the same min-core-id
  roots.

Where each stage runs: the sorts, segment reductions and scatters over
the slab (:func:`hierarchy_prepare`'s lexsort, the core pass,
Borůvka's per-round minimum per component, the union-finds and the
border attach) are torch ops on the slab's device, so a graph on the
card never goes through numpy.  Kruskal's merge forest and the
condensation walk about n MST edges in order, as the JAX package does,
on the host in numpy and Python.  Every output is bitwise the JAX
package's on the same slab: the ranks are a total order
(``lexsort((j, i, w))``), so the chosen edges do not depend on where a
stage ran.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .distances import INT_INF
from .labels import uf_hook, uf_resolve_dense

_I64_INF = int(np.iinfo(np.int64).max)


# ---------------------------------------------------------------------------
# threshold <-> user-eps frame maps
#
# The slab's values are in the kernel frame; a user's eps is in the
# driver frame for cosine and haversine.  The forward map is the fit's
# own round trip (float64 driver remap, then the float32 square), so a
# ladder eps chosen here re-thresholds to the intended prefix when a
# fit or a sweep config runs it.
# ---------------------------------------------------------------------------


def thr_from_user_eps(eps_u: float, frame: str) -> np.float32:
    """User-frame eps -> the float32 threshold the fit compares against."""
    if frame == "cityblock":
        return np.float32(eps_u)
    if frame == "cosine":
        e = np.float32(np.sqrt(2.0 * eps_u))
    elif frame == "haversine":
        e = np.float32(2.0 * np.sin(eps_u / 2.0))
    else:
        e = np.float32(eps_u)
    return e * e


def user_eps_from_thr(thr: float, frame: str) -> float:
    """Threshold -> user-frame eps (the float64 inverse of the remap)."""
    t = float(thr)
    if frame == "cityblock":
        return t
    if frame == "cosine":
        return t / 2.0
    if frame == "haversine":
        return float(2.0 * np.arcsin(min(np.sqrt(t) / 2.0, 1.0)))
    return float(np.sqrt(t))


# ---------------------------------------------------------------------------
# prepare + core distances
# ---------------------------------------------------------------------------


def _tensor(x, dtype, device=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` (numpy input lands on the CPU, or
    on ``device``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort(keys)`` in torch: stable sorts from the first key
    (least significant) to the last (primary).  Returns int64 indices."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _sync(device) -> None:
    """Wait for the card before reading a stage's clock."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def hierarchy_prepare(gi, gj, dval):
    """Sort-once slab state for the hierarchy: rows contiguous by
    ``gi`` and ascending ``dval`` within each row (two stable sorts, as
    ``np.lexsort((dv, gi))``), so the ``min_samples``-th smallest of a
    row is a direct index.  Returns ``(gi_s, gj_s, dv_s, starts,
    uniq)``: int64 / int64 / float32 on the slab's device, each row's
    first entry and its id."""
    gi = _tensor(gi, torch.int64)
    gj = _tensor(gj, torch.int64, gi.device)
    dv = _tensor(dval, torch.float32, gi.device)
    order = _lexsort([dv, gi])
    gi_s, gj_s, dv_s = gi[order], gj[order], dv[order]
    if gi_s.numel():
        brk = torch.nonzero(gi_s[1:] != gi_s[:-1]).flatten() + 1
        starts = torch.cat([brk.new_zeros(1), brk])
        uniq = gi_s[starts]
    else:
        starts = gi_s.new_empty(0)
        uniq = gi_s.new_empty(0)
    return gi_s, gj_s, dv_s, starts, uniq


def core_distances(state, mask, min_samples: int) -> torch.Tensor:
    """Per-point squared core distance from the prepared slab.

    ``cd2[p]`` is the ``min_samples``-th smallest dval of p's row
    (+inf when the row is shorter: never core below the ceiling), except
    that ``min_samples <= 1`` pins valid points to 0 (the self-count
    clamp makes every valid point core at any eps).  Padding (+inf)
    sorts to the tail of its row and can only select +inf.  Returns
    (n,) float32 on the slab's device."""
    gi_s, _gj_s, dv_s, starts, uniq = state
    mask = _tensor(mask, torch.bool, dv_s.device)
    n = mask.shape[0]
    ms = int(min_samples)
    cd2 = torch.full((n,), float("inf"), dtype=torch.float32,
                     device=dv_s.device)
    if ms <= 1:
        cd2[mask] = 0.0
        return cd2
    if starts.numel():
        ends = torch.cat([starts[1:], starts.new_full((1,), gi_s.numel())])
        has = (ends - starts) >= ms
        cd2[uniq[has]] = dv_s[starts[has] + (ms - 1)]
    cd2[~mask] = float("inf")
    return cd2


def core_distances_device(gi, gj, dval, mask, min_samples) -> torch.Tensor:
    """:func:`core_distances` from the unsorted slab in one shot (the
    JAX package's jitted twin): one lexsort and each entry's rank in
    its row (against the row's first entry, by ``searchsorted``) turn
    the k-th smallest into a single masked scatter-min.  Bitwise
    :func:`core_distances` on the same slab, on any device.
    :class:`~..dbscan.DBSCAN` does not call it: its slab is already
    prepared on the same device, and the core pass indexes that."""
    gi = _tensor(gi, torch.int64)
    dval = _tensor(dval, torch.float32, gi.device)
    mask = _tensor(mask, torch.bool, gi.device)
    n = mask.shape[0]
    ms = int(min_samples)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=gi.device)
    if ms <= 1:
        return torch.where(mask, torch.zeros_like(inf), inf)
    order = _lexsort([dval, gi])
    gi_s = gi[order]
    dv_s = dval[order]
    first = torch.searchsorted(gi_s, gi_s, side="left")
    rank = torch.arange(gi_s.shape[0], device=gi.device) - first
    hit = rank == (ms - 1)
    # Slot n takes the non-hits; the clamp keeps the scatter in range.
    tgt = torch.where(hit, torch.clamp(gi_s, 0, n), n)
    cd2 = torch.full((n + 1,), float("inf"), dtype=torch.float32,
                     device=gi.device).scatter_reduce(
        0, tgt, torch.where(hit, dv_s, inf), reduce="amin")[:n]
    return torch.where(mask, cd2, inf)


# ---------------------------------------------------------------------------
# mutual-reachability MST: Borůvka rounds over the pair list
# ---------------------------------------------------------------------------


def mutual_reachability_mst(state, cd2, n: int):
    """Borůvka MST over the mutual-reachability graph.

    Candidate edges are the canonical (i < j) half of the slab with
    ``w = max(cd2[i], cd2[j], dval)`` finite (padding and edges touching
    never-core points drop out).  Each edge's rank is its place in
    ``lexsort((j, i, w))``, a total order, so each component's least
    incident edge is unique and the chosen set has no cycle.  Each round
    is a scatter-min of ranks per component and a union-find contraction
    (:func:`~.labels.uf_hook`; min-id roots); edges inside a component
    leave the round.

    Returns ``(mi, mj, mw, info)`` on the slab's device, ascending by
    rank, with ``info`` carrying ``boruvka_rounds``, ``n_live``,
    ``n_components``, ``candidate_edges`` and ``round_cap`` (the
    ``ceil(log2(C0)) + 1`` bound on the rounds)."""
    gi_s, gj_s, dv_s, _starts, _uniq = state
    dev = dv_s.device
    cd2 = _tensor(cd2, torch.float32, dev)
    w = torch.maximum(dv_s, torch.maximum(cd2[gi_s], cd2[gj_s]))
    sel = (gi_s < gj_s) & torch.isfinite(w)
    mi, mj, mw = gi_s[sel], gj_s[sel], w[sel]
    order = _lexsort([mj, mi, mw])
    mi, mj, mw = mi[order], mj[order], mw[order]
    m = int(mi.shape[0])
    live_ids = torch.unique(torch.cat([mi, mj])) if m else mi
    n_live = int(live_ids.shape[0])
    chosen = torch.zeros(m, dtype=torch.bool, device=dev)
    lab = torch.arange(int(n), dtype=torch.int64, device=dev)
    # Candidates still joining two components (by rank).
    cand = torch.arange(m, dtype=torch.int64, device=dev)
    rounds = 0
    c0 = 0
    while cand.numel():
        a = lab[mi[cand]]
        b = lab[mj[cand]]
        live = a != b
        if not bool(live.any()):
            break
        cand, a, b = cand[live], a[live], b[live]
        if rounds == 0:
            c0 = int(torch.unique(torch.cat([a, b])).shape[0])
        rounds += 1
        best = torch.full((int(n),), _I64_INF, dtype=torch.int64,
                          device=dev)
        best.scatter_reduce_(0, a, cand, reduce="amin")
        best.scatter_reduce_(0, b, cand, reduce="amin")
        new = torch.unique(best[best < _I64_INF])
        chosen[new] = True
        # The forest so far plus this round's edges: the same min-id
        # roots as resolving every chosen edge from scratch.
        lab = uf_hook(lab, mi[new], mj[new])
    idx = torch.nonzero(chosen).flatten()
    n_components = (
        int(torch.unique(lab[live_ids]).shape[0]) if n_live else 0
    )
    info = {
        "mst_edges": int(idx.shape[0]),
        "boruvka_rounds": int(rounds),
        "round_cap": int(np.ceil(np.log2(max(c0, 2)))) + 1,
        "n_live": n_live,
        "n_components": n_components,
        "candidate_edges": m,
    }
    return mi[idx], mj[idx], mw[idx], info


# ---------------------------------------------------------------------------
# dendrogram: Kruskal merge forest -> condensed tree -> stability (host)
# ---------------------------------------------------------------------------


def _host(x, dtype) -> np.ndarray:
    """A tensor or array as a numpy array of ``dtype`` on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _merge_forest(mi, mj, mw, n: int):
    """Kruskal merge sequence over the MST edges (ascending (w, i, j)),
    on the host.

    Returns ``(left, right, weight, size, roots)``: internal node t has
    id ``n + t``; ``roots`` are the forest's final node ids (one per
    connected component of the mutual-reachability graph), ascending."""
    mi, mj = _host(mi, np.int64), _host(mj, np.int64)
    mw = _host(mw, np.float32)
    order = np.lexsort((mj, mi, mw))
    ei, ej, ew = mi[order], mj[order], mw[order]
    m = len(ei)
    parent = list(range(int(n)))
    node = list(range(int(n)))
    size = [1] * int(n)

    def find(x: int) -> int:
        # Path halving: the same roots as full compression.
        while parent[x] != x:
            parent[x] = x = parent[parent[x]]
        return x

    left = [0] * m
    right = [0] * m
    msize = [0] * m
    for t, (a, b) in enumerate(zip(ei.tolist(), ej.tolist())):
        while parent[a] != a:
            parent[a] = a = parent[parent[a]]
        while parent[b] != b:
            parent[b] = b = parent[parent[b]]
        left[t], right[t] = node[a], node[b]
        msize[t] = size[a] + size[b]
        parent[b] = a
        size[a] += size[b]
        node[a] = n + t
    roots = sorted({
        node[find(p)] for p in np.unique(np.concatenate([ei, ej])).tolist()
    }) if m else []
    return (np.asarray(left, np.int64), np.asarray(right, np.int64),
            ew.astype(np.float64), np.asarray(msize, np.int64), roots)


class _Cluster:
    """One condensed cluster: alive for ``thr in [end_w, birth_w)``."""

    __slots__ = (
        "cid", "parent", "birth_w", "end_w", "size", "exits",
        "children", "stability",
    )

    def __init__(self, cid, parent, birth_w, size):
        self.cid = cid
        self.parent = parent
        self.birth_w = birth_w
        self.end_w = 0.0
        self.size = size
        self.exits: List[Tuple[float, int]] = []
        self.children: List[int] = []
        self.stability = 0.0


class Hierarchy:
    """Condensed density hierarchy and flat-cut machinery over one slab.

    Built by :func:`build_hierarchy`.  ``state``, ``mask``, ``cd2`` and
    the MST ``(mi, mj, mw)`` are tensors on the slab's device; the
    condensed clusters live on the host.  :meth:`labels_at_thr` is the
    per-cut path (a union-find over about n MST edges and one border
    attach over the slab), byte-identical to
    :func:`~.labels.graph_dbscan` at the same threshold and
    min_samples."""

    def __init__(self, state, mask, n, min_samples, kernel_metric,
                 user_frame, thr_max, cd2, mst, info):
        self.state = state
        dev = state[2].device
        self.mask = _tensor(mask, torch.bool, dev)
        self.n = int(n)
        self.min_samples = int(min_samples)
        self.kernel_metric = kernel_metric
        self.user_frame = user_frame
        self.thr_max = float(thr_max)
        self.cd2 = _tensor(cd2, torch.float32, dev)
        self.mi, self.mj, self.mw = mst
        self._mw_host = _host(self.mw, np.float32)
        self.info = dict(info)
        self.clusters: List[_Cluster] = []
        self.selected: List[int] = []
        self._lambda_floor = 1e-12

    # -- flat labels -----------------------------------------------------

    def labels_at_thr(self, thr):
        """Flat labels at a float32 threshold (slab id space), on the
        slab's device.

        The relabel's fixpoint at this hierarchy's min_samples (the MST
        weights carry its core distances): core by core distance (the
        counts rule), components by a union-find over the MST's
        thr-prefix (the core-core components), min-core-id roots,
        borders to the least adjacent core root.  Returns ``(labels,
        core)``: (n,) int32 and bool tensors; the caller unscatters."""
        gi_s, gj_s, dv_s, starts, _uniq = self.state
        dev = dv_s.device
        t = torch.tensor(float(np.float32(thr)), dtype=torch.float32,
                         device=dev)
        if self.min_samples <= 1:
            core = self.mask.clone()
        else:
            core = (self.cd2 <= t) & self.mask
        sel = self.mw <= t
        roots = uf_resolve_dense(
            torch.stack([self.mi[sel], self.mj[sel]], dim=1), self.n
        )
        inf = torch.tensor(INT_INF, dtype=torch.int64, device=dev)
        f = torch.where(core, roots, inf)
        border = torch.full((self.n,), INT_INF, dtype=torch.int64,
                            device=dev)
        if starts.numel():
            cand = torch.where((dv_s <= t) & core[gj_s], f[gj_s], inf)
            border.scatter_reduce_(0, gi_s, cand, reduce="amin")
        labels = torch.where(
            core, f,
            torch.where(self.mask & (border != INT_INF), border, -1),
        ).to(torch.int32)
        return labels, core

    # -- condensation ----------------------------------------------------

    def _lam(self, w: float, birth: bool = False) -> float:
        """HDBSCAN*'s lambda = 1 / distance, in the user frame.

        Duplicate points give zero-distance merges; the floor (half the
        least positive distance in the tree) keeps lambda finite without
        reordering any comparison.  Birth weights clamp at the graph
        ceiling: the family is truncated there, so a root component's
        stability starts at the ceiling."""
        if birth:
            w = min(w, self.thr_max)
        d = user_eps_from_thr(w, self.user_frame)
        return 1.0 / max(d, self._lambda_floor)

    def condense(self, min_cluster_size: int) -> None:
        """Condense the merge forest by ``min_cluster_size``, score every
        condensed cluster with the excess-of-mass stability ``sum_p
        (lambda_exit(p) - lambda_birth)``, and run the EOM selection
        bottom-up (a cluster beats its subtree iff its own stability is
        at least the sum of its children's winning subtrees).  Host
        numpy and Python, in the JAX package's order of operations."""
        mcs = int(min_cluster_size)
        left, right, weight, msize, roots = _merge_forest(
            self.mi, self.mj, self.mw, self.n
        )
        # user_eps_from_thr is non-decreasing in every frame, so the
        # least positive distance is the map of the least positive
        # weight.
        pos = weight[weight > 0]
        self._lambda_floor = (
            0.5 * user_eps_from_thr(pos.min(), self.user_frame)
            if len(pos) else 1e-12
        )
        self.clusters = []
        n = self.n
        left_l, right_l = left.tolist(), right.tolist()
        weight_l, msize_l = weight.tolist(), msize.tolist()

        def nsize(node: int) -> int:
            return 1 if node < n else msize_l[node - n]

        stack: List[Tuple[int, int]] = []  # (tree node, cluster idx)
        for r in roots:
            if nsize(r) < mcs:
                continue
            c = _Cluster(len(self.clusters), None, np.inf, nsize(r))
            self.clusters.append(c)
            stack.append((r, c.cid))
        while stack:
            node, cid = stack.pop()
            c = self.clusters[cid]
            while True:
                if node < n:
                    # mcs >= 2: a bare leaf only comes from a one-point
                    # component, closed above.
                    c.end_w = 0.0
                    break
                t = node - n
                a, b = left_l[t], right_l[t]
                sa, sb = nsize(a), nsize(b)
                w = weight_l[t]
                if sa >= mcs and sb >= mcs:
                    c.end_w = w
                    for child in (a, b):
                        cc = _Cluster(
                            len(self.clusters), cid, w, nsize(child)
                        )
                        c.children.append(cc.cid)
                        self.clusters.append(cc)
                        stack.append((child, cc.cid))
                    break
                if sa < mcs and sb < mcs:
                    c.exits.append((w, sa + sb))
                    c.end_w = w
                    break
                keep, drop = (a, b) if sa >= mcs else (b, a)
                c.exits.append((w, nsize(drop)))
                node = keep
        for c in self.clusters:
            lb = self._lam(c.birth_w, birth=True)
            c.stability = sum(
                (self._lam(w) - lb) * cnt for w, cnt in c.exits
            )
            for ch in c.children:
                c.stability += (
                    self._lam(self.clusters[ch].birth_w) - lb
                ) * self.clusters[ch].size
        # EOM bottom-up: children were appended after their parent, so
        # the reverse construction order is leaves first.
        subtree = [0.0] * len(self.clusters)
        wins = [False] * len(self.clusters)
        for c in reversed(self.clusters):
            kids = sum(subtree[ch] for ch in c.children)
            if not c.children or c.stability >= kids:
                wins[c.cid] = True
                subtree[c.cid] = c.stability
            else:
                subtree[c.cid] = kids
        self.selected = []
        blocked = [False] * len(self.clusters)
        for c in self.clusters:  # top-down: parents precede children
            if blocked[c.cid] or not wins[c.cid]:
                continue
            self.selected.append(c.cid)
            desc = list(c.children)
            while desc:
                d = desc.pop()
                blocked[d] = True
                desc.extend(self.clusters[d].children)
        self.info["condensed_clusters"] = len(self.clusters)
        self.info["selected_clusters"] = len(self.selected)
        self.info["stability_total"] = round(
            float(sum(self.clusters[c].stability for c in self.selected)),
            6,
        )

    # -- flat-cut selection ---------------------------------------------

    def _cut_candidates(self) -> np.ndarray:
        ws = np.unique(self._mw_host.astype(np.float64))
        ws = ws[np.isfinite(ws)]
        return np.append(ws, self.thr_max) if len(ws) else np.asarray(
            [self.thr_max]
        )

    def cut_scores(self) -> List[Tuple[float, float]]:
        """``(thr, score)`` per candidate cut: the summed stability of
        the selected clusters alive at thr (``end_w <= thr < birth_w``;
        labels are constant between consecutive distinct MST weights, so
        these are all the family's distinct cuts).  A sweep line over
        birth and death events."""
        cands = self._cut_candidates()
        add = np.zeros(len(cands), np.float64)
        if self.selected:
            ends = np.asarray(
                [self.clusters[c].end_w for c in self.selected]
            )
            births = np.asarray(
                [self.clusters[c].birth_w for c in self.selected]
            )
            stabs = np.asarray(
                [self.clusters[c].stability for c in self.selected]
            )
            on = np.searchsorted(cands, ends, side="left")
            off = np.searchsorted(cands, births, side="left")
            np.add.at(add, on[on < len(cands)], stabs[on < len(cands)])
            np.subtract.at(
                add, off[off < len(cands)], stabs[off < len(cands)]
            )
        scores = np.cumsum(add)
        return [(float(t), float(s)) for t, s in zip(cands, scores)]

    def select_cut(self) -> Tuple[float, float]:
        """The stability-selected flat cut: ``(thr_star, eps_user)``.

        Argmax of :meth:`cut_scores`, ties toward the larger threshold
        (fewer noise points for equal stability mass).  The eps is a
        user-frame value whose fit round trip lands in ``[thr_star,
        next distinct weight)`` (:meth:`_interval_eps`)."""
        cands = self._cut_candidates()
        scores = self.cut_scores()
        best_thr, best_s = scores[0]
        for thr, s in scores[1:]:
            if s > best_s or (s == best_s and thr > best_thr):
                best_thr, best_s = thr, s
        self.info["cut_thr"] = float(best_thr)
        self.info["cut_score"] = round(float(best_s), 6)
        nxt = cands[cands > best_thr]
        hi = float(nxt[0]) if len(nxt) else float(
            np.nextafter(np.float32(best_thr), np.float32(np.inf))
        )
        return float(best_thr), self._interval_eps(best_thr, hi)

    def _interval_eps(self, lo: float, hi: float) -> float:
        """A user-frame eps whose round trip lands in ``[lo, hi)``: the
        float64 midpoint when the interval holds one (at least 4 ulps),
        else the exact lower boundary (a slab weight, so representable).
        Labels are constant on the interval, so any such eps names the
        same clustering."""
        wide = (hi - lo) >= 4 * float(
            np.spacing(np.float32(max(lo, 1e-30)))
        )
        if wide:
            mid = 0.5 * (lo + hi)
            eps_u = user_eps_from_thr(mid, self.user_frame)
            rt = float(thr_from_user_eps(eps_u, self.user_frame))
            if lo <= rt < hi:
                return eps_u
        return user_eps_from_thr(lo, self.user_frame)

    def eps_ladder(self, k: int) -> List[float]:
        """The top-``k``-stability eps ladder of ``sweep(eps_list=
        "auto")``: candidate cuts ranked by :meth:`cut_scores` (ties
        toward the larger thr), each mapped to a round-trip-safe user
        eps, deduplicated, ascending.  Fewer than k distinct cuts return
        what exists."""
        cands = self._cut_candidates()
        ranked = sorted(
            self.cut_scores(), key=lambda ts: (-ts[1], -ts[0])
        )
        out: List[float] = []
        for thr, _s in ranked:
            if len(out) >= int(k):
                break
            nxt = cands[cands > thr]
            hi = float(nxt[0]) if len(nxt) else float(
                np.nextafter(np.float32(thr), np.float32(np.inf))
            )
            eps_u = self._interval_eps(thr, hi)
            if eps_u > 0 and eps_u not in out:
                out.append(eps_u)
        return sorted(out)

    def telemetry(self) -> Dict:
        """The hierarchy block's body (the caller adds the route and
        timing fields it owns)."""
        return dict(self.info)


def build_hierarchy(
    state,
    mask,
    n: int,
    min_samples: int,
    *,
    kernel_metric: str = "euclidean",
    user_frame: str = "euclidean",
    thr_max: float,
    min_cluster_size: Optional[int] = None,
) -> Hierarchy:
    """Core distances, the Borůvka MST and the condensed tree in one call.

    ``state`` comes from :func:`hierarchy_prepare` on the slab's device,
    whose core pass (:func:`core_distances`) indexes the prepared rows;
    ``thr_max`` is the graph ceiling as a threshold.
    ``min_cluster_size`` (>= 2; :class:`~..dbscan.DBSCAN` validates it)
    defaults to ``max(min_samples, 2)``.  ``info`` carries each stage's
    seconds (``core_pass_s``, ``mst_s``, ``condense_s``; the card is
    synchronised before each clock read)."""
    mcs = (
        max(int(min_samples), 2) if min_cluster_size is None
        else int(min_cluster_size)
    )
    dev = state[2].device
    t0 = time.perf_counter()
    cd2 = core_distances(state, mask, min_samples)
    _sync(dev)
    t1 = time.perf_counter()
    mi, mj, mw, info = mutual_reachability_mst(state, cd2, n)
    _sync(dev)
    t2 = time.perf_counter()
    h = Hierarchy(
        state, mask, n, min_samples, kernel_metric, user_frame,
        thr_max, cd2, (mi, mj, mw), info,
    )
    h.condense(mcs)
    t3 = time.perf_counter()
    h.info["min_cluster_size"] = mcs
    h.info["core_pass_s"] = round(t1 - t0, 6)
    h.info["mst_s"] = round(t2 - t1, 6)
    h.info["condense_s"] = round(t3 - t2, 6)
    return h
