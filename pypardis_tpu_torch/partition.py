"""Spatial partitioning on the host (counterpart of
``pypardis_tpu/partition.py``).

* Morton planning and bit interleave (:func:`morton_plan`,
  :func:`interleave_bit_words`), shared with the device layout;
* the host Morton sort (:func:`morton_codes`, :func:`spatial_order`);
* the split strategies and :class:`KDPartitioner` (the node-at-a-time
  builder), with tree replay for routing (:func:`route_tree`) and the
  eps-widened replay the serving index routes queries by
  (:func:`expanded_members`);
* the global Morton range split: in RAM (:func:`morton_range_split`)
  and as an external sample-sort over row chunks with an on-disk spill
  (:func:`morton_range_split_streaming`, :class:`MortonStreamSplit`),
  the products the global-Morton route reads, and
  :class:`MortonRangePartitioner`, its ranges as a partitioner.

Everything here must stay byte-identical to the JAX package: the bit
packing fixes the sort order and with it the cluster numbering, and the
KD tree fixes which leaf slab a core point lands in.  Numpy reductions
can differ in the last ulp between memory layouts, so the partitioner
keeps its points C-contiguous, as the reference does.  The streaming
split's multi-process spill belongs to the process layer (ROADMAP A10's
rest).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from .geometry import BoundingBox, BoxStack
from .utils.validate import check_query_points

_VALID_SPLIT_METHODS = ("min_var", "rotation", "mean_var", "median_search")


def median_search_split(values: np.ndarray):
    """Exact-median boundary along one axis: ``(below_mask, boundary)``
    with left ``< boundary`` and right ``>= boundary``."""
    boundary = float(np.median(values))
    below = values < boundary
    return below, boundary


def mean_var_split(values: np.ndarray, mean: float = None,
                   variance: float = None):
    """Approximate-median boundary from moments: of the 7 candidates
    ``mean + j*0.3*sigma`` (j in -3..3), the one with the smallest
    ``|#below - #above|``.  Returns ``(below_mask, boundary)``."""
    if mean is None:
        mean = float(values.mean())
    if variance is None:
        variance = float(values.var())
    std = np.sqrt(variance)
    candidates = mean + np.arange(-0.9, 0.91, 0.3) * std
    below_counts = (values[:, None] < candidates[None, :]).sum(axis=0)
    balance = np.abs(2 * below_counts - len(values))
    boundary = float(candidates[int(np.argmin(balance))])
    below = values < boundary
    return below, boundary


def min_var_split(points: np.ndarray):
    """The max-variance axis, then a :func:`mean_var_split` boundary on
    it.  Returns ``(axis, below_mask, boundary)``."""
    mean = points.mean(axis=0)
    var = points.var(axis=0)
    axis = int(np.argmax(var))
    below, boundary = mean_var_split(
        points[:, axis], mean=float(mean[axis]), variance=float(var[axis])
    )
    return axis, below, boundary


def morton_plan(d: int):
    """(axes_used, bits_per_axis) for a <=128-bit Morton code: every
    axis up to d=32 (the top-variance axes beyond that) with >= 4 bits
    each, and up to 16 bits for low d."""
    k = min(d, 32)
    if k == 0:  # (N, 0) points: one all-zero word, any order is spatial
        return 0, 0
    bits = max(4, min(16, 128 // k))
    return k, bits


def interleave_bit_words(q_axes, bits: int, word_bits: int, zeros, shift):
    """MSB-first bit interleave of per-axis quantized values into words.

    ``q_axes``: sequence of k integer arrays; ``zeros()``: a fresh
    all-zero word array; ``shift(v)``: the int ``v`` in the word type.
    Code bit e lands in word ``e // word_bits``; the leading word is
    left-padded when ``bits * k % word_bits != 0``.  Returns the word
    list, most significant first — always at least one word.  With
    torch int64 words of ``word_bits=32`` each word holds an unsigned
    32-bit value.
    """
    k = len(q_axes)
    total = bits * k
    n_words = max(1, -(-total // word_bits))
    words = [zeros() for _ in range(n_words)]
    one = shift(1)
    emitted = n_words * word_bits - total
    for b in range(bits - 1, -1, -1):
        for a in range(k):
            w = emitted // word_bits
            bit = (q_axes[a] >> shift(b)) & one
            words[w] = (words[w] << one) | bit
            emitted += 1
    return words


def _morton_quantize_words(points: np.ndarray, lo, span, bits: int):
    """Quantize an (M, k) array against a fixed ``(lo, span)`` frame and
    interleave into uint64 words, most significant first."""
    k = points.shape[1]
    if k == 0 or bits == 0:
        return [np.zeros(len(points), dtype=np.uint64)]
    q = np.minimum(
        ((points - lo) / span * (1 << bits)).astype(np.uint64),
        (1 << bits) - 1,
    )
    return interleave_bit_words(
        [q[:, a] for a in range(k)],
        bits,
        64,
        lambda: np.zeros(len(points), dtype=np.uint64),
        np.uint64,
    )


def morton_codes(points: np.ndarray):
    """Morton (Z-order) code words of (N, k) points: uint64 arrays,
    most significant first, jointly holding the <=128-bit code of
    :func:`morton_plan`, quantized per axis over the data's range."""
    points = np.asarray(points)
    if points.dtype not in (np.float32, np.float64):
        points = points.astype(np.float64)
    if points.ndim != 2:
        raise ValueError(f"points must be (N, k), got {points.shape}")
    k, bits = morton_plan(points.shape[1])
    if points.shape[1] > k:
        axes = np.argsort(points.var(axis=0))[::-1][:k]
        points = points[:, np.sort(axes)]
    if k == 0:
        return [np.zeros(len(points), dtype=np.uint64)]
    lo = points.min(axis=0)
    # The floor must not underflow the input dtype (1e-300 is 0 in
    # float32, which made all-equal axes divide by zero).
    span = np.maximum(points.max(axis=0) - lo, np.finfo(points.dtype).tiny)
    return _morton_quantize_words(points, lo, span, bits)


def spatial_order(points: np.ndarray) -> np.ndarray:
    """Index permutation sorting points along the Morton curve, so that
    contiguous blocks of the permuted layout have tight boxes."""
    points = np.asarray(points)
    if len(points) <= 1:
        return np.arange(len(points))
    words = morton_codes(points)
    if len(words) == 1:
        return np.argsort(words[0], kind="stable")
    return np.lexsort(words[::-1])  # np.lexsort: last key is primary


def expanded_members(tree, points: np.ndarray, margin: float):
    """Membership of every point in every margin-expanded leaf box, by
    replaying the split tree with widened comparisons: at each split a
    point goes left when ``x <= boundary + margin`` and right when
    ``x >= boundary - margin`` — both inside the band.

    Returns ``{label: (member_idx, owned_mask)}``; ``owned_mask`` marks
    the members the leaf owns under the partitioner's strict ``<``.
    """
    points = np.asarray(points)
    n = len(points)
    state = {0: (np.arange(n, dtype=np.int32), np.ones(n, dtype=bool))}
    for parent, axis, boundary, _left, right in tree:
        arr, own = state.pop(int(parent))
        c = points[arr, int(axis)].astype(np.float64, copy=False)
        lsel = c <= boundary + margin
        rsel = c >= boundary - margin
        state[int(parent)] = (arr[lsel], own[lsel] & (c[lsel] < boundary))
        state[int(right)] = (arr[rsel], own[rsel] & (c[rsel] >= boundary))
    return state


def route_tree(tree, points: np.ndarray) -> np.ndarray:
    """Leaf label of every point, by replaying a split tree of
    ``(parent, axis, boundary, left, right)`` rows in construction
    order (left keeps the parent's label; ``>= boundary`` goes right).
    Raises ValueError for points narrower than the tree's split axes or
    with NaN/inf coordinates."""
    tree = list(tree)
    points = check_query_points(points).astype(np.float64, copy=False)
    if tree:
        need = max(int(a) for _p, a, _b, _l, _r in tree) + 1
        if points.shape[1] < need:
            raise ValueError(
                f"points have {points.shape[1]} dims but the split tree "
                f"routes on axis {need - 1}"
            )
    labels = np.zeros(len(points), dtype=np.int32)
    for parent, axis, boundary, _left, right in tree:
        mask = labels == int(parent)
        go_right = mask & (points[:, int(axis)] >= boundary)
        labels[go_right] = int(right)
    return labels


class KDPartitioner:
    """Binary-tree spatial partitioner over an in-memory (N, k) array.

    ``KDPartitioner(data, max_partitions, k, split_method, sample_size,
    seed)``; unknown split methods fall back to ``"min_var"``.  The tree
    grows breadth first, one node at a time: each split takes its
    boundary from the node's points (a ``sample_size`` subsample drawn
    from ``np.random.default_rng(seed)`` for larger nodes), the left
    child keeps the parent's label and the right child takes the next
    one; a degenerate boundary falls back to the exact median, and a
    node that still cannot split stays a leaf.

    Products: ``partitions`` {label: int32 point indices, ascending},
    ``bounding_boxes`` {label: BoundingBox}, ``result`` (N,) point ->
    label, and ``tree``, the ``(parent, axis, boundary, left, right)``
    rows that :func:`route_tree` replays.  They equal the JAX package's
    products under the same seed, for its ``"legacy"`` and ``"level"``
    builders alike.
    """

    def __init__(
        self,
        data,
        max_partitions: Optional[int] = None,
        k: Optional[int] = None,
        split_method: str = "min_var",
        sample_size: Optional[int] = 1_000_000,
        seed: int = 0,
    ):
        points = np.asarray(data)
        if points.dtype not in (np.float32, np.float64):
            points = points.astype(np.float64)
        if points.ndim != 2:
            raise ValueError(f"data must be (N, k), got shape {points.shape}")
        # Row gathers of an F-order array come back F-order, whose
        # reductions can differ in the last ulp from C-order ones.
        if not points.flags.c_contiguous:
            points = np.ascontiguousarray(points)
        self.points = points
        self.k = int(k) if k is not None else points.shape[1]
        self.split_method = (
            split_method if split_method in _VALID_SPLIT_METHODS
            else "min_var"
        )
        if max_partitions is None:
            max_partitions = min(4 ** self.k, 256)
        self.max_partitions = max(1, min(int(max_partitions), len(points)))
        self._sample_size = sample_size
        self._rng = np.random.default_rng(seed)

        # The global box, unioned over chunks as the reference does.
        chunk = 1 << 20
        global_box = BoundingBox(k=self.k)
        for s in range(0, len(points), chunk):
            e = min(s + chunk, len(points))
            global_box = global_box.union(
                BoundingBox(
                    lower=points[s:e].min(axis=0),
                    upper=points[s:e].max(axis=0),
                )
            )
        self.bounding_boxes: Dict[int, BoundingBox] = {}
        self.partitions: Dict[int, np.ndarray] = {}
        self.tree = []
        # The node-at-a-time breadth-first builder (the JAX package's
        # "legacy" one) and its per-level seconds, which a sharded fit
        # reports as partition_levels_s.
        self.builder = "legacy"
        self.level_times_s: list = []
        self._create_partitions(global_box)
        self.result = np.empty(len(points), dtype=np.int32)
        for label, idx in self.partitions.items():
            self.result[idx] = label

    def _split_subset(self, subset_idx: np.ndarray, depth: int):
        """(axis, boundary) of one node, from a subsample if large."""
        idx = subset_idx
        if self._sample_size is not None and len(idx) > self._sample_size:
            idx = self._rng.choice(idx, size=self._sample_size, replace=False)
        pts = self.points[idx]
        if self.split_method == "rotation":
            axis = depth % self.k
            _, boundary = mean_var_split(pts[:, axis])
        elif self.split_method == "mean_var":
            axis = int(np.argmax(pts.var(axis=0)))
            _, boundary = mean_var_split(pts[:, axis])
        elif self.split_method == "median_search":
            axis = int(np.argmax(pts.var(axis=0)))
            _, boundary = median_search_split(pts[:, axis])
        else:  # min_var
            axis, _, boundary = min_var_split(pts)
        return axis, boundary

    def _create_partitions(self, root_box: BoundingBox) -> None:
        all_idx = np.arange(len(self.points), dtype=np.int32)
        self.partitions = {0: all_idx}
        self.bounding_boxes = {0: root_box}
        next_label = 1
        todo = deque([(0, 0)])  # (label, depth)
        while todo and next_label < self.max_partitions:
            t_level = time.perf_counter()
            level = deque()
            while todo and next_label < self.max_partitions:
                label, depth = todo.popleft()
                idx = self.partitions[label]
                if len(idx) < 2:
                    continue
                axis, boundary = self._split_subset(idx, depth)
                below = self.points[idx, axis] < boundary
                left_idx, right_idx = idx[below], idx[~below]
                if len(left_idx) == 0 or len(right_idx) == 0:
                    _, boundary = median_search_split(self.points[idx, axis])
                    below = self.points[idx, axis] < boundary
                    left_idx, right_idx = idx[below], idx[~below]
                    if len(left_idx) == 0 or len(right_idx) == 0:
                        continue
                left_box, right_box = self.bounding_boxes[label].split(
                    axis, boundary
                )
                right_label = next_label
                next_label += 1
                self.partitions[label] = left_idx
                self.partitions[right_label] = right_idx
                self.bounding_boxes[label] = left_box
                self.bounding_boxes[right_label] = right_box
                self.tree.append((label, axis, boundary, label, right_label))
                level.append((label, depth + 1))
                level.append((right_label, depth + 1))
            todo.extend(level)
            self.level_times_s.append(time.perf_counter() - t_level)

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def box_stack(self) -> BoxStack:
        """The partition boxes in label order as one :class:`BoxStack`."""
        labels = sorted(self.bounding_boxes)
        return BoxStack.from_boxes(self.bounding_boxes[l] for l in labels)

    def partition_sizes(self) -> np.ndarray:
        labels = sorted(self.partitions)
        return np.array([len(self.partitions[l]) for l in labels])

    def route(self, points: np.ndarray) -> np.ndarray:
        """Leaf labels of new points by replaying the split tree
        (validated against ``k`` and for finiteness)."""
        check_query_points(points, self.k)
        return route_tree(self.tree, points)


# ---------------------------------------------------------------------------
# the global Morton range split
# ---------------------------------------------------------------------------


def _tile_boxes_inram(sub: np.ndarray, order: np.ndarray, block: int):
    """(nt, k) per-tile float32 bounding boxes of the sorted layout."""
    n, k = sub.shape
    nt = -(-n // block)
    lo = np.empty((nt, k), np.float32)
    hi = np.empty((nt, k), np.float32)
    step = max(1, (1 << 22) // max(block, 1))
    for t0 in range(0, nt, step):
        t1 = min(t0 + step, nt)
        rows = sub[order[t0 * block:t1 * block]]
        pad = (t1 - t0) * block - len(rows)
        if pad:
            rows = np.concatenate([rows, np.full((pad, k), rows[-1])])
        tiles = rows.reshape(t1 - t0, block, k)
        lo[t0:t1] = tiles.min(axis=1)
        hi[t0:t1] = tiles.max(axis=1)
    return lo, hi


def _weights_from_boxes(lo: np.ndarray, hi: np.ndarray, eps: float,
                        max_cols: int = 4096) -> np.ndarray:
    """Per-tile live-column counts from (nt, k) tile boxes: the tiled
    passes' cost model, shared by the in-RAM and the streaming splits so
    their work-balanced cuts are the same whichever built the boxes.
    Past ``max_cols`` tiles the columns are sampled on an even stride and
    the count scaled back.  The gap broadcast is chunked along rows only
    (~8M elements at a time), so ``w`` does not depend on the chunk."""
    nt, k = lo.shape
    stride = max(1, -(-nt // max_cols))
    clo, chi = lo[::stride], hi[::stride]
    eps2 = np.float32(eps) ** 2
    w = np.zeros(nt)
    chunk = max(1, (1 << 23) // max(len(clo) * k, 1))
    for s in range(0, nt, chunk):
        e = min(s + chunk, nt)
        gap = np.maximum(
            0.0,
            np.maximum(clo[None] - hi[s:e, None], lo[s:e, None] - chi[None]),
        )
        w[s:e] = (np.sum(gap * gap, axis=-1) <= eps2).sum(axis=1)
    return w * stride


def _morton_range_weights(sub: np.ndarray, order: np.ndarray, block: int,
                          eps: float, max_cols: int = 4096) -> np.ndarray:
    """Per-tile work estimate of the sorted layout: each row tile's live
    (box gap <= eps) column tiles (:func:`_weights_from_boxes`)."""
    lo, hi = _tile_boxes_inram(sub, order, block)
    return _weights_from_boxes(lo, hi, eps, max_cols)


# Rows per float64 partial sum of the dataset mean.  Both splits sum in
# these groups: floating-point summation depends on its grouping, and
# the recentred float32 frame (every slab row and sort key) on the mean.
_CENTER_CHUNK = 1 << 20


def _chunked_center(points, n: int, k: int,
                    chunk: int = _CENTER_CHUNK) -> np.ndarray:
    """The float64 dataset mean, accumulated ``chunk`` rows at a time."""
    acc = np.zeros(k, np.float64)
    for s in range(0, n, chunk):
        acc += np.sum(points[s:min(s + chunk, n)], axis=0, dtype=np.float64)
    return acc / max(n, 1)


def _balanced_starts(w: np.ndarray, n: int, block: int, n_ranges: int,
                     slack: float = 1.5) -> np.ndarray:
    """Range boundaries that equalise cumulative tile work: greedy cuts
    at the weights' quantiles, on tile boundaries, with no range above
    ``slack`` times the equal share of tiles (every range's slab is
    padded to the largest)."""
    nt = len(w)
    cw = np.concatenate([[0.0], np.cumsum(w)])
    max_t = max(1, int(np.ceil(slack * nt / n_ranges)))
    starts_t = np.zeros(n_ranges + 1, dtype=np.int64)
    starts_t[n_ranges] = nt
    prev = 0
    for j in range(1, n_ranges):
        tgt = cw[-1] * j / n_ranges
        t = int(np.searchsorted(cw, tgt))
        if t > 0 and cw[t] - tgt > tgt - cw[t - 1]:
            t -= 1
        t = max(t, prev, nt - (n_ranges - j) * max_t)
        t = min(t, nt, prev + max_t)
        starts_t[j] = prev = t
    return np.minimum(starts_t * block, n)


def _range_starts(w_fn, n: int, n_ranges: int, eps, block) -> np.ndarray:
    """Work-balanced starts from ``w_fn()``'s tile weights when ``eps``
    and ``block`` are given, else equal ``ceil(n / n_ranges)``-row
    ranges."""
    if eps is not None and block is not None and n_ranges > 1 and n:
        return _balanced_starts(w_fn(), n, int(block), n_ranges)
    per = -(-n // n_ranges)
    return np.minimum(np.arange(n_ranges + 1, dtype=np.int64) * per, n)


def morton_range_split(points: np.ndarray, n_ranges: int,
                       chunk: int = 1 << 20, eps: float = None,
                       block: int = None):
    """The global Morton order and its split into contiguous ranges: each
    range is owned by one slab, so every point is clustered exactly once.

    The order is taken in the recentred float32 frame (the float64 mean,
    :func:`_chunked_center`, subtracted, then cast), the frame the slabs
    are built in.  With ``eps`` and ``block`` the cuts equalise estimated
    work (:func:`_morton_range_weights`, :func:`_balanced_starts`), else
    rows.  Every contiguous split gives the same labels: balance is a
    speed property.  This path holds one float32 copy of the data and the
    (N,) permutation; data that does not fit takes
    :func:`morton_range_split_streaming`, which gives the same order,
    starts and centre.  Returns ``(order, starts, center)``: (N,) int32,
    (n_ranges + 1,) int64 and (k,) float64."""
    points = np.asarray(points)
    n, k = points.shape
    n_ranges = max(1, int(n_ranges))
    center = _chunked_center(points, n, k)
    sub = np.empty((n, k), np.float32)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        np.subtract(points[s:e], center, out=sub[s:e], casting="unsafe")
    order = np.asarray(spatial_order(sub), dtype=np.int32)
    starts = _range_starts(
        lambda: _morton_range_weights(sub, order, int(block), float(eps)),
        n, n_ranges, eps, block)
    del sub
    return order, starts, center


def _lex_searchsorted(cols, spl_cols) -> np.ndarray:
    """Lexicographic bucket of each row: the count of splitters <= its
    key.  ``cols`` are the rows' key columns, most significant first,
    the last a unique tiebreak (the row id); ``spl_cols`` the ascending
    splitters' columns.  The unique key spreads even all-duplicate rows
    over the buckets."""
    n = len(cols[0])
    b1 = len(spl_cols[0])
    lo = np.zeros(n, np.int64)
    if b1 == 0:
        return lo
    hi = np.full(n, b1, np.int64)
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) >> 1
        midc = np.minimum(mid, b1 - 1)
        # le[r]: splitter[mid[r]] <= row r, column by column.
        le = np.zeros(n, bool)
        decided = np.zeros(n, bool)
        for c, sc in zip(cols, spl_cols):
            sv = sc[midc]
            le |= ~decided & (sv < c)
            decided |= sv != c
        le |= ~decided  # equal keys: <=
        lo = np.where(active & le, mid + 1, lo)
        hi = np.where(active & ~le, mid, hi)


def _accum_tile_boxes(tlo, thi, rows, gpos: int, block: int) -> None:
    """Fold sorted rows at global positions ``[gpos, gpos + len)`` into
    the per-tile min/max boxes, whatever chunks deliver them."""
    m, _k = rows.shape
    if m == 0:
        return
    pos = 0
    head = (-gpos) % block
    if head:
        h = min(head, m)
        t = gpos // block
        np.minimum(tlo[t], rows[:h].min(axis=0), out=tlo[t])
        np.maximum(thi[t], rows[:h].max(axis=0), out=thi[t])
        pos = h
    full = (m - pos) // block
    if full:
        t0 = (gpos + pos) // block
        tiles = rows[pos:pos + full * block].reshape(full, block, -1)
        np.minimum(tlo[t0:t0 + full], tiles.min(axis=1),
                   out=tlo[t0:t0 + full])
        np.maximum(thi[t0:t0 + full], tiles.max(axis=1),
                   out=thi[t0:t0 + full])
        pos += full * block
    if pos < m:
        t = (gpos + pos) // block
        np.minimum(tlo[t], rows[pos:].min(axis=0), out=tlo[t])
        np.maximum(thi[t], rows[pos:].max(axis=0), out=thi[t])


class MortonRangePartitioner:
    """The global-Morton engine's partition surface (the JAX
    ``MortonRangePartitioner``): ``partitions``, ``result``,
    ``bounding_boxes`` and ``n_partitions`` over the Morton ranges, so
    ``DBSCAN``'s inspection attributes and ``cluster_mapping()`` read as
    on the KD route.  There is no split tree (``tree == []``) and no
    ``route()``: a range is a property of the fitted data's order, not a
    region new points can be routed into."""

    def __init__(self, order: np.ndarray, starts: np.ndarray,
                 bounding_boxes: Dict[int, BoundingBox]):
        order = np.asarray(order, dtype=np.int32)
        starts = np.asarray(starts, dtype=np.int64)
        self.tree: list = []
        self.builder = "morton_range"
        self.level_times_s: list = []
        self.split_method = "morton_range"
        self.bounding_boxes = dict(bounding_boxes)
        self.partitions = {
            s: order[starts[s]:starts[s + 1]].copy()
            for s in range(len(starts) - 1)
        }
        self.result = np.empty(len(order), dtype=np.int32)
        for s, idx in self.partitions.items():
            self.result[idx] = s

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def partition_sizes(self) -> np.ndarray:
        labels = sorted(self.partitions)
        return np.array([len(self.partitions[l]) for l in labels])


class MortonStreamSplit:
    """The streaming split's product (:func:`morton_range_split_streaming`):
    the range boundaries, centre and per-tile boxes as small arrays, and
    one sorted spill file from which each range's rows are read back on
    demand, so no caller holds the whole sorted array or permutation.

    The spill directory is removed by :meth:`close` (also on leaving a
    ``with`` block, and from ``__del__``).  The JAX class's striped
    multi-process spill and its closing barrier belong to the process
    layer (ROADMAP A10): this one reads one ``sorted.bin``."""

    def __init__(self, n: int, k: int, starts: np.ndarray,
                 center: np.ndarray, spill_dir: str, sorted_path: str,
                 rec2, tile_lo, tile_hi, stats: Dict):
        self.n = int(n)
        self.k = int(k)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.center = np.asarray(center, dtype=np.float64)
        self.tile_lo = tile_lo
        self.tile_hi = tile_hi
        self.stats = dict(stats)
        self._spill_dir = spill_dir
        self._sorted_path = sorted_path
        self._rec2 = rec2
        self._closed = False

    @property
    def n_ranges(self) -> int:
        return len(self.starts) - 1

    def _read(self, a: int, b: int) -> np.ndarray:
        if self._closed:
            raise RuntimeError("MortonStreamSplit is closed")
        itemsize = self._rec2.itemsize
        with open(self._sorted_path, "rb") as f:
            f.seek(a * itemsize)
            buf = f.read((b - a) * itemsize)
        return np.frombuffer(buf, dtype=self._rec2)

    def range_rows(self, s: int):
        """``(ids int32, rows float32 (m, k))`` of range ``s``: the
        recentred rows in global Morton order, what
        ``_recentre_rows(points, order[a:b], center)`` gives in RAM."""
        return self.row_span(int(self.starts[s]), int(self.starts[s + 1]))

    def iter_range_rows(self, s: int, chunk: int = 1 << 16):
        """Yield ``(offset, ids int32, rows float32)`` pieces of range
        ``s``, so that a slab fills without the whole range in RAM."""
        a, b = int(self.starts[s]), int(self.starts[s + 1])
        for c in range(a, b, chunk):
            e = min(c + chunk, b)
            arr = self._read(c, e)
            yield c - a, arr["id"].astype(np.int32), arr["x"]

    def range_ids(self, s: int) -> np.ndarray:
        """The int32 global Morton order restricted to range ``s``."""
        return self.range_rows(s)[0]

    def row_span(self, a: int, b: int):
        """``(ids, rows)`` of the sorted positions ``[a, b)``: the chained
        route's tile-granular boundary reads."""
        arr = self._read(int(a), int(b))
        return arr["id"].astype(np.int32), arr["x"]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        shutil.rmtree(self._spill_dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # the spill never outlives the handle
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _recentred_rows_at(points, ids, center, k):
    """Gather and recentre the rows ``ids`` (the sample's keys)."""
    sub = np.empty((len(ids), k), np.float32)
    np.subtract(np.asarray(points[ids]), center, out=sub, casting="unsafe")
    return sub


def _stream_frame(points, n: int, k: int):
    """Pass 1 of the streaming split: the chunked float64 centre, the
    exact per-axis extrema and, past 32 axes, the per-axis sums of
    squares that choose the keyed axes."""
    center = _chunked_center(points, n, k)
    lo_raw = np.full(k, np.inf)
    hi_raw = np.full(k, -np.inf)
    sumsq = np.zeros(k, np.float64)
    for s in range(0, n, _CENTER_CHUNK):
        c = np.asarray(points[s:min(s + _CENTER_CHUNK, n)])
        np.minimum(lo_raw, c.min(axis=0), out=lo_raw)
        np.maximum(hi_raw, c.max(axis=0), out=hi_raw)
        if k > 32:
            d = c.astype(np.float64) - center
            sumsq += np.sum(d * d, axis=0)
    return center, lo_raw, hi_raw, sumsq


def morton_range_split_streaming(
    points, n_ranges: int, eps: float = None, block: int = None,
    chunk: int = 1 << 17, spill_dir: Optional[str] = None,
    bucket_bytes: Optional[int] = None, sample_per_bucket: int = 512,
    seed: int = 0,
) -> MortonStreamSplit:
    """External sample-sort for the global Morton order, the out-of-core
    twin of :func:`morton_range_split`: ``points`` is any row-sliceable
    (N, k) array, typically a disk-backed ``np.memmap``, and host memory
    stays at O(chunk + sample + one spill bucket).  Three passes:

    1. **scan**: the chunked float64 centre (:func:`_chunked_center`, so
       the recentred frame is the in-RAM split's) and the exact extrema;
       then a ``seed``-drawn uniform row sample is keyed in the recentred
       float32 frame and ``B - 1`` splitters are read off its quantiles,
       in the unique composite domain ``(morton words..., row id)``: the
       id is what a stable sort breaks ties by, so all-duplicate rows
       still spread over the buckets;
    2. **bucket-append**: each chunk is recentred, keyed against the
       global frame (:func:`_morton_quantize_words`) and its records
       (int64 id, float32 coordinates, key words) appended to per-bucket
       spill files;
    3. **per-bucket sort**: each bucket alone is loaded, stably sorted by
       (words, id) and appended to one sorted spill file, the per-tile
       boxes accumulating on the way.  The buckets partition the key
       domain in order, so their concatenation is the stable global sort:
       every range read equals ``order[a:b]`` of the in-RAM split.

    ``starts`` come from the in-RAM split's formulas over the streamed
    tile boxes.  Buckets hold at most ``bucket_bytes`` of records
    (default ``PPTORCH_STREAM_BUCKET_MB``, 32 MB); the largest is
    ``stats["stream_max_bucket_rows"]``.  The spill lives in a fresh
    directory under ``spill_dir`` (default ``PPTORCH_SPILL_DIR``, else
    the system's temporary directory) and is removed on failure here and
    by :meth:`MortonStreamSplit.close`.  Past 32 axes the keyed axes are
    chosen by their float64 variance from chunked moments, as the JAX
    package does (the in-RAM split takes ``points.var``: the two may pick
    different axes where variances tie to rounding).  Single-process: the
    JAX fleet build (segments striped over processes, barriers) belongs
    to ROADMAP A10.
    """
    n, k = points.shape
    n_ranges = max(1, int(n_ranges))
    if n >= np.iinfo(np.int32).max:
        raise ValueError("morton_range_split_streaming: N must fit int32 gids")
    center, lo_raw, hi_raw, sumsq = _stream_frame(points, n, k)
    ka, bits = morton_plan(k)
    axes = np.arange(k)
    if k > ka:
        axes = np.sort(np.argsort(sumsq / max(n, 1))[::-1][:ka])
    # f32(x - center) is monotone in x, so the recentred extrema are the
    # in-RAM copy's min and max.
    lo32 = np.empty(k, np.float32)
    hi32 = np.empty(k, np.float32)
    np.subtract(lo_raw, center, out=lo32, casting="unsafe")
    np.subtract(hi_raw, center, out=hi32, casting="unsafe")
    lo32, hi32 = lo32[axes], hi32[axes]
    span = np.maximum(hi32 - lo32, np.finfo(np.float32).tiny)
    n_words = max(1, -(-bits * len(axes) // 64)) if len(axes) else 1

    def _keys(sub_chunk):
        return _morton_quantize_words(sub_chunk[:, axes], lo32, span, bits)

    # -- splitters from a uniform sample
    rec_bytes = 8 * n_words + 8 + 4 * k
    if bucket_bytes is None:
        bucket_bytes = int(float(
            os.environ.get("PPTORCH_STREAM_BUCKET_MB") or 32) * 1e6)
    n_buckets = int(min(max(1, -(-n * rec_bytes // max(bucket_bytes, 1))),
                        512))
    rng = np.random.default_rng(seed)
    n_sample = int(min(n, max(4096, sample_per_bucket * n_buckets)))
    sampled = 0
    spl_cols = None
    if n_buckets > 1 and n:
        sample_ids = np.unique(rng.integers(0, n, n_sample))
        sampled = len(sample_ids)
        sw = _keys(_recentred_rows_at(points, sample_ids, center, k))
        s_order = np.lexsort((sample_ids,) + tuple(sw[::-1]))
        pos = (np.arange(1, n_buckets) * len(sample_ids)) // n_buckets
        sel = s_order[pos]
        spl_cols = [w[sel] for w in sw] + [sample_ids[sel].astype(np.int64)]
    else:
        n_buckets = 1

    # -- pass 2: bucket-append spill
    base_dir = spill_dir or os.environ.get("PPTORCH_SPILL_DIR") or None
    sdir = tempfile.mkdtemp(prefix="pptorch_gm_spill_", dir=base_dir)
    rec = np.dtype([("w", "<u8", (n_words,)), ("id", "<i8"),
                    ("x", "<f4", (k,))])
    rec2 = np.dtype([("id", "<i8"), ("x", "<f4", (k,))])
    try:
        counts = np.zeros(n_buckets, np.int64)
        paths = [os.path.join(sdir, f"b{b:04d}.bin") for b in range(n_buckets)]
        files = [open(path, "wb") for path in paths]
        try:
            for s in range(0, n, chunk):
                e = min(s + chunk, n)
                sub = np.empty((e - s, k), np.float32)
                np.subtract(np.asarray(points[s:e]), center, out=sub,
                            casting="unsafe")
                words = _keys(sub)
                ids = np.arange(s, e, dtype=np.int64)
                arr = np.empty(e - s, rec)
                for j, w in enumerate(words):
                    arr["w"][:, j] = w
                arr["id"] = ids
                arr["x"] = sub
                if n_buckets > 1:
                    bkt = _lex_searchsorted(words + [ids], spl_cols)
                    order = np.argsort(bkt, kind="stable")
                    arr = arr[order]
                    bounds = np.searchsorted(bkt[order],
                                             np.arange(n_buckets + 1))
                else:
                    bounds = np.array([0, e - s])
                for b in range(n_buckets):
                    a0, a1 = int(bounds[b]), int(bounds[b + 1])
                    if a1 > a0:
                        files[b].write(arr[a0:a1].tobytes())
                        counts[b] += a1 - a0
        finally:
            for f in files:
                f.close()

        # -- pass 3: sort each bucket alone, accumulate the tile boxes
        nt = -(-n // block) if block else 0
        tlo = np.full((nt, k), np.float32(np.inf)) if nt else None
        thi = np.full((nt, k), np.float32(-np.inf)) if nt else None
        offsets = np.concatenate(([0], np.cumsum(counts)))
        sorted_path = os.path.join(sdir, "sorted.bin")
        with open(sorted_path, "wb") as out:
            for b in range(n_buckets):
                raw = np.fromfile(paths[b], dtype=rec)
                os.unlink(paths[b])
                if len(raw) == 0:
                    continue
                perm = np.lexsort((raw["id"],) + tuple(
                    raw["w"][:, j] for j in range(n_words - 1, -1, -1)))
                srt = raw[perm]
                del raw, perm
                # Re-packed and written piecewise: two fewer bucket-sized
                # temporaries at the sort's peak.
                piece = 1 << 17
                for p0 in range(0, len(srt), piece):
                    p1 = min(p0 + piece, len(srt))
                    o2 = np.empty(p1 - p0, rec2)
                    o2["id"] = srt["id"][p0:p1]
                    o2["x"] = srt["x"][p0:p1]
                    out.write(o2.tobytes())
                    del o2
                if nt:
                    _accum_tile_boxes(tlo, thi, srt["x"], int(offsets[b]),
                                      block)
                del srt

        starts = _range_starts(
            lambda: _weights_from_boxes(tlo, thi, float(eps)),
            n, n_ranges, eps, block)
        stats = {
            "stream_buckets": int(n_buckets),
            "stream_max_bucket_rows": int(counts.max()) if n else 0,
            "stream_sample_rows": int(sampled),
            "stream_procs": 1,
            "spill_bytes": int(n * (rec.itemsize + rec2.itemsize)),
        }
        return MortonStreamSplit(n, k, starts, center, sdir, sorted_path,
                                 rec2, tlo, thi, stats)
    except BaseException:
        shutil.rmtree(sdir, ignore_errors=True)
        raise
