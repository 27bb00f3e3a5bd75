"""Spatial partitioning on the host (counterpart of
``pypardis_tpu/partition.py``).

* Morton planning and bit interleave (:func:`morton_plan`,
  :func:`interleave_bit_words`), shared with the device layout;
* the host Morton sort (:func:`morton_codes`, :func:`spatial_order`);
* the split strategies and :class:`KDPartitioner` (the node-at-a-time
  builder), with tree replay for routing (:func:`route_tree`) and the
  eps-widened replay the serving index routes queries by
  (:func:`expanded_members`).

Everything here must stay byte-identical to the JAX package: the bit
packing fixes the sort order and with it the cluster numbering, and the
KD tree fixes which leaf slab a core point lands in.  Numpy reductions
can differ in the last ulp between memory layouts, so the partitioner
keeps its points C-contiguous, as the reference does.  The Morton-range
split, its partitioner and ``BoxStack`` belong to the multi-GPU slice
(ROADMAP A11/A12).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

from .geometry import BoundingBox
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

    @property
    def n_partitions(self) -> int:
        return len(self.partitions)

    def partition_sizes(self) -> np.ndarray:
        labels = sorted(self.partitions)
        return np.array([len(self.partitions[l]) for l in labels])

    def route(self, points: np.ndarray) -> np.ndarray:
        """Leaf labels of new points by replaying the split tree
        (validated against ``k`` and for finiteness)."""
        check_query_points(points, self.k)
        return route_tree(self.tree, points)
