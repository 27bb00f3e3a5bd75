"""The hand-written Hopper kernels and the tile geometry they run on
(counterpart of ``pypardis_tpu/ops/pallas_kernels.py``).

* B1 :func:`count_pairs` replaces ``_count_pairs_kernel``;
* B2 :func:`minlab_pairs` replaces ``_minlab_pairs_kernel``;
* B3 :func:`count_pairs_sketch` replaces ``_count_pairs_sketch_kernel``;
* B4 :func:`minlab_pairs_sketch` replaces ``_minlab_pairs_sketch_kernel``;
* B5 :func:`query_leaf` replaces ``_query_leaf_kernel`` (with its
  per-index tables, :func:`query_tables`).

Each has a kernel per precision mode where the TPU kernel has a mode
branch.  B1 at d <= 64 takes d^2 on the tensor cores in every mode
(bf16 operands recentred on the row tile's centre): under ``"high"``,
``"highest"`` (:func:`count_pairs`) and ``"mixed"``
(:func:`count_pairs_mixed`, which also counts the reference band's
stats) a pair outside a proven band around eps^2 takes the tensor-core
verdict and every other pair the exact d^2, bitwise the FP32 counts;
``"default"`` (:func:`count_pairs_default`) takes the bf16 verdict alone.
B2 under ``"mixed"`` (:func:`minlab_pairs_mixed`: a bf16 tensor-core
fast pass, a band, and an exact rescore per in-band pair) and
``"default"`` (:func:`minlab_pairs_default`: the bf16 pass alone), as
B1 past 64 axes; B3/B4 rescore in bf16 under ``"default"``, and B3
under every other mode through the certified bf16 rescore (a per-pair
band and an exact fallback, bitwise the exact verdicts); B5 answers pad
rows from per-index tables (:func:`query_tables`), skips each leaf's
pad tail, and adds a bf16 unit prefilter under ``"mixed"``.  B2 and B4
skip, exactly, the
column chunks whose labels cannot lower any row of a block (the
label-bound skip; :func:`~.distances.minlab_pairs_walk` and
:func:`~.distances.minlab_skip_walk` are their walks in plain torch).

All are CUDA C++ for ``sm_90a`` (``csrc/pair_kernels.cu``,
``csrc/sketch_kernels.cu``, ``csrc/query_kernels.cu`` and their shared
bf16 tile routine ``csrc/bf16_tile.cuh``, built by ``csrc/_build.py``
at first use).  Each wrapper checks its inputs, allocates its output
with ``torch.empty``, launches on the current stream and adds one to
its entry of :data:`LAUNCHES` (one per kernel and mode).  For a tensor
on the CPU it runs the plain PyTorch version (:data:`PLAIN`); for a
CUDA tensor it launches the kernel or raises — it never tries the
kernel and falls back.

The entry points :func:`neighbor_counts_cuda` and
:func:`min_neighbor_label_cuda` mirror ``neighbor_counts_pallas`` and
``min_neighbor_label_pallas`` on the ``(d, N)`` layout: the same tile
rule, the same live tile-pair list, the same masking contract, the same
``sketch=`` resolution and the same widened returns under ``"mixed"``.
:func:`sketch_stage` stages the sketch slab (``_sketch_stage``).
"""

from __future__ import annotations

import numpy as np
import torch

from .distances import (
    INT_INF,
    certified_count_walk,
    certified_rescore_walk,
    counts_over_pairs,
    counts_over_pairs_default,
    counts_over_pairs_mixed,
    counts_over_pairs_sketch,
    default_pair_budget,
    eps_threshold,
    live_tile_pairs,
    minlab_over_pairs,
    minlab_over_pairs_default,
    minlab_over_pairs_mixed,
    minlab_over_pairs_sketch,
    minlab_pairs_walk,
    minlab_skip_walk,
    row_offsets,
    tile_bounds,
    tile_norms,
)
from .precision import norm_precision_mode
from .query import (
    query_block_frames,
    query_keep_walk,
    query_leaf_ends,
    query_min_core_plain,
    query_pad_keys,
    query_pass_pairs,
)
from .sketch import effective_k, sketch_gate_band, sketch_matrix

# Launches per kernel and mode since the last reset_launch_counts();
# bumped only where a wrapper launches its CUDA kernel.  The plain
# names run "high"/"highest"; B3/B4 under "mixed" run the same kernels as
# "high" (B3's certified rescore, B4's exact one), counted under their
# mode; "query_tables" counts the builds of B5's per-index tables.
LAUNCHES = dict.fromkeys((
    "count_pairs", "minlab_pairs",
    "count_pairs_mixed", "minlab_pairs_mixed",
    "count_pairs_default", "minlab_pairs_default",
    "count_pairs_sketch", "minlab_pairs_sketch",
    "count_pairs_sketch_mixed", "minlab_pairs_sketch_mixed",
    "count_pairs_sketch_default", "minlab_pairs_sketch_default",
    "query_leaf", "query_leaf_mixed", "query_tables",
), 0)

PLAIN = {
    "count_pairs": counts_over_pairs,
    "minlab_pairs": minlab_over_pairs,
    "count_pairs_mixed": counts_over_pairs_mixed,
    "minlab_pairs_mixed": minlab_over_pairs_mixed,
    "count_pairs_default": counts_over_pairs_default,
    "minlab_pairs_default": minlab_over_pairs_default,
    "count_pairs_sketch": counts_over_pairs_sketch,
    "minlab_pairs_sketch": minlab_over_pairs_sketch,
    "query_leaf": query_min_core_plain,
}


# Passes of the cityblock metric run on the card.  Cityblock has no
# kernel (the JAX package runs it outside Pallas too): its pass is the
# plain torch one on the tensor's device, counted here, never in
# LAUNCHES.
L1_PASSES = dict.fromkeys(("count_pairs_l1", "minlab_pairs_l1"), 0)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in L1_PASSES:
        L1_PASSES[k] = 0


def _pallas_block(block: int, n: int, d: int, mode: str = "high") -> int:
    """The layout tile rule, kept from the TPU kernels: the largest tile
    <= ``block`` whose distance tile plus operand blocks stay under a
    32MB budget (a TPU VMEM rationale) and that divides ``n``.  The port
    keeps the arithmetic because the segment-break alignment and with it
    the Morton-first cluster numbering depend on it; the CUDA kernels
    sub-tile internally as they like.  block=2048, d=16, "high" -> 1024.
    """
    b = min(block, n)
    if mode == "high":
        tile_words, opnd_words = 4, 8
    elif mode == "mixed":
        tile_words, opnd_words = 6, 8
    else:
        tile_words, opnd_words = 2, 4
    while b > 128 and (
        tile_words * b * b * 4 + opnd_words * b * (d + 2) * 4
        > 32 * 1024 * 1024
        or n % b != 0
    ):
        b //= 2
    return b


def gm_tile_aligned(block: int, n_total: int, owned: int, d: int,
                    mode: str = "high") -> bool:
    """Whether the tile of an ``owned + boundary`` slab of ``n_total``
    rows divides both ``n_total`` and the ``owned`` prefix: the
    owner-computes filters split the tile-pair list at ``owned // tile``,
    and a tile straddling the split would mix owned and boundary rows.

    A power-of-two ``block`` always aligns when ``owned`` and ``n_total``
    are multiples of it (the global-Morton slab's are): the tile is
    ``block`` halved while it stays above 128, so it divides ``block``
    and with it both lengths."""
    tile = _pallas_block(block, n_total, d, mode)
    return n_total % tile == 0 and owned % tile == 0


def _bounds_dn(pts_dn, mask, nt, block):
    """(nt, d) masked per-tile bounds straight off the (d, N) layout;
    empty tiles get inverted boxes so they always prune."""
    d = pts_dn.shape[0]
    return tile_bounds(
        pts_dn.reshape(d, nt, block).transpose(0, 1),
        mask.reshape(nt, block),
    )


def _centers_dn(pts_dn, mask, nt, block):
    """(nt, d) per-tile recentring points: box centres of the valid
    coordinates; empty tiles carry inverted bounds whose midpoint is 0
    (the JAX package's ``_centers_dn`` without its trailing axis)."""
    lo, hi = _bounds_dn(pts_dn, mask, nt, block)
    return (0.5 * (lo + hi)).contiguous()


def tile_frames(pts_dn, mask, tile):
    """``(centers, rnorm)`` of the bf16 passes' row tiles over
    ``mask``: :func:`_centers_dn` and the (nt, 2) ``[nx, gx]`` norm
    maxima of :func:`~.distances.tile_norms`."""
    nt = pts_dn.shape[1] // tile
    centers = _centers_dn(pts_dn, mask, nt, tile)
    return centers, tile_norms(pts_dn, mask, tile, centers)


def pass_frames(pts_dn, mask, tile, mode, k=0):
    """The row frames a pass of ``mode`` needs over its rows ``mask``:
    ``(centers, rnorm)`` of :func:`tile_frames` under ``"mixed"``
    without the sketch (k = 0), ``(centers, None)`` under ``"default"``
    (the bf16 pass or the sketch's bf16 rescore), with the sketch in
    every mode (B3's rescore recentres on them) and at d <= 64 (B1's
    tensor-core kernel does), else ``(None, None)``."""
    if mode == "mixed" and not k:
        return tile_frames(pts_dn, mask, tile)
    if mode == "default" or k or pts_dn.shape[0] <= 64:
        return _centers_dn(pts_dn, mask, pts_dn.shape[1] // tile, tile), None
    return None, None


def _round8(v: int) -> int:
    return -(-int(v) // 8) * 8


# Columns per float64 product in sketch_stage (a (d, chunk) float64
# temporary of d * 1 MiB).
_STAGE_COLS = 1 << 17


def sketch_stage(points_dn, mask, k: int, mode: str = "high"):
    """The sketch slab and its gate band (``_sketch_stage``).

    ``points_dn`` (d, N) float32 -> ``(slab, band)``: ``slab`` (skp, N)
    float32 with rows 0..k-1 ``Q^T x``, row k ``sqrt(max(|x|^2 -
    |Q^T x|^2, 0))`` and zero rows up to ``skp = round8(k + 1)`` (inert
    in every slab sum); ``band`` the :func:`sketch_gate_band` float32
    halfwidth at the masked maximum column norm, as a Python float.

    ``Q^T x`` is a float64 product rounded once to float32: cuBLAS
    never runs a float64 product in TF32, so no global
    ``allow_tf32``/``set_float32_matmul_precision`` setting can loosen
    it past the float32 rounding the band certifies.
    """
    d, n = points_dn.shape
    q, eta = sketch_matrix(d, k)
    qt = torch.from_numpy(np.ascontiguousarray(q.T)).to(
        points_dn.device, torch.float64
    )
    skp = _round8(k + 1)
    slab = torch.zeros((skp, n), dtype=torch.float32, device=points_dn.device)
    for s in range(0, n, _STAGE_COLS):
        e = min(s + _STAGE_COLS, n)
        slab[:k, s:e] = (qt @ points_dn[:, s:e].double()).float()
    full = (points_dn * points_dn).sum(dim=0)
    proj = slab[:k]
    slab[k] = torch.sqrt(torch.clamp_min(full - (proj * proj).sum(dim=0),
                                         0.0))
    nmax = torch.sqrt(torch.where(mask, full, 0.0).max())
    band = sketch_gate_band(nmax.item(), d, k, eta, precision=mode)
    return slab, float(band)


def _staged(points_dn, mask, k: int, mode: str, slab, src_mask=None):
    """``slab`` if the caller staged one, else :func:`sketch_stage` over
    the pass's validity ``mask | src_mask`` (the band mask of
    ``_sketch_stage``)."""
    if slab is not None:
        return slab
    band_mask = mask if src_mask is None else (mask | src_mask)
    return sketch_stage(points_dn, band_mask, k, mode)


def sketch_gate(eps, band) -> float:
    """The widened pair-list gate ``sqrt(eps^2 + band)`` in float32, as
    a Python float holding that exact float32 value (a float64 gate
    would move the list at the boundary)."""
    e = np.float32(eps)
    return float(np.sqrt(e * e + np.float32(band)))


def kernel_pair_list(points_dn, eps, mask, block: int, precision,
                     budget: int | None = None, src_mask=None,
                     sketch: int = 0, slab=None, metric="euclidean"):
    """Live tile-pair list on the kernels' own tile grid.

    ``points_dn`` (d, N) float32; ``mask`` (N,) bool.  ``src_mask``
    optionally tightens the column boxes.  ``sketch`` (a resolved k, 0
    = off) extracts over the (skp)-row slab boxes at the gate
    :func:`sketch_gate` instead of the full-d boxes; ``slab`` is a
    staged ``(slab, band)`` pair (None stages it here over ``mask |
    src_mask``).  The tile never depends on the sketch.  ``metric``
    ("euclidean" or "cityblock") picks the box test's form.  Returns
    ``((rows, cols), (total, budget))``: ``total > budget`` means the
    list was truncated and results built from it are invalid (rerun
    with ``budget >= total``)."""
    d, n = points_dn.shape
    mode = norm_precision_mode(precision)
    pb = _pallas_block(block, n, d, mode)
    nt = n // pb
    gate, box_src = eps, points_dn
    if sketch:
        slab = _staged(points_dn, mask, sketch, mode, slab, src_mask)
        box_src, gate = slab[0], sketch_gate(eps, slab[1])
    lo, hi = _bounds_dn(box_src, mask, nt, pb)
    lo_col = hi_col = None
    if src_mask is not None:
        lo_col, hi_col = _bounds_dn(box_src, src_mask, nt, pb)
    if budget is None:
        budget = default_pair_budget(nt)
    budget = min(budget, nt * nt)
    rows, cols, total = live_tile_pairs(
        lo, hi, gate, lo_col, hi_col, budget=budget, metric=metric
    )
    return (rows, cols), (total, budget)


def count_pairs_l1(pts, mask, row_ptr, cols, eps_f, tile):
    """The cityblock counts pass, on the tensor's device:
    :func:`~.distances.counts_over_pairs` at ``metric="cityblock"``
    (``eps_f`` the float32 eps).  Counted in :data:`L1_PASSES` on the
    card."""
    if pts.is_cuda:
        L1_PASSES["count_pairs_l1"] += 1
    return counts_over_pairs(pts, mask, row_ptr, cols, eps_f, tile,
                             metric="cityblock")


def minlab_pairs_l1(pts, labels, row_ptr, cols, eps_f, tile, *,
                    live_rows=None):
    """The cityblock min-label pass, as :func:`count_pairs_l1`."""
    if pts.is_cuda:
        L1_PASSES["minlab_pairs_l1"] += 1
    return minlab_over_pairs(pts, labels, row_ptr, cols, eps_f, tile,
                             live_rows=live_rows, metric="cityblock")


def _check(pts, colval, row_ptr, cols, tile):
    d, n = pts.shape
    if pts.dtype != torch.float32 or not pts.is_contiguous():
        raise ValueError("points must be a contiguous (d, N) float32 tensor")
    if tile <= 0 or n % tile != 0:
        raise ValueError(f"tile {tile} does not divide N={n}")
    for name, t in (("colval", colval), ("row_ptr", row_ptr),
                    ("cols", cols)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
        if t.device != pts.device:
            raise ValueError(
                f"{name} is on {t.device}, points on {pts.device}"
            )
    if colval.shape[0] != n or row_ptr.shape[0] != n // tile + 1:
        raise ValueError(
            f"shape mismatch: colval {tuple(colval.shape)}, row_ptr "
            f"{tuple(row_ptr.shape)} for N={n}, tile={tile}"
        )


def _check_frames(pts, tile, centers, rnorm):
    d, n = pts.shape
    nt = n // tile
    for name, t, shape in (("centers", centers, (nt, d)),
                           ("rnorm", rnorm, (nt, 2))):
        if t is None:
            continue
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(
                f"{name} must be a contiguous {shape} float32 tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, points on {pts.device}")


def _check_counter(name, t, pts):
    if t is not None and (t.dtype != torch.int64 or t.shape != (1,)
                          or t.device != pts.device):
        raise ValueError(f"{name} must be a (1,) int64 tensor beside pts")


# The B1 kernel's mode argument (B1_EXACT, B1_MIXED, B1_DEFAULT in
# csrc/pair_kernels.cu).
_B1_MODE = {"high": 0, "mixed": 1, "default": 2}


def _launch_count(mode, pts, mask, row_ptr, cols, eps2, tile, centers=None,
                  rnorm=None, rescored_pairs=None):
    """B1 in every mode (see :func:`count_pairs`): under ``"mixed"``
    returns ``(counts, stats)``, else the (N,) int32 counts."""
    _check(pts, mask, row_ptr, cols, tile)
    if mode != "high" and centers is None:
        raise ValueError(f"precision={mode!r} needs the row tiles' centers")
    if mode == "mixed" and rnorm is None:
        raise ValueError("precision='mixed' needs the row tiles' rnorm")
    _check_frames(pts, tile, centers, rnorm)
    _check_counter("rescored_pairs", rescored_pairs, pts)
    d, n = pts.shape
    if rescored_pairs is not None and (mode == "default" or d > 64):
        raise ValueError("rescored_pairs counts the exact fallback of the "
                         "tensor-core B1 (d <= 64, exact modes)")
    key = "count_pairs" if mode == "high" else f"count_pairs_{mode}"
    mixed = mode == "mixed"
    if centers is None and d <= 64:
        # The tensor-core kernel recentres on any points: the box
        # centres over the mask unless the caller staged them.
        centers = _centers_dn(pts, mask != 0, n // tile, tile)
    if pts.device.type == "cpu":
        if rescored_pairs is not None:
            rescored_pairs += certified_count_walk(
                pts, mask, row_ptr, cols, eps2, tile, centers)[1]
        extra = ((centers, rnorm) if mixed
                 else (centers,) if mode == "default" else ())
        return PLAIN[key](pts, mask, row_ptr, cols, eps2, tile, *extra)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    from ..csrc import _build

    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=pts.device)
    if mixed:
        n_band = torch.zeros(1, dtype=torch.int64, device=pts.device)
        flags = torch.zeros(max(cols.shape[0], 1), dtype=torch.int32,
                            device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pp_count_pairs(
            pts.data_ptr(), mask.data_ptr(), row_ptr.data_ptr(),
            cols.data_ptr(), None if centers is None else centers.data_ptr(),
            rnorm.data_ptr() if mixed else None, float(eps2), n, d, tile,
            n // tile, _B1_MODE[mode], out.data_ptr(),
            n_band.data_ptr() if mixed else None,
            flags.data_ptr() if mixed else None,
            None if rescored_pairs is None else rescored_pairs.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    if mixed:
        return out, torch.cat([n_band, flags.sum(dtype=torch.int64)[None]])
    return out


def count_pairs(pts, mask, row_ptr, cols, eps2, tile, centers=None, *,
                rescored_pairs=None):
    """B1: per-point neighbour counts over the live tile pairs.

    ``pts`` (d, N) float32; ``mask`` (N,) int32 column validity;
    ``row_ptr`` (nt+1,) int32 CSR offsets; ``cols`` int32 column tiles;
    ``eps2`` the float32 eps^2 (``distances.eps2_f32``).  Returns (N,)
    int32, bitwise :func:`~.distances.counts_over_pairs` on every row;
    rows of tiles without a live pair get 0.

    At d <= 64 the kernel takes d^2 on the tensor cores (bf16 operands
    recentred on the row tiles' ``centers`` (nt, d), any points;
    :func:`pass_frames` stages the box centres over the mask, and None
    takes them here), decides each pair outside a proven band around
    eps^2 from it and every other pair by the exact d^2.
    ``rescored_pairs``: an optional (1,) int64 tensor beside ``pts``,
    zeroed by the caller, to which the kernel adds the pairs it decided
    exactly (on the CPU, the count of
    :func:`~.distances.certified_count_walk`).  Past 64 axes it runs the
    exact d^2 for every pair (in axis slices)."""
    return _launch_count("high", pts, mask, row_ptr, cols, eps2, tile,
                         centers, rescored_pairs=rescored_pairs)


def count_pairs_mixed(pts, mask, row_ptr, cols, eps2, tile, centers,
                      rnorm, *, rescored_pairs=None):
    """B1 under ``precision="mixed"``: at d <= 64 the kernel of
    :func:`count_pairs` (its counts, bitwise on every row, and its
    ``rescored_pairs``), which also counts the reference band's stats
    over the same d2f: per pair-list entry the band is
    :func:`~.distances.fast_band` at the row tile's ``rnorm`` and the
    entry's valid columns' norms about the row tile's centre.  Past 64
    axes the bf16 pass classifies against that band and rescores its
    in-band pairs exactly.  ``centers`` (nt, d) / ``rnorm`` (nt, 2) from
    :func:`tile_frames` over ``mask``.  Returns ``(counts, stats)``:
    counts equal to :func:`count_pairs` on the rows of ``mask``;
    ``stats`` the (2,) int64 ``[band_pairs, rescored_tiles]`` over valid
    rows and columns."""
    return _launch_count("mixed", pts, mask, row_ptr, cols, eps2, tile,
                         centers, rnorm, rescored_pairs)


def count_pairs_default(pts, mask, row_ptr, cols, eps2, tile, centers):
    """B1 under ``precision="default"``: the bf16 pass decides every
    pair (lossy; no band, no rescore)."""
    return _launch_count("default", pts, mask, row_ptr, cols, eps2, tile,
                         centers)


def _launch_minlab(mode, pts, labels, row_ptr, cols, eps2, tile,
                   centers=None, rnorm=None, live_rows=None, evaluated=None):
    """B2 in every mode: the FP32 kernel (``"high"``) or the bf16 one
    (``"mixed"``, ``"default"``), each with its exact label-bound skip
    (see :func:`minlab_pairs`)."""
    _check(pts, labels, row_ptr, cols, tile)
    fast = mode in ("mixed", "default")
    if fast and centers is None:
        raise ValueError(f"precision={mode!r} needs the row tiles' centers")
    if mode == "mixed" and rnorm is None:
        raise ValueError("precision='mixed' needs the row tiles' rnorm")
    _check_frames(pts, tile, centers, rnorm)
    _check_counter("evaluated", evaluated, pts)
    d, n = pts.shape
    if live_rows is not None and (
            live_rows.dtype != torch.bool or live_rows.shape != (n,)
            or not live_rows.is_contiguous()
            or live_rows.device != pts.device):
        raise ValueError("live_rows must be a contiguous (N,) bool tensor "
                         "beside pts")
    key = "minlab_pairs" if mode == "high" else f"minlab_pairs_{mode}"
    frames = (centers, rnorm) if mode == "mixed" else (
        (centers,) if fast else ())
    if pts.device.type == "cpu":
        if evaluated is not None:
            evaluated += minlab_pairs_walk(
                pts, labels, row_ptr, cols, eps2, tile, mode, centers, rnorm,
                live_rows=live_rows)[1]
        return PLAIN[key](pts, labels, row_ptr, cols, eps2, tile, *frames,
                          live_rows=live_rows)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    from ..csrc import _build

    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=pts.device)
    # Each column tile's least label, for the kernel's entry skip.
    tile_min = labels.view(n // tile, tile).amin(dim=1).contiguous()
    skip = (tile_min.data_ptr(),
            None if live_rows is None else live_rows.data_ptr(),
            out.data_ptr(),
            None if evaluated is None else evaluated.data_ptr())
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        if fast:
            rc = lib.pp_minlab_pairs_fast(
                pts.data_ptr(), labels.data_ptr(), row_ptr.data_ptr(),
                cols.data_ptr(), centers.data_ptr(),
                rnorm.data_ptr() if mode == "mixed" else None, float(eps2),
                n, d, tile, n // tile, int(mode == "default"), *skip, stream)
        else:
            rc = lib.pp_minlab_pairs(
                pts.data_ptr(), labels.data_ptr(), row_ptr.data_ptr(),
                cols.data_ptr(), float(eps2), n, d, tile, n // tile, *skip,
                stream)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    return out


def minlab_pairs(pts, labels, row_ptr, cols, eps2, tile, *, live_rows=None,
                 evaluated=None):
    """B2: per-point minimum label over columns within eps (non-source
    columns carry INT32_MAX).  Returns (N,) int32; INT32_MAX where no
    source is within eps.

    The kernel skips, exactly, the column tiles and 32-column chunks
    whose labels cannot lower any row of its block (each row's running
    minimum against the chunk's least label; it never looks at a
    distance).  ``live_rows``: an optional (N,) bool of the rows the
    caller still needs; the others leave the skip's bound and get
    INT32_MAX.  ``evaluated``: an optional (1,) int64 tensor beside
    ``pts``, zeroed by the caller, to which the kernel adds the (block,
    chunk) pairs it evaluated (on the CPU, the count of
    :func:`~.distances.minlab_pairs_walk`, which stages
    :func:`~.distances.minlab_group` chunks per barrier as the kernel
    does)."""
    return _launch_minlab("high", pts, labels, row_ptr, cols, eps2, tile,
                          live_rows=live_rows, evaluated=evaluated)


def minlab_pairs_mixed(pts, labels, row_ptr, cols, eps2, tile, centers,
                       rnorm, *, live_rows=None, evaluated=None):
    """B2 under ``precision="mixed"`` (the band over source columns, no
    stats): equal to :func:`minlab_pairs` on the rows ``rnorm`` covers;
    the skip and its keywords as there."""
    return _launch_minlab("mixed", pts, labels, row_ptr, cols, eps2, tile,
                          centers, rnorm, live_rows, evaluated)


def minlab_pairs_default(pts, labels, row_ptr, cols, eps2, tile, centers, *,
                         live_rows=None, evaluated=None):
    """B2 under ``precision="default"``; the skip and its keywords as in
    :func:`minlab_pairs_mixed`."""
    return _launch_minlab("default", pts, labels, row_ptr, cols, eps2, tile,
                          centers, None, live_rows, evaluated)


def _check_slab(pts, slab, k):
    d, n = pts.shape
    if (slab.dtype != torch.float32 or not slab.is_contiguous()
            or slab.dim() != 2 or slab.shape[1] != n):
        raise ValueError(
            f"slab must be a contiguous (skp, N={n}) float32 tensor, got "
            f"{slab.dtype} {tuple(slab.shape)}"
        )
    if slab.device != pts.device:
        raise ValueError(f"slab is on {slab.device}, points on {pts.device}")
    skp = slab.shape[0]
    if skp % 8 != 0 or not 0 < k < skp:
        raise ValueError(
            f"slab rows {skp} must be a multiple of 8 holding the residual "
            f"row k={k}"
        )


def row_fragments(pts, centers, tile):
    """B3's certified rescore's row operands: every row recentred on its
    tile's centre (one float32 subtraction) and rounded to bf16 (nearest
    even), laid out as the kernel's mma.sync A fragments, so a warp reads
    16 rows of one 16-axis k-step as one 16-byte load per lane.

    ``pts`` (d, N) float32, ``centers`` (nt, d).  Returns a contiguous
    (nt, tp / 16, dp / 16, 8, 4, 2, 2, 2) bfloat16 tensor, ``tp`` the tile
    rounded up to 32 rows and ``dp`` d up to 16 axes (zeros in the pad):
    entry [r, m, kk, g, t, q, h, i] is row m * 16 + h * 8 + g of tile r
    at axis kk * 16 + q * 8 + t * 2 + i, so lane 4 g + t holds the
    fragment registers a[2 q + h] (csrc/bf16_tile.cuh's layout)."""
    d, n = pts.shape
    nt = n // tile
    dp = -(-d // 16) * 16
    tp = -(-tile // 32) * 32
    frag = torch.empty((nt, tp // 16, dp // 16, 8, 4, 2, 2, 2),
                       dtype=torch.bfloat16, device=pts.device)
    # The (nt, tp, dp) row-major order of the same entries, as a view:
    # each batch of row tiles is written through it, so the fragments
    # are the only full-size tensor.
    x = frag.permute(0, 1, 6, 3, 2, 5, 4, 7)
    step = max(1, (1 << 24) // (tp * dp))
    for s in range(0, nt, step):
        e = min(nt, s + step)
        rows = pts[:, s * tile:e * tile].T.reshape(e - s, tile, d)
        t = torch.zeros((e - s, tp, dp), dtype=torch.bfloat16,
                        device=pts.device)
        t[:, :tile, :d] = (rows - centers[s:e, None, :]).to(torch.bfloat16)
        x[s:e] = t.view(e - s, tp // 16, 2, 8, dp // 16, 2, 4, 2)
    return frag


def _launch_sketch(name, pts, colval, row_ptr, cols, slab, k, eps2, band,
                   tile, mode="high", centers=None, evaluated=None,
                   rescored_pairs=None):
    """Both sketch kernels: B3 returns ``(counts, stats)``, B4 the
    minimum labels.  ``mode="default"`` rescores in bf16 about the row
    tiles' ``centers``; every other mode exactly: B4 with the FP32 sum,
    B3 with the certified rescore about ``centers``.  ``evaluated`` (B4)
    and ``rescored_pairs`` (B3, exact modes) as in
    :func:`minlab_pairs_sketch` and :func:`count_pairs_sketch`."""
    _check(pts, colval, row_ptr, cols, tile)
    _check_slab(pts, slab, k)
    mode = norm_precision_mode(mode)
    counting = name == "count_pairs_sketch"
    bf16 = mode == "default"
    if (bf16 or counting) and centers is None:
        raise ValueError("B3 and precision='default' need the row tiles' "
                         "centers for their bf16 rescore")
    if not (counting or bf16) and centers is not None:
        raise ValueError("B4's exact rescore takes no centers: they go with "
                         "precision='default' only")
    if bf16 and rescored_pairs is not None:
        raise ValueError("rescored_pairs counts the certified rescore of the "
                         "exact modes; precision='default' has none")
    _check_counter("evaluated", evaluated, pts)
    _check_counter("rescored_pairs", rescored_pairs, pts)
    certified = counting and not bf16
    _check_frames(pts, tile, centers, None)
    key = name if mode in ("high", "highest") else f"{name}_{mode}"
    if pts.device.type == "cpu":
        if evaluated is not None:
            evaluated += minlab_skip_walk(pts, colval, row_ptr, cols, slab,
                                          k, eps2, band, tile, centers)[1]
        if rescored_pairs is not None:
            rescored_pairs += certified_rescore_walk(
                pts, colval, row_ptr, cols, slab, k, eps2, band, tile,
                centers)[1]
        return PLAIN[name](pts, colval, row_ptr, cols, slab, k, eps2, band,
                           tile, centers if bf16 else None)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    from ..csrc import _build

    lib = _build.load()
    d, n = pts.shape
    out = torch.empty(n, dtype=torch.int32, device=pts.device)
    # The rescore (csrc/sketch_kernels.cu): SK_BF16 under "default",
    # else SK_CERTIFIED for B3 and SK_EXACT for B4.
    rescore = 1 if bf16 else (2 if counting else 0)
    if counting:
        # band_pairs (one 64-bit counter) and one rescore flag per
        # pair-list entry, summed below.
        n_band = torch.zeros(1, dtype=torch.int64, device=pts.device)
        flags = torch.zeros(max(cols.shape[0], 1), dtype=torch.int32,
                            device=pts.device)
        extra = (n_band.data_ptr(), flags.data_ptr(),
                 None if rescored_pairs is None
                 else rescored_pairs.data_ptr())
        # The certified rescore reads each point's axes from a row-major
        # copy (in the (d, N) layout they lie N floats apart) and its rows
        # as bf16 mma fragments.
        frames = ((centers, pts.T.contiguous(),
                   row_fragments(pts, centers, tile)) if certified
                  else (centers, None, None))
    else:
        # Each column tile's least label, for the kernel's entry skip.
        tile_min = colval.view(n // tile, tile).amin(dim=1).contiguous()
        extra = (tile_min.data_ptr(),
                 None if evaluated is None else evaluated.data_ptr())
        frames = (centers,)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"pp_{name}")(
            pts.data_ptr(), slab.data_ptr(), colval.data_ptr(),
            row_ptr.data_ptr(), cols.data_ptr(),
            *(None if t is None else t.data_ptr() for t in frames),
            float(eps2), float(band), n, d, slab.shape[0], k, tile, n // tile,
            rescore,
            out.data_ptr(), *extra, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    if counting:
        return out, torch.cat([n_band, flags.sum(dtype=torch.int64)[None]])
    return out


def count_pairs_sketch(pts, mask, row_ptr, cols, slab, k, eps2, band, tile,
                       mode="high", centers=None, *, rescored_pairs=None):
    """B3: :func:`count_pairs` through the slab gate.  ``slab`` (skp, N)
    float32 from :func:`sketch_stage` (row ``k`` the residual norm);
    ``band`` its float32 halfwidth.  Returns ``(counts, stats)``, equal
    to :func:`count_pairs` on any data, with ``stats`` a (2,) int64
    tensor ``[band_pairs, rescored_tiles]``: pairs neither certainly in
    nor certainly out whose column is valid (every row counted), and
    pair-list entries holding one.  Under ``"high"``, ``"highest"`` and
    ``"mixed"`` the kernel decides the in-band pairs by the bf16 tensor-
    core d^2 recentred on the row tiles' ``centers`` (nt, d), any points
    (:func:`pass_frames` gives the box centres over ``mask``), within a
    proven per-pair band, and the rest by the exact d^2;
    ``rescored_pairs``, an optional (1,) int64 tensor beside ``pts``
    zeroed by the caller, gets the count of the latter (on the CPU,
    :func:`~.distances.certified_rescore_walk`'s).  On the card such a
    launch holds 1.5 times the points' bytes more while it runs: their
    row-major float32 copy and their bf16 :func:`row_fragments`.
    ``mode="default"`` (with the row tiles' ``centers`` over ``mask``)
    decides the in-band pairs by the bf16 pass alone instead (lossy, as
    that mode's band is)."""
    return _launch_sketch("count_pairs_sketch", pts, mask, row_ptr, cols,
                          slab, k, eps2, band, tile, mode, centers,
                          rescored_pairs=rescored_pairs)


def minlab_pairs_sketch(pts, labels, row_ptr, cols, slab, k, eps2, band,
                        tile, mode="high", centers=None, *, evaluated=None):
    """B4: :func:`minlab_pairs` through the slab gate (no stats);
    ``mode``/``centers`` as in :func:`count_pairs_sketch`.  The kernel
    skips, exactly, the column tiles and 32-column chunks whose labels
    cannot lower any row of its block.  ``evaluated``: an optional (1,)
    int64 tensor beside ``pts``, zeroed by the caller, to which the
    kernel adds the (block, chunk) pairs it evaluated (on the CPU, the
    count of :func:`~.distances.minlab_skip_walk`)."""
    return _launch_sketch("minlab_pairs_sketch", pts, labels, row_ptr,
                          cols, slab, k, eps2, band, tile, mode, centers,
                          evaluated)


def mma_dot_probe(a, b):
    """The tensor cores' FP32 accumulation as B3's certified rescore
    runs it (``pp_mma_dot_probe``: one accumulator chained through
    ``mma.sync`` m16n8k16 over the k-steps in order), for measuring the
    header's term (3): ``a`` (B, 16, K) and ``b`` (B, 8, K) bfloat16, K
    a multiple of 16, gives (B, 16, 8) float32, ``a[i] @ b[i].T``.  Not
    a kernel of the fit, so not counted in :data:`LAUNCHES`.  On the CPU
    the float64 product rounded once to float32."""
    if (a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or a.dim() != 3 or b.dim() != 3 or a.shape[1] != 16
            or b.shape[1] != 8 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[2] or a.shape[2] % 16
            or a.device != b.device):
        raise ValueError("a (B, 16, K) and b (B, 8, K) bfloat16 on one "
                         "device, K a multiple of 16")
    if a.device.type == "cpu":
        return torch.bmm(a.double(), b.double().transpose(1, 2)).float()
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from ..csrc import _build

    lib = _build.load()
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((a.shape[0], 16, 8), dtype=torch.float32,
                      device=a.device)
    with torch.cuda.device(a.device):
        rc = lib.pp_mma_dot_probe(
            a.data_ptr(), b.data_ptr(), a.shape[0], a.shape[2],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pp_mma_dot_probe failed: cudaError {rc}")
    return out


def _grid(points_dn, block, mode):
    d, n = points_dn.shape
    tile = _pallas_block(block, n, d, mode)
    if n % tile != 0:
        raise ValueError(f"tile {tile} does not divide n={n}")
    return tile, n // tile


def neighbor_counts_cuda(points_dn, eps, mask, block: int = 1024,
                         precision: str = "high", pairs=None, sketch=None,
                         slab=None, frames=None, metric="euclidean"):
    """Counterpart of ``neighbor_counts_pallas`` (layout ``"dn"``):
    per-point eps-neighbour counts, 0 on invalid rows.  ``pairs``: a
    shared ``(rows, cols)`` list from :func:`kernel_pair_list`; None
    extracts here, and a truncated list makes every count -1.
    ``frames``: the staged :func:`pass_frames` over ``mask`` (None
    computes them here).

    ``sketch``: a spec (None reads ``PPTORCH_SKETCH``); a resolved k > 0
    runs B3 over the slab (``slab``: a staged ``(slab, band)`` pair, or
    None to stage it over ``mask``).  ``precision="mixed"`` runs the
    bf16 B1 with its rescore, ``"default"`` the bf16 B1 alone.  With
    k > 0 or under ``"mixed"`` the return is ``(counts, stats)``, stats
    the (2,) int64 ``[band_pairs, rescored_tiles]`` of the sketch gate
    (the sketch wins) or of the bf16 band.  ``metric="cityblock"`` runs
    :func:`count_pairs_l1` (no sketch, no bf16 pass)."""
    mode = norm_precision_mode(precision)
    tile, nt = _grid(points_dn, block, mode)
    l1 = metric == "cityblock"
    k = 0 if l1 else effective_k(sketch, points_dn.shape[0])
    if k:
        slab = _staged(points_dn, mask, k, mode, slab)
    poison = False
    if pairs is None:
        pairs, (total, budget) = kernel_pair_list(
            points_dn, eps, mask, block, mode, sketch=k, slab=slab,
            metric=metric,
        )
        poison = total > budget
    rows, cols = pairs
    args = (points_dn, mask.to(torch.int32), row_offsets(rows, nt),
            cols.contiguous())
    e2 = eps_threshold(eps, metric)
    stats = None
    # The bf16 passes' row frames, over the rows they count for.
    if frames is None:
        frames = ((None, None) if l1
                  else pass_frames(points_dn, mask, tile, mode, k))
    centers, rnorm = frames
    if l1:
        counts = count_pairs_l1(*args, e2, tile)
    elif k:
        counts, stats = count_pairs_sketch(
            *args, slab[0], k, e2, slab[1], tile, mode, centers
        )
    elif mode == "mixed":
        counts, stats = count_pairs_mixed(*args, e2, tile, centers, rnorm)
    elif mode == "default":
        counts = count_pairs_default(*args, e2, tile, centers)
    else:
        counts = count_pairs(*args, e2, tile, centers)
    counts = torch.where(mask, counts, 0)
    if poison:
        counts = torch.full_like(counts, -1)
    return counts if stats is None else (counts, stats)


def min_neighbor_label_cuda(points_dn, labels, eps, src_mask,
                            block: int = 1024, precision: str = "high",
                            row_mask=None, pairs=None, sketch=None,
                            slab=None, frames=None, live_rows=None,
                            metric="euclidean"):
    """Counterpart of ``min_neighbor_label_pallas`` (layout ``"dn"``):
    per-point minimum label over ``src_mask`` points within eps.  Rows
    outside ``row_mask`` return arbitrary values the caller masks;
    ``row_mask`` tightens the tile boxes of a self-extracted list and
    the bf16 passes' row frames, and a truncated list poisons every row
    to INT32_MIN.  ``sketch``, ``slab`` and ``precision`` as in
    :func:`neighbor_counts_cuda` (the slab staged over ``row_mask |
    src_mask``, ``frames`` over ``row_mask``); with k > 0 or under
    ``"mixed"`` the return is ``(best, zeros(2))``, as the JAX entry
    point's.  ``live_rows``: an optional (N,) bool of the rows the
    caller still needs; the others get INT32_MAX (B2 leaves them out
    of its skip's bound, :func:`minlab_pairs`).  ``metric="cityblock"``
    runs :func:`minlab_pairs_l1`."""
    mode = norm_precision_mode(precision)
    tile, nt = _grid(points_dn, block, mode)
    l1 = metric == "cityblock"
    k = 0 if l1 else effective_k(sketch, points_dn.shape[0])
    rm = torch.ones_like(src_mask) if row_mask is None else row_mask
    if k:
        slab = _staged(points_dn, rm, k, mode, slab, src_mask)
    poison = False
    if pairs is None:
        pairs, (total, budget) = kernel_pair_list(
            points_dn, eps, rm, block, mode, src_mask=src_mask,
            sketch=k, slab=slab, metric=metric,
        )
        poison = total > budget
    rows, cols = pairs
    labi = torch.where(src_mask, labels.to(torch.int32), INT_INF)
    args = (points_dn, labi.contiguous(), row_offsets(rows, nt),
            cols.contiguous())
    e2 = eps_threshold(eps, metric)
    if frames is None:
        frames = ((None, None) if l1
                  else pass_frames(points_dn, rm, tile, mode, k))
    centers, rnorm = frames
    live = None if live_rows is None else live_rows.contiguous()
    if l1:
        best = minlab_pairs_l1(*args, e2, tile, live_rows=live)
    elif k:
        # B4 rescores exactly outside "default": no centres.
        best = minlab_pairs_sketch(
            *args, slab[0], k, e2, slab[1], tile, mode,
            centers if mode == "default" else None,
        )
        if live is not None:
            best = torch.where(live, best, INT_INF)
    elif mode == "mixed":
        best = minlab_pairs_mixed(*args, e2, tile, centers, rnorm,
                                  live_rows=live)
    elif mode == "default":
        best = minlab_pairs_default(*args, e2, tile, centers, live_rows=live)
    else:
        best = minlab_pairs(*args, e2, tile, live_rows=live)
    if poison:
        best = torch.full_like(best, -(2**31))
    if k or mode == "mixed":
        return best, torch.zeros(2, dtype=torch.int64, device=best.device)
    return best


def _check_query(q, tile_leaf, coords, labels, block, nb):
    if q.dtype != torch.float32 or not q.is_contiguous() or q.dim() != 3:
        raise ValueError("queries must be a contiguous (nqt, d, qb) float32 "
                         "tensor")
    nqt, d, qb = q.shape
    if (coords.dtype != torch.float32 or not coords.is_contiguous()
            or coords.dim() != 2 or coords.shape[0] != d):
        raise ValueError(
            f"coords must be a contiguous (d={d}, L*C) float32 tensor, got "
            f"{coords.dtype} {tuple(coords.shape)}"
        )
    for name, t, n in (("tile_leaf", tile_leaf, nqt),
                       ("labels", labels, coords.shape[1])):
        if (t.dtype != torch.int32 or not t.is_contiguous() or t.dim() != 1
                or t.shape[0] != n):
            raise ValueError(
                f"{name} must be a contiguous ({n},) int32 tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    for name, t in (("tile_leaf", tile_leaf), ("coords", coords),
                    ("labels", labels)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, queries on {q.device}")
    C = block * nb
    if block <= 0 or nb <= 0 or coords.shape[1] % C != 0:
        raise ValueError(
            f"the slab width {coords.shape[1]} is not a multiple of the "
            f"leaf capacity C = nb * block = {nb} * {block}"
        )


def query_tables(coords, labels, *, block, nb):
    """B5's per-index tables over ``L`` leaf slabs of ``C = nb * block``
    slots: ``(pad_keys (L,) int64, leaf_end (L,) int32, ctr (L*nb, d)
    float32, slots (L*C, 4) float32)`` -- the key of a pad row against
    each leaf (:func:`~.query.query_pad_keys`), each leaf's end
    (:func:`~.query.query_leaf_ends`) and the ``"mixed"`` block frames
    (:func:`~.query.query_block_frames`).  On the card two small kernels
    build them (one launch counted); on the CPU the plain functions."""
    d = coords.shape[0]
    C = block * nb
    if (coords.dtype != torch.float32 or not coords.is_contiguous()
            or coords.dim() != 2 or block <= 0 or nb <= 0
            or coords.shape[1] % C != 0):
        raise ValueError(
            f"coords must be a contiguous (d, L*C) float32 tensor with C = "
            f"nb * block = {nb} * {block}, got {coords.dtype} "
            f"{tuple(coords.shape)}"
        )
    if (labels.dtype != torch.int32 or labels.dim() != 1
            or labels.shape[0] != coords.shape[1]
            or labels.device != coords.device or not labels.is_contiguous()):
        raise ValueError("labels must be a contiguous (L*C,) int32 tensor "
                         "beside coords")
    if coords.device.type == "cpu":
        return (query_pad_keys(coords, labels, C),
                query_leaf_ends(coords, labels, C),
                *query_block_frames(coords, labels, block))
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    from ..csrc import _build

    lib = _build.load()
    L = coords.shape[1] // C
    kw = dict(device=coords.device)
    tables = (torch.empty(L, dtype=torch.int64, **kw),
              torch.empty(L, dtype=torch.int32, **kw),
              torch.empty((L * nb, d), dtype=torch.float32, **kw),
              torch.empty((L * C, 4), dtype=torch.float32, **kw))
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pp_query_tables(
            coords.data_ptr(), labels.data_ptr(), L, C, block, d,
            *(t.data_ptr() for t in tables), *(t.numel() for t in tables),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"query_tables kernel launch failed: cudaError {rc}")
    LAUNCHES["query_tables"] += 1
    return tables


def _check_tables(tables, coords, block, nb):
    d = coords.shape[0]
    C = block * nb
    L = coords.shape[1] // C
    want = ((torch.int64, (L,)), (torch.int32, (L,)),
            (torch.float32, (L * nb, d)), (torch.float32, (L * C, 4)))
    if len(tables) != 4 or any(
            t.dtype != dt or tuple(t.shape) != sh or not t.is_contiguous()
            or t.device != coords.device
            for t, (dt, sh) in zip(tables, want)):
        raise ValueError(
            "tables must be query_tables(coords, labels, block, nb) of this "
            "slab, on its device"
        )


def query_leaf(q, tile_leaf, coords, labels, *, block, nb,
               precision="high", eps2=None, keep_stats=None,
               pass_stats=None, tables=None):
    """B5: per query row, ``(min d2, min label among ties)`` over every
    slot of its tile's leaf slab (``C = nb * block`` slots per leaf).

    ``q`` (nqt, d, qb) float32 centred query tiles; ``tile_leaf``
    (nqt,) int32; ``coords`` (d, L*C) float32; ``labels`` (L*C,) int32;
    ``tables`` the slab's :func:`query_tables`, built once per index
    (:meth:`~..serve.index.CorePointIndex.kernel_tables`): required on
    the card, built here on the CPU where none are given.  Returns the packed (2, nqt, qb) int32
    ``[labels, bitcast(d2)]``, bitwise :func:`~.query.
    query_min_core_plain`'s.  The kernel answers pad rows from the
    tables and skips each leaf's pad tail (:func:`~.query.
    query_skip_walk` is that rule in plain torch).

    ``precision="mixed"`` (with the float32 ``eps2``) decides each unit
    (tile, 32-row group, column block) by its bf16 lower bound and runs
    the exact pass on the kept units only; a row with a core within eps
    gets the exact answer, a row without one may keep +inf.
    ``keep_stats``: an optional (2,) int64 tensor beside ``q``, zeroed
    by the caller, to which the call adds ``[kept units, visited
    units]`` (on the CPU, :func:`~.query.query_keep_walk`'s).
    ``pass_stats``: an optional (1,) int64 tensor beside ``q``, zeroed
    by the caller, to which the call adds the (row, slot) pairs its
    exact pass computes, 32 per row group and column it runs (on the
    CPU, :func:`~.query.query_pass_pairs`'s count)."""
    _check_query(q, tile_leaf, coords, labels, block, nb)
    mixed = norm_precision_mode(precision) == "mixed"
    if mixed and eps2 is None:
        raise ValueError("precision='mixed' needs eps2 for its prefilter")
    if keep_stats is not None and (
            keep_stats.dtype != torch.int64 or keep_stats.shape != (2,)
            or keep_stats.device != q.device):
        raise ValueError("keep_stats must be a (2,) int64 tensor beside q")
    if pass_stats is not None and (
            pass_stats.dtype != torch.int64 or pass_stats.shape != (1,)
            or pass_stats.device != q.device):
        raise ValueError("pass_stats must be a (1,) int64 tensor beside q")
    if tables is not None:
        _check_tables(tables, coords, block, nb)
    if q.device.type == "cpu":
        if keep_stats is not None or pass_stats is not None:
            if tables is None:
                tables = query_tables(coords, labels, block=block, nb=nb)
            keep = None
            if mixed:
                keep, counts = query_keep_walk(
                    q, tile_leaf, coords, labels, tables[2:], tables[1],
                    eps2, block=block, nb=nb)
                if keep_stats is not None:
                    keep_stats += counts[:2]
            if pass_stats is not None:
                pass_stats += query_pass_pairs(q, tile_leaf, tables[1],
                                               block=block, nb=nb, keep=keep)
        return query_min_core_plain(
            q, tile_leaf, coords, labels, block=block, nb=nb,
            precision="mixed" if mixed else "high", eps2=eps2,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if tables is None:
        raise ValueError("query_leaf on the card needs the index's tables "
                         "(query_tables, built once per index)")
    from ..csrc import _build

    lib = _build.load()
    nqt, d, qb = q.shape
    C = block * nb
    G = -(-qb // 32)
    kw = dict(device=q.device)
    out = torch.empty((2, nqt, qb), dtype=torch.int32, **kw)
    # One scratch buffer: the rows' keys (u64), the groups' classes and,
    # under "mixed", the units' keep flags (bytes).
    n_keys = nqt * qb * 8
    n_grp = -(-nqt * G // 16) * 16
    scratch = torch.empty(n_keys + n_grp + (nqt * G * nb if mixed else 0),
                          dtype=torch.uint8, **kw)
    at = scratch.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pp_query_leaf(
            q.data_ptr(), tile_leaf.data_ptr(), coords.data_ptr(),
            labels.data_ptr(), coords.shape[1], nqt, d, qb, C, block,
            *(t.data_ptr() for t in tables),
            float(eps2) if mixed else 0.0, int(mixed),
            None if keep_stats is None else keep_stats.data_ptr(),
            None if pass_stats is None else pass_stats.data_ptr(),
            at, at + n_keys, at + n_keys + n_grp if mixed else None,
            out.data_ptr(), n_keys // 8, n_grp, out.numel(), stream,
        )
    key = "query_leaf_mixed" if mixed else "query_leaf"
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    return out


# The counterpart of ``query_min_core_pallas``.
query_min_core_cuda = query_leaf
