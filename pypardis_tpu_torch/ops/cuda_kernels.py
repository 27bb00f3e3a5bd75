"""The hand-written Hopper kernels and the tile geometry they run on
(counterpart of ``pypardis_tpu/ops/pallas_kernels.py``).

* B1 :func:`count_pairs` replaces ``_count_pairs_kernel``;
* B2 :func:`minlab_pairs` replaces ``_minlab_pairs_kernel``;
* B5 :func:`query_leaf` replaces ``_query_leaf_kernel``.

All are CUDA C++ for ``sm_90a`` (``csrc/pair_kernels.cu``,
``csrc/query_kernels.cu``, built by ``csrc/_build.py`` at first use).
Each wrapper checks its inputs, allocates its output with
``torch.empty``, launches on the current stream and adds one to its
entry of :data:`LAUNCHES`.  For a tensor on the CPU it runs the plain
PyTorch version (``ops/distances`` ``counts_over_pairs`` /
``minlab_over_pairs``, ``ops/query.query_min_core_plain``, bitwise the
kernels' arithmetic); for a CUDA tensor it launches the kernel or
raises — it never tries the kernel and falls back.

The entry points :func:`neighbor_counts_cuda` and
:func:`min_neighbor_label_cuda` mirror ``neighbor_counts_pallas`` and
``min_neighbor_label_pallas`` on the ``(d, N)`` layout: the same tile
rule, the same live tile-pair list and the same masking contract.
"""

from __future__ import annotations

import torch

from .distances import (
    INT_INF,
    counts_over_pairs,
    default_pair_budget,
    eps2_f32,
    live_tile_pairs,
    minlab_over_pairs,
    row_offsets,
    tile_bounds,
)
from .precision import norm_precision_mode, require_ported
from .query import query_min_core_plain

# Launches per kernel since the last reset_launch_counts(); bumped only
# where a wrapper launches its CUDA kernel.
LAUNCHES = {"count_pairs": 0, "minlab_pairs": 0, "query_leaf": 0}

PLAIN = {
    "count_pairs": counts_over_pairs,
    "minlab_pairs": minlab_over_pairs,
    "query_leaf": query_min_core_plain,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _bounds_dn(pts_dn, mask, nt, block):
    """(nt, d) masked per-tile bounds straight off the (d, N) layout;
    empty tiles get inverted boxes so they always prune."""
    d = pts_dn.shape[0]
    return tile_bounds(
        pts_dn.reshape(d, nt, block).transpose(0, 1),
        mask.reshape(nt, block),
    )


def kernel_pair_list(points_dn, eps, mask, block: int, precision,
                     budget: int | None = None, src_mask=None):
    """Live tile-pair list on the kernels' own tile grid.

    ``points_dn`` (d, N) float32; ``mask`` (N,) bool.  ``src_mask``
    optionally tightens the column boxes.  Returns ``((rows, cols),
    (total, budget))``: ``total > budget`` means the list was truncated
    and results built from it are invalid (rerun with ``budget >=
    total``)."""
    d, n = points_dn.shape
    pb = _pallas_block(block, n, d, norm_precision_mode(precision))
    nt = n // pb
    lo, hi = _bounds_dn(points_dn, mask, nt, pb)
    lo_col = hi_col = None
    if src_mask is not None:
        lo_col, hi_col = _bounds_dn(points_dn, src_mask, nt, pb)
    if budget is None:
        budget = default_pair_budget(nt)
    budget = min(budget, nt * nt)
    rows, cols, total = live_tile_pairs(
        lo, hi, eps, lo_col, hi_col, budget=budget
    )
    return (rows, cols), (total, budget)


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


def _launch(name, pts, colval, row_ptr, cols, eps2, tile):
    _check(pts, colval, row_ptr, cols, tile)
    if pts.device.type == "cpu":
        return PLAIN[name](pts, colval, row_ptr, cols, eps2, tile)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    from ..csrc import _build

    lib = _build.load()
    d, n = pts.shape
    out = torch.empty(n, dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"pp_{name}")(
            pts.data_ptr(), colval.data_ptr(), row_ptr.data_ptr(),
            cols.data_ptr(), float(eps2), n, d, tile, n // tile,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def count_pairs(pts, mask, row_ptr, cols, eps2, tile):
    """B1: per-point neighbour counts over the live tile pairs.

    ``pts`` (d, N) float32; ``mask`` (N,) int32 column validity;
    ``row_ptr`` (nt+1,) int32 CSR offsets; ``cols`` int32 column tiles;
    ``eps2`` the float32 eps^2 (``distances.eps2_f32``).  Returns (N,) int32;
    rows of tiles without a live pair get 0."""
    return _launch("count_pairs", pts, mask, row_ptr, cols, eps2, tile)


def minlab_pairs(pts, labels, row_ptr, cols, eps2, tile):
    """B2: per-point minimum label over columns within eps (non-source
    columns carry INT32_MAX).  Returns (N,) int32; INT32_MAX where no
    source is within eps."""
    return _launch("minlab_pairs", pts, labels, row_ptr, cols, eps2, tile)


def _grid(points_dn, block, precision):
    d, n = points_dn.shape
    tile = _pallas_block(
        block, n, d, require_ported(norm_precision_mode(precision))
    )
    if n % tile != 0:
        raise ValueError(f"tile {tile} does not divide n={n}")
    return tile, n // tile


def neighbor_counts_cuda(points_dn, eps, mask, block: int = 1024,
                         precision: str = "high", pairs=None):
    """Counterpart of ``neighbor_counts_pallas`` (layout ``"dn"``):
    per-point eps-neighbour counts, 0 on invalid rows.  ``pairs``: a
    shared ``(rows, cols)`` list from :func:`kernel_pair_list`; None
    extracts here, and a truncated list makes every count -1."""
    tile, nt = _grid(points_dn, block, precision)
    poison = False
    if pairs is None:
        pairs, (total, budget) = kernel_pair_list(
            points_dn, eps, mask, block, precision
        )
        poison = total > budget
    rows, cols = pairs
    counts = count_pairs(
        points_dn, mask.to(torch.int32), row_offsets(rows, nt),
        cols.contiguous(), eps2_f32(eps), tile,
    )
    counts = torch.where(mask, counts, 0)
    return torch.full_like(counts, -1) if poison else counts


def min_neighbor_label_cuda(points_dn, labels, eps, src_mask,
                            block: int = 1024, precision: str = "high",
                            row_mask=None, pairs=None):
    """Counterpart of ``min_neighbor_label_pallas`` (layout ``"dn"``):
    per-point minimum label over ``src_mask`` points within eps.  Rows
    outside ``row_mask`` return arbitrary values the caller masks;
    ``row_mask`` only tightens the tile boxes of a self-extracted list,
    and a truncated one poisons every row to INT32_MIN."""
    tile, nt = _grid(points_dn, block, precision)
    poison = False
    if pairs is None:
        rm = (
            torch.ones_like(src_mask) if row_mask is None else row_mask
        )
        pairs, (total, budget) = kernel_pair_list(
            points_dn, eps, rm, block, precision, src_mask=src_mask,
        )
        poison = total > budget
    rows, cols = pairs
    labi = torch.where(src_mask, labels.to(torch.int32), INT_INF)
    best = minlab_pairs(
        points_dn, labi.contiguous(), row_offsets(rows, nt),
        cols.contiguous(), eps2_f32(eps), tile,
    )
    return torch.full_like(best, -(2**31)) if poison else best


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


def query_leaf(q, tile_leaf, coords, labels, *, block, nb):
    """B5: per query row, ``(min d2, min label among ties)`` over every
    slot of its tile's leaf slab (``C = nb * block`` slots per leaf).

    ``q`` (nqt, d, qb) float32 centred query tiles; ``tile_leaf``
    (nqt,) int32; ``coords`` (d, L*C) float32; ``labels`` (L*C,) int32.
    Returns the packed (2, nqt, qb) int32 ``[labels, bitcast(d2)]``."""
    _check_query(q, tile_leaf, coords, labels, block, nb)
    if q.device.type == "cpu":
        return query_min_core_plain(q, tile_leaf, coords, labels,
                                    block=block, nb=nb)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from ..csrc import _build

    lib = _build.load()
    nqt, d, qb = q.shape
    C = block * nb
    out = torch.empty((2, nqt, qb), dtype=torch.int32, device=q.device)
    splits = int(lib.pp_query_splits(nqt, qb, C))
    keys = torch.empty(splits * nqt * qb, dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pp_query_leaf(
            q.data_ptr(), tile_leaf.data_ptr(), coords.data_ptr(),
            labels.data_ptr(), coords.shape[1], nqt, d, qb, C, splits,
            keys.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"query_leaf kernel launch failed: cudaError {rc}")
    LAUNCHES["query_leaf"] += 1
    return out


# The counterpart of ``query_min_core_pallas`` in its exact modes.
query_min_core_cuda = query_leaf
