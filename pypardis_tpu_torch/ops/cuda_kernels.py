"""The hand-written Hopper kernels and the tile geometry they run on
(counterpart of ``pypardis_tpu/ops/pallas_kernels.py``).

* B1 :func:`count_pairs` replaces ``_count_pairs_kernel``;
* B2 :func:`minlab_pairs` replaces ``_minlab_pairs_kernel``;
* B3 :func:`count_pairs_sketch` replaces ``_count_pairs_sketch_kernel``;
* B4 :func:`minlab_pairs_sketch` replaces ``_minlab_pairs_sketch_kernel``;
* B5 :func:`query_leaf` replaces ``_query_leaf_kernel``.

All are CUDA C++ for ``sm_90a`` (``csrc/pair_kernels.cu``,
``csrc/sketch_kernels.cu``, ``csrc/query_kernels.cu``, built by
``csrc/_build.py`` at first use).  Each wrapper checks its inputs,
allocates its output with ``torch.empty``, launches on the current
stream and adds one to its entry of :data:`LAUNCHES`.  For a tensor on
the CPU it runs the plain PyTorch version (:data:`PLAIN`, bitwise the
kernels' arithmetic); for a CUDA tensor it launches the kernel or
raises — it never tries the kernel and falls back.

The entry points :func:`neighbor_counts_cuda` and
:func:`min_neighbor_label_cuda` mirror ``neighbor_counts_pallas`` and
``min_neighbor_label_pallas`` on the ``(d, N)`` layout: the same tile
rule, the same live tile-pair list, the same masking contract and the
same ``sketch=`` resolution.  :func:`sketch_stage` stages the sketch
slab (``_sketch_stage``).
"""

from __future__ import annotations

import numpy as np
import torch

from .distances import (
    INT_INF,
    counts_over_pairs,
    counts_over_pairs_sketch,
    default_pair_budget,
    eps2_f32,
    live_tile_pairs,
    minlab_over_pairs,
    minlab_over_pairs_sketch,
    row_offsets,
    tile_bounds,
)
from .precision import norm_precision_mode, require_ported
from .query import query_min_core_plain
from .sketch import effective_k, sketch_gate_band, sketch_matrix

# Launches per kernel since the last reset_launch_counts(); bumped only
# where a wrapper launches its CUDA kernel.
LAUNCHES = {"count_pairs": 0, "minlab_pairs": 0, "count_pairs_sketch": 0,
            "minlab_pairs_sketch": 0, "query_leaf": 0}

PLAIN = {
    "count_pairs": counts_over_pairs,
    "minlab_pairs": minlab_over_pairs,
    "count_pairs_sketch": counts_over_pairs_sketch,
    "minlab_pairs_sketch": minlab_over_pairs_sketch,
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
                     sketch: int = 0, slab=None):
    """Live tile-pair list on the kernels' own tile grid.

    ``points_dn`` (d, N) float32; ``mask`` (N,) bool.  ``src_mask``
    optionally tightens the column boxes.  ``sketch`` (a resolved k, 0
    = off) extracts over the (skp)-row slab boxes at the gate
    :func:`sketch_gate` instead of the full-d boxes; ``slab`` is a
    staged ``(slab, band)`` pair (None stages it here over ``mask |
    src_mask``).  The tile never depends on the sketch.  Returns
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
        lo, hi, gate, lo_col, hi_col, budget=budget
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


def _launch_sketch(name, pts, colval, row_ptr, cols, slab, k, eps2, band,
                   tile):
    """Both sketch kernels: B3 returns ``(counts, stats)``, B4 the
    minimum labels."""
    _check(pts, colval, row_ptr, cols, tile)
    _check_slab(pts, slab, k)
    if pts.device.type == "cpu":
        return PLAIN[name](pts, colval, row_ptr, cols, slab, k, eps2, band,
                           tile)
    if pts.device.type != "cuda":
        raise ValueError(f"unsupported device {pts.device}")
    from ..csrc import _build

    lib = _build.load()
    d, n = pts.shape
    out = torch.empty(n, dtype=torch.int32, device=pts.device)
    counting = name == "count_pairs_sketch"
    if counting:
        # band_pairs (one 64-bit counter) and one rescore flag per
        # pair-list entry, summed below.
        n_band = torch.zeros(1, dtype=torch.int64, device=pts.device)
        flags = torch.zeros(max(cols.shape[0], 1), dtype=torch.int32,
                            device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"pp_{name}")(
            pts.data_ptr(), slab.data_ptr(), colval.data_ptr(),
            row_ptr.data_ptr(), cols.data_ptr(), float(eps2), float(band),
            n, d, slab.shape[0], k, tile, n // tile, out.data_ptr(),
            n_band.data_ptr() if counting else None,
            flags.data_ptr() if counting else None, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    if counting:
        return out, torch.cat([n_band, flags.sum(dtype=torch.int64)[None]])
    return out


def count_pairs_sketch(pts, mask, row_ptr, cols, slab, k, eps2, band, tile):
    """B3: :func:`count_pairs` through the slab gate.  ``slab`` (skp, N)
    float32 from :func:`sketch_stage` (row ``k`` the residual norm);
    ``band`` its float32 halfwidth.  Returns ``(counts, stats)``, equal
    to :func:`count_pairs` on any data, with ``stats`` a (2,) int64
    tensor ``[band_pairs, rescored_tiles]``: pairs neither certainly in
    nor certainly out whose column is valid (every row counted), and
    pair-list entries holding one."""
    return _launch_sketch("count_pairs_sketch", pts, mask, row_ptr, cols,
                          slab, k, eps2, band, tile)


def minlab_pairs_sketch(pts, labels, row_ptr, cols, slab, k, eps2, band,
                        tile):
    """B4: :func:`minlab_pairs` through the slab gate (no stats)."""
    return _launch_sketch("minlab_pairs_sketch", pts, labels, row_ptr,
                          cols, slab, k, eps2, band, tile)


def _grid(points_dn, block, precision):
    d, n = points_dn.shape
    tile = _pallas_block(
        block, n, d, require_ported(norm_precision_mode(precision))
    )
    if n % tile != 0:
        raise ValueError(f"tile {tile} does not divide n={n}")
    return tile, n // tile


def neighbor_counts_cuda(points_dn, eps, mask, block: int = 1024,
                         precision: str = "high", pairs=None, sketch=None,
                         slab=None):
    """Counterpart of ``neighbor_counts_pallas`` (layout ``"dn"``):
    per-point eps-neighbour counts, 0 on invalid rows.  ``pairs``: a
    shared ``(rows, cols)`` list from :func:`kernel_pair_list`; None
    extracts here, and a truncated list makes every count -1.

    ``sketch``: a spec (None reads ``PPTORCH_SKETCH``); a resolved k > 0
    runs B3 over the slab (``slab``: a staged ``(slab, band)`` pair, or
    None to stage it over ``mask``) and returns ``(counts, stats)``,
    stats the (2,) int64 ``[band_pairs, rescored_tiles]``."""
    tile, nt = _grid(points_dn, block, precision)
    k = effective_k(sketch, points_dn.shape[0])
    if k:
        slab = _staged(points_dn, mask, k, norm_precision_mode(precision),
                       slab)
    poison = False
    if pairs is None:
        pairs, (total, budget) = kernel_pair_list(
            points_dn, eps, mask, block, precision, sketch=k, slab=slab
        )
        poison = total > budget
    rows, cols = pairs
    args = (points_dn, mask.to(torch.int32), row_offsets(rows, nt),
            cols.contiguous())
    if k:
        counts, stats = count_pairs_sketch(
            *args, slab[0], k, eps2_f32(eps), slab[1], tile
        )
    else:
        counts = count_pairs(*args, eps2_f32(eps), tile)
    counts = torch.where(mask, counts, 0)
    if poison:
        counts = torch.full_like(counts, -1)
    return (counts, stats) if k else counts


def min_neighbor_label_cuda(points_dn, labels, eps, src_mask,
                            block: int = 1024, precision: str = "high",
                            row_mask=None, pairs=None, sketch=None,
                            slab=None):
    """Counterpart of ``min_neighbor_label_pallas`` (layout ``"dn"``):
    per-point minimum label over ``src_mask`` points within eps.  Rows
    outside ``row_mask`` return arbitrary values the caller masks;
    ``row_mask`` only tightens the tile boxes of a self-extracted list,
    and a truncated one poisons every row to INT32_MIN.  ``sketch`` and
    ``slab`` as in :func:`neighbor_counts_cuda` (the slab staged over
    ``row_mask | src_mask``); with k > 0 B4 runs and the return is
    ``(best, zeros(2))``, as the JAX entry point's."""
    tile, nt = _grid(points_dn, block, precision)
    k = effective_k(sketch, points_dn.shape[0])
    rm = torch.ones_like(src_mask) if row_mask is None else row_mask
    if k:
        slab = _staged(points_dn, rm, k, norm_precision_mode(precision),
                       slab, src_mask)
    poison = False
    if pairs is None:
        pairs, (total, budget) = kernel_pair_list(
            points_dn, eps, rm, block, precision, src_mask=src_mask,
            sketch=k, slab=slab,
        )
        poison = total > budget
    rows, cols = pairs
    labi = torch.where(src_mask, labels.to(torch.int32), INT_INF)
    args = (points_dn, labi.contiguous(), row_offsets(rows, nt),
            cols.contiguous())
    if k:
        best = minlab_pairs_sketch(
            *args, slab[0], k, eps2_f32(eps), slab[1], tile
        )
    else:
        best = minlab_pairs(*args, eps2_f32(eps), tile)
    if poison:
        best = torch.full_like(best, -(2**31))
    if k:
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
