"""Out-of-sample query primitive: nearest core point within eps
(counterpart of ``pypardis_tpu/ops/query.py``).

A query joins cluster ``c`` iff it lies within eps of a core point of
``c``; it takes the label of its nearest core point, the smallest label
among equally near ones, else it is noise.  ``(min d^2, then min
label)`` is the whole rule, and it gives the same answer in any
reduction order.

Exactness: d^2 is ``(q_a - c_a)^2`` summed over the axes in index
order, each subtraction, product and sum rounded on its own.  The numpy
oracle (:func:`brute_force_query`), the plain PyTorch version
(:func:`query_min_core_plain`; eager ops round once each, so nothing is
contracted into a fused multiply-add) and the CUDA kernel B5
(``csrc/query_kernels.cu``, written with ``__fsub_rn``/``__fmul_rn``/
``__fadd_rn``) repeat that sequence, so all three agree bit for bit.

Layout, as in the JAX package: core slabs in the ``(d, L*C)`` layout,
one padded slab of ``C`` slots per KD leaf, ``C`` a multiple of the
column ``block``.  Pad slots carry :data:`PAD_COORD` (its squared
difference with any real coordinate overflows to +inf) and INT32_MAX
labels, so no mask enters the computation.  Queries arrive as ``(nqt,
d, qb)`` tiles, each scanning the slab of leaf ``tile_leaf[i]``.

``precision="mixed"`` adds the bf16 block prefilter
(:func:`fast_block_keep`, the JAX package's ``_fast_block_keep``): a
column block whose every real (query, core) pair has a bf16 lower bound
past eps^2 is skipped, the rest run the unchanged exact pass.  A row
with a core within eps gets the same answer; a row without one may keep
+inf where the exact pass finds a farther core, so results are compared
after the within-eps verdict.
"""

from __future__ import annotations

import numpy as np
import torch

from .distances import INT_INF, axis_sq, bf16_round, eps2_f32, fast_band

# Pad-slot coordinate: (PAD_COORD - x)^2 overflows float32 to +inf for
# any real x, so pad slots lose every min and fail every eps test.
PAD_COORD = np.float32(2e19)
# Inverted-box sentinel for the per-block bounds of empty blocks.
BIG = np.float32(3e38)

_INT_INF32 = np.int32(INT_INF)

# Elements of one (nqt, qb, columns) d^2 temporary of the plain version:
# ~64MB on the CPU, ~256MB on the card.
_PLAIN_ELEMS = 1 << 24


def axis_sq_dists(q, c):
    """(m, d) x (n, d) -> (m, n) float32 squared distances, accumulated
    per axis in index order, each numpy op rounded on its own."""
    diff = q[:, 0, None] - c[None, :, 0]
    acc = diff * diff
    for a in range(1, q.shape[1]):
        diff = q[:, a, None] - c[None, :, a]
        acc = acc + diff * diff
    return acc


def brute_force_query(queries, cores, labels, eps):
    """The numpy oracle: exact ``(labels, d2)`` per query over all
    cores (already centred; cast to float32).  Label -1 and d2 = +inf
    where no core lies within eps."""
    q = np.asarray(queries, np.float32)
    c = np.asarray(cores, np.float32)
    lab = np.asarray(labels, np.int32)
    m = len(q)
    out_lab = np.full(m, -1, np.int32)
    out_d2 = np.full(m, np.inf, np.float32)
    if m == 0 or len(c) == 0:
        return out_lab, out_d2
    e2 = np.float32(eps2_f32(eps))
    # Chunk queries so the (chunk, n_core) temporary stays ~256MB.
    chunk = max(1, (1 << 26) // max(len(c), 1))
    for s in range(0, m, chunk):
        d2 = axis_sq_dists(q[s:s + chunk], c)
        dmin = d2.min(axis=1)
        tied = np.where(d2 == dmin[:, None], lab[None, :], _INT_INF32)
        labmin = tied.min(axis=1).astype(np.int32)
        sel = dmin <= e2
        out_lab[s:s + chunk] = np.where(sel, labmin, -1)
        out_d2[s:s + chunk] = np.where(sel, dmin, np.float32(np.inf))
    return out_lab, out_d2


def _block_best(d2, lab, best_d2, best_lab):
    """Fold a (nqt, qb, w) distance tile with its (nqt, 1, w) labels
    into the per-row running ``(min d2, min label among ties)``."""
    m = d2.amin(dim=2)
    cand = torch.where(d2 == m[..., None], lab, INT_INF).amin(dim=2)
    take = (m < best_d2) | ((m == best_d2) & (cand < best_lab))
    return torch.where(take, m, best_d2), torch.where(take, cand, best_lab)


# A query or slot coordinate at or past this magnitude is padding.
_PAD_LIMIT = 1e18


def fast_block_keep(q, cols, labs, eps2):
    """The bf16 block prefilter: for each query tile and column block,
    whether some real pair's exact d^2 could lie within eps.

    ``q`` (nqt, d, qb) query tiles; ``cols`` (d, nqt, nbk, block) and
    ``labs`` (nqt, nbk, block) each tile's column blocks.  Both sides
    recentre on the block's box midpoint over its real slots (label !=
    INT32_MAX), round to bf16, and ``d2f = |q-c|^2 + |y-c|^2 - 2
    bf16(q-c).bf16(y-c)``; the per-element band is
    :func:`~.distances.fast_band` at the recentred and the index-frame
    norms (``query.py``'s ``band_halfwidth(|q-c|, |y-c|) +
    exact_slack(|q|, |y|)``), so ``d2f - band`` lower-bounds the exact
    d^2.  Pad slots and pad query rows (a coordinate past 1e18) are
    excluded by mask, never by the inf/NaN arithmetic they produce.
    Returns (nqt, nbk) bool."""
    real = labs != INT_INF
    qreal = (q.abs() < _PAD_LIMIT).all(dim=1)
    big = float(BIG)
    hi = torch.where(real[None], cols, -big).amax(dim=-1)
    lo = torch.where(real[None], cols, big).amin(dim=-1)
    ctr = (0.5 * (hi + lo))[..., None]  # (d, nqt, nbk, 1)
    qd = q.permute(1, 0, 2)[:, :, None, :]  # (d, nqt, 1, qb)
    qc = qd - ctr
    cc = cols - ctr
    qq = axis_sq(qc)  # (nqt, nbk, qb)
    c2 = axis_sq(cc)  # (nqt, nbk, block)
    dot = torch.matmul(bf16_round(qc).permute(1, 2, 3, 0),
                       bf16_round(cc).permute(1, 2, 0, 3))
    d2f = (qq[..., None] + c2[..., None, :]) - 2.0 * dot
    band = fast_band(
        torch.sqrt(qq)[..., None], torch.sqrt(c2)[..., None, :],
        torch.sqrt(axis_sq(qd))[..., None], torch.sqrt(axis_sq(cols))[
            ..., None, :],
    )
    ok = ((d2f - band <= eps2) & real[..., None, :]
          & qreal[:, None, :, None])
    return ok.any(dim=3).any(dim=2)


def query_min_core_plain(q, tile_leaf, coords, labels, *, block, nb,
                         precision="high", eps2=None):
    """Plain PyTorch version of B5: per query row, ``(min d2, min label
    among ties)`` over every slot of its tile's leaf slab.

    ``q`` (nqt, d, qb) float32 centred query tiles (pad rows at
    PAD_COORD); ``tile_leaf`` (nqt,) int32; ``coords`` (d, L*C) float32
    with ``C = nb * block``; ``labels`` (L*C,) int32.  Columns go by
    whole blocks, several at a time; d^2 accumulates axis by axis in
    index order with eager ops.  ``precision="mixed"`` (with the
    float32 ``eps2``) leaves out the blocks :func:`fast_block_keep`
    rejects.  Returns the packed (2, nqt, qb) int32 ``[labels,
    bitcast(d2)]`` on ``q``'s device.
    """
    mixed = precision == "mixed"
    if mixed and eps2 is None:
        raise ValueError("precision='mixed' needs eps2 for its prefilter")
    nqt, d, qb = q.shape
    C = nb * block
    slabs = coords.reshape(d, -1, C)
    labs = labels.reshape(-1, C)
    leaf = tile_leaf.long()
    best_d2 = torch.full((nqt, qb), float("inf"), dtype=torch.float32,
                         device=q.device)
    best_lab = torch.full((nqt, qb), INT_INF, dtype=torch.int32,
                          device=q.device)
    elems = _PLAIN_ELEMS * (4 if q.is_cuda else 1)
    step = max(1, elems // max(nqt * qb * block, 1)) * block
    for c0 in range(0, C, step):
        c1 = min(c0 + step, C)
        cols = slabs[:, leaf, c0:c1]  # (d, nqt, w)
        diff = q[:, 0, :, None] - cols[0][:, None, :]
        acc = diff * diff
        for a in range(1, d):
            diff = q[:, a, :, None] - cols[a][:, None, :]
            acc = acc + diff * diff
        lab = labs[leaf, c0:c1]
        if mixed:
            w = c1 - c0
            keep = fast_block_keep(
                q, cols.reshape(d, nqt, w // block, block),
                lab.reshape(nqt, w // block, block), eps2,
            ).repeat_interleave(block, dim=1)
            acc = torch.where(keep[:, None, :], acc, float("inf"))
            lab = torch.where(keep, lab, INT_INF)
        best_d2, best_lab = _block_best(
            acc, lab[:, None, :], best_d2, best_lab
        )
    return torch.stack([best_lab, best_d2.view(torch.int32)])


def unpack_query_result(packed):
    """Host decode of the packed (2, nqt, qb) int32 result: ``(raw
    labels, raw d2)`` before the within-eps verdict (the engine folds a
    query's leaves first, then applies ``d2 <= eps2``)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    return packed[0], packed[1].view(np.float32)

