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

The kernel skips what cannot change an answer: it answers pad rows from
a per-index table (:func:`query_pad_keys`), stops each real row at its
leaf's end (:func:`query_leaf_ends`) and, under ``"mixed"``, decides
units of 32 query rows from per-index block frames
(:func:`query_block_frames`).  :func:`query_skip_walk` and
:func:`query_keep_walk` are those rules in plain torch.
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


def _sqrt_rn(x):
    """float32 square roots rounded correctly, as the kernel's
    ``__fsqrt_rn``: taken in float64 and rounded once to float32 (float64
    holds more than twice float32's bits, so the double rounding of a
    square root is harmless).  torch's float32 ``sqrt`` on the CPU may
    miss by an ulp."""
    return torch.sqrt(x.double()).float()


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
    real, ctr, c2, nc, gc = keep_frames(cols, labs)
    qreal = (q.abs() < _PAD_LIMIT).all(dim=1)
    qd = q.permute(1, 0, 2)[:, :, None, :]  # (d, nqt, 1, qb)
    qc = qd - ctr
    cc = cols - ctr
    qq = axis_sq(qc)  # (nqt, nbk, qb)
    dot = torch.matmul(bf16_round(qc).permute(1, 2, 3, 0),
                       bf16_round(cc).permute(1, 2, 0, 3))
    d2f = (qq[..., None] + c2[..., None, :]) - 2.0 * dot
    band = fast_band(
        _sqrt_rn(qq)[..., None], nc[..., None, :],
        _sqrt_rn(axis_sq(qd))[..., None], gc[..., None, :],
    )
    ok = ((d2f - band <= eps2) & real[..., None, :]
          & qreal[:, None, :, None])
    return ok.any(dim=3).any(dim=2)


def keep_frames(cols, labs):
    """The column side of :func:`fast_block_keep` for ``cols`` (d, ...,
    block) and ``labs`` (..., block): ``(real, ctr, |y - c|^2, |y - c|,
    |y|)``, ``ctr`` (d, ..., 1) the box midpoint of each block's real
    slots (0 for a block without one); the norms are those of real
    slots (inf or garbage elsewhere, which the real mask excludes)."""
    real = labs != INT_INF
    big = float(BIG)
    hi = torch.where(real[None], cols, -big).amax(dim=-1)
    lo = torch.where(real[None], cols, big).amin(dim=-1)
    ctr = (0.5 * (hi + lo))[..., None]
    c2 = axis_sq(cols - ctr)
    return real, ctr, c2, _sqrt_rn(c2), _sqrt_rn(axis_sq(cols))


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


# -- the kernel's per-index tables and its skipping, in plain torch ----

# Query rows per unit of the "mixed" prefilter: one warp's rows.
QUERY_GROUP = 32
# PAD_COORD's bits: a pad row or pad slot holds them in every axis.
_PAD_BITS = int(np.float32(PAD_COORD).view(np.int32))


def query_keys(packed):
    """(2, ...) int32 ``[labels, bits(d2)]`` -> the kernel's 64-bit keys
    ``(bits(d2) << 32) | (label ^ 2^31)`` as int64: d2 >= 0 orders by
    its bits and the flipped sign bit orders labels, so the least key
    is the lexicographic least ``(d2, label)``."""
    lab, bits = packed[0].long(), packed[1].long()
    return ((bits & 0xFFFFFFFF) << 32) | ((lab & 0xFFFFFFFF) ^ 0x80000000)


def query_pad_keys(coords, labels, C):
    """(L,) int64: per leaf, the key B5 gives a pad row (PAD_COORD in
    every axis) against the leaf's whole slab -- ``query_min_core_plain``
    on one such row per leaf.  With a pad slot in the slab that is (0,
    INT32_MAX); with none, every real slot's d2 overflows to +inf and it
    is (+inf, the leaf's least label).  The kernel's table; the kernel
    answers a pad row from it without a pass."""
    d, n = coords.shape
    L = n // C
    q = torch.full((L, d, 1), float(PAD_COORD), dtype=torch.float32,
                   device=coords.device)
    leaf = torch.arange(L, dtype=torch.int32, device=coords.device)
    packed = query_min_core_plain(q, leaf, coords, labels, block=C, nb=1)
    return query_keys(packed[:, :, 0])


def query_leaf_ends(coords, labels, C):
    """(L,) int32: per leaf, one past its last slot that is not a pad
    slot (label INT32_MAX and PAD_COORD's bits in every axis; 0 for a
    leaf of pads).  The kernel's table: against a row with some ``|q_a|
    < 1e18`` a pad slot's d2 is +inf and its key (+inf, INT32_MAX) the
    starting key, so every slot past the end is skipped without changing
    the answer."""
    pad = ((labels == INT_INF)
           & (coords.view(torch.int32) == _PAD_BITS).all(dim=0))
    real = ~pad.reshape(-1, C)
    pos = torch.arange(1, C + 1, dtype=torch.int32, device=coords.device)
    return torch.where(real, pos, 0).amax(dim=1).to(torch.int32)


def query_block_frames(coords, labels, block):
    """The "mixed" prefilter's per-index frames, per column block of
    ``block`` slots: ``ctr`` (L*nb, d) float32, the box midpoint of the
    block's real slots (label != INT32_MAX; 0 for a block without one),
    and ``slots`` (L*C, 4) float32 ``[|y - c|^2, |y - c|, |y|, real]``
    per slot (the squares summed axis by axis in index order; zeros at
    a slot that is not real).  The kernel's table, built per index and
    again at every live commit; :func:`fast_block_keep` computes the
    same per call."""
    d, n = coords.shape
    nbk = n // block
    real = (labels != INT_INF).reshape(nbk, block)
    c3 = coords.reshape(d, nbk, block)
    big = float(BIG)
    hi = torch.where(real, c3, -big).amax(dim=-1)
    lo = torch.where(real, c3, big).amin(dim=-1)
    ctr = 0.5 * (hi + lo)  # (d, nbk)
    cc = torch.where(real, axis_sq(c3 - ctr[..., None]), 0.0)
    gc = torch.where(real, axis_sq(c3), 0.0)
    slots = torch.stack([cc, _sqrt_rn(cc), _sqrt_rn(gc),
                         real.to(torch.float32)], dim=-1)
    return ctr.T.contiguous(), slots.reshape(n, 4)


def query_skip_walk(q, tile_leaf, coords, labels, pad_keys, leaf_end, *,
                    block, nb):
    """Exact B5 as the kernel skips, in plain torch: a pad row takes its
    leaf's pad key, a real row the least ``(d2, label)`` over its leaf's
    slots below the leaf's end (the whole slab where every ``|q_a| >=
    1e18``).  Returns the packed (2, nqt, qb) int32 result, which equals
    :func:`query_min_core_plain`'s bit for bit on any input."""
    nqt, d, qb = q.shape
    C = nb * block
    slabs = coords.reshape(d, -1, C)
    labs = labels.reshape(-1, C)
    leaf = tile_leaf.long()
    # Pad rows hold PAD_COORD's bits in every axis; a real row whose every
    # coordinate lies at or past 1e18 may meet a pad slot at a finite d2.
    pad = (q.view(torch.int32) == _PAD_BITS).all(dim=1)
    near = ~pad & (q.abs() >= _PAD_LIMIT).all(dim=1)
    lim = torch.where(near, C, leaf_end.long()[leaf][:, None])  # (nqt, qb)
    best_d2 = torch.full((nqt, qb), float("inf"), dtype=torch.float32,
                         device=q.device)
    best_lab = torch.full((nqt, qb), INT_INF, dtype=torch.int32,
                          device=q.device)
    top = int(torch.where(pad, 0, lim).max()) if nqt * qb else 0
    elems = _PLAIN_ELEMS * (4 if q.is_cuda else 1)
    step = max(1, elems // max(nqt * qb * block, 1)) * block
    for c0 in range(0, top, step):
        c1 = min(c0 + step, top)
        cols = slabs[:, leaf, c0:c1]
        diff = q[:, 0, :, None] - cols[0][:, None, :]
        acc = diff * diff
        for a in range(1, d):
            diff = q[:, a, :, None] - cols[a][:, None, :]
            acc = acc + diff * diff
        pos = torch.arange(c0, c1, device=q.device)
        inside = pos < lim[..., None]
        acc = torch.where(inside, acc, float("inf"))
        lab = torch.where(inside, labs[leaf, c0:c1][:, None, :], INT_INF)
        best_d2, best_lab = _block_best(acc, lab, best_d2, best_lab)
    keys = query_keys(torch.stack([best_lab, best_d2.view(torch.int32)]))
    keys = torch.where(pad, pad_keys[leaf][:, None], keys)
    return torch.stack([
        ((keys & 0xFFFFFFFF) ^ 0x80000000).to(torch.int32),
        (keys >> 32).to(torch.int32),
    ])


def _ulp_slack(v):
    return v.abs() * 2.0 ** -22


def _groups(x, G):
    """(nqt, nbk, qb, w) -> (nqt, nbk, G, QUERY_GROUP, w), the rows
    padded with False to whole groups."""
    nqt, nbk, qb, w = x.shape
    out = torch.zeros(nqt, nbk, G * QUERY_GROUP, w, dtype=torch.bool,
                      device=x.device)
    out[:, :, :qb] = x
    return out.reshape(nqt, nbk, G, QUERY_GROUP, w)


def query_keep_walk(q, tile_leaf, coords, labels, frames, leaf_end, eps2,
                    *, block, nb):
    """The "mixed" prefilter's decisions in plain torch, in the kernel's
    unit: (tile, group of :data:`QUERY_GROUP` rows, column block).

    A unit is visited when its group holds a real query row (every
    ``|q_a| < 1e18``) and its block starts below the leaf's end; it is
    kept when some pair of a real row and a real slot has ``d2f - band
    <= eps2`` (``d2f``, ``band`` as :func:`fast_block_keep` forms them,
    from the per-index ``frames`` of :func:`query_block_frames`).  Only
    the cross term's summation order differs from the kernel's, so the
    walk also counts the fragile units: no pair keeps by more than the
    order could move (``2 (K + 2) 2^-23 |bf16(q-c)| |bf16(y-c)|`` plus
    rounding at 2^-22), and some pair lies within that of eps2.  The
    card's kept count may differ from the walk's by at most those.  The
    walk also counts the kept pairs: the (real row, real slot) pairs with
    ``d2f - band <= eps2``, the exact work the function needs after the
    prefilter, whatever unit a kernel decides in.  Returns ``(keep (nqt,
    G, nb) bool, [kept, visited, fragile, kept pairs])``."""
    nqt, d, qb = q.shape
    C = nb * block
    G = -(-qb // QUERY_GROUP)
    ctr, slots = frames
    leaf = tile_leaf.long()
    slabs = coords.reshape(d, -1, C)
    sframe = slots.reshape(-1, C, 4)
    cblk = ctr.reshape(-1, nb, d)
    qreal = (q.abs() < _PAD_LIMIT).all(dim=1)  # (nqt, qb)
    greal = _groups(qreal[:, None, :, None], G).any(dim=3)[:, 0, :, 0]
    nbend = (leaf_end.long()[leaf] + block - 1) // block  # (nqt,)
    bidx = torch.arange(nb, device=q.device)
    visited = greal[:, :, None] & (bidx < nbend[:, None])[:, None, :]
    keep = torch.zeros(nqt, G, nb, dtype=torch.bool, device=q.device)
    fragile = torch.zeros_like(keep)
    kept_pairs = 0
    kpad = -(-d // 16) * 16
    gq = _sqrt_rn(axis_sq(q.permute(1, 0, 2)))  # (nqt, qb)
    elems = _PLAIN_ELEMS * (4 if q.is_cuda else 1)
    per = max(1, elems // max(nqt * qb * block, 1))
    for b0 in range(0, int(nbend.max()) if nqt else 0, per):
        b1 = min(b0 + per, nb)
        nbk = b1 - b0
        c = cblk[leaf, b0:b1].permute(2, 0, 1)  # (d, nqt, nbk)
        y = slabs[:, leaf, b0 * block:b1 * block].reshape(
            d, nqt, nbk, block)
        f = sframe[leaf, b0 * block:b1 * block].reshape(nqt, nbk, block, 4)
        qc = q.permute(1, 0, 2)[:, :, None, :] - c[..., None]  # d,t,b,r
        xx = axis_sq(qc)  # (nqt, nbk, qb)
        bq = bf16_round(qc)
        by = bf16_round(y - c[..., None])  # (d, nqt, nbk, block)
        dot = torch.einsum("atbr,atbs->tbrs", bq, by)
        cc, nc, gc, sreal = (f[..., i][:, :, None, :] for i in range(4))
        d2f = (xx[..., None] + cc) - 2.0 * dot
        band = fast_band(_sqrt_rn(xx)[..., None], nc,
                         gq[:, None, :, None], gc)
        m = (d2f - band) - eps2
        tol = (2.0 * (kpad + 2) * 2.0 ** -23
               * torch.sqrt(axis_sq(bq))[..., None]
               * torch.sqrt(axis_sq(by))[:, :, None, :]
               + _ulp_slack(xx[..., None] + cc) + _ulp_slack(2.0 * dot)
               + _ulp_slack(band) + _ulp_slack(torch.tensor(eps2)))
        pair = (sreal > 0) & qreal[:, None, :, None]
        kept_pairs += int(((m <= 0) & pair).sum())

        def unit(x):
            return _groups(x & pair, G).any(dim=4).any(dim=3).permute(
                0, 2, 1)

        keep[:, :, b0:b1] = unit(m <= 0)
        sure = unit(m < -tol)
        near_eps = unit(m.abs() <= tol)
        fragile[:, :, b0:b1] = ~sure & near_eps
    keep &= visited
    fragile &= visited
    counts = torch.tensor([int(keep.sum()), int(visited.sum()),
                           int(fragile.sum()), kept_pairs],
                          dtype=torch.int64)
    return keep, counts


def query_pass_pairs(q, tile_leaf, leaf_end, *, block, nb, keep=None):
    """The (row, slot) pairs B5's exact pass computes, counted as the
    kernel's optional pass counter counts them: a group of
    :data:`QUERY_GROUP` rows runs (all its rows, pad lanes included)
    over the columns below its limit, which is 0 without a real row, the
    whole slab ``C`` with a real row whose every ``|q_a| >= 1e18``, else
    its leaf's end.  Under ``"mixed"`` ``keep`` (nqt, G, nb) bool, the
    prefilter's units, limits it to the kept column blocks.  Returns an
    int."""
    nqt, d, qb = q.shape
    C = nb * block
    G = -(-qb // QUERY_GROUP)
    pad = (q.view(torch.int32) == _PAD_BITS).all(dim=1)
    near = ~pad & (q.abs() >= _PAD_LIMIT).all(dim=1)

    def grouped(x):  # (nqt, qb) -> (nqt, G): any row of the group
        return _groups(x[:, None, :, None], G).any(dim=3)[:, 0, :, 0]

    end = leaf_end.long()[tile_leaf.long()][:, None]
    lim = torch.where(grouped(near), C, torch.where(grouped(~pad), end, 0))
    if keep is None:
        return int(lim.sum()) * QUERY_GROUP
    b0 = torch.arange(nb, device=q.device) * block
    cols = (torch.minimum(lim[..., None], b0 + block) - b0).clamp(min=0)
    return int((cols * keep).sum()) * QUERY_GROUP


def unpack_query_result(packed):
    """Host decode of the packed (2, nqt, qb) int32 result: ``(raw
    labels, raw d2)`` before the within-eps verdict (the engine folds a
    query's leaves first, then applies ``d2 <= eps2``)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    return packed[0], packed[1].view(np.float32)

