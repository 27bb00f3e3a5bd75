"""Primitives behind live insert/delete on a fitted model (counterpart
of ``pypardis_tpu/ops/incremental.py``).

Inserting or deleting a point changes core flags only within eps of
it, and labels only within eps of a flipped flag (Ester et al., VLDB
1998), so the write path never needs a global pass.  This module holds
the primitives :class:`pypardis_tpu_torch.serve.live.LiveModel` builds
on:

* :func:`count_within_eps` / :func:`within_eps_mask` — exact neighbour
  counts of a query set against a candidate set, in **float64 on the
  raw coordinates**: one frame for the whole update sequence, where a
  maintained float32 verdict would move with the dataset's mean.  They
  run as torch ops on the tensors' device (the card for a live model
  on the card), so a batch spread over a large model is counted where
  its points live.  :func:`count_reaches` answers "at least k" with the
  same verdicts, stopping a row once it has k.
* :func:`core_components` — eps-connectivity components of a set of
  known core points: the fit's pipeline (``dbscan._pad_and_run``, B1
  and B2 on the card) with ``min_samples=1``, over a slab padded to a
  power-of-two bucket with sentinel rows.
* :func:`attach_to_cores` — border assignment: the nearest core within
  eps, ties to the smallest label (the serving rule), in the same
  float64 frame as the counts.

d² is summed axis by axis in index order, ``d2 += (a_j - b_j)^2``, the
subtract, the square and the add each a separate op: nothing is fused
into a multiply-add, so the bits are the same on the CPU and the card.
They may differ from numpy's ``einsum`` (the JAX package's form) by an
ulp of d², which moves a verdict only for a pair within an ulp of eps².
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .distances import INT_INF

# Elements of one (rows, candidates) float64 d² temporary: 512 MiB.
_CHUNK_ELEMS = 1 << 26


def _chunk_rows(n_cand: int) -> int:
    return max(1, _CHUNK_ELEMS // max(n_cand, 1))


def _f64(x, device=None) -> torch.Tensor:
    """``x`` (an array or a tensor) as a float64 tensor on ``device``
    (default: the tensor's own device, the CPU for an array)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float64)
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    return t if device is None else t.to(device)


def sq_dists_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) x (n, k) -> (m, n) float64 squared distances, summed axis
    by axis in index order with one rounding per op (callers chunk)."""
    d2 = None
    for j in range(a.shape[1]):
        diff = a[:, j, None] - b[None, :, j]
        diff = diff.mul_(diff)
        d2 = diff if d2 is None else d2.add_(diff)
    return d2


def count_within_eps(queries, candidates, eps: float) -> torch.Tensor:
    """(m,) int64 counts of candidate points within ``eps`` (inclusive,
    the fit's ``d2 <= eps^2``) of each query row, on the queries'
    device.  A query that is also a candidate counts itself, as the
    core rule's min_samples does."""
    q = _f64(queries)
    c = _f64(candidates, q.device)
    out = torch.zeros(len(q), dtype=torch.int64, device=q.device)
    if len(q) == 0 or len(c) == 0:
        return out
    e2 = float(eps) ** 2
    step = _chunk_rows(len(c))
    for s in range(0, len(q), step):
        out[s:s + step] = (sq_dists_f64(q[s:s + step], c) <= e2).sum(dim=1)
    return out


def count_reaches(queries, candidates, eps: float, need,
                  first_cols: int = 4096) -> torch.Tensor:
    """(m,) bool: at least ``need`` (an int or a per-row array) of the
    candidates lie within ``eps`` of each query row, on the queries'
    device.  The same pair verdicts as :func:`count_within_eps`, so
    ``count_reaches(q, c, eps, k) == (count_within_eps(q, c, eps) >=
    k)``.  The candidates are taken in chunks of ``first_cols``
    columns, then twice as many each round, and a row leaves the work
    once it has reached ``need``: a dense model's core test reads its
    first chunk, not its whole pool, and a row that never reaches costs
    under twice a full count in at most ``log2(n / first_cols) + 1``
    rounds (each a host sync)."""
    q = _f64(queries)
    c = _f64(candidates, q.device)
    left = torch.as_tensor(
        np.asarray(need, np.int64) if not isinstance(need, torch.Tensor)
        else need).to(q.device, torch.int64).expand(len(q)).clone()
    pending = torch.nonzero(left > 0).flatten()
    s, width = 0, max(int(first_cols), 1)
    while s < len(c) and len(pending):
        left[pending] -= count_within_eps(q[pending], c[s:s + width], eps)
        pending = pending[left[pending] > 0]
        s, width = s + width, 2 * width
    return left <= 0


def within_eps_mask(queries, candidates, eps: float) -> torch.Tensor:
    """(m,) bool: the query row has some candidate within eps."""
    return count_within_eps(queries, candidates, eps) > 0


def attach_to_cores(points, cores, core_labels, eps: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(labels, d2)`` per point on the points' device: the cluster of
    the nearest core within eps (ties: the smallest label), -1 and +inf
    where no core reaches.  The serving rule, in the counts' float64
    frame."""
    p = _f64(points)
    c = _f64(cores, p.device)
    lab = torch.as_tensor(np.asarray(core_labels, np.int64)
                          if not isinstance(core_labels, torch.Tensor)
                          else core_labels).to(p.device, torch.int64)
    m = len(p)
    out_lab = torch.full((m,), -1, dtype=torch.int32, device=p.device)
    out_d2 = torch.full((m,), float("inf"), dtype=torch.float64,
                        device=p.device)
    if m == 0 or len(c) == 0:
        return out_lab, out_d2
    e2 = float(eps) ** 2
    step = _chunk_rows(len(c))
    for s in range(0, m, step):
        d2 = sq_dists_f64(p[s:s + step], c)
        dmin = d2.amin(dim=1)
        tied = torch.where(d2 == dmin[:, None], lab[None, :], INT_INF)
        labmin = tied.amin(dim=1)
        sel = dmin <= e2
        out_lab[s:s + step] = torch.where(sel, labmin, -1).to(torch.int32)
        out_d2[s:s + step] = torch.where(sel, dmin, float("inf"))
    return out_lab, out_d2


def bucket_size(n: int, floor: int = 64) -> int:
    """Power-of-two bucket of :func:`core_components` slabs."""
    b = max(int(floor), 1)
    while b < int(n):
        b *= 2
    return b


def core_components(
    cores,
    eps: float,
    *,
    block: int = 256,
    precision: str = "high",
    backend: str = "auto",
    bucket: bool = True,
    min_bucket: int = 64,
    device=None,
) -> np.ndarray:
    """(n,) int32 eps-connectivity component ids (dense, from 0) of a set
    of known core points: the fit's pipeline with ``min_samples=1`` on
    ``device`` (B1 and B2 on the card), whose every point is core, so
    its clusters are the eps-graph's components.

    ``bucket`` pads the slab to a power-of-two size with sentinel rows
    on a grid 3·eps apart past the data's upper corner (each its own
    component, after every real point), bit for bit the JAX package's
    grid: the sentinels take part in the fit's frame and Morton order,
    so they fix the numbering of the real components.  The grid and the
    centring are computed in host numpy from the slab's float64 rows
    (a tensor is brought to the host), as the JAX package computes
    them, so the numbering is its numbering.
    """
    if isinstance(cores, torch.Tensor):
        device = cores.device if device is None else device
        cores = cores.detach().cpu().numpy()
    cores = np.asarray(cores, np.float64)
    n = len(cores)
    if n == 0:
        return np.empty(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    from ..dbscan import _pad_and_run
    from .labels import densify_labels

    run = cores
    if bucket:
        pad = bucket_size(n, min_bucket) - n
        if pad > 0:
            # A compact grid, not a line: the fit recentres in float32,
            # whose distance error grows with the slab's spread, so a
            # pad-long line of sentinels would blur the real pairs.
            k = cores.shape[1]
            step = 3.0 * max(float(eps), 1e-6)
            g, side = 1, pad
            while side > 8 and g < k:
                g += 1
                side = int(np.ceil(pad ** (1.0 / g)))
            side = max(side, 2)
            hi = cores.max(axis=0)
            far = np.tile(cores.mean(axis=0), (pad, 1))
            idx = np.arange(pad)
            for a in range(g):
                far[:, a] = hi[a] + step * (2 + (idx % side))
                idx = idx // side
            run = np.concatenate([cores, far])
    roots, _core, _info = _pad_and_run(
        run, eps, 1, block, precision=precision, backend=backend,
        device=device,
    )
    return densify_labels(roots)[:n]


def label_lut(mapping: dict, max_id: int) -> np.ndarray:
    """Dense int32 LUT of a union-find label mapping
    (:func:`pypardis_tpu_torch.parallel.merge.resolve_label_edges`),
    identity outside the mapping, so one gather applies it to any label
    array (the index's labels on the card among them)."""
    lut = np.arange(max(int(max_id) + 1, 1), dtype=np.int32)
    for k, v in mapping.items():
        if 0 <= int(k) < len(lut):
            lut[int(k)] = int(v)
    return lut
