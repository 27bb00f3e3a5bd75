"""The core-point index behind the query engine (counterpart of
``pypardis_tpu/serve/index.py``).

Built once from a fitted (or checkpoint-loaded) model:

1. take the core points and their labels, centred on their float64
   mean and cast to float32;
2. split them with a deterministic KD tree (:class:`KDPartitioner`,
   ``min_var``) into leaves, and Morton-sort each leaf;
3. pad every leaf to one common capacity ``C``, a multiple of the column
   ``block``: pad slots carry far-away coordinates and INT32_MAX labels,
   so no mask enters the kernel;
4. hold the ``(d, L*C)`` coordinate slab, the label row and the
   per-block bounds as tensors on the index's device, uploaded once
   (:meth:`CorePointIndex.device_tensors`).

Queries route by replaying the same tree with an eps-widened margin
(:func:`expanded_members`): a query within eps of a leaf boundary lands
in every leaf that could hold its nearest within-eps core, so the
per-leaf results fold into the exact global answer.  The host arrays
are byte-identical to the JAX package's index on the same cores.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.query import BIG, INT_INF, PAD_COORD, brute_force_query, eps2_f32
from ..partition import KDPartitioner, expanded_members, spatial_order
from ..utils.shaping import clamp_block, round_up, row_chunks
from ..utils.validate import check_query_points, validate_params

_INT_INF32 = np.int32(INT_INF)

# Routing margin slack over eps: leaf membership is tested in float64
# on float32 coordinates, the within-eps verdict is a float32 sum; the
# slack only ever adds candidate leaves, never changes an answer.
_MARGIN_SLACK = 1.001


def _leaf_partition(cores_c: np.ndarray, leaves: int, seed: int):
    """(tree, {leaf: core indices}) over the centred float32 cores, from
    a fresh deterministic partitioner, so a rebuilt index over the same
    cores is byte-identical in any process."""
    if leaves <= 1 or len(cores_c) < 2:
        return [], {0: np.arange(len(cores_c), dtype=np.int64)}
    part = KDPartitioner(
        cores_c, max_partitions=int(leaves), split_method="min_var",
        seed=seed,
    )
    return part.tree, part.partitions


class CorePointIndex:
    """Core points of a fitted DBSCAN, laid out for batched queries.

    Built by :meth:`build` (from core points and labels) or restored by
    :func:`pypardis_tpu_torch.checkpoint.load_index`.  Host arrays are
    numpy; :meth:`device_tensors` holds them on ``device`` (the card
    unless ``device="cpu"``).
    """

    def __init__(
        self, *, eps, center, tree, coords, labels, blo, bhi,
        block: int, qblock: int, n_core: int, stats: Optional[Dict] = None,
        device=None,
    ):
        from ..dbscan import resolve_device

        self.eps = float(eps)
        self.eps2 = eps2_f32(eps)
        self.center = np.asarray(center, np.float64)
        self.tree = [
            (int(p), int(a), float(b), int(l), int(r))
            for p, a, b, l, r in tree
        ]
        self.coords = np.asarray(coords, np.float32)  # (d, L*C)
        self.labels = np.asarray(labels, np.int32)  # (L*C,)
        self.blo = np.asarray(blo, np.float32)  # (L*nb, d)
        self.bhi = np.asarray(bhi, np.float32)
        self.block = int(block)
        self.qblock = int(qblock)
        self.n_core = int(n_core)
        self.stats: Dict = dict(stats or {})
        self.device = resolve_device(device)
        # Query frame of a driver metric: "unit" (cosine) normalizes
        # queries before centring, "latlon" (haversine) embeds [lat, lon]
        # radians on the unit sphere.  Set by build_index from the
        # model's metric and by load_index.
        self.unit_norm = False
        self.projection = "none"
        # Live updates (ROADMAP A15) bump this; a built index stays at 0.
        self.epoch = 0
        self._margin = self.eps * _MARGIN_SLACK
        self._dev = None
        self._tables = None

    # -- construction -----------------------------------------------------

    @classmethod
    def build(
        cls, cores, labels, eps, *, leaves: Optional[int] = None,
        block: int = 256, qblock: int = 128, seed: int = 0, device=None,
    ):
        """Index ``(n_core, d)`` core points with their cluster labels and
        upload the slabs to ``device``.

        ``leaves``: KD leaf budget (default scales with the core count,
        at most 64); ``block``: the column block (clamped to the largest
        leaf); ``qblock``: query rows per tile; ``seed``: the KD
        partitioner's subsample seed.
        """
        validate_params(eps, 1)
        cores = np.asarray(cores)
        if cores.ndim != 2:
            raise ValueError(
                f"core points must be (N, k) 2-D, got shape {cores.shape}"
            )
        labels = np.asarray(labels, np.int32)
        if len(labels) != len(cores):
            raise ValueError(
                f"{len(cores)} core points but {len(labels)} labels"
            )
        n, d = cores.shape
        t0 = time.perf_counter()
        if n == 0:
            idx = cls(
                eps=eps,
                center=np.zeros(d),
                tree=[],
                coords=np.full((d, 0), PAD_COORD, np.float32),
                labels=np.empty(0, np.int32),
                blo=np.empty((0, d), np.float32),
                bhi=np.empty((0, d), np.float32),
                block=int(block), qblock=int(qblock), n_core=0,
                device=device,
            )
            idx.stats = {"n_core": 0, "n_leaves": 0, "build_s": 0.0,
                         "index_bytes": 0}
            idx.src_index = np.empty(0, np.int64)
            return idx
        # Centre on the float64 core mean, then cast: the centre also
        # recentres every query, so distances are preserved exactly.
        center = cores.mean(axis=0, dtype=np.float64)
        cores_c = np.empty((n, d), np.float32)
        for s, e in row_chunks(n, d):
            np.subtract(cores[s:e].astype(np.float64), center,
                        out=cores_c[s:e], casting="unsafe")
        if leaves is None:
            leaves = int(np.clip(n // max(4 * block, 1), 1, 64))
        tree, parts = _leaf_partition(cores_c, int(leaves), seed)
        L = len(parts)
        max_leaf = max(len(v) for v in parts.values())
        block = clamp_block(int(block), max_leaf, floor=8)
        C = round_up(max_leaf, block)
        nb = C // block
        coords = np.full((d, L * C), PAD_COORD, np.float32)
        slab_labels = np.full(L * C, _INT_INF32, np.int32)
        # Slab column -> input core row (-1 for pads).
        src_index = np.full(L * C, -1, np.int64)
        for leaf in range(L):
            idx_l = np.asarray(parts[leaf])
            idx_l = idx_l[spatial_order(cores_c[idx_l])]
            s = leaf * C
            for a, b in row_chunks(len(idx_l), d):
                coords[:, s + a:s + b] = cores_c[idx_l[a:b]].T
            slab_labels[s:s + len(idx_l)] = labels[idx_l]
            src_index[s:s + len(idx_l)] = idx_l
        # Per-column-block core bounds (empty blocks invert).
        valid = (slab_labels != _INT_INF32).reshape(L * nb, block)
        c3 = coords.reshape(d, L * nb, block)
        blo = np.where(valid[None], c3, BIG).min(axis=2).T
        bhi = np.where(valid[None], c3, -BIG).max(axis=2).T
        idx = cls(
            eps=eps, center=center, tree=tree, coords=coords,
            labels=slab_labels, blo=blo, bhi=bhi, block=block,
            qblock=int(qblock), n_core=n, device=device,
        )
        idx.src_index = src_index
        idx.stats = {
            "n_core": n,
            "n_leaves": L,
            "leaf_cap": C,
            "block": block,
            "pad_waste": round(L * C / n - 1.0, 6),
            "index_bytes": int(
                coords.nbytes + slab_labels.nbytes + blo.nbytes + bhi.nbytes
            ),
        }
        idx.device_tensors()
        idx.stats["build_s"] = round(time.perf_counter() - t0, 6)
        return idx

    # -- geometry ---------------------------------------------------------

    @property
    def d(self) -> int:
        return self.coords.shape[0]

    @property
    def leaf_cap(self) -> int:
        cap = int(self.stats.get("leaf_cap", 0) or 0)
        if cap > 0:
            return cap
        if self.coords.shape[1] == 0:
            return self.block
        return int(self.coords.shape[1])

    @property
    def n_leaves(self) -> int:
        return 0 if self.coords.shape[1] == 0 else (
            self.coords.shape[1] // self.leaf_cap
        )

    @property
    def nb(self) -> int:
        return self.leaf_cap // self.block

    # -- device residency -------------------------------------------------

    def device_tensors(self):
        """``(coords, labels, blo, bhi)`` on the index's device, uploaded
        on first use and kept for the index's life.  On the card the
        upload also builds B5's per-index tables (:meth:`kernel_tables`)
        on the current stream, so every later batch's B5 finds them."""
        if self._dev is None:
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (self.coords, self.labels, self.blo, self.bhi)
            )
            if self.device.type == "cuda" and self.coords.shape[1]:
                from ..ops.cuda_kernels import query_tables

                self._tables = query_tables(
                    self._dev[0], self._dev[1], block=self.block, nb=self.nb
                )
        return self._dev

    def kernel_tables(self):
        """B5's per-index tables (``ops/cuda_kernels.query_tables``):
        the pad rows' keys, the leaf ends and the ``"mixed"`` block
        frames.  Built with the upload on the card; on the CPU (whose B5
        is the plain version, which needs none) computed per call."""
        coords, labels, _blo, _bhi = self.device_tensors()
        if self._tables is not None:
            return self._tables
        from ..ops.cuda_kernels import query_tables

        return query_tables(coords, labels, block=self.block, nb=self.nb)

    @property
    def index_device_bytes(self) -> int:
        """Bytes the index holds on its device (0 before the upload),
        B5's tables included."""
        if self._dev is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self._dev + tuple(self._tables or ())))

    # -- query-side layout ------------------------------------------------

    def prepare_queries(self, X) -> np.ndarray:
        """Validated, centred float32 queries, projected first when the
        index serves a driver-metric frame (``"unit"``/``"latlon"``)."""
        if self.projection == "latlon":
            from ..geometry import latlon_to_unit_sphere

            X = latlon_to_unit_sphere(check_query_points(X, 2))
        X = check_query_points(X, self.d)
        X = X.astype(np.float64)
        if self.unit_norm:
            nrm = np.sqrt(np.einsum("ij,ij->i", X, X))
            if not nrm.all():
                raise ValueError(
                    "metric='cosine' is undefined for zero vectors: "
                    "query row(s) with zero norm"
                )
            X = X / nrm[:, None]
        return (X - self.center).astype(np.float32)

    def route(self, qf32: np.ndarray):
        """``[(leaf, query indices)]`` in ascending leaf order: each query
        appears under every leaf whose eps-expanded region holds it."""
        n = len(qf32)
        if n == 0 or self.n_leaves == 0:
            return []
        if not self.tree:
            return [(0, np.arange(n, dtype=np.int64))]
        members = expanded_members(self.tree, qf32, self._margin)
        return [
            (leaf, members[leaf][0]) for leaf in sorted(members)
            if len(members[leaf][0])
        ]

    def assemble(self, qf32: np.ndarray):
        """Pack routed queries into padded tiles.

        Returns ``(qbuf, tile_leaf, rowmap)``: ``qbuf`` a fresh ``(nqt,
        d, qb)`` float32 array (pad rows at PAD_COORD), ``tile_leaf`` the
        leaf of each tile and ``rowmap[t]`` the query indices tile ``t``
        answers for.  The tile count rounds up to a power of two, as the
        JAX package's does."""
        qb = self.qblock
        tiles = []
        for leaf, arr in self.route(qf32):
            for s in range(0, len(arr), qb):
                tiles.append((leaf, arr[s:s + qb]))
        nqt = 1 << (max(len(tiles), 1) - 1).bit_length()
        qbuf = np.full((nqt, self.d, qb), PAD_COORD, np.float32)
        tile_leaf = np.zeros(nqt, np.int32)
        rowmap = []
        for t, (leaf, arr) in enumerate(tiles):
            qbuf[t, :, :len(arr)] = qf32[arr].T
            tile_leaf[t] = leaf
            rowmap.append(arr)
        return qbuf, tile_leaf, rowmap

    def dispatch(self, qbuf, tile_leaf, precision="high"):
        """Launch B5 on one assembled batch (asynchronous on the card; the
        plain version on a CPU index); returns the packed (2, nqt, qb)
        int32 result on the index's device.  ``precision="mixed"`` runs
        B5 with its bf16 unit prefilter."""
        from ..ops.cuda_kernels import query_leaf

        coords, labels, _blo, _bhi = self.device_tensors()
        q, tl = torch.from_numpy(qbuf), torch.from_numpy(tile_leaf)
        if self.device.type == "cuda":
            # From pageable memory the copy would wait for the whole
            # stream (the previous batch's B5 included); from pinned
            # memory it queues behind it.
            q, tl = q.pin_memory(), tl.pin_memory()
        q = q.to(self.device, non_blocking=True)
        tl = tl.to(self.device, non_blocking=True)
        return query_leaf(q, tl, coords, labels, block=self.block,
                          nb=self.nb, precision=precision, eps2=self.eps2,
                          tables=self._tables)

    # -- oracle -----------------------------------------------------------

    def oracle_predict(self, X):
        """Brute-force numpy reference over the index's own core set:
        ``(labels, d2)``, the exactness target of ``predict``."""
        qf32 = self.prepare_queries(X)
        sel = self.labels != _INT_INF32
        return brute_force_query(
            qf32, self.coords[:, sel].T, self.labels[sel], self.eps
        )


def _model_core_set(model):
    """(core coordinates, core labels) of a fitted model: the stored core
    set of a loaded or carried-across model, else the core rows of its
    training data (a CUDA tensor fetches only those rows, once)."""
    mask = np.asarray(model.core_sample_mask_, bool)
    labels = np.asarray(model.labels_, np.int32)[mask]
    stored = getattr(model, "_serve_core_points", None)
    if stored is not None:
        cores = np.asarray(stored)
        if len(cores) != len(labels):
            raise ValueError(
                f"checkpoint core set has {len(cores)} points but the "
                f"core mask marks {len(labels)}"
            )
    elif model.data is not None:
        cores = _core_rows(model.data, mask)
    else:
        raise RuntimeError(
            "serving needs the core-point coordinates: fit()/train() in "
            "this process, or load a checkpoint that carries core points"
        )
    return cores, labels


def _core_rows(data, mask: np.ndarray) -> np.ndarray:
    """The rows of ``data`` (numpy or a tensor anywhere) under ``mask``,
    as numpy in the data's own dtype."""
    if isinstance(data, torch.Tensor):
        sel = torch.from_numpy(mask).to(data.device)
        return data[sel].cpu().numpy()
    return np.asarray(data)[mask]


def build_index(model, *, leaves=None, block: int = 256, qblock: int = 128,
                seed: int = 0):
    """Serving index of a fitted (or checkpoint-loaded) ``DBSCAN``, on the
    model's device.  It answers the L2 question at ``model.kernel_eps``
    over the model's core rows, as the JAX package's index does for
    every metric; a cosine or haversine model's rows are already in its
    kernel frame, and the index projects queries into it (``"unit"`` /
    ``"latlon"``)."""
    model._require_fitted()
    cores, labels = _model_core_set(model)
    idx = CorePointIndex.build(
        cores, labels, model.kernel_eps, leaves=leaves, block=block,
        qblock=qblock, seed=seed, device=model.device,
    )
    metric_norm = getattr(model, "_metric_norm", None)
    idx.unit_norm = metric_norm == "cosine"
    idx.projection = {
        "cosine": "unit", "haversine": "latlon"
    }.get(metric_norm, "none")
    return idx
