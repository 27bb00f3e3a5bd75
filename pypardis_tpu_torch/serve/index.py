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

Live updates (:class:`~pypardis_tpu_torch.serve.live.LiveModel`) edit
the index in place between :meth:`CorePointIndex.begin_update` and
:meth:`CorePointIndex.commit_update`: pad slots absorb inserted cores,
deletes turn slots back into pads, a leaf out of pad slots is re-laid
out across its slabs and appended ones, and a relabel is a LUT.  The
host mirrors change first; the commit ships one delta to the device
tensors (scattered columns, appended slabs, the LUT gathered on the
card, touched block bounds) and rebuilds B5's tables over the new slab
on the same stream, so a B5 launched after the commit reads them and
one launched before it reads the old slab.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.query import BIG, INT_INF, PAD_COORD, brute_force_query, eps2_f32
from ..partition import (
    KDPartitioner,
    expanded_members,
    route_tree,
    spatial_order,
)
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
        leaf_slabs: Optional[Dict] = None, gids=None, device=None,
        handle: Optional[str] = None,
    ):
        from ..dbscan import resolve_device

        # The model handle: names the fitted model this index serves in
        # a multi-model plane (:class:`~.gateway.ModelGateway`).  The port
        # has no staging cache, so it routes nothing.
        self.handle = None if handle is None else str(handle)
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
        self._margin = self.eps * _MARGIN_SLACK
        self._dev = None
        self._tables = None
        # Set by release(): the device tensors are gone for good.
        self._released = False
        # The event behind the upload, where another stream must wait
        # for it (a generation built on a compaction thread's stream).
        self._ready = None
        # Live-update state: the epoch (one per committed delta or
        # generation swap), delta bytes shipped, generation swaps, deltas
        # since the last swap, and the slab width this generation was
        # built with (appended slabs past it are the compaction's debt).
        self.epoch = 0
        self.delta_bytes = 0
        self.generation = 0
        self.deltas_since_compact = 0
        self._base_cols = int(self.coords.shape[1])
        # Tree leaf -> its slabs: a leaf grown past its pad slots owns
        # slabs appended past the build layout, and its queries scan
        # each.  Slot -> stable point id (-1 for pads) once attached.
        if leaf_slabs is not None:
            self.leaf_slabs = {
                int(l): [int(s) for s in slabs]
                for l, slabs in leaf_slabs.items()
            }
        else:
            n_slabs = (
                0 if self.coords.shape[1] == 0
                else self.coords.shape[1] // max(self.leaf_cap, 1)
            )
            self.leaf_slabs = {s: [s] for s in range(n_slabs)} or {0: []}
        self.gids = None if gids is None else np.asarray(gids, np.int64)
        self._gid_col: Optional[Dict[int, int]] = None
        self._pending = None

    # -- construction -----------------------------------------------------

    @classmethod
    def build(
        cls, cores, labels, eps, *, leaves: Optional[int] = None,
        block: int = 256, qblock: int = 128, seed: int = 0, center=None,
        device=None, handle: Optional[str] = None,
    ):
        """Index ``(n_core, d)`` core points with their cluster labels and
        upload the slabs to ``device``.

        ``leaves``: KD leaf budget (default scales with the core count,
        at most 64); ``block``: the column block (clamped to the largest
        leaf); ``qblock``: query rows per tile; ``seed``: the KD
        partitioner's subsample seed; ``center``: the recentring frame
        (default the cores' float64 mean).  A compaction builds in the
        old generation's frame, so queries centred before the swap stay
        valid after it.  ``handle`` names the model the index serves.
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
                center=np.zeros(d) if center is None else center,
                tree=[],
                coords=np.full((d, 0), PAD_COORD, np.float32),
                labels=np.empty(0, np.int32),
                blo=np.empty((0, d), np.float32),
                bhi=np.empty((0, d), np.float32),
                block=int(block), qblock=int(qblock), n_core=0,
                device=device, handle=handle,
            )
            idx.stats = {"n_core": 0, "n_leaves": 0, "build_s": 0.0,
                         "index_bytes": 0}
            idx.src_index = np.empty(0, np.int64)
            return idx
        # Centre on the float64 core mean, then cast: the centre also
        # recentres every query, so distances are preserved exactly.
        if center is None:
            center = cores.mean(axis=0, dtype=np.float64)
        else:
            center = np.asarray(center, np.float64)
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
            qblock=int(qblock), n_core=n, device=device, handle=handle,
        )
        idx.src_index = src_index
        idx.leaf_slabs = {leaf: [leaf] for leaf in range(L)}
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

    @property
    def appended_slab_bytes(self) -> int:
        """Bytes of the slabs appended past this generation's build
        layout (coords, label and gid per slot, the block bounds): the
        write debt the compaction watermark (``PPTORCH_COMPACT_SLAB_
        BYTES``) reads.  Zero after a build or a generation swap."""
        extra = int(self.coords.shape[1]) - self._base_cols
        if extra <= 0:
            return 0
        nb = extra // max(self.block, 1)
        return int(extra * (4 * self.d + 4 + 8) + nb * (8 * self.d))

    # -- device residency -------------------------------------------------

    def device_tensors(self):
        """``(coords, labels, blo, bhi)`` on the index's device, uploaded
        on first use and kept for the index's life.  On the card the
        upload also builds B5's per-index tables (:meth:`kernel_tables`)
        on the current stream, so every later batch's B5 finds them.  A
        released index (:meth:`release`) raises."""
        if self._released:
            raise RuntimeError(
                "this index was released (its device tensors were freed, "
                "e.g. by a gateway eviction); load_index() its spill to "
                "serve it again"
            )
        if self._dev is None:
            # A copy on the CPU too: the live path edits the host mirrors
            # first and ships the delta at its commit.
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device, copy=True)
                for a in (self.coords, self.labels, self.blo, self.bhi)
            )
            if self.device.type == "cuda":
                self._rebuild_tables()
        return self._dev

    def _rebuild_tables(self) -> None:
        """B5's tables over the device slab, on the current stream, and
        the event behind them (see :meth:`replace_generation`)."""
        coords, labels = self._dev[0], self._dev[1]
        self._tables = None
        if coords.shape[1]:
            from ..ops.cuda_kernels import query_tables

            self._tables = query_tables(coords, labels, block=self.block,
                                        nb=self.nb)
        self._ready = torch.cuda.Event()
        self._ready.record()

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

    def release(self) -> int:
        """Drop the index's device tensors (the slabs and B5's tables) so
        the card's allocator gets them back; the host mirrors stay whole.
        Any later dispatch raises.  Returns the device bytes dropped
        (:attr:`index_device_bytes`).  The caller drains every engine
        over this index first: a batch in flight keeps its tensors
        alive until it is folded."""
        if self._pending is not None:
            raise RuntimeError(
                "cannot release an index with a delta update open; "
                "commit_update() first"
            )
        freed = self.index_device_bytes
        self._dev = None
        self._tables = None
        self._ready = None
        self._released = True
        return freed

    @property
    def index_device_bytes(self) -> int:
        """Bytes the index holds on its device (0 before the upload),
        B5's tables included."""
        if self._dev is None:
            return 0
        return int(sum(t.numel() * t.element_size()
                       for t in self._dev + tuple(self._tables or ())))

    # -- live updates -----------------------------------------------------

    def attach_gids(self, core_gids) -> None:
        """Attach stable point ids to the slots: ``core_gids`` in the order
        the cores were passed to :meth:`build` (``src_index`` maps them
        onto columns).  Needed before :meth:`remove_gids` and
        :meth:`set_label_gids`."""
        src = getattr(self, "src_index", None)
        gids = np.full(len(self.labels), -1, np.int64)
        if src is not None and len(src):
            sel = src >= 0
            gids[sel] = np.asarray(core_gids, np.int64)[src[sel]]
        self.gids = gids
        self._gid_col = None

    def _gid_map(self) -> Dict[int, int]:
        if self.gids is None:
            raise RuntimeError(
                "index has no point ids; call attach_gids() first"
            )
        if self._gid_col is None:
            cols = np.flatnonzero(self.gids >= 0)
            self._gid_col = dict(zip(self.gids[cols].tolist(), cols.tolist()))
        return self._gid_col

    def begin_update(self) -> None:
        """Open a mutation batch: every insert, removal and relabel until
        :meth:`commit_update` edits the host mirrors only."""
        if self._pending is not None:
            raise RuntimeError("an index update is already open")
        self._pending = {
            "cols": set(), "old_w": self.coords.shape[1], "lut": None,
        }

    def insert_cores(self, cores, labels, gids) -> None:
        """Add core points (raw-frame coordinates) with their labels and
        stable ids.  Each routes through the tree queries replay into
        its leaf's pad slots; a leaf out of pad slots is re-laid out
        (:meth:`_rebuild_leaf`)."""
        cores = np.asarray(cores)
        labels = np.asarray(labels, np.int32)
        gids = np.asarray(gids, np.int64)
        n = len(cores)
        if n == 0:
            return
        cc = np.ascontiguousarray(
            (cores.astype(np.float64) - self.center).astype(np.float32)
        )
        leaves = (route_tree(self.tree, cc) if self.tree
                  else np.zeros(n, np.int32))
        for leaf in np.unique(leaves):
            sel = np.flatnonzero(leaves == leaf)
            self._insert_into_leaf(int(leaf), cc[sel], labels[sel], gids[sel])
        self.n_core += n

    def _insert_into_leaf(self, leaf, pts, labels, gids) -> None:
        C = self.leaf_cap
        slabs = self.leaf_slabs.setdefault(leaf, [])
        free = [
            np.flatnonzero(self.labels[s * C:(s + 1) * C] == _INT_INF32)
            + s * C for s in slabs
        ]
        free = np.concatenate(free) if free else np.empty(0, np.int64)
        if len(free) >= len(pts):
            self._set_cols(free[:len(pts)].astype(np.int64), pts, labels,
                           gids)
        else:
            self._rebuild_leaf(leaf, pts, labels, gids)

    def _set_cols(self, cols, pts, labels, gids) -> None:
        self.coords[:, cols] = pts.T
        self.labels[cols] = labels
        if self.gids is not None:
            self.gids[cols] = gids
            self._gid_col = None
        self._pending["cols"].update(cols.tolist())

    def _rebuild_leaf(self, leaf, new_pts, new_labels, new_gids) -> None:
        """Re-lay-out one overflowing leaf: its members and the
        newcomers, Morton-sorted across its slabs and as many appended
        slabs as it needs.  No other leaf's columns move."""
        C = self.leaf_cap
        slabs = self.leaf_slabs.setdefault(leaf, [])
        old_cols = np.concatenate(
            [np.arange(s * C, (s + 1) * C) for s in slabs]
        ) if slabs else np.empty(0, np.int64)
        live = old_cols[self.labels[old_cols] != _INT_INF32] \
            if len(old_cols) else old_cols
        pts = np.concatenate(
            [self.coords[:, live].T, np.asarray(new_pts, np.float32)]
        ) if len(live) else np.asarray(new_pts, np.float32)
        labs = np.concatenate([self.labels[live], new_labels])
        gds = np.concatenate([
            self.gids[live] if self.gids is not None
            else np.full(len(live), -1, np.int64),
            new_gids,
        ])
        m = len(pts)
        while len(slabs) * C < m:
            slabs.append(self._append_slab())
        cols_all = np.concatenate(
            [np.arange(s * C, (s + 1) * C) for s in slabs]
        )
        self.coords[:, cols_all] = PAD_COORD
        self.labels[cols_all] = _INT_INF32
        if self.gids is not None:
            self.gids[cols_all] = -1
        order = spatial_order(pts)
        dest = cols_all[:m]
        self.coords[:, dest] = pts[order].T
        self.labels[dest] = labs[order]
        if self.gids is not None:
            self.gids[dest] = gds[order]
            self._gid_col = None
        self.leaf_slabs[leaf] = slabs
        self._pending["cols"].update(cols_all.tolist())

    def _append_slab(self) -> int:
        C = self.leaf_cap
        self.stats.setdefault("leaf_cap", C)
        d = self.coords.shape[0]
        nb = C // self.block
        s = self.coords.shape[1] // C
        self.coords = np.concatenate(
            [self.coords, np.full((d, C), PAD_COORD, np.float32)], axis=1
        )
        self.labels = np.concatenate(
            [self.labels, np.full(C, _INT_INF32, np.int32)]
        )
        if self.gids is not None:
            self.gids = np.concatenate([self.gids, np.full(C, -1, np.int64)])
        self.blo = np.concatenate(
            [self.blo, np.full((nb, d), BIG, np.float32)]
        )
        self.bhi = np.concatenate(
            [self.bhi, np.full((nb, d), -BIG, np.float32)]
        )
        return s

    def remove_gids(self, gids) -> None:
        """Turn the given points' slots back into pad slots (far-away
        coordinates, INT32_MAX labels); a leaf is never re-laid out by a
        delete, later inserts absorb the freed slots."""
        gmap = self._gid_map()
        gids = np.asarray(gids).reshape(-1)
        cols = np.asarray([gmap[int(g)] for g in gids], np.int64)
        if len(cols) == 0:
            return
        self.coords[:, cols] = PAD_COORD
        self.labels[cols] = _INT_INF32
        self.gids[cols] = -1
        for g in gids:
            gmap.pop(int(g), None)
        self.n_core -= len(cols)
        self._pending["cols"].update(cols.tolist())

    def set_label_gids(self, gids, labels) -> None:
        """Rewrite the labels of existing slots (a delete's re-clustered
        fresh ids)."""
        gmap = self._gid_map()
        gids = np.asarray(gids).reshape(-1)
        if len(gids) == 0:
            return
        cols = np.asarray([gmap[int(g)] for g in gids], np.int64)
        self.labels[cols] = np.asarray(labels, np.int32)
        self._pending["cols"].update(cols.tolist())

    def apply_label_map(self, lut) -> None:
        """Apply a union-find relabel LUT (identity outside the merged
        ids, :func:`~..ops.incremental.label_lut`) to every live slot.
        The commit ships only the LUT and gathers on the device."""
        lut = np.asarray(lut, np.int32)
        moved = np.flatnonzero(lut != np.arange(len(lut), dtype=np.int32))
        if len(moved):
            # Labels below the first moved id are fixed points.
            sel = (self.labels >= moved[0]) & (self.labels != _INT_INF32)
            self.labels[sel] = lut[np.clip(self.labels[sel], 0, len(lut) - 1)]
        p = self._pending
        p["lut"] = lut if p["lut"] is None else lut[
            np.clip(p["lut"], 0, len(lut) - 1)
        ]

    def _recompute_bounds(self, blocks) -> None:
        b = self.block
        blocks = np.asarray(sorted(blocks), np.int64)
        if len(blocks) == 0:
            return
        idx = (blocks[:, None] * b + np.arange(b)[None, :]).reshape(-1)
        cc = self.coords[:, idx].reshape(self.d, len(blocks), b)
        valid = (self.labels[idx] != _INT_INF32).reshape(len(blocks), b)
        self.blo[blocks] = np.where(valid[None], cc, BIG).min(axis=2).T
        self.bhi[blocks] = np.where(valid[None], cc, -BIG).max(axis=2).T

    def commit_update(self) -> int:
        """Close the mutation batch: recompute the touched block bounds,
        ship one device delta (the scattered columns by ``index_copy_``,
        appended slabs by ``torch.cat``, the relabel LUT as a gather on
        the device, the touched bound rows in place; never the whole
        index), rebuild B5's tables over the new slab on the same stream,
        and bump the epoch.  Returns the delta bytes shipped."""
        p = self._pending
        if p is None:
            raise RuntimeError("no index update open; call begin_update()")
        self._pending = None
        cols = np.asarray(sorted(p["cols"]), np.int64)
        old_w = int(p["old_w"])
        lut = p["lut"]
        touched_blocks = set((cols // self.block).tolist())
        self._recompute_bounds(touched_blocks)
        delta = 0
        if self._dev is not None:
            coords_d, labels_d, blo_d, bhi_d = self._dev
            dev = coords_d.device

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            old_rows = old_w // self.block
            if self.coords.shape[1] > old_w:
                app = (self.coords[:, old_w:], self.labels[old_w:],
                       self.blo[old_rows:], self.bhi[old_rows:])
                coords_d = torch.cat([coords_d, put(app[0])], dim=1)
                labels_d = torch.cat([labels_d, put(app[1])])
                blo_d = torch.cat([blo_d, put(app[2])])
                bhi_d = torch.cat([bhi_d, put(app[3])])
                delta += sum(a.nbytes for a in app)
            scat = cols[cols < old_w]
            if len(scat):
                ji = put(scat)
                coords_d.index_copy_(1, ji, put(self.coords[:, scat]))
                labels_d.index_copy_(0, ji, put(self.labels[scat]))
                delta += self.coords[:, scat].nbytes + self.labels[scat].nbytes
            if lut is not None:
                lut_d = put(lut)
                labels_d.copy_(torch.where(
                    labels_d == INT_INF, labels_d,
                    lut_d[labels_d.clamp(0, len(lut) - 1).long()],
                ))
                delta += lut.nbytes
            brows = np.asarray(
                sorted(b for b in touched_blocks if b < old_rows), np.int64
            )
            if len(brows):
                jb = put(brows)
                blo_d[jb] = put(self.blo[brows])
                bhi_d[jb] = put(self.bhi[brows])
                delta += 2 * self.blo[brows].nbytes
            self._dev = (coords_d, labels_d, blo_d, bhi_d)
            if dev.type == "cuda":
                self._rebuild_tables()
        self.epoch += 1
        self.delta_bytes += int(delta)
        self.deltas_since_compact += 1
        self.stats["n_leaves"] = self.n_leaves
        self.stats["index_bytes"] = int(
            self.coords.nbytes + self.labels.nbytes + self.blo.nbytes
            + self.bhi.nbytes
        )
        return int(delta)

    def replace_generation(self, fresh: "CorePointIndex") -> None:
        """Adopt a freshly built index (slabs, tree, bounds, ids and its
        device tensors) in place, keeping this object and its epoch
        clock: every engine holding this index serves the new generation
        from its next dispatch.  ``fresh`` must share this index's frame
        (``build(center=self.center)``) so queries centred before the
        swap stay valid; the caller drains in-flight tickets first.  The
        current stream waits for ``fresh``'s upload, which may have run
        on another thread's stream."""
        if self._pending is not None:
            raise RuntimeError(
                "cannot swap index generations with a delta update open; "
                "commit_update() first"
            )
        for attr in ("center", "tree", "coords", "labels", "blo", "bhi",
                     "block", "qblock", "n_core", "leaf_slabs", "gids",
                     "unit_norm", "projection", "_dev", "_tables"):
            setattr(self, attr, getattr(fresh, attr))
        self.src_index = getattr(fresh, "src_index", None)
        self.stats = dict(fresh.stats)
        self._gid_col = None
        if fresh._ready is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(fresh._ready)
            for t in (self._dev or ()) + tuple(self._tables or ()):
                t.record_stream(stream)
        self._base_cols = int(self.coords.shape[1])
        self.deltas_since_compact = 0
        self.generation += 1
        self.epoch += 1

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
        """``[(slab, query indices)]`` in ascending slab order: each query
        appears in every slab of every leaf whose eps-expanded region
        holds it (a leaf grown past its pad slots by live inserts owns
        several slabs, and its queries scan each)."""
        n = len(qf32)
        if n == 0:
            return []
        if not self.tree:
            idx = np.arange(n, dtype=np.int64)
            return [(s, idx) for s in sorted(self.leaf_slabs.get(0, []))]
        members = expanded_members(self.tree, qf32, self._margin)
        out = [
            (slab, members[leaf][0]) for leaf in sorted(members)
            if len(members[leaf][0])
            for slab in self.leaf_slabs.get(leaf, [leaf])
        ]
        out.sort(key=lambda t: t[0])
        return out

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
                seed: int = 0, handle: Optional[str] = None):
    """Serving index of a fitted (or checkpoint-loaded) ``DBSCAN``, on the
    model's device.  It answers the L2 question at ``model.kernel_eps``
    over the model's core rows, as the JAX package's index does for
    every metric; a cosine or haversine model's rows are already in its
    kernel frame, and the index projects queries into it (``"unit"`` /
    ``"latlon"``).  ``handle`` names the model in a multi-model plane."""
    model._require_fitted()
    cores, labels = _model_core_set(model)
    idx = CorePointIndex.build(
        cores, labels, model.kernel_eps, leaves=leaves, block=block,
        qblock=qblock, seed=seed, device=model.device, handle=handle,
    )
    metric_norm = getattr(model, "_metric_norm", None)
    idx.unit_norm = metric_norm == "cosine"
    idx.projection = {
        "cosine": "unit", "haversine": "latlon"
    }.get(metric_norm, "none")
    return idx
