"""Live updates: incremental insert/delete on a fitted model
(counterpart of ``pypardis_tpu/serve/live.py``).

An update changes the clustering only within eps of the change (Ester
et al., VLDB 1998): counts move within eps of an inserted or deleted
point, labels within eps of a flipped core flag.  A KD tree over the
initial points bounds each update to a few leaves, and the serving
:class:`~pypardis_tpu_torch.serve.CorePointIndex` is edited in place
(pad slots absorb inserted cores; an overflowing leaf is re-laid out
alone), one device delta per update.

Per batch:

* **insert** — counts only rise, so flags only flip on and clusters
  only grow or merge.  Without a flip or a new core, each newcomer
  attaches to its nearest core within eps, or is noise.  Otherwise the
  leaves whose eps-expanded boxes hold a new or flipped point are
  re-clustered over their known cores
  (:func:`~..ops.incremental.core_components`: the fit's pipeline with
  ``min_samples=1``, B1 and B2 on the card) and the local components
  are stitched into the global labels by a union-find over (old label,
  component) edges (:func:`~..parallel.merge.resolve_label_edges`); a
  merge renames labels through a LUT.
* **delete** — counts only fall, so flags only flip off and clusters
  only shrink or split.  A split is cluster-local, not leaf-local: the
  surviving members of the clusters that owned a deleted point or a
  demoted core are re-clustered under fresh labels.

The verdicts run in float64 on raw coordinates, on the model's device
(:mod:`..ops.incremental`).  Border points attach to the nearest core
within eps (ties: the smallest label), the serving rule; a refit breaks
border ties by its own order, so a refit's equal is a partition (ARI
1.0) where no border point lies within eps of two clusters.

Where the points live: a float64 tensor on the model's device with 2n
capacity holds the coordinates the verdicts read, so a verdict ships
only the batch; its host mirror (the JAX package's ``_coords``) serves
routing, the re-cluster's slab, snapshots and checkpoints.  The
bookkeeping (alive, labels, core flags, leaf members) is host numpy, as
in the JAX package.  The model's ``labels_``, ``core_sample_mask_`` and
``data`` are synced lazily, on their first read after an update.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.incremental import (
    attach_to_cores,
    bucket_size,
    core_components,
    count_reaches,
    count_within_eps,
    label_lut,
)
from ..parallel.merge import resolve_label_edges
from ..partition import KDPartitioner, expanded_members, route_tree
from ..utils.validate import check_query_points

# Routing slack over eps, as the index's: extra slack only adds
# candidate leaves, never changes an answer.
_SLACK = 1.001


def check_live_metric(metric: str) -> None:
    """Raise ``NotImplementedError`` unless ``metric`` is Euclidean: the
    live verdicts (:func:`count_within_eps`, :func:`attach_to_cores`),
    the re-clusters (:func:`core_components`) and the compaction refit
    are all L2 in the raw coordinates.  Cosine and haversine read eps
    in the unit-sphere kernel frame, as in the JAX package; a cityblock
    model would be re-clustered in L2 at its L1 eps, so it is refused
    too, where the JAX package lets it go live on L2 verdicts."""
    if metric == "euclidean":
        return
    why = ("the incremental algebra reads model.eps in the unit-sphere "
           "kernel frame" if metric in ("cosine", "haversine") else
           "the live verdicts, re-clusters and compaction refit are "
           "Euclidean")
    raise NotImplementedError(
        f"live updates with metric={metric!r} are not supported: {why}; "
        f"fit/predict/sweep all support it"
    )


class LiveModel:
    """Incremental insert/delete on a fitted
    :class:`~pypardis_tpu_torch.dbscan.DBSCAN`, its serving index edited
    in place.

    Points carry stable integer ids (returned by :meth:`insert`, taken by
    :meth:`delete`); the fit's points are ``0..n-1``.  Labels are
    canonical ids, stable across updates and not re-densified, so
    ``predict`` and the model's labels agree.  ``stats`` holds the update
    telemetry under the JAX package's key names.  ``handle`` names the
    model in a multi-model plane: its index and engine are built under it.
    """

    def __init__(self, model, *, leaves: Optional[int] = None,
                 block: int = 256, qblock: int = 128, warm: bool = True,
                 handle: Optional[str] = None,
                 _resume: Optional[Dict] = None, **engine_kw):
        model._require_fitted()
        self.handle = None if handle is None else str(handle)
        check_live_metric(model._metric_norm)
        self.model = model
        self.eps = float(model.eps)
        self.min_samples = int(model.min_samples)
        self._fit_generation = model._fit_generation
        self.device = model.device
        if _resume is not None:
            data = np.asarray(_resume["points"], np.float64)
            labels = np.asarray(_resume["labels"], np.int32)
            core = np.asarray(_resume["core"], bool)
            self._next_label = int(_resume["next_label"])
        else:
            data = model.data
            if data is None:
                raise RuntimeError(
                    "live updates need the training coordinates; "
                    "model.data was cleared (or the model came from a "
                    "checkpoint without live state)"
                )
            labels = np.asarray(model.labels_, np.int32)
            core = np.asarray(model.core_sample_mask_, bool)
            self._next_label = (
                int(labels.max()) + 1 if (labels >= 0).any() else 0
            )
        n, k = data.shape
        self.k = int(k)
        # The model's data keeps its kind at the lazy sync: a tensor
        # stays a tensor on its device.
        self._data_dtype = data.dtype
        self._data_device = (data.device if isinstance(data, torch.Tensor)
                             else None)
        cap = max(2 * n, n + 64)
        self._coords = np.empty((cap, k), np.float64)
        self._coords_t = torch.empty((cap, k), dtype=torch.float64,
                                     device=self.device)
        if isinstance(data, torch.Tensor):
            self._coords_t[:n] = data.to(self.device, torch.float64)
            # The host mirror in row chunks: no second dataset-sized copy.
            for s in range(0, n, 1 << 16):
                e = min(s + (1 << 16), n)
                self._coords[s:e] = data[s:e].detach().cpu().numpy()
        else:
            self._coords[:n] = data
            self._coords_t[:n] = torch.from_numpy(self._coords[:n]).to(
                self.device)
        pts = self._coords[:n]
        self._alive = np.zeros(cap, bool)
        self._alive[:n] = True
        self._labels = np.full(cap, -1, np.int32)
        self._labels[:n] = labels
        self._core = np.zeros(cap, bool)
        self._core[:n] = core
        self._n = n

        # The routing tree over the initial points: fresh and
        # deterministic; its split planes cover all space, so points
        # outside the initial extent still route.
        if leaves is None:
            leaves = int(np.clip(n // 512, 4, 64))
        if _resume is not None:
            self._tree = [
                (int(p), int(a), float(b), int(l), int(r))
                for p, a, b, l, r in _resume["tree"]
            ]
        elif leaves > 1 and n >= 2:
            self._tree = KDPartitioner(
                pts, max_partitions=int(leaves), split_method="min_var",
                seed=0,
            ).tree
        else:
            self._tree = []
        self._leaf_of = np.zeros(cap, np.int32)
        self._leaf_of[:n] = (
            route_tree(self._tree, pts) if self._tree
            else np.zeros(n, np.int32)
        )
        # Leaf -> its point ids, ascending (dead ids are pruned lazily).
        order = np.argsort(self._leaf_of[:n], kind="stable")
        leaf_ids, starts = np.unique(self._leaf_of[:n][order],
                                     return_index=True)
        self._leaf_members: Dict[int, np.ndarray] = dict(zip(
            leaf_ids.tolist(), np.split(order.astype(np.int64), starts[1:])
        ))
        self.n_leaves = max(len(self._leaf_members), 1)

        # Serving: the model's engine over a gid-tagged index (a resume
        # restores the mutated slabs byte for byte).
        if _resume is not None:
            from .engine import QueryEngine

            self.index = _resume["index"]
            self.engine = QueryEngine(
                self.index, backend=model.kernel_backend, model=model,
                handle=self.handle, **engine_kw,
            )
            model._serve_engine = self.engine
        else:
            self.engine = model.query_engine(
                block=block, qblock=qblock, handle=self.handle, **engine_kw
            )
            self.index = self.engine.index
            self.index.attach_gids(np.flatnonzero(core))

        # Telemetry: one dict updated in place.
        self._ins_ms: deque = deque(maxlen=4096)
        self._del_ms: deque = deque(maxlen=4096)
        self.stats: Dict = {}
        self._counters = {
            "inserts": 0, "deletes": 0, "updates": 0,
            "recluster_events": 0, "recluster_points": 0,
            "recluster_dispatches": 0,
            "label_remaps": 0,
            "compactions": 0, "epoch_swaps": 0,
        }
        self._last_fraction = 0.0
        # Ingest state (:mod:`.ingest`): the sizes of the batches
        # applied, compaction seconds, whether a compaction is in flight
        # (saved, so a restore knows), and the replay flag that keeps a
        # compaction's replayed writes out of the user's write counters.
        self._batch_sizes: deque = deque(maxlen=64)
        self._compaction_s = 0.0
        self._compact_active = False
        self.compact_pending = False
        self._replay = False
        # Lazy model sync: an update marks the model's surfaces dirty;
        # the O(N) copies run once per read.
        self._dirty = False
        self._syncs = 0
        self._sync_bytes = 0
        self._warm_ms = 0.0
        if warm:
            self._warm_kernel()
        model._live_stats = self.stats
        model._live_model = self
        self._publish()

    def _warm_kernel(self) -> None:
        """Run the re-cluster once per bucket an insert will hit (a two
        point dummy padded up to it) before the first update, so the
        first update's latency holds no one-time cost (the kernels'
        library load, the allocator's first blocks)."""
        n_core = int(self._core[:self._n][self._alive[:self._n]].sum())
        if n_core < 2:
            return
        per_leaf = max(n_core // max(self.n_leaves, 1), 1)
        buckets = {
            bucket_size(min(2 * per_leaf + 8, n_core + 8)),
            bucket_size(n_core + 8),
        }
        dummy = np.zeros((2, self.k), np.float64)
        dummy[1, 0] = max(100.0 * self.eps, 100.0)
        t0 = time.perf_counter()
        for b in sorted(buckets):
            core_components(dummy, self.eps, min_bucket=b,
                            **self._kernel_kw())
        self._warm_ms = (time.perf_counter() - t0) * 1e3

    def _kernel_kw(self) -> Dict:
        m = self.model
        return dict(block=min(int(m.block), 256), precision=m.precision,
                    backend=m.kernel_backend, device=self.device)

    # -- the write surface ------------------------------------------------

    def insert(self, X) -> np.ndarray:
        """Insert points; returns their stable ids.  A multi-row ``X`` is
        one batch: one blast radius, one re-cluster, one index delta."""
        return self._do_insert(self._check_points(X))

    def insert_batch(self, X) -> np.ndarray:
        """The batched insert that :class:`~.ingest.IngestQueue`
        coalesces writes into: B rows cost one re-cluster dispatch and
        one index delta (``recluster_dispatches`` and ``index_epoch``
        move by one)."""
        return self._do_insert(self._check_points(X))

    def delete_batch(self, ids) -> int:
        """Batched delete by stable ids: one blast radius over the
        affected clusters, one re-cluster dispatch, one index delta."""
        return self.delete(ids)

    def _do_insert(self, X, ids=None) -> np.ndarray:
        """The insert algebra.  ``ids=None`` appends fresh ids; a
        compaction's replay passes the ids it re-applies (their rows and
        leaves are in place, marked dead by the generation install)."""
        t0 = time.perf_counter()
        m = len(X)
        if m == 0:
            return np.empty(0, np.int64)
        eps, ms = self.eps, self.min_samples
        Xt = torch.from_numpy(np.ascontiguousarray(X)).to(self.device)

        cand = self._pool(X)
        cand_t = self._rows(cand)
        # Existing points whose counts rise and which may flip: only a
        # point that is not core yet can, so only those are counted.
        maybe = cand[~self._core[cand]]
        gain = self._count(self._rows(maybe), Xt)
        maybe, gain = maybe[gain > 0], gain[gain > 0]
        if len(maybe):
            pool2 = self._pool(self._coords[maybe])
            flips = maybe[self._reaches(self._rows(maybe),
                                        self._rows(pool2), ms - gain)]
        else:
            flips = np.empty(0, np.int64)
        # The newcomers' core test: alive candidates plus the batch
        # itself (the self-count rides in the batch term).
        new_core = self._reaches(Xt, cand_t, ms - self._count(Xt, Xt))

        if ids is None:
            ids = self._append(X, Xt)
        else:
            ids = np.asarray(ids, np.int64)
            self._alive[ids] = True
            self._labels[ids] = -1
        self._core[ids] = new_core
        self._core[flips] = True

        if len(flips) == 0 and not new_core.any():
            # No structure moved: the newcomers are border or noise.
            # Every core within eps of one lies in its routed leaves.
            core_cand = cand[self._core[cand]]
            labs, _d2 = attach_to_cores(
                Xt, self._rows(core_cand), self._labels[core_cand], eps
            )
            self._labels[ids] = labs.cpu().numpy()
            self._last_fraction = 0.0
            self._finish_update("inserts", m, t0, self._ins_ms)
            return ids

        changed_pts = np.concatenate([X, self._coords[flips]])
        lut = self._recluster_insert(changed_pts)
        # One index delta: the merge LUT renames in place; the new cores
        # (inserted and flipped) fill pad slots.
        self.index.begin_update()
        if lut is not None:
            self.index.apply_label_map(lut)
            self._counters["label_remaps"] += 1
        add = np.concatenate([ids[new_core], flips]).astype(np.int64)
        if len(add):
            self.index.insert_cores(self._coords[add], self._labels[add], add)
        self.index.commit_update()
        self._finish_update("inserts", m, t0, self._ins_ms)
        return ids

    def delete(self, ids) -> int:
        """Delete points by id; returns the number removed.  Untouched
        clusters keep their labels; the clusters that owned a deleted
        point or a demoted core re-cluster under fresh labels."""
        t0 = time.perf_counter()
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        if len(ids) == 0:
            return 0
        bad = ids[(ids < 0) | (ids >= self._n) | ~self._alive[
            np.clip(ids, 0, max(self._n - 1, 0))
        ]]
        if len(bad):
            raise KeyError(
                f"unknown or already-deleted point id(s): "
                f"{bad[:8].tolist()}"
            )
        eps, ms = self.eps, self.min_samples
        D = self._coords[ids].copy()
        was_core = self._core[ids].copy()
        dead_labels = self._labels[ids].copy()
        self._alive[ids] = False
        self._core[ids] = False

        cand = self._pool(D)
        # Points whose counts fall and which may flip: only a core point
        # can lose its flag.
        maybe = cand[self._core[cand]]
        maybe = maybe[self._count(self._rows(maybe), self._rows(ids)) > 0]
        if len(maybe):
            flips = maybe[~self._reaches(
                self._rows(maybe),
                self._rows(self._pool(self._coords[maybe])), ms,
            )]
        else:
            flips = np.empty(0, np.int64)

        if not was_core.any() and len(flips) == 0:
            # Border or noise deletions detach nothing else.
            self._labels[ids] = -1
            self._last_fraction = 0.0
            self._finish_update("deletes", len(ids), t0, self._del_ms)
            return len(ids)

        flip_labels = self._labels[flips]
        self._core[flips] = False
        self._labels[ids] = -1
        affected = np.unique(np.concatenate([
            dead_labels[dead_labels >= 0], flip_labels[flip_labels >= 0],
        ]))
        s_core, s_labels = self._recluster_delete(affected, ids)

        self.index.begin_update()
        gone = np.concatenate([ids[was_core], flips]).astype(np.int64)
        if len(gone):
            self.index.remove_gids(gone)
        if len(s_core):
            self.index.set_label_gids(s_core, s_labels)
        self.index.commit_update()
        self._finish_update("deletes", len(ids), t0, self._del_ms)
        return len(ids)

    # -- the re-cluster ---------------------------------------------------

    def _components(self, s_core) -> np.ndarray:
        if len(s_core) >= 2:
            self._counters["recluster_dispatches"] += 1
        return core_components(self._coords[s_core], self.eps,
                               **self._kernel_kw())

    def _recluster_insert(self, changed_pts):
        """Re-cluster the leaves reached by new and flipped points and
        stitch the local components into the global labels through the
        union-find.  Returns the relabel LUT (None without labels)."""
        leaves = self._leaves_reaching(changed_pts)
        S = self._members(leaves)
        s_core = S[self._core[S]]
        comp = self._components(s_core)
        n_comp = int(comp.max()) + 1 if len(comp) else 0
        first = self._next_label
        fresh = first + comp.astype(np.int64)
        self._next_label += n_comp
        old = self._labels[s_core].astype(np.int64)
        sel = old >= 0
        # The distinct (old label, component) edges: the union-find's
        # answer does not depend on repeats.
        key = np.unique(old[sel] * max(n_comp, 1) + comp[sel])
        edges = np.stack([key // max(n_comp, 1),
                          first + key % max(n_comp, 1)], axis=1)
        labels = self._labels[:self._n]  # a dead point's label is -1
        # Every alive label lies below ``first``, so the largest id in
        # play is the last fresh one; ids outside the edges keep theirs.
        lut = None
        if len(fresh):
            mapping = resolve_label_edges(edges, np.concatenate([
                edges.reshape(-1), np.arange(first, first + n_comp)]))
            lut = label_lut(mapping, first + n_comp - 1)
            moved = np.flatnonzero(lut[:first] != np.arange(first))
            if len(moved):
                live = labels >= moved[0]
                labels[live] = lut[labels[live]]
            final = lut[fresh]
        else:
            top = int(labels.max()) if len(labels) else -1
            if top >= 0:
                lut = label_lut({}, top)
            final = fresh.astype(np.int32)
        self._labels[s_core] = final
        self._attach_noncore(S[~self._core[S]])
        self._note_recluster(leaves, len(S))
        return lut

    def _recluster_delete(self, affected, deleted_ids):
        """Re-cluster the surviving members of the affected clusters
        under fresh labels (no stitching: a core edge between two
        clusters would have merged them before the delete)."""
        alive = self._alive[:self._n]
        S = np.flatnonzero(
            np.isin(self._labels[:self._n], affected) & alive
        ).astype(np.int64)
        s_core = S[self._core[S]]
        comp = self._components(s_core)
        n_comp = int(comp.max()) + 1 if len(comp) else 0
        fresh = (self._next_label + comp.astype(np.int64)).astype(np.int32)
        self._next_label += n_comp
        self._labels[s_core] = fresh
        self._attach_noncore(S[~self._core[S]])
        leaves = set(np.unique(np.concatenate([
            self._leaf_of[S], self._leaf_of[deleted_ids]
        ])).tolist())
        self._note_recluster(leaves, len(S))
        return s_core, self._labels[s_core]

    def _attach_noncore(self, pts_ids) -> None:
        """Re-attach non-core points: the nearest core within eps (ties:
        the smallest label), else noise, over the cores of the leaves
        each point's eps-ball reaches."""
        if len(pts_ids) == 0:
            return
        pool = self._pool(self._coords[pts_ids])
        core_cand = pool[self._core[pool]]
        labs, _d2 = attach_to_cores(
            self._rows(pts_ids), self._rows(core_cand),
            self._labels[core_cand], self.eps,
        )
        self._labels[pts_ids] = labs.cpu().numpy()

    # -- locality and the point store ---------------------------------------

    def _rows(self, ids) -> torch.Tensor:
        """The float64 rows of ``ids`` on the model's device."""
        return self._coords_t[torch.from_numpy(
            np.asarray(ids, np.int64)).to(self.device)]

    def _count(self, queries, candidates) -> np.ndarray:
        return count_within_eps(queries, candidates, self.eps).cpu().numpy()

    def _reaches(self, queries, candidates, need) -> np.ndarray:
        """Rows with at least ``need`` candidates within eps."""
        return count_reaches(queries, candidates, self.eps,
                             need).cpu().numpy()

    def _pool(self, pts) -> np.ndarray:
        """Alive ids in every leaf whose eps-expanded box holds one of
        ``pts``: a set that provably holds every eps-neighbour."""
        return self._members(self._leaves_reaching(pts))

    def _leaves_reaching(self, pts):
        if not self._tree:
            return {0}
        members = expanded_members(
            self._tree, np.asarray(pts, np.float64), self.eps * _SLACK,
        )
        return {l for l, (idx, _own) in members.items() if len(idx)}

    def _members(self, leaves) -> np.ndarray:
        out = []
        for leaf in leaves:
            ids = self._leaf_members.get(int(leaf))
            if ids is None or not len(ids):
                continue
            arr = ids[self._alive[ids]]
            if len(arr) * 2 < len(ids):
                self._leaf_members[int(leaf)] = arr
            out.append(arr)
        if not out:
            return np.empty(0, np.int64)
        # The leaves hold disjoint ids: their sorted union is a sort.
        return np.sort(np.concatenate(out))

    def _append(self, X, Xt) -> np.ndarray:
        m = len(X)
        need = self._n + m
        if need > len(self._coords):
            cap = max(2 * len(self._coords), need)
            for name in ("_coords", "_alive", "_labels", "_core",
                         "_leaf_of"):
                old = getattr(self, name)
                fresh = np.zeros(
                    (cap,) + old.shape[1:], old.dtype
                ) if old.dtype != np.int32 else np.full(
                    (cap,) + old.shape[1:], -1, np.int32
                )
                fresh[:self._n] = old[:self._n]
                setattr(self, name, fresh)
            self._leaf_of[self._n:] = 0
            grown = torch.empty((cap, self.k), dtype=torch.float64,
                                device=self.device)
            grown[:self._n] = self._coords_t[:self._n]
            self._coords_t = grown
        ids = np.arange(self._n, need, dtype=np.int64)
        self._coords[ids] = X
        self._coords_t[self._n:need] = Xt
        self._alive[ids] = True
        self._labels[ids] = -1
        self._core[ids] = False
        leaf = (route_tree(self._tree, X) if self._tree
                else np.zeros(m, np.int32))
        self._leaf_of[ids] = leaf
        for l in np.unique(leaf).tolist():
            self._leaf_members[l] = np.concatenate([
                self._leaf_members.get(l, np.empty(0, np.int64)),
                ids[leaf == l],
            ])
        self._n = need
        return ids

    def _check_points(self, X) -> np.ndarray:
        if self.model._fit_generation != self._fit_generation:
            raise RuntimeError(
                "model was refit after this LiveModel was built; "
                "rebuild it (model.live())"
            )
        return np.asarray(check_query_points(X, self.k), np.float64)

    # -- the read surface ---------------------------------------------------

    def ids(self) -> np.ndarray:
        """Stable ids of the alive points, ascending."""
        return np.flatnonzero(self._alive[:self._n]).astype(np.int64)

    def points(self) -> np.ndarray:
        return self._coords[:self._n][self._alive[:self._n]].copy()

    def labels(self) -> np.ndarray:
        """Labels of the alive points (canonical ids, stable across
        updates)."""
        return self._labels[:self._n][self._alive[:self._n]].copy()

    def core_mask(self) -> np.ndarray:
        return self._core[:self._n][self._alive[:self._n]].copy()

    def predict(self, X, return_distance: bool = False):
        """Out-of-sample assignment against the current index, bitwise
        its oracle."""
        return self.engine.predict(X, return_distance)

    # -- bookkeeping ------------------------------------------------------

    def _note_recluster(self, leaves, n_points) -> None:
        self._counters["recluster_events"] += 1
        self._counters["recluster_points"] += int(n_points)
        self._last_fraction = round(
            len(set(leaves)) / max(self.n_leaves, 1), 6
        )

    def _finish_update(self, kind, m, t0, lat) -> None:
        # A compaction's replay re-applies writes the user already
        # counted: its kernel work stays in the re-cluster counters, the
        # write counters and latencies do not move.
        if not self._replay:
            lat.append((time.perf_counter() - t0) * 1e3)
            self._counters[kind] += int(m)
            self._counters["updates"] += 1
            self._batch_sizes.append(int(m))
        self._mark_dirty()
        self._publish()

    def _mark_dirty(self) -> None:
        """O(1) per update: the model's surfaces are copied on their next
        read (:meth:`_sync_if_dirty`)."""
        m = self.model
        self._dirty = True
        m._result_cache = None
        m._serve_core_points = None

    def _sync_if_dirty(self) -> None:
        if not self._dirty:
            return
        # Cleared first: the assignments below go through the model's
        # setters, and a read during the sync sees the state in flight.
        self._dirty = False
        m = self.model
        alive = self._alive[:self._n]
        m.labels_ = self._labels[:self._n][alive].copy()
        m.core_sample_mask_ = self._core[:self._n][alive].copy()
        if self._data_device is not None:
            sel = torch.from_numpy(alive).to(self.device)
            m.data = self._coords_t[:self._n][sel].to(
                self._data_device, self._data_dtype)
            data_bytes = m._data_v.numel() * m._data_v.element_size()
        else:
            m.data = self._coords[:self._n][alive].astype(self._data_dtype)
            data_bytes = m._data_v.nbytes
        m._keys = np.flatnonzero(alive).astype(np.int64)
        self._syncs += 1
        self._sync_bytes += int(
            m._labels_v.nbytes + m._core_mask_v.nbytes + data_bytes
            + m._keys.nbytes
        )

    def _publish(self) -> None:
        def _pct(d, q):
            return round(float(np.percentile(np.asarray(d), q)), 3) \
                if len(d) else 0.0

        c = self._counters
        alive = self._alive[:self._n]
        self.stats.update({
            "model": self.handle or "default",
            "points": int(np.count_nonzero(alive)),
            "cores": int(np.count_nonzero(self._core[:self._n] & alive)),
            "inserts": c["inserts"],
            "deletes": c["deletes"],
            "updates": c["updates"],
            "recluster_events": c["recluster_events"],
            "recluster_points": c["recluster_points"],
            "recluster_tile_fraction": float(self._last_fraction),
            "label_remaps": c["label_remaps"],
            "n_leaves": int(self.n_leaves),
            "index_epoch": int(self.index.epoch),
            "index_delta_bytes": int(self.index.delta_bytes),
            "insert_p50_ms": _pct(self._ins_ms, 50),
            "insert_p99_ms": _pct(self._ins_ms, 99),
            "delete_p50_ms": _pct(self._del_ms, 50),
            "delete_p99_ms": _pct(self._del_ms, 99),
            "warm_compile_ms": round(float(self._warm_ms), 3),
            "model_syncs": int(self._syncs),
            "model_sync_bytes": int(self._sync_bytes),
            "batch_sizes": [int(b) for b in self._batch_sizes],
            "reclusters_per_write": round(
                c["recluster_events"]
                / max(c["inserts"] + c["deletes"], 1), 6
            ),
            "recluster_dispatches": c["recluster_dispatches"],
            "compactions": c["compactions"],
            "compaction_s": round(float(self._compaction_s), 3),
            "epoch_swaps": c["epoch_swaps"],
            "index_generation": int(self.index.generation),
            "appended_slab_bytes": int(self.index.appended_slab_bytes),
        })

    # -- compaction (:class:`~.ingest.Compactor` drives these) ----------

    def begin_compaction_snapshot(self) -> Dict:
        """Freeze the compaction's input under the caller's lock: the
        alive ids and a copy of their coordinates.  Ids are append-only
        and never reused, so the writes that land during the refit are
        found at the swap by id arithmetic alone."""
        ids = np.flatnonzero(self._alive[:self._n]).astype(np.int64)
        self._compact_active = True
        return {
            "n": int(self._n),
            "ids": ids,
            "points": self._coords[ids].copy(),
        }

    def _install_generation(self, snap, labels, core, fresh):
        """Swap a compacted generation in, under the caller's lock: (1)
        drain the engine, so readers submitted before the swap resolve
        against the old generation; (2) adopt the refit's clustering of
        the snapshot (labels re-densify here); (3) swap the fresh index
        in place (:meth:`CorePointIndex.replace_generation`); (4) replay
        the writes that landed during the refit through the incremental
        algebra (kept out of the user's write counters).  Returns
        ``(replayed insert rows, replayed delete rows)``."""
        self.engine.drain()
        ids = snap["ids"]
        later = np.arange(snap["n"], self._n, dtype=np.int64)
        later = later[self._alive[later]]
        deleted = ids[~self._alive[ids]]
        labels = np.asarray(labels, np.int32)
        core = np.asarray(core, bool)
        self._labels[:self._n] = -1
        self._core[:self._n] = False
        self._alive[:self._n] = False
        self._alive[ids] = True
        self._labels[ids] = labels
        self._core[ids] = core
        self._next_label = (
            int(labels.max()) + 1 if (labels >= 0).any() else 0
        )
        self.index.replace_generation(fresh)
        self._counters["epoch_swaps"] += 1
        self._replay = True
        try:
            if len(deleted):
                self.delete(deleted)
            if len(later):
                self._do_insert(self._coords[later].copy(), ids=later)
        finally:
            self._replay = False
        self._mark_dirty()
        self._publish()
        return int(len(later)), int(len(deleted))

    def _note_compaction(self, seconds: float) -> None:
        self._counters["compactions"] += 1
        self._compaction_s += float(seconds)
        self._publish()

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the live state (points, labels, core flags, ids,
        the routing tree, counters and the mutated index slabs), in the
        JAX package's format.  A save during a compaction keeps the
        serving generation and flags ``compact_pending``."""
        from ..checkpoint import save_model

        self._sync_if_dirty()
        save_model(
            self.model, path,
            live={
                "points": self.points(),
                "labels": self.labels(),
                "core": self.core_mask(),
                "gids": self.ids(),
                "next_label": int(self._next_label),
                "tree": np.asarray(self._tree, np.float64).reshape(-1, 5),
                "counters": dict(self._counters),
                "compact_pending": bool(self._compact_active),
            },
            index=self.index,
        )

    @classmethod
    def load(cls, path: str, device=None, **engine_kw) -> "LiveModel":
        """Restore a live checkpoint of either package onto ``device``
        (default the card); point ids re-densify to ``0..n_alive-1`` in
        the saved id order.  ``compact_pending`` says a compaction was in
        flight at the save; the saved generation is the one served."""
        from ..checkpoint import load_model

        model = load_model(path, device=device)
        ck = getattr(model, "_live_ckpt", None)
        if ck is None:
            raise ValueError(
                f"{path} is a plain model checkpoint without live "
                f"state; build a fresh LiveModel(model) instead"
            )
        compact_pending = bool(ck.pop("compact_pending", False))
        index = ck.pop("index")
        old_gids = np.asarray(ck.pop("gids"), np.int64)
        if index.gids is not None:
            # Saved ids were sparse (deletions); positions restart dense.
            g = index.gids
            order = np.argsort(old_gids, kind="stable")
            pos = np.searchsorted(old_gids[order], g)
            hit = (g >= 0) & (pos < len(old_gids))
            hit[hit] = old_gids[order][pos[hit]] == g[hit]
            index.gids = np.full(len(g), -1, np.int64)
            index.gids[hit] = order[pos[hit]]
            index._gid_col = None
        live = cls(model, _resume={**ck, "index": index}, **engine_kw)
        for k, v in (ck.get("counters") or {}).items():
            if k in live._counters:
                live._counters[k] = int(v)
        live.compact_pending = compact_pending
        live._publish()
        return live
