"""Checkpoints in the JAX package's ``.npz`` format, key for key
(counterpart of ``pypardis_tpu/checkpoint.py``).

A file written by either package loads in the other:

* ``save_model`` / ``load_model``: hyperparameters, labels, core mask,
  record keys, boxes, metrics and the core-point coordinates, so a
  loaded model serves ``predict`` without its training data; with
  ``live=``/``index=`` (:meth:`~.serve.live.LiveModel.save`) also the
  live state and the mutated index slabs (the ``live_*``/``index_*``
  payload), which ``load_model`` hands to
  :meth:`~.serve.live.LiveModel.load`;
* ``save_index`` / ``load_index``: a serving index's padded slabs,
  labels, per-block bounds, split tree and frame, byte for byte;
* ``save_partitioner`` / ``load_partitioner``: a KD split tree and its
  boxes.

The JAX package accepts only its own kernel backends (``auto``/``xla``/
``pallas``), so the port writes ``"auto"`` and reads any of them as
``"auto"``.  Every precision mode loads with its meaning (a
``"mixed"`` model serves through B5's bf16 prefilter), and every
metric (a cosine or haversine model's core points are in its kernel
frame, as the JAX package stores them).  An ``eps=None`` (density
hierarchy) model saves and loads as the JAX package's does: its
``eps`` is stored as null and its selected ``eps_`` is not stored, so a
loaded one keeps its labels and ``assignments()`` while ``predict``
raises, having no eps to serve at.
"""

from __future__ import annotations

import json

import numpy as np

from .geometry import BoundingBox
from .partition import KDPartitioner, route_tree
from .utils.validate import check_query_points


def _norm_npz(path: str) -> str:
    """``np.savez`` appends ``.npz`` when it is missing and ``np.load``
    does not; normalize both ways so ``save("m")``/``load("m")`` pair."""
    return path if str(path).endswith(".npz") else f"{path}.npz"


def save_partitioner(part: KDPartitioner, path: str) -> None:
    """Persist the split tree and boxes (not the points)."""
    labels = sorted(part.bounding_boxes)
    np.savez(
        _norm_npz(path),
        kind="kd_partition_tree",
        k=part.k,
        split_method=part.split_method,
        labels=np.asarray(labels),
        lower=np.stack([part.bounding_boxes[l].lower for l in labels]),
        upper=np.stack([part.bounding_boxes[l].upper for l in labels]),
        tree=np.asarray(part.tree, dtype=np.float64).reshape(-1, 5),
    )


class PartitionTree:
    """A loaded partition tree: routing and boxes without the data."""

    def __init__(self, k, split_method, labels, lower, upper, tree):
        self.k = int(k)
        self.split_method = str(split_method)
        self.bounding_boxes = {
            int(l): BoundingBox(lower=lo, upper=up)
            for l, lo, up in zip(labels, lower, upper)
        }
        self.tree = [
            (int(p), int(a), float(b), int(lf), int(rt))
            for p, a, b, lf, rt in tree
        ]

    @property
    def n_partitions(self) -> int:
        return len(self.bounding_boxes)

    def route(self, points: np.ndarray) -> np.ndarray:
        """Replay the split tree (validated against ``k``)."""
        check_query_points(points, self.k)
        return route_tree(self.tree, points)


def load_partitioner(path: str) -> PartitionTree:
    with np.load(_norm_npz(path), allow_pickle=False) as z:
        if str(z["kind"]) != "kd_partition_tree":
            raise ValueError(f"{path} is not a partition-tree checkpoint")
        return PartitionTree(
            z["k"], z["split_method"], z["labels"], z["lower"], z["upper"],
            z["tree"],
        )


def save_model(model, path: str, *, live=None, index=None) -> None:
    """Persist a fitted ``DBSCAN``: results, hyperparameters and the
    core-point coordinates (in the data's own dtype).

    ``live``/``index`` (both, from :meth:`~.serve.live.LiveModel.save`)
    also persist the live state: the current points with their labels,
    core flags and stable ids, the routing tree and counters, and the
    index's slabs byte for byte (epoch, leaf -> slab map and slot ids
    included), so a restarted server serves the updated model as it was
    and keeps taking writes."""
    from .serve.index import _core_rows

    if model.labels_ is None:
        raise ValueError("model is untrained; nothing to checkpoint")
    boxes = model.bounding_boxes or {}
    labels = sorted(boxes)
    params = {
        "eps": model.eps,
        "min_samples": model.min_samples,
        "metric": model.metric
        if isinstance(model.metric, str)
        else getattr(model.metric, "__name__", "euclidean"),
        # The JAX constructor's sharding knobs, at its defaults: the
        # port's fit is single-device (ROADMAP A11).
        "max_partitions": None,
        "split_method": "min_var",
        "block": model.block,
        "precision": model.precision,
        # The JAX package validates this against its own backends.
        "kernel_backend": "auto",
    }
    keys = np.asarray(model._keys)
    if keys.dtype == object:
        # Object keys would need pickle, which loading refuses.
        keys = keys.astype(str)
    cores = getattr(model, "_serve_core_points", None)
    if cores is None and model.data is not None:
        cores = _core_rows(
            model.data, np.asarray(model.core_sample_mask_, bool)
        )
    extra = {}
    if live is not None:
        extra.update(
            live_points=np.asarray(live["points"], np.float64),
            live_labels=np.asarray(live["labels"], np.int32),
            live_core=np.asarray(live["core"], bool),
            live_gids=np.asarray(live["gids"], np.int64),
            live_tree=np.asarray(live["tree"], np.float64).reshape(-1, 5),
            live_meta=json.dumps({
                "next_label": int(live["next_label"]),
                "counters": {
                    k: int(v) for k, v in live["counters"].items()
                },
                # A compaction was in flight at the save: the saved index
                # is the serving generation; the partial one is dropped.
                "compact_pending": bool(live.get("compact_pending", False)),
            }),
        )
    if index is not None:
        # The leaf -> slab map as (leaf, slab) rows.
        pairs = [
            (int(l), int(s))
            for l, slabs in sorted(index.leaf_slabs.items()) for s in slabs
        ]
        extra.update(
            index_coords=index.coords,
            index_labels=index.labels,
            index_blo=index.blo,
            index_bhi=index.bhi,
            index_center=index.center,
            index_tree=np.asarray(index.tree, np.float64).reshape(-1, 5),
            index_gids=(
                index.gids if index.gids is not None
                else np.empty(0, np.int64)
            ),
            index_leaf_slabs=np.asarray(pairs, np.int64).reshape(-1, 2),
            index_meta=json.dumps({
                "eps": index.eps,
                "block": index.block,
                "qblock": index.qblock,
                "n_core": index.n_core,
                "leaf_cap": int(index.stats.get("leaf_cap", 0)),
                "n_leaves": int(index.stats.get("n_leaves", 0)),
                "epoch": int(index.epoch),
            }),
        )
    np.savez(
        _norm_npz(path),
        kind="dbscan_model",
        params=json.dumps(params),
        labels_=model.labels_,
        core_sample_mask_=model.core_sample_mask_,
        core_points=(
            cores if cores is not None else np.zeros((0, 0), np.float32)
        ),
        keys=keys,
        box_labels=np.asarray(labels, dtype=np.int64),
        box_lower=np.stack([boxes[l].lower for l in labels])
        if labels else np.zeros((0, 0)),
        box_upper=np.stack([boxes[l].upper for l in labels])
        if labels else np.zeros((0, 0)),
        metrics=json.dumps(model.metrics_),
        **extra,
    )


def load_model(path: str, device=None):
    """Rebuild a fitted ``DBSCAN`` from either package's checkpoint;
    ``assignments()`` and ``predict`` work without retraining.
    ``device``: where the model serves and refits (default the card).
    A live checkpoint's payload goes to ``model._live_ckpt`` (its index
    on ``device``), for :meth:`~.serve.live.LiveModel.load`."""
    from .dbscan import DBSCAN

    with np.load(_norm_npz(path), allow_pickle=False) as z:
        if str(z["kind"]) != "dbscan_model":
            raise ValueError(f"{path} is not a DBSCAN model checkpoint")
        params = json.loads(str(z["params"]))
        model = DBSCAN(
            eps=params["eps"],
            min_samples=params["min_samples"],
            metric=params["metric"],
            block=params["block"],
            precision=params["precision"],
            # The stored backend names a JAX route ("auto"/"xla"/
            # "pallas"); the port picks its own.
            kernel_backend="auto",
            device=device,
        )
        model.labels_ = z["labels_"]
        model.core_sample_mask_ = z["core_sample_mask_"]
        model._keys = z["keys"]
        model.bounding_boxes = {
            int(l): BoundingBox(lower=lo, upper=up)
            for l, lo, up in zip(
                z["box_labels"], z["box_lower"], z["box_upper"]
            )
        }
        model.expanded_boxes = {
            l: b.expand(2 * model.eps)
            for l, b in model.bounding_boxes.items()
        }
        model.metrics_ = json.loads(str(z["metrics"]))
        if "core_points" in z.files and z["core_points"].size:
            model._serve_core_points = z["core_points"]
        if "live_points" in z.files:
            model._live_ckpt = _live_payload(z, device)
    return model


def _live_payload(z, device):
    """The ``live_*``/``index_*`` payload of an open checkpoint: the live
    state and the mutated index (slabs byte for byte, on ``device``)."""
    from .serve import CorePointIndex

    imeta = json.loads(str(z["index_meta"]))
    lmeta = json.loads(str(z["live_meta"]))
    leaf_slabs: dict = {}
    for leaf, slab in z["index_leaf_slabs"]:
        leaf_slabs.setdefault(int(leaf), []).append(int(slab))
    idx = CorePointIndex(
        eps=imeta["eps"],
        center=z["index_center"],
        tree=z["index_tree"],
        coords=z["index_coords"],
        labels=z["index_labels"],
        blo=z["index_blo"],
        bhi=z["index_bhi"],
        block=imeta["block"],
        qblock=imeta["qblock"],
        n_core=imeta["n_core"],
        leaf_slabs=leaf_slabs,
        gids=z["index_gids"] if z["index_gids"].size else None,
        stats={
            "n_core": imeta["n_core"],
            "n_leaves": imeta["n_leaves"],
            "leaf_cap": imeta["leaf_cap"],
            "index_bytes": int(
                z["index_coords"].nbytes + z["index_labels"].nbytes
                + z["index_blo"].nbytes + z["index_bhi"].nbytes
            ),
        },
        device=device,
    )
    idx.epoch = int(imeta["epoch"])
    return {
        "points": z["live_points"],
        "labels": z["live_labels"],
        "core": z["live_core"],
        "gids": z["live_gids"],
        "tree": z["live_tree"],
        "next_label": lmeta["next_label"],
        "counters": lmeta["counters"],
        "compact_pending": lmeta.get("compact_pending", False),
        "index": idx,
    }


def save_index(index, path: str) -> None:
    """Persist a serving index: padded slabs, labels, per-block bounds,
    split tree and frame — a restarted process serves it without the
    model, the dataset or a rebuild."""
    np.savez(
        _norm_npz(path),
        kind="serve_index",
        params=json.dumps({
            "eps": index.eps,
            "block": index.block,
            "qblock": index.qblock,
            "n_core": index.n_core,
            "leaf_cap": int(index.stats.get("leaf_cap", 0)),
            "n_leaves": int(index.stats.get("n_leaves", 0)),
            "unit_norm": bool(index.unit_norm),
            "projection": str(index.projection),
        }),
        center=index.center,
        tree=np.asarray(index.tree, np.float64).reshape(-1, 5),
        coords=index.coords,
        labels=index.labels,
        blo=index.blo,
        bhi=index.bhi,
    )


def load_index(path: str, handle=None, device=None):
    """Restore a serving index saved by either package (slabs load byte
    for byte, so it serves identical answers) onto ``device`` (default
    the card).  ``handle`` names the model the restored index serves in
    a multi-model plane (the gateway readmits an evicted model so)."""
    from .serve import CorePointIndex

    with np.load(_norm_npz(path), allow_pickle=False) as z:
        if str(z["kind"]) != "serve_index":
            raise ValueError(f"{path} is not a serving-index checkpoint")
        params = json.loads(str(z["params"]))
        idx = CorePointIndex(
            eps=params["eps"],
            center=z["center"],
            tree=z["tree"],
            coords=z["coords"],
            labels=z["labels"],
            blo=z["blo"],
            bhi=z["bhi"],
            block=params["block"],
            qblock=params["qblock"],
            n_core=params["n_core"],
            stats={
                "n_core": params["n_core"],
                "n_leaves": params["n_leaves"],
                "leaf_cap": params["leaf_cap"],
                "index_bytes": int(
                    z["coords"].nbytes + z["labels"].nbytes
                    + z["blo"].nbytes + z["bhi"].nbytes
                ),
            },
            device=device,
            handle=handle,
        )
        idx.unit_norm = bool(params.get("unit_norm", False))
        idx.projection = str(
            params.get("projection", "unit" if idx.unit_norm else "none")
        )
    return idx
