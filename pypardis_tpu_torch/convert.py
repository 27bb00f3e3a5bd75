"""Carry fitted state across from the JAX package in memory (files go
through :mod:`.checkpoint`).

* :func:`dbscan_from_reference` builds a fitted port ``DBSCAN`` from a
  JAX model's parameters (the ``params`` dict its checkpoints store:
  ``eps``, ``min_samples``, ``metric``, ``block``, ``precision``, ...)
  and its numpy fit state, without refitting.  The result surface
  (``assignments()``, ``result``, ``cluster_dict``, the boxes) then
  answers as the JAX model does, and ``predict`` serves from the
  carried core points.
* :func:`index_from_reference` turns a JAX ``CorePointIndex``'s numpy
  arrays into a port index that answers identically.
"""

from __future__ import annotations

import numpy as np

from .config import DBSCANConfig


def dbscan_from_reference(params: dict, X, labels, core, *, keys=None,
                          device=None):
    """A fitted port ``DBSCAN`` holding the JAX model's fit.

    ``params``: the JAX model's parameters (unknown keys are ignored;
    its ``kernel_backend`` names a JAX backend and is dropped; its
    ``sketch`` spec carries over, so a refit sketches as it did; its
    ``metric`` too).  ``X``: the JAX model's ``data``, the (N, d)
    training points (for cosine and haversine the projected rows, the
    kernel frame it holds them in); ``labels`` / ``core``: its ``labels_``
    and ``core_sample_mask_``; ``keys``: its record keys (default
    ``arange(N)``); ``device``: where a refit of the returned model
    would run (default the card).
    """
    X = np.asarray(X)
    labels = np.asarray(labels, dtype=np.int32)
    core = np.asarray(core, dtype=bool)
    if labels.shape != (len(X),) or core.shape != (len(X),):
        raise ValueError(
            f"labels {labels.shape} / core {core.shape} do not match "
            f"{len(X)} points"
        )
    cfg = DBSCANConfig.from_dict(
        {k: v for k, v in params.items() if k != "kernel_backend"}
    )
    cfg.device = device
    model = cfg.build()
    model.data = X
    model._keys = np.arange(len(X)) if keys is None else np.asarray(keys)
    # The JAX fit sets its boxes in the kernel frame (eps remapped).
    with model._kernel_frame():
        if len(X):
            model._set_fit(labels, core, X.min(axis=0), X.max(axis=0))
        else:
            model._set_fit(labels, core, np.zeros(0), np.zeros(0))
    # The core rows serve predict() even once ``data`` is dropped.
    model._serve_core_points = X[core]
    return model


def index_from_reference(ref, *, device=None):
    """A port ``CorePointIndex`` holding a JAX index's arrays (``coords``,
    ``labels``, ``blo``, ``bhi``, ``center``, ``tree``, ``block``,
    ``qblock``, ``n_core``, ``stats`` and its query frame), on
    ``device`` (default the card)."""
    from .serve import CorePointIndex

    idx = CorePointIndex(
        eps=ref.eps, center=ref.center, tree=ref.tree,
        coords=ref.coords, labels=ref.labels, blo=ref.blo, bhi=ref.bhi,
        block=ref.block, qblock=ref.qblock, n_core=ref.n_core,
        stats={k: ref.stats[k] for k in
               ("n_core", "n_leaves", "leaf_cap", "block", "pad_waste",
                "index_bytes") if k in ref.stats},
        device=device,
    )
    idx.unit_norm = bool(ref.unit_norm)
    idx.projection = str(ref.projection)
    return idx
