"""Label-equivalence merging on the host (counterpart of
``pypardis_tpu/parallel/merge.py``).

:func:`resolve_label_edges` unions (E, 2) label-equivalence edges into
{label id -> the least id of its component}, the rule of the
reference's ``ClusterAggregator`` (merged clusters take the minimum
id).  The live path stitches a local re-cluster's components into the
global labels with it.  :func:`merge_occurrences` is the KD route's
host merge (``sharded_dbscan(..., merge="host")``): it unions the halo
occurrence tables of the per-partition fits into final labels.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.labels import uf_resolve_dense


def resolve_label_edges(edges, ids) -> Dict[int, int]:
    """Union a (E, 2) table of label-equivalence edges over the id
    universe ``ids`` (1-D); returns {label id -> canonical (minimum)
    label id of its component}.  An edge naming an id outside the
    universe raises ``KeyError``.

    Ids map to dense indices by a sorted search; the union-find's
    minimum dense root is then the component's minimum original id.
    """
    ids_sorted = np.unique(np.asarray(ids))
    edges = np.asarray(edges).reshape(-1, 2)
    dense = np.searchsorted(ids_sorted, edges)
    if len(edges):
        if len(ids_sorted) == 0:
            raise KeyError(
                f"edge references id(s) not in the empty id universe: "
                f"{edges[0]}"
            )
        clipped = np.clip(dense, 0, len(ids_sorted) - 1)
        if not np.array_equal(ids_sorted[clipped], edges):
            missing = edges[(ids_sorted[clipped] != edges).any(axis=1)][0]
            raise KeyError(
                f"edge references id(s) not in the id universe: {missing}"
            )
    roots = uf_resolve_dense(dense.astype(np.int64), len(ids_sorted)).numpy()
    return {
        int(v): int(ids_sorted[roots[i]]) for i, v in enumerate(ids_sorted)
    }


def relabel_i32(labels, lut, fill: int = -1) -> np.ndarray:
    """``out[i] = lut[labels[i]]`` for labels inside the table, else
    ``fill`` (the JAX package's ``_native.relabel_i32``), as one numpy
    gather."""
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    lut = np.ascontiguousarray(lut, dtype=np.int32)
    ok = (labels >= 0) & (labels < lut.size)
    out = np.full_like(labels, fill)
    out[ok] = lut[labels[ok]]
    return out


def merge_occurrences(
    home_label, core, occ_gid, occ_label,
) -> Tuple[np.ndarray, Dict[int, int]]:
    """Merge per-partition labels over halo-duplicate occurrence tables.

    ``home_label``: (N,) each point's label from its home partition
    (root gid, -1 noise); ``core``: (N,) home-run core flags;
    ``occ_gid``/``occ_label``: the flattened halo occurrences, a point's
    gid and the label it took in a foreign partition.  The reference's
    rule (its ``aggregator.py:38-40``): an occurrence links its label to
    the point's home label only when the point is core at home and
    labelled in the foreign run; merged clusters take the least id.
    Returns ``(final_labels, mapping)``.
    """
    home_label = np.asarray(home_label)
    core = np.asarray(core, dtype=bool)
    occ_gid = np.asarray(occ_gid).reshape(-1)
    occ_label = np.asarray(occ_label).reshape(-1)

    link = (occ_gid >= 0) & (occ_gid < len(home_label)) & (occ_label >= 0)
    link &= core[np.clip(occ_gid, 0, len(home_label) - 1)]
    a = home_label[occ_gid[link]]
    b = occ_label[link]
    keep = a >= 0
    edges = np.stack([a[keep], b[keep]], axis=1)

    ids = np.unique(
        np.concatenate([home_label[home_label >= 0], edges.reshape(-1)])
    )
    mapping = resolve_label_edges(edges, ids)
    lut = np.full(int(ids.max()) + 2 if len(ids) else 1, -1, np.int32)
    for k, v in mapping.items():
        lut[k] = v
    return relabel_i32(home_label, lut, fill=-1), mapping
