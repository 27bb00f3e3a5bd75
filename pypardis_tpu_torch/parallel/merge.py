"""Label-equivalence merging on the host (counterpart of
``pypardis_tpu/parallel/merge.py``).

:func:`resolve_label_edges` unions (E, 2) label-equivalence edges into
{label id -> the least id of its component}, the rule of the
reference's ``ClusterAggregator`` (merged clusters take the minimum
id).  The live path stitches a local re-cluster's components into the
global labels with it.  ``merge_occurrences`` comes with the sharded
fit (ROADMAP A10/A11).
"""

from __future__ import annotations

from typing import Dict

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
