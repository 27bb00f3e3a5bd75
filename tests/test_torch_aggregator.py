"""The port's ``ClusterAggregator`` / ``UnionFind`` (its own copy of
``pypardis_tpu/aggregator.py``) and the partition helpers
(``dbscan_partition``, ``map_cluster_id``, ``DBSCAN.cluster_mapping``),
each held against the JAX package on the same inputs: equal states,
equal yields, equal mappings."""

import numpy as np
import pytest
import torch

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import aggregator as jagg
from pypardis_tpu import dbscan as jdbscan
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import (
    DBSCAN,
    ClusterAggregator,
    dbscan_partition,
    default_value,
    map_cluster_id,
)
from pypardis_tpu_torch.aggregator import UnionFind
from pypardis_tpu_torch.dbscan import _partition_cluster_dict


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _state(agg):
    return (dict(agg.fwd), {k: set(v) for k, v in agg.rev.items()},
            agg.next_global_id)


# tests/test_aggregator.py's cases, fed to both aggregators.
CASES = {
    "new_cluster": [(0, ["0:0"])],
    "noise_and_noncore": [(0, ["0:-1"]), (1, ["1:2*"])],
    "min_id_merge": [(0, ["0:0"]), (1, ["1:0"]), (2, ["0:0", "1:0"])],
    "transitive": [(0, ["a"]), (1, ["b"]), (2, ["c"]), (3, ["a", "b"]),
                   (4, ["b", "c"])],
    "border_never_merges": [(0, ["0:0"]), (1, ["0:1"]),
                            (2, ["0:0*", "0:1*"])],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_aggregator_cases_match_the_reference(case):
    ours, ref = ClusterAggregator(), jagg.ClusterAggregator()
    for item in CASES[case]:
        ours + item
        ref + item
    assert _state(ours) == _state(ref)
    assert len(ours) == len(ref)


def test_combining_aggregators_matches_the_reference():
    ours = [ClusterAggregator(), ClusterAggregator()]
    refs = [jagg.ClusterAggregator(), jagg.ClusterAggregator()]
    for k, items in enumerate(([(0, ["a"]), (1, ["b"])],
                               [(0, ["b", "c"]), (1, ["d"])])):
        for item in items:
            ours[k] + item
            refs[k] + item
    ours[0] + ours[1]
    refs[0] + refs[1]
    assert _state(ours[0]) == _state(refs[0])
    assert ours[0].fwd["b"] == ours[0].fwd["c"]


def test_default_value_and_union_find_match_the_reference():
    assert default_value() == jagg.default_value()
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 200, size=(150, 2))
    ours, ref = UnionFind(200), jagg.UnionFind(200)
    for a, b in edges:
        ours.union(int(a), int(b))
        ref.union(int(a), int(b))
    assert np.array_equal(ours.roots(), ref.roots())
    assert all(ours.find(i) == ref.find(i) for i in range(200))
    roots = ours.roots()
    # Min-id linking: every root is the least id of its component.
    assert all(roots[i] <= i for i in range(200))


def _records(X, parts):
    return [((int(k), int(p)), X[k]) for k, p in zip(range(len(X)), parts)]


@pytest.mark.parametrize("metric,eps", [("euclidean", 0.3),
                                        ("cityblock", 0.35)])
def test_dbscan_partition_yields_the_reference_wire_format(blobs750, metric,
                                                           eps):
    """The per-partition worker on one partition's records yields what
    the JAX worker yields, key for key."""
    recs = _records(blobs750, np.full(len(blobs750), 3))
    params = {"eps": eps, "min_samples": 10, "metric": metric,
              "backend": "auto"}
    ours = list(dbscan_partition(recs, dict(params, device="cpu")))
    ref = list(jdbscan.dbscan_partition(recs, dict(params, backend="xla")))
    assert ours == ref
    assert any(v.endswith("*") for _k, v in ours)
    assert all(v.startswith("3:") for _k, v in ours)
    assert list(dbscan_partition([], params)) == []


def test_partition_records_aggregate_and_map_like_the_reference(blobs750):
    """Two partitions' worker output through the aggregator and
    ``map_cluster_id``: the port's chain gives the reference chain's
    global ids."""
    half = len(blobs750) // 2
    chains = []
    for worker, agg_cls, mapper, kw in (
            (dbscan_partition, ClusterAggregator, map_cluster_id,
             {"device": "cpu"}),
            (jdbscan.dbscan_partition, jagg.ClusterAggregator,
             jdbscan.map_cluster_id, {"backend": "xla"})):
        params = dict({"eps": 0.3, "min_samples": 10}, **kw)
        out = []
        for p, (s, e) in enumerate(((0, half), (half, len(blobs750)))):
            recs = [((k, p), blobs750[k]) for k in range(s, e)]
            out += list(worker(recs, params))
        agg = agg_cls()
        for k, lab in out:
            agg + (k, [lab])
        chains.append([mapper((k, [lab]), dict(agg.fwd)) for k, lab in out])
    assert chains[0] == chains[1]
    assert any(g >= 0 for _k, g in chains[0])
    assert any(g == -1 for _k, g in chains[0])


def test_map_cluster_id_cases():
    mapping = {"0:1": 7, "1:0": 2}
    for x in ((5, ["0:1"]), (5, ["0:1*"]), (6, ["0:-1"]), (7, ["2:9"])):
        assert map_cluster_id(x, mapping) == jdbscan.map_cluster_id(
            x, mapping)
    assert map_cluster_id((5, ["0:1*"]), mapping) == (5, 7)
    assert map_cluster_id((6, ["0:-1"]), mapping) == (6, -1)


@pytest.mark.parametrize("metric,eps", [("euclidean", 0.3),
                                        ("cityblock", 0.35)])
def test_cluster_mapping_matches_the_reference(blobs750, metric, eps):
    """``cluster_mapping()`` after a fit: the same aggregator state and
    ``cluster_dict`` as the JAX model's, and the same state as feeding
    every point's label one by one."""
    ours = DBSCAN(eps=eps, min_samples=10, metric=metric, device="cpu")
    ours.fit(blobs750)
    ref = JaxDBSCAN(eps=eps, min_samples=10, metric=metric,
                    kernel_backend="xla", mesh=default_mesh(1)).fit(blobs750)
    a, b = ours.cluster_mapping(), ref.cluster_mapping()
    assert _state(a) == _state(b)
    assert ours.cluster_dict == ref.cluster_dict
    loop = ClusterAggregator()
    for i, lab in enumerate(ours.labels_):
        loop + (i, [f"0:{lab}"])
    assert dict(loop.fwd) == dict(a.fwd)
    assert len(a) == int(ours.labels_.max()) + 1


def test_partition_cluster_dict_matches_the_reference():
    rng = np.random.default_rng(4)
    parts = rng.integers(0, 5, 400).astype(np.int32)
    labels = rng.integers(-1, 9, 400).astype(np.int32)
    assert _partition_cluster_dict(parts, labels) == (
        jdbscan._partition_cluster_dict(parts, labels))


def test_cluster_mapping_before_a_fit_is_empty():
    agg = DBSCAN(eps=0.3, min_samples=10, device="cpu").cluster_mapping()
    assert len(agg) == 0 and agg.next_global_id == 0
