"""The port's serving path on the CPU against the JAX package: the numpy
oracle, the KD partitioner and Morton sort, the core-point index, the
plain version of the query kernel B5, the engine and its queue.

The same inputs, made with numpy from a seed, go through both packages.
Everything the serving contract promises is exact, so every comparison
is bitwise (labels and d^2 bits), with no tolerance.
"""

import numpy as np
import pytest
import torch

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import partition as jpart
from pypardis_tpu.ops import query as jquery
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.serve import CorePointIndex as JaxIndex
from pypardis_tpu.serve import QueryEngine as JaxEngine
from pypardis_tpu_torch import DBSCAN, KDPartitioner, partition
from pypardis_tpu_torch.convert import dbscan_from_reference, index_from_reference
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops import query
from pypardis_tpu_torch.serve import (
    CorePointIndex,
    DeadlineExceeded,
    QueryEngine,
    QueueFull,
)
from pypardis_tpu_torch.utils.validate import check_query_points


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


INT_INF = np.iinfo(np.int32).max


def _params(ref):
    return {
        "eps": ref.eps, "min_samples": ref.min_samples,
        "metric": ref.metric, "block": ref.block,
        "precision": ref.precision, "kernel_backend": ref.kernel_backend,
    }


@pytest.fixture(scope="module")
def fitted():
    """A JAX single-device fit of 3-D blobs and the port model carrying
    the same fit (so both index the same cores and labels)."""
    from sklearn.datasets import make_blobs

    centers = np.random.default_rng(0).uniform(-1, 1, size=(3, 3)) * 2
    X, _ = make_blobs(n_samples=1200, centers=centers, cluster_std=0.4,
                      random_state=0)
    ref = JaxDBSCAN(eps=0.35, min_samples=8, kernel_backend="xla",
                    mesh=default_mesh(1)).fit(X)
    port = dbscan_from_reference(
        _params(ref), X, ref.labels_, ref.core_sample_mask_, device="cpu"
    )
    assert ref.core_sample_mask_.sum() > 200
    return ref, port, X


@pytest.fixture(scope="module")
def queries(fitted):
    _ref, _port, X = fitted
    rng = np.random.default_rng(3)
    return np.concatenate([
        X[:100],
        X[rng.integers(0, len(X), 150)]
        + rng.normal(scale=0.3, size=(150, X.shape[1])),
        rng.uniform(-3, 3, size=(100, X.shape[1])),
        np.full((4, X.shape[1]), 50.0),  # far from everything: noise
    ])


def _boundary_queries(index, n_per_split=6, seed=7):
    """Queries within eps of every split plane of the index's tree
    (raw frame: prepare_queries recentres)."""
    rng = np.random.default_rng(seed)
    qs = []
    for _p, axis, boundary, _l, _r in index.tree:
        for _ in range(n_per_split):
            q = rng.uniform(-1.5, 1.5, size=index.d)
            q[axis] = boundary + rng.uniform(-0.9, 0.9) * index.eps
            qs.append(q)
    return np.asarray(qs) + index.center


# -- the numpy oracle -----------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 16])
def test_oracle_matches_jax(d):
    rng = np.random.default_rng(d)
    cores = rng.normal(size=(300, d)).astype(np.float32)
    # Exact ties: duplicated cores under different labels.
    cores[150:160] = cores[:10]
    labels = rng.integers(0, 5, 300).astype(np.int32)
    q = np.concatenate([
        cores[:20], rng.normal(size=(80, d)).astype(np.float32)
    ])
    assert np.array_equal(
        query.axis_sq_dists(q, cores).view(np.int32),
        jquery.axis_sq_dists(q, cores).view(np.int32),
    )
    eps = 0.5 * np.sqrt(d)
    got = query.brute_force_query(q, cores, labels, eps)
    want = jquery.brute_force_query(q, cores, labels, eps)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
    assert (got[0][:10] == np.minimum(labels[:10], labels[150:160])).all()
    assert query.eps2_f32(0.3) == float(jquery.eps2_f32(0.3))


# -- Morton sort, KD partitioner, routing ---------------------------------


@pytest.mark.parametrize("d,dtype", [(2, np.float64), (5, np.float32),
                                     (40, np.float32)])
def test_morton_codes_and_spatial_order_match_jax(d, dtype):
    X = np.random.default_rng(d).normal(size=(700, d)).astype(dtype)
    X[:5, 0] = X[5, 0]  # repeated coordinates
    got, want = partition.morton_codes(X), jpart.morton_codes(X)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(partition.spatial_order(X),
                          jpart.spatial_order(X))


def _kd_data():
    rng = np.random.default_rng(11)
    X = np.concatenate([
        rng.normal(size=(900, 3)),
        rng.normal(loc=4.0, scale=0.5, size=(300, 3)),
        np.zeros((60, 3)),  # a stack of identical points
    ]).astype(np.float32)
    return X


@pytest.mark.parametrize("split_method", ["min_var", "rotation",
                                          "mean_var", "median_search"])
@pytest.mark.parametrize("builder", ["legacy", "level"])
@pytest.mark.parametrize("sample_size", [None, 200])
def test_kd_partitioner_matches_jax(split_method, builder, sample_size):
    X = _kd_data()
    got = KDPartitioner(X, max_partitions=16, split_method=split_method,
                        sample_size=sample_size, seed=3)
    want = jpart.KDPartitioner(X, max_partitions=16,
                               split_method=split_method,
                               sample_size=sample_size, seed=3,
                               builder=builder)
    assert got.tree == want.tree
    assert sorted(got.partitions) == sorted(want.partitions)
    for label, idx in want.partitions.items():
        assert got.partitions[label].dtype == idx.dtype
        assert np.array_equal(got.partitions[label], idx)
    for label, box in want.bounding_boxes.items():
        assert np.array_equal(got.bounding_boxes[label].lower, box.lower)
        assert np.array_equal(got.bounding_boxes[label].upper, box.upper)
    assert np.array_equal(got.result, want.result)
    assert np.array_equal(got.partition_sizes(), want.partition_sizes())
    Q = np.random.default_rng(1).normal(scale=2.0, size=(200, 3))
    assert np.array_equal(got.route(Q), want.route(Q))


def test_kd_degenerate_boundary_falls_back_to_median():
    """An axis whose moment boundaries leave one side empty splits at
    the exact median; an all-equal node stays a leaf."""
    X = np.zeros((64, 2))
    X[:40, 0] = 1.0
    X[40:, 0] = np.arange(24) * 1e-3 + 5.0
    got = KDPartitioner(X, max_partitions=8, seed=0)
    want = jpart.KDPartitioner(X, max_partitions=8, seed=0)
    assert got.tree == want.tree
    assert np.array_equal(got.result, want.result)
    same = KDPartitioner(np.ones((10, 2)), max_partitions=4)
    assert same.tree == [] and same.n_partitions == 1


def test_route_tree_and_expanded_members_match_jax():
    X = _kd_data()
    tree = jpart.KDPartitioner(X, max_partitions=8, seed=0).tree
    Q = np.random.default_rng(2).normal(scale=2.0, size=(500, 3))
    assert np.array_equal(partition.route_tree(tree, Q),
                          jpart.route_tree(tree, Q))
    got = partition.expanded_members(tree, Q.astype(np.float32), 0.3)
    want = jpart.expanded_members(tree, Q.astype(np.float32), 0.3)
    assert sorted(got) == sorted(want)
    for leaf in want:
        assert np.array_equal(got[leaf][0], want[leaf][0])
        assert np.array_equal(got[leaf][1], want[leaf][1])
    with pytest.raises(ValueError, match="split tree"):
        partition.route_tree(tree, Q[:, :1])


# -- the index ------------------------------------------------------------


@pytest.mark.parametrize("leaves", [1, 4, 8])
def test_index_build_and_assemble_match_jax(fitted, queries, leaves):
    ref, port, _X = fitted
    mask = ref.core_sample_mask_
    cores, labels = np.asarray(ref.data)[mask], ref.labels_[mask]
    want = JaxIndex.build(cores, labels, ref.eps, leaves=leaves, block=32,
                          qblock=32)
    got = CorePointIndex.build(cores, labels, port.eps, leaves=leaves,
                               block=32, qblock=32, device="cpu")
    for name in ("coords", "labels", "blo", "bhi", "center", "src_index"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.tree == want.tree
    for key in ("n_core", "n_leaves", "leaf_cap", "block", "pad_waste",
                "index_bytes"):
        assert got.stats[key] == want.stats[key], key
    assert (got.n_leaves, got.nb, got.d) == (want.n_leaves, want.nb, want.d)
    assert got.index_device_bytes == got.stats["index_bytes"]
    Q = np.concatenate([queries, _boundary_queries(got)]) \
        if got.tree else queries
    qf = got.prepare_queries(Q)
    assert np.array_equal(qf, want.prepare_queries(Q))
    qbuf, tile_leaf, rowmap = got.assemble(qf)
    jq, _jmask, jtl, jrow = want.assemble(qf)
    assert np.array_equal(qbuf, np.array(jq))
    assert np.array_equal(tile_leaf, jtl)
    assert len(rowmap) == len(jrow)
    for a, b in zip(rowmap, jrow):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("leaves", [1, 4])
def test_plain_query_kernel_matches_pallas_and_xla(fitted, queries, leaves):
    """B5's plain version == the JAX Pallas kernel (interpret mode),
    bitwise on the whole packed result, pad rows included; == the JAX
    XLA twin on every real row within eps (the twin skips blocks whose
    box lies beyond eps, so elsewhere it keeps the identity)."""
    ref, port, _X = fitted
    want_idx = ref.query_engine(leaves=leaves, block=32, qblock=32).index
    idx = port.query_engine(leaves=leaves, block=32, qblock=32).index
    qf = idx.prepare_queries(queries)
    qbuf, tile_leaf, _rowmap = idx.assemble(qf)
    jq, jmask, jtl, _ = want_idx.assemble(qf)
    pallas = np.asarray(want_idx.dispatch(
        np.array(jq), jmask, jtl, backend="pallas", interpret=True
    ))
    xla = np.asarray(want_idx.dispatch(np.array(jq), jmask, jtl,
                                       backend="xla"))
    coords, labels, _blo, _bhi = idx.device_tensors()
    before = dict(ck.LAUNCHES)
    got = ck.query_leaf(torch.from_numpy(qbuf), torch.from_numpy(tile_leaf),
                        coords, labels, block=idx.block, nb=idx.nb)
    assert ck.LAUNCHES == before  # the CPU runs the plain version
    assert got.dtype == torch.int32 and got.shape == (2,) + qbuf.shape[::2]
    assert np.array_equal(got.numpy(), pallas)
    e2 = np.float32(idx.eps2)
    plain_lab, plain_d2 = query.unpack_query_result(got)
    xla_lab, xla_d2 = query.unpack_query_result(xla)
    within = jmask & (plain_d2 <= e2)
    assert np.array_equal(within, jmask & (xla_d2 <= e2))
    assert within.sum() > 100
    assert np.array_equal(plain_lab[within], xla_lab[within])
    assert np.array_equal(plain_d2[within].view(np.int32),
                          xla_d2[within].view(np.int32))
    assert np.array_equal(
        got.numpy(), idx.dispatch(qbuf, tile_leaf).numpy()
    )


# -- the engine -----------------------------------------------------------


def _assert_exact(engine, Q):
    t = engine.submit(Q)
    engine.drain()
    olabs, od2 = engine.index.oracle_predict(Q)
    assert np.array_equal(t.labels, olabs)
    assert np.array_equal(t.d2.view(np.int32), od2.view(np.int32))
    return t


@pytest.mark.parametrize("leaves", [1, 4, 8])
def test_predict_matches_jax_engine_and_oracle(fitted, queries, leaves):
    ref, port, _X = fitted
    engine = port.query_engine(leaves=leaves, block=32, qblock=32)
    Q = np.concatenate([queries, _boundary_queries(engine.index)]) \
        if engine.index.tree else queries
    if engine.index.tree:
        routed = engine.index.route(engine.index.prepare_queries(Q))
        assert sum(len(a) for _l, a in routed) > len(Q)  # straddlers
    t = _assert_exact(engine, Q)
    jeng = ref.query_engine(leaves=leaves, block=32, qblock=32)
    jt = jeng.submit(Q)
    jeng.drain()
    assert np.array_equal(t.labels, jt.labels)
    assert np.array_equal(t.d2.view(np.int32), jt.d2.view(np.int32))
    far = slice(len(queries) - 4, len(queries))
    assert (t.labels[far] == -1).all() and np.isinf(t.d2[far]).all()
    labs, dist = engine.predict(Q, return_distance=True)
    assert np.array_equal(labs, t.labels)
    assert np.array_equal(dist, np.sqrt(t.d2))
    assert np.array_equal(port.predict(Q[:50]), ref.predict(Q[:50]))


def test_core_training_points_keep_their_label(fitted):
    _ref, port, X = fitted
    core = port.core_sample_mask_
    assert np.array_equal(port.predict(X[core]), port.labels_[core])


def test_port_fit_serves_like_the_jax_fit(blobs750):
    """A model the port fitted itself (host and tensor input) serves
    what the JAX model serves."""
    port = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(blobs750)
    ref = JaxDBSCAN(eps=0.3, min_samples=10, kernel_backend="xla",
                    mesh=default_mesh(1)).fit(blobs750)
    Q = blobs750[::3] + np.random.default_rng(0).normal(
        scale=0.1, size=blobs750[::3].shape
    )
    want = ref.query_engine(leaves=4, block=32, qblock=32).predict(Q)
    assert np.array_equal(
        port.query_engine(leaves=4, block=32, qblock=32).predict(Q), want
    )
    tensor = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(
        torch.from_numpy(blobs750)
    )
    assert np.array_equal(
        tensor.query_engine(leaves=4, block=32, qblock=32).predict(Q), want
    )


def test_all_noise_model_serves_noise():
    X = np.random.default_rng(5).uniform(-1, 1, size=(64, 3))
    port = DBSCAN(eps=1e-6, min_samples=5, device="cpu").fit(X)
    ref = JaxDBSCAN(eps=1e-6, min_samples=5, kernel_backend="xla",
                    mesh=default_mesh(1)).fit(X)
    assert not port.core_sample_mask_.any()
    labs, dist = port.query_engine().predict(X, return_distance=True)
    assert (labs == -1).all() and np.isinf(dist).all()
    assert np.array_equal(labs, ref.predict(X))
    assert port.query_engine().serving_stats()["n_leaves"] == 0


def test_index_from_reference_answers_identically(fitted, queries):
    ref, _port, _X = fitted
    jeng = ref.query_engine(leaves=4, block=32, qblock=32)
    idx = index_from_reference(jeng.index, device="cpu")
    assert np.array_equal(idx.coords, jeng.index.coords)
    got = QueryEngine(idx).predict(queries, return_distance=True)
    want = jeng.predict(queries, return_distance=True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# -- the queue ------------------------------------------------------------


def test_queue_coalesces_and_reports(fitted, queries):
    _ref, port, _X = fitted
    engine = port.query_engine(leaves=4, block=32, qblock=32,
                               batch_capacity=128)
    tickets = [engine.submit(queries[s:s + 32]) for s in range(0, 320, 32)]
    assert not tickets[0].done
    assert engine.drain() == 320
    olabs, _ = engine.index.oracle_predict(queries[:320])
    assert np.array_equal(np.concatenate([t.result() for t in tickets]),
                          olabs)
    stats = engine.serving_stats()
    assert (stats["queries"], stats["batches"]) == (320, 3)
    for key in ("qps", "p50_ms", "p99_ms", "batch_fill"):
        assert np.isfinite(stats[key]) and stats[key] > 0, key
    assert stats["batch_fill"] <= 1.0 and stats["p99_ms"] >= stats["p50_ms"]
    assert stats["n_core"] == int(port.core_sample_mask_.sum())
    assert stats["index_device_bytes"] == stats["index_bytes"] > 0
    assert (stats["backend"], stats["precision"]) == ("auto", "high")
    assert (stats["shed_total"], stats["deadline_failures"],
            stats["index_epoch"]) == (0, 0, 0)


def test_queue_is_bounded_and_windowed(fitted):
    _ref, port, _X = fitted
    engine = port.query_engine(leaves=2, block=32, max_pending=64)
    engine.submit(np.zeros((40, 3)))
    with pytest.raises(QueueFull, match="queue full"):
        engine.submit(np.zeros((40, 3)))
    assert engine.serving_stats()["shed_total"] == 1
    engine.drain()
    engine.submit(np.zeros((40, 3)))
    for _ in range(3):
        engine.drain()
        engine.submit(np.zeros((1, 3)))
    engine.drain()
    hist = engine._lat_hist
    assert hist.count == 5
    assert engine.serving_stats()["latency_hist"]["count"] == 5
    footprint = hist.nbytes
    for _ in range(10_000):
        hist.observe(1.0)
    assert hist.count == 10_005 and hist.nbytes == footprint


def test_deadline_fails_tickets(fitted):
    _ref, port, _X = fitted
    engine = port.query_engine(leaves=2, block=32)
    late = engine.submit(np.zeros((4, 3)), timeout_s=0.0)
    ok = engine.submit(np.zeros((4, 3)), timeout_s=60.0)
    engine.drain()
    assert late.failed and ok.done and not ok.failed
    with pytest.raises(DeadlineExceeded, match="deadline"):
        late.result()
    assert engine.serving_stats()["deadline_failures"] == 1


def test_refit_makes_a_held_engine_stale(blobs750):
    port = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(blobs750)
    engine = port.query_engine(leaves=2, block=32)
    engine.predict(blobs750[:10])
    assert port.query_engine() is engine  # cached
    port.fit(blobs750[:500])
    with pytest.raises(RuntimeError, match="refit"):
        engine.predict(blobs750[:10])
    fresh = port.query_engine()
    assert fresh is not engine
    fresh.predict(blobs750[:10])


def test_query_validation(fitted):
    _ref, port, _X = fitted
    engine = port.query_engine(leaves=4, block=32)
    with pytest.raises(ValueError, match="dimensionality"):
        engine.predict(np.zeros((4, 5)))
    with pytest.raises(ValueError, match="2-D"):
        engine.predict(np.zeros(4))
    bad = np.zeros((4, 3))
    bad[1, 0] = np.nan
    with pytest.raises(ValueError, match="NaN or infinite"):
        engine.predict(bad)


@pytest.mark.parametrize("points,k,match", [
    (np.zeros(3), None, "2-D"),
    (np.zeros((2, 3, 1)), None, "2-D"),
    (np.zeros((2, 3)), 4, "dimensionality"),
    (np.array([[0.0, np.inf]]), 2, "NaN or infinite"),
    (np.array([[np.nan, 0.0]]), None, "NaN or infinite"),
])
def test_check_query_points_errors(points, k, match):
    with pytest.raises(ValueError, match=match):
        check_query_points(points, k)
    from pypardis_tpu.utils.validate import check_query_points as jcheck

    with pytest.raises(ValueError, match=match):
        jcheck(points, k)


def test_check_query_points_passes_good_input():
    X = np.arange(6, dtype=np.int64).reshape(3, 2)
    assert check_query_points(X, 2) is not None
    assert check_query_points(X).shape == (3, 2)


# -- backends, precision, device ------------------------------------------


def test_engine_backend_must_match_the_index_device(fitted):
    """``"auto"`` runs the plain version on a CPU index; an explicit
    backend must match the device (the plain version never stands in
    for B5 on the card)."""
    _ref, port, _X = fitted
    idx = port.query_engine(leaves=2, block=32).index
    assert QueryEngine(idx, backend="torch").backend == "torch"
    assert QueryEngine(idx, backend="AUTO").backend == "auto"
    with pytest.raises(ValueError, match="cannot run"):
        QueryEngine(idx, backend="cuda")
    with pytest.raises(ValueError, match="kernel_backend"):
        QueryEngine(idx, backend="pallas")


def test_mixed_precision_engine_equals_the_oracle_after_the_verdict(fitted):
    """A "mixed" engine (B5 with its bf16 chunk prefilter) answers as the
    numpy oracle and the JAX "mixed" engine do (the engines apply the
    within-eps verdict); an explicit precision is reported as asked."""
    ref, port, X = fitted
    rng = np.random.default_rng(12)
    Q = np.concatenate([X[::3] + rng.normal(scale=0.1, size=X[::3].shape),
                        rng.uniform(-4, 4, size=(60, X.shape[1]))])
    engine = port.query_engine(leaves=2, block=32, precision="mixed")
    assert engine.serving_stats()["precision"] == "mixed"
    t = _assert_exact(engine, Q)
    jeng = ref.query_engine(leaves=2, block=32, precision="mixed")
    jt = jeng.submit(Q)
    jeng.drain()
    assert np.array_equal(t.labels, jt.labels)
    assert np.array_equal(t.d2.view(np.int32), jt.d2.view(np.int32))
    assert (t.labels >= 0).any() and (t.labels < 0).any()
    exact = port.query_engine(leaves=2, block=32, precision="highest")
    assert exact.serving_stats()["precision"] == "highest"


def test_query_leaf_rejects_bad_inputs():
    q = torch.zeros((2, 3, 8))
    tl = torch.zeros(2, dtype=torch.int32)
    coords = torch.zeros((3, 64))
    labels = torch.zeros(64, dtype=torch.int32)
    ck.query_leaf(q, tl, coords, labels, block=16, nb=2)
    with pytest.raises(ValueError, match="multiple"):
        ck.query_leaf(q, tl, coords, labels, block=16, nb=3)
    with pytest.raises(ValueError, match="coords"):
        ck.query_leaf(q, tl, coords[:2].contiguous(), labels, block=16, nb=2)
    with pytest.raises(ValueError, match="labels"):
        ck.query_leaf(q, tl, coords, labels.long(), block=16, nb=2)
    with pytest.raises(ValueError, match="tile_leaf"):
        ck.query_leaf(q, tl[:1], coords, labels, block=16, nb=2)
    with pytest.raises(ValueError, match="queries"):
        ck.query_leaf(q.double(), tl, coords, labels, block=16, nb=2)


def test_serving_needs_a_card_unless_asked_for_the_cpu(monkeypatch, fitted):
    _ref, port, _X = fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mask = port.core_sample_mask_
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorePointIndex.build(np.asarray(port.data)[mask],
                             port.labels_[mask], port.eps)
    with pytest.raises(RuntimeError, match="not fitted"):
        DBSCAN(eps=0.5, device="cpu").predict(np.zeros((1, 3)))
