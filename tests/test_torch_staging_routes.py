"""The staging cache's routes through the port's drivers, against the JAX
package on the same seeded inputs: the counterparts of
``tests/test_overlap.py::test_overlap_warm_refit_reuses_chained_slabs``
and ``::test_overlap_mutation_safety``, ``tests/test_serve.py::
test_warm_second_index_build_reuses_device_slabs`` and ``tests/
test_sweep.py::test_second_sweep_reuses_graph``,
``::test_eps_change_staging_reuse_is_correct`` and
``::test_kd_sharded_byte_parity_and_staging_reuse``; then the serving
index's delta route, the gateway's eviction, the restage rung and a live
commit that never writes into another index's cached tensors."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import sharded_dbscan as jax_sharded_dbscan
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu.serve import build_index as jax_build_index
from pypardis_tpu.utils import faults as jax_faults
from pypardis_tpu_torch import DBSCAN, obs
from pypardis_tpu_torch.ops.pipeline import LAYOUT_ROUTE
from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan, staging
from pypardis_tpu_torch.partition import KDPartitioner
from pypardis_tpu_torch.serve import ModelGateway, build_index
from pypardis_tpu_torch.utils import faults


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_staging():
    """Both packages' caches and fault plans cleared around each test: a
    worker keeps module state across the files it runs."""
    for mod in (staging, jax_staging, faults, jax_faults):
        mod.clear()
    yield
    for mod in (staging, jax_staging, faults, jax_faults):
        mod.clear()


@pytest.fixture(scope="module")
def data():
    X, _ = make_blobs(
        n_samples=4000, centers=10, n_features=3, cluster_std=0.3,
        random_state=5,
    )
    return X.astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(
        n_samples=1500, centers=5, n_features=3, cluster_std=0.3,
        random_state=11,
    )
    return X


KW = dict(eps=0.4, min_samples=5, block=64)


def _counters(stats):
    return stats["staged_bytes"], stats["staged_bytes_reused"]


def _chained(X, **kw):
    """``(port, jax)`` chained fits (one device, overlap on)."""
    port = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                          device="cpu", **kw)
    jax = jax_sharded_dbscan(X, JaxKD(X, max_partitions=8),
                             mesh=default_mesh(1), overlap=True, **kw)
    return port, jax


def test_overlap_warm_refit_reuses_chained_slabs(data):
    """Warm refits serve every partition's slabs from the cache; an eps
    change re-ships only the (eps-keyed) halos.  Counters equal the JAX
    route's at each step."""
    steps = [_chained(data, **KW), _chained(data, **KW),
             _chained(data, **dict(KW, eps=0.5))]
    for port, jax in steps:
        np.testing.assert_array_equal(port[0], np.asarray(jax[0]))
        np.testing.assert_array_equal(port[1], np.asarray(jax[1]))
        assert _counters(port[2]) == _counters(jax[2])
    (s1, _j1), (s2, _j2), (s3, _j3) = steps
    assert s1[2]["staged_bytes_reused"] == 0 and s1[2]["staged_bytes"] > 0
    assert _counters(s2[2]) == (0, s1[2]["staged_bytes"])
    np.testing.assert_array_equal(s1[0], s2[0])
    assert s3[2]["staged_bytes_reused"] > 0  # owned slabs from the cache
    assert s3[2]["staged_bytes"] > 0  # halos re-shipped


def test_overlap_mutation_safety(data):
    """Mutate the input in place between chained fits: the second fit
    misses and matches a cold fit of the new data (and the JAX route)."""
    X = np.array(data)
    l1, _c, _s = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                device="cpu", **KW)
    X[:500] += 50.0  # in place: the same array object, the same shapes
    l2, c2, s2 = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                device="cpu", **KW)
    assert s2["staged_bytes_reused"] == 0
    staging.clear()
    ref, ref_c, _rs = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                     device="cpu", **KW)
    np.testing.assert_array_equal(l2, ref)
    np.testing.assert_array_equal(c2, ref_c)
    assert not np.array_equal(l1, l2)
    jl, _jc, _js = jax_sharded_dbscan(X, JaxKD(X, max_partitions=8),
                                      mesh=default_mesh(1), overlap=False,
                                      **KW)
    np.testing.assert_array_equal(l2, np.asarray(jl))


def _fitted(X):
    port = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu").fit(X)
    jax = JaxDBSCAN(eps=0.4, min_samples=5, block=128).fit(X)
    return port, jax


def test_warm_second_index_build_reuses_device_slabs(blobs):
    port, jax = _fitted(blobs)
    staging.device_evict("serve_index")  # a cold start
    first = build_index(port, leaves=4, block=32)
    second = build_index(port, leaves=4, block=32)
    assert first.stats["staged_bytes"] > 0
    assert second.stats["staged_bytes"] == 0
    assert (second.stats["staged_bytes_reused"]
            == first.stats["staged_bytes"])
    # The same tensors, and the same bytes as the JAX route's.
    assert all(a is b for a, b in zip(first.device_tensors(),
                                      second.device_tensors()))
    jax_staging.device_evict("serve_index")
    j_first = jax_build_index(jax, leaves=4, block=32)
    j_second = jax_build_index(jax, leaves=4, block=32)
    for p, j in ((first, j_first), (second, j_second)):
        assert _counters(p.stats) == _counters(j.stats)
    assert (staging.route_nbytes("serve_index")
            == jax_staging.route_nbytes("serve_index"))


EPS_LIST = [0.3, 0.4, 0.25]


def test_second_sweep_reuses_graph(blobs):
    """A second sweep under the cached eps ceiling reuses the graph (the
    eps-free ``sweep_graph`` route): the 0.4 graph's pair count, labels
    equal to fits, as in the JAX package."""
    kw = dict(block=128)
    m = DBSCAN(eps=0.4, min_samples=5, device="cpu", **kw)
    res1 = m.sweep(blobs, EPS_LIST)
    res2 = m.sweep(blobs, [0.25])  # ceiling under the cached 0.4
    assert int(m.metrics_["staged_bytes_reused"]) > 0
    assert int(m.metrics_["staged_bytes"]) == 0
    assert res2.stats["graph_pairs"] == res1.stats["graph_pairs"]
    fit = DBSCAN(eps=0.25, min_samples=5, device="cpu", **kw).fit(blobs)
    np.testing.assert_array_equal(res2.labels(0.25), fit.labels_)
    np.testing.assert_array_equal(res2.core(0.25), fit.core_sample_mask_)
    jm = JaxDBSCAN(eps=0.4, min_samples=5, mesh=default_mesh(1), **kw)
    j1 = jm.sweep(blobs, EPS_LIST)
    j2 = jm.sweep(blobs, [0.25])
    assert int(jm.metrics_["staged_bytes_reused"]) > 0
    # (The two graphs' edge sets may differ within 1e-5 of eps: the
    # port's sweep tests hold that; each reuse keeps its own.)
    assert j2.stats["graph_pairs"] == j1.stats["graph_pairs"]
    np.testing.assert_array_equal(res2.labels(0.25),
                                  np.asarray(j2.labels(0.25)))
    # A ceiling above the cached one rebuilds.
    m.sweep(blobs, [0.5])
    assert int(m.metrics_["staged_bytes_reused"]) == 0


def test_eps_change_staging_reuse_is_correct(blobs):
    """fit(eps1) -> fit(eps2) with owned-slab reuse equals a cold fit at
    eps2 (the JAX regression: pooled build buffers aliasing cached slabs
    on the CPU, ``give_back_after_put``)."""
    kw = dict(min_samples=5, block=128, mesh=Mesh(["cpu"] * 8),
              device="cpu")
    DBSCAN(eps=0.6, **kw).fit(blobs)
    m = DBSCAN(eps=0.25, **kw)
    m.fit(blobs)
    warm = np.asarray(m.labels_)
    assert m.metrics_["staged_bytes_reused"] > 0
    staging.clear()
    m2 = DBSCAN(eps=0.25, **kw)
    m2.fit(blobs)
    np.testing.assert_array_equal(warm, np.asarray(m2.labels_))
    jm = JaxDBSCAN(eps=0.25, min_samples=5, block=128,
                   mesh=default_mesh(8)).fit(blobs)
    np.testing.assert_array_equal(warm, np.asarray(jm.labels_))


def test_kd_sharded_byte_parity_and_staging_reuse(blobs):
    """The JAX KD sweep's reuse contract on the port's sweep (a model
    with a mesh sweeps on one device, ROADMAP A13's rest): configs 2..k
    reuse the device-resident graph, each config equals a fit at it,
    and the per-config reuse pattern is the JAX sweep's."""
    ms_list = [5, 8]
    m = DBSCAN(eps=0.4, min_samples=5, block=128, mesh=Mesh(["cpu"] * 8),
               device="cpu")
    res = m.sweep(blobs, EPS_LIST, ms_list)
    assert res.stats["distance_passes"] == 1
    assert res.per_config[0]["staged_bytes_reused"] == 0
    for cfg in res.per_config[1:]:
        assert cfg["staged_bytes_reused"] > 0, cfg
    for (e, ms), lab in res:
        fit = DBSCAN(eps=e, min_samples=ms, block=128,
                     device="cpu").fit(blobs)
        np.testing.assert_array_equal(lab, fit.labels_)
    jres = JaxDBSCAN(eps=0.4, min_samples=5, block=128,
                     mesh=default_mesh(8)).sweep(blobs, EPS_LIST, ms_list)
    assert ([c["staged_bytes_reused"] > 0 for c in res.per_config]
            == [c["staged_bytes_reused"] > 0 for c in jres.per_config])


def test_live_commit_counts_its_delta_route_and_shares_nothing(blobs):
    """A live commit replaces its route's entry by new tensors (never a
    write into tensors another index over the same slabs shares), its
    delta bytes land on the delta route, and the engine reports both."""
    model = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu")
    model.fit(blobs)
    live = model.live()
    idx = live.index
    twin = build_index(model, handle=idx.handle)
    shared = twin.device_tensors()
    # The twin's upload hit the live index's entry: the same tensors.
    assert all(a is b for a, b in zip(shared, idx.device_tensors()))
    snap = [t.clone() for t in shared]
    live.insert(blobs[:5] + 0.01)
    for a, b in zip(shared, snap):
        assert torch.equal(a, b)
    delta = idx.delta_bytes
    assert delta > 0
    assert staging.route_delta_nbytes(idx.delta_route) == delta
    assert staging.device_holds(idx.staging_route, idx.device_tensors())
    s = live.engine.serving_stats()
    assert s["index_delta_bytes"] == delta
    assert s["index_device_bytes"] == staging.route_nbytes(
        idx.staging_route)


def test_gateway_eviction_and_release_empty_the_route(blobs, tmp_path):
    model = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu")
    model.fit(blobs)
    gw = ModelGateway(budget_bytes=1 << 40, spill_dir=str(tmp_path))
    h = gw.register("a", model)
    route = h.index.staging_route
    assert route == "serve_index.a" and staging.route_nbytes(route) > 0
    assert (gw.handle("a").engine.serving_stats()["index_device_bytes"]
            == staging.route_nbytes(route))
    gw._evict(h)
    assert staging.route_nbytes(route) == 0
    h = gw.handle("a")  # readmitted from its spill: a fresh upload
    assert staging.route_nbytes(route) > 0
    gw.unregister("a")
    assert staging.route_nbytes(route) == 0


def test_restage_evicts_the_layout(blobs, monkeypatch):
    """A transient failure outliving the pipeline's own retries evicts
    ``pipeline_layout`` and restages: the retry rebuilds the layout, the
    labels stay the clean fit's."""
    from pypardis_tpu_torch import dbscan as port_dbscan
    from pypardis_tpu_torch.ops import pipeline

    clean = DBSCAN(device="cpu", **dict(KW, block=128)).fit(blobs)
    staging.clear()
    monkeypatch.setattr(pipeline, "DEFAULT_WAITS", (0.0,))
    monkeypatch.setattr(port_dbscan, "DEFAULT_WAITS", (0.0,))
    rec = obs.RunRecorder()
    with obs.use_recorder(rec), faults.plan(
            "pipeline.cluster:1=transfer_error,"
            "pipeline.cluster:2=transfer_error"):
        labels, core, info = port_dbscan._pad_and_run(
            blobs, 0.4, 5, 128, device="cpu")
    counts = rec.event_counts()
    assert counts.get("retry.restage") == 1
    # The layout shipped twice: the first attempt's was evicted.
    assert info["staged_bytes"] == 2 * staging.route_nbytes(LAYOUT_ROUTE)
    assert info["staged_bytes_reused"] == 0
    from pypardis_tpu_torch.ops.labels import densify_labels

    np.testing.assert_array_equal(densify_labels(labels), clean.labels_)
    np.testing.assert_array_equal(core, clean.core_sample_mask_)


def test_layout_cache_knobs(blobs, monkeypatch):
    """``PPTORCH_LAYOUT_CACHE=0`` turns the layout cache off and
    ``PPTORCH_LAYOUT_CACHE_MAX`` caps it (the JAX defaults: on, 512 MB of
    coordinates)."""
    from pypardis_tpu_torch.dbscan import _layout_cacheable

    assert _layout_cacheable(1 << 20, 16)
    assert not _layout_cacheable(1 << 20, 512)  # 4 GB past 512 MB
    monkeypatch.setenv("PPTORCH_LAYOUT_CACHE_MAX", str(8 << 30))
    assert _layout_cacheable(1 << 20, 512)
    monkeypatch.setenv("PPTORCH_LAYOUT_CACHE", "0")
    assert not _layout_cacheable(8, 2)
    m = DBSCAN(device="cpu", **dict(KW, block=128)).fit(blobs)
    assert m.metrics_["staged_bytes"] == 0
    assert staging.pool_nbytes() == 0


def test_transfer_retries_an_oom_and_raises_a_cuda_error():
    """Trap 1: an OOM is retried after the eviction; an error naming CUDA
    raises at once, and so does any other."""
    staging.device_put_cached("r", ("k",), (torch.zeros(8),))
    calls = []

    def oom_once():
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 2.00 GiB")
        return "shipped"

    rec = obs.RunRecorder()
    with obs.use_recorder(rec):
        assert staging.transfer(oom_once) == "shipped"
    assert len(calls) == 2 and staging.route_nbytes("r") == 0
    c = rec.metrics.as_dict()["counters"]
    assert c["retry.staging.device_put.attempts"] == 1
    for err in (RuntimeError("CUDA error: an illegal memory access was "
                             "encountered"),
                RuntimeError("CUDA error: out of memory"),
                ValueError("bad shape")):
        staging.device_put_cached("r", ("k",), (torch.zeros(8),))
        hits = []

        def boom(err=err):
            hits.append(1)
            raise err

        with pytest.raises(type(err)):
            staging.transfer(boom)
        assert len(hits) == 1 and staging.route_nbytes("r") > 0


def test_give_back_after_put_drops_host_buffers_on_the_cpu():
    """On the CPU a copy to the device may be the buffer itself: cached
    products' buffers are dropped, not pooled (the JAX aliasing bug)."""
    buf = staging.borrow((4, 8), np.float32)
    product = torch.from_numpy(buf).to("cpu")
    assert product.data_ptr() == buf.ctypes.data  # the aliasing
    staging.give_back_after_put([buf], "cpu")
    assert staging.pool_nbytes() == 0
    assert staging.borrow((4, 8), np.float32) is not buf
    staging.give_back([buf])
    assert staging.pool_nbytes() == buf.nbytes
    assert staging.borrow((4, 8), np.float32) is buf


def test_cache_bookkeeping_matches_jax():
    """The same calls on both packages' caches give the same counters,
    pool and route bytes (tensors against numpy arrays of one size)."""
    for mod, make in ((staging, lambda n: torch.zeros(n)),
                      (jax_staging, lambda n: np.zeros(n, np.float32))):
        mod.begin_fit()
        mod.device_put_cached("a", (1,), (make(10), make(6)), aux={"x": 1})
        assert mod.device_get("a", (1,))[1] == {"x": 1}
        assert mod.device_peek("a", (1,)) and not mod.device_peek("a", (2,))
        assert mod.device_get("a", (2,)) is None  # a miss evicts
        assert mod.route_nbytes("a") == 0
        mod.device_put_cached(mod.SWEEP_GRAPH_ROUTE, ("g",), (make(4),),
                              aux={"eps_max": 0.5})
        assert mod.device_get_cover(mod.SWEEP_GRAPH_ROUTE, ("g",), 0.4)
        assert mod.touch_route(mod.SWEEP_GRAPH_ROUTE) == 16
        assert mod.device_get_cover(mod.SWEEP_GRAPH_ROUTE, ("g",),
                                    0.6) is None
        mod.device_put_cached("i", ("c",), (make(8),))
        mod.device_replace("i", ("d",), (make(9),), staged_nbytes=12,
                           delta_route="i_delta")
        mod.device_replace("i", ("e",), (make(9),), staged_nbytes=4,
                           delta_route="i_delta")
        assert mod.route_delta_nbytes("i_delta") == 16
        assert mod.route_nbytes("i") == 36
    assert staging.fit_stats() == jax_staging.fit_stats()
    assert staging.pool_nbytes() == jax_staging.pool_nbytes()
