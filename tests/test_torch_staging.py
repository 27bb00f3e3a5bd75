"""The staging cache (``pypardis_tpu_torch/parallel/staging.py``) against
the JAX package's (``pypardis_tpu/parallel/staging.py``): the
counterparts of ``tests/test_staging.py`` and of
``tests/test_faults.py::test_staging_oom_evicts_and_recovers``, run on
both packages over the same seeded inputs.  Warm fits give labels and
core flags byte-identical to cold fits and to the JAX package, and the
counters (``staged_bytes``, ``staged_bytes_reused``) equal the JAX
package's where both stage the same arrays.  A mutated input, another
device and a tensor input never hit."""

import hashlib

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.dbscan import _pad_and_run as jax_pad_and_run
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import sharded_dbscan as jax_sharded_dbscan
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu.utils import faults as jax_faults
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.dbscan import _pad_and_run
from pypardis_tpu_torch.ops.pipeline import LAYOUT_ROUTE
from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan, staging
from pypardis_tpu_torch.partition import KDPartitioner
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
        n_samples=1500, centers=5, n_features=3, cluster_std=0.3,
        random_state=11,
    )
    return X


KW = dict(eps=0.4, min_samples=5, block=128)


def _both(X, mesh_size, **kw):
    """``(port, jax)`` sharded fits of ``X`` on a mesh of ``mesh_size``
    (one device: the chained route)."""
    port = sharded_dbscan(
        X, KDPartitioner(X, max_partitions=8),
        mesh=Mesh(["cpu"] * mesh_size) if mesh_size > 1 else None,
        device="cpu", **kw)
    jax = jax_sharded_dbscan(X, JaxKD(X, max_partitions=8),
                             mesh=default_mesh(mesh_size), **kw)
    return port, jax


def _counters(stats):
    return stats["staged_bytes"], stats["staged_bytes_reused"]


def _same(port, jax):
    assert np.array_equal(port[0], np.asarray(jax[0]))
    assert np.array_equal(port[1], np.asarray(jax[1]))
    assert _counters(port[2]) == _counters(jax[2])


def test_warm_fit_reuses_staged_slabs(data):
    cold = _both(data, 8, **KW)
    assert _counters(cold[0][2])[1] == 0 and cold[0][2]["staged_bytes"] > 0
    warm = _both(data, 8, **KW)
    # Warm: owned AND halo slabs from the cache, nothing shipped.
    assert _counters(warm[0][2]) == (0, cold[0][2]["staged_bytes"])
    for a, b in ((cold[0], warm[0]), (cold[0], cold[1]), (warm[0], warm[1])):
        assert np.array_equal(a[0], np.asarray(b[0]))
        assert np.array_equal(a[1], np.asarray(b[1]))
    _same(*cold)
    _same(*warm)


def test_eps_sweep_reuses_owned_slabs_only(data):
    """Owned slabs are keyed without eps: an eps change re-ships the
    halos alone."""
    kw = dict(KW, eps=0.4)
    _same(*_both(data, 8, **kw))
    second = _both(data, 8, **dict(kw, eps=0.5))
    _same(*second)
    shipped, reused = _counters(second[0][2])
    assert shipped > 0 and reused > 0


def test_mutated_input_never_served_stale(data):
    X = np.array(data)
    l1, _c, _s = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                mesh=Mesh(["cpu"] * 8), device="cpu", **KW)
    X[:200] += 100.0  # in place: the same array object
    l2, c2, s2 = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                mesh=Mesh(["cpu"] * 8), device="cpu", **KW)
    assert s2["staged_bytes_reused"] == 0
    assert not np.array_equal(l1, l2)
    staging.clear()
    l3, c3, _s3 = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                 mesh=Mesh(["cpu"] * 8), device="cpu", **KW)
    np.testing.assert_array_equal(l2, l3)
    np.testing.assert_array_equal(c2, c3)
    jl, _jc, js = jax_sharded_dbscan(X, JaxKD(X, max_partitions=8),
                                     mesh=default_mesh(8), **KW)
    assert np.array_equal(l2, np.asarray(jl))
    assert js["staged_bytes_reused"] == 0


def test_api_warm_refit_reports_reuse(data):
    """Through ``DBSCAN``: ``train`` builds a fresh (content-identical)
    partitioner each fit, and the second fit reports the reuse."""
    model = DBSCAN(mesh=Mesh(["cpu"] * 8), device="cpu", **KW)
    model.fit(data)
    r_cold = model.report()["sharding"]
    model.fit(data)
    r_warm = model.report()["sharding"]
    jm = JaxDBSCAN(**KW)
    jm.fit(data)
    j_cold = jm.report()["sharding"]
    jm.fit(data)
    j_warm = jm.report()["sharding"]
    assert r_cold["staged_bytes_reused"] == 0
    assert r_warm["staged_bytes_reused"] == r_cold["staged_bytes"] > 0
    for r, j in ((r_cold, j_cold), (r_warm, j_warm)):
        assert _counters(r) == _counters(j)


def test_ring_route_caches_owned_slabs(data):
    kw = dict(KW, halo="ring")
    cold = _both(data, 8, **kw)
    warm = _both(data, 8, **kw)
    _same(*cold)
    _same(*warm)
    assert cold[0][2]["staged_bytes_reused"] == 0
    assert _counters(warm[0][2]) == (0, cold[0][2]["staged_bytes"])


def test_single_shard_layout_cache(data):
    """The single-card fit's ``pipeline_layout`` route, and its bytes
    equal to the JAX route's (owner int32 as there)."""
    X = np.array(data[:1200], np.float32)
    l1, c1, i1 = _pad_and_run(X, 0.4, 5, 128, device="cpu")
    jl, jc, ji = jax_pad_and_run(X, 0.4, 5, "euclidean", 128)
    assert i1["staged_bytes_reused"] == 0
    assert i1["staged_bytes"] == ji["staged_bytes"] > 0
    assert np.array_equal(l1, np.asarray(jl))
    assert np.array_equal(c1, np.asarray(jc))
    l2, c2, i2 = _pad_and_run(X, 0.4, 5, 128, device="cpu")
    assert (i2["staged_bytes"], i2["staged_bytes_reused"]) == (
        0, i1["staged_bytes"])
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(c1, c2)
    # another min_samples: the layout does not depend on it
    _l, _c, i3 = _pad_and_run(X, 0.4, 9, 128, device="cpu")
    assert i3["staged_bytes_reused"] == i1["staged_bytes"]
    # another eps: other segment breaks, a miss
    _l, _c, i4 = _pad_and_run(X, 0.5, 5, 128, device="cpu")
    assert i4["staged_bytes_reused"] == 0
    # mutated in place: a content miss, fresh labels
    X[:100] += 40.0
    l5, c5, i5 = _pad_and_run(X, 0.4, 5, 128, device="cpu")
    assert i5["staged_bytes_reused"] == 0
    staging.clear()
    l6, c6, _i6 = _pad_and_run(X, 0.4, 5, 128, device="cpu")
    np.testing.assert_array_equal(l5, l6)
    np.testing.assert_array_equal(c5, c6)


@pytest.mark.parametrize("kind", ["float64", "float32", "int32", "memmap",
                                  "noncontiguous"])
def test_points_fingerprint_is_the_jax_fingerprint(kind, tmp_path):
    """One definition, bit-identical to the JAX package's: snapshots
    (``utils/jobstate.fit_meta``) are bound to it."""
    from pypardis_tpu.utils import jobstate as jax_jobstate
    from pypardis_tpu_torch.utils import jobstate

    rng = np.random.default_rng(3)
    X = rng.normal(size=(5000, 7))
    if kind == "float32":
        X = X.astype(np.float32)
    elif kind == "int32":
        X = (X * 100).astype(np.int32)
    elif kind == "memmap":
        mm = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+",
                                       dtype=np.float64, shape=X.shape)
        mm[:] = X
        X = mm
    elif kind == "noncontiguous":
        X = X[::2, 1:]
    assert staging.points_fingerprint(X) == jax_staging.points_fingerprint(X)
    kw = dict(eps=0.3, min_samples=5, metric="euclidean", block=64,
              mode="kd")
    assert jobstate.fit_meta(X, **kw) == jax_jobstate.fit_meta(X, **kw)


def _fit_layout(X, device="cpu"):
    return _pad_and_run(X, 0.4, 5, 128, device=device)


def test_another_device_misses(data):
    """The key holds the device: an entry a card fit left (its key's
    device ``cuda:0``) never serves a CPU fit."""
    X = np.array(data[:1200])
    l1, c1, i1 = _fit_layout(X)
    key, arrays, aux, nbytes = staging._device_cache[LAYOUT_ROUTE]
    assert key[-1] == "cpu"
    staging._device_cache[LAYOUT_ROUTE] = (key[:-1] + ("cuda:0",), arrays,
                                          aux, nbytes)
    l2, c2, i2 = _fit_layout(X)
    assert i2["staged_bytes_reused"] == 0 and i2["staged_bytes"] > 0
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(c1, c2)
    # The KD routes key their mesh's devices as strings.
    from pypardis_tpu_torch.parallel.sharded import _sharding_cache_key

    part = KDPartitioner(X, max_partitions=4)
    a = _sharding_cache_key(X, part, 4, 128, ["cpu"] * 4)
    b = _sharding_cache_key(X, part, 4, 128, ["cuda:0"] * 4)
    assert a != b and a[-1] == ("cpu",) * 4


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def test_fits_never_write_into_cached_tensors(data):
    """Every cached tensor hashes the same after warm fits on every route
    as after the cold fits that cached it."""
    X = np.array(data)
    mesh = Mesh(["cpu"] * 4)
    runs = [
        lambda: DBSCAN(device="cpu", **KW).fit(X),
        lambda: DBSCAN(device="cpu", min_samples=9, eps=0.4,
                       block=128).fit(X),
        lambda: DBSCAN(device="cpu", **KW).sweep(X, [0.3, 0.4]),
        lambda: sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                               device="cpu", **KW),
        lambda: sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                               mesh=mesh, device="cpu", **KW),
        lambda: sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                               mesh=mesh, device="cpu", halo="ring", **KW),
    ]
    for run in runs:
        run()
    before = {r: _digest(e[1]) for r, e in staging._device_cache.items()}
    assert {"pipeline_layout", "sweep_graph", "chained_owned",
            "chained_halo", "host_owned", "host_halo",
            "ring_owned"} <= set(before)
    for run in runs:
        run()
    after = {r: _digest(e[1]) for r, e in staging._device_cache.items()}
    assert after == before


def test_tensor_input_is_never_fingerprinted(data, monkeypatch):
    seen = []
    orig = staging.points_fingerprint

    def spy(points):
        if isinstance(points, torch.Tensor):
            seen.append(tuple(points.shape))
        return orig(points)

    monkeypatch.setattr(staging, "points_fingerprint", spy)
    T = torch.from_numpy(np.array(data))
    m = DBSCAN(device="cpu", **KW).fit(T)
    DBSCAN(device="cpu", **KW).sweep(T, [0.3, 0.4])
    DBSCAN(mesh=Mesh(["cpu"] * 4), device="cpu", **KW).fit(T)
    assert seen == []
    assert m.metrics_["staged_bytes"] == m.metrics_["staged_bytes_reused"] \
        == 0
    assert staging.pool_nbytes() == 0


def test_staging_oom_evicts_and_recovers(data):
    """The JAX test's plan ``staging.device_put:1=oom`` on both packages:
    the copy's OOM evicts the cache, the retry ships, labels equal the
    clean fit's."""
    kw = dict(KW, max_partitions=8)
    clean = DBSCAN(mesh=Mesh(["cpu"] * 8), device="cpu", **kw).fit(data)
    staging.clear()
    DBSCAN(device="cpu", **KW).fit(data)  # something for the OOM to evict
    assert staging.route_nbytes(LAYOUT_ROUTE) > 0
    with faults.plan("staging.device_put:1=oom"):
        faulty = DBSCAN(mesh=Mesh(["cpu"] * 8), device="cpu",
                        **kw).fit(data)
    np.testing.assert_array_equal(faulty.labels_, clean.labels_)
    r = faulty.report()
    assert r["faults"]["injected"] == 1
    assert r["faults"]["retried"] >= 1
    assert staging.route_nbytes(LAYOUT_ROUTE) == 0  # evicted by the rung
    jax_staging.clear()
    with jax_faults.plan("staging.device_put:1=oom"):
        jf = JaxDBSCAN(**kw).fit(data)
    np.testing.assert_array_equal(faulty.labels_, np.asarray(jf.labels_))
    jr = jf.report()
    assert (r["faults"]["injected"], r["faults"]["retried"]) == (
        jr["faults"]["injected"], jr["faults"]["retried"])


def test_resource_sampler_reads_the_pool(data):
    from pypardis_tpu_torch.obs.resources import staging_pool_bytes

    m = DBSCAN(device="cpu", **KW).fit(data)
    assert staging_pool_bytes() == staging.pool_nbytes() > 0
    assert m.report()["resources"]["staging_pool_bytes"] \
        == staging.pool_nbytes()
