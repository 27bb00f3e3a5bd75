"""The sweep graph's cache on every route: an eps=None fit served a
cached graph built at a higher ceiling gives what the cold fit gives
(and the JAX package, which never reads the graph back), and the sweep
cap (``PPTORCH_SWEEP_MAX_PAIRS``) holds a freshly joined sharded graph
and a cached one to the same rule.

The hierarchy's data sit on the 1/16 lattice, each point beside its
negation, so both packages' float32 d^2 are exact and the selected
``eps_`` is equal, not merely close."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import Mesh, sharded, staging

KW = dict(min_samples=5, block=128)
ROUTES = {"fused": ({}, dict(mesh=default_mesh(1))),
          "kd": (dict(mesh=Mesh(["cpu"] * 4)), dict(mesh=default_mesh(4))),
          "global_morton": (dict(mesh=Mesh(["cpu"] * 4), mode="global_morton"),
                            dict(mesh=default_mesh(4), mode="global_morton"))}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_slate():
    staging.clear()
    jax_staging.clear()
    yield
    staging.clear()
    jax_staging.clear()


@pytest.fixture(scope="module")
def lattice():
    """600 blob points on the 1/16 lattice and their negations."""
    X, _ = make_blobs(n_samples=600, centers=5, n_features=3,
                      cluster_std=0.3, random_state=3)
    X = np.round(X * 16.0) / 16.0
    return np.concatenate([X, -X])


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(n_samples=1200, centers=5, n_features=3,
                      cluster_std=0.3, random_state=3)
    return X


@pytest.mark.parametrize("route", ["fused", "kd", "global_morton"])
def test_eps_none_after_a_wider_sweep_equals_the_cold_fit(lattice, route):
    """A sweep at 1.5x the hierarchy's ceiling caches a wider graph; the
    eps=None fit that follows keeps only the edges under its own ceiling,
    so its ``eps_``, labels, core flags and graph size are the cold fit's
    and the JAX route's."""
    pkw, jkw = ROUTES[route]
    cold = DBSCAN(eps=None, device="cpu", **KW, **pkw).fit(lattice)
    h0 = cold.report()["hierarchy"]
    staging.clear()
    wide = 1.5 * h0["eps_max"]
    res = DBSCAN(eps=wide, device="cpu", **KW, **pkw).sweep(lattice, [wide])
    assert res.stats["mode"] == route
    assert res.stats["graph_pairs"] > h0["graph_pairs"]
    warm = DBSCAN(eps=None, device="cpu", **KW, **pkw).fit(lattice)
    h1 = warm.report()["hierarchy"]
    assert int(warm.metrics_["staged_bytes"]) == 0
    assert warm.eps_ == cold.eps_
    np.testing.assert_array_equal(warm.labels_, cold.labels_)
    np.testing.assert_array_equal(warm.core_sample_mask_,
                                  cold.core_sample_mask_)
    for key in ("graph_pairs", "graph_bytes", "mst_edges", "eps_max",
                "selected_clusters"):
        assert h1[key] == h0[key], key
    j = JaxDBSCAN(eps=None, **KW, **jkw).fit(lattice)
    assert warm.eps_ == j.eps_
    np.testing.assert_array_equal(warm.labels_, np.asarray(j.labels_))
    np.testing.assert_array_equal(warm.core_sample_mask_,
                                  np.asarray(j.core_sample_mask_))


def _slab_sizes(monkeypatch):
    """Record each slab's emitted edge count."""
    sizes = []
    orig = sharded._sweep_slab_graph

    def spy(*a, **k):
        out = orig(*a, **k)
        sizes.append(int(out[0].numel()))
        return out

    monkeypatch.setattr(sharded, "_sweep_slab_graph", spy)
    return sizes


@pytest.mark.parametrize("state", ["cold", "warm"])
@pytest.mark.parametrize("route", ["kd", "global_morton"])
def test_sweep_cap_binds_the_joined_graph(blobs, monkeypatch, route, state):
    """A cap above every slab but below the joined graph: a cold and a
    warm sweep both degrade to the logged per-config fits with exact
    labels, and an eps=None fit under the same ceiling raises the
    no-refit error either way."""
    pkw, _ = ROUTES[route]
    eps = 0.4
    monkeypatch.setenv("PPTORCH_HIER_EPS_MAX", repr(eps))
    sizes = _slab_sizes(monkeypatch)
    full = DBSCAN(eps=eps, device="cpu", **KW, **pkw).sweep(blobs, [eps])
    total = full.stats["graph_pairs"]
    assert sum(sizes) == total and len(sizes) > 1
    cap = (max(sizes) + total) // 2
    assert max(sizes) < cap < total
    if state == "cold":
        staging.clear()
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", str(cap))
    m = DBSCAN(eps=eps, device="cpu", **KW, **pkw)
    res = m.sweep(blobs, [eps])
    assert res.stats["degraded"] == "per_config_refit"
    assert m.report()["faults"]["degraded_to"] == "sweep_refit"
    np.testing.assert_array_equal(res.labels(eps), full.labels(eps))
    np.testing.assert_array_equal(res.core(eps), full.core(eps))
    with pytest.raises(RuntimeError, match="cannot degrade"):
        DBSCAN(eps=None, device="cpu", **KW, **pkw).fit(blobs)
