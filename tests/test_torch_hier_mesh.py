"""The eps-free hierarchy on a mesh: ``DBSCAN(eps=None, mesh=Mesh(["cpu"]
* P)).fit`` and ``sweep(eps_list="auto")`` on the KD and global-Morton
graphs, held against the JAX package's routes on ``default_mesh(P)``
(``tests/test_hierarchy.py``'s across-modes and auto-ladder cases) and
against the port's own fits at each selected eps and each rung.

The data sit on the 1/16 lattice, each point beside its negation (the
slabs recentre on a float64 mean of 0): both packages' float32 d^2 are
exact there, so the selected ``eps_`` and every ladder value are equal,
not merely close."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.ops.labels import densify_labels
from pypardis_tpu_torch.parallel import Mesh, staging
from pypardis_tpu_torch.parallel.sharded import _canonicalize_roots

MS = 5
KW = dict(min_samples=MS, block=128)


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


def _canon(labels, core):
    return densify_labels(_canonicalize_roots(np.asarray(labels),
                                              np.asarray(core, bool)))


def _route_kw(route, P):
    """The port's and the JAX model's keywords for a route on P devices."""
    if route == "fused":
        return {}, dict(mesh=default_mesh(1))
    extra = {"mode": "global_morton"} if route == "global_morton" else {}
    return (dict(mesh=Mesh(["cpu"] * P), **extra),
            dict(mesh=default_mesh(P), **extra))


@pytest.fixture(scope="module")
def across_modes(lattice):
    """Every route's eps=None fit, the port's and the JAX package's, on
    4 and 8 devices: ``{(route, P): (port model, JAX model)}``."""
    out = {}
    for P in (4, 8):
        for route in ("fused", "kd", "global_morton"):
            if route == "fused" and P == 8:
                continue
            pkw, jkw = _route_kw(route, P)
            staging.clear()
            jax_staging.clear()
            m = DBSCAN(eps=None, device="cpu", **KW, **pkw).fit(lattice)
            j = JaxDBSCAN(eps=None, **KW, **jkw).fit(lattice)
            out[(route, P)] = (m, j)
    return out


@pytest.mark.parametrize("route,P", [("kd", 4), ("kd", 8),
                                     ("global_morton", 4),
                                     ("global_morton", 8)])
def test_eps_none_on_a_mesh_matches_jax(across_modes, route, P):
    """The route's eps=None fit: the JAX route's ``eps_``, labels and core
    flags byte for byte, one distance pass, the route named in the
    hierarchy block and the run's devices."""
    m, j = across_modes[(route, P)]
    assert m.eps_ == j.eps_
    np.testing.assert_array_equal(m.labels_, np.asarray(j.labels_))
    np.testing.assert_array_equal(m.core_sample_mask_,
                                  np.asarray(j.core_sample_mask_))
    h, jh = m.report()["hierarchy"], j.report()["hierarchy"]
    assert h["distance_passes"] == 1
    assert h["mode"] == route and h["n_devices"] == P
    for key in ("mode", "n_devices", "graph_pairs", "mst_edges", "n_live",
                "n_components", "condensed_clusters", "selected_clusters",
                "eps_max", "eps_selected"):
        assert h[key] == jh[key], key
    assert m.report()["run"]["n_devices"] == P
    assert m.metrics_["n_partitions"] == P


@pytest.mark.parametrize("P", [4, 8])
def test_eps_none_across_modes(across_modes, P):
    """Fused, KD and global-Morton: the same selected eps and canon-
    identical labels, as ``tests/test_hierarchy.py`` holds the JAX
    routes."""
    eps0 = across_modes[("fused", 4)][0].eps_
    canon0 = _canon(across_modes[("fused", 4)][0].labels_,
                    across_modes[("fused", 4)][0].core_sample_mask_)
    for route in ("kd", "global_morton"):
        m, j = across_modes[(route, P)]
        assert m.eps_ == eps0 == j.eps_, route
        np.testing.assert_array_equal(
            _canon(m.labels_, m.core_sample_mask_), canon0, err_msg=route)
        np.testing.assert_array_equal(
            _canon(j.labels_, j.core_sample_mask_), canon0, err_msg=route)


@pytest.mark.parametrize("route", ["kd", "global_morton"])
def test_eps_none_equals_fits_at_its_eps(lattice, across_modes, route):
    """The mesh fit's labels are the route's own fit at its ``eps_`` byte
    for byte, and canon-equal to the single-card fit at it."""
    m, _j = across_modes[(route, 4)]
    pkw, _ = _route_kw(route, 4)
    ref = DBSCAN(eps=m.eps_, device="cpu", **KW, **pkw).fit(lattice)
    np.testing.assert_array_equal(m.labels_, ref.labels_)
    np.testing.assert_array_equal(m.core_sample_mask_, ref.core_sample_mask_)
    one = DBSCAN(eps=m.eps_, device="cpu", **KW).fit(lattice)
    np.testing.assert_array_equal(
        _canon(m.labels_, m.core_sample_mask_),
        _canon(one.labels_, one.core_sample_mask_))
    np.testing.assert_array_equal(m.core_sample_mask_, one.core_sample_mask_)


@pytest.mark.parametrize("route,P", [("kd", 4), ("kd", 8),
                                     ("global_morton", 4),
                                     ("global_morton", 8)])
def test_auto_ladder_rungs_on_a_mesh(lattice, route, P):
    """Every rung of ``sweep(eps_list="auto")`` byte-identical to the
    port's fit at it on the same route, and the JAX route's ladder and
    rungs equal."""
    pkw, jkw = _route_kw(route, P)
    m = DBSCAN(eps=None, device="cpu", **KW, **pkw)
    res = m.sweep(lattice, eps_list="auto", min_samples_list=[MS, 8])
    st = res.stats
    assert st["distance_passes"] == 1
    assert st["eps_source"] == "hierarchy_auto"
    assert st["mode"] == route and st["n_devices"] == P
    assert st["owner_computes"] is True
    ladder = st["ladder"]
    assert ladder == sorted(ladder) and len(res) == 2 * len(ladder)
    for eps, ms in res.configs:
        f = DBSCAN(eps=eps, min_samples=ms, block=128, device="cpu",
                   **pkw).fit(lattice)
        np.testing.assert_array_equal(res.labels(eps, ms), f.labels_,
                                      err_msg=f"{route} eps={eps} ms={ms}")
        np.testing.assert_array_equal(res.core(eps, ms),
                                      f.core_sample_mask_)
    jr = JaxDBSCAN(eps=None, **KW, **jkw).sweep(
        lattice, eps_list="auto", min_samples_list=[MS, 8])
    assert jr.stats["ladder"] == ladder
    assert jr.stats["mode"] == route
    assert jr.stats["graph_pairs"] == st["graph_pairs"]
    for cfg in res.configs:
        np.testing.assert_array_equal(res.labels(*cfg),
                                      np.asarray(jr.labels(*cfg)))
        np.testing.assert_array_equal(res.core(*cfg),
                                      np.asarray(jr.core(*cfg)))


@pytest.mark.parametrize("route", ["kd", "global_morton"])
def test_graph_past_the_cap_raises_the_no_refit_error(lattice, monkeypatch,
                                                       route):
    """The hierarchy has no eps to refit at: a graph past its cap on a
    mesh raises the no-refit error, as on one card and in JAX."""
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "1000")
    pkw, _ = _route_kw(route, 4)
    with pytest.raises(RuntimeError, match="cannot degrade"):
        DBSCAN(eps=None, device="cpu", **KW, **pkw).fit(lattice)


def test_tensor_input_on_a_mesh_stays_fused(lattice, across_modes):
    """A tensor takes the single-card graph on a mesh, as in JAX: the
    fused route's eps and labels."""
    X = torch.from_numpy(lattice.astype(np.float32))
    m = DBSCAN(eps=None, device="cpu", mesh=Mesh(["cpu"] * 4), **KW).fit(X)
    fused = across_modes[("fused", 4)][0]
    h = m.report()["hierarchy"]
    assert h["mode"] == "fused" and h["n_devices"] == 1
    assert m.eps_ == fused.eps_
    np.testing.assert_array_equal(m.labels_, fused.labels_)


def test_eps_none_then_sweep_reuses_the_mesh_graph(lattice):
    """A ladder sweep after an eps=None fit on the same mesh model reads
    the cached global graph: no staged bytes, the same pairs."""
    kw = dict(KW, mesh=Mesh(["cpu"] * 4))
    m = DBSCAN(eps=None, device="cpu", **kw).fit(lattice)
    pairs = m.report()["hierarchy"]["graph_pairs"]
    res = m.sweep(lattice, eps_list="auto")
    assert res.stats["graph_pairs"] == pairs
    assert int(m.metrics_["staged_bytes"]) == 0
    assert int(m.metrics_["staged_bytes_reused"]) > 0
