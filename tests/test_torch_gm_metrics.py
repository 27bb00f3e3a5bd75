"""The global-Morton engine's other metrics, held against the JAX engine
on the same inputs: cityblock through ``global_morton_dbscan(...,
metric="cityblock")`` on 4- and 8-device meshes under both merges and in
the chained form (labels after ``_canonicalize_roots``, core flags, the
exchange's ``(bnd, bmsk, bgid)`` and every count in ``stats``), at 256
axes where a Euclidean fit would run the sketch, through ``DBSCAN`` and
its sweep; cosine and haversine through ``DBSCAN``'s frames on the
global-Morton mesh; and the engine's ``ValueError`` for either of them
passed to it directly.

The cityblock data sit on the 1/16 lattice, so both packages' float32
L1 sums are exact whatever their order."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import global_morton as jax_gm
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import Mesh, global_morton_dbscan, staging
from pypardis_tpu_torch.parallel import global_morton as gm
from pypardis_tpu_torch.parallel.sharded import _canonicalize_roots

KW = dict(eps=0.6, min_samples=5, block=128, metric="cityblock")
# Timings, the port's own telemetry and the overlap's timed efficiency.
PORT_ONLY = {"stage_s", "partition_passes", "merge_host_syncs",
             "exchange_overlap_efficiency"}


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
    X, _ = make_blobs(n_samples=1200, centers=5, n_features=3,
                      cluster_std=0.3, random_state=3)
    return np.round(X * 16.0) / 16.0


def _check_stats(stats, want, tag):
    assert set(stats) - PORT_ONLY == set(want) - PORT_ONLY, tag
    for key in sorted(want):
        if key.endswith("_s") or key in PORT_ONLY or key == "parity":
            continue
        assert stats[key] == want[key], (tag, key)


def _recording(monkeypatch, module, store):
    """Record each call's exchange products of ``module``'s engine."""
    inner = module._gm_boundary_tiles

    def rec(*a, **k):
        out = inner(*a, **k)
        store.append(out[0])
        return out

    monkeypatch.setattr(module, "_gm_boundary_tiles", rec)


@pytest.mark.parametrize("P,merge", [(4, "device"), (4, "host"),
                                     (8, "device"), (8, "host")])
def test_cityblock_engine_matches_jax(lattice, monkeypatch, P, merge):
    got_x, want_x = [], []
    _recording(monkeypatch, gm, got_x)
    _recording(monkeypatch, jax_gm, want_x)
    kw = dict(KW, merge=merge)
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        lattice, mesh=default_mesh(P), **kw)
    lab, core, st = global_morton_dbscan(lattice, mesh=Mesh(["cpu"] * P),
                                         device="cpu", **kw)
    tag = f"P={P} {merge}"
    np.testing.assert_array_equal(_canonicalize_roots(lab, core),
                                  _canonicalize_roots(j_lab, j_core),
                                  err_msg=tag)
    np.testing.assert_array_equal(lab, j_lab, err_msg=tag)
    np.testing.assert_array_equal(core, j_core, err_msg=tag)
    _check_stats(st, j_st, tag)
    assert st["merge"] == merge and st["ring_rounds"] == P - 1
    assert st["boundary_tiles"] > 0
    (bnd, bmsk, bgid), = got_x
    (j_b, j_m, j_g), = want_x
    for s in range(P):
        np.testing.assert_array_equal(bnd[s].numpy().T, np.asarray(j_b)[s])
        np.testing.assert_array_equal(bmsk[s].numpy(), np.asarray(j_m)[s])
        np.testing.assert_array_equal(bgid[s].numpy(), np.asarray(j_g)[s])


@pytest.mark.parametrize("chain", [2, 4])
def test_cityblock_chained_form_matches_jax(lattice, chain):
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        lattice, mesh=default_mesh(1), chain=chain, **KW)
    lab, core, st = global_morton_dbscan(lattice, mesh=1, chain=chain,
                                         device="cpu", **KW)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    _check_stats(st, j_st, f"chain={chain}")
    assert st["duplicated_work_factor"] == 1.0


def test_cityblock_runs_unsketched_at_width(monkeypatch):
    """At 256 axes a Euclidean fit tightens the ring with the sketch;
    cityblock's passes run unsketched and its exchange is the box one,
    as in JAX."""
    X, _ = make_blobs(n_samples=1200, centers=4, n_features=256,
                      cluster_std=0.25, center_box=(-4, 4), random_state=2)
    X = np.round(X * 16.0) / 16.0
    kw = dict(eps=90.0, min_samples=5, block=128, metric="cityblock",
              merge="host")
    got_x, want_x = [], []
    _recording(monkeypatch, gm, got_x)
    _recording(monkeypatch, jax_gm, want_x)
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        X, mesh=default_mesh(4), **kw)
    lab, core, st = global_morton_dbscan(X, mesh=Mesh(["cpu"] * 4),
                                         device="cpu", **kw)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    _check_stats(st, j_st, "256-D")
    assert st["sketch_k"] == 0 and st["sent_tiles"] == st["sent_tiles_box"]
    assert len(np.unique(lab[lab >= 0])) == 4
    for (a, b, c), (ja, jb, jc) in zip(got_x, want_x):
        for s in range(4):
            np.testing.assert_array_equal(a[s].numpy().T, np.asarray(ja)[s])
            np.testing.assert_array_equal(c[s].numpy(), np.asarray(jc)[s])


def test_cityblock_through_dbscan_and_its_sweep(lattice):
    """``DBSCAN(metric="cityblock", mode="global_morton", mesh=...)``:
    the JAX model's labels, canon-equal to the single-card cityblock
    fit; its sweep the JAX sweep's configs byte for byte."""
    kw = dict(KW, mode="global_morton")
    m = DBSCAN(mesh=Mesh(["cpu"] * 4), device="cpu", **kw).fit(lattice)
    j = JaxDBSCAN(mesh=default_mesh(4), **kw).fit(lattice)
    np.testing.assert_array_equal(m.labels_, np.asarray(j.labels_))
    np.testing.assert_array_equal(m.core_sample_mask_,
                                  np.asarray(j.core_sample_mask_))
    assert m.metrics_["mode"] == "global_morton"
    one = DBSCAN(device="cpu", **{k: v for k, v in KW.items()}).fit(lattice)
    np.testing.assert_array_equal(
        _canonicalize_roots(m.labels_, m.core_sample_mask_),
        _canonicalize_roots(one.labels_, one.core_sample_mask_))
    res = DBSCAN(mesh=Mesh(["cpu"] * 4), device="cpu", **kw).sweep(
        lattice, [0.4, 0.6])
    jres = JaxDBSCAN(mesh=default_mesh(4), **kw).sweep(lattice, [0.4, 0.6])
    assert res.stats["mode"] == jres.stats["mode"] == "global_morton"
    assert res.stats["graph_pairs"] == jres.stats["graph_pairs"]
    for cfg in res.configs:
        np.testing.assert_array_equal(res.labels(*cfg), jres.labels(*cfg))
        np.testing.assert_array_equal(res.core(*cfg), jres.core(*cfg))


def _sphere_rows(n_per=240, d=8, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(5, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    X = np.concatenate([ci + rng.normal(scale=0.03, size=(n_per, d))
                        for ci in c])
    return X * rng.uniform(0.5, 2.0, size=(len(X), 1))


def _geo_rows(n_per=240, seed=5):
    """(lat, lon) radians around five cities at least 0.9 rad apart,
    0.01 rad of spread, and 20 points anywhere: no pair lies near the
    0.2 rad eps, where the packages' float32 chords of unit rows (which
    err by about 2^-22 in d^2) could round apart."""
    rng = np.random.default_rng(seed)
    c = np.radians([[48.85, 2.35], [40.71, -74.0], [35.68, 139.69],
                    [-33.87, 151.21], [-23.55, -46.63]])
    X = np.concatenate([ci + rng.normal(scale=1e-2, size=(n_per, 2))
                        for ci in c])
    far = np.stack([np.arcsin(rng.uniform(-1, 1, 20)),
                    rng.uniform(-np.pi, np.pi, 20)], axis=1)
    return np.concatenate([X, far])


@pytest.mark.parametrize("metric", ["cosine", "haversine"])
def test_frame_metrics_on_the_global_morton_mesh(metric):
    """Cosine and haversine reach the engine through ``DBSCAN``'s frames
    (the Euclidean passes): the JAX model's labels and core flags."""
    if metric == "cosine":
        X, eps = _sphere_rows(), 0.01
    else:
        X, eps = _geo_rows(), 0.2
    kw = dict(eps=eps, min_samples=5, block=128, metric=metric,
              mode="global_morton")
    m = DBSCAN(mesh=Mesh(["cpu"] * 4), device="cpu", **kw).fit(X)
    j = JaxDBSCAN(mesh=default_mesh(4), **kw).fit(X)
    np.testing.assert_array_equal(m.labels_, np.asarray(j.labels_))
    np.testing.assert_array_equal(m.core_sample_mask_,
                                  np.asarray(j.core_sample_mask_))
    assert m.metrics_["mode"] == "global_morton"
    assert m.metrics_["n_partitions"] == 4
    assert len(np.unique(m.labels_[m.labels_ >= 0])) == 5


@pytest.mark.parametrize("metric", ["cosine", "haversine"])
def test_engine_refuses_a_frame_metric(lattice, metric):
    """Passed to the engine directly cosine or haversine raises
    ``ValueError``, as the JAX normalizer does, on the mesh and in the
    chained form."""
    kw = dict(KW, metric=metric)
    with pytest.raises(ValueError):
        jax_gm.global_morton_dbscan(lattice, mesh=default_mesh(4), **kw)
    with pytest.raises(ValueError):
        global_morton_dbscan(lattice, mesh=Mesh(["cpu"] * 4), device="cpu",
                             **kw)
    with pytest.raises(ValueError):
        global_morton_dbscan(lattice, mesh=1, chain=4, device="cpu", **kw)
