"""The port's sweep on a mesh (``DBSCAN(mesh=Mesh(["cpu"] * P)).sweep``),
held against the JAX package's sharded sweep on ``default_mesh(P)``
(``tests/test_sweep.py``'s KD and global-Morton cases): the graph
emission's owner-computes row restriction (``neighbor_pair_graph(
row_tiles=)``), the global graphs of ``sweep_graph_sharded`` and
``sweep_graph_global_morton`` (sorted ``(gi, gj, dval)`` triples,
``dval`` bitwise, and their stats), each config's labels and core flags
against the JAX sweep and the port's own sharded fit at it, the overflow
rung, the graph's reuse, the tensor input's single-card route and the
report's route keys.

The graphs are compared on a lattice (multiples of 1/16, each point
beside its negation, so the float64 mean the slabs recentre on is 0):
there both packages' float32 d^2 forms are exact, so ``dval`` is equal
bit for bit, and so are the graphs' sizes and the sweeps' labels.
Elsewhere the two forms may round a pair within 1e-5 of eps apart
(``tests/test_torch_sweep.py``); the tests that hold the port against
itself run on blobs."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.ops.distances import (
    neighbor_pair_graph as jax_neighbor_pair_graph,
)
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import global_morton as jax_gm
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch import DBSCAN, obs
from pypardis_tpu_torch.ops.distances import neighbor_pair_graph
from pypardis_tpu_torch.parallel import (
    Mesh, staging, sweep_graph_global_morton, sweep_graph_sharded,
)
from pypardis_tpu_torch.partition import KDPartitioner

EPS_LIST = [0.25, 0.4]
MS_LIST = [3, 5]
KW = dict(min_samples=5, block=128)


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
def blobs():
    X, _ = make_blobs(n_samples=1200, centers=5, n_features=3,
                      cluster_std=0.3, random_state=3)
    return X


@pytest.fixture(scope="module")
def lattice():
    """600 blob points on the 1/16 lattice and their negations."""
    X, _ = make_blobs(n_samples=600, centers=4, n_features=3,
                      cluster_std=0.3, random_state=7)
    X = np.round(X * 16.0) / 16.0
    return np.concatenate([X, -X])


def _mesh(P):
    return Mesh(["cpu"] * P)


def _triples(gi, gj, dv):
    """The edge set as a sorted (E, 3) array, ``dval`` by its bits."""
    gi, gj, dv = (np.asarray(a) for a in (gi, gj, dv))
    bits = dv.astype(np.float32).view(np.int32).astype(np.int64)
    t = np.stack([gi.astype(np.int64), gj.astype(np.int64), bits], axis=1)
    return t[np.lexsort(t.T[::-1])]


def _graph_np(graph):
    return tuple(t.cpu().numpy() for t in graph)


@pytest.mark.parametrize("metric,eps", [("euclidean", 0.4),
                                        ("cityblock", 0.6)])
def test_row_tiles_emission_matches_jax(lattice, metric, eps):
    """The owned prefix emits, the rest is column evidence: the JAX
    emission's edge set with ``row_tiles``, and ``row_tiles`` of every
    tile (or None) is the unrestricted emission bit for bit."""
    tile = 128
    n = 1024
    pts = torch.from_numpy(lattice[:n].T.astype(np.float32).copy())
    mask = torch.ones(n, dtype=torch.bool)
    mask[-37:] = False
    whole = neighbor_pair_graph(pts, mask, eps, metric=metric, tile=tile)
    every = neighbor_pair_graph(pts, mask, eps, metric=metric, tile=tile,
                                row_tiles=n // tile)
    for a, b in zip(whole[:3], every[:3]):
        assert torch.equal(a, b)
    assert whole[3] == every[3]
    for rt in (1, 3):
        gi, gj, dv, st = neighbor_pair_graph(pts, mask, eps, metric=metric,
                                             tile=tile, row_tiles=rt)
        e = st[0]
        assert st[0] <= st[1]
        assert int(gi[:e].max()) < rt * tile
        ji, jj, jd, jst = jax_neighbor_pair_graph(
            pts.numpy(), mask.numpy(), eps, metric=metric, block=tile,
            layout="dn", row_tiles=rt)
        jst = np.asarray(jst)
        jd = np.asarray(jd)
        live = np.isfinite(jd)
        assert int(jst[0]) == e and int(jst[2]) == st[2]
        np.testing.assert_array_equal(
            _triples(gi[:e], gj[:e], dv[:e]),
            _triples(np.asarray(ji)[live], np.asarray(jj)[live], jd[live]))


@pytest.mark.parametrize("P", [4, 8])
def test_sweep_graph_sharded_matches_jax(lattice, P):
    eps = 0.4
    g, st = sweep_graph_sharded(
        lattice, KDPartitioner(lattice, max_partitions=P), eps, block=128,
        mesh=_mesh(P), device="cpu")
    jg, jst = jax_sharded.sweep_graph_sharded(
        lattice, JaxKD(lattice, max_partitions=P), eps, block=128,
        mesh=default_mesh(P))
    np.testing.assert_array_equal(_triples(*_graph_np(g)), _triples(*jg))
    assert g[0].dtype == torch.int32 and g[2].dtype == torch.float32
    assert st == jst
    assert st["mode"] == "kd" and st["owner_computes"] is True
    assert st["graph_bytes"] == 12 * st["graph_pairs"] > 0


@pytest.mark.parametrize("P", [4, 8])
def test_sweep_graph_global_morton_matches_jax(lattice, P):
    eps = 0.4
    g, st = sweep_graph_global_morton(lattice, eps, block=128,
                                      mesh=_mesh(P), device="cpu")
    jg, jst = jax_gm.sweep_graph_global_morton(lattice, eps, block=128,
                                               mesh=default_mesh(P))
    np.testing.assert_array_equal(_triples(*_graph_np(g)), _triples(*jg))
    assert st == jst
    assert st["duplicated_work_factor"] == 1.0
    assert st["boundary_tiles"] > 0 and st["n_partitions"] == P


def _sharded_fit(X, eps, ms, **kw):
    m = DBSCAN(eps=eps, min_samples=ms, device="cpu", **kw).fit(X)
    return m.labels_, m.core_sample_mask_


@pytest.mark.parametrize("mode,P", [("kd", 4), ("kd", 8),
                                    ("global_morton", 4),
                                    ("global_morton", 8)])
def test_sharded_sweep_matches_jax_and_fits(lattice, mode, P):
    """Each config byte-identical to the JAX sweep on the same route and
    to the port's own sharded fit at it (``tests/test_sweep.py``'s KD
    and global-Morton contracts); one distance pass, the route's mode,
    graph size and partitions equal."""
    extra = {} if mode == "kd" else {"mode": "global_morton"}
    kw = dict(KW, mesh=_mesh(P), **extra)
    m = DBSCAN(eps=0.4, device="cpu", **kw)
    res = m.sweep(lattice, EPS_LIST, MS_LIST)
    jres = JaxDBSCAN(eps=0.4, mesh=default_mesh(P), **KW, **extra).sweep(
        lattice, EPS_LIST, MS_LIST)
    st, jst = res.stats, jres.stats
    assert st["mode"] == jst["mode"] == mode
    assert st["distance_passes"] == jst["distance_passes"] == 1
    for key in ("graph_pairs", "graph_bytes", "owner_computes",
                "n_devices", "degraded", "k"):
        assert st[key] == jst[key], key
    assert m.metrics_["n_partitions"] == P
    assert res.configs == jres.configs
    for cfg in res.configs:
        np.testing.assert_array_equal(res.labels(*cfg), jres.labels(*cfg),
                                      err_msg=f"{mode} {cfg}")
        np.testing.assert_array_equal(res.core(*cfg), jres.core(*cfg))
        lab, core = _sharded_fit(lattice, *cfg,
                                 **{k: v for k, v in kw.items()
                                    if k != "min_samples"})
        np.testing.assert_array_equal(res.labels(*cfg), lab,
                                      err_msg=f"{mode} fit {cfg}")
        np.testing.assert_array_equal(res.core(*cfg), core)
    assert res.per_config[0]["staged_bytes_reused"] == 0
    assert all(c["staged_bytes_reused"] > 0 for c in res.per_config[1:])
    assert m.report()["run"]["n_devices"] == P


@pytest.mark.parametrize("mode", ["kd", "global_morton"])
def test_overflow_degrades_to_per_config_fits(blobs, monkeypatch, mode):
    """A cap below the graph: the logged ``sweep_refit`` rung, per-config
    sharded fits with exact labels, and ``degraded`` set."""
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "1000")
    extra = {} if mode == "kd" else {"mode": "global_morton"}
    kw = dict(KW, mesh=_mesh(4), **extra)
    m = DBSCAN(eps=0.4, device="cpu", **kw)
    res = m.sweep(blobs, EPS_LIST)
    assert res.stats["degraded"] == "per_config_refit"
    assert res.stats["distance_passes"] == len(EPS_LIST)
    assert res.stats["mode"] == ("auto" if mode == "kd" else mode)
    assert res.stats["owner_computes"] is False
    faults = m.report()["faults"]
    assert faults["degraded"] == 1
    assert faults["degraded_to"] == "sweep_refit"
    monkeypatch.delenv("PPTORCH_SWEEP_MAX_PAIRS")
    for eps in EPS_LIST:
        lab, core = _sharded_fit(blobs, eps, 5,
                                 **{k: v for k, v in kw.items()
                                    if k != "min_samples"})
        np.testing.assert_array_equal(res.labels(eps), lab)
        np.testing.assert_array_equal(res.core(eps), core)


def test_second_sweep_reuses_the_sharded_graph(blobs):
    """A sweep whose ceiling is under the cached one builds nothing: the
    0.4 graph's pairs, no staged bytes, labels equal to the fit; a
    higher ceiling rebuilds."""
    kw = dict(KW, mesh=_mesh(4))
    m = DBSCAN(eps=0.4, device="cpu", **kw)
    res1 = m.sweep(blobs, EPS_LIST)
    recorder = obs.RunRecorder(device="cpu")
    with obs.use_recorder(recorder):
        res2 = m.sweep(blobs, [0.25])
    assert res2.stats["mode"] == "kd"
    assert res2.stats["graph_pairs"] == res1.stats["graph_pairs"]
    assert int(m.metrics_["staged_bytes"]) == 0
    assert int(m.metrics_["staged_bytes_reused"]) > 0
    lab, core = _sharded_fit(blobs, 0.25, 5, block=128, mesh=_mesh(4))
    np.testing.assert_array_equal(res2.labels(0.25), lab)
    np.testing.assert_array_equal(res2.core(0.25), core)
    m.sweep(blobs, [0.5])
    assert int(m.metrics_["staged_bytes"]) > 0


def test_tensor_input_on_a_mesh_sweeps_fused(blobs):
    """A tensor takes the single-card route on a mesh, as in JAX, and
    its report's sweep block names it as the JAX fused sweep's does
    (``tests/test_sweep.py:68-69``)."""
    X = torch.from_numpy(blobs.astype(np.float32))
    m = DBSCAN(eps=0.4, device="cpu", mesh=_mesh(4), **KW)
    res = m.sweep(X, EPS_LIST)
    assert res.stats["mode"] == "fused" and res.stats["n_devices"] == 1
    ref = DBSCAN(eps=0.4, device="cpu", **KW).sweep(X, EPS_LIST)
    for cfg in res.configs:
        np.testing.assert_array_equal(res.labels(*cfg), ref.labels(*cfg))
    jm = JaxDBSCAN(eps=0.4, mesh=default_mesh(1), **KW)
    jm.sweep(blobs, EPS_LIST)
    rep, jrep = m.report()["sweep"], jm.report()["sweep"]
    assert rep["owner_computes"] is False
    assert rep["dispatch"] in ("pair", "dense")
    for key in ("mode", "owner_computes", "n_devices", "distance_passes"):
        assert rep[key] == jrep[key], key


@pytest.mark.parametrize("mode", ["kd", "global_morton"])
def test_report_sweep_block_names_the_route(blobs, mode):
    """``report()["sweep"]`` carries ``owner_computes`` and ``dispatch``
    on the sharded routes too, equal to the JAX sweep's."""
    extra = {} if mode == "kd" else {"mode": "global_morton"}
    m = DBSCAN(eps=0.4, device="cpu", mesh=_mesh(4), **KW, **extra)
    m.sweep(blobs, EPS_LIST)
    jm = JaxDBSCAN(eps=0.4, mesh=default_mesh(4), **KW, **extra)
    jm.sweep(blobs, EPS_LIST)
    rep, jrep = m.report()["sweep"], jm.report()["sweep"]
    assert rep["owner_computes"] is True
    assert rep["dispatch"] in ("pair", "dense")
    for key in ("mode", "owner_computes", "n_devices", "distance_passes"):
        assert rep[key] == jrep[key], key
