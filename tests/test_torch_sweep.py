"""The port's amortized sweep (``DBSCAN.sweep`` / ``sweep_dbscan``),
mirroring ``tests/test_sweep.py``'s single-device cases: each config's
labels and core mask byte-identical to the port's own fit at that
config and to the JAX sweep, one distance pass, the precision modes,
eps-order invariance, the exact-total retry and the degradation to
per-config fits, degenerate geometries, min_samples-only sweeps, the
functional form, validation, the cosine, haversine and cityblock
frames, and a sketch model's sweep.  The graph module and the relabel
are held against the JAX package's on the same inputs."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import benchdata
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import DBSCAN, SweepResult, sweep_dbscan
from pypardis_tpu_torch.dbscan import _stage
from pypardis_tpu_torch.ops import distances
from pypardis_tpu_torch.ops.distances import neighbor_pair_graph
from pypardis_tpu_torch.ops.labels import dbscan_fixed_size, graph_dbscan
from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

EPS_LIST = [0.25, 0.4]
MS_LIST = [3, 5]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(n_samples=1200, centers=5, n_features=3,
                      cluster_std=0.3, random_state=3)
    return X


def _solo(X, eps, ms, **kw):
    m = DBSCAN(eps=eps, min_samples=ms, device="cpu", **kw).fit(X)
    return m.labels_, m.core_sample_mask_


def _assert_parity(X, res, tag, **kw):
    for eps, ms in res.configs:
        ref_l, ref_c = _solo(X, eps, ms, **kw)
        assert np.array_equal(res.labels(eps, ms), ref_l), (tag, eps, ms)
        assert np.array_equal(res.core(eps, ms), ref_c), (tag, eps, ms)


def _jax_sweep(X, eps_list, ms_list=None, **kw):
    m = JaxDBSCAN(eps=max(eps_list), min_samples=5, kernel_backend="xla",
                  mesh=default_mesh(1), **kw)
    return m.sweep(X, eps_list, ms_list)


def test_fused_byte_parity_with_fits_and_the_jax_sweep(blobs):
    m = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu")
    res = m.sweep(blobs, EPS_LIST, MS_LIST)
    assert isinstance(res, SweepResult)
    assert res.stats["distance_passes"] == 1
    assert res.stats["degraded"] is None
    assert res.stats["graph_pairs"] > 0
    assert res.stats["graph_bytes"] == 12 * res.stats["graph_pairs"]
    assert len(res.stats["relabel_s"]) == len(res) == 4
    assert res.stats["sweep_amortization_est"] > 0
    assert res.configs == [(e, s) for e in EPS_LIST for s in MS_LIST]
    _assert_parity(blobs, res, "fused", block=128)
    ref = _jax_sweep(blobs, EPS_LIST, MS_LIST, block=128)
    for cfg in res.configs:
        assert np.array_equal(res.labels(*cfg), ref.labels(*cfg)), cfg
        assert np.array_equal(res.core(*cfg), ref.core(*cfg)), cfg
    # The model is left fitted at the last config.
    last = res.configs[-1]
    assert np.array_equal(m.labels_, res.labels(*last))
    assert np.array_equal(m.core_sample_mask_, res.core(*last))
    assert m.metrics_["kernel_passes"] >= 1 + 2 * len(res)
    assert [c for c, _l in res] == res.configs


@pytest.mark.parametrize("precision", ["highest", "mixed", "default"])
def test_precision_modes(blobs, precision):
    """The graph stores the exact d^2, so "highest" and "mixed" sweeps
    equal their fits; "default" (bf16 verdicts that depend on each fit's
    tile frames) runs per-config fits, so it equals them too."""
    kw = dict(block=128, precision=precision)
    res = DBSCAN(eps=0.4, min_samples=5, device="cpu", **kw).sweep(
        blobs, EPS_LIST)
    _assert_parity(blobs, res, precision, **kw)
    assert res.stats["distance_passes"] == (
        len(res) if precision == "default" else 1)


def test_eps_order_invariance(blobs):
    m = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu")
    a = m.sweep(blobs, sorted(EPS_LIST))
    b = m.sweep(blobs, sorted(EPS_LIST)[::-1])
    for eps in EPS_LIST:
        assert np.array_equal(a.labels(eps), b.labels(eps))
        assert np.array_equal(a.core(eps), b.core(eps))


def test_edge_overflow_retries_once_with_the_exact_total(blobs, monkeypatch):
    """A slab below the graph's size: the exact total comes back and one
    retry builds the whole graph (still one distance pass)."""
    monkeypatch.setattr(distances, "default_edge_budget", lambda n: 1000)
    res = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu").sweep(
        blobs, EPS_LIST)
    assert res.stats["distance_passes"] == 1
    assert res.stats["graph_pairs"] > 1000
    _assert_parity(blobs, res, "retry", block=128)


def test_default_edge_budget_stays_under_the_cap(monkeypatch):
    """The default slab is 96 edges a row, at least 2^16, and never past
    the sweep cap: a graph past the cap is given up, so a larger slab
    would only be allocated to be thrown away."""
    assert distances.default_edge_budget(10) == 1 << 16
    assert distances.default_edge_budget(100_000) == 9_600_000
    assert distances.default_edge_budget(1_000_000) == 1 << 26
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "5000")
    assert distances.default_edge_budget(10) == 5000


def test_overflow_degrades_to_per_config_fits(blobs, monkeypatch):
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "64")
    res = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu").sweep(
        blobs, EPS_LIST)
    assert res.stats["degraded"] == "per_config_refit"
    assert res.stats["distance_passes"] == len(res.configs)
    _assert_parity(blobs, res, "degraded", block=128)


def test_duplicate_points_and_all_noise():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(40, 3))
    X = np.concatenate([base, base, base, rng.normal(size=(80, 3)) + 8.0])
    res = DBSCAN(eps=0.3, min_samples=5, block=64, device="cpu").sweep(
        X, [1e-4, 0.3])
    _assert_parity(X, res, "degenerate", block=64)
    assert set(np.unique(res.labels(1e-4))) == {-1}
    ref = _jax_sweep(X, [1e-4, 0.3], block=64)
    assert np.array_equal(res.labels(0.3), ref.labels(0.3))


def test_min_samples_only_sweep(blobs):
    res = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu").sweep(
        blobs, [0.4], [2, 5, 20])
    assert res.stats["distance_passes"] == 1
    _assert_parity(blobs, res, "ms-grid", block=128)
    with pytest.raises(KeyError):
        res.labels(0.4)
    with pytest.raises(KeyError):
        res.labels(0.3, 5)


def test_sweep_dbscan_functional(blobs):
    res = sweep_dbscan(blobs, [0.4], min_samples_list=[5], block=128,
                       device="cpu")
    ref_l, _ = _solo(blobs, 0.4, 5, block=128)
    assert np.array_equal(res.labels(0.4, 5), ref_l)
    assert res.model.labels_ is not None and len(res) == 1


def test_tensor_input_sweep(blobs):
    """A tensor sweeps where it lies, equal to the fits of that tensor."""
    X = torch.from_numpy(blobs)
    res = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu").sweep(
        X, EPS_LIST, [5])
    _assert_parity(X, res, "tensor", block=128)


@pytest.mark.parametrize("args,err", [
    (([],), ValueError),
    (([-0.5],), ValueError),
    (([0.5], [0]), ValueError),
    (("bogus",), ValueError),
    (("auto", [0]), ValueError),
])
def test_validation(args, err):
    m = DBSCAN(eps=0.4, min_samples=5, device="cpu")
    with pytest.raises(err):
        m.sweep(np.zeros((10, 2)), *args)


def test_validation_of_metric_ranges_and_empty_data():
    m = DBSCAN(eps=0.02, min_samples=5, metric="cosine", device="cpu")
    with pytest.raises(ValueError, match=r"\(0, 2\]"):
        m.sweep(np.ones((10, 3)), [0.01, 2.5])
    with pytest.raises(ValueError, match="non-empty"):
        DBSCAN(eps=0.4, device="cpu").sweep(np.zeros((0, 2)), [0.4])


@pytest.fixture(scope="module")
def sphere_clusters():
    rng = np.random.default_rng(7)
    c = rng.normal(size=(4, 8))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    X = np.concatenate([ci + rng.normal(scale=0.03, size=(120, 8))
                        for ci in c])
    return X * rng.uniform(0.5, 2.0, size=(len(X), 1))


def test_cosine_sweep_rides_the_graph(sphere_clusters):
    X = sphere_clusters
    kw = dict(metric="cosine", block=128)
    m = DBSCAN(eps=0.02, min_samples=5, device="cpu", **kw)
    res = m.sweep(X, [0.01, 0.05])
    assert res.stats["distance_passes"] == 1
    _assert_parity(X, res, "cosine", **kw)
    ref = _jax_sweep(X, [0.01, 0.05], **kw)
    for cfg in res.configs:
        assert np.array_equal(res.labels(*cfg), ref.labels(*cfg)), cfg
    assert m.metric == "cosine" and m.eps == 0.02


def test_haversine_and_cityblock_sweeps(blobs750):
    for metric, X, eps_list in (
            ("haversine", blobs750 * 0.1, [0.02, 0.03]),
            ("cityblock", blobs750, [0.3, 0.35])):
        kw = dict(metric=metric, block=128)
        res = DBSCAN(eps=eps_list[0], min_samples=10, device="cpu",
                     **kw).sweep(X, eps_list, [5, 10])
        assert res.stats["distance_passes"] == 1
        _assert_parity(X, res, metric, **kw)


def test_sketch_models_sweep_stays_exact():
    """A 512-D model with the sketch on: its fits run B3/B4's plain
    versions, the sweep's graph the exact d^2; the labels agree."""
    X, _t = benchdata.make_embedding_data(600, 512)
    kw = dict(block=128, sketch="auto")
    res = DBSCAN(eps=2.0, min_samples=10, device="cpu", **kw).sweep(
        X, [1.6, 2.0])
    _assert_parity(X, res, "sketch", **kw)
    m = DBSCAN(eps=2.0, min_samples=10, device="cpu", **kw).fit(X)
    assert m.metrics_["sketch_k"] == 128


def test_emission_in_many_batches(blobs, monkeypatch):
    """Batches of two tile pairs (as many as the card's batches at 1M
    points): the same graph and totals as one batch, and a sweep
    through it still equals its fits."""
    from pypardis_tpu_torch.ops import distances

    pts, n, block = _stage(blobs, 128, CPU)
    xs, mask, _owner = _pipeline_layout(pts, 0.4, n, block, sort=True)
    whole = neighbor_pair_graph(xs, mask, 0.4, tile=128)
    monkeypatch.setattr(distances, "_CHUNK_ELEMS", 4 * 2 * 128 * 128)
    parts = neighbor_pair_graph(xs, mask, 0.4, tile=128)
    assert parts[3] == whole[3]
    for a, b in zip(parts[:3], whole[:3]):
        assert torch.equal(a, b)
    res = DBSCAN(eps=0.4, min_samples=5, block=128, device="cpu").sweep(
        blobs, EPS_LIST, MS_LIST)
    assert res.stats["graph_pairs"] == whole[3][0]
    _assert_parity(blobs, res, "batched", block=128)


@pytest.mark.parametrize("metric,eps", [("euclidean", 0.4),
                                        ("cityblock", 0.6)])
def test_graph_matches_the_jax_emission(blobs, metric, eps):
    """``neighbor_pair_graph`` emits the JAX package's edge set on the
    same staged layout, with the exact totals.  The packages take d^2
    in different float32 forms (the port the axis-ordered sum of its
    kernels, the JAX package the matmul expansion), so edges may differ
    only on pairs whose float64 distance lies within 1e-5 of eps,
    relative."""
    from pypardis_tpu.ops.distances import neighbor_pair_graph_host

    pts, n, block = _stage(blobs, 128, CPU)
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    gi, gj, dv, st = neighbor_pair_graph(xs, mask, eps, metric=metric,
                                         tile=128)
    e = st[0]
    assert st[0] <= st[1] and st[2] <= st[3]
    assert torch.isinf(dv[e:]).all() and torch.isfinite(dv[:e]).all()
    ji, jj, _jd, jst = neighbor_pair_graph_host(
        xs.numpy(), mask.numpy(), eps, metric=metric, block=128,
        layout="dn")
    ours = set(zip(gi[:e].tolist(), gj[:e].tolist()))
    theirs = set(zip(ji.tolist(), jj.tolist()))
    assert len(theirs) == int(jst[0])
    x64 = xs.double().numpy()
    for i, j in ours ^ theirs:
        diff = x64[:, i] - x64[:, j]
        dist = (np.abs(diff).sum() if metric == "cityblock"
                else np.sqrt((diff * diff).sum()))
        assert abs(dist - eps) <= 1e-5 * eps, (i, j, dist)
    assert len(ours ^ theirs) <= 4
    # A slab short of the total: exact total, the first edges kept.
    gi2, _gj2, _dv2, st2 = neighbor_pair_graph(
        xs, mask, eps, metric=metric, tile=128, budget=100)
    assert st2[:2] == [e, 100] and torch.equal(gi2, gi[:100])
    # Past a cap the emission stops: the total only exceeds the cap.
    _gi3, _gj3, _dv3, st3 = neighbor_pair_graph(
        xs, mask, eps, metric=metric, tile=128, cap=100)
    assert 100 < st3[0] <= e


@pytest.mark.parametrize("metric", ["euclidean", "cityblock"])
def test_graph_relabel_matches_the_fit_and_jax(blobs, metric):
    """``graph_dbscan`` over the graph at eps_max equals
    ``dbscan_fixed_size`` at each smaller eps on the same layout, and
    the JAX package's ``graph_dbscan`` over the same edges."""
    import jax.numpy as jnp

    from pypardis_tpu.ops.labels import graph_dbscan as jax_graph_dbscan

    eps_max = 0.4 if metric == "euclidean" else 0.6
    pts, n, block = _stage(blobs, 128, CPU)
    xs, mask, _owner = _pipeline_layout(pts, eps_max, n, block, sort=True)
    gi, gj, dv, st = neighbor_pair_graph(xs, mask, eps_max, metric=metric,
                                         tile=128)
    e = st[0]
    gi, gj, dv = gi[:e].long(), gj[:e].long(), dv[:e]
    for eps in (0.6 * eps_max, eps_max):
        for ms in (3, 8):
            lab, core, passes = graph_dbscan(gi, gj, dv, mask, eps, ms,
                                             metric=metric)
            fl, fc, fst = dbscan_fixed_size(xs, eps, ms, mask, block=128,
                                            metric=metric)
            assert torch.equal(lab, fl) and torch.equal(core, fc)
            assert passes == int(fst[2])
            jl, jc, jp = jax_graph_dbscan(
                jnp.asarray(gi.int().numpy()), jnp.asarray(gj.int().numpy()),
                jnp.asarray(dv.numpy()), jnp.asarray(mask.numpy()), eps, ms,
                metric=metric)
            assert np.array_equal(np.asarray(jl), lab.numpy())
            assert np.array_equal(np.asarray(jc), core.numpy())
            assert int(jp) == passes
