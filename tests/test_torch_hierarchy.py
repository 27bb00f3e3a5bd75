"""The port's density hierarchy (``pypardis_tpu_torch/ops/hierarchy.py``,
``DBSCAN(eps=None)``, ``min_cluster_size``, ``sweep(eps_list="auto")``
and eps=None checkpoints) against the JAX package on the same inputs,
made with numpy from a seed.

* Ops level: the same slab (from the JAX package's host graph and from
  the port's graph, padding included) goes into both packages, and
  every function is bitwise equal: the prepared state, the core
  distances and their one-shot twin, the MST and its info, the merge
  forest, the condensed clusters (births, ends, stabilities), the
  selection, the cut, the ladder and the cuts' labels; the MST weights
  also against scipy's ``minimum_spanning_tree``.
* The min-id union-find bitwise the JAX ``uf_resolve_dense``.
* End to end: an eps=None fit byte-identical to the port's own
  ``fit(eps_)``, and to the JAX eps=None fit in labels and core mask
  with ``eps_`` within 1e-5 relative (the packages' float32 d^2 differ
  in form); the auto ladder's rungs equal to fits at them; serving,
  the knobs, overflow, validation and checkpoints both ways.
"""

import ast
import os

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import pypardis_tpu.ops.hierarchy as JH
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import checkpoint as jckpt
from pypardis_tpu._native import uf_resolve_dense as jax_uf
from pypardis_tpu.ops.distances import neighbor_pair_graph_host
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import DBSCAN, load_model
from pypardis_tpu_torch.dbscan import _stage
from pypardis_tpu_torch.ops import hierarchy as PH
from pypardis_tpu_torch.ops.distances import neighbor_pair_graph
from pypardis_tpu_torch.ops.labels import graph_dbscan, uf_resolve_dense
from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module")
def blobs750m():
    """``tests/conftest.py``'s blobs750, module-scoped."""
    from sklearn.preprocessing import StandardScaler

    X, _ = make_blobs(n_samples=750, centers=[[1, 1], [-1, -1], [1, -1]],
                      cluster_std=0.4, random_state=0)
    return StandardScaler().fit_transform(X).astype(np.float64)


@pytest.fixture(scope="module")
def sphere_clusters():
    rng = np.random.default_rng(7)
    c = rng.normal(size=(4, 8))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    X = np.concatenate([ci + rng.normal(scale=0.03, size=(120, 8))
                        for ci in c])
    return X * rng.uniform(0.5, 2.0, size=(len(X), 1))


# -- ops level -------------------------------------------------------------


def _geometry(kind):
    """``(points (n, 3) float32, eps_max)`` for the ops-level cases."""
    rng = np.random.default_rng(11)
    if kind == "blobs":
        X = np.concatenate([rng.normal(c, 0.25, size=(90, 3)) for c in
                            ([0, 0, 0], [4, 0, 0], [0, 4, 0], [2, 2, 3])])
        return X.astype(np.float32), 1.2
    if kind == "duplicates":
        X = np.concatenate([np.tile([[1.0, 2.0, 3.0]], (64, 1)),
                            np.tile([[1.5, 2.0, 3.0]], (40, 1)),
                            rng.normal(9.0, 0.2, size=(60, 3))])
        return X.astype(np.float32), 1.0
    if kind == "all_noise":
        X = (np.arange(48, dtype=np.float32)[:, None] * 1000.0
             * np.ones((1, 3), np.float32))
        return X, 1.0
    X = rng.normal(0, 0.1, size=(200, 3)).astype(np.float32)  # single
    return X, 0.5


def _slab(kind, source, block=128):
    """The same slab for both packages: numpy ``(gi, gj, dv, mask)``
    from the JAX host graph (exact total) or the port's graph (with its
    +inf padding), over the points staged as the port stages them."""
    X, eps_max = _geometry(kind)
    pts, n, block = _stage(X, block, CPU)
    xs, mask, _owner = _pipeline_layout(pts, eps_max, n, block, sort=False)
    if source == "jax":
        gi, gj, dv, _st = neighbor_pair_graph_host(
            xs.numpy(), mask.numpy(), eps_max, block=block, layout="dn")
    else:
        gi, gj, dv, _st = (t.numpy() if isinstance(t, torch.Tensor) else t
                           for t in neighbor_pair_graph(xs, mask, eps_max,
                                                        tile=block))
    thr_max = float(np.float32(eps_max) ** 2)
    return (np.asarray(gi), np.asarray(gj), np.asarray(dv),
            mask.numpy(), thr_max)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(jax_val, port_val, what):
    p = port_val.numpy() if isinstance(port_val, torch.Tensor) else port_val
    j = np.asarray(jax_val)
    assert p.dtype == j.dtype, (what, p.dtype, j.dtype)
    assert np.array_equal(_bits(j), _bits(p)), what


def _no_clock(info):
    return {k: v for k, v in info.items() if not k.endswith("_s")}


def _cluster_rows(h):
    return [(c.cid, c.parent, c.birth_w, c.end_w, c.size, c.exits,
             c.children, c.stability) for c in h.clusters]


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("kind",
                         ["blobs", "duplicates", "all_noise", "single"])
def test_every_stage_bitwise_the_jax_package(kind, source):
    """Each function of the module on the same slab, at min_samples 1, 2
    and 10, bitwise the JAX package's (the host core pass and its
    one-shot twin both)."""
    import jax.numpy as jnp

    gi, gj, dv, mask, thr_max = _slab(kind, source)
    n = len(mask)
    js = JH.hierarchy_prepare(gi, gj, dv)
    ps = PH.hierarchy_prepare(torch.from_numpy(gi), torch.from_numpy(gj),
                              torch.from_numpy(dv))
    for a, b, what in zip(js, ps, ("gi_s", "gj_s", "dv_s", "starts",
                                   "uniq")):
        _same(a, b, what)
    for ms in (1, 2, 10):
        jcd = JH.core_distances(js, mask, ms)
        pcd = PH.core_distances(ps, torch.from_numpy(mask), ms)
        _same(jcd, pcd, f"cd2 ms={ms}")
        jdev = JH.core_distances_device(
            jnp.asarray(gi), jnp.asarray(gj), jnp.asarray(dv),
            jnp.asarray(mask), ms)
        pdev = PH.core_distances_device(torch.from_numpy(gi),
                                        torch.from_numpy(gj),
                                        torch.from_numpy(dv),
                                        torch.from_numpy(mask), ms)
        _same(jdev, pdev, f"twin ms={ms}")
        _same(jcd, pdev, f"twin vs host ms={ms}")
        jm = JH.mutual_reachability_mst(js, jcd, n)
        pm = PH.mutual_reachability_mst(ps, pcd, n)
        for a, b, what in zip(jm[:3], pm[:3], ("mi", "mj", "mw")):
            _same(a, b, f"{what} ms={ms}")
        assert jm[3] == pm[3], (ms, jm[3], pm[3])
        assert pm[3]["boruvka_rounds"] <= pm[3]["round_cap"]
        for a, b in zip(JH._merge_forest(*jm[:3], n)[:4],
                        PH._merge_forest(*pm[:3], n)[:4]):
            _same(a, b, f"merge forest ms={ms}")
        assert (JH._merge_forest(*jm[:3], n)[4]
                == PH._merge_forest(*pm[:3], n)[4])
        for mcs in (None, 7) if ms == 2 else (None,):
            kw = dict(kernel_metric="euclidean", user_frame="euclidean",
                      thr_max=thr_max, min_cluster_size=mcs)
            jh = JH.build_hierarchy(js, mask, n, ms, **kw)
            ph = PH.build_hierarchy(ps, torch.from_numpy(mask), n, ms, **kw)
            assert _cluster_rows(jh) == _cluster_rows(ph), (ms, mcs)
            assert jh.selected == ph.selected
            assert jh.cut_scores() == ph.cut_scores()
            assert jh.select_cut() == ph.select_cut()
            assert jh.eps_ladder(8) == ph.eps_ladder(8)
            assert _no_clock(jh.info) == _no_clock(ph.info)
            cands = jh._cut_candidates()
            for thr in list(cands[:: max(1, len(cands) // 6)]) + [
                    0.5 * thr_max, thr_max]:
                jl, jc = jh.labels_at_thr(thr)
                pl, pc = ph.labels_at_thr(thr)
                _same(jl, pl, f"labels thr={thr}")
                _same(jc, pc, f"core thr={thr}")


def test_cuts_equal_the_relabel_over_the_port_graph(blobs):
    """``labels_at_thr`` at any threshold equals ``graph_dbscan`` (the
    sweep's relabel, which equals the fit) over the same port graph."""
    X = np.asarray(blobs, np.float32)
    pts, n, block = _stage(X, 128, CPU)
    xs, mask, _owner = _pipeline_layout(pts, 1.2, n, block, sort=True)
    gi, gj, dv, st = neighbor_pair_graph(xs, mask, 1.2, tile=block)
    gi, gj, dv = gi[:st[0]].long(), gj[:st[0]].long(), dv[:st[0]]
    state = PH.hierarchy_prepare(gi, gj, dv)
    h = PH.build_hierarchy(state, mask, len(mask), 5,
                           thr_max=float(np.float32(1.2) ** 2))
    for eps in (0.2, 0.35, 0.5, 0.8, 1.1):
        lab, core = h.labels_at_thr(float(np.float32(eps) ** 2))
        ref_l, ref_c, _p = graph_dbscan(gi, gj, dv, mask, eps, 5)
        assert torch.equal(lab, ref_l) and torch.equal(core, ref_c), eps


def test_mst_weights_match_scipy_oracle():
    """Borůvka over the port's slab equals scipy's minimum spanning tree
    on the dense mutual-reachability matrix over the slab's own d^2,
    truncated at the ceiling."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    gi, gj, dv, mask, _thr = _slab("blobs", "port")
    n = int(mask.sum())
    state = PH.hierarchy_prepare(gi, gj, dv)
    cd2 = PH.core_distances(state, mask, 5)
    _mi, _mj, mw, info = PH.mutual_reachability_mst(state, cd2, len(mask))
    assert info["boruvka_rounds"] <= info["round_cap"]
    assert info["mst_edges"] == info["n_live"] - info["n_components"]
    gi_s, gj_s, dv_s = (t.numpy() for t in state[:3])
    cdn = cd2.numpy()
    live = np.isfinite(dv_s) & (gi_s != gj_s) & (gi_s < n) & (gj_s < n)
    mre = np.maximum(dv_s[live],
                     np.maximum(cdn[gi_s[live]], cdn[gj_s[live]]))
    keep = np.isfinite(mre)
    w = np.zeros((n, n), np.float64)
    w[gi_s[live][keep], gj_s[live][keep]] = mre[keep]
    oracle = minimum_spanning_tree(csr_matrix(np.triu(w)))
    ow = np.sort(np.asarray(oracle[oracle.nonzero()]).ravel())
    got = np.sort(mw.numpy().astype(np.float64))
    assert len(got) == len(ow)
    np.testing.assert_allclose(got, ow, rtol=1e-6)


# -- the union-find --------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_union_find_bitwise_the_jax_native(seed):
    """Random edge sets with self-loops and out-of-range entries (negative
    and past n): the same min-id roots as the JAX ``uf_resolve_dense``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    m = int(rng.integers(0, 3 * n))
    edges = rng.integers(-5, n + 5, size=(m, 2))
    loops = rng.integers(0, n, size=min(m, 20))
    edges[: len(loops)] = loops[:, None]
    want = jax_uf(edges, n)
    got = uf_resolve_dense(torch.from_numpy(edges), n)
    _same(want, got, f"seed {seed}")
    _same(want, uf_resolve_dense(edges, n), f"numpy seed {seed}")
    # A long chain in descending ids: many hooking passes.
    chain = np.stack([np.arange(n - 1, 0, -1), np.arange(n - 2, -1, -1)],
                     axis=1)
    _same(jax_uf(chain, n), uf_resolve_dense(chain, n), "chain")


def test_frame_maps_bitwise():
    """``thr_from_user_eps`` / ``user_eps_from_thr`` in all four frames,
    both directions, bitwise the JAX package's, and round-trip stable."""
    rng = np.random.default_rng(3)
    for frame, scale in (("euclidean", 2.0), ("cityblock", 3.0),
                         ("cosine", 0.5), ("haversine", 0.2)):
        for eps in rng.uniform(1e-4, 1.0, size=64) * scale:
            t = PH.thr_from_user_eps(eps, frame)
            assert type(t) is np.float32
            assert t.view(np.int32) == JH.thr_from_user_eps(
                eps, frame).view(np.int32), (frame, eps)
            u = PH.user_eps_from_thr(t, frame)
            assert u == JH.user_eps_from_thr(t, frame), (frame, eps)
            assert PH.thr_from_user_eps(u, frame) == t, (frame, eps)


def test_the_module_imports_neither_jax_nor_the_jax_package():
    path = os.path.join(REPO, "pypardis_tpu_torch", "ops", "hierarchy.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module or "" for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "torch" in mods
    for mod in mods:
        assert mod.split(".")[0] not in ("jax", "jaxlib", "pypardis_tpu")


# -- end to end ------------------------------------------------------------


FIXTURES = {
    "blobs": ("blobs", {}),
    "blobs750": ("blobs750m", {}),
    "sphere_clusters": ("sphere_clusters", {"metric": "cosine"}),
}


def _jax_model(**kw):
    return JaxDBSCAN(kernel_backend="xla", mesh=default_mesh(1), block=128,
                     **kw)


def _port_fit(X, **kw):
    return DBSCAN(block=128, device="cpu", **kw).fit(X)


def _jax_d2_slack(X, eps, metric):
    """Relative slack on an eps from the JAX package's float32 d^2 form
    (|x|^2 + |y|^2 - 2 x.y on the centred rows): its d^2 errs by up to
    about 4 M 2^-24 with M the largest |x|^2, so an eps by half that
    over eps^2.  Zero for cityblock and cosine (unit rows here: M <=
    1 gives under 1e-5 at these eps)."""
    if metric != "euclidean":
        return 0.0
    Xc = np.asarray(X, np.float64) - np.asarray(X, np.float64).mean(0)
    M = float((Xc * Xc).sum(1).max())
    return 2.0 * M * 2.0 ** -24 / eps ** 2


@pytest.mark.parametrize("name", list(FIXTURES))
def test_eps_none_fit_matches_its_fit_and_the_jax_fit(name, request):
    fx, kw = FIXTURES[name]
    X = request.getfixturevalue(fx)
    m = _port_fit(X, eps=None, min_samples=5, **kw)
    assert m.eps is None and m.eps_ > 0
    ref = _port_fit(X, eps=m.eps_, min_samples=5, **kw)
    assert np.array_equal(m.labels_, ref.labels_)
    assert np.array_equal(m.core_sample_mask_, ref.core_sample_mask_)
    again = _port_fit(X, eps=None, min_samples=5, **kw)
    assert again.eps_ == m.eps_
    assert np.array_equal(again.labels_, m.labels_)
    assert np.array_equal(again.core_sample_mask_, m.core_sample_mask_)
    h = m._hier_stats
    assert h["distance_passes"] == 1
    assert h["boruvka_rounds"] <= h["round_cap"]
    assert h["selected_clusters"] >= 1 and h["mst_edges"] > 0
    assert h["eps_selected"] == m.eps_
    assert 0 < m.eps_ <= h["eps_max"] * (1 + 1e-6)
    for key in ("graph_build_s", "prepare_s", "core_pass_s", "mst_s",
                "condense_s", "cut_s", "relabel_s"):
        assert h[key] >= 0, key
    j = _jax_model(eps=None, min_samples=5, **kw).fit(X)
    assert abs(m.eps_ - j.eps_) <= 1e-5 * j.eps_, (m.eps_, j.eps_)
    assert np.array_equal(m.labels_, np.asarray(j.labels_))
    assert np.array_equal(m.core_sample_mask_,
                          np.asarray(j.core_sample_mask_))
    jh = j.report()["hierarchy"]
    for key in ("mst_edges", "n_live", "n_components", "condensed_clusters",
                "selected_clusters", "min_cluster_size", "distance_passes"):
        assert h[key] == jh[key], key


@pytest.mark.parametrize("name", list(FIXTURES))
def test_auto_ladder_rungs_equal_fits_and_the_jax_ladder(name, request):
    fx, kw = FIXTURES[name]
    X = request.getfixturevalue(fx)
    res = DBSCAN(eps=None, min_samples=5, block=128, device="cpu",
                 **kw).sweep(X, "auto", [5, 10])
    st = res.stats
    assert st["distance_passes"] == 1 and st["eps_source"] == "hierarchy_auto"
    ladder = st["ladder"]
    assert ladder == sorted(ladder) and len(res) == 2 * len(ladder)
    assert {ms for _e, ms in res.configs} == {5, 10}
    assert st["hierarchy"]["ladder"] == ladder
    for eps, ms in res.configs:
        f = _port_fit(X, eps=eps, min_samples=ms, **kw)
        assert np.array_equal(res.labels(eps, ms), f.labels_), (eps, ms)
        assert np.array_equal(res.core(eps, ms), f.core_sample_mask_)
    jr = _jax_model(eps=None, min_samples=5, **kw).sweep(X, "auto", [5, 10])
    jl = jr.stats["ladder"]
    assert len(jl) == len(ladder)
    for a, b in zip(ladder, jl):
        tol = 1e-5 + _jax_d2_slack(X, b, kw.get("metric", "euclidean"))
        assert abs(a - b) <= tol * b, (a, b, tol)
        # The values carry the packages' d^2 forms; the rungs' cuts do
        # not, so each rung's labels and core mask are the JAX rung's.
        for ms in (5, 10):
            assert np.array_equal(res.labels(a, ms),
                                  np.asarray(jr.labels(b, ms))), (a, b, ms)
            assert np.array_equal(res.core(a, ms),
                                  np.asarray(jr.core(b, ms))), (a, b, ms)


def test_min_cluster_size_moves_the_selection_as_in_jax(blobs):
    small = _port_fit(blobs, eps=None, min_samples=5)
    big = _port_fit(blobs, eps=None, min_samples=5, min_cluster_size=100)
    jbig = _jax_model(eps=None, min_samples=5, min_cluster_size=100).fit(
        blobs)
    hs, hb = small._hier_stats, big._hier_stats
    assert hb["min_cluster_size"] == 100 and hs["min_cluster_size"] == 5
    assert hb["condensed_clusters"] < hs["condensed_clusters"]
    jh = jbig.report()["hierarchy"]
    assert (hb["condensed_clusters"], hb["selected_clusters"]) == (
        jh["condensed_clusters"], jh["selected_clusters"])
    assert abs(big.eps_ - jbig.eps_) <= 1e-5 * jbig.eps_
    assert np.array_equal(big.labels_, np.asarray(jbig.labels_))
    ref = _port_fit(blobs, eps=big.eps_, min_samples=5)
    assert np.array_equal(big.labels_, ref.labels_)


def test_predict_on_an_eps_none_model_is_the_jax_engines(blobs):
    """Serving runs at ``eps_``: labels and d^2 bits of the JAX
    engine's answers (its eps_ is the same bits here)."""
    rng = np.random.default_rng(4)
    Q = np.concatenate([blobs[:200] + rng.normal(0, 0.2, (200, 3)),
                        rng.uniform(-12, 12, (56, 3))])
    m = _port_fit(blobs, eps=None, min_samples=5)
    j = _jax_model(eps=None, min_samples=5).fit(blobs)
    assert m.eps_ == j.eps_ and m.kernel_eps == j.kernel_eps
    pl, pd = m.query_engine().predict(Q, return_distance=True)
    jl, jd = j.query_engine().predict(Q, return_distance=True)
    assert np.array_equal(pl, np.asarray(jl))
    assert np.array_equal(np.asarray(pd, np.float32).view(np.int32),
                          np.asarray(jd, np.float32).view(np.int32))
    assert np.array_equal(m.predict(blobs[:32]), m.labels_[:32])


def test_env_knobs_behave_as_the_jax_packages(blobs, monkeypatch):
    monkeypatch.setenv("PPTORCH_HIER_EPS_MAX", "0.9")
    monkeypatch.setenv("PYPARDIS_HIER_EPS_MAX", "0.9")
    m = _port_fit(blobs, eps=None, min_samples=5)
    assert m._hier_stats["eps_max"] == pytest.approx(0.9)
    assert m.eps_ <= 0.9 * (1 + 1e-6)
    j = _jax_model(eps=None, min_samples=5).fit(blobs)
    assert abs(m.eps_ - j.eps_) <= 1e-5 * j.eps_
    assert np.array_equal(m.labels_, np.asarray(j.labels_))
    ref = _port_fit(blobs, eps=m.eps_, min_samples=5)
    assert np.array_equal(m.labels_, ref.labels_)
    monkeypatch.delenv("PPTORCH_HIER_EPS_MAX")
    monkeypatch.delenv("PYPARDIS_HIER_EPS_MAX")
    # The sample knob moves the heuristic ceiling as in the JAX package.
    monkeypatch.setenv("PPTORCH_HIER_SAMPLE", "64")
    monkeypatch.setenv("PYPARDIS_HIER_SAMPLE", "64")
    a = DBSCAN(eps=None, min_samples=5, device="cpu")
    b = _jax_model(eps=None, min_samples=5)
    assert a._hier_ceiling(blobs) == b._hier_ceiling(blobs)
    monkeypatch.delenv("PPTORCH_HIER_SAMPLE")
    monkeypatch.delenv("PYPARDIS_HIER_SAMPLE")
    assert a._hier_ceiling(blobs) == b._hier_ceiling(blobs)
    assert a._hier_ceiling(torch.from_numpy(blobs)) == b._hier_ceiling(
        blobs)
    monkeypatch.setenv("PPTORCH_HIER_LADDER_K", "3")
    res = DBSCAN(eps=None, min_samples=5, block=128, device="cpu").sweep(
        blobs, "auto")
    assert 0 < len(res.stats["ladder"]) <= 3


def test_graph_past_the_cap_raises_the_no_refit_error(blobs, monkeypatch):
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "1000")
    with pytest.raises(RuntimeError) as err:
        _port_fit(blobs, eps=None, min_samples=5)
    assert "PPTORCH_SWEEP_MAX_PAIRS" in str(err.value)
    assert "PPTORCH_HIER_EPS_MAX" in str(err.value)
    with pytest.raises(RuntimeError, match="no eps to refit at"):
        DBSCAN(eps=None, min_samples=5, block=128, device="cpu").sweep(
            blobs, "auto")


def test_validation_raises_as_in_jax(monkeypatch):
    for kw in ({"eps": 0.0}, {"eps": -1.0}, {"eps": float("nan")},
               {"eps": float("inf")}, {"eps": None, "min_cluster_size": 1},
               {"eps": None, "min_samples": 0}):
        with pytest.raises(ValueError):
            DBSCAN(device="cpu", **kw)
        with pytest.raises(ValueError):
            JaxDBSCAN(**kw)
    m = DBSCAN(eps=None, device="cpu")
    with pytest.raises(RuntimeError, match="eps=None"):
        _ = m.kernel_eps
    with pytest.raises(ValueError, match="non-empty"):
        m.fit(np.zeros((0, 3)))
    with pytest.raises(ValueError, match="NaN"):
        m.fit(np.full((8, 3), np.nan))
    with pytest.raises(ValueError):
        m.sweep(np.ones((8, 3)), "all")
    from pypardis_tpu_torch.utils.validate import validate_params

    with pytest.raises(ValueError):
        validate_params(None, 5)
    validate_params(None, 5, allow_none_eps=True)
    monkeypatch.setenv("PPTORCH_HIER_EPS_MAX", "-1")
    with pytest.raises(ValueError):
        m.fit(np.ones((8, 3)))


@pytest.mark.parametrize("metric,scale", [("haversine", 0.1),
                                          ("cityblock", 1.0)])
def test_driver_and_l1_frames(blobs750m, metric, scale):
    X = blobs750m * scale
    m = _port_fit(X, eps=None, min_samples=10, metric=metric)
    ref = _port_fit(X, eps=m.eps_, min_samples=10, metric=metric)
    assert np.array_equal(m.labels_, ref.labels_)
    assert np.array_equal(m.core_sample_mask_, ref.core_sample_mask_)
    assert m.metric == metric and m.eps is None
    j = _jax_model(eps=None, min_samples=10, metric=metric).fit(X)
    assert abs(m.eps_ - j.eps_) <= 1e-5 * j.eps_
    assert np.array_equal(m.labels_, np.asarray(j.labels_))


@pytest.mark.parametrize("precision", ["mixed", "default"])
def test_precision_modes_run_the_graph(blobs750m, precision):
    """Every mode takes the graph (the JAX package's hierarchy has no
    refit route): its exact d^2 gives the "high" hierarchy."""
    m = _port_fit(blobs750m, eps=None, min_samples=10, precision=precision)
    h = _port_fit(blobs750m, eps=None, min_samples=10)
    assert m.eps_ == h.eps_ and np.array_equal(m.labels_, h.labels_)
    assert m._hier_stats["distance_passes"] == 1


# -- checkpoints -------------------------------------------------------------


def test_eps_none_checkpoints_cross_load(tmp_path, blobs):
    port = _port_fit(blobs, eps=None, min_samples=5)
    jax_m = _jax_model(eps=None, min_samples=5).fit(blobs)
    port.save(str(tmp_path / "p.npz"))
    jckpt.save_model(jax_m, str(tmp_path / "j.npz"))
    for path in ("p.npz", "j.npz"):
        mine = load_model(str(tmp_path / path), device="cpu")
        theirs = jckpt.load_model(str(tmp_path / path))
        assert mine.eps is None and theirs.eps is None
        assert np.array_equal(mine.labels_, np.asarray(theirs.labels_))
        assert np.array_equal(mine.labels_, port.labels_)
        assert mine.assignments() == [tuple(r) for r in theirs.assignments()]
        # Neither package stores eps_: a loaded eps=None model has no
        # eps to serve at, and predict raises in both.
        assert mine.eps_ is None and theirs.eps_ is None
        with pytest.raises(RuntimeError):
            mine.predict(blobs[:4])
        with pytest.raises(RuntimeError):
            theirs.predict(blobs[:4])
