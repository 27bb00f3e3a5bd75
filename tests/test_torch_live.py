"""The port's live path (``serve/live.py`` and the index's in-place
updates) on the CPU against the JAX package's ``LiveModel``.

The same fitted data and the same seeded update sequence go through the
JAX ``LiveModel`` (the fused route, ``default_mesh(1)``) and the port's
(``device="cpu"``, where B1/B2/B5 run their plain versions).  After
every step the alive points' labels, core flags and ids, the index's
host arrays, slot ids, leaf -> slab map, epoch and generation, and the
counters are byte-identical; ``predict`` is bitwise the JAX engine's in
labels and d^2, and the port's engine is bitwise its index's oracle.

The cases are ``tests/test_live.py``'s that need no mesh.  Its KD and
global-Morton fitted models and ``ReplicatedQueryEngine`` wait for the
sharded routes (ROADMAP A10-A12); the load harness for A15's second
half.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from benchdata import make_separated_blob_data
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel.mesh import default_mesh
from pypardis_tpu.serve import Compactor as JaxCompactor
from pypardis_tpu.serve import LiveModel as JaxLive
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.serve import Compactor, LiveModel

EPS, MS = 1.1, 6
INT_INF = np.iinfo(np.int32).max


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _data(n=600, dim=3, seed=0):
    X, _truth, centers = make_separated_blob_data(
        n, dim, n_centers=5, std=0.35,
        min_sep=2 * EPS + 6 * 0.35 + 1.0, spread=10.0, seed=seed,
    )
    return X, centers


def _models(X, eps=EPS, ms=MS, block=128):
    jm = JaxDBSCAN(eps=eps, min_samples=ms, mesh=default_mesh(1),
                   block=block).fit(X)
    pm = DBSCAN(eps=eps, min_samples=ms, block=block, device="cpu").fit(X)
    assert np.array_equal(jm.labels_, pm.labels_)
    assert np.array_equal(jm.core_sample_mask_, pm.core_sample_mask_)
    return jm, pm


def _pair(n=600, seed=0, **kw):
    """(JAX live, port live, X, centres) over the same fit."""
    X, centers = _data(n, seed=seed)
    jm, pm = _models(X)
    kw.setdefault("warm", False)
    return jm.live(**kw), pm.live(**kw), X, centers


def _bits(a):
    return np.asarray(a).view(np.int32)


def _same(jl, pl, delta=True):
    """Every host-side surface of the two live models byte-identical,
    and the port's device tensors equal to its host mirrors."""
    for f in ("labels", "core_mask", "ids", "points"):
        assert np.array_equal(getattr(jl, f)(), getattr(pl, f)()), f
    ji, pi = jl.index, pl.index
    assert np.array_equal(_bits(ji.coords), _bits(pi.coords))
    for f in ("labels", "blo", "bhi", "gids", "center"):
        assert np.array_equal(getattr(ji, f), getattr(pi, f)), f
    assert ji.leaf_slabs == pi.leaf_slabs
    assert (ji.epoch, ji.generation, ji.n_core, ji.deltas_since_compact) \
        == (pi.epoch, pi.generation, pi.n_core, pi.deltas_since_compact)
    assert ji.appended_slab_bytes == pi.appended_slab_bytes
    assert jl._counters == pl._counters
    assert jl._next_label == pl._next_label
    if delta:
        assert ji.delta_bytes == pi.delta_bytes
    for k in ("points", "cores", "recluster_tile_fraction", "n_leaves",
              "index_epoch", "index_generation", "batch_sizes",
              "reclusters_per_write", "appended_slab_bytes"):
        assert jl.stats[k] == pl.stats[k], k
    dev = pi.device_tensors()
    for t, a in zip(dev, (pi.coords, pi.labels, pi.blo, pi.bhi)):
        assert np.array_equal(_bits(t.numpy()), _bits(a))


def _predict_same(jl, pl, Q):
    jlab, jd = jl.engine.predict(Q, return_distance=True)
    plab, pd = pl.engine.predict(Q, return_distance=True)
    assert np.array_equal(jlab, plab)
    assert np.array_equal(_bits(np.float32(jd)), _bits(np.float32(pd)))
    t = pl.engine.submit(Q)
    pl.engine.drain()
    olabs, od2 = pl.index.oracle_predict(Q)
    assert np.array_equal(t.labels, olabs)
    assert np.array_equal(_bits(t.d2), _bits(od2))


def _both(lives, op, arg):
    """Apply one write to both live models; their results must agree."""
    out = [getattr(lv, op)(arg) for lv in lives]
    assert np.array_equal(out[0], out[1])
    return out[1]


def _refit_equivalent(live):
    refit = DBSCAN(eps=live.eps, min_samples=live.min_samples, block=128,
                   device="cpu").fit(live.points()).labels_
    assert adjusted_rand_score(refit, live.labels()) == 1.0


def test_insert_fast_path_border_and_noise():
    jl, pl, X, centers = _pair(leaves=8)
    epoch0 = pl.index.epoch
    _both((jl, pl), "insert", np.array([[40.0, 40.0, 40.0]]))
    assert pl.labels()[-1] == -1
    ids2 = _both((jl, pl), "insert",
                 (centers[0] + np.array([0.0, 0.0, EPS * 0.9]))[None])
    assert pl._labels[ids2[0]] >= 0
    if pl.stats["recluster_events"] == 0:
        assert pl.index.epoch == epoch0
    assert pl.stats["inserts"] == 2
    _same(jl, pl)
    _refit_equivalent(pl)


def test_one_insert_bridges_three_clusters():
    """Three arms around a gap; one core insert at the centre merges
    all three through the union-find stitch."""
    eps, ms = 0.9, 5
    arms = []
    for a in (0.0, 2 * np.pi / 3, 4 * np.pi / 3):
        r = np.arange(0.8, 3.01, 0.1)
        arms.append(np.stack([r * np.cos(a), r * np.sin(a)], axis=1))
    X = np.concatenate(arms)
    jm, pm = _models(X, eps=eps, ms=ms, block=64)
    labs0 = pm.labels_
    assert len(np.unique(labs0[labs0 >= 0])) == 3
    jl, pl = jm.live(leaves=4, warm=False), pm.live(leaves=4, warm=False)
    ids = _both((jl, pl), "insert", np.zeros((1, 2)))
    assert pl._core[ids[0]]
    labs = pl.labels()
    assert len(np.unique(labs[labs >= 0])) == 1
    assert pl.stats["label_remaps"] == 1
    _same(jl, pl)
    _predict_same(jl, pl, np.concatenate([X, np.zeros((1, 2))]))


def test_delete_splits_cluster():
    eps, ms = 0.6, 3
    line = np.stack([np.arange(0.0, 8.01, 0.4), np.zeros(21)], axis=1)
    jm, pm = _models(line, eps=eps, ms=ms, block=64)
    jl, pl = jm.live(leaves=4, warm=False), pm.live(leaves=4, warm=False)
    mid = int(np.argmin(np.abs(line[:, 0] - 4.0)))
    _both((jl, pl), "delete", [mid])
    labs = pl.labels()
    assert len(np.unique(labs[labs >= 0])) == 2, "the cluster must split"
    _same(jl, pl)
    _predict_same(jl, pl, pl.points())
    _refit_equivalent(pl)


def test_randomized_sequence_matches_the_jax_package():
    """Seeded inserts (interior, a new clump, noise) and deletes (cores
    included): byte-identical to the JAX live model after every step,
    refit-equivalent at the end, predict bitwise the JAX engine's."""
    jl, pl, X, centers = _pair(leaves=8)
    rng = np.random.default_rng(17)
    dim = X.shape[1]
    for step in range(12):
        kind = step % 4
        if kind == 0:
            c = centers[step % len(centers)]
            _both((jl, pl), "insert", c + rng.normal(scale=0.3,
                                                     size=(4, dim)))
        elif kind == 1:
            spot = np.full(dim, 20.0 + 3 * step)
            _both((jl, pl), "insert",
                  spot + rng.normal(scale=0.2, size=(MS + 2, dim)))
        elif kind == 2:
            _both((jl, pl), "insert", rng.uniform(-30, 30, size=(2, dim)))
        else:
            _both((jl, pl), "delete",
                  rng.choice(pl.ids(), size=6, replace=False))
        _same(jl, pl)
    _refit_equivalent(pl)
    _predict_same(jl, pl, np.concatenate([
        pl.points()[:200], rng.uniform(-25, 25, size=(100, dim))
    ]))
    assert 0.0 <= pl.stats["recluster_tile_fraction"] < 1.0


def test_index_delta_pad_absorption_then_overflow():
    """Pad slots absorb an insert (a delta far below the resident
    bytes); a leaf poured past its pads owns appended slabs, and its
    queries scan each (``route`` names slabs)."""
    jl, pl, X, centers = _pair(n=800, leaves=8, block=32, qblock=32)
    idx = pl.index
    assert idx.n_leaves > 1
    slabs0, resident = idx.n_leaves, idx.stats["index_bytes"]
    epoch0, delta0 = idx.epoch, idx.delta_bytes
    _both((jl, pl), "insert",
          centers[0] + np.full((1, X.shape[1]), 0.05))
    if idx.epoch > epoch0:
        assert 0 < idx.delta_bytes - delta0 < resident
    _same(jl, pl)
    rng = np.random.default_rng(3)
    cols = idx.coords.shape[1]
    _both((jl, pl), "insert",
          centers[1] + rng.normal(scale=0.3, size=(300, X.shape[1])))
    assert idx.coords.shape[1] > cols, "expected slab growth"
    grown = [l for l, s in idx.leaf_slabs.items() if len(s) > 1]
    assert grown and idx.n_leaves > slabs0
    assert idx.appended_slab_bytes > 0
    _same(jl, pl)
    Q = np.concatenate([pl.points()[:200],
                        rng.uniform(-20, 20, size=(50, X.shape[1]))])
    routed = {s for s, _ in idx.route(idx.prepare_queries(Q))}
    assert any(s >= slabs0 for s in routed), "appended slabs are scanned"
    assert [(s, a.tolist()) for s, a in idx.route(idx.prepare_queries(Q))] \
        == [(s, a.tolist())
            for s, a in jl.index.route(jl.index.prepare_queries(Q))]
    _predict_same(jl, pl, Q)
    _refit_equivalent(pl)


def test_delete_frees_slots_for_later_inserts():
    jl, pl, X, centers = _pair(leaves=8)
    idx = pl.index
    core_ids = pl.ids()[pl.core_mask()]
    _both((jl, pl), "delete", core_ids[:10])
    free_after = int((idx.labels == INT_INF).sum())
    cols = idx.coords.shape[1]
    _same(jl, pl)
    _both((jl, pl), "insert", centers[2] + np.random.default_rng(5).normal(
        scale=0.2, size=(5, X.shape[1])))
    assert idx.coords.shape[1] == cols, "freed pad slots must absorb"
    assert int((idx.labels == INT_INF).sum()) < free_after
    _same(jl, pl)
    _refit_equivalent(pl)


def test_stale_engine_and_live_model_raise_after_refit():
    X, _c = _data()
    m = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    engine = m.query_engine()
    live = m.live(warm=False)
    assert m._live_model is live and m.live() is live
    m.fit(X[: len(X) // 2])
    assert m._live_model is None and m._live_stats is None
    with pytest.raises(RuntimeError, match="refit"):
        engine.predict(X[:4])
    with pytest.raises(RuntimeError, match="refit"):
        live.insert(X[:1])
    assert m.query_engine().predict(X[:4]) is not None
    assert len(m.live(warm=False).insert(X[:1])) == 1
    assert len(m.insert(X[:2])) == 2 and m.delete([0]) == 1


def _mutate(lives, centers, rng, dim):
    _both(lives, "insert", centers[0] + rng.normal(scale=0.3,
                                                   size=(40, dim)))
    _both(lives, "delete", lives[1].ids()[5:15])
    _both(lives, "insert", rng.uniform(-20, 20, size=(3, dim)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_live_checkpoint_round_trip_and_cross_load(tmp_path, writer):
    """A live checkpoint written by either package loads in both: the
    restored servers answer byte-identically to the one that saved, and
    keep taking the same writes in step."""
    jl, pl, X, centers = _pair(n=500, leaves=8, block=32, qblock=32)
    rng = np.random.default_rng(9)
    dim = X.shape[1]
    _mutate((jl, pl), centers, rng, dim)
    Q = np.concatenate([pl.points()[:150],
                        rng.uniform(-15, 15, size=(80, dim))])
    before = pl.engine.predict(Q, return_distance=True)
    path = str(tmp_path / "live.npz")
    (pl if writer == "port" else jl).save(path)
    rp = LiveModel.load(path, device="cpu")
    rj = JaxLive.load(path)
    assert rp.index.epoch == pl.index.epoch == rj.index.epoch
    assert rp.compact_pending is False
    _same(rj, rp)
    after = rp.engine.predict(Q, return_distance=True)
    assert np.array_equal(before[0], after[0])
    assert np.array_equal(_bits(before[1]), _bits(after[1]))
    _predict_same(rj, rp, Q)
    _both((rj, rp), "insert",
          centers[1] + rng.normal(scale=0.2, size=(4, dim)))
    _both((rj, rp), "delete", rp.ids()[:2])
    _same(rj, rp)
    _refit_equivalent(rp)
    # A plain model checkpoint (no live state) is refused.
    plain = str(tmp_path / "plain.npz")
    DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X[:300]).save(plain)
    with pytest.raises(ValueError, match="without live state"):
        LiveModel.load(plain, device="cpu")


def test_inflight_tickets_answer_against_the_new_epoch():
    """A ticket submitted before a live update and drained after it
    answers against the updated index, and the engine reports the
    epoch."""
    jl, pl, X, centers = _pair(n=400, seed=3, leaves=8)
    Q = X[:64]
    tj, tp = jl.engine.submit(Q), pl.engine.submit(Q)
    epoch0 = pl.index.epoch
    _both((jl, pl), "insert", centers[0] + np.random.default_rng(8).normal(
        scale=0.25, size=(10, X.shape[1])))
    jl.engine.drain()
    pl.engine.drain()
    assert tp.done
    olabs, od2 = pl.index.oracle_predict(Q)
    assert np.array_equal(tp.labels, olabs)
    assert np.array_equal(_bits(tp.d2), _bits(od2))
    assert np.array_equal(tp.labels, tj.labels)
    st = pl.engine.serving_stats()
    assert st["index_epoch"] == pl.index.epoch > epoch0
    assert st["index_generation"] == 0


def test_epoch_swap_readers_old_then_new_generation():
    """Readers submitted before a compaction's swap drain against the
    old generation, readers after it against the new one: both bitwise
    their generation's oracle and the JAX engine's, none dropped."""
    jl, pl, X, centers = _pair(n=500, seed=5, leaves=8)
    rng = np.random.default_rng(11)
    spot = np.full(X.shape[1], 22.0)
    _both((jl, pl), "insert",
          spot + rng.normal(scale=0.2, size=(MS + 2, X.shape[1])))
    _both((jl, pl), "delete", pl.ids()[3:9])
    Q = np.concatenate([pl.points()[:150], spot + rng.normal(
        scale=0.2, size=(20, X.shape[1]))])
    pre = pl.index.oracle_predict(Q)
    bj, bp = jl.engine.submit(Q), pl.engine.submit(Q)
    JaxCompactor(jl).compact()
    Compactor(pl).compact()
    assert bp.done and not bp.failed
    assert np.array_equal(bp.labels, pre[0])
    assert np.array_equal(_bits(bp.d2), _bits(pre[1]))
    assert np.array_equal(bp.labels, bj.labels)
    _same(jl, pl, delta=False)
    _predict_same(jl, pl, Q)
    assert pl.engine.serving_stats()["index_generation"] == 1
    _refit_equivalent(pl)


def test_insert_validation_and_delete_unknown_id():
    X, _c = _data(n=300, seed=2)
    live = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X).live(warm=False)
    with pytest.raises(ValueError, match="2-D"):
        live.insert(np.zeros(3))
    with pytest.raises(ValueError):
        live.insert(np.zeros((2, X.shape[1] + 1)))
    bad = np.zeros((1, X.shape[1]))
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        live.insert(bad)
    with pytest.raises(KeyError, match="unknown"):
        live.delete([10 ** 9])
    ids = live.insert(np.full((1, X.shape[1]), 30.0))
    live.delete(ids)
    with pytest.raises(KeyError, match="deleted"):
        live.delete(ids)
    assert len(live.insert(np.empty((0, X.shape[1])))) == 0
    assert live.delete([]) == 0


def test_live_refuses_what_the_jax_package_refuses():
    rng = np.random.default_rng(0)
    U = rng.normal(size=(200, 3)) + 5.0
    for metric, eps in (("cosine", 0.01), ("haversine", 1e-4)):
        pts = U if metric == "cosine" else np.radians(
            rng.uniform([-10, -10], [10, 10], size=(200, 2)))
        m = DBSCAN(eps=eps, min_samples=5, metric=metric,
                   device="cpu").fit(pts)
        with pytest.raises(NotImplementedError, match=metric):
            m.live()
        jm = JaxDBSCAN(eps=eps, min_samples=5, metric=metric,
                       mesh=default_mesh(1)).fit(pts)
        with pytest.raises(NotImplementedError, match=metric):
            jm.live()
    m = DBSCAN(eps=None, min_samples=5, device="cpu").fit(U)
    with pytest.raises(TypeError, match="eps=None"):
        m.live()
    with pytest.raises(TypeError):
        JaxDBSCAN(eps=None, min_samples=5, mesh=default_mesh(1)).fit(
            U).live()


@pytest.mark.parametrize("entry", ["live", "constructor", "checkpoint"])
def test_live_refuses_a_cityblock_model(entry, tmp_path):
    """A cityblock model does not go live, by any door: the live
    verdicts, re-clusters and compaction refit are Euclidean, so its
    labels would turn into an L2 clustering at its L1 eps.  The JAX
    package lets such a model go live; its live checkpoint does not
    load into the port either."""
    X, _centers = _data(n=300, seed=6)
    pm = DBSCAN(eps=EPS, min_samples=MS, metric="cityblock", block=128,
                device="cpu").fit(X)
    with pytest.raises(NotImplementedError, match="cityblock"):
        if entry == "live":
            pm.live(warm=False)
        elif entry == "constructor":
            LiveModel(pm, warm=False)
        else:
            jm = JaxDBSCAN(eps=EPS, min_samples=MS, metric="cityblock",
                           mesh=default_mesh(1), block=128).fit(X)
            path = str(tmp_path / "live.npz")
            jm.live(warm=False).save(path)
            LiveModel.load(path, device="cpu")
    assert pm._live_model is None


def test_warm_runs_the_buckets_before_the_first_insert():
    X, centers = _data(n=500, seed=4)
    m = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    live = m.live(leaves=1)
    assert live.stats["warm_compile_ms"] > 0.0
    assert live.stats["recluster_dispatches"] == 0
    live.insert(centers[0] + np.random.default_rng(5).normal(
        scale=0.2, size=(8, X.shape[1])))
    assert live._counters["recluster_events"] >= 1
    _refit_equivalent(live)


def test_lazy_model_sync_copies_only_on_read():
    X, centers = _data(n=500, seed=6)
    m = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    live = m.live(leaves=4, warm=False)
    assert live.stats["model_syncs"] == 0
    rng = np.random.default_rng(9)
    for i in range(5):
        live.insert(centers[i % 5] + rng.normal(scale=0.2,
                                                size=(2, X.shape[1])))
    assert live.stats["model_syncs"] == 0
    assert len(m.labels_) == 510
    live._publish()
    assert live.stats["model_syncs"] == 1
    assert np.array_equal(m.labels_, live.labels())
    assert np.array_equal(m.core_sample_mask_, live.core_mask())
    assert np.array_equal(m.data, live.points())
    assert m.data.dtype == X.dtype
    assert live.stats["model_sync_bytes"] > 0
    _ = m.labels_, m.data
    live._publish()
    assert live.stats["model_syncs"] == 1
    live.delete([0])
    assert np.array_equal(m.labels_, live.labels())
    assert [k for k, _ in m.assignments()][:2] == [1, 2]
    live._publish()
    assert live.stats["model_syncs"] == 2


def test_tensor_fitted_model_goes_live_without_a_host_refit():
    """A model fitted from a tensor takes the same writes as one fitted
    from the array, byte for byte; its synced ``data`` stays a tensor."""
    X, centers = _data(n=500, seed=7)
    a = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    b = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        torch.from_numpy(X))
    la, lb = a.live(leaves=8, warm=False), b.live(leaves=8, warm=False)
    rng = np.random.default_rng(1)
    batch = centers[1] + rng.normal(scale=0.3, size=(20, X.shape[1]))
    assert np.array_equal(la.insert(batch), lb.insert(batch))
    la.delete([3, 4, 5])
    lb.delete([3, 4, 5])
    assert np.array_equal(la.labels(), lb.labels())
    assert np.array_equal(la.index.labels, lb.index.labels)
    assert isinstance(b.data, torch.Tensor) and b.data.dtype == torch.float64
    assert torch.equal(b.data, torch.from_numpy(la.points()))
