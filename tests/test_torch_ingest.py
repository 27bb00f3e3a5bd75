"""The port's streaming ingest (``serve/ingest.py``: ``IngestQueue`` and
``Compactor``) on the CPU against the JAX package's.

The same fit and the same write stream go through both packages (the
JAX side on the fused route, ``default_mesh(1)``; the port's on
``device="cpu"``).  After each step the live state, the index's host
arrays, epoch and generation and the counters are byte-identical, and
``predict`` is bitwise the JAX engine's.  The cases are
``tests/test_ingest.py``'s that need no mesh; its fault-injection cases
are in ``tests/test_torch_faults.py`` and the compaction's
checkpoint-resume in ``tests/test_torch_jobstate.py``; sharded refits
wait for A10-A12.
"""

import threading

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from benchdata import make_separated_blob_data
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel.mesh import default_mesh
from pypardis_tpu.serve import Compactor as JaxCompactor
from pypardis_tpu.serve import IngestQueue as JaxQueue
from pypardis_tpu.serve import LiveModel as JaxLive
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.serve import (
    Compactor,
    IngestQueue,
    LiveModel,
    QueueFull,
)

EPS, MS = 1.1, 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _pair(n=600, seed=0, **kw):
    X, _truth, centers = make_separated_blob_data(
        n, 3, n_centers=5, std=0.35,
        min_sep=2 * EPS + 6 * 0.35 + 1.0, spread=10.0, seed=seed,
    )
    jm = JaxDBSCAN(eps=EPS, min_samples=MS, mesh=default_mesh(1),
                   block=128).fit(X)
    pm = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    kw.setdefault("warm", False)
    return jm.live(**kw), pm.live(**kw), X, centers


def _same(jl, pl, delta=True):
    for f in ("labels", "core_mask", "ids", "points"):
        assert np.array_equal(getattr(jl, f)(), getattr(pl, f)()), f
    ji, pi = jl.index, pl.index
    assert np.array_equal(ji.coords.view(np.int32), pi.coords.view(np.int32))
    for f in ("labels", "blo", "bhi", "gids", "center"):
        assert np.array_equal(getattr(ji, f), getattr(pi, f)), f
    assert ji.leaf_slabs == pi.leaf_slabs
    assert (ji.epoch, ji.generation, ji.deltas_since_compact,
            ji.appended_slab_bytes) == (pi.epoch, pi.generation,
                                        pi.deltas_since_compact,
                                        pi.appended_slab_bytes)
    assert jl._counters == pl._counters
    if delta:
        assert ji.delta_bytes == pi.delta_bytes
    for k in ("batch_sizes", "reclusters_per_write", "epoch_swaps",
              "compactions", "index_generation", "appended_slab_bytes"):
        assert jl.stats[k] == pl.stats[k], k


def _both(lives, op, arg):
    out = [getattr(lv, op)(arg) for lv in lives]
    assert np.array_equal(out[0], out[1])
    return out[1]


def _predict_same(jl, pl, Q):
    a = jl.engine.predict(Q, return_distance=True)
    b = pl.engine.predict(Q, return_distance=True)
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(np.float32(a[1]).view(np.int32),
                          np.float32(b[1]).view(np.int32))
    t = pl.engine.submit(Q)
    pl.engine.drain()
    olabs, od2 = pl.index.oracle_predict(Q)
    assert np.array_equal(t.labels, olabs) and np.array_equal(t.d2, od2)


def _refit_equivalent(live):
    refit = DBSCAN(eps=live.eps, min_samples=live.min_samples, block=128,
                   device="cpu").fit(live.points()).labels_
    assert adjusted_rand_score(refit, live.labels()) == 1.0


def test_insert_batch_one_dispatch_one_delta():
    jl, pl, X, centers = _pair(leaves=8)
    rng = np.random.default_rng(1)
    B = 64
    batch = (centers[rng.integers(0, len(centers), B)]
             + rng.normal(scale=0.25, size=(B, X.shape[1])))
    d0, e0 = pl.stats["recluster_dispatches"], pl.index.epoch
    ids = _both((jl, pl), "insert_batch", batch)
    assert len(ids) == B
    assert pl.stats["recluster_dispatches"] - d0 == 1
    assert pl.index.epoch - e0 == 1, "one index delta per batch"
    assert pl.stats["batch_sizes"][-1] == B
    assert pl.stats["reclusters_per_write"] < 0.05
    _same(jl, pl)
    _refit_equivalent(pl)
    d0, e0 = pl.stats["recluster_dispatches"], pl.index.epoch
    core_ids = ids[pl._core[ids]]
    assert len(core_ids) > 2
    _both((jl, pl), "delete_batch", core_ids[:16])
    assert pl.stats["recluster_dispatches"] - d0 == 1
    assert pl.index.epoch - e0 == 1
    _same(jl, pl)
    _refit_equivalent(pl)


def test_ingest_queue_coalesces_in_order():
    jl, pl, X, centers = _pair(leaves=8)
    rng = np.random.default_rng(2)
    qs = [JaxQueue(jl, max_batch_rows=256), IngestQueue(pl, max_batch_rows=256)]
    writes = [
        ("insert", centers[0] + rng.normal(scale=0.2, size=(3, 3))),
        ("insert", centers[1] + rng.normal(scale=0.2, size=(4, 3))),
        ("delete", pl.ids()[:2]),
        ("insert", centers[2] + rng.normal(scale=0.2, size=(2, 3))),
    ]
    tickets = [[getattr(q, f"submit_{k}")(a) for k, a in writes] for q in qs]
    resolved = [q.flush() for q in qs]
    # 4 submits, 3 batches: [3 + 4 inserts], [2 deletes], [2 inserts].
    assert qs[1].stats()["batches"] == 3 == qs[0].stats()["batches"]
    assert all(t.done and not t.failed for t in tickets[1])
    assert len(resolved[1]) == 4
    for tj, tp in zip(*tickets):
        assert np.array_equal(tj.result(), tp.result())
    t1, t2 = tickets[1][:2]
    assert len(t1.ids) == 3 and len(t2.ids) == 4
    assert set(t1.ids).isdisjoint(t2.ids)
    _same(jl, pl)
    _refit_equivalent(pl)
    st = qs[1].stats()
    for k in ("rows", "pending_rows", "shed", "failed_batches",
              "mean_batch_rows"):
        assert st[k] == qs[0].stats()[k], k
    assert st["write_p99_ms"] >= st["write_p50_ms"] > 0
    assert qs[1].flush() == []


def test_ingest_queue_backpressure_and_failure_isolation():
    """QueueFull past max_pending_rows; a batch that fails (a delete of
    an unknown id, found at the flush) fails its own tickets only,
    leaves the model untouched, and the flush goes on."""
    X, _truth, centers = make_separated_blob_data(
        400, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=1)
    live = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X).live(leaves=4, warm=False)
    q = IngestQueue(live, max_pending_rows=8)
    q.submit_insert(np.full((6, 3), 20.0))
    with pytest.raises(QueueFull):
        q.submit_insert(np.full((6, 3), 21.0))
    assert q.stats()["shed"] == 1
    q.flush()
    pts0 = live.points()
    bad = q.submit_delete([10 ** 9])
    good = q.submit_insert(centers[0] + np.full((2, 3), 0.1))
    resolved = q.flush()
    assert len(resolved) == 2
    assert bad.failed and isinstance(bad.error, KeyError)
    with pytest.raises(KeyError):
        bad.result()
    assert good.done and not good.failed and len(good.result()) == 2
    assert q.stats()["failed_batches"] == 1
    assert np.array_equal(live.points()[:len(pts0)], pts0)
    assert q.stats()["pending_rows"] == 0
    _refit_equivalent(live)


def test_compaction_swap_correctness():
    jl, pl, X, centers = _pair(n=700, leaves=8, block=32, qblock=32)
    rng = np.random.default_rng(3)
    _both((jl, pl), "insert_batch",
          centers[1] + rng.normal(scale=0.3, size=(250, X.shape[1])))
    _both((jl, pl), "delete_batch", pl.ids()[10:30])
    assert pl.index.appended_slab_bytes > 0
    assert pl.index.deltas_since_compact >= 2
    _same(jl, pl)
    Q = np.concatenate([pl.points()[:150],
                        rng.uniform(-15, 15, size=(60, X.shape[1]))])
    pre = pl.index.oracle_predict(Q)
    inflight = pl.engine.submit(Q)
    jl.engine.submit(Q)
    epoch0, gen0 = pl.index.epoch, pl.index.generation
    jstats = JaxCompactor(jl).compact()
    comp = Compactor(pl)
    stats = comp.compact()
    assert stats["compactions"] == 1
    for k in ("replayed_inserts", "replayed_deletes"):
        assert stats[k] == jstats[k]
    assert set(comp.phase_s) == set(Compactor.PHASES)
    assert inflight.done and not inflight.failed
    assert np.array_equal(inflight.labels, pre[0])
    assert np.array_equal(inflight.d2, pre[1])
    assert pl.index.generation == gen0 + 1
    assert pl.index.epoch == epoch0 + 1
    assert pl.index.appended_slab_bytes == 0
    assert pl.index.deltas_since_compact == 0
    assert all(len(s) == 1 for s in pl.index.leaf_slabs.values())
    assert pl.stats["epoch_swaps"] == 1 and pl.stats["compactions"] == 1
    assert pl.stats["compaction_s"] > 0
    _same(jl, pl, delta=False)
    _predict_same(jl, pl, Q)
    _refit_equivalent(pl)
    _both((jl, pl), "insert_batch",
          centers[0] + rng.normal(scale=0.2, size=(5, X.shape[1])))
    _same(jl, pl, delta=False)
    _refit_equivalent(pl)


def test_writes_during_compaction_are_replayed():
    """Writes that land between the snapshot and the swap (scheduled by
    the phase hook) are replayed into the new generation."""
    jl, pl, X, centers = _pair(n=600, seed=2, leaves=8)
    rng = np.random.default_rng(4)
    spot = np.full(X.shape[1], 25.0)
    clump = spot + rng.normal(scale=0.2, size=(MS + 2, X.shape[1]))
    mid = {}

    def hook_for(live, key):
        def hook(phase):
            if phase == "build":
                mid[key] = live.insert(clump)
                live.delete(live.ids()[5:12])
        return hook

    jstats = JaxCompactor(jl, phase_hook=hook_for(jl, "jax")).compact()
    stats = Compactor(pl, phase_hook=hook_for(pl, "port")).compact()
    assert stats["replayed_inserts"] == MS + 2 == jstats["replayed_inserts"]
    assert stats["replayed_deletes"] == 7 == jstats["replayed_deletes"]
    assert np.array_equal(mid["jax"], mid["port"])
    labs = pl._labels[mid["port"]]
    assert (labs >= 0).all() and len(np.unique(labs)) == 1
    _same(jl, pl, delta=False)
    _refit_equivalent(pl)
    _predict_same(jl, pl, pl.points())


def test_compaction_trigger_watermarks(monkeypatch):
    X, _truth, centers = make_separated_blob_data(
        500, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=3)
    live = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X).live(leaves=8, warm=False)
    rng = np.random.default_rng(5)
    comp = Compactor(live, max_deltas=2, slab_bytes=1 << 40)
    assert not comp.should_compact() and not comp.maybe_compact()
    for i in range(2):
        live.insert_batch(centers[i] + rng.normal(scale=0.25, size=(8, 3)))
    assert live.index.deltas_since_compact >= 2
    assert comp.should_compact()
    comp.compact()
    assert not comp.should_compact(), "the swap resets the watermarks"
    monkeypatch.setenv("PPTORCH_COMPACT_DELTAS", "7")
    monkeypatch.setenv("PPTORCH_COMPACT_SLAB_BYTES", "12345")
    c2 = Compactor(live)
    assert c2.max_deltas == 7 and c2.slab_bytes == 12345
    monkeypatch.setenv("PPTORCH_COMPACT_DELTAS", "not-a-number")
    assert Compactor(live).max_deltas == 512


def test_background_compaction_and_unported_options():
    X, _truth, centers = make_separated_blob_data(
        400, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=4)
    live = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X).live(leaves=4, warm=False)
    live.insert_batch(centers[0] + np.full((4, 3), 0.1))
    comp = Compactor(live, max_deltas=1)
    assert comp.maybe_compact()
    comp.join(timeout=120)
    assert not comp.running and comp.stats["compactions"] == 1
    assert live.index.generation == 1
    _refit_equivalent(live)
    # ckpt= is ported (checkpoint-resumable refits): accepted.
    assert Compactor(live, ckpt="job.npz").ckpt == "job.npz"
    for kw in ({"mode": "global_morton"}, {"mesh": None}):
        with pytest.raises(NotImplementedError, match="A10-A12"):
            Compactor(live, fit_kw=kw)

    def boom(_snap):
        raise RuntimeError("refit failed")

    bad = Compactor(live)
    bad._refit = boom
    bad.start()
    with pytest.raises(RuntimeError, match="refit failed"):
        bad.join(timeout=120)
    assert live.index.generation == 1 and not live._compact_active


def test_writer_thread_and_background_compaction_share_the_lock():
    """A writer thread holding the compactor's lock per write and a
    background compaction: every write lands once, the generation swaps
    once, and the live model ends refit-equivalent."""
    X, _truth, centers = make_separated_blob_data(
        400, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=5)
    live = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X).live(leaves=4, warm=False)
    comp = Compactor(live)
    rng = np.random.default_rng(6)
    batches = [centers[i % 5] + rng.normal(scale=0.2, size=(3, 3))
               for i in range(12)]
    written = []

    def writer():
        for b in batches:
            with comp.lock:
                written.append(live.insert_batch(b))

    t = threading.Thread(target=writer)
    comp.start()
    t.start()
    t.join(timeout=120)
    comp.join(timeout=120)
    assert not t.is_alive() and not comp.running
    assert len(written) == 12 and live.stats["inserts"] == 36
    assert live.index.generation == 1
    assert len(live.ids()) == 400 + 36
    _refit_equivalent(live)


def test_compaction_publishes_under_the_harness_lock():
    """Every republish of the live stats during a compaction runs under
    the lock the harness's writers take: a publish outside it reads the
    point arrays while a writer extends them (ROADMAP C7).  Recorded
    without racing threads: each ``_publish`` call notes whether the
    lock was held."""
    X, _truth, _centers = make_separated_blob_data(
        300, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=8)
    live = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(
        X).live(leaves=4, warm=False)
    lock = threading.Lock()
    comp = Compactor(live, lock=lock)
    held = []
    publish = live._publish

    def noting():
        held.append(lock.locked())
        publish()

    live._publish = noting
    comp.compact()
    assert held and all(held), held
    assert live.stats["compactions"] == 1


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mid_compaction_save_load_keeps_the_serving_generation(
        tmp_path, writer):
    """A checkpoint written mid-compaction (by either package) restores
    the pre-swap generation byte for byte, flags ``compact_pending``,
    and a compaction of the restored model completes in both."""
    jl, pl, X, centers = _pair(n=500, seed=5, leaves=8)
    rng = np.random.default_rng(6)
    _both((jl, pl), "insert_batch",
          centers[0] + rng.normal(scale=0.25, size=(30, 3)))
    path = str(tmp_path / "mid.npz")
    pre_epoch = pl.index.epoch
    pre_coords, pre_labels = pl.index.coords.copy(), pl.index.labels.copy()
    saver = pl if writer == "port" else jl

    def hook(phase):
        if phase == "build":
            saver.save(path)

    (Compactor if writer == "port" else JaxCompactor)(
        saver, phase_hook=hook).compact()
    assert saver.index.epoch == pre_epoch + 1
    rp, rj = LiveModel.load(path, device="cpu"), JaxLive.load(path)
    assert rp.compact_pending is True is rj.compact_pending
    assert rp.index.epoch == pre_epoch and rp.index.generation == 0
    assert np.array_equal(rp.index.coords, pre_coords)
    assert np.array_equal(rp.index.labels, pre_labels)
    _same(rj, rp)
    _predict_same(rj, rp, rp.points()[:100])
    JaxCompactor(rj).compact()
    Compactor(rp).compact()
    _same(rj, rp, delta=False)
    _refit_equivalent(rp)
    path2 = str(tmp_path / "clean.npz")
    rp.save(path2)
    assert LiveModel.load(path2, device="cpu").compact_pending is False
