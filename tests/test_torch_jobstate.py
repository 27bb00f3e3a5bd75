"""The port's checkpoint-resumable fits (``utils/jobstate.py``,
``DBSCAN.train(resume=)``, ``sharded_dbscan(jobstate=)``,
``Compactor(ckpt=)``) on the CPU, held against the JAX package.

A fit killed mid-run (an injected terminal fault in process, or a
SIGKILL of a child process) resumes to labels byte-identical to the
JAX package's uninterrupted fit, replaying only the unfinished batches
or partitions.  ``fit_meta`` gives both packages the same dict, and a
jobstate file written by either opens in the other with equal payloads.
Counterparts of ``tests/test_jobstate.py``'s cases that need no
global-Morton route (ROADMAP A12 brings ``gm_note``'s caller)."""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from benchdata import make_separated_blob_data
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu.parallel import sharded_dbscan as jax_sharded_dbscan
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu.serve import Compactor as JaxCompactor
from pypardis_tpu.utils import jobstate as jax_jobstate
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import sharded_dbscan
from pypardis_tpu_torch.parallel import staging as port_staging
from pypardis_tpu_torch.partition import KDPartitioner
from pypardis_tpu_torch.serve import Compactor
from pypardis_tpu_torch.utils import faults
from pypardis_tpu_torch.utils.faults import FaultInjected
from pypardis_tpu_torch.utils.jobstate import JobState, fit_meta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(eps=0.45, min_samples=5, block=64)
# The stepped route's fits: tests/test_dispatch.py's blobs.
SKW = dict(eps=0.6, min_samples=6, block=256)


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
    faults.clear()
    staging.clear()
    port_staging.clear()
    yield
    faults.clear()
    staging.clear()
    port_staging.clear()


@pytest.fixture(scope="module")
def blob_data():
    X, _ = make_blobs(n_samples=4000, centers=10, n_features=3,
                      cluster_std=0.3, random_state=5)
    return X.astype(np.float32)


def _stepped_blobs():
    X, _ = make_blobs(n_samples=2048, centers=10, n_features=8,
                      cluster_std=0.3, random_state=7)
    return X.astype(np.float32)


@pytest.fixture(scope="module")
def stepped_ref():
    """The data and the JAX package's uninterrupted fused fit (XLA)."""
    X = _stepped_blobs()
    ref = JaxDBSCAN(**SKW, kernel_backend="xla",
                    mesh=default_mesh(1)).fit(X)
    return X, ref


def _step_env(monkeypatch, batch=1):
    monkeypatch.setenv("PPTORCH_STEP_THRESHOLD", "1")
    monkeypatch.setenv("PPTORCH_ROUND_BATCH", str(batch))


# -- the stepped route ------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3])
def test_stepped_resume_byte_identical(stepped_ref, tmp_path, monkeypatch,
                                       k):
    """Die at round batch k (one round each), resume from the snapshot
    of batch k-1: labels and core bytes of the JAX uninterrupted fit."""
    X, ref = stepped_ref
    _step_env(monkeypatch)
    path = str(tmp_path / "stepped.ckpt")
    with faults.plan(f"stepped.batch:{k}=error"):
        with pytest.raises(FaultInjected):
            DBSCAN(**SKW, device="cpu").train(X, resume=path)
    assert os.path.exists(path + ".npz")
    m = DBSCAN(**SKW, device="cpu").train(X, resume=path)
    assert m.labels_.tobytes() == ref.labels_.tobytes()
    assert m.core_sample_mask_.tobytes() == ref.core_sample_mask_.tobytes()
    assert m._jobstate.restored_rounds == k - 1
    r = m.report()
    assert r["metrics"]["counters"]["events.jobstate_restore"] == 1
    st = r["stepped"]
    # The resumed fit runs only the batches after the snapshot.
    clean = DBSCAN(**SKW, device="cpu").fit(X).report()["stepped"]
    assert st["batches"] == clean["batches"] - (k - 1)


def test_resume_rejects_mismatched_fit(stepped_ref, blob_data, tmp_path,
                                       monkeypatch):
    X, _ref = stepped_ref
    _step_env(monkeypatch)
    path = str(tmp_path / "mismatch.ckpt")
    with faults.plan("stepped.batch:2=error"):
        with pytest.raises(FaultInjected):
            DBSCAN(**SKW, device="cpu").train(X, resume=path)
    with pytest.raises(ValueError, match="different fit"):
        DBSCAN(**SKW, device="cpu").train(blob_data, resume=path)
    with pytest.raises(ValueError, match="different fit"):
        DBSCAN(eps=0.61, min_samples=6, block=256,
               device="cpu").train(X, resume=path)


def test_resume_on_eps_none_raises():
    with pytest.raises(ValueError, match="hierarchy"):
        DBSCAN(eps=None, device="cpu").train(np.zeros((10, 2)),
                                             resume="x.npz")


def test_ckpt_env_writes_and_cosine_resumes(tmp_path, monkeypatch):
    """``PPTORCH_CKPT`` writes snapshots for a fit without ``resume``;
    a cosine fit resumes through its Euclidean frame."""
    X = _stepped_blobs() + 3.0
    kw = dict(eps=0.002, min_samples=6, block=256, metric="cosine",
              device="cpu")
    clean = DBSCAN(**kw).fit(X)
    assert clean.labels_.max() >= 1
    _step_env(monkeypatch)
    path = str(tmp_path / "env.ckpt.npz")
    monkeypatch.setenv("PPTORCH_CKPT", path)
    with faults.plan("stepped.batch:2=error"):
        with pytest.raises(FaultInjected):
            DBSCAN(**kw).fit(X)
    assert os.path.exists(path)
    monkeypatch.delenv("PPTORCH_CKPT")
    m = DBSCAN(**kw).train(X, resume=path)
    assert m._jobstate.restored_rounds == 1
    assert m.labels_.tobytes() == clean.labels_.tobytes()


_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from pypardis_tpu_torch import DBSCAN
X = np.load({data!r})
DBSCAN(eps=0.6, min_samples=6, block=256, device="cpu").fit(X)
print("finished", flush=True)
"""


def test_sigkill_mid_fit_resumes_byte_identical(stepped_ref, tmp_path,
                                                monkeypatch):
    """A child process (the port alone) runs the stepped fit with
    ``PPTORCH_CKPT`` and a 0.5 s hang before each batch; once its
    snapshot exists the parent SIGKILLs it and resumes in process."""
    X, ref = stepped_ref
    path = str(tmp_path / "kill.ckpt.npz")
    script = tmp_path / "child.py"
    # The data goes through a file: importing sklearn would cost the
    # child seconds.
    data = str(tmp_path / "x.npy")
    np.save(data, X)
    script.write_text(_CHILD.format(repo=REPO, data=data))
    env = dict(os.environ, PPTORCH_CKPT=path, PPTORCH_STEP_THRESHOLD="1",
               PPTORCH_ROUND_BATCH="1",
               PPTORCH_FAULTS="stepped.batch:*=hang(0.5)")
    killed = False
    for _attempt in range(3):
        if os.path.exists(path):
            os.unlink(path)
        child = subprocess.Popen([sys.executable, str(script)], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL)
        try:
            t0 = time.monotonic()
            while (not os.path.exists(path) and child.poll() is None
                   and time.monotonic() - t0 < 120):
                time.sleep(0.01)
            if child.poll() is None:
                child.send_signal(signal.SIGKILL)
                killed = child.wait(timeout=30) == -signal.SIGKILL
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
            child.stdout.close()
        if killed:
            break
    assert killed and os.path.exists(path)
    _step_env(monkeypatch)
    m = DBSCAN(**SKW, device="cpu").train(X, resume=path)
    assert m._jobstate.restored_rounds >= 1
    assert m.labels_.tobytes() == ref.labels_.tobytes()
    assert m.core_sample_mask_.tobytes() == ref.core_sample_mask_.tobytes()


# -- the chained route ------------------------------------------------------


def test_chained_resume_byte_identical(blob_data, tmp_path):
    """Kill the chained route at partition 5 (a terminal injected
    error), resume from the snapshot: partitions 0-3 replay from the
    file, none of them built, and labels equal the JAX route's (under
    its host merge, byte-identical to its device merge and seconds
    cheaper on the CPU)."""
    X = blob_data
    jl, jc, _js = jax_sharded_dbscan(X, JaxKD(X, max_partitions=8),
                                     mesh=default_mesh(1), backend="xla",
                                     merge="host", **KW)
    path = str(tmp_path / "chained.ckpt.npz")
    meta = fit_meta(X, eps=KW["eps"], min_samples=KW["min_samples"],
                    metric="euclidean", block=KW["block"], mode="kd")
    part = KDPartitioner(X, max_partitions=8)
    js = JobState.open(path, meta)
    with faults.plan("chained.partition:5=error"):
        with pytest.raises(FaultInjected):
            sharded_dbscan(X, part, jobstate=js, device="cpu", **KW)
    from pypardis_tpu_torch.parallel import sharded

    built = []
    orig = sharded._partition_slab
    sharded._partition_slab = (
        lambda pts, msk, gid, points, layout, p:
        built.append(p) or orig(pts, msk, gid, points, layout, p))
    try:
        js2 = JobState.open(path, meta, resume=True)
        from pypardis_tpu_torch import obs

        rec = obs.RunRecorder()
        with obs.use_recorder(rec):
            lab, core, _s = sharded_dbscan(X, part, jobstate=js2,
                                           device="cpu", **KW)
    finally:
        sharded._partition_slab = orig
    assert js2.restored_partitions == 4
    assert sorted(built) == list(range(4, 8))
    assert rec.event_counts()["jobstate_restore"] == 1
    np.testing.assert_array_equal(lab, jl)
    np.testing.assert_array_equal(core, jc)


def test_budget_mismatch_invalidates_snapshot(tmp_path):
    js = JobState(str(tmp_path / "b.npz"), {"schema": "x"})
    js.chained_note(0, np.zeros(8, np.int32), np.zeros(8, bool),
                    np.zeros(5, np.int64), budget=0)
    assert set(js.chained_restore(0)) == {0}
    assert js.chained_restore(4096) == {}
    js.chained_note(1, np.zeros(8, np.int32), np.zeros(8, bool),
                    np.zeros(5, np.int64), budget=4096)
    assert set(js.chained_restore(4096)) == {1}
    assert js.chained_restore(0) == {}


def test_jobstate_atomic_roundtrip(tmp_path):
    path = str(tmp_path / "rt.npz")
    meta = {"schema": "pypardis_tpu/jobstate@1", "eps": 0.5}
    js = JobState.open(path, meta)
    js.gm_note(np.arange(17, dtype=np.int32), 3, budget=0)
    js.stepped_note(np.arange(32, dtype=np.int32), 2, budget=64)
    js.flush(force=True)
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    js2 = JobState.open(path, meta, resume=True)
    lab, rounds = js2.gm_restore(0, 17)
    np.testing.assert_array_equal(lab, np.arange(17, dtype=np.int32))
    assert rounds == 3
    f, batches = js2.stepped_restore(64, 32)
    np.testing.assert_array_equal(f, np.arange(32, dtype=np.int32))
    assert batches == 2
    assert js2.gm_restore(0, 18) is None
    assert js2.stepped_restore(0, 32) is None


def test_cadence_gates_the_writes(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTORCH_CKPT_EVERY_S", "3600")
    js = JobState(str(tmp_path / "c.npz"), {"schema": "x"})
    assert js.every_s == 3600.0 and js.due()
    js.stepped_note(np.arange(4, dtype=np.int32), 1, budget=0)
    assert not js.due()
    js.stepped_note(np.arange(4, dtype=np.int32) + 1, 2, budget=0)
    js2 = JobState.open(js.path, {"schema": "x"}, resume=True)
    assert js2.stepped_restore(0, 4)[1] == 1  # the second write waited
    js.flush(force=True)
    js3 = JobState.open(js.path, {"schema": "x"}, resume=True)
    assert js3.stepped_restore(0, 4)[1] == 2


def test_first_snapshot_is_due_whatever_the_uptime(tmp_path, monkeypatch):
    """``time.monotonic()`` counts from the host's boot: on a host up for
    less than the cadence, a file never written must still be due, and
    the first note must reach the disk."""
    from pypardis_tpu_torch.utils import jobstate as jobstate_mod

    clock = [5.0]
    monkeypatch.setattr(jobstate_mod.time, "monotonic", lambda: clock[0])
    js = JobState(str(tmp_path / "u.npz"), {"schema": "x"}, every_s=3600)
    assert js.due()
    js.chained_note(0, np.arange(4, dtype=np.int32), np.ones(4, bool),
                    np.arange(5, dtype=np.int64), budget=0)
    assert os.path.exists(js.path)
    js2 = JobState.open(js.path, {"schema": "x"}, resume=True)
    assert sorted(js2.chained_restore(0)) == [0]
    # After the first write the cadence gates as before.
    clock[0] = 5.0 + 3599.0
    assert not js.due()
    clock[0] = 5.0 + 3600.0
    assert js.due()


# -- the file format --------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fit_meta_is_the_jax_dict(dtype):
    X = np.random.default_rng(3).normal(size=(777, 5)).astype(dtype)
    kw = dict(eps=0.5, min_samples=7, metric="euclidean", block=1024,
              mode="auto")
    want = jax_jobstate.fit_meta(X, **kw)
    assert fit_meta(X, **kw) == want
    assert fit_meta(torch.from_numpy(X), **kw) == want


def _notes(js):
    js.chained_note(2, np.arange(8, dtype=np.int32), np.arange(8) % 2 == 0,
                    np.arange(5, dtype=np.int64), budget=4096)
    js.chained_note(5, -np.arange(8, dtype=np.int32), np.ones(8, bool),
                    np.arange(5, dtype=np.int64) * 3, budget=4096)
    js.stepped_note(np.arange(40, dtype=np.int32)[::-1], 3, budget=0)
    js.gm_note(np.arange(9, dtype=np.int32), 4, budget=8192)
    js.flush(force=True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_jobstate_files_cross_open(tmp_path, writer):
    meta = jax_jobstate.fit_meta(np.ones((10, 3), np.float32), eps=0.3,
                                 min_samples=4, metric="euclidean",
                                 block=64, mode="kd")
    path = str(tmp_path / "x.ckpt")
    _notes((jax_jobstate.JobState if writer == "jax" else JobState).open(
        path, meta))
    a = jax_jobstate.JobState.open(path, meta, resume=True)
    b = JobState.open(path, meta, resume=True)
    ca, cb = a.chained_restore(4096), b.chained_restore(4096)
    assert sorted(ca) == sorted(cb) == [2, 5]
    for p in ca:
        for x, y in zip(ca[p], cb[p]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for fn, args in (("stepped_restore", (0, 40)),
                     ("gm_restore", (8192, 9))):
        x, y = getattr(a, fn)(*args), getattr(b, fn)(*args)
        assert np.array_equal(x[0], y[0]) and x[1] == y[1]
    assert (a.restored_partitions, a.restored_rounds) == (
        b.restored_partitions, b.restored_rounds)


def test_discard_stale(tmp_path):
    from pypardis_tpu_torch.utils.jobstate import discard_stale

    meta = {"schema": "x", "eps": 1.0}
    js = JobState.open(str(tmp_path / "d.npz"), meta)
    js.flush(force=True)
    assert not discard_stale(js.path, meta)
    assert discard_stale(js.path, dict(meta, eps=2.0))
    assert not os.path.exists(js.path)
    with open(js.path, "wb") as f:
        f.write(b"torn")
    assert discard_stale(js.path, meta) and not os.path.exists(js.path)


# -- the compaction -------------------------------------------------------


_LIVE_KW = dict(eps=1.1, min_samples=6, block=128)


def _written(live):
    """The same writes on a live model of either package."""
    rng = np.random.default_rng(2)
    _X, _t, centers = _live_data()
    batch = centers[rng.integers(0, 5, 32)] + rng.normal(
        scale=0.3, size=(32, 3))
    live.insert_batch(batch)
    live.delete_batch(live.ids()[5:25])
    return live


def _live_data():
    return make_separated_blob_data(
        600, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=0)


@pytest.fixture(scope="module")
def jax_compacted():
    """The JAX package's uninterrupted compaction of the written model."""
    X = _live_data()[0]
    jl = _written(JaxDBSCAN(**_LIVE_KW, mesh=default_mesh(1)).fit(X).live(
        warm=False))
    JaxCompactor(jl).compact()
    return _generation(jl)


def _generation(live):
    idx = live.index
    return (live.labels().tobytes(), live.core_mask().tobytes(),
            idx.coords.view(np.int32).tobytes(), idx.labels.tobytes(),
            idx.gids.tobytes(), idx.epoch, idx.generation)


@pytest.mark.parametrize("plan", ["compact.phase:2=error",
                                  "stepped.batch:2=error"])
def test_compaction_resume_swaps_the_uninterrupted_generation(
        tmp_path, monkeypatch, plan, jax_compacted):
    """A cycle killed in its refit (before it, at ``compact.phase:2``, or
    inside it on the stepped route) resumes from ``ckpt`` and swaps in
    the generation of an uninterrupted cycle, the JAX package's too."""
    pl = _written(DBSCAN(**_LIVE_KW, device="cpu").fit(
        _live_data()[0]).live(warm=False))
    if plan.startswith("stepped"):
        _step_env(monkeypatch)
    ckpt = str(tmp_path / "compact.ckpt")
    with faults.plan(plan):
        with pytest.raises(FaultInjected):
            Compactor(pl, ckpt=ckpt).compact()
    assert pl.index.generation == 0
    comp = Compactor(pl, ckpt=ckpt)
    comp.compact()
    assert comp.stats["resumed_rounds"] == (1 if plan.startswith(
        "stepped") else 0)
    assert not os.path.exists(ckpt + ".npz")  # removed after the cycle
    assert _generation(pl) == jax_compacted
