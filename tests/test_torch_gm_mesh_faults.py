"""The global-Morton mesh engine's fault sites, resume and telemetry on
the CPU, against the JAX engine: the counterparts of
``tests/test_faults.py::test_gm_fixpoint_transfer_error_recovers``,
``::test_gm_ring_round_transfer_error_recovers`` and
``::test_gm_terminal_oom_falls_back_to_kd``, of
``tests/test_jobstate.py::test_gm_resume_via_train``,
``::test_btcap_exhaustion_names_knob`` and the global-Morton form of
``::test_resume_rejects_mismatched_fit``, and of
``tests/test_flight.py::test_gm_ring_counters_surfaced_in_summary`` and
the ``global_morton`` case of ``::test_resources_finite_on_all_routes``;
then the device merge's degradation rung and a resumed fixpoint at the
engine's own surface.

``gm.ring_round`` and ``gm.fixpoint_round`` sit inside a retry scope,
so one injected transfer error is retried once and the labels stay the
clean fit's; ``gm.exchange`` sits outside one, as in the JAX package:
an OOM there is the ``DBSCAN`` surface's ``kd_owner_computes`` rung.
The data is ``tests/test_faults.py``'s line through all 8 ranges, so
the fixpoint runs several rounds."""

import math

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu.utils import faults as jax_faults
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import global_morton_dbscan, staging
from pypardis_tpu_torch.parallel.mesh import Mesh
from pypardis_tpu_torch.utils import faults
from pypardis_tpu_torch.utils.jobstate import JobState, fit_meta

KW = dict(eps=0.45, min_samples=5, block=64)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.clear()
    jax_faults.clear()
    staging.clear()
    jax_staging.clear()
    yield
    faults.clear()
    jax_faults.clear()
    staging.clear()


@pytest.fixture(scope="module")
def chain_data():
    rng = np.random.default_rng(0)
    n = 3000
    X = np.stack([np.arange(n) * 0.1, rng.normal(0, 0.05, n)], axis=1)
    return X.astype(np.float32)


@pytest.fixture(scope="module")
def blob_data():
    X, _ = make_blobs(n_samples=2000, centers=8, n_features=4,
                      cluster_std=0.3, random_state=3)
    return X.astype(np.float32)


@pytest.fixture(scope="module")
def jax_clean(chain_data):
    """The JAX engine's clean device-merge fit of the line."""
    jax_staging.clear()
    m = JaxDBSCAN(mode="global_morton", merge="device",
                  mesh=default_mesh(8), **KW).fit(chain_data)
    return m.labels_, m.core_sample_mask_


def _model(**kw):
    return DBSCAN(mode="global_morton", mesh=Mesh(["cpu"] * 8),
                  device="cpu", **dict(KW, **kw))


def test_fault_sites_are_known():
    for site in ("gm.exchange", "gm.ring_round", "gm.fixpoint_round"):
        assert site in faults.KNOWN_SITES
        assert site in jax_faults.KNOWN_SITES


def test_gm_fixpoint_transfer_error_recovers(chain_data, jax_clean):
    clean = _model(merge="device").fit(chain_data)
    np.testing.assert_array_equal(clean.labels_, jax_clean[0])
    staging.clear()
    with faults.plan("gm.fixpoint_round:1=transfer_error"):
        faulty = _model(merge="device").fit(chain_data)
    np.testing.assert_array_equal(faulty.labels_, clean.labels_)
    np.testing.assert_array_equal(faulty.core_sample_mask_,
                                  clean.core_sample_mask_)
    r = faulty.report()
    assert r["faults"]["injected"] == 1
    assert r["faults"]["retried"] == 1
    assert r["faults"]["giveups"] == 0
    assert r["events"]["fault_injected"] == 1
    assert r["events"]["transient_retry"] == 1
    assert clean.report()["faults"]["injected"] == 0
    assert faulty.metrics_["fixpoint_rounds"] == \
        clean.metrics_["fixpoint_rounds"] >= 2


def test_gm_ring_round_transfer_error_recovers(chain_data, jax_clean):
    clean = _model().fit(chain_data)
    staging.clear()
    with faults.plan("gm.ring_round:2=transfer_error"):
        faulty = _model().fit(chain_data)
    np.testing.assert_array_equal(faulty.labels_, clean.labels_)
    np.testing.assert_array_equal(faulty.labels_, jax_clean[0])
    r = faulty.report()
    assert r["faults"]["injected"] == 1 and r["faults"]["retried"] == 1
    assert faulty.metrics_["boundary_tiles"] == clean.metrics_[
        "boundary_tiles"]


def test_gm_terminal_oom_falls_back_to_kd(chain_data, jax_clean):
    with faults.plan("gm.exchange:1=oom"):
        faulty = _model().fit(chain_data)
    np.testing.assert_array_equal(faulty.labels_, jax_clean[0])
    r = faulty.report()
    assert r["faults"]["degraded_to"] == "kd_owner_computes"
    # The fallback really ran the KD route.
    assert r["sharding"].get("mode") != "global_morton"
    assert faulty.partitioner_.builder != "morton_range"


def test_device_merge_oom_degrades_to_the_host_merge(chain_data, jax_clean):
    """An OOM inside the device route's ladder (``gm.execute``) reruns
    the fit under the host union-find: ``merge_host``, the same labels."""
    with faults.plan("gm.execute:1=oom"):
        m = _model(merge="device").fit(chain_data)
    np.testing.assert_array_equal(m.labels_, jax_clean[0])
    r = m.report()
    assert r["faults"]["degraded_to"] == "merge_host"
    assert r["sharding"]["merge"] == "host"


def test_gm_resume_via_train(chain_data, jax_clean, tmp_path):
    """``train(resume=)`` on the engine: the fit dies inside fixpoint
    round 2 and the resumed fit starts from the saved ``lab_map``, to
    the uninterrupted labels."""
    path = str(tmp_path / "gm.ckpt")
    with faults.plan("gm.fixpoint_round:2=error"):
        with pytest.raises(faults.FaultInjected):
            _model(merge="device").train(chain_data, resume=path)
    staging.clear()
    model = _model(merge="device")
    model.train(chain_data, resume=path)
    np.testing.assert_array_equal(model.labels_, jax_clean[0])
    np.testing.assert_array_equal(model.core_sample_mask_, jax_clean[1])
    assert model._jobstate.restored_rounds >= 1
    assert model.report()["metrics"]["counters"].get(
        "events.jobstate_restore", 0) >= 1


def test_resumed_fixpoint_at_the_engine_surface(chain_data, jax_clean,
                                                tmp_path):
    """``global_morton_dbscan(jobstate=)``: a run killed in round 3 is
    resumed from its snapshot (keyed by the pair budget) and converges
    to the clean labels in fewer rounds of its own."""
    X = np.asarray(chain_data)
    path = str(tmp_path / "gm_engine.npz")
    meta = fit_meta(X, eps=KW["eps"], min_samples=KW["min_samples"],
                    metric="euclidean", block=KW["block"],
                    mode="global_morton")
    kw = dict(KW, mesh=Mesh(["cpu"] * 8), merge="device", device="cpu")
    clean = global_morton_dbscan(X, **kw)
    js = JobState.open(path, meta, every_s=0)
    with faults.plan("gm.fixpoint_round:3=error"):
        with pytest.raises(faults.FaultInjected):
            global_morton_dbscan(X, jobstate=js, **kw)
    js2 = JobState.open(path, meta, resume=True)
    lab, core, st = global_morton_dbscan(X, jobstate=js2, **kw)
    assert js2.restored_rounds == 2
    np.testing.assert_array_equal(lab, clean[0])
    np.testing.assert_array_equal(core, clean[1])
    np.testing.assert_array_equal(lab, jax_clean[0])


def test_resume_rejects_mismatched_fit(chain_data, blob_data, tmp_path):
    path = str(tmp_path / "mismatch.ckpt")
    with faults.plan("gm.fixpoint_round:1=error"):
        with pytest.raises(faults.FaultInjected):
            _model(merge="device").train(chain_data, resume=path)
    with pytest.raises(ValueError, match="different fit"):
        _model(merge="device").train(blob_data, resume=path)


def test_btcap_exhaustion_names_knob(blob_data):
    with pytest.raises(RuntimeError) as ei:
        # eps large enough that every tile is a boundary tile: an
        # explicit btcap=1 overflows and fails loudly.
        global_morton_dbscan(blob_data, eps=5.0, min_samples=5, block=64,
                             btcap=1, mesh=Mesh(["cpu"] * 8), device="cpu")
    msg = str(ei.value)
    assert "btcap" in msg and "PPTORCH_GM_BTCAP" in msg


def test_btcap_knob_is_an_explicit_cap(blob_data, monkeypatch):
    monkeypatch.setenv("PPTORCH_GM_BTCAP", "1")
    with pytest.raises(RuntimeError, match="needs"):
        global_morton_dbscan(blob_data, eps=5.0, min_samples=5, block=64,
                             mesh=Mesh(["cpu"] * 8), device="cpu")


def test_gm_ring_counters_surfaced_in_summary(blob_data):
    m = DBSCAN(eps=0.4, min_samples=5, block=64, mode="global_morton",
               mesh=Mesh(["cpu"] * 8), device="cpu").fit(blob_data)
    ctr = m.report()["metrics"]["counters"]
    assert ctr.get("gm.ring_bytes_sent", 0) > 0
    assert ctr.get("gm.ring_tiles_kept", 0) > 0
    assert ctr["gm.ring_bytes_sent"] == (
        m.metrics_["boundary_tile_bytes"] * 7)
    assert "ring " in m.summary()


def test_resources_finite_on_the_global_morton_route(blob_data):
    res = DBSCAN(eps=0.4, min_samples=5, block=64, mode="global_morton",
                 mesh=Mesh(["cpu"] * 8), device="cpu").fit(
        blob_data).report()["resources"]
    for key in ("peak_host_rss_bytes", "peak_device_bytes",
                "staging_pool_bytes", "samples"):
        assert math.isfinite(float(res[key])), key
    assert res["peak_host_rss_bytes"] > 0
    assert res["samples"] >= 1
