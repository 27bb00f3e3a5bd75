"""``DBSCAN(mesh=Mesh(["cpu"] * P))`` against the JAX package's
``DBSCAN(mesh=default_mesh(P))`` over the conftest's eight faked CPU
devices: labels, core mask, the reference's parity surface
(``bounding_boxes``, ``neighbors``, ``cluster_dict``,
``cluster_mapping()``), ``metrics_`` and the report's ``sharding`` /
``run`` / ``devices`` sections, bitwise but for timings; the counterparts
of the JAX mesh tests of ``tests/test_obs.py``
(``test_report_schema_on_mesh``, ``test_report_compute_and_perf_
contract_sections``, the sharded halves of ``test_export_trace_valid_
chrome_json`` and ``test_report_host_pipeline_fields``) and
``tests/test_faults.py`` (the ``DBSCAN(max_partitions=)`` forms of
``test_device_merge_oom_spills_to_host`` and
``test_rss_soft_limit_prefers_host_merge``); and the fused step's
ladders and spill through ``sharded_dbscan``."""

import json
import math

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import obs as jax_obs
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu_torch import DBSCAN, obs
from pypardis_tpu_torch.parallel import Mesh
from pypardis_tpu_torch.parallel import staging as port_staging
from pypardis_tpu_torch.utils import faults
from test_torch_mesh_parity import _jax, _port, _same_result

KW = dict(eps=0.4, min_samples=5, block=64)
# Report keys that are timings, the JAX staging cache's, or the name of
# the partition builder (the port's is the JAX "legacy" node-at-a-time
# one; both give the same tree).
TIMED = {"partition_levels_s", "staged_bytes", "staged_bytes_reused",
         "partition_builder", "total_s", "points_per_sec", "stage_s"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _mesh(P):
    return Mesh(["cpu"] * P)


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(n_samples=4000, centers=10, n_features=3,
                      cluster_std=0.3, random_state=5)
    return X.astype(np.float32)


@pytest.fixture(scope="module")
def fitted_model():
    """``tests/test_obs.py``'s fixture on an 8-device mesh, fitted cold
    (the port's staging cache cleared first)."""
    X, _ = make_blobs(n_samples=2000, centers=8, n_features=4,
                      cluster_std=0.3, random_state=3)
    port_staging.clear()
    return DBSCAN(mesh=_mesh(8), device="cpu", eps=0.4, min_samples=5,
                  block=64).fit(X)


def _boxes(boxes):
    return {l: (b.lower.tobytes(), b.upper.tobytes())
            for l, b in boxes.items()}


@pytest.mark.parametrize("P,parts", [(4, None), (8, None), (4, 6)])
def test_mesh_fit_matches_jax(blobs, P, parts):
    staging.clear()
    ref = JaxDBSCAN(mesh=default_mesh(P), max_partitions=parts,
                    **KW).fit(blobs)
    m = DBSCAN(mesh=_mesh(P), max_partitions=parts, device="cpu",
               **KW).fit(blobs)
    np.testing.assert_array_equal(m.labels_, ref.labels_)
    np.testing.assert_array_equal(m.core_sample_mask_,
                                  ref.core_sample_mask_)
    assert _boxes(m.bounding_boxes) == _boxes(ref.bounding_boxes)
    assert _boxes(m.expanded_boxes) == _boxes(ref.expanded_boxes)
    assert sorted(m.neighbors) == sorted(ref.neighbors)
    for l in ref.neighbors:
        np.testing.assert_array_equal(m.neighbors[l], ref.neighbors[l])
    assert m.cluster_dict == ref.cluster_dict
    np.testing.assert_array_equal(m.partitioner_.result,
                                  ref.partitioner_.result)
    got, want = m.cluster_mapping(), ref.cluster_mapping()
    assert dict(got.fwd) == dict(want.fwd)
    assert got.next_global_id == want.next_global_id
    # More than one partition keys the codes (the parent keyed all as 0).
    assert len({k.split(":")[0] for k in got.fwd}) > 1
    assert m.metrics_["n_partitions"] == ref.metrics_["n_partitions"]
    assert m.assignments() == ref.assignments()
    r, jr = m.report(), ref.report()
    json.dumps(r)
    for sec in ("sharding", "devices"):
        keys = (set(r[sec]) | set(jr[sec])) - TIMED
        assert {k: r[sec].get(k) for k in keys} == {
            k: jr[sec].get(k) for k in keys}, sec
    for k in ("n_points", "n_dims", "n_devices"):
        assert r["run"][k] == jr["run"][k]
    for k in ("max_partitions", "split_method", "merge", "owner_computes",
              "overlap", "mode"):
        assert r["params"][k] == jr["params"][k], k


def test_report_schema_on_mesh(fitted_model):
    r = fitted_model.report()
    assert r["schema"] == "pypardis_tpu/run_report@1"
    json.dumps(r)
    assert set(r["phases"]) >= {"partition", "cluster", "densify"}
    assert all(v >= 0 for v in r["phases"].values())
    assert r["run"]["total_s"] > 0
    assert r["run"]["n_points"] == 2000 and r["run"]["n_dims"] == 4
    assert r["run"]["n_devices"] == 8
    assert r["sharding"]["halo_factor"] > 0
    assert r["sharding"]["pad_waste"] >= 0
    assert r["sharding"]["n_shard_partitions"] == 8
    assert r["sharding"]["halo_bytes"] > 0
    dev = r["devices"]
    assert dev["count"] == 8
    assert len(dev["partition_sizes"]) == 8
    assert sum(dev["points"]) == 2000
    assert r["events"]["restage"] == 0
    assert r["faults"] == {
        "injected": 0, "retried": 0, "giveups": 0, "degraded": 0,
        "degraded_to": "",
    }
    assert "phase.cluster" in r["metrics"]["timings"]
    s = fitted_model.summary()
    assert "2,000 pts x 4D" in s
    assert "halo_factor" in s and "pad_waste" in s


def test_report_compute_and_perf_contract_sections(fitted_model):
    r = fitted_model.report()
    comp = r["compute"]
    for key in ("live_pairs", "kernel_block", "kernel_passes",
                "model_flops", "achieved_flops_per_sec", "peak_flops",
                "mfu"):
        assert key in comp, key
        assert math.isfinite(float(comp[key])), key
    assert comp["live_pairs"] > 0
    assert comp["kernel_passes"] >= 2
    assert comp["kernel_block"] > 0
    assert comp["achieved_flops_per_sec"] > 0
    assert 0 < comp["mfu"] < 1
    sh = r["sharding"]
    assert sh["owner_computes"] is True
    assert 1.0 <= sh["duplicated_work_factor"] < 1.0 + sh["pad_waste"] + 0.5
    # A cold fit reuses nothing from the staging cache.
    assert sh["staged_bytes_reused"] == 0
    assert "compute:" in fitted_model.summary()


def test_export_trace_valid_chrome_json(fitted_model, tmp_path):
    path = fitted_model.export_trace(str(tmp_path / "fit_trace.json"))
    doc = json.load(open(path))
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert {"cluster", "partition", "sharded.build_shards",
            "sharded.execute"} <= names


def test_report_host_pipeline_fields():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(4000, 3))
    m = DBSCAN(mesh=_mesh(8), device="cpu", eps=0.4, min_samples=5,
               block=64).fit(X)
    rep = m.report()
    levels = rep["sharding"]["partition_levels_s"]
    assert isinstance(levels, list) and len(levels) >= 1
    assert all(isinstance(t, float) and t >= 0 for t in levels)
    assert rep["sharding"]["partition_builder"] == "legacy"
    assert "overlap" in rep["params"]
    assert "partition levels" in m.summary()


@pytest.fixture(scope="module")
def fault_blobs():
    X, _ = make_blobs(n_samples=1200, centers=8, n_features=4,
                      cluster_std=0.3, random_state=3)
    return X.astype(np.float32)


def test_device_merge_oom_spills_to_host(fault_blobs):
    kw = dict(eps=0.45, min_samples=5, block=64, max_partitions=8,
              mesh=_mesh(8), device="cpu")
    clean = DBSCAN(merge="host", **kw).fit(fault_blobs)
    with faults.plan("sharded.execute:1=oom"):
        faulty = DBSCAN(merge="device", **kw).fit(fault_blobs)
    np.testing.assert_array_equal(faulty.labels_, clean.labels_)
    r = faulty.report()
    assert r["sharding"]["merge"] == "host"
    assert r["faults"]["degraded"] >= 1
    assert r["faults"]["degraded_to"] == "merge_host"
    assert r["events"]["degraded"] >= 1


def test_rss_soft_limit_prefers_host_merge(fault_blobs, monkeypatch):
    monkeypatch.setenv("PPTORCH_RSS_SOFT_LIMIT", "1024")  # always over
    from pypardis_tpu_torch.obs.resources import memory_pressure

    assert memory_pressure()
    model = DBSCAN(merge="auto", max_partitions=8, mesh=_mesh(8),
                   device="cpu", eps=0.45, min_samples=5,
                   block=64).fit(fault_blobs)
    r = model.report()
    assert r["sharding"]["merge"] == "host"
    assert r["metrics"]["counters"].get(
        "events.resource.pressure", 0) >= 1


# -- the ladders and the spill ------------------------------------------------


def test_merge_rounds_ladder_matches_jax():
    """A line of points threading every partition: at merge_rounds=1
    both retry at 4x and converge to one cluster, counting the rung
    alike."""
    X = np.zeros((256, 2))
    X[:, 0] = np.arange(256, dtype=np.float64) * 0.09
    kw = dict(eps=0.2, min_samples=2, block=64)
    recs = {"jax": jax_obs.RunRecorder(), "port": obs.RunRecorder()}
    with jax_obs.use_recorder(recs["jax"]):
        want = _jax(X, 4, kw=kw, merge="device", merge_rounds=1)
    with obs.use_recorder(recs["port"]):
        got = _port(X, 4, kw=kw, merge="device", merge_rounds=1)
    _same_result(got, want)
    assert got[2]["merge_rounds"] > 1
    assert got[0].max() == got[0].min() >= 0
    counters = [{k: v for k, v in recs[n].metrics.as_dict()[
        "counters"].items() if k.startswith("retry.")}
        for n in ("jax", "port")]
    assert counters[0] == counters[1] == {
        "retry.merge_rounds.attempts": 1}


@pytest.fixture(scope="module")
def references(blobs):
    """The JAX fused step on 4 devices, owner-computes on, per merge."""
    return {merge: _jax(blobs, 4, merge=merge)
            for merge in ("device", "host")}


def test_tiny_pair_budget_reruns_at_the_exact_total(blobs, references):
    got = _port(blobs, 4, pair_budget=1, merge="device")
    _same_result(got, references["device"])
    p = got[2]["n_shard_partitions"]
    # The first attempt ran no pass; the rerun ran every partition.
    assert got[2]["partition_passes"][:p] == [0] * p
    assert min(got[2]["partition_passes"][p:]) >= 2


def test_injected_oom_finishes_the_merge_on_the_host(blobs, references):
    rec = obs.RunRecorder()
    with obs.use_recorder(rec), faults.plan("sharded.execute:1=oom"):
        lab, core, stats = _port(blobs, 4, merge="device")
    want = references["host"]
    np.testing.assert_array_equal(lab, want[0])
    np.testing.assert_array_equal(core, want[1])
    assert stats["merge"] == "host" and "merge_rounds" not in stats
    assert rec.event_counts().get("degraded", 0) >= 1
    names = {s.name for s in rec.tracer.spans}
    assert {"sharded.build_shards", "sharded.execute",
            "sharded.merge_host"} <= names


def test_other_failures_do_not_degrade(blobs):
    with faults.plan("sharded.execute:1=error"):
        with pytest.raises(faults.FaultInjected):
            _port(blobs, 4, merge="device")


def test_cluster_mapping_after_a_mesh_fit_keys_the_partitions():
    """After a mesh fit ``cluster_mapping()`` keys each point by its KD
    partition (``partitioner_.result``), as the JAX model does; a
    single-device model keys every point as partition 0 (the parent's
    method keyed a mesh fit's points so too)."""
    X, _ = make_blobs(n_samples=1500, centers=6, n_features=2,
                      cluster_std=0.4, random_state=2)
    kw = dict(eps=0.3, min_samples=5, block=64)
    ref = JaxDBSCAN(mesh=default_mesh(4), **kw).fit(X)
    port = DBSCAN(mesh=_mesh(4), device="cpu", **kw).fit(X)
    got, want = port.cluster_mapping(), ref.cluster_mapping()
    assert dict(got.fwd) == dict(want.fwd)
    assert dict(got.rev) == dict(want.rev)
    assert port.cluster_dict == dict(want.fwd)
    assert len({k.split(":")[0] for k in got.fwd}) == 4
