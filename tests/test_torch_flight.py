"""The port's flight recorder and resource watermarks
(``obs/flight.py``, ``obs/resources.py``) on the CPU against the JAX
package's.

A port fit's flight file is written incrementally and parses after a
clean fit, an exception mid-fit (the span it unwinds through stays open
in the file) and a SIGKILL; ``replay`` rebuilds the Chrome trace and a
partial report from the file alone.  The format is the JAX package's:
a port file replays in the JAX ``replay`` to the same spans and
partial report, and a JAX file in the port's.  The resource sampler
always joins and the watermarks are finite on every route.  The cases
are ``tests/test_flight.py``'s that need no mesh (its global-Morton
and bench-gate cases wait for ROADMAP A12 and A16).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import obs as jobs
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu_torch import DBSCAN, KDPartitioner, obs
from pypardis_tpu_torch.parallel import sharded_dbscan
from pypardis_tpu_torch.parallel import staging as port_staging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(eps=0.4, min_samples=5, block=64)


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
    X, _ = make_blobs(n_samples=2000, centers=8, n_features=4,
                      cluster_std=0.3, random_state=11)
    return X


def _parse_lines(path):
    return [json.loads(ln) for ln in open(path, encoding="utf-8")
            .read().splitlines() if ln.strip()]


def _no_sampler_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("pypardis-resource-sampler")
                and t.is_alive()]


def _x_names(trace):
    return [e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"]


# -- flight file: clean fit ------------------------------------------------


def test_flight_file_written_and_replayable(tmp_path, blobs):
    path = str(tmp_path / "flight.jsonl")
    m = DBSCAN(device="cpu", flight=path, **KW).fit(blobs)
    recs = _parse_lines(path)
    kinds = {r["k"] for r in recs}
    assert {"header", "so", "sc", "g", "tm", "rs", "ev", "fin"} <= kinds
    hdr = next(r for r in recs if r["k"] == "header")
    assert hdr["schema"] == "pypardis_tpu/flight@1"
    assert (hdr["n_points"], hdr["n_dims"], hdr["backend"]) == (
        2000, 4, "cpu")
    assert hdr["params"]["eps"] == 0.4
    fin = [r for r in recs if r["k"] == "fin"]
    assert len(fin) == 1 and fin[0]["status"] == "ok"

    rep = obs.replay(path)
    assert rep.complete and rep.status == "ok"
    assert rep.open_spans == [] and rep.bad_lines == 0
    live = _x_names(json.load(open(m.export_trace(
        str(tmp_path / "live.json")))))
    assert _x_names(rep.to_chrome_trace()) == live == [
        "pipeline.layout", "pipeline.cluster", "cluster", "densify"]
    r = rep.report()
    assert r["schema"] == "pypardis_tpu/run_report@1"
    assert r["partial"] is False and r["flight"]["status"] == "ok"
    assert set(r["phases"]) == set(m.report()["phases"])
    assert r["phases"]["cluster"] > 0
    assert r["run"]["n_points"] == 2000
    assert r["compute"]["live_pairs"] == m.metrics_["live_pairs"]
    assert r["resources"]["peak_host_rss_bytes"] > 0
    json.dumps(r)
    assert "resources:" in rep.summary()


def test_flight_env_opt_in_directory_mode(tmp_path, blobs, monkeypatch):
    monkeypatch.setenv("PPTORCH_FLIGHT", str(tmp_path))
    DBSCAN(device="cpu", **KW).fit(blobs)
    files = list(tmp_path.glob("flight-*.jsonl"))
    assert len(files) == 1
    assert obs.replay(str(files[0])).complete
    with pytest.raises(NotImplementedError, match="A10"):
        obs.replay(str(tmp_path))


def test_no_flight_by_default(tmp_path, blobs, monkeypatch):
    monkeypatch.delenv("PPTORCH_FLIGHT", raising=False)
    monkeypatch.chdir(tmp_path)
    m = DBSCAN(device="cpu", **KW).fit(blobs)
    assert m._recorder.flight is None
    assert list(tmp_path.iterdir()) == []


# -- cross-reading between the packages ------------------------------------


def _replays_agree(path, live_names, live_phases):
    """Both packages' replays of one file: the same spans in order, the
    same partial report phases (the live fit's) and completeness."""
    mine, theirs = obs.replay(path), jobs.replay(path)
    assert _x_names(mine.to_chrome_trace()) == _x_names(
        theirs.to_chrome_trace()) == live_names
    rm, rt = mine.report(), theirs.report()
    assert set(rm["phases"]) == set(rt["phases"]) == set(live_phases)
    assert rm["phases"] == rt["phases"]
    assert rm["run"] == rt["run"]
    assert rm["events"] == rt["events"]
    assert (mine.complete, mine.status, mine.records) == (
        theirs.complete, theirs.status, theirs.records)


def test_port_flight_file_replays_in_the_jax_package(tmp_path, blobs):
    path = str(tmp_path / "port.jsonl")
    m = DBSCAN(device="cpu", flight=path, **KW).fit(blobs)
    _replays_agree(path, [s.name for s in m._recorder.tracer.spans],
                   m.report()["phases"])


def test_jax_flight_file_replays_in_the_port(tmp_path, blobs):
    path = str(tmp_path / "jax.jsonl")
    staging.clear()
    m = JaxDBSCAN(mesh=default_mesh(1), flight=path, **KW).fit(blobs)
    _replays_agree(path, [s.name for s in m._recorder.tracer.spans],
                   m.report()["phases"])


# -- flight file: a failure mid-fit ---------------------------------------


def test_injected_midfit_exception_leaves_open_span(
        tmp_path, blobs, monkeypatch):
    """A fit an exception stops leaves a parseable file whose open span
    marks where it died, and a partial report; the exception
    propagates (there is no fallback)."""
    def boom(*a, **kw):
        raise RuntimeError("injected cluster-step failure")

    monkeypatch.setattr("pypardis_tpu_torch.dbscan._pad_and_run", boom)
    path = str(tmp_path / "flight.jsonl")
    m = DBSCAN(device="cpu", flight=path, **KW)
    with pytest.raises(RuntimeError, match="injected"):
        m.fit(blobs)
    assert _no_sampler_threads()
    recs = _parse_lines(path)
    fin = [r for r in recs if r["k"] == "fin"]
    assert len(fin) == 1 and fin[0]["status"] == "error"
    assert "injected" in fin[0]["error"]
    opened = {r["id"]: r["name"] for r in recs if r["k"] == "so"}
    closed = {r["id"] for r in recs if r["k"] == "sc"}
    assert {opened[i] for i in set(opened) - closed} == {"cluster"}
    for rp in (obs.replay(path), jobs.replay(path)):
        assert rp.status == "error"
        assert [s["name"] for s in rp.open_spans] == ["cluster"]
        assert rp.report()["flight"]["open_spans"] == ["cluster"]
        unclosed = [e["name"] for e in rp.to_chrome_trace()["traceEvents"]
                    if e.get("args", {}).get("unclosed")]
        assert unclosed == ["cluster"]
        assert "PARTIAL" not in rp.summary()
    assert m.labels_ is None
    out = m.export_trace(str(tmp_path / "failed_fit.json"))
    assert "cluster" in _x_names(json.load(open(out)))
    with pytest.raises(RuntimeError, match="not fitted"):
        m.report()


_CHILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import pypardis_tpu_torch.dbscan as d

def stall(*a, **kw):
    open({marker!r}, "w").close()
    time.sleep(120)

d._pad_and_run = stall
X = np.random.default_rng(0).normal(size=(500, 3))
d.DBSCAN(eps=0.5, min_samples=5, block=64, device="cpu",
         flight={path!r}).fit(X)
"""


def test_sigkilled_child_leaves_an_open_span(tmp_path):
    """A fit killed with SIGKILL inside its cluster phase leaves a file
    without a ``fin`` record whose open span both packages' replays
    name; the partial report says so."""
    path = str(tmp_path / "killed.jsonl")
    marker = str(tmp_path / "inside")
    code = _CHILD.format(repo=REPO, marker=marker, path=path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    child = subprocess.Popen([sys.executable, "-c", code], env=env)
    try:
        t0 = time.time()
        while not os.path.exists(marker):
            assert child.poll() is None, "the child exited early"
            assert time.time() - t0 < 60, "the child never reached the fit"
            time.sleep(0.05)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
    assert child.returncode == -signal.SIGKILL
    for rp in (obs.replay(path), jobs.replay(path)):
        assert not rp.complete and rp.status is None
        assert [s["name"] for s in rp.open_spans] == ["cluster"]
        r = rp.report()
        assert r["partial"] is True
        assert r["flight"]["open_spans"] == ["cluster"]
        assert "PARTIAL (run killed inside cluster" in rp.summary()


# -- heartbeats and notes ---------------------------------------------------


def test_chained_route_heartbeats_land_in_the_flight_file(
        tmp_path, blobs, monkeypatch, caplog):
    path = str(tmp_path / "chained.jsonl")
    rec = obs.RunRecorder()
    flight = obs.open_flight(path)
    rec.attach_flight(flight)
    monkeypatch.setenv("PPTORCH_HEARTBEAT", "0.0001")
    with obs.use_recorder(rec), caplog.at_level("INFO"):
        part = KDPartitioner(blobs, max_partitions=4)
        sharded_dbscan(blobs, part, device="cpu", **KW)
        obs.flight_note("staging.reuse", nbytes=12)
    flight.finish("ok")
    flight.close()
    recs = _parse_lines(path)
    hb = [r for r in recs if r["k"] == "hb"]
    assert [(r["stage"], r["done"], r["total"]) for r in hb] == [
        ("chained.partitions", p + 1, 4) for p in range(4)]
    # (The fit's own staging notes ride in the file beside it.)
    assert any(r["k"] == "note" and r.get("nbytes") == 12 for r in recs)
    assert "heartbeat chained.partitions 4/4" in caplog.text
    rp = obs.replay(path)
    assert rp.heartbeats["chained.partitions"]["done"] == 4
    assert [n for n in _x_names(rp.to_chrome_trace())] == [
        "sharded.build_shards", "sharded.execute"]


# -- resource watermarks ----------------------------------------------------


def test_sampler_never_leaks_threads(blobs):
    for _ in range(2):
        DBSCAN(device="cpu", **KW).fit(blobs)
        assert _no_sampler_threads()


@pytest.mark.parametrize("route", ["fit", "sweep", "eps_none", "chained"])
def test_resources_finite_on_all_routes(blobs, route):
    X = blobs[:800]
    # A cold cache: the staging watermark is then the pool as the fit
    # leaves it (the cache only grows during a cold fit).
    port_staging.clear()
    if route == "chained":
        rec = obs.RunRecorder()
        sampler = obs.ResourceSampler(rec).start()
        with obs.use_recorder(rec):
            sharded_dbscan(X, KDPartitioner(X, max_partitions=4),
                           device="cpu", **KW)
        sampler.stop()
        res = obs.build_run_report(
            rec, params={}, n_points=len(X), n_dims=4, n_devices=1,
            backend="cpu", metrics={})["resources"]
    else:
        m = DBSCAN(eps=None if route == "eps_none" else 0.4, min_samples=5,
                   block=64, device="cpu")
        if route == "sweep":
            m.sweep(X, [0.3, 0.4])
        else:
            m.fit(X)
        res = m.report()["resources"]
    assert _no_sampler_threads()
    for key in ("peak_host_rss_bytes", "peak_device_bytes",
                "staging_pool_bytes", "samples"):
        assert np.isfinite(float(res[key])), key
    assert res["peak_host_rss_bytes"] > 0 and res["samples"] >= 1
    assert res["peak_device_bytes"] == 0
    assert res["staging_pool_bytes"] == port_staging.pool_nbytes()


def test_memory_pressure_and_its_event(monkeypatch):
    from pypardis_tpu_torch.obs import resources

    assert resources.host_rss_bytes() > 0
    assert resources.device_live_bytes("cpu") == 0
    monkeypatch.setenv("PPTORCH_RSS_SOFT_LIMIT", "1")
    assert resources.rss_soft_limit() == 1 and resources.memory_pressure()
    rec = obs.RunRecorder()
    s = obs.ResourceSampler(rec, interval_s=0.01).start()
    time.sleep(0.05)
    s.stop()
    assert rec.event_counts() == {"resource.pressure": 1}
    assert rec.metrics.gauge("resources.pressure") is True
    monkeypatch.setenv("PPTORCH_RSS_SOFT_LIMIT", "0")
    assert not resources.memory_pressure()
