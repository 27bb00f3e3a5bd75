"""The port's live export plane (``obs/export.py``) and the engine's
latency histogram on the CPU against the JAX package's.

The same registry and run state render to the same OpenMetrics text in
both packages; ``attach_exporters`` is None with its knobs unset, serves
a scrape on an ephemeral 127.0.0.1 port during a fit, writes snapshot
lines that parse, tees with a flight recorder and restores the sink
seam on close; the load harness attaches it to the engine's recorder.
The histogram cases of ``tests/test_export.py`` run on both packages'
``Histogram`` with the same observations, and the engine's
``serving_stats()`` p50/p99 come from its histogram, equal to the JAX
engine's on the same latencies.
"""

import json
import math
import time
import urllib.request

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import obs as jobs
from pypardis_tpu.obs import export as jexport
from pypardis_tpu.obs.flight import FlightRecorder as JaxFlight
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.serve import QueryEngine as JaxEngine
from pypardis_tpu_torch import DBSCAN, obs
from pypardis_tpu_torch.convert import dbscan_from_reference
from pypardis_tpu_torch.obs import export as texport
from pypardis_tpu_torch.obs.flight import FlightRecorder
from pypardis_tpu_torch.serve import QueryEngine, sustained_load

KW = dict(eps=0.4, min_samples=5, block=64)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_export_env(monkeypatch):
    for k in ("PPTORCH_METRICS_PORT", "PPTORCH_METRICS_SNAPSHOT",
              "PPTORCH_METRICS_SNAPSHOT_S"):
        monkeypatch.delenv(k, raising=False)


def _blobs(n=600):
    X, _ = make_blobs(n_samples=n, centers=4, n_features=3,
                      cluster_std=0.3, random_state=0)
    return X


# -- Histogram: tests/test_export.py's cases on both packages --------------


def _hist_case(H, case):
    if case == "percentiles":
        h = H(window_s=60)
        for i in range(1, 101):
            h.observe(float(i))
        return h, (h.percentile(50), h.percentile(99), h.count, h.max_ms,
                   h.sum_ms)
    if case == "window_expiry":
        h = H(window_s=8)
        old = time.monotonic() - 1000.0
        for _ in range(10):
            h.observe(1.0, now_s=old)
        first = (h.window_count, h.percentile(50))
        for _ in range(5):
            h.observe(100.0)
        return h, first + (h.window_count, h.percentile(50),
                           h.percentile(50, window=False))
    if case == "footprint":
        h = H()
        before = h.nbytes
        for i in range(20_000):
            h.observe((i % 977) / 7.0)
        return h, (h.nbytes == before, h.count)
    if case == "nan_and_overflow":
        h = H()
        h.observe(float("nan"))
        h.observe(1e9)
        return h, (h.count, h.percentile(99))
    if case == "merge_clone":
        a, b = H(window_s=60), H(window_s=60)
        for v in (0.5, 2.0, 8.0):
            a.observe(v)
        for v in (32.0, 128.0):
            b.observe(v)
        c = a.clone()
        c.merge_from(b)
        back = H.from_snapshot(json.loads(json.dumps(c.snapshot())))
        return c, (a.count, c.count, c.max_ms, back.count,
                   back.percentile(50, window=False))


@pytest.mark.parametrize("case", ["percentiles", "window_expiry",
                                  "footprint", "nan_and_overflow",
                                  "merge_clone"])
def test_histogram_cases_equal_the_jax_ones(case):
    hp, vp = _hist_case(texport.Histogram, case)
    hj, vj = _hist_case(jexport.Histogram, case)
    assert vp == vj
    assert hp.snapshot() == hj.snapshot()
    if case == "percentiles":
        assert 30 <= vp[0] <= 80 and 70 <= vp[1] <= 140
    if case == "footprint":
        assert vp == (True, 20_000)


# -- OpenMetrics rendering --------------------------------------------------


def _render(pkg, export):
    reg = pkg.MetricsRegistry()
    reg.inc("events.compile")
    reg.set("metrics.http_port", 9200)
    reg.set("gateway.model.m03.queries", 7)
    reg.observe_ms("serving.latency_ms", 3.0)
    reg.observe("phase.cluster", 0.25)
    state = export.LiveState()
    state.span_open(1, "cluster", 0.0, 0, {})
    state.span_close(2, "chained.partition", 0.0, 0.012, {})
    state.heartbeat("chained.partitions", 3, 7, 1.5)
    state.sample(rss=12345.0)
    return export.render_openmetrics(reg.as_dict(), state)


def test_render_openmetrics_families():
    body = _render(obs, texport)
    jbody = _render(jobs, jexport)
    strip = lambda b: [ln for ln in b.splitlines()
                       if not ln.startswith("pypardis_open_span")]
    assert strip(body) == strip(jbody)
    assert body.endswith("# EOF\n")
    assert "pypardis_events_compile_total 1" in body
    assert "pypardis_metrics_http_port 9200" in body
    assert 'pypardis_gateway_queries{model="m03"} 7' in body
    assert 'pypardis_serving_latency_ms_bucket{le="' in body
    assert 'pypardis_span_chained_partition_bucket{le="' in body
    assert 'pypardis_open_span{name="cluster",depth="0"}' in body
    assert 'pypardis_heartbeat_done{stage="chained.partitions"} 3' in body
    assert "pypardis_resource_rss 12345" in body
    assert "pypardis_run_finished 0" in body
    for ln in body.splitlines():
        if "_bucket{" in ln:
            assert math.isfinite(float(ln.rsplit(" ", 1)[1]))


def _parse_openmetrics(body):
    """Every sample line's float value; comments are TYPE lines or the
    terminating EOF."""
    lines = body.rstrip("\n").splitlines()
    assert lines[-1] == "# EOF"
    samples = {}
    for ln in lines[:-1]:
        if ln.startswith("#"):
            assert ln.startswith("# TYPE "), ln
            continue
        name, value = ln.rsplit(" ", 1)
        samples[name] = float(value)
    return samples


# -- attach_exporters -------------------------------------------------------


def test_attach_exporters_off_is_none():
    assert texport.attach_exporters(obs.RunRecorder()) is None
    assert texport.attach_exporters(None) is None


def test_http_scrape_mid_span_and_seam_restore():
    rec = obs.RunRecorder()
    stack = texport.attach_exporters(rec, port=0)
    assert stack is not None and stack.http_port
    assert obs.last_http_port() == stack.http_port
    try:
        with rec.span("unit.scrape_phase"):
            rec.metrics.observe_ms("serving.latency_ms", 1.5)
            url = f"http://127.0.0.1:{stack.http_port}"
            with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
                ctype = r.headers.get("Content-Type", "")
                body = r.read().decode("utf-8")
            assert "openmetrics-text" in ctype
            assert 'pypardis_open_span{name="unit.scrape_phase"' in body
            _parse_openmetrics(body)
            with urllib.request.urlopen(url + "/state.json", timeout=5) as r:
                st = json.loads(r.read())
            assert st["schema"] == texport.SNAPSHOT_SCHEMA
            assert "unit.scrape_phase" in st["open_spans"]
        assert rec.metrics.gauge("metrics.http_port") == stack.http_port
    finally:
        stack.close()
    assert rec.flight is None and rec.tracer.sink is None
    assert rec.metrics.sink is None


def test_scrape_during_a_fit_parses(monkeypatch):
    """With ``PPTORCH_METRICS_PORT=0`` a fit serves its registry and run
    state on an ephemeral 127.0.0.1 port; a scrape from inside the
    fit's cluster phase parses as OpenMetrics and shows the open span."""
    import pypardis_tpu_torch.dbscan as tdb

    run = tdb._pad_and_run
    bodies = []

    def scraping(*a, **kw):
        url = f"http://127.0.0.1:{obs.last_http_port()}/metrics"
        with urllib.request.urlopen(url, timeout=5) as r:
            bodies.append(r.read().decode("utf-8"))
        return run(*a, **kw)

    monkeypatch.setattr(tdb, "_pad_and_run", scraping)
    monkeypatch.setenv("PPTORCH_METRICS_PORT", "0")
    m = DBSCAN(device="cpu", **KW).fit(_blobs())
    samples = _parse_openmetrics(bodies[0])
    assert samples['pypardis_open_span{name="cluster",depth="0"}'] >= 0
    assert samples["pypardis_resources_samples"] >= 1
    assert samples["pypardis_run_finished"] == 0
    assert m.report()["export"]["http_port"] == obs.last_http_port()
    assert m._recorder.tracer.sink is None


def test_snapshot_stream_lines_parse(tmp_path):
    rec = obs.RunRecorder()
    path = tmp_path / "snap.jsonl"
    stack = texport.attach_exporters(rec, snapshot_path=str(path),
                                     snapshot_interval_s=0.05)
    try:
        with rec.span("unit.snap_phase"):
            rec.metrics.observe_ms("serving.latency_ms", 2.0)
            time.sleep(0.18)
    finally:
        stack.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines() if ln]
    assert len(lines) >= 2
    for r in lines:
        assert r["schema"] == "pypardis_tpu/metrics_snapshot@1"
        assert "span_hists" in r and "heartbeats" in r
    assert lines[-1]["hists"]["serving.latency_ms"]["count"] == 1
    assert lines[-1]["span_hists"]["span.unit.snap_phase"]["count"] == 1


@pytest.mark.parametrize("flight_pkg", ["port", "jax"])
def test_exporters_tee_with_flight_recorder(tmp_path, flight_pkg):
    """The exporters ride the sink seam beside a flight recorder (either
    package's: the sink surface is one) and restore it on close."""
    rec = obs.RunRecorder()
    fpath = tmp_path / "flight.jsonl"
    cls = FlightRecorder if flight_pkg == "port" else JaxFlight
    flight = cls(str(fpath), flush_interval_s=0.0)
    rec.attach_flight(flight)
    stack = texport.attach_exporters(rec, port=0)
    try:
        with rec.span("unit.tee_phase"):
            rec.event("pair_overflow", total=3, budget=1)
    finally:
        stack.close()
    kinds = [json.loads(ln)["k"] for ln in fpath.read_text().splitlines()
             if ln]
    assert "so" in kinds and "sc" in kinds and "ev" in kinds
    assert stack.state.events == 1 and stack.state.last_event == (
        "pair_overflow")
    assert rec.flight is flight and rec.tracer.sink is flight
    assert rec.metrics.sink is flight


# -- the engine's latency histogram and the load harness --------------------


@pytest.fixture(scope="module")
def engines():
    from pypardis_tpu import DBSCAN as JaxDBSCAN

    X = _blobs()
    ref = JaxDBSCAN(mesh=default_mesh(1), kernel_backend="xla", **KW).fit(X)
    params = {"eps": ref.eps, "min_samples": ref.min_samples,
              "metric": ref.metric, "block": ref.block,
              "precision": ref.precision,
              "kernel_backend": ref.kernel_backend}
    port = dbscan_from_reference(params, X, ref.labels_,
                                 ref.core_sample_mask_, device="cpu")
    return ref, port, X


def test_engine_latency_percentiles_come_from_the_histogram(engines):
    ref, port, _X = engines
    te = QueryEngine.from_model(port, leaves=2, block=32)
    je = JaxEngine.from_model(ref, leaves=2, block=32)
    lat = np.random.default_rng(4).lognormal(mean=1.0, sigma=1.2,
                                             size=500)
    for e in (te, je):
        for v in lat:
            e.recorder.metrics.observe_ms("serving.latency_ms", float(v))
    ts, js = te.serving_stats(), je.serving_stats()
    assert (ts["p50_ms"], ts["p99_ms"]) == (js["p50_ms"], js["p99_ms"])
    assert ts["latency_hist"] == js["latency_hist"]
    assert ts["latency_hist"]["count"] == 500
    assert ts["p50_ms"] == round(te._lat_hist.percentile(50), 3)


def test_drain_observes_and_publishes(engines):
    _ref, port, X = engines
    te = QueryEngine.from_model(port, leaves=2, block=32)
    for i in range(3):
        te.submit(X[i * 10:(i + 1) * 10])
    te.drain()
    st = te.serving_stats()
    assert st["latency_hist"]["count"] == 3 and st["queries"] == 30
    g = te.recorder.metrics.as_dict()["gauges"]
    assert g["serving.queries"] == 30 and g["serving.p99_ms"] >= 0


def test_sustained_load_attaches_the_export_plane(engines, tmp_path,
                                                  monkeypatch):
    _ref, port, _X = engines
    te = QueryEngine.from_model(port, leaves=2, block=32)
    snap = tmp_path / "load.jsonl"
    monkeypatch.setenv("PPTORCH_METRICS_SNAPSHOT", str(snap))
    monkeypatch.setenv("PPTORCH_METRICS_SNAPSHOT_S", "0.1")
    res = sustained_load(te, clients=2, duration_s=0.4, rate_hz=40.0,
                         batch_rows=4, seed=1)
    lines = [json.loads(ln) for ln in snap.read_text().splitlines() if ln]
    assert len(lines) >= 2
    hist = lines[-1]["hists"]["serving.latency_ms"]
    assert hist["count"] == te._lat_hist.count > 0
    assert res["latency_hist"]["schema"] == "pypardis_tpu/hist@1"
    assert te.recorder.tracer.sink is None and te.recorder.flight is None
