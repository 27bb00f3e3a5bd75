"""The port's run reports (``obs/report.py``, ``DBSCAN.report()``,
``summary()``, ``export_trace()``) on the CPU against the JAX package's.

``build_run_report`` and ``format_summary`` take the same metrics and
recorder contents in both packages and give the same report and text
(a single-route fit on blobs750 and the chained route's stats of both
packages' ``sharded_dbscan``).  A port fit and a JAX fit of the same
data (the JAX one on the fused route, ``default_mesh(1)``,
``kernel_backend="auto"``, which is XLA on the CPU) agree on the
report's keys, params, run, sharding, compute counts, events, phase
names and span tree, timings aside.  The JAX fit is warmed first and
its staging cache cleared, so it has no first-compile event and runs
its layout as the port does; the JAX staging economy's
``staged_bytes``/``staged_bytes_reused`` (not ported, ROADMAP A16 item
10) are left out of the sharding comparison.  The integration cases
are ``tests/test_obs.py``'s that need no mesh.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.preprocessing import StandardScaler

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import obs as jobs
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu.parallel import sharded_dbscan as jax_sharded
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu.utils.hints import PAIR_BUDGET_HINTS
from pypardis_tpu.utils.profiling import PhaseTimer as JaxTimer
from pypardis_tpu_torch import DBSCAN, KDPartitioner, obs
from pypardis_tpu_torch.csrc import _build
from pypardis_tpu_torch.parallel import sharded_dbscan
from pypardis_tpu_torch.utils.profiling import PhaseTimer

STAGING_KEYS = {"staged_bytes", "staged_bytes_reused"}
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pypardis_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _blobs750():
    X, _ = make_blobs(n_samples=750, centers=[[1, 1], [-1, -1], [1, -1]],
                      cluster_std=0.4, random_state=0)
    return StandardScaler().fit_transform(X).astype(np.float64)


KW = dict(eps=0.3, min_samples=10, block=64)


@pytest.fixture(scope="module")
def fits():
    """A port fit and a JAX fit of blobs750, the JAX one warmed and its
    staging cleared."""
    X = _blobs750()
    JaxDBSCAN(mesh=default_mesh(1), **KW).fit(X)
    staging.clear()
    ref = JaxDBSCAN(mesh=default_mesh(1), **KW).fit(X)
    port = DBSCAN(device="cpu", **KW).fit(X)
    return ref, port, X


@pytest.fixture(scope="module")
def chained_stats():
    """The chained route's stats of both packages on blobs750 (4 KD
    partitions), each with its partition and cluster phases and its
    recorder.  Each run starts from a pair budget of 1, so its pair
    ladder overflows once and reruns at the exact total."""
    X = _blobs750()
    out = {}
    staging.clear()
    PAIR_BUDGET_HINTS.clear()
    for name, part_cls, run, timer_cls, pkg, kw in (
        ("port", KDPartitioner, sharded_dbscan, PhaseTimer, obs,
         {"device": "cpu"}),
        ("jax", JaxKD, jax_sharded, JaxTimer, jobs,
         {"mesh": default_mesh(1), "backend": "xla"}),
    ):
        rec = pkg.RunRecorder()
        timer = timer_cls()
        with pkg.use_recorder(rec):
            with timer.phase("partition"):
                part = part_cls(X, max_partitions=4)
            with timer.phase("cluster"):
                _l, _c, stats = run(X, part, **KW, merge="device",
                                    pair_budget=1, **kw)
        stats = dict(stats, **timer.as_dict())
        stats["total_s"] = sum(timer.as_dict().values())
        out[name] = (stats, rec)
    PAIR_BUDGET_HINTS.clear()
    return X, out


def _contents(rec):
    """A recorder's gauges, plain counters and events, to replay."""
    d = rec.metrics.as_dict()
    counters = {k: v for k, v in d["counters"].items()
                if not k.startswith("events.")}
    events = [{k: v for k, v in e.items() if k != "t_s"}
              for e in rec.events]
    return d["gauges"], counters, events


def _replay(pkg, contents):
    gauges, counters, events = contents
    rec = pkg.RunRecorder()
    for k, v in gauges.items():
        rec.metrics.set(k, v)
    for k, v in counters.items():
        rec.metrics.inc(k, v)
    for e in events:
        e = dict(e)
        rec.event(e.pop("kind"), **e)
    return rec


def _build_both(metrics, contents, n, d):
    params = dict(KW, metric="euclidean", precision="high")
    reps = {}
    for name, pkg in (("port", obs), ("jax", jobs)):
        reps[name] = pkg.build_run_report(
            _replay(pkg, contents), params=params, n_points=n, n_dims=d,
            n_devices=1, backend="cpu", metrics=metrics)
    return reps


def _drop_windows(rep):
    """The registry's histogram snapshots without their windowed counts
    (they move with the wall clock between the two builds)."""
    rep = json.loads(json.dumps(rep))
    for h in rep["metrics"].get("hists", {}).values():
        for f in ("window_count", "p50_ms", "p99_ms"):
            h.pop(f, None)
    return rep


@pytest.mark.parametrize("case", ["single", "chained_port", "chained_jax"])
def test_build_run_report_and_summary_equal_the_jax_ones(
        case, fits, chained_stats, monkeypatch):
    if case == "single":
        _ref, port, X = fits
        metrics, rec = port.metrics_, port._recorder
    else:
        X, out = chained_stats
        metrics, rec = out[case.split("_")[1]]
    contents = _contents(rec)
    reps = _build_both(metrics, contents, len(X), X.shape[1])
    # Unpinned: equal but for the peak (the JAX package asks JAX for
    # the device kind, the port asks torch).
    peak = ("peak_flops", "peak_source", "mfu", "mfu_f32_synth")
    for r in reps.values():
        for k in peak:
            r["compute"].pop(k)
    assert _drop_windows(reps["port"]) == _drop_windows(reps["jax"])
    monkeypatch.setenv("PPTORCH_PEAK_FLOPS", "2.5e12")
    monkeypatch.setenv("PYPARDIS_PEAK_FLOPS", "2.5e12")
    reps = _build_both(metrics, contents, len(X), X.shape[1])
    assert _drop_windows(reps["port"]) == _drop_windows(reps["jax"])
    assert reps["port"]["compute"]["peak_source"] == "env"
    assert obs.format_summary(reps["port"]) == jobs.format_summary(
        reps["jax"])
    json.dumps(reps["port"])


def _inner(spans):
    return [(s.name, s.depth) for s in spans]


def test_fit_report_matches_jax(fits, tmp_path):
    ref, port, _X = fits
    r, j = port.report(), ref.report()
    assert sorted(r) == sorted(j)
    assert r["schema"] == j["schema"] == "pypardis_tpu/run_report@1"
    assert r["params"] == j["params"]
    for k in ("n_points", "n_dims", "n_devices"):
        assert r["run"][k] == j["run"][k]
    drop = lambda sh: {k: v for k, v in sh.items() if k not in STAGING_KEYS}
    assert drop(r["sharding"]) == drop(j["sharding"])
    for k in ("live_pairs", "kernel_block", "kernel_passes", "kernel_tiles",
              "model_flops", "live_pair_fraction", "precision_mode",
              "sketch_k", "band_pairs", "rescored_pairs"):
        assert r["compute"][k] == j["compute"][k], k
    assert r["events"] == j["events"]
    assert r["faults"] == j["faults"]
    assert set(r["phases"]) == set(j["phases"]) == {"cluster", "densify"}
    assert r["devices"] == j["devices"]
    assert set(r["resources"]) == set(j["resources"])
    assert _inner(port._recorder.tracer.spans) == _inner(
        ref._recorder.tracer.spans)

    def names(m, which):
        doc = json.load(open(m.export_trace(str(tmp_path / which))))
        return [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]

    assert names(port, "p.json") == names(ref, "j.json") == [
        "pipeline.layout", "pipeline.cluster", "cluster", "densify"]


@pytest.mark.parametrize("kind", ["sweep", "hierarchy"])
def test_sweep_and_hierarchy_reports_match_jax(kind):
    """The sweep and the eps=None fit: the same report keys, params,
    phase names and driver phases in order; the pipeline's inner spans
    by name (the port's graph emission may take its exact-total retry,
    which the JAX CPU route never needs)."""
    X = _blobs750()
    eps = None if kind == "hierarchy" else 0.3
    models = {
        "jax": JaxDBSCAN(eps=eps, min_samples=10, block=64,
                         mesh=default_mesh(1)),
        "port": DBSCAN(eps=eps, min_samples=10, block=64, device="cpu"),
    }
    for m in models.values():
        staging.clear()
        if kind == "sweep":
            m.sweep(X, [0.2, 0.3], [5, 10])
        else:
            m.fit(X)
    r, j = models["port"].report(), models["jax"].report()
    assert sorted(r) == sorted(j)
    # The selected eps: the JAX CPU graph's matmul d^2 moves it by up to
    # ~2e-5 relative (ROADMAP C, tests/test_torch_hierarchy.py).
    sel = [x["params"].pop("eps_selected", None) for x in (r, j)]
    if kind == "hierarchy":
        assert sel[0] == pytest.approx(sel[1], rel=2e-5)
    assert r["params"] == j["params"]
    assert set(r["phases"]) == set(j["phases"])
    assert r["compute"]["live_pairs"] == j["compute"]["live_pairs"]
    block = "sweep" if kind == "sweep" else "hierarchy"
    assert r[block]["k" if kind == "sweep" else "mst_edges"] == (
        j[block]["k" if kind == "sweep" else "mst_edges"])
    sp = {n: models[n]._recorder.tracer.spans for n in models}
    assert [s.name for s in sp["port"] if s.depth == 0] == [
        s.name for s in sp["jax"] if s.depth == 0]
    assert {s.name for s in sp["port"] if s.depth} == {
        s.name for s in sp["jax"] if s.depth}


# -- tests/test_obs.py's integration cases, on one device -----------------


def test_report_schema_single_device(fits):
    _ref, port, _X = fits
    r = port.report()
    json.dumps(r)
    assert set(r["phases"]) == {"cluster", "densify"}
    assert all(v >= 0 for v in r["phases"].values())
    assert r["run"]["total_s"] > 0
    assert (r["run"]["n_points"], r["run"]["n_dims"],
            r["run"]["n_devices"], r["run"]["backend"]) == (750, 2, 1, "cpu")
    assert r["sharding"]["halo_factor"] == 0.0
    assert r["devices"] == {"count": 1, "processes": 1,
                            "partition_sizes": [[750]], "points": [750]}
    assert set(r["events"]) == {
        "restage", "transient_retry", "pair_overflow", "halo_overflow",
        "merge_unconverged", "compile", "fault_injected", "degraded",
    }
    assert r["faults"] == {"injected": 0, "retried": 0, "giveups": 0,
                           "degraded": 0, "degraded_to": ""}
    assert "phase.cluster" in r["metrics"]["timings"]
    assert r["metrics"]["gauges"]["run.live_pairs"] == (
        r["compute"]["live_pairs"])
    assert r["metrics"]["counters"]["events.log.train"] == 1


def test_summary_one_screen(fits):
    s = fits[1].summary()
    assert "750 pts x 2D" in s and "on 1 cpu device(s)" in s
    assert "halo_factor" in s and "events:" in s and "resources:" in s
    assert "compute:" in s and "live-metrics:" not in s
    assert len(s.splitlines()) <= 9


def test_summary_live_metrics_line(tmp_path, monkeypatch):
    snap = tmp_path / "snap.jsonl"
    monkeypatch.setenv("PPTORCH_METRICS_SNAPSHOT", str(snap))
    monkeypatch.setenv("PPTORCH_METRICS_SNAPSHOT_S", "0.1")
    m = DBSCAN(device="cpu", **KW).fit(_blobs750())
    s = m.summary()
    assert "live-metrics:" in s and str(snap) in s
    assert len(s.splitlines()) <= 10
    lines = [ln for ln in snap.read_text().splitlines() if ln]
    assert lines and all(
        json.loads(ln)["schema"] == "pypardis_tpu/metrics_snapshot@1"
        for ln in lines)
    assert m.report()["export"] == {"snapshot_path": str(snap)}


def test_report_compute_single_shard_nonzero():
    X = np.random.default_rng(2).normal(size=(600, 4))
    comp = DBSCAN(eps=0.4, min_samples=5, block=64, device="cpu").fit(
        X).report()["compute"]
    assert comp["live_pairs"] > 0 and comp["kernel_passes"] >= 2
    assert comp["mfu"] > 0 and comp["peak_source"] == "default"
    for k in ("model_flops", "achieved_flops_per_sec", "peak_flops", "mfu"):
        assert math.isfinite(float(comp[k]))


def test_report_single_shard_path():
    X = np.random.default_rng(0).normal(size=(12, 3))
    r = DBSCAN(eps=0.5, min_samples=2, block=64, device="cpu").fit(
        X).report()
    json.dumps(r)
    assert r["run"]["n_devices"] == 1 and r["devices"]["points"] == [12]
    assert r["sharding"]["overlap_efficiency"] == 0.0
    assert r["sharding"]["partition_levels_s"] == []
    assert "cluster" in r["phases"] and "overlap" in r["params"]


def test_refit_resets_telemetry():
    X = np.random.default_rng(1).normal(size=(64, 3))
    m = DBSCAN(eps=0.5, min_samples=3, block=64, device="cpu")
    m.fit(X)
    first_rec = m._recorder
    m.sweep(X, [0.4, 0.5])
    assert "sweep" in m.report() and m._recorder is not first_rec
    m.fit(X)
    second = m.report()
    assert "sweep" not in second and second["run"]["n_points"] == 64
    assert len(m._recorder.tracer.spans) == 4
    assert second["metrics"]["timings"]["phase.cluster"]["count"] == 1


def test_report_and_trace_errors(tmp_path, fits):
    m = DBSCAN(device="cpu")
    for call in (m.report, m.summary,
                 lambda: m.export_trace(str(tmp_path / "x.json"))):
        with pytest.raises(RuntimeError,
                           match=r"not fitted; call fit\(\)/train\(\)"):
            call()
    path = str(tmp_path / "model.npz")
    fits[1].save(path)
    loaded = DBSCAN.load(path, device="cpu")
    assert loaded.report()["run"]["n_points"] == 750
    with pytest.raises(RuntimeError, match="no telemetry recorded"):
        loaded.export_trace(str(tmp_path / "y.json"))


def test_serving_and_live_blocks(fits):
    X = fits[2]
    m = DBSCAN(device="cpu", **KW).fit(X)
    assert "serving" not in m.report()
    m.predict(X[:20])
    srv = m.report()["serving"]
    assert srv["queries"] == 20 and srv["latency_hist"]["count"] >= 1
    assert "serving:" in m.summary()
    m.live(warm=False).insert(X[:3] + 0.01)
    lv = m.report()["live"]
    assert lv["inserts"] == 3 and "live:" in m.summary()


# -- events ---------------------------------------------------------------


def test_pair_overflow_event_recorded_in_both_packages(chained_stats):
    """A forced pair-budget overflow on the chained route records the
    same ``pair_overflow`` count and fields in both packages."""
    counts = {}
    for name, (_stats, rec) in chained_stats[1].items():
        counts[name] = rec.event_counts().get("pair_overflow", 0)
        ev = [e for e in rec.events if e["kind"] == "pair_overflow"]
        assert ev and ev[0]["budget"] == 1 and ev[0]["total"] > 1
        counts[name, "total"] = ev[0]["total"]
    assert counts["port"] == counts["jax"] == 1
    assert counts["port", "total"] == counts["jax", "total"]


def test_merge_unconverged_event_recorded():
    X = _blobs750()
    rec = obs.RunRecorder()
    with obs.use_recorder(rec):
        sharded_dbscan(X, KDPartitioner(X, max_partitions=8), **KW,
                       merge="device", merge_rounds=1, device="cpu")
    ev = [e for e in rec.events if e["kind"] == "merge_unconverged"]
    assert ev and ev[0]["rounds"] == 1 and ev[0]["next"] == 4


def test_chained_route_spans_and_rss_rung(monkeypatch):
    X = _blobs750()
    part = KDPartitioner(X, max_partitions=8)
    rec = obs.RunRecorder()
    with obs.use_recorder(rec):
        _l, _c, dev = sharded_dbscan(X, part, **KW, device="cpu")
        monkeypatch.setenv("PPTORCH_RSS_SOFT_LIMIT", "1")
        _l, _c, host = sharded_dbscan(X, part, **KW, device="cpu")
    assert (dev["merge"], host["merge"]) == ("device", "host")
    names = [(s.name, s.attrs.get("merge")) for s in rec.tracer.spans]
    assert names == [
        ("sharded.build_shards", None), ("sharded.execute", "device"),
        ("sharded.build_shards", None), ("sharded.execute", "host"),
        ("sharded.merge_host", None),
    ]


# -- the kernel build's compile event and the checked build ---------------


def test_kernel_build_records_one_compile_event(tmp_path, monkeypatch):
    """``_build.load`` records ``compile`` (``stage="kernel_build"``)
    when it runs the compiler, and none on a cached load."""
    monkeypatch.setenv("PPTORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    built = []

    def fake_compile(out):
        built.append(out)
        open(out, "w").close()
        _build.BUILD_INFO["seconds"] = 1.5

    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_bind", lambda lib: None)
    rec = obs.RunRecorder()
    with obs.use_recorder(rec):
        _build.load()
        _build.load()
        monkeypatch.setattr(_build, "_lib", None)
        _build.load()
    assert len(built) == 1
    assert rec.event_counts() == {"compile": 1}
    assert rec.events[0]["stage"] == "kernel_build"


def test_checked_build_has_its_own_key(monkeypatch):
    monkeypatch.delenv("PPTORCH_KERNEL_CHECKS", raising=False)
    plain = _build._library_path()
    assert "-DPPT_CHECKED" not in _build.compile_flags()
    monkeypatch.setenv("PPTORCH_KERNEL_CHECKS", "1")
    checked = _build._library_path()
    assert "-DPPT_CHECKED" in _build.compile_flags()
    assert "libpp_kernels_checked_" in os.path.basename(checked)
    assert os.path.dirname(checked) == os.path.dirname(plain)
    assert checked != plain


@pytest.mark.parametrize("src,kernel", [
    ("query_kernels.cu", "query_tables_kernel"),
    ("query_kernels.cu", "query_frames_kernel"),
    ("query_kernels.cu", "query_rows_kernel"),
    ("query_kernels.cu", "query_pass_kernel"),
    ("query_kernels.cu", "query_unpack_kernel"),
    ("pair_kernels.cu", "b1_tc_kernel"),
    ("pair_kernels.cu", "minlab_kernel"),
])
def test_live_path_kernels_guard_their_stores(src, kernel):
    """Every global store of the live path's kernels (an assignment
    through an output pointer, or an atomic on one) sits behind a
    ``PPT_CHECK`` within the three lines before it."""
    text = open(os.path.join(CSRC, src)).read()
    start = text.index(f"{kernel}(")
    end = text.find("__global__", start)
    lines = text[start:end if end > 0 else len(text)].splitlines()
    store = re.compile(
        r"^\s*(if \(.*\)\s*)?(out|pad_keys|leaf_end|slots|flags|grp|keys|c)"
        r"\[[^]]*\]\s*=[^=]|atomicMin\(keys")
    stores = [i for i, ln in enumerate(lines) if store.search(ln)]
    assert stores, kernel
    for i in stores:
        window = "\n".join(lines[max(0, i - 3):i])
        assert "PPT_CHECK" in window, (kernel, lines[i])


@pytest.mark.parametrize("kernel", [
    "query_tables_kernel", "query_frames_kernel", "query_rows_kernel",
    "query_pass_kernel", "query_unpack_kernel",
])
def test_table_guards_check_allocated_extents(kernel):
    """B5's guards hold each index against an extent the kernel takes as
    a ``PPT_EXTENT`` parameter (the output's numel from the wrapper),
    never against ``gridDim`` or another bound that produced the index,
    and the wrappers pass every such numel down."""
    text = open(os.path.join(CSRC, "query_kernels.cu")).read()
    start = text.index(f"{kernel}(")
    end = text.find("__global__", start)
    body = text[start:end if end > 0 else len(text)]
    params = body[:body.index(") {")]
    extents = set(re.findall(r"PPT_EXTENT\((\w+)\)", params))
    assert extents, kernel
    checks = re.findall(r"PPT_CHECK\((.*?),\s*(\w+)\);", body, re.S)
    assert checks, kernel
    for index, extent in checks:
        assert extent in extents, (kernel, index, extent)
        assert "gridDim" not in index + extent, (kernel, index)
    wrappers = open(os.path.join(
        os.path.dirname(CSRC), "ops", "cuda_kernels.py")).read()
    assert "*(t.numel() for t in tables)" in wrappers
    assert "n_keys // 8, n_grp, out.numel()" in wrappers
