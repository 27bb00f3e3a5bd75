"""The port's metrics plane (``obs/export.Histogram``,
``obs/registry.MetricsRegistry``) against the JAX package's modules, and
the handle seam the gateway rides (``handle=`` through the index, the
engine, the live model and ``load_index``; ``CorePointIndex.release``).
"""

import time

import numpy as np
import pytest
import torch

from benchdata import make_separated_blob_data
from pypardis_tpu.obs import export as jexport
from pypardis_tpu.obs import registry as jregistry
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.checkpoint import load_index, save_index
from pypardis_tpu_torch.obs import export, registry
from pypardis_tpu_torch.obs import Histogram, MetricsRegistry, RunRecorder
from pypardis_tpu_torch.serve import QueryEngine


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _samples(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    # Latencies across the buckets' whole range, the overflow, a NaN and
    # exact bucket edges.
    v = np.concatenate([
        10.0 ** rng.uniform(-3.5, 5.5, n),
        [0.0, 1e-3, 1.0, 100.0, 1e5, 2e5, float("nan")],
        np.asarray(export._EDGES_MS[::7]),
    ])
    return v.tolist()


def _same_chunk(fn):
    """Run ``fn`` inside one window chunk of the default histogram, so
    windowed fields cannot differ by a chunk boundary between calls."""
    chunk = Histogram().window_s / export._WINDOW_CHUNKS
    while True:
        c0 = int(time.monotonic() / chunk)
        out = fn()
        if int(time.monotonic() / chunk) == c0:
            return out


def test_bucket_edges_and_schema_are_the_jax_packages():
    assert export._EDGES_MS == jexport._EDGES_MS
    assert export.HIST_SCHEMA == jexport.HIST_SCHEMA == "pypardis_tpu/hist@1"
    counts = [0] * 65
    for i, c in ((3, 5), (10, 1), (40, 7), (64, 2)):
        counts[i] = c
    for q in (0, 1, 50, 90, 99, 100):
        assert export._pct_from_counts(counts, q, 123.4) == \
            jexport._pct_from_counts(counts, q, 123.4)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_snapshot_and_percentiles_equal_the_jax_ones(seed):
    vals = _samples(seed)
    now = time.monotonic()
    ours, theirs = Histogram(window_s=60.0), jexport.Histogram(window_s=60.0)
    for i, v in enumerate(vals):
        # Half the samples land in chunks long gone from the window.
        t = now - (0.0 if i % 2 else 600.0)
        ours.observe(v, now_s=t)
        theirs.observe(v, now_s=t)
    snaps = _same_chunk(lambda: (ours.snapshot(), theirs.snapshot()))
    assert snaps[0] == snaps[1]
    assert snaps[0]["count"] == len(vals) - 1  # the NaN is dropped
    for q in (1, 50, 90, 99, 99.9):
        for window in (True, False):
            got = _same_chunk(lambda: (ours.percentile(q, window),
                                       theirs.percentile(q, window)))
            assert got[0] == got[1], (q, window)
    assert ours.window_count == theirs.window_count
    assert ours.nbytes == theirs.nbytes
    # Pooling: merge_from and clone keep the lifetime counts.
    other = Histogram(window_s=60.0)
    other.observe(3.0)
    merged = ours.clone().merge_from(other)
    jother = jexport.Histogram(window_s=60.0)
    jother.observe(3.0)
    jmerged = theirs.clone().merge_from(jother)
    assert merged.percentile(99, window=False) == \
        jmerged.percentile(99, window=False)
    assert (merged.count, merged.max_ms) == (jmerged.count, jmerged.max_ms)


def test_from_snapshot_round_trips_across_packages():
    h = Histogram(window_s=30.0)
    for v in _samples(3, 500):
        h.observe(v)
    snap = h.snapshot()
    for cls in (Histogram, jexport.Histogram):
        back = cls.from_snapshot(snap)
        assert back.window_s == 30.0
        assert back.count == h.count and back._life == h._life
        assert back.percentile(99, window=False) == \
            h.percentile(99, window=False)
    # A JAX snapshot rebuilds in the port.
    j = jexport.Histogram.from_snapshot(snap)
    assert Histogram.from_snapshot(j.snapshot())._life == h._life


def test_window_knob_takes_the_port_prefix(monkeypatch):
    monkeypatch.setenv("PPTORCH_HIST_WINDOW_S", "12")
    assert Histogram().window_s == 12.0
    monkeypatch.setenv("PPTORCH_HIST_WINDOW_S", "junk")
    assert Histogram().window_s == 60.0
    assert Histogram(window_s=0.1).window_s == 0.5


@pytest.mark.parametrize("s", [
    "m00", "Tenant-A", "big model/v2", "", "ünïcode", "a.b.c", "__", 42,
    "UPPER_case 9",
])
def test_sanitize_segment_equals_the_jax_one(s):
    assert registry.sanitize_segment(s) == jregistry.sanitize_segment(s)
    registry.validate_key(f"gateway.model.{registry.sanitize_segment(s)}"
                          ".evictions")


def _reg_mod(reg):
    return registry if isinstance(reg, MetricsRegistry) else jregistry


def _drive(reg):
    """The gateway's key pattern, plus every write surface."""
    for mid in ("big", "m1", "live"):
        sid = _reg_mod(reg).sanitize_segment(mid)
        reg.inc("gateway.evictions")
        reg.inc(f"gateway.model.{sid}.evictions", np.int64(2))
        reg.set(f"gateway.model.{sid}.index_bytes", np.int64(1 << 20))
        reg.set(f"gateway.model.{sid}.resident", 1)
    for i, tenant in enumerate(("t00", "Hot Tenant")):
        sid = _reg_mod(reg).sanitize_segment(tenant)
        for v in (0.5, 2.0, 40.0 + i):
            reg.observe_ms(f"gateway.tenant.{sid}.latency_ms", v)
        reg.inc(f"gateway.tenant.{sid}.shed_total", 3)
    reg.observe("phase.refresh", 0.25)
    reg.observe("phase.refresh", np.float64(0.75))
    reg.hist("gateway.extra", window_s=30.0).observe(7.0)
    reg.load_hist("gateway.loaded", {"buckets": [[1.0, 4]], "count": 4,
                                     "sum_ms": 3.5, "max_ms": 1.0})


def test_registry_as_dict_equals_the_jax_one():
    ours, theirs = MetricsRegistry(), jregistry.MetricsRegistry()
    _drive(ours)
    _drive(theirs)
    a, b = _same_chunk(lambda: (ours.as_dict(), theirs.as_dict()))
    assert a == b
    assert a["counters"]["gateway.evictions"] == 3
    assert ours.counter("gateway.tenant.hot_tenant.shed_total") == 3
    assert ours.gauges_with_prefix("gateway.model.m1") == \
        theirs.gauges_with_prefix("gateway.model.m1")
    assert ours.counters_with_prefix("gateway.tenant") == \
        theirs.counters_with_prefix("gateway.tenant")
    # Merging: counters add, gauges take the newer, timings pool.
    other, jother = MetricsRegistry(), jregistry.MetricsRegistry()
    _drive(other)
    _drive(jother)
    ours.merge(other)
    theirs.merge(jother)
    a, b = _same_chunk(lambda: (ours.as_dict(), theirs.as_dict()))
    assert a == b and a["timings"]["phase.refresh"]["count"] == 4
    with pytest.raises(ValueError, match="violates the schema"):
        ours.inc("Bad Key")
    assert isinstance(RunRecorder().metrics, MetricsRegistry)


# -- the handle seam --------------------------------------------------------


def _model():
    X, _t, _c = make_separated_blob_data(
        300, 3, n_centers=4, std=0.35, min_sep=6.0, spread=10.0, seed=2)
    return DBSCAN(eps=1.0, min_samples=5, block=128,
                  device="cpu").fit(X), X


def test_serving_stats_name_the_handle():
    m, X = _model()
    assert QueryEngine.from_model(m).serving_stats()["model"] == "default"
    eng = QueryEngine.from_model(m, handle="fleet-7")
    assert eng.index.handle == "fleet-7" and eng.handle == "fleet-7"
    assert eng.serving_stats()["model"] == "fleet-7"
    # An engine over a named index takes its handle; one given wins.
    assert QueryEngine(eng.index).handle == "fleet-7"
    assert QueryEngine(eng.index, handle="x").serving_stats()["model"] == "x"
    live = m.live(handle="lv", warm=False)
    assert live.stats["model"] == "lv"
    assert live.index.handle == "lv"
    assert live.engine.serving_stats()["model"] == "lv"


def test_load_index_takes_a_handle(tmp_path):
    m, X = _model()
    eng = QueryEngine.from_model(m)
    path = str(tmp_path / "idx.npz")
    save_index(eng.index, path)
    idx = load_index(path, handle="m9", device="cpu")
    assert idx.handle == "m9" and idx.device.type == "cpu"
    assert QueryEngine(idx).serving_stats()["model"] == "m9"
    assert load_index(path, device="cpu").handle is None
    np.testing.assert_array_equal(QueryEngine(idx).predict(X[:50]),
                                  eng.predict(X[:50]))


def test_release_drops_the_device_tensors_and_a_dispatch_raises():
    m, X = _model()
    eng = QueryEngine.from_model(m, handle="r")
    eng.predict(X[:10])
    idx = eng.index
    held = idx.device_tensors()
    nbytes = idx.index_device_bytes
    assert nbytes > 0
    assert idx.release() == nbytes
    assert idx._dev is None and idx.index_device_bytes == 0
    # The host mirrors stay whole.
    assert idx.coords.shape[1] == held[0].shape[1]
    assert np.array_equal(idx.labels, held[1].numpy())
    with pytest.raises(RuntimeError, match="released"):
        eng.predict(X[:10])
    with pytest.raises(RuntimeError, match="released"):
        idx.kernel_tables()
    idx2 = QueryEngine.from_model(m).index
    idx2.begin_update()
    with pytest.raises(RuntimeError, match="delta update open"):
        idx2.release()
