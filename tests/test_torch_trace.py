"""The port's telemetry core (``obs/trace.py``, ``obs/recorder.py``,
``obs/registry.py``, ``utils/log.py``, ``utils/profiling.py``) on the
CPU against the JAX package's: the same operations on both packages'
registries, tracers and recorders give the same dumps, span trees,
Chrome traces and event logs.  Counterparts of the unit tests of
``tests/test_obs.py``; the JAX ``sync_on`` test's counterpart holds the
port's CUDA-event wait (on the CPU a no-op; on the card
``tests/test_torch_card.py`` and ``chip_smoke.py`` phase 14.1)."""

import json

import numpy as np
import pytest
import torch

from pypardis_tpu import obs as jobs
from pypardis_tpu.utils import log as jlog
from pypardis_tpu.utils import profiling as jprof
from pypardis_tpu_torch import obs
from pypardis_tpu_torch.utils import log as tlog
from pypardis_tpu_torch.utils import profiling as tprof

PKGS = {"jax": jobs, "port": obs}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _both(fn):
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def _timings(d):
    """A registry dump without its windowed histogram counts (they move
    with the wall clock between the two packages' calls)."""
    d = dict(d)
    d["hists"] = {k: {f: v for f, v in h.items()
                      if f not in ("window_count", "p50_ms", "p99_ms")}
                  for k, h in d.get("hists", {}).items()}
    return d


# -- MetricsRegistry ------------------------------------------------------


def test_registry_counter_gauge_timing():
    def run(pkg):
        reg = pkg.MetricsRegistry()
        reg.inc("events.retry.restage")
        reg.inc("events.retry.restage", 2)
        reg.set("sharded.halo_factor", 0.25)
        reg.observe("phase.cluster", 1.0)
        reg.observe("phase.cluster", 3.0)
        return _timings(reg.as_dict())

    got = _both(run)
    assert got["port"] == got["jax"]
    t = got["port"]["timings"]["phase.cluster"]
    assert (t["count"], t["total_s"], t["min_s"], t["max_s"]) == (
        2, 4.0, 1.0, 3.0)


@pytest.mark.parametrize("bad", ["Upper.case", "spa ce", "", "trailing.",
                                 ".leading", "dash-key"])
def test_registry_rejects_bad_keys(bad):
    for pkg in PKGS.values():
        with pytest.raises(ValueError):
            pkg.MetricsRegistry().inc(bad)


def test_registry_numpy_values_become_python():
    def run(pkg, extra):
        reg = pkg.MetricsRegistry()
        reg.set("run.n_partitions", np.int32(8))
        reg.inc("events.compile", np.int64(1))
        reg.observe("phase.x", np.float32(0.5))
        for k, v in extra.items():
            reg.set(k, v)
        d = reg.as_dict()
        json.dumps(d)
        return d

    port = run(obs, {"run.live_pairs": torch.tensor(7)})
    jax = run(jobs, {"run.live_pairs": np.int64(7)})
    assert _timings(port) == _timings(jax)
    assert isinstance(port["gauges"]["run.n_partitions"], int)
    assert isinstance(port["gauges"]["run.live_pairs"], int)


def test_registry_merge_semantics():
    def run(pkg):
        a, b = pkg.MetricsRegistry(), pkg.MetricsRegistry()
        a.inc("events.compile", 1)
        b.inc("events.compile", 2)
        a.set("run.n_partitions", 4)
        b.set("run.n_partitions", 8)
        a.observe("phase.cluster", 1.0)
        b.observe("phase.cluster", 3.0)
        return _timings(a.merge(b).as_dict())

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"]["counters"]["events.compile"] == 3
    assert got["port"]["gauges"]["run.n_partitions"] == 8


# -- Tracer / spans --------------------------------------------------------


def _tree(tracer):
    return [(s.name, s.depth, dict(s.attrs)) for s in tracer.spans]


def test_span_nesting_depths_and_durations():
    def run(pkg):
        tr = pkg.Tracer()
        with tr.span("outer"):
            with tr.span("inner", stage=1):
                pass
        return tr

    got = _both(run)
    assert _tree(got["port"]) == _tree(got["jax"]) == [
        ("inner", 1, {"stage": 1}), ("outer", 0, {})]
    inner, outer = got["port"].spans
    assert 0 <= inner.dur_s <= outer.dur_s
    assert outer.t0_s <= inner.t0_s
    assert inner.t0_s + inner.dur_s <= outer.t0_s + outer.dur_s + 1e-6
    d = got["port"].durations()
    assert d["outer"] >= d["inner"]


def test_span_sync_on_blocks_on_device_work():
    """``sync_on`` takes the tensors (nested too) and the span consumes
    the wait at exit; CPU tensors add no event.  ``sync=True`` on the
    CPU is a no-op."""
    tr = obs.Tracer(device=torch.device("cpu"))
    with tr.span("compute") as sp:
        y = torch.arange(1024) * 2
        sp.sync_on({"y": y, "pair": (y, [y])})
        assert sp._pending == []
    with tr.span("barrier", sync=True):
        pass
    assert [s.name for s in tr.spans] == ["compute", "barrier"]
    assert all(s._pending is None and s.dur_s >= 0 for s in tr.spans)


def test_a_failure_inside_a_span_still_raises_and_closes_it():
    for pkg in PKGS.values():
        tr = pkg.Tracer()
        with pytest.raises(RuntimeError, match="inside"):
            with tr.span("phase"):
                raise RuntimeError("inside")
        assert [s.name for s in tr.spans] == ["phase"]
        assert tr.spans[0].dur_s is not None


def test_chrome_trace_export_round_trip(tmp_path):
    docs = {}
    for name, pkg in PKGS.items():
        tr = pkg.Tracer()
        with tr.span("fit", n=100):
            with tr.span("cluster", rows=np.int64(5)):
                pass
        tr.add_complete("bridge", tr.epoch_s, 0.25, kind="x")
        path = tr.export_chrome_trace(str(tmp_path / f"{name}.json"))
        docs[name] = json.load(open(path))
    strip = [
        [{k: v for k, v in e.items() if k not in ("ts", "dur", "args")}
         | ({"args": e["args"]} if e["ph"] == "X" else {})
         for e in d["traceEvents"]]
        for d in (docs["port"], docs["jax"])
    ]
    assert strip[0] == strip[1]
    assert docs["port"]["displayTimeUnit"] == docs["jax"]["displayTimeUnit"]
    x = [e for e in docs["port"]["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in x] == ["cluster", "fit", "bridge"]
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in x)
    assert x[0]["args"] == {"rows": 5} and x[1]["args"] == {"n": 100}
    assert x[2]["dur"] == pytest.approx(0.25e6)


def test_span_retention_cap():
    tr = obs.Tracer()
    tr.MAX_SPANS = 3
    for i in range(5):
        tr.add_complete(f"s{i}", tr.epoch_s, 0.0)
    assert len(tr.spans) == 3 and tr.dropped == 2


# -- RunRecorder / events / log bridge ------------------------------------


def test_recorder_events_bump_counters():
    def run(pkg):
        rec = pkg.RunRecorder()
        rec.event("pair_overflow", total=10, budget=4)
        rec.event("retry.restage", wait_s=10)
        rec.event("retry.restage", wait_s=np.int64(75))
        return rec

    got = _both(run)
    for rec in got.values():
        assert rec.event_counts() == {"pair_overflow": 1, "retry.restage": 2}
    strip = [[{k: v for k, v in e.items() if k != "t_s"} for e in r.events]
             for r in (got["port"], got["jax"])]
    assert strip[0] == strip[1]
    assert strip[0][0] == {"kind": "pair_overflow", "total": 10, "budget": 4}
    assert strip[0][2]["wait_s"] == 75 and type(strip[0][2]["wait_s"]) is int


def test_current_is_ambient_outside_a_fit_and_nests():
    for pkg in PKGS.values():
        ambient = pkg.current()
        outer, inner = pkg.RunRecorder(), pkg.RunRecorder()
        with pkg.use_recorder(outer):
            assert pkg.current() is outer
            with pkg.use_recorder(inner):
                pkg.event("merge_unconverged", rounds=2)
                with pkg.span("merge"):
                    pass
            assert pkg.current() is outer
        assert pkg.current() is ambient
        assert inner.event_counts() == {"merge_unconverged": 1}
        assert [s.name for s in inner.tracer.spans] == ["merge"]
        assert outer.event_counts() == {} and not outer.tracer.spans


def test_log_phase_records_into_current_recorder():
    for pkg, log in ((jobs, jlog), (obs, tlog)):
        rec = pkg.RunRecorder()
        with pkg.use_recorder(rec):
            log.log_phase("train", n=100, clusters=3)
        assert rec.event_counts() == {"log.train": 1}
        assert rec.events[0]["n"] == 100


def test_phase_timer_feeds_registry_and_tracer():
    got = {}
    for name, pkg, prof in (("jax", jobs, jprof), ("port", obs, tprof)):
        rec = pkg.RunRecorder()
        with pkg.use_recorder(rec):
            t = prof.PhaseTimer()
            with t.phase("cluster"):
                pass
            with t.phase("cluster"):
                pass
        assert set(t.as_dict()) == {"cluster_s"}
        got[name] = rec
    for rec in got.values():
        reg = rec.metrics.as_dict()
        assert reg["timings"]["phase.cluster"]["count"] == 2
        assert [s.name for s in rec.tracer.spans] == ["cluster", "cluster"]


def test_profile_dir_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(8).sum()
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]


def test_each_thread_records_into_its_own_recorder():
    """The port keeps the current recorder per thread: a fit on a
    background thread (a compaction's refit) and one on the caller's
    thread never record into each other's recorder, and a thread with
    none records into the ambient one."""
    import threading

    main, side = obs.RunRecorder(), obs.RunRecorder()
    inside, done = threading.Event(), threading.Event()

    def worker():
        with obs.use_recorder(side):
            inside.set()
            done.wait(5)
            obs.event("pair_overflow", total=2, budget=1)

    t = threading.Thread(target=worker)
    with obs.use_recorder(main):
        t.start()
        inside.wait(5)
        obs.event("merge_unconverged", rounds=1)
        done.set()
        t.join(5)
        assert obs.current() is main
    assert main.event_counts() == {"merge_unconverged": 1}
    assert side.event_counts() == {"pair_overflow": 1}
    seen = []
    t = threading.Thread(target=lambda: seen.append(obs.current()))
    t.start()
    t.join(5)
    assert seen == [obs.current()] and seen[0] not in (main, side)
