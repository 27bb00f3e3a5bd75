"""``chip_smoke.py``'s phase 14 (run reports and tracing) rehearsed on
the CPU at small sizes: 13.2's recorded chained fit and its report, the
report gates (with the H100 peak row and a device watermark stood in,
since the CPU has neither), the trace hold and the flight hold pass on
the port's CPU fits and fail on a spoiled report, a trace outside its
fit's wall and a replay that lost a span.  14.1's sync hold needs CUDA
events: it runs on the card only."""

import json
import time

import numpy as np
import pytest
import torch

from benchdata import make_blob_data

SIZES = dict(n=4000, eps=2.4, parts=4, block=256)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card_standins(monkeypatch):
    """The H100 peak row and a device watermark where the CPU has
    none: the gates' logic runs, not the card's numbers."""
    from pypardis_tpu_torch.obs import report, resources

    monkeypatch.setattr(report, "_peak_flops",
                        lambda backend=None: (989e12, "table:h100"))
    monkeypatch.setattr(resources, "device_live_bytes",
                        lambda device=None: 1 << 20)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 1 << 30)


def _data(n=SIZES["n"]):
    X, _truth = make_blob_data(n, 16, n_centers=8, std=0.4)
    return X


def test_chained_fit_report_passes_the_gates(card_standins):
    import chip_smoke

    cpu = torch.device("cpu")
    (lab, core, st), wall, kd_s, part, rec = chip_smoke.chained_fit_recorded(
        torch, cpu, lambda: None, _data(), SIZES)
    assert wall > 0 and kd_s > 0 and len(lab) == SIZES["n"]
    assert set(rec["phases"]) == {"partition_s", "cluster_s"}
    assert [s.name for s in rec["recorder"].tracer.spans] == [
        "partition", "sharded.build_shards", "sharded.execute", "cluster"]
    rep = chip_smoke.chained_report(rec)
    json.dumps(rep)
    assert rep["compute"]["live_pairs"] == st["live_pairs"]
    assert rep["sharding"]["n_shard_partitions"] == st["n_shard_partitions"]
    out = chip_smoke.report_gates(torch, cpu, rep, st, "rehearsal chained")
    assert out["peak_device_bytes"] == 1 << 20


def test_fit_report_trace_and_flight_pass(card_standins, tmp_path):
    import chip_smoke
    from pypardis_tpu_torch import DBSCAN

    X = _data()
    m = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu")
    t = time.perf_counter()
    m.fit(X)
    wall = time.perf_counter() - t
    chip_smoke.report_gates(torch, torch.device("cpu"), m.report(),
                            m.metrics_, "rehearsal fit")
    fit = dict(wall=wall, trace=m.export_trace(str(tmp_path / "t.json")))
    assert chip_smoke.trace_hold(fit)["spans"] == [
        "pipeline.layout", "pipeline.cluster", "cluster", "densify"]
    got = chip_smoke.flight_hold(X[:1500], torch.device("cpu"), block=256)
    assert got["spans"] == [
        "pipeline.layout", "pipeline.cluster", "cluster", "densify"]


@pytest.mark.parametrize("spoil", ["nan", "peak", "phases", "passes"])
def test_report_gates_fail_on_a_spoiled_report(card_standins, spoil):
    import chip_smoke
    from pypardis_tpu_torch import DBSCAN

    m = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu").fit(
        _data(1500))
    rep, metrics = m.report(), dict(m.metrics_)
    if spoil == "nan":
        rep["sharding"]["halo_factor"] = float("nan")
    elif spoil == "peak":
        rep["compute"]["peak_source"] = "default"
    elif spoil == "phases":
        rep["phases"]["cluster"] = rep["run"]["total_s"] * 2
    else:
        metrics["kernel_passes"] += 1
    with pytest.raises(SystemExit):
        chip_smoke.report_gates(torch, torch.device("cpu"), rep, metrics,
                                f"spoiled {spoil}")


def test_trace_and_flight_holds_fail(tmp_path, monkeypatch):
    import chip_smoke
    from pypardis_tpu_torch import DBSCAN, obs

    X = _data(1500)
    m = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu").fit(X)
    short = dict(wall=1e-7, trace=m.export_trace(str(tmp_path / "t.json")))
    with pytest.raises(SystemExit):
        chip_smoke.trace_hold(short)
    replay = obs.replay

    def lossy(path):
        rp = replay(path)
        rp.recorder.tracer.spans.pop()
        return rp

    monkeypatch.setattr(obs, "replay", lossy)
    with pytest.raises(SystemExit):
        chip_smoke.flight_hold(X, torch.device("cpu"), block=256)
    assert np.isfinite(m.report()["run"]["total_s"])
