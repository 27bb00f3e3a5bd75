"""The port's multi-tenant gateway (``serve/gateway.py``) on the CPU,
case by case after ``tests/test_gateway.py``, and against the JAX
package's gateway on the same fleet and the same sequence of operations.

Each case of the JAX file has a counterpart here (eviction and
readmission byte-identity with the exact LRU victims, pinned models, the
epoch swap under ``gateway_load``, quota isolation, stale handles,
unknown and double registrations, the live handle);
``test_admit_fault_site_sheds_upstream``'s is in
``tests/test_torch_faults.py``.  Then the
two gateways run one sequence (registrations, serves, a budget, a
readmission, quotas, a refresh): their ``gateway_report()``s are equal
in every field but the latency ones, their answers are bitwise equal,
and a spill written by either package loads in the other's
``load_index`` and serves the same answers.
"""

import numpy as np
import pytest
import torch

from benchdata import make_separated_blob_data
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import checkpoint as jckpt
from pypardis_tpu.parallel.mesh import default_mesh
from pypardis_tpu.serve import ModelGateway as JaxGateway
from pypardis_tpu.serve import QueryEngine as JaxEngine
from pypardis_tpu.serve import TenantQuotaExceeded as JaxShed
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.checkpoint import load_index, save_index
from pypardis_tpu_torch.serve import (
    GatewayError,
    ModelGateway,
    ModelNotRegistered,
    QueryEngine,
    StaleModelHandle,
    TenantQuotaExceeded,
    gateway_load,
)

EPS, MS = 1.0, 5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _data(seed=0, n=300, dim=4):
    X, _truth, _centers = make_separated_blob_data(
        n, dim, n_centers=4, std=0.35,
        min_sep=2 * EPS + 6 * 0.35 + 1.0, spread=10.0, seed=seed,
    )
    return X


def _fit(seed=0, n=300, dim=4):
    X = _data(seed, n, dim)
    return DBSCAN(eps=EPS, min_samples=MS, block=128,
                  device="cpu").fit(X), X


def _jax_fit(X):
    return JaxDBSCAN(eps=EPS, min_samples=MS, mesh=default_mesh(1),
                     block=128).fit(X)


def _fleet(gw, k=3):
    fleet = {}
    for i in range(k):
        m, X = _fit(seed=i)
        mid = f"m{i:02d}"
        gw.register(mid, m)
        fleet[mid] = (m, X)
    return fleet


def test_eviction_reload_byte_identity(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    fleet = _fleet(gw, 3)
    pre = {mid: m.predict(X[:40]) for mid, (m, X) in fleet.items()}
    for mid, (m, X) in fleet.items():
        np.testing.assert_array_equal(gw.predict(mid, X[:40]), pre[mid])
    slabs = {mid: tuple(t.clone() for t in gw.handle(mid).index
                        .device_tensors()) for mid in fleet}

    # The budget fits ~2 of the 3 residents: the least recently served
    # (m00) is the victim.
    per = gw.handle("m01").index_bytes
    gw.budget_bytes = int(per * 2.5)
    victim_index = gw._handles["m00"].index
    gw._ensure_budget(keep="m02")
    rep = gw.gateway_report()
    assert rep["evictions"] == 1
    assert rep["resident_models"] == 2
    evicted = [m for m, b in rep["models"].items() if not b["resident"]]
    assert evicted == ["m00"]
    spills = list(tmp_path.glob("*.npz"))
    assert len(spills) == 1 and spills[0].stem == "m00"
    # The victim's device tensors are gone, and a dispatch raises.
    assert victim_index._dev is None and victim_index._tables is None
    with pytest.raises(RuntimeError, match="released"):
        victim_index.device_tensors()

    # Readmission on demand: the slabs reload byte for byte, the answers
    # are bitwise the pre-eviction ones, and the reload displaced the
    # new least recently served resident (m02: the handle("m01") probe
    # touched m01).
    np.testing.assert_array_equal(
        gw.predict("m00", fleet["m00"][1][:40]), pre["m00"]
    )
    back = gw._handles["m00"].index
    assert back.handle == "m00" and back.device.type == "cpu"
    for a, b in zip(back.device_tensors(), slabs["m00"]):
        assert torch.equal(a, b)
    rep = gw.gateway_report()
    assert rep["reloads"] == 1
    assert rep["evictions"] == 2
    assert rep["models"]["m00"]["resident"]
    assert not rep["models"]["m02"]["resident"]
    assert rep["models"]["m01"]["resident"]


def test_pinned_models_never_evicted(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    m0, X0 = _fit(seed=0)
    m1, _ = _fit(seed=1)
    gw.register("keep", m0, pin=True)
    gw.register("spare", m1)
    gw.budget_bytes = 1  # nothing fits; only the unpinned spills
    gw._ensure_budget(keep="")
    rep = gw.gateway_report()
    assert rep["models"]["keep"]["resident"]
    assert not rep["models"]["spare"]["resident"]
    np.testing.assert_array_equal(
        gw.predict("keep", X0[:8]), m0.predict(X0[:8])
    )
    assert gw.gateway_report()["reloads"] == 0


def test_largest_policy_evicts_the_largest(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path), eviction="largest")
    small, _ = _fit(seed=0, n=200)
    large, _ = _fit(seed=1, n=600)
    gw.register("large", large)
    gw.register("small", small)
    gw.predict("small", _data(0, 200)[:4])  # small is now the MRU
    gw.budget_bytes = gw.resident_bytes() - 1
    gw._ensure_budget(keep="")
    rep = gw.gateway_report()
    assert not rep["models"]["large"]["resident"]
    assert rep["models"]["small"]["resident"]
    with pytest.raises(ValueError, match="eviction policy"):
        ModelGateway(spill_dir=str(tmp_path), eviction="fifo")


def test_epoch_swap_under_load_zero_drops(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    fleet = _fleet(gw, 3)
    m_new, X_new = _fit(seed=7)

    res = gateway_load(
        gw, list(fleet), tenants=3, clients_per_tenant=1,
        duration_s=1.2, rate_hz=120.0, batch_rows=4, seed=3,
        refresh_at_s=0.4,
        refresher=lambda: gw.refresh("m02", m_new),
    )
    assert res["dropped_tickets"] == 0
    assert res["deadline_failures"] == 0
    assert res["gateway"]["epoch_swaps"] == 1
    assert res["queries"] > 0
    np.testing.assert_array_equal(
        gw.predict("m02", X_new[:30]), m_new.predict(X_new[:30])
    )
    tenants = res["gateway"]["tenants"]
    assert {"t00", "t01", "t02"} <= set(tenants)
    for st in tenants.values():
        assert np.isfinite(st["p99_ms"])


def test_quota_shedding_isolates_tenants(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    m, X = _fit(seed=0)
    gw.register("m00", m)
    gw.set_quota("hot", qps=0.001, burst=3)
    hot_ok = hot_shed = 0
    for _ in range(10):
        try:
            gw.predict("m00", X[:4], tenant="hot")
            hot_ok += 1
        except TenantQuotaExceeded:
            hot_shed += 1
    for _ in range(10):
        gw.predict("m00", X[:4], tenant="quiet")
    assert hot_ok == 3 and hot_shed == 7
    rep = gw.gateway_report()
    assert rep["tenants"]["hot"]["shed"] == 7
    assert rep["tenants"]["quiet"]["shed"] == 0
    assert rep["tenants"]["quiet"]["admitted"] == 10
    assert rep["tenants"]["quiet"]["failed"] == 0
    assert rep["admission_sheds"] == 7
    counters = gw.recorder.metrics.as_dict()["counters"]
    assert counters["gateway.tenant.hot.shed_total"] == 7


def test_stale_handle_rejected_after_refit(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    m, X = _fit(seed=0)
    gw.register("m00", m)
    gw.predict("m00", X[:4])
    m.fit(X)
    with pytest.raises(StaleModelHandle, match="refit after"):
        gw.predict("m00", X[:4])
    gw.refresh("m00")
    np.testing.assert_array_equal(
        gw.predict("m00", X[:30]), m.predict(X[:30])
    )


def test_refit_while_evicted_stays_stale(tmp_path):
    """A readmitted engine compares against the generation registered,
    so a refit during the eviction is refused too; ``refresh`` of an
    evicted handle rebuilds from the new model and drops the spill."""
    gw = ModelGateway(spill_dir=str(tmp_path))
    m, X = _fit(seed=0)
    m1, _ = _fit(seed=1)
    gw.register("m00", m)
    gw.register("m01", m1)
    gw.budget_bytes = 1
    gw._ensure_budget(keep="m01")
    assert not gw.gateway_report()["models"]["m00"]["resident"]
    m.fit(X)
    with pytest.raises(StaleModelHandle):
        gw.predict("m00", X[:4])
    gw.refresh("m00")
    rep = gw.gateway_report()
    assert rep["models"]["m00"]["epoch_swaps"] == 1
    assert not list(tmp_path.glob("m00.npz"))
    np.testing.assert_array_equal(
        gw.predict("m00", X[:30]), m.predict(X[:30])
    )


def test_unknown_model_and_double_register(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    m, X = _fit(seed=0)
    with pytest.raises(ModelNotRegistered, match="no model 'nope'"):
        gw.predict("nope", X[:2])
    gw.register("m00", m)
    with pytest.raises(GatewayError, match="already registered"):
        gw.register("m00", m)
    index = gw._handles["m00"].index
    gw.unregister("m00")
    assert index._dev is None  # released
    with pytest.raises(ModelNotRegistered):
        gw.predict("m00", X[:2])
    with pytest.raises(ModelNotRegistered):
        gw.unregister("m00")


def test_live_handle_is_pinned_and_writable(tmp_path):
    gw = ModelGateway(spill_dir=str(tmp_path))
    m, X = _fit(seed=0)
    h = gw.register("m00", m, live=True)
    assert h.pinned and h.live is not None
    assert h.live.handle == "m00" and h.index.handle == "m00"
    assert h.live.stats["model"] == "m00"
    q = X[:1] + 0.05
    h.live.insert(q)
    labs = gw.predict("m00", q)
    assert labs[0] == h.live.labels()[-1]
    with pytest.raises(GatewayError, match="live handle"):
        gw.refresh("m00")


def test_knobs_take_the_port_prefix(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTORCH_GATEWAY_BUDGET_BYTES", "12345")
    monkeypatch.setenv("PPTORCH_GATEWAY_EVICTION", "largest")
    monkeypatch.setenv("PPTORCH_GATEWAY_SPILL_DIR", str(tmp_path / "s"))
    monkeypatch.setenv("PPTORCH_GATEWAY_TENANT_QPS", "2.5")
    monkeypatch.setenv("PPTORCH_GATEWAY_TENANT_BURST", "4")
    gw = ModelGateway()
    assert (gw.budget_bytes, gw.eviction, gw.spill_dir, gw.tenant_qps,
            gw.tenant_burst) == (12345, "largest", str(tmp_path / "s"),
                                 2.5, 4.0)
    monkeypatch.delenv("PPTORCH_GATEWAY_SPILL_DIR")
    assert ModelGateway().spill_dir.endswith(
        ".cache/pypardis_tpu_torch/gateway")


# -- against the JAX gateway ------------------------------------------------

_LATENCY = ("p50_ms", "p99_ms", "latency_hist")


def _sequence(gw, fits, new_fit, tenants_out, shed_cls):
    """One sequence of operations: serve the fleet, enforce a budget,
    readmit, shed a hot tenant, refresh one model, drain."""
    answers = []
    for mid, (m, X) in fits.items():
        answers.append(gw.predict(mid, X[:40], tenant="a",
                                  return_distance=True))
    per = gw._handles["m01"].index_bytes
    gw.budget_bytes = int(per * 2.5)
    gw._ensure_budget(keep="m02")
    answers.append(gw.predict("m00", fits["m00"][1][:40], tenant="b",
                              return_distance=True))
    gw.set_quota("hot", qps=0.001, burst=2)
    for _ in range(5):
        try:
            gw.predict("m01", fits["m01"][1][:4], tenant="hot")
        except shed_cls:
            tenants_out.append("shed")
    gw.refresh("m01", new_fit)
    for mid, (m, X) in fits.items():
        answers.append(gw.predict(mid, X[:40], tenant="c",
                                  return_distance=True))
    gw.drain()
    return answers


def _strip(rep):
    rep = dict(rep)
    rep["tenants"] = {
        t: {k: v for k, v in st.items() if k not in _LATENCY}
        for t, st in rep["tenants"].items()
    }
    return rep


def test_same_sequence_same_report_and_answers_as_the_jax_gateway(tmp_path):
    data = {f"m{i:02d}": _data(seed=i) for i in range(3)}
    X_new = _data(seed=7)
    port_fits = {mid: (DBSCAN(eps=EPS, min_samples=MS, block=128,
                              device="cpu").fit(X), X)
                 for mid, X in data.items()}
    jax_fits = {mid: (_jax_fit(X), X) for mid, X in data.items()}
    pgw = ModelGateway(spill_dir=str(tmp_path / "port"))
    jgw = JaxGateway(spill_dir=str(tmp_path / "jax"))
    for mid in data:
        pgw.register(mid, port_fits[mid][0])
        jgw.register(mid, jax_fits[mid][0])
    victims = {"port": [], "jax": []}
    for name, gw in (("port", pgw), ("jax", jgw)):
        evict = gw._evict

        def recorded(h, _e=evict, _v=victims[name]):
            _v.append(h.model_id)
            return _e(h)
        gw._evict = recorded
    p_shed, j_shed = [], []
    p_ans = _sequence(pgw, port_fits, DBSCAN(
        eps=EPS, min_samples=MS, block=128, device="cpu").fit(X_new), p_shed,
        TenantQuotaExceeded)
    j_ans = _sequence(jgw, jax_fits, _jax_fit(X_new), j_shed, JaxShed)
    assert victims["port"] == victims["jax"] == ["m00", "m01", "m02", "m00"]
    assert len(p_shed) == len(j_shed) == 3
    for (pl, pd), (jl, jd) in zip(p_ans, j_ans):
        np.testing.assert_array_equal(pl, np.asarray(jl))
        assert np.array_equal(np.float32(pd).view(np.int32),
                              np.float32(jd).view(np.int32))
    pr, jr = pgw.gateway_report(), jgw.gateway_report()
    assert _strip(pr) == _strip(jr)
    assert pr["evictions"] == 4 and pr["reloads"] == 3
    assert pr["epoch_swaps"] == 1 and pr["admission_sheds"] == 3
    # The latency fields are there, with the JAX keys and schema.
    for t, st in pr["tenants"].items():
        assert st["latency_hist"]["schema"] == "pypardis_tpu/hist@1"
        assert set(st["latency_hist"]) == set(jr["tenants"][t]
                                              ["latency_hist"])
    # The registries carry the same keys after the same sequence.
    pm = pgw.recorder.metrics.as_dict()
    jm = jgw.recorder.metrics.as_dict()
    assert pm["counters"] == jm["counters"]
    assert pm["gauges"] == {k: v for k, v in jm["gauges"].items()
                            if k.startswith("gateway.")}
    assert set(pm["hists"]) == {k for k in jm["hists"]
                                if k.startswith("gateway.")}


def test_spills_cross_load_both_ways(tmp_path):
    X = _data(seed=4)
    pm = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    jm = _jax_fit(X)
    Q = np.concatenate([X[:60], np.random.default_rng(0).uniform(
        X.min(0) - 1, X.max(0) + 1, size=(40, X.shape[1]))])
    want = pm.query_engine().predict(Q, return_distance=True)
    for name, model, gw_cls in (("port", pm, ModelGateway),
                                ("jax", jm, JaxGateway)):
        gw = gw_cls(spill_dir=str(tmp_path / name))
        gw.register("m", model)
        gw.register("pin", model, pin=True)
        gw.budget_bytes = 1
        gw._ensure_budget(keep="pin")
        assert not gw.gateway_report()["models"]["m"]["resident"]
    p_spill, j_spill = tmp_path / "port" / "m.npz", tmp_path / "jax" / "m.npz"
    # The port's spill served by the JAX package, and the other way.
    j_idx = jckpt.load_index(str(p_spill), handle="m")
    labs, dist = JaxEngine(j_idx).predict(Q, return_distance=True)
    np.testing.assert_array_equal(np.asarray(labs), want[0])
    assert np.array_equal(np.float32(dist).view(np.int32),
                          want[1].view(np.int32))
    p_idx = load_index(str(j_spill), handle="m", device="cpu")
    assert p_idx.handle == "m"
    labs, dist = QueryEngine(p_idx).predict(Q, return_distance=True)
    np.testing.assert_array_equal(labs, want[0])
    assert np.array_equal(dist.view(np.int32), want[1].view(np.int32))
    # A port spill round-trips through the port too, byte for byte.
    back = load_index(str(p_spill), device="cpu")
    save_index(back, str(tmp_path / "again.npz"))
    again = load_index(str(tmp_path / "again.npz"), device="cpu")
    for f in ("coords", "labels", "blo", "bhi", "center"):
        assert np.array_equal(getattr(back, f), getattr(again, f))
