"""The port's load harnesses (``serve/load.py``: ``sustained_load`` and
``gateway_load``) on the CPU.

``test_sustained_load_harness`` and ``test_sustained_mixed_load_with_
compaction`` are ``tests/test_live.py::test_sustained_load_harness`` and
the ``sustained_load`` case of ``tests/test_ingest.py`` (writers, a
``Compactor``, ``compact_at_s``) against the port, each followed by its
check (a refit's ARI 1.0, ``predict`` bitwise the oracle).  The
fault-mode cases shed on a full queue and count missed deadlines
without aborting.  The stats keys of both harnesses are the JAX
package's.  Every run lasts at most 1.5 s, as the JAX tests' do.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

from benchdata import make_separated_blob_data
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel.mesh import default_mesh
from pypardis_tpu.serve import ModelGateway as JaxGateway
from pypardis_tpu.serve import gateway_load as jax_gateway_load
from pypardis_tpu.serve import sustained_load as jax_sustained_load
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.serve import (
    Compactor,
    IngestQueue,
    ModelGateway,
    QueryEngine,
    gateway_load,
    sustained_load,
)

EPS, MS = 1.1, 6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _data(n=600, dim=3, seed=0):
    return make_separated_blob_data(
        n, dim, n_centers=5, std=0.35,
        min_sep=2 * EPS + 6 * 0.35 + 1.0, spread=10.0, seed=seed,
    )


def _fit(n=600, dim=3, seed=0):
    X, _truth, centers = _data(n, dim, seed)
    m = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    return m, X, centers


def _assert_refit_equivalent(live):
    refit = DBSCAN(eps=live.eps, min_samples=live.min_samples, block=128,
                   device="cpu").fit(live.points()).labels_
    ari = adjusted_rand_score(refit, live.labels())
    assert ari == 1.0, f"ARI {ari} vs full refit"


def _assert_oracle_exact(live, Q):
    t = live.engine.submit(Q)
    live.engine.drain()
    olabs, od2 = live.index.oracle_predict(Q)
    np.testing.assert_array_equal(t.labels, olabs)
    np.testing.assert_array_equal(t.d2, od2)


def test_sustained_load_harness():
    m, X, _centers = _fit(n=500)
    live = m.live(leaves=8)
    res = sustained_load(
        live.engine, clients=4, duration_s=0.7, rate_hz=120.0,
        batch_rows=16, write_fraction=0.4, live=live, seed=1,
    )
    assert res["arrival"] == "poisson"
    assert res["clients"] == 4
    assert res["queries"] > 0
    assert res["dropped_tickets"] == 0 and res["shed"] == 0
    for key in ("qps", "p50_ms", "p99_ms", "batch_fill"):
        assert np.isfinite(res[key]), (key, res)
    if res["writes"]:
        assert res["update_visible_p50_ms"] > 0
        assert live.stats["inserts"] == res["writes"]
    assert res["latency_hist"]["schema"] == "pypardis_tpu/hist@1"
    _assert_refit_equivalent(live)


def test_sustained_mixed_load_with_compaction():
    """Mixed read/write load across a background compaction and its
    epoch swap: no dropped or failed ticket, >= 1 swap, the compaction's
    window recorded, ``predict`` bitwise the oracle after."""
    m, X, centers = _fit(n=600, seed=6)
    live = m.live(leaves=8)

    def wsamp(rng, k):
        c = centers[rng.integers(0, len(centers))]
        return c + rng.normal(scale=0.25, size=(k, X.shape[1]))

    comp = Compactor(live)
    res = sustained_load(
        live.engine, clients=2, duration_s=1.2, rate_hz=80.0,
        batch_rows=16, writers=1, write_rate_hz=30.0,
        write_batch_rows=4, write_sampler=wsamp, live=live,
        compactor=comp, compact_at_s=0.2, seed=9,
    )
    assert res["compactions"] >= 1
    assert res["epoch_swaps"] >= 1
    assert res["dropped_tickets"] == 0
    assert res["write_failures"] == 0
    assert res["deadline_failures"] == 0
    assert res["writers"] == 1 and res["write_rows"] > 0
    assert len(comp.windows) == res["compactions"]
    assert all(a < b for a, b in comp.windows)
    for key in ("qps", "write_qps", "p99_ms",
                "read_p99_during_compaction_ms",
                "read_p99_outside_ms",
                "compaction_overlap_degradation"):
        assert np.isfinite(res[key]), (key, res[key])
    _assert_oracle_exact(live, live.points()[:150])
    _assert_refit_equivalent(live)


def test_writers_stamp_update_visible_latency_on_their_tickets():
    m, X, centers = _fit(n=400, seed=2)
    live = m.live(leaves=4, warm=False)
    q = IngestQueue(live)
    seen = []
    flush = q.flush

    def kept():
        out = flush()
        seen.extend(out)
        return out
    q.flush = kept
    res = sustained_load(
        live.engine, clients=1, duration_s=0.6, rate_hz=50.0,
        batch_rows=8, writers=2, write_rate_hz=40.0, write_batch_rows=2,
        delete_fraction=0.3, live=live, ingest=q, seed=4,
        write_sampler=lambda rng, k: centers[0] + rng.normal(
            scale=0.2, size=(k, X.shape[1])),
    )
    # The pump stamps the inserts it flushes (the final flush after the
    # run does not): visible no sooner than applied.
    stamped = [t for t in seen if t.kind == "insert" and not t.failed
               and t.visible_ms is not None]
    assert stamped and all(t.visible_ms >= t.latency_ms > 0
                           for t in stamped)
    assert res["write_rows"] == q.rows and res["write_failures"] == 0
    assert res["update_visible_p50_ms"] > 0
    _assert_refit_equivalent(live)


@pytest.mark.parametrize("mode", ["queue_full", "deadline"])
def test_fault_mode_counts_sheds_and_deadline_failures(mode):
    """A full queue is a shed and a missed deadline a counted failure:
    the harness runs to its end in both cases."""
    m, X, _centers = _fit(n=400, seed=3)
    if mode == "queue_full":
        # max_pending below one request: every submit sheds.
        engine = QueryEngine.from_model(m, max_pending=8)
        res = sustained_load(engine, clients=2, duration_s=0.4,
                             rate_hz=100.0, batch_rows=16, seed=5)
        assert res["shed"] > 0 and res["requests"] == 0
        assert res["shed"] == engine.serving_stats()["shed_total"]
        assert res["queries"] == 0 and res["deadline_failures"] == 0
    else:
        engine = QueryEngine.from_model(m, max_pending=64)
        res = sustained_load(engine, clients=2, duration_s=0.4,
                             rate_hz=100.0, batch_rows=16, seed=5,
                             submit_timeout_s=1e-6)
        assert res["deadline_failures"] > 0
        assert res["deadline_failures"] + res["queries"] // 16 == \
            res["requests"] - res["writes"]
        assert res["submit_timeout_s"] == 1e-6
    assert res["dropped_tickets"] == 0


def test_gateway_load_writes_reach_live_handles(tmp_path):
    fits = [_fit(n=300, seed=s) for s in (11, 12)]
    gw = ModelGateway(spill_dir=str(tmp_path))
    gw.register("ro", fits[0][0])
    h = gw.register("lv", fits[1][0], live=True)
    n0 = h.live.stats["points"]
    res = gateway_load(gw, ["lv", "ro"], tenants=2, clients_per_tenant=1,
                       duration_s=0.6, rate_hz=80.0, batch_rows=4,
                       write_fraction=0.3, seed=2)
    assert res["writes"] > 0
    assert h.live.stats["points"] == n0 + res["writes"]
    assert res["update_visible_p50_ms"] > 0
    assert res["dropped_tickets"] == 0 and res["deadline_failures"] == 0
    assert set(res["shed_by_tenant"]) == {"t00", "t01"}
    _assert_refit_equivalent(h.live)


def test_stats_keys_equal_the_jax_harnesses(tmp_path):
    X, _truth, _c = _data(n=300, seed=8)
    port = DBSCAN(eps=EPS, min_samples=MS, block=128, device="cpu").fit(X)
    jax = JaxDBSCAN(eps=EPS, min_samples=MS, mesh=default_mesh(1),
                    block=128).fit(X)
    kw = dict(clients=1, duration_s=0.3, rate_hz=40.0, batch_rows=8,
              seed=1)
    ours = sustained_load(port.query_engine(), **kw)
    theirs = jax_sustained_load(jax.query_engine(), **kw)
    assert set(ours) == set(theirs)
    assert set(ours["latency_hist"]) == set(theirs["latency_hist"])
    gkw = dict(tenants=1, duration_s=0.3, rate_hz=40.0, batch_rows=4,
               seed=1)
    pgw = ModelGateway(spill_dir=str(tmp_path / "p"))
    pgw.register("m", port)
    jgw = JaxGateway(spill_dir=str(tmp_path / "j"))
    jgw.register("m", jax)
    ours = gateway_load(pgw, ["m"], **gkw)
    theirs = jax_gateway_load(jgw, ["m"], **gkw)
    assert set(ours) == set(theirs)
    assert set(ours["gateway"]) == set(theirs["gateway"])
    assert set(ours["gateway"]["models"]["m"]) == \
        set(theirs["gateway"]["models"]["m"])
    assert set(ours["gateway"]["tenants"]["t00"]) == \
        set(theirs["gateway"]["tenants"]["t00"])
