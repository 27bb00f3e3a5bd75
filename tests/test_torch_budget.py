"""The port's pair-budget and merge-rounds ladders with the hint cache
(``utils/budget.py``, ``utils/hints.py``) on the CPU.

Counterparts of ``tests/test_convergence_budget.py``'s cases that need
no ring (the port's chained route on ``device="cpu"``): non-convergence
retried at 4x and then raised, the pair-budget overflow rerun seeding
the hint a refit reuses, no hint without an overflow, the host merge's
rerun and the bounded cache; the single route's hint key; each rung's
retries and giveups as counters of the report's faults block; and the
knob-naming cases of ``tests/test_jobstate.py``.  The JAX route's
labels and the same counters are held in
``tests/test_torch_sharded.py::test_merge_rounds_ladder_matches_jax``
and ``tests/test_torch_report.py::
test_pair_overflow_event_recorded_in_both_packages``, which pay for the
JAX runs already."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu_torch import DBSCAN, obs
from pypardis_tpu_torch import dbscan as tdbscan
from pypardis_tpu_torch.parallel import sharded, sharded_dbscan
from pypardis_tpu_torch.partition import KDPartitioner
from pypardis_tpu_torch.utils.budget import run_ladders
from pypardis_tpu_torch.utils.hints import (
    PAIR_BUDGET_HINTS,
    BudgetHintCache,
    dispatch_tag,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_hints():
    PAIR_BUDGET_HINTS.clear()
    yield
    PAIR_BUDGET_HINTS.clear()


def _chain_data(n=256, k=2, step=0.09):
    """A line of points threading every KD partition: one cluster
    chained across all 8."""
    pts = np.zeros((n, k))
    pts[:, 0] = np.arange(n, dtype=np.float64) * step
    return pts


def _blobs(n=1200, seed=1):
    X, _ = make_blobs(n_samples=n, centers=8, n_features=3,
                      cluster_std=0.3, random_state=seed)
    return X


def _faults(rec):
    c = rec.metrics.as_dict()["counters"]
    return {
        "retried": {k: v for k, v in c.items()
                    if k.startswith("retry.") and k.endswith(".attempts")},
        "giveups": {k: v for k, v in c.items()
                    if k.startswith("retry.") and k.endswith(".giveups")},
    }


def _port(X, kw, part=8):
    rec = obs.RunRecorder()
    try:
        with obs.use_recorder(rec):
            res = sharded_dbscan(X, KDPartitioner(X, max_partitions=part),
                                 device="cpu", **kw)
    except RuntimeError as e:
        res = e
    return res, _faults(rec)


CHAIN_KW = dict(eps=0.2, min_samples=2, block=64, merge="device")


def test_nonconvergence_detected_and_retried():
    """merge_rounds=1 cannot certify a fixpoint on the chained line: the
    port retries at 4x and returns the converged one-cluster labels.
    (``tests/test_torch_sharded.py::test_merge_rounds_ladder_matches_jax``
    holds labels and counters against the JAX route.)"""
    X = _chain_data()
    ref = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                         device="cpu", **CHAIN_KW)
    (lab, core, stats), port_faults = _port(
        X, dict(CHAIN_KW, merge_rounds=1))
    assert stats["merge_converged"] is True
    np.testing.assert_array_equal(lab, ref[0])
    np.testing.assert_array_equal(core, ref[1])
    assert lab.max() == lab.min() >= 0
    assert port_faults["retried"] == {"retry.merge_rounds.attempts": 1}


def test_both_rungs_count_their_retries():
    """A one-pair budget and one merge round: each rung retries once,
    each counted under its site (as in the JAX ladder, which
    ``tests/test_torch_report.py`` and ``test_torch_sharded.py`` hold
    rung by rung)."""
    X = _chain_data()
    ref = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                         device="cpu", **CHAIN_KW)
    (lab, _c, _s), port_faults = _port(
        X, dict(CHAIN_KW, pair_budget=1, merge_rounds=1))
    np.testing.assert_array_equal(lab, ref[0])
    assert port_faults == {
        "retried": {"retry.merge_rounds.attempts": 1,
                    "retry.pair_budget.attempts": 1},
        "giveups": {}}


def test_nonconvergence_raises_instead_of_silent_undermerge():
    """Zero rounds (the retry: still too few) raise, with one retry and
    one giveup on the merge_rounds rung."""
    res, port_faults = _port(_chain_data(), dict(CHAIN_KW, merge_rounds=0))
    assert isinstance(res, RuntimeError)
    assert "did not converge" in str(res)
    assert port_faults == {"retried": {"retry.merge_rounds.attempts": 1},
                           "giveups": {"retry.merge_rounds.giveups": 1}}


def _spy_budgets(monkeypatch):
    calls = []
    orig = sharded._chained_tables_overlap

    def spy(*a, **kw):
        calls.append(kw.get("pair_budget"))
        return orig(*a, **kw)

    monkeypatch.setattr(sharded, "_chained_tables_overlap", spy)
    return calls


def test_pair_budget_overflow_rerun_and_hint_reuse(monkeypatch):
    """A too-small budget reruns at the exact total with correct labels,
    the exact budget lands in the hint cache, and the next fit of the
    configuration extracts once under it."""
    X = _blobs()
    kw = dict(eps=0.4, min_samples=5, block=64, merge="device")
    ref = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                         device="cpu", **kw)
    calls = _spy_budgets(monkeypatch)
    (lab, _c, _s), port_faults = _port(X, dict(kw, pair_budget=1))
    np.testing.assert_array_equal(lab, ref[0])
    assert calls[0] == 1 and len(calls) == 2 and calls[1] > 1
    assert len(PAIR_BUDGET_HINTS) == 1  # seeded from the rerun
    assert port_faults["retried"] == {"retry.pair_budget.attempts": 1}
    calls.clear()
    lab, _c, _s = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                 device="cpu", **kw)
    np.testing.assert_array_equal(lab, ref[0])
    assert len(calls) == 1 and calls[0] is not None  # the hint, no rerun


def test_no_hint_seeded_without_overflow(monkeypatch):
    X = _blobs(800, seed=2)
    calls = _spy_budgets(monkeypatch)
    kw = dict(eps=0.4, min_samples=5, block=64, merge="device")
    sharded_dbscan(X, KDPartitioner(X, max_partitions=8), device="cpu",
                   **kw)
    assert calls == [None] and len(PAIR_BUDGET_HINTS) == 0
    calls.clear()
    sharded_dbscan(X, KDPartitioner(X, max_partitions=8), device="cpu",
                   **kw)
    assert calls == [None]


def test_host_merge_budget_rerun():
    X = _blobs(seed=4)
    kw = dict(eps=0.4, min_samples=5, block=64, merge="host")
    ref = sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                         device="cpu", **kw)
    (lab, _c, stats), port_faults = _port(X, dict(kw, pair_budget=1))
    assert stats["merge"] == "host"
    np.testing.assert_array_equal(lab, ref[0])
    assert len(PAIR_BUDGET_HINTS) == 1
    assert port_faults["retried"] == {"retry.pair_budget.attempts": 1}


def test_single_shard_hint_cache_bounded():
    c = BudgetHintCache(maxsize=4)
    for i in range(10):
        c.put(("k", i), i)
    assert len(c) == 4
    assert c.get(("k", 9)) == 9 and c.get(("k", 0)) is None
    c.put(("fresh", 0), 1)
    assert c.get(("k", 9)) == 9  # refreshed by the get above
    assert dispatch_tag(123) == "pair"


def test_single_route_seeds_and_reuses_its_hint(monkeypatch):
    """The single route's ladder keys its hint as the JAX driver does;
    an overflowed first fit seeds it and the refit extracts once."""
    X = _blobs(1200, seed=5)
    seen, short = [], [True]
    orig = tdbscan.dbscan_device_pipeline

    def spy(*a, pair_budget=None, **kw):
        seen.append(pair_budget)
        # The test's first extraction gets a budget too small.
        pb = pair_budget
        if short:
            short.pop()
            pb = 8
        return orig(*a, pair_budget=pb, **kw)

    monkeypatch.setattr(tdbscan, "dbscan_device_pipeline", spy)
    kw = dict(eps=0.4, min_samples=5, block=128, device="cpu")
    first = DBSCAN(**kw).fit(X)
    assert seen[0] is None and seen[1] > 8 and len(seen) == 2
    assert len(PAIR_BUDGET_HINTS) == 1
    (key,) = list(PAIR_BUDGET_HINTS._d)
    assert key[0] == "pair" and key[2:] == (128, "high", 0.4,
                                              "euclidean", 0)
    r = first.report()
    assert r["faults"]["retried"] == 1 and r["events"]["pair_overflow"] == 1
    seen.clear()
    again = DBSCAN(**kw).fit(X)
    assert seen == [PAIR_BUDGET_HINTS.get(key)]
    np.testing.assert_array_equal(again.labels_, first.labels_)
    assert again.report()["faults"]["retried"] == 0


def test_pair_budget_exhaustion_names_knob():
    def run_step(pb, _mr):
        return None, (50000, 10), True  # always past the budget

    with pytest.raises(RuntimeError) as ei:
        run_ladders(run_step, ("t",), None, 8)
    msg = str(ei.value)
    assert "pair_budget=" in msg and "PPTORCH_PAIR_BUDGET" in msg


def test_pair_budget_env_knob(monkeypatch):
    seen = []

    def run_step(pb, _mr):
        seen.append(pb)
        return "out", (100, 0), True

    monkeypatch.setenv("PPTORCH_PAIR_BUDGET", "8192")
    assert run_ladders(run_step, ("t2",), None, 8) == "out"
    assert seen == [8192]
