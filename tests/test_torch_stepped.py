"""The port's host-stepped route (``ops/pipeline._cluster_stepped`` over
``ops/labels.dbscan_prepare`` / ``dbscan_rounds`` / ``dbscan_border``)
on the CPU, held against the JAX package.

At ``PPTORCH_STEP_THRESHOLD`` 1 and ``PPTORCH_ROUND_BATCH`` 1, 3 and 8
the stepped fit's labels and core flags equal the JAX fused fit's
(``kernel_backend="xla"``) and the port's fused fit's byte for byte; its
``report()["stepped"]`` keys and ``compute.kernel_passes`` equal the JAX
stepped fit's under the serial loop (``PYPARDIS_STEP_OVERLAP=0``; the
port has no speculative loop), Pallas in interpret mode on a one-device
mesh, as
``tests/test_dispatch.py::test_stepped_route_parity_with_pair_dispatch``
runs it; the fit's min-label passes are the JAX count and run through
the stages' wrappers that many times."""

import functools

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.ops import pallas_kernels as jax_pk
from pypardis_tpu.ops import pipeline as jax_pipeline
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.ops import labels as tlabels
from pypardis_tpu_torch.ops import pipeline as tpipeline

EPS, MS = 0.6, 6
KW = dict(eps=EPS, min_samples=MS, block=256)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _blobs(n=2048, d=8, seed=7, std=0.3):
    """``tests/test_dispatch.py``'s blobs."""
    X, _ = make_blobs(n_samples=n, centers=10, n_features=d,
                      cluster_std=std, random_state=seed)
    return X.astype(np.float32)


def _margin(X, eps):
    """Least |d^2 - eps^2| / eps^2 over the pairs, in float64."""
    x = X.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    return float(np.abs(d2 - eps * eps).min() / (eps * eps))


@pytest.fixture(scope="module")
def refs():
    """The data, the JAX fused fit (XLA) and the port's fused fit."""
    X = _blobs()
    # No pair within float32 rounding of eps: the exact verdicts of both
    # packages agree.
    assert _margin(X, EPS) > 1e-6
    staging.clear()
    jax_fit = JaxDBSCAN(**KW, kernel_backend="xla",
                        mesh=default_mesh(1)).fit(X)
    port = DBSCAN(**KW, device="cpu").fit(X)
    assert "stepped" not in port.report()
    np.testing.assert_array_equal(port.labels_, jax_fit.labels_)
    return X, jax_fit, port


def _stepped(monkeypatch, X, batch):
    monkeypatch.setenv("PPTORCH_STEP_THRESHOLD", "1")
    monkeypatch.setenv("PPTORCH_ROUND_BATCH", str(batch))
    return DBSCAN(**KW, device="cpu").fit(X)


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_stepped_fit_is_the_fused_fit(refs, monkeypatch, batch):
    X, jax_fit, port = refs
    m = _stepped(monkeypatch, X, batch)
    for want in (jax_fit, port):
        assert m.labels_.tobytes() == want.labels_.tobytes()
        assert (m.core_sample_mask_.tobytes()
                == want.core_sample_mask_.tobytes())
    st = m.report()["stepped"]
    assert st["batches"] >= 1 and st["batch_size"] == batch
    assert st["speculate"] is False and st["converged"] is True
    assert st["dispatched_batches"] == st["batches"]
    assert m.metrics_["kernel_passes"] == 1 + st["batches"] * batch


def test_stepped_launches_are_the_pass_count(refs, monkeypatch):
    """Every stepped batch runs its k rounds: one prepare (the counts
    pass), ``batches * batch_k`` min-label passes."""
    X, _jax, _port = refs
    calls = {"prepare": 0, "minlab": 0}
    prep, minlab = tlabels.dbscan_prepare, tlabels._minlab

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tpipeline, "dbscan_prepare", count("prepare", prep))
    monkeypatch.setattr(tlabels, "_minlab", count("minlab", minlab))
    m = _stepped(monkeypatch, X, 2)
    assert calls["prepare"] == 1
    assert 1 + calls["minlab"] == m.metrics_["kernel_passes"]


@pytest.fixture(scope="module")
def jax_stepped():
    """The JAX stepped fit at the default batch under the serial loop,
    Pallas in interpret mode on a one-device mesh
    (``tests/test_dispatch.py``'s setup)."""
    X = _blobs()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_pk, "neighbor_counts_pallas", functools.partial(
            jax_pk.neighbor_counts_pallas, interpret=True))
        mp.setattr(jax_pk, "min_neighbor_label_pallas", functools.partial(
            jax_pk.min_neighbor_label_pallas, interpret=True))
        staging.clear()
        fused = JaxDBSCAN(**KW, kernel_backend="pallas",
                          mesh=default_mesh(1)).fit(X)
        mp.setattr(jax_pipeline, "STEP_THRESHOLD", 1)
        mp.setenv("PYPARDIS_STEP_OVERLAP", "0")
        staging.clear()
        m = JaxDBSCAN(**KW, kernel_backend="pallas",
                      mesh=default_mesh(1)).fit(X)
    finally:
        mp.undo()
        staging.clear()
    m.fused_pallas = fused
    return X, m


def test_stepped_report_matches_the_jax_stepped_fit(jax_stepped,
                                                    monkeypatch):
    X, jm = jax_stepped
    want = jm.report()
    monkeypatch.setenv("PPTORCH_STEP_THRESHOLD", "1")
    m = DBSCAN(**KW, device="cpu").fit(X)
    got = m.report()
    assert set(got["stepped"]) == set(want["stepped"])
    assert got["compute"]["kernel_passes"] == want["compute"]["kernel_passes"]
    for key in ("batches", "batch_size", "dispatched_batches", "speculate",
                "converged"):
        assert got["stepped"][key] == want["stepped"][key], key
    spans = [s for s in m._recorder.tracer.spans
             if s.name == "pipeline.cluster"]
    assert spans and spans[0].attrs["mode"] == "stepped"
    assert spans[0].attrs["capacity"] >= len(X)


def test_stepped_route_parity_with_pair_dispatch(refs, jax_stepped,
                                                monkeypatch):
    """The counterpart of ``tests/test_dispatch.py::
    test_stepped_route_parity_with_pair_dispatch``: in each package the
    stepped fit equals the fused fit of the same kernels byte for byte.
    (The JAX leg runs its Pallas kernels, whose bf16_3x "high" split
    differs from exact float32 at a few near-eps pairs, the documented
    backend gap; the port's kernels and their plain versions are exact,
    so its leg also equals the JAX XLA fit, see above.)"""
    X, jax_fit, port = refs
    _X2, jm = jax_stepped
    assert "stepped" not in jm.fused_pallas.report()
    assert jm.report()["stepped"]["batches"] >= 1
    np.testing.assert_array_equal(jm.labels_, jm.fused_pallas.labels_)
    np.testing.assert_array_equal(jm.core_sample_mask_,
                                  jm.fused_pallas.core_sample_mask_)
    monkeypatch.setenv("PPTORCH_STEP_THRESHOLD", "1")
    m = DBSCAN(**KW, device="cpu").fit(X)
    assert m.report()["stepped"]["batches"] >= 1
    np.testing.assert_array_equal(m.labels_, port.labels_)
    np.testing.assert_array_equal(m.core_sample_mask_,
                                  port.core_sample_mask_)


def test_fused_route_is_the_composed_stages(refs):
    """``dbscan_fixed_size`` is prepare + rounds to the fixpoint +
    border: at max_rounds 1 (an exit by the cap) the border pass runs
    and is counted."""
    X, _jax, _port = refs
    pts = torch.from_numpy(np.ascontiguousarray((X - X.mean(0)).T))
    mask = torch.ones(pts.shape[1], dtype=torch.bool)
    lab, core, ps = tlabels.dbscan_fixed_size(pts, EPS, MS, mask, block=256,
                                              max_rounds=1)
    st = tlabels.dbscan_prepare(pts, EPS, MS, mask, block=256)
    f, g, live, changed, rounds = tlabels.dbscan_rounds(
        st, st["f0"], mask, 1)
    assert changed and rounds == 1 and int(ps[2]) == 3
    border = tlabels.dbscan_border(st, f, live)
    want = tlabels.finish_labels(f, border, st["core"], mask)
    assert torch.equal(lab, want) and torch.equal(core, st["core"])


def test_a_batch_past_the_fixpoint_changes_nothing(refs):
    X, _jax, _port = refs
    pts = torch.from_numpy(np.ascontiguousarray((X - X.mean(0)).T))
    mask = torch.ones(pts.shape[1], dtype=torch.bool)
    st = tlabels.dbscan_prepare(pts, EPS, MS, mask, block=256)
    f, g, live, changed, rounds = tlabels.dbscan_rounds(
        st, st["f0"], mask, 64)
    assert not changed
    f2, g2, _l, changed2, rounds2 = tlabels.dbscan_rounds(
        st, f, live, 3, until_fixpoint=False)
    assert rounds2 == 3 and not changed2
    assert torch.equal(f2, f) and torch.equal(g2, g)
    # From the full mask (a resumed batch) too.
    f3, g3, _l, _c, _r = tlabels.dbscan_rounds(st, f, mask, 2,
                                               until_fixpoint=False)
    assert torch.equal(f3, f) and torch.equal(g3, g)


def test_truncated_pair_list_runs_no_stepped_pass(refs, monkeypatch):
    """An overflowed list on the stepped route runs no pass and is
    reported in-band; the ladder reruns it at the exact total (one
    ``pair_budget`` retry in the report's faults block)."""
    X, jax_fit, _port = refs
    calls = []
    minlab = tlabels._minlab
    monkeypatch.setattr(tlabels, "_minlab",
                        lambda *a, **k: calls.append(1) or minlab(*a, **k))
    monkeypatch.setenv("PPTORCH_STEP_THRESHOLD", "1")
    monkeypatch.setenv("PPTORCH_PAIR_BUDGET", "1")
    m = DBSCAN(**KW, device="cpu").fit(X)
    assert m.labels_.tobytes() == jax_fit.labels_.tobytes()
    r = m.report()
    assert r["events"]["pair_overflow"] == 1
    assert r["faults"]["retried"] == 1 and r["faults"]["giveups"] == 0
    assert m.metrics_["pair_budget"] >= m.metrics_["live_pairs"] > 1
    # Only the rerun's passes ran.
    assert 1 + len(calls) == m.metrics_["kernel_passes"]
