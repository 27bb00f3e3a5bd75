"""Sketched passes and fits of the port against the JAX package on the
CPU: the sketched pair list and the plain versions of B3/B4 against the
Pallas kernels in interpret mode, sketched fits against the JAX fit and
the port's own unsketched fit, the sketch knobs through a fit, and a
rehearsal of ``chip_smoke.py``'s phase 7.

The Pallas kernels and the JAX fit compute d^2 through the norm
expansion, the port through an axis-ordered difference sum; the two may
disagree on pairs within float32 rounding of eps^2, so the data that is
compared with JAX carries a guard band (no pair within ``GUARD * eps^2``
of eps^2, checked in float64; float32 formulations differ by ~1e-6
relative).  The port's sketched and unsketched passes share the exact
arithmetic and are compared on any data.  The unit-level parity tests
(Q, the band, the slab, the stats' int64 path) are in
tests/test_torch_sketch.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import benchdata
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.ops import pallas_kernels as jpk
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops import sketch as tsk
from pypardis_tpu_torch.ops.distances import eps2_f32
from pypardis_tpu_torch.ops.precision import exact_slack
from test_torch_sketch import BLOCK, _layout

SIGMA = 0.5
GUARD = 5e-5


def _noise_dominated(n, dim, n_centers=8, seed=0):
    """tests/test_sketch.py's geometry: equidistant centres on a scaled
    orthonormal basis plus full-rank noise that dominates every axis."""
    rng = np.random.default_rng(seed)
    eps = round(1.06 * SIGMA * np.sqrt(2.0 * dim), 2)
    basis = np.linalg.qr(rng.normal(size=(dim, n_centers)))[0]
    centers = (3.5 * eps / np.sqrt(2.0)) * basis.T
    truth = rng.integers(0, n_centers, size=n)
    X = centers[truth] + rng.normal(scale=SIGMA, size=(n, dim))
    return X.astype(np.float32), eps


def _near_eps_shells(n=700, d=256, eps=4.0, seed=3):
    """Tight blobs plus points planted at eps * (1 +- 1e-4) from anchor
    points (tests/test_mixed_precision.py's shells): every planted pair
    lands in the sketch band and goes through the exact rescore."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * (3.0 * eps / np.sqrt(d))
    X = (centers[rng.integers(0, 6, n)]
         + rng.normal(scale=0.08 * eps / np.sqrt(d), size=(n, d)))
    X[10] = X[11]
    for i, anchor in enumerate(range(0, 60, 5)):
        v = rng.normal(size=d)
        v /= np.linalg.norm(v)
        X[100 + 2 * i] = X[anchor] + (eps * (1 - 1e-4)) * v
        X[101 + 2 * i] = X[anchor] + (eps * (1 + 1e-4)) * v
    return X.astype(np.float32), eps


def _guard(X, eps, keep=()):
    """Drop every point with a pair whose float64 d^2 lies within
    ``GUARD * eps^2`` of eps^2 (planted rows in ``keep`` stay: they sit
    2e-4 off)."""
    x = X.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    near = np.abs(d2 - eps * eps) < GUARD * eps * eps
    np.fill_diagonal(near, False)
    drop = near.any(axis=1)
    drop[list(keep)] = False
    return X[~drop]


def _geometry(name):
    """(X, eps, min_samples) of a parity geometry, guard-banded."""
    if name == "noise":
        X, eps = _noise_dominated(800, 160, seed=2)
        return _guard(X, eps)[:768], eps, 5
    if name == "embedding":
        X, _ = benchdata.make_embedding_data(900, 512)
        return _guard(X, 2.0)[:800], 2.0, 10
    X, eps = _near_eps_shells()
    return _guard(X, eps, keep=range(100, 124)), eps, 5


@pytest.fixture(scope="module", params=["noise", "embedding", "shells"])
def geom(request):
    return request.param, _geometry(request.param)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain passes are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


# -- the sketch knobs through a fit ------------------------------------


def test_env_knobs_resolve_like_the_constructor(monkeypatch):
    X, eps = _noise_dominated(512, 160, seed=5)
    kw = dict(eps=eps, min_samples=5, block=BLOCK, device="cpu")
    pinned = DBSCAN(sketch=16, **kw).fit(X)
    monkeypatch.setenv("PPTORCH_SKETCH", "16")
    env = DBSCAN(**kw).fit(X)
    assert env.metrics_["sketch_k"] == pinned.metrics_["sketch_k"] == 16
    assert env.metrics_["band_pairs"] == pinned.metrics_["band_pairs"] > 0
    assert np.array_equal(env.labels_, pinned.labels_)
    monkeypatch.setenv("PPTORCH_SKETCH", "off")
    assert DBSCAN(**kw).fit(X).metrics_["sketch_k"] == 0
    # The constructor's pin wins over the knob.
    assert DBSCAN(sketch="auto", **kw).fit(X).metrics_["sketch_k"] == 40
    monkeypatch.delenv("PPTORCH_SKETCH")
    monkeypatch.setenv("PPTORCH_SKETCH_MIN_D", "32")
    assert tsk.resolve_sketch("auto", 64) == tsk.SKETCH_MIN_K
    X64 = X[:, :64]
    m = DBSCAN(eps=eps, min_samples=5, block=BLOCK, device="cpu").fit(X64)
    assert m.metrics_["sketch_k"] == tsk.SKETCH_MIN_K
    monkeypatch.setenv("PPTORCH_SKETCH_MIN_D", "128")
    assert DBSCAN(**kw).fit(X64).metrics_["sketch_k"] == 0


@pytest.mark.parametrize("budget", [None, 20], ids=["default", "overflow"])
def test_kernel_pair_list_sketch_matches_jax(geom, budget):
    """Entry for entry, totals included, with and without the column
    boxes of a source subset."""
    _name, (X, eps, _ms) = geom
    xs, mask = _layout(X, eps)
    d = xs.shape[0]
    k = tsk.resolve_sketch("auto", d)
    src = mask & (torch.arange(xs.shape[1]) % 3 != 0)
    for src_mask in (None, src):
        (rows, cols), (total, bud) = ck.kernel_pair_list(
            xs, eps, mask, BLOCK, "high", budget=budget, src_mask=src_mask,
            sketch=k,
        )
        (jr, jc), jstats = jpk.kernel_pair_list(
            jnp.asarray(xs.numpy()), eps, jnp.asarray(mask.numpy()), BLOCK,
            "high", "dn", budget=budget,
            src_mask=None if src_mask is None else jnp.asarray(
                src_mask.numpy()),
            sketch=k,
        )
        assert [total, bud] == [int(v) for v in np.asarray(jstats)]
        assert np.array_equal(rows.numpy(), np.asarray(jr))
        assert np.array_equal(cols.numpy(), np.asarray(jc))
        if budget is not None:
            assert total > bud


# -- the plain versions of B3 / B4 -----------------------------------------


def _band_tolerance(xs, mask, slab, band, k, eps, colmask):
    """Pairs whose slab gate value lies within ``exact_slack`` of a gate
    edge: the two t2 formulations (the port's difference sum, the JAX
    kernels' norm expansion) may classify exactly these differently, so
    band_pairs may differ by at most their number."""
    s = slab.numpy().astype(np.float64)[:k + 1]
    sq = (s * s).sum(0)
    t2 = sq[:, None] + sq[None, :] - 2.0 * s.T @ s
    up = t2 + 4.0 * s[k][:, None] * s[k][None, :]
    e2 = eps2_f32(eps)
    nrm = float(np.sqrt(sq.max()))
    slack = exact_slack(nrm, nrm)
    near = ((np.abs(t2 - band - e2) <= slack)
            | (np.abs(up - (e2 - band)) <= slack))
    return int(near[:, colmask.numpy()].sum())


@pytest.mark.parametrize("sketch", [16, "auto"])
def test_plain_sketch_passes_match_pallas_interpret(geom, sketch):
    """Counts and min labels equal to the JAX Pallas sketch kernels and
    to the port's unsketched passes; rescored_tiles equal to JAX's;
    band_pairs within the formulation tolerance of JAX's."""
    _name, (X, eps, ms) = geom
    xs, mask = _layout(X, eps)
    d = xs.shape[0]
    k = tsk.resolve_sketch(sketch, d)
    jxs, jmask = jnp.asarray(xs.numpy()), jnp.asarray(mask.numpy())
    counts, stats = ck.neighbor_counts_cuda(xs, eps, mask, block=BLOCK,
                                            sketch=k)
    jc, jst = jpk.neighbor_counts_pallas(
        jxs, eps, jmask, block=BLOCK, precision="high", interpret=True,
        layout="dn", sketch=k,
    )
    m = mask.numpy()
    assert np.array_equal(counts.numpy()[m], np.asarray(jc)[m])
    plain = ck.neighbor_counts_cuda(xs, eps, mask, block=BLOCK, sketch=0)
    assert torch.equal(counts, plain)
    band_pairs, rescored = (int(v) for v in stats)
    jband, jresc = (int(v) for v in np.asarray(jst))
    assert band_pairs > 0 and rescored > 0
    assert rescored == jresc
    slab, band = ck.sketch_stage(xs, mask, k)
    tol = _band_tolerance(xs, mask, slab, band, k, eps, mask)
    assert abs(band_pairs - jband) <= tol, (band_pairs, jband, tol)

    core = (torch.clamp_min(counts, 1) >= ms) & mask
    assert core.any()
    labels = torch.from_numpy(
        np.random.default_rng(3).permutation(xs.shape[1]).astype(np.int32))
    best, zeros = ck.min_neighbor_label_cuda(
        xs, labels, eps, core, block=BLOCK, row_mask=mask, sketch=k)
    jbest, _ = jpk.min_neighbor_label_pallas(
        jxs, jnp.asarray(labels.numpy()), eps, jnp.asarray(core.numpy()),
        block=BLOCK, precision="high", interpret=True,
        row_mask=jmask, layout="dn", sketch=k,
    )
    assert np.array_equal(best.numpy()[m], np.asarray(jbest)[m])
    assert torch.equal(best, ck.min_neighbor_label_cuda(
        xs, labels, eps, core, block=BLOCK, row_mask=mask, sketch=0))
    assert not zeros.any()


# -- fits -------------------------------------------------------------------


def test_fits_byte_identical_to_jax_and_unsketched(geom):
    """Labels and core mask equal for every k, to the JAX fit and to the
    port's own unsketched fit; the metrics carry the resolved k and the
    counts pass's gate telemetry."""
    _name, (X, eps, ms) = geom
    ref = JaxDBSCAN(eps=eps, min_samples=ms, block=BLOCK,
                    kernel_backend="xla", mesh=default_mesh(1),
                    sketch="auto").fit(X)
    assert ref.labels_.max() >= 1
    d = X.shape[1]
    for sketch in (16, 64, "auto", 0):
        m = DBSCAN(eps=eps, min_samples=ms, block=BLOCK, device="cpu",
                   sketch=sketch).fit(X)
        assert np.array_equal(m.labels_, ref.labels_), sketch
        assert np.array_equal(m.core_sample_mask_, ref.core_sample_mask_)
        k = tsk.resolve_sketch(sketch, d)
        assert m.metrics_["sketch_k"] == k
        if k:
            assert m.metrics_["band_pairs"] > 0
            assert m.metrics_["rescored_tiles"] > 0
        else:
            assert m.metrics_["band_pairs"] == 0
            assert m.metrics_["rescored_tiles"] == 0


def test_chip_smoke_sketch_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 7 of chip_smoke.py end to end at small sizes, the kernels'
    wrappers running their plain versions and counting their calls as
    launches (on the card each call is one launch)."""
    import time

    import chip_smoke

    for name in ("count_pairs", "minlab_pairs", "count_pairs_sketch",
                 "minlab_pairs_sketch"):
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, name, counted)

    def median_ms(fn, reps):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))

    sizes = {"check_n": 600, "onoff_n": 600, "main_n": 700,
             "sub_tiles": 1, "reps": 1}
    kernels, onoff = chip_smoke.sketch_phase(
        torch, torch.device("cpu"), median_ms, lambda: None, sizes)
    assert onoff["model"].metrics_["sketch_k"] > 0
    assert [k["name"] for k in kernels] == ["count_pairs_sketch",
                                            "minlab_pairs_sketch"]
    b3 = kernels[0]
    assert 0 < b3["floor_ms"] and 0 <= b3["mma_probe_term3_share"] <= 1
    for rec in kernels:
        assert rec["launches"] >= 1 and rec["max_abs_err"] == 0
        assert rec["bound_by"] == "operations" and rec["bound_ms"] > 0
        assert rec["library_ms"] is None
