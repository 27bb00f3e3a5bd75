"""The port's sketch prefilter against the JAX package on the CPU, unit
by unit: the projection matrix, the spec resolution, the gate band, the
slab, the plain versions of B3/B4 at their edges, the wrappers' checks
and the int64 path of the pair stats.  The sketched pair lists, passes
and fits against the JAX package are in tests/test_torch_sketch_fits.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import benchdata
from pypardis_tpu.ops import pallas_kernels as jpk
from pypardis_tpu.ops import sketch as jsk
from pypardis_tpu_torch import DBSCAN, DBSCANConfig
from pypardis_tpu_torch.convert import dbscan_from_reference
from pypardis_tpu_torch.dbscan import _stage
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops import sketch as tsk
from pypardis_tpu_torch.ops.distances import (
    counts_over_pairs_sketch,
    eps2_f32,
    minlab_over_pairs_sketch,
)
from pypardis_tpu_torch.ops.pipeline import (
    _pipeline_layout,
    _pipeline_pack,
    unpack_pipeline_result,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


INT_INF = np.iinfo(np.int32).max
BLOCK = 128


def _layout(X, eps):
    """The fit's own (d, cap) device layout, Morton-sorted."""
    pts, n, block = _stage(X, BLOCK, torch.device("cpu"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    return xs, mask


# -- the projection, the spec and the band ---------------------------------


@pytest.mark.parametrize("d,k,seed", [(160, 40, None), (256, 64, None),
                                      (512, 128, None), (130, 33, 7)])
def test_sketch_matrix_bitwise_equal(d, k, seed):
    q, eta = tsk.sketch_matrix(d, k, seed)
    jq, jeta = jsk.sketch_matrix(d, k, seed)
    assert q.dtype == np.float32 and q.shape == (d, k)
    assert np.array_equal(q.view(np.int32), jq.view(np.int32))
    assert eta == jeta


def test_spec_validation_matches_jax():
    for spec in (None, "auto", "off", "", " Auto ", 0, "32", np.int64(8), 16):
        assert tsk.check_sketch_spec(spec) == jsk.check_sketch_spec(spec)
    for bad in ("weird", -1, 1.5, True, [16], "-3"):
        with pytest.raises((ValueError, TypeError)):
            jsk.check_sketch_spec(bad)
        with pytest.raises((ValueError, TypeError)):
            tsk.check_sketch_spec(bad)
    with pytest.raises(ValueError, match="sketch"):
        DBSCAN(eps=0.3, min_samples=5, device="cpu", sketch="sometimes")


def test_resolve_policy_matches_jax():
    cases = [("auto", 64), ("auto", 512), ("auto", 127), ("auto", 128),
             ("auto", 2048), (500, 64), (16, 64), (0, 512), ("off", 512),
             (None, 300), (3, 4), (1, 1), ("7", 130)]
    for spec, d in cases:
        for metric in ("euclidean", "cityblock"):
            assert (tsk.resolve_sketch(spec, d, metric)
                    == jsk.resolve_sketch(spec, d, metric)), (spec, d, metric)
    for d in range(0, 2200, 7):
        assert tsk.auto_k(d) == jsk.auto_k(d)
    assert (tsk.SKETCH_MIN_K, tsk.SKETCH_MAX_K) == (
        jsk.SKETCH_MIN_K, jsk.SKETCH_MAX_K)
    assert tsk.resolve_sketch("auto", 512) == 128
    for k in (1, 16, 64, 128):
        assert tsk.jl_band(k) == jsk.jl_band(k, delta=0.01)


@pytest.mark.parametrize("nmax", [0.0, 1.0, 21.67, 22.87, 1234.5678])
def test_gate_band_bitwise_equal(nmax):
    """float32 in the JAX operation order: equal bits at the same nmax.
    The port has no lossless fast dot, so its ``default`` band is the
    JAX band with ``fast_exact=False``; ``high`` ignores the flag."""
    for d, k in ((160, 40), (512, 128), (256, 33)):
        _q, eta = tsk.sketch_matrix(d, k)
        for prec, fast in (("high", True), ("high", False),
                           ("default", False)):
            got = tsk.sketch_gate_band(np.float32(nmax), d, k, eta, prec)
            want = np.asarray(jsk.sketch_gate_band(
                jnp.float32(nmax), d, k, eta, prec, fast))
            assert got.dtype == np.float32
            assert got.view(np.int32) == want.astype(np.float32).view(
                np.int32), (d, k, prec, fast)


# -- the slab and the pair list --------------------------------------------


@pytest.mark.parametrize("d,k", [(256, 64), (512, 128), (160, 33)])
def test_slab_matches_jax_stage(d, k):
    """Rows 0..k-1 are float32 products of one Q over d terms in two
    summation orders (the port rounds a float64 product once, XLA sums
    in float32), so they agree to a few float32 ulps of the column norm:
    rtol 1e-6 plus atol 1e-6 * nmax.  Pad rows are zero in both."""
    X, _ = benchdata.make_embedding_data(1024, d, seed=1)
    xs, mask = _layout(X, 2.0)
    slab, band = ck.sketch_stage(xs, mask, k)
    jslab, jband = jpk._sketch_stage(
        jnp.asarray(xs.numpy()), jnp.asarray(mask.numpy()), k, "high")
    jslab = np.asarray(jslab)
    assert slab.shape == jslab.shape == (-(-(k + 1) // 8) * 8, xs.shape[1])
    nmax = float(np.sqrt((xs.numpy().astype(np.float64) ** 2).sum(0).max()))
    np.testing.assert_allclose(slab.numpy(), jslab, rtol=1e-6,
                               atol=1e-6 * nmax)
    assert not slab[k + 1:].any() and not jslab[k + 1:].any()
    # The band differs from JAX's only through nmax's summation order.
    assert band == pytest.approx(float(jband), rel=1e-6)
    _q, eta = tsk.sketch_matrix(d, k)
    assert band == float(tsk.sketch_gate_band(
        np.sqrt(np.float32((xs * xs).sum(0)[mask].max())), d, k, eta))


def test_slab_ignores_the_global_tf32_setting():
    X, _ = benchdata.make_embedding_data(512, 256, seed=4)
    xs, mask = _layout(X, 2.0)
    want = ck.sketch_stage(xs, mask, 64)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = ck.sketch_stage(xs, mask, 64)
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]


def test_plain_sketch_identity_and_stats_on_rows_without_pairs():
    """Row tiles with no live pair get the identity; invalid columns are
    neither counted nor in band; an unvisited entry is not rescored."""
    torch.manual_seed(0)
    pts = torch.randn(40, 256)
    slab, band = ck.sketch_stage(pts, torch.ones(256, dtype=torch.bool), 16)
    row_ptr = torch.tensor([0, 1, 1], dtype=torch.int32)
    cols = torch.tensor([0, 1], dtype=torch.int32)  # entry 1 is padding
    mask = torch.ones(256, dtype=torch.int32)
    mask[5:9] = 0
    e2 = eps2_f32(9.0)
    c, st = counts_over_pairs_sketch(pts, mask, row_ptr, cols, slab, 16, e2,
                                     band, 128)
    assert (c[128:] == 0).all() and (c[:128] >= 1).all()
    assert int(st[1]) == 1 and 0 < int(st[0]) < 128 * 124
    lab = torch.where(mask.bool(), 7, INT_INF).to(torch.int32)
    m = minlab_over_pairs_sketch(pts, lab, row_ptr, cols, slab, 16, e2,
                                 band, 128)
    assert (m[128:] == INT_INF).all() and (m[:128] == 7).all()
    ck.reset_launch_counts()
    got = ck.count_pairs_sketch(pts, mask, row_ptr, cols, slab, 16, e2, band,
                                128, "high",
                                ck.pass_frames(pts, mask != 0, 128, "high",
                                               16)[0])
    assert torch.equal(got[0], c) and torch.equal(got[1], st)
    assert not any(ck.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["dtype", "rows", "width", "k", "device"])
def test_sketch_wrappers_reject_bad_slabs(bad):
    pts = torch.zeros((4, 256), dtype=torch.float32)
    slab = torch.zeros((24, 256), dtype=torch.float32)
    k = 16
    if bad == "dtype":
        slab = slab.double()
    elif bad == "rows":
        slab = torch.zeros((20, 256), dtype=torch.float32)
    elif bad == "width":
        slab = torch.zeros((24, 128), dtype=torch.float32)
    elif bad == "k":
        k = 24
    else:
        slab = slab.to("meta")
    args = (pts, torch.ones(256, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), slab, k, 1.0, 0.1, 128)
    with pytest.raises(ValueError):
        ck.count_pairs_sketch(*args)
    with pytest.raises(ValueError):
        ck.minlab_pairs_sketch(*args)


def test_int64_pair_stats_survive_the_pack():
    """band_pairs passes 2^31 on a 1M x 512 fit; the stats travel beside
    the int32 row, not in it."""
    cap = 256
    owner = torch.arange(cap)
    roots = torch.arange(cap, dtype=torch.int32)
    core = torch.ones(cap, dtype=torch.bool)
    stats = torch.tensor([123_456, 200_000, 5, 41_700_000_000, 161_234],
                         dtype=torch.int64)
    packed = _pipeline_pack(roots, core, stats, owner, cap=cap)
    out = unpack_pipeline_result((packed[0].numpy(), packed[1].numpy()))
    assert np.array_equal(out[0], roots.numpy()) and out[1].all()
    assert out[2:] == (123_456, 200_000, 5, 41_700_000_000, 161_234)


def test_sketch_spec_travels_with_config_and_convert():
    cfg = DBSCANConfig(eps=0.7, sketch="auto", device="cpu")
    assert DBSCANConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.build().sketch == "auto"
    X = np.random.default_rng(0).normal(size=(50, 3))
    params = {"eps": 0.5, "min_samples": 3, "metric": "euclidean",
              "block": 128, "precision": "high", "kernel_backend": "xla",
              "sketch": 16}
    model = dbscan_from_reference(params, X, np.zeros(50, np.int32),
                                  np.ones(50, bool), device="cpu")
    assert model.sketch == 16
    # "mixed" with a pinned sketch: the sketch gate's telemetry (the
    # sketch wins), and the "high" fit's labels byte for byte.
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=400, n_features=32, centers=3,
                      cluster_std=1.0, random_state=2)
    mixed = DBSCAN(eps=5.5, min_samples=4, precision="mixed", sketch=16,
                   device="cpu").fit(X)
    high = DBSCAN(eps=5.5, min_samples=4, sketch=16, device="cpu").fit(X)
    assert mixed.metrics_["sketch_k"] == high.metrics_["sketch_k"] == 16
    assert np.array_equal(mixed.labels_, high.labels_)
    assert np.array_equal(mixed.core_sample_mask_, high.core_sample_mask_)
    assert mixed.labels_.max() >= 1
    for key in ("band_pairs", "rescored_tiles"):
        assert mixed.metrics_[key] == high.metrics_[key] > 0
