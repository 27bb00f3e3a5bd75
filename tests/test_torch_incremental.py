"""The live path's primitives on the CPU against the JAX package:
``ops/incremental.py`` (float64 verdicts, border attach, the bucketed
re-cluster, the relabel LUT) and ``parallel/merge.resolve_label_edges``.

The same inputs, made with numpy from a seed, go through both packages.
The port sums d^2 axis by axis (subtract, square, add: one rounding
each), so its d^2 is held bitwise against a numpy oracle in that order,
and against the JAX package's ``einsum`` within 4 ulps of d^2 (its
summation order may differ); counts and labels are held exactly on this
data, whose pairs keep clear of eps^2 by more than that.
"""

import numpy as np
import pytest
import torch

from benchdata import make_separated_blob_data
from pypardis_tpu.ops import incremental as jinc
from pypardis_tpu.parallel import merge as jmerge
from pypardis_tpu_torch.ops import incremental as inc
from pypardis_tpu_torch.parallel.merge import resolve_label_edges


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _sequential_d2(a, b):
    """numpy oracle: d^2 summed axis by axis in index order."""
    d2 = np.zeros((len(a), len(b)))
    for j in range(a.shape[1]):
        diff = a[:, j, None] - b[None, :, j]
        d2 = d2 + diff * diff
    return d2


def _points(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=1.5, size=(n, d)) + rng.uniform(-1e3, 1e3, d)


def _margin(d2, eps):
    """Relative distance of the nearest pair from the eps^2 boundary."""
    return float(np.min(np.abs(d2 - eps * eps)) / (eps * eps))


@pytest.mark.parametrize("d", [1, 3, 16])
def test_sq_dists_are_the_sequential_sum(d):
    a, b = _points(70, d, d), _points(90, d, d + 100)
    got = inc.sq_dists_f64(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), _sequential_d2(a, b))
    ref = jinc.sq_dists_f64(a, b)
    np.testing.assert_allclose(got.numpy(), ref, rtol=4 * 2.0 ** -52,
                               atol=0)


@pytest.mark.parametrize("d,eps", [(3, 1.1), (16, 2.4)])
def test_counts_and_mask_equal_the_jax_package(d, eps, monkeypatch):
    q, c = _points(300, d, 1), _points(500, d, 2)
    c[:200] = q[:200] + np.random.default_rng(3).normal(
        scale=eps / np.sqrt(d), size=(200, d))
    assert _margin(_sequential_d2(q, c), eps) > 1e-12
    want = jinc.count_within_eps(q, c, eps)
    assert want.sum() > 0
    got = inc.count_within_eps(q, c, eps)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    # Row chunks do not change a count.
    monkeypatch.setattr(inc, "_CHUNK_ELEMS", 1000)
    assert np.array_equal(inc.count_within_eps(q, c, eps).numpy(), want)
    assert np.array_equal(inc.within_eps_mask(q, c, eps).numpy(),
                          jinc.within_eps_mask(q, c, eps))
    for a, b in ((q[:0], c), (q, c[:0])):
        assert np.array_equal(inc.count_within_eps(a, b, eps).numpy(),
                              jinc.count_within_eps(a, b, eps))


@pytest.mark.parametrize("need", [1, 6, 40, "rows"])
def test_count_reaches_is_the_count_against_its_need(need):
    """"At least k" with an early exit per row: the same verdicts as the
    full count, whatever the first chunk (from a width of 7 the 900
    candidates take eight doubling chunks)."""
    rng = np.random.default_rng(9)
    q, c = _points(200, 3, 10), _points(900, 3, 11)
    c[:600] = q[rng.integers(0, 200, 600)] + rng.normal(scale=0.6,
                                                        size=(600, 3))
    counts = jinc.count_within_eps(q, c, 1.1)
    k = rng.integers(-1, 30, 200) if need == "rows" else need
    want = counts >= k
    assert 0 < want.sum() < len(want) or need == 1
    for first in (1, 7, 64, 4096):
        got = inc.count_reaches(q, c, 1.1, k, first_cols=first)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert inc.count_reaches(q, c[:0], 1.1, 0).all()
    assert not inc.count_reaches(q, c[:0], 1.1, 1).any()


def test_attach_to_cores_equals_the_jax_package():
    rng = np.random.default_rng(4)
    pts, cores = _points(400, 3, 5), _points(300, 3, 6)
    cores[:150] = pts[:150] + rng.normal(scale=0.4, size=(150, 3))
    labels = rng.integers(0, 7, 300)
    # Ties: a duplicated core under a smaller label.
    cores[150], labels[150], labels[0] = cores[0], 9, 2
    cores[151], labels[151] = cores[0], 1
    eps = 1.1
    assert _margin(_sequential_d2(pts, cores), eps) > 1e-12
    lab, d2 = inc.attach_to_cores(pts, cores, labels, eps)
    jlab, jd2 = jinc.attach_to_cores(pts, cores, labels, eps)
    assert lab.dtype == torch.int32 and np.array_equal(lab.numpy(), jlab)
    assert (jlab >= 0).sum() > 100 and (jlab == -1).sum() > 10
    within = jlab >= 0
    np.testing.assert_allclose(d2.numpy()[within], jd2[within],
                               rtol=4 * 2.0 ** -52, atol=0)
    assert np.isinf(d2.numpy()[~within]).all()
    oracle = _sequential_d2(pts, cores)
    assert np.array_equal(d2.numpy()[within], oracle.min(axis=1)[within])
    empty = inc.attach_to_cores(pts, cores[:0], labels[:0], eps)
    assert (empty[0].numpy() == -1).all() and np.isinf(empty[1].numpy()).all()


def test_bucket_size_and_label_lut_equal_the_jax_package():
    for n, floor in ((0, 64), (1, 64), (64, 64), (65, 64), (1000, 64),
                     (5, 1), (300, 512)):
        assert inc.bucket_size(n, floor) == jinc.bucket_size(n, floor)
    mapping = {0: 0, 3: 1, 1: 1, 7: 2, 12: 2, 40: 3}
    for top in (0, 5, 12, 50):
        assert np.array_equal(inc.label_lut(mapping, top),
                              jinc.label_lut(mapping, top))


@pytest.mark.parametrize("n,d,bucket,min_bucket", [
    (2, 3, True, 64), (150, 3, True, 64), (150, 3, False, 64),
    (700, 3, True, 64), (300, 16, True, 512), (1, 3, True, 64),
    (0, 3, True, 64),
])
def test_core_components_equal_the_jax_package(n, d, bucket, min_bucket):
    """The bucketed re-cluster over known cores: the same sentinel grid,
    the same components, numbered alike (B1/B2's plain versions here,
    the JAX package's fused XLA route there)."""
    X, _t, _c = make_separated_blob_data(
        max(n, 1), d, n_centers=5, std=0.35, min_sep=5.3, spread=10.0,
        seed=n)
    X = X[:n]
    want = jinc.core_components(X, 1.1, block=128, bucket=bucket,
                                min_bucket=min_bucket)
    got = inc.core_components(X, 1.1, block=128, bucket=bucket,
                              min_bucket=min_bucket, device="cpu")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    if n > 100:
        assert len(np.unique(got)) >= 5
    # A tensor is brought to the host for the grid: the same numbering.
    t = inc.core_components(torch.from_numpy(X), 1.1, block=128,
                            bucket=bucket, min_bucket=min_bucket)
    assert np.array_equal(t, want)


def test_resolve_label_edges_equals_the_jax_package():
    rng = np.random.default_rng(8)
    ids = np.unique(rng.integers(0, 200, 80))
    edges = ids[rng.integers(0, len(ids), size=(60, 2))]
    assert resolve_label_edges(edges, ids) == jmerge.resolve_label_edges(
        edges, ids)
    # Three clusters joined by one bridge: every member maps to the least.
    e3 = np.array([[5, 9], [9, 2], [11, 2]])
    out = resolve_label_edges(e3, [2, 5, 9, 11, 30])
    assert out == {2: 2, 5: 2, 9: 2, 11: 2, 30: 30}
    assert out == jmerge.resolve_label_edges(e3, [2, 5, 9, 11, 30])
    assert resolve_label_edges(np.empty((0, 2), np.int64), []) == {}
    for bad_ids in ([], [1, 2]):
        with pytest.raises(KeyError, match="not in the"):
            resolve_label_edges([[1, 3]], bad_ids)
        with pytest.raises(KeyError, match="not in the"):
            jmerge.resolve_label_edges([[1, 3]], bad_ids)
