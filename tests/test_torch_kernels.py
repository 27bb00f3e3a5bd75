"""The port's kernel layer against the JAX package: the plain versions of
the two pair kernels (B1 counts, B2 min-label) and the live tile-pair
list.

The JAX kernels run as the JAX package's own tests run them on the CPU:
the Pallas bodies through the interpreter (``interpret=True``,
``precision="highest"``) and the XLA tiled path.  The TPU kernels
compute d^2 through a norm-augmented matmul, the port through an
axis-ordered sum; the two can legitimately disagree only on pairs whose
d^2 lies within float rounding of eps^2, so the data carries a guard
band (every pair is at least 1e-3 * eps^2 away from eps^2, checked in
float64), and the bar is then exact equality on valid rows.  Rows that
are invalid return unspecified values in both packages and are not
compared.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypardis_tpu.ops.distances import min_neighbor_label, neighbor_counts
from pypardis_tpu.ops.pallas_kernels import (
    kernel_pair_list as jax_kernel_pair_list,
    min_neighbor_label_pallas,
    neighbor_counts_pallas,
)
from pypardis_tpu.partition import spatial_order
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops.distances import (
    counts_over_pairs,
    eps2_f32,
    minlab_over_pairs,
    row_offsets,
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
EPS = 2.0
BLOCK = 256


def guard_banded_blobs(d, n=2048, seed=7, band=1e-3):
    """Blobs as in tests/test_pallas.py, minus every point that has a
    pair within ``band * eps^2`` of eps^2; Morton-sorted, the last 77
    slots invalid."""
    rng = np.random.default_rng(seed)
    m = n + n // 2
    centers = rng.uniform(-10, 10, size=(8, d))
    X = (
        centers[rng.integers(0, 8, size=m)]
        + rng.normal(scale=0.3 * np.sqrt(8 / d), size=(m, d))
    ).astype(np.float32)
    x64 = X.astype(np.float64)
    sq = (x64 * x64).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x64 @ x64.T
    near = np.abs(d2 - EPS * EPS) < band * EPS * EPS
    X = X[~near.any(axis=1)][:n]
    assert len(X) == n
    X = X[spatial_order(X)]
    mask = np.ones(n, bool)
    mask[-77:] = False
    return X, mask


@pytest.fixture(scope="module", params=[16, 64], ids=["d16", "d64"])
def blob_data(request):
    return guard_banded_blobs(request.param)


def _port_inputs(X, mask):
    return (
        torch.from_numpy(np.ascontiguousarray(X.T)),
        torch.from_numpy(mask),
    )


def test_counts_match_pallas_and_xla(blob_data):
    X, mask = blob_data
    pts, msk = _port_inputs(X, mask)
    got = ck.neighbor_counts_cuda(pts, EPS, msk, block=BLOCK).numpy()
    want_p = np.asarray(neighbor_counts_pallas(
        jnp.asarray(X), EPS, jnp.asarray(mask), block=BLOCK,
        precision="highest", interpret=True,
    ))
    want_x = np.asarray(neighbor_counts(
        jnp.asarray(X), EPS, jnp.asarray(mask), block=BLOCK,
        precision="highest",
    ))
    assert np.array_equal(got[mask], want_p[mask])
    assert np.array_equal(got[mask], want_x[mask])
    assert (got[~mask] == 0).all()
    assert got[mask].min() >= 1  # every valid point counts itself


def test_minlab_match_pallas_and_xla(blob_data):
    X, mask = blob_data
    rng = np.random.default_rng(3)
    counts = np.asarray(neighbor_counts(
        jnp.asarray(X), EPS, jnp.asarray(mask), block=BLOCK,
        precision="highest",
    ))
    core = (counts >= 8) & mask
    labels = rng.permutation(len(X)).astype(np.int32)
    pts, msk = _port_inputs(X, mask)
    got = ck.min_neighbor_label_cuda(
        pts, torch.from_numpy(labels), EPS, torch.from_numpy(core),
        block=BLOCK, row_mask=msk,
    ).numpy()
    want_p = np.asarray(min_neighbor_label_pallas(
        jnp.asarray(X), jnp.asarray(labels), EPS, jnp.asarray(core),
        block=BLOCK, precision="highest", interpret=True,
        row_mask=jnp.asarray(mask),
    ))
    want_x = np.asarray(min_neighbor_label(
        jnp.asarray(X), jnp.asarray(labels), EPS, jnp.asarray(core),
        block=BLOCK, precision="highest", row_mask=jnp.asarray(mask),
    ))
    assert np.array_equal(got[mask], want_p[mask])
    assert np.array_equal(got[mask], want_x[mask])
    # Sources reach someone: the comparison is not all-sentinel.
    assert (got[mask] != INT_INF).sum() > len(X) // 2


def test_counts_on_natural_data_differ_only_near_eps():
    """Without a guard band the TPU formulation (augmented matmul) and
    the port's (axis-ordered difference sum) may disagree, but only on
    pairs whose d^2 lies within ``exact_slack`` of eps^2: each row's
    count differs by at most its number of such pairs."""
    from pypardis_tpu_torch.ops.precision import exact_slack

    rng = np.random.default_rng(21)
    n, d = 2048, 16
    centers = rng.uniform(-10, 10, size=(8, d))
    X = (centers[rng.integers(0, 8, size=n)]
         + rng.normal(scale=0.5, size=(n, d))).astype(np.float32)
    X = X[spatial_order(X)]
    mask = np.ones(n, bool)
    pts, msk = _port_inputs(X, mask)
    got = ck.neighbor_counts_cuda(pts, EPS, msk, block=BLOCK).numpy()
    want = np.asarray(neighbor_counts(
        jnp.asarray(X), EPS, jnp.asarray(mask), block=BLOCK,
        precision="highest",
    ))
    x64 = X.astype(np.float64)
    sq = (x64 * x64).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x64 @ x64.T
    nrm = float(np.sqrt(sq.max()))
    near = (np.abs(d2 - EPS * EPS) <= exact_slack(nrm, nrm)).sum(1)
    assert (np.abs(got - want) <= near).all()
    assert near.sum() > 0  # the data does reach the boundary


@pytest.mark.parametrize("budget", [None, 12], ids=["default", "overflow"])
def test_kernel_pair_list_matches_jax(blob_data, budget):
    """rows, cols and the exact total agree entry for entry — including
    which pairs a too-small budget keeps."""
    X, mask = blob_data
    pts, msk = _port_inputs(X, mask)
    (rows, cols), (total, bud) = ck.kernel_pair_list(
        pts, EPS, msk, BLOCK, "high", budget=budget
    )
    (jr, jc), jstats = jax_kernel_pair_list(
        jnp.asarray(X.T), EPS, jnp.asarray(mask), BLOCK, "high", "dn",
        budget=budget,
    )
    assert [total, bud] == [int(v) for v in np.asarray(jstats)]
    assert np.array_equal(rows.numpy(), np.asarray(jr))
    assert np.array_equal(cols.numpy(), np.asarray(jc))
    if budget is not None:
        assert total > bud  # the overflow contract is exercised


def test_pallas_block_matches_jax():
    from pypardis_tpu.ops.pallas_kernels import _pallas_block

    for args in [(2048, 1 << 20, 16, "high"), (1024, 4096, 64, "highest"),
                 (4096, 8192, 512, "high"), (2048, 6144, 16, "mixed"),
                 (256, 2048, 8, "default")]:
        assert ck._pallas_block(*args) == _pallas_block(*args), args
    assert ck._pallas_block(2048, 1 << 20, 16, "high") == 1024


def test_plain_versions_identity_on_rows_without_pairs():
    """Row tiles with no live pair get the identity: 0 / INT32_MAX."""
    pts = torch.arange(2 * 256, dtype=torch.float32).reshape(2, 256)
    row_ptr = torch.tensor([0, 1, 1], dtype=torch.int32)
    cols = torch.tensor([0], dtype=torch.int32)
    ones = torch.ones(256, dtype=torch.int32)
    c = counts_over_pairs(pts, ones, row_ptr, cols, eps2_f32(1.5), 128)
    assert (c[128:] == 0).all() and (c[:128] >= 1).all()
    m = minlab_over_pairs(pts, ones * 5, row_ptr, cols, eps2_f32(1.5), 128)
    assert (m[128:] == INT_INF).all() and (m[:128] == 5).all()


def test_wrappers_use_plain_versions_on_cpu_without_launching():
    X, mask = guard_banded_blobs(16, n=512, seed=1)
    pts, msk = _port_inputs(X, mask)
    (rows, cols), _ = ck.kernel_pair_list(pts, EPS, msk, 128, "high")
    nt = pts.shape[1] // 128
    rp = row_offsets(rows, nt)
    mi = msk.to(torch.int32)
    ck.reset_launch_counts()
    got = ck.count_pairs(pts, mi, rp, cols, eps2_f32(EPS), 128)
    want = counts_over_pairs(pts, mi, rp, cols, eps2_f32(EPS), 128)
    assert torch.equal(got, want)
    assert {"count_pairs", "minlab_pairs", "count_pairs_sketch",
            "minlab_pairs_sketch", "query_leaf"} <= set(ck.LAUNCHES)
    assert not any(ck.LAUNCHES.values())


@pytest.mark.parametrize("bad", ["dtype", "tile", "row_ptr"])
def test_wrappers_reject_bad_inputs(bad):
    pts = torch.zeros((4, 256), dtype=torch.float32)
    colval = torch.ones(256, dtype=torch.int32)
    row_ptr = torch.zeros(3, dtype=torch.int32)
    cols = torch.zeros(1, dtype=torch.int32)
    tile = 128
    if bad == "dtype":
        pts = pts.double()
    elif bad == "tile":
        tile = 100
    else:
        row_ptr = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.count_pairs(pts, colval, row_ptr, cols, 1.0, tile)


def test_build_library_name_tracks_sources(tmp_path, monkeypatch):
    """The compiled library is keyed by the sources and flags, and lands
    in the build directory (never in the package)."""
    from pypardis_tpu_torch.csrc import _build

    monkeypatch.setenv("PPTORCH_BUILD_DIR", str(tmp_path))
    path = _build._library_path()
    assert path.startswith(str(tmp_path)) and path.endswith(".so")
    assert path == _build._library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build._library_path() != path


def test_build_without_nvcc_raises(monkeypatch):
    from pypardis_tpu_torch.csrc import _build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
