"""B1's tensor-core counts pass on the CPU.

The kernel (``csrc/pair_kernels.cu``, ``b1_tc_kernel``, d <= 64, every
precision mode) takes d^2 on the tensor cores from bf16 operands
recentred on the row tile's centre, decides each pair outside a band
around eps^2 that it proves for every pair of a 64-column chunk, and
sends the rest to the exact axis-ordered d^2.  It cannot run here, so
these tests hold its rule: :func:`certified_count_walk` emulates it
operation for operation and must return the plain counts bitwise (and
the JAX package's Pallas counts in interpret mode), its ``"mixed"``
stats must be the plain ``"mixed"`` version's, and the chunk band must
bound ``|d2f - d2|`` for every pair it covers.  On the card
``chip_smoke.py`` and ``tests/test_torch_card.py`` hold the kernel's
counts bitwise and its ``rescored_pairs`` near the emulation's.

Inputs are made with numpy from fixed seeds (stated per geometry); the
bar is exact equality everywhere except the band test, which compares
in float64 with no tolerance beyond the band itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu.ops import pallas_kernels as jpk
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops.distances import (
    B1_CHUNK,
    _pair_d2,
    axis_sq,
    b1_chunk_band,
    bf16_round,
    certified_count_walk,
    counts_over_pairs,
    counts_over_pairs_mixed,
    eps2_f32,
    row_offsets,
)
from test_torch_precision import BLOCK, _layout, adversarial

GEOMS = ("blobs750", "separated", "adversarial")
DIMS = (3, 16, 64)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain passes are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _geometry(name, d):
    """``(X, eps)`` float32.  ``blobs750``: the reference demo's recipe
    (750 points, three blobs of std 0.4 at +-1 corners, standardised)
    in d axes, seed 0, eps 0.35 sqrt(2 d) (near the typical within-blob
    distance, so that pairs lie near eps at every d: the demo's 0.3 at
    2-D leaves none near it at 16-D); ``separated``: benchdata's
    separated blobs (seed 0), eps as ``test_torch_dbscan``'s; and the
    adversarial geometry (seed 3: duplicates, pairs at eps (1 -+ 1e-4),
    a 1e3 offset)."""
    if name == "blobs750":
        rng = np.random.default_rng(0)
        corners = rng.choice([-1.0, 1.0], size=(3, d))
        X = corners[rng.integers(0, 3, 750)] + rng.normal(
            scale=0.4, size=(750, d))
        X = (X - X.mean(0)) / X.std(0)
        return X.astype(np.float32), round(0.35 * np.sqrt(2.0 * d), 3)
    if name == "separated":
        wide = d >= 64
        X, _t, _c = benchdata.make_separated_blob_data(
            1500, d, n_centers=6, std=0.3 if wide else 0.4,
            min_sep=12.0 if wide else 8.0, spread=20.0 if wide else 10.0)
        return X.astype(np.float32), {3: 0.9, 16: 2.4, 64: 4.0}[d]
    eps = round(0.9 * np.sqrt(d / 8.0), 3)
    return adversarial(n=1500, d=d, eps=eps, offset=1e3), eps


_CACHE = {}


def _inputs(name, d):
    """B1's inputs on the fit's own layout, with the row tiles' frames
    (cached per geometry and d)."""
    key = (name, d)
    if key not in _CACHE:
        X, eps = _geometry(name, d)
        xs, mask = _layout(X, eps)
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, BLOCK, "high", budget=1 << 16)
        assert total <= budget
        tile = ck._pallas_block(BLOCK, xs.shape[1], d, "high")
        rp = row_offsets(rows, xs.shape[1] // tile)
        centers, rnorm = ck.tile_frames(xs, mask, tile)
        a = (xs, mask.to(torch.int32), rp, cols, eps2_f32(eps), tile)
        _CACHE[key] = dict(a=a, X=X, eps=eps, mask=mask, centers=centers,
                           rnorm=rnorm)
    return _CACHE[key]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", GEOMS)
def test_walk_counts_equal_plain_and_the_jax_pallas_b1(name, d):
    """The emulated kernel's counts are bitwise the plain B1's on every
    row, and some pairs were queued.  Against the JAX Pallas B1
    (``precision="highest"``, interpret mode), whose augmented matmul
    rounds otherwise, a valid row's count may differ only by its pairs
    whose float64 d^2 lies within ``exact_slack`` of eps^2 (as in
    ``test_torch_kernels``), and most rows have none."""
    from pypardis_tpu_torch.ops.precision import exact_slack

    inp = _inputs(name, d)
    a, mask = inp["a"], inp["mask"]
    got, rescored, fragile = certified_count_walk(*a, inp["centers"])
    assert torch.equal(got, counts_over_pairs(*a))
    assert rescored > 0 and fragile >= 0
    xs = a[0]
    want = np.asarray(jpk.neighbor_counts_pallas(
        jnp.asarray(xs.numpy()), inp["eps"], jnp.asarray(mask.numpy()),
        block=BLOCK, precision="highest", interpret=True, layout="dn"))
    m = mask.numpy()
    x64 = xs.numpy().T[m].astype(np.float64)
    sq = (x64 * x64).sum(1)
    d2 = ((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    nrm = float(np.sqrt(sq.max()))
    near = (np.abs(d2 - np.float64(a[4])) <= exact_slack(nrm, nrm)).sum(1)
    diff = np.abs(got.numpy()[m] - want[m])
    assert (diff <= near).all()
    assert (diff == 0).mean() > 0.9


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", GEOMS)
def test_walk_mixed_stats_equal_the_plain_mixed_version(name, d):
    """With the row tiles' rnorm the walk also counts the reference
    band's ``[band_pairs, rescored_tiles]`` over the same d2f: exactly
    :func:`counts_over_pairs_mixed`'s, and its counts are the exact
    ones."""
    inp = _inputs(name, d)
    a = inp["a"]
    (got, stats), _r, _f = certified_count_walk(*a, inp["centers"],
                                                inp["rnorm"])
    want, wstats = counts_over_pairs_mixed(*a, inp["centers"],
                                           inp["rnorm"])
    assert torch.equal(stats, wstats)
    assert torch.equal(got, counts_over_pairs(*a))
    m = inp["mask"]
    assert torch.equal(got[m], want[m])


@pytest.mark.parametrize("d", DIMS)
def test_wrapper_adds_the_walks_count_on_the_cpu(d):
    """On the CPU ``count_pairs(..., rescored_pairs=)`` returns the plain
    counts and adds the walk's queued count (with the staged centres or,
    given none, the box centres over the mask); ``"default"`` takes no
    such counter."""
    inp = _inputs("adversarial", d)
    a = inp["a"]
    rc = torch.zeros(1, dtype=torch.int64)
    got = ck.count_pairs(*a, inp["centers"], rescored_pairs=rc)
    assert torch.equal(got, counts_over_pairs(*a))
    want = certified_count_walk(*a, inp["centers"])[1]
    assert int(rc[0]) == want
    rc2 = torch.zeros(1, dtype=torch.int64)
    ck.count_pairs(*a, rescored_pairs=rc2)
    assert int(rc2[0]) == want
    rc3 = torch.zeros(1, dtype=torch.int64)
    ck.count_pairs_mixed(*a, inp["centers"], inp["rnorm"],
                         rescored_pairs=rc3)
    assert int(rc3[0]) == want
    with pytest.raises(ValueError):
        ck._launch_count("default", *a, inp["centers"],
                         rescored_pairs=torch.zeros(1, dtype=torch.int64))


def _pairs(kind, d, m, seed):
    """``m`` (row, column, centre) float32 triples at d axes (seed
    ``seed``): ``random`` directions at scales 1e-3..1e3 about a centre
    off both points; ``near`` pairs at d2 = eps2 (1 + 1e-4 t), t in
    [-1, 1], the column a hair off the row's bf16 rounding midpoints."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, size=(m, 1))
    x = rng.normal(size=(m, d)) * scale
    c = x + rng.normal(size=(m, d)) * scale * 2.0
    if kind == "random":
        y = x + rng.normal(size=(m, d)) * scale
    else:
        v = rng.normal(size=(m, d))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        t = 1.0 + 1e-4 * rng.uniform(-1, 1, size=(m, 1))
        y = x + scale * np.sqrt(t) * v
        ym = np.ldexp(np.round(np.ldexp(y - c, 7)) + 0.5 - 1e-3, -7)
        y = np.where(np.abs(y - c) < 1.0, c + ym, y)
    return (np.asarray(v, np.float32) for v in (x, y, c))


@pytest.mark.parametrize("K", [16, 32, 64])
@pytest.mark.parametrize("kind", ["random", "near"])
def test_chunk_band_bounds_every_pair_in_float64(kind, K):
    """For every pair of a chunk, ``|d2f - d2| <= band`` in float64,
    ``d2`` the exact axis-ordered d^2 and ``d2f`` from the bf16 operands
    with the cross term summed three ways (float64, forward and reversed
    float32), both as the plain version rounds it and as the kernel takes
    it (``|X|^2 + fl(|Y|^2 - 2 dot)``): 64 rows of one tile against 64
    columns of one chunk, at d = K (a full last k-step) and d = K - 5
    (zero pad axes)."""
    for d in (K, K - 5):
        x, y, c = _pairs(kind, d, B1_CHUNK, seed=K + d)
        ctr = torch.from_numpy(c[:1])  # one centre for the row tile
        xt = torch.from_numpy(np.ascontiguousarray(x.T))[:, None, :]
        yt = torch.from_numpy(np.ascontiguousarray(y.T))[:, None, :]
        cc = ctr.T[:, :, None]
        xc, yc = xt - cc, yt - cc
        band = b1_chunk_band(xc, yc, torch.ones(1, B1_CHUNK,
                                                dtype=torch.bool))
        d2 = _pair_d2(xt, yt).double()
        xh, yh = bf16_round(xc)[:, 0].double(), bf16_round(yc)[:, 0].double()
        s = (axis_sq(xc)[0][:, None] + axis_sq(yc)[0][None, :]).double()
        prods = xh[:, :, None] * yh[:, None, :]  # (d, rows, cols), exact
        sums = [prods.sum(0)]
        for order in (range(d), reversed(range(d))):
            acc = torch.zeros(prods.shape[1:], dtype=torch.float32)
            for a in order:
                acc = acc + prods[a].float()
            sums.append(acc.double())
        xx = axis_sq(xc)[0][:, None].double()
        yy = axis_sq(yc)[0][None, :].double()
        for dot in sums:
            # The plain form fl(fl(xx + yy) - 2 dot), and the kernel's:
            # xx + fl(yy - 2 dot) in real arithmetic.
            d2f = (s.float().double() - 2.0 * dot.float().double()).float()
            t = (yy.float().double() - 2.0 * dot.float().double()).float()
            for got in (d2f.double(), xx + t.double()):
                err = (got - d2[0]).abs()
                assert bool((err <= band[0].double()).all()), float(
                    (err / band[0].double()).max())
