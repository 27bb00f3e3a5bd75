"""The port's precision modes against the JAX package on the CPU, unit by
unit: the mode surface, the row tiles' centres and norms, the mixed band
(its soundness on adversarial data and its width against the JAX band),
the plain bf16 versions of B1/B2 against the FP32 ones and against the
Pallas kernels in interpret mode, the B5 prefilter, and the wrappers'
checks.  Fits, serving and the phase-8 rehearsal are in
tests/test_torch_precision_fits.py.

The plain versions emulate the card's bf16 pass exactly (operands
recentred, rounded to bf16 once, products exact in FP32); the JAX
package's CPU "default" dot is full FP32, so its band statistics are
compared within a stated tolerance and its verdicts on data whose pairs
all lie outside the bf16 band.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypardis_tpu.ops import distances as jdist
from pypardis_tpu.ops import pallas_kernels as jpk
from pypardis_tpu.ops import precision as jprec
from pypardis_tpu.ops import query as jquery
from pypardis_tpu.partition import spatial_order
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops import precision as tprec
from pypardis_tpu_torch.ops import query as tquery
from pypardis_tpu_torch.ops.distances import (
    INT_INF,
    _fast_d2,
    _pair_d2,
    eps2_f32,
    fast_band,
    row_offsets,
)
from test_torch_kernels import EPS, guard_banded_blobs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


BLOCK = 256


def adversarial(n=3000, d=8, eps=0.9, seed=3, offset=0.0):
    """tests/test_mixed_precision.py's geometry: 12 blobs, duplicate
    points and pairs planted at eps * (1 -+ 1e-4) from ten anchors, all
    shifted by ``offset``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(12, d))
    X = centers[rng.integers(0, 12, n)] + rng.normal(scale=0.25, size=(n, d))
    X[10] = X[11]
    X[12] = X[13] = X[14]
    for i, anchor in enumerate(range(0, 50, 5)):
        v = rng.normal(size=d)
        v /= np.linalg.norm(v)
        X[100 + 2 * i] = X[anchor] + (eps * (1 - 1e-4)) * v
        X[101 + 2 * i] = X[anchor] + (eps * (1 + 1e-4)) * v
    return (X + offset).astype(np.float32)


def _layout(X, eps, block=BLOCK):
    """The fit's own (d, cap) layout (Morton sort, centring, padding)."""
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

    pts, n, block = _stage(X, block, torch.device("cpu"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    return xs, mask


def _inputs(xs, mask, eps, mode="mixed", block=BLOCK):
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, mode)
    assert total <= budget
    d, n = xs.shape
    tile = ck._pallas_block(block, n, d, mode)
    return row_offsets(rows, n // tile), cols, tile


def test_every_mode_is_ported():
    assert tprec.PRECISION_MODES == jprec.PRECISION_MODES
    assert not hasattr(tprec, "require_ported")
    for mode in tprec.PRECISION_MODES:
        assert tprec.norm_precision_mode(mode.upper()) == mode
    for nx, ny in ((0.0, 0.0), (1.5, 2.25), (300.0, 7.0)):
        assert tprec.band_halfwidth(nx, ny) == jprec.band_halfwidth(nx, ny)
        assert tprec.exact_slack(nx, ny) == jprec.exact_slack(nx, ny)


@pytest.mark.parametrize("d", [3, 16])
def test_centers_dn_matches_jax(d):
    """Box centres of the valid coordinates, 0 for an empty tile."""
    X, mask = guard_banded_blobs(d, n=1024, seed=2)
    mask[256:512] = False  # an empty tile
    pts = torch.from_numpy(np.ascontiguousarray(X.T))
    got = ck._centers_dn(pts, torch.from_numpy(mask), 4, 256).numpy()
    want = np.asarray(jpk._centers_dn(jnp.asarray(X.T), jnp.asarray(mask),
                                      4, 256))[:, :, 0]
    assert got.shape == (4, d)
    assert np.array_equal(got, want)
    assert not got[1].any()


@pytest.mark.parametrize("offset", [0.0, 1e3], ids=["offset0", "offset1e3"])
def test_mixed_band_is_sound_on_adversarial_data(offset):
    """Over every pair of every live tile pair of the fit's layout: no
    pair outside the band has a bf16 verdict that differs from the exact
    verdict, and the planted near-eps pairs do fall in the band."""
    eps = 0.9
    xs, mask = _layout(adversarial(offset=offset), eps)
    rp, cols, tile = _inputs(xs, mask, eps)
    d, n = xs.shape
    nt = n // tile
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    t3 = xs.reshape(d, nt, tile)
    m2 = mask.reshape(nt, tile)
    e2 = eps2_f32(eps)
    rows = torch.repeat_interleave(torch.arange(nt),
                                   (rp[1:] - rp[:-1]).long())
    cols = cols[:int(rp[-1])].long()
    flipped = in_band = 0
    for s in range(0, len(rows), 16):
        r, c = rows[s:s + 16], cols[s:s + 16]
        d2f, yy = _fast_d2(t3[:, r], t3[:, c], centers[r])
        exact = _pair_d2(t3[:, r], t3[:, c]) <= e2
        valid = m2[c]
        ny = torch.sqrt(torch.where(valid, yy, 0.0).amax(dim=1))
        gy = torch.sqrt(torch.where(
            valid, (t3[:, c] * t3[:, c]).sum(0), 0.0).amax(dim=1))
        band = fast_band(rnorm[r, 0], ny, rnorm[r, 1], gy)[:, None, None]
        both = valid[:, None, :] & m2[r][:, :, None]
        out = ((d2f - e2).abs() > band) & both
        flipped += int(((d2f <= e2) != exact)[out].sum())
        in_band += int((~out & both).sum())
    assert flipped == 0
    assert in_band > 0


def test_mixed_band_equals_the_jax_band_at_the_same_tiles():
    """``fast_band`` at the kernels' per-entry norms is the JAX
    package's ``_mixed_band_t`` (masked recentred and frame norm maxima)
    up to float32 summation order: never tighter than it by more than a
    few ulps."""
    xs, mask = _layout(adversarial(n=1500, d=16, eps=1.27), 1.27)
    rp, cols, tile = _inputs(xs, mask, 1.27)
    d, n = xs.shape
    nt = n // tile
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    t3 = xs.reshape(d, nt, tile)
    m2 = mask.reshape(nt, tile)
    rows = torch.repeat_interleave(torch.arange(nt),
                                   (rp[1:] - rp[:-1]).long())
    for r, c in list(zip(rows.tolist(), cols[:int(rp[-1])].tolist()))[:12]:
        yc = t3[:, c] - centers[r][:, None]
        ny = torch.sqrt(torch.where(m2[c], (yc * yc).sum(0), 0.0).max())
        gy = torch.sqrt(torch.where(m2[c], (t3[:, c] ** 2).sum(0), 0.0).max())
        got = float(fast_band(rnorm[r, 0], ny, rnorm[r, 1], gy))
        want = float(jdist._mixed_band_t(
            jnp.asarray(t3[:, r].numpy()), jnp.asarray(t3[:, c].numpy()),
            jnp.asarray(centers[r].numpy())[:, None],
            jnp.asarray(m2[r].numpy()), jnp.asarray(m2[c].numpy()),
        ))
        assert got >= want * (1 - 1e-6)
        assert got <= want * (1 + 1e-6)


@pytest.mark.parametrize("d,eps", [(3, 1.2), (16, 2.4), (96, 6.0)])
def test_plain_mixed_equals_plain_high(d, eps):
    """Counts and min labels of the bf16 pass with its rescore equal the
    FP32 pass's on every valid row; default differs only as bf16 does."""
    from benchdata import make_blob_data

    X, _ = make_blob_data(2500, d, n_centers=6, std=0.4, seed=d)
    xs, mask = _layout(X, eps)
    rp, cols, tile = _inputs(xs, mask, eps)
    mi, e2 = mask.to(torch.int32), eps2_f32(eps)
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    got, stats = ck.count_pairs_mixed(xs, mi, rp, cols, e2, tile, centers,
                                      rnorm)
    want = ck.count_pairs(xs, mi, rp, cols, e2, tile)
    assert torch.equal(got[mask], want[mask])
    assert int(stats[0]) > 0 and int(stats[1]) > 0
    core = (want >= 10) & mask
    lab = torch.where(core, torch.arange(len(want), dtype=torch.int32),
                      INT_INF).contiguous()
    best = ck.minlab_pairs_mixed(xs, lab, rp, cols, e2, tile, centers, rnorm)
    assert torch.equal(best[mask],
                       ck.minlab_pairs(xs, lab, rp, cols, e2, tile)[mask])
    dflt = ck.count_pairs_default(xs, mi, rp, cols, e2, tile, centers)
    assert (dflt[mask] - want[mask]).abs().sum() <= stats[0]


@pytest.mark.parametrize("mode", ["mixed", "default", "high"])
def test_staged_frames_serve_every_pass(mode):
    """``pass_frames`` gives each mode the row frames its passes read
    (at d <= 64 every mode's B1 recentres on the tiles' centres; only
    ``"mixed"`` reads rnorm), and the entry points answer the same with
    them staged as with their own."""
    xs, mask = _layout(adversarial(n=1500, d=16, eps=1.27), 1.27)
    tile = ck._pallas_block(BLOCK, xs.shape[1], 16, mode)
    centers, rnorm = ck.pass_frames(xs, mask, tile, mode)
    want_c, want_r = ck.tile_frames(xs, mask, tile)
    assert torch.equal(centers, want_c)
    assert rnorm is None if mode != "mixed" else torch.equal(rnorm, want_r)
    kw = dict(block=BLOCK, precision=mode, sketch=0)
    own = ck.neighbor_counts_cuda(xs, 1.27, mask, **kw)
    staged = ck.neighbor_counts_cuda(xs, 1.27, mask, frames=(centers, rnorm),
                                     **kw)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (own, staged))):
        assert torch.equal(a, b)
    core = (own[0] if isinstance(own, tuple) else own) >= 6
    lab = torch.arange(xs.shape[1], dtype=torch.int32)
    own = ck.min_neighbor_label_cuda(xs, lab, 1.27, core, row_mask=mask, **kw)
    staged = ck.min_neighbor_label_cuda(xs, lab, 1.27, core, row_mask=mask,
                                        frames=(centers, rnorm), **kw)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (own, staged))):
        assert torch.equal(a, b)


def test_plain_versions_match_pallas_interpret():
    """The entry points under "mixed" against the Pallas kernels in
    interpret mode: counts and min labels bitwise on valid rows.  Band
    statistics within 5 %: the JAX CPU fast pass is FP32 (not bf16),
    its band leaves out the exact slack and takes the row maxima over
    every row, and it counts every row where the port counts valid ones.
    """
    X, mask = guard_banded_blobs(16)
    pts = torch.from_numpy(np.ascontiguousarray(X.T))
    msk = torch.from_numpy(mask)
    got, stats = ck.neighbor_counts_cuda(pts, EPS, msk, block=BLOCK,
                                         precision="mixed")
    want, jstats = jpk.neighbor_counts_pallas(
        jnp.asarray(X), EPS, jnp.asarray(mask), block=BLOCK,
        precision="mixed", interpret=True,
    )
    assert np.array_equal(got.numpy()[mask], np.asarray(want)[mask])
    jst = np.asarray(jstats).astype(np.int64)
    assert jst[0] > 0 and int(stats[0]) > 0
    assert abs(int(stats[0]) - jst[0]) <= 0.05 * jst[0]
    assert abs(int(stats[1]) - jst[1]) <= max(2, 0.05 * jst[1])
    core = (got >= 8) & msk
    labels = np.random.default_rng(3).permutation(len(X)).astype(np.int32)
    best, zeros = ck.min_neighbor_label_cuda(
        pts, torch.from_numpy(labels), EPS, core, block=BLOCK,
        precision="mixed", row_mask=msk,
    )
    jbest, _ = jpk.min_neighbor_label_pallas(
        jnp.asarray(X), jnp.asarray(labels), EPS, jnp.asarray(core.numpy()),
        block=BLOCK, precision="mixed", interpret=True,
        row_mask=jnp.asarray(mask),
    )
    assert np.array_equal(best.numpy()[mask], np.asarray(jbest)[mask])
    assert not zeros.any()


def test_plain_default_matches_pallas_interpret_on_guard_banded_data():
    """Under "default" on data whose every pair lies outside the bf16
    band (a jittered integer lattice, d^2 at least 0.45 from eps^2 = 23),
    the port's bf16 verdicts equal the JAX CPU pass's exact ones."""
    from test_torch_precision_fits import lattice

    X = lattice()
    n = len(X) - len(X) % 256
    X, mask = X[:n], np.ones(n, bool)
    X = X[spatial_order(X)]
    eps = float(np.sqrt(23.0))
    pts = torch.from_numpy(np.ascontiguousarray(X.T))
    got = ck.neighbor_counts_cuda(pts, eps, torch.from_numpy(mask),
                                  block=BLOCK, precision="default")
    want = jpk.neighbor_counts_pallas(
        jnp.asarray(X), eps, jnp.asarray(mask), block=BLOCK,
        precision="default", interpret=True,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fast_block_keep_is_a_sound_prefilter():
    """Every block holding a real pair within eps is kept (so the
    verdict never changes), pad slots and pad rows are excluded by mask,
    and blocks far from every query are skipped."""
    rng = np.random.default_rng(4)
    d, nqt, qb, nbk, blk = 5, 6, 16, 4, 32
    q = rng.normal(size=(nqt, d, qb)).astype(np.float32) + 1e3
    cols = (rng.normal(size=(d, nqt, nbk, blk)) * 1.5).astype(np.float32) + 1e3
    cols[:, :, 3] += 50.0  # far blocks
    labs = rng.integers(0, 9, size=(nqt, nbk, blk)).astype(np.int32)
    labs[:, 1, blk // 2:] = INT_INF  # half-pad blocks
    cols[:, :, 1, blk // 2:] = tquery.PAD_COORD
    labs[:, 2] = INT_INF  # all-pad blocks
    cols[:, :, 2] = tquery.PAD_COORD
    q[:, :, -2:] = tquery.PAD_COORD  # pad rows
    qt, ct, lt = (torch.from_numpy(a) for a in (q, cols, labs))
    e2 = eps2_f32(1.3)
    keep = tquery.fast_block_keep(qt, ct, lt, e2)
    x = q.astype(np.float64)
    c = cols.astype(np.float64)
    d2 = ((x.transpose(0, 2, 1)[:, None, :, None, :]
           - c.transpose(1, 2, 3, 0)[:, :, None, :, :]) ** 2).sum(-1)
    real = (labs != INT_INF)[:, :, None, :] & (np.abs(q) < 1e18).all(1)[
        :, None, :, None]
    need = ((d2 <= e2) & real).any(axis=(2, 3))
    assert need.any()
    assert bool(keep[torch.from_numpy(need)].all())
    assert not keep[:, 2].any() and not keep[:, 3].any()


def test_query_plain_mixed_equals_exact_after_the_verdict():
    """The plain B5 under "mixed" against the exact one and against the
    JAX XLA query kernel under "mixed", after the verdict, on real
    rows."""
    rng = np.random.default_rng(6)
    d, nqt, qb, L, blk, nb = 4, 8, 32, 3, 32, 4
    C = blk * nb
    coords = rng.normal(size=(d, L * C)).astype(np.float32)
    labels = rng.integers(0, 40, L * C).astype(np.int32)
    coords[:, L * C - 40:] = tquery.PAD_COORD
    labels[L * C - 40:] = INT_INF
    q = (rng.normal(size=(nqt, d, qb)) * 1.3).astype(np.float32)
    q[:, :, -3:] = tquery.PAD_COORD
    tl = rng.integers(0, L, nqt).astype(np.int32)
    e2 = eps2_f32(0.8)
    args = [torch.from_numpy(a) for a in (q, tl, coords, labels)]
    mixed = ck.query_leaf(*args, block=blk, nb=nb, precision="mixed",
                          eps2=e2)
    exact = ck.query_leaf(*args, block=blk, nb=nb)
    valid = labels != INT_INF
    c3 = coords.reshape(d, L * nb, blk)
    blo = np.where(valid.reshape(L * nb, blk)[None], c3, 3e38).min(2).T
    bhi = np.where(valid.reshape(L * nb, blk)[None], c3, -3e38).max(2).T
    jout = jquery.query_min_core(
        jnp.asarray(q), jnp.asarray(np.ones((nqt, qb), bool)),
        jnp.asarray(tl), jnp.asarray(coords), jnp.asarray(labels),
        jnp.asarray(blo), jnp.asarray(bhi), jnp.float32(e2), jnp.int32(0),
        block=blk, nb=nb, precision="mixed",
    )

    def verdict(p):
        p = np.asarray(p)
        d2 = p[1].view(np.float32)[:, :qb - 3]
        ok = d2 <= np.float32(e2)
        return np.where(ok, p[0][:, :qb - 3], -1), np.where(ok, d2, np.inf)

    got = verdict(mixed.numpy())
    for other in (exact.numpy(), jout):
        want = verdict(other)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
    assert (got[0] >= 0).any() and (got[0] < 0).any()


def test_launch_keys_and_cpu_wrappers():
    """One launch count per kernel and mode; on the CPU the wrappers run
    their plain versions and launch nothing."""
    assert set(ck.LAUNCHES) == {
        f"{base}{suffix}"
        for base in ("count_pairs", "minlab_pairs", "count_pairs_sketch",
                     "minlab_pairs_sketch")
        for suffix in ("", "_mixed", "_default")
    } | {"query_leaf", "query_leaf_mixed", "query_tables"}
    X, mask = guard_banded_blobs(16, n=512, seed=1)
    pts = torch.from_numpy(np.ascontiguousarray(X.T))
    ck.reset_launch_counts()
    for mode in ("mixed", "default"):
        out = ck.neighbor_counts_cuda(pts, EPS, torch.from_numpy(mask),
                                      block=128, precision=mode)
        assert isinstance(out, tuple) == (mode == "mixed")
    assert not any(ck.LAUNCHES.values())


def test_wrappers_reject_bad_frames():
    pts = torch.zeros((4, 256), dtype=torch.float32)
    colval = torch.ones(256, dtype=torch.int32)
    row_ptr = torch.zeros(3, dtype=torch.int32)
    cols = torch.zeros(1, dtype=torch.int32)
    good_c = torch.zeros((2, 4))
    good_r = torch.zeros((2, 2))
    ck.count_pairs_mixed(pts, colval, row_ptr, cols, 1.0, 128, good_c, good_r)
    with pytest.raises(ValueError, match="centers"):
        ck.count_pairs_mixed(pts, colval, row_ptr, cols, 1.0, 128,
                             good_c[:1], good_r)
    with pytest.raises(ValueError, match="rnorm"):
        ck.count_pairs_mixed(pts, colval, row_ptr, cols, 1.0, 128, good_c,
                             good_r.double())
    with pytest.raises(ValueError, match="rnorm"):
        ck.count_pairs_mixed(pts, colval, row_ptr, cols, 1.0, 128, good_c,
                             None)
    slab = torch.zeros((8, 256))
    with pytest.raises(ValueError, match="centers"):
        ck.count_pairs_sketch(pts, colval, row_ptr, cols, slab, 4, 1.0, 0.1,
                              128, "default")
    # B3 recentres its certified rescore in every mode; B4's exact
    # rescore takes no centres outside "default".
    with pytest.raises(ValueError, match="centers"):
        ck.minlab_pairs_sketch(pts, colval, row_ptr, cols, slab, 4, 1.0, 0.1,
                               128, "mixed", good_c)
    with pytest.raises(ValueError, match="centers"):
        ck.count_pairs_sketch(pts, colval, row_ptr, cols, slab, 4, 1.0, 0.1,
                              128, "mixed", good_c[:1])
    with pytest.raises(ValueError, match="eps2"):
        ck.query_leaf(torch.zeros((1, 4, 8)), torch.zeros(1, dtype=torch.int32),
                      torch.zeros((4, 32)), torch.zeros(32, dtype=torch.int32),
                      block=16, nb=2, precision="mixed")
