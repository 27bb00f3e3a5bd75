"""Card-only tests of the GPU package: the CUDA kernels against their
plain versions, a fit on the card against the same fit on the CPU (and
a sketched fit against an unsketched one), and serving on the card
against the same serving on the CPU.

They need a CUDA device and skip without one.  They import neither JAX
nor the JAX package, so on a machine without JAX they run with
``python -m pytest tests/test_torch_card.py --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from benchdata import (
    make_blob_data, make_embedding_data, make_separated_blob_data,
)
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.dbscan import _stage
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops.distances import (
    INT_INF, certified_rescore_walk, counts_over_pairs, eps2_f32,
    minlab_over_pairs, minlab_pairs_walk, minlab_skip_walk, row_offsets,
)
from pypardis_tpu_torch.ops.labels import _pointer_jump
from pypardis_tpu_torch.ops.pipeline import _pipeline_layout
from pypardis_tpu_torch.ops.query import (
    PAD_COORD, query_block_frames, query_keep_walk, query_leaf_ends,
    query_min_core_plain, query_pad_keys, query_pass_pairs, query_skip_walk,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("d,eps", [(3, 1.2), (16, 2.4), (64, 4.8),
                                   (96, 6.0)])
def test_kernels_equal_plain_versions_on_card(d, eps):
    """Kernel and plain version share their d^2 arithmetic, so they are
    bitwise equal on any data (exact equality, no tolerance)."""
    _need_card()
    X, _ = make_blob_data(20_000, d, n_centers=8, std=0.4, seed=d)
    pts, n, block = _stage(X, 1024, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, "high"
    )
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], d, "high")
    rp = row_offsets(rows, xs.shape[1] // tile)
    mi = mask.to(torch.int32)
    e2 = eps2_f32(eps)
    before = dict(ck.LAUNCHES)
    got = ck.count_pairs(xs, mi, rp, cols, e2, tile)
    assert torch.equal(got, counts_over_pairs(xs, mi, rp, cols, e2, tile))
    core = (torch.where(mask, got, 0) >= 10) & mask
    lab = torch.where(
        core, torch.arange(len(got), device="cuda", dtype=torch.int32),
        INT_INF,
    ).contiguous()
    best = ck.minlab_pairs(xs, lab, rp, cols, e2, tile)
    assert torch.equal(best, minlab_over_pairs(xs, lab, rp, cols, e2, tile))
    assert ck.LAUNCHES["count_pairs"] == before["count_pairs"] + 1
    assert ck.LAUNCHES["minlab_pairs"] == before["minlab_pairs"] + 1


@pytest.mark.cuda
def test_card_fit_equals_cpu_fit():
    _need_card()
    X, truth = make_blob_data(8000, 16, n_centers=8, std=0.4, seed=3)
    gpu = DBSCAN(eps=2.4, min_samples=10, block=256).fit(X)
    cpu = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu").fit(X)
    assert np.array_equal(gpu.labels_, cpu.labels_)
    assert np.array_equal(gpu.core_sample_mask_, cpu.core_sample_mask_)
    tensor = DBSCAN(eps=2.4, min_samples=10, block=256).fit(
        torch.from_numpy(X).cuda()
    )
    assert tensor.labels_.max() == gpu.labels_.max()


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices():
    _need_card()
    pts = torch.zeros((4, 256), device="cuda")
    colval = torch.ones(256, dtype=torch.int32)  # on the CPU
    row_ptr = torch.zeros(3, dtype=torch.int32, device="cuda")
    cols = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="colval"):
        ck.count_pairs(pts, colval, row_ptr, cols, 1.0, 128)


def _query_inputs(d, nqt, qb, L, C, seed, integer):
    """Random B5 inputs: L leaf slabs of C slots with a padded tail (the
    last leaf's last 64 slots, at least one whole block, are pads),
    duplicated cores under other labels, queries equal to core points
    and whole pad rows.  ``integer`` coordinates make exact d^2 ties
    between different labels common."""
    rng = np.random.default_rng(seed)
    if integer:
        coords = rng.integers(-3, 4, size=(d, L * C)).astype(np.float32)
    else:
        coords = rng.normal(size=(d, L * C)).astype(np.float32)
    labels = rng.integers(0, 50, L * C).astype(np.int32)
    coords[:, 5:15] = coords[:, 20:30]  # same point, other labels
    coords[:, L * C - 64:] = PAD_COORD
    labels[L * C - 64:] = INT_INF
    tile_leaf = rng.integers(0, L, nqt).astype(np.int32)
    tile_leaf[0] = L - 1
    if integer:
        q = rng.integers(-3, 4, size=(nqt, d, qb)).astype(np.float32)
    else:
        q = rng.normal(size=(nqt, d, qb)).astype(np.float32)
    for i in range(nqt):  # some rows sit exactly on a core of the leaf
        cols = tile_leaf[i] * C + rng.integers(0, C - 64, 4)
        q[i, :, :4] = coords[:, cols]
    q[:, :, qb - 3:] = PAD_COORD
    return [torch.from_numpy(a).cuda() for a in (q, tile_leaf, coords, labels)]


def query_pad_inputs(d, seed=0):
    """B5 inputs (numpy) with every kind of padding the kernel skips:
    leaf 0 full (no pad slot, so its pad rows answer (+inf, its least
    label)), leaf 1 with a pad tail, leaf 2 with a pad tail and one pad
    slot inside, leaf 3 all pads; tiles with pad rows after their real
    rows, three pad tiles at leaf 0 last, real rows at a core (d2 = 0),
    and real rows near the pad magnitude (every |q_a| >= 1e18), one of
    which sits exactly on PAD_COORD in all axes but one, so a pad slot
    is its nearest slot at a finite d2.  Returns (q, tile_leaf, coords,
    labels, block, nb)."""
    rng = np.random.default_rng(seed)
    L, block, nb, qb, nqt = 4, 32, 6, 80, 9
    C = block * nb
    coords = rng.normal(size=(d, L * C)).astype(np.float32)
    labels = rng.integers(0, 40, L * C).astype(np.int32)
    labels[:C] += 3  # leaf 0's least label is not 0
    for s in (list(range(2 * C - 70, 2 * C)) + [2 * C + 9]
              + list(range(3 * C - 40, 3 * C)) + list(range(3 * C, 4 * C))):
        coords[:, s] = PAD_COORD
        labels[s] = INT_INF
    q = rng.normal(size=(nqt, d, qb)).astype(np.float32)
    tile_leaf = np.array([1, 2, 0, 3, 1, 2, 0, 0, 0], np.int32)
    n_real = [80, 33, 64, 5, 1, 70]
    for t, n in enumerate(n_real):
        q[t, :, n:] = PAD_COORD
        if tile_leaf[t] != 3:
            cols = tile_leaf[t] * C + rng.integers(10, C - 80, 2)
            q[t, :, :2] = coords[:, cols]
    q[len(n_real):] = PAD_COORD
    q[0, :, 7] = 1.5e18
    q[1, :, 20] = PAD_COORD
    q[1, 0, 20] = np.float32(1.99e19)
    q[5, :, 3] = -3e18
    return q, tile_leaf, coords, labels, block, nb


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3, 16, 64, 96])
@pytest.mark.parametrize("shape", [
    # (nqt, qb, L, C, block, integer coordinates)
    (5, 48, 3, 128, 32, True),
    (2, 300, 2, 4096, 256, False),
    (16, 128, 4, 512, 64, False),
])
def test_query_kernel_equals_plain_version_on_card(d, shape):
    """B5 against its plain version on the card, bitwise on labels and
    d^2 bits, pad rows included: exact ties between labels, all-pad
    blocks, pad query rows, queries equal to a core point (d^2 = 0),
    several splits per tile and several row groups per tile."""
    _need_card()
    nqt, qb, L, C, block, integer = shape
    q, tl, coords, labels = _query_inputs(d, nqt, qb, L, C, d, integer)
    tables = ck.query_tables(coords, labels, block=block, nb=C // block)
    before = ck.LAUNCHES["query_leaf"]
    got = ck.query_leaf(q, tl, coords, labels, block=block, nb=C // block,
                        tables=tables)
    want = query_min_core_plain(q, tl, coords, labels, block=block,
                                nb=C // block)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["query_leaf"] == before + 1
    assert torch.equal(got, want)
    d2 = got[1].view(torch.float32)
    assert bool((d2[:, :4] == 0).all())  # rows on a core point
    if integer:
        assert bool((d2[:, :qb - 3] == 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 64, 96])
def test_query_kernel_skips_padding_bitwise_on_card(d):
    """B5 on every kind of padding it skips (pad tiles, pad rows, a full
    leaf, pad tails, an all-pad leaf, real rows near the pad magnitude):
    bitwise its plain version and the plain walk of its skipping, its
    tables bitwise their plain versions, and the pairs its pass counted
    equal to ``query_pass_pairs``'s (no pad tile, pad group or pad tail
    computed; the near rows' groups over the whole slab)."""
    _need_card()
    *arrays, block, nb = query_pad_inputs(d)
    q, tl, coords, labels = (torch.from_numpy(a).cuda() for a in arrays)
    before = dict(ck.LAUNCHES)
    tables = ck.query_tables(coords, labels, block=block, nb=nb)
    ran = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = ck.query_leaf(q, tl, coords, labels, block=block, nb=nb,
                        pass_stats=ran, tables=tables)
    torch.cuda.synchronize()
    assert int(ran) == query_pass_pairs(q, tl, tables[1], block=block,
                                        nb=nb) > 0
    assert ck.LAUNCHES["query_leaf"] == before["query_leaf"] + 1
    assert ck.LAUNCHES["query_tables"] == before["query_tables"] + 1
    # The plain versions on the card: torch's CPU square root may differ
    # from the IEEE one by an ulp; the card's does not.
    C = block * nb
    plain = (query_pad_keys(coords, labels, C),
             query_leaf_ends(coords, labels, C),
             *query_block_frames(coords, labels, block))
    for g, w in zip(tables, plain):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    want = query_min_core_plain(q, tl, coords, labels, block=block, nb=nb)
    assert torch.equal(got, want)
    walk = query_skip_walk(q, tl, coords, labels, tables[0], tables[1],
                           block=block, nb=nb)
    assert torch.equal(got, walk)
    d2 = got[1].view(torch.float32).cpu()
    assert float(d2[1, 20]) < float("inf") and int(got[0, 1, 20]) == INT_INF
    assert bool(torch.isinf(d2[6:, :]).all())  # pad tiles: leaf 0 is full
    lab = got[0].cpu()
    # The all-pad leaf: its real rows keep the starting key, its pad rows
    # meet a pad slot at 0.
    assert bool(torch.isinf(d2[3, :5]).all())
    assert bool((lab[3] == INT_INF).all())
    assert bool((d2[3, 5:] == 0).all()) and bool((d2[1, 33:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 96])
def test_query_mixed_units_against_the_walk_on_card(d):
    """Mixed B5 on the padded inputs: after the verdict, equal to the
    exact kernel on every row with all |q_a| < 1e18; its [kept,
    visited] units equal to query_keep_walk's, kept within its fragile
    units."""
    _need_card()
    *arrays, block, nb = query_pad_inputs(d, seed=1)
    q, tl, coords, labels = (torch.from_numpy(a).cuda() for a in arrays)
    e2 = eps2_f32(0.5 + 0.3 * d ** 0.5)
    tables = ck.query_tables(coords, labels, block=block, nb=nb)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    got = ck.query_leaf(q, tl, coords, labels, block=block, nb=nb,
                        precision="mixed", eps2=e2, keep_stats=stats,
                        tables=tables)
    exact = ck.query_leaf(q, tl, coords, labels, block=block, nb=nb,
                          tables=tables)
    _keep, walk = query_keep_walk(q, tl, coords, labels, tables[2:],
                                  tables[1], e2, block=block, nb=nb)
    torch.cuda.synchronize()
    real = (q.abs() < 1e18).all(dim=1)

    def verdict(p):
        d2 = p[1].view(torch.float32)
        ok = d2 <= e2
        return torch.where(ok, p[0], -1), torch.where(ok, d2, float("inf"))

    (gl, gd), (el, ed) = verdict(got), verdict(exact)
    assert torch.equal(gl[real], el[real])
    assert torch.equal(gd[real].view(torch.int32), ed[real].view(torch.int32))
    assert int(stats[1]) == int(walk[1])
    assert abs(int(stats[0]) - int(walk[0])) <= int(walk[2])
    assert 0 < int(stats[0]) < int(stats[1])


@pytest.mark.cuda
def test_card_serving_equals_cpu_serving():
    _need_card()
    X, _ = make_blob_data(8000, 16, n_centers=8, std=0.4, seed=3)
    gpu = DBSCAN(eps=2.4, min_samples=10, block=256).fit(X)
    cpu = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu").fit(X)
    rng = np.random.default_rng(1)
    Q = np.concatenate([
        X[:500] + rng.normal(scale=0.3, size=(500, 16)),
        rng.uniform(X.min(), X.max(), size=(100, 16)),
    ])
    before = ck.LAUNCHES["query_leaf"]
    eng = gpu.query_engine(leaves=8, block=64, qblock=64)
    got = eng.predict(Q, return_distance=True)
    assert ck.LAUNCHES["query_leaf"] == before + 1
    want = cpu.query_engine(leaves=8, block=64, qblock=64).predict(
        Q, return_distance=True
    )
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    olab, od2 = eng.index.oracle_predict(Q)
    assert np.array_equal(got[0], olab)
    assert np.array_equal(got[1], np.sqrt(od2))
    assert eng.serving_stats()["index_device_bytes"] > 0


@pytest.mark.cuda
def test_card_double_buffered_drain_equals_cpu_drain():
    """Many small batches through the pinned result copies and their
    events: every ticket equals the CPU engine's, one B5 per batch."""
    _need_card()
    X, _ = make_blob_data(8000, 16, n_centers=8, std=0.4, seed=3)
    gpu = DBSCAN(eps=2.4, min_samples=10, block=256).fit(X)
    cpu = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu").fit(X)
    rng = np.random.default_rng(2)
    reqs = [X[rng.integers(0, len(X), 200)]
            + rng.normal(scale=0.3, size=(200, 16)) for _ in range(12)]
    kw = dict(leaves=8, block=64, qblock=64, batch_capacity=400)
    eng, ref = gpu.query_engine(**kw), cpu.query_engine(**kw)
    before = ck.LAUNCHES["query_leaf"]
    got = [eng.submit(r) for r in reqs]
    want = [ref.submit(r) for r in reqs]
    assert eng.drain() == ref.drain() == 2400
    assert eng.serving_stats()["batches"] == 6
    assert ck.LAUNCHES["query_leaf"] == before + 6
    assert eng.device_wait_s >= 0.0 and ref.device_wait_s == 0.0
    for g, w in zip(got, want):
        assert np.array_equal(g.result(), w.result())
        assert np.array_equal(g.d2, w.d2)


def _sketch_inputs(d, k, seed):
    """B3/B4 inputs on the card: embedding data with near-eps pairs
    planted at 2.0 * (1 +- 1e-4) (in the band, so the rescore runs), every
    97th column masked, pad rows past n, and row tile 0 stripped of its
    live pairs (its rows must get the identity)."""
    X, _ = make_embedding_data(12_000, d, seed=seed)
    rng = np.random.default_rng(seed)
    for i, anchor in enumerate(range(0, 400, 20)):
        v = rng.normal(size=d)
        v /= np.linalg.norm(v)
        X[5000 + 2 * i] = X[anchor] + (2.0 * (1 - 1e-4)) * v
        X[5001 + 2 * i] = X[anchor] + (2.0 * (1 + 1e-4)) * v
    pts, n, block = _stage(X, 1024, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, 2.0, n, block, sort=True)
    assert xs.shape[1] > n
    mask = mask & (torch.arange(xs.shape[1], device="cuda") % 97 != 0)
    slab, band = ck.sketch_stage(xs, mask, k)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, 2.0, mask, block, "high", sketch=k, slab=(slab, band))
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], d, "high")
    rp = row_offsets(rows, xs.shape[1] // tile)
    start = int(rp[1])
    assert start > 0
    rp, cols = (rp - start).clamp_min(0).to(torch.int32), cols[start:]
    return xs, mask, slab, band, rp, cols.contiguous(), tile


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(130, 16), (130, 33), (130, 64), (256, 16),
                                 (256, 33), (256, 64), (256, 128), (512, 16),
                                 (512, 33), (512, 64), (512, 128)])
def test_sketch_kernels_equal_plain_versions_on_card(d, k):
    """B3/B4 against their plain versions, bitwise (counts, band_pairs,
    rescored_tiles, min labels), and against B1/B2 on the same list."""
    _need_card()
    xs, mask, slab, band, rp, cols, tile = _sketch_inputs(d, k, d + k)
    mi = mask.to(torch.int32)
    e2 = eps2_f32(2.0)
    a = (xs, mi, rp, cols, slab, k, e2, band, tile)
    before = dict(ck.LAUNCHES)
    got, stats = ck.count_pairs_sketch(
        *a, "high", ck.pass_frames(xs, mask, tile, "high", k)[0])
    want, wstats = ck.PLAIN["count_pairs_sketch"](*a)
    assert torch.equal(got, want) and torch.equal(stats, wstats)
    assert torch.equal(got, ck.count_pairs(xs, mi, rp, cols, e2, tile))
    assert int(stats[0]) > 0 and int(stats[1]) > 0
    assert not got[:tile].any()  # row tile 0 has no live pair
    core = (torch.where(mask, got, 0) >= 10) & mask
    lab = torch.where(
        core, torch.arange(len(got), device="cuda", dtype=torch.int32),
        INT_INF,
    ).contiguous()
    b = (xs, lab, rp, cols, slab, k, e2, band, tile)
    best = ck.minlab_pairs_sketch(*b)
    assert torch.equal(best, ck.PLAIN["minlab_pairs_sketch"](*b))
    assert torch.equal(best, ck.minlab_pairs(xs, lab, rp, cols, e2, tile))
    assert (best[:tile] == INT_INF).all()
    assert ck.LAUNCHES["count_pairs_sketch"] == before[
        "count_pairs_sketch"] + 1
    assert ck.LAUNCHES["minlab_pairs_sketch"] == before[
        "minlab_pairs_sketch"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(256, 64), (512, 128)])
@pytest.mark.parametrize("state", ["round1", "descending", "permuted",
                                   "no_source"])
def test_b4_skip_equals_plain_and_counts_as_the_walk_on_card(d, k, state):
    """B4's label-bound skip: the labels bitwise the plain version's at
    any label state, and the (block, chunk) pairs it evaluates equal to
    minlab_skip_walk's (the same verdicts, so the same running
    minima)."""
    _need_card()
    xs, mask, slab, band, rp, cols, tile = _sketch_inputs(d, k, d + k + 1)
    e2 = eps2_f32(2.0)
    n = xs.shape[1]
    idx = torch.arange(n, device="cuda", dtype=torch.int32)
    lab = {
        "round1": idx,
        "descending": n - 1 - idx,
        "permuted": torch.randperm(
            n, generator=torch.Generator().manual_seed(3)).to(
                "cuda", torch.int32),
        "no_source": torch.full_like(idx, INT_INF),
    }[state]
    lab = torch.where(mask, lab, INT_INF).contiguous()
    b = (xs, lab, rp, cols, slab, k, e2, band, tile)
    ev = torch.zeros(1, dtype=torch.int64, device="cuda")
    best = ck.minlab_pairs_sketch(*b, evaluated=ev)
    want, walked = minlab_skip_walk(*b)
    assert torch.equal(best, ck.PLAIN["minlab_pairs_sketch"](*b))
    assert torch.equal(best, want)
    assert int(ev[0]) == walked
    assert walked <= int(rp[-1]) * -(-tile // 256) * -(-tile // 32)
    assert (walked == 0) == (state == "no_source")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 512])
@pytest.mark.parametrize("geom", ["adversarial", "embedding"])
def test_b3_certified_rescore_bitwise_on_card(geom, d):
    """B3's certified rescore (bf16 tensor-core d^2, per-pair band,
    exact fallback): counts and both stats bitwise the plain version's
    and B1's, under "high" and "mixed", and ``rescored_pairs`` off the
    emulation's by no more than its fragile pairs (those another
    summation order could move across a band edge) nor than
    ``chip_smoke.rescored_tolerance`` (0.1 %)."""
    _need_card()
    from chip_smoke import adversarial, rescored_tolerance

    if geom == "adversarial":
        eps = float(0.25 * np.sqrt(2.0 * d))
        X = adversarial(20_000, d, eps)
    else:
        eps = 2.0
        X, _ = make_embedding_data(20_000, d, seed=d)
    pts, n, block = _stage(X, 2048, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    k = d // 4
    slab, band = ck.sketch_stage(xs, mask, k)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, "high", budget=1 << 22, sketch=k,
        slab=(slab, band))
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], d, "high")
    rp = row_offsets(rows, xs.shape[1] // tile)
    centers = ck.pass_frames(xs, mask, tile, "high", k)[0]
    mi = mask.to(torch.int32)
    e2 = eps2_f32(eps)
    a = (xs, mi, rp, cols, slab, k, e2, band, tile)
    want, wstats = ck.PLAIN["count_pairs_sketch"](*a)
    emu, erc, frag = certified_rescore_walk(*a, centers)
    tol = min(frag, rescored_tolerance(erc))
    assert torch.equal(emu, want)
    assert torch.equal(want, ck.count_pairs(xs, mi, rp, cols, e2, tile))
    for mode in ("high", "mixed"):
        rc = torch.zeros(1, dtype=torch.int64, device="cuda")
        got, stats = ck.count_pairs_sketch(*a, mode, centers,
                                           rescored_pairs=rc)
        assert torch.equal(stats, wstats), (stats, wstats)
        assert int((got != want).sum()) == 0
        assert int(stats[0]) > 0
        assert abs(int(rc[0]) - erc) <= tol, (int(rc[0]), erc, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "mixed"])
def test_card_sketched_512d_fit_equals_unsketched_fit(precision):
    """A sketched 512-D fit, whose counts pass runs the certified
    rescore, byte-identical to the unsketched fit."""
    _need_card()
    X, _truth = make_embedding_data(6000, 512, seed=7)
    kw = dict(eps=2.0, min_samples=10, block=512, precision=precision)
    ck.reset_launch_counts()
    on = DBSCAN(sketch="auto", **kw).fit(X)
    key = "count_pairs_sketch" + ("" if precision == "high" else "_mixed")
    assert ck.LAUNCHES[key] == 1
    off = DBSCAN(sketch=0, **kw).fit(X)
    assert on.metrics_["sketch_k"] == 128 and on.metrics_["band_pairs"] > 0
    assert np.array_equal(on.labels_, off.labels_)
    assert np.array_equal(on.core_sample_mask_, off.core_sample_mask_)
    assert on.labels_.max() >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "mixed"])
def test_card_sketched_fit_past_16384_axes_equals_unsketched_fit(precision):
    """Past 16,384 axes (the certified band has no limit on d) a
    sketched fit runs B3's certified rescore and stays byte-identical
    to the unsketched fit."""
    _need_card()
    d = 16400
    X, _truth = make_embedding_data(1500, d, seed=11)
    # The full-rank noise adds 2 d 0.02^2 to every squared distance:
    # eps^2 keeps the 512-D fits' margin of 3.59 above it.
    eps = float(np.sqrt(2 * d * 0.02**2 + 3.59))
    kw = dict(eps=eps, min_samples=10, block=512, precision=precision)
    ck.reset_launch_counts()
    on = DBSCAN(sketch="auto", **kw).fit(X)
    key = "count_pairs_sketch" + ("" if precision == "high" else "_mixed")
    assert ck.LAUNCHES[key] == 1
    off = DBSCAN(sketch=0, **kw).fit(X)
    assert on.metrics_["sketch_k"] > 0 and on.metrics_["band_pairs"] > 0
    assert np.array_equal(on.labels_, off.labels_)
    assert np.array_equal(on.core_sample_mask_, off.core_sample_mask_)
    assert on.labels_.max() >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(6))
def test_mma_accumulation_within_the_bands_term_3_on_card(case):
    """The tensor cores' FP32 accumulation, chained over K = 512 as B3's
    certified rescore chains it, on adversarial bf16 inputs
    (``chip_smoke.mma_probe_cases``): ``|dot - P'| <= 2^-21 K sum |p|``
    (the header's term (3); sum |p| <= |X'| |Y'|) against the float64
    sum of the same products."""
    _need_card()
    from chip_smoke import mma_probe_cases

    name, a, b = mma_probe_cases()[case]
    K = a.shape[2]
    got = ck.mma_dot_probe(
        torch.from_numpy(a).cuda().to(torch.bfloat16),
        torch.from_numpy(b).cuda().to(torch.bfloat16)).cpu().double()
    a64, b64 = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    exact = torch.bmm(a64, b64.transpose(1, 2))
    mag = torch.bmm(a64.abs(), b64.abs().transpose(1, 2))
    assert bool(torch.isfinite(got).all()), name
    assert bool(((got - exact).abs() <= 2.0**-21 * K * mag).all()), name


@pytest.mark.cuda
def test_card_sketched_fit_equals_unsketched_fit():
    _need_card()
    # Small enough for the plain versions on the CPU (tile 512, 6 tiles).
    X, _truth = make_embedding_data(3000, 256, seed=5)
    kw = dict(eps=2.0, min_samples=10, block=512)
    ck.reset_launch_counts()
    on = DBSCAN(sketch="auto", **kw).fit(X)
    assert ck.LAUNCHES["count_pairs_sketch"] == 1
    assert ck.LAUNCHES["count_pairs"] == ck.LAUNCHES["minlab_pairs"] == 0
    off = DBSCAN(sketch=0, **kw).fit(X)
    cpu = DBSCAN(sketch="auto", device="cpu", **kw).fit(X)
    for other in (off, cpu):
        assert np.array_equal(on.labels_, other.labels_)
        assert np.array_equal(on.core_sample_mask_, other.core_sample_mask_)
    assert on.metrics_["sketch_k"] == 64 and off.metrics_["sketch_k"] == 0
    assert on.metrics_["band_pairs"] == cpu.metrics_["band_pairs"] > 0
    assert on.metrics_["rescored_tiles"] == cpu.metrics_["rescored_tiles"]


# -- precision modes: the bf16 tensor-core kernels ---------------------------


def _fast_inputs(d, eps, seed, offset=0.0):
    """B1/B2 inputs of a fit on the card (natural blobs, shifted by
    ``offset`` before the fit centres them), their row frames and a
    first min-label pass's labels."""
    X, _ = make_blob_data(20_000, d, n_centers=8, std=0.4, seed=seed)
    pts, n, block = _stage(X + offset, 1024, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, "mixed")
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], d, "mixed")
    rp = row_offsets(rows, xs.shape[1] // tile)
    mi = mask.to(torch.int32)
    counts = ck.count_pairs(xs, mi, rp, cols, eps2_f32(eps), tile)
    core = (torch.where(mask, counts, 0) >= 10) & mask
    lab = torch.where(
        core, torch.arange(len(counts), device="cuda", dtype=torch.int32),
        INT_INF,
    ).contiguous()
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    return dict(xs=xs, mask=mask, mi=mi, lab=lab, rp=rp, cols=cols,
                e2=eps2_f32(eps), tile=tile, centers=centers, rnorm=rnorm)


@pytest.mark.cuda
@pytest.mark.parametrize("d,eps", [(3, 1.2), (16, 2.4), (64, 4.8),
                                   (96, 6.0)])
def test_mixed_kernels_equal_plain_and_fp32_on_card(d, eps):
    """B1/B2 under "mixed": counts and min labels bitwise equal to the
    plain version's and to the FP32 kernels' on valid rows; the band
    stats agree with the plain version's within 0.1% (kernel and plain
    version differ only in the tensor cores' order of the d2f sum, which
    moves pairs at the band's edge)."""
    _need_card()
    inp = _fast_inputs(d, eps, d)
    m = inp["mask"]
    a = (inp["xs"], inp["mi"], inp["rp"], inp["cols"], inp["e2"],
         inp["tile"], inp["centers"], inp["rnorm"])
    before = dict(ck.LAUNCHES)
    got, st = ck.count_pairs_mixed(*a)
    want, wst = ck.PLAIN["count_pairs_mixed"](*a)
    exact = ck.count_pairs(*a[:6])
    assert torch.equal(got[m], want[m]) and torch.equal(got[m], exact[m])
    assert int(st[0]) > 0 and int(st[1]) > 0
    assert (st - wst).abs().max() <= 1 + 1e-3 * wst.max()
    b = (inp["xs"], inp["lab"]) + a[2:]
    best = ck.minlab_pairs_mixed(*b)
    assert torch.equal(best[m], ck.PLAIN["minlab_pairs_mixed"](*b)[m])
    assert torch.equal(best[m], ck.minlab_pairs(*b[:6])[m])
    assert ck.LAUNCHES["count_pairs_mixed"] == before["count_pairs_mixed"] + 1
    assert ck.LAUNCHES["minlab_pairs_mixed"] == (
        before["minlab_pairs_mixed"] + 1)


def _eps2_bracket(e2, rel=2.0 ** -12):
    """float32 eps^2 values ``rel`` below and above ``e2``: kernel and
    plain version differ only in the order of the d2f sum, by far less
    than ``rel * eps^2`` at these shapes, and every verdict is monotone
    in eps^2, so the kernel lies between the plain version at the two."""
    return (float(np.float32(e2 * (1 - rel))),
            float(np.float32(e2 * (1 + rel))))


@pytest.mark.cuda
@pytest.mark.parametrize("d,eps", [(3, 1.2), (16, 2.4), (64, 4.8),
                                   (96, 6.0)])
def test_default_kernels_bracketed_by_plain_on_card(d, eps):
    """B1/B2 under "default": counts between the plain version's at
    eps^2 (1 -+ 2^-12), min labels likewise (reversed), on every row."""
    _need_card()
    inp = _fast_inputs(d, eps, d)
    lo, hi = _eps2_bracket(inp["e2"])
    rest = (inp["tile"], inp["centers"])
    a = (inp["xs"], inp["mi"], inp["rp"], inp["cols"])
    got = ck.count_pairs_default(*a, inp["e2"], *rest)
    plain = ck.PLAIN["count_pairs_default"]
    assert bool((plain(*a, lo, *rest) <= got).all())
    assert bool((got <= plain(*a, hi, *rest)).all())
    b = (inp["xs"], inp["lab"], inp["rp"], inp["cols"])
    best = ck.minlab_pairs_default(*b, inp["e2"], *rest)
    plain = ck.PLAIN["minlab_pairs_default"]
    assert bool((plain(*b, hi, *rest) <= best).all())
    assert bool((best <= plain(*b, lo, *rest)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(256, 64), (512, 128)])
def test_sketch_default_kernels_bracketed_by_plain_on_card(d, k):
    """B3/B4 under "default" (the bf16 rescore): stats equal to the plain
    version's (the gate is unchanged), counts and labels bracketed as in
    the unsketched test (the gated verdict is monotone in eps^2 too)."""
    _need_card()
    xs, mask, slab, band, rp, cols, tile = _sketch_inputs(d, k, d + k)
    centers, _rn = ck.tile_frames(xs, mask, tile)
    mi = mask.to(torch.int32)
    e2 = eps2_f32(2.0)
    lo, hi = _eps2_bracket(e2)
    a = (xs, mi, rp, cols, slab, k)
    got, st = ck.count_pairs_sketch(*a, e2, band, tile, "default", centers)
    plain = ck.PLAIN["count_pairs_sketch"]
    want, wst = plain(*a, e2, band, tile, centers)
    assert torch.equal(st, wst) and int(st[0]) > 0
    assert bool((plain(*a, lo, band, tile, centers)[0] <= got).all())
    assert bool((got <= plain(*a, hi, band, tile, centers)[0]).all())
    core = (torch.where(mask, got, 0) >= 10) & mask
    lab = torch.where(
        core, torch.arange(len(got), device="cuda", dtype=torch.int32),
        INT_INF,
    ).contiguous()
    b = (xs, lab, rp, cols, slab, k)
    best = ck.minlab_pairs_sketch(*b, e2, band, tile, "default", centers)
    plain = ck.PLAIN["minlab_pairs_sketch"]
    assert bool((plain(*b, hi, band, tile, centers) <= best).all())
    assert bool((best <= plain(*b, lo, band, tile, centers)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 96])
def test_query_mixed_equals_exact_after_the_verdict_on_card(d):
    """B5 under "mixed": after the within-eps verdict, labels and d^2
    bits equal the exact kernel's and the plain mixed version's on every
    real row (pad rows, which the engine drops, meet pad slots at d^2 =
    0 in a chunk that runs and +inf in one that is skipped)."""
    _need_card()
    q, tl, coords, labels = _query_inputs(d, 16, 128, 4, 512, d, False)
    e2 = eps2_f32(1.0 + 0.3 * d ** 0.5)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    tables = ck.query_tables(coords, labels, block=64, nb=8)
    got = ck.query_leaf(q, tl, coords, labels, block=64, nb=8,
                        precision="mixed", eps2=e2, keep_stats=stats,
                        tables=tables)
    exact = ck.query_leaf(q, tl, coords, labels, block=64, nb=8,
                          tables=tables)
    plain = query_min_core_plain(q, tl, coords, labels, block=64, nb=8,
                                 precision="mixed", eps2=e2)

    def verdict(p):
        d2 = p[1].view(torch.float32)
        ok = d2 <= e2
        return torch.where(ok, p[0], -1), torch.where(ok, d2, float("inf"))

    real = slice(0, q.shape[2] - 3)
    for other in (exact, plain):
        gl, gd = verdict(got)
        ol, od = verdict(other)
        assert torch.equal(gl[:, real], ol[:, real])
        assert torch.equal(gd[:, real].view(torch.int32),
                           od[:, real].view(torch.int32))
    assert 0 < int(stats[0]) <= int(stats[1])
    assert int((verdict(got)[0] >= 0).sum()) > 0


@pytest.mark.cuda
def test_card_mixed_fit_equals_high_fit():
    _need_card()
    X, _ = make_blob_data(8000, 16, n_centers=8, std=0.4, seed=3)
    ck.reset_launch_counts()
    mixed = DBSCAN(eps=2.4, min_samples=10, block=256, precision="mixed").fit(X)
    assert ck.LAUNCHES["count_pairs_mixed"] == 1
    assert ck.LAUNCHES["minlab_pairs_mixed"] >= 1
    assert ck.LAUNCHES["count_pairs"] == ck.LAUNCHES["minlab_pairs"] == 0
    high = DBSCAN(eps=2.4, min_samples=10, block=256).fit(X)
    cpu = DBSCAN(eps=2.4, min_samples=10, block=256, precision="mixed",
                 device="cpu").fit(X)
    for other in (high, cpu):
        assert np.array_equal(mixed.labels_, other.labels_)
        assert np.array_equal(mixed.core_sample_mask_,
                              other.core_sample_mask_)
    assert mixed.metrics_["band_pairs"] > 0
    assert mixed.query_engine().precision == "mixed"


# -- B1 on the tensor cores (d <= 64, every mode) ---------------------------


def _adversarial_b1_inputs(d):
    """B1's inputs on the adversarial geometry (chip_smoke.adversarial:
    near-eps pairs, duplicates, a 1e3 offset; 20,000 points, seed 3) on
    the card, with the row tiles' frames."""
    from chip_smoke import adversarial

    eps = round(0.9 * np.sqrt(d / 8.0), 3)
    pts, n, block = _stage(adversarial(20_000, d, eps), 1024,
                           torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, "high")
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], d, "high")
    rp = row_offsets(rows, xs.shape[1] // tile)
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    a = (xs, mask.to(torch.int32), rp, cols, eps2_f32(eps), tile)
    return a, mask, centers, rnorm


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 64])
def test_b1_tensor_cores_bitwise_in_every_mode_on_card(d):
    """The tensor-core B1 on adversarial blobs: "high" and "mixed"
    counts bitwise the plain B1's on every row (and each other's),
    "mixed" stats within 1e-3 of the plain "mixed" version's, "default"
    between the plain "default" version at eps^2 (1 -+ 2^-12); each
    launch counted once."""
    _need_card()
    a, mask, centers, rnorm = _adversarial_b1_inputs(d)
    want = counts_over_pairs(*a)
    before = dict(ck.LAUNCHES)
    high = ck.count_pairs(*a, centers)
    mixed, st = ck.count_pairs_mixed(*a, centers, rnorm)
    dflt = ck.count_pairs_default(*a, centers)
    assert torch.equal(high, want) and torch.equal(mixed, want)
    _pm, wst = ck.PLAIN["count_pairs_mixed"](*a, centers, rnorm)
    assert int(st[0]) > 0
    assert (st - wst).abs().max() <= 1 + 1e-3 * wst.max()
    lo, hi = _eps2_bracket(a[4])
    plain = ck.PLAIN["count_pairs_default"]
    assert bool((plain(*a[:4], lo, a[5], centers) <= dflt).all())
    assert bool((dflt <= plain(*a[:4], hi, a[5], centers)).all())
    for key in ("count_pairs", "count_pairs_mixed", "count_pairs_default"):
        assert ck.LAUNCHES[key] == before[key] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 16, 64])
def test_b1_rescored_pairs_within_tolerance_of_the_walk_on_card(d):
    """The tensor-core B1's ``rescored_pairs`` (the pairs its exact
    fallback decided), the same under "high" and "mixed", is off
    ``certified_count_walk``'s by no more than the walk's fragile pairs
    nor than ``chip_smoke.rescored_tolerance`` (0.1 %)."""
    from chip_smoke import rescored_tolerance
    from pypardis_tpu_torch.ops.distances import certified_count_walk

    _need_card()
    a, _mask, centers, rnorm = _adversarial_b1_inputs(d)
    rc = torch.zeros(1, dtype=torch.int64, device="cuda")
    ck.count_pairs(*a, centers, rescored_pairs=rc)
    rcm = torch.zeros(1, dtype=torch.int64, device="cuda")
    ck.count_pairs_mixed(*a, centers, rnorm, rescored_pairs=rcm)
    _c, want, frag = certified_count_walk(*a, centers)
    assert want > 0 and int(rc[0]) == int(rcm[0])
    assert abs(int(rc[0]) - want) <= min(frag, rescored_tolerance(want))


@pytest.mark.cuda
def test_card_200k_fits_byte_identical_across_high_and_mixed():
    """A 200,000 x 16-D fit (the main path's geometry) under "high" and
    under "mixed": byte-identical labels and core masks, each through
    its own B1 launch."""
    _need_card()
    X, _ = make_blob_data(200_000, 16, n_centers=32, std=0.4)
    fits = {}
    for mode in ("high", "mixed"):
        ck.reset_launch_counts()
        fits[mode] = DBSCAN(eps=2.4, min_samples=10, block=2048,
                            precision=mode).fit(X)
        key = "count_pairs" if mode == "high" else "count_pairs_mixed"
        assert ck.LAUNCHES[key] == 1
    assert np.array_equal(fits["high"].labels_, fits["mixed"].labels_)
    assert np.array_equal(fits["high"].core_sample_mask_,
                          fits["mixed"].core_sample_mask_)


def _b2_rounds(d, eps, mode):
    """A 20,000-point fit's B2 inputs under ``mode`` on the card and its
    round loop's (labels, live rows) per round, to convergence."""
    X, _ = make_blob_data(20_000, d, n_centers=8, std=0.4, seed=d)
    pts, n, block = _stage(X, 1024, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, mode)
    assert total <= budget
    N = xs.shape[1]
    tile = ck._pallas_block(block, N, d, mode)
    rp = row_offsets(rows, N // tile)
    e2 = eps2_f32(eps)
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    frames = {"high": (), "mixed": (centers, rnorm),
              "default": (centers,)}[mode]
    mi = mask.to(torch.int32)
    counts = (ck.count_pairs_default(xs, mi, rp, cols, e2, tile, centers)
              if mode == "default" else ck.count_pairs(xs, mi, rp, cols, e2,
                                                       tile))
    core = (torch.where(mask, counts, 0) >= 10) & mask
    name = "minlab_pairs" if mode == "high" else f"minlab_pairs_{mode}"
    f = torch.where(core, torch.arange(N, device="cuda", dtype=torch.int32),
                    INT_INF)
    live = mask
    out = []
    while True:
        a = (xs, f.contiguous(), rp, cols, e2, tile) + frames
        out.append((a, live))
        g = ck.PLAIN[name](*a)
        live = mask & (g != INT_INF)
        f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f), core)
        if torch.equal(f_new, f):
            return name, frames, out
        f = f_new


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["high", "mixed", "default"])
@pytest.mark.parametrize("d,eps", [(3, 1.2), (16, 2.4), (64, 4.8),
                                   (96, 6.0)])
def test_b2_skip_bitwise_and_counts_as_the_walk_on_card(d, eps, mode):
    """B2's label-bound skip at each round's labels of a fit, with the
    fit's live rows and without them: the
    labels bitwise the plain version's and minlab_pairs_walk's and the
    evaluated (block, chunk) pairs equal to the walk's ("default": the
    bf16 sums may differ in order, so its labels lie between the plain
    version's at eps^2 (1 -+ 2^-12), and its count is held where they
    are bitwise)."""
    _need_card()
    name, frames, rounds = _b2_rounds(d, eps, mode)
    kern = getattr(ck, name)
    plain = ck.PLAIN[name]
    pad = [None] * (2 - len(frames))
    for a, live in rounds:
        for lr in (None, live):
            ev = torch.zeros(1, dtype=torch.int64, device="cuda")
            got = kern(*a, live_rows=lr, evaluated=ev)
            want = plain(*a, live_rows=lr)
            walked, n_ev = minlab_pairs_walk(
                *a[:6], mode, *frames, *pad, live_rows=lr)
            assert torch.equal(walked, want)
            if mode == "default" and not torch.equal(got, want):
                lo, hi = _eps2_bracket(a[4])
                rest = a[5:]
                assert bool((plain(*a[:4], hi, *rest, live_rows=lr)
                             <= got).all())
                assert bool((got <= plain(*a[:4], lo, *rest,
                                          live_rows=lr)).all())
                continue
            assert torch.equal(got, want), (d, mode)
            assert int(ev[0]) == n_ev, (d, mode)
    assert n_ev > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [58_200, 70_000])
def test_card_high_fit_past_58108_axes(d):
    """Past 58,108 axes one staged column would not fit 227 KB of
    shared memory: B1/B2 under "high" stage their chunks in axis slices
    (as they do past 64 axes) and stay bitwise their plain versions, and the unsketched fit equals
    the sketched one."""
    _need_card()
    X, _truth = make_embedding_data(1500, d, seed=11)
    # As in the 16,400-D test: eps^2 keeps the 512-D fits' margin of
    # 3.59 above the noise's 2 d 0.02^2.
    eps = float(np.sqrt(2 * d * 0.02**2 + 3.59))
    pts, n, block = _stage(X, 512, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, "high")
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], d, "high")
    rp = row_offsets(rows, xs.shape[1] // tile)
    mi = mask.to(torch.int32)
    e2 = eps2_f32(eps)
    got = ck.count_pairs(xs, mi, rp, cols, e2, tile)
    assert torch.equal(got, counts_over_pairs(xs, mi, rp, cols, e2, tile))
    core = (torch.where(mask, got, 0) >= 10) & mask
    lab = torch.where(
        core, torch.arange(len(got), device="cuda", dtype=torch.int32),
        INT_INF).contiguous()
    ev = torch.zeros(1, dtype=torch.int64, device="cuda")
    best = ck.minlab_pairs(xs, lab, rp, cols, e2, tile, live_rows=mask,
                           evaluated=ev)
    want, n_ev = minlab_pairs_walk(xs, lab, rp, cols, e2, tile,
                                   live_rows=mask)
    assert torch.equal(best, want)
    assert torch.equal(best, minlab_over_pairs(xs, lab, rp, cols, e2, tile,
                                               live_rows=mask))
    assert int(ev[0]) == n_ev > 0
    kw = dict(eps=eps, min_samples=10, block=512, precision="high")
    ck.reset_launch_counts()
    off = DBSCAN(sketch=0, **kw).fit(X)
    assert ck.LAUNCHES["count_pairs"] == 1 and ck.LAUNCHES["minlab_pairs"]
    on = DBSCAN(sketch="auto", **kw).fit(X)
    assert on.metrics_["sketch_k"] > 0
    assert np.array_equal(on.labels_, off.labels_)
    assert np.array_equal(on.core_sample_mask_, off.core_sample_mask_)
    assert off.labels_.max() >= 1


# -- the metrics and the sweep (the slice's new shapes) -------------------


def _frame_inputs(rows, eps, k=0):
    """Staged B1/B2 (or B3/B4) inputs of kernel-frame ``rows`` at
    ``eps`` on the card, and the round-1 labels."""
    dev = torch.device("cuda")
    pts, n, block = _stage(rows, 1024, dev)
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    slab = ck.sketch_stage(xs, mask, k, "high") if k else None
    (r, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, "high", sketch=k, slab=slab, budget=1 << 26)
    assert total <= budget
    tile = ck._pallas_block(block, xs.shape[1], xs.shape[0], "high")
    rp = row_offsets(r, xs.shape[1] // tile)
    return xs, mask, rp, cols, tile, slab


@pytest.mark.cuda
def test_b1_b2_bitwise_at_d3_on_the_unit_sphere():
    """Haversine's frame: GeoLife-shaped stay points on the unit sphere
    at the chord of 50 m, where eps is ~8e-6."""
    _need_card()
    from chip_smoke import HAV_EPS, geolife_like
    from pypardis_tpu_torch.geometry import latlon_to_unit_sphere

    X, _t = geolife_like(40_000)
    chord = float(2.0 * np.sin(HAV_EPS / 2.0))
    xs, mask, rp, cols, tile, _s = _frame_inputs(latlon_to_unit_sphere(X),
                                                 chord)
    mi, e2 = mask.to(torch.int32), eps2_f32(chord)
    got = ck.count_pairs(xs, mi, rp, cols, e2, tile)
    assert torch.equal(got, counts_over_pairs(xs, mi, rp, cols, e2, tile))
    core = (torch.where(mask, got, 0) >= 10) & mask
    lab = torch.where(core, torch.arange(len(got), device="cuda",
                                         dtype=torch.int32), INT_INF)
    lab = lab.contiguous()
    assert torch.equal(ck.minlab_pairs(xs, lab, rp, cols, e2, tile),
                       minlab_over_pairs(xs, lab, rp, cols, e2, tile))
    assert int(core.sum()) > 0


@pytest.mark.cuda
def test_b3_b4_bitwise_on_unit_norm_rows():
    _need_card()
    from chip_smoke import COS_EPS
    from pypardis_tpu_torch.dbscan import _unit_rows

    X, _t = make_embedding_data(6000, 512)
    eps = float(np.sqrt(2.0 * COS_EPS))
    xs, mask, rp, cols, tile, slab = _frame_inputs(_unit_rows(X), eps,
                                                   k=128)
    centers = ck.pass_frames(xs, mask, tile, "high", 128)[0]
    a = (xs, mask.to(torch.int32), rp, cols, slab[0], 128, eps2_f32(eps),
         slab[1], tile)
    counts, st = ck.count_pairs_sketch(*a, "high", centers)
    pc, pst = ck.PLAIN["count_pairs_sketch"](*a)
    assert torch.equal(counts, pc) and torch.equal(st.cpu(), pst.cpu())
    core = (torch.where(mask, counts, 0) >= 10) & mask
    lab = torch.where(core, torch.arange(len(counts), device="cuda",
                                         dtype=torch.int32), INT_INF)
    b = (xs, lab.contiguous()) + a[2:]
    assert torch.equal(ck.minlab_pairs_sketch(*b),
                       ck.PLAIN["minlab_pairs_sketch"](*b))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["haversine", "cosine"])
def test_driver_metric_fit_and_predict_on_card_equal_the_cpu(metric):
    """A cosine or haversine fit on the card equals the CPU fit byte for
    byte, and its predict (B5 at d = 3 or 512 in the model's frame)
    equals the CPU engine's in labels and distances."""
    _need_card()
    from chip_smoke import COS_EPS, HAV_EPS, geolife_like

    if metric == "haversine":
        X, _t = geolife_like(30_000)
        eps, jitter = HAV_EPS, HAV_EPS / 2
    else:
        X, _t = make_embedding_data(3000, 512)
        eps, jitter = COS_EPS, 0.05
    kw = dict(eps=eps, min_samples=10, metric=metric, block=1024)
    gpu = DBSCAN(**kw).fit(X)
    cpu = DBSCAN(device="cpu", **kw).fit(X)
    assert np.array_equal(gpu.labels_, cpu.labels_)
    assert np.array_equal(gpu.core_sample_mask_, cpu.core_sample_mask_)
    rng = np.random.default_rng(3)
    Q = X[::8] + rng.normal(scale=jitter, size=X[::8].shape)
    before = ck.LAUNCHES["query_leaf"]
    got = gpu.predict(Q)
    assert ck.LAUNCHES["query_leaf"] > before
    want = cpu.predict(Q)
    assert np.array_equal(got, want) and (got >= 0).any()
    ge, ce = gpu.query_engine(), cpu.query_engine()
    assert np.array_equal(ge.predict(Q, return_distance=True)[1],
                          ce.predict(Q, return_distance=True)[1])


@pytest.mark.cuda
def test_l1_pass_on_card_equals_the_cpu():
    """The cityblock pass is the same torch ops on either device: its
    counts and minima on the card equal the CPU's, and a cityblock fit
    on the card runs it (counted in L1_PASSES) and equals the CPU fit."""
    _need_card()
    from pypardis_tpu_torch.ops.distances import eps_threshold

    X, _t = make_blob_data(20_000, 16, n_centers=8, std=0.4, seed=16)
    dev = torch.device("cuda")
    pts, n, block = _stage(X, 1024, dev)
    xs, mask, _owner = _pipeline_layout(pts, 6.0, n, block, sort=True)
    (r, cols), (total, budget) = ck.kernel_pair_list(
        xs, 6.0, mask, block, "high", metric="cityblock", budget=1 << 26)
    tile = ck._pallas_block(block, xs.shape[1], 16, "high")
    rp = row_offsets(r, xs.shape[1] // tile)
    thr = eps_threshold(6.0, "cityblock")
    a = (xs, mask.to(torch.int32), rp, cols, thr, tile)
    got = ck.count_pairs_l1(*a)
    cpu = tuple(t.cpu() if torch.is_tensor(t) else t for t in a)
    assert torch.equal(got.cpu(), ck.count_pairs_l1(*cpu))
    lab = torch.where(mask, torch.arange(len(got), device=dev,
                                         dtype=torch.int32), INT_INF)
    assert torch.equal(
        ck.minlab_pairs_l1(xs, lab, rp, cols, thr, tile).cpu(),
        ck.minlab_pairs_l1(*((cpu[0], lab.cpu()) + cpu[2:])))
    ck.reset_launch_counts()
    g = DBSCAN(eps=6.0, min_samples=10, metric="cityblock").fit(X)
    assert sum(ck.L1_PASSES.values()) == g.metrics_["kernel_passes"]
    assert sum(ck.LAUNCHES.values()) == 0
    c = DBSCAN(eps=6.0, min_samples=10, metric="cityblock",
               device="cpu").fit(X)
    assert np.array_equal(g.labels_, c.labels_)


@pytest.mark.cuda
def test_sweep_on_card_equals_its_fits():
    """A 16-config sweep from a CUDA tensor: one distance pass, each
    config byte-identical to a fit at it on the card."""
    _need_card()
    X, _t = make_blob_data(50_000, 16, n_centers=8, std=0.4, seed=5)
    Xd = torch.from_numpy(X).cuda()
    eps_list = [0.15 * (i + 1) for i in range(8)]
    res = DBSCAN(eps=1.2, min_samples=5, block=2048).sweep(Xd, eps_list,
                                                           [5, 10])
    assert res.stats["distance_passes"] == 1 and len(res) == 16
    for eps, ms in res.configs:
        fit = DBSCAN(eps=eps, min_samples=ms, block=2048).fit(Xd)
        assert np.array_equal(res.labels(eps, ms), fit.labels_)
        assert np.array_equal(res.core(eps, ms), fit.core_sample_mask_)


@pytest.mark.cuda
@pytest.mark.parametrize("ms", [1, 2, 10])
def test_hierarchy_stages_on_card_equal_the_cpu(ms):
    """The hierarchy's device stages on the card (the prepare's lexsort,
    the one-shot core twin and the prepared slab's core pass, the
    Borůvka MST, the cuts' labels) bitwise the same stages on the CPU
    over the same slab."""
    _need_card()
    from pypardis_tpu_torch.ops import hierarchy as H
    from pypardis_tpu_torch.ops.distances import neighbor_pair_graph

    X, _ = make_blob_data(30_000, 16, n_centers=8, std=0.4, seed=5)
    pts, n, block = _stage(X, 1024, torch.device("cuda"))
    xs, mask, _owner = _pipeline_layout(pts, 1.8, n, block, sort=True)
    gi, gj, dv, st = neighbor_pair_graph(xs, mask, 1.8, tile=1024)
    slab = {"cuda": (gi, gj, dv, mask)}
    slab["cpu"] = tuple(t.cpu() for t in slab["cuda"])
    out = {}
    for dev, (g_i, g_j, d_v, msk) in slab.items():
        state = H.hierarchy_prepare(g_i, g_j, d_v)
        cd2 = H.core_distances(state, msk, ms)
        twin = H.core_distances_device(g_i, g_j, d_v, msk, ms)
        assert torch.equal(cd2.view(torch.int32), twin.view(torch.int32))
        mst = H.mutual_reachability_mst(state, cd2, len(msk))
        h = H.build_hierarchy(state, msk, len(msk), ms,
                              thr_max=float(np.float32(1.8) ** 2))
        assert torch.equal(h.cd2.view(torch.int32), cd2.view(torch.int32))
        cuts = [h.labels_at_thr(float(np.float32(e) ** 2))
                for e in (0.9, 1.3, 1.8)]
        out[dev] = (state, cd2, mst, h, cuts)
    (sg, cg, mg, hg, kg), (sc, cc, mc, hc, kc) = out["cuda"], out["cpu"]
    for a, b in zip(sg, sc):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(cg.cpu().view(torch.int32), cc.view(torch.int32))
    for a, b in zip(mg[:3], mc[:3]):
        assert torch.equal(a.cpu(), b)
    assert mg[3] == mc[3] and mg[3]["boruvka_rounds"] <= mg[3]["round_cap"]
    assert hg.select_cut() == hc.select_cut()
    assert hg.eps_ladder(8) == hc.eps_ladder(8)
    for (lg, pg), (lc, pc) in zip(kg, kc):
        assert torch.equal(lg.cpu(), lc) and torch.equal(pg.cpu(), pc)


@pytest.mark.cuda
def test_eps_none_fit_on_card_equals_the_cpu_and_its_fit():
    _need_card()
    X, _ = make_blob_data(20_000, 16, n_centers=32, std=0.4, seed=2)
    card = DBSCAN(eps=None, min_samples=10, block=256).fit(X)
    cpu = DBSCAN(eps=None, min_samples=10, block=256, device="cpu").fit(X)
    assert card.eps_ == cpu.eps_
    assert np.array_equal(card.labels_, cpu.labels_)
    assert np.array_equal(card.core_sample_mask_, cpu.core_sample_mask_)
    ref = DBSCAN(eps=card.eps_, min_samples=10, block=256).fit(
        torch.from_numpy(X).cuda())
    assert np.array_equal(card.labels_, ref.labels_)
    assert np.array_equal(card.core_sample_mask_, ref.core_sample_mask_)


@pytest.mark.cuda
def test_eps_none_at_default_precision_is_the_exact_clustering(monkeypatch):
    """The hierarchy's graph holds exact d^2 in every precision mode, so
    an eps=None fit at ``precision="default"`` gives the ``"high"``
    clustering: the same ``eps_``, labels and core mask as eps=None at
    ``"high"`` and as ``fit(eps_)`` at ``"high"`` (not as ``fit(eps_)``
    at ``"default"``, whose bf16 verdicts may differ near eps).  Twin
    blobs, so the cut lies inside the ceiling."""
    _need_card()
    from chip_smoke import twin_blobs

    X, _ = twin_blobs(6000)
    Xd = torch.from_numpy(X).cuda()
    monkeypatch.setenv("PPTORCH_HIER_EPS_MAX", "1.1")
    fits = [DBSCAN(eps=None, min_samples=10, min_cluster_size=50,
                   block=128, precision=p).fit(Xd)
            for p in ("default", "high")]
    ref = DBSCAN(eps=fits[0].eps_, min_samples=10, block=128).fit(Xd)
    assert fits[0].eps_ == fits[1].eps_ < 1.1
    for m in (fits[1], ref):
        assert np.array_equal(fits[0].labels_, m.labels_)
        assert np.array_equal(fits[0].core_sample_mask_, m.core_sample_mask_)


def _hold_index(idx):
    """The index's device tensors equal its host mirrors, and B5's
    tables equal a fresh ``query_tables`` and their plain versions on
    the card and on the CPU (from the host mirrors), bitwise."""
    dev = idx.device_tensors()
    for t, a in zip(dev, (idx.coords, idx.labels, idx.blo, idx.bhi)):
        assert torch.equal(t.cpu(), torch.from_numpy(a))
    got = idx.kernel_tables()
    fresh = ck.query_tables(dev[0], dev[1], block=idx.block, nb=idx.nb)

    def plain(coords, labels):
        return (query_pad_keys(coords, labels, idx.leaf_cap),
                query_leaf_ends(coords, labels, idx.leaf_cap),
                *query_block_frames(coords, labels, idx.block))
    host = plain(torch.from_numpy(idx.coords), torch.from_numpy(idx.labels))
    for g, f, w, h in zip(got, fresh, plain(dev[0], dev[1]), host):
        assert torch.equal(g.view(torch.int32), f.view(torch.int32))
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), h.view(torch.int32))


def _live_writes(live, centers, rng, dim):
    """Inserts (interior, a new clump, noise, a pour past a leaf's
    pads), core deletes and a compaction; yields after each."""
    live.insert(centers[0] + rng.normal(scale=0.3, size=(4, dim)))
    yield "interior"
    live.insert(np.full(dim, 24.0) + rng.normal(scale=0.2, size=(8, dim)))
    yield "clump"
    live.insert(rng.uniform(-30, 30, size=(3, dim)))
    yield "noise"
    live.insert_batch(centers[1] + rng.normal(scale=0.3, size=(300, dim)))
    yield "pour"
    live.delete_batch(live.ids()[live.core_mask()][:12])
    yield "delete cores"
    from pypardis_tpu_torch.serve import Compactor

    Compactor(live).compact()
    yield "compaction"
    live.insert_batch(centers[2] + rng.normal(scale=0.3, size=(20, dim)))
    yield "after the swap"


@pytest.mark.cuda
def test_live_sequence_keeps_b5_tables_fresh_on_card():
    """Every commit rebuilds B5's tables over the new slab (a filled
    tail pad moves a leaf's end; a delete leaves an interior pad; an
    overflow appends a slab; a compaction swaps the generation), and
    ``predict`` stays bitwise ``oracle_predict``."""
    _need_card()
    X, _t, centers = make_separated_blob_data(
        800, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=0)
    live = DBSCAN(eps=1.1, min_samples=6, block=128).fit(X).live(
        leaves=8, block=32, qblock=32)
    idx = live.index
    commit = idx.commit_update
    held = []

    def checked():
        before = ck.LAUNCHES["query_tables"]
        out = commit()
        assert ck.LAUNCHES["query_tables"] == before + 1
        _hold_index(idx)
        held.append(idx.epoch)
        return out

    idx.commit_update = checked
    rng = np.random.default_rng(3)
    Q0 = np.concatenate([X[:200], rng.uniform(-25, 25, size=(80, 3))])
    cols0 = idx.coords.shape[1]
    for what in _live_writes(live, centers, rng, 3):
        _hold_index(idx)
        Q = np.concatenate([Q0, live.points()[-40:]])
        olabs, od2 = idx.oracle_predict(Q)
        assert np.array_equal(live.predict(Q), olabs), what
        t = live.engine.submit(Q)
        live.engine.drain()
        assert np.array_equal(t.d2.view(np.int32), od2.view(np.int32)), what
        if what == "pour":
            assert idx.coords.shape[1] > cols0
    # One rebuild per commit; the swap adopts the new generation's.
    assert len(held) == idx.epoch - 1 >= 5 and idx.generation == 1


@pytest.mark.cuda
def test_live_on_card_equals_live_on_the_cpu():
    """The same writes on a card model and a CPU model: labels, core
    flags, the index's host arrays and the counters byte-identical, and
    ``predict`` bitwise."""
    _need_card()
    X, _t, centers = make_separated_blob_data(
        800, 3, n_centers=5, std=0.35, min_sep=6.3, spread=10.0, seed=1)
    lives = [DBSCAN(eps=1.1, min_samples=6, block=128, device=d).fit(
        X).live(leaves=8, block=32, qblock=32, warm=False)
        for d in ("cuda", "cpu")]
    gens = [_live_writes(lv, centers, np.random.default_rng(4), 3)
            for lv in lives]
    for steps in zip(*gens):
        g, c = lives
        assert np.array_equal(g.labels(), c.labels()), steps
        assert np.array_equal(g.core_mask(), c.core_mask())
        for f in ("coords", "labels", "blo", "bhi", "gids"):
            assert np.array_equal(getattr(g.index, f), getattr(c.index, f))
        assert g.index.leaf_slabs == c.index.leaf_slabs
        assert g._counters == c._counters
        Q = np.concatenate([X[:100], g.points()[-50:]])
        a, b = (lv.predict(Q, return_distance=True) for lv in lives)
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1].view(np.int32), b[1].view(np.int32))


@pytest.mark.cuda
def test_incremental_primitives_on_card_equal_the_cpu():
    """float64 counts and the border attach: card = CPU, counts and
    labels exactly, d^2 bitwise (no fused multiply-add on either)."""
    _need_card()
    from pypardis_tpu_torch.ops import incremental as inc

    rng = np.random.default_rng(5)
    q = rng.normal(size=(3000, 16)) * 0.4 + rng.uniform(-10, 10, 16)
    c = np.concatenate([q[:2000] + rng.normal(scale=0.3, size=(2000, 16)),
                        rng.normal(size=(3000, 16)) * 3.0])
    lab = rng.integers(0, 9, len(c))
    for eps in (1.0, 2.4):
        a = inc.count_within_eps(torch.from_numpy(q).cuda(),
                                 torch.from_numpy(c).cuda(), eps)
        assert torch.equal(a.cpu(), inc.count_within_eps(q, c, eps))
        gl, gd = inc.attach_to_cores(torch.from_numpy(q).cuda(),
                                     torch.from_numpy(c).cuda(), lab, eps)
        cl, cd = inc.attach_to_cores(q, c, lab, eps)
        assert torch.equal(gl.cpu(), cl)
        assert torch.equal(gd.cpu().view(torch.int64), cd.view(torch.int64))
    d2g = inc.sq_dists_f64(torch.from_numpy(q[:500]).cuda(),
                           torch.from_numpy(c[:700]).cuda())
    d2c = inc.sq_dists_f64(torch.from_numpy(q[:500]), torch.from_numpy(c[:700]))
    assert torch.equal(d2g.cpu().view(torch.int64), d2c.view(torch.int64))


@pytest.mark.cuda
def test_gateway_eviction_gives_memory_back_and_readmits_bitwise(tmp_path):
    """Evict a model on the card (its spill written, its device tensors
    released: ``memory_allocated`` falls by at least its index's device
    bytes) and readmit it: onto the card, its slabs and B5 tables bitwise
    what they were, its answers (labels and d^2) bitwise as before."""
    _need_card()
    import gc

    from pypardis_tpu_torch.serve import ModelGateway

    fits = {}
    for i, name in enumerate(("a", "b")):
        X, _t, _c = make_separated_blob_data(
            3000, 8, n_centers=6, std=0.35, min_sep=6.0, spread=10.0,
            seed=40 + i)
        fits[name] = (DBSCAN(eps=1.1, min_samples=6, block=256).fit(X), X)
    gw = ModelGateway(spill_dir=str(tmp_path))
    for name, (m, _X) in fits.items():
        gw.register(name, m)

    def served(name, Q):
        t = gw.submit(name, Q)
        gw.drain(name)
        return t.labels, t.d2

    Q = fits["a"][1][:512] + 0.01
    before = served("a", Q)
    served("b", fits["b"][1][:64])
    idx = gw._handles["a"].index
    snap = [t.clone() for t in idx._dev + idx._tables]
    nbytes = idx.index_device_bytes
    del idx
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    gw.budget_bytes = gw.resident_bytes() - 1
    gw._ensure_budget(keep="b")
    gc.collect()
    torch.cuda.synchronize()
    assert not gw.gateway_report()["models"]["a"]["resident"]
    assert mem0 - torch.cuda.memory_allocated() >= nbytes > 0
    after = served("a", Q)
    back = gw._handles["a"].index
    assert back.device.type == "cuda"
    def bits(t):
        return t.view(torch.int64 if t.element_size() == 8 else torch.int32)

    assert len(back._dev + back._tables) == len(snap)
    for t, s in zip(back._dev + back._tables, snap):
        assert torch.equal(bits(t), bits(s))
    assert np.array_equal(after[0], before[0])
    assert np.array_equal(after[1].view(np.int32), before[1].view(np.int32))
    olabs, od2 = back.oracle_predict(Q)
    assert np.array_equal(after[0], olabs)


@pytest.mark.cuda
def test_span_sync_on_covers_the_card_work():
    """A span with ``sync_on`` closes after the work queued on the
    tensor's stream, so it covers the CUDA events recorded around it;
    ``sync=True`` synchronises the tracer's device."""
    _need_card()
    from pypardis_tpu_torch import obs

    dev = torch.device("cuda")
    a = torch.randn(4096, 4096, device=dev)
    tr = obs.Tracer(device=dev)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with tr.span("matmul") as sp:
        s.record()
        out = a
        for _ in range(8):
            out = out @ a
        e.record()
        sp.sync_on(out)
    assert e.query()
    assert tr.spans[-1].dur_s * 1e3 >= s.elapsed_time(e)
    with tr.span("barrier", sync=True):
        out = out @ a
    assert torch.cuda.current_stream().query()


@pytest.mark.cuda
def test_fit_report_on_the_card():
    """A fit on the card reports the H100 peak row (on an H100), a
    positive model rate, its device watermark within the allocator's
    peak, and the pipeline's spans."""
    _need_card()
    X, _ = make_blob_data(50_000, 16, n_centers=16, std=0.4)
    m = DBSCAN(eps=2.4, min_samples=10, block=1024).fit(X)
    r = m.report()
    comp, res = r["compute"], r["resources"]
    if "H100" in torch.cuda.get_device_name():
        assert (comp["peak_source"], comp["peak_flops"]) == (
            "table:h100", 989e12)
    assert comp["achieved_flops_per_sec"] > 0
    assert comp["live_pairs"] == m.metrics_["live_pairs"]
    assert 0 < res["peak_device_bytes"] <= torch.cuda.max_memory_allocated()
    assert r["run"]["backend"] == "cuda"
    assert [s.name for s in m._recorder.tracer.spans] == [
        "pipeline.layout", "pipeline.cluster", "cluster", "densify"]


_CHECKED_CHILD = r"""
import json, torch
from pypardis_tpu_torch.csrc import _build

assert _build.checked()
lib = _build.load()
L, nb, block, d = 4, 2, 32, 16
C = nb * block
g = torch.Generator(device="cuda").manual_seed(0)
coords = torch.randn((d, L * C), generator=g, device="cuda")
labels = torch.arange(L * C, dtype=torch.int32, device="cuda")
tables = (torch.empty(L, dtype=torch.int64, device="cuda"),
          torch.empty(L, dtype=torch.int32, device="cuda"),
          torch.empty((L * nb, d), device="cuda"),
          torch.empty((L * C, 4), device="cuda"))
stream = torch.cuda.current_stream().cuda_stream


def run(extents):
    rc = lib.pp_query_tables(coords.data_ptr(), labels.data_ptr(), L, C,
                             block, d, *(t.data_ptr() for t in tables),
                             *extents, stream)
    torch.cuda.synchronize()
    return rc


out = {"whole": run([t.numel() for t in tables])}
print(json.dumps(out), flush=True)
try:
    run([L - 1] + [t.numel() for t in tables[1:]])
    out["short"] = "no error"
except RuntimeError as e:
    out["short"] = str(e).splitlines()[0]
print(json.dumps(out), flush=True)
"""


@pytest.mark.cuda
def test_checked_build_traps_a_store_past_its_extent():
    """The checked build's guards can fire: B5's table kernels told that
    ``pad_keys`` holds one leaf fewer than the grid writes stop the
    launch, where the whole extents pass.  The normal build ignores the
    extents.  The checked library runs in a child process, as a trap
    leaves its CUDA context unusable."""
    import json
    import os
    import subprocess
    import sys

    _need_card()
    from pypardis_tpu_torch.csrc import _build

    if not _build.checked():
        lib = _build.load()
        L, C, d = 4, 64, 16
        coords = torch.randn((d, L * C), device="cuda")
        labels = torch.arange(L * C, dtype=torch.int32, device="cuda")
        whole = ck.query_tables(coords, labels, block=32, nb=2)
        tables = tuple(torch.empty_like(t) for t in whole)
        rc = lib.pp_query_tables(
            coords.data_ptr(), labels.data_ptr(), L, C, 32, 16,
            *(t.data_ptr() for t in tables), 0, 0, 0, 0,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert all(torch.equal(a, b) for a, b in zip(tables, whole))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PPTORCH_KERNEL_CHECKS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _CHECKED_CHILD], env=env,
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert lines, proc.stderr[-4000:]
    out = json.loads(lines[-1])
    assert out["whole"] == 0, out
    assert out.get("short", "no error") != "no error", (out, proc.stderr)
