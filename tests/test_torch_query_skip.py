"""B5's skipping of padding and its "mixed" units, in plain torch on the
CPU, against the JAX package.

The CUDA kernel (``csrc/query_kernels.cu``) cannot run here.  It answers
pad rows from a per-index table of keys, skips each leaf's pad tail up to
a per-index end, and under ``"mixed"`` decides (tile, 32-row group,
column block) units from per-index block frames.  ``ops/query`` holds
those tables' plain versions and the two walks (``query_skip_walk``,
``query_keep_walk``); these tests hold them against the JAX Pallas B5 in
interpret mode, the plain B5 and the plain prefilter.  The card holds
the kernel against the same functions (``tests/test_torch_card.py``,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_card import query_pad_inputs

import chip_smoke
from pypardis_tpu.ops.pallas_kernels import query_min_core_pallas
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops import query
from pypardis_tpu_torch.ops.distances import eps2_f32

INT_INF = np.iinfo(np.int32).max


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _pallas(q, tile_leaf, coords, labels, block, nb):
    return np.asarray(query_min_core_pallas(
        jnp.asarray(q), jnp.asarray(tile_leaf), jnp.asarray(coords),
        jnp.asarray(labels), jnp.zeros(1, jnp.int32),
        jnp.ones(1, jnp.float32), block=block, nb=nb, interpret=True,
    ))


def _tables(coords, labels, block, nb):
    return ck.query_tables(torch.from_numpy(coords), torch.from_numpy(labels),
                           block=block, nb=nb)


@pytest.mark.parametrize("d", [3, 16, 96])
def test_tables_and_skip_walk_equal_the_pallas_kernel(d):
    """Pad rows from the key table and real rows cut at the leaf ends
    give the whole packed output of JAX's Pallas B5 bit for bit: a full
    leaf, pad tails, a pad slot inside a leaf, an all-pad leaf, pad
    tiles, pad rows and real rows near the pad magnitude."""
    *arrays, block, nb = query_pad_inputs(d)
    q, tl, coords, labels = arrays
    pad_keys, ends, _ctr, _slots = _tables(coords, labels, block, nb)
    C = block * nb
    assert ends.tolist() == [C, 2 * C - 70 - C, C - 40, 0]
    want = _pallas(q, tl, coords, labels, block, nb)
    t = [torch.from_numpy(a) for a in arrays]
    walk = query.query_skip_walk(*t, pad_keys, ends, block=block, nb=nb)
    assert np.array_equal(walk.numpy(), want)
    plain = query.query_min_core_plain(*t, block=block, nb=nb)
    assert np.array_equal(plain.numpy(), want)
    # The keys by hand: a leaf without a pad slot answers its pad rows
    # (+inf, least label), any other (0, INT32_MAX).
    lab0 = int(labels[:C].min())
    assert int(pad_keys[0]) == (0x7F800000 << 32) | (lab0 ^ 0x80000000)
    assert all(int(k) == 0xFFFFFFFF for k in pad_keys[1:])
    d2 = want[1].view(np.float32)
    assert np.isinf(d2[6:]).all() and (want[0][6:] == lab0).all()
    assert np.isfinite(d2[1, 20]) and want[0][1, 20] == INT_INF


def test_tables_on_assembled_batches_equal_the_pallas_kernel():
    """An index's tables on its own assembled batches (pad tiles at leaf
    0, pad rows, leaves padded to the largest): the walk equals JAX's
    Pallas B5 on the whole packed output."""
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=1200, centers=5, n_features=4,
                      cluster_std=0.5, random_state=3)
    model = DBSCAN(eps=0.6, min_samples=5, device="cpu").fit(X)
    idx = model.query_engine(leaves=6, block=32, qblock=32).index
    rng = np.random.default_rng(5)
    Q = X[rng.integers(0, len(X), 300)] + rng.normal(scale=0.2,
                                                     size=(300, 4))
    qbuf, tile_leaf, rowmap = idx.assemble(idx.prepare_queries(Q))
    assert len(rowmap) < qbuf.shape[0]  # pad tiles
    coords, labels, _blo, _bhi = idx.device_tensors()
    pad_keys, ends, _ctr, _slots = idx.kernel_tables()
    assert int(ends.max()) <= idx.leaf_cap and int(ends.min()) < idx.leaf_cap
    want = _pallas(qbuf, tile_leaf, idx.coords, idx.labels, idx.block, idx.nb)
    walk = query.query_skip_walk(
        torch.from_numpy(qbuf), torch.from_numpy(tile_leaf), coords, labels,
        pad_keys, ends, block=idx.block, nb=idx.nb)
    assert np.array_equal(walk.numpy(), want)


@pytest.mark.parametrize("d", [5, 16, 64])
def test_block_frames_equal_the_prefilter_frames(d):
    """The per-index frames, bitwise what ``fast_block_keep`` computes per
    call on the real slots of every block (pad slots carry zeros)."""
    *arrays, block, nb = query_pad_inputs(d, seed=2)
    _q, _tl, coords, labels = (torch.from_numpy(a) for a in arrays)
    ctr, slots = query.query_block_frames(coords, labels, block)
    nbk = coords.shape[1] // block
    real, c, c2, nc, gc = query.keep_frames(
        coords.reshape(d, nbk, block), labels.reshape(nbk, block))
    assert torch.equal(ctr.view(torch.int32), c[..., 0].T.view(torch.int32))
    s = slots.reshape(nbk, block, 4)
    assert torch.equal(s[..., 3] > 0, real)
    for i, want in enumerate((c2, nc, gc)):
        assert torch.equal(s[..., i][real].view(torch.int32),
                           want[real].view(torch.int32))
        assert bool((s[..., i][~real] == 0).all())


@pytest.mark.parametrize("d", [3, 16])
def test_block_frames_take_correctly_rounded_square_roots(d):
    """The frames' two square-root columns round correctly, as the
    kernel's ``__fsqrt_rn`` does (numpy's float32 ``sqrt`` is IEEE), on
    enough slots that torch's own float32 CPU ``sqrt`` would miss."""
    rng = np.random.default_rng(d)
    block, n = 64, 64 * 512
    coords = (rng.normal(size=(d, n)) * 7.0).astype(np.float32)
    labels = rng.integers(0, 50, n).astype(np.int32)
    labels[rng.random(n) < 0.2] = INT_INF
    _ctr, slots = query.query_block_frames(
        torch.from_numpy(coords), torch.from_numpy(labels), block)
    s = slots.numpy()
    real = s[:, 3] > 0
    gc = coords[0] * coords[0]
    for a in range(1, d):
        gc = gc + coords[a] * coords[a]
    for col, sq in ((1, s[:, 0]), (2, gc)):
        want = np.where(real, np.sqrt(sq), np.float32(0))
        assert np.array_equal(s[:, col].view(np.int32),
                              want.view(np.int32))


def _mixed_from_units(q, tl, coords, labels, keep, block, nb):
    """The exact pass over the kept units only (the kernel's second
    phase), as the plain version: every other slot at (+inf, INT32_MAX)
    for that row."""
    nqt, d, qb = q.shape
    C = block * nb
    rows = keep.repeat_interleave(query.QUERY_GROUP, dim=1)[:, :qb]
    slots = rows.repeat_interleave(block, dim=2)  # (nqt, qb, C)
    cols = coords.reshape(d, -1, C)[:, tl.long()]  # (d, nqt, C)
    diff = q[:, 0, :, None] - cols[0][:, None, :]
    acc = diff * diff
    for a in range(1, d):
        diff = q[:, a, :, None] - cols[a][:, None, :]
        acc = acc + diff * diff
    lab = labels.reshape(-1, C)[tl.long()][:, None, :].expand(-1, qb, -1)
    acc = torch.where(slots, acc, float("inf"))
    lab = torch.where(slots, lab, INT_INF)
    m = acc.amin(dim=2)
    best = torch.where(acc == m[..., None], lab, INT_INF).amin(dim=2)
    return best, m


@pytest.mark.parametrize("d", [3, 16, 96])
def test_keep_walk_is_sound_and_matches_the_block_prefilter(d):
    """The walk keeps every unit holding a within-eps pair, so the exact
    pass over its kept units answers every real row as the exact B5 does
    after the verdict; OR-ed over each tile's groups its decisions equal
    ``fast_block_keep``'s (the plain "mixed" B5's, per tile and block) up
    to its fragile units; its counts are the wrapper's ``keep_stats`` on
    the CPU."""
    *arrays, block, nb = query_pad_inputs(d, seed=1)
    q, tl, coords, labels = (torch.from_numpy(a) for a in arrays)
    e2 = eps2_f32(0.5 + 0.3 * d ** 0.5)
    tables = ck.query_tables(coords, labels, block=block, nb=nb)
    keep, counts = query.query_keep_walk(q, tl, coords, labels, tables[2:],
                                         tables[1], e2, block=block, nb=nb)
    kept, visited, fragile, kept_pairs = (int(x) for x in counts)
    assert keep.shape == (q.shape[0], 3, nb) and int(keep.sum()) == kept
    assert 0 < kept < visited
    # Pair by pair: no more than the real pairs of the kept units.
    assert 0 < kept_pairs <= kept * query.QUERY_GROUP * block
    exact = query.query_min_core_plain(q, tl, coords, labels, block=block,
                                       nb=nb)
    real = (q.abs() < 1e18).all(dim=1)
    within = real & (exact[1].view(torch.float32) <= e2)
    assert int(within.sum()) > 0
    lab, d2 = _mixed_from_units(q, tl, coords, labels, keep, block, nb)
    assert torch.equal(lab[within], exact[0][within])
    assert torch.equal(d2[within].view(torch.int32), exact[1][within])
    assert bool((d2[real & ~within] > e2).all())
    C = block * nb
    cols = coords.reshape(q.shape[1], -1, C)[:, tl.long()].reshape(
        q.shape[1], q.shape[0], nb, block)
    labs = labels.reshape(-1, C)[tl.long()].reshape(q.shape[0], nb, block)
    per_tile = query.fast_block_keep(q, cols, labs, e2)
    assert int((keep.any(dim=1) != per_tile).sum()) <= fragile
    stats = torch.zeros(2, dtype=torch.int64)
    got = ck.query_leaf(q, tl, coords, labels, block=block, nb=nb,
                        precision="mixed", eps2=e2, keep_stats=stats,
                        tables=tables)
    assert stats.tolist() == [kept, visited]
    assert torch.equal(got, query.query_min_core_plain(
        q, tl, coords, labels, block=block, nb=nb, precision="mixed",
        eps2=e2))


def test_keep_walk_counts_fragile_units_near_eps():
    """At the eps^2 where a unit's decision flips, the summation order
    could flip it back, so the unit counts as fragile; well away from it
    the decision is sure."""
    d, block, nb, qb = 4, 8, 2, 32
    coords = np.zeros((d, block * nb), np.float32)
    coords[0, :block] = np.arange(block, dtype=np.float32)
    coords[0, block:] = 1e3 + np.arange(block, dtype=np.float32)
    labels = np.arange(block * nb, dtype=np.int32)
    q = np.full((1, d, qb), query.PAD_COORD, np.float32)
    q[0, :, 0] = 0.0
    q[0, 0, 0] = -1.0  # 1.0 from slot 0
    t = [torch.from_numpy(a) for a in (q, np.zeros(1, np.int32), coords,
                                       labels)]
    tables = ck.query_tables(t[2], t[3], block=block, nb=nb)

    def walk(e2):
        keep, counts = query.query_keep_walk(*t, tables[2:], tables[1],
                                             float(e2), block=block, nb=nb)
        return keep[0, 0].tolist(), counts.tolist()

    assert walk(1.0) == ([True, False], [1, 2, 0, 1])
    assert walk(0.25) == ([False, False], [0, 2, 0, 0])
    lo, hi = np.float32(0.25), np.float32(1.0)  # skipped, kept
    while np.nextafter(lo, hi) != hi:
        mid = np.float32((lo + hi) / 2)
        mid = mid if lo < mid < hi else np.nextafter(lo, hi)
        if walk(mid)[0][0]:
            hi = mid
        else:
            lo = mid
    assert walk(hi) == ([True, False], [1, 2, 1, 1])
    assert walk(lo) == ([False, False], [0, 2, 1, 0])


def test_b5_fill_counts_the_launched_pairs():
    """``chip_smoke.b5_fill`` on an assembled batch: the real pairs lie
    within the pairs B5's pass computes (``query_pass_pairs``, which the
    card's pass counter is held to), and those within every row against
    every slot; the mixed bound is the least of the exact bound and the
    prefilter plus the kept pairs' exact pass."""
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=900, centers=4, n_features=3,
                      cluster_std=0.4, random_state=1)
    model = DBSCAN(eps=0.5, min_samples=5, device="cpu").fit(X)
    idx = model.query_engine(leaves=4, block=32, qblock=32).index
    qbuf, tile_leaf, rowmap = idx.assemble(idx.prepare_queries(X[:200]))
    f = chip_smoke.b5_fill(idx, tile_leaf, rowmap, qbuf.shape[2])
    assert f["real_rows"] == sum(len(a) for a in rowmap)
    ends = idx.kernel_tables()[1]
    ran = query.query_pass_pairs(torch.from_numpy(qbuf),
                                 torch.from_numpy(tile_leaf), ends,
                                 block=idx.block, nb=idx.nb)
    assert 0 < f["real_pairs"] <= ran < f["all_pairs"]
    assert np.array_equal(f["ends"], ends.numpy())
    bound, by, ceiling, _ = chip_smoke.b5_bounds(f, 3)
    assert by == "operations" and ceiling == pytest.approx(2 * bound)
    assert chip_smoke.b5_bounds(f, 3, f["real_pairs"])[0] == bound
    # At d = 3 the exact pass (10 operations a pair) is cheaper than the
    # prefilter alone; at d = 16 (49) a prefilter keeping nothing is not.
    assert chip_smoke.b5_bounds(f, 3, 0)[0] == bound
    exact16 = chip_smoke.b5_bounds(f, 16)[0]
    assert 0 < chip_smoke.b5_bounds(f, 16, 0)[0] < exact16


def _pass_pairs_by_rows(q, tl, ends, block, nb, keep=None):
    """The pass's pairs row group by row group, in Python."""
    nqt, d, qb = q.shape
    C, G = block * nb, -(-qb // query.QUERY_GROUP)
    total = 0
    for t in range(nqt):
        for g in range(G):
            rows = q[t, :, g * 32:(g + 1) * 32].T.numpy()
            pad = (rows.view(np.int32) == int(
                np.float32(query.PAD_COORD).view(np.int32))).all(axis=1)
            near = ~pad & (np.abs(rows) >= 1e18).all(axis=1)
            lim = C if near.any() else int(ends[tl[t]]) if (~pad).any() else 0
            for b in range(nb):
                if keep is None or keep[t, g, b]:
                    total += 32 * max(0, min(lim, (b + 1) * block)
                                      - b * block)
    return total


@pytest.mark.parametrize("d", [3, 16])
def test_pass_pairs_count_what_the_pass_runs(d):
    """``query_pass_pairs`` (the count the card's pass counter is held
    to) equals the rule row group by row group: nothing for a group
    without a real row, the whole slab for a group with a near row,
    else up to the leaf's end, and only kept blocks under "mixed"; the
    CPU wrapper's ``pass_stats`` adds it."""
    *arrays, block, nb = query_pad_inputs(d, seed=1)
    q, tl, coords, labels = (torch.from_numpy(a) for a in arrays)
    tables = ck.query_tables(coords, labels, block=block, nb=nb)
    e2 = eps2_f32(0.5 + 0.3 * d ** 0.5)
    keep, _counts = query.query_keep_walk(q, tl, coords, labels, tables[2:],
                                          tables[1], e2, block=block, nb=nb)
    for k, kw in ((None, {}), (keep, dict(precision="mixed", eps2=e2))):
        want = _pass_pairs_by_rows(q, tl, tables[1], block, nb, k)
        assert query.query_pass_pairs(q, tl, tables[1], block=block, nb=nb,
                                      keep=k) == want > 0
        ran = torch.zeros(1, dtype=torch.int64)
        ck.query_leaf(q, tl, coords, labels, block=block, nb=nb,
                      pass_stats=ran, **kw)
        assert int(ran) == want
    # Pad tiles and groups of pad rows run nothing, near groups the slab.
    C = block * nb
    assert query.query_pass_pairs(q[6:], tl[6:], tables[1], block=block,
                                  nb=nb) == 0
    assert query.query_pass_pairs(q[:1, :, :32], tl[:1], tables[1],
                                  block=block, nb=nb) == 32 * C
