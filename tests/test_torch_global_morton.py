"""The global-Morton route's chained form on one card,
``pypardis_tpu_torch.parallel.global_morton_dbscan(points, mesh=1,
chain=R)``, held against the JAX package's
``global_morton_dbscan(points, mesh=default_mesh(1), chain=R)`` on the
CPU (``tests/test_global_morton.py``'s geometry: 3,000 x 3 blobs as a
float32 memmap and its in-RAM twin, eps 0.4, min_samples 5, block 128;
a 1,200 x 128 case runs the plain B3/B4).  Bitwise throughout: the
in-RAM and streaming splits, each range's break plan and boundary
cover, the owner-computes passes on a real range slab, and the route's
labels, core flags and stats (timings aside).  Then the env and
``sharded_dbscan`` spellings, the spill's cleanup, retry and resume at
``gm.chained_range``, the refused metrics, the knobs the mesh engine
lifted (held against the JAX engine) and the tile rule.

One documented difference: under ``precision="mixed"`` the JAX
package's CPU pass tests its band on the exact d^2, the port's B1 (and
its plain version) on the bf16 fast d^2, as the kernels do, so
``band_pairs`` differs by the pairs that straddle a band edge (35 of
14,608 on the range slab below; the fused fits differ alike).  It is
held within 1 % of JAX, and exactly against the port's own whole-slab
counts pass; ``rescored_tiles`` and everything else bitwise."""

import os
import sys

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import benchdata
from pypardis_tpu import partition as jax_partition
from pypardis_tpu.ops import labels as jax_labels
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu.parallel import global_morton as jax_gm
from pypardis_tpu_torch import DBSCAN, obs
from pypardis_tpu_torch import partition
from pypardis_tpu_torch.ops import labels as oc
from pypardis_tpu_torch.ops.cuda_kernels import _pallas_block, gm_tile_aligned
from pypardis_tpu_torch.parallel import (
    global_morton as gm,
    global_morton_dbscan,
    sharded_dbscan,
)
from pypardis_tpu_torch.parallel.sharded import _canonicalize_roots
from pypardis_tpu_torch.partition import KDPartitioner
from pypardis_tpu_torch.utils import faults
from pypardis_tpu_torch.utils.faults import FaultInjected
from pypardis_tpu_torch.utils.jobstate import JobState, fit_meta

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_precision_fits import lattice  # noqa: E402

KW = dict(eps=0.4, min_samples=5, block=128)
# The JAX route's timings; the port's own telemetry.
PORT_ONLY = {"stage_s", "partition_passes"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.clear()
    staging.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def mm_points(tmp_path_factory):
    """A disk-backed float32 memmap of the 3,000 blobs and its in-RAM
    twin (the memmap rounds the float64 blobs once)."""
    X, _ = make_blobs(n_samples=3000, centers=6, n_features=3,
                      cluster_std=0.3, random_state=3)
    X = X.astype(np.float32)
    path = tmp_path_factory.mktemp("gm") / "pts.f32"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    return np.memmap(path, dtype=np.float32, mode="r", shape=X.shape), X


def _sketched128():
    X, _, _ = benchdata.make_separated_blob_data(
        1200, 128, n_centers=6, min_sep=30.0, spread=30.0, seed=2)
    return X.astype(np.float32), dict(eps=9.0, min_samples=10, block=128)


@pytest.fixture(scope="module")
def references(mm_points):
    """The JAX chained route per case: ``{case: (X, kwargs, chain,
    (labels, core, stats))}``."""
    mm, X = mm_points
    Xs, kws = _sketched128()
    cases = {
        "memmap": (mm, dict(KW, precision="high"), 4),
        "mixed": (mm, dict(KW, precision="mixed"), 4),
        "sketched128": (Xs, dict(kws, precision="high"), 2),
    }
    out = {}
    for name, (pts, kw, chain) in cases.items():
        staging.clear()
        out[name] = (pts, kw, chain, jax_gm.global_morton_dbscan(
            pts, mesh=default_mesh(1), chain=chain, **kw))
    out["inram"] = (X, dict(KW, precision="high"), 4, out["memmap"][3])
    return out


def _recorded(fn):
    rec = obs.RunRecorder()
    with obs.use_recorder(rec):
        out = fn()
    return out, rec


# -- the splits -------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(eps=0.4, block=128)],
                         ids=["equal_rows", "work_balanced"])
def test_morton_range_split_matches_jax(mm_points, kw):
    _mm, X = mm_points
    want = jax_partition.morton_range_split(X, 8, **kw)
    got = partition.morton_range_split(X, 8, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    order, starts, center = got
    np.testing.assert_array_equal(
        order, partition.spatial_order((X - center).astype(np.float32)))
    assert starts[0] == 0 and starts[-1] == len(X)
    if kw:
        # Work-balanced cuts: on tile boundaries, each range within 1.5x
        # the equal share of tiles.
        assert all(s % 128 == 0 for s in starts[1:-1])
        cap = np.ceil(1.5 * -(-len(X) // 128) / 8) * 128
        assert np.diff(starts).max() <= cap


@pytest.mark.parametrize("kw", [{}, dict(eps=0.4, block=128)],
                         ids=["equal_rows", "work_balanced"])
def test_streaming_split_matches_jax(mm_points, kw):
    mm, X = mm_points
    with jax_partition.morton_range_split_streaming(
            mm, 8, bucket_bytes=50_000, **kw) as want, \
            partition.morton_range_split_streaming(
                mm, 8, bucket_bytes=50_000, **kw) as got:
        assert got.stats["stream_buckets"] > 1
        assert got.stats == want.stats
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.center, want.center)
        if kw:
            np.testing.assert_array_equal(got.tile_lo, want.tile_lo)
            np.testing.assert_array_equal(got.tile_hi, want.tile_hi)
        for s in range(8):
            (gi, gr), (wi, wr) = got.range_rows(s), want.range_rows(s)
            np.testing.assert_array_equal(gi, wi)
            assert gr.tobytes() == wr.tobytes()
        # The in-RAM split's order, and its recentred float32 rows.
        order, starts, center = partition.morton_range_split(X, 8, **kw)
        np.testing.assert_array_equal(got.starts, starts)
        np.testing.assert_array_equal(
            np.concatenate([got.range_ids(s) for s in range(8)]), order)
        ids0, rows0 = got.range_rows(0)
        assert rows0.tobytes() == (X[ids0] - center).astype(
            np.float32).tobytes()
        sdir = got._spill_dir
    assert not os.path.exists(sdir)


def test_streaming_split_all_duplicate_rows():
    D = np.ones((4096, 3), np.float32)
    kw = dict(eps=0.4, block=64, bucket_bytes=20_000)
    with jax_partition.morton_range_split_streaming(D, 8, **kw) as want, \
            partition.morton_range_split_streaming(D, 8, **kw) as got:
        np.testing.assert_array_equal(got.starts, want.starts)
        assert got.stats == want.stats
        cat = np.concatenate([got.range_ids(s) for s in range(8)])
        np.testing.assert_array_equal(cat, np.arange(4096))
        assert got.stats["stream_buckets"] > 1
        assert got.stats["stream_max_bucket_rows"] < 4096


# -- each range's layout and boundary cover -------------------------------


def _splits(mm, n_ranges=4, block=128, eps=0.4):
    return (jax_partition.morton_range_split_streaming(mm, n_ranges, eps=eps,
                                                       block=block),
            partition.morton_range_split_streaming(mm, n_ranges, eps=eps,
                                                   block=block))


@pytest.mark.parametrize("segbreak", ["1", "0"])
def test_stream_range_plans_and_boundary_cover_match_jax(mm_points,
                                                         monkeypatch,
                                                         segbreak):
    """Per range: the break plan, padded length and extent box
    (``_stream_range_plan``), the boundary tiles and rows
    (``_chain_boundary_tiles``) and the boundary slab, mask and gids
    (``_chain_fill_boundary``, the JAX rows transposed)."""
    mm, _X = mm_points
    monkeypatch.setenv("PPTORCH_GM_SEGBREAK", segbreak)
    if segbreak == "0":
        monkeypatch.setenv("PYPARDIS_GM_SEGBREAK", "0")
    want, got = _splits(mm)
    with want, got:
        broke = False
        for s in range(4):
            wp, wl, wlo, whi = jax_gm._stream_range_plan(want, s, 128, 0.4)
            gp, gl, glo, ghi = gm._stream_range_plan(got, s, 128, 0.4)
            assert gl == wl
            np.testing.assert_array_equal(glo, wlo)
            np.testing.assert_array_equal(ghi, whi)
            assert (gp is None) == (wp is None)
            if gp is not None:
                broke |= len(gp[0]) > 0
                for a, b in zip(gp, wp):
                    np.testing.assert_array_equal(a, b)
        assert broke == (segbreak == "1")
        n = len(mm)
        wt, wr = jax_gm._chain_boundary_tiles(want, want.starts, 128, 0.4,
                                              n, 4)
        gt, gr = gm._chain_boundary_tiles(got, got.starts, 128, 0.4, n, 4)
        assert gr == wr and sum(gr) > 0
        bcap = max(len(t) for t in gt) * 128
        for a, b in zip(gt, wt):
            np.testing.assert_array_equal(a, b)
            gbp, gbm, gbg = gm._chain_fill_boundary(got, a, bcap, 128, n, 3)
            wbp, wbm, wbg = jax_gm._chain_fill_boundary(want, b, bcap, 128,
                                                        n, 3)
            assert gbp.tobytes() == np.ascontiguousarray(wbp.T).tobytes()
            np.testing.assert_array_equal(gbm, wbm)
            np.testing.assert_array_equal(gbg, wbg)


def test_gm_segment_layout_matches_jax(mm_points):
    """The in-RAM form of the break plan (the mesh engine's) equals the
    JAX one and the streamed plan's targets."""
    mm, _X = mm_points
    with partition.morton_range_split_streaming(mm, 4, eps=0.4,
                                                block=128) as sp:
        for s in range(4):
            _ids, rows = sp.range_rows(s)
            t, plen = gm._gm_segment_layout(rows, 128, 0.4)
            jt, jplen = jax_gm._gm_segment_layout(rows, 128, 0.4)
            np.testing.assert_array_equal(t, jt)
            assert plen == jplen
            plan, splen, _lo, _hi = gm._stream_range_plan(sp, s, 128, 0.4)
            assert splen == plen
            np.testing.assert_array_equal(
                gm._plan_targets(plan, 0, len(rows)), t)


# -- the owner-computes passes on a real range slab ------------------------


def _range_slab_case(pts, kw, chain, core_g):
    """The range with the most boundary tiles, laid out by the route's
    own code: ``(pts (k, N), mask, gids, cap, core_all)``, ``core_all``
    the owners' flags from ``core_g`` (N,)."""
    n, k = pts.shape
    block = kw["block"]
    with partition.morton_range_split_streaming(pts, chain, eps=kw["eps"],
                                                block=block) as sp:
        plans = [gm._stream_range_plan(sp, s, block, kw["eps"])
                 for s in range(chain)]
        cap = max(p[1] for p in plans)
        tiles, _rows = gm._chain_boundary_tiles(sp, sp.starts, block,
                                                kw["eps"], n, chain)
        bcap = max(len(t) for t in tiles) * block
        s = int(np.argmax([len(t) for t in tiles]))
        slab, msk, og, bg = gm._range_slab(sp, s, plans[s][0], tiles[s], cap,
                                           bcap, block, n)
    gid = np.concatenate([og, bg])
    core_all = core_g[np.clip(gid, 0, n - 1)] & (gid < n)
    return slab, msk, gid, cap, core_all


@pytest.mark.parametrize("case,precision", [
    ("blobs", "high"), ("blobs", "mixed"), ("lattice", "default"),
])
def test_oc_passes_match_jax_on_a_range_slab(mm_points, case, precision):
    """``oc_counts_banded`` and ``oc_propagate_banded`` on the largest
    range slab against the JAX passes (XLA) on the same rows: owned core
    flags, labels and passes bitwise; band stats as the module says.
    ``"default"`` runs on the guard-banded lattice, whose every pair lies
    far from eps (the JAX package's CPU pass is float32)."""
    if case == "blobs":
        _mm, X = mm_points
        kw = dict(KW)
    else:
        X = lattice()
        kw = dict(eps=float(np.sqrt(23.0)), min_samples=150, block=128)
    core_g = DBSCAN(device="cpu", **kw).fit(X).core_sample_mask_
    slab, msk, gid, cap, core_all = _range_slab_case(X, kw, 2 if case ==
                                                     "lattice" else 4, core_g)
    pts = torch.from_numpy(slab)
    mask = torch.from_numpy(msk)
    ex = oc.oc_extract(pts, kw["eps"], mask, owned=cap, block=kw["block"],
                       precision=precision)
    assert ex["total"] <= ex["budget"] and ex["hh_pairs"] > 0
    core, band = oc.oc_counts_banded(ex, kw["min_samples"])
    labels, passes, pband = oc.oc_propagate_banded(
        ex, torch.from_numpy(core_all))

    import jax.numpy as jnp

    jp, jm = jnp.asarray(slab.T), jnp.asarray(msk)
    jkw = dict(owned=cap, metric="euclidean", block=kw["block"],
               precision=precision)
    kind, pairs, jst = jax_labels.oc_extract(jp, kw["eps"], jm, backend="xla",
                                             **jkw)
    jcore, jband = jax_labels.oc_counts_banded(
        jp, kw["eps"], kw["min_samples"], jm, kind=kind, pairs=pairs, **jkw)
    jlab, jpasses, _jpb = jax_labels.oc_propagate_banded(
        jp, kw["eps"], jm, jnp.asarray(core_all), kind=kind, pairs=pairs,
        **jkw)
    np.testing.assert_array_equal(core.numpy(), np.asarray(jcore))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlab))
    assert passes == int(jpasses)
    # The owned flags are the whole data's, and boundary slots relay.
    own = gid[:cap] < len(X)
    np.testing.assert_array_equal(core.numpy()[own], core_g[gid[:cap][own]])
    assert (labels.numpy()[cap:] >= 0).any()
    # The stats row's live pairs: the JAX count less the boundary pairs.
    assert ex["total"] - ex["hh_pairs"] == int(np.asarray(jst)[0])
    assert pband.tolist() == [0, 0]
    if precision == "mixed":
        jb = np.asarray(jband).astype(np.int64)
        assert band[0] > 0 and abs(int(band[0]) - int(jb[0])) <= 1e-2 * jb[0]
        assert int(band[1]) == int(jb[1])
        # The band over the owned rows plus the band over the others is
        # the whole slab's counts pass's.
        from pypardis_tpu_torch.ops.cuda_kernels import neighbor_counts_cuda

        rows, cols = ex["pairs"]
        kw_n = dict(block=kw["block"], precision="mixed", sketch=0,
                    frames=ex["frames"])
        _c, whole = neighbor_counts_cuda(pts, kw["eps"], mask, pairs=(rows,
                                         cols), **kw_n)
        keep = rows >= ex["ont"]
        _c, rest = neighbor_counts_cuda(pts, kw["eps"], mask, pairs=(
            rows[keep], cols[keep]), **kw_n)
        assert (band + rest).tolist() == whole.tolist()
    else:
        assert band.tolist() == np.asarray(jband).astype(np.int64).tolist()


def test_oc_counts_and_propagate_keep_the_kernel_convention(mm_points):
    """``oc_counts``/``oc_propagate`` widen by the band only under
    ``"mixed"``, as the JAX entry points do."""
    _mm, X = mm_points
    core_g = DBSCAN(device="cpu", **KW).fit(X).core_sample_mask_
    slab, msk, _gid, cap, core_all = _range_slab_case(X, KW, 4, core_g)
    for precision, width in (("high", None), ("mixed", 2)):
        ex = oc.oc_extract(torch.from_numpy(slab), 0.4,
                           torch.from_numpy(msk), owned=cap, block=128,
                           precision=precision)
        c = oc.oc_counts(ex, 5)
        p = oc.oc_propagate(ex, torch.from_numpy(core_all))
        assert isinstance(c, tuple) == (width is not None)
        assert len(p) == (3 if width else 2)


# -- the route ----------------------------------------------------------------


def _same_stats(stats, j_stats):
    assert set(stats) - PORT_ONLY == set(j_stats)
    for key, want in j_stats.items():
        if key.endswith("_s") or key == "band_pairs":
            continue
        assert stats[key] == want, key


@pytest.mark.parametrize("case", ["memmap", "inram", "mixed", "sketched128"])
def test_chained_route_matches_jax(references, case):
    pts, kw, chain, (j_lab, j_core, j_stats) = references[case]
    lab, core, stats = global_morton_dbscan(pts, mesh=1, chain=chain,
                                            device="cpu", **kw)
    assert lab.dtype == j_lab.dtype and core.dtype == j_core.dtype
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    assert len(np.unique(lab[lab >= 0])) > 1
    _same_stats(stats, j_stats)
    if case == "mixed":
        assert abs(stats["band_pairs"] - j_stats["band_pairs"]) <= (
            1e-2 * j_stats["band_pairs"])
    else:
        assert stats["band_pairs"] == j_stats["band_pairs"]
    assert stats["duplicated_work_factor"] == 1.0
    assert stats["owner_computes"] is True and stats["input"] == "stream"
    assert stats["boundary_tiles"] > 0
    assert stats["sketch_k"] == (32 if case == "sketched128" else 0)
    # One entry per range: its counts pass and its min-label passes.
    assert len(stats["partition_passes"]) == chain
    assert max(stats["partition_passes"]) == stats["kernel_passes"]
    for key in ("gm_build_s", "gm_exchange_s", "gm_execute_s", "gm_merge_s",
                "gm_total_s"):
        assert np.isfinite(stats[key]) and stats[key] >= 0
    # The fused single-card fit's clustering, in the root convention.
    fit = DBSCAN(eps=kw["eps"], min_samples=kw["min_samples"],
                 block=kw["block"], precision=kw["precision"],
                 device="cpu").fit(np.asarray(pts))
    np.testing.assert_array_equal(
        lab, _canonicalize_roots(fit.labels_, fit.core_sample_mask_))
    np.testing.assert_array_equal(core, fit.core_sample_mask_)


def test_env_chain_and_the_sharded_spelling(references, monkeypatch):
    pts, kw, _chain, (j_lab, j_core, _js) = references["memmap"]
    monkeypatch.setenv("PPTORCH_GM_CHAIN", "4")
    lab, core, stats = global_morton_dbscan(pts, mesh=1, device="cpu", **kw)
    np.testing.assert_array_equal(lab, j_lab)
    assert stats["chained"] is True and stats["n_shard_partitions"] == 4
    lab2, core2, stats2 = sharded_dbscan(
        pts, KDPartitioner(np.asarray(pts), max_partitions=8),
        mode="global_morton", device="cpu", **kw)
    np.testing.assert_array_equal(lab2, j_lab)
    np.testing.assert_array_equal(core2, j_core)
    assert stats2["mode"] == "global_morton"


def test_spill_is_removed_on_success_and_on_failure(references, tmp_path,
                                                    monkeypatch):
    pts, kw, chain, _ref = references["memmap"]
    spill = tmp_path / "spill"
    spill.mkdir()
    monkeypatch.setenv("PPTORCH_SPILL_DIR", str(spill))
    seen = []
    orig = gm.morton_range_split_streaming

    def spy(*a, **k):
        sp = orig(*a, **k)
        seen.append(sp._spill_dir)
        return sp

    monkeypatch.setattr(gm, "morton_range_split_streaming", spy)
    global_morton_dbscan(pts, mesh=1, chain=chain, device="cpu", **kw)
    assert len(seen) == 1 and seen[0].startswith(str(spill))
    assert list(spill.iterdir()) == [], "spill left after success"
    with faults.plan("gm.chained_range:6=error"):
        with pytest.raises(FaultInjected):
            global_morton_dbscan(pts, mesh=1, chain=chain, device="cpu",
                                 **kw)
    assert len(seen) == 2
    assert list(spill.iterdir()) == [], "spill left after a failure"


def test_a_transient_fault_retries_the_range(references):
    pts, kw, chain, (j_lab, j_core, _js) = references["memmap"]
    with faults.plan("gm.chained_range:1=transfer_error"):
        (lab, core, stats), rec = _recorded(lambda: global_morton_dbscan(
            pts, mesh=1, chain=chain, device="cpu", **kw))
        assert faults.fault_stats() == {"gm.chained_range": 1}
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    ev = rec.event_counts()
    assert ev["fault_injected"] == 1 and ev["retry.gm.chained_range"] == 1
    assert "retry_giveup" not in ev
    # The JAX route's spans.
    assert {"gm.build", "gm.exchange", "gm.execute", "gm.merge_host"} <= set(
        rec.tracer.durations())
    # The retry re-dispatched range 0 from its slab: one entry per range.
    assert len(stats["partition_passes"]) == chain


def test_resume_past_the_finished_ranges(references, tmp_path,
                                         monkeypatch):
    """A first run dies at pass B's third range (the site's seventh
    arrival with 4 ranges) under a jobstate; the resumed run restores
    ranges 0 and 1, builds and dispatches only 2 and 3 in both passes,
    and gives the uninterrupted labels."""
    pts, kw, chain, (j_lab, j_core, _js) = references["memmap"]
    path = str(tmp_path / "gm.ckpt.npz")
    meta = fit_meta(np.asarray(pts), eps=kw["eps"],
                    min_samples=kw["min_samples"], metric="euclidean",
                    block=kw["block"], mode="global_morton")
    js = JobState.open(path, meta, every_s=0)
    with faults.plan(f"gm.chained_range:{chain + 3}=error"):
        with pytest.raises(FaultInjected):
            global_morton_dbscan(pts, mesh=1, chain=chain, jobstate=js,
                                 device="cpu", **kw)
    built = []
    orig = gm._range_slab

    def spy(split, s, *a):
        built.append(s)
        return orig(split, s, *a)

    monkeypatch.setattr(gm, "_range_slab", spy)
    js2 = JobState.open(path, meta, resume=True)
    (lab, core, stats), rec = _recorded(lambda: global_morton_dbscan(
        pts, mesh=1, chain=chain, jobstate=js2, device="cpu", **kw))
    assert js2.restored_partitions == 2
    assert built == [2, 3, 2, 3]
    assert len(stats["partition_passes"]) == 2
    assert rec.event_counts()["jobstate_restore"] == 1
    assert [e for e in rec.events if e["kind"] == "jobstate_restore"][0][
        "route"] == "gm_chained"
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)


def test_a_tiny_pair_budget_reruns_at_the_exact_total(references):
    pts, kw, chain, (j_lab, _jc, j_stats) = references["memmap"]
    (lab, _core, stats), rec = _recorded(lambda: global_morton_dbscan(
        pts, mesh=1, chain=chain, pair_budget=4, device="cpu", **kw))
    np.testing.assert_array_equal(lab, j_lab)
    assert stats["live_pairs"] == j_stats["live_pairs"]
    assert rec.event_counts()["pair_overflow"] >= 1
    # The truncated attempt ran no pass.
    assert len(stats["partition_passes"]) == 2 * chain
    assert stats["partition_passes"][:chain].count(0) >= 1


# -- what the slice does not cover --------------------------------------------


def _cityblock_callable():
    from scipy.spatial.distance import cityblock

    return cityblock


@pytest.mark.parametrize("knob", [
    dict(metric="cityblock"), dict(metric="manhattan"), dict(metric="l1"),
    dict(metric=_cityblock_callable()),
])
def test_refusals_name_their_roadmap_item(mm_points, monkeypatch, knob):
    """The engine's non-Euclidean metrics (every cityblock spelling) stay
    refused on both forms, naming their item."""
    monkeypatch.delenv("PPTORCH_GM_CHAIN", raising=False)
    _mm, X = mm_points
    for chain in (4, None):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            global_morton_dbscan(X, device="cpu", chain=chain, **KW, **knob)


@pytest.mark.parametrize("knob", [
    dict(mesh=2), dict(chain=1), dict(chain=None), dict(btcap=4),
    dict(merge="device"),
])
def test_knobs_the_mesh_engine_lifted_run_as_in_jax(mm_points, monkeypatch,
                                                   knob):
    """The knobs the chained form once refused: a mesh of two devices,
    ``chain`` 1 or unset (the engine on one device), and ``btcap`` or
    ``merge="device"`` beside ``chain=4`` (unread on the chained form, as
    in JAX).  Each runs to the JAX engine's labels for the same call."""
    monkeypatch.delenv("PPTORCH_GM_CHAIN", raising=False)
    _mm, X = mm_points
    kw = dict(dict(chain=4), **knob)
    jkw = dict(kw, mesh=default_mesh(kw.get("mesh", 1)))
    j_lab, j_core, _js = jax_gm.global_morton_dbscan(X, **KW, **jkw)
    lab, core, st = global_morton_dbscan(X, device="cpu", **KW, **kw)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    assert st["n_shard_partitions"] == _js["n_shard_partitions"]
    assert st.get("chained", False) == _js.get("chained", False)


def test_runs_on_the_card_by_default(mm_points, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _mm, X = mm_points
    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_morton_dbscan(X, mesh=1, chain=4, **KW)


@pytest.mark.parametrize("d", [3, 16, 64, 128, 512, 4096])
def test_a_power_of_two_block_always_aligns(d):
    """``cap`` and ``bcap`` are multiples of ``block``, and the tile is
    ``block`` halved: with a power-of-two ``block`` it divides both."""
    for block in (64, 128, 256, 512, 1024, 2048, 4096):
        for caps in ((1, 1), (3, 1), (7, 5), (1, 9)):
            cap, total = caps[0] * block, (caps[0] + caps[1]) * block
            for mode in ("high", "mixed", "default"):
                assert gm_tile_aligned(block, total, cap, d, mode)


def test_a_misaligned_slab_raises():
    """block=1001 at 600 axes: the tile halves to 500, then 250, 125,
    none of which divides the slab, and nothing quietly runs."""
    block, d = 1001, 600
    assert _pallas_block(block, 3 * block, d) != block
    assert not gm_tile_aligned(block, 3 * block, 2 * block, d)
    with pytest.raises(ValueError, match="block=1001"):
        oc.gm_backend("auto", "euclidean", 3 * block, 2 * block, block, d,
                      "high", torch.device("cpu"))
    pts = torch.zeros((d, 3 * block))
    with pytest.raises(ValueError, match="block=1001"):
        oc.oc_extract(pts, 1.0, torch.ones(3 * block, dtype=torch.bool),
                      owned=2 * block, block=block)
