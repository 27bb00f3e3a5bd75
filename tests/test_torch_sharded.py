"""The KD route's chained form on one card,
``pypardis_tpu_torch.parallel.sharded_dbscan``, held against the JAX
package's ``sharded_dbscan(..., mesh=default_mesh(1), backend="xla")``
on the CPU: labels and core flags byte-identical on blobs750, 16-D
separated blobs and a 128-D case with the sketch on (the plain B3/B4
through the route), under both merges and both overlap settings, with
equal geometry and merge stats; the merge-rounds and pair-budget
ladders; the slab layout; ``merge_occurrences``; the overlap and its
buffer rotation; and the refusals."""

import time

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.preprocessing import StandardScaler

import benchdata
from pypardis_tpu.parallel import default_mesh, staging
from pypardis_tpu.parallel import merge as jax_merge
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch.parallel import merge as t_merge
from pypardis_tpu_torch.parallel import Mesh, sharded, sharded_dbscan
from pypardis_tpu_torch.parallel import staging as port_staging
from pypardis_tpu_torch.partition import KDPartitioner

# Stats the JAX route and the port must report alike.
SAME_STATS = (
    "owned_cap", "n_shard_partitions", "pad_waste", "partition_sizes",
    "halo_factor", "halo_cap", "halo_bytes", "merge", "merge_rounds",
    "merge_converged", "owner_computes", "duplicated_work_factor",
    "live_pairs", "kernel_passes", "band_pairs", "rescored_tiles",
    "kernel_block", "kernel_tiles", "sketch_k",
)
# The port's own telemetry.
PORT_ONLY = {"stage_s", "partition_passes", "merge_host_syncs"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _blobs750():
    X, _ = make_blobs(n_samples=750, centers=[[1, 1], [-1, -1], [1, -1]],
                      cluster_std=0.4, random_state=0)
    return StandardScaler().fit_transform(X).astype(np.float64), dict(
        eps=0.3, min_samples=10, block=64)


def _separated16():
    X, _, _ = benchdata.make_separated_blob_data(3000, 16, n_centers=6,
                                                 seed=1)
    return X, dict(eps=1.2, min_samples=10, block=128)


def _sketched128():
    """128-D separated blobs: the port's sketch resolves on ("auto" at
    d >= 128), so the route runs the plain B3/B4 per partition."""
    X, _, _ = benchdata.make_separated_blob_data(
        1200, 128, n_centers=6, min_sep=30.0, spread=30.0, seed=2)
    return X, dict(eps=9.0, min_samples=10, block=128)


CASES = {"blobs750": _blobs750, "separated16": _separated16,
         "sketched128": _sketched128}


def _margin(X, eps):
    """Least |d^2 - eps^2| / eps^2 over the pairs, in float64."""
    x = X.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    return float(np.abs(d2 - eps * eps).min() / (eps * eps))


def _jax(X, kw, **extra):
    staging.clear()
    return jax_sharded.sharded_dbscan(
        X, JaxKD(X, max_partitions=8), mesh=default_mesh(1),
        backend="xla", **kw, **extra)


@pytest.fixture(scope="module")
def references():
    """Per (case, merge): the data, its kwargs and the JAX result."""
    out = {}
    for name, make in CASES.items():
        X, kw = make()
        for merge in ("device", "host"):
            out[name, merge] = (X, kw, _jax(X, kw, merge=merge))
    return out


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("merge", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_chained_route_matches_jax(references, case, merge, overlap):
    X, kw, (j_lab, j_core, j_stats) = references[case, merge]
    # No pair within float32 rounding (~6e-8 relative) of eps: both
    # packages' verdicts are the exact ones here.
    assert _margin(X, kw["eps"]) > 1e-6
    lab, core, stats = sharded_dbscan(
        X, KDPartitioner(X, max_partitions=8), merge=merge,
        overlap=overlap, device="cpu", **kw)
    assert lab.dtype == j_lab.dtype and core.dtype == j_core.dtype
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    assert len(np.unique(lab[lab >= 0])) > 1
    # (The references ran with the overlap on; the port always
    # overlaps, so its efficiency is reported either way.)
    ov = {"overlap_efficiency"}
    assert set(stats) - PORT_ONLY - ov == set(j_stats) - ov
    for key in SAME_STATS:
        assert (key in stats) == (key in j_stats), key
        if key in j_stats:
            assert stats[key] == j_stats[key], key
    assert 0.0 < stats["overlap_efficiency"] <= 1.0
    if case == "sketched128":
        assert stats["sketch_k"] == 32


def test_chained_route_reports_honestly(references):
    """The counterpart of ``tests/test_global_morton.py::
    test_1dev_chained_route_reports_honestly``: owner_computes asked for
    is reported off, and the duplication is gauged."""
    X, kw, _ = references["blobs750", "device"]
    _l, _c, stats = sharded_dbscan(
        X, KDPartitioner(X, max_partitions=8), owner_computes=True,
        device="cpu", **kw)
    assert stats["owner_computes"] is False
    assert np.isfinite(stats["duplicated_work_factor"])
    assert stats["duplicated_work_factor"] > 1.0
    # Each partition's kernel passes, all run: counts, rounds, border.
    assert len(stats["partition_passes"]) == stats["n_shard_partitions"]
    assert min(stats["partition_passes"]) >= 2
    assert max(stats["partition_passes"]) == stats["kernel_passes"]


def _chain_data(n=256, k=2, step=0.09):
    """tests/test_convergence_budget.py's line of points threading every
    KD partition: one cluster chained across all 8."""
    pts = np.zeros((n, k))
    pts[:, 0] = np.arange(n, dtype=np.float64) * step
    return pts


@pytest.mark.parametrize("rounds", [1, 0])
def test_merge_rounds_ladder_matches_jax(rounds):
    """At merge_rounds=1 both retry at 4x and converge to the same
    labels; at 0 both retry at 1 and raise 'did not converge'.  Both
    count the rung's retries and giveups alike."""
    from pypardis_tpu import obs as jax_obs
    from pypardis_tpu_torch import obs

    X = _chain_data()
    kw = dict(eps=0.2, min_samples=2, block=64, merge="device",
              merge_rounds=rounds)
    recs = {"jax": jax_obs.RunRecorder(), "port": obs.RunRecorder()}

    def port():
        with obs.use_recorder(recs["port"]):
            return sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                                  device="cpu", **kw)

    def ladder_counters():
        return [{k: v for k, v in recs[n].metrics.as_dict()[
            "counters"].items() if k.startswith("retry.")}
            for n in ("jax", "port")]

    try:
        with jax_obs.use_recorder(recs["jax"]):
            ref = _jax(X, kw)
    except RuntimeError as e:
        assert "did not converge" in str(e)
        with pytest.raises(RuntimeError, match="did not converge"):
            port()
        j, p = ladder_counters()
        assert j == p == {"retry.merge_rounds.attempts": 1,
                          "retry.merge_rounds.giveups": 1}
        return
    lab, core, stats = port()
    j, p = ladder_counters()
    assert j == p == {"retry.merge_rounds.attempts": 1}
    np.testing.assert_array_equal(lab, ref[0])
    np.testing.assert_array_equal(core, ref[1])
    assert stats["merge_rounds"] == ref[2]["merge_rounds"]
    assert lab.max() == lab.min() >= 0
    assert stats["merge_host_syncs"] > stats["merge_rounds"]


def test_tiny_pair_budget_reruns_at_the_exact_total():
    X, kw = _separated16()
    part = KDPartitioner(X, max_partitions=8)
    ref = sharded_dbscan(X, part, device="cpu", **kw)
    lab, core, stats = sharded_dbscan(X, part, device="cpu", pair_budget=1,
                                      **kw)
    np.testing.assert_array_equal(lab, ref[0])
    np.testing.assert_array_equal(core, ref[1])
    p = stats["n_shard_partitions"]
    # The first attempt's partitions ran no pass; the rerun ran them all.
    assert stats["partition_passes"][:p] == [0] * p
    assert stats["partition_passes"][p:] == ref[2]["partition_passes"]
    assert stats["live_pairs"] == ref[2]["live_pairs"]


def test_build_shards_is_the_jax_layout_transposed():
    """Owned and halo slabs hold the JAX package's float32 bits in the
    port's (P, k, cap) layout; masks, gids and stats equal."""
    X, kw = _separated16()
    jarr, jst = jax_sharded.build_shards(
        X, JaxKD(X, max_partitions=8), kw["eps"], 1, kw["block"])
    tarr, tst = sharded.build_shards(
        X, KDPartitioner(X, max_partitions=8), kw["eps"], 1, kw["block"])
    for i in (0, 3):
        assert np.array_equal(
            tarr[i].view(np.int32),
            np.ascontiguousarray(jarr[i].transpose(0, 2, 1)).view(np.int32))
    for i in (1, 2, 4, 5):
        np.testing.assert_array_equal(tarr[i], jarr[i])
    assert tst == jst


def test_partition_slabs_are_the_jax_layout():
    """The slab the route clusters for each partition: the JAX package's
    owned slab, then its halo slab, in the port's (k, cap + hcap)
    layout with the same float32 bits; the rows past the JAX halo
    capacity are empty with gid n."""
    X, kw = _separated16()
    jarr, _jst = jax_sharded.build_shards(
        X, JaxKD(X, max_partitions=8), kw["eps"], 1, kw["block"])
    layout, _st = sharded._chained_layout(
        X, KDPartitioner(X, max_partitions=8), kw["eps"], kw["block"],
        "high")
    cap, hcap = layout["cap"], layout["hcap"]
    jcap, jhcap = jarr[0].shape[1], jarr[3].shape[1]
    assert cap == jcap and hcap >= jhcap
    rows = cap + hcap
    pts = np.empty((X.shape[1], rows), np.float32)
    msk = np.empty(rows, bool)
    gid = np.empty(rows, np.int32)
    for p in range(len(layout["part_idx"])):
        sharded._partition_slab(pts, msk, gid, X, layout, p)
        want = np.concatenate([jarr[0][p], jarr[3][p]]).T
        assert np.array_equal(pts[:, :cap + jhcap].view(np.int32),
                              np.ascontiguousarray(want).view(np.int32))
        np.testing.assert_array_equal(
            msk[:cap + jhcap], np.concatenate([jarr[1][p], jarr[4][p]]))
        np.testing.assert_array_equal(
            gid[:cap + jhcap], np.concatenate([jarr[2][p], jarr[5][p]]))
        assert not msk[cap + jhcap:].any()
        assert (gid[cap + jhcap:] == len(X)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_occurrences_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 500
    home = np.where(rng.random(n) < 0.2, -1,
                    rng.integers(0, n, size=n)).astype(np.int32)
    core = rng.random(n) < 0.6
    occ_gid = rng.integers(-2, n + 3, size=900).astype(np.int32)
    occ_lab = np.where(rng.random(900) < 0.3, -1,
                       rng.integers(0, n, size=900)).astype(np.int32)
    got, got_map = t_merge.merge_occurrences(home, core, occ_gid, occ_lab)
    want, want_map = jax_merge.merge_occurrences(home, core, occ_gid,
                                                 occ_lab)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got_map == want_map


def test_relabel_i32_fill_rule():
    from pypardis_tpu._native import relabel_i32 as jax_relabel

    labels = np.array([-3, -1, 0, 2, 4, 5, 9], np.int32)
    lut = np.array([7, -1, 3, 3, 1], np.int32)
    for fill in (-1, 11):
        np.testing.assert_array_equal(
            t_merge.relabel_i32(labels, lut, fill=fill),
            jax_relabel(labels, lut, fill=fill))


class _InFlight:
    """A copy that is still running until something waits on it."""

    def __init__(self, p):
        self.p, self.done = p, False

    def synchronize(self):
        self.done = True


def test_slab_ring_rewrites_a_buffer_only_after_its_copy():
    """The overlap's rotation rule: slot p % 2 is handed out for
    partition p only once the copy that read it for partition p - 2 has
    finished (the JAX package's tests/test_overlap.py holds its own
    rotation to the same rule)."""
    ring = sharded._SlabRing(3, 16, "cpu")
    copies = []

    def ship(p):
        ev = _InFlight(p)
        ring.pending[p % 2] = ev
        copies.append(ev)
        return None, ev

    ring.ship = ship
    for p in range(7):
        pts, msk, gid = ring.acquire(p)
        assert all(c.done for c in copies if c.p % 2 == p % 2)
        pts.fill(p)
        ring.ship(p)
    assert [c.done for c in copies] == [True] * 5 + [False] * 2


def test_slab_ring_copies_are_private():
    """On the CPU a shipped slab is a copy: refilling the buffer leaves
    it as it was."""
    ring = sharded._SlabRing(2, 8, "cpu")
    pts, _msk, _gid = ring.acquire(0)
    pts.fill(1.0)
    (t_pts, _m, _g), ev = ring.ship(0)
    assert ev is None
    ring.acquire(2)[0].fill(5.0)
    assert bool((t_pts == 1.0).all())


@pytest.mark.parametrize("overlap", [True, False])
def test_the_next_slab_is_built_beside_the_card(monkeypatch, overlap):
    """Partition p + 1's slab is built while the card clusters partition
    p, and ``overlap`` (accepted for the JAX signature) changes
    nothing: the same builds beside the card, the same labels."""
    X, kw = _separated16()
    part = KDPartitioner(X, max_partitions=8)
    # A cold fit (builds every slab): no earlier fit's slabs cached.
    port_staging.clear()
    state = {"clustering": False, "beside": 0, "built": 0}
    build, cluster = sharded._partition_slab, sharded._cluster_partition

    def counted_build(*a, **k):
        # Watch for a partition being clustered while this build runs
        # (a while: the main thread may not have reached it yet).
        t = time.perf_counter()
        while not state["clustering"] and time.perf_counter() - t < 0.5:
            time.sleep(0.002)
        state["beside"] += state["clustering"]
        state["built"] += 1
        return build(*a, **k)

    def marked_cluster(*a, **k):
        state["clustering"] = True
        try:
            time.sleep(0.05)
            return cluster(*a, **k)
        finally:
            state["clustering"] = False

    monkeypatch.setattr(sharded, "_partition_slab", counted_build)
    monkeypatch.setattr(sharded, "_cluster_partition", marked_cluster)
    lab, core, stats = sharded_dbscan(X, part, overlap=overlap,
                                      device="cpu", **kw)
    monkeypatch.undo()
    ref = sharded_dbscan(X, part, device="cpu", **kw)
    np.testing.assert_array_equal(lab, ref[0])
    np.testing.assert_array_equal(core, ref[1])
    p = stats["n_shard_partitions"]
    assert state["built"] == p
    # Every build but the first starts while a partition is clustered.
    assert state["beside"] == p - 1
    assert 0.0 < stats["overlap_efficiency"] <= 1.0


def test_runs_on_the_card_by_default(monkeypatch):
    """No CUDA and no device='cpu': the call raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, kw = _blobs750()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_dbscan(X, KDPartitioner(X, max_partitions=8), **kw)


@pytest.mark.parametrize("knob", [dict(mode="global_morton",
                                       metric="cityblock")])
def test_refused_knobs_name_their_roadmap_item(knob):
    X, kw = _blobs750()
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                       device="cpu", **kw, **knob)


@pytest.mark.parametrize("knob", [
    dict(halo="ring"), dict(halo="ring", stream=True), dict(hcap=256),
    dict(mesh=Mesh(["cpu"] * 4), halo="ring"),
    dict(mesh=Mesh(["cpu"] * 2), halo="ring", stream=True),
])
def test_ring_knobs_run(knob):
    """The ring (a mesh of None runs it on one CPU device), its
    streaming build and ``hcap`` (unread under the host halo) run, each
    to the chained route's labels."""
    X, kw = _blobs750()
    part = KDPartitioner(X, max_partitions=8)
    want = sharded_dbscan(X, part, device="cpu", **kw)
    got = sharded_dbscan(X, part, device="cpu", **kw, **knob)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    ring = knob.get("halo") == "ring"
    assert got[2].get("halo_exchange") == ("ring" if ring else None)
    if ring and "mesh" not in knob:
        # One device, eight partitions: owner-computes off (the JAX rule).
        assert got[2]["owner_computes"] is False


def test_stream_needs_the_ring():
    X, kw = _blobs750()
    for mesh in (None, Mesh(["cpu"] * 2)):
        with pytest.raises(ValueError, match="requires halo='ring'"):
            sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                           device="cpu", mesh=mesh, stream=True, **kw)


@pytest.mark.parametrize("bad", [
    dict(merge="both"), dict(mode="ring"), dict(halo="device"),
])
def test_bad_arguments_raise(bad):
    X, kw = _blobs750()
    with pytest.raises(ValueError):
        sharded_dbscan(X, KDPartitioner(X, max_partitions=8),
                       device="cpu", **kw, **bad)


def test_one_partition_takes_the_stacked_route():
    """One partition: the per-partition loop with nothing to overlap
    (so no overlap_efficiency), the same labels as the single-device
    fit's roots canonicalized."""
    from pypardis_tpu_torch import DBSCAN

    X, kw = _blobs750()
    lab, core, stats = sharded_dbscan(
        X, KDPartitioner(X, max_partitions=1), device="cpu", **kw)
    assert "overlap_efficiency" not in stats
    assert stats["halo_factor"] == 0.0
    fit = DBSCAN(eps=kw["eps"], min_samples=kw["min_samples"],
                 block=kw["block"], device="cpu").fit(X)
    np.testing.assert_array_equal(core, fit.core_sample_mask_)
    # The same clustering, numbered otherwise: a bijection of labels.
    np.testing.assert_array_equal(lab < 0, fit.labels_ < 0)
    pairs = np.unique(np.stack([lab, fit.labels_]), axis=1)
    assert pairs.shape[1] == len(np.unique(lab)) == len(
        np.unique(fit.labels_))
