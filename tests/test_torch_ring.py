"""The KD route's ring halo exchange,
``pypardis_tpu_torch.parallel.sharded_dbscan(..., halo="ring")``, held
against the JAX package's ``sharded_dbscan(..., halo="ring")`` over the
conftest's eight faked CPU devices (``tests/test_halo_ring.py``'s
geometry: 4,000 x 3 blobs as float32, eps 0.4, min_samples 5, block 64).

Tolerance: none.  The owned layout and the widened boxes
(``build_owned_shards``), the exchange's ``halo``, ``halo_mask``,
``halo_gid`` and ``overflow`` (``ring_exchange_step``, overflowing
capacities included) are bitwise the JAX package's; the route's labels,
core flags, ``merge_rounds``, ``halo_cap``, ``halo_bytes``,
``partition_sizes``, the pair stats and the ``ring.hcap`` retry counters
equal the JAX route's, under both merges, owner-computes on and off,
with more partitions than devices and fewer.  (At most 16 tests here
build a JAX reference: xdist starts the files with the most tests first,
and the JAX step's compiles beside ``tests/test_analysis.py`` push its
lint-runtime gate.)  The streaming build is held in
``tests/test_torch_stream.py``, the device-input route in
``tests/test_torch_device_input.py``."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import benchdata
from pypardis_tpu import obs as jax_obs
from pypardis_tpu.parallel import default_mesh as jax_default_mesh
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.parallel import staging
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch import obs
from pypardis_tpu_torch.parallel import Mesh, sharded, sharded_dbscan
from pypardis_tpu_torch.partition import KDPartitioner
from pypardis_tpu_torch.utils import faults

KW = dict(eps=0.4, min_samples=5, block=64)
# Stats the JAX ring route and the port must report alike.
SAME_STATS = (
    "owned_cap", "n_shard_partitions", "pad_waste", "partition_sizes",
    "halo_exchange", "halo_cap", "halo_bytes", "merge", "merge_rounds",
    "merge_converged", "owner_computes", "duplicated_work_factor",
    "live_pairs", "kernel_passes", "band_pairs", "rescored_tiles",
    "kernel_block", "kernel_tiles", "sketch_k", "input",
)
PORT_ONLY = {"stage_s", "partition_passes", "merge_host_syncs"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(n_samples=4000, centers=10, n_features=3,
                      cluster_std=0.3, random_state=5)
    return X.astype(np.float32)


def _jax(X, P, kw=KW, parts=8, **extra):
    staging.clear()
    return jax_sharded.sharded_dbscan(
        X, JaxKD(X, max_partitions=parts), mesh=jax_default_mesh(P),
        halo="ring", **kw, **extra)


def _port(X, P, kw=KW, parts=8, **extra):
    return sharded_dbscan(X, KDPartitioner(X, max_partitions=parts),
                          mesh=Mesh(["cpu"] * P), device="cpu",
                          halo="ring", **kw, **extra)


def _same_result(got, want):
    lab, core, stats = got
    j_lab, j_core, j_stats = want
    assert lab.dtype == j_lab.dtype and core.dtype == j_core.dtype
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    assert set(stats) - PORT_ONLY == set(j_stats)
    for key in SAME_STATS:
        assert (key in stats) == (key in j_stats), key
        if key in j_stats:
            assert stats[key] == j_stats[key], key


def _retries(rec):
    return {k: v for k, v in rec.metrics.as_dict()["counters"].items()
            if k.startswith("retry.")}


# -- the layout and the exchange ---------------------------------------------


def test_owned_layout_and_boxes_match_jax(blobs):
    """``build_owned_shards``: the owned slabs (the port's ``(P, k,
    cap)`` orientation of the same float32 bits), masks, gids, the
    widened boxes with their 4-ULP margin and the padding slots'
    inverted boxes, and the stats, at 6 partitions over 4 shards."""
    part, jpart = KDPartitioner(blobs, 6), JaxKD(blobs, max_partitions=6)
    arrays, lo, hi, labels, stats = sharded.build_owned_shards(
        blobs, part, 0.4, 4, 64)
    j_arrays, j_lo, j_hi, j_labels, j_stats = (
        jax_sharded.build_owned_shards(blobs, jpart, 0.4, 4, 64))
    assert stats == j_stats and labels == j_labels
    assert arrays[0].tobytes() == np.ascontiguousarray(
        j_arrays[0].transpose(0, 2, 1)).tobytes()
    for a, b in zip(arrays[1:], j_arrays[1:]):
        np.testing.assert_array_equal(a, b)
    assert lo.tobytes() == j_lo.tobytes() and hi.tobytes() == j_hi.tobytes()
    assert (lo[6:] == np.float32(3e38)).all()
    assert (hi[6:] == np.float32(-3e38)).all()


def _exchange_inputs(X, parts, P):
    part, jpart = KDPartitioner(X, parts), JaxKD(X, max_partitions=parts)
    arrays, lo, hi, _l, _s = sharded.build_owned_shards(X, part, 0.4, P, 64)
    j_args = jax_sharded.build_owned_shards(X, jpart, 0.4, P, 64)
    mesh = Mesh(["cpu"] * P)
    shards = sharded._with_boxes(sharded._ship_owned(arrays, mesh), lo, hi,
                                 mesh)
    return shards, mesh, j_args


@pytest.mark.parametrize("parts,P,hcap", [
    (4, 4, 1024),   # L = 1: no local round
    (8, 4, 1024),   # L = 2: the local round runs
    (16, 8, 1024),  # L = 2 on 8 shards
    (8, 4, 128),    # a capacity that overflows
])
def test_exchange_matches_jax_bitwise(blobs, parts, P, hcap):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    shards, mesh, (j_arrays, j_lo, j_hi, _l, _s) = _exchange_inputs(
        blobs, parts, P)
    jmesh = jax_default_mesh(P)
    sh = NamedSharding(jmesh, PartitionSpec(jmesh.axis_names[0]))
    j_args = [jax.device_put(a, sh) for a in (*j_arrays, j_lo, j_hi)]
    want = [np.asarray(a) for a in jax_sharded.ring_exchange_step(
        *j_args, mesh=jmesh, axis=jmesh.axis_names[0], hcap=hcap)]
    got = sharded.ring_exchange_step(shards, mesh=mesh, hcap=hcap)
    halo, hmask, hgid, over = (torch.cat([g[i] for g in got]).numpy()
                               for i in range(4))
    assert halo.tobytes() == np.ascontiguousarray(
        want[0].transpose(0, 2, 1)).tobytes()
    np.testing.assert_array_equal(hmask, want[1])
    np.testing.assert_array_equal(hgid, want[2])
    assert over.dtype == np.int32
    np.testing.assert_array_equal(over, want[3])
    assert (over.sum() > 0) == (hcap == 128)
    # Accepted slots are a prefix; empty ones hold zeros and INT32_MAX.
    assert (np.diff(hmask.astype(np.int8), axis=1) <= 0).all()
    assert (hgid[~hmask] == 2**31 - 1).all()
    assert not halo.transpose(0, 2, 1)[~hmask].any()


def test_compact_merge_keeps_the_jax_order():
    """Rows already held stay; new valid rows follow in arrival order up
    to the capacity; ``dropped`` counts the rest."""
    from pypardis_tpu_torch.parallel.halo import EMPTY_GID, _compact_merge

    hcap = 6
    halo = torch.zeros((2, hcap))
    halo[:, :2] = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    hmask = torch.tensor([True, True, False, False, False, False])
    hgid = torch.tensor([7, 8] + [EMPTY_GID] * 4, dtype=torch.int32)
    pts = torch.arange(12, dtype=torch.float32).reshape(2, 6) + 10
    valid = torch.tensor([False, True, True, False, True, True])
    gid = torch.arange(100, 106, dtype=torch.int32)
    h, m, g, dropped = _compact_merge(halo, hmask, hgid, pts, valid, gid)
    assert g.tolist() == [7, 8, 101, 102, 104, 105]
    assert m.all() and int(dropped) == 0
    assert h[0].tolist() == [1.0, 2.0, 11.0, 12.0, 14.0, 15.0]
    h2, m2, g2, dropped = _compact_merge(h[:, :5], m[:5], g[:5], pts,
                                         valid, gid)
    assert int(dropped) == 4 and g2.tolist() == [7, 8, 101, 102, 104]


# -- the route ---------------------------------------------------------------


@pytest.mark.parametrize("P,parts,merge,oc", [
    (4, 8, "device", True),
    (4, 8, "host", False),
    (8, 8, "device", False),
    (8, 8, "host", True),
    (8, 4, "device", True),   # fewer partitions than devices
])
def test_ring_route_matches_jax(blobs, P, parts, merge, oc):
    want = _jax(blobs, P, parts=parts, merge=merge, owner_computes=oc)
    got = _port(blobs, P, parts=parts, merge=merge, owner_computes=oc)
    _same_result(got, want)
    stats = got[2]
    assert stats["halo_exchange"] == "ring" and "halo_factor" not in stats
    assert stats.get("merge", "device") == merge
    assert stats["owner_computes"] is oc
    assert set(stats["stage_s"]) >= {"slab_build", "ship", "exchange",
                                     "device", "loop", "merge"}
    assert len(np.unique(got[0][got[0] >= 0])) > 1


def test_one_device_ring_runs_owner_computes_off(blobs):
    """A 1-device mesh of eight partitions: only the local round runs
    and owner-computes is off (the JAX ``_oc_applies``), as in
    ``default_mesh(1)``."""
    want = _jax(blobs, 1, merge="device")
    got = _port(blobs, 1, merge="device")
    _same_result(got, want)
    assert got[2]["owner_computes"] is False


def test_ring_labels_equal_the_host_halo(blobs):
    """Both halo routes cluster alike (the JAX ``tests/test_halo_ring.py``
    pattern), on the port's side and against the JAX host halo."""
    staging.clear()
    want = jax_sharded.sharded_dbscan(
        blobs, JaxKD(blobs, max_partitions=8), mesh=jax_default_mesh(4),
        halo="host", **KW)
    for merge in ("device", "host"):
        ring = _port(blobs, 4, merge=merge)
        host = sharded_dbscan(blobs, KDPartitioner(blobs, 8),
                              mesh=Mesh(["cpu"] * 4), device="cpu",
                              merge=merge, **KW)
        for got in (ring, host):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


def test_sketched_ring_runs_the_plain_b3_b4():
    """128 axes (the sketch on, k = 32): each slab's passes are B3 and
    B4's plain versions; labels and stats the JAX ring route's."""
    X, _, _ = benchdata.make_separated_blob_data(
        1200, 128, n_centers=6, min_sep=30.0, spread=30.0, seed=2)
    kw = dict(eps=9.0, min_samples=10, block=128)
    want = _jax(X, 4, kw=kw, merge="device")
    got = _port(X, 4, kw=kw, merge="device")
    _same_result(got, want)
    assert got[2]["sketch_k"] == 32


# -- the ladders -------------------------------------------------------------


def test_hcap_ladder_counts_its_retries_as_jax(blobs):
    """From the default start (half the owned capacity, 384 slots here,
    where the largest halo holds 612 points) the buffer doubles until it
    holds: each overflow is a ``halo_overflow`` event and a ``ring.hcap``
    retry, counted alike, and only the attempt that held is
    clustered."""
    recs = {"jax": jax_obs.RunRecorder(), "port": obs.RunRecorder()}
    with jax_obs.use_recorder(recs["jax"]):
        want = _jax(blobs, 4, merge="device")
    clustered = []
    orig = sharded._mesh_cluster

    def spy(shards, *a, **k):
        clustered.append(shards[0][0][0].shape[1])
        return orig(shards, *a, **k)

    sharded._mesh_cluster, saved = spy, sharded._mesh_cluster
    try:
        with obs.use_recorder(recs["port"]):
            got = _port(blobs, 4, merge="device")
    finally:
        sharded._mesh_cluster = saved
    _same_result(got, want)
    retries = [_retries(recs[n]) for n in ("jax", "port")]
    assert retries[0] == retries[1] == {"retry.ring.hcap.attempts": 1}
    assert recs["port"].event_counts().get("halo_overflow") == 1
    cap = got[2]["owned_cap"]
    assert clustered == [cap + got[2]["halo_cap"]]
    assert got[2]["halo_cap"] == 2 * sharded.round_up(max(64, cap // 2), 64)


def test_explicit_hcap_runs_once_or_raises(blobs):
    """An explicit ``hcap`` is one attempt: large enough it gives the JAX
    result; too small it raises the JAX message and counts a giveup."""
    want = _jax(blobs, 4, merge="host", hcap=1500)
    got = _port(blobs, 4, merge="host", hcap=1500)
    _same_result(got, want)
    assert got[2]["halo_cap"] == 1536
    rec = obs.RunRecorder()
    with obs.use_recorder(rec), pytest.raises(
            RuntimeError,
            match=r"^ring halo buffer overflow at hcap=64; pass a larger "
                  r"hcap$"):
        _port(blobs, 4, hcap=10)
    counters = rec.metrics.as_dict()["counters"]
    assert counters.get("retry.ring.hcap.giveups") == 1
    assert "retry.ring.hcap.attempts" not in counters


def test_persistent_overflow_raises_after_four_attempts(blobs, monkeypatch):
    """Without an explicit ``hcap`` the fourth overflow gives up with the
    JAX message."""
    monkeypatch.setattr(
        sharded, "ring_halo_exchange_multi",
        lambda *a: [(None, None, None, torch.ones(2, dtype=torch.int32))
                    for _ in range(4)])
    cap_start = None
    with pytest.raises(RuntimeError,
                       match=r"^ring halo buffer overflow persisted up to "
                             r"hcap=(\d+)$") as err:
        _port(blobs, 4)
    cap_start = int(err.value.args[0].rsplit("=", 1)[1])
    part = KDPartitioner(blobs, 8)
    cap = sharded.round_up(max(len(p) for p in part.partitions.values()),
                           64)
    assert cap_start == 8 * sharded.round_up(max(64, cap // 2), 64)


def _line(n=256):
    X = np.zeros((n, 2))
    X[:, 0] = np.arange(n, dtype=np.float64) * 0.09
    return X


def test_merge_rounds_ladder_on_the_ring():
    """The counterpart of ``tests/test_convergence_budget.py::
    test_nonconvergence_ring_detected``: a line threading every
    partition converges at ``merge_rounds=1`` through the 4x retry, to
    the JAX labels, and ``merge_rounds=0`` raises."""
    X = _line()
    kw = dict(eps=0.2, min_samples=2, block=64)
    want = _jax(X, 8, kw=kw, merge="device")
    got = _port(X, 8, kw=kw, merge="device", merge_rounds=1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2]["merge_converged"] is True
    assert got[2]["merge_rounds"] > 1
    assert got[0].max() == got[0].min() >= 0
    with pytest.raises(RuntimeError, match="did not converge"):
        _port(X, 8, kw=kw, merge="device", merge_rounds=0)


def test_oom_in_the_ring_merge_finishes_on_the_host(blobs):
    rec = obs.RunRecorder()
    clean = _port(blobs, 4, merge="device")
    with obs.use_recorder(rec), faults.plan("sharded.execute:1=oom"):
        got = _port(blobs, 4, merge="device")
    assert got[2]["merge"] == "host"
    assert rec.event_counts().get("degraded", 0) >= 1
    np.testing.assert_array_equal(got[0], clean[0])
    np.testing.assert_array_equal(got[1], clean[1])
