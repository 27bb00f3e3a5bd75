"""The KD route's fused multi-device step on a mesh,
``pypardis_tpu_torch.parallel.sharded_dbscan(..., mesh=Mesh(["cpu"] *
P))``, held against the JAX package's ``sharded_dbscan(...,
mesh=default_mesh(P))`` over the conftest's eight faked CPU devices
(``tests/test_sharded.py``'s geometry: 4,000 x 3 blobs as float32, eps
0.4, min_samples 5, block 64, eight KD partitions): labels, core flags,
``merge_rounds`` and every non-timing stat at P = 4 and 8 under both
merges with owner-computes on and off, bitwise; the port's chained
route's labels; the three precisions; a 128-D case through the plain
B3/B4; cityblock.  The mesh, the layout and the refusals are in
``tests/test_torch_mesh.py``, the ladders and ``DBSCAN(mesh=...)`` in
``tests/test_torch_mesh_fits.py``.  (Kept to few tests: xdist starts
the files with the most tests first, and the JAX fused step's compiles
beside ``tests/test_analysis.py`` push its lint-runtime gate past 10 s.)

The one difference, as on the global-Morton route
(``tests/test_torch_global_morton.py``): under ``precision="mixed"``
the JAX CPU pass tests its band on the exact d^2 and the port's B1 on
the bf16 fast d^2, so ``band_pairs`` differs by the pairs that straddle
a band edge (622 of 46,676 on the blobs at P = 4) and is held within
2 %; ``rescored_tiles`` and everything else bitwise."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import benchdata
from pypardis_tpu.parallel import default_mesh as jax_default_mesh
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.parallel import staging
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan
from pypardis_tpu_torch.partition import KDPartitioner
from pypardis_tpu_torch.utils import faults

KW = dict(eps=0.4, min_samples=5, block=64)
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
        **kw, **extra)


def _port(X, P, kw=KW, parts=8, **extra):
    return sharded_dbscan(X, KDPartitioner(X, max_partitions=parts),
                          mesh=Mesh(["cpu"] * P), device="cpu", **kw,
                          **extra)


def _same_result(got, want, band_rtol=0.0):
    lab, core, stats = got
    j_lab, j_core, j_stats = want
    assert lab.dtype == j_lab.dtype and core.dtype == j_core.dtype
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    assert set(stats) - PORT_ONLY == set(j_stats)
    for key in SAME_STATS:
        assert (key in stats) == (key in j_stats), key
        if key not in j_stats:
            continue
        if key == "band_pairs" and band_rtol:
            assert abs(stats[key] - j_stats[key]) <= band_rtol * max(
                j_stats[key], 1), key
        else:
            assert stats[key] == j_stats[key], key


# -- the fused step against JAX ----------------------------------------------


@pytest.fixture(scope="module")
def references(blobs):
    """Per (P, merge, owner_computes): the JAX fused step's result."""
    return {
        (P, merge, oc): _jax(blobs, P, merge=merge, owner_computes=oc)
        for P in (4, 8) for merge in ("device", "host")
        for oc in (True, False)
    }


@pytest.mark.parametrize("oc", [True, False])
@pytest.mark.parametrize("merge", ["device", "host"])
@pytest.mark.parametrize("P", [4, 8])
def test_fused_step_matches_jax(blobs, references, P, merge, oc):
    got = _port(blobs, P, merge=merge, owner_computes=oc)
    _same_result(got, references[P, merge, oc])
    stats = got[2]
    assert stats["owner_computes"] is oc
    assert stats["merge"] == merge
    assert len(np.unique(got[0][got[0] >= 0])) > 1
    # Each partition slot's passes, once (no ladder rung ran).
    assert len(stats["partition_passes"]) == stats["n_shard_partitions"]
    assert max(stats["partition_passes"]) == stats["kernel_passes"]
    assert set(stats["stage_s"]) >= {"halo_sets", "slab_build", "ship",
                                     "device", "loop", "merge"}
    if merge == "device":
        assert stats["merge_host_syncs"] > stats["merge_rounds"]
    if oc:
        # Owner-computes clusters owned slots only.
        assert stats["duplicated_work_factor"] == (
            stats["n_shard_partitions"] * stats["owned_cap"] / len(blobs))


def test_fused_labels_equal_the_chained_route(blobs, references):
    """Both sides of the JAX identity (its tests/test_sharded.py::
    test_single_device_mesh_chained_matches_mesh8): the port's chained
    route on a 1-device mesh gives the fused step's labels."""
    lab, core, stats = sharded_dbscan(
        blobs, KDPartitioner(blobs, max_partitions=8), mesh=Mesh(["cpu"]),
        device="cpu", **KW)
    assert stats["owner_computes"] is False
    for key in ((8, "device", True), (4, "host", False)):
        np.testing.assert_array_equal(lab, references[key][0])
        np.testing.assert_array_equal(core, references[key][1])


def _lattice():
    """A 3-D lattice at spacing 1 with eps sqrt(2.5): every pair's d^2
    is an integer, far from eps^2 in any precision."""
    g = np.arange(12, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g[:6], indexing="ij"),
                   -1).reshape(-1, 3)
    keep = np.random.default_rng(1).random(len(pts)) < 0.6
    return np.ascontiguousarray(pts[keep])


@pytest.mark.parametrize("precision", ["high", "mixed", "default"])
def test_precisions_match_jax(blobs, precision):
    """``"high"`` and ``"mixed"`` on the blobs (``"mixed"``'s labels are
    ``"high"``'s; its band pairs within 2 %), ``"default"`` on a lattice
    whose pairs all lie far from eps (the JAX package's CPU pass is
    float32 where the port's is bf16)."""
    if precision == "default":
        X, kw = _lattice(), dict(eps=float(np.sqrt(2.5)), min_samples=6,
                                 block=64)
    else:
        X, kw = blobs, KW
    want = _jax(X, 4, kw=kw, merge="host", precision=precision)
    got = _port(X, 4, kw=kw, merge="host", precision=precision)
    _same_result(got, want, band_rtol=2e-2 if precision == "mixed" else 0)
    if precision == "mixed":
        assert got[2]["band_pairs"] > 0
        np.testing.assert_array_equal(
            got[0], _port(X, 4, kw=kw, merge="host")[0])


def test_sketched_shards_run_the_plain_b3_b4():
    """128 axes: the sketch resolves on (k = 32), so each partition's
    passes are B3 and B4's plain versions; labels and stats the JAX
    step's."""
    X, _, _ = benchdata.make_separated_blob_data(
        1200, 128, n_centers=6, min_sep=30.0, spread=30.0, seed=2)
    kw = dict(eps=9.0, min_samples=10, block=128)
    for oc in (True, False):
        want = _jax(X, 4, kw=kw, merge="device", owner_computes=oc)
        got = _port(X, 4, kw=kw, merge="device", owner_computes=oc)
        _same_result(got, want)
        assert got[2]["sketch_k"] == 32


def test_cityblock_matches_jax(blobs):
    kw = dict(eps=0.5, min_samples=5, block=64)
    want = _jax(blobs, 4, kw=kw, metric="cityblock", merge="host")
    _same_result(_port(blobs, 4, kw=kw, metric="cityblock", merge="host"),
                 want)
