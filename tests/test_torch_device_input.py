"""The device-input route, ``pypardis_tpu_torch.parallel.device_input``
and ``sharded.sharded_dbscan_device`` (a tensor already on the mesh's
device type), held against ``pypardis_tpu/parallel/device_input.py``
and the JAX ``sharded_dbscan_device`` on the same numpy inputs
(``tests/test_device_input.py``'s geometry: 4,000 x 3 float32 blobs,
eps 0.4, min_samples 5, block 64) over the conftest's eight faked CPU
devices, with ``device="cpu"``.

Tolerance: none, except one stated bound.  ``tree_arrays``,
``device_route``'s ``pid`` and the partition counts are bitwise the JAX
package's; so are ``device_owned_layout``'s slabs, masks, gids and
boxes on a lattice whose mean every summation order computes exactly.
On general data the layout recentres on a float32 mean whose
summation order differs between XLA and torch: the slab coordinates
(matched by gid) then differ by at most ``COORD_ULPS`` float32 ULPs of
the data's largest magnitude, and the Morton order within a partition
may differ where a point sits within those ULPs of a quantization step
(ROADMAP §C, facts about the reference).  The route's labels, core
flags, ``pid`` and stats equal the JAX route's on blobs with no pair
near eps."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import jax.numpy as jnp
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh as jax_default_mesh
from pypardis_tpu.parallel import device_input as jax_di
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan_device
from pypardis_tpu_torch.parallel import device_input as di

KW = dict(eps=0.4, min_samples=5, block=64)
# The slab coordinates' bound against the JAX layout on general data.
COORD_ULPS = 4
SAME_STATS = (
    "owned_cap", "n_shard_partitions", "pad_waste", "partition_sizes",
    "input", "halo_exchange", "halo_cap", "halo_bytes", "merge",
    "merge_rounds", "merge_converged", "owner_computes",
    "duplicated_work_factor", "live_pairs", "kernel_passes", "band_pairs",
    "rescored_tiles", "kernel_block", "kernel_tiles", "sketch_k",
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(n_samples=4000, centers=10, n_features=3,
                      cluster_std=0.3, random_state=5)
    return X.astype(np.float32)


def _lattice(n=2048, side=16, seed=0):
    """``n`` (a power of two) distinct points of an integer lattice: the
    float32 sum of every column is exact in any order and the mean
    ``sum / n`` too, so XLA and torch recentre alike."""
    g = np.arange(side, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    sel = np.random.default_rng(seed).choice(len(pts), n, replace=False)
    return np.ascontiguousarray(pts[sel])


def _routed(X, parts):
    tree = JaxKD(X, max_partitions=parts).tree
    want = jax_di.device_route(jnp.asarray(X),
                               *map(jnp.asarray, jax_di.tree_arrays(tree)))
    got = di.device_route(torch.from_numpy(X), *di.tree_arrays(tree))
    return tree, got, np.asarray(want)


@pytest.mark.parametrize("parts", [1, 5, 8])
def test_route_and_counts_match_jax(blobs, parts):
    tree, pid, want = _routed(blobs, parts)
    for a, b in zip(di.tree_arrays(tree), jax_di.tree_arrays(tree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert pid.dtype == torch.int32
    np.testing.assert_array_equal(pid.numpy(), want)
    p_total = max(parts, 4)
    counts = di.device_partition_counts(pid, p_total=p_total)
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jax_di.device_partition_counts(
            jnp.asarray(want), p_total=p_total)))
    # The routed points are the host KD replay's partition sizes.
    part = JaxKD(blobs, max_partitions=parts)
    assert sorted(counts.tolist()[:len(part.partitions)]) == sorted(
        len(v) for v in part.partitions.values())


def _layouts(X, parts, p_total):
    _tree, pid, want_pid = _routed(X, parts)
    counts = di.device_partition_counts(pid, p_total=p_total)
    cap = -(-int(counts.max()) // 64) * 64
    got = di.device_owned_layout(torch.from_numpy(X), pid, counts,
                                 p_total=p_total, cap=cap)
    want = jax_di.device_owned_layout(
        jnp.asarray(X), jnp.asarray(want_pid),
        jax_di.device_partition_counts(jnp.asarray(want_pid),
                                       p_total=p_total),
        p_total=p_total, cap=cap)
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("parts,p_total", [(8, 8), (6, 8)])
def test_layout_is_bitwise_on_an_exact_mean(parts, p_total):
    """On the lattice the recentring is exact on both sides: slabs (the
    port's ``(P, k, cap)`` orientation), masks, gids and the tight
    boxes (inverted in empty slots) are the JAX layout's bits."""
    got, want = _layouts(_lattice(), parts, p_total)
    assert got[0].tobytes() == np.ascontiguousarray(
        want[0].transpose(0, 2, 1)).tobytes()
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (got[3][parts:] == np.float32(3e38)).all()
    assert (got[4][parts:] == np.float32(-3e38)).all()


def test_layout_within_the_ulp_bound_on_blobs(blobs):
    """On general data the float32 means differ in their last bits: each
    partition holds the same points and each point's recentred row is
    within ``COORD_ULPS`` ULPs of the data's largest magnitude."""
    (o, m, g, lo, hi), (jo, jm, jg, jlo, jhi) = _layouts(blobs, 8, 8)
    bound = COORD_ULPS * np.spacing(np.float32(np.abs(blobs).max()))
    np.testing.assert_array_equal(m.sum(1), jm.sum(1))
    for p in range(8):
        ours = dict(zip(g[p][m[p]].tolist(), o[p].T[m[p]]))
        theirs = dict(zip(jg[p][jm[p]].tolist(), jo[p][jm[p]]))
        assert ours.keys() == theirs.keys()
        diff = np.stack([ours[i] - theirs[i] for i in ours])
        assert np.abs(diff).max() <= bound
    assert np.abs(lo - jlo).max() <= bound
    assert np.abs(hi - jhi).max() <= bound


@pytest.mark.parametrize("P,merge", [(4, "device"), (8, "host")])
def test_device_route_matches_jax(blobs, P, merge):
    want = jax_sharded.sharded_dbscan_device(
        jnp.asarray(blobs), mesh=jax_default_mesh(P), merge=merge, **KW)
    got = sharded_dbscan_device(torch.from_numpy(blobs),
                                mesh=Mesh(["cpu"] * P), device="cpu",
                                merge=merge, **KW)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[4].dtype == torch.int32
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[3].tree == want[3].tree
    for key in SAME_STATS:
        assert got[2].get(key) == want[2].get(key), key
    assert got[2]["input"] == "device"


def test_subsampled_route_fetches_no_coordinates(blobs, monkeypatch):
    """A subsample of 1,000 rows plans the tree: the only floating
    tensor that reaches numpy is that subsample, never the ``(N, k)``
    coordinates, and the labels equal the JAX route's at the same
    subsample."""
    fetched = []
    to_numpy = torch.Tensor.numpy
    to_array = torch.Tensor.__array__

    def spy_numpy(self, *a, **k):
        if self.is_floating_point():
            fetched.append(tuple(self.shape))
        return to_numpy(self, *a, **k)

    def spy_array(self, *a, **k):
        if self.is_floating_point():
            fetched.append(tuple(self.shape))
        return to_array(self, *a, **k)

    X = torch.from_numpy(blobs)
    monkeypatch.setattr(torch.Tensor, "numpy", spy_numpy)
    monkeypatch.setattr(torch.Tensor, "__array__", spy_array)
    got = sharded_dbscan_device(X, mesh=Mesh(["cpu"] * 4), device="cpu",
                                sample_size=1000, **KW)
    monkeypatch.undo()
    assert fetched == [(1000, 3)]
    want = jax_sharded.sharded_dbscan_device(
        jnp.asarray(blobs), mesh=jax_default_mesh(4), sample_size=1000,
        **KW)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_dbscan_fit_of_a_tensor_on_a_mesh(blobs):
    """``DBSCAN(mesh=...).fit(tensor)`` takes the device route: labels,
    the routed partitions, the split-plane boxes, ``cluster_dict`` and
    the lazily computed ``neighbors`` equal the JAX model's."""
    got = DBSCAN(mesh=Mesh(["cpu"] * 8), device="cpu", **KW).fit(
        torch.from_numpy(blobs))
    want = JaxDBSCAN(mesh=jax_default_mesh(8), **KW).fit(jnp.asarray(blobs))
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_array_equal(got.core_sample_mask_,
                                  want.core_sample_mask_)
    assert got.metrics_["input"] == "device"
    assert got.metrics_["n_partitions"] == want.metrics_["n_partitions"]
    np.testing.assert_array_equal(got.partitioner_.result,
                                  want.partitioner_.result)
    for label, idx in want.partitioner_.partitions.items():
        np.testing.assert_array_equal(got.partitioner_.partitions[label],
                                      idx)
    for label, box in want.bounding_boxes.items():
        np.testing.assert_array_equal(got.bounding_boxes[label].lower,
                                      box.lower)
        np.testing.assert_array_equal(got.bounding_boxes[label].upper,
                                      box.upper)
    assert got.cluster_dict == want.cluster_dict
    assert got._neighbors is None and got._neighbors_lazy
    assert sorted(got.neighbors) == sorted(want.neighbors)
    for label, idx in want.neighbors.items():
        np.testing.assert_array_equal(got.neighbors[label], idx)
    # A refit on the single route sets the surface directly.
    got.fit(blobs[:6])
    assert not got._neighbors_lazy
    assert list(got.neighbors) == [0]
    np.testing.assert_array_equal(got.neighbors[0], np.arange(6))


def test_neighbors_need_the_data():
    """Clearing ``data`` after a device fit disables the lazy surface,
    as in JAX."""
    X = _lattice(512)
    m = DBSCAN(mesh=Mesh(["cpu"] * 4), device="cpu", eps=1.5,
               min_samples=4, block=64).fit(torch.from_numpy(X))
    m.data = None
    with pytest.raises(RuntimeError, match="model.data was cleared"):
        _ = m.neighbors
