"""The ring route's streaming build from a memmap,
``pypardis_tpu_torch.parallel.sharded.build_owned_shards_streaming`` and
``sharded_dbscan(..., halo="ring", stream=...)``, against the in-RAM
ring and the JAX package's streaming route (``tests/test_stream.py``'s
geometry: 4,000 x 3 float32 blobs in an ``.npy`` memmap, eps 0.4,
min_samples 5, block 128) over the conftest's eight faked CPU devices.

Tolerance: none.  The streamed slabs are bitwise the in-RAM layout's;
labels, core flags and stats equal the in-RAM ring's and the JAX
streaming route's (``stats["input"] == "stream"``); ``stream=True``
with the host halo raises the JAX ``ValueError``; the host merge spills
as in JAX; ``DBSCAN(mesh=...).fit(memmap)`` takes the stream."""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh as jax_default_mesh
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.parallel import staging
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import Mesh, sharded, sharded_dbscan
from pypardis_tpu_torch.partition import KDPartitioner

KW = dict(eps=0.4, min_samples=5, block=128)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mm_blobs(tmp_path_factory):
    X, _ = make_blobs(n_samples=4000, centers=8, n_features=3,
                      cluster_std=0.3, random_state=2)
    X = X.astype(np.float32)
    path = tmp_path_factory.mktemp("stream") / "x.npy"
    np.save(path, X)
    return X, np.load(path, mmap_mode="r")


def _port(X, P, parts=8, **extra):
    return sharded_dbscan(X, KDPartitioner(np.asarray(X), parts),
                          mesh=Mesh(["cpu"] * P), device="cpu", **KW,
                          **extra)


def _same(got, want, keys=("owned_cap", "n_shard_partitions", "pad_waste",
                           "partition_sizes", "halo_cap", "halo_bytes",
                           "merge_rounds", "live_pairs", "kernel_passes")):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for key in keys:
        assert got[2].get(key) == want[2].get(key), key


@pytest.mark.parametrize("P,parts", [(4, 8), (8, 8), (8, 4)])
def test_streamed_slabs_equal_the_in_ram_layout(mm_blobs, P, parts):
    """One partition at a time from the memmap, each shard's slab
    concatenated on its device: the in-RAM build's bits, padding slots
    (fewer partitions than devices) included."""
    X, mm = mm_blobs
    part = KDPartitioner(X, parts)
    mesh = Mesh(["cpu"] * P)
    shards, lo, hi, labels, stats = sharded.build_owned_shards_streaming(
        mm, part, 0.4, 128, mesh)
    arrays, r_lo, r_hi, r_labels, r_stats = sharded.build_owned_shards(
        X, part, 0.4, P, 128)
    assert stats == dict(r_stats, input="stream") and labels == r_labels
    assert lo.tobytes() == r_lo.tobytes() and hi.tobytes() == r_hi.tobytes()
    assert len(shards) == P
    for i in range(3):
        got = torch.cat([sh[i] for sh in shards]).numpy()
        assert got.tobytes() == arrays[i].tobytes()


def test_stream_builds_one_partition_at_a_time(mm_blobs, monkeypatch):
    """The host holds one partition's slab per fill: every fill writes a
    one-slot buffer."""
    X, mm = mm_blobs
    shapes = []
    fill = sharded._fill_slab

    def spy(slab, *a, **k):
        shapes.append(slab.shape)
        return fill(slab, *a, **k)

    monkeypatch.setattr(sharded, "_fill_slab", spy)
    _l, _c, stats = _port(mm, 4, halo="ring")
    assert stats["input"] == "stream"
    assert len(shapes) == 8 and all(s[0] == 1 for s in shapes)


@pytest.mark.parametrize("merge", ["device", "host"])
def test_stream_matches_the_in_ram_ring_and_jax(mm_blobs, merge):
    """``stream=None`` turns the stream on for a memmap under the ring;
    the labels and stats are the in-RAM ring's and the JAX streaming
    route's."""
    X, mm = mm_blobs
    got = _port(mm, 8, halo="ring", merge=merge)
    assert got[2]["input"] == "stream"
    in_ram = _port(X, 8, halo="ring", merge=merge)
    assert "input" not in in_ram[2]
    _same(got, in_ram)
    staging.clear()
    want = jax_sharded.sharded_dbscan(
        mm, JaxKD(X, max_partitions=8), mesh=jax_default_mesh(8),
        halo="ring", merge=merge, **KW)
    _same(got, want)
    assert want[2]["input"] == "stream"
    assert got[2].get("merge", "device") == merge


def test_stream_flag_on_an_array_and_host_halo_refused(mm_blobs):
    """``stream=True`` streams an in-RAM array too; with the host halo it
    raises the JAX ``ValueError``, as ``stream=False`` keeps a memmap in
    RAM."""
    X, mm = mm_blobs
    got = _port(X, 8, halo="ring", stream=True)
    assert got[2]["input"] == "stream"
    off = _port(mm, 8, halo="ring", stream=False)
    assert "input" not in off[2]
    _same(got, off)
    with pytest.raises(ValueError, match="requires halo='ring'") as port:
        _port(X, 8, halo="host", stream=True)
    with pytest.raises(ValueError) as jax_err:
        jax_sharded.sharded_dbscan(
            X, JaxKD(X, max_partitions=8), mesh=jax_default_mesh(8),
            halo="host", stream=True, **KW)
    assert str(port.value) == str(jax_err.value)


def test_streaming_host_merge_spill(mm_blobs):
    """The JAX ``tests/test_stream.py`` spill: the stream under the host
    merge gives the in-RAM device merge's labels."""
    X, mm = mm_blobs
    ref = _port(X, 8, halo="ring", merge="device")
    got = _port(mm, 8, halo="ring", merge="host")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[2]["merge"] == "host" and got[2]["input"] == "stream"


def test_dbscan_fit_memmap_routes_streaming(mm_blobs):
    """``DBSCAN(mesh=...).fit(memmap)`` streams through the ring, to the
    JAX model's labels, partitions and parity surface."""
    X, mm = mm_blobs
    got = DBSCAN(mesh=Mesh(["cpu"] * 8), device="cpu", **KW).fit(mm)
    staging.clear()
    want = JaxDBSCAN(mesh=jax_default_mesh(8), **KW).fit(mm)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_array_equal(got.core_sample_mask_,
                                  want.core_sample_mask_)
    for key in ("input", "halo_exchange", "halo_cap", "n_partitions"):
        assert got.metrics_[key] == want.metrics_[key], key
    assert got.metrics_["input"] == "stream"
    assert got.cluster_dict == want.cluster_dict
    assert sorted(got.neighbors) == sorted(want.neighbors)
    for label, idx in want.neighbors.items():
        np.testing.assert_array_equal(got.neighbors[label], idx)
