"""The device mesh of the KD route's fused step and what the step is
held to before it runs, against the JAX package on the CPU:
``Mesh``/``default_mesh`` and the cross-shard reductions,
``BoxStack``/``KDPartitioner.box_stack`` and the stacked layout at P =
4 and 8 (padded slots included), bitwise; the refusals of
``sharded_dbscan`` and ``DBSCAN`` on a mesh (the ring's knobs and
inputs, which run), the tile rule, the single
route for small inputs and the constructor's defaults.  The step's
results are held in ``tests/test_torch_mesh_parity.py`` and
``tests/test_torch_mesh_fits.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.geometry import BoxStack as JaxBoxStack
from pypardis_tpu.parallel import sharded as jax_sharded
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.geometry import BoxStack
from pypardis_tpu_torch.parallel import Mesh, default_mesh, sharded
from pypardis_tpu_torch.parallel import mesh as tmesh
from pypardis_tpu_torch.parallel import sharded_dbscan
from pypardis_tpu_torch.partition import KDPartitioner

KW = dict(eps=0.4, min_samples=5, block=64)


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


def _port(X, P, kw=KW, parts=8, **extra):
    return sharded_dbscan(X, KDPartitioner(X, max_partitions=parts),
                          mesh=Mesh(["cpu"] * P), device="cpu", **kw,
                          **extra)


def _mesh(P):
    return Mesh(["cpu"] * P)


# -- the mesh ----------------------------------------------------------------


def test_mesh_has_the_jax_attributes():
    m = Mesh(["cpu"] * 4)
    assert m.size == 4 and len(m) == 4
    assert m.axis_names == ("p",)
    assert isinstance(m.devices, np.ndarray) and m.devices.dtype == object
    assert m.devices.shape == (4,)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert m.distinct() == [torch.device("cpu")]
    assert Mesh(["cpu"] * 2, axis_name="x").axis_names == ("x",)
    # "cuda" and "cuda:0" name one card: a repeated device.
    c = Mesh(["cuda", "cuda:0", "cuda:1"])
    assert [str(d) for d in c.devices] == ["cuda:0", "cuda:0", "cuda:1"]
    assert c.distinct() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert c.device_type == "cuda"


@pytest.mark.parametrize("bad", [["cpu", "cuda:0"], [], ["meta"]])
def test_a_mixed_or_empty_mesh_raises(bad):
    with pytest.raises(ValueError):
        Mesh(bad)


def test_default_mesh_spans_the_cards_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        default_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert [str(d) for d in default_mesh().devices] == [
        "cuda:0", "cuda:1", "cuda:2"]
    assert default_mesh(2).size == 2
    for n in (0, 4):
        with pytest.raises(ValueError, match="n_devices"):
            default_mesh(n)


def test_as_mesh_takes_meshes_and_device_lists():
    m = Mesh(["cpu"] * 2)
    assert tmesh.as_mesh(m) is m and tmesh.as_mesh(None) is None
    assert tmesh.as_mesh(["cpu", "cpu"]) == m
    for bad in (2, SimpleNamespace(devices=np.zeros(2))):
        with pytest.raises(TypeError, match="Mesh"):
            tmesh.as_mesh(bad)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int32])
def test_shard_reductions_are_exact_in_any_order(dtype):
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.integers(-5, 6, size=50)).to(dtype)
             for _ in range(5)]
    want_max = np.max(np.stack([p.numpy() for p in parts]), axis=0)
    for order in (parts, parts[::-1]):
        got = tmesh.shard_max(order, "cpu")
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want_max)
    if dtype == torch.int32:
        want_min = np.min(np.stack([p.numpy() for p in parts]), axis=0)
        np.testing.assert_array_equal(
            tmesh.shard_min(parts[::-1], "cpu").numpy(), want_min)
    stacked = tmesh.gather(parts, "cpu")
    assert stacked.shape == (5, 50)


# -- BoxStack and the stacked layout ----------------------------------------


def test_box_stack_is_the_jax_stack(blobs):
    part, jpart = KDPartitioner(blobs, max_partitions=8), JaxKD(
        blobs, max_partitions=8)
    got, want = part.box_stack(), jpart.box_stack()
    for a, b in ((got, want), (got.expand(0.8), want.expand(0.8))):
        assert a.lower.dtype == b.lower.dtype == np.float64
        assert a.lower.tobytes() == b.lower.tobytes()
        assert a.upper.tobytes() == b.upper.tobytes()
    boxes = [part.bounding_boxes[l] for l in sorted(part.bounding_boxes)]
    direct = BoxStack.from_boxes(boxes)
    jdirect = JaxBoxStack.from_boxes(
        jpart.bounding_boxes[l] for l in sorted(jpart.bounding_boxes))
    assert direct.lower.tobytes() == jdirect.lower.tobytes()
    assert len(direct) == 8 and direct.k == 3
    assert direct[2] == boxes[2]
    np.testing.assert_array_equal(direct.membership(blobs[:500]),
                                  jdirect.membership(blobs[:500]))
    with pytest.raises(ValueError):
        BoxStack(np.zeros((2, 3)), np.zeros((3, 3)))


@pytest.mark.parametrize("parts", [4, 6, 8])
@pytest.mark.parametrize("P", [4, 8])
def test_build_shards_is_the_jax_layout_on_a_mesh(blobs, P, parts):
    """The partition axis padded to a multiple of the mesh with fully
    masked empty slots (gid n), block-multiple capacities; every array
    the JAX package's, transposed to (P, k, cap)."""
    block, n = KW["block"], len(blobs)
    jarr, jst = jax_sharded.build_shards(
        blobs, JaxKD(blobs, max_partitions=parts), KW["eps"], P, block)
    tarr, tst = sharded.build_shards(
        blobs, KDPartitioner(blobs, max_partitions=parts), KW["eps"], P,
        block)
    assert tst == jst
    for i in (0, 3):
        assert tarr[i].view(np.int32).tobytes() == np.ascontiguousarray(
            jarr[i].transpose(0, 2, 1)).view(np.int32).tobytes()
    for i in (1, 2, 4, 5):
        np.testing.assert_array_equal(tarr[i], jarr[i])
    p_total = tst["n_shard_partitions"]
    assert p_total % P == 0 and p_total >= parts
    assert tst["owned_cap"] % block == 0 and tst["halo_cap"] % block == 0
    for j in range(parts, p_total):
        assert not tarr[1][j].any() and not tarr[4][j].any()
        assert (tarr[2][j] == n).all() and (tarr[5][j] == n).all()
    assert tst["partition_sizes"][parts:] == [0] * (p_total - parts)


# -- refusals and the tile rule ----------------------------------------------


@pytest.mark.parametrize("knob", [dict(mode="global_morton",
                                       metric="cityblock")])
def test_refused_knobs_on_a_mesh_name_their_roadmap_item(blobs, knob):
    """The global-Morton mesh engine runs on a mesh now
    (``tests/test_torch_gm_mesh.py``); its non-Euclidean metrics stay
    refused."""
    kw = dict(KW, **knob)
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        _port(blobs[:800], 4, kw=kw)


@pytest.mark.parametrize("knob", [
    dict(halo="ring"), dict(halo="ring", stream=True),
    dict(halo="ring", hcap=256), dict(hcap=256),
])
def test_ring_knobs_run_on_a_mesh(blobs, knob):
    """The ring's knobs run on a mesh (the ring, its streaming build and
    an explicit ``hcap``; ``hcap`` is unread under the host halo, as in
    JAX), each to the host-halo route's labels."""
    want = _port(blobs[:800], 4)
    got = _port(blobs[:800], 4, **knob)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].get("halo_exchange") == knob.get("halo")
    assert (got[2].get("input") == "stream") == bool(knob.get("stream"))


def test_stream_needs_the_ring_on_a_mesh(blobs):
    with pytest.raises(ValueError, match="stream=True requires halo='ring'"):
        _port(blobs[:800], 4, stream=True)


def test_a_mesh_of_the_wrong_type_raises(blobs):
    with pytest.raises(ValueError, match="mesh"):
        sharded_dbscan(blobs, KDPartitioner(blobs, max_partitions=8),
                       mesh=Mesh(["cuda:0"] * 4), device="cpu", **KW)
    with pytest.raises(TypeError, match="Mesh"):
        sharded_dbscan(blobs, KDPartitioner(blobs, max_partitions=8),
                       mesh=4, device="cpu", **KW)


def test_a_misaligned_layout_raises_before_any_pass(monkeypatch):
    """block=1001 at 600 axes: the tile halves to 125, which divides
    neither the owned capacity nor the slab, and nothing runs."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2400, 600)).astype(np.float32)
    ran = []
    monkeypatch.setattr(sharded, "_mesh_cluster",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(ValueError, match="block=1001"):
        sharded_dbscan(X, KDPartitioner(X, max_partitions=2), eps=1.0,
                       min_samples=5, block=1001, mesh=Mesh(["cpu"] * 2),
                       device="cpu")
    assert not ran


# -- DBSCAN on a mesh: the routes and the refusals ---------------------------


def test_small_inputs_on_a_mesh_take_the_single_route():
    X = np.random.default_rng(0).normal(size=(12, 3))
    m = DBSCAN(mesh=_mesh(8), device="cpu", eps=0.5, min_samples=2,
               block=64).fit(X)
    r = m.report()
    assert r["run"]["n_devices"] == 1 and m.partitioner_ is None
    assert r["sharding"]["halo_factor"] == 0.0
    assert list(m.cluster_mapping().fwd) == [
        f"0:{l}" for l in np.unique(m.labels_[m.labels_ >= 0])]


def test_a_single_fit_after_a_mesh_fit_drops_the_partitioner(blobs):
    m = DBSCAN(mesh=_mesh(4), device="cpu", **KW).fit(blobs)
    assert m.partitioner_ is not None
    m.fit(blobs[:6])
    assert m.partitioner_ is None


@pytest.mark.parametrize("how", ["global_morton"])
def test_mesh_fits_refuse_the_unported_routes(blobs, tmp_path, how):
    """``mode="global_morton"`` fits on a mesh now; its cityblock metric
    is what stays refused (ROADMAP A12), and the refusal is not taken
    for an OOM: no KD fallback hides it."""
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        DBSCAN(mesh=_mesh(4), device="cpu", mode=how, metric="cityblock",
               **KW).fit(blobs)


@pytest.mark.parametrize("how", ["memmap", "tensor"])
def test_mesh_fits_take_the_ring_routes(blobs, tmp_path, how):
    """A memmap streams through the ring, a tensor takes the
    device-input route; both to the host-input fit's clustering."""
    if how == "memmap":
        X = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+",
                                      dtype=np.float32, shape=blobs.shape)
        X[:] = blobs
    else:
        X = torch.from_numpy(blobs)
    want = DBSCAN(mesh=_mesh(4), device="cpu", **KW).fit(blobs)
    got = DBSCAN(mesh=_mesh(4), device="cpu", **KW).fit(X)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_array_equal(got.core_sample_mask_,
                                  want.core_sample_mask_)
    assert got.metrics_["input"] == {"memmap": "stream",
                                     "tensor": "device"}[how]
    assert got.metrics_["halo_exchange"] == "ring"


@pytest.mark.parametrize("bad", [
    dict(mesh=Mesh(["cuda:0"] * 2), device="cpu"),
    dict(mode="ring", device="cpu"),
    dict(merge="both", device="cpu"),
    dict(max_partitions=0, device="cpu"),
])
def test_bad_sharding_knobs_raise(bad):
    with pytest.raises(ValueError):
        DBSCAN(**bad)


def test_the_defaults_are_the_jax_constructors():
    m = DBSCAN(device="cpu")
    j = JaxDBSCAN()
    for k in ("max_partitions", "split_method", "mesh", "merge",
              "owner_computes", "overlap", "mode"):
        assert getattr(m, k) == getattr(j, k), k
    assert m._n_devices() == 1
    assert DBSCAN(mesh=["cpu"] * 3, device="cpu")._n_devices() == 3
