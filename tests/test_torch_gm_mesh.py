"""The global-Morton mesh engine, ``pypardis_tpu_torch.parallel.
global_morton_dbscan(points, mesh=Mesh(["cpu"] * P))``, held against
the JAX engine (``global_morton_dbscan(points, mesh=default_mesh(P))``)
on the CPU (``tests/test_global_morton.py``'s geometries: 2,000 x 3
blobs at eps 0.4, min_samples 5, block 128; a line through every
shard; 1,200 x 256 separated blobs under the sketch).

Labels and core flags byte-identical, and every count in ``stats``
equal, for both merges, the overlap on and off, ``"high"`` and
``"mixed"``, P = 4 and 8, the one-device unchained form and the
streaming build; then the ``DBSCAN(mode="global_morton")`` surface, the
staging reuse and ``btcap``.  The JAX engine overlaps its counts only
under its pair-list dispatch (``PYPARDIS_DISPATCH=pair``), which the
overlap-on cases set.  Two documented differences: under that dispatch
the JAX ``live_pairs`` counts the (boundary, boundary) tile pairs the
port's rows leave out (the JAX default dispatch's convention, which the
port keeps), and under ``"mixed"`` ``band_pairs`` is held within 1 %
(the bf16 band, ``tests/test_torch_global_morton.py``'s docstring)."""

import json

import jax
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import benchdata
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.ops.labels import densify_labels
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import global_morton as jax_gm
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.parallel import global_morton_dbscan, sharded_dbscan
from pypardis_tpu_torch.parallel import staging
from pypardis_tpu_torch.parallel.mesh import Mesh
from pypardis_tpu_torch.partition import MortonRangePartitioner

KW = dict(eps=0.4, min_samples=5, block=128)
# Timings and the port's own telemetry.
PORT_ONLY = {"stage_s", "partition_passes", "merge_host_syncs",
             "exchange_overlap_efficiency"}
# The counts the acceptance holds equal in every case.
GAUGES = ("boundary_tiles", "boundary_rows", "sent_tiles", "sent_tiles_box",
          "halo_cap", "pad_waste", "partition_sizes", "fixpoint_rounds")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _clean_slate():
    staging.clear()
    jax_staging.clear()
    yield
    staging.clear()
    jax_staging.clear()


@pytest.fixture(scope="module")
def blobs():
    X, _ = make_blobs(n_samples=2000, centers=6, n_features=3,
                      cluster_std=0.3, random_state=3)
    return X


def _mesh(P):
    return Mesh(["cpu"] * P)


def _port(X, P, **kw):
    return global_morton_dbscan(X, mesh=_mesh(P), device="cpu", **kw)


def _check_stats(stats, want, tag, pair_dispatch=False, mixed=False):
    for key in GAUGES:
        assert stats[key] == want[key], (tag, key)
    for key in sorted(set(want) | set(stats)):
        if key.endswith("_s") or key in PORT_ONLY or key == "parity":
            continue
        if pair_dispatch and key == "live_pairs":
            assert stats[key] <= want[key], (tag, key)
        elif mixed and key == "band_pairs":
            assert abs(stats[key] - want[key]) <= 0.01 * want[key], tag
        else:
            assert stats.get(key) == want.get(key), (tag, key)


@pytest.mark.parametrize("P,merge,overlap,precision", [
    (4, "device", False, "high"),
    (4, "host", True, "high"),
    (8, "device", True, "high"),
    (8, "host", False, "high"),
    (4, "device", True, "mixed"),
    (8, "host", False, "mixed"),
])
def test_engine_matches_jax(blobs, monkeypatch, P, merge, overlap,
                            precision):
    monkeypatch.setenv("PPTORCH_GM_OVERLAP", "1" if overlap else "0")
    if overlap:
        monkeypatch.setenv("PYPARDIS_DISPATCH", "pair")
    jax.clear_caches()
    kw = dict(KW, merge=merge, precision=precision)
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        blobs, mesh=default_mesh(P), **kw)
    lab, core, st = _port(blobs, P, **kw)
    jax.clear_caches()
    tag = f"P={P} {merge} overlap={overlap} {precision}"
    np.testing.assert_array_equal(lab, j_lab, err_msg=tag)
    np.testing.assert_array_equal(core, j_core, err_msg=tag)
    _check_stats(st, j_st, tag, pair_dispatch=overlap,
                 mixed=precision == "mixed")
    assert st["mode"] == "global_morton"
    assert st["halo_exchange"] == "morton_ring"
    assert st["merge"] == merge and st["ring_rounds"] == P - 1
    assert st["duplicated_work_factor"] == 1.0 and st["owner_computes"]
    assert st["boundary_tiles"] > 0
    assert 0.0 <= st["exchange_overlap_efficiency"] <= 1.0
    # The overlap adds the delta pass to every shard's counts.
    assert st["kernel_passes"] == j_st["kernel_passes"]


def test_cluster_spans_many_shard_boundaries():
    """A line threading all 8 Morton ranges: the fixpoint's multi-hop
    propagation carries one label across 7 shard boundaries."""
    rng = np.random.default_rng(0)
    n = 4096
    t = np.linspace(0.0, 100.0, n)
    X = np.stack([t, rng.normal(0.0, 0.01, n)], axis=1)
    kw = dict(eps=0.1, min_samples=5, block=128)
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        X, mesh=default_mesh(8), **kw)
    lab, core, st = _port(X, 8, **kw)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    assert densify_labels(lab).max() == 0
    assert st["merge_converged"] is True
    assert st["fixpoint_rounds"] == j_st["fixpoint_rounds"] >= 2
    assert st["boundary_tiles"] == j_st["boundary_tiles"] >= 7


def test_one_device_unchained_form(blobs):
    """A mesh of one device with ``chain <= 1`` runs the engine itself:
    one shard, an empty one-tile boundary, no ring round; its labels are
    the JAX form's and the chained form's."""
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        blobs, mesh=default_mesh(1), chain=0, **KW)
    lab, core, st = global_morton_dbscan(blobs, mesh=_mesh(1), chain=0,
                                         device="cpu", **KW)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    _check_stats(st, j_st, "1 device")
    assert st["ring_rounds"] == 0 and st["boundary_tiles"] == 0
    chained, c_core, _ = global_morton_dbscan(blobs, mesh=1, chain=4,
                                              device="cpu", **KW)
    np.testing.assert_array_equal(lab, chained)
    np.testing.assert_array_equal(core, c_core)


@pytest.mark.parametrize("P,merge", [(4, "host"), (8, "device")])
def test_streaming_build_equals_the_in_ram_build(blobs, tmp_path, monkeypatch,
                                                P, merge):
    """A float32 memmap streams (:func:`build_morton_shards_streaming`):
    its labels equal the in-RAM build's and the JAX streaming fit's
    (whose default dispatch runs no overlap, so neither does the port's
    here)."""
    monkeypatch.setenv("PPTORCH_GM_OVERLAP", "0")
    X = blobs.astype(np.float32)
    mm = np.memmap(tmp_path / "pts.f32", dtype=np.float32, mode="w+",
                   shape=X.shape)
    mm[:] = X
    mm.flush()
    kw = dict(KW, merge=merge)
    inram, in_core, _ = _port(X, P, **kw)
    staging.clear()
    lab, core, st = _port(mm, P, **kw)
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        mm, mesh=default_mesh(P), **kw)
    assert st["input"] == "stream" == j_st["input"]
    np.testing.assert_array_equal(lab, inram)
    np.testing.assert_array_equal(core, in_core)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    _check_stats(st, j_st, f"stream P={P}")
    assert "order" not in st["parity"]


def test_sketched_fit_matches_jax():
    """1,200 x 256 under the sketch (k auto): the ring's sketch
    tightening at the mesh-wide norm band, then B3/B4's plain versions."""
    X, _, _ = benchdata.make_separated_blob_data(
        1200, 256, n_centers=6, min_sep=30.0, spread=30.0, seed=2)
    X = X.astype(np.float32)
    kw = dict(eps=9.0, min_samples=10, block=128)
    j_lab, j_core, j_st = jax_gm.global_morton_dbscan(
        X, mesh=default_mesh(4), **kw)
    lab, core, st = _port(X, 4, **kw)
    np.testing.assert_array_equal(lab, j_lab)
    np.testing.assert_array_equal(core, j_core)
    for key in GAUGES + ("sketch_k",):
        assert st[key] == j_st[key], key
    assert st["sketch_k"] > 0 and st["sent_tiles"] <= st["sent_tiles_box"]


def test_dbscan_mode_surface(blobs, tmp_path):
    want = JaxDBSCAN(mode="global_morton", mesh=default_mesh(8),
                     **KW).fit(blobs)
    model = DBSCAN(mode="global_morton", mesh=_mesh(8), device="cpu", **KW)
    model.fit(blobs)
    np.testing.assert_array_equal(model.labels_, want.labels_)
    np.testing.assert_array_equal(model.core_sample_mask_,
                                  want.core_sample_mask_)
    report = model.report()
    sh = report["sharding"]
    assert sh["mode"] == "global_morton"
    assert sh["halo_exchange"] == "morton_ring"
    assert sh["duplicated_work_factor"] == 1.0
    assert sh["owner_computes"] is True
    assert sh["boundary_tile_bytes"] > 0
    assert sh["ring_rounds"] == 7
    # The build/exchange/compute/merge split rides as report phases.
    for key in ("gm_build", "gm_exchange", "gm_execute", "gm_merge"):
        assert report["phases"][key] >= 0.0
    part = model.partitioner_
    assert isinstance(part, MortonRangePartitioner)
    np.testing.assert_array_equal(part.result, want.partitioner_.result)
    assert part.tree == [] and part.builder == "morton_range"
    assert int(part.partition_sizes().sum()) == len(blobs)
    assert model.bounding_boxes.keys() == want.bounding_boxes.keys()
    for s, box in model.bounding_boxes.items():
        np.testing.assert_array_equal(box.lower,
                                      want.bounding_boxes[s].lower)
    assert sum(len(v) for v in model.neighbors.values()) == len(blobs)
    assert model.cluster_dict == want.cluster_dict
    assert "boundary" in model.summary()
    path = tmp_path / "gm_trace.json"
    model.export_trace(str(path))
    names = {ev["name"] for ev in json.load(open(path))["traceEvents"]}
    assert {"gm.exchange", "gm.ring_round", "gm.fixpoint_round"} <= names


def test_sharded_dbscan_mode_dispatch(blobs):
    want, _c, _s = jax_gm.global_morton_dbscan(blobs, mesh=default_mesh(8),
                                               **KW)
    labels, _core, stats = sharded_dbscan(
        blobs, None, mode="global_morton", mesh=_mesh(8), device="cpu", **KW)
    assert stats["mode"] == "global_morton"
    np.testing.assert_array_equal(labels, want)


def test_mode_input_validation(blobs, tmp_path):
    """A tensor raises (the Morton keying runs on the host); a memmap
    streams, and its parity surface is the ranges' boxes without a
    partitioner."""
    model = DBSCAN(mode="global_morton", mesh=_mesh(8), device="cpu", **KW)
    with pytest.raises(ValueError, match="host-resident"):
        model.fit(torch.from_numpy(np.asarray(blobs, np.float32)))
    mm = np.memmap(tmp_path / "x.dat", dtype=np.float32, mode="w+",
                   shape=blobs.shape)
    mm[:] = blobs.astype(np.float32)
    m = DBSCAN(mode="global_morton", mesh=_mesh(8), device="cpu",
               **KW).fit(mm)
    assert m.metrics_.get("input") == "stream"
    assert m.partitioner_ is None and m.bounding_boxes
    rep = m.report()
    assert rep["sharding"]["input"] == "stream"
    assert rep["sharding"]["stream_buckets"] >= 1
    assert "stream" in m.summary()


def test_warm_refit_and_eps_sweep_reuse_staged_slabs(blobs):
    mesh = _mesh(8)
    jm = default_mesh(8)
    l1, _, s1 = global_morton_dbscan(blobs, mesh=mesh, device="cpu", **KW)
    j1 = jax_gm.global_morton_dbscan(blobs, mesh=jm, **KW)[2]
    assert s1["staged_bytes_reused"] == 0
    assert s1["staged_bytes"] == j1["staged_bytes"] > 0
    l2, _, s2 = global_morton_dbscan(blobs, mesh=mesh, device="cpu", **KW)
    j2 = jax_gm.global_morton_dbscan(blobs, mesh=jm, **KW)[2]
    # A warm refit reuses the owned slabs and the boundary tiles.
    assert s2["staged_bytes_reused"] == j2["staged_bytes_reused"] > 0
    assert s2["staged_bytes"] == 0
    np.testing.assert_array_equal(l1, l2)
    # An eps change reuses the owned slabs only (their key has no eps).
    kw3 = dict(KW, eps=0.5)
    l3, _, s3 = global_morton_dbscan(blobs, mesh=mesh, device="cpu", **kw3)
    j3 = jax_gm.global_morton_dbscan(blobs, mesh=jm, **kw3)
    assert s3["staged_bytes_reused"] == j3[2]["staged_bytes_reused"] > 0
    assert 0 < s3["staged_bytes"] < s1["staged_bytes"]
    np.testing.assert_array_equal(l3, j3[0])
    # A 4-shard layout of the same data is a key of its own, though
    # every device of both meshes reads "cpu".
    _, _, s4 = global_morton_dbscan(blobs, mesh=_mesh(4), device="cpu",
                                    **KW)
    assert s4["staged_bytes_reused"] == 0


def test_explicit_btcap(blobs):
    want, _c, _s = jax_gm.global_morton_dbscan(blobs, mesh=default_mesh(8),
                                               **KW)
    labels, _, stats = _port(blobs, 8, btcap=64, **KW)
    np.testing.assert_array_equal(labels, want)
    assert stats["boundary_tile_caps"][0] <= 64
    # A too-small explicit send capacity raises, naming the need.
    staging.clear()
    with pytest.raises(RuntimeError, match="boundary-tile") as ei:
        _port(blobs, 8, btcap=1, **KW)
    assert "needs" in str(ei.value) and "PPTORCH_GM_BTCAP" in str(ei.value)
