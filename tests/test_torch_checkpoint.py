"""Checkpoints cross-load between the JAX package and the port, both
ways, and serve identically: models, serving indexes (including the
cosine and haversine query frames) and partition trees, in every
precision mode and metric.  ``eps=None`` checkpoints cross-load in
``tests/test_torch_hierarchy.py``."""

import numpy as np
import pytest
import torch

import pypardis_tpu as jax_pkg
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import checkpoint as jckpt
from pypardis_tpu.partition import KDPartitioner as JaxKD
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import (
    DBSCAN,
    KDPartitioner,
    QueryEngine,
    load_index,
    load_model,
    save_index,
    save_model,
)
from pypardis_tpu_torch import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def jax_fit(X, **kw):
    return JaxDBSCAN(kernel_backend="xla", mesh=default_mesh(1), **kw).fit(X)


@pytest.fixture(scope="module")
def data():
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=900, centers=[[0, 0, 0], [3, 3, 0],
                                              [0, 3, 3]],
                      cluster_std=0.5, random_state=4)
    rng = np.random.default_rng(8)
    Q = np.concatenate([
        X[::4] + rng.normal(scale=0.2, size=X[::4].shape),
        rng.uniform(-2, 5, size=(80, 3)),
    ])
    return X, Q


def _same(a, b):
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])


def test_jax_model_serves_identically_in_the_port(tmp_path, data):
    X, Q = data
    ref = jax_fit(X, eps=0.5, min_samples=6)
    path = str(tmp_path / "jax_model")  # load adds .npz as save did
    jckpt.save_model(ref, path)
    port = load_model(path, device="cpu")
    assert port.data is None
    assert port.kernel_backend == "auto"  # the JAX "xla" is not a port route
    assert np.array_equal(port.labels_, ref.labels_)
    assert np.array_equal(port.core_sample_mask_, ref.core_sample_mask_)
    assert port.assignments() == ref.assignments()
    want = ref.query_engine(leaves=4, block=32, qblock=32).predict(
        Q, return_distance=True
    )
    got = port.query_engine(leaves=4, block=32, qblock=32).predict(
        Q, return_distance=True
    )
    _same(got, want)
    assert np.array_equal(port.predict(Q), ref.predict(Q))


def test_port_model_serves_identically_in_jax(tmp_path, data):
    X, Q = data
    port = DBSCAN(eps=0.5, min_samples=6, device="cpu").fit(X)
    path = str(tmp_path / "port_model.npz")
    port.save(path)
    ref = JaxDBSCAN.load(path)
    assert ref.data is None
    assert np.array_equal(ref.labels_, port.labels_)
    assert ref.assignments() == port.assignments()
    _same(
        port.query_engine(leaves=4, block=32, qblock=32).predict(
            Q, return_distance=True),
        ref.query_engine(leaves=4, block=32, qblock=32).predict(
            Q, return_distance=True),
    )


def test_port_round_trip_keeps_results_and_answers(tmp_path, data):
    X, Q = data
    # A tensor fit: the core rows come off the tensor.
    port = DBSCAN(eps=0.5, min_samples=6, device="cpu").fit(
        torch.from_numpy(X.astype(np.float32))
    )
    path = str(tmp_path / "m.npz")
    save_model(port, path)
    back = DBSCAN.load(path, device="cpu")
    assert back.data is None and back.device.type == "cpu"
    assert back.assignments() == port.assignments()
    assert back.metrics_ == port.metrics_
    assert back.bounding_boxes[0] == port.bounding_boxes[0]
    assert back.expanded_boxes[0] == port.expanded_boxes[0]
    _same(back.query_engine().predict(Q, return_distance=True),
          port.query_engine().predict(Q, return_distance=True))
    with np.load(path) as z:
        assert z["core_points"].dtype == np.float32
        assert len(z["core_points"]) == port.core_sample_mask_.sum()


def test_object_keys_are_stored_as_strings(tmp_path):
    rng = np.random.default_rng(0)
    records = [(f"k{i}", rng.normal(size=2)) for i in range(40)]
    port = DBSCAN(eps=0.8, min_samples=3, device="cpu").train(records)
    path = str(tmp_path / "keys.npz")
    port.save(path)
    back = load_model(path, device="cpu")
    assert back.assignments() == port.assignments()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_checkpoints_cross_load(tmp_path, data, direction):
    X, Q = data
    ref = jax_fit(X, eps=0.5, min_samples=6)
    path = str(tmp_path / "index.npz")
    jeng = ref.query_engine(leaves=4, block=32, qblock=32)
    want = jeng.predict(Q, return_distance=True)
    if direction == "jax_to_port":
        jckpt.save_index(jeng.index, path)
        idx = load_index(path, device="cpu")
        got = QueryEngine(idx).predict(Q, return_distance=True)
        src = jeng.index
    else:
        port = load_model_from(ref, tmp_path)
        idx = port.query_engine(leaves=4, block=32, qblock=32).index
        save_index(idx, path)
        back = jckpt.load_index(path)
        got = jax_pkg.serve.QueryEngine(back, backend="xla").predict(
            Q, return_distance=True
        )
        src, idx = idx, back
    for name in ("coords", "labels", "blo", "bhi", "center"):
        assert np.array_equal(getattr(idx, name), getattr(src, name)), name
    assert idx.tree == src.tree
    assert (idx.leaf_cap, idx.n_leaves, idx.nb) == (
        src.leaf_cap, src.n_leaves, src.nb
    )
    _same(got, want)


def load_model_from(ref, tmp_path):
    path = str(tmp_path / "via.npz")
    jckpt.save_model(ref, path)
    return load_model(path, device="cpu")


@pytest.mark.parametrize("metric,make", [
    ("cosine", "directions"),
    ("haversine", "latlon"),
])
def test_driver_metric_index_frames_load_in_the_port(tmp_path, metric,
                                                     make):
    """A JAX index in the cosine ("unit") or haversine ("latlon") frame
    projects its queries the same way once loaded in the port."""
    rng = np.random.default_rng(5)
    if make == "directions":
        c = rng.normal(size=(4, 3))
        X = np.concatenate([ci + rng.normal(scale=0.1, size=(150, 3))
                            for ci in c])
        Q = X[::5] + rng.normal(scale=0.05, size=X[::5].shape)
        eps = 0.02
    else:
        c = rng.uniform([-1.0, -3.0], [1.0, 3.0], size=(4, 2))
        X = np.concatenate([ci + rng.normal(scale=0.02, size=(150, 2))
                            for ci in c])
        Q = X[::5] + rng.normal(scale=0.01, size=X[::5].shape)
        eps = 0.03
    ref = jax_fit(X, eps=eps, min_samples=5, metric=metric)
    jeng = ref.query_engine(leaves=4, block=32, qblock=32)
    assert jeng.index.projection == {"cosine": "unit",
                                     "haversine": "latlon"}[metric]
    want = jeng.predict(Q, return_distance=True)
    assert (want[0] >= 0).sum() > len(Q) // 2
    path = str(tmp_path / "frame.npz")
    jckpt.save_index(jeng.index, path)
    idx = load_index(path, device="cpu")
    assert (idx.projection, idx.unit_norm) == (
        jeng.index.projection, jeng.index.unit_norm
    )
    _same(QueryEngine(idx).predict(Q, return_distance=True), want)
    # The JAX model loads as a port model in its metric and serves
    # through the same frame.
    mpath = str(tmp_path / "frame_model.npz")
    jckpt.save_model(ref, mpath)
    model = load_model(mpath, device="cpu")
    assert model.metric == metric and model.kernel_eps == ref.kernel_eps
    _same(model.query_engine(leaves=4, block=32, qblock=32).predict(
        Q, return_distance=True), want)


@pytest.mark.parametrize("precision", ["mixed", "default"])
def test_jax_bf16_precision_model_loads_and_serves(tmp_path, data,
                                                   precision):
    """A JAX checkpoint fitted under a bf16 mode loads with its mode and
    serves byte-identically to the JAX engine (a "mixed" model serves
    through the "mixed" prefilter in both packages); a "mixed" refit of
    the loaded model gives the checkpoint's labels (the JAX package's
    CPU "default" dot is full FP32, so only the "mixed" fit is exact in
    both)."""
    X, Q = data
    ref = jax_fit(X, eps=0.5, min_samples=6, precision=precision)
    path = str(tmp_path / f"{precision}.npz")
    jckpt.save_model(ref, path)
    port = load_model(path, device="cpu")
    assert port.precision == precision
    assert np.array_equal(port.labels_, ref.labels_)
    eng = port.query_engine(leaves=4, block=32, qblock=32)
    jeng = ref.query_engine(leaves=4, block=32, qblock=32)
    assert eng.precision == jeng.precision
    assert eng.precision == ("mixed" if precision == "mixed" else "high")
    _same(eng.predict(Q, return_distance=True),
          jeng.predict(Q, return_distance=True))
    if precision == "mixed":
        refit = DBSCAN(eps=0.5, min_samples=6, precision=port.precision,
                       device="cpu").fit(X)
        assert np.array_equal(refit.labels_, ref.labels_)
        assert refit.metrics_["band_pairs"] > 0


def test_wrong_kind_and_unfitted_raise(tmp_path, data):
    X, _Q = data
    with pytest.raises(ValueError, match="untrained"):
        save_model(DBSCAN(eps=0.5, device="cpu"), str(tmp_path / "u.npz"))
    port = DBSCAN(eps=0.5, min_samples=6, device="cpu").fit(X)
    path = str(tmp_path / "m.npz")
    port.save(path)
    with pytest.raises(ValueError, match="serving-index"):
        load_index(path, device="cpu")
    with pytest.raises(ValueError, match="partition-tree"):
        ckpt.load_partitioner(path)
    save_index(port.query_engine().index, str(tmp_path / "i.npz"))
    with pytest.raises(ValueError, match="DBSCAN model"):
        load_model(str(tmp_path / "i.npz"), device="cpu")


def test_loading_without_a_card_needs_the_cpu(tmp_path, data, monkeypatch):
    X, _Q = data
    port = DBSCAN(eps=0.5, min_samples=6, device="cpu").fit(X)
    port.save(str(tmp_path / "m.npz"))
    save_index(port.query_engine().index, str(tmp_path / "i.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(str(tmp_path / "i.npz"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_partition_trees_cross_load(tmp_path, direction):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(500, 3))
    Q = rng.normal(scale=1.5, size=(200, 3))
    path = str(tmp_path / "tree.npz")
    if direction == "jax_to_port":
        part = JaxKD(X, max_partitions=8, seed=1)
        jckpt.save_partitioner(part, path)
        tree = ckpt.load_partitioner(path)
    else:
        part = KDPartitioner(X, max_partitions=8, seed=1)
        ckpt.save_partitioner(part, path)
        tree = jckpt.load_partitioner(path)
    assert tree.tree == part.tree
    assert tree.n_partitions == part.n_partitions == 8
    assert tree.split_method == "min_var" and tree.k == 3
    assert np.array_equal(tree.route(Q), part.route(Q))
    for label, box in part.bounding_boxes.items():
        assert np.array_equal(tree.bounding_boxes[label].lower, box.lower)
    with pytest.raises(ValueError, match="dimensionality"):
        tree.route(Q[:, :2])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mesh_fitted_models_cross_load(tmp_path, data, direction):
    """A model fitted on a 4-device mesh checkpoints its own sharding
    knobs and every partition box; either package loads the other's and
    serves identically."""
    from pypardis_tpu_torch.parallel import Mesh

    X, Q = data
    kw = dict(eps=0.5, min_samples=6, max_partitions=6,
              split_method="rotation")
    path = str(tmp_path / "mesh_model.npz")
    if direction == "jax_to_port":
        src = JaxDBSCAN(kernel_backend="xla", mesh=default_mesh(4),
                        **kw).fit(X)
        jckpt.save_model(src, path)
        back = load_model(path, device="cpu")
    else:
        src = DBSCAN(mesh=Mesh(["cpu"] * 4), device="cpu", **kw).fit(X)
        save_model(src, path)
        back = JaxDBSCAN.load(path)
    assert len(src.bounding_boxes) == 6
    assert (back.max_partitions, back.split_method) == (6, "rotation")
    assert back.assignments() == src.assignments()
    assert np.array_equal(back.core_sample_mask_, src.core_sample_mask_)
    for l, box in src.bounding_boxes.items():
        assert np.array_equal(back.bounding_boxes[l].lower, box.lower)
        assert np.array_equal(back.bounding_boxes[l].upper, box.upper)
    assert back.metrics_["n_partitions"] == 6
    _same(back.query_engine(leaves=4, block=32, qblock=32).predict(
              Q, return_distance=True),
          src.query_engine(leaves=4, block=32, qblock=32).predict(
              Q, return_distance=True))
