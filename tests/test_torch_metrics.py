"""The cityblock, cosine and haversine metrics of the port, held against
the JAX package on the CPU (``kernel_backend="xla"``): fits byte-identical
on blobs750 and separated blobs, pinned against numpy oracles, the
validation contract, ``predict`` bitwise the JAX engine, and JAX
checkpoints in each metric loading, serving and refitting.

Byte parity holds where no pair lies within rounding distance of eps
(ROADMAP): the two packages take d^2 in different float32 forms.  Each
parity case checks its margin: the least float64 distance of any pair
from eps, relative to eps."""

import collections

import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu import checkpoint as jckpt
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel.sharded import _canonicalize_roots
from pypardis_tpu_torch import DBSCAN, load_model
from pypardis_tpu_torch.convert import dbscan_from_reference
from pypardis_tpu_torch.dbscan import _unit_rows
from pypardis_tpu_torch.geometry import latlon_to_unit_sphere
from pypardis_tpu_torch.ops.labels import densify_labels


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


def distances(X, metric):
    """float64 pairwise distances in the metric's own terms."""
    X = np.asarray(X, np.float64)
    if metric == "cityblock":
        return np.abs(X[:, None, :] - X[None, :, :]).sum(-1)
    if metric == "euclidean":
        return np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    if metric == "cosine":
        U = X / np.linalg.norm(X, axis=1, keepdims=True)
        return 1.0 - U @ U.T
    lat, lon = X[:, 0], X[:, 1]
    h = (np.sin((lat[:, None] - lat[None, :]) / 2.0) ** 2
         + np.cos(lat[:, None]) * np.cos(lat[None, :])
         * np.sin((lon[:, None] - lon[None, :]) / 2.0) ** 2)
    return 2.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def oracle(X, metric, eps, ms):
    """Brute-force DBSCAN on float64 distances in the parallel
    formulation (min-core-index components, a border takes the least
    adjacent root), densified."""
    adj = distances(X, metric) <= eps
    core = adj.sum(1) >= ms
    n = len(X)
    comp = np.full(n, -1)
    cid = 0
    for i in range(n):
        if core[i] and comp[i] < 0:
            q = collections.deque([i])
            comp[i] = cid
            while q:
                u = q.popleft()
                for v in np.flatnonzero(adj[u] & core):
                    if comp[v] < 0:
                        comp[v] = cid
                        q.append(v)
            cid += 1
    roots = np.full(cid, n)
    for i in np.flatnonzero(core):
        roots[comp[i]] = min(roots[comp[i]], i)
    lab = np.full(n, -1, np.int64)
    for i in range(n):
        if core[i]:
            lab[i] = roots[comp[i]]
        else:
            nbr = np.flatnonzero(adj[i] & core)
            if len(nbr):
                lab[i] = min(roots[comp[j]] for j in nbr)
    return densify_labels(lab), core


def canon(labels, core):
    return densify_labels(
        _canonicalize_roots(np.asarray(labels), np.asarray(core)))


def _on_sphere(X, scale):
    """Planar blobs as (lat, lon) radians: scaled about the origin and
    kept off the poles."""
    return np.asarray(X, np.float64) * scale


def _directions(X):
    """Planar blobs as directions: a constant third axis lifts them off
    the origin, so each blob is a cone of directions."""
    X = np.asarray(X, np.float64)
    return np.column_stack([X, np.full(len(X), 3.0)])


def _separated(d):
    X, truth, _c = benchdata.make_separated_blob_data(
        1500, d, n_centers=6, std=0.4, min_sep=8.0, spread=10.0)
    return X, truth


# (metric, data, eps, min_samples): blobs750 and separated blobs in each
# metric's terms.
CASES = {
    "cityblock-blobs750": ("cityblock", "blobs750", 0.35, 10),
    "cityblock-separated": ("cityblock", "separated16", 4.5, 10),
    "cosine-blobs750": ("cosine", "blobs750", 0.004, 10),
    "cosine-separated": ("cosine", "separated16", 0.002, 10),
    "haversine-blobs750": ("haversine", "blobs750", 0.03, 10),
    "haversine-separated": ("haversine", "separated2", 0.02, 10),
}


def case_data(name, blobs750):
    metric, data, eps, ms = CASES[name]
    if data == "blobs750":
        X = blobs750
    else:
        X = _separated(int(data[len("separated"):]))[0]
    if metric == "cosine" and X.shape[1] == 2:
        X = _directions(X)
    if metric == "haversine":
        X = _on_sphere(X, 0.1 if data == "blobs750" else 0.05)
    return X, metric, eps, ms


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_byte_identical_to_jax(blobs750, name):
    X, metric, eps, ms = case_data(name, blobs750)
    D = distances(X, metric)
    margin = np.abs(D - eps).min() / eps
    # Clear of the float32 forms' rounding (a few 2^-24 relative at
    # these magnitudes): the least margin here is 3.9e-6.
    assert margin > 1e-6, margin
    port = DBSCAN(eps=eps, min_samples=ms, metric=metric, block=128,
                  device="cpu").fit(X)
    ref = jax_fit(X, eps=eps, min_samples=ms, metric=metric, block=128)
    assert np.array_equal(port.labels_, ref.labels_)
    assert np.array_equal(port.core_sample_mask_, ref.core_sample_mask_)
    assert port.labels_.max() >= 1
    # User-facing spec kept, the data held in the kernel frame.
    assert port.metric == metric and port.eps == eps
    assert np.array_equal(np.asarray(port.data), np.asarray(ref.data))
    assert port.kernel_eps == ref.kernel_eps
    # And the float64 oracle's clustering.
    ol, oc = oracle(X, metric, eps, ms)
    assert np.array_equal(port.core_sample_mask_, oc)
    assert np.array_equal(canon(port.labels_, port.core_sample_mask_), ol)


@pytest.mark.parametrize("metric", ["cosine", "haversine"])
def test_driver_metric_pinned_against_numpy_oracle(metric):
    """The JAX package's own oracle geometries (tests/test_sweep.py's
    sphere clusters, tests/test_haversine.py's trajectories)."""
    if metric == "cosine":
        rng = np.random.default_rng(7)
        c = rng.normal(size=(4, 8))
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        X = np.concatenate([ci + rng.normal(scale=0.03, size=(120, 8))
                            for ci in c])
        X = X * rng.uniform(0.5, 2.0, size=(len(X), 1))
        eps, ms = 0.02, 5
    else:
        rng = np.random.default_rng(11)
        c = np.column_stack([rng.uniform(-1.2, 1.2, 6),
                             rng.uniform(-2.8, 2.8, 6)])
        X = np.concatenate([ci + rng.normal(scale=0.008, size=(130, 2))
                            for ci in c])
        eps, ms = 0.05, 5
    m = DBSCAN(eps=eps, min_samples=ms, metric=metric, block=128,
               device="cpu").fit(X)
    ol, oc = oracle(X, metric, eps, ms)
    assert np.array_equal(m.core_sample_mask_, oc)
    assert np.array_equal(canon(m.labels_, m.core_sample_mask_), ol)
    assert m.labels_.max() >= 3


def test_driver_frames_are_the_jax_packages(blobs750):
    """``_unit_rows`` and the haversine frame bit for bit, float32 and
    float64 input, and a tensor fit equals the array fit."""
    from pypardis_tpu.dbscan import _unit_rows as jax_unit_rows
    from pypardis_tpu.geometry import latlon_to_unit_sphere as jax_sphere

    X = _directions(blobs750)
    for dt in (np.float32, np.float64):
        a, b = _unit_rows(X.astype(dt)), jax_unit_rows(X.astype(dt))
        assert a.dtype == b.dtype and np.array_equal(a, b)
        L = (blobs750 * 0.1).astype(dt)
        assert np.array_equal(latlon_to_unit_sphere(L), jax_sphere(L))
    a = DBSCAN(eps=0.004, min_samples=10, metric="cosine",
               device="cpu").fit(X)
    b = DBSCAN(eps=0.004, min_samples=10, metric="cosine",
               device="cpu").fit(torch.from_numpy(X))
    assert np.array_equal(a.labels_, b.labels_)
    assert np.array_equal(a.core_sample_mask_, b.core_sample_mask_)


def test_driver_fit_equals_the_euclidean_fit_of_its_frame(blobs750):
    """What ``chip_smoke.py`` phase 9 holds on the card: a cosine or
    haversine fit is the Euclidean fit of the projected rows at
    ``kernel_eps``, byte for byte."""
    for metric, X, eps in (("cosine", _directions(blobs750), 0.004),
                           ("haversine", blobs750 * 0.1, 0.03)):
        m = DBSCAN(eps=eps, min_samples=10, metric=metric,
                   device="cpu").fit(X)
        rows = (_unit_rows(X) if metric == "cosine"
                else latlon_to_unit_sphere(X))
        e = DBSCAN(eps=m.kernel_eps, min_samples=10, device="cpu").fit(rows)
        assert np.array_equal(m.labels_, e.labels_)
        assert np.array_equal(m.core_sample_mask_, e.core_sample_mask_)


@pytest.mark.parametrize("spec,want", [
    ("cityblock", "cityblock"), ("manhattan", "cityblock"),
    ("L1", "cityblock"), ("cosine", "cosine"), ("angular", "cosine"),
    ("haversine", "haversine"), ("l2", "euclidean"),
])
def test_metric_spellings(spec, want):
    from pypardis_tpu.utils.validate import check_metric as jax_check
    from pypardis_tpu_torch.utils.validate import check_metric

    assert check_metric(spec) == jax_check(spec) == want
    assert DBSCAN(eps=0.5, metric=spec, device="cpu")._metric_norm == want


def test_scipy_callables_by_name(blobs750):
    from scipy.spatial.distance import cityblock, cosine

    for fn, name, eps in ((cityblock, "cityblock", 0.35),
                          (cosine, "cosine", 0.004)):
        X = blobs750 if name == "cityblock" else _directions(blobs750)
        a = DBSCAN(eps=eps, min_samples=10, metric=fn, device="cpu").fit(X)
        b = DBSCAN(eps=eps, min_samples=10, metric=name, device="cpu").fit(X)
        assert np.array_equal(a.labels_, b.labels_)


@pytest.mark.parametrize("kw,err,match", [
    ({"metric": "cosine", "eps": 2.5}, ValueError, r"\(0, 2\]"),
    ({"metric": "cosine", "eps": 0.0}, ValueError, "eps"),
    ({"metric": "haversine", "eps": 3.5}, ValueError, "RADIANS"),
    ({"metric": "haversine", "eps": -0.1}, ValueError, "eps"),
    ({"metric": "cityblock", "precision": "mixed"}, ValueError, "euclidean"),
    ({"metric": "manhattan", "kernel_backend": "cuda"}, ValueError,
     "euclidean"),
    ({"metric": "chebyshev"}, ValueError, "metric"),
])
def test_validation(kw, err, match):
    kw = dict({"eps": 0.5, "min_samples": 5, "device": "cpu"}, **kw)
    with pytest.raises(err, match=match):
        DBSCAN(**kw)


def test_jax_raises_the_same_on_mixed_cityblock(blobs750):
    """The JAX package refuses "mixed" with cityblock too (at its fit)."""
    with pytest.raises(ValueError, match="euclidean"):
        jax_fit(blobs750, eps=0.35, min_samples=10, metric="cityblock",
                precision="mixed")


def test_bad_driver_inputs_raise():
    with pytest.raises(ValueError, match="zero"):
        DBSCAN(eps=0.1, metric="cosine", device="cpu").fit(
            np.array([[1.0, 0.0], [0.0, 0.0], [0.0, 1.0]]))
    with pytest.raises(ValueError, match="lat, lon"):
        DBSCAN(eps=0.1, metric="haversine", device="cpu").fit(
            np.zeros((5, 3)))
    with pytest.raises(ValueError, match="NaN"):
        DBSCAN(eps=0.1, metric="cosine", device="cpu").fit(
            np.array([[1.0, np.nan], [0.0, 1.0]]))


def _queries(X, metric, seed=5):
    rng = np.random.default_rng(seed)
    near = X[::4] + rng.normal(scale=0.02 if metric != "cityblock" else 0.1,
                               size=X[::4].shape)
    far = rng.uniform(X.min(0), X.max(0), size=(60, X.shape[1]))
    return np.concatenate([near, far])


@pytest.mark.parametrize("name", ["cityblock-blobs750", "cosine-blobs750",
                                  "haversine-separated"])
def test_predict_bitwise_the_jax_engine(blobs750, name):
    """``predict`` in labels and distances equal to the JAX engine, and
    to the index's brute-force oracle.  Both packages serve every metric
    as the L2 question at ``kernel_eps`` in the model's frame (for
    cityblock that is Euclidean eps: a fact of the reference, ROADMAP
    C)."""
    X, metric, eps, ms = case_data(name, blobs750)
    if metric == "haversine":
        Q = X[::4] + np.random.default_rng(5).normal(scale=0.01,
                                                     size=X[::4].shape)
    else:
        Q = _queries(X, metric)
    port = DBSCAN(eps=eps, min_samples=ms, metric=metric, device="cpu").fit(X)
    ref = jax_fit(X, eps=eps, min_samples=ms, metric=metric)
    kw = dict(leaves=4, block=32, qblock=32)
    want = ref.query_engine(**kw).predict(Q, return_distance=True)
    eng = port.query_engine(**kw)
    got = eng.predict(Q, return_distance=True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert (got[0] >= 0).sum() > len(Q) // 4
    olab, _od2 = eng.index.oracle_predict(Q)
    assert np.array_equal(got[0], olab)
    assert eng.index.projection == {"cosine": "unit", "haversine": "latlon"}.get(
        metric, "none")


@pytest.mark.parametrize("name", ["cityblock-separated", "cosine-blobs750",
                                  "haversine-blobs750"])
def test_jax_checkpoint_loads_serves_and_refits(blobs750, tmp_path, name):
    """A JAX model in each metric, through its checkpoint and through
    ``dbscan_from_reference``: same parameters, ``predict`` byte-identical
    to the JAX engine, and a refit of the loaded model on the raw rows
    gives the checkpoint's labels."""
    X, metric, eps, ms = case_data(name, blobs750)
    ref = jax_fit(X, eps=eps, min_samples=ms, metric=metric, block=128)
    Q = _queries(X, metric)
    kw = dict(leaves=4, block=32, qblock=32)
    want = ref.query_engine(**kw).predict(Q, return_distance=True)
    path = str(tmp_path / "model.npz")
    jckpt.save_model(ref, path)
    loaded = load_model(path, device="cpu")
    carried = dbscan_from_reference(
        {"eps": eps, "min_samples": ms, "metric": metric, "block": 128},
        ref.data, ref.labels_, ref.core_sample_mask_, device="cpu")
    for model in (loaded, carried):
        assert model.metric == metric and model.eps == eps
        got = model.query_engine(**kw).predict(Q, return_distance=True)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(model.labels_, ref.labels_)
    for box in ("lower", "upper"):
        assert np.array_equal(getattr(carried.expanded_boxes[0], box),
                              getattr(ref.expanded_boxes[0], box))
    loaded.fit(X)
    assert np.array_equal(loaded.labels_, ref.labels_)
    assert np.array_equal(loaded.core_sample_mask_, ref.core_sample_mask_)


@pytest.mark.parametrize("metric", ["cityblock", "cosine", "haversine"])
def test_port_checkpoint_loads_in_jax(blobs750, tmp_path, metric):
    """The other way: a port model in each metric loads in the JAX
    package and serves what the port serves."""
    name = {"cityblock": "cityblock-blobs750", "cosine": "cosine-blobs750",
            "haversine": "haversine-blobs750"}[metric]
    X, metric, eps, ms = case_data(name, blobs750)
    port = DBSCAN(eps=eps, min_samples=ms, metric=metric, device="cpu").fit(X)
    path = str(tmp_path / "port.npz")
    port.save(path)
    ref = jckpt.load_model(path)
    assert ref.metric == metric
    Q = _queries(X, metric)
    kw = dict(leaves=4, block=32, qblock=32)
    got = port.query_engine(**kw).predict(Q, return_distance=True)
    want = ref.query_engine(**kw).predict(Q, return_distance=True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
