"""The port's ``DBSCAN`` end to end on the CPU: byte parity with the JAX
single-device fit, ARI against sklearn on real data, the input contract,
the device default, the state carried across from the JAX package, and
the import boundary."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import DBSCAN, BoundingBox, DBSCANConfig
from pypardis_tpu_torch.convert import dbscan_from_reference


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_fit(X, **kw):
    """The reference: the JAX package's single-device fit on the CPU
    (conftest fakes 8 devices, so the mesh is pinned to one)."""
    return JaxDBSCAN(kernel_backend="xla", mesh=default_mesh(1), **kw).fit(X)


def test_blobs750_byte_identical(blobs750):
    port = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(blobs750)
    ref = jax_fit(blobs750, eps=0.3, min_samples=10)
    assert np.array_equal(port.labels_, ref.labels_)
    assert np.array_equal(port.core_sample_mask_, ref.core_sample_mask_)
    assert port.labels_.dtype == np.int32
    assert port.metrics_["kernel_passes"] >= 2
    assert port.metrics_["live_pairs"] >= 1


@pytest.mark.parametrize("n,d,block,eps", [
    (4000, 16, 128, 2.4),   # Morton sort + segment-break layout
    (6000, 3, 256, 0.9),
    (3000, 64, 128, 4.0),   # d > 32: top-variance Morton axes
])
def test_separated_blobs_byte_identical(n, d, block, eps):
    wide = d >= 64
    X, truth, _ = benchdata.make_separated_blob_data(
        n, d, n_centers=8, std=0.3 if wide else 0.4,
        min_sep=12.0 if wide else 8.0, spread=20.0 if wide else 10.0,
    )
    port = DBSCAN(eps=eps, min_samples=10, block=block, device="cpu").fit(X)
    ref = jax_fit(X, eps=eps, min_samples=10, block=block)
    assert np.array_equal(port.labels_, ref.labels_)
    assert np.array_equal(port.core_sample_mask_, ref.core_sample_mask_)
    assert port.metrics_["live_pairs"] == ref.metrics_["live_pairs"]
    assert port.metrics_["kernel_passes"] == ref.metrics_["kernel_passes"]
    assert benchdata.ari_vs_truth(port.labels_, truth) == 1.0


def test_tensor_input_matches_host_input(blobs750):
    """A tensor is centred where it lies, in its own dtype (the analogue
    of fitting a device-resident jax.Array)."""
    X32 = blobs750.astype(np.float32)
    a = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(X32)
    b = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(
        torch.from_numpy(X32)
    )
    assert np.array_equal(a.labels_, b.labels_)
    assert np.array_equal(a.core_sample_mask_, b.core_sample_mask_)
    assert b.bounding_boxes[0] == a.bounding_boxes[0]


def test_integer_tensor_fit_matches_numpy_and_reference_fits():
    """An integer tensor is promoted before its mean, as ``jnp.mean``
    promotes, and fits as its numpy array does in both packages."""
    torch.manual_seed(0)
    X = torch.randint(0, 20, (300, 3), dtype=torch.int32)
    kw = dict(eps=2.5, min_samples=3)
    got = DBSCAN(**kw, device="cpu").fit(X)
    host = DBSCAN(**kw, device="cpu").fit(X.numpy())
    ref = jax_fit(X.numpy(), **kw)
    for other in (host, ref):
        assert np.array_equal(got.labels_, other.labels_)
        assert np.array_equal(got.core_sample_mask_, other.core_sample_mask_)
    assert got.labels_.max() >= 1


def test_optdigits_ari_vs_sklearn():
    """Real data, the config of tests/test_realdata.py; ARI >= 0.99 is
    the repo's bar for the reference as well."""
    from sklearn.cluster import DBSCAN as SkDBSCAN
    from sklearn.metrics import adjusted_rand_score

    X, _y, _meta = benchdata.load_real_dataset(download=False)
    port = DBSCAN(eps=22.0, min_samples=5, device="cpu").fit(X)
    sk = SkDBSCAN(eps=22.0, min_samples=5).fit(X)
    assert adjusted_rand_score(sk.labels_, port.labels_) >= 0.99


def test_keyed_records_match_reference():
    rng = np.random.default_rng(4)
    X, _t, _c = benchdata.make_separated_blob_data(600, 4, n_centers=4)
    keys = rng.permutation(10_000)[:600]
    records = [(int(k), X[i]) for i, k in enumerate(keys)]
    port = DBSCAN(eps=1.5, min_samples=5, device="cpu").train(records)
    ref = JaxDBSCAN(eps=1.5, min_samples=5, kernel_backend="xla",
                    mesh=default_mesh(1)).train(records)
    assert port.assignments() == ref.assignments()
    assert port.cluster_dict == ref.cluster_dict
    assert port.bounding_boxes[0] == BoundingBox(
        lower=ref.bounding_boxes[0].lower, upper=ref.bounding_boxes[0].upper
    )
    assert port.expanded_boxes[0] == BoundingBox(
        lower=ref.expanded_boxes[0].lower, upper=ref.expanded_boxes[0].upper
    )
    assert np.array_equal(port.neighbors[0], ref.neighbors[0])


def test_convert_round_trip(blobs750):
    ref = jax_fit(blobs750, eps=0.3, min_samples=10)
    params = {  # the params dict the JAX package's checkpoints store
        "eps": ref.eps, "min_samples": ref.min_samples, "metric": ref.metric,
        "max_partitions": ref.max_partitions,
        "split_method": ref.split_method, "block": ref.block,
        "precision": ref.precision, "kernel_backend": ref.kernel_backend,
    }
    port = dbscan_from_reference(
        params, blobs750, ref.labels_, ref.core_sample_mask_, device="cpu"
    )
    assert port.assignments() == ref.assignments()
    assert port.cluster_dict == ref.cluster_dict
    assert (port.eps, port.min_samples, port.block) == (0.3, 10, 1024)
    # The carried model refits to the same state.
    refit = DBSCAN(eps=port.eps, min_samples=port.min_samples,
                   device="cpu").fit(blobs750)
    assert refit.assignments() == port.assignments()


def test_config_round_trip():
    cfg = DBSCANConfig(eps=0.7, min_samples=3, device="cpu")
    assert DBSCANConfig.from_dict(cfg.to_dict()) == cfg
    model = cfg.build()
    assert (model.eps, model.min_samples, model.device.type) == (
        0.7, 3, "cpu"
    )


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_tiny_inputs(n):
    X = np.random.default_rng(n).normal(size=(n, 3))
    port = DBSCAN(eps=0.5, min_samples=2, device="cpu").fit(X)
    assert port.labels_.shape == (n,)
    if n:
        ref = jax_fit(X, eps=0.5, min_samples=2)
        assert np.array_equal(port.labels_, ref.labels_)


def test_bounding_box_matches_reference():
    from pypardis_tpu.geometry import BoundingBox as JaxBox

    rng = np.random.default_rng(9)
    lo, hi = -rng.random(3), rng.random(3)
    a, ja = BoundingBox(lo, hi), JaxBox(lo, hi)
    b, jb = BoundingBox(lo + 0.5, hi + 0.5), JaxBox(lo + 0.5, hi + 0.5)
    pairs = [
        (a.union(b), ja.union(jb)),
        (a.intersection(b), ja.intersection(jb)),
        (a.expand(0.3), ja.expand(0.3)),
        (a.expand(0.3, how="multiply"), ja.expand(0.3, how="multiply")),
        (BoundingBox(k=3, all_space=True), JaxBox(k=3, all_space=True)),
        (BoundingBox(k=3).union(a), JaxBox(k=3).union(ja)),
        *zip(a.split(1, 0.0), ja.split(1, 0.0)),
    ]
    for p, q in pairs:
        assert np.array_equal(p.lower, q.lower)
        assert np.array_equal(p.upper, q.upper)
    pts = rng.normal(size=(50, 3))
    assert np.array_equal(a.contains_points(pts), ja.contains_points(pts))
    assert BoundingBox(k=3, all_space=True).contains(-1e300 * np.ones(3))
    assert a.volume() == ja.volume()
    with pytest.raises(ValueError, match="how"):
        a.expand(1.0, how="scale")


def test_morton_plan_matches_reference():
    from pypardis_tpu.partition import morton_plan as jax_plan
    from pypardis_tpu_torch.partition import morton_plan

    for d in range(0, 130):
        assert morton_plan(d) == jax_plan(d), d


# -- the input contract of tests/test_validation.py ----------------------


@pytest.fixture()
def X():
    return np.random.default_rng(0).normal(size=(64, 3))


@pytest.mark.parametrize("eps", [0.0, -0.3, float("nan"), float("inf")])
def test_rejects_bad_eps(eps):
    with pytest.raises(ValueError, match="eps"):
        DBSCAN(eps=eps, min_samples=5, device="cpu")


@pytest.mark.parametrize("min_samples", [0, -1])
def test_rejects_bad_min_samples(min_samples):
    with pytest.raises(ValueError, match="min_samples"):
        DBSCAN(eps=0.5, min_samples=min_samples, device="cpu")


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_rejects_nonfinite_coordinates(X, bad):
    X = X.copy()
    X[17, 1] = bad
    with pytest.raises(ValueError, match="NaN or infinite"):
        DBSCAN(eps=0.5, min_samples=5, device="cpu").fit(X)
    with pytest.raises(ValueError, match="NaN or infinite"):
        DBSCAN(eps=0.5, min_samples=5, device="cpu").fit(
            torch.from_numpy(X.astype(np.float32))
        )


@pytest.mark.parametrize("kw,match", [
    ({"precision": "hgih"}, "precision"),
    ({"kernel_backend": "pallas"}, "kernel_backend"),
    ({"metric": "chebyshev"}, "metric"),
    ({"metric": "sqeuclidean"}, "sqeuclidean"),
    ({"device": "meta"}, "device"),
])
def test_rejects_unknown_options(kw, match):
    with pytest.raises(ValueError, match=match):
        DBSCAN(eps=0.5, min_samples=5, **{"device": "cpu", **kw})


@pytest.mark.parametrize("case", ["eps_none", "sweep_auto"])
def test_unported_options_name_their_roadmap_item(case):
    """The options that once raised naming ROADMAP A14 now run: the
    eps-free hierarchy (``eps=None``) and its sweep ladder
    (``sweep(eps_list="auto")``), as the JAX package runs them
    (``tests/test_torch_hierarchy.py`` holds them against it)."""
    X = np.random.default_rng(0).normal(size=(64, 2))
    if case == "eps_none":
        m = DBSCAN(eps=None, min_samples=5, device="cpu").fit(X)
        assert m.eps is None and m.eps_ > 0
        assert m.labels_.shape == (64,)
    else:
        res = DBSCAN(eps=0.5, min_samples=5, device="cpu").sweep(X, "auto")
        assert res.stats["eps_source"] == "hierarchy_auto"
        assert max(res.stats["ladder"]) <= 0.5 * (1 + 1e-6)


@pytest.mark.parametrize("precision", ["mixed", "DEFAULT"])
def test_bf16_precision_modes_validate_and_fit(blobs750, precision):
    """Both bf16 modes validate (case-folded, as the JAX package does)
    and fit: "mixed" to the "high" labels byte for byte with its band
    telemetry, the lossy "default" to within ARI 0.99 of them with
    none."""
    from sklearn.metrics import adjusted_rand_score

    model = DBSCAN(eps=0.3, min_samples=10, device="cpu",
                   precision=precision)
    assert model.precision == precision.lower()
    model.fit(blobs750)
    high = DBSCAN(eps=0.3, min_samples=10, device="cpu").fit(blobs750)
    if precision == "mixed":
        assert np.array_equal(model.labels_, high.labels_)
        assert np.array_equal(model.core_sample_mask_,
                              high.core_sample_mask_)
        assert model.metrics_["band_pairs"] > 0
        assert model.metrics_["rescored_tiles"] > 0
    else:
        assert adjusted_rand_score(model.labels_, high.labels_) >= 0.99
        assert model.metrics_["band_pairs"] == 0
        assert model.metrics_["rescored_tiles"] == 0


def test_scipy_callable_metric_accepted(X):
    from scipy.spatial.distance import euclidean

    labels = DBSCAN(eps=0.5, min_samples=3, metric=euclidean,
                    device="cpu").fit_predict(X)
    assert labels.shape == (len(X),)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DBSCAN(eps=0.5, min_samples=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DBSCAN(eps=0.5, min_samples=5, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DBSCANConfig(eps=0.5).build()


# -- the import boundary ---------------------------------------------------


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(
        os.path.join(REPO, "pypardis_tpu_torch")
    ):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pypardis_tpu"), (path, mod)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the smoke script exits non-zero and prints
    no result line; alone in a directory it cannot even import the
    port."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    proc = subprocess.run(
        [sys.executable, str(lone)], capture_output=True, text=True,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""), timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
