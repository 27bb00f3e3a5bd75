"""The port's precision modes end to end on the CPU against the JAX
package: ``"mixed"`` fits byte-identical to the JAX package's
``"mixed"`` and ``"high"`` fits (sketch off and on, with band telemetry),
``"default"`` fits byte-identical to the JAX ``"default"`` fit on a
geometry every pair of which lies outside the bf16 band, and with ARI
>= 0.99 against sklearn on real data, the d = 256 sketch under both
modes, and a rehearsal of ``chip_smoke.py``'s phase 8 with the plain
versions standing in for the kernels.  The heavy tests live here, apart
from the unit tests of tests/test_torch_precision.py, so that xdist
spreads them.
"""

import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu import DBSCAN as JaxDBSCAN
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu_torch import DBSCAN
from test_torch_precision import adversarial


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


def lattice(seed=0):
    """A jittered integer lattice in 3-D (two slabs, 70 % of the sites,
    three isolated points): every pair's d^2 lies at least 0.45 from
    eps^2 = 23 (checked in float64 by the test that uses it), far outside
    the bf16 band of its tiles (radius ~5: band_halfwidth ~ 0.2 plus an
    exact slack ~ 0.01), so a bf16 pass and an exact pass agree on every
    verdict."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3).astype(np.float64)
    g = g[(g[:, 0] < 5) | (g[:, 0] > 10)]
    g = g[rng.random(len(g)) < 0.7]
    noise = np.array([[30, 30, 30], [-20, 5, 5], [7.5, 40, 3]], float)
    X = np.concatenate([g, noise])
    return (X + rng.normal(scale=0.01, size=X.shape)).astype(np.float32)


def _geometry(name):
    if name == "blobs750":
        from sklearn.datasets import make_blobs
        from sklearn.preprocessing import StandardScaler

        X, _ = make_blobs(n_samples=750, centers=[[1, 1], [-1, -1], [1, -1]],
                          cluster_std=0.4, random_state=0)
        return StandardScaler().fit_transform(X), 0.3, 10, 1024
    if name == "separated":
        X, _t, _ = benchdata.make_separated_blob_data(
            4000, 16, n_centers=8, std=0.4, min_sep=8.0, spread=10.0)
        return X, 2.4, 10, 128
    return adversarial(offset=1e3), 0.9, 6, 256


def _same(a, b):
    assert np.array_equal(a.labels_, b.labels_)
    assert np.array_equal(a.core_sample_mask_, b.core_sample_mask_)


@pytest.mark.parametrize("geom", ["blobs750", "separated", "adversarial"])
def test_mixed_fits_byte_identical_to_jax(geom):
    X, eps, ms, block = _geometry(geom)
    port = DBSCAN(eps=eps, min_samples=ms, block=block, precision="mixed",
                  device="cpu").fit(X)
    high = DBSCAN(eps=eps, min_samples=ms, block=block, device="cpu").fit(X)
    for mode in ("mixed", "high"):
        _same(port, jax_fit(X, eps=eps, min_samples=ms, block=block,
                            precision=mode))
    _same(port, high)
    assert port.metrics_["band_pairs"] > 0
    assert port.metrics_["rescored_tiles"] > 0
    assert high.metrics_["band_pairs"] == high.metrics_["rescored_tiles"] == 0
    assert port.metrics_["kernel_passes"] == high.metrics_["kernel_passes"]


def test_mixed_sketched_fit_byte_identical_to_jax():
    """Sketch on: the stats are the sketch gate's, as in the JAX
    package, and the labels those of the JAX "mixed" and "high" fits."""
    from test_torch_sketch_fits import _near_eps_shells

    X, eps = _near_eps_shells(n=500, d=160)
    port = DBSCAN(eps=eps, min_samples=5, block=128, precision="mixed",
                  sketch=16, device="cpu").fit(X)
    high = DBSCAN(eps=eps, min_samples=5, block=128, sketch=16,
                  device="cpu").fit(X)
    _same(port, high)
    assert port.metrics_["band_pairs"] == high.metrics_["band_pairs"] > 0
    for mode in ("mixed", "high"):
        _same(port, jax_fit(X, eps=eps, min_samples=5, block=128,
                            precision=mode, sketch=16))


def test_default_fit_byte_identical_to_jax_default_on_guard_banded_data():
    X = lattice()
    x = X.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    assert np.abs(d2 - 23.0).min() > 0.4  # the guard band
    kw = dict(eps=float(np.sqrt(23.0)), min_samples=150, block=256)
    port = DBSCAN(precision="default", device="cpu", **kw).fit(X)
    _same(port, jax_fit(X, precision="default", **kw))
    _same(port, DBSCAN(device="cpu", **kw).fit(X))
    assert port.metrics_["band_pairs"] == 0
    assert 0 < port.core_sample_mask_.sum() < len(X)
    assert (port.labels_ < 0).sum() >= 3


def test_default_fit_optdigits_ari_vs_sklearn():
    from sklearn.cluster import DBSCAN as SkDBSCAN
    from sklearn.metrics import adjusted_rand_score

    X, _y, _meta = benchdata.load_real_dataset(download=False)
    port = DBSCAN(eps=22.0, min_samples=5, precision="default",
                  device="cpu").fit(X)
    sk = SkDBSCAN(eps=22.0, min_samples=5).fit(X)
    assert adjusted_rand_score(sk.labels_, port.labels_) >= 0.99


@pytest.mark.parametrize("mode", ["mixed", "default"])
def test_sketch_d256_under_both_modes(mode):
    """At d = 256 the default sketch runs B3/B4 with the mode's band:
    "mixed" is byte-identical to "high"; "default" (tile 1024 where the
    others take 512 at d = 512, here the same) rescores in bf16 and
    stays within ARI 0.99 of it."""
    X, truth = benchdata.make_embedding_data(1500, 256, seed=2)
    kw = dict(eps=2.0, min_samples=10, block=512, device="cpu")
    high = DBSCAN(**kw).fit(X)
    port = DBSCAN(precision=mode, **kw).fit(X)
    assert port.metrics_["sketch_k"] == high.metrics_["sketch_k"] == 64
    assert port.metrics_["band_pairs"] > 0
    if mode == "mixed":
        _same(port, high)
        assert port.metrics_["band_pairs"] == high.metrics_["band_pairs"]
    else:
        assert benchdata.ari_vs_truth(port.labels_, high.labels_) >= 0.99
        assert benchdata.ari_vs_truth(port.labels_, truth) >= 0.99


def test_default_tile_at_512_dims():
    from pypardis_tpu.ops.pallas_kernels import _pallas_block
    from pypardis_tpu_torch.ops.cuda_kernels import _pallas_block as pb

    for mode, tile in (("default", 1024), ("mixed", 512), ("high", 512)):
        assert pb(2048, 1 << 20, 512, mode) == tile
        assert _pallas_block(2048, 1 << 20, 512, mode) == tile


def _precision_phase(monkeypatch, wrong=None):
    """Phase 8 of chip_smoke.py at small sizes, the kernels' wrappers
    running their plain versions and counting their calls as launches
    (on the card each call is one launch).  ``wrong`` names a wrapper
    whose output on the 1M fit's staged inputs (phase 8's (4)) is
    spoiled on one row.  Returns the phase's kernel records."""
    import time

    import chip_smoke
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout
    from pypardis_tpu_torch.ops.query import (
        brute_force_query, query_pass_pairs,
    )

    def counting(name):
        fn = getattr(ck, name)

        def counted(*a, **kw):
            mode = a[9] if name.endswith("sketch") and len(a) > 9 else "high"
            key = name if mode in ("high", "highest") else f"{name}_{mode}"
            if name == "query_leaf":
                key += "_mixed" if kw.get("precision") == "mixed" else ""
            ck.LAUNCHES[key] += 1
            out = fn(*a, **kw)
            if name == wrong and a[0] is xs:
                return spoil(name, out, a[1])
            return out
        return counted

    def spoil(name, out, colval):
        """The first valid row (in the first row tile, which the
        sub-list covers) off by far more than any bracket allows."""
        counts = out[0] if isinstance(out, tuple) else out
        counts = counts.clone()
        i = int(torch.nonzero(mask)[0])
        counts[i] = -5 if name.startswith("minlab") else counts[i] + 1000
        return (counts, out[1]) if isinstance(out, tuple) else counts

    for name in ("count_pairs", "minlab_pairs", "count_pairs_mixed",
                 "minlab_pairs_mixed", "count_pairs_default",
                 "minlab_pairs_default", "count_pairs_sketch",
                 "minlab_pairs_sketch", "query_leaf"):
        monkeypatch.setattr(ck, name, counting(name))
    real_init = DBSCAN.__init__

    def on_cpu(self, *a, **kw):
        kw.setdefault("device", "cpu")
        real_init(self, *a, **kw)

    monkeypatch.setattr(DBSCAN, "__init__", on_cpu)

    def median_ms(fn, reps):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    dev = torch.device("cpu")
    X, truth = benchdata.make_blob_data(2400, 16, n_centers=4, std=0.4)
    model = DBSCAN(eps=2.4, min_samples=10, block=2048).fit(X)
    pts, n, block = _stage(X, 2048, dev)
    xs, mask, _owner = _pipeline_layout(pts, 2.4, n, block, sort=True)
    eng = model.query_engine()
    rng = np.random.default_rng(1)
    batches = [X[rng.integers(0, n, 200)]
               + rng.normal(scale=0.3, size=(200, 16)).astype(np.float32)
               for _ in range(3)]
    tickets = [eng.submit(b) for b in batches]
    eng.drain()
    idx = eng.index
    sel = idx.labels != np.iinfo(np.int32).max
    olab, od2 = brute_force_query(
        idx.prepare_queries(np.concatenate(batches)[:512]),
        idx.coords[:, sel].T, idx.labels[sel], idx.eps)
    qbuf, tl, rowmap = idx.assemble(idx.prepare_queries(batches[2]))
    coords, labels, _blo, _bhi = idx.device_tensors()
    served = dict(
        engine=eng, batches=batches, olab=olab, od2=od2, rowmap=rowmap,
        lab=np.concatenate([t.result() for t in tickets]),
        d2=np.concatenate([t.d2 for t in tickets]),
        tiles=(torch.from_numpy(qbuf), torch.from_numpy(tl), coords, labels),
        fill=dict(chip_smoke.b5_fill(idx, tl, rowmap, qbuf.shape[2]),
                  pass_pairs=query_pass_pairs(
                      torch.from_numpy(qbuf), torch.from_numpy(tl),
                      idx.kernel_tables()[1], block=idx.block, nb=idx.nb)),
    )
    X5, t5 = benchdata.make_embedding_data(900, 512)
    onoff = dict(X=X5, truth=t5,
                 model=DBSCAN(eps=2.0, min_samples=10, block=2048).fit(X5))
    sizes = dict(check_n=1200, sketch_n=900, sub_tiles=1, reps=1,
                 dims=(3, 96))
    return chip_smoke.precision_phase(
        torch, dev, median_ms, lambda: None,
        dict(X=X, truth=truth, model=model, xs=xs, mask=mask), served,
        onoff, {"count_pairs": 1.0, "minlab_pairs": 1.0}, sizes)


def test_chip_smoke_precision_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 8 of chip_smoke.py end to end at small sizes."""
    kernels = _precision_phase(monkeypatch)
    names = [k["name"] for k in kernels]
    assert names == [
        "count_pairs_mixed", "count_pairs_default", "minlab_pairs_mixed",
        "minlab_pairs_default", "query_leaf_mixed",
        "count_pairs_sketch_mixed", "minlab_pairs_sketch_mixed",
        "count_pairs_sketch_default", "minlab_pairs_sketch_default",
    ]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for rec in kernels:
        assert keys <= set(rec)
        assert rec["launches"] >= 1 and rec["bound_ms"] > 0
        assert rec["library_ms"] is None
        if "mixed" in rec["name"]:
            assert rec["max_abs_err"] == 0


@pytest.mark.parametrize("wrong", ["count_pairs_mixed", "minlab_pairs_mixed",
                                   "count_pairs_default",
                                   "minlab_pairs_default"])
def test_chip_smoke_precision_phase_holds_the_main_path_inputs(
        monkeypatch, capsys, wrong):
    """A bf16 B1/B2 kernel that is wrong on one row of the 1M fit's
    inputs alone fails phase 8, by its check against the plain version
    there."""
    with pytest.raises(SystemExit) as exc:
        _precision_phase(monkeypatch, wrong=wrong)
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert f"{wrong} disagrees with its plain version" in err
