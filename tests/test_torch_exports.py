"""The port's public surface against the JAX package's: every name of
``pypardis_tpu.__all__`` resolves in ``pypardis_tpu_torch``, the split
helpers and partitioner checkpoints behave as the JAX ones, and
``DBSCAN.from_config`` builds what the config describes."""

import numpy as np
import pytest

import pypardis_tpu
import pypardis_tpu_torch
from pypardis_tpu_torch import DBSCAN, DBSCANConfig, KDPartitioner


@pytest.mark.parametrize("name", pypardis_tpu.__all__)
def test_every_jax_export_resolves_in_the_port(name):
    assert hasattr(pypardis_tpu_torch, name), name


def test_port_all_names_resolve():
    for name in pypardis_tpu_torch.__all__:
        assert hasattr(pypardis_tpu_torch, name), name


def test_version_is_the_ports_own_string():
    v = pypardis_tpu_torch.__version__
    assert isinstance(v, str)
    assert tuple(int(p) for p in v.split(".")) == pypardis_tpu.__version__


@pytest.mark.parametrize("name", ["median_search_split", "mean_var_split"])
def test_split_helpers_match_jax(name):
    values = np.random.default_rng(4).normal(size=501)
    below, boundary = getattr(pypardis_tpu_torch, name)(values)
    want_below, want_boundary = getattr(pypardis_tpu, name)(values)
    assert boundary == want_boundary
    np.testing.assert_array_equal(below, want_below)


def test_min_var_split_matches_jax():
    pts = np.random.default_rng(5).normal(size=(400, 3)) * [1.0, 3.0, 0.5]
    axis, below, boundary = pypardis_tpu_torch.min_var_split(pts)
    want = pypardis_tpu.min_var_split(pts)
    assert (axis, boundary) == (want[0], want[2])
    np.testing.assert_array_equal(below, want[1])


def test_partitioner_checkpoint_round_trip(tmp_path):
    X = np.random.default_rng(6).normal(size=(600, 2))
    part = KDPartitioner(X, max_partitions=8)
    path = str(tmp_path / "part.npz")
    pypardis_tpu_torch.save_partitioner(part, path)
    tree = pypardis_tpu_torch.load_partitioner(path)
    np.testing.assert_array_equal(tree.route(X), part.result)


def test_from_config_builds_the_configured_model():
    cfg = DBSCANConfig(eps=0.7, min_samples=4, block=256, device="cpu")
    model = DBSCAN.from_config(cfg)
    assert isinstance(model, DBSCAN)
    assert (model.eps, model.min_samples) == (0.7, 4)
    X = np.random.default_rng(7).normal(size=(300, 2))
    np.testing.assert_array_equal(
        model.fit(X).labels_, cfg.build().fit(X).labels_)


def test_parallel_exports_sharded_dbscan():
    from pypardis_tpu_torch import parallel
    from pypardis_tpu_torch.parallel.sharded import sharded_dbscan

    assert parallel.sharded_dbscan is sharded_dbscan
    assert "sharded_dbscan" in parallel.__all__


def test_config_sharding_fields_round_trip_and_build_on_a_mesh():
    """``DBSCANConfig``'s sharding knobs are the JAX config's fields
    with its defaults; they survive ``to_dict``/``from_dict`` (a JAX
    config's dict loads too) and ``build(mesh=)`` puts the model on the
    mesh."""
    import dataclasses

    from pypardis_tpu.config import DBSCANConfig as JaxConfig
    from pypardis_tpu_torch.parallel import Mesh

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(
        DBSCANConfig)}
    for k in ("max_partitions", "split_method", "owner_computes"):
        assert port_fields[k] == jax_fields[k], k
    cfg = DBSCANConfig(eps=0.6, min_samples=4, max_partitions=6,
                       split_method="mean_var", owner_computes=False,
                       device="cpu")
    back = DBSCANConfig.from_dict(cfg.to_dict())
    assert back == cfg
    assert DBSCANConfig.from_dict(JaxConfig(max_partitions=3).to_dict(
    )).max_partitions == 3
    mesh = Mesh(["cpu"] * 4)
    for model in (cfg.build(mesh=mesh), DBSCAN.from_config(cfg, mesh=mesh)):
        assert model.mesh == mesh and model._n_devices() == 4
        assert (model.max_partitions, model.split_method,
                model.owner_computes) == (6, "mean_var", False)
    assert cfg.build().mesh is None

