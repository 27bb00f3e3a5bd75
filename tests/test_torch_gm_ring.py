"""The global-Morton mesh engine's boundary exchange, held bitwise
against the JAX package on the CPU: the box test ``cross_tile_live``,
the tile compaction ``_keep_tiles``, the Morton-range shard build, the
exact capacity plan, the send selection (sketch off, and k = 16 at
d = 256 with the mesh-wide norm band), the whole exchange's ``(bnd,
bmsk, bgid)`` and counts at P = 4 and 8 (also with capacities that
overflow), and the overlapped counts split ``oc_raw_counts +
oc_counts_delta`` against the fused owner counts.

The JAX engine runs on the conftest's faked CPU devices
(``default_mesh(P)``), the port on ``Mesh(["cpu"] * P)``; the port's
``(k, rows)`` slabs are the JAX ``(rows, k)`` ones transposed.  One
bound, not a bit: the sketch slab's projection is a float64 product
rounded once (the JAX one a float32 HIGHEST product), held within 1e-6
relative, and the tile decisions it feeds are held equal on these
data."""

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec
from sklearn.datasets import make_blobs

import benchdata
from pypardis_tpu.ops import distances as jax_dist
from pypardis_tpu.ops import labels as jax_labels
from pypardis_tpu.parallel import default_mesh
from pypardis_tpu.parallel import global_morton as jax_gm
from pypardis_tpu.parallel import halo as jax_halo
from pypardis_tpu.parallel import staging as jax_staging
from pypardis_tpu_torch.ops import distances as dist
from pypardis_tpu_torch.ops import labels as oc
from pypardis_tpu_torch.parallel import global_morton as gm
from pypardis_tpu_torch.parallel import halo, staging
from pypardis_tpu_torch.parallel.mesh import Mesh


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


def _blobs16():
    X, _ = make_blobs(n_samples=3000, centers=8, n_features=16,
                      cluster_std=1.0, random_state=5)
    return X.astype(np.float32), 2.0, 128


def _blobs3():
    X, _ = make_blobs(n_samples=2000, centers=6, n_features=3,
                      cluster_std=0.3, random_state=3)
    return X, 0.4, 128


def _wide256():
    X, _, _ = benchdata.make_separated_blob_data(
        1200, 256, n_centers=6, min_sep=30.0, spread=30.0, seed=2)
    return X.astype(np.float32), 9.0, 128


def _shards(X, P, block, eps):
    """Both packages' owned shards of ``X`` over ``P`` devices."""
    mesh = default_mesh(P)
    sharding = NamedSharding(mesh, PartitionSpec("p"))
    j_arr, j_aux, _b, _k = jax_gm.build_morton_shards(X, P, block, sharding,
                                                      eps=eps)
    p_mesh = Mesh(["cpu"] * P)
    p_arr, p_aux, _b, _k = gm.build_morton_shards(X, P, block, p_mesh,
                                                  eps=eps)
    return (mesh, j_arr, j_aux), (p_mesh, p_arr, p_aux)


def _np(a):
    return np.asarray(a)


# -- the box test and the compaction ----------------------------------------


@pytest.mark.parametrize("eps", [0.05, 0.5, 3.0])
def test_cross_tile_live_matches_jax(eps):
    rng = np.random.default_rng(11)
    lo_r = rng.normal(size=(37, 5)).astype(np.float32)
    hi_r = lo_r + rng.uniform(0, 0.4, size=lo_r.shape).astype(np.float32)
    lo_c = rng.normal(size=(91, 5)).astype(np.float32)
    hi_c = lo_c + rng.uniform(0, 0.4, size=lo_c.shape).astype(np.float32)
    # Inverted boxes (empty tiles, a shard's own) are never live.
    lo_r[3], hi_r[3] = 3e38, -3e38
    lo_c[:5], hi_c[:5] = 3e38, -3e38
    want = _np(jax_dist.cross_tile_live(lo_r, hi_r, lo_c, hi_c, eps))
    got = dist.cross_tile_live(*(torch.from_numpy(a) for a in
                                 (lo_r, hi_r, lo_c, hi_c)), eps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[3]
    assert 0 < int(got.sum()) < len(got) or eps == 3.0


def test_keep_tiles_matches_jax():
    rng = np.random.default_rng(12)
    for n, cap in ((40, 10), (40, 40), (17, 3), (8, 8)):
        val = rng.random(n) < 0.4
        j_order, j_kept, j_drop = jax_halo._keep_tiles(val, cap)
        order, kept, drop = halo._keep_tiles(torch.from_numpy(val), cap)
        np.testing.assert_array_equal(order.numpy(), _np(j_order))
        np.testing.assert_array_equal(kept.numpy(), _np(j_kept))
        assert int(drop) == int(j_drop)


def test_sketch_slab_within_a_ulp_bound_of_jax():
    X, _eps, block = _wide256()
    tiles = torch.from_numpy(X[:4 * block].reshape(4, block, -1)
                             ).transpose(1, 2).contiguous()
    from pypardis_tpu_torch.ops.sketch import sketch_matrix

    q, _eta = sketch_matrix(X.shape[1], 16)
    want = _np(jax_dist._sketch_slab_t(tiles.numpy(), q))
    got = dist.sketch_slab_t(tiles, q).numpy()
    assert got.shape == want.shape == (4, 17, block)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# -- the shard build and the plan --------------------------------------------


@pytest.mark.parametrize("P", [4, 8])
def test_morton_shards_match_jax(P):
    X, eps, block = _blobs16()
    (_m, j_arr, j_aux), (_pm, p_arr, p_aux) = _shards(X, P, block, eps)
    for s in range(P):
        np.testing.assert_array_equal(p_arr[0][s].numpy().T,
                                      _np(j_arr[0])[s])
        np.testing.assert_array_equal(p_arr[1][s].numpy(), _np(j_arr[1])[s])
        np.testing.assert_array_equal(p_arr[2][s].numpy(), _np(j_arr[2])[s])
    for key in ("owned_cap", "n_shard_partitions", "pad_waste",
                "partition_sizes"):
        assert p_aux[key] == j_aux[key], key
    for key in ("starts", "box_lo", "box_hi"):
        assert p_aux["parity"][key] == j_aux["parity"][key], key
    np.testing.assert_array_equal(p_aux["parity"]["order"],
                                  j_aux["parity"]["order"])


@pytest.mark.parametrize("P", [4, 8])
def test_capacity_plan_matches_jax(P):
    X, eps, block = _blobs16()
    (mesh, j_arr, _ja), (p_mesh, p_arr, _pa) = _shards(X, P, block, eps)
    j_send, j_recv = jax_gm._gm_plan_step(
        j_arr[0], j_arr[1], np.float32(eps), gtile=block, mesh=mesh,
        axis="p")
    send, recv = gm._gm_plan_step(p_arr[0], p_arr[1], eps, gtile=block,
                                  mesh=p_mesh)
    np.testing.assert_array_equal(send, _np(j_send))
    np.testing.assert_array_equal(recv, _np(j_recv))
    assert send.sum() > 0 and recv.sum() > 0


# -- the selection -------------------------------------------------------------


@pytest.mark.parametrize("case", ["sketch0", "sketch16_d256"])
def test_select_step_matches_jax(case):
    X, eps, block = _blobs16() if case == "sketch0" else _wide256()
    sk = 0 if case == "sketch0" else 16
    P = 4
    (mesh, j_arr, j_aux), (p_mesh, p_arr, _pa) = _shards(X, P, block, eps)
    nt = j_aux["owned_cap"] // block
    bt, bc = max(1, nt // 2), nt
    want = jax_gm._gm_select_step(
        *j_arr, np.float32(eps), gtile=block, btcap=bt, bcap=bc, mesh=mesh,
        axis="p", sketch=sk)
    got = gm._gm_select_step(*p_arr, eps, gtile=block, btcap=bt, bcap=bc,
                             mesh=p_mesh, sketch=sk)
    # The (T, k, g) tile buffers are the JAX (T, g, k) transposed.
    turned = {0, 10}
    for i, w in enumerate(want):
        w = _np(w)
        for s in range(P):
            g = got[s][i].numpy()
            if i in turned:
                g = g.transpose(0, 2, 1)
            np.testing.assert_array_equal(g, w[s], err_msg=f"output {i}")
    n_send = [int(got[s][5]) for s in range(P)]
    n_box = [int(got[s][9]) for s in range(P)]
    assert sum(n_send) > 0
    # The sketch test only ANDs into the full-d test.
    assert all(a <= b for a, b in zip(n_send, n_box))


# -- the whole exchange ----------------------------------------------------


def _exchange_both(X, eps, block, P, bt=None, bc=None):
    (mesh, j_arr, j_aux), (p_mesh, p_arr, _pa) = _shards(X, P, block, eps)
    if bt is None:
        send, recv = gm._gm_plan_step(p_arr[0], p_arr[1], eps, gtile=block,
                                      mesh=p_mesh)
        bt, bc = max(1, int(send.max())), max(1, int(recv.max()))
    want = jax_gm._gm_exchange(j_arr, np.float32(eps), mesh=mesh, axis="p",
                               gtile=block, bt=bt, bc=bc)
    got = gm._gm_exchange(p_arr, eps, mesh=p_mesh, gtile=block, bt=bt,
                          bc=bc)
    return want, got


@pytest.mark.parametrize("P", [4, 8])
def test_exchange_products_match_jax_bitwise(P):
    X, eps, block = _blobs16()
    ((j_b, j_m, j_g), j_x, j_need, j_ovf), ((bnd, bmsk, bgid), x, need,
                                              ovf) = _exchange_both(
        X, eps, block, P)
    assert (need, ovf) == (j_need, j_ovf) and ovf == 0
    for s in range(P):
        np.testing.assert_array_equal(bnd[s].numpy().T, _np(j_b)[s])
        np.testing.assert_array_equal(bmsk[s].numpy(), _np(j_m)[s])
        np.testing.assert_array_equal(bgid[s].numpy(), _np(j_g)[s])
    for key, want in j_x.items():
        if key != "ring_wall_s":
            assert x[key] == want, key
    assert x["boundary_tiles"] > 0 and x["boundary_rows"] > 0


def test_exchange_with_overflowing_capacities_matches_jax():
    """Capacities of one tile: both the send and the receive side drop
    tiles, and the needs and drops come back as the JAX ones."""
    X, eps, block = _blobs16()
    ((j_b, j_m, j_g), j_x, j_need, j_ovf), ((bnd, bmsk, bgid), x, need,
                                              ovf) = _exchange_both(
        X, eps, block, 4, bt=1, bc=1)
    assert (need, ovf) == (j_need, j_ovf)
    assert need > 1 and ovf > 0
    for s in range(4):
        np.testing.assert_array_equal(bnd[s].numpy().T, _np(j_b)[s])
        np.testing.assert_array_equal(bgid[s].numpy(), _np(j_g)[s])
    assert x["sent_tiles"] == j_x["sent_tiles"]


# -- the overlapped counts split --------------------------------------------


def test_owned_plus_delta_equals_the_fused_counts_and_jax(monkeypatch):
    """On each shard's combined ``owned + boundary`` slab: the owned
    slab's raw counts plus the boundary delta equal the fused owner
    counts bitwise, and the delta equals the JAX pass's (its pair-list
    dispatch, which the delta needs)."""
    import jax

    monkeypatch.setenv("PYPARDIS_DISPATCH", "pair")
    jax.clear_caches()
    X, eps, block = _blobs16()
    P = 4
    (mesh, j_arr, j_aux), (p_mesh, p_arr, p_aux) = _shards(X, P, block, eps)
    (j_b, j_m, _jg), *_ = jax_gm._gm_exchange(
        j_arr, np.float32(eps), mesh=mesh, axis="p", gtile=block, bt=64,
        bc=64)
    (bnd, bmsk, _bg), *_ = gm._gm_exchange(p_arr, eps, mesh=p_mesh,
                                           gtile=block, bt=64, bc=64)
    cap = p_aux["owned_cap"]
    kw = dict(owned=cap, metric="euclidean", block=block, precision="high",
              backend="xla")
    delta_total = 0
    for s in range(P):
        pts = torch.cat([p_arr[0][s], bnd[s]], dim=1)
        msk = torch.cat([p_arr[1][s], bmsk[s]])
        ex = oc.oc_extract(pts, eps, msk, owned=cap, block=block)
        own_ex = oc.oc_extract(p_arr[0][s], eps, p_arr[1][s], owned=cap,
                               block=block)
        fused, _ = oc.oc_raw_counts(ex)
        owned_c, _ = oc.oc_raw_counts(own_ex)
        delta, _ = oc.oc_counts_delta(ex)
        np.testing.assert_array_equal((owned_c + delta).numpy(),
                                      fused.numpy())
        delta_total += int(delta.sum())
        j_pts = np.concatenate([_np(j_arr[0])[s], _np(j_b)[s]])
        j_msk = np.concatenate([_np(j_arr[1])[s], _np(j_m)[s]])
        kind, pairs, _st = jax_labels.oc_extract(
            j_pts, eps, j_msk, pair_budget=None, **kw)
        j_delta, _ = jax_labels.oc_counts_delta(
            j_pts, eps, j_msk, kind=kind, pairs=pairs,
            **{k: v for k, v in kw.items() if k != "backend"})
        np.testing.assert_array_equal(delta.numpy(), _np(j_delta))
    assert delta_total > 0
