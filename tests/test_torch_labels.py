"""``dbscan_fixed_size`` of the port against the JAX package's with
``backend="xla"``: byte-equal labels, core mask, live-pair total and
pass count (the rounds run identically when every round's min-label
pass agrees, which the guard-banded data guarantees — see
tests/test_torch_kernels.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pypardis_tpu.ops import labels as jlabels
from pypardis_tpu_torch.ops import labels as tlabels
from test_torch_kernels import EPS, guard_banded_blobs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


MS = 8


@pytest.fixture(scope="module")
def data():
    return guard_banded_blobs(16)


@pytest.mark.parametrize("max_rounds", [64, 1], ids=["converged", "capped"])
def test_fixed_size_byte_equal(data, max_rounds):
    """``max_rounds=1`` exits by the cap: the border recompute runs and
    counts as a pass in both packages."""
    X, mask = data
    labels, core, stats = tlabels.dbscan_fixed_size(
        torch.from_numpy(np.ascontiguousarray(X.T)), EPS, MS,
        torch.from_numpy(mask), block=256, max_rounds=max_rounds,
    )
    jl, jc, js = jlabels.dbscan_fixed_size(
        jnp.asarray(X.T), EPS, MS, jnp.asarray(mask), block=256,
        max_rounds=max_rounds, backend="xla", layout="dn",
    )
    js = np.asarray(js)
    assert labels.dtype == torch.int32
    assert np.array_equal(labels.numpy(), np.asarray(jl))
    assert np.array_equal(core.numpy(), np.asarray(jc))
    assert int(stats[2]) == int(js[2])  # kernel passes
    assert int(stats[0]) == int(js[0])  # live tile pairs
    assert stats.shape == (5,) and int(stats[3]) == int(stats[4]) == 0
    assert core.any() and (labels[torch.from_numpy(mask)] >= 0).any()
    if max_rounds == 1:
        assert int(stats[2]) == 3  # counts + one round + border recompute


def test_pointer_jump_and_densify_match():
    rng = np.random.default_rng(5)
    n = 300
    active = rng.random(n) < 0.7
    # A forest: every active point points at an active point of lower
    # or equal index, roots point at themselves.
    act_idx = np.flatnonzero(active)
    f = np.full(n, np.iinfo(np.int32).max, np.int32)
    for j, i in enumerate(act_idx):
        f[i] = act_idx[rng.integers(0, j + 1)]
    got = tlabels._pointer_jump(torch.from_numpy(f), torch.from_numpy(active))
    want = jlabels._pointer_jump(jnp.asarray(f), jnp.asarray(active))
    assert np.array_equal(got.numpy(), np.asarray(want))
    roots = np.where(active, got.numpy(), -1)
    assert np.array_equal(
        tlabels.densify_labels(roots), jlabels.densify_labels(roots)
    )


def test_finish_labels_matches():
    rng = np.random.default_rng(2)
    n = 200
    f = rng.integers(0, n, n).astype(np.int32)
    border = np.where(rng.random(n) < 0.5, rng.integers(0, n, n),
                      np.iinfo(np.int32).max).astype(np.int32)
    core = rng.random(n) < 0.3
    mask = rng.random(n) < 0.9
    got = tlabels.finish_labels(*(torch.from_numpy(a)
                                  for a in (f, border, core, mask)))
    want = jlabels.finish_labels(*(jnp.asarray(a)
                                   for a in (f, border, core, mask)))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_resolve_backend():
    assert tlabels.resolve_backend("auto", torch.device("cpu")) == "torch"
    assert tlabels.resolve_backend("torch", "cpu") == "torch"
    assert tlabels.resolve_backend("auto", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="cannot run"):
        tlabels.resolve_backend("cuda", torch.device("cpu"))
    with pytest.raises(ValueError, match="cannot run"):
        tlabels.resolve_backend("torch", torch.device("cuda"))
    with pytest.raises(ValueError, match="kernel_backend"):
        tlabels.resolve_backend("pallas", torch.device("cpu"))


def test_fixed_size_rejects_bad_params():
    pts = torch.zeros((2, 128))
    mask = torch.ones(128, dtype=torch.bool)
    with pytest.raises(ValueError, match="eps"):
        tlabels.dbscan_fixed_size(pts, -1.0, 5, mask, block=128)
    with pytest.raises(ValueError, match="min_samples"):
        tlabels.dbscan_fixed_size(pts, 0.5, 0, mask, block=128)
    with pytest.raises(ValueError, match="precision"):
        tlabels.dbscan_fixed_size(pts, 0.5, 5, mask, block=128,
                                  precision="bf16")


@pytest.mark.parametrize("mode", ["mixed", "default"])
def test_fixed_size_bf16_modes_byte_equal(data, mode):
    """Both bf16 modes against the JAX package's on the guard-banded data
    (no pair within the bf16 band of eps, so "default" decides as the
    exact modes do): labels, core mask, live pairs and passes equal;
    the band stats are the counts pass's under "mixed", zeros under
    "default"."""
    X, mask = data
    labels, core, stats = tlabels.dbscan_fixed_size(
        torch.from_numpy(np.ascontiguousarray(X.T)), EPS, MS,
        torch.from_numpy(mask), block=256, precision=mode,
    )
    jl, jc, js = jlabels.dbscan_fixed_size(
        jnp.asarray(X.T), EPS, MS, jnp.asarray(mask), block=256,
        backend="xla", layout="dn", precision=mode,
    )
    js = np.asarray(js)
    assert np.array_equal(labels.numpy(), np.asarray(jl))
    assert np.array_equal(core.numpy(), np.asarray(jc))
    assert int(stats[0]) == int(js[0]) and int(stats[2]) == int(js[2])
    if mode == "mixed":
        assert int(stats[3]) > 0 and 0 < int(stats[4]) <= int(stats[0])
    else:
        assert int(stats[3]) == int(stats[4]) == 0


def test_pair_budget_overflow_contract(data):
    """A too-small budget is reported in-band exactly as the JAX package
    reports it, and the rerun ladder recovers with the exact total."""
    from pypardis_tpu_torch.utils.budget import run_pair_ladder

    X, mask = data
    pts = torch.from_numpy(np.ascontiguousarray(X.T))
    _l, _c, stats = tlabels.dbscan_fixed_size(
        pts, EPS, MS, torch.from_numpy(mask), block=256, pair_budget=8,
    )
    _jl, _jc, js = jlabels.dbscan_fixed_size(
        jnp.asarray(X.T), EPS, MS, jnp.asarray(mask), block=256,
        backend="xla", layout="dn", pair_budget=8,
    )
    assert int(stats[0]) > int(stats[1]) == 8
    assert int(stats[0]) == int(np.asarray(js)[0])

    budgets = []

    def run_step(pb):
        budgets.append(pb)
        labels, core, st = tlabels.dbscan_fixed_size(
            pts, EPS, MS, torch.from_numpy(mask), block=256,
            pair_budget=8 if pb is None else pb,
        )
        return labels, int(st[0]), int(st[1])

    labels = run_pair_ladder(run_step)
    assert budgets == [None, 4096]
    want, _c, _s = tlabels.dbscan_fixed_size(
        pts, EPS, MS, torch.from_numpy(mask), block=256,
    )
    assert torch.equal(labels, want)
    with pytest.raises(RuntimeError, match="persisted"):
        run_pair_ladder(lambda pb: (None, 100, 8))
