"""B2's label-bound skip on the CPU, in every precision mode.

The kernels (``csrc/pair_kernels.cu``) cannot run here, so these tests
hold their rule: :func:`minlab_pairs_walk` emulates the kernels' block
walk (running minima, chunk skips, the chunks staged per barrier, the
rows left out of the bound) with the plain versions' own verdicts, and
must return the plain B2's result bitwise, while counting at most every
chunk.  On the card, ``chip_smoke.py`` and ``tests/test_torch_card.py``
hold the kernels' own count equal to the walk's.
"""

import os

import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu_torch import DBSCAN
from pypardis_tpu_torch.dbscan import _stage
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops.distances import (
    INT_INF,
    eps2_f32,
    minlab_group,
    minlab_pairs_walk,
    row_offsets,
)
from pypardis_tpu_torch.ops.labels import _pointer_jump
from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

CPU = torch.device("cpu")
MODES = ("high", "mixed", "default")
EPS = {3: 1.2, 16: 2.4, 64: 4.8, 96: 6.0}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain passes are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _inputs(X, eps, block, min_samples, mode):
    """A fit's B2 inputs under ``mode`` (its layout, pair list, frames
    and core mask) as ``(args, core, mask)``; ``args(labels)`` is the
    plain B2's argument tuple (with the frames its mode takes)."""
    pts, n, block = _stage(X, block, CPU)
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, mode, budget=1 << 20)
    assert total <= budget
    d, N = xs.shape
    tile = ck._pallas_block(block, N, d, mode)
    rp = row_offsets(rows, N // tile)
    e2 = eps2_f32(eps)
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    frames = {"high": (), "mixed": (centers, rnorm),
              "default": (centers,)}[mode]
    mi = mask.to(torch.int32)
    counts = (ck.count_pairs_default(xs, mi, rp, cols, e2, tile, centers)
              if mode == "default" else ck.count_pairs(xs, mi, rp, cols, e2,
                                                       tile))
    core = (torch.clamp_min(torch.where(mask, counts, 0), 1)
            >= min_samples) & mask

    def args(labels):
        return (xs, labels.to(torch.int32).contiguous(), rp, cols, e2,
                tile) + frames
    return args, core, mask


def _plain(mode):
    return ck.PLAIN["minlab_pairs" if mode == "high"
                    else f"minlab_pairs_{mode}"]


def _walk(mode, a, **kw):
    xs, lab, rp, cols, e2, tile, *frames = a
    frames += [None] * (2 - len(frames))
    return minlab_pairs_walk(xs, lab, rp, cols, e2, tile, mode, *frames,
                             **kw)


def _chunks(a, rows_per_block):
    rp, tile = a[2], a[5]
    return int(rp[-1]) * -(-tile // rows_per_block) * -(-tile // 32)


def _rounds(mode, args, core, mask):
    """The fit's round loop (ops/labels.dbscan_fixed_size): per round
    its labels and the live rows the fit passes, to convergence."""
    n = core.shape[0]
    f = torch.where(core, torch.arange(n, dtype=torch.int32), INT_INF)
    live = mask
    out = []
    while True:
        out.append((f, live))
        g = _plain(mode)(*args(f))
        live = mask & (g != INT_INF)
        f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f), core)
        if torch.equal(f_new, f):
            return out
        f = f_new


@pytest.fixture(scope="module", params=sorted(EPS))
def blobs(request):
    """Blobs at d = 3, 16, 64, 96 (both row-register capacities of the
    FP32 kernel, its axis-sliced path and the bf16 kernel's K slices) in
    256-row tiles, with noise points, under every mode."""
    d = request.param
    X, _t = benchdata.make_blob_data(1200, d, n_centers=6, std=0.4, seed=d)
    rng = np.random.default_rng(d)
    noise = rng.uniform(X.min(), X.max(), size=(40, d)).astype(np.float32)
    X = np.concatenate([X, noise])
    return d, {m: _inputs(X, EPS[d], 256, 10, m) for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_walk_equals_plain_b2_bitwise_every_round(blobs, mode):
    """At each round's labels of the fit, with and without the fit's
    live rows, the walk's best is bitwise the plain B2's (INT32_MAX off
    the live rows) and it evaluates at most every chunk."""
    d, inp = blobs
    args, core, mask = inp[mode]
    rounds = _rounds(mode, args, core, mask)
    assert len(rounds) >= 2
    rpb = 256 if mode == "high" else 128
    for f, live in rounds:
        a = args(f)
        plain = _plain(mode)(*a)
        best, ev = _walk(mode, a)
        assert torch.equal(best, plain), (d, mode)
        assert 0 < ev <= _chunks(a, rpb)
        lbest, lev = _walk(mode, a, live_rows=live)
        assert torch.equal(lbest, torch.where(live, plain, INT_INF))
        assert torch.equal(lbest, _plain(mode)(*a, live_rows=live))
        assert lev <= ev


def test_walk_equals_the_jax_pallas_b2_in_interpret_mode():
    """The walk's best against the JAX package's ``_minlab_pairs_kernel``
    run by the interpreter on guard-banded data (no pair near eps, so
    the two d^2 formulations agree on every verdict)."""
    import jax.numpy as jnp
    from pypardis_tpu.ops.pallas_kernels import min_neighbor_label_pallas
    from test_torch_kernels import BLOCK, EPS as KEPS, guard_banded_blobs

    X, mask = guard_banded_blobs(16)
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(np.ascontiguousarray(X.T))
    msk = torch.from_numpy(mask)
    counts = ck.neighbor_counts_cuda(pts, KEPS, msk, block=BLOCK)
    core = (counts >= 8) & msk
    labels = torch.from_numpy(rng.permutation(len(X)).astype(np.int32))
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        pts, KEPS, msk, BLOCK, "high", src_mask=core)
    assert total <= budget
    tile = ck._pallas_block(BLOCK, pts.shape[1], 16, "high")
    lab = torch.where(core, labels, INT_INF).contiguous()
    best, ev = minlab_pairs_walk(pts, lab, row_offsets(rows, len(X) // tile),
                                 cols, eps2_f32(KEPS), tile)
    want = np.asarray(min_neighbor_label_pallas(
        jnp.asarray(X), jnp.asarray(labels.numpy()), KEPS,
        jnp.asarray(core.numpy()), block=BLOCK, precision="highest",
        interpret=True, row_mask=jnp.asarray(mask)))
    assert np.array_equal(best.numpy()[mask], want[mask])
    assert ev > 0 and (best.numpy()[mask] != INT_INF).sum() > len(X) // 2


@pytest.mark.parametrize("mode", MODES)
def test_block_height_and_group_never_change_the_result(blobs, mode):
    """Smaller blocks skip more and larger groups refresh the bound less
    often; neither changes a row's answer."""
    _d, inp = blobs
    args, core, mask = inp[mode]
    f, _live = _rounds(mode, args, core, mask)[-1]
    a = args(f)
    plain = _plain(mode)(*a)
    counts = {}
    for rpb, group in ((32, 1), (64, 2), (256, 8)):
        best, counts[(rpb, group)] = _walk(mode, a, rows_per_block=rpb,
                                           group=group)
        assert torch.equal(best, plain)
        assert counts[(rpb, group)] <= _chunks(a, rpb)
    assert counts[(32, 1)] > 0


def test_minlab_group_follows_the_kernels_staging():
    """Two chunks (the bf16 kernel's 64 columns) in the bf16 modes; one
    on the axis-sliced path past 64 axes; up to eight in 48 KB below."""
    assert minlab_group(16, "mixed") == minlab_group(96, "default") == 2
    assert minlab_group(96, "high") == minlab_group(20000, "highest") == 1
    assert minlab_group(3, "high") == minlab_group(16, "high") == 8
    assert minlab_group(32, "high") == 8
    assert minlab_group(33, "high") == minlab_group(64, "high") == 5


def test_converged_blobs_evaluate_a_small_share_of_chunks():
    """Near-clique blobs over several row tiles, with noise: at
    converged labels a block evaluates its own cluster's first chunks
    and the live tiles of clusters with lower labels once the noise and
    pad rows leave the bound; with them in it the share grows by half
    again, and labels descending in slot order defeat much of the
    skip."""
    X, _t = benchdata.make_blob_data(4096, 16, n_centers=4, std=0.2, seed=1)
    rng = np.random.default_rng(2)
    X = np.concatenate([X, rng.uniform(-30, 30, size=(64, 16)).astype(
        np.float32)])
    args, core, mask = _inputs(X, 2.0, 256, 10, "high")
    rounds = _rounds("high", args, core, mask)
    f, live = rounds[-1]
    a = args(f)
    total = _chunks(a, 256)
    share = _walk("high", a, live_rows=live)[1] / total
    pinned = _walk("high", a)[1] / total
    n = len(f)
    desc = torch.where(core, n - 1 - torch.arange(n, dtype=torch.int32),
                       INT_INF)
    share_desc = _walk("high", args(desc), live_rows=live)[1] / total
    assert share < 0.2 and pinned > 1.5 * share
    assert share_desc > 0.4


def test_live_rows_leave_pad_and_sourceless_rows_at_int32_max():
    """Rows outside the fit's mask (pad slots) and rows whose previous
    pass found no source get INT32_MAX from the plain versions, the walk
    and the wrappers, in every mode."""
    X, _t = benchdata.make_blob_data(900, 16, n_centers=3, std=0.4, seed=4)
    X = np.concatenate([X, np.full((3, 16), 40.0, np.float32)])
    for mode in MODES:
        args, core, mask = _inputs(X, 2.4, 256, 10, mode)
        rounds = _rounds(mode, args, core, mask)
        f, live = rounds[1]
        assert (~mask).any() and (mask & ~live).any()
        a = args(f)
        best, _ev = _walk(mode, a, live_rows=live)
        assert bool((best[~live] == INT_INF).all())
        plain = _plain(mode)(*a)
        assert torch.equal(best[live], plain[live])
        fn = getattr(ck, "minlab_pairs" if mode == "high"
                     else f"minlab_pairs_{mode}")
        assert torch.equal(fn(*a, live_rows=live), best)


@pytest.mark.parametrize("geometry", ["blobs750", "separated"])
def test_fit_with_live_rows_equals_the_jax_fit(geometry):
    """The fit passes its live rows to B2; its labels and core mask stay
    byte-identical to the JAX fit's."""
    from pypardis_tpu import DBSCAN as JaxDBSCAN
    from pypardis_tpu.parallel import default_mesh

    if geometry == "blobs750":
        from sklearn.datasets import make_blobs
        from sklearn.preprocessing import StandardScaler

        X, _ = make_blobs(n_samples=750, centers=[[1, 1], [-1, -1], [1, -1]],
                          cluster_std=0.4, random_state=0)
        X = StandardScaler().fit_transform(X).astype(np.float32)
        kw = dict(eps=0.3, min_samples=10)
    else:
        rng = np.random.default_rng(5)
        centers = rng.uniform(-50, 50, size=(5, 8))
        X = (centers[rng.integers(0, 5, 1500)]
             + rng.normal(scale=0.5, size=(1500, 8))).astype(np.float32)
        X = np.concatenate([X, rng.uniform(-80, 80, size=(30, 8)).astype(
            np.float32)])
        kw = dict(eps=1.6, min_samples=8)
    port = DBSCAN(block=256, device="cpu", **kw).fit(X)
    ref = JaxDBSCAN(kernel_backend="xla", mesh=default_mesh(1), block=256,
                    **kw).fit(X)
    assert np.array_equal(port.labels_, np.asarray(ref.labels_))
    assert np.array_equal(port.core_sample_mask_,
                          np.asarray(ref.core_sample_mask_))
    assert (port.labels_ == -1).any() and port.labels_.max() >= 1


@pytest.mark.parametrize("mode", MODES)
def test_wrapper_adds_the_walks_count_on_the_cpu(blobs, mode):
    """On a CPU tensor each B2 wrapper runs the plain version and, asked
    for the count, adds the walk's; malformed skip arguments are
    refused."""
    _d, inp = blobs
    args, core, mask = inp[mode]
    f, live = _rounds(mode, args, core, mask)[-1]
    a = args(f)
    fn = getattr(ck, "minlab_pairs" if mode == "high"
                 else f"minlab_pairs_{mode}")
    ev = torch.full((1,), 7, dtype=torch.int64)
    out = fn(*a, live_rows=live, evaluated=ev)
    best, walked = _walk(mode, a, live_rows=live)
    assert torch.equal(out, best)
    assert int(ev[0]) == 7 + walked
    with pytest.raises(ValueError, match="evaluated"):
        fn(*a, evaluated=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="live_rows"):
        fn(*a, live_rows=live.to(torch.int32))


def test_chip_smoke_b2_hold_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's B2 rounds at a small size, the wrappers running
    their plain versions: one record per mode, a share per round."""
    records = _b2_rounds(monkeypatch)
    assert [r["name"] for r in records] == [
        "minlab_pairs", "minlab_pairs_mixed", "minlab_pairs_default"]
    for rec in records:
        # The bound is the label-exact floor; the work without the skip
        # is no less.
        assert rec["max_abs_err"] == 0
        assert 0 < rec["floor_ms"] == rec["bound_ms"]
        assert rec["bound_ms"] <= rec["bound_ms_unskipped"]
        shares = rec["evaluated_share_per_round"]
        assert len(shares) == len(rec["ms_per_round"]) >= 2
        assert all(0 < s <= 1 for s in shares)


@pytest.mark.parametrize("mode", MODES)
def test_chip_smoke_b2_hold_fails_on_a_wrong_count(monkeypatch, capsys,
                                                   mode):
    """A B2 kernel whose evaluated count is off by one fails the hold.
    The hold's code is the main path's, at 2,400 points and one row
    tile: on the card it runs at 1M x 16-D on 64 row tiles, but its
    timings and bounds also run B1 and B2 over the whole pair list,
    which the plain versions cannot do on the CPU at that size."""
    with pytest.raises(SystemExit) as exc:
        _b2_rounds(monkeypatch, spoil=mode)
    assert exc.value.code == 1
    assert "evaluated count differs from the walk's" in capsys.readouterr().err


def _b2_rounds(monkeypatch, spoil=None):
    import time

    import chip_smoke

    for name, mode in (("minlab_pairs", "high"),
                       ("minlab_pairs_mixed", "mixed"),
                       ("minlab_pairs_default", "default")):
        def counted(*a, _f=getattr(ck, name), _n=name, _m=mode, **kw):
            ck.LAUNCHES[_n] += 1
            out = _f(*a, **kw)
            if spoil == _m and kw.get("evaluated") is not None:
                kw["evaluated"] += 1
            return out
        monkeypatch.setattr(ck, name, counted)

    def median_ms(fn, reps):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    X, _t = benchdata.make_blob_data(2400, 16, n_centers=4, std=0.4)
    pts, n, block = _stage(X, 2048, CPU)
    xs, mask, _o = _pipeline_layout(pts, 2.4, n, block, sort=True)
    return chip_smoke.b2_rounds(torch, CPU, median_ms, lambda: None, xs,
                                mask, MODES, None,
                                dict(chip_smoke.B2_SIZES, sub_tiles=1,
                                     reps=1))


def test_bindings_match_the_c_prototypes():
    """Each ctypes binding of ``csrc/_build`` takes as many arguments as
    its ``extern "C"`` function in the sources declares (no compiler
    here to catch a mismatch)."""
    import re
    import types

    from pypardis_tpu_torch.csrc import _build

    lib = types.SimpleNamespace()
    declared = {}
    for src in _build.SOURCES:
        with open(os.path.join(os.path.dirname(_build.__file__), src)) as f:
            text = f.read()
        block = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"\nint (pp_\w+)\(([^)]*)\)", block):
            declared[name] = len(params.split(","))
            setattr(lib, name, types.SimpleNamespace())
    _build._bind(lib)
    assert "pp_minlab_pairs" in declared and "pp_minlab_pairs_fast" in declared
    for name, n in declared.items():
        assert len(getattr(lib, name).argtypes) == n, name
