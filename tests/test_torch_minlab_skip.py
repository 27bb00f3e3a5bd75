"""B4's label-bound skip on the CPU.

The kernel (``csrc/sketch_kernels.cu``) cannot run here, so these tests
hold its rule: :func:`minlab_skip_walk` emulates the kernel's block walk
(running minima, chunk skips) with the plain version's own verdicts, and
must return the plain B4's result bitwise at any label state, in the
exact and the bf16 rescore modes, while counting at most every chunk.
On the card, ``chip_smoke.py`` holds the kernel's own count equal to the
walk's.
"""

import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu_torch.dbscan import _stage
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops.distances import (
    INT_INF,
    eps2_f32,
    minlab_over_pairs_sketch,
    minlab_skip_walk,
    row_offsets,
)
from pypardis_tpu_torch.ops.labels import _pointer_jump
from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

CPU = torch.device("cpu")
STATES = ("round1", "converged", "permuted", "descending", "no_source")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain passes are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _inputs(X, eps, block, k, min_samples, mode):
    """A sketched fit's B4 inputs (the fit's layout, slab, pair list and
    core mask) as ``(args, core)``; ``args(labels)`` is the plain B4's
    argument tuple."""
    pts, n, block = _stage(X, block, CPU)
    xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
    slab, band = ck.sketch_stage(xs, mask, k, mode)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, eps, mask, block, mode, budget=1 << 20, sketch=k,
        slab=(slab, band))
    assert total <= budget
    d, N = xs.shape
    tile = ck._pallas_block(block, N, d, mode)
    rp = row_offsets(rows, N // tile)
    centers = ck.tile_frames(xs, mask, tile)[0] if mode == "default" else None
    e2 = eps2_f32(eps)
    counts, _st = ck.count_pairs_sketch(xs, mask.to(torch.int32), rp, cols,
                                        slab, k, e2, band, tile, mode,
                                        ck.pass_frames(xs, mask, tile, mode,
                                                       k)[0])
    core = (torch.clamp_min(torch.where(mask, counts, 0), 1)
            >= min_samples) & mask

    def args(labels):
        return (xs, labels.to(torch.int32).contiguous(), rp, cols, slab, k,
                e2, band, tile, centers)
    return args, core


def _chunks(args, rows_per_block=256):
    """Every (block, 32-column chunk) pair the walk could evaluate."""
    _xs, _lab, rp, _c, _s, _k, _e, _b, tile, _ctr = args(torch.zeros(1))
    return (int(rp[-1]) * -(-tile // rows_per_block) * -(-tile // 32))


def _states(args, core):
    """The label states B4 is held at: round-1 slot indices of the
    cores, the converged roots of the fit's round loop, a random
    permutation of the core labels, labels descending in slot order, and
    no source at all."""
    n = core.shape[0]
    idx = torch.arange(n, dtype=torch.int32)
    f = torch.where(core, idx, INT_INF)
    out = {"round1": f}
    while True:
        g = minlab_over_pairs_sketch(*args(f))
        f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f), core)
        if torch.equal(f_new, f):
            break
        f = f_new
    out["converged"] = f
    perm = torch.from_numpy(
        np.random.default_rng(5).permutation(n).astype(np.int32))
    out["permuted"] = torch.where(core, perm, INT_INF)
    out["descending"] = torch.where(core, n - 1 - idx, INT_INF)
    out["no_source"] = torch.full((n,), INT_INF, dtype=torch.int32)
    return out


@pytest.fixture(scope="module", params=["high", "default"])
def embedding(request):
    """Embedding data at 128-D (k = 32) in 256-row tiles: 24 clusters
    over 2,000 points, so several clusters share a tile and a block."""
    X, _truth = benchdata.make_embedding_data(2000, 128)
    args, core = _inputs(X, 2.0, 256, 32, 10, request.param)
    return request.param, args, core, _states(args, core)


@pytest.mark.parametrize("state", STATES)
def test_walk_equals_plain_b4_bitwise(embedding, state):
    mode, args, core, states = embedding
    a = args(states[state])
    plain = minlab_over_pairs_sketch(*a)
    best, evaluated = minlab_skip_walk(*a)
    assert best.dtype == torch.int32 and best.shape == plain.shape
    assert torch.equal(best, plain), (mode, state)
    total = _chunks(args)
    assert 0 <= evaluated <= total
    if state == "no_source":
        assert evaluated == 0
    else:
        assert evaluated > 0


@pytest.mark.parametrize("rows_per_block", [32, 128])
def test_walk_block_height_never_changes_the_result(embedding,
                                                     rows_per_block):
    """Smaller blocks skip more (fewer rows hold the bound up) and never
    change a row's answer."""
    _mode, args, _core, states = embedding
    a = args(states["round1"])
    best, evaluated = minlab_skip_walk(*a, rows_per_block=rows_per_block)
    assert torch.equal(best, minlab_over_pairs_sketch(*a))
    assert 0 < evaluated <= _chunks(args, rows_per_block)


def test_converged_blobs_evaluate_a_small_share_of_chunks():
    """Near-clique blobs, each over several row tiles: at converged
    labels a block evaluates its own cluster's first chunk and the live
    tiles of clusters with lower labels, a small share of the chunks;
    labels descending in slot order defeat the skip."""
    X, _truth = benchdata.make_blob_data(4096, 64, n_centers=4, std=0.2,
                                         seed=1)
    args, core = _inputs(X, 3.5, 256, 16, 10, "high")
    states = _states(args, core)
    total = _chunks(args)
    share = {}
    for name in ("converged", "descending"):
        a = args(states[name])
        best, evaluated = minlab_skip_walk(*a)
        assert torch.equal(best, minlab_over_pairs_sketch(*a))
        share[name] = evaluated / total
    assert share["converged"] < 0.25
    assert share["descending"] > 0.8


def test_wrapper_adds_the_walks_count_on_the_cpu(embedding):
    """On a CPU tensor the wrapper runs the plain version and, asked for
    the count, adds the walk's; a malformed counter is refused."""
    _mode, args, _core, states = embedding
    a = args(states["converged"])
    xs, lab, rp, cols, slab, k, e2, band, tile, centers = a
    mode = "high" if centers is None else "default"
    ev = torch.full((1,), 7, dtype=torch.int64)
    out = ck.minlab_pairs_sketch(xs, lab, rp, cols, slab, k, e2, band, tile,
                                 mode, centers, evaluated=ev)
    best, evaluated = minlab_skip_walk(*a)
    assert torch.equal(out, best)
    assert int(ev[0]) == 7 + evaluated
    with pytest.raises(ValueError, match="evaluated"):
        ck.minlab_pairs_sketch(xs, lab, rp, cols, slab, k, e2, band, tile,
                               mode, centers,
                               evaluated=torch.zeros(1, dtype=torch.int32))
