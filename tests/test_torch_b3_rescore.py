"""B3's certified rescore on the CPU.

The kernel (``csrc/sketch_kernels.cu``, ``sketch_pair_kernel<0,
SK_CERTIFIED>``) decides each in-band pair of the sketch gate by a bf16
tensor-core d^2 within a proven per-pair band and sends the rest to
B1's exact d^2.  It cannot run here, so these tests hold its rule:
:func:`certified_rescore_walk` emulates it with bf16-rounded operands
and the kernel's band formula, operation for operation, and must return
the plain B3's counts bitwise (the band itself is tested in
``tests/test_torch_b3_band.py``).  On the card
``chip_smoke.py`` and ``tests/test_torch_card.py`` hold the kernel's
counts bitwise and its ``rescored_pairs`` near the emulation's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchdata
from pypardis_tpu.ops import pallas_kernels as jpk
from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops import sketch as tsk
from pypardis_tpu_torch.ops.distances import (
    certified_band_coefs,
    certified_rescore_walk,
    counts_over_pairs_sketch,
    eps2_f32,
    row_offsets,
)
from test_torch_precision import adversarial
from test_torch_sketch import BLOCK, _layout
from test_torch_sketch_fits import _guard, _noise_dominated

GEOMS = ("blobs", "embedding", "noise", "adversarial")
DIMS = (128, 256, 512)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain passes are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _geometry(name, d):
    """``(X, eps)``: eps near the typical within-cluster distance, so
    the gate leaves many pairs in band.  The adversarial geometry (1800
    points: pad rows up to the tile) plants pairs at eps (1 -+ 1e-4),
    duplicates, and shifts everything by 1e3."""
    if name == "blobs":
        X, _ = benchdata.make_blob_data(640, d, n_centers=5, std=0.4)
        return X.astype(np.float32), float(0.4 * np.sqrt(2.0 * d))
    if name == "embedding":
        X, _ = benchdata.make_embedding_data(640, d)
        return X, 2.0
    if name == "guarded":  # no pair within rounding distance of eps
        X, _ = benchdata.make_embedding_data(640, d)
        return _guard(X, 2.0), 2.0
    if name == "noise":
        return _noise_dominated(640, d, seed=4)
    eps = float(0.25 * np.sqrt(2.0 * d))
    return adversarial(n=1800, d=d, eps=eps, offset=1e3), eps


_CACHE = {}


def _inputs(name, d):
    """The sketched counts pass's inputs on the fit's own layout, with
    the row tiles' box centres (cached per geometry and d)."""
    key = (name, d)
    if key not in _CACHE:
        X, eps = _geometry(name, d)
        xs, mask = _layout(X, eps)
        k = tsk.resolve_sketch("auto", d)
        slab, band = ck.sketch_stage(xs, mask, k)
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, BLOCK, "high", budget=1 << 20, sketch=k,
            slab=(slab, band))
        assert total <= budget
        tile = ck._pallas_block(BLOCK, xs.shape[1], d, "high")
        rp = row_offsets(rows, xs.shape[1] // tile)
        centers = ck.tile_frames(xs, mask, tile)[0]
        a = (xs, mask.to(torch.int32), rp, cols, slab, k, eps2_f32(eps),
             band, tile)
        _CACHE[key] = dict(a=a, eps=eps, mask=mask, centers=centers)
    return _CACHE[key]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", GEOMS)
def test_emulation_counts_bitwise(name, d):
    """The emulation's counts equal the plain B3's and the unsketched
    counts pass's, bitwise; the gate leaves pairs in band."""
    inp = _inputs(name, d)
    a, mask = inp["a"], inp["mask"]
    want, stats = counts_over_pairs_sketch(*a)
    got, rescored, fragile = certified_rescore_walk(*a, inp["centers"])
    assert int(stats[0]) > 0
    assert 0 <= rescored <= int(stats[0]) and 0 <= fragile <= int(stats[0])
    assert torch.equal(got, want)
    plain = ck.neighbor_counts_cuda(a[0], inp["eps"], mask, block=BLOCK,
                                    sketch=0)
    assert torch.equal(torch.where(mask, got, 0), plain)


@pytest.mark.parametrize("mode", ["high", "mixed"])
def test_cpu_wrapper_counts_the_emulations_rescored_pairs(mode):
    """On the CPU the wrapper's ``rescored_pairs=`` adds the emulation's
    count (beside which the emulation counts the in-band pairs near a
    band edge); the counts stay the plain version's; B3 without the row
    tiles' centres, a malformed counter, or one under ``"default"``, is
    refused."""
    inp = _inputs("embedding", 256)
    a, centers = inp["a"], inp["centers"]
    counts, want, fragile = certified_rescore_walk(*a, centers)
    assert want > 0 and 0 <= fragile <= int(counts_over_pairs_sketch(
        *a)[1][0])
    rc = torch.full((1,), 5, dtype=torch.int64)
    counts, stats = ck.count_pairs_sketch(*a, mode, centers,
                                          rescored_pairs=rc)
    pc, pst = counts_over_pairs_sketch(*a)
    assert torch.equal(counts, pc) and torch.equal(stats, pst)
    assert int(rc[0]) == 5 + want
    with pytest.raises(ValueError, match="centers"):
        ck.count_pairs_sketch(*a, mode, None, rescored_pairs=rc)
    with pytest.raises(ValueError, match="rescored_pairs"):
        ck.count_pairs_sketch(*a, mode, centers,
                              rescored_pairs=torch.zeros(1))
    with pytest.raises(ValueError, match="rescored_pairs"):
        ck.count_pairs_sketch(*a, "default", centers,
                              rescored_pairs=torch.zeros(1,
                                                         dtype=torch.int64))


def test_band_coefs_are_the_headers_formula_rounded_up():
    """``c_cross = 1.25 2 h``, ``c_acc = 1.25 2^-20 K h`` and ``c_norm =
    1.25 (3 d + 12) 2^-24 h``, ``h = 1 / (1 - (2 d + 8 K + 64) 2^-24)``,
    rounded up to float32, ``K`` = d padded to 16: finite and growing
    with d past 16,384 axes, infinite (every in-band pair to the exact
    path) once h is."""
    prev = None
    for d in (3, 16, 17, 128, 512, 1000, 16384, 16400, 100_000, 1_000_000):
        K = -(-d // 16) * 16
        h = 1.0 / (1.0 - (2.0 * d + 8.0 * K + 64.0) * 2.0**-24)
        coefs = certified_band_coefs(d)
        for c, v in zip(coefs, (2.5 * h, 1.25 * 2.0**-20 * K * h,
                                1.25 * (3.0 * d + 12.0) * 2.0**-24 * h)):
            assert np.isfinite(c) and np.float32(c) == c and c >= v
            assert float(np.nextafter(np.float32(c), np.float32(0))) < v
        assert prev is None or all(c >= p for c, p in zip(coefs, prev))
        prev = coefs
    assert all(np.isinf(c) for c in certified_band_coefs(2_000_000))


def test_port_counts_equal_the_jax_reference_on_a_sketched_input():
    """The JAX Pallas sketch kernel (interpret mode) and the port's
    sketched counts pass, and the emulation, agree on a guard-banded
    embedding input at d = 256 (the reference's CPU d^2 is not the
    port's exact sum, so they may differ on pairs near eps)."""
    inp = _inputs("guarded", 256)
    a, mask = inp["a"], inp["mask"]
    xs, k = a[0], a[5]
    jc, _jst = jpk.neighbor_counts_pallas(
        jnp.asarray(xs.numpy()), inp["eps"], jnp.asarray(mask.numpy()),
        block=BLOCK, precision="high", interpret=True, layout="dn",
        sketch=k)
    counts, _st = ck.neighbor_counts_cuda(xs, inp["eps"], mask, block=BLOCK,
                                          sketch=k)
    m = mask.numpy()
    assert np.array_equal(counts.numpy()[m], np.asarray(jc)[m])
    emu = certified_rescore_walk(*a, inp["centers"])[0]
    assert np.array_equal(emu.numpy()[m], np.asarray(jc)[m])
