"""B3's certified band on the CPU: every pair the band decides has the
exact verdict, ``|d2f - d2| <= band_p`` holds on the geometries of
``tests/test_torch_b3_rescore.py`` and under a ``hypothesis`` search
toward the band's edge for any order of the cross term's sum, and the
wrapper's bf16 row fragments follow the kernel's mma layout (kept apart
from that module so that neither is among the largest test files the
parallel run starts first).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pypardis_tpu_torch.ops import cuda_kernels as ck
from pypardis_tpu_torch.ops.distances import (
    _pair_d2,
    _sketch_gate,
    axis_sq,
    bf16_round,
    certified_d2,
)
from test_torch_b3_rescore import DIMS, GEOMS, _inputs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain passes are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("name", GEOMS)
def test_certain_verdicts_equal_exact(name, d):
    """Over every in-band pair: ``|d2f - d2| <= band_p``, and each pair
    the band decides (in: ``d2f + band_p < eps2``, out: ``d2f - band_p >
    eps2``) has the exact verdict."""
    inp = _inputs(name, d)
    a, centers = inp["a"], inp["centers"]
    xs, e2, tile = a[0], a[6], a[8]
    tiles = xs.reshape(d, -1, tile)
    n_amb = n_certain = 0
    for _s, r, c, _v, _sure, amb in _sketch_gate(
            xs, a[4], a[5], a[1], a[2], a[3], e2, a[7], tile, "sum"):
        need = amb.flatten(1).any(dim=1)
        if not bool(need.any()):
            continue
        rn, cn, an = r[need], c[need], amb[need]
        d2f, bp = certified_d2(tiles[:, rn], tiles[:, cn], centers[rn])
        d2 = _pair_d2(tiles[:, rn], tiles[:, cn])
        cin = an & ((d2f + bp) < e2)
        cout = an & ((d2f - bp) > e2)
        assert bool(((d2f - d2).abs() <= bp)[an].all())
        assert bool((d2[cin] <= e2).all())
        assert bool((d2[cout] > e2).all())
        n_amb += int(an.sum())
        n_certain += int((cin | cout).sum())
    assert n_amb > 0 and n_certain > 0


def _ordered_d2f(xc, yc, xx, yy, order):
    """d2f with the cross term of bf16-rounded operands summed in
    float32 in ``order`` (the tensor cores' order is unspecified)."""
    p = (torch.from_numpy(xc).to(torch.bfloat16).float()
         * torch.from_numpy(yc).to(torch.bfloat16).float()).numpy()
    dot = np.float32(0.0)
    for i in order:
        dot = np.float32(dot + p[i])
    return np.float32(np.float32(xx + yy) - np.float32(2.0) * dot)


@settings(max_examples=150, deadline=None)
@given(
    d=st.sampled_from([3, 16, 33, 128, 512]),
    seed=st.integers(0, 2**32 - 1),
    scale=st.floats(1e-3, 1e3),
    edge=st.floats(-0.05, 0.05),
    shape=st.sampled_from(["normal", "halfway", "aligned", "offset"]),
)
def test_band_holds_toward_its_edge(d, seed, scale, edge, shape):
    """No pair with ``|d2f - d2| > band_p``, for the bmm sum, the
    forward and the reversed float32 sums of the cross term, with pairs
    scaled to d2 = eps2 (1 + edge): random directions, coordinates just
    off bf16's rounding midpoints (the largest operand error), rows and
    columns nearly parallel (Cauchy-Schwarz tight), and a far centre."""
    rng = np.random.default_rng(seed)
    if shape == "halfway":
        # Mantissas a hair below a bf16 midpoint, all of one sign.
        m = rng.integers(0, 128, size=(2, d))
        v = (1.0 + (m + 0.5 - 1e-3) / 128.0) * 2.0 ** rng.integers(
            -2, 3, size=(2, d))
        x, y = v[0], v[1]
    elif shape == "aligned":
        x = rng.normal(size=d)
        y = x * (1 + 1e-3 * rng.normal(size=d))
    else:
        x, y = rng.normal(size=(2, d))
    x, y = x * scale, y * scale
    c = rng.normal(size=d) * scale * (50.0 if shape == "offset" else 0.5)
    eps2 = np.float32(max(float(((x - y) ** 2).sum()), 1e-30)
                      * (1.0 + edge))
    x, y, c = (v.astype(np.float32) for v in (x, y, c))
    xt = torch.from_numpy(x)[:, None, None]
    yt = torch.from_numpy(y)[:, None, None]
    d2f, bp = certified_d2(xt, yt, torch.from_numpy(c)[None])
    d2 = float(_pair_d2(xt, yt)[0, 0, 0])
    bp = float(bp[0, 0, 0])
    xc, yc = (x - c).astype(np.float32), (y - c).astype(np.float32)
    xx = np.float32(0.0)
    yy = np.float32(0.0)
    for a in range(d):
        xx = np.float32(xx + np.float32(xc[a] * xc[a]))
        yy = np.float32(yy + np.float32(yc[a] * yc[a]))
    cands = [float(d2f[0, 0, 0]),
             float(_ordered_d2f(xc, yc, xx, yy, range(d))),
             float(_ordered_d2f(xc, yc, xx, yy, range(d - 1, -1, -1)))]
    for f in cands:
        assert abs(f - d2) <= bp, (f, d2, bp)
        if np.float32(f + bp) < eps2:
            assert d2 <= eps2
        if np.float32(f - bp) > eps2:
            assert d2 > eps2


@pytest.mark.parametrize("d,tile", [(40, 48), (512, 128)])
def test_row_fragments_follow_the_mma_layout(d, tile):
    """The wrapper's bf16 row fragments, read as the kernel reads them
    (one 16-byte entry per lane, 16 rows and one k-step, at the offset
    of its row tile, warp, 16-row group and k-step), hold bf16(x - c) of
    the rows and axes of bf16_tile.cuh's A layout, zeros past d and past
    the tile."""
    rng = np.random.default_rng(d)
    nt = 3
    pts = torch.from_numpy(rng.normal(size=(d, nt * tile)).astype(np.float32))
    centers = torch.from_numpy(rng.normal(size=(nt, d)).astype(np.float32))
    frag = ck.row_fragments(pts, centers, tile)
    dp, tp = -(-d // 16) * 16, -(-tile // 32) * 32
    want = torch.zeros((nt, tp, dp), dtype=torch.bfloat16)
    want[:, :tile, :d] = (pts.T.reshape(nt, tile, d)
                          - centers[:, None, :]).to(torch.bfloat16)
    # Entry (r, 16-row group, k-step, lane, register j, half i): the
    # kernel's reading order; row and axis as bf16_tile.cuh lays A out.
    r, grp, kk, lane, j, i = np.meshgrid(
        np.arange(nt), np.arange(tp // 16), np.arange(dp // 16),
        np.arange(32), np.arange(4), np.arange(2), indexing="ij")
    row = grp * 16 + (lane >> 2) + 8 * (j & 1)
    ax = kk * 16 + 2 * (lane & 3) + 8 * (j >> 1) + i
    got = frag.reshape(nt, tp // 16, dp // 16, 32, 4, 2)
    assert torch.equal(got, want[r, row, ax])


def _truncating_dot(a, b):
    """The cross term as a tensor core that keeps only 24 significant
    bits might sum it: per k-step of 16 axes, the running sum and the 16
    exact products aligned to the largest and truncated toward zero
    there, added exactly, and the result truncated to 24 bits.  ``a``
    (..., K), ``b`` (..., K) float64 holding bf16 values."""
    def trunc(v, e):
        q = np.exp2(e - 23.0)
        return np.trunc(v / q) * q

    def expo(m):
        return np.floor(np.log2(np.where(m > 0, m, 1.0)))

    acc = np.zeros(np.broadcast_shapes(a.shape, b.shape)[:-1])
    for k0 in range(0, a.shape[-1], 16):
        p = a[..., k0:k0 + 16] * b[..., k0:k0 + 16]
        v = np.concatenate([acc[..., None], p], axis=-1)
        e = expo(np.abs(v).max(axis=-1))[..., None]
        s = trunc(v, e).sum(axis=-1)
        acc = trunc(s, expo(np.abs(s)))
    return acc


@pytest.mark.parametrize("case", range(6))
def test_truncating_accumulation_stays_within_term_3(case):
    """On the card probe's adversarial inputs (``chip_smoke.
    mma_probe_cases``: cancellation, magnitudes over 2^+-30, one large
    product before or after many below its last bit, a late
    cancellation), three accumulations of the cross term stay within
    the header's term (3), ``|dot - P'| <= 2^-21 K sum |p|``: a tensor
    core truncating to 24 bits (:func:`_truncating_dot`) and the forward
    and reversed float32 sums with rounding."""
    from chip_smoke import mma_probe_cases

    name, a, b = mma_probe_cases(batch=4)[case]
    K = a.shape[2]
    a64 = a.astype(np.float64)[:, :, None, :]
    b64 = b.astype(np.float64)[:, None, :, :]
    prods = a64 * b64
    exact = prods.sum(axis=-1)
    mag = np.abs(prods).sum(axis=-1)
    fwd = np.zeros(exact.shape, np.float32)
    rev = np.zeros(exact.shape, np.float32)
    p32 = prods.astype(np.float32)  # exact: bf16 x bf16 fits float32
    for i in range(K):
        fwd = fwd + p32[..., i]
        rev = rev + p32[..., K - 1 - i]
    for dot in (_truncating_dot(a64, b64), fwd, rev):
        err = np.abs(dot.astype(np.float64) - exact)
        assert (err <= 2.0**-21 * K * mag).all(), name
    # The truncating model loses something on the cases built for it.
    if name in ("one large first", "late cancellation"):
        assert (np.abs(_truncating_dot(a64, b64) - exact) > 0).any()


@pytest.mark.parametrize("d", [16400, 50_000])
def test_band_holds_past_16384_axes(d):
    """Past 16,384 axes (where the band's higher-order factors once set
    a limit) ``|d2f - d2| <= band_p`` still holds, with the cross term
    summed by a truncating tensor core as well, on pairs near eps and
    on nearly parallel ones with a far centre."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(d, 1, 4)).astype(np.float32)
    y = (x + 0.05 * rng.normal(size=(d, 1, 4))).astype(np.float32)
    y[:, :, 2:] = rng.normal(size=(d, 1, 2)).astype(np.float32)
    c = (rng.normal(size=(1, d)) * 30.0).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ct = torch.from_numpy(c)
    d2f, bp = certified_d2(xt, yt, ct)
    d2 = _pair_d2(xt, yt)
    assert bool(torch.isfinite(bp).all())
    assert bool(((d2f - d2).abs() <= bp).all())
    xc = bf16_round(xt - ct.T[:, :, None]).double().numpy()
    yc = bf16_round(yt - ct.T[:, :, None]).double().numpy()
    dot = _truncating_dot(np.moveaxis(xc[:, 0], 0, -1)[:, None, :],
                          np.moveaxis(yc[:, 0], 0, -1)[None, :, :])
    xx = axis_sq(xt - ct.T[:, :, None])[0][:, None]
    yy = axis_sq(yt - ct.T[:, :, None])[0][None, :]
    d2t = (xx + yy) - 2.0 * torch.from_numpy(dot).float()
    assert bool(((d2t - d2[0]).abs() <= bp[0]).all())
