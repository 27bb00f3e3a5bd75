"""The port's device layout against the JAX package's, bit for bit: the
Morton words, the lexsort permutation, the segment-break re-layout and
the packed result.  The layout fixes the kernel-slot order and with it
the cluster numbering, so every comparison here is exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import benchdata
from pypardis_tpu.ops import pipeline as jpipe
from pypardis_tpu_torch.ops import pipeline as tpipe


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _centred_t(X, cap):
    """The host staging copy both packages start from: (d, cap) float32,
    centred on a float64 mean, zero-padded."""
    n, d = X.shape
    out = np.zeros((d, cap), np.float32)
    out[:, :n] = (X - X.mean(axis=0, dtype=np.float64)).T
    return out


@pytest.mark.parametrize("d,n", [(3, 900), (16, 700), (64, 500)])
def test_morton_words_bit_equal(d, n):
    rng = np.random.default_rng(d)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 4.0, size=d)
    cap = 1024
    xt = _centred_t(X, cap)
    mask = np.arange(cap) < n
    want = jpipe._device_morton_words(jnp.asarray(xt), jnp.asarray(mask))
    got = tpipe._device_morton_words(
        torch.from_numpy(xt), torch.from_numpy(mask)
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("d", [2, 16])
def test_lexsort_permutation_equal(d):
    rng = np.random.default_rng(11)
    n, cap = 1500, 2048
    # Coarse values force equal Morton codes, so stability is exercised.
    X = np.round(rng.normal(size=(n, d)), 1)
    xt = _centred_t(X, cap)
    mask = np.arange(cap) < n
    words = tpipe._device_morton_words(
        torch.from_numpy(xt), torch.from_numpy(mask)
    )
    got = tpipe._layout_perm(words).numpy()
    want = np.asarray(jpipe._layout_perm(
        [jnp.asarray(w.numpy().astype(np.uint32)) for w in words]
    ))
    assert np.array_equal(got, want)


def _sorted_inputs(X, cap):
    n = len(X)
    xt = _centred_t(X, cap)
    mask = np.arange(cap) < n
    words = tpipe._device_morton_words(
        torch.from_numpy(xt), torch.from_numpy(mask)
    )
    perm = tpipe._layout_perm(words)
    xs, msk = tpipe._layout_gather(torch.from_numpy(xt), perm, n)
    return xs, msk, perm


@pytest.mark.parametrize("bt", [64, 3], ids=["budget", "top_k"])
def test_segment_break_layout_equal(bt):
    """(xs, mask, owner) equal on blobs whose sorted order jumps by more
    than 4*eps between clusters; ``bt=3`` takes the top-k rank path."""
    X, _t, _c = benchdata.make_separated_blob_data(
        3000, 16, n_centers=8, min_sep=8.0
    )
    eps, block = 2.4, 512
    xs, msk, perm = _sorted_inputs(X, 4096)
    ys, m2, owner = tpipe._segment_break_layout(
        xs, msk, perm, eps, block=block, bt=bt
    )
    jys, jm2, jowner = jpipe._segment_break_layout(
        jnp.asarray(xs.numpy()), jnp.asarray(msk.numpy()),
        jnp.asarray(perm.numpy().astype(np.int32)), eps, block, bt,
    )
    assert np.array_equal(ys.numpy(), np.asarray(jys))
    assert np.array_equal(m2.numpy(), np.asarray(jm2))
    assert np.array_equal(owner.numpy(), np.asarray(jowner))
    # The break layout really applied: segments start on block
    # boundaries, so padding slots sit between the clusters.
    assert ys.shape[1] == 4096 + (bt + 1) * block
    n_segments = int((owner.numpy()[::block] < 4096).sum())
    assert n_segments >= min(bt, 7) + 1


def test_pipeline_layout_gate_and_pack_equal():
    """The whole layout stage and the pack agree with the JAX stage at a
    size where the segment break is gated on (cap >= 16 * block)."""
    X, _t, _c = benchdata.make_separated_blob_data(2000, 8, n_centers=6)
    n, cap, block, eps = len(X), 2048, 128, 2.0
    xt = _centred_t(X, cap)
    xs, m, owner = tpipe._pipeline_layout(
        torch.from_numpy(xt), eps, n, block=block, sort=True
    )
    jxs, jm, jowner = jpipe._pipeline_layout(
        jnp.asarray(xt), eps, n, block=block, sort=True
    )
    assert xs.shape[1] > cap  # the break layout ran
    assert np.array_equal(xs.numpy(), np.asarray(jxs))
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(owner.numpy(), np.asarray(jowner))

    rng = np.random.default_rng(0)
    capk = xs.shape[1]
    roots = np.where(rng.random(capk) < 0.8,
                     rng.integers(0, capk, capk), -1).astype(np.int32)
    core = rng.random(capk) < 0.5
    stats = np.array([7, 4096, 3, 0, 0], np.int32)
    got = tpipe._pipeline_pack(
        torch.from_numpy(roots), torch.from_numpy(core),
        torch.from_numpy(stats.astype(np.int64)), owner, cap=cap,
    )
    want = np.asarray(jpipe._pipeline_pack(
        jnp.asarray(roots), jnp.asarray(core), jnp.asarray(stats),
        jowner, cap=cap,
    ))
    # The port carries the stats as int64 beside the row, not in it.
    row, st = got
    assert np.array_equal(row.numpy(), want[:-5])
    assert st.dtype == torch.int64 and np.array_equal(st.numpy(), want[-5:])
    for g, w in zip(tpipe.unpack_pipeline_result((row.numpy(), st.numpy())),
                    jpipe.unpack_pipeline_result(want)):
        assert np.array_equal(np.asarray(g), np.asarray(w))
