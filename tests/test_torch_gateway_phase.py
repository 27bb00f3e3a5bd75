"""``chip_smoke.py``'s phase 12 (the gateway and the load harnesses)
rehearsed on the CPU at small sizes: the kernels' wrappers run their
plain versions and count their calls as launches, so the phase's gates
and record run without a card.  A readmitted slab with one flipped word,
or a ``release()`` that keeps a tensor alive, fails it."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


# Phase 12 at small sizes: the same 16-D blob law and eps, 8 centres.
REHEARSAL = dict(n=4000, d=16, centers=8, std=0.4, eps=2.4, min_samples=10,
                 block=256, queries=256, trace_cap=64,
                 clients=2, rate_hz=100.0, batch_rows=16, writers=2,
                 write_rate_hz=30.0, write_batch_rows=4,
                 delete_fraction=0.2, compact_at_s=0.3, duration_s=1.0,
                 big_n=4000, fleet_n=1500, fleet=5, seed0=101,
                 budget_share=0.6, hot_rows=16, tenants=2,
                 clients_per_tenant=1, fleet_rate_hz=80.0,
                 fleet_batch_rows=16, zipf_s=1.2, write_fraction=0.05,
                 fleet_duration_s=1.2, refresh_at_s=0.4)


def _gateway_phase(monkeypatch, spoil=None, **over):
    import chip_smoke
    from pypardis_tpu_torch import checkpoint
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.serve.index import CorePointIndex

    for name in ("count_pairs", "minlab_pairs", "query_leaf"):
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, name, counted)
    if spoil == "flipped_word":
        load = checkpoint.load_index

        def flipped(*a, **kw):
            idx = load(*a, **kw)
            idx.labels[0] ^= 1
            return idx
        monkeypatch.setattr(checkpoint, "load_index", flipped)
    elif spoil == "kept_tensor":
        release = CorePointIndex.release
        kept = []

        def keeping(self):
            kept.append(self._dev[0])
            return release(self)
        monkeypatch.setattr(CorePointIndex, "release", keeping)
    sizes = dict(REHEARSAL, **over)
    return chip_smoke.gateway_phase(torch, torch.device("cpu"),
                                    lambda: None, "cpu rehearsal", sizes)


def test_chip_smoke_gateway_phase_rehearses_on_the_cpu(monkeypatch):
    rec = _gateway_phase(monkeypatch)
    ing = rec["ingest"]
    assert ing["compactions"] >= 1 and ing["epoch_swaps"] >= 1
    assert ing["refit_ari"] == 1.0 and ing["write_rows"] > 0
    assert set(ing["compaction_phases"]) == {"snapshot", "refit", "build",
                                             "swap"}
    assert min(ing["launches"][k] for k in ("count_pairs", "minlab_pairs",
                                            "query_leaf")) >= 1
    fl = rec["fleet"]
    assert set(fl["index_bytes"]) == {"big", "m1", "m2", "m3", "m4", "m5",
                                      "live"}
    assert fl["evictions"] >= 1 and fl["reloads"] >= 1
    assert fl["launches"]["query_leaf"] == fl["batches"] >= 1
    assert len(fl["swap_ms"]) == 1
    assert set(fl["tenants"]) == {"t00", "t01"}
    assert np.isfinite(fl["qps"]) and fl["queries"] > 0


@pytest.mark.parametrize("spoil,message", [
    ("flipped_word", "differs from its tensors before the eviction"),
    ("kept_tensor", "did not give the card its memory back"),
])
def test_chip_smoke_gateway_phase_fails_a_spoilt_eviction(monkeypatch, capsys,
                                                          spoil, message):
    with pytest.raises(SystemExit) as exc:
        _gateway_phase(monkeypatch, spoil, duration_s=0.5, compact_at_s=0.1)
    assert exc.value.code == 1
    assert message in capsys.readouterr().err
