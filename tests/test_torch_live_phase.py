"""``chip_smoke.py``'s phase 11 (live updates and ingest) rehearsed on
the CPU at small sizes: the kernels' wrappers run their plain versions
and count their calls as launches, so the phase's gates and record run
without a card, and a commit that leaves the device tensors behind
fails it.  Apart from ``tests/test_torch_live.py`` so that the two run
on separate workers."""

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


# Phase 11 at small sizes: the same 16-D blob law and eps, 8 centres.
REHEARSAL = dict(n=4000, d=16, centers=8, std=0.4, eps=2.4, min_samples=10,
                 block=256, singles=6, batches=2, batch_rows=64,
                 blob_rows=128, clump=12, deletes=16, queue_rows=96,
                 queue_batch=32, replay_rows=8, replay_deletes=4,
                 queries=128, inserted_q=32, trace_cap=64, seed=11)


def _live_phase(monkeypatch, spoil=False):
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.serve.index import CorePointIndex

    for name in ("count_pairs", "minlab_pairs", "query_leaf"):
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, name, counted)
    if spoil:
        commit = CorePointIndex.commit_update

        def spoilt(self):
            out = commit(self)
            if self.epoch == 3:
                self._dev[1][-1] += 1
            return out
        monkeypatch.setattr(CorePointIndex, "commit_update", spoilt)
    return chip_smoke.live_phase(torch, torch.device("cpu"), lambda: None,
                                 "cpu rehearsal", REHEARSAL)


def test_chip_smoke_live_phase_rehearses_on_the_cpu(monkeypatch):
    rec = _live_phase(monkeypatch)
    assert set(rec["kinds"]) == {
        "insert", "insert_batch", "blob_batch", "clump", "noise", "pour",
        "delete_noise", "delete_cores", "queue_flush"}
    assert rec["kinds"]["insert"]["n"] == 6
    assert rec["refit_ari"] == 1.0
    # B1 once per re-cluster, per compaction refit and per warm-up
    # bucket of the loaded model (two).
    assert rec["launches"]["count_pairs"] == rec["recluster_dispatches"] + 3
    assert rec["launches"]["minlab_pairs"] >= rec["recluster_dispatches"]
    assert rec["launches"]["query_leaf"] >= 1
    assert rec["commits"] >= 8 and rec["delta_bytes"] > 0
    assert set(rec["compaction_phases"]) == {"snapshot", "refit", "build",
                                             "swap"}


def test_chip_smoke_live_phase_fails_on_a_stale_device_slab(monkeypatch,
                                                            capsys):
    """A commit that leaves one device label behind its host mirror
    fails the phase at that commit."""
    with pytest.raises(SystemExit) as exc:
        _live_phase(monkeypatch, spoil=True)
    assert exc.value.code == 1
    assert "device tensors differ from its host mirrors" in \
        capsys.readouterr().err
