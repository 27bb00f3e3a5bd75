"""``chip_smoke.py``'s phase 18 (the KD route's ring exchange, its
streaming build and the device-input route on a mesh that repeats one
device) rehearsed on the CPU at small sizes: the kernels' wrappers run
their plain versions and count their calls as launches, so the phase's
gates, its record and its failures run without a card."""

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


REHEARSAL = dict(small_n=1500, small_eps=2.0, small_parts=4,
                 small_block=128, emb_n=400, emb_eps=2.0, emb_parts=2,
                 emb_block=128, mesh=4, ring_merges=["device", "host"],
                 n=4000, eps=2.4, block=128, hold_tiles=4, sk_n=600,
                 sk_eps=2.0, sk_block=128)
KERNELS = ("count_pairs", "minlab_pairs", "count_pairs_sketch",
           "minlab_pairs_sketch")


def _ring_phase(monkeypatch, spoil=None, spoil_hold=None, cpu_refs=False,
                leak=False):
    """Phase 18 on the CPU, every wrapper counting its calls as
    launches.  ``spoil``: a kernel whose launches count twice;
    ``spoil_hold``: a kernel whose first output word is off by one
    inside the largest-slab hold only; ``cpu_refs``: 18.1's CPU runs
    from a child process; ``leak``: the device-input route fetches its
    coordinates to numpy once."""
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import sharded

    in_hold = [False]
    for name in KERNELS:
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 2 if _n == spoil else 1
            out = _f(*a, **kw)
            if in_hold[0] and _n == spoil_hold:
                first = out[0] if isinstance(out, tuple) else out
                first = first.clone()
                first[0] += 1
                out = (first,) + out[1:] if isinstance(out, tuple) else first
            return out
        monkeypatch.setattr(ck, name, counted)
    hold = chip_smoke.gm_slab_hold

    def marked_hold(*a, **kw):
        in_hold[0] = True
        try:
            return hold(*a, **kw)
        finally:
            in_hold[0] = False

    monkeypatch.setattr(chip_smoke, "gm_slab_hold", marked_hold)
    device_route = sharded.sharded_dbscan_device

    def subsampled(points, *a, **kw):
        # The card's 1M points pass the route's 262,144-row subsample;
        # the rehearsal's 4,000 take one of 1,000 rows so that its
        # planning fetches no more than the card's does.
        if leak:
            points.numpy()
        return device_route(points, *a, sample_size=1000, **kw)

    monkeypatch.setattr(sharded, "sharded_dbscan_device", subsampled)
    refs = (chip_smoke.ChainedCpuRefs(REHEARSAL, jobs=("ring",))
            if cpu_refs else None)
    return chip_smoke.ring_phase(torch, torch.device("cpu"), lambda: None,
                                 "cpu rehearsal", REHEARSAL, cpu_refs=refs)


@pytest.mark.parametrize("cpu_refs", [False, True])
def test_chip_smoke_ring_phase_rehearses_on_the_cpu(monkeypatch, cpu_refs):
    rec = _ring_phase(monkeypatch, cpu_refs=cpu_refs)
    assert rec["mesh"] == ["cpu"] * 4
    assert set(rec["small"]) == {"small_device", "emb_device",
                                 "small_host", "emb_host"}
    for tag in ("main", "stream", "device"):
        row = rec[tag]
        assert row["launches"] == {
            "count_pairs": 4,
            "minlab_pairs": sum(p - 1 for p in row["partition_passes"])}
        for key in ("slab_build", "exchange", "device", "loop", "merge"):
            assert row["stage_s"][key] >= 0, (tag, key)
        assert row["halo_bytes"] == 4 * row["halo_cap"] * 16 * 4
    # The stream's fit counts its ladder on its own recorder: the same
    # layout climbs as the in-RAM ring's.
    assert rec["stream"]["hcap_retries"] == rec["main"]["hcap_retries"]
    peaks = rec["stream"]["traced_host_bytes"]
    assert peaks["stream"] < peaks["in_ram"]
    assert rec["main"]["input"] is None
    assert rec["stream"]["input"] == "stream"
    assert rec["device"]["input"] == "device"
    hold = rec["main"]["slab_hold"]
    assert hold["owned"] > 0 and hold["halo"] > 0
    assert hold["max_abs_err"] == {"count_pairs": 0, "minlab_pairs": 0}
    sk = rec["sketch"]
    assert sk["sketch_k"] > 0 and sk["hcap_retries"] >= 1
    assert sk["halo_cap"] == sk["hcap_start"] << sk["hcap_retries"]
    assert sk["launches"]["count_pairs_sketch"] == 4
    assert sk["slab_hold"]["max_abs_err"] == {"count_pairs_sketch": 0,
                                              "minlab_pairs_sketch": 0}
    assert rec["hcap_error"] == (
        "ring halo buffer overflow at hcap=128; pass a larger hcap")


@pytest.mark.parametrize("kernel", ["count_pairs", "minlab_pairs_sketch"])
def test_chip_smoke_ring_phase_fails_on_a_wrong_slab_word(monkeypatch,
                                                          capsys, kernel):
    with pytest.raises(SystemExit) as exc:
        _ring_phase(monkeypatch, spoil_hold=kernel)
    assert exc.value.code == 1
    assert "disagree with their plain versions" in capsys.readouterr().err


def test_chip_smoke_ring_phase_fails_on_a_wrong_count(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        _ring_phase(monkeypatch, spoil="minlab_pairs")
    assert exc.value.code == 1
    assert "launches do not match" in capsys.readouterr().err


def test_chip_smoke_ring_phase_fails_on_a_host_copy(monkeypatch, capsys):
    """The device-input gate: one ``(N, k)`` fetch of the coordinates
    fails the phase."""
    with pytest.raises(SystemExit) as exc:
        _ring_phase(monkeypatch, leak=True)
    assert exc.value.code == 1
    assert "copied the coordinates to the host" in capsys.readouterr().err


def test_chip_smoke_ring_phase_fails_when_the_cpu_run_differs(monkeypatch,
                                                              capsys):
    import chip_smoke

    runs = chip_smoke.ring_cpu_runs

    def spoiled(cases, shards=4):
        out = runs(cases, shards)
        (lab, core, st), sec = out["small_host"]
        lab = lab.copy()
        lab[0] += 1
        out["small_host"] = ((lab, core, st), sec)
        return out

    monkeypatch.setattr(chip_smoke, "ring_cpu_runs", spoiled)
    with pytest.raises(SystemExit) as exc:
        _ring_phase(monkeypatch)
    assert exc.value.code == 1
    assert "18.1 small_host: the card's ring fit differs" in (
        capsys.readouterr().err)
