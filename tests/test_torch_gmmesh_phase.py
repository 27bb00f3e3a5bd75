"""``chip_smoke.py``'s phase 20 (the global-Morton mesh engine on a mesh
that repeats one device) rehearsed on the CPU at small sizes: the
kernels' wrappers run their plain versions and count their calls as
launches, so the phase's gates, its record and its failures run without
a card."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


REHEARSAL = dict(small_n=1500, small_eps=2.0, small_parts=4,
                 small_block=128, emb_n=400, emb_eps=2.0, emb_parts=2,
                 emb_block=128,
                 gm_cases=[[4, "device", 1], [4, "host", 0],
                           [8, "device", 0], [8, "host", 1]],
                 mesh=4, n=4000, eps=2.4, block=128, hold_tiles=4,
                 stream_n=2000, sk_n=600, sk_eps=2.0, sk_block=128,
                 sk_hold_tiles=2)
KERNELS = ("count_pairs", "minlab_pairs", "count_pairs_sketch",
           "minlab_pairs_sketch")


def _phase(monkeypatch, spoil=None, spoil_hold=None, cpu_refs=False):
    """Phase 20 on the CPU, every wrapper counting its calls as
    launches.  ``spoil``: a kernel whose launches count twice;
    ``spoil_hold``: a kernel whose first output word is off by one inside
    the largest-slab hold only; ``cpu_refs``: 20.1's CPU runs from a
    child process (else they run first, in this one)."""
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck

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
    hold = chip_smoke.gmmesh_slab_hold

    def marked_hold(*a, **kw):
        in_hold[0] = True
        try:
            return hold(*a, **kw)
        finally:
            in_hold[0] = False

    monkeypatch.setattr(chip_smoke, "gmmesh_slab_hold", marked_hold)
    refs = (chip_smoke.ChainedCpuRefs(REHEARSAL, jobs=("gmmesh",))
            if cpu_refs else None)
    return chip_smoke.gmmesh_phase(
        torch, torch.device("cpu"), lambda: None, "cpu rehearsal",
        REHEARSAL, cpu_refs=refs, walls={"17.2": 1.0, "18.2": 2.0})


@pytest.mark.parametrize("cpu_refs", [False, True])
def test_chip_smoke_gmmesh_phase_rehearses_on_the_cpu(monkeypatch, cpu_refs):
    rec = _phase(monkeypatch, cpu_refs=cpu_refs)
    assert set(rec["small"]) == {"p4_device_overlap", "p4_host_serial",
                                 "p8_device_serial", "p8_host_overlap"}
    main, host = rec["main"], rec["host"]
    ran = [p for p in main["partition_passes"] if p]
    assert main["launches"] == {
        "count_pairs": 4 + len(ran),
        "minlab_pairs": sum(p - 1 for p in ran)}
    assert main["merges_identical"] is True
    assert host["staged_bytes"] == 0
    assert host["staged_bytes_reused"] == main["staged_bytes"] > 0
    assert main["fixpoint_rounds"] >= 1 and host["fixpoint_rounds"] == 0
    assert main["boundary_tiles"] > 0 and main["halo_factor"] > 0
    hold = main["slab_hold"]
    assert hold["owned"] > 0 and hold["boundary"] > 0
    assert hold["max_abs_err"] == {"count_pairs": 0, "minlab_pairs": 0}
    assert rec["one_card"]["same_as_mesh"] is True
    assert rec["stream"]["n"] == 2000
    sk = rec["sketch"]
    assert sk["sketch_k"] > 0 and sk["sent_tiles"] <= sk["sent_tiles_box"]
    assert sk["slab_hold"]["max_abs_err"] == {"count_pairs_sketch": 0,
                                              "minlab_pairs_sketch": 0}
    assert rec["checks"]["retried"] == {"gm.ring_round": 1,
                                        "gm.fixpoint_round": 1}


@pytest.mark.parametrize("kernel", ["count_pairs", "minlab_pairs"])
def test_chip_smoke_gmmesh_phase_fails_on_a_wrong_slab_word(
        monkeypatch, capsys, kernel):
    with pytest.raises(SystemExit) as exc:
        _phase(monkeypatch, spoil_hold=kernel)
    assert exc.value.code == 1
    assert "disagree with their plain versions" in capsys.readouterr().err


def test_chip_smoke_gmmesh_phase_fails_on_a_wrong_count(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        _phase(monkeypatch, spoil="minlab_pairs")
    assert exc.value.code == 1
    assert "launches do not match" in capsys.readouterr().err


def test_chip_smoke_gmmesh_phase_fails_when_the_cpu_run_differs(monkeypatch,
                                                                capsys):
    import chip_smoke

    runs = chip_smoke.gmmesh_cpu_runs

    def spoiled(cases):
        out = runs(cases)
        (lab, core, st), sec = out["p8_host_overlap"]
        lab = lab.copy()
        lab[0] += 1
        out["p8_host_overlap"] = ((lab, core, st), sec)
        return out

    monkeypatch.setattr(chip_smoke, "gmmesh_cpu_runs", spoiled)
    with pytest.raises(SystemExit) as exc:
        _phase(monkeypatch)
    assert exc.value.code == 1
    assert "20.1 p8_host_overlap: the card's mesh engine differs" in (
        capsys.readouterr().err)
