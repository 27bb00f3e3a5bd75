"""``chip_smoke.py``'s phase 16 (the global-Morton route's chained form)
rehearsed on the CPU at small sizes: the kernels' wrappers run their
plain versions and count their calls as launches, so the phase's gates,
its record and its failures run without a card."""

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
                 emb_block=128, small_ranges=4,
                 gm_modes=["high", "mixed", "default"], emb_ranges=2,
                 n=4000, eps=2.4, ranges=4, block=128, hold_tiles=4,
                 border_eps=2.2, sk_n=600, sk_eps=2.0, sk_ranges=2,
                 sk_block=128)
KERNELS = ("count_pairs", "minlab_pairs", "count_pairs_mixed",
           "minlab_pairs_mixed", "count_pairs_default",
           "minlab_pairs_default", "count_pairs_sketch",
           "minlab_pairs_sketch")


def _gm_phase(monkeypatch, spoil=None, spoil_hold=None, sizes=REHEARSAL,
              cpu_refs=False):
    """Phase 16 on the CPU, every wrapper counting its calls as
    launches.  ``spoil``: a kernel whose launches count twice;
    ``spoil_hold``: a kernel whose first output word is off by one
    inside the largest-slab hold only; ``cpu_refs``: 16.1's CPU runs
    from a child process (else they run first, in this one)."""
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
    hold = chip_smoke.gm_slab_hold

    def marked_hold(*a, **kw):
        in_hold[0] = True
        try:
            return hold(*a, **kw)
        finally:
            in_hold[0] = False

    monkeypatch.setattr(chip_smoke, "gm_slab_hold", marked_hold)
    refs = (chip_smoke.ChainedCpuRefs(sizes, jobs=("gm",)) if cpu_refs
            else None)
    return chip_smoke.gm_phase(torch, torch.device("cpu"), lambda: None,
                               "cpu rehearsal", sizes, cpu_refs=refs)


@pytest.mark.parametrize("cpu_refs", [False, True])
def test_chip_smoke_gm_phase_rehearses_on_the_cpu(monkeypatch, cpu_refs):
    rec = _gm_phase(monkeypatch, cpu_refs=cpu_refs)
    assert set(rec["small"]) == {"small_high", "small_mixed",
                                 "small_default", "emb"}
    main = rec["main"]
    assert main["launches"] == {
        "count_pairs": REHEARSAL["ranges"],
        "minlab_pairs": sum(p - 1 for p in main["partition_passes"])}
    assert main["boundary_tiles"] > 0 and main["halo_factor"] > 0
    for key in ("split", "slab_build", "device"):
        assert main["stage_s"][key] >= 0, key
    hold = main["slab_hold"]
    assert hold["owned"] > 0 and hold["boundary"] > 0
    assert hold["max_abs_err"] == {"count_pairs": 0, "minlab_pairs": 0}
    assert rec["border"]["borders"] > 0
    sk = rec["sketch"]
    assert sk["sketch_k"] > 0
    assert sk["launches"]["count_pairs_sketch"] == REHEARSAL["sk_ranges"]
    assert sk["slab_hold"]["max_abs_err"] == {"count_pairs_sketch": 0,
                                              "minlab_pairs_sketch": 0}
    assert rec["faults"]["retried"] == 1 and rec["faults"]["restored"] == 2
    assert rec["faults"]["resume_launches"]["count_pairs"] == 2


@pytest.mark.parametrize("kernel", ["count_pairs", "minlab_pairs"])
def test_chip_smoke_gm_phase_fails_on_a_wrong_slab_word(monkeypatch, capsys,
                                                        kernel):
    with pytest.raises(SystemExit) as exc:
        _gm_phase(monkeypatch, spoil_hold=kernel)
    assert exc.value.code == 1
    assert "disagree with their plain versions" in capsys.readouterr().err


def test_chip_smoke_gm_phase_fails_on_a_wrong_count(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        _gm_phase(monkeypatch, spoil="minlab_pairs")
    assert exc.value.code == 1
    assert "launches do not match" in capsys.readouterr().err


def test_chip_smoke_gm_phase_fails_when_the_cpu_run_differs(monkeypatch,
                                                            capsys):
    import chip_smoke

    runs = chip_smoke.gm_cpu_runs

    def spoiled(cases):
        out = runs(cases)
        (lab, core, st), sec = out["small_mixed"]
        lab = lab.copy()
        lab[0] += 1
        out["small_mixed"] = ((lab, core, st), sec)
        return out

    monkeypatch.setattr(chip_smoke, "gm_cpu_runs", spoiled)
    with pytest.raises(SystemExit) as exc:
        _gm_phase(monkeypatch)
    assert exc.value.code == 1
    assert "16.1 small_mixed: the card's chained GM fit differs" in (
        capsys.readouterr().err)


def test_one_child_runs_13_1_and_16_1_in_turn():
    """The full script's one child process runs 13.1's CPU runs, then
    16.1's: each job's results equal this process's runs, the first is
    read while the second may still run, and reading the last ends the
    child and removes its files."""
    import os

    import numpy as np

    import chip_smoke

    refs = chip_smoke.ChainedCpuRefs(REHEARSAL, jobs=("kd", "gm"))
    kd_cases = chip_smoke.chained_cpu_cases(REHEARSAL)
    gm_cases = chip_smoke.gm_cpu_cases(REHEARSAL)
    for job, cases, runs in (("kd", kd_cases, chip_smoke.chained_cpu_runs),
                             ("gm", gm_cases, chip_smoke.gm_cpu_runs)):
        got = refs.result(cases, job)
        here = runs(cases)
        assert set(got) == set(here)
        for name in cases:
            for a, b in zip(got[name][0][:2], here[name][0][:2]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            if job == "gm":
                assert got[name][0][2] == here[name][0][2]
    assert refs.proc.poll() == 0
    assert not os.path.exists(refs.log_path)
