"""``chip_smoke.py``'s phase 13 (the KD route's chained form) rehearsed
on the CPU at small sizes: the kernels' wrappers run their plain
versions and count their calls as launches, so the phase's gates, its
record and a failing count run without a card."""

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
                 emb_block=128, n=6000, eps=2.4, parts=8, block=256,
                 hold_tiles=4, border_eps=2.2)


def _chained_phase(monkeypatch, spoil=None, main=None, sizes=REHEARSAL,
                   spoil_hold=None, cpu_refs=False):
    """Phase 13 on the CPU, every wrapper counting its calls as
    launches.  ``spoil``: a kernel whose launches count twice;
    ``spoil_hold``: a kernel whose first output word is off by one
    inside the largest-slab hold only; ``cpu_refs``: 13.1's CPU runs
    from a child process (else they run first, in this one)."""
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck

    in_hold = [False]
    for name in ("count_pairs", "minlab_pairs", "count_pairs_sketch",
                 "minlab_pairs_sketch"):
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 2 if _n == spoil else 1
            out = _f(*a, **kw)
            if in_hold[0] and _n == spoil_hold:
                out = out.clone()
                out[0] += 1
            return out
        monkeypatch.setattr(ck, name, counted)
    hold = chip_smoke.chained_slab_hold

    def marked_hold(*a, **kw):
        in_hold[0] = True
        try:
            return hold(*a, **kw)
        finally:
            in_hold[0] = False

    monkeypatch.setattr(chip_smoke, "chained_slab_hold", marked_hold)
    refs = chip_smoke.ChainedCpuRefs(sizes) if cpu_refs else None
    return chip_smoke.chained_phase(torch, torch.device("cpu"),
                                    lambda: None, "cpu rehearsal",
                                    sizes, main=main, cpu_refs=refs)


@pytest.mark.parametrize("cpu_refs", [False, True])
def test_chip_smoke_chained_phase_rehearses_on_the_cpu(monkeypatch,
                                                       cpu_refs):
    rec = _chained_phase(monkeypatch, cpu_refs=cpu_refs)
    main = rec["main"]
    assert main["n"] == REHEARSAL["n"]
    assert main["partitions"] == REHEARSAL["parts"]
    assert main["halo_factor"] > 0 and main["duplicated_work_factor"] > 1
    assert main["merge"] == "device" and main["merge_rounds"] >= 1
    assert 0 < main["overlap_efficiency"] <= 1
    assert main["launches"]["count_pairs"] == REHEARSAL["parts"]
    assert main["launches"]["minlab_pairs"] >= REHEARSAL["parts"]
    for key in ("kd_build_s", "halo_sets_s", "slab_build_s", "device_s",
                "loop_s", "merge_s"):
        assert main[key] >= 0, key
    assert rec["small"]["n"] == REHEARSAL["small_n"]
    assert rec["small"]["cpu_s"] > 0 and rec["small"]["emb_cpu_s"] > 0
    hold = main["slab_hold"]
    assert hold["tiles_held"] == REHEARSAL["hold_tiles"]
    assert hold["owned"] > 0 and hold["halo"] > 0 and hold["points_held"]
    assert hold["max_abs_err"] == {"count_pairs": 0, "minlab_pairs": 0}
    border = rec["border"]
    assert border["eps"] == REHEARSAL["border_eps"]
    assert border["merge"] == "host" and border["borders"] > 0
    assert border["noise"] >= 0 and border["clusters"] > 1


@pytest.mark.parametrize("kernel", ["count_pairs", "minlab_pairs"])
def test_chip_smoke_chained_phase_fails_on_a_wrong_slab_word(
        monkeypatch, capsys, kernel):
    """One word of B1 or B2 off on the largest slab: the hold against
    the plain versions fails the phase."""
    with pytest.raises(SystemExit) as exc:
        _chained_phase(monkeypatch, spoil_hold=kernel)
    assert exc.value.code == 1
    assert "disagree with their plain versions" in capsys.readouterr().err


def test_chip_smoke_chained_phase_fails_without_border_points(
        monkeypatch, capsys):
    """At an eps where every point is core, 13.3's border check would
    prove nothing: the phase fails."""
    with pytest.raises(SystemExit) as exc:
        _chained_phase(monkeypatch, sizes=dict(REHEARSAL, border_eps=2.6))
    assert exc.value.code == 1
    assert "holds no border point" in capsys.readouterr().err


def test_chip_smoke_chained_phase_fails_on_a_wrong_count(monkeypatch,
                                                         capsys):
    """A min-label pass counted twice: the launches no longer equal the
    partitions' passes, and the phase fails."""
    with pytest.raises(SystemExit) as exc:
        _chained_phase(monkeypatch, spoil="minlab_pairs")
    assert exc.value.code == 1
    assert "launches do not match" in capsys.readouterr().err


def test_chip_smoke_chained_phase_fails_on_a_foreign_border(monkeypatch,
                                                            capsys):
    """A border point that the single-device fit is made to put in a far
    cluster: it lies within eps of no core there, and the phase fails."""
    import numpy as np

    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN

    X, _ = make_blob_data(REHEARSAL["n"], 16, n_centers=32, std=0.4)
    fit = DBSCAN(eps=REHEARSAL["eps"], min_samples=10,
                 block=REHEARSAL["block"], device="cpu").fit(X)
    labels, core = fit.labels_.copy(), fit.core_sample_mask_
    b = int(np.flatnonzero((labels >= 0) & ~core)[0])
    labels[b] = labels[core & (labels != labels[b])][0]
    with pytest.raises(SystemExit) as exc:
        _chained_phase(monkeypatch,
                       main=dict(X=X, labels=labels, core=core))
    assert exc.value.code == 1
    assert "is not within eps of a core" in capsys.readouterr().err


def test_chip_smoke_chained_phase_fails_when_the_cpu_run_differs(
        monkeypatch, capsys):
    """One label off in 13.1's CPU run fails the phase when the CPU runs
    are held at its end."""
    import chip_smoke

    runs = chip_smoke.chained_cpu_runs

    def spoiled(cases):
        out = runs(cases)
        (lab, core), sec = out["small"]
        lab = lab.copy()
        lab[0] += 1
        out["small"] = ((lab, core), sec)
        return out

    monkeypatch.setattr(chip_smoke, "chained_cpu_runs", spoiled)
    with pytest.raises(SystemExit) as exc:
        _chained_phase(monkeypatch)
    assert exc.value.code == 1
    assert "13.1 card vs CPU: the chained fits differ" in (
        capsys.readouterr().err)


def test_chained_cpu_refs_child_holds_its_points(capsys):
    """The child process's runs equal this process's, and a child whose
    points are not the phase's fails it."""
    import numpy as np

    import chip_smoke

    refs = chip_smoke.ChainedCpuRefs(REHEARSAL)
    cases = chip_smoke.chained_cpu_cases(REHEARSAL)
    here = chip_smoke.chained_cpu_runs(cases)
    got = refs.result(cases)
    for name in cases:
        for a, b in zip(got[name][0], here[name][0]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    refs = chip_smoke.ChainedCpuRefs(REHEARSAL)
    other = chip_smoke.chained_cpu_cases(dict(REHEARSAL, small_n=1499))
    with pytest.raises(SystemExit):
        refs.result(other)
    assert "made other points" in capsys.readouterr().err
