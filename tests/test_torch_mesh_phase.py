"""``chip_smoke.py``'s phase 17 (the KD route's fused multi-device step
on a mesh that repeats one device) rehearsed on the CPU at small sizes:
the kernels' wrappers run their plain versions and count their calls as
launches, so the phase's gates, its record and its failures run without
a card."""

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
                 emb_block=128, mesh=4,
                 small_cases=[["high", "device", True],
                              ["mixed", "host", False],
                              ["default", "host", True]],
                 n=4000, eps=2.4, block=128, hold_tiles=4, border_eps=2.2,
                 sk_n=600, sk_eps=2.0, sk_block=128, chain_n=512)
KERNELS = ("count_pairs", "minlab_pairs", "count_pairs_mixed",
           "minlab_pairs_mixed", "count_pairs_default",
           "minlab_pairs_default", "count_pairs_sketch",
           "minlab_pairs_sketch")


def _mesh_phase(monkeypatch, spoil=None, spoil_hold=None, sizes=REHEARSAL,
                cpu_refs=False):
    """Phase 17 on the CPU, every wrapper counting its calls as
    launches.  ``spoil``: a kernel whose launches count twice;
    ``spoil_hold``: a kernel whose first output word is off by one
    inside the largest-slab hold only; ``cpu_refs``: 17.1's CPU runs
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
    refs = (chip_smoke.ChainedCpuRefs(sizes, jobs=("mesh",)) if cpu_refs
            else None)
    return chip_smoke.mesh_phase(torch, torch.device("cpu"), lambda: None,
                                 "cpu rehearsal", sizes, cpu_refs=refs,
                                 walls={"single": 1.0, "chained": 2.0})


@pytest.mark.parametrize("cpu_refs", [False, True])
def test_chip_smoke_mesh_phase_rehearses_on_the_cpu(monkeypatch, cpu_refs):
    rec = _mesh_phase(monkeypatch, cpu_refs=cpu_refs)
    assert rec["mesh"] == ["cpu"] * 4
    assert set(rec["small"]) == {"small_high_device_oc",
                                 "small_mixed_host_dup",
                                 "small_default_host_oc", "emb"}
    for tag in ("main", "host", "border"):
        row = rec[tag]
        assert row["n_shard_partitions"] == 4
        assert row["launches"] == {
            "count_pairs": 4,
            "minlab_pairs": sum(p - 1 for p in row["partition_passes"])}
        assert row["duplicated_work_factor"] == 4 * row["owned_cap"] / 4000
        for key in ("halo_sets", "slab_build", "ship", "device", "loop"):
            assert row["stage_s"][key] >= 0, key
    assert rec["main"]["merge_rounds"] >= 1
    assert rec["host"]["merge_rounds"] is None
    hold = rec["main"]["slab_hold"]
    assert hold["owned"] > 0 and hold["halo"] > 0
    assert hold["max_abs_err"] == {"count_pairs": 0, "minlab_pairs": 0}
    assert rec["border"]["borders"] > 0
    sk = rec["sketch"]
    assert sk["sketch_k"] > 0
    assert sk["launches"]["count_pairs_sketch"] == 4
    assert sk["slab_hold"]["max_abs_err"] == {"count_pairs_sketch": 0,
                                              "minlab_pairs_sketch": 0}
    assert rec["ladders"] == {"pair_budget_reruns": 1,
                              "merge_rounds_retries": 1,
                              "merge_rounds": rec["ladders"]["merge_rounds"],
                              "oom_merge": "host"}
    assert rec["ladders"]["merge_rounds"] > 1


@pytest.mark.parametrize("kernel", ["count_pairs", "minlab_pairs"])
def test_chip_smoke_mesh_phase_fails_on_a_wrong_slab_word(monkeypatch,
                                                          capsys, kernel):
    with pytest.raises(SystemExit) as exc:
        _mesh_phase(monkeypatch, spoil_hold=kernel)
    assert exc.value.code == 1
    assert "disagree with their plain versions" in capsys.readouterr().err


def test_chip_smoke_mesh_phase_fails_on_a_wrong_count(monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        _mesh_phase(monkeypatch, spoil="minlab_pairs")
    assert exc.value.code == 1
    assert "launches do not match" in capsys.readouterr().err


def test_chip_smoke_mesh_phase_fails_when_the_cpu_run_differs(monkeypatch,
                                                              capsys):
    import chip_smoke

    runs = chip_smoke.mesh_cpu_runs

    def spoiled(cases, shards=4):
        out = runs(cases, shards)
        (lab, core, st), sec = out["small_mixed_host_dup"]
        lab = lab.copy()
        lab[0] += 1
        out["small_mixed_host_dup"] = ((lab, core, st), sec)
        return out

    monkeypatch.setattr(chip_smoke, "mesh_cpu_runs", spoiled)
    with pytest.raises(SystemExit) as exc:
        _mesh_phase(monkeypatch)
    assert exc.value.code == 1
    assert "17.1 small_mixed_host_dup: the card's mesh fit differs" in (
        capsys.readouterr().err)
