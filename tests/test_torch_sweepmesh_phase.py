"""``chip_smoke.py``'s phase 21 (sweeps and the eps-free hierarchy on a
mesh that repeats one device, cityblock on the global-Morton engine)
rehearsed on the CPU at small sizes: the kernels' wrappers run their
plain versions and count their calls as launches (the L1 passes too),
so the phase's gates, its record and its failures run without a card."""

import numpy as np
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
                 emb_block=128, shards=[4, 8], sweep_eps=[1.6, 2.0],
                 sweep_ms=[5, 10], hier_max=1.6, l1_eps=6.0,
                 l1_cases=[[4, "device"], [8, "host"]], l1_chain=3, mesh=4,
                 n=4000, block=128, eps_max=2.2, edges=None, l1_n=2000,
                 trace_cap=8)
KERNELS = ("count_pairs", "minlab_pairs")
L1 = ("count_pairs_l1", "minlab_pairs_l1")


def _phase(monkeypatch, spoil_fit=False, cpu_refs=False, keep=None):
    """Phase 21 on the CPU, every wrapper counting its calls.
    ``spoil_fit``: the counts wrapper's counts all 0, so the route's fits
    (every point noise) differ from its sweep's configs;
    ``cpu_refs``: 21.1's CPU runs from a child process (else they run
    first, in this one)."""
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck

    for name in KERNELS + L1:
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            if _n in L1:
                ck.L1_PASSES[_n] += 1
            else:
                ck.LAUNCHES[_n] += 1
            out = _f(*a, **kw)
            if spoil_fit and _n == "count_pairs":
                if isinstance(out, tuple):
                    out = (torch.zeros_like(out[0]),) + out[1:]
                else:
                    out = torch.zeros_like(out)
            return out
        monkeypatch.setattr(ck, name, counted)
    refs = (chip_smoke.ChainedCpuRefs(REHEARSAL, jobs=("sweepmesh",))
            if cpu_refs else None)
    return chip_smoke.sweepmesh_phase(
        torch, torch.device("cpu"), lambda: None, "cpu rehearsal",
        REHEARSAL, cpu_refs=refs, keep=keep, hier_eps=0.5)


@pytest.mark.parametrize("cpu_refs", [False, True])
def test_chip_smoke_sweepmesh_phase_rehearses_on_the_cpu(monkeypatch,
                                                         cpu_refs):
    rec = _phase(monkeypatch, cpu_refs=cpu_refs)
    assert set(rec["small"]) == {
        "p4_kd_sweep", "p4_kd_hier", "p4_global_morton_sweep",
        "p4_global_morton_hier", "p8_kd_sweep", "p8_kd_hier",
        "p8_global_morton_sweep", "p8_global_morton_hier", "p4_l1_device",
        "p8_l1_host", "chain3_l1"}
    for route in ("kd", "global_morton"):
        row = rec["sweep"][route]
        assert row["configs"] == 16 and row["graph_pairs"] > 0
        assert row["graph_device_bytes"] == 12 * row["graph_pairs"]
        assert row["launches"]["count_pairs"] > 0
        assert row["launches"]["minlab_pairs"] > 0
        assert len(row["fits_s"]) == 2
    assert rec["sweep"]["global_morton"]["boundary_tiles"] > 0
    assert rec["sweep"]["kd"]["halo_factor"] > 0
    assert rec["hier"]["eps_"] > 0 and rec["hier"]["phase10_eps_"] == 0.5
    assert rec["cityblock"]["l1_passes"]["count_pairs_l1"] > 0
    assert set(rec["fit_launches"]) == {"kd", "global_morton"}


def test_chip_smoke_sweepmesh_phase_takes_phase_9s_configs(monkeypatch):
    """Handed phase 9's single-card results (from a CPU tensor, as 9.4
    sweeps from a CUDA one), the phase holds every config against them
    and the cityblock fit against 9.3's."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN

    X, _t = make_blob_data(REHEARSAL["n"], 16, n_centers=32, std=0.4)
    eps_max = REHEARSAL["eps_max"]
    eps = [round(eps_max * (i + 1) / 8, 6) for i in range(8)]
    res = DBSCAN(eps=eps_max, min_samples=10, block=128, device="cpu").sweep(
        torch.from_numpy(X), eps, [5, 10])
    one = DBSCAN(eps=6.0, min_samples=10, metric="cityblock", block=128,
                 device="cpu").fit(X[:REHEARSAL["l1_n"]])
    keep = {"sweep": {c: (res.labels(*c), res.core(*c))
                      for c in res.configs},
            "l1": dict(labels=one.labels_, core=one.core_sample_mask_)}
    rec = _phase(monkeypatch, keep=keep)
    assert rec["sweep"]["kd"]["configs"] == 16


def test_chip_smoke_sweepmesh_phase_fails_when_a_fit_differs(monkeypatch,
                                                             capsys):
    with pytest.raises(SystemExit) as exc:
        _phase(monkeypatch, spoil_fit=True)
    assert exc.value.code == 1
    assert "differs from the fit at it" in capsys.readouterr().err


def test_chip_smoke_sweepmesh_phase_fails_when_the_cpu_run_differs(
        monkeypatch, capsys):
    import chip_smoke

    runs = chip_smoke.sweepmesh_cpu_runs

    def spoiled(cases):
        out = runs(cases)
        (lab, core, st), sec = out["p8_kd_sweep"]
        lab = np.array(lab, copy=True)
        lab[0, 0] += 1
        out["p8_kd_sweep"] = ((lab, core, st), sec)
        return out

    monkeypatch.setattr(chip_smoke, "sweepmesh_cpu_runs", spoiled)
    with pytest.raises(SystemExit) as exc:
        _phase(monkeypatch)
    assert exc.value.code == 1
    assert "21.1 p8_kd_sweep: the card's run differs" in (
        capsys.readouterr().err)


@pytest.fixture(scope="module")
def small_fit():
    """A 2,000-row 16-D blob fit on one device: ``(X, eps, ms, labels,
    core)``."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN

    X, _t = make_blob_data(2000, 16, n_centers=8, std=0.4)
    m = DBSCAN(eps=1.4, min_samples=10, block=128, device="cpu").fit(X)
    return X, 1.4, 10, m.labels_, m.core_sample_mask_


def test_chip_smoke_same_frame_hold_fails_on_a_moved_border(small_fit,
                                                            capsys):
    """A border moved to a cluster none of its cores within eps belongs
    to is not a tie of the border rule; a core flag that differs fails
    first."""
    import chip_smoke

    X, eps, _ms, lab, core = small_fit
    dev = torch.device("cpu")
    assert chip_smoke.hold_same_frame(torch, dev, X, eps, lab, core, lab,
                                      core, "same")[0] == 0
    border = np.flatnonzero((lab >= 0) & ~core)
    b = int(border[0])
    other = lab.copy()
    other[b] = int(lab[(lab >= 0) & (lab != lab[b])][0])
    with pytest.raises(SystemExit):
        chip_smoke.hold_same_frame(torch, dev, X, eps, other, core, lab,
                                   core, "moved")
    assert "is not a tie of the border rule" in capsys.readouterr().err
    spoilt = core.copy()
    spoilt[np.flatnonzero(core)[0]] = False
    with pytest.raises(SystemExit):
        chip_smoke.hold_same_frame(torch, dev, X, eps, lab, spoilt, lab,
                                   core, "core")
    assert "core flags differ" in capsys.readouterr().err


def test_chip_smoke_frame_trace_needs_the_deciding_pair(small_fit, capsys):
    """A core flag that differs passes only where the point's
    min_samples-th d^2 lies within exact_slack of eps^2: a point deep in
    its blob fails, the same point passes at an eps set to that d^2."""
    import chip_smoke

    X, eps, ms, lab, core = small_fit
    dev = torch.device("cpu")
    Xc = (X - X.mean(axis=0, dtype=np.float64)).astype(np.float32)
    d2 = ((Xc[:, None, :] - Xc[None, :, :]) ** 2).sum(-1)
    kth = np.sort(d2, axis=1)[:, ms - 1]
    p = int(np.argmin(np.where(core, kth, np.inf)))
    flipped = core.copy()
    flipped[p] = False
    with pytest.raises(SystemExit):
        chip_smoke.trace_frame_flips(torch, dev, X, eps, ms, lab, core, lab,
                                     flipped, "deep", trace_cap=8)
    assert "deciding d2" in capsys.readouterr().err
    at = float(np.sqrt(np.float64(kth[p])))
    n, a = chip_smoke.trace_frame_flips(torch, dev, X, at, ms, lab, core,
                                        lab, flipped, "decisive", trace_cap=8)
    assert n == 1 and a == 1.0
