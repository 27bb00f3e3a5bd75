"""``chip_smoke.py``'s phase 10 (the density hierarchy) rehearsed on the
CPU at small sizes: the kernels' wrappers run their plain versions and
count their calls as launches, so the phase's gates and record run
without a card, and a spoilt cut fails it.  Apart from
``tests/test_torch_hierarchy.py`` so that the two run on separate
workers."""

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


# Phase 10 at small sizes, at a ceiling of 2.0 (at 6,000 points few
# points have 10 neighbours within 1.15).  The cap (set below) lets the
# default ceiling's graph through at 3,000 points and not at 4,000.  At
# 6,000 twin-blob points a ceiling of 1.1 and min_cluster_size 50 cut
# inside it.
REHEARSAL = dict(n=6000, auto_n=2000, small_n=3000, block=128,
                 small_block=128, eps_max=2.0, edges=None, queries=256,
                 hav_eps_max_m=800.0, twin_n=6000, twin_std=1.0,
                 twin_eps_max=1.1, twin_mcs=50)


def _hier_phase(monkeypatch, spoil=None):
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck

    for name in ("count_pairs", "minlab_pairs", "count_pairs_default",
                 "minlab_pairs_default", "query_leaf"):
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, name, counted)
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "400000")
    if spoil is not None:
        from pypardis_tpu_torch.ops import hierarchy as H

        cut = H.Hierarchy.labels_at_thr

        def spoilt(self, thr):
            lab, core = cut(self, thr)
            lab = lab.clone()
            lab[torch.nonzero(core).flatten()[-1]] = -1
            return lab, core
        monkeypatch.setattr(H.Hierarchy, "labels_at_thr", spoilt)
    return chip_smoke.hier_phase(torch, torch.device("cpu"), lambda: None,
                                 "cpu rehearsal", REHEARSAL)


def test_chip_smoke_hier_phase_rehearses_on_the_cpu(monkeypatch):
    rec = _hier_phase(monkeypatch)
    assert set(rec) == {"fit", "auto", "default", "haversine", "interior",
                        "card"}
    assert rec["default"]["n"] == 3000
    assert rec["fit"]["graph_pairs"] > 0 and rec["fit"]["eps_"] > 0
    assert rec["fit"]["boruvka_rounds"] <= rec["fit"]["round_cap"]
    assert rec["auto"]["rungs"] >= 2
    assert rec["haversine"]["b5_launches"] >= 1
    assert rec["interior"]["eps_"] < rec["interior"]["eps_max"]


def test_chip_smoke_hier_phase_fails_on_a_spoilt_cut(monkeypatch, capsys):
    """One core point's label dropped from every cut: the eps=None fit
    no longer equals fit(eps_), and the phase fails."""
    with pytest.raises(SystemExit) as exc:
        _hier_phase(monkeypatch, spoil=True)
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "eps=None against fit(eps_)" in err and "the fits differ" in err
