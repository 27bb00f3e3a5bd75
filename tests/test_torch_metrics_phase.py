"""``chip_smoke.py``'s phase 9 (the metrics and the sweep) rehearsed on
the CPU at small sizes: the kernels' wrappers run their plain versions
and count their calls as launches, so the phase's gates, records and a
failing count run without a card.  Apart from
``tests/test_torch_metrics.py`` so that the two run on separate workers."""

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


# chip_smoke.py's phase 9 at small sizes on the CPU: the wrappers run
# their plain versions and count their calls as launches (on the card
# each call is one launch), so the phase's gates and records rehearse.
REHEARSAL = dict(cos_n=1500, cos_serve_n=1000, check_n=600, hav_n=3000,
                 l1_n=8000, l1_fit_n=8000, l1_sub_n=800, queries=256,
                 oracle_rows=4,
                 sub_tiles=1, plain_tiles=1, reps=1, block=128,
                 sweep_edges=None)


def _metrics_phase(monkeypatch, spoil=None):
    import time

    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck

    for name in ("count_pairs", "minlab_pairs", "count_pairs_sketch",
                 "minlab_pairs_sketch", "query_leaf", "count_pairs_l1",
                 "minlab_pairs_l1"):
        table = ck.L1_PASSES if name.endswith("_l1") else ck.LAUNCHES

        def counted(*a, _f=getattr(ck, name), _n=name, _t=table, **kw):
            _t[_n] += 2 if _n == spoil else 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, name, counted)
    # The cap between the rehearsal's eps_max graph and the one past it.
    monkeypatch.setenv("PPTORCH_SWEEP_MAX_PAIRS", "20000")

    def median_ms(fn, reps):
        """``chip_smoke.main``'s contract on the host clock: one warm-up
        call, then ``reps`` timed calls."""
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / max(reps, 1)

    return chip_smoke.metrics_phase(torch, torch.device("cpu"), median_ms,
                                    lambda: None, REHEARSAL)


def test_chip_smoke_metrics_phase_rehearses_on_the_cpu(monkeypatch):
    kernels, rec = _metrics_phase(monkeypatch)
    assert [k["name"] for k in kernels] == [
        "count_pairs_sketch", "minlab_pairs_sketch", "query_leaf",
        "count_pairs", "minlab_pairs", "query_leaf"]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        assert keys <= set(k) and k["max_abs_err"] == 0
        assert k["launches"] >= 1 and k["bound_ms"] > 0
    assert set(rec) == {"cosine", "haversine", "cityblock", "sweep"}
    assert rec["sweep"]["configs"] == 16 and rec["sweep"]["graph_pairs"] > 0
    assert rec["cityblock"]["ari"] >= 0.99


def test_chip_smoke_metrics_phase_fails_on_a_wrong_l1_count(monkeypatch,
                                                           capsys):
    """A cityblock counts pass counted twice: the passes on the card no
    longer equal the fit's, and the phase fails."""
    with pytest.raises(SystemExit) as exc:
        _metrics_phase(monkeypatch, spoil="count_pairs_l1")
    assert exc.value.code == 1
    assert "L1 passes do not match" in capsys.readouterr().err
