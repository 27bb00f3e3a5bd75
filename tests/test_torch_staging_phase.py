"""``chip_smoke.py``'s phase 19 (the staging cache's warm routes)
rehearsed on the CPU at small sizes: the kernels' wrappers run their
plain versions and count their calls as launches, so the phase's gates,
its record and its failures run without a card."""

import pytest
import torch

from pypardis_tpu_torch.parallel import staging


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The port's tests are large elementwise torch ops; under the
    suite's parallel workers all-core thread pools only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_staging():
    staging.clear()
    yield
    staging.clear()


REHEARSAL = dict(n=3000, eps=2.4, block=256, other_ms=20, miss_eps=1.4,
                 fp_reps=2, sweep_n=2000, sweep_eps=[2.0, 2.4], warm_eps=1.8,
                 small_n=1500, mesh=4, live_rows=4)
KERNELS = ("count_pairs", "minlab_pairs", "query_leaf")


def _staging_phase(monkeypatch):
    """Phase 19 on the CPU, every wrapper counting its calls."""
    import chip_smoke
    from pypardis_tpu_torch.ops import cuda_kernels as ck

    for name in KERNELS:
        def counted(*a, _f=getattr(ck, name), _n=name, **kw):
            ck.LAUNCHES[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(ck, name, counted)
    return chip_smoke.staging_phase(torch, torch.device("cpu"),
                                    lambda: None, "cpu rehearsal", REHEARSAL)


def test_chip_smoke_staging_phase_rehearses_on_the_cpu(monkeypatch):
    rec = _staging_phase(monkeypatch)
    lay = rec["layout"]
    assert lay["staged_bytes"] > 0
    assert set(lay["fingerprint_ms"]) == {"float32", "float64"}
    assert lay["launches_warm"] == lay["launches_cold"]
    assert lay["launches_warm"]["count_pairs"] == 1
    assert lay["launches_warm"]["minlab_pairs"] >= 1
    assert rec["sweep"]["reused_bytes"] > 0
    assert rec["oom"]["injected"] == 1 and rec["oom"]["retried"] >= 1
    serve = rec["serve"]
    assert serve["warm_build_reused"] == serve["index_staged_bytes"] > 0
    assert serve["delta_bytes"] > 0 and serve["query_leaf"] >= 1
    assert rec["launches_warm"]["query_leaf"] == serve["query_leaf"]


def test_chip_smoke_staging_phase_fails_when_a_warm_fit_misses(monkeypatch):
    """A cache that never serves the layout fails 19.1's warm gate."""
    import chip_smoke

    get = staging.device_get
    monkeypatch.setattr(
        staging, "device_get",
        lambda route, key: None if route == "pipeline_layout"
        else get(route, key))
    monkeypatch.setattr(chip_smoke, "fail", _raise)
    with pytest.raises(AssertionError, match="19.1: the warm fit staged"):
        _staging_phase(monkeypatch)


def _raise(msg):
    raise AssertionError(msg)
