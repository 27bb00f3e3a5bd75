"""Deterministic fault injection (counterpart of
``pypardis_tpu/utils/faults.py``).

A :class:`FaultPlan` (parsed from ``PPTORCH_FAULTS`` or installed
programmatically) maps **injection sites**, stable names threaded
through the hot paths, to counted-occurrence fault kinds, so a test or
a probe replays the identical failure on every run.

Spec grammar (comma-separated entries)::

    site[:occurrence]=kind[(arg)]

    stepped.batch:2=error              # 2nd round batch dies
    chained.partition:3=oom            # 3rd partition raises an OOM
    serve.drain:1=hang(3s)             # 1st drain stalls 3 seconds
    stepped.batch:*=hang(0.5)          # EVERY batch stalls 0.5 s

Occurrences are 1-based arrival counts per site (``*``: every arrival).

Fault kinds (the messages keep the JAX package's signatures, so the
classifiers of :mod:`.retry` treat an injected fault as the real one):

* ``transfer_error``: raises :class:`FaultInjected` whose message
  carries ``UNAVAILABLE``, the one transient signature the port retries;
* ``oom``: raises with ``RESOURCE_EXHAUSTED ... Out of memory``:
  degradable at ``sharded.execute`` (the KD route's device merge
  finishes on the host), raised everywhere else;
* ``error``: a terminal failure (the giveup paths, and the jobstate's
  kill window without a subprocess);
* ``hang(Ns)``: sleeps N seconds and returns (a stalled drain, and a
  kill window a probe can aim at).

Injection sites, each inside the retry scope that owns recovery:

===================== ====================================================
``pipeline.cluster``   fused single-card cluster dispatch
``stepped.batch``      host-stepped propagation round batches
``chained.partition``  the chained route's per-partition dispatches
``sharded.execute``    the KD route's device merge, chained or fused
                       (the JAX site sits before the fused step that
                       runs the partitions and the merge; the port's
                       before the merge alone, the one part an OOM
                       spill cures)
``gm.execute``         each ladder attempt of the global-Morton route
                       (mesh engine and chained form), before its passes
``gm.chained_range``   each range's counts and propagation dispatch on
                       the chained form (one per range and pass)
``gm.exchange``        the mesh engine's boundary exchange, once per fit
                       before its cache lookup (an ``oom`` there is the
                       ``kd_owner_computes`` rung of ``DBSCAN``)
``gm.ring_round``      each ring round of the boundary exchange
``gm.fixpoint_round``  each round of the mesh engine's device fixpoint
``serve.drain``        :meth:`QueryEngine.drain`
``ingest.batch``       ``LiveModel.insert_batch`` / ``delete_batch``,
                       fired before any state changes
``compact.phase``      each compaction phase boundary (snapshot / refit
                       / build / swap: occurrences 1..4 per cycle)
``gateway.admit``      every gateway admission, upstream of the quota
``staging.device_put`` every host-to-device copy of the staging cache's
                       routes (:func:`~..parallel.staging.transfer`): an
                       ``oom`` there evicts the cache and retries
===================== ====================================================

The JAX package's other site, ``dist.worker``, comes with the process
layer (ROADMAP A10, §A item 5).

``PPTORCH_FAULTS`` is read at import and again at the start of every
fit (:func:`from_env`), so one process can set it for a single fit.
When no plan is set, :func:`maybe_fail` costs one module-global ``is
None`` check and records nothing.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Dict, List, Optional, Tuple

_KINDS = ("transfer_error", "oom", "error", "hang")

KNOWN_SITES = (
    "pipeline.cluster",
    "stepped.batch",
    "chained.partition",
    "sharded.execute",
    "gm.execute",
    "gm.chained_range",
    "gm.exchange",
    "gm.ring_round",
    "gm.fixpoint_round",
    "serve.drain",
    "ingest.batch",
    "compact.phase",
    "gateway.admit",
    "staging.device_put",
)

_ENTRY_RE = re.compile(
    r"^(?P<site>[a-z0-9_.]+?)(?::(?P<occ>\*|\d+))?="
    r"(?P<kind>[a-z_]+)(?:\((?P<arg>[^)]*)\))?$"
)


class FaultInjected(RuntimeError):
    """An injected fault (never raised on a clean run); the message
    embeds the signature of the error class its kind imitates."""

    def __init__(self, site: str, kind: str, message: str):
        super().__init__(message)
        self.site = site
        self.kind = kind


class FaultPlan:
    """Parsed injection plan with per-site arrival counters."""

    def __init__(self, entries: Dict[str, List[Tuple[object, str, float]]],
                 spec: str):
        # site -> [(occurrence | "*", kind, arg), ...]
        self.entries = entries
        self.spec = spec
        self._arrivals: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries: Dict[str, List[Tuple[object, str, float]]] = {}
        for raw in str(spec).split(","):
            raw = raw.strip()
            if not raw:
                continue
            m = _ENTRY_RE.match(raw)
            if not m:
                raise ValueError(
                    f"bad PPTORCH_FAULTS entry {raw!r}; expected "
                    f"site[:occurrence]=kind[(arg)], e.g. "
                    f"stepped.batch:2=transfer_error or "
                    f"serve.drain:1=hang(3s)"
                )
            kind = m.group("kind")
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in {raw!r}; one of "
                    f"{'|'.join(_KINDS)}"
                )
            occ: object = m.group("occ") or "1"
            if occ != "*":
                occ = int(occ)
                if occ < 1:
                    raise ValueError(
                        f"occurrence must be >= 1 or '*' in {raw!r}"
                    )
            arg = 0.0
            if m.group("arg"):
                arg = float(m.group("arg").rstrip("s"))
            entries.setdefault(m.group("site"), []).append((occ, kind, arg))
        return cls(entries, str(spec))

    def check(self, site: str) -> None:
        rules = self.entries.get(site)
        if rules is None:
            return
        n = self._arrivals.get(site, 0) + 1
        self._arrivals[site] = n
        for occ, kind, arg in rules:
            if occ == "*" or occ == n:
                self._fire(site, kind, arg, n)

    def _fire(self, site: str, kind: str, arg: float, occurrence: int
              ) -> None:
        self.injected[site] = self.injected.get(site, 0) + 1
        # Telemetry before the raise: the current recorder counts every
        # injection (report()["faults"]["injected"]) and the event names
        # the site (the event helper's positional is ``kind``, so the
        # fault's kind rides as ``fault_kind``).
        from ..obs import current, event
        from .log import get_logger

        current().metrics.inc("faults.injected")
        event("fault_injected", site=site, fault_kind=kind,
              occurrence=occurrence)
        get_logger().warning(
            "fault injection: %s at %s (occurrence %d)",
            kind, site, occurrence,
        )
        if kind == "hang":
            time.sleep(max(arg, 0.0))
            return
        if kind == "transfer_error":
            raise FaultInjected(
                site, kind,
                f"UNAVAILABLE: injected transfer_error at {site} "
                f"(PPTORCH_FAULTS occurrence {occurrence})",
            )
        if kind == "oom":
            raise FaultInjected(
                site, kind,
                f"RESOURCE_EXHAUSTED: injected oom at {site}: Out of "
                f"memory (PPTORCH_FAULTS occurrence {occurrence})",
            )
        raise FaultInjected(
            site, kind,
            f"injected terminal error at {site} "
            f"(PPTORCH_FAULTS occurrence {occurrence})",
        )


# The active plan: None on clean runs (maybe_fail's whole cost is this
# one check), and the PPTORCH_FAULTS spec it was last synced from.
_PLAN: Optional[FaultPlan] = None
_ENV_SPEC: Optional[str] = None


def from_env() -> Optional[FaultPlan]:
    """Sync the plan with ``PPTORCH_FAULTS``: a spec that changed since
    the last read installs afresh (counters from zero); an unset one
    clears a plan that came from the environment and leaves a
    programmatic one alone.  The fit entry points call this."""
    global _PLAN, _ENV_SPEC
    spec = os.environ.get("PPTORCH_FAULTS") or None
    if spec != _ENV_SPEC:
        from_env_plan = _PLAN is not None and _PLAN.spec == _ENV_SPEC
        _ENV_SPEC = spec
        if spec:
            _PLAN = FaultPlan.parse(spec)
        elif from_env_plan:
            _PLAN = None
    return _PLAN


from_env()


def install(spec: Optional[str]) -> Optional[FaultPlan]:
    """Install a plan programmatically (None clears); returns it.
    Arrival counters start fresh, so reinstalling a spec replays it."""
    global _PLAN
    _PLAN = FaultPlan.parse(spec) if spec else None
    return _PLAN


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    return _PLAN


@contextlib.contextmanager
def plan(spec: str):
    """Scoped plan for tests: installed on entry, the previous plan
    restored on exit."""
    global _PLAN
    prev = _PLAN
    _PLAN = FaultPlan.parse(spec)
    try:
        yield _PLAN
    finally:
        _PLAN = prev


def maybe_fail(site: str) -> None:
    """The injection hook: a no-op unless a plan names this site."""
    if _PLAN is None:
        return
    _PLAN.check(site)


def fault_stats() -> Dict[str, int]:
    """{site -> injections fired} for the active plan ({} when none)."""
    return dict(_PLAN.injected) if _PLAN is not None else {}
