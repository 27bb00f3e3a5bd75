"""Multi-tenant serving gateway: a model registry under a residency
budget, per-tenant admission control and hot swap (counterpart of
``pypardis_tpu/serve/gateway.py``).

The engine, the index and the live model serve one fitted model each.
:class:`ModelGateway` serves many on one card by composition over model
handles:

* **Registry and residency budget.** ``register(model_id, model)``
  builds the model's :class:`~.engine.QueryEngine` under the handle
  ``model_id`` (``handle`` threads through ``build_index``,
  ``CorePointIndex``, ``QueryEngine`` and ``LiveModel``).  A byte
  budget over the resident indexes' ``index_bytes``
  (``PPTORCH_GATEWAY_BUDGET_BYTES``; 0 = none) is enforced whenever a
  model is registered or readmitted: the ``lru`` (least recently served)
  or ``largest`` resident is **spilled** with
  :func:`~pypardis_tpu_torch.checkpoint.save_index` and its device
  tensors are released (:meth:`~.index.CorePointIndex.release`), so the
  card's allocator gets them back.  A request for an evicted model
  **readmits** it through ``load_index`` onto the model's device: the
  slabs reload byte for byte and B5's tables are rebuilt inside the
  readmission window, so the readmitted model answers bitwise as before.

* **Admission control.** Every request passes one gate: a per-tenant
  token bucket (``qps`` + ``burst``; defaults
  ``PPTORCH_GATEWAY_TENANT_QPS`` / ``_BURST``) sheds an over-quota
  tenant with :class:`TenantQuotaExceeded` before any engine is
  touched, so a hot tenant cannot starve another's p99.  ``timeout_s``
  rides the engine's ticket deadline
  (:class:`~.engine.DeadlineExceeded`); a full queue raises
  :class:`~.engine.QueueFull`.

* **Hot swap.** ``refresh(model_id, model)`` builds the refreshed
  clustering's index in the old generation's frame, drains in-flight
  tickets against the old slabs, and installs the new generation in
  place (:meth:`~.index.CorePointIndex.replace_generation`): no ticket
  is dropped.

* **Telemetry.** :meth:`gateway_report` gives the
  ``pypardis_tpu/gateway_report@1`` block (per-tenant windowed latency
  :class:`~pypardis_tpu_torch.obs.Histogram`\\ s, residency, eviction,
  reload and swap counters, admission sheds); the same numbers go into
  the recorder's registry under ``gateway.model.<id>.*`` and
  ``gateway.tenant.<id>.*``.

Threads: one re-entrant lock serializes registry changes, admission,
every engine's submit and drain, readmission and the swap.  Readmission
runs on the calling thread; it waits for its upload and its tables
before the window closes, so the B5 a pump thread launches next reads
finished tables whatever stream it runs on.

Not yet ported: the ``gateway.admit`` fault site (``utils/faults``,
ROADMAP A16).  ``gateway_load`` exports the gateway's recorder when the
``PPTORCH_METRICS_*`` knobs ask (:func:`~pypardis_tpu_torch.obs.
attach_exporters`).
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..obs import RunRecorder
from ..obs.registry import sanitize_segment
from .engine import QueryEngine

GATEWAY_REPORT_SCHEMA = "pypardis_tpu/gateway_report@1"

# Defaults of the PPTORCH_GATEWAY_* knobs (constructor kwargs win).
DEFAULT_SPILL_DIR = "~/.cache/pypardis_tpu_torch/gateway"
DEFAULT_TENANT_BURST = 8.0
EVICTION_POLICIES = ("lru", "largest")


def _env_num(name: str, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except (TypeError, ValueError):
        return cast(default)


class GatewayError(RuntimeError):
    """Base of the gateway's refusals (admission, residency, staleness):
    callers catch this to back off without touching engine internals."""


class ModelNotRegistered(GatewayError):
    """A request named a model this gateway has never seen."""


class TenantQuotaExceeded(GatewayError):
    """The admission gate refused a request: the tenant's token bucket is
    empty.  Counted per tenant (``admission_sheds``)."""


class StaleModelHandle(GatewayError):
    """The registered model was refit after registration; the resident
    index serves the PREVIOUS clustering.  The gateway refuses rather
    than serve stale answers; ``refresh()`` swaps the new generation
    in."""


class _TokenBucket:
    """Per-tenant admission quota: ``rate`` requests/s with ``burst``
    capacity; rate <= 0 admits everything (quota off)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.t_last = time.perf_counter()

    def try_take(self) -> bool:
        if self.rate <= 0:
            return True
        now = time.perf_counter()
        self.tokens = min(
            self.burst, self.tokens + (now - self.t_last) * self.rate
        )
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class ModelHandle:
    """One registered model's serving state inside the gateway: its
    engine, index and live model, and the residency bookkeeping (spill
    path, byte size, eviction/reload/swap counters) the budget reads."""

    __slots__ = (
        "model_id", "model", "engine", "index", "live",
        "pinned", "resident", "spill_path", "fit_generation",
        "index_bytes", "engine_kw", "evictions", "reloads", "swaps",
        "queries_done",
    )

    def __init__(self, model_id: str, model):
        self.model_id = str(model_id)
        self.model = model
        self.engine: Optional[QueryEngine] = None
        self.index = None
        self.live = None
        self.pinned = False
        self.resident = False
        self.spill_path: Optional[str] = None
        self.fit_generation = 0
        self.index_bytes = 0
        self.engine_kw: Dict = {}
        self.evictions = 0
        self.reloads = 0
        self.swaps = 0
        self.queries_done = 0


class ModelGateway:
    """Registry of resident fitted models behind one admission gate.

    ``budget_bytes`` caps the summed ``index_bytes`` of the resident
    models (0 = unlimited); ``eviction`` picks the victim policy
    (``lru``/``largest``); ``spill_dir`` holds the spills.
    ``tenant_qps``/``tenant_burst`` set the default per-tenant token
    bucket (:meth:`set_quota` overrides one tenant's).  ``engine_kw``
    are the :class:`~.engine.QueryEngine` kwargs every ``register``
    inherits (``leaves``/``block``/``qblock``/``batch_capacity``/...).
    Each model's index lives on that model's device.
    """

    def __init__(
        self, *,
        budget_bytes: Optional[int] = None,
        eviction: Optional[str] = None,
        spill_dir: Optional[str] = None,
        tenant_qps: Optional[float] = None,
        tenant_burst: Optional[float] = None,
        recorder=None,
        **engine_kw,
    ):
        self.budget_bytes = (
            int(budget_bytes) if budget_bytes is not None
            else _env_num("PPTORCH_GATEWAY_BUDGET_BYTES", 0, int)
        )
        self.eviction = str(
            eviction if eviction is not None
            else os.environ.get("PPTORCH_GATEWAY_EVICTION", "lru")
        ).lower()
        if self.eviction not in EVICTION_POLICIES:
            raise ValueError(
                f"eviction policy {self.eviction!r} is not one of "
                f"{EVICTION_POLICIES}"
            )
        self.spill_dir = os.path.expanduser(str(
            spill_dir if spill_dir is not None
            else os.environ.get("PPTORCH_GATEWAY_SPILL_DIR",
                                DEFAULT_SPILL_DIR)
        ))
        self.tenant_qps = (
            float(tenant_qps) if tenant_qps is not None
            else _env_num("PPTORCH_GATEWAY_TENANT_QPS", 0.0, float)
        )
        self.tenant_burst = (
            float(tenant_burst) if tenant_burst is not None
            else _env_num("PPTORCH_GATEWAY_TENANT_BURST",
                          DEFAULT_TENANT_BURST, float)
        )
        self.engine_kw = dict(engine_kw)
        self.recorder = recorder if recorder is not None else RunRecorder()
        # One lock serializes registry changes, admission, every engine's
        # submit/drain and the swap (re-entrant: refresh and readmission
        # nest inside request handling).
        self.lock = threading.RLock()
        # model_id -> handle; dict order is the LRU order (least recently
        # served first), move_to_end on every touch.
        self._handles: "OrderedDict[str, ModelHandle]" = OrderedDict()
        self._quotas: Dict[str, _TokenBucket] = {}
        # (ticket, tenant) pairs awaiting resolution: swept into the
        # per-tenant histograms at each drain, then dropped.
        self._pending: deque = deque()
        self._tenant: Dict[str, Dict] = {}
        self._counters = {
            "evictions": 0, "reloads": 0, "epoch_swaps": 0,
            "admission_sheds": 0, "admitted": 0, "spilled_bytes": 0,
            "reloaded_bytes": 0,
        }
        # Completed eviction/readmission and swap windows [(t0, t1)] on
        # the perf_counter clock: the load harness sorts read latencies
        # into inside and outside them.
        self.evict_windows: List[Tuple[float, float]] = []
        self.swap_windows: List[Tuple[float, float]] = []

    # -- registry ---------------------------------------------------------

    def register(self, model_id: str, model, *, pin: bool = False,
                 live: bool = False, **engine_kw) -> ModelHandle:
        """Admit a fitted model into the registry and build its serving
        engine under the handle ``model_id``.

        ``pin`` exempts the handle from eviction.  ``live`` serves the
        model's :class:`~.live.LiveModel` (the gateway adopts its engine
        and index, so writes through ``handle.live`` are served at once);
        a live handle is pinned, since a spill does not keep its
        live-update state.
        """
        model._require_fitted()
        mid = str(model_id)
        with self.lock:
            if mid in self._handles:
                raise GatewayError(
                    f"model {mid!r} is already registered with this "
                    f"gateway; call refresh() or unregister() first"
                )
            h = ModelHandle(mid, model)
            h.engine_kw = {**self.engine_kw, **engine_kw}
            h.fit_generation = getattr(model, "_fit_generation", 0)
            if live:
                h.live = model.live(handle=mid)
                h.engine = h.live.engine
                h.index = h.live.index
                h.pinned = True
            else:
                h.engine = QueryEngine.from_model(
                    model, handle=mid, **h.engine_kw
                )
                h.index = h.engine.index
                h.pinned = bool(pin)
            h.resident = True
            h.index_bytes = int(h.index.stats.get("index_bytes", 0))
            self._handles[mid] = h
            self._ensure_budget(keep=mid)
            self._publish()
            return h

    def unregister(self, model_id: str) -> None:
        """Drop a model from the registry, release its index's device
        tensors and remove its spill.  A live handle's index stays with
        its :class:`~.live.LiveModel`, which keeps serving its owner."""
        with self.lock:
            h = self._handles.pop(str(model_id), None)
            if h is None:
                raise ModelNotRegistered(
                    f"this gateway has no model {model_id!r}; "
                    f"call register() first"
                )
            if h.index is not None and h.live is None:
                h.index.release()
            if h.spill_path and os.path.exists(h.spill_path):
                os.unlink(h.spill_path)
            self._publish()

    def handle(self, model_id: str) -> ModelHandle:
        """The resident handle for ``model_id``: an evicted model is
        readmitted first, so the handle always has an engine and an
        index."""
        with self.lock:
            return self._resolve(str(model_id))

    @property
    def model_ids(self) -> List[str]:
        with self.lock:
            return list(self._handles)

    def resident_bytes(self) -> int:
        """Summed ``index_bytes`` of the resident handles: the quantity
        the budget bounds."""
        with self.lock:
            return sum(
                h.index_bytes for h in self._handles.values()
                if h.resident
            )

    # -- residency / eviction ---------------------------------------------

    def _resolve(self, mid: str) -> ModelHandle:
        h = self._handles.get(mid)
        if h is None:
            raise ModelNotRegistered(
                f"this gateway has no model {mid!r}; "
                f"call register() first"
            )
        if h.model is not None and getattr(
            h.model, "_fit_generation", 0
        ) != h.fit_generation:
            raise StaleModelHandle(
                f"model {mid!r} was refit after it was registered; "
                f"this handle serves the PREVIOUS clustering — call "
                f"refresh({mid!r}) first"
            )
        if not h.resident:
            self._readmit(h)
        self._handles.move_to_end(mid)
        return h

    def _victim(self, keep: str) -> Optional[ModelHandle]:
        cands = [
            h for m, h in self._handles.items()
            if h.resident and not h.pinned and m != keep
        ]
        if not cands:
            return None
        if self.eviction == "largest":
            return max(cands, key=lambda h: h.index_bytes)
        return cands[0]  # lru: dict order is least recently served

    def _ensure_budget(self, keep: str) -> None:
        """Evict until the residents fit the budget (``keep``, the model
        a request is being served from, is never its own victim)."""
        if self.budget_bytes <= 0:
            return
        while self.resident_bytes() > self.budget_bytes:
            victim = self._victim(keep)
            if victim is None:
                return  # everything left is pinned or in use
            self._evict(victim)

    def _evict(self, h: ModelHandle) -> None:
        """Spill ``h`` to disk (``save_index``) and release its index's
        device tensors; the handle stays registered and readmits on
        demand."""
        from ..checkpoint import save_index

        t0 = time.perf_counter()
        os.makedirs(self.spill_dir, exist_ok=True)
        h.spill_path = os.path.join(
            self.spill_dir, f"{sanitize_segment(h.model_id)}.npz"
        )
        # Resolve straggler tickets against the resident slabs first: an
        # eviction never strands a read, and no batch in flight keeps
        # the released tensors alive.
        h.engine.drain()
        self._sweep()
        h.queries_done += int(h.engine.queries)
        save_index(h.index, h.spill_path)
        h.index.release()
        h.index = None
        h.engine = None
        h.resident = False
        h.evictions += 1
        self._counters["evictions"] += 1
        self._counters["spilled_bytes"] += int(h.index_bytes)
        self.evict_windows.append((t0, time.perf_counter()))
        m = self.recorder.metrics
        m.inc("gateway.evictions")
        m.inc(f"gateway.model.{sanitize_segment(h.model_id)}.evictions")

    def _readmit(self, h: ModelHandle) -> None:
        """Reload an evicted model from its spill onto its model's device:
        the slabs restore byte for byte (``load_index``), so the
        readmitted engine answers bitwise as before the eviction."""
        from ..checkpoint import load_index

        if not h.spill_path or not os.path.exists(h.spill_path):
            raise GatewayError(
                f"model {h.model_id!r} was evicted but its spill "
                f"{h.spill_path!r} is gone; register() it again first"
            )
        t0 = time.perf_counter()
        self._ensure_budget(keep=h.model_id)
        h.index = load_index(h.spill_path, handle=h.model_id,
                             device=getattr(h.model, "device", None))
        # The upload and B5's tables inside the window, waited for: the
        # window holds the readmission's whole cost, and a B5 launched
        # after it from any thread's stream reads finished tables.
        h.index.device_tensors()
        if h.index._ready is not None:
            h.index._ready.synchronize()
        # Build-time kwargs (leaves/block/qblock) shaped the persisted
        # index; only the engine's own kwargs apply to the reload.
        eng_kw = {
            k: v for k, v in h.engine_kw.items()
            if k not in ("leaves", "block", "qblock")
        }
        h.engine = QueryEngine(h.index, model=h.model, **eng_kw)
        # The staleness guard compares against the generation that was
        # REGISTERED, not whatever the model drifted to while evicted (a
        # refit during eviction is stale too).
        h.engine._model_generation = h.fit_generation
        h.resident = True
        h.reloads += 1
        self._counters["reloads"] += 1
        self._counters["reloaded_bytes"] += int(h.index_bytes)
        self.evict_windows.append((t0, time.perf_counter()))
        m = self.recorder.metrics
        m.inc("gateway.reloads")
        m.inc(f"gateway.model.{sanitize_segment(h.model_id)}.reloads")
        self._ensure_budget(keep=h.model_id)

    # -- admission --------------------------------------------------------

    def set_quota(self, tenant: str, qps: float,
                  burst: Optional[float] = None) -> None:
        """Install a per-tenant admission quota (replaces the default for
        this tenant; ``qps <= 0`` turns the quota off)."""
        with self.lock:
            self._quotas[str(tenant)] = _TokenBucket(
                qps, burst if burst is not None else self.tenant_burst
            )

    def _tenant_state(self, tenant: str) -> Dict:
        st = self._tenant.get(tenant)
        if st is None:
            sid = sanitize_segment(tenant)
            st = self._tenant[tenant] = {
                "sid": sid, "admitted": 0, "shed": 0, "failed": 0,
                "hist": self.recorder.metrics.hist(
                    f"gateway.tenant.{sid}.latency_ms"
                ),
            }
        return st

    def _admit(self, tenant: str) -> None:
        # The JAX package's gateway.admit fault site fires here, upstream
        # of the quota bucket and every engine; it comes with the port of
        # utils/faults (ROADMAP A16).
        st = self._tenant_state(tenant)
        bucket = self._quotas.get(tenant)
        if bucket is None:
            bucket = self._quotas[tenant] = _TokenBucket(
                self.tenant_qps, self.tenant_burst
            )
        if not bucket.try_take():
            st["shed"] += 1
            self._counters["admission_sheds"] += 1
            m = self.recorder.metrics
            m.inc("gateway.admission_sheds")
            m.inc(f"gateway.tenant.{st['sid']}.shed_total")
            raise TenantQuotaExceeded(
                f"tenant {tenant!r} is not admitted: over its "
                f"{bucket.rate:g} qps quota (burst {bucket.burst:g}); "
                f"back off or set_quota() first"
            )
        st["admitted"] += 1
        self._counters["admitted"] += 1

    # -- request surface --------------------------------------------------

    def submit(self, model_id: str, X, *, tenant: str = "default",
               timeout_s: Optional[float] = None):
        """Admit, route and enqueue one request; returns the engine's
        ticket (resolved by the next :meth:`drain`).  Sheds with
        :class:`TenantQuotaExceeded` / :class:`~.engine.QueueFull`;
        ``timeout_s`` sets the ticket's deadline."""
        with self.lock:
            self._admit(tenant)
            h = self._resolve(str(model_id))
            t = h.engine.submit(X, timeout_s=timeout_s)
            self._pending.append((t, tenant))
            return t

    def predict(self, model_id: str, X, *, tenant: str = "default",
                timeout_s: Optional[float] = None,
                return_distance: bool = False):
        """Sync assignment through the gateway (admission, routing and
        drain in one call)."""
        with self.lock:
            self._admit(tenant)
            h = self._resolve(str(model_id))
            t = h.engine.submit(X, timeout_s=timeout_s)
            self._pending.append((t, tenant))
            h.engine.drain()
            self._sweep()
            return t.result(return_distance)

    def drain(self, model_id: Optional[str] = None) -> int:
        """Drain every resident engine (or one model's) and fold resolved
        tickets into the per-tenant histograms; returns the query rows
        processed."""
        with self.lock:
            n = 0
            if model_id is not None:
                n += self._resolve(str(model_id)).engine.drain()
            else:
                for h in list(self._handles.values()):
                    if h.resident:
                        n += h.engine.drain()
            self._sweep()
            self._publish()
            return n

    def _sweep(self) -> None:
        for _ in range(len(self._pending)):
            t, tenant = self._pending.popleft()
            if not t.done:
                self._pending.append((t, tenant))
                continue
            st = self._tenant_state(tenant)
            if t.failed:
                st["failed"] += 1
            elif t.latency_ms is not None:
                st["hist"].observe(t.latency_ms)

    # -- hot swap ---------------------------------------------------------

    def refresh(self, model_id: str, model=None) -> None:
        """Hot-swap a refreshed clustering into a handle with no ticket
        dropped.

        Builds a fresh index from ``model`` (default: the registered
        model, after its refit) in the OLD generation's frame, on its
        device, drains in-flight tickets against the old slabs, then
        installs the fresh generation through
        :meth:`~.index.CorePointIndex.replace_generation`: every ticket
        submitted before the swap resolves against the old generation,
        every one after it against the new.  The build runs under the
        lock, so every tenant waits behind it."""
        from .index import CorePointIndex, _model_core_set

        mid = str(model_id)
        with self.lock:
            h = self._handles.get(mid)
            if h is None:
                raise ModelNotRegistered(
                    f"this gateway has no model {mid!r}; "
                    f"call register() first"
                )
            if h.live is not None:
                raise GatewayError(
                    f"model {mid!r} is a live handle; its Compactor "
                    f"owns generation swaps — refresh() is for "
                    f"read-only residents"
                )
            if model is None:
                model = h.model
            model._require_fitted()
            if not h.resident:
                # Adopt the new generation directly: the spill is the
                # OLD clustering, superseded by the refreshed model.
                h.model = model
                h.fit_generation = getattr(model, "_fit_generation", 0)
                self._readmit_fresh(h, model)
                self._publish()
                return
            cores, labels = _model_core_set(model)
            eps = float(getattr(model, "kernel_eps", model.eps))
            old = h.index
            t0 = time.perf_counter()
            fresh = CorePointIndex.build(
                cores, labels, eps, block=old.block, qblock=old.qblock,
                center=old.center, device=old.device, handle=mid,
            )
            metric_norm = getattr(model, "_metric_norm", None)
            fresh.unit_norm = metric_norm == "cosine"
            fresh.projection = {
                "cosine": "unit", "haversine": "latlon"
            }.get(metric_norm, "none")
            # No ticket dropped: those in flight resolve against the OLD
            # generation before the slabs move.
            h.engine.drain()
            self._sweep()
            old.replace_generation(fresh)
            h.model = model
            h.fit_generation = getattr(model, "_fit_generation", 0)
            h.engine._model_ref = weakref.ref(model)
            h.engine._model_generation = h.fit_generation
            h.index_bytes = int(old.stats.get("index_bytes", 0))
            h.swaps += 1
            self._counters["epoch_swaps"] += 1
            self.swap_windows.append((t0, time.perf_counter()))
            self.recorder.metrics.inc("gateway.epoch_swaps")
            self._ensure_budget(keep=mid)
            self._publish()

    def _readmit_fresh(self, h: ModelHandle, model) -> None:
        """Refresh of an evicted handle: build from the new model (a
        swap: the generation moved while spilled)."""
        t0 = time.perf_counter()
        self._ensure_budget(keep=h.model_id)
        h.engine = QueryEngine.from_model(
            model, handle=h.model_id, **h.engine_kw
        )
        h.index = h.engine.index
        h.resident = True
        h.index_bytes = int(h.index.stats.get("index_bytes", 0))
        h.swaps += 1
        self._counters["epoch_swaps"] += 1
        self.swap_windows.append((t0, time.perf_counter()))
        self.recorder.metrics.inc("gateway.epoch_swaps")
        if h.spill_path and os.path.exists(h.spill_path):
            os.unlink(h.spill_path)  # the spill is the OLD clustering
        h.spill_path = None
        self._ensure_budget(keep=h.model_id)

    # -- telemetry --------------------------------------------------------

    def _publish(self) -> None:
        m = self.recorder.metrics
        n_res = sum(1 for h in self._handles.values() if h.resident)
        m.set("gateway.models_registered", len(self._handles))
        m.set("gateway.resident_models", n_res)
        m.set("gateway.resident_bytes", self.resident_bytes())
        m.set("gateway.budget_bytes", int(self.budget_bytes))
        for h in self._handles.values():
            sid = sanitize_segment(h.model_id)
            m.set(f"gateway.model.{sid}.resident", int(h.resident))
            m.set(f"gateway.model.{sid}.index_bytes",
                  int(h.index_bytes))
            m.set(
                f"gateway.model.{sid}.queries",
                int(h.queries_done)
                + int(h.engine.queries if h.resident else 0),
            )

    def gateway_report(self) -> Dict:
        """The fleet's telemetry block (``pypardis_tpu/
        gateway_report@1``, the JAX package's keys): registry and budget
        state, eviction, reload and swap counters, and per-tenant
        admission and windowed-latency stats."""
        with self.lock:
            self._publish()
            models = {}
            for mid, h in self._handles.items():
                models[mid] = {
                    "resident": bool(h.resident),
                    "pinned": bool(h.pinned),
                    "live": h.live is not None,
                    "index_bytes": int(h.index_bytes),
                    "queries": int(h.queries_done) + int(
                        h.engine.queries if h.resident else 0
                    ),
                    "evictions": int(h.evictions),
                    "reloads": int(h.reloads),
                    "epoch_swaps": int(h.swaps),
                    "index_epoch": int(
                        getattr(h.index, "epoch", 0) if h.resident
                        else 0
                    ),
                    "index_generation": int(
                        getattr(h.index, "generation", 0)
                        if h.resident else 0
                    ),
                }
            tenants = {}
            for tenant, st in self._tenant.items():
                hist = st["hist"]
                tenants[tenant] = {
                    "admitted": int(st["admitted"]),
                    "shed": int(st["shed"]),
                    "failed": int(st["failed"]),
                    "p50_ms": hist.percentile(50),
                    "p99_ms": hist.percentile(99),
                    "latency_hist": hist.snapshot(),
                }
            c = self._counters
            return {
                "schema": GATEWAY_REPORT_SCHEMA,
                "models_registered": len(self._handles),
                "resident_models": sum(
                    1 for h in self._handles.values() if h.resident
                ),
                "budget_bytes": int(self.budget_bytes),
                "resident_bytes": int(self.resident_bytes()),
                "eviction_policy": self.eviction,
                "evictions": int(c["evictions"]),
                "reloads": int(c["reloads"]),
                "spilled_bytes": int(c["spilled_bytes"]),
                "reloaded_bytes": int(c["reloaded_bytes"]),
                "epoch_swaps": int(c["epoch_swaps"]),
                "admitted": int(c["admitted"]),
                "admission_sheds": int(c["admission_sheds"]),
                "eviction_windows": len(self.evict_windows),
                "swap_windows": len(self.swap_windows),
                "in_flight": len(self._pending),
                "models": models,
                "tenants": tenants,
            }
