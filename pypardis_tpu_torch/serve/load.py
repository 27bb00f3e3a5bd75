"""Sustained multi-client load harnesses for the serving plane
(counterpart of ``pypardis_tpu/serve/load.py``).

:func:`sustained_load` drives N concurrent client threads against one
:class:`~pypardis_tpu_torch.serve.QueryEngine` under **Poisson
arrivals** (exponential inter-arrival sleeps per client: open-loop
traffic), with an optional write mix through a
:class:`~pypardis_tpu_torch.serve.live.LiveModel`.  A pump thread drains
continuously, so a request's latency includes its queue wait and
coalescing.  The engine's submit/drain surface is single-threaded by
design; the harness serializes it through one lock, so contention shows
in p99, not as corruption.

Measured per run: qps over the harness wall, p50/p99 request latency,
batch fill, and for writes the **update-visible latency**: from a write
entering the live model until a ``predict`` of the written point
answers through the updated index.  With ``writers > 0`` a Poisson
writer population coalesces its batched writes through an
:class:`~pypardis_tpu_torch.serve.ingest.IngestQueue`, and an optional
background :class:`~pypardis_tpu_torch.serve.ingest.Compactor` swaps a
generation in mid-run under the harness lock; the stats then carry
write throughput and coalescing, the zero-dropped-tickets contract and
read p99 inside against outside the compaction windows.

:func:`gateway_load` drives tenants x clients through a
:class:`~pypardis_tpu_torch.serve.gateway.ModelGateway`: Zipf-chosen
models over a per-tenant rotation, live writes on live handles, a
mid-run hot swap, and read p99 inside against outside the eviction and
swap windows.

Both return the JAX package's stats keys.  Their wrappers own the live
export plane: with ``PPTORCH_METRICS_PORT`` / ``PPTORCH_METRICS_SNAPSHOT``
set, the engine's (or the gateway's) registry, the serving latency
histogram included, is scraped or snapshotted for the run.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np

from ..obs.export import Histogram, attach_exporters


def sustained_load(engine, **kw) -> Dict:
    """Run the harness; returns the stats dict (see
    :func:`_sustained_load` for every knob), with the engine's recorder
    exported for the run when the ``PPTORCH_METRICS_*`` knobs ask."""
    exporters = attach_exporters(getattr(engine, "recorder", None))
    try:
        return _sustained_load(engine, **kw)
    finally:
        if exporters is not None:
            exporters.close()


def _sustained_load(
    engine,
    *,
    clients: int = 4,
    duration_s: float = 2.0,
    rate_hz: float = 200.0,
    batch_rows: int = 16,
    write_fraction: float = 0.0,
    live=None,
    query_sampler: Optional[Callable] = None,
    seed: int = 0,
    submit_timeout_s: Optional[float] = None,
    writers: int = 0,
    write_rate_hz: float = 60.0,
    write_batch_rows: int = 8,
    delete_fraction: float = 0.2,
    write_sampler: Optional[Callable] = None,
    ingest=None,
    compactor=None,
    compact_at_s: Optional[float] = None,
) -> Dict:
    """Run the harness; returns the schema'd stats dict.

    ``rate_hz`` is the per-client request rate (Poisson); ``clients``
    threads run open-loop for ``duration_s``.  ``write_fraction`` of
    requests become single-point inserts against ``live`` (required
    when > 0); the rest submit ``batch_rows``-row query batches.
    ``query_sampler(rng, n) -> (n, k)`` supplies query coordinates
    (default: uniform over the index's core bounding box ± eps).

    **Writer population (the streaming-ingest mixed-traffic mode)**:
    ``writers`` dedicated Poisson write clients run alongside the
    readers, each submitting ``write_batch_rows``-row writes (a
    ``delete_fraction`` share deletes its own previously-acknowledged
    inserts) into an :class:`~.ingest.IngestQueue`
    (one is built over ``live`` when not passed) — the pump thread
    flushes it next to every drain, so writes coalesce into batches
    exactly the way reads do.  **Update-visible latency** is measured
    per write ticket: submit → coalesced flush → a ``predict`` of the
    written point answering through the refreshed index.  When a
    ``compactor`` is given, its lock serializes the harness (writers,
    drains, and the epoch swap all agree on one lock); the pump starts
    a background cycle at ``compact_at_s`` seconds (and whenever the
    watermark policy fires), and read latencies are classified against
    the compactor's cycle windows — ``read_p99_during_compaction_ms``
    against ``read_p99_outside_ms`` is the compaction-overlap
    degradation.  The zero-dropped-tickets contract is explicit: ``dropped_tickets`` counts read tickets left unresolved
    after the final drain (always 0 — the swap drains in-flight
    tickets against the old generation rather than dropping them).

    Fault mode: ``submit_timeout_s`` attaches a per-ticket deadline, a
    full queue is counted as a shed (the client backs off — never
    aborts the harness), and deadline-failed tickets are counted
    rather than crashed on — so the harness runs clean under a stalled
    drain and reports how the serving tier degraded (``shed`` /
    ``deadline_failures`` in the stats).
    """
    if write_fraction > 0 and live is None:
        raise ValueError(
            "write_fraction > 0 needs a LiveModel (live=...)"
        )
    if writers > 0 and live is None and ingest is None:
        raise ValueError(
            "writers > 0 needs a LiveModel (live=...) or an "
            "IngestQueue (ingest=...)"
        )
    if writers > 0 and ingest is None:
        from .ingest import IngestQueue

        ingest = IngestQueue(live)
    from .engine import QueueFull
    index = engine.index
    if query_sampler is None:
        sel = np.asarray(index.labels) != np.iinfo(np.int32).max
        if sel.any():
            lo = index.coords[:, sel].min(axis=1) - index.eps
            hi = index.coords[:, sel].max(axis=1) + index.eps
            center = index.center
        else:
            lo = np.full(index.d, -1.0)
            hi = np.full(index.d, 1.0)
            center = np.zeros(index.d)

        def query_sampler(rng, n):
            # Raw-frame queries (prepare_queries re-centers).
            return rng.uniform(lo, hi, size=(n, index.d)) + center

    # One lock serializes the engine, the ingest queue, AND the epoch
    # swap: when a compactor rides along, its lock IS the harness lock,
    # so the swap's drain-then-replace is atomic against every client.
    lock = compactor.lock if compactor is not None else threading.Lock()
    # Resolved tickets fold into bounded histograms at each pump sweep
    # and are discarded — the harness holds O(in-flight) tickets, never
    # O(requests), and the reported percentiles are windowed.
    pending: deque = deque()
    hist_all = Histogram()
    hist_in = Histogram()   # reads completing inside a compaction cycle
    hist_out = Histogram()
    hist_vis = Histogram()  # update-visible round trips
    n_tickets = [0]
    n_queries = [0]
    n_failed = [0]
    errors: list = []
    stop = threading.Event()
    t_start = time.perf_counter()
    deadline = t_start + float(duration_s)
    n_writes = [0]
    n_shed = [0]
    # Start of the compaction cycle currently in flight (None outside
    # one): completed cycles land in compactor.windows, but a read
    # finishing DURING the cycle must classify as inside before the
    # window closes.
    cycle_t0: list = [None]

    def _inside_compaction(done_at: float) -> bool:
        windows = getattr(compactor, "windows", ()) or ()
        if any(a <= done_at <= b for a, b in windows):
            return True
        t0 = cycle_t0[0]
        return t0 is not None and done_at >= t0

    def _sweep_resolved() -> None:
        """Fold resolved read tickets into the histograms and drop
        them (caller holds the lock)."""
        for _ in range(len(pending)):
            t = pending.popleft()
            if not t.done:
                pending.append(t)
                continue
            if t.failed:
                n_failed[0] += 1
            else:
                n_queries[0] += t.n
            if t.latency_ms is not None:
                hist_all.observe(t.latency_ms)
                done_at = t._t_submit + t.latency_ms / 1e3
                (hist_in if _inside_compaction(done_at)
                 else hist_out).observe(t.latency_ms)

    def client(cid: int) -> None:
        rng = np.random.default_rng(seed * 1000 + cid)
        while time.perf_counter() < deadline and not stop.is_set():
            # Poisson arrivals: exponential inter-arrival gap.
            time.sleep(float(rng.exponential(1.0 / rate_hz)))
            if time.perf_counter() >= deadline:
                break
            try:
                if live is not None and rng.random() < write_fraction:
                    q = np.asarray(query_sampler(rng, 1))
                    t0 = time.perf_counter()
                    with lock:
                        ids = live.insert(q)
                        labs = engine.predict(q)
                    hist_vis.observe(
                        (time.perf_counter() - t0) * 1e3
                    )
                    del ids, labs
                    n_writes[0] += 1
                else:
                    q = np.asarray(query_sampler(rng, batch_rows))
                    with lock:
                        pending.append(
                            engine.submit(
                                q, timeout_s=submit_timeout_s
                            )
                        )
                        n_tickets[0] += 1
            except QueueFull:
                # Shed load: the bounded queue refused this request —
                # the open-loop client drops it and keeps its arrival
                # process going (the production behavior the counter
                # measures), never aborts the harness.
                n_shed[0] += 1
            except Exception as e:  # noqa: BLE001 — harness must drain
                errors.append(e)
                stop.set()
                return

    if write_sampler is None:
        write_sampler = query_sampler

    def writer(wid: int) -> None:
        """A dedicated Poisson write client: batches into the ingest
        queue, deletes a share of its own acknowledged inserts."""
        rng = np.random.default_rng(seed * 1000 + 500 + wid)
        mine: list = []  # resolved insert tickets not yet consumed
        own_ids: list = []
        while time.perf_counter() < deadline and not stop.is_set():
            time.sleep(float(rng.exponential(1.0 / write_rate_hz)))
            if time.perf_counter() >= deadline:
                break
            # Harvest acknowledged ids from earlier tickets.
            still = []
            for t in mine:
                if t.done:
                    if not t.failed and t.ids is not None:
                        own_ids.extend(int(i) for i in t.ids)
                else:
                    still.append(t)
            mine = still
            try:
                if own_ids and rng.random() < delete_fraction:
                    take = min(len(own_ids), int(write_batch_rows))
                    ids = [own_ids.pop() for _ in range(take)]
                    with lock:
                        ingest.submit_delete(ids)
                else:
                    q = np.asarray(
                        write_sampler(rng, int(write_batch_rows))
                    )
                    with lock:
                        t = ingest.submit_insert(q)
                    mine.append(t)
                n_writes[0] += 1
            except QueueFull:
                n_shed[0] += 1
            except Exception as e:  # noqa: BLE001 — harness must drain
                errors.append(e)
                stop.set()
                return

    compact_started = [False]

    def pump_once() -> None:
        """One serialized pump round: drain reads, flush writes,
        measure update visibility, and fire the compactor."""
        with lock:
            engine.drain()
            if ingest is not None:
                resolved = ingest.flush()
                now = time.perf_counter()
                probed = False
                for t in resolved:
                    if t.failed or t.kind != "insert":
                        continue
                    if not probed and t.ids is not None and len(t.ids) \
                            and live is not None:
                        # One predict per flush: the written point
                        # answers through the refreshed index — the
                        # update-visible round trip.
                        engine.predict(
                            live._coords[t.ids[:1]].copy()
                        )
                        probed = True
                    t.visible_ms = (now - t._t_submit) * 1e3
                    hist_vis.observe(t.visible_ms)
            _sweep_resolved()
        if compactor is not None:
            elapsed = time.perf_counter() - t_start
            due = (
                compact_at_s is not None and elapsed >= compact_at_s
                and not compact_started[0]
            )
            if due and not compactor.running:
                compactor.start()
                compact_started[0] = True
            elif compactor.maybe_compact():
                compact_started[0] = True
            if compactor.running:
                if cycle_t0[0] is None:
                    cycle_t0[0] = time.perf_counter()
            else:
                cycle_t0[0] = None

    def drainer() -> None:
        while not stop.is_set():
            try:
                pump_once()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                stop.set()
                return
            time.sleep(0.0005)
            if time.perf_counter() >= deadline:
                return  # stragglers resolve in the final drain below

    threads = [
        threading.Thread(target=client, args=(c,), daemon=True)
        for c in range(int(clients))
    ] + [
        threading.Thread(target=writer, args=(w,), daemon=True)
        for w in range(int(writers))
    ]
    pump = threading.Thread(target=drainer, daemon=True)
    for t in threads:
        t.start()
    pump.start()
    for t in threads:
        t.join()
    stop.set()
    pump.join()
    if compactor is not None and compactor._thread is not None:
        compactor.join()  # the swap lands; its error (if any) raises
    cycle_t0[0] = None  # completed cycles are in compactor.windows now
    with lock:
        engine.drain()  # resolve any straggler tickets
        if ingest is not None:
            ingest.flush()
        _sweep_resolved()
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]

    # Tickets still unresolved after the final drain (the zero-dropped
    # contract) — everything resolved was folded into the histograms
    # and discarded at sweep time.
    dropped = len(pending)
    # Compaction-overlap classification happened at sweep time (a read
    # completing inside a live cycle classifies before the window
    # closes); p99s here are lifetime — each side's window may have
    # expired by end of run.
    p99_in = hist_in.percentile(99, window=False) \
        if hist_in.count else 0.0
    p99_out = hist_out.percentile(99, window=False) \
        if hist_out.count else 0.0

    stats = engine.serving_stats()
    return {
        "arrival": "poisson",
        "clients": int(clients),
        "duration_s": round(wall, 3),
        "rate_hz": float(rate_hz),
        "requests": int(n_tickets[0]) + int(n_writes[0]),
        "queries": int(n_queries[0]),
        "writes": int(n_writes[0]),
        "write_fraction": float(write_fraction),
        "qps": round(n_queries[0] / wall, 1) if wall > 0 else 0.0,
        # Windowed percentiles (PPTORCH_HIST_WINDOW_S): how serving is
        # doing NOW, not averaged over the whole run.
        "p50_ms": hist_all.percentile(50),
        "p99_ms": hist_all.percentile(99),
        "latency_hist": hist_all.snapshot(),
        "batch_fill": stats.get("batch_fill", 0.0),
        "update_visible_p50_ms": hist_vis.percentile(50),
        "update_visible_p99_ms": hist_vis.percentile(99),
        "visible_hist": hist_vis.snapshot(),
        "index_epoch": stats.get("index_epoch", 0),
        # Fault-mode telemetry: queue-full refusals seen by the open-
        # loop clients, and tickets that missed their deadline (both 0
        # on a clean run with no timeout).
        "shed": int(n_shed[0]),
        "deadline_failures": int(n_failed[0]),
        "submit_timeout_s": (
            float(submit_timeout_s) if submit_timeout_s else 0.0
        ),
        # Streaming-ingest block (writers + background compaction):
        # write volumes/coalescing, zero-dropped-tickets contract, and
        # the compaction-overlap degradation (read p99 with a cycle in
        # flight vs without — 0.0 when no cycle overlapped the run).
        "writers": int(writers),
        "write_rows": int(getattr(ingest, "rows", 0)),
        "write_batches": int(getattr(ingest, "batches", 0)),
        "mean_write_batch": (
            ingest.stats()["mean_batch_rows"] if ingest is not None
            else 0.0
        ),
        "write_qps": (
            round(getattr(ingest, "rows", 0) / wall, 1)
            if wall > 0 else 0.0
        ),
        "write_failures": int(
            getattr(ingest, "failed_batches", 0)
        ),
        "dropped_tickets": dropped,
        "compactions": int(
            getattr(compactor, "stats", {}).get("compactions", 0)
            if compactor is not None else 0
        ),
        "epoch_swaps": int(
            live.stats.get("epoch_swaps", 0) if live is not None else 0
        ),
        "compaction_s": (
            round(float(compactor.stats.get("compaction_s", 0.0)), 3)
            if compactor is not None else 0.0
        ),
        "read_p99_during_compaction_ms": p99_in,
        "read_p99_outside_ms": p99_out,
        "compaction_overlap_degradation": (
            round(p99_in / p99_out, 3)
            if p99_in > 0 and p99_out > 0 else 0.0
        ),
    }


def gateway_load(gateway, model_ids, **kw) -> Dict:
    """Multi-tenant fleet traffic against a :class:`~pypardis_tpu_torch.
    serve.gateway.ModelGateway` (see :func:`_gateway_load` for every
    knob), with the gateway's recorder exported for the run when the
    ``PPTORCH_METRICS_*`` knobs ask."""
    exporters = attach_exporters(getattr(gateway, "recorder", None))
    try:
        return _gateway_load(gateway, model_ids, **kw)
    finally:
        if exporters is not None:
            exporters.close()


def _gateway_load(
    gateway,
    model_ids,
    *,
    tenants: int = 4,
    clients_per_tenant: int = 1,
    duration_s: float = 2.0,
    rate_hz: float = 120.0,
    batch_rows: int = 8,
    zipf_s: float = 1.2,
    write_fraction: float = 0.0,
    seed: int = 0,
    submit_timeout_s: Optional[float] = None,
    refresh_at_s: Optional[float] = None,
    refresher: Optional[Callable] = None,
    query_sampler: Optional[Callable] = None,
) -> Dict:
    """Drive ``tenants`` x ``clients_per_tenant`` open-loop Poisson
    clients through the gateway's admission gate.

    Each client's per-request model choice is **Zipf-distributed**
    (p(rank) proportional to ``(rank+1)**-zipf_s``) over a per-tenant
    *rotation* of ``model_ids`` — every tenant has a different hot
    model, so under a residency budget the fleet's long tail churns
    through eviction/readmission while each tenant's head stays warm
    (the access pattern LRU is built for).  ``write_fraction`` of a
    tenant's requests become single-point live inserts when the chosen
    model is a live handle (measured as update-visible round trips);
    non-live choices fall back to reads.

    Sheds are first-class: :class:`~.gateway.TenantQuotaExceeded`
    (per-tenant quota) and :class:`~.engine.QueueFull` are counted per
    tenant, and
    the client backs off — the harness never aborts on admission
    control doing its job.  ``refresher()`` (e.g. a closure around
    ``gateway.refresh``) fires once from the pump thread at
    ``refresh_at_s`` seconds — the hot swap lands mid-traffic, and the
    zero-dropped-tickets contract is checked the same way the ingest
    harness checks the Compactor's.

    Read latencies are classified against the gateway's eviction and
    swap windows (``read_p99_in_window_ms`` vs
    ``read_p99_outside_ms``) — residency churn and epoch swaps are
    synchronous under the gateway lock, so completed windows are
    authoritative by sweep time.
    """
    from .engine import QueueFull
    from .gateway import TenantQuotaExceeded

    model_ids = [str(m) for m in model_ids]
    if not model_ids:
        raise ValueError("gateway_load needs at least one model id")
    tenant_names = [f"t{i:02d}" for i in range(int(tenants))]
    lock = gateway.lock
    # Zipf pmf over model ranks, shared by every client; each tenant
    # rotates the model order so rank 0 (the hot model) differs.
    ranks = np.arange(len(model_ids), dtype=np.float64)
    pmf = (ranks + 1.0) ** -float(zipf_s)
    pmf /= pmf.sum()

    bounds: Dict[str, tuple] = {}

    def _default_sampler(rng, n, mid):
        # Lazily captured per-model sampling box (resolving the handle
        # under the lock readmits an evicted model — the serving path).
        box = bounds.get(mid)
        if box is None:
            with lock:
                idx = gateway.handle(mid).index
                sel = (np.asarray(idx.labels)
                       != np.iinfo(np.int32).max)
                if sel.any():
                    lo = idx.coords[:, sel].min(axis=1) - idx.eps
                    hi = idx.coords[:, sel].max(axis=1) + idx.eps
                    center = idx.center
                else:
                    lo = np.full(idx.d, -1.0)
                    hi = np.full(idx.d, 1.0)
                    center = np.zeros(idx.d)
                box = bounds[mid] = (lo, hi, center, int(idx.d))
        lo, hi, center, d = box
        return rng.uniform(lo, hi, size=(n, d)) + center

    if query_sampler is None:
        query_sampler = _default_sampler

    pending: deque = deque()  # (ticket, t_submit) for window classing
    hist_all = Histogram()
    hist_in = Histogram()   # reads completing inside evict/swap windows
    hist_out = Histogram()
    hist_vis = Histogram()
    n_tickets = [0]
    n_queries = [0]
    n_failed = [0]
    n_writes = [0]
    shed_by_tenant = {t: 0 for t in tenant_names}
    errors: list = []
    stop = threading.Event()
    t_start = time.perf_counter()
    deadline = t_start + float(duration_s)

    def _windows():
        return list(gateway.evict_windows) + list(gateway.swap_windows)

    def _sweep_resolved() -> None:
        windows = _windows()
        for _ in range(len(pending)):
            t, t_sub = pending.popleft()
            if not t.done:
                pending.append((t, t_sub))
                continue
            if t.failed:
                n_failed[0] += 1
            else:
                n_queries[0] += t.n
            if t.latency_ms is not None:
                hist_all.observe(t.latency_ms)
                done_at = t_sub + t.latency_ms / 1e3
                (hist_in if any(a <= done_at <= b
                                for a, b in windows)
                 else hist_out).observe(t.latency_ms)

    def client(tenant: str, tidx: int, cid: int) -> None:
        rng = np.random.default_rng(
            seed * 10000 + tidx * 100 + cid
        )
        order = list(np.roll(model_ids, tidx))
        while time.perf_counter() < deadline and not stop.is_set():
            time.sleep(float(rng.exponential(1.0 / rate_hz)))
            if time.perf_counter() >= deadline:
                break
            mid = order[int(rng.choice(len(order), p=pmf))]
            try:
                q = np.asarray(query_sampler(rng, batch_rows, mid))
                if write_fraction > 0 and rng.random() < write_fraction:
                    with lock:
                        h = gateway.handle(mid)
                        if h.live is not None:
                            t0 = time.perf_counter()
                            h.live.insert(q[:1])
                            gateway.predict(
                                mid, q[:1], tenant=tenant,
                                timeout_s=submit_timeout_s,
                            )
                            hist_vis.observe(
                                (time.perf_counter() - t0) * 1e3
                            )
                            n_writes[0] += 1
                            continue
                with lock:
                    t = gateway.submit(
                        mid, q, tenant=tenant,
                        timeout_s=submit_timeout_s,
                    )
                    pending.append((t, t._t_submit))
                    n_tickets[0] += 1
            except (TenantQuotaExceeded, QueueFull):
                # Admission control working as designed: the open-loop
                # client drops the request and keeps arriving.
                shed_by_tenant[tenant] += 1
            except Exception as e:  # noqa: BLE001 — harness must drain
                errors.append(e)
                stop.set()
                return

    refreshed = [False]

    def pump() -> None:
        while not stop.is_set():
            try:
                with lock:
                    gateway.drain()
                    _sweep_resolved()
                if (
                    refresher is not None and not refreshed[0]
                    and refresh_at_s is not None
                    and time.perf_counter() - t_start >= refresh_at_s
                ):
                    refreshed[0] = True
                    refresher()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                stop.set()
                return
            time.sleep(0.0005)
            if time.perf_counter() >= deadline:
                return  # stragglers resolve in the final drain below

    threads = [
        threading.Thread(
            target=client, args=(tenant, tidx, cid), daemon=True
        )
        for tidx, tenant in enumerate(tenant_names)
        for cid in range(int(clients_per_tenant))
    ]
    pump_t = threading.Thread(target=pump, daemon=True)
    for t in threads:
        t.start()
    pump_t.start()
    for t in threads:
        t.join()
    stop.set()
    pump_t.join()
    if refresher is not None and not refreshed[0]:
        refreshed[0] = True
        refresher()  # a short run must still exercise the swap
    with lock:
        gateway.drain()
        _sweep_resolved()
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]

    dropped = len(pending)
    p99_in = hist_in.percentile(99, window=False) \
        if hist_in.count else 0.0
    p99_out = hist_out.percentile(99, window=False) \
        if hist_out.count else 0.0
    report = gateway.gateway_report()
    return {
        "arrival": "poisson-zipf",
        "zipf_s": float(zipf_s),
        "tenants": int(tenants),
        "clients_per_tenant": int(clients_per_tenant),
        "models": len(model_ids),
        "duration_s": round(wall, 3),
        "rate_hz": float(rate_hz),
        "requests": int(n_tickets[0]) + int(n_writes[0]),
        "queries": int(n_queries[0]),
        "writes": int(n_writes[0]),
        "write_fraction": float(write_fraction),
        "qps": round(n_queries[0] / wall, 1) if wall > 0 else 0.0,
        "p50_ms": hist_all.percentile(50),
        "p99_ms": hist_all.percentile(99),
        "latency_hist": hist_all.snapshot(),
        "update_visible_p50_ms": hist_vis.percentile(50),
        "update_visible_p99_ms": hist_vis.percentile(99),
        "shed": int(sum(shed_by_tenant.values())),
        "shed_by_tenant": {
            t: int(n) for t, n in shed_by_tenant.items()
        },
        "deadline_failures": int(n_failed[0]),
        "submit_timeout_s": (
            float(submit_timeout_s) if submit_timeout_s else 0.0
        ),
        # The zero-dropped-tickets contract across eviction,
        # readmission, AND the mid-run epoch swap.
        "dropped_tickets": dropped,
        # Residency-churn / swap overlap: read p99 completing inside an
        # eviction-or-swap window vs fully outside one.
        "read_p99_in_window_ms": p99_in,
        "read_p99_outside_ms": p99_out,
        "window_degradation": (
            round(p99_in / p99_out, 3)
            if p99_in > 0 and p99_out > 0 else 0.0
        ),
        "gateway": report,
    }
