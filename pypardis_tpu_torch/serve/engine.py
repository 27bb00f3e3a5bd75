"""Micro-batching query engine over a :class:`CorePointIndex`
(counterpart of ``pypardis_tpu/serve/engine.py``).

``predict(X)`` is the sync path; ``submit(X)`` / ``drain()`` is the
serving path: a bounded queue coalesces requests into padded device
batches, and the drain double-buffers — B5 runs asynchronously on the
card for batch *i* while the host routes and assembles batch *i+1*.
Each dispatch queues its packed result's copy into pinned host memory
and records an event behind it; finalizing batch *i* waits on that
event only, never on the stream, so B5 of batch *i+1* (queued before
batch *i* is folded) keeps running while the host folds.
``device_wait_s`` sums the host's waits on those events: near zero
when B5 is hidden behind the host stages.

``serving_stats()`` reports QPS over engine-busy wall time, batch fill
(real routed rows over padded device rows), p50/p99 request latency
from the engine's ``serving.latency_ms``
:class:`~pypardis_tpu_torch.obs.export.Histogram` (bounded buckets,
windowed percentiles; its snapshot rides as ``latency_hist``), and the
index's epoch and generation; each drain also publishes them as
``serving.*`` gauges on the engine's :attr:`QueryEngine.recorder`.
A live update (:mod:`.live`) edits the index in place between drains: a
ticket submitted before it and drained after it answers against the
updated index (its queries were centred in the index's frame, which no
update moves), and a batch already dispatched reads the old slab, since
the update's device writes queue behind it on the stream.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from ..obs import RunRecorder
from ..obs.registry import sanitize_segment
from ..ops.precision import norm_precision_mode
from ..ops.query import INT_INF, unpack_query_result
from .index import CorePointIndex, build_index


class QueueFull(RuntimeError):
    """``submit`` backpressure: the bounded queue is at ``max_pending``
    rows (counted in ``serving_stats()["shed_total"]``)."""


class DeadlineExceeded(RuntimeError):
    """A ticket's ``timeout_s`` elapsed before its result was usable;
    the ticket is failed, not delivered late."""


class QueryTicket:
    """One submitted request, resolved (or failed) by the next
    ``drain()``."""

    __slots__ = (
        "n", "labels", "d2", "_t_submit", "latency_ms", "_q",
        "deadline", "error",
    )

    def __init__(self, n: int, q: np.ndarray,
                 timeout_s: Optional[float] = None):
        self.n = int(n)
        self.labels: Optional[np.ndarray] = None
        self.d2: Optional[np.ndarray] = None
        self.latency_ms: Optional[float] = None
        self._t_submit = time.perf_counter()
        self._q = q
        self.deadline = (
            self._t_submit + float(timeout_s)
            if timeout_s is not None else None
        )
        self.error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self.labels is not None or self.error is not None

    @property
    def failed(self) -> bool:
        return self.error is not None

    def result(self, return_distance: bool = False):
        if self.error is not None:
            raise self.error
        if self.labels is None:
            raise RuntimeError(
                "ticket not resolved yet; call QueryEngine.drain() first"
            )
        if return_distance:
            return self.labels, np.sqrt(self.d2)
        return self.labels


class _Inflight:
    __slots__ = ("packed", "ready", "rowmap", "tickets", "n_rows", "fill")

    def __init__(self, packed, rowmap, tickets, n_rows, fill, ready=None):
        # ``packed`` is on the host; on a card index it is a pinned buffer
        # whose copy completes at the CUDA event ``ready``.
        self.packed = packed
        self.ready = ready
        self.rowmap = rowmap
        self.tickets = tickets
        self.n_rows = n_rows
        self.fill = fill


def fold_leaves(n_rows: int, rowmap, labs, d2):
    """Fold the raw per-tile results of one batch (``unpack_query_result``)
    into per-query ``(best d2, best label)``: a query routed to several
    leaves keeps the lexicographic minimum over them."""
    best_d2 = np.full(n_rows, np.inf, np.float32)
    best_lab = np.full(n_rows, INT_INF, np.int32)
    for t, arr in enumerate(rowmap):
        lt, dt = labs[t, :len(arr)], d2[t, :len(arr)]
        cur_d, cur_l = best_d2[arr], best_lab[arr]
        take = (dt < cur_d) | ((dt == cur_d) & (lt < cur_l))
        best_d2[arr] = np.where(take, dt, cur_d)
        best_lab[arr] = np.where(take, lt, cur_l)
    return best_d2, best_lab


def check_query_precision(precision) -> str:
    """The query pass is exact in every mode; ``"mixed"`` adds B5's bf16
    chunk prefilter, which changes no answer after the within-eps
    verdict."""
    return norm_precision_mode(precision)


class QueryEngine:
    """Batched out-of-sample cluster assignment.

    ``backend``: B5 runs on a card index and its plain version on a CPU
    index; ``"auto"`` accepts either, ``"cuda"``/``"torch"`` must match
    the index's device.  ``batch_capacity`` bounds the rows coalesced into
    one batch; ``max_pending`` bounds the queue (``submit`` raises
    :class:`QueueFull` when full).  ``handle`` names the model served
    (default: the index's handle).
    """

    def __init__(
        self,
        index: CorePointIndex,
        *,
        backend: str = "auto",
        batch_capacity: int = 4096,
        max_pending: int = 1 << 16,
        precision: str = "high",
        model=None,
        handle: Optional[str] = None,
    ):
        from ..ops.labels import resolve_backend

        self.index = index
        self.handle = (
            str(handle) if handle is not None
            else getattr(index, "handle", None)
        )
        resolve_backend(backend, index.device)
        # Staleness guard: an engine built from a model records the
        # model's fit generation, and raises once the model is refit.
        self._model_ref = weakref.ref(model) if model is not None else None
        self._model_generation = getattr(model, "_fit_generation", 0)
        self.backend = str(backend).lower()
        self.precision = check_query_precision(precision)
        self.batch_capacity = int(batch_capacity)
        self.max_pending = int(max_pending)
        self.recorder = RunRecorder(device=index.device)
        self._pending: deque = deque()
        self._pending_rows = 0
        # Request latencies on a bounded log-bucket histogram: O(buckets)
        # memory under sustained traffic, p50/p99 over a sliding window
        # (PPTORCH_HIST_WINDOW_S).
        self._lat_hist = self.recorder.metrics.hist("serving.latency_ms")
        self.queries = 0
        self.batches = 0
        self._busy_s = 0.0
        self._fill_num = 0
        self._fill_den = 0
        self._shed = 0
        self._deadline_failures = 0
        self.device_wait_s = 0.0

    @classmethod
    def from_model(cls, model, *, leaves=None, block: int = 256,
                   qblock: int = 128, backend: Optional[str] = None,
                   handle: Optional[str] = None, **kw) -> "QueryEngine":
        index = build_index(model, leaves=leaves, block=block, qblock=qblock,
                            handle=handle)
        if backend is None:
            backend = getattr(model, "kernel_backend", "auto")
        # A model fitted with "mixed" serves "mixed" (the same bf16 bulk
        # pass with an exact rescore); an explicit precision wins.
        if "precision" not in kw and norm_precision_mode(
                getattr(model, "precision", "high")) == "mixed":
            kw["precision"] = "mixed"
        return cls(index, backend=backend, model=model, handle=handle, **kw)

    # -- request surface --------------------------------------------------

    def _check_stale(self) -> None:
        if self._model_ref is None:
            return
        model = self._model_ref()
        if model is not None and getattr(
            model, "_fit_generation", 0
        ) != self._model_generation:
            raise RuntimeError(
                "model was refit after this engine was built; this "
                "engine indexes the PREVIOUS clustering — call "
                "model.query_engine() to get the rebuilt engine"
            )

    def submit(self, X, timeout_s: Optional[float] = None) -> QueryTicket:
        """Enqueue a request (validated now; results after the next
        :meth:`drain`).  ``timeout_s`` sets the ticket's deadline, queue
        wait included; a full queue raises :class:`QueueFull`."""
        self._check_stale()
        q = self.index.prepare_queries(X)
        if self._pending_rows + len(q) > self.max_pending:
            self._shed += 1
            raise QueueFull(
                f"query queue full ({self._pending_rows} rows pending, "
                f"max_pending={self.max_pending}); drain() first or "
                f"shed load upstream"
            )
        t = QueryTicket(len(q), q, timeout_s=timeout_s)
        self._pending.append(t)
        self._pending_rows += len(q)
        return t

    def predict(self, X, return_distance: bool = False):
        """Sync out-of-sample assignment: (N,) int32 labels (noise -1),
        plus float32 distances to the assigning core point (+inf for
        noise) when ``return_distance``."""
        t = self.submit(X)
        self.drain()
        return t.result(return_distance)

    def drain(self) -> int:
        """Process every pending request; returns the query count.
        Tickets coalesce into ``batch_capacity``-row batches; batch
        *i+1* is dispatched before batch *i* is finalized."""
        if not self._pending:
            return 0
        t0 = time.perf_counter()
        batches = []
        cur, rows = [], 0
        while self._pending:
            t = self._pending.popleft()
            if t.deadline is not None and time.perf_counter() > t.deadline:
                self._fail_deadline(t)
                continue
            if cur and rows + t.n > self.batch_capacity:
                batches.append(cur)
                cur, rows = [], 0
            cur.append(t)
            rows += t.n
        if cur:
            batches.append(cur)
        self._pending_rows = 0
        inflight = None
        n_done = 0
        for group in batches:
            nxt = self._dispatch(group)
            if inflight is not None:
                n_done += self._finalize(inflight)
            inflight = nxt
        if inflight is not None:
            n_done += self._finalize(inflight)
        self._busy_s += time.perf_counter() - t0
        self.queries += n_done
        self.batches += len(batches)
        self._publish()
        return n_done

    # -- internals --------------------------------------------------------

    def _dispatch(self, tickets) -> _Inflight:
        qf32 = (
            tickets[0]._q if len(tickets) == 1
            else np.concatenate([t._q for t in tickets])
        )
        n_rows = len(qf32)
        if self.index.n_core == 0 or n_rows == 0:
            return _Inflight(None, [], tickets, n_rows, 1.0)
        qbuf, tile_leaf, rowmap = self.index.assemble(qf32)
        packed = self.index.dispatch(qbuf, tile_leaf,
                                     precision=self.precision)
        ready = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            packed = host
        fill = sum(len(a) for a in rowmap) / max(
            qbuf.shape[0] * qbuf.shape[2], 1
        )
        return _Inflight(packed, rowmap, tickets, n_rows, fill, ready)

    def _finalize(self, fl: _Inflight) -> int:
        # The batch's own copy is its sync point (a batch with no
        # dispatch has no tiles and folds to all-noise).
        if fl.ready is not None:
            t = time.perf_counter()
            fl.ready.synchronize()
            self.device_wait_s += time.perf_counter() - t
        labs, d2 = (None, None) if fl.packed is None else (
            unpack_query_result(fl.packed)
        )
        best_d2, best_lab = fold_leaves(fl.n_rows, fl.rowmap, labs, d2)
        within = best_d2 <= np.float32(self.index.eps2)
        labels = np.where(within, best_lab, -1).astype(np.int32)
        d2 = np.where(within, best_d2, np.float32(np.inf))
        now = time.perf_counter()
        s = 0
        for t in fl.tickets:
            if t.deadline is not None and now > t.deadline:
                # A result past the ticket's deadline is a miss.
                self._fail_deadline(t)
                s += t.n
                continue
            t.labels = labels[s:s + t.n]
            t.d2 = d2[s:s + t.n]
            t.latency_ms = (now - t._t_submit) * 1e3
            t._q = None
            self.recorder.metrics.observe_ms(
                "serving.latency_ms", t.latency_ms)
            s += t.n
        self._fill_num += int(round(fl.fill * fl.n_rows))
        self._fill_den += fl.n_rows
        return fl.n_rows

    def _fail_deadline(self, t: QueryTicket) -> None:
        waited_ms = (time.perf_counter() - t._t_submit) * 1e3
        t.error = DeadlineExceeded(
            f"query ticket missed its deadline: waited "
            f"{waited_ms:.1f}ms against a "
            f"{(t.deadline - t._t_submit) * 1e3:.1f}ms timeout "
            f"(queue wait included); the ticket is failed, resubmit if "
            f"still wanted"
        )
        t._q = None
        self._deadline_failures += 1

    # -- telemetry --------------------------------------------------------

    def _publish(self) -> None:
        """The numeric serving stats as ``serving.*`` gauges, once per
        drain as the JAX engine does (they stream to an attached flight
        file or exporter); the histogram's snapshot is left out."""
        m = self.recorder.metrics
        for k, v in self._scalar_stats().items():
            if isinstance(v, (int, float, bool)):
                m.set(f"serving.{sanitize_segment(k)}", v)

    def serving_stats(self) -> Dict:
        """Serving gauges, finite by construction (the ``serving``
        block of ``DBSCAN.report()``), and the latency histogram's
        snapshot (``pypardis_tpu/hist@1``: windowed percentiles and
        lifetime bucket counts) as ``latency_hist``."""
        return {**self._scalar_stats(),
                "latency_hist": self._lat_hist.snapshot()}

    def _scalar_stats(self) -> Dict:
        p50 = self._lat_hist.percentile(50)
        p99 = self._lat_hist.percentile(99)
        st = self.index.stats
        return {
            "model": self.handle or "default",
            "queries": int(self.queries),
            "batches": int(self.batches),
            "qps": round(self.queries / self._busy_s, 1)
            if self._busy_s > 0 else 0.0,
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
            "batch_fill": round(
                self._fill_num / self._fill_den, 4
            ) if self._fill_den else 0.0,
            "n_core": int(self.index.n_core),
            "n_leaves": int(st.get("n_leaves", 0)),
            "index_bytes": int(st.get("index_bytes", 0)),
            "index_device_bytes": int(self.index.index_device_bytes),
            "backend": self.backend,
            "precision": self.precision,
            "shed_total": int(self._shed),
            "deadline_failures": int(self._deadline_failures),
            "index_epoch": int(self.index.epoch),
            "index_generation": int(self.index.generation),
        }
