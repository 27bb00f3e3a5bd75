"""Streaming ingest: batched writes and background compaction
(counterpart of ``pypardis_tpu/serve/ingest.py``).

* :class:`IngestQueue` coalesces single writes into batches, as the
  query engine coalesces reads: ``submit_insert``/``submit_delete``
  return a :class:`WriteTicket` at once; ``flush()`` groups consecutive
  writes of one kind (order is kept: an insert/delete interleaving is
  ordered) into ``max_batch_rows``-row batches and applies each through
  :meth:`LiveModel.insert_batch` / :meth:`LiveModel.delete_batch`, so B
  single-point writes cost one re-cluster dispatch and one index delta.
* :class:`Compactor` is the LSM maintenance: write deltas pile up in
  the index's appended slabs; when the watermark policy fires (appended
  slab bytes or deltas since the last swap past the ``PPTORCH_COMPACT_*``
  knobs), a full refit of the current points (a port ``DBSCAN`` fit on
  the model's device: B1 and B2 on the card) is built into a fresh
  index generation in the old generation's frame and swapped into the
  live index in place (:meth:`CorePointIndex.replace_generation`).  The
  swap drains the engine first, so readers submitted before it resolve
  against the old generation and readers after it against the new one;
  writes that landed during the refit are replayed at the swap.

Not yet ported: the compaction's checkpoint-resume (``ckpt=``) and the
fault-injection sites (ROADMAP A16), and refits on the sharded routes
(``fit_kw`` with ``mode``/``mesh``; A10-A12).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .engine import QueueFull

# Write latencies the queue's p50/p99 are taken over.
LATENCY_WINDOW = 4096
# Compact once the appended slabs hold this many bytes, or once this
# many write deltas landed since the last swap, whichever comes first.
DEFAULT_COMPACT_SLAB_BYTES = 64 << 20
DEFAULT_COMPACT_DELTAS = 512


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return int(default)


class WriteTicket:
    """One submitted write, resolved (ids assigned or error set) by the
    next :meth:`IngestQueue.flush`.  ``visible_ms`` is set by a caller
    that measures when the write became visible to readers (the load
    harness: submit to the flush that applied it, a ``predict`` through
    the updated index included)."""

    __slots__ = (
        "kind", "rows", "ids", "error", "latency_ms", "visible_ms",
        "_t_submit", "_payload",
    )

    def __init__(self, kind: str, payload):
        self.kind = kind  # "insert" | "delete"
        self._payload = payload
        self.rows = int(len(payload))
        self.ids: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.latency_ms: Optional[float] = None
        self.visible_ms: Optional[float] = None
        self._t_submit = time.perf_counter()

    @property
    def done(self) -> bool:
        return self.ids is not None or self.error is not None

    @property
    def failed(self) -> bool:
        return self.error is not None

    def result(self) -> np.ndarray:
        if self.error is not None:
            raise self.error
        if self.ids is None:
            raise RuntimeError(
                "write ticket not resolved yet; call IngestQueue.flush()"
            )
        return self.ids


class IngestQueue:
    """Bounded write coalescer over a :class:`LiveModel`.

    ``submit_*`` validates and enqueues (:class:`QueueFull` past
    ``max_pending_rows``, never a silent drop); ``flush()`` applies the
    queue in order, one batched update per group.  A batch that fails
    fails only its own tickets (the error rides them) and the flush goes
    on.  Write latencies (submit to flush) go in a bounded window.
    """

    def __init__(self, live, *, max_batch_rows: int = 1024,
                 max_pending_rows: int = 1 << 16):
        self.live = live
        self.max_batch_rows = int(max_batch_rows)
        self.max_pending_rows = int(max_pending_rows)
        self._pending: deque = deque()
        self._pending_rows = 0
        self.batches = 0
        self.rows = 0
        self.shed = 0
        self.failed_batches = 0
        self._batch_rows: deque = deque(maxlen=256)
        self._latencies: deque = deque(maxlen=LATENCY_WINDOW)

    def _enqueue(self, t: WriteTicket) -> WriteTicket:
        if self._pending_rows + t.rows > self.max_pending_rows:
            self.shed += 1
            raise QueueFull(
                f"ingest queue full ({self._pending_rows} rows pending, "
                f"max_pending_rows={self.max_pending_rows}); flush() "
                f"first or shed load upstream"
            )
        self._pending.append(t)
        self._pending_rows += t.rows
        return t

    def submit_insert(self, X) -> WriteTicket:
        """Enqueue an insert (validated now, applied at the next flush)."""
        return self._enqueue(WriteTicket("insert", self.live._check_points(X)))

    def submit_delete(self, ids) -> WriteTicket:
        """Enqueue a delete by stable ids (checked at the flush, against
        the state the writes before it leave)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        return self._enqueue(WriteTicket("delete", ids))

    def _groups(self) -> List[Tuple[str, List[WriteTicket]]]:
        groups: List[Tuple[str, List[WriteTicket]]] = []
        cur_kind, cur, cur_rows = None, [], 0
        while self._pending:
            t = self._pending.popleft()
            if (t.kind != cur_kind
                    or (cur and cur_rows + t.rows > self.max_batch_rows)):
                if cur:
                    groups.append((cur_kind, cur))
                cur_kind, cur, cur_rows = t.kind, [], 0
            cur.append(t)
            cur_rows += t.rows
        if cur:
            groups.append((cur_kind, cur))
        return groups

    def flush(self) -> List[WriteTicket]:
        """Apply every pending write, coalesced; returns the tickets this
        flush resolved (failed ones included)."""
        resolved: List[WriteTicket] = []
        for kind, tickets in self._groups():
            payload = (
                tickets[0]._payload if len(tickets) == 1
                else np.concatenate([t._payload for t in tickets])
            )
            try:
                if kind == "insert":
                    ids = self.live.insert_batch(payload)
                    s = 0
                    for t in tickets:
                        t.ids = ids[s:s + t.rows]
                        s += t.rows
                else:
                    self.live.delete_batch(payload)
                    for t in tickets:
                        t.ids = t._payload
                self.batches += 1
                self.rows += len(payload)
                self._batch_rows.append(len(payload))
            except Exception as e:  # noqa: BLE001 — fails its batch only
                self.failed_batches += 1
                for t in tickets:
                    t.error = e
            now = time.perf_counter()
            for t in tickets:
                t.latency_ms = (now - t._t_submit) * 1e3
                self._latencies.append(t.latency_ms)
                t._payload = None
                self._pending_rows -= t.rows
                resolved.append(t)
        return resolved

    def stats(self) -> Dict:
        br = list(self._batch_rows)
        lat = np.asarray(self._latencies, np.float64)
        p50, p99 = (
            (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)))
            if len(lat) else (0.0, 0.0)
        )
        return {
            "batches": int(self.batches),
            "rows": int(self.rows),
            "pending_rows": int(self._pending_rows),
            "shed": int(self.shed),
            "failed_batches": int(self.failed_batches),
            "mean_batch_rows": round(sum(br) / len(br), 2) if br else 0.0,
            "write_p50_ms": round(p50, 3),
            "write_p99_ms": round(p99, 3),
        }


class Compactor:
    """Full-refit compaction with a generation swap, in the foreground
    (:meth:`compact`) or on a background thread (:meth:`start` /
    :meth:`join`).

    One cycle: snapshot the live points under ``lock`` -> refit them
    (a port ``DBSCAN`` with the live model's eps, min_samples, block,
    precision, backend and device; ``fit_kw`` overrides) -> build a
    fresh index over the refit's cores in the old generation's frame ->
    under ``lock``, drain the engine, install the refit's clustering and
    the fresh generation in place, and replay the writes that landed
    during the refit.  The live index serves throughout; only the
    snapshot and the swap hold the lock.  ``phase_hook(name)`` runs at
    each phase boundary (``PHASES``).

    A refit on the card runs on the calling thread's current stream; the
    swap makes the serving stream wait for the new generation's upload
    (:meth:`CorePointIndex.replace_generation`).
    """

    PHASES = ("snapshot", "refit", "build", "swap")

    def __init__(
        self, live, *, ckpt: Optional[str] = None, lock=None,
        slab_bytes: Optional[int] = None,
        max_deltas: Optional[int] = None,
        fit_kw: Optional[Dict] = None,
        phase_hook: Optional[Callable[[str], None]] = None,
    ):
        if ckpt is not None:
            raise NotImplementedError(
                "checkpoint-resumable compaction (ckpt=) needs the "
                "jobstate machinery, not yet ported (ROADMAP A16)"
            )
        fit_kw = dict(fit_kw or {})
        sharded = sorted({"mode", "mesh"} & set(fit_kw))
        if sharded:
            raise NotImplementedError(
                f"compaction refits on the sharded routes (fit_kw "
                f"{sharded}) are not yet ported (ROADMAP A10-A12)"
            )
        self.live = live
        self.lock = lock if lock is not None else threading.Lock()
        self.slab_bytes = (
            int(slab_bytes) if slab_bytes is not None
            else _env_int("PPTORCH_COMPACT_SLAB_BYTES",
                          DEFAULT_COMPACT_SLAB_BYTES)
        )
        self.max_deltas = (
            int(max_deltas) if max_deltas is not None
            else _env_int("PPTORCH_COMPACT_DELTAS", DEFAULT_COMPACT_DELTAS)
        )
        self.fit_kw = fit_kw
        self._phase_hook = phase_hook
        self.stats: Dict = {
            "compactions": 0, "compaction_s": 0.0,
            "replayed_inserts": 0, "replayed_deletes": 0,
        }
        # Seconds each phase of the last cycle took, and every completed
        # cycle's (t0, t1) on the perf_counter clock: the load harness
        # sorts read latencies into inside and outside these windows.
        self.phase_s: Dict[str, float] = {}
        self.windows: List[Tuple[float, float]] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._active = False

    # -- the trigger policy -----------------------------------------------

    def should_compact(self) -> bool:
        """The watermark policy: appended slab bytes or deltas since the
        last swap crossed their thresholds."""
        idx = self.live.index
        return (
            idx.appended_slab_bytes >= self.slab_bytes
            or idx.deltas_since_compact >= self.max_deltas
        )

    def maybe_compact(self) -> bool:
        """Start a background cycle when the policy says so (not while
        one runs); returns whether one was started."""
        if self.running or not self.should_compact():
            return False
        self.start()
        return True

    # -- the cycle --------------------------------------------------------

    def _phase(self, name: str) -> None:
        if self._phase_hook is not None:
            self._phase_hook(name)

    def compact(self) -> Dict:
        """Run one compaction cycle now; returns the stats."""
        if self._active:
            raise RuntimeError("a compaction cycle is already running")
        self._active = True
        live = self.live
        t0 = time.perf_counter()
        marks = [t0]
        try:
            self._phase("snapshot")
            with self.lock:
                snap = live.begin_compaction_snapshot()
            marks.append(time.perf_counter())
            try:
                self._phase("refit")
                labels, core = self._refit(snap)
                marks.append(time.perf_counter())
                self._phase("build")
                fresh = self._build_generation(snap, labels, core)
                marks.append(time.perf_counter())
                self._phase("swap")
                with self.lock:
                    replayed = live._install_generation(
                        snap, labels, core, fresh
                    )
                marks.append(time.perf_counter())
            finally:
                live._compact_active = False
            dt = marks[-1] - t0
            self.windows.append((t0, marks[-1]))
            self.phase_s = {
                name: marks[i + 1] - marks[i]
                for i, name in enumerate(self.PHASES)
            }
            self.stats["compactions"] += 1
            self.stats["compaction_s"] = round(
                self.stats["compaction_s"] + dt, 6
            )
            self.stats["replayed_inserts"] += int(replayed[0])
            self.stats["replayed_deletes"] += int(replayed[1])
            # Under the lock: the note republishes the live stats, which
            # read the point arrays a writer holding the lock extends.
            with self.lock:
                live._note_compaction(dt)
            return dict(self.stats)
        finally:
            self._active = False

    def _refit(self, snap):
        """Full refit of the snapshot's points from host input (the
        fit the JAX package's compaction runs, byte for byte)."""
        from ..dbscan import DBSCAN

        m = self.live.model
        kw = {
            "eps": self.live.eps,
            "min_samples": self.live.min_samples,
            "block": int(m.block),
            "precision": m.precision,
            "kernel_backend": m.kernel_backend,
            "device": m.device,
        }
        kw.update(self.fit_kw)
        model = DBSCAN(**kw)
        model.train(snap["points"])
        return (
            np.asarray(model.labels_, np.int32),
            np.asarray(model.core_sample_mask_, bool),
        )

    def _build_generation(self, snap, labels, core):
        """The fresh generation: the refit's cores re-partitioned and
        Morton-sorted into a build layout (no appended slabs) in the old
        generation's frame, tagged with the snapshot's ids."""
        from .index import CorePointIndex

        idx = self.live.index
        fresh = CorePointIndex.build(
            snap["points"][core], labels[core], self.live.eps,
            block=idx.block, qblock=idx.qblock, center=idx.center,
            device=idx.device,
        )
        fresh.attach_gids(snap["ids"][core])
        return fresh

    # -- background execution ---------------------------------------------

    @property
    def running(self) -> bool:
        return self._active or (
            self._thread is not None and self._thread.is_alive()
        )

    def start(self) -> threading.Thread:
        """Run one cycle on a background thread (the live index keeps
        serving; only the snapshot and the swap take the lock)."""
        if self.running:
            raise RuntimeError("a compaction cycle is already running")
        self._error = None

        def run():
            try:
                self.compact()
            except BaseException as e:  # noqa: BLE001 — join re-raises
                self._error = e

        self._thread = threading.Thread(
            target=run, name="pypardis-torch-compactor", daemon=True
        )
        self._thread.start()
        return self._thread

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the background cycle; re-raises its error."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            err, self._error = self._error, None
            raise err
