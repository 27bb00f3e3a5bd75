"""Bounded latency histograms (counterpart of the ``Histogram`` in
``pypardis_tpu/obs/export.py``).

:class:`Histogram` is the latency metric type the
:class:`~pypardis_tpu_torch.obs.registry.MetricsRegistry` hosts and the
gateway and the load harness observe into.  Buckets are log-spaced
milliseconds (8 per decade, 1 µs .. 100 s, one overflow slot), so the
structure is O(buckets) however many requests land, and percentiles are
windowed: a ring of chunk vectors covers the last ``window_s`` seconds
(``PPTORCH_HIST_WINDOW_S``, default 60), so ``p99`` says how serving
does now, not over the whole run.  The bucket edges, the percentile
rule and the snapshot format (``pypardis_tpu/hist@1``) are the JAX
package's, so one reader takes both packages' snapshots.

The JAX module's export plane (the OpenMetrics scrape endpoint, the
JSONL snapshotter, ``attach_exporters``) is not ported yet (ROADMAP
A16).
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

HIST_SCHEMA = "pypardis_tpu/hist@1"

# Log-spaced millisecond buckets: 8 per decade across 1e-3 ms (1 µs) ..
# 1e5 ms (100 s), plus one overflow slot: 65 integer cells.
_LOG10_LO = -3.0
_PER_DECADE = 8
_DECADES = 8
_NBUCKETS = _PER_DECADE * _DECADES
_EDGES_MS: Tuple[float, ...] = tuple(
    round(10.0 ** (_LOG10_LO + (i + 1) / _PER_DECADE), 9)
    for i in range(_NBUCKETS)
)
_WINDOW_CHUNKS = 8
_WINDOW_DEFAULT_S = 60.0


def _pct_from_counts(counts: List[int], q: float, max_ms: float) -> float:
    """Percentile estimate over one bucket-count vector: find the bucket
    holding the rank, log-interpolate inside it."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = total * (float(q) / 100.0)
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        cum += c
        if cum >= rank:
            if i >= _NBUCKETS:  # overflow bucket: clamp to the max seen
                return round(max(max_ms, _EDGES_MS[-1]), 3)
            hi = _EDGES_MS[i]
            lo = (
                _EDGES_MS[i - 1] if i > 0
                else _EDGES_MS[0] / (10.0 ** (1.0 / _PER_DECADE))
            )
            frac = (rank - (cum - c)) / c
            return round(lo * (hi / lo) ** frac, 3)
    return round(max_ms, 3)


def _default_window_s() -> float:
    try:
        return float(os.environ.get("PPTORCH_HIST_WINDOW_S",
                                    _WINDOW_DEFAULT_S))
    except ValueError:
        return _WINDOW_DEFAULT_S


class Histogram:
    """Bounded log-bucket latency histogram with windowed percentiles.

    Lifetime counts live in one fixed vector; the sliding window is a
    ring of ``_WINDOW_CHUNKS`` chunk vectors of ``window_s / chunks``
    seconds each, zeroed as the ring advances.  ``percentile()`` answers
    over the live window and falls back to the lifetime counts when the
    window is empty (an idle server still reports its history).
    """

    __slots__ = (
        "window_s", "_chunk_s", "_life", "_chunks", "_chunk_ids",
        "count", "sum_ms", "max_ms", "_lock",
    )

    def __init__(self, window_s: Optional[float] = None):
        if window_s is None:
            window_s = _default_window_s()
        self.window_s = max(float(window_s), 0.5)
        self._chunk_s = self.window_s / _WINDOW_CHUNKS
        self._life = [0] * (_NBUCKETS + 1)
        self._chunks = [
            [0] * (_NBUCKETS + 1) for _ in range(_WINDOW_CHUNKS)
        ]
        self._chunk_ids = [-1] * _WINDOW_CHUNKS
        self.count = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
        self._lock = threading.Lock()

    # -- write ------------------------------------------------------------

    def observe(self, value_ms, now_s: Optional[float] = None) -> None:
        ms = float(value_ms)
        if ms != ms:  # NaN never lands in a bucket
            return
        b = bisect.bisect_left(_EDGES_MS, ms)
        cid = int(
            (time.monotonic() if now_s is None else now_s) / self._chunk_s
        )
        slot = cid % _WINDOW_CHUNKS
        with self._lock:
            self._life[b] += 1
            self.count += 1
            self.sum_ms += ms
            if ms > self.max_ms:
                self.max_ms = ms
            if self._chunk_ids[slot] != cid:
                self._chunks[slot] = [0] * (_NBUCKETS + 1)
                self._chunk_ids[slot] = cid
            self._chunks[slot][b] += 1

    def merge_from(self, other: "Histogram") -> "Histogram":
        """Pool ``other``'s lifetime counts into this histogram (window
        state is per process and not pooled)."""
        with other._lock:
            olife = list(other._life)
            oc, osum, omax = other.count, other.sum_ms, other.max_ms
        with self._lock:
            for i, c in enumerate(olife):
                self._life[i] += c
            self.count += oc
            self.sum_ms += osum
            if omax > self.max_ms:
                self.max_ms = omax
        return self

    def clone(self) -> "Histogram":
        return Histogram(window_s=self.window_s).merge_from(self)

    # -- read -------------------------------------------------------------

    def _window_counts(self, now_s: Optional[float] = None) -> List[int]:
        """Summed counts of the chunks still inside the window (caller
        holds the lock)."""
        cid = int(
            (time.monotonic() if now_s is None else now_s) / self._chunk_s
        )
        out = [0] * (_NBUCKETS + 1)
        for slot in range(_WINDOW_CHUNKS):
            if cid - _WINDOW_CHUNKS < self._chunk_ids[slot] <= cid:
                for i, c in enumerate(self._chunks[slot]):
                    if c:
                        out[i] += c
        return out

    @property
    def window_count(self) -> int:
        with self._lock:
            return sum(self._window_counts())

    def percentile(self, q: float, window: bool = True) -> float:
        with self._lock:
            counts = self._window_counts() if window else list(self._life)
            if window and not any(counts):
                counts = list(self._life)
            max_ms = self.max_ms
        return _pct_from_counts(counts, q, max_ms)

    @property
    def nbytes(self) -> int:
        """Fixed structural footprint, cells x 8: constant by
        construction."""
        return 8 * (len(self._life) + sum(len(c) for c in self._chunks))

    def snapshot(self) -> Dict:
        """One json-serializable dump (``pypardis_tpu/hist@1``): windowed
        p50/p99 and the nonzero lifetime buckets."""
        with self._lock:
            life = list(self._life)
            wcounts = self._window_counts()
            count, sum_ms, max_ms = self.count, self.sum_ms, self.max_ms
        wtotal = sum(wcounts)
        pct_counts = wcounts if wtotal else life
        return {
            "schema": HIST_SCHEMA,
            "unit": "ms",
            "count": int(count),
            "sum_ms": round(sum_ms, 3),
            "max_ms": round(max_ms, 3),
            "window_s": self.window_s,
            "window_count": int(wtotal),
            "p50_ms": _pct_from_counts(pct_counts, 50, max_ms),
            "p99_ms": _pct_from_counts(pct_counts, 99, max_ms),
            "buckets": [
                [_EDGES_MS[i], int(c)]
                for i, c in enumerate(life[:_NBUCKETS]) if c
            ],
            "overflow": int(life[_NBUCKETS]),
        }

    @classmethod
    def from_snapshot(cls, snap: Dict,
                      window_s: Optional[float] = None) -> "Histogram":
        """Rebuild the lifetime state from a :meth:`snapshot` dict of
        either package (window state is not persisted)."""
        h = cls(window_s=window_s or snap.get("window_s"))
        for le, c in snap.get("buckets") or ():
            i = bisect.bisect_left(_EDGES_MS, float(le) * (1 - 1e-9))
            h._life[min(i, _NBUCKETS)] += int(c)
        h._life[_NBUCKETS] += int(snap.get("overflow", 0) or 0)
        h.count = int(snap.get("count", sum(h._life)))
        h.sum_ms = float(snap.get("sum_ms", 0.0))
        h.max_ms = float(snap.get("max_ms", 0.0))
        return h
