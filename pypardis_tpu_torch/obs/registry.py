"""Metrics registry: counters, gauges, timing aggregates and latency
histograms under one dotted key schema (counterpart of
``pypardis_tpu/obs/registry.py``, whole).

Every number a serving plane publishes is reachable under one dotted
key namespace (``gateway.model.<id>.evictions``, ``gateway.tenant.<id>.
latency_ms``, ...) and mergeable across runs.
"""

from __future__ import annotations

import re
from typing import Dict, Union

from .export import Histogram

_KEY_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")

Number = Union[int, float]


def _py(value):
    """Coerce numpy scalars and 0-d tensors (anything with ``.item()``)
    to plain Python numbers, so every dump is json-serializable."""
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    item = getattr(value, "item", None)
    if callable(item):
        return item()
    return value


def sanitize_segment(s) -> str:
    """Coerce an arbitrary string (a model id, a tenant name) into one
    valid key segment."""
    out = re.sub(r"[^a-z0-9_]", "_", str(s).lower())
    return out or "x"


def validate_key(key: str) -> str:
    if not isinstance(key, str) or not _KEY_RE.match(key):
        raise ValueError(
            f"metric key {key!r} violates the schema: lowercase dotted "
            f"segments of [a-z0-9_]"
        )
    return key


class MetricsRegistry:
    """Counters (monotonic adds), gauges (last write wins), timing
    aggregates (count / total / min / max seconds) and bounded latency
    histograms.

    >>> reg = MetricsRegistry()
    >>> reg.inc("gateway.evictions")
    >>> reg.set("gateway.resident_models", 3)
    >>> reg.as_dict()["gauges"]["gateway.resident_models"]
    3

    ``merge`` combines two registries: counters add, gauges take the
    other's value (it is newer), timings and histograms pool.
    """

    def __init__(self):
        self._counters: Dict[str, Number] = {}
        self._gauges: Dict[str, object] = {}
        self._timings: Dict[str, Dict[str, float]] = {}
        self._hists: Dict[str, Histogram] = {}
        # An optional streaming sink (obs.flight.FlightRecorder, or the
        # exporters' Fanout): every write is forwarded to it when set.
        self.sink = None

    # -- write surface ----------------------------------------------------

    def inc(self, key: str, value: Number = 1) -> None:
        validate_key(key)
        self._counters[key] = self._counters.get(key, 0) + _py(value)
        if self.sink is not None:
            self.sink.count(key, value)

    def set(self, key: str, value) -> None:
        validate_key(key)
        self._gauges[key] = _py(value)
        if self.sink is not None:
            self.sink.gauge(key, value)

    def observe(self, key: str, seconds: float) -> None:
        validate_key(key)
        s = float(_py(seconds))
        if self.sink is not None:
            self.sink.timing(key, s)
        t = self._timings.get(key)
        if t is None:
            self._timings[key] = {
                "count": 1, "total_s": s, "min_s": s, "max_s": s,
            }
        else:
            t["count"] += 1
            t["total_s"] += s
            t["min_s"] = min(t["min_s"], s)
            t["max_s"] = max(t["max_s"], s)
        # Timings double as histograms (ms).
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        h.observe(s * 1e3)

    def hist(self, key: str, window_s: float = None) -> Histogram:
        """Get or create the bounded histogram under ``key`` (unit: ms)."""
        h = self._hists.get(key)
        if h is None:
            validate_key(key)
            h = self._hists[key] = Histogram(window_s=window_s)
        return h

    def observe_ms(self, key: str, value_ms: float) -> None:
        """Record one latency sample (milliseconds) into the histogram
        under ``key`` and forward it to the sink's ``hist`` channel."""
        self.hist(key).observe(value_ms)
        if self.sink is not None:
            hs = getattr(self.sink, "hist", None)
            if hs is not None:
                hs(key, float(value_ms))

    def load_hist(self, key: str, snap: dict) -> None:
        """Install a histogram rebuilt from a snapshot dict, pooling into
        any existing one."""
        validate_key(key)
        h = Histogram.from_snapshot(snap)
        mine = self._hists.get(key)
        if mine is None:
            self._hists[key] = h
        else:
            mine.merge_from(h)

    # -- read surface -----------------------------------------------------

    def counter(self, key: str, default: Number = 0) -> Number:
        return self._counters.get(key, default)

    def gauge(self, key: str, default=None):
        return self._gauges.get(key, default)

    def counters_with_prefix(self, prefix: str) -> Dict[str, Number]:
        return {
            k: v for k, v in self._counters.items() if k.startswith(prefix)
        }

    def gauges_with_prefix(self, prefix: str) -> Dict[str, object]:
        return {
            k: v for k, v in self._gauges.items() if k.startswith(prefix)
        }

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into this registry (see the class docstring)."""
        for k, v in other._counters.items():
            self._counters[k] = self._counters.get(k, 0) + v
        self._gauges.update(other._gauges)
        for k, t in other._timings.items():
            mine = self._timings.get(k)
            if mine is None:
                self._timings[k] = dict(t)
            else:
                mine["count"] += t["count"]
                mine["total_s"] += t["total_s"]
                mine["min_s"] = min(mine["min_s"], t["min_s"])
                mine["max_s"] = max(mine["max_s"], t["max_s"])
        for k, h in other._hists.items():
            mine_h = self._hists.get(k)
            if mine_h is None:
                self._hists[k] = h.clone()
            else:
                mine_h.merge_from(h)
        return self

    def as_dict(self) -> Dict[str, dict]:
        """One json-serializable dump: ``{"counters", "gauges",
        "timings", "hists"}``; timings carry count/total/min/max/mean
        seconds, hists are :meth:`Histogram.snapshot` dicts."""
        timings = {}
        for k, t in self._timings.items():
            d = dict(t)
            d["mean_s"] = d["total_s"] / max(d["count"], 1)
            timings[k] = d
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "timings": timings,
            "hists": {k: h.snapshot() for k, h in self._hists.items()},
        }
