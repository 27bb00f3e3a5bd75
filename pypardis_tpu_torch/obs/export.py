"""Live metrics export: bounded histograms and the scrape and snapshot
exporters (counterpart of ``pypardis_tpu/obs/export.py``).

:class:`Histogram` is the latency metric type the
:class:`~pypardis_tpu_torch.obs.registry.MetricsRegistry` hosts and the
engine, the gateway and the load harness observe into.  Buckets are
log-spaced milliseconds (8 per decade, 1 µs .. 100 s, one overflow
slot), so the structure is O(buckets) however many requests land, and
percentiles are windowed: a ring of chunk vectors covers the last
``window_s`` seconds (``PPTORCH_HIST_WINDOW_S``, default 60), so
``p99`` says how serving does now, not over the whole run.  The bucket
edges, the percentile rule and the snapshot format
(``pypardis_tpu/hist@1``) are the JAX package's, so one reader takes
both packages' snapshots.

:func:`attach_exporters` is the opt-in export plane over one
:class:`~pypardis_tpu_torch.obs.recorder.RunRecorder`, fed through the
sink seam the flight recorder uses (a :class:`Fanout` tees the
tracer's, the registry's and the recorder's ``flight`` slots, so the
flight file and the exporters see the same records):

- :class:`MetricsSnapshotter`, a periodic JSONL snapshot emitter
  (``PPTORCH_METRICS_SNAPSHOT``, interval ``PPTORCH_METRICS_SNAPSHOT_S``,
  default 0.5 s): one self-contained, flushed JSON line per interval;
- :class:`MetricsHTTPExporter`, a stdlib ``http.server`` scrape
  endpoint on 127.0.0.1 (``PPTORCH_METRICS_PORT``; ``0`` binds an
  ephemeral port) serving OpenMetrics text at ``/metrics`` and the raw
  state at ``/state.json``.

Both render on demand: the write path pays one histogram increment per
observation.  With neither knob set :func:`attach_exporters` returns
None.  The snapshot schema and the OpenMetrics family names are the
JAX package's (``pypardis_*``), so its readers take the port's output.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

HIST_SCHEMA = "pypardis_tpu/hist@1"
SNAPSHOT_SCHEMA = "pypardis_tpu/metrics_snapshot@1"

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


# ---------------------------------------------------------------------------
# sink plumbing: fan-out + live state
# ---------------------------------------------------------------------------


class Fanout:
    """Tee one sink seam to several sinks.

    The recorder's tracer/registry/flight slots each hold ONE sink
    object; exporters ride the same seam the flight recorder does by
    replacing the slot with a fanout over [previous sink, exporter
    state].  Methods a member lacks are skipped — a sink never has to
    implement the full record-kind surface.
    """

    def __init__(self, sinks):
        self._sinks = [s for s in sinks if s is not None]

    @classmethod
    def of(cls, prev, new) -> "Fanout":
        if isinstance(prev, Fanout):
            return cls(prev._sinks + [new])
        return cls([prev, new])

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        sinks = self._sinks

        def _call(*a, **k):
            for s in sinks:
                fn = getattr(s, name, None)
                if fn is not None:
                    fn(*a, **k)

        return _call


class LiveState:
    """The exporters' in-memory view of the run: open spans, last
    heartbeat per stage, last resource sample, terminal status — the
    record kinds that are *state* rather than aggregates (the registry
    already holds those).  Implements the flight-recorder sink surface
    it needs; everything else no-ops through :class:`Fanout`."""

    def __init__(self, epoch_s: float = 0.0):
        self.epoch_s = float(epoch_s)
        self._lock = threading.Lock()
        self.open_spans: Dict[int, Tuple[str, float, int]] = {}
        self.heartbeats: Dict[str, Dict] = {}
        self.resources: Dict[str, float] = {}
        self.finished: Optional[str] = None
        self.events = 0
        self.last_event: Optional[str] = None
        # Live span-latency histograms, fed on span close: the registry
        # learns a phase's duration only when its timer closes, but a
        # mid-fit scrape wants the distributions of the inner spans (the
        # chained route's partitions, the pipeline stages) now.
        self.hists: Dict[str, Histogram] = {}

    def set_epoch(self, epoch_s: float) -> None:
        self.epoch_s = float(epoch_s)

    def _observe_span(self, name, dur_s) -> None:
        try:
            ms = float(dur_s) * 1e3
        except (TypeError, ValueError):
            return
        key = "span." + str(name)
        h = self.hists.get(key)
        if h is None:
            h = self.hists[key] = Histogram()
        h.observe(ms)

    def span_open(self, sid, name, t0_s, depth, attrs) -> None:
        with self._lock:
            self.open_spans[int(sid)] = (str(name), float(t0_s),
                                         int(depth))

    def span_close(self, sid, name, t0_s, dur_s, attrs) -> None:
        with self._lock:
            self.open_spans.pop(int(sid), None)
            self._observe_span(name, dur_s)

    def span_complete(self, name, t0_s, dur_s, attrs) -> None:
        with self._lock:
            self._observe_span(name, dur_s)

    def event(self, kind, fields) -> None:
        self.events += 1
        self.last_event = str(kind)

    def heartbeat(self, stage, done, total, eta_s) -> None:
        self.heartbeats[str(stage)] = {
            "done": int(done), "total": int(total),
            "eta_s": round(float(eta_s), 3),
        }

    def sample(self, **fields) -> None:
        for k, v in fields.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.resources[str(k)] = float(v)

    def finish(self, status, **fields) -> None:
        self.finished = str(status)

    def spans_now(self) -> List[Tuple[str, float, int]]:
        """Open spans ordered outermost-first, with elapsed seconds."""
        now = time.perf_counter()
        with self._lock:
            items = sorted(self.open_spans.items())
        return [(name, max(now - t0, 0.0), depth)
                for _, (name, t0, depth) in items]

    def hists_snapshot(self) -> Dict[str, Dict]:
        """{span key -> hist@1 snapshot} of the live span histograms."""
        with self._lock:
            return {k: h.snapshot() for k, h in sorted(self.hists.items())}


# ---------------------------------------------------------------------------
# OpenMetrics text exposition
# ---------------------------------------------------------------------------


def _om_name(key: str) -> str:
    return "pypardis_" + str(key).replace(".", "_")


def _om_label(value) -> str:
    s = str(value)
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


# Label-bearing key convention (the multi-tenant gateway's fleet
# telemetry): inside a ``gateway.``-rooted key, a ``model.<id>`` or
# ``tenant.<id>`` segment pair renders as an OpenMetrics LABEL rather
# than a name segment — ``gateway.model.m03.queries`` becomes
# ``pypardis_gateway_queries{model="m03"}`` — so one scrape shows every
# resident model/tenant as series of the same family instead of N
# distinct metric names.
_OM_LABEL_SEGMENTS = ("model", "tenant")


def _om_key_labels(key: str):
    """Split a registry key into (OpenMetrics family name, rendered
    label block) per the convention above; non-gateway keys pass
    through unchanged with an empty label block."""
    parts = str(key).split(".")
    if parts[0] != "gateway":
        return _om_name(key), ""
    kept, labels, i = [], [], 0
    while i < len(parts):
        if parts[i] in _OM_LABEL_SEGMENTS and i + 1 < len(parts) - 1:
            labels.append((parts[i], parts[i + 1]))
            i += 2
        else:
            kept.append(parts[i])
            i += 1
    name = _om_name(".".join(kept))
    if not labels:
        return name, ""
    lab = ",".join(f'{k}="{_om_label(v)}"' for k, v in labels)
    return name, lab


def _om_hist(out: List[str], key: str, snap: Dict) -> None:
    """Append one ``hist@1`` snapshot as an OpenMetrics histogram
    family (cumulative ``_bucket{le=...}`` series + count + sum);
    gateway per-model/per-tenant keys carry their label block on every
    series."""
    n, lab = _om_key_labels(key)
    pre = lab + "," if lab else ""
    suf = "{" + lab + "}" if lab else ""
    out.append(f"# TYPE {n} histogram")
    cum = 0
    for le, c in snap.get("buckets") or ():
        cum += int(c)
        out.append(f'{n}_bucket{{{pre}le="{float(le):g}"}} {cum}')
    cum += int(snap.get("overflow", 0) or 0)
    out.append(f'{n}_bucket{{{pre}le="+Inf"}} {cum}')
    out.append(f"{n}_count{suf} {int(snap.get('count', cum))}")
    out.append(f"{n}_sum{suf} {float(snap.get('sum_ms', 0.0))}")


def render_openmetrics(reg_dump: Dict,
                       state: Optional[LiveState] = None) -> str:
    """The registry dump (+ live state) as OpenMetrics text exposition
    — counters, gauges, timing summaries, histogram bucket series, open
    spans, heartbeats, resource watermarks, terminated by ``# EOF``."""
    out: List[str] = []
    seen_type: set = set()
    for key in sorted(reg_dump.get("counters") or {}):
        v = reg_dump["counters"][key]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        n, lab = _om_key_labels(key)
        if n not in seen_type:
            seen_type.add(n)
            out.append(f"# TYPE {n} counter")
        suf = "{" + lab + "}" if lab else ""
        out.append(f"{n}_total{suf} {v}")
    for key in sorted(reg_dump.get("gauges") or {}):
        v = reg_dump["gauges"][key]
        if isinstance(v, bool):
            v = int(v)
        if not isinstance(v, (int, float)):
            continue
        n, lab = _om_key_labels(key)
        if n not in seen_type:
            seen_type.add(n)
            out.append(f"# TYPE {n} gauge")
        suf = "{" + lab + "}" if lab else ""
        out.append(f"{n}{suf} {v}")
    for key in sorted(reg_dump.get("timings") or {}):
        t = reg_dump["timings"][key]
        n = _om_name(key) + "_seconds"
        out.append(f"# TYPE {n} summary")
        out.append(f"{n}_count {int(t.get('count', 0))}")
        out.append(f"{n}_sum {round(float(t.get('total_s', 0.0)), 6)}")
    for key in sorted(reg_dump.get("hists") or {}):
        _om_hist(out, key, reg_dump["hists"][key])
    if state is not None:
        for key, snap in state.hists_snapshot().items():
            _om_hist(out, key, snap)
        spans = state.spans_now()
        if spans:
            out.append("# TYPE pypardis_open_span gauge")
            for name, elapsed, depth in spans:
                out.append(
                    f'pypardis_open_span{{name="{_om_label(name)}",'
                    f'depth="{depth}"}} {round(elapsed, 3)}'
                )
        if state.heartbeats:
            for fam in ("done", "total", "eta_seconds"):
                out.append(f"# TYPE pypardis_heartbeat_{fam} gauge")
            for stage in sorted(state.heartbeats):
                hb = state.heartbeats[stage]
                lab = f'{{stage="{_om_label(stage)}"}}'
                out.append(
                    f"pypardis_heartbeat_done{lab} {hb['done']}"
                )
                out.append(
                    f"pypardis_heartbeat_total{lab} {hb['total']}"
                )
                out.append(
                    f"pypardis_heartbeat_eta_seconds{lab} {hb['eta_s']}"
                )
        for k in sorted(state.resources):
            n = f"pypardis_resource_{_om_label(k)}"
            out.append(f"# TYPE {n} gauge")
            out.append(f"{n} {state.resources[k]}")
        out.append("# TYPE pypardis_run_finished gauge")
        out.append(
            f"pypardis_run_finished {0 if state.finished is None else 1}"
        )
    out.append("# EOF")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------


class MetricsSnapshotter:
    """Periodic JSONL metrics-snapshot emitter.

    One self-contained JSON line per interval — counters, gauges,
    histogram snapshots, open spans, heartbeats, resource watermarks —
    appended and flushed line-by-line, so a SIGKILLed process leaves a
    stream where every line but (at worst) the last parses.  The first
    line lands immediately at start; one final line lands at close.
    """

    def __init__(self, recorder, state: LiveState, path: str,
                 interval_s: float = 0.5):
        self._rec = recorder
        self._state = state
        self.path = str(path)
        self.interval_s = max(float(interval_s), 0.05)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="pypardis-metrics-snapshot",
            daemon=True,
        )
        self.lines = 0

    def start(self) -> "MetricsSnapshotter":
        self._emit()
        self._thread.start()
        return self

    def _emit(self) -> None:
        st = self._state
        dump = self._rec.metrics.as_dict()
        line = {
            "schema": SNAPSHOT_SCHEMA,
            "t_unix": round(time.time(), 3),
            "t": round(time.perf_counter() - st.epoch_s, 6),
            "counters": dump["counters"],
            "gauges": {
                k: v for k, v in dump["gauges"].items()
                if isinstance(v, (int, float, str, bool)) or v is None
            },
            "hists": dump.get("hists") or {},
            "span_hists": st.hists_snapshot(),
            "open_spans": [name for name, _, _ in st.spans_now()],
            "heartbeats": st.heartbeats,
            "resources": st.resources,
            "finished": st.finished,
        }
        try:
            payload = json.dumps(line, default=str)
        except (TypeError, ValueError):
            return  # an exporter must never take the run down
        f = self._f
        if f.closed:
            return
        try:
            f.write(payload + "\n")
            f.flush()
            self.lines += 1
        except OSError:
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._emit()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self._emit()
        finally:
            try:
                self._f.close()
            except OSError:
                pass


# The last port an HTTP exporter actually bound in this process —
# discovery hook for in-process harnesses using PPTORCH_METRICS_PORT=0
# (an ephemeral port the parent could not otherwise learn).
_LAST_HTTP_PORT: List[int] = []


def last_http_port() -> Optional[int]:
    return _LAST_HTTP_PORT[-1] if _LAST_HTTP_PORT else None


class MetricsHTTPExporter:
    """Opt-in OpenMetrics scrape endpoint on stdlib ``http.server``.

    Serves ``GET /metrics`` (OpenMetrics text exposition rendered from
    the live registry + run state) and ``GET /state.json`` (the raw
    snapshot line as JSON) on 127.0.0.1.  ``port=0`` binds an ephemeral
    port (readable from ``.port`` / :func:`last_http_port`).  Requests
    are served from daemon threads; scraping never blocks the fit.
    """

    def __init__(self, recorder, state: LiveState, port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        rec, st = recorder, state

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: N802 — stdlib API
                pass

            def do_GET(self):  # noqa: N802 — stdlib API
                if self.path.split("?", 1)[0] == "/metrics":
                    body = render_openmetrics(
                        rec.metrics.as_dict(), st
                    ).encode("utf-8")
                    ctype = (
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8"
                    )
                elif self.path.split("?", 1)[0] == "/state.json":
                    dump = rec.metrics.as_dict()
                    body = json.dumps(
                        {
                            "schema": SNAPSHOT_SCHEMA,
                            "hists": dump.get("hists") or {},
                            "span_hists": st.hists_snapshot(),
                            "gauges": dump["gauges"],
                            "counters": dump["counters"],
                            "open_spans": [
                                n for n, _, _ in st.spans_now()
                            ],
                            "heartbeats": st.heartbeats,
                            "resources": st.resources,
                            "finished": st.finished,
                        },
                        default=str,
                    ).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(
            ("127.0.0.1", int(port)), _Handler
        )
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        _LAST_HTTP_PORT.append(self.port)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="pypardis-metrics-http", daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


class ExporterStack:
    """The attached exporters of one recorder, with teardown that
    restores the sink seam exactly as it was."""

    def __init__(self, state: LiveState):
        self.state = state
        self.http: Optional[MetricsHTTPExporter] = None
        self.snapshot: Optional[MetricsSnapshotter] = None
        self._restore: List[Tuple[object, str, object]] = []

    @property
    def http_port(self) -> Optional[int]:
        return self.http.port if self.http is not None else None

    def close(self) -> None:
        if self.snapshot is not None:
            self.snapshot.close()
        if self.http is not None:
            self.http.close()
        for obj, attr, prev in reversed(self._restore):
            setattr(obj, attr, prev)
        self._restore = []


def attach_exporters(recorder, *, port=None, snapshot_path=None,
                     snapshot_interval_s=None) -> Optional[ExporterStack]:
    """Wire the opt-in export plane onto ``recorder`` for the duration
    of a fit / load harness; returns the stack to ``close()``, or None
    when nothing is configured.

    ``port`` defaults to ``PPTORCH_METRICS_PORT`` (the scrape
    endpoint; ``0`` = ephemeral), ``snapshot_path`` to
    ``PPTORCH_METRICS_SNAPSHOT``, ``snapshot_interval_s`` to
    ``PPTORCH_METRICS_SNAPSHOT_S``.  The exporters tee into the same
    sink seam the flight recorder uses (tracer sink, registry sink, and
    the recorder's ``flight`` slot), so heartbeats, spans, and resource
    samples reach them whether or not a flight file is attached.
    Export destinations land in the registry (``metrics.http_port`` /
    ``metrics.snapshot_path``) so ``report()``/``summary()`` can say
    where the live metrics went.
    """
    if recorder is None:
        return None
    if port is None:
        env = os.environ.get("PPTORCH_METRICS_PORT")
        if env not in (None, ""):
            try:
                port = int(env)
            except ValueError:
                port = None
    if snapshot_path is None:
        snapshot_path = os.environ.get("PPTORCH_METRICS_SNAPSHOT") or None
    if port is None and snapshot_path is None:
        return None
    if snapshot_interval_s is None:
        try:
            snapshot_interval_s = float(
                os.environ.get("PPTORCH_METRICS_SNAPSHOT_S", 0.5)
            )
        except ValueError:
            snapshot_interval_s = 0.5

    state = LiveState(epoch_s=recorder.tracer.epoch_s)
    stack = ExporterStack(state)
    for obj, attr in (
        (recorder.tracer, "sink"),
        (recorder.metrics, "sink"),
        (recorder, "flight"),
    ):
        prev = getattr(obj, attr, None)
        stack._restore.append((obj, attr, prev))
        setattr(obj, attr, Fanout.of(prev, state))
    if port is not None:
        try:
            stack.http = MetricsHTTPExporter(recorder, state, port=port)
            recorder.metrics.set("metrics.http_port", stack.http.port)
        except OSError as e:
            import sys

            print(
                f"pypardis_tpu_torch: metrics endpoint bind failed on port "
                f"{port}: {e} — continuing without the scrape endpoint",
                file=sys.stderr,
            )
    if snapshot_path is not None:
        stack.snapshot = MetricsSnapshotter(
            recorder, state, snapshot_path,
            interval_s=snapshot_interval_s,
        ).start()
        recorder.metrics.set(
            "metrics.snapshot_path", str(snapshot_path)
        )
    if stack.http is None and stack.snapshot is None:
        stack.close()  # bind failed and no snapshot: restore the seam
        return None
    return stack
