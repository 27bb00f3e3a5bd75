"""Crash-safe flight recorder: an append-only JSONL telemetry sink
(counterpart of ``pypardis_tpu/obs/flight.py``).

``report()`` and ``export_trace()`` need a live recorder in a live
process; a run that dies mid-fit leaves nothing there.  The flight
recorder is the durable complement: every span open and close, phase
timing, gauge write, event, heartbeat and resource sample is appended
to a JSONL file and flushed within one flush interval (0.25 s unless
the constructor says otherwise; span opens, closes and events flush at
once), so a killed run leaves a parseable post-mortem.

Crash semantics:

* a span an exception unwinds through is left open in the file (no
  close record), the signature a SIGKILL leaves too, so the last open
  span marks where the run died; the in-memory tracer still closes it;
* a run that ends (ok or error) appends one ``fin`` record; a file
  without it was killed outright.

:func:`replay` rebuilds the observable state from the file alone: a
Chrome trace (open spans drawn to the last record's time and tagged
``unclosed``), the metrics registry, the event log and a partial
``run_report``.

The file format is the JAX package's (``pypardis_tpu/flight@1``), so a
port flight file replays in the JAX ``replay`` and a JAX one here: one
JSON object per line, ``k`` the record kind: ``header``, ``so``/``sc``
(span open/close by ``id``), ``sx`` (a pre-measured span), ``ev``
(event), ``g``/``c``/``tm`` (gauge/counter/timing write), ``h`` (a
latency-histogram snapshot, the last per key wins), ``rs`` (resource
sample), ``hb`` (heartbeat), ``note``, ``fin``.  Every ``t`` is seconds
from the recorder's tracer epoch.  A directory of per-process files
(the JAX fleet replay) needs the multi-process layer (ROADMAP A10).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .recorder import current
from .trace import _jsonable

FLIGHT_SCHEMA = "pypardis_tpu/flight@1"

_FLUSH_DEFAULT_S = 0.25

# Per-process sequence for directory-mode file names: two fits in the
# same second must not collide.
_seq_lock = threading.Lock()
_seq = [0]


def _next_seq() -> int:
    with _seq_lock:
        _seq[0] += 1
        return _seq[0]


class FlightRecorder:
    """One append-only JSONL sink, attached to one :class:`RunRecorder`.

    Thread-safe (the resource sampler writes from its own thread).
    ``flush_interval_s`` bounds how stale the on-disk tail can be; a
    plain ``flush()`` (user buffer -> OS) is enough for the SIGKILL
    contract — the process dies, the kernel keeps the written bytes.
    """

    def __init__(self, path: str,
                 flush_interval_s: float = _FLUSH_DEFAULT_S):
        self.path = path
        self._flush_every = max(float(flush_interval_s), 0.0)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._last_flush = 0.0
        self._finished = False
        self.records = 0
        self._hists: Dict[str, object] = {}
        self._hist_last_emit: Dict[str, float] = {}

    # -- wiring ------------------------------------------------------------

    def set_epoch(self, epoch_s: float) -> None:
        """Adopt the attached tracer's epoch so span/record timestamps
        share one clock."""
        self._epoch = float(epoch_s)

    def _t(self, abs_s: Optional[float] = None) -> float:
        base = time.perf_counter() if abs_s is None else abs_s
        return round(base - self._epoch, 6)

    def _emit(self, rec: Dict, urgent: bool = False) -> None:
        try:
            line = json.dumps(rec, separators=(",", ":"), default=str)
        except (TypeError, ValueError):
            return  # a sink must never take the fit down
        with self._lock:
            f = self._f
            if f is None or f.closed:
                return
            f.write(line + "\n")
            self.records += 1
            now = time.monotonic()
            if urgent or now - self._last_flush >= self._flush_every:
                f.flush()
                self._last_flush = now

    @staticmethod
    def _attrs(attrs: Dict) -> Dict:
        return {k: _jsonable(v) for k, v in attrs.items()}

    # -- record kinds ------------------------------------------------------

    def header(self, **fields) -> None:
        self._emit(
            {
                "k": "header",
                "schema": FLIGHT_SCHEMA,
                "pid": os.getpid(),
                "t_unix": round(time.time(), 3),
                **self._attrs(fields),
                **(
                    {"params": fields["params"]}
                    if isinstance(fields.get("params"), dict)
                    else {}
                ),
            },
            urgent=True,
        )

    def span_open(self, sid, name, t0_s, depth, attrs) -> None:
        self._emit(
            {
                "k": "so",
                "id": int(sid),
                "name": name,
                "t": self._t(t0_s),
                "depth": int(depth),
                "a": self._attrs(attrs),
            },
            urgent=True,
        )

    def span_close(self, sid, name, t0_s, dur_s, attrs) -> None:
        self._emit(
            {
                "k": "sc",
                "id": int(sid),
                "name": name,
                "t": self._t(t0_s),
                "dur": round(float(dur_s), 6),
                "a": self._attrs(attrs),
            },
            urgent=True,
        )

    def span_complete(self, name, t0_s, dur_s, attrs) -> None:
        self._emit(
            {
                "k": "sx",
                "name": name,
                "t": self._t(t0_s),
                "dur": round(float(dur_s), 6),
                "a": self._attrs(attrs),
            },
            urgent=True,
        )

    def event(self, kind: str, fields: Dict) -> None:
        self._emit(
            {"k": "ev", "kind": kind, "t": self._t(),
             "f": self._attrs(fields)},
            urgent=True,
        )

    def gauge(self, key: str, value) -> None:
        self._emit({"k": "g", "key": key, "v": _jsonable(value),
                    "t": self._t()})

    def count(self, key: str, value) -> None:
        self._emit({"k": "c", "key": key, "v": _jsonable(value),
                    "t": self._t()})

    def timing(self, key: str, seconds: float) -> None:
        self._emit({"k": "tm", "key": key, "s": round(float(seconds), 6),
                    "t": self._t()})

    def sample(self, **fields) -> None:
        self._emit({"k": "rs", "t": self._t(), **self._attrs(fields)})

    def heartbeat(self, stage: str, done: int, total: int,
                  eta_s: float) -> None:
        self._emit(
            {"k": "hb", "stage": stage, "done": int(done),
             "total": int(total), "eta_s": round(float(eta_s), 3),
             "t": self._t()}
        )

    def note(self, kind: str, fields: Dict) -> None:
        self._emit({"k": "note", "kind": kind, "t": self._t(),
                    **self._attrs(fields)})

    def hist(self, key: str, value_ms: float) -> None:
        """One latency observation on the ``key`` histogram.

        Per-observation records would put the O(requests) cost this
        metric type exists to kill back on disk, so the recorder
        aggregates into its own bounded histogram and emits a compact
        ``h`` snapshot record at most once per flush interval per key
        (plus a final snapshot from :meth:`finish`).
        """
        from .export import Histogram

        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = Histogram()
        h.observe(value_ms)
        now = time.monotonic()
        gap = max(self._flush_every, 0.05)
        if now - self._hist_last_emit.get(key, 0.0) < gap:
            return
        self._hist_last_emit[key] = now
        self._emit({"k": "h", "key": key, "t": self._t(),
                    "snap": h.snapshot()})

    def finish(self, status: str, **fields) -> None:
        """Terminal record — first call wins (the error path writes
        ``status="error"`` before the generic close writes ``"ok"``)."""
        if self._finished:
            return
        self._finished = True
        for key, h in self._hists.items():
            self._emit({"k": "h", "key": key, "t": self._t(),
                        "snap": h.snapshot()})
        self._emit(
            {"k": "fin", "status": status, "t": self._t(),
             **self._attrs(fields)},
            urgent=True,
        )

    def close(self) -> None:
        with self._lock:
            f = self._f
            if f is None or f.closed:
                return
            try:
                f.flush()
            finally:
                f.close()


def open_flight(spec=None) -> Optional[FlightRecorder]:
    """Resolve the opt-in to a :class:`FlightRecorder`, or None.

    ``spec``: a ``*.jsonl`` file path (appended to), any other string
    (a directory: one fresh ``flight-<pid>-<stamp>-<seq>.jsonl`` per
    fit), or None to defer to ``PPTORCH_FLIGHT`` (same meanings; unset
    or empty disables).
    """
    if spec is None:
        spec = os.environ.get("PPTORCH_FLIGHT")
    if not spec:
        return None
    spec = str(spec)
    if spec.endswith(".jsonl"):
        d = os.path.dirname(spec)
        if d:
            os.makedirs(d, exist_ok=True)
        return FlightRecorder(spec)
    os.makedirs(spec, exist_ok=True)
    name = "flight-%d-%s-%d.jsonl" % (
        os.getpid(), time.strftime("%Y%m%d-%H%M%S"), _next_seq()
    )
    return FlightRecorder(os.path.join(spec, name))


def flight_note(kind: str, **fields) -> None:
    """Append an annotation record to the current fit's flight file, if
    one is attached; free without one, so library layers call it
    unconditionally."""
    fl = getattr(current(), "flight", None)
    if fl is not None:
        fl.note(kind, fields)


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

_HB_LAST: Dict[str, float] = {}


def heartbeat(stage: str, done: int, total: int, t0_s: float) -> None:
    """Per-round progress with a rounds-remaining estimate.

    Always lands in the flight file when one is attached; logs a line
    when ``PPTORCH_HEARTBEAT`` is set (its float value is the least
    seconds between lines per stage, ``1`` at most one a second; the
    final round always logs).  The chained route's partition loop
    (``chained.partitions``) calls it.
    """
    now = time.perf_counter()
    elapsed = now - t0_s
    done, total = int(done), int(total)
    remaining = max(total - done, 0)
    eta = (elapsed / done) * remaining if done > 0 else -1.0
    fl = getattr(current(), "flight", None)
    if fl is not None:
        fl.heartbeat(stage, done, total, eta)
    env = os.environ.get("PPTORCH_HEARTBEAT")
    if not env or env in ("0", "false"):
        return
    try:
        min_gap = float(env)
    except ValueError:
        min_gap = 0.0
    last = _HB_LAST.get(stage)
    if last is not None and now - last < min_gap and done < total:
        return
    _HB_LAST[stage] = now
    from ..utils import log as _log

    if not _log.get_logger().handlers:
        _log.enable()
    _log.get_logger().info(
        "heartbeat %s %d/%d rounds, elapsed %.1fs, eta %.1fs",
        stage, done, total, elapsed, max(eta, 0.0),
    )


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


class FlightReplay:
    """The observable state of a (possibly killed) run, reconstructed
    from its flight file alone.

    ``open_spans`` are the spans the run died inside (opened, never
    closed — a SIGKILL or an exception unwinding); ``complete`` is True
    iff a terminal ``fin`` record was written; ``status`` is its
    ``ok``/``error`` value (None for a killed run).
    """

    def __init__(self, path: str):
        from .recorder import RunRecorder

        self.path = path
        self.header: Dict = {}
        self.status: Optional[str] = None
        self.complete = False
        self.records = 0
        self.bad_lines = 0
        self.open_spans: List[Dict] = []
        self.heartbeats: Dict[str, Dict] = {}
        rec = RunRecorder()
        rec.tracer.epoch_s = 0.0
        self.recorder = rec
        open_map: Dict[int, Dict] = {}
        hist_last: Dict[str, Dict] = {}
        last_t = 0.0
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                # A SIGKILL can truncate the final line mid-write; any
                # earlier corruption is counted, not fatal — a
                # post-mortem reader salvages what parses.
                self.bad_lines += 1
                continue
            self.records += 1
            t = float(r.get("t", last_t) or 0.0)
            last_t = max(last_t, t)
            k = r.get("k")
            try:
                if k == "header":
                    self.header = r
                elif k == "so":
                    open_map[int(r["id"])] = r
                elif k == "sc":
                    open_map.pop(int(r["id"]), None)
                    rec.tracer.add_complete(
                        r.get("name", "?"), t, float(r.get("dur", 0.0)),
                        **(r.get("a") or {})
                    )
                    last_t = max(last_t, t + float(r.get("dur", 0.0)))
                elif k == "sx":
                    rec.tracer.add_complete(
                        r.get("name", "?"), t, float(r.get("dur", 0.0)),
                        **(r.get("a") or {})
                    )
                    last_t = max(last_t, t + float(r.get("dur", 0.0)))
                elif k == "ev":
                    rec.metrics.inc("events." + str(r.get("kind")))
                    if len(rec.events) < rec.MAX_EVENTS:
                        rec.events.append(
                            {"kind": r.get("kind"), "t_s": t,
                             **(r.get("f") or {})}
                        )
                elif k == "g":
                    rec.metrics.set(r["key"], r.get("v"))
                elif k == "c":
                    # events.* counter bumps are duplicates of the
                    # (urgent, authoritative) "ev" records — skip them
                    # so replayed event counts aren't doubled.
                    if not str(r["key"]).startswith("events."):
                        rec.metrics.inc(r["key"], r.get("v", 1))
                elif k == "tm":
                    rec.metrics.observe(r["key"], float(r.get("s", 0.0)))
                elif k == "h":
                    # Histogram snapshots supersede each other (each
                    # carries the full lifetime counts) — keep the last
                    # per key, installed at end-of-parse below.
                    hist_last[str(r["key"])] = r.get("snap") or {}
                elif k == "hb":
                    self.heartbeats[str(r.get("stage"))] = {
                        "done": int(r.get("done", 0) or 0),
                        "total": int(r.get("total", 0) or 0),
                        "eta_s": float(r.get("eta_s", -1.0) or 0.0),
                        "t_s": t,
                    }
                elif k == "fin":
                    self.complete = True
                    self.status = r.get("status")
            except (KeyError, TypeError, ValueError):
                self.bad_lines += 1
        for key, snap in hist_last.items():
            try:
                rec.metrics.load_hist(key, snap)
            except (KeyError, TypeError, ValueError):
                self.bad_lines += 1
        self.last_t_s = last_t
        # Spans the run died inside: render them to the last timestamp
        # the file saw, tagged so the Chrome trace shows the death site.
        for r in sorted(open_map.values(), key=lambda x: x.get("t", 0.0)):
            t0 = float(r.get("t", 0.0) or 0.0)
            dur = max(last_t - t0, 0.0)
            attrs = dict(r.get("a") or {})
            attrs["unclosed"] = True
            sp = rec.tracer.add_complete(r.get("name", "?"), t0, dur,
                                         **attrs)
            self.open_spans.append(
                {"name": sp.name, "t_s": t0, "attrs": attrs}
            )

    # -- export surfaces ---------------------------------------------------

    def to_chrome_trace(self) -> dict:
        return self.recorder.tracer.to_chrome_trace()

    def export_chrome_trace(self, path: str) -> str:
        return self.recorder.tracer.export_chrome_trace(path)

    def report(self) -> Dict:
        """A (possibly partial) ``run_report@1`` dict from the file
        alone: phases from the flushed timing records, run gauges,
        resources watermarks, event counts, and the registry dump; the
        extra ``flight`` block says how complete the record is."""
        from .report import build_run_report

        metrics: Dict = {}
        reg = self.recorder.metrics
        for key, tdict in reg.as_dict()["timings"].items():
            if key.startswith("phase."):
                metrics[key[len("phase."):] + "_s"] = tdict["total_s"]
        for key, v in reg.gauges_with_prefix("run.").items():
            metrics[key[len("run."):]] = v
        # Wall-clock absorbed into the registry only on fit completion;
        # for a killed run the last on-disk timestamp is the honest
        # lower bound.
        metrics.setdefault("total_s", round(self.last_t_s, 6))
        hdr = self.header
        rep = build_run_report(
            self.recorder,
            params=hdr.get("params") or {},
            n_points=int(hdr.get("n_points", 0) or 0),
            n_dims=int(hdr.get("n_dims", 0) or 0),
            n_devices=int(hdr.get("n_devices", 1) or 1),
            backend=str(hdr.get("backend", "unknown")),
            metrics=metrics,
        )
        rep["partial"] = not self.complete
        rep["flight"] = {
            "schema": hdr.get("schema", FLIGHT_SCHEMA),
            "path": self.path,
            "records": self.records,
            "bad_lines": self.bad_lines,
            "status": self.status,
            "open_spans": [s["name"] for s in self.open_spans],
            "last_t_s": round(self.last_t_s, 6),
        }
        return rep

    def summary(self) -> str:
        from .report import format_summary

        s = format_summary(self.report())
        if not self.complete:
            inside = ", ".join(s_["name"] for s_ in self.open_spans)
            s += (
                "\n  flight: PARTIAL (run killed"
                + (f" inside {inside}" if inside else "")
                + f"; {self.records} records to t={self.last_t_s:.3f}s)"
            )
        return s


def replay(path: str) -> FlightReplay:
    """Rebuild a run's observable state from its flight file: the
    post-mortem path for killed runs.  A directory of per-process files
    (the JAX package's fleet replay) needs the multi-process layer and
    raises ``NotImplementedError`` (ROADMAP A10)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            "replay of a directory of per-process flight files (the "
            "fleet replay) needs the multi-process layer, not yet ported "
            "(ROADMAP A10); pass one flight-*.jsonl file"
        )
    return FlightReplay(path)
