"""Span tracing with device-sync semantics and Chrome-trace export
(counterpart of ``pypardis_tpu/obs/trace.py``).

Spans nest (a stack per tracer) and measure wall time.  Work queued on
the card runs after the Python that queued it returns, so a span can
wait for it before it closes: ``sync_on(tensors)`` records an event on
the current stream of each CUDA tensor's device and waits on those
events at span exit, so the span covers the device work queued before
the call; ``sync=True`` synchronises the tracer's device (the fit's).
On the CPU both are no-ops: the work has run by the time the call
returns.

Export is Chrome trace format (the ``traceEvents`` JSON that
chrome://tracing and Perfetto load), in the JAX package's layout, so
one reader takes both packages' traces.  ``torch.profiler``'s trace
(``utils/profiling.trace``) is the device-level complement.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional


class Span:
    """One completed (or in-flight) span.  ``dur_s`` is None while
    open."""

    __slots__ = ("name", "t0_s", "dur_s", "depth", "attrs", "_pending")

    def __init__(self, name: str, t0_s: float, depth: int, attrs: dict):
        self.name = name
        self.t0_s = t0_s
        self.dur_s: Optional[float] = None
        self.depth = depth
        self.attrs = attrs
        self._pending = None

    def sync_on(self, tensors) -> None:
        """Wait at span exit for the device work queued so far on the
        streams of ``tensors`` (a tensor or a nested list/tuple/dict of
        them): an event is recorded now on the current stream of each
        CUDA tensor's device.  CPU tensors and other objects add
        nothing."""
        events = _record_events(tensors)
        self._pending = (self._pending or []) + events

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


def _cuda_devices(obj, out: set) -> set:
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    return out


def _record_events(tensors) -> list:
    import torch

    events = []
    for dev in sorted(_cuda_devices(tensors, set()), key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


def _sync_device(device) -> None:
    """Wait for all work queued on ``device`` (a CUDA device); a no-op
    for the CPU.  ``None``: the current CUDA device, where CUDA is
    initialised in this process."""
    import torch

    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """Collect spans relative to one epoch; export as Chrome trace.

    ``device`` is the device ``sync=True`` synchronises (the fit sets
    its own; None: the current CUDA device if CUDA is initialised).
    """

    # Retention cap: the process-ambient recorder lives forever, so an
    # unbounded span list would be a slow leak under sustained traffic.
    # 16k spans ≈ a few MB; beyond it new spans are counted, not kept.
    MAX_SPANS = 16_384

    def __init__(self, device=None):
        self.epoch_s = time.perf_counter()
        self.spans: List[Span] = []
        self.dropped = 0
        self.device = device
        self._stack: List[Span] = []
        # Optional streaming sink (obs.flight.FlightRecorder): span
        # opens and closes are appended to its JSONL file as they happen.
        self.sink = None
        self._next_id = 0

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False, **attrs):
        sp = Span(name, time.perf_counter(), len(self._stack), attrs)
        sid = self._next_id
        self._next_id += 1
        self._stack.append(sp)
        if self.sink is not None:
            self.sink.span_open(sid, name, sp.t0_s, sp.depth, attrs)
        failed = False
        try:
            yield sp
        except BaseException:
            failed = True
            raise
        finally:
            self._stack.pop()
            if sp._pending:
                for ev in sp._pending:
                    ev.synchronize()
            elif sync:
                _sync_device(self.device)
            sp._pending = None
            sp.dur_s = time.perf_counter() - sp.t0_s
            self._keep(sp)
            # A span an exception unwinds through stays OPEN in the
            # flight file, the signature a SIGKILL leaves too: the last
            # open record marks where the run died (the in-memory span
            # still closes, so export_trace is unaffected).
            if self.sink is not None and not failed:
                self.sink.span_close(sid, name, sp.t0_s, sp.dur_s,
                                     sp.attrs)

    def _keep(self, sp: Span) -> None:
        if len(self.spans) < self.MAX_SPANS:
            self.spans.append(sp)
        else:
            self.dropped += 1

    def add_complete(self, name: str, t0_s: float, dur_s: float,
                     **attrs) -> Span:
        """Record an already-measured interval (absolute perf_counter
        start): the bridge for timers that measured on their own."""
        sp = Span(name, t0_s, len(self._stack), attrs)
        sp.dur_s = dur_s
        self._keep(sp)
        if self.sink is not None:
            self.sink.span_complete(name, t0_s, dur_s, attrs)
        return sp

    def durations(self) -> Dict[str, float]:
        """{span name -> total seconds} over completed spans."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            if sp.dur_s is not None:
                out[sp.name] = out.get(sp.name, 0.0) + sp.dur_s
        return out

    # -- Chrome trace export ---------------------------------------------

    def to_chrome_trace(self, pid: int = 0,
                        label: str = "pypardis_tpu_torch driver",
                        offset_s: float = 0.0) -> dict:
        """``{"traceEvents": [...]}``: complete ("X") events in
        microseconds relative to the tracer epoch (loads in
        chrome://tracing and ui.perfetto.dev).  ``pid``/``label`` name
        the lane; ``offset_s`` shifts every timestamp."""
        events = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": int(pid),
                "tid": 0,
                "args": {"name": str(label)},
            }
        ]
        for sp in self.spans:
            if sp.dur_s is None:
                continue
            events.append(
                {
                    "name": sp.name,
                    "ph": "X",
                    "pid": int(pid),
                    "tid": 0,
                    "ts": (sp.t0_s - self.epoch_s + offset_s) * 1e6,
                    "dur": sp.dur_s * 1e6,
                    "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def _jsonable(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            return str(v)
    return str(v)
