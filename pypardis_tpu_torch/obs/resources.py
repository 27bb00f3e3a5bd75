"""Resource watermarks: host RSS, device live bytes, staging pool
(counterpart of ``pypardis_tpu/obs/resources.py``).

:class:`ResourceSampler` is a daemon thread, one per fit, started and
always joined by the fit, that samples

* host RSS (``/proc/self/status``'s ``VmRSS``; ``getrusage``'s peak as
  the fallback),
* the fit device's live bytes (``torch.cuda.memory_allocated``; 0 on
  the CPU),
* the staging pool's bytes (0: the port has no staging cache yet),

and keeps the peaks in the fit's registry as ``resources.*`` gauges
(``report()["resources"]``, finite on every route), streaming each raw
sample into the flight file when one is attached, so the memory curve
survives a kill.  ``PPTORCH_RESOURCE_INTERVAL_S`` sets the period
(default 0.2 s); ``PPTORCH_RSS_SOFT_LIMIT`` (bytes, 0 = off) the host
watermark behind :func:`memory_pressure`.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

_INTERVAL_DEFAULT_S = 0.2
_THREAD_NAME = "pypardis-resource-sampler"


def host_rss_bytes() -> int:
    """Current resident set size in bytes (0 if unreadable)."""
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    return int(line.split()[1]) * 1024
    except Exception:  # noqa: BLE001 — sampling must never raise
        pass
    try:
        import resource

        # ru_maxrss is a peak in KB on Linux: a usable fallback
        # watermark even though it never falls.
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:  # noqa: BLE001
        return 0


def device_live_bytes(device=None) -> int:
    """Bytes the caching allocator holds live on ``device`` (a CUDA
    device; None: the current one where CUDA is initialised); 0 on the
    CPU."""
    try:
        import torch

        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                return 0
        elif not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return 0
        return int(torch.cuda.memory_allocated(device))
    except Exception:  # noqa: BLE001
        return 0


def staging_pool_bytes() -> int:
    """Bytes held by the staging economy.  The port has no staging
    cache until ROADMAP A16's item 10 ports it, so this is 0."""
    return 0


def rss_soft_limit() -> int:
    """The host-RSS soft watermark in bytes (``PPTORCH_RSS_SOFT_LIMIT``;
    0 = disabled)."""
    try:
        return int(float(os.environ.get("PPTORCH_RSS_SOFT_LIMIT", 0)))
    except (TypeError, ValueError):
        return 0


def memory_pressure() -> bool:
    """Whether host RSS exceeds the soft limit now (one ``/proc``
    read), so callers outside a sampled fit see the same verdict:
    ``sharded_dbscan``'s ``merge="auto"`` then takes the host merge
    instead of the device merge's (N+1,) arrays."""
    limit = rss_soft_limit()
    return bool(limit) and host_rss_bytes() > limit


class ResourceSampler:
    """Background watermark sampler for one fit.

    ``start()`` takes one sample at once (so a fit shorter than the
    period still reports finite watermarks), then starts the daemon
    thread; ``stop()`` is idempotent, always joins the thread and takes
    a final sample.  ``device``: the fit's device (None: the recorder's
    tracer device).
    """

    def __init__(self, recorder, interval_s: Optional[float] = None,
                 device=None):
        if interval_s is None:
            interval_s = float(os.environ.get(
                "PPTORCH_RESOURCE_INTERVAL_S", _INTERVAL_DEFAULT_S))
        self._rec = recorder
        self._device = (
            device if device is not None
            else getattr(recorder.tracer, "device", None)
        )
        self._interval = max(float(interval_s), 0.01)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._peak_host = 0
        self._peak_dev = 0
        self._peak_pool = 0
        self._samples = 0
        self._soft_limit = rss_soft_limit()
        self._pressure_noted = False

    def _sample(self) -> None:
        host = host_rss_bytes()
        dev = device_live_bytes(self._device)
        pool = staging_pool_bytes()
        self._samples += 1
        # Crossing the soft limit emits one resource.pressure event per
        # fit (the gauge stays current).
        if self._soft_limit and host > self._soft_limit:
            self._rec.metrics.set("resources.pressure", True)
            if not self._pressure_noted:
                self._pressure_noted = True
                self._rec.event(
                    "resource.pressure", rss_bytes=int(host),
                    soft_limit_bytes=int(self._soft_limit),
                )
        grew = (
            host > self._peak_host or dev > self._peak_dev
            or pool > self._peak_pool
        )
        self._peak_host = max(self._peak_host, host)
        self._peak_dev = max(self._peak_dev, dev)
        self._peak_pool = max(self._peak_pool, pool)
        m = self._rec.metrics
        # Gauges only when a peak moved (each write also lands in the
        # flight file), plus the first sample.
        if grew or self._samples == 1:
            m.set("resources.peak_host_rss_bytes", self._peak_host)
            m.set("resources.peak_device_bytes", self._peak_dev)
            m.set("resources.staging_pool_bytes", self._peak_pool)
        m.set("resources.samples", self._samples)
        fl = getattr(self._rec, "flight", None)
        if fl is not None:
            fl.sample(rss=host, dev=dev, pool=pool)

    def _run(self) -> None:
        while not self._stop_evt.wait(self._interval):
            try:
                self._sample()
            except Exception:  # noqa: BLE001 — never take the fit down
                pass

    def start(self) -> "ResourceSampler":
        try:
            self._sample()
        except Exception:  # noqa: BLE001
            pass
        self._thread = threading.Thread(
            target=self._run, name=_THREAD_NAME, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        try:
            self._sample()
        except Exception:  # noqa: BLE001
            pass
        m = self._rec.metrics
        m.set("resources.peak_host_rss_bytes", self._peak_host)
        m.set("resources.peak_device_bytes", self._peak_dev)
        m.set("resources.staging_pool_bytes", self._peak_pool)
        m.set("resources.samples", self._samples)
