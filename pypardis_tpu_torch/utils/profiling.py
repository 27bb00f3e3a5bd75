"""Per-phase timing and the device trace (counterpart of
``pypardis_tpu/utils/profiling.py``).

:class:`PhaseTimer` accumulates named phase seconds; each phase is also
a span on the current :class:`~pypardis_tpu_torch.obs.RunRecorder`'s
tracer and a ``phase.<name>`` timing in its registry, and both stream
to the fit's flight file when one is attached (the span's open record
lands when the phase starts, so a killed run's file names the phase it
died in).  :func:`trace` runs a block under ``torch.profiler`` and
writes its Chrome trace: the device-level complement of the tracer's
driver spans.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict

# Per-process sequence in the trace file names: two fits in one second
# must not collide.
_SEQ = itertools.count(1)


class PhaseTimer:
    """Accumulate named phase durations.

    >>> t = PhaseTimer()
    >>> with t.phase("cluster"):
    ...     labels = run(...)
    >>> t.as_dict()  # {"cluster_s": 0.123}

    A phase is host time: the spans inside it that must cover device
    work wait on it themselves (``Span.sync_on``).
    """

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        from ..obs import current
        from ..obs.registry import sanitize_segment

        rec = current()
        with rec.span(name) as sp:
            yield self
        # sp.dur_s is set once the span closed.
        self.phases[f"{name}_s"] = (
            self.phases.get(f"{name}_s", 0.0) + sp.dur_s
        )
        rec.metrics.observe(f"phase.{sanitize_segment(name)}", sp.dur_s)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.phases)


@contextlib.contextmanager
def trace(logdir: str):
    """Run the enclosed block under ``torch.profiler`` (CPU activity,
    and CUDA where a card is present) and write its Chrome trace to
    ``logdir/trace-<pid>-<stamp>-<seq>.json`` (loads in chrome://tracing
    and ui.perfetto.dev)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts, record_shapes=False) as prof:
        yield prof
    name = "trace-%d-%s-%d.json" % (
        os.getpid(), time.strftime("%Y%m%d-%H%M%S"), next(_SEQ))
    prof.export_chrome_trace(os.path.join(logdir, name))
