"""Checkpoint-resumable fits: phase-boundary job state (counterpart of
``pypardis_tpu/utils/jobstate.py``; the same file format and schema, so
either package opens the other's snapshots).

A fit that dies (an OOM, a SIGKILL, an injected ``error``) restarts from
its last snapshot instead of from zero: the routes with natural phase
boundaries write their completed work to one atomically rewritten
``.npz``, and ``DBSCAN.train(resume=path)`` replays only what is
missing, to labels byte-identical to an uninterrupted fit.

What is snapshotted, per route:

* **chained route** (:func:`~pypardis_tpu_torch.parallel.sharded_dbscan`):
  each finished partition's global-label and core tables and its pair
  stats; a resume skips those partitions (no slab built, no dispatch)
  and feeds the same tables to the merge;
* **host-stepped route** (:mod:`~pypardis_tpu_torch.ops.pipeline`): the
  propagation state ``f`` after each consumed round batch; min-label
  propagation is monotone toward its unique fixpoint, so resuming from
  any intermediate state of the same pair tables reaches the same
  labels;
* **global-Morton fixpoint** (``gm_note`` / ``gm_restore``): the mesh
  engine's device fixpoint (``parallel/global_morton._gm_fixpoint``)
  notes its ``(N+1,)`` ``lab_map`` after each round at the cadence, and
  a resumed fit starts its rounds from it.

Every payload is keyed by the **pair budget** it was computed under:
tables from a budget that later overflowed are never consumed, a
mismatched budget simply recomputes.  The file carries a **fit
fingerprint** (:func:`fit_meta`: a chunked crc32 of the points' bytes,
eps, min_samples, metric, block, mode); a resume against other data or
parameters raises.

Cadence: ``PPTORCH_CKPT_EVERY_S`` seconds between disk writes (default
0: every phase boundary), read when a :class:`JobState` is made.  Writes
are atomic (a temporary file and ``os.replace``), so a SIGKILL mid-write
leaves the previous consistent snapshot.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

SCHEMA = "pypardis_tpu/jobstate@1"


def _norm_npz(path: str) -> str:
    return path if str(path).endswith(".npz") else f"{path}.npz"


def fit_meta(points, *, eps, min_samples, metric, block, mode) -> Dict:
    """The fit fingerprint a snapshot is bound to (the JAX package's
    dict for the same points and parameters), over the staging cache's
    :func:`~..parallel.staging.points_fingerprint` (imported here: the
    parallel package imports this one)."""
    from ..parallel.staging import points_fingerprint

    fp = list(points_fingerprint(points))
    fp[0] = list(fp[0])  # shape tuple -> list (json round-trip)
    return {
        "schema": SCHEMA,
        "fingerprint": fp,
        "eps": float(eps),
        "min_samples": int(min_samples),
        "metric": str(metric),
        "block": int(block),
        "mode": str(mode),
    }


def discard_stale(path: str, meta: Dict) -> bool:
    """Remove a snapshot written by a DIFFERENT fit; True if removed.

    The resume guard raises on a fingerprint mismatch (right for a
    caller retyping a resume path).  A compaction has the opposite
    contract: a file left by a killed cycle over an older point set
    describes an obsolete generation, so it is discarded and the refit
    starts fresh.  An unreadable (torn) file is discarded the same way."""
    p = _norm_npz(path)
    if not os.path.exists(p):
        return False
    try:
        with np.load(p, allow_pickle=False) as z:
            saved = json.loads(str(z["meta"]))
    except Exception:  # noqa: BLE001 — torn/foreign file: discard
        os.unlink(p)
        return True
    if saved != dict(meta):
        os.unlink(p)
        return True
    return False


class JobState:
    """One resumable fit's snapshot file.

    Route payloads live in memory between flushes; :meth:`due` gates the
    snapshot fetches at the call sites and the disk rewrites here, so
    checkpointing costs nothing faster than the cadence.
    """

    def __init__(self, path: str, meta: Dict,
                 every_s: Optional[float] = None):
        self.path = _norm_npz(path)
        self.meta = dict(meta)
        if every_s is None:
            try:
                every_s = float(os.environ.get("PPTORCH_CKPT_EVERY_S", 0.0))
            except (TypeError, ValueError):
                every_s = 0.0
        self.every_s = max(float(every_s), 0.0)
        # None until the first write: a file never written is always due
        # (``time.monotonic()`` counts from an unspecified start, the
        # host's boot on Linux, so a 0.0 start withheld the first
        # snapshot on a host up for less than ``every_s``).
        self._last_write: Optional[float] = None
        self.restored_partitions = 0
        self.restored_rounds = 0
        # chained: {p: (glab, core, pstats)}, one budget generation.
        self._ch_budget: Optional[int] = None
        self._chained: Dict[int, Tuple] = {}
        # stepped: (f, batches) under a budget.
        self._st_budget: Optional[int] = None
        self._stepped: Optional[Tuple[np.ndarray, int]] = None
        # gm fixpoint: (lab_map, round) under a budget.
        self._gm_budget: Optional[int] = None
        self._gm: Optional[Tuple[np.ndarray, int]] = None

    # -- lifecycle --------------------------------------------------------

    @classmethod
    def open(cls, path: str, meta: Dict, *, resume: bool = False,
             every_s: Optional[float] = None) -> "JobState":
        """Open a job-state file for writing; with ``resume`` and an
        existing file, load its payloads (the fingerprint must match)."""
        js = cls(path, meta, every_s=every_s)
        if resume and os.path.exists(js.path):
            js._load(js.path)
        return js

    def _load(self, p: str) -> None:
        with np.load(p, allow_pickle=False) as z:
            saved_meta = json.loads(str(z["meta"]))
            if saved_meta != self.meta:
                raise ValueError(
                    f"jobstate {p} was written by a different fit "
                    f"(saved {saved_meta}, current {self.meta}); "
                    f"resume only matches identical data and params"
                )
            if "ch_ps" in z.files and len(z["ch_ps"]):
                self._ch_budget = int(z["ch_budget"])
                glab, core, pstats = z["ch_glab"], z["ch_core"], z["ch_pstats"]
                self._chained = {
                    int(p_): (glab[i], core[i], pstats[i])
                    for i, p_ in enumerate(z["ch_ps"])
                }
            if "st_f" in z.files and z["st_f"].size:
                self._st_budget = int(z["st_budget"])
                self._stepped = (z["st_f"], int(z["st_batches"]))
            if "gm_lab" in z.files and z["gm_lab"].size:
                self._gm_budget = int(z["gm_budget"])
                self._gm = (z["gm_lab"], int(z["gm_round"]))

    def due(self) -> bool:
        """Whether the cadence allows another snapshot now: always before
        the first write, then ``every_s`` after the last one."""
        if self._last_write is None:
            return True
        return time.monotonic() - self._last_write >= self.every_s

    def flush(self, force: bool = False) -> None:
        if not force and not self.due():
            return
        payload: Dict = {"meta": json.dumps(self.meta)}
        if self._chained:
            ps = sorted(self._chained)
            payload.update(
                ch_budget=np.int64(self._ch_budget or 0),
                ch_ps=np.asarray(ps, np.int64),
                ch_glab=np.stack(
                    [np.asarray(self._chained[p][0], np.int32) for p in ps]
                ),
                ch_core=np.stack(
                    [np.asarray(self._chained[p][1], bool) for p in ps]
                ),
                ch_pstats=np.stack(
                    [np.asarray(self._chained[p][2], np.int64) for p in ps]
                ),
            )
        if self._stepped is not None:
            payload.update(
                st_budget=np.int64(self._st_budget or 0),
                st_f=np.asarray(self._stepped[0], np.int32),
                st_batches=np.int64(self._stepped[1]),
            )
        if self._gm is not None:
            payload.update(
                gm_budget=np.int64(self._gm_budget or 0),
                gm_lab=np.asarray(self._gm[0], np.int32),
                gm_round=np.int64(self._gm[1]),
            )
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, self.path)
        self._last_write = time.monotonic()

    # -- chained route ----------------------------------------------------

    def chained_restore(self, budget: int) -> Dict[int, Tuple]:
        """{partition -> (glab, core, pstats)} valid under ``budget``
        ({} on a budget mismatch: those tables are never reused)."""
        if self._ch_budget != int(budget) or not self._chained:
            return {}
        self.restored_partitions = len(self._chained)
        return dict(self._chained)

    def chained_note(self, p: int, glab, core, pstats,
                     budget: int) -> None:
        if self._ch_budget != int(budget):
            self._ch_budget = int(budget)
            self._chained = {}
        self._chained[int(p)] = (
            np.asarray(glab, np.int32),
            np.asarray(core, bool),
            np.asarray(pstats, np.int64).reshape(-1),
        )
        self.flush()

    # -- stepped route ----------------------------------------------------

    def stepped_restore(self, budget: int, capk: int
                        ) -> Optional[Tuple[np.ndarray, int]]:
        if (
            self._stepped is None or self._st_budget != int(budget)
            or len(self._stepped[0]) != int(capk)
        ):
            return None
        self.restored_rounds = int(self._stepped[1])
        return self._stepped

    def stepped_note(self, f: np.ndarray, batches: int,
                     budget: int) -> None:
        self._st_budget = int(budget)
        self._stepped = (np.asarray(f, np.int32), int(batches))
        self.flush()

    # -- global-Morton fixpoint -------------------------------------------

    def gm_restore(self, budget: int, n1: int
                   ) -> Optional[Tuple[np.ndarray, int]]:
        if (
            self._gm is None or self._gm_budget != int(budget)
            or len(self._gm[0]) != int(n1)
        ):
            return None
        self.restored_rounds = int(self._gm[1])
        return self._gm

    def gm_note(self, lab_map: np.ndarray, rounds: int,
                budget: int) -> None:
        self._gm_budget = int(budget)
        self._gm = (np.asarray(lab_map, np.int32), int(rounds))
        self.flush()
