"""Bounded cache of sufficient live tile-pair budgets (counterpart of
``pypardis_tpu/utils/hints.py``).

The pair extraction runs against a budget; a dataset dense enough to
defeat the default one pays an extract, an overflow and a rerun on its
first fit.  This cache remembers the exact budget that sufficed, keyed
by the fit's configuration (shape, block, precision, eps, metric, the
sketch's k), so later fits of that configuration extract once.

Entries are written only after an observed overflow: a fit whose
default budget was fine seeds nothing (in the JAX package a seeded hint
is a new static shape and recompiles; here it would only change the
reported budget, and the two packages keep one policy).  The cache is
LRU-bounded, so a process sweeping many configurations does not grow a
dict without end.
"""

from __future__ import annotations

from typing import Hashable, Optional


class BudgetHintCache:
    """Insertion-ordered dict with LRU eviction past ``maxsize``."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self._d: dict = {}

    def get(self, key: Hashable) -> Optional[int]:
        val = self._d.pop(key, None)
        if val is not None:
            self._d[key] = val  # refresh recency
        return val

    def put(self, key: Hashable, value: int) -> None:
        self._d.pop(key, None)
        self._d[key] = int(value)
        while len(self._d) > self.maxsize:
            self._d.pop(next(iter(self._d)))

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d


def dispatch_tag(nt: int | None = None) -> str:
    """Hint-key component naming the kernels' dispatch mode.  The JAX
    package sizes budgets against a dense grid or a compacted pair list
    and keys them apart; the port's kernels always run over the
    compacted list, so the tag is always ``"pair"`` (``nt``, the JAX
    signature's tile-count estimate, changes nothing)."""
    return "pair"


# One shared instance: the single-card driver (dbscan._pad_and_run) and
# the chained route (parallel.sharded.sharded_dbscan) key their entries
# differently, so they coexist without collisions.
PAIR_BUDGET_HINTS = BudgetHintCache()
