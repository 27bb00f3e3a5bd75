"""Pair-budget rerun ladder (counterpart of ``pypardis_tpu/utils/budget.py``).

The live tile-pair list is extracted against a budget; overflow comes
back in-band as ``[total, budget]`` and labels built from a truncated
list are INVALID.  The ladder reruns once with the exact total (rounded
up to 4096) and raises if overflow persists — it never returns labels
from a truncated list.  The sharded route's :func:`run_ladders` adds the
merge-rounds rung.  The JAX package's hint cache and its
``PYPARDIS_PAIR_BUDGET`` knob are not ported yet (ROADMAP A16).
"""

from __future__ import annotations

import logging

from .shaping import round_up


def pair_overflow(total: int, budget: int) -> int:
    """Exact budget to rerun with, or 0 when nothing overflowed."""
    if budget and total > budget:
        logging.getLogger("pypardis_tpu_torch").warning(
            "live tile-pair budget overflow (%d > %d); rerunning with an "
            "exact budget", total, budget,
        )
        return round_up(total, 4096)
    return 0


def run_pair_ladder(run_step, pair_budget=None):
    """Drive ``run_step(pair_budget) -> (outputs, total, budget)``
    through the overflow ladder (:func:`run_ladders` without a merge);
    returns the successful ``outputs``."""
    def step(pb, _rounds):
        outputs, total, budget = run_step(pb)
        return outputs, (total, budget), True

    return run_ladders(step, pair_budget, 0)


def unconverged_error(merge_rounds: int) -> RuntimeError:
    return RuntimeError(
        f"cross-partition label merge did not converge within "
        f"{merge_rounds} rounds — the result would be under-merged "
        f"(a cluster chain threading more partitions than the rounds "
        f"covered would come back split); raise merge_rounds"
    )


def run_ladders(run_step, pair_budget, merge_rounds):
    """Drive ``run_step(pair_budget, merge_rounds) -> (outputs, (total,
    budget), converged)`` through the pair-budget rung (one rerun at the
    exact total; a persisting overflow raises) and the merge-rounds rung
    (one retry at 4x the rounds on non-convergence, then
    :func:`unconverged_error`).  Returns the successful ``outputs``."""
    this_pair, this_rounds = pair_budget, merge_rounds
    pair_retried = rounds_retried = False
    while True:
        outputs, (total, budget), converged = run_step(
            this_pair, this_rounds)
        retry = pair_overflow(total, budget)
        if retry:
            if pair_retried:
                raise RuntimeError(
                    f"live tile-pair budget overflow persisted after an "
                    f"exact-total retry: the kernels need at least "
                    f"{retry} live tile pairs; labels from a truncated "
                    f"pair list would be silently wrong, so this never "
                    f"returns"
                )
            pair_retried, this_pair = True, retry
            continue
        if not converged:
            if rounds_retried:
                raise unconverged_error(this_rounds)
            nxt = max(1, 4 * this_rounds)
            logging.getLogger("pypardis_tpu_torch").warning(
                "label merge unconverged after %d rounds; retrying with "
                "%d", this_rounds, nxt,
            )
            rounds_retried, this_rounds = True, nxt
            continue
        return outputs
