"""Pair-budget and merge-rounds rerun ladders (counterpart of
``pypardis_tpu/utils/budget.py``).

The live tile-pair list is extracted against a budget; overflow comes
back in-band as ``[total, budget]`` and labels built from a truncated
list are INVALID.  Every driver (the single card's ``_pad_and_run``, the
chained route) runs the same ladder: consult the hint cache
(:mod:`.hints`) or ``PPTORCH_PAIR_BUDGET``, rerun once with the exact
total (rounded up to 4096), raise if overflow persists (never return
labels from a truncated list), and seed the hint only after an observed
overflow.  The chained route adds the merge-rounds rung.  Each rung's
retry and giveup count in ``report()["faults"]``, as in the JAX package.
"""

from __future__ import annotations

import os

from ..obs import event as obs_event
from .hints import PAIR_BUDGET_HINTS
from .log import get_logger
from .retry import note_giveup, note_retry
from .shaping import round_up


def pair_overflow(total: int, budget: int) -> int:
    """Exact budget to rerun with, or 0 when nothing overflowed (an
    overflow records a ``pair_overflow`` event)."""
    if budget and total > budget:
        obs_event("pair_overflow", total=int(total), budget=int(budget))
        get_logger().warning(
            "live tile-pair budget overflow (%d > %d); rerunning with an "
            "exact budget", total, budget,
        )
        return round_up(total, 4096)
    return 0


def seed_hint(key, total: int) -> None:
    """Remember the exact budget that sufficed after an observed
    overflow (seed-on-overflow only, see :mod:`.hints`)."""
    if key is not None and int(total) > 0:
        PAIR_BUDGET_HINTS.put(key, round_up(int(total), 4096))


def run_pair_ladder(run_step, pair_budget=None, hint_key=None):
    """Drive ``run_step(pair_budget) -> (outputs, total, budget)``
    through the overflow ladder (:func:`run_ladders` without a merge);
    returns the successful ``outputs``."""
    def step(pb, _rounds):
        outputs, total, budget = run_step(pb)
        return outputs, (total, budget), True

    return run_ladders(step, hint_key, pair_budget, 0)


def unconverged_error(merge_rounds: int) -> RuntimeError:
    return RuntimeError(
        f"cross-partition label merge did not converge within "
        f"{merge_rounds} rounds — the result would be under-merged "
        f"(a cluster chain threading more partitions than the rounds "
        f"covered would come back split); raise merge_rounds"
    )


def run_ladders(run_step, hint_key, pair_budget, merge_rounds):
    """Drive ``run_step(pair_budget, merge_rounds) -> (outputs, (total,
    budget), converged)`` through the pair-budget rung and the
    merge-rounds rung.

    In order: the budget is ``pair_budget``, else ``PPTORCH_PAIR_BUDGET``
    (read per call), else the hint under ``hint_key`` (None: no hint);
    one rerun at the exact total on overflow (a persisting overflow
    raises, naming the knob); the hint seeded after an observed
    overflow; one retry at 4x the rounds on non-convergence, then
    :func:`unconverged_error`.  Returns the successful ``outputs``."""
    this_pair = pair_budget
    if this_pair is None:
        env = os.environ.get("PPTORCH_PAIR_BUDGET")
        if env:
            this_pair = int(env)
    this_rounds = merge_rounds
    pair_retried = rounds_retried = overflowed = False
    while True:
        use_pair = this_pair
        if use_pair is None and hint_key is not None:
            use_pair = PAIR_BUDGET_HINTS.get(hint_key)
        outputs, (total, budget), converged = run_step(use_pair,
                                                       this_rounds)
        retry = pair_overflow(total, budget)
        if retry:
            if pair_retried:
                err = RuntimeError(
                    f"live tile-pair budget overflow persisted after an "
                    f"exact-total retry: the kernels need at least "
                    f"{retry} live tile pairs; pass pair_budget={retry} "
                    f"(or set PPTORCH_PAIR_BUDGET={retry}) — labels from "
                    f"a truncated pair list would be silently wrong, so "
                    f"this never returns"
                )
                note_giveup("pair_budget", err)
                raise err
            note_retry("pair_budget", 0.0,
                       RuntimeError(f"pair budget overflow, need {retry}"))
            pair_retried = overflowed = True
            this_pair = retry
            continue
        if not converged:
            if rounds_retried:
                err = unconverged_error(this_rounds)
                note_giveup("merge_rounds", err)
                raise err
            nxt = max(1, 4 * this_rounds)
            obs_event("merge_unconverged", rounds=this_rounds, next=nxt)
            note_retry("merge_rounds", 0.0,
                       RuntimeError(f"unconverged at {this_rounds} rounds"))
            get_logger().warning(
                "label merge unconverged after %d rounds; retrying with "
                "%d", this_rounds, nxt,
            )
            rounds_retried, this_rounds = True, nxt
            continue
        if overflowed:
            seed_hint(hint_key, total)
        return outputs
