"""Host-side helpers: validation, shape arithmetic, the pair-budget
ladder and its hint cache, fault injection (:mod:`.faults`), the retry
layer (:mod:`.retry`) and checkpoint-resumable job state
(:mod:`.jobstate`)."""

from . import faults, jobstate, retry
from .faults import FaultInjected, FaultPlan
from .jobstate import JobState, fit_meta
from .retry import Retrier
from .shaping import clamp_block, round_up
from .validate import validate_params

__all__ = [
    "round_up", "clamp_block", "validate_params", "faults", "retry",
    "jobstate", "FaultInjected", "FaultPlan", "Retrier", "JobState",
    "fit_meta",
]
