"""Kernel precision modes (counterpart of ``pypardis_tpu/ops/precision.py``).

The accepted surface is the JAX package's mode ladder, so a config
written for one package validates the same way in the other.  On the
card ``"high"`` and ``"highest"`` both run exact FP32 (the TPU's
``"high"`` is a bf16_3x emulation of FP32); ``"default"`` and
``"mixed"`` are accepted names whose Hopper kernels are not written yet
(ROADMAP A9, the precision slice) and raise ``NotImplementedError`` at
fit time.  The bf16 band constants live here all the same: the sketch
gate's ``"default"`` branch (:mod:`.sketch`) is written against them.
"""

from __future__ import annotations

PRECISION_MODES = ("default", "high", "highest", "mixed")

# Modes the port's kernels run today.
PORTED_MODES = ("high", "highest")

# bf16 has 8 explicit mantissa bits: a product of two rounded operands
# carries <= ~2^-8 relative error per term.
BF16_EPS = 2.0 ** -8

# Safety margin on the analytic bounds (band_halfwidth and the sketch
# gate's band), the JAX package's value.
_BAND_SAFETY = 1.25

# Width of the pair-stats row every fit emits:
# [live_pairs_total, budget, kernel_passes, band_pairs, rescored_tiles].
# The last two are the sketch gate's counts-pass telemetry (zero with
# the sketch off).
PAIR_STATS_WIDTH = 5


def norm_precision_mode(precision) -> str:
    """Normalize a precision spelling (any case) to a canonical mode;
    raises ValueError naming the accepted modes otherwise."""
    p = str(precision).lower()
    if p not in PRECISION_MODES:
        raise ValueError(
            f"precision must be one of {PRECISION_MODES}, got {precision!r}"
        )
    return p


def require_ported(mode: str) -> str:
    """Raise ``NotImplementedError`` for a mode without a Hopper kernel."""
    if mode not in PORTED_MODES:
        raise NotImplementedError(
            f"precision={mode!r} has no Hopper kernel yet (ROADMAP A9, "
            f"the precision modes: the next slice of the port); use "
            f"'high' or 'highest', which both run exact FP32 on the card, "
            f"with or without the sketch"
        )
    return mode


def band_halfwidth(nx, ny):
    """Bound on ``|d2_fast - d2_true|`` of one bf16 pass at operand norm
    bounds ``nx``/``ny``: ``1.25 * (2^-7 nx ny + 2^-9 (nx^2 + ny^2))``
    (the JAX package's derivation: bf16 operand rounding of the cross
    term under Cauchy-Schwarz, plus the rounded squared-norm rows)."""
    return _BAND_SAFETY * (
        2.0 * BF16_EPS * nx * ny
        + 0.5 * BF16_EPS * (nx * nx + ny * ny)
    )


def exact_slack(nx, ny):
    """Error bound of an exact FP32 distance pass at frame norms
    ``nx``/``ny``: ``2^-16 * (nx + ny)^2``.  A pair whose d^2 lies
    within this of eps^2 may legitimately get a different verdict from
    two exact FP32 formulations (e.g. the TPU's augmented matmul and the
    port's axis-ordered sum)."""
    s = nx + ny
    return (2.0 ** -16) * s * s
