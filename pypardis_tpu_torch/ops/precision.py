"""Kernel precision modes (counterpart of ``pypardis_tpu/ops/precision.py``).

The accepted surface is the JAX package's mode ladder, so a config
written for one package validates the same way in the other.  What each
mode means on the card:

``"high"`` / ``"highest"``
    Exact FP32: d^2 is the axis-ordered sum of ``(x_a - y_a)^2``, each
    operation rounded on its own (the TPU's ``"high"`` is a bf16_3x
    emulation of FP32).
``"mixed"``
    One bf16 tensor-core pass (``mma.sync`` m16n8k16, FP32
    accumulators) over operands recentred on the row tile's box centre
    and rounded to bf16 once gives ``d2f = |x-c|^2 + |y-c|^2 - 2
    (x-c).(y-c)``, the squared norms in FP32.  Every pair whose ``d2f``
    lies within :func:`band_halfwidth` (at the recentred norm maxima)
    plus :func:`exact_slack` (at the frame norms) of eps^2 is rescored
    with the exact FP32 arithmetic of ``"high"``, pair by pair, so
    counts, labels and core masks are byte-identical to ``"high"``.  In
    serving, the same bf16 pass lower-bounds every (query, core) d^2 of
    a column chunk, and only chunks that may hold a core within eps run
    the exact query pass.
``"default"``
    The one bf16 pass decides every pair (``d2f <= eps^2``): lossy by
    design, as on the TPU; no rescore.  With the sketch on, the in-band
    pairs of the slab gate are decided by the same bf16 pass.
"""

from __future__ import annotations

PRECISION_MODES = ("default", "high", "highest", "mixed")

# bf16 has 8 explicit mantissa bits: a product of two rounded operands
# carries <= ~2^-8 relative error per term.
BF16_EPS = 2.0 ** -8

# Safety margin on the analytic bounds (band_halfwidth and the sketch
# gate's band), the JAX package's value.
_BAND_SAFETY = 1.25

# Width of the pair-stats row every fit emits:
# [live_pairs_total, budget, kernel_passes, band_pairs, rescored_tiles].
# The last two are the counts pass's telemetry: the sketch gate's with
# the sketch on, else the bf16 band's under "mixed", else zero.
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
