"""Input validation (counterpart of ``pypardis_tpu/utils/validate.py``).

The sklearn-inherited contract: bad hyperparameters and non-finite
coordinates raise ``ValueError`` loudly instead of coming back as
silently wrong labels (the kernels compare SQUARED distances, so a
negative eps would otherwise behave like its absolute value).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.precision import norm_precision_mode

KERNEL_BACKENDS = ("auto", "cuda", "torch")

# Metrics the JAX package serves that this slice has not ported yet,
# with the ROADMAP item that ports each.
_UNPORTED_METRICS = {
    "cityblock": "A3",
    "cosine": "A6",
    "haversine": "A6",
}


def check_query_points(points, k=None) -> np.ndarray:
    """Validate out-of-sample query points (or points routed through a
    split tree): a 2-D array, ``k`` columns when given, finite.  A wrong
    width would route through split axes that mean something else, and
    a NaN fails every ``>=`` and slides down the tree's left spine.
    Returns the array as numpy; raises ValueError otherwise."""
    points = np.asarray(points)
    if points.ndim != 2:
        raise ValueError(
            f"query points must be a 2-D (N, k) array, got shape "
            f"{points.shape}"
        )
    if k is not None and points.shape[1] != int(k):
        raise ValueError(
            f"query dimensionality {points.shape[1]} does not match the "
            f"fitted tree's k={int(k)}"
        )
    if points.dtype.kind in "fc" and not np.isfinite(points).all():
        raise ValueError("query points contain NaN or infinite coordinates")
    return points


def check_precision(precision) -> str:
    """Validate a precision spec; returns the canonical mode."""
    return norm_precision_mode(precision)


def check_kernel_backend(backend) -> str:
    """Validate a kernel backend spec (``auto``/``cuda``/``torch``)."""
    b = str(backend).lower()
    if b not in KERNEL_BACKENDS:
        raise ValueError(
            f"kernel_backend must be one of {KERNEL_BACKENDS}, got "
            f"{backend!r}"
        )
    return b


def check_metric(metric) -> str:
    """Normalize a metric spec (string or scipy-style callable, by
    name).  Euclidean is the ported metric; the JAX package's other
    metrics raise ``NotImplementedError`` naming their ROADMAP item, and
    anything else raises ``ValueError``."""
    name = metric
    if callable(metric):
        name = getattr(metric, "__name__", str(metric))
    name = str(name).lower()
    if name in ("euclidean", "l2"):
        return "euclidean"
    if name == "sqeuclidean":
        raise ValueError(
            "metric 'sqeuclidean' is not supported: its eps thresholds "
            "squared distance; use metric='euclidean' with eps=sqrt(eps)"
        )
    canon = {
        "manhattan": "cityblock", "l1": "cityblock", "angular": "cosine",
    }.get(name, name)
    if canon in _UNPORTED_METRICS:
        raise NotImplementedError(
            f"metric {canon!r} is not ported to the GPU package yet "
            f"(ROADMAP {_UNPORTED_METRICS[canon]}); use 'euclidean'"
        )
    raise ValueError(
        f"unsupported metric {metric!r}: the GPU package supports "
        f"'euclidean'"
    )


def validate_params(eps, min_samples) -> None:
    """Raise ValueError on an invalid (eps, min_samples)."""
    if isinstance(min_samples, (int, np.integer)) and min_samples < 1:
        raise ValueError(f"min_samples must be >= 1, got {min_samples}")
    if eps is None:
        raise ValueError("eps must be a positive finite radius, got None")
    if not np.isfinite(float(eps)) or float(eps) <= 0:
        raise ValueError(f"eps must be positive and finite, got {eps}")


def check_finite(points) -> None:
    """Raise ValueError on NaN/inf coordinates (numpy or torch input;
    a tensor reduces on its own device and fetches one bool)."""
    if isinstance(points, torch.Tensor):
        if points.is_floating_point() and not bool(
            torch.isfinite(points).all()
        ):
            raise ValueError("input contains NaN or infinite coordinates")
        return
    points = np.asarray(points)
    if points.dtype.kind not in "fc":
        return
    chunk = 1 << 20
    for s in range(0, len(points), chunk):
        if not np.isfinite(points[s:s + chunk]).all():
            raise ValueError("input contains NaN or infinite coordinates")
