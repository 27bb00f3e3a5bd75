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


def _metric_name(metric) -> str:
    """A metric spec's lower-case name (a scipy-style callable by its
    ``__name__``)."""
    if callable(metric):
        metric = getattr(metric, "__name__", str(metric))
    return str(metric).lower()


def norm_metric(metric) -> str:
    """The kernel metrics' normalizer (``ops/distances._norm_metric`` of
    the JAX package): Euclidean and cityblock spellings, scipy callables
    by name.  The driver metrics (cosine, haversine) never reach the
    kernels and raise here, as anything else does."""
    metric = _metric_name(metric)
    if metric in ("euclidean", "l2"):
        return "euclidean"
    if metric == "sqeuclidean":
        raise ValueError(
            "metric 'sqeuclidean' is not supported: its eps thresholds "
            "squared distance; use metric='euclidean' with eps=sqrt(eps)"
        )
    if metric in ("cityblock", "manhattan", "l1"):
        return "cityblock"
    if metric in ("cosine", "angular"):
        raise ValueError(
            "metric 'cosine' is served at the driver level (unit-"
            "normalization + eps remap: use DBSCAN(metric='cosine')); "
            "the pair passes are euclidean/cityblock only"
        )
    raise ValueError(
        f"unsupported metric {metric!r}: the GPU package supports "
        f"euclidean, cityblock, cosine and haversine"
    )


def _concrete(eps) -> bool:
    return isinstance(eps, (int, float, np.floating)) and np.isfinite(eps)


def check_metric(metric, eps=None) -> str:
    """Normalize a metric spec (string or scipy-style callable, by
    name) and check ``eps`` against its range.

    The kernel metrics are Euclidean and cityblock.  Cosine
    (``"angular"``) and haversine are driver metrics: the fit projects
    the rows (unit norm; (lat, lon) radians onto the unit sphere) and
    remaps eps onto the L2 kernels.  Cosine's eps thresholds ``1 -
    cos`` and lies in (0, 2]; haversine's is the great-circle angle in
    radians, in (0, pi]."""
    name = _metric_name(metric)
    if name == "haversine":
        if _concrete(eps) and not 0 < eps <= np.pi:
            raise ValueError(
                f"metric='haversine' thresholds the great-circle "
                f"angle in RADIANS, which lies in [0, pi]; eps must "
                f"be in (0, pi], got {eps} (degrees instead of "
                f"radians?)"
            )
        return "haversine"
    if name in ("cosine", "angular"):
        if _concrete(eps) and not 0 < eps <= 2:
            raise ValueError(
                f"metric='cosine' thresholds the cosine distance "
                f"1 - cos(theta), which lies in [0, 2]; eps must be in "
                f"(0, 2], got {eps}"
            )
        return "cosine"
    return norm_metric(name)


def validate_params(eps, min_samples, allow_none_eps: bool = False) -> None:
    """Raise ValueError on an invalid (eps, min_samples).

    ``eps=None`` (the density hierarchy, which selects eps by stability
    and exposes it as ``eps_``) is legal only where ``allow_none_eps``:
    the ``DBSCAN`` constructor.  Every call site downstream of a fit
    needs a concrete radius, and a concrete ``eps <= 0`` or non-finite
    one fails either way."""
    if isinstance(min_samples, (int, np.integer)) and min_samples < 1:
        raise ValueError(f"min_samples must be >= 1, got {min_samples}")
    if eps is None:
        if allow_none_eps:
            return
        raise ValueError(
            "eps=None is only legal at construction/fit time (the "
            "density-hierarchy path selects eps by stability); this "
            "call site needs a concrete positive radius"
        )
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
