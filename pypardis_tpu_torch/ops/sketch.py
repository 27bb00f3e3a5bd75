"""Random-projection sketch prefilter for high-d fits (counterpart of
``pypardis_tpu/ops/sketch.py``, whose numpy parts it keeps as copies).

At d >= 128 full-d tile boxes stop pruning and the exact pair passes
pay ``3d`` operations for every pair of a live tile.  A seeded k-dim
projection gives every pair a certified bracket of its d^2:

* ``s(x) = Q^T x`` (k rows) and ``r(x) = sqrt(|x|^2 - |s(x)|^2)`` (one
  more row) form the ``(k+1, N)`` slab;
* ``t2 = |slab(x) - slab(y)|^2`` is a lower bound of ``|x - y|^2`` and
  ``t2 + 4 r(x) r(y)`` an upper bound, both within the scalar
  ``band`` of :func:`sketch_gate_band`, which covers the float32 Q's
  orthonormality defect and every rounding of the slab and of the
  exact pass.

So ``t2 - band > eps^2`` is certainly out, ``t2 + 4 rx ry <= eps^2 -
band`` certainly in, and only the pairs between are rescored with the
exact pass's own arithmetic: counts and labels are byte-identical to
the unsketched fit for any k.  The same slab boxes, at the widened
gate ``sqrt(eps^2 + band)``, build the live tile-pair list.

Q is drawn and orthonormalised in numpy exactly as the JAX package
draws it, so both packages project with the same float32 matrix.  The
knobs read ``PPTORCH_SKETCH`` (the default spec, ``"auto"``),
``PPTORCH_SKETCH_SEED`` and ``PPTORCH_SKETCH_MIN_D``.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from .precision import _BAND_SAFETY, band_halfwidth

# k never exceeds this many sketch dimensions, and never drops below
# this many (the JAX package's limits).
SKETCH_MAX_K = 256
SKETCH_MIN_K = 16


def sketch_seed() -> int:
    """The projection seed (``PPTORCH_SKETCH_SEED``, default 1299721)."""
    return int(os.environ.get("PPTORCH_SKETCH_SEED", "1299721"))


def sketch_min_d() -> int:
    """Dimensionality below which ``"auto"`` resolves to off
    (``PPTORCH_SKETCH_MIN_D``, default 128)."""
    return int(os.environ.get("PPTORCH_SKETCH_MIN_D", "128"))


def auto_k(d: int) -> int:
    """The ``"auto"`` sketch width: ``d // 4`` clamped to
    [SKETCH_MIN_K, SKETCH_MAX_K]."""
    return max(SKETCH_MIN_K, min(SKETCH_MAX_K, int(d) // 4))


def check_sketch_spec(spec):
    """Normalise a ``sketch=`` spec: ``None`` (defer to
    ``PPTORCH_SKETCH``), ``"auto"``, ``"off"``/``0``, or an integer
    k >= 0.  Returns ``None``, ``"auto"`` or an int; raises ValueError
    on anything else."""
    if spec is None:
        return None
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s == "auto":
            return "auto"
        if s in ("off", ""):
            return 0
        try:
            spec = int(s)
        except ValueError:
            raise ValueError(
                f"sketch must be 'auto', 'off', or an integer k >= 0, "
                f"got {spec!r}"
            ) from None
    if isinstance(spec, (bool, float)) or not isinstance(
        spec, (int, np.integer)
    ):
        raise ValueError(
            f"sketch must be 'auto', 'off', or an integer k >= 0, "
            f"got {spec!r}"
        )
    if int(spec) < 0:
        raise ValueError(f"sketch k must be >= 0, got {spec}")
    return int(spec)


def resolve_sketch(spec, d: int, metric: str = "euclidean") -> int:
    """The effective sketch width for a fit (0 = off).  Euclidean only;
    ``"auto"``/``None`` is off below :func:`sketch_min_d` and
    :func:`auto_k` above it; an explicit k is clamped to ``d // 2``
    (the residual split degenerates at k = d)."""
    if str(metric) != "euclidean":
        return 0
    spec = check_sketch_spec(spec)
    d = int(d)
    if spec == "auto" or spec is None:
        if d < sketch_min_d():
            return 0
        k = auto_k(d)
    else:
        k = int(spec)
    if k <= 0:
        return 0
    return max(1, min(k, d // 2))


def sketch_dims(d: int, metric: str = "euclidean") -> int:
    """Resolve ``PPTORCH_SKETCH`` (default ``"auto"``) for dimensionality
    ``d``; read at every call."""
    return resolve_sketch(
        os.environ.get("PPTORCH_SKETCH", "auto"), d, metric
    )


def effective_k(spec, d: int) -> int:
    """The k a fit runs for a ``sketch=`` spec: ``None`` reads
    ``PPTORCH_SKETCH`` (:func:`sketch_dims`), anything else is pinned
    (:func:`resolve_sketch`)."""
    if spec is None:
        return sketch_dims(d)
    return resolve_sketch(spec, d)


@functools.lru_cache(maxsize=32)
def _sketch_matrix(d: int, k: int, seed: int):
    """``(Q, eta)`` for one ``(d, k, seed)``: an Achlioptas sparse
    {+1, 0, -1} draw (probabilities 1/6, 2/3, 1/6) from
    ``SeedSequence([seed, d, k])``, orthonormalised by a float64 QR and
    rounded to a (d, k) float32 Q; ``eta = |Q^T Q - I|_F`` in float64,
    the defect :func:`sketch_gate_band` covers."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed), int(d), int(k)])
    )
    g = rng.choice(
        np.array([-1.0, 0.0, 1.0]), size=(d, k), p=[1 / 6, 2 / 3, 1 / 6]
    )
    # A rank-deficient draw (tiny d only) gets a dense Gaussian nudge.
    while np.linalg.matrix_rank(g) < k:  # pragma: no cover - tiny-d only
        g = g + 1e-3 * rng.standard_normal((d, k))
    q64, _ = np.linalg.qr(g.astype(np.float64))
    q = np.ascontiguousarray(q64[:, :k], dtype=np.float32)
    gram = q.astype(np.float64).T @ q.astype(np.float64)
    eta = float(np.linalg.norm(gram - np.eye(k), "fro"))
    return q, eta


def sketch_matrix(d: int, k: int, seed=None):
    """The cached ``(Q, eta)`` pair; ``seed=None`` reads the knob."""
    if seed is None:
        seed = sketch_seed()
    return _sketch_matrix(int(d), int(k), int(seed))


def jl_band(k: int, delta: float = 0.01) -> float:
    """Predictive JL distortion halfwidth relative to d^2,
    ``sqrt(8 ln(1/delta) / k)`` (Achlioptas).  Telemetry only: the
    kernels' gate is the certified :func:`sketch_gate_band`."""
    k = max(int(k), 1)
    delta = min(max(float(delta), 1e-12), 0.5)
    return float(np.sqrt(8.0 * np.log(1.0 / delta) / k))


def sketch_gate_band(nmax, d: int, k: int, eta: float,
                     precision: str = "high"):
    """Certified halfwidth of the sketch gate at the masked maximum
    column norm ``nmax``, as a ``np.float32``.

    It brackets ``|d2_exact - t2|`` beyond the residual spread: twice
    the exact pass's slack, the length-d float32 accumulation and the
    ``Q^T x`` rounding terms, and the ``4 eta (2 nmax)^2`` defect term,
    times ``_BAND_SAFETY``; ``precision="default"`` adds the bf16
    :func:`band_halfwidth` (the JAX package's lossy fast dot,
    ``fast_exact=False``).  Every operation is the JAX package's, in
    its order and in float32 (a Python constant is rounded to float32
    before it meets a float32 value), so the band, the gate and the
    pair list come out bit for bit as the JAX ones.
    """
    f32 = np.float32
    nmax = f32(nmax)
    s = f32(2.0) * nmax
    s2 = s * s
    acc = f32(2.0 ** -24) * s2
    # exact_slack(nmax, nmax) with its constant in float32.
    sn = nmax + nmax
    slack = f32(2.0 ** -16) * sn * sn
    band = (
        f32(2.0) * slack
        + f32(2.0 * float(d)) * acc
        + f32(2.0 * float(np.sqrt(max(int(k), 1))) * float(d)) * acc
        + f32(4.0 * float(eta)) * s2
    )
    if str(precision) == "default":
        band = band + f32(band_halfwidth(nmax, nmax))
    return f32(_BAND_SAFETY) * band
