"""Axis-aligned bounding boxes and the haversine frame (counterpart of
``pypardis_tpu/geometry.py``).

Host-side numpy, re-typed so the port imports nothing of the JAX
package.  ``all_space`` and empty boxes use +-inf (the reference's
``sys.float_info.min`` sign bug stays fixed).
"""

from __future__ import annotations

import numpy as np


class BoundingBox:
    """An axis-aligned box in k dimensions: inclusive ``contains``,
    ``split`` children sharing the boundary plane, additive or
    proportional ``expand``."""

    __slots__ = ("lower", "upper")

    def __init__(self, lower=None, upper=None, k=None, all_space=False):
        if lower is not None:
            self.lower = np.asarray(lower, dtype=np.float64)
            self.upper = (
                np.asarray(upper, dtype=np.float64)
                if upper is not None
                else self.lower.copy()
            )
        elif k is not None:
            if all_space:
                self.lower = np.full(k, -np.inf)
                self.upper = np.full(k, np.inf)
            else:
                # Empty box: union with anything yields the other operand.
                self.lower = np.full(k, np.inf)
                self.upper = np.full(k, -np.inf)
        else:
            self.lower = None
            self.upper = None

    @property
    def k(self) -> int:
        return len(self.lower)

    def intersection(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(
            lower=np.maximum(self.lower, other.lower),
            upper=np.minimum(self.upper, other.upper),
        )

    def union(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(
            lower=np.minimum(self.lower, other.lower),
            upper=np.maximum(self.upper, other.upper),
        )

    def split(self, dim: int, value: float):
        """Split along ``dim`` at ``value`` -> (left, right); both
        children include the split plane."""
        left = BoundingBox(lower=self.lower.copy(), upper=self.upper.copy())
        left.upper[dim] = value
        right = BoundingBox(lower=self.lower.copy(), upper=self.upper.copy())
        right.lower[dim] = value
        return left, right

    def expand(self, eps=0, how: str = "add") -> "BoundingBox":
        if how == "add":
            return BoundingBox(self.lower - eps, self.upper + eps)
        elif how == "multiply":
            span = self.upper - self.lower
            return BoundingBox(
                self.lower - eps * span, self.upper + eps * span
            )
        raise ValueError(f"how must be 'add' or 'multiply', got {how!r}")

    def contains(self, vector) -> bool:
        vector = np.asarray(vector)
        return bool(
            np.all(self.lower <= vector) and np.all(self.upper >= vector)
        )

    def contains_points(self, points: np.ndarray) -> np.ndarray:
        """Vectorized containment: (N, k) points -> (N,) bool mask."""
        points = np.asarray(points)
        return np.all(
            (points >= self.lower) & (points <= self.upper), axis=-1
        )

    def volume(self) -> float:
        return float(np.prod(np.maximum(self.upper - self.lower, 0.0)))

    def __eq__(self, other):
        if not isinstance(other, BoundingBox):
            return NotImplemented
        return np.array_equal(self.lower, other.lower) and np.array_equal(
            self.upper, other.upper
        )

    def __repr__(self):
        return f"BoundingBox(lower={self.lower}\n\tupper={self.upper})"


class BoxStack:
    """P bounding boxes as two (P, k) float64 arrays: the partition boxes
    of a sharded fit in one piece (``KDPartitioner.box_stack``).  The
    2*eps-widened stack (:meth:`expand`) frames the shard layout's halo
    boxes in the JAX package's arithmetic, bit for bit."""

    __slots__ = ("lower", "upper")

    def __init__(self, lower, upper):
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        if self.lower.shape != self.upper.shape:
            raise ValueError(
                f"lower {self.lower.shape} and upper {self.upper.shape} "
                f"differ in shape"
            )

    @classmethod
    def from_boxes(cls, boxes) -> "BoxStack":
        boxes = list(boxes)
        return cls(np.stack([b.lower for b in boxes]),
                   np.stack([b.upper for b in boxes]))

    def __len__(self) -> int:
        return self.lower.shape[0]

    @property
    def k(self) -> int:
        return self.lower.shape[1]

    def __getitem__(self, i: int) -> BoundingBox:
        return BoundingBox(lower=self.lower[i], upper=self.upper[i])

    def expand(self, eps=0) -> "BoxStack":
        return BoxStack(self.lower - eps, self.upper + eps)

    def membership(self, points, chunk: int = 1 << 16) -> np.ndarray:
        """(N, k) points -> (N, P) bool, point n inside box p
        (inclusive), in chunks of ``chunk`` points."""
        points = np.asarray(points)
        n = len(points)
        out = np.empty((n, len(self)), bool)
        for s in range(0, max(n, 1), chunk):
            e = min(s + chunk, n)
            c = points[s:e, None, :]
            np.all((c >= self.lower[None]) & (c <= self.upper[None]),
                   axis=-1, out=out[s:e])
        return out


def latlon_to_unit_sphere(points) -> np.ndarray:
    """(N, 2) [lat, lon] radians -> (N, 3) unit-sphere embedding, the
    haversine kernel frame: the chord ``2 sin(theta / 2)`` is monotone
    in the great-circle angle, so L2 kernels answer haversine
    thresholds after it.  Trigonometry runs in float64; float32 input
    comes back float32.  A serving index loaded with
    ``projection="latlon"`` replays this on every query."""
    pts = np.asarray(points)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(
            f"metric='haversine' needs (N, 2) [lat, lon] input in "
            f"radians, got shape {pts.shape}"
        )
    out_dtype = np.float32 if pts.dtype == np.float32 else np.float64
    out = np.empty((len(pts), 3), out_dtype)
    chunk = 1 << 20
    for s in range(0, len(pts), chunk):
        e = min(s + chunk, len(pts))
        sub = np.asarray(pts[s:e], np.float64)
        if not np.isfinite(sub).all():
            raise ValueError("input contains NaN or infinite coordinates")
        lat, lon = sub[:, 0], sub[:, 1]
        clat = np.cos(lat)
        out[s:e, 0] = (clat * np.cos(lon)).astype(out_dtype)
        out[s:e, 1] = (clat * np.sin(lon)).astype(out_dtype)
        out[s:e, 2] = np.sin(lat).astype(out_dtype)
    return out
