"""User-facing single-device DBSCAN (counterpart of
``pypardis_tpu/dbscan.py``).

``DBSCAN(eps, min_samples).fit(X)`` runs the whole fit on one device:
the host centres the data on a float64 mean and pads it to the tile
grid; Morton layout, the pair-list extraction, the B1/B2 kernels and
the un-permutation run on the device (:mod:`.ops.pipeline`); the host
densifies the labels.  At d >= 128 the default ``sketch`` ("auto")
decides most pairs from a k = d/4 random-projection slab and rescores
the rest exactly (B3/B4): labels are byte-identical to the unsketched
fit.  The reference's keyed-record surface (``train``
/ ``assignments`` / ``result`` / ``bounding_boxes`` / ``cluster_dict``)
and the sklearn conveniences (``fit`` / ``fit_predict``) are kept.
A fitted model serves out-of-sample queries (``predict`` /
``query_engine``, :mod:`.serve`, kernel B5) and checkpoints in the JAX
package's format (``save`` / ``load``, :mod:`.checkpoint`).

The device is the card (``"cuda"``) unless the caller asks for
``device="cpu"``, which runs the kernels' plain PyTorch versions; with
no CUDA device and no ``device="cpu"`` the constructor raises.
Sharded fits, sweeps, live serving and telemetry are later slices of
the port (ROADMAP A10-A16).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .geometry import BoundingBox
from .ops.cuda_kernels import _pallas_block
from .ops.labels import densify_labels, resolve_backend
from .ops.pipeline import dbscan_device_pipeline, unpack_pipeline_result
from .ops.sketch import check_sketch_spec, effective_k
from .utils.budget import run_pair_ladder
from .utils.shaping import clamp_block, round_up
from .utils.validate import (
    check_finite,
    check_kernel_backend,
    check_metric,
    check_precision,
    validate_params,
)


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card.  Raises when the card is asked for (or
    defaulted to) and no CUDA device exists: the fit never carries on
    quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pypardis_tpu_torch runs on the "
            "GPU by default; pass device='cpu' to run the plain PyTorch "
            "versions of its kernels on the CPU"
        )
    return dev


def _as_float(data) -> np.ndarray:
    """Float view of host input, preserving float32/float64."""
    pts = np.asarray(data)
    if pts.dtype not in (np.float32, np.float64):
        pts = pts.astype(np.float64)
    return pts


def _as_keys_points(data):
    """Accept (N, k) arrays or tensors, ``(keys, vectors)`` pairs, or
    ``[(key, vector), ...]`` records (the reference's RDD records)."""
    if isinstance(data, torch.Tensor) and data.dim() == 2:
        return np.arange(data.shape[0]), data
    if isinstance(data, tuple) and len(data) == 2:
        keys, pts = np.asarray(data[0]), _as_float(data[1])
        if keys.ndim == 1 and pts.ndim == 2 and len(keys) == len(pts):
            return keys, pts
    if (
        isinstance(data, (list, tuple))
        and len(data) > 0
        and isinstance(data[0], tuple)
        and len(data[0]) == 2
        and np.ndim(data[0][1]) >= 1
    ):
        keys = np.asarray([k for k, _ in data])
        pts = np.asarray([np.asarray(v, dtype=np.float64) for _, v in data])
        return keys, pts
    pts = _as_float(data)
    return np.arange(len(pts)), pts


def _stage(points, block: int, device: torch.device):
    """Centre the (N, k) input and lay it out as the ``(k, cap)`` float32
    pipeline input on ``device``, zero-padded to ``cap = round_up(N,
    clamp_block(block, N))``.  Returns ``(points_t, n, block)`` with the
    clamped block.

    Host input centres on a float64 mean (chunked, no dataset-sized f64
    temp): centring keeps magnitudes small at GPS-scale coordinates.  A
    tensor centres on its own device in its own dtype (an integer one in
    float64), then casts.
    """
    n, k = points.shape
    block = clamp_block(block, n)
    points_t = torch.zeros(
        (k, round_up(n, block)), dtype=torch.float32, device=device
    )
    if isinstance(points, torch.Tensor):
        x = points.to(device)
        if not x.is_floating_point():
            # torch has no mean of an integer tensor; promote as jnp.mean
            # does, to float64 like the host path's mean.
            x = x.to(torch.float64)
        points_t[:, :n] = (x - x.mean(dim=0)).to(torch.float32).T
        return points_t, n, block
    center = points.mean(axis=0, dtype=np.float64)
    staged = np.empty((k, n), np.float32)
    chunk = 1 << 20
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        np.subtract(
            points[s:e].T, center[:, None], out=staged[:, s:e],
            casting="unsafe",
        )
    points_t[:, :n] = torch.from_numpy(staged).to(device)
    return points_t, n, block


def _pad_and_run(points, eps, min_samples, block, precision="high",
                 backend="auto", device=None, sketch=None):
    """Centre, pad to a tile multiple, run the device pipeline through
    the pair-budget ladder, and return ``(roots, core, info)`` in input
    order (roots are root point indices, -1 for noise).  ``sketch`` is
    resolved once here (None reads ``PPTORCH_SKETCH``) and every rung of
    the ladder runs that k."""
    points_t, n, block = _stage(points, block, resolve_device(device))
    k, cap = points_t.shape
    sketch_k = effective_k(sketch, k)

    def run_step(pair_budget):
        packed = dbscan_device_pipeline(
            points_t, eps, n, min_samples, block=block,
            precision=precision, backend=backend, sort=n > 2 * block,
            pair_budget=pair_budget, sketch=sketch_k,
        )
        _r, _c, total, budget, *_ = unpack_pipeline_result(packed)
        return packed, total, budget

    packed = run_pair_ladder(run_step)
    roots, core, total, budget, passes, band_pairs, rescored = (
        unpack_pipeline_result(packed)
    )
    info = {
        "live_pairs": int(total),
        "pair_budget": int(budget),
        "kernel_passes": int(passes),
        "kernel_block": int(_pallas_block(block, cap, k, precision)),
        # The counts pass's telemetry: the sketch gate's with it on,
        # else the bf16 band's under "mixed", else zeros.  Pairs whose
        # verdict fell in the band and were rescored, and pair-list
        # entries holding such a pair.
        "band_pairs": int(band_pairs),
        "rescored_tiles": int(rescored),
        # The resolved random-projection width (0 = off).
        "sketch_k": int(sketch_k),
    }
    return roots[:n], core[:n], info


class DBSCAN:
    """Density-based clustering on one GPU.

    Hyperparameters follow the reference (``eps``, ``min_samples``,
    ``metric``) plus the tile ``block``, the kernel ``precision``
    (``"high"`` and ``"highest"`` both run exact FP32; ``"mixed"`` runs
    a bf16 tensor-core pass and rescores the pairs near eps exactly,
    labels byte-identical to ``"high"``; ``"default"`` the bf16 pass
    alone, lossy), the ``kernel_backend`` (``"auto"`` picks the CUDA
    kernels on the card and their plain versions on the CPU), the
    ``device`` and the
    ``sketch`` prefilter (None defers to ``PPTORCH_SKETCH``, default
    ``"auto"``: k = d/4 at d >= 128; ``"off"``/0; or a pinned k),
    which leaves the labels byte-identical.
    """

    def __init__(
        self,
        eps: float = 0.5,
        min_samples: int = 5,
        metric="euclidean",
        block: int = 1024,
        precision: str = "high",
        kernel_backend: str = "auto",
        device=None,
        sketch=None,
    ):
        validate_params(eps, min_samples)
        self.eps = float(eps)
        self.min_samples = int(min_samples)
        self.metric = metric
        self._metric_norm = check_metric(metric)
        self.block = int(block)
        self.precision = check_precision(precision)
        self.kernel_backend = check_kernel_backend(kernel_backend)
        self.sketch = check_sketch_spec(sketch)
        self.device = resolve_device(device)
        resolve_backend(self.kernel_backend, self.device)
        # Reference attribute surface.
        self.data = None
        self._keys = None
        self._result_cache = None
        self.bounding_boxes: Optional[Dict[int, BoundingBox]] = None
        self.expanded_boxes: Optional[Dict[int, BoundingBox]] = None
        self.neighbors = None
        self.cluster_dict = None
        self.labels_: Optional[np.ndarray] = None
        self.core_sample_mask_: Optional[np.ndarray] = None
        self.metrics_: Dict[str, float] = {}
        # Serving state: the cached query engine, the core-point
        # coordinates of a loaded or carried-across model, and the fit
        # generation a held engine checks itself against.
        self._serve_engine = None
        self._serve_core_points = None
        self._fit_generation = 0

    @property
    def kernel_eps(self) -> float:
        """eps in the kernels' frame (the Euclidean metric: eps)."""
        return self.eps

    # -- training ---------------------------------------------------------

    def train(self, data) -> "DBSCAN":
        """Cluster a (key, vector) dataset; see :func:`_as_keys_points`
        for the accepted forms."""
        keys, points = _as_keys_points(data)
        self._keys = keys
        self.data = points
        self._result_cache = None
        self.metrics_ = {}
        # A refit invalidates the serving surface; a held engine sees
        # the generation move and raises instead of serving the old fit.
        self._serve_engine = None
        self._serve_core_points = None
        self._fit_generation += 1
        if len(points) == 0:
            self.labels_ = np.empty(0, np.int32)
            self.core_sample_mask_ = np.empty(0, bool)
            self.bounding_boxes, self.expanded_boxes = {}, {}
            self.neighbors, self.cluster_dict = {}, {}
            self.metrics_ = {"total_s": 0.0, "points_per_sec": 0.0}
            return self
        check_finite(points)
        t0 = time.perf_counter()
        self._train_single(points)
        self.metrics_["total_s"] = time.perf_counter() - t0
        self.metrics_["points_per_sec"] = len(points) / max(
            self.metrics_["total_s"], 1e-9
        )
        return self

    def _train_single(self, points) -> None:
        roots, core, info = _pad_and_run(
            points, self.eps, self.min_samples, self.block,
            precision=self.precision, backend=self.kernel_backend,
            device=self.device, sketch=self.sketch,
        )
        self.metrics_["n_partitions"] = 1
        self.metrics_.update(info)
        if isinstance(points, torch.Tensor):
            both = torch.stack(
                [points.amin(dim=0), points.amax(dim=0)]
            ).double().cpu().numpy()
            lo, hi = both[0], both[1]
        else:
            lo, hi = points.min(axis=0), points.max(axis=0)
        self._set_fit(densify_labels(roots), core, lo, hi)

    def _set_fit(self, labels, core, lo, hi) -> None:
        """Install a single-partition fit: labels, core mask, and the
        reference's parity surface (one box over the data, every point
        in partition 0's neighbourhood, ``"0:<label>"`` cluster codes).
        """
        self.labels_ = labels
        self.core_sample_mask_ = core
        box = BoundingBox(lower=lo, upper=hi)
        self.bounding_boxes = {0: box}
        self.expanded_boxes = {0: box.expand(2 * self.eps)}
        self.neighbors = {0: np.arange(len(labels))}
        self.cluster_dict = {
            f"0:{l}": int(l) for l in np.unique(labels) if l >= 0
        }

    def fit(self, X) -> "DBSCAN":
        """Fit on an (N, d) array; a tensor (e.g. already on the card)
        is clustered where it lies, without a host round trip."""
        if isinstance(X, torch.Tensor):
            return self.train(X)
        return self.train(np.asarray(X))

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).labels_

    # -- results ----------------------------------------------------------

    @property
    def result(self):
        """Key-sorted ``[(key, global label)]``, built on first access."""
        if self._result_cache is None and self.labels_ is not None:
            order = np.argsort(self._keys, kind="stable")
            self._result_cache = list(
                zip(self._keys[order].tolist(), self.labels_[order].tolist())
            )
        return self._result_cache

    def _require_fitted(self) -> None:
        if self.labels_ is None:
            raise RuntimeError(
                "this DBSCAN model is not fitted; call fit()/train() first"
            )

    def assignments(self):
        """``[(key, global cluster id)]`` — the reference's result."""
        self._require_fitted()
        return self.result

    # -- serving ----------------------------------------------------------

    def predict(self, X) -> np.ndarray:
        """Out-of-sample cluster assignment: (N,) int32 labels.  A query
        takes the label of its nearest core point within eps (ties: the
        smallest label), else -1; exact against the brute-force
        core-point oracle.  Runs through the cached
        :meth:`query_engine`."""
        return self.query_engine().predict(X)

    def query_engine(self, **kw):
        """The cached serving engine over this model's core-point index,
        built on first use on the model's device; kwargs (``leaves``,
        ``block``, ``qblock``, ``backend``, ``batch_capacity``, ...)
        force a rebuild.  Works on a loaded model without its training
        data."""
        self._require_fitted()
        if self._serve_engine is None or kw:
            from .serve import QueryEngine

            self._serve_engine = QueryEngine.from_model(self, **kw)
        return self._serve_engine

    # -- checkpoints ------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the fitted model in the JAX package's format."""
        from .checkpoint import save_model

        save_model(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "DBSCAN":
        """Restore a model checkpointed by either package."""
        from .checkpoint import load_model

        return load_model(path, device=device)
