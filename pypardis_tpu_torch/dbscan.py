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

The metrics are the JAX package's: Euclidean and cityblock run the pair
passes directly (cityblock through its torch L1 pass on any device, as
the JAX package runs it outside Pallas); cosine and haversine are
driver metrics, fitted on projected rows (unit norm; the unit sphere)
with eps remapped onto the Euclidean kernels (:attr:`DBSCAN.kernel_eps`).
:meth:`DBSCAN.sweep` / :func:`sweep_dbscan` fit a grid of (eps,
min_samples) configs from one distance pass; :func:`dbscan_partition`,
:func:`map_cluster_id` and :meth:`DBSCAN.cluster_mapping` keep the
reference's per-partition wire format.

The device is the card (``"cuda"``) unless the caller asks for
``device="cpu"``, which runs the kernels' plain PyTorch versions; with
no CUDA device and no ``device="cpu"`` the constructor raises.

``DBSCAN(eps=None)`` fits the eps-free density hierarchy
(:mod:`.ops.hierarchy`): one neighbour-pair graph at a data-derived
ceiling, the mutual-reachability MST and HDBSCAN*'s stability rule
select the flat cut, exposed as ``eps_``; ``sweep(eps_list="auto")``
takes its eps ladder from the same hierarchy.  A fitted model takes
live inserts and deletes (``live``, ``insert``, ``delete``;
:mod:`.serve.live`), its serving index edited in place, and many fitted
models serve behind one :class:`~.serve.gateway.ModelGateway`.  The KD
route's partitioned fit is
:func:`pypardis_tpu_torch.parallel.sharded_dbscan` (chained on one
card, fused on a :class:`~.parallel.mesh.Mesh`); ``fit`` takes it with
more than one device (see :class:`DBSCAN`): a memmap through the ring
exchange's streaming build, a tensor through the device-input route
(:func:`~.parallel.sharded.sharded_dbscan_device`); ``mode=
"global_morton"`` takes the global-Morton mesh engine
(:func:`~.parallel.global_morton_dbscan`: Euclidean, cityblock, and
cosine and haversine through their frames).  A sweep and an eps=None fit route as ``fit`` does:
host input on more than one device builds the global neighbour-pair
graph on the KD route (:func:`~.parallel.sharded.sweep_graph_sharded`)
or, under ``mode="global_morton"``, the global-Morton route
(:func:`~.parallel.global_morton.sweep_graph_global_morton`).  The
multi-process layer is a later slice of the port (ROADMAP A10's rest).

Every fit, sweep and eps=None fit records its telemetry on a fresh
:class:`~.obs.RunRecorder`: phase spans and timings, the pipeline's
spans, the ladders' events and resource watermarks, behind
:meth:`DBSCAN.report` (the JAX package's ``run_report@1`` dict),
:meth:`DBSCAN.summary` and :meth:`DBSCAN.export_trace` (Chrome trace).
``flight=`` streams it to a crash-safe JSONL file
(:func:`~.obs.replay` reads it back), ``profile_dir=`` runs the fit
under ``torch.profiler``, and ``PPTORCH_METRICS_PORT`` /
``PPTORCH_METRICS_SNAPSHOT`` export it live.

A fit past ``PPTORCH_STEP_THRESHOLD`` kernel slots runs its rounds in
batches on the host-stepped route, which ``train(resume=path)`` (or
``PPTORCH_CKPT``) checkpoints and resumes byte-identically
(:mod:`.utils.jobstate`); ``PPTORCH_FAULTS`` injects faults at named
sites (:mod:`.utils.faults`) and ``report()["faults"]`` counts them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import obs
from .aggregator import ClusterAggregator
from .geometry import BoundingBox, latlon_to_unit_sphere
from .ops.cuda_kernels import _pallas_block
from .ops.labels import check_pair_metric, densify_labels, resolve_backend
from .ops.pipeline import (
    LAYOUT_ROUTE,
    _pipeline_pack,
    dbscan_device_pipeline,
    unpack_pipeline_result,
)
from .ops.sketch import check_sketch_spec, effective_k
from .parallel.sharded import SweepGraphOverflow
from .utils import faults
from .utils.budget import run_pair_ladder
from .utils.hints import dispatch_tag
from .utils.log import get_logger, log_phase
from .utils.profiling import PhaseTimer, trace
from .utils.retry import DEFAULT_WAITS, Retrier, is_transient_error
from .utils.shaping import clamp_block, round_up, row_chunks
from .utils.validate import (
    check_finite,
    check_kernel_backend,
    check_metric,
    check_precision,
    validate_params,
)


def _kernel_eps(metric_norm: str, eps) -> float:
    """eps in the kernels' frame: ``sqrt(2 eps)`` for cosine, ``2
    sin(eps / 2)`` for haversine, else eps (float64 numpy, as the JAX
    package computes it)."""
    if metric_norm == "cosine":
        return float(np.sqrt(2.0 * eps))
    if metric_norm == "haversine":
        return float(2.0 * np.sin(eps / 2.0))
    return float(eps)


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
    """Float view of host input, preserving float32/float64 (and a
    memmap, which a mesh fit streams rather than reads whole)."""
    pts = data if isinstance(data, np.memmap) else np.asarray(data)
    if pts.dtype not in (np.float32, np.float64):
        pts = pts.astype(np.float64)
    return pts


def _unit_rows(points) -> np.ndarray:
    """Rows scaled to unit L2 norm: the cosine metric's kernel frame (on
    the unit sphere d^2 = 2 - 2 cos, so the L2 kernels answer cosine
    thresholds at ``sqrt(2 * eps)``).  The JAX package's numpy
    arithmetic, op for op: norms summed in float64 by ``np.einsum``,
    chunked; float32 input comes back float32.  Zero rows raise."""
    pts = _as_float(points)
    out = np.empty(
        pts.shape, np.float64 if pts.dtype == np.float64 else np.float32
    )
    chunk = 1 << 20
    for s in range(0, len(pts), chunk):
        e = min(s + chunk, len(pts))
        sub = np.asarray(pts[s:e], np.float64)
        nrm = np.sqrt(np.einsum("ij,ij->i", sub, sub))
        if not np.isfinite(nrm).all():
            raise ValueError("input contains NaN or infinite coordinates")
        if not nrm.all():
            raise ValueError(
                "metric='cosine' is undefined for zero vectors: row(s) "
                "with zero norm in the input"
            )
        out[s:e] = (sub / nrm[:, None]).astype(out.dtype)
    return out


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


# One host staging buffer, reused across fits of the same padded shape
# (the JAX package's): a fit borrows it, fills it and copies it to the
# device, then returns it.  Only the most recent shape is kept (at 10M x
# 16-D it is 640 MB of host memory).  A second fit while it is out
# allocates a fresh one.
_staging: dict = {}


def _staging_buffer(k: int, cap: int) -> np.ndarray:
    """Borrow the ``(k, cap)`` float32 staging buffer (return it with
    :func:`_staging_return` once its device copy is made)."""
    buf = _staging.pop((k, cap), None)
    if buf is None:
        buf = np.empty((k, cap), np.float32)
    return buf


def _staging_return(buf: np.ndarray) -> None:
    _staging.clear()
    _staging[buf.shape] = buf


def _layout_cacheable(cap: int, k: int) -> bool:
    """Whether the single-card fit may keep its sorted layout on the
    device between fits (the staging cache's ``pipeline_layout`` route).
    The layout can reach 2x cap rows after the segment break, so the
    cache is capped: ``PPTORCH_LAYOUT_CACHE_MAX`` bytes of coordinates
    (default 512 MB, the JAX package's), and ``PPTORCH_LAYOUT_CACHE=0``
    turns it off."""
    if os.environ.get("PPTORCH_LAYOUT_CACHE", "1") == "0":
        return False
    max_bytes = int(os.environ.get("PPTORCH_LAYOUT_CACHE_MAX", 1 << 29))
    return 2 * cap * k * 4 <= max_bytes


def _stage(points, block: int, device: torch.device):
    """Centre the (N, k) input and lay it out as the ``(k, cap)`` float32
    pipeline input on ``device``, zero-padded to ``cap = round_up(N,
    clamp_block(block, N))``.  Returns ``(points_t, n, block)`` with the
    clamped block.

    Host input centres on a float64 mean (chunked, no dataset-sized f64
    temp) into the borrowed staging buffer (:func:`_staging_buffer`),
    copied to ``device`` as a tensor of its own (on the CPU too, where
    the buffer's next fit would otherwise rewrite it) and returned:
    centring keeps magnitudes small at GPS-scale coordinates.  A tensor
    centres on its own device in its own dtype (an integer one in
    float64), then casts.
    """
    n, k = points.shape
    block = clamp_block(block, n)
    cap = round_up(n, block)
    if isinstance(points, torch.Tensor):
        points_t = torch.zeros((k, cap), dtype=torch.float32, device=device)
        x = points.to(device)
        if not x.is_floating_point():
            # torch has no mean of an integer tensor; promote as jnp.mean
            # does, to float64 like the host path's mean.
            x = x.to(torch.float64)
        points_t[:, :n] = (x - x.mean(dim=0)).to(torch.float32).T
        return points_t, n, block
    center = points.mean(axis=0, dtype=np.float64)
    buf = _staging_buffer(k, cap)
    try:
        buf[:, n:] = 0.0
        for s, e in row_chunks(n, k):
            np.subtract(
                points[s:e].T, center[:, None], out=buf[:, s:e],
                casting="unsafe",
            )
        # From pageable memory the copy is complete when it returns.
        return torch.from_numpy(buf).to(device, copy=True), n, block
    finally:
        _staging_return(buf)


def _graph_under_ceiling(gh, gstats, thr_max):
    """The hierarchy's graph handle and stats at its own ceiling
    ``thr_max`` (a float32 threshold): a graph served from the cache may
    have been built at a higher one, and the core distances and the MST
    read every edge they are given, so only the edges with ``dv <=
    thr_max`` are kept, exactly those a cold build at the ceiling
    emits.  A graph built at the ceiling comes back as it is."""
    keep = gh["dv"] <= thr_max
    kept = int(keep.sum())
    if kept == int(gh["dv"].numel()):
        return gh, gstats
    gh = dict(gh, gi=gh["gi"][keep], gj=gh["gj"][keep], dv=gh["dv"][keep])
    gstats = dict(gstats, graph_pairs=kept, graph_bytes=kept * 12)
    return gh, gstats


def _pad_and_run(points, eps, min_samples, block, precision="high",
                 backend="auto", device=None, sketch=None,
                 metric="euclidean", jobstate=None):
    """Centre, pad to a tile multiple, run the device pipeline through
    the pair-budget ladder, and return ``(roots, core, info)`` in input
    order (roots are root point indices, -1 for noise).  ``sketch`` is
    resolved once here (None reads ``PPTORCH_SKETCH``) and every rung of
    the ladder runs that k; ``metric`` is a pair metric (Euclidean or
    cityblock, whose sketch is off).  The ladder's hint key is the JAX
    package's (dispatch tag, slab shape, block, precision, eps, metric,
    sketch k); ``jobstate`` reaches the stepped route.

    Host input goes through the staging cache's ``pipeline_layout``
    route (:func:`_layout_cacheable`): its key is the JAX package's
    (the input's content fingerprint, block, cap, the sort flag,
    precision, eps) and the device, and staging is lazy, so a hit
    centres, copies and sorts nothing.  A tensor is never cached (nor
    fingerprinted).  A transient failure that outlives the pipeline's
    own retries evicts the route and restages (``retry.restage``).
    ``info`` carries the fit's ``staged_bytes`` and
    ``staged_bytes_reused``."""
    from .parallel import staging

    metric = check_pair_metric(metric, check_precision(precision))
    dev = resolve_device(device)
    staging.begin_fit()
    n, k = points.shape
    block = clamp_block(block, n)
    cap = round_up(n, block)
    sort = n > 2 * block
    layout_key = None
    if not isinstance(points, torch.Tensor) and _layout_cacheable(cap, k):
        layout_key = (staging.points_fingerprint(points), block, cap, sort,
                      precision, float(eps), str(dev))
    staged = []

    def points_t():
        # Lazy: a layout-cache hit never calls it.
        if not staged:
            staged.append(_stage(points, block, dev)[0])
        return staged[0]

    sketch_k = effective_k(sketch, k) if metric == "euclidean" else 0
    hint_key = (dispatch_tag(cap // block), (k, cap), block, precision,
                float(eps), metric, sketch_k)

    def restageable(e: BaseException) -> bool:
        if not is_transient_error(e):
            return False
        # The retry rebuilds the layout: a cached one is never served
        # to the attempt after a failure.
        staging.device_evict(LAYOUT_ROUTE)
        staged.clear()
        return True

    def run_step(pair_budget):
        def run():
            return dbscan_device_pipeline(
                points_t, eps, n, min_samples, block=block,
                precision=precision, backend=backend, sort=sort,
                pair_budget=pair_budget, sketch=sketch_k, metric=metric,
                jobstate=jobstate, layout_key=layout_key,
            )

        packed, tiles = Retrier("restage", waits=DEFAULT_WAITS).run(
            run, retryable=restageable)
        _r, _c, total, budget, *_ = unpack_pipeline_result(packed)
        return (packed, tiles), total, budget

    packed, tiles = run_pair_ladder(run_step, hint_key=hint_key)
    roots, core, total, budget, passes, band_pairs, rescored = (
        unpack_pipeline_result(packed)
    )
    reused, shipped = staging.fit_stats()
    tile = int(_pallas_block(block, cap, k, precision))
    info = {
        "live_pairs": int(total),
        "pair_budget": int(budget),
        "kernel_passes": int(passes),
        # The kernel grid's (the segment break pads it past cap).
        "kernel_tiles": int(tiles),
        "kernel_block": tile,
        # The counts pass's telemetry: the sketch gate's with it on,
        # else the bf16 band's under "mixed", else zeros.  Pairs whose
        # verdict fell in the band and were rescored, and pair-list
        # entries holding such a pair.
        "band_pairs": int(band_pairs),
        "rescored_tiles": int(rescored),
        # The resolved random-projection width (0 = off).
        "sketch_k": int(sketch_k),
        # The staging cache's bytes: shipped to the device, and served
        # from it (a warm refit of the same data reuses its layout).
        "staged_bytes": int(shipped),
        "staged_bytes_reused": int(reused),
    }
    return roots[:n], core[:n], info


def _cluster_codes(parts: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Each clustered point's ``(partition, label)`` as one int64 code,
    the partition in the high word (noise left out)."""
    sel = labels >= 0
    return parts[sel].astype(np.int64) << 32 | labels[sel].astype(np.int64)


def _code_key(code) -> str:
    """The ``"partition:cluster"`` key of a :func:`_cluster_codes` code."""
    return f"{int(code) >> 32}:{int(code) & 0xFFFFFFFF}"


def _expanded_neighbors(tree, points, eps) -> Dict:
    """{partition label -> indices of the points in its 2*eps-widened
    box} by a replay of the split tree on the host (a tensor is fetched
    once)."""
    from .partition import expanded_members

    if isinstance(points, torch.Tensor):
        points = points.cpu().numpy()
    members = expanded_members(tree, np.asarray(points), 2 * eps)
    return {l: members[l][0] for l in sorted(members)}


def _partition_cluster_dict(parts: np.ndarray, labels: np.ndarray) -> Dict:
    """``{"partition:cluster": global id}`` parity codes (the reference's
    ``cluster_dict``): the global dense label doubles as the
    per-partition cluster id."""
    return {
        _code_key(c): int(c & 0xFFFFFFFF)
        for c in np.unique(_cluster_codes(parts, labels))
    }


def dbscan_partition(iterable, params):
    """The reference's per-partition worker: takes ``((key, partition),
    vector)`` records, clusters the stacked vectors (``params``:
    ``eps``, ``min_samples`` and optionally ``metric`` (a pair metric),
    ``precision``, ``backend``, ``device``) and yields ``(key,
    "part:cluster[*]")``, ``'*'`` marking non-core points: the label
    wire format :class:`ClusterAggregator` consumes."""
    data = list(iterable)
    if not data:
        return
    (_, part), _ = data[0]
    x = _as_float(np.stack([np.asarray(v) for (_k, _p), v in data]))
    y = [k for (k, _p), _v in data]
    roots, core, _kinfo = _pad_and_run(
        x,
        params["eps"],
        params["min_samples"],
        block=256,
        precision=params.get("precision", "high"),
        backend=params.get("backend", "auto"),
        device=params.get("device"),
        metric=params.get("metric", "euclidean"),
    )
    labels = densify_labels(roots)
    for i in range(len(x)):
        flag = "" if core[i] else "*"
        yield (y[i], "%i:%i%s" % (part, labels[i], flag))


def map_cluster_id(x, mapping: Dict[str, int]):
    """The reference's ``map_cluster_id`` with a plain dict for its
    broadcast: strip the core marker, look up the global id; noise and
    unmapped labels give -1."""
    key, cluster_id = x
    cluster_id = next(iter(cluster_id)).strip("*")
    if "-1" not in cluster_id and cluster_id in mapping:
        return key, mapping[cluster_id]
    return key, -1


class SweepResult:
    """Result of an amortized sweep (:meth:`DBSCAN.sweep`).

    ``configs`` is the ``(eps, min_samples)`` grid in request order; each
    config's dense labels and core mask equal an independent fit at that
    config.  ``stats`` is the sweep's telemetry (``distance_passes``,
    ``graph_pairs``, ``graph_bytes``, ``relabel_s``, ``degraded``,
    ``sweep_amortization_est``, ...); ``per_config`` one dict per
    config.  ``sweep_amortization_est`` is the JAX package's
    ``sweep_amortization`` estimate (configs x (graph build + first
    relabel) / sweep wall), not a measured ratio: on the card the torch
    emission costs far more than a fit, so it overstates the gain.
    """

    def __init__(self, configs, labels, core, per_config, stats):
        self.configs = list(configs)
        self._labels = labels
        self._core = core
        self.per_config = per_config
        self.stats = stats

    def _key(self, eps, min_samples=None):
        if min_samples is None:
            matches = [c for c in self.configs if c[0] == float(eps)]
            if len(matches) != 1:
                raise KeyError(
                    f"eps={eps} matches {len(matches)} configs; pass "
                    f"min_samples too"
                )
            return matches[0]
        key = (float(eps), int(min_samples))
        if key not in self._labels:
            raise KeyError(f"config {key} was not in this sweep")
        return key

    def labels(self, eps, min_samples=None) -> np.ndarray:
        """Dense labels for one config (noise = -1)."""
        return self._labels[self._key(eps, min_samples)]

    def core(self, eps, min_samples=None) -> np.ndarray:
        """Core-sample mask for one config."""
        return self._core[self._key(eps, min_samples)]

    def __len__(self) -> int:
        return len(self.configs)

    def __iter__(self):
        for c in self.configs:
            yield c, self._labels[c]


def sweep_dbscan(points, eps_list, min_samples_list=None, **kw):
    """``DBSCAN(**kw).sweep(points, eps_list, min_samples_list)``; the
    model is ``result.model``."""
    model = DBSCAN(**kw)
    result = model.sweep(points, eps_list, min_samples_list)
    result.model = model
    return result


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
    which leaves the labels byte-identical.  ``metric``: ``"euclidean"``,
    ``"cityblock"`` (also ``"manhattan"``/``"l1"``), ``"cosine"``
    (``"angular"``; eps in (0, 2]) or ``"haversine"`` ((lat, lon)
    radians; eps the great-circle angle in (0, pi]), or a scipy
    callable by name.  ``eps=None`` selects eps by the density
    hierarchy's stability rule at fit time (``eps_``; its labels are
    ``fit(eps_)``'s, at ``"high"`` when ``precision="default"``);
    ``min_cluster_size`` (>= 2, default ``max(min_samples, 2)``) is its
    condensation granularity.  ``flight``: a ``*.jsonl`` path or a
    directory for per-fit files of the crash-safe flight recorder (None
    defers to ``PPTORCH_FLIGHT``); ``profile_dir``: a directory each fit
    writes a ``torch.profiler`` Chrome trace into.

    The sharding knobs are the JAX package's: with more than one device
    (``mesh``, a :class:`~.parallel.mesh.Mesh`, or every visible card
    when there is none) and at least two points per device, ``fit``
    partitions the data with a :class:`~.partition.KDPartitioner` of at
    most ``max_partitions`` leaves (default one per device; its
    ``split_method``) and runs the fused multi-device step
    (:func:`~.parallel.sharded_dbscan`): ``merge`` ``"auto"``,
    ``"device"`` or ``"host"``, ``owner_computes`` (default True: halo
    points are never clustered again).  ``overlap`` is accepted and
    changes nothing (see :func:`~.parallel.sharded_dbscan`).  A memmap
    takes the ring route's streaming build (``halo="ring"``); a tensor
    takes the device-input route
    (:func:`~.parallel.sharded.sharded_dbscan_device`; a tensor on
    another device type moves to the mesh's first device), whose
    ``neighbors`` are computed on first access.  ``mode=
    "global_morton"`` runs the global-Morton mesh engine instead
    (:meth:`_train_sharded_global_morton`): host input only (a tensor
    raises ``ValueError``), a memmap streaming; an OOM-class failure of
    that engine falls back to the KD route (``degraded_to ==
    "kd_owner_computes"``, the same labels).  A mesh's devices must be
    of the model's ``device`` type.
    """

    def __init__(
        self,
        eps: Optional[float] = 0.5,
        min_samples: int = 5,
        metric="euclidean",
        min_cluster_size: Optional[int] = None,
        block: int = 1024,
        precision: str = "high",
        kernel_backend: str = "auto",
        device=None,
        sketch=None,
        profile_dir: Optional[str] = None,
        flight: Optional[str] = None,
        max_partitions: Optional[int] = None,
        split_method: str = "min_var",
        mesh=None,
        merge: Optional[str] = None,
        owner_computes: bool = True,
        overlap: Optional[bool] = None,
        mode: Optional[str] = None,
    ):
        validate_params(eps, min_samples, allow_none_eps=True)
        self.eps = None if eps is None else float(eps)
        self.min_samples = int(min_samples)
        if min_cluster_size is not None and int(min_cluster_size) < 2:
            raise ValueError(
                f"min_cluster_size must be >= 2, got {min_cluster_size}"
            )
        self.min_cluster_size = (
            None if min_cluster_size is None else int(min_cluster_size)
        )
        self.metric = metric
        self._metric_norm = check_metric(metric, self.eps)
        self.block = int(block)
        self.precision = check_precision(precision)
        check_pair_metric(self._pair_metric, self.precision)
        self.kernel_backend = check_kernel_backend(kernel_backend)
        self.sketch = check_sketch_spec(sketch)
        self.device = resolve_device(device)
        resolve_backend(self.kernel_backend, self.device, self._pair_metric)
        self.profile_dir = profile_dir
        self.flight = flight
        # The sharding knobs (the JAX package's, with its defaults): the
        # KD partition count (None: one per mesh device), its split
        # rule, the mesh, the label merge, owner-computes on the fused
        # step, the overlap switch (accepted, see sharded_dbscan) and
        # the mode (auto|kd|global_morton).
        mode = "auto" if mode is None else mode
        if mode not in ("auto", "kd", "global_morton"):
            raise ValueError(
                f"mode must be auto|kd|global_morton, got {mode!r}"
            )
        merge = "auto" if merge is None else merge
        if merge not in ("auto", "device", "host"):
            raise ValueError(f"merge must be auto|device|host, got {merge!r}")
        if max_partitions is not None and int(max_partitions) < 1:
            raise ValueError(
                f"max_partitions must be >= 1, got {max_partitions}"
            )
        from .parallel.mesh import as_mesh

        self.max_partitions = max_partitions
        self.split_method = split_method
        self.mesh = as_mesh(mesh)
        if self.mesh is not None and self.mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh's devices are {self.mesh.device_type} but the "
                f"model runs on {self.device.type}"
            )
        self.merge = merge
        self.owner_computes = bool(owner_computes)
        self.overlap = overlap
        self.mode = mode
        # The sharded fit's partitioner (None after a single-device fit):
        # cluster_mapping() keys points by its partitions.
        self.partitioner_ = None
        # Telemetry of the most recent fit, behind report(), summary()
        # and export_trace(); the sweep's and the hierarchy's blocks.
        self._recorder: Optional[obs.RunRecorder] = None
        self._fit_info: Dict[str, int] = {}
        self._sweep_stats: Optional[Dict] = None
        # The live write surface (:meth:`live`); its model reads the
        # lazily synced labels_ / core_sample_mask_ / data below.
        self._live_model = None
        self._live_stats: Optional[Dict] = None
        # Reference attribute surface.
        self.data = None
        self._keys = None
        self._result_cache = None
        self.bounding_boxes: Optional[Dict[int, BoundingBox]] = None
        self.expanded_boxes: Optional[Dict[int, BoundingBox]] = None
        self._neighbors = None
        self._neighbors_lazy = False
        self.cluster_dict = None
        self.labels_: Optional[np.ndarray] = None
        self.core_sample_mask_: Optional[np.ndarray] = None
        self.metrics_: Dict[str, float] = {}
        # The density hierarchy (eps=None fits, sweep("auto")): its
        # block of stats (the JAX package's report()["hierarchy"]) and
        # the selected eps in the user frame, which serving runs at.
        self._hier_stats: Optional[Dict] = None
        self.eps_: Optional[float] = None
        # Serving state: the cached query engine, the core-point
        # coordinates of a loaded or carried-across model, and the fit
        # generation a held engine checks itself against.
        self._serve_engine = None
        self._serve_core_points = None
        self._fit_generation = 0
        # The most recent fit's checkpoint state (train(resume=) or
        # PPTORCH_CKPT), None without either.
        self._jobstate = None

    @property
    def neighbors(self):
        """{partition label -> indices of the points in its
        2*eps-widened box}, the reference's per-partition neighbourhood
        as index arrays, with one meaning on every route.  After a fit
        from a tensor on a mesh (:meth:`_train_sharded_device`) it is
        computed on first access, as in the JAX package: the split tree
        is replayed on the host, which fetches the coordinates once (a
        transfer the fit itself never makes).  It reads ``self.data``:
        a model whose ``data`` was cleared raises instead."""
        if self._neighbors is None and self._neighbors_lazy:
            if self.data is None or self.partitioner_ is None:
                raise RuntimeError(
                    "neighbors needs the training data; model.data was "
                    "cleared after a device-resident fit"
                )
            self._neighbors = _expanded_neighbors(
                self.partitioner_.tree, self.data, self.eps)
            self._neighbors_lazy = False
        return self._neighbors

    @neighbors.setter
    def neighbors(self, value):
        self._neighbors = value
        self._neighbors_lazy = False

    @property
    def _pair_metric(self) -> str:
        """The metric the pair passes run: cityblock, else Euclidean
        (the driver metrics run the L2 kernels in their frame)."""
        return "cityblock" if self._metric_norm == "cityblock" else "euclidean"

    @property
    def kernel_eps(self) -> float:
        """eps in the kernels' frame: for cosine the L2 threshold
        ``sqrt(2 * eps)`` on the unit sphere, for haversine the chord
        ``2 sin(eps / 2)`` of the great-circle angle, else eps.  The
        serving index builds against it.  An eps=None model resolves to
        the fitted ``eps_``, so serving runs at the eps its labels were
        computed at."""
        return _kernel_eps(self._metric_norm, self._effective_eps())

    def _effective_eps(self) -> float:
        """``self.eps``, or the stability-selected ``eps_`` of an eps=None
        model; raises before its first fit (no eps to serve at yet)."""
        if self.eps is not None:
            return float(self.eps)
        if self.eps_ is not None:
            return float(self.eps_)
        raise RuntimeError(
            "this model was constructed with eps=None and has not been "
            "fitted yet — fit() selects eps by the stability rule and "
            "exposes it as eps_"
        )

    def _kernel_frame(self):
        """Context manager swapping ``(eps, metric)`` to the kernel frame
        for a fit or sweep body of a driver metric (cosine, haversine),
        so every internal consumer sees the L2 values; the user's spec
        is restored on exit.  A no-op for the pair metrics."""
        if self._metric_norm not in ("cosine", "haversine"):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def swap():
            saved = (self.eps, self.metric)
            # The hierarchy picks its own ceiling (_hier_ceiling): an
            # eps=None model swaps only the metric.
            eps_k = None if saved[0] is None else self.kernel_eps
            self.eps, self.metric = eps_k, "euclidean"
            try:
                yield
            finally:
                self.eps, self.metric = saved

        return swap()

    def _driver_frame_rows(self, points) -> np.ndarray:
        """Raw rows in a driver metric's kernel frame: unit rows for
        cosine, (lat, lon) radians on the unit sphere for haversine.
        Host numpy arithmetic, as the JAX package's: a tensor (on the
        card too) is brought to the host first, and ``model.data`` holds
        the projected rows."""
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        if self._metric_norm == "cosine":
            return _unit_rows(points)
        return latlon_to_unit_sphere(points)

    # -- training ---------------------------------------------------------

    def train(self, data, resume: Optional[str] = None) -> "DBSCAN":
        """Cluster a (key, vector) dataset; see :func:`_as_keys_points`
        for the accepted forms.  A cosine or haversine fit runs on the
        projected rows (:meth:`_driver_frame_rows`) at
        :attr:`kernel_eps` (and resumes through that frame); its labels
        are the metric's clustering.  An eps=None model fits the density
        hierarchy instead (:meth:`_fit_hierarchy`), which does not
        resume.

        ``resume=path`` makes the fit checkpoint-resumable
        (:mod:`.utils.jobstate`): the host-stepped route snapshots its
        propagation state to ``path`` at the ``PPTORCH_CKPT_EVERY_S``
        cadence, and a fit that died is retrained with the same path to
        replay only the unfinished batches, labels byte-identical to an
        uninterrupted fit.  A snapshot of another fit (other data or
        parameters) raises ``ValueError``.  ``PPTORCH_CKPT=<path>``
        writes snapshots for fits that pass no ``resume``.  The open
        :class:`~.utils.jobstate.JobState` stays on the model as
        ``_jobstate`` (its ``restored_rounds``)."""
        if self.eps is None:
            if resume is not None:
                raise ValueError(
                    "resume/checkpointing is not supported on the "
                    "eps=None hierarchy path"
                )
            return self._fit_hierarchy(data)
        if self._metric_norm in ("cosine", "haversine"):
            keys, points = _as_keys_points(data)
            with self._kernel_frame():
                self._train_impl(
                    (keys, self._driver_frame_rows(points)), resume)
        else:
            self._train_impl(data, resume)
        self.eps_ = float(self.eps)
        return self

    def _open_jobstate(self, points, resume: Optional[str]):
        """The fit's :class:`~.utils.jobstate.JobState` for ``resume`` or
        ``PPTORCH_CKPT`` (None without either); its meta is the JAX
        package's for the same fit."""
        path = resume or os.environ.get("PPTORCH_CKPT")
        if not path:
            return None
        from .utils.jobstate import JobState, fit_meta

        metric = (self.metric if isinstance(self.metric, str)
                  else getattr(self.metric, "__name__", "callable"))
        return JobState.open(
            path,
            fit_meta(points, eps=self.eps, min_samples=self.min_samples,
                     metric=metric, block=self.block, mode=self.mode),
            resume=resume is not None,
        )

    def _train_impl(self, data, resume: Optional[str] = None) -> "DBSCAN":
        """The metric-agnostic fit body (kernel-frame eps)."""
        keys, points = _as_keys_points(data)
        faults.from_env()
        self._jobstate = self._open_jobstate(points, resume)
        self._keys = keys
        self.data = points
        self._result_cache = None
        self._reset_fit()
        if len(points) == 0:
            self.labels_ = np.empty(0, np.int32)
            self.core_sample_mask_ = np.empty(0, bool)
            self.bounding_boxes, self.expanded_boxes = {}, {}
            self.neighbors, self.cluster_dict = {}, {}
            self.metrics_ = {"total_s": 0.0, "points_per_sec": 0.0}
            self._fit_info = {
                "n_dims": int(points.shape[1]) if points.ndim == 2 else 0,
                "n_devices": 1,
            }
            return self
        t0 = time.perf_counter()
        timer = PhaseTimer()
        n_devices = self._n_devices()
        sharded = n_devices > 1 and len(points) >= 2 * n_devices
        with self._run_telemetry(points, n_devices if sharded else 1):
            # Inside the recorded region: a rejected input seals the
            # flight file with the error.
            check_finite(points)
            try:
                if sharded:
                    self._train_sharded(points, n_devices, timer)
                else:
                    self._train_single(points, timer)
            finally:
                if self._jobstate is not None:
                    # Persist what the cadence still held (a SIGKILL
                    # needs no help: every boundary write is atomic).
                    try:
                        self._jobstate.flush(force=True)
                    except OSError:
                        pass
            self.metrics_.update(timer.as_dict())
            self.metrics_["total_s"] = time.perf_counter() - t0
            self.metrics_["points_per_sec"] = len(points) / max(
                self.metrics_["total_s"], 1e-9
            )
            log_phase(
                "train", n=len(points),
                clusters=int(self.labels_.max()) + 1,
                **{k: round(v, 4) for k, v in self.metrics_.items()
                   if isinstance(v, float)},
            )
        return self

    def _reset_fit(self) -> None:
        """A new fit's clean slate: a fresh recorder and stats (no refit
        carries a previous run's telemetry) and no serving surface (a
        held engine sees the generation move and raises instead of
        serving the old fit)."""
        self._recorder = obs.RunRecorder(device=self.device)
        self.metrics_ = {}
        self._fit_info = {}
        self._sweep_stats = None
        self._hier_stats = None
        self._serve_engine = None
        self._serve_core_points = None
        self._live_model = None
        self._live_stats = None
        self.partitioner_ = None
        self._fit_generation += 1

    @contextlib.contextmanager
    def _run_telemetry(self, points, n_devices: int = 1):
        """One fit's telemetry, as the JAX package's ``train`` sets it
        up: the fit's :class:`~.obs.RunRecorder` (from
        :meth:`_reset_fit`) made current for the block, the flight file
        (``flight=`` / ``PPTORCH_FLIGHT``) with its header, the live
        exporters (``PPTORCH_METRICS_*``), the resource sampler and,
        with ``profile_dir``, ``torch.profiler``.
        On a normal exit the scalar ``metrics_`` land in the registry
        as ``run.*`` gauges; an exception seals the flight file with
        ``status="error"`` and propagates.  The sampler is joined and
        the exporters closed either way."""
        from .parallel.dist import process_index

        rec = self._recorder
        self._fit_info = {"n_dims": int(points.shape[1]),
                          "n_devices": int(n_devices)}
        flight = obs.open_flight(self.flight)
        if flight is not None:
            rec.attach_flight(flight)
            flight.header(
                params={
                    "eps": self.eps,
                    "min_samples": self.min_samples,
                    "mode": self.mode,
                    "merge": self.merge,
                    "block": self.block,
                },
                n_points=int(len(points)),
                n_dims=int(points.shape[1]),
                n_devices=int(n_devices),
                n_processes=1,
                process_index=process_index(),
                backend=self.device.type,
            )
        exporters = obs.attach_exporters(rec)
        sampler = obs.ResourceSampler(rec, device=self.device).start()
        prof = (trace(self.profile_dir) if self.profile_dir
                else contextlib.nullcontext())
        try:
            with obs.use_recorder(rec), prof:
                yield rec
            for k, v in self.metrics_.items():
                if not k.endswith("_s") and isinstance(
                        v, (bool, int, float, str, np.integer,
                            np.floating)):
                    rec.metrics.set(f"run.{k}", v)
        except BaseException as e:
            if flight is not None:
                flight.finish(
                    status="error",
                    error=f"{type(e).__name__}: {str(e)[:300]}",
                )
            raise
        finally:
            sampler.stop()
            if exporters is not None:
                exporters.close()
            if flight is not None:
                flight.finish(status="ok")  # a no-op after an error
                flight.close()

    def _n_devices(self) -> int:
        """The mesh's size, else the visible cards on the card, else 1."""
        if self.mesh is not None:
            return self.mesh.size
        if self.device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def _train_sharded(self, points, n_devices: int, timer) -> None:
        """The partitioned fit on the mesh (the JAX package's host-input
        ``_train_sharded``): the ``partition`` phase (the KD tree, its
        per-level seconds and boxes), the fused step
        (:func:`~.parallel.sharded_dbscan`), the densify, and the
        reference's parity surface from the partitions."""
        from .parallel import sharded as _sharded
        from .parallel.mesh import default_mesh
        from .partition import KDPartitioner

        mesh = self.mesh if self.mesh is not None else default_mesh()
        if self.mode == "global_morton":
            if isinstance(points, torch.Tensor):
                raise ValueError(
                    "mode='global_morton' needs host-resident input: the "
                    "global Morton keying runs on the host (a tensor on "
                    "the device takes the KD ring route)"
                )
            try:
                self._train_sharded_global_morton(points, mesh, timer)
                return
            except Exception as e:  # noqa: BLE001 — re-raised unless OOM
                from .utils.retry import is_degradable_error, note_degraded

                if not is_degradable_error(e):
                    raise
                # The terminal rung: the KD owner-computes route clusters
                # the same data with smaller peak allocations, to the
                # same labels.
                note_degraded("kd_owner_computes", mode="global_morton",
                              error=str(e)[:160])
                get_logger().warning(
                    "global-Morton engine failed terminally (%s); falling "
                    "back to the KD owner-computes route (the same "
                    "labels)", e)
        if isinstance(points, torch.Tensor):
            # A tensor is clustered where it lies (one on another device
            # type moves to the mesh's first device, as a single-device
            # fit moves it): the device-input route.
            self._train_sharded_device(points.to(mesh.device(0)), mesh,
                                       timer)
            return
        with timer.phase("partition"):
            # max_partitions is a user-facing maximum: only the default
            # takes one partition per device; the layout pads the
            # partition axis with empty slots to a mesh multiple.
            part = KDPartitioner(
                points,
                max_partitions=(n_devices if self.max_partitions is None
                                else int(self.max_partitions)),
                split_method=self.split_method,
            )
            self.partitioner_ = part
            self.metrics_["partition_levels_s"] = [
                round(float(t), 6) for t in part.level_times_s
            ]
            self.metrics_["partition_builder"] = part.builder
            self.bounding_boxes = part.bounding_boxes
            self.expanded_boxes = {
                l: b.expand(2 * self.eps)
                for l, b in part.bounding_boxes.items()
            }
        with timer.phase("cluster"):
            # A memmap takes the ring route, whose streaming build never
            # holds the dataset in host RAM (the reference's data larger
            # than one worker).
            labels, core, stats = _sharded.sharded_dbscan(
                points, part, eps=self.eps, min_samples=self.min_samples,
                metric=self._pair_metric, block=self.block, mesh=mesh,
                precision=self.precision, backend=self.kernel_backend,
                merge=self.merge,
                halo="ring" if isinstance(points, np.memmap) else "host",
                owner_computes=self.owner_computes, overlap=self.overlap,
                jobstate=self._jobstate, device=self.device,
                sketch=self.sketch,
            )
        with timer.phase("densify"):
            self.labels_ = densify_labels(labels)
        self.core_sample_mask_ = core
        self.metrics_.update(stats)
        self.metrics_["n_partitions"] = part.n_partitions
        # The reference's parity surface: each partition's 2*eps-widened
        # neighbourhood as point indices, and "partition:cluster" codes
        # whose cluster id is the global dense label.
        self.neighbors = _expanded_neighbors(part.tree, points, self.eps)
        self.cluster_dict = _partition_cluster_dict(part.result,
                                                    self.labels_)

    def _train_sharded_global_morton(self, points, mesh, timer) -> None:
        """The zero-duplication global-Morton fit on the mesh (the JAX
        package's ``_train_sharded_global_morton``): the engine
        (:func:`~.parallel.global_morton_dbscan`) inside the ``cluster``
        phase (there is no KD partition phase: the Morton keying is the
        build), the densify, and the parity surface over the ranges:
        ``partitioner_`` a :class:`~.partition.MortonRangePartitioner`,
        ``bounding_boxes`` the ranges' extents and ``neighbors`` each
        shard's OWNED rows (no expanded membership exists here).  A
        streamed memmap keeps no order, so it gets the ranges' boxes and
        no partitioner."""
        from .parallel.global_morton import global_morton_dbscan
        from .partition import MortonRangePartitioner

        with timer.phase("cluster"):
            labels, core, stats = global_morton_dbscan(
                points, eps=self.eps, min_samples=self.min_samples,
                metric=self._pair_metric, block=self.block, mesh=mesh,
                precision=self.precision, backend=self.kernel_backend,
                merge=self.merge, jobstate=self._jobstate,
                device=self.device,
            )
        parity = stats.pop("parity", None)
        with timer.phase("densify"):
            self.labels_ = densify_labels(labels)
        self.core_sample_mask_ = core
        self.metrics_.update(stats)
        self.metrics_["partition_builder"] = "morton_range"
        self.metrics_["partition_levels_s"] = []
        if parity is None:
            return
        starts = np.asarray(parity["starts"], dtype=np.int64)
        lo = np.asarray(parity["box_lo"])
        hi = np.asarray(parity["box_hi"])
        boxes = {
            s: BoundingBox(lower=lo[s], upper=hi[s])
            for s in range(min(len(lo), len(starts) - 1))
            if starts[s + 1] > starts[s]
        }
        self.metrics_["n_partitions"] = len(starts) - 1
        if boxes:
            self.bounding_boxes = boxes
            self.expanded_boxes = {
                l: b.expand(2 * self.eps) for l, b in boxes.items()
            }
        if "order" in parity:
            part = MortonRangePartitioner(parity["order"], starts, boxes)
            self.partitioner_ = part
            self.metrics_["n_partitions"] = part.n_partitions
            self.neighbors = {s: part.partitions[s] for s in part.partitions}
            self.cluster_dict = _partition_cluster_dict(part.result,
                                                        self.labels_)
        else:
            # The streaming build: ranges and boxes only (the O(N)
            # permutation is what it avoids).
            self.partitioner_ = None
            self.neighbors = None
            self.cluster_dict = {}

    def _train_sharded_device(self, points, mesh, timer) -> None:
        """The partitioned fit of a tensor on the mesh's device type (the
        JAX package's ``_train_sharded_device``): the KD split planes
        from a host subsample, then routing, layout, the ring exchange,
        clustering and the merge on the device
        (:func:`~.parallel.sharded.sharded_dbscan_device`).  The host
        gets the subsample, the ``(P,)`` counts, the ``(N,)`` labels,
        core flags and partition ids: never the ``(N, k)``
        coordinates."""
        from .parallel.sharded import sharded_dbscan_device

        with timer.phase("cluster"):
            labels, core, stats, part, pid = sharded_dbscan_device(
                points, eps=self.eps, min_samples=self.min_samples,
                metric=self._pair_metric, block=self.block, mesh=mesh,
                precision=self.precision, backend=self.kernel_backend,
                max_partitions=self.max_partitions,
                split_method=self.split_method, merge=self.merge,
                owner_computes=self.owner_computes, device=self.device,
                sketch=self.sketch,
            )
        with timer.phase("densify"):
            self.labels_ = densify_labels(labels)
        self.core_sample_mask_ = core
        self.metrics_.update(stats)
        self.metrics_["partition_levels_s"] = [
            round(float(t), 6) for t in part.level_times_s
        ]
        self.metrics_["partition_builder"] = part.builder
        # The subsample's partitioner becomes the full data's: result and
        # partitions from the routed ids, by one stable argsort.
        pid_np = pid.cpu().numpy()
        part.result = pid_np
        order = np.argsort(pid_np, kind="stable")
        uniq, starts = np.unique(pid_np[order], return_index=True)
        bounds = np.append(starts, len(order))
        part.partitions = {
            int(l): order[s:e]
            for l, s, e in zip(uniq, bounds[:-1], bounds[1:])
        }
        self.partitioner_ = part
        self.metrics_["n_partitions"] = len(part.partitions)
        # The boxes replay the split planes from an all-space root, so
        # every routed point lies in its partition's box (the
        # subsample's extents would leave out the full data's extremes).
        boxes = {0: BoundingBox(k=points.shape[1], all_space=True)}
        for parent, axis, boundary, _left, right in part.tree:
            boxes[parent], boxes[right] = boxes[parent].split(axis,
                                                              boundary)
        part.bounding_boxes = boxes
        self.bounding_boxes = boxes
        self.expanded_boxes = {
            l: b.expand(2 * self.eps) for l, b in boxes.items()
        }
        # ``neighbors`` keeps its meaning on this route, computed on first
        # access: it needs the host coordinates the fit never fetches.
        self.neighbors = None
        self._neighbors_lazy = True
        self.cluster_dict = _partition_cluster_dict(pid_np, self.labels_)

    def _train_single(self, points, timer) -> None:
        # A previous sharded fit's partitioner describes other data.
        self.partitioner_ = None
        with timer.phase("cluster"):
            # _pad_and_run returns host arrays: the phase covers the
            # device work.
            roots, core, info = _pad_and_run(
                points, self.eps, self.min_samples, self.block,
                precision=self.precision, backend=self.kernel_backend,
                device=self.device, sketch=self.sketch,
                metric=self._pair_metric, jobstate=self._jobstate,
            )
        with timer.phase("densify"):
            labels = densify_labels(roots)
        self.metrics_["n_partitions"] = 1
        self.metrics_.update(info)
        if isinstance(points, torch.Tensor):
            both = torch.stack(
                [points.amin(dim=0), points.amax(dim=0)]
            ).double().cpu().numpy()
            lo, hi = both[0], both[1]
        else:
            lo, hi = points.min(axis=0), points.max(axis=0)
        self._set_fit(labels, core, lo, hi)

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
        is clustered where it lies, without a host round trip (a cosine
        or haversine frame is projected on the host, see
        :meth:`_driver_frame_rows`)."""
        if isinstance(X, (torch.Tensor, np.memmap)):
            return self.train(X)
        return self.train(np.asarray(X))

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).labels_

    # -- amortized hyperparameter sweeps ----------------------------------

    def sweep(self, data, eps_list, min_samples_list=None) -> SweepResult:
        """Fit every ``(eps, min_samples)`` config from ONE distance pass.

        On the card this is not yet a speed-up: until the emission has
        a kernel (ROADMAP A13), building the graph in torch ops takes
        longer than the per-config fits it replaces (16 configs at 1M x
        16-D: a 6.0 s sweep against 2.3 s of fits on an NVIDIA H100 80GB
        HBM3 at 700 W, ``chip_smoke.py`` phase 9.4).  Its use today is
        one distance pass and exact per-config labels.

        The layout and the neighbour-pair graph are built once at
        ``eps_max = max(eps_list)`` (in the kernel frame), and each
        config re-thresholds the cached distances and relabels over the
        cached pairs (:func:`~.ops.pipeline.sweep_config_pack`): each
        config's labels and core mask are byte-identical to a fit at
        that config.  The grid is ``eps_list x min_samples_list``
        (None: this model's ``min_samples``), eps-major; the order of
        ``eps_list`` does not change any config's result.  A graph past
        ``PPTORCH_SWEEP_MAX_PAIRS`` runs per-config fits instead
        (``stats["degraded"] == "per_config_refit"``), and so does
        ``precision="default"``, whose bf16 verdicts depend on each
        fit's tile frames.  The model is left fitted at the last
        config.

        The route is ``fit``'s (the JAX package's): host input of at
        least two points per device on more than one device builds the
        graph over the KD route's owner-computes slabs, halos at
        ``2 * eps_max`` (``stats["mode"] == "kd"``), or under
        ``mode="global_morton"`` over the Morton ranges and their
        boundary tiles; each config's labels are then the sharded fit's
        (min-core-gid roots) and ``stats`` carries ``owner_computes``,
        ``dispatch`` and ``n_devices``.  A tensor, or one device, takes
        the single-card graph.  A graph past the cap, or an OOM-class
        error while it is built, runs per-config fits on the model's
        route (``note_degraded("sweep_refit")``); a later sweep or
        eps=None fit on the same data and route whose ceiling is at most
        the cached one reuses the graph.

        ``eps_list="auto"`` takes the eps ladder from the density
        hierarchy (:meth:`_sweep_auto_run`): the top
        ``PPTORCH_HIER_LADDER_K`` (default 8) stability cuts of the
        first min_samples' hierarchy, each rung labelled by a cut of its
        min_samples' hierarchy over the same graph, byte-identical to a
        fit at it (at ``"high"`` when ``precision="default"``: the graph
        is exact in every mode); ``stats`` then carries ``eps_source``, ``ladder`` and
        the ``hierarchy`` block.  It needs the graph: past the cap it
        raises instead of refitting.
        """
        auto_ladder = isinstance(eps_list, str)
        if auto_ladder and eps_list != "auto":
            raise ValueError(
                f"eps_list must be a sequence of eps values or the "
                f"string 'auto', got {eps_list!r}"
            )
        if not auto_ladder:
            eps_arr = np.atleast_1d(np.asarray(eps_list, np.float64))
            if eps_arr.ndim != 1 or len(eps_arr) == 0:
                raise ValueError(
                    "eps_list must be a non-empty 1-D sequence"
                )
            eps_vals = [float(e) for e in eps_arr]
            for e in eps_vals:
                validate_params(e, 1)
                check_metric(self.metric, e)
        if min_samples_list is None:
            ms_vals = [int(self.min_samples)]
        else:
            ms_arr = np.atleast_1d(np.asarray(min_samples_list))
            if ms_arr.ndim != 1 or len(ms_arr) == 0:
                raise ValueError(
                    "min_samples_list must be None or a non-empty 1-D "
                    "sequence"
                )
            ms_vals = [int(m) for m in ms_arr]
        for m in ms_vals:
            validate_params(1.0, m)
        configs = (
            None if auto_ladder
            else [(e, m) for e in eps_vals for m in ms_vals]
        )

        keys, points = _as_keys_points(data)
        if self._metric_norm in ("cosine", "haversine"):
            points = self._driver_frame_rows(points)
        if len(points) == 0:
            raise ValueError("sweep needs a non-empty dataset")
        t0 = time.perf_counter()
        self._reset_fit()
        self._keys = keys
        self.data = points
        self._result_cache = None
        self.bounding_boxes = self.expanded_boxes = None
        self.neighbors = None
        self.cluster_dict = None
        timer = PhaseTimer()
        with self._run_telemetry(points):
            check_finite(points)
            with self._kernel_frame():
                if auto_ladder:
                    labels, core, per_cfg, sweep = self._sweep_auto_run(
                        points, ms_vals, timer)
                    configs = [tuple(c) for c in sweep["configs"]]
                else:
                    labels, core, per_cfg, sweep = self._sweep_run(
                        points, configs, timer)
            last = configs[-1]
            self.eps_ = float(last[0])
            self.labels_ = labels[last]
            self.core_sample_mask_ = core[last]
            self.metrics_.update(timer.as_dict())
            wall = time.perf_counter() - t0
            self.metrics_["total_s"] = wall
            self.metrics_["points_per_sec"] = (
                len(configs) * len(points) / max(wall, 1e-9)
            )
            self.metrics_["live_pairs"] = int(sweep["graph_pairs"])
            self._staging_metrics()
            sweep["sweep_wall_s"] = round(wall, 6)
            # An estimate from the sweep's own walls, taking a fit as one
            # graph build plus one relabel (no fit is run to measure it).
            solo = sweep["graph_build_s"] + (
                sweep["relabel_s"][0] if sweep["relabel_s"] else 0.0
            )
            sweep["sweep_amortization_est"] = round(
                len(configs) * solo / max(wall, 1e-9), 4
            )
            self._sweep_stats = sweep
            self._fit_info["n_devices"] = int(sweep["n_devices"])
            log_phase(
                "sweep", n=len(points), k=len(configs),
                distance_passes=sweep["distance_passes"],
                graph_pairs=sweep["graph_pairs"], seconds=round(wall, 4),
            )
        return SweepResult(configs, labels, core, per_cfg, sweep)

    def _sharded_gate(self, points):
        """``(run_mode, n_devices)`` of a sweep or eps=None fit, as the
        JAX package routes them: host input of at least two points per
        device on more than one device takes the KD graph, or under
        ``mode="global_morton"`` the global-Morton graph; a tensor and a
        single device take the fused graph on one device."""
        n_devices = self._n_devices()
        if (not isinstance(points, torch.Tensor) and n_devices > 1
                and len(points) >= 2 * n_devices):
            return ("global_morton" if self.mode == "global_morton"
                    else "kd"), n_devices
        return "fused", 1

    def _graph_route(self, run_mode, points, eps_max, timer, n_devices):
        """The graph at ``eps_max`` on ``run_mode``'s route: ``(relabel,
        gstats, ghandle)`` (see :meth:`_sweep_graph_fused`)."""
        if run_mode == "global_morton":
            return self._sweep_graph_global(points, eps_max, timer)
        if run_mode == "kd":
            return self._sweep_graph_kd(points, eps_max, timer, n_devices)
        return self._sweep_graph_fused(points, eps_max, timer)

    def _graph_metrics(self, gstats) -> None:
        """The graph's partition gauges into ``metrics_``, as the JAX
        package reports them."""
        self.metrics_["n_partitions"] = int(gstats.get("n_partitions", 1))
        for k_ in ("boundary_tiles", "boundary_tile_bytes", "halo_factor",
                   "halo_bytes", "partition_sizes"):
            if k_ in gstats:
                self.metrics_[k_] = gstats[k_]

    def _sweep_run(self, points, configs, timer):
        """The graph and one relabel per config (kernel frame), or the
        per-config fits when the graph is past its cap, an OOM-class
        error stops it (``note_degraded("sweep_refit")``, as in the JAX
        package) or the mode is ``"default"``.  The route is the JAX
        package's (:meth:`_sharded_gate`)."""
        from .parallel import staging
        from .utils.retry import is_degradable_error, note_degraded

        eps_k = [_kernel_eps(self._metric_norm, e) for e, _ in configs]
        staging.begin_fit()
        if self.precision == "default":
            return self._sweep_refit(points, configs, timer)
        run_mode, n_devices = self._sharded_gate(points)
        try:
            relabel, gstats, _gh = self._graph_route(
                run_mode, points, max(eps_k), timer, n_devices)
        except Exception as e:  # noqa: BLE001 — re-raised unless degradable
            if not (isinstance(e, SweepGraphOverflow)
                    or is_degradable_error(e)):
                raise
            note_degraded("sweep_refit", error=str(e)[:160])
            get_logger().warning(
                "sweep graph unavailable (%s); running per-config fits: "
                "labels stay exact, one distance pass per config", e,
            )
            return self._sweep_refit(points, configs, timer)
        labels_out, core_out, per_cfg, relabel_s = {}, {}, [], []
        passes_total = 0
        reused_before = staging.fit_stats()[0]
        for i, (cfg, e_k) in enumerate(zip(configs, eps_k)):
            t_c = time.perf_counter()
            if i:
                # Configs 2..k re-threshold the graph the first config
                # staged: their reuse counts as a warm hit's.
                staging.touch_route(staging.SWEEP_GRAPH_ROUTE)
            with timer.phase("relabel"):
                roots, cor, passes = relabel(e_k, cfg[1])
            reused_now = staging.fit_stats()[0]
            with timer.phase("densify"):
                dense = densify_labels(roots)
            labels_out[cfg] = dense
            core_out[cfg] = cor
            passes_total += int(passes)
            dt = time.perf_counter() - t_c
            relabel_s.append(round(dt, 6))
            per_cfg.append({
                "eps": cfg[0], "min_samples": cfg[1],
                "relabel_s": round(dt, 6),
                "n_clusters": int(dense.max()) + 1, "passes": int(passes),
                "staged_bytes_reused": int(reused_now - reused_before),
            })
            reused_before = reused_now
        self.metrics_["kernel_passes"] = passes_total + 1
        self._graph_metrics(gstats)
        sweep = {
            "k": len(configs),
            "configs": [[e, m] for e, m in configs],
            "distance_passes": 1,
            "graph_pairs": gstats["graph_pairs"],
            "graph_bytes": gstats["graph_bytes"],
            "graph_build_s": round(gstats["build_s"], 6),
            "relabel_s": relabel_s,
            **self._route_block(run_mode, n_devices, gstats, len(points)),
            "degraded": None,
        }
        return labels_out, core_out, per_cfg, sweep

    def _route_block(self, run_mode, n_devices, gstats, n) -> Dict:
        """The sweep block's route keys (the JAX package's): ``mode``,
        ``owner_computes`` (every route but the fused one), ``dispatch``
        and ``n_devices``."""
        return {
            "mode": run_mode,
            "owner_computes": run_mode != "fused",
            "dispatch": dispatch_tag(
                int(gstats.get("owned_cap", n)) // max(self.block, 1)),
            "n_devices": int(n_devices),
        }

    def _sweep_graph_fused(self, points, eps_max, timer):
        """Layout and graph at ``eps_max`` (kernel frame) with the
        exact-total retry; returns ``(relabel, gstats, ghandle)``:
        ``relabel(eps, min_samples) -> (roots, core, passes)`` in input
        order, and the hierarchy's handle on the graph, ``{gi, gj, dv,
        mask, n_ids, finalize}`` in kernel-slot space, ``finalize(roots,
        core)`` mapping slot-space results to input rows as a fit's
        pack does.  The build is ``timer``'s ``graph`` phase; an
        emission overflow records ``pair_overflow`` (``route=
        "sweep_graph"``) before its exact-total retry.

        Host input goes through the staging cache (the JAX package's
        routes): the graph through the eps-free ``sweep_graph`` route
        (:func:`~.parallel.staging.device_get_cover`: a later sweep, or
        eps=None fit, whose ceiling is at most the cached one rebuilds
        nothing), the layout through ``pipeline_layout`` at eps_max,
        each key with the device.  A tensor is never cached."""
        from .ops.distances import sweep_max_edges
        from .ops.pipeline import sweep_config_pack, sweep_graph_pipeline
        from .parallel import staging

        t_b = time.perf_counter()
        n, k = points.shape
        block = clamp_block(self.block, n)
        cap = round_up(n, block)
        sort = n > 2 * block
        layout_key = route_key = cached = None
        if (not isinstance(points, torch.Tensor)
                and _layout_cacheable(cap, k)):
            fp = staging.points_fingerprint(points)
            dev_s = str(self.device)
            layout_key = (fp, block, cap, sort, self.precision,
                          float(eps_max), dev_s)
            route_key = ("fused", fp, block, cap, sort, self.precision,
                         str(self.metric), dev_s)
            cached = staging.device_get_cover(
                staging.SWEEP_GRAPH_ROUTE, route_key, eps_max)
        cap_edges = sweep_max_edges()
        if cached is not None:
            graph, mask_k, owner = cached[0][:3], cached[0][3], cached[0][4]
            stats, cap = cached[1]["stats"], int(cached[1]["cap"])
            need_e = int(stats[0])
            if need_e > cap_edges:
                # The cap binds a cached graph too.
                raise SweepGraphOverflow(
                    f"neighbour-pair graph needs more than {cap_edges} "
                    f"edges, the sweep cap (PPTORCH_SWEEP_MAX_PAIRS)"
                )
        else:
            with timer.phase("graph"):
                staged = []

                def points_t():
                    if not staged:
                        staged.append(_stage(points, self.block,
                                             self.device)[0])
                    return staged[0]

                eb = None
                for attempt in (0, 1):
                    graph, mask_k, owner, cap, stats = sweep_graph_pipeline(
                        points_t, eps_max, n, metric=self._pair_metric,
                        block=block, precision=self.precision, sort=sort,
                        edge_budget=eb, edge_cap=cap_edges,
                        layout_key=layout_key,
                    )
                    need_e, got_e = stats[0], stats[1]
                    if need_e > cap_edges:
                        raise SweepGraphOverflow(
                            f"neighbour-pair graph needs more than "
                            f"{cap_edges} edges, the sweep cap "
                            f"(PPTORCH_SWEEP_MAX_PAIRS)"
                        )
                    if need_e <= got_e:
                        break
                    if attempt:
                        raise SweepGraphOverflow(
                            f"graph emission overflow persisted after an "
                            f"exact-total retry ({need_e}/{got_e})"
                        )
                    obs.event("pair_overflow", total=int(need_e),
                              budget=int(got_e), route="sweep_graph")
                    eb = round_up(need_e, 4096)
                del staged
                if route_key is not None:
                    staging.device_put_cached(
                        staging.SWEEP_GRAPH_ROUTE, route_key,
                        (*graph, mask_k, owner),
                        aux={"eps_max": float(eps_max), "cap": cap,
                             "stats": [int(v) for v in stats]},
                    )
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        gi, gj, dv = (t[:need_e] for t in graph)
        gi, gj = gi.long(), gj.long()
        metric = self._pair_metric

        def relabel(eps_c, ms_c):
            packed = sweep_config_pack(
                gi, gj, dv, mask_k, owner, eps_c, ms_c, stats, cap=cap,
                metric=metric,
            )
            roots, core, _t, _b, passes, _bp, _rs = (
                unpack_pipeline_result(packed)
            )
            return roots[:n], core[:n], passes

        def finalize(roots_s, core_s):
            row, stats0 = _pipeline_pack(
                roots_s, core_s, torch.zeros(5, dtype=torch.int64), owner,
                cap=cap,
            )
            roots, core, *_stats = unpack_pipeline_result(
                (row.numpy(), stats0.numpy()))
            return roots[:n], core[:n]

        gstats = {
            "graph_pairs": int(need_e),
            "graph_bytes": int(need_e) * 12,
            "build_s": time.perf_counter() - t_b,
        }
        ghandle = {
            "gi": gi, "gj": gj, "dv": dv, "mask": mask_k,
            "n_ids": int(mask_k.shape[0]), "finalize": finalize,
        }
        return relabel, gstats, ghandle

    def _graph_mesh(self):
        """The mesh a sharded graph runs on: the model's, else every
        visible card."""
        from .parallel.mesh import default_mesh

        return self.mesh if self.mesh is not None else default_mesh()

    def _sweep_graph_kd(self, points, eps_max, timer, n_devices):
        """The KD route's graph (the JAX ``_sweep_graph_kd``): the
        partition, the parity surface at the graph's halo radius (the
        boxes widened by 2 * eps_max: every config under the ceiling is
        covered) and :func:`~.parallel.sharded.sweep_graph_sharded`'s
        owner-computes slabs at eps_max."""
        from .parallel.sharded import sweep_graph_sharded
        from .partition import KDPartitioner

        with timer.phase("partition"):
            part = KDPartitioner(
                points,
                max_partitions=(n_devices if self.max_partitions is None
                                else int(self.max_partitions)),
                split_method=self.split_method,
            )
            self.partitioner_ = part
            self.metrics_["partition_levels_s"] = [
                round(float(t), 6) for t in part.level_times_s
            ]
            self.metrics_["partition_builder"] = part.builder
            self.bounding_boxes = part.bounding_boxes
            self.expanded_boxes = {
                l: b.expand(2 * eps_max)
                for l, b in part.bounding_boxes.items()
            }
        mesh = self._graph_mesh()
        return self._global_relabel(
            "kd", points, eps_max, timer, mesh,
            lambda: sweep_graph_sharded(
                points, part, eps_max, block=self.block, mesh=mesh,
                metric=self._pair_metric, device=self.device),
            (self.max_partitions, self.split_method))

    def _sweep_graph_global(self, points, eps_max, timer):
        """The global-Morton route's graph (the JAX
        ``_sweep_graph_global``): Morton ranges and the boundary tiles at
        eps_max (:func:`~.parallel.global_morton.
        sweep_graph_global_morton`), no duplicated rows.  A tensor input
        raises ``ValueError``, as the fit does."""
        from .parallel.global_morton import sweep_graph_global_morton

        if isinstance(points, torch.Tensor):
            raise ValueError(
                "mode='global_morton' needs host-resident input (the same "
                "restriction as the fit)"
            )
        mesh = self._graph_mesh()
        out = self._global_relabel(
            "global_morton", points, eps_max, timer, mesh,
            lambda: sweep_graph_global_morton(
                points, eps_max, block=self.block, mesh=mesh,
                metric=self._pair_metric, device=self.device))
        self.metrics_["partition_builder"] = "morton_range"
        self.metrics_["partition_levels_s"] = []
        return out

    def _global_relabel(self, run_mode, points, eps_max, timer, mesh, build,
                        extra_key=()):
        """A global-id graph and its per-config relabel (the JAX
        ``_global_relabel``): ``build()`` (in ``timer``'s ``graph``
        phase) returns ``((gi, gj, dval), gstats)`` on the mesh's first
        device; the graph goes on the ``sweep_graph`` staging route, and
        the relabel is :func:`~.ops.labels.graph_dbscan` on that device,
        whose roots are the least core gid of each cluster (the sharded
        routes' canonical labels).  The route's key holds the input's
        fingerprint besides the JAX key's ``(mode, n, block, precision,
        metric)``, and its entry the ceiling it was built at, so a later
        sweep or eps=None fit under that ceiling builds nothing (a
        cached graph counts whole against ``PPTORCH_SWEEP_MAX_PAIRS``,
        as a fresh one does once its slabs are joined).
        Returns ``(relabel, gstats, ghandle)``; the handle's
        ``finalize`` is the identity slice."""
        from .ops.distances import sweep_max_edges
        from .ops.labels import graph_dbscan
        from .parallel import staging

        t_b = time.perf_counter()
        n = len(points)
        key = (run_mode, staging.points_fingerprint(points), n,
               int(self.block), self.precision, str(self.metric),
               tuple(str(mesh.device(s)) for s in range(mesh.size)),
               *extra_key)
        cached = staging.device_get_cover(staging.SWEEP_GRAPH_ROUTE, key,
                                          eps_max)
        if cached is not None:
            (gi, gj, dv), gstats = cached[0], dict(cached[1]["stats"])
            if gstats["graph_pairs"] > sweep_max_edges():
                raise SweepGraphOverflow(
                    f"the cached neighbour-pair graph holds "
                    f"{gstats['graph_pairs']} edges, past the sweep cap "
                    f"(PPTORCH_SWEEP_MAX_PAIRS)"
                )
        else:
            with timer.phase("graph"):
                (gi, gj, dv), gstats = build()
                staging.device_put_cached(
                    staging.SWEEP_GRAPH_ROUTE, key, (gi, gj, dv),
                    aux={"eps_max": float(eps_max), "stats": dict(gstats)})
                if gi.device.type == "cuda":
                    torch.cuda.synchronize(gi.device)
        gi_l, gj_l = gi.long(), gj.long()
        mask = torch.ones(n, dtype=torch.bool, device=gi.device)
        metric = self._pair_metric

        def relabel(eps_c, ms_c):
            lab, cor, passes = graph_dbscan(gi_l, gj_l, dv, mask, eps_c,
                                            ms_c, metric=metric)
            return lab.cpu().numpy(), cor.cpu().numpy(), int(passes)

        def finalize(lab, cor):
            return (lab[:n].cpu().numpy().astype(np.int32),
                    cor[:n].cpu().numpy().astype(bool))

        gstats["build_s"] = time.perf_counter() - t_b
        ghandle = {"gi": gi_l, "gj": gj_l, "dv": dv, "mask": mask,
                   "n_ids": n, "finalize": finalize}
        return relabel, gstats, ghandle

    def _staging_metrics(self) -> None:
        """The staging cache's counters of this sweep or eps=None fit
        (those of its last fit, after per-config refits, as in the JAX
        package) into ``metrics_``, unless a fit set them."""
        from .parallel import staging

        reused, shipped = staging.fit_stats()
        self.metrics_.setdefault("staged_bytes_reused", int(reused))
        self.metrics_.setdefault("staged_bytes", int(shipped))

    def _sweep_refit(self, points, configs, timer):
        """Per-config fits (one distance pass each) on the kernel-frame
        points, on the model's route (its mesh and sharding knobs): the
        sweep's label-safe fallback."""
        labels_out, core_out, per_cfg, relabel_s = {}, {}, [], []
        for cfg in configs:
            e_u, ms = cfg
            t_c = time.perf_counter()
            m = DBSCAN(
                eps=_kernel_eps(self._metric_norm, e_u), min_samples=ms,
                metric=self._pair_metric, block=self.block,
                precision=self.precision,
                kernel_backend=self.kernel_backend, device=self.device,
                sketch=self.sketch, max_partitions=self.max_partitions,
                split_method=self.split_method, mesh=self.mesh,
                merge=self.merge, owner_computes=self.owner_computes,
                overlap=self.overlap, mode=self.mode,
            )
            with timer.phase("refit"):
                m.train(points)
            labels_out[cfg] = np.asarray(m.labels_)
            core_out[cfg] = np.asarray(m.core_sample_mask_)
            dt = time.perf_counter() - t_c
            relabel_s.append(round(dt, 6))
            per_cfg.append({
                "eps": e_u, "min_samples": ms, "relabel_s": round(dt, 6),
                "n_clusters": int(labels_out[cfg].max()) + 1, "passes": 0,
            })
        self.metrics_["n_partitions"] = 1
        sweep = {
            "k": len(configs),
            "configs": [[e, m_] for e, m_ in configs],
            "distance_passes": len(configs),
            "graph_pairs": 0,
            "graph_bytes": 0,
            "graph_build_s": 0.0,
            "relabel_s": relabel_s,
            "mode": self.mode,
            "owner_computes": False,
            "dispatch": dispatch_tag(None),
            "degraded": "per_config_refit",
            "n_devices": int(self._n_devices()),
        }
        return labels_out, core_out, per_cfg, sweep

    # -- density hierarchy (eps-free fits) --------------------------------

    def _user_eps_from_kernel(self, eps_k: float) -> float:
        """Kernel-frame eps -> user frame (the inverse of
        :attr:`kernel_eps`)."""
        if self._metric_norm == "cosine":
            return float(eps_k) ** 2 / 2.0
        if self._metric_norm == "haversine":
            return float(2.0 * np.arcsin(min(float(eps_k) / 2.0, 1.0)))
        return float(eps_k)

    def _hier_ceiling(self, points) -> float:
        """The hierarchy's eps_max in the kernel frame: the graph is
        built at it, and the family is truncated there.

        In order: a concrete model eps (``sweep("auto")`` on a fitted-eps
        model; inside :meth:`_kernel_frame`, so already remapped), then
        ``PPTORCH_HIER_EPS_MAX`` (user frame), else a sample-kNN
        heuristic on the host in numpy, bit for bit the JAX package's:
        4x the 98th percentile of the ``min_samples``-th neighbour
        distance over a strided ``PPTORCH_HIER_SAMPLE``-row sample
        (default 2048), an overestimate of the core distances (a sample
        is sparser than the whole set).  A tensor sends only its sample
        rows to the host."""
        if self.eps is not None:
            return float(self.eps)
        env = os.environ.get("PPTORCH_HIER_EPS_MAX")
        if env:
            e_u = float(env)
            validate_params(e_u, 1)
            return _kernel_eps(self._metric_norm, e_u)
        n = len(points)
        s_max = max(
            2, min(int(os.environ.get("PPTORCH_HIER_SAMPLE", "2048")), n)
        )
        step = max(1, n // s_max)
        if isinstance(points, torch.Tensor):
            sample = points[::step][:s_max].to(torch.float32).cpu().numpy()
        else:
            sample = np.asarray(points[::step][:s_max], np.float32)
        s = len(sample)
        k = min(max(self.min_samples, 2), s - 1)
        if self._pair_metric == "cityblock":
            dk = np.empty(s, np.float32)
            for lo in range(0, s, 256):
                hi = min(lo + 256, s)
                d = np.abs(
                    sample[lo:hi, None, :] - sample[None, :, :]
                ).sum(-1)
                dk[lo:hi] = np.partition(d, k, axis=1)[:, k]
        else:
            sq = (sample * sample).sum(-1)
            d2 = np.maximum(
                sq[:, None] + sq[None, :] - 2.0 * (sample @ sample.T),
                0.0,
            )
            dk = np.sqrt(np.partition(d2, k, axis=1)[:, k])
        ceil = 4.0 * float(np.quantile(dk.astype(np.float64), 0.98))
        if self._metric_norm in ("cosine", "haversine"):
            # A unit-sphere chord past 2 takes in every pair: it only
            # inflates the graph.
            ceil = min(ceil, 1.999)
        return max(ceil, 1e-6)

    def _hier_run(self, points, timer, ms: Optional[int] = None):
        """Graph and hierarchy (kernel frame), the eps-free front half
        of :meth:`_sweep_run`, on its route (:meth:`_sharded_gate`).
        Returns a context dict: ``hier`` (the ``ms`` hierarchy),
        ``build`` (ms -> another hierarchy over the same prepared slab:
        core pass and MST, no new distance work), ``gh``, ``gstats``,
        ``run_mode``, ``n_devices``, ``eps_max_k`` and ``stages``
        (seconds of the graph build and the prepare)."""
        from .ops import hierarchy as _hier

        ms = int(self.min_samples if ms is None else ms)
        eps_max = self._hier_ceiling(points)
        from .parallel import staging

        staging.begin_fit()
        run_mode, n_devices = self._sharded_gate(points)
        _relabel, gstats, gh = self._graph_route(
            run_mode, points, eps_max, timer, n_devices)
        km = self._pair_metric
        eps_f = np.float32(eps_max)
        thr_max = float(eps_f * eps_f if km == "euclidean" else eps_f)
        gh, gstats = _graph_under_ceiling(gh, gstats, thr_max)
        with timer.phase("hierarchy"):
            t0 = time.perf_counter()
            state = _hier.hierarchy_prepare(gh["gi"], gh["gj"], gh["dv"])
            _hier._sync(self.device)
            t1 = time.perf_counter()

            def build(ms_c: int):
                return _hier.build_hierarchy(
                    state, gh["mask"], gh["n_ids"], int(ms_c),
                    kernel_metric=km, user_frame=self._metric_norm,
                    thr_max=thr_max, min_cluster_size=self.min_cluster_size,
                )

            hier = build(ms)
        return {
            "hier": hier, "build": build, "gh": gh, "gstats": gstats,
            "run_mode": run_mode, "n_devices": int(n_devices),
            "eps_max_k": float(eps_max),
            "stages": {"graph_build_s": gstats["build_s"],
                       "prepare_s": t1 - t0},
        }

    def _hier_no_refit(self, e: Exception) -> RuntimeError:
        return RuntimeError(
            f"the density-hierarchy path needs the cached pair graph "
            f"and cannot degrade to per-config refits (there is no eps "
            f"to refit at): {e}.  Raise PPTORCH_SWEEP_MAX_PAIRS, or "
            f"lower the graph ceiling via PPTORCH_HIER_EPS_MAX."
        )

    def _hier_guarded(self, points, timer, ms: Optional[int] = None):
        """:meth:`_hier_run`, a graph past its cap or an OOM-class error
        raising the no-refit error, as in the JAX package."""
        from .utils.retry import is_degradable_error

        try:
            return self._hier_run(points, timer, ms)
        except Exception as e:  # noqa: BLE001 — re-raised unless degradable
            if not (isinstance(e, SweepGraphOverflow)
                    or is_degradable_error(e)):
                raise
            raise self._hier_no_refit(e) from e

    def _fit_hierarchy(self, data) -> "DBSCAN":
        """The eps=None fit: one distance pass, stability-selected eps.

        The pair graph at a data-derived ceiling, per-point core
        distances, the mutual-reachability MST (Borůvka rounds), the
        tree condensed by ``min_cluster_size`` and HDBSCAN*'s
        excess-of-mass rule pick the flat cut.  ``labels_`` are
        byte-identical to ``fit(eps_)`` on the same device, and every
        step is deterministic given the data and the environment.  The
        graph's d^2 is exact in every precision mode, so at
        ``precision="default"`` they are ``fit(eps_)``'s at ``"high"``;
        a ``"default"`` fit at ``eps_`` decides pairs in bf16 and may
        differ."""
        from .ops import hierarchy as _hier

        keys, points = _as_keys_points(data)
        if self._metric_norm in ("cosine", "haversine"):
            points = self._driver_frame_rows(points)
        if len(points) == 0:
            raise ValueError("eps=None fits need a non-empty dataset")
        t0 = time.perf_counter()
        self._reset_fit()
        self._keys = keys
        self.data = points
        self._result_cache = None
        self.bounding_boxes = self.expanded_boxes = None
        self.neighbors = None
        self.cluster_dict = None
        timer = PhaseTimer()
        with self._run_telemetry(points):
            check_finite(points)
            with self._kernel_frame():
                ctx = self._hier_guarded(points, timer)
                hier = ctx["hier"]
                t = time.perf_counter()
                _thr_star, eps_u = hier.select_cut()
                t_cut = time.perf_counter()
                # Label at the round trip of eps_ (not the raw cut
                # weight): the labels then equal fit(eps_) by
                # construction.
                thr_rt = float(
                    _hier.thr_from_user_eps(eps_u, self._metric_norm))
                with timer.phase("relabel"):
                    lab_s, core_s = hier.labels_at_thr(thr_rt)
                    lab, core = ctx["gh"]["finalize"](lab_s, core_s)
                with timer.phase("densify"):
                    dense = densify_labels(lab)
                t_rel = time.perf_counter()
            self.labels_ = dense
            self.core_sample_mask_ = np.asarray(core, bool)
            self.eps_ = float(eps_u)
            self.metrics_.update(timer.as_dict())
            self.metrics_["total_s"] = time.perf_counter() - t0
            self.metrics_["points_per_sec"] = len(points) / max(
                self.metrics_["total_s"], 1e-9
            )
            self.metrics_["live_pairs"] = int(ctx["gstats"]["graph_pairs"])
            self._staging_metrics()
            self.metrics_["n_partitions"] = int(
                ctx["gstats"].get("n_partitions", 1))
            self.metrics_["kernel_passes"] = 2
            self._fit_info["n_devices"] = ctx["n_devices"]
            ctx["stages"].update(cut_s=t_cut - t, relabel_s=t_rel - t_cut)
            self._hier_stats = self._hier_block(ctx, eps_selected=eps_u)
            log_phase(
                "hierarchy", n=len(points),
                mst_edges=self._hier_stats["mst_edges"],
                boruvka_rounds=self._hier_stats["boruvka_rounds"],
                eps_selected=round(float(eps_u), 6),
                seconds=round(self.metrics_["total_s"], 4),
            )
        return self

    def _hier_block(self, ctx, eps_selected, ladder=None) -> Dict:
        """The hierarchy's stats block (the JAX package's
        ``report()["hierarchy"]`` keys, user-frame values) with each
        stage's seconds."""
        gstats = ctx["gstats"]
        block = dict(ctx["hier"].telemetry())
        block.update(
            distance_passes=1,
            graph_pairs=int(gstats["graph_pairs"]),
            graph_bytes=int(gstats["graph_bytes"]),
            graph_build_s=round(float(gstats["build_s"]), 6),
            mode=ctx["run_mode"],
            n_devices=int(ctx["n_devices"]),
            eps_max=self._user_eps_from_kernel(ctx["eps_max_k"]),
            eps_selected=float(eps_selected),
            min_samples=int(ctx["hier"].min_samples),
        )
        block.update({k: round(float(v), 6)
                      for k, v in ctx["stages"].items()})
        if ladder is not None:
            block["ladder"] = [float(e) for e in ladder]
        return block

    def _sweep_auto_run(self, points, ms_vals, timer):
        """Ladder extraction and per-rung cuts (kernel frame).

        The ladder comes from the first min_samples' hierarchy (its top
        stability cuts); each ``(eps, ms)`` rung is a cut of that ms's
        hierarchy (a union-find over about n MST edges and one border
        attach, no per-config fixpoint), byte-identical to a fit at it.
        """
        from .ops import hierarchy as _hier

        ctx = self._hier_guarded(points, timer, ms=ms_vals[0])
        k = int(os.environ.get("PPTORCH_HIER_LADDER_K", "8"))
        hier0 = ctx["hier"]
        t = time.perf_counter()
        _thr_star, eps_sel = hier0.select_cut()
        ladder = hier0.eps_ladder(k)
        ctx["stages"]["cut_s"] = time.perf_counter() - t
        if not ladder:
            raise RuntimeError(
                "eps_list='auto' found no positive cuts to ladder "
                "(degenerate pair graph: every point isolated at the "
                "ceiling?)"
            )
        hiers = {int(ms_vals[0]): hier0}
        for ms in ms_vals[1:]:
            if int(ms) not in hiers:
                with timer.phase("hierarchy"):
                    hiers[int(ms)] = ctx["build"](ms)
        configs = [(float(e), int(m)) for e in ladder for m in ms_vals]
        gh = ctx["gh"]
        labels_out, core_out, per_cfg, relabel_s = {}, {}, [], []
        for cfg in configs:
            e_u, ms = cfg
            t_c = time.perf_counter()
            thr = float(_hier.thr_from_user_eps(e_u, self._metric_norm))
            with timer.phase("relabel"):
                lab_s, core_s = hiers[ms].labels_at_thr(thr)
                lab, core = gh["finalize"](lab_s, core_s)
            with timer.phase("densify"):
                dense = densify_labels(lab)
            labels_out[cfg] = dense
            core_out[cfg] = np.asarray(core, bool)
            dt = time.perf_counter() - t_c
            relabel_s.append(round(dt, 6))
            per_cfg.append({
                "eps": e_u, "min_samples": ms, "relabel_s": round(dt, 6),
                "n_clusters": int(dense.max()) + 1, "passes": 1,
            })
        self.metrics_["kernel_passes"] = len(configs) + 1
        gstats = ctx["gstats"]
        self._graph_metrics(gstats)
        ctx["stages"]["relabel_s"] = sum(relabel_s)
        self._hier_stats = self._hier_block(
            ctx, eps_selected=eps_sel, ladder=ladder
        )
        sweep = {
            "k": len(configs),
            "configs": [[e, m] for e, m in configs],
            "distance_passes": 1,
            "graph_pairs": int(gstats["graph_pairs"]),
            "graph_bytes": int(gstats["graph_bytes"]),
            "graph_build_s": round(float(gstats["build_s"]), 6),
            "relabel_s": relabel_s,
            **self._route_block(ctx["run_mode"], ctx["n_devices"], gstats,
                                len(points)),
            "degraded": None,
            "eps_source": "hierarchy_auto",
            "ladder": [float(e) for e in ladder],
            "hierarchy": self._hier_stats,
        }
        return labels_out, core_out, per_cfg, sweep

    # -- results ----------------------------------------------------------

    # ``labels_``, ``core_sample_mask_`` and ``data`` are properties so
    # that a live model syncs them lazily: an update marks them dirty,
    # and the O(N) copies run on their first read after it.
    @property
    def labels_(self) -> Optional[np.ndarray]:
        if self._live_model is not None:
            self._live_model._sync_if_dirty()
        return self._labels_v

    @labels_.setter
    def labels_(self, value) -> None:
        self._labels_v = value

    @property
    def core_sample_mask_(self) -> Optional[np.ndarray]:
        if self._live_model is not None:
            self._live_model._sync_if_dirty()
        return self._core_mask_v

    @core_sample_mask_.setter
    def core_sample_mask_(self, value) -> None:
        self._core_mask_v = value

    @property
    def data(self):
        if self._live_model is not None:
            self._live_model._sync_if_dirty()
        return self._data_v

    @data.setter
    def data(self, value) -> None:
        self._data_v = value

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

    # -- live updates -----------------------------------------------------

    def live(self, **kw):
        """The cached :class:`~pypardis_tpu_torch.serve.live.LiveModel`
        over this fitted model, its incremental write surface (built on
        first use; kwargs force a rebuild; a refit drops it).  Only a
        Euclidean model goes live (see :class:`LiveModel`); an eps=None
        model raises too, having no fixed eps to maintain."""
        self._require_fitted()
        from .serve.live import check_live_metric

        check_live_metric(self._metric_norm)
        if self.eps is None:
            raise TypeError(
                "live updates need a fixed eps; this model was built with "
                "eps=None (its fit selected eps_): refit with "
                "DBSCAN(eps=model.eps_) to update it live"
            )
        if self._live_model is None or kw:
            from .serve import LiveModel

            self._live_model = LiveModel(self, **kw)
        return self._live_model

    def insert(self, X) -> np.ndarray:
        """Insert points into the fitted clustering (labels maintained
        incrementally, the serving index edited in place); returns their
        stable ids.  See :class:`~pypardis_tpu_torch.serve.live.
        LiveModel`."""
        return self.live().insert(X)

    def delete(self, ids) -> int:
        """Delete points by id (as :meth:`insert` returned them; the fit's
        points are ``0..n-1``)."""
        return self.live().delete(ids)

    def cluster_mapping(self) -> ClusterAggregator:
        """A :class:`ClusterAggregator` over the final labels (the
        reference's ``cluster_dict`` surface): each ``partition:cluster``
        pair (a sharded fit's KD partition, else partition 0) gets the
        next global id in first-seen point order, as feeding the points
        one by one would; ``cluster_dict`` is set from it."""
        agg = ClusterAggregator()
        if self.labels_ is not None:
            labels = np.asarray(self.labels_)
            parts = (np.asarray(self.partitioner_.result)
                     if self.partitioner_ is not None
                     else np.zeros(len(labels), np.int32))
            codes = _cluster_codes(parts, labels)
            uniq, first = np.unique(codes, return_index=True)
            for gid, c in enumerate(uniq[np.argsort(first, kind="stable")]):
                agg[_code_key(c)] = gid
            agg.next_global_id = len(uniq)
        self.cluster_dict = dict(agg.fwd)
        return agg

    # -- telemetry --------------------------------------------------------

    def report(self) -> Dict:
        """The schema'd telemetry dict of the most recent fit, sweep or
        eps=None fit (``pypardis_tpu/run_report@1``, the JAX package's
        schema and keys): per-phase wall seconds, the shard-layout and
        compute sections, resource watermarks, event counts and the
        registry dump; ``serving`` once the model's engine has answered
        queries, ``live`` with a live model, ``sweep`` after
        :meth:`sweep` and ``hierarchy`` after an eps=None fit or
        ``sweep(eps_list="auto")``.  JSON-serialisable throughout."""
        self._require_fitted()
        eng = self._serve_engine
        serving = (
            eng.serving_stats() if eng is not None and eng.queries > 0
            else None
        )
        live = dict(self._live_stats) if self._live_stats else None
        rep = obs.build_run_report(
            self._recorder,
            params={
                "eps": self.eps,
                "min_samples": self.min_samples,
                "metric": self.metric,
                "max_partitions": self.max_partitions,
                "split_method": self.split_method,
                "block": self.block,
                "precision": self.precision,
                "kernel_backend": self.kernel_backend,
                "merge": self.merge,
                "owner_computes": self.owner_computes,
                "overlap": self.overlap,
                "mode": self.mode,
                "flight": self.flight,
                "auto": False,
                "sketch": self.sketch,
            },
            n_points=len(self.labels_),
            n_dims=self._fit_info.get("n_dims", 0),
            n_devices=self._fit_info.get("n_devices", 1),
            backend=self.device.type,
            metrics=self.metrics_,
            serving=serving,
            live=live,
        )
        if self._sweep_stats:
            rep["sweep"] = dict(self._sweep_stats)
        if self._hier_stats:
            rep["hierarchy"] = dict(self._hier_stats)
            rep["params"]["eps_selected"] = self.eps_
        return rep

    def summary(self) -> str:
        """One-screen rendering of :meth:`report`."""
        return obs.format_summary(self.report())

    def export_trace(self, path: str) -> str:
        """Write the fit's driver spans as Chrome-trace JSON (loads in
        chrome://tracing and ui.perfetto.dev).  Works on a failed fit
        too: the spans recorded before the exception export (a killed
        process leaves its flight file instead, :func:`~.obs.replay`).
        ``profile_dir`` gives the device-level ``torch.profiler``
        trace."""
        if self._recorder is not None:
            return self._recorder.tracer.export_chrome_trace(path)
        self._require_fitted()
        raise RuntimeError(
            "no telemetry recorded for this model (loaded from a "
            "checkpoint?) — export_trace needs an in-process fit"
        )

    # -- checkpoints ------------------------------------------------------

    def save(self, path: str) -> None:
        """Checkpoint the fitted model in the JAX package's format."""
        from .checkpoint import save_model

        save_model(self, path)

    @classmethod
    def from_config(cls, config, mesh=None) -> "DBSCAN":
        """The model a :class:`~.config.DBSCANConfig` describes, on
        ``mesh``."""
        return config.build(mesh=mesh)

    @classmethod
    def load(cls, path: str, device=None) -> "DBSCAN":
        """Restore a model checkpointed by either package."""
        from .checkpoint import load_model

        return load_model(path, device=device)
