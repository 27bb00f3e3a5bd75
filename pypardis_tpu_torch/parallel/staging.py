"""The staging cache: pooled host buffers and device tensors kept across
fits (counterpart of ``pypardis_tpu/parallel/staging.py``).

A warm refit of the same data (another ``min_samples``, an eps sweep, a
repeated benchmark fit) repeats host work whose product the last fit
already put on the device: the mean, the transpose, the copy, the
Morton sort, a KD route's slab build.  This module keeps both halves of
that economy:

* **host pool** (:func:`borrow` / :func:`give_back`): buffers keyed by
  (shape, dtype), reused across fits.  Their content is always
  rewritten by the build, so reuse is correct whatever they held; the
  win is the allocation.  A second caller while a buffer is out
  allocates a fresh one.

* **device cache** (:func:`device_get` / :func:`device_put_cached`):
  the previous fit's device tensors per *route*, keyed by a CONTENT
  fingerprint of the inputs that determine them (never by identity), so
  an input mutated in place between fits misses and is rebuilt.  One
  entry per route; a key miss evicts before the rebuild, so the device
  never holds two generations of a route.  Owned slabs key without eps
  (their layout does not depend on it), so an eps change re-ships only
  the halos.  ``staged_bytes_reused`` in ``DBSCAN.report()`` is the
  bytes served from here, ``staged_bytes`` the bytes shipped.

The routes: ``pipeline_layout`` (the single-card fit's sorted ``(xs,
mask, owner)``), ``sweep_graph`` (the sweep's neighbour-pair graph,
eps-free key, :data:`SWEEP_GRAPH_ROUTE`), ``host_owned`` /
``host_halo`` (the KD route's fused step), ``ring_owned`` (the ring
route), ``chained_owned`` / ``chained_halo`` (the chained route's
per-partition slabs) and ``serve_index[.<handle>]`` with its
``_delta`` route (a serving index).  Each key holds the device the
tensors live on, so a fit on another device misses.

Nothing may write into a cached tensor: a cached entry is shared by
every later fit that hits it.  The one writer is a serving index's
live commit, which replaces its entry through :func:`device_replace`.

Bytes are ``numel() * element_size()``.  Fingerprints hash every byte
of the input (a chunked crc32, host-memory bound), which a cacheable
cold fit pays; tensors are never fingerprinted by the routes (a tensor
input is never cached).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from ..obs.flight import flight_note

# Bytes per crc32 call of the fingerprint (the JAX package's).
_CRC_CHUNK = 1 << 24

# (shape, dtype-str) -> free numpy buffer.
_host_pool: dict = {}

# route -> (key, tuple of tensors, aux dict, nbytes).  One entry a route.
_device_cache: dict = {}

# route -> cumulative bytes shipped as in-place deltas (device_replace).
_route_delta: dict = {}

# The current fit's counters, reset by begin_fit().
_fit_stats = {"reused": 0, "staged": 0}


def begin_fit() -> None:
    """Reset the per-fit counters (one call per fit)."""
    _fit_stats["reused"] = 0
    _fit_stats["staged"] = 0


def fit_stats() -> Tuple[int, int]:
    """``(staged_bytes_reused, staged_bytes)`` of the current fit."""
    return _fit_stats["reused"], _fit_stats["staged"]


def clear() -> None:
    """Drop every pooled host buffer and cached device tensor (tests,
    cold timings, and callers that want the device memory back)."""
    _host_pool.clear()
    _device_cache.clear()
    _route_delta.clear()


def tensors_nbytes(arrays) -> int:
    """The bytes of a sequence of tensors (or numpy arrays): the one
    byte count of the cache, the serving index and its engine."""
    total = 0
    for a in arrays:
        if hasattr(a, "element_size"):
            total += int(a.numel()) * int(a.element_size())
        else:
            total += int(np.asarray(a).nbytes)
    return total


def pool_nbytes() -> int:
    """Bytes the staging economy holds: pooled host buffers plus cached
    device tensors (the resource sampler's ``staging_pool_bytes``)."""
    host = sum(int(b.nbytes) for b in _host_pool.values())
    dev = sum(int(e[3]) for e in _device_cache.values())
    return host + dev


def points_fingerprint(points) -> Tuple:
    """Content fingerprint of an input: ``(shape, dtype, crc32 of every
    byte)``, chunked so no copy of the whole input is made.  A tensor is
    copied to the host once (the resumable fits' :func:`~..utils.
    jobstate.fit_meta`; the cache routes never fingerprint a tensor)."""
    if hasattr(points, "detach"):
        points = points.detach().cpu().numpy()
    points = np.asarray(points)
    flat = points.reshape(-1)
    crc = 0
    step = max(1, _CRC_CHUNK // max(points.itemsize, 1))
    for s in range(0, flat.shape[0], step):
        crc = zlib.crc32(
            np.ascontiguousarray(flat[s:s + step]).view(np.uint8), crc
        )
    return (points.shape, str(points.dtype), crc)


def partitioner_fingerprint(partitioner) -> Tuple:
    """Content fingerprint of a KD partitioner's splits: the partition
    count and a hash of the tree, so a fresh but identical partitioner
    (``DBSCAN.fit`` builds one per call) hits the cache."""
    tree = tuple(
        (int(p), int(a), float(b), int(l), int(r))
        for p, a, b, l, r in partitioner.tree
    )
    return (partitioner.n_partitions, hash(tree))


def borrow(shape, dtype) -> np.ndarray:
    """A host buffer of ``(shape, dtype)``: pooled if one is free, else
    fresh.  Its content is unspecified: the caller overwrites all of
    it."""
    key = (tuple(shape), np.dtype(dtype).str)
    buf = _host_pool.pop(key, None)
    if buf is None:
        buf = np.empty(shape, dtype)
    return buf


def give_back(bufs) -> None:
    """Return borrowed buffers to the pool, once nothing reads them any
    more (the device copy made from them is complete).  Not for buffers
    whose device products are cached: see :func:`give_back_after_put`."""
    for buf in bufs:
        _host_pool[(buf.shape, buf.dtype.str)] = buf


def _put_aliases_host(device) -> bool:
    """Whether a copy of a host buffer to ``device`` may share the
    buffer's memory: on the CPU ``torch.from_numpy(buf).to("cpu")`` is
    the buffer itself, on the card it is a real copy."""
    import torch

    return torch.device(device).type == "cpu"


def give_back_after_put(bufs, device) -> None:
    """Return build buffers whose device products are cached across fits
    (the KD routes' slabs).  On the CPU a product may BE the buffer, and
    pooling it would let the next :func:`borrow` of that shape overwrite
    a cached slab (the JAX package saw exactly that: the second eps of a
    sweep clustered corrupted owned slabs), so there they are dropped.
    On the card the copy is complete once the fit's results are on the
    host, and the buffers rejoin the pool."""
    if not _put_aliases_host(device):
        give_back(bufs)


def device_get(route: str, key) -> Optional[tuple]:
    """``(tensors, aux)`` cached for ``route`` if ``key`` matches, else
    None; a mismatched entry is evicted, so its memory is free before
    the rebuild."""
    entry = _device_cache.get(route)
    if entry is None:
        return None
    ekey, arrays, aux, nbytes = entry
    if ekey != key:
        del _device_cache[route]
        flight_note("staging.evict", route=route, reason="key_miss")
        return None
    _fit_stats["reused"] += nbytes
    flight_note("staging.reuse", route=route, nbytes=int(nbytes))
    return arrays, dict(aux)


def device_peek(route: str, key) -> bool:
    """Whether ``route`` holds an entry for ``key``: a lookahead for a
    driver choosing a route; counts nothing and evicts nothing."""
    entry = _device_cache.get(route)
    return entry is not None and entry[0] == key


def device_holds(route: str, arrays) -> bool:
    """Whether ``route``'s entry is exactly these tensors (by identity):
    whether an index still owns its route's entry."""
    entry = _device_cache.get(route)
    return (entry is not None and len(entry[1]) == len(arrays)
            and all(a is b for a, b in zip(entry[1], arrays)))


def route_nbytes(route: str) -> int:
    """Bytes resident on the device for ``route`` (0 when empty)."""
    entry = _device_cache.get(route)
    return 0 if entry is None else int(entry[3])


def device_evict(route: str) -> None:
    """Drop one route's entry (a failed attempt's restage, a released or
    replaced serving index, a gateway eviction)."""
    if _device_cache.pop(route, None) is not None:
        flight_note("staging.evict", route=route, reason="explicit")


def route_delta_nbytes(route: str) -> int:
    """Bytes shipped through :func:`device_replace` on a delta route
    since the last :func:`clear`."""
    return int(_route_delta.get(route, 0))


def device_replace(
    route: str, key, arrays: tuple, *, staged_nbytes: int,
    delta_route: Optional[str] = None,
) -> tuple:
    """Install an in-place-updated generation of a route's tensors (a
    live index commit): the entry's size is the whole new tensors, but
    the counters move only by ``staged_nbytes``, the bytes that crossed
    to the device, also added to ``delta_route``."""
    nbytes = tensors_nbytes(arrays)
    _fit_stats["staged"] += int(staged_nbytes)
    _device_cache[route] = (key, arrays, {}, nbytes)
    if delta_route is not None:
        _route_delta[delta_route] = (
            _route_delta.get(delta_route, 0) + int(staged_nbytes)
        )
    flight_note(
        "staging.device_replace", route=route,
        delta_nbytes=int(staged_nbytes), nbytes=int(nbytes),
    )
    return arrays


def device_put_cached(route: str, key, arrays: tuple, aux=None) -> tuple:
    """Record freshly staged device tensors (and their build stats in
    ``aux``) for the next fit; their bytes count as staged."""
    nbytes = tensors_nbytes(arrays)
    _fit_stats["staged"] += nbytes
    _device_cache[route] = (key, tuple(arrays), dict(aux or {}), nbytes)
    flight_note("staging.device_put", route=route, nbytes=int(nbytes))
    return arrays


# ---------------------------------------------------------------------------
# The sweep-graph route: the neighbour-pair graph behind DBSCAN.sweep.
#
# A graph extracted at eps_max serves every config with eps <= eps_max
# (re-thresholding its exact d^2 is exact), so the route's key is
# eps-free and the entry's aux carries the eps_max it was built at.  A
# later sweep whose ceiling fits under it reuses the graph outright;
# configs 2..k of one sweep count their reuse through touch_route.
# ---------------------------------------------------------------------------

SWEEP_GRAPH_ROUTE = "sweep_graph"


def device_get_cover(route: str, key, eps_needed: float):
    """``(tensors, aux)`` when ``route`` holds an entry for the eps-free
    ``key`` whose ``aux["eps_max"]`` covers ``eps_needed``; a key match
    with too low a ceiling is evicted (the rebuild at the larger ceiling
    replaces it), and so is a key miss."""
    entry = _device_cache.get(route)
    if entry is None:
        return None
    ekey, arrays, aux, nbytes = entry
    if ekey != key or float(aux.get("eps_max", -1.0)) < float(eps_needed):
        del _device_cache[route]
        flight_note("staging.evict", route=route, reason="key_miss")
        return None
    _fit_stats["reused"] += nbytes
    flight_note("staging.reuse", route=route, nbytes=int(nbytes))
    return arrays, dict(aux)


def touch_route(route: str) -> int:
    """Count one reuse of ``route``'s entry without fetching it (a
    sweep's configs 2..k re-thresholding the graph the first staged).
    Returns the bytes credited (0 when the route is empty)."""
    entry = _device_cache.get(route)
    if entry is None:
        return 0
    nbytes = int(entry[3])
    _fit_stats["reused"] += nbytes
    flight_note("staging.reuse", route=route, nbytes=nbytes)
    return nbytes


def _evict_all_device(error) -> None:
    """An OOM's recovery between transfer attempts: drop every cached
    device tensor, so the retry has the memory the cache held.  Tensors
    a fit already holds stay alive through its own references."""
    if _device_cache:
        flight_note(
            "staging.evict", route="*", reason="oom_recovery",
            nbytes=sum(int(e[3]) for e in _device_cache.values()),
        )
        _device_cache.clear()


def transfer(put_fn):
    """Run a host-to-device copy (``put_fn``, no arguments) under the
    retry layer: a transient fault retries through the ladder, and an
    OOM (``torch.OutOfMemoryError`` or its injected signature) retries
    after :func:`_evict_all_device`.  Any other error, every CUDA error
    among them, raises at once.  The ``staging.device_put`` fault site
    sits inside the retry scope, so an injected fault recovers through
    exactly this path."""
    from ..utils import faults
    from ..utils.retry import Retrier, is_recoverable_oom, is_transient_error

    def attempt():
        faults.maybe_fail("staging.device_put")
        return put_fn()

    return Retrier("staging.device_put", waits=(0.0, 10.0)).run(
        attempt,
        retryable=lambda e: is_transient_error(e) or is_recoverable_oom(e),
        on_retry=lambda e: (
            _evict_all_device(e) if is_recoverable_oom(e) else None
        ),
    )
