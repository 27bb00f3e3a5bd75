"""DBSCAN labeling as core-graph connected components (counterpart of
``pypardis_tpu/ops/labels.py``).

A point is core iff >= min_samples valid points lie within eps (itself
included); clusters are the connected components of the core points
under the eps relation; a border point attaches to the minimum root of
its core neighbours; the rest is noise.  Components come from min-label
propagation with pointer jumping: every core point starts with its own
index, each round takes the minimum label among its core eps-neighbours
(one B2 pass, or B4 with the sketch on; under ``precision="mixed"``
or ``"default"`` the bf16 B2) and chases labels to the
current root, until nothing changes.  PyTorch runs eagerly, so the JAX ``while_loop``s are Python
loops that read one bool from the device per iteration.

A fit is three stages (the JAX package's host-stepped split):
:func:`dbscan_prepare` (pair list, frames, the counts pass, core, the
initial state), :func:`dbscan_rounds` (propagation rounds) and
:func:`dbscan_border` (the border pass after an exit by the round cap).
:func:`dbscan_fixed_size` composes them for the fused route; the
stepped route (``ops/pipeline._cluster_stepped``) runs the rounds in
batches with a snapshot between them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.validate import (
    check_kernel_backend, check_precision, norm_metric, validate_params,
)
from .cuda_kernels import (
    _pallas_block,
    gm_tile_aligned,
    kernel_pair_list,
    min_neighbor_label_cuda,
    neighbor_counts_cuda,
    pass_frames,
    sketch_stage,
)
from .distances import INT_INF, eps_threshold
from .sketch import check_sketch_spec, effective_k


def resolve_backend(backend: str, device: torch.device,
                    metric: str = "euclidean") -> str:
    """``"auto"`` -> ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU
    tensor.  An explicit backend must match the tensor's device: the
    plain versions never stand in for a kernel on the card, and the
    kernels cannot run on the CPU.  Cityblock has no kernel (as in the
    JAX package, where only the Euclidean metric goes through Pallas):
    it resolves to its torch pass on any device, and an explicit
    ``"cuda"`` raises, as the JAX package's ``"pallas"`` does."""
    backend = check_kernel_backend(backend)
    if norm_metric(metric) == "cityblock":
        if backend == "cuda":
            raise ValueError(
                "kernel_backend='cuda' supports only the euclidean "
                "metric, got 'cityblock'; use 'auto' or 'torch'"
            )
        return "torch"
    kind = "cuda" if torch.device(device).type == "cuda" else "torch"
    if backend not in ("auto", kind):
        raise ValueError(
            f"kernel_backend={backend!r} cannot run on a {device} tensor; "
            f"use 'auto' (or {kind!r})"
        )
    return kind


def _pointer_jump(f: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Chase f -> f[f] to a fixpoint.  ``f`` holds point indices for
    ``active`` points and INT32_MAX elsewhere; jumps only read entries of
    active points, whose values are always valid indices."""
    n = f.shape[0]
    while True:
        tgt = torch.clamp(f, 0, n - 1).long()
        nxt = torch.where(active, f[tgt], f)
        if not bool((nxt != f).any()):
            return f
        f = nxt


def uf_hook(parent: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Union the edges ``(a[k], b[k])`` into ``parent``, a min-id forest
    whose entries already point at their roots (``arange`` for none
    merged).  Each pass hooks every larger root onto the least root
    across its edges (a scatter-min) and pointer-jumps to a fixpoint;
    edges whose ends share a root leave the pass.  Returns the new
    forest, each entry its component's minimum id."""
    while a.numel():
        ra, rb = parent[a], parent[b]
        live = ra != rb
        if not bool(live.any()):
            break
        a, b, ra, rb = a[live], b[live], ra[live], rb[live]
        parent = parent.scatter_reduce(
            0, torch.maximum(ra, rb), torch.minimum(ra, rb), reduce="amin"
        )
        parent = _pointer_jump(
            parent, torch.ones_like(parent, dtype=torch.bool))
    return parent


def uf_resolve_dense(edges, n_nodes: int) -> torch.Tensor:
    """Min-id union-find roots for dense node ids ``0..n_nodes-1`` (the
    JAX package's ``_native.uf_resolve_dense``), as array operations on
    the edges' device: hooking and pointer jumping (:func:`uf_hook`).

    ``edges``: (E, 2) integer tensor or array; entries outside ``[0,
    n_nodes)`` are ignored.  Returns (n_nodes,) int64 on the edges'
    device: each node's component root, the component's minimum id."""
    e = edges if isinstance(edges, torch.Tensor) else torch.from_numpy(
        np.asarray(edges, dtype=np.int64))
    e = e.reshape(-1, 2).long()
    n = int(n_nodes)
    a, b = e[:, 0], e[:, 1]
    ok = (a >= 0) & (a < n) & (b >= 0) & (b < n)
    parent = torch.arange(n, dtype=torch.int64, device=e.device)
    return uf_hook(parent, a[ok], b[ok])


def finish_labels(f, border, core, mask):
    """Labels from converged propagation state: core points keep their
    root, valid points with a core neighbour take its root, else -1."""
    return torch.where(
        core, f, torch.where(mask & (border != INT_INF), border, -1)
    ).to(torch.int32)


def dbscan_prepare(
    points,
    eps,
    min_samples,
    mask,
    block: int = 1024,
    precision: str = "high",
    backend: str = "auto",
    pair_budget: int | None = None,
    sketch=None,
    metric: str = "euclidean",
):
    """The first stage of a fit over a padded point set (the JAX
    package's ``dbscan_prepare_pallas``): the slab with the sketch on,
    the live tile-pair list, the row frames, the counts pass (B1, or B3
    with the sketch), the core mask and the initial propagation state
    ``f0`` (each core point its own index, INT32_MAX elsewhere).

    Returns a dict the rounds and the border read: ``total`` and
    ``budget`` of the pair list, and with ``total <= budget`` also
    ``core``, ``f0`` and ``band`` (the counts pass's band telemetry).
    Past the budget the list is truncated and no pass runs (``core`` is
    None): the caller reruns with ``pair_budget >= total``.
    """
    validate_params(eps, min_samples)
    mode = check_precision(precision)
    metric = check_pair_metric(metric, mode)
    resolve_backend(backend, points.device, metric)
    d, n = points.shape
    tile = _pallas_block(block, n, d, mode)
    if n % tile != 0:
        raise ValueError(f"tile {tile} does not divide n={n}")
    points = points.contiguous()
    k = (effective_k(check_sketch_spec(sketch), d)
         if metric == "euclidean" else 0)
    # One slab for every pass: each pass's band mask is the validity
    # mask (the core mask lies inside it), so one band serves all.
    slab = sketch_stage(points, mask, k, mode) if k else None
    # One live tile-pair list for every pass: it covers the validity
    # boxes, a superset of any pass's source subset (the core mask).
    pairs, (total, budget) = kernel_pair_list(
        points, eps, mask, block, mode, budget=pair_budget, sketch=k,
        slab=slab, metric=metric,
    )
    st = dict(points=points, eps=eps, mask=mask, block=block, mode=mode,
              metric=metric, k=k, slab=slab, pairs=pairs,
              total=int(total), budget=int(budget), core=None)
    if total > budget:
        return st
    # The row frames (the tile centres B1 recentres on at d <= 64 in every
    # mode, and the bf16 passes' norms): every pass's rows are the valid
    # ones.
    st["frames"] = (pass_frames(points, mask, tile, mode, k)
                    if metric == "euclidean" else (None, None))
    counts = neighbor_counts_cuda(
        points, eps, mask, block=block, precision=mode, pairs=pairs,
        sketch=k, slab=slab, frames=st["frames"], metric=metric,
    )
    band = torch.zeros(2, dtype=torch.int64)
    if isinstance(counts, tuple):
        counts, band = counts
    # A valid point always counts itself; the clamp keeps that exact
    # when eps^2 sinks below the self-pair's rounding (kept from the JAX
    # package, where the matmul expansion can miss it).
    core = (torch.clamp_min(counts, 1) >= min_samples) & mask
    idx = torch.arange(n, dtype=torch.int32, device=points.device)
    st.update(core=core, f0=torch.where(core, idx, INT_INF),
              band=band.cpu())
    return st


def truncated_result(st):
    """``(labels, core, pair_stats)`` of a truncated pair list (``st``
    past its budget): no pass ran, labels -1, passes 0; the caller
    reruns with ``pair_budget >= total``."""
    n, dev = st["mask"].shape[0], st["mask"].device
    return (
        torch.full((n,), -1, dtype=torch.int32, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev),
        torch.tensor([st["total"], st["budget"], 0, 0, 0],
                     dtype=torch.int64),
    )


def _minlab(st, lab, live):
    """One min-label pass (B2, or B4 with the sketch) over the prepared
    pair list, rows ``live``."""
    best = min_neighbor_label_cuda(
        st["points"], lab, st["eps"], st["core"], block=st["block"],
        precision=st["mode"], row_mask=st["mask"], pairs=st["pairs"],
        sketch=st["k"], slab=st["slab"], frames=st["frames"],
        live_rows=live, metric=st["metric"],
    )
    # The widened return's stats are zeros, as the JAX kernels': the
    # counts pass measured the band.
    return best[0] if isinstance(best, tuple) else best


def dbscan_rounds(st, f, live, k_rounds: int, until_fixpoint: bool = True):
    """Up to ``k_rounds`` propagation rounds from the state ``f`` (the
    JAX package's ``dbscan_rounds_pallas``): per round one min-label pass
    (B2 or B4), the minimum with ``f`` on core points and pointer jumping
    to the current roots.

    ``live``: the rows the passes still need, which B2 keeps in its
    skip's bound: the valid ones, and after a pass only those with a
    source within eps.  The sources (core), the pair list and with them
    every verdict are the same in each pass, so a row that found no
    source never finds one; it keeps INT32_MAX.  The set is not in a
    snapshot: a resumed batch starts from the full validity mask, which
    gives the same labels.

    ``until_fixpoint`` stops after the first round that changes nothing
    (the fused loop).  Without it every one of the ``k_rounds`` runs, past
    the fixpoint too, as a JAX stepped batch is counted: propagation is
    idempotent there, so ``f`` and ``g`` are the same bits and the
    launches equal the JAX pass count.

    Returns ``(f, g, live, changed, rounds)``: ``changed`` False means
    the last round was a fixpoint, and then ``g`` is already the
    border-attach pass (the least root among each row's core
    neighbours)."""
    core, mask = st["core"], st["mask"]
    g = f
    changed = True
    rounds = 0
    while rounds < k_rounds and (changed or not until_fixpoint):
        g = _minlab(st, f, live)
        live = mask & (g != INT_INF)
        f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f), core)
        changed = bool((f_new != f).any())
        f = f_new
        rounds += 1
    return f, g, live, changed, rounds


def dbscan_border(st, f, live):
    """The border-attach pass after a non-converged exit (the JAX
    package's ``dbscan_border_pallas``): the least root among each row's
    core neighbours at the labels ``f``."""
    return _minlab(st, f, live)


def dbscan_fixed_size(
    points,
    eps,
    min_samples,
    mask,
    block: int = 1024,
    max_rounds: int = 64,
    precision: str = "high",
    backend: str = "auto",
    pair_budget: int | None = None,
    sketch=None,
    metric: str = "euclidean",
):
    """DBSCAN over a fixed-capacity padded point set: :func:`dbscan_prepare`,
    :func:`dbscan_rounds` to the fixpoint (at most ``max_rounds``) and,
    after an exit by ``max_rounds``, :func:`dbscan_border`.

    ``points``: (d, N) float32, N a multiple of the effective tile;
    ``mask``: (N,) bool validity.  Returns ``(labels, core,
    pair_stats)``: ``labels`` (N,) int32, the root point index of each
    point's cluster (min index over its core points) or -1; ``core`` (N,)
    bool; ``pair_stats`` a (5,) int64 CPU tensor ``[live_pairs_total,
    budget, kernel_passes, band_pairs, rescored_tiles]`` — when ``total
    > budget`` the labels are INVALID (no pass ran: labels -1, passes 0)
    and the caller reruns with ``pair_budget >= total``.
    ``kernel_passes`` counts the counts pass, one min-label pass per
    round and the border recompute when the loop stopped at
    ``max_rounds``.

    ``sketch``: a spec (None reads ``PPTORCH_SKETCH``, default
    ``"auto"``: on at d >= 128).  With k > 0 the slab and its band are
    staged once, the pair list is extracted over the slab boxes, B3 runs
    the counts pass and B4 every other pass, and ``band_pairs`` /
    ``rescored_tiles`` carry the counts pass's gate telemetry.  Labels
    are byte-identical either way.  Without the sketch,
    ``precision="mixed"`` runs the bf16 B1/B2 with their exact rescore
    (labels byte-identical to ``"high"``) and the two stats are the B1
    pass's band telemetry; ``"default"`` runs the bf16 passes alone.
    Every other case reports zeros there.

    ``metric="cityblock"`` runs the L1 torch passes over a pair list
    pruned by the L1 box test, on any device; the sketch is off and
    ``"mixed"`` raises, as in the JAX package.
    """
    st = dbscan_prepare(
        points, eps, min_samples, mask, block=block, precision=precision,
        backend=backend, pair_budget=pair_budget, sketch=sketch,
        metric=metric,
    )
    if st["core"] is None:
        return truncated_result(st)
    f, g, live, changed, rounds = dbscan_rounds(
        st, st["f0"], mask, max_rounds)
    # Only an exit by max_rounds leaves g older than the final f.
    border = dbscan_border(st, f, live) if changed else g
    labels = finish_labels(f, border, st["core"], mask)
    passes = 1 + rounds + int(changed)
    pair_stats = torch.cat([
        torch.tensor([st["total"], st["budget"], passes],
                     dtype=torch.int64),
        st["band"],
    ])
    return labels, st["core"], pair_stats


# ---------------------------------------------------------------------------
# Owner-computes passes over an ``owned + boundary`` slab (the JAX
# package's ``oc_*``), for the global-Morton route:
#
# * the counts pass counts owned ROWS against every column, so each owned
#   point's core flag is exact (the boundary columns cover every
#   candidate neighbour) and no boundary row is counted;
# * the propagation takes the boundary slots' core flags from their
#   owners and drops the (boundary row, boundary column) tile pairs:
#   boundary cores relay labels between the owned clusters they touch,
#   and each boundary-boundary edge is some other range's owned edge,
#   which the host merge recovers from that range's tables.
#
# The JAX passes re-sort a filtered Pallas list to fixed shapes (a dump
# row and a stable sort, ``_oc_sorted_pairs``); the port's pair list has
# no fixed shape, and a boolean mask keeps its row-major order, which is
# all the CSR offsets (``distances.row_offsets``) need.
# ---------------------------------------------------------------------------


def gm_backend(backend: str, metric: str, n_total: int, owned: int,
               block: int, d: int, precision: str, device) -> str:
    """The backend of a global-Morton ``owned + boundary`` slab of
    ``n_total`` rows (:func:`resolve_backend`), after the tile check of
    :func:`~.cuda_kernels.gm_tile_aligned`.  The JAX package sends a
    misaligned slab to its XLA kernels; the port has no second kernel on
    the card and never runs the plain versions there, so a misaligned
    slab raises, on any device."""
    kind = resolve_backend(backend, device, metric)
    mode = check_precision(precision)
    if not gm_tile_aligned(block, n_total, owned, d, mode):
        raise ValueError(
            f"block={block} cannot tile the global-Morton slab: its tile "
            f"{_pallas_block(block, n_total, d, mode)} does not divide the "
            f"owned prefix (owned={owned}) and the slab (total={n_total}); "
            f"use a power-of-two block"
        )
    return kind


def oc_extract(points, eps, mask, *, owned: int, block: int,
               precision: str = "high", backend: str = "auto",
               pair_budget: int | None = None, sketch=None,
               metric: str = "euclidean"):
    """The owner-computes passes' shared pre-pass over a ``(d, owned +
    boundary)`` slab (a global-Morton range's, or a KD partition's owned
    + halo slab): the sketch slab (k > 0), the live tile-pair list over
    the whole slab and the row frames, each taken once over ``mask`` as
    :func:`dbscan_prepare` takes them.  The passes filter the list
    (:func:`oc_raw_counts`, :func:`oc_propagate`).

    Returns a dict: ``total`` and ``budget`` are the FULL list's (the
    overflow contract: past the budget no pass may run and the caller
    reruns at ``total``); ``pairs`` the list, ``ont`` the owned tiles,
    ``hh_pairs`` the list's (boundary, boundary) tile pairs.  ``metric``
    is a pair metric (cityblock runs its torch passes with the sketch
    off, as :func:`dbscan_prepare` runs it)."""
    mode = check_precision(precision)
    metric = check_pair_metric(metric, mode)
    d, n = points.shape
    gm_backend(backend, metric, n, owned, block, d, mode, points.device)
    tile = _pallas_block(block, n, d, mode)
    points = points.contiguous()
    k = (effective_k(check_sketch_spec(sketch), d)
         if metric == "euclidean" else 0)
    slab = sketch_stage(points, mask, k, mode) if k else None
    (rows, cols), (total, budget) = kernel_pair_list(
        points, eps, mask, block, mode, budget=pair_budget, sketch=k,
        slab=slab, metric=metric,
    )
    ont = owned // tile
    ex = dict(points=points, eps=eps, mask=mask, block=block, mode=mode,
              metric=metric, k=k, slab=slab, pairs=(rows, cols),
              total=int(total), budget=int(budget), owned=int(owned),
              tile=tile, ont=ont,
              hh_pairs=int(((rows >= ont) & (cols >= ont)).sum()))
    if total <= budget:
        ex["frames"] = (pass_frames(points, mask, tile, mode, k)
                        if metric == "euclidean" else (None, None))
    return ex


def _kept(pairs, keep):
    """The entries of a row-sorted pair list under ``keep``, in order."""
    rows, cols = pairs
    return rows[keep], cols[keep]


def _owned_counts(ex, keep):
    """Raw counts over the pairs of ``ex`` under ``keep``: B1, or B3 with
    the sketch.  Returns ``(counts[:owned], band)``."""
    counts = neighbor_counts_cuda(
        ex["points"], ex["eps"], ex["mask"], block=ex["block"],
        precision=ex["mode"], pairs=_kept(ex["pairs"], keep),
        sketch=ex["k"], slab=ex["slab"], frames=ex["frames"],
        metric=ex["metric"],
    )
    band = torch.zeros(2, dtype=torch.int64)
    if isinstance(counts, tuple):
        counts, band = counts
    return counts[:ex["owned"]], band.cpu()


def oc_raw_counts(ex):
    """Owned-row raw neighbour counts (no ``min_samples``) over the
    extracted slab ``ex`` (:func:`oc_extract`): B1, or B3 with the
    sketch, over the pairs whose row tile is owned.  Returns
    ``(counts[:owned], band)``, ``band`` the (2,) int64 band stats
    (zeros off ``"mixed"`` and off the sketch)."""
    rows, _cols = ex["pairs"]
    return _owned_counts(ex, rows < ex["ont"])


def oc_counts_delta(ex):
    """Owned rows x boundary columns counts over the extracted ``owned +
    boundary`` slab ``ex``: the pairs of :func:`oc_raw_counts`' list
    whose column tile is a boundary tile.  The global-Morton engine's
    overlapped counts pass adds it to an owned-slab pass run before the
    exchange; the two column sets are disjoint, so ``owned + delta`` is
    the fused counts bitwise.  Returns ``(counts[:owned], band)``."""
    rows, cols = ex["pairs"]
    ont = ex["ont"]
    return _owned_counts(ex, (rows < ont) & (cols >= ont))


def oc_counts_banded(ex, min_samples):
    """Owned-row core flags with a uniform ``(core, band)`` return:
    :func:`oc_raw_counts` thresholded with the self-count clamp of
    :func:`dbscan_prepare`."""
    counts, band = oc_raw_counts(ex)
    core = (torch.clamp_min(counts, 1) >= min_samples) & (
        ex["mask"][:ex["owned"]])
    return core, band


def oc_counts(ex, min_samples):
    """:func:`oc_counts_banded` in the kernel convention: ``core``, or
    ``(core, band)`` under ``precision="mixed"``."""
    core, band = oc_counts_banded(ex, min_samples)
    return (core, band) if ex["mode"] == "mixed" else core


def oc_propagate_banded(ex, core_all, max_rounds: int = 64):
    """Min-label propagation with the boundary slots as relay-only nodes,
    over the extracted slab ``ex``: the rounds of :func:`dbscan_rounds`
    (B2, or B4 with the sketch) with ``core_all`` as the sources, the
    owned slots' exact flags followed by the boundary slots' owners'
    flags, over the pairs that are not (boundary row, boundary column).
    Returns ``(labels, passes, band)``: per-slot root slot indices (-1
    noise; a boundary slot's label is its occurrence-table entry), the
    min-label passes run (the rounds, and the border pass after an exit
    by ``max_rounds``) and the (2,) band stats, zeros as the JAX
    kernels' min-label stats are."""
    rows, cols = ex["pairs"]
    ont = ex["ont"]
    st = dict(ex, core=core_all,
              pairs=_kept(ex["pairs"], ~((rows >= ont) & (cols >= ont))))
    mask = ex["mask"]
    idx = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    f0 = torch.where(core_all, idx, INT_INF)
    f, g, live, changed, rounds = dbscan_rounds(st, f0, mask, max_rounds)
    border = dbscan_border(st, f, live) if changed else g
    labels = finish_labels(f, border, core_all, mask)
    return labels, rounds + int(changed), torch.zeros(2, dtype=torch.int64)


def oc_propagate(ex, core_all, max_rounds: int = 64):
    """:func:`oc_propagate_banded` in the kernel convention: ``(labels,
    passes)``, widened by the band under ``precision="mixed"``."""
    labels, passes, band = oc_propagate_banded(ex, core_all, max_rounds)
    if ex["mode"] == "mixed":
        return labels, passes, band
    return labels, passes


def check_pair_metric(metric, mode: str) -> str:
    """The pair passes' metric (Euclidean or cityblock); ``"mixed"`` is
    a Euclidean two-pass mode and raises for cityblock, as the JAX
    package's fit does."""
    metric = norm_metric(metric)
    if metric == "cityblock" and mode == "mixed":
        raise ValueError(
            "precision='mixed' supports only the euclidean metric "
            "(its bf16 pass and band are Euclidean), got 'cityblock'"
        )
    return metric


def graph_dbscan(gi, gj, dval, mask, eps, min_samples,
                 metric: str = "euclidean", max_rounds: int = 64):
    """DBSCAN relabel over a cached neighbour-pair graph (the JAX
    package's ``graph_dbscan``), torch ops on the graph's device.

    ``gi``/``gj``: (E,) int64 directed edges (each pair once per
    direction, self-pairs included); ``dval``: (E,) float32 threshold
    values (:func:`~.distances.neighbor_pair_graph`; ``+inf`` padding is
    inert); ``mask``: (n,) validity of the id space.  Round for round
    :func:`dbscan_fixed_size`: the same counts with the self-count
    clamp, the same minima over the same adjacency, the same pointer
    jumping and border attach, so the labels are the fit's at that
    config.  Returns ``(labels, core, passes)``: per-id root (min core
    id, -1 noise), the core mask and the pass count.
    """
    n = mask.shape[0]
    dev = mask.device
    adj = dval <= eps_threshold(eps, norm_metric(metric))
    gi_a, gj_a = gi[adj], gj[adj]
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    counts.index_add_(0, gi_a, torch.ones_like(gi_a, dtype=torch.int32))
    core = (torch.clamp_min(counts, 1) >= min_samples) & mask
    # Only edges into a core column carry a label.
    src = core[gj_a]
    gi_s, gj_s = gi_a[src], gj_a[src]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    f = torch.where(core, idx, INT_INF)

    def minlab(lab):
        out = torch.full((n,), INT_INF, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, gi_s, lab[gj_s], reduce="amin")

    g = f
    changed = True
    rounds = 0
    while changed and rounds < max_rounds:
        g = minlab(f)
        f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f), core)
        changed = bool((f_new != f).any())
        f = f_new
        rounds += 1
    border = minlab(f) if changed else g
    return finish_labels(f, border, core, mask), core, 1 + rounds + int(changed)


def densify_labels(root_labels) -> np.ndarray:
    """Host-side: root-index labels -> dense 0..C-1 ids by ascending
    root, noise -> -1."""
    root_labels = np.asarray(root_labels)
    out = np.full(root_labels.shape, -1, dtype=np.int32)
    valid = root_labels >= 0
    _uniq, inv = np.unique(root_labels[valid], return_inverse=True)
    out[valid] = inv.astype(np.int32)
    return out
