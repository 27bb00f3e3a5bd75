"""The ring halo exchange over the mesh (counterpart of the point-granular
half of ``pypardis_tpu/parallel/halo.py``).

The host-halo layout (:func:`~.sharded.build_shards`) computes every
partition's 2*eps halo on the host.  Here only the owned slabs are laid
out, and each shard collects its partitions' halos from the other
shards: every shard's owned rows ride a ring of ``P - 1`` hops (the JAX
``ppermute`` from shard ``s`` to ``s + 1``), and at each hop every
shard keeps the arriving rows inside its partitions' 2*eps-widened boxes
in a fixed-capacity ``hcap`` buffer per partition.  ``overflow`` counts
the in-box rows a full buffer dropped; the route treats any as an
error and reruns with a larger ``hcap`` (:func:`~.sharded._ring_ladder`).

One process drives every shard.  A hop is a ``.to`` of the buffer onto
the next shard's device: a no-op on a mesh that repeats one device, a
peer copy between distinct cards.

The order of a halo buffer is the JAX order exactly (the per-slab pair
lists and the merge depend on it): rows already accepted stay where they
are, and new in-box rows follow in arrival order (the JAX
``argsort(~mask, stable=True)`` over the buffer and the arriving rows).
Accepted rows are always a prefix of the buffer, so the port places the
``r``-th new in-box row at slot ``held + r`` through a prefix sum, with
no sort and no host sync; empty slots keep zeros, ``False`` and gid
``INT32_MAX``, as in JAX.

The tile-granular half (the global-Morton mesh engine's boundary
tiles, :func:`boundary_send_select` and :func:`ring_tile_round`) ships
whole kernel tiles instead of rows: each shard's tiles whose box lies
within eps of another shard's tiles ride the ring, and a shard keeps a
passing tile iff its box reaches one of its own.  The JAX ``all_gather``
of the tile boxes is a gather of every shard's ``(nt, k)`` boxes onto
each shard's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distances import cross_tile_live, sketch_slab_t, tile_bounds
from .mesh import gather

# The gid of an empty halo slot (the JAX module's ``2**31 - 1``).
EMPTY_GID = 2**31 - 1
# The inverted box of a shard's own tiles and of an empty send slot.
BOX_BIG = float(np.float32(3e38))


def _in_box(pts, msk, lo, hi):
    """Rows of ``(k, n)`` ``pts`` that are valid and inside the box
    ``[lo, hi]`` (inclusive, float32 compares)."""
    return (msk & (pts >= lo[:, None]).all(dim=0)
            & (pts <= hi[:, None]).all(dim=0))


def _compact_merge(halo, hmask, hgid, pts, valid, gid):
    """Append the ``valid`` rows of ``pts`` (``(k, n)``, with their gids)
    to one partition's halo buffer (``(k, hcap)`` rows, mask and gid),
    in order, up to its capacity.  Returns ``(halo, hmask, hgid,
    dropped)``: ``dropped`` is the number of valid rows that found no
    slot (a 0-d int64 tensor)."""
    hcap = hmask.shape[0]
    held = hmask.sum()
    rank = torch.cumsum(valid, 0)
    arriving = rank[-1]
    # Slot j takes the (j - held)-th arriving row: the first index whose
    # running count reaches j - held + 1.
    slot = torch.arange(hcap, device=hmask.device) - held
    take = (slot >= 0) & (slot < arriving)
    src = torch.searchsorted(rank, slot.clamp_min(0) + 1).clamp_max(
        valid.shape[0] - 1)
    halo = torch.where(take[None, :], pts[:, src], halo)
    hgid = torch.where(take, gid[src], hgid)
    return halo, hmask | take, hgid, arriving - take.sum()


def ring_halo_exchange_multi(owned, mask, gid, boxes_lo, boxes_hi, hcap,
                             mesh):
    """Collect each partition's halo from the whole mesh.

    Each argument is a list with one entry per shard of ``mesh``, on
    that shard's device: ``owned`` ``(L, k, cap)`` float32 (the port's
    orientation of the JAX ``(L, cap, k)``), ``mask`` and ``gid``
    ``(L, cap)``, ``boxes_lo``/``boxes_hi`` ``(L, k)`` float32, each
    local partition's 2*eps-widened box.  Returns one ``(halo,
    halo_mask, halo_gid, overflow)`` per shard, of shapes ``(L, k,
    hcap)``, ``(L, hcap)``, ``(L, hcap)`` and ``(L,)`` int32.

    Round 0 filters the shard's own rows against its partitions' boxes,
    each partition's own rows excluded (skipped at ``L == 1``, where
    nothing would pass); rounds ``1..P-1`` hand each shard's flat buffer
    to shard ``s + 1`` and filter the arrivals."""
    n_dev = mesh.size
    L, k, cap = owned[0].shape
    bufs, state = [], []
    for s in range(n_dev):
        dev = owned[s].device
        bufs.append((owned[s].transpose(0, 1).reshape(k, L * cap),
                     mask[s].reshape(-1), gid[s].reshape(-1)))
        state.append([[torch.zeros((k, hcap), dtype=owned[s].dtype,
                                   device=dev),
                       torch.zeros(hcap, dtype=torch.bool, device=dev),
                       torch.full((hcap,), EMPTY_GID, dtype=torch.int32,
                                  device=dev),
                       torch.zeros((), dtype=torch.int64, device=dev)]
                      for _ in range(L)])

    def filter_into(s, buf, exclude):
        pts, msk, gids = buf
        part_of = (torch.arange(L, device=pts.device).repeat_interleave(cap)
                   if exclude else None)
        for l, (h, hm, hg, over) in enumerate(state[s]):
            inbox = _in_box(pts, msk, boxes_lo[s][l], boxes_hi[s][l])
            if exclude:
                inbox &= part_of != l
            h, hm, hg, dropped = _compact_merge(h, hm, hg, pts, inbox, gids)
            state[s][l] = [h, hm, hg, over + dropped]

    if L > 1:
        for s in range(n_dev):
            filter_into(s, bufs[s], True)
    for _round in range(1, n_dev):
        bufs = [tuple(t.to(mesh.device(s), non_blocking=True)
                      for t in bufs[(s - 1) % n_dev])
                for s in range(n_dev)]
        for s in range(n_dev):
            filter_into(s, bufs[s], False)
    return [(torch.stack([p[0] for p in parts]),
             torch.stack([p[1] for p in parts]),
             torch.stack([p[2] for p in parts]),
             torch.stack([p[3] for p in parts]).to(torch.int32))
            for parts in state]


# ---------------------------------------------------------------------------
# the tile-granular exchange (the global-Morton mesh engine)
# ---------------------------------------------------------------------------


def _keep_tiles(cat_val, cap_tiles):
    """Stable tile compaction: valid tiles first, the first ``cap_tiles``
    kept.  Returns ``(order, kept_valid, dropped)``, ``dropped`` the
    valid tiles that found no slot (a 0-d int32 tensor)."""
    order = torch.argsort((~cat_val).to(torch.uint8), stable=True)[:cap_tiles]
    kept = cat_val[order]
    dropped = (cat_val.sum() - kept.sum()).to(torch.int32)
    return order, kept, dropped


def shard_tiles(owned, mask, gtile):
    """A shard's ``(k, cap)`` slab as ``(nt, k, gtile)`` tiles (a view),
    its ``(nt, gtile)`` mask and the tiles' ``(nt, k)`` boxes."""
    k, cap = owned.shape
    nt = cap // gtile
    tiles_t = owned.reshape(k, nt, gtile).transpose(0, 1)
    tmsk = mask.reshape(nt, gtile)
    lo, hi = tile_bounds(tiles_t, tmsk)
    return tiles_t, tmsk, lo, hi


def remote_boxes(los, his, s, device):
    """Every shard's ``(nt, k)`` boxes gathered onto ``device``, shard
    ``s``'s own inverted: ``(P * nt, k)`` lo and hi.  The boxes a tile of
    shard ``s`` is a boundary tile against."""
    all_lo, all_hi = gather(los, device), gather(his, device)
    mine = (torch.arange(len(los), device=device) == s)[:, None, None]
    k = all_lo.shape[-1]
    return (torch.where(mine, BOX_BIG, all_lo).reshape(-1, k),
            torch.where(mine, -BOX_BIG, all_hi).reshape(-1, k))


def boundary_send_select(owned, mask, gid, eps, *, gtile, btcap, mesh,
                         sketch=0):
    """Select and compact every shard's boundary tiles (the JAX
    ``boundary_send_select``, all shards at once).

    ``owned``, ``mask``, ``gid``: one ``(k, cap)``, ``(cap,)``, ``(cap,)``
    tensor per shard of ``mesh``, on its device.  A tile is a boundary
    tile when its box lies within eps of some OTHER shard's tile box
    (:func:`~..ops.distances.cross_tile_live` against the gathered
    boxes, the shard's own inverted).  With ``sketch`` (a resolved k, 0
    = off) a tile must also pass in sketch space: its ``(k + 1)``-row
    slab box within ``sqrt(eps^2 + band)`` of a remote slab box, the
    band :func:`~..ops.sketch.sketch_gate_band` at the MESH-wide masked
    norm maximum (the JAX ``pmax``: a shard's own maximum would not
    cover a farther point elsewhere).  Either test alone keeps every
    needed tile, so their intersection does.

    Returns one tuple per shard: ``(send_pts (btcap, k, gtile), send_msk
    (btcap, gtile), send_gid, send_lo (btcap, k), send_hi, n_send,
    overflow, my_lo (nt, k), my_hi, n_send_box)``, the JAX outputs with
    the points transposed.  Empty send slots carry inverted boxes,
    masked rows and gid ``INT32_MAX``; ``overflow`` counts the boundary
    tiles ``btcap`` dropped and ``n_send_box`` the full-d test's count.
    """
    from ..ops.sketch import sketch_gate_band, sketch_matrix

    P = mesh.size
    parts = [shard_tiles(owned[s], mask[s], gtile) for s in range(P)]
    los = [p[2] for p in parts]
    his = [p[3] for p in parts]
    live = []
    for s in range(P):
        rem_lo, rem_hi = remote_boxes(los, his, s, mesh.device(s))
        live.append(cross_tile_live(los[s], his[s], rem_lo, rem_hi, eps))
    n_box = [lv.sum().to(torch.int32) for lv in live]
    if sketch:
        k = owned[0].shape[0]
        q, eta = sketch_matrix(k, int(sketch))
        sboxes, nmax = [], 0.0
        for tiles_t, tmsk, _lo, _hi in parts:
            sboxes.append(tile_bounds(sketch_slab_t(tiles_t, q), tmsk))
            n2 = torch.where(tmsk, (tiles_t * tiles_t).sum(dim=1), 0.0)
            nmax = max(nmax, float(torch.sqrt(n2.max())) if n2.numel()
                       else 0.0)
        band = sketch_gate_band(nmax, k, int(sketch), eta)
        e = np.float32(eps)
        gate = float(np.sqrt(np.float32(e * e + band)))
        slos = [b[0] for b in sboxes]
        shis = [b[1] for b in sboxes]
        for s in range(P):
            srem_lo, srem_hi = remote_boxes(slos, shis, s, mesh.device(s))
            live[s] = live[s] & cross_tile_live(slos[s], shis[s], srem_lo,
                                                srem_hi, gate)
    out = []
    for s, (tiles_t, tmsk, lo, hi) in enumerate(parts):
        order, valid, overflow = _keep_tiles(live[s], btcap)
        tgid = gid[s].reshape(tmsk.shape)
        v3 = valid[:, None, None]
        v2 = valid[:, None]
        out.append((
            torch.where(v3, tiles_t[order], 0.0),
            tmsk[order] & v2,
            torch.where(v2, tgid[order], EMPTY_GID).to(torch.int32),
            torch.where(v2, lo[order], BOX_BIG),
            torch.where(v2, hi[order], -BOX_BIG),
            live[s].sum().to(torch.int32), overflow, lo, hi, n_box[s],
        ))
    return out


def ring_tile_round(bufs, recvs, my_lo, my_hi, eps, mesh):
    """One hop of the boundary-tile ring and its tile-level accept, on
    every shard (the JAX ``ring_tile_round``).

    ``bufs``: per shard the passing buffer ``(pts (T, k, g), msk (T, g),
    gid (T, g), lo (T, k), hi (T, k))``; ``recvs``: per shard ``(pts
    (bcap, k, g), msk (bcap, g), gid (bcap, g), val (bcap,), overflow
    (0-d int32))``; ``my_lo``/``my_hi``: per shard its own tile boxes.
    Shard ``s`` takes shard ``s - 1``'s buffer (a ``.to`` onto its
    device), accepts the tiles whose box lies within eps of one of its
    own, and merges them stably behind what it holds, up to ``bcap``
    tiles; ``overflow`` adds the accepted tiles that found no slot.
    Unaccepted tiles keep circulating.  Returns ``(bufs, recvs)``, new
    tensors (the inputs are not written)."""
    P = mesh.size
    bufs = [tuple(t.to(mesh.device(s), non_blocking=True)
                  for t in bufs[(s - 1) % P]) for s in range(P)]
    new_recvs = []
    for s in range(P):
        b_pts, b_msk, b_gid, b_lo, b_hi = bufs[s]
        r_pts, r_msk, r_gid, r_val, r_ovf = recvs[s]
        acc = cross_tile_live(b_lo, b_hi, my_lo[s], my_hi[s], eps)
        cat_pts = torch.cat([r_pts, b_pts])
        cat_msk = torch.cat([r_msk, b_msk & acc[:, None]])
        cat_gid = torch.cat([r_gid, torch.where(acc[:, None], b_gid,
                                                EMPTY_GID).to(torch.int32)])
        cat_val = torch.cat([r_val, acc])
        order, kept, dropped = _keep_tiles(cat_val, r_val.shape[0])
        new_recvs.append((cat_pts[order], cat_msk[order], cat_gid[order],
                          kept, r_ovf + dropped))
    return bufs, new_recvs
