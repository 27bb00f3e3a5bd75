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

The tile-granular half of the JAX module (the global-Morton mesh
engine's boundary tiles) is a later slice (ROADMAP A12).
"""

from __future__ import annotations

import torch

# The gid of an empty halo slot (the JAX module's ``2**31 - 1``).
EMPTY_GID = 2**31 - 1


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
