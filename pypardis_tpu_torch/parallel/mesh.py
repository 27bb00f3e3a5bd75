"""The device mesh of the partitioned fit (counterpart of
``pypardis_tpu/parallel/mesh.py``).

A :class:`Mesh` is a 1-D list of ``torch.device``s, one per shard, with
the attributes the JAX package's call sites read (``devices`` as an
object ndarray, ``size``, ``axis_names``).  A device may repeat: a
``Mesh(["cuda:0"] * 4)`` runs four shards on one card (and
``Mesh(["cpu"] * 8)`` eight on the CPU), the way the JAX tests fake
eight host devices, so the per-shard code, the reductions and the merge
run at full width where only one card exists.  :func:`default_mesh`
never repeats a device.

The reductions here are what the fused step's collectives compute (the
JAX ``pmax``/``pmin`` over the mesh axis), over per-shard tensors
gathered onto one device.  They are exact (integer and bool maxima and
minima), so the order in which shards are reduced cannot move a bit.
There is no ``torch.distributed`` here: one process drives every shard.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


class Mesh:
    """A 1-D mesh of devices, one per shard.

    ``devices``: anything ``torch.device`` accepts, in shard order; a
    device may repeat.  All devices are of one type (``"cpu"`` or
    ``"cuda"``): a mixed mesh raises ``ValueError``."""

    def __init__(self, devices: Iterable, axis_name: str = "p"):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in devs}
        if len(types) > 1:
            raise ValueError(
                f"a mesh's devices must all be of one type, got "
                f"{sorted(types)}"
            )
        if types - {"cpu", "cuda"}:
            raise ValueError(f"mesh devices must be cpu or cuda, got {types}")
        if "cuda" in types:
            # cuda and cuda:0 are one card: name every device by index.
            devs = [torch.device("cuda", 0 if d.index is None else d.index)
                    for d in devs]
        self._devs = devs
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = (str(axis_name),)

    @property
    def size(self) -> int:
        return len(self._devs)

    @property
    def device_type(self) -> str:
        return self._devs[0].type

    def device(self, shard: int) -> torch.device:
        """The device shard ``shard`` lives on."""
        return self._devs[shard]

    def distinct(self):
        """The mesh's distinct devices, in first-seen order."""
        seen = []
        for d in self._devs:
            if d not in seen:
                seen.append(d)
        return seen

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self._devs == other._devs
                and self.axis_names == other.axis_names)

    def __hash__(self):
        return hash((tuple(str(d) for d in self._devs), self.axis_names))

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self._devs]!r}, "
                f"axis_name={self.axis_names[0]!r})")


def default_mesh(n_devices: Optional[int] = None,
                 axis_name: str = "p") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` cards (all of them by
    default), the counterpart of ``Mesh(jax.devices()[:n])``.  Each card
    appears once.  Raises without CUDA, or when more cards are asked for
    than exist: it never builds a CPU mesh (``Mesh(["cpu"] * P)`` is the
    explicit way)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "default_mesh() needs CUDA: it spans the visible cards; build "
            "a CPU mesh explicitly with Mesh(['cpu'] * P)"
        )
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(
            f"n_devices must be in [1, {count}] (the visible cards), got "
            f"{n_devices}"
        )
    return Mesh([f"cuda:{i}" for i in range(n)], axis_name)


def as_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` as a :class:`Mesh`: None stays None, a Mesh is itself,
    a sequence of devices becomes a mesh over them."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, (list, tuple)):
        return Mesh(mesh)
    raise TypeError(
        f"mesh must be a pypardis_tpu_torch Mesh or a list of devices, "
        f"got {type(mesh).__name__}"
    )


def gather(tensors, device) -> torch.Tensor:
    """Per-shard tensors stacked on ``device`` (the shard axis first)."""
    return torch.stack([t.to(device) for t in tensors])


def shard_max(tensors, device) -> torch.Tensor:
    """The elementwise maximum over per-shard bool or int32 tensors, on
    ``device`` (the JAX ``pmax``)."""
    out = tensors[0].to(device)
    for t in tensors[1:]:
        out = torch.maximum(out, t.to(device))
    return out


def shard_min(tensors, device) -> torch.Tensor:
    """The elementwise minimum over per-shard int32 tensors, on
    ``device`` (the JAX ``pmin``)."""
    out = tensors[0].to(device)
    for t in tensors[1:]:
        out = torch.minimum(out, t.to(device))
    return out
