"""The one-process forms of the JAX package's ``parallel/dist.py`` that
the global-Morton mesh engine reads: one controller drives every shard
of a :class:`~.mesh.Mesh`, so a fetch is a copy to the host and the
process index is 0.  The multi-process forms (``torch.distributed``
over several hosts) come with the process layer (ROADMAP A10, §A item
5)."""

from __future__ import annotations

import numpy as np


def fetch_np(a) -> np.ndarray:
    """A tensor (on any device), a list of per-shard tensors (stacked)
    or an array, as a numpy array on the host."""
    if isinstance(a, (list, tuple)):
        return np.stack([fetch_np(t) for t in a])
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def process_index() -> int:
    """This controller's index among the fit's processes: always 0."""
    return 0
