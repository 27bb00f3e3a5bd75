"""Config surface (counterpart of ``pypardis_tpu/config.py``).

The fit's constructor kwargs as serializable data, the JAX package's
fields (the sharding knobs ``max_partitions``, ``split_method`` and
``owner_computes`` among them) and the port's own (``device``,
``sketch``, ``profile_dir``, ``flight``).  ``from_dict`` ignores keys
it does not know, so a JAX config dict loads here unchanged; the mesh
is not data and comes to :meth:`DBSCANConfig.build`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class DBSCANConfig:
    """Everything the port's ``DBSCAN(...)`` accepts, as data."""

    eps: float = 0.5
    min_samples: int = 5
    metric: Any = "euclidean"
    max_partitions: Optional[int] = None
    split_method: str = "min_var"
    block: int = 1024
    precision: str = "high"
    kernel_backend: str = "auto"
    # None = the card ("cuda"); "cpu" runs the plain torch versions.
    device: Optional[str] = None
    # None defers to PPTORCH_SKETCH; "auto", "off"/0 or a pinned k.
    sketch: Any = None
    # A directory each fit writes a torch.profiler Chrome trace into.
    profile_dir: Optional[str] = None
    # The flight recorder: a *.jsonl path or a directory (None defers
    # to PPTORCH_FLIGHT).
    flight: Optional[str] = None
    # Owned-row clustering on the fused multi-device step (halo points
    # relay labels, never clustered again); False clusters every halo
    # duplicate again.
    owner_computes: bool = True

    def build(self, mesh=None):
        from .dbscan import DBSCAN

        return DBSCAN(mesh=mesh, **dataclasses.asdict(self))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if callable(d["metric"]):
            d["metric"] = getattr(d["metric"], "__name__", "euclidean")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DBSCANConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
