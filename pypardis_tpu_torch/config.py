"""Config surface (counterpart of ``pypardis_tpu/config.py``).

The single-device fit's constructor kwargs as serializable data.  The
sharding knobs of the JAX package (``max_partitions``,
``split_method``, ``owner_computes``) belong to the multi-GPU slice and
are not fields yet; ``from_dict`` ignores them, so a JAX config dict
loads here unchanged.
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
    block: int = 1024
    precision: str = "high"
    kernel_backend: str = "auto"
    # None = the card ("cuda"); "cpu" runs the plain torch versions.
    device: Optional[str] = None
    # None defers to PPTORCH_SKETCH; "auto", "off"/0 or a pinned k.
    sketch: Any = None

    def build(self):
        from .dbscan import DBSCAN

        return DBSCAN(**dataclasses.asdict(self))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if callable(d["metric"]):
            d["metric"] = getattr(d["metric"], "__name__", "euclidean")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DBSCANConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
