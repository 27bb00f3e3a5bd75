"""pypardis_tpu_torch: the DBSCAN of ``pypardis_tpu`` on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package ``pypardis_tpu`` is the reference; this package imports
nothing of it, nor of JAX.  Entry points run on the card unless the
caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions.
"""

from . import obs
from .aggregator import ClusterAggregator, default_value
from .checkpoint import (
    load_index,
    load_model,
    load_partitioner,
    save_index,
    save_model,
    save_partitioner,
)
from .config import DBSCANConfig
from .dbscan import (
    DBSCAN,
    SweepResult,
    dbscan_partition,
    map_cluster_id,
    sweep_dbscan,
)
from .geometry import BoundingBox
from .partition import (
    KDPartitioner,
    mean_var_split,
    median_search_split,
    min_var_split,
)
from .serve import CorePointIndex, QueryEngine

__version__ = "0.1.0"

__all__ = [
    "DBSCAN", "BoundingBox", "ClusterAggregator", "default_value",
    "DBSCANConfig",
    "CorePointIndex", "QueryEngine", "KDPartitioner", "SweepResult",
    "median_search_split", "mean_var_split", "min_var_split",
    "dbscan_partition", "map_cluster_id", "sweep_dbscan", "save_model",
    "load_model", "save_partitioner", "load_partitioner", "save_index",
    "load_index", "obs", "__version__",
]
