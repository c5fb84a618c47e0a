"""Parallel runtime: device meshes, sharded build, sharded query.

The reference has no parallelism of any kind (SURVEY.md section 2.11); this
package replaces its host-side Semigroup folds with device collectives.
"""

from .mesh import QUERY_AXIS, TREE_AXIS, forest_mesh
from .distributed import (
    DistributedForest,
    distribute,
    forest_batch_distributed,
    merge_top_k,
)
from .data_parallel import (
    DATA_AXIS,
    DataParallelForest,
    brute_force_knn_sharded,
    data_mesh,
    forest_batch_data_parallel,
)

__all__ = [
    "DATA_AXIS",
    "DataParallelForest",
    "QUERY_AXIS",
    "TREE_AXIS",
    "brute_force_knn_sharded",
    "data_mesh",
    "forest_batch_data_parallel",
    "forest_mesh",
    "DistributedForest",
    "distribute",
    "forest_batch_distributed",
    "merge_top_k",
]
