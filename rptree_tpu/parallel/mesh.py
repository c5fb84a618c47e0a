"""Device-mesh construction for the forest's two parallel axes.

The reference is a single-core in-memory library (SURVEY.md section 2.11:
no threads, no processes, no communication anywhere in ocramz/rp-tree), so
device parallelism has no reference counterpart to imitate.  The natural axes
of this workload are:

* ``"tree"`` -- the forest axis.  Trees are independent during both build
  (``createMulti``'s per-tree map, ``Internal.hs:228-240``) and candidate
  generation; only the candidate-union / top-k merge at the end of a query
  couples them (the Semigroup fold at ``RPTree.hs:176``), which becomes an
  ``all_gather`` + re-top-k over the interconnect.
* ``"query"`` -- the query batch.  Queries never interact; this axis is
  embarrassingly parallel (pure data parallelism).

The mesh is a plain reshape of the device list, shaped by the algorithm
alone: every device reaches every other at the same rate (NVLink, all to
all, within a host), so no placement is better than another.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["forest_mesh", "TREE_AXIS", "QUERY_AXIS"]

TREE_AXIS = "tree"
QUERY_AXIS = "query"


def forest_mesh(
    n_tree_shards: Optional[int] = None,
    n_query_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(tree, query)`` device mesh.

    Defaults to putting every available device on the tree axis (tree
    parallelism is the workload's primary scaling direction: per-device
    memory holds fewer trees, and the only collective is the final top-k
    merge).  ``n_tree_shards * n_query_shards`` must equal the device
    count used.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_tree_shards is None:
        n_tree_shards = max(1, n // max(1, n_query_shards))
    if n_tree_shards * n_query_shards != n:
        raise ValueError(
            f"mesh shape ({n_tree_shards} tree x {n_query_shards} query) "
            f"!= {n} devices"
        )
    dev_grid = np.asarray(devices).reshape(n_tree_shards, n_query_shards)
    return Mesh(dev_grid, (TREE_AXIS, QUERY_AXIS))
