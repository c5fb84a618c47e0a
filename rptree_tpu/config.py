"""Configuration records.

Mirrors the reference's configuration surface:

* ``RPTreeConfig`` / ``rp_tree_cfg`` -- the auto-config heuristic of the
  reference (``src/Data/RPTree/Conduit.hs:123-141``): closed-form defaults
  for max tree depth, streaming chunk size, and projection nonzero density.
* ``BenchConfig`` -- the 9-field experiment descriptor of the reference
  (``src/Data/RPTree/Internal/Testing.hs:21-31``), extended with device
  mesh fields (which have no reference counterpart; see SURVEY.md section 2.11).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RPTreeConfig:
    """Construction parameters for one RP tree / forest.

    Field parity with the reference's ``RPCfg`` record
    (``src/Data/RPTree/Conduit.hs:123-128``), with min-leaf kept explicit.
    """

    max_depth: int          # fpMaxTreeDepth: max tree depth (> 1)
    min_leaf: int           # minimum leaf size (points per leaf before stopping)
    chunk_size: int         # fpDataChunkSize: streaming data chunk size
    proj_nz_density: float  # fpProjNzDensity: nonzero density of projections


def rp_tree_cfg(min_leaf: int, n: int, dim: int) -> RPTreeConfig:
    """Auto-configure construction parameters with natural defaults.

    Reproduces the closed-form heuristic of the reference
    (``src/Data/RPTree/Conduit.hs:132-141``):

    * ``max_depth = ceil(log2(n / min_leaf))``
    * ``chunk_size = ceil(n / 100)``
    * ``proj_nz_density = min(1 / log10(dim), 1.0)``
    """
    if n <= 0:
        raise ValueError(f"dataset size must be positive, got {n}")
    if min_leaf <= 0:
        raise ValueError(f"min_leaf must be positive, got {min_leaf}")
    if dim <= 0:
        raise ValueError(f"dim must be positive, got {dim}")
    max_depth = max(1, math.ceil(math.log2(n / min_leaf)))
    chunk = math.ceil(n / 100)
    pnz = min(1.0 / math.log10(dim), 1.0) if dim > 1 else 1.0
    return RPTreeConfig(
        max_depth=max_depth,
        min_leaf=min_leaf,
        chunk_size=chunk,
        proj_nz_density=pnz,
    )


def rp_tree_cfg_clustered(n: int, dim: int, *,
                          centers: int) -> "RPTreeConfig":
    """Closed-form construction heuristic for CLUSTERED data (Gaussian
    mixtures and real embedding workloads), the empirical counterpart of
    the reference's iid heuristic :func:`rp_tree_cfg`.

    Sweeps over clustered data (``examples/clustered_1m.py``) put
    ``min_leaf ~ n / centers`` at the recall/QPS sweet spot: the per-tree leaf then covers most of a
    query's cluster and the cross-tree union the rest (half that size
    saturates recall at the union-reachable set; double reaches higher
    recall at ~0.7x the QPS).  Serve with ``budget=1`` and
    ``probes ~ n_trees`` -- cluster-pure leaves make wide frontiers
    redundant.

    When no reliable ``centers`` estimate exists, sweep it empirically
    with :func:`rptree_tpu.tuning.tune_build` instead.
    """
    if centers <= 0:
        raise ValueError(f"centers must be positive, got {centers}")
    min_leaf = max(8, min(int(n), int(round(n / centers))))
    return rp_tree_cfg(min_leaf, int(n), int(dim))


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Full forest construction configuration.

    Bundles the per-tree parameters with the forest size and randomness; the
    reference passes these positionally to ``forestBatch``
    (``src/Data/RPTree/Batch.hs:48-63``) and ``forest``
    (``src/Data/RPTree/Conduit.hs:104-121``).
    """

    n_trees: int
    max_depth: int
    min_leaf: int
    proj_nz_density: float
    dim: int
    chunk_size: int = 0       # only used by the streaming builder
    dtype: str = "float32"    # compute dtype for projections / distances


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """Experiment descriptor, field-for-field parity with the reference's
    ``BenchConfig`` (``src/Data/RPTree/Internal/Testing.hs:21-31``) plus
    device-mesh fields that have no reference counterpart."""

    description: str
    max_depth: int
    min_leaf: int
    num_trees: int
    chunk_size: int
    nz_density: float
    vector_dim: int
    data_size: int
    num_query_points: int
    # extensions with no reference counterpart
    batch_size: int = 128        # query batch size
    n_tree_shards: int = 1       # mesh axis over the forest (tree parallelism)
    n_query_shards: int = 1      # mesh axis over the query batch
    sparse_input: bool = False   # ingest as padded-ELL (SVector semantics)
    streaming: bool = False      # chunked-ingest build (conduit semantics)
    data_nz: float = 0.8         # data nonzero density (reference grid: 0.8)
