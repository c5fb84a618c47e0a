"""tpu-rpforest: a random-projection-forest ANN engine for accelerators.

Built from scratch in JAX/XLA/Pallas with the capabilities of the Haskell
``rp-tree`` library (ocramz/rp-tree; sparse random projection trees per
Hyvonen et al. 2016).  The public facade mirrors the reference's single
exposed module ``Data.RPTree`` (``src/Data/RPTree.hs:50-113``):

Construction (batch):    :func:`tree_batch`, :func:`forest_batch`
Construction (stream):   :func:`tree`, :func:`forest`
Parameters:              :func:`rp_tree_cfg`, :class:`RPTreeConfig`
Queries:                 :meth:`RPForest.knn`, ``knn_h``, ``knn_pq``
I/O:                     :func:`serialise_rp_forest`, :func:`deserialise_rp_forest`
Statistics:              :meth:`RPForest.recall_with`
Access:                  ``leaves``, ``levels``, ``points``, ``candidates``
Validation:              ``tree_stats``, ``tree_size``, ``leaf_sizes``
Vector types:            :class:`SVec` (sparse), dense = ndarray;
                         batched sparse datasets: :class:`EllMatrix`
Vector ops (``Inner``):  :func:`inner`, :func:`metric_l2`, ...
Rendering:               :func:`write_csv`, :func:`knn_write_csv`,
                         :func:`write_dot`, :func:`draw`
Testing / generation:    :class:`BenchConfig`, :func:`rand_seed`,
                         :func:`data_batch`, :func:`data_source`, samplers
"""

import os as _os

import jax as _jax

#: Persistent compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: a fixed path inside the checkout (the path is part of the cache
#: key, so a directory that moves never hits).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _compile_cache_dir(environ, platforms):
    """Where this process keeps JAX's persistent compile cache, or None.

    ``JAX_COMPILATION_CACHE_DIR`` wins (JAX reads it itself, so no other
    directory is set); ``RPTREE_TPU_NO_CACHE=1`` opts out; CPU runs keep
    no cache (CPU executables are fingerprinted to the host's features,
    and reloading one across a mismatch risks SIGILL).  Otherwise
    :data:`CACHE_DIR`."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if environ.get("RPTREE_TPU_NO_CACHE"):
        return None
    if "cpu" in (platforms or ""):
        return None
    return CACHE_DIR


_cache = _compile_cache_dir(
    _os.environ, _os.environ.get("JAX_PLATFORMS", "")
    or (_jax.config.jax_platforms or ""))
if _cache is not None and _jax.config.jax_compilation_cache_dir is None:
    try:
        _os.makedirs(_cache, exist_ok=True)
    except OSError:  # read-only checkout: run without a persistent cache
        _cache = None
    if _cache is not None:
        _jax.config.update("jax_compilation_cache_dir", _cache)
        _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import (BenchConfig, ForestConfig, RPTreeConfig,
                     rp_tree_cfg, rp_tree_cfg_clustered)
from .models.forest import RPForest, forest_batch, tree_batch
from .models.plan import TreePlan, make_plan
from .streaming import ForestBuilder, forest, tree
from .tuning import tune, tune_build
from .utils.draw import (
    draw,
    knn_write_csv,
    leaf_label_of_points,
    to_dot,
    tree_to_string,
    write_csv,
    write_dot,
)
from .utils import ingest  # fvecs/bvecs/ivecs/idx readers + chunk sources
from .utils.median import StreamingMedian
from .utils import profiling  # named rpt_* scopes + trace()/sync() helpers
from .utils.profiling import device_time
from .utils.io import (
    deserialise_rp_forest,
    load_forest,
    load_forest_sharded,
    save_forest,
    save_forest_sharded,
    serialise_rp_forest,
)
from .ops.sparse import (
    EllMatrix,
    ell_from_scipy_like,
    ell_from_svecs,
    ell_project,
    ell_sq_norms,
    ell_to_dense,
)
from .ops.vector import (
    SVec,
    add,
    from_list_dv,
    from_list_sv,
    from_vector_sv,
    inner,
    inner_dd,
    inner_sd,
    inner_ss,
    metric_dd_l2,
    metric_l2,
    metric_sd_l2,
    metric_ss_l2,
    normalize,
    scale,
    sub,
    to_dense,
)
from .utils.gen import (
    circle2d,
    circle2d2,
    data_batch,
    data_source,
    dense,
    mixture,
    mixture2,
    normal2,
    normal_dense2,
    normal_sparse2,
    rand_seed,
    sample_projections,
    sample_wor,
    sparse,
)
from .version import __version__


# Function-first query API (the reference's ``knn distf k forest q`` calling
# convention, pythonified as ``knn(forest, q, k, ...)``).

def knn(forest_, q, k, **kw):
    """k nearest neighbours (reference ``knn``, RPTree.hs:159-176)."""
    return forest_.knn(q, k, **kw)


def knn_h(forest_, q, k, **kw):
    """Margin-priority kNN (reference ``knnH``, RPTree.hs:196-217)."""
    return forest_.knn_h(q, k, **kw)


def knn_pq(forest_, q, k, **kw):
    """Deduplicating kNN (reference ``knnPQ``, RPTree.hs:178-194)."""
    return forest_.knn_pq(q, k, **kw)


def knn_h_buckets(forest_, q, k, **kw):
    """Raw (unsorted, untruncated) knnH bucket contents -- the reference
    ``knnH``'s return contract (RPTree.hs:196-217)."""
    return forest_.knn_h_buckets(q, k, **kw)


def candidates(forest_, q, **kw):
    """Candidate point ids per tree (reference ``candidates``)."""
    return forest_.candidates(q, **kw)


def recall_with(forest_, q, k, **kw):
    """Mean per-tree recall@k (reference ``recallWith``)."""
    return forest_.recall_with(q, k, **kw)


def tree_size(forest_, t: int = 0):
    """Points stored in a tree (reference ``treeSize``)."""
    return forest_.tree_size(t)


def leaf_sizes(forest_):
    """Per-leaf occupancy (reference ``leafSizes``)."""
    return forest_.leaf_sizes()


def tree_stats(forest_):
    """Node counts (reference ``treeStats``)."""
    return forest_.tree_stats()


def leaves(forest_, t: int = 0):
    """Leaf buckets as point-id lists (reference ``leaves``)."""
    return forest_.leaves(t)


def levels(forest_):
    """Number of projection levels (reference ``levels``)."""
    return forest_.levels()


def points(forest_):
    """The indexed dataset (reference ``points``)."""
    return forest_.points()


__all__ = [name for name in dir() if not name.startswith("_")]
