"""Benchmark harness (the reference's ``bench/time/Main.hs``).

Reproduces the reference time benchmark's structure:

* a grid of :class:`~rptree_tpu.config.BenchConfig` experiment descriptors
  (``bench/time/Main.hs:42-50`` -- the shipped grid is a single point);
* per config: build a forest over a binary sparse-Gaussian-mixture stream
  (``binMixFQBench``, ``bench/time/Main.hs:54-84`` over ``datS``,
  ``Internal/Testing.hs:38-44``), measure mean recall@10 over the query
  points, and wall-clock build/query times with a numerically stable
  running mean (the vendored benchpress-style ``benchmark`` harness,
  ``bench/time/Main.hs:175-230``);
* results printed as one dict per config (the reference ``print``s to
  stdout, ``bench/time/Main.hs:60-62``).

The additions: batched-query QPS (the reference queries one point at a
time) and optional mesh sharding via the config's ``n_tree_shards`` /
``n_query_shards`` fields.

Run: ``python -m rptree_tpu.benchmarks``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from .config import BenchConfig
from .models.forest import RPForest, forest_batch
from .utils import gen as rgen

__all__ = ["benchmark", "run_bench", "bench_grid", "DEFAULT_GRID",
           "REFERENCE_SCALE_GRID", "dense_to_ell"]


def benchmark(fn: Callable[[], object], reps: int = 2) -> Tuple[float, object]:
    """Mean wall seconds of ``fn`` over ``reps`` runs, running-mean
    accumulation (reference ``benchmark``/``mean``,
    ``bench/time/Main.hs:175-230``; wall clock instead of ``getCPUTime``
    because device work is asynchronous to the host CPU)."""
    mean = 0.0
    out = None
    for i in range(1, reps + 1):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        mean += (dt - mean) / i
    return mean, out


def _fetch(x) -> np.ndarray:
    """Force completion via a host fetch of the result."""
    return np.asarray(x)


def dense_to_ell(x: np.ndarray):
    """Pack a dense array's nonzeros into a padded-ELL sparse dataset."""
    from .ops.sparse import EllMatrix

    nz = x != 0
    k = max(1, int(nz.sum(axis=1).max()))
    n = x.shape[0]
    cols = np.zeros((n, k), np.int32)
    vals = np.zeros((n, k), np.float32)
    for i in range(n):
        idx = np.nonzero(nz[i])[0]
        cols[i, : idx.size] = idx
        vals[i, : idx.size] = x[i, idx]
    return EllMatrix(x.shape[1], cols, vals)


def run_bench(cfg: BenchConfig, seed: int = 1234,
              data_nz: Optional[float] = None,
              reps: int = 2, mesh=None) -> dict:
    """Run one experiment: build + recall@10 + QPS (``binMixFQBench``,
    bench/time/Main.hs:54-84).  ``data_nz`` is the data's nonzero density
    (the reference grid uses 0.8).  ``cfg.sparse_input`` routes the dataset
    through the padded-ELL path (SVector semantics); ``cfg.streaming``
    builds through the chunked-ingest pipeline."""
    if data_nz is None:
        data_nz = cfg.data_nz
    gen = lambda key, n: rgen.normal_sparse2(  # noqa: E731
        key, n, cfg.vector_dim, data_nz
    )
    x = np.asarray(rgen.data_batch(seed, cfg.data_size, gen), np.float32)
    q = np.asarray(rgen.data_batch(seed + 1, cfg.num_query_points, gen),
                   np.float32)
    data = dense_to_ell(x) if cfg.sparse_input else x

    def build() -> RPForest:
        if cfg.streaming:
            from . import forest as forest_stream

            chunks = iter(np.array_split(x, max(1, cfg.data_size
                                                // cfg.chunk_size)))
            f = forest_stream(seed, cfg.max_depth, cfg.min_leaf,
                              cfg.num_trees, cfg.chunk_size, cfg.nz_density,
                              cfg.vector_dim, chunks)
        else:
            f = forest_batch(seed, cfg.max_depth, cfg.min_leaf,
                             cfg.num_trees, cfg.nz_density, data)
        if mesh is not None or cfg.n_tree_shards * cfg.n_query_shards > 1:
            from .parallel import distribute, forest_mesh

            m = mesh if mesh is not None else forest_mesh(
                cfg.n_tree_shards, cfg.n_query_shards
            )
            f = distribute(f, m)
        f.pack_leaves()  # serving layout (dense blocks, or EllBlocks for
        #                  sparse bag-of-words datasets)
        _fetch(f.arrays.perm)
        return f

    t_build, f = benchmark(build, reps=1)

    k = 10

    def queries():
        out = []
        for s in range(0, cfg.num_query_points, cfg.batch_size):
            out.append(f.knn(q[s:s + cfg.batch_size], k))
        return [(_fetch(d), _fetch(i)) for d, i in out]

    queries()  # compile + warm
    t_query, outs = benchmark(queries, reps=reps)

    recall = float(np.mean(_fetch(f.recall_with(q, k))))
    # forest-level recall of the returned neighbours (the per-tree
    # recallWith above mirrors the reference's metric, RPTree.hs:259-268,
    # and is tiny by construction at deep configs)
    got = np.concatenate([i for _, i in outs], axis=0)
    exact = _fetch(f.brute_force_knn(q, k)[1])
    recall_forest = float(np.mean([
        len(set(got[b].tolist()) & set(exact[b].tolist())) / k
        for b in range(got.shape[0])
    ]))
    return {
        "description": cfg.description,
        "recall_at_10": round(recall_forest, 4),
        "recall_per_tree": round(recall, 4),
        "build_s": round(t_build, 4),
        "query_s": round(t_query, 4),
        "qps": round(cfg.num_query_points / t_query, 1),
        "config": cfg,
    }


# the reference's shipped grid: one point (bench/time/Main.hs:42-50)
DEFAULT_GRID: List[BenchConfig] = [
    BenchConfig(
        description="binary sparse-Gaussian mixture",
        max_depth=5, min_leaf=10, num_trees=3, chunk_size=100,
        nz_density=0.2, vector_dim=1000, data_size=1000,
        num_query_points=10, batch_size=10,
    ),
]

# BASELINE.json configs[], scaled to bench-friendly sizes
REFERENCE_SCALE_GRID: List[BenchConfig] = [
    BenchConfig(description="configs[0] single tree, 784-d, knn k=10",
                max_depth=9, min_leaf=20, num_trees=1, chunk_size=1000,
                nz_density=0.35, vector_dim=784, data_size=10_000,
                num_query_points=128, batch_size=128),
    BenchConfig(description="configs[1] 10-tree forest recall@10",
                max_depth=9, min_leaf=20, num_trees=10, chunk_size=1000,
                nz_density=0.35, vector_dim=784, data_size=10_000,
                num_query_points=128, batch_size=128),
    BenchConfig(description="configs[2] sparse bag-of-words (padded ELL)",
                max_depth=8, min_leaf=32, num_trees=4, chunk_size=1000,
                nz_density=0.25, vector_dim=10_000, data_size=8_000,
                num_query_points=64, batch_size=64, sparse_input=True,
                data_nz=0.01),
    BenchConfig(description="configs[3] SIFT-shaped dense forest",
                max_depth=11, min_leaf=64, num_trees=8, chunk_size=1000,
                nz_density=0.47, vector_dim=128, data_size=100_000,
                num_query_points=512, batch_size=512),
    BenchConfig(description="configs[4] streaming chunked-ingest build",
                max_depth=9, min_leaf=32, num_trees=4, chunk_size=2_000,
                nz_density=0.35, vector_dim=960, data_size=20_000,
                num_query_points=64, batch_size=64, streaming=True),
]


def bench_grid(grid: Optional[List[BenchConfig]] = None, seed: int = 1234,
               reps: int = 2) -> List[dict]:
    """Run a grid of configs, printing one result dict per line (the
    reference's main, bench/time/Main.hs:54-66)."""
    results = []
    for cfg in grid if grid is not None else DEFAULT_GRID:
        r = run_bench(cfg, seed=seed, reps=reps)
        print({k: v for k, v in r.items() if k != "config"}, flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    import sys

    if "--reference-scale" in sys.argv:
        bench_grid(REFERENCE_SCALE_GRID)
    else:
        bench_grid()
