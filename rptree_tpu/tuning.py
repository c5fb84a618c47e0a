"""Query-configuration auto-tuning.

The reference exposes raw knobs and a closed-form construction heuristic
(``rpTreeCfg``, Conduit.hs:132-141) but no way to pick query-time
parameters for a quality target.  :func:`tune` sweeps the (budget, probes)
surface on a validation query set against the exact brute-force answer,
MEASURES each configuration's throughput on the live device, and returns
the fastest configuration whose measured recall@k clears the target.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["tune", "tune_build"]


def tune(forest, queries, k: int = 10, target_recall: float = 0.9,
         budgets: Sequence[int] = (1, 2, 4, 8, 16, 32),
         probes_per_tree: Sequence[float] = (1.0, 1.5, 2.0, 3.0, 4.0),
         metric: str = "l2", precision: str = "highest",
         measure: bool = True, reps: int = 2,
         time_rows: int = 8192, serving: str = "batched") -> dict:
    """Pick the best (budget, probes) meeting ``target_recall``.

    With ``measure=True`` (default) every swept configuration -- and the
    always-included exact-scan candidate -- is TIMED on the validation
    batch (``reps`` repetitions after a warm-up call, completion forced by
    a host fetch), and the winner is the highest measured-QPS config
    clearing the target.  ``measure=False`` falls back to the static
    proxy cost ``budget + probes * max_leaf_len`` (reranked candidate
    slots plus traversal frontier width) and picks the cheapest.

    On dispatch-bound backends, timing a small validation batch would
    measure call overhead
    rather than per-query device cost and mis-rank configurations for
    large-batch serving.  The timed batch is therefore the validation
    queries TILED up to at least ``time_rows`` rows (recall still uses
    the original batch); set ``time_rows=0`` to time the raw batch.

    ``serving`` picks the pipeline the throughput is measured on:
    ``"batched"`` (default) times :meth:`knn_batched` on packed forests
    (the per-pair path), ``"grouped"`` times :meth:`knn_grouped` in its
    steady-state serving mode (capacity learned by a ``check=True``
    warm-up, timed calls ``check=False``) -- use it when production
    serves through the query-grouped rerank, whose QPS ordering over
    (budget, probes) can differ from the per-pair path's (block-fetch
    sharing grows with probe overlap).  Recall is measured on ``knn``
    either way (the paths are bit-comparable by construction).
    ``"grouped"`` requires a packed forest whose layout
    :meth:`knn_grouped` serves (dense blocks; leaf-sharded on meshes).

    Returns ``{"budget", "probes", "recall", "cost", "qps", "frontier"}``
    where ``frontier`` lists every measured point (for plotting
    recall/throughput curves).  If no configuration reaches the target,
    the best-recall configuration is returned with ``"met": False``.

    The exact scan is always a candidate: when it wins, the result has
    ``"scan": True`` and ``budget``/``probes`` are ``None`` -- serve those
    queries with ``forest.brute_force_knn(..., precision="fastest")``
    instead of ``knn``.  ALWAYS check ``"scan"`` before feeding the knobs
    back into ``knn`` (passing ``budget=None`` would silently use the
    defaults).  NOTE: the scan recommendation is only executable while the
    forest still holds its raw rows -- after ``drop_dataset()`` the
    serve-only forest cannot run ``brute_force_knn`` (and ``tune`` itself
    needs the raw rows for its ground truth).
    """
    from .models.forest import _as_dense_queries

    qb = np.asarray(_as_dense_queries(queries, forest.dim))
    _, exact = forest.brute_force_knn(qb, k)
    exact = np.asarray(exact)
    nq = qb.shape[0]

    # timing batch: tile the validation queries up to >= time_rows rows so
    # dispatch overhead amortizes (see docstring).  The tiled batch only
    # flows through memory-bounded paths: knn_batched (per-chunk peak) on
    # packed forests, the streaming brute-force scan -- the unpacked knn
    # path gathers [B, C, D] candidate rows and times the raw batch.
    tile = 1
    if measure and time_rows and nq < time_rows:
        tile = min(64, -(-int(time_rows) // nq))
    qt = np.tile(qb, (tile, 1)) if tile > 1 else qb
    n_timed = qt.shape[0]
    packed = getattr(forest, "_packed", None) is not None
    if serving not in ("batched", "grouped"):
        raise ValueError(f"serving must be 'batched' or 'grouped', "
                         f"got {serving!r}")
    if serving == "grouped" and not packed:
        raise ValueError("serving='grouped' needs pack_leaves() first")

    def timed_qps(fn, rows=nq):
        """Measured queries/s of one config: warm (compile) call, then
        ``reps`` timed calls, completion forced by the host fetch."""
        np.asarray(fn()[1])
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(fn()[1])
        dt = time.perf_counter() - t0
        return rows * reps / dt if dt > 0 else float("inf")

    lmax = max(forest.plan.max_leaf_len, 1)
    results = []
    for budget in sorted(set(int(b) for b in budgets)):
        budget = max(1, min(budget, forest.plan.n_leaves))
        for ppt in sorted(set(probes_per_tree)):
            probes = max(1, min(int(round(ppt * forest.n_trees)),
                                forest.n_trees * budget))

            def run(budget=budget, probes=probes):
                return forest.knn(qb, k, metric=metric, budget=budget,
                                  probes=probes, precision=precision)

            _, ids = run()
            ids = np.asarray(ids)
            recall = float(np.mean([
                len(set(ids[b].tolist()) & set(exact[b].tolist())) / k
                for b in range(nq)
            ]))
            point = {
                "budget": budget, "probes": probes, "recall": recall,
                # static proxy: reranked slots + traversal frontier work
                "cost": budget + probes * lmax,
            }
            if measure:
                if serving == "grouped":
                    # steady-state serving mode: the check=True warm-up
                    # learns + caches the tile capacity for this batch
                    # shape; the timed calls skip the per-batch capacity
                    # host fetch
                    q_timed = qt if tile > 1 else qb
                    forest.knn_grouped(q_timed, k, metric=metric,
                                       budget=budget, probes=probes,
                                       precision=precision, chunk=nq,
                                       check=True)

                    def run_g(budget=budget, probes=probes):
                        return forest.knn_grouped(
                            q_timed, k, metric=metric, budget=budget,
                            probes=probes, precision=precision,
                            chunk=nq, check=False)

                    point["qps"] = timed_qps(
                        run_g, rows=n_timed if tile > 1 else nq)
                    point["serving"] = "grouped"
                elif packed and tile > 1:
                    def run_t(budget=budget, probes=probes):
                        return forest.knn_batched(
                            qt, k, metric=metric, budget=budget,
                            probes=probes, precision=precision, chunk=nq)

                    point["qps"] = timed_qps(run_t, rows=n_timed)
                else:
                    point["qps"] = timed_qps(run)
            results.append(point)

    # the exact scan is always a candidate operating point; its cost
    # is every stored row.  On hard (e.g. iid high-dim) data the forest's
    # recall saturates below high targets while probes * lmax approaches
    # n, so the scan can be the best config meeting the target -- report
    # it honestly.  The scan is timed AND recall-measured at
    # precision="fastest" (what the recommendation serves with): its
    # per-tile approx_max_k selection is near-exact but NOT 1.0 at scale,
    # so crediting recall=1.0 could claim an
    # unmet target as met.
    n_all = forest.n_points + getattr(forest, "n_folded", 0)

    def run_scan():
        return forest.brute_force_knn(qb, k, metric=metric,
                                      precision="fastest")

    ids_scan = np.asarray(run_scan()[1])
    recall_scan = float(np.mean([
        len(set(ids_scan[b].tolist()) & set(exact[b].tolist())) / k
        for b in range(nq)
    ]))
    scan_point = {"budget": None, "probes": None, "recall": recall_scan,
                  "cost": n_all, "scan": True}
    if measure:
        if tile > 1:
            # the scan streams row chunks (peak memory bounded per tile),
            # so the tiled timing batch is always safe here
            def run_scan_t():
                return forest.brute_force_knn(qt, k, metric=metric,
                                              precision="fastest")

            scan_point["qps"] = timed_qps(run_scan_t, rows=n_timed)
        else:
            scan_point["qps"] = timed_qps(run_scan)
    results.append(scan_point)

    if measure:
        results.sort(key=lambda r: (-r["qps"], -r["recall"]))
    else:
        results.sort(key=lambda r: (r["cost"], -r["recall"]))
    meeting = [r for r in results if r["recall"] >= target_recall]
    if meeting:
        best = dict(meeting[0])
        best["met"] = True
    else:
        best = dict(max(results, key=lambda r: r["recall"]))
        best["met"] = False
    best["frontier"] = results
    return best


def tune_build(data, queries, k: int = 10, target_recall: float = 0.9,
               n_trees_grid: Sequence[int] = (8,),
               min_leaf_grid: Optional[Sequence[int]] = None,
               centers_estimate: Optional[int] = None,
               sample: int = 131072, full_n: Optional[int] = None,
               seed: int = 0, budgets: Sequence[int] = (1, 2),
               probes_per_tree: Sequence[float] = (1.0, 2.0),
               metric: str = "l2", precision: str = "default",
               measure: bool = False, pack=True,
               serving: str = "batched") -> dict:
    """Sweep BUILD-side parameters (n_trees, min_leaf) on a data
    SUBSAMPLE, then scale the winning leaf size to the full dataset.

    :func:`tune` only sweeps query-time knobs on a fixed forest; sweeps
    over clustered data show the build-side knob
    ``min_leaf`` dominates on clustered data (``min_leaf ~ n/centers`` is
    the sweet spot).  This encodes that sweep: cheap rebuilds on
    ``sample`` rows, each evaluated by :func:`tune` over a small
    (budget, probes) grid, winner = the config meeting ``target_recall``
    at the lowest cost (or highest measured QPS with ``measure=True``).
    Cluster structure is scale-free in the leaf-to-cluster RATIO, so the
    winning subsample leaf size transfers to the full dataset as
    ``min_leaf_full = min_leaf * full_n / sample`` (rounded to a power of
    two) -- pass ``full_n`` when ``data`` is already a subsample of the
    corpus to be indexed.

    ``data`` may be host rows, a (possibly point-sharded) jax array, or
    a sharded forest handle (``DataParallelForest`` /
    ``DistributedForest``) -- the subsample is then gathered on device,
    so the host never buffers more than ``sample`` rows and the sweep
    runs at beyond-one-chip corpus scale; ``full_n`` defaults to the
    sharded corpus size.

    ``min_leaf_grid`` defaults to {1/2x, 1x, 2x} of ``sample /
    centers_estimate`` when an estimate is given, else a coarse
    power-of-four ladder.  Returns ``{"n_trees", "min_leaf",
    "min_leaf_full", "budget", "probes", "recall", "met", "scan",
    "frontier"}``; ``scan=True`` means no swept forest met the target and
    the exact scan is the recommended serving path.
    """
    from .models.forest import forest_batch
    from .config import rp_tree_cfg

    if hasattr(data, "mesh") and hasattr(data, "x"):
        # a sharded forest handle (DataParallelForest / DistributedForest):
        # tune the BUILD knobs from its dataset without materializing it
        if data.x is None:
            raise ValueError("dataset dropped; tune_build samples rows")
        data = data.x
    if isinstance(data, jax.Array):
        # device-side subsample: one small gather on the (possibly
        # point-sharded) array, so the host never buffers more than the
        # ``sample`` rows -- tune_build at beyond-one-chip scale
        # (np.asarray on a sharded dataset would defeat the sharding)
        n = int(data.shape[0])
        m = min(int(sample), n)
        if m < n:
            rng = np.random.default_rng(seed)
            idx = np.sort(rng.choice(n, size=m, replace=False))
            x = np.asarray(
                jnp.take(data, jnp.asarray(idx.astype(np.int32)), axis=0),
                dtype=np.float32)
        else:
            x = np.asarray(data, dtype=np.float32)
        if full_n is None:
            full_n = n  # the sharded corpus IS the indexing target
    else:
        x = np.asarray(data, dtype=np.float32)
        n = x.shape[0]
        m = min(int(sample), n)
        if m < n:
            rng = np.random.default_rng(seed)
            x = x[rng.choice(n, size=m, replace=False)]
    full = int(full_n) if full_n else n
    if min_leaf_grid is None:
        if centers_estimate:
            base = max(8, int(round(m / centers_estimate)))
            min_leaf_grid = sorted({max(8, base // 2), base, 2 * base})
        else:
            min_leaf_grid = [ml for ml in (16, 64, 256, 1024) if ml < m]
    frontier = []
    for t in sorted(set(int(t) for t in n_trees_grid)):
        for ml in sorted(set(int(ml) for ml in min_leaf_grid)):
            cfg = rp_tree_cfg(ml, m, x.shape[1])
            f = forest_batch(seed, cfg.max_depth, ml, t,
                             cfg.proj_nz_density, x)
            if pack:
                f.pack_leaves(dtype=None if pack is True else pack)
            r = tune(f, queries, k=k, target_recall=target_recall,
                     budgets=budgets, probes_per_tree=probes_per_tree,
                     metric=metric, precision=precision, measure=measure,
                     serving=serving)
            r = dict(r)
            r["n_trees"], r["min_leaf"] = t, ml
            frontier.append(r)
            del f
    meeting = [r for r in frontier if r["met"] and not r.get("scan")]
    if meeting:
        key = ((lambda r: -r.get("qps", 0.0)) if measure
               else (lambda r: r["cost"]))
        best = dict(min(meeting, key=key))
    else:
        # no forest config met the target: recommend the scan if IT met
        # it anywhere, else the best-recall forest
        scans = [r for r in frontier if r["met"]]
        best = dict(scans[0] if scans
                    else max(frontier, key=lambda r: r["recall"]))
    ml_full = max(8, int(best["min_leaf"] * full / m))
    best["min_leaf_full"] = 1 << (ml_full - 1).bit_length() \
        if ml_full & (ml_full - 1) else ml_full
    best.pop("frontier", None)
    best["frontier"] = frontier
    return best
