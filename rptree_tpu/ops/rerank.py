"""Candidate gather, union/dedup, exact rerank, fused top-k.

The query-side hot path after traversal.  The reference unions per-tree
candidate buckets with a Semigroup fold, maps the exact distance function
over every candidate, sorts, and takes k (``src/Data/RPTree.hs:159-176``).
Here:

* leaf buckets become a static-shape gather from each tree's permutation
  (leaf spans are compile-time constants);
* the union across trees is a concatenation along the candidate axis;
  deduplication (the reference's ``knnPQ``/``nub``, ``RPTree.hs:223-227``)
  is an id-sort + adjacent-equality mask;
* the exact distance is computed in the factored form
  ``d2(x, q) = |x|^2 - 2 x.q + |q|^2`` so the bulk of the work is one
  batched GEMM over gathered candidate rows (matmul-friendly), with squared
  norms precomputed once per dataset;
* selection is ``lax.top_k`` over negated distances.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.plan import TreePlan
from .sparse import EllMatrix

__all__ = [
    "gather_leaf_points",
    "leaf_positions",
    "dedup_ids",
    "merge_top_k",
    "rerank_top_k",
    "candidate_distances",
    "distances_from_dots",
    "METRICS",
]


def leaf_positions(plan: TreePlan, leaf_ids: jax.Array):
    """Expand leaf ids into *positions* in leaf-sorted (permutation) order.

    ``leaf_ids``: int32[..., F] with -1 for empty.  Returns ``(pos
    int32[..., F * max_leaf_len], valid bool[same])``; invalid slots point
    at position 0.  Positions within one leaf are contiguous -- the basis
    of the leaf-packed rerank path, where candidate gathers become
    contiguous-run reads instead of random row fetches.
    """
    lmax = max(plan.max_leaf_len, 1)
    starts = jnp.asarray(plan.leaf_start)
    lens = jnp.asarray(plan.leaf_len)
    safe = jnp.clip(leaf_ids, 0, plan.n_leaves - 1)
    s = jnp.take(starts, safe)
    m = jnp.take(lens, safe)
    offs = jnp.arange(lmax, dtype=jnp.int32)
    pos = s[..., None] + offs
    valid = (leaf_ids >= 0)[..., None] & (offs < m[..., None])
    pos = jnp.where(valid, pos, 0)
    flat = pos.shape[:-2] + (pos.shape[-2] * pos.shape[-1],)
    return pos.reshape(flat), valid.reshape(flat)


def gather_leaf_points(plan: TreePlan, perm: jax.Array, leaf_ids: jax.Array) -> jax.Array:
    """Expand leaf ids into the point ids stored in those leaf buckets.

    ``perm``: int32[n] (one tree's permutation).  ``leaf_ids``: int32[..., F]
    with -1 for empty.  Returns int32[..., F * max_leaf_len] point ids with
    -1 padding.  Leaf spans are static; ragged occupancy is handled by
    masking, not padding of the index itself (SURVEY.md section 7).
    """
    pos, valid = leaf_positions(plan, leaf_ids)
    ids = jnp.take(perm, pos, axis=-1)
    return jnp.where(valid, ids, -1)


def _run_lengths(ids_sorted: jax.Array) -> jax.Array:
    """Length of each equal-id run, at every position (ids sorted asc).

    Pure cumulative ops (no gathers): forward cummax of run-start indices
    gives each run's start, a reversed one gives its end.
    """
    m = ids_sorted.shape[-1]
    pos = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32), ids_sorted.shape)
    start = jnp.concatenate(
        [jnp.ones_like(ids_sorted[..., :1], dtype=bool),
         ids_sorted[..., 1:] != ids_sorted[..., :-1]],
        axis=-1,
    )
    run_start = lax.cummax(jnp.where(start, pos, -1), axis=ids_sorted.ndim - 1)
    end_mark = jnp.concatenate([start[..., 1:],
                                jnp.ones_like(start[..., :1])], axis=-1)
    run_end = jnp.flip(
        lax.cummin(jnp.flip(jnp.where(end_mark, pos, m), axis=-1),
                   axis=ids_sorted.ndim - 1),
        axis=-1,
    )
    return run_end - run_start + 1


def dedup_ids(ids: jax.Array, min_votes: int = 1) -> jax.Array:
    """Sort candidate ids ascending and mask duplicates (and -1 padding)
    to -1.  Input/output: int32[B, C].

    ``min_votes > 1`` additionally drops candidates that appear in fewer
    than that many trees -- the *voting* filter of Hyvonen et al. 2016
    (the paper the reference cites at ``src/Data/RPTree.hs:47``; the
    reference itself only ever unions candidate sets).
    """
    ids_sorted = jnp.sort(ids, axis=-1)
    dup = jnp.concatenate(
        [jnp.zeros_like(ids_sorted[..., :1], dtype=bool),
         ids_sorted[..., 1:] == ids_sorted[..., :-1]],
        axis=-1,
    )
    out = jnp.where(dup | (ids_sorted < 0), -1, ids_sorted)
    if min_votes > 1:
        votes = _run_lengths(ids_sorted)
        out = jnp.where(votes < min_votes, -1, out)
    return out


def merge_top_k(
    dists: jax.Array, ids: jax.Array, k: int, dedup: bool = True,
    min_votes: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Select the k best from an already-scored candidate list, optionally
    masking duplicate ids first.

    ``dists f32[B, M]`` / ``ids int32[B, M]`` -> ``([B, k], [B, k])``.
    Duplicates carry bit-identical distances (same deterministic scoring of
    the same point), so keeping any single copy is exact.  Used both for
    post-distance dedup in the leaf-packed rerank and for the cross-shard
    top-k merge in :mod:`rptree_tpu.parallel.distributed` (the collective
    form of the reference's Semigroup union, ``RPTree.hs:176``).
    """
    if dedup or min_votes > 1:
        # sort by id carrying distances as a payload operand: multi-operand
        # lax.sort moves payloads inside the comparator network, avoiding
        # the two per-element take_along_axis gathers an argsort would need
        ids, dists = lax.sort((ids, dists), num_keys=1)
        drop = jnp.concatenate(
            [jnp.zeros_like(ids[..., :1], dtype=bool),
             (ids[..., 1:] == ids[..., :-1]) & (ids[..., 1:] >= 0)],
            axis=-1,
        )
        if min_votes > 1:
            # voting filter (Hyvonen et al. 2016): candidates must appear
            # in at least min_votes trees
            drop = drop | (_run_lengths(ids) < min_votes)
        dists = jnp.where(drop, jnp.inf, dists)
        ids = jnp.where(drop, -1, ids)
    k = min(k, ids.shape[-1])
    d, out_ids = lax.sort((dists, ids), num_keys=1)
    d, out_ids = d[..., :k], out_ids[..., :k]
    return d, jnp.where(jnp.isinf(d), -1, out_ids)


def distances_from_dots(dots: jax.Array, sqx: jax.Array, q: jax.Array,
                        metric: str = "l2") -> jax.Array:
    """Distances from precomputed inner products ``dots[..., C]`` and
    candidate squared norms ``sqx[..., C]`` (``q``: ``[B, D]`` broadcast
    against the trailing query axes of ``dots``)."""
    if metric in ("l2", "sql2"):
        sqq = jnp.sum(q * q, axis=-1)[..., None]
        d = jnp.maximum(sqx - 2.0 * dots + sqq, 0.0)
        return jnp.sqrt(d) if metric == "l2" else d
    if metric == "cosine":
        nq = jnp.sqrt(jnp.sum(q * q, axis=-1))[..., None]
        return 1.0 - dots / jnp.maximum(jnp.sqrt(sqx) * nq, 1e-30)
    if metric == "dot":
        return -dots
    raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRICS)}")


def _gather_rows(x, ids: jax.Array):
    """Gather candidate rows; returns (rows, extra) where for dense data
    rows is ``[B, C, D]`` and for ELL data it is a (cols, vals) pair."""
    safe = jnp.clip(ids, 0, None)
    if isinstance(x, EllMatrix):
        return jnp.take(x.cols, safe, axis=0), jnp.take(x.vals, safe, axis=0)
    return jnp.take(x, safe, axis=0), None


def candidate_distances(
    x,
    sq_norms: jax.Array,
    q: jax.Array,
    ids: jax.Array,
    metric: str = "l2",
    precision=lax.Precision.HIGHEST,
) -> jax.Array:
    """Exact distances from each query to its candidate rows.

    ``x``: dense ``[n, D]`` or :class:`EllMatrix`; ``sq_norms``: ``[n]``
    precomputed squared norms; ``q``: dense ``[B, D]``; ``ids``:
    ``int32[B, C]`` (-1 = invalid -> +inf distance).

    Metrics (the reference's ``distf`` argument, ``RPTree.hs:168``; the
    ``Inner`` typeclass extension point, ``Internal.hs:315-341``): the
    builtins ``l2`` (Euclidean, the reference's ``metricL2``), ``sql2``,
    ``cosine`` (1 - cosine similarity), ``dot`` (negative inner product,
    for max-inner-product search) -- or any jit-compatible callable
    ``distf(rows f32[..., C, D], q f32[..., 1, D]) -> f32[..., C]``
    (smaller = closer), e.g. L1:
    ``lambda rows, q: jnp.sum(jnp.abs(rows - q), -1)``.
    """
    valid = ids >= 0
    if callable(metric):
        if isinstance(x, EllMatrix):
            raise NotImplementedError(
                "custom distance callables need dense data rows "
                "(ELL-sparse datasets support the builtin metrics only)"
            )
        rows, _ = _gather_rows(x, ids)  # [B, C, D]
        d = metric(rows, q[:, None, :])
        return jnp.where(valid, d, jnp.inf)
    if isinstance(x, EllMatrix):
        cols, vals = _gather_rows(x, ids)  # [B, C, K]
        qg = jnp.take_along_axis(
            q[:, None, :], cols.astype(jnp.int32), axis=-1
        )  # q[b, cols[b, c, k]] -> [B, C, K]
        dots = jnp.sum(vals * qg, axis=-1)
    else:
        rows, _ = _gather_rows(x, ids)  # [B, C, D]
        dots = jnp.einsum(
            "bcd,bd->bc", rows, q, preferred_element_type=jnp.float32,
            precision=precision,
        )
    sqx = jnp.take(sq_norms, jnp.clip(ids, 0, None))
    if metric in ("l2", "sql2"):
        sqq = jnp.sum(q * q, axis=-1)[:, None]
        d = jnp.maximum(sqx - 2.0 * dots + sqq, 0.0)
        if metric == "l2":
            d = jnp.sqrt(d)
    elif metric == "cosine":
        nq = jnp.sqrt(jnp.sum(q * q, axis=-1))[:, None]
        d = 1.0 - dots / jnp.maximum(jnp.sqrt(sqx) * nq, 1e-30)
    elif metric == "dot":
        d = -dots
    else:
        raise ValueError(f"unknown metric {metric!r}; one of {sorted(METRICS)}")
    return jnp.where(valid, d, jnp.inf)


METRICS = ("l2", "sql2", "cosine", "dot")


def rerank_top_k(
    x,
    sq_norms: jax.Array,
    q: jax.Array,
    ids: jax.Array,
    k: int,
    metric: str = "l2",
    dedup: bool = True,
    precision=lax.Precision.HIGHEST,
) -> Tuple[jax.Array, jax.Array]:
    """Exact-rerank the candidate union and select the k best.

    Returns ``(dists f32[B, k], point_ids int32[B, k])`` in increasing
    distance order; unfilled slots have ``inf`` distance and id ``-1``.
    """
    if dedup:
        ids = dedup_ids(ids)
    d = candidate_distances(x, sq_norms, q, ids, metric=metric,
                            precision=precision)
    k = min(k, ids.shape[-1])
    neg, idx = lax.top_k(-d, k)
    out_ids = jnp.take_along_axis(ids, idx, axis=-1)
    dists = -neg
    out_ids = jnp.where(jnp.isinf(dists), -1, out_ids)
    return dists, out_ids
