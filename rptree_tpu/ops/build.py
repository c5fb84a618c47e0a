"""Level-synchronous tree construction (the build-time hot path).

Replaces the reference's recursive ``insert``/``partitionAtMedian``
(``src/Data/RPTree/Internal.hs:257-297,484-505``), which projects and sorts
every node's points one node at a time, with an array program that handles a
*whole level across all trees* at once:

1. ONE projection GEMM for the entire tree: ``proj = X @ R.T`` -> ``[n, L]``
   (batched over the forest by ``vmap``/``shard_map`` into ``[n, T, L]``) --
   the matrix unit does all the build FLOPs in a single op;
2. a ``lax.scan`` over levels whose body is one 2-key stable ``lax.sort``
   over ``(segment_key, proj)``, carrying the point permutation -- the
   segmented median "kernel".  Per-level gather positions are padded to the
   deepest level's segment count so every iteration has identical shapes:
   one compiled sort serves all levels (an unrolled-levels version compiled
   ~L times slower through XLA with no runtime benefit);
3. static gathers of the median / margin values (positions are compile-time
   constants from :class:`~rptree_tpu.models.plan.TreePlan`).

Sort stability plus the plan's positional split reproduce the reference's
``take nh / drop nh`` partition of the stably-sorted projections
(``Internal.hs:495,508-512``) exactly, so leaf contents are bit-identical to
the reference semantics whenever the projections themselves are.

Threshold/margin layout: dense ``f32[L, S_max]`` (leading ``[T]`` for a
forest), where ``S_max`` is the deepest level's segment count; level ``l``
uses entries ``[0, n_segs_l)`` and the padded tail is never read (query
traversal clips segment indices to ``n_segs_l``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..models.plan import TreePlan
from .sparse import EllMatrix, ell_project

__all__ = ["TreeArrays", "build_tree_arrays", "build_forest_arrays", "project_dataset"]


class TreeArrays(NamedTuple):
    """Data-dependent arrays of one tree (or of a whole forest, with a
    leading ``[T]`` axis on every leaf): the device-array counterpart of the
    reference's ``RPTree`` record (``Internal.hs:172-177``)."""

    r: jax.Array     # [depth, D] projections (forest: [T, depth, D])
    thr: jax.Array   # f32[L, S_max] median thresholds per (level, segment)
    mgl: jax.Array   # f32[L, S_max] low margin (Max side)
    mgh: jax.Array   # f32[L, S_max] high margin (Min side)
    perm: jax.Array  # int32[n] point ids sorted by leaf


def project_dataset(x, r_l: jax.Array, precision=lax.Precision.HIGHEST) -> jax.Array:
    """Project points onto projection vectors: ``x [n, D] @ r_l [.., D].T``.

    Precision defaults to HIGHEST: at DEFAULT an accelerator may run f32
    matmuls in a reduced-precision mode (TF32 on a GPU, bf16 passes
    elsewhere), whose error flips the order of
    nearly-equal projections and perturbs median thresholds (recall is
    statistically robust to this, but parity with the reference semantics
    is not).  Pass ``lax.Precision.DEFAULT`` for maximum throughput.
    """
    if isinstance(x, EllMatrix):
        return ell_project(x, r_l)
    return jnp.matmul(x, r_l.T if r_l.ndim == 2 else r_l, precision=precision)


_PLAN_CONST_CACHE: dict = {}
_PLAN_CONST_CACHE_MAX = 8  # entries are O(levels * segments) numpy arrays


def _stacked_plan_constants(plan: TreePlan):
    """[L, ...] device constants with per-level gather positions padded to
    the deepest level's segment count.  Cached per plan.

    The per-position sort key (``lp.seg_key``, the region START of every
    position) is NOT materialized here: at ``[L, n]`` int32 it is ~640 MB
    for a 10M-point depth-16 plan, far too large to embed in the
    compiled program as a constant.
    Each position's key equals the largest region start at or below it,
    so the builder reconstructs it on device per level from the ``[rmax]``
    region-start list via one tiny scatter-max + ``lax.cummax`` --
    bit-identical keys (``key[start] == start`` by construction,
    ``plan.py _build``), O(n) bandwidth instead of an O(L * n) constant."""
    key = (plan.n, plan.max_depth, plan.min_leaf)
    hit = _PLAN_CONST_CACHE.get(key)
    if hit is not None:
        return hit
    smax = max(lp.n_segs for lp in plan.levels)

    def pad(name):
        return np.stack([
            np.pad(getattr(lp, name), (0, smax - lp.n_segs))
            for lp in plan.levels
        ]).astype(np.int32)

    # region-start positions per level (all regions: still-splitting
    # segments AND finalized leaves); padding with 0 is harmless -- it
    # re-scatters value 0 onto position 0, itself always a region start
    starts = [
        np.flatnonzero(np.r_[True, lp.seg_key[1:] != lp.seg_key[:-1]])
        .astype(np.int32)
        for lp in plan.levels
    ]
    rmax = max(len(s) for s in starts)
    reg_starts = np.stack([np.pad(s, (0, rmax - len(s))) for s in starts])

    # cache HOST numpy only: converting to device arrays here would leak
    # tracers when first called under a jit trace; jnp.asarray at the use
    # site turns these into compile-time constants, uploaded once per
    # executable
    out = (reg_starts, pad("thr_pos"), pad("mgl_pos"), pad("mgr_pos"))
    while len(_PLAN_CONST_CACHE) >= _PLAN_CONST_CACHE_MAX:
        _PLAN_CONST_CACHE.pop(next(iter(_PLAN_CONST_CACHE)))
    _PLAN_CONST_CACHE[key] = out
    return out


def build_tree_arrays(plan: TreePlan, x, r: jax.Array) -> TreeArrays:
    """Build one tree's arrays.  ``x``: ``f32[n, D]`` dense or
    :class:`EllMatrix`; ``r``: ``f32[depth, D]``.

    The permutation ``ids`` is initialised in dataset order so stable-sort
    tie-breaking matches the reference's stable merge sort over the same
    order.
    """
    n = plan.n
    nl = plan.n_levels
    ids0 = jnp.arange(n, dtype=jnp.int32)
    if nl == 0:  # single-leaf tree (n <= min_leaf or max_depth == 0)
        z = jnp.zeros((0, 1), dtype=jnp.float32)
        return TreeArrays(r=r, thr=z, mgl=z, mgh=z, perm=ids0)

    # profiler regions named after the reference's SCC cost centres
    # ({-# SCC insert / partitionAtMedian #-}, Internal.hs:257,484)
    with jax.named_scope("rpt_project"):
        proj = project_dataset(x, r[:nl]).astype(jnp.float32)  # [n, L]
    reg_starts, thr_pos, mgl_pos, mgr_pos = _stacked_plan_constants(plan)

    def level_step(ids, xs):
        starts_l, proj_l, tp, mp, rp = xs
        # per-position sort key = largest region start <= position,
        # rebuilt from the [rmax] start list (see _stacked_plan_constants)
        mark = jnp.zeros((n,), jnp.int32).at[starts_l].max(starts_l)
        seg_key = lax.cummax(mark)
        p = jnp.take(proj_l, ids)
        _, p_sorted, ids = lax.sort((seg_key, p, ids), num_keys=2,
                                    is_stable=True)
        return ids, (jnp.take(p_sorted, tp), jnp.take(p_sorted, mp),
                     jnp.take(p_sorted, rp))

    with jax.named_scope("rpt_partition_at_median"):
        ids, (thr, mgl, mgh) = lax.scan(
            level_step,
            ids0,
            (jnp.asarray(reg_starts), proj.T, jnp.asarray(thr_pos),
             jnp.asarray(mgl_pos), jnp.asarray(mgr_pos)),
        )
    return TreeArrays(r=r, thr=thr, mgl=mgl, mgh=mgh, perm=ids)


def build_forest_arrays(plan: TreePlan, x, r: jax.Array) -> TreeArrays:
    """Build a whole forest: ``r`` is ``[T, depth, D]``; every output leaf
    gains a leading ``[T]`` axis.  The per-tree projection GEMMs batch into
    one ``X @ R.T`` across trees (the forest axis is the natural
    "tree-parallel" dimension, SURVEY.md section 2.11)."""
    return jax.vmap(lambda rt: build_tree_arrays(plan, x, rt))(r)
