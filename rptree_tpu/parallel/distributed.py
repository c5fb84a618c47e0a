"""Sharded forest build and query over a device mesh.

The multi-device runtime the reference lacks (SURVEY.md section 2.11): tree
parallelism shards the forest axis ``[T, ...]``, query parallelism shards
the batch axis ``[B, ...]``.  All cross-device composition points are the
ones SURVEY.md identifies as "Semigroup folds become collectives":

* candidate union across trees (``src/Data/RPTree.hs:176``)  ->
  per-shard exact rerank to the local top-k, then ``lax.all_gather`` over
  the ``tree`` axis + duplicate-mask + re-top-k.  This is the standard
  distributed-top-k recipe: every device ships only ``k`` (distance, id)
  pairs over the interconnect instead of its full candidate set.
* per-tree recall mean (``RPTree.hs:265-268``)  ->  ``lax.psum`` of local
  per-tree recall sums over the ``tree`` axis.
* forest assembly (``Batch.hs:63``)  ->  nothing: the build is perfectly
  tree-parallel, each shard builds its trees locally (``shard_map`` with no
  collectives at all).

The dataset ``x`` and its squared norms are replicated across the mesh:
every tree indexes every point (completeness invariant, RPTreeSpec.hs:66-67),
so the rerank gather needs the whole dataset on-device.  Sharding the
dataset itself (with a distributed build median) is a documented follow-up,
not required at reference scale (SURVEY.md section 7 "Cross-shard median").
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ForestConfig
from ..models.forest import (
    RPForest,
    _brute_force,
    _candidate_ids,
    _knn,
    _knn_packed,
    _score_blocks,
    _b1_forest_tables,
    _select_probes,
    _traverse_forest,
)
from ..models.plan import make_plan
from ..ops.build import TreeArrays, build_forest_arrays
from ..ops.sparse import EllBlocks, EllMatrix
from ..ops.shared import SharedRows
from ..ops.rerank import gather_leaf_points, merge_top_k, rerank_top_k
from ..utils import gen as rgen
from .mesh import QUERY_AXIS, TREE_AXIS, forest_mesh

__all__ = [
    "DistributedForest",
    "distribute",
    "forest_batch_distributed",
    "merge_top_k",
]


def _arrays_pspec(n_levels: int) -> TreeArrays:
    """PartitionSpec pytree for a forest's :class:`TreeArrays`: every leaf
    is sharded along its leading ``[T]`` axis."""
    del n_levels
    t = P(TREE_AXIS)
    return TreeArrays(r=t, thr=t, mgl=t, mgh=t, perm=t)


def _pad_k(dists: jax.Array, ids: jax.Array, k: int):
    """Right-pad a (dists, ids) pair to width k with (inf, -1) so every
    shard contributes a fixed-width block to the all_gather."""
    w = ids.shape[-1]
    if w >= k:
        return dists[..., :k], ids[..., :k]
    pad = [(0, 0)] * (ids.ndim - 1) + [(0, k - w)]
    return (
        jnp.pad(dists, pad, constant_values=jnp.inf),
        jnp.pad(ids, pad, constant_values=-1),
    )


# ---------------------------------------------------------------------------
# jitted distributed pipelines (static: mesh, plan, k, budget, metric, dedup)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("mesh", "plan", "k", "budget", "probes", "metric",
                     "dedup", "variant", "precision", "min_votes", "chunk",
                     "sub"),
)
def _dist_knn(mesh, plan, arrays, x, sq_norms, q, k, budget, probes, metric,
              dedup, variant, precision="highest", packed=None,
              min_votes=1, chunk=None, block_len=None,
              block_len_global=None, block_center=None, sub=1):
    """Tree+query-sharded kNN: local rerank to k, all_gather(k per shard)
    over the tree axis, dedup-merge, re-top-k.  With ``packed`` (leaf-
    blocked ``(x_leaf, id_leaf)``, sharded over the tree axis) each shard
    runs the leaf-blocked rerank on its tree group.

    ``min_votes > 1`` (the Hyvonen et al. voting filter; same semantics
    as the single-device path, ``models/forest.py``): each shard ships
    its FULL scored candidate list without dedup -- duplicate copies of a
    candidate are its per-tree votes, and no fixed truncation width is
    safe because unfiltered closer candidates can crowd a filtered-top-k
    candidate's copies out -- and the cross-shard merge counts copies
    globally (``merge_top_k(min_votes=...)``).  The merge then sorts the
    same global union the single-device path sorts; the extra traffic
    (budget * max_leaf_len candidates/shard/query) is the price of exact
    vote parity.

    ``chunk`` (static): ``lax.map`` over per-shard query chunks inside the
    shard_map block -- one dispatch for the whole batch, per-chunk peak
    memory (the sharded ``knn_batched``).  Per-shard batch must divide it.
    """
    def bucket_keep_global(leaf_l, prio_l, tl, fw, b, bl_g=None):
        """Reference knnH's GLOBAL stop rule (RPTree.hs:208-217): every
        shard sees all shards' bucket priorities and sizes (an all_gather
        of a few floats per query), applies the same cumulative-size
        cutoff, and returns the keep-mask for its OWN buckets.  ``bl_g``
        (replicated ``int32[T * n_leaves]`` dynamic occupancy) supersedes
        the static plan sizes after :meth:`RPForest.fold`."""
        prio_all = lax.all_gather(prio_l, TREE_AXIS)  # [S, B, Tl*F]
        leaf_all = lax.all_gather(leaf_l, TREE_AXIS)
        n_sh = prio_all.shape[0]
        m = n_sh * tl * fw
        prio_g = jnp.moveaxis(prio_all, 0, 1).reshape(b, m)
        leaf_g = jnp.moveaxis(leaf_all, 0, 1).reshape(b, m)
        if bl_g is not None:
            # global tree of column j: trees shard in contiguous groups,
            # and the gathered layout is [S, Tl, F] flattened
            tree_of = (jnp.arange(m, dtype=jnp.int32) // fw)[None, :]
            gblock = tree_of * plan.n_leaves + jnp.clip(leaf_g, 0, None)
            sizes_g = jnp.where(leaf_g >= 0, jnp.take(bl_g, gblock), 0)
        else:
            sizes_g = jnp.where(
                leaf_g >= 0,
                jnp.take(jnp.asarray(plan.leaf_len),
                         jnp.clip(leaf_g, 0, None)),
                0,
            )
        order = jnp.argsort(prio_g, axis=-1)  # same result on every shard
        csum = jnp.cumsum(jnp.take_along_axis(sizes_g, order, axis=-1),
                          axis=-1)
        keep_sorted = (csum <= k) | (jnp.arange(m)[None, :] == 0)
        inv = jnp.argsort(order, axis=-1)
        keep = jnp.take_along_axis(keep_sorted, inv, axis=-1)
        my = lax.axis_index(TREE_AXIS)
        return lax.dynamic_slice_in_dim(keep, my * tl * fw, tl * fw, axis=1)

    def chunk_body(arrays_l, x_l, sq_l, q_l, packed_l, bl_l, bl_g, bc_l):
        tl = arrays_l.perm.shape[0]
        # slot width from the PACKED arrays, not the static plan: slack
        # packing / fold() grow blocks past max_leaf_len, and a truncated
        # vote copy would break exact distributed min_votes parity
        lmax = (packed_l[0].shape[-2] if packed_l is not None
                else max(plan.max_leaf_len, 1))
        if min_votes > 1:
            # full local candidate width: vote copies must not truncate
            w = (probes if packed_l is not None else tl * budget) * sub * lmax
            k_eff, dedup_eff = w, False
        else:
            k_eff, dedup_eff = k, dedup
        if variant in ("h", "h_packed"):
            leaf_ids, prio = _traverse_forest(plan, arrays_l, q_l, budget)
            tl_, b, fw = leaf_ids.shape
            leaf_l = jnp.moveaxis(leaf_ids, 0, 1).reshape(b, tl_ * fw)
            prio_l = jnp.moveaxis(prio, 0, 1).reshape(b, tl_ * fw)
            keep_mine = bucket_keep_global(leaf_l, prio_l, tl_, fw, b,
                                           bl_g=bl_g)
            leaf_kept = jnp.where(keep_mine, leaf_l, -1)
            if variant == "h":
                leaf_k3 = jnp.moveaxis(leaf_kept.reshape(b, tl_, fw), 1, 0)
                cand = jax.vmap(
                    lambda perm, l: gather_leaf_points(plan, perm, l)
                )(arrays_l.perm, leaf_k3)  # [Tl, B, F*lmax]
                union = jnp.moveaxis(cand, 0, 1).reshape(b, -1)
                from ..models.forest import _prec
                d_l, i_l = rerank_top_k(x_l, sq_l, q_l, union, k_eff,
                                        metric=metric, dedup=dedup_eff,
                                        precision=_prec(precision))
            else:
                # serve-only form: score the kept buckets on the packed
                # leaf blocks instead of gathering raw dataset rows
                x_leaf_l, sq_leaf_l, id_leaf_l, scale_l = packed_l
                tree_of = jnp.broadcast_to(
                    jnp.arange(tl_, dtype=jnp.int32)[:, None], (tl_, fw)
                ).reshape(1, tl_ * fw)
                rows = tree_of * plan.n_leaves + jnp.clip(leaf_kept, 0, None)
                rows = jnp.where(leaf_kept >= 0, rows, 0)
                lsel_s = leaf_kept
                if sub > 1:
                    from ..models.forest import _expand_sub_probes

                    rows, lsel_s = _expand_sub_probes(rows, leaf_kept, sub)
                kk = k_eff * tl_ if dedup_eff else k_eff
                d_l, i_l = _score_blocks(
                    plan, x_leaf_l, sq_leaf_l, id_leaf_l, rows, lsel_s,
                    q_l, k_eff, kk, metric, dedup_eff, precision,
                    block_scale=scale_l, block_len=bl_l,
                    block_center=bc_l,
                )
        elif packed_l is not None:
            x_leaf_l, sq_leaf_l, id_leaf_l, scale_l = packed_l
            d_l, i_l = _knn_packed(plan, arrays_l, x_leaf_l, sq_leaf_l,
                                   id_leaf_l, q_l, k_eff, budget, probes,
                                   metric, dedup_eff, precision,
                                   block_scale=scale_l, block_len=bl_l,
                                   block_center=bc_l, sub=sub)
        else:
            d_l, i_l = _knn(plan, arrays_l, x_l, sq_l, q_l, k_eff, budget,
                            metric, dedup_eff, precision)
        d_l, i_l = _pad_k(d_l, i_l, k_eff)
        # [S, B_loc, w] -> [B_loc, S*w]; traffic: 8w bytes per query
        d_all = lax.all_gather(d_l, TREE_AXIS)
        i_all = lax.all_gather(i_l, TREE_AXIS)
        s = d_all.shape[0]
        d_all = jnp.moveaxis(d_all, 0, 1).reshape(d_l.shape[0], s * k_eff)
        i_all = jnp.moveaxis(i_all, 0, 1).reshape(i_l.shape[0], s * k_eff)
        return merge_top_k(d_all, i_all, k,
                           dedup=(dedup or min_votes > 1),
                           min_votes=min_votes)

    def block(arrays_l, x_l, sq_l, q_l, packed_l, bl_l, bl_g, bc_l):
        b = q_l.shape[0]
        if chunk is None or chunk >= b:
            return chunk_body(arrays_l, x_l, sq_l, q_l, packed_l, bl_l,
                              bl_g, bc_l)
        qc = q_l.reshape(b // chunk, chunk, q_l.shape[-1])
        d, i = lax.map(
            lambda qi: chunk_body(arrays_l, x_l, sq_l, qi, packed_l, bl_l,
                                  bl_g, bc_l),
            qc,
        )
        return d.reshape(b, -1), i.reshape(b, -1)

    t_ax = P(TREE_AXIS)
    if packed is None:
        packed_spec = None
    else:
        # shared-row layout: the single row store is REPLICATED (every
        # tree indexes every point); only the slot->id / sq tables shard
        x_spec = (SharedRows(P(), t_ax)
                  if isinstance(packed[0], SharedRows) else t_ax)
        packed_spec = (x_spec, t_ax, t_ax,
                       None if packed[3] is None else t_ax)
    bl_spec = None if block_len is None else t_ax
    blg_spec = None if block_len_global is None else P()
    bc_spec = None if block_center is None else (t_ax, t_ax)
    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(_arrays_pspec(plan.n_levels), P(), P(), P(QUERY_AXIS),
                  packed_spec, bl_spec, blg_spec, bc_spec),
        out_specs=(P(QUERY_AXIS), P(QUERY_AXIS)),
        check_vma=False,
    )(arrays, x, sq_norms, q, packed, block_len, block_len_global,
      block_center)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "plan", "k", "budget", "probes",
                     "probes_per_shard", "metric", "dedup", "precision",
                     "min_votes", "bucket_stop", "axis", "chunk", "sub",
                     "grouped_cfg", "all_probes"),
)
def _dist_knn_leaf_sharded(mesh, plan, small, packed, q, k, budget, probes,
                           probes_per_shard, metric, dedup, precision,
                           min_votes=1, bucket_stop=False,
                           block_scale=None, axis=TREE_AXIS, chunk=None,
                           block_len=None, block_len_global=None,
                           block_center=None, sub=1, grouped_cfg=None,
                           all_probes=False):
    """kNN with the leaf blocks sharded round-robin across the tree axis
    (per-chip index memory = 1/S of the total).  Every shard traverses the
    whole (small, replicated) forest structure for its queries, keeps the
    probes it OWNS (block g lives on shard g % S at row g // S), scores
    only those, and the cross-shard top-k merge assembles the answer.

    ``probes_per_shard`` bounds each shard's scored buckets; with
    ``probes_per_shard == probes`` no probe can be dropped (exact); the
    default ~probes/S + slack trades a rare drop under ownership skew for
    an S-fold reduction in per-shard scoring work.

    ``chunk`` (static) runs the pipeline as a ``lax.map`` over per-shard
    query chunks INSIDE the shard_map block: one host dispatch for the
    whole batch with per-chunk peak memory (the sharded form of
    ``RPForest.knn_batched``).  The per-shard batch must divide ``chunk``.

    ``grouped_cfg = (tile_m, nt, tile_chunk[, impl[, selection]])``
    (static) scores each shard's owned probes through the query-grouped
    block-resident rerank (:mod:`rptree_tpu.ops.grouped`) instead of the
    per-pair scorer -- one fetch + one tile dot per tile of same-block
    pairs; the cross-shard merge is unchanged.  ``nt`` is the PER-SHARD
    tile capacity; a third output reports the max tiles any shard needed
    (results exact iff ``needed <= nt``; the caller retries).
    ``selection`` picks each shard's pre-merge candidate tail
    (``"kernel"`` = the fused streaming top-k of
    :mod:`rptree_tpu.ops.topk_kernel`, GPU only).

    ``all_probes=True`` is the data-parallel SHARED-ROW mode: every
    shard holds a slot table for EVERY block (its LOCAL members only,
    compacted; the row store is the point-sharded dataset itself), so
    there is no ownership filter -- each shard scores all selected
    probes against its partial blocks and the merge assembles exact
    results (every member of a probed leaf is owned by exactly one
    shard).  ``probes_per_shard`` is ignored; occupancy must arrive via
    ``block_len`` (the per-shard local member counts).
    """

    def chunk_body(r, thr, mgl, mgh, x_leaf_l, sq_leaf_l, id_leaf_l,
                   scale_l, bl_l, bl_g, bc_l, q_l, tabs=None):
        n_sh = lax.psum(1, axis)
        me = lax.axis_index(axis)
        t = r.shape[0]
        if min_votes > 1:
            # full owned-probe width: vote copies must not truncate
            # (slot width from the packed arrays -- slack/fold may have
            # grown blocks past the plan's static max_leaf_len)
            k_eff = probes_per_shard * sub * x_leaf_l.shape[-2]
            dedup_eff = False
        else:
            k_eff, dedup_eff = k, dedup
        arrays_small = TreeArrays(r=r, thr=thr, mgl=mgl, mgh=mgh,
                                  perm=jnp.zeros((t, 1), jnp.int32))
        # traversal is replicated (the structure arrays are small), so the
        # knnH bucket-stop mask is computed identically on every shard --
        # no collective needed before the ownership filter
        gsel, lsel = _select_probes(plan, arrays_small, q_l, budget, probes,
                                    k=k, bucket_stop=bucket_stop,
                                    block_len=bl_g, tabs=tabs)
        if all_probes:
            # data-parallel shared rows: every shard scores ALL selected
            # probes against its local members of each block (rows index
            # the full [G, lmax_loc] local table directly); no ownership
            # filter -- each member row is owned by exactly one shard
            rows = jnp.where(lsel >= 0, gsel, 0)
            l_s = lsel
        else:
            mine = (lsel >= 0) & (gsel % n_sh == me)
            # keep my highest-priority owned probes (probe slots arrive
            # in priority order from _select_probes), compacted to the
            # front by a small payload-carrying sort on the slot position
            rank = jnp.cumsum(mine.astype(jnp.int32), axis=-1)
            keep = mine & (rank <= probes_per_shard)
            m = gsel.shape[-1]
            key = jnp.where(keep, jnp.arange(m, dtype=jnp.int32)[None, :],
                            m)
            key_s, g_s, l_s = lax.sort((key, gsel, lsel), num_keys=1)
            pad_mask = key_s[:, :probes_per_shard] >= m
            l_s = jnp.where(pad_mask, -1, l_s[:, :probes_per_shard])
            rows = jnp.where(pad_mask, 0,
                             g_s[:, :probes_per_shard] // n_sh)
        if sub > 1:
            # ownership is at LEAF granularity (leaf g on shard g % S at
            # local leaf row g // S); its sub-blocks are the s contiguous
            # storage rows under that leaf row
            from ..models.forest import _expand_sub_probes

            rows, l_s = _expand_sub_probes(rows, l_s, sub)
        kk = k_eff * t if dedup_eff else k_eff
        needed_out = None
        if grouped_cfg is not None:
            from ..models.forest import (_grouped_use_kernel, _prec,
                                         _selection_tail)
            from ..ops.grouped import (grouped_distances,
                                       grouped_distances_kernel)

            tm_, nt_, tch_ = grouped_cfg[:3]
            impl_ = grouped_cfg[3] if len(grouped_cfg) > 3 else "auto"
            sel_ = grouped_cfg[4] if len(grouped_cfg) > 4 else "sort"
            if bl_l is not None:
                lens_rows = bl_l
            else:
                # static per-storage-row occupancy: local row rr holds
                # global block rr * S + me; pad rows past the global
                # block count are empty
                g_rows = (jnp.arange(x_leaf_l.shape[0], dtype=jnp.int32)
                          * n_sh + me)
                lens_rows = jnp.where(
                    g_rows < t * plan.n_leaves,
                    jnp.take(jnp.asarray(plan.leaf_len, jnp.int32),
                             g_rows % plan.n_leaves), 0)
            bq = rows.shape[0]
            if _grouped_use_kernel(impl_, x_leaf_l, metric, scale_l, bc_l,
                                   tm_):
                d_g, needed_l = grouped_distances_kernel(
                    x_leaf_l, sq_leaf_l, lens_rows, rows, l_s, q_l,
                    metric, _prec(precision), tm_, nt_,
                    block_scale=scale_l)
            else:
                d_g, needed_l = grouped_distances(
                    x_leaf_l, sq_leaf_l, lens_rows, rows, l_s, q_l,
                    metric, _prec(precision), tm_, nt_, tch_,
                    block_scale=scale_l, block_center=bc_l)
            d_l, i_l = _selection_tail(d_g.reshape(bq, -1), id_leaf_l,
                                       rows, k_eff, kk, dedup_eff,
                                       selection=sel_)
            needed_out = lax.pmax(needed_l, axis)
            if QUERY_AXIS in mesh.shape:
                needed_out = lax.pmax(needed_out, QUERY_AXIS)
        else:
            d_l, i_l = _score_blocks(plan, x_leaf_l, sq_leaf_l, id_leaf_l,
                                     rows, l_s, q_l, k_eff, kk, metric,
                                     dedup_eff, precision,
                                     block_scale=scale_l, block_len=bl_l,
                                     block_center=bc_l)
        d_l, i_l = _pad_k(d_l, i_l, k_eff)
        d_all = lax.all_gather(d_l, axis)
        i_all = lax.all_gather(i_l, axis)
        sh = d_all.shape[0]
        d_all = jnp.moveaxis(d_all, 0, 1).reshape(d_l.shape[0], sh * k_eff)
        i_all = jnp.moveaxis(i_all, 0, 1).reshape(i_l.shape[0], sh * k_eff)
        out = merge_top_k(d_all, i_all, k,
                          dedup=(dedup or min_votes > 1),
                          min_votes=min_votes)
        if grouped_cfg is not None:
            return out[0], out[1], needed_out
        return out

    def block(r, thr, mgl, mgh, x_leaf_l, sq_leaf_l, id_leaf_l, scale_l,
              bl_l, bl_g, bc_l, q_l):
        b = q_l.shape[0]
        if chunk is None or chunk >= b:
            return chunk_body(r, thr, mgl, mgh, x_leaf_l, sq_leaf_l,
                              id_leaf_l, scale_l, bl_l, bl_g, bc_l, q_l)
        # budget=1 superlevel traversal tables: built once per dispatch,
        # carried into the chunk loop as closure constants
        t = r.shape[0]
        arrays_small = TreeArrays(r=r, thr=thr, mgl=mgl, mgh=mgh,
                                  perm=jnp.zeros((t, 1), jnp.int32))
        tabs = _b1_forest_tables(plan, arrays_small, budget)
        qc = q_l.reshape(b // chunk, chunk, q_l.shape[-1])
        out = lax.map(
            lambda qi: chunk_body(r, thr, mgl, mgh, x_leaf_l, sq_leaf_l,
                                  id_leaf_l, scale_l, bl_l, bl_g, bc_l,
                                  qi, tabs=tabs),
            qc,
        )
        if grouped_cfg is not None:
            d, i, nd = out
            return d.reshape(b, -1), i.reshape(b, -1), jnp.max(nd)
        d, i = out
        return d.reshape(b, -1), i.reshape(b, -1)

    r, thr, mgl, mgh = small
    scale_spec = None if block_scale is None else P(axis)
    bl_spec = None if block_len is None else P(axis)
    blg_spec = None if block_len_global is None else P()
    bc_spec = None if block_center is None else (P(axis), P(axis))
    q_spec = P(QUERY_AXIS) if QUERY_AXIS in mesh.shape else P()
    out_specs = ((q_spec, q_spec) if grouped_cfg is None
                 else (q_spec, q_spec, P()))
    if isinstance(packed[0], SharedRows):
        # shared-row layouts: the slot tables shard; the row store is
        # either the point-sharded dataset (all_probes, data mesh) or a
        # replicated single copy (leaf-round-robin tables on the tree
        # mesh)
        if all_probes and block_len is None:
            raise ValueError("all_probes shared-row serving needs the "
                             "per-shard local occupancy via block_len")
        x_spec = SharedRows(P(axis) if all_probes else P(), P(axis))
    else:
        x_spec = P(axis)
    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), x_spec, P(axis),
                  P(axis), scale_spec, bl_spec, blg_spec, bc_spec,
                  q_spec),
        out_specs=out_specs,
        check_vma=False,
    )(r, thr, mgl, mgh, *packed, block_scale, block_len,
      block_len_global, block_center, q)


@functools.partial(
    jax.jit, static_argnames=("mesh", "plan", "k", "budget", "metric")
)
def _dist_recall(mesh, plan, arrays, x, sq_norms, q, k, budget, metric):
    """Mean per-tree recall@k across the sharded forest: local per-tree
    recall sums, psum over the tree axis, divide by total tree count."""

    def block(arrays_l, x_l, sq_l, q_l):
        _, exact_ids = _brute_force(x_l, sq_l, q_l, k, metric)  # [B, k]
        cand = _candidate_ids(plan, arrays_l, q_l, budget)  # [T_loc, B, C]
        hit = (exact_ids[None, :, :, None] == cand[:, :, None, :]) & (
            cand[:, :, None, :] >= 0
        )
        found = jnp.any(hit, axis=-1)  # [T_loc, B, k]
        local_sum = jnp.sum(
            jnp.sum(found, axis=-1).astype(jnp.float32) / k, axis=0
        )  # [B]
        total = lax.psum(local_sum, TREE_AXIS)
        t_total = cand.shape[0] * lax.psum(1, TREE_AXIS)
        return total / t_total

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(_arrays_pspec(plan.n_levels), P(), P(), P(QUERY_AXIS)),
        out_specs=P(QUERY_AXIS),
        check_vma=False,
    )(arrays, x, sq_norms, q)


@functools.partial(
    jax.jit, static_argnames=("mesh", "plan", "k", "budget", "n_base")
)
def _dist_recall_folded(mesh, plan, arrays, q, k, budget, exact_ids,
                        folded_leaf, n_base):
    """Folded-aware :func:`_dist_recall`: the ground truth (``exact_ids``,
    computed by the folded-aware brute force) may contain fold-appended
    rows (ids >= ``n_base``), whose per-tree candidacy is decided by leaf
    membership (``folded_leaf int32[T, M]``, sharded over the tree axis)
    exactly as in the single-device ``_recall_folded``."""

    def block(arrays_l, q_l, exact_l, fl_l):
        cand = _candidate_ids(plan, arrays_l, q_l, budget)  # [T_loc, B, C]
        hit = (exact_l[None, :, :, None] == cand[:, :, None, :]) & (
            cand[:, :, None, :] >= 0
        )
        found = jnp.any(hit, axis=-1)  # [T_loc, B, k]
        leaf_sel, _ = _traverse_forest(plan, arrays_l, q_l, budget)
        m = fl_l.shape[1]
        fidx = jnp.clip(exact_l - n_base, 0, max(m - 1, 0))  # [B, k]
        fleaf = jnp.take(fl_l, fidx, axis=1)  # [T_loc, B, k]
        found_f = jnp.any(
            leaf_sel[:, :, None, :] == fleaf[:, :, :, None], axis=-1
        )
        found = jnp.where((exact_l >= n_base)[None], found_f, found)
        local_sum = jnp.sum(
            jnp.sum(found, axis=-1).astype(jnp.float32) / k, axis=0
        )
        total = lax.psum(local_sum, TREE_AXIS)
        t_total = cand.shape[0] * lax.psum(1, TREE_AXIS)
        return total / t_total

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(_arrays_pspec(plan.n_levels), P(QUERY_AXIS),
                  P(QUERY_AXIS), P(TREE_AXIS)),
        out_specs=P(QUERY_AXIS),
        check_vma=False,
    )(arrays, q, exact_ids, folded_leaf)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "plan", "dtype_str",
                                    "centered", "sub", "sub_split"))
def _dist_pack(mesh, plan, perm, x, dtype_str, pos, in_leaf,
               centered=False, sub=1, r_sub=None, in_sub=None,
               sub_split="proj"):
    """Tree-sharded leaf-block packing: each shard packs its own trees'
    blocks from the replicated dataset, so per-device peak memory is
    T_local x dataset instead of the whole forest's blocks on one chip.
    ``centered`` packs int8 RESIDUALS around per-block f32 means (the
    centered quantization of ``RPForest.pack_leaves``).  ``sub > 1``
    splits every leaf into ``sub`` projection-ordered SUB-BLOCKS with
    per-sub quantization state (the ``sub_block`` layout; ``r_sub`` is
    the within-leaf ordering direction, ``in_sub`` the ``[nl*sub, ls]``
    validity mask).  ``pos`` / ``in_leaf`` (slot tables at the caller's
    tile-aligned lmax) arrive as ARGUMENTS: they are O(n)-sized, and
    baking them into the HLO would bloat the compiled program."""
    nl = plan.n_leaves
    lmax = pos.shape[1]

    def block(perm_l, x_l, pos, in_leaf, r_sub, in_sub):
        def per_tree(pm):
            ids = jnp.take(pm, pos)
            rows = jnp.take(x_l, ids, axis=0)
            rows = jnp.where(in_leaf[..., None], rows, 0.0)
            ids = jnp.where(in_leaf, ids, -1)
            if sub > 1:
                # within-leaf spatial order (invalid slots key +inf so
                # sub-block occupancy stays a static prefix)
                if sub_split == "kmeans":
                    from ..models.forest import _sub_order_kmeans

                    order = _sub_order_kmeans(rows, in_leaf, r_sub, sub)
                else:
                    key = jnp.where(in_leaf, rows @ r_sub, jnp.inf)
                    order = jnp.argsort(key, axis=-1)
                ids = jnp.take_along_axis(ids, order, axis=-1)
                rows = jnp.take_along_axis(rows, order[..., None], axis=-2)
                d_ = rows.shape[-1]
                rows = rows.reshape(nl * sub, lmax // sub, d_)
                ids = ids.reshape(nl * sub, lmax // sub)
                ids = jnp.where(in_sub, ids, -1)
                rows = jnp.where(in_sub[..., None], rows, 0.0)
            return rows, ids

        rows, ids = jax.vmap(per_tree)(perm_l)
        tl, d = perm_l.shape[0], x_l.shape[1]
        g_l = tl * nl * sub
        ls = lmax // sub
        valid = in_sub if sub > 1 else in_leaf
        sq = jnp.sum(rows * rows, axis=-1)
        if dtype_str == "int8" and centered:
            from ..models.forest import _center_quantize

            rows, scale, mu, mudr = _center_quantize(rows, valid)
            return (rows.reshape(g_l, ls, d),
                    sq.reshape(g_l, ls),
                    ids.reshape(g_l, ls),
                    scale.reshape(g_l),
                    mu.reshape(g_l, d),
                    mudr.reshape(g_l, ls))
        if dtype_str == "int8":
            amax = jnp.max(jnp.abs(rows), axis=(-2, -1), keepdims=True)
            scale = jnp.maximum(amax, 1e-30) / 127.0
            rows = jnp.clip(jnp.round(rows / scale), -127, 127
                            ).astype(jnp.int8)
            scale = scale.reshape(g_l)
        else:
            scale = jnp.ones(g_l, jnp.float32)
            if dtype_str == "bf16":
                rows = rows.astype(jnp.bfloat16)
        return (rows.reshape(g_l, ls, d),
                sq.reshape(g_l, ls),
                ids.reshape(g_l, ls),
                scale)

    t_ax = P(TREE_AXIS)
    n_out = 6 if (dtype_str == "int8" and centered) else 4
    rs_spec = None if r_sub is None else P()
    is_spec = None if in_sub is None else P()
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(t_ax, P(), P(), P(), rs_spec, is_spec),
        out_specs=tuple([t_ax] * n_out),
        check_vma=False,
    )(perm, x, pos, in_leaf, r_sub, in_sub)


@functools.partial(jax.jit, static_argnames=("mesh", "plan"))
def _dist_build(mesh, plan, x, r):
    """Tree-parallel forest build: each shard runs the level-synchronous
    builder on its slice of the projection stack.  Zero collectives."""
    return jax.shard_map(
        lambda x_l, r_l: build_forest_arrays(plan, x_l, r_l),
        mesh=mesh,
        in_specs=(P(), P(TREE_AXIS)),
        out_specs=_arrays_pspec(plan.n_levels),
        check_vma=False,
    )(x, r)


def _serving_lens(f):
    """(block_len_rows, block_len_global, sub) for the sharded scorers:
    sub-blocked packs read the per-sub occupancy tables (fold -- hence a
    dynamic global table -- is excluded for them); whole-leaf packs read
    the post-fold dynamic tables when present."""
    sub = getattr(f, "_sub_block", 1)
    if sub > 1:
        return f._sub_len_rows_dev, None, sub
    ll = getattr(f, "_shared_len_loc", None)
    if ll is not None:
        # data-parallel shared rows: per-shard LOCAL member counts of
        # every block (static; shared layouts never fold)
        return ll, None, 1
    return (getattr(f, "_block_len_rows_dev", None), f._block_len_dev, 1)


def _sharded_knn_grouped(f, q, k, metric, budget, dedup, precision,
                         probes, probes_per_shard, min_votes, tile_m, nt,
                         tile_chunk, chunk, axis, impl="auto", check=True,
                         selection="sort"):
    """Shared wrapper for the sharded query-grouped rerank
    (DistributedForest / DataParallelForest): leaf-sharded packed dense
    blocks only; auto-sizes the PER-SHARD tile capacity exactly like the
    single-device :meth:`RPForest.knn_grouped` (retry with headroom on
    overflow, learned capacity cached per batch shape)."""
    from ..models.forest import _as_dense_queries

    if getattr(f, "_packed_mode", None) != "leaf":
        raise ValueError("pack_leaves(shard_by='leaf') first: the sharded "
                         "knn_grouped serves the leaf-sharded blocks; "
                         "other layouts serve through knn()")
    if callable(metric):
        raise ValueError("knn_grouped supports builtin metrics only; "
                         "use knn() for distance callables")
    k = f._check_k(k)
    if selection == "kernel":
        from ..ops.topk_kernel import topk_kernel_ok

        # the per-shard fused top-k tail needs per-query extraction at
        # k <= 128 and dedup-by-id; vote counting keeps full candidate
        # lists (the merge counts copies), so it stays on the sort tail
        if min_votes > 1:
            selection = "sort"
        elif not topk_kernel_ok(2, int(k)):
            raise ValueError(
                "selection='kernel' needs a GPU backend and k <= 128; "
                "use selection='sort'")
    if axis == TREE_AXIS:
        qb, b = f._pad_queries(_as_dense_queries(q, f.dim))
    else:
        qb, b = f._q_repl(q)
    budget = f._budget(budget)
    bl_r, bl_g, sub = _serving_lens(f)
    from ..models.forest import _ell_tile_chunk_cap

    tile_chunk = _ell_tile_chunk_cap(f._packed[0], f.dim, tile_m,
                                     tile_chunk)
    if probes is None:
        probes = f.n_trees * budget
    if probes_per_shard is None or getattr(f, "_shared_all_probes", False):
        # exact by default; the all-probes shared-row mode has no
        # ownership truncation at all (every shard scores every probe)
        probes_per_shard = int(probes)
    s_q = f.mesh.shape.get(QUERY_AXIS, 1)
    b_local = -(-qb.shape[0] // s_q)
    if chunk is not None:
        chunk = max(1, min(int(chunk), b_local))
        pad = (-qb.shape[0]) % (s_q * chunk)
        if pad:
            qb = jnp.concatenate(
                [qb, jnp.zeros((pad, qb.shape[1]), qb.dtype)], axis=0)
            qb = jax.device_put(
                qb, NamedSharding(
                    f.mesh, P(QUERY_AXIS) if s_q > 1 else P()))
        b_local = chunk

    def run(cap, tc_eff):
        d, i, needed = _dist_knn_leaf_sharded(
            f.mesh, f.plan, f._small, f._packed, qb, int(k), budget,
            int(probes), int(probes_per_shard), metric, dedup, precision,
            min_votes=int(min_votes),
            block_scale=getattr(f, "_block_scale", None),
            block_len=bl_r, block_len_global=bl_g,
            block_center=getattr(f, "_block_center", None),
            sub=sub, axis=axis, chunk=chunk,
            grouped_cfg=(int(tile_m), cap, tc_eff, impl, selection),
            all_probes=getattr(f, "_shared_all_probes", False))
        return (d, i), needed

    from ..models.forest import _grouped_auto_capacity

    key = (qb.shape[0], int(probes_per_shard), int(tile_m), sub,
           chunk if chunk is not None else 0)
    d, i = _grouped_auto_capacity(
        f, key, b_local * int(probes_per_shard) * sub, tile_m,
        tile_chunk, nt, run, check=check)
    return f._apply_update_hooks(qb[:b], d[:b], i[:b], int(k), metric,
                                 precision)


# ---------------------------------------------------------------------------
# user-facing handle
# ---------------------------------------------------------------------------

class DistributedForest(RPForest):
    """An :class:`RPForest` whose arrays are sharded over a device mesh.

    Queries run tree- and query-parallel with an all-gather + re-top-k
    merge; every inherited accessor (``leaves``, ``tree_stats``,
    serialization via :mod:`rptree_tpu.utils.io`, rendering) keeps working
    because the sharded arrays are still ordinary jax arrays.
    """

    _index_axis = TREE_AXIS  # blocks shard over the tree axis

    def __init__(self, plan, arrays, x, sq_norms, config, mesh: Mesh,
                 payloads: Optional[Sequence] = None, seed=None):
        super().__init__(plan, arrays, x, sq_norms, config,
                         payloads=payloads, seed=seed)
        self.mesh = mesh
        n_shards = mesh.shape[TREE_AXIS]
        if self.n_trees % n_shards:
            raise ValueError(
                f"n_trees={self.n_trees} not divisible by tree shards "
                f"{n_shards}"
            )

    # -- sharded query paths -------------------------------------------------

    def _pad_queries(self, qb: jax.Array):
        s = self.mesh.shape[QUERY_AXIS]
        b = qb.shape[0]
        pad = (-b) % s
        if pad:
            qb = jnp.concatenate([qb, jnp.zeros((pad, qb.shape[1]),
                                                qb.dtype)], axis=0)
        return qb, b

    def pack_leaves(self, dtype=None, shard_by: Optional[str] = None,
                    slack: int = 0, centered: bool = False,
                    sub_block: int = 1,
                    sub_split: str = "kmeans",
                    store: str = "blocks") -> "DistributedForest":
        """Leaf-blocked packing, sharded over the tree axis.

        ``slack`` reserves empty per-block slots for :meth:`fold`
        (sharded online inserts).  ``shard_by="tree"``: each shard
        holds its tree group's blocks
        (per-chip memory ~ T_local x dataset).  ``shard_by="leaf"``: blocks
        are distributed round-robin by global block id (block g on shard
        g % S at row g // S) -- per-chip memory is 1/S of the TOTAL index,
        below one dataset copy, and every shard serves the probes it owns.

        ``sub_block=s > 1`` (dense blocks only, exclusive with ``slack``)
        splits every leaf into ``s`` projection-ordered sub-blocks with
        per-sub quantization state, exactly as in
        :meth:`RPForest.pack_leaves`; on the leaf-sharded layout a leaf's
        ``s`` sub-blocks stay contiguous on the leaf's owner shard.

        ``shard_by=None`` (the default) keeps the CURRENT shard mode when
        already packed (so a dtype-only repack never silently converts a
        memory-complete leaf-sharded layout into the T_local-x-dataset
        tree layout) and means ``"tree"`` on a first pack.

        ``store="shared"`` keeps ONE replicated row store (the dataset
        array) and shards only the per-block slot->id / squared-norm
        tables (by tree group or round-robin by leaf) -- the
        memory-bounded layout for datasets near HBM capacity, see
        :meth:`RPForest.pack_leaves` and :meth:`_pack_shared_sharded`.
        """
        # validate EVERYTHING before any state changes: a repack drops
        # the old layout first, so argument errors must fire while the
        # serving state is still intact
        if shard_by is None:
            if self._packed is not None:
                shard_by = getattr(self, "_packed_mode", None)
            shard_by = shard_by or "tree"
        if shard_by not in ("tree", "leaf"):
            raise ValueError("shard_by must be 'tree' or 'leaf'")
        self._validate_pack_args(dtype, slack, centered, sub_block,
                                 sub_split, store=store)
        s_blk = int(sub_block) if sub_block else 1
        from ..models.forest import _sub_split_of

        sub_split = _sub_split_of(sub_split, s_blk)
        if self._packed is not None:
            # same layout (incl. shard mode) -> idempotent no-op;
            # different -> repack (see RPForest.pack_leaves)
            if self._same_pack(dtype, slack, centered, sub_block,
                               sub_split, shard_by=shard_by, store=store):
                return self
            self._clear_pack_for_repack()
        if self._packed is None and store == "shared":
            return self._pack_shared_sharded(dtype, shard_by)
        if self._packed is None:
            if isinstance(self.x, EllMatrix):
                # sparse (EllBlocks) packing: blocks are computed once and
                # resharded by tree group (``shard_by="tree"``; cols/vals/
                # sq/ids all lead with the [T * n_leaves] axis) or
                # round-robin by global block id (``shard_by="leaf"`` --
                # per-chip memory 1/S of the sparse index, the layout
                # that matters at bag-of-words scale; reference headline
                # type SVector, Internal.hs:92-119)
                if centered:
                    raise ValueError("centered quantization applies to "
                                     "dense blocks only")
                super().pack_leaves(dtype=dtype, slack=slack)
                if self._packed is None:
                    return self
                sh = NamedSharding(self.mesh, P(TREE_AXIS))
                if shard_by == "tree":
                    self._packed = jax.tree.map(
                        lambda a: jax.device_put(a, sh), self._packed
                    )
                    self._packed_mode = "tree"
                    return self
                # leaf round-robin: block g on shard g % S at row g // S,
                # exactly the dense leaf-sharded layout (fold() keeps
                # working through the same storage-row map)
                blocks, sq, ids = self._packed
                g = blocks.cols.shape[0]
                n_sh = self.mesh.shape[TREE_AXIS]
                pad = (-g) % n_sh
                idx = np.arange(g + pad)
                rr = np.concatenate([idx[s::n_sh] for s in range(n_sh)])
                pad_row = rr >= g if pad else np.zeros_like(rr, bool)
                rr = jnp.asarray(np.clip(rr, 0, g - 1).astype(np.int32))
                cols = jax.device_put(jnp.take(blocks.cols, rr, axis=0),
                                      sh)
                vals = jax.device_put(jnp.take(blocks.vals, rr, axis=0),
                                      sh)
                sq = jax.device_put(jnp.take(sq, rr, axis=0), sh)
                ids = jnp.take(ids, rr, axis=0)
                ids = jax.device_put(
                    jnp.where(jnp.asarray(pad_row)[:, None], -1, ids), sh)
                self._packed = (EllBlocks(blocks.dim, cols, vals), sq,
                                ids)
                repl = NamedSharding(self.mesh, P())
                self._small = tuple(
                    jax.device_put(a, repl)
                    for a in (self.arrays.r, self.arrays.thr,
                              self.arrays.mgl, self.arrays.mgh)
                )
                self._packed_mode = "leaf"
                return self
            if shard_by == "tree":
                from ..models.forest import _dtype_str

                dtype_str = _dtype_str(dtype)
                if centered and dtype_str != "int8":
                    raise ValueError("centered=True applies to int8 "
                                     "blocks (pass dtype=jnp.int8)")
                from ..models.forest import _tile_align

                lmax0 = max(self.plan.max_leaf_len, 1) + int(slack)
                # slices align to 8 rows, as in the single-device packer
                ls = _tile_align(-(-lmax0 // s_blk))
                lmax = ls * s_blk if s_blk > 1 else ls
                starts = np.asarray(self.plan.leaf_start)
                lens = np.asarray(self.plan.leaf_len)
                pos = starts[:, None] + np.arange(lmax)[None, :]
                in_leaf = np.arange(lmax)[None, :] < lens[:, None]
                pos = np.where(in_leaf, pos, 0).astype(np.int32)
                repl = NamedSharding(self.mesh, P())
                r_sub = in_sub = None
                if s_blk > 1:
                    from ..models.forest import _sub_pack_tables

                    r_sub, in_sub, sub_len = _sub_pack_tables(
                        self.seed, self.dim, lens, ls, s_blk)
                    in_sub = jax.device_put(in_sub, repl)
                    self._sub_len_dev = jax.device_put(jnp.asarray(
                        np.tile(sub_len, self.n_trees)), repl)
                    # storage order == global order for the tree layout
                    self._sub_len_rows_dev = jax.device_put(
                        jnp.asarray(np.tile(sub_len, self.n_trees)),
                        NamedSharding(self.mesh, P(TREE_AXIS)))
                self._sub_block = s_blk
                out = _dist_pack(
                    self.mesh, self.plan, self.arrays.perm, self.x,
                    dtype_str,
                    jax.device_put(jnp.asarray(pos), repl),
                    jax.device_put(jnp.asarray(in_leaf), repl),
                    centered=centered, sub=s_blk, r_sub=r_sub,
                    in_sub=in_sub, sub_split=sub_split,
                )
                if centered:
                    rows, sq, ids, scale, mu, mudr = out
                    self._block_center = (mu, mudr)
                else:
                    rows, sq, ids, scale = out
                    self._block_center = None
                self._pack_slack = int(slack)
                self._packed = (rows, sq, ids)
                self._block_scale = scale if dtype_str == "int8" else None
                self._packed_mode = "tree"
                from ..models.forest import _DTYPE_OF

                self._pack_cfg = {"dtype": _DTYPE_OF[dtype_str],
                                  "centered": centered,
                                  "sub_block": s_blk,
                                  "sub_split": sub_split}
                return self
            super().pack_leaves(dtype=dtype, slack=slack, centered=centered,
                                sub_block=s_blk, sub_split=sub_split)
            if self._packed is None:
                return self
            scale = getattr(self, "_block_scale", None)
            if shard_by != "leaf":
                raise ValueError("shard_by must be 'tree' or 'leaf'")
            n_sh = self.mesh.shape[TREE_AXIS]
            x_leaf, sq_leaf, id_leaf = self._packed
            # round-robin at LEAF granularity (a leaf's sub-blocks stay
            # contiguous on its owner, matching the serving-side
            # rows = (g // S) * sub + j expansion)
            g_leaf = x_leaf.shape[0] // s_blk
            pad_l = (-g_leaf) % n_sh
            idx = np.arange(g_leaf + pad_l)
            rr_leaf = np.concatenate([idx[s::n_sh] for s in range(n_sh)])
            rr_leaf = np.clip(rr_leaf, 0, g_leaf - 1).astype(np.int32)
            pad_row_l = (rr_leaf >= g_leaf if pad_l
                         else np.zeros_like(rr_leaf, bool))
            rr = (rr_leaf[:, None] * s_blk
                  + np.arange(s_blk)[None, :]).reshape(-1).astype(np.int32)
            pad_row = np.repeat(pad_row_l, s_blk)
            g = x_leaf.shape[0]
            pad = pad_l * s_blk
            if s_blk > 1:
                # sub-block occupancies follow the round-robin reorder
                sl = np.asarray(self._sub_len_dev)[rr]
                sl[pad_row] = 0
                self._sub_len_rows_dev = jax.device_put(
                    jnp.asarray(sl),
                    NamedSharding(self.mesh, P(TREE_AXIS)))
                self._sub_len_dev = jax.device_put(
                    self._sub_len_dev, NamedSharding(self.mesh, P()))
            sh = NamedSharding(self.mesh, P(TREE_AXIS))
            x_rr = jax.device_put(jnp.take(x_leaf, jnp.asarray(rr), axis=0), sh)
            sq_rr = jax.device_put(jnp.take(sq_leaf, jnp.asarray(rr), axis=0), sh)
            il = jnp.take(id_leaf, jnp.asarray(rr), axis=0)
            il = jnp.where(jnp.asarray(pad_row)[:, None], -1, il)
            il_rr = jax.device_put(il, sh)
            if scale is not None:
                # int8 per-block scales follow the same round-robin layout
                self._block_scale = jax.device_put(
                    jnp.take(scale, jnp.asarray(rr), axis=0), sh
                )
            center = getattr(self, "_block_center", None)
            if center is not None:
                # centered means / mean.residual terms follow too
                self._block_center = tuple(
                    jax.device_put(jnp.take(a, jnp.asarray(rr), axis=0),
                                   sh)
                    for a in center
                )
            self._packed = (x_rr, sq_rr, il_rr)
            repl = NamedSharding(self.mesh, P())
            self._small = tuple(
                jax.device_put(a, repl)
                for a in (self.arrays.r, self.arrays.thr, self.arrays.mgl,
                          self.arrays.mgh)
            )
            self._packed_mode = "leaf"
        return self

    def _pack_shared_sharded(self, dtype, shard_by: str):
        """Shared-row serving layout on the tree mesh: ONE replicated row
        store (the dataset array -- every tree indexes every point, so
        the rows cannot shard by leaf) plus sharded per-block slot->id /
        squared-norm tables (``ops/shared.py`` has the memory/bandwidth
        trade).  ``shard_by="tree"`` shards the tables by tree group;
        ``shard_by="leaf"`` round-robins them by global block id so each
        shard serves only the probes it owns (per-shard table memory =
        1/S of the id tables; per-shard scoring work ~ probes/S).
        Reference analogue: one vector store per forest,
        ``src/Data/RPTree/Internal.hs:182``."""
        from ..models.forest import (_DTYPE_OF, _dtype_str,
                                     _pack_shared_tables, _tile_align)

        plan = self.plan
        dtype_str = _dtype_str(dtype)
        lmax = _tile_align(max(plan.max_leaf_len, 1))
        starts = np.asarray(plan.leaf_start)
        lens = np.asarray(plan.leaf_len)
        offs = np.arange(lmax, dtype=np.int32)
        pos = np.where(offs < lens[:, None],
                       starts[:, None] + offs, 0).astype(np.int32)
        in_leaf = offs < lens[:, None]
        repl = NamedSharding(self.mesh, P())
        ids, sq = _pack_shared_tables(self.arrays.perm, self.sq_norms,
                                      jnp.asarray(pos),
                                      jnp.asarray(in_leaf))
        g = self.n_trees * plan.n_leaves
        ids = ids.reshape(g, lmax)
        sq = sq.reshape(g, lmax)
        rows = (self.x if _DTYPE_OF[dtype_str] is None
                else self.x.astype(_DTYPE_OF[dtype_str]))
        rows = jax.device_put(rows, repl)
        sh = NamedSharding(self.mesh, P(TREE_AXIS))
        if shard_by == "tree":
            ids = jax.device_put(ids, sh)
            sq = jax.device_put(sq, sh)
            self._packed_mode = "tree"
        else:
            # round-robin at block granularity, exactly the blocked
            # leaf-sharded layout (block g on shard g % S at row g // S)
            n_sh = self.mesh.shape[TREE_AXIS]
            pad = (-g) % n_sh
            idx = np.arange(g + pad)
            rr = np.concatenate([idx[s::n_sh] for s in range(n_sh)])
            pad_row = rr >= g if pad else np.zeros_like(rr, bool)
            rr = np.clip(rr, 0, g - 1).astype(np.int32)
            ids = jnp.take(ids, jnp.asarray(rr), axis=0)
            ids = jax.device_put(
                jnp.where(jnp.asarray(pad_row)[:, None], -1, ids), sh)
            sq = jax.device_put(jnp.take(sq, jnp.asarray(rr), axis=0), sh)
            self._small = tuple(
                jax.device_put(a, repl)
                for a in (self.arrays.r, self.arrays.thr, self.arrays.mgl,
                          self.arrays.mgh)
            )
            self._packed_mode = "leaf"
        self._packed = (SharedRows(rows, ids), sq, ids)
        self._pack_slack = 0
        self._block_scale = None
        self._block_center = None
        self._sub_block = 1
        self._pack_cfg = {"dtype": _DTYPE_OF[dtype_str],
                          "store": "shared"}
        return self

    def knn(self, q, k: int, metric: str = "l2",
            budget: Optional[int] = None, dedup: bool = True,
            precision: str = "highest", probes: Optional[int] = None,
            probes_per_shard: Optional[int] = None, min_votes: int = 1):
        from ..models.forest import _as_dense_queries

        qb, b = self._pad_queries(_as_dense_queries(q, self.dim))
        budget = self._budget(budget)
        n_sh = self.mesh.shape[TREE_AXIS]
        bl_r, bl_g, sub = _serving_lens(self)
        if getattr(self, "_packed_mode", None) == "leaf":
            if probes is None:
                probes = self.n_trees * budget  # global cap here
            if probes_per_shard is None:
                # exact by default: a shard can own every probe
                probes_per_shard = int(probes)
            d, i = _dist_knn_leaf_sharded(
                self.mesh, self.plan, self._small, self._packed, qb, int(k),
                budget, int(probes), int(probes_per_shard), metric, dedup,
                precision, min_votes=int(min_votes),
                block_scale=getattr(self, "_block_scale", None),
                block_len=bl_r, block_len_global=bl_g,
                block_center=getattr(self, "_block_center", None),
                sub=sub,
            )
            return self._apply_update_hooks(qb[:b], d[:b], i[:b], int(k),
                                            metric, precision)
        if probes is None:
            # per-shard probe cap: local trees x budget = exact
            probes = (self.n_trees // n_sh) * budget
        packed4 = (None if self._packed is None
                   else self._packed + (getattr(self, "_block_scale", None),))
        x, sq = self.x, self.sq_norms
        if x is None:
            if packed4 is None:
                raise ValueError("dataset dropped; only packed-path "
                                 "queries are available")
            # placeholders: the packed block ignores the raw dataset
            x = jnp.zeros((1, 1), jnp.float32)
            sq = jnp.zeros((1,), jnp.float32)
        d, i = _dist_knn(self.mesh, self.plan, self.arrays, x,
                         sq, qb, int(k), budget, int(probes),
                         metric, dedup, "flat", precision, packed4,
                         min_votes=int(min_votes),
                         block_len=bl_r, block_len_global=bl_g,
                         block_center=getattr(self, "_block_center",
                                              None), sub=sub)
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], int(k),
                                        metric, precision)

    def knn_batched(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None,
                    probes_per_shard: Optional[int] = None,
                    min_votes: int = 1, chunk: int = 4096):
        """Sharded one-dispatch batched kNN: a ``lax.map`` over per-shard
        query chunks INSIDE the sharded pipeline, so the whole batch costs
        one host dispatch while peak rerank memory stays per-chunk (the
        multi-chip form of :meth:`RPForest.knn_batched`; results are
        identical to chunked :meth:`knn` calls).  Requires
        :meth:`pack_leaves`."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_batched runs the "
                             "leaf-blocked pipeline")
        from ..models.forest import _as_dense_queries

        k = self._check_k(k)
        qb = _as_dense_queries(q, self.dim)
        b = qb.shape[0]
        s_q = self.mesh.shape[QUERY_AXIS]
        chunk = max(1, min(int(chunk), -(-b // s_q)))
        unit = s_q * chunk
        pad = (-b) % unit
        if pad:
            qb = jnp.concatenate(
                [qb, jnp.zeros((pad, qb.shape[1]), qb.dtype)], axis=0)
        budget = self._budget(budget)
        bl_r, bl_g, sub = _serving_lens(self)
        if getattr(self, "_packed_mode", None) == "leaf":
            if probes is None:
                probes = self.n_trees * budget
            if probes_per_shard is None:
                probes_per_shard = int(probes)
            d, i = _dist_knn_leaf_sharded(
                self.mesh, self.plan, self._small, self._packed, qb, int(k),
                budget, int(probes), int(probes_per_shard), metric, dedup,
                precision, min_votes=int(min_votes),
                block_scale=getattr(self, "_block_scale", None),
                chunk=chunk, block_len=bl_r, block_len_global=bl_g,
                block_center=getattr(self, "_block_center", None),
                sub=sub,
            )
        else:
            n_sh = self.mesh.shape[TREE_AXIS]
            if probes is None:
                probes = (self.n_trees // n_sh) * budget
            packed4 = self._packed + (getattr(self, "_block_scale", None),)
            x = jnp.zeros((1, 1), jnp.float32)
            sq = jnp.zeros((1,), jnp.float32)
            d, i = _dist_knn(self.mesh, self.plan, self.arrays, x, sq, qb,
                             int(k), budget, int(probes), metric, dedup,
                             "flat", precision, packed4,
                             min_votes=int(min_votes), chunk=chunk,
                             block_len=bl_r, block_len_global=bl_g,
                             block_center=getattr(self, "_block_center",
                                                  None), sub=sub)
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], int(k),
                                        metric, precision)

    def knn_grouped(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None,
                    probes_per_shard: Optional[int] = None,
                    min_votes: int = 1, tile_m: int = 16,
                    nt: Optional[int] = None, tile_chunk: int = 2048,
                    chunk: Optional[int] = None, impl: str = "auto",
                    check: bool = True, selection: str = "sort"):
        """Query-grouped block-resident kNN on the LEAF-SHARDED packed
        layout: each shard tiles its owned (query, probe) pairs by block
        and scores one tile dot per tile (same results as :meth:`knn`);
        the cross-shard top-k merge is unchanged.  See
        :meth:`rptree_tpu.RPForest.knn_grouped` for the capacity
        semantics (``nt`` here is PER SHARD), the ``check=False``
        steady-state serving mode (skips the per-call capacity fetch),
        and ``selection="kernel"`` (fused streaming per-shard top-k
        tail, GPU only; falls back to the sort tail when
        ``min_votes > 1``)."""
        return _sharded_knn_grouped(self, q, k, metric, budget, dedup,
                                    precision, probes, probes_per_shard,
                                    min_votes, tile_m, nt, tile_chunk,
                                    chunk, TREE_AXIS, impl=impl,
                                    check=check, selection=selection)

    def knn_h(self, q, k: int, metric: str = "l2",
              budget: Optional[int] = None, dedup: bool = True,
              precision: str = "highest", probes: Optional[int] = None):
        """Margin-priority kNN, sharded, with the reference's GLOBAL
        bucket-stop rule (RPTree.hs:208-217): bucket priorities and sizes
        from every shard are all_gathered (a few floats per query), each
        shard applies the same cumulative cutoff and reranks only its own
        kept buckets, and the per-shard top-k merge as usual.

        Runs on the packed leaf blocks when available (including after
        ``drop_dataset``): tree-sharded blocks score the kept buckets
        directly; leaf-sharded blocks apply the stop rule on the
        replicated structure arrays before the ownership filter."""
        from ..models.forest import _as_dense_queries

        qb, b = self._pad_queries(_as_dense_queries(q, self.dim))
        budget = self._budget(budget)
        bl_r, bl_g, sub = _serving_lens(self)
        if getattr(self, "_packed_mode", None) == "leaf":
            if probes is None:
                probes = self.n_trees * budget
            d, i = _dist_knn_leaf_sharded(
                self.mesh, self.plan, self._small, self._packed, qb, int(k),
                budget, int(probes), int(probes), metric, dedup, precision,
                bucket_stop=True,
                block_scale=getattr(self, "_block_scale", None),
                block_len=bl_r, block_len_global=bl_g,
                block_center=getattr(self, "_block_center", None),
                sub=sub,
            )
            return self._apply_update_hooks(qb[:b], d[:b], i[:b], int(k),
                                            metric, precision)
        if self._packed is not None:
            packed4 = self._packed + (getattr(self, "_block_scale", None),)
            x = jnp.zeros((1, 1), jnp.float32)
            sq = jnp.zeros((1,), jnp.float32)
            d, i = _dist_knn(self.mesh, self.plan, self.arrays, x, sq, qb,
                             int(k), budget, 1, metric, dedup, "h_packed",
                             precision, packed4,
                             block_len=bl_r, block_len_global=bl_g,
                             block_center=getattr(self, "_block_center",
                                                  None), sub=sub)
            return self._apply_update_hooks(qb[:b], d[:b], i[:b], int(k),
                                            metric, precision)
        if self.x is None:
            raise ValueError("dataset dropped; pack_leaves() first")
        d, i = _dist_knn(self.mesh, self.plan, self.arrays, self.x,
                         self.sq_norms, qb, int(k), budget, 1, metric,
                         dedup, "h", precision, None)
        return self._apply_update_hooks(qb[:b], d[:b], i[:b], int(k),
                                        metric, precision)

    def rebuild(self) -> "DistributedForest":
        """Fold pending/folded rows and purge tombstones by re-running the
        TREE-PARALLEL build (the base rebuild would silently produce an
        unsharded forest under this class's sharded query paths)."""
        if (not getattr(self, "_pending", None) and self.n_deleted == 0
                and self.n_folded == 0):
            return self
        if self.x is None:
            raise ValueError("dataset dropped; rebuild needs the raw rows")
        x_all, new_payloads = self._rebuild_rows()
        cfg = self.config
        fresh = forest_batch_distributed(
            self.seed, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density, x_all, mesh=self.mesh,
            payloads=new_payloads,
        )
        self.plan, self.arrays = fresh.plan, fresh.arrays
        self.x, self.sq_norms = fresh.x, fresh.sq_norms
        self.payloads = fresh.payloads
        self._pending, self._pending_payloads = [], []
        self._deleted = None
        self._deleted_dev = None
        self._pending_deleted = None
        self._folded_x, self._folded_leaf = [], []
        self._folded_payloads = []
        self._folded_cat = None
        self._block_len = None
        self._block_len_dev = None
        self._block_len_rows_dev = None
        self._lens_global_dev = None
        # learned grouped tile capacities are a function of the plan's
        # block structure (stale ones silently mask pairs under
        # knn_grouped(check=False))
        self._grouped_nt = {}
        if self._packed is not None:
            mode = getattr(self, "_packed_mode", "tree")
            # replay the remembered pack configuration (dtype/centered/
            # sub_block): rebuild must not silently de-quantize the
            # serving layout
            cfg_p = dict(getattr(self, "_pack_cfg", None) or {})
            self._packed = None
            self._small = None
            self._packed_mode = None
            self._block_scale = None
            self._block_center = None
            self._sub_block = 1
            self._sub_len_dev = None
            self._sub_len_rows_dev = None
            self._shared_all_probes = False
            self._shared_len_loc = None
            self.pack_leaves(shard_by=mode or "tree",
                             slack=self._pack_slack, **cfg_p)
        return self

    def recall_with(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None):
        from ..models.forest import _as_dense_queries

        if self.x is None:
            raise ValueError("dataset dropped; recall needs the raw rows")
        qb, b = self._pad_queries(_as_dense_queries(q, self.dim))
        if self.n_folded:
            # folded-aware ground truth (inherited brute force covers the
            # fold-appended rows), then the tree-sharded candidate match
            _, exact_ids = self.brute_force_knn(qb, int(k), metric=metric)
            fl = jax.device_put(
                jnp.asarray(np.concatenate(self._folded_leaf, axis=1)),
                NamedSharding(self.mesh, P(TREE_AXIS)))
            r = _dist_recall_folded(self.mesh, self.plan, self.arrays, qb,
                                    int(k), self._budget(budget),
                                    exact_ids, fl, self.plan.n)
            return r[:b]
        r = _dist_recall(self.mesh, self.plan, self.arrays, self.x,
                         self.sq_norms, qb, int(k), self._budget(budget),
                         metric)
        return r[:b]


def distribute(forest: RPForest, mesh: Optional[Mesh] = None
               ) -> DistributedForest:
    """Shard an existing forest's arrays across a mesh (resharding an index
    built elsewhere or restored from a checkpoint)."""
    if mesh is None:
        mesh = forest_mesh()
    if (getattr(forest, "_pending", None) or getattr(forest, "n_deleted", 0)
            or getattr(forest, "n_folded", 0)):
        raise ValueError("rebuild() before distribute(): pending inserts / "
                         "tombstones are single-device state")
    spec = _arrays_pspec(forest.plan.n_levels)
    arrays = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        forest.arrays, spec,
    )
    repl = NamedSharding(mesh, P())
    x = jax.device_put(forest.x, repl)
    sq = jax.device_put(forest.sq_norms, repl)
    out = DistributedForest(forest.plan, arrays, x, sq, forest.config,
                            mesh, payloads=forest.payloads,
                            seed=forest.seed)
    saved = getattr(forest, "_grouped_nt_saved", None)
    if saved is not None:
        # checkpointed grouped capacities (utils/io.py) follow the forest
        # through resharding; they install only if the pack signature --
        # which includes the mesh shape -- matches
        out._grouped_nt_saved = saved
    return out


def forest_batch_distributed(
    seed, max_depth: int, min_leaf: int, n_trees: int, pnz: float, data,
    mesh: Optional[Mesh] = None, payloads: Optional[Sequence] = None,
    dtype=jnp.float32,
) -> DistributedForest:
    """Tree-parallel batch build (the sharded ``forestBatch``,
    ``Batch.hs:48-63``): sample the projection stack, shard it over the
    tree axis, and build every shard's trees concurrently."""
    from ..models.forest import _prepare_data

    if mesh is None:
        mesh = forest_mesh()
    x, sq_norms, dim, n = _prepare_data(data, dtype)
    plan = make_plan(n, max_depth, min_leaf)
    r = rgen.sample_projections(seed, n_trees, max_depth, dim, pnz)
    r = jax.device_put(r, NamedSharding(mesh, P(TREE_AXIS)))
    x = jax.device_put(x, NamedSharding(mesh, P()))
    sq_norms = jax.device_put(sq_norms, NamedSharding(mesh, P()))
    arrays = _dist_build(mesh, plan, x, r)
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth,
                       min_leaf=min_leaf, proj_nz_density=pnz, dim=dim)
    return DistributedForest(plan, arrays, x, sq_norms, cfg, mesh,
                             payloads=payloads, seed=seed)
