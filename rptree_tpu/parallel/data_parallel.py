"""Data-parallel forest build: dataset sharded over points, exact medians
via distributed radix selection.

SURVEY.md section 7 flags this as the crux of scaling the build beyond one
device's HBM: per (tree, level, node) the reference takes the *median* of
the node's projections with stable tie order (``partitionAtMedian``,
``Internal.hs:484-505``); a data-sharded build cannot sort globally.  The
scheme here:

1. every shard projects its own rows (the expensive GEMM is perfectly
   sharded) and locally sorts ``(node_code, projection_key)`` once per
   level;
2. the median / margin values per node come from a **distributed radix
   selection** on the 32-bit monotone integer image of the float
   projections: walk the bits MSB->LSB, counting ``keys < candidate`` per
   node with a vectorized binary search in each shard's sorted run and a
   ``lax.psum`` over the data axis -- 32 rounds, no data movement;
3. points equal to the median split by the *global stable order* (shard
   order, then local order), reproducing the reference's stable-sort tie
   behaviour: shards exchange per-node equal-counts (one small
   ``all_gather``) and take their slice of the left-side quota;
4. node codes advance level-synchronously; at the end the (tiny) per-point
   leaf codes are gathered and the standard leaf-sorted permutation is
   assembled -- yielding a bit-normal :class:`~rptree_tpu.models.forest.RPForest`.

Exactness: thresholds/margins are the exact order statistics of the global
projection multiset (not approximations), and the leaf assignment matches
the single-device builder's stable semantics whenever the projections
match.  Projection values themselves may differ from the single-device
build by GEMM reduction order (shard-local sums), the usual float caveat.
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
from ..models.forest import RPForest, _candidate_ids
from ..models.plan import TreePlan, make_plan
from ..ops.build import TreeArrays, project_dataset
from ..ops.sparse import EllBlocks, EllMatrix
from ..utils import gen as rgen
from .mesh import QUERY_AXIS

__all__ = ["DataParallelForest", "forest_batch_data_parallel",
           "brute_force_knn_sharded", "DATA_AXIS", "data_mesh"]

DATA_AXIS = "data"


def data_mesh(n_shards: Optional[int] = None, devices=None,
              n_query: int = 1) -> Mesh:
    """Mesh over the data (points) axis; ``n_query > 1`` adds a second
    ``query`` axis, so a giant batch splits across device columns instead
    of replicating ``B x D`` onto every data shard (the (data x query)
    composition).  ``n_shards * n_query`` must not exceed the device
    count."""
    if devices is None:
        devices = jax.devices()
    if n_shards is None:
        n_shards = len(devices) // max(1, n_query)
    if n_query > 1:
        grid = np.asarray(devices[: n_shards * n_query]).reshape(
            n_shards, n_query)
        return Mesh(grid, (DATA_AXIS, QUERY_AXIS))
    return Mesh(np.asarray(devices[:n_shards]), (DATA_AXIS,))


def _f32_to_key(p: jax.Array) -> jax.Array:
    """Monotone f32 -> uint32 (total order matching float comparison)."""
    u = lax.bitcast_convert_type(p, jnp.uint32)
    neg = (u >> 31) == 1
    return jnp.where(neg, ~u, u | jnp.uint32(0x80000000))


def _key_to_f32(k: jax.Array) -> jax.Array:
    neg = (k >> 31) == 0
    u = jnp.where(neg, ~k, k & jnp.uint32(0x7FFFFFFF))
    return lax.bitcast_convert_type(u, jnp.float32)


def _count_less(keys_sorted: jax.Array, lo: jax.Array, hi: jax.Array,
                cand: jax.Array, n_local: int) -> jax.Array:
    """Per-segment count of ``keys < cand`` in a flat locally sorted array.

    ``keys_sorted: uint32[n_local]`` sorted within segments ``[lo_j, hi_j)``;
    ``cand: uint32[n_segs]``.  Vectorized binary search: ~log2(n_local)
    rounds of one small gather each (n_segs indices), instead of a
    per-point scan.
    """
    steps = max(1, int(np.ceil(np.log2(max(n_local, 2)))) + 1)
    lo = lo.astype(jnp.int32)
    hi = hi.astype(jnp.int32)

    def body(_, lh):
        lo, hi = lh
        # fixed-trip-count bisection MUST freeze converged lanes: once
        # lo == hi, `mid` points at the NEXT segment's first key (the flat
        # array is sorted only within segments), and an unguarded step
        # would walk past the boundary and overcount
        active = lo < hi
        mid = (lo + hi) // 2
        v = jnp.take(keys_sorted, jnp.clip(mid, 0, n_local - 1))
        below = v < cand
        lo = jnp.where(active & below, mid + 1, lo)
        hi = jnp.where(active & ~below, mid, hi)
        return lo, hi

    lo, hi = lax.fori_loop(0, steps, body, (lo, hi))
    return lo  # == first index with key >= cand


def _select_rank(keys_sorted, seg_lo, seg_hi, ranks, n_local):
    """Distributed order statistic: value of global rank ``ranks[j]`` within
    segment ``j`` (0-indexed), via 32-round radix selection with psum'd
    counts.  Returns ``uint32[n_segs]`` keys."""

    def bit_step(i, prefix):
        bit = jnp.uint32(1) << (31 - i)
        cand = prefix | bit
        local = _count_less(keys_sorted, seg_lo, seg_hi, cand, n_local) - seg_lo
        cnt = lax.psum(local, DATA_AXIS)
        return jnp.where(cnt <= ranks, cand, prefix)

    return lax.fori_loop(0, 32, bit_step, jnp.zeros_like(ranks, jnp.uint32))


@functools.partial(jax.jit, static_argnames=("mesh", "plan"))
def _dp_build_tree(mesh, plan: TreePlan, x, r):
    """All trees' data-parallel build in ONE dispatch.  ``x: f32[N, D]``
    sharded over rows; ``r: f32[T, depth, D]`` replicated.  Returns
    (thr, mgl, mgh ``[T, L, S_max]`` replicated; leaf codes ``int32[T, N]``
    sharded over the point axis).  The per-tree body is vmapped over the
    tree axis inside the shard_map, so the radix-selection collectives
    batch across trees instead of dispatching T sequential pipelines."""
    nl = plan.n_levels
    smax = max(lp.n_segs for lp in plan.levels) if nl else 1

    # per-level static constants: global ranks of (mgl, thr, mgh) within
    # each segment, global segment start/size (for quotas), padded to smax
    seg_start = np.zeros((nl, smax), np.int32)
    seg_size = np.zeros((nl, smax), np.int32)
    ranks3 = np.zeros((nl, 3, smax), np.int32)
    for l, lp in enumerate(plan.levels):
        ns = lp.n_segs
        seg_start[l, :ns] = lp.seg_start
        seg_size[l, :ns] = lp.seg_size
        ranks3[l, 0, :ns] = lp.mgl_pos - lp.seg_start
        ranks3[l, 1, :ns] = lp.thr_pos - lp.seg_start
        ranks3[l, 2, :ns] = lp.mgr_pos - lp.seg_start
    # child encodings per level (padded): enc >= 0 split-index else leaf
    child = plan.padded_child_table()

    def one_tree(x_l, r_l):
        n_local = x_l.shape[0]
        my_shard = lax.axis_index(DATA_AXIS)
        n_shards = lax.psum(1, DATA_AXIS)
        # dense rows -> one GEMM; ELL rows -> gather+contract (both are
        # row-local, so sharded projections are bit-identical to the
        # single-device build's)
        proj = project_dataset(x_l, r_l[:nl]).astype(jnp.float32)
        # frontier code of each local point: split-seg index at level l
        code = jnp.zeros(n_local, jnp.int32)
        # final leaf id of each local point (-1 while still descending)
        leaf = jnp.full(n_local, -1, jnp.int32)
        thr_out, mgl_out, mgh_out = [], [], []
        order0 = jnp.arange(n_local, dtype=jnp.int32)

        for l in range(nl):
            ns = plan.levels[l].n_segs
            p = proj[:, l]
            key = _f32_to_key(p)
            live = leaf < 0
            # dead points park in a sentinel segment after the live ones
            code_l = jnp.where(live, code, ns)
            # local sort by (segment, key, original order)
            _, key_s, idx_s = lax.sort(
                (code_l, key, order0), num_keys=2, is_stable=True
            )
            # local segment boundaries in the sorted layout
            jj = jnp.arange(smax, dtype=jnp.int32)
            code_sorted = jnp.sort(code_l)
            lo = jnp.searchsorted(code_sorted, jj, side="left").astype(jnp.int32)
            hi = jnp.searchsorted(code_sorted, jj, side="right").astype(jnp.int32)

            vals = []
            for t3 in range(3):
                rk = jnp.asarray(ranks3[l, t3])
                sel = _select_rank(key_s, lo, hi, rk, n_local)
                vals.append(_key_to_f32(sel))
            mgl_v, thr_v, mgh_v = vals
            thr_key = _f32_to_key(thr_v)
            mgl_out.append(mgl_v)
            thr_out.append(thr_v)
            mgh_out.append(mgh_v)

            # ---- stable split: strictly-below go left; equals split by
            # global stable order up to the left quota -------------------
            nh = jnp.asarray(seg_size[l]) // 2  # left side size
            less_loc = _count_less(key_s, lo, hi, thr_key, n_local) - lo
            leq_loc = (_count_less(key_s, lo, hi, thr_key + jnp.uint32(1),
                                   n_local) - lo)
            eq_loc = leq_loc - less_loc
            less_glob = lax.psum(less_loc, DATA_AXIS)
            eq_all = lax.all_gather(eq_loc, DATA_AXIS)  # [S, smax]
            sh = lax.broadcasted_iota(jnp.int32, eq_all.shape, 0)
            eq_before = jnp.sum(
                jnp.where(sh < my_shard, eq_all, 0), axis=0
            )  # equals in earlier shards
            quota = jnp.clip(nh - less_glob, 0) - eq_before  # my left-equals

            # per-point: rank among my shard's equals (stable local order)
            pk = _f32_to_key(p)
            my_thr = jnp.take(thr_key, jnp.clip(code_l, 0, smax - 1))
            is_eq = (pk == my_thr) & live
            # local stable rank among equals of the same segment: count of
            # earlier local equals in my segment; via sorted layout:
            # position in sorted array minus (lo + less_loc)
            pos_in_sorted = jnp.zeros(n_local, jnp.int32).at[idx_s].set(
                jnp.arange(n_local, dtype=jnp.int32)
            )
            eq_rank = pos_in_sorted - jnp.take(lo + less_loc,
                                               jnp.clip(code_l, 0, smax - 1))
            go_left = (pk < my_thr) | (is_eq & (eq_rank < jnp.take(
                jnp.clip(quota, 0), jnp.clip(code_l, 0, smax - 1))))

            side = jnp.where(go_left, 0, 1)
            ch = jnp.asarray(child[l])  # [smax, 2]
            nxt = ch[jnp.clip(code_l, 0, smax - 1), side]
            code = jnp.where(live, jnp.where(nxt >= 0, nxt, 0), code)
            leaf = jnp.where(live & (nxt < 0), -(nxt + 1), leaf)

        thr = jnp.stack(thr_out) if nl else jnp.zeros((0, 1), jnp.float32)
        mgl = jnp.stack(mgl_out) if nl else jnp.zeros((0, 1), jnp.float32)
        mgh = jnp.stack(mgh_out) if nl else jnp.zeros((0, 1), jnp.float32)
        return thr, mgl, mgh, leaf

    def block(x_l, r_all):
        return jax.vmap(lambda r_l: one_tree(x_l, r_l))(r_all)

    return jax.shard_map(
        block,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P()),
        out_specs=(P(), P(), P(), P(None, DATA_AXIS)),
        check_vma=False,
    )(x, r)


@jax.jit
def _leaf_perm(leaf):
    """Stable per-tree permutation from leaf codes: ``int32[T, N]`` ->
    argsort by (leaf, original index).  The codes are tiny (4 bytes/point/
    tree); XLA gathers the sharded codes and sorts on device -- no host
    round trip, no per-tree Python loop."""
    return jnp.argsort(leaf, axis=-1, stable=True).astype(jnp.int32)


@jax.jit
def _sq_norms_sharded(x):
    if isinstance(x, EllMatrix):
        return jnp.sum(x.vals * x.vals, axis=-1)
    return jnp.sum(x * x, axis=-1)


def forest_batch_data_parallel(
    seed, max_depth: int, min_leaf: int, n_trees: int, pnz: float, data,
    mesh: Optional[Mesh] = None, payloads: Optional[Sequence] = None,
) -> "DataParallelForest":
    """Batch-build with the dataset sharded over points, end to end.

    The projections and median selection run sharded (each device touches
    only its rows, all trees in one dispatch); the permutation is a
    device-side stable sort of the per-point leaf codes; and the returned
    :class:`DataParallelForest` KEEPS the dataset sharded -- rerank, brute
    force, recall, and leaf packing all consume shard-local rows, so no
    device ever materializes the full dataset.  ``N`` must be divisible by
    the shard count.  Reference analogue: ``partitionAtMedian`` at scale
    (``Internal.hs:484-505``); the sharding itself has no reference
    counterpart (SURVEY.md section 2.11).
    """
    if mesh is None:
        mesh = data_mesh()
    n_shards = mesh.shape[DATA_AXIS]
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    if isinstance(data, EllMatrix):
        # sparse (padded-ELL) rows shard over the point axis exactly like
        # dense rows: cols/vals are both [N, K] row tables (the sharded
        # ``SVector`` dataset, Internal.hs:92-119).  Host data converts
        # ON HOST and uploads straight to the sharded layout -- a
        # jnp.asarray here would materialize the full table on one
        # device first, defeating the beyond-one-chip memory contract.
        def put(a, dtype):
            if (isinstance(a, jax.Array)
                    and a.sharding.is_equivalent_to(sharding, a.ndim)
                    and a.dtype == dtype):
                return a
            return jax.device_put(np.asarray(a, dtype=dtype), sharding)

        xs = EllMatrix(data.dim, put(data.cols, jnp.int32),
                       put(data.vals, jnp.float32))
        n, dim = xs.n, xs.dim
    else:
        if isinstance(data, jax.Array) and data.sharding.is_equivalent_to(
                sharding, data.ndim):
            xs = data  # already sharded on this mesh: zero movement
        else:
            # device_put from host shards directly; never materialize the
            # full array on one device
            xs = jax.device_put(np.asarray(data, dtype=np.float32), sharding)
        n, dim = xs.shape
    if n % n_shards:
        raise ValueError(f"N={n} not divisible by {n_shards} data shards")
    plan = make_plan(n, max_depth, min_leaf)
    r = rgen.sample_projections(seed, n_trees, max_depth, dim, pnz)
    r = jax.device_put(r, NamedSharding(mesh, P()))

    if plan.n_levels == 0:  # single-leaf trees
        arrays = TreeArrays(
            r=r,
            thr=jnp.zeros((n_trees, 0, 1), jnp.float32),
            mgl=jnp.zeros((n_trees, 0, 1), jnp.float32),
            mgh=jnp.zeros((n_trees, 0, 1), jnp.float32),
            perm=jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32),
                                  (n_trees, n)),
        )
    else:
        thr, mgl, mgh, leaf = _dp_build_tree(mesh, plan, xs, r)
        arrays = TreeArrays(r=r, thr=thr, mgl=mgl, mgh=mgh,
                            perm=_leaf_perm(leaf))
    sq = _sq_norms_sharded(xs)
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth,
                       min_leaf=min_leaf, proj_nz_density=pnz, dim=dim)
    return DataParallelForest(plan, arrays, xs, sq, cfg, mesh,
                              payloads=payloads, seed=seed)


# ---------------------------------------------------------------------------
# sharded query pipelines (dataset stays sharded over points)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("mesh", "plan", "k", "budget", "metric", "dedup",
                     "precision", "min_votes", "variant"),
)
def _dp_knn(mesh, plan, arrays, x, sq, q, k, budget, metric, dedup,
            precision, min_votes=1, variant="flat"):
    """kNN with the dataset sharded over points: the (tiny, replicated)
    structure arrays are traversed identically on every shard, each shard
    exactly reranks only the candidates whose rows it OWNS, and an
    all_gather + re-top-k merges (the reference's Semigroup fold,
    RPTree.hs:176, as a collective).  ``min_votes`` is exact: every copy
    of a candidate id lives in the replicated union, so the vote filter
    runs before the ownership mask."""
    from ..models.forest import _knn_h_ids, _prec
    from ..ops.rerank import dedup_ids, merge_top_k, rerank_top_k
    from .distributed import _pad_k

    def block(arrays_r, x_l, sq_l, q_r):
        n_l = x_l.shape[0]
        me = lax.axis_index(DATA_AXIS)
        base = me * n_l
        if variant == "h":
            union = _knn_h_ids(plan, arrays_r, q_r, k, budget)  # [B, M]
        else:
            cand = _candidate_ids(plan, arrays_r, q_r, budget)  # [T, B, C]
            t, b, c = cand.shape
            union = jnp.transpose(cand, (1, 0, 2)).reshape(b, t * c)
        if min_votes > 1:
            union = dedup_ids(union, min_votes=min_votes)
            dedup_l = False
        else:
            dedup_l = dedup
        local = union - base
        mine = (union >= 0) & (local >= 0) & (local < n_l)
        local_ids = jnp.where(mine, local, -1)
        d_l, i_l = rerank_top_k(x_l, sq_l, q_r, local_ids, k, metric=metric,
                                dedup=dedup_l, precision=_prec(precision))
        i_l = jnp.where(i_l >= 0, i_l + base, -1)
        d_l, i_l = _pad_k(d_l, i_l, k)
        d_all = lax.all_gather(d_l, DATA_AXIS)  # [S, B, k]
        i_all = lax.all_gather(i_l, DATA_AXIS)
        s = d_all.shape[0]
        d_all = jnp.moveaxis(d_all, 0, 1).reshape(d_l.shape[0], s * k)
        i_all = jnp.moveaxis(i_all, 0, 1).reshape(i_l.shape[0], s * k)
        return merge_top_k(d_all, i_all, k, dedup=dedup or min_votes > 1)

    spec = TreeArrays(r=P(), thr=P(), mgl=P(), mgh=P(), perm=P())
    q_spec = P(QUERY_AXIS) if QUERY_AXIS in mesh.shape else P()
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(spec, P(DATA_AXIS), P(DATA_AXIS), q_spec),
        out_specs=(q_spec, q_spec),
        check_vma=False,
    )(arrays, x, sq, q)


@functools.partial(
    jax.jit, static_argnames=("mesh", "plan", "k", "budget", "metric")
)
def _dp_recall(mesh, plan, arrays, x, sq, q, k, budget, metric):
    """recallWith (RPTree.hs:259-268) with the ground truth computed by
    the sharded brute-force scan: per-shard exact top-k, all_gather +
    re-top-k, then the per-tree candidate intersection on the replicated
    structure arrays."""
    from ..models.forest import _brute_force
    from ..ops.rerank import merge_top_k
    from .distributed import _pad_k

    def block(arrays_r, x_l, sq_l, q_r):
        n_l = x_l.shape[0]
        d_l, i_l = _brute_force(x_l, sq_l, q_r, k, metric)
        i_l = jnp.where(i_l >= 0, i_l + lax.axis_index(DATA_AXIS) * n_l, -1)
        d_l, i_l = _pad_k(d_l, i_l, k)
        d_all = lax.all_gather(d_l, DATA_AXIS)
        i_all = lax.all_gather(i_l, DATA_AXIS)
        s = d_all.shape[0]
        d_all = jnp.moveaxis(d_all, 0, 1).reshape(d_l.shape[0], s * k)
        i_all = jnp.moveaxis(i_all, 0, 1).reshape(i_l.shape[0], s * k)
        _, exact_ids = merge_top_k(d_all, i_all, k, dedup=False)
        cand = _candidate_ids(plan, arrays_r, q_r, budget)  # [T, B, C]
        hit = (exact_ids[None, :, :, None] == cand[:, :, None, :]) & (
            cand[:, :, None, :] >= 0
        )
        found = jnp.any(hit, axis=-1)
        return jnp.mean(jnp.sum(found, -1).astype(jnp.float32) / k, axis=0)

    spec = TreeArrays(r=P(), thr=P(), mgl=P(), mgh=P(), perm=P())
    q_spec = P(QUERY_AXIS) if QUERY_AXIS in mesh.shape else P()
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(spec, P(DATA_AXIS), P(DATA_AXIS), q_spec),
        out_specs=q_spec,
        check_vma=False,
    )(arrays, x, sq, q)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "plan", "n_trees", "dtype_str",
                                    "centered", "sub", "sub_split"))
def _dp_pack(mesh, plan, n_trees, perm, x, dtype_str, pos_arr, in_leaf_arr,
             centered=False, sub=1, r_sub=None, in_sub_arr=None,
             sub_split="proj"):
    """Leaf-blocked packing FROM the sharded dataset, INTO leaf-sharded
    blocks (block g on shard g % S at local row g // S -- the layout
    :func:`rptree_tpu.parallel.distributed._dist_knn_leaf_sharded`
    serves).  Each destination shard's blocks are assembled by one psum of
    per-source partial blocks, looped over destinations so per-device peak
    memory stays O(index / S); total interconnect traffic is one dataset
    copy.  No
    device ever holds more than its 1/S of the rows or of the blocks."""
    lmax = pos_arr.shape[1]  # may exceed max_leaf_len: slack slots
    nl = plan.n_leaves
    n_sh = mesh.shape[DATA_AXIS]
    g_total = n_trees * nl
    g_per = -(-g_total // n_sh)  # blocks per shard (last may pad)
    # pos_arr [nl, lmax] / in_leaf_arr [nl, lmax] arrive as ARGUMENTS:
    # they are O(n)-sized, and baking them into the HLO as constants
    # would bloat the compiled program (pass big arrays as jit
    # arguments, never close over them)

    def block(perm_r, x_l, pos_r, in_r, r_sub_r, in_sub_r):
        me = lax.axis_index(DATA_AXIS)
        n_l = x_l.shape[0]
        base = me * n_l
        d = x_l.shape[1]
        acc = jnp.zeros((g_per, lmax, d), jnp.float32)
        for s in range(n_sh):
            g = s + n_sh * np.arange(g_per)           # destination blocks
            g_ok = g < g_total
            g = np.minimum(g, g_total - 1)
            t_of = (g // nl).astype(np.int32)
            leaf_of = jnp.asarray((g % nl).astype(np.int32))
            pos = jnp.take(pos_r, leaf_of, axis=0)    # [g_per, lmax]
            ids = perm_r[jnp.asarray(t_of)[:, None], pos]
            valid = (jnp.take(in_r, leaf_of, axis=0)
                     & jnp.asarray(g_ok)[:, None])
            local = ids - base
            mine = valid & (local >= 0) & (local < n_l)
            rows_p = jnp.where(
                mine[..., None],
                jnp.take(x_l, jnp.clip(local, 0, n_l - 1), axis=0),
                0.0,
            )
            rows_full = lax.psum(rows_p, DATA_AXIS)
            acc = jnp.where(me == s, rows_full, acc)
        # ids / occupancy of MY OWN blocks (me is traced: gather the static
        # tables by traced block index)
        j = jnp.arange(g_per, dtype=jnp.int32)
        g_own = me + n_sh * j
        own_ok = g_own < g_total
        g_own = jnp.minimum(g_own, g_total - 1)
        t_own = g_own // nl
        leaf_own = g_own % nl
        pos_own = jnp.take(pos_r, leaf_own, axis=0)
        in_own = jnp.take(in_r, leaf_own, axis=0)
        in_own = in_own & own_ok[:, None]
        ids_own = perm_r[t_own[:, None], pos_own]
        ids_own = jnp.where(in_own, ids_own, -1)
        rows = jnp.where(in_own[..., None], acc, 0.0)
        if sub > 1:
            # a leaf's sub-blocks are formed LOCALLY on its owner (the
            # whole leaf was just assembled here): order the rows and
            # slice -- the leaf's `sub` sub-blocks stay the contiguous
            # storage rows under its leaf row
            if sub_split == "kmeans":
                from ..models.forest import _sub_order_kmeans

                order = _sub_order_kmeans(rows, in_own, r_sub_r, sub)
            else:
                key = jnp.where(in_own, rows @ r_sub_r, jnp.inf)
                order = jnp.argsort(key, axis=-1)
            ids_own = jnp.take_along_axis(ids_own, order, axis=-1)
            rows = jnp.take_along_axis(rows, order[..., None], axis=-2)
            ls = lmax // sub
            rows = rows.reshape(g_per * sub, ls, d)
            ids_own = ids_own.reshape(g_per * sub, ls)
            sub_idx = (leaf_own[:, None] * sub
                       + jnp.arange(sub, dtype=jnp.int32)[None, :]
                       ).reshape(-1)
            in_own = (jnp.take(in_sub_r, sub_idx, axis=0)
                      & jnp.repeat(own_ok, sub)[:, None])
            ids_own = jnp.where(in_own, ids_own, -1)
            rows = jnp.where(in_own[..., None], rows, 0.0)
        g_out = g_per * sub
        sq = jnp.sum(rows * rows, axis=-1)
        if dtype_str == "int8" and centered:
            from ..models.forest import _center_quantize

            rows, scale, mu, mudr = _center_quantize(rows, in_own)
            return rows, sq, ids_own, scale.reshape(g_out), mu, mudr
        if dtype_str == "int8":
            amax = jnp.max(jnp.abs(rows), axis=(-2, -1), keepdims=True)
            scale = jnp.maximum(amax, 1e-30) / 127.0
            rows = jnp.clip(jnp.round(rows / scale), -127, 127
                            ).astype(jnp.int8)
            scale = scale.reshape(g_out)
        else:
            scale = jnp.ones(g_out, jnp.float32)
            if dtype_str == "bf16":
                rows = rows.astype(jnp.bfloat16)
        return rows, sq, ids_own, scale

    d_ax = P(DATA_AXIS)
    n_out = 6 if (dtype_str == "int8" and centered) else 4
    rs_spec = None if r_sub is None else P()
    is_spec = None if in_sub_arr is None else P()
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(P(), d_ax, P(), P(), rs_spec, is_spec),
        out_specs=tuple([d_ax] * n_out),
        check_vma=False,
    )(perm, x, pos_arr, in_leaf_arr, r_sub, in_sub_arr)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "plan", "n_trees", "dtype_str"))
def _dp_pack_ell(mesh, plan, n_trees, perm, cols, vals, dtype_str,
                 pos_arr, in_leaf_arr):
    """ELL (sparse) counterpart of :func:`_dp_pack`: assemble leaf-sharded
    :class:`EllBlocks` (cols/vals blocks) from the row-sharded ELL tables
    by the same per-destination psum loop.  Padding slots stay col=0/val=0
    so they contribute nothing at score time; per-device peak memory is
    O(index / S)."""
    lmax = pos_arr.shape[1]  # may exceed max_leaf_len: slack slots
    nl = plan.n_leaves
    n_sh = mesh.shape[DATA_AXIS]
    g_total = n_trees * nl
    g_per = -(-g_total // n_sh)

    def block(perm_r, cols_l, vals_l, pos_r, in_r):
        me = lax.axis_index(DATA_AXIS)
        n_l = cols_l.shape[0]
        base = me * n_l
        kz = cols_l.shape[1]
        acc_c = jnp.zeros((g_per, lmax, kz), jnp.int32)
        acc_v = jnp.zeros((g_per, lmax, kz), jnp.float32)
        for s in range(n_sh):
            g = s + n_sh * np.arange(g_per)
            g_ok = g < g_total
            g = np.minimum(g, g_total - 1)
            t_of = (g // nl).astype(np.int32)
            leaf_of = jnp.asarray((g % nl).astype(np.int32))
            pos = jnp.take(pos_r, leaf_of, axis=0)
            ids = perm_r[jnp.asarray(t_of)[:, None], pos]
            valid = (jnp.take(in_r, leaf_of, axis=0)
                     & jnp.asarray(g_ok)[:, None])
            local = ids - base
            mine = valid & (local >= 0) & (local < n_l)
            safe = jnp.clip(local, 0, n_l - 1)
            c_p = jnp.where(mine[..., None],
                            jnp.take(cols_l, safe, axis=0), 0)
            v_p = jnp.where(mine[..., None],
                            jnp.take(vals_l, safe, axis=0), 0.0)
            c_full = lax.psum(c_p, DATA_AXIS)
            v_full = lax.psum(v_p, DATA_AXIS)
            acc_c = jnp.where(me == s, c_full, acc_c)
            acc_v = jnp.where(me == s, v_full, acc_v)
        j = jnp.arange(g_per, dtype=jnp.int32)
        g_own = me + n_sh * j
        own_ok = g_own < g_total
        g_own = jnp.minimum(g_own, g_total - 1)
        t_own = g_own // nl
        leaf_own = g_own % nl
        pos_own = jnp.take(pos_r, leaf_own, axis=0)
        in_own = jnp.take(in_r, leaf_own, axis=0) & own_ok[:, None]
        ids_own = perm_r[t_own[:, None], pos_own]
        ids_own = jnp.where(in_own, ids_own, -1)
        cols_b = jnp.where(in_own[..., None], acc_c, 0)
        vals_b = jnp.where(in_own[..., None], acc_v, 0.0)
        sq = jnp.sum(vals_b * vals_b, axis=-1)
        if dtype_str == "bf16":
            vals_b = vals_b.astype(jnp.bfloat16)
        return cols_b, vals_b, sq, ids_own

    d_ax = P(DATA_AXIS)
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(P(), d_ax, d_ax, P(), P()),
        out_specs=(d_ax, d_ax, d_ax, d_ax),
        check_vma=False,
    )(perm, cols, vals, pos_arr, in_leaf_arr)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _dp_shared_counts(mesh, perm, x, pos_arr, in_leaf_arr):
    """Per-shard LOCAL member counts of every (tree, leaf) block for the
    data-parallel shared-row layout (shard s owns rows
    ``[s*n_l, (s+1)*n_l)``).  The host max of the output fixes the static
    local slot width before :func:`_dp_shared_tables` compacts.  Returns
    ``int32[S * T * n_leaves]`` sharded over the data axis -- ALSO the
    serving-side occupancy (``block_len``) of the local tables."""

    def block(perm_r, x_l, pos_r, in_r):
        me = lax.axis_index(DATA_AXIS)
        n_l = x_l.shape[0]
        base = me * n_l

        def per_tree(perm_t):
            ids = jnp.take(perm_t, pos_r)        # [nl, lmax]
            local = ids - base
            mine = in_r & (local >= 0) & (local < n_l)
            return jnp.sum(mine, axis=-1).astype(jnp.int32)

        return lax.map(per_tree, perm_r).reshape(-1)

    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(P(), P(DATA_AXIS), P(), P()),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )(perm, x, pos_arr, in_leaf_arr)


@functools.partial(jax.jit, static_argnames=("mesh", "lmax_loc"))
def _dp_shared_tables(mesh, perm, x, sq, pos_arr, in_leaf_arr, lmax_loc):
    """Per-shard slot tables for the data-parallel shared-row layout:
    each block's LOCAL members compacted (stable) to the front of a
    static ``lmax_loc``-slot row -- local row indices for the fetch
    (:class:`~rptree_tpu.ops.shared.SharedRows` ``ids``), global point
    ids for the output, per-slot squared norms.  Entirely shard-local
    (no collectives, no row movement; the rows never leave their owner).
    ``lax.map`` over trees keeps peak memory at one tree's id table."""

    def block(perm_r, x_l, sq_l, pos_r, in_r):
        me = lax.axis_index(DATA_AXIS)
        n_l = x_l.shape[0]
        base = me * n_l
        lmax = pos_r.shape[1]

        def per_tree(perm_t):
            ids = jnp.take(perm_t, pos_r)        # [nl, lmax]
            local = ids - base
            mine = in_r & (local >= 0) & (local < n_l)
            # stable compaction of owned slots to the front (slot order
            # within a leaf is preserved -- determinism for tests)
            key = jnp.where(
                mine, jnp.arange(lmax, dtype=jnp.int32)[None, :], lmax)
            key_s, loc_s = lax.sort(
                (key, jnp.where(mine, local, 0)), num_keys=1)
            ok = key_s[:, :lmax_loc] < lmax
            loc_c = jnp.where(ok, loc_s[:, :lmax_loc], -1)
            sq_t = jnp.where(
                ok, jnp.take(sq_l, jnp.clip(loc_c, 0, None)), 0.0)
            gid = jnp.where(ok, loc_c + base, -1)
            return loc_c, gid, sq_t

        loc, gid, sq_t = lax.map(per_tree, perm_r)
        t, nl = perm_r.shape[0], pos_r.shape[0]
        return (loc.reshape(t * nl, lmax_loc),
                gid.reshape(t * nl, lmax_loc),
                sq_t.reshape(t * nl, lmax_loc))

    d_ax = P(DATA_AXIS)
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(P(), d_ax, d_ax, P(), P()),
        out_specs=(d_ax, d_ax, d_ax),
        check_vma=False,
    )(perm, x, sq, pos_arr, in_leaf_arr)


class DataParallelForest(RPForest):
    """An :class:`RPForest` whose DATASET is sharded over points on a
    1-D device mesh -- for datasets beyond one chip's HBM.

    Build, rerank, brute force, recall, and leaf packing all consume
    shard-local rows; serving uses leaf-sharded packed blocks (1/S of the
    index per chip).  The small structure arrays (projections, thresholds,
    margins, permutation) are replicated: traversal is cheap and data
    movement is what kills.
    """

    _index_axis = DATA_AXIS  # blocks shard over the data axis

    def __init__(self, plan, arrays, x, sq_norms, config, mesh: Mesh,
                 payloads: Optional[Sequence] = None, seed=None):
        super().__init__(plan, arrays, x, sq_norms, config,
                         payloads=payloads, seed=seed)
        self.mesh = mesh

    def _q_repl(self, q):
        """Place a query batch on the mesh: replicated on a 1-D data
        mesh; SHARDED over the query axis on a (data x query) mesh, so a
        giant batch costs B/S_q rows per device instead of a full copy on
        every data shard.  Returns ``(padded batch, original B)``."""
        from ..models.forest import _as_dense_queries

        qb = _as_dense_queries(q, self.dim)
        b = qb.shape[0]
        if QUERY_AXIS in self.mesh.shape:
            s_q = self.mesh.shape[QUERY_AXIS]
            pad = (-b) % s_q
            if pad:
                qb = jnp.concatenate(
                    [qb, jnp.zeros((pad, qb.shape[1]), qb.dtype)], axis=0)
            return jax.device_put(
                qb, NamedSharding(self.mesh, P(QUERY_AXIS))), b
        return jax.device_put(qb, NamedSharding(self.mesh, P())), b

    def knn(self, q, k: int, metric: str = "l2",
            budget: Optional[int] = None, dedup: bool = True,
            precision: str = "highest", probes: Optional[int] = None,
            min_votes: int = 1):
        qb, b = self._q_repl(q)
        budget = self._budget(budget)
        if getattr(self, "_packed_mode", None) == "leaf":
            from .distributed import _dist_knn_leaf_sharded, _serving_lens

            bl_r, bl_g, sub = _serving_lens(self)
            if probes is None:
                probes = self.n_trees * budget
            out = _dist_knn_leaf_sharded(
                self.mesh, self.plan, self._small, self._packed, qb, int(k),
                budget, int(probes), int(probes), metric, dedup, precision,
                min_votes=int(min_votes),
                block_scale=getattr(self, "_block_scale", None),
                axis=DATA_AXIS,
                block_len=bl_r, block_len_global=bl_g,
                block_center=getattr(self, "_block_center", None),
                sub=sub,
                all_probes=getattr(self, "_shared_all_probes", False),
            )
        else:
            if self.x is None:
                raise ValueError("dataset dropped; only packed-path "
                                 "queries are available")
            out = _dp_knn(self.mesh, self.plan, self.arrays, self.x,
                          self.sq_norms, qb, int(k), budget, metric, dedup,
                          precision, min_votes=int(min_votes))
        return self._apply_update_hooks(qb[:b], out[0][:b], out[1][:b],
                                        int(k), metric, precision)

    def knn_batched(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, min_votes: int = 1,
                    chunk: int = 4096):
        """One-dispatch batched kNN over the leaf-sharded packed blocks: a
        ``lax.map`` over query chunks inside the sharded pipeline (the
        data-parallel form of :meth:`RPForest.knn_batched`).  Requires
        :meth:`pack_leaves`; results are identical to chunked
        :meth:`knn` calls."""
        if getattr(self, "_packed_mode", None) != "leaf":
            raise ValueError("pack_leaves() first: knn_batched serves the "
                             "leaf-sharded packed blocks")
        from .distributed import _dist_knn_leaf_sharded, _serving_lens

        bl_r, bl_g, sub = _serving_lens(self)
        k = self._check_k(k)
        qb, b = self._q_repl(q)
        s_q = self.mesh.shape.get(QUERY_AXIS, 1)
        chunk = max(1, min(int(chunk), -(-qb.shape[0] // s_q)))
        unit = s_q * chunk
        pad = (-b) % unit
        if pad:
            from ..models.forest import _as_dense_queries
            qb = jnp.concatenate(
                [_as_dense_queries(q, self.dim),
                 jnp.zeros((pad, qb.shape[1]), qb.dtype)], axis=0)
            qb = jax.device_put(
                qb, NamedSharding(
                    self.mesh,
                    P(QUERY_AXIS) if s_q > 1 else P()))
        budget = self._budget(budget)
        if probes is None:
            probes = self.n_trees * budget
        d, i = _dist_knn_leaf_sharded(
            self.mesh, self.plan, self._small, self._packed, qb, int(k),
            budget, int(probes), int(probes), metric, dedup, precision,
            min_votes=int(min_votes),
            block_scale=getattr(self, "_block_scale", None),
            axis=DATA_AXIS, chunk=chunk,
            block_len=bl_r, block_len_global=bl_g,
            block_center=getattr(self, "_block_center", None),
            sub=sub,
            all_probes=getattr(self, "_shared_all_probes", False),
        )
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
        """Query-grouped block-resident kNN on the leaf-sharded packed
        blocks of the data mesh (see
        :meth:`rptree_tpu.parallel.DistributedForest.knn_grouped`)."""
        from .distributed import _sharded_knn_grouped

        return _sharded_knn_grouped(self, q, k, metric, budget, dedup,
                                    precision, probes, probes_per_shard,
                                    min_votes, tile_m, nt, tile_chunk,
                                    chunk, DATA_AXIS, impl=impl,
                                    check=check, selection=selection)

    def knn_h(self, q, k: int, metric: str = "l2",
              budget: Optional[int] = None, dedup: bool = True,
              precision: str = "highest", probes: Optional[int] = None):
        qb, b = self._q_repl(q)
        budget = self._budget(budget)
        if getattr(self, "_packed_mode", None) == "leaf":
            from .distributed import _dist_knn_leaf_sharded, _serving_lens

            bl_r, bl_g, sub = _serving_lens(self)
            if probes is None:
                probes = self.n_trees * budget
            out = _dist_knn_leaf_sharded(
                self.mesh, self.plan, self._small, self._packed, qb, int(k),
                budget, int(probes), int(probes), metric, dedup, precision,
                bucket_stop=True,
                block_scale=getattr(self, "_block_scale", None),
                axis=DATA_AXIS,
                block_len=bl_r, block_len_global=bl_g,
                block_center=getattr(self, "_block_center", None),
                sub=sub,
                all_probes=getattr(self, "_shared_all_probes", False),
            )
            return self._apply_update_hooks(qb[:b], out[0][:b], out[1][:b],
                                            int(k), metric, precision)
        if self.x is None:
            raise ValueError("dataset dropped; pack_leaves() first")
        out = _dp_knn(self.mesh, self.plan, self.arrays, self.x,
                      self.sq_norms, qb, int(k), budget, metric, dedup,
                      precision, variant="h")
        return self._apply_update_hooks(qb[:b], out[0][:b], out[1][:b],
                                        int(k), metric, precision)

    def brute_force_knn(self, q, k: int, metric: str = "l2",
                        precision: str = "highest"):
        if self.x is None:
            raise ValueError("dataset dropped; brute force needs raw rows")
        qb, b = self._q_repl(q)
        d, i = _bf_sharded(self.mesh, self.x, self.sq_norms, qb, int(k),
                           metric)
        qb, d, i = qb[:b], d[:b], i[:b]
        if self.n_folded:
            # fold-appended rows live only in the packed blocks (small
            # dense host copies): scan them separately and merge so the
            # ground truth agrees with the index contents
            d, i = self._merge_folded(qb, d, i, int(k), metric, precision)
        return d, i

    def recall_with(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None):
        if self.x is None:
            raise ValueError("dataset dropped; recall needs raw rows")
        qb, b = self._q_repl(q)
        if self.n_folded:
            # folded-aware ground truth from the sharded brute force (it
            # merges the fold-appended rows), then the candidate match on
            # the REPLICATED structure arrays -- no collective needed
            from ..models.forest import _recall_folded
            _, exact_ids = self.brute_force_knn(qb, int(k), metric=metric)
            fl = jnp.asarray(np.concatenate(self._folded_leaf, axis=1))
            return _recall_folded(self.plan, self.arrays, qb, int(k),
                                  self._budget(budget), exact_ids, fl,
                                  self.plan.n)[:b]
        return _dp_recall(self.mesh, self.plan, self.arrays, self.x,
                          self.sq_norms, qb, int(k), self._budget(budget),
                          metric)[:b]

    def rebuild(self) -> "DataParallelForest":
        """Fold pending inserts / purge tombstones by re-running the
        DATA-PARALLEL build (the base rebuild would produce a
        single-device forest under this class's sharded query paths).
        Rebuild is a heavyweight op: rows are staged through the host.
        The new size must still divide the shard count."""
        if (not getattr(self, "_pending", None) and self.n_deleted == 0
                and self.n_folded == 0):
            return self
        n_sh = self.mesh.shape[DATA_AXIS]
        if isinstance(self.x, EllMatrix):
            # sparse rebuild stays sparse end to end: stage the row-sharded
            # ELL tables through the host (never densified -- a
            # bag-of-words dim would not fit anywhere dense), append the
            # folded/pending dense rows as padded slot lists, purge
            # tombstones, and re-run the data-parallel build
            x_all, new_payloads = self._rebuild_rows_ell()
        else:
            x_all, new_payloads = self._rebuild_rows()
        if x_all.shape[0] % n_sh:
            raise ValueError(
                f"rebuilt size {x_all.shape[0]} does not divide the "
                f"{n_sh} data shards; add/remove to a divisible size"
            )
        cfg = self.config
        fresh = forest_batch_data_parallel(
            self.seed, cfg.max_depth, cfg.min_leaf, cfg.n_trees,
            cfg.proj_nz_density,
            x_all if isinstance(x_all, EllMatrix) else np.asarray(x_all),
            mesh=self.mesh, payloads=new_payloads,
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
            # replay the remembered pack configuration
            # (dtype/centered/sub_block)
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
            self.pack_leaves(slack=self._pack_slack, **cfg_p)
        return self

    def _pack_shared_dp(self, dtype) -> "DataParallelForest":
        """Shared-row serving from the POINT-SHARDED dataset: the row
        store is each shard's own dataset slice (no row copies anywhere)
        plus per-shard compacted slot tables of the LOCAL members of
        every (tree, leaf) block.  Serving runs the ``all_probes`` mode
        of :func:`~rptree_tpu.parallel.distributed._dist_knn_leaf_sharded`:
        every shard scores every selected probe against its partial
        blocks (exact -- each member row is owned by exactly one shard;
        per-shard fetch/score work ~ 1/S plus ownership-skew padding).
        Per-chip memory: the N*D/S dataset slice + ~T*N/S id-table
        entries -- T x below the blocked leaf-sharded layout, the true
        >HBM regime.  Reference analogue: one vector store per forest,
        ``src/Data/RPTree/Internal.hs:182``."""
        from ..models.forest import _DTYPE_OF, _dtype_str, _tile_align
        from ..ops.shared import SharedRows

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
        pos_d = jax.device_put(jnp.asarray(pos), repl)
        in_d = jax.device_put(jnp.asarray(in_leaf), repl)
        len_loc = _dp_shared_counts(self.mesh, self.arrays.perm, self.x,
                                    pos_d, in_d)
        # static local slot width: the max local member count over every
        # (block, shard), 8-row aligned (gather tiling), never past lmax
        lmax_loc = int(jnp.max(len_loc))
        lmax_loc = min(max(-(-max(lmax_loc, 1) // 8) * 8, 8), lmax)
        loc, gid, sq_t = _dp_shared_tables(self.mesh, self.arrays.perm,
                                           self.x, self.sq_norms, pos_d,
                                           in_d, lmax_loc)
        rows = (self.x if _DTYPE_OF[dtype_str] is None
                else self.x.astype(_DTYPE_OF[dtype_str]))
        self._packed = (SharedRows(rows, loc), sq_t, gid)
        self._packed_mode = "leaf"
        self._shared_all_probes = True
        self._shared_len_loc = len_loc
        self._pack_slack = 0
        self._block_scale = None
        self._block_center = None
        self._sub_block = 1
        self._pack_cfg = {"dtype": _DTYPE_OF[dtype_str],
                          "store": "shared"}
        self._small = tuple(
            jax.device_put(a, repl)
            for a in (self.arrays.r, self.arrays.thr, self.arrays.mgl,
                      self.arrays.mgh)
        )
        return self

    def _rebuild_rows_ell(self):
        """ELL counterpart of ``_rebuild_rows``: original sharded rows +
        fold-appended + pending rows as padded (cols, vals) tables, with
        tombstoned entries purged -- never densified.  Dense update rows
        with more nonzeros than the table's K slots cannot be stored
        losslessly and raise."""
        cols = np.asarray(self.x.cols)
        vals = np.asarray(self.x.vals)
        kz = cols.shape[1]
        n0 = cols.shape[0]
        pays = (list(self.payloads) if self.payloads is not None
                else [None] * n0)

        def to_ell(chunk):
            c = np.asarray(chunk)
            rc = np.zeros((c.shape[0], kz), np.int32)
            rv = np.zeros((c.shape[0], kz), np.float32)
            for j in range(c.shape[0]):
                nz = np.flatnonzero(c[j])
                if nz.size > kz:
                    raise ValueError(
                        f"update row has {nz.size} nonzeros > the ELL "
                        f"table's {kz} slots; rebuild from source rows "
                        "with forest_batch_data_parallel")
                rc[j, :nz.size] = nz
                rv[j, :nz.size] = c[j][nz]
            return rc, rv

        cs, vs = [cols], [vals]
        for chunk in self._folded_x:
            rc, rv = to_ell(chunk)
            cs.append(rc)
            vs.append(rv)
        pays = pays + list(self._folded_payloads)
        cols_all = np.concatenate(cs, axis=0)
        vals_all = np.concatenate(vs, axis=0)
        if self._deleted is not None and self._deleted.any():
            keep = ~self._deleted
            cols_all = cols_all[keep]
            vals_all = vals_all[keep]
            pays = [p for p, kp in zip(pays, keep) if kp]
        pend = list(self._pending)
        pend_pays = sum(self._pending_payloads, [])
        dead_p = getattr(self, "_pending_deleted", None)
        if dead_p and pend:
            xp = np.concatenate([np.asarray(c) for c in pend], axis=0)
            keep_p = np.ones(xp.shape[0], bool)
            keep_p[list(dead_p)] = False
            pend = [xp[keep_p]]
            pend_pays = [p for p, kp in zip(pend_pays, keep_p) if kp]
        for chunk in pend:
            rc, rv = to_ell(chunk)
            cols_all = np.concatenate([cols_all, rc], axis=0)
            vals_all = np.concatenate([vals_all, rv], axis=0)
        pays = pays + pend_pays
        x_ell = EllMatrix(self.dim, cols_all, vals_all)
        return x_ell, (None if all(p is None for p in pays) else pays)

    def pack_leaves(self, dtype=None, shard_by: str = "leaf",
                    slack: int = 0, centered: bool = False,
                    sub_block: int = 1,
                    sub_split: str = "kmeans",
                    store: str = "blocks") -> "DataParallelForest":
        """Pack leaf blocks directly from the SHARDED dataset into
        leaf-sharded blocks (1/S of the index per chip).  Only
        ``shard_by="leaf"`` exists here: any other layout would
        materialize more than 1/S of the data somewhere.
        ``sub_block=s > 1`` (dense only, exclusive with ``slack``) forms
        each leaf's projection-ordered sub-blocks locally on the leaf's
        owner shard after assembly."""
        if shard_by not in (None, "leaf"):
            raise ValueError("DataParallelForest packs shard_by='leaf' "
                             "only (the memory-complete layout)")
        shard_by = "leaf"
        # validate BEFORE any state changes (see RPForest.pack_leaves):
        # an invalid call must never destroy the serving layout
        self._validate_pack_args(dtype, slack, centered, sub_block,
                                 sub_split, store=store)
        if self._packed is not None:
            # same layout -> idempotent no-op; different -> repack (see
            # RPForest.pack_leaves)
            if self._same_pack(dtype, slack, centered, sub_block,
                               sub_split, shard_by=shard_by, store=store):
                return self
            self._clear_pack_for_repack()
        if store == "shared":
            return self._pack_shared_dp(dtype)
        from ..models.forest import _dtype_str

        s_blk = int(sub_block) if sub_block else 1
        from ..models.forest import _sub_split_of

        sub_split = _sub_split_of(sub_split, s_blk)
        self._pack_slack = int(slack)
        lmax_ = max(self.plan.max_leaf_len, 1) + int(slack)
        if not isinstance(self.x, EllMatrix):
            # align the slot axis as the single-device pack does
            # (_tile_align)
            from ..models.forest import _tile_align

            dtype_str = _dtype_str(dtype)
            if centered and dtype_str != "int8":
                raise ValueError("centered=True applies to int8 blocks "
                                 "(pass dtype=jnp.int8)")
            if s_blk > 1:
                ls_ = -(-lmax_ // s_blk)
                ls_ = -(-ls_ // 8) * 8
                lmax_ = ls_ * s_blk
            else:
                lmax_ = _tile_align(lmax_)
        starts_ = np.asarray(self.plan.leaf_start)
        lens_ = np.asarray(self.plan.leaf_len)
        pos_a = starts_[:, None] + np.arange(lmax_)[None, :]
        in_leaf_a = np.arange(lmax_)[None, :] < lens_[:, None]
        pos_a = np.where(in_leaf_a, pos_a, 0).astype(np.int32)
        repl0 = NamedSharding(self.mesh, P())
        if isinstance(self.x, EllMatrix):
            # sparse rows -> leaf-sharded EllBlocks (1/S of the sparse
            # index per chip), assembled straight from the sharded tables
            if dtype is not None and jnp.dtype(dtype) == jnp.int8:
                raise ValueError("int8 quantization applies to dense "
                                 "blocks; ELL blocks pack f32/bf16 values")
            dstr = ("bf16" if dtype is not None
                    and jnp.dtype(dtype) == jnp.bfloat16 else "f32")
            cols_b, vals_b, sq, ids = _dp_pack_ell(
                self.mesh, self.plan, self.n_trees, self.arrays.perm,
                self.x.cols, self.x.vals, dstr,
                jax.device_put(jnp.asarray(pos_a), repl0),
                jax.device_put(jnp.asarray(in_leaf_a), repl0),
            )
            self._packed = (EllBlocks(self.dim, cols_b, vals_b), sq, ids)
            self._block_scale = None
            self._packed_mode = "leaf"
            self._pack_cfg = {
                "dtype": jnp.bfloat16 if dstr == "bf16" else None}
            self._small = tuple(
                jax.device_put(a, repl0)
                for a in (self.arrays.r, self.arrays.thr, self.arrays.mgl,
                          self.arrays.mgh)
            )
            return self
        r_sub = in_sub_a = None
        if s_blk > 1:
            from ..models.forest import _sub_pack_tables

            ls_ = lmax_ // s_blk
            r_sub, in_sub_a, sub_len = _sub_pack_tables(
                self.seed, self.dim, lens_, ls_, s_blk)
            in_sub_a = jax.device_put(in_sub_a, repl0)
            self._sub_len_dev = jax.device_put(jnp.asarray(
                np.tile(sub_len, self.n_trees)), repl0)
            # storage-row order: leaf g on shard g % S at leaf row g // S
            n_sh = self.mesh.shape[DATA_AXIS]
            nl = self.plan.n_leaves
            g_total = self.n_trees * nl
            g_per = -(-g_total // n_sh)
            g_rows = np.concatenate([
                s_ + n_sh * np.arange(g_per) for s_ in range(n_sh)])
            ok_rows = g_rows < g_total
            g_rows = np.minimum(g_rows, g_total - 1)
            sl_rows = sub_len.reshape(nl, s_blk)[g_rows % nl]
            sl_rows[~ok_rows] = 0
            self._sub_len_rows_dev = jax.device_put(
                jnp.asarray(sl_rows.reshape(-1)),
                NamedSharding(self.mesh, P(DATA_AXIS)))
        self._sub_block = s_blk
        out = _dp_pack(
            self.mesh, self.plan, self.n_trees, self.arrays.perm, self.x,
            dtype_str,
            jax.device_put(jnp.asarray(pos_a), repl0),
            jax.device_put(jnp.asarray(in_leaf_a), repl0),
            centered=centered, sub=s_blk, r_sub=r_sub, in_sub_arr=in_sub_a,
            sub_split=sub_split,
        )
        if centered:
            rows, sq, ids, scale, mu, mudr = out
            self._block_center = (mu, mudr)
        else:
            rows, sq, ids, scale = out
            self._block_center = None
        self._packed = (rows, sq, ids)
        self._block_scale = scale if dtype_str == "int8" else None
        self._packed_mode = "leaf"
        from ..models.forest import _DTYPE_OF

        self._pack_cfg = {"dtype": _DTYPE_OF[dtype_str],
                          "centered": centered, "sub_block": s_blk,
                          "sub_split": sub_split}
        self._small = tuple(
            jax.device_put(a, repl0)
            for a in (self.arrays.r, self.arrays.thr, self.arrays.mgl,
                      self.arrays.mgh)
        )
        return self


@functools.partial(jax.jit, static_argnames=("mesh", "k", "metric"))
def _bf_sharded(mesh, x, sq, q, k, metric):
    from ..models.forest import _brute_force

    def block(x_l, sq_l, q_l):
        n_l = x_l.shape[0]
        d_l, i_l = _brute_force(x_l, sq_l, q_l, k, metric)
        i_l = jnp.where(i_l >= 0,
                        i_l + lax.axis_index(DATA_AXIS) * n_l, -1)
        d_all = lax.all_gather(d_l, DATA_AXIS)   # [S, B, k]
        i_all = lax.all_gather(i_l, DATA_AXIS)
        s_ = d_all.shape[0]
        d_all = jnp.moveaxis(d_all, 0, 1).reshape(d_l.shape[0], s_ * k)
        i_all = jnp.moveaxis(i_all, 0, 1).reshape(i_l.shape[0], s_ * k)
        dd, ii = lax.sort((d_all, i_all), num_keys=1)
        return dd[:, :k], ii[:, :k]

    q_spec = P(QUERY_AXIS) if QUERY_AXIS in mesh.shape else P()
    return jax.shard_map(
        block, mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS), q_spec),
        out_specs=(q_spec, q_spec),
        check_vma=False,
    )(x, sq, q)


def brute_force_knn_sharded(data, q, k: int, metric: str = "l2",
                            mesh: Optional[Mesh] = None):
    """Exact kNN with the dataset sharded over points: each shard scans its
    rows (streaming chunked GEMM + running top-k), local ids are offset to
    global, and an all_gather + re-top-k merges -- exact ground truth for
    datasets beyond one chip's HBM (the eval story for sharded builds).
    ``len(data)`` must divide the shard count."""
    if mesh is None:
        mesh = data_mesh()
    n_sh = mesh.shape[DATA_AXIS]
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    if isinstance(data, EllMatrix):
        if data.n % n_sh:
            raise ValueError(f"N={data.n} not divisible by {n_sh} shards")
        xs = EllMatrix(
            data.dim,
            jax.device_put(jnp.asarray(data.cols, jnp.int32), sharding),
            jax.device_put(jnp.asarray(data.vals, jnp.float32), sharding),
        )
        sq = jnp.sum(xs.vals * xs.vals, axis=-1)
    else:
        x = jnp.asarray(data, dtype=jnp.float32)
        if x.shape[0] % n_sh:
            raise ValueError(
                f"N={x.shape[0]} not divisible by {n_sh} shards")
        xs = jax.device_put(x, sharding)
        sq = jnp.sum(xs * xs, axis=-1)
    qb = jnp.asarray(q, dtype=jnp.float32)
    if qb.ndim == 1:
        qb = qb[None]
    qb = jax.device_put(qb, NamedSharding(mesh, P()))
    return _bf_sharded(mesh, xs, sq, qb, int(k), metric)
