"""RP forest index: construction facades and query API.

The accelerator counterpart of the reference's ``RPTree``/``RPForest`` types
and their construction/query functions:

* :func:`forest_batch` / :func:`tree_batch` -- batch construction
  (``src/Data/RPTree/Batch.hs:29-63``);
* :meth:`RPForest.knn` -- candidate union + exact rerank + top-k
  (``src/Data/RPTree.hs:159-176``);
* :meth:`RPForest.knn_h` -- margin-priority bucket selection before rerank
  (``RPTree.hs:196-217``);
* :meth:`RPForest.knn_pq` -- deduplicating variant (``RPTree.hs:178-194``);
* :meth:`RPForest.candidates` -- per-tree candidate sets
  (``RPTree.hs:289-314``);
* :meth:`RPForest.recall_with` -- recall@k against the exact neighbours
  (``RPTree.hs:250-285``).

``RPForest`` is a host-side handle: the arrays live on device, the static
:class:`TreePlan` parameterises the jitted kernels, and opaque per-point
payloads (the reference's ``Embed.eData``) stay host-side keyed by row id.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import ForestConfig
from ..ops.build import TreeArrays, build_forest_arrays
from ..ops.rerank import (
    dedup_ids,
    distances_from_dots,
    gather_leaf_points,
    merge_top_k,
    rerank_top_k,
)
from ..ops.shared import SharedRows, fetch_blocks
from ..ops.sparse import EllBlocks, EllMatrix, ell_sq_norms, ell_to_dense
from ..ops.traverse import build_b1_tables, traverse_tree
from ..utils import gen as rgen
from .plan import TreePlan, make_plan

__all__ = ["RPForest", "forest_batch", "tree_batch", "DEFAULT_BUDGET"]

DEFAULT_BUDGET = 32

# matmul precision for the exact-rerank / brute-force distance GEMMs.
# "highest" (IEEE f32 products) is the parity default; "default" (the
# backend's fast f32 matmul, e.g. TF32 tensor cores on a GPU) is the
# serving mode -- its distance error perturbs near-tie orderings but not
# recall statistics (bench.py and chip_smoke.py report both).  "fastest"
# additionally switches the brute-force scan's per-tile selection to
# lax.approx_max_k; outside the scan it behaves like "default".
_PRECISIONS = ("highest", "default", "fastest")

def _dtype_str(dtype) -> str:
    """Validated block-dtype name for pack_leaves: f32 / bf16 / int8.
    Anything else raises (silently substituting f32 would double the
    expected index memory without any indication)."""
    if dtype is None:
        return "f32"
    dt = jnp.dtype(dtype)
    if dt == jnp.dtype(jnp.int8):
        return "int8"
    if dt == jnp.dtype(jnp.bfloat16):
        return "bf16"
    if dt == jnp.dtype(jnp.float32):
        return "f32"
    raise ValueError(
        f"pack_leaves supports f32 / bfloat16 / int8 blocks; got {dtype}"
    )


# inverse of _dtype_str: replaying a remembered pack configuration
# (rebuild) needs the jnp dtype back from the recorded name
_DTYPE_OF = {"f32": None, "bf16": jnp.bfloat16, "int8": jnp.int8}


def _tile_align(n: int) -> int:
    """Slot-axis alignment: 8-row multiples for every block dtype (the
    padded slots are ordinary empty, maskable slots)."""
    return -(-n // 8) * 8


def _center_quantize(rows, valid):
    """Centered (residual) int8 quantization, shared by every packer so
    the layouts stay provably identical: ``rows [..., L, D]``,
    ``valid [..., L]`` (broadcastable).  Returns ``(q int8, scale
    [..., 1, 1], mu [..., D], mudr [..., L])`` where ``mudr`` is the
    precomputed ``mean . dequantized-residual`` term."""
    occ = jnp.maximum(jnp.sum(valid, axis=-1).astype(jnp.float32), 1.0)
    mu = jnp.sum(rows, axis=-2) / occ[..., None]
    res = jnp.where(valid[..., None], rows - mu[..., None, :], 0.0)
    amax = jnp.max(jnp.abs(res), axis=(-2, -1), keepdims=True)
    scale = jnp.maximum(amax, 1e-30) / 127.0
    q = jnp.clip(jnp.round(res / scale), -127, 127).astype(jnp.int8)
    mudr = jnp.einsum("...ld,...d->...l",
                      q.astype(jnp.float32) * scale, mu)
    return q, scale, mu, mudr



def _sub_order_kmeans(rows, valid, r_sub, sub):
    """Within-leaf row ordering for sub-block packing by RECURSIVE
    BALANCED 2-MEANS (``log2(sub)`` levels): at each level every current
    segment fits a 2-means pair (farthest-point init along ``r_sub``,
    four Lloyd steps over the segment's valid rows), reorders the segment
    by the margin ``|x - c1|^2 - |x - c2|^2``, and splits at the midpoint.
    Each final sub-block's rows then share a real cluster center (up to
    the balance constraint), which is what centered int8 needs on leaves
    that straddle clusters -- the 1-D projection sort only gives "nearly
    pure" slices.

    Invalid rows key ``+inf`` at every level, so they stay a contiguous
    tail of every segment and the flat occupancy formula
    ``clip(len - j*ls, 0, ls)`` keeps holding per sub-block.  ``sub``
    must be a power of two.  Returns ``order int32[nl, lmax]`` (apply to
    ids and rows alike)."""
    nl, lmax, d = rows.shape
    order = jnp.broadcast_to(jnp.arange(lmax, dtype=jnp.int32),
                             (nl, lmax))
    levels = sub.bit_length() - 1
    r, v = rows, valid
    for j in range(levels):
        segs = nl * (1 << j)
        m = lmax >> j
        rs = r.reshape(segs, m, d)
        vs = v.reshape(segs, m)
        os_ = order.reshape(segs, m)
        key = jnp.where(vs, rs @ r_sub, jnp.inf)
        i1 = jnp.argmin(key, axis=-1)
        c1 = jnp.take_along_axis(rs, i1[:, None, None], axis=1)[:, 0]
        d1 = jnp.sum((rs - c1[:, None]) ** 2, axis=-1)
        i2 = jnp.argmax(jnp.where(vs, d1, -jnp.inf), axis=-1)
        c2 = jnp.take_along_axis(rs, i2[:, None, None], axis=1)[:, 0]
        for _ in range(4):
            d1 = jnp.sum((rs - c1[:, None]) ** 2, axis=-1)
            d2 = jnp.sum((rs - c2[:, None]) ** 2, axis=-1)
            a1 = ((d1 <= d2) & vs).astype(jnp.float32)
            a2 = ((d1 > d2) & vs).astype(jnp.float32)
            n1 = jnp.sum(a1, axis=-1, keepdims=True)
            n2 = jnp.sum(a2, axis=-1, keepdims=True)
            # empty clusters keep their previous center
            c1 = jnp.where(n1 > 0, jnp.einsum("sm,smd->sd", a1, rs)
                           / jnp.maximum(n1, 1.0), c1)
            c2 = jnp.where(n2 > 0, jnp.einsum("sm,smd->sd", a2, rs)
                           / jnp.maximum(n2, 1.0), c2)
        margin = (jnp.sum((rs - c1[:, None]) ** 2, axis=-1)
                  - jnp.sum((rs - c2[:, None]) ** 2, axis=-1))
        ord2 = jnp.argsort(jnp.where(vs, margin, jnp.inf), axis=-1)
        r = jnp.take_along_axis(rs, ord2[..., None], axis=1
                                ).reshape(nl, lmax, d)
        v = jnp.take_along_axis(vs, ord2, axis=1).reshape(nl, lmax)
        order = jnp.take_along_axis(os_, ord2, axis=1).reshape(nl, lmax)
    return order


def _grouped_auto_capacity(f, key, e, tile_m, tile_chunk, nt, run,
                           check=True):
    """Shared tile-capacity auto-sizing for the grouped rerank (single
    source for the single-device and sharded wrappers): start from the
    cached capacity for this shape (else 2.25x pairs/tile_m -- the
    clustered flagship's tile count sits just above 2x, so 2x would
    retry-recompile at the margin), run, and retry with 12.5% headroom on
    overflow (results are exact only when ``needed <= capacity``).

    Cache policy: an EXPLICIT ``nt`` never writes the cache (a one-off
    generous capacity must not permanently inflate every later auto call
    -- each tile costs fetch+matmul work whether or not it is needed),
    and an auto run re-tightens a cached capacity that is > 2x the
    needed tiles (one recompile buys back the per-call waste; within
    [1x..2x] the cache is left alone for batch-to-batch stability).

    ``check=False`` (steady-state serving): once a capacity is known --
    from the cache (a previous CHECKED call at this shape key) or an
    explicit ``nt`` -- skip the ``int(needed)`` device->host fetch
    entirely, so the call chain stays free of host syncs.
    The first auto call at a new shape key still validates and caches.
    Overflow beyond the capacity then degrades softly (overflow pairs
    are masked to +inf -- candidates silently dropped, never wrong
    distances), which a stationary query stream's 12.5% cached headroom
    is sized to avoid."""
    tc = max(1, int(tile_chunk))
    cap_max = -(-e // tc) * tc  # every pair its own tile

    def _bucket(n):
        # grouped_distances reshapes the tile axis into [nt/tc, tc]
        # chunks, so every capacity is rounded up to a tc multiple
        return min(max(-(-int(n) // tc) * tc, tc), cap_max)

    if not hasattr(f, "_grouped_nt"):
        f._grouped_nt = {}
    if not f._grouped_nt:
        # capacities learned in an earlier process ride checkpoint
        # headers (save_forest); they apply only under the pack layout
        # they were learned on
        saved = getattr(f, "_grouped_nt_saved", None)
        if saved and saved.get("pack") == _pack_sig(f):
            f._grouped_nt = {
                tuple(int(v) for v in ks.split(",")): int(cap)
                for ks, cap in saved["caps"].items()
            }
    if not check and (nt is not None or key in f._grouped_nt):
        cap = _bucket(int(nt)) if nt is not None else f._grouped_nt[key]
        out, needed = run(cap, min(tc, cap))
        # overflow telemetry WITHOUT a host sync: the psum-maxed needed
        # count stays a device scalar; grouped_overflow() fetches it on
        # demand (poll every N batches in a serving loop)
        f._grouped_last = (needed, cap)
        return out
    cap = _bucket(int(nt)) if nt is not None else f._grouped_nt.get(
        key, _bucket(2 * e // int(tile_m) + e // (4 * int(tile_m))))
    while True:
        out, needed = run(cap, min(tc, cap))
        needed = int(needed)
        if needed <= cap or nt is not None:
            break
        cap = _bucket(needed + needed // 8)
    f._grouped_last = (needed, cap)
    if nt is None:
        tight = _bucket(needed + needed // 8)
        cached = f._grouped_nt.get(key, 0)
        if cached < tight or cached > 2 * tight:
            f._grouped_nt[key] = tight
    return out


def _ell_tile_chunk_cap(x_leaf, dim, tile_m, tile_chunk) -> int:
    """Bound the grouped ELL scorer's per-``lax.map``-step buffers at
    vocab-scale dims: each step materializes the tile chunk's DENSE
    query rows ``[tc, m, dim]`` and the gathered contraction
    ``[tc, m, lmax, K]`` -- at bag-of-words dims (V=65536, tc=2048,
    m=16 -> an 8 GB qt buffer alone) the default chunk runs device memory
    out.  Clamp ``tc`` so the larger of
    the two stays ~64M elements (~256 MB f32); dense blocks are
    unaffected."""
    if not isinstance(x_leaf, EllBlocks):
        return tile_chunk
    per = max(int(tile_m) * max(int(dim),
                                x_leaf.shape[-2] * x_leaf.shape[-1]), 1)
    return max(16, min(int(tile_chunk), (64 << 20) // per))


def _pack_sig(f):
    """JSON-safe signature of the serving layout a grouped tile capacity
    was learned under (capacities are a function of the block structure;
    a checkpointed capacity must never be replayed onto a different
    layout -- a stale/tiny one silently masks pairs under
    ``check=False``)."""
    cfg = getattr(f, "_pack_cfg", None)
    if cfg is None:
        return None
    d = cfg.get("dtype")
    return {
        "dtype": None if d is None else jnp.dtype(d).name,
        "centered": bool(cfg.get("centered", False)),
        "sub_block": int(cfg.get("sub_block", 1) or 1),
        "sub_split": cfg.get("sub_split"),
        "store": cfg.get("store", "blocks"),
        "slack": int(getattr(f, "_pack_slack", 0)),
        "mode": getattr(f, "_packed_mode", None),
        # per-shard capacities are a function of the mesh shape too
        "mesh": (dict((k, int(v)) for k, v in f.mesh.shape.items())
                 if getattr(f, "mesh", None) is not None else None),
    }


def _sub_split_of(sub_split: str, s: int) -> str:
    """Validate/normalize the sub-block ordering mode (single source for
    every packer): unknown modes raise; "kmeans" needs a power-of-two
    ``s`` (recursive halving) and falls back to the projection sort."""
    if sub_split not in ("kmeans", "proj"):
        raise ValueError("sub_split must be 'kmeans' or 'proj', "
                         f"got {sub_split!r}")
    if s > 1 and sub_split == "kmeans" and (s & (s - 1)):
        return "proj"
    return sub_split


def _sub_pack_tables(seed, dim, lens, ls, sub):
    """Shared sub-block pack-time state (single source for every packer,
    so the layouts provably agree): the within-leaf ordering direction
    ``r_sub`` (seeded; fold_in salt 987), the per-sub-block occupancy
    ``sub_len int32[n_leaves * sub]`` (valid rows are a contiguous prefix
    of every leaf, so sub j holds ``clip(len - j*ls, 0, ls)``), and the
    slot-validity mask ``in_sub bool[n_leaves * sub, ls]``."""
    import numbers

    j = np.arange(sub)
    sub_len = np.clip(np.asarray(lens)[:, None] - j[None, :] * ls, 0, ls
                      ).astype(np.int32).reshape(-1)
    in_sub = jnp.asarray(np.arange(ls)[None, :] < sub_len[:, None])
    # numbers.Integral (not isinstance int): numpy integer seeds must not
    # silently fall back to 0
    seed0 = int(seed) if isinstance(seed, numbers.Integral) else 0
    r_sub = jax.random.normal(
        jax.random.fold_in(rgen.key_from_seed(seed0), 987),
        (dim,), jnp.float32)
    return r_sub, in_sub, sub_len


def _expand_sub_probes(rows, lsel, sub):
    """Expand a leaf-granular probe selection to sub-block granularity:
    leaf storage row g becomes rows ``g*sub .. g*sub + sub - 1`` (a
    leaf's sub-blocks are contiguous under its leaf row in EVERY packed
    layout), and the occupancy-mask leaf ids repeat per slice.  Single
    source for the packed, grouped, and sharded scorers."""
    b, p = rows.shape
    rows = (rows[..., None] * sub
            + jnp.arange(sub, dtype=jnp.int32)).reshape(b, p * sub)
    return rows, jnp.repeat(lsel, sub, axis=-1)


def _prec(precision: str):
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}")
    return (jax.lax.Precision.HIGHEST if precision == "highest"
            else jax.lax.Precision.DEFAULT)


def _pad_to_chunk(qb: jax.Array, chunk: int):
    """Pad a [B, D] batch up to a multiple of ``chunk`` rows; returns
    (padded batch, original B, effective chunk)."""
    b = qb.shape[0]
    ch = max(1, min(int(chunk), b))
    pad = (-b) % ch
    if pad:
        qb = jnp.concatenate(
            [qb, jnp.zeros((pad, qb.shape[1]), qb.dtype)], axis=0)
    return qb, b, ch


def _as_dense_queries(q, dim: int) -> jax.Array:
    """Queries as f32[B, D]; single vectors are auto-batched; sparse queries
    (SVec or EllMatrix) are densified (B is small)."""
    from ..ops.vector import SVec, to_dense

    if isinstance(q, SVec):
        q = to_dense(q)
    if isinstance(q, EllMatrix):
        q = ell_to_dense(q)
    q = jnp.asarray(q, dtype=jnp.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or q.shape[0] == 0:
        raise ValueError(f"queries must be [B>=1, dim], got shape {q.shape}")
    if q.shape[-1] != dim:
        raise ValueError(f"query dim {q.shape[-1]} != index dim {dim}")
    return q


# ---------------------------------------------------------------------------
# jitted query pipeline (static: plan, budget, k, metric, dedup)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("plan", "budget"))
def _traverse_forest(plan: TreePlan, arrays: TreeArrays, q: jax.Array,
                     budget: int, tabs=None):
    """All-tree traversal: returns (leaf_ids int32[T, B, F], prio f32[T, B, F]).

    ``tabs``: optional prebuilt :func:`_b1_forest_tables` output -- pass it
    when traversing inside a ``lax.map`` chunk loop so the budget=1
    superlevel tables hoist out of the loop as closure constants."""
    nl = plan.n_levels
    r_used = arrays.r[:, :nl, :]  # [T, L, D]
    projq = jnp.einsum("bd,tld->tbl", q, r_used,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    # profiler region named after the reference's SCC ({-# SCC candidates #-})
    with jax.named_scope("rpt_candidates"):
        if tabs is None:
            tabs = _b1_forest_tables(plan, arrays, budget)
        if tabs is None:  # no superlevel fast path at this budget
            return jax.vmap(
                lambda th, lo, hi, pq:
                    traverse_tree(plan, th, lo, hi, pq, budget)
            )(arrays.thr, arrays.mgl, arrays.mgh, projq)
        t = arrays.thr.shape[0]
        # tables ride UNBATCHED (in_axes=None) in their flat [T * S0, ...]
        # layout with per-tree offsets: a vmap-batched gather operand
        # would add a batch dimension to every table index
        return jax.vmap(
            lambda th, lo, hi, pq, ti:
                traverse_tree(plan, th, lo, hi, pq, budget, tabs=tabs,
                              toff=ti),
            in_axes=(0, 0, 0, 0, 0),
        )(arrays.thr, arrays.mgl, arrays.mgh, projq,
          jnp.arange(t, dtype=jnp.int32))


def _b1_forest_tables(plan, arrays, budget):
    """Superlevel traversal tables for all trees in the FLAT layout
    (per block ``[T * S0, P-1, 5]`` -- tree-major row spans, indexed by
    ``tree * S0 + seg``); ``None`` unless the budget <= _FK_MAX_BUDGET
    fast paths apply.  Build once per dispatch and thread into the
    per-chunk traversals."""
    from ..ops.traverse import _FK_MAX_BUDGET, _b1_blocks

    if budget > _FK_MAX_BUDGET or not _b1_blocks(plan):
        return None
    per_tree = jax.vmap(
        lambda th, lo, hi: build_b1_tables(plan, th, lo, hi)
    )(arrays.thr, arrays.mgl, arrays.mgh)
    return tuple(tb.reshape((-1,) + tb.shape[2:]) for tb in per_tree)


@functools.partial(jax.jit, static_argnames=("plan", "budget"))
def _candidate_ids(plan: TreePlan, arrays: TreeArrays, q: jax.Array, budget: int):
    """Per-tree candidate point ids: int32[T, B, F * max_leaf_len], -1 pad."""
    leaf_ids, _ = _traverse_forest(plan, arrays, q, budget)
    return jax.vmap(lambda perm, lids: gather_leaf_points(plan, perm, lids))(
        arrays.perm, leaf_ids
    )


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "metric", "dedup", "precision",
                     "min_votes"),
)
def _knn(plan, arrays, x, sq_norms, q, k, budget, metric, dedup,
         precision="highest", min_votes=1):
    """Forest kNN: union of per-tree candidates -> exact rerank -> top-k
    (reference ``knn``, RPTree.hs:159-176; with dedup=True it is ``knnPQ``,
    RPTree.hs:178-194)."""
    cand = _candidate_ids(plan, arrays, q, budget)  # [T, B, C1]
    t, b, c1 = cand.shape
    union = jnp.transpose(cand, (1, 0, 2)).reshape(b, t * c1)
    if min_votes > 1:
        union = dedup_ids(union, min_votes=min_votes)
        return rerank_top_k(x, sq_norms, q, union, k, metric=metric,
                            dedup=False, precision=_prec(precision))
    return rerank_top_k(x, sq_norms, q, union, k, metric=metric, dedup=dedup,
                        precision=_prec(precision))


def _select_probes(plan, arrays, q, budget, probes, k=None,
                   bucket_stop=False, block_len=None, tabs=None):
    """Traverse and compact the forest's candidate buckets to the
    ``probes`` lowest-margin-priority leaves per query.

    Returns ``(gsel int32[B, P], lsel int32[B, P])``: global block index
    (tree * n_leaves + leaf; masked entries point at block 0) and leaf id
    (-1 where masked).  With ``bucket_stop`` the reference knnH cumulative
    stop rule masks buckets beyond the first ``k`` collected points.
    """
    leaf_ids, prio = _traverse_forest(plan, arrays, q, budget,
                                      tabs=tabs)  # [T, B, F]
    t, b, f = leaf_ids.shape
    nl = plan.n_leaves
    gid = leaf_ids + jnp.arange(t, dtype=jnp.int32)[:, None, None] * nl
    gid_bt = jnp.moveaxis(gid, 0, 1).reshape(b, t * f)
    prio_bt = jnp.moveaxis(prio, 0, 1).reshape(b, t * f)
    live = jnp.moveaxis(leaf_ids >= 0, 0, 1).reshape(b, t * f)
    prio_bt = jnp.where(live, prio_bt, jnp.inf)
    probes = min(probes, t * f)
    # priority sort carrying the block ids as a payload operand (top_k +
    # two take_along_axis gathers would cost ~2x this sort)
    prio_s, gid_s = lax.sort((prio_bt, gid_bt), num_keys=1)
    prio_s, gid_s = prio_s[:, :probes], gid_s[:, :probes]
    lsel = jnp.where(jnp.isinf(prio_s), -1,
                     gid_s % nl if t > 1 else gid_s)
    gsel = gid_s
    if bucket_stop:
        # knn_h semantics (RPTree.hs:208-217): consume buckets in
        # ascending priority while the cumulative size stays <= k, always
        # keeping the first; buckets beyond the stop are masked out.
        # (probes bounds the window; exact whenever the stop fires within
        # it, which min_leaf-sized buckets guarantee for probes >= k.)
        # ``block_len`` (dynamic occupancy after fold()) supersedes the
        # static plan sizes so folded rows count toward the cutoff.
        if block_len is not None:
            sizes = jnp.where(lsel >= 0, jnp.take(block_len, gsel), 0)
        else:
            sizes = jnp.where(
                lsel >= 0,
                jnp.take(jnp.asarray(plan.leaf_len),
                         jnp.clip(lsel, 0, None)),
                0,
            )
        csum = jnp.cumsum(sizes, axis=-1)
        keep = (csum <= k) | (jnp.arange(probes)[None, :] == 0)
        lsel = jnp.where(keep, lsel, -1)
    gsel = jnp.where(lsel >= 0, gsel, 0)
    return gsel, lsel


def _selection_tail(d, id_leaf, rows_sel, k, kk, dedup, min_votes=1,
                    selection="sort"):
    """Shared candidate-selection tail of every leaf-blocked scorer
    (per-pair, grouped, and the sharded kernels): ids are fetched as
    whole leaf blocks with the same ``[B, P]`` index pattern as the rows
    and carried THROUGH the sort as a payload operand (the comparator
    network moves payloads without a per-element id gather), then the
    dedup/vote merge.  ``d: f32[B, P * lmax]`` with +inf in masked
    slots."""
    b, w = d.shape
    lmax = id_leaf.shape[-1]
    probes = rows_sel.shape[1]
    kk = min(kk, probes * lmax)
    ids_blk = jnp.take(id_leaf, rows_sel, axis=0)  # [B, P, lmax]
    ids_flat = ids_blk.reshape(b, probes * lmax)
    with jax.named_scope("rpt_topk_tail"):
        return _selection_tail_ids(d, ids_flat, k, kk, dedup,
                                   min_votes=min_votes, selection=selection)


def _selection_tail_ids(d, ids_flat, k, kk, dedup, min_votes=1,
                        selection="sort"):
    """Top-k (dedup / vote) selection over scored candidates with their
    point ids: ``d f32[B, W]`` (+inf = masked), ``ids_flat int32[B, W]``.
    ``selection``: "sort" (payload sort + merge, the reference form),
    "kernel" (the fused streaming top-k, GPU) or "approx"."""
    w = d.shape[1]
    if min_votes > 1:
        # vote counting is exact only over the FULL candidate list: a
        # fixed kk truncation can crowd a far candidate's vote copies out
        # behind closer single-vote candidates and silently drop it.
        # Matches the unpacked union filter (_knn -> dedup_ids) and the
        # distributed paths' full-width merges.
        kk = w
    else:
        kk = min(kk, w)
    if selection == "kernel" and min_votes == 1:
        # fused streaming top-k extraction (ops/topk_kernel): k serial
        # (min, tie-break, mask-by-id) passes over register-resident row
        # blocks -- one read of the candidate state instead of the
        # payload sort's compare-exchange network, and the duplicate-id
        # masking makes the k*n_trees overselect + id-sort dedup
        # unnecessary.  Ties and duplicates resolve as in the sort tail.
        from ..ops.topk_kernel import topk_dedup_kernel, topk_kernel_ok

        if not topk_kernel_ok(w, k, min_votes, "sort"):
            raise ValueError(
                "selection='kernel' needs a GPU backend, k <= 128, and "
                "min_votes == 1; use selection='sort'")
        return topk_dedup_kernel(d, ids_flat, k, dedup=dedup)
    if selection == "approx" and min_votes == 1 and kk < w:
        # approximate top-k (lax.approx_max_k) -- opt-in only.
        # APPROXIMATE: per-element recall of the kk-candidate set is
        # ~recall_target; exact contracts (oracle parity, min_votes
        # counts) keep the sort.
        neg, sel_idx = lax.approx_max_k(-d, kk, recall_target=0.99)
        d_top = -neg
        ids_top = jnp.take_along_axis(ids_flat, sel_idx, axis=-1)
    else:
        d_sorted, ids_sorted = lax.sort((d, ids_flat), num_keys=1)
        d_top, ids_top = d_sorted[:, :kk], ids_sorted[:, :kk]
    ids_top = jnp.where(jnp.isinf(d_top), -1, ids_top)
    return merge_top_k(d_top, ids_top, k, dedup=dedup, min_votes=min_votes)


def _score_blocks(plan, x_leaf, sq_leaf, id_leaf, rows_sel, lsel, q, k,
                  kk, metric, dedup, precision, min_votes=1,
                  block_scale=None, block_len=None, block_center=None,
                  selection="sort"):
    """Fetch and exactly score the selected leaf blocks.

    ``rows_sel int32[B, P]``: row index into the (possibly shard-local)
    block arrays; ``lsel``: leaf ids for occupancy masking (-1 = skip).
    ``block_len int32[G]``, when given, overrides the plan's static leaf
    occupancy (blocks grown by :meth:`RPForest.fold`).  The slot axis may
    exceed ``plan.max_leaf_len`` (slack slots for folded inserts).
    Returns ``(dists f32[B, k], ids int32[B, k])``.
    """
    lmax = x_leaf.shape[-2]
    b, probes = rows_sel.shape
    # profiler region: the serving-side analog of the reference's
    # {-# SCC insert #-}/rerank hot path (fetch + exact distances);
    # see rptree_tpu.profiling
    with jax.named_scope("rpt_rerank"):
        return _score_blocks_body(plan, x_leaf, sq_leaf, id_leaf,
                                  rows_sel, lsel, q, k, kk, metric, dedup,
                                  precision, min_votes, block_scale,
                                  block_len, block_center, selection,
                                  lmax, b, probes)


def _score_blocks_body(plan, x_leaf, sq_leaf, id_leaf, rows_sel, lsel, q,
                       k, kk, metric, dedup, precision, min_votes,
                       block_scale, block_len, block_center, selection,
                       lmax, b, probes):
    if isinstance(x_leaf, EllBlocks):
        # sparse blocks: gather whole (cols, vals) blocks with the same
        # [B, P] index pattern, fetch the DENSE query at the stored
        # column indices, contract over the K slot axis (padding slots
        # are col=0/val=0 and contribute nothing) -- the batched form of
        # the reference's innerSD pointer walk (Internal.hs:369-382)
        if callable(metric):
            raise NotImplementedError(
                "custom distance callables need dense data rows"
            )
        cols = jnp.take(x_leaf.cols, rows_sel, axis=0)  # [B, P, lmax, K]
        vals = jnp.take(x_leaf.vals, rows_sel, axis=0)
        qg = jnp.take_along_axis(q[:, None, None, :],
                                 cols.astype(jnp.int32), axis=-1)
        dots = jnp.sum(vals.astype(jnp.float32) * qg, axis=-1)
        sqx = jnp.take(sq_leaf, rows_sel, axis=0)
        d = distances_from_dots(dots, sqx, q[:, None], metric)
    else:
        # [B, P, lmax, D] block gather; x_leaf is stored 3-D so no
        # reshape (a [.., lmax*D] -> [.., lmax, D] reshape can force a
        # relayout copy of the gathered blocks).  On the
        # shared-row layout this is an id-table gather + per-row gather
        # instead (ops/shared.py: lmax x the indices, 1/T the memory)
        rows = fetch_blocks(x_leaf, rows_sel)
        if callable(metric):
            # user distance callable (the reference's distf,
            # RPTree.hs:168): applied to the gathered block rows
            if rows.dtype == jnp.int8:
                raise NotImplementedError(
                    "custom distance callables are unsupported on int8-"
                    "quantized blocks (pack with f32/bf16)"
                )
            d = metric(rows.astype(jnp.float32), q[:, None, None, :])
        else:
            if rows.dtype == jnp.int8:
                bscale = jnp.take(block_scale, rows_sel, axis=0)  # [B, P]
                if block_center is not None:
                    # CENTERED quantization: blocks store int8 RESIDUALS
                    # around the block mean (f32), so the quantization
                    # step shrinks by the center-to-spread ratio -- on
                    # clustered data (near-equidistant in-cluster
                    # neighbours) plain int8 scrambles the ranking while
                    # centered int8 matches f32 recall at int8 bandwidth.
                    # dot(q, x^) = q.mu + (q - mu).r^ + mu.r^ with the
                    # last term precomputed per slot at pack time.
                    mu, mudr = block_center
                    mu_g = jnp.take(mu, rows_sel, axis=0)     # [B, P, D]
                    md_g = jnp.take(mudr, rows_sel, axis=0)   # [B, P, L]
                    qc = q[:, None, :] - mu_g
                    qmax = jnp.max(jnp.abs(qc), axis=-1, keepdims=True)
                    qscale = jnp.maximum(qmax, 1e-30) / 127.0
                    qc_i8 = jnp.clip(jnp.round(qc / qscale), -127, 127
                                     ).astype(jnp.int8)
                    dots_i = jnp.einsum("bpld,bpd->bpl", rows, qc_i8,
                                        preferred_element_type=jnp.int32)
                    q_mu = jnp.einsum("bpd,bd->bp", mu_g, q,
                                      preferred_element_type=jnp.float32)
                    dots = (q_mu[..., None] + md_g
                            + dots_i.astype(jnp.float32)
                            * bscale[..., None] * qscale)
                else:
                    # quantized blocks: per-leaf scales stored alongside;
                    # the query is symmetrically quantized per row, dots
                    # accumulate in int32, and the stored
                    # squared norms stay EXACT f32 -- only the cross term
                    # of |x|^2 - 2 x.q + |q|^2 carries quantization error
                    qmax = jnp.max(jnp.abs(q), axis=-1, keepdims=True)
                    qscale = jnp.maximum(qmax, 1e-30) / 127.0
                    q_i8 = jnp.clip(jnp.round(q / qscale), -127, 127
                                    ).astype(jnp.int8)
                    dots_i = jnp.einsum("bpld,bd->bpl", rows, q_i8,
                                        preferred_element_type=jnp.int32)
                    dots = (dots_i.astype(jnp.float32)
                            * bscale[..., None] * qscale[:, None])
            else:
                dots = jnp.einsum("bpld,bd->bpl", rows,
                                  q.astype(rows.dtype),
                                  preferred_element_type=jnp.float32,
                                  precision=_prec(precision))
            # squared norms precomputed per slot at pack time: a [B, P]-
            # index gather instead of a second multiply-reduce over rows
            sqx = jnp.take(sq_leaf, rows_sel, axis=0)
            d = distances_from_dots(dots, sqx, q[:, None], metric)
    if block_len is not None:
        lens = jnp.take(block_len, rows_sel)
    else:
        lens = jnp.take(jnp.asarray(plan.leaf_len), jnp.clip(lsel, 0, None))
    valid = (lsel >= 0)[..., None] & (
        jnp.arange(lmax, dtype=jnp.int32) < lens[..., None]
    )
    d = jnp.where(valid, d, jnp.inf).reshape(b, probes * lmax)
    return _selection_tail(d, id_leaf, rows_sel, k, kk, dedup,
                           min_votes=min_votes, selection=selection)


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "probes", "metric", "dedup",
                     "precision", "bucket_stop", "min_votes", "sub",
                     "selection"),
)
def _knn_packed(plan, arrays, x_leaf, sq_leaf, id_leaf, q, k, budget,
                probes, metric, dedup, precision="highest",
                bucket_stop=False, min_votes=1, block_scale=None,
                block_len=None, block_center=None, sub=1,
                selection="sort", tabs=None):
    """Leaf-blocked forest kNN: semantically the candidate-union +
    exact-rerank + top-k of :func:`_knn`, restructured so a gather's
    cost follows whole blocks rather than single rows.  Candidates are
    fetched per LEAF block (probes gather indices instead of probes *
    lmax row indices), the bucket union is
    compacted by margin priority before any fetch, and ids ride the
    selection sorts as payload operands.  See :func:`_select_probes` and
    :func:`_score_blocks`.
    """
    t = arrays.perm.shape[0]
    # probe selection is at LEAF granularity (bucket-stop sizes read the
    # static leaf occupancy; sub-blocked layouts never fold, so the
    # dynamic block_len only applies at leaf granularity when sub == 1)
    gsel, lsel = _select_probes(plan, arrays, q, budget, probes, k=k,
                                bucket_stop=bucket_stop,
                                block_len=None if sub > 1 else block_len,
                                tabs=tabs)
    if sub > 1:
        gsel, lsel = _expand_sub_probes(gsel, lsel, sub)
    kk = k * t if dedup else k
    return _score_blocks(plan, x_leaf, sq_leaf, id_leaf, gsel, lsel, q, k,
                         kk, metric, dedup, precision, min_votes=min_votes,
                         block_scale=block_scale, block_len=block_len,
                         block_center=block_center, selection=selection)


def _knn_h_ids(plan, arrays, q, k, budget):
    """Candidate point ids selected by the knnH bucket-stop rule
    (RPTree.hs:208-217): buckets in ascending margin-priority order while
    the running size stays <= k (always keeping the first).  Returns
    ``int32[B, M]`` ids with -1 padding -- the rerank-ready candidate set,
    shared by the single-device and data-sharded paths."""
    leaf_ids, prio = _traverse_forest(plan, arrays, q, budget)  # [T, B, F]
    t, b, f = leaf_ids.shape
    leaf_ids_bt = jnp.transpose(leaf_ids, (1, 0, 2)).reshape(b, t * f)
    prio_bt = jnp.transpose(prio, (1, 0, 2)).reshape(b, t * f)
    tree_of = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.int32)[:, None], (t, f)
    ).reshape(t * f)[None, :].repeat(b, axis=0)

    # order buckets by priority (empty slots have +inf priority)
    order = jnp.argsort(prio_bt, axis=-1)
    leaf_sorted = jnp.take_along_axis(leaf_ids_bt, order, axis=-1)
    tree_sorted = jnp.take_along_axis(tree_of, order, axis=-1)
    sizes = jnp.where(
        leaf_sorted >= 0,
        jnp.take(jnp.asarray(plan.leaf_len), jnp.clip(leaf_sorted, 0, None)),
        0,
    )
    csum = jnp.cumsum(sizes, axis=-1)
    # reference stop rule (RPTree.hs:208-217): include buckets while the
    # running total stays <= k; always include the first bucket
    first = jnp.arange(t * f)[None, :] == 0
    keep = (csum <= k) | first
    leaf_kept = jnp.where(keep & (leaf_sorted >= 0), leaf_sorted, -1)

    # expand kept buckets to point ids via each owning tree's permutation
    perm_rows = arrays.perm[tree_sorted.reshape(-1)].reshape(b, t * f, -1)
    lmax = max(plan.max_leaf_len, 1)
    starts = jnp.take(jnp.asarray(plan.leaf_start), jnp.clip(leaf_kept, 0, None))
    lens = jnp.take(jnp.asarray(plan.leaf_len), jnp.clip(leaf_kept, 0, None))
    offs = jnp.arange(lmax, dtype=jnp.int32)
    pos = starts[..., None] + offs  # [B, T*F, Lmax]
    valid = (leaf_kept >= 0)[..., None] & (offs < lens[..., None])
    pos = jnp.where(valid, pos, 0)
    ids = jnp.take_along_axis(perm_rows, pos, axis=-1)
    return jnp.where(valid, ids, -1).reshape(b, -1)


def _grouped_use_kernel(impl, x_leaf, metric, block_scale, block_center,
                        tile_m=16):
    """Trace-time gate for the fused grouped tile kernel: dense resident
    f32/bf16/int8 blocks, no centered residuals, builtin l2/sql2, a
    power-of-two ``tile_m >= 16`` and a GPU backend.  ``impl``: "auto"
    (kernel when eligible), "xla", or "kernel" (raise if ineligible)."""
    if impl == "xla":
        return False
    if impl not in ("auto", "kernel"):
        raise ValueError(f"impl must be 'auto', 'xla' or 'kernel'; got "
                         f"{impl!r}")
    from ..ops.grouped_kernel import grouped_kernel_ok

    # int8 blocks carry a per-block scale (the kernel dequantizes it
    # against exact stored norms); centered residual blocks keep XLA
    ok = ((block_scale is None
           or getattr(x_leaf, "dtype", None) == jnp.int8)
          and block_center is None
          and not callable(metric)
          and grouped_kernel_ok(x_leaf, metric, tile_m)
          and jax.default_backend() == "gpu")
    if impl == "kernel" and not ok:
        raise ValueError(
            "impl='kernel' needs a GPU backend, dense f32/bf16/int8 "
            "blocks (not centered), l2/sql2, and a power-of-two "
            "tile_m >= 16; use impl='auto' to fall back silently")
    return ok


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "probes", "metric", "dedup",
                     "precision", "tile_m", "nt", "tile_chunk",
                     "bucket_stop", "min_votes", "sub", "selection",
                     "impl"),
)
def _knn_grouped(plan, arrays, x_leaf, sq_leaf, id_leaf, lens_global, q, k,
                 budget, probes, metric, dedup, precision, tile_m, nt,
                 tile_chunk, bucket_stop=False, min_votes=1,
                 block_scale=None, block_center=None, sub=1,
                 selection="sort", impl="auto", tabs=None):
    """Query-grouped block-resident rerank (see :mod:`..ops.grouped`):
    semantically :func:`_knn_packed`, restructured so each distinct probed
    block is fetched once per TILE of queries and scored with one tile
    dot -- the win grows with probe overlap (clustered data, large
    batches).  The selection tail (block-gathered ids, payload-carrying
    sort, top-k merge) is the per-pair path's, unchanged.  Returns
    ``(dists, ids, needed_tiles)``; exact iff ``needed_tiles <= nt``
    (the caller retries with a bigger capacity)."""
    from ..ops.grouped import grouped_distances, grouped_distances_kernel

    gsel, lsel = _select_probes(plan, arrays, q, budget, probes, k=k,
                                bucket_stop=bucket_stop,
                                block_len=None if sub > 1 else lens_global,
                                tabs=tabs)
    if sub > 1:
        gsel, lsel = _expand_sub_probes(gsel, lsel, sub)
    b, p = gsel.shape
    lmax = x_leaf.shape[-2]
    t = arrays.perm.shape[0]
    kk = k * t if dedup else k
    if _grouped_use_kernel(impl, x_leaf, metric, block_scale,
                           block_center, tile_m):
        d, needed = grouped_distances_kernel(
            x_leaf, sq_leaf, lens_global, gsel, lsel, q, metric,
            _prec(precision), tile_m, nt, block_scale=block_scale)
    else:
        d, needed = grouped_distances(
            x_leaf, sq_leaf, lens_global, gsel, lsel, q, metric,
            _prec(precision), tile_m, nt, tile_chunk,
            block_scale=block_scale, block_center=block_center)
    # selection tail shared with _score_blocks
    d_out, i_out = _selection_tail(d.reshape(b, p * lmax), id_leaf, gsel,
                                   k, kk, dedup, min_votes=min_votes,
                                   selection=selection)
    return d_out, i_out, needed


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "probes", "metric", "dedup",
                     "precision", "tile_m", "nt", "tile_chunk",
                     "bucket_stop", "min_votes", "sub", "selection",
                     "impl", "chunk"),
)
def _knn_grouped_many(plan, arrays, x_leaf, sq_leaf, id_leaf, lens_global,
                      q, k, budget, probes, metric, dedup, precision,
                      tile_m, nt, tile_chunk, chunk, bucket_stop=False,
                      min_votes=1, block_scale=None, block_center=None,
                      sub=1, selection="sort", impl="auto"):
    """One-dispatch chunked grouped batch (the grouped form of
    :func:`_knn_packed_many`): ``lax.map`` over query chunks of the
    query-grouped pipeline.  ``nt`` is the PER-CHUNK tile capacity:
    chunking bounds the per-chunk buffers and amortizes the host
    dispatch over the whole batch (see ``examples/serving_loop.py``).
    Returned ``needed`` is the max over chunks."""
    is_ellq = isinstance(q, EllMatrix)
    if is_ellq:
        # sparse-QUERY batch: densify one [chunk, dim] strip per map
        # step (see _knn_packed_many_ellq -- same innerSS-at-scale
        # rationale; [B, dim] never materializes)
        b = q.cols.shape[0]
        nc = b // chunk
        qc = (q.cols.reshape(nc, chunk, q.cols.shape[-1]),
              q.vals.reshape(nc, chunk, q.vals.shape[-1]))
        dim = q.dim
    else:
        b = q.shape[0]
        nc = b // chunk
        qc = q.reshape(nc, chunk, q.shape[-1])
    # budget=1 superlevel tables: built ONCE here; the chunk body closes
    # over them, so lax.map carries them as loop constants
    tabs = _b1_forest_tables(plan, arrays, budget)

    def one(qi):
        if is_ellq:
            ci, vi = qi
            qi = jnp.zeros((chunk, dim), jnp.float32).at[
                jnp.arange(chunk)[:, None], ci.astype(jnp.int32)
            ].add(vi.astype(jnp.float32))
        return _knn_grouped(plan, arrays, x_leaf, sq_leaf, id_leaf,
                            lens_global, qi, k, budget, probes, metric,
                            dedup, precision, tile_m, nt, tile_chunk,
                            bucket_stop=bucket_stop, min_votes=min_votes,
                            block_scale=block_scale,
                            block_center=block_center, sub=sub,
                            selection=selection, impl=impl, tabs=tabs)

    d, ids, needed = lax.map(one, qc)
    return d.reshape(b, -1), ids.reshape(b, -1), jnp.max(needed)


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "probes", "metric", "dedup",
                     "precision", "bucket_stop", "min_votes", "chunk",
                     "sub", "selection"),
)
def _knn_packed_many(plan, arrays, x_leaf, sq_leaf, id_leaf, q, k, budget,
                     probes, metric, dedup, precision, bucket_stop,
                     min_votes, block_scale, block_len, chunk,
                     block_center=None, sub=1, selection="sort"):
    """One-dispatch chunked batch query: ``lax.map`` over query chunks of
    the packed kNN pipeline.  Peak memory stays per-chunk (the rerank
    buffers are reused across iterations) while the host pays ONE
    dispatch for the whole batch -- in dispatch-bound environments this
    recovers most of the device/wall gap (bench.py reports both)."""
    b = q.shape[0]
    nc = b // chunk
    qc = q.reshape(nc, chunk, q.shape[-1])
    tabs = _b1_forest_tables(plan, arrays, budget)

    def one(qi):
        return _knn_packed(plan, arrays, x_leaf, sq_leaf, id_leaf, qi, k,
                           budget, probes, metric, dedup, precision,
                           bucket_stop=bucket_stop, min_votes=min_votes,
                           block_scale=block_scale, block_len=block_len,
                           block_center=block_center, sub=sub,
                           selection=selection, tabs=tabs)

    d, ids = lax.map(one, qc)
    return d.reshape(b, -1), ids.reshape(b, -1)


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "probes", "metric", "dedup",
                     "precision", "bucket_stop", "min_votes", "chunk",
                     "sub", "selection", "dim"),
)
def _knn_packed_many_ellq(plan, arrays, x_leaf, sq_leaf, id_leaf, qcols,
                          qvals, dim, k, budget, probes, metric, dedup,
                          precision, bucket_stop, min_votes, block_scale,
                          block_len, chunk, block_center=None, sub=1,
                          selection="sort"):
    """Sparse-QUERY form of :func:`_knn_packed_many`: the query batch
    arrives as padded-ELL tables ``(qcols, qvals) [B, Kq]`` and each
    ``lax.map`` chunk densifies only its own ``[chunk, dim]`` strip
    inside the program -- a giant sparse batch at vocab-scale ``dim``
    never materializes ``[B, dim]`` anywhere (B=512k x 65536-d would be
    128 GB dense; per-chunk it is chunk x dim).  The reference's
    ``innerSS`` query regime (``Internal.hs:100-119``: queries are
    SVectors too) at accelerator batch scale; everything downstream of
    the densified strip is the dense-query pipeline."""
    b = qcols.shape[0]
    nc = b // chunk
    qcc = qcols.reshape(nc, chunk, qcols.shape[-1])
    qvc = qvals.reshape(nc, chunk, qvals.shape[-1])
    tabs = _b1_forest_tables(plan, arrays, budget)

    def one(args):
        ci, vi = args
        # padded slots are (col 0, val 0): the scatter-add contributes 0
        qi = jnp.zeros((chunk, dim), jnp.float32).at[
            jnp.arange(chunk)[:, None], ci.astype(jnp.int32)
        ].add(vi.astype(jnp.float32))
        return _knn_packed(plan, arrays, x_leaf, sq_leaf, id_leaf, qi, k,
                           budget, probes, metric, dedup, precision,
                           bucket_stop=bucket_stop, min_votes=min_votes,
                           block_scale=block_scale, block_len=block_len,
                           block_center=block_center, sub=sub,
                           selection=selection, tabs=tabs)

    d, ids = lax.map(one, (qcc, qvc))
    return d.reshape(b, -1), ids.reshape(b, -1)


@functools.partial(jax.jit, static_argnames=("plan", "budget", "k"))
def _knn_h_ids_packed(plan, arrays, id_leaf, q, k, budget, block_len,
                      row_of=None):
    """:func:`_knn_h_ids` over the PACKED id blocks with dynamic
    occupancies -- the folded-aware form: fold-appended rows live only in
    the packed blocks' slack slots, so the knnH bucket contract after
    :meth:`RPForest.fold` must read ``id_leaf`` (which holds them) and
    ``block_len`` (which counts them toward the cumulative stop rule).
    ``row_of int32[G]`` maps global block id to storage row for layouts
    that reorder blocks (the leaf-sharded round-robin pack)."""
    t = arrays.perm.shape[0]
    b = q.shape[0]
    gsel, lsel = _select_probes(plan, arrays, q, budget, t * budget, k=k,
                                bucket_stop=True, block_len=block_len)
    rows_sel = gsel if row_of is None else jnp.take(row_of, gsel)
    ids_blk = jnp.take(id_leaf, rows_sel, axis=0)  # [B, P, lmax]
    lens = jnp.take(block_len, gsel)
    lmax = id_leaf.shape[-1]
    valid = (lsel >= 0)[..., None] & (
        jnp.arange(lmax, dtype=jnp.int32) < lens[..., None]
    )
    return jnp.where(valid, ids_blk, -1).reshape(b, -1)


@functools.partial(
    jax.jit,
    static_argnames=("plan", "budget", "k", "metric", "dedup", "precision"),
)
def _knn_h(plan, arrays, x, sq_norms, q, k, budget, metric, dedup,
           precision="highest"):
    """Margin-priority variant (reference ``knnH``, RPTree.hs:196-217):
    across all trees, leaf buckets are consumed in ascending margin-priority
    order until at least k points are collected; only those buckets enter
    the exact rerank.  (The reference returns the selected buckets unsorted
    and untruncated; here they are reranked and truncated to k.)"""
    ids = _knn_h_ids(plan, arrays, q, k, budget)
    return rerank_top_k(x, sq_norms, q, ids, k, metric=metric, dedup=dedup,
                        precision=_prec(precision))


@functools.partial(jax.jit, static_argnames=("plan",))
def _descend(plan, arrays, xnew):
    """Leaf each point reaches by pure threshold descent (the placement
    step of the reference's ``insert``, ``Internal.hs:270-276``, without
    the chunk re-split): ``proj < thr -> left, else right`` -- the same
    primary side the query traversal follows, so a folded point is always
    findable by a query at its location.  Returns ``int32[T, M]``."""
    nl = plan.n_levels
    t = arrays.perm.shape[0]
    if nl == 0:
        return jnp.zeros((t, xnew.shape[0]), jnp.int32)
    proj = jnp.einsum("md,tld->tml", xnew, arrays.r[:, :nl],
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    # profiler region named after the reference's {-# SCC insert #-} /
    # {-# SCC insertMulti #-} (Internal.hs:244,257): the placement
    # descent is the device-side share of fold()'s insert path
    with jax.named_scope("rpt_insert"):
        child = plan.padded_child_table()
        smax = child.shape[1]
        m = xnew.shape[0]
        code = jnp.zeros((t, m), jnp.int32)
        leaf = jnp.full((t, m), -1, jnp.int32)
        for l in range(nl):
            my_thr = jnp.take_along_axis(arrays.thr[:, l, :], code, axis=1)
            live = leaf < 0
            side = (proj[:, :, l] >= my_thr).astype(jnp.int32)
            nxt = jnp.asarray(child[l])[jnp.clip(code, 0, smax - 1), side]
            leaf = jnp.where(live & (nxt < 0), -(nxt + 1), leaf)
            code = jnp.where(live & (nxt >= 0), nxt, code)
        return leaf


@jax.jit
def _pack_shared_tables(perm, sq_norms, pos, in_leaf):
    """Per-block slot -> point-id and squared-norm tables for the
    shared-row layout (``pack_leaves(store="shared")``): the blocked
    pack's ``ids``/``sq`` WITHOUT the row blocks -- the dataset array
    itself is the (single, shared) row store.  ``pos``/``in_leaf`` ride
    as arguments for the same reason as :func:`_pack_dense_blocks`."""

    def per_tree(perm_t):
        ids = jnp.take(perm_t, pos)  # [n_leaves, lmax]
        sq = jnp.where(in_leaf, jnp.take(sq_norms, ids), 0.0)
        return jnp.where(in_leaf, ids, -1), sq

    return jax.vmap(per_tree)(perm)


@functools.partial(jax.jit,
                   static_argnames=("dtype_str", "centered", "sub",
                                    "sub_split"))
def _pack_dense_blocks(perm, x, pos, in_leaf, dtype_str, centered,
                       sub=1, r_sub=None, in_sub=None, sub_split="proj"):
    """Leaf-blocked packing, one ``lax.map`` step per tree so the f32
    gather/quantization intermediates are a single tree's blocks (~1/T of
    the index), not the whole forest's -- an eager per-op pack of int8
    blocks at 1M points materializes three full-forest f32 copies and
    OOMs a 16 GB device.  ``pos``/``in_leaf`` are passed as ARGUMENTS
    (big constants would be embedded in the compiled program).

    ``sub > 1`` splits every leaf into ``sub`` SUB-BLOCKS of
    ``lmax/sub`` slots, with the leaf's rows reordered by projection
    onto ``r_sub`` first so each sub-block is a spatially coherent slice
    -- quantization state (int8 scales, centered means) then lives at
    sub-block granularity, which is what rescues centered int8 on leaves
    that straddle clusters.  ``in_sub`` is the validity mask at sub
    granularity ``[n_leaves*sub, lmax/sub]``."""

    def per_tree(perm_t):
        ids = jnp.take(perm_t, pos)  # [n_leaves, lmax]
        rows = jnp.take(x, ids, axis=0)
        rows = jnp.where(in_leaf[..., None], rows, 0.0)
        ids = jnp.where(in_leaf, ids, -1)
        if sub > 1:
            # spatial order within the leaf (invalid slots key +inf ->
            # they stay a contiguous tail, so sub-block occupancy remains
            # a static prefix): balanced recursive 2-means when asked
            # (boundary-adaptive centers; sub must be a power of two),
            # else the 1-D projection sort
            if sub_split == "kmeans":
                order = _sub_order_kmeans(rows, in_leaf, r_sub, sub)
            else:
                key = jnp.where(in_leaf, rows @ r_sub, jnp.inf)
                order = jnp.argsort(key, axis=-1)
            ids = jnp.take_along_axis(ids, order, axis=-1)
            rows = jnp.take_along_axis(rows, order[..., None], axis=-2)
            nl, lmax = in_leaf.shape
            d = rows.shape[-1]
            rows = rows.reshape(nl * sub, lmax // sub, d)
            ids = ids.reshape(nl * sub, lmax // sub)
            ids = jnp.where(in_sub, ids, -1)
            rows = jnp.where(in_sub[..., None], rows, 0.0)
            valid = in_sub
        else:
            valid = in_leaf
        sq = jnp.sum(rows * rows, axis=-1)  # f32, before any downcast
        if dtype_str == "int8" and centered:
            q, scale, mu, mudr = _center_quantize(rows, valid)
            return q, sq, ids, scale.reshape(-1), mu, mudr
        if dtype_str == "int8":
            amax = jnp.max(jnp.abs(rows), axis=(-2, -1), keepdims=True)
            scale = jnp.maximum(amax, 1e-30) / 127.0  # per (sub-)block
            q = jnp.clip(jnp.round(rows / scale), -127, 127
                         ).astype(jnp.int8)
            return q, sq, ids, scale.reshape(-1)
        if dtype_str == "bf16":
            return rows.astype(jnp.bfloat16), sq, ids
        return rows, sq, ids

    return lax.map(per_tree, perm)


@jax.jit
def _scatter_fold(x_leaf, sq_leaf, id_leaf, g, s, rows, sq, ids):
    """Write folded rows into block slack slots: ``g/s int32[T*M]`` block
    row / slot, ``rows f32[T*M, D]``, ``ids int32[T*M]``."""
    x_leaf = x_leaf.at[g, s].set(rows.astype(x_leaf.dtype))
    sq_leaf = sq_leaf.at[g, s].set(sq)
    id_leaf = id_leaf.at[g, s].set(ids)
    return x_leaf, sq_leaf, id_leaf


@jax.jit
def _scatter_fold_ell(cols, vals, sq_leaf, id_leaf, g, s, rcols, rvals,
                      sq, ids):
    """ELL-blocks form of :func:`_scatter_fold`: folded rows arrive as
    padded (cols, vals) slot lists (``[T*M, K]``); padding slots keep the
    col=0/val=0 convention so scoring ignores them."""
    cols = cols.at[g, s].set(rcols)
    vals = vals.at[g, s].set(rvals.astype(vals.dtype))
    sq_leaf = sq_leaf.at[g, s].set(sq)
    id_leaf = id_leaf.at[g, s].set(ids)
    return cols, vals, sq_leaf, id_leaf


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "precision", "chunk")
)
def _brute_force_many(x, sq_norms, q, k, metric, precision, chunk):
    """One-dispatch chunked brute force: ``lax.map`` over query chunks of
    the streaming scan (same recipe as :func:`_knn_packed_many`)."""
    b = q.shape[0]
    qc = q.reshape(b // chunk, chunk, q.shape[-1])
    d, ids = lax.map(
        lambda qi: _brute_force(x, sq_norms, qi, k, metric, precision), qc
    )
    return d.reshape(b, -1), ids.reshape(b, -1)


@functools.partial(jax.jit, static_argnames=("k", "metric", "precision"))
def _brute_force(x, sq_norms, q, k, metric, precision="highest"):
    """Exact k nearest neighbours over the whole dataset (the ground truth
    of ``recallWith``, RPTree.hs:280-282).

    Dense datasets stream in row chunks via ``lax.scan`` with a running
    top-k merge, so peak memory is O(B * chunk) instead of the O(B * n)
    distance matrix (which at 1M points x 2k queries would be 8 GB); each
    chunk is one distance GEMM.  ELL-sparse datasets use the
    single-pass gather form (their n is bounded by the padded-ELL memory
    anyway).
    """
    if callable(metric) and isinstance(x, EllMatrix):
        raise NotImplementedError(
            "custom distance callables need dense data rows"
        )
    if isinstance(x, EllMatrix):
        # scan over row chunks: the one-shot gather form materializes
        # [B, n, K] (tens of GB at bag-of-words scale)
        n, kz = x.cols.shape
        b = q.shape[0]
        c = max(1, min(n, (8 * 1024 * 1024) // max(b * kz, 1)))
        n_chunks = -(-n // c)
        pad = n_chunks * c - n
        cols, vals, sqn = x.cols, x.vals, sq_norms
        if pad:
            cols = jnp.concatenate([cols, jnp.zeros((pad, kz), cols.dtype)])
            vals = jnp.concatenate([vals, jnp.zeros((pad, kz), vals.dtype)])
            sqn = jnp.concatenate([sqn, jnp.full((pad,), jnp.inf, sqn.dtype)])
        k = min(k, n)

        def step(carry, chunk):
            bd, bi = carry
            ci, vi, sqi, base = chunk
            qg = jnp.take_along_axis(
                q[:, None, :],
                jnp.broadcast_to(ci, (b,) + ci.shape).astype(jnp.int32),
                axis=-1,
            )  # [B, c, K]
            dots = jnp.einsum("ck,bck->bc", vi, qg)
            d = _dist_from_dots_full(dots, sqi, q, metric)
            ids = base + jnp.arange(c, dtype=jnp.int32)[None, :]
            alld = jnp.concatenate([bd, d], axis=-1)
            alli = jnp.concatenate(
                [bi, jnp.broadcast_to(ids, d.shape)], axis=-1
            )
            neg, sel = jax.lax.top_k(-alld, k)
            return (-neg, jnp.take_along_axis(alli, sel, axis=-1)), None

        bd0 = jnp.full((b, k), jnp.inf, jnp.float32)
        bi0 = jnp.full((b, k), -1, jnp.int32)
        (bd, bi), _ = lax.scan(
            step, (bd0, bi0),
            (cols.reshape(n_chunks, c, kz), vals.reshape(n_chunks, c, kz),
             sqn.reshape(n_chunks, c),
             jnp.arange(n_chunks, dtype=jnp.int32) * c),
        )
        return bd, bi

    n, b = x.shape[0], q.shape[0]
    fast = precision in ("default", "fastest") and not callable(metric)
    # chunk size: bound the [B, C] distance tile to ~32M floats
    c = max(1, min(n, (32 * 1024 * 1024) // max(b, 1)))
    c = max(128, c - c % 128) if n >= 128 else n
    n_chunks = -(-n // c)
    pad = n_chunks * c - n
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad, x.shape[1]), x.dtype)])
        sq_norms = jnp.concatenate(
            [sq_norms, jnp.full((pad,), jnp.inf, sq_norms.dtype)]
        )
    if fast:
        # an explicit bf16 cast of the tiles halves the scan's bytes and
        # takes the bf16 matmul rate; distances still accumulate in f32
        x = x.astype(jnp.bfloat16)
    xc = x.reshape(n_chunks, c, x.shape[1])
    sqc = sq_norms.reshape(n_chunks, c)
    k = min(k, n)
    use_approx = fast and metric in ("l2", "sql2", "dot") and k <= 128

    def step(carry, chunk):
        bd, bi = carry
        xi, sqi, base = chunk
        if callable(metric):
            # user distf (RPTree.hs:168) over the row chunk; padded rows
            # are masked to +inf below via their +inf squared norm
            d = metric(xi[None, :, :], q[:, None, :])
            d = jnp.where(jnp.isinf(sqi)[None, :], jnp.inf, d)
        else:
            dots = jnp.einsum("bd,nd->bn", q.astype(xi.dtype), xi,
                              preferred_element_type=jnp.float32,
                              precision=_prec(precision))
            d = _dist_from_dots_full(dots, sqi, q, metric)
            # padded rows carry sq=+inf; l2 distances inherit that, but
            # dot (-0.0) and cosine (1.0) would not -- mask explicitly
            d = jnp.where(jnp.isinf(sqi)[None, :], jnp.inf, d)
        ids = base + jnp.arange(c, dtype=jnp.int32)[None, :]
        if use_approx:
            # approximate per-tile selection, then an EXACT 2k merge-sort
            # with the running best (the 0.99 per-tile recall target loses
            # a true neighbour only when it is near-tied at the tile's kth
            # rank)
            neg, sel = lax.approx_max_k(-d, k, recall_target=0.99)
            dt_, it_ = -neg, jnp.take_along_axis(
                jnp.broadcast_to(ids, d.shape), sel, axis=-1)
            md, mi = lax.sort((jnp.concatenate([bd, dt_], axis=-1),
                               jnp.concatenate([bi, it_], axis=-1)),
                              num_keys=1)
            return (md[:, :k], mi[:, :k]), None
        alld = jnp.concatenate([bd, d], axis=-1)
        alli = jnp.concatenate([bi, jnp.broadcast_to(ids, d.shape)], axis=-1)
        neg, sel = jax.lax.top_k(-alld, k)
        return (-neg, jnp.take_along_axis(alli, sel, axis=-1)), None

    bd0 = jnp.full((b, k), jnp.inf, jnp.float32)
    bi0 = jnp.full((b, k), -1, jnp.int32)
    bases = (jnp.arange(n_chunks, dtype=jnp.int32) * c)
    (bd, bi), _ = lax.scan(step, (bd0, bi0), (xc, sqc, bases))
    return bd, bi


def _dist_from_dots_full(dots, sq_norms, q, metric):
    """Distance from dots against a [C]-row chunk (brute-force helper)."""
    if metric in ("l2", "sql2"):
        d = jnp.maximum(
            sq_norms[None, :] - 2.0 * dots + jnp.sum(q * q, -1)[:, None], 0.0
        )
        return jnp.sqrt(d) if metric == "l2" else d
    if metric == "cosine":
        nq = jnp.sqrt(jnp.sum(q * q, -1))[:, None]
        return 1.0 - dots / jnp.maximum(
            jnp.sqrt(sq_norms)[None, :] * nq, 1e-30
        )
    if metric == "dot":
        return -dots
    raise ValueError(metric)


@functools.partial(jax.jit, static_argnames=("plan", "budget", "k", "metric"))
def _recall(plan, arrays, x, sq_norms, q, k, budget, metric):
    """Mean recall@k over trees (reference ``recallWith``, RPTree.hs:259-268):
    per tree, |candidates(q) . exact top-k| / k, averaged over the forest."""
    _, exact_ids = _brute_force(x, sq_norms, q, k, metric)  # [B, k]
    cand = _candidate_ids(plan, arrays, q, budget)  # [T, B, C]
    hit = (exact_ids[None, :, :, None] == cand[:, :, None, :]) & (
        cand[:, :, None, :] >= 0
    )
    found = jnp.any(hit, axis=-1)  # [T, B, k]
    return jnp.mean(jnp.sum(found, axis=-1).astype(jnp.float32) / k, axis=0)  # [B]


@functools.partial(jax.jit,
                   static_argnames=("plan", "budget", "k", "n_base"))
def _recall_folded(plan, arrays, q, k, budget, exact_ids,
                   folded_leaf, n_base):
    """:func:`_recall` over a folded forest: the ground truth
    (``exact_ids``, computed by the folded-aware brute force) includes
    fold-appended rows (ids >= ``n_base``), whose per-tree candidacy is
    decided by leaf membership -- a folded row (living only in the packed
    blocks) is a tree's candidate iff its assigned leaf
    (``folded_leaf int32[T, M]``, recorded at fold time) is among the
    traversal's selected leaves, exactly when the packed query path would
    rerank it."""
    cand = _candidate_ids(plan, arrays, q, budget)  # [T, B, C]
    hit = (exact_ids[None, :, :, None] == cand[:, :, None, :]) & (
        cand[:, :, None, :] >= 0
    )
    found = jnp.any(hit, axis=-1)  # [T, B, k]
    leaf_sel, _ = _traverse_forest(plan, arrays, q, budget)  # [T, B, F]
    m = folded_leaf.shape[1]
    fidx = jnp.clip(exact_ids - n_base, 0, max(m - 1, 0))  # [B, k]
    fleaf = jnp.take(folded_leaf, fidx, axis=1)  # [T, B, k]
    found_f = jnp.any(
        leaf_sel[:, :, None, :] == fleaf[:, :, :, None], axis=-1
    )  # [T, B, k]
    found = jnp.where((exact_ids >= n_base)[None], found_f, found)
    return jnp.mean(jnp.sum(found, axis=-1).astype(jnp.float32) / k, axis=0)


# ---------------------------------------------------------------------------
# the index handle
# ---------------------------------------------------------------------------

class RPForest:
    """A built RP forest index over a fixed dataset.

    Attributes:
      plan: static tree shape (shared by all trees).
      arrays: :class:`TreeArrays` with leading ``[T]`` axis.
      x: the indexed dataset on device (dense ``[n, D]`` or ELL sparse).
      sq_norms: ``f32[n]`` squared norms (for factored L2 distances).
      payloads: optional host-side sequence of opaque per-point payloads
        (the reference's ``Embed.eData``; row ids key into it).
    """

    def __init__(self, plan: TreePlan, arrays: TreeArrays, x, sq_norms,
                 config: ForestConfig, payloads: Optional[Sequence] = None,
                 seed: Optional[int] = None):
        self.plan = plan
        self.arrays = arrays
        self.x = x
        self.sq_norms = sq_norms
        self.config = config
        self.payloads = payloads
        self.seed = seed
        self._packed = None  # leaf-blocked arrays (pack_leaves) or None
        self._block_center = None  # (mu, mu.r) of centered int8 blocks
        self._sub_block = 1        # sub-blocks per leaf (pack_leaves)
        self._sub_len_dev = None   # int32[G*sub] sub-block occupancy
        self._pending = []   # freshness buffer chunks (add/rebuild)
        self._pending_payloads = []
        self._deleted = None  # bool[n] tombstones (remove/rebuild) or None
        self._pending_deleted = None  # set of deleted pending-buffer offsets
        self._block_len = None      # int32[G] dynamic occupancy (fold)
        self._block_len_dev = None  # device copy of the above
        self._folded_x = []         # folded-in rows (for rebuild/payloads)
        self._folded_leaf = []      # per-tree leaf of each folded row
        self._folded_payloads = []
        self._folded_cat = None     # cached (n_folded, x, sq) concatenation
        self._pack_slack = 0

    # -- basic accessors (reference Internal.hs:198-208, RPTree.hs:351-367) --

    @property
    def n_trees(self) -> int:
        return int(self.arrays.perm.shape[0])

    @property
    def n_points(self) -> int:
        return self.plan.n

    @property
    def dim(self) -> int:
        if self.x is None:
            blocks = self._packed[0]
            if isinstance(blocks, EllBlocks):
                return blocks.dim  # slot width is K (nnz), not the dim
            return int(blocks.shape[-1])
        return self.x.dim if isinstance(self.x, EllMatrix) else int(self.x.shape[1])

    def levels(self) -> int:
        """Number of projection levels (= length of rvs in the reference,
        ``Internal.hs:203-204``)."""
        return int(self.arrays.r.shape[1])

    def tree_size(self, t: int = 0) -> int:
        """Points stored in tree ``t`` (reference ``treeSize``); the
        completeness invariant says this equals ``n`` for every tree."""
        del t
        return self.plan.n

    def leaf_sizes(self) -> np.ndarray:
        """Per-leaf occupancy (reference ``leafSizes``); identical across
        trees since the shape is static."""
        return np.asarray(self.plan.leaf_len)

    def tree_stats(self) -> dict:
        """Node counts (reference ``treeStats``, which reports the number of
        leaves -- ``length`` over the leaf-data Foldable)."""
        return {
            "n_leaves": self.plan.n_leaves,
            "n_branches": self.plan.n_branches,
            "n_levels": self.plan.n_levels,
            "max_leaf_len": self.plan.max_leaf_len,
        }

    def leaves(self, t: int = 0) -> list:
        """Leaf buckets of tree ``t`` as lists of point ids (reference
        ``leaves``, Internal.hs:199-200)."""
        perm = np.asarray(self.arrays.perm[t])
        return [
            perm[s : s + m].tolist()
            for s, m in zip(self.plan.leaf_start, self.plan.leaf_len)
        ]

    def _points_raw(self) -> np.ndarray:
        """The originally indexed rows only (no fold-appended rows)."""
        if isinstance(self.x, EllMatrix):
            return np.asarray(ell_to_dense(self.x))
        return np.asarray(self.x)

    def points(self) -> np.ndarray:
        """The indexed dataset, densified (reference ``points``), including
        rows appended online by :meth:`fold` (their ids continue after the
        original rows, so ``points()[i]`` matches returned id ``i``)."""
        raw = self._points_raw()
        if self.n_folded:
            return np.concatenate([raw] + list(self._folded_x), axis=0)
        return raw

    def _merge_folded(self, qb, d, ids, k, metric, precision):
        """Merge an exact scan of the fold-appended rows (small dense
        host-side copies) into a (dists, ids) result -- for datasets whose
        sparse or sharded storage cannot be concatenated with the dense
        folded rows.  Folded ids continue after the indexed points."""
        xf = jnp.concatenate(
            [jnp.asarray(c) for c in self._folded_x], axis=0)
        sqf = jnp.sum(xf * xf, axis=-1)
        kf = min(int(k), int(xf.shape[0]))
        df, idf = _brute_force(xf, sqf, qb, kf, metric, precision)
        idf = jnp.where(idf >= 0, idf + self.plan.n, -1)
        return merge_top_k(jnp.concatenate([d, df], axis=-1),
                           jnp.concatenate([ids, idf], axis=-1), k,
                           dedup=False)

    def _with_folded(self):
        """Dataset + squared norms including fold-appended rows -- what the
        exact scan / recall ground truth must cover so the oracle agrees
        with the index contents after :meth:`fold` (folded ids continue
        after the indexed points, matching the packed blocks' ids).
        Dense datasets only; sparse/sharded callers use
        :meth:`_merge_folded` instead."""
        if not self.n_folded:
            return self.x, self.sq_norms
        nf = self.n_folded
        cache = getattr(self, "_folded_cat", None)
        if cache is not None and cache[0] == nf:
            return cache[1], cache[2]
        xf = jnp.concatenate(
            [self.x] + [jnp.asarray(c) for c in self._folded_x], axis=0)
        sqf = jnp.sum(xf * xf, axis=-1)
        self._folded_cat = (nf, xf, sqf)
        return xf, sqf

    # -- queries -------------------------------------------------------------

    def _budget(self, budget: Optional[int]) -> int:
        if budget is None:
            budget = min(self.plan.n_leaves, DEFAULT_BUDGET)
        return max(1, min(int(budget), self.plan.n_leaves))

    @staticmethod
    def _check_k(k) -> int:
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return k

    def _validate_pack_args(self, dtype, slack, centered, sub_block,
                            sub_split, store: str = "blocks") -> None:
        """Reject invalid pack-layout requests BEFORE any state changes
        (shared by every packer).  Ordering matters: a repack first drops
        the old layout, so argument errors must fire while it is still
        intact -- an invalid call must never destroy the serving state."""
        s = int(sub_block) if sub_block else 1
        if store not in ("blocks", "shared"):
            raise ValueError(f"store must be 'blocks' or 'shared', "
                             f"got {store!r}")
        if store == "shared":
            if isinstance(self.x, EllMatrix):
                raise ValueError("store='shared' applies to dense "
                                 "datasets (ELL rows already pack by "
                                 "value)")
            if slack:
                raise ValueError("store='shared' keeps no row blocks for "
                                 "fold() to write into; slack requires "
                                 "the blocked layout")
            if s > 1:
                raise ValueError("sub_block quantization state requires "
                                 "the blocked layout (store='blocks')")
            if centered or (dtype is not None
                            and jnp.dtype(dtype) == jnp.int8):
                raise ValueError("quantized blocks require the blocked "
                                 "layout (store='blocks'); shared rows "
                                 "serve the dataset's own f32/bf16 rows")
        if isinstance(self.x, EllMatrix):
            if centered:
                raise ValueError("centered quantization applies to dense "
                                 "blocks only")
            if s > 1:
                raise ValueError("sub_block applies to dense blocks only")
            if dtype is not None and jnp.dtype(dtype) == jnp.int8:
                raise ValueError("int8 quantization applies to dense "
                                 "blocks; ELL blocks pack f32/bf16 "
                                 "values")
        else:
            if s > 1 and slack:
                raise ValueError("sub_block and slack are mutually "
                                 "exclusive (fold() addresses whole-leaf "
                                 "blocks)")
            if centered and (dtype is None
                             or jnp.dtype(dtype) != jnp.int8):
                raise ValueError("centered=True applies to int8 blocks "
                                 "(pass dtype=jnp.int8)")
            _dtype_str(dtype)  # rejects unsupported block dtypes
        _sub_split_of(sub_split, s)  # rejects unknown ordering modes

    def _same_pack(self, dtype, slack, centered, sub_block,
                   sub_split, shard_by=None, store: str = "blocks") -> bool:
        """Whether the requested pack layout matches the one in place
        (``_pack_cfg`` + slack + sharded mode) -- the idempotent-no-op
        test shared by every packer.  Only layout-RELEVANT fields
        compare: at ``sub_block=1`` the ``sub_split`` mode has no effect
        on the blocks, so it is canonicalized away."""
        s_req = int(sub_block) if sub_block else 1
        if isinstance(self.x, EllMatrix):
            want = {"dtype": (jnp.bfloat16 if dtype is not None
                              and jnp.dtype(dtype) == jnp.bfloat16
                              else None)}
        elif store == "shared":
            want = {"dtype": _DTYPE_OF[_dtype_str(dtype)],
                    "store": "shared"}
        else:
            want = {"dtype": _DTYPE_OF[_dtype_str(dtype)],
                    "centered": bool(centered), "sub_block": s_req,
                    "sub_split": (_sub_split_of(sub_split, s_req)
                                  if s_req > 1 else None)}
        have = getattr(self, "_pack_cfg", None)
        if have is not None and "sub_split" in have:
            have = dict(have)
            if have.get("sub_block", 1) == 1:
                have["sub_split"] = None
        mode_ok = (shard_by is None
                   or getattr(self, "_packed_mode", None) == shard_by)
        return (mode_ok and have == want
                and getattr(self, "_pack_slack", 0) == int(slack))

    def _clear_pack_for_repack(self) -> None:
        """Drop the packed serving layout so :meth:`pack_leaves` can build
        a different one.  Folded rows block the repack (they live only in
        the packed blocks' slack slots; the dataset alone cannot
        reproduce them) and a serve-only forest has nothing to repack
        from."""
        if self.x is None:
            raise ValueError("cannot repack a serve-only forest "
                             "(drop_dataset was called); the packed "
                             "blocks are the only copy of the data")
        if self.n_folded or self._block_len is not None:
            raise ValueError("cannot repack with folded rows in the "
                             "blocks (they live only in the packed slack "
                             "slots); rebuild() first")
        self._packed = None
        self._packed_mode = None
        self._small = None
        self._block_scale = None
        self._block_center = None
        self._sub_block = 1
        self._sub_len_dev = None
        self._sub_len_rows_dev = None
        self._lens_global_dev = None
        self._shared_all_probes = False
        self._shared_len_loc = None
        # learned tile capacities are a function of the layout (sub
        # multiplies the pair count); stale entries would silently mask
        # pairs under check=False
        self._grouped_nt = {}

    def pack_leaves(self, dtype=None, slack: int = 0,
                    centered: bool = False,
                    sub_block: int = 1,
                    sub_split: str = "kmeans",
                    store: str = "blocks") -> "RPForest":
        """Precompute leaf-blocked copies of the dataset: ``x_leaf
        [T * n_leaves, lmax * D]`` holds each leaf's points contiguously
        (zero-padded to the max leaf size), ``id_leaf [T * n_leaves * lmax]``
        the corresponding point ids.  Serving-path optimization (~T x
        dataset bytes of extra HBM) that turns the rerank's per-point
        gathers into per-leaf block gathers; see :func:`_knn_packed`.
        Dense datasets only; no-op for sparse (ELL) data.

        ``dtype=jnp.bfloat16`` halves the blocks' HBM footprint and fetch
        bytes; candidate distances are then computed from bf16 coordinates
        (~1e-2 relative error -- reranking of near-ties may flip, recall
        statistics do not; exact distances are still reported from the
        same bf16 rows).  Default keeps the dataset dtype.

        ``slack > 0`` reserves that many EMPTY slots per leaf block for
        :meth:`fold` (amortized online inserts without rebuild).

        ``centered=True`` (int8 only) quantizes RESIDUALS around each
        block's mean row instead of raw coordinates: the block mean stays
        f32 (plus a precomputed per-slot ``mean . residual`` term), so the
        quantization step shrinks by the block's center-to-spread ratio.
        On clustered data -- where in-cluster neighbours are
        near-equidistant and plain int8's cross-term error scrambles the
        ranking -- centered int8 restores f32-level recall at int8 fetch
        bandwidth when leaves are pure cluster fragments.  Supported on
        the sharded layouts too (the mean
        operands thread through the sharded scorers).

        ``sub_block=s > 1`` splits every leaf into ``s`` sub-blocks of
        ``lmax/s`` slots, with the leaf's rows reordered so each
        sub-block is a spatially coherent slice.  Queries fetch the same
        bytes (all of a probed leaf's sub-blocks), but the quantization
        state -- int8 scales and centered means -- lives PER SUB-BLOCK,
        which repairs centered int8 on leaves that straddle clusters.
        ``sub_split`` picks the ordering: ``"kmeans"`` (default; balanced
        recursive 2-means, so each sub-block's mean is a real cluster
        center -- requires power-of-two ``s``) or ``"proj"`` (1-D random
        projection sort; any ``s``).  Dense blocks only; incompatible
        with ``slack``/``fold``.  Supported on the sharded layouts too
        (tree-/leaf-sharded and data-parallel packers).

        ``store="shared"`` keeps ONE shared row store (the dataset array
        itself -- no row copies at all) and packs only the per-block
        slot -> point-id tables: ``1/T``-th the blocked layout's index
        memory, bought with per-ROW gather fetches (~2-4x slower on the
        fetch stage; ``ops/shared.py`` has the trade).  The memory-
        bounded mode for datasets near device-memory capacity (e.g. 10M
        f32 x 128-d: blocked T=8 needs ~41 GB, shared ~5.8 GB).
        Results are bit-identical to an unquantized blocked pack.  Dense
        datasets only; exclusive with ``slack``/``fold``, int8 /
        ``centered`` / ``sub_block``, and :meth:`drop_dataset` (the
        dataset IS the store).  ``dtype=jnp.bfloat16`` stores a casted
        half-size row copy instead of aliasing the dataset.  Sharded
        forms exist on both parallel classes: the tree mesh shards the
        slot tables over one replicated row store
        (:meth:`DistributedForest.pack_leaves`), and the data mesh
        serves straight from each shard's dataset slice via per-shard
        local-member tables
        (:meth:`DataParallelForest.pack_leaves`).

        ELL-sparse datasets pack into :class:`EllBlocks` (leaf-blocked
        padded cols/vals) and serve through the same probe-compacted
        block path.

        Calling again with the SAME layout is an idempotent no-op; a
        DIFFERENT layout repacks from the dataset (raises if the forest
        holds folded rows -- they live only in the packed blocks' slack
        slots, ``rebuild()`` first -- or if the dataset was dropped).
        """
        self._validate_pack_args(dtype, slack, centered, sub_block,
                                 sub_split, store=store)
        if self._packed is not None:
            # already packed: the SAME requested layout is an idempotent
            # no-op; a DIFFERENT one repacks (silently keeping the old
            # layout -- e.g. int8 blocks after a pack_leaves() asking for
            # f32 -- was a footgun: the serving dtype quietly disagreed
            # with what the caller asked for)
            if self._same_pack(dtype, slack, centered, sub_block,
                               sub_split, store=store):
                return self
            self._clear_pack_for_repack()
        if self._packed is None and store == "shared":
            plan = self.plan
            self._pack_slack = 0
            dtype_str = _dtype_str(dtype)
            # same slot-axis alignment as the blocked layout: the id/sq
            # tables are cheap either way and the serving masks are
            # layout-blind
            lmax = _tile_align(max(plan.max_leaf_len, 1))
            starts = np.asarray(plan.leaf_start)
            lens = np.asarray(plan.leaf_len)
            offs = np.arange(lmax, dtype=np.int32)
            pos = np.where(offs < lens[:, None],
                           starts[:, None] + offs, 0).astype(np.int32)
            in_leaf = offs < lens[:, None]
            ids, sq = _pack_shared_tables(self.arrays.perm, self.sq_norms,
                                          jnp.asarray(pos),
                                          jnp.asarray(in_leaf))
            g = self.n_trees * plan.n_leaves
            ids = ids.reshape(g, lmax)
            sq = sq.reshape(g, lmax)
            try:
                from jax.experimental.layout import Format, Layout

                def pin(a):
                    mm = tuple(range(a.ndim - 1, -1, -1))
                    return jax.device_put(
                        a, Format(Layout(major_to_minor=mm), a.sharding)
                    )

                ids, sq = pin(ids), pin(sq)
            except Exception:  # backends without explicit-layout support
                pass
            rows = (self.x if _DTYPE_OF[dtype_str] is None
                    else self.x.astype(_DTYPE_OF[dtype_str]))
            self._packed = (SharedRows(rows, ids), sq, ids)
            self._block_scale = None
            self._block_center = None
            self._sub_block = 1
            self._pack_cfg = {"dtype": _DTYPE_OF[dtype_str],
                              "store": "shared"}
            return self
        if self._packed is None and isinstance(self.x, EllMatrix):
            plan = self.plan
            self._pack_slack = int(slack)
            lmax = max(plan.max_leaf_len, 1) + int(slack)
            starts = jnp.asarray(plan.leaf_start)
            lens = jnp.asarray(plan.leaf_len)
            offs = jnp.arange(lmax, dtype=jnp.int32)
            pos = starts[:, None] + offs
            in_leaf = offs < lens[:, None]
            pos = jnp.where(in_leaf, pos, 0)
            sqn = self.sq_norms

            def per_tree(perm):
                ids = jnp.take(perm, pos)  # [n_leaves, lmax]
                cols = jnp.take(self.x.cols, ids, axis=0)
                vals = jnp.take(self.x.vals, ids, axis=0)
                cols = jnp.where(in_leaf[..., None], cols, 0)
                vals = jnp.where(in_leaf[..., None], vals, 0.0)
                sq = jnp.where(in_leaf, jnp.take(sqn, ids), 0.0)
                return cols, vals, sq, jnp.where(in_leaf, ids, -1)

            cols, vals, sq, ids = jax.vmap(per_tree)(self.arrays.perm)
            g = self.n_trees * plan.n_leaves
            kz = self.x.k
            if dtype is not None and jnp.dtype(dtype) == jnp.bfloat16:
                vals = vals.astype(jnp.bfloat16)
            blocks = EllBlocks(self.dim,
                               cols.reshape(g, lmax, kz),
                               vals.reshape(g, lmax, kz))
            self._packed = (blocks, sq.reshape(g, lmax),
                            ids.reshape(g, lmax))
            self._block_scale = None
            self._pack_cfg = {
                "dtype": (jnp.bfloat16 if dtype is not None
                          and jnp.dtype(dtype) == jnp.bfloat16 else None)}
            return self
        if self._packed is None and not isinstance(self.x, EllMatrix):
            plan = self.plan
            s = int(sub_block) if sub_block else 1
            if s > 1 and slack:
                raise ValueError("sub_block and slack are mutually "
                                 "exclusive (fold() addresses whole-leaf "
                                 "blocks)")
            sub_split = _sub_split_of(sub_split, s)
            self._pack_slack = int(slack)
            if centered and (dtype is None
                             or jnp.dtype(dtype) != jnp.int8):
                raise ValueError("centered=True applies to int8 blocks "
                                 "(pass dtype=jnp.int8)")
            dtype_str = _dtype_str(dtype)
            lmax0 = max(plan.max_leaf_len, 1) + int(slack)
            # align the slot axis to 8 rows (_tile_align).  Padded slots
            # are ordinary empty slots (maskable, bonus fold slack).
            ls = _tile_align(-(-lmax0 // s))
            lmax = ls * s if s > 1 else ls
            starts = np.asarray(plan.leaf_start)
            lens = np.asarray(plan.leaf_len)
            offs = np.arange(lmax, dtype=np.int32)
            pos = starts[:, None] + offs  # [n_leaves, lmax]
            in_leaf = offs < lens[:, None]
            pos = np.where(in_leaf, pos, 0).astype(np.int32)
            nl, d = plan.n_leaves, self.dim
            r_sub = in_sub = None
            if s > 1:
                r_sub, in_sub, sub_len = _sub_pack_tables(
                    self.seed, d, lens, ls, s)
                self._sub_len_dev = jnp.asarray(
                    np.tile(sub_len, self.n_trees))
            self._sub_block = s
            out = _pack_dense_blocks(self.arrays.perm, self.x,
                                     jnp.asarray(pos),
                                     jnp.asarray(in_leaf), dtype_str,
                                     centered, sub=s, r_sub=r_sub,
                                     in_sub=in_sub, sub_split=sub_split)
            scale = None
            center = None
            g = self.n_trees * nl * s
            if dtype_str == "int8" and centered:
                rows, sq, ids, scale, mu, mudr = out
                center = (mu.reshape(g, d), mudr.reshape(g, ls))
                scale = scale.reshape(g)
            elif dtype_str == "int8":
                rows, sq, ids, scale = out
                scale = scale.reshape(g)
            else:
                rows, sq, ids = out
            rows = rows.reshape(g, ls, d)
            sq = sq.reshape(g, ls)
            ids = ids.reshape(g, ls)
            # pin standard row-major layouts: the packing computation's
            # natural output layouts are lmax-major, and every query would
            # otherwise relayout-copy the block arrays on entry
            try:
                from jax.experimental.layout import Format, Layout

                def pin(a):
                    mm = tuple(range(a.ndim - 1, -1, -1))
                    return jax.device_put(
                        a, Format(Layout(major_to_minor=mm), a.sharding)
                    )

                rows, sq, ids = pin(rows), pin(sq), pin(ids)
            except Exception:  # backends without explicit-layout support
                pass
            self._packed = (rows, sq, ids)
            self._block_scale = scale
            self._block_center = center
            # remember the pack configuration so rebuild() re-packs the
            # SAME layout (an int8/centered pack silently becoming f32
            # would grow index memory 4x with no indication)
            self._pack_cfg = {"dtype": _DTYPE_OF[dtype_str],
                              "centered": centered, "sub_block": s,
                              "sub_split": sub_split}
        return self

    # -- incremental updates (freshness layer) -------------------------------

    def add(self, points, payloads: Optional[Sequence] = None,
            rebuild_every: int = 0) -> "RPForest":
        """Insert new points online (the reference's streaming ``insert``,
        ``Internal.hs:257-297``, whose chunk-wise re-splits this replaces).

        Design: new points land in a brute-force-scanned pending
        buffer that queries merge with the forest's results exactly (the
        standard freshness-layer recipe); :meth:`rebuild` folds the buffer
        into a fresh index.  ``rebuild_every > 0`` triggers an automatic
        rebuild when the buffer reaches that many points.
        """
        if self.x is None:
            raise ValueError("cannot add to a serve-only forest "
                             "(drop_dataset was called)")
        p = jnp.asarray(points, dtype=jnp.float32)
        if p.ndim == 1:
            p = p[None, :]
        if p.shape[-1] != self.dim:
            raise ValueError(f"point dim {p.shape[-1]} != index dim {self.dim}")
        if payloads is not None and len(payloads) != p.shape[0]:
            raise ValueError("payloads length != points length")
        if getattr(self, "_pending", None) is None:
            self._pending = []
            self._pending_payloads = []
        self._pending.append(p)
        self._pending_payloads.append(
            list(payloads) if payloads is not None
            else [None] * p.shape[0]
        )
        if rebuild_every and self.n_pending >= rebuild_every:
            self.rebuild()
        return self

    def remove(self, ids) -> "RPForest":
        """Delete points by id (tombstones): removed points stop appearing
        in query results immediately; :meth:`rebuild` purges them from the
        index.  The reference has no delete (its trees are immutable); this
        completes the online-update surface alongside :meth:`add`."""
        ids = np.asarray(ids).reshape(-1)
        n_idx = self.plan.n + self.n_folded  # indexed + fold-appended rows
        if self._deleted is None:
            self._deleted = np.zeros(n_idx, dtype=bool)
        in_range = (ids >= 0) & (ids < n_idx)
        self._deleted[ids[in_range]] = True
        self._deleted_dev = jnp.asarray(self._deleted)
        # ids past the indexed rows address the pending (freshness) buffer:
        # those points must stop appearing too (and be dropped at rebuild)
        in_pending = (ids >= n_idx) & (ids < n_idx + self.n_pending)
        if in_pending.any():
            if getattr(self, "_pending_deleted", None) is None:
                self._pending_deleted = set()
            self._pending_deleted.update(
                int(i) - n_idx for i in ids[in_pending]
            )
        return self

    @property
    def n_deleted(self) -> int:
        n = int(self._deleted.sum()) if self._deleted is not None else 0
        return n + len(getattr(self, "_pending_deleted", None) or ())

    def _apply_update_hooks(self, qb, d, ids, k, metric, precision):
        """Tombstone masking + exact pending merge -- applied by every
        query surface (knn, knn_h, and the sharded facades)."""
        if self._deleted is not None:
            d, ids = self._mask_deleted(d, ids, k)
        if getattr(self, "_pending", None):
            d, ids = self._merge_pending(qb, d, ids, k, metric, precision)
        return d, ids

    def _mask_deleted(self, d, ids, k):
        """Drop tombstoned ids from a (dists, ids) result and re-select."""
        nflag = self._deleted_dev.shape[0]
        dead = (jnp.take(self._deleted_dev, jnp.clip(ids, 0, None))
                & (ids >= 0) & (ids < nflag))
        d = jnp.where(dead, jnp.inf, d)
        ids = jnp.where(dead, -1, ids)
        return merge_top_k(d, ids, k, dedup=False)

    @property
    def n_pending(self) -> int:
        return sum(int(c.shape[0]) for c in getattr(self, "_pending", None) or [])

    @property
    def n_folded(self) -> int:
        return sum(int(c.shape[0])
                   for c in getattr(self, "_folded_x", None) or [])

    _index_axis = None  # sharded subclasses set their mesh axis name

    def _fold_row_of(self, g: np.ndarray) -> np.ndarray:
        """Storage row of global block id ``g`` in the packed arrays:
        identity for the single-device and tree-sharded layouts; the
        leaf-sharded round-robin layout stores block g on shard ``g % S``
        at local row ``g // S`` (global row ``(g % S) * G/S + g // S``)."""
        if (getattr(self, "mesh", None) is None
                or getattr(self, "_packed_mode", None) != "leaf"):
            return g
        s = int(self.mesh.shape[self._index_axis])
        g_rows = int(self._packed[0].shape[0])  # padded block count
        return (g % s) * (g_rows // s) + g // s

    def _store_block_len(self, bl: np.ndarray) -> None:
        """Record the dynamic per-block occupancy (global block order) and
        refresh the device copies the query kernels read: sharded layouts
        keep BOTH a replicated global-order copy (bucket-stop sizes read
        it by global block id) and a storage-row-order sharded copy
        (scoring reads it by local row)."""
        self._block_len = bl
        if getattr(self, "mesh", None) is None:
            self._block_len_dev = jnp.asarray(bl)
            return
        from jax.sharding import NamedSharding, PartitionSpec as P

        self._block_len_dev = jax.device_put(
            jnp.asarray(bl), NamedSharding(self.mesh, P()))
        rows_n = int(self._packed[0].shape[0])
        bl_rows = np.zeros(rows_n, np.int32)
        bl_rows[self._fold_row_of(np.arange(bl.shape[0]))] = bl
        self._block_len_rows_dev = jax.device_put(
            jnp.asarray(bl_rows),
            NamedSharding(self.mesh, P(self._index_axis)))

    def fold(self) -> "RPForest":
        """Fold the pending buffer into the packed leaf blocks' slack
        slots: each point descends every tree by the stored thresholds
        (the placement step of the reference's ``insert``,
        ``Internal.hs:257-297``) and is appended to the leaf it reaches --
        amortized cost O(chunk x depth) + one scatter, NOT the O(n)
        rebuild.  Points whose target leaf is full in ANY tree stay in the
        exact pending merge; :meth:`rebuild` folds everything for real.
        Requires :meth:`pack_leaves` (use ``slack=...`` to reserve room);
        like rebuild, folding renumbers the buffered points' ids.

        Works on every packed layout: single-device dense/int8/ELL blocks,
        tree-sharded and leaf-sharded dense or ELL blocks (the scatter
        addresses each block's storage row through the layout's
        round-robin map, and the dynamic per-block occupancy is threaded
        into the sharded query kernels).

        How long is fold-only operation safe?  As
        ``examples/fold_drift.py`` measures it: under a STATIONARY
        stream, recall stays within 0.002 of a fresh rebuild up to 80%
        folded fraction -- degradation comes from slack exhaustion, not
        threshold staleness.  Under distribution DRIFT the gap opens once
        the data has moved ~0.5 sigma and leaves saturate (0.27 recall
        gap at 81% folded).  Recommended default: :meth:`rebuild` by ~50%
        folded fraction under drift (``add(rebuild_every=n//2)``), 80%
        stationary, or on the first fold that leaves overflow pending."""
        if self._packed is None:
            raise ValueError("pack_leaves(slack=...) first: fold inserts "
                             "into the packed blocks' slack slots")
        if isinstance(self._packed[0], SharedRows):
            raise ValueError("fold() writes rows into the packed blocks' "
                             "slack slots; the shared-row layout "
                             "(store='shared') keeps no row blocks -- "
                             "rebuild() folds pending points instead")
        if getattr(self, "_sub_block", 1) > 1:
            raise ValueError("fold() needs whole-leaf blocks; pack "
                             "without sub_block (or rebuild())")
        sharded = getattr(self, "mesh", None) is not None
        is_ell = isinstance(self._packed[0], EllBlocks)
        if not getattr(self, "_pending", None):
            return self
        xp = jnp.concatenate(self._pending, axis=0)
        pays = sum(self._pending_payloads, [])
        dead = getattr(self, "_pending_deleted", None) or set()
        if dead:
            keepm = np.ones(xp.shape[0], bool)
            keepm[list(dead)] = False
            xp = xp[jnp.asarray(keepm)]
            pays = [p for p, kp in zip(pays, keepm) if kp]
            self._pending_deleted = None
        m = int(xp.shape[0])
        if m == 0:
            self._pending, self._pending_payloads = [], []
            return self

        t, nl = self.n_trees, self.plan.n_leaves
        if is_ell:
            blocks = self._packed[0]
            lmax_eff = blocks.cols.shape[-2]
            kz = blocks.cols.shape[-1]
            # densified pending rows -> padded ELL slot lists; rows with
            # more nonzeros than the blocks' K slots cannot be stored
            # losslessly and stay in the exact pending merge
            xp_np = np.asarray(xp)
            nz = xp_np != 0.0
            nnz = nz.sum(axis=1)
            convertible = nnz <= kz
        else:
            lmax_eff = self._packed[0].shape[-2]
            convertible = None
        if self._block_len is None:
            self._block_len = np.tile(
                np.asarray(self.plan.leaf_len, np.int32), t
            )
        bl = self._block_len
        leaf = np.asarray(_descend(self.plan, self.arrays, xp))  # [T, M]
        g = leaf + np.arange(t, dtype=np.int32)[:, None] * nl

        def _ranks(g_row, width):
            """Stable rank of each element within its equal-value group."""
            order = np.argsort(g_row, kind="stable")
            gs = g_row[order]
            first = np.concatenate([[True], gs[1:] != gs[:-1]])
            start = np.maximum.accumulate(
                np.where(first, np.arange(width), 0))
            rank = np.empty(width, np.int64)
            rank[order] = np.arange(width) - start
            return rank

        # pass 1: acceptance with conservative ranks over ALL candidates
        # (a point is folded only if it fits in EVERY tree; rejecting a
        # point can only free slots, so pass-2 ranks never exceed these)
        fits = np.ones(m, bool) if convertible is None else convertible.copy()
        for tt in range(t):
            fits &= bl[g[tt]] + _ranks(g[tt], m) < lmax_eff
        sel = np.where(fits)[0]
        if sel.size:
            msel = sel.size
            gsel = g[:, sel]
            slots = np.zeros((t, msel), np.int32)
            for tt in range(t):  # pass 2: contiguous slots among accepted
                slots[tt] = bl[gsel[tt]] + _ranks(gsel[tt], msel)
            base = self.plan.n + self.n_folded
            ids_new = base + np.arange(msel, dtype=np.int32)
            rows = xp[jnp.asarray(sel)]
            sq = jnp.sum(rows * rows, axis=-1)  # exact norms, as at pack
            # sharded layouts store block g at a round-robin row; the
            # scatter addresses storage rows through the layout's map
            rsel = self._fold_row_of(gsel)
            if is_ell:
                # pack each accepted dense row into K (col, val) slots
                rows_np = xp_np[sel]
                rc = np.zeros((msel, kz), np.int32)
                rv = np.zeros((msel, kz), np.float32)
                for j in range(msel):
                    idxs = np.flatnonzero(rows_np[j])
                    rc[j, :idxs.size] = idxs
                    rv[j, :idxs.size] = rows_np[j][idxs]
                blocks = self._packed[0]
                out_ell = _scatter_fold_ell(
                    blocks.cols, blocks.vals, self._packed[1],
                    self._packed[2],
                    jnp.asarray(rsel.reshape(-1)),
                    jnp.asarray(slots.reshape(-1)),
                    jnp.asarray(np.tile(rc, (t, 1))),
                    jnp.asarray(np.tile(rv, (t, 1))),
                    jnp.tile(sq, t),
                    jnp.tile(jnp.asarray(ids_new), t),
                )
                if sharded:
                    # re-pin the scattered outputs to the original block
                    # shardings (GSPMD may have chosen different ones)
                    out_ell = tuple(
                        jax.device_put(a, ref.sharding)
                        for a, ref in zip(
                            out_ell, (blocks.cols, blocks.vals,
                                      self._packed[1], self._packed[2]))
                    )
                cols2, vals2, sq2, ids2 = out_ell
                self._packed = (EllBlocks(blocks.dim, cols2, vals2),
                                sq2, ids2)
            else:
                scale = getattr(self, "_block_scale", None)
                center = getattr(self, "_block_center", None)
                mudr_new = None
                if scale is None:
                    flat_rows = jnp.tile(rows, (t, 1))
                else:
                    # int8 blocks: quantize each folded row with its TARGET
                    # block's existing scale (rows larger than the block's
                    # original amplitude clip; stored norms stay exact);
                    # scales are stored in storage-row order
                    sc = np.asarray(scale)[rsel]  # [T, msel]
                    rows_d = np.asarray(rows)
                    if center is not None:
                        # centered blocks store residuals around the block
                        # mean; the per-slot mean.residual term is updated
                        # alongside the scatter below
                        mu_sel = np.asarray(center[0])[rsel]  # [T, m, D]
                        res = rows_d[None] - mu_sel
                        rq = np.clip(np.round(res / sc[..., None]),
                                     -127, 127).astype(np.int8)
                        mudr_new = np.einsum(
                            "tmd,tmd->tm",
                            rq.astype(np.float32) * sc[..., None], mu_sel)
                    else:
                        rq = np.clip(
                            np.round(rows_d[None] / sc[..., None]),
                            -127, 127,
                        ).astype(np.int8)
                    flat_rows = jnp.asarray(rq.reshape(t * msel, -1))
                x_leaf, sq_leaf, id_leaf = self._packed
                new_packed = _scatter_fold(
                    x_leaf, sq_leaf, id_leaf,
                    jnp.asarray(rsel.reshape(-1)),
                    jnp.asarray(slots.reshape(-1)),
                    flat_rows,
                    jnp.tile(sq, t),
                    jnp.tile(jnp.asarray(ids_new), t),
                )
                if sharded:
                    # re-pin the scattered outputs to the original block
                    # shardings (GSPMD may have chosen different ones)
                    new_packed = tuple(
                        jax.device_put(a, ref.sharding)
                        for a, ref in zip(new_packed,
                                          (x_leaf, sq_leaf, id_leaf))
                    )
                self._packed = new_packed
                if mudr_new is not None:
                    mu_arr, mudr_arr = self._block_center
                    upd = mudr_arr.at[
                        jnp.asarray(rsel.reshape(-1)),
                        jnp.asarray(slots.reshape(-1)),
                    ].set(jnp.asarray(mudr_new.reshape(-1)))
                    if sharded:
                        upd = jax.device_put(upd, mudr_arr.sharding)
                    self._block_center = (mu_arr, upd)
            for tt in range(t):
                np.add.at(bl, gsel[tt], 1)
            self._store_block_len(bl)
            self._folded_x.append(np.asarray(rows))
            self._folded_leaf.append(leaf[:, sel])
            self._folded_cat = None
            self._folded_payloads.extend(
                pays[j] for j in sel.tolist())
            if self._deleted is not None:
                self._deleted = np.concatenate(
                    [self._deleted, np.zeros(msel, bool)])
                self._deleted_dev = jnp.asarray(self._deleted)
        # overflowing points stay in the exact pending merge
        rest = np.where(~fits)[0]
        if rest.size:
            self._pending = [xp[jnp.asarray(rest)]]
            self._pending_payloads = [[pays[j] for j in rest.tolist()]]
        else:
            self._pending, self._pending_payloads = [], []
        return self

    def _rebuild_rows(self):
        """Collect the full post-update dataset for a rebuild: original
        rows + fold-appended rows + pending rows, with tombstoned entries
        purged.  Returns ``(x_all, payloads_or_None)``."""
        x_old = jnp.asarray(self._points_raw())
        old_payloads = (list(self.payloads) if self.payloads is not None
                        else [None] * self.plan.n)
        # fold-appended rows re-enter the exact build as ordinary points
        if self.n_folded:
            x_old = jnp.concatenate(
                [x_old] + [jnp.asarray(c) for c in self._folded_x], axis=0
            )
            old_payloads = old_payloads + list(self._folded_payloads)
        if self._deleted is not None and self._deleted.any():
            keep = ~self._deleted
            x_old = x_old[jnp.asarray(keep)]
            old_payloads = [p for p, kp in zip(old_payloads, keep) if kp]
        pend_rows = list(self._pending)
        pend_payloads = sum(self._pending_payloads, [])
        dead_p = getattr(self, "_pending_deleted", None)
        if dead_p and pend_rows:
            xp = jnp.concatenate(pend_rows, axis=0)
            keep_p = np.ones(xp.shape[0], dtype=bool)
            keep_p[list(dead_p)] = False
            pend_rows = [xp[jnp.asarray(keep_p)]]
            pend_payloads = [p for p, kp in zip(pend_payloads, keep_p) if kp]
        x_all = jnp.concatenate([x_old] + pend_rows, axis=0)
        new_payloads = old_payloads + pend_payloads
        return x_all, (None if all(p is None for p in new_payloads)
                       else new_payloads)

    def rebuild(self) -> "RPForest":
        """Fold pending points into (and purge deletions from) a fresh
        index (same seed and construction parameters; the plan adapts to
        the new size).  NOTE: ids are row indices of the current index, so
        a rebuild that purges deletions renumbers them; payloads follow
        the points."""
        if (not getattr(self, "_pending", None) and self.n_deleted == 0
                and self.n_folded == 0):
            return self
        from .forest import forest_batch  # self-import safe at runtime

        x_all, new_payloads = self._rebuild_rows()
        cfg = self.config
        fresh = forest_batch(self.seed, cfg.max_depth, cfg.min_leaf,
                             cfg.n_trees, cfg.proj_nz_density, x_all,
                             payloads=new_payloads)
        self.plan = fresh.plan
        self.arrays = fresh.arrays
        self.x = fresh.x
        self.sq_norms = fresh.sq_norms
        self.payloads = fresh.payloads
        self._pending = []
        self._pending_payloads = []
        self._deleted = None
        self._pending_deleted = None
        self._folded_x = []
        self._folded_leaf = []
        self._folded_payloads = []
        self._folded_cat = None
        self._block_len = None
        self._block_len_dev = None
        # the static per-block occupancy cache is a function of the PLAN,
        # which rebuild() just replaced -- a stale table silently masks or
        # unmasks rows in knn_grouped
        self._lens_global_dev = None
        # learned grouped tile capacities are a function of the plan's
        # block structure too; a stale undersized capacity would silently
        # mask pairs under knn_grouped(check=False) after the rebuild
        self._grouped_nt = {}
        if self._packed is not None:
            # replay the remembered pack configuration (dtype / centered /
            # sub_block), not just the slack -- rebuild must not silently
            # de-quantize the serving layout
            cfg_p = dict(getattr(self, "_pack_cfg", None) or {})
            self._packed = None
            self._block_scale = None
            self._block_center = None
            self._sub_block = 1
            self._sub_len_dev = None
            self.pack_leaves(slack=self._pack_slack, **cfg_p)
        return self

    def _merge_pending(self, qb, d, ids, k, metric, precision):
        """Exact brute-force scan of the pending buffer, merged with the
        forest's results (pending ids continue after the indexed points)."""
        xp = jnp.concatenate(self._pending, axis=0)
        sqp = jnp.sum(xp * xp, axis=-1)
        dead = getattr(self, "_pending_deleted", None)
        if dead:
            mask = np.zeros(xp.shape[0], dtype=bool)
            mask[list(dead)] = True
        # over-fetch by the tombstone count so deleted pending points can
        # never crowd live ones out of the k window (post-mask below)
        kp = min(k + (len(dead) if dead else 0), xp.shape[0])
        dp, ip = _brute_force(xp, sqp, qb, kp, metric, precision)
        if dead:
            dpd = jnp.take(jnp.asarray(mask), jnp.clip(ip, 0, None)) & (ip >= 0)
            dp = jnp.where(dpd, jnp.inf, dp)
            ip = jnp.where(dpd, -1, ip)
        ip = jnp.where(ip >= 0, ip + self.plan.n + self.n_folded, -1)
        d_all = jnp.concatenate([d, dp], axis=-1)
        i_all = jnp.concatenate([ids, ip], axis=-1)
        return merge_top_k(d_all, i_all, k, dedup=False)

    def drop_dataset(self) -> "RPForest":
        """Serve-only mode: release the raw dataset and squared norms,
        keeping just the packed leaf blocks (which contain every point in
        leaf order).  After this, ``knn``/``knn_h`` keep working on the
        packed path; ``brute_force_knn``, ``recall_with``, ``points`` and
        the unpacked query paths raise.  Frees 1x dataset + norms of HBM
        (the tree-sharded distributed case keeps only T_local trees' blocks
        per chip)."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: the packed blocks are "
                             "the only remaining copy of the data")
        if isinstance(self._packed[0], SharedRows):
            raise ValueError("the shared-row layout (store='shared') "
                             "serves from the dataset array itself -- "
                             "there is no separate copy to drop (it is "
                             "already the single-copy mode)")
        self.x = None
        self.sq_norms = None
        return self

    def knn(self, q, k: int, metric: str = "l2", budget: Optional[int] = None,
            dedup: bool = True, precision: str = "highest",
            probes: Optional[int] = None, min_votes: int = 1,
            selection: str = "sort") -> Tuple[jax.Array, jax.Array]:
        """k nearest neighbours of ``q`` (single vector or batch).

        Returns ``(dists f32[B, k], ids int32[B, k])`` ordered by increasing
        distance; ``-1`` ids mark unfilled slots.  ``dedup=False``
        reproduces the reference ``knn``'s concatenating union
        (RPTree.hs:176), which may return the same point more than once.

        After :meth:`pack_leaves`, ``probes`` caps the total number of leaf
        buckets reranked across trees (lowest margin priority first;
        default ``n_trees * budget`` = no cap, exact).

        ``min_votes > 1`` keeps only candidates found by at least that
        many trees -- the voting filter of Hyvonen et al. 2016 (the cited
        algorithm's full form; the reference library unions only).

        ``metric`` is a builtin name (``l2``/``sql2``/``cosine``/``dot``)
        or any jit-compatible callable ``distf(rows[..., C, D],
        q[..., 1, D]) -> [..., C]`` (smaller = closer) -- the reference's
        user-supplied ``distf`` (RPTree.hs:168) / ``Inner`` extension
        point (Internal.hs:315-341).  Callables need dense data rows
        (not ELL datasets or int8 blocks).
        """
        k = self._check_k(k)
        qb = _as_dense_queries(q, self.dim)
        budget = self._budget(budget)
        if self._packed is not None:
            x_leaf, sq_leaf, id_leaf = self._packed
            if probes is None:
                probes = self.n_trees * budget
            sub = getattr(self, "_sub_block", 1)
            out = _knn_packed(self.plan, self.arrays, x_leaf, sq_leaf,
                              id_leaf, qb, int(k), budget, int(probes),
                              metric, dedup, precision,
                              min_votes=int(min_votes),
                              block_scale=getattr(self, "_block_scale", None),
                              block_len=(self._sub_len_dev if sub > 1
                                         else self._block_len_dev),
                              block_center=self._block_center, sub=sub,
                              selection=selection)
            return self._apply_update_hooks(qb, out[0], out[1], int(k),
                                            metric, precision)
        if self.x is None:
            raise ValueError("dataset dropped (drop_dataset); only packed-"
                             "path queries are available")
        out = _knn(self.plan, self.arrays, self.x, self.sq_norms, qb, int(k),
                   budget, metric, dedup, precision,
                   min_votes=int(min_votes))
        return self._apply_update_hooks(qb, out[0], out[1], int(k), metric,
                                        precision)

    def knn_batched(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, min_votes: int = 1,
                    chunk: int = 4096,
                    selection: str = "sort") -> Tuple[jax.Array, jax.Array]:
        """Large-batch kNN in ONE device dispatch: queries are processed
        in chunks of ``chunk`` inside a single ``lax.map`` program, so
        peak rerank memory is per-chunk but the host pays one dispatch
        for the whole batch.  Requires :meth:`pack_leaves`.  Results are
        identical to chunked :meth:`knn` calls.

        An :class:`EllMatrix` query batch stays SPARSE at the facade:
        each chunk densifies only its own ``[chunk, dim]`` strip inside
        the program, so giant sparse batches at vocab-scale dims never
        materialize ``[B, dim]`` (the reference's sparse-query
        ``innerSS`` regime, ``Internal.hs:100-119``, at accelerator
        batch scale).  The exact pending merge needs dense rows -- ``fold()``
        first when pending inserts exist."""
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_batched runs the "
                             "leaf-blocked pipeline")
        k = self._check_k(k)
        budget = self._budget(budget)
        x_leaf, sq_leaf, id_leaf = self._packed
        if probes is None:
            probes = self.n_trees * budget
        sub = getattr(self, "_sub_block", 1)
        if isinstance(q, EllMatrix):
            # sparse-query batch at scale: densify PER CHUNK inside the
            # one-dispatch loop (the whole-batch [B, dim] buffer the
            # default path would build is the scaling wall at vocab
            # dims); the reference's innerSS regime, Internal.hs:100-119
            if q.dim != self.dim:
                raise ValueError(f"query dim {q.dim} != index dim "
                                 f"{self.dim}")
            if getattr(self, "_pending", None):
                raise ValueError(
                    "sparse-query batches do not support the exact "
                    "pending merge (it needs dense query rows); fold() "
                    "or rebuild() first")
            qc, qv = q.cols, q.vals
            b = qc.shape[0]
            ch = max(1, min(int(chunk), b))
            pad = (-b) % ch
            if pad:
                qc = jnp.concatenate(
                    [qc, jnp.zeros((pad, qc.shape[1]), qc.dtype)])
                qv = jnp.concatenate(
                    [qv, jnp.zeros((pad, qv.shape[1]), qv.dtype)])
            d, ids = _knn_packed_many_ellq(
                self.plan, self.arrays, x_leaf, sq_leaf, id_leaf, qc, qv,
                self.dim, int(k), budget, int(probes), metric, dedup,
                precision, False, int(min_votes),
                getattr(self, "_block_scale", None),
                self._sub_len_dev if sub > 1 else self._block_len_dev,
                ch, block_center=self._block_center, sub=sub,
                selection=selection,
            )
            d, ids = d[:b], ids[:b]
            if self._deleted is not None:
                d, ids = self._mask_deleted(d, ids, int(k))
            return d, ids
        qb, b, chunk = _pad_to_chunk(_as_dense_queries(q, self.dim), chunk)
        out = _knn_packed_many(
            self.plan, self.arrays, x_leaf, sq_leaf, id_leaf, qb, int(k),
            budget, int(probes), metric, dedup, precision, False,
            int(min_votes), getattr(self, "_block_scale", None),
            self._sub_len_dev if sub > 1 else self._block_len_dev, chunk,
            block_center=self._block_center, sub=sub, selection=selection,
        )
        out = (out[0][:b], out[1][:b])
        return self._apply_update_hooks(qb[:b], out[0], out[1], int(k),
                                        metric, precision)

    def _lens_global(self) -> jax.Array:
        """Per-block occupancy ``int32[G]`` in GLOBAL block order: the
        dynamic post-fold table when present, else the plan's static leaf
        lengths tiled over trees (sub-block occupancies when packed with
        ``sub_block > 1``)."""
        sub = getattr(self, "_sub_block", 1)
        if sub > 1:
            return self._sub_len_dev
        if self._block_len_dev is not None:
            return self._block_len_dev
        if getattr(self, "_lens_global_dev", None) is None:
            self._lens_global_dev = jnp.asarray(
                np.tile(np.asarray(self.plan.leaf_len, np.int32),
                        self.n_trees))
        return self._lens_global_dev

    def knn_grouped(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None, dedup: bool = True,
                    precision: str = "highest",
                    probes: Optional[int] = None, tile_m: int = 16,
                    nt: Optional[int] = None, tile_chunk: int = 2048,
                    bucket_stop: bool = False, min_votes: int = 1,
                    selection: str = "sort", impl: str = "auto",
                    check: bool = True, chunk: Optional[int] = None
                    ) -> Tuple[jax.Array, jax.Array]:
        """Query-grouped block-resident kNN: same results as :meth:`knn`
        on the packed path, restructured so queries probing the SAME leaf
        block share one fetch of it and one tile dot against the
        resident block (:mod:`rptree_tpu.ops.grouped`).  The win grows
        with probe overlap -- clustered data and large batches; on data
        where every pair probes a distinct block it degenerates to the
        per-pair path's traffic plus grouping overhead (use :meth:`knn`).

        Processes the WHOLE batch in one dispatch.  The data-dependent
        tile count is covered by a static capacity that auto-sizes: the
        first call measures the needed tiles and re-runs if the initial
        guess was low (each capacity bucket compiles once); the learned
        capacity is cached per (batch, probes, tile_m) shape.

        ELL-sparse blocks serve through the same tiling (one
        ``(cols, vals)`` block fetch per tile; the contraction stays
        gather-based); at vocab-scale dims ``tile_chunk`` auto-clamps so
        the per-step dense-query tile fits device memory (bag-of-words
        shapes usually serve faster per-pair via :meth:`knn_batched`
        anyway); ``min_votes`` and
        custom distance callables apply
        as in :meth:`knn` (callables need dense f32/bf16 blocks).
        Sharded forests serve the leaf-sharded grouped form through
        their own ``knn_grouped`` (``parallel/distributed.py``).

        ``check=False`` is the steady-state serving mode: once this
        batch shape's capacity is known (one earlier checked call, or an
        explicit ``nt``) the per-call device->host capacity fetch is
        skipped, keeping the call free of host syncs.  If a later batch
        at this
        shape needs more tiles than the cached capacity + 12.5% headroom,
        its overflow pairs are silently masked (+inf) -- a recall dip,
        never a wrong distance.

        ``chunk`` runs the pipeline as a ``lax.map`` over query chunks
        INSIDE the one dispatch (the grouped form of
        :meth:`knn_batched`): giant batches amortize the per-dispatch
        host cost while per-chunk peak memory stays bounded.  ``nt``/the
        cached capacity are then PER CHUNK.
        """
        if self._packed is None:
            raise ValueError("pack_leaves() first: knn_grouped runs on "
                             "the leaf-blocked layout")
        if callable(metric):
            # same dense-rows constraint as the per-pair scorer
            if isinstance(self._packed[0], EllBlocks):
                raise NotImplementedError(
                    "custom distance callables need dense data rows "
                    "(ELL-sparse datasets support the builtin metrics "
                    "only)")
            if self._packed[0].dtype == jnp.int8:
                raise NotImplementedError(
                    "custom distance callables are unsupported on int8-"
                    "quantized blocks (pack with f32/bf16)")
        k = self._check_k(k)
        ellq = isinstance(q, EllMatrix)
        if ellq:
            # sparse-QUERY batch (see knn_batched): stays (cols, vals)
            # at the facade; each chunk densifies its own strip inside
            # the one-dispatch program
            if q.dim != self.dim:
                raise ValueError(f"query dim {q.dim} != index dim "
                                 f"{self.dim}")
            if getattr(self, "_pending", None):
                raise ValueError(
                    "sparse-query batches do not support the exact "
                    "pending merge (it needs dense query rows); fold() "
                    "or rebuild() first")
            if chunk is None:
                chunk = 4096  # per-chunk densify requires the chunked form
            qb = q
        else:
            qb = _as_dense_queries(q, self.dim)
        budget = self._budget(budget)
        if probes is None:
            probes = self.n_trees * budget
        probes = int(probes)
        sub = getattr(self, "_sub_block", 1)
        x_leaf, sq_leaf, id_leaf = self._packed
        lens = self._lens_global()
        tile_chunk = _ell_tile_chunk_cap(x_leaf, self.dim, tile_m,
                                         tile_chunk)
        b = qb.shape[0]
        if chunk is not None:
            chunk = max(1, min(int(chunk), b))
            pad = (-b) % chunk
            if pad and ellq:
                qb = EllMatrix(
                    self.dim,
                    jnp.concatenate(
                        [qb.cols,
                         jnp.zeros((pad, qb.cols.shape[1]),
                                   qb.cols.dtype)]),
                    jnp.concatenate(
                        [qb.vals,
                         jnp.zeros((pad, qb.vals.shape[1]),
                                   qb.vals.dtype)]))
            elif pad:
                qb = jnp.concatenate(
                    [qb, jnp.zeros((pad, qb.shape[1]), qb.dtype)], axis=0)

        def run(cap, tc_eff):
            if chunk is not None:
                d, ids, needed = _knn_grouped_many(
                    self.plan, self.arrays, x_leaf, sq_leaf, id_leaf,
                    lens, qb, int(k), budget, probes, metric, dedup,
                    precision, int(tile_m), cap, tc_eff, chunk,
                    bucket_stop=bucket_stop, min_votes=int(min_votes),
                    block_scale=getattr(self, "_block_scale", None),
                    block_center=self._block_center, sub=sub,
                    selection=selection, impl=impl)
            else:
                d, ids, needed = _knn_grouped(
                    self.plan, self.arrays, x_leaf, sq_leaf, id_leaf,
                    lens, qb, int(k), budget, probes, metric, dedup,
                    precision, int(tile_m), cap, tc_eff,
                    bucket_stop=bucket_stop, min_votes=int(min_votes),
                    block_scale=getattr(self, "_block_scale", None),
                    block_center=self._block_center, sub=sub,
                    selection=selection, impl=impl)
            return (d, ids), needed

        key = ((qb.shape[0], probes, int(tile_m), sub) if chunk is None
               else (qb.shape[0], probes, int(tile_m), sub, chunk))
        d, ids = _grouped_auto_capacity(
            self, key, (chunk or qb.shape[0]) * probes * sub, tile_m,
            tile_chunk, nt, run, check=check)
        if ellq:
            # pending raised above; tombstone masking needs no rows
            d, ids = d[:b], ids[:b]
            if self._deleted is not None:
                d, ids = self._mask_deleted(d, ids, int(k))
            return d, ids
        return self._apply_update_hooks(qb[:b], d[:b], ids[:b], int(k),
                                        metric, precision)

    def grouped_overflow(self) -> Optional[dict]:
        """Overflow telemetry for the most recent :meth:`knn_grouped`
        call (single-device or sharded -- the sharded count is already
        psum-maxed across shards).

        ``check=False`` steady-state serving silently masks overflow
        pairs to +inf when a batch needs more tiles than the cached
        capacity (a recall dip, never a wrong distance); the needed-tile
        count stays a DEVICE scalar during serving, so the serving loop
        itself never host-syncs.  Calling this fetches that one int
        and returns ``{"needed", "capacity",
        "overflow"}`` -- poll it every N batches and re-run a checked
        call (or :meth:`knn_grouped` with a larger ``nt``) when
        ``overflow`` is True.  Returns None before any grouped call."""
        last = getattr(self, "_grouped_last", None)
        if last is None:
            return None
        needed, cap = last
        n = int(needed)
        return {"needed": n, "capacity": int(cap), "overflow": n > cap}

    def knn_pq(self, q, k: int, metric: str = "l2",
               budget: Optional[int] = None, precision: str = "highest"):
        """Deduplicating kNN (reference ``knnPQ``, RPTree.hs:178-194)."""
        return self.knn(q, k, metric=metric, budget=budget, dedup=True,
                        precision=precision)

    def knn_h(self, q, k: int, metric: str = "l2", budget: Optional[int] = None,
              dedup: bool = True, precision: str = "highest",
              probes: Optional[int] = None):
        """Margin-priority kNN (reference ``knnH``, RPTree.hs:196-217).
        After :meth:`pack_leaves` this runs on the leaf-blocked fast path
        (the bucket stop rule becomes a mask over the priority-ordered
        probe window)."""
        k = self._check_k(k)
        qb = _as_dense_queries(q, self.dim)
        budget = self._budget(budget)
        if self._packed is not None:
            x_leaf, sq_leaf, id_leaf = self._packed
            if probes is None:
                probes = self.n_trees * budget
            sub = getattr(self, "_sub_block", 1)
            out = _knn_packed(self.plan, self.arrays, x_leaf, sq_leaf,
                              id_leaf, qb, int(k), budget, int(probes),
                              metric, dedup, precision, bucket_stop=True,
                              block_scale=getattr(self, "_block_scale", None),
                              block_len=(self._sub_len_dev if sub > 1
                                         else self._block_len_dev),
                              block_center=self._block_center, sub=sub)
        else:
            out = _knn_h(self.plan, self.arrays, self.x, self.sq_norms, qb,
                         int(k), budget, metric, dedup, precision)
        return self._apply_update_hooks(qb, out[0], out[1], int(k), metric,
                                        precision)

    def knn_h_buckets(self, q, k: int, budget: Optional[int] = None):
        """Raw candidate point ids selected by the knnH bucket-stop rule,
        UNSORTED and UNTRUNCATED -- the reference ``knnH``'s actual return
        contract (RPTree.hs:196-217 returns the selected buckets'
        contents, not a reranked top-k; :meth:`knn_h` reranks and
        truncates them to k).  Returns ``int32[B, M]`` ids, -1 padded.

        After :meth:`fold` the buckets are read from the PACKED id blocks
        with the dynamic occupancies, so fold-appended rows appear in (and
        count toward the stop rule of) their assigned buckets -- the
        contract tracks the index contents, not just the build-time
        permutation."""
        k = self._check_k(k)
        qb = _as_dense_queries(q, self.dim)
        if self.n_folded:
            # folded rows exist only with packed blocks (fold() requires
            # pack_leaves); read the honest, occupancy-aware form
            id_leaf = self._packed[2]
            row_of = None
            if (getattr(self, "mesh", None) is not None
                    and getattr(self, "_packed_mode", None) == "leaf"):
                g = int(self._block_len_dev.shape[0])
                row_of = jnp.asarray(
                    self._fold_row_of(np.arange(g)).astype(np.int32))
            return _knn_h_ids_packed(self.plan, self.arrays, id_leaf, qb,
                                     int(k), self._budget(budget),
                                     self._block_len_dev, row_of=row_of)
        return _knn_h_ids(self.plan, self.arrays, qb, int(k),
                          self._budget(budget))

    def candidates(self, q, budget: Optional[int] = None, tree: Optional[int] = None):
        """Candidate point ids per tree (reference ``candidates``,
        RPTree.hs:289-314).  Returns ``int32[T, B, C]`` (-1 padded), or
        ``[B, C]`` for a single tree."""
        qb = _as_dense_queries(q, self.dim)
        cand = _candidate_ids(self.plan, self.arrays, qb, self._budget(budget))
        return cand if tree is None else cand[tree]

    def recall_with(self, q, k: int, metric: str = "l2",
                    budget: Optional[int] = None) -> jax.Array:
        """Average recall@k over the forest's trees (reference
        ``recallWith``, RPTree.hs:250-285).  Returns ``f32[B]``."""
        if self.x is None:
            raise ValueError("dataset dropped (drop_dataset); recall "
                             "needs the raw rows")
        qb = _as_dense_queries(q, self.dim)
        if self.n_folded:
            _, exact_ids = self.brute_force_knn(qb, int(k), metric=metric)
            fl = jnp.asarray(np.concatenate(self._folded_leaf, axis=1))
            return _recall_folded(self.plan, self.arrays, qb,
                                  int(k), self._budget(budget),
                                  exact_ids, fl, self.plan.n)
        return _recall(self.plan, self.arrays, self.x, self.sq_norms, qb,
                       int(k), self._budget(budget), metric)

    def brute_force_knn(self, q, k: int, metric: str = "l2",
                        precision: str = "highest",
                        query_chunk: Optional[int] = None):
        """Exact kNN by full scan (ground-truth oracle).  ``query_chunk``
        processes the batch in one device dispatch, ``query_chunk``
        queries at a time (large batches; dense data only)."""
        if self.x is None:
            raise ValueError("dataset dropped (drop_dataset); brute "
                             "force needs the raw rows")
        qb = _as_dense_queries(q, self.dim)
        if self.n_folded and isinstance(self.x, EllMatrix):
            # sparse rows cannot concatenate with the dense folded rows:
            # scan them separately and merge
            d, ids = _brute_force(self.x, self.sq_norms, qb, int(k),
                                  metric, precision)
            return self._merge_folded(qb, d, ids, int(k), metric,
                                      precision)
        x, sq = self._with_folded()  # ground truth covers folded rows too
        if query_chunk and not isinstance(x, EllMatrix):
            qb, b, ch = _pad_to_chunk(qb, query_chunk)
            d, ids = _brute_force_many(x, sq, qb, int(k),
                                       metric, precision, ch)
            return d[:b], ids[:b]
        return _brute_force(x, sq, qb, int(k), metric,
                            precision)

    def payload_of(self, ids) -> list:
        """Resolve row ids to payloads (None where id < 0 or no payloads).
        Ids past the indexed points resolve into the pending (freshness)
        buffer's payloads."""
        ids = np.asarray(ids)
        pending = sum(getattr(self, "_pending_payloads", None) or [], [])
        folded = getattr(self, "_folded_payloads", None) or []

        def one(i):
            i = int(i)
            if i < 0:
                return None
            if i >= self.plan.n:
                j = i - self.plan.n
                if j < len(folded):  # fold-appended rows come first
                    return folded[j]
                j -= len(folded)
                return pending[j] if j < len(pending) else None
            if self.payloads is None:
                return i
            return self.payloads[i]

        return [one(i) for i in ids.reshape(-1)]

    def __repr__(self):
        return (f"RPForest(trees={self.n_trees}, n={self.n_points}, "
                f"dim={self.dim}, {self.plan!r})")


# ---------------------------------------------------------------------------
# batch construction facades (reference Batch.hs)
# ---------------------------------------------------------------------------

def _prepare_data(data, dtype=jnp.float32):
    if isinstance(data, EllMatrix):
        x = EllMatrix(data.dim, jnp.asarray(data.cols), jnp.asarray(data.vals, dtype=dtype))
        return x, ell_sq_norms(x), x.dim, x.n
    x = jnp.asarray(data, dtype=dtype)
    if x.ndim != 2:
        raise ValueError(f"dataset must be [n, dim], got shape {x.shape}")
    return x, jnp.sum(x * x, axis=-1), int(x.shape[1]), int(x.shape[0])


def forest_batch(seed, max_depth: int, min_leaf: int, n_trees: int,
                 pnz: float, data, payloads: Optional[Sequence] = None,
                 dtype=jnp.float32, pack=False) -> RPForest:
    """Batch-build a random projection forest (reference ``forestBatch``,
    ``src/Data/RPTree/Batch.hs:48-63``): sample ``n_trees x max_depth``
    sparse Gaussian projection vectors from the seed, then run the
    level-synchronous builder with a tree axis.

    ``pack=True`` (or a dtype, e.g. ``jnp.bfloat16``) immediately applies
    the leaf-blocked serving layout (:meth:`RPForest.pack_leaves`) --
    the ~10x-faster query path, at ~``n_trees`` extra copies of the
    dataset in HBM."""
    x, sq_norms, dim, n = _prepare_data(data, dtype)
    plan = make_plan(n, max_depth, min_leaf)
    r = rgen.sample_projections(seed, n_trees, max_depth, dim, pnz)
    build = jax.jit(build_forest_arrays, static_argnums=0)
    arrays = build(plan, x, r)
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth, min_leaf=min_leaf,
                       proj_nz_density=pnz, dim=dim)
    f = RPForest(plan, arrays, x, sq_norms, cfg, payloads=payloads, seed=seed)
    if pack:
        f.pack_leaves(dtype=None if pack is True else pack)
    return f


def tree_batch(seed, max_depth: int, min_leaf: int, pnz: float, data,
               payloads: Optional[Sequence] = None, dtype=jnp.float32) -> RPForest:
    """Batch-build a single tree (reference ``treeBatch``, Batch.hs:29-41):
    a forest with one tree."""
    return forest_batch(seed, max_depth, min_leaf, 1, pnz, data,
                        payloads=payloads, dtype=dtype)
