"""Batched level-synchronous query traversal.

The reference descends the pointer tree per query, forking into both
subtrees when the query lands close to a cut plane -- the exact decision
table at ``src/Data/RPTree.hs:309-314``:

    proj < thr && dl > dr  -> BOTH
    proj < thr             -> LEFT
    proj > thr && dl < dr  -> BOTH
    otherwise              -> RIGHT

with ``dl = |margin_lo - proj|``, ``dr = |margin_hi - proj|``.

Here the whole query batch advances one level at a time over a fixed-size
*frontier* of tree nodes per (query, tree).  Forking appends the second
child to the frontier; when the frontier overflows its budget, entries with
the largest margin-priority are dropped (the same priority the reference's
``candidatesH`` uses: the running minimum of margin distances along the
path, ``RPTree.hs:317-346``).  With ``budget >= n_leaves`` the traversal is
exact (identical leaf set to the reference's ``candidates``).

Layout note: all per-level state is kept as ``[F, B]`` -- the (large)
query batch on the minor axis, the (small) frontier on the major one, so
every elementwise op runs over the full batch.  The 2F -> F frontier
compaction is a bitonic sorting network expressed as
``min``/``max``/``where`` along the frontier axis (F is a static power-of-2
after padding), which XLA fuses into a handful of elementwise ops -- no
``sort``/``top_k`` call, no layout change.

Encoding: a frontier entry is an int32 -- ``>= 0`` means "split-segment
index at the current level", ``< 0`` (but not INVALID) encodes a terminal
leaf as ``-(leaf_id + 1)``, and ``INVALID`` (int32 min) is an empty slot.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.plan import TreePlan

__all__ = ["traverse_tree", "INVALID_ENC", "VALID_PRIO_CAP", "bitonic_sort_kv",
           "build_b1_tables"]

INVALID_ENC = jnp.iinfo(jnp.int32).min
# priorities of live entries are capped at a large finite value so that empty
# (infinite-priority) slots always lose the compaction
VALID_PRIO_CAP = jnp.float32(3.0e38)


def _next_pow2(m: int) -> int:
    p = 1
    while p < m:
        p *= 2
    return p


def bitonic_sort_kv(pri: jax.Array, enc: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sort ``(pri, enc)`` rows ascending by ``pri`` along axis 0.

    ``pri: f32[M, B]``, ``enc: int32[M, B]`` with M a power of two.  A
    classic bitonic network of ``min/max/where`` ops -- every stage is a
    full-lane-width VPU op over the batch axis, which is the reason this
    beats ``lax.top_k`` (whose reduction axis would have to be the minor
    axis) for small M.
    """
    m, b = pri.shape
    assert m & (m - 1) == 0, f"M must be a power of two, got {m}"
    idx = np.arange(m)
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            # partner index is idx ^ j: swapping j-sized blocks pairwise,
            # expressed as reshape + reversed slice (no gather)
            shape = (m // (2 * j), 2, j, b)
            p_o = jnp.flip(pri.reshape(shape), axis=1).reshape(m, b)
            e_o = jnp.flip(enc.reshape(shape), axis=1).reshape(m, b)
            keep_min = ((idx & k) == 0) == (idx < (idx ^ j))
            keep_min = jnp.asarray(keep_min[:, None])
            # lexicographic (pri, enc) comparison: priority ties are common
            # (forked siblings inherit the same running path-minimum), and a
            # plain `<` would make both pair elements pick the same side,
            # duplicating one entry and LOSING the other.  Live encodings
            # are distinct tree nodes, so (pri, enc) is a strict total
            # order on live entries.
            other_is_min = (p_o < pri) | ((p_o == pri) & (e_o < enc))
            p_min = jnp.where(other_is_min, p_o, pri)
            e_min = jnp.where(other_is_min, e_o, enc)
            p_max = jnp.where(other_is_min, pri, p_o)
            e_max = jnp.where(other_is_min, enc, e_o)
            pri = jnp.where(keep_min, p_min, p_max)
            enc = jnp.where(keep_min, e_min, e_max)
            j //= 2
        k *= 2
    return pri, enc


# up to this table size the one-hot expansion is cheaper than one gather
_ONEHOT_MAX = 64


def _lookup_level(thr_l, mgl_l, mgh_l, child_l, seg):
    """All five per-level node-table lookups for frontier ``seg [F, B]``.

    A gather's cost follows its number of INDICES more than its payload,
    so the five separate ``table[seg]`` lookups (threshold, two margins,
    two children) that a naive traversal issues per level dominate its
    runtime.  Two regimes:

    * small tables (``n_segs <= 64``, the upper tree levels): a single
      one-hot compare reused for all five select-and-sum reductions --
      pure elementwise work, no gather at all;
    * large tables (the deep levels): pack all five columns into ONE
      ``f32[n_segs, 8]`` row (child ints bitcast to f32, values preserved
      through the gather) and issue a single row gather -- 1/5th the
      index count of the naive form.

    Returns ``(thr, lo, hi, lc, rc)`` each shaped like ``seg``.
    """
    ns = thr_l.shape[0]
    if ns == 1:
        b = lambda a: jnp.broadcast_to(a[0], seg.shape)  # noqa: E731
        return (b(thr_l), b(mgl_l), b(mgh_l),
                b(child_l[:, 0]), b(child_l[:, 1]))
    if ns <= _ONEHOT_MAX:
        shape = (ns,) + (1,) * seg.ndim
        oh = seg[None, ...] == jnp.arange(ns, dtype=seg.dtype).reshape(shape)

        def pick(col):
            zero = jnp.zeros((), dtype=col.dtype)
            return jnp.sum(jnp.where(oh, col.reshape(shape), zero), axis=0)

        return (pick(thr_l), pick(mgl_l), pick(mgh_l),
                pick(child_l[:, 0]), pick(child_l[:, 1]))
    packed = jnp.stack(
        [thr_l, mgl_l, mgh_l,
         jax.lax.bitcast_convert_type(child_l[:, 0], jnp.float32),
         jax.lax.bitcast_convert_type(child_l[:, 1], jnp.float32)],
        axis=-1,
    )  # [ns, 5]
    vals = jnp.take(packed, seg, axis=0)  # [F, B, 5] -- ONE gather
    lc = jax.lax.bitcast_convert_type(vals[..., 3], jnp.int32)
    rc = jax.lax.bitcast_convert_type(vals[..., 4], jnp.int32)
    return vals[..., 0], vals[..., 1], vals[..., 2], lc, rc


def traverse_tree(
    plan: TreePlan,
    thr: jax.Array,
    mgl: jax.Array,
    mgh: jax.Array,
    projq: jax.Array,
    budget: int,
    tabs=None,
    toff=None,
) -> Tuple[jax.Array, jax.Array]:
    """Traverse one tree with a batch of queries.

    Args:
      plan: static tree shape.
      thr/mgl/mgh: ``f32[L, S_max]`` threshold and margin arrays (level
        ``l`` uses entries ``[0, n_segs_l)``; the padded tail is unread).
      projq: ``f32[B, L]`` query projections (``q . r_l`` per level).
      budget: frontier width F (>= 1).  ``F >= plan.n_leaves`` is exact.
      tabs: optional prebuilt :func:`build_b1_tables` output; pass it
        when traversing inside a ``lax.map`` chunk loop so the superlevel
        tables hoist out of the loop as closure constants.  May hold the
        FLAT all-tree layout (``[T * S0, ...]`` rows) -- then ``toff``
        (scalar tree index) selects this tree's span.  Gathers through a
        vmap-batched table carry a batch dimension on every index, which
        is why the forest-level callers always pass flat tables.
      toff: scalar tree index into flat ``tabs`` (None = tables are
        per-tree).

    Returns:
      ``(leaf_ids int32[B, F]`` with ``-1`` for empty slots,
      ``prio f32[B, F]`` -- the reference's ``candidatesH`` margin priority).
    """
    if int(budget) == 1:
        return _traverse_b1(plan, thr, mgl, mgh, projq, tabs, toff)
    if 2 <= int(budget) <= _FK_MAX_BUDGET and _b1_blocks(plan):
        return _traverse_fk(plan, thr, mgl, mgh, projq, int(budget), tabs,
                            toff)
    return _traverse_frontier(plan, thr, mgl, mgh, projq, budget)


def _traverse_frontier(
    plan: TreePlan,
    thr: jax.Array,
    mgl: jax.Array,
    mgh: jax.Array,
    projq: jax.Array,
    budget: int,
) -> Tuple[jax.Array, jax.Array]:
    """The general fixed-frontier traversal (any budget F >= 1)."""
    b = projq.shape[0]
    f = int(budget)
    projq = projq.T  # [L, B]: queries on lanes

    fenc = jnp.full((f, b), INVALID_ENC, dtype=jnp.int32)
    fpri = jnp.full((f, b), jnp.inf, dtype=jnp.float32)
    fenc = fenc.at[0, :].set(plan.root_enc)
    # reference candidatesH starts the path priority at infinity
    # (RPTree.hs:322-324); capped finite so live entries beat empty slots
    fpri = fpri.at[0, :].set(VALID_PRIO_CAP)

    m = _next_pow2(2 * f)

    for l, lp in enumerate(plan.levels):
        is_seg = fenc >= 0
        seg = jnp.clip(fenc, 0, lp.n_segs - 1)
        t, lo, hi, lc, rc = _lookup_level(
            thr[l][: lp.n_segs], mgl[l][: lp.n_segs], mgh[l][: lp.n_segs],
            jnp.asarray(lp.child_enc), seg,
        )
        proj = projq[l][None, :]  # [1, B]
        dl = jnp.abs(lo - proj)
        dr = jnp.abs(hi - proj)
        lt = proj < t
        gt = proj > t
        go_both = (lt & (dl > dr)) | (gt & (dl < dr))
        go_left = lt | go_both
        go_right = (~lt) | go_both
        pl = jnp.minimum(fpri, dl)
        pr = jnp.minimum(fpri, dr)
        # slot bank 1: descend-left entries, or pass-through (leaf / empty)
        enc_l = jnp.where(is_seg, jnp.where(go_left, lc, INVALID_ENC), fenc)
        pri_l = jnp.where(is_seg, jnp.where(go_left, pl, jnp.inf), fpri)
        # slot bank 2: descend-right entries
        take_r = is_seg & go_right
        enc_r = jnp.where(take_r, rc, INVALID_ENC)
        pri_r = jnp.where(take_r, pr, jnp.inf)
        enc2 = jnp.concatenate([enc_l, enc_r], axis=0)  # [2F, B]
        pri2 = jnp.where(enc2 == INVALID_ENC,
                         jnp.inf,
                         jnp.concatenate([pri_l, pri_r], axis=0))
        if m > 2 * f:  # pad to a power of two for the network
            pad = ((0, m - 2 * f), (0, 0))
            enc2 = jnp.pad(enc2, pad, constant_values=INVALID_ENC)
            pri2 = jnp.pad(pri2, pad, constant_values=jnp.inf)
        # compact 2F -> F keeping the lowest margin priorities
        pri_s, enc_s = bitonic_sort_kv(pri2, enc2)
        fenc = enc_s[:f, :]
        fpri = pri_s[:f, :]

    leaf_ids = jnp.where(fenc == INVALID_ENC, -1, -(fenc + 1))
    return leaf_ids.T, fpri.T


# ---------------------------------------------------------------------------
# budget=1 superlevel fast path
# ---------------------------------------------------------------------------
#
# With a frontier of ONE the per-level compaction degenerates to picking the
# lexicographic (priority, enc) minimum of the <=2 children -- a pure scalar
# descent per query.  That removes the bitonic network, and (the actual win)
# lets the deep levels' node-table lookups be fetched as whole SUBTREES: one
# row gather per ~6 levels instead of one per level.  A gather's cost
# follows its INDEX count, so packing a k-level subtree (2^k - 1
# nodes x 5 values) into one table row divides the traversal's gather count
# by k; the in-register descent over the fetched row is one-hot select-sums
# (full-lane VPU ops) whose cost (~sum 2^i * 5 per block) is negligible.
# Semantics are pinned to `_traverse_frontier(budget=1)` exactly, including
# the (pri, enc) lexicographic fork tie-break (test_traverse_fast.py).

# cap on levels per superlevel block: row width (2^k - 1) * 5 f32 and the
# last sub-step's one-hot width 2^(k-1) both grow exponentially; 6 keeps the
# row at 315 f32 (~1.3 KB) and the widest one-hot at 32 lanes of selects
_B1_MAX_DEPTH = 6


@dataclasses.dataclass(frozen=True)
class _B1Block:
    """Static maps for one superlevel block of ``kd`` levels from ``l0``.

    ``flat_pos [S0, P-1]``: gather index into the flattened ``[L * S_max]``
    threshold arrays for the node at heap position ``p`` (column ``p - 1``;
    position 1 is the block-top segment itself, children of ``p`` are
    ``2p``/``2p+1``).  ``lcrc [S0, P-1, 2]``: the node's static child
    encodings.  Dead positions (below a leaf) are clipped to index 0 and
    never read live."""

    l0: int
    kd: int
    s0: int
    flat_pos: np.ndarray
    lcrc: np.ndarray


def _b1_build_blocks(plan: TreePlan, s_max: int) -> List[_B1Block]:
    blocks: List[_B1Block] = []
    l = 0
    while l < plan.n_levels:
        if plan.levels[l].n_segs <= _ONEHOT_MAX:
            l += 1
            continue
        kd = min(_B1_MAX_DEPTH, plan.n_levels - l)
        s0 = plan.levels[l].n_segs
        p = 1 << kd
        flat_pos = np.zeros((s0, p - 1), np.int32)
        lcrc = np.zeros((s0, p - 1, 2), np.int32)
        # enc of every node in layer i (positions 2^i .. 2^(i+1)-1), walked
        # level-order; a node's children interleave in position order
        enc_layer = np.arange(s0, dtype=np.int32)[:, None]  # [S0, 1]
        col = 0
        for i in range(kd):
            lp = plan.levels[l + i]
            live = enc_layer >= 0
            seg = np.clip(enc_layer, 0, lp.n_segs - 1)
            lc = np.where(live, lp.child_enc[seg, 0], 0).astype(np.int32)
            rc = np.where(live, lp.child_enc[seg, 1], 0).astype(np.int32)
            w = 1 << i
            flat_pos[:, col : col + w] = (l + i) * s_max + np.where(
                live, seg, 0
            )
            lcrc[:, col : col + w, 0] = lc
            lcrc[:, col : col + w, 1] = rc
            enc_layer = np.stack([lc, rc], axis=-1).reshape(s0, 2 * w)
            col += w
        blocks.append(_B1Block(l0=l, kd=kd, s0=s0, flat_pos=flat_pos,
                               lcrc=lcrc))
        l += kd
    return blocks


def _b1_blocks(plan: TreePlan) -> List[_B1Block]:
    """Cached per-plan block maps (plans are immutable and themselves
    cached); empty when no level exceeds the one-hot size.

    Child encodings ride the table as exact f32 VALUES (not bitcast bit
    patterns: those are NaN payloads for negative encs and denormals for
    small positive ones, and XLA lowerings may move gathered data
    through arithmetic -- canonicalizing NaNs and flushing denormals --
    which corrupts the descent into an all-masked traversal).  Exactness needs |enc| < 2^24, so plans beyond
    that disable the fast path (the frontier handles them)."""
    cached = getattr(plan, "_b1_cache", None)
    if cached is None:
        smax = max((lp.n_segs for lp in plan.levels), default=1)
        if max(smax, plan.n_leaves + 1) >= (1 << 24):
            blocks: List[_B1Block] = []
        else:
            blocks = _b1_build_blocks(plan, smax)
        cached = (blocks, smax)
        plan._b1_cache = cached
    return cached[0]


def build_b1_tables(plan: TreePlan, thr, mgl, mgh):
    """Build the budget=1 superlevel tables from one tree's runtime
    threshold/margin arrays: per block a ``f32[S0, P-1, 5]`` of
    (thr, mgl, mgh, lc, rc) per subtree node (child encs as exact f32
    values -- see :func:`_b1_blocks`).  One small
    gather per block -- call once per dispatch (or vmap over trees) and
    pass the result through :func:`traverse_tree` so chunk loops reuse it
    as a closure constant."""
    blocks = _b1_blocks(plan)
    if not blocks:
        return ()
    _, smax = plan._b1_cache
    nl = plan.n_levels
    stacked = jnp.stack(
        [thr[:nl, :smax], mgl[:nl, :smax], mgh[:nl, :smax]], axis=-1
    ).reshape(nl * smax, 3)
    tabs = []
    for blk in blocks:
        flat = jnp.asarray(blk.flat_pos.reshape(-1))
        g = jnp.take(stacked, flat, axis=0).reshape(blk.s0, -1, 3)
        # child encodings as exact f32 VALUES (see _b1_blocks docstring)
        ci = jnp.asarray(blk.lcrc.astype(np.float32))
        tabs.append(jnp.concatenate([g, ci], axis=-1))  # [S0, P-1, 5]
    return tuple(tabs)


def _b1_step(enc, pri, t, lo, hi, lc, rc, proj):
    """One budget=1 decision: the 4-case margin table + the frontier
    compaction's lexicographic (pri, enc) minimum over the <=2 children.
    Frozen (leaf) entries pass through.  Returns (enc, pri, went_right)."""
    is_seg = enc >= 0
    dl = jnp.abs(lo - proj)
    dr = jnp.abs(hi - proj)
    lt = proj < t
    go_both = (lt & (dl > dr)) | ((proj > t) & (dl < dr))
    go_left = lt | go_both
    pl = jnp.minimum(pri, dl)
    pr = jnp.minimum(pri, dr)
    lex_right = (pr < pl) | ((pr == pl) & (rc < lc))
    right = jnp.where(go_both, lex_right, ~go_left)
    enc2 = jnp.where(is_seg, jnp.where(right, rc, lc), enc)
    pri2 = jnp.where(is_seg, jnp.where(right, pr, pl), pri)
    return enc2, pri2, right & is_seg


# fixed-frontier budgets up to this use the superlevel tables too: each
# frontier slot fetches its block-top subtree row ONCE per kd levels
# (budget gathers per block instead of budget per level) and the per-level
# expansion/compaction runs on (pri, enc) exactly as `_traverse_frontier`,
# with (source slot, heap position) riding the bitonic as an aux payload.
# The one-hot data reconstruction costs ~budget^2 * 2^i selects per
# sub-step, so big budgets keep the plain frontier path.
_FK_MAX_BUDGET = 8


def _bitonic_sort_kva(pri, enc, aux):
    """:func:`bitonic_sort_kv` carrying one extra int32 payload operand
    (moves with its (pri, enc) pair; live (pri, enc) keys are unique, so
    payload order is well-defined)."""
    m, b = pri.shape
    assert m & (m - 1) == 0, f"M must be a power of two, got {m}"
    idx = np.arange(m)
    k = 2
    while k <= m:
        j = k // 2
        while j >= 1:
            shape = (m // (2 * j), 2, j, b)
            p_o = jnp.flip(pri.reshape(shape), axis=1).reshape(m, b)
            e_o = jnp.flip(enc.reshape(shape), axis=1).reshape(m, b)
            a_o = jnp.flip(aux.reshape(shape), axis=1).reshape(m, b)
            keep_min = ((idx & k) == 0) == (idx < (idx ^ j))
            keep_min = jnp.asarray(keep_min[:, None])
            other_is_min = (p_o < pri) | ((p_o == pri) & (e_o < enc))
            p_min = jnp.where(other_is_min, p_o, pri)
            e_min = jnp.where(other_is_min, e_o, enc)
            a_min = jnp.where(other_is_min, a_o, aux)
            p_max = jnp.where(other_is_min, pri, p_o)
            e_max = jnp.where(other_is_min, enc, e_o)
            a_max = jnp.where(other_is_min, aux, a_o)
            pri = jnp.where(keep_min, p_min, p_max)
            enc = jnp.where(keep_min, e_min, e_max)
            aux = jnp.where(keep_min, a_min, a_max)
            j //= 2
        k *= 2
    return pri, enc, aux


def _fk_level_step(fenc, fpri, faux, t, lo, hi, lc, rc, proj, m, f,
                   child_aux):
    """One frontier level exactly as `_traverse_frontier`, with the data
    already looked up and an aux payload tracking each entry's (source
    slot, heap position).  ``child_aux(faux, right)`` computes the aux of
    a descended child."""
    is_seg = fenc >= 0
    dl = jnp.abs(lo - proj)
    dr = jnp.abs(hi - proj)
    lt = proj < t
    gt = proj > t
    go_both = (lt & (dl > dr)) | (gt & (dl < dr))
    go_left = lt | go_both
    go_right = (~lt) | go_both
    pl = jnp.minimum(fpri, dl)
    pr = jnp.minimum(fpri, dr)
    enc_l = jnp.where(is_seg, jnp.where(go_left, lc, INVALID_ENC), fenc)
    pri_l = jnp.where(is_seg, jnp.where(go_left, pl, jnp.inf), fpri)
    aux_l = jnp.where(is_seg, child_aux(faux, False), faux)
    take_r = is_seg & go_right
    enc_r = jnp.where(take_r, rc, INVALID_ENC)
    pri_r = jnp.where(take_r, pr, jnp.inf)
    aux_r = child_aux(faux, True)
    enc2 = jnp.concatenate([enc_l, enc_r], axis=0)  # [2F, B]
    pri2 = jnp.where(enc2 == INVALID_ENC,
                     jnp.inf,
                     jnp.concatenate([pri_l, pri_r], axis=0))
    aux2 = jnp.concatenate([aux_l, aux_r], axis=0)
    if m > 2 * f:
        pad = ((0, m - 2 * f), (0, 0))
        enc2 = jnp.pad(enc2, pad, constant_values=INVALID_ENC)
        pri2 = jnp.pad(pri2, pad, constant_values=jnp.inf)
        aux2 = jnp.pad(aux2, pad, constant_values=0)
    pri_s, enc_s, aux_s = _bitonic_sort_kva(pri2, enc2, aux2)
    return enc_s[:f, :], pri_s[:f, :], aux_s[:f, :]


def _traverse_fk(plan, thr, mgl, mgh, projq, budget, tabs=None,
                 toff=None):
    """Small-budget traversal over the superlevel tables: per block each
    frontier slot gathers its subtree row once; the per-level frontier
    semantics (4-case table, forks, compaction) are `_traverse_frontier`'s
    exactly (pinned in test_traverse_fast.py)."""
    b = projq.shape[0]
    f = int(budget)
    projq = projq.T  # [L, B]
    blocks = _b1_blocks(plan)
    if tabs is None:
        tabs = build_b1_tables(plan, thr, mgl, mgh)
        toff = None
    m = _next_pow2(2 * f)

    fenc = jnp.full((f, b), INVALID_ENC, dtype=jnp.int32)
    fpri = jnp.full((f, b), jnp.inf, dtype=jnp.float32)
    faux = jnp.zeros((f, b), dtype=jnp.int32)
    fenc = fenc.at[0, :].set(plan.root_enc)
    fpri = fpri.at[0, :].set(VALID_PRIO_CAP)

    no_aux = lambda aux, right: aux  # noqa: E731
    bi = 0
    l = 0
    while l < plan.n_levels:
        lp = plan.levels[l]
        if bi < len(blocks) and blocks[bi].l0 == l:
            blk, tab = blocks[bi], tabs[bi]
            bi += 1
            # one subtree-row gather per frontier slot for the whole block
            ix = jnp.clip(fenc, 0, blk.s0 - 1)
            if toff is not None:
                ix = ix + toff * blk.s0
            rows = jnp.take(tab, ix.reshape(-1),
                            axis=0).reshape(f, b, -1, 5)  # [F, B, P-1, 5]
            # aux = src * 2^kd + heap position (src: which fetched row)
            pw = 1 << blk.kd
            faux = jnp.broadcast_to(
                jnp.arange(f, dtype=jnp.int32)[:, None] * pw + 1, (f, b))
            # child aux: src field unchanged, pos -> 2*pos + right (the
            # final sub-step may carry pos past the field width; it is
            # never read -- the next block regenerates faux)
            child = lambda aux, right: (aux & ~(pw - 1)) + 2 * (  # noqa: E731
                aux & (pw - 1)) + (1 if right else 0)
            for i in range(blk.kd):
                w = 1 << i
                sub = rows[:, :, w - 1 : 2 * w - 1, :]   # [F', B, 2^i, 5]
                src = faux // pw
                pos = faux & (pw - 1)
                oh = ((src[:, :, None, None]
                       == jnp.arange(f, dtype=jnp.int32)[None, None, :,
                                                         None])
                      & (pos[:, :, None, None]
                         == jnp.arange(w, 2 * w,
                                       dtype=jnp.int32)[None, None, None,
                                                        :]))
                # [F, B, F', 2^i] x [F', B, 2^i, 5] -> [F, B, 5]
                vals = jnp.sum(
                    jnp.where(oh[..., None],
                              jnp.transpose(sub, (1, 0, 2, 3))[None, ...],
                              0.0),
                    axis=(2, 3))
                vc = vals[..., 3:5].astype(jnp.int32)
                fenc, fpri, faux = _fk_level_step(
                    fenc, fpri, faux, vals[..., 0], vals[..., 1],
                    vals[..., 2], vc[..., 0], vc[..., 1],
                    projq[l + i][None, :], m, f, child)
            l += blk.kd
        else:
            seg = jnp.clip(fenc, 0, lp.n_segs - 1)
            t, lo, hi, lc, rc = _lookup_level(
                thr[l][: lp.n_segs], mgl[l][: lp.n_segs],
                mgh[l][: lp.n_segs], jnp.asarray(lp.child_enc), seg)
            fenc, fpri, faux = _fk_level_step(
                fenc, fpri, faux, t, lo, hi, lc, rc, projq[l][None, :],
                m, f, no_aux)
            l += 1

    leaf_ids = jnp.where(fenc == INVALID_ENC, -1, -(fenc + 1))
    return leaf_ids.T, fpri.T


def _traverse_b1(plan, thr, mgl, mgh, projq, tabs=None, toff=None):
    """Budget=1 traversal: shallow levels via the one-hot lookup, deep
    levels via superlevel subtree rows (one gather per block)."""
    b = projq.shape[0]
    projq = projq.T  # [L, B]
    blocks = _b1_blocks(plan)
    if tabs is None:
        tabs = build_b1_tables(plan, thr, mgl, mgh)
        toff = None
    enc = jnp.full((b,), plan.root_enc, dtype=jnp.int32)
    pri = jnp.full((b,), VALID_PRIO_CAP, dtype=jnp.float32)
    bi = 0
    l = 0
    while l < plan.n_levels:
        lp = plan.levels[l]
        if bi < len(blocks) and blocks[bi].l0 == l:
            blk, tab = blocks[bi], tabs[bi]
            bi += 1
            ix = jnp.clip(enc, 0, blk.s0 - 1)
            if toff is not None:
                ix = ix + toff * blk.s0
            row_f = jnp.take(tab, ix, axis=0)
            pos = jnp.ones((b,), dtype=jnp.int32)
            for i in range(blk.kd):
                w = 1 << i
                sub_f = row_f[:, w - 1 : 2 * w - 1, :]    # [B, 2^i, 5]
                oh = pos[:, None] == jnp.arange(
                    w, 2 * w, dtype=jnp.int32)[None, :]
                vf = jnp.sum(jnp.where(oh[..., None], sub_f, 0.0), axis=1)
                # columns 3:5 are exact-integer-valued f32 child encodings
                vc = vf[:, 3:5].astype(jnp.int32)
                enc, pri, right = _b1_step(
                    enc, pri, vf[:, 0], vf[:, 1], vf[:, 2],
                    vc[:, 0], vc[:, 1], projq[l + i])
                pos = 2 * pos + right.astype(jnp.int32)
            l += blk.kd
        else:
            seg = jnp.clip(enc, 0, lp.n_segs - 1)[None, :]
            t, lo, hi, lc, rc = _lookup_level(
                thr[l][: lp.n_segs], mgl[l][: lp.n_segs],
                mgh[l][: lp.n_segs], jnp.asarray(lp.child_enc), seg)
            enc, pri, _ = _b1_step(enc, pri, t[0], lo[0], hi[0],
                                   lc[0], rc[0], projq[l])
            l += 1
    leaf_ids = jnp.where(enc == INVALID_ENC, -1, -(enc + 1))
    return leaf_ids[:, None], pri[:, None]
