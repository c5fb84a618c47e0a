"""Query-grouped block-resident rerank.

The leaf-blocked rerank (:func:`rptree_tpu.models.forest._score_blocks`)
fetches each probed leaf block once PER (query, probe) pair -- on clustered
data, where many queries in a batch probe the same blocks (their shared
cluster's leaves), the same bytes stream from device memory over and
over, and the contraction is a per-query GEMV.  This module restructures
the scoring as small matrix products:

1. flatten the batch's (query, probe) pairs and sort them by probed block
   id (one 2-operand ``lax.sort``);
2. chop each equal-block run into TILES of at most ``tile_m`` pairs -- a
   tile references exactly ONE block;
3. per tile: fetch the resident block once, gather the tile's ``tile_m``
   query rows, and score with ONE ``[tile_m, D] x [D, lmax]`` matmul
   (batched over a chunk of tiles as one einsum here; the Triton kernel
   of :mod:`.grouped_kernel` scores each tile without materializing the
   gathered blocks);
4. scatter each pair's distance row back to its slot; the caller then
   runs the UNCHANGED selection tail of the per-pair path (ids fetched as
   whole blocks, payload-carrying sort, top-k merge).

Step 3 fetches each distinct block once per TILE instead of once per pair:
with mean group size ``c`` the block-fetch bytes drop ~``min(c, tile_m)``x
and the contraction runs at matmul rate.  The selection tail stays the
per-pair path's -- results are bit-comparable by construction.

Numerics: f32 blocks contract at an accuracy floor regardless of the
caller's knob (:func:`f32_dot_precision`, shared with the kernel path):
a single reduced-precision pass (one TF32 pass on the GPU) loses
ranking accuracy on near-equidistant clustered data, where distances
are small differences of large squared norms, so any setting below
``"highest"`` runs the 3-pass TF32 algorithm.  An explicit
``"highest"`` is honored; bf16/int8 blocks keep their native
pipelines.

Static shapes: the number of tiles ``sum_g ceil(c_g / tile_m)`` is
data-dependent, so the kernel takes a static tile capacity ``nt`` and
reports the tiles it actually NEEDED; pairs beyond the capacity are
masked (their slots return +inf).  The caller (``RPForest.knn_grouped``)
checks the returned count and retries with the next capacity bucket --
results are exact whenever ``needed <= nt``.  Reference analogue: the
rerank fold of ``knn`` (``src/Data/RPTree.hs:159-176``); the grouping
itself is a restructuring for the accelerator with no reference
counterpart.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .rerank import distances_from_dots
from .shared import fetch_blocks
from .sparse import EllBlocks

__all__ = ["grouped_distances", "grouped_distances_kernel",
           "f32_dot_precision"]

_BIG = 1 << 30  # sentinel block id for masked pairs (sorts to the end)


def _tile_tables(gsel, lsel, tile_m: int, nt: int, with_slots=False):
    """Sort the batch's (query, probe) pairs by block id and chop equal-
    block runs into tiles of at most ``tile_m`` pairs (pure sort +
    cumulative ops, no gathers).  Returns ``(tb int32[nt], tp
    int32[nt, tile_m], needed int32[])``: per-tile block id, per-slot
    pair index (-1 = empty slot), and the tiles actually needed
    (exact iff ``needed <= nt``; overflow pairs land in a dropped trash
    tile).

    ``with_slots`` appends ``slot int32[b * p]``: each PAIR's flat tile
    slot ``tid * tile_m + row`` (``nt * tile_m`` for pairs in no tile --
    masked probes and capacity overflow), i.e. the inverse of ``tp``.
    It rides ONE extra flat sort on the already-sorted pair ids instead
    of a per-pair scatter (`.at[dest].set(iota)`)."""
    b, p = gsel.shape
    e = b * p
    g_flat = jnp.where(lsel >= 0, gsel, _BIG).reshape(e)
    pair = jnp.arange(e, dtype=jnp.int32)
    g_s, pair_s = lax.sort((g_flat, pair), num_keys=1)
    pos = jnp.arange(e, dtype=jnp.int32)
    new = jnp.concatenate(
        [jnp.ones((1,), bool), g_s[1:] != g_s[:-1]])
    seg_start = lax.cummax(jnp.where(new, pos, 0))
    rank = pos - seg_start
    valid_s = g_s < _BIG
    tile_start = (new | (rank % tile_m == 0)) & valid_s
    tile_id = jnp.cumsum(tile_start.astype(jnp.int32)) - 1
    needed = tile_id[-1] + 1
    ok = valid_s & (tile_id >= 0) & (tile_id < nt)
    tid = jnp.where(ok, tile_id, nt)  # capacity overflow -> trash tile
    row = rank % tile_m
    tile_block = jnp.zeros((nt + 1,), jnp.int32).at[tid].set(
        jnp.where(ok, g_s, 0), mode="drop")
    tile_pair = jnp.full((nt + 1, tile_m), -1, jnp.int32).at[tid, row].set(
        jnp.where(ok, pair_s, -1), mode="drop")
    if not with_slots:
        return tile_block[:nt], tile_pair[:nt], needed
    slot_s = jnp.where(ok, tile_id * tile_m + row, nt * tile_m)
    _, slot = lax.sort((pair_s, slot_s), num_keys=1)
    return tile_block[:nt], tile_pair[:nt], needed, slot


def f32_dot_precision(precision):
    """The dot precision f32 blocks contract at under the caller's
    ``precision`` (a ``lax.Precision``), on both the XLA and the kernel
    path: ``HIGHEST`` is IEEE f32; any lower setting gets the 3-pass TF32
    algorithm on the GPU, whose single TF32 pass loses ranking accuracy
    (see the module docstring), and IEEE f32 on other backends, which
    have no TF32 algorithms."""
    if precision == lax.Precision.HIGHEST or jax.default_backend() != "gpu":
        return lax.Precision.HIGHEST
    return lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _quantize_rows(qrows):
    """Symmetric per-row int8 quantization of query rows ``[..., D]``;
    returns (int8 rows, f32 scale [..., 1])."""
    amax = jnp.max(jnp.abs(qrows), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-30) / 127.0
    qi = jnp.clip(jnp.round(qrows / scale), -127, 127).astype(jnp.int8)
    return qi, scale


def grouped_distances(x_leaf, sq_leaf, lens_of_block, gsel, lsel, q,
                      metric, precision, tile_m: int, nt: int,
                      tile_chunk: int, block_scale=None, block_center=None,
                      row_of=None):
    """Exact distances of every (query, probe) pair, computed block-major.

    Args:
      x_leaf/sq_leaf: packed dense blocks ``[G, lmax, D]`` / ``[G, lmax]``
        (storage-row order), or sparse :class:`EllBlocks` (``cols``/``vals``
        ``[G, lmax, K]``) -- each tile then fetches the (cols, vals) block
        pair once and contracts by gathering the tile's DENSE query rows at
        the stored column indices (the batched ``innerSD`` pointer walk,
        reference ``Internal.hs:369-382``); the block-fetch saving is the
        same, the contraction stays gather-based (no matmul for sparse
        rows).
      lens_of_block: ``int32[G_global]`` occupancy per GLOBAL block id
        (static plan lengths or the dynamic post-fold table).
      gsel/lsel: probe selection ``int32[B, P]`` (global block id / leaf
        id with -1 = masked) from ``_select_probes``.
      q: ``f32[B, D]`` queries.
      tile_m: pairs per tile (the matmul M dimension).
      nt: static tile capacity; must be a multiple of ``tile_chunk``.
      tile_chunk: tiles scored per ``lax.map`` step (bounds peak memory).
      row_of: optional ``int32[G_global]`` global-block-id -> storage-row
        map (leaf-sharded round-robin layouts).

    Returns ``(d f32[B, P, lmax], needed int32[])``: masked slots (invalid
    probes, occupancy padding, capacity overflow) carry +inf.  Exact iff
    ``needed <= nt``.
    """
    b, p = gsel.shape
    e = b * p
    lmax = x_leaf.shape[-2]

    # ---- pair sort + tile assignment (shared with the kernel path) -------
    with jax.named_scope("rpt_tile_tables"):
        tb, tp, needed, inv = _tile_tables(gsel, lsel, tile_m, nt,
                                           with_slots=True)
        lens = jnp.take(lens_of_block, tb)

    # ---- score tile chunks (each materializes only tile_chunk blocks) ----
    rows_of = tb if row_of is None else jnp.take(row_of, tb)
    ns = nt // tile_chunk
    mu = mudr = None
    if block_center is not None:
        mu, mudr = block_center
    # f32 blocks get the accuracy floor (see module docstring); bf16
    # blocks keep the caller's knob, like the per-pair scorer.
    is_ell = isinstance(x_leaf, EllBlocks)
    if not is_ell and x_leaf.dtype == jnp.int8 and mu is None:
        # quantize each query once (a per-row op), then gather its tile
        # rows -- the kernel path shares this exact computation
        q_i8_all, qs_all = _quantize_rows(q)
    if not is_ell and x_leaf.dtype == jnp.float32:
        prec_eff = f32_dot_precision(precision)
    else:
        prec_eff = precision

    def step(args):
        rows_i, tp_i, lens_i = args
        sqb = jnp.take(sq_leaf, rows_i, axis=0)   # [tc, lmax]
        qi = jnp.where(tp_i >= 0, tp_i // p, 0)
        qt = jnp.take(q, qi, axis=0)              # [tc, m, D]
        if is_ell:
            # sparse blocks: one (cols, vals) fetch per tile, query rows
            # gathered at the stored columns (padding is col=0/val=0 and
            # contributes nothing)
            cols = jnp.take(x_leaf.cols, rows_i, axis=0)  # [tc, lmax, K]
            vals = jnp.take(x_leaf.vals, rows_i, axis=0)
            qg = jnp.take_along_axis(
                qt[:, :, None, :], cols[:, None].astype(jnp.int32),
                axis=-1)                          # [tc, m, lmax, K]
            dots = jnp.sum(vals[:, None].astype(jnp.float32) * qg, axis=-1)
            d = distances_from_dots(dots, sqb[:, None, :], qt, metric)
            valid = (tp_i >= 0)[:, :, None] & (
                jnp.arange(lmax, dtype=jnp.int32) < lens_i[:, None, None]
            )
            d = jnp.where(valid, d, jnp.inf)
            tc = rows_i.shape[0]
            return d.reshape(tc * tile_m, lmax)
        # [tc, lmax, D]; per-row id gather on the shared-row layout
        blk = fetch_blocks(x_leaf, rows_i)
        if callable(metric):
            # user distance callable (the reference's distf,
            # RPTree.hs:168) on the resident block vs the tile's query
            # rows; the broadcast fuses into the callable's reduction
            tc = rows_i.shape[0]
            d = metric(
                jnp.broadcast_to(
                    blk[:, None].astype(jnp.float32),
                    (tc, tile_m, blk.shape[-2], blk.shape[-1])),
                qt[:, :, None, :])
            valid = (tp_i >= 0)[:, :, None] & (
                jnp.arange(lmax, dtype=jnp.int32) < lens_i[:, None, None]
            )
            return jnp.where(valid, d, jnp.inf).reshape(tc * tile_m, lmax)
        if blk.dtype == jnp.int8:
            bscale = jnp.take(block_scale, rows_i, axis=0)  # [tc]
            if mu is not None:
                # centered residual blocks: dot(q, x^) =
                #   q.mu + (q - mu).r^ + mu.r^  (last term precomputed)
                mu_i = jnp.take(mu, rows_i, axis=0)      # [tc, D]
                md_i = jnp.take(mudr, rows_i, axis=0)    # [tc, lmax]
                qc = qt - mu_i[:, None, :]
                qc_i8, qscale = _quantize_rows(qc)
                dots_i = jnp.einsum("nmd,nld->nml", qc_i8, blk,
                                    preferred_element_type=jnp.int32)
                q_mu = jnp.einsum("nmd,nd->nm", qt, mu_i,
                                  preferred_element_type=jnp.float32)
                dots = (q_mu[..., None] + md_i[:, None, :]
                        + dots_i.astype(jnp.float32)
                        * bscale[:, None, None] * qscale)
            else:
                q_i8 = jnp.take(q_i8_all, qi, axis=0)
                qscale = jnp.take(qs_all, qi, axis=0)
                dots_i = jnp.einsum("nmd,nld->nml", q_i8, blk,
                                    preferred_element_type=jnp.int32)
                dots = (dots_i.astype(jnp.float32)
                        * bscale[:, None, None] * qscale)
        else:
            dots = jnp.einsum("nmd,nld->nml", qt.astype(blk.dtype), blk,
                              preferred_element_type=jnp.float32,
                              precision=prec_eff)
        d = distances_from_dots(dots, sqb[:, None, :], qt, metric)
        valid = (tp_i >= 0)[:, :, None] & (
            jnp.arange(lmax, dtype=jnp.int32) < lens_i[:, None, None]
        )
        d = jnp.where(valid, d, jnp.inf)
        tc = rows_i.shape[0]
        return d.reshape(tc * tile_m, lmax)

    with jax.named_scope("rpt_grouped_score"):
        d_all = lax.map(
            step,
            (rows_of.reshape(ns, tile_chunk),
             tp.reshape(ns, tile_chunk, tile_m),
             lens.reshape(ns, tile_chunk)),
        ).reshape(nt * tile_m, lmax)

    # ---- reorder each pair's distance row back to its slot ---------------
    # (inverse-permutation row GATHER via the `inv` table that rides the
    # tile sort, cheaper than a row scatter)
    with jax.named_scope("rpt_pair_reorder"):
        pad = jnp.concatenate([d_all, jnp.full((1, lmax), jnp.inf)],
                              axis=0)
        return jnp.take(pad, inv, axis=0).reshape(b, p, lmax), needed


def grouped_distances_kernel(x_leaf, sq_leaf, lens_of_block, gsel, lsel, q,
                             metric, precision, tile_m: int, nt: int,
                             row_of=None, block_scale=None,
                             interpret=False):
    """Same contract as :func:`grouped_distances`, with the tile scoring
    in the fused Pallas kernel (:mod:`.grouped_kernel`), which reads each
    tile's block straight from ``x_leaf`` instead of materializing the
    gathered ``[nt, lmax, D]`` blocks, and the pair reorder as an
    inverse-permutation ROW GATHER.

    Numerics: f32 blocks contract at :func:`f32_dot_precision`, the XLA
    path's accuracy floor; bf16 blocks run their native single pass;
    int8 blocks dot exactly in int32.  Dense f32/bf16/int8 + l2/sql2 only (callers gate
    with :func:`.grouped_kernel.grouped_kernel_ok` and fall back to the
    XLA path).
    """
    from .grouped_kernel import grouped_score_tiles, grouped_score_tiles_int8

    b, p = gsel.shape
    lmax = x_leaf.shape[-2]
    with jax.named_scope("rpt_tile_tables"):
        tb, tp, needed, inv = _tile_tables(gsel, lsel, tile_m, nt,
                                           with_slots=True)
        lens_t = jnp.take(lens_of_block, tb)
    rows_of = tb if row_of is None else jnp.take(row_of, tb)
    qi = jnp.where(tp >= 0, tp // p, 0).reshape(-1)
    qt = jnp.take(q, qi, axis=0)  # [nt * tile_m, D] in tile-slot order
    with jax.named_scope("rpt_grouped_score"):
        if x_leaf.dtype == jnp.int8:
            q_i8, qs = _quantize_rows(q)  # once per query, as the XLA path
            d_all = grouped_score_tiles_int8(
                x_leaf, sq_leaf, block_scale, rows_of, lens_t,
                jnp.take(q_i8, qi, axis=0), jnp.take(qs[:, 0], qi),
                jnp.sum(qt * qt, axis=1), metric, tile_m,
                interpret=interpret)
        else:
            prec = (f32_dot_precision(precision)
                    if x_leaf.dtype == jnp.float32 else None)
            d_all = grouped_score_tiles(
                x_leaf, sq_leaf, rows_of, lens_t, qt, metric, tile_m,
                precision=prec, interpret=interpret)
    # pair reorder: pairs in no tile (masked probes / capacity overflow)
    # read the +inf pad row; `inv` rides the tile sort (see _tile_tables)
    with jax.named_scope("rpt_pair_reorder"):
        pad = jnp.concatenate([d_all, jnp.full((1, lmax), jnp.inf)],
                              axis=0)
        return jnp.take(pad, inv, axis=0).reshape(b, p, lmax), needed
