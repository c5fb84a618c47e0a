"""Fused tile-scoring kernel for the query-grouped rerank (Pallas / Triton).

The XLA lowering of the grouped score map (:func:`.grouped.
grouped_distances`) gathers every tile's leaf block into a fresh
``[nt, lmax, D]`` array in device memory and then runs a batched matmul
with M = ``tile_m`` over it: each probed block is read, written and read
again.  This kernel scores the same tiles without materializing the
gathered blocks: one program per tile reads the tile's block row
straight from the packed ``x_leaf`` (the block index comes from the
tile table, loaded by the program itself), contracts it against the
tile's ``tile_m`` query rows with ``pl.dot`` in chunks of ``_BL``
slots, assembles the factored L2 and the occupancy mask, and writes
only the ``[tile_m, lmax]`` distance rows.  Programs are
independent (no state carried between grid steps), so they spread over
every SM.

Triton wants power-of-two block shapes: the slot axis is walked in
power-of-two chunks and the feature axis is padded to one, both through
masked loads (masked lanes read 0 and contribute nothing to the dots);
``tile_m`` must itself be a power of two >= 16 (the tensor-core dot's
minimum M).  Output rows for empty tile slots are junk by construction --
the caller's pair reorder never reads them (their ``tile_pair`` entry is
-1).

Dense f32/bf16/int8 blocks, ``l2``/``sql2`` only; other layouts/metrics
keep the XLA path.  Reference analogue: the rerank fold of ``knn``
(``src/Data/RPTree.hs:159-176``); the tiling is a restructuring for the
accelerator with no reference counterpart.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["grouped_score_tiles", "grouped_score_tiles_int8",
           "grouped_kernel_ok"]

# Triton's dot needs every operand dimension >= 16 (int8 >= 32 along K)
_MIN_DIM = 16
# slots contracted per dot (the slot axis is walked in chunks of this)
_BL = 64
# Triton compile parameters of both tile kernels (not yet tuned)
_COMPILER = dict(num_warps=4, num_stages=2)


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << max(0, int(n) - 1).bit_length())


def grouped_kernel_ok(x_leaf, metric, tile_m: int = 16) -> bool:
    """Shape/metric gate: dense resident f32/bf16/int8 blocks (a 3-D
    ``[G, lmax, D]`` array -- shared-row and sparse layouts have no
    ``ndim``), builtin ``l2``/``sql2``, and a power-of-two ``tile_m`` of
    at least 16 (the dot's M).  ``lmax`` and ``D`` are free: the kernel
    pads both to powers of two with masked loads."""
    if metric not in ("l2", "sql2"):
        return False
    if getattr(x_leaf, "ndim", 0) != 3:
        return False
    if x_leaf.dtype not in (jnp.float32, jnp.bfloat16, jnp.int8):
        return False
    tm = int(tile_m)
    return tm >= _MIN_DIM and tm & (tm - 1) == 0


def _blocking(lmax: int, d: int, dtype):
    dp = _pow2(d, 2 * _MIN_DIM if dtype == jnp.int8 else _MIN_DIM)
    bl = min(_BL, _pow2(lmax, _MIN_DIM))
    return dp, bl, -(-lmax // bl)


def _store_rows(out_ref, rows, cols, dd, ln, lmax, metric):
    """Shared epilogue: clamp, optional sqrt, occupancy mask, store."""
    dd = jnp.maximum(dd, 0.0)
    if metric == "l2":
        dd = jnp.sqrt(dd)
    dd = jnp.where(cols[None, :] < ln, dd, jnp.inf)
    plgpu.store(out_ref.at[rows[:, None], cols[None, :]], dd,
                mask=(cols < lmax)[None, :])


@functools.partial(
    jax.jit, static_argnames=("metric", "tile_m", "precision", "interpret"))
def grouped_score_tiles(x_leaf, sq_leaf, tb, lens_t, qt, metric, tile_m,
                        precision=None, interpret=False):
    """Exact per-slot distances of every tile: ``d[nt * tile_m, lmax]``.

    ``x_leaf: [G, lmax, D]`` packed blocks (f32/bf16), ``sq_leaf:
    f32[G, lmax]`` slot squared norms, ``tb: int32[nt]`` block row per
    tile, ``lens_t: int32[nt]`` occupancy per tile, ``qt:
    f32[nt * tile_m, D]`` query rows in tile-slot order (empty slots may
    carry any row -- their output is never read).  ``precision`` is the
    dot precision (see :func:`.grouped.f32_dot_precision`).  Slots
    at/after a tile's occupancy return +inf.
    """
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    dt = x_leaf.dtype
    dp, bl, n_chunks = _blocking(lmax, d, dt)
    prec = precision
    if interpret and isinstance(prec, lax.DotAlgorithmPreset):
        prec = lax.Precision.HIGHEST  # the CPU has no TF32 algorithms

    def kern(tb_ref, lens_ref, x_ref, sq_ref, q_ref, out_ref):
        t = pl.program_id(0)
        blk = tb_ref[t]
        ln = lens_ref[t]
        rows = t * tile_m + jnp.arange(tile_m)
        dcol = jnp.arange(dp)
        dmask = (dcol < d)[None, :]
        qm = plgpu.load(q_ref.at[rows[:, None], dcol[None, :]],
                        mask=dmask, other=0.0)           # [m, dp] f32
        sqq = jnp.sum(qm * qm, axis=1)[:, None]         # [m, 1]
        qd = qm.astype(dt)

        def chunk(c, carry):
            cols = c * bl + jnp.arange(bl)
            cmask = cols < lmax
            xb = plgpu.load(x_ref.at[blk, cols[:, None], dcol[None, :]],
                            mask=cmask[:, None] & dmask, other=0)  # [bl, dp]
            dots = pl.dot(qd, xb, trans_b=True, precision=prec)
            sq = plgpu.load(sq_ref.at[blk, cols], mask=cmask, other=0.0)
            _store_rows(out_ref, rows, cols, sq[None, :] - 2.0 * dots + sqq,
                        ln, lmax, metric)
            return carry

        lax.fori_loop(0, n_chunks, chunk, 0)

    return pl.pallas_call(
        kern,
        grid=(nt,),
        out_shape=jax.ShapeDtypeStruct((nt * tile_m, lmax), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(**_COMPILER),
        interpret=interpret,
        name="rpt_grouped_tiles",
    )(tb.astype(jnp.int32), lens_t.astype(jnp.int32), x_leaf, sq_leaf,
      qt.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("metric", "tile_m", "interpret"))
def grouped_score_tiles_int8(x_leaf, sq_leaf, scale, tb, lens_t, q_i8,
                             qscale, sqq, metric, tile_m, interpret=False):
    """:func:`grouped_score_tiles` for int8-quantized blocks: the tile dot
    runs int8 x int8 -> int32 on the tensor cores, and the factored-L2
    assembly dequantizes with the block scale x the per-row query scale
    against the EXACT stored slot norms and true f32 query norms -- the
    same arithmetic as the XLA int8 grouped path.  ``scale: f32[G]``
    per-block quantization scales; the query rows arrive quantized in
    tile-slot order (the caller quantizes each query once,
    `ops/grouped._quantize_rows`): ``q_i8: int8[nt * tile_m, D]``,
    ``qscale: f32[nt * tile_m]`` and their true squared norms ``sqq:
    f32[nt * tile_m]``.
    """
    g, lmax, d = x_leaf.shape
    nt = tb.shape[0]
    dp, bl, n_chunks = _blocking(lmax, d, jnp.int8)

    def kern(tb_ref, lens_ref, scale_ref, x_ref, sq_ref, q_ref, qs_ref,
             qq_ref, out_ref):
        t = pl.program_id(0)
        blk = tb_ref[t]
        ln = lens_ref[t]
        sc = scale_ref[blk]
        rows = t * tile_m + jnp.arange(tile_m)
        dcol = jnp.arange(dp)
        dmask = (dcol < d)[None, :]
        qm = plgpu.load(q_ref.at[rows[:, None], dcol[None, :]],
                        mask=dmask, other=0)             # [m, dp] i8
        qs = qs_ref[rows][:, None]                       # [m, 1]
        qq = qq_ref[rows][:, None]

        def chunk(c, carry):
            cols = c * bl + jnp.arange(bl)
            cmask = cols < lmax
            xb = plgpu.load(x_ref.at[blk, cols[:, None], dcol[None, :]],
                            mask=cmask[:, None] & dmask, other=0)  # [bl, dp]
            dots = pl.dot(qm, xb, trans_b=True)           # int32
            sq = plgpu.load(sq_ref.at[blk, cols], mask=cmask, other=0.0)
            # (dots * block scale) * query scale: the XLA path's
            # association, so both round alike
            dotsf = dots.astype(jnp.float32) * sc * qs
            _store_rows(out_ref, rows, cols, sq[None, :] - 2.0 * dotsf + qq,
                        ln, lmax, metric)
            return carry

        lax.fori_loop(0, n_chunks, chunk, 0)

    return pl.pallas_call(
        kern,
        grid=(nt,),
        out_shape=jax.ShapeDtypeStruct((nt * tile_m, lmax), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(**_COMPILER),
        interpret=interpret,
        name="rpt_grouped_tiles_int8",
    )(tb.astype(jnp.int32), lens_t.astype(jnp.int32),
      scale.astype(jnp.float32), x_leaf, sq_leaf, q_i8,
      qscale.astype(jnp.float32), sqq.astype(jnp.float32))
