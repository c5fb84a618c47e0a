"""Fused per-query top-k (+ duplicate-id masking) selection kernel.

The serving pipelines' selection tail (:func:`..models.forest.
_selection_tail_ids`) ranks each query's ``W = probes * lmax`` scored
candidate slots with a full-width 2-operand payload sort, takes the
``kk = k * n_trees`` prefix, and dedups by id -- a compare-exchange
network that passes over the whole [B, W] (distance, id) state many
times.  Serving only needs the k SMALLEST DISTINCT ids, and k is tiny
(10): this kernel reads each program's ``[bm, W]`` row block into
registers once and extracts the winners with k serial (min, tie-break,
mask-by-id) passes, one read of the state instead of the sort network's
many.  Masking by winner id makes the dedup free -- no
``k * n_trees`` overselect, no id-sort, no second merge.

Triton wants power-of-two blocks: the candidate axis is padded to one by
masked loads that read ``(+inf, -1)``, which never win a pass, and rows
past ``B`` are masked on load and store -- nothing is copied to pad.

Tie/duplicate semantics (pinned in tests/test_topk_kernel.py), the sort
tail's own: winner of each pass is the lowest distance; with ``dedup``
ties go to the lowest id (the order the sort tail's id-sorted dedup
merge leaves) and every slot holding the winner's id is masked, so a
duplicated id keeps its LOWEST-distance copy; without ``dedup`` ties go
to the lowest slot position (the stable sort's prefix).  ``min_votes >
1`` callers need full candidate lists and keep the sort tail.

Reference analogue: the ``take k . sortBy`` candidate fold of ``knn``
(``src/Data/RPTree.hs:159-176``); the single-pass streaming extraction is
a restructuring for the accelerator with no reference counterpart.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["topk_dedup_kernel", "topk_kernel_ok", "topk_block_rows"]

# largest k the kernel extracts (k serial passes; the sort tail is the
# better form long before this)
_K_MAX = 128
# candidate elements each program keeps in registers (bm * padded W)
_ELEMS = 2048
_ID_MAX = 2**31 - 1


def topk_kernel_ok(w: int, k: int, min_votes: int = 1,
                   selection: str = "sort") -> bool:
    """Gate: a GPU backend, k within the kernel's bound, dedup-compatible
    selection (the approx knob and vote counting keep the XLA tail)."""
    if selection != "sort" or min_votes != 1:
        return False
    if k > _K_MAX or w < 1:
        return False
    return jax.default_backend() == "gpu"


def topk_block_rows(w: int) -> int:
    """Rows per program: as many as keep ``bm * pow2(W)`` near
    ``_ELEMS`` register-resident elements (at least one row), so short
    rows still give each program enough work and long rows do not
    spill."""
    wp = 1 << max(0, int(w) - 1).bit_length()
    return max(1, _ELEMS // wp)


@functools.partial(jax.jit,
                   static_argnames=("k", "dedup", "bm", "interpret"))
def topk_dedup_kernel(d, ids, k: int, dedup: bool = True, bm=None,
                      interpret: bool = False):
    """Per-row k smallest (distance, id) pairs of ``d f32[B, W]`` /
    ``ids int32[B, W]``; with ``dedup`` the k winners have distinct ids
    (every slot carrying an already-selected id is skipped).  Returns
    ``(dk f32[B, k], ik int32[B, k])``; rows with fewer than k live
    (finite) candidates pad with (+inf, -1).  Any ``W``/``B``.
    """
    b, w = d.shape
    assert k <= _K_MAX, k
    wp = 1 << max(0, w - 1).bit_length()
    kp = 1 << max(0, k - 1).bit_length()
    bm = topk_block_rows(w) if bm is None else int(bm)

    def kern(d_ref, id_ref, od_ref, oi_ref):
        rows = pl.program_id(0) * bm + jnp.arange(bm)
        pos = jnp.arange(wp)
        live_rows = (rows < b)[:, None]
        m_in = live_rows & (pos < w)[None, :]
        dv = plgpu.load(d_ref.at[rows[:, None], pos[None, :]], mask=m_in,
                        other=jnp.inf)                    # [bm, wp]
        iv = plgpu.load(id_ref.at[rows[:, None], pos[None, :]], mask=m_in,
                        other=-1)
        lane = jnp.arange(kp)[None, :]
        od = jnp.full((bm, kp), jnp.inf, jnp.float32)
        oi = jnp.full((bm, kp), -1, jnp.int32)

        def one_pass(j, carry):
            dv, od, oi = carry
            m = jnp.min(dv, axis=1, keepdims=True)        # [bm, 1]
            at_min = dv == m
            if dedup:
                # ties -> lowest id: the order the sort tail's id-sorted
                # dedup merge leaves among equal distances
                wid = jnp.min(jnp.where(at_min, iv, _ID_MAX), axis=1,
                              keepdims=True)
                kill = iv == wid
            else:
                # ties -> lowest position: the stable sort's prefix
                p = jnp.min(jnp.where(at_min, pos[None, :], wp), axis=1,
                            keepdims=True)
                kill = pos[None, :] == p
                wid = jnp.max(jnp.where(kill, iv, -1), axis=1,
                              keepdims=True)
            live = m < jnp.inf
            wid = jnp.where(live, wid, -1)
            od = jnp.where(lane == j, m, od)
            oi = jnp.where(lane == j, wid, oi)
            # mask the winner: every copy of its id (dedup) or just the
            # selected slot; exhausted rows select nothing live
            dv = jnp.where(kill & live, jnp.inf, dv)
            return dv, od, oi

        _, od, oi = lax.fori_loop(0, k, one_pass, (dv, od, oi))
        m_out = live_rows & (lane < k)
        plgpu.store(od_ref.at[rows[:, None], lane], od, mask=m_out)
        plgpu.store(oi_ref.at[rows[:, None], lane], oi, mask=m_out)

    return pl.pallas_call(
        kern,
        grid=(-(-b // bm),),
        out_shape=[
            jax.ShapeDtypeStruct((b, k), jnp.float32),
            jax.ShapeDtypeStruct((b, k), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="rpt_topk_dedup",
    )(d.astype(jnp.float32), ids.astype(jnp.int32))
