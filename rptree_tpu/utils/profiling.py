"""Device-side timing utilities.

The reference measures CPU time around pure computations
(``bench/time/Main.hs:175-230``).  On an asynchronously-dispatched
accelerator a wall clock around one call measures dispatch and fetch as
well as the device work.  :func:`device_time` runs the operation ``n``
times inside one jitted ``lax.fori_loop`` with a forced data dependency
between iterations, fetches one scalar, and reports the marginal
per-iteration time: device time, independent of dispatch/fetch
overhead.

**Named profiler regions.**  The reference marks its four hot functions
with GHC cost centers -- ``{-# SCC candidates #-}``
(``src/Data/RPTree.hs:289``), ``{-# SCC insertMulti #-}`` / ``{-# SCC
insert #-}`` (``src/Data/RPTree/Internal.hs:244,257``) and ``{-# SCC
partitionAtMedian #-}`` (``Internal.hs:484``) -- so ``+RTS -p`` profiles
attribute time to them.  The equivalents here are ``jax.named_scope``
regions, which surface as op-name prefixes in
profiler traces (perfetto / TensorBoard) and in lowered HLO metadata:

====================  =====================================================
scope                 covers (reference analogue)
====================  =====================================================
``rpt_candidates``    forest traversal + probe selection (SCC candidates)
``rpt_insert``        fold()'s placement descent (SCC insert/insertMulti)
``rpt_partition_at_median``  the build's level split (SCC partitionAtMedian)
``rpt_project``       build-time projection GEMM (inside partitionAtMedian)
``rpt_rerank``        block fetch + exact distances (the serving hot loop)
``rpt_tile_tables``   grouped pair sort + tile assignment
``rpt_grouped_score`` grouped block-resident distance tiles
``rpt_pair_reorder``  grouped inverse-permutation row reorder
``rpt_topk_tail``     candidate selection tail (sort / fused top-k)
====================  =====================================================

:func:`trace` wraps ``jax.profiler`` so a stage decomposition no longer
needs a throwaway script::

    import rptree_tpu as rt
    f = rt.forest_batch(...).pack_leaves()
    with rt.profiling.trace("/tmp/rpt_trace"):
        d, i = f.knn_grouped(q, 10)
        rt.profiling.sync(d)

then open the perfetto link (or ``tensorboard --logdir /tmp/rpt_trace``)
and group ops by the ``rpt_*`` name prefixes.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator


import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["device_time", "trace", "sync", "SCOPES"]


def device_time(step: Callable, *args, reps: int = 20) -> float:
    """Marginal device seconds per call of ``step(*args)``.

    Iterations are chained through a data dependency on the FIRST
    FLOATING-POINT argument (an ``acc * 1e-9`` perturbation -- adding it
    to an integer argument would silently promote it to f32 and break
    integer consumers like gathers/scatters downstream); at least one
    argument must be floating.  ``step`` returns an array or tuple of
    arrays.  Args are passed through as jit arguments (never closed
    over -- a closure would embed large arrays as program constants).
    """
    def _is_float_array(a):
        try:  # pytree args (e.g. TreeArrays) are fine, just not targets
            return jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        except (TypeError, ValueError):
            return False

    fi = next((i for i, a in enumerate(args) if _is_float_array(a)), None)
    if fi is None:
        raise ValueError("device_time needs at least one floating-point "
                         "array argument to chain iterations through")

    def loop(n: int) -> float:
        @jax.jit
        def g(argt):
            def body(_, acc):
                a = list(argt)
                a[fi] = a[fi] + acc * 1e-9
                out = step(*a)
                if isinstance(out, tuple):
                    out = out[0]
                return jnp.sum(
                    jnp.asarray(out).astype(jnp.float32).ravel()[:1]
                ) * 1e-20 + acc

            return lax.fori_loop(0, n, body, 0.0)

        float(g(args))  # compile + warm
        t0 = time.perf_counter()
        float(g(args))
        return time.perf_counter() - t0

    t1, tn = loop(1), loop(reps)
    return max(0.0, (tn - t1) / (reps - 1))


# ---------------------------------------------------------------------------
# Named profiler regions + trace capture (see module docstring)
# ---------------------------------------------------------------------------


#: The named regions the library emits (see module docstring).
SCOPES = (
    "rpt_candidates",
    "rpt_insert",
    "rpt_partition_at_median",
    "rpt_project",
    "rpt_rerank",
    "rpt_tile_tables",
    "rpt_grouped_score",
    "rpt_pair_reorder",
    "rpt_topk_tail",
)


def sync(*arrays) -> None:
    """Wait for the device work behind ``arrays`` so the trace window
    contains the real execution."""
    jax.block_until_ready(arrays)


@contextlib.contextmanager
def trace(logdir: str, host: bool = False) -> Iterator[None]:
    """Capture a profiler trace of the block body into ``logdir``
    (perfetto/TensorBoard format).  Ops land under the ``rpt_*`` named
    scopes above -- the SCC-style stage decomposition.

    ``host=True`` adds host-side Python tracing (TraceMe) to the
    capture.  Remember to :func:`sync` the outputs INSIDE the block;
    otherwise dispatch returns immediately and the trace window closes
    before the device work runs."""
    options = jax.profiler.ProfileOptions()
    if host:
        options.python_tracer_level = 1
    jax.profiler.start_trace(logdir, profiler_options=options)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
