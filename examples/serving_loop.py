"""Steady-state serving loop: pipelined dispatch closes the wall-vs-device gap.

A synchronous serve loop's wall QPS sits below the device-side number
because it pays a dispatch plus a result fetch per batch.  A production
server does neither: it keeps a few batches IN FLIGHT (jax
dispatch is async; results are fetched when the client consumes them,
by which time the device has moved on).  With ``knn_grouped(...,
check=False)`` the serving path has no hidden host syncs, so the
pipeline actually fills.

This script measures the same flagship serving three ways:
  sync        -- dispatch, fetch, repeat (what bench.py's wall loop does)
  depth=d     -- keep d batches in flight, fetch the oldest when the
                 window fills (bounded staleness / memory)
  chunked     -- accumulate 4 batches and serve them as ONE dispatch of
                 ``knn_grouped(chunk=BQ)`` (lax.map over chunks inside
                 the jit; per-chunk peak memory)

Where the per-call cost is synchronous host-side dispatch rather than
result latency, pipelining buys little and chunked batching pays it once
per 4 batches.  The production recipe is therefore: batch as large as
latency allows,
serve with ``chunk=32768``, ``check=False``, and poll
``f.grouped_overflow()`` every N batches (the overflow counter stays on
device; one int fetch tells you if a traffic shift outgrew the learned
tile capacity -- re-run one checked call to re-learn it).

Run: ``python examples/serving_loop.py [n] [centers] [depth...]``
Reference analogue: the reference library serves one query at a time
(``src/Data/RPTree.hs:159-176``); batching + pipelining is the
accelerator's serving shape.
"""

import collections
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEFAULT = 1_000_000
C_DEFAULT = 4_000
DIM = 128
K = 10
SIGMA = 0.15
SEED = 20260817
T, ML, BUDGET, PROBES = 8, 128, 1, 8
BQ = 32768          # per-batch queries
N_BATCHES = 8       # distinct in-flight query batches (rotated)
REPS = 24           # total batches served per timing


def main(n=N_DEFAULT, c=C_DEFAULT, depths=(2, 4)):
    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu.utils.gen import clustered_mixture

    x, q = clustered_mixture(jax.random.PRNGKey(SEED), n, c, DIM, SIGMA,
                             BQ * N_BATCHES)
    jax.block_until_ready(q)
    qs = [q[i * BQ:(i + 1) * BQ] for i in range(N_BATCHES)]

    cfg = rt.rp_tree_cfg(ML, n, DIM)
    t0 = time.perf_counter()
    f = rt.forest_batch(SEED, cfg.max_depth, ML, T, cfg.proj_nz_density, x)
    np.asarray(f.arrays.perm[0, :1])
    f.pack_leaves()
    print(f"built+packed in {time.perf_counter() - t0:.1f}s "
          f"(T={T} ml={ML} b={BUDGET} p={PROBES}, B={BQ})")

    def serve(qb, check=False):
        return f.knn_grouped(qb, K, budget=BUDGET, probes=PROBES,
                             precision="default", check=check)

    # warm-up: ONE checked call per batch shape caches the tile capacity
    # and compiles; everything after runs check=False (no host syncs)
    d0, i0 = serve(qs[0], check=True)
    int(jnp.sum(jnp.clip(i0[:, 0], 0, 1)))  # force + warm the fetch op

    def fetch(res):
        # consume one scalar per batch (a server would stream the ids
        # out; one scalar keeps the measurement honest without timing
        # the bulk result transfer)
        return int(jnp.sum(jnp.clip(res[1][:, 0], 0, 1)))

    results = {}

    # sync loop (dispatch, fetch, repeat)
    fetch(serve(qs[0]))
    t0 = time.perf_counter()
    for r in range(REPS):
        fetch(serve(qs[r % N_BATCHES]))
    dt = time.perf_counter() - t0
    results["sync"] = REPS * BQ / dt
    print(f"sync:    {results['sync']:10.0f} QPS wall")

    # pipelined: keep `depth` batches in flight
    for depth in depths:
        window = collections.deque()
        fetch(serve(qs[0]))  # re-warm dispatch path
        t0 = time.perf_counter()
        for r in range(REPS):
            window.append(serve(qs[r % N_BATCHES]))
            if len(window) >= depth:
                fetch(window.popleft())
        while window:
            fetch(window.popleft())
        dt = time.perf_counter() - t0
        results[f"depth={depth}"] = REPS * BQ / dt
        print(f"depth={depth}: {results[f'depth={depth}']:10.0f} QPS wall")

    # chunked giant batch: 4 batches, ONE dispatch (lax.map over chunks)
    qbig = jnp.concatenate(qs[:4], axis=0)

    def serve_big(check=False):
        return f.knn_grouped(qbig, K, budget=BUDGET, probes=PROBES,
                             precision="default", chunk=BQ,
                             check=check)

    fetch(serve_big(check=True))  # capacity + compile at this shape
    fetch(serve_big())
    t0 = time.perf_counter()
    for _ in range(max(1, REPS // 4)):
        fetch(serve_big())
    dt = time.perf_counter() - t0
    results["chunked"] = max(1, REPS // 4) * 4 * BQ / dt
    print(f"chunked: {results['chunked']:10.0f} QPS wall "
          f"(4 batches / dispatch)")

    # production overflow monitoring: the check=False loop above never
    # host-syncs, but its needed-tile counter rides along on device --
    # poll it every N batches (one int fetch) and re-learn the capacity
    # (a checked call) if a traffic shift ever overflows the headroom
    ov = f.grouped_overflow()
    print(f"overflow telemetry after the loop: needed={ov['needed']} "
          f"capacity={ov['capacity']} overflow={ov['overflow']}")

    best = max(results.values())
    print(f"\nbest over sync: {best / results['sync']:.2f}x "
          f"({max(results, key=results.get)})")
    return results


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT
    c = int(sys.argv[2]) if len(sys.argv) > 2 else C_DEFAULT
    ds = tuple(int(a) for a in sys.argv[3:]) or (2, 4)
    main(n, c, ds)
