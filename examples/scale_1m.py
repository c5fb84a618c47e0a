"""Million-point scale check (SIFT-1M-shaped): build an 8-tree index
over 1M synthetic 128-d vectors on one device, pack to bf16 blocks, and report device-side build and query
times plus recall@10 against the exact scan.

Run: ``python examples/scale_1m.py [n]``  (default 1,000,000)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n: int = 1_000_000):
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu.ops.build import build_forest_arrays

    dim, n_trees, k = 128, 8, 10
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    cfg = rt.rp_tree_cfg(64, n, dim)
    print(f"n={n} depth={cfg.max_depth} pnz={cfg.proj_nz_density:.3f}")

    t0 = time.perf_counter()
    f = rt.forest_batch(1, cfg.max_depth, 64, n_trees,
                        cfg.proj_nz_density, x)
    np.asarray(f.arrays.perm)
    print(f"build wall {time.perf_counter() - t0:.1f}s "
          "(includes host->device transfer and any compile)")

    import jax
    r = jnp.asarray(np.asarray(f.arrays.r))
    dt = rt.device_time(
        lambda rr, xx: build_forest_arrays(f.plan, xx, rr).perm,
        r, f.x, reps=3,
    )
    print(f"build device {dt:.2f}s")

    f.pack_leaves(dtype=jnp.bfloat16)
    b = 2048
    q = jnp.asarray((x[rng.integers(0, n, size=b)]
                     + 0.1 * rng.normal(size=(b, dim))).astype(np.float32))
    from rptree_tpu.models.forest import _knn_packed

    xl, sl, il = f._packed
    dt = rt.device_time(
        lambda qq, a, b_, c_, d_: _knn_packed(
            f.plan, a, b_, c_, d_, qq, k, 4, 12, "l2", True, "default"
        ),
        q, f.arrays, xl, sl, il, reps=10,
    )
    print(f"query device {dt * 1e3:.2f}ms per {b} queries "
          f"({b / dt:.0f} QPS/chip)")

    _, ids = f.knn(q[:256], k, budget=4, probes=12, precision="default")
    _, exact = f.brute_force_knn(q[:256], k)
    ids, exact = np.asarray(ids), np.asarray(exact)
    rec = np.mean([
        len(set(ids[i].tolist()) & set(exact[i].tolist())) / k
        for i in range(256)
    ])
    print(f"recall@{k} = {rec:.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
