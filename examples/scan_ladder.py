"""Exact-scan ladder on live hardware.

Times the XLA streaming scan (``_brute_force_many``) at the bench shape
on the CURRENT backend at precision ``highest`` / ``default`` /
``fastest`` (per-tile ``approx_max_k``) and prints a QPS ladder -- the
yardstick a fused scan + running top-k kernel would have to beat before
``RPForest.brute_force_knn`` promotes it.

Run: ``python examples/scan_ladder.py [n] [batch]``
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(n: int = 100_000, b: int = 4096):
    import jax
    import jax.numpy as jnp

    from rptree_tpu.models.forest import _brute_force_many

    dim, k = 128, 10
    key = jax.random.PRNGKey(0)
    kx, kq = jax.random.split(key)
    x = jax.random.normal(kx, (n, dim), jnp.float32)
    q = jax.random.normal(kq, (b, dim), jnp.float32)
    sq = jnp.sum(x * x, axis=-1)
    float(jnp.sum(q))
    print(f"backend={jax.default_backend()} n={n} d={dim} b={b} k={k}")

    # ground truth for the recall column
    gt = np.asarray(_brute_force_many(x, sq, q[:512], k, "l2",
                                      "highest", 256)[1])

    def timed(label, fn, rec_fn):
        fn()  # compile + warm
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            fn()
        qps = b / ((time.perf_counter() - t0) / reps)
        ids = rec_fn()
        rec = float(np.mean([
            len(set(ids[i].tolist()) & set(gt[i].tolist())) / k
            for i in range(512)
        ]))
        print(f"  {label:<28} {qps:10.0f} QPS  recall@10 {rec:.4f}")
        return qps

    for prec in ("highest", "default", "fastest"):
        timed(
            f"xla scan precision={prec}",
            lambda p=prec: int(jnp.sum(jnp.clip(
                _brute_force_many(x, sq, q, k, "l2", p, 1024)[1], 0, None))),
            lambda p=prec: np.asarray(
                _brute_force_many(x, sq, q[:512], k, "l2", p, 256)[1]),
        )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100_000,
         int(sys.argv[2]) if len(sys.argv) > 2 else 4096)
