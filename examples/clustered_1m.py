"""Clustered-data (Gaussian mixture) tree-vs-scan sweep at 1M points.

Gaussian mixtures are the reference's own bench data family
(``src/Data/RPTree/Internal/Testing.hs:38-50``) and the regime where real
embedding workloads live.  On iid-Gaussian data the forest's recall
saturates per shape, but on clustered data the tree path
clears high recall at a fraction of the exact scan's cost -- this script
measures that crossover: it sweeps (trees, min_leaf, budget, probes) on a
1M-point 128-d mixture and reports recall@10 + wall QPS for each config
next to the exact scan, so ``bench.py``'s ``tree_qps_at_target`` pin
can be reproduced.

Everything is generated ON DEVICE (a host-side 512 MB dataset would
spend the wall clock on the host-to-device copy).

Run: ``python examples/clustered_1m.py [n] [centers]``
"""

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


def main(n: int = N_DEFAULT, c: int = C_DEFAULT):
    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu.utils.gen import clustered_mixture

    b_time, b_rec = 4096, 1024
    x, q = clustered_mixture(jax.random.PRNGKey(SEED), n, c, DIM, SIGMA,
                             b_time)
    jax.block_until_ready(q)
    print(f"n={n} centers={c} dim={DIM} sigma={SIGMA}")

    # ground truth once, highest precision
    t0 = time.perf_counter()
    sq = jnp.sum(x * x, axis=-1)
    from rptree_tpu.models.forest import _brute_force_many

    d_gt, gt = _brute_force_many(x, sq, q[:b_rec], K, "l2",
                                 "highest", 256)
    gt = np.asarray(gt)
    print(f"ground truth in {time.perf_counter() - t0:.1f}s")

    # exact-scan operating point (the engine's own fast scan)
    def sweep_scan():
        d, ids = _brute_force_many(x, sq, q, K, "l2", "fastest", 1024)
        return int(jnp.sum(jnp.clip(ids, 0, None)))

    sweep_scan()
    t0 = time.perf_counter()
    for _ in range(2):
        sweep_scan()
    scan_qps = b_time / ((time.perf_counter() - t0) / 2)
    ids_s = np.asarray(_brute_force_many(x, sq, q[:b_rec], K, "l2",
                                         "fastest", 256)[1])
    scan_rec = float(np.mean([
        len(set(ids_s[i].tolist()) & set(gt[i].tolist())) / K
        for i in range(b_rec)
    ]))
    print(f"scan: {scan_qps:.0f} QPS @ recall {scan_rec:.4f}")

    # int8 without centering is OMITTED deliberately: on clustered data
    # its cross-term quantization error scrambles the near-equidistant
    # in-cluster ranking (centered int8 is the quantized row to watch)
    # min_leaf ~ the expected cluster size (n / centers) is the sweet
    # spot: the per-tree leaf then covers most of the query's cluster and
    # the cross-tree union the rest (smaller leaves saturate lower,
    # larger ones buy recall with QPS)
    shapes = [(8, 256, None, False), (8, 256, jnp.int8, True),
              (8, 128, None, False)]
    results = []
    for t_trees, min_leaf, dtype, centered in shapes:
        cfg = rt.rp_tree_cfg(min_leaf, n, DIM)
        t0 = time.perf_counter()
        f = rt.forest_batch(SEED, cfg.max_depth, min_leaf, t_trees,
                            cfg.proj_nz_density, x)
        np.asarray(f.arrays.perm[0, :1])
        f.pack_leaves(dtype=dtype, centered=centered)
        dname = ("f32" if dtype is None
                 else ("int8c" if centered else "int8"))
        print(f"T={t_trees} ml={min_leaf} {dname}: built+packed in "
              f"{time.perf_counter() - t0:.1f}s "
              f"(lmax={f.plan.max_leaf_len}, leaves={f.plan.n_leaves})")
        for budget, probes in ((1, 8), (1, 12), (2, 16)):
            probes = min(probes, t_trees * budget)
            lmax = f.plan.max_leaf_len
            chunk = max(256, min(4096, (1 << 22) // max(probes * lmax, 1)))
            chunk = 1 << int(np.log2(chunk))

            def sweep():
                _, ids = f.knn_batched(q, K, budget=budget, probes=probes,
                                       precision="default", chunk=chunk)
                return int(jnp.sum(jnp.clip(ids, 0, None)))

            sweep()
            t0 = time.perf_counter()
            for _ in range(2):
                sweep()
            qps = b_time / ((time.perf_counter() - t0) / 2)
            ids_t = np.asarray(f.knn_batched(
                q[:b_rec], K, budget=budget, probes=probes,
                precision="default", chunk=min(chunk, b_rec))[1])
            rec = float(np.mean([
                len(set(ids_t[i].tolist()) & set(gt[i].tolist())) / K
                for i in range(b_rec)
            ]))
            results.append({"trees": t_trees, "min_leaf": min_leaf,
                            "dtype": dname, "budget": budget,
                            "probes": probes, "qps": qps, "recall": rec})
            print(f"  budget={budget} probes={probes}: "
                  f"{qps:.0f} QPS @ recall {rec:.4f}")
        del f

    print("\n-- frontier (recall desc) --")
    for r in sorted(results, key=lambda r: -r["recall"]):
        print(f"T={r['trees']:3d} ml={r['min_leaf']:5d} {r['dtype']:>5} "
              f"b={r['budget']} p={r['probes']:3d}  {r['qps']:8.0f} QPS  "
              f"recall {r['recall']:.4f}")
    best = [r for r in results if r["recall"] >= 0.9]
    if best:
        w = max(best, key=lambda r: r["qps"])
        print(f"\ntree winner @>=0.9: {w['qps']:.0f} QPS "
              f"(scan {scan_qps:.0f}) -> "
              f"{'TREE WINS' if w['qps'] > scan_qps else 'scan wins'}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT,
         int(sys.argv[2]) if len(sys.argv) > 2 else C_DEFAULT)
