"""10M points on ONE chip via the shared-row layout.

The blocked serving layout stores each tree's leaves as contiguous row
blocks -- T full dataset copies, bought for contiguous block fetches.
At 10M f32 x 128-d points and T=8 that is ~41 GB, while the dataset
itself is 5 GB.
``pack_leaves(store="shared")`` keeps ONE shared row store plus per-tree
id tables (~6 GB total) and serves by per-row gathers -- this script
measures what that buys and costs at 10M clustered points: build time,
index memory, recall@10, and QPS (per-pair and query-grouped) against
the exact scan.

Data and queries are generated ON DEVICE (a 5 GB host-side dataset
would spend the wall clock on the host-to-device copy).

Run: ``python examples/scale_10m.py [n] [centers]``
(default 10,000,000 points / 40,000 centers -> the
``min_leaf ~ n/centers`` sweet spot at 250)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEFAULT = 10_000_000
C_DEFAULT = 40_000
DIM = 128
K = 10
SIGMA = 0.15
SEED = 20260820
TREES = 8


def _hbm_gb():
    import jax

    st = jax.devices()[0].memory_stats() or {}
    return st.get("bytes_in_use", 0) / 2**30


def main(n: int = N_DEFAULT, c: int = C_DEFAULT):
    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt

    from rptree_tpu.utils.gen import clustered_mixture

    b_time, b_rec = 65536, 1024
    x, q = clustered_mixture(jax.random.PRNGKey(SEED), n, c, DIM, SIGMA,
                             b_time)
    jax.block_until_ready(q)
    print(f"n={n} centers={c} dim={DIM} sigma={SIGMA}  "
          f"hbm={_hbm_gb():.2f} GB (dataset "
          f"{n * DIM * 4 / 2**30:.2f} GB)")

    cfg = rt.rp_tree_cfg_clustered(n, DIM, centers=c)
    print(f"cfg: min_leaf={cfg.min_leaf} depth={cfg.max_depth} "
          f"pnz={cfg.proj_nz_density:.3f} T={TREES}")

    t0 = time.perf_counter()
    f = rt.forest_batch(SEED, cfg.max_depth, cfg.min_leaf, TREES,
                        cfg.proj_nz_density, x)
    np.asarray(f.arrays.perm[0, :1])
    print(f"build wall {time.perf_counter() - t0:.1f}s "
          f"(incl. compile)  hbm={_hbm_gb():.2f} GB")

    t0 = time.perf_counter()
    f.pack_leaves(store="shared")
    np.asarray(f._packed[2][:1, :1])
    g, lmax, d = f._packed[0].shape
    blocked_gb = g * lmax * d * 4 / 2**30
    print(f"pack(store='shared') {time.perf_counter() - t0:.1f}s: "
          f"{g} blocks x lmax={lmax}; id+sq tables "
          f"{2 * g * lmax * 4 / 2**30:.2f} GB vs blocked layout's "
          f"{blocked_gb:.1f} GB of row copies  hbm={_hbm_gb():.2f} GB")

    # ground truth + exact-scan operating point (x stays resident: the
    # shared layout's store IS the dataset)
    t0 = time.perf_counter()
    _, gt = f.brute_force_knn(q[:b_rec], K)
    gt = np.asarray(gt)
    print(f"ground truth (exact scan, {b_rec}q) in "
          f"{time.perf_counter() - t0:.1f}s")

    def scan_once():
        _, ids = f.brute_force_knn(q[:4096], K, precision="fastest")
        return int(jnp.sum(jnp.clip(ids, 0, None)))

    scan_once()
    t0 = time.perf_counter()
    scan_once()
    scan_qps = 4096 / (time.perf_counter() - t0)
    print(f"exact scan: {scan_qps:.0f} QPS (precision='fastest')")

    probes = TREES
    from rptree_tpu.ops.topk_kernel import topk_kernel_ok

    sel = ("kernel" if topk_kernel_ok(probes * f.plan.max_leaf_len, K)
           else "sort")
    for name, run in (
        ("per-pair knn_batched",
         lambda qq, ch: f.knn_batched(qq, K, budget=1, probes=probes,
                                      precision="default", chunk=ch)),
        (f"per-pair knn_batched selection={sel}",
         lambda qq, ch: f.knn_batched(qq, K, budget=1, probes=probes,
                                      precision="default", chunk=ch,
                                      selection=sel)),
        ("grouped knn_grouped",
         lambda qq, ch, check=False: f.knn_grouped(
             qq, K, budget=1, probes=probes, precision="default",
             chunk=ch, check=check)),
    ):
        ch = 8192
        # warm + learn the tile capacity with the CHECKED call (an
        # unlearned capacity under check=False silently masks pairs),
        # then warm the FULL-BATCH dispatch shape: the chunked serving
        # call is one executable per (B, chunk) pair, so timing a shape
        # that was never run measures the compile, not the device
        try:
            run(q[:ch], ch, check=True)
        except TypeError:
            run(q[:ch], ch)  # per-pair path has no check knob
        int(jnp.sum(jnp.clip(run(q, ch)[1], 0, None)))  # warm, force done
        t0 = time.perf_counter()
        _, ids = run(q, ch)
        int(jnp.sum(jnp.clip(ids, 0, None)))  # force completion
        qps = b_time / (time.perf_counter() - t0)
        try:
            ids_r = np.asarray(run(q[:b_rec], b_rec, check=True)[1])
        except TypeError:
            ids_r = np.asarray(run(q[:b_rec], b_rec)[1])
        rec = float(np.mean([
            len(set(ids_r[i].tolist()) & set(gt[i].tolist())) / K
            for i in range(b_rec)
        ]))
        print(f"{name}: {qps:.0f} QPS wall @ recall {rec:.4f} "
              f"(B={b_time}, chunk={ch}, vs scan {qps / scan_qps:.1f}x)"
              f"  hbm={_hbm_gb():.2f} GB")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT,
         int(sys.argv[2]) if len(sys.argv) > 2 else C_DEFAULT)
