"""Bag-of-words sparse (ELL) serving on one chip: tree vs exact scan.

The reference's headline vector type is the sparse ``SVector``
(``src/Data/RPTree/Internal.hs:92-119``) and its bench data is sparse
gaussians (``Internal/Testing.hs:38-50``).  This script measures the
regime that type exists for -- document vectors over a large vocabulary
-- end to end on device: sparse (ELL) build, ``EllBlocks`` pack, and
dense-query serving, against the exact sparse scan.

Default shape: 262,144 docs x 65,536-term vocab, 32 terms/doc, 256
topic bands, T=8.  What it shows:

- the exact sparse scan is expensive at vocab scale (a gather-contract
  per document) -- exactly why the tree matters here;
- per-pair ``knn_batched`` and grouped ``knn_grouped`` at the same
  config; the tile_chunk AUTO-CLAMP (``_ell_tile_chunk_cap``) bounds the
  grouped path's per-step dense-query tile at vocab dims;
- a larger min_leaf (the n/topics sweet spot) trades QPS for recall.

Recall saturates low on this family for the same structural reason
iid-Gaussian does (32-nnz docs have near-tie neighbourhoods).

Run: ``python examples/bow_sparse.py [n] [vocab] [min_leaf]``
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DEFAULT = 262_144
V_DEFAULT = 65_536
ML_DEFAULT = 128
NNZ, T, K, B = 32, 8, 10, 1024
SEED = 20260820


def main(n=N_DEFAULT, v=V_DEFAULT, ml=ML_DEFAULT):
    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu.ops.sparse import EllMatrix

    @jax.jit
    def gen(key):
        kc, kv, kt, kq = jax.random.split(key, 4)
        topic = jax.random.randint(kt, (n, 1), 0, 256)
        base = topic * (v // 256)
        off = jax.random.randint(kc, (n, NNZ), 0, v // 64)
        cols = jnp.sort(jnp.clip(base + off, 0, v - 1).astype(jnp.int32),
                        axis=1)
        vals = jnp.abs(jax.random.normal(kv, (n, NNZ), jnp.float32)) + 0.1
        return cols, vals, jax.random.randint(kq, (B,), 0, n)

    cols, vals, qi = gen(jax.random.PRNGKey(SEED))
    x = EllMatrix(v, cols, vals)
    cfg = rt.rp_tree_cfg(ml, n, v)
    t0 = time.perf_counter()
    f = rt.forest_batch(SEED, cfg.max_depth, ml, T, cfg.proj_nz_density, x)
    np.asarray(f.arrays.perm[0, :1])
    print(f"sparse build {time.perf_counter() - t0:.1f}s "
          f"(depth={cfg.max_depth} ml={ml})")
    t0 = time.perf_counter()
    f.pack_leaves()
    np.asarray(f._packed[2][:1, :1])
    g, lmax, kz = f._packed[0].shape
    print(f"EllBlocks pack {time.perf_counter() - t0:.1f}s: "
          f"{g} blocks x lmax={lmax} x K={kz}")

    @jax.jit
    def densify(ci, vi):
        q = jnp.zeros((ci.shape[0], v), jnp.float32)
        return q.at[jnp.arange(ci.shape[0])[:, None], ci].add(vi)

    q = densify(jnp.take(cols, qi, axis=0), jnp.take(vals, qi, axis=0))
    float(jnp.sum(q))

    gt = np.concatenate([np.asarray(f.brute_force_knn(q[s:s + 256], K)[1])
                         for s in range(0, B, 256)], axis=0)

    def scan_once():
        _, ids = f.brute_force_knn(q[:256], K)
        return int(jnp.sum(jnp.clip(ids, 0, None)))

    scan_once()
    t0 = time.perf_counter()
    scan_once()
    scan_qps = 256 / (time.perf_counter() - t0)
    print(f"exact sparse scan: {scan_qps:.0f} QPS")

    # sparse-QUERY form: the same documents as (cols, vals) tables --
    # [B, dim] never materializes (the innerSS regime at batch scale);
    # grouped + a fat chunk is the fastest sparse path
    q_ell = EllMatrix(v, jnp.take(cols, qi, axis=0),
                      jnp.take(vals, qi, axis=0))

    for name, run in (
        ("per-pair knn_batched",
         lambda qq: f.knn_batched(qq, K, budget=2, precision="default",
                                  chunk=512)),
        ("grouped knn_grouped",
         lambda qq: f.knn_grouped(qq, K, budget=2, precision="default")),
        ("grouped SPARSE queries",
         lambda qq: f.knn_grouped(q_ell, K, budget=2,
                                  precision="default",
                                  chunk=min(4096, B))),
    ):
        int(jnp.sum(jnp.clip(run(q)[1], 0, None)))  # warm + capacities
        t0 = time.perf_counter()
        _, ids = run(q)
        int(jnp.sum(jnp.clip(ids, 0, None)))
        qps = B / (time.perf_counter() - t0)
        got = np.asarray(ids)
        rec = float(np.mean([
            len(set(got[i].tolist()) & set(gt[i].tolist())) / K
            for i in range(B)
        ]))
        print(f"{name}: {qps:.0f} QPS wall @ recall {rec:.4f} "
              f"(vs scan {qps / scan_qps:.1f}x)")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else N_DEFAULT,
         int(sys.argv[2]) if len(sys.argv) > 2 else V_DEFAULT,
         int(sys.argv[3]) if len(sys.argv) > 3 else ML_DEFAULT)
