"""Hand-written kernels against what XLA makes of the plain version.

Times, on the GPU, at the two serving configurations ``bench.py`` and
``chip_smoke.py`` use:

* the grouped tile-scoring stage: the Triton tile kernel
  (``ops/grouped_kernel.py``) against the XLA gather + batched matmul
  (``ops/grouped.grouped_distances``), f32 blocks on the clustered 1M
  set and int8 blocks on the iid 100k set;
* the selection tail: the Triton streaming top-k (``ops/topk_kernel.py``)
  against the ``lax.sort`` payload tail and against ``lax.top_k`` +
  ``merge_top_k``, on the candidate rows those stages produce;
* end to end through ``knn_grouped``: every (impl, selection) pair.

Each number is the median wall time of ``--reps`` calls that end in
``block_until_ready`` after one warm-up call.  The card's name and power
limit are printed first; write them beside any number kept.

Run: ``python examples/kernel_timing.py [--n 1000000] [--queries 65536]``
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median_time(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _stage_inputs(f, q, budget, probes, k):
    """Probe selection of the grouped path, for timing its stages alone."""
    import jax

    from rptree_tpu.models.forest import _select_probes

    sel = jax.jit(lambda a, qq: _select_probes(f.plan, a, qq, budget, probes,
                                               k=k))
    return sel(f.arrays, q)


def time_config(name, f, q, k, budget, probes, precision, reps, out):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from rptree_tpu.models.forest import (_prec, _selection_tail_ids,
                                          merge_top_k)
    from rptree_tpu.ops.grouped import (grouped_distances,
                                        grouped_distances_kernel)
    from rptree_tpu.ops.topk_kernel import topk_block_rows, topk_dedup_kernel

    b = q.shape[0]
    # capacity + compile through the public path
    jax.block_until_ready(f.knn_grouped(q, k, budget=budget, probes=probes,
                                        precision=precision, chunk=b))
    nt = f._grouped_nt[(b, probes, 16, 1, b)]
    x_leaf, sq_leaf, id_leaf = f._packed
    scale = getattr(f, "_block_scale", None)
    lens = f._lens_global()
    gsel, lsel = _stage_inputs(f, q, budget, probes, k)
    prec = _prec(precision)

    xla = jax.jit(lambda *a: grouped_distances(
        *a, "l2", prec, 16, nt, 2048, block_scale=scale)[0])
    ker = jax.jit(lambda *a: grouped_distances_kernel(
        *a, "l2", prec, 16, nt, block_scale=scale)[0])
    args = (x_leaf, sq_leaf, lens, gsel, lsel, q)
    t_xla = _median_time(xla, *args, reps=reps)
    t_ker = _median_time(ker, *args, reps=reps)
    d_x = xla(*args)
    d_k = ker(*args)
    fin = jnp.isfinite(d_x)
    err = float(jnp.max(jnp.where(fin, jnp.abs(d_k - d_x)
                                  / (1.0 + jnp.abs(d_x)), 0.0)))
    same_mask = bool(jnp.all(fin == jnp.isfinite(d_k)))
    row = {"config": name, "stage": "grouped_score", "xla_s": t_xla,
           "kernel_s": t_ker,
           "max_rel_err": err, "mask_equal": same_mask,
           "tiles": int(nt), "lmax": int(x_leaf.shape[1]),
           "precision": precision}
    print(json.dumps(row), flush=True)
    out.append(row)

    # selection tail on the candidate rows the scoring stage produced
    p = gsel.shape[1]
    lmax = x_leaf.shape[1]
    dd = d_x.reshape(b, p * lmax)
    ids = jnp.take(id_leaf, gsel, axis=0).reshape(b, p * lmax)
    kk = k * f.n_trees
    sort_tail = jax.jit(lambda d_, i_: _selection_tail_ids(
        d_, i_, k, kk, True))

    @jax.jit
    def topk_tail(d_, i_):
        neg, idx = lax.top_k(-d_, kk)
        it = jnp.take_along_axis(i_, idx, axis=-1)
        it = jnp.where(jnp.isinf(neg), -1, it)
        return merge_top_k(-neg, it, k, dedup=True)

    t_sort = _median_time(sort_tail, dd, ids, reps=reps)
    t_topk = _median_time(topk_tail, dd, ids, reps=reps)
    res = {}
    for bm in sorted({1, 2, 4, topk_block_rows(p * lmax)}):
        kern = jax.jit(lambda d_, i_, bm=bm: topk_dedup_kernel(d_, i_, k,
                                                               bm=bm))
        res[bm] = _median_time(kern, dd, ids, reps=reps)
    ds, is_ = sort_tail(dd, ids)
    dk, ik = topk_dedup_kernel(dd, ids, k)
    row = {"config": name, "stage": "topk_tail", "sort_s": t_sort,
           "top_k_merge_s": t_topk,
           "kernel_s_by_bm": {str(a): v for a, v in res.items()},
           "default_bm": topk_block_rows(p * lmax), "width": p * lmax,
           "ids_equal": bool(jnp.all(ik == is_)),
           "dists_bit_equal": bool(jnp.all(dk == ds))}
    print(json.dumps(row), flush=True)
    out.append(row)

    # end to end through the public entry point
    for impl in ("xla", "kernel"):
        for selection in ("sort", "kernel"):
            fn = lambda qq, impl=impl, selection=selection: f.knn_grouped(
                qq, k, budget=budget, probes=probes, precision=precision,
                chunk=b, check=False, impl=impl, selection=selection)
            t = _median_time(fn, q, reps=reps)
            row = {"config": name, "stage": "knn_grouped", "impl": impl,
                   "selection": selection, "s": t, "qps": b / t}
            print(json.dumps(row), flush=True)
            out.append(row)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-iid", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    a = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu.utils.gen import clustered_mixture

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"device_kind": dev.device_kind,
                      "count": len(jax.devices()),
                      "nvidia_smi": smi.strip()}), flush=True)
    out = []

    # clustered 1M, f32 blocks
    x, q = clustered_mixture(jax.random.PRNGKey(a.seed), a.n, 4000, 128,
                             0.15, a.queries)
    f = rt.forest_batch(a.seed, rt.rp_tree_cfg(128, a.n, 128).max_depth,
                        128, 8, 1.0, x)
    f.pack_leaves()
    for precision in ("highest", "default"):
        time_config("clustered_1m_f32", f, q, 10, 1, 8, precision, a.reps,
                    out)
    del f, x, q

    # iid 100k, int8 blocks (the bench.py headline layout)
    rng = np.random.default_rng(a.seed)
    x = rng.normal(size=(a.n_iid, 128)).astype(np.float32)
    q = jnp.asarray(x[rng.integers(0, a.n_iid, size=a.queries)]
                    + 0.1 * rng.normal(size=(a.queries, 128)
                                       ).astype(np.float32))
    cfg = rt.rp_tree_cfg(64, a.n_iid, 128)
    f = rt.forest_batch(a.seed, cfg.max_depth, 64, 8, cfg.proj_nz_density,
                        x)
    f.pack_leaves(dtype=jnp.int8, slack=8)
    time_config("iid_100k_int8", f, q, 10, 2, 10, "default", a.reps, out)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
