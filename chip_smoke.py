"""Smoke test of the main path on the GPU, at real size.

Drives the forest build, the packed layouts and every serving path
through the public entry points on one card, runs each hand-written
kernel as compiled for the card, and checks the results against the
repo's plain references:

1. device: JAX must find a GPU (no CPU fallback); prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. clustered 1M (1,000,000 x 128 f32 around 4,000 centres, sigma 0.15,
   T=8, min_leaf=128): ``knn_grouped`` and ``knn_batched`` on 65,536
   queries, recall@10 against the exact scan at both precisions, and
   the lowered serving step must contain the Triton kernels;
   the same forest repacked with ``store="shared"`` (served by the XLA
   grouped path) keeps recall@10 at both precisions;
3. iid int8 100k (the ``bench.py`` headline layout): ``knn_grouped``
   with ``selection="kernel"`` and ``"sort"`` return equal ids;
4. each kernel against its plain XLA version at those shapes;
5. oracle parity at 20,000 x 128 against ``rptree_tpu.reference``;
6. ``--multichip`` (four cards, this phase only): tree-sharded and
   data-sharded builds and serving against the single-device forest.

Each phase prints one JSON line of its numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
process exits non-zero and prints no result line.

Run: ``python chip_smoke.py [--seed S] [--multichip]``
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

K = 10
DIM = 128


def emit(phase, **numbers):
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def require_gpu(devices):
    """Phase 1 gate: the first device must be a GPU; anything else (the
    CPU included) is refused."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {plat!r}")
    return devices[0]


def card_name_and_power():
    """``name, power.limit`` from nvidia-smi, read by a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def recall(got, exact):
    got, exact = np.asarray(got), np.asarray(exact)
    return float(np.mean([len(set(got[b].tolist()) & set(exact[b].tolist()))
                          / exact.shape[1] for b in range(exact.shape[0])]))


def same_sets_up_to_ties(d_a, i_a, d_b, i_b, tol=1e-4):
    """Rows whose neighbour sets differ must differ only among candidates
    tied within ``tol`` at the k-th distance.  Returns the number of rows
    whose sets differ.  The two paths sum the factored L2 ``|x|^2 - 2 x.q
    + |q|^2`` in different orders, and its cancellation leaves a few f32
    ulps of ``|x|^2`` (about 1e-5 at |x|^2 ~ 128) in each distance: the
    same bound the tile kernel is held to."""
    d_a, i_a, d_b, i_b = map(np.asarray, (d_a, i_a, d_b, i_b))
    diff = 0
    for r in range(i_a.shape[0]):
        if set(i_a[r].tolist()) == set(i_b[r].tolist()):
            continue
        diff += 1
        np.testing.assert_allclose(d_a[r], d_b[r], rtol=tol, atol=tol,
                                   err_msg=f"row {r}: sets differ beyond "
                                           "distance ties")
    return diff


def lowered_step(f, q, precision, selection, nt):
    """The grouped serving step as the chunked path compiles it."""
    from rptree_tpu.models.forest import _knn_grouped

    x_leaf, sq_leaf, id_leaf = f._packed
    args = (f.plan, f.arrays, x_leaf, sq_leaf, id_leaf, f._lens_global(),
            q, K, 1, 8, "l2", True, precision, 16, nt, 2048)
    return _knn_grouped.lower(
        *args, block_scale=getattr(f, "_block_scale", None),
        selection=selection)


def phase_clustered(seed, n_points, n_queries, centers=4000):
    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu.utils.gen import clustered_mixture

    t0 = time.perf_counter()
    x, q = clustered_mixture(jax.random.PRNGKey(seed), n_points, centers,
                             DIM, 0.15, n_queries)
    jax.block_until_ready((x, q))
    cfg = rt.rp_tree_cfg(128, n_points, DIM)
    f = rt.forest_batch(seed, cfg.max_depth, 128, 8, cfg.proj_nz_density, x)
    jax.block_until_ready(f.arrays.perm)
    build_s = time.perf_counter() - t0
    f.pack_leaves()
    _, exact = f.brute_force_knn(q[:1024], K, precision="highest")

    out = {"n": n_points, "queries": n_queries, "lmax": f._packed[0].shape[1],
           "build_s_incl_compile": build_s}
    res = {}
    for prec in ("highest", "default"):
        dg, ig = f.knn_grouped(q, K, budget=1, probes=8, chunk=n_queries,
                               precision=prec)
        dp, ip = f.knn_batched(q, K, budget=1, probes=8, chunk=4096,
                               precision=prec)
        res[prec] = (dg, ig, dp, ip)
        out[f"recall_grouped_{prec}"] = recall(ig[:1024], exact)
        out[f"recall_perpair_{prec}"] = recall(ip[:1024], exact)
        assert out[f"recall_grouped_{prec}"] >= 0.90, out
    dg, ig, dp, ip = res["highest"]
    out["rows_differing_grouped_vs_perpair_highest"] = same_sets_up_to_ties(
        dg, ig, dp, ip)

    # the kernels must be in the compiled serving step: a silent XLA
    # fallback fails here
    nt = f._grouped_nt[(n_queries, 8, 16, 1, n_queries)]
    qc = q[:n_queries]
    for selection, want in (("sort", 1), ("kernel", 2)):
        text = lowered_step(f, qc, "default", selection, nt).as_text()
        got = text.count("__gpu$xla.gpu.triton")
        assert got >= want, (selection, got)
        out[f"triton_calls_selection_{selection}"] = got
    comp = lowered_step(f, qc, "default", "kernel", nt).compile()
    ma = comp.memory_analysis()
    out["serving_step_memory"] = {
        k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(ma, k)}
    emit("clustered_1m", **out)
    return f, q, exact, res["highest"][:2]


def phase_iid_int8(seed, n_points, n_queries):
    import jax.numpy as jnp

    import rptree_tpu as rt

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_points, DIM)).astype(np.float32)
    q = jnp.asarray(x[rng.integers(0, n_points, size=n_queries)]
                    + 0.1 * rng.normal(size=(n_queries, DIM)
                                       ).astype(np.float32))
    cfg = rt.rp_tree_cfg(64, n_points, DIM)
    f = rt.forest_batch(seed, cfg.max_depth, 64, 8, cfg.proj_nz_density, x)
    f.pack_leaves(dtype=jnp.int8, slack=8)
    kw = dict(budget=2, probes=10, precision="default", chunk=32768)
    dk, ik = f.knn_grouped(q, K, selection="kernel", **kw)
    ds, is_ = f.knn_grouped(q, K, selection="sort", **kw)
    ik, is_ = np.asarray(ik), np.asarray(is_)
    rows = int(np.sum(np.any(ik != is_, axis=1)))
    emit("iid_100k_int8", n=n_points, queries=n_queries,
         lmax=f._packed[0].shape[1], rows_ids_differ=rows,
         dists_bit_equal=bool(np.array_equal(np.asarray(dk),
                                             np.asarray(ds))))
    assert rows == 0, rows
    return f, q


def _stage_args(f, q, budget, probes):
    import jax

    from rptree_tpu.models.forest import _select_probes

    gsel, lsel = jax.jit(lambda a, qq: _select_probes(
        f.plan, a, qq, budget, probes, k=K))(f.arrays, q)
    x_leaf, sq_leaf, id_leaf = f._packed
    return (x_leaf, sq_leaf, f._lens_global(), gsel, lsel, q), id_leaf


def phase_kernels(f_c, q_c, f_i, q_i):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from rptree_tpu.models.forest import _selection_tail_ids
    from rptree_tpu.ops.grouped import (grouped_distances,
                                        grouped_distances_kernel)
    from rptree_tpu.ops.topk_kernel import topk_dedup_kernel

    def rel_err(a, b):
        """max |a - b| / (1 + |b|) over live slots, and (b, a) there."""
        fin = jnp.isfinite(b)
        assert bool(jnp.all(fin == jnp.isfinite(a))), "occupancy masks differ"
        e = jnp.where(fin, jnp.abs(a - b) / (1.0 + jnp.abs(b)), 0.0).ravel()
        i = jnp.argmax(e)
        return float(e[i]), [float(b.ravel()[i]), float(a.ravel()[i])]

    out = {}
    cases = (("f32", f_c, q_c, 1, 8, 1e-4), ("int8", f_i, q_i, 2, 10, 1e-5))
    for name, f, q, budget, probes, tol in cases:
        args, id_leaf = _stage_args(f, q, budget, probes)
        # the auto capacity rule: 2.25x pairs / tile_m, in whole chunks
        e = q.shape[0] * probes
        nt = -(-(2 * e // 16 + e // 64) // 2048) * 2048
        scale = getattr(f, "_block_scale", None)
        for prec in (lax.Precision.HIGHEST, lax.Precision.DEFAULT):
            dx, nx = jax.jit(lambda *a: grouped_distances(
                *a, "l2", prec, 16, nt, 2048, block_scale=scale))(*args)
            dk, nk = jax.jit(lambda *a: grouped_distances_kernel(
                *a, "l2", prec, 16, nt, block_scale=scale))(*args)
            assert int(nk) == int(nx) <= nt, (int(nk), int(nx), nt)
            err, worst = rel_err(dk, dx)
            tag = "highest" if prec == lax.Precision.HIGHEST else "default"
            out[f"tiles_{name}_max_rel_err_{tag}"] = err
            out[f"tiles_{name}_worst_xla_kernel_{tag}"] = worst
            if tag == "highest":
                assert err <= tol, (name, err)
        # selection tail: the candidate rows of the scoring stage
        b, p = args[3].shape
        dd = dk.reshape(b, -1)
        ids = jnp.take(id_leaf, args[3], axis=0).reshape(b, -1)
        kk = K * f.n_trees
        ds, is_ = jax.jit(lambda d_, i_: _selection_tail_ids(
            d_, i_, K, kk, True))(dd, ids)
        dq, iq = topk_dedup_kernel(dd, ids, K)
        out[f"topk_{name}_rows_ids_differ"] = int(
            jnp.sum(jnp.any(iq != is_, axis=1)))
        out[f"topk_{name}_dists_bit_equal"] = bool(jnp.all(dq == ds))
        assert out[f"topk_{name}_rows_ids_differ"] == 0, out
        assert out[f"topk_{name}_dists_bit_equal"], out
    emit("kernels_vs_xla", **out)


def phase_shared(f, q, exact, ref_highest):
    """The shared-row layout has no kernel: its grouped serving runs the
    XLA path, whose f32 accuracy floor this checks at "default"."""
    f.pack_leaves(store="shared")
    out = {}
    for prec in ("highest", "default"):
        d, i = f.knn_grouped(q, K, budget=1, probes=8, chunk=q.shape[0],
                             precision=prec)
        out[f"recall_grouped_shared_{prec}"] = recall(i[:1024], exact)
        assert out[f"recall_grouped_shared_{prec}"] >= 0.90, out
        if prec == "highest":
            out["rows_differing_shared_vs_blocked_highest"] = (
                same_sets_up_to_ties(d, i, *ref_highest))
    emit("clustered_1m_shared", **out)


def phase_oracle(seed):
    import rptree_tpu as rt
    from rptree_tpu.reference import leaf_spans, ref_forest_batch, ref_knn

    n, t, ml, nq = 20_000, 4, 64, 64
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(n, DIM)).astype(np.float32)
    q = rng.normal(size=(nq, DIM)).astype(np.float32)
    cfg = rt.rp_tree_cfg(ml, n, DIM)
    f = rt.forest_batch(seed, cfg.max_depth, ml, t, cfg.proj_nz_density, x)
    ref = ref_forest_batch(x.astype(np.float64),
                           np.asarray(f.arrays.r, np.float64),
                           cfg.max_depth, ml)
    leaf_mismatch = 0
    for tt in range(t):
        ours = sorted(sorted(leaf) for leaf in f.leaves(tt))
        theirs = sorted(sorted(ids.tolist()) for ids in leaf_spans(ref[tt]))
        leaf_mismatch += int(ours != theirs)
    dists, ids = map(np.asarray, f.knn(q, K, budget=f.plan.n_leaves))
    id_mismatch = 0
    for b in range(nq):
        rd, rid = ref_knn(ref, x.astype(np.float64), q[b].astype(np.float64),
                          K, dedup=True)
        if list(ids[b]) != list(rid):
            # only an f32-vs-f64 distance tie may reorder two candidates
            id_mismatch += 1
            np.testing.assert_allclose(dists[b], rd, rtol=1e-5, atol=1e-5)
    emit("oracle_parity_20k", n=n, trees=t, queries=nq,
         trees_with_leaf_mismatch=leaf_mismatch,
         queries_with_id_order_tie=id_mismatch)
    assert leaf_mismatch == 0


def phase_multichip(seed, n_points, n_queries):
    import jax

    import rptree_tpu as rt
    from rptree_tpu.parallel import (data_mesh, forest_batch_data_parallel,
                                     forest_batch_distributed, forest_mesh)
    from rptree_tpu.utils.gen import clustered_mixture

    devs = jax.devices()
    assert len(devs) >= 4, f"--multichip needs 4 devices, found {len(devs)}"
    x, q = clustered_mixture(jax.random.PRNGKey(seed), n_points, 4000, DIM,
                             0.15, n_queries)
    cfg = rt.rp_tree_cfg(128, n_points, DIM)
    build = (seed, cfg.max_depth, 128, 8, cfg.proj_nz_density)
    f1 = rt.forest_batch(*build, x)
    f1.pack_leaves()
    kw = dict(budget=1, probes=8, precision="highest")
    ref_k = f1.knn_batched(q, K, chunk=4096, **kw)
    ref_g = f1.knn_grouped(q, K, chunk=n_queries, **kw)
    del f1
    out = {"n": n_points, "queries": n_queries, "devices": 4}

    def check(name, f):
        t0 = time.perf_counter()
        got_k = f.knn_batched(q, K, chunk=4096, **kw)
        got_g = f.knn_grouped(q, K, **kw)
        jax.block_until_ready((got_k, got_g))
        out[f"{name}_serve_s_incl_compile"] = time.perf_counter() - t0
        out[f"{name}_knn_rows_differ_by_ties"] = same_sets_up_to_ties(
            *got_k, *ref_k)
        out[f"{name}_grouped_rows_differ_by_ties"] = same_sets_up_to_ties(
            *got_g, *ref_g)

    ft = forest_batch_distributed(*build, x, mesh=forest_mesh(4,
                                                              devices=devs[:4]))
    ft.pack_leaves(shard_by="leaf")
    check("tree_sharded", ft)
    del ft
    for store in ("blocked", "shared"):
        fd = forest_batch_data_parallel(*build, x,
                                        mesh=data_mesh(4, devices=devs[:4]))
        if store == "shared":
            fd.pack_leaves(store="shared")
        else:
            fd.pack_leaves()
        check(f"data_sharded_{store}", fd)
        del fd
    emit("multichip", **out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20260816)
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded phase")
    a = ap.parse_args(argv)

    import jax

    dev = require_gpu(jax.devices())
    smi = card_name_and_power()
    emit("device", device_kind=dev.device_kind, count=len(jax.devices()),
         jax=jax.__version__)
    print(smi, flush=True)

    if a.multichip:
        phase_multichip(a.seed, 1_000_000, 65536)
    else:
        f_c, q_c, exact, ref_highest = phase_clustered(a.seed, 1_000_000,
                                                       65536)
        f_i, q_i = phase_iid_int8(a.seed, 100_000, 65536)
        phase_kernels(f_c, q_c, f_i, q_i)
        del f_i
        phase_shared(f_c, q_c, exact, ref_highest)
        del f_c
        phase_oracle(a.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
