"""Headline benchmark: batched forest-kNN throughput, the accelerator
engine vs a CPU re-execution of the reference algorithm's semantics.

The reference publishes no numbers, so the baseline is self-generated:
the numpy oracle in :mod:`rptree_tpu.reference` runs the same forest
(same trees, same candidate semantics) query-by-query, the way the
reference library does (``src/Data/RPTree.hs:159-176`` is single-query).
``vs_baseline`` is the engine-QPS / oracle-QPS ratio; the north-star
target is >= 100x (BASELINE.json).

Prints ONE JSON line:
  {"metric": "knn_qps", "value": <qps>, "unit": "queries/s",
   "vs_baseline": <ratio>, ..., "device": {platform, kind, count,
   nvidia_smi}}
"""

import json
import subprocess
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import rptree_tpu as rt
    from rptree_tpu import reference as ref

    # SIFT-shaped workload (BASELINE.json configs[3] scaled to bench time):
    # n=100k 128-d dense vectors, 8 trees, auto depth, k=10.
    N, DIM, T, K = 100_000, 128, 8, 10
    MIN_LEAF = 64
    BUDGET = 2     # frontier width; forks are rare on this workload, so
    #                this is recall-equivalent to the reference's unbounded
    #                descent (budget 2 and 4 return the same recall@10)
    PROBES = 10    # leaf buckets reranked per query (slots past ~10 are
    #                duplicate or masked buckets at this shape)
    B = 524288     # total query batch, served as chunks inside ONE
    #                dispatch so the host pays one call for the batch
    BR = 32768     # recall-probe prefix (plenty for a stable recall@10)
    CHUNK = 4096   # queries per device call (bounds rerank memory ~1.2GB)
    SEED = 20260816

    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    q = (x[rng.integers(0, N, size=B)]
         + 0.1 * rng.normal(size=(B, DIM)).astype(np.float32))

    cfg = rt.rp_tree_cfg(MIN_LEAF, N, DIM)

    # ---- engine build ----------------------------------------------------
    t0 = time.perf_counter()
    f = rt.forest_batch(SEED, cfg.max_depth, MIN_LEAF, T,
                        cfg.proj_nz_density, x)
    jax.block_until_ready(f.arrays.perm)
    build_cold_s = time.perf_counter() - t0  # includes one-time jit compile

    t0 = time.perf_counter()
    f2 = rt.forest_batch(SEED + 1, cfg.max_depth, MIN_LEAF, T,
                         cfg.proj_nz_density, x)
    jax.block_until_ready(f2.arrays.perm)
    build_s = time.perf_counter() - t0  # steady-state (compile cached)
    del f2

    # serving-path layout: int8 leaf blocks (per-leaf scales, exact stored
    # norms, int32 dot accumulation) -- a quarter of the f32 block-fetch
    # bytes; the grouped int8 tile kernel dequantizes against the exact
    # stored norms.  slack=8 reserves fold() slots (ordinary maskable
    # padding).  The reference algorithm itself runs in f64; precision
    # knobs are part of the speed/quality surface, not hidden, and recall
    # is reported below and must beat the baseline's.
    f.pack_leaves(dtype=jnp.int8, slack=8)

    qd = jnp.asarray(q)
    GCH = 32768  # grouped serving chunk

    def sweep(check=True):
        # one-dispatch grouped batch (lax.map over chunks): queries
        # probing the same leaf block share one fetch + one tile dot;
        # check=False is the steady-state mode (capacity cached by the
        # warm-up call).  selection="kernel" is the fused streaming
        # top-k tail (ops/topk_kernel): one pass extracts the k smallest
        # distinct ids instead of the payload sort network
        return f.knn_grouped(qd, K, budget=BUDGET, probes=PROBES,
                             precision="default", chunk=GCH,
                             check=check, selection="kernel")

    def sweep_timed():
        # one scalar fetch at the end times the whole batch
        _, ids = sweep(check=False)
        return int(jnp.sum(jnp.clip(ids, 0, None)))

    np.asarray(sweep(check=True)[1][:8])  # capacity + compile + warm
    sweep_timed()  # warm the timed expression too
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        sweep_timed()
    dt = (time.perf_counter() - t0) / reps
    qps = B / dt

    # device-side QPS (marginal fori_loop; utils/profiling): the wall
    # number above includes the host's dispatch and fetch -- record both.
    # The packed arrays are passed as ARGUMENTS (closing over them would
    # embed GBs of constants in the lowered program)
    from rptree_tpu.models.forest import _knn_grouped, _knn_packed_many
    from rptree_tpu.utils.profiling import device_time

    xl_b, sl_b, il_b = f._packed
    sc_b = f._block_scale
    lens_b = f._lens_global()
    ntb = f._grouped_nt[(B, PROBES, 16, 1, GCH)]

    def dev_step(qx, xl, sl, il, ln, sc):
        return _knn_grouped(f.plan, f.arrays, xl, sl, il, ln, qx, K,
                            BUDGET, PROBES, "l2", True, "default", 16,
                            ntb, 2048, block_scale=sc,
                            selection="kernel")[0]

    qps_device = GCH / max(
        device_time(dev_step, qd[:GCH], xl_b, sl_b, il_b, lens_b, sc_b,
                    reps=5), 1e-9)

    # quality: recall@10 of the returned neighbours vs exact top-k
    # (on the first BR queries -- ample for a stable recall statistic)
    got = np.asarray(sweep(check=False)[1])[:BR]
    exact = np.concatenate([
        np.asarray(f.brute_force_knn(qd[s:s + CHUNK], K)[1])
        for s in range(0, BR, CHUNK)
    ], axis=0)
    recall = float(np.mean([
        len(set(got[b].tolist()) & set(exact[b].tolist())) / K
        for b in range(BR)
    ]))

    # ---- CPU reference-semantics baseline (per-query, as the reference
    # runs: one query at a time over the pointer forest) ------------------
    r_np = np.asarray(f.arrays.r, dtype=np.float64)
    t0 = time.perf_counter()
    ref_forest = ref.ref_forest_batch(x, r_np, cfg.max_depth, MIN_LEAF)
    ref_build_s = time.perf_counter() - t0

    # CPU-time-based oracle measurement: the single-threaded numpy loop's
    # wall clock varies ~3x with machine load; process_time is stable and
    # is exactly what the reference's own bench harness measures
    # (getCPUTime, bench/time/Main.hs:188-193)
    nq_ref = 64
    ref_recalls = []
    t0 = time.process_time()
    for b in range(nq_ref):
        _, rid = ref.ref_knn(ref_forest, x, q[b], K, dedup=True)
        ref_recalls.append(
            len(set(rid.tolist()) & set(exact[b].tolist())) / K
        )
    ref_qps = nq_ref / (time.process_time() - t0)
    del ref_forest

    # ---- high-recall operating point (recall@10 >= 0.9), n=100k ---------
    # On iid-Gaussian 128-d data the RP forest's recall saturates per
    # forest shape (forks are structural), so the engine's cheapest
    # >=0.9 config is the exact scan (recall 1.0); the best tree point
    # is reported alongside for the frontier.  tune()
    # (rptree_tpu.tuning) automates this sweep offline; the winning
    # configs are pinned here to keep the driver bench's compile count
    # bounded.
    TARGET = 0.9
    QT, MLT, BT, PT = 32, 4096, 2, 32  # quality forest: T=32, min_leaf=4096
    cfg_q = rt.rp_tree_cfg(MLT, N, DIM)
    fq = rt.forest_batch(SEED, cfg_q.max_depth, MLT, QT,
                         cfg_q.proj_nz_density, x)
    fq.pack_leaves(dtype=jnp.bfloat16)
    lmax_q = fq.plan.max_leaf_len
    cbq = 1 << int(np.log2(max(32, (1 << 21) // max(PT * lmax_q, 1))))
    ids_q = np.concatenate(
        [np.asarray(fq.knn(qd[s:s + cbq], K, budget=BT, probes=PT,
                           precision="default")[1])
         for s in range(0, 1024, cbq)], axis=0)
    recall_tree = float(np.mean([
        len(set(ids_q[b].tolist()) & set(exact[b].tolist())) / K
        for b in range(1024)
    ]))

    BQ = 8192  # enough to amortize dispatch at the heavy tree config

    def sweep_q():
        _, ids = fq.knn_batched(qd[:BQ], K, budget=BT, probes=PT,
                                precision="default", chunk=cbq)
        return int(jnp.sum(ids))

    sweep_q()
    t0 = time.perf_counter()
    for _ in range(2):
        sweep_q()
    qps_tree = BQ / ((time.perf_counter() - t0) / 2)
    del fq

    # exact scan (the engine's own brute_force_knn), one dispatch for
    # the whole batch
    def sweep_bf():
        _, ids = f.brute_force_knn(qd, K, precision="fastest",
                                   query_chunk=2048)
        return int(jnp.sum(ids))

    sweep_bf()
    t0 = time.perf_counter()
    for _ in range(3):
        sweep_bf()
    qps_scan = B / ((time.perf_counter() - t0) / 3)
    ids_scan = np.concatenate(
        [np.asarray(f.brute_force_knn(qd[s:s + 2048], K,
                                      precision="fastest")[1])
         for s in range(0, 2048, 2048)], axis=0)
    recall_scan = float(np.mean([
        len(set(ids_scan[b].tolist()) & set(exact[b].tolist())) / K
        for b in range(min(1024, ids_scan.shape[0]))
    ]))
    cands = [(qps_tree, recall_tree), (qps_scan, recall_scan)]
    meeting = [c for c in cands if c[1] >= TARGET] or [max(cands,
                                                           key=lambda c: c[1])]
    qps_at_target, recall_at_target = max(meeting)

    # oracle at matched recall: its cheapest >=0.9 semantics-faithful
    # config is likewise the exact scan (its tree at T=32/ml=4096 scans
    # MORE candidates per query with Python overhead on top).  Give the
    # oracle its best shot: factored-distance GEMV with precomputed
    # squared norms (not the naive (x-q)^2 loop).
    nq_bf = 64
    sq_np = np.sum(x * x, axis=1)
    t0 = time.process_time()
    for b in range(nq_bf):
        d2 = sq_np - 2.0 * (x @ q[b])
        np.argpartition(d2, K)[:K]
    ref_qps_target = nq_bf / (time.process_time() - t0)

    # ---- clustered-data tree-served >= 0.9 point (1M) --------------------
    # Gaussian mixtures are the reference's own bench data family
    # (src/Data/RPTree/Internal/Testing.hs:38-50) and the regime real
    # embedding workloads live in.  Config from the examples/clustered_1m.py
    # sweep: min_leaf ~ cluster size so the per-tree leaf covers most of
    # the query's cluster, f32 blocks (int8's cross-term error scrambles
    # near-equidistant in-cluster rankings), budget=1.
    NC, CC, SIGC = 1_000_000, 4_000, 0.15
    MLC, TC, BC, PC = 128, 8, 1, 8
    BCQ = 524288  # serving batch, run as lax.map chunks of CHC inside ONE
    #               dispatch; larger chunks raise the per-chunk probe-group
    #               density (fewer block fetches per query)
    CHC = 65536

    from rptree_tpu.utils.gen import clustered_mixture

    xc, qc = clustered_mixture(jax.random.PRNGKey(SEED), NC, CC, DIM, SIGC,
                               BCQ)
    jax.block_until_ready(qc)
    sqc = jnp.sum(xc * xc, axis=-1)
    from rptree_tpu.models.forest import _brute_force_many

    gt_c = np.asarray(_brute_force_many(xc, sqc, qc[:1024], K, "l2",
                                        "highest", 256)[1])
    # the clustered build config comes from the TUNER, not a hand pin:
    # sweep min_leaf around n_sub/centers on a subsample; the winner
    # transfers by the scale law min_leaf ~ n/centers.  Static-cost
    # ranking (measure=False) keeps the compile count bounded and picks
    # the smallest leaf meeting the target.
    from rptree_tpu.tuning import tune_build

    SUBC = 131072
    tb = tune_build(np.asarray(xc[:SUBC]), np.asarray(qc[:256]), k=K,
                    target_recall=TARGET, centers_estimate=CC,
                    sample=SUBC, full_n=NC, budgets=(BC,),
                    probes_per_tree=(1.0, 2.0), measure=False)
    PC = int(tb["probes"] or PC)
    # candidate leaf sizes, SMALLEST first (smaller leaves serve faster
    # at equal probes): subsample recall within 0.02 of the target is a
    # candidate -- the boundary is noisy at subsample cluster sizes and
    # recall transfers slightly UP with scale (cluster occupancy grows at
    # fixed leaf/cluster ratio).  Each candidate is VERIFIED at full
    # scale; the first one meeting the target serves (bounded fallback:
    # the tuner's own pick always meets by construction of the sweep).
    def _scale_ml(ml):
        v = max(8, int(ml * NC / SUBC))
        return 1 << (v - 1).bit_length() if v & (v - 1) else v

    # ...plus HALF the tuner's pick: subsample leaves near k under-predict
    # the scaled recall (a 16-row leaf cannot hold 10 neighbours the way
    # its 128-row scaled image can), and the at-scale probe below makes
    # trying the smaller config safe
    cands = sorted({
        _scale_ml(r["min_leaf"]) for r in tb["frontier"]
        if r["recall"] >= TARGET - 0.02 and not r.get("scan")
    } | {int(tb["min_leaf_full"]),
         max(8, int(tb["min_leaf_full"]) // 2)})
    fc = None
    for MLC in cands:
        if fc is not None:
            del fc
        cfg_c = rt.rp_tree_cfg(MLC, NC, DIM)
        fc = rt.forest_batch(SEED, cfg_c.max_depth, MLC, TC,
                             cfg_c.proj_nz_density, xc)
        fc.pack_leaves()

        # serve through the query-grouped block-resident rerank
        # (ops/grouped.py): queries probing the same leaf block share ONE
        # fetch of it and ONE tile dot -- on clustered data probe sets
        # overlap heavily by construction
        def sweep_c(check=True):
            # the warm-up call validates + caches the tile capacity; the
            # timed loop passes check=False (steady-state serving mode),
            # skipping the per-batch capacity fetch.  selection="kernel":
            # the fused streaming top-k tail
            _, ids = fc.knn_grouped(qc, K, budget=BC, probes=PC,
                                    precision="default", chunk=CHC,
                                    check=check, selection="kernel")
            return ids

        ids_g = np.asarray(sweep_c()[:1024])  # capacity + compile + warm
        recall_probe = float(np.mean([
            len(set(ids_g[b].tolist()) & set(gt_c[b].tolist())) / K
            for b in range(1024)
        ]))
        if recall_probe >= TARGET:
            break

    # warm the timed expression too (its tiny sum/clip ops compile on
    # first use, which would otherwise land inside the clock)
    int(jnp.sum(jnp.clip(sweep_c(check=False)[:, 0], 0, 1)))
    t0 = time.perf_counter()
    for _ in range(2):
        int(jnp.sum(jnp.clip(sweep_c(check=False)[:, 0], 0, 1)))
    tree_qps_c = BCQ / ((time.perf_counter() - t0) / 2)

    xl_c, sl_c, il_c = fc._packed
    lens_c = fc._lens_global()
    # per-CHUNK capacity (5-tuple key for chunked batches)
    ntc = fc._grouped_nt[(BCQ, PC, 16, 1, CHC)]
    from rptree_tpu.models.forest import _knn_grouped

    # device-side: ONE chunk through the unchunked pipeline (same
    # per-chunk program the lax.map runs; the marginal fori_loop method
    # needs the single-call form)
    qc_dev = qc[:CHC]

    def dev_step_c(qx, xl, sl, il, ln):
        return _knn_grouped(fc.plan, fc.arrays, xl, sl, il, ln, qx, K,
                            BC, PC, "l2", True, "default", 16, ntc,
                            2048, selection="kernel")[0]

    tree_qps_c_device = CHC / max(
        device_time(dev_step_c, qc_dev, xl_c, sl_c, il_c, lens_c,
                    reps=4),
        1e-9)
    tree_recall_c = recall_probe  # from the serving path above

    # per-pair path, kept for comparison
    def sweep_c_pp():
        _, ids = fc.knn_batched(qc, K, budget=BC, probes=PC,
                                precision="default", chunk=2048)
        return int(jnp.sum(jnp.clip(ids[:, 0], 0, 1)))

    sweep_c_pp()
    t0 = time.perf_counter()
    for _ in range(2):
        sweep_c_pp()
    tree_qps_c_pp = BCQ / ((time.perf_counter() - t0) / 2)

    def dev_step_c_pp(qx, xl, sl, il):
        return _knn_packed_many(fc.plan, fc.arrays, xl, sl, il, qx, K,
                                BC, PC, "l2", True, "default", False,
                                1, None, None, 2048)[0]

    tree_qps_c_pp_device = BCQ / max(
        device_time(dev_step_c_pp, qc, xl_c, sl_c, il_c, reps=4), 1e-9)

    def sweep_scan_c():
        _, ids = _brute_force_many(xc, sqc, qc, K, "l2", "fastest", 1024)
        return int(jnp.sum(jnp.clip(ids, 0, None)))

    sweep_scan_c()
    t0 = time.perf_counter()
    for _ in range(2):
        sweep_scan_c()
    scan_qps_c = BCQ / ((time.perf_counter() - t0) / 2)
    ids_sc = np.asarray(_brute_force_many(xc, sqc, qc[:1024], K, "l2",
                                          "fastest", 256)[1])
    scan_recall_c = float(np.mean([
        len(set(ids_sc[b].tolist()) & set(gt_c[b].tolist())) / K
        for b in range(1024)
    ]))
    del fc, xc, sqc, qc

    # ---- 1M-point high-recall point --------------------------------------
    N1 = 1_000_000
    x1 = rng.normal(size=(N1, DIM)).astype(np.float32)
    f1 = rt.forest_batch(SEED, 3, N1, 1, 1.0, x1)  # single-leaf: scan host
    q1 = qd[:4096]

    def sweep_bf1():
        _, ids = f1.brute_force_knn(q1, K, precision="fastest",
                                    query_chunk=1024)
        return int(jnp.sum(ids))

    sweep_bf1()
    t0 = time.perf_counter()
    for _ in range(2):
        sweep_bf1()
    qps_scan_1m = 4096 / ((time.perf_counter() - t0) / 2)
    exact_1m = np.asarray(f1.brute_force_knn(q1[:256], K)[1])  # highest
    got_1m = np.asarray(f1.brute_force_knn(q1[:256], K,
                                           precision="fastest")[1])
    recall_1m = float(np.mean([
        len(set(got_1m[b].tolist()) & set(exact_1m[b].tolist())) / K
        for b in range(256)
    ]))
    sq1_np = np.sum(x1 * x1, axis=1)
    t0 = time.process_time()
    for b in range(8):
        d2 = sq1_np - 2.0 * (x1 @ q[b])
        np.argpartition(d2, K)[:K]
    ref_qps_1m = 8 / (time.process_time() - t0)
    del f1, x1

    # ---- recall plausibility gate ----------------------------------------
    # Structurally impossible device-side recalls (the CPU oracle's
    # recall is the yardstick) mean a wrong program ran -- a miscompile
    # or a corrupted compile cache -- not a slower engine: refuse to
    # record the numbers.
    oracle_rec = float(np.mean(ref_recalls))
    checks = [
        ("headline recall vs oracle parity", recall >= 0.5 * oracle_rec),
        ("exact-scan recall@target", recall_at_target >= 0.8),
        ("clustered tree recall", tree_recall_c >= 0.8),
        ("1m fastest-scan recall", recall_1m >= 0.8),
    ]
    bad = [name for name, ok in checks if not ok]
    if bad:
        raise RuntimeError(
            "implausible device-side results (suspected miscompile or "
            f"corrupted compile cache): {', '.join(bad)}")

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)

    print(json.dumps({
        "metric": "knn_qps",
        "value": round(qps, 1),
        "unit": "queries/s",
        "qps_device": round(qps_device, 1),
        "headline_serving_path": "knn_grouped int8 blocks + "
                                 "fused top-k tail",
        "vs_baseline": round(qps / ref_qps, 1),
        "recall_at_10": round(recall, 4),
        "baseline_recall_at_10": round(float(np.mean(ref_recalls)), 4),
        "baseline_qps": round(ref_qps, 1),
        "build_s": round(build_s, 3),
        "build_cold_s": round(build_cold_s, 3),
        "baseline_build_s": round(ref_build_s, 3),
        "recall_target": TARGET,
        "qps_at_target": round(qps_at_target, 1),
        "recall_at_target": round(recall_at_target, 4),
        "vs_baseline_at_target": round(qps_at_target / ref_qps_target, 1),
        "baseline_qps_at_target": round(ref_qps_target, 1),
        "tree_point_at_target": {
            "qps": round(qps_tree, 1), "recall": round(recall_tree, 4),
            "trees": QT, "min_leaf": MLT, "budget": BT, "probes": PT},
        "qps_at_target_1m": round(qps_scan_1m, 1),
        "recall_at_target_1m": round(recall_1m, 4),
        "vs_baseline_at_target_1m": round(qps_scan_1m / ref_qps_1m, 1),
        # clustered 1M (reference's own bench data family): the TREE path
        # is the winning >=0.9 config, beating the engine's own exact scan
        "tree_qps_at_target": round(tree_qps_c, 1),
        "tree_qps_device": round(tree_qps_c_device, 1),
        "tree_recall_at_target": round(tree_recall_c, 4),
        # block-resident tile rerank + fused streaming top-k tail
        "tree_serving_path": "knn_grouped + fused top-k tail",
        "tree_qps_perpair": round(tree_qps_c_pp, 1),
        "tree_qps_perpair_device": round(tree_qps_c_pp_device, 1),
        "clustered_scan_qps": round(scan_qps_c, 1),
        "clustered_scan_recall": round(scan_recall_c, 4),
        "tree_vs_scan_clustered": round(tree_qps_c / scan_qps_c, 2),
        "vs_baseline_tree_at_target": round(tree_qps_c / ref_qps_1m, 1),
        "clustered_config": {"n": NC, "centers": CC, "sigma": SIGC,
                             "trees": TC, "min_leaf": MLC, "budget": BC,
                             "probes": PC, "blocks": "f32",
                             "batch": BCQ, "chunk": CHC,
                             "tuned": True,  # min_leaf/probes from
                             #                 tune_build on a subsample
                             "tuner_subsample": SUBC,
                             "tuner_min_leaf_sub": int(tb["min_leaf"])},
        "config": {"n": N, "dim": DIM, "trees": T, "k": K,
                   "max_depth": cfg.max_depth, "min_leaf": MIN_LEAF,
                   "budget": BUDGET, "probes": PROBES, "batch": B},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": smi.stdout.strip() or None},
    }))


if __name__ == "__main__":
    main()
