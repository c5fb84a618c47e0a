"""Auxiliary-subsystem tests: demo app, bench harness, streaming median."""

import numpy as np
import pytest

from rptree_tpu.config import BenchConfig
from rptree_tpu.utils.median import StreamingMedian


# -- streaming median (reference MedianHeap semantics) ----------------------

def test_streaming_median_matches_numpy():
    rng = np.random.default_rng(5)
    xs = rng.normal(size=501)
    m = StreamingMedian()
    for v in xs:
        m.insert(float(v))
    assert m.median() == pytest.approx(float(np.median(xs)))


def test_streaming_median_even_averages_heads():
    m = StreamingMedian([1.0, 2.0, 3.0, 4.0])
    assert m.median() == pytest.approx(2.5)
    assert len(m) == 4


def test_streaming_median_empty_raises():
    with pytest.raises(ValueError):
        StreamingMedian().median()


# -- demo app (app/Main.hs workload, scaled down) ---------------------------

def test_demo_writes_artifacts(tmp_path, monkeypatch):
    import rptree_tpu.demo as demo

    monkeypatch.setattr(demo, "N", 500)
    monkeypatch.setattr(demo, "CHUNK", 100)
    demo.main(str(tmp_path))
    scatter = (tmp_path / "scatter.csv").read_text().strip().splitlines()
    assert len(scatter) == 500
    assert all(len(line.split(",")) == 3 for line in scatter[:5])
    dot = (tmp_path / "tree.dot").read_text()
    assert dot.startswith("digraph") and "->" in dot
    knn = (tmp_path / "knn.csv").read_text().strip().splitlines()
    # dataset rows + up to K hit rows labelled -1
    hits = [l for l in knn if l.endswith(",-1")]
    assert 1 <= len(hits) <= demo.K
    assert (tmp_path / "knn_h.csv").exists()


# -- bench harness (bench/time/Main.hs structure) ---------------------------

def test_run_bench_tiny():
    from rptree_tpu.benchmarks import run_bench

    cfg = BenchConfig(
        description="tiny", max_depth=4, min_leaf=8, num_trees=2,
        chunk_size=50, nz_density=0.5, vector_dim=32, data_size=300,
        num_query_points=8, batch_size=8,
    )
    r = run_bench(cfg, seed=3, reps=1)
    assert 0.0 <= r["recall_at_10"] <= 1.0
    assert r["build_s"] > 0 and r["qps"] > 0


def test_tune_meets_target():
    import numpy as np

    import rptree_tpu as rt
    from rptree_tpu.utils import gen as rgen

    x = np.asarray(rgen.data_batch(4, 3000, rgen.circle2d2), np.float32)
    f = rt.forest_batch(4, 6, 16, 8, 1.0, x).pack_leaves()
    q = np.asarray(rgen.data_batch(5, 24, rgen.circle2d2), np.float32)
    best = rt.tune(f, q, k=5, target_recall=0.8,
                   budgets=(2, 8), probes_per_tree=(1.0, 2.0), reps=1)
    assert best["met"] and best["recall"] >= 0.8
    # 2x2 tree-config grid + the exact-scan candidate (recall 1.0, cost n)
    assert len(best["frontier"]) == 5
    scan = [r for r in best["frontier"] if r.get("scan")]
    assert len(scan) == 1 and scan[0]["cost"] == 3000
    # every frontier point carries a measured throughput; the winner is
    # the fastest measured config among those meeting the target
    assert all(r["qps"] > 0 for r in best["frontier"])
    qpss = [r["qps"] for r in best["frontier"] if r["recall"] >= 0.8]
    assert best["qps"] == max(qpss)
    # static-cost mode still picks the cheapest meeting config
    best_c = rt.tune(f, q, k=5, target_recall=0.8,
                     budgets=(2, 8), probes_per_tree=(1.0, 2.0),
                     measure=False)
    costs = [r["cost"] for r in best_c["frontier"] if r["recall"] >= 0.8]
    assert best_c["cost"] == min(costs) and "qps" not in best_c["frontier"][0]


def test_tune_serving_grouped():
    """serving='grouped' times the query-grouped pipeline (steady-state
    check=False calls after a capacity-learning warm-up) and tags the
    measured points; it needs a packed forest."""
    import numpy as np
    import pytest

    import rptree_tpu as rt
    from rptree_tpu.utils import gen as rgen

    x = np.asarray(rgen.data_batch(4, 2000, rgen.circle2d2), np.float32)
    q = np.asarray(rgen.data_batch(5, 16, rgen.circle2d2), np.float32)
    f = rt.forest_batch(4, 6, 16, 8, 1.0, x).pack_leaves()
    best = rt.tune(f, q, k=5, target_recall=0.5, budgets=(2,),
                   probes_per_tree=(1.0,), reps=1, time_rows=64,
                   serving="grouped")
    pts = [r for r in best["frontier"] if not r.get("scan")]
    assert all(r.get("serving") == "grouped" and r["qps"] > 0
               for r in pts)
    f_unpacked = rt.forest_batch(4, 6, 16, 8, 1.0, x)
    with pytest.raises(ValueError, match="pack_leaves"):
        rt.tune(f_unpacked, q, k=5, serving="grouped")
    with pytest.raises(ValueError, match="serving"):
        rt.tune(f, q, k=5, serving="turbo")


def test_device_time_nonnegative():
    import jax.numpy as jnp

    import rptree_tpu as rt

    dt = rt.device_time(lambda a: a * 2.0, jnp.ones((64, 64)), reps=3)
    assert dt >= 0.0


def test_example_pipeline_runs(capsys, monkeypatch):
    import runpy
    import sys

    monkeypatch.setenv("RPTREE_EXAMPLE_N", "4000")
    monkeypatch.setenv("RPTREE_EXAMPLE_FAST", "1")  # narrow sweep grids:
    # the full grids are ~40 one-core XLA compiles (~3 min of suite wall)
    argv = sys.argv
    sys.argv = ["sift_pipeline.py"]
    try:
        runpy.run_path("examples/sift_pipeline.py", run_name="__main__")
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "recall@10=" in out and "served" in out


def test_gen_custom_component_sampler():
    """dense/sparse accept a caller-supplied component sampler (the
    reference's `sparse pnz dim <sampler>` extension point, Gen.hs:148-175)."""
    import jax
    import numpy as np

    from rptree_tpu.utils import gen as rgen

    key = rgen.key_from_seed(7)
    u = np.asarray(rgen.dense(key, 64, 8, sampler=jax.random.uniform))
    assert ((u >= 0.0) & (u < 1.0)).all()
    s = np.asarray(rgen.sparse(key, 256, 16, 0.5,
                               sampler=jax.random.uniform))
    nz = s[s != 0.0]
    assert ((nz > 0.0) & (nz < 1.0)).all()
    frac = (s != 0.0).mean()
    assert 0.3 < frac < 0.7


def test_tune_build_clustered():
    """Build-side tuning encodes the
    ``min_leaf ~ n/centers`` sweet spot; the winner transfers to the
    full-dataset scale as min_leaf * full_n / sample."""
    import numpy as np

    import rptree_tpu as rt

    rng = np.random.default_rng(5)
    centers = rng.normal(size=(32, 16)).astype(np.float32) * 4.0
    x = (centers[rng.integers(0, 32, 4096)]
         + 0.1 * rng.normal(size=(4096, 16)).astype(np.float32))
    q = (x[rng.integers(0, 4096, 24)]
         + 0.05 * rng.normal(size=(24, 16)).astype(np.float32))
    best = rt.tune_build(x, q, k=5, target_recall=0.9,
                         centers_estimate=32, sample=4096,
                         full_n=1_000_000, budgets=(1,),
                         probes_per_tree=(1.0,), measure=False)
    assert best["met"] and best["recall"] >= 0.9
    assert best["min_leaf"] in (64, 128, 256)  # around 4096/32
    # scale transfer: min_leaf_full ~ min_leaf * 1M/4096, power-of-2
    ml_f = best["min_leaf_full"]
    assert ml_f >= best["min_leaf"] * (1_000_000 // 4096)
    assert ml_f & (ml_f - 1) == 0
    assert len(best["frontier"]) == 3  # the 3-point min_leaf grid


def test_rp_tree_cfg_clustered():
    import pytest

    import rptree_tpu as rt

    cfg = rt.rp_tree_cfg_clustered(1_000_000, 128, centers=4000)
    assert cfg.min_leaf == 250  # n / centers
    assert cfg.max_depth == 12  # ceil(log2(1M / 250))
    with pytest.raises(ValueError):
        rt.rp_tree_cfg_clustered(1000, 8, centers=0)
