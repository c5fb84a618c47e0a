"""Profiler surface: the reference's four SCC cost centers
(RPTree.hs:289, Internal.hs:244,257,484) map to ``jax.named_scope``
regions that survive into lowered HLO, and ``rptree_tpu.profiling.trace``
captures a perfetto trace without a throwaway script (SURVEY.md section 5
tracing/profiling)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import rptree_tpu as rt
from rptree_tpu.utils.profiling import SCOPES  # noqa: F401


def _mk(n=512, dim=8, trees=2, min_leaf=16):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, dim)).astype(np.float32)
    f = rt.forest_batch(3, 4, min_leaf, trees, 1.0, x)
    q = rng.normal(size=(8, dim)).astype(np.float32)
    return f, x, q


def test_query_scopes_in_lowered_hlo():
    """The serving pipeline names traversal, rerank, and the selection
    tail (the SCC-candidates analog + the hot-loop decomposition)."""
    from rptree_tpu.models.forest import _knn_packed

    f, x, q = _mk()
    f.pack_leaves()
    x_leaf, sq_leaf, id_leaf = f._packed
    lo = jax.jit(
        lambda a, xl, sl, il, qq: _knn_packed(
            f.plan, a, xl, sl, il, qq, 3, 4, 8, "l2", True)
    ).lower(f.arrays, x_leaf, sq_leaf, id_leaf, jnp.asarray(q))
    txt = lo.as_text(debug_info=True)
    for scope in ("rpt_candidates", "rpt_rerank", "rpt_topk_tail"):
        assert scope in txt, scope


def test_grouped_scopes_in_lowered_hlo():
    from rptree_tpu.models.forest import _knn_grouped

    f, x, q = _mk()
    f.pack_leaves()
    x_leaf, sq_leaf, id_leaf = f._packed
    lens = f._lens_global()
    lo = jax.jit(
        lambda a, xl, sl, il, qq: _knn_grouped(
            f.plan, a, xl, sl, il, lens, qq, 3, 4, 8, "l2", True,
            "highest", 8, 64, 16)
    ).lower(f.arrays, x_leaf, sq_leaf, id_leaf, jnp.asarray(q))
    txt = lo.as_text(debug_info=True)
    for scope in ("rpt_tile_tables", "rpt_grouped_score",
                  "rpt_pair_reorder", "rpt_topk_tail"):
        assert scope in txt, scope


def test_build_and_insert_scopes_in_lowered_hlo():
    from rptree_tpu.models.forest import _descend
    from rptree_tpu.ops.build import build_forest_arrays

    f, x, q = _mk()
    r = f.arrays.r
    lo = jax.jit(
        lambda xx, rr: build_forest_arrays(f.plan, xx, rr)
    ).lower(jnp.asarray(x), r)
    txt = lo.as_text(debug_info=True)
    assert "rpt_partition_at_median" in txt
    assert "rpt_project" in txt
    lo2 = jax.jit(
        lambda a, xx: _descend(f.plan, a, xx)
    ).lower(f.arrays, jnp.asarray(x[:4]))
    assert "rpt_insert" in lo2.as_text(debug_info=True)


def test_trace_helper_writes_capture(tmp_path):
    """rt.profiling.trace captures a profiler run (the user-invocable
    form of the stage decomposition)."""
    import os

    f, x, q = _mk()
    f.pack_leaves()
    logdir = str(tmp_path / "trace")
    try:
        with rt.profiling.trace(logdir):
            d, i = f.knn(q, 3)
            rt.profiling.sync(d, i)
    except Exception as e:  # pragma: no cover - env-specific profiler gaps
        pytest.skip(f"profiler unavailable on this backend: {e}")
    found = []
    for root, _dirs, files in os.walk(logdir):
        found += files
    assert any(fn.endswith((".pb", ".json.gz", ".xplane.pb"))
               for fn in found), found
