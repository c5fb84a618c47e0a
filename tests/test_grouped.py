"""Query-grouped block-resident rerank: exact parity with the per-pair
packed path (same probes, same candidates, same top-k) across dtypes,
capacities, fold, and the knnH bucket-stop rule."""

import numpy as np
import jax.numpy as jnp
import pytest

from rptree_tpu import forest_batch, rp_tree_cfg

SEED = 20260816
K = 10


def _mk(n=4096, dim=16, trees=4, min_leaf=32, centers=24, qnoise=0.1,
        **pack):
    rng = np.random.default_rng(SEED)
    c = rng.normal(size=(centers, dim)).astype(np.float32)
    x = (c[rng.integers(0, centers, n)]
         + 0.2 * rng.normal(size=(n, dim)).astype(np.float32))
    cfg = rp_tree_cfg(min_leaf, n, dim)
    f = forest_batch(SEED, cfg.max_depth, min_leaf, trees,
                     cfg.proj_nz_density, x)
    f.pack_leaves(**pack)
    q = (x[rng.integers(0, n, 64)]
         + qnoise * rng.normal(size=(64, dim)).astype(np.float32))
    return f, q


def _assert_same(f, q, grouped_kw=None, knn_kw=None, tol=1e-5,
                 min_overlap=1.0):
    gk = dict(grouped_kw or {})
    kk = dict(knn_kw or {})
    dg, ig = map(np.asarray, f.knn_grouped(q, K, **gk))
    dp, ip = map(np.asarray, f.knn(q, K, **kk))
    np.testing.assert_allclose(dg, dp, rtol=tol, atol=tol)
    # near-tied distances may order differently between the grouped and
    # per-pair contractions; compare as sets (and for low-precision block
    # dtypes, whose accumulation order differs, as mean set overlap)
    ov = np.mean([
        len(set(ig[b].tolist()) & set(ip[b].tolist())) / K
        for b in range(q.shape[0])
    ])
    assert ov >= min_overlap, ov


def test_grouped_matches_packed_f32():
    f, q = _mk()
    _assert_same(f, q)


def test_grouped_matches_packed_dtypes():
    # bf16/int8 dots accumulate in a different order between the grouped
    # and per-pair einsums, so near-tie distances/rankings may flip; the
    # distances agree to block-dtype precision and the result sets overlap.
    # (qnoise keeps query-point distances away from zero: the factored L2
    # cancellation otherwise amplifies dtype noise unboundedly -- for BOTH
    # paths -- and the comparison would test luck, not the grouping.)
    for pack in ({"dtype": jnp.bfloat16}, {"dtype": jnp.int8},
                 {"dtype": jnp.int8, "centered": True}):
        f, q = _mk(qnoise=1.0, **pack)
        _assert_same(f, q, tol=3e-2, min_overlap=0.9)


def test_grouped_capacity_retry_and_cache():
    f, q = _mk()
    # force an undersized first capacity: the auto-retry must still
    # return exact results and cache the learned capacity
    d1, i1 = map(np.asarray, f.knn_grouped(q, K, tile_chunk=8))
    key = next(iter(f._grouped_nt))
    assert f._grouped_nt[key] >= 8
    d2, i2 = map(np.asarray, f.knn(q, K))
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
    # an explicitly too-small nt is NOT exact and is the caller's choice;
    # it must still run and mask (never crash)
    d3, _ = f.knn_grouped(q, K, nt=8, tile_chunk=8)
    assert np.isfinite(np.asarray(d3)).any()


def test_grouped_check_false_serving_mode():
    f, q = _mk()
    de, ie = map(np.asarray, f.knn(q, K))
    # no cached capacity yet: check=False still validates the first call
    d1, i1 = map(np.asarray, f.knn_grouped(q, K, check=False))
    np.testing.assert_allclose(d1, de, rtol=1e-5, atol=1e-5)
    assert f._grouped_nt  # ...and caches
    cap = dict(f._grouped_nt)
    # steady state: the cached capacity is reused without the host fetch
    # (observable: the cache is not re-tightened/touched) and results
    # stay exact
    d2, i2 = map(np.asarray, f.knn_grouped(q, K, check=False))
    np.testing.assert_allclose(d2, de, rtol=1e-5, atol=1e-5)
    assert f._grouped_nt == cap
    np.testing.assert_array_equal(i1, i2)
    # explicit nt + check=False: runs without any capacity fetch; a
    # too-small capacity masks (soft degradation), never crashes
    d3, _ = f.knn_grouped(q, K, nt=8, tile_chunk=8, check=False)
    assert np.isfinite(np.asarray(d3)).any()


def test_grouped_chunked_one_dispatch():
    f, q = _mk()
    de, ie = map(np.asarray, f.knn(q, K))
    # chunk divides the batch
    d1, i1 = map(np.asarray, f.knn_grouped(q, K, chunk=16))
    np.testing.assert_allclose(d1, de, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i1, ie)
    # chunk does NOT divide the batch: zero-padded, sliced back
    d2, i2 = map(np.asarray, f.knn_grouped(q[:50], K, chunk=16))
    np.testing.assert_allclose(d2, de[:50], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i2, ie[:50])
    # per-chunk capacity key is distinct from the unchunked one and the
    # steady-state mode composes
    assert (64, f.n_trees * 4, 16, 1, 16) in f._grouped_nt \
        or any(len(k) == 5 for k in f._grouped_nt)
    d3, i3 = map(np.asarray, f.knn_grouped(q, K, chunk=16, check=False))
    np.testing.assert_allclose(d3, de, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i3, ie)


def test_grouped_chunked_capacity_retry():
    f, q = _mk()
    de, _ = map(np.asarray, f.knn(q, K))
    # tiny tile_chunk forces a low first guess -> auto-retry per chunk
    d1, _ = map(np.asarray, f.knn_grouped(q, K, chunk=8, tile_chunk=8))
    np.testing.assert_allclose(d1, de, rtol=1e-5, atol=1e-5)


def test_grouped_chunked_min_votes():
    f, q = _mk()
    d0, i0 = map(np.asarray, f.knn_grouped(q, K, min_votes=2))
    d1, i1 = map(np.asarray, f.knn_grouped(q, K, min_votes=2, chunk=16))
    np.testing.assert_allclose(d1, d0, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i1, i0)


def test_grouped_probes_cap_and_budget():
    f, q = _mk()
    _assert_same(f, q, {"probes": 3, "budget": 2}, {"probes": 3, "budget": 2})


def test_grouped_bucket_stop_matches_knn_h():
    f, q = _mk()
    dg, ig = map(np.asarray, f.knn_grouped(q, K, bucket_stop=True))
    dp, ip = map(np.asarray, f.knn_h(q, K))
    np.testing.assert_allclose(dg, dp, rtol=1e-5, atol=1e-5)
    for b in range(q.shape[0]):
        assert set(ig[b].tolist()) == set(ip[b].tolist())


def test_grouped_after_fold():
    f, q = _mk()
    f2, _ = _mk()
    # repack with slack, fold a chunk in, and check parity again
    f2._packed = None
    f2.pack_leaves(slack=8)
    rng = np.random.default_rng(7)
    f2.add(rng.normal(size=(32, 16)).astype(np.float32))
    f2.fold()
    assert f2.n_folded > 0
    _assert_same(f2, q)


def test_grouped_sub_block():
    f, q = _mk(sub_block=2)
    _assert_same(f, q)


def test_grouped_after_rebuild_rereads_occupancy():
    """rebuild() replaces the plan, so the cached static occupancy table
    must be invalidated -- a stale one silently masks/unmasks rows."""
    f, q = _mk(n=2048)
    _ = f.knn_grouped(q, K)  # caches the plan-A occupancy table
    rng = np.random.default_rng(3)
    f.add(rng.normal(size=(2048, 16)).astype(np.float32))
    f.rebuild()  # plan B: same leaf count regime, different leaf lengths
    # (tol: the two contraction orders differ by ~1e-5 on f32 at this n;
    # the BUG this test pins produced masking errors of ~1e0)
    _assert_same(f, q, tol=1e-4)


def test_grouped_explicit_nt_rounds_to_chunk():
    """A caller-given nt that is not a tile_chunk multiple must be
    rounded up, not crash the chunk reshape."""
    f, q = _mk()
    d, ids = map(np.asarray, f.knn_grouped(q, K, nt=3000, tile_chunk=64))
    d0, _ = map(np.asarray, f.knn(q, K))
    np.testing.assert_allclose(d, d0, rtol=1e-5, atol=1e-5)


def test_grouped_custom_metric_matches_knn():
    """User distance callables (the reference distf) through the grouped
    tiles: parity with the per-pair path; int8 blocks still reject."""
    l1 = lambda rows, qq: jnp.sum(jnp.abs(rows - qq), -1)  # noqa: E731
    f, q = _mk()
    dg, ig = map(np.asarray, f.knn_grouped(q, K, metric=l1))
    dp, ip = map(np.asarray, f.knn(q, K, metric=l1))
    np.testing.assert_allclose(dg, dp, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ig, ip)
    fi, _ = _mk(dtype=jnp.int8)
    with pytest.raises(NotImplementedError):
        fi.knn_grouped(q, K, metric=l1)


def test_grouped_ell_matches_knn():
    """ELL-sparse blocks through the grouped tiling: parity with the
    per-pair EllBlocks path (same probes, same candidates)."""
    import rptree_tpu as rt
    from rptree_tpu.ops.sparse import EllMatrix

    rng = np.random.default_rng(SEED)
    n, dim, nnz = 2048, 48, 6
    cols = rng.integers(0, dim, size=(n, nnz)).astype(np.int32)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    ell = EllMatrix(dim, jnp.asarray(cols), jnp.asarray(vals))
    f = rt.forest_batch(SEED, 6, 24, 3, 1.0, ell).pack_leaves()
    q = np.asarray(rt.ell_to_dense(ell))[:48] + np.float32(0.01)
    dg, ig = map(np.asarray, f.knn_grouped(q, K, budget=4))
    dp, ip = map(np.asarray, f.knn(q, K, budget=4))
    np.testing.assert_allclose(dg, dp, rtol=1e-5, atol=1e-5)
    for b in range(q.shape[0]):
        assert set(ig[b].tolist()) == set(ip[b].tolist())
    # bf16-valued sparse blocks run the same pipeline
    f2 = rt.forest_batch(SEED, 6, 24, 3, 1.0, ell).pack_leaves(
        dtype=jnp.bfloat16)
    db, ib = map(np.asarray, f2.knn_grouped(q, K, budget=4))
    db2, _ = map(np.asarray, f2.knn(q, K, budget=4))
    np.testing.assert_allclose(db, db2, rtol=3e-2, atol=3e-2)


def test_grouped_min_votes_matches_knn():
    """min_votes voting filter through the grouped tail: parity with the
    per-pair path."""
    f, q = _mk()
    for v in (2, 3):
        dg, ig = map(np.asarray, f.knn_grouped(q, K, min_votes=v))
        dp, ip = map(np.asarray, f.knn(q, K, min_votes=v))
        np.testing.assert_allclose(dg, dp, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ig, ip)


def test_grouped_capacity_cache_policy():
    """An explicit nt must not poison the learned capacity cache, and an
    oversized cached capacity re-tightens (every tile costs fetch+matmul
    work whether or not it is needed)."""
    f, q = _mk()
    f.knn_grouped(q, K, tile_chunk=16)
    key = next(iter(f._grouped_nt))
    learned = f._grouped_nt[key]
    # explicit generous capacity: same results, cache untouched
    cap_max = -(-q.shape[0] * f.n_trees * f._budget(None) * 16 // 16) * 16
    d1, _ = f.knn_grouped(q, K, tile_chunk=16, nt=4096)
    assert f._grouped_nt[key] == learned
    d0, _ = f.knn_grouped(q, K, tile_chunk=16)
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), atol=1e-5)
    # a wildly oversized cached value tightens on the next auto call
    f._grouped_nt[key] = learned * 8
    f.knn_grouped(q, K, tile_chunk=16)
    assert f._grouped_nt[key] <= 2 * learned


def test_grouped_overflow_telemetry():
    """check=False overflow is DETECTABLE without a per-batch host sync:
    the needed-tile count rides as a device scalar and
    grouped_overflow() fetches it on demand."""
    f, q = _mk()
    assert f.grouped_overflow() is None
    d0, i0 = map(np.asarray, f.knn_grouped(q, K))
    ov = f.grouped_overflow()
    assert ov is not None and not ov["overflow"]
    assert 0 < ov["needed"] <= ov["capacity"]
    # explicit undersized capacity in steady-state mode: pairs silently
    # mask (soft recall dip), and the telemetry reports the overflow
    f.knn_grouped(q, K, nt=8, tile_chunk=8, check=False)
    ov2 = f.grouped_overflow()
    assert ov2["overflow"] and ov2["needed"] == ov["needed"]
    assert ov2["capacity"] == 8
    # healthy steady-state serving reports no overflow
    f.knn_grouped(q, K, check=False)
    assert not f.grouped_overflow()["overflow"]
