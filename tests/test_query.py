"""Query-path tests: statistical assertions mirroring the reference hspec
suite (knn hits inside the query's own disk, RPTreeSpec.hs:60-106) plus
exact parity against the numpy oracle that re-executes the reference
semantics."""

import numpy as np
import pytest

from rptree_tpu import forest_batch, rp_tree_cfg, tree_batch
from rptree_tpu.reference import (
    ref_candidates,
    ref_forest_batch,
    ref_knn,
    ref_recall_with,
    leaf_spans,
)
from rptree_tpu.utils import gen as rgen

SEED = 20260816


@pytest.fixture(scope="module")
def circle_forest():
    n, ntrees, min_leaf, dim = 2048, 8, 20, 2
    cfg = rp_tree_cfg(min_leaf, n, dim)
    x = np.asarray(rgen.data_batch(SEED, n, rgen.circle2d2), dtype=np.float32)
    f = forest_batch(SEED, cfg.max_depth, min_leaf, ntrees, 1.0, x)
    return f, x


def test_knn_hits_inside_disk(circle_forest):
    # query at the (0,0) disk center: all k=5 hits must be inside that disk
    # (distance < 1), the reference's statistical assertion
    # (RPTreeSpec.hs:68-85)
    f, _ = circle_forest
    q = np.zeros(2, np.float32)
    for fn in (f.knn, f.knn_pq, f.knn_h):
        dists, ids = fn(q, 5)
        dists = np.asarray(dists)[0]
        assert np.all(ids[0] >= 0).item()
        assert dists.max() < 1.0
        assert np.all(np.diff(dists) >= 0)  # increasing distance order


def test_knn_batch_matches_single(circle_forest):
    f, x = circle_forest
    qs = np.asarray([[0.0, 0.0], [2.0, 3.0], [1.0, 1.5]], np.float32)
    db, ib = map(np.asarray, f.knn(qs, 4))
    for i, q in enumerate(qs):
        ds, is_ = map(np.asarray, f.knn(q, 4))
        np.testing.assert_allclose(db[i], ds[0], rtol=1e-6)
        np.testing.assert_array_equal(ib[i], is_[0])


def test_recall_reasonable(circle_forest):
    f, x = circle_forest
    qs = np.asarray(rgen.data_batch(99, 16, rgen.circle2d2), np.float32)
    rec = np.asarray(f.recall_with(qs, 10))
    # per-tree mean recall on an easy 2-D dataset should be substantial
    assert rec.mean() > 0.4
    # and forest-level knn with full budget should recover nearly everything
    d_exact, i_exact = map(np.asarray, f.brute_force_knn(qs, 10))
    d_ann, i_ann = map(np.asarray, f.knn(qs, 10, budget=f.plan.n_leaves))
    hit = (i_exact[:, :, None] == i_ann[:, None, :]).any(-1).mean()
    assert hit > 0.9


# ---------------------------------------------------------------------------
# exact parity vs the numpy oracle (reference semantics)
# ---------------------------------------------------------------------------

def _build_pair(n=400, ntrees=3, max_depth=5, min_leaf=8, dim=4, seed=77):
    x = np.asarray(rgen.data_batch(seed, n, lambda k, m: rgen.dense(k, m, dim)),
                   dtype=np.float32)
    f = forest_batch(seed, max_depth, min_leaf, ntrees, 1.0, x)
    rs = np.asarray(f.arrays.r, dtype=np.float32)
    ref = ref_forest_batch(x.astype(np.float64), rs.astype(np.float64),
                           max_depth, min_leaf)
    return f, ref, x


def test_leaf_contents_match_oracle():
    """Same projections => identical leaf buckets (up to float-sum noise,
    which the integer check below excludes)."""
    f, ref, x = _build_pair()
    for t in range(f.n_trees):
        eng_leaves = [sorted(l) for l in f.leaves(t)]
        orc_leaves = [sorted(ids.tolist()) for ids in leaf_spans(ref[t])]
        assert len(eng_leaves) == len(orc_leaves)
        mismatched = sum(a != b for a, b in zip(eng_leaves, orc_leaves))
        # float32 GEMM vs float64 matvec can flip points at ulp-equal
        # projections; require near-total agreement
        assert mismatched <= max(1, len(eng_leaves) // 20)


def test_candidates_match_oracle():
    f, ref, x = _build_pair()
    qs = np.asarray(rgen.data_batch(5, 8, lambda k, m: rgen.dense(k, m, 4)),
                    np.float32)
    cand = np.asarray(f.candidates(qs, budget=f.plan.n_leaves))  # [T, B, C]
    agree = 0
    total = 0
    for t in range(f.n_trees):
        for b, q in enumerate(qs):
            mine = set(int(i) for i in cand[t, b] if i >= 0)
            orc = set(ref_candidates(ref[t], q.astype(np.float64)).tolist())
            total += 1
            if mine == orc:
                agree += 1
    assert agree >= total - 2  # allow ulp-level divergence on margins


def test_knn_matches_oracle():
    f, ref, x = _build_pair()
    qs = np.asarray(rgen.data_batch(5, 6, lambda k, m: rgen.dense(k, m, 4)),
                    np.float32)
    d_t, i_t = map(np.asarray, f.knn(qs, 5, budget=f.plan.n_leaves))
    for b, q in enumerate(qs):
        d_o, i_o = ref_knn(ref, x.astype(np.float64), q.astype(np.float64),
                           5, dedup=True)
        # distances agree to float tolerance
        np.testing.assert_allclose(d_t[b], d_o, rtol=2e-4, atol=2e-5)


def test_recall_matches_oracle():
    f, ref, x = _build_pair()
    qs = np.asarray(rgen.data_batch(17, 4, lambda k, m: rgen.dense(k, m, 4)),
                    np.float32)
    rec_t = np.asarray(f.recall_with(qs, 5, budget=f.plan.n_leaves))
    for b, q in enumerate(qs):
        rec_o = ref_recall_with(ref, x.astype(np.float64),
                                q.astype(np.float64), 5)
        assert rec_t[b] == pytest.approx(rec_o, abs=0.15)


def test_budget_one_still_returns_k():
    f, _, _ = _build_pair()
    q = np.zeros(4, np.float32)
    d, i = map(np.asarray, f.knn(q, 3, budget=1))
    assert (i[0] >= 0).all()
    assert np.isfinite(d[0]).all()


def test_packed_knn_matches_unpacked(circle_forest):
    """pack_leaves() must not change kNN results (leaf-blocked rerank is a
    layout change, not a semantic one)."""
    f, x = circle_forest
    qs = np.asarray(rgen.data_batch(123, 9, rgen.circle2d2), np.float32)
    d1, i1 = map(np.asarray, f.knn(qs, 7))
    f.pack_leaves()
    try:
        d2, i2 = map(np.asarray, f.knn(qs, 7))
        d3, i3 = map(np.asarray, f.knn(qs, 7, budget=f.plan.n_leaves))
        d4, i4 = map(np.asarray, f.knn(qs, 7, probes=4))
    finally:
        f._packed = None  # other tests share this module-scoped fixture
    np.testing.assert_allclose(d1, d2, atol=1e-4)
    for b in range(9):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
    # exact-budget packed agrees with exact-budget unpacked
    d5, i5 = map(np.asarray, f.knn(qs, 7, budget=f.plan.n_leaves))
    np.testing.assert_allclose(d3, d5, atol=1e-4)
    # probes cap still returns full, valid top-k on this easy dataset
    assert (i4 >= 0).all()


def test_packed_bf16_preserves_neighbours():
    """bf16-packed blocks halve fetch bytes; neighbour ids must be
    preserved (distance values at small d carry bf16 cancellation noise
    from the factored |x|^2 - 2x.q + |q|^2 form)."""
    import jax.numpy as jnp

    x = np.asarray(rgen.data_batch(8, 1000,
                                   lambda k, m: rgen.dense(k, m, 16)),
                   np.float32)
    f = forest_batch(5, 5, 8, 4, 1.0, x)
    q = x[:12] + 0.05
    d1, i1 = map(np.asarray, f.knn(q, 5))
    f.pack_leaves(dtype=jnp.bfloat16)
    d2, i2 = map(np.asarray, f.knn(q, 5))
    overlap = np.mean([len(set(i1[b].tolist()) & set(i2[b].tolist())) / 5
                       for b in range(12)])
    assert overlap >= 0.9
    same = i1 == i2
    np.testing.assert_allclose(d1[same], d2[same], atol=0.3)


def test_knn_h_packed_matches_unpacked(circle_forest):
    """knn_h on the leaf-blocked path applies the same global bucket-stop
    rule; results must match the unpacked implementation."""
    f, x = circle_forest
    qs = np.asarray(rgen.data_batch(321, 8, rgen.circle2d2), np.float32)
    d1, i1 = map(np.asarray, f.knn_h(qs, 6))
    f.pack_leaves()
    try:
        d2, i2 = map(np.asarray, f.knn_h(qs, 6))
    finally:
        f._packed = None
    np.testing.assert_allclose(d1, d2, atol=1e-4)
    for b in range(8):
        assert set(i1[b].tolist()) == set(i2[b].tolist())


def test_min_votes_filter(circle_forest):
    """Voting (Hyvonen et al. 2016): candidates must appear in >= v trees;
    distances weakly increase with the threshold; packed path agrees."""
    f, x = circle_forest
    qs = np.asarray(rgen.data_batch(55, 8, rgen.circle2d2), np.float32)
    d1, i1 = map(np.asarray, f.knn(qs, 6))
    d2, i2 = map(np.asarray, f.knn(qs, 6, min_votes=3))
    assert np.all(d2 >= d1 - 1e-6)
    cand = np.asarray(f.candidates(qs))
    for b in range(8):
        for pid in i2[b]:
            if pid >= 0:
                votes = sum((cand[t, b] == pid).any()
                            for t in range(f.n_trees))
                assert votes >= 3
    f.pack_leaves()
    try:
        d3, i3 = map(np.asarray, f.knn(qs, 6, min_votes=3))
    finally:
        f._packed = None
    np.testing.assert_allclose(d2, d3, atol=1e-4)


def test_drop_dataset_serve_only():
    """Serve-only mode keeps packed queries working without the raw data."""
    x = np.asarray(rgen.data_batch(77, 900, rgen.circle2d2), np.float32)
    f = forest_batch(77, 5, 10, 4, 1.0, x)
    q = x[:4]
    d1, i1 = map(np.asarray, f.knn(q, 5))
    f.pack_leaves().drop_dataset()
    d2, i2 = map(np.asarray, f.knn(q, 5))
    np.testing.assert_allclose(d1, d2, atol=1e-4)
    assert f.dim == 2
    with pytest.raises(ValueError):
        forest_batch(77, 5, 10, 4, 1.0, x).drop_dataset()  # not packed


def test_add_and_rebuild_freshness():
    """Online insert: pending points are exactly searchable immediately
    (freshness layer) and fold into the index on rebuild -- the batched
    form of the reference's streaming insert (Internal.hs:257-297)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(500, 8)).astype(np.float32)
    f = forest_batch(2, 5, 8, 3, 1.0, x, payloads=[f"p{i}" for i in range(500)])
    new = rng.normal(size=(30, 8)).astype(np.float32) + 6.0
    f.add(new, payloads=[f"n{i}" for i in range(30)])
    q = new[:4] + 0.01
    _, ids = map(np.asarray, f.knn(q, 3))
    assert (ids[:, 0] >= 500).all()          # freshest points win
    assert f.payload_of(ids[:1, :1])[0].startswith("n")  # pending payloads
    f.rebuild()
    assert f.tree_size() == 530 and f.n_pending == 0
    _, ids2 = map(np.asarray, f.knn(q, 3))
    assert all(f.payload_of([i])[0].startswith("n") for i in ids2[:, 0])
    # auto-rebuild threshold
    f.add(new[:5], rebuild_every=4)
    assert f.n_pending == 0 and f.tree_size() == 535
    # packed path merges pending too
    f.pack_leaves()
    f.add(new[:2] + 10.0)
    _, ids3 = map(np.asarray, f.knn(new[:1] + 10.0, 1))
    assert ids3[0, 0] >= 535


def test_remove_tombstones_and_purge():
    """Deletions take effect immediately (tombstones) and purge on rebuild,
    renumbering ids; payloads follow their points."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    f = forest_batch(4, 5, 8, 3, 1.0, x,
                     payloads=[f"p{i}" for i in range(400)])
    q = x[:3] + 1e-3
    _, i0 = map(np.asarray, f.knn(q, 1))
    assert (i0[:, 0] == np.arange(3)).all()
    f.remove([0, 1, 2])
    _, i1 = map(np.asarray, f.knn(q, 2))
    assert not set(i1.reshape(-1).tolist()) & {0, 1, 2}
    f.rebuild()
    assert f.tree_size() == 397
    _, i2 = map(np.asarray, f.knn(q, 1))
    # original point 3 is now row 0; payload identity is preserved
    assert f.payload_of(i2[:1, 0]) != ["p0"]
    assert all(p.startswith("p") for p in f.payload_of(i2[:, 0]))


def test_remove_pending_point():
    """A freshly added (pending, not yet rebuilt) point must be removable:
    its id addresses the pending buffer, it disappears from results
    immediately, and rebuild() drops it instead of folding it in."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    f = forest_batch(6, 5, 8, 3, 1.0, x)
    new = rng.normal(size=(4, 8)).astype(np.float32) + 7.0
    f.add(new)
    q = new[:1] + 1e-3
    _, ia = map(np.asarray, f.knn(q, 2))
    assert ia[0, 0] >= 300
    f.remove(ia[:1, 0])
    _, ib = map(np.asarray, f.knn(q, 2))
    assert ia[0, 0] not in set(ib.reshape(-1).tolist())
    assert ib[0, 0] >= 300  # the other pending points still show up
    f.rebuild()
    assert f.tree_size() == 303  # deleted pending row was purged
    _, ic = map(np.asarray, f.knn(q, 3))
    d_exact, _ = map(np.asarray, f.brute_force_knn(q, 3))
    assert (ic[0] >= 0).all()


def test_fold_incremental_insert():
    """fold(): pending points descend the stored thresholds and land in
    their leaves' slack slots -- immediately findable by normal probing,
    payloads and deletes follow, rebuild() folds them for real
    (reference ``insert``'s bounded-work online update,
    Internal.hs:257-297)."""
    rng = np.random.default_rng(33)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    f = forest_batch(8, 4, 16, 3, 1.0, x,
                     payloads=[f"p{i}" for i in range(600)])
    f.pack_leaves(slack=16)
    new = rng.normal(size=(10, 8)).astype(np.float32)
    f.add(new, payloads=[f"n{i}" for i in range(10)])
    f.fold()
    assert f.n_pending == 0 and f.n_folded == 10
    # folded points are found by BLOCK probing (not the pending merge)
    q = new + 1e-4
    _, ids = map(np.asarray, f.knn(q, 1, budget=f.plan.n_leaves))
    assert (ids[:, 0] >= 600).all()
    assert f.payload_of(ids[:3, 0]) == [f"n{i}" for i in range(3)]
    # base points still found
    _, ib = map(np.asarray, f.knn(x[:5] + 1e-4, 1, budget=8))
    assert (ib[:, 0] == np.arange(5)).all()
    # delete a folded point
    f.remove(ids[:1, 0])
    _, ids2 = map(np.asarray, f.knn(q[:1], 1, budget=f.plan.n_leaves))
    assert ids2[0, 0] != ids[0, 0]
    # rebuild folds everything into a fresh exact index
    f.rebuild()
    assert f.tree_size() == 609 and f.n_folded == 0


def test_fold_overflow_stays_pending():
    """Points whose leaf is full in any tree stay in the exact pending
    merge (still searchable) instead of being dropped."""
    rng = np.random.default_rng(34)
    x = rng.normal(size=(400, 4)).astype(np.float32)
    f = forest_batch(9, 4, 8, 2, 1.0, x)
    f.pack_leaves()  # slack=0: max-size leaves have NO room
    new = rng.normal(size=(50, 4)).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_pending + f.n_folded == 50
    assert f.n_pending > 0  # slack-0 packing can't absorb everything
    # every new point still findable (block or pending merge)
    _, ids = map(np.asarray, f.knn(new + 1e-5, 1, budget=f.plan.n_leaves))
    assert (ids[:, 0] >= 400).all()


def test_fold_is_sublinear():
    """Amortized fold cost must not scale with the index size: folding a
    small chunk is far cheaper than rebuild() at the same n."""
    import time

    rng = np.random.default_rng(35)
    x = rng.normal(size=(30_000, 16)).astype(np.float32)
    f = forest_batch(10, 8, 32, 3, 1.0, x)
    f.pack_leaves(slack=8)
    new = rng.normal(size=(32, 16)).astype(np.float32)
    # warm the jitted descend/scatter kernels on identical shapes
    f.add(new)
    f.fold()
    f.add(new + 1.0)
    t0 = time.perf_counter()
    f.fold()
    fold_s = time.perf_counter() - t0
    g = forest_batch(10, 8, 32, 3, 1.0, x)
    g.pack_leaves(slack=8)
    g.add(new)
    t0 = time.perf_counter()
    g.rebuild()
    rebuild_s = time.perf_counter() - t0
    assert fold_s < rebuild_s / 5, (fold_s, rebuild_s)


def test_fold_into_int8_blocks():
    """fold() quantizes folded rows with the target block's scale; new
    points are findable through the int8 scorer."""
    import jax.numpy as jnp

    rng = np.random.default_rng(44)
    x = rng.normal(size=(500, 8)).astype(np.float32)
    f = forest_batch(13, 4, 16, 2, 1.0, x)
    f.pack_leaves(dtype=jnp.int8, slack=8)
    new = rng.normal(size=(5, 8)).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_folded == 5 and f.n_pending == 0
    _, ids = map(np.asarray, f.knn(new + 1e-4, 1, budget=f.plan.n_leaves))
    assert (ids[:, 0] >= 500).all()


def test_packed_int8_preserves_neighbours():
    """int8 blocks (per-leaf scales, exact stored norms): 4x less fetch
    than f32; neighbour sets must stay essentially intact."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 32)).astype(np.float32)
    f = forest_batch(5, 6, 16, 6, 1.0, x)
    q = x[:16] + 0.02
    d1, i1 = map(np.asarray, f.knn(q, 8))
    f.pack_leaves(dtype=jnp.int8)
    d2, i2 = map(np.asarray, f.knn(q, 8))
    overlap = np.mean([len(set(i1[b].tolist()) & set(i2[b].tolist())) / 8
                       for b in range(16)])
    assert overlap >= 0.9
    same = i1 == i2
    np.testing.assert_allclose(d1[same], d2[same], atol=0.5)


@pytest.mark.parametrize("metric", ["sql2", "cosine", "dot"])
def test_packed_nonl2_metrics_match_unpacked(circle_forest, metric):
    f, x = circle_forest
    qs = np.asarray(rgen.data_batch(17, 6, rgen.circle2d2), np.float32)
    d1, i1 = map(np.asarray, f.knn(qs, 5, metric=metric))
    f.pack_leaves()
    try:
        d2, i2 = map(np.asarray, f.knn(qs, 5, metric=metric))
    finally:
        f._packed = None
    np.testing.assert_allclose(d1, d2, atol=1e-4)
    for b in range(6):
        assert set(i1[b].tolist()) == set(i2[b].tolist())


def test_brute_force_fastest_mode():
    """precision="fastest": bf16 tiles + approx_max_k per tile with an
    exact 2k merge; neighbour sets must stay essentially intact vs the
    exact f32 scan."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(5000, 32)).astype(np.float32)
    f = forest_batch(12, 3, 2048, 1, 1.0, x)
    q = x[:16] + 0.01
    d1, i1 = map(np.asarray, f.brute_force_knn(q, 10))
    d2, i2 = map(np.asarray, f.brute_force_knn(q, 10, precision="fastest"))
    overlap = np.mean([len(set(i1[b]) & set(i2[b])) / 10 for b in range(16)])
    assert overlap >= 0.9
    assert (np.asarray(d2)[:, 0] < 1.0).all()


def test_knn_h_respects_remove_and_add():
    """Review finding r2: knn_h (packed and unpacked) must apply
    tombstones and the exact pending merge, like knn."""
    rng = np.random.default_rng(50)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    for pack in (False, True):
        f = forest_batch(14, 5, 8, 3, 1.0, x)
        if pack:
            f.pack_leaves()
        q = x[:2] + 1e-4
        _, i0 = map(np.asarray, f.knn_h(q, 1, budget=8))
        assert (i0[:, 0] == np.arange(2)).all(), pack
        f.remove([0, 1])
        _, i1 = map(np.asarray, f.knn_h(q, 2, budget=8))
        assert not set(i1.reshape(-1).tolist()) & {0, 1}, pack
        f.add(x[:2] + 5.0)
        _, i2 = map(np.asarray, f.knn_h(x[:1] + 5.0, 1, budget=8))
        assert i2[0, 0] >= 400, pack


def test_knn_batched_matches_chunked_knn():
    """knn_batched (one-dispatch lax.map over chunks) must equal chunked
    knn calls exactly, including the padded tail and update hooks."""
    rng = np.random.default_rng(51)
    x = rng.normal(size=(2000, 8)).astype(np.float32)
    f = forest_batch(15, 5, 16, 3, 1.0, x).pack_leaves()
    q = rng.normal(size=(37, 8)).astype(np.float32)
    d1, i1 = map(np.asarray, f.knn(q, 5, budget=4, probes=8))
    d2, i2 = map(np.asarray, f.knn_batched(q, 5, budget=4, probes=8,
                                           chunk=16))
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)
    # hooks: removed points vanish, pending points appear
    f.remove(i1[:1, 0])
    f.add(q[:1] * 0 + 50.0)
    d3, i3 = map(np.asarray, f.knn_batched(q, 5, budget=4, probes=8,
                                           chunk=16))
    assert i1[0, 0] not in set(i3[0].tolist())
    d4, i4 = map(np.asarray,
                 f.knn_batched(np.full((1, 8), 50.0, np.float32), 1))
    assert i4[0, 0] >= 2000


def test_brute_force_query_chunk_matches():
    rng = np.random.default_rng(52)
    x = rng.normal(size=(1500, 8)).astype(np.float32)
    f = forest_batch(16, 3, 1024, 1, 1.0, x)
    q = rng.normal(size=(23, 8)).astype(np.float32)
    d1, i1 = map(np.asarray, f.brute_force_knn(q, 6))
    d2, i2 = map(np.asarray, f.brute_force_knn(q, 6, query_chunk=8))
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)


def test_fold_oracle_includes_folded_rows():
    """After fold(), brute_force_knn / recall_with / points() cover the
    fold-appended rows, so the ground-truth oracle agrees with the index
    contents: a returned folded neighbour counts as a hit, and points()
    round-trips the index (an oracle that scanned only self.x would
    disagree with the packed blocks)."""
    rng = np.random.default_rng(55)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    f = forest_batch(8, 4, 16, 3, 1.0, x)
    f.pack_leaves(slack=16)
    new = rng.normal(size=(10, 8)).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_folded == 10
    pts = f.points()
    assert pts.shape == (610, 8)
    np.testing.assert_allclose(pts[600:], new, rtol=1e-6)
    q = new + 1e-4
    # exact scan names the folded rows as the true nearest neighbours
    _, bf = map(np.asarray, f.brute_force_knn(q, 1))
    assert (bf[:, 0] >= 600).all()
    _, bf2 = map(np.asarray, f.brute_force_knn(q, 1, query_chunk=4))
    assert (bf2 == bf).all()
    # recall counts the folded neighbour as found when its leaf is probed
    # (fold places points on the primary descent side, the same side the
    # query traversal follows at the query's own location)
    r = np.asarray(f.recall_with(q, 1, budget=f.plan.n_leaves))
    assert float(r.mean()) >= 0.8
    # knn agrees with the folded-aware oracle end to end
    _, ids = map(np.asarray, f.knn(q, 1, budget=f.plan.n_leaves))
    assert (ids == bf).all()
    # knn_h's bucket-stop sizes now count the dynamic occupancy
    _, ih = map(np.asarray, f.knn_h(q, 1, budget=f.plan.n_leaves))
    assert (ih[:, 0] >= 600).all()


def test_knn_h_buckets_reference_contract():
    """knn_h_buckets returns the SELECTED BUCKETS' contents, unsorted and
    untruncated (the reference knnH's return type, RPTree.hs:196-217) --
    a superset of knn_h's reranked top-k."""
    rng = np.random.default_rng(56)
    x = rng.normal(size=(500, 6)).astype(np.float32)
    f = forest_batch(9, 4, 16, 3, 1.0, x)
    k = 5
    raw = np.asarray(f.knn_h_buckets(x[:8], k))
    assert raw.ndim == 2 and raw.shape[0] == 8
    # untruncated: the bucket union is larger than k (min_leaf=16 > k)
    live_counts = (raw >= 0).sum(axis=1)
    assert (live_counts >= k).all()
    # contains every id knn_h returns (knn_h = rerank(raw buckets))
    _, ids = map(np.asarray, f.knn_h(x[:8], k, dedup=True))
    for b in range(8):
        got = set(i for i in ids[b].tolist() if i >= 0)
        assert got <= set(raw[b].tolist())


def test_knn_h_buckets_includes_folded_rows():
    """After fold(), knn_h_buckets reads the PACKED id blocks with the
    dynamic occupancies: fold-appended rows appear in their assigned
    buckets and count toward the cumulative stop rule (the contract
    tracks index contents, not just the build permutation)."""
    rng = np.random.default_rng(57)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    f = forest_batch(8, 4, 16, 3, 1.0, x)
    f.pack_leaves(slack=16)
    new = rng.normal(size=(8, 8)).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_folded == 8
    q = new + 1e-4
    raw = np.asarray(f.knn_h_buckets(q, 4, budget=f.plan.n_leaves))
    # each query's nearest neighbour is its folded twin; the twin's
    # bucket is the first selected, so the folded id must appear
    for b in range(8):
        got = set(i for i in raw[b].tolist() if i >= 0)
        assert (600 + b) in got, (b, sorted(got)[:20])
    # and knn_h's reranked ids stay a subset of the raw buckets
    _, ih = map(np.asarray, f.knn_h(q, 4, budget=f.plan.n_leaves))
    for b in range(8):
        assert {i for i in ih[b].tolist() if i >= 0} <= set(raw[b].tolist())


def test_rebuild_replays_pack_config():
    """rebuild() re-packs with the REMEMBERED pack configuration
    (dtype/centered/sub_block), not a silent f32 downgrade."""
    import jax.numpy as jnp

    rng = np.random.default_rng(58)
    x = (3.0 + rng.normal(size=(500, 8))).astype(np.float32)
    f = forest_batch(11, 4, 16, 2, 1.0, x)
    f.pack_leaves(dtype=jnp.int8, centered=True, slack=8)
    f.add(rng.normal(size=(4, 8)).astype(np.float32))
    f.rebuild()
    assert f._packed[0].dtype == jnp.int8
    assert f._block_scale is not None
    assert f._block_center is not None
    # sub-blocked bf16 pack replays too
    g = forest_batch(11, 4, 16, 2, 1.0, x)
    g.pack_leaves(dtype=jnp.bfloat16, sub_block=2)
    g.add(rng.normal(size=(4, 8)).astype(np.float32))
    g.rebuild()
    assert g._packed[0].dtype == jnp.bfloat16
    assert g._sub_block == 2 and g._sub_len_dev is not None


def test_centered_int8_blocks_beat_plain_int8_on_clustered():
    """Centered (residual) int8 blocks: the block mean stays f32 and only
    residuals quantize, shrinking the cross-term error by the
    center-to-spread ratio.  On clustered data (large shared centers,
    near-equidistant in-cluster neighbours) plain int8 scrambles the
    ranking; centered int8 must track the f32 ranking."""
    import jax.numpy as jnp

    rng = np.random.default_rng(60)
    c, dim, n = 24, 32, 2400
    centers = 10.0 * rng.normal(size=(c, dim))
    assign = rng.integers(0, c, size=n)
    x = (centers[assign]
         + 0.1 * rng.normal(size=(n, dim))).astype(np.float32)
    q = x[:32] + 0.02 * rng.normal(size=(32, dim)).astype(np.float32)

    def overlap(dtype, centered=False):
        # deep trees -> leaves are pure fragments of one cluster, the
        # regime where a block mean is a good center (and the regime the
        # serving configs live in: min_leaf below the cluster size)
        f = forest_batch(21, 8, 16, 4, 1.0, x)
        f.pack_leaves(dtype=dtype, centered=centered)
        _, exact = map(np.asarray, f.brute_force_knn(q, 10))
        _, ids = map(np.asarray,
                     f.knn(q, 10, budget=8, precision="default"))
        return float(np.mean([
            len(set(ids[b].tolist()) & set(exact[b].tolist())) / 10
            for b in range(32)
        ]))

    ov_f32 = overlap(None)
    ov_plain = overlap(jnp.int8)
    ov_centered = overlap(jnp.int8, centered=True)
    # centering must close at least half the int8 -> f32 ranking gap
    # (the remainder comes from leaves that straddle clusters, where a
    # single block mean is a weak center -- median cuts do not aim to
    # separate clusters, so some straddling is inherent)
    assert ov_plain < ov_f32 - 0.05  # the regime where centering matters
    assert ov_centered >= ov_plain + 0.5 * (ov_f32 - ov_plain), (
        ov_f32, ov_plain, ov_centered)


def test_centered_int8_fold():
    """fold() into centered int8 blocks quantizes the residual with the
    target block's scale and updates the per-slot mean.residual term."""
    import jax.numpy as jnp

    rng = np.random.default_rng(61)
    x = (5.0 + rng.normal(size=(500, 8))).astype(np.float32)
    f = forest_batch(13, 4, 16, 2, 1.0, x)
    f.pack_leaves(dtype=jnp.int8, centered=True, slack=8)
    new = (5.0 + rng.normal(size=(5, 8))).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_folded == 5 and f.n_pending == 0
    _, ids = map(np.asarray, f.knn(new + 1e-4, 1, budget=f.plan.n_leaves))
    assert (ids[:, 0] >= 500).all()


def test_sub_block_pack_parity_and_centered_rescue():
    """Sub-leaf blocks: f32 sub-blocked packing is an
    EXACT re-blocking (same candidates, same results as whole-leaf
    blocks), and per-sub-block centers rescue centered int8 on leaves
    that straddle clusters (the projection-sorted slices are nearly
    pure, so each slice's mean is a tight center)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(62)
    c, dim, n = 24, 32, 2400
    centers = 10.0 * rng.normal(size=(c, dim))
    assign = rng.integers(0, c, size=n)
    x = (centers[assign]
         + 0.1 * rng.normal(size=(n, dim))).astype(np.float32)
    q = x[:32] + 0.02 * rng.normal(size=(32, dim)).astype(np.float32)

    # exact re-blocking parity (f32): identical neighbour sets
    f0 = forest_batch(21, 6, 32, 4, 1.0, x).pack_leaves()
    f4 = forest_batch(21, 6, 32, 4, 1.0, x).pack_leaves(sub_block=4)
    d0, i0 = map(np.asarray, f0.knn(q, 10, budget=8))
    d4, i4 = map(np.asarray, f4.knn(q, 10, budget=8))
    np.testing.assert_allclose(d0, d4, atol=1e-5)
    for b in range(32):
        assert set(i0[b].tolist()) == set(i4[b].tolist())
    # knn_batched through the sub-blocked layout
    d5, i5 = map(np.asarray, f4.knn_batched(q, 10, budget=8, chunk=8))
    np.testing.assert_array_equal(i4, i5)
    # knn_h still applies the reference stop rule at leaf granularity
    dh, ih = map(np.asarray, f4.knn_h(q[:4], 5, budget=8))
    assert (ih[:, 0] >= 0).all()

    def overlap(f):
        _, exact = map(np.asarray, f0.brute_force_knn(q, 10))
        _, ids = map(np.asarray,
                     f.knn(q, 10, budget=8, precision="default"))
        return float(np.mean([
            len(set(ids[b].tolist()) & set(exact[b].tolist())) / 10
            for b in range(32)
        ]))

    # SHALLOW forest: leaves straddle clusters, where whole-leaf centered
    # int8 falls well below f32 -- per-sub-block centers recover it
    ov_f32 = overlap(f0)
    fc = forest_batch(21, 6, 32, 4, 1.0, x)
    fc.pack_leaves(dtype=jnp.int8, centered=True)
    ov_cent = overlap(fc)
    fcs = forest_batch(21, 6, 32, 4, 1.0, x)
    fcs.pack_leaves(dtype=jnp.int8, centered=True, sub_block=8)
    ov_cent_sub = overlap(fcs)
    # the residue vs f32 is the ONE mixed boundary slice per straddle
    # (~ls/leaf_len of the rows); everything else scores at f32 level
    assert ov_cent_sub > ov_cent + 0.15, (ov_f32, ov_cent, ov_cent_sub)
    # boundary-adaptive 2-means ordering: at least
    # as good as the projection sort, and f32 re-blocking stays exact
    fcp = forest_batch(21, 6, 32, 4, 1.0, x)
    fcp.pack_leaves(dtype=jnp.int8, centered=True, sub_block=8,
                    sub_split="proj")
    ov_cent_proj = overlap(fcp)
    assert ov_cent_sub >= ov_cent_proj - 0.02, (ov_cent_sub, ov_cent_proj)
    fk = forest_batch(21, 6, 32, 4, 1.0, x).pack_leaves(
        sub_block=4, sub_split="kmeans")
    dk, ik = map(np.asarray, fk.knn(q, 10, budget=8))
    np.testing.assert_allclose(d0, dk, atol=1e-5)
    for b in range(32):
        assert set(i0[b].tolist()) == set(ik[b].tolist())
    # non-power-of-two sub falls back to the projection sort silently
    f3 = forest_batch(21, 6, 32, 4, 1.0, x).pack_leaves(sub_block=3)
    assert f3._pack_cfg["sub_split"] == "proj"
    with pytest.raises(ValueError, match="sub_split"):
        forest_batch(21, 6, 32, 2, 1.0, x).pack_leaves(sub_block=4,
                                                       sub_split="bogus")
    # guards: fold/slack are whole-leaf features
    with pytest.raises(ValueError, match="sub_block"):
        forest_batch(21, 6, 32, 2, 1.0, x).pack_leaves(sub_block=4,
                                                       slack=4)
    fcs.add(x[:2] + 0.5)
    with pytest.raises(ValueError, match="whole-leaf"):
        fcs.fold()

