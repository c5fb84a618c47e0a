"""Data-parallel build (dataset sharded over points, distributed radix
median selection) vs the single-device builder.  SURVEY.md section 7
"Cross-shard median" -- the hard part of a sharded build; exactness of the
selection and of the stable tie split is the contract."""

import numpy as np
import pytest

import rptree_tpu as rt
from rptree_tpu.parallel.data_parallel import (
    data_mesh,
    forest_batch_data_parallel,
)

N, DIM, T = 1600, 24, 3
SEED = 909


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return rng.normal(size=(N, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def single(data):
    return rt.forest_batch(SEED, 6, 12, T, 1.0, data)


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_leaf_contents_match_single_device(single, data, n_shards):
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(n_shards))
    for t in range(T):
        l1 = [set(b) for b in single.leaves(t)]
        l2 = [set(b) for b in f.leaves(t)]
        assert sum(a != b for a, b in zip(l1, l2)) == 0


def test_thresholds_margins_match_single_device(single, data):
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    t1 = np.asarray(single.arrays.thr)
    t2 = np.asarray(f.arrays.thr)
    m1 = np.asarray(single.arrays.mgl)
    m2 = np.asarray(f.arrays.mgl)
    h1 = np.asarray(single.arrays.mgh)
    h2 = np.asarray(f.arrays.mgh)
    for l, lp in enumerate(single.plan.levels):
        ns = lp.n_segs  # padded tail holds garbage in both; compare live
        np.testing.assert_allclose(t1[:, l, :ns], t2[:, l, :ns], atol=1e-6)
        np.testing.assert_allclose(m1[:, l, :ns], m2[:, l, :ns], atol=1e-6)
        np.testing.assert_allclose(h1[:, l, :ns], h2[:, l, :ns], atol=1e-6)


def test_queries_match_single_device(single, data):
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    q = data[:9] + 0.02
    d1, i1 = map(np.asarray, single.knn(q, 5))
    d2, i2 = map(np.asarray, f.knn(q, 5))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(9):
        assert set(i1[b].tolist()) == set(i2[b].tolist())


def test_indivisible_rows_raise(data):
    with pytest.raises(ValueError):
        forest_batch_data_parallel(SEED, 6, 12, 1, 1.0, data[:1593],
                                   mesh=data_mesh(8))


def test_single_leaf_plan(data):
    f = forest_batch_data_parallel(SEED, 0, 12, 1, 1.0, data[:800],
                                   mesh=data_mesh(8))
    assert f.tree_size() == 800
    assert f.plan.n_leaves == 1


def _addressable_max_rows(arr):
    """Largest per-device shard (rows) of a sharded array."""
    return max(s.data.shape[0] for s in arr.addressable_shards)


def test_memory_complete_end_to_end(single, data):
    """Build -> pack -> serve -> recall with the
    dataset sharded throughout -- no device ever holds the full dataset
    or the full index."""
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    # the returned forest keeps x sharded: each device holds N/8 rows
    assert _addressable_max_rows(f.x) == N // 8
    assert _addressable_max_rows(f.sq_norms) == N // 8

    q = data[:9] + 0.02
    # sharded brute force / recall (no full materialization)
    d_bf, i_bf = map(np.asarray, f.brute_force_knn(q, 5))
    d_1, i_1 = map(np.asarray, single.brute_force_knn(q, 5))
    np.testing.assert_allclose(d_bf, d_1, atol=1e-5)
    rec = np.asarray(f.recall_with(q, 5, budget=8))
    rec1 = np.asarray(single.recall_with(q, 5, budget=8))
    np.testing.assert_allclose(rec, rec1, atol=1e-6)

    # leaf-sharded packing straight from the sharded rows: blocks are
    # sharded 1/S per device
    f.pack_leaves()
    rows, sq, ids = f._packed
    g_total = T * f.plan.n_leaves
    assert _addressable_max_rows(rows) == -(-g_total // 8)
    d2, i2 = map(np.asarray, f.knn(q, 5, budget=16))
    d1, i1 = map(np.asarray, single.knn(q, 5, budget=16))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(9):
        assert set(i1[b].tolist()) == set(i2[b].tolist())

    # serve-only: drop the sharded dataset, packed queries keep working
    f.drop_dataset()
    d3, i3 = map(np.asarray, f.knn(q, 5, budget=16))
    np.testing.assert_allclose(d2, d3, atol=1e-6)
    with pytest.raises(ValueError):
        f.brute_force_knn(q, 5)


def test_dp_knn_h_and_min_votes_match_single(single, data):
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    q = data[:9] + 0.02
    dh1, ih1 = map(np.asarray, single.knn_h(q, 5, budget=8))
    dh2, ih2 = map(np.asarray, f.knn_h(q, 5, budget=8))
    np.testing.assert_allclose(dh1, dh2, atol=1e-5)
    dv1, iv1 = map(np.asarray, single.knn(q, 5, budget=8, min_votes=2))
    dv2, iv2 = map(np.asarray, f.knn(q, 5, budget=8, min_votes=2))
    np.testing.assert_allclose(dv1, dv2, atol=1e-5)
    # min_votes on the packed leaf-sharded path too
    f.pack_leaves()
    dv3, iv3 = map(np.asarray, f.knn(q, 5, budget=8, min_votes=2))
    np.testing.assert_allclose(dv1, dv3, atol=1e-5)


def test_dp_int8_pack(single, data):
    import jax.numpy as jnp

    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    f.pack_leaves(dtype=jnp.int8)
    q = data[:9] + 0.02
    d1, i1 = map(np.asarray, single.knn(q, 5, budget=16))
    d2, i2 = map(np.asarray, f.knn(q, 5, budget=16))
    overlap = np.mean([
        len(set(i1[b].tolist()) & set(i2[b].tolist())) / 5 for b in range(9)
    ])
    assert overlap >= 0.9


def test_sharded_brute_force_matches_single(data):
    from rptree_tpu.parallel import brute_force_knn_sharded

    q = data[:7] + 0.01
    d2, i2 = map(np.asarray,
                 brute_force_knn_sharded(data, q, 9, mesh=data_mesh(8)))
    import rptree_tpu as rt
    f = rt.forest_batch(1, 3, 8, 1, 1.0, data)
    d1, i1 = map(np.asarray, f.brute_force_knn(q, 9))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(7):
        assert set(i1[b].tolist()) == set(i2[b].tolist())


def test_dp_rebuild_stays_sharded(data):
    """rebuild() on a DataParallelForest re-runs the SHARDED build (the
    base rebuild would silently produce a single-device forest under the
    sharded query paths) and refuses indivisible sizes."""
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    f.pack_leaves()
    f.add(data[:8] + 3.0)
    f.fold()  # slack=0: only below-max leaves have free padded slots
    assert f.n_pending + f.n_folded == 8
    f.rebuild()
    assert f.tree_size() == N + 8
    # still sharded after rebuild
    assert max(sh.data.shape[0] for sh in f.x.addressable_shards) \
        == (N + 8) // 8
    d, i = map(np.asarray, f.knn(data[:1] + 3.0, 1))
    assert i[0, 0] >= 0
    f.add(data[:3])  # (N+11) % 8 != 0
    with pytest.raises(ValueError):
        f.rebuild()


def _make_ell(n=1600, dim=96, nnz=8, seed=21):
    from rptree_tpu.ops.sparse import EllMatrix

    rng = np.random.default_rng(seed)
    cols = rng.integers(1, dim, size=(n, nnz)).astype(np.int32)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    # a few short rows exercise padding (col=0, val=0)
    vals[rng.random((n, nnz)) < 0.2] = 0.0
    cols[vals == 0.0] = 0
    return EllMatrix(dim, cols, vals)


def test_data_parallel_ell_build_matches_single_device():
    """Bag-of-words (ELL) datasets take the sharded
    build path -- projections are row-local so the sharded build's leaf
    contents equal the single-device ELL build's exactly."""
    ell = _make_ell()
    single = rt.forest_batch(SEED, 6, 12, T, 1.0, ell)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, ell,
                                   mesh=data_mesh(8))
    # per-device shard sizes: 1/8 of the rows on each chip
    assert _addressable_max_rows(f.x.cols) == 1600 // 8
    assert _addressable_max_rows(f.x.vals) == 1600 // 8
    for t in range(T):
        l1 = [set(b) for b in single.leaves(t)]
        l2 = [set(b) for b in f.leaves(t)]
        assert sum(a != b for a, b in zip(l1, l2)) == 0
    q = np.asarray(
        np.take(np.asarray(rt.ell_to_dense(ell)), np.arange(9), axis=0)
        + 0.01, np.float32)
    d1, i1 = map(np.asarray, single.knn(q, 5, budget=8))
    d2, i2 = map(np.asarray, f.knn(q, 5, budget=8))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(9):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
    # sharded ELL brute force
    from rptree_tpu.parallel import brute_force_knn_sharded

    db, ib = map(np.asarray,
                 brute_force_knn_sharded(ell, q, 5, mesh=data_mesh(8)))
    d1b, i1b = map(np.asarray, single.brute_force_knn(q, 5))
    np.testing.assert_allclose(db, d1b, atol=1e-5)


def test_data_parallel_ell_packed_serving():
    """ELL leaf-sharded packing: 1/S of the sparse blocks per chip, packed
    query parity with the single-device EllBlocks path, serve-only."""
    ell = _make_ell()
    single = rt.forest_batch(SEED, 6, 12, T, 1.0, ell).pack_leaves()
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, ell, mesh=mesh)
    f.pack_leaves()
    blocks, sq, ids = f._packed
    g_total = T * f.plan.n_leaves
    assert _addressable_max_rows(blocks.cols) == -(-g_total // 8)
    assert _addressable_max_rows(blocks.vals) == -(-g_total // 8)
    q = np.asarray(np.asarray(rt.ell_to_dense(ell))[:9] + 0.01, np.float32)
    d1, i1 = map(np.asarray, single.knn(q, 5, budget=16))
    d2, i2 = map(np.asarray, f.knn(q, 5, budget=16))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(9):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
    # knn_h on the packed sparse path
    dh1, ih1 = map(np.asarray, single.knn_h(q, 5, budget=8))
    dh2, ih2 = map(np.asarray, f.knn_h(q, 5, budget=8))
    np.testing.assert_allclose(dh1, dh2, atol=1e-5)
    # grouped rerank on the sharded sparse blocks (one (cols, vals)
    # fetch per tile) matches the per-pair sharded path
    dg, ig = map(np.asarray, f.knn_grouped(q, 5, budget=16))
    np.testing.assert_allclose(d2, dg, atol=1e-5)
    np.testing.assert_array_equal(i2, ig)
    # serve-only mode keeps working with the sharded sparse blocks
    f.drop_dataset()
    d3, i3 = map(np.asarray, f.knn(q, 5, budget=16))
    np.testing.assert_allclose(d2, d3, atol=1e-6)
    # int8 is a dense-block feature
    g = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, ell, mesh=mesh)
    import jax.numpy as jnp

    with pytest.raises(ValueError):
        g.pack_leaves(dtype=jnp.int8)


def test_dp_knn_batched_parity(single, data):
    """Sharded one-dispatch batches on the data-parallel leaf-sharded
    layout: parity with chunked knn(), padding handled, unpacked raises."""
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    with pytest.raises(ValueError, match="pack_leaves"):
        f.knn_batched(data[:4], 5)
    f.pack_leaves()
    q = data[:19] + 0.02
    d1, i1 = map(np.asarray, f.knn(q, 5, budget=16))
    d2, i2 = map(np.asarray, f.knn_batched(q, 5, budget=16, chunk=8))
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)
    d0, i0 = map(np.asarray, single.knn(q, 5, budget=16))
    # cross-path check vs the single-device index: distances carry the
    # usual pack-path GEMM reduction-order noise
    np.testing.assert_allclose(d0, d2, atol=1e-4)


def test_dp_fold_leaf_sharded(single, data):
    """fold() on the data-parallel leaf-sharded layout: slack slots in the
    psum-assembled blocks absorb online inserts; queries, knn_h, batched
    queries and the (merged) brute-force oracle all see the folded rows."""
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    f.pack_leaves(slack=8)
    rng = np.random.default_rng(42)
    new = rng.normal(size=(10, DIM)).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_folded == 10 and f.n_pending == 0
    q = new + 1e-4
    _, ids = map(np.asarray, f.knn(q, 1, budget=f.plan.n_leaves))
    assert (ids[:, 0] >= N).all()
    _, ih = map(np.asarray, f.knn_h(q, 1, budget=f.plan.n_leaves))
    assert (ih[:, 0] >= N).mean() >= 0.5  # k=1 stop rule scores ~1 bucket
    _, bf = map(np.asarray, f.brute_force_knn(q, 1))
    assert (bf[:, 0] >= N).all()
    d1, i1 = map(np.asarray, f.knn(q, 3, budget=8))
    d2, i2 = map(np.asarray, f.knn_batched(q, 3, budget=8, chunk=4))
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)
    # recall on the folded forest works (folded-aware ground truth +
    # leaf-membership candidacy; DP==single-device parity is pinned in
    # test_dp_recall_after_fold).  k=1 at full budget: each query sits on
    # its folded point, whose leaf is on the query's traversal path in
    # every tree, so candidate recall of the folded rows is exactly 1.
    r_f = np.asarray(f.recall_with(q, 1, budget=f.plan.n_leaves))
    assert r_f.shape == (10,)
    np.testing.assert_allclose(r_f, 1.0)
    # base rows still served, and rebuild still divides the mesh
    _, ib = map(np.asarray, f.knn(data[:5] + 1e-4, 1, budget=8))
    assert (ib[:, 0] == np.arange(5)).all()
    f.add(rng.normal(size=(6, DIM)).astype(np.float32))  # 1600+16 % 8 == 0
    f.rebuild()
    assert f.tree_size() == N + 16 and f.n_folded == 0


def test_dp_centered_int8(single, data):
    """Centered int8 on the data-parallel leaf-sharded layout: means are
    computed from the psum-assembled blocks and served sharded."""
    import jax.numpy as jnp

    s1 = rt.forest_batch(SEED, 6, 12, T, 1.0, data)
    s1.pack_leaves(dtype=jnp.int8, centered=True)
    q = data[:9] + 0.02
    d0, i0 = map(np.asarray, s1.knn(q, 5, budget=16))
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    f.pack_leaves(dtype=jnp.int8, centered=True)
    assert f._block_center is not None
    d1, i1 = map(np.asarray, f.knn(q, 5, budget=16))
    overlap = np.mean([
        len(set(i0[b].tolist()) & set(i1[b].tolist())) / 5
        for b in range(9)
    ])
    assert overlap >= 0.9, overlap
    db, ib = map(np.asarray, f.knn_batched(q, 5, budget=16, chunk=4))
    np.testing.assert_array_equal(i1, ib)
    dh, ih = map(np.asarray, f.knn_h(q, 5, budget=16))
    assert (ih[:, 0] >= 0).all()
    # fold into DP centered blocks (slack slots + mean.residual update)
    g = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    g.pack_leaves(dtype=jnp.int8, centered=True, slack=8)
    new_rows = data[:4] + 3.0
    g.add(new_rows)
    g.fold()
    assert g.n_folded == 4
    _, ifo = map(np.asarray, g.knn(new_rows + 1e-4, 1,
                                   budget=g.plan.n_leaves))
    assert (ifo[:, 0] >= N).all()


def test_dp_sub_block_parity(single, data):
    """Sub_block packing from the sharded
    rows; f32 sub-blocking is an exact re-blocking of the leaf blocks."""
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    f.pack_leaves(sub_block=2)
    assert f._sub_block == 2
    q = data[:9] + 0.01
    d1, i1 = map(np.asarray, single.knn(q, 10, budget=16))
    d2, i2 = map(np.asarray, f.knn(q, 10, budget=16))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(9):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
    # knn_h (bucket stop at leaf granularity) matches the single-device
    # sub-blocked knn_h (the stop rule may legitimately drop a query's
    # own bucket, so parity -- not identity -- is the contract)
    s2 = rt.forest_batch(SEED, 6, 12, T, 1.0, data)
    s2.pack_leaves(sub_block=2)
    dh, ih = map(np.asarray, f.knn_h(q, 5, budget=8))
    dh2, ih2 = map(np.asarray, s2.knn_h(q, 5, budget=8))
    np.testing.assert_allclose(dh, dh2, atol=1e-5)
    for b in range(9):
        assert set(ih[b].tolist()) == set(ih2[b].tolist())


def test_dp_ell_rebuild(single, data):
    """Rebuild() on a data-parallel ELL dataset stays
    sparse and sharded; pending + folded + tombstoned rows all resolve."""
    ell = _make_ell()
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, ell,
                                   mesh=data_mesh(8))
    n0 = f.n_points
    # new sparse rows (as dense chunks), delete half of them while still
    # pending, then rebuild (the result size must divide the shards)
    de = f.dim
    new = np.zeros((16, de), np.float32)
    for j in range(16):
        new[j, (j % de, (j * 3 + 1) % de)] = (1.0 + j, -0.5)
    f.add(new)
    f.remove(np.arange(n0, n0 + 8))
    f.rebuild()
    assert f.n_points == n0 + 16 - 8
    from rptree_tpu.ops.sparse import EllMatrix
    assert isinstance(f.x, EllMatrix)
    assert f.n_pending == 0 and f.n_deleted == 0
    # the rebuilt index finds the surviving new rows exactly
    _, ids = map(np.asarray, f.knn(new[8:10], 1, budget=16))
    got = np.asarray(f.points())[ids[:, 0]]
    np.testing.assert_allclose(got, new[8:10], atol=1e-6)
    # a dense update row with more nonzeros than K must raise
    f2 = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, _make_ell(),
                                    mesh=data_mesh(8))
    wide = np.ones((8, f2.dim), np.float32)
    f2.add(wide)
    with pytest.raises(ValueError):
        f2.rebuild()


def test_dp_recall_after_fold(single, data):
    """Recall_with after fold()."""
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                   mesh=data_mesh(8))
    f.pack_leaves(slack=8)
    q = data[:9] + 0.01
    r0 = np.asarray(f.recall_with(q, 10, budget=16))
    new = data[:6] * 0.5 + 2.0
    f.add(new)
    f.fold()
    assert f.n_folded == 6
    r1 = np.asarray(f.recall_with(q, 10, budget=16))
    assert r1.shape == (9,)
    rq = np.asarray(f.recall_with(new[:2], 1, budget=16))
    assert (rq > 0.99).all()
    assert abs(float(r0.mean()) - float(r1.mean())) < 0.2


def test_dp_query_axis_composition(single, data):
    """(data x query) 2-D mesh -- giant batches split
    across the query axis instead of replicating B x D onto every data
    shard; results match the 1-D data mesh and the single device."""
    mesh2 = data_mesh(4, n_query=2)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh2)
    f.pack_leaves()
    # 22 queries (odd, forces padding): 11 rows per query shard, not 22
    q = np.concatenate([data[:22]]).astype(np.float32) + 0.01
    qb, b = f._q_repl(q)
    assert b == 22 and qb.shape[0] == 22
    assert _addressable_max_rows(qb) == 11  # B/s_q per device, not B
    d1, i1 = map(np.asarray, single.knn(q, 10, budget=16))
    for name, fn, kw in (("knn", f.knn, {}),
                         ("knn_batched", f.knn_batched, {"chunk": 4}),
                         ("knn_h", f.knn_h, {})):
        d2, i2 = map(np.asarray, fn(q, 10, budget=16, **kw))
        assert d2.shape == (22, 10)
        if name != "knn_h":  # knn_h's bucket stop legitimately differs
            np.testing.assert_allclose(d1, d2, atol=1e-4)
            for bq in range(22):
                assert set(i1[bq].tolist()) == set(i2[bq].tolist())
    # recall + brute force compose with the query axis too
    r = np.asarray(f.recall_with(q, 5, budget=16))
    assert r.shape == (22,)
    db, ib = map(np.asarray, f.brute_force_knn(q, 5))
    assert (ib[:, 0] == np.arange(22)).all()
    # unpacked path as well
    f2 = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh2)
    d3, i3 = map(np.asarray, f2.knn(q, 10, budget=16))
    np.testing.assert_allclose(d1, d3, atol=1e-4)


def test_tune_on_data_parallel_forest(single, data):
    """tune() on a DataParallelForest: the sweep's knn/brute-force calls
    run the sharded pipelines (including the scan candidate's sharded
    brute force)."""
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    rng = np.random.default_rng(5)
    q = data[:9] + 0.01 * rng.normal(size=(9, DIM)).astype(np.float32)
    best = rt.tune(f, q, k=5, target_recall=0.3, budgets=(1, 2),
                   probes_per_tree=(1.0,), measure=False)
    assert best["recall"] > 0 and "frontier" in best


def test_tune_build_on_sharded_dataset(single, data):
    """tune_build accepts a sharded forest handle (or sharded array):
    the subsample is gathered ON DEVICE (the host never buffers more
    than ``sample`` rows), and the derived knobs equal the host-rows
    sweep on the same subsample."""
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data, mesh=mesh)
    rng = np.random.default_rng(6)
    q = data[:32] + 0.01 * rng.normal(size=(32, DIM)).astype(np.float32)
    kw = dict(k=5, target_recall=0.3, n_trees_grid=(T,),
              min_leaf_grid=(16,), sample=512, seed=3,
              budgets=(1,), probes_per_tree=(1.0,), measure=False)
    best_sharded = rt.tune_build(f, q, **kw)
    # full_n defaults to the sharded corpus size
    assert best_sharded["min_leaf_full"] >= best_sharded["min_leaf"]
    # equivalence anchor: same subsample drawn host-side
    idx = np.sort(np.random.default_rng(3).choice(N, size=512,
                                                  replace=False))
    best_host = rt.tune_build(data[idx], q, full_n=N, **{
        k_: v for k_, v in kw.items() if k_ != "sample"}, sample=512)
    assert (best_sharded["min_leaf"], best_sharded["budget"]) == (
        best_host["min_leaf"], best_host["budget"])
    assert best_sharded["min_leaf_full"] == best_host["min_leaf_full"]


def test_dp_knn_grouped_matches_knn(single, data):
    """knn_grouped on the data-parallel leaf-sharded blocks (incl. the
    (data x query) 2-D mesh) matches the per-pair sharded path."""
    for mesh in (data_mesh(8), data_mesh(4, n_query=2)):
        f = forest_batch_data_parallel(SEED, 6, 12, T, 1.0, data,
                                       mesh=mesh)
        f.pack_leaves()
        q = data[:8] + 0.01
        d0, i0 = map(np.asarray, f.knn(q, 5, budget=8))
        dg, ig = map(np.asarray, f.knn_grouped(q, 5, budget=8))
        # near-zero self-distances amplify summation-order noise through
        # the sqrt of |x|^2 - 2 x.q + |q|^2 (cancellation of ~|x|^2-sized
        # terms: delta_d ~ eps*|x|^2 / d), so the tolerance is looser than
        # the ids contract, which stays exact
        np.testing.assert_allclose(d0, dg, atol=2e-4)
        np.testing.assert_array_equal(i0, ig)
