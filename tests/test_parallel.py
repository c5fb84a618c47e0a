"""Sharded build/query vs single-device results (SURVEY.md section 4:
"single-device vs sharded bit-exactness" is a sharding-specific test the
reference cannot have).  Runs on the 8-virtual-device CPU mesh from
conftest.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rptree_tpu as rt
from rptree_tpu.parallel import (
    DistributedForest,
    distribute,
    forest_batch_distributed,
    forest_mesh,
    merge_top_k,
)

SEED = 7071
N, DIM, T = 1500, 32, 8
MAXD, MINL, PNZ = 6, 16, 1.0


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(99)
    return rng.normal(size=(N, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(100)
    return rng.normal(size=(13, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def single(data):
    return rt.forest_batch(SEED, MAXD, MINL, T, PNZ, data)


@pytest.fixture(scope="module")
def dist_trees(data):
    """All 8 devices on the tree axis."""
    return forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    )


@pytest.fixture(scope="module")
def dist_2d(data):
    """4 tree shards x 2 query shards."""
    return forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(4, 2)
    )


def test_mesh_shapes():
    m = forest_mesh(8, 1)
    assert m.shape == {"tree": 8, "query": 1}
    with pytest.raises(ValueError):
        forest_mesh(3, 2)


def test_sharded_build_matches_single_device(single, dist_trees):
    """The tree-parallel build must produce the same trees as the
    single-device vmap build (same seed => same projections).  Thresholds
    may differ by float GEMM reduction-order noise (the sharded build
    projects each shard's trees in a separate matmul); the permutation --
    i.e. which points land in which leaves -- must match exactly."""
    a, b = single.arrays, dist_trees.arrays
    np.testing.assert_array_equal(np.asarray(a.perm), np.asarray(b.perm))
    for l in range(single.plan.n_levels):
        np.testing.assert_allclose(
            np.asarray(a.thr[l]), np.asarray(b.thr[l]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(a.mgl[l]), np.asarray(b.mgl[l]), atol=1e-5
        )


@pytest.mark.parametrize("fixture", ["dist_trees", "dist_2d"])
def test_sharded_knn_matches_single_device(single, queries, fixture, request):
    dist = request.getfixturevalue(fixture)
    k = 10
    d1, i1 = single.knn(queries, k, budget=16)
    d2, i2 = dist.knn(queries, k, budget=16)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)
    # ids may permute within distance ties; compare id sets where distances
    # are strictly distinct, sets otherwise
    for b in range(queries.shape[0]):
        assert set(np.asarray(i1)[b].tolist()) == set(np.asarray(i2)[b].tolist())


def test_sharded_knn_h_superset_quality(single, queries, dist_trees):
    """knn_h's sharded stop rule selects a superset of buckets; the top-1
    must still be at least as close as the single-device top-1."""
    d1, _ = single.knn_h(queries, 5, budget=16)
    d2, _ = dist_trees.knn_h(queries, 5, budget=16)
    assert np.all(np.asarray(d2)[:, 0] <= np.asarray(d1)[:, 0] + 1e-5)


def test_sharded_recall_matches_single_device(single, queries, dist_trees):
    r1 = single.recall_with(queries, 10, budget=16)
    r2 = dist_trees.recall_with(queries, 10, budget=16)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), atol=1e-6)


def test_distribute_existing_forest(single, queries):
    dist = distribute(single, forest_mesh(8, 1))
    d1, i1 = single.knn(queries, 7)
    d2, i2 = dist.knn(queries, 7)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)


def test_query_padding(dist_2d, data):
    """Query batches not divisible by the query-shard count are padded and
    sliced back."""
    q = data[:3]  # 3 queries over 2 query shards
    d, i = dist_2d.knn(q, 5)
    assert d.shape == (3, 5) and i.shape == (3, 5)


def test_merge_top_k_dedups_across_shards():
    d = jnp.asarray([[1.0, 3.0, 1.0, 2.0]])
    i = jnp.asarray([[4, 9, 4, 7]], dtype=jnp.int32)
    md, mi = merge_top_k(d, i, 3, dedup=True)
    assert mi[0].tolist() == [4, 7, 9]
    np.testing.assert_allclose(np.asarray(md[0]), [1.0, 2.0, 3.0])


def test_indivisible_tree_count_raises(data):
    with pytest.raises(ValueError):
        forest_batch_distributed(SEED, MAXD, MINL, 6, PNZ, data,
                                 mesh=forest_mesh(8, 1))


def test_sharded_packed_knn_matches_single_device(single, queries, data):
    """Leaf-blocked rerank sharded over the tree axis must agree with the
    single-device unpacked path."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves()
    k = 10
    d1, i1 = single.knn(queries, k, budget=16)
    d2, i2 = dist.knn(queries, k, budget=16)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)
    for b in range(queries.shape[0]):
        assert set(np.asarray(i1)[b].tolist()) == set(np.asarray(i2)[b].tolist())


def test_leaf_sharded_packed_knn_matches_single_device(single, queries, data):
    """Leaf-sharded blocks (1/S of the index per chip): with the exact
    per-shard probe quota, results must match the single-device path."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves(shard_by="leaf")
    k = 10
    d1, i1 = single.knn(queries, k, budget=16)
    d2, i2 = dist.knn(queries, k, budget=16)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)
    for b in range(queries.shape[0]):
        assert set(np.asarray(i1)[b].tolist()) == set(np.asarray(i2)[b].tolist())
    # quota mode: per-shard cap trades exactness for S-fold less scoring;
    # top-1 must still be found on this easy workload
    d3, i3 = dist.knn(queries, k, budget=16,
                      probes_per_shard=max(2, (T * 16) // 8))
    assert np.all(np.asarray(i3)[:, 0] == np.asarray(i1)[:, 0])


def test_sharded_int8_packed(single, queries, data):
    import jax.numpy as jnp

    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves(dtype=jnp.int8)
    d1, i1 = single.knn(queries, 8, budget=16)
    d2, i2 = dist.knn(queries, 8, budget=16)
    overlap = np.mean([
        len(set(np.asarray(i1)[b].tolist()) & set(np.asarray(i2)[b].tolist())) / 8
        for b in range(queries.shape[0])
    ])
    assert overlap >= 0.9


def test_distributed_serve_only(data, queries):
    """drop_dataset on a tree-sharded packed forest: packed knn AND knn_h
    keep working (knn_h scores the kept buckets on the blocks); paths
    needing raw rows raise."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves()
    d1, i1 = dist.knn(queries, 5)
    dist.drop_dataset()
    d2, i2 = dist.knn(queries, 5)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)
    dh, ih = dist.knn_h(queries, 5)  # packed/serve-only knn_h
    assert dh.shape == (queries.shape[0], 5)
    assert (np.asarray(ih)[:, 0] >= 0).all()
    with pytest.raises(ValueError):
        dist.recall_with(queries, 5)


def test_min_votes_matches_single_device(single, queries, data):
    """The voting filter must behave identically on every distributed
    path: unpacked, tree-sharded packed, and leaf-sharded packed."""
    k = 8
    d1, i1 = single.knn(queries, k, budget=16, min_votes=2)
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    )
    for prep in (lambda f: f,
                 lambda f: f.pack_leaves(),
                 lambda f: f.pack_leaves(shard_by="leaf")):
        f = prep(forest_batch_distributed(
            SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)))
        d2, i2 = f.knn(queries, k, budget=16, min_votes=2)
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2),
                                   atol=1e-5)
        for b in range(queries.shape[0]):
            assert (set(np.asarray(i1)[b].tolist())
                    == set(np.asarray(i2)[b].tolist())), (prep, b)


def test_leaf_sharded_knn_h_matches_single_packed(single, queries, data):
    """Leaf-sharded knn_h applies the identical bucket-stop mask on the
    replicated structure arrays, so it must match the single-device
    packed knn_h exactly."""
    sp = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, data).pack_leaves()
    d1, i1 = sp.knn_h(queries, 5, budget=16)
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves(shard_by="leaf")
    d2, i2 = dist.knn_h(queries, 5, budget=16)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)


def test_int8_leaf_sharded_packed(single, queries, data):
    """int8 blocks + leaf sharding: per-block scales follow the
    round-robin layout; neighbour quality must hold."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves(dtype=jnp.int8, shard_by="leaf")
    d1, i1 = single.knn(queries, 8, budget=16)
    d2, i2 = dist.knn(queries, 8, budget=16)
    overlap = np.mean([
        len(set(np.asarray(i1)[b].tolist())
            & set(np.asarray(i2)[b].tolist())) / 8
        for b in range(queries.shape[0])
    ])
    assert overlap >= 0.9


def test_sparse_packed_tree_sharded(queries):
    """ELL datasets pack into tree-sharded EllBlocks; distributed packed
    queries must match the single-device packed sparse path."""
    from rptree_tpu.ops.sparse import EllMatrix

    rng = np.random.default_rng(61)
    cols = np.stack([np.sort(rng.choice(DIM, size=5, replace=False))
                     for _ in range(800)]).astype(np.int32)
    vals = rng.normal(size=(800, 5)).astype(np.float32)
    m = EllMatrix(DIM, jnp.asarray(cols), jnp.asarray(vals))
    single = rt.forest_batch(3, 5, 16, T, 1.0, m).pack_leaves()
    d1, i1 = map(np.asarray, single.knn(queries, 5, budget=8))
    dist = forest_batch_distributed(
        3, 5, 16, T, 1.0, m, mesh=forest_mesh(8, 1)
    ).pack_leaves()
    assert dist._packed is not None
    d2, i2 = map(np.asarray, dist.knn(queries, 5, budget=8))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(queries.shape[0]):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
    # serve-only works for sparse too
    dist.drop_dataset()
    d3, i3 = map(np.asarray, dist.knn(queries, 5, budget=8))
    np.testing.assert_allclose(d2, d3, atol=1e-6)


def test_sparse_packed_leaf_sharded(queries):
    """ELL blocks round-robin by LEAF across the mesh (1/S of the sparse
    index per chip -- the layout that matters at bag-of-words scale):
    per-pair, grouped, batched, and knn_h all match the single-device
    packed sparse path; fold() writes through the round-robin map."""
    from rptree_tpu.ops.sparse import EllMatrix

    rng = np.random.default_rng(61)
    cols = np.stack([np.sort(rng.choice(DIM, size=5, replace=False))
                     for _ in range(800)]).astype(np.int32)
    vals = rng.normal(size=(800, 5)).astype(np.float32)
    m = EllMatrix(DIM, jnp.asarray(cols), jnp.asarray(vals))
    single = rt.forest_batch(3, 5, 16, T, 1.0, m).pack_leaves()
    d1, i1 = map(np.asarray, single.knn(queries, 5, budget=8))
    dh1, ih1 = map(np.asarray, single.knn_h(queries, 5, budget=8))
    dist = forest_batch_distributed(
        3, 5, 16, T, 1.0, m, mesh=forest_mesh(4, 2)
    ).pack_leaves(shard_by="leaf", slack=8)
    assert dist._packed_mode == "leaf"
    d2, i2 = map(np.asarray, dist.knn(queries, 5, budget=8))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    for b in range(queries.shape[0]):
        assert set(i1[b].tolist()) == set(i2[b].tolist())
    dg, ig = map(np.asarray, dist.knn_grouped(queries, 5, budget=8))
    np.testing.assert_allclose(d1, dg, atol=1e-4)
    db, ib = map(np.asarray, dist.knn_batched(queries[:12], 5, budget=8,
                                              chunk=3))
    np.testing.assert_allclose(d1[:12], db, atol=1e-5)
    dh2, ih2 = map(np.asarray, dist.knn_h(queries, 5, budget=8))
    np.testing.assert_allclose(dh1, dh2, atol=1e-5)
    # fold through the round-robin storage map (sparse new points)
    new = np.zeros((2, DIM), np.float32)
    new[0, [1, 5, 9]] = (0.5, -0.25, 1.0)
    new[1, [2, 3]] = (1.5, 0.75)
    dist.add(new)
    dist.fold()
    assert dist.n_folded == 2 and dist.n_pending == 0
    _, ids = map(np.asarray, dist.knn(new, 1, budget=8))
    assert ids[0, 0] == 800 and ids[1, 0] == 801
    # grouped reads the dynamic storage-row occupancies after fold
    _, idg = map(np.asarray, dist.knn_grouped(new, 1, budget=8))
    assert idg[0, 0] == 800 and idg[1, 0] == 801


def test_sharded_fold_slack0_and_rebuild_repacks(data, queries):
    """fold() on a slack=0 sharded packing absorbs nothing (every block
    is full): points stay in the exact pending merge, and rebuild() on a
    packed sharded forest re-packs and STAYS sharded."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves()
    new = data[:4] + 3.0
    dist.add(new)
    dist.fold()
    # slack=0: only leaves below the padded max size have free slots
    assert dist.n_pending + dist.n_folded == 4
    # new points are served either from the blocks or the pending merge
    _, ids = map(np.asarray, dist.knn(new[:1] + 1e-4, 1))
    assert ids[0, 0] >= N
    dist.rebuild()  # must re-pack (slack=0) without TypeError
    assert dist.tree_size() == N + 4
    assert dist._packed is not None and dist._packed_mode == "tree"


def test_sharded_knn_h_respects_remove_and_add(data, queries):
    """Review finding r2: knn_h must apply tombstones and the pending
    merge on the sharded paths, like knn does."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    )
    q = data[:2] + 1e-4
    _, i0 = map(np.asarray, dist.knn_h(q, 1, budget=8))
    assert (i0[:, 0] == np.arange(2)).all()
    dist.remove([0, 1])
    _, i1 = map(np.asarray, dist.knn_h(q, 2, budget=8))
    assert not set(i1.reshape(-1).tolist()) & {0, 1}
    dist.add(data[:2] + 5.0)
    _, i2 = map(np.asarray, dist.knn_h(data[:1] + 5.0, 1, budget=8))
    assert i2[0, 0] >= N


def test_sharded_knn_batched_parity(data, queries):
    """Knn_batched on sharded forests runs the lax.map
    chunking INSIDE the sharded pipeline; results match chunked knn()
    exactly on both leaf-sharded and tree-sharded packed layouts."""
    q32 = np.concatenate([queries] * 3, axis=0)[:32]  # 32 queries
    # leaf-sharded blocks on a 4x2 (tree x query) mesh
    f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(4, 2))
    f.pack_leaves(shard_by="leaf")
    d1, i1 = map(np.asarray, f.knn(q32, 5, budget=8))
    d2, i2 = map(np.asarray, f.knn_batched(q32, 5, budget=8, chunk=8))
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    np.testing.assert_array_equal(i1, i2)
    # odd batch (padding) + chunk larger than the batch
    d3, i3 = map(np.asarray, f.knn_batched(q32[:13], 5, budget=8, chunk=64))
    np.testing.assert_allclose(d1[:13], d3, atol=1e-6)
    # tree-sharded packed blocks
    g = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(8, 1))
    g.pack_leaves(shard_by="tree")
    d4, i4 = map(np.asarray, g.knn(q32, 5, budget=8))
    d5, i5 = map(np.asarray, g.knn_batched(q32, 5, budget=8, chunk=8))
    np.testing.assert_allclose(d4, d5, atol=1e-6)
    np.testing.assert_array_equal(i4, i5)
    # unpacked forests cannot silently fall back to the single-device path
    h = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(8, 1))
    with pytest.raises(ValueError, match="pack_leaves"):
        h.knn_batched(q32, 5)


def test_sharded_fold_tree_and_leaf_modes(data):
    """Fold() on sharded packed layouts.  New points
    descend the stored thresholds, scatter into each layout's storage
    rows, and are served with dynamic per-block occupancy on both the
    tree-sharded and the round-robin leaf-sharded paths."""
    rng = np.random.default_rng(41)
    new = rng.normal(size=(12, DIM)).astype(np.float32)
    for shard_by, mesh in (("tree", forest_mesh(8, 1)),
                           ("leaf", forest_mesh(4, 2))):
        f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                     mesh=mesh)
        f.pack_leaves(shard_by=shard_by, slack=8)
        f.add(new)
        f.fold()
        assert f.n_folded == 12 and f.n_pending == 0, shard_by
        q = new + 1e-4
        _, ids = map(np.asarray, f.knn(q, 1, budget=f.plan.n_leaves))
        assert (ids[:, 0] >= N).all(), shard_by
        # knn_h's bucket stop reads the dynamic occupancy; with k=1 the
        # reference stop rule scores ~one bucket, so finding the folded
        # point is only guaranteed when its bucket has the best margin
        _, ih = map(np.asarray, f.knn_h(q, 1, budget=f.plan.n_leaves))
        assert (ih[:, 0] >= N).mean() >= 0.5, shard_by
        # base points still served
        _, ib = map(np.asarray, f.knn(data[:5] + 1e-4, 1, budget=8))
        assert (ib[:, 0] == np.arange(5)).all(), shard_by
        # the ground-truth oracle covers the folded rows
        _, bf = map(np.asarray, f.brute_force_knn(q, 1))
        assert (bf[:, 0] >= N).all(), shard_by
        # one-dispatch batches agree after fold
        d1, i1 = map(np.asarray, f.knn(q, 3, budget=8))
        d2, i2 = map(np.asarray, f.knn_batched(q, 3, budget=8, chunk=4))
        np.testing.assert_allclose(d1, d2, atol=1e-6)
        np.testing.assert_array_equal(i1, i2)
        # rebuild folds for real and STAYS sharded
        f.rebuild()
        assert f.n_folded == 0 and f.tree_size() == N + 12
        assert isinstance(f, DistributedForest)
        _, ir = map(np.asarray, f.knn(q, 1, budget=8))
        assert (ir >= 0).all()


def test_tune_on_tree_sharded_forest(data):
    """tune() drives any forest through its public knn/brute_force
    surface; on a tree-sharded DistributedForest every swept config (and
    the scan candidate) runs the sharded pipelines.  (A second tune test
    below covers the 2-D mesh + static-cost ranking.)"""
    f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(8, 1)).pack_leaves()
    q = data[:16] + 0.01
    best = rt.tune(f, q, k=5, target_recall=0.5, budgets=(2, 4),
                   probes_per_tree=(1.0,), reps=1)
    assert best["met"] and best["qps"] > 0
    assert len(best["frontier"]) == 3  # 2 tree configs + the scan


def test_sharded_centered_int8(data, queries):
    """Centered (residual) int8 blocks on BOTH sharded layouts: the mean
    operands thread through the sharded scorers, matching the
    single-device centered path."""
    import jax.numpy as jnp

    single = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, data)
    single.pack_leaves(dtype=jnp.int8, centered=True)
    d0, i0 = map(np.asarray, single.knn(queries, 8, budget=16))
    for shard_by, mesh in (("tree", forest_mesh(8, 1)),
                           ("leaf", forest_mesh(4, 2))):
        f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                     mesh=mesh)
        f.pack_leaves(dtype=jnp.int8, centered=True, shard_by=shard_by)
        d1, i1 = map(np.asarray, f.knn(queries, 8, budget=16))
        overlap = np.mean([
            len(set(i0[b].tolist()) & set(i1[b].tolist())) / 8
            for b in range(queries.shape[0])
        ])
        assert overlap >= 0.9, (shard_by, overlap)
        # the chunked (knn_batched) and bucket-stop (knn_h) paths thread
        # the mean operands too
        db, ib = map(np.asarray, f.knn_batched(queries, 8, budget=16,
                                               chunk=4))
        np.testing.assert_array_equal(i1, ib[:queries.shape[0]])
        dh, ih = map(np.asarray, f.knn_h(queries, 8, budget=16))
        assert (ih[:, 0] >= 0).all()
    # fold into sharded centered blocks updates the mean.residual slots
    g = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(8, 1))
    g.pack_leaves(dtype=jnp.int8, centered=True, slack=8)
    new = data[:4] + 3.0
    g.add(new)
    g.fold()
    assert g.n_folded == 4
    _, ifo = map(np.asarray, g.knn(new + 1e-4, 1, budget=g.plan.n_leaves))
    assert (ifo[:, 0] >= N).all()


def test_sharded_sub_block_tree_and_leaf(data, queries):
    """Sub_block on the tree- and leaf-sharded
    packers.  f32 sub-blocked packs are an exact re-blocking, so both
    sharded layouts must match the single-device whole-leaf path."""
    base = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, data)
    base.pack_leaves()
    d0, i0 = map(np.asarray, base.knn(queries, 10, budget=16))
    for mode in ("tree", "leaf"):
        dist = forest_batch_distributed(
            SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
        ).pack_leaves(shard_by=mode, sub_block=2)
        assert dist._sub_block == 2
        d1, i1 = map(np.asarray, dist.knn(queries, 10, budget=16))
        np.testing.assert_allclose(d0, d1, atol=1e-5)
        for b in range(queries.shape[0]):
            assert set(i0[b].tolist()) == set(i1[b].tolist()), (mode, b)
        # knn_h (bucket stop at leaf granularity) must run too
        dh, ih = map(np.asarray, dist.knn_h(queries, 5, budget=8))
        assert (ih[:, 0] >= 0).all()
        # centered int8 at sub granularity composes on sharded layouts
        dist_q = forest_batch_distributed(
            SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
        ).pack_leaves(shard_by=mode, dtype=jnp.int8, centered=True,
                      sub_block=2)
        dq, iq = map(np.asarray, dist_q.knn(queries, 10, budget=16))
        overlap = np.mean([
            len(set(i0[b].tolist()) & set(iq[b].tolist())) / 10
            for b in range(queries.shape[0])
        ])
        assert overlap >= 0.85, (mode, overlap)


def test_sharded_recall_after_fold(data, queries):
    """Recall_with on a folded sharded forest (the
    folded-aware ground truth + tree-sharded candidate matching)."""
    dist = forest_batch_distributed(
        SEED, MAXD, MINL, T, PNZ, data, mesh=forest_mesh(8, 1)
    ).pack_leaves(slack=8)
    r0 = np.asarray(dist.recall_with(queries, 10, budget=16))
    new = data[:6] * 0.5 + 2.0
    dist.add(new)
    dist.fold()
    assert dist.n_folded == 6
    r1 = np.asarray(dist.recall_with(queries, 10, budget=16))
    assert r1.shape == (queries.shape[0],)
    # querying AT a folded point: it is its own nearest neighbour and its
    # leaf is the traversal's first bucket, so recall includes it
    rq = np.asarray(dist.recall_with(new[:2], 1, budget=16))
    assert (rq > 0.99).all()
    assert abs(float(r0.mean()) - float(r1.mean())) < 0.2


def test_sharded_ell_fold(queries):
    """Fold() into sharded (tree-mode) ELL blocks."""
    from rptree_tpu.ops.sparse import EllMatrix

    rng = np.random.default_rng(61)
    cols = np.stack([np.sort(rng.choice(DIM, size=5, replace=False))
                     for _ in range(800)]).astype(np.int32)
    vals = rng.normal(size=(800, 5)).astype(np.float32)
    m = EllMatrix(DIM, jnp.asarray(cols), jnp.asarray(vals))
    dist = forest_batch_distributed(
        3, 5, 16, T, 1.0, m, mesh=forest_mesh(8, 1)
    ).pack_leaves(slack=8)
    # a sparse new point (nnz <= K) folds into the sharded blocks
    new = np.zeros((2, DIM), np.float32)
    new[0, [1, 5, 9]] = (0.5, -0.25, 1.0)
    new[1, [2, 3]] = (1.5, 0.75)
    dist.add(new)
    dist.fold()
    assert dist.n_folded == 2 and dist.n_pending == 0
    _, ids = map(np.asarray, dist.knn(new, 1, budget=8))
    assert ids[0, 0] == 800 and ids[1, 0] == 801
    # knn_h reads the dynamic occupancies too
    _, ih = map(np.asarray, dist.knn_h(new[:1], 1, budget=8))
    assert ih[0, 0] == 800


def test_tune_on_sharded_forest(data, queries):
    """tune() runs unchanged on a DistributedForest (its knn /
    brute_force_knn / knn_batched methods are the sweep's only surface)
    and returns the same knobs as on the equivalent single-device
    forest when ranked by the static cost proxy."""
    f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(4, 2))
    f.pack_leaves()
    best = rt.tune(f, queries, k=5, target_recall=0.3,
                   budgets=(1, 2), probes_per_tree=(1.0, 2.0),
                   measure=False)
    assert best["met"] and not best.get("scan")
    f0 = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, data).pack_leaves()
    best0 = rt.tune(f0, queries, k=5, target_recall=0.3,
                    budgets=(1, 2), probes_per_tree=(1.0, 2.0),
                    measure=False)
    assert (best["budget"], best["probes"]) == (best0["budget"],
                                                best0["probes"])
    # measured mode exercises the sharded knn_batched timing path
    best_m = rt.tune(f, queries, k=5, target_recall=0.3,
                     budgets=(1,), probes_per_tree=(1.0,),
                     measure=True, reps=1, time_rows=64)
    assert best_m["frontier"][0].get("qps", 0) > 0


def test_sharded_knn_grouped_2d_mesh(data, queries):
    """Grouped rerank on the (tree x query) 2-D mesh: query batches split
    over the query axis while each tree shard tiles its owned probes --
    parity with the 1-D tree mesh and the single-device forest."""
    f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(4, 2))
    f.pack_leaves(shard_by="leaf")
    single = rt.forest_batch(SEED, MAXD, MINL, T, PNZ, data)
    single.pack_leaves()
    d0, i0 = map(np.asarray, single.knn(queries, 5, budget=4))
    dg, ig = map(np.asarray, f.knn_grouped(queries, 5, budget=4))
    np.testing.assert_allclose(d0, dg, atol=1e-5)
    np.testing.assert_array_equal(i0, ig)
    # steady-state serving mode: the cached per-shard capacity is reused
    # without the per-batch capacity fetch, results unchanged
    dc, ic = map(np.asarray, f.knn_grouped(queries, 5, budget=4,
                                           check=False))
    np.testing.assert_allclose(d0, dc, atol=1e-5)
    np.testing.assert_array_equal(i0, ic)
    # chunked (one-dispatch batched) form on the 2-D mesh
    db, ib = map(np.asarray, f.knn_grouped(queries[:12], 5, budget=4,
                                           chunk=3))
    np.testing.assert_allclose(d0[:12], db, atol=1e-5)
    np.testing.assert_array_equal(i0[:12], ib)


def test_sharded_knn_grouped_matches_knn(data, queries):
    """Leaf-sharded query-grouped rerank: same results as the sharded
    per-pair path and as the single-device forest, including after fold
    (dynamic occupancy) and with an undersized capacity retry."""
    f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(8))
    f.pack_leaves(shard_by="leaf", slack=4)
    d0, i0 = map(np.asarray, f.knn(queries, 5, budget=4))
    dg, ig = map(np.asarray, f.knn_grouped(queries, 5, budget=4))
    np.testing.assert_allclose(d0, dg, atol=1e-5)
    np.testing.assert_array_equal(i0, ig)
    # batched (chunked) grouped form
    db, ib = map(np.asarray, f.knn_grouped(queries[:12], 5, budget=4,
                                           chunk=4))
    np.testing.assert_allclose(d0[:12], db, atol=1e-5)
    # capacity retry: tiny tile_chunk forces a low first guess
    d1, i1 = map(np.asarray, f.knn_grouped(queries, 5, budget=4,
                                           tile_chunk=8))
    np.testing.assert_allclose(d0, d1, atol=1e-5)
    # fold into slack slots: grouped reads the dynamic occupancy
    rng = np.random.default_rng(4)
    new = rng.normal(size=(6, DIM)).astype(np.float32)
    f.add(new)
    f.fold()
    assert f.n_folded > 0
    d2, i2 = map(np.asarray, f.knn(new + 1e-4, 1, budget=4))
    d3, i3 = map(np.asarray, f.knn_grouped(new + 1e-4, 1, budget=4))
    np.testing.assert_array_equal(i2, i3)


def test_sharded_knn_grouped_selection_kernel_gate(data, queries):
    """selection="kernel" on the sharded grouped path: the fused top-k
    tail runs on the GPU only, so the CPU test mesh raises the gate
    error; vote counting (min_votes > 1) falls back to the sort tail and
    serves (parity of the kernel tail itself is pinned in
    tests/test_topk_kernel.py and checked on the card by chip_smoke.py)."""
    f = forest_batch_distributed(SEED, MAXD, MINL, T, PNZ, data,
                                 mesh=forest_mesh(8))
    f.pack_leaves(shard_by="leaf")
    with pytest.raises(ValueError, match="GPU backend"):
        f.knn_grouped(queries, 5, budget=4, selection="kernel")
    d0, i0 = map(np.asarray, f.knn_grouped(queries, 5, budget=4,
                                           min_votes=2))
    d1, i1 = map(np.asarray, f.knn_grouped(queries, 5, budget=4,
                                           min_votes=2,
                                           selection="kernel"))
    np.testing.assert_allclose(d0, d1, atol=1e-6)
    np.testing.assert_array_equal(i0, i1)
