"""Streaming construction tests, mirroring the reference's conduit block
(RPTreeSpec.hs:87-106): completeness + knn closeness, plus the
batch==streaming equivalence the reference's paired describe-blocks imply."""

import numpy as np
import pytest

import rptree_tpu as rp
from rptree_tpu.utils import gen as rgen

SEED = 4242


def test_streaming_forest_completeness_and_knn():
    n, ntrees, min_leaf, dim = 2000, 6, 20, 2
    cfg = rp.rp_tree_cfg(min_leaf, n, dim)
    src = rp.data_source(SEED, n, cfg.chunk_size, rgen.circle2d2)
    f = rp.forest(SEED, cfg.max_depth, min_leaf, ntrees, cfg.chunk_size, 1.0,
                  dim, src)
    assert f.tree_size() == n
    for t in range(ntrees):
        assert sorted(np.asarray(f.arrays.perm[t]).tolist()) == list(range(n))
    d, i = f.knn(np.zeros(2, np.float32), 5)
    assert np.asarray(d)[0].max() < 1.0
    d, i = f.knn_h(np.zeros(2, np.float32), 5)
    assert np.asarray(d)[0].max() < 1.0


def test_streaming_equals_batch_on_same_data():
    """With the exact-rebuild streaming design, end-of-stream result is
    bit-identical to the batch build over the concatenated chunks."""
    n, dim = 600, 4
    x = np.asarray(rgen.data_batch(9, n, lambda k, m: rgen.dense(k, m, dim)),
                   np.float32)
    fb = rp.forest_batch(9, 5, 10, 3, 1.0, x)
    builder = rp.ForestBuilder(9, 5, 10, 3, 1.0, dim)
    for s in range(0, n, 100):
        builder.insert_chunk(x[s : s + 100])
    fs = builder.build()
    np.testing.assert_array_equal(np.asarray(fb.arrays.perm),
                                  np.asarray(fs.arrays.perm))
    for l in range(fb.plan.n_levels):
        np.testing.assert_allclose(np.asarray(fb.arrays.thr[l]),
                                   np.asarray(fs.arrays.thr[l]))


def test_single_tree_stream():
    src = rp.data_source(1, 500, 100, rgen.circle2d2)
    f = rp.tree(1, 5, 10, 100, 1.0, 2, src)
    assert f.n_trees == 1
    assert f.tree_size() == 500


def test_builder_payloads_and_validation():
    b = rp.ForestBuilder(0, 4, 5, 2, 1.0, 3)
    b.insert_chunk(np.ones((4, 3), np.float32), payloads=["a", "b", "c", "d"])
    b.insert_chunk(np.zeros((2, 3), np.float32), payloads=["e", "f"])
    f = b.build()
    assert f.payloads == ["a", "b", "c", "d", "e", "f"]
    with pytest.raises(ValueError):
        b.insert_chunk(np.ones((2, 5), np.float32))  # wrong dim
    with pytest.raises(ValueError):
        rp.ForestBuilder(0, 4, 5, 2, 1.0, 3).build()  # empty source


def test_builder_incremental_rebuild():
    b = rp.ForestBuilder(3, 4, 5, 2, 1.0, 2, periodic_rebuild_every=1)
    b.insert_chunk(np.random.default_rng(0).normal(size=(50, 2)))
    f1 = b.build()
    assert f1.tree_size() == 50
    b.insert_chunk(np.random.default_rng(1).normal(size=(30, 2)))
    f2 = b.build()
    assert f2.tree_size() == 80


def test_streaming_oracle_refine_semantics():
    """The numpy oracle's streaming mode follows the reference's
    running-average thresholds and margin merging -- check the tree still
    holds all points and queries hit near neighbours (the reference's own
    statistical contract)."""
    from rptree_tpu.reference import ref_build_stream, tree_size as rts, ref_knn

    n, dim = 400, 2
    x = np.asarray(rgen.data_batch(5, n, rgen.circle2d2), np.float64)
    r = np.asarray(rgen.sample_projections(5, 1, 5, dim, 1.0)[0], np.float64)
    t = ref_build_stream(x, r, max_depth=5, min_leaf=10, chunk_size=50)
    assert rts(t) == n
    d, ids = ref_knn([t], x, np.zeros(2), 5)
    assert d.max() < 1.0


def test_streaming_data_parallel_bounded_memory():
    """Streaming accumulation is sharded -- chunks land
    round-robin across the mesh devices (per-device peak O(N/S)), the
    finalize consumes shard-local rows, and the built forest keeps the
    dataset sharded.  GIST-shaped rows (dim 960), scaled down for CI."""
    import collections

    import numpy as np

    from rptree_tpu import ForestBuilder
    from rptree_tpu.parallel.data_parallel import data_mesh

    n, dim, chunk = 4096, 960, 256
    rng = np.random.default_rng(5)
    mesh = data_mesh(8)
    b = ForestBuilder(9, 5, 64, 2, 0.5, dim, mesh=mesh)
    for s in range(0, n, chunk):
        b.insert_chunk(rng.normal(size=(chunk, dim)).astype(np.float32))

    # accumulation: every chunk committed to ONE device, rows balanced
    per_dev = collections.Counter()
    for c in b._chunks:
        devs = list(c.devices())
        assert len(devs) == 1
        per_dev[devs[0]] += c.shape[0]
    assert max(per_dev.values()) <= n // 8 + chunk

    f = b.build()
    assert f.tree_size() == n
    # the finalized forest keeps x sharded: 1/8 of the rows per device
    assert max(sh.data.shape[0] for sh in f.x.addressable_shards) == n // 8
    # and it serves correctly
    q = np.asarray(b._chunks[0])[:4]
    d, i = map(np.asarray, f.knn(q, 3))
    assert (i[:, 0] >= 0).all() and (d[:, 0] < d[:, 2]).all()


def test_streaming_data_parallel_finalize():
    """Streaming accumulation with the sharded (data-parallel) finalize
    must equal the single-device streaming build."""
    import numpy as np

    from rptree_tpu import ForestBuilder
    from rptree_tpu.parallel.data_parallel import data_mesh
    from rptree_tpu.utils import gen as rgen

    x = np.asarray(rgen.data_batch(21, 1600, rgen.circle2d2), np.float32)
    b1 = ForestBuilder(3, 6, 12, 2, 1.0, 2)
    b2 = ForestBuilder(3, 6, 12, 2, 1.0, 2, mesh=data_mesh(8))
    for s in range(0, 1600, 400):
        b1.insert_chunk(x[s:s + 400])
        b2.insert_chunk(x[s:s + 400])
    f1, f2 = b1.build(), b2.build()
    for t in range(2):
        l1 = [set(b) for b in f1.leaves(t)]
        l2 = [set(b) for b in f2.leaves(t)]
        assert sum(a != b for a, b in zip(l1, l2)) == 0


def test_anytime_partial_index():
    """anytime_slack: a queryable partial index tracks the stream online
    (fold into slack slots; NO mid-stream rebuilds), while build() stays
    the exact batch build.  Closes the reference's refine-as-you-go gap
    (Internal.hs:280-285) with strictly better freshness: the reference
    never exposes a mid-stream index at all."""
    import numpy as np

    from rptree_tpu import ForestBuilder

    rng = np.random.default_rng(77)
    dim = 8
    b = ForestBuilder(11, 5, 32, 2, 1.0, dim, anytime_slack=512)
    first = rng.normal(size=(600, dim)).astype(np.float32)
    b.insert_chunk(first)
    assert b.partial_index is not None
    n_plan = b.partial_index.plan.n
    marker = None
    for i in range(4):
        c = rng.normal(size=(200, dim)).astype(np.float32) + (i + 1)
        b.insert_chunk(c)
        marker = c[0]
        # the partial index already answers for the chunk just inserted
        d, ids = map(np.asarray,
                     b.partial_index.knn(marker, 1,
                                         budget=b.partial_index.plan.n_leaves))
        assert float(d[0, 0]) < 1e-3
    # bounded work: the partial index was NEVER rebuilt (same plan size)
    assert b.partial_index.plan.n == n_plan
    # exact finalize unchanged
    f = b.build()
    assert f.tree_size() == 600 + 4 * 200


def test_anytime_partial_index_data_parallel():
    """anytime_slack + data_parallel: the partial
    index is a DataParallelForest with leaf-sharded slack blocks -- the
    anytime view keeps O(N/S) per device and later chunks fold through
    the sharded scatter; build() stays the exact sharded batch build."""
    import numpy as np

    from rptree_tpu import ForestBuilder
    from rptree_tpu.parallel import DataParallelForest, data_mesh

    rng = np.random.default_rng(78)
    dim = 8
    mesh = data_mesh(8)
    b = ForestBuilder(12, 5, 32, 2, 1.0, dim, mesh=mesh,
                      anytime_slack=256)
    first = rng.normal(size=(640, dim)).astype(np.float32)
    b.insert_chunk(first)
    p = b.partial_index
    assert isinstance(p, DataParallelForest)
    assert max(s.data.shape[0] for s in p.x.addressable_shards) == 640 // 8
    for i in range(3):
        c = rng.normal(size=(160, dim)).astype(np.float32) + (i + 1)
        b.insert_chunk(c)
        d, ids = map(np.asarray,
                     b.partial_index.knn(c[0], 1,
                                         budget=p.plan.n_leaves))
        # ~0: the inserted point itself (factored-form f32 roundoff only)
        assert float(d[0, 0]) < 1e-2
    assert b.partial_index.plan.n == 640  # never rebuilt
    f = b.build()
    assert f.tree_size() == 640 + 3 * 160
