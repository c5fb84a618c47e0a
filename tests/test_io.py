"""Serialisation round-trips (reference serialiseRPForest /
deserialiseRPForest, Internal.hs:185-196)."""

import numpy as np
import pytest

import rptree_tpu as rp
from rptree_tpu.utils import gen as rgen


def _forest(payloads=False, sparse=False):
    n, dim = 300, 6
    if sparse:
        svs = []
        for i in range(n):
            a, b = i % dim, (i + 3) % dim
            pairs = sorted({a: float(i + 1), b: 0.5}.items())[: 2 - (i % 2)]
            svs.append(rp.from_list_sv(dim, pairs))
        x = rp.ell_from_svecs(svs)
    else:
        x = np.asarray(rgen.data_batch(1, n, lambda k, m: rgen.dense(k, m, dim)),
                       np.float32)
    pl = [f"item-{i}" for i in range(n)] if payloads else None
    return rp.forest_batch(1, 4, 10, 3, 1.0, x, payloads=pl)


def _assert_equal_forests(a, b):
    np.testing.assert_array_equal(np.asarray(a.arrays.perm),
                                  np.asarray(b.arrays.perm))
    np.testing.assert_array_equal(np.asarray(a.arrays.r), np.asarray(b.arrays.r))
    for l in range(a.plan.n_levels):
        np.testing.assert_array_equal(np.asarray(a.arrays.thr[:, l]),
                                      np.asarray(b.arrays.thr[:, l]))
        np.testing.assert_array_equal(np.asarray(a.arrays.mgl[:, l]),
                                      np.asarray(b.arrays.mgl[:, l]))
        np.testing.assert_array_equal(np.asarray(a.arrays.mgh[:, l]),
                                      np.asarray(b.arrays.mgh[:, l]))
    q = np.ones(a.dim, np.float32) * 0.1
    da, ia = map(np.asarray, a.knn(q, 3))
    db, ib = map(np.asarray, b.knn(q, 3))
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db)


def test_save_load_roundtrip(tmp_path):
    f = _forest(payloads=True)
    p = str(tmp_path / "forest.npz")
    rp.save_forest(p, f)
    g = rp.load_forest(p)
    _assert_equal_forests(f, g)
    assert g.payloads[:3] == ["item-0", "item-1", "item-2"]
    assert g.config == f.config


def test_save_load_sparse(tmp_path):
    f = _forest(sparse=True)
    p = str(tmp_path / "sparse.npz")
    rp.save_forest(p, f)
    g = rp.load_forest(p)
    _assert_equal_forests(f, g)
    assert isinstance(g.x, rp.EllMatrix)


def test_per_tree_blobs_roundtrip_any_order():
    f = _forest()
    blobs = rp.serialise_rp_forest(f)
    assert len(blobs) == f.n_trees
    # restore in reversed order: trees re-keyed 0.. (order undefined)
    g = rp.deserialise_rp_forest(list(reversed(blobs)))
    assert g.n_trees == f.n_trees
    np.testing.assert_array_equal(
        np.sort(np.asarray(g.arrays.r).ravel()),
        np.sort(np.asarray(f.arrays.r).ravel()),
    )
    q = np.ones(f.dim, np.float32) * 0.1
    np.testing.assert_array_equal(np.asarray(g.knn(q, 3)[1]),
                                  np.asarray(f.knn(q, 3)[1]))


def test_deserialise_error_surface():
    with pytest.raises(ValueError):
        rp.deserialise_rp_forest([b"not a checkpoint"])
    with pytest.raises(ValueError):
        rp.deserialise_rp_forest([])


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Per-shard checkpoints -- save never materializes
    the full dataset in one buffer (one npz per shard), restore uploads
    each shard straight to its device and yields a working
    DataParallelForest with per-device rows still N/S."""
    import numpy as np

    import rptree_tpu as rt
    from rptree_tpu.parallel import data_mesh, forest_batch_data_parallel

    rng = np.random.default_rng(77)
    n, dim, t = 800, 16, 2
    x = rng.normal(size=(n, dim)).astype(np.float32)
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(5, 5, 10, t, 1.0, x, mesh=mesh)
    d = tmp_path / "ckpt"
    rt.save_forest_sharded(str(d), f)
    import os

    files = sorted(os.listdir(d))
    assert "common.npz" in files
    shard_files = [p for p in files if p.startswith("shard_")]
    assert len(shard_files) == 8
    g = rt.load_forest_sharded(str(d), mesh=mesh)
    assert max(s.data.shape[0] for s in g.x.addressable_shards) == n // 8
    np.testing.assert_array_equal(np.asarray(f.arrays.perm),
                                  np.asarray(g.arrays.perm))
    q = x[:7] + 0.01
    d1, i1 = map(np.asarray, f.knn(q, 5, budget=8))
    d2, i2 = map(np.asarray, g.knn(q, 5, budget=8))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    np.testing.assert_array_equal(i1, i2)
    # packed serving after restore
    g.pack_leaves()
    d3, i3 = map(np.asarray, g.knn(q, 5, budget=8))
    np.testing.assert_allclose(d1, d3, atol=1e-4)
    # resharding restore: same rows on a smaller mesh
    g4 = rt.load_forest_sharded(str(d), mesh=data_mesh(4))
    assert max(s.data.shape[0] for s in g4.x.addressable_shards) == n // 4
    d4, i4 = map(np.asarray, g4.knn(q, 5, budget=8))
    np.testing.assert_array_equal(i1, i4)
    # learned grouped capacities persist through the SHARDED checkpoint
    # and reinstall only on a matching mesh + pack layout
    f.pack_leaves()
    dg, ig = map(np.asarray, f.knn_grouped(q, 5, budget=8))
    assert f._grouped_nt
    d2p = tmp_path / "ckpt2"
    rt.save_forest_sharded(str(d2p), f)
    g5 = rt.load_forest_sharded(str(d2p), mesh=mesh)
    g5.pack_leaves()
    dg5, ig5 = map(np.asarray, g5.knn_grouped(q, 5, budget=8,
                                              check=False))
    np.testing.assert_array_equal(ig, ig5)
    assert g5._grouped_nt == f._grouped_nt
    # a different mesh shape must NOT inherit per-shard capacities
    from rptree_tpu.models.forest import _pack_sig
    g6 = rt.load_forest_sharded(str(d2p), mesh=data_mesh(4))
    g6.pack_leaves()
    assert _pack_sig(g6) != g6._grouped_nt_saved["pack"]


def test_sharded_checkpoint_ell_roundtrip(tmp_path):
    import numpy as np

    import rptree_tpu as rt
    from rptree_tpu.ops.sparse import EllMatrix
    from rptree_tpu.parallel import data_mesh, forest_batch_data_parallel

    rng = np.random.default_rng(78)
    n, dim, nnz = 800, 48, 6
    cols = rng.integers(1, dim, size=(n, nnz)).astype(np.int32)
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    ell = EllMatrix(dim, cols, vals)
    mesh = data_mesh(8)
    f = forest_batch_data_parallel(6, 5, 10, 2, 1.0, ell, mesh=mesh)
    d = tmp_path / "ckpt_ell"
    rt.save_forest_sharded(str(d), f)
    g = rt.load_forest_sharded(str(d), mesh=mesh)
    assert max(s.data.shape[0] for s in g.x.cols.addressable_shards) \
        == n // 8
    q = np.asarray(rt.ell_to_dense(ell))[:5] + 0.01
    d1, i1 = map(np.asarray, f.knn(q, 5, budget=8))
    d2, i2 = map(np.asarray, g.knn(q, 5, budget=8))
    np.testing.assert_allclose(d1, d2, atol=1e-5)
    np.testing.assert_array_equal(i1, i2)


def test_saved_grouped_capacities_roundtrip(tmp_path):
    """Learned grouped tile capacities persist through save_forest and
    reinstall on a restored server that repacks the SAME layout -- the
    first check=False call then serves without re-walking the
    auto-capacity ladder.  A different layout (or no
    pack) must NOT inherit them."""
    f = _forest()
    f.pack_leaves()
    q = np.asarray(rgen.data_batch(5, 16, lambda k, m: rgen.dense(k, m, 6)),
                   np.float32)
    d0, i0 = map(np.asarray, f.knn_grouped(q, 3))
    assert f._grouped_nt
    p = str(tmp_path / "forest.npz")
    rp.save_forest(p, f)
    g = rp.load_forest(p)
    g.pack_leaves()
    # steady-state call works IMMEDIATELY (capacity from the checkpoint;
    # check=False with an unknown key would otherwise validate+cache)
    d1, i1 = map(np.asarray, g.knn_grouped(q, 3, check=False))
    np.testing.assert_array_equal(i0, i1)
    assert g._grouped_nt == f._grouped_nt
    # a DIFFERENT pack layout must not inherit the capacities: the
    # stored signature no longer matches, so the lazy install refuses
    # and the first call validates fresh
    from rptree_tpu.models.forest import _pack_sig

    g2 = rp.load_forest(p)
    g2.pack_leaves(slack=4)
    assert _pack_sig(g2) != g2._grouped_nt_saved["pack"]
    d2, i2 = map(np.asarray, g2.knn_grouped(q, 3, check=False))
    np.testing.assert_array_equal(i0, i2)
