"""Exactness of the fused streaming top-k tail (ops/topk_kernel) vs the
payload-sort tail it replaces (interpret mode; the card runs the same
comparison in chip_smoke.py), plus the gate that chooses it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rptree_tpu.models.forest import _selection_tail_ids
from rptree_tpu.ops import topk_kernel
from rptree_tpu.ops.topk_kernel import (topk_block_rows, topk_dedup_kernel,
                                        topk_kernel_ok)


def _sort_tail(d, ids, k, kk, dedup):
    """Numpy re-execution of _selection_tail_ids(selection='sort'):
    stable distance order, and with dedup the id-sorted merge (ties among
    equal distances end in ascending id order)."""
    out_d = np.empty((d.shape[0], k), np.float32)
    out_i = np.empty((d.shape[0], k), np.int32)
    for r in range(d.shape[0]):
        order = np.argsort(d[r], kind="stable")[:kk]
        dd, ii = d[r][order], ids[r][order]
        ii = np.where(np.isinf(dd), -1, ii)
        if dedup:
            seen, keep = set(), []
            for j in range(kk):
                if ii[j] >= 0 and ii[j] in seen:
                    continue
                if ii[j] >= 0:
                    seen.add(ii[j])
                keep.append(j)
            dd, ii = dd[keep], ii[keep]
            o2 = np.lexsort((ii, dd))
            dd = np.concatenate([dd[o2], np.full(kk, np.inf, np.float32)])
            ii = np.concatenate([ii[o2], np.full(kk, -1, np.int32)])
        out_d[r] = dd[:k]
        out_i[r] = np.where(np.isinf(dd[:k]), -1, ii[:k])
    return out_d, out_i


def _xla_tail(d, ids, k, dedup):
    """The production sort tail itself, at full width."""
    return map(np.asarray, _selection_tail_ids(
        jnp.asarray(d), jnp.asarray(ids), k, d.shape[1], dedup))


@pytest.mark.parametrize("dedup", [True, False])
def test_topk_kernel_matches_sort_tail(dedup):
    """Random state with masked slots and BIT-IDENTICAL duplicate copies
    (the exact-layout case): kernel == stable-sort tail, bitwise."""
    rng = np.random.default_rng(0)
    b, w, k = 24, 256, 10
    base = rng.uniform(1.0, 9.0, size=(b, w)).astype(np.float32)
    ids = rng.integers(0, 40, size=(b, w)).astype(np.int32)
    # duplicates of the same id carry identical distances (scored from
    # the same stored row): overwrite each row's copies with the first
    d = base.copy()
    for r in range(b):
        first = {}
        for j in range(w):
            if ids[r, j] in first:
                d[r, j] = d[r, first[ids[r, j]]]
            else:
                first[ids[r, j]] = j
    # masked slots
    mask = rng.uniform(size=(b, w)) < 0.3
    d = np.where(mask, np.inf, d).astype(np.float32)
    ids = np.where(mask, -1, ids)
    kd, ki = topk_dedup_kernel(jnp.asarray(d), jnp.asarray(ids), k,
                               dedup=dedup, bm=8, interpret=True)
    # full-width oracle: the production tail's kk = k * n_trees prefix
    # equals this whenever each id has <= n_trees copies (the forest
    # invariant); the kernel implements the full-width semantics directly
    rd, ri = _sort_tail(d, ids, k, w, dedup)
    np.testing.assert_array_equal(np.asarray(ki), ri)
    np.testing.assert_array_equal(np.asarray(kd), rd)


@pytest.mark.parametrize("bm", [1, 2, 4])
@pytest.mark.parametrize("dedup", [True, False])
def test_topk_kernel_matches_xla_tail_with_ties(bm, dedup):
    """Quantized distances (many exact ties between distinct ids, as on
    int8 layouts) and a width that is not a power of two: the kernel
    returns the production sort tail's ids row for row and its distances
    bit for bit, for every rows-per-program choice."""
    rng = np.random.default_rng(11)
    b, w, k = 13, 90, 10
    d = (rng.integers(0, 12, size=(b, w)) / 4.0).astype(np.float32)
    ids = rng.integers(0, 60, size=(b, w)).astype(np.int32)
    d[rng.uniform(size=(b, w)) < 0.2] = np.inf
    if dedup:
        # the sort tail's keep-any-copy merge is exact when an id's
        # copies share one distance (exact layouts); make them so
        for r in range(b):
            for i in np.unique(ids[r]):
                sel = ids[r] == i
                d[r, sel] = d[r, sel].min()
    kd, ki = topk_dedup_kernel(jnp.asarray(d), jnp.asarray(ids), k,
                               dedup=dedup, bm=bm, interpret=True)
    xd, xi = _xla_tail(d, ids, k, dedup)
    np.testing.assert_array_equal(np.asarray(ki), xi)
    np.testing.assert_array_equal(np.asarray(kd), xd)


def test_topk_kernel_dup_distances_keep_min():
    """Quantized cross-leaf duplicates (same id, different distances):
    the kernel keeps the LOWEST-distance copy and never returns an id
    twice."""
    d = jnp.asarray([[5.0, 1.0, 3.0, 2.0] + [np.inf] * 124], jnp.float32)
    ids = jnp.asarray([[7, 7, 3, 3] + [-1] * 124], jnp.int32)
    kd, ki = topk_dedup_kernel(d, ids, 3, dedup=True, bm=8,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(ki), [[7, 3, -1]])
    np.testing.assert_allclose(np.asarray(kd)[0, :2], [1.0, 2.0])
    assert np.isinf(np.asarray(kd)[0, 2])


def test_topk_kernel_exhausted_rows_and_padding():
    """Rows with < k live candidates pad with (+inf, -1); batch sizes
    that are not a block multiple are masked, not padded."""
    b, w, k = 10, 128, 4  # b=10 with bm=8 exercises the ragged block
    d = np.full((b, w), np.inf, np.float32)
    ids = np.full((b, w), -1, np.int32)
    d[:, 0], ids[:, 0] = 2.0, 5
    d[3, 1], ids[3, 1] = 1.0, 9
    kd, ki = topk_dedup_kernel(jnp.asarray(d), jnp.asarray(ids), k,
                               dedup=True, bm=8, interpret=True)
    ki = np.asarray(ki)
    assert ki.shape == (b, k)
    np.testing.assert_array_equal(ki[0], [5, -1, -1, -1])
    np.testing.assert_array_equal(ki[3], [9, 5, -1, -1])
    np.testing.assert_array_equal(ki[9], [5, -1, -1, -1])
    assert np.isinf(np.asarray(kd)[0, 1:]).all()


def test_topk_kernel_lane_pad_non_multiple_width():
    """Candidate widths that are not powers of two (the serving paths'
    probes*lmax) pad by masked loads with (+inf, -1) and match the sort
    tail exactly."""
    rng = np.random.default_rng(3)
    b, w, k = 16, 200, 6  # 200 -> a 256-wide block
    d = rng.uniform(1.0, 9.0, size=(b, w)).astype(np.float32)
    ids = rng.integers(0, 500, size=(b, w)).astype(np.int32)
    kd, ki = topk_dedup_kernel(jnp.asarray(d), jnp.asarray(ids), k,
                               dedup=True, bm=8, interpret=True)
    rd, ri = _sort_tail(d, ids, k, w, True)
    np.testing.assert_array_equal(np.asarray(ki), ri)
    np.testing.assert_array_equal(np.asarray(kd), rd)


def test_topk_kernel_tie_break_lowest_position():
    """Without dedup, equal distances with distinct ids extract in slot
    order (the stable sort's prefix)."""
    d = jnp.asarray([[4.0] * 128], jnp.float32)
    ids = jnp.asarray([np.arange(128, dtype=np.int32)[::-1]])
    _, ki = topk_dedup_kernel(d, ids, 5, dedup=False, bm=8,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(ki)[0],
                                  [127, 126, 125, 124, 123])


def test_topk_kernel_tie_break_lowest_id_with_dedup():
    """With dedup, equal distances with distinct ids extract in id order
    (the sort tail's id-sorted merge)."""
    d = jnp.asarray([[4.0] * 128], jnp.float32)
    ids = jnp.asarray([np.arange(128, dtype=np.int32)[::-1]])
    _, ki = topk_dedup_kernel(d, ids, 5, dedup=True, bm=8,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(ki)[0], [0, 1, 2, 3, 4])


@pytest.mark.parametrize("w,bm", [(1, 2048), (640, 2), (1024, 2),
                                  (1600, 1), (5000, 1)])
def test_topk_block_rows(w, bm):
    """Rows per program keep ~2048 candidates in registers, >= 1 row."""
    assert topk_block_rows(w) == bm


def test_topk_kernel_gate(monkeypatch):
    """The kernel is chosen on a GPU backend only, for k <= 128 and the
    exact (non-voting, non-approximate) selection."""
    monkeypatch.setattr(topk_kernel.jax, "default_backend", lambda: "gpu")
    assert topk_kernel_ok(1024, 10)
    assert not topk_kernel_ok(1024, 129)
    assert not topk_kernel_ok(1024, 10, min_votes=2)
    assert not topk_kernel_ok(1024, 10, selection="approx")
    monkeypatch.setattr(topk_kernel.jax, "default_backend", lambda: "cpu")
    assert not topk_kernel_ok(1024, 10)


def test_selection_kernel_raises_off_gpu():
    """selection='kernel' names the GPU in its error on other backends
    (no silent interpret-mode fallback)."""
    assert jax.default_backend() == "cpu"
    d = jnp.ones((2, 16), jnp.float32)
    ids = jnp.zeros((2, 16), jnp.int32)
    with pytest.raises(ValueError, match="GPU backend"):
        _selection_tail_ids(d, ids, 3, 16, True, selection="kernel")
