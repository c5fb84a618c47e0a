"""EXACT (zero-tolerance) parity vs the reference-semantics oracle.

The statistical parity tests allow a handful of leaf/candidate flips for
f32-vs-f64 ulp ties on Gaussian projections.  Here both data and
projection vectors are small INTEGERS, so every projection value is
exactly representable in f32 and f64 alike: any genuine tie exercises the
stable tie rule (pinned elsewhere) and every non-tie comparison is exact
-- leaf contents, candidates, and margins must agree with the numpy
oracle bit-for-bit, with NO mismatch allowance.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rptree_tpu.config import ForestConfig
from rptree_tpu.models.forest import RPForest
from rptree_tpu.models.plan import make_plan
from rptree_tpu.ops.build import build_forest_arrays, TreeArrays
from rptree_tpu.reference import leaf_spans, ref_candidates, ref_forest_batch


def _integer_forest(seed, n, dim, n_trees, max_depth, min_leaf):
    rng = np.random.default_rng(seed)
    # integers small enough that projections (sums of dim products of
    # |v| <= 8) stay within exact f32 integer range (2^24)
    x = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    r = rng.integers(-8, 9, size=(n_trees, max_depth, dim)
                     ).astype(np.float32)
    plan = make_plan(n, max_depth, min_leaf)
    arrays = build_forest_arrays(plan, jnp.asarray(x), jnp.asarray(r))
    cfg = ForestConfig(n_trees=n_trees, max_depth=max_depth,
                       min_leaf=min_leaf, proj_nz_density=1.0, dim=dim)
    f = RPForest(plan, arrays, jnp.asarray(x),
                 jnp.sum(jnp.asarray(x) ** 2, axis=-1), cfg, seed=seed)
    ref = ref_forest_batch(x.astype(np.float64), r.astype(np.float64),
                           max_depth, min_leaf)
    return f, ref, x, r


@pytest.mark.parametrize("case", range(4))
def test_integer_projection_exact_leaf_parity(case):
    rng = np.random.default_rng(4200 + case)
    n = int(rng.integers(60, 700))
    dim = int(rng.integers(2, 12))
    t = int(rng.integers(1, 4))
    depth = int(rng.integers(2, 7))
    ml = int(rng.integers(1, 16))
    f, ref, x, r = _integer_forest(4300 + case, n, dim, t, depth, ml)
    for tt in range(t):
        ours = [sorted(leaf) for leaf in f.leaves(tt)]
        theirs = [sorted(ids.tolist()) for ids in leaf_spans(ref[tt])]
        assert ours == theirs, (case, tt)  # EXACT: zero mismatches
    # thresholds and margins are exact order statistics of exact integers
    for tt in range(t):
        thr = np.asarray(f.arrays.thr[tt])
        from rptree_tpu.reference import Bin
        node = ref[tt].root
        # spot-check the root split against the oracle tree
        if isinstance(node, Bin):
            assert float(thr[0, 0]) == node.thr, (case, tt)


@pytest.mark.parametrize("case", range(3))
def test_integer_projection_exact_candidates(case):
    rng = np.random.default_rng(4400 + case)
    f, ref, x, r = _integer_forest(4500 + case, 400, 6, 2, 5, 4)
    q = rng.integers(-8, 9, size=(6, 6)).astype(np.float32)
    cand = np.asarray(f.candidates(q, budget=f.plan.n_leaves))
    for tt in range(2):
        for b in range(6):
            mine = set(int(i) for i in cand[tt, b] if i >= 0)
            orc = set(ref_candidates(ref[tt],
                                     q[b].astype(np.float64)).tolist())
            assert mine == orc, (case, tt, b)  # EXACT: zero disagreements
