"""The Triton kernels as compiled for the card, against their plain XLA
versions.  Marked ``gpu``: they skip on the CPU and run on a card with
``RPTREE_GPU_TESTS=1 python -m pytest -m gpu tests/``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from rptree_tpu.models.forest import _selection_tail_ids
from rptree_tpu.ops import grouped
from rptree_tpu.ops.topk_kernel import topk_dedup_kernel

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_kernel_on_card_matches_xla(gpu_device, dtype):
    rng = np.random.default_rng(0)
    g, lmax, d, b, p = 64, 100, 96, 512, 4
    xf = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = jnp.asarray((xf * xf).sum(-1))
    lens = jnp.asarray(rng.integers(1, lmax + 1, size=g).astype(np.int32))
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    scale = None
    if dtype == "int8":
        sc = np.abs(xf).max(axis=(1, 2)) / 127.0
        x = jnp.asarray(np.clip(np.round(xf / sc[:, None, None]), -127,
                                127).astype(np.int8))
        scale = jnp.asarray(sc.astype(np.float32))
    else:
        x = jnp.asarray(xf).astype(dtype)
    gsel = jnp.asarray(rng.integers(0, g, size=(b, p)).astype(np.int32))
    hi = lax.Precision.HIGHEST
    nt = 4096
    dx, nx = jax.jit(lambda *a: grouped.grouped_distances(
        *a, "l2", hi, 16, nt, 2048, block_scale=scale))(
            x, sq, lens, gsel, gsel, q)
    dk, nk = jax.jit(lambda *a: grouped.grouped_distances_kernel(
        *a, "l2", hi, 16, nt, block_scale=scale))(x, sq, lens, gsel, gsel, q)
    assert int(nx) == int(nk)
    dx, dk = np.asarray(dx), np.asarray(dk)
    np.testing.assert_array_equal(np.isinf(dx), np.isinf(dk))
    fin = np.isfinite(dx)
    np.testing.assert_allclose(dk[fin], dx[fin], rtol=1e-4, atol=1e-4)


def test_topk_kernel_on_card_matches_sort_tail(gpu_device):
    rng = np.random.default_rng(1)
    b, w, k = 3000, 1000, 10
    d = jnp.asarray(rng.uniform(1.0, 9.0, size=(b, w)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, 100_000, size=(b, w)).astype(np.int32))
    kd, ki = topk_dedup_kernel(d, ids, k)
    sd, si = jax.jit(lambda a, c: _selection_tail_ids(
        a, c, k, w, True))(d, ids)
    np.testing.assert_array_equal(np.asarray(ki), np.asarray(si))
    np.testing.assert_array_equal(np.asarray(kd), np.asarray(sd))
