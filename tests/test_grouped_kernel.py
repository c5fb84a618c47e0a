"""Fused grouped tile-scoring kernel (ops/grouped_kernel.py): exactness
in interpret mode against a numpy re-execution of the tile contract and
against the XLA grouped path, plus the gate that chooses it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from rptree_tpu.models import forest as fmod
from rptree_tpu.ops import grouped
from rptree_tpu.ops.grouped_kernel import (grouped_kernel_ok,
                                           grouped_score_tiles,
                                           grouped_score_tiles_int8)

HI = lax.Precision.HIGHEST


def _ref_tiles(x, sq, tb, lens_t, qt, metric, tile_m):
    nt = tb.shape[0]
    lmax = x.shape[1]
    out = np.full((nt * tile_m, lmax), np.inf, np.float32)
    for i in range(nt):
        blk = x[tb[i]].astype(np.float64)
        for m in range(tile_m):
            qv = qt[i * tile_m + m].astype(np.float64)
            dd = np.maximum(
                sq[tb[i]].astype(np.float64)
                - 2.0 * (blk @ qv) + float(qv @ qv), 0.0)
            if metric == "l2":
                dd = np.sqrt(dd)
            row = np.where(np.arange(lmax) < lens_t[i], dd, np.inf)
            out[i * tile_m + m] = row.astype(np.float32)
    return out


@pytest.mark.parametrize("tile_m", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "sql2"])
def test_grouped_score_tiles_interpret(metric, dtype, tile_m):
    """Odd slot and feature widths (masked power-of-two blocks) and
    several slot chunks per tile, against float64 numpy."""
    rng = np.random.default_rng(0)
    g, lmax, d = 9, 75, 50
    nt = 6
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    sq = (x * x).sum(-1).astype(np.float32)
    tb = rng.integers(0, g, size=nt).astype(np.int32)
    lens_t = rng.integers(1, lmax + 1, size=nt).astype(np.int32)
    qt = rng.normal(size=(nt * tile_m, d)).astype(np.float32)
    out = grouped_score_tiles(jnp.asarray(x).astype(dtype), jnp.asarray(sq),
                              jnp.asarray(tb), jnp.asarray(lens_t),
                              jnp.asarray(qt), metric, tile_m,
                              precision=HI if dtype == "float32" else None,
                              interpret=True)
    qref = np.asarray(jnp.asarray(qt).astype(dtype).astype(jnp.float32))
    ref = _ref_tiles(x, sq, tb, lens_t, qref, metric, tile_m)
    tol = 2e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(np.asarray(out), ref, rtol=tol, atol=tol)


def test_grouped_score_tiles_repeated_blocks():
    """Clustered pair sets repeat blocks heavily; consecutive tiles of
    the same block must score identically."""
    rng = np.random.default_rng(1)
    g, lmax, d = 6, 8, 32
    tile_m, nt = 16, 16
    x = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = (x * x).sum(-1).astype(np.float32)
    tb = np.zeros(nt, np.int32)
    tb[8:] = 3
    lens_t = np.full(nt, lmax, np.int32)
    qt = np.tile(rng.normal(size=(1, d)).astype(np.float32),
                 (nt * tile_m, 1))
    out = np.asarray(grouped_score_tiles(
        jnp.asarray(x), jnp.asarray(sq), jnp.asarray(tb),
        jnp.asarray(lens_t), jnp.asarray(qt), "sql2", tile_m,
        precision=HI, interpret=True))
    for i in range(1, 8):
        np.testing.assert_array_equal(out[0], out[i * tile_m])
    for i in range(9, 16):
        np.testing.assert_array_equal(out[8 * tile_m], out[i * tile_m])


def test_grouped_kernel_gate():
    assert grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.float32), "l2")
    assert grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.bfloat16), "sql2")
    # slot and feature widths are free (masked power-of-two blocks)
    assert grouped_kernel_ok(jnp.zeros((4, 13, 50), jnp.float32), "l2")
    assert grouped_kernel_ok(jnp.zeros((4, 56, 64), jnp.int8), "l2")
    assert grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.float32), "l2",
                             tile_m=32)
    # tile_m: a power of two >= 16 (the tensor-core dot's M)
    assert not grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.float32), "l2",
                                 tile_m=8)
    assert not grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.float32), "l2",
                                 tile_m=24)
    assert not grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.float16), "l2")
    assert not grouped_kernel_ok(jnp.zeros((4, 16, 64), jnp.float32),
                                 "cosine")
    from rptree_tpu.ops.sparse import EllBlocks
    assert not grouped_kernel_ok(
        EllBlocks(64, jnp.zeros((4, 16, 3), jnp.int32),
                  jnp.zeros((4, 16, 3), jnp.float32)), "l2")
    from rptree_tpu.ops.shared import SharedRows
    assert not grouped_kernel_ok(
        SharedRows(jnp.zeros((10, 64), jnp.float32),
                   jnp.zeros((4, 16), jnp.int32)), "l2")


def test_kernel_precision(monkeypatch):
    """f32 blocks: HIGHEST is IEEE; lower settings get the 3-pass TF32
    floor on the GPU and IEEE f32 on backends without TF32."""
    f32p = grouped.f32_dot_precision
    monkeypatch.setattr(grouped.jax, "default_backend", lambda: "gpu")
    assert f32p(HI) == HI
    assert (f32p(lax.Precision.DEFAULT)
            == lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    assert (f32p(lax.Precision.HIGH)
            == lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    monkeypatch.setattr(grouped.jax, "default_backend", lambda: "cpu")
    assert f32p(lax.Precision.DEFAULT) == HI
    assert f32p(HI) == HI


@pytest.mark.parametrize("precision", ["default", "highest"])
def test_grouped_distances_f32_floor(monkeypatch, precision):
    """The XLA grouped path contracts f32 blocks at the same floor as the
    kernel: on a GPU backend a "default" request traces the 3-pass TF32
    algorithm, "highest" stays IEEE f32."""
    rng = np.random.default_rng(4)
    g, lmax, d, b, p = 6, 16, 32, 8, 2
    x = jnp.asarray(rng.normal(size=(g, lmax, d)).astype(np.float32))
    sq = jnp.sum(x * x, axis=-1)
    lens = jnp.full((g,), lmax, jnp.int32)
    gsel = jnp.asarray(rng.integers(0, g, size=(b, p)).astype(np.int32))
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    prec = fmod._prec(precision)
    monkeypatch.setattr(grouped.jax, "default_backend", lambda: "gpu")
    text = str(jax.make_jaxpr(lambda *a: grouped.grouped_distances(
        *a, "l2", prec, 16, 8, 4))(x, sq, lens, gsel, gsel, q))
    assert ("TF32_TF32_F32_X3" in text) == (precision == "default")
    bf = x.astype(jnp.bfloat16)
    text = str(jax.make_jaxpr(lambda *a: grouped.grouped_distances(
        *a, "l2", prec, 16, 8, 4))(bf, sq, lens, gsel, gsel, q))
    assert "TF32" not in text  # bf16 blocks keep their native pass


@pytest.mark.parametrize("metric", ["l2", "sql2"])
def test_grouped_score_tiles_int8_interpret(metric):
    """int8 kernel == the XLA int8 grouped contract (quantized dots x
    block scale x per-row query scale against exact stored norms)."""
    rng = np.random.default_rng(3)
    g, lmax, d = 12, 72, 64
    tile_m, nt = 16, 8
    xf = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = (xf * xf).sum(-1).astype(np.float32)
    scale = (np.abs(xf).max(axis=(1, 2)) / 127.0).astype(np.float32)
    xi = np.clip(np.round(xf / scale[:, None, None]), -127, 127).astype(np.int8)
    tb = rng.integers(0, g, size=nt).astype(np.int32)
    lens_t = rng.integers(1, lmax + 1, size=nt).astype(np.int32)
    qt = rng.normal(size=(nt * tile_m, d)).astype(np.float32)
    # numpy re-execution of the quantized contract
    amax = np.maximum(np.abs(qt).max(axis=1, keepdims=True), 1e-30)
    qsc = (amax / 127.0).astype(np.float32)
    qi = np.clip(np.round(qt / qsc), -127, 127).astype(np.int8)
    out = grouped_score_tiles_int8(
        jnp.asarray(xi), jnp.asarray(sq), jnp.asarray(scale),
        jnp.asarray(tb), jnp.asarray(lens_t), jnp.asarray(qi),
        jnp.asarray(qsc[:, 0]), jnp.asarray((qt * qt).sum(1)), metric,
        tile_m, interpret=True)
    ref = np.full((nt * tile_m, lmax), np.inf, np.float32)
    for i in range(nt):
        blk = xi[tb[i]].astype(np.int32)
        for m in range(tile_m):
            r = i * tile_m + m
            dots = (blk @ qi[r].astype(np.int32)).astype(np.float64)
            dots = dots * scale[tb[i]] * qsc[r, 0]
            dd = np.maximum(sq[tb[i]] - 2.0 * dots + float(qt[r] @ qt[r]),
                            0.0)
            if metric == "l2":
                dd = np.sqrt(dd)
            ref[r] = np.where(np.arange(lmax) < lens_t[i], dd,
                              np.inf).astype(np.float32)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def _probe_set(rng, g, b, p):
    gsel = rng.integers(0, g, size=(b, p)).astype(np.int32)
    # clustered-style repeats plus some masked probes
    gsel[b // 2:] = gsel[0]
    lsel = np.where(rng.uniform(size=(b, p)) < 0.15, -1, gsel)
    return jnp.asarray(gsel), jnp.asarray(lsel.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_grouped_distances_kernel_matches_xla(dtype):
    """The kernel wrapper (tile tables, query gather, pair reorder) gives
    the XLA grouped path's distances for every (query, probe) pair,
    including masked probes and capacity overflow."""
    rng = np.random.default_rng(5)
    g, lmax, d, b, p = 10, 24, 40, 20, 3
    xf = rng.normal(size=(g, lmax, d)).astype(np.float32)
    sq = jnp.asarray((xf * xf).sum(-1))
    lens = jnp.asarray(rng.integers(1, lmax + 1, size=g).astype(np.int32))
    q = jnp.asarray(rng.normal(size=(b, d)).astype(np.float32))
    scale = None
    if dtype == "int8":
        scale = np.abs(xf).max(axis=(1, 2)) / 127.0
        x = jnp.asarray(np.clip(np.round(xf / scale[:, None, None]),
                                -127, 127).astype(np.int8))
        scale = jnp.asarray(scale.astype(np.float32))
    else:
        x = jnp.asarray(xf)
    gsel, lsel = _probe_set(rng, g, b, p)
    for nt in (64, 3):  # ample, then overflowing capacity
        dx, nx = grouped.grouped_distances(x, sq, lens, gsel, lsel, q,
                                           "l2", HI, 16, nt, 1,
                                           block_scale=scale)
        dk, nk = grouped.grouped_distances_kernel(
            x, sq, lens, gsel, lsel, q, "l2", HI, 16, nt,
            block_scale=scale, interpret=True)
        assert int(nx) == int(nk)
        dx, dk = np.asarray(dx), np.asarray(dk)
        np.testing.assert_array_equal(np.isinf(dx), np.isinf(dk))
        fin = np.isfinite(dx)
        np.testing.assert_allclose(dk[fin], dx[fin], rtol=1e-4, atol=1e-4)


def test_grouped_use_kernel_choice(monkeypatch):
    """auto takes the kernel on a GPU backend for eligible blocks and on
    nothing else; impl='kernel' raises with a message naming the GPU."""
    x = jnp.zeros((4, 16, 64), jnp.float32)
    xi = jnp.zeros((4, 16, 64), jnp.int8)
    sc = jnp.ones((4,), jnp.float32)
    monkeypatch.setattr(fmod.jax, "default_backend", lambda: "cpu")
    assert not fmod._grouped_use_kernel("auto", x, "l2", None, None)
    with pytest.raises(ValueError, match="GPU backend"):
        fmod._grouped_use_kernel("kernel", x, "l2", None, None)
    monkeypatch.setattr(fmod.jax, "default_backend", lambda: "gpu")
    assert fmod._grouped_use_kernel("auto", x, "l2", None, None)
    assert fmod._grouped_use_kernel("kernel", x, "sql2", None, None)
    assert fmod._grouped_use_kernel("auto", xi, "l2", sc, None)
    assert not fmod._grouped_use_kernel("xla", x, "l2", None, None)
    # centered int8, non-builtin metrics, small tiles keep XLA
    assert not fmod._grouped_use_kernel("auto", xi, "l2", sc, (sc, sc))
    assert not fmod._grouped_use_kernel("auto", x, "cosine", None, None)
    assert not fmod._grouped_use_kernel("auto", x, "l2", None, None,
                                        tile_m=8)
    with pytest.raises(ValueError, match="tile_m"):
        fmod._grouped_use_kernel("kernel", x, "l2", None, None, tile_m=8)
    # the per-pair top-k' variant is gone with its option
    with pytest.raises(ValueError, match="impl must be"):
        fmod._grouped_use_kernel("kernel_topk", x, "l2", None, None)


@pytest.mark.parametrize("pack", ["f32", "int8"])
def test_knn_grouped_kernel_route_matches_xla(monkeypatch, pack):
    """End to end through RPForest.knn_grouped: with the backend reported
    as a GPU (kernels in interpret mode), impl='auto' routes through the
    tile kernel and selection='kernel' through the top-k kernel, and both
    return the XLA route's neighbours."""
    import rptree_tpu as rt
    from rptree_tpu.ops import topk_kernel

    rng = np.random.default_rng(7)
    x = rng.normal(size=(600, 24)).astype(np.float32)
    q = x[:32] + 0.05 * rng.normal(size=(32, 24)).astype(np.float32)
    f = rt.forest_batch(3, 5, 16, 4, 1.0, x)
    if pack == "int8":
        f.pack_leaves(dtype=jnp.int8)
    else:
        f.pack_leaves()
    d0, i0 = map(np.asarray, f.knn_grouped(q, 5, impl="xla"))
    calls = []
    real = grouped.grouped_distances_kernel

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **dict(kw, interpret=True))

    monkeypatch.setattr(grouped, "grouped_distances_kernel", spy)
    monkeypatch.setattr(topk_kernel, "topk_dedup_kernel", functools.partial(
        topk_kernel.topk_dedup_kernel, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    d1, i1 = map(np.asarray, f.knn_grouped(q, 5, selection="kernel"))
    assert calls, "auto did not take the tile kernel on a GPU backend"
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-5)
