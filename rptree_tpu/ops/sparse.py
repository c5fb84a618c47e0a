"""Batched sparse input support (the reference's ``SVector`` datasets).

The reference stores each sparse point as a sorted coordinate list and walks
it with pointer loops (``src/Data/RPTree/Internal.hs:92-119,351-382``).  On
an accelerator, ragged per-row structure defeats XLA tiling, so the dataset-level
representation here is **padded ELL**: every row holds exactly ``K`` (max
nnz) column/value slots, with padding encoded as ``col=0, val=0`` -- padding
therefore contributes nothing to inner products, projections, or squared
norms, and every op below is a dense gather/GEMM that XLA compiles as such.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .vector import SVec

__all__ = ["EllMatrix", "EllBlocks", "ell_from_svecs", "ell_from_scipy_like", "ell_project", "ell_sq_norms", "ell_to_dense", "ell_rows_to_svecs"]


@jax.tree_util.register_pytree_node_class
class EllBlocks:
    """Leaf-blocked padded-ELL rows for the packed serving path: per
    (tree, leaf) block, ``cols: int32[G, lmax, K]`` / ``vals: f32[G, lmax,
    K]`` hold each leaf's sparse points contiguously (the sparse
    counterpart of the dense ``x_leaf`` blocks).  Blocks gather with the
    same per-(query, probe) block index pattern as dense blocks; scoring
    gathers the DENSE query at the stored column indices (``q[b, cols]``)
    and contracts over the K slot axis -- padding (col=0, val=0)
    contributes nothing.  Reference semantics: ``SVector`` inner products
    (``Internal.hs:92-119, 369-382``), batched."""

    def __init__(self, dim: int, cols, vals):
        self.dim = int(dim)
        self.cols = cols
        self.vals = vals

    @property
    def shape(self):
        return self.cols.shape

    @property
    def dtype(self):
        return self.vals.dtype

    def tree_flatten(self):
        return (self.cols, self.vals), self.dim

    @classmethod
    def tree_unflatten(cls, dim, children):
        return cls(dim, *children)


@jax.tree_util.register_pytree_node_class
class EllMatrix:
    """Padded ELL sparse matrix: ``cols: int32[N, K]``, ``vals: f32[N, K]``.

    Padding slots have ``col == 0`` and ``val == 0``.  ``dim`` is the dense
    column dimension (the reference ``svDim``, ``Internal.hs:92``)."""

    def __init__(self, dim: int, cols, vals):
        self.dim = int(dim)
        self.cols = cols
        self.vals = vals

    @property
    def shape(self):
        return (self.cols.shape[0], self.dim)

    @property
    def n(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    def tree_flatten(self):
        return (self.cols, self.vals), self.dim

    @classmethod
    def tree_unflatten(cls, dim, children):
        cols, vals = children
        return cls(dim, cols, vals)

    def __repr__(self):
        return f"EllMatrix(n={self.cols.shape[0]}, dim={self.dim}, k={self.cols.shape[1]})"


def ell_from_svecs(svs: Sequence[SVec], dtype=np.float32) -> EllMatrix:
    """Pack single sparse vectors into a padded ELL matrix."""
    if len(svs) == 0:
        raise ValueError("empty sparse dataset")
    dim = svs[0].dim
    k = max(1, max(sv.nnz for sv in svs))
    n = len(svs)
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=dtype)
    for i, sv in enumerate(svs):
        if sv.dim != dim:
            raise ValueError("inconsistent sparse dimensions")
        cols[i, : sv.nnz] = sv.idx
        vals[i, : sv.nnz] = sv.val
    return EllMatrix(dim, cols, vals)


def ell_from_scipy_like(indptr, indices, data, dim: int, dtype=np.float32) -> EllMatrix:
    """Pack CSR triplets (e.g. from scipy) into padded ELL."""
    indptr = np.asarray(indptr)
    n = indptr.size - 1
    row_nnz = np.diff(indptr)
    k = max(1, int(row_nnz.max()))
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=dtype)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols[i, : e - s] = indices[s:e]
        vals[i, : e - s] = data[s:e]
    return EllMatrix(dim, cols, vals)


def ell_project(x: EllMatrix, r: jax.Array) -> jax.Array:
    """Project every sparse row onto dense vectors: ``X @ R.T``.

    ``r`` is ``[D]`` or ``[L, D]``; result ``[N]`` or ``[N, L]``.  Implemented
    as a gather of ``r`` columns at the stored indices followed by a
    contraction over the K slot axis -- padding contributes 0.  This replaces
    the reference's per-point ``innerSD`` pointer walk
    (``Internal.hs:369-382``) with one batched gather+reduce.
    """
    gathered = jnp.take(r, x.cols, axis=-1)  # [..., N, K]
    return jnp.einsum("...nk,nk->n...", gathered, x.vals)


def ell_sq_norms(x: EllMatrix) -> jax.Array:
    """Squared L2 norm of every row (padding slots are zero)."""
    return jnp.sum(x.vals * x.vals, axis=-1)


def ell_to_dense(x: EllMatrix) -> jax.Array:
    """Densify to ``f32[N, dim]`` (scatter-add; duplicate columns within a
    row would add, matching coordinate-list semantics)."""
    n, k = x.cols.shape
    out = jnp.zeros((n, x.dim), dtype=x.vals.dtype)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, k))
    return out.at[rows, x.cols].add(x.vals)


def ell_rows_to_svecs(x: EllMatrix, rows: Sequence[int]) -> list:
    """Unpack selected rows back into :class:`SVec` values (host-side)."""
    cols = np.asarray(x.cols)
    vals = np.asarray(x.vals)
    out = []
    for i in rows:
        mask = ~((cols[i] == 0) & (vals[i] == 0.0))
        idx = cols[i][mask].astype(np.int64)
        order = np.argsort(idx, kind="stable")
        out.append(SVec(x.dim, idx[order], vals[i][mask][order].astype(np.float64)))
    return out
