"""Shared-row serving layout: one copy of the dataset, per-tree id blocks.

The standard leaf-blocked pack (:meth:`RPForest.pack_leaves`) stores each
tree's leaves as CONTIGUOUS row blocks -- T full copies of the dataset in
device memory, bought for contiguous block fetches (one index per block
instead of one per row).  At T=8 trees over 10M f32 x 128-d points that
is ~41 GB while the dataset itself is 5 GB.

``pack_leaves(store="shared")`` keeps ONE shared row store (the dataset
array itself, no copy) and packs only the per-block slot -> point-id
tables (int32, ~``T/D``-th the block bytes).  Serving fetches a probed
block by gathering its ``lmax`` ROWS by id instead of one contiguous
block -- ``lmax``x more gather indices, a slower fetch stage -- in
exchange for ``T``x less index memory: the memory-bounded regime
(datasets near device-memory capacity) where the blocked layout
cannot exist at all.  Reference analogue: the reference's single
``RPForest`` over one vector store with per-tree leaf id sets
(``src/Data/RPTree/Internal.hs:236-255``); the blocked-vs-shared split is
a device memory/bandwidth trade with no reference counterpart.

Exact by construction: the scored rows are the SAME f32 rows the dataset
holds, so results are bit-identical to an unquantized blocked pack
(pinned in ``tests/test_shared_rows.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["SharedRows", "fetch_blocks"]


@jax.tree_util.register_pytree_node_class
class SharedRows:
    """Shared-row stand-in for the dense ``x_leaf`` block array: ``rows
    f32/bf16[N, D]`` (one copy of the dataset) + ``ids int32[G, lmax]``
    (per-block slot -> point id, -1 padding).  Exposes the blocked
    array's ``shape``/``dtype`` so the serving paths' masking, precision
    and capacity logic is layout-blind; only the block FETCH dispatches
    (:func:`fetch_blocks`).  Deliberately has no ``ndim``: the fused tile
    kernels need resident contiguous blocks and gate on it
    (``grouped_kernel_ok``)."""

    def __init__(self, rows, ids):
        self.rows = rows
        self.ids = ids

    @property
    def shape(self):
        g, lmax = self.ids.shape
        return (g, lmax, self.rows.shape[-1])

    @property
    def dtype(self):
        return self.rows.dtype

    def tree_flatten(self):
        return (self.rows, self.ids), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def fetch_blocks(x_leaf, idx):
    """Gather leaf blocks ``[..., lmax, D]`` at block indices ``idx
    int32[...]``: one contiguous block gather on the blocked layout, an
    id-table gather + per-row gather on :class:`SharedRows` (padding
    slots read row 0 -- garbage that every caller masks by occupancy,
    exactly as blocked padding slots hold zeros)."""
    if isinstance(x_leaf, SharedRows):
        ids = jnp.take(x_leaf.ids, idx, axis=0)
        return jnp.take(x_leaf.rows, jnp.clip(ids, 0, None), axis=0)
    return jnp.take(x_leaf, idx, axis=0)
