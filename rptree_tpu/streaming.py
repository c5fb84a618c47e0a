"""Streaming (chunked-ingest) forest construction.

The reference builds incrementally from a conduit stream: chunks are folded
into the tree, re-partitioning each branch at the *chunk's* median and
refining thresholds by running average / margins by monoid merge
(``src/Data/RPTree/Conduit.hs:58-121``, ``Internal.hs:257-297``).  Its
documented contract (Conduit.hs:49-57): the source is non-empty,
*stationary*, and bounded -- the result is only produced at end-of-stream.

Design (SURVEY.md section 7, M5): the host input pipeline
accumulates device-resident chunks and the index is (re)built with the exact
level-synchronous builder at finalize time.  Under the stationarity
assumption this strictly dominates the reference's approximate
running-average medians -- thresholds are *exact* medians of all data seen
-- while the per-chunk work is just a host->device transfer.  The
reference's refine semantics (threshold drift, margin merge, max-depth
chunk-drop) are preserved verbatim in :mod:`rptree_tpu.reference` for
parity measurement; divergence is deliberate and documented here.

``periodic_rebuild_every`` trades build cost for queryability of the
partial index mid-stream (the reference's tree is also only *returned* at
end-of-stream, so this is an extension, not a parity gap).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Union

import numpy as np

from .config import ForestConfig
from .models.forest import RPForest, forest_batch

__all__ = ["ForestBuilder", "tree", "forest"]


class ForestBuilder:
    """Incremental forest construction (the reference's
    ``insert``/``insertMulti`` accumulation, ``Internal.hs:244-297``).

    Usage::

        b = ForestBuilder(seed, max_depth=10, min_leaf=20, n_trees=8,
                          pnz=0.5, dim=784)
        for chunk in source:       # chunk: [m, dim] numpy/jax array
            b.insert_chunk(chunk)
        index = b.build()
    """

    def __init__(self, seed, max_depth: int, min_leaf: int, n_trees: int,
                 pnz: float, dim: int, chunk_size: int = 0,
                 periodic_rebuild_every: int = 0, mesh=None,
                 data_parallel: bool = False, anytime_slack: int = 0):
        self.mesh = mesh
        self.data_parallel = bool(data_parallel) or mesh is not None
        # produce-anytime refinement (the reference refines thresholds as
        # chunks arrive, Internal.hs:280-285, but only RETURNS at end of
        # stream; anytime_slack > 0 goes further: a queryable partial
        # index absorbs every chunk ONLINE via RPForest.fold at
        # O(chunk x depth) cost -- no mid-stream rebuilds).  The final
        # build() is still the exact batch build over everything seen.
        self.anytime_slack = int(anytime_slack)
        self._anytime: Optional[RPForest] = None
        self.seed = seed
        self.max_depth = int(max_depth)
        self.min_leaf = int(min_leaf)
        self.n_trees = int(n_trees)
        self.pnz = float(pnz)
        self.dim = int(dim)
        self.chunk_size = int(chunk_size)
        self.periodic = int(periodic_rebuild_every)
        self._chunks: list = []
        self._payloads: list = []
        self._n = 0
        self._index: Optional[RPForest] = None
        self._chunks_since_rebuild = 0

    @property
    def n_points(self) -> int:
        return self._n

    @property
    def partial_index(self) -> Optional[RPForest]:
        """Anytime view of the stream (``anytime_slack > 0``): a
        queryable index reflecting every chunk inserted so far, updated
        online at O(chunk x depth) per chunk (folded into leaf slack
        slots; overflow stays in its exact pending merge).  The final
        :meth:`build` remains the exact batch build."""
        return self._anytime

    def _mesh_devices(self):
        import jax

        if self.mesh is not None:
            return list(self.mesh.devices.flatten())
        return jax.devices()

    def insert_chunk(self, chunk, payloads: Optional[Sequence] = None):
        """Fold one data chunk into the builder (reference ``insertC``,
        Conduit.hs:79-91).  Chunks are transferred to the device eagerly
        and asynchronously, overlapping host->device uploads with the
        source's own ingest work instead of paying one large transfer at
        finalize.  In data-parallel mode chunks are placed ROUND-ROBIN
        across the mesh's devices, so accumulation peak per device is
        O(N / S) -- the bounded-memory property of the reference's conduit
        pipeline (Conduit.hs:169-176), which the sharded finalize then
        consumes without ever assembling the dataset on one chip."""
        import jax

        c = np.asarray(chunk, dtype=np.float32)
        if c.ndim == 1:
            c = c[None, :]
        if c.shape[1] != self.dim:
            raise ValueError(f"chunk dim {c.shape[1]} != builder dim {self.dim}")
        if payloads is not None and len(payloads) != c.shape[0]:
            raise ValueError("payloads length != chunk length")
        try:
            if self.data_parallel:
                devs = self._mesh_devices()
                c = jax.device_put(c, devs[len(self._chunks) % len(devs)])
            else:
                c = jax.device_put(c)  # async; jnp.concatenate at build
        except Exception:
            pass  # keep the host copy if the device is unavailable
        self._chunks.append(c)
        self._payloads.append(list(payloads) if payloads is not None else None)
        self._n += c.shape[0]
        self._index = None
        self._chunks_since_rebuild += 1
        if self.anytime_slack:
            if self._anytime is None:
                # seed the partial index from the first chunk; slack slots
                # absorb later chunks without rebuild.  In data-parallel
                # mode the partial index is itself a DataParallelForest
                # with leaf-sharded slack blocks, so the anytime view
                # keeps the O(N/S)-per-device property and later chunks
                # fold through the sharded scatter.
                if self.data_parallel:
                    from .parallel.data_parallel import (
                        data_mesh,
                        forest_batch_data_parallel,
                    )

                    mesh = (self.mesh if self.mesh is not None
                            else data_mesh())
                    s = len(list(mesh.devices.flatten()))
                    if c.shape[0] % s:
                        raise ValueError(
                            f"anytime_slack with data_parallel needs the "
                            f"first chunk ({c.shape[0]} rows) to divide "
                            f"the {s} data shards"
                        )
                    self._anytime = forest_batch_data_parallel(
                        self.seed, self.max_depth, self.min_leaf,
                        self.n_trees, self.pnz, np.asarray(c), mesh=mesh,
                        payloads=(list(payloads) if payloads is not None
                                  else None),
                    )
                else:
                    self._anytime = forest_batch(
                        self.seed, self.max_depth, self.min_leaf,
                        self.n_trees, self.pnz, np.asarray(c),
                        payloads=(list(payloads) if payloads is not None
                                  else None),
                    )
                self._anytime.pack_leaves(slack=self.anytime_slack)
            else:
                self._anytime.add(np.asarray(c), payloads=payloads)
                self._anytime.fold()
        if self.periodic and self._chunks_since_rebuild >= self.periodic:
            self.build()

    def _all_payloads(self) -> Optional[list]:
        if all(p is None for p in self._payloads):
            return None
        out = []
        for c, p in zip(self._chunks, self._payloads):
            out.extend(p if p is not None else [None] * c.shape[0])
        return out

    def build(self) -> RPForest:
        """Finalize: exact level-synchronous rebuild over everything seen."""
        if self._n == 0:
            raise ValueError("streaming source was empty (the reference "
                             "requires a non-empty source, Conduit.hs:52)")
        if self._index is None:
            import jax.numpy as jnp

            if self.data_parallel:
                # sharded finalize: reassemble the round-robin-accumulated
                # chunks into the contiguous data-sharded layout CHUNK-WISE
                # (device-to-device slices; per-device peak stays O(N/S)
                # throughout -- its final 1/S block plus in-flight chunks),
                # preserving ingest-order ids exactly, then run the
                # distributed-median build on the sharded rows
                import jax
                from jax.sharding import NamedSharding, PartitionSpec as P

                from .parallel.data_parallel import (
                    DATA_AXIS,
                    data_mesh,
                    forest_batch_data_parallel,
                )

                mesh = self.mesh if self.mesh is not None else data_mesh()
                devs = list(mesh.devices.flatten())
                s = len(devs)
                n = self._n
                if n % s:
                    raise ValueError(
                        f"streamed rows ({n}) must divide the "
                        f"data-shard count ({s}) for the sharded finalize"
                    )
                per = n // s
                parts: list = [[] for _ in range(s)]
                off = 0
                for c in self._chunks:
                    c = jnp.asarray(c)
                    m = c.shape[0]
                    a = off
                    while a < off + m:
                        d = min(a // per, s - 1)
                        e = min(off + m, (d + 1) * per)
                        parts[d].append(
                            jax.device_put(c[a - off:e - off], devs[d])
                        )
                        a = e
                    off += m
                blocks = [
                    bl[0] if len(bl) == 1 else jnp.concatenate(bl, axis=0)
                    for bl in parts
                ]
                xs = jax.make_array_from_single_device_arrays(
                    (n, self.dim),
                    NamedSharding(mesh, P(DATA_AXIS)),
                    blocks,
                )
                self._index = forest_batch_data_parallel(
                    self.seed, self.max_depth, self.min_leaf, self.n_trees,
                    self.pnz, xs, mesh=mesh,
                )
                if self._all_payloads() is not None:
                    self._index.payloads = self._all_payloads()
            else:
                x = jnp.concatenate(
                    [jnp.asarray(c) for c in self._chunks], axis=0
                )
                self._index = forest_batch(
                    self.seed, self.max_depth, self.min_leaf, self.n_trees,
                    self.pnz, x, payloads=self._all_payloads(),
                )
            object.__setattr__(
                self._index, "config",
                ForestConfig(n_trees=self.n_trees, max_depth=self.max_depth,
                             min_leaf=self.min_leaf, proj_nz_density=self.pnz,
                             dim=self.dim, chunk_size=self.chunk_size),
            )
            self._chunks_since_rebuild = 0
        return self._index


def _drive(builder: ForestBuilder, source: Union[Iterable, Iterator],
           chunk_size: int) -> RPForest:
    """Feed a source of rows or chunks through the builder, re-chunking
    single rows to ``chunk_size`` (semantics of ``chunksOf``,
    Conduit.hs:174)."""
    buf: list = []
    for item in source:
        a = np.asarray(item, dtype=np.float32)
        if a.ndim == 2:
            builder.insert_chunk(a)
        else:
            buf.append(a)
            if len(buf) >= chunk_size:
                builder.insert_chunk(np.stack(buf))
                buf = []
    if buf:
        builder.insert_chunk(np.stack(buf))
    return builder.build()


def tree(seed, max_depth: int, min_leaf: int, chunk_size: int, pnz: float,
         dim: int, source) -> RPForest:
    """Populate a single tree from a data stream (reference ``tree``,
    Conduit.hs:58-72).  ``source`` yields rows ``[dim]`` or chunks
    ``[m, dim]``."""
    b = ForestBuilder(seed, max_depth, min_leaf, 1, pnz, dim,
                      chunk_size=chunk_size)
    return _drive(b, source, chunk_size)


def forest(seed, max_depth: int, min_leaf: int, n_trees: int,
           chunk_size: int, pnz: float, dim: int, source) -> RPForest:
    """Populate a forest from a data stream (reference ``forest``,
    Conduit.hs:104-121)."""
    b = ForestBuilder(seed, max_depth, min_leaf, n_trees, pnz, dim,
                      chunk_size=chunk_size)
    return _drive(b, source, chunk_size)
