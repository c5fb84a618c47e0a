"""Index serialization / checkpointing.

The reference CBOR-serialises whole trees (including the points stored at
the leaves) via the ``serialise`` package, one lazy ByteString per tree with
undefined order (``src/Data/RPTree/Internal.hs:185-196``).  This engine's
index is array-structured, so checkpoints are npz archives: projections,
per-level thresholds/margins, permutations, the dataset, and a JSON header
with the static plan parameters (SURVEY.md section 5, checkpoint/resume).

Two surfaces:

* :func:`save_forest` / :func:`load_forest` -- one file for the whole
  forest (recommended; the dataset is stored once).
* :func:`serialise_rp_forest` / :func:`deserialise_rp_forest` -- API parity
  with the reference: a list of standalone per-tree blobs, each of which
  (like the reference's) embeds the leaf data, and whose order does not
  matter for restore.  Restore re-keys trees 0..T-1 (Internal.hs:191-196).
"""

from __future__ import annotations

import io
import json
import pickle
from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..config import ForestConfig
from ..models.forest import RPForest
from ..models.plan import make_plan
from ..ops.build import TreeArrays
from ..ops.sparse import EllMatrix, ell_sq_norms

__all__ = ["save_forest", "load_forest", "serialise_rp_forest",
           "deserialise_rp_forest", "save_forest_sharded",
           "load_forest_sharded"]

_FORMAT_VERSION = 1


def _check_clean(forest: RPForest):
    if (getattr(forest, "_pending", None) or getattr(forest, "n_deleted", 0)
            or getattr(forest, "n_folded", 0)):
        raise ValueError(
            "forest has pending inserts or tombstoned deletions; call "
            "rebuild() before serialising so the checkpoint is complete"
        )


def _header(forest: RPForest) -> dict:
    h = {
        "format_version": _FORMAT_VERSION,
        "n": forest.plan.n,
        "max_depth": forest.plan.max_depth,
        "min_leaf": forest.plan.min_leaf,
        "n_levels": forest.plan.n_levels,
        "n_trees": forest.n_trees,
        "dim": forest.dim,
        "sparse": isinstance(forest.x, EllMatrix),
        "config": {
            "n_trees": forest.config.n_trees,
            "max_depth": forest.config.max_depth,
            "min_leaf": forest.config.min_leaf,
            "proj_nz_density": forest.config.proj_nz_density,
            "dim": forest.config.dim,
            "chunk_size": forest.config.chunk_size,
            "dtype": forest.config.dtype,
        },
        "seed": forest.seed if isinstance(forest.seed, int) else None,
    }
    # learned grouped tile capacities (knn_grouped auto-sizing), tagged
    # with the pack-layout signature they were learned under: a restored
    # server can serve check=False immediately without re-walking the
    # auto-capacity ladder, but only if it repacks the SAME layout
    caps = getattr(forest, "_grouped_nt", None)
    if caps:
        from ..models.forest import _pack_sig

        sig = _pack_sig(forest)
        if sig is not None:
            h["grouped_nt"] = {
                "pack": sig,
                "caps": {",".join(str(int(v)) for v in k): int(cap)
                         for k, cap in caps.items()},
            }
    return h


def _pack(forest: RPForest, tree: Optional[int] = None) -> dict:
    """Collect arrays into a flat dict for npz.  ``tree=None`` packs the
    whole forest; an int packs a single tree's slice."""
    sel = slice(None) if tree is None else slice(tree, tree + 1)
    arrs = {
        "r": np.asarray(forest.arrays.r[sel]),
        "perm": np.asarray(forest.arrays.perm[sel]),
        "thr": np.asarray(forest.arrays.thr[sel]),
        "mgl": np.asarray(forest.arrays.mgl[sel]),
        "mgh": np.asarray(forest.arrays.mgh[sel]),
    }
    if isinstance(forest.x, EllMatrix):
        arrs["x_cols"] = np.asarray(forest.x.cols)
        arrs["x_vals"] = np.asarray(forest.x.vals)
    else:
        arrs["x"] = np.asarray(forest.x)
    if forest.payloads is not None:
        arrs["payloads"] = np.frombuffer(
            pickle.dumps(list(forest.payloads)), dtype=np.uint8
        )
    return arrs


def _unpack(header: dict, z) -> RPForest:
    plan = make_plan(header["n"], header["max_depth"], header["min_leaf"])
    if plan.n_levels != header["n_levels"]:
        raise ValueError("checkpoint plan mismatch: "
                         f"{plan.n_levels} != {header['n_levels']}")
    arrays = TreeArrays(
        r=jnp.asarray(z["r"]),
        thr=jnp.asarray(z["thr"]),
        mgl=jnp.asarray(z["mgl"]),
        mgh=jnp.asarray(z["mgh"]),
        perm=jnp.asarray(z["perm"]),
    )
    if header["sparse"]:
        x = EllMatrix(header["dim"], jnp.asarray(z["x_cols"]),
                      jnp.asarray(z["x_vals"]))
        sq = ell_sq_norms(x)
    else:
        x = jnp.asarray(z["x"])
        sq = jnp.sum(x * x, axis=-1)
    payloads = None
    if "payloads" in z:
        payloads = pickle.loads(z["payloads"].tobytes())
    cfg = ForestConfig(**header["config"])
    f = RPForest(plan, arrays, x, sq, cfg, payloads=payloads,
                 seed=header.get("seed"))
    if "grouped_nt" in header:
        # installed lazily by _grouped_auto_capacity once the forest is
        # packed with the matching layout
        f._grouped_nt_saved = header["grouped_nt"]
    return f


def save_forest(path: str, forest: RPForest) -> None:
    """Save the whole forest index (arrays + dataset + payloads) to one
    npz file with a JSON header."""
    _check_clean(forest)
    arrs = _pack(forest)
    arrs["header"] = np.frombuffer(
        json.dumps(_header(forest)).encode(), dtype=np.uint8
    )
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrs)


def load_forest(path: str) -> RPForest:
    """Restore a forest saved by :func:`save_forest`.

    Note: payloads (if present) are unpickled -- only load checkpoints you
    trust."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(z["header"].tobytes().decode())
        return _unpack(header, {k: z[k] for k in z.files})


def serialise_rp_forest(forest: RPForest) -> List[bytes]:
    """One standalone blob per tree (reference ``serialiseRPForest``,
    Internal.hs:185-188).  Each blob embeds the dataset, mirroring the
    reference where leaf data lives inside every serialized tree; prefer
    :func:`save_forest` to store the dataset once."""
    _check_clean(forest)
    out = []
    for t in range(forest.n_trees):
        header = _header(forest)
        header["n_trees"] = 1
        arrs = _pack(forest, tree=t)
        arrs["header"] = np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8
        )
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrs)
        out.append(buf.getvalue())
    return out


def deserialise_rp_forest(blobs: Sequence[bytes]) -> RPForest:
    """Reassemble a forest from per-tree blobs in any order (reference
    ``deserialiseRPForest``, Internal.hs:191-196: trees are re-keyed
    ``[0..]``).  Raises ``ValueError`` on malformed or inconsistent blobs
    (the reference's ``Either String`` surface)."""
    if not blobs:
        raise ValueError("no blobs to deserialise")
    headers = []
    parts = []
    for blob in blobs:
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                data = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 - surface as Either-String parity
            raise ValueError(f"deserialise failed: {e}") from e
        headers.append(json.loads(data["header"].tobytes().decode()))
        parts.append(data)
    h0 = headers[0]
    for h in headers[1:]:
        if (h["n"], h["max_depth"], h["min_leaf"], h["dim"], h["sparse"]) != (
            h0["n"], h0["max_depth"], h0["min_leaf"], h0["dim"], h0["sparse"]
        ):
            raise ValueError("inconsistent tree blobs")
    merged = {
        k: np.concatenate([p[k] for p in parts])
        for k in ("r", "perm", "thr", "mgl", "mgh")
    }
    for k in ("x", "x_cols", "x_vals", "payloads"):
        if k in parts[0]:
            merged[k] = parts[0][k]
    h0 = dict(h0)
    h0["n_trees"] = len(parts)
    cfg = dict(h0["config"])
    cfg["n_trees"] = len(parts)
    h0["config"] = cfg
    return _unpack(h0, merged)


# ---------------------------------------------------------------------------
# sharded checkpoints (per-shard blobs; no full-dataset host buffer)
# ---------------------------------------------------------------------------

def save_forest_sharded(dirpath: str, forest) -> None:
    """Checkpoint a sharded forest as one npz PER DATA SHARD plus a small
    common file -- the host only ever buffers one shard's rows at a time
    (``save_forest`` would ``np.asarray`` the full dataset, defeating the
    point of building data-parallel because it exceeds one device).
    Payloads are stored pickled; restoring unpickles them, so only load
    checkpoints you trust (see :func:`load_forest_sharded`).

    Layout: ``<dirpath>/common.npz`` (header + replicated structure
    arrays) and ``<dirpath>/shard_<i>.npz`` (that shard's dataset rows and
    their global row offset).  Restore with :func:`load_forest_sharded`.
    Reference analogue: per-tree standalone blobs,
    ``serialiseRPForest`` (Internal.hs:185-196) -- here the unit of
    independence is the data shard instead of the tree.

    Supported: :class:`~rptree_tpu.parallel.data_parallel.DataParallelForest`
    (dense or ELL rows).  Tree-sharded :class:`DistributedForest` restores
    via ``distribute(load_forest(...))`` instead (its dataset is
    replicated, so the one-file form is already per-device-sized).
    """
    import os

    from ..parallel.data_parallel import DATA_AXIS, DataParallelForest

    if not isinstance(forest, DataParallelForest):
        raise ValueError(
            "save_forest_sharded checkpoints DataParallelForest; use "
            "save_forest (+ distribute() on restore) for other forests"
        )
    _check_clean(forest)
    if forest.x is None:
        raise ValueError("dataset dropped (drop_dataset); sharded "
                         "checkpoints store the sharded rows")
    os.makedirs(dirpath, exist_ok=True)
    header = _header(forest)
    header["kind"] = "data_parallel"
    header["n_shards"] = int(forest.mesh.shape[DATA_AXIS])
    common = {
        "r": np.asarray(forest.arrays.r),
        "perm": np.asarray(forest.arrays.perm),
        "thr": np.asarray(forest.arrays.thr),
        "mgl": np.asarray(forest.arrays.mgl),
        "mgh": np.asarray(forest.arrays.mgh),
        "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
    }
    if forest.payloads is not None:
        common["payloads"] = np.frombuffer(
            pickle.dumps(list(forest.payloads)), dtype=np.uint8
        )
    with open(os.path.join(dirpath, "common.npz"), "wb") as fh:
        np.savez_compressed(fh, **common)

    sparse = isinstance(forest.x, EllMatrix)
    shards = (forest.x.cols if sparse else forest.x).addressable_shards
    by_dev = {}
    for s in shards:
        start = s.index[0].start or 0
        by_dev[start] = s
    for i, start in enumerate(sorted(by_dev)):
        s = by_dev[start]
        arrs = {"row_start": np.asarray([start], np.int64)}
        if sparse:
            arrs["x_cols"] = np.asarray(s.data)
            # find the matching vals shard by row range
            for sv in forest.x.vals.addressable_shards:
                if (sv.index[0].start or 0) == start:
                    arrs["x_vals"] = np.asarray(sv.data)
                    break
        else:
            arrs["x"] = np.asarray(s.data)
        with open(os.path.join(dirpath, f"shard_{i}.npz"), "wb") as fh:
            np.savez_compressed(fh, **arrs)


def load_forest_sharded(dirpath: str, mesh=None):
    """Restore a :func:`save_forest_sharded` checkpoint directly into a
    :class:`DataParallelForest`: each shard file is uploaded straight to
    its device (resharding to the target mesh's shard count if it
    differs), so no host or device buffer ever holds the full dataset.

    Note: payloads (if present) are unpickled -- only load checkpoints
    you trust (same caveat as :func:`load_forest`).
    """
    import os

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..config import ForestConfig
    from ..parallel.data_parallel import (
        DATA_AXIS,
        DataParallelForest,
        _sq_norms_sharded,
        data_mesh,
    )

    with np.load(os.path.join(dirpath, "common.npz"),
                 allow_pickle=False) as z:
        header = json.loads(z["header"].tobytes().decode())
        common = {k: z[k] for k in z.files}
    if header.get("kind") != "data_parallel":
        raise ValueError("not a sharded checkpoint (kind != data_parallel)")
    if mesh is None:
        mesh = data_mesh()
    devs = list(mesh.devices.flatten())
    n_sh_files = header["n_shards"]
    n = header["n"]
    if n % len(devs):
        raise ValueError(f"checkpoint rows ({n}) do not divide the "
                         f"target mesh ({len(devs)} shards)")
    per = n // len(devs)
    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def assemble(key2, dtype, width):
        """Stream shard files into per-device blocks: rows are re-chunked
        to the target mesh's contiguous N/S blocks device by device."""
        blocks = [[] for _ in devs]
        for i in range(n_sh_files):
            with np.load(os.path.join(dirpath, f"shard_{i}.npz"),
                         allow_pickle=False) as z:
                start = int(z["row_start"][0])
                rows = z[key2]
            a = start
            while a < start + rows.shape[0]:
                d = min(a // per, len(devs) - 1)
                e = min(start + rows.shape[0], (d + 1) * per)
                blocks[d].append(
                    jax.device_put(
                        np.ascontiguousarray(rows[a - start:e - start]),
                        devs[d])
                )
                a = e
        parts = [
            bl[0] if len(bl) == 1 else jnp.concatenate(bl, axis=0)
            for bl in blocks
        ]
        return jax.make_array_from_single_device_arrays(
            (n, width), sharding, parts
        )

    plan = make_plan(n, header["max_depth"], header["min_leaf"])
    arrays = TreeArrays(
        r=jnp.asarray(common["r"]),
        thr=jnp.asarray(common["thr"]),
        mgl=jnp.asarray(common["mgl"]),
        mgh=jnp.asarray(common["mgh"]),
        perm=jnp.asarray(common["perm"]),
    )
    if header["sparse"]:
        with np.load(os.path.join(dirpath, "shard_0.npz"),
                     allow_pickle=False) as z0:
            kz = z0["x_cols"].shape[1]
        x = EllMatrix(header["dim"], assemble("x_cols", np.int32, kz),
                      assemble("x_vals", np.float32, kz))
    else:
        x = assemble("x", np.float32, header["dim"])
    sq = _sq_norms_sharded(x)
    payloads = None
    if "payloads" in common:
        payloads = pickle.loads(common["payloads"].tobytes())
    cfg = ForestConfig(**header["config"])
    f = DataParallelForest(plan, arrays, x, sq, cfg, mesh,
                           payloads=payloads, seed=header.get("seed"))
    if "grouped_nt" in header:
        f._grouped_nt_saved = header["grouped_nt"]
    return f
