"""Random generation: projection sampling, synthetic datasets, reservoir
sampling (the reference's L1 layer, ``src/Data/RPTree/Gen.hs``).

The reference threads a ``splitmix`` counter-based PRNG through a ``Gen``
state monad so everything is a pure function of one ``Word64`` seed
(``Gen.hs:13``, ``Batch.hs:15``).  The equivalent here is
``jax.random``'s counter-based threefry keys with ``fold_in`` discipline:
the projection matrix for (tree t, level l) comes from
``fold_in(fold_in(key, t), l)``, giving the same "reproducible from one
seed, order-independent" property without any sequential state.
"""

from __future__ import annotations

import functools
import secrets
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "rand_seed",
    "key_from_seed",
    "sample_projections",
    "sparse",
    "dense",
    "normal2",
    "normal_dense2",
    "normal_sparse2",
    "circle2d",
    "circle2d2",
    "mixture",
    "mixture2",
    "data_batch",
    "clustered_mixture",
    "data_source",
    "sample_wor",
]


def rand_seed() -> int:
    """Fresh random seed from OS entropy (reference ``randSeed``,
    ``src/Data/RPTree/Internal/Testing.hs:33-34``)."""
    return secrets.randbits(63)


def key_from_seed(seed) -> jax.Array:
    """uint64 seed -> jax PRNG key."""
    if isinstance(seed, (int, np.integer)):
        return jax.random.PRNGKey(seed & 0x7FFFFFFFFFFFFFFF)
    return seed  # already a key


def sample_projections(seed, n_trees: int, depth: int, dim: int, pnz: float,
                       dtype=jnp.float32) -> jax.Array:
    """Sample the forest's projection tensor ``R: [n_trees, depth, dim]``.

    Semantics of the reference's per-(tree, level) sparse Gaussian vectors
    (``Batch.hs:39,59-60``: Bernoulli(pnz) support mask, N(0,1) components,
    ``Gen.hs:148-195``), materialized dense: zeros where the mask is off.
    Keys are folded in per (tree, level) so any sub-slice is reproducible
    independently of sampling order.
    """
    key = key_from_seed(seed)
    kv, km = jax.random.split(key)
    vals = jax.random.normal(kv, (n_trees, depth, dim), dtype=jnp.float32)
    if pnz >= 1.0:
        r = vals
    else:
        mask = jax.random.bernoulli(km, pnz, (n_trees, depth, dim))
        r = jnp.where(mask, vals, 0.0)
    return r.astype(dtype)


# ---------------------------------------------------------------------------
# synthetic data generators (reference Gen.hs:100-195)
#
# Each generator has signature gen(key, n) -> array [n, d]; `data_batch` /
# `data_source` drive them.  Distributions match the reference's mixtures.
# ---------------------------------------------------------------------------

def dense(key, n: int, dim: int, mu: float = 0.0, sigma: float = 1.0,
          sampler: Callable = None) -> jax.Array:
    """Dense random vectors (reference ``dense``/``denseVG``,
    Gen.hs:156-175).  Components are N(mu, sigma) by default; a
    ``sampler(key, shape) -> array`` callable overrides the component
    distribution entirely (the reference's caller-supplied sampler
    argument -- ``dense dim stdUniform`` etc.), ignoring mu/sigma."""
    if sampler is not None:
        return sampler(key, (n, dim))
    return mu + sigma * jax.random.normal(key, (n, dim))


def sparse(key, n: int, dim: int, pnz: float, mu: float = 0.0,
           sigma: float = 1.0, sampler: Callable = None) -> jax.Array:
    """Sparse random vectors with Bernoulli(pnz) support, materialized
    dense (reference ``sparse``/``sparseVG``, Gen.hs:148-195).  As with
    :func:`dense`, ``sampler(key, shape)`` substitutes any component
    distribution for the default N(mu, sigma) -- the reference's
    ``sparse pnz dim <sampler>`` extension point."""
    kv, km = jax.random.split(key)
    if sampler is not None:
        vals = sampler(kv, (n, dim))
    else:
        vals = mu + sigma * jax.random.normal(kv, (n, dim))
    mask = jax.random.bernoulli(km, pnz, (n, dim))
    return jnp.where(mask, vals, 0.0)


def mixture(gens, probs=None) -> Callable:
    """N-component mixture: per-vector categorical choice between
    generators (reference ``mixtureN``, Gen.hs:102-108).  ``probs``
    defaults to uniform."""
    gens = list(gens)
    if probs is None:
        probs = [1.0 / len(gens)] * len(gens)
    p = jnp.asarray(probs, dtype=jnp.float32)

    def gen(key, n: int) -> jax.Array:
        ks = jax.random.split(key, len(gens) + 1)
        choice = jax.random.categorical(ks[0], jnp.log(p), shape=(n,))
        outs = jnp.stack([g(k, n) for g, k in zip(gens, ks[1:])])
        return jnp.take_along_axis(
            outs, choice[None, :, None].astype(jnp.int32), axis=0
        )[0]

    return gen


def mixture2(gen_a: Callable, gen_b: Callable, p: float = 0.5) -> Callable:
    """Binary mixture: per-vector Bernoulli(p) choice between two generators
    (reference ``mixtureN`` specialization, Gen.hs:102-113)."""

    def gen(key, n: int) -> jax.Array:
        kb, ka, kbb = jax.random.split(key, 3)
        choose_a = jax.random.bernoulli(kb, p, (n,))
        xa = gen_a(ka, n)
        xb = gen_b(kbb, n)
        return jnp.where(choose_a[:, None], xa, xb)

    return gen


def normal2(key, n: int) -> jax.Array:
    """2-D binary Gaussian mixture: N(0, 0.5) vs N(2, 0.5) per vector
    (reference ``normal2``, Gen.hs:139-144)."""
    return mixture2(
        lambda k, m: dense(k, m, 2, 0.0, 0.5),
        lambda k, m: dense(k, m, 2, 2.0, 0.5),
    )(key, n)


def normal_dense2(key, n: int, dim: int) -> jax.Array:
    """d-dim binary Gaussian mixture (reference ``normalDense2``, Gen.hs:132-137)."""
    return mixture2(
        lambda k, m: dense(k, m, dim, 0.0, 0.5),
        lambda k, m: dense(k, m, dim, 2.0, 0.5),
    )(key, n)


def normal_sparse2(key, n: int, dim: int, pnz: float) -> jax.Array:
    """Sparse binary Gaussian mixture (reference ``normalSparse2``,
    Gen.hs:125-130), materialized dense."""
    return mixture2(
        lambda k, m: sparse(k, m, dim, pnz, 0.0, 0.5),
        lambda k, m: sparse(k, m, dim, pnz, 2.0, 0.5),
    )(key, n)


def circle2d(key, n: int, r: float = 1.0) -> jax.Array:
    """Uniform points on the disk of radius ``r`` (reference ``circle2d``,
    Gen.hs:115-123, which rejection-samples; here polar sampling -- same
    distribution at r=1, and exact for any r: the reference's accept test
    uses ``x^2+y^2 <= r`` rather than ``r^2``, a quirk not reproduced)."""
    ku, ka = jax.random.split(key)
    rad = r * jnp.sqrt(jax.random.uniform(ku, (n,)))
    ang = 2.0 * jnp.pi * jax.random.uniform(ka, (n,))
    return jnp.stack([rad * jnp.cos(ang), rad * jnp.sin(ang)], axis=-1)


def circle2d2(key, n: int) -> jax.Array:
    """Binary mixture of two unit disks centered (0,0) and (2,3) -- the
    reference test-suite dataset (``test/Data/RPTreeSpec.hs:112-120``)."""
    return mixture2(
        lambda k, m: circle2d(k, m, 1.0),
        lambda k, m: circle2d(k, m, 1.0) + jnp.asarray([2.0, 3.0]),
    )(key, n)


def data_batch(seed, n: int, gen: Callable) -> jax.Array:
    """Sample a full batch dataset (reference ``dataBatch``, Batch.hs:66-75)."""
    return gen(key_from_seed(seed), n)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def clustered_mixture(key, n: int, centers: int, dim: int, sigma: float,
                      n_queries: int):
    """Device-side Gaussian mixture (the reference's bench data family,
    ``Internal/Testing.hs:38-50``): ``centers`` unit-Gaussian centres,
    ``n`` points at N(centre, sigma), and ``n_queries`` queries perturbed
    from random data points by sigma/2.  Returns ``(x f32[n, dim], q
    f32[n_queries, dim])``, generated on the device from ``key``."""
    kc, ka, kn, kq, kp = jax.random.split(key, 5)
    cen = jax.random.normal(kc, (centers, dim), jnp.float32)
    assign = jax.random.randint(ka, (n,), 0, centers)
    x = (jnp.take(cen, assign, axis=0)
         + sigma * jax.random.normal(kn, (n, dim), jnp.float32))
    qi = jax.random.randint(kq, (n_queries,), 0, n)
    q = (jnp.take(x, qi, axis=0)
         + 0.5 * sigma * jax.random.normal(kp, (n_queries, dim),
                                           jnp.float32))
    return x, q


def data_source(seed, n: int, chunk_size: int, gen: Callable) -> Iterator[np.ndarray]:
    """Chunked stream of random data points (reference ``dataSource``,
    Conduit.hs:179-188, chunked per ``chunkedAccum`` Conduit.hs:169-176).

    Yields numpy chunks of ``chunk_size`` rows (last chunk may be short) --
    the host input pipeline feeding the streaming builder.
    """
    key = key_from_seed(seed)
    off = 0
    while off < n:
        m = min(chunk_size, n - off)
        key, sub = jax.random.split(key)
        yield np.asarray(gen(sub, m))
        off += m


def sample_wor(seed, k: int, xs) -> list:
    """Sample ``k`` items without replacement in one pass (reservoir
    sampling; the reference implements Algorithm L, Gen.hs:29-92).  Works on
    any iterable; returns a list of at most ``k`` items."""
    rng = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF if isinstance(seed, int) else seed)
    reservoir = []
    w = 1.0
    next_i = None
    for i, x in enumerate(xs):
        if len(reservoir) < k:
            reservoir.append(x)
            if len(reservoir) == k:
                w = float(np.exp(np.log(rng.random()) / k))
                next_i = i + int(np.floor(np.log(rng.random()) / np.log1p(-w))) + 1
        elif i == next_i:
            reservoir[rng.integers(0, k)] = x
            w *= float(np.exp(np.log(rng.random()) / k))
            next_i = i + int(np.floor(np.log(rng.random()) / np.log1p(-w))) + 1
    return reservoir
