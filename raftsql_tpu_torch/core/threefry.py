"""Threefry-2x32 draws, bit for bit those of the JAX package's
`jax.random` calls, in plain numpy.

The JAX package draws its boot state (election timeouts and the jitter
key, core/state.py init_peer_state) and the chaos harness's random
drops (transport/faults.py random_drop) with `jax.random` on the
default threefry PRNG, in its partitionable form (`split` is fold-like
and `random_bits` counts with a 64-bit iota split into two 32-bit
words).  This module recomputes those draws on the host so a port node
booted with `seed=s` is the JAX package's node booted with `seed=s`,
on the CPU and on the card alike.

Keys are uint32 arrays of shape [2] (the raw `PRNGKey` layout).  All
arithmetic is uint32 with wraparound, as XLA computes it.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds over counter words (x0, x1) of one
    shape; returns the two output words."""
    k0, k1 = (U32(int(k)) for k in np.asarray(key, np.uint32).reshape(2))
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    x = [np.array(x0, np.uint32, ndmin=1), np.array(x1, np.uint32, ndmin=1)]
    shape = np.shape(x0)
    with np.errstate(over="ignore"):
        x[0] = x[0] + ks[0]
        x[1] = x[1] + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + U32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with 64-bit ints off: the seed is
    taken as int32, so the high word is 0 and the low word is the
    seed's 32-bit pattern."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in`: threefry of the key over counter (0, data)."""
    a, b = threefry2x32(key, [0], [int(data) & 0xFFFFFFFF])
    return np.concatenate([a, b])


def _iota_2x32(shape) -> tuple:
    """The row-major flat index of every element as 64 bits, split into
    (high, low) uint32 words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split`, fold-like: key i is threefry over counter
    (0, i).  Returns [num, 2] uint32."""
    hi, lo = _iota_2x32((num,))
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=1)


def random_bits32(key, shape) -> np.ndarray:
    """32 random bits per element: the two threefry words over the
    element's flat-index counter, xored."""
    shape = tuple(shape)
    hi, lo = _iota_2x32(shape)
    a, b = threefry2x32(key, hi, lo)
    return a ^ b


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval, dtype=int32)` for
    int32 bounds: two draws of 32 bits, combined by a multiply-remainder
    in uint32 arithmetic (wrapping, as XLA's uint32 ops do)."""
    k1, k2 = split(key)
    hi = random_bits32(k1, shape)
    lo = random_bits32(k2, shape)
    span = U32((int(maxval) - int(minval)) & 0xFFFFFFFF) \
        if maxval > minval else U32(1)
    with np.errstate(over="ignore"):
        mult = U32(2 ** 16) % span
        mult = U32((int(mult) * int(mult)) & 0xFFFFFFFF) % span
        off = (hi % span) * mult + lo % span
        off = off % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key, shape) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32)` in [0, 1): the top 23
    random bits as a mantissa under exponent 0, minus 1."""
    bits = random_bits32(key, shape)
    f = ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return np.maximum(np.float32(0.0), f)


def bernoulli(key, p: float, shape) -> np.ndarray:
    """`jax.random.bernoulli(key, p, shape)` for a Python float p (taken
    as float32): uniform < p."""
    return uniform(key, shape) < np.float32(p)
