"""MurmurHash64A with the reference's fixed seed table.

Bit-exact port of ``Tools::murmur_hash64`` (/root/reference/tools.hpp:16-50):
the hash runs over the **ASCII byte string** of the k-mer (not its packed
bits), consuming little-endian 8-byte words then a 1-7 byte tail, with the
standard murmur64A mixing constants.  ``HASH_SEEDS`` is the reference's fixed
table of 128 primes (tools.hpp:9) — every Bloom filter and coupled bit array
derives its probe positions from these seeds, so hash parity here is the root
of all model parity.

Three implementations:
  * ``murmur64_py``  — scalar python ints, for golden tests / tiny inputs.
  * ``murmur64_np``  — batched NumPy over [N, len] ASCII byte arrays (host).
  * ``murmur64_jnp`` — batched jnp, jit-safe (device), on uint64 lanes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Reference HashSeeds table (tools.hpp:9): 128 consecutive primes.
HASH_SEEDS = np.array(
    [
        46757, 46769, 46771, 46807, 46811, 46817, 46819, 46829, 46831, 46853,
        46861, 46867, 46877, 46889, 46901, 46919, 46933, 46957, 46993, 46997,
        47017, 47041, 47051, 47057, 47059, 47087, 47093, 47111, 47119, 47123,
        47129, 47137, 47143, 47147, 47149, 47161, 47189, 47207, 47221, 47237,
        47251, 47269, 47279, 47287, 47293, 47297, 47303, 47309, 47317, 47339,
        47351, 47353, 47363, 47381, 47387, 47389, 47407, 47417, 47419, 47431,
        47441, 47459, 47491, 47497, 47501, 47507, 47513, 47521, 47527, 47533,
        47543, 47563, 47569, 47581, 47591, 47599, 47609, 47623, 47629, 47639,
        47653, 47657, 47659, 47681, 47699, 47701, 47711, 47713, 47717, 47737,
        47741, 47743, 47777, 47779, 47791, 47797, 47807, 47809, 47819, 47837,
        47843, 47857, 47869, 47881, 47903, 47911, 47917, 47933, 47939, 47947,
        47951, 47963, 47969, 47977, 47981, 48017, 48023, 48029, 48049, 48073,
        48079, 48091, 48109, 48119, 48121, 48131, 48157, 48163,
    ],
    dtype=np.uint64,
)

_M = 0xC6A4A7935BD1E995
_R = 47
_MASK = 0xFFFFFFFFFFFFFFFF


def murmur64_py(data: bytes, seed: int) -> int:
    """Scalar reference implementation over a raw byte string."""
    m, r = _M, _R
    n = len(data)
    h = (seed ^ ((n * m) & _MASK)) & _MASK
    nfull = n // 8
    for w in range(nfull):
        k = int.from_bytes(data[8 * w : 8 * w + 8], "little")
        k = (k * m) & _MASK
        k ^= k >> r
        k = (k * m) & _MASK
        h ^= k
        h = (h * m) & _MASK
    tail = data[8 * nfull :]
    if tail:
        t = int.from_bytes(tail, "little")
        h ^= t
        h = (h * m) & _MASK
    h ^= h >> r
    h = (h * m) & _MASK
    h ^= h >> r
    return h


def _mix_words(bytes_2d, n: int, seeds, xp):
    """Shared batched murmur body.

    bytes_2d: [..., n] uint8; seeds: scalar or broadcastable uint64 array.
    Returns uint64 [...] (broadcast of batch dims with seeds).
    """
    u = xp.uint64
    m = u(_M)
    r = u(_R)
    b = bytes_2d.astype(xp.uint64)
    h = xp.asarray(seeds, dtype=xp.uint64) ^ (u(n) * m)
    nfull = n // 8
    for w in range(nfull):
        k = u(0)
        for j in range(8):
            k = k | (b[..., 8 * w + j] << u(8 * j))
        k = k * m
        k = k ^ (k >> r)
        k = k * m
        h = h ^ k
        h = h * m
    ntail = n & 7
    if ntail:
        t = u(0)
        for j in range(ntail):
            t = t | (b[..., 8 * nfull + j] << u(8 * j))
        h = h ^ t
        h = h * m
    h = h ^ (h >> r)
    h = h * m
    h = h ^ (h >> r)
    return h


def murmur64_np(ascii_bytes: np.ndarray, seed) -> np.ndarray:
    """Batched host murmur: ascii_bytes [..., len] uint8, seed scalar/array."""
    n = ascii_bytes.shape[-1]
    with np.errstate(over="ignore"):
        return _mix_words(ascii_bytes, n, np.asarray(seed, dtype=np.uint64), np)


def murmur64_jnp(ascii_bytes: jnp.ndarray, seed) -> jnp.ndarray:
    """Batched device murmur (jit-safe). ascii_bytes [..., len] uint8."""
    n = ascii_bytes.shape[-1]
    return _mix_words(ascii_bytes, n, jnp.asarray(seed, dtype=jnp.uint64), jnp)


def murmur_pre_jnp(ascii_bytes: jnp.ndarray):
    """Seed-independent half of murmur64: per-8-byte-block mixes + assembled
    tail.  The block mix (k*=m; k^=k>>r; k*=m) never sees the seed, so for
    S seed evaluations of the same string (nh probes x n_bits arrays on the
    query path) it runs once instead of S times.

    ascii_bytes [..., n] uint8 -> (blocks [..., nfull] u64, tail [...] u64).
    """
    u = jnp.uint64
    m = u(_M)
    r = u(_R)
    n = ascii_bytes.shape[-1]
    b = ascii_bytes.astype(jnp.uint64)
    blocks = []
    for w in range(n // 8):
        k = u(0)
        for j in range(8):
            k = k | (b[..., 8 * w + j] << u(8 * j))
        k = k * m
        k = k ^ (k >> r)
        k = k * m
        blocks.append(k)
    blocks_arr = (
        jnp.stack(blocks, axis=-1)
        if blocks
        else jnp.zeros(ascii_bytes.shape[:-1] + (0,), dtype=jnp.uint64)
    )
    ntail = n & 7
    t = u(0)
    if ntail:
        t = jnp.zeros(ascii_bytes.shape[:-1], dtype=jnp.uint64)
        for j in range(ntail):
            t = t | (b[..., 8 * (n // 8) + j] << u(8 * j))
    else:
        t = jnp.zeros(ascii_bytes.shape[:-1], dtype=jnp.uint64)
    return blocks_arr, t


def murmur_eval_jnp(blocks: jnp.ndarray, tail: jnp.ndarray, n: int, seeds) -> jnp.ndarray:
    """Fold precomputed blocks under each seed: blocks [..., nfull], tail
    [...], seeds [S] -> hashes [..., S] (bit-identical to murmur64_jnp)."""
    u = jnp.uint64
    m = u(_M)
    r = u(_R)
    s = jnp.asarray(seeds, dtype=jnp.uint64)
    h = s ^ (u(n) * m)  # [S]
    h = jnp.broadcast_to(h, blocks.shape[:-1] + s.shape)
    for w in range(blocks.shape[-1]):
        h = (h ^ blocks[..., w][..., None]) * m
    if n & 7:
        h = (h ^ tail[..., None]) * m
    h = h ^ (h >> r)
    h = h * m
    h = h ^ (h >> r)
    return h
