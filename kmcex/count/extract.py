"""Device k-mer extraction: code batches -> canonical packed k-mers.

The XLA formulation of the reference's per-read window walk: for a
[B, L] batch of 2-bit codes, all L-k+1 windows are packed with a static
k-step shift ladder (each step a full [B, W] vector op), invalid windows are
masked via a cumulative-sum-of-invalid trick, and canonicalization is the
bit-parallel reverse complement from core.codec.  Everything is static-shape
and jit-compiled once per (L, k).

Cites: window walk kmc_file.cpp:991-1133 (GetCountersForRead), canonical
min tools.hpp:146-167.

Sorting and compaction below are plain ``lax.sort`` calls; on the GPU XLA
lowers both the key sort and the (key, payload) sort to CUB's radix sort.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from kmcex.core import codec

SENTINEL = jnp.uint64(0xFFFFFFFFFFFFFFFF)


def _extract_core(codes: jnp.ndarray, invalid: jnp.ndarray, k: int):
    """codes [B, L] uint8 in 0..3, invalid [B, L] bool -> (kmers [B*W]
    canonical u64 with SENTINEL at invalid windows, n_valid)."""
    B, L = codes.shape
    W = L - k + 1
    # prefix sums of invalid counts -> window validity in O(1) per window
    csum = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.cumsum(invalid.astype(jnp.int32), axis=1, dtype=jnp.int32)],
        axis=1,
    )
    win_ok = (csum[:, k:] - csum[:, :-k]) == 0  # [B, W]

    c = codes.astype(jnp.uint64)
    kmer = jnp.zeros((B, W), dtype=jnp.uint64)
    for t in range(k):  # static ladder; XLA fuses into one elementwise loop
        kmer = kmer | (c[:, t : t + W] << jnp.uint64(2 * (k - 1 - t)))
    kmer = codec.canonical_jnp(kmer, k)
    kmer = jnp.where(win_ok, kmer, SENTINEL)
    return kmer.reshape(-1), jnp.sum(win_ok, dtype=jnp.int64)


@functools.partial(jax.jit, static_argnums=(1,))
def extract_canonical(codes: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[B, L] uint8 codes (0..3 valid, else invalid) -> (kmers [B*W] uint64
    canonical with SENTINEL at invalid windows, n_valid scalar). W = L-k+1."""
    invalid = codes > 3
    return _extract_core(jnp.where(invalid, 0, codes), invalid, k)


@functools.partial(jax.jit, static_argnums=(2,))
def extract_canonical_packed(packed: jnp.ndarray, maskbits: jnp.ndarray, k: int):
    """Packed variant: ``packed`` [B, L/4] uint8 holds 4 bases/byte
    (little-endian 2-bit fields), ``maskbits`` [B, L/8] uint8 holds validity
    bits (little-endian).  4x fewer host->device bytes than raw codes; the
    unpack is a couple of elementwise shifts that XLA fuses into the
    extract."""
    B, P4 = packed.shape
    shifts = jnp.array([0, 2, 4, 6], dtype=jnp.uint8)
    codes = ((packed[:, :, None] >> shifts[None, None, :]) & 3).reshape(B, P4 * 4)
    mshifts = jnp.arange(8, dtype=jnp.uint8)
    vbits = ((maskbits[:, :, None] >> mshifts[None, None, :]) & 1).reshape(B, -1)
    return _extract_core(codes, vbits == 0, k)


def pack_codes_np(codes: "np.ndarray"):
    """Host-side pack: [B, L] uint8 codes (255 = invalid), L % 8 == 0 ->
    (packed [B, L/4], maskbits [B, L/8]).  Pure NumPy; runs in the prefetch
    producer thread so it overlaps device compute."""
    import numpy as np

    B, L = codes.shape
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint8).reshape(B, L // 4, 4)
    packed = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)
    maskbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, maskbits


def sorted_u64(x: jnp.ndarray) -> jnp.ndarray:
    """Ascending sort of a flat uint64 vector (SENTINEL sorts last)."""
    return jnp.sort(x)


def sorted_u64_with_payload(k: jnp.ndarray, c: jnp.ndarray):
    """Ascending (u64 key, u32 payload) sort; the payload follows its key."""
    return jax.lax.sort((k, c), num_keys=1, is_stable=False)


def segment_compact(s: jnp.ndarray):
    """Segment-count duplicates of an already-sorted k-mer array and compact.

    Returns (unique_sorted [N] with SENTINEL padding at the tail, counts [N]
    aligned, n_unique scalar).  SENTINEL entries (masked windows) are
    dropped.  The compaction is a (key, payload) sort in which every slot
    but a run's first holds SENTINEL, so the run starts move to the front
    in order, each carrying its ORIGINAL POSITION as the payload; run
    lengths then fall out as diffs of consecutive compacted positions (one
    elementwise pass, no reverse scan).
    """
    n = s.shape[0]
    idxs = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    valid = first & (s != SENTINEL)
    n_real = jnp.sum(s != SENTINEL, dtype=jnp.int32)  # sentinels sort last
    key = jnp.where(valid, s, SENTINEL)
    pos = jnp.where(valid, idxs, 0).astype(jnp.uint32)  # run-start position
    n_unique = jnp.sum(valid, dtype=jnp.int64)
    uniq_c, pos_c = sorted_u64_with_payload(key, pos)
    # run length i = next run's start - this run's start; the last run ends
    # at n_real (sentinels sort last, so real elements are a prefix)
    nu32 = n_unique.astype(jnp.int32)
    shifted = jnp.concatenate([pos_c[1:], jnp.zeros((1,), jnp.uint32)])
    next_pos = jnp.where(idxs + 1 < nu32, shifted, n_real.astype(jnp.uint32))
    counts_c = jnp.where(idxs < nu32, next_pos - pos_c, 0)
    return uniq_c, counts_c.astype(jnp.uint32), n_unique


@jax.jit
def sort_count_unique(kmers: jnp.ndarray):
    """Sort a flat uint64 k-mer array and segment-count duplicates (see
    segment_compact for the formulation and return value)."""
    return segment_compact(sorted_u64(kmers))
