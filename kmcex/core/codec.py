"""2-bit k-mer codec: packing, reverse complement, canonicalization.

Semantics follow the reference utilities (/root/reference/tools.hpp):
  * base encoding A=0 C=1 G=2 T=3, MSB-first — the first (leftmost) base of the
    k-mer occupies the highest bit pair of the packed word (tools.hpp:63-76).
  * reverse complement on the packed uint64 (tools.hpp:130-139).
  * canonical k-mer = min(kmer, revcomp(kmer)) as an unsigned compare
    (tools.hpp:141-167).

Every function has a NumPy implementation (host path: IO, serialization) and a
jnp implementation (device path, used inside jit).  k is static (<= 32, so a
k-mer fits one uint64); all shapes are static for XLA.

The bit-parallel formulations below (mask/shift ladders rather than
per-base loops) keep every step a full-width elementwise op that XLA fuses.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# ASCII codes for the 2-bit alphabet, index = 2-bit code.
ACGT_BYTES = np.frombuffer(b"ACGT", dtype=np.uint8)

# Map ASCII byte -> 2-bit code; 255 marks non-ACGT (N etc.).
_BASE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE_LUT[_c] = _i

_U64 = np.uint64


def encode_bases(ascii_bytes: np.ndarray) -> np.ndarray:
    """ASCII uint8 array -> 2-bit codes (255 for non-ACGT). Any shape."""
    return _BASE_LUT[ascii_bytes]


def string_to_codes(s: str) -> np.ndarray:
    return encode_bases(np.frombuffer(s.encode(), dtype=np.uint8))


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes [..., k] into uint64 [...], MSB-first (tools.hpp:63-76)."""
    k = codes.shape[-1]
    shifts = (2 * (k - 1 - np.arange(k))).astype(_U64)
    return np.bitwise_or.reduce(codes.astype(_U64) << shifts, axis=-1)


def string_to_u64(s: str) -> int:
    """Reference Tools::kmers2uint64 (tools.hpp:63-76)."""
    return int(pack_codes_np(string_to_codes(s)))


def strings_to_u64(kmers: list[str], k: int) -> np.ndarray:
    """Vectorized kmers2uint64 for a batch of equal-length k-mer strings."""
    buf = np.frombuffer("".join(kmers).encode(), dtype=np.uint8)
    return pack_codes_np(encode_bases(buf.reshape(len(kmers), k)))


def u64_to_string(v: int, k: int) -> str:
    """Reference Tools::uint64_to_string (tools.hpp:90-100)."""
    out = bytearray(k)
    v = int(v)
    for i in range(k - 1, -1, -1):
        out[i] = ACGT_BYTES[v & 3]
        v >>= 2
    return out.decode()


def unpack_u64_np(v: np.ndarray, k: int) -> np.ndarray:
    """uint64 [...] -> 2-bit codes [..., k], MSB-first."""
    shifts = (2 * (k - 1 - np.arange(k))).astype(_U64)
    return ((v[..., None] >> shifts) & _U64(3)).astype(np.uint8)


def _revcomp_impl(v, k: int, xp):
    """Bit-parallel reverse complement of a 2-bit packed k-mer.

    Equivalent to the reference per-base loop (tools.hpp:130-139): complement
    every base (XOR 11), reverse the order of 2-bit groups across the full
    64-bit word with a mask ladder, then right-align to k bases.
    """
    u = xp.uint64
    x = ~v  # complement every bit; junk above 2k bits is shifted out below
    # Swap adjacent 2-bit groups, then nibbles, bytes, 16s, 32s: a full
    # bit-group reversal of the 64-bit word at 2-bit granularity.
    m2 = u(0x3333333333333333)
    m4 = u(0x0F0F0F0F0F0F0F0F)
    m8 = u(0x00FF00FF00FF00FF)
    m16 = u(0x0000FFFF0000FFFF)
    x = ((x & m2) << u(2)) | ((x >> u(2)) & m2)
    x = ((x & m4) << u(4)) | ((x >> u(4)) & m4)
    x = ((x & m8) << u(8)) | ((x >> u(8)) & m8)
    x = ((x & m16) << u(16)) | ((x >> u(16)) & m16)
    x = (x << u(32)) | (x >> u(32))
    return x >> u(64 - 2 * k)


def revcomp_np(v: np.ndarray, k: int) -> np.ndarray:
    """Reference Tools::get_complementation(uint64, len) (tools.hpp:130-139)."""
    v = np.asarray(v, dtype=_U64)
    with np.errstate(over="ignore"):
        return _revcomp_impl(v, k, np)


def revcomp_jnp(v: jnp.ndarray, k: int) -> jnp.ndarray:
    return _revcomp_impl(v.astype(jnp.uint64), k, jnp)


def canonical_np(v: np.ndarray, k: int) -> np.ndarray:
    """Reference Tools::get_min_kmer / get_min_com_kmer_uint (tools.hpp:146-167)."""
    v = np.asarray(v, dtype=_U64)
    return np.minimum(v, revcomp_np(v, k))


def canonical_jnp(v: jnp.ndarray, k: int) -> jnp.ndarray:
    v = v.astype(jnp.uint64)
    return jnp.minimum(v, revcomp_jnp(v, k))


def ascii_bytes_np(v: np.ndarray, k: int) -> np.ndarray:
    """uint64 [...] -> ASCII uint8 [..., k] (the string form the hashes run over)."""
    return ACGT_BYTES[unpack_u64_np(np.asarray(v, dtype=_U64), k)]


def ascii_bytes_jnp(v: jnp.ndarray, k: int) -> jnp.ndarray:
    shifts = jnp.asarray(2 * (k - 1 - np.arange(k)), dtype=jnp.uint64)
    codes = ((v.astype(jnp.uint64)[..., None] >> shifts) & jnp.uint64(3)).astype(
        jnp.int32
    )
    return jnp.asarray(ACGT_BYTES)[codes]


def middle_kmer_np(v: np.ndarray, k: int) -> np.ndarray:
    """The (k-2)-mer kmer[1:k-1] of a packed k-mer (back Bloom filters hash it;
    kmodel.hpp:386-390,475,548)."""
    v = np.asarray(v, dtype=_U64)
    mask = (_U64(1) << _U64(2 * (k - 1))) - _U64(1) if k < 32 else _U64(0xFFFFFFFFFFFFFFFF) >> _U64(2)
    return (v & mask) >> _U64(2)


def middle_kmer_jnp(v: jnp.ndarray, k: int) -> jnp.ndarray:
    mask = jnp.uint64(((1 << (2 * (k - 1))) - 1))
    return (v.astype(jnp.uint64) & mask) >> jnp.uint64(2)
