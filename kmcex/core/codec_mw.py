"""Multi-word 2-bit k-mer codec for k > 32.

The reference CKmerAPI packs k-mers of arbitrary k into an array of uint64
words, MSB-first (/root/reference/kmc_api/kmer_api.h:26-81).  This module is
the vectorized NumPy equivalent used by the DB-reader / annotation layer
(the *model* layer stays k <= 32, matching the reference's own uint64
utilities, tools.hpp:63-76,160-167).

Representation: a batch of k-mers is an ``[n, W]`` uint64 array with
``W = n_words(k)``; word 0 is the MOST significant, and the 2k payload bits
are right-aligned in the 64*W-bit integer (value = sum(words[i] <<
64*(W-1-i))).  Lexicographic base order == numeric order of that integer,
so comparisons reduce to word-by-word tie-breaking (or a big-endian byte
view for numpy sort/searchsorted).
"""

from __future__ import annotations

import numpy as np

from kmcex.core.codec import ACGT_BYTES, encode_bases

_U64 = np.uint64


def n_words(k: int) -> int:
    """Words needed for k bases (kmer_api.h:40-43 uses the same ceil)."""
    return (2 * k + 63) // 64


def pack_codes_mw(codes: np.ndarray, k: int) -> np.ndarray:
    """2-bit codes [n, k] -> [n, W] uint64, MSB-first, right-aligned."""
    n = codes.shape[0]
    W = n_words(k)
    out = np.zeros((n, W), dtype=_U64)
    c = codes.astype(_U64)
    # base i sits at bit 2*(k-1-i) of the 2k-bit integer
    for i in range(k):
        bit = 2 * (k - 1 - i)
        w = W - 1 - bit // 64
        out[:, w] |= c[:, i] << _U64(bit % 64)
    return out


def unpack_mw(v: np.ndarray, k: int) -> np.ndarray:
    """[n, W] uint64 -> 2-bit codes [n, k], MSB-first."""
    W = v.shape[1]
    out = np.zeros((v.shape[0], k), dtype=np.uint8)
    for i in range(k):
        bit = 2 * (k - 1 - i)
        w = W - 1 - bit // 64
        out[:, i] = ((v[:, w] >> _U64(bit % 64)) & _U64(3)).astype(np.uint8)
    return out


def strings_to_mw(kmers: list[str], k: int) -> np.ndarray:
    buf = np.frombuffer("".join(kmers).encode(), dtype=np.uint8)
    return pack_codes_mw(encode_bases(buf.reshape(len(kmers), k)), k)


def mw_to_strings(v: np.ndarray, k: int) -> list[str]:
    chars = ACGT_BYTES[unpack_mw(np.asarray(v, dtype=_U64), k)]
    return [row.tobytes().decode() for row in chars]


def _rev_bases_u64(x: np.ndarray) -> np.ndarray:
    """Reverse the 32 2-bit groups of each uint64 (mask ladder)."""
    u = _U64
    m2 = u(0x3333333333333333)
    m4 = u(0x0F0F0F0F0F0F0F0F)
    m8 = u(0x00FF00FF00FF00FF)
    m16 = u(0x0000FFFF0000FFFF)
    x = ((x & m2) << u(2)) | ((x >> u(2)) & m2)
    x = ((x & m4) << u(4)) | ((x >> u(4)) & m4)
    x = ((x & m8) << u(8)) | ((x >> u(8)) & m8)
    x = ((x & m16) << u(16)) | ((x >> u(16)) & m16)
    return (x << u(32)) | (x >> u(32))


def shr_mw(v: np.ndarray, s: int) -> np.ndarray:
    """Logical right shift of the 64W-bit integers by ``s`` bits."""
    W = v.shape[1]
    wo, b = divmod(s, 64)
    out = np.zeros_like(v)
    for j in range(W):
        src = j - wo
        if 0 <= src < W:
            out[:, j] = v[:, src] >> _U64(b) if b else v[:, src]
            if b and src - 1 >= 0:
                out[:, j] |= v[:, src - 1] << _U64(64 - b)
        elif b and 0 <= src - 1 < W:
            out[:, j] = v[:, src - 1] << _U64(64 - b)
    return out


def revcomp_mw(v: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement, the multi-word analogue of tools.hpp:130-139 /
    the byte-LUT in-place reverse (kmer_api.h:515-646)."""
    v = np.asarray(v, dtype=_U64)
    with np.errstate(over="ignore"):
        x = ~v  # complement every base (junk above 2k bits masked below)
        x = _rev_bases_u64(x)
    x = x[:, ::-1]  # reversing base order also reverses word significance
    return shr_mw(x, 64 * v.shape[1] - 2 * k)


def less_mw(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise a < b on [n, W] big-endian-word integers."""
    less = np.zeros(a.shape[0], dtype=bool)
    decided = np.zeros(a.shape[0], dtype=bool)
    for w in range(a.shape[1]):
        less |= ~decided & (a[:, w] < b[:, w])
        decided |= a[:, w] != b[:, w]
    return less


def equal_mw(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.all(a == b, axis=1)


def canonical_mw(v: np.ndarray, k: int) -> np.ndarray:
    """min(kmer, revcomp) — multi-word get_min_kmer (tools.hpp:160-167)."""
    v = np.asarray(v, dtype=_U64)
    rc = revcomp_mw(v, k)
    take_rc = less_mw(rc, v)
    return np.where(take_rc[:, None], rc, v)


def sort_key_mw(v: np.ndarray) -> np.ndarray:
    """[n, W] -> [n] fixed-width byte keys whose memcmp order equals numeric
    order (big-endian words, word 0 first).  Works with np.sort /
    np.searchsorted / np.unique."""
    W = v.shape[1]
    be = np.ascontiguousarray(v).astype(">u8")
    return be.view(f"S{8 * W}").reshape(-1)


def extract_bits_mw(v: np.ndarray, lowbit: int, nbits: int) -> np.ndarray:
    """Extract bits [lowbit, lowbit+nbits) (nbits <= 64) as uint64 [n]."""
    assert nbits <= 64
    W = v.shape[1]
    wl, s = divmod(lowbit, 64)
    col = W - 1 - wl
    out = v[:, col] >> _U64(s) if s else v[:, col].copy()
    if s and s + nbits > 64 and col - 1 >= 0:
        out = out | (v[:, col - 1] << _U64(64 - s))
    if nbits < 64:
        out = out & ((_U64(1) << _U64(nbits)) - _U64(1))
    return out


def signatures_mw(v: np.ndarray, k: int, sig_len: int) -> np.ndarray:
    """Batched get_signature for multi-word k-mers (kmer_api.h:653-673)."""
    from kmcex.core.signature import norm_table

    norm = norm_table(sig_len)
    best = np.full(v.shape[0], np.uint32(1 << (2 * sig_len)), dtype=np.uint32)
    for w in range(k - sig_len + 1):
        mm = extract_bits_mw(v, 2 * (k - sig_len - w), 2 * sig_len)
        best = np.minimum(best, norm[mm.astype(np.int64)])
    return best
