"""Read annotation: per-window k-mer counters for whole reads.

Equivalent of the vendored KMC API's GetCountersForRead family
(/root/reference/kmc_api/kmc_file.cpp:991-1352): for every k-length window
of a read, return its counter — 0 for windows containing non-ACGT bases or
absent k-mers.  Canonical (both-strands) semantics, matching KMC databases
built in canonical mode.

Two backends:
  * a KMC database (exact counts, host vectorized binary search);
  * a KModel / DeviceKModel (approximate counts, batched device probes) —
    the reference has no model-backed annotator; it falls out of the batched
    query here.
"""

from __future__ import annotations

import numpy as np

from kmcex.core import codec, codec_mw


def extract_windows_mw(codes: np.ndarray, k: int,
                       canonical: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] uint8 codes -> (kmers [B, Wn, W] multi-word u64, valid
    [B, Wn]) for k > 32 (CKmerAPI multi-word packing, kmer_api.h:26-81)."""
    B, L = codes.shape
    Wn = L - k + 1
    W = codec_mw.n_words(k)
    if Wn <= 0:
        return np.zeros((B, 0, W), np.uint64), np.zeros((B, 0), bool)
    inv = (codes > 3).astype(np.int32)
    csum = np.concatenate([np.zeros((B, 1), np.int32), np.cumsum(inv, axis=1)], axis=1)
    valid = (csum[:, k:] - csum[:, :-k]) == 0
    c = np.where(codes > 3, 0, codes).astype(np.uint64)
    kmers = np.zeros((B, Wn, W), dtype=np.uint64)
    r = k - 32 * (W - 1)  # bases in the (most significant) word 0
    for w in range(W):
        s = 0 if w == 0 else r + 32 * (w - 1)   # first base of this word
        nb = r if w == 0 else 32
        for t in range(nb):
            kmers[:, :, w] |= c[:, s + t : s + t + Wn] << np.uint64(2 * (nb - 1 - t))
    if canonical:
        flat = codec_mw.canonical_mw(kmers.reshape(-1, W), k)
        kmers = flat.reshape(B, Wn, W)
    return kmers, valid


def extract_windows_np(codes: np.ndarray, k: int,
                       canonical: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """[B, L] uint8 codes -> (kmers [B, W] u64, valid [B, W]); canonicalized
    unless ``canonical=False`` (single-strand databases)."""
    B, L = codes.shape
    W = L - k + 1
    if W <= 0:
        return np.zeros((B, 0), np.uint64), np.zeros((B, 0), bool)
    inv = (codes > 3).astype(np.int32)
    csum = np.concatenate([np.zeros((B, 1), np.int32), np.cumsum(inv, axis=1)], axis=1)
    valid = (csum[:, k:] - csum[:, :-k]) == 0
    c = np.where(codes > 3, 0, codes).astype(np.uint64)
    kmer = np.zeros((B, W), dtype=np.uint64)
    for t in range(k):
        kmer |= c[:, t : t + W] << np.uint64(2 * (k - 1 - t))
    if canonical:
        kmer = codec.canonical_np(kmer, k)
    return kmer, valid


def _reads_to_codes(reads: list[str]) -> np.ndarray:
    L = max((len(r) for r in reads), default=0)
    codes = np.full((len(reads), L), 255, dtype=np.uint8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = codec.encode_bases(np.frombuffer(r.encode(), np.uint8))
    return codes


def annotate_with_db(reader, reads: list[str] | np.ndarray, k: int | None = None) -> list[np.ndarray]:
    """Exact per-window counters from a KMC database (io.kmc_db.KMCReader).

    Matches CKMCFile::GetCountersForRead: canonical lookups for both-strands
    databases, direct lookups for single-strand ones (kmc_file.cpp:991-1130
    has both variants), float counters for quake databases, and 0 for windows
    with invalid bases or absent k-mers."""
    k = k or reader.kmer_length
    if isinstance(reads, list):
        codes = _reads_to_codes(reads)
        lens = [len(r) for r in reads]
    else:
        codes = reads
        lens = [codes.shape[1]] * len(codes)
    canon = getattr(reader, "both_strands", True)
    if k > 32:
        kmers, valid = extract_windows_mw(codes, k, canonical=canon)
        W = kmers.shape[-1]
        counts = reader.check_kmers(kmers.reshape(-1, W)).reshape(valid.shape)
    else:
        kmers, valid = extract_windows_np(codes, k, canonical=canon)
        counts = reader.check_kmers(kmers.reshape(-1)).reshape(kmers.shape)
    counts = np.where(valid, counts, 0)
    out_dt = counts.dtype if counts.dtype == np.float32 else np.uint32
    return [counts[i, : max(lens[i] - k + 1, 0)].astype(out_dt) for i in range(len(lens))]


def annotate_with_model(model, reads: list[str] | np.ndarray, k: int | None = None) -> list[np.ndarray]:
    """Approximate per-window counters from a KModel (host) or DeviceKModel
    (batched device query)."""
    from kmcex.model.kmodel import KModel

    if k is None:
        k = getattr(model, "kmer_length", None) or model.k
    if isinstance(reads, list):
        codes = _reads_to_codes(reads)
        lens = [len(r) for r in reads]
    else:
        codes = reads
        lens = [codes.shape[1]] * len(codes)
    kmers, valid = extract_windows_np(codes, k)
    flat = kmers.reshape(-1)
    if isinstance(model, KModel):
        occ = model.kmer_to_occ_u64(flat)
    else:
        occ = np.asarray(model.kmer_to_occ(flat))
    occ = occ.reshape(kmers.shape)
    occ = np.where(valid, occ, 0)
    return [occ[i, : max(lens[i] - k + 1, 0)].astype(np.int32) for i in range(len(lens))]
