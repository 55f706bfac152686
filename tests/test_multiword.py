"""Multi-word (k > 32) codec + KMC DB reader/writer/annotation.

The vendored CKmerAPI packs arbitrary-k k-mers into uint64 arrays
(kmer_api.h:26-81); these tests pin our [n, W] representation against
independent pure-string brute force (the model layer stays k <= 32 like the
reference's own uint64 utilities, tools.hpp:63-76)."""

import numpy as np
import pytest

from kmcex.core import codec_mw
from kmcex.io import kmc_db
from kmcex.query import annotate

COMP = str.maketrans("ACGT", "TGCA")


def rc_str(s: str) -> str:
    return s.translate(COMP)[::-1]


def rand_kmers(rng, n, k):
    return ["".join(rng.choice(list("ACGT"), k)) for _ in range(n)]


@pytest.mark.parametrize("k", [33, 45, 64, 75])
def test_codec_mw_roundtrip_and_revcomp(k):
    rng = np.random.default_rng(k)
    kmers = rand_kmers(rng, 200, k)
    v = codec_mw.strings_to_mw(kmers, k)
    assert v.shape == (200, codec_mw.n_words(k))
    assert codec_mw.mw_to_strings(v, k) == kmers

    rc = codec_mw.revcomp_mw(v, k)
    assert codec_mw.mw_to_strings(rc, k) == [rc_str(s) for s in kmers]
    # involution
    assert np.array_equal(codec_mw.revcomp_mw(rc, k), v)

    canon = codec_mw.canonical_mw(v, k)
    expect = [min(s, rc_str(s)) for s in kmers]
    assert codec_mw.mw_to_strings(canon, k) == expect


def test_mw_order_and_bits():
    k = 45
    rng = np.random.default_rng(1)
    kmers = rand_kmers(rng, 300, k)
    v = codec_mw.strings_to_mw(kmers, k)
    keys = codec_mw.sort_key_mw(v)
    order = np.argsort(keys)
    assert [kmers[i] for i in order] == sorted(kmers)
    # extract_bits matches python big-int arithmetic
    vals = [int("".join(str("ACGT".index(c)) for c in s), 4) for s in kmers[:20]]
    for lowbit, nbits in [(0, 8), (60, 16), (64, 64), (88, 2), (3, 33)]:
        got = codec_mw.extract_bits_mw(v[:20], lowbit, nbits)
        exp = [(x >> lowbit) & ((1 << nbits) - 1) for x in vals]
        assert got.tolist() == exp


@pytest.mark.parametrize("k", [33, 45, 55])
def test_kmc1_db_roundtrip_k_gt_32(tmp_path, k):
    rng = np.random.default_rng(k)
    strs = sorted(set(rand_kmers(rng, 500, k)))
    v = codec_mw.strings_to_mw(strs, k)
    order = np.argsort(codec_mw.sort_key_mw(v))
    v = v[order]
    counts = rng.integers(1, 900, len(v)).astype(np.uint32)
    db = str(tmp_path / "mw")
    kmc_db.write_kmc1(db, v, counts, k)

    rd = kmc_db.KMCReader(db)
    assert rd.kmer_length == k and rd.multiword and rd.n_words == codec_mw.n_words(k)
    got_k, got_c = rd.list_all()
    assert np.array_equal(got_k, v)
    assert np.array_equal(got_c, counts)

    # random access: all present + some absent
    q = np.concatenate([v[::7], codec_mw.strings_to_mw(rand_kmers(rng, 50, k), k)])
    got = rd.check_kmers(q)
    lut = {s: int(c) for s, c in zip([strs[i] for i in order], counts)}
    exp = [lut.get(s, 0) for s in codec_mw.mw_to_strings(q, k)]
    assert got.tolist() == exp


def test_annotate_with_db_k_gt_32(tmp_path):
    k = 41
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 600))
    reads = [genome[i : i + 120] for i in range(0, 400, 37)]
    # counts via brute force on canonical k-mer strings
    from collections import Counter

    cnt = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            cnt[min(w, rc_str(w))] += 1
    strs = sorted(cnt)
    v = codec_mw.strings_to_mw(strs, k)
    counts = np.array([cnt[s] for s in strs], np.uint32)
    db = str(tmp_path / "ann")
    kmc_db.write_kmc1(db, v, counts, k)
    rd = kmc_db.KMCReader(db)

    out = annotate.annotate_with_db(rd, reads)
    for r, row in zip(reads, out):
        exp = [cnt[min(r[i : i + k], rc_str(r[i : i + k]))]
               for i in range(len(r) - k + 1)]
        assert row.tolist() == exp

    # reads with Ns: invalid windows report 0
    nread = reads[0][:20] + "N" + reads[0][21:]
    row = annotate.annotate_with_db(rd, [nread])[0]
    for i in range(len(nread) - k + 1):
        w = nread[i : i + k]
        exp = 0 if "N" in w else cnt[min(w, rc_str(w))]
        assert row[i] == exp
