"""Read-annotation API tests (GetCountersForRead equivalent)."""

import numpy as np

from kmcex.core import codec
from kmcex.io import kmc_db
from kmcex.model.kmodel import get_model
from kmcex.query import annotate


def test_annotate_with_db(tmp_path):
    rng = np.random.default_rng(0)
    k = 15
    # genome-derived reads so windows actually hit the database
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = []
    for _ in range(30):
        s = int(rng.integers(0, len(genome) - 80))
        reads.append(genome[s : s + 80])
    reads[5] = reads[5][:20] + "N" + reads[5][21:]  # invalid base in one read

    # count all read k-mers exactly (brute force), build a DB
    from collections import Counter

    c = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if "N" in w:
                continue
            c[int(codec.canonical_np(np.uint64(codec.string_to_u64(w)), k))] += 1
    kmers = np.array(sorted(c), dtype=np.uint64)
    counts = np.array([c[int(x)] for x in kmers], dtype=np.uint64)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, kmers, counts, k)
    reader = kmc_db.KMCReader(db)

    out = annotate.annotate_with_db(reader, reads)
    assert len(out) == len(reads)
    for r, row in zip(reads, out):
        assert len(row) == len(r) - k + 1
        for i, cnt in enumerate(row):
            w = r[i : i + k]
            if "N" in w:
                assert cnt == 0
            else:
                key = int(codec.canonical_np(np.uint64(codec.string_to_u64(w)), k))
                assert cnt == c[key]


def test_annotate_with_model():
    rng = np.random.default_rng(1)
    k = 21
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(rng.integers(0, 1 << 62, size=30000, dtype=np.uint64) & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), 1, 1023).astype(np.uint32)
    km = get_model(1, 1023, 7, 4)
    km.init_from_pairs(can, counts, k)

    read = codec.u64_to_string(int(can[10]), k) + "ACGT"
    out = annotate.annotate_with_model(km, [read])
    assert len(out) == 1 and len(out[0]) == 5
    # window 0 is exactly can[10]; model query for it equals kmer_to_occ
    want = km.kmer_to_occ(codec.u64_to_string(int(can[10]), k))
    assert out[0][0] == want


def test_annotate_single_strand_db(tmp_path):
    """Single-strand databases (both_strands=0) look windows up without
    canonicalization, matching the vendored GetCountersForRead variants."""
    import numpy as np

    from kmcex.core import codec
    from kmcex.io import kmc_db
    from kmcex.query import annotate

    k = 15
    rng = np.random.default_rng(11)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    kmers = np.unique(rng.integers(0, 1 << (2 * k), 4000, dtype=np.uint64) & mask)
    counts = rng.integers(1, 100, len(kmers), dtype=np.uint64)
    db = str(tmp_path / "ss")
    kmc_db.write_kmc1(db, kmers, counts, k, both_strands=False)
    r = kmc_db.KMCReader(db)
    assert not r.both_strands

    read = codec.u64_to_string(int(kmers[10]), k) + "A"
    (got,) = annotate.annotate_with_db(r, [read])
    # window 0 is kmers[10] exactly (no canonicalization); its count matches
    assert got[0] == counts[10]
    # the canonical form of a non-stored reverse complement must NOT hit:
    rc = codec.revcomp_np(np.array([kmers[10]], np.uint64), k)[0]
    if rc != kmers[10] and rc not in set(kmers.tolist()):
        read_rc = codec.u64_to_string(int(rc), k)
        (got_rc,) = annotate.annotate_with_db(r, [read_rc])
        assert got_rc[0] == 0
