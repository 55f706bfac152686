"""KMC database reader/writer unit tests (io/kmc_db.py)."""

import numpy as np
import pytest

from kmcex.core import codec
from kmcex.io import kmc_db


def _pairs(seed, n, k):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << min(2 * k, 62), size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(raw & mask, k))
    counts = rng.integers(1, 1024, size=len(can), dtype=np.uint64)
    return can, counts


def test_roundtrip_k31(tmp_path):
    can, counts = _pairs(0, 5000, 31)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, 31, min_count=1, max_count=1023)
    r = kmc_db.KMCReader(db)
    assert r.kmer_length == 31
    assert r.counter_size == 2
    kmers, cts = r.list_all()
    np.testing.assert_array_equal(kmers, can)
    np.testing.assert_array_equal(cts, counts.astype(np.uint32))


def test_roundtrip_various_k(tmp_path):
    for k in [11, 15, 21, 25, 32]:
        can, counts = _pairs(k, 2000, k)
        db = str(tmp_path / f"db{k}")
        kmc_db.write_kmc1(db, can, counts, k, min_count=1, max_count=1023)
        r = kmc_db.KMCReader(db)
        kmers, cts = r.list_all()
        np.testing.assert_array_equal(kmers, can)
        np.testing.assert_array_equal(cts, counts.astype(np.uint32))


def test_min_max_filter(tmp_path):
    can, counts = _pairs(5, 3000, 31)
    db = str(tmp_path / "db")
    # store with wide bounds, read back with [5, 100] listing filter
    kmc_db.write_kmc1(db, can, counts, 31, min_count=5, max_count=100)
    r = kmc_db.KMCReader(db)
    kmers, cts = r.list_all()
    keep = (counts >= 5) & (counts <= 100)
    np.testing.assert_array_equal(kmers, can[keep])
    np.testing.assert_array_equal(cts, counts[keep].astype(np.uint32))


def test_check_kmers(tmp_path):
    can, counts = _pairs(9, 4000, 31)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, 31, min_count=1, max_count=1023)
    r = kmc_db.KMCReader(db)
    rng = np.random.default_rng(1)
    absent = rng.integers(0, 1 << 62, size=500, dtype=np.uint64)
    q = np.concatenate([can[::3], absent])
    got = r.check_kmers(q)
    lookup = dict(zip(can.tolist(), counts.tolist()))
    want = np.array([lookup.get(int(x), 0) for x in q], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_quake_mode_roundtrip(tmp_path):
    """mode=1 stores float32 counters as raw IEEE bits (kmc_file.cpp:408-420).
    Random access (BinarySearch, kmc_file.cpp:1425-1433) filters hits on the
    counter AS FLOAT against [min_count, max_count]."""
    can, _ = _pairs(3, 3000, 31)
    rng = np.random.default_rng(3)
    fcounts = (rng.random(len(can)) * 100).astype(np.float32) + np.float32(0.5)
    db = str(tmp_path / "qdb")
    kmc_db.write_kmc1(db, can, fcounts, 31, min_count=1,
                      max_count=0xFFFFFFFF, mode=1)
    r = kmc_db.KMCReader(db)
    assert r.mode == 1 and r.counter_size == 4
    kmers, cts = r.list_all()
    assert cts.dtype == np.float32
    np.testing.assert_array_equal(kmers, can)
    np.testing.assert_array_equal(cts, fcounts)
    # random access: float filter — counters in [0.5, 1) are misses even
    # though their raw bit pattern is a huge in-range integer (ADVICE r1)
    got = r.check_kmers(can[::7])
    want = np.where(fcounts[::7] >= np.float32(1), fcounts[::7], np.float32(0))
    np.testing.assert_array_equal(got, want)
    # the model layer must refuse quake databases (the reference would feed
    # float bits into its integer encode)
    from kmcex.model.kmodel import get_model

    with pytest.raises(ValueError):
        get_model(1, 1023, 7, 5).init(db)


def test_quake_listing_or_quirk(tmp_path):
    """ReadNextKmer's quake filter quirk (kmc_file.cpp:495-512): a record
    lists iff float-in-range OR raw-bits-in-range (the float overload's
    `continue` falls through to the integer do/while condition), while
    BinarySearch uses the float comparison alone."""
    can, _ = _pairs(6, 64, 31)
    can = can[:3]
    # [0]: float 2.5 in [1,1023], raw bits 0x40200000 out  -> listed, RA hit
    # [1]: float 0.5 out, raw bits 0x3F000000 out          -> dropped, RA miss
    # [2]: denormal float(raw=5): float out, raw 5 in      -> listed, RA miss
    fcounts = np.array([2.5, 0.5, 0.0], dtype=np.float32)
    fcounts[2] = np.uint32(5).view(np.float32)
    db = str(tmp_path / "qdb2")
    kmc_db.write_kmc1(db, can, fcounts, 31, min_count=1, max_count=1023, mode=1)
    r = kmc_db.KMCReader(db)
    kmers, cts = r.list_all()
    np.testing.assert_array_equal(kmers, can[[0, 2]])
    np.testing.assert_array_equal(cts, fcounts[[0, 2]])
    got = r.check_kmers(can)
    np.testing.assert_array_equal(
        got, np.array([2.5, 0.0, 0.0], dtype=np.float32))


def test_list_chunks_streaming_equals_list_all(tmp_path):
    """Chunked streaming decode (bounded memory, 32MB-window analogue of
    kmc_file.cpp:18,605-609) concatenates to exactly the full listing, for
    any chunk size."""
    can, counts = _pairs(13, 5000, 31)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, 31, min_count=2, max_count=500)
    r = kmc_db.KMCReader(db)
    want_k, want_c = r.list_all()
    for chunk_bytes in (1, 64, 4096):
        parts = list(kmc_db.KMCReader(db).list_chunks(chunk_bytes=chunk_bytes))
        got_k = np.concatenate([p[0] for p in parts])
        got_c = np.concatenate([p[1] for p in parts])
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_c, want_c)


def test_streaming_init_equals_in_memory_build(tmp_path):
    """KModel.init streams the DB in bounded chunks; the resulting model
    must be byte-identical to an in-memory init_from_pairs build."""
    from kmcex.model.kmodel import get_model

    can, counts = _pairs(17, 20000, 31)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, 31, min_count=1, max_count=1023)

    km_a = get_model(1, 1023, 7, 5)
    km_a.init(db)
    km_b = get_model(1, 1023, 7, 5)
    km_b.init_from_pairs(can, counts.astype(np.uint32), 31)
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    km_a.save(a_dir)
    km_b.save(b_dir)
    for fn in ["header", "km.bin", "rest.bin"]:
        assert (a_dir / fn).read_bytes() == (b_dir / fn).read_bytes(), fn


def test_counter_size_rule():
    assert kmc_db.counter_size_for(255) == 1
    assert kmc_db.counter_size_for(256) == 2
    assert kmc_db.counter_size_for(1023) == 2
    assert kmc_db.counter_size_for(65536) == 3
    assert kmc_db.counter_size_for(1 << 24) == 4


def test_stream_writer_matches_one_shot(tmp_path):
    """KMC1StreamWriter (chunk-by-chunk, bounded memory) must produce
    byte-identical .kmc_pre/.kmc_suf to the one-shot write_kmc1 for the
    same table — the genome-scale DB writer (VERDICT r3 item 4)."""
    for k in (31, 21):
        can, counts = _pairs(k * 7, 6000, k)
        counts = np.minimum(counts, 1023)
        one = str(tmp_path / f"one{k}")
        kmc_db.write_kmc1(one, can, counts, k, min_count=1, max_count=1023,
                          counter_size=kmc_db.counter_size_for(1023))
        st = str(tmp_path / f"st{k}")
        w = kmc_db.KMC1StreamWriter(st, k, min_count=1, max_count=1023)
        rng = np.random.default_rng(k)
        a = 0
        while a < len(can):
            m = int(rng.integers(1, 700))
            w.write_chunk(can[a : a + m], counts[a : a + m])
            a += m
        w.close()
        for ext in (".kmc_pre", ".kmc_suf"):
            ob = open(one + ext, "rb").read()
            sb = open(st + ext, "rb").read()
            assert ob == sb, (k, ext, len(ob), len(sb))
        r = kmc_db.KMCReader(st)
        kk, cc = r.list_all()
        np.testing.assert_array_equal(kk, can)
        np.testing.assert_array_equal(cc, counts.astype(np.uint32))


def test_stream_writer_rejects_unsorted(tmp_path):
    w = kmc_db.KMC1StreamWriter(str(tmp_path / "x"), 21, max_count=1023)
    w.write_chunk(np.array([5, 9], np.uint64), np.array([1, 1], np.uint32))
    with pytest.raises(ValueError):
        w.write_chunk(np.array([9], np.uint64), np.array([1], np.uint32))
    with pytest.raises(ValueError):
        w.write_chunk(np.array([20, 12], np.uint64),
                      np.array([1, 1], np.uint32))
    w.close()


def test_stream_writer_quake_mode(tmp_path):
    """Streaming writer in quake mode (float counters stored as IEEE bits,
    kmc_file.cpp:408-420) matches the one-shot writer byte-for-byte."""
    k = 21
    can, _ = _pairs(99, 3000, k)
    fcounts = (np.random.default_rng(1).random(len(can)) * 50 + 0.5).astype(
        np.float32)
    one = str(tmp_path / "one")
    kmc_db.write_kmc1(one, can, fcounts, k, min_count=1, max_count=1023,
                      mode=1)
    st = str(tmp_path / "st")
    with kmc_db.KMC1StreamWriter(st, k, min_count=1, max_count=1023,
                                 mode=1) as w:
        for a in range(0, len(can), 777):
            w.write_chunk(can[a : a + 777], fcounts[a : a + 777])
    for ext in (".kmc_pre", ".kmc_suf"):
        assert (open(one + ext, "rb").read() == open(st + ext, "rb").read()), ext
