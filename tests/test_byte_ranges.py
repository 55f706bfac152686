"""Byte-range record-boundary splitting of one big input file
(io.fastq.split_byte_ranges + SegmentStream(byte_range=...)): the multi-host
single-file input split (SURVEY.md §5 data parallelism over reads; the
reference feeds one such file to kmc, main.cpp:137)."""

import gzip
from collections import Counter

import numpy as np
import pytest

from kmcex.core import codec
from kmcex.io import fastq


def _write_fastq(path, n_reads=400, seed=0, tricky_quals=True):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGTN", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n_reads):
            L = int(rng.integers(20, 60))
            seq = acgt[rng.integers(0, 4, L)].tobytes()
            if rng.random() < 0.1:  # sprinkle Ns
                pos = int(rng.integers(0, L))
                seq = seq[:pos] + b"N" + seq[pos + 1 :]
            # quality lines that START WITH '@' (and '+') — the ambiguity the
            # record scanner must survive
            if tricky_quals:
                q0 = b"@" if i % 3 == 0 else (b"+" if i % 3 == 1 else b"I")
            else:
                q0 = b"I"
            qual = q0 + b"I" * (L - 1)
            f.write(b"@read%d some description\n" % i)
            f.write(seq + b"\n+\n" + qual + b"\n")


def _count_stream(path, k, byte_range=None, seg_len=64):
    """reads + canonical k-mer Counter via the numpy segment path."""
    st = fastq.SegmentStream(path, k, seg_len, 64, use_native=False,
                             byte_range=byte_range)
    cnt: Counter = Counter()
    for codes in st:
        for row in codes:
            for s in range(len(row) - k + 1):
                win = row[s : s + k]
                if (win < 4).all():
                    v = 0
                    for b in win:
                        v = (v << 2) | int(b)
                    cnt[int(codec.canonical_np(np.array([v], np.uint64), k)[0])] += 1
    return st.reads, cnt


def test_split_ranges_cover_and_align(tmp_path):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq)
    data = fq.read_bytes()
    for n_parts in (1, 2, 3, 5, 8):
        ranges = fastq.split_byte_ranges(str(fq), n_parts)
        assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert b == c
        for a, b in ranges[1:]:
            if a < len(data):  # every non-degenerate start is a record header
                assert data[a - 1 : a + 1][0:1] == b"\n"
                assert data[a : a + 1] == b"@"
                # and scans as a real header: two lines later is '+'
                j1 = data.find(b"\n", a)
                j2 = data.find(b"\n", j1 + 1)
                assert data[j2 + 1 : j2 + 2] == b"+"


def test_range_streams_equal_whole_file(tmp_path):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=300, seed=7)
    k = 9
    want_reads, want = _count_stream(str(fq), k)
    for n_parts in (2, 3, 4):
        ranges = fastq.split_byte_ranges(str(fq), n_parts)
        reads = 0
        got: Counter = Counter()
        for r in ranges:
            nr, c = _count_stream(str(fq), k, byte_range=r)
            reads += nr
            got.update(c)
        assert reads == want_reads
        assert got == want


def test_range_stream_native_matches_numpy(tmp_path):
    fq = tmp_path / "r.fastq"
    _write_fastq(fq, n_reads=200, seed=3)
    k = 9
    ranges = fastq.split_byte_ranges(str(fq), 3)
    for r in ranges:
        st_n = fastq.SegmentStream(str(fq), k, 64, 1 << 12, use_native=True,
                                   byte_range=r)
        st_p = fastq.SegmentStream(str(fq), k, 64, 1 << 12, use_native=False,
                                   byte_range=r)
        bn = list(st_n)
        bp = list(st_p)
        assert st_n.reads == st_p.reads
        assert len(bn) == len(bp)
        for a, b in zip(bn, bp):
            np.testing.assert_array_equal(a, b)


def test_fasta_ranges(tmp_path):
    fa = tmp_path / "r.fasta"
    rng = np.random.default_rng(11)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(fa, "wb") as f:
        for i in range(60):
            L = int(rng.integers(30, 200))
            f.write(b">seq%d\n" % i)
            f.write(acgt[rng.integers(0, 4, L)].tobytes() + b"\n")
    data = fa.read_bytes()
    k = 11
    want_reads, want = _count_stream(str(fa), k)
    ranges = fastq.split_byte_ranges(str(fa), 4)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(data)
    reads = 0
    got: Counter = Counter()
    for a, b in ranges:
        if a < len(data) and a > 0:
            assert data[a : a + 1] == b">"
        nr, c = _count_stream(str(fa), k, byte_range=(a, b))
        reads += nr
        got.update(c)
    assert reads == want_reads
    assert got == want


def test_gzip_rejected(tmp_path):
    gz = tmp_path / "r.fastq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b"@r0\nACGTACGTACGT\n+\nIIIIIIIIIIII\n")
    with pytest.raises(ValueError):
        fastq.split_byte_ranges(str(gz), 2)


def test_more_parts_than_records(tmp_path):
    fq = tmp_path / "tiny.fastq"
    _write_fastq(fq, n_reads=2, tricky_quals=False)
    ranges = fastq.split_byte_ranges(str(fq), 8)
    size = fq.stat().st_size
    assert ranges[0][0] == 0 and ranges[-1][1] == size
    k = 9
    want_reads, want = _count_stream(str(fq), k)
    reads = 0
    got: Counter = Counter()
    for r in ranges:
        nr, c = _count_stream(str(fq), k, byte_range=r)
        reads += nr
        got.update(c)
    assert reads == want_reads == 2
    assert got == want
