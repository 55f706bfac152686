"""Counting engine tests: extraction, dedupe, FASTQ pipeline vs brute force."""

import gzip
from collections import Counter

import numpy as np

from kmcex.core import codec
from kmcex.count import extract
from kmcex.count.counter import CountAccumulator
from kmcex.count.pipeline import count_fastq
from kmcex.io import fastq

BASES = "ACGT"


def brute_counts(reads: list[str], k: int) -> Counter:
    c = Counter()
    for r in reads:
        # split at non-ACGT (KMC semantics)
        for part in "".join(b if b in BASES else " " for b in r).split():
            for i in range(len(part) - k + 1):
                kmer = part[i : i + k]
                c[codec.string_to_u64(codec.u64_to_string(
                    int(codec.canonical_np(np.uint64(codec.string_to_u64(kmer)), k)), k))] += 1
    return c


def random_reads(rng, n, lo=40, hi=220, n_rate=0.01):
    reads = []
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        chars = rng.choice(list("ACGT"), size=L)
        nmask = rng.random(L) < n_rate
        chars[nmask] = "N"
        reads.append("".join(chars))
    return reads


def test_extract_canonical_tiny():
    k = 5
    s = "ACGTTACGN"  # one N splits the windows
    codes = codec.encode_bases(np.frombuffer(s.encode(), np.uint8))[None, :]
    kmers, n_valid = extract.extract_canonical(codes, k)
    got = sorted(int(x) for x in np.asarray(kmers) if x != 0xFFFFFFFFFFFFFFFF)
    want = sorted(
        int(codec.canonical_np(np.uint64(codec.string_to_u64(s[i : i + k])), k))
        for i in range(4)  # windows 0..3 are N-free
    )
    assert got == want
    assert int(n_valid) == 4


def test_counts_vs_bruteforce(tmp_path):
    rng = np.random.default_rng(0)
    k = 21
    reads = random_reads(rng, 300)
    # duplicate some reads to create multiplicity
    reads = reads + reads[:100]
    fq = tmp_path / "t.fastq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    kmers, counts, stats = count_fastq(str(fq), k=k, ci=1, cs=1 << 30,
                                       seg_len=64, batch_segs=512)
    assert stats.reads == len(reads)
    want = brute_counts(reads, k)
    got = dict(zip(kmers.tolist(), counts.tolist()))
    assert got == dict(want)
    assert np.all(kmers[1:] > kmers[:-1])


def test_gzip_and_list_inputs(tmp_path):
    rng = np.random.default_rng(1)
    k = 15
    reads1 = random_reads(rng, 80)
    reads2 = random_reads(rng, 80)
    f1 = tmp_path / "a.fastq.gz"
    with gzip.open(f1, "wt") as f:
        for i, r in enumerate(reads1):
            f.write(f"@a{i}\n{r}\n+\n{'I' * len(r)}\n")
    f2 = tmp_path / "b.fastq"
    with open(f2, "w") as f:
        for i, r in enumerate(reads2):
            f.write(f"@b{i}\n{r}\n+\n{'I' * len(r)}\n")
    lst = tmp_path / "in.lst"
    lst.write_text(f"{f1}\n{f2}\n")
    kmers, counts, stats = count_fastq(f"@{lst}", k=k, seg_len=96, batch_segs=256)
    want = brute_counts(reads1 + reads2, k)
    got = dict(zip(kmers.tolist(), counts.tolist()))
    assert got == dict(want)


def test_ci_cs_semantics(tmp_path):
    # ci drops rare k-mers, cs clamps counters (KMC -ci/-cs)
    k = 11
    read = "ACGTACGTACGTACGTACG"
    reads = [read] * 10 + [("T" * 5 + "GATTACAGATT" + "C" * 5)]
    fq = tmp_path / "t.fastq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    kmers, counts, _ = count_fastq(str(fq), k=k, ci=2, cs=5, seg_len=32, batch_segs=64)
    want = brute_counts(reads, k)
    exp = {km: min(c, 5) for km, c in want.items() if c >= 2}
    got = dict(zip(kmers.tolist(), counts.tolist()))
    assert got == exp


def test_fasta_input(tmp_path):
    k = 9
    fa = tmp_path / "t.fa"
    fa.write_text(">s1\nACGTACGTACGTACGT\n>s2\nGGGGGGGGGGGG\n")
    kmers, counts, _ = count_fastq(str(fa), k=k, seg_len=32, batch_segs=64)
    want = brute_counts(["ACGTACGTACGTACGT", "GGGGGGGGGGGG"], k)
    got = dict(zip(kmers.tolist(), counts.tolist()))
    assert got == dict(want)


def test_wrapped_fasta_matches_unwrapped(tmp_path):
    """A standard 70-column wrapped genome must count every k-mer — incl.
    the ~40% of windows spanning line breaks that the round-3 per-line
    segmentation silently lost.  Checked across chunk seams (tiny
    chunk_bytes forces records to straddle chunks), in all four stream
    modes (native/numpy x packed/unpacked)."""
    rng = np.random.default_rng(17)
    k = 31
    seqs = []
    for i in range(5):
        L = int(rng.integers(150, 4000))
        chars = rng.choice(list("ACGTN"), size=L, p=[0.24] * 4 + [0.04])
        seqs.append("".join(chars))
    flat = tmp_path / "flat.fa"
    wrapped = tmp_path / "wrap.fa"
    with open(flat, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")
    with open(wrapped, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n")
            for a in range(0, len(s), 70):
                f.write(s[a : a + 70] + "\n")
    want = brute_counts(seqs, k)
    for use_native in (True, False):
        for packed in (True, False):
            st = fastq.SegmentStream(str(wrapped), k, seg_len=128,
                                     batch_segs=32, use_native=use_native,
                                     packed=packed)
            got: Counter = Counter()
            for b in st:
                if packed:
                    km, _ = extract.extract_canonical_packed(*b, k)
                else:
                    km, _ = extract.extract_canonical(b, k)
                km = np.asarray(km)
                got.update(km[km != 0xFFFFFFFFFFFFFFFF].tolist())
            assert got == want, (use_native, packed)
            assert st.reads == len(seqs)
            assert st.bases == sum(len(s) for s in seqs)
    # chunk-seam carry: records straddling 1KB parse chunks lose nothing
    from kmcex.io.fastq import _iter_seq_spans, _segment_spans

    got2: Counter = Counter()
    reads2 = bases2 = 0
    for block, s, e, nr, nb in _iter_seq_spans(str(wrapped),
                                               chunk_bytes=1024, k=k):
        reads2 += nr
        bases2 += nb
        segs = _segment_spans(block, s, e, k, 128)
        if len(segs):
            km = np.asarray(extract.extract_canonical(segs, k)[0])
            got2.update(km[km != 0xFFFFFFFFFFFFFFFF].tolist())
    assert got2 == want
    assert reads2 == len(seqs)
    assert bases2 == sum(len(s) for s in seqs)


def test_accumulator_merging():
    # many tiny batches must merge to the same result as one big batch
    rng = np.random.default_rng(3)
    k = 13
    vals = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.uint64)
    vals = codec.canonical_np(vals, k)
    acc = CountAccumulator(k)
    for chunk in np.array_split(vals, 23):
        u, c = np.unique(chunk, return_counts=True)
        acc.add_kmer_run(u, c.astype(np.uint64))
    kmers, counts = acc.finalize()
    u, c = np.unique(vals, return_counts=True)
    np.testing.assert_array_equal(kmers, u)
    np.testing.assert_array_equal(counts, c.astype(np.uint32))


def test_native_packed_stream_matches(tmp_path):
    """Native packed segmenter output == byte segmenter + host pack."""
    import numpy as np

    from kmcex.count.extract import pack_codes_np
    from kmcex.io import fastq

    rng = np.random.default_rng(21)
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    fq = tmp_path / "r.fastq"
    with open(fq, "wb") as f:
        for i in range(300):
            L = int(rng.integers(20, 90))
            seq = bases[rng.integers(0, 5, L)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * L))
    k, seg_len, bs = 17, 48, 64
    s1 = fastq.SegmentStream(str(fq), k, seg_len, bs)
    s2 = fastq.SegmentStream(str(fq), k, seg_len, bs, packed=True)
    b1 = list(s1)
    b2 = list(s2)
    assert len(b1) == len(b2)
    assert (s1.reads, s1.bases) == (s2.reads, s2.bases)
    for codes, (packed, mask) in zip(b1, b2):
        wp, wm = pack_codes_np(codes)
        np.testing.assert_array_equal(packed, wp)
        np.testing.assert_array_equal(mask, wm)


def test_bitpack_transfer_roundtrip():
    """Device _pack_span bit-packing == native unpack, across widths and the
    real/pad boundary (sentinel deltas must not corrupt neighbouring lanes)."""
    import jax.numpy as jnp

    from kmcex import native
    from kmcex.count.device_lsm import SENTINEL, _final_stats, _pack_span

    rng = np.random.default_rng(9)
    for n_real, size, n_chunks, cs in [(1000, 1024, 4, 1023),
                                       (777, 2048, 8, 255),
                                       (64, 64, 1, 65535)]:
        kmers = np.unique(
            rng.integers(1, 1 << 50, size=2 * n_real, dtype=np.uint64))[:n_real]
        assert len(kmers) == n_real
        counts = rng.integers(1, 4 * cs, size=n_real).astype(np.uint32)
        ku = np.full(size, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
        kc = np.zeros(size, np.uint32)
        ku[:n_real] = kmers
        kc[:n_real] = counts
        u, c = jnp.asarray(ku), jnp.asarray(kc)
        flat = np.asarray(_final_stats(u, c, np.uint32(1), n_chunks))
        assert int(flat[6]) == int(counts[0])   # first count
        assert int(flat[7]) == int(kmers[-1])   # last k-mer
        assert int(flat[8]) == int(counts[-1])  # last count
        assert int(flat[4]) == n_real
        row_gap = flat[9 : 9 + n_chunks]
        row_cnt = np.minimum(flat[9 + n_chunks : 9 + 2 * n_chunks],
                             np.uint64(cs))
        m = size // n_chunks
        base = np.uint64(int(flat[5]))
        got_k, got_c = [], []
        for i in range(n_chunks):
            if i * m >= n_real:
                break
            wbits = min(64, (max(1, int(row_gap[i]).bit_length()) + 1) & ~1)
            cbits = min(32, (max(1, int(row_cnt[i]).bit_length()) + 1) & ~1)
            kb, cb = _pack_span(u, c, jnp.int32(i * m), m, wbits, cbits, cs)
            n_here = min(n_real - i * m, m)
            dk = native.unpack_deltas(np.asarray(kb), n_here, wbits, int(base))
            dc = native.unpack_counts(np.asarray(cb), n_here, cbits)
            base = dk[-1]
            got_k.append(dk)
            got_c.append(dc)
        np.testing.assert_array_equal(np.concatenate(got_k), kmers)
        np.testing.assert_array_equal(
            np.concatenate(got_c), np.minimum(counts, np.uint32(cs)))


def test_fused_finalize_stream():
    """The fused single-dispatch finalize (sort + compact + stats in one
    device program, multi-row bit-packed decode) must equal a brute-force
    unique/count, including long duplicate runs spanning row boundaries,
    across ci/cs settings."""
    import jax.numpy as jnp

    from kmcex.count.device_lsm import DeviceCountAccumulator

    rng = np.random.default_rng(11)
    SEN = np.uint64(0xFFFFFFFFFFFFFFFF)
    for trial in range(6):
        size = 256
        # heavy duplication: few distinct values, with one value repeated
        # enough to span multiple transfer rows when sorted
        vals = rng.integers(1, 25, size=size - 40, dtype=np.uint64) * 977
        vals = np.concatenate([
            vals,
            np.full(30, np.uint64(7 * 977), np.uint64),  # long dup run
            np.full(10, SEN, np.uint64),                 # masked windows
        ])
        rng.shuffle(vals)
        for ci, cs in [(1, 1023), (2, 255), (3, 7)]:
            acc = DeviceCountAccumulator(k=31)
            for chunk in np.array_split(vals, 4):
                acc.raw.append(jnp.asarray(chunk))
                acc.raw_elems += len(chunk)
            total, hist, it = acc.finalize_stream(ci, cs, n_chunks=16)
            got_k, got_c = [], []
            for ku, kc in it:
                got_k.append(ku)
                got_c.append(kc)
            got_k = np.concatenate(got_k) if got_k else np.zeros(0, np.uint64)
            got_c = np.concatenate(got_c) if got_c else np.zeros(0, np.uint32)
            real = vals[vals != SEN]
            want_k, want_c = np.unique(real, return_counts=True)
            keep = want_c >= ci
            want_k, want_c = want_k[keep], np.minimum(want_c[keep], cs)
            np.testing.assert_array_equal(got_k, want_k)
            np.testing.assert_array_equal(got_c, want_c.astype(np.uint32))
            assert total == len(want_k)
            want_hist = [int(np.count_nonzero(
                np.unique(real, return_counts=True)[1] == ci + i))
                for i in range(3)]
            np.testing.assert_array_equal(hist, want_hist)


def test_fasta_joiner_fuzz(tmp_path):
    """Randomized wrap widths (including 1-char lines, empty lines, CRLF,
    headerless continuation across chunk seams) against brute force."""
    rng = np.random.default_rng(41)
    k = 11
    for trial in range(6):
        seqs = []
        for i in range(int(rng.integers(1, 6))):
            L = int(rng.integers(5, 900))
            seqs.append("".join(rng.choice(list("ACGTN"), size=L,
                                           p=[0.24] * 4 + [0.04])))
        fa = tmp_path / f"f{trial}.fa"
        nl = "\r\n" if trial % 2 else "\n"
        with open(fa, "w", newline="") as f:
            for i, s in enumerate(seqs):
                f.write(f">s{i} desc{nl}")
                a = 0
                while a < len(s):
                    w = int(rng.integers(1, 120))
                    f.write(s[a : a + w] + nl)
                    a += w
                    if rng.random() < 0.1:
                        f.write(nl)  # stray empty line inside the record
        want = brute_counts(seqs, k)
        from kmcex.io.fastq import _iter_seq_spans, _segment_spans

        got: Counter = Counter()
        reads = bases = 0
        cb = int(rng.integers(64, 2048))
        for block, s, e, nr, nb in _iter_seq_spans(str(fa), chunk_bytes=cb,
                                                   k=k):
            reads += nr
            bases += nb
            segs = _segment_spans(block, s, e, k, 64)
            if len(segs):
                km = np.asarray(extract.extract_canonical(segs, k)[0])
                got.update(km[km != 0xFFFFFFFFFFFFFFFF].tolist())
        assert got == want, trial
        assert reads == len(seqs)
        assert bases == sum(len(s) for s in seqs)
