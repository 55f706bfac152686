"""FASTQ/FASTA ingestion: files -> fixed-shape 2-bit code batches.

Replaces the input half of the external KMC binary the reference shells out
to (main.cpp:137-140).  Supports plain or gzipped FASTQ/FASTA, a single file
or an ``@list`` file of inputs (README.md:18-19, rs.lst).

Reads are segmented into fixed-length windows with k-1 overlap so every
k-mer window appears in exactly one segment row and all device tensors have
static shapes (XLA requirement).  Non-ACGT bases map to code 255; the
extraction kernel masks windows containing them (the same semantics as KMC
splitting reads at N, kmc_file.cpp:1008-1023).  Multi-line (wrapped) FASTA
records are joined per record with a k-1 carry across parse chunks, so no
k-mer spans are lost at line breaks (the reference CLI is FASTQ-only,
main.cpp:43-46; FASTA support is this rebuild's extension).

Parsing and segmentation are fully vectorized NumPy over ~16MB chunks: the
line scan is one flatnonzero over newline bytes and the segment matrix is one
fancy-indexed gather, so the host side keeps up with the device.
"""

from __future__ import annotations

import gzip
import pathlib
from typing import Iterator

import numpy as np

from kmcex.core.codec import _BASE_LUT

DEFAULT_SEG_LEN = 256
# Batch granularity: finer batches start the first h2d transfer sooner and
# give the at-arrival sort/merge pipeline more overlap slots — measured
# best on the bench workload (65536: 1.45-1.49s, 32768: 1.39s, 16384:
# 1.34s end-to-end; 8192 regresses, its flush-shape variants explode the
# compile set).  ~2M windows per batch at 150bp reads.
DEFAULT_BATCH_SEGS = 16384


def resolve_inputs(input_spec: str) -> list[str]:
    """A path, or '@listfile' with one path per line (reference CLI surface)."""
    if input_spec.startswith("@"):
        paths = []
        for line in pathlib.Path(input_spec[1:]).read_text().splitlines():
            line = line.strip()
            if line:
                paths.append(line)
        return paths
    return [input_spec]


def _open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f, "rb")
    return f


class _RangeFile:
    """Read-window view [start, end) of an uncompressed file: ``read`` clamps
    at ``end``.  Range bounds come from split_byte_ranges, i.e. they are
    record boundaries, so a consumer parsing this window never sees partial
    records."""

    def __init__(self, f, start: int, end: int):
        self._f = f
        self._end = end
        f.seek(start)

    def read(self, n: int = -1) -> bytes:
        remaining = self._end - self._f.tell()
        if remaining <= 0:
            return b""
        if n < 0 or n > remaining:
            n = remaining
        return self._f.read(n)

    def peek(self, n: int = 1) -> bytes:
        pos = self._f.tell()
        b = self.read(n)
        self._f.seek(pos)
        return b

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_input(path: str, byte_range: tuple[int, int] | None = None):
    """Open ``path`` for streaming; with ``byte_range`` (record-aligned, from
    split_byte_ranges) only that window is readable.  Gzipped inputs cannot
    be range-split (no random access) — resolve them whole-file upstream."""
    if byte_range is None:
        return _open_maybe_gzip(path)
    f = open(path, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        raise ValueError(
            f"{path}: gzipped inputs cannot be split by byte range; "
            "assign whole files per host instead"
        )
    return _RangeFile(f, *byte_range)


def _record_start_at_or_after(f, pos: int, size: int, is_fasta: bool) -> int:
    """Absolute offset of the first record start at or after byte ``pos``.

    FASTA: the next line starting with '>'.  FASTQ: the next line starting
    with '@' whose line-after-next starts with '+' — quality lines may begin
    with '@' too, but then the line two later is a sequence line, which never
    begins with '+' (the 4-line record structure disambiguates).  Returns
    ``size`` when no further record exists.

    Streams forward from ``pos`` keeping the invariant that every line start
    inside the scan buffer is preceded by its '\\n' inside the buffer (the
    buffer begins at pos-1), so starts are never missed at chunk seams; the
    buffer is trimmed to the last newline (or to the first still-unresolved
    candidate) each round, bounding memory even for genome-long FASTA lines."""
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    base = pos - 1  # absolute offset of buf[0]
    f.seek(base)
    buf = b""
    eof = False
    marker = ord(">") if is_fasta else ord("@")
    while True:
        if not eof:
            chunk = f.read(1 << 20)
            eof = not chunk
            buf += chunk
        arr = np.frombuffer(buf, dtype=np.uint8)
        nls = np.flatnonzero(arr == 10)
        starts = nls + 1
        starts = starts[starts < len(arr)]
        cand = starts[arr[starts] == marker]
        if is_fasta:
            if len(cand):
                return base + int(cand[0])
        else:
            unresolved = -1
            for c in cand:
                c = int(c)
                j1 = buf.find(b"\n", c)
                j2 = buf.find(b"\n", j1 + 1) if j1 >= 0 else -1
                if j1 < 0 or j2 < 0 or j2 + 1 >= len(buf):
                    if eof:
                        continue  # truncated record at EOF: not a start
                    unresolved = c
                    break
                if buf[j2 + 1] == ord("+"):
                    return base + c
            if unresolved >= 0:
                keep = unresolved - 1  # keep the '\n' preceding the candidate
                base += keep
                buf = buf[keep:]
                continue
        if eof:
            return size
        if len(nls):  # drop fully-scanned lines; keep the final newline
            keep = int(nls[-1])
            base += keep
            buf = buf[keep:]
        elif len(buf) > 1:  # giant line, no newline yet: keep one byte
            base += len(buf) - 1
            buf = buf[-1:]


def split_byte_ranges(path: str, n_parts: int) -> list[tuple[int, int]]:
    """Split one UNCOMPRESSED FASTQ/FASTA file into ``n_parts`` byte ranges
    aligned to record starts (every range begins exactly at a record header,
    ranges cover the file disjointly).  This is how one genome-scale input
    file is divided across hosts without any host parsing the whole thing
    (the reference feeds one file to kmc, main.cpp:137; multi-host data
    parallelism over reads is SURVEY.md §5's design).  Gzip → ValueError."""
    import os

    size = os.path.getsize(path)
    n_parts = max(1, int(n_parts))
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            raise ValueError(f"{path}: cannot byte-range split gzipped input")
        f.seek(0)
        head = f.read(1)
        is_fasta = head == b">"
        bounds = [0]
        for i in range(1, n_parts):
            target = size * i // n_parts
            pos = _record_start_at_or_after(f, target, size, is_fasta)
            bounds.append(max(pos, bounds[-1]))
        bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(n_parts)]


def _join_fasta_records(block: np.ndarray, starts: np.ndarray,
                        ends: np.ndarray, tail: bytes, k: int):
    """Concatenate a chunk's FASTA sequence lines per record into one
    contiguous buffer (wrapped 60-80 column genomes are the normal case;
    round-3 treated every line as its own read, silently losing every
    k-mer spanning a line break — ~40% of windows at 70 cols, k=31).

    ``tail`` is the open record's last k-1 bases from the previous chunk;
    it is prepended when the chunk's first sequence lines continue that
    record, so no window is lost at the chunk seam.  Returns (joined,
    rec_starts, rec_ends, n_records, n_bases, new_tail); n_bases excludes
    the prepended tail (no double counting)."""
    hdr = block[starts] == ord(">")
    seq = ~hdr
    lens = (ends - starts)[seq]
    s_seq = starts[seq]
    n_bases = int(lens.sum())
    rec_of_line = np.cumsum(hdr)[seq]  # 0 = continuation of the open record
    n_records = int(hdr.sum())
    cont = len(rec_of_line) > 0 and rec_of_line[0] == 0
    lead = np.frombuffer(tail if cont else b"", dtype=np.uint8)
    total = len(lead) + n_bases
    joined = np.empty(total, dtype=np.uint8)
    joined[: len(lead)] = lead
    if n_bases:
        # one fancy gather moves every sequence byte (vectorized join)
        line_of_byte = np.repeat(np.arange(len(lens)), lens)
        cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
        idx = s_seq[line_of_byte] + (np.arange(n_bases) - cum[line_of_byte])
        joined[len(lead):] = block[idx]
    if len(rec_of_line) == 0:
        empty = np.zeros(0, dtype=np.int64)
        return joined, empty, empty, n_records, 0, b"" if n_records else tail
    cumlens = np.concatenate([[0], np.cumsum(lens)]) + len(lead)
    new_rec = np.concatenate([[True], rec_of_line[1:] != rec_of_line[:-1]])
    rec_starts = cumlens[:-1][new_rec]
    rec_ends = np.concatenate([rec_starts[1:], [total]]).astype(np.int64)
    rec_starts = rec_starts.astype(np.int64)
    if cont:
        rec_starts[0] = 0  # include the carried k-1 prefix
    # open iff the chunk's LAST line belongs to a sequence (not a header)
    if hdr[-1]:
        new_tail = b""
    else:
        lo = max(int(rec_starts[-1]), total - (k - 1))
        new_tail = joined[lo:total].tobytes()
    return joined, rec_starts, rec_ends, n_records, n_bases, new_tail


def _iter_seq_spans(path: str, chunk_bytes: int = 1 << 24,
                    byte_range: tuple[int, int] | None = None, k: int = 1):
    """Yield (block_bytes, starts, ends, n_reads, n_bases) sequence spans.

    FASTQ: every 4th line starting from line 1, one span per read.
    FASTA: sequence lines JOINED per record (see _join_fasta_records) —
    wrapped multi-line records lose no k-mers; a record continuing across
    a chunk seam reappears as a new span carrying its previous k-1 bases,
    so n_reads/n_bases (records by header / bases excluding carry) are the
    accurate statistics, not len(starts)/sum(ends-starts).
    ``byte_range`` restricts parsing to a record-aligned window (see
    split_byte_ranges).
    """
    with _open_input(path, byte_range) as f:
        head = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if not head:
            head = b"@"
        is_fasta = head == b">"
        carry = b""      # incomplete trailing line
        fa_tail = b""    # FASTA: open record's last k-1 bases
        fastq_phase = 0
        eof = False
        while not eof:
            chunk = f.read(chunk_bytes)
            if not chunk:
                eof = True
                if not carry:
                    break
                data = carry + b"\n"  # flush a final unterminated line
                carry = b""
            else:
                data = carry + chunk
                last_nl = data.rfind(b"\n")
                if last_nl < 0:
                    carry = data
                    continue
                carry = data[last_nl + 1 :]
                data = data[: last_nl + 1]
            block = np.frombuffer(data, dtype=np.uint8)
            nl = np.flatnonzero(block == 10)
            starts = np.empty_like(nl)
            starts[0] = 0
            starts[1:] = nl[:-1] + 1
            ends = nl
            # strip \r for CRLF input
            crlf = (ends > starts) & (block[np.maximum(ends - 1, 0)] == 13)
            ends = ends - crlf.astype(ends.dtype)
            if is_fasta:
                joined, js, je, n_rec, n_b, fa_tail = _join_fasta_records(
                    block, starts, ends, fa_tail, k)
                if len(js) or n_rec:
                    yield joined, js, je, n_rec, n_b
            else:
                n = len(starts)
                keep = (np.arange(n) + fastq_phase) % 4 == 1
                fastq_phase = (fastq_phase + n) % 4
                s, e = starts[keep], ends[keep]
                yield block, s, e, len(s), int((e - s).sum())


def _segment_spans(
    block: np.ndarray, starts: np.ndarray, ends: np.ndarray, k: int, seg_len: int
) -> np.ndarray:
    """Vectorized: cut all sequence spans into overlapping segments and gather
    one [n_segs, seg_len] 2-bit code matrix (255 = pad/N)."""
    stride = seg_len - (k - 1)
    lens = (ends - starts).astype(np.int64)
    ok = lens >= k
    starts, ends, lens = starts[ok], ends[ok], lens[ok]
    if len(starts) == 0:
        return np.zeros((0, seg_len), dtype=np.uint8)
    nseg = (lens - k) // stride + 1
    total = int(nseg.sum())
    read_of_seg = np.repeat(np.arange(len(starts)), nseg)
    cum = np.concatenate([[0], np.cumsum(nseg)[:-1]])
    j = np.arange(total) - cum[read_of_seg]  # segment index within read
    abs_start = starts[read_of_seg] + j * stride
    pos = abs_start[:, None] + np.arange(seg_len)[None, :]
    limit = ends[read_of_seg][:, None]
    safe = np.minimum(pos, len(block) - 1)
    codes = _BASE_LUT[block[safe]]
    return np.where(pos < limit, codes, np.uint8(255))


class SegmentStream:
    """Iterates [batch_segs, seg_len] uint8 code batches over input files,
    tracking read/base statistics.  Uses the native C++ segmenter (single
    pass, writes straight into the yield buffer) with a NumPy fallback.

    With ``packed=True`` (requires seg_len % 8 == 0) batches are
    (packed [batch_segs, seg_len/4], maskbits [batch_segs, seg_len/8])
    tuples in the device transfer format — the native segmenter emits them
    directly from ASCII, so no separate packing pass touches the data."""

    def __init__(self, input_spec: str, k: int, seg_len: int = DEFAULT_SEG_LEN,
                 batch_segs: int = DEFAULT_BATCH_SEGS, use_native: bool = True,
                 packed: bool = False,
                 byte_range: tuple[int, int] | None = None):
        self.input_spec = input_spec
        self.k = k
        self.seg_len = seg_len
        self.batch_segs = batch_segs
        self.use_native = use_native
        self.packed = packed
        self.byte_range = byte_range
        if byte_range is not None:
            assert len(resolve_inputs(input_spec)) == 1, \
                "byte_range applies to a single input file"
        if packed:
            assert seg_len % 8 == 0, "packed mode needs seg_len % 8 == 0"
        self.reads = 0
        self.bases = 0

    def __iter__(self) -> Iterator:
        if self.use_native:
            try:
                from kmcex import native

                native.lib()
                yield from self._iter_native(native)
                return
            except Exception:
                pass
        if self.packed:
            from kmcex.count.extract import pack_codes_np

            for codes in self._iter_numpy():
                yield pack_codes_np(codes)
        else:
            yield from self._iter_numpy()

    def _new_buf(self):
        if self.packed:
            return (
                np.zeros((self.batch_segs, self.seg_len // 4), dtype=np.uint8),
                np.zeros((self.batch_segs, self.seg_len // 8), dtype=np.uint8),
            )
        return np.full((self.batch_segs, self.seg_len), 255, dtype=np.uint8)

    def _segment(self, native, arr, is_fasta, phase, buf, row):
        if self.packed:
            return native.segment_buffer_packed(
                arr, is_fasta, phase, self.k, self.seg_len,
                buf[0][row:], buf[1][row:],
            )
        return native.segment_buffer(
            arr, is_fasta, phase, self.k, self.seg_len, buf[row:]
        )

    def _iter_native(self, native) -> Iterator:
        buf = self._new_buf()
        row = 0
        for path in resolve_inputs(self.input_spec):
            with _open_input(path, self.byte_range) as f:
                head = f.peek(1)[:1] if hasattr(f, "peek") else b""
                is_fasta = head == b">"
                if is_fasta:
                    # FASTA goes through the NumPy record-joiner: the native
                    # segmenter is line-at-a-time, so wrapped (60-80 col)
                    # records would lose every k-mer spanning a line break.
                    # Rows still fill the shared native batch buffer so
                    # mixed FASTQ/FASTA @lists batch seamlessly.
                    buf, row = yield from self._fasta_into_buf(path, buf, row)
                    continue
                phase = 0
                carry = b""
                eof = False
                while not eof:
                    chunk = f.read(1 << 24)
                    if not chunk:
                        eof = True
                        if not carry:
                            break
                        data = carry + b"\n"  # flush a final unterminated line
                        carry = b""
                    else:
                        data = carry + chunk if carry else chunk
                    arr = np.frombuffer(data, dtype=np.uint8)
                    off = 0
                    while off < len(arr):
                        rows, consumed, nr, nb, phase = self._segment(
                            native, arr[off:], is_fasta, phase, buf, row
                        )
                        row += rows
                        self.reads += nr
                        self.bases += nb
                        off += consumed
                        stalled = consumed == 0 and rows == 0
                        if stalled and data.find(b"\n", off) == -1:
                            break  # incomplete tail line -> carry
                        if stalled and row == 0:
                            raise ValueError(
                                "single sequence line needs more than "
                                f"batch_segs={self.batch_segs} segment rows; "
                                "raise batch_segs (whole-genome FASTA lines)"
                            )
                        if row == self.batch_segs or stalled:
                            # buffer full (exactly, or the next read needs
                            # more rows than remain): flush and keep going
                            yield buf
                            buf = self._new_buf()
                            row = 0
                    carry = data[off:] if off < len(data) else b""
        if row:
            yield buf

    def _fasta_into_buf(self, path: str, buf, row: int):
        """Generator: segment one FASTA file (record-joined spans) into the
        shared native batch buffer; yields full buffers, returns the final
        (buf, row)."""
        from kmcex.count.extract import pack_codes_np

        for block, starts, ends, n_reads, n_bases in _iter_seq_spans(
                path, byte_range=self.byte_range, k=self.k):
            self.reads += n_reads
            self.bases += n_bases
            segs = _segment_spans(block, starts, ends, self.k, self.seg_len)
            off = 0
            while off < len(segs):
                take = min(len(segs) - off, self.batch_segs - row)
                part = segs[off : off + take]
                if self.packed:
                    p, mbits = pack_codes_np(part)
                    buf[0][row : row + take] = p
                    buf[1][row : row + take] = mbits
                else:
                    buf[row : row + take] = part
                row += take
                off += take
                if row == self.batch_segs:
                    yield buf
                    buf = self._new_buf()
                    row = 0
        return buf, row

    def _iter_numpy(self) -> Iterator[np.ndarray]:
        pend: list[np.ndarray] = []
        pend_rows = 0
        for path in resolve_inputs(self.input_spec):
            for block, starts, ends, n_reads, n_bases in _iter_seq_spans(
                    path, byte_range=self.byte_range, k=self.k):
                self.reads += n_reads
                self.bases += n_bases
                segs = _segment_spans(block, starts, ends, self.k, self.seg_len)
                if len(segs) == 0:
                    continue
                pend.append(segs)
                pend_rows += len(segs)
                while pend_rows >= self.batch_segs:
                    cat = pend[0] if len(pend) == 1 else np.concatenate(pend)
                    yield cat[: self.batch_segs]
                    rest = cat[self.batch_segs :]
                    pend = [rest] if len(rest) else []
                    pend_rows = len(rest)
        if pend_rows:
            cat = pend[0] if len(pend) == 1 else np.concatenate(pend)
            pad = np.full((self.batch_segs - pend_rows, self.seg_len), 255, dtype=np.uint8)
            yield np.concatenate([cat, pad])


def segment_batches(input_spec: str, k: int, seg_len: int = DEFAULT_SEG_LEN,
                    batch_segs: int = DEFAULT_BATCH_SEGS) -> SegmentStream:
    return SegmentStream(input_spec, k, seg_len, batch_segs)


def sniff_read_length(input_spec: str, max_reads: int = 10000) -> int:
    """Median sequence length over the first reads (to pick a segment length
    that wastes no window slots on padding)."""
    lens: list[np.ndarray] = []
    seen = 0
    for path in resolve_inputs(input_spec):
        for _, starts, ends, n_reads, _b in _iter_seq_spans(
                path, chunk_bytes=1 << 22):
            lens.append(ends - starts)
            seen += n_reads
            if seen >= max_reads:
                break
        break
    if not lens:
        return DEFAULT_SEG_LEN
    return int(np.median(np.concatenate(lens)))
