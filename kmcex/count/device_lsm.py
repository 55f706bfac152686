"""Device-resident accumulation of (k-mer, count) runs.

Two-level design that keeps every sort on the device and sends only the
final table over the host link:

  * **Raw tier** — per input batch only the fused extract kernel runs; the
    flat canonical k-mer vectors stay in HBM unsorted.  When the tier
    reaches ``raw_tier_elems`` k-mers it is concatenated and collapsed by
    ONE sort + segment-count pass.  Counting per 8M batch and pairwise
    merging (the previous scheme) sorted every element ~6x; a large tier
    sorts each element ~2x (count pass + at most one merge per LSM level).
  * **LSM runs** — collapsed tiers are sorted unique runs, merged pairwise
    (concat -> sort -> segment-sum) whenever two reach the same size
    class, exactly like an LSM tree.  Memory stays bounded for
    genome-scale inputs while merge cost is amortized.

Only the final merged table is pulled to the host, counts narrowed to
uint16 when ``cs`` fits (half the transfer bytes; counters clamp to cs
anyway, kmodel.hpp:675).

Segment counts use the scatter-free formulation of
count/extract.sort_count_unique (compact run-boundary positions, diff
them); only the run-MERGE kernels still use prefix sums + reverse cummin,
because merged counts are sums of partial counts, not run lengths.  The number of distinct compiled shapes is logarithmic (power-of-two
sizes only) plus one per distinct batches-per-tier count (bounded by
``raw_tier_elems // batch_elems``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from kmcex.count.extract import (
    SENTINEL,
    extract_canonical,
    extract_canonical_packed,
    segment_compact,
    sort_count_unique,
    sorted_u64,
    sorted_u64_with_payload,
)


@jax.jit
def _merge_runs_kernel(ka, ca, kb, cb):
    """Merge two sorted (kmer, count) runs (SENTINEL-padded), summing
    duplicates; result padded to len(ka)+len(kb).  The merge is concat +
    one (key, count) sort."""
    k = jnp.concatenate([ka, kb])
    c = jnp.concatenate([ca, cb]).astype(jnp.uint32)
    k, c = sorted_u64_with_payload(k, c)
    n = k.shape[0]
    idxs = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), k[1:] != k[:-1]])
    valid = first & (k != SENTINEL)
    n_real = jnp.sum(k != SENTINEL, dtype=jnp.int32)
    # segment count sums via cumsum differencing at boundaries
    csum = jnp.cumsum(c, dtype=jnp.uint64)
    bpos = jnp.where(first, idxs, n)
    next_b = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.concatenate([bpos[1:], jnp.array([n], jnp.int32)])))
    )
    seg_end = jnp.minimum(next_b, n_real)  # exclusive
    start_excl = jnp.where(idxs > 0, csum[jnp.maximum(idxs - 1, 0)], 0)
    seg_sum = csum[jnp.maximum(seg_end - 1, 0)] - start_excl
    seg_sum = jnp.where(seg_end > idxs, seg_sum, 0)
    counts = jnp.where(valid, seg_sum, 0)
    # saturate at uint32 (counters clamp to cs far below this anyway)
    counts32 = jnp.minimum(counts, jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    key = jnp.where(valid, k, SENTINEL)
    n_unique = jnp.sum(valid, dtype=jnp.int32)
    uniq, counts_c = sorted_u64_with_payload(key, counts32)
    counts_c = jnp.where(idxs < n_unique, counts_c, 0)
    return uniq, counts_c, n_unique


@functools.partial(jax.jit, static_argnums=(1,))
def _extract_kernel(codes, k: int):
    """Fused extract -> canonicalize; the flat k-mer vector stays in HBM."""
    kmers, _ = extract_canonical(codes, k)
    return kmers


@functools.partial(jax.jit, static_argnums=(2,))
def _extract_kernel_packed(packed, maskbits, k: int):
    kmers, _ = extract_canonical_packed(packed, maskbits, k)
    return kmers


@jax.jit
def _collapse_kernel(kmers_list):
    """Concat a raw tier and collapse to a sorted unique run."""
    flat = jnp.concatenate(kmers_list) if len(kmers_list) > 1 else kmers_list[0]
    uniq, counts, n_unique = sort_count_unique(flat)
    return uniq, counts, n_unique.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _pack_final(kmers, counts, cs: int, narrow: bool):
    c = jnp.minimum(counts, jnp.uint32(cs))
    if narrow:
        c = c.astype(jnp.uint16)
    return kmers, c


@functools.partial(jax.jit, static_argnums=(3,))
def _final_stats(kmers, counts, ci, n_rows: int = 1):
    """One fused pass over the final table: encode-sizing stats (the
    reference's pass 1, kmodel.hpp:423-434) plus the delta-transfer
    parameters, packed into ONE flat u64 vector so a SINGLE host pull
    decides everything before table bytes move (each blocking
    device->host pull is a host sync; one pull keeps the finalize to one).

    Layout: [0]=total pairs >= ci, [1:4]=histogram of counter==ci+i,
    [4]=n_real, [5]=first k-mer, [6]=first count, [7]=last k-mer,
    [8]=last count, [9:9+R]=per-row max delta, [9+R:9+2R]=per-row max
    count.  Per-row maxima let each transfer row use its own bit width:
    canonical k-mers (min of fwd/rc) thin out near the top of the key
    space, so a global width would waste a byte per entry."""
    valid = (kmers != SENTINEL) & (counts >= ci)
    total = jnp.sum(valid, dtype=jnp.int64)
    hist = jnp.stack(
        [jnp.sum(valid & (counts == ci + i), dtype=jnp.int64) for i in range(3)]
    )
    real = kmers != SENTINEL  # contiguous prefix: sentinels sort last
    n_real = jnp.sum(real, dtype=jnp.int64)
    idx = jnp.arange(kmers.shape[0])
    prev = jnp.concatenate([kmers[:1], kmers[:-1]])
    gap = jnp.where(real & (idx > 0), kmers - prev, 0)
    row_gap_max = jnp.max(gap.reshape(n_rows, -1), axis=1)
    cnt = jnp.where(real, counts, 0)
    row_cnt_max = jnp.max(cnt.reshape(n_rows, -1), axis=1)
    last_i = jnp.maximum(n_real - 1, 0)
    return jnp.concatenate([
        jnp.stack([
            total.astype(jnp.uint64),
            hist[0].astype(jnp.uint64),
            hist[1].astype(jnp.uint64),
            hist[2].astype(jnp.uint64),
            n_real.astype(jnp.uint64),
            kmers[0],
            counts[0].astype(jnp.uint64),
            kmers[last_i],
            counts[last_i].astype(jnp.uint64),
        ]),
        row_gap_max,
        row_cnt_max.astype(jnp.uint64),
    ])


@functools.partial(jax.jit, static_argnums=(3,))
def _fused_finalize(kmers_list, ci, cs, n_rows: int):
    """The whole single-tier finalize as ONE device program: concat the raw
    tier, sort, segment-count duplicates, compact, cs-clamp, and compute
    the flat stats vector.  One dispatch + one small pull.

    Counts are cs-clamped HERE: the reference's counters are clamped when
    its kmc binary writes the database, so every downstream consumer — the
    sizing histogram, the Bloom feed, the low drop, the transfer — must see
    clamped values; matching on raw counts diverges whenever
    cs < ci + bf_num."""
    flat = jnp.concatenate(kmers_list) if len(kmers_list) > 1 else kmers_list[0]
    u, c, _ = segment_compact(sorted_u64(flat))
    c = jnp.minimum(c, cs)
    return u, c, _final_stats(u, c, ci, n_rows)


def _drop_compact(u, c, thresh, n_rows: int):
    """Shared tail of the low-drop: mask counts < thresh, recompact,
    restat (see _drop_below for why low keys leave the transfer)."""
    mask = c >= thresh
    ks = jnp.where(mask, u, SENTINEL)
    cs_ = jnp.where(mask, c, 0)
    u2, c2 = sorted_u64_with_payload(ks, cs_)
    return u2, c2, _final_stats(u2, c2, thresh, n_rows)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _fused_finalize_drop(kmers_list, ci, cs, thresh: int, n_rows: int):
    """_fused_finalize with the model-only path's low-key drop FOLDED into
    the same program: returns the full table (for the device Bloom feed)
    AND the dropped/recompacted transfer table with its own stats — one
    dispatch, one less blocking stats roundtrip than the two-program
    shape."""
    flat = jnp.concatenate(kmers_list) if len(kmers_list) > 1 else kmers_list[0]
    u, c, _ = segment_compact(sorted_u64(flat))
    c = jnp.minimum(c, cs)
    stats = _final_stats(u, c, ci, n_rows)
    u2, c2, stats2 = _drop_compact(u, c, jnp.uint32(thresh), n_rows)
    return u, c, u2, c2, jnp.concatenate([stats, stats2])


@jax.jit
def _sorted_boundary(kmers_list, ci, cs):
    """Concat + sort the raw tier and mark run boundaries WITHOUT compacting:
    returns (key, counts, gstats) where duplicate/masked slots hold
    (SENTINEL, 0), boundary slots hold (k-mer, run length), and ``gstats``
    is [total >= ci, hist(ci), hist(ci+1), hist(ci+2)] — the reference's
    pass-1 sizing numbers (kmodel.hpp:423-434), fused here so ONE dispatch +
    one small pull covers sort + stats.  The compaction itself is deferred
    so it can run per SEGMENT, overlapping the host encode (see
    DeviceCountAccumulator._segmented_stream)."""
    flat = jnp.concatenate(kmers_list) if len(kmers_list) > 1 else kmers_list[0]
    return _boundary_mark(sorted_u64(flat), ci, cs)


def _boundary_mark(s, ci, cs):
    n = s.shape[0]
    idxs = jnp.arange(n, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    valid = first & (s != SENTINEL)
    n_real = jnp.sum(s != SENTINEL, dtype=jnp.int32)
    bpos = jnp.where(first, idxs, n)
    next_b = jnp.flip(jax.lax.cummin(jnp.flip(
        jnp.concatenate([bpos[1:], jnp.array([n], jnp.int32)]))))
    run_len = jnp.minimum(next_b, n_real) - idxs
    counts = jnp.minimum(jnp.where(valid, run_len, 0).astype(jnp.uint32),
                         cs)  # reference counters are cs-clamped at source
    key = jnp.where(valid, s, SENTINEL)
    total = jnp.sum(counts >= ci, dtype=jnp.int64)
    hist = [jnp.sum(counts == ci + i, dtype=jnp.int64) for i in range(3)]
    return key, counts, jnp.stack([total, *hist])


@functools.partial(jax.jit, static_argnums=(3, 4))
def _compact_seg(key, cnt, q, seg_len: int, n_rows: int, ci=1):
    """Compact ONE segment [q*seg_len, (q+1)*seg_len) of the boundary-marked
    arrays and compute its stats vector.  ``q`` is traced (one compiled
    program serves every segment)."""
    ks = jax.lax.dynamic_slice(key, (q * seg_len,), (seg_len,))
    cs_ = jax.lax.dynamic_slice(cnt, (q * seg_len,), (seg_len,))
    u, c = sorted_u64_with_payload(ks, cs_)
    nu = jnp.sum(ks != SENTINEL, dtype=jnp.int32)
    c = jnp.where(jnp.arange(seg_len) < nu, c, 0)
    return u, c, _final_stats(u, c, ci, n_rows)


# Standalone jit of the shared drop tail (used by the runs-path fallback
# where the drop is not folded into a fused finalize).  Drops every entry
# with count < thresh: low-count keys whose Bloom insertion happened ON
# DEVICE never need to cross the host link, and for ci>1 the sub-ci keys
# the decode would discard anyway stop traveling too.  Counts must already
# be cs-clamped (the fused programs clamp right after compaction).
_drop_below = functools.partial(jax.jit, static_argnums=(3,))(_drop_compact)


def _pack_bits(vals: jnp.ndarray, width: int) -> jnp.ndarray:
    """Pack ``vals`` (uint64, each < 2**width, len % 8 == 0) into a dense
    little-endian bitstream: each group of 8 values becomes exactly
    ``width`` bytes (value a of a group occupies stream bits
    [a*width, (a+1)*width)).  Static unroll over the width byte lanes —
    every lane is one full-vector shift/or, which XLA fuses."""
    g = vals.reshape(-1, 8)
    lanes = []
    for j in range(width):
        lo_bit = 8 * j
        b = jnp.zeros((g.shape[0],), jnp.uint64)
        a = lo_bit // width
        while a < 8 and a * width < lo_bit + 8:
            sh = lo_bit - a * width
            if sh >= 0:
                b = b | (g[:, a] >> jnp.uint64(sh))
            else:
                b = b | (g[:, a] << jnp.uint64(-sh))
            a += 1
        lanes.append(b.astype(jnp.uint8))
    return jnp.stack(lanes, axis=1).reshape(-1)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _pack_span(kmers, counts, start, m: int, wbits: int, cbits: int, cs: int):
    """Bit-pack one span of ``m`` entries starting at traced offset
    ``start``: consecutive-k-mer deltas at ``wbits`` bits each plus
    cs-clamped counts at ``cbits`` bits.  The native
    kx_unpack_deltas/kx_unpack_counts reverse this at memory speed.

    ``start`` is TRACED and ``m`` comes from a fixed granule ladder
    (_pack_plan), so the jit key (m, wbits, cbits, cs) is INDEPENDENT of
    the table's size and content — the round-3 fused pack was keyed on
    the full data-dependent per-row spec tuple, which recompiled a
    5-16 SECOND monolith for every new dataset."""
    seg = jax.lax.dynamic_slice(kmers, (start,), (m,))
    prev = jnp.where(start > 0, kmers[jnp.maximum(start - 1, 0)], seg[0])
    d = seg - jnp.concatenate([prev[None], seg[:-1]])
    # zero pad-region deltas: a SENTINEL-sized delta would overflow its
    # wbits slot and corrupt neighbouring lanes in the same 8-group
    d = jnp.where(seg == SENTINEL, jnp.uint64(0), d)
    kb = _pack_bits(d, wbits)
    c = jnp.minimum(jax.lax.dynamic_slice(counts, (start,), (m,)),
                    jnp.uint32(cs)).astype(jnp.uint64)
    cb = _pack_bits(c, cbits)
    return kb, cb


# Packing granule: 2^18-entry spans keep the pull pipeline fine-grained
# (first chunk reaches the encoder after ~1.5MB, not ~7MB) and bound the
# padded-slot waste past n_real to < 2^18 entries.  A coarser 2^20 granule
# measured SLOWER end-to-end (+0.15s chunk_wait): fewer, larger pull
# groups delay the encoder's first chunk more than the saved dispatches.
PACK_SPAN_ELEMS = 1 << 18
PACK_TAIL_ELEMS = 1 << 18


def _pack_plan(size: int, n_real: int, row_gap, row_cnt, n_rows: int,
               cs: int) -> list[tuple[int, int, int, int]]:
    """Spans covering [0, ~n_real) on the fixed granule ladder: coarse
    PACK_SPAN_ELEMS spans then PACK_TAIL_ELEMS tail spans.  Each span's
    (start, m, wbits, cbits); widths are maxima over the _final_stats row
    granules the span covers, rounded up to a multiple of 4."""
    stat_m = size // n_rows
    plan = []
    start = 0
    while start < n_real:
        m = PACK_SPAN_ELEMS
        if m > size or start + m > ((n_real + PACK_TAIL_ELEMS - 1)
                                    // PACK_TAIL_ELEMS) * PACK_TAIL_ELEMS:
            m = min(PACK_TAIL_ELEMS, size)
        g0 = start // stat_m
        g1 = min(-(-(start + m) // stat_m), n_rows)
        gap = max(int(row_gap[g]) for g in range(g0, g1))
        cnt = min(max(int(row_cnt[g]) for g in range(g0, g1)), cs)
        wbits = min(64, -(-max(1, gap.bit_length()) // 4) * 4)
        cbits = min(32, -(-max(1, cnt.bit_length()) // 4) * 4)
        plan.append((start, m, wbits, cbits))
        start += m
    return plan


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# Resolved once at import (trace-time flags inside jitted callers would be
# frozen by the jit cache anyway).  KMCEX_SEGMENTED_FINALIZE=1 opts into the
# per-segment finalize whose compact/pack/pull overlaps the host encode.
# DEFAULT OFF: the fused path's async sliced pulls already stream into
# the encode, so segmentation only adds per-segment stats-pull sync
# points.  Kept as an opt-in diagnostic, not a perf path (see
# tests/test_plain_sort.py::test_segmented_finalize).
import os as _os

_SEGMENTED_FINALIZE = _os.environ.get("KMCEX_SEGMENTED_FINALIZE", "0") == "1"


def write_run_file(path: str, ku: np.ndarray, kc: np.ndarray) -> None:
    """Spill one sorted (kmers, counts) run: u64 length, u64 keys, u32
    counts (shared by the single-chip and sharded disk tiers)."""
    with open(path, "wb") as f:
        np.array([len(ku)], dtype="<u8").tofile(f)
        ku.astype("<u8").tofile(f)
        kc.astype("<u4").tofile(f)


def open_run_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Memmap a spilled run (see write_run_file)."""
    n = int(np.fromfile(path, dtype="<u8", count=1)[0])
    km = np.memmap(path, dtype="<u8", mode="r", offset=8, shape=(n,))
    cm = np.memmap(path, dtype="<u4", mode="r", offset=8 + 8 * n, shape=(n,))
    return km, cm


def one_pass_finalize(sources, ci: int, cs: int, disk_dir: str | None,
                      cleanup=None):
    """ONE k-way merge pass over sorted unique runs: computes the encode
    sizing stats (total >= ci, low-counter histogram) while spooling the
    merged table — to ``<disk_dir>/merged_*.bin`` when a disk dir is given
    (the out-of-core regime) or to a RAM chunk list otherwise.  Returns
    (total, hist, chunk_iter); the iterator yields ascending ci-filtered
    cs-clamped (kmers, counts) chunks and runs ``cleanup`` when exhausted
    or closed.  Replaces the merge-twice structure (stats pass + fresh
    re-merge) that doubled the dominant I/O on the genome-scale path."""
    import os

    total = 0
    hist = np.zeros(3, dtype=np.int64)
    if disk_dir is not None:
        os.makedirs(disk_dir, exist_ok=True)
        kpath = os.path.join(disk_dir, "merged_k.bin")
        cpath = os.path.join(disk_dir, "merged_c.bin")
        n_all = 0
        with open(kpath, "wb") as fk, open(cpath, "wb") as fc:
            for mk, mc in DeviceCountAccumulator._merge_streams(sources):
                mcc = np.minimum(mc, np.uint32(cs))  # reference counters
                total += int(np.count_nonzero(mcc >= ci))  # are cs-clamped
                for i in range(3):
                    hist[i] += int(np.count_nonzero(mcc == ci + i))
                n_all += len(mk)
                mk.astype("<u8").tofile(fk)
                mc.astype("<u4").tofile(fc)
        if n_all == 0:
            if cleanup is not None:
                cleanup()
            return 0, hist, iter(())
        km = np.memmap(kpath, dtype="<u8", mode="r", shape=(n_all,))
        cm = np.memmap(cpath, dtype="<u4", mode="r", shape=(n_all,))

        def chunks(m: int = 1 << 22):
            try:
                for a in range(0, n_all, m):
                    ku = np.asarray(km[a : a + m])
                    kc = np.asarray(cm[a : a + m])
                    keep = kc >= ci
                    yield ku[keep], np.minimum(kc[keep], np.uint32(cs))
            finally:
                if cleanup is not None:
                    cleanup()

        return total, hist, chunks()
    # all-RAM regime: one pass accumulates the merged chunks directly.
    # Chunks are stored ci-filtered and cs-clamped so the retained copy is
    # the final table, not the raw merge output — peak host memory is the
    # source runs plus the (smaller) filtered table, never both unfiltered.
    parts = []
    for mk, mc in DeviceCountAccumulator._merge_streams(sources):
        mc = np.minimum(mc, np.uint32(cs))  # clamp before hist/total too
        total += int(np.count_nonzero(mc >= ci))
        for i in range(3):
            hist[i] += int(np.count_nonzero(mc == ci + i))
        keep = mc >= ci
        if keep.any():
            parts.append((mk[keep], np.minimum(mc[keep], np.uint32(cs))))

    def ram_chunks():
        try:
            yield from parts
        finally:
            if cleanup is not None:
                cleanup()

    return total, hist, ram_chunks()


def _decode_filter(meta, ci: int):
    """Decode one _pack_run meta into ascending ci-filtered (kmers, counts)
    chunks (counts in the packed stream are already cs-clamped)."""
    for ku, kc in DeviceCountAccumulator._decode_run(meta):
        keep = kc >= ci
        if keep.any():
            yield ku[keep], kc[keep]


def _row_count(size: int, max_rows: int = 128) -> int:
    """Largest power-of-two row count <= max_rows such that rows divide
    ``size`` into whole 8-groups (the _pack_bits unit)."""
    r = max_rows
    while r > 1 and (size % r or (size // r) % 8):
        r //= 2
    return r


class DeviceCountAccumulator:
    """Accumulates batches on device; one host transfer at finalize."""

    # Device-memory sizes below were first chosen for a 16 GB card; they
    # fit well inside the ~60 GB JAX reserves on an 80 GB H100 and are
    # kept until measurement says a larger tier pays.
    # Raw k-mers buffered on the device before one sort+count pass (512MB
    # at u64; the finalize sort over it needs a few times that in scratch).
    RAW_TIER_ELEMS = 64 << 20
    # Below this size, merges stay fully async (no host sync to learn the
    # unique count); above it, one scalar sync lets us shrink the pad so
    # memory and future merge cost track the true distinct-k-mer count.
    SHRINK_THRESHOLD = 1 << 23
    # Runs at or above this many entries leave the device: pulled to host
    # RAM and merged there by the native two-pointer merge.  Genome-scale
    # tables (NA12878 31-mers: billions of distinct k-mers) cannot live on
    # one chip; the device stays a fast "memtable" level of the LSM.
    SPILL_THRESHOLD = 128 << 20
    # Host-RAM budget for the host LSM level.  When spilled runs exceed it,
    # the largest run streams to a temp file and drops out of RAM; the
    # finalize merges disk + RAM runs out-of-core (the analogue of KMC's
    # external-memory bins — the reference delegates this regime to the
    # kmc binary, SURVEY.md §5 "long-context" row).  Override with
    # KMCEX_DISK_SPILL_BYTES (0 disables disk spill).
    DISK_SPILL_BYTES = 16 << 30

    def __init__(self, k: int, raw_tier_elems: int | None = None,
                 spill_threshold: int | None = None,
                 disk_spill_bytes: int | None = None,
                 disk_dir: str | None = None):
        import os as _os

        self.k = k
        self.raw_tier_elems = (raw_tier_elems
                               or int(_os.environ.get("KMCEX_RAW_TIER_ELEMS", 0))
                               or self.RAW_TIER_ELEMS)
        self.spill_threshold = (spill_threshold
                                or int(_os.environ.get(
                                    "KMCEX_SPILL_THRESHOLD", 0))
                                or self.SPILL_THRESHOLD)
        if disk_spill_bytes is None:
            disk_spill_bytes = int(_os.environ.get(
                "KMCEX_DISK_SPILL_BYTES", self.DISK_SPILL_BYTES))
        self.disk_spill_bytes = disk_spill_bytes
        self._disk_dir_arg = disk_dir
        self._disk_dir: str | None = None
        self.disk_runs: list[str] = []
        self.raw: list[jnp.ndarray] = []
        self.raw_elems = 0
        self.runs: list[tuple[jnp.ndarray, jnp.ndarray, int]] = []  # (k, c, size)
        self.host_runs: list[tuple[np.ndarray, np.ndarray]] = []
        self.total_windows = 0
        # set by finalize_stream when a bloom_factory ran on this table
        self.device_bloom = None
        # tier-transition telemetry (surfaced via KMCEX_STATS_JSON)
        self.tier_events = {"raw_collapses": 0, "device_merges": 0,
                            "host_spills": 0, "disk_spills": 0}

    def add_batch(self, codes) -> None:
        n_windows = codes.shape[0] * (codes.shape[1] - self.k + 1)
        kmers = _extract_kernel(codes, self.k)
        self._push_raw(kmers, n_windows)

    def add_batch_packed(self, packed, maskbits) -> None:
        """2-bit packed input (see extract.pack_codes_np): L = 4 * packed
        width."""
        L = packed.shape[1] * 4
        n_windows = packed.shape[0] * (L - self.k + 1)
        kmers = _extract_kernel_packed(packed, maskbits, self.k)
        self._push_raw(kmers, n_windows)

    def _push_raw(self, kmers, n_windows: int) -> None:
        self.total_windows += n_windows
        self.raw.append(kmers)
        self.raw_elems += n_windows
        if self.raw_elems >= self.raw_tier_elems:
            self._collapse_raw()

    def _collapse_raw(self) -> None:
        self.tier_events["raw_collapses"] += 1
        if not self.raw:
            return
        uniq, counts, nu = _collapse_kernel(self.raw)
        self.raw = []
        self.raw_elems = 0
        self._after_collapse(uniq, counts, nu)

    def _after_collapse(self, uniq, counts, nu) -> None:
        size = uniq.shape[0]
        if size >= self.SHRINK_THRESHOLD:
            shrunk = _next_pow2(max(int(nu), 1))  # scalar device sync
            if shrunk < size:
                uniq, counts = uniq[:shrunk], counts[:shrunk]
                size = shrunk
        # runs must be pow2-padded so merge shape classes stay logarithmic
        psize = _next_pow2(size)
        if psize != size:
            pad = psize - size
            uniq = jnp.concatenate([uniq, jnp.full((pad,), SENTINEL, jnp.uint64)])
            counts = jnp.concatenate([counts, jnp.zeros((pad,), jnp.uint32)])
            size = psize
        if size >= self.spill_threshold:
            self._spill(uniq, counts)
        else:
            self.runs.append((uniq, counts, size))
            self._rebalance()

    def _merge_top2(self) -> None:
        self.tier_events["device_merges"] += 1
        kb, cb, sb = self.runs.pop()
        ka, ca, sa = self.runs.pop()
        u, c, nu = _merge_runs_kernel(ka, ca, kb, cb)
        size = sa + sb
        if size >= self.SHRINK_THRESHOLD:
            shrunk = _next_pow2(max(int(nu), 1))  # scalar device sync
            if shrunk < size:
                u, c = u[:shrunk], c[:shrunk]
                size = shrunk
        if size >= self.spill_threshold:
            self._spill(u, c)
        else:
            self.runs.append((u, c, size))

    def _spill(self, u, c) -> None:
        """Pull a device run to host RAM and fold it into the host LSM level
        (native two-pointer merge; raw counts — ci/cs apply at finalize)."""
        ku = np.asarray(u)
        kc = np.asarray(c).astype(np.uint32, copy=False)
        real = ku != np.uint64(0xFFFFFFFFFFFFFFFF)
        ku, kc = ku[real], kc[real]
        if not len(ku):
            return
        self.tier_events["host_spills"] += 1
        self.host_runs.append((ku, kc))
        from kmcex import native

        while (len(self.host_runs) >= 2
               and len(self.host_runs[-2][0]) < 2 * len(self.host_runs[-1][0])):
            kb, cb = self.host_runs.pop()
            ka, ca = self.host_runs.pop()
            self.host_runs.append(native.merge_runs(ka, ca, kb, cb))
        self._maybe_spill_to_disk()

    # -- disk tier (out-of-core runs) ------------------------------------
    def _host_bytes(self) -> int:
        return sum(12 * len(k) for k, _ in self.host_runs)

    def _maybe_spill_to_disk(self) -> None:
        if not self.disk_spill_bytes:
            return
        while self.host_runs and self._host_bytes() > self.disk_spill_bytes:
            # the size-tiered cascade keeps host_runs largest-first
            self._write_disk_run(*self.host_runs.pop(0))

    def _write_disk_run(self, ku: np.ndarray, kc: np.ndarray) -> None:
        self.tier_events["disk_spills"] += 1
        import os
        import tempfile

        if self._disk_dir is None:
            self._disk_dir = self._disk_dir_arg or tempfile.mkdtemp(
                prefix="kmcex_lsm_")
        os.makedirs(self._disk_dir, exist_ok=True)
        path = os.path.join(self._disk_dir, f"run{len(self.disk_runs):04d}.bin")
        write_run_file(path, ku, kc)
        self.disk_runs.append(path)

    @staticmethod
    def _open_disk_run(path: str) -> tuple[np.ndarray, np.ndarray]:
        return open_run_file(path)

    @staticmethod
    def _merge_streams(runs, chunk_elems: int = 1 << 22):
        """K-way streaming merge of sorted unique (kmers, counts) runs
        (arrays or memmaps), summing duplicate keys; yields ascending
        chunks.  Per step: pick the smallest per-run window-max as the key
        bound, take everything <= bound from EVERY run (so each key's
        occurrences across runs land in one step), and fold pairwise with
        the native two-pointer merge."""
        from kmcex import native

        curs = [0] * len(runs)
        while True:
            active = [i for i in range(len(runs)) if curs[i] < len(runs[i][0])]
            if not active:
                return
            bound = min(
                runs[i][0][min(curs[i] + chunk_elems, len(runs[i][0])) - 1]
                for i in active
            )
            mk = mc = None
            for i in active:
                hi = int(np.searchsorted(runs[i][0], bound, side="right"))
                ku = np.asarray(runs[i][0][curs[i]:hi], dtype=np.uint64)
                kc = np.asarray(runs[i][1][curs[i]:hi]).astype(np.uint32,
                                                               copy=False)
                curs[i] = hi
                if not len(ku):
                    continue
                if mk is None:
                    mk, mc = ku, kc
                else:
                    mk, mc = native.merge_runs(mk, mc, ku, kc)
            if mk is not None and len(mk):
                yield mk, mc

    def _finalize_disk(self, ci: int, cs: int):
        """Out-of-core finalize when disk runs exist: one k-way merge pass
        computes totals and spools the merged table to ONE file; the
        returned iterator then streams it with ci/cs applied.  Host memory
        stays bounded by (n_runs + 1) merge chunks.  Run files are deleted
        as soon as the merge pass consumed them; the merged files (and the
        temp dir, when we created it) are deleted when the returned
        iterator is exhausted or closed — see also close()."""
        import os

        runs = [self._open_disk_run(p) for p in self.disk_runs]
        runs += [(k, c) for k, c in self.host_runs]
        total, hist, it = one_pass_finalize(runs, ci, cs, self._disk_dir,
                                            cleanup=self.close)
        del runs  # drop the memmaps so the run files can be unlinked
        self.host_runs = []
        for p in self.disk_runs:
            try:
                os.unlink(p)
            except OSError:
                pass
        self.disk_runs = []
        return total, hist, it

    def close(self) -> None:
        """Delete any disk-tier files this accumulator created (run files,
        merged files, and the mkdtemp dir when we own it).  Idempotent;
        safe to call whether or not a finalize ran."""
        import os
        import shutil

        for p in self.disk_runs:
            try:
                os.unlink(p)
            except OSError:
                pass
        self.disk_runs = []
        if self._disk_dir is not None:
            for name in ("merged_k.bin", "merged_c.bin"):
                try:
                    os.unlink(os.path.join(self._disk_dir, name))
                except OSError:
                    pass
            if self._disk_dir_arg is None:
                shutil.rmtree(self._disk_dir, ignore_errors=True)
            self._disk_dir = None

    # -- checkpoint / resume ----------------------------------------------
    # The reference has NO mid-build persistence (builds are not resumable,
    # SURVEY.md §5 "Checkpoint / resume"); at genome scale a multi-hour
    # count needs one.  Every tier of this accumulator is already a set of
    # sorted (kmers, counts) runs, so a checkpoint is: drain the device
    # tiers to host, write each run as a run file, then the manifest LAST
    # (a crash mid-checkpoint leaves no manifest -> no torn state).
    def checkpoint(self, ckpt_dir: str, extra: dict | None = None) -> None:
        """Persist the full counting state to ``ckpt_dir``; counting can
        continue afterwards (the device tiers drain but the accumulator
        stays valid).  ``extra`` rides along in the manifest (the pipeline
        stores its stream position there, see pipeline.count_encode
        ckpt_dir)."""
        import json
        import os
        import shutil

        os.makedirs(ckpt_dir, exist_ok=True)
        self._merge_device_runs()
        if self.runs:
            u, c, _ = self.runs.pop()
            self._spill(u, c)
        # Each checkpoint writes a NEW file generation: a restored
        # accumulator holds read-only memmaps of the previous generation's
        # files, so overwriting them in place would SIGBUS the reader.
        # Stale generations are unlinked only AFTER the new manifest lands
        # (open memmaps keep the inodes alive; a crash in between just
        # leaks files the next checkpoint cleans up).
        gen = getattr(self, "_ckpt_gen", 0)
        files = []
        for i, (ku, kc) in enumerate(self.host_runs):
            name = f"g{gen:04d}_run{i:04d}.bin"
            write_run_file(os.path.join(ckpt_dir, name), np.asarray(ku),
                           np.asarray(kc))
            files.append(name)
        for p in self.disk_runs:
            name = f"g{gen:04d}_disk_{os.path.basename(p)}"
            shutil.copyfile(p, os.path.join(ckpt_dir, name))
            files.append(name)
        tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"k": self.k, "total_windows": self.total_windows,
                       "files": files, "gen": gen, "extra": extra or {}}, f)
        os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))
        self._ckpt_gen = gen + 1
        keep = set(files) | {"manifest.json"}
        for name in os.listdir(ckpt_dir):
            if name not in keep and name.endswith(".bin"):
                try:
                    os.unlink(os.path.join(ckpt_dir, name))
                except OSError:
                    pass

    @staticmethod
    def read_manifest(ckpt_dir: str) -> dict | None:
        """The checkpoint manifest, or None when ``ckpt_dir`` holds no
        complete checkpoint (a crash mid-checkpoint leaves no manifest)."""
        import json
        import os

        try:
            with open(os.path.join(ckpt_dir, "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @classmethod
    def restore(cls, ckpt_dir: str, **kwargs) -> "DeviceCountAccumulator":
        """Rebuild an accumulator from ``checkpoint``; more batches may be
        added before finalize.  Runs load as read-only memmaps (lazily
        paged — restoring does not pull the table into RAM); checkpoint
        files are never modified or deleted."""
        import json
        import os

        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            m = json.load(f)
        acc = cls(int(m["k"]), **kwargs)
        acc.total_windows = int(m["total_windows"])
        acc.host_runs = [open_run_file(os.path.join(ckpt_dir, name))
                         for name in m["files"]]
        acc.host_runs.sort(key=lambda r: -len(r[0]))  # cascade invariant
        acc._ckpt_gen = int(m.get("gen", 0)) + 1
        return acc

    def _rebalance(self) -> None:
        while len(self.runs) >= 2 and self.runs[-2][2] <= self.runs[-1][2]:
            self._merge_top2()

    def _merge_device_runs(self):
        """Collapse raw tier and merge device runs down to at most one."""
        self._collapse_raw()
        while len(self.runs) >= 2:
            self._merge_top2()

    def _finalize_host(self) -> tuple[np.ndarray, np.ndarray] | None:
        """When spills happened: fold any remaining device run into the host
        level and merge host runs to one.  Returns raw (kmers, counts) or
        None when nothing spilled."""
        if not self.host_runs:
            return None
        if self.runs:
            u, c, _ = self.runs.pop()
            self._spill(u, c)
        from kmcex import native

        while len(self.host_runs) >= 2:
            kb, cb = self.host_runs.pop()
            ka, ca = self.host_runs.pop()
            self.host_runs.append(native.merge_runs(ka, ca, kb, cb))
        return self.host_runs[0]

    def finalize(self, ci: int = 1, cs: int = 0xFFFFFFFF) -> tuple[np.ndarray, np.ndarray]:
        self._merge_device_runs()
        if self.disk_runs:
            # out-of-core regime: this entry point MATERIALIZES the merged
            # table in host RAM — exactly the regime disk spill exists for.
            # Warn loudly and point callers at finalize_stream; raise when
            # the materialized size would clearly exceed the spill budget.
            import warnings

            disk_bytes = sum(
                12 * self._open_disk_run(p)[0].shape[0] for p in self.disk_runs
            )
            # raise only for genuinely-beyond-RAM sizes (absolute floor so
            # forced-tiny-threshold tests and small tables still pass)
            ram_budget = max(2 * self.disk_spill_bytes, 8 << 30)
            if self.disk_spill_bytes and disk_bytes > ram_budget:
                raise MemoryError(
                    f"finalize() would materialize ~{disk_bytes >> 20}MB of "
                    f"disk-spilled table in host RAM (budget "
                    f"{ram_budget >> 20}MB); use finalize_stream() for "
                    f"bounded memory"
                )
            warnings.warn(
                "DeviceCountAccumulator.finalize() materializes the merged "
                "table despite disk spill; use finalize_stream() for "
                "bounded memory", ResourceWarning, stacklevel=2)
            if self.runs:
                u, c, _ = self.runs.pop()
                self._spill(u, c)
            _, _, it = self._finalize_disk(ci, cs)
            parts = list(it)
            if not parts:
                return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        host = self._finalize_host()
        if host is not None:
            kmers, counts = host
            keep = counts >= ci
            return kmers[keep], np.minimum(counts[keep], np.uint32(cs))
        if not self.runs:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32)
        u, c, _ = self.runs[0]
        narrow = cs < (1 << 16)
        u, c = _pack_final(u, c, int(cs), narrow)
        kmers = np.asarray(u)
        counts = np.asarray(c).astype(np.uint32)
        real = kmers != np.uint64(0xFFFFFFFFFFFFFFFF)
        kmers, counts = kmers[real], counts[real]
        keep = counts >= ci
        return kmers[keep], counts[keep]

    # key-range segments per single-tier finalize: segment q's encode
    # overlaps segment q+1's device compaction + transfer
    FINALIZE_SEGMENTS = 4
    # each segment is padded to whole units of this many entries
    SEGMENT_UNIT = 1 << 18

    def _segmented_stream(self, key, cnt, ci: int, cs: int):
        """Yield ascending ci-filtered (kmers, counts) chunks segment by
        segment.  Per segment: one traced-index compact+stats dispatch, one
        small stats pull (which waits only for THAT segment), then the
        bit-packed row pulls start async while decode/encode proceeds —
        later segments' device work runs concurrently."""
        total_len = int(key.shape[0])
        Q = self.FINALIZE_SEGMENTS
        # pad to whole units per segment so every segment shares one
        # compiled compact/pack shape and stays 8-group aligned
        unit = Q * self.SEGMENT_UNIT
        padded = -(-total_len // unit) * unit
        if padded > total_len:
            pad = padded - total_len
            key = jnp.concatenate(
                [key, jnp.full((pad,), SENTINEL, jnp.uint64)])
            cnt = jnp.concatenate([cnt, jnp.zeros((pad,), jnp.uint32)])
        seg = padded // Q
        n_rows = _row_count(seg)
        # Dispatch discipline (the device executes in dispatch order): the
        # next segment's compact is enqueued right after this segment's pack
        # rows and BEFORE this segment's host-side decode, so the device
        # compacts q+1 while the host decodes/encodes q.
        nxt = _compact_seg(key, cnt, jnp.int32(0), seg, n_rows, jnp.uint32(ci))
        for q in range(Q):
            u, c, flat = nxt
            meta = self._pack_run(u, c, ci, cs, np.asarray(flat))
            if q + 1 < Q:
                nxt = _compact_seg(key, cnt, jnp.int32(q + 1), seg, n_rows,
                                   jnp.uint32(ci))
            if meta is not None:
                yield from _decode_filter(meta, ci)

    def _pack_run(self, u, c, ci: int, cs: int, flat: np.ndarray | None = None):
        """Bit-packed transfer rows for one compacted run.  ``flat`` is the
        pulled _final_stats vector (computed + pulled here when not already
        available).  Starts the async device->host pulls; returns a meta
        dict (None when empty) consumed by _decode_run.  Counts in the
        packed stream are cs-clamped; ci filtering happens at decode."""
        size = u.shape[0]
        n_rows = _row_count(size)
        if flat is None:
            flat = np.asarray(_final_stats(u, c, np.uint32(ci), n_rows))
        assert len(flat) == 9 + 2 * _row_count(size), "stats/rows mismatch"
        n_real = int(flat[4])
        if n_real == 0:
            return None
        meta = {
            "total": int(flat[0]), "hist": flat[1:4].astype(np.int64),
            "n_real": n_real,
            "first_k": int(flat[5]), "first_c": int(flat[6]),
            "last_k": int(flat[7]), "last_c": int(flat[8]), "cs": int(cs),
        }
        if size % 8:  # tiny table: pull it raw, no packing
            ku = np.asarray(u)[:n_real]
            kc = np.minimum(np.asarray(c)[:n_real].astype(np.uint32),
                            np.uint32(cs))
            meta["raw"] = (ku, kc)
            return meta
        row_gap = flat[9 : 9 + n_rows]
        row_cnt = np.minimum(flat[9 + n_rows : 9 + 2 * n_rows], np.uint64(cs))
        plan = _pack_plan(size, n_real, row_gap, row_cnt, n_rows, int(cs))
        kb_parts, cb_parts = [], []
        for start, m, wbits, cbits in plan:
            kb, cb = _pack_span(u, c, jnp.int32(start), m, wbits, cbits,
                                int(cs))
            kb_parts.append(kb)
            cb_parts.append(cb)
        # One buffer per stream for the pulls: the slices of one buffer
        # pipeline, where many small buffers each pay a transfer's fixed
        # cost.  The concat is a cheap device-memory copy.
        kb_all = (jnp.concatenate(kb_parts) if len(kb_parts) > 1
                  else kb_parts[0])
        cb_all = (jnp.concatenate(cb_parts) if len(cb_parts) > 1
                  else cb_parts[0])
        # Group the spans into <= 8 pull slices so the host decode streams
        # (feed of group g overlaps the pull of group g+1).
        n_groups = max(1, min(int(_os.environ.get("KMCEX_PULL_GROUPS", "8")),
                              len(plan)))
        per = -(-len(plan) // n_groups)
        groups = []
        ko = co = 0
        for g0 in range(0, len(plan), per):
            spans = plan[g0 : g0 + per]
            kn = sum(m * wb // 8 for _, m, wb, _ in spans)
            cn = sum(m * cb // 8 for _, m, _, cb in spans)
            ks = kb_all[ko : ko + kn]
            cs_slice = cb_all[co : co + cn]
            ks.copy_to_host_async()
            cs_slice.copy_to_host_async()
            groups.append((spans, ks, cs_slice))
            ko += kn
            co += cn
        meta["groups"] = groups
        return meta

    @staticmethod
    def _decode_run(meta):
        """Decode one _pack_run meta into (kmers, cs-clamped counts) chunks
        (NOT ci-filtered; the seam merger filters)."""
        if "raw" in meta:
            yield meta["raw"]
            return
        from kmcex import native

        base = np.uint64(meta["first_k"])
        n_real = meta["n_real"]
        for spans, ksj, csj in meta["groups"]:
            kb = np.asarray(ksj)
            cbytes = np.asarray(csj)
            ko = co = 0
            for start, m, wbits, cbits in spans:
                kn = m * wbits // 8
                cn = m * cbits // 8
                n_here = min(n_real - start, m)
                ku = native.unpack_deltas(kb[ko : ko + kn], n_here, wbits,
                                          int(base))
                kc = native.unpack_counts(cbytes[co : co + cn], n_here, cbits)
                base = ku[-1]
                ko += kn
                co += cn
                yield ku, kc

    def _finalize_device_table(self, u, c, flat, ci, cs, bloom_factory,
                               drop_low, pre_drop=None):
        """Common tail of the on-device finalize paths: optional device
        Bloom-bank build (model.device_bloom) + optional low-key transfer
        drop, then the packed pull.  Dispatch order matters: the pack/pull
        dispatches go FIRST so the table transfer starts immediately; the
        bloom feed scatters run behind them on the device stream,
        overlapping the host-side decode/encode.  Sets ``self.device_bloom``
        to the builder (None when no build ran)."""
        import time as _time

        fin = self.finalize_phases = {}
        t = _time.time()
        flat = np.asarray(flat)  # blocks on last merge + compact + stats
        if pre_drop is not None and pre_drop[2] is None:
            # fold path: the drop table's stats rode along in the same pull
            half = len(flat) // 2
            pre_drop = (pre_drop[0], pre_drop[1], flat[half:])
            flat = flat[:half]
        fin["stats_wait"] = _time.time() - t
        total = int(flat[0])
        hist = flat[1:4].astype(np.int64)
        n_real = int(flat[4])
        builder = None
        if bloom_factory is not None and n_real:
            try:
                builder = bloom_factory(hist)
            except ValueError:  # bitmap too large: host build fallback
                builder = None
        bf_num = 1 if ci == 1 else 3
        t = _time.time()
        if builder is not None and drop_low:
            if pre_drop is not None:  # drop was folded into the finalize
                u2, c2, flat2 = pre_drop
                flat2 = np.asarray(flat2)
            else:
                n_rows = _row_count(int(u.shape[0]))
                u2, c2, flat2 = _drop_below(u, c, jnp.uint32(ci + bf_num),
                                            n_rows)
                flat2 = np.asarray(flat2)
            fin["drop_low"] = _time.time() - t
            t = _time.time()
            meta = self._pack_run(u2, c2, ci, cs, flat2)
        else:
            meta = self._pack_run(u, c, ci, cs, flat)
        fin["pack_dispatch"] = _time.time() - t
        if builder is not None:
            t = _time.time()
            builder.feed_table(u, c, n_real)
            builder.start_pull()
            fin["bloom_feed_dispatch"] = _time.time() - t
        self.device_bloom = builder
        if meta is None or total == 0:
            return total, hist, iter(())
        return total, hist, _decode_filter(meta, ci)

    def finalize_stream(self, ci: int = 1, cs: int = 0xFFFFFFFF,
                        n_chunks: int = 16, bloom_factory=None,
                        drop_low: bool = False):
        """Streaming finalize: returns (total, low_hist, chunk_iter) where
        ``chunk_iter`` yields (kmers, counts) numpy chunks in ascending-k-mer
        order, already ci-filtered and cs-clamped.

        ``bloom_factory`` (callable(low_hist) -> model.device_bloom.
        DeviceBloomBuilder) opts into building the Bloom bank on device for
        the single-device-table regimes; the builder lands on
        ``self.device_bloom``.  ``drop_low`` additionally drops the
        Bloom-bound keys (and sub-ci keys) from the host transfer — only
        valid when the caller does not need the low pairs on the host (no
        KMC database spool, no keep_pairs).

        The common case (the whole input is one raw tier) runs as ONE fused
        device program — concat, sort, compact, stats — followed by ONE
        small stats pull, so the host syncs with the device once.  The
        table then crosses the host link as bit-packed k-mer deltas +
        counts with PER-ROW widths (canonical k-mers thin out toward the top of the key
        space, so one global width wastes a byte per entry) in async pulls
        started up front; consuming a chunk (feeding the model encoder)
        overlaps later transfers.  ``n_chunks`` is kept for API
        compatibility (host-run chunking only)."""
        self.device_bloom = None
        if (not self.runs and not self.host_runs and not self.disk_runs
                and self.raw):
            if not _SEGMENTED_FINALIZE:
                # default path: the whole single-tier finalize as ONE fused
                # program + packed pulls (no per-segment overlap; see the
                # _SEGMENTED_FINALIZE note for why segmented is opt-in).
                # On the model-only fast path the low-key drop is folded
                # into the same program (one less stats roundtrip).
                fold = bloom_factory is not None and drop_low
                bf_num = 1 if ci == 1 else 3
                pre_drop = None
                size = sum(int(x.shape[0]) for x in self.raw)
                n_rows = _row_count(size)
                if fold:
                    u, c, u2, c2, both = _fused_finalize_drop(
                        self.raw, jnp.uint32(ci), jnp.uint32(cs),
                        ci + bf_num, n_rows)
                else:
                    u, c, flat = _fused_finalize(self.raw, jnp.uint32(ci),
                                                 jnp.uint32(cs), n_rows)
                if fold:  # ONE pull covers both stats vectors (split in
                    # _finalize_device_table, where the pull is timed)
                    flat = both
                    pre_drop = (u2, c2, None)
                self.raw = []
                self.raw_elems = 0
                return self._finalize_device_table(u, c, flat, ci, cs,
                                                   bloom_factory, drop_low,
                                                   pre_drop=pre_drop)
            # SEGMENTED single-tier finalize: sort + boundary-mark the whole
            # tier, pull only the 4-word sizing stats, then compact/pack/pull
            # one key-range segment at a time — the host encode consumes
            # segment q while the device compacts segment q+1, overlapping
            # what used to be strictly serial phases.
            key, cnt, gstats = _sorted_boundary(self.raw, jnp.uint32(ci),
                                                jnp.uint32(cs))
            self.raw = []
            self.raw_elems = 0
            gstats = np.asarray(gstats)
            total = int(gstats[0])
            hist = gstats[1:4].astype(np.int64)
            if total == 0:
                return 0, np.zeros(3, dtype=np.int64), iter(())
            return total, hist, self._segmented_stream(key, cnt, ci, cs)
        self._merge_device_runs()
        if self.disk_runs:
            if self.runs:
                u, c, _ = self.runs.pop()
                self._spill(u, c)
            return self._finalize_disk(ci, cs)
        host = self._finalize_host()
        if host is not None:
            kmers, counts = host
            counts_c = np.minimum(counts, np.uint32(cs))  # clamped sizing
            valid = counts_c >= ci
            total = int(np.count_nonzero(valid))
            hist = np.array(
                [np.count_nonzero(counts_c == ci + i) for i in range(3)],
                dtype=np.int64,
            )
            m = max(1, -(-len(kmers) // max(n_chunks, 1)))

            def hit():
                for a in range(0, len(kmers), m):
                    ku = kmers[a : a + m]
                    kc = counts[a : a + m]
                    keep = kc >= ci
                    yield ku[keep], np.minimum(kc[keep], np.uint32(cs))

            return total, hist, hit()
        if not self.runs:
            return 0, np.zeros(3, dtype=np.int64), iter(())
        u, c, _ = self.runs[0]
        c = jnp.minimum(c, jnp.uint32(cs))  # clamp before stats/feed/drop
        flat = _final_stats(u, c, np.uint32(ci), _row_count(int(u.shape[0])))
        return self._finalize_device_table(u, c, flat, ci, cs,
                                           bloom_factory, drop_low)
