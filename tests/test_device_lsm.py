"""Device-side LSM accumulator must match the host accumulator exactly."""

import re

import numpy as np

from kmcex.core import codec
from kmcex.count.device_lsm import DeviceCountAccumulator, _merge_runs_kernel
from kmcex.count.extract import SENTINEL


def test_merge_runs_kernel():
    ka = np.array([1, 5, 9, 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
    ca = np.array([2, 3, 1, 0], dtype=np.uint32)
    kb = np.array([5, 7, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
    cb = np.array([4, 1, 0, 0], dtype=np.uint32)
    u, c, n = _merge_runs_kernel(ka, ca, kb, cb)
    n = int(n)
    assert n == 4
    np.testing.assert_array_equal(np.asarray(u[:n]), [1, 5, 7, 9])
    np.testing.assert_array_equal(np.asarray(c[:n]), [2, 7, 1, 1])
    assert np.all(np.asarray(u[n:]) == 0xFFFFFFFFFFFFFFFF)


def test_device_accumulator_matches_numpy():
    rng = np.random.default_rng(0)
    k = 17
    acc = DeviceCountAccumulator(k)
    all_kmers = []
    for _ in range(7):
        codes = rng.integers(0, 4, size=(64, 80)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.03] = 255
        acc.add_batch(codes)
        # reference extraction on host
        from kmcex.count.extract import extract_canonical

        flat = np.asarray(extract_canonical(codes, k)[0])
        all_kmers.append(flat[flat != 0xFFFFFFFFFFFFFFFF])
    kmers, counts = acc.finalize(ci=1)
    want_k, want_c = np.unique(np.concatenate(all_kmers), return_counts=True)
    np.testing.assert_array_equal(kmers, want_k)
    np.testing.assert_array_equal(counts, want_c.astype(np.uint32))


def test_packed_extract_matches_unpacked():
    rng = np.random.default_rng(5)
    k = 21
    codes = rng.integers(0, 4, size=(32, 96)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.05] = 255
    from kmcex.count.extract import (
        extract_canonical,
        extract_canonical_packed,
        pack_codes_np,
    )

    want, n_want = extract_canonical(codes, k)
    packed, maskbits = pack_codes_np(codes)
    got, n_got = extract_canonical_packed(packed, maskbits, k)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(n_got) == int(n_want)


def test_device_accumulator_packed_matches():
    rng = np.random.default_rng(6)
    k = 17
    acc = DeviceCountAccumulator(k)
    acc2 = DeviceCountAccumulator(k)
    from kmcex.count.extract import pack_codes_np

    for _ in range(3):
        codes = rng.integers(0, 4, size=(64, 80)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.03] = 255
        acc.add_batch(codes)
        acc2.add_batch_packed(*pack_codes_np(codes))
    k1, c1 = acc.finalize(ci=1)
    k2, c2 = acc2.finalize(ci=1)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(c1, c2)


def test_device_accumulator_tiny_tiers():
    """Force raw-tier collapses + LSM merges with a tiny tier limit."""
    rng = np.random.default_rng(2)
    k = 17
    acc = DeviceCountAccumulator(k, raw_tier_elems=2000)
    all_kmers = []
    from kmcex.count.extract import extract_canonical

    for _ in range(9):
        codes = rng.integers(0, 4, size=(16, 80)).astype(np.uint8)
        acc.add_batch(codes)
        flat = np.asarray(extract_canonical(codes, k)[0])
        all_kmers.append(flat[flat != 0xFFFFFFFFFFFFFFFF])
    assert len(acc.runs) >= 1  # collapses actually happened mid-stream
    kmers, counts = acc.finalize(ci=1)
    want_k, want_c = np.unique(np.concatenate(all_kmers), return_counts=True)
    np.testing.assert_array_equal(kmers, want_k)
    np.testing.assert_array_equal(counts, want_c.astype(np.uint32))


def test_device_accumulator_ci_cs():
    rng = np.random.default_rng(1)
    k = 9
    acc = DeviceCountAccumulator(k)
    codes = np.tile(rng.integers(0, 4, size=(4, 40)).astype(np.uint8), (8, 1))
    acc.add_batch(codes)
    kmers, counts = acc.finalize(ci=3, cs=5)
    assert (counts >= 3).all() and (counts <= 5).all()


def test_finalize_stream_matches_finalize():
    rng = np.random.default_rng(8)
    k = 17
    a1 = DeviceCountAccumulator(k)
    a2 = DeviceCountAccumulator(k)
    batches = []
    for _ in range(4):
        codes = rng.integers(0, 4, size=(64, 80)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.03] = 255
        batches.append(codes)
    # repeat some batches so multiplicities straddle the ci=2 threshold
    for codes in batches + batches[:2]:
        a1.add_batch(codes)
        a2.add_batch(codes)
    want_k, want_c = a1.finalize(ci=2, cs=5)
    assert len(want_k) > 0  # the comparison must be non-trivial
    total, hist, chunks = a2.finalize_stream(ci=2, cs=5)
    parts = list(chunks)
    got_k = (np.concatenate([p[0] for p in parts]) if parts
             else np.zeros(0, np.uint64))
    got_c = (np.concatenate([p[1] for p in parts]) if parts
             else np.zeros(0, np.uint32))
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert total == len(want_k)
    # hist counts counter==ci+i among >= ci entries
    assert hist[0] == np.count_nonzero(want_c == 2)


def test_finalize_stream_empty():
    acc = DeviceCountAccumulator(17)
    total, hist, chunks = acc.finalize_stream()
    assert total == 0 and list(chunks) == []


def test_spill_to_host_matches():
    """Tiny spill threshold forces device runs through the host LSM level."""
    rng = np.random.default_rng(9)
    k = 17
    a1 = DeviceCountAccumulator(k)
    a2 = DeviceCountAccumulator(k, raw_tier_elems=2000, spill_threshold=4096)
    for _ in range(6):
        codes = rng.integers(0, 4, size=(32, 80)).astype(np.uint8)
        a1.add_batch(codes)
        a2.add_batch(codes)
    assert a2.host_runs, "spill did not trigger"
    k1, c1 = a1.finalize(ci=1, cs=1023)
    k2, c2 = a2.finalize(ci=1, cs=1023)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(c1, c2)


def test_spill_finalize_stream_matches():
    rng = np.random.default_rng(10)
    k = 17
    a1 = DeviceCountAccumulator(k)
    a2 = DeviceCountAccumulator(k, raw_tier_elems=2000, spill_threshold=4096)
    for _ in range(6):
        codes = rng.integers(0, 4, size=(32, 80)).astype(np.uint8)
        a1.add_batch(codes)
        a2.add_batch(codes)
    want_k, want_c = a1.finalize(ci=2, cs=9)
    total, hist, chunks = a2.finalize_stream(ci=2, cs=9)
    parts = list(chunks)
    got_k = np.concatenate([p[0] for p in parts]) if parts else np.zeros(0, np.uint64)
    got_c = np.concatenate([p[1] for p in parts]) if parts else np.zeros(0, np.uint32)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert total == len(want_k)


def _brute_counts(batches, k):
    from kmcex.count.extract import extract_canonical

    allk = []
    for codes in batches:
        flat = np.asarray(extract_canonical(codes, k)[0])
        allk.append(flat[flat != 0xFFFFFFFFFFFFFFFF])
    return np.unique(np.concatenate(allk), return_counts=True)


def test_disk_spill_tier(tmp_path):
    """Tiny thresholds force every run through the disk tier; the
    out-of-core k-way merge must agree with brute force (both finalize
    flavors)."""
    rng = np.random.default_rng(42)
    k = 15
    batches = []
    for _ in range(6):
        codes = rng.integers(0, 4, size=(48, 60)).astype(np.uint8)
        batches.append(codes)

    acc = DeviceCountAccumulator(
        k, raw_tier_elems=1500, spill_threshold=1024,
        disk_spill_bytes=4096, disk_dir=str(tmp_path / "lsm"))
    for codes in batches:
        acc.add_batch(codes)
    assert acc.disk_runs, "disk tier never engaged"
    total, hist, chunks = acc.finalize_stream(ci=1, cs=0xFFFFFFFF)
    got_k = []
    got_c = []
    for ku, kc in chunks:
        got_k.append(ku)
        got_c.append(kc)
    got_k = np.concatenate(got_k)
    got_c = np.concatenate(got_c)
    want_k, want_c = _brute_counts(batches, k)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c.astype(np.uint32))
    assert total == len(want_k)
    for i in range(3):
        assert hist[i] == int(np.count_nonzero(want_c == 1 + i))

    # non-streaming finalize takes the same path
    acc2 = DeviceCountAccumulator(
        k, raw_tier_elems=1500, spill_threshold=1024,
        disk_spill_bytes=4096, disk_dir=str(tmp_path / "lsm2"))
    for codes in batches:
        acc2.add_batch(codes)
    fk, fc = acc2.finalize(ci=1)
    np.testing.assert_array_equal(fk, want_k)
    np.testing.assert_array_equal(fc, want_c.astype(np.uint32))


def test_disk_spill_ci_filter(tmp_path):
    rng = np.random.default_rng(9)
    k = 13
    batches = [rng.integers(0, 4, size=(40, 50)).astype(np.uint8) for _ in range(4)]
    acc = DeviceCountAccumulator(
        k, raw_tier_elems=900, spill_threshold=512,
        disk_spill_bytes=2048, disk_dir=str(tmp_path / "lsm"))
    for codes in batches:
        acc.add_batch(codes)
    assert acc.disk_runs
    total, _, chunks = acc.finalize_stream(ci=2, cs=3)
    got_k, got_c = [], []
    for ku, kc in chunks:
        got_k.append(ku)
        got_c.append(kc)
    want_k, want_c = _brute_counts(batches, k)
    keep = want_c >= 2
    np.testing.assert_array_equal(np.concatenate(got_k), want_k[keep])
    np.testing.assert_array_equal(
        np.concatenate(got_c), np.minimum(want_c[keep], 3).astype(np.uint32))
    assert total == int(np.count_nonzero(keep))


def test_pack_plan_properties():
    """_pack_plan spans must tile [0, >=n_real) contiguously on the granule
    ladder, stay in-bounds, and carry widths that cover every gap/count
    maximum of the stat granules they span."""
    import numpy as np

    from kmcex.count.device_lsm import (
        PACK_SPAN_ELEMS,
        PACK_TAIL_ELEMS,
        _pack_plan,
        _row_count,
    )

    rng = np.random.default_rng(0)
    for trial in range(200):
        size = 1 << int(rng.integers(10, 26))
        n_real = int(rng.integers(1, size + 1))
        n_rows = _row_count(size)
        row_gap = rng.integers(1, 1 << 50, n_rows).astype(np.uint64)
        row_cnt = rng.integers(1, 1 << 20, n_rows).astype(np.uint64)
        plan = _pack_plan(size, n_real, row_gap, row_cnt, n_rows, 1023)
        pos = 0
        stat_m = size // n_rows
        for start, m, wbits, cbits in plan:
            assert start == pos, "spans must be contiguous"
            assert m in (PACK_SPAN_ELEMS, PACK_TAIL_ELEMS, size)
            assert start + m <= size, "span exceeds the table"
            assert m % 8 == 0
            g0, g1 = start // stat_m, min(-(-(start + m) // stat_m), n_rows)
            gmax = max(int(row_gap[g]) for g in range(g0, g1))
            assert (1 << wbits) > gmax or wbits == 64
            cmax = min(max(int(row_cnt[g]) for g in range(g0, g1)), 1023)
            assert (1 << cbits) > cmax or cbits == 32
            pos += m
        assert pos >= n_real, "plan must cover every real entry"
        assert pos - n_real < max(PACK_TAIL_ELEMS, 8), "excess pad spans"


def test_checkpoint_resume(tmp_path):
    """Mid-count checkpoint -> restore -> continue == straight-through
    (the reference has no mid-build persistence; SURVEY §5 row exceeded).
    Checkpoint files survive the restored accumulator's finalize."""
    import os

    import numpy as np

    from kmcex.count.device_lsm import DeviceCountAccumulator

    rng = np.random.default_rng(61)
    k = 15
    batches = []
    for _ in range(8):
        codes = rng.integers(0, 4, size=(16, 48)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.02] = 255
        batches.append(codes)

    ref = DeviceCountAccumulator(k)
    for b in batches:
        ref.add_batch(b)
    want_k, want_c = ref.finalize(ci=1)
    want_w = ref.total_windows

    acc = DeviceCountAccumulator(k, raw_tier_elems=1024,
                                 spill_threshold=2048)
    for b in batches[:5]:
        acc.add_batch(b)
    ck = tmp_path / "ckpt"
    acc.checkpoint(str(ck))
    assert (ck / "manifest.json").exists()

    res = DeviceCountAccumulator.restore(str(ck), raw_tier_elems=1024,
                                         spill_threshold=2048)
    for b in batches[5:]:
        res.add_batch(b)
    got_k, got_c = res.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert res.total_windows == want_w
    # checkpoint untouched: restore again and finalize WITHOUT new batches
    res2 = DeviceCountAccumulator.restore(str(ck))
    pk, pc = res2.finalize(ci=1)
    ref5 = DeviceCountAccumulator(k)
    for b in batches[:5]:
        ref5.add_batch(b)
    w5k, w5c = ref5.finalize(ci=1)
    np.testing.assert_array_equal(pk, w5k)
    np.testing.assert_array_equal(pc, w5c)
    assert (ck / "manifest.json").exists()
    assert any(re.match(r"g\d+_run", f.name) for f in ck.iterdir())

    # the original accumulator stays valid after checkpointing too
    for b in batches[5:]:
        acc.add_batch(b)
    ak, ac = acc.finalize(ci=1)
    np.testing.assert_array_equal(ak, want_k)
    np.testing.assert_array_equal(ac, want_c)
