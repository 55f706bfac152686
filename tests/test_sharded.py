"""Multi-device sharded counting on the virtual 8-device CPU mesh."""

import numpy as np

from kmcex.core import codec
from kmcex.count import extract
from kmcex.parallel import sharded


def _random_codes(rng, rows, seg_len, n_rate=0.02):
    codes = rng.integers(0, 4, size=(rows, seg_len)).astype(np.uint8)
    codes[rng.random(codes.shape) < n_rate] = 255
    return codes


def test_sharded_count_matches_single_device():
    rng = np.random.default_rng(0)
    k = 21
    codes = _random_codes(rng, 64, 96)
    mesh = sharded.make_mesh(8)
    kmers, counts, parts, windows = sharded.sharded_count(codes, mesh, k)

    # single-device truth
    flat, n_valid = extract.extract_canonical(codes, k)
    flat = np.asarray(flat)
    flat = flat[flat != 0xFFFFFFFFFFFFFFFF]
    want_k, want_c = np.unique(flat, return_counts=True)
    np.testing.assert_array_equal(kmers, want_k)
    np.testing.assert_array_equal(counts, want_c.astype(counts.dtype))
    assert windows == int(n_valid)

    # shards are disjoint and complete
    total = sum(len(p[0]) for p in parts)
    assert total == len(want_k)
    for i, (pk, _) in enumerate(parts):
        if len(pk):
            owners = np.asarray(sharded.owner_of(pk, 8))
            assert (owners == i).all()


def test_owner_balance():
    rng = np.random.default_rng(1)
    k = 31
    kmers = codec.canonical_np(rng.integers(0, 1 << 62, size=200000, dtype=np.uint64), k)
    owners = np.asarray(sharded.owner_of(kmers, 8))
    frac = np.bincount(owners, minlength=8) / len(owners)
    assert frac.max() < 0.16 and frac.min() > 0.09  # ~0.125 each


def test_sharded_accumulator_matches_single_device():
    import numpy as np
    from kmcex.count.device_lsm import DeviceCountAccumulator
    from kmcex.parallel import sharded

    rng = np.random.default_rng(11)
    k = 19
    n = 8
    rows, L = 16, 72
    mesh = sharded.make_mesh(n)
    acc = sharded.ShardedCountAccumulator(mesh, k, rows // n, L)
    ref = DeviceCountAccumulator(k)
    for _ in range(5):
        codes = rng.integers(0, 4, size=(rows, L)).astype(np.uint8)
        codes[rng.random(codes.shape) < 0.02] = 255
        acc.add_batch(codes)
        ref.add_batch(codes)
    got_k, got_c = acc.finalize(ci=1, cs=1023)
    want_k, want_c = ref.finalize(ci=1, cs=1023)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


def test_sharded_accumulator_tiers_and_spill():
    """The raw tier (unsorted routed k-mers collapsed by one sort+count),
    the per-shard LSM merges, and the host spill path must all agree with
    the single-chip accumulator — forced by tiny thresholds."""
    from kmcex.count.device_lsm import DeviceCountAccumulator

    rng = np.random.default_rng(23)
    k = 15
    n = 8
    rows, L = 16, 48
    mesh = sharded.make_mesh(n)
    acc = sharded.ShardedCountAccumulator(
        mesh, k, rows // n, L, raw_tier_elems=64, spill_threshold=256)
    ref = DeviceCountAccumulator(k)
    for _ in range(9):
        codes = _random_codes(rng, rows, L)
        acc.add_batch(codes)
        ref.add_batch(codes)
    assert any(acc.host_runs), "spill threshold should have triggered"
    got_k, got_c = acc.finalize(ci=2, cs=255)
    want_k, want_c = ref.finalize(ci=2, cs=255)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


def test_sharded_disk_spill_tier(tmp_path):
    """Tiny thresholds force the sharded accumulator through the DISK tier;
    both finalize flavors must agree with the single-chip accumulator
    (mirrors test_device_lsm.test_disk_spill_tier for the mesh path)."""
    from kmcex.count.device_lsm import DeviceCountAccumulator

    rng = np.random.default_rng(29)
    k = 15
    n = 8
    rows, L = 16, 48
    batches = [_random_codes(rng, rows, L) for _ in range(9)]
    mesh = sharded.make_mesh(n)
    acc = sharded.ShardedCountAccumulator(
        mesh, k, rows // n, L, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=2048, disk_dir=str(tmp_path / "lsm"))
    ref = DeviceCountAccumulator(k)
    for codes in batches:
        acc.add_batch(codes)
        ref.add_batch(codes)
    assert any(acc.disk_runs), "disk tier never engaged"
    total, hist, chunks = acc.finalize_stream(ci=1, cs=0xFFFFFFFF)
    got_k, got_c = [], []
    prev_last = -1
    for ku, kc in chunks:
        assert int(ku[0]) > prev_last  # globally ascending stream
        prev_last = int(ku[-1])
        got_k.append(ku)
        got_c.append(kc)
    got_k = np.concatenate(got_k)
    got_c = np.concatenate(got_c)
    want_k, want_c = ref.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert total == len(want_k)
    for i in range(3):
        assert hist[i] == int(np.count_nonzero(want_c == 1 + i))
    import os

    assert not any(acc.disk_runs) and acc._disk_dir is None, "disk not cleaned"

    # non-streaming finalize takes the same path
    acc2 = sharded.ShardedCountAccumulator(
        mesh, k, rows // n, L, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=2048, disk_dir=str(tmp_path / "lsm2"))
    for codes in batches:
        acc2.add_batch(codes)
    fk, fc = acc2.finalize(ci=1)
    np.testing.assert_array_equal(fk, want_k)
    np.testing.assert_array_equal(fc, want_c)


def test_route_capacity_overflow_reroutes():
    """Degenerate input (every window the same k-mer -> one owner shard)
    overflows the measured-bound routing buffers; the accumulator must
    detect it and re-route with worst-case capacity, losing nothing."""
    from kmcex.count.device_lsm import DeviceCountAccumulator

    k = 15
    n = 8
    rows, L = 512, 48  # big enough that the measured cap < worst case
    mesh = sharded.make_mesh(n)
    # poly-C reads: every window is the same canonical k-mer
    codes = np.full((rows, L), 1, dtype=np.uint8)
    acc = sharded.ShardedCountAccumulator(mesh, k, rows // n, L)
    cap = sharded.default_route_capacity(rows // n, L - k + 1, n)
    assert cap < (rows // n) * (L - k + 1), "test needs a sub-worst-case cap"
    ref = DeviceCountAccumulator(k)
    acc.add_batch(codes)
    ref.add_batch(codes)
    assert acc.reroutes == 1, "overflow should have triggered a re-route"
    got_k, got_c = acc.finalize(ci=1)
    want_k, want_c = ref.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


def test_finalize_single_merge_traversal(tmp_path, monkeypatch):
    """The out-of-core finalize must traverse the k-way merge ONCE (stats
    computed while spooling), not merge-twice (round-3 weak #5)."""
    from kmcex.count import device_lsm

    rng = np.random.default_rng(31)
    k, n, rows, L = 15, 8, 16, 48
    mesh = sharded.make_mesh(n)
    acc = sharded.ShardedCountAccumulator(
        mesh, k, rows // n, L, raw_tier_elems=64, spill_threshold=256,
        disk_spill_bytes=2048, disk_dir=str(tmp_path / "lsm"))
    for _ in range(9):
        acc.add_batch(_random_codes(rng, rows, L))
    calls = []
    orig = device_lsm.DeviceCountAccumulator._merge_streams

    def counting(runs, chunk_elems=1 << 22):
        calls.append(1)
        return orig(runs, chunk_elems)

    monkeypatch.setattr(device_lsm.DeviceCountAccumulator, "_merge_streams",
                        staticmethod(counting))
    total, hist, it = acc.finalize_stream(ci=1)
    for _ in it:
        pass
    assert sum(calls) == 1


def test_route_sentinel_flood_loses_nothing():
    """Round-3 regression: a mixed batch whose rows are MOSTLY invalid
    windows (the shape distributed_count_fastq produces for partial tail
    buffers and N-rich reads) flooded the shard that SENTINEL hashes to,
    and the duplicate-index scatter in _route_local clobbered that shard's
    slot-0 real k-mer without firing the overflow re-route.  Sentinels must
    not consume routing capacity at all: exact equality with the brute-force
    recount, with reroutes == 0."""
    from kmcex.count.device_lsm import DeviceCountAccumulator

    import jax.numpy as jnp

    rng = np.random.default_rng(37)
    k = 15
    n = 8
    rows, L = 512, 48
    mesh = sharded.make_mesh(n)
    s_star = int(sharded.owner_of(
        jnp.asarray([0xFFFFFFFFFFFFFFFF], dtype=jnp.uint64), n)[0])
    # a base row whose FIRST window's canonical k-mer is owned by s_star —
    # in the old scatter, that k-mer occupied slot 0 of the flooded group
    # and was the one the overflow-sentinel writes clobbered
    probe = None
    for seed in range(500):
        cand = np.random.default_rng(seed).integers(
            0, 4, size=(1, L)).astype(np.uint8)
        km = np.asarray(extract.extract_canonical(cand, k)[0])
        if (km[0] != 0xFFFFFFFFFFFFFFFF
                and int(sharded.owner_of(km[:1], n)[0]) == s_star):
            probe = cand[0, :k]
            break
    assert probe is not None
    # mostly-N batch (the partial-tail/N-rich shape): each device's first
    # window is the planted s_star-owned k-mer, everything after is a
    # sentinel flood far past the statistical per-destination cap
    codes = np.full((rows, L), 255, dtype=np.uint8)
    per_dev = rows // n
    for d in range(n):
        codes[d * per_dev, :k] = probe
    sprinkle = _random_codes(rng, rows, L, n_rate=0.0)
    pick = rng.random(codes.shape) < 0.02
    codes[pick] = sprinkle[pick]
    cap = sharded.default_route_capacity(per_dev, L - k + 1, n)
    flat = np.asarray(extract.extract_canonical(codes[:per_dev], k)[0])
    n_sent = int(np.count_nonzero(flat == 0xFFFFFFFFFFFFFFFF))
    assert n_sent > cap, "test needs a per-device sentinel count past cap"

    acc = sharded.ShardedCountAccumulator(mesh, k, rows // n, L)
    ref = DeviceCountAccumulator(k)
    acc.add_batch(codes)
    ref.add_batch(codes)
    assert acc.reroutes == 0, "sentinels must not trip the overflow path"
    got_k, got_c = acc.finalize(ci=1)
    want_k, want_c = ref.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


def test_count_fastq_sharded_end_to_end(tmp_path):
    """FASTQ -> packed segments -> sharded extract/all_to_all -> per-shard
    LSM -> streaming finalize, wired through count_fastq(accumulator=
    "sharded") on the 8-device CPU mesh, equals the single-chip pipeline
    (VERDICT r1 item 4)."""
    from kmcex.count.pipeline import count_fastq

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, size=20000)
    with open(tmp_path / "reads.fastq", "wb") as f:
        for i, s in enumerate(rng.integers(0, len(genome) - 80, size=3000)):
            seq = bases[genome[s : s + 80]].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 80))
    fq = str(tmp_path / "reads.fastq")
    k = 21
    sk, sc, sstats = count_fastq(fq, k=k, ci=1, cs=1023, batch_segs=512,
                                 accumulator="sharded",
                                 mesh=sharded.make_mesh(8))
    dk, dc, dstats = count_fastq(fq, k=k, ci=1, cs=1023, batch_segs=512,
                                 accumulator="device")
    np.testing.assert_array_equal(sk, dk)
    np.testing.assert_array_equal(sc, dc)
    # sharded counts VALID windows (psum of n_valid); single-chip counts
    # window slots incl. padding — assert the exact semantic of each
    assert sstats.windows == 3000 * (80 - k + 1)
    assert dstats.windows >= sstats.windows
    assert sstats.reads == dstats.reads == 3000

    # the streaming finalize contract feeds the encoder identically
    acc = sharded.ShardedCountAccumulator(sharded.make_mesh(8), k, 64, 80,
                                          packed=True)
    from kmcex.io import fastq as fastq_mod

    stream = fastq_mod.SegmentStream(fq, k, 80, 512, packed=True)
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    sh = NamedSharding(sharded.make_mesh(8), PartitionSpec("shard"))
    for packed, maskbits in stream:
        acc.add_batch_packed(*jax.device_put((packed, maskbits), sh))
    total, hist, it = acc.finalize_stream(ci=1, cs=1023)
    got_k = np.concatenate([x[0] for x in it])
    assert total == len(dk)
    np.testing.assert_array_equal(got_k, dk)
    np.testing.assert_array_equal(
        hist, [np.count_nonzero(dc == 1 + i) for i in range(3)])


def test_sharded_query_matches_host():
    """Data-parallel serving (parallel.serve): replicated model, queries
    sharded over the mesh -> answers identical to the host query path."""
    from kmcex.model.kmodel import get_model
    from kmcex.parallel.serve import ShardedKModelServer

    rng = np.random.default_rng(42)
    k = 31
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, size=40000, dtype=np.uint64) & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), 1, 1023).astype(np.uint32)
    km = get_model(1, 1023, 7, 5)
    km.init_from_pairs(can, counts, k)

    mesh = sharded.make_mesh(8)
    srv = ShardedKModelServer(km, mesh, tile=1 << 13)
    q = np.concatenate([
        can[:: max(1, len(can) // 4000)],
        rng.integers(0, 1 << 62, size=3000, dtype=np.uint64) & mask,
        can[:7] ^ np.uint64(0b1100),  # near-miss neighbors
    ])
    got = srv.kmer_to_occ(q)
    want = km.kmer_to_occ_u64(q)
    np.testing.assert_array_equal(got, want)
    # ragged tail exercises pad-to-mesh-quantum
    got_small = srv.kmer_to_occ(q[:13])
    np.testing.assert_array_equal(got_small, want[:13])


def test_genome_scale_e2e_sharded_disk_to_model(tmp_path):
    """BASELINE config 5's shape, forced tiny: sharded count on the mesh ->
    per-shard DISK-spilled runs -> one-pass streaming finalize ->
    streaming encode (init_from_chunks) + streaming KMC1 writer -> model
    and DB bytes identical to the in-RAM single-chip build (VERDICT r3
    item 4)."""
    from kmcex.count.pipeline import count_encode
    from kmcex.io import kmc_db
    from kmcex.model.kmodel import get_model

    rng = np.random.default_rng(8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, size=30000)
    fq = tmp_path / "reads.fastq"
    with open(fq, "wb") as f:
        for i, s in enumerate(rng.integers(0, len(genome) - 80, size=4000)):
            seq = bases[genome[s : s + 80]].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 80))
    k = 21

    # force every tier: tiny raw tier, tiny spill threshold, tiny disk budget
    import kmcex.parallel.sharded as sh_mod

    old = (sh_mod.ShardedCountAccumulator.RAW_TIER_ELEMS,
           sh_mod.ShardedCountAccumulator.SPILL_THRESHOLD,
           sh_mod.ShardedCountAccumulator.DISK_SPILL_BYTES)
    sh_mod.ShardedCountAccumulator.RAW_TIER_ELEMS = 4096
    sh_mod.ShardedCountAccumulator.SPILL_THRESHOLD = 8192
    sh_mod.ShardedCountAccumulator.DISK_SPILL_BYTES = 4096
    import os as _os

    _os.environ["KMCEX_DISK_SPILL_BYTES"] = "4096"
    try:
        km_s, _, _, st = count_encode(
            str(fq), k=k, ci=1, cs=1023, batch_segs=512, keep_pairs=False,
            db_path=str(tmp_path / "db_stream"),
            accumulator="sharded", mesh=sharded.make_mesh(8))
    finally:
        (sh_mod.ShardedCountAccumulator.RAW_TIER_ELEMS,
         sh_mod.ShardedCountAccumulator.SPILL_THRESHOLD,
         sh_mod.ShardedCountAccumulator.DISK_SPILL_BYTES) = old
        del _os.environ["KMCEX_DISK_SPILL_BYTES"]

    # in-RAM single-chip reference build
    km_d, kd, cd, _ = count_encode(str(fq), k=k, ci=1, cs=1023,
                                   batch_segs=512, keep_pairs=True)
    km_s.save(str(tmp_path / "m_sharded"))
    km_d.save(str(tmp_path / "m_device"))
    for name in ("header", "km.bin", "rest.bin"):
        a = (tmp_path / "m_sharded" / name).read_bytes()
        b = (tmp_path / "m_device" / name).read_bytes()
        assert a == b, f"{name} differs"
    # streaming DB == one-shot DB over the same pairs
    kmc_db.write_kmc1(str(tmp_path / "db_ram"), kd, cd.astype(np.uint64), k,
                      min_count=1, max_count=1023,
                      counter_size=kmc_db.counter_size_for(1023))
    for ext in (".kmc_pre", ".kmc_suf"):
        sa = (tmp_path / ("db_stream" + ext)).read_bytes()
        sb = (tmp_path / ("db_ram" + ext)).read_bytes()
        assert sa == sb, ext
    assert st.distinct_kmers == len(kd)


def test_sharded_checkpoint_resume(tmp_path):
    """Sharded mid-count checkpoint -> restore on a fresh mesh accumulator
    -> continue == straight-through; mesh-size mismatch rejected."""
    import pytest

    from kmcex.count.device_lsm import DeviceCountAccumulator

    rng = np.random.default_rng(67)
    k, n, rows, L = 15, 8, 16, 48
    batches = [_random_codes(rng, rows, L) for _ in range(6)]
    mesh = sharded.make_mesh(n)

    ref = DeviceCountAccumulator(k)
    for b in batches:
        ref.add_batch(b)
    want_k, want_c = ref.finalize(ci=1)

    acc = sharded.ShardedCountAccumulator(mesh, k, rows // n, L,
                                          raw_tier_elems=64,
                                          spill_threshold=256)
    for b in batches[:3]:
        acc.add_batch(b)
    ck = tmp_path / "ck"
    acc.checkpoint(str(ck))
    res = sharded.ShardedCountAccumulator.restore(
        mesh, str(ck), raw_tier_elems=64, spill_threshold=256)
    for b in batches[3:]:
        res.add_batch(b)
    got_k, got_c = res.finalize(ci=1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)

    with pytest.raises(ValueError):
        sharded.ShardedCountAccumulator.restore(sharded.make_mesh(4),
                                                str(ck))
