"""Device Bloom-bank build parity: the scatter-built filters must be
byte-identical to the host/native insertion (order-independence of the
Bloom OR makes this exact, kmodel.hpp:473-506)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from kmcex.count.device_lsm import SENTINEL  # noqa: E402
from kmcex.model.bloom import BloomBank  # noqa: E402
from kmcex.model.device_bloom import DeviceBloomBuilder  # noqa: E402
from kmcex.model.kmodel import get_model  # noqa: E402


def _rand_table(rng, n, k, ci, max_c=9):
    mask = (1 << (2 * k)) - 1
    kmers = np.unique(
        rng.integers(0, mask + 1, size=n, dtype=np.uint64))
    from kmcex.core import codec

    kmers = np.unique(codec.canonical_np(kmers, k))
    counts = rng.integers(ci, max_c, size=len(kmers)).astype(np.uint32)
    return kmers, counts


@pytest.mark.parametrize("k,ci,nh", [(31, 1, 7), (25, 2, 7), (31, 2, 5)])
def test_device_bloom_matches_host(k, ci, nh):
    rng = np.random.default_rng(42 + k + ci)
    kmers, counts = _rand_table(rng, 4000, k, ci)
    bf_num = 1 if ci == 1 else 3
    hist = np.array(
        [np.count_nonzero(counts == ci + i) for i in range(3)], np.uint64)

    host = BloomBank(hist, nh, ci)
    for i in range(bf_num):
        host.insert(i, kmers[counts == ci + i], k)

    b = DeviceBloomBuilder(k, ci, 1023, nh, hist)
    # SENTINEL-padded device table, like the fused finalize produces
    pad = 173
    u = jnp.asarray(np.concatenate(
        [kmers, np.full(pad, np.uint64(SENTINEL))]))
    c = jnp.asarray(np.concatenate(
        [counts, np.zeros(pad, np.uint32)]))
    dev = BloomBank(hist, nh, ci)
    b.feed_table(u, c, len(kmers))
    b.into(dev)

    for i in range(bf_num):
        np.testing.assert_array_equal(dev.bit_bf[i], host.bit_bf[i])
        np.testing.assert_array_equal(dev.bit_bf_back[i],
                                      host.bit_bf_back[i])
    # membership answers agree too
    probe = np.concatenate([kmers[:200], rng.integers(
        0, 1 << (2 * k), 100, dtype=np.uint64)])
    from kmcex.core import codec

    probe = codec.canonical_np(probe, k)
    np.testing.assert_array_equal(
        dev.check_all(probe, k), host.check_all(probe, k))


def test_device_bloom_split_feeds_match():
    """Feeding the table in two finalize-style calls equals one feed."""
    k, ci, nh = 31, 1, 7
    rng = np.random.default_rng(7)
    kmers, counts = _rand_table(rng, 3000, k, ci)
    hist = np.array(
        [np.count_nonzero(counts == ci + i) for i in range(3)], np.uint64)

    one = DeviceBloomBuilder(k, ci, 1023, nh, hist)
    one.feed_table(jnp.asarray(kmers), jnp.asarray(counts), len(kmers))
    cut = len(kmers) // 2
    two = DeviceBloomBuilder(k, ci, 1023, nh, hist)
    two.feed_table(jnp.asarray(kmers[:cut]), jnp.asarray(counts[:cut]), cut)
    two.feed_table(jnp.asarray(kmers[cut:]), jnp.asarray(counts[cut:]),
                   len(kmers) - cut)
    b1 = BloomBank(hist, nh, ci)
    b2 = BloomBank(hist, nh, ci)
    one.into(b1)
    two.into(b2)
    np.testing.assert_array_equal(b1.bit_bf[0], b2.bit_bf[0])
    np.testing.assert_array_equal(b1.bit_bf_back[0], b2.bit_bf_back[0])


def test_sharded_device_bloom_model_identical(tmp_path):
    """The mesh-built Bloom bank (per-shard scatter + pmax OR-collective)
    must produce a model byte-identical to the host-bloom build."""
    import os

    from kmcex.count.pipeline import count_encode
    from tests.test_byte_ranges import _write_fastq

    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=600, seed=9)
    k = 19

    prev = os.environ.get("KMCEX_DEVICE_BLOOM")
    os.environ["KMCEX_DEVICE_BLOOM"] = "0"
    try:
        km_host, _, _, _ = count_encode(str(fq), k=k,
                                        accumulator="sharded")
    finally:
        if prev is None:
            os.environ.pop("KMCEX_DEVICE_BLOOM", None)
        else:
            os.environ["KMCEX_DEVICE_BLOOM"] = prev
    km_mesh, _, _, _ = count_encode(str(fq), k=k, accumulator="sharded")

    d_host = tmp_path / "m_host"
    d_mesh = tmp_path / "m_mesh"
    km_host.save(d_host)
    km_mesh.save(d_mesh)
    for name in ("header", "km.bin", "rest.bin"):
        assert (d_host / name).read_bytes() == (d_mesh / name).read_bytes(), name


def test_sharded_device_bloom_skipped_when_spilled(tmp_path):
    """Spilled runs would be missed by the device feed; the builder must
    not engage and the host path must produce the same model."""
    import jax

    from kmcex.model.device_bloom import ShardedDeviceBloomBuilder
    from kmcex.parallel.sharded import ShardedCountAccumulator, make_mesh
    from kmcex.count import extract

    mesh = make_mesh(devices=jax.devices("cpu")[:4])
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(8, 64)).astype(np.uint8)
    acc = ShardedCountAccumulator(mesh, 19, 2, 64, spill_threshold=1)
    acc.add_batch(codes)
    total, hist, it = acc.finalize_stream(
        ci=1, bloom_factory=lambda h: ShardedDeviceBloomBuilder(
            mesh, 19, 1, 1023, 7, h))
    assert acc.device_bloom is None  # spilled -> host build
    parts = list(it)
    got = np.concatenate([p[0] for p in parts])
    flat = np.asarray(extract.extract_canonical(codes, 19)[0])
    flat = flat[flat != np.uint64(0xFFFFFFFFFFFFFFFF)]
    np.testing.assert_array_equal(got, np.unique(flat))


def test_sharded_device_bloom_skipped_on_finalize_time_spill(tmp_path):
    """Regression (round-5 review): the no-spill precondition must be
    re-checked AFTER _merge_all_device — the finalize-time raw collapse can
    cascade a merge over the spill threshold, and a builder fed only the
    surviving device run would silently lose the spilled keys' low
    counts."""
    import jax

    from kmcex.count import extract
    from kmcex.model.device_bloom import ShardedDeviceBloomBuilder
    from kmcex.parallel import sharded

    mesh = sharded.make_mesh(devices=jax.devices("cpu")[:2])
    k, rows, seg = 19, 2, 64
    rng = np.random.default_rng(17)
    acc = sharded.ShardedCountAccumulator(
        mesh, k, rows, seg, raw_tier_elems=1 << 60,
        spill_threshold=1 << 60)
    batches = [rng.integers(0, 4, size=(2 * rows, seg)).astype(np.uint8)
               for _ in range(11)]
    flats = []
    for cb in batches:
        flat = np.asarray(extract.extract_canonical(cb, k)[0])
        flats.append(flat[flat != np.uint64(0xFFFFFFFFFFFFFFFF)])
    # runs: R6 (6 batches), R2 (2 batches); 3 batches left raw
    for cb in batches[:6]:
        acc.add_batch(cb)
    acc._collapse_raw()
    for cb in batches[6:8]:
        acc.add_batch(cb)
    acc._collapse_raw()
    for cb in batches[8:]:
        acc.add_batch(cb)
    assert len(acc.runs) == 2 and acc.raw
    s_unit = acc.runs[1][2] // 2  # per-batch run width
    # now let the finalize-time cascade (R2 + R3 -> R5) cross the threshold
    acc.spill_threshold = 4 * s_unit
    total, hist, it = acc.finalize_stream(
        ci=1, bloom_factory=lambda h: ShardedDeviceBloomBuilder(
            mesh, k, 1, 1023, 7, h))
    assert any(acc.host_runs) or acc.device_bloom is None
    assert acc.device_bloom is None, \
        "builder must not engage after a finalize-time spill"
    parts = list(it)
    got_k = np.concatenate([p[0] for p in parts])
    got_c = np.concatenate([p[1] for p in parts])
    want_k, want_c = np.unique(np.concatenate(flats), return_counts=True)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c.astype(got_c.dtype))


def test_device_bloom_narrow_cs_clamped_membership(tmp_path):
    """Regression (round-5 review): with cs < ci + bf_num the Bloom
    membership must match the reference's cs-CLAMPED counters.  Ground
    truth is init_from_pairs fed the clamped table (what the reference's
    clamped database would contain)."""
    from kmcex.count.pipeline import count_encode
    from tests.test_byte_ranges import _write_fastq

    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=500, seed=13)
    k, ci, cs = 19, 1, 1  # every counter clamps to 1 -> everything is low

    km_pipe, kk, cc, _ = count_encode(str(fq), k=k, ci=ci, cs=cs)
    assert cc.max() == 1  # clamped pairs
    km_truth = get_model(ci, cs, 7, 5)
    km_truth.init_from_pairs(kk, cc, k)
    d_pipe = tmp_path / "m_pipe"
    d_truth = tmp_path / "m_truth"
    km_pipe.save(d_pipe)
    km_truth.save(d_truth)
    for name in ("header", "km.bin", "rest.bin"):
        assert (d_pipe / name).read_bytes() == (d_truth / name).read_bytes(), name

    # model-only fast path too (device bloom + drop): same bytes
    km_fast, _, _, _ = count_encode(str(fq), k=k, ci=ci, cs=cs,
                                    keep_pairs=False)
    d_fast = tmp_path / "m_fast"
    km_fast.save(d_fast)
    for name in ("header", "km.bin", "rest.bin"):
        assert (d_fast / name).read_bytes() == (d_truth / name).read_bytes(), name


@pytest.mark.parametrize("ci", [1, 2])
def test_count_encode_device_bloom_model_identical(tmp_path, ci):
    """End-to-end: the model-only fast path (device bloom + dropped low
    transfer; for ci>1 the sub-ci keys drop too) builds a byte-identical
    model to the host-bloom path."""
    import os

    from kmcex.count.pipeline import count_encode
    from tests.test_byte_ranges import _write_fastq  # tiny generator

    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, n_reads=500, seed=5)
    k = 19  # generator reads are 20-60bp

    prev = os.environ.get("KMCEX_DEVICE_BLOOM")
    os.environ["KMCEX_DEVICE_BLOOM"] = "0"
    try:
        km_host, kk, cc, _ = count_encode(str(fq), k=k, ci=ci,
                                          keep_pairs=True)
    finally:
        if prev is None:
            os.environ.pop("KMCEX_DEVICE_BLOOM", None)
        else:
            os.environ["KMCEX_DEVICE_BLOOM"] = prev
    # fast path: no pairs kept, no DB -> low keys never reach the host
    km_dev, _, _, stats = count_encode(str(fq), k=k, ci=ci,
                                       keep_pairs=False)

    d_host = tmp_path / "m_host"
    d_dev = tmp_path / "m_dev"
    km_host.save(d_host)
    km_dev.save(d_dev)
    for name in ("header", "km.bin", "rest.bin"):
        assert (d_host / name).read_bytes() == (d_dev / name).read_bytes(), name
    # the fast path really did drop the low keys from the transfer
    assert stats.distinct_kmers == len(kk)