"""KMC2 (version 0x200) database writer: roundtrip through our reader, and
— the real contract — interop with the VENDORED reference KMC API: the
reference kmcEx model built from our KMC2 database must byte-match our own
model built from the same database (which exercises the reference's KMC2
header parse, signature-binned LUT walk, and listing order end to end)."""

import pathlib
import subprocess

import numpy as np
import pytest

from kmcex.core import codec, signature as sig_mod
from kmcex.io import kmc_db
from kmcex.model.kmodel import get_model

from tests.test_model_parity import ref_harness  # noqa: F401  (fixture)


def _make_pairs(seed, n, k, ci, cs):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << min(2 * k, 63), size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(raw & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), ci, cs).astype(np.uint64)
    return can, counts, rng


@pytest.mark.parametrize("k,sig_len,n_bins", [(31, 9, 512), (31, 5, 64),
                                              (21, 7, 128)])
def test_kmc2_roundtrip(tmp_path, k, sig_len, n_bins):
    can, counts, rng = _make_pairs(5, 40000, k, 1, 1023)
    db = str(tmp_path / "db2")
    kmc_db.write_kmc2(db, can, counts, k, min_count=1, max_count=1023,
                      signature_len=sig_len, n_bins=n_bins)
    rd = kmc_db.KMCReader(db)
    assert rd.kmc_version == 0x200
    assert rd.kmer_length == k and rd.signature_len == sig_len
    got_k, got_c = rd.list_all()
    # listing order is (bin, kmer): same multiset, ascending within bins
    order = np.argsort(got_k, kind="stable")
    np.testing.assert_array_equal(got_k[order], can)
    np.testing.assert_array_equal(got_c[order], counts.astype(np.uint32))
    sigs = sig_mod.signatures(got_k, k, sig_len)
    bins = rd.signature_map[sigs]
    assert (np.diff(bins.astype(np.int64)) >= 0).all(), "not bin-grouped"

    # random access: hits + misses
    q = np.concatenate([
        can[:: max(1, len(can) // 1500)],
        codec.canonical_np(
            rng.integers(0, 1 << min(2 * k, 63), 1000, dtype=np.uint64)
            & ((np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)), k),
    ])
    got = rd.check_kmers(q)
    lut = dict(zip(can.tolist(), counts.tolist()))
    want = np.array([lut.get(int(x), 0) for x in q], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_kmc2_reference_interop(ref_harness, tmp_path):  # noqa: F811
    """The reference binary reads our KMC2 db; models built by the reference
    and by us FROM THE SAME KMC2 DB are byte-identical (listing order is the
    db's storage order on both sides, kmodel.hpp:57-86)."""
    k, ci, cs, nh, nb = 31, 1, 1023, 7, 5
    can, counts, rng = _make_pairs(11, 60000, k, ci, cs)
    db = str(tmp_path / "db2")
    kmc_db.write_kmc2(db, can, counts, k, min_count=ci, max_count=cs,
                      signature_len=9, n_bins=512)

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    subprocess.run(
        [ref_harness, "build", db, str(ref_dir), str(ci), str(cs), str(nh), str(nb)],
        check=True, capture_output=True,
    )

    km = get_model(ci, cs, nh, nb)
    km.init(db)  # streams the KMC2 db in ITS storage order
    my_dir = tmp_path / "mine"
    km.save(my_dir)
    for fn in ["header", "km.bin", "rest.bin"]:
        a = (pathlib.Path(ref_dir) / fn).read_bytes()
        b = (pathlib.Path(my_dir) / fn).read_bytes()
        assert a == b, f"{fn} differs ({len(a)} vs {len(b)} bytes)"


def test_kmc2_multiword_roundtrip(tmp_path):
    k = 45
    rng = np.random.default_rng(3)
    from kmcex.core import codec_mw

    raw = rng.integers(0, 1 << 63, size=(8000, codec_mw.n_words(k)),
                       dtype=np.uint64)
    raw[:, 0] &= (np.uint64(1) << np.uint64(2 * k - 64)) - np.uint64(1)
    can = codec_mw.canonical_mw(raw, k)
    keys = codec_mw.sort_key_mw(can)
    _, idx = np.unique(keys, return_index=True)
    can = can[idx]
    counts = rng.integers(1, 1000, len(can)).astype(np.uint64)
    db = str(tmp_path / "dbmw")
    kmc_db.write_kmc2(db, can, counts, k, signature_len=9)
    rd = kmc_db.KMCReader(db)
    got_k, got_c = rd.list_all()
    order = np.argsort(codec_mw.sort_key_mw(got_k), kind="stable")
    np.testing.assert_array_equal(got_k[order], can)
    np.testing.assert_array_equal(got_c[order], counts.astype(np.uint32))
    q = np.concatenate([can[::11][:800], can[:200]])
    got = rd.check_kmers(q)
    lut = {tuple(x): c for x, c in zip(can.tolist(), counts.tolist())}
    want = np.array([lut.get(tuple(x), 0) for x in q.tolist()], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)
