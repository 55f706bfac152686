"""DeviceKModel (jitted batched query) must agree exactly with the host
query path — which itself is verified bit-exact against the reference binary
in test_model_parity.py, so transitivity gives device == reference."""

import numpy as np
import pytest

from kmcex.core import codec
from kmcex.model.kmodel import get_model
from kmcex.query.device_model import DeviceKModel


def _build(seed, n, k, ci, cs, nh, nb):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(raw & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), ci, cs).astype(np.uint64)
    km = get_model(ci, cs, nh, nb)
    km.init_from_pairs(can, counts.astype(np.uint32), k)
    return km, can, rng


@pytest.mark.parametrize(
    "seed,n,k,ci,cs,nh,nb",
    [
        (11, 100000, 31, 1, 1023, 7, 5),
        (12, 60000, 31, 2, 1023, 7, 5),
        (13, 50000, 21, 1, 255, 7, 4),
    ],
)
def test_device_matches_host(seed, n, k, ci, cs, nh, nb):
    km, can, rng = _build(seed, n, k, ci, cs, nh, nb)
    dm = DeviceKModel(km)
    q = np.concatenate(
        [can[::9][:3000], rng.integers(0, 1 << (2 * k), size=1500, dtype=np.uint64)]
    )
    host = km.kmer_to_occ_u64(q)
    dev = np.asarray(dm.kmer_to_occ(q))
    np.testing.assert_array_equal(dev, host)


def test_device_query_shapes():
    km, can, _ = _build(14, 20000, 31, 1, 1023, 7, 5)
    dm = DeviceKModel(km)
    out = np.asarray(dm.kmer_to_occ(can[:128].reshape(2, 64)))
    assert out.shape == (2, 64)


def test_device_rest_quirk_keys_match_host():
    """The cuckoo rest table's phantom entries must reproduce the
    reference's inclusive-high quirk (rest.hpp:236-247): derive the
    quirk-triggering keys independently from the CSR arrays and compare
    device vs host on exactly those."""
    km, can, rng = _build(21, 120000, 31, 1, 1023, 7, 5)
    kld = km.kld
    assert kld.suffix_bin_count > 100, "model must have a real rest store"
    suffix = kld._ensure_suffix_int()
    pre = kld.pre_buffer.astype(np.int64)
    suf_bits = 2 * kld.suf_len
    quirks = []
    for p in np.flatnonzero(kld.hash2index >= 0):
        pi = kld.hash2index[p]
        lo, hi = pre[pi], pre[pi + 1]
        if hi < kld.suffix_bin_count and (lo == hi or suffix[hi] > suffix[hi - 1]):
            quirks.append((np.uint64(p) << np.uint64(suf_bits)) | suffix[hi])
    q = np.array(quirks, dtype=np.uint64)
    assert len(q) > 10
    # only canonical quirk keys stay quirk keys after canonicalization
    q = q[codec.canonical_np(q, 31) == q]
    assert len(q) > 5
    host = km.kmer_to_occ_u64(q)
    dev = np.asarray(DeviceKModel(km).kmer_to_occ(q))
    np.testing.assert_array_equal(dev, host)
    # the quirk actually fires for at least some of these keys
    assert (kld.check_kmer(q) > 0).any()


def test_device_fb_gate_both_branches():
    """The half-tile find_bitarray gate must be exact on both sides: a
    batch that is almost all array-resident k-mers (cnt > N/2 -> full
    branch) and one that is almost all random (half branch)."""
    km, can, rng = _build(22, 80000, 31, 1, 1023, 7, 5)
    dm = DeviceKModel(km)
    dense = can[: 4096]  # resident: nearly every lane needs find_bitarray
    sparse = rng.integers(0, 1 << 62, size=4096, dtype=np.uint64)
    for q in (dense, sparse, np.concatenate([dense[:2048], sparse[:2048]])):
        host = km.kmer_to_occ_u64(q)
        dev = np.asarray(dm.kmer_to_occ(q))
        np.testing.assert_array_equal(dev, host)
