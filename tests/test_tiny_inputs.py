"""Tiny-population models must not crash (reference SIGFPEs: 0-byte filters
from (count>>3)*(nh-2) for <8 k-mers and (n>>4)*nh for <16 k-mers lead to
hash-modulo-zero, kmodel.hpp:411-418,437-438).  We clamp sizes to >=1 byte."""

import numpy as np
import pytest

from kmcex.core import codec
from kmcex.model.kmodel import get_model, load_model


def _pairs(n, k=31, seed=0):
    rng = np.random.default_rng(seed)
    kmers = np.unique(rng.integers(0, 1 << 62, n * 2, dtype=np.uint64))
    kmers = codec.canonical_np(kmers, k)
    kmers = np.unique(kmers)[:n]
    counts = rng.integers(1, 40, len(kmers)).astype(np.uint32)
    return np.sort(kmers), counts


@pytest.mark.parametrize("n", [1, 3, 12, 30])
def test_tiny_build_query_roundtrip(tmp_path, n):
    kmers, counts = _pairs(n)
    km = get_model(1, 1023, 7, 5)
    km.init_from_pairs(kmers, counts, 31)
    got = km.kmer_to_occ_u64(kmers)
    # approximate structure: every true positive must answer *something*
    # sane; exact k-mers with count in the identity-bin range (<32) whose
    # lookup resolves via rest store or BF must be exact.
    assert got.shape == (len(kmers),)
    assert (got >= 0).all()
    d = tmp_path / "m"
    km.save(d)
    km2 = load_model(d)
    np.testing.assert_array_equal(km2.kmer_to_occ_u64(kmers), got)


def test_empty_model(tmp_path):
    km = get_model(1, 1023, 7, 5)
    km.init_from_pairs(np.zeros(0, np.uint64), np.zeros(0, np.uint32), 31)
    q = np.array([12345678901234567], dtype=np.uint64)
    assert km.kmer_to_occ_u64(q)[0] == 0
    d = tmp_path / "m"
    km.save(d)
    assert load_model(d).kmer_to_occ_u64(q)[0] == 0
