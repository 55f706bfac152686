"""MurmurHash64A parity vs reference golden vectors (tools.hpp:16-50)."""

import numpy as np
import pytest

from kmcex.core.murmur import HASH_SEEDS, murmur64_jnp, murmur64_np, murmur64_py


def test_seed_table():
    assert len(HASH_SEEDS) == 128
    assert HASH_SEEDS[0] == 46757
    assert HASH_SEEDS[127] == 48163


def test_murmur_py_golden(golden_core):
    for key, seed, want in golden_core["murmur"]:
        assert murmur64_py(key.encode(), seed) == int(want), (key, seed)


def test_murmur_np_golden(golden_core):
    # Group by key length so each batch has uniform shape.
    by_len = {}
    for key, seed, want in golden_core["murmur"]:
        by_len.setdefault(len(key), []).append((key, seed, int(want)))
    for n, rows in by_len.items():
        keys = np.array([np.frombuffer(k.encode(), dtype=np.uint8) for k, _, _ in rows])
        seeds = np.array([s for _, s, _ in rows], dtype=np.uint64)
        got = murmur64_np(keys, seeds)
        want = np.array([w for _, _, w in rows], dtype=np.uint64)
        np.testing.assert_array_equal(got, want)


def test_murmur_jnp_matches_np():
    rng = np.random.default_rng(0)
    for n in [1, 7, 8, 9, 29, 31, 32]:
        batch = rng.integers(65, 85, size=(64, n), dtype=np.uint8)
        seeds = rng.integers(0, 2**32, size=(64,), dtype=np.uint64)
        np.testing.assert_array_equal(
            np.asarray(murmur64_jnp(batch, seeds)), murmur64_np(batch, seeds)
        )


def test_murmur_jnp_broadcast_seeds():
    # One kmer hashed under many seeds (the nh-probe pattern).
    key = np.frombuffer(b"ACGTACGTACGTACGTACGTACGTACGTACG", dtype=np.uint8)
    got = np.asarray(murmur64_jnp(key[None, :], HASH_SEEDS[:7]))
    want = np.array(
        [murmur64_py(key.tobytes(), int(s)) for s in HASH_SEEDS[:7]], dtype=np.uint64
    )
    np.testing.assert_array_equal(got, want)
