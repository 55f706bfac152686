"""2-bit codec parity vs reference golden vectors (tools.hpp:54-167)."""

import numpy as np

from kmcex.core import codec


def test_codec_golden(golden_core):
    for kmer, k, u, rc, mink, roundtrip in golden_core["codec"]:
        u, rc = int(u), int(rc)
        assert codec.string_to_u64(kmer) == u
        assert int(codec.revcomp_np(np.uint64(u), k)) == rc
        got_min = codec.u64_to_string(int(codec.canonical_np(np.uint64(u), k)), k)
        assert got_min == mink
        assert codec.u64_to_string(u, k) == roundtrip


def test_revcomp_involution():
    rng = np.random.default_rng(1)
    for k in [1, 4, 15, 16, 21, 25, 31, 32]:
        v = rng.integers(0, 1 << min(2 * k, 63), size=256, dtype=np.uint64)
        rc = codec.revcomp_np(v, k)
        np.testing.assert_array_equal(codec.revcomp_np(rc, k), v)


def test_revcomp_jnp_matches_np():
    rng = np.random.default_rng(2)
    for k in [4, 21, 31, 32]:
        v = rng.integers(0, 1 << min(2 * k, 63), size=128, dtype=np.uint64)
        np.testing.assert_array_equal(np.asarray(codec.revcomp_jnp(v, k)), codec.revcomp_np(v, k))
        np.testing.assert_array_equal(
            np.asarray(codec.canonical_jnp(v, k)), codec.canonical_np(v, k)
        )


def test_bin_to_decimal_golden(golden_core):
    # bin_to_decimal is little-endian bit decode: bit i of result = arr[i].
    for arr, want in golden_core["bin_to_decimal"]:
        got = sum(b << i for i, b in enumerate(arr))
        assert got == want


def test_ascii_bytes():
    s = "GATTACAGATTACAGATTACA"
    v = codec.string_to_u64(s)
    np.testing.assert_array_equal(
        codec.ascii_bytes_np(np.uint64(v), len(s)),
        np.frombuffer(s.encode(), dtype=np.uint8),
    )
    np.testing.assert_array_equal(
        np.asarray(codec.ascii_bytes_jnp(np.uint64(v)[None], len(s)))[0],
        np.frombuffer(s.encode(), dtype=np.uint8),
    )


def test_middle_kmer():
    s = "GATTACAGATTACAGATTACA"
    v = codec.string_to_u64(s)
    mid = codec.middle_kmer_np(np.uint64(v), len(s))
    assert codec.u64_to_string(int(mid), len(s) - 2) == s[1:-1]


def test_encode_bases_invalid():
    got = codec.encode_bases(np.frombuffer(b"ACGTNacgtX", dtype=np.uint8))
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 255, 0, 1, 2, 3, 255])
