"""Chunked (streaming) model build must be byte-identical to one-shot.

The coupled-array encode schedule depends only on overall stream order
(kmodel.hpp:508-573), so feeding the listing in chunks — as the pipeline
does to overlap the device table pull with the encode — must produce the
same km.bin/rest.bin bytes.
"""

import numpy as np

from kmcex.core import codec
from kmcex.model.kmodel import get_model


def _pairs(n, k=31, seed=3):
    rng = np.random.default_rng(seed)
    kmers = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, n * 2, dtype=np.uint64), k))[:n]
    counts = np.clip(rng.zipf(1.4, size=len(kmers)), 1, 1023).astype(np.uint32)
    return kmers, counts


def _model_bytes(km, tmp_path, name):
    d = tmp_path / name
    km.save(d)
    return (d / "km.bin").read_bytes(), (d / "rest.bin").read_bytes()


def test_chunked_build_byte_identical(tmp_path):
    kmers, counts = _pairs(300_000)
    one = get_model(1, 1023, 7, 5)
    one.init_from_pairs(kmers, counts, 31)

    low_hist = np.zeros(3, dtype=np.uint64)
    low_hist[0] = np.count_nonzero(counts == 1)
    chunks = [
        (kmers[a:b], counts[a:b])
        for a, b in zip([0, 70_000, 70_001, 200_000],
                        [70_000, 70_001, 200_000, len(kmers)])
    ]
    two = get_model(1, 1023, 7, 5)
    two.init_from_chunks(iter(chunks), 31, len(kmers), low_hist)

    km1, rest1 = _model_bytes(one, tmp_path, "one")
    km2, rest2 = _model_bytes(two, tmp_path, "two")
    assert km1 == km2
    assert rest1 == rest2


def test_chunked_build_ci3(tmp_path):
    kmers, counts = _pairs(100_000, seed=4)
    counts = np.clip(counts, 3, 1023)
    one = get_model(3, 1023, 7, 5)
    one.init_from_pairs(kmers, counts, 31)
    low_hist = np.array(
        [np.count_nonzero(counts == 3 + i) for i in range(3)], dtype=np.uint64
    )
    two = get_model(3, 1023, 7, 5)
    mid = len(kmers) // 3
    two.init_from_chunks(
        iter([(kmers[:mid], counts[:mid]), (kmers[mid:], counts[mid:])]),
        31, len(kmers), low_hist,
    )
    km1, rest1 = _model_bytes(one, tmp_path, "one")
    km2, rest2 = _model_bytes(two, tmp_path, "two")
    assert km1 == km2
    assert rest1 == rest2
