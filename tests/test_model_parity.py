"""End-to-end parity vs the reference implementation.

Builds the *reference* kmcEx model (compiled read-only from /root/reference
via tests/golden/gen_model.cpp) and kmcex's model from the same KMC1
database, then asserts byte equality of header/km.bin/rest.bin and exact
agreement of kmer_to_occ over present + random queries.  This exercises the
whole host pipeline: KMC1 writer -> reference reader interop, Bloom bank,
coupled bit-array encode schedule, rest store, serializer, and query
semantics including the neighbor-disambiguation path.
"""

import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from kmcex.core import codec
from kmcex.io import kmc_db
from kmcex.model.kmodel import get_model, load_model

GOLDEN = pathlib.Path(__file__).parent / "golden"
REF = "/root/reference"


@pytest.fixture(scope="session")
def ref_harness(tmp_path_factory):
    if not os.path.isdir(REF) or shutil.which("g++") is None:
        pytest.skip("reference sources or g++ unavailable")
    exe = tmp_path_factory.mktemp("harness") / "gen_model"
    cmd = [
        "g++", "-O2", "-std=c++11", "-fopenmp", f"-I{REF}",
        "-o", str(exe), str(GOLDEN / "gen_model.cpp"),
        f"{REF}/kmc_api/kmc_file.cpp", f"{REF}/kmc_api/kmer_api.cpp",
        f"{REF}/kmc_api/mmer.cpp",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return str(exe)


def _make_pairs(seed, n, k, ci, cs):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(raw & mask, k))
    counts = np.clip(rng.zipf(1.5, size=len(can)), ci, cs).astype(np.uint64)
    return can, counts, rng


CASES = [
    # (seed, n, k, ci, cs, nh, nb)
    (7, 120000, 31, 1, 1023, 7, 5),
    (8, 80000, 31, 2, 1023, 7, 5),
    (9, 60000, 21, 1, 255, 7, 4),
    (10, 60000, 25, 3, 1023, 6, 3),
]


@pytest.mark.parametrize("seed,n,k,ci,cs,nh,nb", CASES)
def test_model_byte_and_query_parity(ref_harness, tmp_path, seed, n, k, ci, cs, nh, nb):
    can, counts, rng = _make_pairs(seed, n, k, ci, cs)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, k, min_count=ci, max_count=cs)

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    subprocess.run(
        [ref_harness, "build", db, str(ref_dir), str(ci), str(cs), str(nh), str(nb)],
        check=True, capture_output=True,
    )

    km = get_model(ci, cs, nh, nb)
    km.init_from_pairs(can, counts.astype(np.uint32), k)
    my_dir = tmp_path / "mine"
    km.save(my_dir)

    for fn in ["header", "km.bin", "rest.bin"]:
        a = (ref_dir / fn).read_bytes()
        b = (my_dir / fn).read_bytes()
        assert a == b, f"{fn} differs ({len(a)} vs {len(b)} bytes)"

    # query parity: present k-mers + uniform randoms (exercising FP paths)
    q = np.concatenate(
        [can[::7][:2000], rng.integers(0, 1 << (2 * k), size=1000, dtype=np.uint64)]
    )
    qs = [codec.u64_to_string(int(x), k) for x in q]
    ref_q = subprocess.run(
        [ref_harness, "query", str(ref_dir)], input="\n".join(qs),
        capture_output=True, text=True, check=True,
    )
    ref_occ = np.array([int(x) for x in ref_q.stdout.split()], dtype=np.int32)
    mine = np.asarray(km.kmer_to_occ(qs), dtype=np.int32)
    assert np.array_equal(ref_occ, mine)

    # save/load roundtrip answers identically
    km2 = load_model(my_dir)
    mine2 = np.asarray(km2.kmer_to_occ(qs), dtype=np.int32)
    assert np.array_equal(mine2, mine)


@pytest.mark.slow
def test_full_bucket_rotating_flush_parity(ref_harness, tmp_path):
    """Byte parity THROUGH the feed-triggered rotating flush: the coupled
    bit-array insertion buffer flushes only once n_bits * 2^18 (~1.31M)
    array-bound k-mers accumulate (kmodel.hpp:508-527 / kx_encoder_feed),
    running the full insert_with_thread rotation + reorder_buffer + rest
    hand-off (kmodel.hpp:529-573).  Smaller parity cases never reach it;
    this one pushes ~1.7M k-mers with counter >= ci+bf_num through both
    encoders and asserts km.bin/rest.bin byte equality."""
    k, ci, cs, nh, nb = 31, 1, 1023, 7, 5
    rng = np.random.default_rng(42)
    raw = rng.integers(0, 1 << 62, size=2_200_000, dtype=np.uint64)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    can = np.unique(codec.canonical_np(raw & mask, k))
    assert len(can) > 1_900_000
    # ~90% of counters >= ci + bf_num(=1) + 1 = 2 -> coupled arrays; the
    # rest count 1 -> Bloom pair 0 (mixed routing like a real build)
    counts = np.where(
        rng.random(len(can)) < 0.9,
        rng.integers(2, 200, size=len(can), dtype=np.uint64),
        np.uint64(1),
    )
    n_array_bound = int(np.count_nonzero(counts >= ci + 1))
    assert n_array_bound > 5 * (1 << 18) + 200_000  # well past one flush

    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, k, min_count=ci, max_count=cs)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    subprocess.run(
        [ref_harness, "build", db, str(ref_dir), str(ci), str(cs), str(nh), str(nb)],
        check=True, capture_output=True,
    )

    km = get_model(ci, cs, nh, nb)
    km.init_from_pairs(can, counts.astype(np.uint32), k)
    my_dir = tmp_path / "mine"
    km.save(my_dir)
    for fn in ["header", "km.bin", "rest.bin"]:
        a = (ref_dir / fn).read_bytes()
        b = (my_dir / fn).read_bytes()
        assert a == b, f"{fn} differs ({len(a)} vs {len(b)} bytes)"


def test_reference_reads_our_kmc1_db(ref_harness, tmp_path):
    can, counts, _ = _make_pairs(3, 30000, 31, 1, 1023)
    db = str(tmp_path / "db")
    kmc_db.write_kmc1(db, can, counts, 31, min_count=1, max_count=1023)
    out = subprocess.run(
        [ref_harness, "list", db], capture_output=True, text=True, check=True
    )
    lines = out.stdout.strip().split("\n")
    assert len(lines) == len(can)
    got_k = np.array([codec.string_to_u64(l.split()[0]) for l in lines], dtype=np.uint64)
    got_c = np.array([int(l.split()[1]) for l in lines], dtype=np.uint32)
    np.testing.assert_array_equal(got_k, can)
    np.testing.assert_array_equal(got_c, counts.astype(np.uint32))


def test_reference_reads_our_quake_db(ref_harness, tmp_path):
    """Quake-mode (mode=1, float counter) databases we write are readable by
    the vendored float ReadNextKmer overload (kmc_file.cpp:408-420)."""
    can, _, rng = _make_pairs(4, 20000, 31, 1, 1023)
    fcounts = (rng.random(len(can)) * 50).astype(np.float32) + np.float32(0.25)
    db = str(tmp_path / "qdb")
    kmc_db.write_kmc1(db, can, fcounts, 31, min_count=1,
                      max_count=0xFFFFFFFF, mode=1)
    out = subprocess.run(
        [ref_harness, "listf", db], capture_output=True, text=True, check=True
    )
    lines = out.stdout.strip().split("\n")
    assert len(lines) == len(can)
    got_k = np.array([codec.string_to_u64(l.split()[0]) for l in lines], dtype=np.uint64)
    got_c = np.array([float(l.split()[1]) for l in lines], dtype=np.float32)
    np.testing.assert_array_equal(got_k, can)
    np.testing.assert_array_equal(got_c, fcounts)
