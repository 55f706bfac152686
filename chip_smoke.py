"""End-to-end check of count -> encode -> query on the GPU.

Runs the system's main path once through the entry points a user calls, at
the scale of a bacterial genome (2 Mbp, 533k x 150 bp reads at 40x
coverage, 0.5% per-base errors; about 64M k-mer windows), and compares every
product exactly with an independent reference:

  1. device: JAX's backend must be the GPU; never continues on the CPU;
  2. the CLI (``kmcex.cli.main``) counts and encodes; its KMC1 database
     must list exactly the numpy oracle's canonical k-mers and counts, and
     its saved model must be byte-equal to one built on the host from the
     oracle pairs;
  3. the model-only path (``count_encode(keep_pairs=False)``: device Bloom
     build plus low-key drop) must save the same bytes;
  4. ``DeviceKModel.kmer_to_occ`` must equal the host ``kmer_to_occ_u64`` on
     1M queries, half present and half random.

``--four`` runs only the four-card phase and its comparisons: the
hash-sharded accumulator with the mesh Bloom build must give a model
byte-equal to a single-card build of the same input, and the sharded query
server must answer as the host does.

Usage: ``python chip_smoke.py [--four]``.  The last line of standard output
is one JSON object ``{"ok": true, "device": {...}}``; any failure exits
non-zero without printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

K, CI, CS, NH, NB = 31, 1, 1023, 7, 5
GENOME_LEN, N_READS, ERR_RATE, SEED = 2_000_000, 533_000, 0.005, 4242
N_QUERIES = 1_000_000
MODEL_FILES = ("header", "km.bin", "rest.bin")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ---------------------------------------------------------------

def require_gpu(n_devices: int):
    """The backend and every device used must be the GPU."""
    import jax

    backend = jax.default_backend()
    devices = jax.devices()
    check(backend == "gpu",
          f"JAX backend is {backend!r}, not 'gpu'; refusing to run on it")
    check(len(devices) >= n_devices,
          f"need {n_devices} GPU(s), JAX sees {len(devices)}")
    used = devices[:n_devices]
    check(all(d.platform == "gpu" for d in used),
          f"non-GPU device among {used}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    log(f"card: {card}")
    return used, card.splitlines()[0]


# -- oracle and comparison helpers (no GPU needed) --------------------------

def make_input(path: str, genome_len: int = GENOME_LEN,
               n_reads: int = N_READS, seed: int = SEED) -> None:
    from bench import make_fastq

    make_fastq(pathlib.Path(path), genome_len=genome_len, n_reads=n_reads,
               seed=seed, err_rate=ERR_RATE)


def oracle_pairs(fastq: str, k: int = K, cs: int = CS):
    """Canonical k-mer listing of a FASTQ file in plain numpy, independent
    of the system under test: each sequence line packed 2-bit MSB-first
    (A=0 C=1 G=2 T=3), windows holding any other base dropped, reverse
    complement = complemented bases in reverse order, canonical = the
    smaller.  Returns ascending (kmers u64, counts u32 clamped to cs)."""
    lines = pathlib.Path(fastq).read_bytes().split(b"\n")[1::4]
    lines = [ln for ln in lines if ln]
    L = len(lines[0])
    check(all(len(ln) == L for ln in lines), "oracle expects equal lengths")
    seq = np.frombuffer(b"".join(lines), dtype=np.uint8).reshape(-1, L)
    lut = np.full(256, 4, dtype=np.uint8)
    for code, base in enumerate(b"ACGT"):
        lut[base] = code
    codes = lut[seq]
    W = L - k + 1
    bad = np.cumsum(np.pad(codes == 4, ((0, 0), (1, 0))), axis=1)
    ok = (bad[:, k:] - bad[:, :W]) == 0
    c = np.where(codes == 4, 0, codes).astype(np.uint64)
    fwd = np.zeros((len(c), W), dtype=np.uint64)
    rc = np.zeros((len(c), W), dtype=np.uint64)
    for t in range(k):
        fwd = (fwd << np.uint64(2)) | c[:, t:t + W]
        rc |= (np.uint64(3) - c[:, t:t + W]) << np.uint64(2 * t)
    canon = np.minimum(fwd, rc)[ok]
    kmers, counts = np.unique(canon, return_counts=True)
    return kmers, np.minimum(counts, cs).astype(np.uint32)


def model_bytes(model_dir: str) -> dict[str, bytes]:
    return {n: (pathlib.Path(model_dir) / n).read_bytes() for n in MODEL_FILES}


def host_model(kmers, counts, save_dir: str, k: int = K):
    """Model built on the host from a listing (host Bloom insert)."""
    from kmcex.model.kmodel import get_model

    km = get_model(CI, CS, NH, NB)
    km.init_from_pairs(kmers, counts, k)
    km.save(save_dir)
    return km


def same_model(got: dict[str, bytes], want: dict[str, bytes],
               what: str) -> None:
    for name in MODEL_FILES:
        check(got[name] == want[name],
              f"{what}: {name} differs ({len(got[name])} vs "
              f"{len(want[name])} bytes)")


def query_mix(kmers, n: int = N_QUERIES, k: int = K, seed: int = 0):
    """Half present keys, half random k-mers, shuffled."""
    rng = np.random.default_rng(seed)
    mask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
    q = np.concatenate([
        rng.choice(kmers, n // 2),
        rng.integers(0, 1 << 62, n - n // 2, dtype=np.uint64) & mask])
    rng.shuffle(q)
    return q


# -- phases 2-5 ------------------------------------------------------------

def phase_cli(fastq: str, tmp: str, oracle, card: str):
    """Count + encode through the CLI; DB listing and model vs the oracle."""
    from kmcex import cli
    from kmcex.io import kmc_db

    db = os.path.join(tmp, "db", "reads.res")
    work = os.path.join(tmp, "work")
    os.makedirs(os.path.dirname(db))
    os.makedirs(work)
    t0 = time.perf_counter()
    rc = cli.main(["kmcex", f"-k{K}", f"-nh{NH}", f"-nb{NB}", fastq, db,
                   work])
    wall = time.perf_counter() - t0
    check(rc == 0, f"CLI exited {rc}")
    lk, lc = kmc_db.KMCReader(db).list_all()
    want_k, want_c = oracle
    check(np.array_equal(lk, want_k),
          f"KMC listing keys differ from the oracle ({len(lk)} vs "
          f"{len(want_k)} k-mers)")
    check(np.array_equal(np.asarray(lc, np.uint32), want_c),
          "KMC listing counts differ from the oracle")
    host_dir = os.path.join(tmp, "host_model")
    host_model(want_k, want_c, host_dir)
    want = model_bytes(host_dir)
    same_model(model_bytes(os.path.join(work, "reads.res")), want,
               "CLI model vs host build")
    log(f"phase cli: ok; {len(want_k)} distinct k-mers; wall "
        f"{wall:.3f} s cold (compilation included) [{card}]")
    return want


def phase_model_only(fastq: str, tmp: str, want, card: str, reps: int = 2):
    """keep_pairs=False: device Bloom build plus low-key drop."""
    from kmcex.count.pipeline import count_encode

    walls = []
    for i in range(reps):
        t0 = time.perf_counter()
        km, _, _, stats = count_encode(fastq, k=K, ci=CI, cs=CS,
                                       num_hash=NH, num_bit=NB,
                                       keep_pairs=False)
        walls.append(time.perf_counter() - t0)
        check("encode.bloom_pull" in stats.phases
              and "finalize.drop_low" in stats.phases,
              f"device Bloom path did not run: {sorted(stats.phases)}")
        d = os.path.join(tmp, f"model_only_{i}")
        km.save(d)
        same_model(model_bytes(d), want, "model-only vs host build")
    rate = stats.reads / walls[-1]
    log(f"phase model-only: ok; {stats.reads} reads; walls "
        f"{[round(w, 3) for w in walls]} s (first cold); "
        f"{rate:.0f} reads/s warm [{card}]")
    log("phase model-only phases (warm, s): " + json.dumps(
        {k: round(v, 4) for k, v in sorted(stats.phases.items(),
                                          key=lambda kv: -kv[1])}))
    return km


def phase_query(km, kmers, card: str, n: int = N_QUERIES):
    """Device kmer_to_occ vs the host answers, exactly."""
    from kmcex.query.device_model import DeviceKModel

    q = query_mix(kmers, n)
    want = km.kmer_to_occ_u64(q)
    dm = DeviceKModel(km)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = dm.kmer_to_occ(q)
        walls.append(time.perf_counter() - t0)
        check(np.array_equal(got, want),
              f"device answers differ on {np.count_nonzero(got != want)} "
              f"of {n} queries")
    log(f"phase query: ok; {n} queries; walls {[round(w, 3) for w in walls]}"
        f" s (first cold); {n / walls[-1] / 1e6:.3f} Mq/s warm [{card}]")


def phase_four(fastq: str, tmp: str, devices, card: str) -> None:
    """Sharded count + mesh Bloom build and sharded serving on 4 cards."""
    from kmcex.count.pipeline import count_encode
    from kmcex.parallel.serve import ShardedKModelServer
    from kmcex.parallel.sharded import make_mesh

    kw = dict(k=K, ci=CI, cs=CS, num_hash=NH, num_bit=NB, keep_pairs=False)
    km1, listing, _, _ = count_encode(fastq, **dict(kw, keep_pairs=True))
    d1 = os.path.join(tmp, "single")
    km1.save(d1)
    mesh = make_mesh(devices=devices)
    walls = []
    for i in range(2):
        t0 = time.perf_counter()
        km4, _, _, stats = count_encode(fastq, accumulator="sharded",
                                        mesh=mesh, **kw)
        walls.append(time.perf_counter() - t0)
        check("encode.bloom_pull" in stats.phases,
              f"mesh Bloom build did not run: {sorted(stats.phases)}")
        d4 = os.path.join(tmp, f"sharded_{i}")
        km4.save(d4)
        same_model(model_bytes(d4), model_bytes(d1),
                   "sharded model vs single-card build")
    log(f"phase four: sharded model ok; walls "
        f"{[round(w, 3) for w in walls]} s (first cold); "
        f"{stats.reads / walls[-1]:.0f} reads/s warm on {len(devices)} "
        f"cards [{card}]")
    q = query_mix(listing)
    want = km1.kmer_to_occ_u64(q)
    srv = ShardedKModelServer(km4, mesh)
    for _ in range(2):
        t0 = time.perf_counter()
        got = srv.kmer_to_occ(q)
        wall = time.perf_counter() - t0
        check(np.array_equal(got, want),
              f"sharded server differs on {np.count_nonzero(got != want)} "
              f"queries")
    log(f"phase four: sharded server ok; {len(q) / wall / 1e6:.3f} Mq/s "
        f"warm on {len(devices)} cards [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1
    try:
        devices, card = require_gpu(n_dev)
        import jax

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            fq = os.path.join(tmp, "reads.fastq")
            t0 = time.perf_counter()
            make_input(fq)
            log(f"input: {N_READS} reads x 150 bp from a {GENOME_LEN} bp "
                f"genome, {time.perf_counter() - t0:.1f} s to write")
            if args.four:
                phase_four(fq, tmp, devices, card)
            else:
                t0 = time.perf_counter()
                oracle = oracle_pairs(fq)
                log(f"oracle: {len(oracle[0])} distinct k-mers in "
                    f"{time.perf_counter() - t0:.1f} s")
                want = phase_cli(fq, tmp, oracle, card)
                km = phase_model_only(fq, tmp, want, card)
                phase_query(km, oracle[0], card)
            stats = devices[0].memory_stats() or {}
            log(f"device 0 peak bytes in use: "
                f"{stats.get('peak_bytes_in_use', 'not reported')}")
        d = jax.devices()[0]
        print(json.dumps({"ok": True, "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}}))
        return 0
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
