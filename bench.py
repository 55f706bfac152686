"""Benchmark: count+encode throughput of the pipeline on the GPU.

Workload: synthetic 150bp reads drawn from a simulated genome (deterministic
seed), k=31, nh=7, nb=5, ci=1, cs=1023 — the reference's default config
(BASELINE.json config 1).  The pipeline measured is the full kmcEx
equivalent: FASTQ parse -> device extract/canonicalize/count -> merge ->
KModel encode (Bloom bank + coupled bit arrays + rest store).

Refuses to run on anything but the GPU; any phase that fails stops the
run.  Inputs are generated into a temporary directory.  The last line of
standard output is one JSON object with the figures and the device they
were measured on (platform, kind, count, and the card's name and power
limit from nvidia-smi).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

N_READS = int(os.environ.get("KMCEX_BENCH_READS", 200_000))
BATCH_SEGS = int(os.environ.get("KMCEX_BENCH_BATCH_SEGS", 0)) or None
READ_LEN = 150
GENOME_LEN = 2_000_000
K, NH, NB, CI, CS = 31, 7, 5, 1, 1023


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_fastq(path: pathlib.Path, genome_len: int = GENOME_LEN,
               n_reads: int = N_READS, seed: int = 12345,
               err_rate: float = 0.002) -> None:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    starts = rng.integers(0, genome_len - READ_LEN, size=n_reads)
    idx = starts[:, None] + np.arange(READ_LEN)[None, :]
    reads = genome[idx]
    # sequencing errors + rare Ns (0.05%)
    err = rng.random(reads.shape) < err_rate
    reads = np.where(err, (reads + rng.integers(1, 4, size=reads.shape)) % 4, reads)
    acgt = np.frombuffer(b"ACGTN", dtype=np.uint8)
    ascii_reads = acgt[reads]
    ascii_reads[rng.random(reads.shape) < 0.0005] = ord("N")
    qual = np.full(READ_LEN, ord("I"), dtype=np.uint8)
    with open(path, "wb") as f:
        chunk = []
        for i in range(n_reads):
            chunk.append(b"@r%d\n" % i)
            chunk.append(ascii_reads[i].tobytes())
            chunk.append(b"\n+\n")
            chunk.append(qual.tobytes())
            chunk.append(b"\n")
            if len(chunk) >= 5000:
                f.write(b"".join(chunk))
                chunk = []
        f.write(b"".join(chunk))


def require_gpu() -> str:
    """Fail unless JAX runs on the GPU; returns nvidia-smi's name and power
    limit for the card."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench: JAX backend is {jax.default_backend()!r},"
                         f" not 'gpu'")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> None:
    card = require_gpu()
    log(f"card: {card}")
    with tempfile.TemporaryDirectory(prefix="kmcex_bench_") as d:
        run(pathlib.Path(d), card)


def run(bench_dir: pathlib.Path, card: str) -> None:
    fq = bench_dir / f"reads_{N_READS}.fastq"
    log("generating synthetic FASTQ ...")
    make_fastq(fq)

    from kmcex.count.pipeline import count_encode
    from kmcex.io import kmc_db

    kwargs = {}
    if BATCH_SEGS:
        kwargs["batch_segs"] = BATCH_SEGS
    # Warm-up pass compiles the kernels (cached for the measured pass) and
    # collects the (kmers, counts) table the secondary metrics need (query
    # sampling, the false-positive set).
    log("warm-up (compilation) ...")
    _, kmers, counts, _ = count_encode(
        str(fq), k=K, ci=CI, cs=CS, num_hash=NH, num_bit=NB, **kwargs)

    # Measured: the MODEL-ONLY path (keep_pairs=False, no DB spool) — the
    # product of the run is the encoded model, exactly what the reference's
    # encode phase produces; on this path the Bloom bank is built on device
    # and low-count keys never cross the host link (model/device_bloom.py).
    # Best of n passes: host-side phases share the machine's cores.
    n_rep = int(os.environ.get("KMCEX_BENCH_REPS", 6))
    best = None
    for rep in range(n_rep):
        log(f"measured pass {rep + 1}/{n_rep} ...")
        t0 = time.time()
        km, _, _, stats = count_encode(
            str(fq), k=K, ci=CI, cs=CS, num_hash=NH, num_bit=NB,
            keep_pairs=False, **kwargs
        )
        t_total = time.time() - t0
        if best is None or t_total < best[0]:
            best = (t_total, stats.count_seconds, km, stats)
    t_total, t_count, km, stats = best
    reads_per_s = stats.reads / t_total
    log(
        f"ours: {stats.reads} reads, {stats.windows} windows, "
        f"{stats.distinct_kmers} distinct kmers; count {t_count:.2f}s + "
        f"encode {t_total - t_count:.2f}s -> {reads_per_s:,.0f} reads/s"
    )
    phases = {k: round(v, 3) for k, v in sorted(
        stats.phases.items(), key=lambda kv: -kv[1])}
    log(f"phase breakdown (best pass): {json.dumps(phases)}")

    # Secondary metrics: query throughput on host (native) and device
    # paths.
    host_mqs = dev_mqs = compute_mqs = 0.0
    if os.environ.get("KMCEX_BENCH_QUERY", "1") != "0":
        rng = np.random.default_rng(0)
        nq = 1_000_000
        q = np.concatenate([
            rng.choice(kmers, nq // 2),
            rng.integers(0, 1 << 62, nq // 2, dtype=np.uint64),
        ])
        rng.shuffle(q)
        km.kmer_to_occ_u64(q[:1000])  # warm
        best_h = 1e9
        for _ in range(2):
            t0 = time.time()
            km.kmer_to_occ_u64(q)
            best_h = min(best_h, time.time() - t0)
        host_mqs = nq / best_h / 1e6
        log(f"host kmer_to_occ: {host_mqs:.2f} Mqueries/s")
        from kmcex.query.device_model import DeviceKModel

        dm = DeviceKModel(km)
        dm.kmer_to_occ(q[: dm.TILE])  # compile (main + resolve shapes)
        # compute-only (device-resident queries, no host link),
        # measured BEFORE the end-to-end runs, best of 3 groups
        import jax as _jax

        qd = _jax.device_put(q[: dm.TILE])
        _jax.block_until_ready(qd)
        _jax.block_until_ready(dm._main(qd)[0])
        reps = 8
        t_main = 1e9
        for _ in range(3):
            t0 = time.time()
            for _ in range(reps):
                o = dm._main(qd)
            _jax.block_until_ready(o[0])
            t_main = min(t_main, (time.time() - t0) / reps)
        compute_mqs = dm.TILE / t_main / 1e6
        log(f"device kmer_to_occ compute-only (phase 1, device-resident "
            f"input): {compute_mqs:.2f} Mqueries/s")
        best_q = 1e9
        for _ in range(3):
            t0 = time.time()
            dm.kmer_to_occ(q)
            best_q = min(best_q, time.time() - t0)
        dev_mqs = nq / best_q / 1e6
        log(f"device kmer_to_occ: {dev_mqs:.2f} Mqueries/s")

        # gather roofline: pure random gathers matching the query
        # path's ACTUAL probe inventory on the gated program —
        # 35*3/4 u16 (3/4-tile find_bitarray) + 16 u8 (bloom bank +
        # km_back) + 2 u64 + 2 i32 (cuckoo rest) per query — so
        # (compute-only / roofline) says how close the full decision
        # tree runs to a gather-only ceiling (u64 and u16 gathers differ
        # in cost, so each table type is timed at its own width).
        import jax.numpy as _jnp

        def _gather_time(dtype, n_per_q, elems, lanes=None):
            lanes = lanes if lanes is not None else dm.TILE
            tab_ = _jax.device_put(_jnp.zeros(max(elems, 8), dtype))
            gi_ = _jax.device_put(_jnp.asarray(
                rng.integers(0, max(elems, 8),
                             size=(lanes, n_per_q)), dtype=_jnp.int32))
            gf_ = _jax.jit(
                lambda i: _jnp.sum(tab_[i].astype(_jnp.uint32)))
            _jax.block_until_ready(gf_(gi_))
            t0_ = time.time()
            for _ in range(reps):
                o_ = gf_(gi_)
            _jax.block_until_ready(o_)
            return (time.time() - t0_) / reps

        bit12_elems = NB * km.km_byte_size
        bf_bytes = int(km.bloom.byte_bf.sum()
                       + km.bloom.byte_bf_back.sum()) + km.byte_km_back
        t_g = (_gather_time(_jnp.uint16, NB * NH, bit12_elems,
                            lanes=(3 * dm.TILE) // 4)
               + _gather_time(_jnp.uint8, 2 * NH + 2, max(bf_bytes, 8))
               + _gather_time(_jnp.uint64, 2, 1 << 22)
               + _gather_time(_jnp.int32, 2, 1 << 22))
        log(f"composite gather roofline (gated probe inventory): "
            f"{dm.TILE / t_g / 1e6:.2f} Mqueries/s; "
            f"query path at {100 * t_g / t_main:.0f}% of roofline")

    # Measured false-positive rate of kmer_to_occ on absent k-mers.  The
    # reference README claims its FP rate beats BF-based count baselines
    # by ~2 orders of magnitude (/root/reference/README.md:3) but prints
    # no number; byte-parity with the reference makes OUR measured rate
    # exactly ITS rate on this input — recorded here so the claim has a
    # concrete, reproducible figure.  (The paper's baseline construction
    # — count-answering Bloom-filter banks at its chosen operating points
    # — is not in the repo, so only our side is measurable.)
    fp_rate = 0.0
    if os.environ.get("KMCEX_BENCH_QUERY", "1") != "0":
        rng = np.random.default_rng(99)
        mask2k = (np.uint64(1) << np.uint64(2 * K)) - np.uint64(1)
        cand = rng.integers(0, 1 << 62, 400_000, dtype=np.uint64) & mask2k
        from kmcex.core import codec as _codec

        cand = np.unique(_codec.canonical_np(cand, K))
        absent = cand[~np.isin(cand, kmers)]
        occ = km.kmer_to_occ_u64(absent)
        fp_rate = float(np.count_nonzero(occ)) / len(absent)
        log(f"false-positive rate on {len(absent)} absent k-mers: "
            f"{fp_rate:.2e} (== the reference's rate by byte parity; "
            f"model {km.total_model_bytes() >> 20}MB for "
            f"{km.total_kmer_count} k-mers with counts)")

    # Memory-saving ratio in the reference's regime (README.md:3: "average
    # memory-saving ratio on all 31-mers is as high as 13.81 as compared with
    # RAW INPUT"): a ~30x-coverage workload (the main bench's 15x synthetic is
    # low-coverage, which shrinks the ratio).  "Raw input" is the textual
    # k-mer listing (k bases + count per line), matching the paper's
    # raw-counter-output framing; the binary KMC database ratio is reported
    # alongside.  Byte-parity with the reference means these ratios equal the
    # reference's own on identical input.
    mem_ratio_raw = mem_ratio_db = 0.0
    if os.environ.get("KMCEX_BENCH_MEMRATIO", "1") != "0":
        fq30 = bench_dir / "reads_cov30.fastq"
        log("generating 30x-coverage FASTQ ...")
        make_fastq(fq30, genome_len=1_000_000, n_reads=200_000, seed=777)
        km30, k30, c30, _ = count_encode(
            str(fq30), k=K, ci=CI, cs=CS, num_hash=NH, num_bit=NB
        )
        raw_bytes = int(np.sum(K + 2 + np.char.str_len(c30.astype("U"))))
        db30 = bench_dir / "bench_db30"
        kmc_db.write_kmc1(str(db30), k30, c30.astype(np.uint64), K,
                          min_count=CI, max_count=CS)
        db30_bytes = sum(
            os.path.getsize(str(db30) + ext) for ext in (".kmc_pre", ".kmc_suf")
        )
        model_bytes = km30.total_model_bytes()
        mem_ratio_raw = raw_bytes / model_bytes
        mem_ratio_db = db30_bytes / model_bytes
        log(f"memory-saving ratio at 30x coverage ({len(k30)} distinct): "
            f"{mem_ratio_raw:.2f}x vs raw listing ({raw_bytes >> 20}MB), "
            f"{mem_ratio_db:.2f}x vs KMC database ({db30_bytes >> 20}MB) "
            f"-> model {model_bytes >> 20}MB")

    # Memory-saving ratio with a REALISTIC k-mer count spectrum: the
    # reference's 13.81x average (README.md:3) is on real sequencing data,
    # whose spectrum is dominated by an error-singleton tail (every base
    # error spawns up to k singleton k-mers) plus a high-coverage body.
    # Singletons land in the Bloom bank at ~nh-1 bits each vs ~2*nb*nh/16
    # bytes in the coupled arrays, so the ratio rises with the singleton
    # mass; the main bench's low-error workload understates it.  0.5%/base
    # errors at 40x coverage reproduces the regime.
    mem_ratio_realistic = 0.0
    realistic_mreads_s = 0.0
    if os.environ.get("KMCEX_BENCH_MEMRATIO", "1") != "0":
        fqr = bench_dir / "reads_realistic.fastq"
        log("generating realistic-spectrum FASTQ (40x, 0.5% errors) ...")
        make_fastq(fqr, genome_len=2_000_000, n_reads=533_000,
                   seed=4242, err_rate=0.005)
        # pass 1: warm this shape's compiles + collect the table for
        # the ratios
        kmr, kr, cr, rstats = count_encode(
            str(fqr), k=K, ci=CI, cs=CS, num_hash=NH, num_bit=NB
        )
        # timed: the model-only path, best-of-2
        t_real = None
        for _ in range(2):
            t0 = time.time()
            kmr, _, _, rstats = count_encode(
                str(fqr), k=K, ci=CI, cs=CS, num_hash=NH, num_bit=NB,
                keep_pairs=False,
            )
            t_real = min(t_real or 1e9, time.time() - t0)
        n_single = int(np.count_nonzero(cr == 1))
        log(f"realistic-spectrum count+encode: {rstats.reads} reads in "
            f"{t_real:.2f}s -> {rstats.reads / t_real / 1e6:.3f} Mreads/s "
            f"({100 * n_single / max(len(kr), 1):.0f}% singletons -> "
            f"the Bloom bank takes most keys; built on device)")
        log("realistic phases: " + json.dumps({
            k_: round(v, 3) for k_, v in sorted(
                rstats.phases.items(), key=lambda kv: -kv[1])}))
        raw_bytes_r = int(np.sum(K + 2 + np.char.str_len(cr.astype("U"))))
        model_bytes_r = kmr.total_model_bytes()
        mem_ratio_realistic = raw_bytes_r / model_bytes_r
        log(f"memory-saving ratio, realistic spectrum ({len(kr)} distinct, "
            f"{100 * n_single / max(len(kr), 1):.0f}% singletons): "
            f"{mem_ratio_realistic:.2f}x vs raw listing "
            f"({raw_bytes_r >> 20}MB -> model {model_bytes_r >> 20}MB)")
        realistic_mreads_s = rstats.reads / t_real / 1e6

    import jax

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "count+encode throughput (k=31, nh=7, nb=5, 150bp reads)",
        "value": round(reads_per_s / 1e6, 4),
        "unit": "Mreads/s",
        "realistic_mreads_s": realistic_mreads_s,
        "mem_ratio_30x_vs_raw_input": round(mem_ratio_raw, 2),
        "mem_ratio_30x_vs_kmc_db": round(mem_ratio_db, 2),
        "mem_ratio_realistic": round(mem_ratio_realistic, 2),
        "host_query_mqs": round(host_mqs, 2),
        "device_query_mqs": round(dev_mqs, 2),
        "device_query_compute_mqs": round(compute_mqs, 2),
        "fp_rate": fp_rate,
        "phases": phases,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
