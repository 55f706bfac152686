"""Scale soak on the GPU: >=10x the bench workload, real spill
thresholds, sustained-throughput + tier-transition + peak-RSS record, and
an independent numpy oracle check of the full table (the closest
NA12878-config proxy one card allows).

Usage: python tools/soak.py [n_reads] [out_json]
Writes the JSON artifact (default chiprun_out/soak.json).
"""

import json
import pathlib
import resource
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
import numpy as np

N_READS = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
OUT = pathlib.Path(sys.argv[2]) if len(sys.argv) > 2 else (
    pathlib.Path(__file__).parent.parent / "chiprun_out" / "soak.json")
GENOME = 20_000_000
K = 31


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    import bench

    card = bench.require_gpu()
    log(f"card: {card}")
    with tempfile.TemporaryDirectory(prefix="kmcex_soak_") as d:
        return soak(pathlib.Path(d) / "reads_soak.fastq", card)


def soak(fq: pathlib.Path, card: str) -> int:
    import bench
    import chip_smoke

    log(f"generating soak FASTQ ({N_READS} reads, {GENOME} base genome)")
    bench.make_fastq(fq, genome_len=GENOME, n_reads=N_READS, seed=2025)

    from kmcex.count.pipeline import count_encode

    # pass 1 warms this scale's compile shapes; pass 2 is the record
    log("pass 1 (warm) ...")
    t0 = time.time()
    count_encode(str(fq), k=K, ci=1, cs=1023, num_hash=7, num_bit=5,
                 keep_pairs=False)
    t_warm = time.time() - t0
    log(f"pass 1: {t_warm:.1f}s")
    log("pass 2 (timed) ...")
    t0 = time.time()
    km, _, _, stats = count_encode(str(fq), k=K, ci=1, cs=1023, num_hash=7,
                                   num_bit=5, keep_pairs=False)
    wall = time.time() - t0
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    rate = stats.reads / wall / 1e6
    log(f"soak: {stats.reads} reads, {stats.windows} windows, "
        f"{stats.distinct_kmers} distinct in {wall:.1f}s -> {rate:.3f} "
        f"Mreads/s; tiers {stats.tiers}; peak RSS {rss_mb}MB")

    # verification pass (keeps pairs) + independent numpy oracle
    log("verification pass + oracle ...")
    _, kmers, counts, _ = count_encode(str(fq), k=K, ci=1, cs=1023,
                                      num_hash=7, num_bit=5)
    want_k, want_c = chip_smoke.oracle_pairs(str(fq), K, 1023)
    ok_keys = np.array_equal(kmers, want_k)
    ok_counts = np.array_equal(counts.astype(np.uint32), want_c)
    log(f"oracle: keys {'OK' if ok_keys else 'MISMATCH'}, counts "
        f"{'OK' if ok_counts else 'MISMATCH'} ({len(want_k)} distinct)")

    # model totals line up with the table
    ok_model = km.total_kmer_count == len(want_k)

    artifact = {
        "card": card,
        "workload": {"n_reads": N_READS, "read_len": 150,
                     "genome_len": GENOME, "k": K, "err_rate": 0.002,
                     "seed": 2025},
        "wall_seconds": round(wall, 2),
        "warm_pass_seconds": round(t_warm, 2),
        "mreads_per_s": round(rate, 4),
        "windows": stats.windows,
        "distinct_kmers": stats.distinct_kmers,
        "count_seconds": round(stats.count_seconds, 2),
        "encode_seconds": round(stats.encode_seconds, 2),
        "phases": {k_: round(v, 3) for k_, v in stats.phases.items()},
        "tiers": stats.tiers,
        "peak_rss_mb": rss_mb,
        "oracle": {"keys_exact": bool(ok_keys),
                   "counts_exact": bool(ok_counts),
                   "model_total_matches": bool(ok_model)},
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(artifact, indent=1) + "\n")
    log(f"wrote {OUT}")
    return 0 if (ok_keys and ok_counts and ok_model) else 1


if __name__ == "__main__":
    sys.exit(main())
