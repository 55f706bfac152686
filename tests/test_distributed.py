"""Multi-host runtime test: 2 spawned processes, a process-spanning mesh,
and the hash-routed sharded count running all_to_all ACROSS the process
boundary (BASELINE config 5's code path, SURVEY.md §5 "distributed
communication backend" — validated on CPU because multi-host GPU
clusters aren't available in CI, exactly like the virtual single-process mesh tests).

Each worker process forces the CPU platform with 4 virtual devices, joins a
2-process jax.distributed world (8 global devices), streams its half of the
batches into ShardedCountAccumulator, and writes the finalized table; the
parent asserts both processes produced the identical, correct table.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from kmcex.parallel import distributed
distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())

from kmcex.parallel.sharded import ShardedCountAccumulator

mesh = distributed.global_mesh()
K, SEG_ROWS, SEG_LEN = 7, 4, 24  # 4 rows per device
acc = ShardedCountAccumulator(mesh, K, SEG_ROWS, SEG_LEN)

rng = np.random.default_rng(123)  # same stream on both; each takes its half
for _ in range(3):
    batch = rng.integers(0, 4, size=(8 * SEG_ROWS, SEG_LEN)).astype(np.uint8)
    batch[rng.random(batch.shape) < 0.02] = 255  # sprinkle of Ns
    local = batch[pid * 16 : (pid + 1) * 16]  # this host's device rows
    acc.add_batch(distributed.process_local_batch(mesh, local))

kmers, counts = acc.finalize(ci=1)
np.savez(out_path, kmers=kmers, counts=counts)
print("OK", len(kmers), flush=True)
"""


COUNT_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]
fq_path = sys.argv[4]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from kmcex.parallel import distributed
distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2

# single big uncompressed file -> each process gets a byte range
items = distributed.host_input_slices(fq_path)
assert len(items) == 1 and items[0][1] is not None, items

kmers, counts = distributed.distributed_count_fastq(
    fq_path, k=9, ci=1, cs=1023, seg_len=32, batch_segs=4)
np.savez(out_path, kmers=kmers, counts=counts)
print("OK", len(kmers), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_all_to_all_count(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    outs = [tmp_path / f"out{i}.npz" for i in range(2)]
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port), str(outs[i])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out.decode()[-2000:], err.decode()[-2000:])
        assert b"OK" in out

    # both processes saw the identical global table
    r0, r1 = np.load(outs[0]), np.load(outs[1])
    np.testing.assert_array_equal(r0["kmers"], r1["kmers"])
    np.testing.assert_array_equal(r0["counts"], r1["counts"])

    # and it matches a single-process brute-force count of the same input
    from collections import Counter

    from kmcex.core import codec

    rng = np.random.default_rng(123)
    want: Counter = Counter()
    k = 7
    for _ in range(3):
        batch = rng.integers(0, 4, size=(32, 24)).astype(np.uint8)
        batch[rng.random(batch.shape) < 0.02] = 255
        for row in batch:
            for s in range(24 - k + 1):
                win = row[s : s + k]
                if (win < 4).all():
                    v = 0
                    for b in win:
                        v = (v << 2) | int(b)
                    want[int(codec.canonical_np(np.array([v], np.uint64), k)[0])] += 1
    exp_k = np.array(sorted(want), dtype=np.uint64)
    exp_c = np.array([want[int(x)] for x in exp_k], dtype=np.uint32)
    np.testing.assert_array_equal(r0["kmers"], exp_k)
    np.testing.assert_array_equal(r0["counts"], exp_c)


@pytest.mark.slow
def test_two_process_distributed_count_fastq(tmp_path):
    """The actual multi-host driver (distributed_count_fastq) on ONE big
    uncompressed FASTQ: byte-range split across processes, lockstep batch
    feeding (unequal per-host batch counts), equality with a single-process
    count of the same file."""
    from tests.test_byte_ranges import _write_fastq

    fq = tmp_path / "big.fastq"
    _write_fastq(fq, n_reads=350, seed=99)

    worker = tmp_path / "count_worker.py"
    worker.write_text(COUNT_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    outs = [tmp_path / f"cnt{i}.npz" for i in range(2)]
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port), str(outs[i]), str(fq)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out.decode()[-2000:], err.decode()[-2000:])
        assert b"OK" in out

    r0, r1 = np.load(outs[0]), np.load(outs[1])
    np.testing.assert_array_equal(r0["kmers"], r1["kmers"])
    np.testing.assert_array_equal(r0["counts"], r1["counts"])

    # single-process reference count over the same file
    from kmcex.count.pipeline import count_fastq

    want_k, want_c, _ = count_fastq(str(fq), k=9, ci=1, cs=1023,
                                    seg_len=32, accumulator="host")
    np.testing.assert_array_equal(r0["kmers"], want_k)
    np.testing.assert_array_equal(r0["counts"], want_c)


E2E_WORKER = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
out_dir = sys.argv[3]
fq_path = sys.argv[4]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()
os.environ["KMCEX_DISK_SPILL_BYTES"] = "4096"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from kmcex.parallel import distributed
distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2

# force every sharded tier at tiny scale (disk spill included)
import kmcex.parallel.sharded as sh_mod
sh_mod.ShardedCountAccumulator.RAW_TIER_ELEMS = 4096
sh_mod.ShardedCountAccumulator.SPILL_THRESHOLD = 8192
sh_mod.ShardedCountAccumulator.DISK_SPILL_BYTES = 4096

from kmcex.count.pipeline import count_encode

db = os.path.join(out_dir, "db") if pid == 0 else None
km, _, _, stats = count_encode(
    fq_path, k=9, ci=1, cs=1023, seg_len=32, batch_segs=64,
    keep_pairs=False, db_path=db, accumulator="sharded")
if pid == 0:
    km.save(os.path.join(out_dir, "model"))
print("OK", stats.distinct_kmers, stats.reads, flush=True)
"""


@pytest.mark.slow
def test_two_process_genome_scale_e2e(tmp_path):
    """The full genome-scale driver (VERDICT r3 item 4, forced tiny): TWO
    processes count one byte-range-split FASTQ through the lockstep
    sharded accumulator with the DISK tier engaged, the streaming finalize
    feeds the streaming encode + streaming KMC1 writer on rank 0, and the
    resulting model + DB bytes equal a single-process in-RAM build."""
    from tests.test_byte_ranges import _write_fastq

    fq = tmp_path / "big.fastq"
    _write_fastq(fq, n_reads=400, seed=77)

    worker = tmp_path / "e2e_worker.py"
    worker.write_text(E2E_WORKER)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent) + os.pathsep + env.get("PYTHONPATH", "")
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    procs = []
    for i in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port), str(out_dir), str(fq)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (out.decode()[-2000:], err.decode()[-2000:])
        assert b"OK" in out

    # single-process in-RAM reference build of the same file
    from kmcex.count.pipeline import count_encode
    from kmcex.io import kmc_db

    km, kd, cd, _ = count_encode(str(fq), k=9, ci=1, cs=1023, seg_len=32,
                                 batch_segs=64, keep_pairs=True)
    km.save(str(tmp_path / "model_ref"))
    for fn in ["header", "km.bin", "rest.bin"]:
        assert ((out_dir / "model" / fn).read_bytes()
                == (tmp_path / "model_ref" / fn).read_bytes()), fn
    kmc_db.write_kmc1(str(tmp_path / "db_ref"), kd, cd.astype(np.uint64), 9,
                      min_count=1, max_count=1023,
                      counter_size=kmc_db.counter_size_for(1023))
    for ext in [".kmc_pre", ".kmc_suf"]:
        assert ((out_dir / ("db" + ext)).read_bytes()
                == (tmp_path / ("db_ref" + ext)).read_bytes()), ext
