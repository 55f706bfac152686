"""Multi-host distributed runtime: process-spanning device meshes.

The reference is a single-process OpenMP tool (SURVEY.md §2 parallelism
inventory); genome-scale targets (BASELINE config 5: NA12878 31-mers on a
multi-host cluster) need the count table sharded across hosts.  This
module is the startup + mesh layer for that: ``jax.distributed`` brings up
the cross-process runtime, the mesh spans every device of every process,
and the counting step (parallel/sharded.py) runs unchanged under
``shard_map`` — XLA hands the ``all_to_all`` to NCCL, over NVLink within
a host and the network across hosts.

Data flow per process (host):
  * each host reads ITS OWN slice of the input files (``host_slice`` picks
    round-robin file ownership from an @list; a single big file is split by
    byte ranges at read-record boundaries upstream),
  * local extract/canonicalize on the host's devices (data parallel),
  * k-mers route to owner shards by hash via all_to_all,
  * per-shard sorted count tables stay sharded; ``psum`` gives global stats.

Runs identically on GPU hosts and on N spawned CPU processes with
``--xla_force_host_platform_device_count`` (how tests/test_distributed.py
exercises the cross-process code path without accelerators).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Bring up the cross-process JAX runtime.

    Pass the arguments explicitly or via KMCEX_COORDINATOR /
    KMCEX_NUM_PROCESSES / KMCEX_PROCESS_ID; on a host without a cluster
    manager nothing is auto-detected.  On GPUs run ONE process per card and
    give each its card with ``local_device_ids=[i]`` (a JAX process
    reserves most of a card's memory, so a second process on the same card
    fails).  Safe to call
    twice (second call is a no-op).  Must run before anything initialises
    the XLA backend (jax.devices / any computation)."""
    if getattr(initialize, "_done", False):
        return
    coordinator_address = coordinator_address or os.environ.get("KMCEX_COORDINATOR")
    if num_processes is None and "KMCEX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KMCEX_NUM_PROCESSES"])
    if process_id is None and "KMCEX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KMCEX_PROCESS_ID"])
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)
    initialize._done = True


def global_mesh(axis: str = "shard") -> Mesh:
    """1-D mesh over every device of every process, in (process, local)
    order so consecutive shards sit on the same host when possible (keeps
    most all_to_all traffic on NVLink, only the host-crossing remainder on
    the network)."""
    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def host_slice(paths: list[str]) -> list[str]:
    """Round-robin ownership of input files for this process — each host
    parses only its own slice (data parallelism over reads, SURVEY.md §5)."""
    pid, n = jax.process_index(), jax.process_count()
    return [p for i, p in enumerate(paths) if i % n == pid]


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def host_input_slices(input_spec: str) -> list[tuple[str, tuple[int, int] | None]]:
    """This process's (path, byte_range) work items.

    A single uncompressed file is split by byte ranges at record boundaries
    (io.fastq.split_byte_ranges) so one genome-scale FASTQ parses in
    parallel across all hosts — the reference feeds exactly one such file
    to kmc (main.cpp:137).  Multiple files (or gzip, which has no random
    access) fall back to round-robin whole-file ownership."""
    from kmcex.io import fastq

    paths = fastq.resolve_inputs(input_spec)
    pid, n = jax.process_index(), jax.process_count()
    if len(paths) == 1 and n > 1 and not _is_gzip(paths[0]):
        ranges = fastq.split_byte_ranges(paths[0], n)
        return [(paths[0], ranges[pid])]
    return [(p, None) for p in host_slice(paths)]


def process_local_batch(mesh: Mesh, codes: np.ndarray):
    """Wrap this process's local batch rows as a globally sharded array.

    ``codes`` is the [local_rows, seg_len] block this host parsed; the
    returned jax.Array is the concatenation over processes, sharded along
    the mesh axis, suitable for the sharded count step.  local_rows must be
    a multiple of the local device count."""
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.make_array_from_process_local_data(sharding, codes)


def stream_into_accumulator(acc, input_spec: str, k: int,
                            seg_len: int) -> tuple[int, int]:
    """Drain this process's input slice into a ShardedCountAccumulator in
    LOCKSTEP with every other process (the all_to_all inside each count
    step requires all processes to step together; hosts that run dry feed
    fully-masked empty buffers).  After this returns on every process,
    ``acc.finalize_stream`` yields the identical global table everywhere —
    the multi-host half of the genome-scale driver (BASELINE config 5).
    Returns GLOBAL (reads, bases) parsed across all processes.

    Batches move in the accumulator's transfer format: 2-bit packed +
    validity bitmask when ``acc`` was built with ``packed=True`` (4x fewer
    h2d bytes; the native segmenter emits the packed form directly),
    byte codes otherwise."""
    from kmcex.io import fastq

    mesh = acc.mesh
    packed_mode = getattr(acc, "_packed", False)
    items = host_input_slices(input_spec)
    local_dev = jax.local_device_count()
    local_rows = acc.seg_rows * local_dev
    streams: list = []

    def new_buf():
        if packed_mode:
            return (np.zeros((local_rows, seg_len // 4), dtype=np.uint8),
                    np.zeros((local_rows, seg_len // 8), dtype=np.uint8))
        return np.full((local_rows, seg_len), 255, dtype=np.uint8)

    def copy_rows(dst, src, at, lo, hi):
        if packed_mode:
            dst[0][at : at + hi - lo] = src[0][lo:hi]
            dst[1][at : at + hi - lo] = src[1][lo:hi]
        else:
            dst[at : at + hi - lo] = src[lo:hi]

    def local_full_buffers():
        buf = new_buf()
        fill = 0
        for path, brange in items:
            stream = fastq.SegmentStream(path, k, seg_len, local_rows,
                                         use_native=True, packed=packed_mode,
                                         byte_range=brange)
            streams.append(stream)
            for batch in stream:
                nb = len(batch[0]) if packed_mode else len(batch)
                take = min(local_rows - fill, nb)
                copy_rows(buf, batch, fill, 0, take)
                fill += take
                if fill == local_rows:
                    yield buf
                    buf = new_buf()
                    fill = 0
                if take < nb:
                    copy_rows(buf, batch, 0, take, nb)
                    fill = nb - take
        if fill:
            yield buf

    def put(buf):
        if packed_mode:
            acc.add_batch_packed(process_local_batch(mesh, buf[0]),
                                 process_local_batch(mesh, buf[1]))
        else:
            acc.add_batch(process_local_batch(mesh, buf))

    it = local_full_buffers()
    if jax.process_count() == 1:
        for buf in it:
            put(buf)
        return (sum(s.reads for s in streams),
                sum(s.bases for s in streams))
    from jax.experimental import multihost_utils

    empty = new_buf()
    while True:
        nxt = next(it, None)
        flags = multihost_utils.process_allgather(
            np.array([0 if nxt is None else 1], dtype=np.int32))
        if not int(np.asarray(flags).sum()):
            break
        put(empty if nxt is None else nxt)
    totals = multihost_utils.process_allgather(np.array(
        [sum(s.reads for s in streams), sum(s.bases for s in streams)],
        dtype=np.int64))
    totals = np.asarray(totals).reshape(jax.process_count(), 2).sum(axis=0)
    return int(totals[0]), int(totals[1])


def distributed_count_fastq(input_spec: str, k: int, ci: int = 1,
                            cs: int = 1023, seg_len: int = 256,
                            batch_segs: int = 4096):
    """Multi-host counting driver: each process streams its input slice
    (byte ranges of one big file, or round-robin whole files —
    host_input_slices), batches are globally sharded, and the hash-routed
    sharded accumulator (parallel/sharded.py) counts across all devices of
    all processes.

    The all_to_all inside every count step requires ALL processes to step
    in lockstep, but hosts' slices can yield different batch counts (byte
    ranges are only approximately equal).  Each step therefore starts with
    a tiny host allgather of "do I still have data"; hosts that ran dry
    feed empty (all-padding) buffers, whose windows are fully masked, until
    every host is done.

    Returns host-side (kmers, counts) — identical on every process (the
    per-shard tables are gathered; fine for model-building, which every
    host replicates).  For tables too large to gather, consume
    ``ShardedCountAccumulator.finalize_stream`` per shard instead."""
    from kmcex.parallel.sharded import ShardedCountAccumulator

    mesh = global_mesh()
    # Global batch = batch_segs rows per device; each process contributes
    # rows for ITS devices only.  Packed transfer format when seg_len
    # permits (4x fewer h2d bytes).
    packed = seg_len % 8 == 0
    acc = ShardedCountAccumulator(mesh, k, batch_segs, seg_len,
                                  packed=packed)
    stream_into_accumulator(acc, input_spec, k, seg_len)
    return acc.finalize(ci, cs)
