"""End-to-end pipeline: FASTQ -> counts -> KModel -> saved model dir.

The device-side equivalent of the reference CLI run (main.cpp:129-150):
where the reference shells out to the kmc binary and then re-reads its
database, this pipeline streams reads through the device extraction/count
kernels, optionally materializes a KMC1-format database (drop-in compatible
with the vendored KMC API), and encodes the KModel.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time

import numpy as np

from kmcex.config import KParams
from kmcex.count.counter import CountAccumulator
from kmcex.io import fastq, kmc_db
from kmcex.model.kmodel import KModel, get_model


@dataclasses.dataclass
class PipelineStats:
    reads: int = 0
    bases: int = 0
    windows: int = 0
    distinct_kmers: int = 0
    count_seconds: float = 0.0
    encode_seconds: float = 0.0
    phases: dict = dataclasses.field(default_factory=dict)
    # tier-transition counts from the counting accumulator (raw collapses,
    # device merges, host/disk spills) — scale-run observability
    tiers: dict = dataclasses.field(default_factory=dict)


def count_fastq(
    input_spec: str,
    k: int = 31,
    ci: int = 1,
    cs: int = 1023,
    seg_len: int | None = None,
    batch_segs: int = fastq.DEFAULT_BATCH_SEGS,
    accumulator: str = "device",
    mesh=None,
) -> tuple[np.ndarray, np.ndarray, PipelineStats]:
    """Count canonical k-mers in FASTQ/FASTA input.

    ``seg_len=None`` auto-sizes segments to the observed read length so no
    window slots are wasted on padding.  ``accumulator="device"`` keeps all
    run merging in HBM on one chip (one host transfer total); "sharded"
    runs the hash-routed multi-chip accumulator over ``mesh`` (defaults to
    all devices); "host" is the NumPy LSM."""
    t0 = time.time()
    if seg_len is None:
        sniffed = fastq.sniff_read_length(input_spec)
        seg_len = min(512, max(k + 33, sniffed))
    seg_len = (seg_len + 7) & ~7  # packed path needs L % 8 == 0
    # The producer threads overlap parsing+packing (one native pass) and the
    # h2d copy (packed codes are 4x smaller than raw codes) with device
    # dispatch.
    from kmcex.utils import prefetch_iterator

    if accumulator == "device":
        import jax

        from kmcex.count.device_lsm import DeviceCountAccumulator

        stream = fastq.SegmentStream(input_spec, k, seg_len, batch_segs, packed=True)
        acc = DeviceCountAccumulator(k)
        parsed = prefetch_iterator(iter(stream), depth=2)
        for packed, maskbits in prefetch_iterator(
            parsed, depth=2, transform=jax.device_put
        ):
            acc.add_batch_packed(packed, maskbits)
    elif accumulator == "sharded":
        import jax

        from kmcex.parallel.sharded import ShardedCountAccumulator, make_mesh

        if mesh is None:
            mesh = make_mesh()
        n = int(mesh.devices.size)
        batch_segs = max(n, (batch_segs // n) * n)  # rows divide the mesh
        stream = fastq.SegmentStream(input_spec, k, seg_len, batch_segs, packed=True)
        acc = ShardedCountAccumulator(mesh, k, batch_segs // n, seg_len,
                                      packed=True)
        from jax.sharding import NamedSharding, PartitionSpec

        row_sharded = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
        put = lambda t: jax.device_put(t, row_sharded)
        parsed = prefetch_iterator(iter(stream), depth=2)
        for packed, maskbits in prefetch_iterator(parsed, depth=2, transform=put):
            acc.add_batch_packed(packed, maskbits)
    else:
        stream = fastq.segment_batches(input_spec, k, seg_len, batch_segs)
        acc = CountAccumulator(k)
        for codes in prefetch_iterator(iter(stream), depth=3):
            acc.add_batch(codes)
    kmers, counts = acc.finalize(ci, cs)
    stats = PipelineStats(
        reads=stream.reads,
        bases=stream.bases,
        windows=acc.total_windows,
        distinct_kmers=len(kmers),
        count_seconds=time.time() - t0,
    )
    return kmers, counts, stats


def count_encode(
    input_spec: str,
    k: int = 31,
    ci: int = 1,
    cs: int = 1023,
    num_hash: int = 7,
    num_bit: int = 5,
    seg_len: int | None = None,
    batch_segs: int = fastq.DEFAULT_BATCH_SEGS,
    keep_pairs: bool = True,
    db_path: str | None = None,
    accumulator: str = "device",
    mesh=None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 256,
) -> tuple[KModel, np.ndarray | None, np.ndarray | None, PipelineStats]:
    """Count + encode with the device->host table pull overlapping the host
    encode (streaming chunks; bit-identical to the two-phase build).

    Returns (model, kmers, counts, stats); kmers/counts are None unless
    ``keep_pairs`` (they cost host memory, not time — pass False plus
    ``db_path`` for the genome-scale regime: the KMC1 database then spools
    chunk-by-chunk through io.kmc_db.KMC1StreamWriter with bounded
    memory).  ``accumulator="sharded"`` runs the hash-routed multi-chip
    accumulator over ``mesh`` (all devices by default) — combined with a
    spawned multi-process runtime (parallel.distributed) this is the
    multi-host path; in that case only process 0 should pass db_path.

    ``ckpt_dir`` makes the COUNT phase resumable (the reference has no
    mid-build persistence, SURVEY.md §5): every ``ckpt_every`` batches the
    accumulator state plus the stream position land in ``ckpt_dir``
    (manifest written last — a crash mid-checkpoint is invisible).  On the
    next call with the same ckpt_dir, input and parameters, counting
    resumes after the last checkpointed batch; batch segmentation is
    deterministic, so the resumed model is byte-identical to an
    uninterrupted run (tested).  The manifest is retired on success.
    Single-process only (the multi-host path raises)."""
    from kmcex.utils.timing import Phases, device_trace

    ph = Phases()
    t0 = time.time()
    with device_trace("count_encode"):
        with ph.phase("sniff_read_length"):
            if seg_len is None:
                sniffed = fastq.sniff_read_length(input_spec)
                seg_len = min(512, max(k + 33, sniffed))
            seg_len = (seg_len + 7) & ~7
        import jax

        from kmcex.utils import prefetch_iterator

        # two producer stages: thread A parses + 2-bit packs (one native
        # pass), thread B copies to device; the main thread only dispatches —
        # parse, h2d and device compute all overlap
        n_reads = n_bases = None
        ckpt_fp = {"input": str(input_spec), "k": int(k),
                   "seg_len": int(seg_len), "batch_segs": int(batch_segs),
                   "accumulator": accumulator, "ci": int(ci), "cs": int(cs)}
        if accumulator == "sharded" and jax.process_count() > 1:
            if ckpt_dir:
                raise NotImplementedError(
                    "ckpt_dir is single-process only; the multi-host "
                    "stream does not checkpoint its byte-range position")
            # multi-host: each process parses only its byte-range/file
            # slice, stepping the all_to_all in lockstep with the others
            from kmcex.parallel import distributed
            from kmcex.parallel.sharded import ShardedCountAccumulator

            if mesh is None:
                mesh = distributed.global_mesh()
            n = int(mesh.devices.size)
            rows = max(1, batch_segs // n)
            stream = None
            acc = ShardedCountAccumulator(mesh, k, rows, seg_len,
                                          packed=True)
            with ph.phase("stream+extract"):
                n_reads, n_bases = distributed.stream_into_accumulator(
                    acc, input_spec, k, seg_len)
        else:
            if accumulator == "sharded":
                from jax.sharding import NamedSharding, PartitionSpec

                from kmcex.parallel.sharded import (
                    ShardedCountAccumulator,
                    make_mesh,
                )

                if mesh is None:
                    mesh = make_mesh()
                n = int(mesh.devices.size)
                batch_segs = max(n, (batch_segs // n) * n)
                stream = fastq.SegmentStream(input_spec, k, seg_len,
                                             batch_segs, packed=True)
                acc = ShardedCountAccumulator(mesh, k, batch_segs // n,
                                              seg_len, packed=True)
                sh = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
                put = lambda t: jax.device_put(t, sh)
            else:
                from kmcex.count.device_lsm import DeviceCountAccumulator

                stream = fastq.SegmentStream(input_spec, k, seg_len,
                                             batch_segs, packed=True)
                acc = DeviceCountAccumulator(k)
                put = jax.device_put
            # resume: swap in the checkpointed accumulator and skip the
            # batches it already consumed (segmentation is deterministic)
            skip = 0
            if ckpt_dir:
                m = type(acc).read_manifest(ckpt_dir)
                if m is not None:
                    if m.get("extra", {}).get("fingerprint") != ckpt_fp:
                        raise ValueError(
                            f"checkpoint in {ckpt_dir} was written for a "
                            f"different input/parameter set "
                            f"({m.get('extra', {}).get('fingerprint')}); "
                            f"delete it to start fresh")
                    if accumulator == "sharded":
                        acc = type(acc).restore(mesh, ckpt_dir, packed=True)
                    else:
                        acc = type(acc).restore(ckpt_dir)
                    skip = int(m["extra"]["n_batches"])
            ckpt_every = int(os.environ.get("KMCEX_CKPT_EVERY", ckpt_every))
            # fault injection for the resume tests (the reference has no
            # fault story at all, SURVEY.md §5): crash after N batches
            crash_after = int(os.environ.get("KMCEX_CRASH_AFTER_BATCHES", 0))
            with ph.phase("stream+extract"):
                parsed = prefetch_iterator(iter(stream), depth=2)
                if skip:
                    base = parsed
                    parsed = (x for j, x in enumerate(base) if j >= skip)
                nb = skip
                for packed, maskbits in prefetch_iterator(
                    parsed, depth=2, transform=put
                ):
                    acc.add_batch_packed(packed, maskbits)
                    nb += 1
                    if ckpt_dir and ckpt_every and nb % ckpt_every == 0:
                        acc.checkpoint(ckpt_dir, extra={
                            "fingerprint": ckpt_fp, "n_batches": nb})
                    if crash_after and nb - skip >= crash_after:
                        raise RuntimeError(
                            "injected crash (KMCEX_CRASH_AFTER_BATCHES)")
        # Device Bloom build (model/device_bloom.py): for the single-chip
        # device accumulator the Bloom bank is scattered together ON the
        # device, overlapping the table pull; when the host needs no low
        # pairs (no DB spool, no keep_pairs) those keys are dropped from
        # the transfer entirely — on singleton-heavy real spectra that is
        # ~80% of the table staying on device, with only the ~5x-smaller
        # finished filter bytes crossing the link.
        fin_kwargs = {}
        if os.environ.get("KMCEX_DEVICE_BLOOM", "1") != "0":
            if accumulator == "device":
                from kmcex.model.device_bloom import DeviceBloomBuilder

                fin_kwargs = dict(
                    bloom_factory=lambda hist: DeviceBloomBuilder(
                        k, ci, cs, num_hash, hist),
                    drop_low=(not keep_pairs) and db_path is None,
                )
            elif accumulator == "sharded":
                from kmcex.model.device_bloom import (
                    ShardedDeviceBloomBuilder,
                )

                fin_kwargs = dict(
                    bloom_factory=lambda hist: ShardedDeviceBloomBuilder(
                        mesh, k, ci, cs, num_hash, hist))
        with ph.phase("merge+stats"):
            total, low_hist, chunks = acc.finalize_stream(ci, cs,
                                                          **fin_kwargs)
        for name, secs in getattr(acc, "finalize_phases", {}).items():
            ph.add(f"finalize.{name}", secs)
        bloom_builder = getattr(acc, "device_bloom", None)
        # a producer thread owns the device->host pulls, the delta decode AND
        # the per-chunk counter routing (model.kmodel.split_chunk) so the
        # (GIL-releasing) native encode on the main thread only feeds
        from kmcex.model.kmodel import split_chunk

        bf_num = 1 if ci == 1 else 3
        collected: list[tuple[np.ndarray, np.ndarray]] = []
        writer = None
        if db_path:
            writer = kmc_db.KMC1StreamWriter(db_path, k, min_count=ci,
                                             max_count=cs)

        def produce(item):
            ku, kc = item
            if keep_pairs:
                collected.append((ku, kc))
            if writer is not None:
                writer.write_chunk(ku, kc.astype(np.uint64))
            return split_chunk(ku, kc, ci, bf_num)

        chunks = prefetch_iterator(chunks, depth=4, transform=produce)
        t_count = time.time() - t0

        km = get_model(ci, cs, num_hash, num_bit)
        try:
            with ph.phase("transfer+encode"):
                km.init_from_chunks(chunks, k, total, low_hist,
                                    device_bloom=bloom_builder)
        except BaseException:
            # a partial spool must not look like a complete database
            if writer is not None:
                writer.abort()
            raise
        else:
            if writer is not None:
                writer.close()
            if ckpt_dir:
                # retire the manifest: the run completed, a later run with
                # this dir starts fresh (run files stay until overwritten)
                try:
                    os.unlink(os.path.join(ckpt_dir, "manifest.json"))
                except OSError:
                    pass
        for name, secs in getattr(km, "encode_phases", {}).items():
            ph.add(f"encode.{name}", secs)
        t_total = time.time() - t0
    kmers = counts = None
    if keep_pairs:
        kmers = np.concatenate([x[0] for x in collected]) if collected else np.zeros(0, np.uint64)
        counts = np.concatenate([x[1] for x in collected]) if collected else np.zeros(0, np.uint32)
    stats = PipelineStats(
        reads=n_reads if n_reads is not None else stream.reads,
        bases=n_bases if n_bases is not None else stream.bases,
        windows=acc.total_windows,
        distinct_kmers=total,
        count_seconds=t_count,
        encode_seconds=t_total - t_count,
        phases=dict(ph.seconds),
        tiers=dict(getattr(acc, "tier_events", {})),
    )
    return km, kmers, counts, stats


def run(params: KParams, save_dir: str | None = None,
        write_db: bool = True) -> tuple[KModel, PipelineStats]:
    """Full kmcEx-equivalent run: count, (optionally) stream the KMC1 DB to
    ``output_file_name``, build + save the model under
    ``working_directory/<basename>`` (main.cpp:143-149).

    The KMC1 database spools chunk-by-chunk during the encode (bounded
    memory at genome scale; the table is never materialized in host RAM).
    ``params.accumulator`` picks the counting backend: "device" (default,
    single chip) or "sharded" (hash-routed mesh over all devices — the
    multi-chip / multi-host path; on a multi-process runtime every process
    must call this, and only process 0 writes the DB + model)."""
    if params.t:
        from kmcex import native

        native.set_num_threads(params.t)
    batch_env = int(os.environ.get("KMCEX_BATCH_SEGS", 0))
    import jax

    is_primary = jax.process_index() == 0
    acc_kind = getattr(params, "accumulator", "device") or "device"
    db_path = (params.output_file_name
               if write_db and params.output_file_name and is_primary
               else None)
    km, kmers, counts, stats = count_encode(
        params.input_file_name, params.k, params.ci, params.cs,
        params.num_hash, params.num_bit,
        keep_pairs=False, db_path=db_path, accumulator=acc_kind,
        ckpt_dir=getattr(params, "ckpt_dir", "") or None,
        **({"batch_segs": batch_env} if batch_env else {}),
    )
    if save_dir is None and params.output_file_name:
        base = pathlib.Path(params.output_file_name).name
        save_dir = str(pathlib.Path(params.working_directory) / base)
    if save_dir and is_primary:
        km.save(save_dir)
    return km, stats
