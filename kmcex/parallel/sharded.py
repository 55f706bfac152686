"""Multi-chip sharded counting: data-parallel reads, hash-sharded k-mer table.

The distributed design from SURVEY.md §5/§7: read segments are sharded
across the device mesh (data parallel); each device extracts + canonicalizes
its k-mers locally; k-mers are routed to their owner shard by a
multiplicative hash via ``all_to_all``; each shard then
sort-counts its partition.  The shard-local results together form the global
count table (disjoint by construction), and ``psum`` provides global stats.

Mirrors the single-chip DeviceCountAccumulator's tiering (count/device_lsm):
routed k-mers buffer unsorted in a per-shard RAW TIER collapsed by one
sort+segment-count pass, collapsed runs merge pairwise in a per-shard LSM,
and runs past a spill threshold leave the device for host RAM where the
native two-pointer merge folds them — so the global table never needs to
fit on one chip (KMC's external-memory bins, rebuilt for a mesh).

Runs identically on several GPUs of one host or on a virtual
``--xla_force_host_platform_device_count`` CPU mesh (how the tests
validate it).  The mesh is 1-D: every card reaches every other over NVLink
at the same rate, so the layout follows the all_to_all routing alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from kmcex.count import extract

GOLDEN = jnp.uint64(0x9E3779B97F4A7C15)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("shard",))


def owner_of(kmers: jnp.ndarray, n_shards: int) -> jnp.ndarray:
    """Owner shard by multiplicative (Fibonacci) hash of the canonical k-mer.

    Plain ``kmer % n`` would skew: canonical k-mers concentrate in the lower
    half of the value space (min of a k-mer and its reverse complement)."""
    h = kmers * GOLDEN
    return ((h >> jnp.uint64(32)).astype(jnp.uint32) % jnp.uint32(n_shards)).astype(
        jnp.int32
    )


def _route_local(kmers, n_valid, n: int, cap: int):
    """Local half of the exchange: group local k-mers by owner shard into
    [n, cap] send buffers (SENTINEL padding), then all_to_all.  Also returns
    the global count of REAL k-mers that overflowed their destination
    buffer (the caller re-routes the batch with worst-case capacity when
    nonzero — degenerate inputs like poly-A reads can send everything to
    one shard, which no statistical bound covers).

    SENTINEL (invalid-window) entries are excluded from routing entirely:
    they sort past every real owner group (owner forced to n) and never
    consume destination capacity.  The send buffers are built by GATHER
    from the owner-sorted array, not by scatter: an earlier duplicate-index
    scatter here silently clobbered the slot-0 real k-mer of the shard
    SENTINEL hashed to whenever sentinels overflowed cap (a data-loss
    bug)."""
    N = kmers.shape[0]
    owner = jnp.where(kmers != extract.SENTINEL,
                      owner_of(kmers, n), jnp.int32(n))
    order = jnp.argsort(owner)
    kmers_s = kmers[order]
    owner_s = owner[order]
    bounds = jnp.searchsorted(owner_s, jnp.arange(n + 1, dtype=jnp.int32))
    group_size = bounds[1:] - bounds[:-1]  # real entries per destination
    src = bounds[:-1, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
    send = jnp.where(src < bounds[1:, None],
                     kmers_s[jnp.minimum(src, N - 1)], extract.SENTINEL)
    dropped = jax.lax.psum(
        jnp.sum(jnp.maximum(group_size - cap, 0), dtype=jnp.int64), "shard")
    recv = jax.lax.all_to_all(send, "shard", split_axis=0, concat_axis=0, tiled=True)
    # replicated TOTAL real count (diagnostics)
    n_real = jax.lax.psum(
        jnp.sum(recv != extract.SENTINEL, dtype=jnp.int64), "shard")
    windows = jax.lax.psum(n_valid, "shard")
    return recv.reshape(1, -1), windows, dropped, n_real


def default_route_capacity(seg_rows: int, W: int, n: int) -> int:
    """Measured-bound routing capacity: the owner hash spreads k-mers
    ~binomially over shards (stddev sqrt(total/n)), so 2.2x the mean plus a
    floor covers any statistically plausible skew; genuinely degenerate
    inputs overflow and trigger a worst-case re-route (see _route_local).
    Versus the old always-worst-case buffers this cuts all_to_all bytes and
    raw-tier HBM by ~n/2."""
    worst = seg_rows * W
    mean = -(-seg_rows * W // n)
    cap = max(1024, ((int(2.2 * mean) + 127) // 128) * 128)
    return min(worst, cap)


def build_route_step(mesh: Mesh, k: int, seg_rows: int, seg_len: int,
                     capacity: int | None = None, packed: bool = False):
    """Jitted routing step: one input batch -> (per-shard RAW routed k-mers
    [n_shards, n*cap] sharded SENTINEL-padded, global window count, global
    overflow count, per-shard real k-mer counts).  No sorting here — raw
    tiers collapse later, amortizing the sort.

    ``capacity`` is the per-destination routing buffer (static shape for
    all_to_all); defaults to default_route_capacity's measured bound.
    ``packed`` selects the 2-bit transfer format (io/fastq packed segment
    batches)."""
    n = mesh.devices.size
    W = seg_len - k + 1
    cap = capacity or default_route_capacity(seg_rows, W, n)

    if packed:
        def local_step(packed_b, maskbits):
            kmers, n_valid = extract.extract_canonical_packed(packed_b, maskbits, k)
            return _route_local(kmers, n_valid, n, cap)

        in_specs = (P("shard"), P("shard"))
    else:
        def local_step(codes):
            kmers, n_valid = extract.extract_canonical(codes, k)
            return _route_local(kmers, n_valid, n, cap)

        in_specs = P("shard")
    return jax.jit(
        jax.shard_map(local_step, mesh=mesh, in_specs=in_specs,
                      out_specs=(P("shard"), P(), P(), P()))
    )


def build_sharded_collapse(mesh: Mesh):
    """Jitted per-shard collapse: concat a shard's raw arrays and
    sort+segment-count them into a sorted unique run (no collectives —
    partitions are disjoint by the owner hash)."""
    def local(arrs):  # tuple of [1, R_i] local views
        flat = jnp.concatenate([a.reshape(-1) for a in arrs])
        u, c, nu = extract.sort_count_unique(flat)
        return u[None, :], c[None, :], nu[None].astype(jnp.int64)

    return jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=(P("shard"),),
                      out_specs=(P("shard"), P("shard"), P("shard")))
    )


def build_sharded_merge(mesh: Mesh):
    """Jitted pairwise merge of two per-shard sorted (kmer,count) run sets
    ([n_shards, size] arrays sharded over the mesh); partitions are disjoint
    by the owner hash, so each shard merges independently — no collectives."""
    from kmcex.count.device_lsm import _merge_runs_kernel

    def local(ka, ca, kb, cb):  # local blocks [1, size]
        u, c, nu = _merge_runs_kernel(ka[0], ca[0], kb[0], cb[0])
        return u[None, :], c[None, :], nu[None]

    return jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("shard"), P("shard"), P("shard"), P("shard")),
            out_specs=(P("shard"), P("shard"), P("shard")),
        )
    )


# back-compat alias: the one-shot routed count step used by older tests
def build_sharded_count_step(mesh: Mesh, k: int, seg_rows: int, seg_len: int,
                             capacity: int | None = None):
    """Returns a jitted step: codes [n_shards*seg_rows, seg_len] uint8 ->
    (uniq [n_shards, M], counts [n_shards, M], n_unique [n_shards],
    windows_total scalar) — route + immediate per-shard sort-count."""
    n = mesh.devices.size
    W = seg_len - k + 1
    cap = capacity or seg_rows * W

    def local_step(codes):
        kmers, n_valid = extract.extract_canonical(codes, k)
        recv, windows, _, _ = _route_local(kmers, n_valid, n, cap)
        uniq, counts, n_unique = extract.sort_count_unique(recv.reshape(-1))
        return uniq[None, :], counts[None, :], n_unique[None], windows

    return jax.jit(
        jax.shard_map(
            local_step, mesh=mesh, in_specs=P("shard"),
            out_specs=(P("shard"), P("shard"), P("shard"), P()),
        )
    )


def _pull(arr) -> np.ndarray:
    """Device->host for a (possibly multi-process) sharded array."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        arr = multihost_utils.process_allgather(arr, tiled=True)
    return np.asarray(arr)


class ShardedCountAccumulator:
    """Streaming multi-chip counting: every batch is extracted and routed to
    owner shards, raw routed k-mers buffer per shard and collapse by one
    sort+count pass per tier, collapsed runs merge in a per-shard LSM,
    oversized runs spill to host RAM, and past a RAM budget runs stream to
    disk — full feature parity with the single-chip
    count/device_lsm.DeviceCountAccumulator (SURVEY.md §5's distributed
    backend; KMC's external-memory bins rebuilt for a mesh).

    Routing buffers use a measured statistical bound instead of worst-case
    (default_route_capacity); a batch whose hash skew overflows it is
    re-routed once with worst-case buffers (collective-safe: the overflow
    count is a psum, identical on every process).
    """

    RAW_TIER_ELEMS = 32 << 20   # per-shard raw k-mer slots before a collapse
    SPILL_THRESHOLD = 64 << 20  # per-shard run size that leaves HBM
    DISK_SPILL_BYTES = 16 << 30  # host-RAM budget before runs go to disk

    def __init__(self, mesh: Mesh, k: int, seg_rows: int, seg_len: int,
                 packed: bool = False, raw_tier_elems: int | None = None,
                 spill_threshold: int | None = None,
                 capacity: int | None = None,
                 disk_spill_bytes: int | None = None,
                 disk_dir: str | None = None):
        import os as _os

        self.mesh = mesh
        self.k = k
        self.n = mesh.devices.size
        self.seg_rows = seg_rows
        self.seg_len = seg_len
        self._packed = packed
        self.step = build_route_step(mesh, k, seg_rows, seg_len,
                                     capacity=capacity, packed=packed)
        self._full_step = None  # lazily built worst-case re-route
        self.reroutes = 0
        self.collapse = build_sharded_collapse(mesh)
        self.merge = build_sharded_merge(mesh)
        self.raw_tier_elems = raw_tier_elems or self.RAW_TIER_ELEMS
        self.spill_threshold = spill_threshold or self.SPILL_THRESHOLD
        if disk_spill_bytes is None:
            disk_spill_bytes = int(_os.environ.get(
                "KMCEX_DISK_SPILL_BYTES", self.DISK_SPILL_BYTES))
        self.disk_spill_bytes = disk_spill_bytes
        self._disk_dir_arg = disk_dir
        self._disk_dir: str | None = None
        self.raw: list = []          # [n, R_i] sharded raw arrays
        self.raw_elems = 0           # per-shard raw SLOT count (memory bound)
        self.raw_real = 0            # real k-mers buffered (diagnostics)
        self.runs: list[tuple] = []  # (uniq [n, M], counts [n, M], M)
        # host LSM level, per shard: lists of sorted (kmers, counts) runs
        self.host_runs: list[list[tuple[np.ndarray, np.ndarray]]] = [
            [] for _ in range(self.n)]
        self.disk_runs: list[list[str]] = [[] for _ in range(self.n)]
        self.total_windows = 0
        # set by finalize_stream when a bloom_factory ran on the mesh
        self.device_bloom = None

    def _route(self, *args):
        recv, windows, dropped, n_real = self.step(*args)
        if int(dropped):
            # degenerate hash skew: redo this batch with exact buffers
            if self._full_step is None:
                W = self.seg_len - self.k + 1
                self._full_step = build_route_step(
                    self.mesh, self.k, self.seg_rows, self.seg_len,
                    capacity=self.seg_rows * W, packed=self._packed)
            self.reroutes += 1
            recv, windows, _, n_real = self._full_step(*args)
        return recv, int(windows), int(n_real)

    def add_batch(self, codes) -> None:
        self._push_raw(*self._route(codes))

    def add_batch_packed(self, packed, maskbits) -> None:
        self._push_raw(*self._route(packed, maskbits))

    def _push_raw(self, recv, windows: int, real_total: int) -> None:
        self.total_windows += windows
        self.raw.append(recv)
        self.raw_elems += recv.shape[1]
        self.raw_real += real_total  # global real k-mers routed (diagnostic)
        if self.raw_elems >= self.raw_tier_elems:
            self._collapse_raw()

    def _collapse_raw(self) -> None:
        if not self.raw:
            return
        u, c, _ = self.collapse(tuple(self.raw))
        self.raw = []
        self.raw_elems = 0
        self.raw_real = 0
        self._push_run(u, c)

    def _push_run(self, u, c) -> None:
        if u.shape[1] >= self.spill_threshold:
            self._spill(u, c)
            return
        self.runs.append((u, c, u.shape[1]))
        while len(self.runs) >= 2 and self.runs[-2][2] <= self.runs[-1][2]:
            kb, cb, _ = self.runs.pop()
            ka, ca, _ = self.runs.pop()
            u2, c2, _ = self.merge(ka, ca, kb, cb)
            if u2.shape[1] >= self.spill_threshold:
                self._spill(u2, c2)
                break
            self.runs.append((u2, c2, u2.shape[1]))

    # -- host + disk tiers -------------------------------------------------
    def _spill(self, u, c) -> None:
        """Pull a per-shard run set to host RAM and fold it into each
        shard's size-tiered host run list (native two-pointer merges)."""
        ku = _pull(u)
        kc = _pull(c).astype(np.uint32, copy=False)
        from kmcex import native

        for s in range(self.n):
            row_k, row_c = ku[s], kc[s]
            real = row_k != np.uint64(0xFFFFFFFFFFFFFFFF)
            rk, rc = row_k[real], row_c[real]
            if not len(rk):
                continue
            lst = self.host_runs[s]
            lst.append((rk, rc))
            while (len(lst) >= 2
                   and len(lst[-2][0]) < 2 * len(lst[-1][0])):
                kb, cb = lst.pop()
                ka, ca = lst.pop()
                lst.append(native.merge_runs(ka, ca, kb, cb))
        self._maybe_spill_to_disk()

    def _host_bytes(self) -> int:
        return sum(12 * len(k) for lst in self.host_runs for k, _ in lst)

    def _maybe_spill_to_disk(self) -> None:
        if not self.disk_spill_bytes:
            return
        from kmcex.count import device_lsm

        while self._host_bytes() > self.disk_spill_bytes:
            # drop the biggest run of the heaviest shard to disk
            s = max(range(self.n),
                    key=lambda i: sum(len(k) for k, _ in self.host_runs[i]))
            if not self.host_runs[s]:
                return
            ku, kc = self.host_runs[s].pop(0)  # cascade keeps largest first
            if self._disk_dir is None:
                import tempfile

                self._disk_dir = self._disk_dir_arg or tempfile.mkdtemp(
                    prefix="kmcex_sharded_")
            import os

            os.makedirs(self._disk_dir, exist_ok=True)
            path = os.path.join(
                self._disk_dir,
                f"s{s:03d}_run{len(self.disk_runs[s]):04d}.bin")
            device_lsm.write_run_file(path, ku, kc)
            self.disk_runs[s].append(path)

    def close(self) -> None:
        """Delete disk-tier files (idempotent; mirrors
        DeviceCountAccumulator.close)."""
        import os
        import shutil

        for lst in self.disk_runs:
            for p in lst:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        self.disk_runs = [[] for _ in range(self.n)]
        if self._disk_dir is not None:
            for name in ("merged_k.bin", "merged_c.bin"):
                try:
                    os.unlink(os.path.join(self._disk_dir, name))
                except OSError:
                    pass
            if self._disk_dir_arg is None:
                shutil.rmtree(self._disk_dir, ignore_errors=True)
            self._disk_dir = None

    def _merge_all_device(self):
        self._collapse_raw()
        while len(self.runs) >= 2:
            kb, cb, _ = self.runs.pop()
            ka, ca, _ = self.runs.pop()
            u, c, _ = self.merge(ka, ca, kb, cb)
            self.runs.append((u, c, u.shape[1]))

    def _run_sources(self):
        """Every sorted run (RAM arrays + disk memmaps) across all shards.
        Shards partition the key space by HASH (interleaved, not ranged),
        so the global ascending stream is a flat k-way merge over all of
        them — device_lsm._merge_streams does exactly that with bounded
        memory."""
        from kmcex.count import device_lsm

        src = []
        for s in range(self.n):
            src += [device_lsm.open_run_file(p) for p in self.disk_runs[s]]
            src += list(self.host_runs[s])
        return src

    def _drain_to_host(self) -> None:
        self._merge_all_device()
        if self.runs:
            u, c, _ = self.runs.pop()
            self._spill(u, c)

    # -- checkpoint / resume ------------------------------------------------
    def checkpoint(self, ckpt_dir: str, extra: dict | None = None) -> None:
        """Persist the sharded counting state (per-shard run sets) so a
        genome-scale multi-chip count can resume — mirrors
        DeviceCountAccumulator.checkpoint (the reference has no mid-build
        persistence, SURVEY.md §5).  Call on ALL processes of a
        multi-process runtime: the drain runs collectives (allgathers)
        that need every process, and every process holds the same
        gathered runs afterwards — the file/manifest writes themselves
        are gated on process 0 here, so concurrent calls never race on
        the shared checkpoint paths."""
        import json
        import os
        import shutil

        from kmcex.count import device_lsm

        self._drain_to_host()
        import jax as _jax

        if _jax.process_index() != 0:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        # new file generation per checkpoint: a restored accumulator memmaps
        # the previous generation read-only, so files are never overwritten
        # in place (SIGBUS); stale generations unlink after the manifest
        # lands (see DeviceCountAccumulator.checkpoint)
        gen = getattr(self, "_ckpt_gen", 0)
        shard_files: list[list[str]] = []
        for s in range(self.n):
            files = []
            for i, (ku, kc) in enumerate(self.host_runs[s]):
                name = f"g{gen:04d}_s{s:03d}_run{i:04d}.bin"
                device_lsm.write_run_file(os.path.join(ckpt_dir, name),
                                          np.asarray(ku), np.asarray(kc))
                files.append(name)
            for p in self.disk_runs[s]:
                name = f"g{gen:04d}_s{s:03d}_disk_{os.path.basename(p)}"
                shutil.copyfile(p, os.path.join(ckpt_dir, name))
                files.append(name)
            shard_files.append(files)
        tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump({"k": self.k, "n_shards": self.n,
                       "seg_rows": self.seg_rows, "seg_len": self.seg_len,
                       "total_windows": self.total_windows, "gen": gen,
                       "shard_files": shard_files, "extra": extra or {}}, f)
        os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))
        self._ckpt_gen = gen + 1
        keep = {n for fs in shard_files for n in fs} | {"manifest.json"}
        for name in os.listdir(ckpt_dir):
            if name not in keep and name.endswith(".bin"):
                try:
                    os.unlink(os.path.join(ckpt_dir, name))
                except OSError:
                    pass

    @staticmethod
    def read_manifest(ckpt_dir: str) -> dict | None:
        """The checkpoint manifest, or None when no complete checkpoint
        exists (mirrors DeviceCountAccumulator.read_manifest)."""
        import json
        import os

        try:
            with open(os.path.join(ckpt_dir, "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @classmethod
    def restore(cls, mesh: Mesh, ckpt_dir: str,
                **kwargs) -> "ShardedCountAccumulator":
        """Rebuild from ``checkpoint``; the mesh size must match.  Runs load
        as read-only memmaps; checkpoint files are never deleted."""
        import json
        import os

        from kmcex.count import device_lsm

        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            m = json.load(f)
        if int(m["n_shards"]) != mesh.devices.size:
            raise ValueError(
                f"checkpoint has {m['n_shards']} shards, mesh has "
                f"{mesh.devices.size}")
        acc = cls(mesh, int(m["k"]), int(m["seg_rows"]), int(m["seg_len"]),
                  **kwargs)
        acc.total_windows = int(m["total_windows"])
        for s, files in enumerate(m["shard_files"]):
            acc.host_runs[s] = [
                device_lsm.open_run_file(os.path.join(ckpt_dir, name))
                for name in files]
            acc.host_runs[s].sort(key=lambda r: -len(r[0]))
        acc._ckpt_gen = int(m.get("gen", 0)) + 1
        return acc

    def finalize(self, ci: int = 1, cs: int = 0xFFFFFFFF):
        """Global host-side (kmers, counts) sorted ascending.  Materializes
        the table — bounded by the RAM budget unless disk runs exist; use
        finalize_stream for the out-of-core regime."""
        total, hist, it = self.finalize_stream(ci, cs)
        parts = list(it)
        if not parts:
            return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint32)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    def finalize_stream(self, ci: int = 1, cs: int = 0xFFFFFFFF,
                        n_chunks: int = 16, bloom_factory=None):
        """Streaming finalize with the same (total, low_hist, chunk_iter)
        contract as DeviceCountAccumulator.finalize_stream: ascending
        ci-filtered cs-clamped chunks.  ONE k-way merge traversal total
        (one_pass_finalize computes the sizing stats while spooling the
        merged table).  Memory bound by regime: when the disk tier
        engaged, the merge spools to disk and host memory stays at
        (n_runs + 1) merge windows; below the disk threshold the
        ci-filtered cs-clamped table itself is retained in RAM alongside
        the source runs (both under the spill budget by construction).
        ``n_chunks`` is kept for API compatibility.

        ``bloom_factory`` (callable(low_hist) ->
        model.device_bloom.ShardedDeviceBloomBuilder) builds the Bloom
        bank ACROSS THE MESH before the table drains: each shard scatters
        its disjoint keys' probe bits, an OR-collective (pmax) combines the
        bitmaps, and only finished filter bytes come back — the
        commutative half of the encode scales with the mesh.  Engages
        only when no shard has spilled (host/disk runs would be missed);
        the builder lands on ``self.device_bloom``."""
        from kmcex.count import device_lsm

        self.device_bloom = None
        if (bloom_factory is not None and not any(self.host_runs)
                and not any(self.disk_runs) and (self.raw or self.runs)):
            self._merge_all_device()
            # re-check AFTER the merge: _collapse_raw/_push_run can spill
            # runs to host mid-merge, and a builder fed only the surviving
            # device run would silently lose the spilled keys' low counts
            if (self.runs and not any(self.host_runs)
                    and not any(self.disk_runs)):
                u, c, _ = self.runs[0]
                from kmcex.model.device_bloom import (
                    ShardedDeviceBloomBuilder,
                )

                hist = ShardedDeviceBloomBuilder.global_low_hist(
                    self.mesh, u, c, ci, cs)
                try:
                    builder = bloom_factory(hist)
                except ValueError:  # bitmap too large: host fallback
                    builder = None
                if builder is not None:
                    builder.feed_table_sharded(u, c)
                    self.device_bloom = builder
        self._drain_to_host()
        sources = self._run_sources()
        if not sources:
            return 0, np.zeros(3, dtype=np.int64), iter(())
        disk_dir = self._disk_dir if any(self.disk_runs) else None
        total, hist, it = device_lsm.one_pass_finalize(
            sources, ci, cs, disk_dir, cleanup=self.close)
        if disk_dir is not None:
            # the merged spool replaced the run files; free them now
            import os

            del sources
            for lst in self.disk_runs:
                for p in lst:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            self.disk_runs = [[] for _ in range(self.n)]
        return total, hist, it


def sharded_count(codes: np.ndarray, mesh: Mesh, k: int):
    """Count canonical k-mers of one batch across the mesh; returns merged
    host-side (kmers, counts) plus the per-shard partitions."""
    n = mesh.devices.size
    rows = codes.shape[0]
    assert rows % n == 0, "batch rows must divide the mesh"
    step = build_sharded_count_step(mesh, k, rows // n, codes.shape[1])
    uniq, counts, n_unique, windows = step(codes)
    uniq = np.asarray(uniq)
    counts = np.asarray(counts)
    n_unique = np.asarray(n_unique)
    parts = [(uniq[i, : n_unique[i]], counts[i, : n_unique[i]]) for i in range(n)]
    merged_k = np.concatenate([p[0] for p in parts])
    merged_c = np.concatenate([p[1] for p in parts])
    order = np.argsort(merged_k)
    return merged_k[order], merged_c[order], parts, int(windows)
