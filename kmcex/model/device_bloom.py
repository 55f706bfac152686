"""Device-side Bloom-bank build.

The reference inserts low-count k-mers into the Bloom pairs with atomic
scatter-ORs on the host (kmodel.hpp:473-506) — commutative and order-free,
which makes it the one piece of the encode that can leave the sequential
host schedule entirely.  Here the (nh-1) main-filter and (nh-2) back-filter
probe positions are computed on device straight from the counted table
(murmur over the regenerated ASCII form, exactly the host/native seed
schedule) and set into a device bitmap; only the FINISHED filter bytes
cross the device->host link.  On singleton-heavy real spectra ~80% of the
table's keys feed the Bloom bank, so this removes most of the
table transfer — the finished filters are ~5x smaller than the keys that
build them — and takes bloom insertion off the host entirely.

Bitmap strategy: an XLA scatter `.at[pos].set(1)` into a ONE-BYTE-PER-BIT
bitmap is trivially exact under duplicate positions (every writer stores
the same byte, so no read-modify-write race exists), where a bit-packed
bitmap would need an atomic OR.  All 2*bf_num filter tables
live at byte-aligned offsets in ONE flat bitmap so each tile needs ONE
scatter; table lengths and offsets are traced scalars, so one compiled
program serves every dataset of a given padded size.  The byte pack
(bit j of a byte is MSB-first, kmodel.hpp:576-588) runs on device; the
host pulls ready-to-use filter bytes, bit-identical to the host build
(order-independence makes parity free; asserted in tests).
"""

from __future__ import annotations

import functools

import numpy as np

from kmcex.model.bloom import BloomBank, bf_sizes

# Rows per feed dispatch: [TILE, (bf_num)*(2nh-3)] position tensors stay
# ~200MB at bf_num=3 (small beside the card's memory) while keeping the
# dispatch count low.
TILE = 1 << 21

# Bitmaps are one byte per bit; beyond this capacity (a small share of an
# 80 GB card) fall back to the host build (the disk-spill regimes never
# reach here anyway).
MAX_BITMAP_BYTES = 4 << 30


def _tile_positions(ut, ct, cs, lens, offs, cap, k: int, ci: int,
                    bf_num: int, n_hash: int):
    """Flat probe-bit positions for one tile of (kmer, count) rows; masked
    lanes map to ``cap`` (callers scatter with mode="drop").  ``cs`` is the
    counter cap: membership matches the reference's cs-CLAMPED counters
    (its kmc binary clamps when writing the database), which matters for
    configs with cs < ci + bf_num."""
    import jax.numpy as jnp

    from kmcex.core import codec
    from kmcex.core.murmur import (
        HASH_SEEDS,
        murmur_eval_jnp,
        murmur_pre_jnp,
    )
    from kmcex.count.device_lsm import SENTINEL

    real = ut != SENTINEL
    ct = jnp.minimum(ct, cs)
    ascii_k = codec.ascii_bytes_jnp(ut, k)
    bl, tl = murmur_pre_jnp(ascii_k)
    h_main = murmur_eval_jnp(bl, tl, k, HASH_SEEDS[: n_hash - 1])
    ascii_m = codec.ascii_bytes_jnp(codec.middle_kmer_jnp(ut, k), k - 2)
    blm, tlm = murmur_pre_jnp(ascii_m)
    h_back = murmur_eval_jnp(blm, tlm, k - 2, HASH_SEEDS[: n_hash - 2])

    dump = jnp.uint64(cap)  # mode="drop" swallows masked lanes
    pos_parts = []
    for i in range(bf_num):
        low = real & (ct == np.uint32(ci + i))
        pm = offs[2 * i] + h_main % lens[2 * i]
        pb = offs[2 * i + 1] + h_back % lens[2 * i + 1]
        pos_parts.append(jnp.where(low[:, None], pm, dump))
        pos_parts.append(jnp.where(low[:, None], pb, dump))
    return jnp.concatenate(pos_parts, axis=1).reshape(-1)


@functools.lru_cache(maxsize=None)
def _feed_program(k: int, ci: int, bf_num: int, n_hash: int):
    """Build the jitted per-tile feed: (u, c, t, lens, offs, bitmap) ->
    bitmap with this tile's probe bits set.  ``lens``/``offs`` are u64
    vectors of the 2*bf_num table bit-lengths and bitmap offsets (traced,
    so the program is reused across datasets)."""
    import jax
    import jax.numpy as jnp

    # bitmap donated: the builder rebinds the result each call, and the
    # copy XLA would otherwise make costs a full bitmap of HBM traffic
    # per tile
    @functools.partial(jax.jit, donate_argnums=(6,))
    def feed(u, c, t, cs, lens, offs, bitmap):
        ut = jax.lax.dynamic_slice(u, (t * TILE,), (TILE,))
        ct = jax.lax.dynamic_slice(c, (t * TILE,), (TILE,))
        pos = _tile_positions(ut, ct, cs, lens, offs, bitmap.shape[0],
                              k, ci, bf_num, n_hash)
        return bitmap.at[pos].set(jnp.uint8(1), mode="drop")

    return feed


def _pack_bytes(bm):
    """bits u8[cap] -> bytes u8[cap//8], MSB-first within each byte
    (reference set_bit/check_bit layout, kmodel.hpp:576-588)."""
    import jax.numpy as jnp

    g = bm.reshape(-1, 8)
    out = jnp.zeros(g.shape[0], jnp.uint8)
    for j in range(8):
        out = out | (g[:, j] << np.uint8(7 - j))
    return out


@functools.lru_cache(maxsize=None)
def _sharded_feed_program(mesh, k: int, ci: int, bf_num: int, n_hash: int):
    """shard_map feed over a hash-sharded table: each shard scatters its
    own disjoint keys' probe bits into a local bitmap, an OR-collective
    (pmax of the 0/1 bitmaps) over the shard axis combines them, and the
    byte pack runs in the same program — one dispatch returns the replicated finished
    filter bytes.  This is the 'atomic-OR is ideal for collectives'
    pattern from SURVEY.md §5 made literal: the Bloom side of the encode
    scales with the mesh while the order-dependent coupled-array side
    stays on the host."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def local(u_l, c_l, cs, lens, offs, bitmap):
        u = u_l[0]
        c = c_l[0]
        bm = bitmap
        cap = bm.shape[0]
        S = u.shape[0]
        for a in range(0, S, TILE):
            pos = _tile_positions(u[a : a + TILE], c[a : a + TILE], cs,
                                  lens, offs, cap, k, ci, bf_num, n_hash)
            bm = bm.at[pos].set(jnp.uint8(1), mode="drop")
        # OR of 0/1 bitmaps across shards is their max
        bm = jax.lax.pmax(bm, "shard")
        return _pack_bytes(bm)

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("shard"), P("shard"), P(), P(), P(), P()),
        out_specs=P()))


@functools.lru_cache(maxsize=None)
def _sharded_low_hist_program(mesh):
    """psum of the low-counter histogram over the shard axis (the global
    pass-1 sizing numbers, computed without draining the table)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kmcex.count.device_lsm import SENTINEL

    def local(u_l, c_l, ci_, cs_):
        u = u_l[0]
        c = jnp.minimum(c_l[0], cs_)  # reference counters are cs-clamped
        real = u != SENTINEL
        h = jnp.stack([
            jnp.sum(real & (c == ci_ + np.uint32(i)), dtype=jnp.int64)
            for i in range(3)])
        return jax.lax.psum(h, "shard")

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("shard"), P("shard"), P(), P()),
        out_specs=P()))


@functools.lru_cache(maxsize=None)
def _pack_program():
    """jitted single-device wrapper around _pack_bytes."""
    import jax

    return jax.jit(_pack_bytes)


class DeviceBloomBuilder:
    """Accumulates the Bloom bank on device while the count table streams
    to the host encode.  Lifecycle:

        b = DeviceBloomBuilder(k, ci, cs, n_hash, low_hist)  # post stats pull
        b.feed_table(u, c, n_real)     # device arrays from the finalize
        b.start_pull()                 # dispatch byte-pack + async pull
        b.into(bank)                   # fill a BloomBank's byte arrays

    Raises ValueError at construction when the bitmap would exceed
    MAX_BITMAP_BYTES (callers fall back to the host build)."""

    def __init__(self, k: int, ci: int, cs: int, n_hash: int, low_hist):
        import jax
        import jax.numpy as jnp

        self.k = int(k)
        self.ci = int(ci)
        self.cs = int(cs)
        self.n_hash = int(n_hash)
        self.bf_num = 1 if ci == 1 else 3
        counts = np.zeros(3, dtype=np.uint64)
        counts[: self.bf_num] = np.asarray(low_hist)[: self.bf_num]
        self.byte_bf, self.byte_back = bf_sizes(counts[: self.bf_num], n_hash)
        # interleaved (main_i, back_i) byte-aligned offsets into one bitmap
        sizes_bits = []
        for i in range(self.bf_num):
            sizes_bits += [int(self.byte_bf[i]) * 8, int(self.byte_back[i]) * 8]
        offs = np.cumsum([0] + sizes_bits[:-1]).astype(np.uint64)
        total_bits = int(sum(sizes_bits))
        if total_bits > MAX_BITMAP_BYTES:
            raise ValueError(
                f"device bloom bitmap would need {total_bits} bytes")
        cap = 1 << max(3, (total_bits - 1).bit_length())
        self.total_bytes = total_bits // 8
        self._lens = jax.device_put(
            np.array(sizes_bits, dtype=np.uint64))
        self._offs = jax.device_put(offs)
        self._bitmap = jnp.zeros(cap, jnp.uint8)
        self._feed = _feed_program(self.k, self.ci, self.bf_num, self.n_hash)
        self._pack = _pack_program()
        self._pulled = None

    def feed_table(self, u, c, n_real: int) -> None:
        """Scatter the probe bits of every low-count key in ``u[:n_real]``
        (device arrays, SENTINEL-padded, sorted-unique).  Each key must be
        fed exactly once across all calls (duplicate POSITIONS are fine —
        set(1) is idempotent — duplicate KEYS are too, but signal an
        upstream bug)."""
        import jax.numpy as jnp

        size = int(u.shape[0])
        n = min(size, max(int(n_real), 0))
        n_tiles = -(-n // TILE)
        if size % TILE:
            pad = n_tiles * TILE - size
            if pad > 0:
                from kmcex.count.device_lsm import SENTINEL

                u = jnp.concatenate(
                    [u, jnp.full((pad,), SENTINEL, jnp.uint64)])
                c = jnp.concatenate([c, jnp.zeros((pad,), jnp.uint32)])
        for t in range(n_tiles):
            self._bitmap = self._feed(u, c, jnp.int32(t),
                                      jnp.uint32(self.cs), self._lens,
                                      self._offs, self._bitmap)

    def start_pull(self) -> None:
        """Dispatch the byte pack and start the async device->host pull of
        the finished filter bytes (call right after the last feed; the pull
        overlaps the host encode)."""
        if self._pulled is None:
            b = self._pack(self._bitmap)[: self.total_bytes]
            b.copy_to_host_async()
            self._pulled = b

    def into(self, bank: BloomBank) -> None:
        """Fill ``bank``'s filter byte arrays (sizes must match: the bank
        must be built from the same low_hist/n_hash/ci)."""
        self.start_pull()
        data = np.asarray(self._pulled)
        off = 0
        for i in range(self.bf_num):
            for arr, nbytes in ((bank.bit_bf[i], int(self.byte_bf[i])),
                                (bank.bit_bf_back[i], int(self.byte_back[i]))):
                assert len(arr) == nbytes, "bank sized from different hist"
                arr[:] = data[off : off + nbytes]
                off += nbytes


class ShardedDeviceBloomBuilder(DeviceBloomBuilder):
    """Bloom bank built across the device MESH: each shard scatters its
    disjoint partition's probe bits locally, an OR-collective (pmax) over
    the shard axis ORs the bitmaps, and the finished bytes come back
    replicated — the
    commutative half of the encode scaling with the mesh (SURVEY.md §5).
    Feed with the per-shard merged run ([n_shards, S] sharded arrays)
    BEFORE the table drains to the host."""

    def __init__(self, mesh, k: int, ci: int, cs: int, n_hash: int,
                 low_hist):
        super().__init__(k, ci, cs, n_hash, low_hist)
        self.mesh = mesh

    def feed_table_sharded(self, u, c) -> None:
        import jax.numpy as jnp

        prog = _sharded_feed_program(self.mesh, self.k, self.ci,
                                     self.bf_num, self.n_hash)
        data = prog(u, c, jnp.uint32(self.cs), self._lens, self._offs,
                    self._bitmap)[: self.total_bytes]
        data.copy_to_host_async()
        self._pulled = data  # start_pull() becomes a no-op

    @staticmethod
    def global_low_hist(mesh, u, c, ci: int, cs: int) -> np.ndarray:
        """Global pass-1 histogram (cs-clamped counter == ci+i) of a
        sharded table."""
        import jax.numpy as jnp

        return np.asarray(
            _sharded_low_hist_program(mesh)(u, c, jnp.uint32(ci),
                                            jnp.uint32(cs)))
