"""DeviceKModel — the KModel resident in device memory with a fully batched,
jit-compiled ``kmer_to_occ``.

This is the serving path (the reference's OpenMP query fan-out,
kmodel.hpp:90-98, rebuilt as one XLA program): every stage of the query
decision tree — exact rest-store lookup, back-filter membership, Bloom bank
probes, coupled bit-array probes, and the 8-neighbor disambiguation
(kmodel.hpp:100-116,286-359) — is computed for the whole batch with gathers
and combined with masks.  No data-dependent control flow; one fixed dataflow
graph, so XLA pipelines the HBM gathers.

All hash probes are MurmurHash64A over the ASCII k-mer bytes (regenerated on
device from the packed form) with the reference seed schedule, so results
are bit-identical to the host/native path (verified in tests against the
reference binary's answers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from kmcex.core import codec
from kmcex.core.murmur import (
    HASH_SEEDS,
    murmur_eval_jnp,
    murmur_pre_jnp,
)
from kmcex.model.kmodel import KModel

_U64 = jnp.uint64

_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)  # no canonical k-mer is all-ones


def _cuckoo_hashes(keys: np.ndarray, m1: int, m2: int, bits: int):
    with np.errstate(over="ignore"):
        h1 = (keys * np.uint64(m1)) >> np.uint64(64 - bits)
        h2 = (keys * np.uint64(m2)) >> np.uint64(64 - bits)
    return h1.astype(np.int64), h2.astype(np.int64)


def _build_cuckoo(keys: np.ndarray, vals: np.ndarray, seed: int = 0):
    """Two-table cuckoo hash of an exact (u64 key -> i32 value) map.

    The device rest-store lookup was a bucket binary search — ~11 gathers
    with a SERIAL dependency chain per query (each search step waits on the
    previous gather).  Cuckoo guarantees each key sits in one of exactly
    TWO slots, so the lookup is 2 independent key gathers + 2 value
    gathers, fully pipelined.  Build is vectorized numpy (eviction rounds);
    load factor <=0.45 converges in a few dozen rounds, else rehash with
    fresh multipliers."""
    n = len(keys)
    bits = max(4, int(np.ceil(np.log2(max(n * 1.1, 8)))))
    rng = np.random.default_rng(seed)
    for _attempt in range(16):
        S = 1 << bits
        m1 = int(rng.integers(1, 1 << 63)) * 2 + 1
        m2 = int(rng.integers(1, 1 << 63)) * 2 + 1
        t_k = [np.full(S, _EMPTY, np.uint64) for _ in range(2)]
        t_v = [np.zeros(S, np.int32) for _ in range(2)]
        cur_k, cur_v = keys.copy(), vals.copy()
        side = 0
        for _round in range(96):
            if not len(cur_k):
                break
            h1, h2 = _cuckoo_hashes(cur_k, m1, m2, bits)
            idx = h1 if side == 0 else h2
            tk, tv = t_k[side], t_v[side]
            uslots = np.unique(idx)
            orig_k = tk[uslots].copy()
            orig_v = tv[uslots].copy()
            tk[idx] = cur_k
            tv[idx] = cur_v
            placed = tk[idx] == cur_k
            changed = orig_k != tk[uslots]
            evict = changed & (orig_k != _EMPTY)
            cur_k = np.concatenate([cur_k[~placed], orig_k[evict]])
            cur_v = np.concatenate([cur_v[~placed], orig_v[evict]])
            side ^= 1
        else:
            bits += 1  # didn't converge: bigger tables, new multipliers
            continue
        return t_k[0], t_v[0], t_k[1], t_v[1], m1, m2, bits
    raise RuntimeError("cuckoo build failed to converge")


def _seed_matrix(n_bits: int, n_hash: int) -> np.ndarray:
    """seeds[i, j] = HashSeeds[(i*n_hash + j) % 128] (kmodel.hpp:450-453)."""
    idx = (np.arange(n_bits)[:, None] * n_hash + np.arange(n_hash)[None, :]) % 128
    return HASH_SEEDS[idx]


def _gather_bits(bits: jnp.ndarray, pos: jnp.ndarray) -> jnp.ndarray:
    """MSB-first bit gather from a uint8 array (kmodel.hpp:584-588).

    Byte indices are i32: every model table is far below 2^31 bytes (the
    reference's own sizes are counts>>4 scaled, kmodel.hpp:411-456), and
    32-bit gather indices halve the index-tensor bytes feeding the gather —
    the query path's dominant HBM traffic."""
    byte = (pos >> _U64(3)).astype(jnp.int32)
    shift = (jnp.uint8(7) - (pos & _U64(7)).astype(jnp.uint8))
    return (bits[byte] >> shift) & jnp.uint8(1)


class DeviceKModel:
    """Immutable device copy of a built/loaded KModel + jitted query.

    ``sharding``/``in_sharding`` turn the single-chip server into a
    data-parallel multi-chip one: pass a replicated NamedSharding for the
    model tables and a batch-sharded NamedSharding for the query tiles (see
    parallel.serve.ShardedKModelServer) — every op in the query program is
    batch-parallel, so XLA's SPMD partitioner splits it across the mesh with
    no collectives (the reference's OpenMP query fan-out, kmodel.hpp:90-98,
    scaled to chips)."""

    def __init__(self, km: KModel, sharding=None, in_sharding=None):
        self._in_sharding = in_sharding
        # batch-sharded tiles must divide the mesh
        self._tile_quantum = in_sharding.mesh.size if in_sharding is not None else 1
        self.k = km.kmer_length
        self.n_hash = km.n_hash
        self.n_bits = km.n_bits
        self.ci = km.ci
        self.cs = km.cs
        self.bf_num = km.bf_num
        self.probe_order = km.bloom.probe_order
        self.bf_num_hash = km.bf_num_hash
        self.bf_back_num_hash = km.bf_back_num_hash
        self.km_back_num_hash = km.km_back_num_hash
        self.bin_end_index1 = km.occu_bin.bin_end_index1

        target = sharding if sharding is not None else jax.devices()[0]
        put = lambda x: jax.device_put(jnp.asarray(x), target)

        # Bloom bank (zero-length filters stay host-side as static facts)
        self.bf_bits = [put(b) if len(b) else None for b in km.bloom.bit_bf]
        self.bf_back_bits = [put(b) if len(b) else None for b in km.bloom.bit_bf_back]
        self.bf_len = [int(x) for x in km.bloom.length_bf]
        self.bf_back_len = [int(x) for x in km.bloom.length_bf_back]

        # coupled arrays + km_back.  bit1/bit2 are interleaved into one u16
        # plane so each probe needs ONE gather for both the value bit and the
        # tag bit — the probe gathers are the query's dominant device cost.
        # Stored FLAT: a 1-D gather with fused index arithmetic lowers better
        # than a 2-D (array, byte) gather.
        self.bit12 = put(
            (km.bit1.astype(np.uint16)
             | (km.bit2.astype(np.uint16) << 8)).reshape(-1))
        self.km_bit_size = int(km.km_bit_size)
        self.km_back = put(km.km_back) if km.byte_km_back else None
        self.bit_km_back = int(km.bit_km_back)
        self._seed_flat = _seed_matrix(self.n_bits, self.n_hash).astype(np.uint64).reshape(-1)
        # shared hash-state seed vectors: ONE murmur precompute + eval per
        # distinct string serves every probe family (the precompute's block
        # mixes are ~40% of the query's device compute; round-3 ran them
        # up to 4x per query).  h_k = k-mer hashes for (BF main ++ bit
        # arrays); h_m = middle-(k-2)-mer hashes for (km_back ++ BF back).
        self._seeds_k = np.concatenate(
            [HASH_SEEDS[: self.bf_num_hash], self._seed_flat]).astype(np.uint64)
        self._n_seeds_m = max(self.bf_back_num_hash, self.km_back_num_hash)
        self._seeds_m = HASH_SEEDS[: self._n_seeds_m].astype(np.uint64)

        # rest store: exact lookups go through a 2-table cuckoo hash (two
        # independent key gathers replace the old bucket binary search's
        # serial ~11-gather chain).  The table holds the real entries PLUS
        # one "phantom" entry per bucket boundary reproducing the
        # reference's inclusive-high quirk (rest.hpp:236-247: a key above
        # its whole bucket that equals the NEXT bucket's first suffix hits
        # with that bucket's count) — so answers stay bit-identical to the
        # host path, quirk included.
        kld = km.kld
        self.rest_n = kld.suffix_bin_count
        if self.rest_n:
            full = kld._full_kmer_sorted()
            counts = kld.count_bin.astype(np.int32)
            suf_bits = 2 * kld.suf_len
            suffix = kld._ensure_suffix_int()
            pre = kld.pre_buffer.astype(np.int64)
            p_all = np.flatnonzero(kld.hash2index >= 0).astype(np.uint64)
            pi = kld.hash2index[p_all.astype(np.int64)]
            lo = pre[pi]
            hi = pre[pi + 1]
            ok = hi < self.rest_n
            prev_s = suffix[np.maximum(hi - 1, 0)]
            above = (lo == hi) | (suffix[np.minimum(hi, self.rest_n - 1)]
                                  > prev_s)
            pm = ok & above
            phantom_k = ((p_all[pm] << np.uint64(suf_bits))
                         | suffix[hi[pm]])
            phantom_v = counts[hi[pm]]
            keys = np.concatenate([full, phantom_k])
            vals = np.concatenate([counts, phantom_v])
            t1k, t1v, t2k, t2v, m1, m2, bits = _build_cuckoo(keys, vals)
            self.rest_t1k = put(t1k)
            self.rest_t1v = put(t1v)
            self.rest_t2k = put(t2k)
            self.rest_t2v = put(t2v)
            self.rest_m1 = np.uint64(m1)
            self.rest_m2 = np.uint64(m2)
            self.rest_bits = int(bits)
        # occ decode LUTs
        self.bin2mean = put(km.occu_bin.bin2mean_lut.astype(np.int32))
        self.occ2bin = put(km.occu_bin.occ2bin_lut.astype(np.int32))

        # gated program (half-tile find_bitarray) serves every tile; the
        # ungated one compiles lazily, only for rare overflowing tiles
        self._main = jax.jit(self._build_main(gated=True))
        self._main_full = jax.jit(self._build_main(gated=False))
        self._resolve = jax.jit(self._build_resolve())

    # -- probe primitives ---------------------------------------------------
    # All murmur evaluations share the seed-independent block mixes of each
    # ASCII string (murmur_pre_jnp): not re-mixing blocks per seed cuts
    # the hash work per query several-fold.
    def _murmur_positions(self, kmers, klen, seeds, bit_len):
        """[..., n_seeds] probe positions for the ASCII form of kmers."""
        ascii_b = codec.ascii_bytes_jnp(kmers, klen)  # [..., klen]
        bl, tl = murmur_pre_jnp(ascii_b)
        h = murmur_eval_jnp(bl, tl, klen, np.asarray(seeds, dtype=np.uint64))
        return h % _U64(bit_len)

    def _check_bloom(self, kmers, klen, bits, bit_len, n_hash, seeds):
        if bits is None or bit_len == 0:
            return jnp.zeros(kmers.shape, dtype=bool)
        pos = self._murmur_positions(kmers, klen, seeds, bit_len)
        return jnp.all(_gather_bits(bits, pos) == 1, axis=-1)

    def _middle(self, kmers):
        return codec.middle_kmer_jnp(kmers, self.k)

    def _hash_state(self, kmers):
        """Shared murmur state for one batch of canonical k-mers:
        (h_k [..., bf_num_hash + nb*nh], h_m [..., n_seeds_m]).  One ASCII
        regen + precompute + eval per distinct string; every probe family
        below takes positions as (h % its table length)."""
        ascii_k = codec.ascii_bytes_jnp(kmers, self.k)
        bl, tl = murmur_pre_jnp(ascii_k)
        h_k = murmur_eval_jnp(bl, tl, self.k, self._seeds_k)
        ascii_m = codec.ascii_bytes_jnp(self._middle(kmers), self.k - 2)
        blm, tlm = murmur_pre_jnp(ascii_m)
        h_m = murmur_eval_jnp(blm, tlm, self.k - 2, self._seeds_m)
        return h_k, h_m

    def _check_back(self, kmers, h_m=None):
        """check_back_bloomfilter over km_back (kmodel.hpp:107)."""
        if self.km_back is None:
            return jnp.zeros(kmers.shape, dtype=bool)
        if h_m is None:
            return self._check_bloom(
                self._middle(kmers), self.k - 2, self.km_back,
                self.bit_km_back, self.km_back_num_hash,
                HASH_SEEDS[: self.km_back_num_hash],
            )
        pos = h_m[..., : self.km_back_num_hash] % _U64(self.bit_km_back)
        return jnp.all(_gather_bits(self.km_back, pos) == 1, axis=-1)

    def _check_all_bf(self, kmers, h_k=None, h_m=None):
        """check_all_bf (kmodel.hpp:361-371): first hit in probe order."""
        occ = jnp.zeros(kmers.shape, dtype=jnp.int32)
        mids = self._middle(kmers) if h_m is None else None
        for i in self.probe_order:
            if self.bf_bits[i] is None or self.bf_len[i] == 0:
                main = jnp.zeros(kmers.shape, dtype=bool)
            elif h_k is not None:
                pos = (h_k[..., : self.bf_num_hash]
                       % _U64(self.bf_len[i]))
                main = jnp.all(
                    _gather_bits(self.bf_bits[i], pos) == 1, axis=-1)
            else:
                main = self._check_bloom(
                    kmers, self.k, self.bf_bits[i], self.bf_len[i],
                    self.bf_num_hash, HASH_SEEDS[: self.bf_num_hash],
                )
            if self.bf_back_bits[i] is None or self.bf_back_len[i] == 0:
                back = jnp.zeros(kmers.shape, dtype=bool)
            elif h_m is not None:
                pos = (h_m[..., : self.bf_back_num_hash]
                       % _U64(self.bf_back_len[i]))
                back = jnp.all(
                    _gather_bits(self.bf_back_bits[i], pos) == 1, axis=-1)
            else:
                back = self._check_bloom(
                    mids, self.k - 2, self.bf_back_bits[i],
                    self.bf_back_len[i], self.bf_back_num_hash,
                    HASH_SEEDS[: self.bf_back_num_hash],
                )
            hit = main & back & (occ == 0)
            occ = jnp.where(hit, i + self.ci, occ)
        return occ

    def _find_bitarray(self, kmers, h_k=None):
        """[..., n_bits] decoded bins, -1 where tags miss (kmodel.hpp:625-646)."""
        if h_k is not None:
            h = h_k[..., self.bf_num_hash :]
        else:
            ascii_b = codec.ascii_bytes_jnp(kmers, self.k)  # [..., k]
            bl, tl = murmur_pre_jnp(ascii_b)
            h = murmur_eval_jnp(bl, tl, self.k, self._seed_flat)  # [..., nb*nh]
        pos = (h % _U64(self.km_bit_size)).reshape(
            kmers.shape + (self.n_bits, self.n_hash)
        )
        byte = (pos >> _U64(3)).astype(jnp.int32)  # tables << 2^31 bytes
        shift = (jnp.uint16(7) - (pos & _U64(7)).astype(jnp.uint16))
        nb_idx = jnp.arange(self.n_bits, dtype=jnp.int32)[:, None]
        km_bytes = jnp.int32(self.km_bit_size >> 3)
        # one FLAT gather: low byte bit1, high byte bit2
        w = self.bit12[nb_idx * km_bytes + byte]
        v1 = ((w >> shift) & jnp.uint16(1)).astype(jnp.uint8)
        v2 = ((w >> (shift + jnp.uint16(8))) & jnp.uint16(1)).astype(jnp.uint8)
        ok = jnp.all(v2 == 1, axis=-1)
        weights = (jnp.int32(1) << jnp.arange(self.n_hash, dtype=jnp.int32))
        bins = jnp.sum(v1.astype(jnp.int32) * weights, axis=-1)
        return jnp.where(ok, bins, -1)

    def _check_rest(self, kmers):
        """Exact lookup via the 2-table cuckoo hash: 2 independent key
        gathers + 2 value gathers, no serial search chain.  The phantom
        entries added at build time reproduce the reference's
        inclusive-high quirk exactly (rest.hpp:223-251; see __init__)."""
        if self.rest_n == 0:
            return jnp.zeros(kmers.shape, dtype=jnp.int32)
        sh = _U64(64 - self.rest_bits)
        i1 = ((kmers * _U64(self.rest_m1)) >> sh).astype(jnp.int32)
        i2 = ((kmers * _U64(self.rest_m2)) >> sh).astype(jnp.int32)
        hit1 = self.rest_t1k[i1] == kmers
        hit2 = self.rest_t2k[i2] == kmers
        return jnp.where(
            hit1, self.rest_t1v[i1],
            jnp.where(hit2, self.rest_t2v[i2], 0)).astype(jnp.int32)

    # -- the full decision tree --------------------------------------------
    def _neighbor_candidates(self, kmers):
        """get_neighbor_kmer_bin (kmodel.hpp:326-359): values + validity for
        the 8 shift neighbors of each k-mer."""
        k = self.k
        mask2k = _U64((1 << (2 * k)) - 1) if k < 32 else _U64(0xFFFFFFFFFFFFFFFF)
        bases = jnp.arange(4, dtype=_U64)
        fwd = ((kmers[..., None] << _U64(2)) & mask2k) | bases
        bwd = (kmers[..., None] >> _U64(2)) | (bases << _U64(2 * (k - 1)))
        neigh = codec.canonical_jnp(jnp.concatenate([fwd, bwd], axis=-1), k)  # [..., 8]

        rest_c = self._check_rest(neigh)
        rest_hit = rest_c > 0
        rest_val = self.occ2bin[jnp.clip(rest_c, 0, self.occ2bin.shape[0] - 1)]

        h_k, h_m = self._hash_state(neigh)
        bf = self._check_all_bf(neigh, h_k, h_m)
        bf_hit = bf != 0

        back = self._check_back(neigh, h_m)
        B = self._find_bitarray(neigh, h_k)  # [..., 8, nb]
        ok = B != -1
        any_ok = jnp.any(ok, axis=-1)
        nz = ok & (B != 0)
        any_nz = jnp.any(nz, axis=-1)
        first_nz_idx = jnp.argmax(nz, axis=-1)
        first_nz = jnp.take_along_axis(B, first_nz_idx[..., None], axis=-1)[..., 0]
        one_val = jnp.where(any_nz, first_nz, 0)
        one_hit = back & any_ok

        vals = jnp.where(rest_hit, rest_val, jnp.where(bf_hit, bf, one_val))
        valid = rest_hit | bf_hit | one_hit
        return vals.astype(jnp.int32), valid

    def _decode_bin(self, bin_val):
        """OccuBin bin -> approximate count (identity below bin_end_index1)."""
        mean = self.bin2mean[jnp.clip(bin_val, 0, self.bin2mean.shape[0] - 1)]
        return jnp.where(bin_val < self.bin_end_index1, bin_val, mean)

    def _build_main(self, gated: bool = True):
        """Phase 1 (runs for every query): everything except the 8-neighbor
        disambiguation.  Returns the final answer where it is determined plus
        the inputs phase 2 needs for the (rare) ambiguous queries — masked
        lanes of a vectorized program still pay full cost, so the
        9x-heavier candidate pass must not run for the whole batch.  ``gated`` selects the half-tile
        find_bitarray variant (see below)."""

        def main(kmers: jnp.ndarray):
            kmers = codec.canonical_jnp(kmers.astype(_U64), self.k)
            rest_occ = self._check_rest(kmers)
            h_k, h_m = self._hash_state(kmers)
            is_back = self._check_back(kmers, h_m)
            bf_occ = self._check_all_bf(kmers, h_k, h_m)

            # find_bitarray is the query's largest gather block (nb*nh per
            # lane), but its result only matters for lanes the decision
            # tree routes to the coupled arrays: in back-filter AND not in
            # the exact store (kmodel.hpp:104-113) — and downstream only
            # (nbin, first_bin) are consumed (phase 2 re-probes the rare
            # ambiguous lanes itself).  The gated program probes a
            # COMPACTED 3/4 tile unconditionally — hashes recomputed for
            # the selected lanes (compute is ~free; gathers are the cost) —
            # and reports `overflow` when more lanes needed probing; the
            # HOST then re-dispatches that tile through the ungated
            # program (and stops gating for the rest of the batch); an
            # in-program lax.cond would be a scheduling barrier between
            # the probe stages.  3/4 (not 1/2) because the saturated
            # km_back filter is format-pinned at ~86% fill (the
            # reference's own sizing), so ~half of even random queries
            # pass it — need fractions sit near 0.5 on mixed workloads
            # and above it on resident-heavy ones.
            need_fb = is_back & (rest_occ == 0)
            N = kmers.shape[0]
            M = max(1, (3 * N) // 4)

            def fb_stats(ks, h):
                B = self._find_bitarray(ks, h)
                pos_mask = B > 0
                nbin = jnp.sum(pos_mask, axis=-1)
                first_idx = jnp.argmax(pos_mask, axis=-1)
                first_bin = jnp.where(
                    nbin > 0,
                    jnp.take_along_axis(B, first_idx[..., None], -1)[..., 0],
                    0)
                return nbin.astype(jnp.int32), first_bin.astype(jnp.int32)

            if gated and N > 1:
                sel = jnp.argsort(jnp.where(need_fb, 0, 1)
                                  .astype(jnp.int32))[:M]
                nb_h, fb_h = fb_stats(kmers[sel], None)
                zero = jnp.zeros(N, jnp.int32)
                nbin = zero.at[sel].set(nb_h, unique_indices=True)
                first_bin = zero.at[sel].set(fb_h, unique_indices=True)
                overflow = jnp.sum(need_fb) > M
            else:
                nbin, first_bin = fb_stats(kmers, h_k)
                overflow = jnp.bool_(False)

            # kmer_to_bin without candidates (kmodel.hpp:286-302):
            # len==0 -> occ; len==1 & occ==0 -> first_bin; rest = ambiguous.
            bin_val = jnp.where(nbin == 0, bf_occ, first_bin)
            bit_path = self._decode_bin(bin_val)

            out = jnp.where(
                rest_occ != 0,
                rest_occ,
                jnp.where(
                    ~is_back,
                    jnp.where(bf_occ != 0, bf_occ, 0),
                    bit_path,
                ),
            ).astype(jnp.int32)
            ambiguous = (
                (rest_occ == 0)
                & is_back
                & (((nbin == 1) & (bf_occ != 0)) | (nbin >= 2))
            )
            # Only (out, ambiguous, overflow) cross the device->host link
            # (the link is the end-to-end bottleneck), so they travel
            # small: answers are <= cs (u16 when cs permits) and the
            # ambiguity mask is bit-packed (x8) — ~2.4x fewer download
            # bytes per tile.  Phase 2 recomputes probe state on device
            # for the few ambiguous survivors.
            if self.cs < (1 << 16):
                out = out.astype(jnp.uint16)
            if N % 8 == 0:
                bits = ambiguous.reshape(-1, 8).astype(jnp.uint8)
                weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
                ambiguous = jnp.sum(bits * weights, axis=1,
                                    dtype=jnp.uint8)
            return out, ambiguous, overflow

        return main

    RESOLVE_TILE = 4096

    def _build_resolve(self):
        """Phase 2 (ambiguous queries only): neighbor candidates + the
        reference's majority/nearest-bin rules (kmodel.hpp:292-322).  Takes
        raw packed k-mers and recomputes B/bf_occ on device — cheaper than
        shipping per-query probe state over the host link for ~0.1% of
        queries."""

        def resolve(kmers):
            kmers = codec.canonical_jnp(kmers.astype(_U64), self.k)
            h_k, h_m = self._hash_state(kmers)
            B = self._find_bitarray(kmers, h_k)
            bf_occ = self._check_all_bf(kmers, h_k, h_m)
            pos_mask = B > 0
            nbin = jnp.sum(pos_mask, axis=-1)
            first_idx = jnp.argmax(pos_mask, axis=-1)
            first_bin = jnp.where(
                nbin > 0, jnp.take_along_axis(B, first_idx[..., None], -1)[..., 0], 0
            )
            cand_vals, cand_valid = self._neighbor_candidates(kmers)
            n_cand = jnp.sum(cand_valid, axis=-1)
            cnt_bf = jnp.sum(
                cand_valid & (cand_vals < self.ci + self.bf_num), axis=-1
            )
            take_occ1 = (nbin == 1) & (bf_occ != 0) & (cnt_bf >= n_cand // 2)
            big = jnp.int32(1 << 21)
            dist = jnp.abs(B[..., :, None] - cand_vals[..., None, :])
            dist = jnp.where(cand_valid[..., None, :], dist, big)
            cur_min = jnp.min(dist, axis=-1)
            cur_min = jnp.where(pos_mask, cur_min, big * 2)
            best_multi = jnp.take_along_axis(
                B, jnp.argmin(cur_min, axis=-1)[..., None], -1
            )[..., 0]
            best_multi = jnp.where(n_cand > 0, best_multi, 0)
            bin_val = jnp.where(
                nbin == 1, jnp.where(take_occ1, bf_occ, first_bin), best_multi
            )
            return self._decode_bin(bin_val).astype(jnp.int32)

        return resolve

    # Queries are processed in fixed-size tiles: the probe tensors scale
    # with N x n_bits x n_hash, so an unbounded batch blows device memory
    # at compile time, and one tile shape = one compiled program.  A tile's
    # probe tensors take well under 1 GB, small beside an 80 GB card.  Device throughput is
    # gather-bound; the host link is hidden by pipelining uploads, compute
    # and async downloads across tiles.
    TILE = 1 << 16
    # Tiles in flight at once: bounds device memory for huge query batches
    # while keeping the upload/compute/download pipeline full.
    GROUP = 64

    def kmer_to_occ(self, kmers_u64, tile: int | None = None) -> np.ndarray:
        """Batched query; input packed uint64, canonicalized on device.

        Arbitrarily large batches run in TILE-sized phase-1 device calls
        (uploads first, then dispatches, downloads async, so nothing blocks
        until all tiles of a group are in flight); the ambiguous survivors
        (typically ~0.1%) are resolved in RESOLVE_TILE-sized phase-2 calls."""
        qa = np.asarray(kmers_u64, dtype=np.uint64)
        q = qa.reshape(-1)
        tile = tile or self.TILE
        n = len(q)
        if n == 0:
            return np.zeros(qa.shape, dtype=np.int32)

        out = np.zeros(n, dtype=np.int32)
        amb_idx: list[np.ndarray] = []
        # Probe gating compacts lanes with a batch-wide argsort — fine on
        # one chip, but under a batch-sharded mesh it would become a
        # cross-shard sort (the serve path is otherwise zero-collective),
        # so multi-chip serving uses the ungated program.
        gate_on = self._in_sharding is None
        starts = list(range(0, n, tile))
        for g in range(0, len(starts), self.GROUP):
            group = starts[g : g + self.GROUP]
            chunks = []
            for a in group:
                chunk = q[a : a + tile]
                nc = len(chunk)
                t = min(tile, max(1 << max(0, (nc - 1).bit_length()),
                                  self._tile_quantum))
                if nc < t:
                    chunk = np.pad(chunk, (0, t - nc))
                chunks.append((a, nc, chunk))
            # stage 1: all uploads (independent of any queued compute)
            dev = [
                (a, nc, jax.device_put(c, self._in_sharding))
                for a, nc, c in chunks
            ]
            # stage 2: all dispatches + async downloads.  Once a tile of
            # this batch overflowed the gate, later tiles dispatch through
            # the ungated program directly (workloads are homogeneous
            # within a batch; re-dispatching every tile would double work).
            pending = []
            for a, nc, c in dev:
                if gate_on:
                    o, amb, ovf = self._main(c)
                else:
                    o, amb, ovf = self._main_full(c)
                o.copy_to_host_async()
                amb.copy_to_host_async()
                ovf.copy_to_host_async()
                pending.append((a, nc, c, o, amb, ovf))
            # stage 3: harvest; a tile where >3/4 of the lanes needed the
            # coupled-array probe re-dispatches through the ungated program
            for a, nc, c, o, amb, ovf in pending:
                if bool(np.asarray(ovf)):
                    gate_on = False
                    o, amb, _ = self._main_full(c)
                out[a : a + nc] = np.asarray(o)[:nc]
                amb_np = np.asarray(amb)
                if amb_np.dtype != np.bool_:  # bit-packed (see _build_main)
                    amb_np = np.unpackbits(amb_np, bitorder="little")
                ai = np.flatnonzero(amb_np[:nc])
                if len(ai):
                    amb_idx.append(ai + a)
        if amb_idx:
            idx = np.concatenate(amb_idx)
            ks = q[idx]  # phase 2 recomputes probe state on device
            rt = self.RESOLVE_TILE
            res = []
            for a in range(0, len(idx), rt):
                ke = ks[a : a + rt]
                nc = len(ke)
                if nc < rt:  # one fixed shape -> one compiled program
                    ke = np.pad(ke, (0, rt - nc))
                ked = jax.device_put(ke.astype(np.uint64), self._in_sharding)
                res.append(np.asarray(self._resolve(ked))[:nc])
            out[idx] = np.concatenate(res)
        return out.reshape(qa.shape)
