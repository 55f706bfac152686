"""Stage-by-stage device cost profile of the DeviceKModel query path.

Times jitted PREFIXES of the phase-1 program on one TILE of queries; the
differences localize the compute gap between the full decision tree
(compute-only Mq/s) and the pure-gather roofline.  Run alone: one process
per card.
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import jax
import jax.numpy as jnp

from kmcex.core import codec
from kmcex.model.kmodel import get_model
from kmcex.query.device_model import DeviceKModel

K, NH, NB, CI, CS = 31, 7, 5, 1, 1023


def build_model(n=3_400_000, seed=0):
    if len(sys.argv) > 1:  # profile against a real workload's model
        from kmcex.count.pipeline import count_encode

        km, kmers, counts, _ = count_encode(sys.argv[1], k=K, ci=CI, cs=CS,
                                            num_hash=NH, num_bit=NB)
        print(f"model from {sys.argv[1]}: {len(kmers)} distinct, "
              f"{km.kld.suffix_bin_count} rest entries, "
              f"bf={int(km.bloom.kmer_counts.sum())}", flush=True)
        return km, kmers
    rng = np.random.default_rng(seed)
    kmers = np.unique(codec.canonical_np(
        rng.integers(0, 1 << 62, size=n, dtype=np.uint64), K))
    counts = np.minimum(
        rng.geometric(0.3, size=len(kmers)).astype(np.uint32), CS)
    km = get_model(CI, CS, NH, NB)
    km.init_from_pairs(kmers, counts, K)
    print(f"synthetic model: {len(kmers)} distinct, "
          f"{km.kld.suffix_bin_count} rest entries, "
          f"bf={int(km.bloom.kmer_counts.sum())}", flush=True)
    return km, kmers


def timeit(f, *args, reps=8):
    o = f(*args)
    jax.block_until_ready(o)
    t0 = time.time()
    for _ in range(reps):
        o = f(*args)
    jax.block_until_ready(o)
    return (time.time() - t0) / reps


def main():
    print("building model ...", flush=True)
    km, kmers = build_model()
    dm = DeviceKModel(km)
    rng = np.random.default_rng(1)
    nq = dm.TILE
    q = np.concatenate([
        rng.choice(kmers, nq // 2),
        rng.integers(0, 1 << 62, nq // 2, dtype=np.uint64)])
    rng.shuffle(q)
    qd = jax.device_put(q)
    jax.block_until_ready(qd)

    stages = {}

    f_canon = jax.jit(lambda ks: codec.canonical_jnp(
        ks.astype(jnp.uint64), dm.k))
    stages["canonical"] = timeit(f_canon, qd)

    def pre_hash(ks):
        ks = codec.canonical_jnp(ks.astype(jnp.uint64), dm.k)
        h_k, h_m = dm._hash_state(ks)
        return h_k.sum() + h_m.sum()

    stages["+hash_state"] = timeit(jax.jit(pre_hash), qd)

    def pre_rest(ks):
        ks = codec.canonical_jnp(ks.astype(jnp.uint64), dm.k)
        return dm._check_rest(ks).sum()

    stages["canon+rest_only"] = timeit(jax.jit(pre_rest), qd)

    def pre_bf(ks):
        ks = codec.canonical_jnp(ks.astype(jnp.uint64), dm.k)
        h_k, h_m = dm._hash_state(ks)
        return (dm._check_back(ks, h_m).sum()
                + dm._check_all_bf(ks, h_k, h_m).sum())

    stages["+hash+back+bf"] = timeit(jax.jit(pre_bf), qd)

    def pre_fb(ks):
        ks = codec.canonical_jnp(ks.astype(jnp.uint64), dm.k)
        h_k, h_m = dm._hash_state(ks)
        return dm._find_bitarray(ks, h_k).sum()

    stages["+hash+find_bitarray"] = timeit(jax.jit(pre_fb), qd)

    def full(ks):
        return dm._main(ks)[0]

    stages["full_main"] = timeit(full, qd)

    def full_ungated(ks):
        return dm._main_full(ks)[0]

    stages["full_main_ungated"] = timeit(full_ungated, qd)

    for name, t in stages.items():
        print(f"{name:>22s}: {t*1e3:7.2f} ms  "
              f"({nq / t / 1e6:5.2f} Mq/s)", flush=True)
    th = stages["+hash_state"]
    print(f"\nderived: hash_state alone ~{(th - stages['canonical'])*1e3:.2f} ms; "
          f"bf-stage ~{(stages['+hash+back+bf'] - th)*1e3:.2f} ms; "
          f"find_bitarray ~{(stages['+hash+find_bitarray'] - th)*1e3:.2f} ms; "
          f"rest ~{(stages['canon+rest_only'] - stages['canonical'])*1e3:.2f} ms",
          flush=True)


if __name__ == "__main__":
    main()
