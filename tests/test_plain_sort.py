"""The counting engine's plain-XLA sort, merge and compaction paths vs
brute force: extract.sorted_u64 / sorted_u64_with_payload, the LSM run
merge, the segment-count compaction, the low-key drop compaction, and the
single-tier finalize (fused and segmented) of DeviceCountAccumulator."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmcex.count import device_lsm, extract
from kmcex.count.device_lsm import (
    DeviceCountAccumulator,
    _drop_below,
    _merge_runs_kernel,
    _row_count,
)

S = np.uint64(0xFFFFFFFFFFFFFFFF)


# -- sorts -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 1 << 10, 3000, (1 << 12) - 7])
def test_sorted_u64(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    out = np.asarray(extract.sorted_u64(jnp.asarray(x)))
    assert len(out) == n and np.array_equal(out, np.sort(x))


def test_sorted_u64_sentinel_keys_sort_last():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 63, 2000, dtype=np.uint64)
    x[::5] = S  # masked windows
    out = np.asarray(extract.sorted_u64(jnp.asarray(x)))
    assert np.array_equal(out, np.sort(x))
    assert (out[-400:] == S).all()


@pytest.mark.parametrize("n", [1000, 5000])
def test_sorted_u64_with_payload(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    p = np.arange(n, dtype=np.uint32)
    k, pay = extract.sorted_u64_with_payload(jnp.asarray(x), jnp.asarray(p))
    k, pay = np.asarray(k), np.asarray(pay)
    assert np.array_equal(k, np.sort(x))
    assert np.array_equal(x[pay], k)  # payload followed its key


def _want_merge(a, ca, b, cb):
    acc = collections.Counter()
    for key, c in zip(np.concatenate([a, b]).tolist(),
                      np.concatenate([ca, cb]).tolist()):
        if key != int(S):
            acc[key] += c
    keys = np.array(sorted(acc), dtype=np.uint64)
    return keys, np.array([acc[x] for x in keys.tolist()], dtype=np.uint32)


def _check_merge(a, ca, b, cb):
    u, c, n = _merge_runs_kernel(jnp.asarray(a), jnp.asarray(ca),
                                 jnp.asarray(b), jnp.asarray(cb))
    u, c, n = np.asarray(u), np.asarray(c), int(n)
    wk, wc = _want_merge(a, ca, b, cb)
    assert len(u) == len(a) + len(b)
    assert n == len(wk)
    np.testing.assert_array_equal(u[:n], wk)
    np.testing.assert_array_equal(c[:n], wc)
    assert (u[n:] == S).all() and (c[n:] == 0).all()


@pytest.mark.parametrize("la,lb", [(1000, 500), (1 << 10, 1 << 10),
                                   (3000, 1700), (1, 1)])
def test_merge_runs(la, lb):
    """LSM runs are sorted and unique; keys shared between the two runs
    must come out once with their counts summed."""
    rng = np.random.default_rng(la * 31 + lb)
    space = 2 * (la + lb)
    a = np.sort(rng.choice(space, la, replace=False)).astype(np.uint64)
    b = np.sort(rng.choice(space, lb, replace=False)).astype(np.uint64)
    ca = rng.integers(1, 1000, la, dtype=np.uint32)
    cb = rng.integers(1, 1000, lb, dtype=np.uint32)
    _check_merge(a, ca, b, cb)


def test_merge_sentinel_padded_runs():
    # LSM runs are SENTINEL-padded; merging two of them must keep all real
    # keys ahead of every sentinel.
    rng = np.random.default_rng(3)
    a = np.sort(rng.choice(1 << 40, 900, replace=False)).astype(np.uint64)
    b = np.sort(rng.choice(1 << 40, 700, replace=False)).astype(np.uint64)
    ap = np.concatenate([a, np.full(124, S)])
    bp = np.concatenate([b, np.full(300, S)])
    ca = np.concatenate([np.ones(900, np.uint32), np.zeros(124, np.uint32)])
    cb = np.concatenate([np.ones(700, np.uint32), np.zeros(300, np.uint32)])
    _check_merge(ap, ca, bp, cb)


# -- compaction --------------------------------------------------------------
# Both compactions move survivors to the front in order and fill the tail
# with (SENTINEL, 0).  segment_compact's holes are duplicate and masked
# slots of a sorted window array; the low drop's holes are table entries
# below the count threshold.

_segment_compact = jax.jit(extract.segment_compact)


def _check_segment_compact(s):
    """``s``: sorted windows, SENTINEL (masked) slots last."""
    u, c, n = _segment_compact(jnp.asarray(s))
    u, c, n = np.asarray(u), np.asarray(c), int(n)
    wk, wc = np.unique(s[s != S], return_counts=True)
    assert n == len(wk)
    np.testing.assert_array_equal(u[:n], wk)
    np.testing.assert_array_equal(c[:n], wc.astype(np.uint32))
    assert (u[n:] == S).all() and (c[n:] == 0).all()


def _check_drop(keys, counts):
    """``keys`` ascending and distinct with holes anywhere (count 0)."""
    n = len(keys)
    u, c, st = _drop_below(jnp.asarray(keys), jnp.asarray(counts),
                           jnp.uint32(1), _row_count(n))
    u, c, st = np.asarray(u), np.asarray(c), np.asarray(st)
    live = counts >= 1
    m = int(live.sum())
    np.testing.assert_array_equal(u[:m], keys[live])
    np.testing.assert_array_equal(c[:m], counts[live])
    assert (u[m:] == S).all() and (c[m:] == 0).all()
    assert int(st[0]) == m and int(st[4]) == m  # total >= 1, n_real


def _holed(kind, n, holes, rng):
    """One input of ``n`` slots with the given hole mask, for either
    compaction: distinct ascending keys (with per-key repeats standing in
    for the duplicate slots of a window array)."""
    keys = np.sort(rng.choice(1 << 62, size=n, replace=False)).astype(np.uint64)
    if kind == "segment":
        reps = rng.integers(1, 4, n)
        s = np.repeat(keys, reps)[:n]
        s[holes] = S
        return (np.sort(s),)
    counts = rng.integers(1, 1 << 31, n).astype(np.uint32)
    keys[holes] = S
    counts[holes] = 0
    return keys, counts


_CHECK = {"segment": _check_segment_compact, "drop": _check_drop}


@pytest.mark.parametrize("kind", ["segment", "drop"])
@pytest.mark.parametrize("n,frac,seed", [
    (1 << 10, 0.5, 0), (1 << 12, 0.1, 1), (1 << 12, 0.9, 2),
    (3000, 0.3, 3), ((1 << 12) - 7, 0.5, 4), (1000, 0.0, 5), (2048, 1.0, 6),
])
def test_compact_random(kind, n, frac, seed):
    rng = np.random.default_rng(seed)
    holes = rng.random(n) < frac
    _CHECK[kind](*_holed(kind, n, holes, rng))


@pytest.mark.parametrize("kind", ["segment", "drop"])
def test_compact_sorted_with_dup_holes(kind):
    """The pipeline shape: ascending keys whose duplicate slots are holes."""
    rng = np.random.default_rng(42)
    base = np.sort(rng.integers(0, 1 << 62, 4096, dtype=np.uint64))
    s = np.repeat(base, rng.integers(1, 5, 4096))[: 1 << 12]
    if kind == "segment":
        _check_segment_compact(s)
        return
    first = np.concatenate([[True], s[1:] != s[:-1]])
    keys = np.where(first, s, S)
    counts = np.where(first, rng.integers(1, 100, len(s)), 0).astype(np.uint32)
    _check_drop(keys, counts)


@pytest.mark.parametrize("kind", ["segment", "drop"])
def test_compact_hole_runs(kind):
    """Whole halves of holes: maximal and zero survivor displacement."""
    n = 1 << 12
    rng = np.random.default_rng(7)
    for half in (slice(0, n // 2), slice(n // 2, n)):
        holes = np.zeros(n, bool)
        holes[half] = True
        _CHECK[kind](*_holed(kind, n, holes, rng))


@pytest.mark.parametrize("kind", ["segment", "drop"])
def test_compact_exhaustive_tiny(kind):
    """Hole patterns over 12 slots spread across a 512-slot array (with a
    long hole run on every third pattern): every survivor must land in
    order, whatever the pattern."""
    n = 512
    rng = np.random.default_rng(11)
    for pat in range(0, 1 << 12, 7):
        holes = np.zeros(n, bool)
        for b in range(12):
            if (pat >> b) & 1:
                holes[b * 21 % n] = True
        if pat % 3 == 0:
            holes[200:300] = True
        _CHECK[kind](*_holed(kind, n, holes, rng))


# -- finalize ----------------------------------------------------------------

def _batches(rng, sizes, k, n_frac):
    out = []
    for rows, L in sizes:
        codes = rng.integers(0, 4, size=(rows, L)).astype(np.uint8)
        codes[rng.random(codes.shape) < n_frac] = 255
        f = np.asarray(extract.extract_canonical(jnp.asarray(codes), k)[0])
        out.append((codes, f[f != S]))
    return out


@pytest.mark.parametrize("segmented", [False, True])
def test_segmented_finalize(monkeypatch, segmented):
    """Single-tier finalize_stream — the fused program, or the segmented
    per-key-range compaction — vs brute force, stats included."""
    monkeypatch.setattr(device_lsm, "_SEGMENTED_FINALIZE", segmented)
    rng = np.random.default_rng(77)
    k = 13
    acc = DeviceCountAccumulator(k)
    acc.SEGMENT_UNIT = 1 << 10
    data = _batches(rng, [(64, 48)] * 3, k, 0.02)
    for codes, _ in data:
        acc.add_batch(codes)
    total, hist, chunks = acc.finalize_stream(ci=1, cs=1023)
    parts = list(chunks)
    got_k = np.concatenate([p[0] for p in parts])
    got_c = np.concatenate([p[1] for p in parts])
    want_k, want_c = np.unique(np.concatenate([f for _, f in data]),
                               return_counts=True)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c.astype(np.uint32))
    assert total == len(want_k)
    for i in range(3):
        assert hist[i] == int(np.count_nonzero(want_c == 1 + i))


def test_raw_tier_collapses_and_merges():
    """A forced-small raw tier (4096 windows) collapses mid-stream and
    merges the collapsed runs pairwise in the device LSM; the result, and
    the streamed finalize of a second accumulator, equal brute force."""
    rng = np.random.default_rng(99)
    k = 13
    sizes = [(64, 48), (192, 48), (32, 48), (96, 48), (64, 48)] * 2
    data = _batches(rng, sizes, k, 0.03)
    want_k, want_c = np.unique(np.concatenate([f for _, f in data]),
                               return_counts=True)
    acc = DeviceCountAccumulator(k, raw_tier_elems=4096)
    for codes, _ in data:
        acc.add_batch(codes)
    got_k, got_c = acc.finalize(ci=1, cs=1023)
    assert acc.tier_events["raw_collapses"] >= 4
    assert acc.tier_events["device_merges"] >= 1
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c.astype(np.uint32))

    acc2 = DeviceCountAccumulator(k, raw_tier_elems=4096)
    for codes, _ in data:
        acc2.add_batch(codes)
    total, _, chunks = acc2.finalize_stream(ci=1, cs=1023)
    assert np.array_equal(np.concatenate([x[0] for x in chunks]), want_k)
    assert total == len(want_k)
