"""Device profile of the counting path: XLA's sorts, scans and scatter.

Measures, on the current accelerator, what XLA makes of the operations the
finalize is built from, and where a warm model-only ``count_encode`` spends
device time:

  * ``extract.sorted_u64`` and ``extract.sorted_u64_with_payload`` at the
    finalize's shapes (26M and 64M u64 keys, without and with a u32
    payload): median time, keys/s, share of a memory-bandwidth floor, and
    the sort implementation in the optimized HLO (a CUB custom call or
    XLA's own sort);
  * the segment-count scans (u64 cumsum, reverse i32 cummin) at 64M;
  * the Bloom-bank scatter (``.at[pos].set(1)`` with duplicate indices);
  * one profiler trace of a warm ``count_encode(keep_pairs=False)`` on the
    realistic input of chip_smoke.py, reduced to device busy share and the
    top kernels.

Run from the repository root: ``python tools/gpu_profile.py [--out DIR]``.
Prints one JSON summary as its last line and writes it to
``DIR/gpu_profile.json`` (default ``chiprun_out``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published peak device-memory bandwidth by device kind (NVIDIA data sheet,
# H100 SXM5: 3.35 TB/s).  A device not in the table is an error.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

SORT_SIZES = (26_000_000, 64_000_000)


def _median_time(fn, *args, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _hlo_sort_impl(jitted, *args) -> list[str]:
    """Sort implementations in the optimized HLO: CUB custom-call targets
    and XLA sort ops."""
    text = jitted.lower(*args).compile().as_text()
    found = set()
    for m in re.finditer(r'custom_call_target="([^"]+)"', text):
        found.add(f"custom-call {m.group(1)}")
    if re.search(r"[\]\)\}] sort\(", text):
        found.add("xla sort")
    return sorted(found)


def radix_floor_bytes(n: int, payload_bytes: int) -> int:
    """Bytes an LSD radix sort of n u64 keys must move: one histogram pass
    reading the keys, then 8 passes of 8-bit digits that each read and
    write every key and payload once."""
    return n * 8 + 8 * n * 2 * (8 + payload_bytes)


def profile_sorts(peak: float) -> list[dict]:
    import jax
    import jax.numpy as jnp

    from kmcex.count.extract import SENTINEL, sorted_u64, sorted_u64_with_payload

    rng = np.random.default_rng(0)
    out = []
    f_keys = jax.jit(sorted_u64)
    f_pair = jax.jit(sorted_u64_with_payload)
    for n in SORT_SIZES:
        x = rng.integers(0, 1 << 62, n, dtype=np.uint64)
        x[rng.random(n) < 0.02] = np.uint64(SENTINEL)
        xd = jax.device_put(x)
        pd = jax.device_put(np.arange(n, dtype=np.uint32))
        for name, fn, args, pb in (
                ("sorted_u64", f_keys, (xd,), 0),
                ("sorted_u64_with_payload", f_pair, (xd, pd), 4)):
            t = _median_time(fn, *args)
            floor_s = radix_floor_bytes(n, pb) / peak
            out.append({"op": name, "n": n, "seconds": t,
                        "keys_per_s": n / t, "floor_seconds": floor_s,
                        "floor_share": floor_s / t,
                        "impl": _hlo_sort_impl(fn, *args)})
            print(json.dumps(out[-1]), flush=True)
        del xd, pd
    return out


def profile_scans_and_scatter() -> dict:
    import jax
    import jax.numpy as jnp

    n = 64_000_000
    rng = np.random.default_rng(1)
    c = jax.device_put(rng.integers(0, 4, n, dtype=np.uint32))
    b = jax.device_put(rng.integers(0, n, n, dtype=np.int32))
    f_sum = jax.jit(lambda v: jnp.cumsum(v, dtype=jnp.uint64))
    f_min = jax.jit(lambda v: jnp.flip(jax.lax.cummin(jnp.flip(v))))
    res = {"n": n,
           "cumsum_u64_seconds": _median_time(f_sum, c),
           "reverse_cummin_i32_seconds": _median_time(f_min, b)}
    # Bloom feed shape: ~95M probe positions into a one-byte-per-bit map
    n_pos = 96_000_000
    cap = 1 << 30
    pos = jax.device_put(rng.integers(0, cap, n_pos, dtype=np.uint64))
    f_sc = jax.jit(lambda bm, p: bm.at[p].set(jnp.uint8(1), mode="drop"),
                   donate_argnums=(0,))
    bm = jnp.zeros(cap, jnp.uint8)
    bm = f_sc(bm, pos)
    jax.block_until_ready(bm)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        bm = f_sc(bm, pos)
        jax.block_until_ready(bm)
        ts.append(time.perf_counter() - t0)
    res["bloom_scatter_positions"] = n_pos
    res["bloom_scatter_seconds"] = statistics.median(ts)
    res["bloom_scatter_positions_per_s"] = n_pos / res["bloom_scatter_seconds"]
    print(json.dumps(res), flush=True)
    return res


def reduce_trace(trace_dir: str, top: int = 15) -> dict:
    """Device busy share and the top kernels of a profiler trace: busy is
    the union of kernel and copy intervals on the GPU's stream lines over
    the window from their first start to last end."""
    import glob

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    result = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        kernels: dict[str, float] = {}
        spans = []
        for line in plane.lines:
            if line.name.startswith("Stream"):
                for ev in line.events:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.duration_ns
                    spans.append((ev.start_ns, ev.end_ns))
        if not spans:
            continue
        spans.sort()
        busy = 0.0
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        result[plane.name] = {
            "lines": {ln.name: len(list(ln.events)) for ln in plane.lines},
            "window_s": window / 1e9, "busy_s": busy / 1e9,
            "idle_share": 1 - busy / window,
            "top_kernels_s": {k[:120]: v / 1e9 for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1])[:top]},
        }
    return result


def profile_pipeline() -> dict:
    import chip_smoke
    from kmcex.count.pipeline import count_encode

    kw = dict(k=31, ci=1, cs=1023, num_hash=7, num_bit=5, keep_pairs=False)
    with tempfile.TemporaryDirectory(prefix="gpu_profile_") as tmp:
        fq = os.path.join(tmp, "reads.fastq")
        chip_smoke.make_input(fq)
        count_encode(fq, **kw)  # compile
        t0 = time.perf_counter()
        _, _, _, stats = count_encode(fq, **kw)
        wall = time.perf_counter() - t0
        trace_dir = os.path.join(tmp, "trace")
        os.environ["KMCEX_TRACE_DIR"] = trace_dir
        try:
            count_encode(fq, **kw)
        finally:
            del os.environ["KMCEX_TRACE_DIR"]
        trace = reduce_trace(trace_dir)
    res = {"reads": stats.reads, "untraced_wall_s": wall,
           "reads_per_s": stats.reads / wall,
           "phases_s": dict(sorted(stats.phases.items(),
                                   key=lambda kv: -kv[1])),
           "trace": trace}
    print(json.dumps(res), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    import subprocess

    import jax

    if jax.default_backend() != "gpu":
        print(f"gpu_profile: backend is {jax.default_backend()!r}, not gpu",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    if dev.device_kind not in PEAK_BYTES_PER_S:
        print(f"gpu_profile: no peak bandwidth for {dev.device_kind!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    summary = {"card": card, "device_kind": dev.device_kind,
               "xla_flags": os.environ.get("XLA_FLAGS", ""),
               "sorts": profile_sorts(PEAK_BYTES_PER_S[dev.device_kind]),
               "scans_scatter": profile_scans_and_scatter(),
               "pipeline": profile_pipeline()}
    summary["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
        "peak_bytes_in_use")
    with open(os.path.join(args.out, "gpu_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
