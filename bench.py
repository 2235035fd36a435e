"""Benchmark harness: PEAQ throughput of the four cells on one GPU.

Usage: python bench.py [--batch N] [--seconds S] [--repeats R]
       python bench.py --cpu-dry-run      (tiny sizes, labelled platform cpu)

Cells: basic and advanced PEAQ, each in the `accurate` (default) and the
`float32` tier, on `batch` synthetic stereo pairs of `seconds` each.  One
JSON record per cell goes to stdout, naming the device (platform, kind,
count, power limit), the rate in audio-seconds per second with its
min/max over repeats, the first call's compile time (set-up, not in the
rate) and the device's peak_bytes_in_use.

Without a GPU the harness exits non-zero; a CPU run has to be asked for
(--cpu-dry-run), and its records carry platform "cpu" and a metric name
that says so.  A failing cell fails the run.

`vs_baseline` divides by 6400 audio-s/s, the BASELINE.json north star
(>=100x realtime per pair at batch 64).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# (mode, advanced, dtype, microbatch)
CELLS = (
    ("basic", False, "accurate", 64),
    ("basic", False, "float32", 64),
    ("advanced", True, "accurate", 32),
    ("advanced", True, "float32", 32),
)


def make_pairs(batch: int, seconds: float, channels: int = 2,
               seed: int = 0) -> tuple[list, list]:
    rng = np.random.default_rng(seed)
    n = int(seconds * 48000)
    t = np.arange(n, dtype=np.float64) / 48000.0
    # only 11 distinct harmonic stacks exist (f0 cycles i % 11): build
    # each base once
    bases = {}
    for m in range(min(batch, 11)):
        f0 = 180.0 + 37.0 * m
        ref = np.zeros(n)
        test = np.zeros(n)
        k = 1
        while k * f0 < 15000.0:
            tone = np.sin(2 * np.pi * k * f0 * t + 0.3 * k) / k
            ref += tone
            if k * f0 < 10000.0:  # codec-like lowpass on the test signal
                test += tone
            k += 1
        bases[m] = (0.5 * ref, 0.5 * test)
    refs, tests = [], []
    for i in range(batch):
        ref, test = bases[i % 11]
        test = test + 1e-4 * rng.standard_normal(n)
        # channel-major storage returned as [T, C] transposed VIEWS: the
        # batch padder's channel-major writes then hit the contiguous
        # memcpy path instead of the 2-column strided one
        refs.append(np.stack([ref] * channels, 0).astype(np.float32).T)
        tests.append(np.stack([test] * channels, 0).astype(np.float32).T)
    return refs, tests


def bench(advanced: bool, batch: int, seconds: float, dtype: str,
          iters: int = 2, microbatch: int = 32,
          repeats: int = 3) -> dict:
    """Steady-state throughput: `iters` passes over the batch are
    dispatched back to back and synchronized once at the end (as a sweep
    runs).  Returns {"rates": one audio-s/s rate per repeat,
    "compile_s": first call minus one steady call, i.e. the compile}."""
    import jax
    from gstpeaq_jax import constants as C
    from gstpeaq_jax.parallel import batch as B

    refs, tests = make_pairs(batch, seconds)
    buckets = B.compute_buckets(refs, tests, advanced)
    arrays = B.prepare_chunk(refs, tests, buckets)
    mb = min(microbatch, batch)
    # advanced sig_pair is pair-outermost [2, B, ...]: batch axis is dim 1
    sl = lambda a, s: (a[:, s:s + mb] if advanced and a.ndim >= 4
                       else a[s:s + mb])
    chunks = [[jax.device_put(sl(a, s)) for a in arrays]
              for s in range(0, batch, mb)]
    if advanced:
        fn = B._jitted_advanced_batch(92.0, C.DEFAULT_SETTINGS, dtype,
                                      buckets[0], buckets[1])
    else:
        fn = B._jitted_basic_batch(92.0, C.DEFAULT_SETTINGS, dtype)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*chunks[0]))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*chunks[0]))
    steady = time.perf_counter() - t0
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        outs = [fn(*ch) for _ in range(iters) for ch in chunks]
        jax.block_until_ready(outs)
        rates.append(iters * batch * seconds / (time.perf_counter() - t0))
    return {"rates": rates, "compile_s": first - steady}


def spread_fields(rates: list[float]) -> dict:
    """median with min/max across repeats, so that noise is told apart
    from a real regression."""
    rs = sorted(rates)
    med = rs[len(rs) // 2] if len(rs) % 2 else 0.5 * (
        rs[len(rs) // 2 - 1] + rs[len(rs) // 2])
    return {"value": round(med, 1),
            "spread": [round(rs[0], 1), round(rs[-1], 1)],
            "n_repeats": len(rs)}


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_fields() -> dict:
    import jax
    dev = jax.devices()[0]
    smi = gpu_name_and_power_limit()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "power_limit": smi.split(",")[-1].strip() if smi else None}


def peak_bytes_in_use() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def cell_record(mode: str, dtype: str, batch: int, seconds: float,
                result: dict, device: dict, peak: int | None) -> dict:
    """One cell's JSON record.  A CPU run's metric says so in its name:
    no CPU number is written under the device metric's name."""
    sp = spread_fields(result["rates"])
    what = f"{mode} PEAQ, {dtype} tier, batch {batch} x {seconds:g} s"
    metric = (f"audio-seconds/sec/gpu ({what})" if device["platform"]
              == "gpu" else f"audio-seconds/sec on {device['platform']} "
              f"(dry run, not a device metric; {what})")
    return {"metric": metric, "unit": "audio-sec/s",
            "vs_baseline": round(sp["value"] / 6400.0, 3), **sp,
            "compile_s": round(result["compile_s"], 2),
            "peak_bytes_in_use": peak, **device}


def run_cells(batch: int, seconds: float, repeats: int = 3,
              iters: int = 2) -> list[dict]:
    device = device_fields()
    records = []
    for mode, advanced, dtype, mb in CELLS:
        res = bench(advanced=advanced, batch=batch, seconds=seconds,
                    dtype=dtype, iters=iters, microbatch=mb,
                    repeats=repeats)
        rec = cell_record(mode, dtype, batch, seconds, res, device,
                          peak_bytes_in_use())
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu-dry-run", action="store_true",
                    help="run on the CPU at 4 pairs x 2 s; the records say "
                    "platform cpu")
    args = ap.parse_args(argv)
    import jax
    if args.cpu_dry_run:
        jax.config.update("jax_platforms", "cpu")
        args.batch, args.seconds = 4, 2.0
    from gstpeaq_jax import api
    api.enable_compile_cache()
    platform = jax.devices()[0].platform
    if platform != "gpu" and not args.cpu_dry_run:
        print(f"bench.py: no GPU (JAX platform {platform!r}); "
              f"use --cpu-dry-run for a labelled CPU run", file=sys.stderr)
        return 2
    run_cells(args.batch, args.seconds, args.repeats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
