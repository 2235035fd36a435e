"""A/B the advanced microbatch size on the device.

Each microbatch size is warmed (compiled) once, then timed in interleaved
rounds (A, B, C, A, B, C, ...) so that drift over the run spreads evenly
across the configurations.

Usage: python tools/mb_ab.py [--mbs 16,32,64] [--rounds 3]
                             [--dtype accurate|float32]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mbs", default="16,32,64")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--dtype", default="accurate")
    args = parser.parse_args()
    mbs = [int(x) for x in args.mbs.split(",")]

    import bench
    from gstpeaq_jax import api
    api.enable_compile_cache()

    results = {mb: [] for mb in mbs}
    for mb in mbs:
        t0 = time.time()
        bench.bench(advanced=True, batch=64, seconds=10.0, dtype=args.dtype,
                    iters=1, microbatch=mb, repeats=1)
        print(f"# warm mb{mb}: {time.time() - t0:.0f}s", flush=True)
    for rnd in range(args.rounds):
        for mb in mbs:
            rates = bench.bench(advanced=True, batch=64, seconds=10.0,
                                dtype=args.dtype, iters=args.iters,
                                microbatch=mb, repeats=2)["rates"]
            results[mb].extend(rates)
            print(f"# round {rnd} mb{mb}: "
                  + " ".join(f"{r:.0f}" for r in rates), flush=True)
    for mb in mbs:
        rs = sorted(results[mb])
        print(f"mb{mb}: median {rs[len(rs) // 2]:.0f} min {rs[0]:.0f} "
              f"max {rs[-1]:.0f} a-s/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
