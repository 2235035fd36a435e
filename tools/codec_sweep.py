"""Codec-eval sweep: batched ODG for thousands of ref/test pairs.

The BASELINE "Codec-eval sweep" configuration: evaluate a grid of coded
variants against references, on the default device
(pure data parallelism over the pair axis — see parallel/shard.py).

Usage:
  python tools/codec_sweep.py MANIFEST.tsv [--advanced] [--out results.tsv]

MANIFEST.tsv: one pair per line, "ref_path<TAB>test_path".
With --demo N, generates N synthetic codec-like pairs instead (for
benchmarking without data).
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def load_manifest(path):
    pairs = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ref, test = line.split("\t")[:2]
            pairs.append((ref, test))
    return pairs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("manifest", nargs="?")
    parser.add_argument("--advanced", action="store_true")
    parser.add_argument("--precision", default=None)
    parser.add_argument("--demo", type=int, default=0,
                        help="run N synthetic pairs instead of a manifest")
    parser.add_argument("--out", default=None)
    parser.add_argument("--microbatch", type=int, default=32)
    parser.add_argument("--pcm16", action="store_true",
                        help="ship inputs as raw int16 PCM and dequantize "
                        "on device (framing.dequantize): halves "
                        "host->device transfer bytes; exact for "
                        "PCM16-sourced audio")
    parser.add_argument("--prefetch-gb", type=float, default=6.0,
                        help="stage all input chunks on device before the "
                        "first dispatch when they fit this budget")
    args = parser.parse_args()

    from gstpeaq_jax import api
    api.enable_compile_cache()

    from gstpeaq_jax.parallel import batch as B
    from gstpeaq_jax.utils import native

    if args.demo:
        import bench as BE
        names = [f"demo{i}" for i in range(args.demo)]
        refs, tests = BE.make_pairs(args.demo, 10.0)
    else:
        if not args.manifest:
            parser.error("need MANIFEST or --demo N")
        pairs = load_manifest(args.manifest)
        names = [t for _, t in pairs]
        load = (native.load_audio_48k_ship if args.pcm16
                else native.load_audio_48k)
        refs = [load(r) for r, _ in pairs]
        tests = [load(t) for _, t in pairs]

    if args.pcm16:
        # float-sourced pairs (demo / non-PCM16 files) quantize here;
        # raw PCM16 loads are already int16 and pass through untouched
        q = lambda x: x if x.dtype == np.int16 else np.clip(
            np.round(np.asarray(x, np.float64) * 32768.0),
            -32768, 32767).astype(np.int16)
        refs = [q(r) for r in refs]
        tests = [q(t) for t in tests]

    t0 = time.time()
    phases = {}
    out = B.peaq_batch(refs, tests, advanced=args.advanced,
                       dtype=args.precision, microbatch=args.microbatch,
                       prefetch_gb=args.prefetch_gb, timings=phases)
    dt = time.time() - t0
    audio = sum(r.shape[0] for r in refs) / 48000.0
    import resource
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"# {len(refs)} pairs, {audio:.0f} audio-sec in {dt:.1f}s "
          f"({audio/dt:.0f} audio-sec/s), peak host RSS {peak_gb:.1f} GB",
          file=sys.stderr)
    # attribute the wall time: first_sync holds the one-time program
    # load of the process; stage+dispatch+drain is the repeatable cost
    steady = audio / max(dt - phases.get("first_sync", 0.0), 1e-9)
    print("# phases: "
          + " ".join(f"{k} {v:.1f}s" for k, v in phases.items())
          + f"; excl. one-time program-load stall: {steady:.0f} "
          "audio-sec/s", file=sys.stderr)

    lines = [f"{n}\t{o:.4f}\t{d:.4f}"
             for n, o, d in zip(names, out["odg"], out["di"])]
    text = "item\todg\tdi\n" + "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
