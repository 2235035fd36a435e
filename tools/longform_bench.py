"""Long-form streaming benchmark: hour-scale program, O(1) memory.

The BASELINE "Long-form streaming" configuration: a long stereo program
processed through PeaqStream in chunks with carried device state.
With --streams N > 1 the same program length runs as N concurrent
lockstep streams through PeaqStreamPool (one vmapped chunk program) —
the production serving shape; reported throughput is aggregate.

  python tools/longform_bench.py [--minutes 60] [--advanced]
                                 [--chunk 1024] [--streams N]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def device_source_bench(pool, args, ref_b, test_b, total) -> int:
    """Carried-state device streaming rate: stage ONE chunk pair per
    path (fft / fb) on device, then advance the pool's vmapped chunk
    steps back to back with the state pytree carried on device.  The
    repeated chunk makes the running ODG meaningless as a quality
    number but exercises exactly the production program sequence."""
    import jax

    from gstpeaq_jax import constants as C
    from gstpeaq_jax.parallel.stream import PeaqStreamPool

    assert isinstance(pool, PeaqStreamPool), "--device-source needs --streams>1"
    ns = args.streams
    rng = np.random.default_rng(1)

    def chunk(n_samp):
        reps = -(-n_samp // ref_b.shape[0])
        r1 = np.tile(ref_b, reps)[:n_samp]
        t1 = (np.tile(test_b, reps)[:n_samp]
              + (1e-4 * rng.standard_normal(n_samp)).astype(np.float32))
        r = np.broadcast_to(r1, (ns, 2, n_samp))      # [N, CH, T]
        t = np.broadcast_to(t1, (ns, 2, n_samp))
        if args.pcm16:
            q = lambda x: np.clip(np.round(x.astype(np.float64) * 32768.0),
                                  -32768, 32767).astype(np.int16)
            r, t = q(r), q(t)
        return jax.device_put(np.ascontiguousarray(r)), \
            jax.device_put(np.ascontiguousarray(t))

    fft_stride = args.chunk * C.FFT_STEPSIZE
    fft_op = (pool._steps[0], chunk(fft_stride + C.FFT_STEPSIZE))
    ops = [fft_op]
    if args.advanced:
        # the fb path consumes 3x the fft stride per step (192*16 vs
        # 1024 samples per "chunk frame"): 3 fft steps per fb step keeps
        # both paths at the same audio clock, as the real drain does
        assert pool._fb_samples == 3 * fft_stride
        ops = [fft_op, fft_op, fft_op,
               (pool._steps[1], chunk(pool._fb_samples))]
    state = pool.state
    # warm the programs (compile + first execution) outside the clock
    for step, (r, t) in ops:
        state = step(state, r, t)
    np.asarray(jax.tree.leaves(state)[0])
    stride = fft_stride * (3 if args.advanced else 1)
    t0 = time.time()
    done = 0
    while done < total:
        for step, (r, t) in ops:
            state = step(state, r, t)
        done += stride
    np.asarray(jax.tree.leaves(state)[0])  # host sync
    dt = time.time() - t0
    agg = ns * done / 48000
    print(f"device-source: {agg:.0f} audio-sec in {dt:.1f}s "
          f"({agg/dt:.0f} audio-sec/s aggregate, {ns} streams, "
          f"carried state, transfers excluded)")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--minutes", type=float, default=60.0)
    parser.add_argument("--advanced", action="store_true")
    parser.add_argument("--chunk", type=int, default=1024,
                        help="chunk size in FFT frames (bigger chunks = "
                        "fewer dispatches)")
    parser.add_argument("--streams", type=int, default=1,
                        help="concurrent lockstep streams (PeaqStreamPool)")
    parser.add_argument("--pcm16", action="store_true",
                        help="feed int16 PCM (dequantized on device): "
                        "halves the per-chunk transfer")
    parser.add_argument("--device-source", action="store_true",
                        help="stage ONE chunk pair on device and drive "
                        "the chunk steps directly: measures the carried-"
                        "state DEVICE streaming rate with host->device "
                        "transfers excluded")
    parser.add_argument("--precision", default=None)
    args = parser.parse_args()

    from gstpeaq_jax import api
    api.enable_compile_cache()

    from gstpeaq_jax.parallel.stream import (PeaqStream, PeaqStreamAdvanced,
                                             PeaqStreamPool)

    ns = args.streams
    if ns > 1:
        stream = PeaqStreamPool(ns, channels=2, chunk_frames=args.chunk,
                                dtype=args.precision, advanced=args.advanced)
    else:
        cls = PeaqStreamAdvanced if args.advanced else PeaqStream
        stream = cls(channels=2, chunk_frames=args.chunk,
                     dtype=args.precision)

    total = int(args.minutes * 60 * 48000)
    feed = 48000 * 10  # 10 s host chunks
    rng = np.random.default_rng(0)

    # Synthesize the program ONCE (a 30 s base that tiles with continuous
    # phase: f0 = 331 Hz and the 4 Hz AM both complete integer cycles in
    # 30 s), then feed slices of it: synthesizing per feed (~45 numpy
    # sine passes over 480k samples) would benchmark numpy, not the
    # streaming pipeline.  Harmonic-rich to ~15 kHz: the
    # BandwidthRef MOV only accumulates frames whose reference bandwidth
    # exceeds bin 346 (~8.1 kHz, src/movs.c:775-809); a band-limited tone
    # over a noise floor never qualifies and the ODG is NaN (faithful to
    # the reference's 0/0).
    base_n = 48000 * 30
    tt = np.arange(base_n) / 48000.0
    f0 = 331.0
    ref_b = np.zeros(base_n)
    test_b = np.zeros(base_n)
    k = 1
    while k * f0 < 15000.0:
        tone = np.sin(2 * np.pi * k * f0 * tt + 0.3 * k) / k
        ref_b += tone
        if k * f0 < 10000.0:   # codec-like lowpass on the test signal
            test_b += tone
        k += 1
    am = 1.0 + 0.3 * np.sin(2 * np.pi * 4.0 * tt)
    ref_b = (0.5 * ref_b * am).astype(np.float32)
    test_b = (0.485 * test_b * am).astype(np.float32)

    if args.device_source:
        return device_source_bench(stream, args, ref_b, test_b, total)

    t0 = time.time()
    done = 0
    while done < total:
        n = min(feed, total - done)
        off = done % base_n          # feed divides base_n: no wrap
        ref1 = ref_b[off:off + n]
        test1 = test_b[off:off + n] + (1e-4 * rng.standard_normal(n)
                                       ).astype(np.float32)
        if ns > 1:
            # [N, T, CH]: same program per stream, distinct noise floors
            noise = (1e-4 * rng.standard_normal((ns - 1, n))
                     ).astype(np.float32)
            tests1 = np.concatenate(
                [test1[None], test_b[off:off + n][None] + noise])
            ref = np.broadcast_to(ref1[None, :, None], (ns, n, 2))
            test = np.repeat(tests1[:, :, None], 2, axis=2)
        else:
            ref = np.stack([ref1, ref1], 1)
            test = np.stack([test1, test1], 1)
        if args.pcm16:
            q = lambda x: np.clip(np.round(x.astype(np.float64) * 32768.0),
                                  -32768, 32767).astype(np.int16)
            ref, test = q(ref), q(test)
        stream.feed(ref, test)
        done += n
        if done % (feed * 30) == 0:
            cur = stream.current()
            odg = cur.odg if ns == 1 else float(np.median(cur.odg))
            el = time.time() - t0
            print(f"# {done/48000:.0f}s fed, "
                  f"{ns * done/48000/el:.1f}x realtime aggregate, "
                  f"running ODG {odg:.3f}", file=sys.stderr, flush=True)
    res = stream.finalize()
    dt = time.time() - t0
    agg = ns * total / 48000
    print(f"processed {agg:.0f} audio-sec in {dt:.1f}s "
          f"({agg/dt:.1f}x realtime aggregate = {agg/dt:.0f} audio-sec/s, "
          f"{ns} stream{'s' if ns > 1 else ''})")
    if ns > 1:
        print(f"ODG median {np.median(res.odg):.3f} "
              f"min {res.odg.min():.3f} max {res.odg.max():.3f}")
    else:
        print(f"ODG {res.odg:.3f}  DI {res.di:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
