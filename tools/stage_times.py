"""Device time of single pipeline stages at the bench cells' shapes, and the
FB spreading kernel against its XLA form end to end.

Usage: python tools/stage_times.py [--trace-dir DIR] [--no-ab] [--no-stages]

Stages (each jitted alone, inputs on the device, shapes of one microbatch
of the bench cells: basic 64 pairs, advanced 32 pairs, stereo, 10 s):

  fb_spread        fb_ear.spread_t, Triton kernel and XLA exp form
  fft_spread       fft_ear.spread (basic 109 bands, advanced 55)
  mod_smoothers    level_adapt.level_adapt_fused_mod (basic, advanced FB)
  fwd_masking      the FB forward-masking banded recurrence

Each stage prints its host-clock time per call (median of 10 calls, each
ended by block_until_ready) and its device time per call from one
profiler trace of 10 calls: the union of the kernel intervals on the
device's stream lines, divided by the call count.

Unless --no-ab, the advanced bench cells (accurate, float32) then run with
the spreading kernel and with the XLA form, in the order kernel, XLA, XLA,
kernel, and print each rate.
"""

import argparse
import glob
import os
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def device_ms_from_trace(logdir: str, n_calls: int) -> tuple[float, str]:
    """Busy time of the first GPU per call, from the newest xplane under
    `logdir`: the union of the event intervals on its stream lines."""
    from jax.profiler import ProfileData
    path = max(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    assert planes, [p.name for p in pd.planes]
    lines = list(planes[0].lines)
    chosen = [ln for ln in lines if ln.name.startswith("Stream")] or lines
    spans = sorted((ev.start_ns, ev.end_ns)
                   for ln in chosen for ev in ln.events)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6 / n_calls, ",".join(sorted({ln.name for ln in chosen}))


def time_stage(name: str, fn, args, trace_dir: str, n: int = 10) -> None:
    import jax
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    jax.block_until_ready(jfn(*args))
    compile_s = time.perf_counter() - t0
    host = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(*args))
        host.append((time.perf_counter() - t0) * 1e3)
    logdir = tempfile.mkdtemp(prefix=name, dir=trace_dir)
    with jax.profiler.trace(logdir):
        outs = [jfn(*args) for _ in range(n)]
        jax.block_until_ready(outs)
    dev_ms, basis = device_ms_from_trace(logdir, n)
    print(f"{name}: host {np.median(host):.3f} ms/call (min "
          f"{min(host):.3f}, max {max(host):.3f}), device {dev_ms:.3f} "
          f"ms/call [{basis}], first call {compile_s:.1f} s", flush=True)


def stages(trace_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from gstpeaq_jax import earparams as EP
    from gstpeaq_jax.models import level_adapt as LA
    from gstpeaq_jax.ops import fb_ear as FB
    from gstpeaq_jax.ops import fft_ear as FE
    from gstpeaq_jax.ops import iir
    rng = np.random.default_rng(0)
    put = lambda shape, lo, hi: jax.device_put(
        rng.uniform(lo, hi, shape).astype(np.float32))
    # advanced microbatch 32, 2 signals x 2 channels, 10 s: FB bucket
    # 2688 frames = 16128 instants; FFT bucket 512 frames
    kb = FB.build_consts(EP.fb_ear_params(), dtype=jnp.float32)
    fb_re, fb_im = put((2, 32, 2, 40, 16128), -0.1, 0.1), \
        put((2, 32, 2, 40, 16128), -0.1, 0.1)
    for kernel in (True, False):
        time_stage(f"fb_spread_{'kernel' if kernel else 'xla'}",
                   lambda r, i, kernel=kernel: FB.spread_t(
                       kb, r, i, kernel=kernel), (fb_re, fb_im), trace_dir)
    for bands, shape in ((109, (2, 64, 2, 512, 109)), (55, (32, 2, 512, 55))):
        k = FE.build_consts(EP.fft_ear_params(bands), dtype=jnp.float32)
        time_stage(f"fft_spread_{bands}", lambda p, k=k: FE.spread(k, p),
                   (put(shape, 1e-6, 1e4),), trace_dir)
    for name, a, shape, step in (
            ("mod_smoothers_basic", FE.build_consts(
                EP.fft_ear_params(109), dtype=jnp.float32).adapt_a,
             (2, 64, 2, 109, 512), 1024),
            ("mod_smoothers_advanced_fb", kb.adapt_a,
             (2, 32, 2, 40, 2688), 192)):
        z = shape[-2]
        avg = jnp.asarray(LA.sliding_average_matrix(z), jnp.float32)
        time_stage(name, lambda e, u, a=a, avg=avg, step=step:
                   LA.level_adapt_fused_mod(a, avg, e, u, step),
                   (put(shape, 0.01, 10.0), put(shape, 0.01, 10.0)),
                   trace_dir)
    time_stage("fwd_masking_fb", lambda b: iir.linear_recurrence_banded(
        kb.ear_a, b, axis=-1), (put((2, 32, 2, 40, 2688), 0.0, 1.0),),
        trace_dir)


def ab_end_to_end() -> None:
    import bench
    from gstpeaq_jax.ops import fb_ear as FB
    from gstpeaq_jax.parallel import batch as B
    choose = FB.use_spread_kernel
    for dtype in ("accurate", "float32"):
        for label in ("kernel", "xla", "xla", "kernel"):
            FB.use_spread_kernel = (choose if label == "kernel"
                                    else lambda *a, **k: False)
            B._jitted_advanced_batch.cache_clear()
            res = bench.bench(advanced=True, batch=64, seconds=10.0,
                              dtype=dtype, iters=2, microbatch=32,
                              repeats=3)
            sp = bench.spread_fields(res["rates"])
            print(f"advanced {dtype} {label}: {sp['value']} audio-s/s "
                  f"(min/max {sp['spread'][0]}/{sp['spread'][1]})",
                  flush=True)
    FB.use_spread_kernel = choose
    B._jitted_advanced_batch.cache_clear()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--no-ab", action="store_true")
    ap.add_argument("--no-stages", action="store_true")
    args = ap.parse_args()
    import jax
    import bench
    from gstpeaq_jax import api
    api.enable_compile_cache()
    dev = jax.devices()[0]
    assert dev.platform == "gpu", f"needs a GPU, JAX found {dev.platform}"
    print(f"device: {dev.device_kind}; nvidia-smi: "
          f"{bench.gpu_name_and_power_limit()}", flush=True)
    if not args.no_stages:
        trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="stage_times")
        os.makedirs(trace_dir, exist_ok=True)
        stages(trace_dir)
    if not args.no_ab:
        ab_end_to_end()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
