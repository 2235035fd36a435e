"""Smoke test of the PEAQ main path on the GPU, through the user entry points.

    python chip_smoke.py           one GPU: every phase below
    python chip_smoke.py --four    four GPUs: the sharded sweep, the sharded
                                   stream pool and the sharded training step,
                                   each against its single-device twin

Phases (one GPU), in this order because the float64 tier turns on
jax_enable_x64 for the rest of the process:

  device   JAX must report a GPU; prints its kind, the device count and
           `nvidia-smi --query-gpu=name,power.limit`
  gemm     which precision the float32 tiers' front-end GEMMs get
  bench    the four bench.py cells (basic/advanced x accurate/float32,
           64 pairs x 10 s stereo): rate, compile time, peak memory
  drift    the 20-item drift corpus (stereo, 10 s) through peaq_batch in
           the accurate and float32 tiers (compared after the float64 run)
  stream   PeaqStreamPool(8, advanced=True) over 60 s in chunks against
           peaq_batch on the same pairs
  float64  the drift corpus in the float64 tier; accurate must stay within
           |dODG| <= 1e-3 of it on every item (float32 drift is printed)
  spec     float64 api.peaq: the pinned 0.171 / -2.007 (mono and stereo
           upmix), and basic + advanced against utils/numpy_ref
  cli      cli.main on a WAV pair, in this process

Every check raises on failure, so the script exits non-zero; only when all
phases pass does it print, as its last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

GATE_ACCURATE = 1e-3        # |dODG| of the default tier vs float64
STREAM_TOL = 5e-4           # float32 chunked vs whole (tests/test_stream.py)
SHARD_TOL = 1e-4            # sharded vs single-device, same tier

# sizes: (pairs, seconds) of each phase
BENCH = (64, 10.0)
CORPUS = (20, 10.0)
STREAM = (8, 60.0)
FOUR = (64, 10.0)


def last_line(devices) -> str:
    """The final stdout line, from jax.devices()."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def require_gpu(count: int):
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        sys.exit(2)
    if len(devices) < count:
        print(f"chip_smoke: need {count} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        sys.exit(2)
    return devices


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: passed in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_device(devices) -> None:
    import bench
    smi = bench.gpu_name_and_power_limit()
    assert smi, "nvidia-smi gave no name,power.limit line"
    print(f"device_kind: {devices[0].device_kind}  count: {len(devices)}")
    print(smi, flush=True)


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / np.max(np.abs(want)))


def phase_gemm() -> None:
    """Precision the front-end GEMMs get: each runs once at HIGH (the
    float32 tier) and HIGHEST (the accurate tier), at real operand widths,
    against a float64 product on the host."""
    import jax
    import jax.numpy as jnp
    from gstpeaq_jax import earparams as EP
    from gstpeaq_jax.ops import fb_ear as FB
    from gstpeaq_jax.ops import fft_ear as FE
    fe = FE.build_consts(EP.fft_ear_params(109), dtype=jnp.float32)
    fb = FB.build_consts(EP.fb_ear_params(), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((512, 2048)).astype(np.float32)
    ehs = rng.standard_normal((512, 512)).astype(np.float32)
    blocks = rng.standard_normal((4, 64, 128)).astype(np.float32)
    dft = np.asarray(fe.dft_matrix, np.float64)
    ehs_w = np.asarray(fe.ehs_fwd, np.float64)
    kern = np.asarray(fb.h_phase, np.float64)
    conv_ref = sum(np.einsum("nhc,co->nho",
                             np.asarray(blocks, np.float64)[:, j:j + 52],
                             kern[j]) for j in range(13))
    hi = jax.lax.Precision.HIGH
    hst = jax.lax.Precision.HIGHEST
    for name, p in (("HIGH (float32 tier)", hi),
                    ("HIGHEST (accurate tier)", hst)):
        dot = jax.jit(lambda a, b, p=p: jnp.dot(a, b, precision=p))
        conv = jax.jit(lambda x, k, p=p: jax.lax.conv_general_dilated(
            x, k, (1,), "VALID", dimension_numbers=("NHC", "HIO", "NHC"),
            precision=p))
        errs = {
            "rDFT GEMM": _rel_err(dot(frames, fe.dft_matrix),
                                  frames.astype(np.float64) @ dft),
            "EHS GEMM": _rel_err(dot(ehs, fe.ehs_fwd),
                                 ehs.astype(np.float64) @ ehs_w),
            "FB conv": _rel_err(conv(blocks, fb.h_phase), conv_ref),
        }
        print(f"{name}: " + ", ".join(
            f"{k} max rel err {v:.2e} ({_precision_class(v)})"
            for k, v in errs.items()), flush=True)


def _precision_class(err: float) -> str:
    """TF32 keeps a 10-bit mantissa (~5e-4 relative per product); a full
    f32 product of these depths stays within a few 1e-6."""
    return "TF32" if err > 1e-4 else "f32"


def phase_bench() -> list[dict]:
    import bench
    return bench.run_cells(batch=BENCH[0], seconds=BENCH[1], repeats=3,
                           iters=2)


def corpus():
    from tools.drift import realistic_pairs
    return realistic_pairs(*CORPUS)


def phase_drift(refs, tests) -> dict:
    from gstpeaq_jax.parallel import batch as B
    out = {}
    for advanced in (False, True):
        for tier in ("accurate", "float32"):
            t0 = time.perf_counter()
            res = B.peaq_batch(refs, tests, advanced=advanced, dtype=tier,
                               microbatch=len(refs))
            assert np.all(np.isfinite(res["odg"])), (advanced, tier)
            out[advanced, tier] = res["odg"]
            print(f"{'advanced' if advanced else 'basic'} {tier}: "
                  f"{time.perf_counter() - t0:.1f} s incl. compile",
                  flush=True)
    return out


def phase_stream() -> None:
    import bench
    from gstpeaq_jax.parallel import batch as B
    from gstpeaq_jax.parallel.stream import PeaqStreamPool
    n, seconds = STREAM
    refs, tests = bench.make_pairs(n, seconds, seed=5)
    want = B.peaq_batch(refs, tests, advanced=True, microbatch=n)["odg"]
    pool = PeaqStreamPool(n, channels=2, advanced=True)
    feed_in_steps(pool, refs, tests)
    got = pool.finalize().odg
    d = np.abs(got - want)
    print(f"stream pool ({n} x {seconds:g} s, advanced, accurate) vs "
          f"peaq_batch: "
          f"max |dODG| {d.max():.3e}", flush=True)
    assert np.all(np.isfinite(got)) and d.max() <= STREAM_TOL, (got, want)


def feed_in_steps(pool, refs, tests, seconds: float = 5.0) -> None:
    r, t = np.stack(refs), np.stack(tests)
    step = int(48000 * seconds)
    for s in range(0, r.shape[1], step):
        pool.feed(r[:, s:s + step], t[:, s:s + step])


def phase_float64(refs, tests, tiers: dict) -> None:
    from gstpeaq_jax.parallel import batch as B
    for advanced in (False, True):
        mode = "advanced" if advanced else "basic"
        t0 = time.perf_counter()
        f64 = B.peaq_batch(refs, tests, advanced=advanced, dtype="float64",
                           microbatch=len(refs))["odg"]
        print(f"{mode} float64: {time.perf_counter() - t0:.1f} s incl. "
              f"compile", flush=True)
        assert np.all(np.isfinite(f64)), f64
        acc = np.abs(tiers[advanced, "accurate"] - f64)
        f32 = np.abs(tiers[advanced, "float32"] - f64)
        print(f"{mode}: item  float64-ODG  |dODG| accurate  |dODG| float32")
        for i in range(len(f64)):
            print(f"  {i + 1:4d}  {f64[i]:10.5f}  {acc[i]:.3e}  "
                  f"{f32[i]:.3e}")
        print(f"{mode}: worst |dODG| accurate {acc.max():.3e} (gate "
              f"{GATE_ACCURATE:g}), float32 {f32.max():.3e} (not gated)",
              flush=True)
        assert acc.max() <= GATE_ACCURATE, (mode, acc.max())


def phase_spec() -> None:
    from gstpeaq_jax import api
    from gstpeaq_jax import constants as C
    from gstpeaq_jax.utils import numpy_ref as R
    from gstpeaq_jax.utils import testsignals as TS
    n = 128 * 1024
    s = TS.sine(n)
    sa, tr = TS.saw(n), TS.triangle(n)
    pinned = [
        ("sine vs itself", api.peaq(s, s, dtype="float64").odg, "0.171"),
        ("saw vs triangle", api.peaq(sa, tr, dtype="float64").odg,
         "-2.007"),
        ("saw vs triangle, stereo upmix",
         api.peaq(np.stack([sa, sa], 1), np.stack([tr, tr], 1),
                  dtype="float64").odg, "-2.007"),
    ]
    for name, odg, want in pinned:
        print(f"{name}: ODG {odg:.3f} (pinned {want})", flush=True)
        assert f"{odg:.3f}" == want, (name, odg)
    # the tolerances tests/test_jax_pipeline.py holds on the CPU
    for advanced, names, mov_tol in ((False, C.MOV_BASIC_NAMES, 1e-8),
                                     (True, C.MOV_ADVANCED_NAMES, 1e-7)):
        want = (R.peaq_advanced if advanced else R.peaq_basic)(sa, tr)
        got = api.peaq(sa, tr, advanced=advanced, dtype="float64")
        d_odg = abs(got.odg - want.odg)
        d_mov = max(abs(got.movs[k] - want.movs[k]) / (1 + abs(want.movs[k]))
                    for k in names)
        print(f"{'advanced' if advanced else 'basic'} float64 vs numpy_ref: "
              f"|dODG| {d_odg:.3e} (tol 1e-9), max |dMOV|/(1+|MOV|) "
              f"{d_mov:.3e} (tol {mov_tol:g})", flush=True)
        assert d_odg <= 1e-9 and d_mov <= mov_tol


def phase_cli() -> None:
    from gstpeaq_jax import cli
    from gstpeaq_jax.utils import testsignals as TS
    from gstpeaq_jax.utils import wavio
    n = 128 * 1024
    with tempfile.TemporaryDirectory() as tmp:
        rp, tp = os.path.join(tmp, "ref.wav"), os.path.join(tmp, "test.wav")
        wavio.write_wav(rp, TS.saw(n)[:, None], 48000)
        wavio.write_wav(tp, TS.triangle(n)[:, None], 48000)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([rp, tp])
    lines = buf.getvalue().strip().splitlines()
    print("\n".join(lines), flush=True)
    assert rc == 0, rc
    assert lines[-2] == "Objective Difference Grade: -2.007", lines
    assert lines[-1].startswith("Distortion Index: "), lines
    float(lines[-1].split(": ")[1])


def run_one_gpu() -> None:
    devices = require_gpu(1)
    from gstpeaq_jax import api
    api.enable_compile_cache()
    with phase("device"):
        phase_device(devices)
    with phase("gemm"):
        phase_gemm()
    with phase("bench"):
        phase_bench()
    refs, tests = corpus()
    with phase("drift"):
        tiers = phase_drift(refs, tests)
    with phase("stream"):
        phase_stream()
    with phase("float64"):
        phase_float64(refs, tests, tiers)
    with phase("spec"):
        phase_spec()
    with phase("cli"):
        phase_cli()
    print(last_line(devices), flush=True)


def _shard_devices(x) -> set:
    return {s.device.id for s in x.addressable_shards}


def run_four_gpus() -> None:
    devices = require_gpu(4)[:4]
    import jax
    import bench
    from gstpeaq_jax import api
    from gstpeaq_jax.models import nn
    from gstpeaq_jax.parallel import batch as B
    from gstpeaq_jax.parallel import shard as S
    from gstpeaq_jax.parallel.stream import PeaqStreamPool
    api.enable_compile_cache()
    with phase("device"):
        phase_device(devices)
    mesh = S.default_mesh(devices)
    refs, tests = bench.make_pairs(*FOUR, seed=7)
    with phase("sharded sweep"):
        for advanced in (False, True):
            sh = S.peaq_sharded(refs, tests, mesh=mesh, advanced=advanced,
                                dtype="accurate")
            # the bench cells' microbatches: the same single-device
            # programs as bench.py (and its compile cache entries)
            single = B.peaq_batch(refs, tests, advanced=advanced,
                                  dtype="accurate",
                                  microbatch=32 if advanced else 64)
            d_odg = np.abs(sh["odg"] - single["odg"]).max()
            d_mov = np.nanmax(np.abs(sh["movs"] - single["movs"])
                              / (1 + np.abs(single["movs"])))
            print(f"{'advanced' if advanced else 'basic'} peaq_sharded on "
                  f"{len(devices)} GPUs vs peaq_batch on one: max |dODG| "
                  f"{d_odg:.3e}, max |dMOV|/(1+|MOV|) {d_mov:.3e}; output "
                  f"shards on devices {sorted(sh['devices'])}", flush=True)
            assert len(sh["devices"]) == 4, sh["devices"]
            assert d_odg <= SHARD_TOL, d_odg
    with phase("sharded stream pool"):
        pools = {}
        for name, m in (("single", None), ("sharded", mesh)):
            pool = PeaqStreamPool(8, channels=2, advanced=True, mesh=m)
            feed_in_steps(pool, refs[:8], tests[:8])
            pools[name] = pool
        on = _shard_devices(jax.tree.leaves(pools["sharded"].state)[0])
        d = np.abs(pools["sharded"].finalize().odg
                   - pools["single"].finalize().odg).max()
        print(f"sharded PeaqStreamPool (8 x {FOUR[1]:g} s, advanced) vs "
              f"unsharded: max |dODG| {d:.3e}; state shards on devices "
              f"{sorted(on)}", flush=True)
        assert on == {dev.id for dev in devices}, on
        assert d <= SHARD_TOL, d
    with phase("sharded training step"):
        rng = np.random.default_rng(3)
        movs = rng.standard_normal((64, 11)) * 10 + 50
        tgt = rng.standard_normal(64)
        params, losses = S.train_cognitive_sharded(movs, tgt, mesh=mesh,
                                                   steps=1, lr=1e-2)
        ref_params, ref_loss = jax.jit(nn.sgd_train_step)(
            nn.init_cognitive_params(), jax.numpy.asarray(movs),
            jax.numpy.asarray(tgt), 1e-2)
        for k in params:
            # equal_nan: the reference step itself leaves NaN in some
            # entries (NaN entries must sit in the same places)
            np.testing.assert_allclose(np.asarray(params[k]),
                                       np.asarray(ref_params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        d = float(np.nanmax(np.concatenate(
            [np.abs(np.asarray(params[k]) - np.asarray(ref_params[k]))
             .ravel() for k in params])))
        on = set.intersection(*(_shard_devices(p) for p in params.values()))
        print(f"train_cognitive_sharded step vs unsharded: loss "
              f"{losses[0]:.6f} vs {float(ref_loss):.6f}, max |dparam| "
              f"{d:.3e}; params on devices {sorted(on)}", flush=True)
        assert on == {dev.id for dev in devices}, on
        assert abs(losses[0] - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss)), (losses, ref_loss)
    print(last_line(devices), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-GPU sharded paths only")
    args = ap.parse_args(argv)
    if args.four:
        run_four_gpus()
    else:
        run_one_gpu()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
