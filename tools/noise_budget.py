"""Per-stage noise budget for the accurate tier (runs on CPU).

Computes the exact f64 basic-pipeline ODGs on the realistic drift corpus,
then re-runs with f32 rounding injected at ONE point at a time and reports
the ODG drift each injection causes.  This tells which stages genuinely
need extended precision to hit the <=1e-3-ODG gate and which can run f32.

Usage: python tools/noise_budget.py [--pairs N] [--seconds S]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from gstpeaq_jax import constants as C
from gstpeaq_jax.models import basic, level_adapt, modulation
from gstpeaq_jax.ops import fft_ear as FE
from gstpeaq_jax.parallel import batch as B
from tools.drift import realistic_pairs


def r32(x):
    """Round an f64 array through f32 (one rounding injection)."""
    return x.astype(jnp.float32).astype(jnp.float64)


def run(refs, tests):
    out = B.peaq_batch(refs, tests, dtype="float64", microbatch=4)
    B._jitted_basic_batch.cache_clear()
    return out["odg"]


INJECTIONS = {}


def injection(name):
    def deco(fn):
        INJECTIONS[name] = fn
        return fn
    return deco


import functools


@functools.lru_cache(maxsize=2)
def _dft64():
    from gstpeaq_jax import earparams as EP
    params = EP.fft_ear_params(C.BASIC_BAND_COUNT, 92.0)
    n = C.FFT_FRAMESIZE
    kk = np.arange(n // 2 + 1)
    ang = -2.0 * np.pi * np.outer(np.arange(n), kk) / n
    win = params.hann_window[:, None]
    return np.concatenate([np.cos(ang) * win, np.sin(ang) * win], 1)


def _spectrum_chunked(k, frames, n_chunks, chunk_sum_dtype):
    """DFT via f32 chunk GEMMs; chunk partials summed in chunk_sum_dtype."""
    x = frames.astype(jnp.float64)
    bins = C.FFT_FRAMESIZE // 2 + 1
    dm = _dft64()
    xs = x.reshape(*x.shape[:-1], n_chunks, -1)
    dms = dm.reshape(n_chunks, C.FFT_FRAMESIZE // n_chunks, -1)
    parts = jnp.einsum("...ck,ckb->...cb", xs.astype(jnp.float32),
                       dms.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST)
    spec_ri = jnp.sum(parts.astype(chunk_sum_dtype), axis=-2)
    spec_ri = spec_ri.astype(jnp.float64)
    power = (spec_ri[..., :bins] ** 2
             + spec_ri[..., bins:] ** 2) * k.level_factor.astype(jnp.float64)
    weighted = power * k.om_weight.astype(jnp.float64)
    band_power = jnp.maximum(
        weighted @ k.group_matrix.astype(jnp.float64), 1e-12)
    unsmeared = FE.spread(k, band_power + k.internal_noise)
    energy = jnp.sum(x[..., C.FFT_FRAMESIZE // 2:] ** 2, axis=-1)
    thr = energy >= C.EHS_ENERGY_THRESHOLD
    return power, weighted, unsmeared, thr


@injection("f32 DFT GEMM (f32 chunk accumulation, K=2048)")
def _spectrum_accum(orig_stateless):
    def stateless(k, frames):
        return _spectrum_chunked(k, frames, 16, jnp.float32)
    return FE, "stateless", stateless


@injection("mixed-tier spectra: spec+power+weight+grouping all f32")
def _spectrum_all32(orig_stateless):
    def stateless(k, frames):
        x = frames.astype(jnp.float32)
        bins = C.FFT_FRAMESIZE // 2 + 1
        dm = jnp.asarray(_dft64(), jnp.float32)
        spec_ri = jnp.einsum("...k,kb->...b", x, dm,
                             precision=jax.lax.Precision.HIGHEST)
        power = ((spec_ri[..., :bins] ** 2 + spec_ri[..., bins:] ** 2)
                 * k.level_factor.astype(jnp.float32))
        weighted = power * k.om_weight.astype(jnp.float32)
        band_power = jnp.maximum(
            weighted @ k.group_matrix.astype(jnp.float32), 1e-12)
        unsmeared = FE.spread(
            k, band_power.astype(jnp.float64) + k.internal_noise)
        energy = jnp.sum(x.astype(jnp.float64)[..., 1024:] ** 2, axis=-1)
        thr = energy >= C.EHS_ENERGY_THRESHOLD
        return (power.astype(jnp.float64), weighted.astype(jnp.float64),
                unsmeared, thr)
    return FE, "stateless", stateless


@injection("band_power quantized to f32 (isolates input rounding)")
def _bandpower32(orig_stateless):
    def stateless(k, frames):
        power, weighted, unsmeared, thr = orig_stateless(k, frames)
        band_power = jnp.maximum(weighted @ k.group_matrix, 1e-12)
        band_power = r32(band_power)
        unsmeared = FE.spread(k, band_power + k.internal_noise)
        return power, weighted, unsmeared, thr
    return FE, "stateless", stateless


@injection("K-split-16 spectrum (f32 chunk GEMMs, f64 chunk sum)")
def _spectrum_ksplit(orig_stateless):
    def stateless(k, frames):
        return _spectrum_chunked(k, frames, 16, jnp.float64)
    return FE, "stateless", stateless


@injection("K-split-32 spectrum (f32 chunk GEMMs, f64 chunk sum)")
def _spectrum_ksplit32(orig_stateless):
    def stateless(k, frames):
        return _spectrum_chunked(k, frames, 32, jnp.float64)
    return FE, "stateless", stateless


@injection("upper-spread tail in f32 (prologue+lower+diag f64)")
def _upper_tail(orig_spread):
    def spread(k, pitch_power, block=16):
        Z = k.band_count
        dz = k.delta_z
        a_uce = k.a_uc * pitch_power ** (0.2 * dz)
        n_up = Z - jnp.arange(Z, dtype=pitch_power.dtype)
        g_iu = (1.0 - a_uce ** n_up) / (1.0 - a_uce)
        en = pitch_power / (k.g_il + g_iu - 1.0)
        ene = en ** 0.4
        e2 = ene @ k.lower_matrix                     # f64 lower+diagonal
        # upper tail entirely in f32
        log_a = (0.4 * jnp.log(a_uce)).astype(jnp.float32)
        ene32 = ene.astype(jnp.float32)
        i_idx = jnp.arange(Z, dtype=jnp.float32)
        chunks = []
        for jb in range(0, Z, block):
            j = jnp.arange(jb, min(jb + block, Z), dtype=jnp.float32)
            expo = j - i_idx[:, None]
            w = jnp.where(expo > 0, jnp.exp(expo * log_a[..., None]), 0.0)
            chunks.append(jnp.sum(ene32[..., None] * w, axis=-2))
        e2 = e2 + jnp.concatenate(chunks, -1).astype(jnp.float64)
        return e2 ** 2.5 / k.spread_norm
    return FE, "spread", spread


@injection("whole spread in f32 (incl prologue)")
def _spread32(orig_spread):
    def spread(k, pitch_power, block=16):
        out = orig_spread(k, pitch_power.astype(jnp.float32), block)
        return out.astype(jnp.float64)
    return FE, "spread", spread


@injection("level adapter in f32")
def _adapt32(orig):
    def la(a, avg, re, te, state=None):
        ar, at, st = orig(a.astype(jnp.float32), avg.astype(jnp.float32),
                          re.astype(jnp.float32), te.astype(jnp.float32),
                          state=state)
        return (ar.astype(jnp.float64), at.astype(jnp.float64), st)
    return level_adapt, "level_adapt", la


@injection("modulation processor in f32")
def _mod32(orig):
    def mod(a, u, step, state=None):
        m, al, st = orig(a.astype(jnp.float32), u.astype(jnp.float32), step,
                         state=state)
        return m.astype(jnp.float64), al.astype(jnp.float64), st
    return modulation, "modulation", mod


@injection("time smear in f32")
def _smear32(orig):
    def ts(k, u, axis=0, state=None, return_state=False):
        out = orig(k, u.astype(jnp.float32), axis=axis, state=state,
                   return_state=return_state)
        if return_state:
            return out[0].astype(jnp.float64), out[1]
        return out.astype(jnp.float64)
    return FE, "time_smear", ts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    refs, tests = realistic_pairs(args.pairs, args.seconds)

    base = run(refs, tests)
    print("f64 ODGs:", np.round(base, 6), flush=True)

    for name, make in INJECTIONS.items():
        mod, attr, _ = make(None)        # discover the patch target
        if attr == "stateless":
            # the pipelines call the pair/hop-block form; adapt the
            # frames-based injection onto it (frame f = blocks[f] |
            # blocks[f + 1]).  This tool runs in f64, where the direct
            # weighted difference matches the pair form's cancellation-free
            # delta to ~1e-15.
            frames_orig = getattr(mod, attr)
            _, _, frames_repl = make(frames_orig)
            attr = "stateless_pair_hop"
            orig = getattr(mod, attr)

            def repl(k, ref_blocks, test_blocks, _fn=frames_repl):
                # blocks are [CH, F+1, 1024] channel-major
                blocks = jnp.stack([ref_blocks, test_blocks])
                frames = jnp.concatenate(
                    [blocks[..., :-1, :], blocks[..., 1:, :]], axis=-1)
                power, _, unsmeared, thr = _fn(k, frames)
                hi = k.group_bin_hi
                delta_p = power[0][..., :hi] - power[1][..., :hi]
                return power, unsmeared, thr, delta_p
        else:
            orig = getattr(mod, attr)
            _, _, repl = make(orig)      # rebuild closure over the original
        setattr(mod, attr, repl)
        try:
            odg = run(refs, tests)
        finally:
            setattr(mod, attr, orig)
        print(f"{name}: max |dODG| = {np.max(np.abs(odg - base)):.2e}",
              flush=True)


if __name__ == "__main__":
    main()
