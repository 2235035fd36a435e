"""Basic-version PEAQ pipeline (FFT ear model, 11 MOVs), fully vectorized.

One jittable function maps padded 48 kHz signal pairs to {ODG, DI, MOVs}:

  stage A (vmapped over frames/channels/signals): window+FFT+weighting+
          grouping+spreading, per-frame MOV raw terms            (GEMMs)
  stage B (associative scans over the frame axis): time smearing, level
          adaptation, modulation smoothing, MFPD filter          (log-depth)
  stage C: masked-reduction accumulation + cognitive model       (tiny)

Orchestration semantics follow src/gstpeaq.c:849-921 exactly: the
frame>=24 gates, the loudness-reached +3 delay, the data-boundary tentative
machinery (closed form, see accum.py), binaural ADB/MFPD, and the trailing
zero-pad flush frame (supplied by host-side padding).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C
from .. import earparams as EP
from ..ops import fft_ear as FE
from ..ops import framing
from . import accum
from . import level_adapt
from . import movs as MOVS
from . import nn


class BasicOutputs(NamedTuple):
    odg: Any
    di: Any
    movs: Any          # [11] in MOV_BASIC_NAMES order
    total_signal_energy: Any
    total_noise_energy: Any


def make_pipeline(band_count: int = C.BASIC_BAND_COUNT,
                  playback_level: float = 92.0,
                  settings: C.Settings = C.DEFAULT_SETTINGS,
                  dtype=jnp.float64, spectrum_dtype=None,
                  fft_spectra: bool = False, accurate: bool = False):
    """Build the jittable basic pipeline closure.

    `dtype` = band-domain compute type; `spectrum_dtype` = bin-domain type
    (f32 spectra under an f64 band chain is a mixed mode).  Returns
    fn(ref_sig, test_sig) with ref/test_sig: [CH, T] float32 channel-major,
    T = (n_frames + 1) * 1024 (zero-padded, host-prepared).
    """
    sdtype = spectrum_dtype or dtype
    params = EP.fft_ear_params(band_count, playback_level)
    k0 = FE.build_consts(params, dtype=dtype, spectrum_dtype=sdtype,
                         use_dft_gemm=False if fft_spectra else None,
                         accurate=accurate)
    avg_matrix0 = jnp.asarray(
        level_adapt.sliding_average_matrix(band_count), dtype=dtype)
    consts = (k0, avg_matrix0)

    def pipeline(consts, ref_sig: jnp.ndarray, test_sig: jnp.ndarray,
                 valid_frames=None) -> BasicOutputs:
        # consts passed as a pytree ARGUMENT: closure constants (16 MB DFT
        # matrix) would inline into the HLO and slow compilation.
        # ref/test_sig: [CH, T] channel-major (the sample axis is the
        # contiguous minor, so no [T, CH] transpose runs), or the blocked
        # [CH, T/128, 128] layout (host-shipped; the data-boundary gate
        # then rides the blocked sliding-max instead of a flat
        # sample-rate pass + concat)
        k, avg_matrix = consts
        # PCM16-shipped inputs convert on device (framing.dequantize)
        ref_sig = framing.dequantize(ref_sig)
        test_sig = framing.dequantize(test_sig)
        if ref_sig.ndim == 3 and ref_sig.shape[-1] == C.FFT_STEPSIZE:
            # HOP-layout ship [CH, F + 1, 1024]: the rows ARE the rDFT's
            # hop blocks — no blocked->flat merge and no blocks_hop
            # copy ever runs
            n_frames = ref_sig.shape[-2] - 1
            above = framing.fft_gate_from_chunks(
                *framing.sliding_max5_chunks(ref_sig.astype(sdtype)),
                n_frames)
            ref_blocks, test_blocks = ref_sig, test_sig
        elif ref_sig.ndim == 3:          # blocked [CH, Tb, 128] (streams)
            n_frames = ref_sig.shape[-2] * 128 // C.FFT_STEPSIZE - 1
            above = framing.fft_gate_from_max5(
                framing.sliding_max5_blocked(ref_sig.astype(sdtype)),
                n_frames)
            ref_sig = ref_sig.reshape(*ref_sig.shape[:-2], -1)
            test_sig = test_sig.reshape(*test_sig.shape[:-2], -1)
        else:
            n_frames = ref_sig.shape[-1] // C.FFT_STEPSIZE - 1
            above = framing.above_threshold_signal(
                ref_sig.astype(sdtype), n_frames, C.FFT_FRAMESIZE,
                C.FFT_STEPSIZE)  # [F]
        if ref_sig.ndim == 2:
            ref_blocks = framing.blocks_hop(ref_sig, n_frames)  # [CH,F+1,1024]
            test_blocks = framing.blocks_hop(test_sig, n_frames)

        frame_valid = None
        if valid_frames is not None:
            # bucketed batching: frames past a pair's own flush frame can
            # still overlap real audio (50% overlap) — exclude them exactly
            # as the reference does by never processing them
            frame_valid = jnp.arange(n_frames) < valid_frames
            above = above & frame_valid
        has, active, committed = accum.activity(above)

        # ---- stage A: stateless ear model on both signals ----
        power, unsmeared, thresh, delta_p = FE.stateless_pair_hop(
            k, ref_blocks, test_blocks)
        ref_p, test_p = power[0], power[1]

        # ---- stage B: scans over the frame axis ----
        # transposed MOV-tail layout [2, CH, Z, F]: bands major, frames
        # minor — ONE boundary transpose (of the small band-domain
        # tensor; the 1025-bin spectra stay channel-major with no
        # transpose at all) replaces the moveaxis pair around every
        # banded recurrence
        uns_t = jnp.swapaxes(unsmeared, -1, -2)  # [2,CH,Z,F]
        exc = FE.time_smear(k, uns_t, axis=-1)
        ref_e, test_e = exc[0], exc[1]           # [CH,Z,F]
        # level-adapter stage 1 + both modulation smoothers fused into one
        # banded recurrence call (four independent adapt_a recurrences)
        adapted_ref, adapted_test, mod2, avg_loud2 = (
            level_adapt.level_adapt_fused_mod(
                k.adapt_a, avg_matrix, exc, uns_t, C.FFT_STEPSIZE))
        mod_ref, mod_test = mod2[0], mod2[1]
        avg_loud_ref = avg_loud2[0]

        # loudness gate; src/gstpeaq.c:841-845,880-886 — ONE stacked call
        # over the [2, CH, Z, F] excitation pair (bit-identical per slice)
        loud2 = FE.loudness(k, exc, axis=-2)        # [2,CH,F]
        loud_ok = jnp.any((loud2[0] > 0.1) & (loud2[1] > 0.1), axis=-2)
        any_loud = jnp.any(loud_ok)
        f_idx = jnp.arange(loud_ok.shape[-1])
        loud_frame = jnp.argmax(loud_ok)       # first frame where reached
        nl_gate = ((f_idx >= 24) & any_loud
                   & (f_idx - 3 >= loud_frame))
        md_gate = f_idx >= 24

        # ---- stage C: per-frame MOV terms ----
        # everything comes out channel-major [CH, F]; the tiny accum
        # boundary transposes to the accumulators' frame-major [F, CH]
        fm = lambda x: jnp.swapaxes(x, -1, -2)
        md1, md2, temp_wt = (fm(x) for x in MOVS.modulation_difference(
            k.internal_noise, mod_ref, mod_test, avg_loud_ref,
            rms_mode=False, lev_wt=100.0))
        nl = fm(MOVS.noise_loudness(
            k.internal_noise, 1.5, 0.15, 0.5, 0.0, mod_ref, mod_test,
            adapted_ref, adapted_test))
        bw_ref, bw_test, bw_valid = (
            fm(x) for x in MOVS.bandwidth(ref_p, test_p,
                                          bin_idx=k.bin_idx))
        hi = k.group_bin_hi
        nmr_mean, disturbed = (fm(x) for x in MOVS.nmr(
            k.group_matrix[:hi], k.masking_difference,
            ref_p[..., :hi], test_p[..., :hi],
            jnp.swapaxes(ref_e, -1, -2),       # [CH, F, Z] for the
            delta_weighted=delta_p))           # bin-domain quotient
        p_bin, steps_bin = MOVS.prob_detect(
            ref_e, test_e, settings.use_floor_for_steps_above_threshold)
        ehs_val, ehs_valid = MOVS.ehs(
            ref_p, test_p, thresh[0], thresh[1], settings, sdtype,
            ehs_mats=None if k.ehs_fwd is None else
            (k.ehs_fwd, k.ehs_inv_re, k.ehs_inv_im, k.ehs_fwd2),
            delta_weighted=delta_p, ehs_mask=k.ehs_mask,
            ehs_dmat=k.ehs_dmat, precision=k.dft_precision,
            ehs_zero=k.ehs_zero)
        ehs_val = fm(ehs_val)

        # ---- accumulate (channel means where multichannel) ----
        cm = committed[:, None]
        gm = md_gate[:, None]
        one = jnp.ones_like(md1)
        mov = {
            "BandwidthRefB": jnp.mean(
                accum.avg(bw_ref, one, cm & bw_valid)),
            "BandwidthTestB": jnp.mean(
                accum.avg(bw_test, one, cm & bw_valid)),
            "TotalNMRB": jnp.mean(accum.avg_log(nmr_mean, one, cm)),
            "WinModDiff1B": jnp.mean(accum.avg_window(
                md1, active[:, None] & gm, committed[:, None])),
            "ADBB": accum.adb(steps_bin, committed & (p_bin > 0.5)),
            "EHSB": jnp.mean(
                accum.avg(ehs_val, one, cm & ehs_valid[:, None])),
            "AvgModDiff1B": jnp.mean(accum.avg(md1, temp_wt, cm & gm)),
            "AvgModDiff2B": jnp.mean(accum.avg(md2, temp_wt, cm & gm)),
            "RmsNoiseLoudB": jnp.mean(
                accum.rms(nl, one, cm & nl_gate[:, None])),
            "MFPDB": accum.filtered_max(p_bin, active, committed),
            "RelDistFramesB": jnp.mean(accum.avg(disturbed, one, cm)),
        }
        mov_vec = jnp.stack([mov[name] for name in C.MOV_BASIC_NAMES])
        di = nn.di_basic(mov_vec, settings.clamp_movs)
        odg = nn.odg(di)

        # totalsnr bookkeeping; src/gstpeaq.c:913-918
        # first half of frame f = hop block f  ([CH, F, 1024])
        rhalf = ref_blocks[..., :-1, :].astype(sdtype)
        nhalf = rhalf - test_blocks[..., :-1, :].astype(sdtype)
        if frame_valid is not None:
            sel = frame_valid[:, None]
            rhalf = jnp.where(sel, rhalf, 0.0)
            nhalf = jnp.where(sel, nhalf, 0.0)
        rsum = jnp.sum(rhalf ** 2)
        nsum = jnp.sum(nhalf ** 2)
        return BasicOutputs(odg=odg, di=di, movs=mov_vec,
                            total_signal_energy=rsum,
                            total_noise_energy=nsum)

    return pipeline, consts
