"""Advanced-version PEAQ pipeline (FFT + filter-bank ear models, 5 MOVs).

Two parallel paths over the same audio, as in the reference
(src/gstpeaq.c:923-1010): the 55-band FFT ear model at frame 2048 / hop 1024
feeding SegmentalNMR + EHS, and the 40-band filter-bank ear model at frame
192 feeding RmsModDiffA / RmsNoiseLoudAsymA / AvgLinDistA through the level
adapter and modulation processors.  Each path has its own frame counters and
data-boundary gating.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax.numpy as jnp

from .. import constants as C
from .. import earparams as EP
from ..ops import fb_ear as FB
from ..ops import fft_ear as FE
from ..ops import framing
from . import accum
from . import level_adapt
from . import movs as MOVS
from . import nn


class AdvancedOutputs(NamedTuple):
    odg: Any
    di: Any
    movs: Any          # [5] in MOV_ADVANCED_NAMES order
    total_signal_energy: Any
    total_noise_energy: Any


def unified_input(pipe, n_fft: int, n_fb: int):
    """Wrap an advanced pipeline to take ONE raw signal-pair array instead
    of separately-padded FFT and FB copies of the same audio.

    The dual-rate front end consumed the audio twice ([2, CH, T_fft] +
    [2, CH, T_fb] differ only in bucket padding), so every sweep shipped
    ~2x the sample bytes host->device and paid ~2x the host padding.  The
    wrapped signature is fn(consts, sig_pair, valid_fft, valid_fb) with
    sig_pair [2, CH, Tmax] flat or [2, CH, Tmax/128, 128] blocked,
    Tmax = max(t_fft, t_fb), zero-padded raw audio (truncated at
    min(Tmax, T_signal), NOT at each path's own flush boundary): frames
    past a pair's own flush frame carry real audio instead of zeros, and
    the per-path valid masks exclude them exactly as the reference's
    drain loop never processes them (src/gstpeaq.c:715-745) — every
    consumer (threshold, MOV accumulation, totalsnr) is valid-gated, and
    the band-chain recurrences are causal so poisoned trailing frames
    cannot reach unmasked ones.  Each path slices its prefix on device
    (free for the blocked FB rows; one fused prefix slice for the flat
    FFT view).  n_fft/n_fb are static (they cannot be derived from
    Tmax alone — either path's bucket may be the longer one)."""
    t_fft = (n_fft + 1) * C.FFT_STEPSIZE
    t_fb = n_fb * C.FB_FRAMESIZE

    def wrapped(consts, sig_pair, valid_fft=None, valid_fb=None):
        # PCM16-shipped inputs convert on device (framing.dequantize)
        sig_pair = framing.dequantize(sig_pair)
        if sig_pair.ndim == 4 and sig_pair.shape[-1] == C.FFT_STEPSIZE:
            # HOP-layout ship [2, CH, Tq, 1024]: the FFT path's inputs
            # are row prefixes IN PLACE (the rows are its hop blocks, so
            # no blocked->flat merge + blocks_hop copy runs); the FB path
            # re-blocks its prefix to 128-sample rows in ONE reshape that
            # fuses into the DC table GEMM's operand format
            assert t_fb % C.FFT_STEPSIZE == 0
            rows_fft = t_fft // C.FFT_STEPSIZE
            fb_pair = sig_pair[..., :t_fb // C.FFT_STEPSIZE, :]
            return pipe(consts, sig_pair[0, ..., :rows_fft, :],
                        sig_pair[1, ..., :rows_fft, :],
                        fb_pair, valid_fft, valid_fb,
                        thresh_blocked=sig_pair[0])
        if sig_pair.ndim == 4:          # blocked [2, CH, Tb, 128]
            assert t_fb % 128 == 0
            flat = sig_pair.reshape(*sig_pair.shape[:-2], -1)
            fb_pair = sig_pair[..., :t_fb // 128, :]
            # both paths' data-boundary gates derive from ONE sliding-max
            # pass over the blocked ref (they read the same samples)
            return pipe(consts, flat[0, ..., :t_fft], flat[1, ..., :t_fft],
                        fb_pair, valid_fft, valid_fb,
                        thresh_blocked=sig_pair[0])
        flat = sig_pair
        fb_pair = flat[..., :t_fb]
        return pipe(consts, flat[0, ..., :t_fft], flat[1, ..., :t_fft],
                    fb_pair, valid_fft, valid_fb)
    return wrapped


def make_pipeline(playback_level: float = 92.0,
                  settings: C.Settings = C.DEFAULT_SETTINGS,
                  dtype=jnp.float64, spectrum_dtype=None,
                  fft_spectra: bool = False, accurate: bool = False):
    """Build the jittable advanced pipeline closure.

    Returns fn(ref_fft, test_fft, fb_pair), channel-major:
      ref/test_fft: [CH, (F_fft + 1) * 1024] float32 (zero-padded)
      fb_pair:      [2, CH, F_fb * 192] float32 (ref/test stacked on the
                    leading axis BY THE HOST, which saves a device-side
                    stack copy), or the blocked [2, CH, T/128, 128] layout
    """
    sdtype = spectrum_dtype or dtype
    fft_params = EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT, playback_level)
    # truncate_spectrum: the advanced FFT path reads no bin above the
    # grouping support (NMR < group_bin_hi, EHS < 512; bandwidth is
    # basic-only), so the rDFT GEMM skips the top ~25% of columns
    kf0 = FE.build_consts(fft_params, dtype=dtype, spectrum_dtype=sdtype,
                          truncate_spectrum=True,
                          use_dft_gemm=False if fft_spectra else None,
                          accurate=accurate)
    fb_params = EP.fb_ear_params(playback_level)
    kb0 = FB.build_consts(
        fb_params, dtype=dtype, spectrum_dtype=sdtype,
        swap_slope=settings.swap_slope_filter_coefficients,
        accurate=accurate)
    avg_matrix0 = jnp.asarray(
        level_adapt.sliding_average_matrix(C.FB_BAND_COUNT), dtype=dtype)
    consts = (kf0, kb0, avg_matrix0)

    def pipeline(consts, ref_fft, test_fft, fb_pair,
                 valid_fft=None, valid_fb=None,
                 thresh_blocked=None) -> AdvancedOutputs:
        kf, kb, avg_matrix = consts
        # ------------------ FFT path: SegmentalNMR + EHS ------------------
        if ref_fft.ndim == 3:
            # HOP-layout ship: the rows ARE the rDFT's hop blocks
            n_fft = ref_fft.shape[-2] - 1
            rblocks, tblocks = ref_fft, test_fft       # [CH,F+1,1024]
        else:
            n_fft = ref_fft.shape[-1] // C.FFT_STEPSIZE - 1
            rblocks = framing.blocks_hop(ref_fft, n_fft)  # [CH,F+1,1024]
            tblocks = framing.blocks_hop(test_fft, n_fft)
        hop_gate = (thresh_blocked is not None
                    and thresh_blocked.shape[-1] == C.FFT_STEPSIZE)
        if thresh_blocked is not None:
            # blocked unified input: one sliding-max pass over the ref
            # serves both paths' gates; the hop path reduces to per-64-
            # chunk maxima in the producing pass (sliding_max5_chunks)
            # so the sample-rate max5 never materializes
            if hop_gate:
                cm, cm5 = framing.sliding_max5_chunks(
                    thresh_blocked.astype(sdtype))
                above_fft = framing.fft_gate_from_chunks(cm, cm5, n_fft)
            else:
                max5 = framing.sliding_max5_blocked(
                    thresh_blocked.astype(sdtype))
                above_fft = framing.fft_gate_from_max5(max5, n_fft)
        else:
            above_fft = framing.above_threshold_signal(
                ref_fft.astype(sdtype), n_fft, C.FFT_FRAMESIZE,
                C.FFT_STEPSIZE)
        fft_frame_valid = None
        if valid_fft is not None:
            fft_frame_valid = jnp.arange(n_fft) < valid_fft
            above_fft = above_fft & fft_frame_valid
        _, _, committed_fft = accum.activity(above_fft)

        power, unsmeared, thresh, delta_p = FE.stateless_pair_hop(
            kf, rblocks, tblocks, spread_ref_only=True)
        # only the REF excitation is consumed (NMR masking): grouping and
        # spreading run on the ref alone (spread_ref_only), and the smear
        # runs in the transposed layout
        ref_u_t = jnp.swapaxes(unsmeared, -1, -2)         # [CH, Z, F]
        ref_exc = jnp.swapaxes(FE.time_smear(kf, ref_u_t, axis=-1), -1, -2)
        hi = kf.group_bin_hi
        fmv = lambda x: jnp.swapaxes(x, -1, -2)   # [CH,F] -> accum [F,CH]
        nmr_mean, _ = MOVS.nmr(kf.group_matrix[:hi], kf.masking_difference,
                               power[0][..., :hi], power[1][..., :hi],
                               ref_exc, delta_weighted=delta_p)
        nmr_mean = fmv(nmr_mean)
        ehs_val, ehs_valid = MOVS.ehs(
            power[0], power[1], thresh[0], thresh[1], settings, sdtype,
            ehs_mats=None if kf.ehs_fwd is None else
            (kf.ehs_fwd, kf.ehs_inv_re, kf.ehs_inv_im, kf.ehs_fwd2),
            delta_weighted=delta_p, ehs_mask=kf.ehs_mask,
            ehs_dmat=kf.ehs_dmat, precision=kf.dft_precision,
            ehs_zero=kf.ehs_zero)
        ehs_val = fmv(ehs_val)
        cmf = committed_fft[:, None]
        one = jnp.ones_like(nmr_mean)
        seg_nmr = jnp.mean(accum.avg(
            10.0 * jnp.log10(nmr_mean), one, cmf))
        ehs_mov = jnp.mean(accum.avg(ehs_val, one, cmf & ehs_valid[:, None]))

        # ------------- FB path: ModDiff / NoiseLoudAsym / LinDist ----------
        # fb_pair arrives ref/test-stacked [2, CH, T] flat or BLOCKED
        # [2, CH, T/128, 128] (the DC cascade's block layout, shipped by
        # the host); the threshold test reads only the ref slice
        fb_blocked = fb_pair.ndim == 4
        if fb_blocked and fb_pair.shape[-1] == C.FFT_STEPSIZE:
            # HOP-layout ship: gate from the shared hop-form max5, then
            # ONE re-block of the FB prefix to the chain's 128-sample rows
            # (fuses into the DC table GEMM's operand format)
            n_fb = fb_pair.shape[-2] * C.FFT_STEPSIZE // C.FB_FRAMESIZE
            if hop_gate:
                rows_fb = fb_pair.shape[-2]
                above_fb = framing.fb_gate_from_chunks(
                    cm[..., :rows_fb, :], cm5[..., :rows_fb, :], n_fb)
            else:
                above_fb = framing.above_threshold_blocked(
                    fb_pair[0].astype(sdtype).reshape(
                        *fb_pair.shape[1:-2], -1, 128), n_fb)
            fb_pair = fb_pair.reshape(*fb_pair.shape[:-2], -1, 128)
        elif fb_blocked:
            ref_fb = fb_pair[0]
            n_fb = ref_fb.shape[-2] * 128 // C.FB_FRAMESIZE
            if thresh_blocked is not None:
                above_fb = framing.fb_gate_from_max5(
                    max5[..., :ref_fb.shape[-2], :], n_fb)
            else:
                above_fb = framing.above_threshold_blocked(
                    ref_fb.astype(sdtype), n_fb)
        else:
            ref_fb = fb_pair[0]
            n_fb = ref_fb.shape[-1] // C.FB_FRAMESIZE
            above_fb = framing.above_threshold_signal(
                ref_fb.astype(sdtype), n_fb, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
        if valid_fb is not None:
            above_fb = above_fb & (jnp.arange(n_fb) < valid_fb)
        _, _, committed_fb = accum.activity(above_fb)

        # [2, CH, ...]: both signals through ONE filter-bank pass (halves
        # the op count of the FB front end vs separate ref/test calls);
        # already pair-stacked and channel-major from the host
        exc2, uns2 = FB.process_signal(kb, fb_pair.astype(sdtype), n_fb,
                                       blocked=fb_blocked)  # [2,CH,40,F]
        # the FB chain's native transposed layout IS the MOV-tail layout:
        # no boundary transpose at all
        ref_e, test_e = exc2[0], exc2[1]

        # level-adapter stage 1 + both modulation smoothers fused into one
        # banded recurrence call (four independent adapt_a recurrences)
        adapted_ref, adapted_test, mod2, avg_loud2 = (
            level_adapt.level_adapt_fused_mod(
                kb.adapt_a, avg_matrix, exc2, uns2, C.FB_FRAMESIZE))
        mod_ref, mod_test = mod2[0], mod2[1]
        avg_loud_ref = avg_loud2[0]

        # ONE stacked loudness call over exc2 (bit-identical per slice)
        loud2 = FB.loudness(kb, exc2, axis=-2)       # [2,CH,F]
        loud_ok = jnp.any((loud2[0] > 0.1) & (loud2[1] > 0.1), axis=-2)
        any_loud = jnp.any(loud_ok)
        f_idx = jnp.arange(n_fb)
        loud_frame = jnp.argmax(loud_ok)
        md_gate = f_idx >= 125                     # src/gstpeaq.c:988
        nl_gate = (md_gate & any_loud
                   & (f_idx - 13 >= loud_frame))   # src/gstpeaq.c:996-997

        fm = lambda x: jnp.swapaxes(x, -1, -2)     # [CH,F] -> accum [F,CH]
        md1_t, _, temp_wt_t = MOVS.modulation_difference(
            kb.internal_noise, mod_ref, mod_test, avg_loud_ref,
            rms_mode=True, lev_wt=1.0)
        md1, temp_wt = fm(md1_t), fm(temp_wt_t)
        nl_asym = fm(MOVS.noise_loudness(
            kb.internal_noise, 2.5, 0.3, 1.0, 0.1, mod_ref, mod_test,
            adapted_ref, adapted_test))
        if settings.swap_mod_patts_for_noise_loudness_movs:
            missing = fm(MOVS.noise_loudness(
                kb.internal_noise, 1.5, 0.15, 1.0, 0.0, mod_test, mod_ref,
                adapted_test, adapted_ref))
            lin_dist = fm(MOVS.noise_loudness(
                kb.internal_noise, 1.5, 0.15, 1.0, 0.0, mod_ref, mod_ref,
                adapted_ref, ref_e))
        else:
            missing = fm(MOVS.noise_loudness(
                kb.internal_noise, 1.5, 0.15, 1.0, 0.0, mod_ref, mod_test,
                adapted_test, adapted_ref))
            lin_dist = fm(MOVS.noise_loudness(
                kb.internal_noise, 1.5, 0.15, 1.0, 0.0, mod_ref, mod_test,
                adapted_ref, ref_e))

        cmb = committed_fb[:, None]
        gmb = md_gate[:, None]
        oneb = jnp.ones_like(md1)
        rms_mod_diff = jnp.mean(accum.rms(md1, temp_wt, cmb & gmb))
        nl_mask = cmb & nl_gate[:, None]
        rms_noise_loud_asym = jnp.mean(accum.rms_asym(nl_asym, missing,
                                                      nl_mask))
        avg_lin_dist = jnp.mean(accum.avg(lin_dist, oneb, nl_mask))

        mov = {
            "RmsModDiffA": rms_mod_diff,
            "RmsNoiseLoudAsymA": rms_noise_loud_asym,
            "SegmentalNMRB": seg_nmr,
            "EHSB": ehs_mov,
            "AvgLinDistA": avg_lin_dist,
        }
        mov_vec = jnp.stack([mov[name] for name in C.MOV_ADVANCED_NAMES])
        di = nn.di_advanced(mov_vec, settings.clamp_movs)
        odg = nn.odg(di)

        # first half of frame f = hop block f  ([CH, F, 1024])
        rhalf = rblocks[..., :-1, :].astype(sdtype)
        nhalf = rhalf - tblocks[..., :-1, :].astype(sdtype)
        if fft_frame_valid is not None:
            sel = fft_frame_valid[:, None]
            rhalf = jnp.where(sel, rhalf, 0.0)
            nhalf = jnp.where(sel, nhalf, 0.0)
        rsum = jnp.sum(rhalf ** 2)
        nsum = jnp.sum(nhalf ** 2)
        return AdvancedOutputs(odg=odg, di=di, movs=mov_vec,
                               total_signal_energy=rsum,
                               total_noise_energy=nsum)

    return pipeline, consts
