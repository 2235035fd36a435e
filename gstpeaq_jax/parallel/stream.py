"""Chunked streaming PEAQ for long programs (hours) with carried state.

The reference is inherently streaming: GStreamer pushes buffers and all
model state lives in per-component structs (src/gstpeaq.c:596-661).  Here the
equivalent is an explicit device-side state pytree carried between fixed-size
chunk invocations of a jitted step function: O(1) memory in program length,
checkpointable (the state is a pytree of arrays — orbax-serializable), and
the ODG is queryable at any prefix, matching the element's live `odg`
property (src/gstpeaq.c:475-503).

Accumulator streaming semantics (INIT/tentative, src/movaccum.c:304-354) are
kept exact with three carried aggregates per MOV:
    s_all       — sums over all accumulated frames so far
    s_committed — sums as of the most recent above-threshold frame
    has_above   — whether any above-threshold frame occurred yet
get_value() reads s_committed (== s_all whenever the stream is currently
in an above-threshold region), which reproduces the snapshot behavior.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

from .. import constants as C

# Checkpoint compatibility tag (utils/checkpoint.py embeds + checks this).
# Bump whenever the carried state pytree changes shape or meaning.
#   2: complex biquad carries became real [..., 2] pairs; FB e0 tail
#      transposed [CH, 10, Z] -> [CH, Z, 10] (round 2)
#   3: FB conv history grew 1455 -> 1536 samples (12 aligned 128-blocks;
#      the kernels carry the offset, see ops/fb_ear._KERNEL_OFF)
STATE_FORMAT_VERSION = 3


def _cm(x: np.ndarray) -> np.ndarray:
    """Host [T, CH] -> contiguous channel-major [CH, T] (device layout)."""
    return np.ascontiguousarray(x.T)


def _dequant_host(x: np.ndarray) -> np.ndarray:
    """Host-side twin of framing.dequantize: int16 PCM -> float32 signal."""
    return (x.astype(np.float32) / 32768.0) if x.dtype == np.int16 else x


def _cat_ship(buf: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Append to a stream buffer, letting an EMPTY buffer adopt the
    incoming dtype (int16 PCM ships raw and dequantizes on device —
    framing.dequantize — halving the per-chunk transfer).  Mixing dtypes
    mid-stream falls back to float32 with the int16 side dequantized on
    HOST (raw-value upcast would be 32768x too loud — device-side
    dequantize passes float32 through); it costs the ship-byte saving,
    so keep a stream's feeds one dtype."""
    if buf.dtype != new.dtype:
        if buf.shape[-2] == 0:
            buf = buf.astype(new.dtype)
        else:
            buf, new = _dequant_host(buf), _dequant_host(new)
    return np.concatenate([buf, new], axis=-2)


# ---------------------------------------------------------------------------
# Device-side chunk step (basic version)
# ---------------------------------------------------------------------------


def _make_basic_chunk_step(playback_level: float, settings: C.Settings,
                           dtype_name: str):
    import jax
    import jax.numpy as jnp

    from .. import api, earparams as EP
    from ..models import accum, level_adapt, movs as MOVS, modulation as MP
    from ..ops import fft_ear as FE, framing

    dtype, sdtype = api.resolve_dtypes(dtype_name)
    fft_spectra = api.use_fft_spectra(dtype_name)
    params = EP.fft_ear_params(C.BASIC_BAND_COUNT, playback_level)
    k0 = FE.build_consts(params, dtype=dtype, spectrum_dtype=sdtype,
                         use_dft_gemm=False if fft_spectra else None,
                         accurate=api.use_accurate(dtype_name))
    avg_matrix0 = jnp.asarray(
        level_adapt.sliding_average_matrix(C.BASIC_BAND_COUNT), dtype=dtype)
    consts = (k0, avg_matrix0)

    def init_state(channels: int):
        z = C.BASIC_BAND_COUNT
        f = lambda *s: jnp.zeros(s, dtype)
        mov_sums = {name: {"all": f(channels), "committed": f(channels),
                           "all_den": f(channels), "committed_den": f(channels)}
                    for name in C.MOV_BASIC_NAMES}
        for name in ("ADBB", "MFPDB"):
            mov_sums[name] = {kk: f(1) for kk in
                              ("all", "committed", "all_den", "committed_den")}
        mov_sums["RmsNoiseLoudB 2nd"] = None  # unused in basic
        del mov_sums["RmsNoiseLoudB 2nd"]
        return {
            "smear": f(2, channels, z),
            "la": tuple(f(channels, z) for _ in range(6)),
            "mod": tuple((f(channels, z),) * 3 for _ in range(2)),
            "sums": mov_sums,
            "mfpd_filt": f(1),
            "mfpd_max_all": f(1),
            "mfpd_max_committed": f(1),
            "win_sqrts": f(channels, 3),
            "win_calls": jnp.zeros((), jnp.int32),
            "has_above": jnp.zeros((), bool),
            "frame_offset": jnp.zeros((), jnp.int32),
            "lrf": jnp.full((), np.iinfo(np.int32).max, jnp.int32),
            "signal_energy": f(),
            "noise_energy": f(),
        }

    def chunk_step(consts, state, ref_sig, test_sig):
        """Process one chunk.  ref/test_sig: [CH, (Fc+1)*1024] float32 —
        or int16 PCM, dequantized on DEVICE (channel-major layout);
        shipping int16 halves the per-chunk transfer."""
        ref_sig = framing.dequantize(ref_sig)
        test_sig = framing.dequantize(test_sig)
        k, avg_matrix = consts
        n_frames = ref_sig.shape[-1] // C.FFT_STEPSIZE - 1
        ref_blocks = framing.blocks_hop(ref_sig, n_frames)
        test_blocks = framing.blocks_hop(test_sig, n_frames)
        above = framing.above_threshold_signal(
            ref_sig.astype(sdtype), n_frames, C.FFT_FRAMESIZE,
            C.FFT_STEPSIZE)  # [Fc]

        power, unsmeared, thresh, delta_p = FE.stateless_pair_hop(
            k, ref_blocks, test_blocks)
        # transposed MOV-tail layout [2, CH, Z, F] (see models/basic.py)
        uns_t = jnp.swapaxes(unsmeared, -1, -2)
        exc, smear_new = FE.time_smear(
            k, uns_t, axis=-1, state=state["smear"], return_state=True)
        ref_e, test_e = exc[0], exc[1]
        adapted_ref, adapted_test, la_new = level_adapt.level_adapt(
            k.adapt_a, avg_matrix, ref_e, test_e, state=state["la"])
        mod_ref, avg_loud_ref, mod_ref_new = MP.modulation(
            k.adapt_a, uns_t[0], C.FFT_STEPSIZE, state=state["mod"][0])
        mod_test, _, mod_test_new = MP.modulation(
            k.adapt_a, uns_t[1], C.FFT_STEPSIZE, state=state["mod"][1])

        f_glob = state["frame_offset"] + jnp.arange(n_frames)
        loud_ref = FE.loudness(k, ref_e, axis=-2)
        loud_test = FE.loudness(k, test_e, axis=-2)
        loud_ok = jnp.any((loud_ref > 0.1) & (loud_test > 0.1), axis=-2)
        lrf = jnp.minimum(state["lrf"], jnp.where(
            jnp.any(loud_ok), f_glob[jnp.argmax(loud_ok)],
            np.iinfo(np.int32).max).astype(jnp.int32))
        md_gate = f_glob >= 24
        nl_gate = md_gate & (f_glob - 3 >= lrf)

        fm = lambda x: jnp.swapaxes(x, -1, -2)   # [CH,F] -> accum [F,CH]
        md1, md2, temp_wt = (fm(x) for x in MOVS.modulation_difference(
            k.internal_noise, mod_ref, mod_test, avg_loud_ref,
            rms_mode=False, lev_wt=100.0))
        nl = fm(MOVS.noise_loudness(
            k.internal_noise, 1.5, 0.15, 0.5, 0.0, mod_ref, mod_test,
            adapted_ref, adapted_test))
        bw_ref, bw_test, bw_valid = (
            fm(x) for x in MOVS.bandwidth(power[0], power[1],
                                          bin_idx=k.bin_idx))
        hi = k.group_bin_hi
        nmr_mean, disturbed = (fm(x) for x in MOVS.nmr(
            k.group_matrix[:hi], k.masking_difference,
            power[0][..., :hi], power[1][..., :hi],
            jnp.swapaxes(ref_e, -1, -2), delta_weighted=delta_p))
        p_bin, steps_bin = MOVS.prob_detect(
            ref_e, test_e, settings.use_floor_for_steps_above_threshold)
        ehs_val, ehs_valid = MOVS.ehs(
            power[0], power[1], thresh[0], thresh[1], settings, sdtype,
            ehs_mats=None if k.ehs_fwd is None else
            (k.ehs_fwd, k.ehs_inv_re, k.ehs_inv_im, k.ehs_fwd2),
            delta_weighted=delta_p, ehs_mask=k.ehs_mask,
            ehs_dmat=k.ehs_dmat, precision=k.dft_precision,
            ehs_zero=k.ehs_zero)
        ehs_val = fm(ehs_val)

        # --- streaming accumulation ---
        has_prev = state["has_above"]
        became = jnp.cumsum(above.astype(jnp.int32)) > 0
        active = has_prev | became               # [Fc]
        any_above = jnp.any(above)
        t_last = n_frames - 1 - jnp.argmax(above[::-1])  # valid iff any_above

        def upd(entry, num_c, den_c, gate):
            m = (active & gate)[:, None] if num_c.ndim == 2 \
                else (active & gate)
            num_c = jnp.where(m, num_c, 0.0)
            den_c = jnp.where(m, den_c, 0.0)
            pn = jnp.cumsum(num_c, axis=0)
            pd = jnp.cumsum(den_c, axis=0)
            new_all = entry["all"] + pn[-1]
            new_all_den = entry["all_den"] + pd[-1]
            new_comm = jnp.where(any_above, entry["all"] + pn[t_last],
                                 entry["committed"])
            new_comm_den = jnp.where(any_above,
                                     entry["all_den"] + pd[t_last],
                                     entry["committed_den"])
            return {"all": new_all, "committed": new_comm,
                    "all_den": new_all_den, "committed_den": new_comm_den}

        sums = dict(state["sums"])
        one = jnp.ones_like(md1)
        tgate = jnp.ones_like(above)
        sums["BandwidthRefB"] = upd(sums["BandwidthRefB"], bw_ref * bw_valid,
                                    bw_valid.astype(dtype), tgate)
        sums["BandwidthTestB"] = upd(sums["BandwidthTestB"],
                                     bw_test * bw_valid,
                                     bw_valid.astype(dtype), tgate)
        sums["TotalNMRB"] = upd(sums["TotalNMRB"], nmr_mean, one, tgate)
        sums["AvgModDiff1B"] = upd(sums["AvgModDiff1B"], md1 * temp_wt,
                                   temp_wt, md_gate)
        sums["AvgModDiff2B"] = upd(sums["AvgModDiff2B"], md2 * temp_wt,
                                   temp_wt, md_gate)
        sums["RmsNoiseLoudB"] = upd(sums["RmsNoiseLoudB"], nl * nl,
                                    one, nl_gate)
        sums["RelDistFramesB"] = upd(sums["RelDistFramesB"], disturbed, one,
                                     tgate)
        sums["EHSB"] = upd(sums["EHSB"],
                           jnp.where(ehs_valid[:, None], ehs_val, 0.0),
                           ehs_valid.astype(dtype)[:, None] * one, tgate)
        adb_gate = p_bin > 0.5
        sums["ADBB"] = upd(sums["ADBB"], steps_bin[:, None],
                           jnp.ones((n_frames, 1), dtype), adb_gate)

        # MFPD: masked IIR + running max with snapshot at t_last
        called = active  # accumulate() runs on every non-INIT frame
        a_f = jnp.where(called, 0.9, 1.0)[:, None]
        b_f = jnp.where(called, 0.1 * p_bin, 0.0)[:, None]
        from ..ops import iir
        filt = iir.linear_recurrence(a_f, b_f, axis=0,
                                     y0=state["mfpd_filt"])
        runmax = jax.lax.associative_scan(
            jnp.maximum, jnp.where(called[:, None], filt, -jnp.inf), axis=0)
        runmax = jnp.maximum(runmax, state["mfpd_max_all"])
        mfpd_max_all = runmax[-1]
        mfpd_max_committed = jnp.where(any_above, runmax[t_last],
                                       state["mfpd_max_committed"])

        # WinModDiff: sliding 4-window over *called* frames (contiguous)
        win_called = active & md_gate
        sq = jnp.sqrt(jnp.where(win_called[:, None], md1, 0.0))
        ext = jnp.concatenate([jnp.moveaxis(state["win_sqrts"], 1, 0), sq], 0)
        wsum = (ext[3:] + ext[2:-1] + ext[1:-2] + ext[:-3]) / 4.0
        contrib = wsum ** 4
        call_idx = (state["win_calls"]
                    + jnp.cumsum(win_called.astype(jnp.int32)) - 1)
        full = win_called & (call_idx >= 3)
        sums["WinModDiff1B"] = upd(sums["WinModDiff1B"], contrib, one, full)
        win_calls_new = state["win_calls"] + jnp.sum(
            win_called.astype(jnp.int32))
        # carry last 3 sqrt values of the extended sequence
        win_sqrts_new = jnp.moveaxis(ext[-3:], 0, 1)

        rhalf = ref_blocks[..., :-1, :].astype(sdtype)  # 1st half of frame f
        nhalf = rhalf - test_blocks[..., :-1, :].astype(sdtype)

        new_state = {
            "smear": smear_new,
            "la": la_new,
            "mod": (mod_ref_new, mod_test_new),
            "sums": sums,
            "mfpd_filt": filt[-1],
            "mfpd_max_all": mfpd_max_all,
            "mfpd_max_committed": mfpd_max_committed,
            "win_sqrts": win_sqrts_new,
            "win_calls": win_calls_new,
            "has_above": has_prev | any_above,
            "frame_offset": state["frame_offset"] + n_frames,
            "lrf": lrf,
            "signal_energy": state["signal_energy"] + jnp.sum(rhalf ** 2),
            "noise_energy": state["noise_energy"] + jnp.sum(nhalf ** 2),
        }
        return new_state

    def read_movs(state):
        """MOVs / DI / ODG from the current stream state (any prefix)."""
        from ..models import nn
        sums = state["sums"]

        def frac(name):
            return (sums[name]["committed"], sums[name]["committed_den"])

        vals = {}
        for name in ("BandwidthRefB", "BandwidthTestB", "AvgModDiff1B",
                     "AvgModDiff2B", "RelDistFramesB", "EHSB"):
            n_, d_ = frac(name)
            vals[name] = jnp.mean(n_ / d_)
        n_, d_ = frac("TotalNMRB")
        vals["TotalNMRB"] = jnp.mean(10.0 * jnp.log10(n_ / d_))
        for name in ("RmsNoiseLoudB", "WinModDiff1B"):
            n_, d_ = frac(name)
            vals[name] = jnp.mean(jnp.sqrt(n_ / d_))
        n_, d_ = frac("ADBB")
        vals["ADBB"] = jnp.where(
            d_[0] > 0,
            jnp.where(n_[0] == 0.0, -0.5,
                      jnp.log10(jnp.maximum(n_[0], 1e-300) / d_[0])),
            0.0)
        vals["MFPDB"] = jnp.maximum(state["mfpd_max_committed"], 0.0)[0]
        mov_vec = jnp.stack([vals[n2] for n2 in C.MOV_BASIC_NAMES])
        di = nn.di_basic(mov_vec, settings.clamp_movs)
        return mov_vec, di, nn.odg(di)

    return init_state, chunk_step, read_movs, consts


# ---------------------------------------------------------------------------
# Device-side chunk steps (advanced version: FFT path + FB path)
# ---------------------------------------------------------------------------


def _make_advanced_chunk_steps(playback_level: float, settings: C.Settings,
                               dtype_name: str):
    import jax
    import jax.numpy as jnp

    from .. import api, earparams as EP
    from ..models import level_adapt, movs as MOVS, modulation as MP
    from ..ops import fb_ear as FB, fft_ear as FE, framing

    dtype, sdtype = api.resolve_dtypes(dtype_name)
    fft_params = EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT, playback_level)
    fft_spectra = api.use_fft_spectra(dtype_name)
    kf0 = FE.build_consts(fft_params, dtype=dtype, spectrum_dtype=sdtype,
                          truncate_spectrum=True,
                          use_dft_gemm=False if fft_spectra else None,
                          accurate=api.use_accurate(dtype_name))
    fb_params = EP.fb_ear_params(playback_level)
    kb0 = FB.build_consts(
        fb_params, dtype=dtype, spectrum_dtype=sdtype,
        swap_slope=settings.swap_slope_filter_coefficients,
        accurate=api.use_accurate(dtype_name))
    avg_matrix0 = jnp.asarray(
        level_adapt.sliding_average_matrix(C.FB_BAND_COUNT), dtype=dtype)
    consts = (kf0, kb0, avg_matrix0)

    def f(*s):
        return jnp.zeros(s, dtype)

    def init_state(channels: int):
        sums = {name: {kk: f(channels) for kk in
                       ("all", "committed", "all_den", "committed_den")}
                for name in C.MOV_ADVANCED_NAMES}
        sums["RmsNoiseLoudAsymA"]["all2"] = f(channels)
        sums["RmsNoiseLoudAsymA"]["committed2"] = f(channels)
        def fb_model_state():
            # (dc_state, hp2_history, cu, masking_state) per fb_ear layout;
            # the biquad carries are REAL [CH, 2] pairs, so the state
            # pytree that crosses the jit boundary is all real
            dc = (f(channels, 2), f(channels, 2),
                  f(channels, 2), f(channels, 2))
            return (dc, f(channels, FB._HIST_LEN),
                    f(channels, C.FB_BAND_COUNT),
                    (f(channels, C.FB_BAND_COUNT, 10),   # e0 tail, [Z, I]
                     f(channels, C.FB_BAND_COUNT)))

        return {
            "sums": sums,
            # FFT path
            "smear": f(2, channels, C.ADVANCED_FFT_BAND_COUNT),
            "has_above_fft": jnp.zeros((), bool),
            # FB path
            "fb_ref": fb_model_state(),
            "fb_test": fb_model_state(),
            "la": tuple(f(channels, C.FB_BAND_COUNT) for _ in range(6)),
            "mod": tuple((f(channels, C.FB_BAND_COUNT),) * 3
                         for _ in range(2)),
            "has_above_fb": jnp.zeros((), bool),
            "frame_offset_fb": jnp.zeros((), jnp.int32),
            "lrf": jnp.full((), np.iinfo(np.int32).max, jnp.int32),
            "signal_energy": f(),
            "noise_energy": f(),
        }

    def _update(entry, num_c, den_c, gate, active, any_above, t_last,
                num2_c=None):
        m = (active & gate)
        m = m[:, None] if num_c.ndim == 2 else m
        num_c = jnp.where(m, num_c, 0.0)
        den_c = jnp.where(m, den_c, 0.0)
        pn = jnp.cumsum(num_c, axis=0)
        pd = jnp.cumsum(den_c, axis=0)
        out = {
            "all": entry["all"] + pn[-1],
            "all_den": entry["all_den"] + pd[-1],
            "committed": jnp.where(any_above, entry["all"] + pn[t_last],
                                   entry["committed"]),
            "committed_den": jnp.where(any_above,
                                       entry["all_den"] + pd[t_last],
                                       entry["committed_den"]),
        }
        if num2_c is not None:
            num2_c = jnp.where(m, num2_c, 0.0)
            p2 = jnp.cumsum(num2_c, axis=0)
            out["all2"] = entry["all2"] + p2[-1]
            out["committed2"] = jnp.where(
                any_above, entry["all2"] + p2[t_last], entry["committed2"])
        return out

    def fft_chunk_step(consts, state, ref_sig, test_sig):
        """FFT path chunk: SegmentalNMR + EHS.
        ref/test_sig: [CH, (Fc+1)*1024] channel-major (f32 or PCM16,
        dequantized on device)."""
        ref_sig = framing.dequantize(ref_sig)
        test_sig = framing.dequantize(test_sig)
        kf, kb, avg_matrix = consts
        n_frames = ref_sig.shape[-1] // C.FFT_STEPSIZE - 1
        ref_blocks = framing.blocks_hop(ref_sig, n_frames)
        test_blocks = framing.blocks_hop(test_sig, n_frames)
        above = framing.above_threshold_signal(
            ref_sig.astype(sdtype), n_frames, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
        power, unsmeared, thresh, delta_p = FE.stateless_pair_hop(
            kf, ref_blocks, test_blocks)
        # both signals' smear states are carried (checkpoint format), but
        # only the REF excitation is consumed (NMR masking)
        uns_t = jnp.swapaxes(unsmeared, -1, -2)       # [2, CH, Z, F]
        exc, smear_new = FE.time_smear(
            kf, uns_t, axis=-1, state=state["smear"], return_state=True)
        hi = kf.group_bin_hi
        fmv = lambda x: jnp.swapaxes(x, -1, -2)  # [CH,F] -> accum [F,CH]
        nmr_mean, _ = MOVS.nmr(kf.group_matrix[:hi], kf.masking_difference,
                               power[0][..., :hi], power[1][..., :hi],
                               jnp.swapaxes(exc[0], -1, -2),
                               delta_weighted=delta_p)
        nmr_mean = fmv(nmr_mean)
        ehs_val, ehs_valid = MOVS.ehs(
            power[0], power[1], thresh[0], thresh[1], settings, sdtype,
            ehs_mats=None if kf.ehs_fwd is None else
            (kf.ehs_fwd, kf.ehs_inv_re, kf.ehs_inv_im, kf.ehs_fwd2),
            delta_weighted=delta_p, ehs_mask=kf.ehs_mask,
            ehs_dmat=kf.ehs_dmat, precision=kf.dft_precision,
            ehs_zero=kf.ehs_zero)
        ehs_val = fmv(ehs_val)
        has_prev = state["has_above_fft"]
        active = has_prev | (jnp.cumsum(above.astype(jnp.int32)) > 0)
        any_above = jnp.any(above)
        t_last = n_frames - 1 - jnp.argmax(above[::-1])
        one = jnp.ones_like(nmr_mean)
        tgate = jnp.ones_like(above)
        sums = dict(state["sums"])
        sums["SegmentalNMRB"] = _update(
            sums["SegmentalNMRB"], 10.0 * jnp.log10(nmr_mean), one, tgate,
            active, any_above, t_last)
        sums["EHSB"] = _update(
            sums["EHSB"], jnp.where(ehs_valid[:, None], ehs_val, 0.0),
            ehs_valid.astype(dtype)[:, None] * one, tgate, active, any_above,
            t_last)
        rhalf = ref_blocks[..., :-1, :].astype(sdtype)  # 1st half of frame f
        nhalf = rhalf - test_blocks[..., :-1, :].astype(sdtype)
        new_state = dict(state)
        new_state.update(
            sums=sums, smear=smear_new, has_above_fft=has_prev | any_above,
            signal_energy=state["signal_energy"] + jnp.sum(rhalf ** 2),
            noise_energy=state["noise_energy"] + jnp.sum(nhalf ** 2))
        return new_state

    def fb_chunk_step(consts, state, ref_sig, test_sig):
        """FB path chunk: RmsModDiffA / RmsNoiseLoudAsymA / AvgLinDistA.
        ref/test_sig: [CH, Fc*192] channel-major (f32 or PCM16,
        dequantized on device)."""
        ref_sig = framing.dequantize(ref_sig)
        test_sig = framing.dequantize(test_sig)
        kf, kb, avg_matrix = consts
        n_fb = ref_sig.shape[-1] // C.FB_FRAMESIZE
        above = framing.above_threshold_signal(
            ref_sig.astype(sdtype), n_fb, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
        ref_e, ref_u, fb_ref_new = FB.process_signal(
            kb, ref_sig.astype(sdtype), n_fb,
            state["fb_ref"], True)                # [CH, Z, F] transposed
        test_e, test_u, fb_test_new = FB.process_signal(
            kb, test_sig.astype(sdtype), n_fb,
            state["fb_test"], True)
        adapted_ref, adapted_test, la_new = level_adapt.level_adapt(
            kb.adapt_a, avg_matrix, ref_e, test_e, state=state["la"])
        mod_ref, avg_loud_ref, mod_ref_new = MP.modulation(
            kb.adapt_a, ref_u, C.FB_FRAMESIZE, state=state["mod"][0])
        mod_test, _, mod_test_new = MP.modulation(
            kb.adapt_a, test_u, C.FB_FRAMESIZE, state=state["mod"][1])

        f_glob = state["frame_offset_fb"] + jnp.arange(n_fb)
        loud_ref = FB.loudness(kb, ref_e, axis=-2)
        loud_test = FB.loudness(kb, test_e, axis=-2)
        loud_ok = jnp.any((loud_ref > 0.1) & (loud_test > 0.1), axis=-2)
        lrf = jnp.minimum(state["lrf"], jnp.where(
            jnp.any(loud_ok), f_glob[jnp.argmax(loud_ok)],
            np.iinfo(np.int32).max).astype(jnp.int32))
        md_gate = f_glob >= 125
        nl_gate = md_gate & (f_glob - 13 >= lrf)

        fm = lambda x: jnp.swapaxes(x, -1, -2)   # [CH,F] -> accum [F,CH]
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

        has_prev = state["has_above_fb"]
        active = has_prev | (jnp.cumsum(above.astype(jnp.int32)) > 0)
        any_above = jnp.any(above)
        t_last = n_fb - 1 - jnp.argmax(above[::-1])
        one = jnp.ones_like(md1)
        sums = dict(state["sums"])
        # MODE_RMS accumulates w^2*v^2 / w^2; src/movaccum.c:375-378
        sums["RmsModDiffA"] = _update(
            sums["RmsModDiffA"], temp_wt * temp_wt * md1 * md1,
            temp_wt * temp_wt, md_gate, active, any_above, t_last)
        sums["RmsNoiseLoudAsymA"] = _update(
            sums["RmsNoiseLoudAsymA"], nl_asym * nl_asym, one, nl_gate,
            active, any_above, t_last, num2_c=missing * missing)
        sums["AvgLinDistA"] = _update(
            sums["AvgLinDistA"], lin_dist, one, nl_gate, active, any_above,
            t_last)

        new_state = dict(state)
        new_state.update(
            sums=sums, fb_ref=fb_ref_new, fb_test=fb_test_new, la=la_new,
            mod=(mod_ref_new, mod_test_new),
            has_above_fb=has_prev | any_above,
            frame_offset_fb=state["frame_offset_fb"] + n_fb, lrf=lrf)
        return new_state

    def read_movs(state):
        from ..models import nn
        sums = state["sums"]

        def frac(name):
            return sums[name]["committed"], sums[name]["committed_den"]

        vals = {}
        n_, d_ = frac("SegmentalNMRB")
        vals["SegmentalNMRB"] = jnp.mean(n_ / d_)
        n_, d_ = frac("EHSB")
        vals["EHSB"] = jnp.mean(n_ / d_)
        n_, d_ = frac("RmsModDiffA")
        vals["RmsModDiffA"] = jnp.mean(jnp.sqrt(n_ / d_))
        n_, d_ = frac("AvgLinDistA")
        vals["AvgLinDistA"] = jnp.mean(n_ / d_)
        e = sums["RmsNoiseLoudAsymA"]
        vals["RmsNoiseLoudAsymA"] = jnp.mean(
            jnp.sqrt(e["committed"] / e["committed_den"])
            + 0.5 * jnp.sqrt(e["committed2"] / e["committed_den"]))
        mov_vec = jnp.stack([vals[n2] for n2 in C.MOV_ADVANCED_NAMES])
        di = nn.di_advanced(mov_vec, settings.clamp_movs)
        return mov_vec, di, nn.odg(di)

    return init_state, fft_chunk_step, fb_chunk_step, read_movs, consts


# ---------------------------------------------------------------------------
# Host-side stream driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamResult:
    odg: float
    di: float
    movs: dict[str, float]


class PeaqStream:
    """Streaming basic-PEAQ evaluator with O(1) memory in program length.

    feed() accepts arbitrary-length [T, CH] float32 chunks for both signals;
    current() returns the ODG of everything fed so far (the reference's
    query-at-any-time property); finalize() flushes the trailing partial
    frame (src/gstpeaq.c:715-745) and returns the final result.

    The device state is an explicit pytree: checkpoint/resume is
    `state = stream.state` / orbax save + restore.
    """

    def __init__(self, channels: int = 2, chunk_frames: int = 64,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None):
        import jax

        from .. import api
        dtype = dtype or api.default_dtype()
        init_state, chunk_step, read_movs, consts = _make_basic_chunk_step(
            playback_level, settings, dtype)
        self._channels = channels
        self._chunk_frames = chunk_frames
        self._chunk_samples = chunk_frames * C.FFT_STEPSIZE
        self.state = init_state(channels)
        _jstep = jax.jit(chunk_step)
        self._step = lambda *args: _jstep(consts, *args)
        self._read = jax.jit(read_movs)
        self._buf_ref = np.zeros((0, channels), np.float32)
        self._buf_test = np.zeros((0, channels), np.float32)
        self._finalized = False

    def feed(self, ref: np.ndarray, test: np.ndarray) -> None:
        from .batch import as_2d_ship
        assert not self._finalized
        r, t = as_2d_ship(ref), as_2d_ship(test)   # int16 ships raw
        self._buf_ref = _cat_ship(self._buf_ref, r)
        self._buf_test = _cat_ship(self._buf_test, t)
        self._drain()

    def _drain(self) -> None:
        need = self._chunk_samples + C.FFT_STEPSIZE  # frames overlap by 1024
        while (self._buf_ref.shape[0] >= need
               and self._buf_test.shape[0] >= need):
            take = self._chunk_samples + C.FFT_STEPSIZE
            r = self._buf_ref[:take]
            t = self._buf_test[:take]
            self.state = self._step(self.state, _cm(r), _cm(t))
            # keep the trailing step for the next chunk's first frame overlap
            self._buf_ref = self._buf_ref[self._chunk_samples:]
            self._buf_test = self._buf_test[self._chunk_samples:]

    def current(self) -> StreamResult:
        movs, di, odg = self._read(self.state)
        movs = np.asarray(movs)
        return StreamResult(
            odg=float(odg), di=float(di),
            movs={n: float(v) for n, v in zip(C.MOV_BASIC_NAMES, movs)})

    def finalize(self) -> StreamResult:
        """Process remaining full frames + the zero-padded flush frame."""
        if not self._finalized:
            from ..ops import framing
            n_rest = framing.num_frames(
                self._buf_ref.shape[0], self._buf_test.shape[0],
                C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
            if n_rest > 0:
                r = framing.pad_signal(self._buf_ref, n_rest,
                                       C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
                t = framing.pad_signal(self._buf_test, n_rest,
                                       C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
                self.state = self._step(self.state, _cm(r), _cm(t))
            self._buf_ref = self._buf_ref[:0]
            self._buf_test = self._buf_test[:0]
            self._finalized = True
        return self.current()


class PeaqStreamAdvanced:
    """Streaming advanced-PEAQ evaluator: two sub-streams (FFT path at
    2048/1024, filter-bank path at 192/192) with independent buffering, as
    the reference's four GstAdapters (src/gstpeaq.c:117-120,645-652)."""

    def __init__(self, channels: int = 2, chunk_frames: int = 64,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None):
        import jax

        from .. import api
        dtype = dtype or api.default_dtype()
        (init_state, fft_step, fb_step, read_movs,
         consts) = _make_advanced_chunk_steps(playback_level, settings, dtype)
        self._channels = channels
        self._fft_chunk = chunk_frames * C.FFT_STEPSIZE
        self._fb_frames = chunk_frames * 16  # ~same audio span
        self.state = init_state(channels)
        _jfft = jax.jit(fft_step)
        _jfb = jax.jit(fb_step)
        self._fft_step = lambda *args: _jfft(consts, *args)
        self._fb_step = lambda *args: _jfb(consts, *args)
        self._read = jax.jit(read_movs)
        z = np.zeros((0, channels), np.float32)
        self._fft_buf = [z, z.copy()]
        self._fb_buf = [z.copy(), z.copy()]
        self._finalized = False

    def feed(self, ref, test) -> None:
        from .batch import as_2d_ship
        assert not self._finalized
        r, t = as_2d_ship(ref), as_2d_ship(test)   # int16 ships raw
        self._fft_buf = [_cat_ship(self._fft_buf[0], r),
                         _cat_ship(self._fft_buf[1], t)]
        self._fb_buf = [_cat_ship(self._fb_buf[0], r),
                        _cat_ship(self._fb_buf[1], t)]
        self._drain()

    def _drain(self) -> None:
        need = self._fft_chunk + C.FFT_STEPSIZE
        while min(b.shape[0] for b in self._fft_buf) >= need:
            self.state = self._fft_step(self.state,
                                        _cm(self._fft_buf[0][:need]),
                                        _cm(self._fft_buf[1][:need]))
            self._fft_buf = [b[self._fft_chunk:] for b in self._fft_buf]
        need_fb = self._fb_frames * C.FB_FRAMESIZE
        while min(b.shape[0] for b in self._fb_buf) >= need_fb:
            self.state = self._fb_step(self.state,
                                       _cm(self._fb_buf[0][:need_fb]),
                                       _cm(self._fb_buf[1][:need_fb]))
            self._fb_buf = [b[need_fb:] for b in self._fb_buf]

    def current(self) -> StreamResult:
        movs, di, odg = self._read(self.state)
        movs = np.asarray(movs)
        return StreamResult(
            odg=float(odg), di=float(di),
            movs={n: float(v) for n, v in zip(C.MOV_ADVANCED_NAMES, movs)})

    def finalize(self) -> StreamResult:
        if not self._finalized:
            from ..ops import framing
            n_fft = framing.num_frames(
                self._fft_buf[0].shape[0], self._fft_buf[1].shape[0],
                C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
            if n_fft > 0:
                r = framing.pad_signal(self._fft_buf[0], n_fft,
                                       C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
                t = framing.pad_signal(self._fft_buf[1], n_fft,
                                       C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
                self.state = self._fft_step(self.state, _cm(r), _cm(t))
            n_fb = framing.num_frames(
                self._fb_buf[0].shape[0], self._fb_buf[1].shape[0],
                C.FB_FRAMESIZE, C.FB_FRAMESIZE)
            if n_fb > 0:
                r = framing.pad_signal(self._fb_buf[0], n_fb,
                                       C.FB_FRAMESIZE, C.FB_FRAMESIZE)
                t = framing.pad_signal(self._fb_buf[1], n_fb,
                                       C.FB_FRAMESIZE, C.FB_FRAMESIZE)
                self.state = self._fb_step(self.state, _cm(r), _cm(t))
            z = np.zeros((0, self._channels), np.float32)
            self._fft_buf = [z, z.copy()]
            self._fb_buf = [z.copy(), z.copy()]
            self._finalized = True
        return self.current()


# ---------------------------------------------------------------------------
# Lockstep stream pool: N concurrent streams, one vmapped program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoolResult:
    """Per-stream results: odg/di are [N] float arrays; movs maps MOV
    name -> [N] float array."""
    odg: np.ndarray
    di: np.ndarray
    movs: dict[str, np.ndarray]


class PeaqStreamPool:
    """N concurrent long-form streams advanced in lockstep by ONE vmapped
    chunk program — the production serving shape for long programs: a
    single stream leaves the device nearly idle (batch-1 GEMMs) and pays
    a dispatch per chunk, while a pool amortizes both across N streams
    (vmap adds a leading batch dim to every stage, including the Pallas
    kernel).

    Same chunk-step closures and carried-state semantics as PeaqStream /
    PeaqStreamAdvanced (INIT/tentative aggregates, complex-free pytree);
    the state simply gains a leading [N] axis, so it remains
    checkpointable with utils/checkpoint (same STATE_FORMAT_VERSION).

    Lockstep means every feed() advances ALL streams by the same sample
    count: ref/test are [N, T] or [N, T, CH].  Streams with genuinely
    different lengths belong in separate pools (or pad the short ones
    and read current() before their tails — validity gating is per
    accumulated frame, exactly as in the scalar classes).

    `mesh`: an optional jax.sharding.Mesh — the stream axis shards over
    its first axis (pure data parallelism: streams are independent, so
    XLA partitions every stage locally with no metric-path collectives,
    exactly like the codec-sweep sharding in parallel/shard.py).  State,
    chunk operands, and reads all carry the sharding; n_streams must be
    a multiple of the mesh size.
    """

    def __init__(self, n_streams: int, channels: int = 2,
                 chunk_frames: int = 64, playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None, advanced: bool = False,
                 mesh=None):
        import jax
        import jax.numpy as jnp

        from .. import api
        dtype = dtype or api.default_dtype()
        self._n = n_streams
        self._channels = channels
        self._advanced = advanced
        vm = functools.partial(jax.vmap, in_axes=(None, 0, 0, 0))
        if advanced:
            (init_state, fft_step, fb_step, read_movs,
             consts) = _make_advanced_chunk_steps(playback_level, settings,
                                                  dtype)
            jfft, jfb = jax.jit(vm(fft_step)), jax.jit(vm(fb_step))
            self._steps = (lambda *a: jfft(consts, *a),
                           lambda *a: jfb(consts, *a))
            self._fft_chunk = chunk_frames * C.FFT_STEPSIZE
            self._fb_samples = chunk_frames * 16 * C.FB_FRAMESIZE
            self._mov_names = C.MOV_ADVANCED_NAMES
        else:
            (init_state, chunk_step, read_movs,
             consts) = _make_basic_chunk_step(playback_level, settings,
                                              dtype)
            jstep = jax.jit(vm(chunk_step))
            self._steps = (lambda *a: jstep(consts, *a),)
            self._fft_chunk = chunk_frames * C.FFT_STEPSIZE
            self._fb_samples = None
            self._mov_names = C.MOV_BASIC_NAMES
        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            assert n_streams % mesh.devices.size == 0, \
                (n_streams, mesh.devices.size)
            axis = mesh.axis_names[0]

            def _put(x):
                spec = P(axis, *([None] * (np.ndim(x) - 1)))
                return jax.device_put(x, NamedSharding(mesh, spec))
            self._put = _put
        else:
            self._put = None
        one = init_state(channels)
        # broadcast-COPY the scalar initial state to [N, ...]: init values
        # are not all zero (NaN-primed warmup windows), so no jnp.zeros
        self.state = jax.tree.map(
            lambda x: jnp.tile(jnp.asarray(x)[None],
                               (n_streams,) + (1,) * jnp.ndim(x)), one)
        if self._put is not None:
            self.state = jax.tree.map(lambda x: self._put(np.asarray(x)),
                                      self.state)
        self._read = jax.jit(jax.vmap(read_movs))
        self._buf = [np.zeros((n_streams, 0, channels), np.float32)
                     for _ in range(2 if not advanced else 4)]
        self._finalized = False

    def _as3(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.dtype != np.int16:                 # int16 PCM ships raw
            x = x.astype(np.float32, copy=False)
        if x.ndim == 2:
            x = x[:, :, None]
        assert x.shape[0] == self._n and x.shape[2] == self._channels, \
            x.shape
        return x

    def feed(self, ref, test) -> None:
        assert not self._finalized
        r, t = self._as3(ref), self._as3(test)
        if r.shape[1] != t.shape[1]:
            raise ValueError(
                f"PeaqStreamPool.feed is lockstep: ref and test must carry "
                f"the same sample count per feed (got {r.shape[1]} vs "
                f"{t.shape[1]}); use scalar PeaqStream for skewed feeds")
        if self._advanced:
            self._buf = [_cat_ship(b, x)
                         for b, x in zip(self._buf, (r, t, r, t))]
        else:
            self._buf = [_cat_ship(b, x)
                         for b, x in zip(self._buf, (r, t))]
        self._drain()

    @staticmethod
    def _cm3(x: np.ndarray) -> np.ndarray:
        """[N, T, CH] -> contiguous [N, CH, T]."""
        return np.ascontiguousarray(np.swapaxes(x, 1, 2))

    def _ship(self, x: np.ndarray):
        """Chunk operand to device: an explicit put; with a mesh, the put
        shards the stream axis directly."""
        import jax
        cm = self._cm3(x)
        return self._put(cm) if self._put is not None else jax.device_put(cm)

    def _drain(self) -> None:
        need = self._fft_chunk + C.FFT_STEPSIZE
        step = self._steps[0]
        while self._buf[0].shape[1] >= need:
            self.state = step(self.state, self._ship(self._buf[0][:, :need]),
                              self._ship(self._buf[1][:, :need]))
            self._buf[0] = self._buf[0][:, self._fft_chunk:]
            self._buf[1] = self._buf[1][:, self._fft_chunk:]
        if not self._advanced:
            return
        fb = self._steps[1]
        while self._buf[2].shape[1] >= self._fb_samples:
            self.state = fb(
                self.state,
                self._ship(self._buf[2][:, :self._fb_samples]),
                self._ship(self._buf[3][:, :self._fb_samples]))
            self._buf[2] = self._buf[2][:, self._fb_samples:]
            self._buf[3] = self._buf[3][:, self._fb_samples:]

    def current(self) -> PoolResult:
        movs, di, odg = self._read(self.state)
        movs = np.asarray(movs)                      # [N, M]
        return PoolResult(
            odg=np.asarray(odg), di=np.asarray(di),
            movs={n: movs[:, i] for i, n in enumerate(self._mov_names)})

    def _flush(self, ib: int, step, frame: int, hop: int) -> None:
        from ..ops import framing
        t_len = self._buf[ib].shape[1]
        n_rest = framing.num_frames(t_len, t_len, frame, hop)
        if n_rest > 0:
            length = framing.padded_length(n_rest, frame, hop)
            pad = [(0, 0), (0, max(0, length - t_len)), (0, 0)]
            r = np.pad(self._buf[ib], pad)[:, :length]
            t = np.pad(self._buf[ib + 1], pad)[:, :length]
            self.state = step(self.state, self._ship(r), self._ship(t))
        empty = self._buf[ib][:, :0]
        self._buf[ib] = empty
        self._buf[ib + 1] = empty.copy()

    def finalize(self) -> PoolResult:
        """Process remaining full frames + the zero-padded flush frame
        (lockstep: every stream flushes at the same boundary)."""
        if not self._finalized:
            self._flush(0, self._steps[0], C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
            if self._advanced:
                self._flush(2, self._steps[1], C.FB_FRAMESIZE,
                            C.FB_FRAMESIZE)
            self._finalized = True
        return self.current()
