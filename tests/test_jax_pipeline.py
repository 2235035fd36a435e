"""JAX pipeline vs the NumPy spec implementation (and reference goldens).

The NumPy implementation in gstpeaq_jax.utils.numpy_ref is itself gated
against the C reference's golden vectors and pinned ODGs (test_numpy_ref);
here the vectorized/scanned JAX pipeline is held to near-machine agreement
with that spec.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gstpeaq_jax import api
from gstpeaq_jax import constants as C
from gstpeaq_jax import earparams as EP
from gstpeaq_jax.ops import fb_ear as FB
from gstpeaq_jax.ops import fft_ear as FE
from gstpeaq_jax.utils import numpy_ref as R
from gstpeaq_jax.utils import testsignals as TS


def rel_err(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return np.max(np.abs(got - want) / (np.abs(want) + 1e-300))


def test_fft_ear_matches_spec():
    p = EP.fft_ear_params(109)
    k = FE.build_consts(p)
    rng = np.random.default_rng(1)
    f1 = np.zeros(2048, dtype=np.float32)
    f1[:1024] = -1
    f1[1025:] = 1
    frames = np.stack([f1] + [
        rng.standard_normal(2048).astype(np.float32) * 0.1 for _ in range(5)])
    power, weighted, unsmeared, thr = FE.stateless(k, jnp.asarray(frames))
    exc = FE.time_smear(k, unsmeared, axis=0)
    st = R.FFTEarState(109)
    for i in range(len(frames)):
        R.fft_ear_process_block(p, st, frames[i])
        assert rel_err(power[i], st.power_spectrum) < 1e-9
        assert rel_err(weighted[i], st.weighted_power_spectrum) < 1e-9
        assert rel_err(unsmeared[i], st.unsmeared_excitation) < 1e-9
        assert rel_err(exc[i], st.excitation) < 1e-9
        assert bool(thr[i]) == st.energy_threshold_reached


def test_fb_ear_matches_spec():
    p = EP.fb_ear_params()
    k = FB.build_consts(p)
    rng = np.random.default_rng(3)
    n_frames = 9
    x = (rng.standard_normal(192 * n_frames) * 0.3).astype(np.float32)
    exc_np, uns_np = R.fb_process_signal(p, x)
    # process_signal returns the transposed MOV-tail layout [Z, F]
    exc, uns = FB.process_signal(k, jnp.asarray(x, jnp.float64), n_frames)
    assert rel_err(np.asarray(exc).T, exc_np) < 1e-7
    assert rel_err(np.asarray(uns).T, uns_np) < 1e-7


def test_fb_spread_t_matches_spread():
    """spread_t (transposed [Z, I] layout, instants-last slope-filter
    recurrence) must equal spread to near machine precision, including
    streaming state."""
    p = EP.fb_ear_params()
    k = FB.build_consts(p)
    rng = np.random.default_rng(7)
    n_inst = 124
    for state in (None, jnp.asarray(np.abs(rng.standard_normal(40)))):
        re = rng.standard_normal((n_inst, 40)) * 1e3
        im = rng.standard_normal((n_inst, 40)) * 1e3
        e0_ref, cu_ref = FB.spread(k, jnp.asarray(re), jnp.asarray(im),
                                   state, True)
        e0_t, cu_t = FB.spread_t(k, jnp.asarray(re.T), jnp.asarray(im.T),
                                 state, True)
        assert rel_err(np.asarray(e0_t).T, e0_ref) < 1e-13
        assert rel_err(cu_t, cu_ref) < 1e-13


def test_fb_ear_mixed_precision_runs():
    """Mixed (f32 samples / f64 bands) FB path: dtype promotion regression —
    a strong-typed np.float64 biquad gain used to promote the f32 conv input
    to f64 and crash conv_general_dilated."""
    p = EP.fb_ear_params()
    k = FB.build_consts(p, dtype=jnp.float64, spectrum_dtype=jnp.float32)
    rng = np.random.default_rng(3)
    n_frames = 9
    x = (rng.standard_normal(192 * n_frames) * 0.3).astype(np.float32)
    exc_np, _ = R.fb_process_signal(p, x)
    exc, _ = FB.process_signal(k, jnp.asarray(x, jnp.float32), n_frames)
    assert exc.dtype == jnp.float64  # band domain stays wide
    assert rel_err(np.asarray(exc).T, exc_np) < 5e-2  # f32 front end


def test_fb_loudness_golden():
    k = FB.build_consts(EP.fb_ear_params())
    scale = 10 ** ((40 - 92) / 20)
    sig = (scale * np.sin(2 * np.pi * 1000 / 48000 * np.arange(250 * 192)))
    exc, _ = FB.process_signal(k, jnp.asarray(sig, jnp.float64), 250)
    loud = float(FB.loudness(k, exc[..., -1]))   # last frame, [Z]
    assert 1.03 < loud < 1.04


def test_basic_pipeline_matches_spec_noisy():
    rng = np.random.default_rng(7)
    n = 30 * 1024
    ref = (0.5 * TS.sine(n, 440)
           + 0.05 * rng.standard_normal(n).astype(np.float32))
    test = ref + 0.02 * rng.standard_normal(n).astype(np.float32)
    ref[-6000:] = 0
    test[-6000:] = 0
    want = R.peaq_basic(ref, test)
    got = api.peaq(ref, test)
    for name in C.MOV_BASIC_NAMES:
        w, g = want.movs[name], got.movs[name]
        if np.isnan(w):
            assert np.isnan(g), name
        else:
            assert abs(g - w) <= 1e-8 * (1 + abs(w)), (name, g, w)


@pytest.mark.slow
def test_basic_pipeline_pinned_odgs():
    n = 128 * 1024
    s = TS.sine(n)
    assert f"{api.peaq(s, s).odg:.3f}" == "0.171"
    res = api.peaq(TS.saw(n), TS.triangle(n))
    assert f"{res.odg:.3f}" == "-2.007"


@pytest.mark.slow
def test_advanced_pipeline_matches_spec():
    n = 64 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    want = R.peaq_advanced(sa, tr)
    got = api.peaq(sa, tr, advanced=True)
    for name in C.MOV_ADVANCED_NAMES:
        w, g = want.movs[name], got.movs[name]
        assert abs(g - w) <= 1e-7 * (1 + abs(w)), (name, g, w)
    assert abs(got.odg - want.odg) < 1e-9


def test_advanced_unified_input_poisoned_tail():
    """The unified raw-input wrapper (models/advanced.unified_input) ships
    ONE signal array truncated at min(Tmax, T_signal) — NOT at each path's
    own flush boundary — so frames past a pair's flush frame carry real
    audio instead of zeros and must be excluded by the valid masks alone.
    Unequal, non-frame-aligned lengths maximize the poisoned tail (the
    longer signal's audio fills frames the shorter one never reaches)."""
    rng = np.random.default_rng(23)
    n_ref, n_test = 40 * 1024 + 777, 38 * 1024 + 123
    ref = (0.5 * TS.sine(n_ref, 440)
           + 0.05 * rng.standard_normal(n_ref).astype(np.float32))
    test = (ref[:n_test] + 0.02
            * rng.standard_normal(n_test).astype(np.float32))
    want = R.peaq_advanced(ref, test)
    got = api.peaq(ref, test, advanced=True)
    for name in C.MOV_ADVANCED_NAMES:
        w, g = want.movs[name], got.movs[name]
        assert abs(g - w) <= 1e-7 * (1 + abs(w)), (name, g, w)
    assert abs(got.odg - want.odg) < 1e-9


def test_accurate_tier_runs_both_modes(monkeypatch):
    """The "accurate" precision tier (the DENSE rDFT with every front-end
    GEMM pinned to HIGHEST, api.use_accurate) must build and, on CPU —
    where precision hints are no-ops — agree EXACTLY with the float32 tier
    (identical arithmetic: pure wiring test; its accuracy on the device
    is measured by tools/drift.py and chip_smoke.py).  The CT path stays
    forceable via GSTPEAQ_CT_DFT=1 and agrees to the CT-vs-dense
    arithmetic delta only."""
    from gstpeaq_jax.ops import fft_ear
    n = 30 * 1024
    ref, test = TS.saw(n), TS.triangle(n)
    acc = {}
    for adv in (False, True):
        a = api.peaq(ref, test, advanced=adv, dtype="accurate")
        f = api.peaq(ref, test, advanced=adv, dtype="float32")
        assert np.isfinite(a.odg)
        # same arithmetic on CPU (precision hints only act on the GPU)
        assert abs(a.odg - f.odg) < 1e-9, (adv, a.odg, f.odg)
        acc[adv] = a.odg
    # the CT A/B path still builds and runs: reassociated arithmetic
    monkeypatch.setattr(fft_ear, "USE_CT_DFT", True)
    api._jitted_basic.cache_clear()
    api._jitted_advanced.cache_clear()
    try:
        for adv in (False, True):
            f = api.peaq(ref, test, advanced=adv, dtype="float32")
            assert abs(acc[adv] - f.odg) < 1e-4, (adv, acc[adv], f.odg)
    finally:
        # drop the CT-forced programs so later tests rebuild defaults
        api._jitted_basic.cache_clear()
        api._jitted_advanced.cache_clear()


def test_stereo_channel_averaging():
    n = 30 * 1024
    sa, tr = TS.saw(n), TS.triangle(n)
    mono = api.peaq(sa, tr)
    stereo = api.peaq(np.stack([sa, sa], 1), np.stack([tr, tr], 1))
    # duplicated channels must give the same ODG as mono
    assert abs(mono.odg - stereo.odg) < 1e-9


def test_unified_threshold_gates_match_flat():
    """One sliding-max pass (framing.sliding_max5_blocked) must reproduce
    BOTH ear models' data-boundary gates exactly, including quiet spans
    and hop-boundary windows."""
    from gstpeaq_jax.ops import framing
    rng = np.random.default_rng(13)
    n_fft, n_fb = 32, 176            # t_fft = 33792 > t_fb = 33792 equal? no
    t_fft = (n_fft + 1) * 1024       # 33792
    t_fb = n_fb * 192                # 33792
    t = max(t_fft, t_fb)
    x = (rng.standard_normal((2, t)) * 1e-3).astype(np.float32)
    x[:, 5000:12000] = 0.0           # quiet span -> gate transitions
    x[:, 20000:20200] *= 100.0
    m = framing.sliding_max5_blocked(jnp.asarray(x.reshape(2, -1, 128)))
    got_fft = framing.fft_gate_from_max5(m, n_fft)
    got_fb = framing.fb_gate_from_max5(m[..., :t_fb // 128, :], n_fb)
    want_fft = framing.above_threshold_signal(
        jnp.asarray(x[:, :t_fft]), n_fft, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    want_fb = framing.above_threshold_signal(
        jnp.asarray(x[:, :t_fb]), n_fb, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    np.testing.assert_array_equal(np.asarray(got_fft), np.asarray(want_fft))
    np.testing.assert_array_equal(np.asarray(got_fb), np.asarray(want_fb))


def test_unified_threshold_gates_match_flat_hops():
    """The HOP-layout [.., Tq, 1024] gate forms (the r5 ship layout whose
    rows are the rDFT's hop blocks) must reproduce both ear models' flat
    data-boundary gates exactly as well."""
    from gstpeaq_jax.ops import framing
    rng = np.random.default_rng(13)
    n_fft, n_fb = 32, 176            # t_fft == t_fb == 33792 == 33 * 1024
    t_fft = (n_fft + 1) * 1024
    t_fb = n_fb * 192
    t = max(t_fft, t_fb)
    x = (rng.standard_normal((2, t)) * 1e-3).astype(np.float32)
    x[:, 5000:12000] = 0.0           # quiet span -> gate transitions
    x[:, 20000:20200] *= 100.0
    m = framing.sliding_max5_blocked(jnp.asarray(x.reshape(2, -1, 1024)))
    got_fft = framing.fft_gate_from_max5_hops(m, n_fft)
    got_fb = framing.fb_gate_from_max5_hops(m[..., :t_fb // 1024, :], n_fb)
    want_fft = framing.above_threshold_signal(
        jnp.asarray(x[:, :t_fft]), n_fft, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    want_fb = framing.above_threshold_signal(
        jnp.asarray(x[:, :t_fb]), n_fb, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    np.testing.assert_array_equal(np.asarray(got_fft), np.asarray(want_fft))
    np.testing.assert_array_equal(np.asarray(got_fb), np.asarray(want_fb))


def test_unified_threshold_gates_chunk_form_matches():
    """The chunk-reduced gate forms (framing.sliding_max5_chunks — the
    producing pass emits per-64-lane maxima so the sample-rate max5
    never materializes) must give identical decisions to the max5 hop
    forms AND the flat reference on the same signal."""
    from gstpeaq_jax.ops import framing
    rng = np.random.default_rng(13)
    n_fft, n_fb = 32, 176            # t_fft == t_fb == 33792 == 33 * 1024
    t_fft = (n_fft + 1) * 1024
    t_fb = n_fb * 192
    t = max(t_fft, t_fb)
    x = (rng.standard_normal((2, t)) * 1e-3).astype(np.float32)
    x[:, 5000:12000] = 0.0           # quiet span -> gate transitions
    x[:, 20000:20200] *= 100.0
    xb = jnp.asarray(x.reshape(2, -1, 1024))
    cm, cm5 = framing.sliding_max5_chunks(xb)
    got_fft = framing.fft_gate_from_chunks(cm, cm5, n_fft)
    rows_fb = t_fb // 1024
    got_fb = framing.fb_gate_from_chunks(
        cm[..., :rows_fb, :], cm5[..., :rows_fb, :], n_fb)
    m = framing.sliding_max5_blocked(xb)
    np.testing.assert_array_equal(
        np.asarray(got_fft),
        np.asarray(framing.fft_gate_from_max5_hops(m, n_fft)))
    np.testing.assert_array_equal(
        np.asarray(got_fb),
        np.asarray(framing.fb_gate_from_max5_hops(m[..., :rows_fb, :],
                                                  n_fb)))
    want_fft = framing.above_threshold_signal(
        jnp.asarray(x[:, :t_fft]), n_fft, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
    want_fb = framing.above_threshold_signal(
        jnp.asarray(x[:, :t_fb]), n_fb, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
    np.testing.assert_array_equal(np.asarray(got_fft), np.asarray(want_fft))
    np.testing.assert_array_equal(np.asarray(got_fb), np.asarray(want_fb))


def test_blocked_fb_input_matches_flat():
    """The blocked [CH, T/128, 128] FB input layout (host-shipped for the
    Pallas DC fast path) must reproduce the flat [CH, T] path exactly:
    process_signal and the data-boundary threshold test."""
    import jax.numpy as jnp
    from gstpeaq_jax.ops import fb_ear as FB, framing

    p = EP.fb_ear_params()
    k = FB.build_consts(p)
    rng = np.random.default_rng(11)
    n_frames = 256                   # T = 49152 = 128 * 384, Pallas-aligned
    t = 192 * n_frames
    x = (rng.standard_normal((2, t)) * 0.3).astype(np.float64)
    x[:, t // 2:] *= 1e-6
    exc_f, uns_f = FB.process_signal(k, jnp.asarray(x), n_frames)
    exc_b, uns_b = FB.process_signal(
        k, jnp.asarray(x.reshape(2, -1, 128)), n_frames, blocked=True)
    np.testing.assert_array_equal(np.asarray(exc_f), np.asarray(exc_b))
    np.testing.assert_array_equal(np.asarray(uns_f), np.asarray(uns_b))

    thr_f = framing.above_threshold_signal(
        jnp.asarray(x, jnp.float32), n_frames, 192, 192)
    thr_b = framing.above_threshold_blocked(
        jnp.asarray(x.reshape(2, -1, 128), jnp.float32), n_frames)
    np.testing.assert_array_equal(np.asarray(thr_f), np.asarray(thr_b))
