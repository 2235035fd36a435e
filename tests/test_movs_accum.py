"""Module-level MOV + accumulator tests against the NumPy spec."""

import numpy as np
import jax.numpy as jnp

from gstpeaq_jax import constants as C
from gstpeaq_jax import earparams as EP
from gstpeaq_jax.models import accum, movs as MOVS
from gstpeaq_jax.ops import fft_ear as FE
from gstpeaq_jax.utils import numpy_ref as R

RNG = np.random.default_rng(12)


def test_noise_loudness_kernel():
    p = EP.fft_ear_params(109)
    mr = np.abs(RNG.standard_normal((5, 109))) * 2
    mt = np.abs(RNG.standard_normal((5, 109))) * 2
    er = np.abs(RNG.standard_normal((5, 109))) * 1e3 + 1
    et = er * (1 + 0.1 * RNG.standard_normal((5, 109)))
    # transposed MOV-tail layout: [Z, F]
    got = np.asarray(MOVS.noise_loudness(
        jnp.asarray(p.internal_noise), 1.5, 0.15, 0.5, 0.0,
        jnp.asarray(mr.T), jnp.asarray(mt.T),
        jnp.asarray(er.T), jnp.asarray(et.T)))
    for i in range(5):
        want = R.calc_noise_loudness(p, 1.5, 0.15, 0.5, 0.0, mr[i], mt[i],
                                     er[i], et[i])
        assert abs(got[i] - want) < 1e-10 * (1 + abs(want))


def test_bandwidth_matches_spec():
    spectra_r = np.abs(RNG.standard_normal((6, 1025))) ** 4 * 1e3
    spectra_t = np.abs(RNG.standard_normal((6, 1025))) ** 4
    # make some frames valid: strong lowpassed ref
    spectra_r[:, 600:] *= 1e-9
    bw_r, bw_t, valid = (np.asarray(x) for x in MOVS.bandwidth(
        jnp.asarray(spectra_r), jnp.asarray(spectra_t)))
    for i in range(6):
        acc_r = R.MovAccum(R.MODE_AVG, 1)
        acc_t = R.MovAccum(R.MODE_AVG, 1)
        acc_r.set_tentative(False)
        acc_t.set_tentative(False)
        R.mov_bandwidth([spectra_r[i]], [spectra_t[i]], acc_r, acc_t)
        if acc_r.den[0] > 0:
            assert valid[i]
            assert bw_r[i] == acc_r.num[0]
            assert bw_t[i] == acc_t.num[0]
        else:
            assert not valid[i]


def test_prob_detect_matches_spec():
    p = EP.fft_ear_params(109)
    er = np.abs(RNG.standard_normal((4, 2, 109))) * 1e3 + 1
    et = er * (1 + 0.05 * RNG.standard_normal((4, 2, 109)))
    # transposed MOV-tail layout: [C, Z, F]
    p_bin, steps = (np.asarray(x) for x in MOVS.prob_detect(
        jnp.asarray(er.transpose(1, 2, 0)), jnp.asarray(et.transpose(1, 2, 0))))
    for i in range(4):
        acc_adb = R.MovAccum(R.MODE_ADB, 1)
        acc_mfpd = R.MovAccum(R.MODE_FILTERED_MAX, 1)
        acc_adb.set_tentative(False)
        acc_mfpd.set_tentative(False)
        R.mov_prob_detect(p, [er[i, 0], er[i, 1]], [et[i, 0], et[i, 1]], 2,
                          acc_adb, acc_mfpd, C.DEFAULT_SETTINGS)
        # mfpd filter state got 0.1 * p after one step
        assert abs(acc_mfpd.filt_state[0] - 0.1 * p_bin[i]) < 1e-12
        if p_bin[i] > 0.5:
            assert abs(acc_adb.num[0] - steps[i]) < 1e-9 * (1 + steps[i])


def test_ehs_matches_spec():
    p = EP.fft_ear_params(109)
    k = FE.build_consts(p)
    w_r = np.abs(RNG.standard_normal((3, 1, 1025))) ** 2 + 1e-6
    w_t = w_r * np.exp(0.1 * RNG.standard_normal((3, 1, 1025)))
    thr = np.ones((3, 1), bool)
    ehs_val, valid = (np.asarray(x) for x in MOVS.ehs(
        jnp.asarray(w_r), jnp.asarray(w_t), jnp.asarray(thr),
        jnp.asarray(thr), C.DEFAULT_SETTINGS, jnp.float64))
    for i in range(3):
        acc = R.MovAccum(R.MODE_AVG, 1)
        acc.set_tentative(False)

        class S:
            pass

        sr, st = S(), S()
        sr.weighted_power_spectrum = w_r[i, 0]
        st.weighted_power_spectrum = w_t[i, 0]
        sr.energy_threshold_reached = st.energy_threshold_reached = True
        R.mov_ehs([sr], [st], acc, C.DEFAULT_SETTINGS)
        want = acc.num[0]
        assert abs(ehs_val[i, 0] - want) < 1e-8 * (1 + abs(want))


def test_ehs_gemm_path_matches_fft_path():
    """The DFT-GEMM EHS path (the float32 tiers' route) equals the FFT
    path to f32 roundoff."""
    p = EP.fft_ear_params(109)
    k = FE.build_consts(p, dtype=jnp.float32, spectrum_dtype=jnp.float32,
                        use_dft_gemm=True, use_ct_dft=False)
    assert k.ehs_fwd is not None
    w_r = jnp.asarray(np.abs(RNG.standard_normal((7, 2, 1025))) ** 2 + 1e-8,
                      jnp.float32)
    w_t = w_r * jnp.asarray(
        np.exp(0.1 * RNG.standard_normal((7, 2, 1025))), jnp.float32)
    thr = jnp.ones((7, 2), bool)
    a, _ = MOVS.ehs(w_r, w_t, thr, thr, C.DEFAULT_SETTINGS, jnp.float32)
    b, _ = MOVS.ehs(w_r, w_t, thr, thr, C.DEFAULT_SETTINGS, jnp.float32,
                    ehs_mats=(k.ehs_fwd, k.ehs_inv_re, k.ehs_inv_im,
                              k.ehs_fwd2))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                               atol=1e-7)


def test_accumulator_modes_roundtrip():
    """Closed-form masked reductions == the serial C-state-machine spec."""
    f = 40
    above = RNG.random(f) > 0.3
    above[:3] = False
    above[-4:] = False
    v = np.abs(RNG.standard_normal(f)) * 3
    w = np.abs(RNG.standard_normal(f)) + 0.5

    has, active, committed = (np.asarray(x) for x in accum.activity(
        jnp.asarray(above)))

    for mode, fn in [
        (R.MODE_AVG, lambda: accum.avg(jnp.asarray(v), jnp.asarray(w),
                                       jnp.asarray(committed))),
        (R.MODE_RMS, lambda: accum.rms(jnp.asarray(v), jnp.asarray(w),
                                       jnp.asarray(committed))),
        (R.MODE_AVG_LOG, lambda: accum.avg_log(
            jnp.asarray(v), jnp.asarray(w), jnp.asarray(committed))),
    ]:
        ref_acc = R.MovAccum(mode, 1)
        for t in range(f):
            ref_acc.set_tentative(not above[t])
            ref_acc.accumulate(0, v[t], w[t])
        want = ref_acc.get_value()
        got = float(fn())
        assert abs(got - want) < 1e-10 * (1 + abs(want)), (mode, got, want)

    # filtered max
    ref_acc = R.MovAccum(R.MODE_FILTERED_MAX, 1)
    for t in range(f):
        ref_acc.set_tentative(not above[t])
        ref_acc.accumulate(0, v[t], 1.0)
    want = ref_acc.get_value()
    got = float(accum.filtered_max(jnp.asarray(v), jnp.asarray(active),
                                   jnp.asarray(committed)))
    assert abs(got - want) < 1e-12

    # windowed average with a >= 10 gate (contiguous)
    gate = np.arange(f) >= 10
    ref_acc = R.MovAccum(R.MODE_AVG_WINDOW, 1)
    for t in range(f):
        ref_acc.set_tentative(not above[t])
        if gate[t]:
            ref_acc.accumulate(0, v[t], 1.0)
    want = ref_acc.get_value()
    got = float(accum.avg_window(jnp.asarray(v),
                                 jnp.asarray(active & gate),
                                 jnp.asarray(committed)))
    assert abs(got - want) < 1e-10 * (1 + abs(want))

    # RMS_ASYM (second input w is the MissingComponents value;
    # src/movaccum.c:380-384,462-466) with the noise-loudness gate shape
    gate = np.arange(f) >= 7
    ref_acc = R.MovAccum(R.MODE_RMS_ASYM, 1)
    for t in range(f):
        ref_acc.set_tentative(not above[t])
        if gate[t]:
            ref_acc.accumulate(0, v[t], w[t])
    want = ref_acc.get_value()
    got = float(accum.rms_asym(jnp.asarray(v), jnp.asarray(w),
                               jnp.asarray(committed & gate)))
    assert abs(got - want) < 1e-10 * (1 + abs(want))

    # ADB with a probability gate
    pgate = RNG.random(f) > 0.4
    ref_acc = R.MovAccum(R.MODE_ADB, 1)
    for t in range(f):
        ref_acc.set_tentative(not above[t])
        if pgate[t]:
            ref_acc.accumulate(0, v[t], 1.0)
    want = ref_acc.get_value()
    got = float(accum.adb(jnp.asarray(v), jnp.asarray(committed & pgate)))
    assert abs(got - want) < 1e-12 * (1 + abs(want))
