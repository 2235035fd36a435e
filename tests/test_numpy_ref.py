"""Golden-vector gates for the NumPy reference implementation.

These tests pin our implementation against the reference's own unit-test
goldens (extracted from /root/reference/src/testpeaq.c by
tools/extract_goldens.py) using the reference's tolerances
(abs 5e-6 OR rel 5e-5; src/testpeaq.c:33-35), plus the reference's pinned
end-to-end ODGs (src/runtest-1.0.sh).
"""

import pathlib

import numpy as np
import pytest

from gstpeaq_jax import constants as C
from gstpeaq_jax import earparams as EP
from gstpeaq_jax.utils import numpy_ref as R
from gstpeaq_jax.utils import testsignals as TS

GOLDEN = np.load(pathlib.Path(__file__).parent / "golden" / "testpeaq.npz")

DELTA = 5e-6
RELDELTA = 5e-5


def assert_close(got, ref, name):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    ad = np.abs(got - ref)
    with np.errstate(invalid="ignore", divide="ignore"):
        rd = np.abs(2 * (got - ref) / (got + ref))
    bad = (ad > DELTA) & (rd > RELDELTA)
    assert not bad.any(), (
        f"{name}: {bad.sum()} mismatches, worst abs {ad.max():.3g}")


@pytest.fixture(scope="module")
def fft_params():
    return EP.fft_ear_params(C.BASIC_BAND_COUNT)


@pytest.fixture(scope="module")
def ear_golden_state(fft_params):
    state = R.FFTEarState(C.BASIC_BAND_COUNT)
    f1 = np.zeros(2048, dtype=np.float32)
    f1[:1024] = -1
    f1[1025:] = 1
    f2 = ((np.arange(2048) - 1024) / 1024).astype(np.float32)
    R.fft_ear_process_block(fft_params, state, f1)
    R.fft_ear_process_block(fft_params, state, f2)
    return state


def test_power_spectrum_golden(ear_golden_state):
    assert_close(ear_golden_state.power_spectrum,
                 GOLDEN["fft_ref_data"] ** 2, "power_spectrum")


def test_weighted_power_spectrum_golden(ear_golden_state):
    assert_close(ear_golden_state.weighted_power_spectrum,
                 GOLDEN["weighted_fft_ref_data"] ** 2, "weighted")


def test_unsmeared_excitation_golden(ear_golden_state):
    assert_close(ear_golden_state.unsmeared_excitation,
                 GOLDEN["unsmeared_excitation_ref"], "unsmeared_excitation")


def test_excitation_golden(ear_golden_state):
    assert_close(ear_golden_state.excitation,
                 GOLDEN["excitation_ref"], "excitation")


def test_spl_calibration(fft_params):
    """Full-scale 1019.5 Hz sine must read 92 dB SPL in bin 43;
    src/testpeaq.c:695-705."""
    state = R.FFTEarState(C.BASIC_BAND_COUNT)
    for frame in range(10):
        i = np.arange(2048)
        x = np.sin(2 * np.pi * 1019.5 / 48000 * (i + frame * 1024))
        R.fft_ear_process_block(fft_params, state, x.astype(np.float32))
        spl = 10 * np.log10(state.power_spectrum[43])
        assert 91.9999 < spl < 92.0001


def test_fft_loudness(fft_params):
    """40 dB SPL 1 kHz tone loudness ~0.584 sone; src/testpeaq.c:714-724."""
    state = R.FFTEarState(C.BASIC_BAND_COUNT)
    scale = 10 ** ((40 - 92) / 20)
    for frame in range(50):
        i = np.arange(2048)
        x = scale * np.sin(2 * np.pi * 1000 / 48000 * (i + frame * 1024))
        R.fft_ear_process_block(fft_params, state, x.astype(np.float32))
    loudness = R.calc_loudness(fft_params, state.excitation)
    assert 0.58 < loudness < 0.59


def test_fb_loudness():
    """40 dB SPL 1 kHz tone loudness in [1.03, 1.04];
    src/testpeaq.c:726-744."""
    fb = EP.fb_ear_params()
    scale = 10 ** ((40 - 92) / 20)
    i = np.arange(250 * 192)
    sig = (scale * np.sin(2 * np.pi * 1000 / 48000 * i)).astype(np.float32)
    exc, _ = R.fb_process_signal(fb, sig)
    loudness = R.calc_loudness(fb, exc[-1])
    assert 1.03 < loudness < 1.04


def test_level_adapter_goldens(fft_params):
    la = R.LevelAdapterState(109, fft_params.adapt_time_constants)
    ref = np.arange(1, 110, dtype=np.float64)
    test = np.arange(109, 0, -1, dtype=np.float64)
    la.process(ref, test)
    assert_close(la.adapted_ref,
                 GOLDEN["spectrally_adapted_ref_patterns1_ref"], "ref1")
    assert_close(la.adapted_test,
                 GOLDEN["spectrally_adapted_test_patterns1_ref"], "test1")
    la.process(ref, test)
    assert_close(la.adapted_ref,
                 GOLDEN["spectrally_adapted_ref_patterns2_ref"], "ref2")
    assert_close(la.adapted_test,
                 GOLDEN["spectrally_adapted_test_patterns2_ref"], "test2")


def test_modulation_goldens(fft_params):
    mp = R.ModulationState(109, fft_params.adapt_time_constants,
                           C.FFT_STEPSIZE)
    x = np.arange(1, 110, dtype=np.float64)
    mp.process(x)
    assert_close(mp.modulation, GOLDEN["modulation1_ref"], "modulation1")
    assert_close(mp.filtered_loudness, GOLDEN["loudness1_ref"], "loudness1")
    mp.process(x)
    assert_close(mp.modulation, GOLDEN["modulation2_ref"], "modulation2")
    assert_close(mp.filtered_loudness, GOLDEN["loudness2_ref"], "loudness2")


@pytest.mark.slow
def test_pinned_odg_sine():
    """audiotestsrc sine vs itself -> ODG 0.171; src/runtest-1.0.sh:16-19."""
    s = TS.sine(128 * 1024)
    res = R.peaq_basic(s, s)
    assert f"{res.odg:.3f}" == "0.171"


@pytest.mark.slow
def test_pinned_odg_saw_triangle():
    """saw vs triangle -> ODG -2.007; src/runtest-1.0.sh:28-31."""
    res = R.peaq_basic(TS.saw(128 * 1024), TS.triangle(128 * 1024))
    assert f"{res.odg:.3f}" == "-2.007"


@pytest.mark.slow
def test_pinned_odg_stereo_upmix():
    """channels=2 upmix variants also give -2.007; src/runtest-1.0.sh:31-50."""
    sa = TS.saw(128 * 1024)
    tr = TS.triangle(128 * 1024)
    res = R.peaq_basic(np.stack([sa, sa], 1), np.stack([tr, tr], 1))
    assert f"{res.odg:.3f}" == "-2.007"
