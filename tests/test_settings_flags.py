"""The standard-ambiguity Settings flags change JAX and NumPy-spec results
identically (each flag is a conformance landmine; src/settings.h:47-97)."""

import dataclasses

import numpy as np
import pytest

from gstpeaq_jax import api
from gstpeaq_jax import constants as C
from gstpeaq_jax.utils import numpy_ref as R
from gstpeaq_jax.utils import testsignals as TS

N = 40 * 1024


@pytest.fixture(scope="module")
def pair():
    return TS.saw(N), TS.triangle(N)


@pytest.mark.parametrize("flag", [
    "center_ehs_correlation_window",
    "ehs_subtract_dc_before_window",
    "use_floor_for_steps_above_threshold",
    "clamp_movs",
])
def test_basic_flag_equivalence(pair, flag):
    ref, test = pair
    settings = dataclasses.replace(
        C.DEFAULT_SETTINGS,
        **{flag: not getattr(C.DEFAULT_SETTINGS, flag)})
    want = R.peaq_basic(ref, test, settings=settings)
    got = api.peaq(ref, test, settings=settings)
    assert abs(got.odg - want.odg) < 1e-9, flag
    base = api.peaq(ref, test)
    if flag != "use_floor_for_steps_above_threshold":
        # most flags must actually change something on this signal
        changed = any(
            abs(got.movs[k] - base.movs[k]) > 1e-12
            for k in C.MOV_BASIC_NAMES)
        assert changed or abs(got.odg - base.odg) > 0, flag


@pytest.mark.slow
@pytest.mark.parametrize("flag", [
    "swap_mod_patts_for_noise_loudness_movs",
    "swap_slope_filter_coefficients",
])
def test_advanced_flag_equivalence(pair, flag):
    ref, test = pair
    settings = dataclasses.replace(
        C.DEFAULT_SETTINGS,
        **{flag: not getattr(C.DEFAULT_SETTINGS, flag)})
    want = R.peaq_advanced(ref, test, settings=settings)
    got = api.peaq(ref, test, advanced=True, settings=settings)
    for name in C.MOV_ADVANCED_NAMES:
        w, g = want.movs[name], got.movs[name]
        assert abs(g - w) <= 1e-7 * (1 + abs(w)), (name, g, w)
    # flipping the flag must actually move the FB-path MOVs
    base = api.peaq(ref, test, advanced=True)
    fb_movs = ("RmsModDiffA", "RmsNoiseLoudAsymA", "AvgLinDistA")
    assert any(abs(got.movs[k] - base.movs[k]) > 1e-9 for k in fb_movs), flag


def test_swap_slope_changes_fb_excitation(pair):
    """The swapped slope filter (settings.h:97) flips the smoother's time
    constant; the spec and JAX FB paths must move identically."""
    import jax.numpy as jnp
    from gstpeaq_jax import earparams as EP
    from gstpeaq_jax.ops import fb_ear as FB

    sig = np.asarray(pair[0][:192 * 40], np.float64)
    p = EP.fb_ear_params(92.0)
    exc_np, _ = R.fb_process_signal(p, sig, swap_slope=True)
    k = FB.build_consts(p, dtype=jnp.float64, swap_slope=True)
    exc, _ = FB.process_signal(k, jnp.asarray(sig), 40)
    np.testing.assert_allclose(np.asarray(exc).T, exc_np, rtol=1e-9,
                               atol=1e-12)
    exc_np_def, _ = R.fb_process_signal(p, sig, swap_slope=False)
    assert np.max(np.abs(exc_np - exc_np_def)) > 0
